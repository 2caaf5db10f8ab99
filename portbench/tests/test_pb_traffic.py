"""The traffic is a pure function of (seed, step), and a serving mix's
schedule of arrivals and lengths is the mix's alone."""

import collections

import numpy as np
import pytest

from portbench import gen, spec


def test_markov_batch_is_a_pure_function_of_seed_and_step():
    a, b = gen.Markov(1000, 2**31 + 5), gen.Markov(1000, 2**31 + 5)
    x, y = a.batch(7, 4, 64), b.batch(7, 4, 64)
    assert all(np.array_equal(x[k], y[k]) for k in x)
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not np.array_equal(a.batch(8, 4, 64)["tokens"], x["tokens"])
    other = gen.Markov(1000, 2**31 + 6).batch(7, 4, 64)["tokens"]
    assert not np.array_equal(other, x["tokens"])


def test_markov_matches_the_ports_pipeline_arithmetic():
    from repro_torch.data import DataConfig, SyntheticTokens
    ours = gen.Markov(512, 11).batch(3, 4, 48)
    port = SyntheticTokens(DataConfig(vocab=512, seq_len=48, global_batch=4,
                                      seed=11)).batch(3)
    assert all(np.array_equal(ours[k], port[k]) for k in ours)


def test_rows_differ_within_a_batch():
    t = gen.Markov(122753, 9).batch(0, 4, 2048)["tokens"]
    assert len({r.tobytes() for r in t}) == 4


def test_every_seed_gets_the_mixs_one_schedule():
    mix = spec.traffic("serve.longprompt")
    n = 27
    sched = gen.serve_schedule(mix, n * mix["mean_interval_s"])
    assert len(sched) == n
    assert sched == gen.serve_schedule(mix, n * mix["mean_interval_s"])
    counts = collections.Counter(b["length"] for b in sched)
    assert counts == {length: 3 for length in mix["lengths"]}
    # Poisson: each gap is one of the exponential's n quantiles, each used
    # at most once, in a drawn order
    gaps = np.diff([b["due"] for b in sched])
    want = -mix["mean_interval_s"] * np.log1p(-(np.arange(n) + 0.5) / n)
    assert sched[0]["due"] == 0.0
    hits = [int(np.argmin(abs(want - g))) for g in gaps]
    assert np.allclose(gaps, want[hits]) and len(set(hits)) == n - 1
    assert not np.all(np.diff(gaps) >= 0)
    other = dict(mix, schedule_seed=mix["schedule_seed"] + 1)
    assert gen.serve_schedule(other, n * mix["mean_interval_s"]) != sched
    even = gen.serve_schedule(dict(mix, arrivals="even"), 3.0)
    assert [b["due"] for b in even] == pytest.approx(
        [i * mix["mean_interval_s"] for i in range(len(even))])


def test_the_checked_sample_holds_the_longest():
    mix = spec.traffic("serve.longprompt")
    sched = gen.serve_schedule(mix, 30)
    pick = gen.check_sample(sched, mix["check_batches"], 123)
    assert len(set(pick)) == mix["check_batches"]
    assert {sched[i]["length"] for i in pick} == set(mix["lengths"])
    assert pick == gen.check_sample(sched, mix["check_batches"], 123)
    assert pick != gen.check_sample(sched, mix["check_batches"], 2**31 + 9)
    few = gen.check_sample(sched, 2, 123)
    assert max(sched[i]["length"] for i in few) == max(mix["lengths"])
