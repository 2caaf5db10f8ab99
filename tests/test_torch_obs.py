"""The port's tracer (`repro_torch.obs`) on the CPU, and the benchmark's
readers of it (`portbench/metrics/`).

* Off: `span` hands back one shared no-op, nothing is recorded or
  counted, and a DeepSeek-MoE-shaped LM's prefill, `generate` and a
  training step give bitwise the same outputs with the tracer on and off.
* On: spans nest under the right parents with ordered host times, the
  profiler sees them as host ranges, and the MoE counters equal a count
  made apart from `blocks.route`'s expert choices, on a config that drops
  pairs; they add up across an inference-mode call and a training step
  (remat's recomputed forward not counted twice) and ignore fake tensors.
* The readers: the two-anchor clock mapping, stretch skipping, None for
  device metrics without events, None against a program without the
  tracer, and a traced tiny run of each cell through the harness.
Every test leaves the tracer off."""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.configs as configs
from portbench import spec
from portbench.metrics import _obs
from portbench.tests import tiny
from repro_torch import obs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.serve import generate
from repro_torch.models import blocks
from repro_torch.models import lm as lm_mod
from repro_torch.optim import AdamWConfig, adamw_init, make_train_step

MOE_KEYS = ("moe.valid_pairs", "moe.kept_pairs", "moe.buffer_rows")
READERS = ("host_lead_ms.train", "host_lead_ms.serve", "moe_event_ms.serve",
           "moe_fill_pct.serve", "moe_drop_pct.serve")


@pytest.fixture(autouse=True)
def tracer_off():
    obs.disable()
    yield
    obs.disable()


def _drop_cfg():
    """The reduced DeepSeek-MoE (4 experts, top 2, group 32) at capacity
    factor 0.5: 9 slots for the 16 pairs an expert gets on average."""
    cfg = configs.get("deepseek-moe-16b", reduced=True)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def _tokens(cfg, shape=(2, 32), seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (shape[0], shape[1] + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _outputs(cfg):
    """A prefill's logits, `generate`'s tokens, and a training step's loss
    and updated params, each from fresh params."""
    model = lm_mod.build(cfg)
    batch = _tokens(cfg)
    serve = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 32, "cpu")
    with torch.inference_mode():
        logits = model.prefill(serve, batch["tokens"], cache)
    toks = generate(model, serve, batch["tokens"][:, :24], 28, 4)
    state = adamw_init(model.init(torch.Generator().manual_seed(0),
                                  torch.float32))
    state, m = make_train_step(model.loss, AdamWConfig())(state, batch)
    return [logits, toks, m["loss"], m["grad_norm"],
            *(p.detach() for p in torch.utils._pytree.tree_leaves(
                state.params))]


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------


def test_off_span_is_one_shared_noop_and_nothing_is_kept():
    assert not obs.enabled()
    a, b = obs.span("step"), obs.span("moe", torch.ones(1), batch=2)
    assert a is b
    with a:
        obs.mark("step.enqueued", torch.ones(1))
        obs.count_moe(torch.ones(2, 4, 2, dtype=torch.bool), 16, 16)
    assert obs.records() == {"records": [], "clock": None}
    assert all(obs.counters()[k] == 0 for k in MOE_KEYS)


def test_outputs_are_bitwise_equal_with_the_tracer_on_and_off():
    cfg = _drop_cfg()
    off = _outputs(cfg)
    assert not obs.records()["records"]
    obs.enable()
    on = _outputs(cfg)
    assert len(obs.records()["records"]) > 0
    obs.disable()
    assert len(on) == len(off)
    for x, y in zip(on, off):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# On
# ---------------------------------------------------------------------------


def _ancestors(recs, r):
    out = []
    while r.parent is not None:
        r = recs[r.parent]
        out.append(r.name)
    return out


def test_step_spans_nest_with_ordered_host_times():
    cfg = _drop_cfg()
    model = lm_mod.build(cfg)
    state = adamw_init(model.init(torch.Generator().manual_seed(0),
                                  torch.float32))
    step = make_train_step(model.loss, AdamWConfig())
    obs.enable()
    step(state, _tokens(cfg))
    got = obs.records()
    recs = got["records"]
    assert got["clock"] is None
    assert [r.id for r in recs] == list(range(len(recs)))
    top = [r for r in recs if r.parent is None]
    assert [(r.kind, r.name) for r in top] == [("span", "step")]
    assert top[0].attrs == {"batch": 2, "length": 32, "step": 1}
    children = [r.name for r in recs if r.parent == top[0].id]
    assert children == ["step.forward", "step.backward", "step.optimizer",
                        "step.enqueued"]
    moe = [r for r in recs if r.name == "moe"]
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    # the forward's blocks, and remat's recomputed ones in the backward
    assert [_ancestors(recs, r)[0] for r in moe] == \
        ["step.forward"] * n_moe + ["step.backward"] * n_moe
    for r in recs:
        assert r.host_t1_ns >= r.host_t0_ns
        assert r.device_t0_ns is None and r.device_ms is None
        if r.parent is not None:
            p = recs[r.parent]
            assert p.host_t0_ns <= r.host_t0_ns <= r.host_t1_ns <= p.host_t1_ns
    sibs = [r for r in recs if r.parent == top[0].id]
    assert all(a.host_t1_ns <= b.host_t0_ns for a, b in zip(sibs, sibs[1:]))


def test_generate_spans_nest_and_its_mark_ends_the_enqueue():
    cfg = _drop_cfg()
    model = lm_mod.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    obs.enable()
    generate(model, params, _tokens(cfg)["tokens"][:, :20], 21, 1)
    recs = obs.records()["records"]
    gen = recs[0]
    assert (gen.name, gen.parent, gen.attrs) == (
        "generate", None, {"batch": 2, "length": 20, "gen": 1})
    assert [r.name for r in recs if r.parent == gen.id] == [
        "generate.prefill", "generate.enqueued"]
    moe = [r for r in recs if r.name == "moe"]
    assert len(moe) == cfg.n_layers - cfg.moe.first_dense_layers
    assert all(_ancestors(recs, r) == ["generate.prefill", "generate"]
               and r.attrs == {"batch": 2, "length": 20} for r in moe)
    end = recs[-1]
    assert end.kind == "mark" and end.host_t0_ns == end.host_t1_ns
    assert max(r.host_t1_ns for r in recs[1:-1]) <= end.host_t0_ns \
        <= gen.host_t1_ns


def test_spans_open_host_ranges_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    cfg = _drop_cfg()
    model = lm_mod.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = _tokens(cfg)["tokens"][:, :20]
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(model, params, prompts, 21, 1)
    ours = {e.name: e for e in prof.events()
            if e.name in ("generate", "generate.prefill", "moe")}
    assert set(ours) == {"generate", "generate.prefill", "moe"}
    assert not any(e.is_user_annotation for e in ours.values())
    assert ours["generate.prefill"].cpu_parent.name == "generate"
    obs.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(model, params, prompts, 21, 1)
    assert not any(e.name == "generate" for e in prof.events())


def _independent_counts(p, dims, x):
    """(valid pairs, kept pairs, buffer rows) from route's expert choices
    alone: each group keeps at most C of the pairs an expert got."""
    xg, valid = blocks.group_tokens(x, dims.group_size)
    expert = blocks.route(p, dims, xg, valid)[1]
    cap, kept = dims.capacity, 0
    for g in range(expert.shape[0]):
        chosen = expert[g][valid[g]].reshape(-1)
        counts = torch.bincount(chosen, minlength=dims.n_experts)
        kept += int(counts.clamp(max=cap).sum())
    return (int(valid.sum()) * dims.top_k, kept,
            dims.n_experts * expert.shape[0] * cap)


@pytest.mark.parametrize("shape", [(4, 32), (3, 20)])   # 20 x 3: padding
def test_moe_counters_equal_a_count_from_the_routing(shape):
    dims = blocks.MoEDims(d_model=64, n_experts=4, top_k=2, d_expert=32,
                          n_shared=1, group_size=32, capacity_factor=0.5)
    p = blocks.init_moe(torch.Generator().manual_seed(3), dims,
                        torch.float32)
    x = torch.randn(*shape, 64, generator=torch.Generator().manual_seed(4))
    want = _independent_counts(p, dims, x)
    assert want[1] < want[0]   # the capacity drops pairs
    obs.enable()
    with torch.inference_mode():
        blocks.moe(p, dims, x)
    c = obs.counters()
    assert tuple(c[k] for k in MOE_KEYS) == want


def test_moe_counters_add_up_over_inference_and_a_training_step():
    cfg = _drop_cfg()
    model = lm_mod.build(cfg)   # remat "full": the backward recomputes
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    batch = _tokens(cfg)
    obs.enable()
    with torch.no_grad():
        model.forward(params, batch["tokens"])
    once = [obs.counters()[k] for k in MOE_KEYS]
    assert 0 < once[1] < once[0]
    obs.reset()
    with torch.inference_mode():
        model.forward(params, batch["tokens"])
    make_train_step(model.loss, AdamWConfig())(adamw_init(params), batch)
    assert [obs.counters()[k] for k in MOE_KEYS] == [2 * n for n in once]


def test_nothing_is_counted_on_fake_tensors():
    obs.enable()
    with FakeTensorMode():
        cell = specs.build_cell(_drop_cfg(), configs.base.ShapeSpec(
            "train_small", kind="train", seq_len=32, global_batch=2),
            device="cpu")
    assert dryrun.dry_run(cell)["status"] == "ok"
    assert any(r.name == "moe" for r in obs.records()["records"])
    assert all(obs.counters()[k] == 0 for k in MOE_KEYS)


def test_counters_carry_the_kernels_launch_counts():
    from repro_torch.kernels.adamw import adamw, global_norm
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.wkv6 import wkv6_bwd
    c = obs.counters()
    assert c["flash_attention.launches"] == flash_attention.launches
    assert c["flash_attention.launches_mla"] == flash_attention.launches_mla
    assert c["wkv6_bwd.launches"] == wkv6_bwd.launches
    assert c["adamw.launches"] == adamw.launches
    assert c["adamw.leaves"] == adamw.leaves
    assert c["global_norm.launches"] == global_norm.launches
    assert {k.split(".")[0] for k in c} == {
        "moe", "flash_attention", "flash_attention_bwd", "wkv6", "wkv6_bwd",
        "selective_scan", "selective_scan_bwd", "adamw", "global_norm"}


# ---------------------------------------------------------------------------
# The clock and the readers
# ---------------------------------------------------------------------------


def test_the_two_anchor_clock_maps_device_times_linearly():
    # the device counted 10 ms where the host counted 10.0001 ms
    first, second = (0.0, 1_000), (10.0, 1_000 + 10_000_100)
    assert obs.to_host_ns(0.0, first, second) == 1_000
    assert obs.to_host_ns(10.0, first, second) == 1_000 + 10_000_100
    assert obs.to_host_ns(5.0, first, second) == pytest.approx(
        1_000 + 5_000_050)
    assert obs.to_host_ns(20.0, first, second) == pytest.approx(
        1_000 + 20_000_200)


def _rec(kind, name, i, parent, t0, dev_lead_ms=None, device_ms=None):
    dev = None if dev_lead_ms is None else t0 + dev_lead_ms * 1e6
    return obs.Record(kind, name, i, parent, {}, t0,
                      t0 if kind == "mark" else t0 + 1, dev, dev, device_ms)


def _serve_records(leads, moe_ms):
    """A generate span a batch: two moe spans under its prefill, and its
    mark leading the device by `leads[i]` ms."""
    recs = []
    for lead, (a, b) in zip(leads, moe_ms):
        g = len(recs)
        recs.append(_rec("span", "generate", g, None, 100 * g))
        recs.append(_rec("span", "generate.prefill", g + 1, g, 100 * g))
        recs.append(_rec("span", "moe", g + 2, g + 1, 100 * g, 0.0, a))
        recs.append(_rec("span", "moe", g + 3, g + 1, 100 * g, 0.0, b))
        recs.append(_rec("mark", "generate.enqueued", g + 4, g, 100 * g,
                         lead))
    return recs


def _ctx(recs, counters=None, **skip):
    return dict(skip, obs={"records": recs, "clock": None,
                           "counters": counters or {}})


@pytest.fixture
def readers():
    return {name: spec.reader(name) for name in READERS}


def test_loading_a_reader_turns_the_tracer_on(readers):
    assert obs.enabled()
    ctx = {"stretch_batches": 0}
    readers["moe_fill_pct.serve"].read(ctx)
    assert not obs.enabled() and ctx["obs"]["counters"]["moe.buffer_rows"] \
        == 0


def test_serve_readers_skip_the_stretch(readers):
    recs = _serve_records([50.0, 1.0, 3.0, 2.0],
                          [(9.0, 9.0), (1.0, 2.0), (3.0, 4.0), (5.0, 6.0)])
    ctx = _ctx(recs, stretch_batches=1)
    assert readers["host_lead_ms.serve"].read(ctx) == pytest.approx(2.0)
    assert readers["moe_event_ms.serve"].read(ctx) == pytest.approx(7.0)
    ctx = _ctx(recs, stretch_batches=0)
    assert readers["host_lead_ms.serve"].read(ctx) == pytest.approx(2.5)
    assert readers["moe_event_ms.serve"].read(ctx) == pytest.approx(9.75)


def test_train_reader_takes_the_median_after_the_stretch(readers):
    recs = [_rec("mark", "step.enqueued", i, None, 10 * i, lead)
            for i, lead in enumerate([0.5, 0.6, 120.0, 130.0, 90.0])]
    ctx = _ctx(recs, stretch_steps=2)
    assert readers["host_lead_ms.train"].read(ctx) == pytest.approx(120.0)


@pytest.mark.parametrize("name", ["host_lead_ms.train", "host_lead_ms.serve",
                                  "moe_event_ms.serve"])
def test_device_metrics_without_events_read_none(readers, name):
    recs = _serve_records([None, None], [(None, None), (None, None)])
    recs += [_rec("mark", "step.enqueued", len(recs), None, 0)]
    ctx = _ctx(recs, stretch_batches=0, stretch_steps=0)
    assert readers[name].read(ctx) is None


def test_fill_and_drop_readers(readers):
    c = {"moe.valid_pairs": 1000, "moe.kept_pairs": 990,
         "moe.buffer_rows": 1248}
    assert readers["moe_fill_pct.serve"].read(_ctx([], c)) == \
        pytest.approx(100 * 990 / 1248)
    assert readers["moe_drop_pct.serve"].read(_ctx([], c)) == \
        pytest.approx(1.0)
    zero = dict.fromkeys(MOE_KEYS, 0)
    assert readers["moe_fill_pct.serve"].read(_ctx([], zero)) is None
    assert readers["moe_drop_pct.serve"].read(_ctx([], zero)) is None


def test_readers_read_none_against_a_program_without_the_tracer(
        readers, monkeypatch):
    monkeypatch.setattr(_obs, "obs", None)
    _obs.turn_on()
    ctx = {"stretch_batches": 0, "stretch_steps": 0}
    assert all(readers[n].read(ctx) is None for n in READERS)


@pytest.mark.parametrize("cell, want, absent", [
    ("deepseek-moe-16b.serve.longprompt",
     {"moe_fill_pct.serve", "moe_drop_pct.serve"},
     {"host_lead_ms.serve", "moe_event_ms.serve"}),
    ("minicpm-2b.train.4x2048", set(), {"host_lead_ms.train"})])
def test_a_traced_tiny_run_reads_the_counts_and_no_device_time(
        tmp_path, cell, want, absent):
    root, here = tiny.copy(tmp_path)
    result, _ = tiny.run(root, here, cell, trace=True)
    assert want <= set(result["metrics"])
    assert not absent & set(result["metrics"])
    if want:
        fill = result["metrics"]["moe_fill_pct.serve"]["value"]
        drop = result["metrics"]["moe_drop_pct.serve"]["value"]
        assert 0 < fill <= 100 and 0 <= drop < 100
    assert not obs.enabled()
