"""The port's concurrent sweep service (`repro_torch.sweep.service`) and
its stdlib client on the CPU.

Two families:

  reference  the same request documents through the port's
             `SweepService(window_ms=0, device="cpu")` and the JAX
             reference's `SweepService(window_ms=0)`: the same `ok`,
             `name`, `cells`, `axes`, `source` and errors, the views
             (rows, summary, pareto, plateaus) within 1e-12 relative, and
             the same `stats()` document (keys and counters); the paths
             the service rides on (`spec_union` + `SweepResult.subset`,
             `lower_designs(pad_caps=True)` with `evaluate_bucketed`, LM
             `@b<n>` scenarios, `pareto_front`, `capacity_plateaus`)
             against the reference within 1e-12;
  contracts  every contract of `tests/test_service.py` on the port:
             coalesced = individual, dedup, incompatible platforms, errors
             delivered once, cache keys and eviction, drain, stats, HTTP
             and unix round trips, 413, 429 with cache hits exempt, LM
             `@b<n>` requests, and `python -m repro_torch.sweep serve
             --device cpu` exiting 0 on SIGTERM with a request in flight;
             plus one device per service (raising without CUDA), the
             compile cache raising, warmup, and a threaded stress run.

The reference's engines import `jax.experimental.enable_x64`, which JAX
0.9 no longer has; the `ref` fixture aliases it to `jax.enable_x64` when
it first runs, never at import.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch import scenarios
from repro_torch.core import sweep
from repro_torch.core.sweep import SymbolicSweepSpec, spec_union
from repro_torch.sweep import client
from repro_torch.sweep import service as service_mod
from repro_torch.sweep.service import (
    Coalescer,
    ResultCache,
    SweepService,
    evaluate_spec,
    spec_key,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPECS = os.path.join(ROOT, "specs")
REL = 1e-12
CPU = "cpu"

# A small scenario/design pool, as the reference's service tests use.
SCENARIOS = ("cnn/alexnet/infer@b4", "cnn/alexnet/train@b64",
             "cnn/squeezenet/infer@b4", "cnn/resnet18/train@b64")
CAPS = ("3MB", "8MB")


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's sweep layer, imported with the R1 alias."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.core import sweep as rsweep
    from repro.sweep import service as rservice
    return types.SimpleNamespace(sweep=rsweep, service=rservice)


def designs_at(caps=("3MB",)):
    return [f"{m}@{c}" for c in caps for m in ("sram", "stt", "sot")]


def doc(name, scens=SCENARIOS[:2], designs=None, platforms=("gtx-1080ti",)):
    return {"schema": "deepnvm.sweepspec/2", "name": name,
            "scenarios": list(scens),
            "designs": list(designs or designs_at()),
            "platforms": list(platforms), "baseline_mem": "sram"}


def golden(name):
    with open(os.path.join(SPECS, f"{name}.json")) as f:
        return json.load(f)


def assert_doc_close(got, want, tol=REL, where=""):
    """Nested dicts / lists of floats within rel tol; the rest equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_doc_close(got[k], want[k], tol, f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_doc_close(g, w, tol, f"{where}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=tol, nan_ok=True), where
    else:
        assert got == want, where


def assert_rows_match(got, want, tol=REL):
    assert_doc_close(got, want, tol, "rows")


def run_cpu(d):
    return sweep.run(SymbolicSweepSpec.from_json(d).resolve(), device=CPU)


# ---------------------------------------------------------------------------
# Against the reference service
# ---------------------------------------------------------------------------

VIEWS = ["rows", "summary", "pareto", "plateaus"]


def _sequence():
    """One request sequence: fresh evaluations, cache hits, a sharded
    envelope, an LM batch override, ops and every kind of bad request."""
    iso = golden("isocap")
    return [
        {"spec": iso, "want": VIEWS},
        {"spec": iso, "want": ["summary"]},                     # cache
        {"spec": golden("mixed_cnn_lm"), "want": VIEWS,
         "include_dram": True},
        {"spec": iso, "want": ["summary"],
         "shard": {"scenario_chunk": 4, "by_width": True}},     # sharded
        iso,                                                    # bare spec
        {"spec": doc("lm-b", scens=("lm/qwen3-14b/decode_32k",
                                    "lm/qwen3-14b/decode_32k@b32")),
         "want": ["rows", "summary"]},
        {"op": "ping"},
        {"op": "reboot"},
        {"spec": {"schema": "bogus"}},
        {"spec": iso, "want": ["everything"]},
        {"spec": iso, "shard": {"bogus": 1}},
        "{not json",
        {"op": "stats"},
    ]


_TIMES = ("uptime_s", "elapsed_ms", "warmup_s")


def _strip_times(d):
    if isinstance(d, dict):
        return {k: _strip_times(v) for k, v in d.items() if k not in _TIMES}
    return d


def test_responses_and_stats_match_reference(ref):
    mine = SweepService(window_ms=0.0, device=CPU)
    theirs = ref.service.SweepService(window_ms=0.0)
    try:
        for req in _sequence():
            raw = req if isinstance(req, str) else json.dumps(req)
            got, want = mine.handle(raw), theirs.handle(raw)
            assert got.keys() == want.keys(), req
            for k in ("ok", "name", "cells", "axes", "source", "error",
                      "status", "op"):
                assert got.get(k) == want.get(k), (k, req)
            for view in VIEWS:
                if view in want:
                    assert_doc_close(got[view], want[view], where=view)
            if got.get("op") == "stats":
                assert_doc_close(_strip_times(got["stats"]),
                                 _strip_times(want["stats"]))
        assert_doc_close(_strip_times(mine.stats()),
                         _strip_times(theirs.stats()))
        assert mine.stats().keys() == theirs.stats().keys()
    finally:
        mine.close()
        theirs.close()


def _sym_pair(ref, d):
    return (SymbolicSweepSpec.from_json(d).resolve(),
            ref.sweep.SymbolicSweepSpec.from_json(d).resolve())


def _assert_results(got, want):
    assert [str(d.org) for d in got.designs] \
        == [str(d.org) for d in want.designs]
    assert_rows_match(got.rows(include_dram=True),
                      want.rows(include_dram=True))
    assert_doc_close(got.summary(), want.summary())


def test_spec_union_and_subset_match_reference(ref):
    docs = [golden("isocap"), golden("dtco")]
    pairs = [_sym_pair(ref, d) for d in docs]
    union = spec_union([p for p, _ in pairs], name="u")
    runion = ref.sweep.spec_union([r for _, r in pairs], name="u")
    got = evaluate_spec(union, device=CPU)
    want = ref.service.evaluate_spec(runion)
    _assert_results(got, want)
    for (p, r) in pairs:
        _assert_results(got.subset(p), want.subset(r))
        _assert_results(got.subset(p), sweep.run(p, device=CPU))


@pytest.mark.parametrize("name", ["dtco_isoarea", "mixed_cnn_lm"])
def test_bucketed_evaluation_matches_reference(ref, name):
    """`lower_designs(pad_caps=True)` with `evaluate_bucketed` (the
    service's evaluation) against the reference's, and against the
    exact path."""
    spec, rspec = _sym_pair(ref, golden(name))
    table, designs = sweep.lower_designs(spec.designs, pad_caps=True,
                                         device=CPU)
    rtable, rdesigns = ref.sweep.lower_designs(rspec.designs, pad_caps=True)
    assert table.capacities_bytes == rtable.capacities_bytes
    assert [str(d.org) for d in designs] == [str(d.org) for d in rdesigns]
    _assert_results(evaluate_spec(spec, device=CPU),
                    ref.service.evaluate_spec(rspec))
    _assert_results(evaluate_spec(spec, device=CPU),
                    sweep.run(spec, device=CPU))


def test_lm_batch_and_12nm_cells_match_reference(ref):
    d = doc("lm-probe",
            scens=("lm/tinyllama-1.1b/decode_32k@b8",
                   "lm/hymba-1.5b/long_500k", "cnn/alexnet/train@b64"),
            designs=[f"{m}@{c}@12nm-scaled" for c in ("3MB", "48MB")
                     for m in ("sram", "stt", "sot")])
    spec, rspec = _sym_pair(ref, d)
    _assert_results(sweep.run(spec, device=CPU), ref.sweep.run(rspec))


@pytest.mark.parametrize("name", ["isocap", "dtco", "mixed_cnn_lm"])
def test_pareto_and_plateaus_match_reference(ref, name):
    spec, rspec = _sym_pair(ref, golden(name))
    got, want = sweep.run(spec, device=CPU), ref.sweep.run(rspec)
    for dram in (False, True):
        assert_rows_match(got.pareto_front(include_dram=dram),
                          want.pareto_front(include_dram=dram))
    assert got.capacity_plateaus() == want.capacity_plateaus()


def test_warmup_matches_reference(ref):
    path = os.path.join(SPECS, "isocap.json")
    mine = SweepService(window_ms=0.0, device=CPU)
    theirs = ref.service.SweepService(window_ms=0.0)
    try:
        info = mine.warmup(specs=(path,))
        rinfo = theirs.warmup(specs=(path,))
        assert _strip_times(info) == _strip_times(rinfo)
        assert mine.stats()["warmup"] == info
        assert mine.handle({"spec": golden("isocap")})["source"] \
            == "evaluated"
    finally:
        mine.close()
        theirs.close()


# ---------------------------------------------------------------------------
# One device per service
# ---------------------------------------------------------------------------


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = SymbolicSweepSpec.from_json(doc("dev")).resolve()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SweepService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SweepService(coalesce=False, evaluate=lambda s: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_spec(spec)


def test_service_resolves_its_device_once():
    svc = SweepService(window_ms=0.0, coalesce=False,
                       device=torch.device("cpu"))
    try:
        assert svc.device == "cpu"
        resp = svc.handle({"spec": doc("dev-shard"), "want": ["rows"],
                           "shard": {"scenario_chunk": 1}})
        assert resp["ok"] and resp["source"] == "sharded", resp
        assert_rows_match(resp["rows"], run_cpu(doc("dev-shard")).rows())
    finally:
        svc.close()


def test_compile_cache_raises():
    with pytest.raises(NotImplementedError, match="compilation cache"):
        service_mod.enable_compilation_cache("/nonexistent/cache")
    svc = SweepService(window_ms=0.0, device=CPU)
    try:
        with pytest.raises(NotImplementedError, match="compilation cache"):
            svc.warmup(compile_cache_dir="unused")
        assert svc.warmup_info is None
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# tests/test_service.py's contracts, on the port
# ---------------------------------------------------------------------------


def _fire_concurrently(svc, docs, want=("rows", "summary")):
    barrier = threading.Barrier(len(docs))
    responses = [None] * len(docs)

    def fire(i, d):
        barrier.wait()
        responses[i] = svc.handle({"spec": d, "want": list(want)})

    threads = [threading.Thread(target=fire, args=(i, d))
               for i, d in enumerate(docs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
        assert not t.is_alive()
    return responses


def test_coalesced_specs_match_individual_runs():
    rng = random.Random(20260808)
    svc = SweepService(window_ms=250.0, device=CPU)
    try:
        for rnd in range(3):
            docs = []
            for i in range(4):
                scens = rng.sample(SCENARIOS, rng.randint(1, len(SCENARIOS)))
                caps = rng.choice([("3MB",), ("8MB",), CAPS])
                docs.append(doc(f"prop-{rnd}-{i}", scens, designs_at(caps)))
            responses = _fire_concurrently(svc, docs)
            assert all(r is not None for r in responses)
            for d, resp in zip(docs, responses):
                assert resp["ok"], resp.get("error")
                expected = run_cpu(d)
                assert_rows_match(resp["rows"], expected.rows())
                assert_doc_close(resp["summary"], expected.summary())
        assert svc.coalescer.coalesced_requests > 0
        assert svc.coalescer.max_group >= 2
        assert svc.requests == svc.ok == 3 * 4
    finally:
        svc.close()


def test_identical_inflight_requests_dedup():
    d = doc("dedup-spec")
    svc = SweepService(window_ms=250.0, device=CPU)
    try:
        responses = _fire_concurrently(svc, [d, d, d], want=("summary",))
        assert all(r["ok"] for r in responses)
        assert all(r["source"] == "coalesced" for r in responses)
        assert svc.coalescer.deduped_requests == 2
        assert svc.coalescer.batches == 1
        assert_doc_close(responses[0]["summary"], responses[1]["summary"],
                         tol=0.0)
    finally:
        svc.close()


def test_incompatible_platforms_pass_through():
    a = doc("pt-gtx", SCENARIOS[:1], platforms=("gtx-1080ti",))
    b = doc("pt-tpu", SCENARIOS[:1], platforms=("tpu-v5e",))
    svc = SweepService(window_ms=250.0, device=CPU)
    try:
        responses = _fire_concurrently(svc, [a, b], want=("summary",))
        assert all(r["ok"] for r in responses)
        assert all(r["source"] == "evaluated" for r in responses)
        assert svc.coalescer.coalesced_requests == 0
    finally:
        svc.close()
    with pytest.raises(ValueError, match="platform axis"):
        spec_union([SymbolicSweepSpec.from_json(a).resolve(),
                    SymbolicSweepSpec.from_json(b).resolve()])


def test_coalescer_delivers_errors_exactly_once():
    def failing(spec):
        raise RuntimeError("engine down")

    co = Coalescer(evaluate=failing, window_ms=0.0)
    spec = SymbolicSweepSpec.from_json(doc("err")).resolve()
    try:
        with pytest.raises(RuntimeError, match="engine down"):
            co.submit(spec)
    finally:
        co.close()
    with pytest.raises(RuntimeError, match="closed"):
        co.submit(spec)


def test_result_cache_hits_and_spec_key_stability():
    d = doc("cache-spec")
    svc = SweepService(window_ms=0.0, device=CPU)
    try:
        first = svc.handle({"spec": d, "want": ["summary"]})
        second = svc.handle({"spec": d, "want": ["rows"]})
        assert first["ok"] and second["ok"]
        assert first["source"] == "evaluated"
        assert second["source"] == "cache"
        assert svc.cache.hits == 1 and svc.cache.misses == 1
    finally:
        svc.close()
    assert spec_key(SymbolicSweepSpec.from_json(d)) == spec_key(
        SymbolicSweepSpec.from_json(json.loads(json.dumps(d))))


def test_result_cache_bounded_eviction():
    cache = ResultCache(maxsize=2)
    for i in range(4):
        cache.put(f"k{i}", f"r{i}")
    assert len(cache) == 2
    assert cache.get("k0") is None and cache.get("k3") == "r3"
    assert (cache.hits, cache.misses) == (1, 1)


def test_close_drains_slow_inflight_request():
    release = threading.Event()

    def slow(spec):
        release.wait(5.0)
        return evaluate_spec(spec, device=CPU)

    svc = SweepService(window_ms=50.0, evaluate=slow, device=CPU)
    responses = []

    def transport():
        with svc.track():
            responses.append(svc.handle({"spec": doc("slow-spec"),
                                         "want": ["summary"]}))

    t = threading.Thread(target=transport)
    t.start()
    time.sleep(0.15)
    release.set()
    svc.close()
    t.join(10.0)
    assert not t.is_alive()
    assert len(responses) == 1 and responses[0]["ok"]
    post = svc.handle({"spec": doc("post-close"), "want": ["summary"]})
    assert not post["ok"] and "closed" in post["error"]
    svc.close()


def test_stats_document_and_ops():
    svc = SweepService(window_ms=0.0, device=CPU)
    try:
        assert svc.handle({"op": "ping"}) == {"ok": True, "op": "ping"}
        bad = svc.handle({"op": "reboot"})
        assert not bad["ok"] and "unknown op" in bad["error"]
        d = doc("stats-spec", SCENARIOS[:1])
        svc.handle({"spec": d})
        svc.handle({"spec": d})
        svc.handle({"spec": {"schema": "bogus"}})
        stats = svc.handle({"op": "stats"})["stats"]
        assert stats["requests"] == {"total": 4, "ok": 2, "errors": 2}
        assert stats["result_cache"]["hits"] == 1
        assert stats["result_cache"]["misses"] == 1
        assert stats["coalesce"]["enabled"]
        assert stats["cells"]["total"] == 2 * 1 * 3
        assert stats["cells"]["p50"] == 3.0
        assert stats["elapsed_ms"]["p50"] > 0
        assert stats["elapsed_ms"]["p95"] >= stats["elapsed_ms"]["p50"]
        json.dumps(stats)
    finally:
        svc.close()


def test_http_transport_roundtrip_and_client_cli(capsys):
    svc = SweepService(window_ms=5.0, device=CPU)
    srv = service_mod.SweepHTTPServer(("127.0.0.1", 0), svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"127.0.0.1:{srv.server_address[1]}"
    try:
        assert client.wait_ready(url, timeout=10.0)
        resp = client.http_request(url, {"spec": doc("http-spec"),
                                         "want": ["summary"]})
        assert resp["ok"] and "summary" in resp
        bad = client.http_request(url, {"spec": {"schema": "bogus"}})
        assert not bad["ok"] and "error" in bad
        stats = client.http_stats(url)
        assert stats["ok"] and stats["stats"]["requests"]["total"] == 2
        path = os.path.join(SPECS, "isocap.json")
        assert client.main([path, path, "--url", url, "--want", "rows",
                            "--stats"]) == 0
        out = capsys.readouterr()
        lines = [json.loads(x) for x in out.out.splitlines()]
        want = sweep.load_spec(path).run(device=CPU).rows()
        assert len(lines) == 2
        for resp in lines:
            assert resp["ok"] and resp["cells"] == 30
            assert_rows_match(resp["rows"], want)
        assert json.loads(out.err)["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_http_burst_of_concurrent_clients():
    """64 clients at once on a cold service (the four goldens, 16 each):
    every one answered.  socketserver's listen backlog of 5 overflows
    while the first evaluation holds the interpreter, and the kernel
    resets the waiting connections."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import engine, workload_engine
    sweep.clear_cache()
    engine.design_table.cache_clear()
    workload_engine.evaluate_platforms.cache_clear()
    names = ("isocap", "dtco", "dtco_isoarea", "lm_nvm")
    svc = SweepService(window_ms=5.0, device=CPU)
    srv = service_mod.SweepHTTPServer(("127.0.0.1", 0), svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"127.0.0.1:{srv.server_address[1]}"
    try:
        with ThreadPoolExecutor(max_workers=64) as pool:
            out = list(pool.map(lambda n: client.http_request(
                url, {"spec": golden(n), "want": ["summary"]}, 120.0),
                [n for n in names for _ in range(16)]))
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    for resp, name in zip(out, [n for n in names for _ in range(16)]):
        assert resp["ok"], resp.get("error")
        assert_doc_close(resp["summary"], run_cpu(golden(name)).summary())


@pytest.mark.skipif(service_mod.SweepUnixServer is None,
                    reason="no AF_UNIX on this platform")
def test_unix_transport_roundtrip(tmp_path):
    path = str(tmp_path / "sweep.sock")
    svc = SweepService(window_ms=5.0, device=CPU)
    srv = service_mod.SweepUnixServer(path, svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        resps = client.unix_request(path, [
            {"spec": doc("unix-spec"), "want": ["summary"]},
            {"op": "stats"},
            {"spec": {"schema": "bogus"}},
        ])
        assert resps[0]["ok"] and "summary" in resps[0]
        assert resps[1]["ok"] and resps[1]["op"] == "stats"
        assert not resps[2]["ok"]
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def _serve_process(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.sweep", "serve", *args],
        cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    for _ in range(200):
        line = proc.stderr.readline()
        if not line:
            break
        if line.startswith("listening on http://"):
            return proc, line.split("http://", 1)[1].strip()
    proc.kill()
    proc.communicate()
    raise AssertionError("server never reported its address")


def test_serve_subprocess_sigterm_graceful():
    # a 500 ms coalescing window holds the second request in flight
    proc, url = _serve_process("--device", "cpu", "--http", "127.0.0.1:0",
                               "--window-ms", "500", "--stats-on-exit")
    try:
        resp = client.http_request(
            url, {"spec": doc("sigterm-spec", SCENARIOS[:1]),
                  "want": ["summary"]}, timeout=120.0)
        assert resp["ok"]
        inflight = {}
        t = threading.Thread(target=lambda: inflight.update(
            resp=client.http_request(url, {"spec": golden("dtco"),
                                           "want": ["summary"]},
                                     timeout=120.0)))
        t.start()
        deadline = time.monotonic() + 30.0
        while not client.http_stats(url)["stats"]["limits"]["pending"]:
            assert time.monotonic() < deadline, "request never admitted"
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60.0)
        t.join(60.0)
        assert not t.is_alive()
        assert proc.returncode == 0
        assert inflight["resp"]["ok"] and inflight["resp"]["cells"] == 120
        stats = json.loads(err)
        assert stats["requests"]["ok"] == 2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_serve_subprocess_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "serve", "--http",
         "127.0.0.1:0"], cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "listening on" not in out.stderr


# ---------------------------------------------------------------------------
# LM @b<n> scenarios
# ---------------------------------------------------------------------------


def test_lm_batch_override_resolve_and_inverse():
    base = scenarios.resolve("lm/qwen3-14b/prefill_32k")
    s8 = scenarios.resolve("lm/qwen3-14b/prefill_32k@b8")
    assert s8.batch == 8
    assert s8.workload == "qwen3-14b/prefill_32k@b8"
    assert scenarios.name_of(s8) == "lm/qwen3-14b/prefill_32k@b8"
    assert scenarios.resolve("lm/qwen3-14b/prefill_32k@b8") is s8
    assert s8 is not base
    from repro_torch.core.tech import GTX_1080TI
    spec = sweep.SweepSpec(name="lm-b", scenarios=(base, s8),
                           designs=sweep.design_grid(("sram", "stt"),
                                                     (3.0,)),
                           platforms=(GTX_1080TI,))
    assert len(spec.scenarios) == 2


def test_lm_batch_override_errors():
    for bad in ("lm/qwen3-14b/prefill_32k@b0",
                "lm/qwen3-14b/prefill_32k@bx",
                "lm/qwen3-14b/prefill_32k@b-1"):
        with pytest.raises(ValueError):
            scenarios.resolve(bad)
    with pytest.raises(ValueError, match="positive int"):
        scenarios.lm_traffic("qwen3-14b", "prefill_32k", batch=0)


def test_lm_batch_names_registered():
    names = scenarios.names()
    assert "lm/qwen3-14b/prefill_32k" in names
    for b in scenarios.LM_BATCHES:
        assert f"lm/qwen3-14b/prefill_32k@b{b}" in names
    for name in names:
        if name.startswith("lm/") and "@b8" in name:
            assert scenarios.name_of(scenarios.resolve(name)) == name


def test_lm_batch_cells_through_service():
    d = doc("lm-b-mix",
            scens=("lm/qwen3-14b/decode_32k", "lm/qwen3-14b/decode_32k@b32"),
            designs=designs_at(("3MB",)))
    svc = SweepService(window_ms=0.0, device=CPU)
    try:
        resp = svc.handle({"spec": d, "want": ["rows"]})
        assert resp["ok"], resp.get("error")
        assert_rows_match(resp["rows"], run_cpu(d).rows())
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------


def test_oversize_request_refused_with_413():
    svc = SweepService(window_ms=0.0, max_body_bytes=128, device=CPU)
    try:
        resp = svc.handle("x" * 256)
        assert resp["ok"] is False and resp["status"] == 413
        assert "RequestTooLarge" in resp["error"]
        limits = svc.stats()["limits"]
        assert limits["rejected_too_large"] == 1
        assert limits["max_body_bytes"] == 128
        assert svc.handle(json.dumps({"op": "ping"}))["ok"]
    finally:
        svc.close()


def test_overload_refused_with_429_and_cache_hits_exempt():
    release = threading.Event()

    def slow(spec):
        release.wait(timeout=60.0)
        return evaluate_spec(spec, device=CPU)

    svc = SweepService(window_ms=0.0, coalesce=False, evaluate=slow,
                       max_pending=1, device=CPU)
    warm = doc("bp-warm")
    try:
        release.set()
        assert svc.handle(warm)["ok"]
        release.clear()
        first = {}
        t = threading.Thread(
            target=lambda: first.update(resp=svc.handle(doc("bp-slow"))))
        t.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            with svc._lock:
                if svc._pending:
                    break
            time.sleep(0.01)
        refused = svc.handle(doc("bp-refused"))
        assert refused["ok"] is False and refused["status"] == 429
        assert "ServiceOverloaded" in refused["error"]
        assert svc.handle({"op": "stats"})["ok"]
        hit = svc.handle(warm)
        assert hit["ok"] and hit["source"] == "cache"
        release.set()
        t.join(timeout=60.0)
        assert not t.is_alive()
        assert first["resp"]["ok"]
        limits = svc.stats()["limits"]
        assert limits["rejected_overloaded"] == 1
        assert limits["pending"] == 0
    finally:
        release.set()
        svc.close()


def test_http_oversize_body_refused_before_read():
    svc = SweepService(window_ms=0.0, max_body_bytes=512, device=CPU)
    srv = service_mod.SweepHTTPServer(("127.0.0.1", 0), svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"127.0.0.1:{srv.server_address[1]}"
    try:
        assert client.wait_ready(url, timeout=10.0)
        big = doc("http-too-big", scens=tuple(SCENARIOS) * 40,
                  designs=designs_at(CAPS) * 40)
        assert len(json.dumps(big)) > 512
        resp = client.http_request(url, big)
        assert resp["ok"] is False and resp["status"] == 413
        assert client.http_request(url, {"op": "ping"})["ok"]
        assert client.http_stats(url)["stats"]["limits"][
            "rejected_too_large"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


# ---------------------------------------------------------------------------
# Threads: more callers than cores, a short switch interval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False])
def test_concurrent_callers_stress(coalesce):
    """16 callers over 4 distinct documents, interleaved at a 1 us switch
    interval: every response right, no counter update lost.  Without
    coalescing the callers evaluate concurrently, racing on the engines'
    memos."""
    from repro_torch.core import engine, workload_engine
    engine.design_table.cache_clear()
    workload_engine.evaluate_platforms.cache_clear()
    docs = [doc(f"stress-{i}", SCENARIOS[i:i + 2], designs_at(CAPS[i % 2:]))
            for i in range(4)]
    want = {d["name"]: run_cpu(d).rows() for d in docs}
    svc = SweepService(window_ms=2.0, coalesce=coalesce, device=CPU)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        responses = _fire_concurrently(svc, [docs[i % 4] for i in range(16)],
                                       want=("rows",))
    finally:
        sys.setswitchinterval(old)
        svc.close()
    for resp in responses:
        assert resp["ok"], resp.get("error")
        assert_rows_match(resp["rows"], want[resp["name"]])
    stats = svc.stats()
    assert stats["requests"] == {"total": 16, "ok": 16, "errors": 0}
    cache = stats["result_cache"]
    assert cache["hits"] + cache["misses"] == 16
    assert cache["size"] == 4
    assert stats["limits"]["pending"] == 0
