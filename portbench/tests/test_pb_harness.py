"""The harness finds what a cell names by its name alone, fails rather
than fall back without a chip, and hands the port weights in its own
layout."""

import json
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from portbench import program, spec, weights
from portbench.tests import tiny
from repro_torch.models import lm as lm_mod

NEW_METRIC = '''"""Counts the spans of the new function."""
SPANS = {"rmsnorm": "repro_torch.models.layers:rmsnorm"}


def read(ctx):
    n = len(ctx["reduced"].forward("rmsnorm"))
    return float(n) if n else None
'''


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root, here = tiny.copy(tmp_path)
    (here / "configs" / "dense-other.json").write_text(
        json.dumps(dict(tiny.DENSE, name="dense-other", n_layers=3)))
    (here / "traffic" / "serve.other.json").write_text(
        json.dumps(dict(tiny.SERVE, lengths=[8, 12])))
    (here / "limits" / "dense-other.serve.other.json").write_text(
        json.dumps({"token_gap": 1.0}))
    (here / "metrics" / "rmsnorm_calls.serve.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dense-other", "source": "t",
                             "file": "portbench/configs/dense-other.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "dense-other.serve.other",
                               "config": "dense-other",
                               "traffic": "serve.other", "chips": 1,
                               "why": "t"})
    bench["end_to_end"][1]["workloads"].append("dense-other.serve.other")
    bench["per_layer"].append({"name": "rmsnorm_calls.serve", "unit": "1",
                               "better": "lower", "source": "program_span",
                               "layer": "layers", "moves": "ttft_ms_p95",
                               "workloads": ["dense-other.serve.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = tiny.run(root, here, "dense-other.serve.other", trace=True)
    # 3 layers x 2 norms + the final norm, a batch, 3 traced batches
    assert result["metrics"]["rmsnorm_calls.serve"]["value"] == 21.0
    assert result["correct"]
    plain, _ = tiny.run(root, here, "dense-other.serve.other")
    assert set(plain["metrics"]) == {"ttft_ms_p95", "peak_mem_gib", "setup_s"}


def test_result_line_has_the_contracts_keys(tmp_path):
    root, here = tiny.copy(tmp_path)
    result, info = tiny.run(root, here, "minicpm-2b.train.4x2048")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "check"]
    assert set(result["check"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["check"].values())
    assert result["attempted"] >= 1


def _cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "minicpm-2b.train.4x2048", "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=300)


def test_no_cuda_device_means_no_result():
    assert not torch.cuda.is_available()
    done = _cli(spec.REPO)
    assert done.returncode == 2
    assert done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_a_directory_of_only_the_benchmark_gives_no_result(tmp_path):
    import shutil
    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _cli(tmp_path)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.parametrize("name", ["minicpm-2b", "deepseek-moe-16b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_weights_take_the_ports_layout(name, dtype):
    cfg = spec.config(name)
    with FakeTensorMode():
        port = lm_mod.build(program.arch(cfg)).init(None, dtype,
                                                    device="cpu")
    want = [(n, tuple(t.shape), t.dtype) for n, t in weights.leaves(port)]
    assert [n for n, _, _ in want] == weights.names(cfg)
    small = dict(tiny.MOE if cfg.get("moe") else tiny.DENSE)
    ours = weights.make(small, 1, "cpu", dtype)
    with FakeTensorMode():
        theirs = lm_mod.build(program.arch(small)).init(None, dtype,
                                                        device="cpu")
    assert [(n, tuple(t.shape), t.dtype) for n, t in weights.leaves(ours)] \
        == [(n, tuple(t.shape), t.dtype) for n, t in weights.leaves(theirs)]


def test_weights_are_a_function_of_the_seed():
    a = weights.make(tiny.MOE, 2**31 + 1, "cpu", torch.bfloat16)
    b = weights.make(tiny.MOE, 2**31 + 1, "cpu", torch.bfloat16)
    c = weights.make(tiny.MOE, 2**31 + 2, "cpu", torch.bfloat16)
    la, lb, lc = (weights.leaves(x) for x in (a, b, c))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], lc[0][1])


def test_the_benchmark_file_keeps_to_its_shape():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for w in bench["workloads"]:
        assert (spec.HERE / "configs" / f"{w['config']}.json").is_file()
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (spec.HERE / "limits" / f"{w['name']}.json").is_file()
        assert spec.arch(spec.config(w["config"])).Reference
        e2e, per_layer = spec.metrics_of(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert all(m["moves"] in names for m in per_layer)
    for m in bench["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
