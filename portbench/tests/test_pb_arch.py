"""A cell is added by new files and entries alone: the architecture a
configuration names is a module of its own (`arch/<name>.py`), found by
that name in the run's portbench directory, and every cell's tiny twins
are files (`tests/twins/`)."""

import hashlib
import json
import time

import pytest

from portbench import harness, program, spec
from portbench.arch import decoder
from portbench.tests import tiny

NEW_ARCH = '''"""The decoder's parts, each noting its use in USED."""
from portbench.arch import decoder

USED = set()


def _noted(name):
    def noted(*args, **kwargs):
        USED.add(name)
        return getattr(decoder, name)(*args, **kwargs)
    return noted


port_config = _noted("port_config")
segments = _noted("segments")
block_layout = _noted("block_layout")
prefill_flops = _noted("prefill_flops")
train_step_flops = _noted("train_step_flops")


class Reference(decoder.Reference):
    def __init__(self, cfg, prec="fp32"):
        USED.add("Reference")
        super().__init__(cfg, prec)
'''
CELL = "moe-other.serve.other"


def test_every_cell_has_its_twins():
    missing = tiny.missing_twins(spec.load_benchmark())
    assert not missing, f"twin files missing: {missing}"


def test_a_cell_without_twins_is_named_and_left_out(tmp_path, monkeypatch):
    bench = spec.load_benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    bench["workloads"].append({"name": "x.serve.longprompt", "config": "x",
                               "traffic": "serve.longprompt", "chips": 1,
                               "why": "t"})
    assert tiny.missing_twins(bench) == [str(tiny.TWINS / "x.json")]
    monkeypatch.setattr(spec, "load_benchmark", lambda root=spec.REPO: bench)
    root, _ = tiny.copy(tmp_path)
    copied = json.loads((root / "BENCHMARK.json").read_text())["workloads"]
    assert [w["name"] for w in copied] == cells


def _hashes(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_cell_of_a_new_architecture_is_added_by_new_files_only(tmp_path):
    root, here = tiny.copy(tmp_path)
    before = _hashes(root)
    old_bench = json.loads((root / "BENCHMARK.json").read_text())
    twins = here / "tests" / "twins"
    new_files = {
        here / "arch" / "decoder_twin.py": NEW_ARCH,
        here / "configs" / "moe-other.json": json.dumps(dict(
            tiny.MOE, name="moe-other", arch="decoder_twin", n_layers=3)),
        here / "traffic" / "serve.other.json": json.dumps(dict(
            tiny.SERVE, lengths=[8, 12])),
        here / "limits" / f"{CELL}.json": json.dumps({"token_gap": 1.0}),
        twins / "moe-other.json": json.dumps(dict(tiny.MOE,
                                                  arch="decoder_twin")),
        twins / "serve.other.json": json.dumps(tiny.SERVE)}
    assert not set(new_files) & set(before)
    for path, text in new_files.items():
        path.write_text(text)
    bench = json.loads(json.dumps(old_bench))
    bench["configs"].append({"name": "moe-other", "source": "t",
                             "file": "portbench/configs/moe-other.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": CELL, "config": "moe-other",
                               "traffic": "serve.other", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("ttft_ms_p95", "mfu.serve"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert not tiny.missing_twins(bench, twins)

    run = tiny.make(root, here, CELL)
    assert run.arch.__file__ == str(here / "arch" / "decoder_twin.py")
    result, _ = harness.run_cell(run)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"ttft_ms_p95", "peak_mem_gib",
                                      "setup_s"}
    assert run.arch.USED == {"port_config", "segments", "block_layout",
                             "Reference"}
    traced = harness.make_run(CELL, 2**31 + 78, 0.5, True, "cpu",
                              time.perf_counter(), here=here, root=root)
    result, _ = harness.run_cell(traced)
    assert result["correct"] and "mfu.serve" in result["metrics"]
    assert "prefill_flops" in traced.arch.USED

    after = json.loads((root / "BENCHMARK.json").read_text())
    assert after["configs"].pop()["name"] == "moe-other"
    assert after["workloads"].pop()["name"] == CELL
    for m in after["end_to_end"] + after["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].remove(CELL)
    assert after == old_bench   # entries added, none changed
    del before[root / "BENCHMARK.json"]
    assert {p: h for p, h in _hashes(root).items() if p in before} == before


def test_an_unknown_arch_names_the_missing_file(tmp_path):
    assert spec.arch({}).port_config is program.arch
    assert spec.arch({"arch": "decoder"}).Reference is decoder.Reference
    root, here = tiny.copy(tmp_path)
    (here / "configs" / "minicpm-2b.json").write_text(
        json.dumps(dict(tiny.DENSE, arch="no-such-arch")))
    with pytest.raises(FileNotFoundError) as err:
        tiny.make(root, here, "minicpm-2b.train.4x2048")
    assert str(here / "arch" / "no-such-arch.py") in str(err.value)
