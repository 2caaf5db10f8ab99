"""The port's sweep CLI (`python -m repro_torch.sweep run|show|mega|serve|invert`)
on the CPU, against the JAX reference's CLI (`repro.sweep_cli`) and
against the port's own in-process pipeline.

`run --csv` on the golden specs matches the reference CLI's CSV within
1e-12 relative with equal labels, and the port's in-process
`sweep.run(..., device="cpu").rows()` bit for bit (the CSV writes floats
with `report.fmt_exact`); `show` prints what the reference prints; `mega
--quick --summary` matches the reference's summary within 1e-12.  The
port's decisions: `--device` defaults to cuda and raises without it,
`--devices` takes only 1, and `serve --compile-cache` raises.  `invert`
on the shipped problem document and on a bare sweepspec, with the flag
overrides, writes the reference CLI's result document (the solve's floats
within 1e-9 relative, parity <= 1e-12).

The reference's engines import `jax.experimental.enable_x64`, which JAX
0.9 no longer has; the `ref` fixture aliases it to `jax.enable_x64` when
it first runs, never at import.
"""

from __future__ import annotations

import csv
import io
import json
import math
import os
import subprocess
import sys
import types

import pytest
import torch

from repro_torch import scenarios, sweep_cli
from repro_torch.core import dtco, isocap, sweep, tech

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPECS = os.path.join(ROOT, "specs")
REL = 1e-12
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's CLI, imported with the R1 alias."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro import sweep_cli as rcli
    return types.SimpleNamespace(cli=rcli)


def spec_path(name: str) -> str:
    return os.path.join(SPECS, name)


def _csv_rows(path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _assert_csv_close(got_path, want_path):
    """Equal headers and label columns; numeric columns within REL."""
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, wv in w.items():
            try:
                fw = float(wv)
            except ValueError:
                assert g[k] == wv, k
            else:
                assert abs(float(g[k]) - fw) <= REL * abs(fw), (k, g[k], wv)


def _assert_csv_matches_rows(csv_path, rows):
    """The CSV against in-process rows: floats exact (repr round trip)."""
    got = _csv_rows(csv_path)
    assert len(got) == len(rows)
    for parsed, want in zip(got, rows):
        assert parsed.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert float(parsed[k]) == v, k
            else:
                assert parsed[k] == str(v), k


def _assert_json_close(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_json_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= REL * abs(want), (where, got, want)
    else:
        assert got == want, where


# ---------------------------------------------------------------------------
# Against the reference CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("golden,pyspec", [
    ("isocap.json", lambda: isocap.spec()),
    ("dtco.json", lambda: dtco.spec()),
    # benchmarks/lm_nvm.py's spec, which the JSON document resolves to
    ("lm_nvm.json", lambda: scenarios.lm_sweep_spec(
        platforms=(tech.TPU_V5E, tech.GTX_1080TI), name="lm-nvm")),
])
def test_cli_run_csv_matches_reference_and_pipeline(ref, golden, pyspec,
                                                    tmp_path):
    out, rout = tmp_path / "port.csv", tmp_path / "ref.csv"
    sweep_cli.main(["run", spec_path(golden), "--csv", str(out), *CPU])
    ref.cli.main(["run", spec_path(golden), "--csv", str(rout)])
    _assert_csv_close(out, rout)
    _assert_csv_matches_rows(out, sweep.run(pyspec(), device="cpu").rows())


def test_cli_run_views_match_reference(ref, tmp_path, capsys):
    """--pareto, --plateaus, --summary and --include-dram on a spec with a
    capacity axis and CNN and LM scenarios."""
    outs = {}
    for side, main in (("port", sweep_cli.main), ("ref", ref.cli.main)):
        d = tmp_path / side
        d.mkdir()
        argv = ["run", spec_path("mixed_cnn_lm.json"), "--csv",
                str(d / "rows.csv"), "--pareto", str(d / "pareto.csv"),
                "--plateaus", str(d / "plateaus.csv"), "--summary",
                "--include-dram"]
        main(argv + (CPU if side == "port" else []))
        outs[side] = (d, json.loads(capsys.readouterr().out))
    for name in ("rows.csv", "pareto.csv", "plateaus.csv"):
        _assert_csv_close(outs["port"][0] / name, outs["ref"][0] / name)
    _assert_json_close(outs["port"][1], outs["ref"][1])


@pytest.mark.parametrize("golden", ["isocap.json", "dtco.json",
                                    "dtco_isoarea.json", "lm_nvm.json",
                                    "mixed_cnn_lm.json"])
def test_cli_show_matches_reference(ref, golden, capsys):
    sweep_cli.main(["show", spec_path(golden)])
    got = capsys.readouterr()
    ref.cli.main(["show", spec_path(golden)])
    want = capsys.readouterr()
    assert got.out == want.out and got.out


def test_cli_mega_quick_summary_matches_reference(ref, capsys):
    sweep_cli.main(["mega", "--quick", "--summary", *CPU])
    got = capsys.readouterr()
    ref.cli.main(["mega", "--quick", "--summary"])
    want = capsys.readouterr()
    assert "mega-quick" in got.err and "cells/s" in got.err
    assert got.err.splitlines()[0] == want.err.splitlines()[0]  # axes, plan
    _assert_json_close(json.loads(got.out), json.loads(want.out))


# ---------------------------------------------------------------------------
# The reference CLI's contracts, on the port
# ---------------------------------------------------------------------------


def test_cli_stdout_and_stdin(capsys, monkeypatch):
    text = open(spec_path("isocap.json")).read()
    monkeypatch.setattr("sys.stdin", io.StringIO(text))
    sweep_cli.main(["run", "-", "--no-norm", *CPU])
    header = capsys.readouterr().out.splitlines()[0]
    assert header.startswith("platform,workload,batch,stage,mem")
    assert "_x" not in header


@pytest.mark.parametrize("shard_args", [["--shard", "3", "--by-width"],
                                        ["--design-chunk", "2",
                                         "--devices", "1"]])
def test_cli_run_sharded_matches_unsharded(tmp_path, shard_args):
    plain, sharded = tmp_path / "a.csv", tmp_path / "b.csv"
    path = spec_path("isocap.json")
    sweep_cli.main(["run", path, "--csv", str(plain), *CPU])
    sweep_cli.main(["run", path, "--csv", str(sharded), *shard_args, *CPU])
    _assert_csv_close(sharded, plain)


def test_cli_mega_quick_sharded(capsys):
    sweep_cli.main(["mega", "--quick", "--shard", "10", "--design-chunk",
                    "6", "--summary", *CPU])
    out = capsys.readouterr()
    assert "mega-quick" in out.err and "cells/s" in out.err
    assert json.loads(out.out)


def test_serve_answers_and_survives_bad_requests():
    doc = json.load(open(spec_path("isocap.json")))
    requests = [
        json.dumps(doc),
        json.dumps({"spec": doc, "want": ["rows", "pareto"]}),
        "{not json",
        json.dumps({"spec": {"schema": "bogus"}}),
        json.dumps({"spec": doc, "want": ["everything"]}),
    ]
    out = io.StringIO()
    served = sweep_cli.serve(io.StringIO("\n".join(requests) + "\n"), out,
                             device="cpu")
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == len(requests)
    assert [r["ok"] for r in resp] == [True, True, False, False, False]
    assert resp[0]["summary"]["gtx-1080ti"]["sot"]["edp_reduction_max"] > 1
    assert len(resp[1]["rows"]) \
        == len(sweep.run(isocap.spec(), device="cpu").rows())
    json.dumps(resp)


def test_serve_reports_cells_and_shard():
    with open(spec_path("isocap.json")) as f:
        doc = json.load(f)
    req = {"spec": doc, "want": ["summary"],
           "shard": {"scenario_chunk": 4, "by_width": True}}
    out = io.StringIO()
    served = sweep_cli.serve(
        io.StringIO(json.dumps(req) + "\n" + json.dumps(doc) + "\n"), out,
        device="cpu")
    assert served == 2
    for resp in (json.loads(x) for x in out.getvalue().splitlines()):
        assert resp["ok"] and resp["cells"] == 30
        assert resp["elapsed_ms"] > 0
    bad = sweep_cli.answer(json.dumps({"spec": doc, "shard": {"bogus": 1}}),
                           device="cpu")
    assert not bad["ok"] and "shard" in bad["error"]


def test_answer_keeps_one_default_service_per_device():
    first = sweep_cli._service("cpu")
    assert sweep_cli._service(torch.device("cpu")) is first
    assert sweep_cli.answer({"op": "ping"}, device="cpu")["ok"]


# ---------------------------------------------------------------------------
# The port's decisions: the device, --devices, --compile-cache
# ---------------------------------------------------------------------------

NO_DEVICE = {
    "run": lambda: sweep_cli.main(["run", spec_path("isocap.json")]),
    "mega": lambda: sweep_cli.main(["mega", "--quick"]),
    "serve": lambda: sweep_cli.main(["serve"]),
    "answer": lambda: sweep_cli.answer({"op": "ping"}),
    "serve_stdio": lambda: sweep_cli.serve(io.StringIO(""), io.StringIO()),
    "invert": lambda: sweep_cli.main(["invert",
                                      spec_path("inverse_isocap.json")]),
}


@pytest.mark.parametrize("entry", sorted(NO_DEVICE))
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NO_DEVICE[entry]()


def test_show_needs_no_device(capsys):
    sweep_cli.main(["show", spec_path("dtco.json")])
    assert capsys.readouterr().out.startswith("dtco: 1 platforms x 10 "
                                              "scenarios x 12 designs")


@pytest.mark.parametrize("cmd", [["run", spec_path("isocap.json")],
                                 ["mega", "--quick"]])
def test_devices_other_than_one_fail(cmd):
    with pytest.raises(ValueError, match=r"one device \(found \d+ CUDA"):
        sweep_cli.main([*cmd, "--devices", "2", *CPU])


def test_compile_cache_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="compilation cache"):
        sweep_cli.main(["serve", "--compile-cache", str(tmp_path / "cc"),
                        *CPU])
    assert not (tmp_path / "cc").exists()


# invert: the port's CLI against the reference's on the same document and
# flags.  The solve's floats within 1e-9 relative (a few dozen Adam steps
# carry the last ulps of two implementations), parity <= 1e-12 on both
# sides, everything else equal.
INVERT_CASES = {
    "shipped-iso-area": ["inverse_isocap.json", "--objective", "edp",
                         "--iso-area", "--starts", "2", "--iters", "20"],
    "bare-spec-budget": ["isocap.json", "--budget", "4.0", "--starts", "2",
                         "--iters", "15", "--lr", "0.1", "--seed", "3"],
    "target-no-budget-dram": ["inverse_isocap.json", "--no-budget",
                              "--target", "0.5", "--include-dram",
                              "--starts", "1", "--iters", "10"],
}


def _assert_invert_close(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            if k == "parity_rel_err":
                assert got[k] <= 1e-12 and want[k] <= 1e-12, where
            else:
                _assert_invert_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_invert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), where     # a start past the STT wall
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-9 * abs(want), (where, got, want)
    else:
        assert got == want, where


@pytest.mark.parametrize("case", sorted(INVERT_CASES))
def test_cli_invert_matches_reference(ref, case, tmp_path, capsys):
    spec, *flags = INVERT_CASES[case]
    rout = tmp_path / "ref.json"
    ref.cli.main(["invert", spec_path(spec), *flags, "--json", str(rout)])
    want = json.loads(rout.read_text())
    capsys.readouterr()
    if case == "target-no-budget-dram":      # the default: stdout
        sweep_cli.main(["invert", spec_path(spec), *flags, *CPU])
        got = json.loads(capsys.readouterr().out)
    else:
        out = tmp_path / "port.json"
        sweep_cli.main(["invert", spec_path(spec), *flags, "--json",
                        str(out), *CPU])
        got = json.loads(out.read_text())
    _assert_invert_close(got, want)
    assert got["schema"] == "deepnvm.inverse_result/1"
    assert got["problem"]["iters"] == int(flags[flags.index("--iters") + 1])


def test_module_entry_point_runs_and_raises_without_device(tmp_path):
    """`python -m repro_torch.sweep` as a user runs it: with `--device
    cpu` it writes the same CSV as the in-process run; without a device
    it fails here, printing nothing to stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tmp_path / "dtco.csv"
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "run",
         spec_path("dtco.json"), "--csv", str(out), *CPU],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert "dtco: 120 rows" in done.stderr
    _assert_csv_matches_rows(out, sweep.run(dtco.spec(), device="cpu").rows())
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, "-m", "repro_torch.sweep", "run",
             spec_path("isocap.json")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert bad.returncode != 0 and not bad.stdout
        assert "CUDA is not available" in bad.stderr
