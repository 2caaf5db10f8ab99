"""Tiny twins of the benchmark's configurations and traffic mixes for the
CPU tests, and a copy of the benchmark in a temporary directory whose cells
run them under the real cells' names.  Nothing here runs on the chip.

Every configuration and every mix that a cell of `BENCHMARK.json` names
has a twin of the same name: `twins/<config>.json`, `twins/<traffic>.json`.
`twins/mid/` holds larger ones where a test needs them: a size at which
the models amplify rounding as the real ones do (10 layers, d 256, hd 64,
4096 tokens, 32 requests checked), the control's.  Adding a cell is adding
its twins; nothing here changes."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import harness, spec

TWINS = Path(__file__).resolve().parent / "twins"


def twin(name: str, mid: bool = False) -> dict:
    """The twin `name` (with `mid`, its mid-size twin where there is one)."""
    path = TWINS / "mid" / f"{name}.json"
    if not (mid and path.is_file()):
        path = TWINS / f"{name}.json"
    return json.loads(path.read_text())


def twin_files(cell: dict, twins: Path = TWINS) -> list[Path]:
    return [twins / f"{cell[k]}.json" for k in ("config", "traffic")]


def missing_twins(bench: dict, twins: Path = TWINS) -> list[str]:
    """The twin files that cells of `bench` name and that do not exist."""
    return sorted({str(p) for w in bench["workloads"]
                   for p in twin_files(w, twins) if not p.is_file()})


DENSE = twin("minicpm-2b")
MOE = twin("deepseek-moe-16b")
TRAIN = twin("train.4x2048")
SERVE = twin("serve.longprompt")
MID = {"dense": twin("minicpm-2b", mid=True),
       "moe": twin("deepseek-moe-16b", mid=True),
       "serve": twin("serve.longprompt", mid=True)}


def copy(tmp: Path, mid: bool = False) -> tuple[Path, Path]:
    """(root, portbench) of a copy of the benchmark in `tmp` whose cells
    run their configurations' and mixes' twins (`mid`: the mid-size ones
    where there are), written over the copy's configuration and mix files.
    A cell without both twins is left out (`missing_twins` names them)."""
    tmp = Path(tmp)
    here = tmp / "portbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    bench["workloads"] = [w for w in bench["workloads"]
                          if all(p.is_file() for p in twin_files(w))]
    for w in bench["workloads"]:
        (here / "configs" / f"{w['config']}.json").write_text(
            json.dumps(twin(w["config"], mid)))
        (here / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(twin(w["traffic"], mid)))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, here


def run(root: Path, here: Path, workload: str, seed: int = 2**31 + 77,
        seconds: float = 0.5, trace: bool = False) -> tuple[dict, dict]:
    """(result line, checks) of a run on the CPU, the look for a chip
    skipped."""
    r = harness.make_run(workload, seed, seconds, trace, "cpu",
                         time.perf_counter(), here=here, root=root)
    return harness.run_cell(r)


def make(root: Path, here: Path, workload: str, seed: int = 2**31 + 77,
         seconds: float = 0.5):
    return harness.make_run(workload, seed, seconds, False, "cpu",
                            time.perf_counter(), here=here, root=root)
