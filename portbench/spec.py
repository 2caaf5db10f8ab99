"""Finds what a cell names, each in a file of its own under `portbench/`:
its entry in `BENCHMARK.json`, its configuration (`configs/<config>.json`),
the architecture module that configuration names (`arch/<arch>.py`), its
traffic mix (`traffic/<traffic>.json`), its correctness limits
(`limits/<workload>.json`) and the reader of each per-layer metric
(`metrics/<metric>.py`).  Adding an architecture, configuration, mix or
metric is adding its file and its entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str, here: Path) -> dict:
    path = here / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"workload {name!r} is not in BENCHMARK.json: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, here: Path = HERE) -> dict:
    return _json("configs", name, here)


def traffic(name: str, here: Path = HERE) -> dict:
    return _json("traffic", name, here)


def limits(name: str, here: Path = HERE) -> dict:
    return _json("limits", name, here)


def applies(metric: dict, workload_name: str) -> bool:
    return "workloads" not in metric or workload_name in metric["workloads"]


def metrics_of(bench: dict, workload_name: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    return ([m for m in bench["end_to_end"] if applies(m, workload_name)],
            [m for m in bench["per_layer"] if applies(m, workload_name)])


def _module(path: Path, what: str):
    """The module at `path`, loaded by its path (a name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {what}: {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, here: Path = HERE):
    """The module `metrics/<name>.py`.  It defines `read(ctx) -> float |
    None` and may define `SPANS`, {label: "module:function"}: the
    program's functions that the traced run wraps in spans for it."""
    return _module(here / "metrics" / f"{name}.py",
                   f"reader for metric {name!r}")


DEFAULT_ARCH = "decoder"


def arch(cfg: dict, here: Path = HERE):
    """The module `arch/<cfg["arch"]>.py` (`decoder` where the
    configuration names none): everything of the harness that depends on
    the model's architecture.  It defines `port_config(cfg)` (the port's
    configuration object), `segments(cfg)` and `block_layout(cfg, kind)`
    (the leaves `weights.make` draws), `Reference` (the plain float32
    model: `Reference(cfg, prec)` with `last_logits` and `loss`), and
    `prefill_flops(cfg, b, s)` / `train_step_flops(cfg, b, s)` (model
    FLOPs)."""
    name = cfg.get("arch", DEFAULT_ARCH)
    return _module(here / "arch" / f"{name}.py",
                   f"architecture module for arch {name!r}")
