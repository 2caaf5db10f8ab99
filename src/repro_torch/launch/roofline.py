"""Roofline analysis of the dry run's records, ported from
`repro.launch.roofline`, at one H100's peaks.

Per (arch x shape) record of `launch.dryrun`:

    compute term    = FLOPs / (devices * PEAK_BF16_FLOPS)
    memory term     = HBM bytes / (devices * PEAK_BYTES)
    collective term = 0: a one-device record moves nothing over a link

FLOPs and HBM bytes come from the analytic accounting (`launch.flops`),
as in the JAX package; the dry run's FlopCounterMode total (which leaves
the hand-written kernels out) is reported beside them.  Dominant term =
the bottleneck; fraction = compute / max(terms).  `fits_device`: the
traced peak below the device's memory (None for a CPU record).

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--dir runs/dryrun]
Writes runs/roofline.csv and prints the table.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES
from repro_torch.core.report import markdown_table, write_csv
from repro_torch.launch import flops as flops_mod

# NVIDIA H100 80GB HBM3 (SXM, 700 W, as `nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader` prints it on the card's machine), from
# its datasheet: dense bf16 on the tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def analyze_record(rec: dict) -> dict:
    if rec.get("status") != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"],
                "mesh": rec["mesh"], "status": rec["status"]}
    if rec["n_devices"] != 1:
        raise ValueError(f"{rec['arch']} x {rec['shape']}: "
                         f"{rec['n_devices']} devices; the port's records "
                         "are of one")
    cfg = configs.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    acct = flops_mod.account(cfg, shape)

    t_compute = acct.flops / PEAK_BF16_FLOPS
    t_memory = acct.hbm_bytes / PEAK_BYTES
    terms = {"compute": t_compute, "memory": t_memory, "collective": 0.0}
    dominant = max(terms, key=terms.get)
    t_bound = max(terms.values())
    peak = rec["memory"]["peak_bytes"]
    cap = rec.get("device_memory_bytes")
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": "ok", "chips": 1,
        "compute_s": t_compute, "memory_s": t_memory, "collective_s": 0.0,
        "dominant": dominant,
        "roofline_frac": t_compute / t_bound if t_bound else 0.0,
        "model_flops": acct.model_flops,
        "analytic_flops": acct.flops,
        "useful_ratio": acct.model_flops / acct.flops if acct.flops else 0.0,
        "traced_flops": rec["cost"].get("flops", 0) or 0,
        "mem_per_dev_gb": peak / 1e9,
        "fits_device": None if cap is None else peak < cap,
        "coll_gb": 0.0,
    }


def load_dir(d: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun")
    ap.add_argument("--out", default="runs/roofline.csv")
    args = ap.parse_args(argv)
    rows = [analyze_record(rec) for rec in load_dir(args.dir)]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    # the columns of an analysed record, where a skipped one leads
    write_csv(args.out, rows, next((list(r) for r in rows
                                    if r["status"] == "ok"), None))
    shown = [{k: r.get(k) for k in
              ("arch", "shape", "mesh", "dominant", "roofline_frac",
               "compute_s", "memory_s", "collective_s", "mem_per_dev_gb",
               "fits_device", "status")} for r in rows]
    print(markdown_table(shown))
    print(f"\nwrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
