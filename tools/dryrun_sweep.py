"""The whole dry-run sweep: every arch of `configs.all_archs()` at every
shape of `SHAPES` (40 cells, long_500k skipped for the eight models that
are not sub-quadratic), traced at full size on fake tensors, then the
roofline table of the records.

    python3 tools/dryrun_sweep.py [--device cuda] [--out runs/dryrun]

On the GPU machine (~3.5 min on an H100; chip_smoke's phase 9 runs a
subset) every cell traces through the kernels' shape functions.  With
`--device cpu` the plain twins run on fake CPU tensors, token by token
for RWKV6 and Hymba: hours at these shapes.  Prints the card's name and
power limit, one line a cell, then the table `launch.roofline` prints;
writes the records to `--out` and the table to `<out>/roofline.csv`.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="runs/dryrun")
    args = ap.parse_args()
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    for arch in configs.all_archs():
        for shape in SHAPES:
            dryrun.run_cell(arch, shape, args.out, device=args.device)
    print(f"swept in {time.perf_counter() - t0:.1f} s", flush=True)
    roofline.main(["--dir", args.out,
                   "--out", str(Path(args.out) / "roofline.csv")])


if __name__ == "__main__":
    main()
