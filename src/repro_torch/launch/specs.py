"""The training schedule per architecture, ported from
`repro.launch.specs.schedule_for`.  The rest of the JAX module lowers
abstract TPU cells for the dry-run and is not ported."""

from __future__ import annotations

from functools import partial

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.schedules import cosine, wsd


def schedule_for(cfg: ArchConfig):
    """MiniCPM trains with WSD (its paper's contribution); others cosine."""
    if "minicpm" in cfg.name:
        return partial(wsd, peak=1e-2, warmup=2000, total=100_000)
    return partial(cosine, peak=3e-4, warmup=2000, total=100_000)
