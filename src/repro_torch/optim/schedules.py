"""LR schedules, ported from `repro.optim.schedules`: cosine, linear
warmup and WSD (warmup-stable-decay, MiniCPM).

Each takes the step as an int, a float or a tensor and returns a 0-d
float32 tensor, computed in fp32 as the JAX versions are."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def linear_warmup(step, warmup: int, peak: float) -> torch.Tensor:
    return peak * torch.clamp((_f32(step) + 1) / max(1, warmup), max=1.0)


def cosine(step, *, peak: float, warmup: int, total: int,
           final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = linear_warmup(step, warmup, peak)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, peak * cos)


def wsd(step, *, peak: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM): flat peak LR, sharp exponential-ish
    decay over the last `decay_frac` of training."""
    step = _f32(step)
    warm = linear_warmup(step, warmup, peak)
    decay_start = total * (1 - decay_frac)
    t = torch.clamp((step - decay_start) / max(1.0, total - decay_start),
                    0.0, 1.0)
    stable = peak * torch.pow(final_frac, t)   # exp decay to final_frac*peak
    return torch.where(step < warmup, warm, stable)
