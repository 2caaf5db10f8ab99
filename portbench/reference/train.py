"""The training step of the reference: the loss of a plain reference model
(the `Reference` of the cell's architecture module), autograd's gradients,
global-norm clipping and AdamW with the configuration's schedule, all in
float32.

AdamW as the configuration states it: g scaled by min(1, clip / (|g| +
1e-9)); m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2; p -= lr (m / (1 -
b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + lr wd p on the decayed leaves
(every leaf but those named in `no_decay`).  WSD: linear warmup to the peak
over `warmup` steps ((t + 1) / warmup), then flat, then peak x
final_frac^x over the last `decay_frac` of `total`.  The schedule is read
at the optimizer's step count t = 1, 2, ...
"""

from __future__ import annotations

import math

import torch


def wsd(step: int, peak: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> float:
    if step < warmup:
        return peak * min(1.0, (step + 1) / max(1, warmup))
    start = total * (1 - decay_frac)
    x = min(1.0, max(0.0, (step - start) / max(1.0, total - start)))
    return peak * final_frac ** x


def cosine(step: int, peak: float, warmup: int, total: int,
           final_frac: float = 0.1) -> float:
    if step < warmup:
        return peak * min(1.0, (step + 1) / max(1, warmup))
    x = min(1.0, max(0.0, (step - warmup) / max(1, total - warmup)))
    return peak * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(
        math.pi * x)))


def learning_rate(cfg: dict, step: int) -> float:
    s = dict(cfg["schedule"])
    kind = s.pop("kind")
    return {"wsd": wsd, "cosine": cosine}[kind](step, **s)


def flat_leaves(params) -> list[tuple[str, torch.Tensor]]:
    from portbench.weights import leaves
    return leaves(params)


class Trainer:
    """Steps the reference model `ref` (its `cfg` and `loss`) from `params`
    (trained in place) on batches."""

    def __init__(self, ref, params: dict):
        self.cfg, self.ref = ref.cfg, ref
        self.params = params
        self.named = flat_leaves(params)
        self.opt = ref.cfg["optimizer"]
        no_decay = set(self.opt.get("no_decay", ()))
        self.decay = [name not in no_decay for name, _ in self.named]
        self.m = self.v = None
        self.t = 0

    def step(self, tokens, labels) -> tuple[float, list[float]]:
        """One step; returns (loss, each leaf's clipped-gradient norm)."""
        leaves = [p for _, p in self.named]
        for p in leaves:
            p.requires_grad_(True)
        loss = self.ref.loss(self.params, tokens, labels)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        for p in leaves:
            p.requires_grad_(False)
        o = self.opt
        with torch.no_grad():
            norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            scale = torch.clamp(o["clip_norm"] / (norm + 1e-9), max=1.0)
            if self.m is None:
                self.m = [torch.zeros_like(p) for p in leaves]
                self.v = [torch.zeros_like(p) for p in leaves]
            self.t += 1
            lr = learning_rate(self.cfg, self.t)
            b1, b2 = o["b1"], o["b2"]
            b1c, b2c = 1 - b1 ** self.t, 1 - b2 ** self.t
            norms = []
            for p, g, m, v, dec in zip(leaves, grads, self.m, self.v,
                                       self.decay):
                g = g * scale
                norms.append(g.norm())
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (m / b1c) / ((v / b2c).sqrt() + o["eps"])
                if dec:
                    delta = delta + o["weight_decay"] * p
                p.sub_(lr * delta)
            del grads
            norms = torch.stack(norms).tolist()
        return float(loss.detach()), norms

    def free_state(self) -> None:
        self.m = self.v = None
