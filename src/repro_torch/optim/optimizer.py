"""AdamW, the train state and the train-step builder, ported from
`repro.optim.optimizer`.

The update is the JAX one: global-norm clipping, bias correction with the
step in fp32, the update computed in fp32 and cast back to each leaf's
dtype, decoupled weight decay on the leaves `decay_mask` picks, gradient
accumulation over microbatches, and an optional `grad_transform` applied to
the gradients before the update.

Unlike the JAX version, `adamw_update` updates the state in place (params,
mu, nu and step) and returns it: TinyLlama-1.1B's fp32 params, mu and nu
come to 13 GB, and a functional update would hold them twice.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.convert import is_stacked


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Callable | None = None  # step -> lr; None: 3e-4


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict
    mu: dict
    nu: dict


_FIELDS = ("step", "params", "mu", "nu")
pytree.register_pytree_node(
    TrainState, lambda s: ([getattr(s, f) for f in _FIELDS], None),
    lambda children, _: TrainState(*children),
    serialized_type_name="repro_torch.optim.TrainState",
    flatten_with_keys_fn=lambda s: (
        [(pytree.GetAttrKey(f), getattr(s, f)) for f in _FIELDS], None))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    return torch.stack([x.float().square().sum()
                        for x in pytree.tree_leaves(tree)]).sum().sqrt()


def decay_mask(params: dict) -> list[bool]:
    """Per leaf of `params` (in `tree_leaves` order), whether AdamW decays
    it: every leaf of a block segment (`seg*`) or of Whisper's encoder
    blocks (`encoder`), and every other leaf with two or more dims.

    The JAX `adamw_update` decays `p.ndim >= 2` (repro/optim/optimizer.py:
    88-89), and its LM stacks a segment's block params, and the encoder's,
    along a leading layer axis (repro/models/lm.py:297-298, :445), so a
    block's norm scale is (L, d) there and is decayed; only the top-level
    1-D leaves (`ln_f.scale`, `ln_enc.scale`) escape.  The port keeps
    blocks as a list of per-layer dicts, where the same scale is (d,), so
    it decays by this rule to give the same update."""
    return pytree.tree_leaves({
        name: pytree.tree_map(
            lambda p, stacked=is_stacked(name): stacked or p.dim() >= 2, sub)
        for name, sub in params.items()})


def adamw_init(params: dict) -> TrainState:
    return TrainState(
        step=0, params=params,
        mu=pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
        nu=pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params))


def adamw_update(state: TrainState, grads, cfg: AdamWConfig,
                 grad_transform: Callable | None = None) -> TrainState:
    """One AdamW step on `state`, in place; returns it."""
    if grad_transform is not None:
        grads = grad_transform(grads)
    flat_g = pytree.tree_leaves(grads)
    scale = torch.clamp(cfg.clip_norm / (global_norm(flat_g) + 1e-9), max=1.0)
    step = state.step + 1
    lr = float(cfg.schedule(step)) if cfg.schedule else 3e-4
    # the bias corrections in fp32, as the JAX step.astype(float32) gives
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    flat_p = pytree.tree_leaves(state.params)
    with torch.no_grad():
        for p, g, m, v, decay in zip(flat_p, flat_g,
                                     pytree.tree_leaves(state.mu),
                                     pytree.tree_leaves(state.nu),
                                     decay_mask(state.params), strict=True):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / b1c) / ((v / b2c).sqrt() + cfg.eps)
            p32 = p.float()
            if decay:
                delta = delta + cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
    state.step = step
    return state


def make_train_step(loss_fn: Callable, cfg: AdamWConfig,
                    accum_steps: int = 1,
                    grad_transform: Callable | None = None):
    """Builds train_step(state, batch) -> (state, metrics), the state
    updated in place.

    `loss_fn(params, batch) -> scalar`.  With accum_steps > 1 the batch's
    leading axis is split into that many microbatches, whose gradients are
    summed in fp32 and averaged (activation memory of one microbatch).
    metrics: "loss" and "grad_norm" (before clipping) as fp32 tensors, and
    "step"."""

    def step(state: TrainState, batch: dict):
        leaves, spec = pytree.tree_flatten(state.params)
        for p in leaves:
            p.requires_grad_(True)
        micro = ([batch] if accum_steps == 1 else
                 [{k: x.reshape(accum_steps, -1, *x.shape[1:])[i]
                   for k, x in batch.items()} for i in range(accum_steps)])
        loss, gsum = 0.0, None
        for mb in micro:
            value = loss_fn(state.params, mb)
            # a leaf with no path to the loss (the MoE router bias enters
            # only the top-k sort) gets a zero gradient, as under
            # jax.value_and_grad; AdamW then leaves it where it is
            grads = torch.autograd.grad(value, leaves, materialize_grads=True)
            loss = loss + value.detach()
            gsum = ([g.float() for g in grads] if gsum is None
                    else [a + g for a, g in zip(gsum, grads)])
        if accum_steps > 1:
            loss = loss / accum_steps
            gsum = [g / accum_steps for g in gsum]
        grads = pytree.tree_unflatten(gsum, spec)
        state = adamw_update(state, grads, cfg, grad_transform)
        return state, {"loss": loss.float(), "grad_norm": global_norm(gsum),
                       "step": state.step}

    return step
