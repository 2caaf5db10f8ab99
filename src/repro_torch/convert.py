"""Carry the JAX package's params into the port's layout.

`params_from_jax` takes the JAX `params` pytree after
`jax.tree.map(np.asarray, ...)` (nested dicts of numpy arrays) and returns
the port's params: each segment's leading layer axis (and that of
Whisper's `encoder` blocks) unstacked into a list of per-layer dicts
(other subtrees, DeepSeek-V3's MTP head among them, as
they are), matmul weights in bf16, MLA's projections among them (the JAX
path casts them to bf16 at every use, so this is bit-identical), and in
fp32 the norm scales (`scale` leaves) and the leaves that the JAX blocks
read in fp32 (FP32_LEAVES: the MoE router bias, the SSM's `a_log`, the
RWKV time-mix's decay and bonus).  With `dtype=torch.float32` every leaf is fp32: the JAX
package's own fp32 masters, for training.
"""

from __future__ import annotations

import numpy as np
import torch


FP32_LEAVES = frozenset({"scale", "router_bias", "a_log", "w0", "w_lora_a",
                         "w_lora_b", "bonus"})


def _leaf(name: str, a, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    if dtype is None:
        dtype = torch.float32 if name in FP32_LEAVES else torch.bfloat16
    return t.to(device=device, dtype=dtype)


def _tree(d: dict, device, dtype) -> dict:
    return {k: _tree(v, device, dtype) if isinstance(v, dict)
            else _leaf(k, v, device, dtype) for k, v in d.items()}


def _unstack(d: dict, i: int) -> dict:
    return {k: _unstack(v, i) if isinstance(v, dict) else v[i]
            for k, v in d.items()}


def _count(d: dict) -> int:
    v = next(iter(d.values()))
    return _count(v) if isinstance(v, dict) else len(v)


def is_stacked(name: str) -> bool:
    """Whether the JAX package stacks top-level subtree `name` on a leading
    layer axis: a segment (`seg*`) or Whisper's encoder blocks."""
    return name.startswith("seg") or name == "encoder"


def params_from_jax(tree: dict, device="cuda", dtype=None) -> dict:
    """`dtype`: None for the serving layout above, or one dtype for every
    leaf (torch.float32: training masters)."""
    out = {}
    for name, sub in tree.items():
        if is_stacked(name):
            out[name] = [_tree(_unstack(sub, i), device, dtype)
                         for i in range(_count(sub))]
        else:
            out[name] = _tree(sub, device, dtype)
    return out
