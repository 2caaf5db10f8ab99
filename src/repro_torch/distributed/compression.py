"""Error-feedback gradient compression, ported from
`repro.distributed.compression` to tensors.

Two compressors, both with error feedback (the residual of each step is
added back before the next compression):

  * int8 quantization: 4x less traffic than fp32, dense;
  * top-k sparsification: keep the k largest-magnitude entries per leaf.

On one device nothing crosses a link, so the training driver builds the
compressor and, like the JAX driver, does not apply it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero all but the top-|frac| fraction of entries (per leaf)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


@dataclasses.dataclass
class EFCompressor:
    """Error-feedback wrapper around one of the compressors."""

    kind: str = "int8"       # "int8" | "topk" | "none"
    topk_frac: float = 0.05

    def init(self, params):
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    def __call__(self, grads, error):
        """Returns (compressed_grads, new_error)."""
        if self.kind == "none":
            return grads, error
        flat_g, spec = pytree.tree_flatten(grads)
        comp, err = [], []
        for g, e in zip(flat_g, pytree.tree_leaves(error), strict=True):
            g = g.float() + e
            if self.kind == "int8":
                out = dequantize_int8(*quantize_int8(g))
            else:
                out = topk_sparsify(g, self.topk_frac)
            comp.append(out)
            err.append(g - out)
        return (pytree.tree_unflatten(comp, spec),
                pytree.tree_unflatten(err, spec))
