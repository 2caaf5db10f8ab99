"""Kernel dispatch, ported from `repro.kernels.ops`.

`attention(...)` is what the model layer calls: naive SDPA below
FLASH_THRESHOLD query positions (the quadratic logits are cheap there);
at or above it, the CUDA flash kernel for CUDA tensors and its plain twin
for CPU tensors.  Every path honours `scale`.

`rwkv_mix(...)` runs the WKV6 recurrence: the CUDA kernel for CUDA
tensors, its plain twin for CPU tensors.  Both return the final state
(the JAX dispatcher's Pallas path returns None there).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wkv

# below this q-length, naive SDPA is used (cheapest at small S)
FLASH_THRESHOLD = 2048
IMPLS = ("naive", "kernel", "plain")


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, scale: float | None = None,
              force: str | None = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,H,hd), H equal (expand GQA upstream).
    `force` picks one of IMPLS; "kernel" needs CUDA tensors."""
    impl = force or ("naive" if q.shape[1] < FLASH_THRESHOLD
                     else ("kernel" if q.is_cuda else "plain"))
    if impl == "naive":
        return ref.naive_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("attention(force='kernel') needs CUDA tensors; "
                             f"got {q.device}")
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)
    if impl == "plain":
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale)
    raise ValueError(f"attention: force={impl!r} not in {IMPLS}")


def rwkv_mix(r, k, v, w, u, *, s0=None, force: str | None = None):
    """WKV6.  r,k,v,w: (B,S,H,hd) float32; u: (H,hd); s0: (B,H,hd,hd) or
    None.  `force` is "kernel" (needs CUDA tensors) or "plain".  Returns
    (y, s_final), both float32."""
    impl = force or ("kernel" if r.is_cuda else "plain")
    if impl == "kernel":
        if not r.is_cuda:
            raise ValueError("rwkv_mix(force='kernel') needs CUDA tensors; "
                             f"got {r.device}")
        return wkv.wkv6(r, k, v, w, u, s0)
    if impl == "plain":
        return wkv.wkv6_plain(r, k, v, w, u, s0)
    raise ValueError(f"rwkv_mix: force={impl!r} not in ('kernel', 'plain')")
