"""Kernel dispatch, ported from `repro.kernels.ops`.

`attention(...)` is what the model layer calls: naive SDPA below
FLASH_THRESHOLD query positions (the quadratic logits are cheap there);
at or above it, the CUDA flash kernels for CUDA tensors and their plain
twin for CPU tensors.  Serving and training take the same path,
`FlashAttention` (forward kernel, backward kernel); where no gradient can
reach the call (`torch.no_grad`, `inference_mode`, no input requiring
grad) its forward writes no lse and saves nothing.  Every path honours
`scale` and is differentiable.

`rwkv_mix(...)` runs the WKV6 recurrence: the CUDA kernels for CUDA
tensors, through `WKV6` (forward kernel, backward kernel; where no
gradient can reach the call its forward writes no checkpoints and saves
nothing), and its plain twin, which autograd differentiates, for CPU
tensors.  Both return the final state (the JAX dispatcher's Pallas path
returns None there).

`ssm_scan(...)` runs the selective scan of the SSM: the CUDA kernels for
CUDA tensors, through `SelectiveScan` (likewise), and the plain loop over
tokens, which autograd differentiates, for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import wkv6 as wkv

# below this q-length, naive SDPA is used (cheapest at small S)
FLASH_THRESHOLD = 2048
IMPLS = ("naive", "kernel", "plain")


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset: int = 0, scale: float | None = None,
              force: str | None = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,H,hd), H equal (expand GQA upstream),
    or the MLA layout (`flash_attention.is_mla`: one k and one v head shared
    by q's heads, head dims 576 / 512; the output then (B,Sq,H,512)).
    `force` picks one of IMPLS; "kernel" needs CUDA tensors.  Every path
    is differentiable, the kernels at the MLA layout too (its backward
    kernel sums dK and dV over q's heads)."""
    impl = force or ("naive" if q.shape[1] < FLASH_THRESHOLD
                     else ("kernel" if q.is_cuda else "plain"))
    if impl == "naive":
        return ref.naive_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("attention(force='kernel') needs CUDA tensors; "
                             f"got {q.device}")
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v))
        return fa.FlashAttention.apply(q, k, v, causal, window, q_offset,
                                       scale, grad)
    if impl == "plain":
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale)
    raise ValueError(f"attention: force={impl!r} not in {IMPLS}")


def rwkv_mix(r, k, v, w, u, *, s0=None, force: str | None = None):
    """WKV6.  r,k,v,w: (B,S,H,hd) float32; u: (H,hd); s0: (B,H,hd,hd) or
    None.  `force` is "kernel" (needs CUDA tensors) or "plain"; both are
    differentiable.  Returns (y, s_final), both float32."""
    impl = force or ("kernel" if r.is_cuda else "plain")
    if impl == "kernel":
        if not r.is_cuda:
            raise ValueError("rwkv_mix(force='kernel') needs CUDA tensors; "
                             f"got {r.device}")
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0))
        return wkv.WKV6.apply(r, k, v, w, u, s0, grad)
    if impl == "plain":
        return wkv.wkv6_plain(r, k, v, w, u, s0)
    raise ValueError(f"rwkv_mix: force={impl!r} not in ('kernel', 'plain')")


def ssm_scan(dt, u, b, c, a, h0=None, force: str | None = None):
    """The selective scan.  dt, u: (B,S,D); b, c: (B,S,N); a: (D,N); h0:
    (B,D,N) or None (zeros); all float32 for the kernel.  `force` is
    "kernel" (needs CUDA tensors) or "plain" (the loop, on any device;
    "naive", the attention oracle's name, takes it too, so a model built
    with force="naive" runs every oracle); both are differentiable.
    Returns (y (B,S,D), h_last (B,D,N)), both in dt's dtype."""
    impl = force or ("kernel" if dt.is_cuda else "plain")
    if impl == "kernel":
        if not dt.is_cuda:
            raise ValueError("ssm_scan(force='kernel') needs CUDA tensors; "
                             f"got {dt.device}")
        grad = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (dt, u, b, c, a, h0))
        return ss.SelectiveScan.apply(dt, u, b, c, a, h0, grad)
    if impl in ("plain", "naive"):
        return ss.ssm_scan_plain(dt, u, b, c, a, h0)
    raise ValueError(f"ssm_scan: force={impl!r} not in IMPLS {IMPLS}")
