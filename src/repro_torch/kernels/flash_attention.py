"""Flash-attention forward: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas TPU kernel `repro.kernels.flash_attention.
flash_attention`.  The kernel lives in `csrc/flash_attention.cu` (see its
header for the design and its bound on an H100); it is built by nvcc on
first use and called through ctypes.  On a CPU tensor the wrapper runs the
plain twin, `flash_attention_plain`; on a CUDA tensor it launches the
kernel or raises.  `flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fwd():
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _check(q, k, v, window, q_offset):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         "(B,Sq,H,hd) and two equal (B,Skv,H,hd)")
    b, _, h, hd = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
        raise ValueError("flash_attention: q and k/v differ in batch, heads "
                         "or head_dim (expand GQA before the call)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.stride(-1) != 1 or any(s % align for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head_dim, 16-byte aligned rows and strides "
                             f"(strides {t.stride()})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if -(-q.shape[1] // 64) > 65535:
        raise ValueError("flash_attention: Sq beyond 64 * 65535")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None, q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's plain twin, on any device: `ref.flash_attention_ref`
    with `block_k = min(512, Skv)`, as the JAX dispatcher calls it."""
    return ref.flash_attention_ref(q, k, v, min(512, k.shape[1]), causal,
                                   window, q_offset, scale)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Skv,H,hd) with H already GQA-expanded.
    Any Sq and Skv; hd in HEAD_DIMS on the GPU.  Returns (B,Sq,H,hd) in
    q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    _check(q, k, v, window, q_offset)
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if sq == 0:
        return out
    fwd, errstr = _fwd()
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _DTYPES[q.dtype], b, h, sq, skv, hd,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              *out.stride()[:3], int(causal), window or 0, q_offset, scale,
              torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
