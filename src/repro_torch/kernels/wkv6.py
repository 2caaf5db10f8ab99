"""WKV6 (the RWKV6 time-mix recurrence): the hand-written CUDA kernel and
its wrapper.

Replaces the Pallas TPU kernel `repro.kernels.rwkv6.wkv6`.  The kernel
lives in `csrc/wkv6.cu` (see its header for the design and its bound on an
H100); it is built by nvcc on first use and called through ctypes.  On a
CPU tensor the wrapper runs the plain twin, `wkv6_plain`, which autograd
differentiates; on a CUDA tensor it launches the kernel or raises.  The
kernel has no backward yet, so under grad mode it raises for an input that
requires grad instead of handing back an output without a gradient.
`wkv6.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
NO_BACKWARD = ("the wkv6 kernel has no backward yet (ROADMAP A3: RWKV "
               "training with a wkv6 backward kernel); on the CPU the plain "
               "recurrence is differentiable")


def bind(lib: ctypes.CDLL):
    """(wkv6_fwd, wkv6_error_string) of a library built from `csrc/wkv6.cu`,
    with their ctypes signatures."""
    fn = lib.wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_error_string


@functools.cache
def _fwd():
    return bind(build.library("wkv6"))


def copy_bytes(*ts: torch.Tensor) -> int:
    """The width of the kernel's copies for these (B,S,H,hd) tensors: 16
    bytes where every base address is 16-byte aligned and every stride of
    a dimension longer than 1 is a multiple of 4 elements, else 4."""
    for t in ts:
        if t.data_ptr() % 16 or any(
                n > 1 and st % 4 for n, st in zip(t.shape[:3], t.stride()[:3])):
            return 4
    return 16


def _check(r, k, v, w, u, s0, chunk):
    ts = {"r": r, "k": k, "v": v, "w": w, "u": u}
    if s0 is not None:
        ts["s0"] = s0
    for name, t in ts.items():
        if not (t.is_cuda and t.device == r.device):
            raise ValueError("wkv6: r, k, v, w, u, s0 must lie on one CUDA "
                             f"device ({name} is on {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6: {name} is {t.dtype}; the kernel takes "
                             "float32")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}; want four "
                         "equal (B,S,H,hd)")
    b, _, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head_dim {hd} not in {HEAD_DIMS}")
    if u.shape != (h, hd):
        raise ValueError(f"wkv6: u {tuple(u.shape)}; want {(h, hd)}")
    if s0 is not None and s0.shape != (b, h, hd, hd):
        raise ValueError(f"wkv6: s0 {tuple(s0.shape)}; want {(b, h, hd, hd)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name} needs a contiguous head_dim "
                             f"(strides {t.stride()})")
    if r.shape[1] < 1:
        raise ValueError("wkv6: S must be >= 1")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} not in [1, {MAX_CHUNK}]")


def wkv6_plain(r, k, v, w, u, s0=None):
    """The kernel's plain twin, on any device: `ref.wkv6_ref`."""
    return ref.wkv6_ref(r, k, v, w, u, s0)


def wkv6(r, k, v, w, u, s0=None, *, chunk: int = 32):
    """r, k, v, w: (B,S,H,hd) float32; u: (H,hd); s0: (B,H,hd,hd) or None
    (zeros).  Any S >= 1; hd in HEAD_DIMS on the GPU.  `chunk` is how many
    tokens the kernel stages in shared memory at a time (1..128, fewer
    where two stages would not fit); it does not change the result.
    Returns (y: (B,S,H,hd), s_final: (B,H,hd,hd)), both float32."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        raise NotImplementedError(f"wkv6: an input requires grad, but "
                                  f"{NO_BACKWARD}")
    y, s_final = launch(_fwd(), r, k, v, w, u, s0, chunk)
    wkv6.launches += 1
    return y, s_final


def launch(fwd, r, k, v, w, u, s0, chunk):
    """Check the CUDA inputs and run the kernel of `fwd` (from `bind`) on
    them; returns (y, s_final).  Counts nothing: `wkv6` counts its own
    launches."""
    _check(r, k, v, w, u, s0, chunk)
    b, s, h, hd = r.shape
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    s_final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                          device=r.device)
    fn, errstr = fwd
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s0 is None else s0.data_ptr(),
             y.data_ptr(), s_final.data_ptr(), b, s, h, hd,
             *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *w.stride()[:3], *y.stride()[:3], chunk,
             int(copy_bytes(r, k, v, w) == 16),
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return y, s_final


wkv6.launches = 0
