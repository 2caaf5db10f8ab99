"""WKV6 (the RWKV6 time-mix recurrence): the hand-written CUDA forward and
backward kernels, their wrappers, and the autograd Function that joins
them.

The forward replaces the Pallas TPU kernel `repro.kernels.rwkv6.wkv6`.  The
backward has no TPU counterpart: the JAX package differentiates the
`lax.scan` of `repro.models.blocks.rwkv_tmix`, and the backward computes
the same VJP.  Both live in `csrc/wkv6.cu` (see its header for the designs
and their bounds on an H100), built by nvcc on first use and called
through ctypes.  On CPU tensors each wrapper runs its plain twin
(`wkv6_plain`, `ref.wkv6_bwd_plain`); on CUDA tensors it launches its
kernel or raises.  `wkv6.launches` counts forward launches and
`wkv6_bwd.launches` backward calls (three kernels each).

On fake tensors (`torch._subclasses.FakeTensorMode`; the dry run) each
wrapper is its kernel's shape function: checks (the address ones aside)
and the allocations of outputs and scratch as for real tensors, then no
build, pointer or launch, and no count.

`WKV6` is the way to differentiate through the kernels, and the one that
`ops.rwkv_mix` calls: its forward asks the kernel for the state every
CKPT_EVERY tokens and saves the inputs and those checkpoints (nothing where
no gradient can reach the call), its backward runs the backward kernel.
Called directly under grad mode with an input that requires grad, the raw
`wkv6` raises rather than hand back an output that carries no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
# tokens between the forward's checkpoints: kCkptEvery in csrc/wkv6.cu
CKPT_EVERY = 32


def bind(lib: ctypes.CDLL):
    """(wkv6_fwd, wkv6_error_string) of a library built from `csrc/wkv6.cu`,
    with their ctypes signatures."""
    fn = lib.wkv6_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_error_string


@functools.cache
def _fwd():
    return bind(build.library("wkv6"))


def bind_bwd(lib: ctypes.CDLL):
    """(wkv6_bwd, wkv6_error_string) of a library built from `csrc/wkv6.cu`,
    with their ctypes signatures."""
    fn = lib.wkv6_bwd
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, bind(lib)[1]


@functools.cache
def _bwd():
    return bind_bwd(build.library("wkv6"))


# the backward's 21 (b, s, h) strides of r, k, v, w, dy, dr (dk, dw) and dv
_STRIDES = ctypes.c_longlong * 21


def copy_bytes(*ts: torch.Tensor) -> int:
    """The width of the kernel's copies for these (B,S,H,hd) tensors: 16
    bytes where every base address is 16-byte aligned (a fake tensor's
    has none to check) and every stride of a dimension longer than 1 is a
    multiple of 4 elements, else 4."""
    for t in ts:
        if (not is_fake(t) and t.data_ptr() % 16) or any(
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


def wkv6_fwd(r, k, v, w, u, s0=None, *, chunk: int = 32,
             want_ckpt: bool = False):
    """The forward: r, k, v, w (B,S,H,hd) float32; u (H,hd); s0 (B,H,hd,hd)
    or None (zeros).  Any S >= 1; hd in HEAD_DIMS on the GPU.  `chunk` is
    how many tokens the kernel stages in shared memory at a time (1..128,
    fewer where two stages would not fit); it does not change the result.
    Returns (y (B,S,H,hd), s_final (B,H,hd,hd), ckpt), ckpt the float32
    (B,H,ceil(S/CKPT_EVERY),hd,hd) state before every CKPT_EVERY-th token
    when `want_ckpt` on the GPU (what `wkv6_bwd` walks back from), else
    None (the kernel then writes none)."""
    if r.device.type == "cpu":
        return (*wkv6_plain(r, k, v, w, u, s0), None)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, s0)):
        raise RuntimeError(
            "wkv6: an input requires grad, and the kernel's output would "
            "carry none; differentiate through WKV6.apply (ops.rwkv_mix "
            "does), or call under torch.no_grad()")
    b, s, h, hd = r.shape
    ckpt = (torch.empty((b, h, -(-s // CKPT_EVERY), hd, hd),
                        dtype=torch.float32, device=r.device)
            if want_ckpt else None)
    fake = is_fake(r)
    y, s_final = launch(None if fake else _fwd(), r, k, v, w, u, s0, chunk,
                        ckpt)
    if not fake:
        wkv6.launches += 1
    return y, s_final, ckpt


def wkv6(r, k, v, w, u, s0=None, *, chunk: int = 32):
    """`wkv6_fwd`'s (y, s_final) alone.  On a CPU tensor the plain twin,
    differentiable; on CUDA tensors the kernel, which raises under grad
    mode for an input that requires grad (see `WKV6`)."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    return wkv6_fwd(r, k, v, w, u, s0, chunk=chunk)[:2]


def launch(fwd, r, k, v, w, u, s0, chunk, ckpt=None):
    """Check the CUDA inputs and run the kernel of `fwd` (from `bind`) on
    them, writing checkpoints into `ckpt` where given; returns (y,
    s_final).  On fake tensors it allocates them and returns (`fwd` may
    then be None).  Counts nothing: `wkv6_fwd` counts its own launches."""
    _check(r, k, v, w, u, s0, chunk)
    b, s, h, hd = r.shape
    if ckpt is not None and (ckpt.shape != (b, h, -(-s // CKPT_EVERY), hd, hd)
                             or not ckpt.is_contiguous()):
        raise ValueError(f"wkv6: ckpt {tuple(ckpt.shape)} is not a "
                         "contiguous (B,H,ceil(S/CKPT_EVERY),hd,hd)")
    y = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    s_final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                          device=r.device)
    if is_fake(r):
        return y, s_final
    fn, errstr = fwd
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), None if s0 is None else s0.data_ptr(),
             y.data_ptr(), s_final.data_ptr(),
             None if ckpt is None else ckpt.data_ptr(), b, s, h, hd,
             *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *w.stride()[:3], *y.stride()[:3], chunk,
             int(copy_bytes(r, k, v, w) == 16),
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6 kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return y, s_final


wkv6.launches = 0


def wkv6_bwd(r, k, v, w, u, s0, dy, ds_final, ckpt, *, chunk: int = 32):
    """The backward: r, k, v, w, u, s0 as the forward took them, the
    gradients dy (B,S,H,hd) of y and ds_final (B,H,hd,hd) of s_final
    (either None: zeros), and the forward's checkpoints (`wkv6_fwd(...,
    want_ckpt=True)`; unused on the CPU).  Returns (dr, dk, dv, dw,
    du (H,hd), ds0 (B,H,hd,hd)), all float32."""
    if r.device.type == "cpu":
        return ref.wkv6_bwd_plain(r, k, v, w, u, s0, dy, ds_final,
                                  ckpt_every=CKPT_EVERY)
    fake = is_fake(r)
    out = bwd_launch(None if fake else _bwd(), r, k, v, w, u, s0, dy,
                     ds_final, ckpt, chunk)
    if not fake:
        wkv6_bwd.launches += 1
    return out[:6]


def bwd_launch(bwd, r, k, v, w, u, s0, dy, ds_final, ckpt, chunk=32):
    """Check the CUDA inputs and run the backward of `bwd` (from
    `bind_bwd`) on them: `wkv6_bwd`'s six outputs, then gck, the float32
    (B,H,ceil(S/CKPT_EVERY),hd,hd) gradient of the state after each span
    of CKPT_EVERY tokens (the reverse pass's checkpoints, which the span
    walk starts from; `ref.wkv6_grad_checkpoints`).  On fake tensors it
    allocates them and returns (`bwd` may then be None).  Counts nothing:
    `wkv6_bwd` counts its own calls."""
    _check(r, k, v, w, u, s0, chunk)
    b, s, h, hd = r.shape
    nck = -(-s // CKPT_EVERY)
    dy = torch.zeros_like(r) if dy is None else dy
    extra = {"dy": (dy, (b, s, h, hd)), "ckpt": (ckpt, (b, h, nck, hd, hd))}
    if ds_final is not None:
        extra["ds_final"] = (ds_final, (b, h, hd, hd))
    for name, (t, shape) in extra.items():
        if t is None or t.shape != shape or t.dtype != torch.float32 \
                or t.device != r.device or t.stride(-1) != 1:
            raise ValueError(f"wkv6_bwd: {name} "
                             f"{None if t is None else tuple(t.shape)}; want "
                             f"float32 {shape} on {r.device}, contiguous "
                             "along its last dim")
    u = u.contiguous()
    ckpt = ckpt.contiguous()
    ds_final = None if ds_final is None else ds_final.contiguous()

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (new(b, s, h, hd) for _ in range(4))
    du, ds0 = new(h, hd), new(b, h, hd, hd)
    gck, du_part = new(b, h, nck, hd, hd), new(b, h, nck, hd)
    if is_fake(r):
        return dr, dk, dv, dw, du, ds0, gck
    strides = _STRIDES(*(st for t in (r, k, v, w, dy, dr, dv)
                         for st in t.stride()[:3]))
    fn, errstr = bwd
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
             None if ds_final is None else ds_final.data_ptr(),
             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
             du.data_ptr(), ds0.data_ptr(), gck.data_ptr(),
             du_part.data_ptr(), b, s, h, hd, strides, chunk,
             int(copy_bytes(r, k, v, w, dy) == 16),
             torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return dr, dk, dv, dw, du, ds0, gck


wkv6_bwd.launches = 0


class WKV6(torch.autograd.Function):
    """WKV6 that autograd differentiates: the forward kernel with
    checkpoints, then the backward kernel (their plain twins on CPU
    tensors).  `WKV6.apply(r, k, v, w, u, s0, grad)` returns (y, s_final);
    `grad=False` says that no gradient will reach this call (the caller
    runs under `torch.no_grad`, or no input requires grad), and the forward
    then writes no checkpoints and saves nothing, as serving wants."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0=None, grad=True):
        ctx.set_materialize_grads(False)
        y, s_final, ckpt = wkv6_fwd(r, k, v, w, u, s0, want_ckpt=grad)
        if grad:
            ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        saved = ctx.saved_tensors   # unpacked once: checkpoint allows one
        if not saved:
            raise RuntimeError("WKV6: backward through a call made with "
                               "grad=False")
        r, k, v, w, u, s0, ckpt = saved
        dy, ds_final = (None if t is None else t.contiguous()
                        for t in (dy, ds_final))
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u, s0, dy, ds_final,
                                           ckpt)
        return dr, dk, dv, dw, du, None if s0 is None else ds0, None
