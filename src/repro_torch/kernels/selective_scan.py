"""The selective scan of the Mamba-style SSM (Hymba's hybrid block): the
hand-written CUDA forward and backward kernels, their wrappers, the plain
loop they replace, and the autograd Function that joins them.

No TPU kernel: the JAX package runs the scan as a `lax.scan`
(`repro.models.blocks.ssm`) and differentiates it with `jax.grad`; the
kernels compute the same scan and VJP.  Both live in
`csrc/selective_scan.cu` (see its header for the designs and their bounds
on an H100), built by nvcc on first use and called through ctypes.  On CPU
tensors each wrapper runs its plain twin (`ssm_scan_plain`,
`ref.ssm_scan_bwd_plain`); on CUDA tensors it launches its kernels or
raises.  The kernels split the sequence into chunks of CHUNK tokens that
run in parallel, joined by the scan's linear carry (`ref.ssm_scan_chunked`
and `ref.ssm_scan_bwd_plain(..., chunk=CHUNK)` are their order on the
CPU): a forward call is three launches (one where S <= CHUNK), a backward
call four (two).
`selective_scan.launches` counts forward calls and
`selective_scan_bwd.launches` backward calls.

On fake tensors (`torch._subclasses.FakeTensorMode`; the dry run) each
wrapper is its kernels' shape function: checks and the allocations of
outputs and scratch as for real tensors, then no build, pointer or
launch, and no count.

`SelectiveScan` is the way to differentiate through the kernels, and the
one that `ops.ssm_scan` calls: its forward asks the kernel for h every
CKPT_EVERY tokens and saves the inputs and those checkpoints (nothing
where no gradient can reach the call), its backward runs the backward
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build, ref

# state dims the kernels take: the reduced Hymba's and Hymba-1.5B's
STATE_DIMS = (4, 16)
# tokens between the forward's checkpoints: kCkptEvery in the source
CKPT_EVERY = 16
# channels a block: kChannels (the backward's dB / dC partials per block)
CHANNELS = 64
# tokens a chunk (a multiple of CKPT_EVERY); a call with S <= CHUNK walks
# one chunk and needs no carry
CHUNK = 96


def bind(lib: ctypes.CDLL):
    """(ssm_scan_fwd, ssm_scan_error_string) of a library built from
    `csrc/selective_scan.cu`, with their ctypes signatures."""
    fn = lib.ssm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return fn, lib.ssm_scan_error_string


def bind_bwd(lib: ctypes.CDLL):
    """(ssm_scan_bwd, ssm_scan_error_string), as `bind`."""
    fn = lib.ssm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, bind(lib)[1]


@functools.cache
def _fwd():
    return bind(build.library("selective_scan"))


@functools.cache
def _bwd():
    return bind_bwd(build.library("selective_scan"))


def ssm_scan_plain(dt, u, b, c, a, h0=None):
    """The scan as `repro.models.blocks.ssm` writes it, a loop over tokens
    (three launches a token on the GPU), in dt's dtype: decay = exp(dt a),
    drive = (dt u) B, h = decay h + drive, y_t = h_t C_t (a bmm).  dt, u
    (B,S,D); b, c (B,S,N); a (D,N); h0 (B,D,N) or None (zeros).  Returns
    (y (B,S,D), h_last (B,D,N)); autograd differentiates it as it
    stands."""
    bsz, _, di = dt.shape
    n = a.shape[-1]
    decay = torch.exp(dt[..., None] * a)                      # (B,S,D,N)
    drive = (dt * u.to(dt.dtype))[..., None] * b[:, :, None, :]
    h = (torch.zeros(bsz, di, n, dtype=dt.dtype, device=dt.device)
         if h0 is None else h0.to(dt.dtype))
    ys = []   # y_t = einsum("bdn,bn->bd", h, c_t), as the bmm it lowers to
    for dec, drv, ct in zip(decay.unbind(1), drive.unbind(1),
                            c[..., None].unbind(1)):
        h = dec * h + drv
        ys.append(torch.bmm(h, ct))
    del decay, drive, dec, drv
    return torch.cat(ys, dim=2).transpose(1, 2), h


def _check(dt, u, b, c, a, h0):
    ts = {"dt": dt, "u": u, "b": b, "c": c, "a": a}
    if h0 is not None:
        ts["h0"] = h0
    for name, t in ts.items():
        if not (t.is_cuda and t.device == dt.device):
            raise ValueError("selective_scan: dt, u, b, c, a, h0 must lie on "
                             f"one CUDA device ({name} is on {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"selective_scan: {name} is {t.dtype}; the "
                             "kernel takes float32")
    if dt.dim() != 3 or u.shape != dt.shape:
        raise ValueError(f"selective_scan: dt {tuple(dt.shape)}, u "
                         f"{tuple(u.shape)}; want two equal (B,S,D)")
    bsz, s, di = dt.shape
    n = a.shape[-1]
    if a.shape != (di, n) or n not in STATE_DIMS:
        raise ValueError(f"selective_scan: a {tuple(a.shape)}; want (D, N) "
                         f"with D {di} and N in {STATE_DIMS}")
    for name, t in (("b", b), ("c", c)):
        if t.shape != (bsz, s, n):
            raise ValueError(f"selective_scan: {name} {tuple(t.shape)}; want "
                             f"{(bsz, s, n)}")
    if h0 is not None and h0.shape != (bsz, di, n):
        raise ValueError(f"selective_scan: h0 {tuple(h0.shape)}; want "
                         f"{(bsz, di, n)}")
    if s < 1 or not 1 <= bsz <= 65535:
        raise ValueError(f"selective_scan: B {bsz}, S {s}; want S >= 1 and "
                         "1 <= B <= 65535")


def _ptr(t):
    return None if t is None else t.data_ptr()


def selective_scan_fwd(dt, u, b, c, a, h0=None, *, want_ckpt: bool = False):
    """The forward: dt, u (B,S,D) float32; b, c (B,S,N); a (D,N); h0
    (B,D,N) or None (zeros); N in STATE_DIMS on the GPU.  Returns (y
    (B,S,D), h_last (B,D,N), ckpt), all float32, ckpt the (B,
    ceil(S/CKPT_EVERY), D, N) h before every CKPT_EVERY-th token when
    `want_ckpt` on the GPU (what `selective_scan_bwd` walks back from),
    else None (the kernel then writes none)."""
    if dt.device.type == "cpu":
        return (*ssm_scan_plain(dt, u, b, c, a, h0), None)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (dt, u, b, c, a, h0)):
        raise RuntimeError(
            "selective_scan: an input requires grad, and the kernel's "
            "output would carry none; differentiate through "
            "SelectiveScan.apply (ops.ssm_scan does), or call under "
            "torch.no_grad()")
    fake = is_fake(dt)
    y, h_last, ckpt = launch(None if fake else _fwd(), dt, u, b, c, a, h0,
                             want_ckpt, CHUNK)
    if not fake:
        selective_scan.launches += 1
    return y, h_last, ckpt


def _new(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def launch(fwd, dt, u, b, c, a, h0, want_ckpt: bool, chunk: int):
    """Check the CUDA inputs and run the forward kernels of `fwd` (from
    `bind`) in chunks of `chunk` tokens (a multiple of CKPT_EVERY); returns
    (y, h_last, ckpt or None).  On fake tensors it allocates them and
    returns (`fwd` may then be None).  Counts nothing: `selective_scan_fwd`
    counts its own calls."""
    _check(dt, u, b, c, a, h0)
    dt, u, b, c, a = (t.contiguous() for t in (dt, u, b, c, a))
    h0 = None if h0 is None else h0.contiguous()
    bsz, s, di = dt.shape
    n = a.shape[-1]
    nc, dev = -(-s // chunk), dt.device
    y, h_last = _new(dev, bsz, s, di), _new(dev, bsz, di, n)
    ckpt = (_new(dev, bsz, -(-s // CKPT_EVERY), di, n) if want_ckpt
            else None)
    # the chunks' local states and sums of dt, then the carried states
    cbuf, sdt = ((_new(dev, bsz, nc, di, n), _new(dev, bsz, nc, di))
                 if nc > 1 else (None, None))
    if is_fake(dt):
        return y, h_last, ckpt
    fn, errstr = fwd
    err = fn(dt.data_ptr(), u.data_ptr(), b.data_ptr(), c.data_ptr(),
             a.data_ptr(), _ptr(h0), y.data_ptr(), h_last.data_ptr(),
             _ptr(ckpt), _ptr(cbuf), _ptr(sdt), bsz, s, di, n, chunk,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return y, h_last, ckpt


def selective_scan(dt, u, b, c, a, h0=None):
    """`selective_scan_fwd`'s (y, h_last) alone: the plain twin on CPU
    tensors (differentiable), the kernel on CUDA tensors (which raises
    under grad mode for an input that requires grad; see
    `SelectiveScan`)."""
    return selective_scan_fwd(dt, u, b, c, a, h0)[:2]


selective_scan.launches = 0


def selective_scan_bwd(dt, u, b, c, a, h0, dy, dh_last, ckpt):
    """The backward: the forward's inputs, the gradients dy (B,S,D) of y
    and dh_last (B,D,N) of h_last (either None: zeros), and the forward's
    checkpoints (`selective_scan_fwd(..., want_ckpt=True)`; unused on the
    CPU).  Returns (ddt, du (B,S,D), db, dc (B,S,N), da (D,N), dh0
    (B,D,N)), all float32 (on the CPU in dt's dtype)."""
    if dt.device.type == "cpu":
        return ref.ssm_scan_bwd_plain(dt, u, b, c, a, h0, dy, dh_last,
                                      ckpt_every=CKPT_EVERY)
    fake = is_fake(dt)
    got = bwd_launch(None if fake else _bwd(), dt, u, b, c, a, h0, dy,
                     dh_last, ckpt, CHUNK)
    if not fake:
        selective_scan_bwd.launches += 1
    return got


def bwd_launch(bwd, dt, u, b, c, a, h0, dy, dh_last, ckpt, chunk: int):
    """Check the CUDA inputs and run the backward kernels of `bwd` (from
    `bind_bwd`) in chunks of `chunk` tokens; returns (ddt, du, db, dc, da,
    dh0).  On fake tensors it allocates them and returns (`bwd` may then
    be None).  Counts nothing."""
    _check(dt, u, b, c, a, h0)
    bsz, s, di = dt.shape
    n = a.shape[-1]
    nck, nc = -(-s // CKPT_EVERY), -(-s // chunk)
    dy = torch.zeros_like(dt) if dy is None else dy
    extra = {"dy": (dy, (bsz, s, di)), "ckpt": (ckpt, (bsz, nck, di, n))}
    if dh_last is not None:
        extra["dh_last"] = (dh_last, (bsz, di, n))
    for name, (t, shape) in extra.items():
        if t is None or t.shape != shape or t.dtype != torch.float32 \
                or t.device != dt.device:
            raise ValueError(f"selective_scan_bwd: {name} "
                             f"{None if t is None else tuple(t.shape)}; want "
                             f"float32 {shape} on {dt.device}")
    dt, u, b, c, a, dy, ckpt = (t.contiguous()
                                for t in (dt, u, b, c, a, dy, ckpt))
    dh_last = None if dh_last is None else dh_last.contiguous()
    dev = dt.device
    ddt, du = _new(dev, bsz, s, di), _new(dev, bsz, s, di)
    db, dc = _new(dev, bsz, s, n), _new(dev, bsz, s, n)
    da, dh0 = _new(dev, di, n), _new(dev, bsz, di, n)
    nblk = -(-di // CHANNELS)
    part_b, part_c = _new(dev, nblk, bsz, s, n), _new(dev, nblk, bsz, s, n)
    da_part = _new(dev, bsz, nc, di, n)
    cbuf, sdt = ((_new(dev, bsz, nc, di, n), _new(dev, bsz, nc, di))
                 if nc > 1 else (None, None))
    if is_fake(dt):
        return ddt, du, db, dc, da, dh0
    fn, errstr = bwd
    err = fn(dt.data_ptr(), u.data_ptr(), b.data_ptr(), c.data_ptr(),
             a.data_ptr(), dy.data_ptr(), _ptr(dh_last), ckpt.data_ptr(),
             ddt.data_ptr(), du.data_ptr(), db.data_ptr(), dc.data_ptr(),
             da.data_ptr(), dh0.data_ptr(), part_b.data_ptr(),
             part_c.data_ptr(), da_part.data_ptr(), _ptr(cbuf), _ptr(sdt),
             bsz, s, di, n, chunk,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    return ddt, du, db, dc, da, dh0


selective_scan_bwd.launches = 0


class SelectiveScan(torch.autograd.Function):
    """The scan that autograd differentiates: the forward kernel with
    checkpoints, then the backward kernel (their plain twins on CPU
    tensors).  `SelectiveScan.apply(dt, u, b, c, a, h0, grad)` returns (y,
    h_last); `grad=False` says that no gradient will reach this call (the
    caller runs under `torch.no_grad`, or no input requires grad), and the
    forward then writes no checkpoints and saves nothing, as serving
    wants."""

    @staticmethod
    def forward(ctx, dt, u, b, c, a, h0=None, grad=True):
        ctx.set_materialize_grads(False)
        y, h_last, ckpt = selective_scan_fwd(dt, u, b, c, a, h0,
                                             want_ckpt=grad)
        if grad:
            ctx.save_for_backward(dt, u, b, c, a, h0, ckpt)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        saved = ctx.saved_tensors   # unpacked once: checkpoint allows one
        if not saved:
            raise RuntimeError("SelectiveScan: backward through a call made "
                               "with grad=False")
        dt, u, b, c, a, h0, ckpt = saved
        ddt, du, db, dc, da, dh0 = selective_scan_bwd(dt, u, b, c, a, h0, dy,
                                                      dh_last, ckpt)
        return ddt, du, db, dc, da, None if h0 is None else dh0, None
