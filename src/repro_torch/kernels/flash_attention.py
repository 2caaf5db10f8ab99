"""Flash attention: the hand-written CUDA forward and backward kernels,
their wrappers, and the autograd Function that joins them.

The forward replaces the Pallas TPU kernel `repro.kernels.flash_attention.
flash_attention`.  The backward has no TPU counterpart: the JAX package
differentiates through the plain jnp VJP of `repro.kernels.ref.
flash_attention_ref`, and the backward kernel computes the same function.
The kernels live in `csrc/flash_attention.cu` and
`csrc/flash_attention_bwd.cu` (see their headers for the designs and their
bounds on an H100); they are built by nvcc on first use and called through
ctypes.  On CPU tensors each wrapper runs its plain twin (`ref.flash_fwd`,
`ref.flash_attention_bwd_plain`); on CUDA tensors it launches its kernel or
raises.  `flash_attention.launches` counts forward launches and
`flash_attention_bwd.launches` backward calls (three kernels each).

Both also take DeepSeek-V3's latent (MLA) layout, `is_mla`: one k and one
v head shared by all of q's heads, q and k of head dim 576, v of 512 (the
JAX package runs it through `ref.flash_attention_ref` and its VJP, since
its Pallas kernel cannot take it).  Its kernels are their own in the same
sources: forward, a wgmma kernel for bfloat16 and a SIMT kernel for
float32 (`mla_kernel` says which a call runs), counted in
`flash_attention.launches_mla`; backward, wgmma kernels for bfloat16 and
SIMT kernels for float32 (`mla_bwd_kernel` says which), dK and dV summed
over the heads (four launches a call; five where v is a tensor of its own
or dV is wanted apart from dK in bfloat16), counted in
`flash_attention_bwd.launches_mla`.  Where v is a view of k, the backward
can return k's whole gradient, dK + [dV, 0], as one tensor
(`dv_into_dk`), which `FlashAttention` asks for.

`FlashAttention` is the way to differentiate through the kernels, and the
one that `ops.attention` calls: its forward asks the kernel for lse and
saves q, k, v, o and lse (neither where no gradient can reach the call),
its backward runs the backward kernel.  Called directly under grad mode with an input
that requires grad, the CUDA forward raises rather than hand back an output
that carries no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 128, 256)
# the MLA layout's (q / k, v) head dims: kv_lora_rank + rope, kv_lora_rank
MLA_DIMS = (576, 512)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL):
    """(flash_attention_fwd, flash_attention_error_string) of a library
    built from `csrc/flash_attention.cu`, with their ctypes signatures."""
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


@functools.cache
def _fwd():
    return bind(build.library("flash_attention"))


def bind_mla(lib: ctypes.CDLL):
    """(flash_attention_mla_fwd, flash_attention_error_string) of a library
    built from `csrc/flash_attention.cu`, with their ctypes signatures."""
    fn = lib.flash_attention_mla_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, bind(lib)[1]


@functools.cache
def _fwd_mla():
    return bind_mla(build.library("flash_attention"))


def is_mla(q, k, v) -> bool:
    """q (B,Sq,H,576), k (B,Skv,1,576) and v (B,Skv,1,512): the MLA layout."""
    return (q.dim() == k.dim() == v.dim() == 4 and k.shape[2] == v.shape[2] == 1
            and (q.shape[-1], k.shape[-1], v.shape[-1])
            == (MLA_DIMS[0], MLA_DIMS[0], MLA_DIMS[1]))


def mla_kernel(q, k, v) -> str:
    """The kernel that a CUDA call at the MLA layout (`is_mla`, dtypes
    as `_check` takes them) runs: "simt" for float32 (the tensor cores
    would round to tf32); for bfloat16 the wgmma kernel, "wgmma_kv" where v
    is k's first 512 features (the same storage and batch and position
    strides: the K tile then serves as V) and "wgmma" where it loads v's
    own tiles.  Raises ValueError for a bfloat16 q whose (position, head)
    rows do not lie at one stride, a position stride other than H times
    the head stride (the kernel reads q as one matrix of Sq H rows).
    Depends on shapes, strides and storage only, so it answers for CPU
    tensors as well."""
    if q.dtype == torch.float32:
        return "simt"
    _, sq, h, _ = q.shape
    if h > 1 and sq > 1 and q.stride(1) != h * q.stride(2):
        raise ValueError(
            f"flash_attention: q strides {q.stride()}; the bf16 kernel at "
            "the MLA layout reads q's (position, head) rows at one stride, "
            f"so its position stride must be H x its head stride ({h} x "
            f"{q.stride(2)})")
    return "wgmma_kv" if v_in_k(k, v) else "wgmma"


def mla_bwd_kernel(q, k, v, do) -> str:
    """The kernels that a CUDA backward at the MLA layout runs, by
    `mla_kernel`'s rule on q, k and v ("simt" for float32, "wgmma_kv" or
    "wgmma" for bfloat16); a bfloat16 do (the output's gradient) must lie
    as q does, its (position, head) rows at one stride, or it raises
    ValueError, as a q that does not.  Depends on shapes, strides and
    storage only, so it answers for CPU tensors as well."""
    kernel = mla_kernel(q, k, v)
    _, sq, h, _ = do.shape
    if (kernel != "simt" and h > 1 and sq > 1
            and do.stride(1) != h * do.stride(2)):
        raise ValueError(
            f"flash_attention_bwd: do strides {do.stride()}; the bf16 "
            "kernels at the MLA layout read do's (position, head) rows at "
            "one stride, so its position stride must be H x its head "
            f"stride ({h} x {do.stride(2)})")
    return kernel


def v_in_k(k, v) -> bool:
    """v is k's first features: the same storage, batch and position
    strides (as `mla_attention` passes k_eff[..., :512]).  The kernels
    then read V from the K tiles."""
    return (v.data_ptr() == k.data_ptr()
            and v.stride()[:2] == k.stride()[:2])


@functools.cache
def _bwd():
    lib = build.library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_bwd_error_string


def bind_bwd_mla(lib: ctypes.CDLL):
    """(flash_attention_mla_bwd, flash_attention_mla_bwd_scratch) of a
    library built from `csrc/flash_attention_bwd.cu`, with their ctypes
    signatures."""
    fn = lib.flash_attention_mla_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.flash_attention_mla_bwd_scratch
    scratch.argtypes = [ctypes.c_int] * 5
    scratch.restype = ctypes.c_longlong
    return fn, scratch


@functools.cache
def _bwd_mla():
    return bind_bwd_mla(build.library("flash_attention_bwd"))


def _check(q, k, v, window, q_offset, mla: bool = False, **like_q):
    """Raise on what the kernels do not take: q (B,Sq,H,hd), k and v
    (B,Skv,H,hd), and the tensors of `like_q` shaped as q, all on one CUDA
    device, in one of _DTYPES, hd in HEAD_DIMS, with a contiguous head_dim
    and 16-byte aligned rows and strides.  With `mla`, the MLA layout
    instead of the equal heads and head dims (`is_mla`), and `like_q`
    shaped as the output, (B,Sq,H,512)."""
    ts = {"q": q, "k": k, "v": v, **like_q}
    if not all(t.is_cuda and t.device == q.device for t in ts.values()):
        raise ValueError(f"flash_attention: {', '.join(ts)} must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts.values()):
        raise ValueError("flash_attention: dtypes "
                         f"{'/'.join(str(t.dtype) for t in ts.values())}; "
                         "the kernel takes float32 or bfloat16")
    if mla:
        if not (is_mla(q, k, v) and k.shape[:2] == v.shape[:2]
                and k.shape[0] == q.shape[0]):
            raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                             f"(B,Sq,H,{MLA_DIMS[0]}), (B,Skv,1,"
                             f"{MLA_DIMS[0]}) and (B,Skv,1,{MLA_DIMS[1]})")
        for name, t in like_q.items():
            if t.shape != (*q.shape[:3], MLA_DIMS[1]):
                raise ValueError(f"flash_attention: {name} {tuple(t.shape)}; "
                                 f"want {(*q.shape[:3], MLA_DIMS[1])}")
    else:
        if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
            raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                             f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                             "(B,Sq,H,hd) and two equal (B,Skv,H,hd)")
        b, _, h, hd = q.shape
        if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, hd):
            raise ValueError("flash_attention: q and k/v differ in batch, "
                             "heads or head_dim (expand GQA before the call; "
                             "one shared head is taken only at the MLA "
                             f"layout, head dims {MLA_DIMS})")
        for name, t in like_q.items():
            if t.shape != q.shape:
                raise ValueError(f"flash_attention: {name} {tuple(t.shape)}; "
                                 f"want q's {tuple(q.shape)}")
        if hd not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head_dim {hd} not in "
                             f"{HEAD_DIMS}")
    align = 16 // q.element_size()
    for name, t in ts.items():
        if (t.stride(-1) != 1 or any(s % align for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head_dim, 16-byte aligned rows and strides "
                             f"(strides {t.stride()})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    if max(-(-q.shape[1] // 16), -(-k.shape[1] // 16)) > 65535:
        raise ValueError("flash_attention: Sq or Skv beyond 16 * 65535")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None, q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """The forward kernel's plain twin, on any device and differentiable:
    `ref.flash_attention_ref` with `block_k = min(512, Skv)`, as the JAX
    dispatcher calls it."""
    return ref.flash_attention_ref(q, k, v, min(512, k.shape[1]), causal,
                                   window, q_offset, scale)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        scale: float | None = None, want_lse: bool = False):
    """The forward: q (B,Sq,H,hd); k, v (B,Skv,H,hd), H already
    GQA-expanded, or the MLA layout (`is_mla`); any Sq and Skv; hd in
    HEAD_DIMS on the GPU.  Returns (out (B,Sq,H,hd_v) in q's dtype, lse),
    hd_v v's head dim, lse the fp32 (B,H,Sq) natural log of each row's
    softmax denominator over the scaled logits when `want_lse`, else None
    (the kernel then writes none)."""
    if q.device.type == "cpu":
        out, lse = ref.flash_fwd(q, k, v, min(512, k.shape[1]), causal,
                                 window, q_offset, scale)
        return out, lse if want_lse else None
    mla = is_mla(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: an input requires grad, and the kernel's output "
            "would carry none; differentiate through FlashAttention.apply "
            "(ops.attention does), or call under torch.no_grad()")
    _check(q, k, v, window, q_offset, mla=mla)
    kernel = mla_kernel(q, k, v) if mla else None
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5 if scale is None else float(scale)
    out = torch.empty((b, sq, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if sq == 0:
        return out, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    masks = (int(causal), window or 0, q_offset, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if mla:
        fwd, errstr = _fwd_mla()
        err = fwd(*ptrs, _DTYPES[q.dtype], int(kernel == "wgmma_kv"), b, h,
                  sq, skv, *q.stride()[:3],
                  *k.stride()[:2], *v.stride()[:2], *out.stride()[:3], *masks)
    else:
        fwd, errstr = _fwd()
        err = fwd(*ptrs, _DTYPES[q.dtype], b, h, sq, skv, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], *masks)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    if mla:
        flash_attention.launches_mla += 1
    else:
        flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """The forward's output alone (no lse).  On a CPU tensor the plain twin,
    differentiable; on CUDA tensors the kernel, which raises under grad
    mode for an input that requires grad (see `FlashAttention`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)[0]


flash_attention.launches = 0
flash_attention.launches_mla = 0   # the forwards at the MLA layout


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        scale: float | None = None,
                        dv_into_dk: bool = False):
    """The backward: q, k, v as the forward took them (the MLA layout too),
    its output o, the output's gradient do (both shaped as the output) and
    its lse (fp32 (B,H,Sq), from `flash_attention_fwd(..., want_lse=True)`).
    Returns (dq, dk, dv) in the inputs' dtype; at the MLA layout dk and dv
    are summed over q's heads.  `dv_into_dk` (the MLA layout with v a view
    of k's first 512 features, `v_in_k`; else ValueError) returns (dq, dk +
    [dv, 0], None): k's whole gradient, which autograd would otherwise form
    by adding dv into it, summed in fp32 before the rounding to the
    inputs' dtype."""
    if dv_into_dk and not (is_mla(q, k, v) and v_in_k(k, v)):
        raise ValueError("flash_attention_bwd: dv_into_dk needs the MLA "
                         "layout with v a view of k's first "
                         f"{MLA_DIMS[1]} features")
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             min(512, k.shape[1]), causal,
                                             window, q_offset, scale,
                                             dv_into_dk)
    mla = is_mla(q, k, v)
    _check(q, k, v, window, q_offset, mla=mla, o=o, do=do)
    if mla:
        mla_bwd_kernel(q, k, v, do)   # raises on a q or do it cannot read
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse {lse.dtype} "
                         f"{tuple(lse.shape)}; want contiguous float32 "
                         f"{(b, h, sq)} on {q.device}")
    scale = hd ** -0.5 if scale is None else float(scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = (None if dv_into_dk
          else torch.empty(v.shape, dtype=v.dtype, device=q.device))
    if sq == 0 or skv == 0:
        return dq.zero_(), dk.zero_(), None if dv is None else dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dk if dv is None else dv)
        for s in t.stride()[:3]))
    masks = (int(causal), window or 0, q_offset, scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    outs = (dq.data_ptr(), dk.data_ptr(),
            None if dv is None else dv.data_ptr())
    fn, errstr = _bwd()
    if mla:
        fn_mla, scratch = _bwd_mla()
        part = torch.empty(scratch(b, h, skv, _DTYPES[q.dtype],
                                   int(dv_into_dk)),
                           dtype=torch.float32, device=q.device)
        err = fn_mla(*ptrs, part.data_ptr(), *outs, _DTYPES[q.dtype],
                     int(v_in_k(k, v)), int(dv_into_dk), b, h, sq, skv,
                     strides, *masks)
    else:
        err = fn(*ptrs, *outs, _DTYPES[q.dtype], b, h, sq, skv, hd, strides,
                 *masks)
    if err:
        raise RuntimeError("flash_attention_bwd kernel launch failed: "
                           f"{errstr(err).decode()} ({err})")
    if mla:
        flash_attention_bwd.launches_mla += 1
    else:
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_mla = 0   # the backwards at the MLA layout


class FlashAttention(torch.autograd.Function):
    """Flash attention that autograd differentiates: the forward kernel
    with lse, then the backward kernel (their plain twins on CPU tensors).
    `FlashAttention.apply(q, k, v, causal, window, q_offset, scale, grad)`:
    `grad=False` says that no gradient will reach this call (the caller
    runs under `torch.no_grad`, or no input requires grad), and the forward
    then writes no lse and saves nothing, as serving wants.  At the MLA
    layout with v a view of k (as `mla_attention` passes k_eff[..., :512])
    and k wanting a gradient, the backward returns k's whole gradient,
    dK + [dV, 0] (`dv_into_dk`), and None for v."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, q_offset=0,
                scale=None, grad=True):
        opts = dict(causal=causal, window=window, q_offset=q_offset,
                    scale=scale)
        out, lse = flash_attention_fwd(q, k, v, want_lse=grad, **opts)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors   # unpacked once: checkpoint allows one
        if not saved:
            raise RuntimeError("FlashAttention: backward through a call "
                               "made with grad=False")
        q, k, v, out, lse = saved
        fused = (ctx.needs_input_grad[1] and is_mla(q, k, v)
                 and v_in_k(k, v))
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         dv_into_dk=fused, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None
