"""The CUDA kernels (flash attention forward and backward, both at
DeepSeek-V3's MLA layout too, WKV6 forward and backward, the selective scan
forward and backward) against their plain twins, the models' launches
through them (Whisper's decoder among them), and the float64 DeepNVM++ pipeline
(the engines, the golden specs, the DTCO analyses, the sweep service and
the inverse designer) on `cuda` against the same pipeline on `cpu` (1e-12
relative, equal tuned organizations; the inverse designer's gradients
within 1e-10 of their largest component, its solve within 1e-9), on the
GPU.

Marked `cuda`: each test skips without a CUDA device.  Run on the GPU
machine with `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.
This file imports no JAX (the GPU machine has none).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine, sweep, tech, workload_engine, workloads
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import wkv6 as wkv
from repro_torch.models import lm

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, sq, h, hd, dtype, skv=None, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
                 for s in (sq, skv or sq, skv or sq))


def _seen(sq, skv, causal, window, q_offset, dev):
    """(Sq,) bool: the query rows that see at least one key."""
    q_pos = torch.arange(sq, device=dev)[:, None] + q_offset
    k_pos = torch.arange(skv, device=dev)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool, device=dev)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return vis.any(dim=1)


EDGES = [
    (True, None, 0, None, 256, 256),
    (False, None, 0, None, 256, 256),
    (True, 128, 0, None, 512, 512),
    (True, None, 128, None, 128, 256),
    (False, None, 0, 0.3, 200, 333),
    (True, None, 0, None, 2100, 2100),
    # the edges of the bf16 kernel's 128-row q and 64 / 128-key kv tiles
    (True, None, 0, None, 1, 1),
    (True, None, 0, None, 127, 127),
    (True, None, 0, None, 129, 129),
    (True, None, 0, None, 255, 255),
    (False, None, 0, None, 129, 255),
    (True, None, 128, None, 127, 255),        # Sq < Skv, q_offset
    (True, None, 254, None, 1, 255),          # one query at the cache's end
    (True, 100, 0, None, 300, 300),           # window ends inside a tile
    (True, 200, 56, 0.2, 255, 311),
    (False, None, 0, 0.2, 129, 64),           # Skv below one kv tile
    (True, None, 64, None, 129, 100),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", EDGES)
def test_kernel_matches_plain(dev, dtype, hd, causal, window, q_offset,
                              scale, sq, skv):
    q, k, v = _qkv(dev, 2, sq, 3, hd, dtype, skv)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


# the bf16 hd-256 kernel's tile edges: its 128-row q tiles and 64-key kv
# tiles at 127 / 128 / 129 rows and 63 / 64 / 65 keys
HD256_EDGES = [
    (True, None, 0, None, 127, 127),
    (True, None, 0, None, 128, 128),
    (True, None, 0, None, 129, 129),
    (False, None, 0, None, 128, 63),
    (False, None, 0, 0.2, 129, 64),           # a non-default scale
    (True, None, 0, None, 127, 65),
    (True, None, 64, None, 65, 129),          # Sq < Skv, q_offset
    (True, None, 64, None, 1, 65),            # one query at the cache's end
    (True, 40, 0, None, 129, 129),            # window ends inside a tile
    (True, 30, 0, None, 127, 63),             # rows past 92 see no key
]


@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", HD256_EDGES)
def test_hd256_kernel_matches_plain_at_its_tile_edges(dev, causal, window,
                                                      q_offset, scale, sq,
                                                      skv):
    """bf16 at hd 256 (the wgmma kernel without a producer warpgroup): the
    output within 2e-2 (max abs) and lse within 1e-4 (relative max) of
    the plain twin's, on the rows that see a key."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    q, k, v = _qkv(dev, 2, sq, 3, 256, torch.bfloat16, skv)
    seen = _seen(sq, skv, causal, window, q_offset, dev)
    got, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    want, want_lse = ref.flash_fwd(q, k, v, min(512, skv), **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float())[:, seen].abs().max().item() <= 2e-2
    lse_err = ((lse - want_lse)[:, :, seen].abs().max()
               / want_lse[:, :, seen].abs().max())
    assert lse_err.item() <= 1e-4


def test_kernel_reads_strided_q(dev):
    q, k, v = _qkv(dev, 1, 256, 2, 64, torch.bfloat16)
    got = fa.flash_attention(q[:, 128:], k, v, q_offset=128)
    want = fa.flash_attention_plain(q[:, 128:], k, v, q_offset=128)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_kernel_reads_strided_kv(dev, hd):
    """k and v as every other head of wider tensors, each a token slice:
    the tensor maps take the caller's strides."""
    q, _, _ = _qkv(dev, 2, 200, 2, hd, torch.bfloat16)
    _, kw, vw = _qkv(dev, 2, 1, 4, hd, torch.bfloat16, skv=272, seed=1)
    k, v = kw[:, 72:, ::2], vw[:, :200, 1::2]
    assert not (k.is_contiguous() or v.is_contiguous())
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_kernel_rejects_unsupported_head_dim(dev):
    q, k, v = _qkv(dev, 1, 64, 1, 48, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)


# the bf16 backward kernels' own tile edges (hd 64, 128 and 256): 128- or
# 64-row q steps and 128-key (64 at hd 256) tiles (dK / dV), 128-row q tiles
# and 64-key tiles (dQ), and rings that wrap (hd 256: 2 stages of Q and dO;
# 2 of K and 1 of V in dQ)
BWD_EDGES = [
    (True, None, 0, None, 63, 63),
    (True, None, 0, None, 64, 64),
    (True, None, 0, None, 65, 65),
    (False, None, 0, None, 127, 129),
    (True, None, 0, 0.2, 128, 128),
    (True, None, 0, None, 129, 129),
    (True, None, 64, None, 65, 129),          # Sq < Skv, q_offset
    (True, None, 1, None, 128, 129),
    (False, None, 0, None, 129, 63),
    (True, 40, 0, None, 129, 65),             # window ends inside a tile
    (True, 30, 0, None, 127, 63),             # rows past 92 see no key
    (True, 100, 28, None, 64, 127),
    (True, None, 0, None, 192, 192),          # three q steps
    (False, None, 0, None, 129, 257),         # five key tiles and one
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", EDGES + [
    (True, 50, 0, None, 300, 100),            # rows past 148 see no key
] + BWD_EDGES)
def test_backward_kernel_matches_plain(dev, dtype, hd, causal, window,
                                       q_offset, scale, sq, skv):
    """lse against the plain forward's (relative max 1e-4); dq, dk, dv
    against autograd of the plain twin, relative to max(max |want|, 1) (a
    gradient can be 0 by cancellation), with dO zero on rows that see no
    key; the kernel's dq finite on those rows with a dO that is not."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    q, k, v = _qkv(dev, 2, sq, 3, hd, dtype, skv)
    seen = _seen(sq, skv, causal, window, q_offset, dev)
    do = torch.randn(q.shape, device=dev).to(dtype)
    do_seen = do * seen[None, :, None, None]
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    _, want_lse = ref.flash_fwd(q, k, v, min(512, skv), **kw)
    lse_err = ((lse - want_lse)[:, :, seen].abs().max()
               / want_lse[:, :, seen].abs().max())
    assert lse_err.item() <= 1e-4
    got = fa.flash_attention_bwd(q, k, v, out, do_seen, lse, **kw)
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ts, **kw).backward(do_seen)
    for g, t in zip(got, ts):
        err = ((g.float() - t.grad.float()).abs().max()
               / t.grad.float().abs().max().clamp_min(1.0))
        assert err.item() <= TOL[dtype]
    dq = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)[0]
    assert torch.isfinite(dq).all()


@pytest.mark.parametrize("hd", [64, 128])
def test_backward_kernel_is_deterministic(dev, hd):
    """Two backward calls on the same bf16 inputs give bitwise-equal dq, dk
    and dv: the kernels use no atomics."""
    q, k, v = _qkv(dev, 2, 1000, 3, hd, torch.bfloat16)
    do = torch.randn(q.shape, device=dev).bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse)
    second = fa.flash_attention_bwd(q, k, v, out, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_hd256_backward_is_deterministic_at_gemma_training_shape(dev):
    """Two backward calls at Gemma-7B's training shape (2, 2048, 16, 256)
    give bitwise-equal dq, dk and dv."""
    q, k, v = _qkv(dev, 2, 2048, 16, 256, torch.bfloat16)
    do = torch.randn(q.shape, device=dev).bfloat16()
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse)
    second = fa.flash_attention_bwd(q, k, v, out, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("hd", [64, 256])
def test_backward_kernel_reads_strided_inputs(dev, hd):
    """k and v as every other head of wider tensors, dO a slice: the
    kernels take the caller's strides."""
    q, _, _ = _qkv(dev, 2, 200, 2, hd, torch.bfloat16)
    _, kw_, vw = _qkv(dev, 2, 1, 4, hd, torch.bfloat16, skv=272, seed=1)
    k, v = kw_[:, 72:, ::2], vw[:, :200, 1::2]
    dow = torch.randn(2, 200, 4, hd, device=dev).bfloat16()
    do = dow[:, :, 1::2]
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse)
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ts).backward(do)
    for g, t in zip(got, ts):
        assert ((g.float() - t.grad.float()).abs().max()
                / t.grad.float().abs().max()).item() <= 2e-2


def test_function_differentiates_through_the_kernels(dev):
    """`FlashAttention.apply` runs the forward with lse and the backward
    kernel, once each; its gradients match autograd of the plain twin."""
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 1, 300, 2, 64,
                                                 torch.float32))
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    out = fa.FlashAttention.apply(q, k, v, True, None, 0, None)
    out.backward(torch.ones_like(out))
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention_bwd.launches - before[1]) == (1, 1)
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ts).backward(torch.ones_like(out))
    for a, b in zip((q, k, v), ts):
        assert ((a.grad - b.grad).abs().max()
                / b.grad.abs().max().clamp_min(1.0)).item() <= 2e-5


def test_kernels_raise_for_inputs_that_require_grad(dev):
    """No kernel output without a gradient: the raw flash forward and wkv6
    raise under grad mode for an input that requires grad, and run under
    no_grad; ops.attention and ops.rwkv_mix take FlashAttention and WKV6
    there instead, and differentiate through the backward kernels."""
    q, k, v = _qkv(dev, 1, 64, 1, 64, torch.bfloat16)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    out = ops.attention(q, k, v, force="kernel")
    assert out.grad_fn is not None
    r, kk, vv, w, u, _ = _wkv_inputs(dev, (1, 8, 2, 64))
    u.requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        wkv.wkv6(r, kk, vv, w, u)
    with torch.no_grad():
        assert wkv.wkv6(r, kk, vv, w, u)[0].grad_fn is None
    before = wkv.wkv6_bwd.launches
    y, s = ops.rwkv_mix(r, kk, vv, w, u)
    assert y.grad_fn is not None
    (y.sum() + s.sum()).backward()   # dy and ds_final: stride-0 expansions
    assert wkv.wkv6_bwd.launches - before == 1
    assert u.grad is not None and torch.isfinite(u.grad).all()


@pytest.mark.parametrize("remat,forwards", [("full", 4), ("dots", 4),
                                             ("none", 2)])
def test_model_train_step_launches_forward_recompute_and_backward(
        dev, remat, forwards):
    """One loss + backward at 2048 tokens: per layer a forward, its
    recompute where remat recomputes the block, and a backward; gradients
    against the plain twins."""
    cfg = ArchConfig(name="gpu-test", family="dense", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                     vocab=512)
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                dtype=torch.float32)
    leaves = [params["embed"]["table"], params["seg0"][0]["attn"]["wq"],
              params["seg0"][1]["attn"]["wk"]]
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (1, 2049), device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    before = (fa.flash_attention.launches, fa.flash_attention_bwd.launches)
    got = torch.autograd.grad(lm.build(cfg, remat=remat).loss(params, batch),
                              leaves)
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention_bwd.launches - before[1]) == (forwards, 2)
    want = torch.autograd.grad(
        lm.build(cfg, force="plain").loss(params, batch), leaves)
    for g, w in zip(got, want):
        assert ((g - w).norm() / w.norm()).item() <= 5e-2


def test_model_prefill_launches_one_kernel_per_layer(dev):
    cfg = ArchConfig(name="gpu-test", family="dense", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                     vocab=512)
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, ops.FLASH_THRESHOLD),
                           device=dev)
    before = fa.flash_attention.launches
    got = lm.build(cfg).prefill(params, tokens,
                                lm.build(cfg).init_cache(1, 2048, dev))
    assert fa.flash_attention.launches - before == cfg.n_layers
    plain = lm.build(cfg, force="plain")
    want = plain.prefill(params, tokens, plain.init_cache(1, 2048, dev))
    rel = (got - want).abs().max() / want.abs().max()
    assert rel.item() <= 2e-2


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------


def _wkv_inputs(dev, shape, decay=-3.0, with_s0=False, seed=0):
    """r, k, v ~ 0.5 N; w = exp(-exp(decay + 0.5 N)); u ~ 0.1 N;
    s0 ~ 0.1 N or None, float32 on `dev`."""
    b, _, h, hd = shape
    g = torch.Generator(dev).manual_seed(seed)

    def n(*sh):
        return torch.randn(sh, generator=g, device=dev)
    r, k, v = 0.5 * n(*shape), 0.5 * n(*shape), 0.5 * n(*shape)
    w = torch.exp(-torch.exp(decay + 0.5 * n(*shape)))
    u = 0.1 * n(h, hd)
    s0 = 0.1 * n(b, h, hd, hd) if with_s0 else None
    return r, k, v, w, u, s0


def _wkv_ok(got, want):
    """|got - want| <= 1e-4 + 1e-4 |want| elementwise (the bar of
    tests/test_kernels.py), and finite."""
    return bool(torch.isfinite(got).all()
                and ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


@pytest.mark.parametrize("shape,chunk,decay,with_s0", [
    ((1, 128, 2, 32), 32, -3.0, False),
    ((1, 128, 2, 32), 64, -3.0, False),
    ((2, 256, 4, 64), 32, -3.0, False),
    ((2, 256, 4, 64), 64, -3.0, True),
    ((1, 2100, 2, 64), 64, -3.0, False),      # ragged last chunk
    ((4, 1, 40, 64), 32, -3.0, True),         # one decode step
    ((2, 100, 3, 16), 32, -3.0, True),
    ((2, 100, 3, 128), 128, -3.0, True),
    ((2, 256, 4, 64), 1, -3.0, False),
    ((2, 256, 4, 64), 64, 2.0, False),        # strong decay
    ((4, 1, 8, 128), 32, -3.0, True),         # hd 128 decode step
    ((2, 300, 4, 64), 128, -3.0, False),      # the ring wraps, ragged tail
    ((2, 300, 4, 32), 128, -3.0, True),
])
def test_wkv6_kernel_matches_plain(dev, shape, chunk, decay, with_s0):
    r, k, v, w, u, s0 = _wkv_inputs(dev, shape, decay, with_s0)
    y, s = wkv.wkv6(r, k, v, w, u, s0, chunk=chunk)
    want_y, want_s = wkv.wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert _wkv_ok(y, want_y) and _wkv_ok(s, want_s)


def test_wkv6_kernel_state_carry(dev):
    r, k, v, w, u, _ = _wkv_inputs(dev, (2, 300, 4, 64), seed=1)
    y_all, s_all = wkv.wkv6(r, k, v, w, u)
    y1, s1 = wkv.wkv6(r[:, :170], k[:, :170], v[:, :170], w[:, :170], u)
    y2, s2 = wkv.wkv6(r[:, 170:], k[:, 170:], v[:, 170:], w[:, 170:], u, s1)
    assert _wkv_ok(torch.cat([y1, y2], 1), y_all) and _wkv_ok(s2, s_all)


def test_wkv6_kernel_reads_strided_input(dev):
    """Every other head of a wider tensor, and a token slice: no copies."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, (2, 96, 6, 32), with_s0=True)
    sl = (slice(None), slice(16, None), slice(None, None, 2))
    args = [t[sl] for t in (r, k, v, w)]
    assert not args[0].is_contiguous()
    y, s = wkv.wkv6(*args, u[::2], s0[:, ::2])
    want_y, want_s = wkv.wkv6_plain(*args, u[::2], s0[:, ::2])
    assert _wkv_ok(y, want_y) and _wkv_ok(s, want_s)


def _misaligned(t, pad=1):
    """`t` (B,S,H,hd) copied into a view of a wider buffer whose base sits
    one element in and whose token stride is H*hd + pad elements."""
    b, s, h, hd = t.shape
    ts = h * hd + pad
    view = torch.zeros(1 + b * s * ts, device=t.device).as_strided(
        t.shape, (s * ts, ts, hd, 1), 1)
    return view.copy_(t)


def test_wkv6_kernel_reads_misaligned_rows(dev):
    """Rows that allow no 16-byte copies take the kernel's 4-byte path."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, (2, 77, 3, 64), with_s0=True)
    args = [_misaligned(t) for t in (r, k, v, w)]
    assert wkv.copy_bytes(*args) == 4 and wkv.copy_bytes(r, k, v, w) == 16
    y, s = wkv.wkv6(*args, u, s0, chunk=32)
    want_y, want_s = wkv.wkv6_plain(*args, u, s0)
    torch.cuda.synchronize()
    assert _wkv_ok(y, want_y) and _wkv_ok(s, want_s)


def test_wkv6_kernel_rejects_what_it_does_not_take(dev):
    r, k, v, w, u, _ = _wkv_inputs(dev, (1, 8, 2, 48))
    with pytest.raises(ValueError, match="head_dim"):
        wkv.wkv6(r, k, v, w, u)
    r, k, v, w, u, _ = _wkv_inputs(dev, (1, 8, 2, 64))
    with pytest.raises(ValueError, match="float32"):
        wkv.wkv6(r.bfloat16(), k, v, w, u)
    with pytest.raises(ValueError, match="chunk"):
        wkv.wkv6(r, k, v, w, u, chunk=129)


def _wkv_bwd_args(dev, shape, decay=-3.0, with_s0=False, with_dsf=True,
                  seed=0):
    """The backward's arguments: the forward's inputs, dy ~ N(0, 1),
    ds_final ~ 0.1 N (or None) and the forward's checkpoints."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, shape, decay, with_s0, seed)
    b, _, h, hd = shape
    g = torch.Generator(dev).manual_seed(seed + 1)
    dy = torch.randn(shape, generator=g, device=dev)
    dsf = (0.1 * torch.randn((b, h, hd, hd), generator=g, device=dev)
           if with_dsf else None)
    ck = wkv.wkv6_fwd(r, k, v, w, u, s0, want_ckpt=True)[2]
    return r, k, v, w, u, s0, dy, dsf, ck


def _wkv_bwd_held(got, want, with_s0):
    """Each of dr, dk, dv, dw, du (and ds0 with s0) finite and within
    1e-4 x max(max |want|, 1) absolute (chip_smoke.py's bar)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 5 and not with_s0:
            continue
        bar = 1e-4 * max(b.abs().max().item(), 1.0)
        assert torch.isfinite(a).all() and (a - b).abs().max().item() <= bar


@pytest.mark.parametrize("shape,decay,with_s0,with_dsf", [
    ((1, 128, 2, 32), -3.0, False, False),
    ((2, 256, 4, 64), -3.0, True, True),
    ((1, 2100, 2, 64), -3.0, False, True),    # ragged last span
    ((4, 1, 40, 64), -3.0, True, True),       # one decode step: S = 1
    ((2, 100, 3, 16), -3.0, True, True),
    ((2, 100, 3, 128), -3.0, True, False),
    ((2, 256, 4, 64), 2.0, False, True),      # strong decay
    ((2, 33, 3, 32), -3.0, True, True),       # one token past a span
])
def test_wkv6_backward_matches_plain(dev, shape, decay, with_s0, with_dsf):
    args = _wkv_bwd_args(dev, shape, decay, with_s0, with_dsf)
    got = wkv.wkv6_bwd(*args)
    want = ref.wkv6_bwd_plain(*args[:-1])
    torch.cuda.synchronize()
    _wkv_bwd_held(got, want, with_s0)


def test_wkv6_backward_reads_misaligned_rows(dev):
    """Rows that allow no 16-byte copies take the 4-byte path in both the
    row walk and the dv pass."""
    r, k, v, w, u, s0, dy, dsf, _ = _wkv_bwd_args(dev, (2, 77, 3, 64),
                                                  with_s0=True)
    args = [_misaligned(t) for t in (r, k, v, w)]
    assert wkv.copy_bytes(*args, dy) == 4
    ck = wkv.wkv6_fwd(*args, u, s0, want_ckpt=True)[2]
    got = wkv.wkv6_bwd(*args, u, s0, dy, dsf, ck)
    _wkv_bwd_held(got, ref.wkv6_bwd_plain(*args, u, s0, dy, dsf), True)


def test_wkv6_forward_checkpoints_hold_the_states(dev):
    """want_ckpt: the state before tokens 0, 32, 64, ... (WKV_BAR of the
    plain recurrence's), and y bitwise equal to the serving kernel's."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, (2, 100, 3, 64), with_s0=True)
    y, _, ck = wkv.wkv6_fwd(r, k, v, w, u, s0, want_ckpt=True)
    assert ck.shape == (2, 3, 4, 64, 64)
    assert _wkv_ok(ck, ref.wkv6_checkpoints(k, v, w, s0, wkv.CKPT_EVERY))
    assert torch.equal(y, wkv.wkv6(r, k, v, w, u, s0)[0])


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("s,with_dsf", [(1, True), (33, True), (47, False),
                                        (64, True), (100, True),
                                        (2100, True)])
def test_wkv6_reverse_pass_checkpoints_match_plain(dev, s, with_dsf, hd):
    """The gradient after every span that the backward's reverse pass
    leaves for the span walk, against `ref.wkv6_grad_checkpoints` (the
    elementwise bar of `_wkv_ok`): S a multiple of the span, and S whose
    spans counted back from the last token are out of phase (1, 33, 47,
    100, 2100), the last one zeros without ds_final."""
    args = _wkv_bwd_args(dev, (1 if s == 2100 else 2, s, 3, hd),
                         with_s0=True, with_dsf=with_dsf)
    r, k, v, w, u, s0, dy, dsf, ck = args
    gck = wkv.bwd_launch(wkv._bwd(), *args)[6]
    want = ref.wkv6_grad_checkpoints(r, w, dy, dsf, wkv.CKPT_EVERY)
    torch.cuda.synchronize()
    assert gck.shape == want.shape and _wkv_ok(gck, want)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("s", [33, 2047, 2100])
def test_wkv6_backward_at_span_phases(dev, s, hd):
    """The backward against its plain twin where the span walk's last span
    is short (S = 33, 2047, 2100: the reverse pass's checkpoints out of
    phase with the forward's)."""
    args = _wkv_bwd_args(dev, (1, s, 2, hd), with_s0=True, seed=s)
    got = wkv.wkv6_bwd(*args)
    want = ref.wkv6_bwd_plain(*args[:-1])
    torch.cuda.synchronize()
    _wkv_bwd_held(got, want, True)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("s,chunk", [(33, 1), (100, 16), (100, 64),
                                     (300, 128)])
def test_wkv6_forward_checkpoints_through_the_tile(dev, s, chunk, hd):
    """The checkpoints the forward stores through its shared tile, at
    chunks that put them at every place in a stage, against
    `ref.wkv6_checkpoints`; y bitwise equal to the serving kernel's."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, (2, s, 3, hd), with_s0=True,
                                    seed=chunk)
    y, _, ck = wkv.wkv6_fwd(r, k, v, w, u, s0, chunk=chunk, want_ckpt=True)
    want = ref.wkv6_checkpoints(k, v, w, s0, wkv.CKPT_EVERY)
    torch.cuda.synchronize()
    assert ck.shape == want.shape and _wkv_ok(ck, want)
    assert torch.equal(y, wkv.wkv6(r, k, v, w, u, s0, chunk=chunk)[0])


def test_wkv6_backward_is_deterministic(dev):
    """Two backward calls at the training shape (4, 2048, 40, 64) give
    bitwise-equal outputs: no atomics."""
    args = _wkv_bwd_args(dev, (4, 2048, 40, 64), with_dsf=False)
    first, second = wkv.wkv6_bwd(*args), wkv.wkv6_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_rwkv_model_train_step_launches_forwards_and_backwards(dev):
    """One loss + backward of a 2-layer RWKV6 model with remat full: per
    layer a wkv6 forward, its recompute and a wkv6 backward; gradients
    against the plain recurrence's within 5e-2 relative L2."""
    cfg = ArchConfig(name="gpu-rwkv", family="ssm", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
                     vocab=512, rwkv=True)
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                dtype=torch.float32)
    leaves = [params["embed"]["table"], params["seg0"][0]["tmix"]["wr"],
              params["seg0"][1]["tmix"]["w0"],
              params["seg0"][1]["tmix"]["bonus"]]
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, 301), device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    before = (wkv.wkv6.launches, wkv.wkv6_bwd.launches)
    got = torch.autograd.grad(lm.build(cfg).loss(params, batch), leaves)
    assert (wkv.wkv6.launches - before[0],
            wkv.wkv6_bwd.launches - before[1]) == (2 * cfg.n_layers,
                                                   cfg.n_layers)
    want = torch.autograd.grad(
        lm.build(cfg, force="plain").loss(params, batch), leaves)
    for g, w in zip(got, want):
        assert ((g - w).norm() / w.norm()).item() <= 5e-2


def test_rwkv_model_launches_one_kernel_per_layer_per_step(dev):
    cfg = ArchConfig(name="gpu-rwkv", family="ssm", n_layers=2, d_model=256,
                     n_heads=4, n_kv_heads=4, head_dim=64, d_ff=512,
                     vocab=512, rwkv=True)
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=dev)
    cache, pcache = model.init_cache(2, 42, dev), plain.init_cache(2, 42, dev)
    before = wkv.wkv6.launches
    got = [model.prefill(params, tokens, cache)]
    want = [plain.prefill(params, tokens, pcache)]
    for i in range(2):
        tok = got[-1][:, -1].argmax(-1, keepdim=True)
        got.append(model.decode_step(params, tok, cache, 40 + i))
        want.append(plain.decode_step(params, tok, pcache, 40 + i))
    assert wkv.wkv6.launches - before == 3 * cfg.n_layers
    for g, p in zip(got, want):
        assert ((g - p).abs().max() / p.abs().max()).item() <= 2e-2


# ---------------------------------------------------------------------------
# The mixture of experts (DeepSeek-MoE): plain PyTorch, the flash forward
# in its attention
# ---------------------------------------------------------------------------


def test_moe_block_fp32_cuda_matches_cpu_with_drops(dev):
    """fp32 `blocks.moe` at a width that drops slots (16 experts, top 4,
    capacity 1.0): the card's chosen experts and kept (token, slot) pairs
    equal the CPU's, the output within 1e-4 relative max, the aux within
    1e-6."""
    from repro_torch.models import blocks
    dims = blocks.MoEDims(d_model=256, n_experts=16, top_k=4, d_expert=128,
                          n_shared=1, group_size=256, capacity_factor=1.0)
    params = blocks.init_moe(torch.Generator("cpu").manual_seed(0), dims,
                             dtype=torch.float32)
    params["router_bias"] = torch.linspace(-0.02, 0.02, 16)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 600, 256)).astype(np.float32))
    gp = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in params.items()}
    want, want_aux = blocks.moe(params, dims, x)
    got, aux = blocks.moe(gp, dims, x.to(dev))
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4
    assert abs(aux.item() - want_aux.item()) <= 1e-6
    xg, valid = blocks.group_tokens(x, dims.group_size)
    _, w_expert, _, _, w_kept, _ = blocks.route(params, dims, xg, valid)
    _, g_expert, _, _, g_kept, _ = blocks.route(gp, dims, xg.to(dev),
                                                valid.to(dev))
    assert torch.equal(g_expert.cpu(), w_expert)
    assert torch.equal(g_kept.cpu(), w_kept)
    assert int((valid[..., None] & ~w_kept).sum()) > 0


def _moe_reduced():
    import repro_torch.configs as configs
    return configs.get("deepseek-moe-16b", reduced=True)


def test_moe_model_cuda_matches_cpu(dev):
    """The reduced deepseek-moe-16b forward (below the flash threshold:
    plain PyTorch throughout) on the card against the CPU, 2e-2."""
    cfg = _moe_reduced()
    model = lm.build(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator("cpu").manual_seed(2))
    want = model.forward(params, tokens)
    gp = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    got = model.forward(gp, tokens.to(dev)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2


def test_moe_model_prefill_launches_one_kernel_per_layer_decode_none(dev):
    """A 2048-token prefill of the reduced deepseek-moe-16b launches the
    flash forward once per layer (its dense lead and its MoE layer) and
    matches the plain twin (2e-2); decode steps launch none."""
    cfg = _moe_reduced()
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, ops.FLASH_THRESHOLD),
                           device=dev)
    cache = model.init_cache(2, ops.FLASH_THRESHOLD + 2, dev)
    before = fa.flash_attention.launches
    got = model.prefill(params, tokens, cache)
    assert fa.flash_attention.launches - before == cfg.n_layers == 2
    want = plain.prefill(params, tokens,
                         plain.init_cache(2, ops.FLASH_THRESHOLD + 2, dev))
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    before = fa.flash_attention.launches
    tok = got[:, -1].argmax(-1, keepdim=True)
    for i in range(2):
        tok = model.decode_step(params, tok, cache, ops.FLASH_THRESHOLD + i)[
            :, -1].argmax(-1, keepdim=True)
    assert fa.flash_attention.launches == before
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab


# ---------------------------------------------------------------------------
# DeepSeek-V3's MLA layout: q (B, Sq, H, 576), one shared k head of 576 and v
# head of 512, through its own kernels (wgmma for bf16, SIMT for fp32)
# ---------------------------------------------------------------------------

MLA_SCALE = 192 ** -0.5   # V3's qk_dim ** -0.5
# (Sq, Skv, q_offset): one key; the bf16 kernel's 64-key tiles at 63 / 64 /
# 65 / 191 and the SIMT kernel's 32-key tiles at 127 / 129 (both kernels'
# 64-row blocks: 63, 65, 189 ... rows); a decode step at the end of a
# 2064-position cache, the prefill into it and a chunk prefilled at
# position 1900 of it
MLA_EDGES = [(1, 1, 0), (63, 63, 0), (64, 64, 0), (65, 65, 0), (127, 127, 0),
             (129, 129, 0), (191, 191, 0), (1, 2064, 2063), (2048, 2064, 0),
             (100, 2064, 1900)]


def _mla(dev, b, sq, skv, h, dtype, view=False, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(b, sq, h, 576, generator=g, device=dev).to(dtype)
    k = torch.randn(b, skv, 1, 576, generator=g, device=dev).to(dtype)
    v = (k[..., :512] if view else
         torch.randn(b, skv, 1, 512, generator=g, device=dev).to(dtype))
    return q, k, v


def _mla_against_plain(q, k, v, dtype, q_offset):
    """The kernel against the plain twin, causal at MLA_SCALE: one launch
    at the MLA layout and none elsewhere, the output within TOL (max abs),
    lse within 1e-4 (relative max)."""
    assert fa.mla_kernel(q, k, v) == (
        "simt" if dtype == torch.float32 else "wgmma_kv"
        if v.data_ptr() == k.data_ptr() else "wgmma")
    kw = dict(causal=True, q_offset=q_offset, scale=MLA_SCALE)
    before = (fa.flash_attention.launches, fa.flash_attention.launches_mla)
    got, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    assert (fa.flash_attention.launches - before[0],
            fa.flash_attention.launches_mla - before[1]) == (0, 1)
    want, want_lse = ref.flash_fwd(q, k, v, min(512, k.shape[1]), **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (*q.shape[:3], 512)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert ((lse - want_lse).abs().max()
            / want_lse.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 128])
@pytest.mark.parametrize("sq,skv,q_offset", MLA_EDGES)
def test_mla_kernel_matches_plain(dev, dtype, h, sq, skv, q_offset):
    q, k, v = _mla(dev, 2, sq, skv, h, dtype)
    _mla_against_plain(q, k, v, dtype, q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 128])
@pytest.mark.parametrize("sq,skv,q_offset", MLA_EDGES)
def test_mla_kernel_with_v_a_view_of_k_matches_plain(dev, dtype, h, sq, skv,
                                                     q_offset):
    """v as k's first 512 features, as `mla_attention` passes it: the
    bf16 kernel's K tile serves as its V tile."""
    q, k, v = _mla(dev, 2, sq, skv, h, dtype, view=True)
    _mla_against_plain(q, k, v, dtype, q_offset)


def test_mla_bf16_kernel_rejects_a_q_it_cannot_flatten(dev):
    """The bf16 kernel reads q's (position, head) rows at one stride: a q
    whose position stride is not H times its head stride raises before
    any launch; the same q in fp32 runs the SIMT kernel."""
    q, k, v = _mla(dev, 2, 40, 40, 3, torch.bfloat16, view=True)
    bad = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = fa.flash_attention.launches_mla
    with pytest.raises(ValueError, match="position stride"):
        fa.flash_attention(bad, k, v, scale=MLA_SCALE)
    assert fa.flash_attention.launches_mla == before
    _mla_against_plain(bad.float(), k.float(), v.float(), torch.float32, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_kernel_reads_v_as_a_view_of_k(dev, dtype):
    """v as k's first 512 features (a strided view, as `mla_attention`
    passes it), and a strided q: the caller's strides, uncopied."""
    q, k, v = _mla(dev, 2, 300, 333, 3, dtype, view=True)
    assert not v.is_contiguous()
    _mla_against_plain(q, k, v, dtype, 33)
    qw, _, _ = _mla(dev, 2, 300, 1, 6, dtype, seed=1)
    _mla_against_plain(qw[:, :, ::2], k, v, dtype, 33)


def test_mla_kernel_rejects_other_layouts(dev):
    """Only (576, 512) with one shared k / v head is taken: a v of 576, a
    q of 512, or two k heads under 128 q heads still raise."""
    q, k, v = _mla(dev, 1, 8, 8, 128, torch.bfloat16)
    for args in ((q, k, k), (q[..., :512], k[..., :512], v),
                 (q, k.expand(-1, -1, 2, -1), v.expand(-1, -1, 2, -1))):
        assert not fa.is_mla(*args)
        with pytest.raises(ValueError):
            fa.flash_attention(*args)


def _mla_bwd_against_plain(q, k, v, dtype, q_offset):
    """The MLA backward against autograd of the plain twin on the same q,
    k, v (v's values as a tensor of its own) and dO, causal at MLA_SCALE:
    the kernels `fa.mla_bwd_kernel` names (SIMT for float32, wgmma for
    bfloat16, V read from the K tiles where v is a view of k), one launch
    at the MLA layout and none elsewhere, dq, dk and dv in the inputs'
    dtype within TOL of max(max |want|, 1), as chip_smoke holds the
    backwards; where v is a view of k, the fused call too (`dv_into_dk`,
    as `FlashAttention` makes it): dq and k's whole gradient against the
    twin's dq and dk + [dv, 0] at the same bar, no dv.  Returns (dq, dk,
    dv)."""
    kw = dict(causal=True, q_offset=q_offset, scale=MLA_SCALE)
    do = torch.randn(*q.shape[:3], 512, device=q.device,
                     generator=torch.Generator(q.device).manual_seed(7)
                     ).to(dtype)
    view = fa.v_in_k(k, v)
    assert fa.mla_bwd_kernel(q, k, v, do) == (
        "simt" if dtype == torch.float32 else "wgmma_kv" if view
        else "wgmma")
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert (fa.flash_attention_bwd.launches - before[0],
            fa.flash_attention_bwd.launches_mla - before[1]) == (0, 1)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa.flash_attention_plain(qr, kr, vr, **kw).backward(do)
    torch.cuda.synchronize()
    wants = [(got, (qr.grad, kr.grad, vr.grad))]
    if view:
        fused = fa.flash_attention_bwd(q, k, v, out, do, lse,
                                       dv_into_dk=True, **kw)
        assert fused[2] is None
        whole = kr.grad.clone()
        whole[..., :512] += vr.grad
        wants.append((fused[:2], (qr.grad, whole)))
    for outs, refs in wants:
        for a, want in zip(outs, refs):
            assert a.shape == want.shape and a.dtype == dtype
            assert torch.isfinite(a).all()
            assert (a.float() - want.float()).abs().max().item() \
                <= TOL[dtype] * max(want.float().abs().max().item(), 1.0)
    return got


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 20, 128])
@pytest.mark.parametrize("sq,skv,q_offset", MLA_EDGES)
def test_mla_backward_matches_plain(dev, view, dtype, h, sq, skv, q_offset):
    """The backward at the MLA layout at its 16-key and 16-row tile edges
    (63 / 64 / 65 / 127 / 129 / 191), a decode step, a 2048-token prefill
    into 2064 keys and a chunk at position 1900; one head, 20 (a head
    group of 16 and one of 4: dK / dV sums ragged groups) and V3's 128;
    v a tensor of its own and a view of k (dQ then reads V from its K
    tiles)."""
    q, k, v = _mla(dev, 2, sq, skv, h, dtype, view=view)
    _mla_bwd_against_plain(q, k, v, dtype, q_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_backward_is_deterministic(dev, dtype):
    """Two backward calls at V3's training shape (1, 2048, 128), v a view
    of k, are bitwise equal (no atomics: the head groups' partial dK / dV
    are summed in order); a strided q (every other head of a wider
    tensor) is read at its own strides."""
    q, k, v = _mla(dev, 1, 2048, 2048, 128, dtype, view=True)
    kw = dict(causal=True, scale=MLA_SCALE)
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    do = torch.randn(out.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(5)).to(dtype)
    first = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    second = fa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    qw, _, _ = _mla(dev, 2, 300, 1, 6, dtype, seed=1)
    _, k, v = _mla(dev, 2, 300, 333, 3, dtype, view=True)
    _mla_bwd_against_plain(qw[:, :, ::2], k, v, dtype, 33)


def test_mla_under_grad_raises(dev):
    """The MLA layout under grad: `ops.attention` returns an output with a
    grad_fn whose backward launches the MLA backward kernel once (and no
    other backward), its gradients within TOL of autograd of the plain
    twin; the raw forward still raises rather than hand back an output
    without a gradient; under no_grad nothing is saved."""
    q, k, _ = _mla(dev, 1, 2048, 2048, 2, torch.bfloat16)
    q.requires_grad_()
    k.requires_grad_()
    v = k[..., :512]
    out = ops.attention(q, k, v, scale=MLA_SCALE)
    assert out.grad_fn is not None
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    do = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(3),
                     device=dev).to(out.dtype)
    got = torch.autograd.grad(out, (q, k), do)
    assert (fa.flash_attention_bwd.launches - before[0],
            fa.flash_attention_bwd.launches_mla - before[1]) == (0, 1)
    want = torch.autograd.grad(fa.flash_attention_plain(
        q, k, v, scale=MLA_SCALE), (q, k), do)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= TOL[
            torch.bfloat16] * max(b.float().abs().max().item(), 1.0)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        assert ops.attention(q, k, v).grad_fn is None


def _mla_config():
    """The reduced deepseek-v3-671b at the MLA layout's widths (kv rank
    512, rope 64), so a 2048-token prefill reaches the kernel."""
    import repro_torch.configs as configs
    cfg = configs.get("deepseek-v3-671b", reduced=True)
    return dataclasses.replace(cfg, d_model=256, n_heads=2,
                               mla=dataclasses.replace(cfg.mla,
                                                       kv_lora_rank=512,
                                                       qk_rope_dim=64))


def test_mla_model_prefill_launches_one_kernel_per_layer_decode_none(dev):
    """A 2048-token prefill of a narrow V3 (at the MLA layout's widths)
    launches the MLA-layout kernel once per layer and matches the plain
    twin (2e-2, as the reduced MoE's prefill); decode steps launch
    none."""
    cfg = _mla_config()
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    params = model.init(torch.Generator(dev).manual_seed(0))
    s = ops.FLASH_THRESHOLD
    tokens = torch.randint(0, cfg.vocab, (2, s), device=dev)
    with torch.no_grad():
        cache = model.init_cache(2, s + 2, dev)
        before = fa.flash_attention.launches_mla
        got = model.prefill(params, tokens, cache)
        assert fa.flash_attention.launches_mla - before == cfg.n_layers == 2
        want = plain.prefill(params, tokens, plain.init_cache(2, s + 2, dev))
        assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
        before = (fa.flash_attention.launches, fa.flash_attention.launches_mla)
        tok = got[:, -1].argmax(-1, keepdim=True)
        for i in range(2):
            tok = model.decode_step(params, tok, cache, s + i)[
                :, -1].argmax(-1, keepdim=True)
        assert (fa.flash_attention.launches,
                fa.flash_attention.launches_mla) == before
        assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab


# ---------------------------------------------------------------------------
# Hymba: the flash forward at 25 heads with a 1024-key window, the selective
# SSM and the ring-buffer cache in plain PyTorch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1024, None])
def test_kernel_at_hymba_heads_matches_plain(dev, window):
    """bf16 hd 64 at Hymba's 25 (GQA-expanded) heads, with its 1024-key
    window and without (its global layers), 2048 positions: the kernel
    against the plain twin (2e-2), its lse within 1e-4 relative."""
    q, k, v = _qkv(dev, 2, 2048, 25, 64, torch.bfloat16)
    kw = dict(causal=True, window=window)
    got, lse = fa.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    want, want_lse = ref.flash_fwd(q, k, v, 512, **kw)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert ((lse - want_lse).abs().max() / want_lse.abs().max()).item() \
        <= 1e-4


def _hymba_reduced():
    import repro_torch.configs as configs
    return configs.get("hymba-1.5b", reduced=True)


def test_hymba_model_cuda_matches_cpu(dev):
    """The reduced hymba-1.5b (below the flash threshold: plain PyTorch
    throughout) on the card against the CPU: the forward at 2 x 64 and a
    prefill of 8 tokens then 40 decode steps, through 2.5 wraps of the
    16-slot ring (2e-2 and 3e-2), the rings' pos equal."""
    cfg = _hymba_reduced()
    model = lm.build(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    gp = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator("cpu").manual_seed(2))
    want = model.forward(params, tokens)
    got = model.forward(gp, tokens.to(dev)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    runs = []
    for p, d in ((params, "cpu"), (gp, dev)):
        cache, toks = model.init_cache(2, 48, d), tokens.to(d)
        outs = [model.prefill(p, toks[:, :8], cache)]
        outs += [model.decode_step(p, toks[:, i:i + 1], cache, i)
                 for i in range(8, 48)]
        runs.append(([o.cpu() for o in outs],
                     cache["seg1"][0]["kv"]["pos"].cpu()))
    (want, want_pos), (got, got_pos) = runs
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 3e-2
    assert torch.equal(got_pos, want_pos)


def test_hymba_model_prefill_launches_one_kernel_per_layer_decode_none(dev):
    """A 2048-token prefill of the reduced hymba-1.5b launches the flash
    forward once per layer (its window of 16 in the middle one) and
    matches the plain twin (2e-2); decode steps launch none."""
    cfg = _hymba_reduced()
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, ops.FLASH_THRESHOLD),
                           device=dev)
    cache = model.init_cache(2, ops.FLASH_THRESHOLD + 2, dev)
    before = fa.flash_attention.launches
    got = model.prefill(params, tokens, cache)
    assert fa.flash_attention.launches - before == cfg.n_layers == 3
    want = plain.prefill(params, tokens,
                         plain.init_cache(2, ops.FLASH_THRESHOLD + 2, dev))
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    before = fa.flash_attention.launches
    tok = got[:, -1].argmax(-1, keepdim=True)
    for i in range(2):
        tok = model.decode_step(params, tok, cache, ops.FLASH_THRESHOLD + i)[
            :, -1].argmax(-1, keepdim=True)
    assert fa.flash_attention.launches == before
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab


# ---------------------------------------------------------------------------
# The selective scan (Hymba's SSM): the kernels against the plain twins
# ---------------------------------------------------------------------------


def _scan_args(dev, b, s, d, n, with_h0=True, strong=False, seed=0):
    """(dt, u, B, C, a, h0), dy, dh_last on the card; `strong` draws dt in
    [6, 10], so exp(dt a) underflows to 0 in the upper states."""
    g = torch.Generator(dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    dt = (6 + 4 * torch.rand((b, s, d), generator=g, device=dev) if strong
          else torch.nn.functional.softplus(randn(b, s, d)))
    a = -torch.arange(1, n + 1, device=dev) * torch.exp(0.1 * randn(d, n))
    args = (dt, randn(b, s, d), randn(b, s, n), randn(b, s, n), a,
            0.3 * randn(b, d, n) if with_h0 else None)
    return args, randn(b, s, d), 0.1 * randn(b, d, n)


@pytest.mark.parametrize("shape,with_h0,strong", [
    ((2, 1, 1600, 16), True, False),
    ((2, 33, 64, 4), False, False),
    ((2, 65, 77, 4), True, False),
    ((3, 100, 77, 16), False, True),
    ((2, 300, 1600, 16), True, False),
    ((2, ss.CHUNK - 1, 64, 4), True, False),
    ((2, ss.CHUNK, 1600, 16), False, False),
    ((2, ss.CHUNK + 1, 64, 16), True, False),
    ((2, 2 * ss.CHUNK - 6, 77, 16), True, False),
    ((2, 2 * ss.CHUNK + 44, 77, 4), False, True),
])
def test_scan_kernels_match_plain(dev, shape, with_h0, strong):
    """The forward's y and h_last within 1e-5 (relative max) of the plain
    loop, its checkpoints of `ref.ssm_checkpoints`; the backward's six
    gradients within 1e-4 x max(max |want|, 1) of `ref.ssm_scan_bwd_plain`,
    finite.  The shapes cross the kernels' chunks of ss.CHUNK tokens (one
    chunk, its edges, D = 77 over two chunks, strong decay over three)."""
    args, dy, dh = _scan_args(dev, *shape, with_h0, strong)
    y, h, ck = ss.selective_scan_fwd(*args, want_ckpt=True)
    want_y, want_h = ss.ssm_scan_plain(*args)
    want_ck = ref.ssm_checkpoints(args[0], args[1], args[2], args[4],
                                  args[5], ss.CKPT_EVERY)
    for got, want in ((y, want_y), (h, want_h), (ck, want_ck)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    got = ss.selective_scan_bwd(*args, dy, dh, ck)
    want = ref.ssm_scan_bwd_plain(*args, dy, dh)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(),
                                                        1.0)


@pytest.mark.parametrize("shape,with_h0", [
    ((2, 3 * ss.CHUNK + 5, 64, 16), True),
    ((3, 2 * ss.CHUNK, 77, 4), False),
])
def test_scan_kernels_match_the_chunked_order(dev, shape, with_h0):
    """The kernels against their chunk and carry order on the same device
    (`ref.ssm_scan_chunked`, `ref.ssm_scan_bwd_plain` at ss.CHUNK): y and
    h_last within 1e-5 (relative max), the six gradients within 1e-4 x
    max(max |want|, 1)."""
    args, dy, dh = _scan_args(dev, *shape, with_h0)
    y, h, ck = ss.selective_scan_fwd(*args, want_ckpt=True)
    want_y, want_h = ref.ssm_scan_chunked(*args, ss.CHUNK)
    for got, want in ((y, want_y), (h, want_h)):
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    got = ss.selective_scan_bwd(*args, dy, dh, ck)
    want = ref.ssm_scan_bwd_plain(*args, dy, dh, ckpt_every=ss.CKPT_EVERY,
                                  chunk=ss.CHUNK)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(),
                                                        1.0)


def test_scan_backward_is_deterministic(dev):
    """Two backward calls at Hymba-1.5B's training shape (4, 2048, 1600,
    16) give bitwise-equal gradients: no atomics."""
    args, dy, _ = _scan_args(dev, 4, 2048, 1600, 16, with_h0=False)
    _, _, ck = ss.selective_scan_fwd(*args, want_ckpt=True)
    first = ss.selective_scan_bwd(*args, dy, None, ck)
    second = ss.selective_scan_bwd(*args, dy, None, ck)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_scan_function_under_checkpoint(dev):
    """`ops.ssm_scan` through `SelectiveScan` under
    `torch.utils.checkpoint(use_reentrant=False)` gives the gradients it
    gives without (bitwise: the recompute runs the same kernel), with two
    forward launches and one backward; and the raw wrapper raises for an
    input that requires grad."""
    args, dy, dh = _scan_args(dev, 2, 100, 64, 16)
    ins = [t.requires_grad_(True) for t in args]

    def run(*xs):
        y, h = ops.ssm_scan(*xs)
        return (y * dy).sum() + (h * dh).sum()
    want = torch.autograd.grad(run(*ins), ins)
    before = (ss.selective_scan.launches, ss.selective_scan_bwd.launches)
    got = torch.autograd.grad(
        torch.utils.checkpoint.checkpoint(run, *ins, use_reentrant=False),
        ins)
    assert (ss.selective_scan.launches - before[0],
            ss.selective_scan_bwd.launches - before[1]) == (2, 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(RuntimeError, match="requires grad"):
        ss.selective_scan(*ins)


def test_hymba_model_train_step_launches_scan_and_flash(dev):
    """One loss + backward of the reduced hymba-1.5b at 2 x 2048 with remat
    full: per layer two flash forwards and one backward, two scan forwards
    (one writing checkpoints, its recompute) and one scan backward; every
    gradient finite and the loss within 2e-2 of the plain twins'."""
    cfg = _hymba_reduced()
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                dtype=torch.float32)
    leaves = torch.utils._pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, ops.FLASH_THRESHOLD + 1),
                           device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    counters = (fa.flash_attention, fa.flash_attention_bwd,
                ss.selective_scan, ss.selective_scan_bwd)
    before = [c.launches for c in counters]
    loss = lm.build(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    n = cfg.n_layers
    assert [c.launches - b for c, b in zip(counters, before)] == [
        2 * n, n, 2 * n, n]
    assert all(torch.isfinite(g).all() for g in grads)
    want = lm.build(cfg, force="plain").loss(params, batch)
    assert abs(loss.item() - want.item()) <= 2e-2 * abs(want.item())


# ---------------------------------------------------------------------------
# Whisper (the encoder-decoder): the decoder's self-attention through the
# flash kernels, the encoder and the cross-attention naive
# ---------------------------------------------------------------------------


def _whisper_reduced():
    import repro_torch.configs as configs
    return configs.get("whisper-small", reduced=True)


def _frames(cfg, b, dev, seed=3):
    g = torch.Generator("cpu").manual_seed(seed)
    return torch.randn((b, cfg.encdec.n_frames, cfg.d_model),
                       generator=g).bfloat16().to(dev)


def test_whisper_model_cuda_matches_cpu(dev):
    """The reduced whisper-small (below the flash threshold: plain PyTorch
    throughout) on the card against the CPU: the encoder's output and the
    forward at 2 x 64 (2e-2), and a prefill of 8 tokens then 8 decode
    steps given the encoder's output (3e-2)."""
    cfg = _whisper_reduced()
    model = lm.build(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0))
    gp = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    frames = _frames(cfg, 2, "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator("cpu").manual_seed(2))
    enc = model.encode(params, frames)
    got = model.encode(gp, frames.to(dev)).cpu()
    assert ((got - enc).abs().max() / enc.abs().max()).item() <= 2e-2
    want = model.forward(params, tokens, frames=frames)
    got = model.forward(gp, tokens.to(dev), frames=frames.to(dev)).cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    runs = []
    for p, d in ((params, "cpu"), (gp, dev)):
        cache, toks = model.init_cache(2, 16, d), tokens.to(d)
        e = model.encode(p, frames.to(d))
        outs = [model.prefill(p, toks[:, :8], cache, enc_out=e)]
        outs += [model.decode_step(p, toks[:, i:i + 1], cache, i, enc_out=e)
                 for i in range(8, 16)]
        runs.append([o.cpu() for o in outs])
    for g, w in zip(*reversed(runs)):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 3e-2


def test_whisper_prefill_launches_one_kernel_per_decoder_layer(dev):
    """A 2048-token decoder prefill of the reduced whisper-small launches
    the flash forward once per decoder layer and matches the plain twin
    (2e-2); the encoder (32 frames), the cross-attention and the decode
    steps launch none."""
    cfg = _whisper_reduced()
    model, plain = lm.build(cfg), lm.build(cfg, force="plain")
    params = model.init(torch.Generator(dev).manual_seed(0))
    frames = _frames(cfg, 2, dev)
    tokens = torch.randint(0, cfg.vocab, (2, ops.FLASH_THRESHOLD),
                           device=dev)
    before = fa.flash_attention.launches
    enc = model.encode(params, frames)
    assert fa.flash_attention.launches == before
    cache = model.init_cache(2, ops.FLASH_THRESHOLD + 2, dev)
    got = model.prefill(params, tokens, cache, enc_out=enc)
    assert fa.flash_attention.launches - before == cfg.n_layers == 2
    want = plain.prefill(params, tokens,
                         plain.init_cache(2, ops.FLASH_THRESHOLD + 2, dev),
                         frames=frames)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2
    before = fa.flash_attention.launches
    tok = got[:, -1].argmax(-1, keepdim=True)
    for i in range(2):
        tok = model.decode_step(params, tok, cache, ops.FLASH_THRESHOLD + i,
                                enc_out=enc)[:, -1].argmax(-1, keepdim=True)
    assert fa.flash_attention.launches == before
    assert 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab


def test_whisper_train_step_launches_decoder_flash_only(dev):
    """One loss + backward of the reduced whisper-small at 2 x 2048 with
    bf16 frames and remat full: per decoder layer two flash forwards and
    one backward, none for the encoder or the cross-attention; every
    gradient finite (the encoder's nonzero) and the loss within 2e-2 of
    the plain twins'."""
    cfg = _whisper_reduced()
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                dtype=torch.float32)
    leaves = torch.utils._pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (2, ops.FLASH_THRESHOLD + 1),
                           device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": _frames(cfg, 2, dev)}
    counters = (fa.flash_attention, fa.flash_attention_bwd)
    before = [c.launches for c in counters]
    loss = lm.build(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    n = cfg.n_layers
    assert [c.launches - b for c, b in zip(counters, before)] == [2 * n, n]
    assert all(torch.isfinite(g).all() for g in grads)
    enc = torch.utils._pytree.tree_leaves(params["encoder"])
    assert all(g.abs().sum() > 0 for p, g in zip(leaves, grads)
               if any(p is e for e in enc))
    want = lm.build(cfg, force="plain").loss(params, batch)
    assert abs(loss.item() - want.item()) <= 2e-2 * abs(want.item())


# ---------------------------------------------------------------------------
# The float64 pipeline: cuda against cpu
# ---------------------------------------------------------------------------

PIPE_REL = 1e-12
PIPE_MEMS = ("sram", "stt", "sot")
PIPE_CAPS = tuple(int(c * 2**20) for c in (0.5, 1, 3, 7, 10, 16, 64, 96))
SPECS = Path(__file__).resolve().parents[1] / "specs"


def _max_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-300)))


def test_pipeline_design_table_cuda_matches_cpu(dev):
    nodes = tuple(tech.NODES.values())
    got = engine.design_table(PIPE_MEMS, PIPE_CAPS, nodes=nodes,
                              device="cuda")
    want = engine.design_table(PIPE_MEMS, PIPE_CAPS, nodes=nodes,
                               device="cpu")
    for f in ("read_latency_s", "write_latency_s", "read_energy_j",
              "write_energy_j", "leakage_w", "area_mm2"):
        assert _max_rel(getattr(got, f), getattr(want, f)) <= PIPE_REL, f
    for node in nodes:
        for mem in PIPE_MEMS:
            for cap in PIPE_CAPS:
                assert got.tuned_index(mem, cap, node) \
                    == want.tuned_index(mem, cap, node), (node, mem, cap)


def test_pipeline_fold_cuda_matches_cpu(dev):
    table = engine.design_table(PIPE_MEMS, PIPE_CAPS, device="cpu")
    designs = [table.tuned(m, c) for c in PIPE_CAPS for m in PIPE_MEMS]
    stats = [workload_engine.stats_for(w, b, t)
             for w in workloads.registry().values()
             for t in (False, True) for b in (1, 64, 4096)]
    platforms = tuple(tech.PLATFORMS.values())
    want = workload_engine.evaluate_platforms(stats, designs, platforms,
                                              device="cpu")
    for path in ("evaluate_platforms", "evaluate_bucketed",
                 "evaluate_chunk"):
        got = getattr(workload_engine, path)(stats, designs, platforms,
                                             device="cuda")
        for g, w in zip(got, want):
            for f in ("l2_read_tx", "l2_write_tx", "dram_tx", "runtime_s",
                      "runtime_nodram_s", "dyn_read_j", "dyn_write_j",
                      "leak_j", "leak_nodram_j", "dram_j"):
                assert _max_rel(getattr(g, f), getattr(w, f)) \
                    <= PIPE_REL, (path, f)
    assert _max_rel(workload_engine.dram_tx(stats, PIPE_CAPS, device="cuda"),
                    workload_engine.dram_tx(stats, PIPE_CAPS, device="cpu")) \
        <= PIPE_REL


@pytest.mark.parametrize("name", ["isocap", "dtco", "dtco_isoarea", "lm_nvm",
                                  "mixed_cnn_lm"])
def test_pipeline_golden_spec_cuda_matches_cpu(dev, name):
    spec = sweep.load_spec(str(SPECS / f"{name}.json")).resolve()
    got = sweep.run(spec, device="cuda")
    want = sweep.run(spec, device="cpu")
    assert [str(d.org) for d in got.designs] \
        == [str(d.org) for d in want.designs]
    sharded = sweep.run(spec, sweep.ShardPlan(scenario_chunk=3, devices=1),
                        device="cuda")
    for res in (got, sharded):
        assert len(res.rows()) == len(want.rows())
        for g, w in zip(res.rows(), want.rows()):
            assert g.keys() == w.keys()
            for k, v in w.items():
                if isinstance(v, float):
                    assert abs(g[k] - v) <= PIPE_REL * abs(v), (name, k)
                else:
                    assert g[k] == v, (name, k)


def _assert_doc_close(got, want, where=""):
    """Nested dicts / lists of floats within PIPE_REL; the rest equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_doc_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_doc_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= PIPE_REL * abs(want), (where, got, want)
    else:
        assert got == want, where


def test_pipeline_dtco_cuda_matches_cpu(dev):
    import dataclasses

    from repro_torch.core import dtco
    for fn, head in ((dtco.analyze, dtco.headline),
                     (dtco.isoarea_analyze, dtco.isoarea_headline)):
        got, want = fn(device="cuda"), fn(device="cpu")
        _assert_doc_close([dataclasses.asdict(r) for r in got],
                          [dataclasses.asdict(r) for r in want])
        _assert_doc_close(head(got), head(want))


def test_pipeline_service_cuda_matches_cpu(dev):
    """The same request sequence through a service on `cuda` and one on
    `cpu`: the same sources and stats counters, every view within
    PIPE_REL; then a coalesced burst on `cuda` against `sweep.run` on
    `cpu`."""
    import json
    import threading

    from repro_torch.sweep.service import SweepService
    views = ["rows", "summary", "pareto", "plateaus"]
    docs = {n: json.loads((SPECS / f"{n}.json").read_text())
            for n in ("isocap", "dtco", "dtco_isoarea", "lm_nvm",
                      "mixed_cnn_lm")}
    requests = [{"spec": d, "want": views} for d in docs.values()]
    requests += [{"spec": docs["isocap"], "want": ["rows"]},
                 {"spec": docs["dtco"], "want": ["summary"],
                  "shard": {"scenario_chunk": 3, "devices": 1}}]
    on = {d: SweepService(window_ms=0.0, device=d) for d in ("cuda", "cpu")}
    try:
        assert on["cuda"].device == f"cuda:{torch.cuda.current_device()}"
        on["cuda"].warmup(specs=[str(SPECS / "isocap.json")], grid=True)
        for req in requests:
            got, want = (on[d].handle(req) for d in ("cuda", "cpu"))
            assert got["ok"] and want["ok"], (got.get("error"), req)
            assert got["source"] == want["source"]
            for view in views:
                if view in want:
                    _assert_doc_close(got[view], want[view], view)
        counters = [{k: on[d].stats()[k] for k in ("requests",
                                                   "result_cache")}
                    for d in ("cuda", "cpu")]
        assert counters[0] == counters[1]
    finally:
        for svc in on.values():
            svc.close()
    svc = SweepService(window_ms=50.0, device="cuda")
    burst = [docs[n] for n in ("isocap", "dtco", "dtco_isoarea",
                               "lm_nvm")] * 4
    out = [None] * len(burst)
    barrier = threading.Barrier(len(burst))

    def fire(i):
        barrier.wait()
        out[i] = svc.handle({"spec": burst[i], "want": ["rows"]})

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(burst))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
            assert not t.is_alive()
    finally:
        svc.close()
    for d, resp in zip(burst, out):
        assert resp["ok"], resp.get("error")
        want = sweep.SymbolicSweepSpec.from_json(d).run(device="cpu")
        _assert_doc_close(resp["rows"], want.rows(), d["name"])
    assert svc.coalescer.coalesced_requests + svc.coalescer.deduped_requests


# ---------------------------------------------------------------------------
# The inverse designer: cuda against cpu
# ---------------------------------------------------------------------------


def _inverse_problem(name, **kw):
    from repro_torch import inverse
    return inverse.InverseProblem(
        sweep=sweep.SymbolicSweepSpec.load(str(SPECS / f"{name}.json")),
        objective="edp", **kw)


@pytest.mark.parametrize("name", ["isocap", "dtco_isoarea"])
def test_inverse_loss_and_gradient_cuda_match_cpu(dev, name):
    from repro_torch.inverse import relax
    prob = _inverse_problem(name)
    on = {d: relax.lower(prob, device=d) for d in ("cuda", "cpu")}
    theta0 = on["cpu"].theta0
    offset = theta0 + np.random.default_rng(2).uniform(-0.05, 0.05,
                                                       theta0.size)
    for theta in (theta0, offset):
        for temp in (0.5, relax.HARD_TEMP):
            got_g, got = torch.func.grad_and_value(on["cuda"].loss)(
                torch.from_numpy(theta).to("cuda"), temp)
            want_g, want = torch.func.grad_and_value(on["cpu"].loss)(
                torch.from_numpy(theta), temp)
            assert abs(float(got) - float(want)) <= PIPE_REL * abs(
                float(want))
            assert float((got_g.cpu() - want_g).abs().max()) \
                <= 1e-10 * float(want_g.abs().max())
            obj, area, _ = on["cuda"].objective_matrix(
                torch.from_numpy(theta).to("cuda"), temp)
            w_obj, w_area, _ = on["cpu"].objective_matrix(
                torch.from_numpy(theta), temp)
            assert _max_rel(obj.cpu().numpy(), w_obj.numpy()) <= PIPE_REL
            assert _max_rel(area.cpu().numpy(), w_area.numpy()) <= PIPE_REL


@pytest.mark.parametrize("name", ["isocap", "dtco_isoarea"])
def test_inverse_recover_corner_cuda_matches_cpu(dev, name):
    from repro_torch import inverse
    prob = _inverse_problem(name)
    got = inverse.recover_corner(prob, device="cuda")
    want = inverse.recover_corner(prob, device="cpu")
    grid = inverse.grid_argmin(prob, device="cuda")
    assert got["corner"] == want["corner"] == grid["corner"]
    assert abs(got["value"] - want["value"]) <= PIPE_REL * want["value"]
    assert _max_rel(got["objective_matrix"], want["objective_matrix"]) \
        <= PIPE_REL


def test_inverse_two_start_solve_cuda_matches_cpu(dev):
    from repro_torch import inverse
    prob = dataclasses.replace(
        inverse.InverseProblem.load(str(SPECS / "inverse_isocap.json")),
        starts=2, iters=40)
    got = inverse.solve(prob, device="cuda")
    want = inverse.solve(prob, device="cpu")
    assert got.corner == want.corner
    assert got.converged_start == want.converged_start
    assert got.parity_rel_err <= 1e-12
    assert got.best_value < got.grid_best_value
    assert got.area_mm2 <= got.area_budget_mm2 * (1.0 + 1e-9)
    for a, b in ((got.best_value, want.best_value),
                 (got.standard_value, want.standard_value),
                 *zip(got.trajectory, want.trajectory)):
        assert abs(a - b) <= 1e-9 * abs(b)
    assert abs(got.grid_best_value - want.grid_best_value) \
        <= PIPE_REL * want.grid_best_value


def test_inverse_sensitivity_cuda_matches_cpu(dev):
    from repro_torch.inverse import relax, sensitivity
    prob = _inverse_problem("dtco_isoarea")
    rows = {d: sensitivity.sensitivity_rows(
        prob, relax.lower(prob, device=d), device=d) for d in ("cuda", "cpu")}
    assert len(rows["cuda"]) == len(rows["cpu"]) == 640
    for g, w in zip(rows["cuda"], rows["cpu"]):
        assert g["leaf"] == w["leaf"] and g["node"] == w["node"]
        assert abs(g["elasticity"] - w["elasticity"]) <= 1e-10
    assert [(r["node"], r["mem"], r["leaf"])
            for r in sensitivity.top_knobs(rows["cuda"])] \
        == [(r["node"], r["mem"], r["leaf"])
            for r in sensitivity.top_knobs(rows["cpu"])]


def test_inverse_step_copies_nothing_between_host_and_card(dev):
    """A vmapped loss-and-gradient step reads only the lowering's device
    constants: the profiler sees no host <-> device copy in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.inverse import relax
    low = relax.lower(_inverse_problem("isocap"), device="cuda")
    step = torch.func.vmap(torch.func.grad_and_value(low.loss),
                           in_dims=(0, None))
    theta = torch.from_numpy(low.theta0).to("cuda")[None].repeat(4, 1)
    step(theta, 0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(theta, 0.5)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert rows, "the profiler saw no device work"
    # device-to-device copies (a slice's backward) stay on the card
    assert not [e.key for e in rows
                if "Memcpy HtoD" in e.key or "Memcpy DtoH" in e.key]


# ---------------------------------------------------------------------------
# The dry run (launch.dryrun) on fake CUDA tensors against real runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", [("tinyllama-1.1b", "train"),
                                       ("tinyllama-1.1b", "prefill"),
                                       ("rwkv6-3b", "train"),
                                       ("hymba-1.5b", "prefill"),
                                       ("deepseek-v3-671b", "decode")])
def test_dry_run_on_fake_cuda_matches_a_real_run(dev, arch, kind):
    """A reduced cell at 2 x 2048 (the flash threshold) traced on fake CUDA
    tensors through the kernels' shape functions, then run for real:
    argument bytes and FLOPs equal, the predicted peak within 5 % + 256 MiB
    of max_memory_allocated, no launch by the trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.configs as configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, specs
    cfg = configs.get(arch, reduced=True)
    shape = ShapeSpec(f"{kind}_2048", 2048, 2, kind)
    fns = (fa.flash_attention, fa.flash_attention_bwd, wkv.wkv6,
           wkv.wkv6_bwd, ss.selective_scan, ss.selective_scan_bwd)
    before = [fn.launches for fn in fns]
    with FakeTensorMode():
        pred = dryrun.dry_run(specs.build_cell(cfg, shape, device=dev))
    assert [fn.launches for fn in fns] == before
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    cell = specs.build_cell(cfg, shape, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    flops = FlopCounterMode(display=False)
    with flops:
        cell.step_fn(*cell.args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert pred["memory"]["argument_bytes"] == dryrun.tensor_bytes(cell.args)
    assert pred["cost"]["flops"] == flops.get_total_flops()
    assert abs(pred["memory"]["peak_bytes"] - peak) <= 0.05 * peak + 2**28
    if kind != "decode":
        assert [fn.launches for fn in fns] != before


def test_fp8_kv_cache_decode_on_cuda(dev):
    """Reduced TinyLlama served with the fp8 cache on the card: prefill
    and decode finite, the cache fp8 and half the bf16 one's bytes."""
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    cfg = configs.get("tinyllama-1.1b", reduced=True)
    params = lm.build(cfg).init(torch.Generator(dev).manual_seed(0))
    m8 = lm.build(cfg, kv_cache_dtype=torch.float8_e4m3fn)
    prompts = torch.randint(0, cfg.vocab, (2, 16), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    toks = serve.generate(m8, params, prompts, 24, 8)
    assert toks.shape == (2, 8) and int(toks.max()) < cfg.vocab
    c8 = m8.init_cache(2, 24, dev)
    c16 = lm.build(cfg).init_cache(2, 24, dev)
    assert c8["seg0"][0]["kv"]["k"].dtype == torch.float8_e4m3fn
    n8 = sum(t.nbytes for t in torch.utils._pytree.tree_leaves(c8))
    n16 = sum(t.nbytes for t in torch.utils._pytree.tree_leaves(c16))
    assert 2 * n8 == n16
    logits = m8.prefill(params, prompts, c8)
    assert torch.isfinite(logits).all()
