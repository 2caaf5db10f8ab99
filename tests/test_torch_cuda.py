"""The CUDA kernels (flash attention forward and backward, WKV6) against
their plain twins, and the float64 DeepNVM++ pipeline on `cuda` against
the same pipeline on `cpu` (1e-12 relative, equal tuned organizations),
on the GPU.

Marked `cuda`: each test skips without a CUDA device.  Run on the GPU
machine with `PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py`.
This file imports no JAX (the GPU machine has none).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import engine, sweep, tech, workload_engine, workloads
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
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
    """No kernel output without a gradient: the forward and wkv6 raise
    under grad mode for an input that requires grad, and run under
    no_grad; ops.attention takes FlashAttention there instead."""
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
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        wkv.wkv6(r, kk, vv, w, u)
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        ops.rwkv_mix(r, kk, vv, w, u)
    with torch.no_grad():
        wkv.wkv6(r, kk, vv, w, u)


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
