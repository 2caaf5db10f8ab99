"""RWKV6 training in the port against the JAX package, on the CPU.

The WKV6 backward's plain twin, `ref.wkv6_bwd_plain` (the reverse walk the
CUDA backward kernel makes, checkpoints and all), against autograd of the
port's `ref.wkv6_ref` and against `jax.vjp` of `repro.kernels.ref.wkv6_ref`
(the `lax.scan` the JAX package differentiates), on the same numpy-seeded
inputs and cotangents.  Bar: every output (dr, dk, dv, dw, du, ds0) within
1e-4 x max(max |want|, 1) absolute, the bar chip_smoke.py holds the kernel
to; fp32 summation order alone moves them by ~1e-6 here.  Then `WKV6` (the
autograd Function around the kernels) on CPU tensors, where it runs the
plain halves, `build_trainer` on the reduced RWKV6 config, and the LM's
loss and gradients against `jax.value_and_grad` with
tests/test_torch_train.py's bars (loss 1e-3 relative, each leaf 5e-2
relative L2: bf16 activations round at other places in the two packages).
The CUDA kernels run only on a GPU: see tests/test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro_torch.configs as tconfigs
from repro.kernels import ref as _jref
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as wkv
from repro_torch.launch import train as ttrain
from test_torch_train import _batch, _check_grads

ARCH = "rwkv6-3b"
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(shape, seed=0, decay=-3.0, with_s0=False):
    """r, k, v ~ 0.5 N; w = exp(-exp(decay + 0.5 N)); u ~ 0.1 N; s0 ~ 0.1 N;
    the cotangents dy ~ N and ds_final ~ 0.1 N; float32 numpy arrays."""
    b, s, h, hd = shape
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal(shape, np.float32) for _ in "rkv")
    w = np.exp(-np.exp(decay + 0.5 * rng.standard_normal(shape, np.float32)))
    u = 0.1 * rng.standard_normal((h, hd), np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, hd, hd), np.float32)
          if with_s0 else None)
    dy = rng.standard_normal(shape, np.float32)
    dsf = 0.1 * rng.standard_normal((b, h, hd, hd), np.float32)
    return (r, k, v, w.astype(np.float32), u, s0), dy, dsf


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _autograd(args, dy, dsf):
    """(dr, dk, dv, dw, du, ds0) by autograd of the port's `wkv6_ref`."""
    ts = [None if a is None else _t(a).requires_grad_() for a in args]
    y, s_final = ref.wkv6_ref(*ts)
    loss = (y * _t(dy)).sum()
    if dsf is not None:
        loss = loss + (s_final * _t(dsf)).sum()
    loss.backward()
    return [None if t is None else t.grad for t in ts]


def _jax_vjp(args, dy, dsf):
    """The same gradients by `jax.vjp` of the reference's `wkv6_ref`."""
    r, k, v, w, u, s0 = args
    b, _, h, hd = r.shape
    if s0 is None:
        def f(r, k, v, w, u):
            return _jref.wkv6_ref(r, k, v, w, u)
        prims = (r, k, v, w, u)
    else:
        f, prims = _jref.wkv6_ref, args
    _, vjp = jax.vjp(f, *prims)
    cot = (dy, np.zeros((b, h, hd, hd), np.float32) if dsf is None else dsf)
    grads = [np.asarray(g) for g in vjp(cot)]
    return grads + [None] * (6 - len(grads))


def _held(got, want, what):
    for name, g, w_ in zip(NAMES, got, want):
        if w_ is None:
            continue
        w_ = np.asarray(w_.detach() if isinstance(w_, torch.Tensor) else w_,
                        np.float32)
        g = g.detach().numpy()
        assert g.shape == w_.shape, (what, name)
        assert np.isfinite(g).all(), (what, name)
        err = np.abs(g - w_).max()
        assert err <= 1e-4 * max(np.abs(w_).max(), 1.0), (what, name, err)


# (B, S, H, hd, decay, with_s0, with ds_final): S = 1; a ragged last span
# (37 = 32 + 5); hd 16 and 64; with and without s0 and ds_final; R6's
# strong decay (w down to ~1e-6), where dividing by w would lose dw
CASES = [
    (2, 1, 3, 16, -3.0, False, True),
    (2, 1, 3, 16, -3.0, True, False),
    (2, 37, 3, 16, -3.0, True, True),
    (2, 37, 3, 16, -3.0, False, False),
    (1, 70, 2, 64, -3.0, True, True),
    (1, 70, 2, 64, -3.0, False, False),
    (2, 65, 2, 16, 2.0, True, True),
    (1, 96, 2, 64, 2.0, False, True),
]


@pytest.mark.parametrize("b,s,h,hd,decay,with_s0,with_dsf", CASES)
def test_bwd_plain_matches_autograd_and_jax(b, s, h, hd, decay, with_s0,
                                            with_dsf):
    args, dy, dsf = _inputs((b, s, h, hd), seed=s + hd, decay=decay,
                            with_s0=with_s0)
    dsf = dsf if with_dsf else None
    got = ref.wkv6_bwd_plain(*(_t(a) for a in args), _t(dy), _t(dsf))
    assert (got[-1] is not None) and got[4].shape == (h, hd)
    _held(got, _autograd(args, dy, dsf), "autograd")
    _held(got, _jax_vjp(args, dy, dsf), "jax.vjp")


def test_checkpoints_are_the_states_before_every_span():
    """`ref.wkv6_checkpoints` (what chip_smoke.py holds the forward
    kernel's checkpoints to): entry c is the state after the first
    c x every tokens, s0 for c = 0, as `wkv6_ref` leaves it (1e-6)."""
    (r, k, v, w, u, s0), _, _ = _inputs((2, 70, 2, 16), seed=7,
                                        with_s0=True)
    ck = ref.wkv6_checkpoints(_t(k), _t(v), _t(w), _t(s0), 32)
    assert ck.shape == (2, 2, 3, 16, 16)
    assert torch.equal(ck[:, :, 0], _t(s0))
    for c in (1, 2):
        _, want = ref.wkv6_ref(*(_t(a[:, :32 * c]) for a in (r, k, v, w)),
                               _t(u), _t(s0))
        assert (ck[:, :, c] - want).abs().max().item() <= 1e-6


# (B, S, H, hd, decay, with ds_final): S a multiple of the span; S = 47,
# 70 and 1, whose spans, counted back from the last token, are out of
# phase with the forward's; R6's strong decay; hd 16 and 64
GCK_CASES = [
    (2, 64, 2, 16, -3.0, True),
    (2, 47, 3, 16, -3.0, True),
    (2, 47, 2, 16, -3.0, False),
    (2, 1, 3, 16, -3.0, True),
    (1, 96, 2, 16, 2.0, True),
    (1, 70, 2, 64, -3.0, True),
]


@pytest.mark.parametrize("b,s,h,hd,decay,with_dsf", GCK_CASES)
def test_grad_checkpoints_are_the_gradients_after_every_span(
        b, s, h, hd, decay, with_dsf):
    """`ref.wkv6_grad_checkpoints` (what the GPU tests hold the backward's
    reverse pass to): the last entry is ds_final itself (zeros without),
    and entry c < last the gradient of the state after span c, which is
    ds0 of the suffix after that span with the state checkpoint there as
    s0: as the G that `wkv6_bwd_plain` walks, and as `jax.vjp` of the
    reference's `wkv6_ref`, within the bar above."""
    args, dy, dsf = _inputs((b, s, h, hd), seed=s + 3 * hd, decay=decay,
                            with_s0=True)
    dsf = dsf if with_dsf else None
    r, k, v, w, u, s0 = args
    gck = ref.wkv6_grad_checkpoints(_t(r), _t(w), _t(dy), _t(dsf), 32)
    nck = -(-s // 32)
    assert gck.shape == (b, h, nck, hd, hd)
    assert torch.equal(gck[:, :, -1], torch.zeros((b, h, hd, hd))
                       if dsf is None else _t(dsf))
    sck = ref.wkv6_checkpoints(_t(k), _t(v), _t(w), _t(s0), 32)
    for c in range(nck - 1):
        a = 32 * (c + 1)
        suffix = tuple(x[:, a:] for x in (r, k, v, w)) + (
            u, sck[:, :, c + 1].numpy())
        got = [None] * 5 + [gck[:, :, c]]
        plain = ref.wkv6_bwd_plain(*(_t(x) for x in suffix), _t(dy[:, a:]),
                                   _t(dsf))
        _held(got, [None] * 5 + [plain[5]], f"wkv6_bwd_plain, span {c}")
        _held(got, [None] * 5 + [_jax_vjp(suffix, dy[:, a:], dsf)[5]],
              f"jax.vjp, span {c}")


# (B, S, H, hd, decay, with_s0, with ds_final): full spans, a short last
# span (S = 47, 70, 1), R6's strong decay, hd 16 and 64
PAIR_CASES = [
    (2, 64, 2, 16, -3.0, True, True),
    (2, 47, 3, 16, -3.0, False, True),
    (2, 1, 3, 16, -3.0, True, False),
    (1, 70, 2, 64, -3.0, True, True),
    (2, 65, 2, 16, 2.0, True, True),
    (1, 96, 2, 64, 2.0, False, False),
]


@pytest.mark.parametrize("b,s,h,hd,decay,with_s0,with_dsf", PAIR_CASES)
def test_span_pairs_match_the_recurrence_and_jax(b, s, h, hd, decay, with_s0,
                                                 with_dsf):
    """`ref.wkv6_span_pairs`, the span walk by token pairs that the CUDA
    backward runs (each span from its two checkpoints, products of w
    only), gives dr, dk, dw and du of `wkv6_bwd_plain` and of `jax.vjp`
    of the reference `wkv6_ref`, within the bar above."""
    args, dy, dsf = _inputs((b, s, h, hd), seed=2 * s + hd, decay=decay,
                            with_s0=with_s0)
    dsf = dsf if with_dsf else None
    r, k, v, w, u, s0 = (_t(a) for a in args)
    ck = ref.wkv6_checkpoints(k, v, w, s0, 32)
    gck = ref.wkv6_grad_checkpoints(r, w, _t(dy), _t(dsf), 32)
    dr, dk, dw, du = ref.wkv6_span_pairs(r, k, v, w, u, _t(dy), ck, gck, 32)
    got = [dr, dk, None, dw, du, None]

    def but_dv_ds0(want):   # dv and ds0 are the reverse pass's
        return [None if x in (2, 5) else g for x, g in enumerate(want)]
    _held(got, but_dv_ds0(ref.wkv6_bwd_plain(r, k, v, w, u, s0, _t(dy),
                                             _t(dsf))), "wkv6_bwd_plain")
    _held(got, but_dv_ds0(_jax_vjp(args, dy, dsf)), "jax.vjp")


@pytest.mark.parametrize("ckpt_every", [1, 5, 8, 64])
def test_ckpt_every_changes_nothing_beyond_rounding(ckpt_every):
    """The span length is the kernel's kCkptEvery; any other length gives
    the same gradients up to fp32 rounding (1e-5 of the scale)."""
    args, dy, dsf = _inputs((2, 70, 2, 16), seed=4, with_s0=True)
    ts = [_t(a) for a in args]
    want = ref.wkv6_bwd_plain(*ts, _t(dy), _t(dsf))
    got = ref.wkv6_bwd_plain(*ts, _t(dy), _t(dsf), ckpt_every=ckpt_every)
    for name, g, w_ in zip(NAMES, got, want):
        err = (g - w_).abs().max().item()
        assert err <= 1e-5 * max(w_.abs().max().item(), 1.0), (name, err)


@pytest.mark.parametrize("with_s0", [False, True])
def test_function_on_cpu_matches_autograd_of_plain(with_s0):
    """`WKV6.apply` on CPU tensors runs `wkv6_plain` forwards and
    `wkv6_bwd_plain` backwards: outputs equal the plain twin's, gradients
    (through y and s_final) within fp32 rounding of autograd's, and no
    kernel counter moves."""
    args, dy, dsf = _inputs((2, 40, 3, 16), seed=5, with_s0=with_s0)
    before = (wkv.wkv6.launches, wkv.wkv6_bwd.launches)
    ts = [None if a is None else _t(a).requires_grad_() for a in args]
    y, s_final = wkv.WKV6.apply(*ts, True)
    ((y * _t(dy)).sum() + (s_final * _t(dsf)).sum()).backward()
    want_y, want_s = wkv.wkv6_plain(*(_t(a) for a in args))
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(s_final.detach(), want_s)
    _held([None if t is None else t.grad for t in ts],
          _autograd(args, dy, dsf), "WKV6")
    assert (wkv.wkv6.launches, wkv.wkv6_bwd.launches) == before


def test_function_without_grad_saves_nothing():
    """grad=False: the forward saves nothing, so a backward through it
    raises instead of returning a gradient."""
    args, dy, _ = _inputs((1, 8, 2, 16), seed=6)
    ts = [None if a is None else _t(a).requires_grad_() for a in args]
    y, _ = wkv.WKV6.apply(*ts, False)
    with pytest.raises(RuntimeError, match="grad=False"):
        (y * _t(dy)).sum().backward()


def test_build_trainer_steps_rwkv():
    """`build_trainer` on the reduced RWKV6 config, on the CPU: one step
    reports the initial params' loss (`model.loss` on the same batch, within
    1e-6 relative), finite, and moves every time-mix leaf to finite
    values."""
    cfg = tconfigs.get(ARCH, reduced=True)
    model, state, step, _ = ttrain.build_trainer(cfg, device="cpu")
    before = pytree.tree_map(lambda t: t.detach().clone(), state.params)
    _, tb = _batch(cfg.vocab, (2, 64))
    with torch.no_grad():
        want = model.loss(state.params, tb).item()
    state, metrics = step(state, tb)
    assert state.step == 1 and np.isfinite(want)
    assert abs(metrics["loss"].item() - want) <= 1e-6 * abs(want)
    assert all(torch.isfinite(p).all()
               for p in pytree.tree_leaves(state.params))
    tmix = state.params["seg0"][0]["tmix"]
    for name in ("wr", "wk", "wv", "w0", "bonus", "mu_w"):
        assert not torch.equal(tmix[name],
                               before["seg0"][0]["tmix"][name]), name


def test_rwkv_loss_and_grads_match_jax():
    """`LM.loss` + backward of the reduced RWKV6 config (batch 2 x 32)
    against `jax.value_and_grad` of the reference, whose recurrence is the
    differentiated `lax.scan`."""
    _check_grads(ARCH, None, (2, 32))
