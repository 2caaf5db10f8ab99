"""The port's RWKV6 path against the JAX package's, on the CPU.

Inputs come from numpy seeds and go to both frameworks.  Kernel level: the
plain twin `wkv6_plain` against `repro.kernels.ref.wkv6_ref` (the Pallas
`wkv6` needs `pl.load`, which JAX 0.9 no longer has), rtol = atol = 1e-4
as tests/test_kernels.py.  Block and model level: `repro.models.blocks`
and `repro.models.lm` on the `rwkv6-3b-smoke` config, with `bonus`, `w0`
and the `mu_*` mixes drawn from numpy on both sides (the init's bonus of 0
would leave the u term untested).  Bars: fp32 blocks 1e-4, bf16 blocks and
forward / prefill logits 2e-2 relative to the largest magnitude,
teacher-forced decode 3e-2, the bf16 state of the first layer within one
bf16 step (1e-2) and of later layers within 2e-2.
The CUDA kernel runs only on a GPU: see tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref as _jref
from repro.models import blocks as _jb
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv
from repro_torch.launch import serve
from repro_torch.models import blocks as tb
from repro_torch.models import lm as tlm

ARCH = "rwkv6-3b"
jwkv6_ref = jax.jit(_jref.wkv6_ref)
jtmix = jax.jit(_jb.rwkv_tmix, static_argnums=1)
jcmix = jax.jit(_jb.rwkv_cmix, static_argnums=1)
DIMS = _jb.RWKVDims(d_model=64, n_heads=4, d_ff=128)
TDIMS = tb.RWKVDims(d_model=64, n_heads=4, d_ff=128)


def _wkv_inputs(shape, seed=0, decay=-3.0, with_s0=False):
    """r, k, v ~ 0.5 N; w = exp(-exp(decay + 0.5 N)); u ~ 0.1 N; s0 ~ 0.1 N,
    as float32 numpy arrays."""
    b, s, h, hd = shape
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal(shape, np.float32) for _ in "rkv")
    w = np.exp(-np.exp(decay + 0.5 * rng.standard_normal(shape, np.float32)))
    u = 0.1 * rng.standard_normal((h, hd), np.float32)
    s0 = (0.1 * rng.standard_normal((b, h, hd, hd), np.float32)
          if with_s0 else None)
    return r, k, v, w.astype(np.float32), u, s0


def _both(arrs):
    jx = tuple(None if a is None else jnp.asarray(a) for a in arrs)
    tx = tuple(None if a is None else torch.from_numpy(a) for a in arrs)
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


# ---------------------------------------------------------------------------
# Kernel level: the plain twin against the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 128, 2, 32), (2, 256, 4, 64),
                                   (4, 1, 40, 64)])   # RWKV6-3B decode step
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_plain_vs_jax_ref(shape, with_s0):
    (jr, jk, jv, jw, ju, js0), t = _both(_wkv_inputs(shape, seed=0,
                                                     with_s0=with_s0))
    want_y, want_s = jwkv6_ref(jr, jk, jv, jw, ju, js0)
    got_y, got_s = wkv.wkv6_plain(*t)
    assert got_y.dtype == got_s.dtype == torch.float32
    _close(got_y, want_y, 1e-4)
    _close(got_s, want_s, 1e-4)


def test_wkv6_state_carry_composition():
    """Two halves with the carried state == one run, and both agree with
    the JAX oracle's run over the whole."""
    arrs = _wkv_inputs((1, 128, 2, 32), seed=1)
    (jr, jk, jv, jw, ju, _), (r, k, v, w, u, _) = _both(arrs)
    y_all, s_all = wkv.wkv6_plain(r, k, v, w, u)
    y1, s1 = wkv.wkv6_plain(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u)
    y2, s2 = wkv.wkv6_plain(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u,
                            s1)
    _close(torch.cat([y1, y2], 1), y_all.numpy(), 1e-5)
    _close(s2, s_all.numpy(), 1e-5)
    want_y, want_s = jwkv6_ref(jr, jk, jv, jw, ju)
    _close(y_all, want_y, 1e-4)
    _close(s_all, want_s, 1e-4)


def _misaligned(t, pad=1):
    """`t` (B,S,H,hd) copied into a view of a wider buffer whose base sits
    one element in and whose token stride is H*hd + pad elements: the
    layout that takes the CUDA kernel's 4-byte copy path."""
    b, s, h, hd = t.shape
    ts = h * hd + pad
    view = torch.zeros(1 + b * s * ts).as_strided(t.shape, (s * ts, ts, hd, 1),
                                                  1)
    return view.copy_(t)


def test_wkv6_plain_reads_misaligned_view():
    arrs = _wkv_inputs((2, 77, 3, 64), seed=3, with_s0=True)
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _both(arrs)
    views = [_misaligned(t) for t in (r, k, v, w)]
    assert wkv.copy_bytes(*views) == 4 and wkv.copy_bytes(r, k, v, w) == 16
    want_y, want_s = jwkv6_ref(jr, jk, jv, jw, ju, js0)
    got_y, got_s = wkv.wkv6_plain(*views, u, s0)
    _close(got_y, want_y, 1e-4)
    _close(got_s, want_s, 1e-4)


def _tpu_chunk_form(r, k, v, w, u, chunk):
    """numpy emulation, in fp32, of the arithmetic of the Pallas
    `_wkv_kernel` (src/repro/kernels/rwkv6.py:25): per-chunk cumulative
    log-decay with r and k scaled by exp(-/+ (cum - cum[C/2]))."""
    s_len, hd = r.shape
    state = np.zeros((hd, hd), np.float32)
    ys = []
    with np.errstate(over="ignore", invalid="ignore"):
        for c0 in range(0, s_len, chunk):
            rr, kk, vv, ww = (a[c0:c0 + chunk] for a in (r, k, v, w))
            logw = np.log(np.maximum(ww, np.float32(1e-30)))
            cum = np.cumsum(logw, axis=0, dtype=np.float32)
            cum_ex = cum - logw
            y_state = (rr * np.exp(cum_ex)) @ state
            c_mid = cum[chunk // 2][None, :]
            att = (rr * np.exp(cum_ex - c_mid)) @ (kk * np.exp(c_mid - cum)).T
            att = np.tril(att, -1)
            bonus = np.sum(rr * u[None] * kk, axis=1, keepdims=True) * vv
            ys.append(y_state + att @ vv + bonus)
            state = (np.exp(cum[-1])[:, None] * state
                     + (kk * np.exp(cum[-1:] - cum)).T @ vv)
    return np.concatenate(ys)


def test_wkv6_strong_decay_stays_finite():
    """w = exp(-exp(2 + 0.5 N)), the decays of trained RWKV6 channels:
    the plain twin stays finite and within 1e-4 of the JAX oracle, where
    the TPU kernel's mid-chunk normalisation overflows fp32 (R6)."""
    arrs = _wkv_inputs((1, 256, 2, 64), seed=2, decay=2.0)
    (jr, jk, jv, jw, ju, _), t = _both(arrs)
    want_y, want_s = jwkv6_ref(jr, jk, jv, jw, ju)
    got_y, got_s = wkv.wkv6_plain(*t)
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    _close(got_y, want_y, 1e-4)
    _close(got_s, want_s, 1e-4)
    r, k, v, w, u, _ = arrs
    tpu = _tpu_chunk_form(r[0, :, 0], k[0, :, 0], v[0, :, 0], w[0, :, 0],
                          u[0], chunk=128)
    assert not np.isfinite(tpu).all()


def _spy(monkeypatch, module, name):
    calls, fn = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_rwkv_mix_dispatch_on_cpu(monkeypatch):
    calls = _spy(monkeypatch, ref, "wkv6_ref")
    (jr, jk, jv, jw, ju, js0), (r, k, v, w, u, s0) = _both(
        _wkv_inputs((2, 16, 2, 16), seed=3, with_s0=True))
    y, s = ops.rwkv_mix(r, k, v, w, u, s0=s0)
    want_y, want_s = jwkv6_ref(jr, jk, jv, jw, ju, js0)
    _close(y, want_y, 1e-4)
    _close(s, want_s, 1e-4)
    assert calls == ["wkv6_ref"]
    y2, _ = wkv.wkv6(r, k, v, w, u, s0)          # CPU tensor: plain twin
    assert torch.equal(y, y2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rwkv_mix(r, k, v, w, u, force="kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.rwkv_mix(r, k, v, w, u, force="pallas")
    assert wkv.wkv6.launches == 0


# ---------------------------------------------------------------------------
# Block level
# ---------------------------------------------------------------------------


def _draw_leaves(tree, seed):
    """The JAX params with `bonus`, `w0` and every `mu*` leaf redrawn from
    numpy: bonus ~ 0.5 N, w0 ~ U(-6, -1), mu ~ U(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == "bonus":
            return jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype)
        if name == "w0":
            return jnp.asarray(rng.uniform(-6.0, -1.0, a.shape), a.dtype)
        if name.startswith("mu"):
            return jnp.asarray(rng.uniform(0.0, 1.0, a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _bf16_matmul_weights(tree):
    """JAX params with the leaves the port stores in bf16 rounded to bf16
    and back (the fp32 leaves untouched), so fp32 activations multiply the
    same values on both sides."""
    def leaf(path, a):
        name = path[-1].key
        return (a if name in ("scale", "w0", "w_lora_a", "w_lora_b", "bonus")
                else a.astype(jnp.bfloat16).astype(a.dtype))
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _port(tree):
    return params_from_jax({"p": jax.tree.map(np.asarray, tree)},
                           device="cpu")["p"]


JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _x_and_state(dtype, with_state, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(JD[dtype]), torch.from_numpy(x).to(TD[dtype])
    if not with_state:
        return jx, tx, None, None
    last = rng.standard_normal((2, 64)).astype(np.float32)
    s = (0.1 * rng.standard_normal((2, 4, 16, 16))).astype(np.float32)
    js = {"last_x": jnp.asarray(last).astype(jnp.bfloat16),
          "s": jnp.asarray(s).astype(jnp.bfloat16)}
    ts = {"last_x": torch.from_numpy(last).to(torch.bfloat16),
          "s": torch.from_numpy(s).to(torch.bfloat16)}
    return jx, tx, js, ts


@pytest.mark.parametrize("dtype", list(JD))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_tmix_matches_jax(dtype, with_state):
    jp = _bf16_matmul_weights(_draw_leaves(
        jax.jit(_jb.init_rwkv_tmix, static_argnums=1)(
            jax.random.PRNGKey(0), DIMS), seed=4))
    tp = _port(jp)
    jx, tx, js, ts = _x_and_state(dtype, with_state, seed=5)
    want, jstate = jtmix(jp, DIMS, jx, state=js)
    got, tstate = tb.rwkv_tmix(tp, TDIMS, tx, state=ts)
    assert got.dtype == TD[dtype]
    assert _rel(got, want) <= BLOCK_TOL[dtype]
    for name in ("last_x", "s"):
        assert tstate[name].dtype == torch.bfloat16
        assert _rel(tstate[name], jstate[name].astype(jnp.float32)) <= 1e-2


@pytest.mark.parametrize("dtype", list(JD))
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_cmix_matches_jax(dtype, with_state):
    jp = _bf16_matmul_weights(_draw_leaves(
        jax.jit(_jb.init_rwkv_cmix, static_argnums=1)(
            jax.random.PRNGKey(1), DIMS), seed=6))
    tp = _port(jp)
    jx, tx, js, ts = _x_and_state(dtype, with_state, seed=7)
    js = None if js is None else {"last_x": js["last_x"]}
    ts = None if ts is None else {"last_x": ts["last_x"]}
    want, jstate = jcmix(jp, DIMS, jx, state=js)
    got, tstate = tb.rwkv_cmix(tp, TDIMS, tx, state=ts)
    assert _rel(got, want) <= BLOCK_TOL[dtype]
    assert torch.equal(tstate["last_x"].float(), torch.from_numpy(
        np.array(jstate["last_x"].astype(jnp.float32))))


def test_params_from_jax_keeps_fp32_leaves_exact():
    jp = _draw_leaves(jax.jit(_jb.init_rwkv_tmix, static_argnums=1)(
        jax.random.PRNGKey(2), DIMS), seed=8)
    tp = _port(jp)
    for name in ("w0", "w_lora_a", "w_lora_b", "bonus"):
        assert tp[name].dtype == torch.float32, name
        assert np.array_equal(tp[name].numpy(), np.asarray(jp[name])), name
    for name in ("wr", "mu_r", "wo"):
        assert tp[name].dtype == torch.bfloat16, name
    assert tp["ln_out"]["scale"].dtype == torch.float32


def test_port_init_keeps_fp32_leaves():
    tp = tb.init_rwkv_tmix(torch.Generator("cpu").manual_seed(0), TDIMS)
    jp = _port(jax.jit(_jb.init_rwkv_tmix, static_argnums=1)(
        jax.random.PRNGKey(0), DIMS))
    for name, t in tp.items():
        if isinstance(t, dict):
            continue
        assert t.dtype == jp[name].dtype and t.shape == jp[name].shape, name


# ---------------------------------------------------------------------------
# Model level: rwkv6-3b-smoke
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, JAX params, port model, port params), read-only."""
    jm = jlm.build(jconfigs.get(ARCH, reduced=True))
    jp = _draw_leaves(jax.jit(jm.init)(jax.random.PRNGKey(0)), seed=9)
    tm = tlm.build(tconfigs.get(ARCH, reduced=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_build_accepts_rwkv():
    model = tlm.build(tconfigs.get(ARCH))
    assert [(s.kind, s.count) for s in model.plan] == [("rwkv", 32)]
    dims = tlm.rwkv_dims(model.cfg)
    assert (dims.head_dim, dims.n_heads, dims.d_ff) == (64, 40, 8960)


def test_smoke_forward_matches_jax():
    jm, jp, tm, tp = _models()
    tokens = _tokens((2, 24), tm.cfg.vocab)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-2


def test_prefill_and_decode_match_jax_with_state():
    """Prefill then teacher-forced decode: logits at every step, and the
    cache's bf16 WKV state and `last_x`s after each call.  Layer 0 sees
    the same inputs on both sides, so its state is held to one bf16 step
    (1e-2); later layers read activations that already differ by bf16
    rounding (the 2e-2 logits bar), so their state is held to 2e-2."""
    jm, jp, tm, tp = _models()
    b, s, pre = 2, 14, 8
    tokens = _tokens((b, s), tm.cfg.vocab, seed=2)
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache)
    tcache = tm.init_cache(b, s, "cpu")
    tt = torch.from_numpy(tokens)
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache), jlogits) <= 2e-2

    def check_state():
        for j, layer in enumerate(tcache["seg0"]):
            for part, name in (("tmix", "s"), ("tmix", "last_x"),
                               ("cmix", "last_x")):
                got = layer[part][name]
                assert got.dtype == torch.bfloat16
                want = jcache["seg0"][part][name][j].astype(jnp.float32)
                assert _rel(got, want) <= (1e-2 if j == 0 else 2e-2), (
                    j, part, name)
    check_state()
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert _rel(got, jlogits) <= 3e-2, i
        check_state()
    assert wkv.wkv6.launches == 0


def test_serve_main_rwkv_on_cpu():
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
