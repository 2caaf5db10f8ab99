"""The port's layers against `repro.models.layers` on the same inputs.

Params come from the JAX `init_*` functions and cross with
`repro_torch.convert.params_from_jax`, which stores matmul weights in bf16.
For fp32 activations the JAX side is handed the same bf16-rounded weights,
so both sides multiply the same values.  Tolerances: 1e-5 for fp32 inputs,
2e-2 (relative to the largest magnitude) for bf16 paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as _jl
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tl



class jl:
    """The JAX layers, jitted: one compile per call site instead of one
    per primitive keeps this file fast on the CPU."""
    AttnDims = _jl.AttnDims
    init_kv_cache = _jl.init_kv_cache
    init_mlp = jax.jit(_jl.init_mlp, static_argnums=(1, 2))
    init_embed = jax.jit(_jl.init_embed, static_argnums=(1, 2),
                         static_argnames="tied")
    init_attention = jax.jit(_jl.init_attention, static_argnums=1)
    rmsnorm = jax.jit(_jl.rmsnorm)
    apply_rope = jax.jit(_jl.apply_rope, static_argnums=2)
    mlp = jax.jit(_jl.mlp, static_argnums=2)
    embed = jax.jit(_jl.embed, static_argnums=2)
    unembed = jax.jit(_jl.unembed, static_argnames="cap")
    attention = jax.jit(_jl.attention, static_argnums=1,
                        static_argnames="cache_index")


JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@jax.jit
def _bf16_rounded(tree):
    """JAX params with every matmul weight rounded to bf16 and back."""
    def leaf(path, a):
        name = path[-1].key
        return a if name == "scale" else a.astype(jnp.bfloat16).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _port(tree):
    return params_from_jax({"p": jax.tree.map(np.asarray, tree)},
                           device="cpu")["p"]


def _x(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JD[dtype]), torch.from_numpy(a).to(TD[dtype])


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / max(1e-6, np.abs(want).max())
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    jx, tx = _x((2, 5, 32), dtype)
    scale = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    got = tl.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert got.dtype == TD[dtype]
    _check(got, jl.rmsnorm({"scale": jnp.asarray(scale)}, jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    jx, tx = _x((2, 7, 3, 16), dtype)
    pos = np.arange(7)[None, :] + 5
    got = tl.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    _check(got, jl.apply_rope(jx, jnp.asarray(pos), 10000.0), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp(dtype, activation):
    jp = _bf16_rounded(jl.init_mlp(jax.random.PRNGKey(0), 32, 64))
    jx, tx = _x((2, 5, 32), dtype, seed=2)
    _check(tl.mlp(_port(jp), tx, activation),
           jl.mlp(jp, jx, activation), dtype)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied):
    jp = jl.init_embed(jax.random.PRNGKey(1), 50, 32, tied=tied)
    tp = _port(jp)
    tokens = np.random.default_rng(3).integers(0, 50, (2, 6))
    jx = jl.embed(jp, jnp.asarray(tokens), 1.5)
    tx = tl.embed(tp, torch.from_numpy(tokens), 1.5)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx, np.float32))
    got = tl.unembed(tp, tx, cap=4.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.unembed(
        jp, jx, cap=4.0)), rtol=1e-5, atol=1e-5)


def _attn_setup(dtype, qk_norm=False, seed=4):
    dims = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                qk_norm=qk_norm)
    jdims, tdims = jl.AttnDims(**dims), tl.AttnDims(**dims)
    jp = _bf16_rounded(jl.init_attention(jax.random.PRNGKey(seed), jdims))
    return jdims, tdims, jp, _port(jp)


@pytest.mark.parametrize("dtype,qk_norm", [("float32", False),
                                           ("float32", True),
                                           ("bfloat16", False)])
def test_attention_prefill_fills_cache(dtype, qk_norm):
    jdims, tdims, jp, tp = _attn_setup(dtype, qk_norm)
    b, s, max_seq = 2, 12, 16
    jx, tx = _x((b, s, 32), dtype, seed=5)
    pos = np.arange(s)[None, :]
    jcache = jl.init_kv_cache(b, max_seq, jdims)
    tcache = tl.init_kv_cache(b, max_seq, tdims, "cpu")
    jout, jcache = jl.attention(jp, jdims, jx, jnp.asarray(pos),
                                kv_cache=jcache, cache_index=0)
    tout = tl.attention(tp, tdims, tx, torch.from_numpy(pos),
                        kv_cache=tcache, cache_index=0)
    _check(tout, jout, dtype)
    for name in ("k", "v"):
        _check(tcache[name], jcache[name], "bfloat16")


def test_attention_decode_step():
    jdims, tdims, jp, tp = _attn_setup("bfloat16", seed=6)
    b, s, max_seq = 2, 9, 16
    jx, tx = _x((b, s + 1, 32), "bfloat16", seed=7)
    jcache = jl.init_kv_cache(b, max_seq, jdims)
    tcache = tl.init_kv_cache(b, max_seq, tdims, "cpu")
    pos = np.arange(s)[None, :]
    _, jcache = jl.attention(jp, jdims, jx[:, :s], jnp.asarray(pos),
                             kv_cache=jcache, cache_index=0)
    tl.attention(tp, tdims, tx[:, :s], torch.from_numpy(pos),
                 kv_cache=tcache, cache_index=0)
    step = np.array([[s]])
    jout, jcache = jl.attention(jp, jdims, jx[:, s:], jnp.asarray(step),
                                kv_cache=jcache, cache_index=s)
    tout = tl.attention(tp, tdims, tx[:, s:], torch.from_numpy(step),
                        kv_cache=tcache, cache_index=s)
    _check(tout, jout, "bfloat16")
    _check(tcache["k"], jcache["k"], "bfloat16")


def test_ring_buffer_cache_not_ported():
    """The sliding-window cache's layout against `init_kv_cache` of the JAX
    package: a window shorter than the cache gives a ring of `window`
    slots with an int32 pos of -1 (unwritten); a window as long as the
    cache gives a plain cache of max_seq slots and no pos."""
    dims = tl.AttnDims(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                       window=8)
    for max_seq in (16, 8):
        got = tl.init_kv_cache(1, max_seq, dims, "cpu")
        want = jl.init_kv_cache(1, max_seq, jl.AttnDims(
            d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, window=8))
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].shape == want[key].shape, key
            assert np.array_equal(got[key].float().numpy(),
                                  np.asarray(want[key], np.float32)), key
    ring = tl.init_kv_cache(1, 16, dims, "cpu")
    assert ring["k"].shape == (1, 8, 2, 16)
    assert ring["pos"].dtype == torch.int32 and (ring["pos"] == -1).all()
    assert tl.init_kv_cache(1, 8, dims, "cpu")["k"].shape == (1, 8, 2, 16)
