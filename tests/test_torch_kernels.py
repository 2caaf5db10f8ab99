"""The port's attention oracles and dispatch against the JAX package's.

Inputs come from a numpy seed and go to both frameworks.  The JAX side is
`repro.kernels.ref` (what `repro.kernels.ops.attention` runs off the TPU;
the Pallas kernel itself needs `pl.load`, which JAX 0.9 no longer has).
The CUDA kernel runs only on a GPU: see tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as _jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


class jref:
    """The JAX oracles, jitted: one compile per shape instead of one per
    primitive keeps this file fast on the CPU."""
    naive_attention = jax.jit(_jref.naive_attention, static_argnames=(
        "causal", "window", "q_offset", "scale"))
    flash_attention_ref = jax.jit(_jref.flash_attention_ref,
                                  static_argnums=(3, 4, 5, 6, 7))

SHAPES = [  # (B, S, H, hd), as tests/test_kernels.py
    (1, 128, 1, 64),
    (2, 256, 4, 64),
    (1, 512, 2, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MASKS = [(True, None), (False, None), (True, 128)]


def _qkv(shape, dtype, seed=0, kv_len=None):
    """fp32 normals from numpy, rounded to `dtype` once, as (jax, torch)."""
    rng = np.random.default_rng(seed)
    kshape = shape if kv_len is None else (shape[0], kv_len, *shape[2:])
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape, kshape, kshape)]
    jd, td, _ = DTYPES[dtype]
    jx = tuple(jnp.asarray(a).astype(jd) for a in arrs)
    tx = tuple(torch.from_numpy(a).to(td) for a in arrs)
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_flash_vs_jax_oracles(shape, dtype, causal, window):
    (jq, jk, jv), (q, k, v) = _qkv(shape, dtype)
    tol = DTYPES[dtype][2]
    want = jref.naive_attention(jq, jk, jv, causal=causal, window=window)
    got = ref.flash_attention_ref(q, k, v, 64, causal, window)
    _close(got, want, tol)
    _close(got, jref.flash_attention_ref(jq, jk, jv, 64, causal, window,
                                         0, None), tol)
    _close(ref.naive_attention(q, k, v, causal=causal, window=window), want,
           tol)


def test_q_offset_matches_jax():
    """Second half of the queries against the full kv, positioned by
    q_offset (chunked-prefill continuation)."""
    (jq, jk, jv), (q, k, v) = _qkv((1, 256, 2, 64), "float32", seed=5)
    want = jref.flash_attention_ref(jq[:, 128:], jk, jv, 64, True, None,
                                    128, None)
    _close(ref.flash_attention_ref(q[:, 128:], k, v, 64, True, None, 128),
           want, 1e-5)
    _close(ref.naive_attention(q[:, 128:], k, v, q_offset=128), want, 1e-5)


@pytest.mark.parametrize("impl", ["naive", "plain"])
def test_non_default_scale(impl):
    (jq, jk, jv), (q, k, v) = _qkv((2, 256, 4, 64), "float32", seed=2)
    want = jref.naive_attention(jq, jk, jv, causal=True, scale=0.3)
    _close(ops.attention(q, k, v, scale=0.3, force=impl), want, 2e-5)


def _spy(monkeypatch, module, name):
    """Record the calls that reach module.name."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_dispatch_below_threshold_is_naive(monkeypatch):
    calls = _spy(monkeypatch, ref, "naive_attention")
    (jq, jk, jv), (q, k, v) = _qkv((1, 300, 2, 64), "bfloat16", seed=3)
    _close(ops.attention(q, k, v), jref.naive_attention(jq, jk, jv), 2e-2)
    assert calls == ["naive_attention"]


def test_dispatch_at_threshold_is_plain_flash_on_cpu(monkeypatch):
    calls = _spy(monkeypatch, fa, "flash_attention_plain")
    shape = (1, ops.FLASH_THRESHOLD, 1, 64)
    (jq, jk, jv), (q, k, v) = _qkv(shape, "float32", seed=4)
    _close(ops.attention(q, k, v), jref.flash_attention_ref(
        jq, jk, jv, 512, True, None, 0, None), 2e-5)
    assert calls == ["flash_attention_plain"]


def test_ragged_kv_tail_kept_where_jax_ref_drops_it():
    """Reference fault R5: `repro.kernels.ref._flash_fwd` walks
    `skv // block_k` blocks, so at S = 2100 `ops.attention` (block_k 512)
    drops keys 2048..2099.  The port walks the ragged tail."""
    s = 2100
    (jq, jk, jv), (q, k, v) = _qkv((1, s, 1, 64), "float32", seed=6)
    want = jref.naive_attention(jq, jk, jv)
    _close(ops.attention(q, k, v), want, 2e-5)
    _close(ref.flash_attention_ref(q, k, v, 512), want, 2e-5)
    jax_flash = np.asarray(jref.flash_attention_ref(jq, jk, jv, 512, True,
                                                    None, 0, None))
    err = np.abs(jax_flash - np.asarray(want))
    assert err[:, :2048].max() < 2e-5 and err[:, 2048:].max() > 1e-3


def test_launch_counter_stays_zero_on_cpu():
    (_, _, _), (q, k, v) = _qkv((1, ops.FLASH_THRESHOLD, 1, 64), "bfloat16")
    before = fa.flash_attention.launches
    ops.attention(q, k, v)
    fa.flash_attention(q[:, :64], k[:, :64], v[:, :64])
    assert fa.flash_attention.launches == before == 0


def test_force_kernel_on_cpu_raises():
    (_, _, _), (q, k, v) = _qkv((1, 128, 1, 64), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="not in"):
        ops.attention(q, k, v, force="pallas")
