"""The flash kernel's plain twin against the JAX oracle where the bf16
kernel's tiles end.

`flash_attention_plain` is what the CUDA kernel is held against on the card
(tests/test_torch_cuda.py, chip_smoke.py), so it must be right at the edges
of the kernel's 128-row q tiles and 64 / 128-key kv tiles: lengths of 1,
127, 129 and 255, Sq < Skv with a q_offset, a window that ends inside a
tile, Skv below one kv tile, hd 128 and 256 (Gemma-7B's heads, the wgmma
kernel without a producer warpgroup) and a non-default scale.  Inputs come
from a numpy seed and go to both frameworks; fp32 at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as _jref
from repro_torch.kernels import flash_attention as fa

naive = jax.jit(_jref.naive_attention,
                static_argnames=("causal", "window", "q_offset", "scale"))

# (causal, window, q_offset, scale, Sq, Skv), as test_torch_cuda.py's edges
EDGES = [
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


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", EDGES)
def test_plain_twin_matches_jax_at_tile_edges(causal, window, q_offset,
                                              scale, sq, skv, hd):
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v = (rng.standard_normal((2, s, 3, hd)).astype(np.float32)
               for s in (sq, skv, skv))
    want = naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window, q_offset=q_offset,
                 scale=scale)
    got = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_offset=q_offset, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
