"""The flash backward's plain twin against `jax.vjp` of the JAX reference
where the backward kernel's tiles end.

`ref.flash_attention_bwd_plain` (reached through `FlashAttention` on CPU
tensors) is what the CUDA backward kernels are held against on the card
(tests/test_torch_cuda.py, chip_smoke.py), so it must match the reference's
custom VJP at the edges of the bf16 kernels' tiles: the dK / dV kernel's
128-row (hd 64) or 64-row (hd 128, 256) q steps and 128-key (64 at hd 256)
tiles, the dQ kernel's 128-row q tiles and 64-key tiles.  Sq and Skv take
63, 64, 65, 127, 128 and 129, then 192 (three q steps: the hd-256 kernel's
two-stage ring wraps) and 257 (five 64-key tiles and one key: its dQ
kernel's rings of two K stages and one V stage wrap), with causal masks
shifted by q_offset, windows that end inside a tile, and rows that see no
key (dO is zero on those rows, as chip_smoke.py makes it: there the
reference's -1e30 arithmetic and the kernel differ by design).  Skv stays
<= 512, so the reference's block_k = min(512, Skv) is one whole block.
Inputs come from a numpy seed and go to both frameworks; fp32, each
gradient within 2e-5 of the reference relative to max(max |want|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as _jref
from repro_torch.kernels import flash_attention as fa

TOL = 2e-5

# (causal, window, q_offset, scale, Sq, Skv), as chip_smoke.py's BWD_EDGES
EDGES = [
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


def _seen(sq, skv, causal, window, q_offset):
    """(Sq,) bool: the query rows that see at least one key."""
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(skv)[None, :]
    vis = np.ones((sq, skv), bool)
    if causal:
        vis &= q_pos >= k_pos
    if window is not None:
        vis &= q_pos - k_pos < window
    return vis.any(axis=1)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,window,q_offset,scale,sq,skv", EDGES)
def test_plain_backward_matches_jax_vjp_at_tile_edges(causal, window,
                                                      q_offset, scale, sq,
                                                      skv, hd):
    rng = np.random.default_rng(sq * 1000 + skv + hd)
    q, do = (rng.standard_normal((2, sq, 3, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, skv, 3, hd)).astype(np.float32)
            for _ in range(2))
    seen = _seen(sq, skv, causal, window, q_offset)
    if window is not None and window < 64:
        assert not seen.all()   # the case has rows that see no key
    do *= seen[None, :, None, None]

    def jfn(a, b, c):
        return _jref.flash_attention_ref(a, b, c, min(512, skv), causal,
                                         window, q_offset, scale)
    jout, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.FlashAttention.apply(*ts, causal, window, q_offset, scale)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    for t, w in zip(ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= TOL, err
