"""The MLA-layout flash backward's fused form on the CPU: k's whole
gradient, dK + [dV, 0], where v is a view of k's first 512 features (as
`mla_attention` passes k_eff[..., :512]).

Inputs come from a numpy seed.  Bars:
  * the plain twin `ref.flash_attention_bwd_plain(..., dv_into_dk=True)`,
    the CPU path of `flash_attention_bwd(..., dv_into_dk=True)`, against
    `jax.vjp` of the reference's `flash_attention_ref` taking k once (v its
    first 512 features), in fp32: dq and k's gradient within 1e-5 of
    max(max |want|, 1) (at one key dq and dk cancel to rounding residues);
  * `FlashAttention.apply` with v a view of k: no gradient reaches v (a
    hook on it sees none) and k's gradient, the fused one, equals the
    twin's unfused dk + [dv, 0] (1e-6 relative: the same arithmetic);
  * `fa.mla_bwd_kernel`, the rule the backward follows on CUDA tensors at
    the MLA layout, on CPU tensors (it reads shapes, strides and storage
    only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

SCALE = 192 ** -0.5   # DeepSeek-V3's qk_dim ** -0.5


def _inputs(b, sq, skv, h, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, 576)).astype(np.float32),
            rng.standard_normal((b, skv, 1, 576)).astype(np.float32),
            rng.standard_normal((b, sq, h, 512)).astype(np.float32))


def _rel(got, want, floor=1.0):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(floor, np.abs(want).max()))


@pytest.mark.parametrize("b,sq,skv,h,q_offset", [
    (2, 70, 90, 3, 20), (1, 1, 1, 1, 0), (1, 129, 129, 20, 0),
    (2, 65, 191, 3, 126)])
def test_plain_twin_dv_into_dk_matches_jax(b, sq, skv, h, q_offset):
    """The fused backward's plain twin against `jax.vjp` of the reference
    with k taken once (its view as v differentiated through)."""
    q, k, do = _inputs(b, sq, skv, h)
    block = min(512, skv)
    jfn = jax.jit(lambda a, c: jref.flash_attention_ref(
        a, c, c[..., :512], block, True, None, q_offset, SCALE))
    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k))
    want_dq, want_dk = vjp(jnp.asarray(do))
    tq, tk, tdo = (torch.from_numpy(t) for t in (q, k, do))
    tv = tk[..., :512]
    assert fa.is_mla(tq, tk, tv) and fa.v_in_k(tk, tv)
    kw = dict(causal=True, q_offset=q_offset, scale=SCALE)
    out, lse = fa.flash_attention_fwd(tq, tk, tv, want_lse=True, **kw)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tv, out, tdo, lse,
                                        dv_into_dk=True, **kw)
    assert dv is None and dk.shape == tk.shape
    assert _rel(dq, want_dq) <= 1e-5
    assert _rel(dk, want_dk) <= 1e-5
    # the same sum as the unfused twin's dk + [dv, 0]
    _, dk_apart, dv_apart = ref.flash_attention_bwd_plain(
        tq, tk, tv, out, tdo, lse, block, True, None, q_offset, SCALE)
    dk_apart[..., :512] += dv_apart
    assert _rel(dk, dk_apart.numpy(), floor=1e-30) <= 1e-6


def test_flash_attention_gives_v_no_gradient_where_v_is_a_view_of_k():
    """`FlashAttention.apply` on CPU tensors, v = k[..., :512]: the
    backward returns k's whole gradient and None for v, so autograd sends
    nothing through the view (a hook on v sees no tensor), and k's gradient
    is the unfused one's dk + [dv, 0]."""
    q0, k0, do0 = _inputs(2, 70, 90, 3, seed=1)
    q = torch.from_numpy(q0).requires_grad_()
    k = torch.from_numpy(k0).requires_grad_()
    v = k[..., :512]
    reached = []
    v.register_hook(lambda g: reached.append(g is not None))
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    out = fa.FlashAttention.apply(q, k, v, True, None, 20, SCALE, True)
    out.backward(torch.from_numpy(do0))
    assert not any(reached)
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_mla) == before
    tq, tk = torch.from_numpy(q0), torch.from_numpy(k0)
    kw = dict(causal=True, q_offset=20, scale=SCALE)
    o, lse = fa.flash_attention_fwd(tq, tk, tk[..., :512], want_lse=True,
                                    **kw)
    dq, dk, dv = fa.flash_attention_bwd(tq, tk, tk[..., :512], o,
                                        torch.from_numpy(do0), lse, **kw)
    dk[..., :512] += dv
    assert _rel(q.grad, dq.numpy(), floor=1e-30) <= 1e-6
    assert _rel(k.grad, dk.numpy(), floor=1e-30) <= 1e-6


@pytest.mark.parametrize("v_of", ["copy", "tail", "other"])
def test_dv_into_dk_needs_v_a_view_of_k(v_of):
    """`dv_into_dk` is refused where v is not k's first 512 features: a
    copy of them, k's last 512, or a tensor of its own."""
    q0, k0, do0 = _inputs(1, 9, 9, 3)
    q, k, do = (torch.from_numpy(t) for t in (q0, k0, do0))
    v = {"copy": k[..., :512].clone(), "tail": k[..., 64:],
         "other": torch.zeros(1, 9, 1, 512)}[v_of]
    out, lse = fa.flash_attention_fwd(q, k, v, want_lse=True)
    with pytest.raises(ValueError, match="dv_into_dk"):
        fa.flash_attention_bwd(q, k, v, out, do, lse, dv_into_dk=True)


def _dispatch_case(name):
    """(q, k, v, do) on the CPU for a `test_mla_bwd_kernel_dispatch` case."""
    dtype = torch.float32 if name.startswith("fp32") else torch.bfloat16
    q = torch.zeros(2, 6, 3, 576, dtype=dtype)
    k = torch.zeros(2, 9, 1, 576, dtype=dtype)
    v = torch.zeros(2, 9, 1, 512, dtype=dtype)
    do = torch.zeros(2, 6, 3, 512, dtype=dtype)
    outer = do.transpose(1, 2).contiguous().transpose(1, 2)
    q_outer = q.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros(2, 6, 6, 512, dtype=dtype)
    return {
        "fp32": (q, k, v, do),
        "fp32_view": (q, k, k[..., :512], do),
        "fp32_do_heads_outer": (q, k, v, outer),
        "bf16": (q, k, v, do),
        "bf16_view": (q, k, k[..., :512], do),
        "bf16_tail_view": (q, k, k[..., 64:], do),
        "bf16_do_every_other_head": (q, k, v, wide[:, :, ::2]),
        "bf16_one_position": (q_outer[:, :1], k, v, outer[:, :1]),
        "bf16_q_heads_outer": (q_outer, k, v, do),
        "bf16_do_heads_outer": (q, k, k[..., :512], outer),
        "bf16_do_every_other_position": (q[:, ::2], k, v, do[:, ::2]),
    }[name]


@pytest.mark.parametrize("name,want", [
    ("fp32", "simt"), ("fp32_view", "simt"), ("fp32_do_heads_outer", "simt"),
    ("bf16", "wgmma"), ("bf16_view", "wgmma_kv"), ("bf16_tail_view", "wgmma"),
    ("bf16_do_every_other_head", "wgmma"), ("bf16_one_position", "wgmma"),
    ("bf16_q_heads_outer", ValueError), ("bf16_do_heads_outer", ValueError),
    ("bf16_do_every_other_position", ValueError)])
def test_mla_bwd_kernel_dispatch(name, want):
    """`fa.mla_bwd_kernel`: float32 takes the SIMT kernels whatever its
    strides; bfloat16 the wgmma kernels, reading V from the K tiles only
    where v is k's first 512 features; a bf16 q or do whose position stride
    is not H times its head stride raises (one position has a single row
    stride)."""
    q, k, v, do = _dispatch_case(name)
    assert fa.is_mla(q, k, v)
    if want is ValueError:
        with pytest.raises(ValueError, match="position stride"):
            fa.mla_bwd_kernel(q, k, v, do)
    else:
        assert fa.mla_bwd_kernel(q, k, v, do) == want
