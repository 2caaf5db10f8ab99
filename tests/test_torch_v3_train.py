"""DeepSeek-V3 training in the port against `repro.models.lm` on the CPU:
its multi-token-prediction (MTP) loss, `LM.loss` and their gradients, the
flash VJP at the MLA layout with v a view of k, and the trainer.

Inputs come from a numpy seed; params from the JAX init, carried over by
`params_from_jax` (the "mtp" subtree among them).  Bars:
  * `LM._mtp_loss` and `LM.loss` of the reduced deepseek-v3-671b (batch 2
    x 32: the naive attention branch) within 1e-5 relative of the JAX
    package's in fp32 activations (both sides' embedding gathered in
    fp32), and within tests/test_torch_moe.py's 1e-2 in the shipped bf16
    activations;
  * the loss and every gradient leaf, the MTP head's included, against
    `jax.value_and_grad(model.loss)` with tests/test_torch_train.py's
    bars: the loss within 1e-3, each leaf within 5e-2 relative L2; at
    2048 positions (batch 1: both sides' chunked flash path inside every
    MLA block, the MTP block's too) a leaf that routing moves farther
    within 1.5 x the port's naive-attention path's distance from JAX on
    that leaf, as tests/test_torch_moe.py holds the MoE; the router
    bias's gradient zero on both sides;
  * `FlashAttention` on CPU tensors at the MLA layout, v a view of k's
    first 512 features as `mla_attention` passes it: output and the q and
    k gradients (k's holding v's) equal to autograd of
    `flash_attention_plain` on the same view (the same plain arithmetic:
    1e-6 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.configs as tconfigs
from repro.models import layers as jlayers
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, make_train_step
from test_torch_train import (_batch, _check_grads, _flat, _jax_model,
                              _port_grads, _rel_l2, _stacked)

ARCH = "deepseek-v3-671b"


def _losses(jm, jp, tm, tp, shape):
    """((JAX loss, JAX MTP term), (port loss, port MTP term)) on one
    numpy-seeded batch."""
    jb, tb = _batch(jm.cfg.vocab, shape, seed=4)
    want = (float(jax.jit(jm.loss)(jp, jb)),
            float(jax.jit(jm._mtp_loss)(jp, jb["tokens"], jb["labels"])))
    got = (tm.loss(tp, tb).item(),
           tm._mtp_loss(tp, tb["tokens"], tb["labels"]).item())
    return want, got


@pytest.mark.parametrize("part", ["loss", "mtp"])
def test_mtp_loss_matches_jax_in_fp32(monkeypatch, part):
    """In fp32 activations on both sides (the embedding gathered in fp32,
    so every block, norm and product runs in fp32), the MTP term and the
    whole loss (CE + 0.01 aux + 0.3 MTP) agree to summation order."""
    monkeypatch.setattr(jlayers, "embed", functools.partial(
        jlayers.embed, dtype=jnp.float32))
    monkeypatch.setattr(tlayers, "embed", functools.partial(
        tlayers.embed, dtype=torch.float32))
    jm, jp = _jax_model(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    want, got = _losses(jm, jp, tlm.build(tconfigs.get(ARCH, reduced=True)),
                        tp, (2, 32))
    i = ["loss", "mtp"].index(part)
    assert np.isfinite(got[i]) and got[i] > 0
    assert abs(got[i] - want[i]) <= 1e-5 * abs(want[i])


def test_loss_with_mtp_matches_jax_in_bf16():
    """The shipped bf16 activations: the loss and its MTP term within the
    MoE LM's 1e-2, and the loss is the CE + 0.01 aux + 0.3 MTP sum."""
    jm, jp = _jax_model(ARCH)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    tm = tlm.build(tconfigs.get(ARCH, reduced=True))
    (jloss, jmtp), (loss, mtp) = _losses(jm, jp, tm, tp, (2, 32))
    assert abs(loss - jloss) <= 1e-2 * abs(jloss)
    assert abs(mtp - jmtp) <= 1e-2 * abs(jmtp)
    jb, tb = _batch(jm.cfg.vocab, (2, 32), seed=4)
    x, aux = tm._hidden(tp, tb["tokens"])
    ce = tlayers.cross_entropy(tm._logits(tp, x), tb["labels"])
    assert abs(loss - (ce + 0.01 * aux + 0.3 * mtp).item()) <= 1e-6 * loss


def test_loss_and_grads_match_jax():
    """`LM.loss` and its gradients (batch 2 x 32, naive attention) against
    `jax.value_and_grad(model.loss)`, every leaf of the MTP head among
    them; the router bias's gradient is zero on both sides."""
    got, want = _check_grads(ARCH, None, (2, 32))
    mtp = [name for name in want if name.startswith("/mtp/")]
    assert "/mtp/proj" in mtp and "/mtp/block/attn/wkv_a" in mtp
    assert "/mtp/ln/scale" in mtp
    for name in mtp:
        assert torch.count_nonzero(got[name]) > 0, name
    bias = [name for name in want if name.endswith("/router_bias")]
    assert bias
    for name in bias:
        assert not np.asarray(want[name]).any()
        assert not got[name].any()


def test_loss_and_grads_at_seq_2048_match_jax():
    """The reduced V3 at 2048 positions (batch 1), so both sides
    differentiate their chunked flash attention inside every MLA block,
    the MTP block's too (here `ops.attention`'s plain twin, the kernels'
    on the card): the loss within 1e-3 of `jax.value_and_grad(model.loss)`
    and every leaf within max(5e-2, 1.5 x the port's naive-attention
    path's distance from JAX on that leaf).  At 2048 tokens bf16 rounding
    sends a few tokens to other experts in one package and not the other:
    the router's gradient lies ~6.6e-2 from JAX's through the flash path
    and ~8.7e-2 through the naive path.  ~20 s here."""
    jm, jp = _jax_model(ARCH)
    jb, tb = _batch(jm.cfg.vocab, (1, 2048))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    dist = {}
    for force in (None, "naive"):
        tm = tlm.build(tconfigs.get(ARCH, reduced=True), force=force,
                       remat="none")
        loss, grads = _port_grads(tm, tp, tb)
        assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
        got = _flat(_stacked(grads))
        assert got.keys() == want.keys()
        dist[force] = {name: _rel_l2(got[name], want[name]) for name in want}
        assert not got["/seg1/ffn/router_bias"].any()
    assert any(name.startswith("/mtp/block/attn/") for name in dist[None])
    for name, d in dist[None].items():
        assert d <= max(5e-2, 1.5 * dist["naive"][name]), name


def test_flash_attention_grads_at_mla_layout_with_v_a_view_of_k():
    """`FlashAttention.apply` on CPU tensors at the MLA layout with v =
    k[..., :512] (the wrappers' plain twins, no launch): its output and
    the gradients of q and of k, into which autograd adds v's, match
    autograd of `flash_attention_plain` on the same view."""
    rng = np.random.default_rng(0)
    q0 = rng.standard_normal((2, 70, 3, 576)).astype(np.float32)
    k0 = rng.standard_normal((2, 90, 1, 576)).astype(np.float32)
    do = torch.from_numpy(rng.standard_normal((2, 70, 3, 512)).astype(
        np.float32))
    kw = dict(causal=True, q_offset=20, scale=192 ** -0.5)
    grads, outs = [], []
    before = (fa.flash_attention_bwd.launches,
              fa.flash_attention_bwd.launches_mla)
    for via in ("apply", "plain"):
        q = torch.from_numpy(q0).requires_grad_()
        k = torch.from_numpy(k0).requires_grad_()
        v = k[..., :512]
        assert fa.is_mla(q, k, v) and fa.v_in_k(k, v)
        out = (fa.FlashAttention.apply(q, k, v, True, None, 20, kw["scale"],
                                       True) if via == "apply"
               else fa.flash_attention_plain(q, k, v, **kw))
        out.backward(do)
        outs.append(out.detach())
        grads.append((q.grad, k.grad))
    assert (fa.flash_attention_bwd.launches,
            fa.flash_attention_bwd.launches_mla) == before
    assert outs[0].shape == (2, 70, 3, 512)
    assert _rel_l2(outs[0], outs[1].numpy()) <= 1e-6
    for got, want in zip(*grads):
        assert torch.count_nonzero(want[..., :512]) > 0
        assert _rel_l2(got, want.numpy()) <= 1e-6


def test_build_trainer_steps_v3_on_the_cpu():
    """`build_trainer` on the reduced V3 (MTP loss, MLA blocks, the MoE):
    two steps with finite losses that move the MTP head's params and leave
    the router bias bitwise where it was; then three steps of the same model
    at AdamW's constant 3e-4 (the shipped cosine schedule warms up over
    2000 steps, so its first steps barely move the loss): falling losses
    (each step reports the loss before its update)."""
    cfg = tconfigs.get(ARCH, reduced=True)
    model, state, step, _ = train.build_trainer(cfg, device="cpu")
    assert model.cfg.mtp and "mtp" in state.params
    proj = state.params["mtp"]["proj"].detach().clone()
    bias = state.params["seg1"][0]["ffn"]["router_bias"].detach().clone()
    _, tb = _batch(cfg.vocab, (2, 32))
    losses = []
    for fn in (step, step, *[make_train_step(model.loss, AdamWConfig())] * 3):
        state, metrics = fn(state, tb)
        losses.append(metrics["loss"].item())
    assert state.step == 5 and all(np.isfinite(losses))
    assert losses[4] < losses[3] < losses[2]
    assert not torch.equal(state.params["mtp"]["proj"], proj)
    assert torch.equal(state.params["seg1"][0]["ffn"]["router_bias"], bias)
    assert all(torch.isfinite(p).all()
               for p in pytree.tree_leaves(state.params))


def test_train_main_v3_on_the_cpu(tmp_path):
    """The train CLI at `--arch deepseek-v3-671b --reduced --device cpu`:
    two finite losses."""
    losses = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)
