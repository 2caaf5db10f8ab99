"""Qwen3-14B and MiniCPM-2B, narrow and shallow, against the JAX package on
the CPU at the flash threshold.

Two configs keep each arch's features at small width:

  * Qwen3-shaped: 2 layers, d_model 512, 10 query heads over 2 kv heads of
    128 (GQA 5 : 1, as Qwen3-14B's 40 / 8), QK-norm, rope theta 1e6, an
    untied unembedding;
  * MiniCPM-shaped: 2 layers, d_model 384, 6 heads of 64, tied embeddings,
    the depth-scaled residual 1.4 / sqrt(2).  Its name holds "minicpm",
    which is how `schedule_for` picks the WSD schedule.

Params come from the JAX `model.init` and cross with `params_from_jax`;
tokens come from a numpy seed.  At 2048 positions both sides take their
flash branch: the JAX chunked reference and its custom VJP, the port's
plain twins (the CUDA kernels run only on a GPU, tests/test_torch_cuda.py).
Bars: prefill logits within 2e-2 of the largest magnitude
(tests/test_torch_serve.py); the loss within 1e-3 relative and each
gradient leaf within 5e-2 relative L2 (tests/test_torch_train.py); the
schedules within 1e-7 relative (both fp32).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro_torch import optim as topt
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from test_torch_serve import _rel
from test_torch_train import _batch, _flat, _port_grads, _rel_l2, _stacked

SHAPED = {
    "qwen3": ("qwen3-14b", dict(
        name="qwen3-shaped-smoke", n_layers=2, d_model=512, n_heads=10,
        n_kv_heads=2, head_dim=128, d_ff=1024, vocab=512, qk_norm=True,
        rope_theta=1e6)),
    "minicpm": ("minicpm-2b", dict(
        name="minicpm-shaped-smoke", n_layers=2, d_model=384, n_heads=6,
        n_kv_heads=6, head_dim=64, d_ff=768, vocab=512,
        tied_embeddings=True, residual_scale=1.4 / math.sqrt(2))),
}
SCHEDULE_STEPS = [0, 1, 1999, 2000, 90_000, 95_000, 100_000]


def _config(package, which):
    """The shaped config `which` from `package` (the JAX or the port's
    configs), on top of its arch's reduced config."""
    arch, over = SHAPED[which]
    return dataclasses.replace(package.get(arch, reduced=True), **over)


@functools.lru_cache(maxsize=None)
def _jax_model(which):
    jm = jlm.build(_config(jconfigs, which))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def _port(which, jp, dtype=None):
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", dtype)
    return tlm.build(_config(tconfigs, which)), tp


def test_shaped_configs_keep_their_arch_features():
    q, m = _config(tconfigs, "qwen3"), _config(tconfigs, "minicpm")
    assert (q.qk_norm, q.rope_theta, q.tied_embeddings) == (True, 1e6, False)
    assert q.n_heads // q.n_kv_heads == 5 and q.head_dim == 128
    assert (m.tied_embeddings, m.n_heads, m.n_kv_heads, m.head_dim) == (
        True, 6, 6, 64)
    assert m.residual_scale == 1.4 / math.sqrt(m.n_layers)
    for which in SHAPED:
        assert repr(_config(jconfigs, which)) == repr(_config(tconfigs,
                                                              which))


@pytest.mark.parametrize("which", sorted(SHAPED))
def test_prefill_at_flash_threshold_matches_jax(which):
    """A FLASH_THRESHOLD-token prompt: both frameworks take their flash
    branch (the port's plain twin on CPU tensors: no launch); the logits
    within 2e-2 and the cache written to its last position."""
    jm, jp = _jax_model(which)
    tm, tp = _port(which, jp)
    s = ops.FLASH_THRESHOLD
    tokens = np.random.default_rng(3).integers(0, tm.cfg.vocab, (1, s))
    want, _ = jax.jit(jm.prefill)(jp, jnp.asarray(tokens),
                                  jm.init_cache(1, s))
    cache = tm.init_cache(1, s, "cpu")
    before = fa.flash_attention.launches
    got = tm.prefill(tp, torch.from_numpy(tokens), cache)
    assert _rel(got, want) <= 2e-2
    assert fa.flash_attention.launches == before
    assert cache["seg0"][-1]["kv"]["k"][:, s - 1].abs().sum() > 0


@pytest.mark.parametrize("which", sorted(SHAPED))
def test_loss_and_grads_at_seq_2048_match_jax(which):
    """`LM.loss` and every gradient leaf at (1, 2048) against
    `jax.value_and_grad(model.loss)` from the same fp32 masters: loss 1e-3
    relative, leaves 5e-2 relative L2.  Qwen3's QK-norm scales are leaves
    of their own; MiniCPM's tied table is one leaf, whose gradient sums
    the embedding's rows (the batch's tokens only) and the unembedding's
    (every row)."""
    jm, jp = _jax_model(which)
    jb, tb = _batch(jm.cfg.vocab, (1, ops.FLASH_THRESHOLD))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tm, tp = _port(which, jp, torch.float32)
    loss, grads = _port_grads(tm, tp, tb)
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(_stacked(grads))
    assert got.keys() == want.keys()
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 5e-2, name
    if which == "qwen3":
        assert {"/seg0/attn/q_norm/scale", "/seg0/attn/k_norm/scale",
                "/embed/unembed"} <= got.keys()
    else:
        assert "/embed/unembed" not in got
        table = got["/embed/table"]
        assert bool((table.abs().sum(dim=1) > 0).all())   # the unembedding
        seen = np.zeros(tm.cfg.vocab, bool)
        seen[np.asarray(jb["tokens"]).ravel()] = True
        unseen = torch.from_numpy(~seen)
        # a row the batch never embeds gets the unembedding's part alone;
        # a seen row adds the embedding's
        assert unseen.any() and bool(seen.any())
        assert _rel_l2(table[unseen], want["/embed/table"][~seen]) <= 5e-2


@pytest.mark.parametrize("which,kind", [("qwen3", "cosine"),
                                        ("minicpm", "wsd")])
def test_schedule_for_matches_the_reference(which, kind):
    """`schedule_for` picks WSD for MiniCPM (by name) and cosine for
    Qwen3, for the shaped and the published configs, equal to the
    reference's at the warmup's edges, the stable phase and the decay."""
    ref_fn = {"cosine": jsched.cosine, "wsd": jsched.wsd}[kind]
    for package_cfg in ((_config(jconfigs, which), _config(tconfigs, which)),
                        (jconfigs.get(SHAPED[which][0]),
                         tconfigs.get(SHAPED[which][0]))):
        jfn = jspecs.schedule_for(package_cfg[0])
        tfn = tspecs.schedule_for(package_cfg[1])
        assert jfn.func is ref_fn and tfn.func.__name__ == kind
        assert tfn.keywords == jfn.keywords
        for s in SCHEDULE_STEPS:
            want = float(jfn(jnp.asarray(s, jnp.int32)))
            for arg in (s, torch.tensor(s)):
                got = float(tfn(arg))
                assert abs(got - want) <= 1e-7 * abs(want), (s, got, want)


@pytest.mark.parametrize("which", sorted(SHAPED))
def test_build_trainer_step_matches_jax_with_its_schedule(which):
    """One step of `build_trainer`'s train step (batch 2 x 32) from the
    JAX init's fp32 masters against the JAX `make_train_step` with the
    reference's `schedule_for`: the loss within 1e-3, the params after the
    update as tests/test_torch_train.py::test_train_step_matches_jax holds
    them, in units of the step's LR (WSD's 1e-5 for MiniCPM, cosine's 3e-7
    for Qwen3: the other schedule's LR would move them by the wrong
    amount)."""
    jm, jp = _jax_model(which)
    jb, tb = _batch(jm.cfg.vocab, (2, 32), seed=7)
    jcfg = _config(jconfigs, which)
    jstep = jax.jit(jopt.make_train_step(
        jm.loss, jopt.AdamWConfig(schedule=jspecs.schedule_for(jcfg))))
    jstate, jmetrics = jstep(jopt.adamw_init(jp), jb)
    _, tp = _port(which, jp, torch.float32)
    _, _, step, _ = ttrain.build_trainer(_config(tconfigs, which),
                                             device="cpu")
    tstate, tmetrics = step(topt.adamw_init(tp), tb)
    lr = float(jspecs.schedule_for(jcfg)(jnp.asarray(1, jnp.int32)))
    assert lr == pytest.approx({"qwen3": 3e-4, "minicpm": 1e-2}[which]
                               * 2 / 2000, rel=1e-6)
    assert (abs(tmetrics["loss"].item() - float(jmetrics["loss"]))
            <= 1e-3 * float(jmetrics["loss"]))
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(_stacked(tstate.params))
    diffs = np.concatenate([np.abs(got[n].detach().numpy() - want[n]).ravel()
                            for n in want])
    assert diffs.max() <= 2.5 * lr
    assert (diffs > 1e-2 * lr).mean() <= 1e-2
