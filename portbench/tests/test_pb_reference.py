"""The plain reference against the port at reduced sizes, both in float32:
forward logits, last-position logits after a prefill, the loss and every
gradient leaf, and AdamW steps with the configuration's schedule.  (The
test may import the port; the reference may not.)"""

import dataclasses

import pytest
import torch

from portbench import program, weights
from portbench.reference.model import Reference
from portbench.reference.train import Trainer, learning_rate
from portbench.tests import tiny
from repro_torch.launch.specs import schedule_for
from repro_torch.models import layers
from repro_torch.models import lm as lm_mod
from repro_torch.optim import AdamWConfig, adamw_init, make_train_step

MOE_DROPS = dict(tiny.MOE, moe=dict(tiny.MOE["moe"], group_size=16,
                                    capacity_factor=1.0))
CONFIGS = {"dense": tiny.DENSE, "moe": tiny.MOE, "moe_drops": MOE_DROPS}


@pytest.fixture
def fp32_port(monkeypatch):
    """The port's embedding in float32, so that it runs in float32."""
    embed = layers.embed
    monkeypatch.setattr(layers, "embed", lambda p, t, scale=1.0,
                        dtype=torch.float32: embed(p, t, scale, dtype))


def _tokens(cfg, b=2, s=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab"], (b, s + 1), generator=g)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_and_prefill_match_the_port(name, fp32_port):
    cfg = CONFIGS[name]
    params = weights.make(cfg, 3, "cpu", torch.float32)
    model = lm_mod.build(program.arch(cfg))
    toks = _tokens(cfg)[:, :-1]
    ref = Reference(cfg)
    want = ref.logits(params, ref.hidden(params, toks))
    got = model.forward(params, toks)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    cache = model.init_cache(toks.shape[0], toks.shape[1] + 1, "cpu")
    last = model.prefill(params, toks, cache)[:, -1]
    torch.testing.assert_close(last, ref.last_logits(params, toks),
                               rtol=1e-5, atol=1e-5)


def test_the_drop_case_drops(fp32_port):
    """Capacity 16 x 2 / 8 x 1.0 + 1 = 5 slots: some pairs are dropped."""
    from portbench.reference.model import capacity
    assert capacity(MOE_DROPS["moe"]) == 5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_the_port(name, fp32_port):
    cfg = CONFIGS[name]
    params = weights.make(cfg, 4, "cpu", torch.float32)
    toks = _tokens(cfg, seed=1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    named = weights.leaves(params)
    leaves = [p for _, p in named]
    for p in leaves:
        p.requires_grad_(True)
    model = lm_mod.build(program.arch(cfg), remat="full")
    if cfg.get("moe"):   # LM.loss adds 0.01 x the load-balance loss, which
        # the reference leaves out: the MoE cells only serve
        port_loss = layers.cross_entropy(model.forward(params,
                                                       batch["tokens"]),
                                         batch["labels"])
    else:
        port_loss = model.loss(params, batch)
    ref_loss = Reference(cfg).loss(params, batch["tokens"], batch["labels"],
                                   chunk=16)
    torch.testing.assert_close(port_loss, ref_loss, rtol=1e-6, atol=1e-6)
    g_port = torch.autograd.grad(port_loss, leaves, materialize_grads=True)
    g_ref = torch.autograd.grad(ref_loss, leaves, materialize_grads=True)
    for (n, _), a, b in zip(named, g_port, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=n)


def test_adamw_steps_match_the_port(fp32_port):
    cfg = tiny.DENSE
    arch = program.arch(cfg)
    o = cfg["optimizer"]
    step = make_train_step(lm_mod.build(arch).loss, AdamWConfig(
        b1=o["b1"], b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
        clip_norm=o["clip_norm"], schedule=schedule_for(
            dataclasses.replace(arch, name="minicpm-tiny"))))
    state = adamw_init(weights.make(cfg, 5, "cpu", torch.float32))
    tr = Trainer(Reference(cfg), weights.make(cfg, 5, "cpu", torch.float32))
    for k in range(3):
        toks = _tokens(cfg, seed=10 + k)
        state, m = step(state, {"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]})
        loss, _ = tr.step(toks[:, :-1], toks[:, 1:])
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-6)
    for (n, a), (_, b) in zip(weights.leaves(state.params),
                              weights.leaves(tr.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, msg=n)


def test_schedule_matches_the_ports_wsd():
    cfg = tiny.DENSE
    sched = schedule_for(program.arch(cfg))
    for t in (1, 2, 3, 1999, 2000, 50000, 95000, 99999):
        assert learning_rate(cfg, t) == pytest.approx(float(sched(t)),
                                                      rel=1e-6)
