"""The port's mixture of experts and DeepSeek-MoE LM against
`repro.models.blocks.moe` and `repro.models.lm` on the CPU.

Inputs come from a numpy seed; params from the JAX init, carried over by
`params_from_jax`.  Bars:
  * the MoE block in fp32 activations: output within 1e-5 of the largest
    magnitude, the load-balance loss within 1e-6, the chosen experts and
    the kept (token, slot) pairs equal, in the smoke dims, with capacity
    drops, with padding, with exact router ties and with a router bias;
  * the reduced deepseek-moe-16b LM in bf16: forward and prefill logits
    within 2e-2, teacher-forced decode steps within 3e-2 (the bars of
    tests/test_torch_serve.py), `LM.loss` within 1e-2 of the JAX
    `model.loss`, the summed load-balance loss within 1e-3.  On the same
    bf16 input the two routers' logits are bitwise equal; through the LM
    the bf16 activations round differently upstream, and on the loss's
    batch two tokens pick another expert at a near tie: the aux differs by
    5.6e-4 there, 4e-6 on the forward's batch;
  * training: the reduced deepseek-moe-16b's loss and gradients against
    `jax.value_and_grad(model.loss)` with tests/test_torch_train.py's
    bars (loss 1e-3 relative, each leaf 5e-2 relative L2; at 2048
    positions, the flash path, a leaf that routing moves farther within
    1.5 x the port's naive-attention path's distance from JAX), the router
    bias's gradient zero on both sides (it enters only the top-k sort);
    one `build_trainer` step leaves the router bias bitwise where it was.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.launch import train
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init, make_train_step
from test_torch_train import (_batch, _check_grads, _flat, _jax_model,
                              _port_grads, _rel_l2, _stacked)

ARCH = "deepseek-moe-16b"
# the reduced config's MoE: 4 experts, top 2, one shared, group 32
SMOKE = dict(d_model=64, n_experts=4, top_k=2, d_expert=96, n_shared=1,
             group_size=32, capacity_factor=8.0)
# name: (dims overrides, x shape (B,S), router edit)
CASES = {
    "smoke": ({}, (2, 32), None),
    "drops": ({"capacity_factor": 1.0}, (4, 32), None),
    "padding": ({}, (3, 20), None),           # 60 tokens: 4 padding rows
    "ties": ({}, (4, 32), "tie"),            # experts 0 and 1 identical
    "bias": ({"capacity_factor": 1.0}, (4, 32), "bias"),
}
BIAS = np.array([0.3, -0.2, 0.1, 0.0], np.float32)


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


def _block(name):
    """(JAX dims, JAX params, port dims, port fp32 params, x (numpy))."""
    over, shape, edit = CASES[name]
    jdims = jblocks.MoEDims(**{**SMOKE, **over})
    tdims = tblocks.MoEDims(**{**SMOKE, **over})
    jp = jax.tree.map(np.asarray, jax.jit(
        jblocks.init_moe, static_argnums=1)(jax.random.PRNGKey(4), jdims))
    jp = {k: (dict(v) if isinstance(v, dict) else np.array(v))
          for k, v in jp.items()}
    if edit == "tie":
        jp["router"][:, 1] = jp["router"][:, 0]
    elif edit == "bias":
        jp["router_bias"] = BIAS.copy()
    tp = params_from_jax({"moe": jp}, "cpu", torch.float32)["moe"]
    x = np.random.default_rng(5).standard_normal(
        (*shape, SMOKE["d_model"])).astype(np.float32)
    return jdims, jp, tdims, tp, x


def _jax_routing(jp, dims, x):
    """The JAX block's routing, its lines (repro/models/blocks.py:55-84)
    run to read what `moe` keeps internal: (expert (G,S,K), kept (G,S,K))."""
    b, s, d = x.shape
    t, g = b * s, dims.group_size
    pad = (-t) % g
    xf = jnp.concatenate([jnp.asarray(x).reshape(t, d),
                          jnp.zeros((pad, d), jnp.float32)])
    valid = (jnp.arange(t + pad) < t).astype(jnp.float32).reshape(-1, g)
    xg = xf.reshape(-1, g, d)
    logits = jnp.einsum("gsd,de->gse", xg, jnp.asarray(jp["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs + jnp.asarray(jp["router_bias"]), dims.top_k)
    e = dims.n_experts
    cap = int(g * dims.top_k / e * dims.capacity_factor) + 1
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32) * valid[..., None, None]
    pos = jnp.cumsum(onehot.reshape(onehot.shape[0], -1, e), axis=1)
    pos = pos.reshape(onehot.shape) - 1.0
    kept = jnp.sum(onehot * (pos < cap), axis=-1) > 0
    return np.asarray(idx), np.asarray(kept), np.asarray(probs)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_block_matches_jax_fp32(name):
    jdims, jp, tdims, tp, x = _block(name)
    want, want_aux = jblocks.moe(jax.tree.map(jnp.asarray, jp), jdims,
                                 jnp.asarray(x))
    got, aux = tblocks.moe(tp, tdims, torch.from_numpy(x))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert _rel(got, want) <= 1e-5
    assert abs(aux.item() - float(want_aux)) <= 1e-6 * max(
        1.0, abs(float(want_aux)))

    want_idx, want_kept, want_probs = _jax_routing(jp, jdims, x)
    xg, valid = tblocks.group_tokens(torch.from_numpy(x), tdims.group_size)
    pad = (-(x.shape[0] * x.shape[1])) % tdims.group_size
    _, expert, _, _, kept, _ = tblocks.route(tp, tdims, xg, valid)
    assert np.array_equal(expert.numpy(), want_idx)
    assert np.array_equal(kept.numpy(), want_kept)
    dropped = int((valid[..., None] & ~kept).sum())
    if name in ("drops", "bias"):
        assert dropped > 0 and tdims.capacity == 17
    if name == "padding":
        assert pad == 4 and not kept.numpy()[-1, -pad:].any()
    if name == "ties":   # expert 0 and 1 tie at the top-k edge: 0 wins
        edge = (want_idx == 0).any(-1) ^ (want_idx == 1).any(-1)
        assert edge.sum() > 0
        assert np.array_equal(want_probs[..., 0], want_probs[..., 1])
        assert not (want_idx[edge] == 1).any()
    if name == "bias":   # the bias moves the choice, not the gates
        plain = _jax_routing({**jp, "router_bias": 0 * BIAS}, jdims, x)[0]
        assert not np.array_equal(plain, want_idx)


def test_moe_capacity_at_full_width():
    dims = tlm.moe_dims(tconfigs.get(ARCH))
    assert (dims.group_size, dims.capacity) == (512, 61)
    assert dims.router_bias and dims.n_shared == 2


def test_params_from_jax_keeps_router_bias_fp32():
    _, jp, _, _, _ = _block("bias")
    tp = params_from_jax({"moe": jp}, "cpu")["moe"]
    assert tp["router_bias"].dtype == torch.float32
    assert np.array_equal(tp["router_bias"].numpy(), BIAS)
    for name in ("router", "wi_gate", "wo"):
        assert tp[name].dtype == torch.bfloat16, name
    assert tp["shared"]["wi_up"].dtype == torch.bfloat16


def test_port_init_matches_jax_layout():
    jdims, _, tdims, _, _ = _block("smoke")
    jp = jax.jit(jblocks.init_moe, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jdims)
    tp = tblocks.init_moe(torch.Generator("cpu").manual_seed(0), tdims)
    want = params_from_jax({"moe": jax.tree.map(np.asarray, jp)}, "cpu")
    got, want = jax.tree.leaves_with_path(tp), jax.tree.leaves_with_path(
        want["moe"])
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path


# ---------------------------------------------------------------------------
# The reduced deepseek-moe-16b LM
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, JAX params, port model, port params), read-only."""
    jm = jlm.build(jconfigs.get(ARCH, reduced=True))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tlm.build(tconfigs.get(ARCH, reduced=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_layer_plan_matches_jax():
    for reduced in (False, True):
        want = jlm.layer_plan(jconfigs.get(ARCH, reduced=reduced))
        got = tlm.build(tconfigs.get(ARCH, reduced=reduced)).plan
        assert [(s.kind, s.count) for s in got] == [(s.kind, s.count)
                                                     for s in want]
    _, _, tm, tp = _models()
    assert [len(tp[f"seg{i}"]) for i in range(2)] == [1, 1]
    assert tp["seg0"][0]["ffn"]["wi_gate"].shape == (64, 192)
    assert tp["seg1"][0]["ffn"]["shared"]["wi_gate"].shape == (64, 96)


def test_forward_logits_and_aux_match_jax():
    jm, jp, tm, tp = _models()
    tokens = _tokens((2, 32), tm.cfg.vocab)
    want, want_aux, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-2
    _, aux = tm._hidden(tp, torch.from_numpy(tokens))
    assert abs(aux.item() - float(want_aux)) <= 1e-3 * abs(float(want_aux))


def test_teacher_forced_decode_matches_jax():
    jm, jp, tm, tp = _models()
    b, s, pre = 2, 20, 8
    tokens = _tokens((b, s), tm.cfg.vocab, seed=2)
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache)
    tcache = tm.init_cache(b, s, "cpu")
    tt = torch.from_numpy(tokens)
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache), jlogits) <= 2e-2
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert _rel(got, jlogits) <= 3e-2, i


def test_decode_matches_own_forward():
    """Prefill then decode steps against the port's forward on the whole
    sequence, position by position (3e-2, as tests/test_models.py holds
    the JAX decode against its forward)."""
    _, _, tm, tp = _models()
    b, s, pre = 2, 16, 6
    tt = torch.from_numpy(_tokens((b, s), tm.cfg.vocab, seed=3))
    full = tm.forward(tp, tt)
    cache = tm.init_cache(b, s, "cpu")
    got = [tm.prefill(tp, tt[:, :pre], cache)]
    got += [tm.decode_step(tp, tt[:, i:i + 1], cache, i)
            for i in range(pre, s)]
    for j, g in enumerate(got):
        pos = pre - 1 + j
        assert _rel(g[:, 0], full[:, pos].numpy()) <= 3e-2, pos


def test_loss_matches_jax():
    """`LM.loss` (cross-entropy + 0.01 x aux) against the JAX
    `model.loss` within 1e-2 relative; the aux term is there."""
    jm, jp, tm, tp = _models()
    toks = _tokens((2, 33), tm.cfg.vocab, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    want = float(jax.jit(jm.loss)(jp, jb))
    got = tm.loss(tp, tb).item()
    assert abs(got - want) <= 1e-2 * abs(want)
    ce = layers.cross_entropy(tm.forward(tp, tb["tokens"]), tb["labels"])
    jlogits, jaux, _ = jax.jit(jm.forward)(jp, jb["tokens"])
    jce = float(jlayers.cross_entropy(jlogits, jb["labels"]))
    assert abs(want - jce - 0.01 * float(jaux)) <= 1e-6 * abs(want)
    assert abs((got - ce.item()) - 0.01 * float(jaux)) <= 1e-3 * abs(
        0.01 * float(jaux))


def test_serve_main_moe_on_cpu():
    from repro_torch.launch import serve
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


# ---------------------------------------------------------------------------
# Training: the router bias has no path to the loss
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax():
    """`LM.loss` and its gradients (batch 2 x 32, naive attention) against
    `jax.value_and_grad(model.loss)`; the router bias's gradient is zero
    on both sides."""
    got, want = _check_grads(ARCH, None, (2, 32))
    bias = [name for name in want if name.endswith("/router_bias")]
    assert bias
    for name in bias:
        assert not np.asarray(want[name]).any()
        assert not got[name].any()


def test_loss_and_grads_at_seq_2048_match_jax():
    """The reduced deepseek-moe-16b at 2048 positions (batch 1), so both
    sides differentiate their chunked flash attention inside the MoE LM
    (here `ops.attention`'s plain twin, the kernels' on the card): the
    loss within 1e-3 of `jax.value_and_grad(model.loss)`, and every
    gradient leaf within tests/test_torch_train.py's 5e-2 relative L2 or,
    where routing moves it farther, within 1.5 x the distance of the
    port's naive-attention path from JAX on that leaf.  At 2048 tokens
    bf16 rounding sends a few tokens to other experts in one package and
    not the other: the router's gradient lies ~6e-2 from JAX's through the
    flash path and ~7e-2 through the naive path, the bar chip_smoke holds
    a MoE training step to (the naive oracle's distance, never the path's
    own).  The router bias's gradient is zero."""
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
    for name, d in dist[None].items():
        assert d <= max(5e-2, 1.5 * dist["naive"][name]), name


def test_build_trainer_step_leaves_router_bias():
    """One `build_trainer` step on the CPU: a finite loss, the router bias
    bitwise unchanged (a zero gradient; it starts at zero, so the decay
    the R9 rule gives a segment's leaves keeps it there), the other
    params moved."""
    cfg = tconfigs.get(ARCH, reduced=True)
    _, state, step, _ = train.build_trainer(cfg, device="cpu")
    ffn = state.params["seg1"][0]["ffn"]
    bias = ffn["router_bias"].detach().clone()
    router = ffn["router"].detach().clone()
    _, tb = _batch(cfg.vocab, (2, 32))
    state, metrics = step(state, tb)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert torch.equal(state.params["seg1"][0]["ffn"]["router_bias"], bias)
    assert not torch.equal(state.params["seg1"][0]["ffn"]["router"], router)


def test_dense_step_sees_a_gradient_in_every_leaf():
    """The train step's zeros for unused leaves must not hide a leaf that
    reaches the loss: on a dense config every gradient the optimizer gets
    is nonzero."""
    cfg = tconfigs.get("tinyllama-1.1b", reduced=True)
    model = tlm.build(cfg)
    seen = []

    def capture(grads):
        seen.append(grads)
        return grads
    step = make_train_step(model.loss, AdamWConfig(), grad_transform=capture)
    state = adamw_init(model.init(torch.Generator("cpu").manual_seed(0),
                                  dtype=torch.float32))
    _, tb = _batch(cfg.vocab, (2, 32))
    step(state, tb)
    leaves = jax.tree.leaves_with_path(seen[0])
    assert len(leaves) == len(jax.tree.leaves(state.params))
    for path, g in leaves:
        assert g is not None and g.abs().sum() > 0, path
