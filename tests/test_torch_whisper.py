"""The port's encoder-decoder (Whisper) against `repro.models.lm.WhisperLM`
on the CPU, at the reduced whisper-small (2 encoder + 2 decoder layers,
d_model 64, 4 heads x 16, 32 frames, vocab 256).

Params come from the JAX `model.init` and cross with `params_from_jax`;
tokens and frames come from a numpy seed, the same values on both sides.
Bars: the encoder's output and the logits within 1e-5 (relative max) in
fp32 (fp32 frames, fp32 weights, and both packages' `layers.embed`
patched to fp32 by the test: the JAX decoder with a bf16 embedding and an
fp32 encoder output mixes dtypes and fails inside its layer scan) and 2e-2
in bf16; teacher-forced decode steps within 3e-2 (the bar
tests/test_models.py uses for decode against forward); the loss within
1e-3 and each gradient leaf within 5e-2 relative L2, tests/test_torch_train.py's
bars.  At 2048 decoder tokens both sides take their flash branch (the
JAX chunked reference, the port's plain twin); the 32 frames keep the
encoder and the cross-attention naive on both.

Two reference faults are pinned here: R14, the JAX `serve.generate`
hands its decode steps neither frames nor the encoder's output, so it
raises at the first; R15, the JAX `launch.train.main` feeds Whisper
batches without frames.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro_torch import optim as topt
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ARCH = "whisper-small"
DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = jlm.build(jconfigs.get(ARCH, reduced=True))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def _port(dtype=None, remat="full"):
    """The port's model and the JAX params carried over (`dtype` None: the
    serving layout, bf16 matmul weights; torch.float32: fp32 masters)."""
    _, jp = _jax_model()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", dtype)
    return tlm.build(tconfigs.get(ARCH, reduced=True), remat=remat), tp


def _frames(batch, seed=0):
    cfg = tconfigs.get(ARCH, reduced=True)
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _both(a, dtype):
    """numpy `a` as a JAX array and a torch tensor of `dtype` (a key of
    DT), the same values."""
    jd, td, _ = DT[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(td)


def _rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(1e-30, np.linalg.norm(want)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _named(tree):
    """{"a/0/b": leaf} of nested dicts and lists."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _stacked(tree):
    """The port's per-layer lists (segments and the encoder) stacked along
    a leading layer axis, as the JAX package keeps them."""
    return {k: pytree.tree_map(lambda *xs: torch.stack(xs), *v)
            if isinstance(v, list) else v for k, v in tree.items()}


@pytest.fixture
def fp32_embed(monkeypatch):
    """Both packages' `layers.embed` gathering in fp32 (see the module
    docstring)."""
    monkeypatch.setattr(jlayers, "embed", functools.partial(
        jlayers.embed, dtype=jnp.float32))
    monkeypatch.setattr(tlayers, "embed", functools.partial(
        tlayers.embed, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Build, layout
# ---------------------------------------------------------------------------


def test_build_returns_whisper_lm_full_and_reduced():
    for reduced in (False, True):
        cfg = tconfigs.get(ARCH, reduced=reduced)
        model = tlm.build(cfg)
        assert isinstance(model, tlm.WhisperLM)
        assert model.plan == (tlm.Segment("crossdec", cfg.n_layers),)
        assert model.enc_seg == tlm.Segment("dense",
                                            cfg.encdec.n_encoder_layers)


def test_params_from_jax_layout_and_dtypes():
    """The encoder unstacked into per-layer dicts as the segments are;
    `ln_enc`, each decoder block's `ln_cross` and `cross`; scales fp32,
    matmul weights bf16 (or every leaf fp32 for training); the port's own
    init gives the same tree and shapes."""
    jm, jp = _jax_model()
    cfg = jm.cfg
    _, tp = _port()
    assert isinstance(tp["encoder"], list)
    assert len(tp["encoder"]) == cfg.encdec.n_encoder_layers == 2
    assert len(tp["seg0"]) == cfg.n_layers == 2
    for i, lp in enumerate(tp["encoder"]):
        assert set(lp) == {"ln_attn", "ln_mlp", "attn", "ffn"}
        assert torch.equal(lp["attn"]["wq"].float(), torch.from_numpy(
            np.array(jp["encoder"]["attn"]["wq"][i])).bfloat16().float())
    for lp in tp["seg0"]:
        assert set(lp) == {"ln_attn", "ln_mlp", "attn", "ffn", "ln_cross",
                           "cross"}
        assert lp["ln_cross"]["scale"].dtype == torch.float32
        assert lp["cross"]["wk"].dtype == torch.bfloat16
        assert lp["cross"]["wo"].shape == (cfg.n_heads, cfg.head_dim,
                                           cfg.d_model)
    assert tp["ln_enc"]["scale"].dtype == torch.float32
    assert tp["encoder"][0]["ffn"]["wi_gate"].dtype == torch.bfloat16
    masters = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                              torch.float32)
    assert all(t.dtype == torch.float32 for t in pytree.tree_leaves(masters))
    own = tlm.build(tconfigs.get(ARCH, reduced=True)).init(
        torch.Generator("cpu").manual_seed(0))
    assert ({k: (t.shape, t.dtype) for k, t in _named(own).items()}
            == {k: (t.shape, t.dtype) for k, t in _named(tp).items()})


# ---------------------------------------------------------------------------
# Encoder, forward, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DT))
def test_encode_matches_jax(dtype):
    jm, jp = _jax_model()
    tm, tp = _port(torch.float32 if dtype == "float32" else None)
    jf, tf = _both(_frames(2), dtype)
    want = jax.jit(jm.encode)(jp, jf)
    got = tm.encode(tp, tf)
    assert got.dtype == DT[dtype][1]
    assert _rel(got, want) <= DT[dtype][2]


@pytest.mark.parametrize("dtype", list(DT))
def test_forward_logits_match_jax(dtype, request):
    if dtype == "float32":
        request.getfixturevalue("fp32_embed")
    jm, jp = _jax_model()
    tm, tp = _port(torch.float32 if dtype == "float32" else None)
    jf, tf = _both(_frames(2), dtype)
    tokens = _tokens((2, 32))
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens), frames=jf)
    got = tm.forward(tp, torch.from_numpy(tokens), frames=tf)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 256)
    assert _rel(got, want) <= DT[dtype][2]


def test_prefill_and_decode_with_enc_out_match_jax():
    """A 16-token prefill (given the frames) then 3 teacher-forced decode
    steps given the encoder's output, against the reference's `prefill`
    and `decode_step(enc_out=)`; the port's decode steps also against its
    own forward over the whole sequence."""
    jm, jp = _jax_model()
    tm, tp = _port()
    b, pre, s = 2, 16, 19
    jf, tf = _both(_frames(b, seed=3), "bfloat16")
    tokens = _tokens((b, s), seed=4)
    tt = torch.from_numpy(tokens)
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache, frames=jf)
    tcache = tm.init_cache(b, s, "cpu")
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache, frames=tf),
                jlogits) <= 2e-2
    jenc = jax.jit(jm.encode)(jp, jf)
    tenc = tm.encode(tp, tf)
    full = tm.forward(tp, tt, enc_out=tenc)
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32), enc_out=jenc)
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i, enc_out=tenc)
        assert _rel(got, jlogits) <= 3e-2, i
        assert _rel(got[:, 0], full[:, i].numpy()) < 3e-2, i


def test_entry_points_refuse_a_call_without_frames_or_enc_out():
    tm, tp = _port()
    tokens = torch.from_numpy(_tokens((1, 4)))
    cache = tm.init_cache(1, 8, "cpu")
    for call in (lambda: tm.forward(tp, tokens),
                 lambda: tm.prefill(tp, tokens, cache),
                 lambda: tm.decode_step(tp, tokens[:, :1], cache, 4),
                 lambda: tm.loss(tp, {"tokens": tokens, "labels": tokens})):
        with pytest.raises(ValueError, match="frames.*enc_out"):
            call()


def test_prefill_at_flash_threshold_matches_jax():
    """A decoder prompt of FLASH_THRESHOLD tokens: both frameworks take
    their flash branch for the decoder's self-attention (the JAX chunked
    reference, the port's plain twin), the encoder and cross-attention
    staying naive; no kernel launches on the CPU."""
    jm, jp = _jax_model()
    tm, tp = _port()
    s = ops.FLASH_THRESHOLD
    jf, tf = _both(_frames(1, seed=5), "bfloat16")
    tokens = _tokens((1, s), seed=6)
    want, _ = jax.jit(jm.prefill)(jp, jnp.asarray(tokens),
                                  jm.init_cache(1, s), frames=jf)
    before = fa.flash_attention.launches
    cache = tm.init_cache(1, s, "cpu")
    got = tm.prefill(tp, torch.from_numpy(tokens), cache, frames=tf)
    assert _rel(got, want) <= 2e-2
    assert fa.flash_attention.launches == before
    assert cache["seg0"][-1]["kv"]["k"][:, s - 1].abs().sum() > 0


def test_reference_generate_raises_at_its_first_decode():
    """R14: the JAX `generate` passes the frames to the prefill only, so
    its first decode step runs `encode(params, None)`."""
    jm, jp = _jax_model()
    jf, _ = _both(_frames(2), "bfloat16")
    prompts = jnp.asarray(_tokens((2, 8)))
    with pytest.raises(AttributeError, match="shape"):
        jserve.generate(jm, jp, prompts, 12, 3, jf)


def test_generate_serves_where_the_reference_raises():
    """R14 repaired in the port: `generate` encodes once and returns the
    argmax of its own teacher-forced decode (replayed here step by step
    with the encoder's output), whose logits match the reference's
    `decode_step(enc_out=)` on the same tokens."""
    jm, jp = _jax_model()
    tm, tp = _port()
    b, pre, gen = 2, 8, 4
    jf, tf = _both(_frames(b, seed=7), "bfloat16")
    prompts = _tokens((b, pre), seed=8)
    toks = serve.generate(tm, tp, torch.from_numpy(prompts), pre + gen, gen,
                          tf)
    assert toks.shape == (b, gen)
    tenc, jenc = tm.encode(tp, tf), jax.jit(jm.encode)(jp, jf)
    tcache = tm.init_cache(b, pre + gen, "cpu")
    jcache = jm.init_cache(b, pre + gen)
    with torch.inference_mode():
        got = tm.prefill(tp, torch.from_numpy(prompts), tcache, enc_out=tenc)
    want, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(prompts), jcache,
                                       frames=jf)
    step = jax.jit(jm.decode_step)
    for i in range(gen):
        assert _rel(got, want) <= 3e-2, i
        assert torch.equal(got[:, -1].argmax(-1), toks[:, i]), i
        if i == gen - 1:
            break
        tok = toks[:, i:i + 1]
        with torch.inference_mode():
            got = tm.decode_step(tp, tok, tcache, pre + i, enc_out=tenc)
        want, jcache = step(jp, jnp.asarray(tok.numpy()), jcache,
                            jnp.asarray(pre + i, jnp.int32), enc_out=jenc)


def test_serve_main_on_cpu():
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _batch(shape, seed=9):
    toks = _tokens((shape[0], shape[1] + 1), seed=seed)
    jf, tf = _both(_frames(shape[0], seed=seed + 1), "bfloat16")
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:]), "frames": jf}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:]), "frames": tf}
    return jb, tb


def _port_grads(tm, tp, tb):
    leaves, spec = pytree.tree_flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    return loss, pytree.tree_unflatten(list(grads), spec)


@pytest.mark.parametrize("seq,remat", [(32, "none"), (32, "full"),
                                       (2048, "full")])
def test_loss_and_grads_match_jax(seq, remat):
    """`LM.loss` + backward against `jax.value_and_grad(model.loss)` with
    bf16 frames: the loss within 1e-3, every gradient leaf (the encoder's,
    `ln_enc`'s and the cross-attention's among them) within 5e-2 relative
    L2.  At 2048 decoder tokens both sides differentiate their chunked
    flash attention; under remat "full" the encoder's gradient reaches it
    through every decoder block's checkpoint."""
    jm, jp = _jax_model()
    jb, tb = _batch((2 if seq == 32 else 1, seq))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tm, tp = _port(torch.float32, remat=remat)
    loss, grads = _port_grads(tm, tp, tb)
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(_stacked(grads))
    assert got.keys() == want.keys()
    assert any(k.startswith("/encoder/") for k in want)
    assert any("/cross/" in k for k in want)
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 5e-2, name


def test_remat_grads_equal_no_remat():
    """remat "full" and "dots" against none on the CPU: the same loss and
    gradients (the recompute runs the same ops)."""
    _, tb = _batch((2, 32), seed=11)
    runs = [_port_grads(*_port(torch.float32, remat=r), tb)
            for r in ("none", "full", "dots")]
    for loss, grads in runs[1:]:
        assert loss.item() == runs[0][0].item()
        for g, w in zip(pytree.tree_leaves(grads),
                        pytree.tree_leaves(runs[0][1])):
            assert torch.allclose(g, w, rtol=1e-6, atol=1e-9)


def test_adamw_update_matches_jax_with_the_encoder():
    """Two AdamW updates from the same fp32 params and numpy grads at 1e-6:
    R9's decay mask takes the encoder's per-layer norm scales (stacked, so
    2-D, in the JAX package) and leaves `ln_enc` and `ln_f` alone."""
    _, jp = _jax_model()
    _, tp = _port(torch.float32)
    flat_mask = dict(zip(_named(tp), topt.decay_mask(tp), strict=True))
    assert flat_mask["encoder/0/ln_attn/scale"] is True
    assert flat_mask["ln_enc/scale"] is False and not flat_mask["ln_f/scale"]
    cfg_j = jopt.AdamWConfig(schedule=lambda s: 1e-2)
    cfg_t = topt.AdamWConfig(schedule=lambda s: 1e-2)
    rng = np.random.default_rng(12)
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(2):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32), jax.tree.map(np.asarray, jp))
        jstate = jopt.adamw_update(jstate, jax.tree.map(jnp.asarray, g),
                                   cfg_j)
        tstate = topt.adamw_update(tstate,
                                   params_from_jax(g, "cpu", torch.float32),
                                   cfg_t)
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(_stacked(tstate.params))
    for name in want:
        w = want[name]
        assert (np.abs(got[name].detach().numpy() - w).max()
                <= 1e-6 * max(1e-30, np.abs(w).max())), name


def test_build_trainer_steps_the_reduced_whisper():
    """`build_trainer(device="cpu")` on the reduced Whisper with batches
    that carry bf16 frames: the step's loss is `model.loss` of the initial
    params (1e-6 relative), finite, and the step moves the encoder's and
    the cross-attention's params to finite values."""
    cfg = tconfigs.get(ARCH, reduced=True)
    model, state, step, _ = train.build_trainer(cfg, device="cpu")
    assert isinstance(model, tlm.WhisperLM)
    _, tb = _batch((2, 32), seed=13)
    enc = state.params["encoder"][0]["attn"]["wq"].detach().clone()
    cross = state.params["seg0"][1]["cross"]["wk"].detach().clone()
    with torch.no_grad():
        want = model.loss(state.params, tb).item()
    state, metrics = step(state, tb)
    assert state.step == 1 and np.isfinite(want)
    assert abs(metrics["loss"].item() - want) <= 1e-6 * abs(want)
    assert all(torch.isfinite(p).all()
               for p in pytree.tree_leaves(state.params))
    assert not torch.equal(state.params["encoder"][0]["attn"]["wq"], enc)
    assert not torch.equal(state.params["seg0"][1]["cross"]["wk"], cross)


def test_train_main_refuses_whisper(tmp_path):
    """R15 in the port: `train.main` refuses an encoder-decoder arch up
    front (its data pipeline carries no frames), before any step, retry or
    backoff."""
    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "1", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "ckpt").exists()


def test_reference_loss_on_a_pipeline_batch_raises():
    """R15's cause in the reference: its `launch.train.main` feeds
    `SyntheticTokens` batches, which carry no frames, and `WhisperLM.loss`
    reads batch["frames"].  (`main` itself retries with 30 s of backoff
    before it raises, so it is not called here.)"""
    jm, jp = _jax_model()
    data = JSyntheticTokens(JDataConfig(vocab=jm.cfg.vocab, seq_len=8,
                                        global_batch=2))
    batch = data.batch(0)
    assert "frames" not in batch
    with pytest.raises(KeyError, match="frames"):
        jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
