"""The port's Hymba against the JAX package on the CPU: the selective SSM
block against `repro.models.blocks.ssm`, the ring-buffer KV cache against
`repro.models.layers.attention`, and the hybrid LM against
`repro.models.lm`.

Inputs come from a numpy seed; params from the JAX init, carried over by
`params_from_jax`.  Bars:
  * the SSM block in fp32 activations: output within 1e-5 of the largest
    magnitude (measured 2.2e-7 / 3.6e-7 without / with a state), the new
    bf16 state's conv tail equal and its h within one bf16 ulp (measured
    equal); in bf16 activations: output and h within 2e-2 (measured 1.2e-2
    and 3.3e-3: jax.nn.silu and F.silu round bf16 differently), the conv
    tail equal;
  * a 10-token call and six single-token steps against one 16-token call
    of the same block: within 1e-2 (measured 1.4e-3 in fp32, 1.5e-3 in
    bf16: the state between calls is bf16), the final conv tail equal;
  * the bf16 depthwise conv sum bitwise equal to the JAX block's;
  * the ring-buffer cache: k, v and pos equal to the JAX cache's after a
    prefill and after every decode step; the attention output within 2e-2
    (prefill) and 3e-2 (decode), the bars of tests/test_torch_serve.py;
  * the reduced hymba-1.5b LM in bf16: forward and prefill logits within
    2e-2, teacher-forced and own-forward decode within 3e-2 (the bar
    tests/test_models.py holds the JAX decode to), through three wraps of
    its 16-slot window.
"""

import dataclasses
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers
from repro_torch.models import lm as tlm

ARCH = "hymba-1.5b"
SSM = dict(d_model=64, d_inner=64, state_dim=4, conv_k=4)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the ring buffer at layer level: GQA 4 / 2 heads x 16, an 8-slot window
ATTN = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, window=8)
# Hymba's shape at the flash threshold, narrow: 5 query heads over one KV
# head of 64 (Hymba's 25 / 5 at a fifth), state 16 as published, a global
# layer and then a sliding-window layer of Hymba's 1024 positions
HYMBA_NARROW = dict(name="hymba-narrow", n_layers=2, d_model=128, n_heads=5,
                    n_kv_heads=1, head_dim=64, d_ff=256, vocab=256)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _np(t) -> np.ndarray:
    """A port tensor or a JAX array as a float32 (int32 kept) numpy array."""
    if isinstance(t, torch.Tensor):
        return t.numpy() if t.dtype == torch.int32 else t.float().numpy()
    a = np.asarray(t)
    return a if a.dtype == np.int32 else a.astype(np.float32)


def _bf16_ulps(got, want) -> float:
    """max |got - want| in units of the bf16 spacing at |want|."""
    got, want = _np(got), _np(want)
    spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float((np.abs(got - want) / spacing).max())


# ---------------------------------------------------------------------------
# The selective SSM block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ssm_params():
    """(JAX dims, JAX params, port dims), read-only."""
    jd, td = jblocks.SSMDims(**SSM), tblocks.SSMDims(**SSM)
    jp = jax.jit(jblocks.init_ssm, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jd)
    return jd, jp, td


def _port_ssm(jp, dtype):
    """The JAX params in the port's layout: bf16 matmul weights for bf16
    activations (serving), every leaf fp32 for fp32 activations."""
    tree = {"s": jax.tree.map(np.asarray, jp)}
    return params_from_jax(tree, "cpu", None if dtype == torch.bfloat16
                           else torch.float32)["s"]


def _ssm_inputs(seed=0, s=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, SSM["d_model"])).astype(np.float32)
    state = {"conv": rng.standard_normal(
        (2, SSM["conv_k"] - 1, SSM["d_inner"])).astype(np.float32),
        "h": 0.3 * rng.standard_normal(
            (2, SSM["d_inner"], SSM["state_dim"])).astype(np.float32)}
    return x, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_jax(dtype, with_state):
    jdt, tdt = DT[dtype]
    jd, jp, td = _ssm_params()
    x, state = _ssm_inputs()
    js = ts = None
    if with_state:   # the state is bf16 between calls on both sides
        js = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in state.items()}
        ts = {k: torch.from_numpy(v).bfloat16() for k, v in state.items()}
    want, wstate = jax.jit(lambda p, x, s: jblocks.ssm(p, jd, x, state=s))(
        jp, jnp.asarray(x).astype(jdt), js)
    got, gstate = tblocks.ssm(_port_ssm(jp, tdt), td,
                              torch.from_numpy(x).to(tdt), state=ts)
    assert got.dtype == tdt
    assert gstate["conv"].dtype == gstate["h"].dtype == torch.bfloat16
    assert np.array_equal(_np(gstate["conv"]), _np(wstate["conv"]))
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
        assert _bf16_ulps(gstate["h"], wstate["h"]) <= 1
    else:
        assert _rel(got, want) <= 2e-2
        assert _rel(gstate["h"], wstate["h"]) <= 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_then_steps_match_one_call(dtype):
    """A 10-token call, then six single-token calls carrying the bf16
    state, against one 16-token call of the port's block (1e-2), and the
    same chunking through the JAX block (the block bars above)."""
    jdt, tdt = DT[dtype]
    jd, jp, td = _ssm_params()
    tp = _port_ssm(jp, tdt)
    x, _ = _ssm_inputs(seed=1)
    xt = torch.from_numpy(x).to(tdt)
    whole, wstate = tblocks.ssm(tp, td, xt)
    out, st = tblocks.ssm(tp, td, xt[:, :10])
    outs = [out]
    jstep = jax.jit(lambda p, x, s: jblocks.ssm(p, jd, x, state=s))
    jout, jst = jstep(jp, jnp.asarray(x[:, :10]).astype(jdt),
                      jblocks.init_ssm_state(2, jd))
    jouts = [jout]
    for t in range(10, 16):
        out, st = tblocks.ssm(tp, td, xt[:, t:t + 1], state=st)
        outs.append(out)
        jout, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]).astype(jdt), jst)
        jouts.append(jout)
    got = torch.cat(outs, dim=1)
    assert _rel(got, whole.float().numpy()) <= 1e-2
    assert torch.equal(st["conv"], wstate["conv"])
    assert _rel(st["h"], wstate["h"].float().numpy()) <= 1e-2
    assert _rel(got, np.concatenate([_np(j) for j in jouts], axis=1)) <= (
        1e-5 if dtype == "float32" else 2e-2)


def test_depthwise_conv_sums_in_the_jax_order():
    """In bf16 the conv is K rounded products summed left to right, as the
    JAX block's `sum(conv_in[:, i:i+s] * kern[i] for i in range(K))`:
    bitwise equal to it, where an fp32 accumulation (conv1d) or the other
    order differs."""
    rng = np.random.default_rng(2)
    conv_in = rng.standard_normal((2, 19, 64)).astype(np.float32)
    kern = (0.5 * rng.standard_normal((4, 64))).astype(np.float32)

    @jax.jit
    def jconv(ci, kn):
        ci, kn = ci.astype(jnp.bfloat16), kn.astype(jnp.bfloat16)
        return sum(ci[:, i:i + 16] * kn[i] for i in range(4))
    want = _np(jconv(jnp.asarray(conv_in), jnp.asarray(kern)))
    ci = torch.from_numpy(conv_in).bfloat16()
    kn = torch.from_numpy(kern).bfloat16()
    got = tblocks.depthwise_conv(ci, kn)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 64)
    assert np.array_equal(_np(got), want)
    fp32_acc = sum(ci[:, i:i + 16].float() * kn[i].float()
                   for i in range(4)).bfloat16()
    backwards = ci[:, 3:19] * kn[3]
    for i in (2, 1, 0):
        backwards = backwards + ci[:, i:i + 16] * kn[i]
    assert (_np(fp32_acc) != want).mean() > 0.1
    assert (_np(backwards) != want).mean() > 0.1


# ---------------------------------------------------------------------------
# The ring-buffer KV cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefill", [12, 5])
def test_ring_buffer_cache_matches_jax(prefill):
    """A window of 8 slots in a 40-position cache: a prefill longer (12)
    or shorter (5) than the span, then single-token decode steps through
    three wraps of the ring; after each call k, v and pos equal the JAX
    cache's, and the outputs agree."""
    jd = jlayers.AttnDims(**ATTN)
    td = layers.AttnDims(**ATTN)
    b, max_seq, span = 2, 40, ATTN["window"]
    n = prefill + 3 * span + 2
    jp = jax.jit(jlayers.init_attention, static_argnums=1)(
        jax.random.PRNGKey(3), jd)
    tp = params_from_jax({"a": jax.tree.map(np.asarray, jp)}, "cpu")["a"]
    x = np.random.default_rng(4).standard_normal(
        (b, n, ATTN["d_model"])).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    jcache = jlayers.init_kv_cache(b, max_seq, jd)
    tcache = layers.init_kv_cache(b, max_seq, td, "cpu")
    assert tcache["pos"].dtype == torch.int32
    assert tcache["k"].shape == (b, span, ATTN["n_kv_heads"],
                                 ATTN["head_dim"])

    def check(got, want, jc, bar):
        assert _rel(got, want) <= bar
        for key in ("k", "v", "pos"):
            assert np.array_equal(_np(tcache[key]), _np(jc[key])), key

    pos = np.arange(prefill)[None]
    want, jcache = jlayers.attention(jp, jd, xj[:, :prefill],
                                     jnp.asarray(pos), kv_cache=jcache,
                                     cache_index=0)
    got = layers.attention(tp, td, xt[:, :prefill], torch.from_numpy(pos),
                           kv_cache=tcache, cache_index=0)
    check(got, want, jcache, 2e-2)
    assert _np(tcache["pos"]).max() == prefill - 1
    assert (_np(tcache["pos"]) >= 0).sum() == min(prefill, span)
    for i in range(prefill, n):
        want, jcache = jlayers.attention(
            jp, jd, xj[:, i:i + 1], jnp.asarray([[i]]), kv_cache=jcache,
            cache_index=jnp.asarray(i, jnp.int32))
        got = layers.attention(tp, td, xt[:, i:i + 1],
                               torch.tensor([[i]]), kv_cache=tcache,
                               cache_index=i)
        check(got, want, jcache, 3e-2)
        assert _np(tcache["pos"])[i % span] == i


# ---------------------------------------------------------------------------
# The hybrid LM
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(narrow: bool = False):
    """(JAX model, JAX params, port model, port params) of the reduced
    hymba-1.5b, or of HYMBA_NARROW; read-only."""
    cfgs = []
    for package in (jconfigs, tconfigs):
        cfg = package.get(ARCH, reduced=True)
        if narrow:
            cfg = dataclasses.replace(
                cfg, **HYMBA_NARROW, ssm=dataclasses.replace(
                    cfg.ssm, state_dim=16, global_attn_layers=(0,),
                    sliding_window=1024))
        cfgs.append(cfg)
    jm = jlm.build(cfgs[0])
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tlm.build(cfgs[1])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_layer_plan_matches_jax():
    for reduced in (False, True):
        want = jlm.layer_plan(jconfigs.get(ARCH, reduced=reduced))
        got = tlm.layer_plan(tconfigs.get(ARCH, reduced=reduced))
        assert [(s.kind, s.count, s.window) for s in got] == [
            (s.kind, s.count, s.window) for s in want]
    full = tlm.layer_plan(tconfigs.get(ARCH))
    assert [(s.count, s.window) for s in full] == [
        (1, None), (14, 1024), (1, None), (15, 1024), (1, None)]
    assert tlm.attn_dims(tconfigs.get(ARCH), 1024).window == 1024
    assert tlm.ssm_dims(tconfigs.get(ARCH)).dtr == 100


def test_port_init_matches_jax_layout():
    """The port's init has the JAX init's leaves: paths, shapes, and the
    dtypes `params_from_jax` gives them."""
    jm, _, tm, tp = _models()
    got = tm.init(torch.Generator("cpu").manual_seed(0))
    g = jax.tree.leaves_with_path(got)
    w = jax.tree.leaves_with_path(tp)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path


def test_params_from_jax_keeps_a_log_fp32():
    _, jp, _, tp = _models()
    ssm = tp["seg0"][0]["ssm"]
    assert ssm["a_log"].dtype == torch.float32
    assert np.array_equal(ssm["a_log"].numpy(),
                          np.asarray(jp["seg0"]["ssm"]["a_log"][0]))
    for name in ("d_skip", "conv", "dt_proj", "in_proj", "x_proj"):
        assert ssm[name].dtype == torch.bfloat16, name


def test_forward_logits_match_jax():
    jm, jp, tm, tp = _models()
    tokens = _tokens((2, 40), tm.cfg.vocab)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-2


def test_teacher_forced_decode_matches_jax():
    """Prefill 8 tokens, then 48 decode steps: three wraps of the middle
    layer's 16-slot ring; each step's logits and the ring's pos against
    the JAX model's."""
    jm, jp, tm, tp = _models()
    b, s, pre = 2, 56, 8
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
    assert np.array_equal(tcache["seg1"][0]["kv"]["pos"].numpy(),
                          np.asarray(jcache["seg1"]["kv"]["pos"][0]))


def test_decode_matches_own_forward():
    """Prefill 6 tokens, then decode steps to 54 positions (three wraps of
    the 16-slot window) against the port's forward on the whole sequence,
    position by position."""
    _, _, tm, tp = _models()
    b, s, pre = 2, 54, 6
    tt = torch.from_numpy(_tokens((b, s), tm.cfg.vocab, seed=3))
    full = tm.forward(tp, tt)
    cache = tm.init_cache(b, s, "cpu")
    assert "pos" in cache["seg1"][0]["kv"]
    got = [tm.prefill(tp, tt[:, :pre], cache)]
    got += [tm.decode_step(tp, tt[:, i:i + 1], cache, i)
            for i in range(pre, s)]
    for j, g in enumerate(got):
        pos = pre - 1 + j
        assert _rel(g[:, 0], full[:, pos].numpy()) <= 3e-2, pos


def test_cache_grows_only_in_the_global_layers():
    """As tests/test_models.py holds the JAX model: from 64 to 4096
    positions only the global-attention layers' KV grows; the ring
    buffers and the SSM states keep their size, byte for byte."""
    cfg = tconfigs.get(ARCH, reduced=True)
    tm = tlm.build(cfg)
    small, big = tm.init_cache(1, 64, "cpu"), tm.init_cache(1, 4096, "cpu")

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(tree))
    small_b, big_b = nbytes(small), nbytes(big)
    glb_frac = len(cfg.ssm.global_attn_layers) / cfg.n_layers
    assert big_b < small_b * (4096 / 64) * (glb_frac + 0.15)
    for i, seg in enumerate(tm.plan):
        if seg.window is not None:
            assert nbytes(small[f"seg{i}"]) == nbytes(big[f"seg{i}"])
        assert nbytes(small[f"seg{i}"][0]["ssm"]) == nbytes(
            big[f"seg{i}"][0]["ssm"])
    jm = jlm.build(jconfigs.get(ARCH, reduced=True))
    assert big_b == sum(x.size * x.dtype.itemsize
                        for x in jax.tree.leaves(jm.init_cache(1, 4096)))


def test_prefill_at_flash_threshold_matches_jax():
    """A prompt of FLASH_THRESHOLD tokens through HYMBA_NARROW: both
    frameworks take their flash branch (the JAX chunked reference, the
    port's plain twin), the sliding-window layer with Hymba's window of
    1024; the logits within 2e-2, the ring's last 1024 positions stored
    as the JAX cache stores them."""
    jm, jp, tm, tp = _models(narrow=True)
    s = ops.FLASH_THRESHOLD
    assert [seg.window for seg in tm.plan] == [None, 1024]
    tokens = _tokens((1, s), tm.cfg.vocab, seed=5)
    want, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens),
                                       jm.init_cache(1, s))
    before = fa.flash_attention.launches
    cache = tm.init_cache(1, s, "cpu")
    got = tm.prefill(tp, torch.from_numpy(tokens), cache)
    assert _rel(got, want) <= 2e-2
    assert fa.flash_attention.launches == before
    ring = cache["seg1"][0]["kv"]
    assert ring["k"].shape[1] == 1024
    assert np.array_equal(ring["pos"].numpy(),
                          np.asarray(jcache["seg1"]["kv"]["pos"][0]))
    assert sorted(ring["pos"].tolist()) == list(range(s - 1024, s))


def test_serve_main_hymba_on_cpu():
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
