"""The port's multi-head latent attention (MLA) and DeepSeek-V3 LM against
`repro.models.blocks.mla_attention` and `repro.models.lm` on the CPU.

Inputs come from a numpy seed; params from the JAX init, carried over by
`params_from_jax`.  The block runs in fp32 activations (the JAX side
jitted) at the reduced deepseek-v3-671b dims unless a case says
otherwise.  Bars:
  * `mla_attention` in fp32: output and cache entries within 1e-5 of the
    largest magnitude (summation order), at 17 positions (the naive
    absorbed branch), at 2048 (the flash branch: the JAX package's
    `force="ref"` chunked reference against the port's plain twin of the
    kernel) and through a latent cache (a 40-token prefill into 64
    positions, then 3 decode steps); in bf16 activations 2e-2;
  * the plain twin at the MLA layout (one k / v head shared by q's heads,
    head dims 576 / 512) against `repro.kernels.ref.flash_attention_ref`:
    output 1e-5, its VJP against `jax.vjp` 2e-5 of max(max |want|, 1)
    (chip_smoke's backward bar: at one key dq and dk cancel to rounding
    residues), with `block_k = min(512, Skv)` as
    `ops.attention` passes it, so the JAX side drops no key (R5);
  * the reduced LM in bf16: forward and prefill logits within 2e-2,
    teacher-forced decode steps within 3e-2, decode against its own
    forward within 3e-2 (the bars of tests/test_torch_moe.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref as jref
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm

ARCH = "deepseek-v3-671b"


def _rel(got, want, floor=1e-30):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(floor, np.abs(want).max()))


def _dims():
    """(JAX MLADims, port MLADims) of the reduced config."""
    cfg = jconfigs.get(ARCH, reduced=True)
    return jlm.mla_dims(cfg), tlm.mla_dims(tconfigs.get(ARCH, reduced=True))


@functools.lru_cache(maxsize=None)
def _block_params():
    """(JAX params (numpy), port fp32 params) of one MLA block."""
    jdims, _ = _dims()
    jp = jax.tree.map(np.asarray, jax.jit(
        jblocks.init_mla, static_argnums=1)(jax.random.PRNGKey(3), jdims))
    return jp, params_from_jax({"attn": jp}, "cpu", torch.float32)["attn"]


def _x(shape, d, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (*shape, d)).astype(np.float32)


DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def test_init_mla_layout_and_params_from_jax():
    """The port's eight MLA leaves have the JAX init's names, shapes and
    the serving dtypes (bf16 matmul weights, fp32 norm scales), and
    `params_from_jax` carries the JAX values over (bf16-rounded)."""
    jdims, tdims = _dims()
    jp, _ = _block_params()
    tp = tblocks.init_mla(torch.Generator("cpu").manual_seed(0), tdims)
    want = params_from_jax({"attn": jp}, "cpu")["attn"]
    assert list(tp) == ["wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b",
                        "wv_b", "wo"]
    got, want_l = (jax.tree.leaves_with_path(t) for t in (tp, want))
    assert [p for p, _ in got] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got, want_l):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
    assert tp["wq_b"].shape == (32, 4, 24) and tp["wkv_a"].shape == (64, 24)
    assert want["q_norm"]["scale"].dtype == torch.float32
    for name in ("wq_a", "wk_b", "wo"):
        assert want[name].dtype == torch.bfloat16
        assert torch.equal(want[name],
                           torch.from_numpy(np.array(jp[name])).bfloat16())


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("s", [17, 2048])
def test_mla_attention_matches_jax(s, dtype):
    """Without a cache: 17 positions take the naive absorbed branch on
    both sides, 2048 the flash branch (`ops.attention`'s plain twin here,
    the JAX package's chunked reference there)."""
    jd, td, tol = DT[dtype]
    jdims, tdims = _dims()
    jp, tp = _block_params()
    x = _x((1, s), jdims.d_model)
    pos = np.arange(s)[None]
    want, _ = jax.jit(jblocks.mla_attention, static_argnums=1)(
        jax.tree.map(jnp.asarray, jp), jdims, jnp.asarray(x, jd),
        jnp.asarray(pos))
    got = tblocks.mla_attention(tp, tdims, torch.from_numpy(x).to(td),
                                torch.from_numpy(pos))
    assert got.dtype == td
    assert _rel(got, want.astype(jnp.float32)) <= tol


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_cache_prefill_then_decode_matches_jax(cache_dtype):
    """A 40-token prefill into a 64-position latent cache, then 3 decode
    steps at positions 40-42: each output and the cache entries written
    so far against the JAX block's, in fp32 activations.  With a bf16
    cache the entries are held to one bf16 step (8e-3 relative)."""
    jd, td, _ = DT[cache_dtype]
    jdims, tdims = _dims()
    jp, tp = _block_params()
    jpj = jax.tree.map(jnp.asarray, jp)
    b, pre, n = 2, 40, 64
    x = _x((b, pre + 3), jdims.d_model, seed=6)
    jcache = jblocks.init_mla_cache(b, n, jdims, dtype=jd)
    tcache = tblocks.init_mla_cache(b, n, tdims, "cpu", dtype=td)
    assert {k: (v.shape, v.dtype) for k, v in tcache.items()} == {
        "ckv": ((b, n, 16), td), "krope": ((b, n, 8), td)}
    step = jax.jit(jblocks.mla_attention, static_argnums=1)
    out_bar, cache_bar = (1e-5, 1e-5) if cache_dtype == "float32" else (
        1e-3, 8e-3)
    for start, stop in [(0, pre), (pre, pre + 1), (pre + 1, pre + 2),
                        (pre + 2, pre + 3)]:
        pos = np.arange(start, stop)[None]
        want, jcache = step(jpj, jdims, jnp.asarray(x[:, start:stop]),
                            jnp.asarray(pos), kv_cache=jcache,
                            cache_index=start)
        got = tblocks.mla_attention(tp, tdims,
                                    torch.from_numpy(x[:, start:stop]),
                                    torch.from_numpy(pos), kv_cache=tcache,
                                    cache_index=start)
        assert _rel(got, want) <= out_bar, start
        for name in ("ckv", "krope"):
            assert _rel(tcache[name][:, :stop],
                        jcache[name][:, :stop].astype(jnp.float32)) <= \
                cache_bar, (name, start)
            assert not tcache[name][:, stop:].any()


# ---------------------------------------------------------------------------
# The kernel's plain twin at the MLA layout
# ---------------------------------------------------------------------------


def _mla_inputs(sq, skv, h=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, sq, h, 576)).astype(np.float32),
            rng.standard_normal((1, skv, 1, 576)).astype(np.float32),
            rng.standard_normal((1, skv, 1, 512)).astype(np.float32),
            rng.standard_normal((1, sq, h, 512)).astype(np.float32))


@pytest.mark.parametrize("sq,skv,q_offset", [
    (1, 1, 0), (127, 127, 0), (129, 129, 0), (2048, 2048, 0), (64, 129, 65),
    # the bf16 kernel's 64-key tiles, and 189 / 66 rows of 3 heads (not a
    # multiple of its 64-row blocks)
    (63, 63, 0), (65, 65, 0), (191, 191, 0), (22, 191, 169)])
def test_plain_twin_at_mla_layout_matches_jax(sq, skv, q_offset):
    """`flash_attention_plain` and its VJP (the plain backward, which sums
    dK and dV over q's heads) against `jax.vjp` of the reference's
    `flash_attention_ref`, causal, at the MLA layout's scale 192**-0.5."""
    q, k, v, do = _mla_inputs(sq, skv)
    block, scale = min(512, skv), 192 ** -0.5
    jfn = jax.jit(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, block, True, None, q_offset, scale))
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    assert fa.is_mla(*ts)
    out = fa.flash_attention_plain(*ts, causal=True, q_offset=q_offset,
                                   scale=scale)
    out.backward(torch.from_numpy(do))
    assert out.shape == (1, sq, 3, 512)
    assert _rel(out, jout) <= 1e-5
    for t, w in zip(ts, want):   # over max(max |want|, 1): at one key dq
        assert _rel(t.grad, w, floor=1.0) <= 2e-5   # and dk cancel to ~0


def test_plain_forward_lse_at_mla_layout():
    """`flash_attention_fwd` on CPU tensors at the MLA layout (v a view of
    k's first 512 features, as `mla_attention` passes it): the output of
    `flash_attention_plain` and the reference VJP's m + log(max(l, 1e-30))
    as lse."""
    q, k, _, _ = _mla_inputs(70, 90, seed=1)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    out, lse = fa.flash_attention_fwd(tq, tk, tk[..., :512], q_offset=20,
                                      scale=0.05, want_lse=True)
    _, (m, l) = jref._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(k[..., :512]), block_k=90,
                                causal=True, window=None, q_offset=20,
                                scale=0.05)
    assert lse.shape == (1, 3, 70)
    assert _rel(lse, m + jnp.log(jnp.maximum(l, 1e-30))) <= 1e-6
    assert torch.equal(out, fa.flash_attention_plain(
        tq, tk, tk[..., :512], q_offset=20, scale=0.05))


def _dispatch_case(name):
    """(q, k, v) on the CPU for a `test_mla_kernel_dispatch` case."""
    dtype = torch.float32 if name.startswith("fp32") else torch.bfloat16
    q = torch.zeros(2, 6, 3, 576, dtype=dtype)
    k = torch.zeros(2, 9, 1, 576, dtype=dtype)
    v = torch.zeros(2, 9, 1, 512, dtype=dtype)
    heads_outer = q.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros(2, 6, 6, 576, dtype=dtype)
    return {
        "fp32": (q, k, v),
        "fp32_view": (q, k, k[..., :512]),
        "fp32_heads_outer": (heads_outer, k, v),
        "bf16": (q, k, v),
        "bf16_view": (q, k, k[..., :512]),
        "bf16_tail_view": (q, k, k[..., 64:]),
        "bf16_copy_of_view": (q, k, k[..., :512].clone()),
        "bf16_every_other_head": (wide[:, :, ::2], k, v),
        "bf16_one_head_strided": (q[:, ::2, :1], k, v),
        "bf16_one_position": (heads_outer[:, :1], k, v),
        "bf16_heads_outer": (heads_outer, k, v),
        "bf16_every_other_position": (q[:, ::2], k, v),
    }[name]


@pytest.mark.parametrize("name,want", [
    ("fp32", "simt"), ("fp32_view", "simt"), ("fp32_heads_outer", "simt"),
    ("bf16", "wgmma"), ("bf16_view", "wgmma_kv"), ("bf16_tail_view", "wgmma"),
    ("bf16_copy_of_view", "wgmma"), ("bf16_every_other_head", "wgmma"),
    ("bf16_one_head_strided", "wgmma"), ("bf16_one_position", "wgmma"),
    ("bf16_heads_outer", ValueError),
    ("bf16_every_other_position", ValueError)])
def test_mla_kernel_dispatch(name, want):
    """`fa.mla_kernel`, the rule the wrapper follows at the MLA layout on
    CUDA tensors: float32 takes the SIMT kernel whatever its strides;
    bfloat16 the wgmma kernel, reading the K tile as V only where v is k's
    first 512 features (not its last 512, nor a copy); a bf16 q whose
    position stride is not H times its head stride raises (where H > 1
    and Sq > 1: one head, or one position, has a single row stride)."""
    q, k, v = _dispatch_case(name)
    assert fa.is_mla(q, k, v)
    if want is ValueError:
        with pytest.raises(ValueError, match="position stride"):
            fa.mla_kernel(q, k, v)
    else:
        assert fa.mla_kernel(q, k, v) == want


# ---------------------------------------------------------------------------
# The reduced deepseek-v3-671b LM
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


def test_lm_init_matches_jax_layout_mtp_included():
    """`LM.init` gives the JAX init's leaves (the MTP head's among them)
    with their shapes and serving dtypes; `params_from_jax` carries every
    leaf, bf16 matmul weights and fp32 norm scales."""
    jm, jp, tm, tp = _models()
    own = tm.init(torch.Generator("cpu").manual_seed(0))
    got, want = (jax.tree.leaves_with_path(t) for t in (own, tp))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
    assert sorted(tp["mtp"]) == ["block", "ln", "proj"]
    assert tp["mtp"]["proj"].shape == (128, 64)
    assert tp["mtp"]["block"]["ffn"]["wi_gate"].shape == (64, 128)
    assert tp["mtp"]["block"]["attn"]["kv_norm"]["scale"].dtype == \
        torch.float32
    assert tp["seg1"][0]["attn"]["wk_b"].dtype == torch.bfloat16
    assert [(s.kind, s.count) for s in tm.plan] == [("dense_lead", 1),
                                                     ("moe", 1)]


def test_forward_logits_match_jax():
    jm, jp, tm, tp = _models()
    tokens = _tokens((2, 32), tm.cfg.vocab)
    want, _, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-2


def test_teacher_forced_decode_matches_jax():
    jm, jp, tm, tp = _models()
    b, s, pre = 2, 20, 8
    tokens = _tokens((b, s), tm.cfg.vocab, seed=2)
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache)
    tcache = tm.init_cache(b, s, "cpu")
    assert tcache["seg0"][0]["kv"]["ckv"].shape == (b, s, 16)
    tt = torch.from_numpy(tokens)
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache), jlogits) <= 2e-2
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert _rel(got, jlogits) <= 3e-2, i


def test_decode_matches_own_forward():
    """Prefill then decode steps through the latent cache against the
    port's forward on the whole sequence, position by position."""
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


def test_serve_main_v3_on_cpu():
    from repro_torch.launch import serve
    toks = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert toks.shape == (2, 4) and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < 256


def test_training_an_mtp_config_is_refused():
    """No longer refused: V3's loss runs, finite and larger than 0.3 x its
    MTP term, and its trainer builds with the MTP head's params as fp32
    masters (tests/test_torch_v3_train.py holds both against JAX)."""
    _, _, tm, tp = _models()
    toks = torch.from_numpy(_tokens((1, 9), tm.cfg.vocab))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss = tm.loss(tp, batch)
    mtp = tm._mtp_loss(tp, batch["tokens"], batch["labels"])
    assert torch.isfinite(loss) and torch.isfinite(mtp) and mtp > 0
    assert loss > 0.3 * mtp
    model, state, _, _ = train.build_trainer(
        tconfigs.get(ARCH, reduced=True), device="cpu")
    assert model.cfg.mtp
    assert state.params["mtp"]["proj"].dtype == torch.float32
