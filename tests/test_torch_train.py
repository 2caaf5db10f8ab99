"""The port's training path against the JAX package's, on the CPU.

Both sides get the same numpy-seeded inputs (and, for the LM, the JAX
`model.init` params carried over by `params_from_jax(..., dtype=float32)`,
the fp32 masters).  The JAX side runs its non-Pallas paths: naive attention
below 2048 query positions and the jnp custom-VJP `flash_attention_ref`
from there.  The port's CUDA kernels run only on a GPU
(tests/test_torch_cuda.py); here the wrappers run their plain twins.

Tolerances:
  * attention gradients: fp32 2e-5, bf16 2e-2 (relative max), the kernel
    bars; fp32 differences measure ~1e-6 (summation order);
  * LM loss within 1e-3 relative, gradient leaves within 5e-2 relative L2:
    activations are bf16 in both packages and round at other places.  The
    port's own gradients move by up to 2.0 % (relative L2) between bf16
    and fp32 activations on reduced TinyLlama, and the JAX ones differ
    from the port's by up to 2.3 % on these configs;
  * the optimizer alone (same fp32 grads): 1e-6 relative;
  * schedules: 1e-6 relative (both fp32).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref as jref
from repro.launch import specs as jspecs
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro_torch import optim as topt
from repro_torch.convert import params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import lm as tlm
from repro_torch.optim import schedules as tsched

DENSE = ["tinyllama-1.1b", "qwen3-14b", "gemma-7b", "minicpm-2b",
         "chameleon-34b"]
# Gemma-7B's block at head dim 256, narrow and shallow, as
# tests/test_torch_serve.py builds it: GeGLU, tied embeddings, sqrt(d)
# embedding scale and logit cap 30 from its reduced config, two heads of 256
GEMMA_HD256 = dict(name="gemma-hd256-smoke", n_layers=2, d_model=512,
                   n_heads=2, n_kv_heads=2, head_dim=256, d_ff=1024,
                   vocab=512)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normals(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel_max(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1e-30, np.abs(want).max()))


def _rel_l2(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want)
                 / max(1e-30, np.linalg.norm(want)))


def _flat(tree, prefix="") -> dict:
    """{"/a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _stacked(tree: dict) -> dict:
    """The port's per-layer lists stacked along a leading layer axis, as
    the JAX package keeps a segment."""
    return {k: pytree.tree_map(lambda *xs: torch.stack(xs), *v)
            if k.startswith("seg") else v for k, v in tree.items()}


def _batch(vocab, shape, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (shape[0],
                                                           shape[1] + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jb, tb


def _config(package, arch, n_layers=None):
    """`arch`'s reduced config from `package` (the JAX or the port's
    configs), or the Gemma-shaped hd-256 config for "gemma-hd256"; with
    `n_layers` layers where given."""
    cfg = (dataclasses.replace(package.get("gemma-7b", reduced=True),
                               **GEMMA_HD256)
           if arch == "gemma-hd256" else package.get(arch, reduced=True))
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


@functools.lru_cache(maxsize=None)
def _jax_model(arch, n_layers=None):
    jm = jlm.build(_config(jconfigs, arch, n_layers))
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0))


def _port(arch, jp, n_layers=None, remat="none"):
    cfg = _config(tconfigs, arch, n_layers)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return tlm.build(cfg, remat=remat), tp


def _port_grads(tm, tp, tb):
    """(loss, grads) as the train step takes them: a leaf with no path to
    the loss (the MoE router bias) gets zeros, as under
    `jax.value_and_grad`."""
    leaves, spec = pytree.tree_flatten(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss, pytree.tree_unflatten(list(grads), spec)


# ---------------------------------------------------------------------------
# Loss and attention gradients
# ---------------------------------------------------------------------------


def test_cross_entropy_matches_jax():
    (logits,) = _normals([(2, 8, 50)])
    logits *= 3
    labels = np.random.default_rng(2).integers(0, 50, (2, 8))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


@pytest.mark.parametrize("dtype", list(DT))
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 300, 0), (True, None, 128)])
def test_flash_vjp_matches_jax(dtype, causal, window, q_offset):
    """The plain flash Function's gradients against `jax.vjp` of the
    reference's custom VJP at whole blocks (Sq = Skv = 2048, block 512)."""
    jd, td = DT[dtype]
    q, k, v, do = _normals([(1, 2048, 2, 16)] * 4)
    jfn = jax.jit(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, 512, causal, window, q_offset, None))
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x).astype(jd) for x in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jd))
    ts = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*ts, 512, causal, window, q_offset)
    out.backward(torch.from_numpy(do).to(td))
    assert _rel_max(out, jout) <= TOL[dtype]
    for t, w in zip(ts, want):
        assert t.grad.dtype == td
        assert _rel_max(t.grad, w) <= TOL[dtype]


@pytest.mark.parametrize("impl", ["flash_attention_ref", "FlashAttention"])
def test_flash_grads_at_ragged_kv_match_naive(impl):
    """Ragged Skv (700 = 2 x 256 + 188), where the JAX VJP raises (R8):
    the plain Function and the kernel Function (its plain twins on the
    CPU) against autograd of naive attention, with a window and q_offset."""
    q, k, v, do = _normals([(1, 600, 2, 32), (1, 700, 2, 32),
                            (1, 700, 2, 32), (1, 600, 2, 32)], seed=3)
    fns = {"flash_attention_ref": lambda a, b, c: ref.flash_attention_ref(
               a, b, c, 256, True, 200, 100),
           "FlashAttention": lambda a, b, c: fa.FlashAttention.apply(
               a, b, c, True, 200, 100, None),
           "naive": lambda a, b, c: ref.naive_attention(
               a, b, c, causal=True, window=200, q_offset=100)}
    grads = {}
    for name in (impl, "naive"):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        fns[name](*ts).backward(torch.from_numpy(do))
        grads[name] = [t.grad for t in ts]
    for got, want in zip(grads[impl], grads["naive"]):
        assert _rel_max(got, want.numpy()) <= 2e-5


def test_jax_flash_vjp_raises_at_ragged_kv():
    """R8: the reference's VJP walks skv // block_k blocks and reshapes
    their dk / dv to k.shape, so it raises where Skv % block_k != 0."""
    x = jnp.ones((1, 10, 1, 8), jnp.float32)
    with pytest.raises(TypeError, match="reshape"):
        jax.grad(lambda q: jref.flash_attention_ref(q, x, x, 4).sum())(x)


def test_flash_lse_matches_jax_residuals():
    """The plain forward's lse is the reference VJP's m + log(max(l,
    1e-30))."""
    q, k, v = _normals([(1, 300, 2, 16)] * 3, seed=4)
    _, (m, l) = jref._flash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                                block_k=100, causal=True, window=None,
                                q_offset=0, scale=0.25)
    want = m + jnp.log(jnp.maximum(l, 1e-30))
    _, lse = ref.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), 100,
                           True, None, 0, 0.25)
    assert _rel_max(lse, want) <= 1e-6


def test_flash_function_without_grad_saves_nothing():
    """`FlashAttention.apply(..., grad=False)`, as ops.attention calls it
    where no gradient can reach (serving): the same output as with
    grad=True, no tensor saved, and a backward through it raises."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _normals([(1, 300, 2, 16)] * 3, seed=5))
    want = fa.FlashAttention.apply(q, k, v, True, None, 0, None, True)
    assert len(want.grad_fn.saved_tensors) == 5
    got = fa.FlashAttention.apply(q, k, v, True, None, 0, None, False)
    assert got.grad_fn.saved_tensors == ()
    assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="grad=False"):
        got.sum().backward()


def test_flash_function_under_checkpoint():
    """`FlashAttention` inside `torch.utils.checkpoint(use_reentrant=False)`,
    as remat="full" runs it on the card: the same gradients as without
    (exactly: the recompute runs the same plain twin on the CPU)."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _normals([(1, 300, 2, 16)] * 4, seed=6))
    grads = []
    for remat in (False, True):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        fn = lambda a, b, c: fa.FlashAttention.apply(a, b, c, True, None,
                                                     0, None, True)
        out = (torch.utils.checkpoint.checkpoint(fn, *ts, use_reentrant=False)
               if remat else fn(*ts))
        out.backward(do)
        grads.append([t.grad for t in ts])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_cpu_paths_carry_gradients():
    """On the CPU the wrappers run their plain twins, which autograd
    differentiates: ops.attention at FLASH_THRESHOLD, ops.rwkv_mix."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _normals([(1, ops.FLASH_THRESHOLD, 1, 16)] * 3))
    ops.attention(q, k, v).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    r, kk, vv = (0.5 * torch.from_numpy(x)
                 for x in _normals([(1, 8, 2, 16)] * 3, seed=8))
    w = torch.full((1, 8, 2, 16), 0.9)
    u = torch.zeros(2, 16, requires_grad=True)
    y, s = ops.rwkv_mix(r, kk, vv, w, u)
    (y.sum() + s.sum()).backward()
    assert u.grad is not None and torch.isfinite(u.grad).all()


# ---------------------------------------------------------------------------
# The LM's loss and gradients
# ---------------------------------------------------------------------------


def _check_grads(arch, n_layers, shape):
    """The port's loss within 1e-3 and each gradient leaf within 5e-2
    relative L2 of `jax.value_and_grad(model.loss)`; returns the two
    gradients as {"/path": leaf} (the port's torch, JAX's numpy)."""
    jm, jp = _jax_model(arch, n_layers)
    jb, tb = _batch(jm.cfg.vocab, shape)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tm, tp = _port(arch, jp, n_layers)
    loss, grads = _port_grads(tm, tp, tb)
    assert abs(loss.item() - float(jloss)) <= 1e-3 * abs(float(jloss))
    want = _flat(jax.tree.map(np.asarray, jgrads))
    got = _flat(_stacked(grads))
    assert got.keys() == want.keys()
    for name in want:
        assert _rel_l2(got[name], want[name]) <= 5e-2, name
    return got, want


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_jax(arch):
    """`LM.loss` + backward against `jax.value_and_grad(model.loss)` on
    the reduced dense configs (batch 2 x 32, naive attention)."""
    _check_grads(arch, None, (2, 32))


def test_one_layer_at_seq_2048_matches_jax():
    """One block at 2048 positions, so both sides differentiate their
    chunked flash attention inside the LM."""
    _check_grads("tinyllama-1.1b", 1, (1, 2048))


def test_gemma_hd256_layer_at_seq_2048_matches_jax():
    """One Gemma-shaped block at head dim 256 (GEMMA_HD256) at 2048
    positions: the flash VJP at the head dim Gemma-7B trains with, inside
    the LM (GeGLU, tied embeddings, logit cap), against
    `jax.value_and_grad(model.loss)` with the bars above."""
    _check_grads("gemma-hd256", 1, (1, 2048))


def test_build_trainer_steps_a_depth_cut_config():
    """What chip_smoke.py does with Gemma-7B, on the CPU at small width:
    `dataclasses.replace(cfg, n_layers=...)` of a Gemma config (here the
    hd-256 one) through `build_trainer(..., device="cpu")`, one step at
    2048 positions (the flash path, its plain twins here).  The step
    reports the loss of the initial params (`model.loss` on the same batch,
    within 1e-6 relative: the same computation), finite, and moves the
    params to finite values."""
    cfg = _config(tconfigs, "gemma-hd256", n_layers=1)
    model, state, step, _ = ttrain.build_trainer(cfg, device="cpu")
    assert model.cfg.n_layers == 1 and len(state.params["seg0"]) == 1
    table = state.params["embed"]["table"].detach().clone()
    _, tb = _batch(cfg.vocab, (1, 2048))
    with torch.no_grad():
        want = model.loss(state.params, tb).item()
    state, metrics = step(state, tb)
    assert state.step == 1 and np.isfinite(want)
    assert abs(metrics["loss"].item() - want) <= 1e-6 * abs(want)
    assert all(torch.isfinite(p).all()
               for p in pytree.tree_leaves(state.params))
    assert not torch.equal(state.params["embed"]["table"], table)


def test_hymba_loss_and_grads_match_jax():
    """The reduced hybrid (hymba-1.5b: layers 0 and 2 global, layer 1 with
    its 16-token window; the SSM's scan the plain loop here, the JAX
    block's `lax.scan` there) against `jax.value_and_grad(model.loss)` at
    batch 2 x 32, with the bars above."""
    _check_grads("hymba-1.5b", None, (2, 32))


def test_hymba_two_layers_at_seq_2048_match_jax():
    """Two reduced hybrid layers at 2048 positions, layer 0 global and
    layer 1 windowed (16 keys), so both sides differentiate their chunked
    flash attention, global and windowed, beside the scan inside the LM."""
    _check_grads("hymba-1.5b", 2, (1, 2048))


def test_hymba_trains_on_the_cpu(tmp_path):
    """`build_trainer` on the reduced hybrid: every leaf's gradient (the
    SSM's a_log, d_skip and conv among them) finite and nonzero, one step
    with a finite loss that moves the params; then the train CLI at
    `--reduced --device cpu --steps 2`: two finite losses."""
    cfg = tconfigs.get("hymba-1.5b", reduced=True)
    model, state, step, _ = ttrain.build_trainer(cfg, device="cpu")
    _, tb = _batch(cfg.vocab, (2, 32))
    tp = pytree.tree_map(lambda t: t.detach().clone(), state.params)
    _, grads = _port_grads(model, tp, tb)
    for name, g in _flat(_stacked(grads)).items():
        assert torch.isfinite(g).all() and torch.count_nonzero(g) > 0, name
    a_log = state.params["seg0"][0]["ssm"]["a_log"].detach().clone()
    state, metrics = step(state, tb)
    assert state.step == 1 and np.isfinite(metrics["loss"].item())
    assert not torch.equal(state.params["seg0"][0]["ssm"]["a_log"], a_log)
    losses = ttrain.main(["--arch", "hymba-1.5b", "--reduced", "--device",
                          "cpu", "--steps", "2", "--batch", "2", "--seq",
                          "32", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads_equal_no_remat(remat):
    jm, jp = _jax_model("tinyllama-1.1b")
    _, tb = _batch(jm.cfg.vocab, (1, 2048), seed=5)
    want = _port_grads(*_port("tinyllama-1.1b", jp), tb)
    got = _port_grads(*_port("tinyllama-1.1b", jp, remat=remat), tb)
    assert got[0].item() == want[0].item()
    for g, w in zip(pytree.tree_leaves(got[1]), pytree.tree_leaves(want[1])):
        assert _rel_max(g, w.numpy()) <= 1e-6


def test_lm_rejects_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        tlm.LM(tconfigs.get("tinyllama-1.1b", reduced=True), remat="some")


# ---------------------------------------------------------------------------
# Optimizer, train step, schedules
# ---------------------------------------------------------------------------


LR = 1e-2   # large enough that R9's decay, lr * wd * p, shows at 1e-6


def _lr(step):
    return LR


def _jax_cfg():
    return jopt.AdamWConfig(schedule=_lr)


def _port_cfg():
    return topt.AdamWConfig(schedule=_lr)


def test_decay_mask_follows_the_reference_stacking():
    """R9: the JAX update decays every leaf of a stacked segment (a block's
    norm scale is (L, d) there) and only the top-level 1-D leaves escape."""
    jm, jp = _jax_model("tinyllama-1.1b")
    _, tp = _port("tinyllama-1.1b", jp)
    flat, _ = pytree.tree_flatten_with_path(tp)
    names = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat]
    by_name = dict(zip(names, topt.decay_mask(tp), strict=True))
    assert by_name["ln_f/scale"] is False
    assert by_name["seg0/0/ln_attn/scale"] and by_name["seg0/1/ln_mlp/scale"]
    assert all(by_name[n] for n in by_name if n.startswith("seg0"))
    assert np.asarray(jp["seg0"]["ln_attn"]["scale"]).ndim == 2


def test_adamw_update_matches_jax():
    """Two updates from the same fp32 params and numpy grads (global norm
    above the clip), at 1e-6 relative: clipping, bias correction, the
    decay mask of R9."""
    jm, jp = _jax_model("tinyllama-1.1b")
    _, tp = _port("tinyllama-1.1b", jp)
    rng = np.random.default_rng(6)
    jgrads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), jax.tree.map(np.asarray, jp)) for _ in range(2)]
    jstate = jopt.adamw_init(jp)
    tstate = topt.adamw_init(tp)
    for g in jgrads:
        assert float(jopt.global_norm(g)) > 1.0
        jstate = jopt.adamw_update(jstate, jax.tree.map(jnp.asarray, g),
                                   _jax_cfg())
        tg = params_from_jax(g, "cpu", torch.float32)
        tstate = topt.adamw_update(tstate, tg, _port_cfg())
    assert tstate.step == int(jstate.step) == 2
    for field in ("params", "mu", "nu"):
        want = _flat(jax.tree.map(np.asarray, getattr(jstate, field)))
        got = _flat(_stacked(getattr(tstate, field)))
        for name in want:
            assert _rel_max(got[name], want[name]) <= 1e-6, (field, name)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_jax(accum_steps):
    """One `make_train_step` step (batch 4 x 32) from the same params: the
    loss, the gradient norm, and the params after the update.  The update
    is lr (m / sqrt(v) + wd p), ~lr sign(g) at the first step, and the
    gradients differ at bf16 noise: where a gradient is near 0 its sign may
    differ, and the param moves 2 lr the other way (measured: 0.3-0.4 % of
    the elements, by up to 2.0 lr; every other element within 1e-2 lr).
    So: every element within 2.5 lr, and at most 1 % beyond 1e-2 lr."""
    jm, jp = _jax_model("tinyllama-1.1b")
    jb, tb = _batch(jm.cfg.vocab, (4, 32), seed=7)
    jstep = jax.jit(jopt.make_train_step(jm.loss, _jax_cfg(), accum_steps))
    jstate, jmetrics = jstep(jopt.adamw_init(jp), jb)
    tm, tp = _port("tinyllama-1.1b", jp)
    tstep = topt.make_train_step(tm.loss, _port_cfg(), accum_steps)
    tstate, tmetrics = tstep(topt.adamw_init(tp), tb)
    assert tmetrics["step"] == int(jmetrics["step"]) == 1
    assert (abs(tmetrics["loss"].item() - float(jmetrics["loss"]))
            <= 1e-3 * float(jmetrics["loss"]))
    assert (abs(tmetrics["grad_norm"].item() - float(jmetrics["grad_norm"]))
            <= 5e-2 * float(jmetrics["grad_norm"]))
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(_stacked(tstate.params))
    diffs = np.concatenate([np.abs(got[n].detach().numpy() - want[n]).ravel()
                            for n in want])
    assert diffs.max() <= 2.5 * LR
    assert (diffs > 1e-2 * LR).mean() <= 1e-2


def test_schedules_match_jax():
    steps = [0, 1, 999, 1999, 2000, 2001, 5000, 50_000, 89_999, 95_000,
             100_000, 120_000]
    pairs = [(functools.partial(jsched.cosine, peak=3e-4, warmup=2000,
                                total=100_000),
              functools.partial(tsched.cosine, peak=3e-4, warmup=2000,
                                total=100_000)),
             (functools.partial(jsched.wsd, peak=1e-2, warmup=2000,
                                total=100_000),
              functools.partial(tsched.wsd, peak=1e-2, warmup=2000,
                                total=100_000)),
             (functools.partial(jsched.linear_warmup, warmup=10, peak=1.0),
              functools.partial(tsched.linear_warmup, warmup=10, peak=1.0))]
    for arch in ("tinyllama-1.1b", "minicpm-2b"):
        pairs.append((jspecs.schedule_for(jconfigs.get(arch)),
                      tspecs.schedule_for(tconfigs.get(arch))))
    for jfn, tfn in pairs:
        for s in steps:
            want = float(jfn(jnp.asarray(s, jnp.int32)))
            for arg in (s, torch.tensor(s)):
                got = float(tfn(arg))
                assert abs(got - want) <= 1e-6 * abs(want), (s, got, want)
