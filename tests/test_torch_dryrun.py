"""The port's cells, dry run and roofline (`repro_torch.launch.specs`,
`dryrun`, `roofline`), the kernels' shape functions on fake tensors, and
the fp8 KV cache, against the JAX package where it has a counterpart.

* `build_cell`'s fake arguments, leaf by leaf in shape and dtype, against
  `convert.params_from_jax` of the JAX cell's (`repro.launch.specs.
  build_cell`) on reduced configs;
* `dry_run` on fake CPU tensors against a real CPU run of the same small
  cell (B 2 x S 32: RWKV6's and Hymba's plain twins walk token by token
  on fake CPU tensors): argument bytes, FlopCounterMode totals and the
  MemTracker peak equal;
* the record's keys (the JAX record's, but its HLO size) and the
  long_500k skip;
* the roofline's terms times the peaks against JAX `analyze_record`'s on
  the same record;
* the fp8 (e4m3) cache: teacher-forced decode of reduced TinyLlama and
  Hymba (the ring buffer) against the JAX `LM` with
  `kv_cache_dtype=jnp.float8_e4m3fn`, within the bf16 cache's bars of
  tests/test_torch_serve.py (prefill 2e-2, decode 3e-2 of the largest
  logit): the cache stores the same rounded values on both sides, read
  back upcast.  DeepSeek-V3's latent cache raises in the JAX package
  (R16), so its fp8 run is held to JAX's bf16-cache run within 1e-1;
* the wrappers on fake CUDA tensors (which this CPU build can make): the
  outputs' shapes and dtypes, no launch counted, nothing built.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import wkv6 as wkv
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models import lm as tlm

KINDS = ("train", "prefill", "decode")
SMALL = dict(seq_len=32, global_batch=2)
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.float8_e4m3fn): torch.float8_e4m3fn}


def _shape(kind):
    return ShapeSpec(f"{kind}_small", kind=kind, **SMALL)


def _fake_cell(arch, kind, **kw):
    with FakeTensorMode():
        return specs.build_cell(tconfigs.get(arch, reduced=True),
                                _shape(kind), device="cpu", **kw)


def _meta(tree):
    return [(tuple(t.shape), t.dtype) for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _by_path(tree) -> dict:
    """path -> (shape, dtype) of every tensor leaf (the JAX package sorts
    dict keys, the port keeps their order)."""
    return {pytree.keystr(p): (tuple(t.shape), t.dtype)
            for p, t in pytree.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_cell_params_match_jax_layout(arch, kind):
    """The port's cell params against the JAX cell's, carried by
    `params_from_jax` (fp32 masters for train, the serving layout else);
    the AdamW moments shaped as the params in fp32."""
    jcell = jspecs.build_cell(jconfigs.get(arch, reduced=True),
                              JShape(f"{kind}_small", kind=kind, **SMALL))
    jparams = jcell.abstract_args[0]
    if kind == "train":
        jparams = jparams.params
    want = params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jparams),
        device="cpu", dtype=torch.float32 if kind == "train" else None)
    cell = _fake_cell(arch, kind)
    got = cell.args[0]
    if kind == "train":
        assert _meta(got.mu) == _meta(got.nu) == [
            (s, torch.float32) for s, _ in _meta(got.params)]
        got = got.params
    assert _by_path(got) == _by_path(want)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_cell_cache_matches_jax_layout(arch, kind):
    """The cell's cache against the JAX cell's, one layer of a stacked
    leaf at a time, in shape and dtype; the tokens' shapes."""
    jcell = jspecs.build_cell(jconfigs.get(arch, reduced=True),
                              JShape(f"{kind}_small", kind=kind, **SMALL))
    jcache = jcell.abstract_args[2]
    cell = _fake_cell(arch, kind)
    for path, leaf in pytree.tree_flatten_with_path(cell.args[2])[0]:
        node = jcache
        for k in path:
            if isinstance(k, pytree.SequenceKey):
                continue
            node = node[k.key]
        assert (tuple(leaf.shape), leaf.dtype) == (
            tuple(node.shape[1:]), DTYPES[jnp.dtype(node.dtype)]), path
    assert tuple(cell.args[1].shape) == jcell.abstract_args[1].shape
    if kind == "decode":
        assert cell.args[3] == SMALL["seq_len"] - 1


def _real_run(cell):
    args = [t for t in pytree.tree_leaves(cell.args)
            if isinstance(t, torch.Tensor)]
    tracker = MemTracker()
    tracker.track_external(*args)
    flops = FlopCounterMode(display=False)
    with flops, tracker:
        out = cell.step_fn(*cell.args)
    peak = sum(s["Total"] for s in
               tracker.get_tracker_snapshot("peak").values())
    return out, flops.get_total_flops(), peak


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", jconfigs.all_archs())
def test_dry_run_matches_a_real_run(arch, kind):
    """The dry run of a small reduced cell on fake CPU tensors against the
    same cell run for real on the CPU: equal argument bytes, FLOPs and
    peak (MemTracker on both); the real output finite."""
    cell = _fake_cell(arch, kind)
    rec = dryrun.dry_run(cell)
    real = specs.build_cell(tconfigs.get(arch, reduced=True), _shape(kind),
                            device="cpu")
    arg_bytes = dryrun.tensor_bytes(real.args)
    out, flops, peak = _real_run(real)
    assert rec["memory"]["argument_bytes"] == arg_bytes
    assert rec["cost"]["flops"] == flops > 0
    assert rec["memory"]["peak_bytes"] == peak
    assert rec["memory"]["temp_bytes"] == peak - arg_bytes
    assert rec["memory"]["output_bytes"] == dryrun.tensor_bytes(out)
    loss = out[1]["loss"] if kind == "train" else out
    assert torch.isfinite(loss).all()


def test_dry_run_needs_fake_arguments():
    real = specs.build_cell(tconfigs.get("tinyllama-1.1b", reduced=True),
                            _shape("decode"), device="cpu")
    with pytest.raises(ValueError, match="FakeTensorMode"):
        dryrun.dry_run(real)


def test_build_cell_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        specs.build_cell(tconfigs.get("tinyllama-1.1b", reduced=True),
                         _shape("decode"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("tinyllama-1.1b", "decode_32k", None, reduced=True)


# the JAX record's keys (repro/launch/dryrun.py:228-245) but its HLO size
JAX_KEYS = {"arch", "shape", "mesh", "n_devices", "fsdp", "act_shard",
            "seq_parallel", "remat", "kv_fp8", "status", "lower_s",
            "compile_s", "memory", "cost", "collectives"}


@functools.cache
def _record(arch="tinyllama-1.1b", shape="decode_32k", **kw):
    return dryrun.run_cell(arch, shape, None, reduced=True, device="cpu",
                           **kw)


def test_record_keys_and_long_context_skip(tmp_path):
    rec = _record()
    assert JAX_KEYS <= rec.keys()
    assert (rec["mesh"], rec["n_devices"], rec["status"]) == ("host", 1, "ok")
    assert not (rec["fsdp"] or rec["act_shard"] or rec["seq_parallel"])
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert rec["memory"]["peak_bytes"] == (rec["memory"]["argument_bytes"]
                                           + rec["memory"]["temp_bytes"])
    for part in ("bytes", "counts"):
        assert rec["collectives"][part] == dict.fromkeys(
            dryrun.COLLECTIVE_KINDS, 0)
    assert rec["device"] is None and rec["device_memory_bytes"] is None
    for arch in tconfigs.all_archs():
        cfg = tconfigs.get(arch)
        if cfg.sub_quadratic:
            continue
        skipped = dryrun.run_cell(arch, "long_500k", str(tmp_path),
                                  device="cpu")
        assert skipped["status"] == "skipped(full-attention)"
    assert len(roofline.load_dir(str(tmp_path))) == 8
    long = dryrun.run_cell("rwkv6-3b", "long_500k", str(tmp_path),
                           reduced=True, device="cpu", tag="-r")
    assert long["status"] == "ok"


def test_kv_fp8_record_halves_the_cache():
    bf16, fp8 = _record(), _record(kv_fp8=True)
    assert fp8["kv_fp8"] and not bf16["kv_fp8"]
    cfg = tconfigs.get("tinyllama-1.1b", reduced=True)
    shape = SHAPES["decode_32k"]
    kv = (2 * cfg.n_layers * shape.global_batch * shape.seq_len
          * cfg.n_kv_heads * cfg.head_dim)           # elements of k and v
    assert (bf16["memory"]["argument_bytes"]
            - fp8["memory"]["argument_bytes"]) == kv


@pytest.fixture(scope="module")
def jroofline():
    """The JAX roofline, imported with the R1 alias (its report and tech
    modules come through `repro.core`)."""
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.launch import roofline as jr
    return jr


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "decode_32k"),
                                        ("deepseek-v3-671b", "decode_32k"),
                                        ("rwkv6-3b", "long_500k"),
                                        ("tinyllama-1.1b", "long_500k")])
def test_roofline_terms_match_jax(jroofline, arch, shape):
    rec = _record(arch, shape)
    got, want = roofline.analyze_record(rec), jroofline.analyze_record(rec)
    if rec["status"] != "ok":
        assert got == want
        return
    assert got["compute_s"] * roofline.PEAK_BF16_FLOPS == pytest.approx(
        want["compute_s"] * jroofline.PEAK, rel=1e-12)
    assert got["memory_s"] * roofline.PEAK_BYTES == pytest.approx(
        want["memory_s"] * jroofline.HBM_BW, rel=1e-12)
    assert got["collective_s"] == want["collective_s"] == 0.0
    for k in ("model_flops", "analytic_flops", "useful_ratio",
              "mem_per_dev_gb", "chips"):
        assert got[k] == want[k], k
    assert got["dominant"] == max(("compute", "memory"),
                                  key=lambda t: got[f"{t}_s"])
    assert got["fits_device"] is None


def test_roofline_main_writes_every_row(tmp_path):
    for shape in ("decode_32k", "long_500k"):
        dryrun.run_cell("rwkv6-3b", shape, str(tmp_path), reduced=True,
                        device="cpu")
    dryrun.run_cell("tinyllama-1.1b", "long_500k", str(tmp_path),
                    device="cpu")
    out = tmp_path / "roofline.csv"
    rows = roofline.main(["--dir", str(tmp_path), "--out", str(out)])
    assert [r["status"] for r in rows] == ["ok", "ok",
                                           "skipped(full-attention)"]
    assert "dominant" in out.read_text().splitlines()[0]


# ---------------------------------------------------------------------------
# The fp8 KV cache against the JAX package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch, fp8: bool):
    jm = jlm.build(jconfigs.get(arch, reduced=True))
    if fp8:
        jm.kv_cache_dtype = jnp.float8_e4m3fn
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tlm.build(tconfigs.get(arch, reduced=True),
                   kv_cache_dtype=torch.float8_e4m3fn if fp8
                   else torch.bfloat16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1e-6, np.abs(want).max())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "hymba-1.5b"])
def test_fp8_cache_decode_matches_jax(arch):
    jm, jp, tm, tp = _models(arch, True)
    b, s, pre = 2, 24, 8      # Hymba's reduced window of 16 wraps
    tokens = np.random.default_rng(5).integers(0, tm.cfg.vocab, (b, s))
    jcache = jm.init_cache(b, s)
    jlogits, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :pre]),
                                          jcache)
    tcache = tm.init_cache(b, s, "cpu")
    fp8 = [t for t in pytree.tree_leaves(tcache)
           if t.dtype == torch.float8_e4m3fn]
    assert fp8 and all(
        DTYPES[jnp.dtype(x.dtype)] == torch.float8_e4m3fn
        for x in jax.tree.leaves(jcache) if x.dtype == jnp.float8_e4m3fn)
    tt = torch.from_numpy(tokens)
    assert _rel(tm.prefill(tp, tt[:, :pre], tcache), jlogits) <= 2e-2
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = tm.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert _rel(got, jlogits) <= 3e-2, i
    # the stored values: the same fp8 roundings, up to a bf16 ulp of the
    # values rounded (one e4m3 step, 1/8 relative, where they fall apart)
    for got, want in zip(fp8, [x for x in jax.tree.leaves(jcache)
                               if x.dtype == jnp.float8_e4m3fn]):
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))[0]   # the first layer
        assert np.abs(g - w).max() <= 0.125 * max(1.0, np.abs(w).max())
        break


def test_fp8_latent_cache_where_jax_raises():
    """R16: the JAX MLA contracts bf16 probabilities with the fp8 latent
    cache as it stands (src/repro/models/blocks.py:195), and JAX has
    no implicit promotion for 8-bit floats, so a prefill with an fp8 cache
    raises there.  The port reads the cache upcast to bf16.  Held to the
    JAX package's bf16-cache run instead, within 1e-1 of the largest
    logit: the fp8 roundings alone put TinyLlama's and Hymba's fp8 decode
    7.4e-2 and 6.0e-2 from their bf16-cache JAX runs, while their fp8 runs
    sit within 3e-2 of JAX's fp8 runs (above)."""
    jm8, jp, t8, tp = _models("deepseek-v3-671b", True)
    jm, _, _, _ = _models("deepseek-v3-671b", False)
    b, s, pre = 2, 24, 8
    tokens = np.random.default_rng(5).integers(0, t8.cfg.vocab, (b, s))
    with pytest.raises(ValueError,     # jax's TypePromotionError
                       match="8-bit floats do not support implicit"):
        jm8.prefill(jp, jnp.asarray(tokens[:, :pre]), jm8.init_cache(b, s))
    jlogits, jcache = jax.jit(jm.prefill)(
        jp, jnp.asarray(tokens[:, :pre]), jm.init_cache(b, s))
    tcache = t8.init_cache(b, s, "cpu")
    tt = torch.from_numpy(tokens)
    assert _rel(t8.prefill(tp, tt[:, :pre], tcache), jlogits) <= 1e-1
    step = jax.jit(jm.decode_step)
    for i in range(pre, s):
        jlogits, jcache = step(jp, jnp.asarray(tokens[:, i:i + 1]), jcache,
                               jnp.asarray(i, jnp.int32))
        got = t8.decode_step(tp, tt[:, i:i + 1], tcache, i)
        assert torch.isfinite(got).all()
        assert _rel(got, jlogits) <= 1e-1, i
    assert tcache["seg0"][0]["kv"]["ckv"].dtype == torch.float8_e4m3fn


def test_fp8_cache_is_half_and_prefill_kernel_gets_fresh_kv():
    """The fp8 cache holds half the bf16 cache's bytes; a prefill at the
    flash threshold hands the flash path the fresh bf16 k and v (its
    output equals the bf16-cache model's), never the fp8 cache."""
    _, _, t8, tp = _models("tinyllama-1.1b", True)
    _, _, t16, _ = _models("tinyllama-1.1b", False)
    c8, c16 = t8.init_cache(1, 2048, "cpu"), t16.init_cache(1, 2048, "cpu")
    assert 2 * dryrun.tensor_bytes(c8) == dryrun.tensor_bytes(c16)
    seen = []
    plain = fa.flash_attention_plain

    def spy(q, k, v, **kw):
        seen.append((k.dtype, v.dtype))
        return plain(q, k, v, **kw)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, t8.cfg.vocab, (1, 2048)))
    fa.flash_attention_plain = spy
    try:
        got = t8.prefill(tp, tokens, c8)
        want = t16.prefill(tp, tokens, c16)
    finally:
        fa.flash_attention_plain = plain
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The kernels' shape functions on fake CUDA tensors
# ---------------------------------------------------------------------------


def _no_build(name):
    raise AssertionError(f"a shape function asked to build {name}")


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(build, "library", _no_build)
    counts = {}
    for fn in (fa.flash_attention, fa.flash_attention_bwd, wkv.wkv6,
               wkv.wkv6_bwd, ss.selective_scan, ss.selective_scan_bwd):
        for attr in ("launches", "launches_mla"):
            if hasattr(fn, attr):
                counts[(fn, attr)] = getattr(fn, attr)
    with FakeTensorMode():
        yield lambda *shape, dtype=torch.bfloat16: torch.empty(
            shape, dtype=dtype, device="cuda")
    assert {k: getattr(*k) for k in counts} == counts


def test_flash_shape_functions(fake_cuda):
    q, k, v = (fake_cuda(2, 64, 4, 64) for _ in range(3))
    out = fa.FlashAttention.apply(q, k, v, True, None, 0, None, False)
    assert (out.shape, out.dtype, out.device.type) == (
        (2, 64, 4, 64), torch.bfloat16, "cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, want_lse=True)
    assert lse.shape == (2, 4, 64) and lse.dtype == torch.float32
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, o, lse)
    assert dq.shape == dk.shape == dv.shape == (2, 64, 4, 64)
    # the MLA layout, v a view of k: dV summed into dK
    qm, km = fake_cuda(1, 64, 16, 576), fake_cuda(1, 80, 1, 576)
    vm = km.narrow(-1, 0, 512)   # slicing a fake CUDA tensor needs CUDA here
    assert fa.v_in_k(km, vm) and not fa.v_in_k(km, fake_cuda(1, 80, 1, 512))
    om, lm = fa.flash_attention_fwd(qm, km, vm, want_lse=True)
    assert om.shape == (1, 64, 16, 512)
    dq, dk, dv = fa.flash_attention_bwd(qm, km, vm, om, om, lm,
                                        dv_into_dk=True)
    assert dk.shape == km.shape and dv is None
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(fake_cuda(1, 8, 2, 48), fake_cuda(1, 8, 2, 48),
                               fake_cuda(1, 8, 2, 48))


def test_mla_bwd_scratch():
    """The library's count (csrc/flash_attention_bwd.cu:2391) as the
    shape function reckons it: (576 + 512) floats a head group and key,
    576 in bf16 with dV summed into dK."""
    assert fa.mla_bwd_scratch(1, 128, 2048, torch.bfloat16, True) == \
        8 * 2048 * 576
    assert fa.mla_bwd_scratch(4, 20, 333, torch.float32, True) == \
        4 * 2 * 333 * 1088
    assert fa.mla_bwd_scratch(4, 20, 333, torch.bfloat16, False) == \
        4 * 2 * 333 * 1088


def test_wkv6_and_scan_shape_functions(fake_cuda):
    r, k, v, w = (fake_cuda(2, 40, 3, 64, dtype=torch.float32)
                  for _ in range(4))
    u = fake_cuda(3, 64, dtype=torch.float32)
    y, s_final, ckpt = wkv.wkv6_fwd(r, k, v, w, u, want_ckpt=True)
    assert (y.shape, s_final.shape, ckpt.shape) == (
        (2, 40, 3, 64), (2, 3, 64, 64), (2, 3, 2, 64, 64))
    grads = wkv.wkv6_bwd(r, k, v, w, u, None, y, None, ckpt)
    assert [g.shape for g in grads] == [r.shape] * 4 + [u.shape,
                                                        s_final.shape]
    dt, uu = (fake_cuda(2, 200, 64, dtype=torch.float32) for _ in range(2))
    b, c = (fake_cuda(2, 200, 16, dtype=torch.float32) for _ in range(2))
    a = fake_cuda(64, 16, dtype=torch.float32)
    y, h, ck = ss.selective_scan_fwd(dt, uu, b, c, a, want_ckpt=True)
    assert (y.shape, h.shape, ck.shape) == ((2, 200, 64), (2, 64, 16),
                                            (2, 13, 64, 16))
    grads = ss.selective_scan_bwd(dt, uu, b, c, a, None, y, None, ck)
    assert [g.shape for g in grads] == [dt.shape, dt.shape, b.shape,
                                        c.shape, a.shape, h.shape]


def test_serve_batched_example_on_cpu(monkeypatch, capsys):
    """examples/torch_serve_batched.py: reduced Qwen3-14B through
    `repro_torch.launch.serve.main`, here with --device cpu."""
    import runpy
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / \
        "torch_serve_batched.py"
    monkeypatch.setattr("sys.argv", [str(path), "--device", "cpu"])
    runpy.run_path(str(path), run_name="__main__")
    out = capsys.readouterr().out
    assert "generated (4, 16) tokens" in out and "on cpu" in out
