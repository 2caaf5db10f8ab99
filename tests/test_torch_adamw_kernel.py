"""AdamW's multi-tensor kernels (`kernels/adamw.py`, `csrc/adamw.cu`) on
the CPU: the wrapper's launch plan (grouping by dtype, launches within the
kernels' 4 KB parameter tables, the vector and tail split, misaligned
views), the fake-tensor path (shapes only: no build, no launch, no count),
and the CPU path, which gives the same bits as the loop it replaced.  The
kernels themselves run in `tests/test_torch_cuda.py`."""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

import repro_torch.configs as configs
from repro_torch.kernels import adamw as ak
from repro_torch.models import lm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               decay_mask, global_norm)

SRC = Path(ak.__file__).parent / "csrc" / "adamw.cu"
F32, BF16 = torch.float32, torch.bfloat16


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([0-9 <]+);",
                     SRC.read_text())[1]
    a, _, b = expr.partition("<<")
    return int(a) << int(b) if b else int(a)


def test_constants_and_rows_match_the_kernel_source():
    """The wrapper's constants, kinds, flags and row layouts are the
    source's (the library's own are checked again when it is bound)."""
    text = SRC.read_text()
    assert [_const(n) for n in ("kChunk", "kMaxLeaves", "kMaxNormLeaves",
                                "kNormBlocks")] == [
        ak.CHUNK, ak.MAX_LEAVES, ak.MAX_NORM_LEAVES, ak.NORM_BLOCKS]
    assert ak.CHUNK % 4 == 0
    assert "enum Kind { kF32 = 0, kBF16 = 1 };" in text
    assert ak.KINDS == {F32: 0, BF16: 1}
    assert "enum Flag { kDecay = 1, kVector = 2 };" in text
    assert (ak.DECAY, ak.VECTOR) == (1, 2)
    assert ak.UPDATE_ROW.itemsize == 48 and ak.NORM_ROW.itemsize == 24
    assert "sizeof(UpdateRow) == 48" in text
    assert "sizeof(NormRow) == 24" in text


def _table_bytes(leaves: int, pointers: int) -> int:
    """csrc/adamw.cu's UpdateTable (4 pointers a leaf) or NormTable (1):
    pointers and lengths, chunk starts (one more), flags and the count,
    padded to 8 bytes."""
    raw = leaves * (8 * pointers + 8 + 4 + 1) + 4 + 4
    return -(-raw // 8) * 8


def test_a_launch_fits_in_4kb_of_parameters():
    """An update launch takes its table, the 9 hyperparameters and the
    scale's pointer; a norm launch its table and the partials' pointer."""
    assert _table_bytes(ak.MAX_LEAVES, 4) + 9 * 4 + 8 <= 4096
    assert _table_bytes(ak.MAX_NORM_LEAVES, 1) + 8 <= 4096


def test_plan_groups_by_dtype_and_cuts_runs():
    keys = [F32, BF16, F32, F32, BF16, F32, F32]
    numels = [5, 7, 0, 3, 1, 2, 9]
    assert ak.plan(keys, numels, 2) == [(F32, [0, 3]), (F32, [5, 6]),
                                        (BF16, [1, 4])]
    assert ak.plan(keys, numels, 64) == [(F32, [0, 3, 5, 6]), (BF16, [1, 4])]
    pairs = [(F32, F32), (BF16, F32), (F32, BF16), (F32, F32)]
    assert ak.plan(pairs, [1, 1, 1, 1], 64) == [
        ((F32, F32), [0, 3]), ((BF16, F32), [1]), ((F32, BF16), [2])]
    assert ak.plan([F32, F32], [0, 0], 64) == []


def _minicpm_params():
    with FakeTensorMode():
        return lm.build(configs.get("minicpm-2b")).init(None, F32,
                                                        device="cpu")


def test_plan_at_minicpm_2b_leaves():
    """MiniCPM-2B's 362 fp32 leaves (2,724,880,896 params): six update
    launches and two norm launches, every leaf once and in order, each
    launch's chunks within an int."""
    ps = pytree.tree_leaves(_minicpm_params())
    numels = [p.numel() for p in ps]
    assert len(ps) == 362 and sum(numels) == 2_724_880_896
    upd = ak.plan([(F32, F32)] * len(ps), numels, ak.MAX_LEAVES)
    norm = ak.plan([F32] * len(ps), numels, ak.MAX_NORM_LEAVES)
    assert [len(i) for _, i in upd] == [64] * 5 + [42]
    assert [len(i) for _, i in norm] == [192, 170]
    for launches in (upd, norm):
        assert [i for _, idx in launches for i in idx] == list(range(362))
        assert all(sum(ak.chunks(numels[i]) for i in idx) < 2**31
                   for _, idx in launches)
    assert ak.chunks(numels[0]) == 17_263   # the tied table, 282,822,912


def _view(dtype, n: int, offset: int) -> torch.Tensor:
    """n elements `offset` elements into a fresh (64-byte aligned) buffer."""
    return torch.arange(offset + n, dtype=dtype)[offset:]


# (param dtype, grad dtype, numel, param offset, grad offset): 4k, 4k + 1,
# 4k + 3 and two-chunk lengths; misaligned views; bf16 aligned at 8 bytes
LEAVES = [(F32, F32, 4096, 0, 0), (F32, F32, 4097, 0, 0),
          (F32, F32, 7, 1, 0), (F32, BF16, 2 * ak.CHUNK + 3, 0, 4),
          (BF16, F32, 1, 0, 0), (BF16, BF16, 1003, 4, 2),
          (F32, F32, 0, 0, 0), (F32, F32, 4, 0, 2), (BF16, BF16, 8, 2, 0),
          (F32, F32, ak.CHUNK, 4, 0)]


def _leaves():
    ps = [_view(pd, n, po) for pd, _, n, po, _ in LEAVES]
    gs = [_view(gd, n, go) for _, gd, n, _, go in LEAVES]
    ms = [torch.zeros(n) for *_, n, _, _ in LEAVES]
    vs = [torch.zeros(n) for *_, n, _, _ in LEAVES]
    return ps, gs, ms, vs


def _aligned(t) -> bool:
    return t.data_ptr() % (4 * t.element_size()) == 0


def test_update_table_vector_and_tail_split():
    """Rows launch by launch: the leaf's pointers and length, its first
    chunk within the launch, DECAY from the mask, VECTOR where every
    pointer allows 4 elements a load; the kernel then walks the first n -
    n % 4 elements four at a time and the rest one at a time (all of them
    one at a time without VECTOR)."""
    ps, gs, ms, vs = _leaves()
    decay = [i % 3 != 0 for i in range(len(ps))]
    launches = ak.plan([(p.dtype, g.dtype) for p, g in zip(ps, gs)],
                       [p.numel() for p in ps], 2)
    rows, spans = ak.update_table(ps, gs, ms, vs, decay, launches)
    spans = spans.reshape(-1, 4)
    assert len(rows) == sum(1 for *_, n, _, _ in LEAVES if n)
    for (key, idx), (first, count, pk, gk) in zip(launches, spans):
        assert count == len(idx) <= 2
        assert (pk, gk) == (ak.KINDS[key[0]], ak.KINDS[key[1]])
        c = 0
        for r, i in zip(rows[first:first + count], idx):
            p, g, m, v = ps[i], gs[i], ms[i], vs[i]
            assert (r["p"], r["g"], r["m"], r["v"]) == (
                p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
            assert r["n"] == p.numel() and r["chunk0"] == c
            vec = all(_aligned(t) for t in (p, g, m, v))
            assert r["flags"] == (ak.DECAY * decay[i]) | (ak.VECTOR * vec)
            c += ak.chunks(p.numel())
    flags = {i: int(r["flags"]) & ak.VECTOR
             for (_, idx), (first, n, *_) in zip(launches, spans)
             for i, r in zip(idx, rows[first:first + n])}
    # misaligned: fp32 one element in, bf16 two elements (4 bytes) in
    assert [bool(flags[i]) for i in (0, 1, 2, 3, 4, 5, 7, 8, 9)] == [
        True, True, False, True, True, False, False, False, True]


def test_norm_table_groups_grads_by_dtype():
    _, gs, _, _ = _leaves()
    launches = ak.plan([g.dtype for g in gs], [g.numel() for g in gs],
                       ak.MAX_NORM_LEAVES)
    rows, spans = ak.norm_table(gs, launches)
    spans = spans.reshape(-1, 3)
    assert [(k, len(i)) for k, i in launches] == [(F32, 6), (BF16, 3)]
    assert spans.tolist() == [[0, 6, 0], [6, 3, 1]]
    for (_, idx), (first, count, _) in zip(launches, spans):
        chunk0 = np.cumsum([0] + [ak.chunks(gs[i].numel()) for i in idx])
        got = rows[first:first + count]
        assert got["chunk0"].tolist() == chunk0[:-1].tolist()
        assert got["g"].tolist() == [gs[i].data_ptr() for i in idx]
        assert got["flags"].tolist() == [ak.VECTOR * _aligned(gs[i])
                                         for i in idx]


def _fake_state(dtypes, shapes):
    ps = [torch.empty(s, dtype=d, device="cuda") for d, s in
          zip(dtypes, shapes)]
    params = {"embed": {"table": ps[0]}, "ln_f": {"scale": ps[1]},
              "seg0": [{"w": p} for p in ps[2:]]}
    return adamw_init(params)


def test_fake_cuda_tensors_allocate_only(monkeypatch):
    """On fake CUDA tensors (the dry run) the update and the norm check and
    allocate, and build, launch and count nothing; the norm is a 0-d
    float32 on the device."""
    monkeypatch.setattr(ak, "_lib", lambda: pytest.fail("built a kernel"))
    before = (ak.adamw.launches, ak.adamw.leaves, ak.global_norm.launches)
    with FakeTensorMode():
        state = _fake_state([F32, F32, BF16, F32],
                            [(300, 64), (64,), (64, 96), (5,)])
        grads = pytree.tree_map(lambda p: torch.empty_like(p), state.params)
        state = adamw_update(state, grads, AdamWConfig())
        norm = global_norm(grads)
    assert state.step == 1
    assert norm.shape == () and norm.dtype == F32
    assert norm.device.type == "cuda"
    assert (ak.adamw.launches, ak.adamw.leaves,
            ak.global_norm.launches) == before


@pytest.mark.parametrize("what", ["param_fp16", "grad_fp64", "m_bf16",
                                  "param_transposed"])
def test_fake_cuda_tensors_the_kernels_do_not_take_raise(what):
    with FakeTensorMode():
        state = _fake_state([F32, F32, F32], [(8, 16), (16,), (16, 8)])
        grads = pytree.tree_map(lambda p: torch.empty_like(p), state.params)
        if what == "param_fp16":
            state.params["ln_f"]["scale"] = torch.empty(
                16, dtype=torch.float16, device="cuda")
        elif what == "grad_fp64":
            grads["ln_f"]["scale"] = torch.empty(16, dtype=torch.float64,
                                                 device="cuda")
        elif what == "m_bf16":
            state.mu["ln_f"]["scale"] = torch.empty(16, dtype=BF16,
                                                    device="cuda")
        else:
            state.params["seg0"][0]["w"] = torch.empty(
                (16, 8), device="cuda").t()
        with pytest.raises(ValueError, match="adamw"):
            adamw_update(state, grads, AdamWConfig())


# ---------------------------------------------------------------------------
# The CPU path: the same bits as the loop the kernels replaced
# ---------------------------------------------------------------------------

def _old_global_norm(tree) -> torch.Tensor:
    return torch.stack([x.float().square().sum()
                        for x in pytree.tree_leaves(tree)]).sum().sqrt()


def _old_adamw_update(state, grads, cfg, grad_transform=None):
    if grad_transform is not None:
        grads = grad_transform(grads)
    flat_g = pytree.tree_leaves(grads)
    scale = torch.clamp(cfg.clip_norm / (_old_global_norm(flat_g) + 1e-9),
                        max=1.0)
    step = state.step + 1
    lr = float(cfg.schedule(step)) if cfg.schedule else 3e-4
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    flat_p = pytree.tree_leaves(state.params)
    with torch.no_grad():
        for p, g, m, v, decay in zip(flat_p, flat_g,
                                     pytree.tree_leaves(state.mu),
                                     pytree.tree_leaves(state.nu),
                                     decay_mask(state.params), strict=True):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / b1c) / ((v / b2c).sqrt() + cfg.eps)
            p32 = p.float()
            if decay:
                delta = delta + cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
    state.step = step
    return state


def _halve(grads):
    return pytree.tree_map(lambda g: g * 0.5, grads)


@pytest.mark.parametrize("dtype,transform", [(F32, None), (BF16, None),
                                             (F32, _halve)])
def test_cpu_update_and_norm_give_the_old_loops_bits(dtype, transform):
    """Three updates of reduced TinyLlama's params (fp32 or bf16 matmul
    weights, fp32 norm scales) with the clip engaged, idle and engaged,
    through `adamw_update` and through the loop it replaced: params, m, v
    and step bitwise equal, and `global_norm` bitwise the old norm."""
    model = lm.build(configs.get("tinyllama-1.1b", reduced=True))
    cfg = AdamWConfig(schedule=lambda s: 1e-3 * s)
    states = [adamw_init(model.init(torch.Generator().manual_seed(0), dtype))
              for _ in range(2)]
    gen = torch.Generator().manual_seed(1)
    before = (ak.adamw.launches, ak.adamw.leaves, ak.global_norm.launches)
    for size in (1.0, 1e-4, 3.0):
        grads = pytree.tree_map(
            lambda p: (size * torch.randn(p.shape, generator=gen)).to(
                p.dtype), states[0].params)
        assert torch.equal(global_norm(grads), _old_global_norm(grads))
        assert (_old_global_norm(grads).item() > 1.0) == (size > 1e-3)
        adamw_update(states[0], grads, cfg, transform)
        _old_adamw_update(states[1], grads, cfg, transform)
    assert states[0].step == states[1].step == 3
    for field in ("params", "mu", "nu"):
        for a, b in zip(pytree.tree_leaves(getattr(states[0], field)),
                        pytree.tree_leaves(getattr(states[1], field)),
                        strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b), field
    assert (ak.adamw.launches, ak.adamw.leaves,
            ak.global_norm.launches) == before


def test_launch_range_is_an_op_only_while_profiling():
    """The launches' host range: nothing without a profiler; under one a
    function-scope op of its name, nested in the caller's ranges (so the
    benchmark's span around `adamw_update` owns the kernels' time)."""
    assert isinstance(ak.launch_range("adamw_update"),
                      contextlib.nullcontext)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("pb:adamw_update#0"):
            with ak.launch_range("adamw_update"):
                torch.zeros(4).add_(1)
    evs = {e.name: e for e in prof.events()}
    assert evs["adamw_update"].cpu_parent.name == "pb:adamw_update#0"
    assert "aten::add_" in [c.name for c in evs["adamw_update"].cpu_children]
