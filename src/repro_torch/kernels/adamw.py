"""AdamW and its global-norm clipping: the hand-written multi-tensor CUDA
kernels, their wrappers and their plain twins.

The kernels (`csrc/adamw.cu`, see its header for the design and the bound)
replace the loop of `optim.optimizer.adamw_update` (~15 elementwise kernels
a leaf) and `global_norm` (two a leaf) with a few launches: the leaves are
grouped by dtype and cut into launches of at most MAX_LEAVES leaves
(MAX_NORM_LEAVES for the norm), each leaf into chunks of CHUNK elements.
The norm is two passes with no atomics (the same inputs give the same
bits); the update reads the clip scale from the norm's device buffer, so
the step never waits for the device.

Each wrapper dispatches on its tensors: on CPU tensors the plain twin
(`adamw_plain`, `global_norm_plain`: the loop the port ran before the
kernels, op for op); on CUDA tensors the kernels, or a ValueError for what
they do not take (a dtype other than float32 or bfloat16, m or v not
float32, a param, m or v that is not contiguous); on fake tensors (the dry
run) the kernels' shape function: checks and scratch allocations, then no
build, pointer or launch, and no count.

Counters: `global_norm.launches` and `adamw.launches` count kernel
launches (a norm is its pass-1 launches plus one); `adamw.leaves` counts
the leaves the kernels updated (on CUDA, every leaf of every update).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import build

# kChunk, kMaxLeaves, kMaxNormLeaves and kNormBlocks in csrc/adamw.cu
CHUNK = 1 << 14
MAX_LEAVES = 64
MAX_NORM_LEAVES = 192
NORM_BLOCKS = 1024
# csrc/adamw.cu's Kind and Flag
KINDS = {torch.float32: 0, torch.bfloat16: 1}
DECAY, VECTOR = 1, 2
# csrc/adamw.cu's UpdateRow and NormRow
UPDATE_ROW = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"),
                       ("v", "<u8"), ("n", "<i8"), ("chunk0", "<i4"),
                       ("flags", "<i4")])
NORM_ROW = np.dtype([("g", "<u8"), ("n", "<i8"), ("chunk0", "<i4"),
                     ("flags", "<i4")])


def bind(lib: ctypes.CDLL):
    """(adamw_norm, adamw_update, adamw_error_string) of a library built
    from `csrc/adamw.cu`, with their ctypes signatures; raises if its
    constants are not this module's."""
    got = (ctypes.c_int * 4)()
    lib.adamw_constants.argtypes = [ctypes.c_void_p]
    lib.adamw_constants(got)
    want = (CHUNK, MAX_LEAVES, MAX_NORM_LEAVES, NORM_BLOCKS)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/adamw.cu's constants {tuple(got)} are not "
                           f"the wrapper's {want}")
    norm = lib.adamw_norm
    norm.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p]
    norm.restype = ctypes.c_int
    update = lib.adamw_update
    update.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_float] * 9
                       + [ctypes.c_void_p, ctypes.c_void_p])
    update.restype = ctypes.c_int
    lib.adamw_error_string.argtypes = [ctypes.c_int]
    lib.adamw_error_string.restype = ctypes.c_char_p
    return norm, update, lib.adamw_error_string


@functools.cache
def _lib():
    return bind(build.library("adamw"))


def plan(keys: list, numels: list[int], per_launch: int) -> list:
    """The launches for leaves of these keys (a dtype, or a pair of them)
    and element counts: [(key, [leaf index, ...]), ...], the leaves of one
    key in their order cut into runs of at most `per_launch`, keys in the
    order they first appear; leaves with no elements are left out."""
    groups: dict = {}
    for i, (key, n) in enumerate(zip(keys, numels, strict=True)):
        if n:
            groups.setdefault(key, []).append(i)
    return [(key, idx[j:j + per_launch]) for key, idx in groups.items()
            for j in range(0, len(idx), per_launch)]


def chunks(n: int) -> int:
    return -(-n // CHUNK)


def _vector(ptrs: tuple, ts: tuple) -> int:
    """VECTOR where the kernels may walk these tensors (at these addresses)
    four elements at a time: every address a multiple of 4 elements (16
    bytes in float32, 8 in bfloat16); else 0."""
    return VECTOR if all(a % (4 * t.element_size()) == 0
                         for a, t in zip(ptrs, ts)) else 0


def _rows(launches: list, fields) -> tuple[list, list]:
    """(rows, [(first row, rows), ...]): `fields(i, chunk0)` gives leaf i's
    row, chunk0 its first chunk within its launch."""
    rows, spans = [], []
    for _, idx in launches:
        spans.append((len(rows), len(idx)))
        c = 0
        for i in idx:
            n, row = fields(i, c)
            rows.append(row)
            c += chunks(n)
    return rows, spans


def norm_table(gs: list, launches: list) -> tuple[np.ndarray, np.ndarray]:
    """The norm's rows (NORM_ROW) and its launches (first row, rows, grad
    kind) for `plan`'s launches over `gs`."""
    def fields(i, c):
        g = gs[i]
        ptr, n = g.data_ptr(), g.numel()
        return n, (ptr, n, c, _vector((ptr,), (g,)))
    rows, spans = _rows(launches, fields)
    return (np.array(rows, dtype=NORM_ROW),
            np.array([(a, n, KINDS[key]) for (key, _), (a, n)
                      in zip(launches, spans)], dtype=np.int32).reshape(-1))


def update_table(ps, gs, ms, vs, decay, launches) -> tuple:
    """The update's rows (UPDATE_ROW) and its launches (first row, rows,
    param kind, grad kind) for `plan`'s launches."""
    def fields(i, c):
        p, g, m, v = ts = ps[i], gs[i], ms[i], vs[i]
        ptrs = p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr()
        n = p.numel()
        return n, (*ptrs, n, c,
                   (DECAY if decay[i] else 0) | _vector(ptrs, ts))
    rows, spans = _rows(launches, fields)
    return (np.array(rows, dtype=UPDATE_ROW),
            np.array([(a, n, KINDS[pk], KINDS[gk]) for ((pk, gk), _), (a, n)
                      in zip(launches, spans)], dtype=np.int32).reshape(-1))


def launch_range(name: str):
    """While a profiler records, a function-scope host range of `name`
    around a launch: a ctypes launch is no op of PyTorch's, and without an
    op of its own the profiler ties its kernels to the innermost enclosing
    op, outside the caller's user-scope ranges (`record_function`)."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return contextlib.nullcontext()


def _walkable(gs: list, dev: torch.device) -> list:
    """The grads on `dev`, each contiguous (a copy where it is not)."""
    out = []
    for i, g in enumerate(gs):
        if g.device != dev or g.dtype not in KINDS:
            raise ValueError(f"adamw: grad {i} is {g.dtype} on {g.device}; "
                             f"the kernels take float32 or bfloat16 on {dev}")
        out.append(g if g.is_contiguous() else g.contiguous())
    return out


def global_norm_plain(leaves: list) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32: the norm's plain
    twin, on any device."""
    return torch.stack([x.float().square().sum() for x in leaves]).sum().sqrt()


def _norm(gs: list, clip: float) -> torch.Tensor:
    """(norm, clip scale) as a float32 (2,) tensor on the grads' device,
    from the norm kernels (on fake tensors, allocated only); `gs` as
    `_walkable` gives them."""
    dev = gs[0].device
    launches = plan([g.dtype for g in gs], [g.numel() for g in gs],
                    MAX_NORM_LEAVES)
    partial = torch.empty(len(launches) * NORM_BLOCKS, dtype=torch.float32,
                          device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if is_fake(gs[0]):
        return out
    rows, spans = norm_table(gs, launches)
    fn, _, errstr = _lib()
    with torch.cuda.device(dev), launch_range("adamw_norm"):
        err = fn(rows.ctypes.data, spans.ctypes.data, len(launches), clip,
                 partial.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"adamw_norm launch failed: "
                           f"{errstr(err).decode()} ({err})")
    global_norm.launches += len(launches) + 1
    return out


def global_norm(leaves: list) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares as a 0-d float32 tensor:
    on CPU tensors the plain twin, on CUDA tensors the two-pass kernels."""
    if leaves[0].device.type == "cpu":
        return global_norm_plain(leaves)
    return _norm(_walkable(leaves, leaves[0].device), 1.0).select(0, 0)


global_norm.launches = 0


def adamw_plain(ps, gs, ms, vs, decay, cfg, lr: float, b1c: float,
                b2c: float) -> None:
    """The update's plain twin, on any device: clip the grads by their
    global norm, then each leaf's AdamW step in fp32, in place."""
    scale = torch.clamp(cfg.clip_norm / (global_norm_plain(gs) + 1e-9),
                        max=1.0)
    update_plain(ps, gs, ms, vs, decay, scale, cfg, lr, b1c, b2c)


def update_plain(ps, gs, ms, vs, decay, scale, cfg, lr: float, b1c: float,
                 b2c: float) -> None:
    """`adamw_plain`'s steps given the clip scale (a 0-d fp32 tensor): the
    leaf loop, which a test can run a leaf at a time."""
    with torch.no_grad():
        for p, g, m, v, dec in zip(ps, gs, ms, vs, decay, strict=True):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / b1c) / ((v / b2c).sqrt() + cfg.eps)
            p32 = p.float()
            if dec:
                delta = delta + cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)


def adamw(ps, gs, ms, vs, decay, cfg, lr: float, b1c: float,
          b2c: float) -> None:
    """One AdamW step over the leaves ps (params), gs (grads), ms, vs (fp32
    moments), in place: grads clipped to `cfg.clip_norm` by their global
    norm, `decay[i]` whether leaf i is decayed, `lr` and the bias
    corrections b1c, b2c as the caller computed them.  On CPU tensors the
    plain twin; on CUDA tensors the norm kernels, then the update kernel."""
    dev = ps[0].device
    if dev.type == "cpu":
        return adamw_plain(ps, gs, ms, vs, decay, cfg, lr, b1c, b2c)
    if not len(gs) == len(ms) == len(vs) == len(decay) == len(ps):
        raise ValueError(f"adamw: {len(ps)} params, {len(gs)} grads, "
                         f"{len(ms)} / {len(vs)} moments, {len(decay)} "
                         "decay flags")
    gs = _walkable(gs, dev)
    f32 = torch.float32
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if p.dtype not in KINDS or m.dtype != f32 or v.dtype != f32:
            raise ValueError(f"adamw: leaf {i}: param {p.dtype}, m {m.dtype},"
                             f" v {v.dtype}; the kernels take a float32 or "
                             "bfloat16 param and float32 moments")
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()
                and p.device == m.device == v.device == dev):
            raise ValueError(f"adamw: leaf {i}: param, m and v must be "
                             f"contiguous on {dev} ({p.device}, strides "
                             f"{p.stride()} / {m.stride()} / {v.stride()})")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adamw: leaf {i}: param {tuple(p.shape)}, grad "
                             f"{tuple(g.shape)}, m {tuple(m.shape)}, v "
                             f"{tuple(v.shape)}")
    scale = _norm(gs, cfg.clip_norm).narrow(0, 1, 1)
    if is_fake(ps[0]):
        return
    launches = plan([(p.dtype, g.dtype) for p, g in zip(ps, gs)],
                    [p.numel() for p in ps], MAX_LEAVES)
    rows, spans = update_table(ps, gs, ms, vs, decay, launches)
    _, fn, errstr = _lib()
    with torch.cuda.device(dev), launch_range("adamw_update"):
        err = fn(rows.ctypes.data, spans.ctypes.data, len(launches), lr,
                 cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
                 cfg.weight_decay, b1c, b2c, scale.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"adamw_update launch failed: "
                           f"{errstr(err).decode()} ({err})")
    adamw.launches += len(launches)
    adamw.leaves += len(ps)


adamw.launches = 0
adamw.leaves = 0
