"""Sharding rules, ported from `repro.distributed.sharding`: every param,
cache and batch leaf mapped to a spec, a tuple of one mesh axis (a name,
or a tuple of names) or None per dimension, the counterpart of JAX's
`PartitionSpec` (whose normal form it keeps: a tuple of one axis is
that axis' name).

Scheme (Megatron-style TP on `model`, DP/FSDP on `data` (+`pod`)):

  * embeddings       vocab on `model` (fallback: d_model)
  * attention q/o    heads on `model`; k/v heads on `model` when divisible
  * MLP              d_ff on `model`
  * MoE experts      expert dim on `model` (expert parallelism)
  * FSDP (optional)  largest remaining dim over `data` (+`pod`)
  * batch/caches     batch on (`pod`,`data`); seq on `model` for batch-1
                     long-context caches; replicate what does not divide

Divisibility is never assumed: each rule emits an ordered list of
candidate (dim -> axis) assignments and `best_fit` keeps the first ones
that divide (Qwen3's 40 heads do not split over model=16, so TP falls
back to d_model; MiniCPM's 122,753-token vocab falls back the same way).

The port's trees keep a segment (and Whisper's encoder) as a list of
per-layer dicts where the JAX package stacks them on a leading layer
axis, which it never shards.  So a per-layer leaf gets the JAX spec of
the stacked leaf without its layer dimension.

The port runs on one device (`launch.mesh`): the specs describe a
layout, computed for any mesh, meshes that are only described included;
`place` puts a tree on a one-device mesh (the counterpart of
`tree_shardings` / `batch_shardings` and `jax.device_put`).  The
activation constraints (`enable_activation_sharding`, `constrain`) take
only a one-device mesh or None and leave activations as they are; the
port's models do not call them.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.utils._pytree as pytree

from repro_torch.convert import is_stacked
from repro_torch.launch.mesh import Mesh

MODEL_AXIS = "model"

# The sweep engine's mesh (core/sweep.py ShardPlan): one axis of chunks.
SWEEP_AXIS = "sweep"


def sweep_mesh(devices: int | None = None, device="cuda") -> Mesh:
    """The one-device mesh on the ``sweep`` axis: ``devices`` is None or 1
    (the port runs on one device, as `ShardPlan.devices` says)."""
    if devices not in (None, 1):
        raise ValueError(f"requested {devices} devices; the port runs on "
                         "one device")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return Mesh({SWEEP_AXIS: 1}, (SWEEP_AXIS,), (dev,))


def sweep_chunk_spec() -> tuple:
    """Spec of a stacked chunk tensor: the leading chunk axis on the sweep
    mesh, everything else local."""
    return (SWEEP_AXIS,)


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: `data`, plus `pod` folded in when present."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        sz = 1
        for a in axis:
            sz *= mesh.shape[a]
        return sz
    return mesh.shape[axis]


def best_fit(shape: Sequence[int], mesh,
             preferences: Sequence[tuple[int, object]]) -> tuple:
    """Greedy first-fit: keep each (dim, axis) whose size divides the dim
    and whose axis is still unused; replicate everything else."""
    assignment: dict[int, object] = {}
    used: set[str] = set()
    for dim, axis in preferences:
        if dim >= len(shape) or dim in assignment:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        if any(a not in mesh.axis_names or a in used for a in axes):
            continue
        if shape[dim] % _axis_size(mesh, axis) != 0 or shape[dim] == 0:
            continue
        assignment[dim] = axis
        used.update(axes)
    return tuple(_entry(assignment.get(i)) for i in range(len(shape)))


def _entry(axis):
    """One dim's axis as `PartitionSpec` keeps it: a tuple of one name as
    the name, an empty tuple as None."""
    if isinstance(axis, tuple) and len(axis) < 2:
        return axis[0] if axis else None
    return axis


def _key(k):
    return getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))


def _layout(path, leaf) -> tuple[str, tuple, bool]:
    """(the JAX path's name, the JAX leaf's shape, whether the port's leaf
    is one layer of a stacked subtree): a per-layer leaf's path drops the
    layer's list index, and its shape gains a leading layer axis (of 1:
    no rule ever reads or assigns it)."""
    keys = [_key(k) for k in path]
    layer = next((i + 1 for i, k in enumerate(keys[:-1])
                  if isinstance(k, str) and is_stacked(k)
                  and isinstance(keys[i + 1], int)), None)
    shape = tuple(getattr(leaf, "shape", ()))
    if layer is not None:
        del keys[layer]
        shape = (1, *shape)
    return "/".join(str(k) for k in keys), shape, layer is not None


def param_spec(path, leaf, mesh, *, fsdp: bool = False) -> tuple:
    """Spec of one model / optimizer parameter leaf: the JAX rules on the
    JAX layout (`_layout`), the layer dim dropped from a per-layer leaf's."""
    name, shape, layer = _layout(path, leaf)
    ndim = len(shape)
    off = 1 if (layer and ("seg" in name or "encoder" in name)
                and ndim >= 2) else 0
    dp = dp_axes(mesh)
    prefs: list[tuple[int, object]] = []

    def pref(dim_rel: int, axis):
        prefs.append((dim_rel + off, axis))

    nd = ndim - off
    if "embed" in name:                       # (vocab, d) / (d, vocab)
        big = 0 if shape[0] >= (shape[1] if ndim > 1 else 0) else 1
        prefs.append((big, MODEL_AXIS))
        prefs.append((1 - big, dp if fsdp else MODEL_AXIS))
    elif any(k in name for k in ("wi_gate", "wi_up", "wo", "wk", "wv", "wq",
                                 "wr", "wg", "router", "in_proj", "out_proj",
                                 "x_proj", "dt_proj", "w_lora", "proj",
                                 "shared", "cmix", "wq_a", "wq_b", "wkv_a",
                                 "wk_b", "wv_b")):
        if nd == 3 and ("ffn/wi" in name or "ffn/wo" in name):
            # MoE experts (E, d, f): expert parallelism
            pref(0, MODEL_AXIS)
            if fsdp:
                pref(2, dp)
                pref(1, dp)
        elif nd == 3:                          # (d, H, hd) attention
            pref(1, MODEL_AXIS)               # heads on model
            pref(0, MODEL_AXIS)               # fallback: d_model
            if fsdp:
                pref(0, dp)
        elif nd == 2:
            # 2-D matrices: shard the bigger dim on model, other on data
            big = 0 if shape[off] >= shape[off + (1 if nd > 1 else 0)] else 1
            pref(big, MODEL_AXIS)
            pref(1 - big, MODEL_AXIS)
            if fsdp:
                pref(1 - big, dp)
                pref(big, dp)
        elif nd == 1 and fsdp:
            pref(0, dp)
    elif nd >= 2 and fsdp:
        pref(0, dp)
    spec = best_fit(shape, mesh, prefs)
    return spec[1:] if layer else spec


def cache_spec(path, leaf, mesh) -> tuple:
    """KV / state caches: batch on dp; heads / latent on model; batch-1
    long caches shard the sequence dim on model instead."""
    name, shape, layer = _layout(path, leaf)
    ndim = len(shape)
    dp = dp_axes(mesh)
    # stacked layer dim leads: (L, B, ...)
    off = 1 if "seg" in name else 0
    prefs: list[tuple[int, object]] = [(off, dp)]
    if "pos" in name:
        return (None,) * len(leaf.shape)
    if "ckv" in name or "krope" in name:      # MLA latent (L,B,S,r)
        prefs.append((off + 1, MODEL_AXIS))   # seq on model
    elif ndim - off == 4 and ("k" in name or "v" in name):
        prefs.append((off + 2, MODEL_AXIS))   # kv heads
        prefs.append((off + 1, MODEL_AXIS))   # fallback: seq
    elif "s" in name and ndim - off == 4:     # rwkv state (B,H,hd,hd)
        prefs.append((off + 1, MODEL_AXIS))
        prefs.append((off + 2, MODEL_AXIS))
    elif ndim - off >= 2:
        prefs.append((off + 1, MODEL_AXIS))
    spec = best_fit(shape, mesh, prefs)
    return spec[1:] if layer else spec


def batch_spec(leaf, mesh) -> tuple:
    """A batch leaf: batch on dp (or `data`), a batch-1 long context's
    sequence on model; a scalar (or a Python int, the decode index) is
    replicated."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return ()
    dp = dp_axes(mesh)
    prefs = [(0, dp), (0, "data")]
    if len(shape) >= 2:
        prefs.append((1, MODEL_AXIS))  # batch-1 long context: shard seq
    return best_fit(shape, mesh, prefs)


def tree_specs(tree, mesh, kind: str, **kw):
    """Map a tree of tensors (real or fake) to specs; `kind` is "param" or
    "cache"."""
    fn = {"param": param_spec, "cache": cache_spec}[kind]
    return pytree.tree_map_with_path(lambda p, x: fn(p, x, mesh, **kw), tree)


def _one_device(mesh) -> torch.device:
    devices = getattr(mesh, "devices", ())
    if len(devices) != 1:
        raise ValueError(f"a mesh of {len(devices)} devices: the port places "
                         "trees on one-device meshes only "
                         "(launch.mesh.make_host_mesh)")
    return devices[0]


def place(tree, mesh):
    """Every tensor leaf of `tree` on the one-device mesh's device (values
    kept; the other leaves as they are)."""
    dev = _one_device(mesh)
    return pytree.tree_map(
        lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def enable_activation_sharding(mesh: Mesh | None,
                               seq_parallel: bool = False) -> None:
    """The JAX package's switch for its activation constraints: None, or a
    one-device mesh, where there is nothing to constrain; another mesh
    raises."""
    if mesh is not None:
        _one_device(mesh)


def constrain(x, kind: str):
    """`x` unchanged (one device: no layout to ask for).  kinds as the JAX
    package's: residual | heads | hidden | logits."""
    if kind not in ("residual", "heads", "hidden", "logits"):
        raise ValueError(kind)
    return x
