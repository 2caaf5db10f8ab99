"""Meshes, ported from `repro.launch.mesh`.

The port runs on one device.  The JAX package lays its cells out over
TPU-v5e pods of 16 x 16 = 256 chips (a leading `pod` axis of 2 for
multi-pod) and shards them by `distributed.sharding`; the port's entry
points, like its sweeps (`core.sweep.ShardPlan.devices` is None or 1),
run on one card.  So `make_host_mesh` is the one-device mesh
{"data": 1, "model": 1} over that card, and `make_production_mesh` only
describes the TPU mesh: it holds no devices, its sharding specs can be
computed (`distributed.sharding`), and nothing is ever placed on it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape` maps each axis name to its size, `axis_names` orders them,
    and `devices` holds the mesh's devices (empty for a mesh that is only
    described)."""

    shape: dict
    axis_names: tuple
    devices: tuple = ()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh, described: (16, 16) on ("data",
    "model"), or (2, 16, 16) with a leading "pod" axis; no devices."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    return Mesh(dict(zip(axes, sizes)), axes)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """The one-device mesh {"data": 1, "model": 1} over `device` (the card
    by default; without CUDA it raises unless `device="cpu"` is given).
    `model` is the JAX signature's model-axis size; one device holds one,
    as `min(model, n_devices)` gives there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    if model < 1:
        raise ValueError(f"model axis {model} < 1")
    return Mesh({"data": 1, "model": 1}, ("data", "model"), (dev,))
