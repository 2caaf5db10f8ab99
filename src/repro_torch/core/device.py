"""The device the float64 pipeline runs on.

Every entry point of the port's pipeline takes a ``device`` argument that
defaults to ``"cuda"``.  ``resolve`` turns it into the canonical string
the memoized layers key on ("cpu" or "cuda:<index>"), so "cuda", "cuda:0"
and ``torch.device("cuda", 0)`` share one memo entry, and it raises when a
CUDA device is asked for and none is present: nothing falls back to the
CPU.  ``put`` moves the engines' numpy inputs there, keeping their dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device) -> str:
    """Canonical memo-key form of ``device``; raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"the pipeline runs on 'cuda' or 'cpu', not "
                         f"{str(device)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return f"cuda:{index}"


def put(a: np.ndarray, device: str) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (float64, int64, bool)
    on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
