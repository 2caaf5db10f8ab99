"""Fault-tolerant checkpointing, ported from `repro.checkpoint.manager`:
atomic, async, keep-k, auto-resume, over any pytree of tensors (a
`TrainState` included).

  * Each save copies every leaf to host memory at once (later in-place
    updates of the state cannot reach it), then writes
    `<dir>/step_<N>.tmp/`, one .npy per flattened leaf plus a manifest
    (treedef, shapes, dtypes), and renames it to `step_<N>`: a crashed save
    can never be mistaken for a valid checkpoint.
  * The writing runs on a background thread (`wait()` joins it).
  * `restore_latest` takes the newest complete checkpoint whose leaf count
    and shapes match, skipping (and reporting) corrupt ones, and reports the
    step.
  * numpy has no bfloat16: bf16 leaves are written as fp32 (exact) and cast
    back to the dtype of the structure restored into.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.utils._pytree as pytree


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _restored(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    return type(like)(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        self.wait()
        leaves, treedef = pytree.tree_flatten(tree)
        host_leaves = [_to_host(leaf) for leaf in leaves]

        def _write():
            tmp = os.path.join(self.directory, f"step_{step:010d}.tmp")
            final = os.path.join(self.directory, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(host_leaves),
                        "treedef": str(treedef),
                        "shapes": [list(a.shape) for a in host_leaves],
                        "dtypes": [str(leaf.dtype) if isinstance(
                            leaf, torch.Tensor) else str(a.dtype)
                            for leaf, a in zip(leaves, host_leaves)]}
            for i, arr in enumerate(host_leaves):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):   # re-save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self._complete_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def _complete_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.directory, name,
                                           "manifest.json")):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self._complete_steps()
        return max(steps) if steps else None

    def restore(self, step: int, like):
        """Restore into the structure of `like`: each tensor leaf on its
        device and in its dtype (validates leaf count and shapes)."""
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, treedef = pytree.tree_flatten(like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, "
                f"expected {len(leaves)}: incompatible tree")
        restored = []
        for i, ref in enumerate(leaves):
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            if (isinstance(ref, torch.Tensor)
                    and tuple(arr.shape) != tuple(ref.shape)):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            restored.append(_restored(arr, ref))
        return pytree.tree_unflatten(restored, treedef)

    def restore_latest(self, like):
        """(step, tree) of the newest valid checkpoint, or (None, None)."""
        self.wait()
        for step in sorted(self._complete_steps(), reverse=True):
            try:
                return step, self.restore(step, like)
            except (ValueError, OSError) as e:  # corrupt: try the previous
                print(f"checkpoint step {step} unreadable ({e}); skipping")
        return None, None
