"""Spans around the program's functions, recorded from the benchmark's own
files: in a traced run each function that a metric's reader names (its
`SPANS`, {label: "module:function"}) is replaced, on its module, by a
wrapper that opens `torch.profiler.record_function("pb:<label>#<i>")` and
notes the i-th call's arguments (tensor shapes, dtypes, whether they need
a gradient).  The program is called as before; only the traced run
installs them.  A `Tap` keeps what a program function returns (serving's
last-position logits, for the comparison that decides `correct`)."""

from __future__ import annotations

import functools
import importlib

import torch

PREFIX = "pb:"


def describe(x):
    if isinstance(x, torch.Tensor):
        return {"shape": tuple(x.shape), "dtype": str(x.dtype).split(".")[-1],
                "grad": bool(x.requires_grad)}
    if isinstance(x, (int, float, bool, str)) or x is None:
        return x
    return type(x).__name__


class Spans:
    def __init__(self, targets: dict[str, str]):
        self.targets = dict(targets)
        self.calls: dict[str, list[dict]] = {k: [] for k in self.targets}
        self._saved: list = []

    def install(self) -> "Spans":
        for label, target in self.targets.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(label, orig))
        return self

    def remove(self) -> None:
        while self._saved:
            mod, attr, orig = self._saved.pop()
            setattr(mod, attr, orig)

    def _wrap(self, label: str, fn):
        calls = self.calls[label]

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            calls.append({"args": [describe(a) for a in args],
                          "kwargs": {k: describe(v)
                                     for k, v in kwargs.items()}})
            with torch.profiler.record_function(
                    f"{PREFIX}{label}#{len(calls) - 1}"):
                return fn(*args, **kwargs)
        return wrapped


def span(name: str):
    """A span of the benchmark's own loop (a step, a batch, a wait)."""
    return torch.profiler.record_function(PREFIX + name)


class Tap:
    """Keeps what one program function returns while `armed` is set: the
    function ("module:function") is replaced on its module by a wrapper
    that calls it and, when armed, appends its result to `out`.  The
    program is called as before; `remove` puts the function back."""

    def __init__(self, target: str):
        mod_name, self.attr = target.split(":")
        self.mod = importlib.import_module(mod_name)
        self.orig = getattr(self.mod, self.attr)
        self.armed, self.out = False, []

        @functools.wraps(self.orig)
        def wrapped(*args, **kwargs):
            result = self.orig(*args, **kwargs)
            if self.armed:
                self.out.append(result)
            return result
        setattr(self.mod, self.attr, wrapped)

    def take(self) -> list:
        out, self.out = self.out, []
        return out

    def remove(self) -> None:
        setattr(self.mod, self.attr, self.orig)
