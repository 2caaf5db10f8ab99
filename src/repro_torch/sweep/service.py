"""Concurrent sweep service — one request handler behind HTTP,
unix-socket, and stdin-JSONL transports, with request coalescing, a
result cache, and cold-start-killing warmup.

The JSONL stdin loop (``python -m repro_torch.sweep serve``) was a
single-threaded facade over the memoized sweep pipeline; this module is
the production form the ROADMAP's "heavy traffic" north star asks for:

* **Transports** (stdlib only): :class:`SweepHTTPServer` (threaded; POST
  a request document to ``/``, ``GET /stats`` and ``GET /healthz``),
  :class:`SweepUnixServer` (threaded unix socket speaking the same JSONL
  protocol as stdin), and :func:`serve_stdio` (the original loop, now a
  thin adapter over the same :meth:`SweepService.handle`).

* **Request coalescing** (:class:`Coalescer`): concurrent in-flight
  specs that arrive within a small batching window and declare the same
  platform axis are merged into one superset spec
  (``core.sweep.spec_union``), evaluated **once** through the bucketed
  fold (``workload_engine.evaluate_bucketed``), and sliced back into
  per-request results (``SweepResult.subset``) — the batched-evaluation
  economics of the sweep engine applied across requests.  *Identical*
  in-flight requests (same canonical spec document) collapse further:
  they share one queue entry, skipping even the resolve, so a thundering
  herd of clients asking the same golden question costs one evaluation.
  Per-request values match an individual ``run()`` at <= 1e-12 (padding
  reassociates reductions, so bit-identity is not claimed).

* **Result cache**: bounded, keyed on the canonical serialized symbolic
  spec (``json.dumps(sym.to_doc(), sort_keys=True)``), with hit/miss
  counters.  Sharded (``"shard"``-envelope) requests bypass both the
  cache and the coalescer, mirroring ``run()``'s no-memo policy for
  mega-results.

* **Backpressure**: a bounded admission gate (``max_pending``
  concurrent evaluations; cache hits and ops are never refused) and a
  request-document size limit (``max_body_bytes``; the HTTP transport
  refuses oversize bodies before reading them).  Refusals answer with
  ``{"ok": false, "status": 413 | 429, "error": ...}`` — HTTP maps the
  status onto the response code, JSONL clients read it from the
  document — and are counted in ``stats()["limits"]``.

* **Warmup** (:meth:`SweepService.warmup`): resolves the given specs,
  builds their real design tables through the capacity-bucketed circuit
  path (priming bitcell characterization, calibration and Algorithm-1
  tunings), and runs the fold once at their bucketed shapes on the
  service's device — plus an optional spec-independent shape grid
  (``workload_engine.warmup`` / ``engine.warmup``).  The JAX package also
  wires a persistent compilation cache here; eager PyTorch compiles
  nothing to persist, so :func:`enable_compilation_cache` raises.

* **One device per service**: ``SweepService(device=...)`` (``cuda``
  unless the caller passes ``"cpu"``) resolves its device once, raising
  without CUDA, and every evaluation, sharded run and warmup of that
  service runs there.

Graceful shutdown: transports wrap each request in
:meth:`SweepService.track`, so :meth:`SweepService.close` can drain
in-flight requests (including any sitting in the coalescing window)
before stopping the worker — SIGTERM/SIGINT never drop a response that
was accepted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import socket
import socketserver
import sys
import threading
import time
from collections import OrderedDict, deque
from collections.abc import Mapping, Sequence
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NoReturn

import numpy as np

from repro_torch.core import device as device_mod
from repro_torch.core import engine, workload_engine
from repro_torch.core.sweep import (
    ShardPlan,
    SweepResult,
    SweepSpec,
    SymbolicSweepSpec,
    lower_designs,
    n_cells,
    run_sharded,
    spec_union,
)

WANTS = ("rows", "summary", "pareto", "plateaus")
SHARD_KEYS = ("scenario_chunk", "design_chunk", "devices", "by_width")
OPS = ("ping", "stats")


class RequestTooLarge(ValueError):
    """Request document exceeds ``max_body_bytes`` (HTTP 413)."""

    http_status = 413


class ServiceOverloaded(RuntimeError):
    """Admission refused: ``max_pending`` evaluations already in flight
    (HTTP 429).  Cache hits and ops are never refused — only work that
    would start a new evaluation."""

    http_status = 429


# ---------------------------------------------------------------------------
# Request documents
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Parsed:
    sym: SymbolicSweepSpec
    want: tuple[str, ...]
    include_dram: bool
    plan: ShardPlan | None


def _parse(req: Mapping) -> _Parsed:
    """One serve-mode request document (bare spec or envelope) -> the
    validated pieces.  The envelope form::

        {"spec": {...}, "want": ["rows", ...], "include_dram": false,
         "shard": {"scenario_chunk": 8, ...}}
    """
    envelope = isinstance(req, Mapping) and "spec" in req
    doc = req["spec"] if envelope else req
    want = tuple(req.get("want", ("summary",))) if envelope else ("summary",)
    unknown = set(want) - set(WANTS)
    if unknown:
        raise ValueError(f"unknown want items {sorted(unknown)}; "
                         f"available: {list(WANTS)}")
    include_dram = bool(req.get("include_dram", False)) if envelope else False
    plan = None
    if envelope and req.get("shard") is not None:
        shard = dict(req["shard"])
        unknown = set(shard) - set(SHARD_KEYS)
        if unknown:
            raise ValueError(f"unknown shard keys {sorted(unknown)}; "
                             f"available: {list(SHARD_KEYS)}")
        plan = ShardPlan(**shard)
    return _Parsed(SymbolicSweepSpec.from_json(doc), want, include_dram,
                   plan)


def _axes(spec: SweepSpec) -> dict:
    return {"platforms": len(spec.platforms),
            "scenarios": len(spec.scenarios),
            "designs": len(spec.designs)}


def _views(result: SweepResult, want: Sequence[str],
           include_dram: bool) -> dict:
    out: dict = {}
    if "rows" in want:
        out["rows"] = result.rows(include_dram=include_dram)
    if "summary" in want:
        out["summary"] = result.summary()
    if "pareto" in want:
        out["pareto"] = result.pareto_front(include_dram=include_dram)
    if "plateaus" in want:
        out["plateaus"] = result.capacity_plateaus()
    return out


def spec_key(sym: SymbolicSweepSpec) -> str:
    """The result-cache key: the canonical serialized symbolic spec."""
    return json.dumps(sym.to_doc(), sort_keys=True)


# ---------------------------------------------------------------------------
# Evaluation path (bucketed shapes end to end)
# ---------------------------------------------------------------------------


def evaluate_spec(spec: SweepSpec, device="cuda") -> SweepResult:
    """The service's one-spec evaluation on ``device``: the
    capacity-bucketed circuit lowering plus the bucketed fold, so every
    fold lands on a shape ``warmup`` can pre-run.  Matches
    ``sweep.run(spec)`` at <= 1e-12; the exact (unbucketed) path stays the
    CLI ``run`` default."""
    table, designs = lower_designs(spec.designs, pad_caps=True,
                                   device=device)
    tables = workload_engine.evaluate_bucketed(spec.scenarios, designs,
                                               spec.platforms, device=device)
    return SweepResult(spec=spec, design_table=table, designs=designs,
                       tables=tables)


# ---------------------------------------------------------------------------
# Coalescer: the batching window
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _Pending:
    """One submitted spec awaiting its (exactly-once) result.  Identical
    concurrent requests (same canonical ``key``) share one pending —
    ``claims`` counts the callers waiting on it."""

    spec: SweepSpec
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: SweepResult | None = None
    error: BaseException | None = None
    group_size: int = 1
    key: str | None = None
    claims: int = 1

    @property
    def shared(self) -> bool:
        """Did this request share its evaluation with another?"""
        return self.group_size > 1 or self.claims > 1


class Coalescer:
    """Merge compatible in-flight specs into one superset evaluation.

    ``submit`` blocks the calling transport thread until a dedicated
    worker has answered the request.  The worker collects everything that
    arrives within ``window_ms`` of the first pending request (up to
    ``max_batch``), partitions the batch into compatibility groups (the
    ``spec_union`` rule: identical platform axis), evaluates each group's
    union **once**, and slices each member's view back out.  Every
    pending request is delivered exactly once — on success, on a
    per-request slice failure, or on a group evaluation failure — and
    ``close`` refuses new work but drains everything already queued.
    """

    def __init__(self, evaluate=evaluate_spec, window_ms: float = 5.0,
                 max_batch: int = 64):
        self._evaluate = evaluate
        self.window_s = max(0.0, window_ms) / 1e3
        self.max_batch = max(1, max_batch)
        self._cv = threading.Condition()
        self._queue: list[_Pending] = []
        self._keyed: dict[str, _Pending] = {}   # queued, by canonical key
        self._closed = False
        self.batches = 0             # evaluation groups run
        self.coalesced_requests = 0  # requests merged through a union
        self.deduped_requests = 0    # identical in-flight requests shared
        self.max_group = 0
        self._worker = threading.Thread(target=self._loop,
                                        name="sweep-coalescer", daemon=True)
        self._worker.start()

    def join(self, key: str) -> _Pending | None:
        """Attach to an identical queued request (same canonical key)
        without resolving or submitting anything; None if no such request
        is in the window.  The caller waits on the returned pending."""
        with self._cv:
            pending = self._keyed.get(key)
            if pending is not None:
                pending.claims += 1
                self.deduped_requests += 1
        if pending is not None:
            pending.event.wait()
            if pending.error is not None:
                raise pending.error
        return pending

    def submit(self, spec: SweepSpec, key: str | None = None) -> _Pending:
        with self._cv:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            pending = self._keyed.get(key) if key is not None else None
            if pending is None:
                pending = _Pending(spec, key=key)
                self._queue.append(pending)
                if key is not None:
                    self._keyed[key] = pending
                self._cv.notify_all()
            else:
                pending.claims += 1
                self.deduped_requests += 1
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending

    def close(self) -> None:
        """Refuse new submissions, drain the queue, stop the worker."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._worker.join()

    # -- worker ------------------------------------------------------------

    def _collect(self) -> list[_Pending]:
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if not self._queue:
                return []       # closed and drained
            deadline = time.monotonic() + self.window_s
            while len(self._queue) < self.max_batch and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(timeout=left)
            batch = self._queue[:self.max_batch]
            del self._queue[:self.max_batch]
            for p in batch:     # late identical arrivals start a new entry
                if p.key is not None:
                    self._keyed.pop(p.key, None)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return
            groups: dict[tuple, list[_Pending]] = {}
            for p in batch:
                groups.setdefault(p.spec.platforms, []).append(p)
            for group in groups.values():
                self._run_group(group)

    def _run_group(self, group: list[_Pending]) -> None:
        with self._cv:  # stats() reads these counters concurrently
            self.batches += 1
            self.max_group = max(self.max_group, len(group))
        try:
            if len(group) == 1:
                group[0].result = self._evaluate(group[0].spec)
            else:
                union = spec_union([p.spec for p in group],
                                   name=f"coalesced[{len(group)}]")
                superset = self._evaluate(union)
                for p in group:
                    try:
                        p.result = superset.subset(p.spec)
                    except BaseException as e:  # noqa: BLE001 — isolate
                        p.error = e
                with self._cv:
                    self.coalesced_requests += len(group)
        except BaseException as e:  # noqa: BLE001 — the worker must live
            for p in group:
                if p.result is None and p.error is None:
                    p.error = e
        finally:
            for p in group:
                p.group_size = len(group)
                p.event.set()


# ---------------------------------------------------------------------------
# Result cache
# ---------------------------------------------------------------------------


class ResultCache:
    """Bounded FIFO result cache keyed on the canonical serialized spec
    (two textually different but equivalent documents hash apart — each
    pays one evaluation, both land in the cache)."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = max(0, maxsize)
        self._entries: OrderedDict[str, SweepResult] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> SweepResult | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
            else:
                self.misses += 1
            return entry

    def put(self, key: str, result: SweepResult) -> None:
        if not self.maxsize:
            return
        with self._lock:
            self._entries[key] = result
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------


def _percentiles(xs: Sequence[float]) -> dict:
    if not xs:
        return {"p50": None, "p95": None}
    return {"p50": float(np.percentile(xs, 50)),
            "p95": float(np.percentile(xs, 95))}


class SweepService:
    """The shared request handler every transport speaks to.

    ``handle`` takes one request document (a JSON string or a mapping)
    and returns one JSON-serializable response document — the same
    contract the stdin JSONL loop always had, now concurrency-safe:
    transport threads call it freely, and spec evaluations funnel through
    the coalescer's single worker (or, with ``coalesce=False``, run
    inline in the calling thread).

    ``device`` (``cuda`` unless the caller passes ``"cpu"``) is resolved
    once, here, so a service raises at construction without CUDA; every
    evaluation runs there.  ``evaluate`` defaults to :func:`evaluate_spec`
    on that device."""

    def __init__(self, window_ms: float = 5.0, max_batch: int = 64,
                 coalesce: bool = True, cache_size: int = 256,
                 evaluate=None, max_pending: int = 64,
                 max_body_bytes: int = 1 << 20, device="cuda"):
        self.device = device_mod.resolve(device)
        if evaluate is None:
            evaluate = functools.partial(evaluate_spec, device=self.device)
        self._evaluate = evaluate
        self.cache = ResultCache(cache_size)
        self.coalescer = Coalescer(evaluate, window_ms, max_batch) \
            if coalesce else None
        self.warmup_info: dict | None = None
        self._closed = False
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._samples: deque[tuple[int, float]] = deque(maxlen=4096)
        self.requests = 0
        self.ok = 0
        self.errors = 0
        # Backpressure limits: evaluations admitted concurrently, and the
        # largest request document a transport will read.
        self.max_pending = max(1, max_pending)
        self.max_body_bytes = max(1, max_body_bytes)
        self._pending = 0
        self.rejected_too_large = 0
        self.rejected_overloaded = 0
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    # -- request handling --------------------------------------------------

    def handle(self, request: Mapping | str) -> dict:
        """One request -> one response document (never raises).  Refused
        requests (oversize document, admission limit) answer with
        ``{"ok": false, "error": ..., "status": 413 | 429}``."""
        t0 = time.perf_counter()
        try:
            if isinstance(request, str) \
                    and len(request) > self.max_body_bytes:
                raise RequestTooLarge(
                    f"request document is {len(request)} bytes "
                    f"(max_body_bytes={self.max_body_bytes})")
            req = json.loads(request) if isinstance(request, str) \
                else request
            if isinstance(req, Mapping) and "op" in req:
                return self._op(req)
            parsed = _parse(req)
            result, source = self._result_for(parsed)
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            resp: dict = {"ok": True, "name": parsed.sym.name,
                          "axes": _axes(result.spec),
                          "cells": n_cells(result.spec),
                          "elapsed_ms": elapsed_ms,
                          "source": source}
            resp.update(_views(result, parsed.want, parsed.include_dram))
            self._record(True, n_cells(result.spec), elapsed_ms)
            return resp
        except Exception as e:  # noqa: BLE001 — the server must survive
            return self._error_response(
                e, (time.perf_counter() - t0) * 1e3)

    def refuse_oversized(self, nbytes: int) -> dict:
        """A transport-level 413 for a body it refused to even read
        (same counting and document shape as the in-handler guard)."""
        return self._error_response(
            RequestTooLarge(f"request body is {nbytes} bytes "
                            f"(max_body_bytes={self.max_body_bytes})"),
            0.0)

    def _error_response(self, e: BaseException, elapsed_ms: float) -> dict:
        with self._lock:
            if isinstance(e, RequestTooLarge):
                self.rejected_too_large += 1
            elif isinstance(e, ServiceOverloaded):
                self.rejected_overloaded += 1
        self._record(False, 0, elapsed_ms)
        resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        status = getattr(e, "http_status", None)
        if status is not None:
            resp["status"] = status
        return resp

    @contextlib.contextmanager
    def _admit(self):
        """Admission gate around work that starts a new evaluation
        (cache misses and sharded runs; cache hits and ops bypass it)."""
        with self._lock:
            if self._pending >= self.max_pending:
                raise ServiceOverloaded(
                    f"{self._pending} evaluations already pending "
                    f"(max_pending={self.max_pending})")
            self._pending += 1
        try:
            yield
        finally:
            with self._lock:
                self._pending -= 1

    def _op(self, req: Mapping) -> dict:
        op = req["op"]
        if op == "ping":
            return {"ok": True, "op": "ping"}
        if op == "stats":
            return {"ok": True, "op": "stats", "stats": self.stats()}
        raise ValueError(f"unknown op {op!r}; available: {list(OPS)}")

    def _result_for(self, parsed: _Parsed) -> tuple[SweepResult, str]:
        if parsed.plan is not None:
            # sharded mega-requests stream through merge and bypass both
            # the cache and the coalescer (run()'s no-memo policy: the
            # results are too large to pin) — but not the admission gate:
            # they are the heaviest requests the service takes
            with self._admit():
                return run_sharded(parsed.sym.resolve(), parsed.plan,
                                   device=self.device), "sharded"
        key = spec_key(parsed.sym)
        hit = self.cache.get(key)
        if hit is not None:
            return hit, "cache"
        with self._admit():
            if self.coalescer is not None:
                # identical in-flight request? share it without resolving
                pending = self.coalescer.join(key)
                if pending is None:
                    pending = self.coalescer.submit(parsed.sym.resolve(),
                                                    key=key)
                result = pending.result
                source = "coalesced" if pending.shared else "evaluated"
            else:
                result = self._evaluate(parsed.sym.resolve())
                source = "evaluated"
        self.cache.put(key, result)
        return result, source

    def _record(self, ok: bool, cells: int, elapsed_ms: float) -> None:
        with self._lock:
            self.requests += 1
            if ok:
                self.ok += 1
                self._samples.append((cells, elapsed_ms))
            else:
                self.errors += 1

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """The ``{"op": "stats"}`` document: counters plus per-request
        cells and elapsed_ms percentiles over the last 4096 requests."""
        with self._lock:
            samples = list(self._samples)
            doc: dict = {
                "uptime_s": time.monotonic() - self._t0,
                "requests": {"total": self.requests, "ok": self.ok,
                             "errors": self.errors},
                "result_cache": {"hits": self.cache.hits,
                                 "misses": self.cache.misses,
                                 "size": len(self.cache),
                                 "maxsize": self.cache.maxsize},
                "limits": {"max_pending": self.max_pending,
                           "max_body_bytes": self.max_body_bytes,
                           "pending": self._pending,
                           "rejected_too_large": self.rejected_too_large,
                           "rejected_overloaded":
                               self.rejected_overloaded},
            }
        c = self.coalescer
        doc["coalesce"] = {
            "enabled": c is not None,
            "batches": c.batches if c else 0,
            "coalesced_requests": c.coalesced_requests if c else 0,
            "deduped_requests": c.deduped_requests if c else 0,
            "max_group": c.max_group if c else 0,
            "window_ms": c.window_s * 1e3 if c else 0.0,
        }
        cells = [n for n, _ in samples]
        lat = [ms for _, ms in samples]
        doc["cells"] = {"total": int(sum(cells)), **_percentiles(cells)}
        doc["elapsed_ms"] = _percentiles(lat)
        if self.warmup_info is not None:
            doc["warmup"] = self.warmup_info
        return doc

    # -- warmup ------------------------------------------------------------

    def warmup(self, specs: Sequence = (), compile_cache_dir=None,
               grid: bool = False) -> dict:
        """Kill the cold start before the first request lands, on the
        service's device.

        ``specs`` (paths, documents, symbolic or concrete specs) warm the
        exact request shapes: scenario statistics, the capacity-bucketed
        design tables (bitcell + calibration + Algorithm-1 tunings), and
        the fold at each spec's bucketed (s, k, d, p) shape.  ``grid``
        additionally runs the spec-independent shape grids
        (``engine.warmup`` + ``workload_engine.warmup``).
        ``compile_cache_dir`` raises (:func:`enable_compilation_cache`)."""
        t0 = time.perf_counter()
        info: dict = {"specs": [], "grid": bool(grid), "fold_shapes": 0}
        if compile_cache_dir:
            info["compile_cache"] = enable_compilation_cache(
                compile_cache_dir)
            info["compile_cache_dir"] = str(compile_cache_dir)
        if grid:
            info["engine_tables"] = engine.warmup(device=self.device)
            info["fold_shapes"] += workload_engine.warmup(device=self.device)
        shapes = set()
        for item in specs:
            spec = _as_spec(item)
            lower_designs(spec.designs, pad_caps=True, device=self.device)
            shapes.add(workload_engine.fold_shape(
                len(spec.scenarios),
                max(len(s.streams) for s in spec.scenarios),
                len(spec.designs), len(spec.platforms)))
            info["specs"].append(spec.name)
        for shape in sorted(shapes):
            workload_engine.warmup_fold(shape, device=self.device)
        info["fold_shapes"] += len(shapes)
        info["warmup_s"] = time.perf_counter() - t0
        with self._lock:  # stats() snapshots warmup_info concurrently
            self.warmup_info = info
        return info

    # -- lifecycle ---------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    @contextlib.contextmanager
    def track(self):
        """Transports wrap each request *and its response write* in this,
        so ``drain`` waits for delivery, not just computation."""
        with self._inflight_cv:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until no request is in flight (tracked by ``track``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._inflight_cv.wait(left)
        return True

    def close(self, timeout: float | None = None) -> None:
        """Graceful shutdown: drain in-flight requests (which flushes the
        coalescing window — queued specs are evaluated and delivered),
        then stop the worker.  Idempotent; ``handle`` after close answers
        with an error document instead of evaluating."""
        if self._closed:
            return
        self.drain(timeout)
        with self._lock:  # handle() checks closed from transport threads
            self._closed = True
        if self.coalescer is not None:
            self.coalescer.close()

    def __enter__(self) -> SweepService:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _as_spec(item) -> SweepSpec:
    """Warmup-spec coercion: path, JSON document, symbolic, or concrete."""
    if isinstance(item, SweepSpec):
        return item
    if isinstance(item, SymbolicSweepSpec):
        return item.resolve()
    if isinstance(item, str):
        return SymbolicSweepSpec.load(item).resolve()
    if isinstance(item, Mapping):
        return SymbolicSweepSpec.from_json(item).resolve()
    raise TypeError(f"cannot warm up from {type(item).__name__}")


def enable_compilation_cache(path) -> NoReturn:
    """Raises: the JAX package persists its XLA compiles at ``path``
    across process restarts, but the port's pipeline is eager PyTorch,
    which compiles nothing that a cache could keep (its cold start is
    the device's context and the memoized tables, which ``warmup``
    builds in process)."""
    raise NotImplementedError(
        f"compile cache {str(path)!r}: the PyTorch pipeline runs eager "
        "code and has no persistent compilation cache to enable; use "
        "warmup (--warmup / --warmup-spec) to take the cold start before "
        "the first request")


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class _HttpHandler(BaseHTTPRequestHandler):
    """POST / (or /sweep) with a request document; GET /stats, /healthz."""

    server_version = "deepnvm-sweep/1"
    protocol_version = "HTTP/1.0"   # close per request: shutdown never
    #                                 waits on idle keep-alive connections

    def _reply(self, code: int, doc: dict) -> None:
        body = (json.dumps(doc) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path not in ("/", "/sweep"):
            self._reply(404, {"ok": False,
                              "error": f"NotFound: POST {self.path}"})
            return
        svc = self.server.service
        with svc.track():
            n = int(self.headers.get("Content-Length") or 0)
            if n > svc.max_body_bytes:
                # refuse before reading: an oversize body never touches
                # the parser or the heap
                resp = svc.refuse_oversized(n)
            else:
                body = self.rfile.read(n).decode("utf-8", "replace")
                resp = svc.handle(body)
            self._reply(200 if resp.get("ok")
                        else int(resp.get("status", 400)), resp)

    def do_GET(self) -> None:  # noqa: N802
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, self.server.service.handle({"op": "stats"}))
        else:
            self._reply(404, {"ok": False,
                              "error": f"NotFound: GET {self.path}"})

    def log_message(self, fmt, *args) -> None:  # stderr stays quiet
        pass


class SweepHTTPServer(ThreadingHTTPServer):
    """Threaded HTTP transport.  Handler threads are daemons and close
    does not join them — graceful shutdown goes through
    ``service.drain()``, which waits for tracked request delivery.

    The listen backlog is ``socket.SOMAXCONN``, not socketserver's 5: while
    an evaluation holds the interpreter, a burst of concurrent clients
    overflows a backlog of 5 and the kernel resets their connections."""

    daemon_threads = True
    block_on_close = False
    request_queue_size = socket.SOMAXCONN

    def __init__(self, address: tuple[str, int], service: SweepService):
        super().__init__(address, _HttpHandler)
        self.service = service


class _JsonlHandler(socketserver.StreamRequestHandler):
    """One JSONL request per line in, one response line out — the stdin
    protocol, per connection."""

    def handle(self) -> None:
        for raw in self.rfile:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            with self.server.service.track():
                resp = self.server.service.handle(line)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()


if hasattr(socketserver, "ThreadingUnixStreamServer"):
    class SweepUnixServer(socketserver.ThreadingUnixStreamServer):
        """Threaded unix-socket transport speaking line-delimited JSON
        (the stdin protocol over a socket).  A stale socket path is
        unlinked on bind; like the HTTP server, shutdown drains via the
        service."""

        daemon_threads = True
        block_on_close = False

        def __init__(self, path: str, service: SweepService):
            if os.path.exists(path):
                os.unlink(path)
            super().__init__(path, _JsonlHandler)
            self.service = service
else:  # pragma: no cover — platforms without AF_UNIX
    SweepUnixServer = None


def serve_stdio(service: SweepService, in_stream=None, out_stream=None,
                ) -> int:
    """The original JSONL loop as a thin adapter over the shared handler:
    one request per line in, one response line out, engine caches (and
    now the service's result cache) warm for the life of the process."""
    in_stream = in_stream if in_stream is not None else sys.stdin
    out_stream = out_stream if out_stream is not None else sys.stdout
    served = 0
    for line in in_stream:
        if not line.strip():
            continue
        with service.track():
            out_stream.write(json.dumps(service.handle(line)) + "\n")
            out_stream.flush()
        served += 1
    return served
