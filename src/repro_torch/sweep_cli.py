"""Sweep-as-a-service: the CLI / service facade over symbolic SweepSpecs.

    python -m repro_torch.sweep run spec.json --csv out.csv
    python -m repro_torch.sweep run spec.json --device cpu
    python -m repro_torch.sweep show spec.json
    python -m repro_torch.sweep invert specs/inverse_isocap.json
    python -m repro_torch.sweep invert spec.json --objective edp --iso-area
    python -m repro_torch.sweep mega --summary
    python -m repro_torch.sweep serve < requests.jsonl
    python -m repro_torch.sweep serve --http 127.0.0.1:8731 \
        --warmup-spec specs/isocap.json --stats-on-exit

``run``, ``mega``, ``invert`` and ``serve`` evaluate on ``--device``
(``cuda`` unless ``--device cpu`` is given; without CUDA they raise, and
nothing falls back to the CPU).  ``show`` evaluates nothing and takes no
device.

``run`` lowers one JSON spec document (core/sweep.py, schema
``deepnvm.sweepspec/2``) through the registries and evaluates it — exactly
one circuit-engine call plus one workload-fold call — then writes the
long-format rows as full-precision CSV (floats repr-round-trip, so a
JSON-defined sweep reproduces the Python pipeline bit-for-bit).  With
``--shard``/``--design-chunk`` (plus ``--devices``/``--by-width``) the
spec instead takes the chunked/sharded lowering (``core.sweep.ShardPlan``)
and streams partial results through the order-invariant merge — the path
for mega-specs too large for one fold (``--devices`` takes only 1: the
port runs a sweep on one device).  ``mega`` builds and runs the full
DTCO cross product (``repro_torch.scenarios.mega_spec``, 1e5+ cells)
through that path.  ``show`` resolves without evaluating (spec linting).

``invert`` runs the gradient-based inverse-design solver
(:mod:`repro_torch.inverse`) over a spec's corner grid on ``--device``:
it accepts either a ``deepnvm.inverse/1`` problem document or a bare
sweepspec plus flags (``--objective edp --iso-area`` is the paper-style
"minimize EDP at the grid's own max area" question), prints the
converged-design summary to stderr, and emits the auditable result
document (leaves, standard-path re-evaluation, parity, gain vs the grid
argmin) as JSON.

``serve`` is the long-lived mode, backed by the concurrent
:class:`repro_torch.sweep.service.SweepService` (see that module for the
full story: transports, request coalescing, result cache, warmup).  With no
transport flag it keeps the historical stdin JSONL contract — one request
per line in, one response line out; ``--http HOST:PORT`` and/or
``--unix PATH`` start threaded socket transports over the same handler
(``--stdin`` adds the stdin loop alongside them).  ``--warmup`` /
``--warmup-spec PATH`` build the design tables and run the fold at the
request shapes before the first request (``--compile-cache DIR`` raises:
eager PyTorch has no persistent compilation cache); ``--window-ms`` /
``--max-batch`` / ``--no-coalesce`` tune the coalescing window; ``--stats-on-exit`` prints the stats document
to stderr on shutdown.  SIGTERM/SIGINT shut down gracefully: in-flight
requests (including any in the coalescing window) are answered first.

A serve request is either a bare spec document, an envelope, or an op::

    {"spec": {...}, "want": ["rows", "summary", "pareto", "plateaus"],
     "include_dram": false,
     "shard": {"scenario_chunk": 8, "design_chunk": 32,
               "devices": null, "by_width": true}}
    {"op": "stats"}

The response is one JSON object: ``{"ok": true, "name": ..., "axes":
{...}, "cells": ..., "elapsed_ms": ..., "source": "evaluated" |
"coalesced" | "cache" | "sharded", <one key per requested view>}`` — or
``{"ok": false, "error": ...}`` on a bad request (the process keeps
serving).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections.abc import Mapping

from repro_torch.core import device as device_mod
from repro_torch.core import report
from repro_torch.core.sweep import ShardPlan, SymbolicSweepSpec
from repro_torch.sweep.service import (  # noqa: F401 — re-exported
    SHARD_KEYS,
    WANTS,
    SweepService,
)
from repro_torch.sweep import service as service_mod


def _load(path: str) -> SymbolicSweepSpec:
    if path == "-":
        return SymbolicSweepSpec.from_json(sys.stdin.read())
    return SymbolicSweepSpec.load(path)


def _axes(spec) -> dict:
    return {"platforms": len(spec.platforms),
            "scenarios": len(spec.scenarios),
            "designs": len(spec.designs)}


def _plan_of(args: argparse.Namespace) -> ShardPlan | None:
    if not (args.shard or args.design_chunk or args.devices
            or args.by_width):
        return None
    return ShardPlan(scenario_chunk=args.shard,
                     design_chunk=args.design_chunk,
                     devices=args.devices, by_width=args.by_width)


def _progress(i: int, total: int, part) -> None:
    print(f"\r  shard {i}/{total} ({part.spec.name})",
          end="" if i < total else "\n", file=sys.stderr, flush=True)


def _add_shard_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--shard", type=int, metavar="N",
                   help="sharded lowering: chunk the scenario axis by N")
    p.add_argument("--design-chunk", type=int, metavar="N",
                   help="chunk the design axis by N")
    p.add_argument("--devices", type=int, metavar="N",
                   help="fold each chunk as a one-chunk group; only 1 is "
                        "accepted (the port runs a sweep on one device; "
                        "any other count raises)")
    p.add_argument("--by-width", action="store_true",
                   help="order scenarios by stream count before chunking "
                        "(minimizes padded-SoA area per chunk)")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="device the engines run on (default cuda; raises "
                        "without CUDA unless 'cpu' is given)")


def _run_spec(spec, plan: ShardPlan | None, device="cuda"):
    from repro_torch.core import sweep as sweep_mod
    if plan is None:
        return sweep_mod.run(spec, device=device)
    return sweep_mod.run_sharded(spec, plan, progress=_progress,
                                 device=device)


def cmd_run(args: argparse.Namespace) -> None:
    sym = _load(args.spec)
    result = _run_spec(sym.resolve(), _plan_of(args), args.device)
    rows = result.rows(include_norm=not args.no_norm,
                       include_dram=args.include_dram)
    # status lines go to stderr: stdout carries only data (the rows CSV
    # when --csv is omitted, the --summary JSON), so redirection is safe
    if args.csv:
        report.write_csv(args.csv, rows, fmt=report.fmt_exact)
        axes = _axes(result.spec)
        print(f"{sym.name}: {len(rows)} rows "
              f"({axes['platforms']} platforms x {axes['scenarios']} "
              f"scenarios x {axes['designs']} designs) -> {args.csv}",
              file=sys.stderr)
    else:
        sys.stdout.write(report.csv_str(rows, fmt=report.fmt_exact))
    if args.pareto:
        report.write_csv(args.pareto, result.pareto_front(
            include_dram=args.include_dram), fmt=report.fmt_exact)
        print(f"pareto front -> {args.pareto}", file=sys.stderr)
    if args.plateaus:
        report.write_csv(args.plateaus, result.capacity_plateaus(),
                         fmt=report.fmt_exact)
        print(f"capacity plateaus -> {args.plateaus}", file=sys.stderr)
    if args.summary:
        print(json.dumps(result.summary(), indent=2))


def cmd_mega(args: argparse.Namespace) -> None:
    """Build and run the full DTCO cross product through the sharded
    lowering (default plan: 8-scenario x 32-design chunks, width-sorted —
    a few thousand cells per chunk, bounded peak memory)."""
    from repro_torch import scenarios
    from repro_torch.core.sweep import n_cells as cells_of
    spec = scenarios.mega_spec(quick=args.quick)
    # mega is always sharded: unset knobs take chunked defaults (8 x 32,
    # width-sorted — a few thousand cells per chunk, bounded peak memory)
    plan = ShardPlan(scenario_chunk=args.shard or 8,
                     design_chunk=args.design_chunk or 32,
                     devices=args.devices, by_width=True)
    print(f"{spec.name}: {cells_of(spec)} cells "
          f"({len(spec.platforms)} platforms x {len(spec.scenarios)} "
          f"scenarios x {len(spec.designs)} designs), plan {plan}",
          file=sys.stderr)
    t0 = time.perf_counter()
    result = _run_spec(spec, plan, args.device)
    dt = time.perf_counter() - t0
    print(f"evaluated in {dt:.1f}s "
          f"({cells_of(spec) / dt:,.0f} cells/s)", file=sys.stderr)
    if args.csv:
        report.write_csv(args.csv, result.rows(), fmt=report.fmt_exact)
        print(f"rows -> {args.csv}", file=sys.stderr)
    if args.summary or not args.csv:
        print(json.dumps(result.summary(), indent=2))


def cmd_invert(args: argparse.Namespace) -> None:
    """Gradient-based inverse design: accepts a ``deepnvm.inverse/1``
    problem document or a bare sweepspec (the spec's corner grid becomes
    the relaxation's span; solver fields come from the flags)."""
    import dataclasses

    from repro_torch import inverse

    if args.spec == "-":
        doc = json.loads(sys.stdin.read())
    else:
        with open(args.spec) as f:
            doc = json.load(f)
    if doc.get("schema") == inverse.SCHEMA:
        prob = inverse.InverseProblem.from_json(doc)
    else:
        prob = inverse.InverseProblem(
            sweep=SymbolicSweepSpec.from_json(doc),
            name=doc.get("name", "inverse"))
    # flags override the document's fields only when given
    over: dict = {}
    if args.objective is not None:
        over["objective"] = args.objective
    if args.iso_area:
        over["area_budget_mm2"] = "iso"
    elif args.budget is not None:
        over["area_budget_mm2"] = args.budget
    elif args.no_budget:
        over["area_budget_mm2"] = None
    if args.target is not None:
        over["target"] = args.target
    if args.include_dram:
        over["include_dram"] = True
    for field in ("starts", "iters", "lr", "seed"):
        if getattr(args, field) is not None:
            over[field] = getattr(args, field)
    if over:
        prob = dataclasses.replace(prob, **over)

    t0 = time.perf_counter()
    res = inverse.solve(prob, device=args.device)
    dt = time.perf_counter() - t0
    print(f"{prob.name}: {prob.starts} starts x {prob.iters} iters "
          f"in {dt:.1f}s", file=sys.stderr)
    print(res.summary(), file=sys.stderr)
    out = json.dumps(res.to_doc(), indent=2) + "\n"
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
        print(f"result -> {args.json}", file=sys.stderr)
    else:
        sys.stdout.write(out)


def cmd_show(args: argparse.Namespace) -> None:
    sym = _load(args.spec)
    spec = sym.resolve()
    axes = _axes(spec)
    print(f"{spec.name}: {axes['platforms']} platforms x "
          f"{axes['scenarios']} scenarios x {axes['designs']} designs, "
          f"baseline {spec.baseline_mem!r}")
    print("platforms:", ", ".join(p.name for p in spec.platforms))
    print("scenarios:", ", ".join(sym.scenarios))
    print("designs:")
    for p in spec.designs:
        print(f"  {p.mem}@{p.capacity_mb:g}MB @{p.node.name} "
              f"(group {p.group!r})")


# The zero-window default services backing ``answer``/``serve`` for direct
# library callers, one per device: same handler as the transports, but
# requests evaluate immediately (no coalescing delay) — the historical
# single-caller contract.
_default_services: dict[str, SweepService] = {}
_default_lock = threading.Lock()


def _service(device="cuda") -> SweepService:
    device = device_mod.resolve(device)
    with _default_lock:
        svc = _default_services.get(device)
        if svc is None or svc.closed:
            svc = _default_services[device] = SweepService(window_ms=0.0,
                                                           device=device)
        return svc


def answer(request: Mapping | str, device="cuda") -> dict:
    """One serve-mode request -> one response document, evaluated on
    ``device``."""
    return _service(device).handle(request)


def serve(in_stream=None, out_stream=None, device="cuda") -> int:
    """Long-lived JSONL loop: one request per line in, one response line
    out, evaluated on ``device``.  Engine caches persist for the life of
    the process, so a warm server answers repeated specs without
    re-evaluating anything."""
    return service_mod.serve_stdio(_service(device), in_stream, out_stream)


def cmd_serve(args: argparse.Namespace) -> None:
    import signal

    stdio = args.stdin or not (args.http or args.unix)
    # Zero coalescing window for a pure stdin loop (one synchronous caller,
    # a window only adds latency); a small window once sockets are involved.
    window_ms = args.window_ms if args.window_ms is not None \
        else (0.0 if stdio and not (args.http or args.unix) else 5.0)
    svc = SweepService(window_ms=window_ms, max_batch=args.max_batch,
                      coalesce=not args.no_coalesce,
                      max_pending=args.max_pending,
                      max_body_bytes=args.max_body_bytes,
                      device=args.device)
    if args.warmup or args.warmup_spec or args.compile_cache:
        info = svc.warmup(specs=tuple(args.warmup_spec or ()),
                          compile_cache_dir=args.compile_cache,
                          grid=args.warmup)
        print(f"warmup: {info['fold_shapes']} fold shapes, "
              f"{info.get('engine_tables', 0)} engine tables, "
              f"{len(info['specs'])} specs in {info['warmup_s']:.2f}s",
              file=sys.stderr)

    servers = []
    if args.http:
        host, _, port = args.http.rpartition(":")
        srv = service_mod.SweepHTTPServer(
            (host or "127.0.0.1", int(port)), svc)
        servers.append(srv)
        bound = srv.server_address
        print(f"listening on http://{bound[0]}:{bound[1]}",
              file=sys.stderr, flush=True)
    if args.unix:
        if service_mod.SweepUnixServer is None:
            raise SystemExit("unix sockets unsupported on this platform")
        srv = service_mod.SweepUnixServer(args.unix, svc)
        servers.append(srv)
        print(f"listening on unix:{args.unix}", file=sys.stderr, flush=True)

    def _terminate(signum, frame):  # noqa: ARG001 — signal signature
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)
    threads = [threading.Thread(target=srv.serve_forever, daemon=True)
               for srv in servers]
    for t in threads:
        t.start()
    try:
        if stdio:
            service_mod.serve_stdio(svc)
        else:
            threading.Event().wait()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        svc.close()
        if args.stats_on_exit:
            print(json.dumps(svc.stats(), indent=2), file=sys.stderr)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="evaluate a spec JSON document")
    run_p.add_argument("spec", help="path to spec.json ('-' for stdin)")
    run_p.add_argument("--csv", metavar="PATH",
                       help="write rows CSV here (default: stdout)")
    run_p.add_argument("--pareto", metavar="PATH",
                       help="also write the per-scenario Pareto front")
    run_p.add_argument("--plateaus", metavar="PATH",
                       help="also write capacity-plateau rows")
    run_p.add_argument("--summary", action="store_true",
                       help="print the aggregate summary as JSON")
    run_p.add_argument("--no-norm", action="store_true",
                       help="omit the normalized (*_x) columns")
    run_p.add_argument("--include-dram", action="store_true",
                       help="include DRAM terms in energy/EDP columns")
    _add_shard_flags(run_p)
    _add_device_flag(run_p)
    run_p.set_defaults(func=cmd_run)

    mega_p = sub.add_parser(
        "mega", help="run the full 1e5-cell DTCO cross product (sharded)")
    mega_p.add_argument("--quick", action="store_true",
                        help="CI-smoke size (a few hundred cells)")
    mega_p.add_argument("--csv", metavar="PATH",
                        help="write rows CSV here")
    mega_p.add_argument("--summary", action="store_true",
                        help="print the aggregate summary as JSON")
    _add_shard_flags(mega_p)
    _add_device_flag(mega_p)
    mega_p.set_defaults(func=cmd_mega)

    inv_p = sub.add_parser(
        "invert",
        help="gradient-based inverse design over a spec's corner grid")
    inv_p.add_argument("spec", help="deepnvm.inverse/1 problem JSON or a "
                                    "sweepspec JSON ('-' for stdin)")
    inv_p.add_argument("--objective", choices=["edp", "edap"], default=None,
                       help="objective to minimize (default: the "
                            "document's, else edp)")
    inv_p.add_argument("--iso-area", action="store_true",
                       help="area budget = max grid-corner area (the "
                            "iso-area formulation)")
    inv_p.add_argument("--budget", type=float, metavar="MM2",
                       help="explicit area budget in mm^2")
    inv_p.add_argument("--no-budget", action="store_true",
                       help="drop the area constraint entirely")
    inv_p.add_argument("--target", type=float, metavar="VALUE",
                       help="target-hitting mode: drive the objective to "
                            "VALUE instead of minimizing")
    inv_p.add_argument("--include-dram", action="store_true",
                       help="include DRAM terms in the EDP objective")
    inv_p.add_argument("--starts", type=int, default=None, metavar="N",
                       help="multi-start batch size")
    inv_p.add_argument("--iters", type=int, default=None, metavar="N",
                       help="Adam iterations per start")
    inv_p.add_argument("--lr", type=float, default=None,
                       help="Adam learning rate (ln-leaf space)")
    inv_p.add_argument("--seed", type=int, default=None,
                       help="start-sampling seed")
    inv_p.add_argument("--json", metavar="PATH",
                       help="write the result document here (default: "
                            "stdout)")
    _add_device_flag(inv_p)
    inv_p.set_defaults(func=cmd_invert)

    show_p = sub.add_parser("show", help="resolve a spec without running")
    show_p.add_argument("spec")
    show_p.set_defaults(func=cmd_show)

    serve_p = sub.add_parser(
        "serve",
        help="concurrent sweep service (stdin JSONL / HTTP / unix socket)")
    serve_p.add_argument("--http", metavar="HOST:PORT",
                         help="serve HTTP on this address (port 0 picks "
                              "an ephemeral port, printed to stderr)")
    serve_p.add_argument("--unix", metavar="PATH",
                         help="serve JSONL over a unix stream socket")
    serve_p.add_argument("--stdin", action="store_true",
                         help="also run the stdin JSONL loop alongside "
                              "socket transports (default when no "
                              "transport flag is given)")
    serve_p.add_argument("--window-ms", type=float, default=None,
                         metavar="MS",
                         help="coalescing window (default 5ms with a "
                              "socket transport, 0 for stdin-only)")
    serve_p.add_argument("--max-batch", type=int, default=64, metavar="N",
                         help="max requests merged per coalesced batch")
    serve_p.add_argument("--no-coalesce", action="store_true",
                         help="disable request coalescing")
    serve_p.add_argument("--max-pending", type=int, default=64, metavar="N",
                         help="evaluations admitted concurrently before "
                              "requests are refused with 429")
    serve_p.add_argument("--max-body-bytes", type=int, default=1 << 20,
                         metavar="N",
                         help="largest request document accepted (larger "
                              "bodies are refused with 413, unread)")
    serve_p.add_argument("--warmup", action="store_true",
                         help="pre-trace engine + fold kernels at the "
                              "registered pad-width buckets before serving")
    serve_p.add_argument("--warmup-spec", action="append", metavar="PATH",
                         help="pre-trace the exact shapes this spec needs "
                              "(repeatable)")
    serve_p.add_argument("--compile-cache", metavar="DIR",
                         help="raises: the JAX package's persistent "
                              "compilation cache has no PyTorch "
                              "counterpart (eager code compiles nothing "
                              "to keep)")
    serve_p.add_argument("--stats-on-exit", action="store_true",
                         help="print the stats document to stderr on "
                              "shutdown")
    _add_device_flag(serve_p)
    serve_p.set_defaults(func=cmd_serve)

    args = ap.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
