"""Stdlib client for the sweep service — library helpers plus a small
CLI used by the CI smoke job and the serve benchmark.

    python -m repro_torch.sweep.client --url 127.0.0.1:8731 \
        --want rows specs/isocap.json specs/isocap.json --concurrency 8

Fires every request concurrently (one thread per request up to
``--concurrency``), prints one response JSON line per request in input
order, and exits nonzero if any response is not ok — so a shell can both
capture parity data and assert health in one call.  ``--stats`` prints
the server's stats document to stderr afterwards (the coalesce counters
the smoke job asserts on).
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
import urllib.error
import urllib.request
from collections.abc import Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor


def _base(url: str) -> str:
    if "://" not in url:
        url = "http://" + url
    return url.rstrip("/")


def http_request(url: str, doc: Mapping, timeout: float = 600.0) -> dict:
    """POST one request document; error responses (HTTP 400) still carry
    the service's JSON error document, which is returned, not raised."""
    data = json.dumps(doc).encode()
    req = urllib.request.Request(
        _base(url) + "/", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode())


def http_stats(url: str, timeout: float = 60.0) -> dict:
    with urllib.request.urlopen(_base(url) + "/stats",
                                timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def wait_ready(url: str, timeout: float = 60.0) -> bool:
    """Poll /healthz until the server answers (startup gate)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(_base(url) + "/healthz",
                                        timeout=5.0) as resp:
                if resp.status == 200:
                    return True
        except OSError:
            time.sleep(0.1)
    return False


def unix_request(path: str, docs: Sequence[Mapping],
                 timeout: float = 600.0) -> list[dict]:
    """One unix-socket connection, JSONL: send every document, read one
    response line per document (in order)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(path)
        f = sock.makefile("rwb")
        for doc in docs:
            f.write((json.dumps(doc) + "\n").encode())
        f.flush()
        return [json.loads(f.readline().decode()) for _ in docs]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep.client",
        description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="+",
                    help="spec JSON paths; each becomes one request")
    ap.add_argument("--url", default="127.0.0.1:8731",
                    metavar="HOST:PORT", help="HTTP server address")
    ap.add_argument("--want", action="append", metavar="VIEW",
                    help="requested views (repeatable; default summary)")
    ap.add_argument("--include-dram", action="store_true")
    ap.add_argument("--concurrency", type=int, default=8, metavar="N",
                    help="max in-flight requests (default 8)")
    ap.add_argument("--wait", type=float, default=60.0, metavar="S",
                    help="wait up to S seconds for /healthz first")
    ap.add_argument("--stats", action="store_true",
                    help="print the server stats document to stderr")
    args = ap.parse_args(argv)

    if args.wait and not wait_ready(args.url, args.wait):
        print(f"server at {args.url} not ready", file=sys.stderr)
        return 2
    requests = []
    for path in args.specs:
        with open(path) as f:
            doc = {"spec": json.load(f),
                   "want": args.want or ["summary"],
                   "include_dram": args.include_dram}
        requests.append(doc)
    with ThreadPoolExecutor(max_workers=max(1, args.concurrency)) as pool:
        responses = list(pool.map(
            lambda doc: http_request(args.url, doc), requests))
    ok = True
    for resp in responses:
        print(json.dumps(resp))
        ok = ok and bool(resp.get("ok"))
    if args.stats:
        print(json.dumps(http_stats(args.url), indent=2), file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
