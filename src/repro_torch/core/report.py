"""CSV/markdown emission helpers shared by benchmarks and launch tools."""

from __future__ import annotations

import csv
import io
import os
from collections.abc import Mapping, Sequence


def csv_str(rows: Sequence[Mapping[str, object]],
            fields: Sequence[str] | None = None,
            fmt: "callable | None" = None) -> str:
    """Rows to CSV text.  ``fmt`` maps each cell value; the default
    human-readable rounding is ``_fmt``, and ``fmt_exact`` keeps floats at
    full repr precision (the CLI's bit-for-bit mode)."""
    if not rows:
        return ""
    fmt = fmt if fmt is not None else _fmt
    fields = list(fields) if fields else list(rows[0].keys())
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=fields, extrasaction="ignore")
    w.writeheader()
    for r in rows:
        w.writerow({k: fmt(r.get(k)) for k in fields})
    return buf.getvalue()


def write_csv(path: str, rows: Sequence[Mapping[str, object]],
              fields: Sequence[str] | None = None,
              fmt: "callable | None" = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(csv_str(rows, fields, fmt))


def fmt_exact(v: object) -> object:
    """Lossless cell formatting: floats via repr (round-trips exactly)."""
    return repr(v) if isinstance(v, float) else v


def markdown_table(rows: Sequence[Mapping[str, object]],
                   fields: Sequence[str] | None = None) -> str:
    if not rows:
        return "(empty)"
    fields = list(fields) if fields else list(rows[0].keys())
    out = ["| " + " | ".join(fields) + " |",
           "|" + "|".join("---" for _ in fields) + "|"]
    for r in rows:
        out.append("| " + " | ".join(str(_fmt(r.get(k))) for k in fields) + " |")
    return "\n".join(out)


def _fmt(v: object) -> object:
    if isinstance(v, float):
        if v == 0:
            return 0
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.4g}"
        return round(v, 4)
    return v
