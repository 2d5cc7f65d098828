"""Trace aggregation of the port: JSONL spans -> per-phase wall/self-time
table.

Port of ``repro.telemetry.report``, with the command line of the
reference's ``scripts/trace_report.py``::

    python -m repro_torch.telemetry.report trace.jsonl [more.jsonl] [--json]

A span's **total** time is its own duration; its **self** time is the
duration less the durations of its *direct* children.  Self-times
telescope: summed over every span of a properly nested trace they equal
the root spans' total wall time, so the coverage figure reads as "how
much of the run the named phases account for" (1 by construction when
a root span wraps the run).  Stdlib only.
"""
from __future__ import annotations

import argparse
import json
import sys


def load_spans(path: str) -> list[dict]:
    """Parse one JSONL trace file into span records.

    Non-JSON and non-span lines are skipped (the format is append-only
    and a crashed run may leave a torn final line).
    """
    spans: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "name" in rec and "dur" in rec:
                spans.append(rec)
    return spans


def aggregate(spans: list[dict]) -> tuple[dict[str, dict], float]:
    """Per-phase stats + root wall time.

    Returns ``({name: {count, total, self, min, max}}, wall)`` where
    ``wall`` is the summed duration of parentless (root) spans.
    """
    child_dur: dict[int, float] = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            child_dur[p] = child_dur.get(p, 0.0) + s["dur"]
    stats: dict[str, dict] = {}
    wall = 0.0
    for s in spans:
        st = stats.setdefault(s["name"], {
            "count": 0, "total": 0.0, "self": 0.0,
            "min": float("inf"), "max": 0.0})
        dur = float(s["dur"])
        st["count"] += 1
        st["total"] += dur
        st["self"] += dur - child_dur.get(s.get("id"), 0.0)
        st["min"] = min(st["min"], dur)
        st["max"] = max(st["max"], dur)
        if s.get("parent") is None:
            wall += dur
    return stats, wall


def coverage(spans: list[dict]) -> float:
    """Fraction of root wall time the per-phase self-times account for."""
    stats, wall = aggregate(spans)
    if wall <= 0.0:
        return 0.0
    return sum(st["self"] for st in stats.values()) / wall


def format_table(stats: dict[str, dict], wall: float) -> str:
    """Human per-phase table, widest self-time first."""
    rows = sorted(stats.items(), key=lambda kv: -kv[1]["self"])
    name_w = max([len("phase")] + [len(n) for n in stats])
    head = (f"{'phase':<{name_w}}  {'count':>5}  {'total_s':>9}  "
            f"{'self_s':>9}  {'self_%':>6}  {'min_s':>9}  {'max_s':>9}")
    lines = [head, "-" * len(head)]
    for name, st in rows:
        pct = 100.0 * st["self"] / wall if wall > 0 else 0.0
        lines.append(
            f"{name:<{name_w}}  {st['count']:>5}  {st['total']:>9.4f}  "
            f"{st['self']:>9.4f}  {pct:>6.1f}  {st['min']:>9.4f}  "
            f"{st['max']:>9.4f}")
    covered = sum(st["self"] for st in stats.values())
    pct = 100.0 * covered / wall if wall > 0 else 0.0
    lines.append(f"wall {wall:.4f}s; phase self-times cover "
                 f"{covered:.4f}s ({pct:.1f}%)")
    return "\n".join(lines)


def report(path: str) -> str:
    """One-call convenience: load, aggregate, format."""
    stats, wall = aggregate(load_spans(path))
    return format_table(stats, wall)


def main(argv: list[str] | None = None) -> int:
    """The command line: a table a trace file (``--json``: one JSON
    object, path -> wall, span count and phases); 1 when a file cannot
    be read."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="per-phase wall/self-time summary of telemetry "
                    "JSONL traces")
    ap.add_argument("paths", nargs="+", help="trace .jsonl file(s)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    out_json: dict = {}
    status = 0
    for path in args.paths:
        try:
            spans = load_spans(path)
        except OSError as e:
            print(f"{path}: cannot read trace: {e}", file=sys.stderr)
            status = 1
            continue
        stats, wall = aggregate(spans)
        if args.json:
            out_json[path] = {"wall": wall, "spans": len(spans),
                              "phases": stats}
        else:
            print(f"== {path} ({len(spans)} span(s)) ==")
            print(format_table(stats, wall) if spans else "(empty trace)")
            print()
    if args.json:
        print(json.dumps(out_json, indent=1))
    return status


if __name__ == "__main__":
    sys.exit(main())
