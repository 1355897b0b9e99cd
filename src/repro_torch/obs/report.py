"""Run-summary renderer for ledger (and trace) files.

::

    python -m repro_torch.obs.report LEDGER.json [--trace trace.json] [--top N]

Prints, for one serialized :mod:`repro_torch.obs.ledger` object: the run context,
the phase-seconds breakdown (where the wall clock went), the plan-vs-actual
table with per-record drift and verdicts, and the drift flags.  With
``--trace`` it also lists the top spans by duration and the per-category
span counts from a Chrome-trace file (the ``--trace`` output of the
drivers/benches).

Rendering only — the exit-coded CI gate over the same files is
``python -m repro_torch.obs.regress``.  Stdlib-only.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.obs.ledger import validate_ledger


def _fmt_qty(v, unit: str) -> str:
    if v is None:
        return "-"
    if unit == "bytes":
        for thresh, suf in ((1 << 30, "GiB"), (1 << 20, "MiB"),
                            (1 << 10, "KiB")):
            if abs(v) >= thresh:
                return f"{v / thresh:.2f}{suf}"
        return f"{v}B"
    if unit == "seconds":
        return f"{v:.3f}s"
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def _fmt_drift(drift) -> str:
    if drift is None:
        return "undef"
    return f"{drift * 100:+.2f}%"


def _table(rows: list[list[str]], header: list[str]) -> list[str]:
    widths = [max(len(r[i]) for r in [header] + rows)
              for i in range(len(header))]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    return [line(header), line(["-" * w for w in widths])] + \
        [line(r) for r in rows]


def render_ledger(obj: dict) -> str:
    """The full text report of one serialized ledger (validates first)."""
    summary = validate_ledger(obj)
    out = [f"ledger: {summary['records']} records, "
           f"ok={summary['ok']} "
           f"({summary['errors']} error, {summary['warnings']} warn flags)"]

    run = obj["run"]
    phase_seconds = None
    ctx_rows = []
    for key in sorted(run):
        if key == "phase_seconds":
            phase_seconds = run[key]
            continue
        val = run[key]
        if isinstance(val, dict):      # merged hybrid ledgers nest contexts
            val = json.dumps(val, sort_keys=True)
        ctx_rows.append(f"  {key} = {val}")
    out.append("")
    out.append("run:")
    out.extend(ctx_rows)

    if phase_seconds:
        total = sum(phase_seconds.values())
        driver = phase_seconds.get("driver", total)
        out.append("")
        out.append("phase breakdown:")
        rows = [[cat, f"{secs:.3f}s",
                 f"{secs / driver * 100:.1f}%" if driver else "-"]
                for cat, secs in sorted(phase_seconds.items(),
                                        key=lambda kv: -kv[1])]
        out.extend("  " + l for l in
                   _table(rows, ["phase", "seconds", "% of driver"]))

    out.append("")
    out.append("plan vs actual:")
    rows = []
    for rec in obj["records"]:
        rows.append([
            rec["name"],
            _fmt_qty(rec["predicted"], rec["unit"]),
            _fmt_qty(rec["measured"], rec["unit"]),
            _fmt_drift(rec["drift"]),
            rec["check"],
            "ok" if rec["ok"] else f"DRIFT({rec['severity']})",
        ])
    out.extend("  " + l for l in
               _table(rows, ["record", "predicted", "measured", "drift",
                             "check", "verdict"]))

    out.append("")
    if obj["flags"]:
        out.append("drift flags: " + ", ".join(obj["flags"]))
    else:
        out.append("drift flags: none")
    return "\n".join(out)


def render_trace_tops(trace_obj: dict, top: int = 10) -> str:
    """Top spans by duration + per-category counts from a Chrome trace."""
    from repro_torch.obs.export import span_counts
    spans = [e for e in trace_obj.get("traceEvents", [])
             if e.get("ph") == "X"]
    spans.sort(key=lambda e: -e.get("dur", 0))
    out = [f"top {min(top, len(spans))} spans (of {len(spans)}):"]
    rows = [[e.get("name", "?"), str(e.get("cat", "?")),
             f"{e.get('dur', 0) / 1e6:.3f}s"]
            for e in spans[:top]]
    out.extend("  " + l for l in _table(rows, ["span", "cat", "dur"]))
    counts = span_counts(trace_obj)
    out.append("span counts: " + ", ".join(
        f"{cat}={n}" for cat, n in sorted(counts.items())))
    return "\n".join(out)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ledger", help="serialized ledger JSON file")
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="also summarize a Chrome-trace file")
    ap.add_argument("--top", type=int, default=10,
                    help="spans to list from --trace (default 10)")
    args = ap.parse_args(argv)

    with open(args.ledger) as f:
        obj = json.load(f)
    print(render_ledger(obj))
    if args.trace:
        with open(args.trace) as f:
            trace_obj = json.load(f)
        print()
        print(render_trace_tops(trace_obj, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
