"""Exit-coded regression gate over bench history and ledger files.

::

    python -m repro_torch.obs.regress --history BENCH_HISTORY.jsonl [--window 5]
    python -m repro_torch.obs.regress --ledger LEDGER_outofcore.json
    python -m repro_torch.obs.regress --history ... --ledger ... --strict-times

Two gates, both designed for CI:

- **History** (``--history``): each line of the JSONL file is one bench
  emission (``benchmarks/history.py`` appends them with provenance).  For
  every bench name, the newest entry is compared row-by-row against a
  rolling baseline built from up to ``--window`` prior entries of the same
  configuration (same quick flag / backend / device count).  Metrics are
  classified by key:

  - *deterministic* (bytes, waves, slots, nnz, counts, shapes) must match
    the baseline **exactly** — they are pure functions of the store shapes,
    so any drift is a real behavior change and fails the gate;
  - *time-like* metrics (seconds, rates) are compared against the rolling
    median with a relative threshold (``--time-tol``) and only **warn** by
    default (CI machines are noisy); ``--strict-times`` promotes them;
  - everything else (RMSE, ratios) warns beyond ``--noise-tol``.

  A bench with no baseline yet passes (first run seeds the history).

- **Ledger** (``--ledger``, repeatable): validates the file against the
  :mod:`repro_torch.obs.ledger` schema (which recomputes every verdict) and
  fails on any error-severity record whose check does not hold — a seeded
  or real mis-prediction exits nonzero.

Exit code 0 = clean (warnings allowed), 1 = hard failure.  Stdlib-only.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
from typing import Optional

from repro_torch.obs.ledger import validate_ledger

#: the reference's bench-history schema, byte for byte
HISTORY_SCHEMA = "repro.obs/bench-history-v1"

#: metric keys that are deterministic functions of the problem shapes —
#: exact-match across runs of the same code, or the gate fails
DETERMINISTIC_RE = re.compile(
    r"(bytes|waves|batches|slots|nnz|epochs|iters|count|^m$|^n$|^f$|^p$"
    r"|^q$|^g$|^k$|n_data|mesh_shape|^fits$|fill_waste)", re.IGNORECASE)
#: wall-clock-derived keys — noisy, warn-only unless --strict-times
TIME_RE = re.compile(
    r"(seconds|_s$|_per_sec|per_iter_s|^t$|time)", re.IGNORECASE)
#: metered peaks depend on prefetch-pipeline timing (how many buffers were
#: simultaneously live), so they are bounded, not deterministic
NOISY_OVERRIDE_RE = re.compile(r"peak", re.IGNORECASE)
#: keys never compared (identity / bookkeeping)
SKIP_KEYS = frozenset({"provenance", "curve", "ledger", "name", "solver"})


def classify(key: str) -> str:
    if NOISY_OVERRIDE_RE.search(key):
        return "noisy"
    if TIME_RE.search(key):        # before DETERMINISTIC: epochs_per_sec
        return "time"
    if DETERMINISTIC_RE.search(key):
        return "deterministic"
    return "noisy"


def load_history(path: str) -> list[dict]:
    entries = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("schema") != HISTORY_SCHEMA:
                raise ValueError(
                    f"{path}:{lineno}: schema {obj.get('schema')!r} != "
                    f"{HISTORY_SCHEMA!r}")
            entries.append(obj)
    return entries


def _config_key(entry: dict) -> tuple:
    prov = entry.get("provenance", {})
    return (entry.get("bench"), prov.get("quick"),
            prov.get("backend"), prov.get("device_count"))


def _row_key(row: dict) -> str:
    return str(row.get("name") or row.get("solver") or "?")


def _flatten(row: dict, prefix: str = "") -> dict:
    """Numeric leaves of one bench row, dotted keys for nested dicts
    (``phase_seconds.solve``); skip-listed and non-numeric leaves drop."""
    out = {}
    for key, val in row.items():
        if key in SKIP_KEYS:
            continue
        name = f"{prefix}{key}"
        if isinstance(val, bool):
            out[name] = int(val)
        elif isinstance(val, (int, float)):
            out[name] = val
        elif isinstance(val, dict):
            out.update(_flatten(val, prefix=name + "."))
    return out


def compare_history(entries: list[dict], *, window: int = 5,
                    time_tol: float = 0.5, noise_tol: float = 0.05,
                    strict_times: bool = False) -> tuple[list[str], int]:
    """(report lines, hard-failure count) of newest-vs-baseline per bench."""
    lines: list[str] = []
    failures = 0
    by_cfg: dict[tuple, list[dict]] = {}
    for entry in entries:
        by_cfg.setdefault(_config_key(entry), []).append(entry)

    for cfg, group in sorted(by_cfg.items(), key=lambda kv: str(kv[0])):
        newest, prior = group[-1], group[-window - 1:-1]
        label = f"{cfg[0]} (quick={cfg[1]}, backend={cfg[2]}, dev={cfg[3]})"
        if not prior:
            lines.append(f"SEED {label}: first run, no baseline yet")
            continue
        new_rows = {_row_key(r): _flatten(r) for r in newest["records"]}
        base_rows: dict[str, dict[str, list]] = {}
        for entry in prior:
            for row in entry["records"]:
                metrics = base_rows.setdefault(_row_key(row), {})
                for key, val in _flatten(row).items():
                    metrics.setdefault(key, []).append(val)
        checked = 0
        for rkey, metrics in sorted(new_rows.items()):
            base = base_rows.get(rkey)
            if base is None:
                lines.append(f"NEW  {label} :: {rkey}: no baseline row")
                continue
            for mkey, val in sorted(metrics.items()):
                hist = base.get(mkey)
                if not hist:
                    continue
                checked += 1
                kind = classify(mkey)
                if kind == "deterministic":
                    ref = hist[-1]       # exact lineage, not a median
                    if val != ref:
                        failures += 1
                        lines.append(
                            f"FAIL {label} :: {rkey}.{mkey}: {val} != "
                            f"baseline {ref} (deterministic metric drifted)")
                    continue
                ref = statistics.median(hist)
                tol = time_tol if kind == "time" else noise_tol
                if ref == 0:
                    drifted = abs(val) > tol
                    desc = f"{val} vs baseline 0"
                else:
                    rel = (val - ref) / abs(ref)
                    drifted = abs(rel) > tol
                    desc = f"{val:.6g} vs median {ref:.6g} ({rel:+.1%})"
                if drifted:
                    hard = strict_times if kind == "time" else False
                    failures += 1 if hard else 0
                    lines.append(
                        f"{'FAIL' if hard else 'WARN'} {label} :: "
                        f"{rkey}.{mkey}: {desc} beyond {tol:.0%}")
        lines.append(f"OK   {label}: {checked} metrics vs "
                     f"{len(prior)}-run baseline")
    return lines, failures


def check_ledger(path: str) -> tuple[list[str], int]:
    """(report lines, hard-failure count) for one serialized ledger."""
    lines: list[str] = []
    with open(path) as f:
        obj = json.load(f)
    try:
        summary = validate_ledger(obj)
    except ValueError as e:
        return [f"FAIL {path}: {e}"], 1
    failures = summary["errors"]
    for rec in obj["records"]:
        if rec["ok"]:
            continue
        tag = "FAIL" if rec["severity"] == "error" else "WARN"
        lines.append(
            f"{tag} {path} :: {rec['name']}: predicted={rec['predicted']} "
            f"measured={rec['measured']} (check={rec['check']}, "
            f"drift={rec['drift']})")
    lines.append(f"{'FAIL' if failures else 'OK  '} {path}: "
                 f"{summary['records']} records, {failures} error flag(s), "
                 f"{summary['warnings']} warn flag(s)")
    return lines, failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--history", default=None, metavar="JSONL",
                    help="bench history file to gate (BENCH_HISTORY.jsonl)")
    ap.add_argument("--ledger", action="append", default=[],
                    metavar="JSON", help="ledger file to gate (repeatable)")
    ap.add_argument("--window", type=int, default=5,
                    help="rolling-baseline size (default 5 prior runs)")
    ap.add_argument("--time-tol", type=float, default=0.5,
                    help="relative threshold for time metrics (default 0.5)")
    ap.add_argument("--noise-tol", type=float, default=0.05,
                    help="relative threshold for other noisy metrics")
    ap.add_argument("--strict-times", action="store_true",
                    help="promote time-metric drift from warn to fail")
    args = ap.parse_args(argv)
    if not args.history and not args.ledger:
        ap.error("nothing to check: pass --history and/or --ledger")

    failures = 0
    if args.history:
        entries = load_history(args.history)
        lines, n = compare_history(
            entries, window=args.window, time_tol=args.time_tol,
            noise_tol=args.noise_tol, strict_times=args.strict_times)
        failures += n
        print(f"history: {len(entries)} run(s) in {args.history}")
        for line in lines:
            print(" " + line)
    for path in args.ledger:
        lines, n = check_ledger(path)
        failures += n
        for line in lines:
            print(line)
    print(f"regress: {'FAIL' if failures else 'PASS'} "
          f"({failures} hard failure(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
