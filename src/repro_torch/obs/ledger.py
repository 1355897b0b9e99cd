"""Plan-vs-actual ledger: the repo's predictions confronted with its meters.

The paper's whole argument is a cost model — eq. 5-8 price the bytes a wave
moves, §4.4 prices what stays resident, Fig. 5b prices the reduction — and
the repo both *predicts* those numbers (``core.partition.plan_for``,
``outofcore.schedule.required_capacity_bytes``, ``kernels.budgets``) and
*measures* them (``MemoryMeter``, the ``obs`` registry counters).  A
:class:`Ledger` is the closing of that loop: one structured record per
predicted quantity, each carrying the prediction, the measurement, a
relative-drift number, and a verdict under a declared check:

- ``"exact"`` — measured must equal predicted.  Byte and count metrics are
  deterministic functions of the store shapes, so anything but equality
  means the model (or the instrumentation) is wrong.
- ``"le"``    — measured must not exceed predicted: capacity bounds
  (metered peak vs budget, kernel footprint vs VMEM limit).
- ``"rel"``   — |measured - predicted| <= rel_tol * |predicted|: noisy
  quantities (times, float ratios).

``severity="warn"`` records never fail the ledger as a whole (time metrics
are warn-only by design); ``severity="error"`` records decide ``ok``.

The ledger serializes to one JSON object (:meth:`Ledger.to_obj`) that the
streaming drivers attach to their :class:`StreamTelemetry`, benches write
next to their BENCH rows, ``python -m repro_torch.obs.report`` renders, and
``python -m repro_torch.obs.regress --ledger`` exit-codes for CI.
:func:`validate_ledger` is the schema gate: it checks structure AND
recomputes every verdict, so a ledger whose ``ok`` flags disagree with its
own numbers is rejected, not trusted.

Stdlib-only, like the rest of ``repro_torch.obs``.
"""
from __future__ import annotations

from typing import Mapping, Optional

#: the reference's schema string, byte for byte: either package validates and
#: renders the other's ledgers
LEDGER_SCHEMA = "repro.obs/ledger-v1"
CHECKS = ("exact", "le", "rel")
SEVERITIES = ("error", "warn")


def _drift(predicted, measured) -> Optional[float]:
    """Relative drift (measured - predicted) / predicted; None when the
    prediction is zero and the measurement is not (undefined, and JSON has
    no clean infinity)."""
    if predicted:
        return (measured - predicted) / predicted
    return 0.0 if not measured else None


def _verdict(check: str, predicted, measured, rel_tol: float) -> bool:
    if check == "exact":
        return measured == predicted
    if check == "le":
        return measured <= predicted
    if check == "rel":
        if predicted:
            return abs(measured - predicted) <= rel_tol * abs(predicted)
        return abs(measured) <= rel_tol
    raise ValueError(f"unknown check {check!r}")


class Ledger:
    """One run's plan-vs-actual records plus its run context.

    ``**run`` is free-form context (solver, mesh shape, wave counts,
    phase_seconds, ...) carried verbatim into the serialized object —
    whatever the report CLI needs to label the run.
    """

    def __init__(self, **run):
        self.run = dict(run)
        self.records: list[dict] = []

    def record(self, name: str, predicted, measured, *, unit: str,
               check: str = "exact", rel_tol: float = 0.0,
               severity: str = "error", **context) -> dict:
        """Append one plan-vs-actual record and return it.

        The verdict is computed here, from the numbers — callers never set
        ``ok`` themselves, which is what lets ``validate_ledger`` recompute
        and reject a tampered or stale ledger.
        """
        assert check in CHECKS, check
        assert severity in SEVERITIES, severity
        predicted = predicted if isinstance(predicted, int) else float(predicted)
        measured = measured if isinstance(measured, int) else float(measured)
        rec = {
            "name": str(name),
            "unit": str(unit),
            "check": check,
            "severity": severity,
            "predicted": predicted,
            "measured": measured,
            "rel_tol": float(rel_tol),
            "drift": _drift(predicted, measured),
            "ok": _verdict(check, predicted, measured, rel_tol),
        }
        if context:
            rec["context"] = context
        self.records.append(rec)
        return rec

    @property
    def ok(self) -> bool:
        """True iff every error-severity record holds."""
        return all(r["ok"] for r in self.records if r["severity"] == "error")

    @property
    def flags(self) -> list[str]:
        """``severity:name`` of every failing record (warn ones included —
        they are reported, they just do not decide ``ok``)."""
        return [f"{r['severity']}:{r['name']}"
                for r in self.records if not r["ok"]]

    def to_obj(self) -> dict:
        """The JSON-ready serialized form (``validate_ledger``'s input)."""
        return {
            "schema": LEDGER_SCHEMA,
            "run": dict(self.run),
            "records": [dict(r) for r in self.records],
            "ok": self.ok,
            "flags": self.flags,
        }


def validate_ledger(obj) -> dict:
    """Schema + consistency gate over a serialized ledger.

    Raises ``ValueError`` on any structural problem or on a verdict that
    does not follow from its own record's numbers; returns a summary
    ``{"records", "errors", "warnings", "ok"}`` (errors/warnings count the
    *failing* records per severity).
    """
    def fail(msg):
        raise ValueError(f"invalid ledger: {msg}")

    if not isinstance(obj, dict):
        fail(f"expected object, got {type(obj).__name__}")
    if obj.get("schema") != LEDGER_SCHEMA:
        fail(f"schema {obj.get('schema')!r} != {LEDGER_SCHEMA!r}")
    for key in ("run", "records", "ok", "flags"):
        if key not in obj:
            fail(f"missing top-level key {key!r}")
    if not isinstance(obj["run"], dict):
        fail("run context must be an object")
    if not isinstance(obj["records"], list):
        fail("records must be a list")

    n_err = n_warn = 0
    flags = []
    for i, rec in enumerate(obj["records"]):
        where = f"records[{i}]"
        if not isinstance(rec, dict):
            fail(f"{where} is not an object")
        for key in ("name", "unit", "check", "severity",
                    "predicted", "measured", "rel_tol", "drift", "ok"):
            if key not in rec:
                fail(f"{where} missing key {key!r}")
        if rec["check"] not in CHECKS:
            fail(f"{where} unknown check {rec['check']!r}")
        if rec["severity"] not in SEVERITIES:
            fail(f"{where} unknown severity {rec['severity']!r}")
        for key in ("predicted", "measured"):
            if isinstance(rec[key], bool) or \
                    not isinstance(rec[key], (int, float)):
                fail(f"{where}.{key} is not a number: {rec[key]!r}")
        want_ok = _verdict(rec["check"], rec["predicted"], rec["measured"],
                           rec["rel_tol"])
        if bool(rec["ok"]) != want_ok:
            fail(f"{where} ({rec['name']}) verdict ok={rec['ok']} "
                 f"inconsistent with predicted={rec['predicted']} "
                 f"measured={rec['measured']} under check={rec['check']}")
        want_drift = _drift(rec["predicted"], rec["measured"])
        got_drift = rec["drift"]
        if want_drift is None:
            if got_drift is not None:
                fail(f"{where} drift should be null")
        elif got_drift is None or abs(got_drift - want_drift) > 1e-9:
            fail(f"{where} drift {got_drift!r} != {want_drift!r}")
        if not rec["ok"]:
            flags.append(f"{rec['severity']}:{rec['name']}")
            if rec["severity"] == "error":
                n_err += 1
            else:
                n_warn += 1
    want_overall = n_err == 0
    if bool(obj["ok"]) != want_overall:
        fail(f"overall ok={obj['ok']} but {n_err} error record(s) fail")
    if list(obj["flags"]) != flags:
        fail(f"flags {obj['flags']!r} != recomputed {flags!r}")
    return {"records": len(obj["records"]), "errors": n_err,
            "warnings": n_warn, "ok": want_overall}


def merge_ledgers(parts: Mapping[str, Optional[dict]]) -> dict:
    """One ledger over a multi-phase run (the hybrid driver's telemetry
    merge).  ``parts`` maps phase name -> serialized ledger (None for a
    phase that did not run); record names and flags are prefixed with the
    phase name (``als/bytes_streamed``), run contexts nest under their
    phase keys, and the merged ``ok`` is the conjunction.
    """
    live = {k: v for k, v in parts.items() if v}
    assert live, "merge_ledgers needs at least one non-empty ledger"
    records = []
    flags = []
    for name, obj in live.items():
        for rec in obj["records"]:
            r = dict(rec)
            r["name"] = f"{name}/{rec['name']}"
            records.append(r)
            if not r["ok"]:
                flags.append(f"{r['severity']}:{r['name']}")
    return {
        "schema": LEDGER_SCHEMA,
        "run": {name: dict(obj["run"]) for name, obj in live.items()},
        "records": records,
        "ok": all(obj["ok"] for obj in live.values()),
        "flags": flags,
    }
