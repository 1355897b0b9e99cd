"""Chrome-trace / Perfetto JSON export of a recorded ``Tracer``.

Emits the JSON *object* flavor of the Trace Event Format — the shape both
``chrome://tracing`` and https://ui.perfetto.dev load directly:

    {"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}

Span events are ``ph: "X"`` (complete) with microsecond ``ts``/``dur``;
each thread that recorded at least one event gets a ``ph: "M"``
``thread_name`` metadata record so the prefetch worker shows up as its own
named track next to the main thread.  Counter samples (``ph: "C"``, e.g.
prefetch queue depth) render as Perfetto counter tracks.  When a
``MetricsRegistry`` is passed along, its snapshot rides in ``otherData``
so one file carries the timeline *and* the numbers.

``validate_chrome_trace`` is the schema gate the tests and the CI
bench-smoke job run over the emitted file: required keys per event,
non-negative times, and — per thread — properly *nested* spans (a span
must either contain or be disjoint from any span it overlaps; partial
overlap on one thread means broken instrumentation).
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.trace import Tracer, process_id


def chrome_trace(tracer: Tracer, registry=None,
                 process_name: str = "repro_torch") -> dict:
    """Render a tracer's events as a Chrome-trace JSON object."""
    pid = process_id()
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for tid, tname in sorted(tracer.thread_names.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for ev in sorted(tracer.events, key=lambda e: (e.ts, -e.dur)):
        rec = {"name": ev.name, "cat": ev.cat or "default", "ph": ev.ph,
               "ts": ev.ts, "pid": pid, "tid": ev.tid, "args": ev.args}
        if ev.ph == "X":
            rec["dur"] = ev.dur
        elif ev.ph == "i":
            rec["s"] = "t"              # thread-scoped instant
        events.append(rec)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if registry is not None:
        out["otherData"] = {"metrics": registry.snapshot()}
    return out


def write_trace(path: str, tracer: Tracer, registry=None,
                process_name: str = "repro_torch") -> dict:
    """Serialize :func:`chrome_trace` to ``path``; returns the object."""
    obj = chrome_trace(tracer, registry=registry, process_name=process_name)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj: dict) -> dict:
    """Schema-check a trace object (or raise ``ValueError``).

    Checks: the top-level shape, per-event required keys, non-negative
    microsecond times, and per-thread span nesting.  Returns summary
    stats ``{"events": n, "spans": n, "cats": {...}, "tids": {...}}`` so
    callers (CI) can assert coverage on top.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")

    spans_by_tid: dict[int, list[tuple[float, float, str]]] = {}
    cats: set[str] = set()
    n_spans = 0
    for i, ev in enumerate(events):
        for key in ("name", "ph", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"event {i} missing 'ts': {ev}")
        if ev["ts"] < 0:
            raise ValueError(f"event {i} has negative ts: {ev}")
        cats.add(ev.get("cat", "default"))
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if dur is None or dur < 0:
                raise ValueError(f"span {i} missing/negative 'dur': {ev}")
            n_spans += 1
            spans_by_tid.setdefault(ev["tid"], []).append(
                (ev["ts"], dur, ev["name"]))

    # per-thread nesting: walking spans by (start, longest-first), every
    # span must close before any enclosing span closes
    for tid, spans in spans_by_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple[float, str]] = []     # (end, name)
        for ts, dur, name in spans:
            while stack and stack[-1][0] <= ts:
                stack.pop()
            end = ts + dur
            if stack and end > stack[-1][0]:
                raise ValueError(
                    f"tid {tid}: span {name!r} [{ts}, {end}] partially "
                    f"overlaps enclosing {stack[-1][1]!r} "
                    f"(ends {stack[-1][0]})")
            stack.append((end, name))

    return {"events": len(events), "spans": n_spans, "cats": sorted(cats),
            "tids": sorted(spans_by_tid)}


def load_and_validate(path: str) -> dict:
    """Read a trace file and validate it; returns the summary stats."""
    with open(path) as f:
        return validate_chrome_trace(json.load(f))


def span_counts(obj: dict, by: str = "cat") -> dict[str, int]:
    """Count ``ph == "X"`` spans per category (or per name): the helper
    the per-wave-span-count regression and the CI schema check share."""
    out: dict[str, int] = {}
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "X":
            key = ev.get(by, "default") if by != "name" else ev["name"]
            out[key] = out.get(key, 0) + 1
    return out
