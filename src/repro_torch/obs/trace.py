"""Span tracer: where a wave's wall-clock actually goes.

The port's copy of the reference's ``repro/obs/trace.py``: the same
classes, the same category vocabulary, the same host clock.

The streaming stack's cost story is the paper's cost story — eq. 5-8 price
*bytes*, and the overlap argument (§4.4: "hide load time behind compute")
is a claim about *time*.  ``MemoryMeter`` already audits the bytes; this
module audits the time: every hot phase (prefetch wait, wave solve, staged
reduction, checkpoint commit) runs inside a span, and the spans export to
Chrome-trace JSON (``obs.export``) so a run opens directly in Perfetto.

Spans read the host clock.  CUDA work is asynchronous, so a span that
ends on a kernel launch times the enqueue, not the kernel: a span
measures device work only where it ends at a synchronising call (the
streaming driver's ``.cpu()`` write-back of each wave's solved rows, the
SGD driver's synchronise at the end of an epoch).  Kernel times come
from CUDA events, outside this module.

Two instruments, two costs:

- :class:`Tracer` — retains one event per span for export.  The default
  tracer is :data:`NULL_TRACER`, whose ``span()`` returns one shared no-op
  context manager: no allocation, no clock read, no lock.  Tracing is
  strictly opt-in (``set_tracer`` in library use, or a ``tracer=``
  argument), so the fast test lane pays nothing.
- :class:`phase` — the always-on accounting the drivers use.  One clock
  pair per phase; the elapsed time lands in a ``MetricsRegistry`` (counter
  ``phase_seconds/<cat>`` + latency histogram ``<cat>_seconds``) and, when
  a real tracer is active, also becomes a span.  This is what makes
  ``StreamTelemetry.wall_seconds`` and the per-phase breakdowns available
  with tracing off — metrics are cheap per wave, spans are opt-in.

Spans are thread-aware: each records the OS thread it ran on, so the
prefetch worker's load spans interleave correctly with the consumer's
solve spans in the exported timeline (two tracks, overlapping — the
overlap IS the paper's preload win, made visible).

Category vocabulary (the span/metric catalog in OBSERVABILITY.md):

==================  =====================================================
category            what runs under it
==================  =====================================================
``driver``          one whole streaming run (its total is wall_seconds)
``iteration``       one ALS iteration / ``epoch`` one SGD epoch
``half``            one ALS half (solve-X / accumulate-Theta)
``solve``           one wave's compute+writeback — exactly one span per
                    wave consumed, so ``count(cat="solve") == waves_run``
``prefetch``        consumer-side queue wait (pipeline stall time)
``prefetch_load``   worker-side host->device load (overlapped time)
``reduce``          topology-aware reduction + post-reduce shard solves
``checkpoint``      one per-wave checkpoint commit (snapshot + enqueue)
``serve``           serving-engine prefill / decode steps
==================  =====================================================
"""
from __future__ import annotations

import functools
import os
import threading
import time
from typing import Optional


class SpanEvent:
    """One recorded event.  ``ph`` follows the Chrome trace vocabulary:
    ``X`` complete span, ``i`` instant, ``C`` counter sample.  ``ts``/
    ``dur`` are microseconds relative to the tracer's epoch."""

    __slots__ = ("name", "cat", "ph", "ts", "dur", "tid", "args")

    def __init__(self, name, cat, ph, ts, dur, tid, args):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.args = args

    def __repr__(self):
        return (f"SpanEvent({self.name!r}, cat={self.cat!r}, ph={self.ph!r},"
                f" ts={self.ts:.1f}, dur={self.dur:.1f}, tid={self.tid})")


class _NoopSpan:
    """The shared do-nothing context manager a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class NullTracer:
    """Disabled tracer: every call is a constant-time no-op.

    ``span()`` returns the one shared :data:`NOOP_SPAN` — no event list,
    no clock read — so instrumentation left in hot paths costs a method
    call and nothing else when tracing is off.
    """

    enabled = False

    def span(self, name: str, cat: str = "", **args):
        return NOOP_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        return None

    def counter(self, name: str, value, cat: str = "") -> None:
        return None

    def spans(self, cat: Optional[str] = None) -> list:
        return []


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()  # reprolint: disable=obs-routing
        return self

    def __exit__(self, *exc):
        self._tracer.record(self._name, self._cat, self._t0,
                            time.perf_counter(), self._args)  # reprolint: disable=obs-routing
        return False


class Tracer:
    """Recording tracer: spans, instants, counter samples, per thread.

    Thread-safe by a single lock around the event list — spans are
    recorded at *exit* (one append per span), so the lock is never held
    across user code.  Timestamps are ``time.perf_counter()`` relative to
    the tracer's construction (``epoch``), exported as microseconds.
    """

    enabled = True

    def __init__(self):
        self.epoch = time.perf_counter()  # reprolint: disable=obs-routing
        self.events: list[SpanEvent] = []
        self.thread_names: dict[int, str] = {}
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one span; ``args`` become span tags."""
        return _Span(self, name, cat, args)

    def record(self, name: str, cat: str, t0: float, t1: float,
               args: Optional[dict] = None, ph: str = "X") -> None:
        """Record a pre-timed span (the ``phase`` helper's entry point)."""
        tid = threading.get_ident()
        ev = SpanEvent(name, cat, ph, (t0 - self.epoch) * 1e6,
                       (t1 - t0) * 1e6, tid, dict(args or ()))
        with self._lock:
            self.events.append(ev)
            if tid not in self.thread_names:
                self.thread_names[tid] = threading.current_thread().name

    def instant(self, name: str, cat: str = "", **args) -> None:
        t = time.perf_counter()  # reprolint: disable=obs-routing
        self.record(name, cat, t, t, args, ph="i")

    def counter(self, name: str, value, cat: str = "") -> None:
        """One sample of a time-varying quantity (queue depth, occupancy);
        exports as a Chrome counter track."""
        t = time.perf_counter()  # reprolint: disable=obs-routing
        self.record(name, cat, t, t, {"value": value}, ph="C")

    # -- queries ------------------------------------------------------
    def spans(self, cat: Optional[str] = None) -> list[SpanEvent]:
        """Completed spans (``ph == "X"``), optionally one category."""
        with self._lock:
            return [e for e in self.events
                    if e.ph == "X" and (cat is None or e.cat == cat)]


# ---------------------------------------------------------------------------
# Process-wide current tracer (what --trace installs)
# ---------------------------------------------------------------------------

_CURRENT: NullTracer | Tracer = NULL_TRACER


def set_tracer(tracer) -> NullTracer | Tracer:
    """Install the process-wide tracer; returns the previous one.
    Instrumented code that was not handed an explicit tracer picks this
    up via :func:`current_tracer`."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NULL_TRACER
    return prev


def current_tracer() -> NullTracer | Tracer:
    return _CURRENT


def traced(name: Optional[str] = None, cat: str = ""):
    """Decorator form: run the wrapped function inside a span on the
    *current* tracer (resolved per call, so enabling tracing later works)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with current_tracer().span(label, cat=cat):
                return fn(*a, **kw)
        return wrapper
    return deco


class phase:
    """Span + always-on metrics in one context manager.

    The drivers' instrumentation point: one ``perf_counter`` pair per
    phase, fed to (a) ``registry`` — counter ``phase_seconds/<cat>`` and
    histogram ``<cat>_seconds`` — and (b) ``tracer`` as a span when one is
    recording.  Either sink may be None.  This is the only sanctioned way
    to time code under ``src/repro/`` outside ``obs/`` (reprolint rule
    ``obs-routing`` enforces it).
    """

    __slots__ = ("_tracer", "_registry", "_name", "_cat", "_args", "_t0")

    def __init__(self, name: str, *, cat: str, tracer=None, registry=None,
                 **args):
        self._tracer = tracer
        self._registry = registry
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()  # reprolint: disable=obs-routing
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()  # reprolint: disable=obs-routing
        reg = self._registry
        if reg is not None:
            reg.add_phase(self._cat, t1 - self._t0)
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.record(self._name, self._cat, self._t0, t1, self._args)
        return False


def process_id() -> int:
    """The pid the exporter stamps on events (one process per trace)."""
    return os.getpid()
