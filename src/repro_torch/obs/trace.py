"""Span tracer: where a run's time actually goes, on the host's clock and
the device's.

The port's copy of the reference's ``repro/obs/trace.py``: the same
classes, the same category vocabulary, the same host clock; the port adds
a device clock, span parents, step spans with counter deltas, and
profiler annotations.

The streaming stack's cost story is the paper's cost story — eq. 5-8 price
*bytes*, and the overlap argument (§4.4: "hide load time behind compute")
is a claim about *time*.  ``MemoryMeter`` already audits the bytes; this
module audits the time: every hot phase (prefetch wait, wave solve, staged
reduction, checkpoint commit; in-core ALS's halves, bins and kernels; an
SGD epoch's sets) runs inside a span, and the spans export to
Chrome-trace JSON (``obs.export``) so a run opens directly in Perfetto.

Clocks.  Every span reads the host clock (``ts``/``dur``).  CUDA work is
asynchronous, so on the host a span that ends on a kernel launch times
the enqueue.  A tracer made with ``Tracer(device_clock=True)`` also
records a ``torch.cuda.Event`` on the current stream at each span's enter
and exit, so a span needs no synchronise to time the device: the events
resolve to ``SpanEvent.device_ms`` in :meth:`Tracer.resolve`, which the
caller runs after its own synchronise (``spans()`` and the exporter run
it too, and wait for the events they resolve).  A span with no event
pair — on the CPU, before CUDA is initialised, a step span
(:meth:`Tracer.step_span`, which ends at its step's host read of the
result) and a :class:`phase` — takes its host duration as ``device_ms``.
``SpanEvent.clock`` says which it is, ``"device"`` or ``"host"``, and
the exporter writes both.  torch is imported by the tracer, never by
importing this module.

A span over several cards (:meth:`Tracer.span_on`, the mesh drivers')
records its event pair on the current stream of each card it names, and
its ``device_ms`` runs from the earliest start to the latest end among
them.  Events of different cards share no clock, so each card's are put
on the host's clock through that card's latest anchor
(:meth:`Tracer.anchor`: an event recorded where the card's stream is
idle, beside the host time); a span begun on a card with no anchor yet
takes the longest of its cards' own durations instead.

Structure.  Each event has an ``id`` and a ``parent``: the span or
:class:`phase` open on the same thread when it began (None at the top),
so a reader rebuilds
the tree and puts each span down to the step that caused it.  A step
span (:meth:`Tracer.step_span`: ``als.iteration``, ``sgd.epoch``) also
records, as its ``counters`` arg, the deltas of the process registry's
counters over its own interval (``obs.metrics``: kernel launches, host
syncs).  A recording tracer's span begun while ``torch.profiler``
records also enters ``torch.profiler.record_function(name)``, so it is a
``user_annotation`` range on the host and a ``gpu_user_annotation`` range
on the device, in the same timeline as the kernels: every idle gap of the
device trace falls under the innermost program span open at its middle,
or under none (the caller's code between steps).

Two instruments, two costs:

- :class:`Tracer` — retains one event per span for export.  The default
  tracer is :data:`NULL_TRACER`, whose ``span()`` and ``step_span()``
  return one shared no-op context manager: no allocation, no clock read,
  no event, no lock.  Tracing is strictly opt-in (``set_tracer`` in
  library use, or a ``tracer=`` argument), so the fast test lane pays
  nothing.  With tracing off a span's args cost what building its
  keyword arguments costs: shapes and names are attribute reads, and an
  arg that needs counting (a bin's or a set's ratings, a bin's K) is
  computed only when ``tracer.enabled``.
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
``iteration``       one ALS iteration (``als.iteration``: both halves
                    and the evaluation, not the caller's callback) /
                    ``epoch`` one SGD epoch (``sgd.epoch``: the sets and
                    the evaluation)
``half``            one ALS half (solve-X / accumulate-Theta;
                    ``als.half``, arg ``side``)
``bin``             one degree bin's q-batch of an in-core ALS half
                    (``als.bin``: ``bin``, ``batch``, ``rows``, ``K``,
                    ``nnz``, ``fixed_rows``, ``f``; on a mesh
                    ``su_als.bin``: ``K`` and ``nnz`` one per cell)
``scatter``         a bin's solved rows written back (``als.scatter``)
``mesh``            a step of SU-ALS over the cells of a mesh, under
                    ``su_als.bin``: ``su_als.herm`` (the partial
                    Hermitians), ``su_als.reduce`` (``phase`` ``fast``,
                    ``slow`` or ``flat``, ``bytes`` the cells receive),
                    ``su_als.solve``, ``su_als.gather``; and
                    ``su_als.reshard`` (``bytes``) at the end of a half
``set``             one diagonal set of an SGD epoch (``sgd.set``: ``set``,
                    ``live``, ``slots``, ``x_rows``, ``theta_rows``, ``g``,
                    ``mb``, ``f``)
``kernel``          one call of a kernel op (``kernel.fused_herm``,
                    ``kernel.batch_solve``, ``kernel.sgd_tile``; args are
                    shapes)
``objective``       a driver's in-loop evaluation (``als.evaluate``,
                    ``sgd.evaluate``) and each RMSE under it
``layout``          host layout builds (``layout.bin_rows``,
                    ``layout.bin``, ``layout.pad_csr``,
                    ``layout.block_coo``)
``build``           a kernel library's first load, ``nvcc`` included
                    (``kernel.load``: ``library``, ``compiled``)
``solve``           one wave's compute+writeback — exactly one span per
                    wave consumed, so ``count(cat="solve") == waves_run``
``prefetch``        consumer-side queue wait (pipeline stall time)
``prefetch_load``   worker-side host->device load (overlapped time)
``reduce``          topology-aware reduction + post-reduce shard solves
``checkpoint``      one per-wave checkpoint commit (snapshot + enqueue)
``serve``           serving-engine prefill / decode steps
==================  =====================================================

No span arg reads a device tensor: the drivers count per-bin and per-set
ratings on the host from the layouts, once per run and only while a
tracer records.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Optional

from repro_torch.obs.metrics import process_registry


class SpanEvent:
    """One recorded event.  ``ph`` follows the Chrome trace vocabulary:
    ``X`` complete span, ``i`` instant, ``C`` counter sample.  ``ts``/
    ``dur`` are microseconds relative to the tracer's epoch.  ``id`` is
    unique in its tracer, ``parent`` the id of the span open on the same
    thread when this one began (None at the top).  On a device-clock
    tracer's span ``device_ms`` is its duration on the clock that
    ``clock`` names: ``"device"`` for a CUDA-event pair (None until
    :meth:`Tracer.resolve`), ``"host"`` where the span recorded no event
    pair.  Both are None on a host-clock tracer.  A span over several
    anchored cards (:meth:`Tracer.span_on`) also has ``device_t0``: its
    earliest start on the host's clock, in ms of ``time.perf_counter``,
    so that a reader can take the union of spans that overlap."""

    __slots__ = ("name", "cat", "ph", "ts", "dur", "tid", "args", "id", "parent",
                 "device_ms", "clock", "device_t0")

    def __init__(self, name, cat, ph, ts, dur, tid, args, id=0, parent=None,
                 device_ms=None, clock=None, device_t0=None):
        self.name = name
        self.cat = cat
        self.ph = ph
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.args = args
        self.id = id
        self.parent = parent
        self.device_ms = device_ms
        self.clock = clock
        self.device_t0 = device_t0

    def __repr__(self):
        return (f"SpanEvent({self.name!r}, cat={self.cat!r}, ph={self.ph!r},"
                f" ts={self.ts:.1f}, dur={self.dur:.1f}, tid={self.tid},"
                f" id={self.id}, parent={self.parent})")


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

    ``span()`` and ``step_span()`` return the one shared
    :data:`NOOP_SPAN` — no event list, no clock read, no CUDA event — so
    instrumentation left in hot paths costs a method call and nothing
    else when tracing is off.
    """

    enabled = False

    def span(self, name: str, cat: str = "", **args):
        return NOOP_SPAN

    def span_on(self, devices, name: str, cat: str = "", **args):
        return NOOP_SPAN

    def anchor(self, devices) -> None:
        return None

    def step_span(self, name: str, cat: str = "", **args):
        return NOOP_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        return None

    def counter(self, name: str, value, cat: str = "") -> None:
        return None

    def resolve(self) -> None:
        return None

    def spans(self, cat: Optional[str] = None) -> list:
        return []


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_step", "_t0", "_id",
                 "_parent", "_ev0", "_annot", "_c0", "_cards")

    def __init__(self, tracer, name, cat, args, step=False, cards=None):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._step = step
        self._cards = cards

    def __enter__(self):
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(tr._ids)
        stack.append(self._id)
        self._c0 = process_registry().snapshot()["counters"] if self._step else None
        self._annot = tr._annotate(self._name)
        self._ev0 = None if self._step else tr._device_mark(self._cards)
        self._t0 = time.perf_counter()  # reprolint: disable=obs-routing
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()  # reprolint: disable=obs-routing
        tr = self._tracer
        ev1 = tr._device_mark(self._cards) if self._ev0 is not None else None
        if self._annot is not None:
            self._annot.__exit__(None, None, None)
        args = self._args
        if self._c0 is not None:
            c0 = self._c0
            args["counters"] = {k: v - c0.get(k, 0.0)
                                for k, v in process_registry().snapshot()["counters"].items()
                                if v != c0.get(k, 0.0)}
        tr._stack().pop()
        tr._finish(self._name, self._cat, self._t0, t1, args, self._id, self._parent,
                   self._ev0, ev1)
        return False


class Tracer:
    """Recording tracer: spans, instants, counter samples, per thread.

    Thread-safe by a single lock around the event list — spans are
    recorded at *exit* (one append per span), so the lock is never held
    across user code.  Timestamps are ``time.perf_counter()`` relative to
    the tracer's construction (``epoch``), exported as microseconds.
    ``device_clock=True`` adds each span's CUDA-event pair, resolved to
    ``device_ms`` by :meth:`resolve` (module docstring).
    """

    enabled = True

    def __init__(self, device_clock: bool = False):
        self.epoch = time.perf_counter()  # reprolint: disable=obs-routing
        self.events: list[SpanEvent] = []
        self.thread_names: dict[int, str] = {}
        self.device_clock = device_clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pending: list[tuple] = []
        self._anchors: dict = {}
        # a host-clock tracer uses torch (for profiler annotations) only
        # where the process has imported it already
        if device_clock:
            import torch
        else:
            torch = sys.modules.get("torch")
        self._torch = torch
        self._cuda = device_clock and torch.cuda.is_available()

    def _stack(self) -> list:
        """Ids of the spans open on the calling thread, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _annotate(self, name: str):
        """``record_function(name)`` entered while ``torch.profiler``
        records, else None."""
        if self._torch is None or not self._torch.autograd._profiler_enabled():
            return None
        annot = self._torch.profiler.record_function(name)
        annot.__enter__()
        return annot

    def _device_mark(self, cards=None):
        """A timing event recorded on the current stream, or None where no
        CUDA work can run yet.  With ``cards`` (CUDA devices): a tuple of
        (card, event on the card's current stream, the card's anchor)."""
        if not self._cuda or not self._torch.cuda.is_initialized():
            return None
        cuda = self._torch.cuda
        if cards is not None:
            marks = []
            for card in cards:
                ev = cuda.Event(enable_timing=True)
                ev.record(cuda.current_stream(card))
                marks.append((card, ev, self._anchors.get(card)))
            return tuple(marks) or None
        ev = cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # -- recording ----------------------------------------------------
    def span(self, name: str, cat: str = "", **args):
        """Context manager timing one span; ``args`` become span tags."""
        return _Span(self, name, cat, args)

    def span_on(self, devices, name: str, cat: str = "", **args):
        """:meth:`span` over the CUDA cards among ``devices`` (module
        docstring): its device time runs from the earliest of its cards'
        start events to the latest of their end events.  With no card
        among them (None, or CPU devices) it is :meth:`span`."""
        cards = [d for d in (devices or ()) if getattr(d, "type", None) == "cuda"]
        if not cards:
            return _Span(self, name, cat, args)
        return _Span(self, name, cat, args, cards=cards)

    def anchor(self, devices) -> None:
        """Puts the CUDA cards among ``devices`` on the host's clock for the
        spans that begin after it: on each card, waits for its current
        stream, records an event there and notes the host time.  Call it
        where those streams have little or nothing left to run (after a
        host read that waited for them); it waits for the rest."""
        if not self._cuda or not self._torch.cuda.is_initialized():
            return
        cuda = self._torch.cuda
        for card in devices or ():
            if getattr(card, "type", None) != "cuda":
                continue
            stream = cuda.current_stream(card)
            stream.synchronize()
            ev = cuda.Event(enable_timing=True)
            ev.record(stream)
            self._anchors[card] = (ev, time.perf_counter())  # reprolint: disable=obs-routing

    def step_span(self, name: str, cat: str = "", **args):
        """:meth:`span` of one driver step: its ``counters`` arg holds the
        process registry's counter deltas over the span, each counter that
        moved (``obs.metrics``).  A step ends at its host read of the
        step's result, so the step span keeps the host clock (its
        ``device_ms`` is its host duration, ``clock`` ``"host"``): on an H100 a pair of CUDA
        timing events around each SGD epoch stopped a copy the caller
        queued on another stream between epochs from overlapping the next
        epoch's kernels, 4 % of the epoch."""
        return _Span(self, name, cat, args, step=True)

    def _finish(self, name, cat, t0, t1, args, span_id, parent, ev0=None, ev1=None,
                ph="X") -> None:
        tid = threading.get_ident()
        ev = SpanEvent(name, cat, ph, (t0 - self.epoch) * 1e6,
                       (t1 - t0) * 1e6, tid, dict(args or ()), span_id, parent)
        if ev1 is not None:
            ev.clock = "device"
        elif self.device_clock and ph == "X":
            ev.device_ms, ev.clock = (t1 - t0) * 1e3, "host"
        with self._lock:
            self.events.append(ev)
            if ev1 is not None:
                self._pending.append((ev, ev0, ev1))
            if tid not in self.thread_names:
                self.thread_names[tid] = threading.current_thread().name

    def record(self, name: str, cat: str, t0: float, t1: float,
               args: Optional[dict] = None, ph: str = "X") -> None:
        """Record a pre-timed event (instants, counter samples), a child
        of the span open on the calling thread."""
        stack = self._stack()
        self._finish(name, cat, t0, t1, args, next(self._ids),
                     stack[-1] if stack else None, ph=ph)

    def instant(self, name: str, cat: str = "", **args) -> None:
        t = time.perf_counter()  # reprolint: disable=obs-routing
        self.record(name, cat, t, t, args, ph="i")

    def counter(self, name: str, value, cat: str = "") -> None:
        """One sample of a time-varying quantity (queue depth, occupancy);
        exports as a Chrome counter track."""
        t = time.perf_counter()  # reprolint: disable=obs-routing
        self.record(name, cat, t, t, {"value": value}, ph="C")

    def resolve(self) -> None:
        """Sets ``device_ms`` of every span whose CUDA events are still
        pending, waiting for each span's end event (a no-op for events the
        caller's synchronise already completed)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for ev, ev0, ev1 in pending:
            if isinstance(ev0, tuple):
                ev.device_t0, ev.device_ms = _cards_span(ev0, ev1)
                continue
            ev1.synchronize()
            ev.device_ms = ev0.elapsed_time(ev1)

    # -- queries ------------------------------------------------------
    def spans(self, cat: Optional[str] = None) -> list[SpanEvent]:
        """Completed spans (``ph == "X"``), optionally one category, with
        their device times resolved."""
        self.resolve()
        with self._lock:
            return [e for e in self.events
                    if e.ph == "X" and (cat is None or e.cat == cat)]


def _cards_span(starts, ends) -> tuple:
    """``(device_t0, device_ms)`` of a span over several cards: its
    earliest start and, to its latest end, its milliseconds on the host's
    clock, through each card's anchor at the span's start; where a card
    had none, ``(None, the longest of the cards' own durations)``."""
    for _, e, _ in ends:
        e.synchronize()
    if all(anchor is not None for _, _, anchor in starts):
        t0 = min(a[1] * 1e3 + a[0].elapsed_time(s) for _, s, a in starts)
        t1 = max(a[1] * 1e3 + a[0].elapsed_time(e) for (_, _, a), (_, e, _) in zip(starts, ends))
        return t0, t1 - t0
    return None, max(s.elapsed_time(e) for (_, s, _), (_, e, _) in zip(starts, ends))


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


class phase:
    """Span + always-on metrics in one context manager.

    The drivers' instrumentation point: one ``perf_counter`` pair per
    phase, fed to (a) ``registry`` — counter ``phase_seconds/<cat>`` and
    histogram ``<cat>_seconds`` — and (b) ``tracer`` as a span when one is
    recording.  Either sink may be None.  This is the only sanctioned way
    to time code under ``src/repro/`` outside ``obs/`` (reprolint rule
    ``obs-routing`` enforces it).  While a tracer records, a phase is on
    its thread's stack like a span, so the spans opened inside it are its
    children; it keeps the host clock.
    """

    __slots__ = ("_tracer", "_registry", "_name", "_cat", "_args", "_t0", "_id",
                 "_parent")

    def __init__(self, name: str, *, cat: str, tracer=None, registry=None,
                 **args):
        self._tracer = tracer
        self._registry = registry
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        tr = self._tracer
        if tr is not None and tr.enabled:
            stack = tr._stack()
            self._parent = stack[-1] if stack else None
            self._id = next(tr._ids)
            stack.append(self._id)
        self._t0 = time.perf_counter()  # reprolint: disable=obs-routing
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()  # reprolint: disable=obs-routing
        reg = self._registry
        if reg is not None:
            reg.add_phase(self._cat, t1 - self._t0)
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr._stack().pop()
            tr._finish(self._name, self._cat, self._t0, t1, self._args, self._id,
                       self._parent)
        return False


def process_id() -> int:
    """The pid the exporter stamps on events (one process per trace)."""
    return os.getpid()
