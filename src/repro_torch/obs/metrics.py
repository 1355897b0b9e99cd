"""Metrics registry: counters, gauges, fixed-bucket histograms.

The numeric side of the observability layer.  Where ``obs.trace`` answers
"what ran when", the registry answers "how much, how often, how long" —
waves run, bytes streamed, per-wave solve latency, prefetch queue depth —
and it is *always on* in the drivers: one dict lookup and one add per
event, cheap enough that ``StreamTelemetry`` is now just a view over it
(``StreamTelemetry.from_registry``).

Thread-safety: the registry is written from the prefetch worker and the
consumer concurrently, so creation is guarded by a registry lock and each
instrument guards its own mutation.  Instruments are create-on-first-use
(``registry.counter("waves_run")``), prometheus-style.

Naming convention: ``<subsystem>/<what>`` for plain instruments
(``prefetch/items``), ``phase_seconds/<category>`` for the per-phase time
accounting the :class:`~repro_torch.obs.trace.phase` helper feeds, and
``<category>_seconds`` for the matching latency histograms.

Beside the per-run registries there is one process-wide registry
(:func:`process_registry`, next to ``trace.current_tracer``) for what
the program counts wherever it runs:

- ``kernel/<name>/launches``: the calls of a CUDA kernel's wrapper that
  launched it, and ``kernel/<name>/cuda_launches``: the CUDA launches
  those calls made (``fused_herm``, ``herm_hbm_accum``, ``batch_solve``,
  ``sgd_tile``); :func:`kernel_launches` reads them by kernel;
- ``host/syncs``: the places in the drivers' hot loops where the host
  reads a device value (an RMSE's ``float()``, ``_rmse_bins``'s per-bin
  reads) or waits for the stream.

The counters only grow: a reader takes a delta between two reads, as a
step span (``Tracer.step_span``) does over its own interval.
"""
from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

#: default latency buckets (seconds): 1 ms .. 100 s, ~3x steps — wide
#: enough for a CI smoke wave and a real-scale streaming wave alike
DEFAULT_LATENCY_BUCKETS = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3,
                           1.0, 3.0, 10.0, 30.0, 100.0)


class Counter:
    """Monotonically increasing value (float so second-counters fit)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-set value, with the running max kept for peak-style reads."""

    __slots__ = ("_lock", "value", "max")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0
        self.max = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
            if v > self.max:
                self.max = v


class Histogram:
    """Fixed-bucket histogram with less-or-equal bucket semantics.

    ``edges`` are the inclusive upper bounds: an observation ``v`` lands
    in the first bucket with ``v <= edges[i]``; anything above the last
    edge lands in the overflow bucket (``counts[-1]``), so ``counts`` has
    ``len(edges) + 1`` entries and every observation is counted exactly
    once.  ``sum``/``count`` give the mean without bucket math.
    """

    __slots__ = ("_lock", "edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float]):
        assert edges, "histogram needs at least one bucket edge"
        se = tuple(float(e) for e in edges)
        assert se == tuple(sorted(se)) and len(set(se)) == len(se), \
            f"bucket edges must be strictly increasing, got {edges}"
        self._lock = threading.Lock()
        self.edges = se
        self.counts = [0] * (len(se) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Create-on-first-use instrument registry (one per streaming run)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    edges if edges is not None else DEFAULT_LATENCY_BUCKETS)
            elif edges is not None:
                assert h.edges == tuple(float(e) for e in edges), \
                    (f"histogram {name!r} already registered with edges "
                     f"{h.edges}, asked for {tuple(edges)}")
            return h

    # -- the phase-accounting hook obs.trace.phase drives ---------------
    def add_phase(self, category: str, seconds: float) -> None:
        """One completed phase: total seconds per category + a latency
        sample (``phase_seconds/<cat>`` counter, ``<cat>_seconds``
        histogram)."""
        self.counter(f"phase_seconds/{category}").inc(seconds)
        self.histogram(f"{category}_seconds").observe(seconds)

    def phase_seconds(self) -> dict[str, float]:
        """``{category: total seconds}`` across every phase seen so far."""
        with self._lock:
            items = list(self._counters.items())
        pre = "phase_seconds/"
        return {name[len(pre):]: c.value for name, c in items
                if name.startswith(pre)}

    def snapshot(self) -> dict:
        """Plain-data dump (JSON-ready) of every instrument — what the
        exporter embeds next to the trace events."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: {"value": g.value, "max": g.max}
                      for k, g in self._gauges.items()}
            hists = {k: {"edges": list(h.edges), "counts": list(h.counts),
                         "sum": h.sum, "count": h.count}
                     for k, h in self._histograms.items()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}


_PROCESS = MetricsRegistry()


def process_registry() -> MetricsRegistry:
    """The process-wide registry of the program's kernel launches and host
    syncs (module docstring)."""
    return _PROCESS


def kernel_counters(name: str) -> tuple[Counter, Counter]:
    """The ``launches`` and ``cuda_launches`` counters of kernel ``name``
    in the process registry, for its wrapper to increment."""
    return (_PROCESS.counter(f"kernel/{name}/launches"),
            _PROCESS.counter(f"kernel/{name}/cuda_launches"))


def kernel_launches(kind: str = "launches") -> dict[str, int]:
    """``{kernel: count}`` of the process registry's ``kernel/<name>/<kind>``
    counters (``kind`` is ``"launches"`` or ``"cuda_launches"``); a
    kernel whose module was never imported is absent."""
    if kind not in ("launches", "cuda_launches"):
        raise ValueError(f"unknown launch count {kind!r}")
    out = {}
    for key, value in _PROCESS.snapshot()["counters"].items():
        parts = key.split("/")
        if len(parts) == 3 and parts[0] == "kernel" and parts[2] == kind:
            out[parts[1]] = int(value)
    return out
