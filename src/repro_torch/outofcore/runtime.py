"""Solver-agnostic streaming runtime: the plumbing every wave driver shares
(the port's copy of the reference's ``repro/outofcore/runtime.py``).

The out-of-core subsystem runs more than one solver (ALS half-iterations,
SGD diagonal-set epochs); what they have in common is not the math but the
execution substrate: a metered simulated-device footprint, telemetry of what
actually streamed, per-wave checkpoint commits, and the simulated-kill hook
the resume tests drive.  That substrate lives here so a new solver's driver
only writes its wave loop.

The drivers do all their counting and timing through an
``obs.MetricsRegistry``; :class:`StreamTelemetry` is *computed* from the
registry at the end of a run (:meth:`StreamTelemetry.from_registry`).  The registry counter /
gauge names that view reads are the contract::

    counters: waves_run, batches_loaded, bytes_streamed,
              padded_slots, nnz_streamed,
              reduce_fast_bytes, reduce_slow_bytes,
              phase_seconds/<category>   (fed by obs.trace.phase)
    gauges:   peak_bytes, resumed_from_step

``wall_seconds`` is the total of the ``driver`` phase category — the span
that wraps one whole streaming run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Mapping, Optional

from repro_torch.obs.ledger import merge_ledgers
from repro_torch.obs.trace import phase


class MemoryMeter:
    """Named live-allocation tracker (thread-safe: the prefetch worker
    registers wave buffers while the consumer frees earlier ones)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def alloc(self, name: str, nbytes: int) -> None:
        with self._lock:
            assert name not in self._live, name
            self._live[name] = int(nbytes)
            self.live_bytes += int(nbytes)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def free(self, name: str) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(name)


@dataclasses.dataclass
class StreamTelemetry:
    """What the run actually did — peak footprint, traffic, resume point.

    A read-only *view* built from the run's ``obs.MetricsRegistry`` (see
    the module doc for the name contract); the classic fields are unchanged
    so existing callers (benches, examples, tests) keep working, and two
    breakdown fields ride along:

    - ``phase_seconds``: total seconds per phase category (``prefetch``,
      ``solve``, ``reduce``, ``checkpoint``, ...) — where the wall-clock
      went.  For a merged hybrid telemetry the keys are prefixed with the
      phase name (``als/solve``, ``sgd/solve``).
    - ``phases``: for merged telemetries only, the per-phase
      ``StreamTelemetry`` objects keyed by phase name (``als``/``sgd``).

    The pad/fill accounting: ``padded_slots`` counts every ELL
    slot streamed in a rating payload (padding included), ``nnz_streamed``
    the true ratings under those slots, and ``fill_waste_ratio`` their
    quotient — the measured twin of ``RatingStore.worst_fill``'s planning
    bound.  ``ledger`` is the run's serialized plan-vs-actual ledger
    (``repro_torch.obs.ledger``, the reference's schema).
    """

    capacity_bytes: int = 0
    peak_bytes: int = 0
    waves_run: int = 0
    batches_loaded: int = 0
    bytes_streamed: int = 0      # host->device rating + factor-slice traffic
    padded_slots: int = 0        # ELL slots streamed (padding included)
    nnz_streamed: int = 0        # true ratings under those slots
    fill_waste_ratio: float = 0.0  # padded_slots / nnz_streamed
    resumed_from_step: int = 0
    wall_seconds: float = 0.0
    # mesh streaming only: per-link traffic of the topology-aware reduction
    # that combines the per-data-shard Hermitian partials (distributed.reduce)
    reduce_fast_bytes: int = 0   # intra-fast-domain ring traffic
    reduce_slow_bytes: int = 0   # inter-domain tree traffic
    topology: str = ""           # DeviceTopology.describe() of the reduce
    # per-phase breakdowns (obs.trace.phase)
    phase_seconds: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)
    # plan-vs-actual ledger: serialized repro_torch.obs.ledger object
    ledger: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_registry(cls, registry, *, capacity_bytes: int = 0,
                      topology: str = "",
                      ledger: Optional[dict] = None) -> "StreamTelemetry":
        """The post-run view over a driver's metrics registry."""
        def cnt(name):
            return registry.counter(name).value

        phases = registry.phase_seconds()
        slots = int(cnt("padded_slots"))
        nnz = int(cnt("nnz_streamed"))
        return cls(
            capacity_bytes=int(capacity_bytes),
            peak_bytes=int(registry.gauge("peak_bytes").value),
            waves_run=int(cnt("waves_run")),
            batches_loaded=int(cnt("batches_loaded")),
            bytes_streamed=int(cnt("bytes_streamed")),
            padded_slots=slots,
            nnz_streamed=nnz,
            fill_waste_ratio=slots / nnz if nnz else 0.0,
            resumed_from_step=int(registry.gauge("resumed_from_step").value),
            wall_seconds=phases.get("driver", 0.0),
            reduce_fast_bytes=int(cnt("reduce_fast_bytes")),
            reduce_slow_bytes=int(cnt("reduce_slow_bytes")),
            topology=topology,
            phase_seconds=phases,
            ledger=dict(ledger) if ledger else {},
        )


def merge_telemetry(
        parts: Mapping[str, Optional[StreamTelemetry]]) -> StreamTelemetry:
    """One telemetry over a multi-phase run (the hybrid drivers).

    ``parts`` maps phase name -> that phase's telemetry (None for a phase
    that did not run, e.g. the ALS warm start skipped on resume).  Traffic
    and time sum; capacity/peak take the max (each phase ran under its own
    budget, and per-phase ``peak <= capacity`` implies the same for the
    maxima); ``phase_seconds`` keys are prefixed with the phase name and
    the full per-phase telemetries stay reachable under ``.phases``.
    """
    live = {k: t for k, t in parts.items() if t is not None}
    assert live, "merge_telemetry needs at least one non-None phase"
    tels = list(live.values())
    slots = sum(t.padded_slots for t in tels)
    nnz = sum(t.nnz_streamed for t in tels)
    ledgers = {name: t.ledger for name, t in live.items() if t.ledger}
    return StreamTelemetry(
        capacity_bytes=max(t.capacity_bytes for t in tels),
        peak_bytes=max(t.peak_bytes for t in tels),
        waves_run=sum(t.waves_run for t in tels),
        batches_loaded=sum(t.batches_loaded for t in tels),
        bytes_streamed=sum(t.bytes_streamed for t in tels),
        padded_slots=slots,
        nnz_streamed=nnz,
        fill_waste_ratio=slots / nnz if nnz else 0.0,
        resumed_from_step=max(t.resumed_from_step for t in tels),
        wall_seconds=sum(t.wall_seconds for t in tels),
        reduce_fast_bytes=sum(t.reduce_fast_bytes for t in tels),
        reduce_slow_bytes=sum(t.reduce_slow_bytes for t in tels),
        topology=next((t.topology for t in tels if t.topology), ""),
        phase_seconds={f"{name}/{cat}": secs
                       for name, t in live.items()
                       for cat, secs in t.phase_seconds.items()},
        phases=dict(live),
        ledger=merge_ledgers(ledgers) if ledgers else {},
    )


class SimulatedFailure(RuntimeError):
    """Raised by ``fail_after_waves`` — stands in for a killed machine."""


class WaveCheckpointer:
    """Per-wave commit + simulated-kill counter, shared by the drivers.

    ``save`` takes the checkpoint tree as a thunk so the host-side snapshot
    copies are only made when a manager is actually attached; the kill fires
    *after* the wave's commit is durable (``mgr.wait()``), which is what lets
    the resume tests demand bit-exact continuation.  Each commit runs in a
    ``checkpoint`` phase span covering the snapshot + async enqueue — the
    host-blocking part of the §4.4 protocol (the background write itself is
    deliberately off the clock; it overlaps the next wave).
    """

    def __init__(self, mgr, fail_after_waves: Optional[int] = None,
                 tracer=None, registry=None):
        self.mgr = mgr
        self.fail_after_waves = fail_after_waves
        self.saves = 0
        self._tracer = tracer
        self._registry = registry

    def save(self, step: int, tree_fn: Callable[[], dict]) -> None:
        if self.mgr is not None:
            with phase("checkpoint.commit", cat="checkpoint",
                       tracer=self._tracer, registry=self._registry,
                       step=step):
                self.mgr.save(step, tree_fn())
            if self._registry is not None:
                self._registry.counter("checkpoints_committed").inc()
        self.saves += 1
        if (self.fail_after_waves is not None
                and self.saves >= self.fail_after_waves):
            if self.mgr is not None:
                self.mgr.wait()             # make sure the wave committed
            raise SimulatedFailure(
                f"simulated kill after {self.saves} wave(s)")
