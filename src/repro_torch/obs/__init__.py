"""repro_torch.obs — span tracing, metrics, Chrome-trace export and the
plan-vs-actual ledger: the port's copy of the reference's ``repro/obs``.

The layer the streaming driver reports through (the reference's
OBSERVABILITY.md catalogs its spans and metrics; the port keeps the names):

- ``obs.trace`` — thread-aware span tracer (no-op unless enabled), the
  ``phase`` helper that also feeds per-phase metrics, and the
  process-wide ``set_tracer``/``current_tracer`` hook.  Spans carry an
  ``id`` and a ``parent``; ``Tracer(device_clock=True)`` times each span
  on the device with CUDA events as well, resolved to ``device_ms`` by
  ``Tracer.resolve()`` after the caller's own synchronise, so a span no
  longer has to end at a synchronise to time device work (a span with no
  event pair — a driver's step span, which ends at its host read, a
  ``phase``, any span on the CPU — keeps the host clock, and its
  ``clock`` says so).  A ``phase`` is a parent like a span.  While
  ``torch.profiler`` records, each span is also one of its annotations.
  Categories: the table in ``obs/trace.py`` (``iteration``/``epoch``,
  ``half``, ``bin``, ``scatter``, ``set``, ``kernel``, ``objective``,
  ``layout``, ``build``, and the streaming stack's).
- ``obs.metrics`` — counters / gauges / fixed-bucket histograms;
  ``StreamTelemetry`` is a view over one of these registries.  The
  process-wide ``process_registry()`` holds the kernels' launch counts
  (``kernel_launches()``) and the drivers' host syncs; a step span
  records their deltas.
- ``obs.export`` — Chrome-trace / Perfetto JSON emission + the schema
  validator.
- ``obs.ledger`` — plan-vs-actual records (predicted vs measured bytes /
  peaks / fill waste) with recomputed verdicts, on the reference's schema
  ``repro.obs/ledger-v1`` so either package reads the other's ledgers;
  ``obs.report`` renders one, ``obs.regress`` exit-codes it (and a bench
  history).

Stdlib-only on purpose: nothing in the hot path pulls torch or numpy
through the instrumentation, and importing it touches no device (a
device-clock tracer imports torch when it is made).
"""
from repro_torch.obs.export import (chrome_trace, load_and_validate,
                                    span_counts, validate_chrome_trace,
                                    write_trace)
from repro_torch.obs.ledger import (LEDGER_SCHEMA, Ledger, merge_ledgers,
                                    validate_ledger)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry, kernel_launches,
                                     process_registry)
from repro_torch.obs.trace import (NOOP_SPAN, NULL_TRACER, NullTracer,
                                   SpanEvent, Tracer, current_tracer, phase,
                                   set_tracer)

__all__ = [
    "Counter", "DEFAULT_LATENCY_BUCKETS", "Gauge", "Histogram",
    "LEDGER_SCHEMA", "Ledger", "MetricsRegistry", "NOOP_SPAN",
    "NULL_TRACER", "NullTracer", "SpanEvent", "Tracer", "chrome_trace",
    "current_tracer", "kernel_launches", "load_and_validate",
    "merge_ledgers", "phase", "process_registry", "set_tracer", "span_counts",
    "validate_chrome_trace", "validate_ledger", "write_trace",
]
