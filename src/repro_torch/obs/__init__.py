"""repro_torch.obs — span tracing, metrics, Chrome-trace export and the
plan-vs-actual ledger: the port's copy of the reference's ``repro/obs``.

The layer the streaming driver reports through (the reference's
OBSERVABILITY.md catalogs its spans and metrics; the port keeps the names):

- ``obs.trace`` — thread-aware span tracer (no-op unless enabled), the
  ``phase`` helper that also feeds per-phase metrics, and the
  process-wide ``set_tracer``/``current_tracer`` hook.
- ``obs.metrics`` — counters / gauges / fixed-bucket histograms;
  ``StreamTelemetry`` is a view over one of these registries.
- ``obs.export`` — Chrome-trace / Perfetto JSON emission + the schema
  validator.
- ``obs.ledger`` — plan-vs-actual records (predicted vs measured bytes /
  peaks / fill waste) with recomputed verdicts, on the reference's schema
  ``repro.obs/ledger-v1`` so either package reads the other's ledgers;
  ``obs.report`` renders one, ``obs.regress`` exit-codes it (and a bench
  history).

Stdlib-only on purpose: nothing in the hot path pulls torch or numpy
through the instrumentation, and importing it touches no device.
"""
from repro_torch.obs.export import (chrome_trace, load_and_validate,
                                    span_counts, validate_chrome_trace,
                                    write_trace)
from repro_torch.obs.ledger import (LEDGER_SCHEMA, Ledger, merge_ledgers,
                                    validate_ledger)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NOOP_SPAN, NULL_TRACER, NullTracer,
                                   SpanEvent, Tracer, current_tracer, phase,
                                   set_tracer, traced)

__all__ = [
    "Counter", "DEFAULT_LATENCY_BUCKETS", "Gauge", "Histogram",
    "LEDGER_SCHEMA", "Ledger", "MetricsRegistry", "NOOP_SPAN",
    "NULL_TRACER", "NullTracer", "SpanEvent", "Tracer", "chrome_trace",
    "current_tracer", "load_and_validate", "merge_ledgers", "phase",
    "set_tracer", "span_counts", "traced", "validate_chrome_trace",
    "validate_ledger", "write_trace",
]
