"""Observability for the port: structured tracing, serving metrics and
the fault-injection seam, kept as the port's own copy (plain Python, no
torch import at module level).

This package is a LEAF dependency: it imports nothing from
:mod:`repro_torch.core`, so the engine can thread tracer and fault hooks
through its hot paths without an import cycle.  The surfaces:

* :mod:`repro_torch.obs.trace` — a lightweight span/event :class:`Tracer`
  with JSON-lines and Chrome-trace (Perfetto-loadable) exporters, plus the
  module-global ``current_tracer()`` seam the engine consults (one
  attribute read + ``None`` check when tracing is off);
* :mod:`repro_torch.obs.metrics` — counters, gauges and bounded-memory
  latency histograms (p50/p95/p99) behind a :class:`MetricsRegistry` with
  a Prometheus-style text rendering;
* :mod:`repro_torch.obs.faultinject` — the named fault-injection points
  the bucket executor consults (same disabled-path budget as the tracer:
  one attribute read);
* :mod:`repro_torch.obs.check_trace` — the trace checker's rules
  (:func:`~repro_torch.obs.check_trace.check_trace`: record fields, the
  span forest, time nesting), runnable as ``python -m
  repro_torch.obs.check_trace TRACE.jsonl``.

The trace schema and the metrics catalog are those of docs/observability.md.
"""
from . import faultinject
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import (TRACE_SCHEMA_VERSION, Tracer, current_tracer,
                    read_jsonl, set_tracer, trace_event, trace_span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TRACE_SCHEMA_VERSION", "Tracer", "current_tracer", "faultinject",
    "read_jsonl", "set_tracer", "trace_event", "trace_span",
]
