"""Observability layer: span tracer (dual wall/virtual clocks, Chrome
trace export), metrics registry (Prometheus text + JSONL sink),
per-query operator profiles, the workload flight recorder, and the
calibrated dispatch cost model the capacity simulator replays
against. Host-only — nothing here runs inside a compiled plan, and
the NULL_TRACER default keeps the warm path at its pre-instrumentation
cost."""
from repro_torch.core.obs.costmodel import (CostModel, fit_cost_model)
from repro_torch.core.obs.metrics import (Counter, EventSink, Gauge,
                                          Histogram, MetricsRegistry,
                                          REGISTERED_STATS, stats_diff,
                                          stats_snapshot)
from repro_torch.core.obs.profile import (OpProfile, QueryProfile,
                                          build_profile)
from repro_torch.core.obs.recorder import (FlightRecorder, FlightTrace,
                                           load_trace, load_trace_file)
from repro_torch.core.obs.trace import (NULL_TRACER, Span, Tracer, current,
                                        sig_digest, using,
                                        validate_trace_events)

__all__ = [
    "CostModel", "fit_cost_model",
    "Counter", "EventSink", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTERED_STATS", "stats_diff", "stats_snapshot",
    "OpProfile", "QueryProfile", "build_profile",
    "FlightRecorder", "FlightTrace", "load_trace", "load_trace_file",
    "NULL_TRACER", "Span", "Tracer", "current", "sig_digest",
    "using", "validate_trace_events",
]
