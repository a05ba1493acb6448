"""Observability layer of the port. Only the span tracer is carried
over in this slice: the rewrite driver emits its rule-firing events
and stage spans through ``trace.current()``. Host-only."""
from repro_torch.core.obs.trace import (  # noqa: F401
    NULL_TRACER, Span, Tracer, current, sig_digest, using)
