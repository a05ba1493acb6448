"""Async multi-tenant serving runtime (the layer between the
prepared-query cache and "millions of users").

``QueryService`` (service.py) is call-driven: it batches only the
requests handed to one ``execute_batch`` call. This package adds the
runtime that keeps devices saturated across concurrent query
*streams*:

  queue.py      time-windowed admission on a deterministic virtual
                clock — requests from many tenants accumulate under a
                latency SLO; windows close by deadline or fill
  bucketing.py  cost-based batch-bucket selection replacing blind
                pow2 padding — bucket sizes chosen to minimize
                padding waste x compile count over the observed
                signature mix
  scheduler.py  fair cross-tenant dispatch (deficit round-robin) that
                issues grouped batches through the service's batched
                regrowth ladder, plus ``ServingRuntime`` gluing all
                three behind ``QueryService.submit()/drain()``
  window.py     streaming-window grouped mode — per-admission-window
                partial group states (count/sum/min/max) merged
                associatively across batches, merge-order invariant
                by construction
  simulate.py   deviceless discrete-event replay of recorded or
                synthetic traces through the same admission/DRR/
                bucketing code, charging a calibrated cost model
                instead of dispatching — capacity curves in seconds
"""
from repro_torch.core.serving.bucketing import (CostBasedBucketing,  # noqa: F401
                                          Pow2Bucketing, next_pow2)
from repro_torch.core.serving.queue import (AdmissionQueue, Ticket,  # noqa: F401
                                      VirtualClock)
from repro_torch.core.serving.scheduler import (FairScheduler,  # noqa: F401
                                          RuntimeStats, ServingRuntime)
from repro_torch.core.serving.simulate import (SimEvent, SimReport,  # noqa: F401
                                         Simulation, events_from_trace,
                                         events_from_traffic, simulate)
from repro_torch.core.serving.window import (GroupSpec,  # noqa: F401
                                       WindowedGroupState, group_spec_of)
