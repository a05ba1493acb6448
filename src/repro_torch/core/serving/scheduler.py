"""Fair cross-tenant dispatch and the serving runtime.

``FairScheduler`` is a deficit round-robin: each tenant owns a FIFO of
admitted tickets and a deficit counter topped up by ``quantum`` every
round it has backlog. A flooding tenant cannot starve a light one —
while both have backlog, per-round service differs by at most one
quantum (the property test in tests/test_scheduler.py pins this under
an adversarial arrival mix).

``ServingRuntime`` glues the pieces into the asynchronous frontend
``QueryService.submit()/drain()`` exposes:

    submit --> AdmissionQueue (SLO windows, virtual clock)
           --> FairScheduler (deficit round-robin across tenants)
           --> group by erased signature
           --> bucketing policy (cost-based or pow2)
           --> QueryService.serve_group (ONE batched dispatch per
               signature group, batched regrowth on overflow)

Results are exactness-preserving and bit-identical to direct
per-request ``execute`` — the runtime only decides *when* and *with
whom* a request shares a dispatch, never how it is computed.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Optional

from repro_torch.core.obs import trace as obs_trace
from repro_torch.core.obs.metrics import stats_diff, stats_snapshot
from repro_torch.core.obs.trace import NULL_TRACER, sig_digest
from repro_torch.core.serving.bucketing import make_policy
from repro_torch.core.serving.queue import AdmissionQueue, Ticket, VirtualClock
from repro_torch.core.serving.window import WindowedGroupState, group_spec_of


class FairScheduler:
    """Deficit round-robin over tenants (credits in requests)."""

    def __init__(self, quantum: int = 4):
        assert quantum >= 1
        self.quantum = quantum
        self._queues: "OrderedDict[str, deque[Ticket]]" = OrderedDict()
        self._deficit: dict[str, float] = {}
        self.served: dict[str, int] = {}
        # rotation cursor: budgeted sweeps start at a different active
        # tenant each round, so a budget smaller than the sum of
        # active quanta cannot permanently starve later-offered
        # tenants (their deficit also carries over until served)
        self._rotate = 0

    def offer(self, tickets: list[Ticket]) -> None:
        for t in tickets:
            self._queues.setdefault(t.tenant, deque()).append(t)

    def backlog(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def select(self, budget: Optional[int] = None) -> list[Ticket]:
        """One DRR sweep: every backlogged tenant earns a quantum,
        then spends its deficit FIFO. ``budget`` caps total picks per
        sweep (None: one full round; must be >= 1 — a zero budget
        would pick nothing forever). Sweeps start at a rotating
        tenant, so a budget exhausted by the first tenants still
        reaches the rest on later sweeps. Tenants that drain give
        their leftover credit up — deficit resets on empty, so idle
        tenants cannot hoard service."""
        assert budget is None or budget >= 1, \
            "budget must be None or >= 1"
        picked: list[Ticket] = []
        active = [t for t, q in self._queues.items() if q]
        for tenant in active:
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) \
                + self.quantum
        if active:
            start = self._rotate % len(active)
            active = active[start:] + active[:start]
            self._rotate += 1
        for tenant in active:
            q = self._queues[tenant]
            while q and self._deficit[tenant] >= 1 and (
                    budget is None or len(picked) < budget):
                picked.append(q.popleft())
                self._deficit[tenant] -= 1
                self.served[tenant] = self.served.get(tenant, 0) + 1
            if not q:
                self._deficit[tenant] = 0.0
        return picked


@dataclasses.dataclass
class RuntimeStats:
    submitted: int = 0
    dispatched: int = 0         # requests that completed
    batches: int = 0            # grouped device dispatches
    scalar_dispatches: int = 0  # singleton / parameterless requests
    padded_slots: int = 0       # phantom batch slots executed
    padded_rows: int = 0        # phantom slots x per-request row cost
    real_rows: int = 0          # real slots x per-request row cost
    steps: int = 0              # scheduler sweeps
    slo_misses: int = 0         # tickets completed past their deadline
    # per-tenant breakdown of slo_misses (sums to it) and per-cause
    # attribution: "compile-on-path" (the dispatch that completed the
    # ticket paid a trace+compile), "regrowth-retry" (it regrew a
    # capacity and retried), "queued-behind" (the work was warm — the
    # deadline was blown waiting on windows/scheduling). Tickets carry
    # the same verdict in ``Ticket.slo_cause``.
    slo_misses_by_tenant: dict = dataclasses.field(default_factory=dict)
    slo_miss_causes: dict = dataclasses.field(default_factory=dict)
    # gauges (instantaneous, not monotonic): tickets held in pending
    # admission windows / in the scheduler's per-tenant FIFOs, sampled
    # after every sweep — the capacity sweep plots queue growth
    # against offered load from these
    queue_depth: int = 0
    sched_backlog: int = 0

    @property
    def padding_waste(self) -> float:
        """Fraction of executed rows that were phantom padding."""
        total = self.padded_rows + self.real_rows
        return self.padded_rows / total if total else 0.0

    def snapshot(self) -> "RuntimeStats":
        return stats_snapshot(self)

    def diff(self, since: "RuntimeStats") -> "RuntimeStats":
        return stats_diff(self, since)


class ServingRuntime:
    """The admission-and-scheduling loop in front of a QueryService.

    Deterministic by construction: all scheduling decisions read the
    virtual clock, which advances from submitted arrival timestamps
    and (only when ``measure_service_time=True``, the benchmark mode)
    from measured dispatch durations. ``window`` is the admission
    share of the latency SLO.
    """

    def __init__(self, service, *, window: float = 1.0,
                 max_fill: int = 16, quantum: int = 4,
                 policy=None, clock: Optional[VirtualClock] = None,
                 measure_service_time: bool = False,
                 recorder=None):
        self.service = service
        # optional flight recorder (obs/recorder.py): every admitted
        # ticket is captured at submit() for deviceless replay
        self.recorder = recorder
        self.clock = clock or VirtualClock()
        # observability: share the service's tracer; serving-stage
        # spans carry virtual timestamps once the clock is bound
        self.tracer = getattr(service, "tracer", NULL_TRACER)
        if self.tracer.enabled:
            self.tracer.bind_clock(self.clock)
        self.queue = AdmissionQueue(self.clock, window=window,
                                    max_fill=max_fill,
                                    tracer=self.tracer)
        self.scheduler = FairScheduler(quantum=quantum)
        if policy is None:
            policy = "cost"
        if isinstance(policy, str):
            kw = ({} if policy == "pow2" else
                  {"row_cost_for": service.row_cost_for_signature})
            policy = make_policy(policy, **kw)
        self.policy = policy
        self.measure_service_time = measure_service_time
        self.stats = RuntimeStats()
        # register this runtime's stats + latency histograms with the
        # service's metrics registry. Re-binding the "runtime" prefix
        # on a second runtime is intentional: the live one wins.
        metrics = getattr(service, "metrics", None)
        if metrics is not None:
            metrics.register_stats("runtime", self.stats)
            self._lat_tenant = metrics.histogram(
                "runtime_latency_vs",
                help="per-tenant virtual completion latency (s)")
            self._lat_sig = metrics.histogram(
                "runtime_latency_sig_vs",
                help="per-signature virtual completion latency (s)")
        else:
            self._lat_tenant = self._lat_sig = None
        self._tickets: list[Ticket] = []
        # (sig, group_size, bucket, row_cost) per batched dispatch —
        # the trace a CostBasedBucketing ladder can be fitted from
        # offline (benchmarks/serving_benchmarks.py)
        self.dispatch_log: list[tuple[str, int, int, int]] = []
        # (sig digest, group_size, bucket, seconds, compiles) per
        # dispatch, appended only under measure_service_time — the
        # observations obs/costmodel.py fits dispatch service time
        # from (compiles > 0 marks cold samples the warm fit excludes)
        self.service_log: list[tuple[str, int, int, float, int]] = []
        # streaming-window grouped mode: stream name -> running merged
        # state (serving/window.py). Partials are absorbed as their
        # tickets complete — in whatever order batches dispatch — and
        # the state survives drain() so a stream accumulates across
        # admission horizons. A streamed ticket that errors at
        # dispatch is recorded here: a stream missing a window is NOT
        # a smaller exact result, it is a wrong one, so reads fail
        # loudly instead
        self._streams: dict[str, WindowedGroupState] = {}
        self._stream_failed: dict[str, list[int]] = {}

    # -- frontend ----------------------------------------------------------

    def submit(self, query, bindings=None, *, tenant: str = "default",
               at: Optional[float] = None, slo: Optional[float] = None,
               stream: Optional[str] = None,
               template: Optional[str] = None) -> Ticket:
        """Admit one request. ``at`` is its virtual arrival time
        (advancing the clock — open-loop traffic submits in timestamp
        order); ``slo`` overrides the ticket's latency deadline
        (default: admission window + one window of dispatch budget).
        Preparation happens here so admission groups by erased
        signature, not query text. ``stream`` files the request's
        grouped result as one window's partial of the named windowed
        stream (the plan must be associatively mergeable —
        count/sum/min/max, no HAVING/order/post-group wrappers);
        streamed requests admit, bucket and dispatch exactly like
        every other request."""
        if at is not None:
            # an arrival that crosses pending window deadlines closes
            # and dispatches them AT those deadlines first — the clock
            # must never jump a window past its own close time (that
            # would bill the gap to the next arrival as queueing
            # latency and batch requests the SLO never allowed
            # together)
            nxt = self.queue.next_close()
            while nxt is not None and nxt < at:
                self.clock.advance_to(nxt)
                self.step()
                nxt = self.queue.next_close()
            self.clock.advance_to(at)
        now = self.clock.now()
        with self.tracer.span("admit", cat="serving", tenant=tenant,
                              seq=self.stats.submitted) as sp:
            pq = self.service.prepare(query)
            sp.set(sig=sig_digest(pq.signature))
            values = self.service._values_for(pq, bindings)
        if stream is not None:
            spec = group_spec_of(pq.plan)   # raises on non-mergeable
            st = self._streams.get(stream)
            if st is None:
                self._streams[stream] = WindowedGroupState(spec)
            elif st.spec != spec:
                raise ValueError(
                    f"stream {stream!r} already carries a different "
                    f"grouped result layout")
        deadline = now + (slo if slo is not None
                          else 2.0 * self.queue.window)
        # seq is the runtime-lifetime submission ordinal (NOT the index
        # into the current horizon's ticket list, which drain resets):
        # it doubles as the stream window id, which must stay unique
        # across drains
        t = Ticket(seq=self.stats.submitted, tenant=tenant, query=pq,
                   values=values, arrival=now, deadline=deadline,
                   stream=stream, template=template)
        self._tickets.append(t)
        self.queue.submit(t)
        self.stats.submitted += 1
        if self.recorder is not None:
            self.recorder.record(t)
        # open-loop semantics: submitting IS the passage of time, so
        # windows whose deadline this arrival crossed dispatch now —
        # not at some eventual drain (which would inflate their
        # latency by the remaining traffic horizon)
        self.step()
        return t

    # -- dispatch ----------------------------------------------------------

    def step(self, budget: Optional[int] = None) -> int:
        """Close due windows, run one DRR sweep, dispatch the picked
        tickets grouped by signature. Returns tickets processed
        (completed or errored — progress either way)."""
        self.scheduler.offer(self.queue.pop_due())
        picked = self.scheduler.select(budget)
        if not picked:
            self._sample_gauges()
            return 0
        self.stats.steps += 1
        groups: "OrderedDict[str, list[Ticket]]" = OrderedDict()
        for t in picked:
            groups.setdefault(t.query.signature, []).append(t)
        done = 0
        for sig, tickets in groups.items():
            done += self._dispatch(sig, tickets)
        self._sample_gauges()
        return done

    def _sample_gauges(self) -> None:
        # instantaneous occupancy after a sweep; plain assignment, not
        # accumulation, so re-sampling is idempotent
        self.stats.queue_depth = len(self.queue)
        self.stats.sched_backlog = self.scheduler.backlog()

    def _dispatch(self, sig: str, tickets: list[Ticket]) -> int:
        # install this runtime's tracer as the ambient one for the
        # whole dispatch: nested instants fired from deeper layers
        # (bucket-refit in bucketing.py, stream-absorb in window.py,
        # rewrite-rule under a cold prepare) attach to the trace
        # without those modules importing the runtime
        with obs_trace.using(self.tracer):
            return self._dispatch_inner(sig, tickets)

    def _dispatch_inner(self, sig: str, tickets: list[Ticket]) -> int:
        svc = self.service
        pq = tickets[0].query
        row_cost = svc.row_cost(pq)
        # snapshot service counters before the work so an SLO miss can
        # be attributed to what this dispatch actually paid for:
        # compiles on the critical path, regrowth retries, or plain
        # queueing behind other windows (all counters warm)
        before = svc.stats.snapshot()
        # opt-in latency measurement, never on the result path
        t0 = (time.perf_counter()  # lint: allow(DET001)
              if self.measure_service_time else 0.0)
        bucket = len(tickets)       # scalar path: no padding
        with self.tracer.span("dispatch", cat="serving",
                              sig=sig_digest(sig),
                              requests=len(tickets)) as span:
            try:
                if len(tickets) == 1 or not pq.specs:
                    for t in tickets:
                        t.result = svc.execute(t.query, t.values)
                    self.stats.scalar_dispatches += len(tickets)
                    span.set(mode="scalar")
                else:
                    size = len(tickets)
                    # decide with what the policy knows, THEN learn:
                    # the fitted ladder only ever serves later
                    # windows, so a cold signature pads pow2 instead
                    # of compiling a bucket bespoke to its first group
                    bucket = self.policy.bucket_for(sig, size)
                    self.policy.observe(sig, size)
                    self.tracer.event("bucket", cat="serving",
                                      sig=sig_digest(sig), size=size,
                                      bucket=bucket)
                    rss = svc.serve_group(
                        pq, [t.values for t in tickets], bucket=bucket)
                    for t, rs in zip(tickets, rss):
                        t.result = rs
                    self.stats.batches += 1
                    self.stats.padded_slots += bucket - size
                    self.stats.padded_rows += (bucket - size) * row_cost
                    self.dispatch_log.append((sig, size, bucket,
                                              row_cost))
                    span.set(mode="batched", bucket=bucket)
            except Exception as e:  # exactness failures surface per
                for t in tickets:   # ticket
                    if t.result is None:
                        t.error = e
                span.set(error=type(e).__name__)
        if self.measure_service_time:
            elapsed = time.perf_counter() - t0  # lint: allow(DET001)
            self.clock.advance(elapsed)
            # service-time observation for the cost model — compile
            # count tags cold samples so the warm fit can exclude them
            self.service_log.append(
                (sig_digest(sig), len(tickets), bucket, elapsed,
                 svc.stats.compiles - before.compiles))
        delta = svc.stats.diff(before)
        cause = ("compile-on-path" if delta.compiles > 0 else
                 "regrowth-retry" if delta.retries > 0 else
                 "queued-behind")
        # only work that actually completed counts as executed rows /
        # dispatched requests — an errored group must not inflate
        # throughput or deflate padding_waste in the benchmark record
        completed = sum(1 for t in tickets if t.result is not None)
        self.stats.real_rows += completed * row_cost
        now = self.clock.now()
        for t in tickets:
            t.completion = now
            latency = now - t.arrival
            if self._lat_tenant is not None:
                self._lat_tenant.labels(tenant=t.tenant) \
                    .observe(latency)
                self._lat_sig.labels(sig=sig_digest(sig)) \
                    .observe(latency)
            if now > t.deadline:
                t.slo_cause = cause
                self.stats.slo_misses += 1
                self.stats.slo_misses_by_tenant[t.tenant] = \
                    self.stats.slo_misses_by_tenant.get(t.tenant,
                                                        0) + 1
                self.stats.slo_miss_causes[cause] = \
                    self.stats.slo_miss_causes.get(cause, 0) + 1
            if t.stream is not None:
                if t.result is not None:
                    # fold this window's partial groups into the
                    # stream — dispatch order is whatever the
                    # scheduler produced, which is exactly why the
                    # state is merge-order invariant by construction
                    self._streams[t.stream].absorb(t.seq,
                                                   t.result.rows())
                else:
                    # a lost window poisons the stream's totals;
                    # remember it so stream_result refuses
                    self._stream_failed.setdefault(
                        t.stream, []).append(t.seq)
        self.stats.dispatched += completed
        # processed count (incl. errored tickets): the drain loop must
        # keep sweeping remaining backlog even when one group errors
        return len(tickets)

    # -- windowed grouped streams ------------------------------------------

    def stream_state(self, name: str) -> WindowedGroupState:
        """The named stream's running merged state (raises KeyError
        for unknown streams). States persist across ``drain()`` calls
        so a stream keeps accumulating over admission horizons."""
        return self._streams[name]

    def stream_result(self, name: str) -> list[tuple]:
        """Finalized grouped rows of the named stream: every absorbed
        window's partials folded in canonical order — for f32-exact
        data, bit-identical to the one-shot grouped query over the
        union of the windows. Raises RuntimeError when any of the
        stream's windows failed at dispatch: totals missing a window
        are wrong, not merely partial (the per-ticket ``error`` has
        the cause)."""
        failed = self._stream_failed.get(name)
        if failed:
            raise RuntimeError(
                f"stream {name!r} lost window(s) {sorted(failed)} to "
                f"dispatch errors; its totals would be silently "
                f"wrong — see the failed tickets' .error")
        return self._streams[name].finalize()

    # -- drain -------------------------------------------------------------

    def drain(self, budget: Optional[int] = None) -> list[Ticket]:
        """Run to quiescence: close every pending window (advancing
        the clock to each close time, so deadline closes happen at
        their deadline, not "now") and dispatch until no backlog
        remains. Returns all tickets in submission order; each ticket
        that missed its deadline carries its attributed cause in
        ``slo_cause`` and the aggregate per-tenant / per-cause
        breakdown is live in ``stats.slo_misses_by_tenant`` /
        ``stats.slo_miss_causes``."""
        while len(self.queue) or self.scheduler.backlog():
            if self.step(budget):
                continue
            nxt = self.queue.next_close()
            if nxt is not None:
                self.clock.advance_to(nxt)
            else:
                break
        out, self._tickets = self._tickets, []
        return out
