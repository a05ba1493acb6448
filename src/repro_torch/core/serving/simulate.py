"""Deviceless discrete-event capacity simulator.

Replays a recorded (``obs/recorder.py``) or synthetic
(``workload.make_tenant_traffic``) multi-tenant trace through the
*real* serving-control-plane code — ``AdmissionQueue`` windows,
``FairScheduler`` deficit round-robin, the bucketing policies, the
``VirtualClock`` — substituting a calibrated ``CostModel``
(``obs/costmodel.py``) for device dispatch. Nothing here touches a device:
a 10^5-request trace replays in seconds on a bare CPU, which is the
point — p50/p99-vs-offered-load curves without burning device hours.

Fidelity contract (gated in ``benchmarks --suite capacity``): the
submit/step/drain loops below mirror ``ServingRuntime`` decision for
decision — the strict ``nxt < at`` window-close loop on submit, a
``step()`` after every admission, the same deadline formula, the same
DRR sweep, the same scalar-vs-batched split and policy observe rule.
Replaying a recorded trace with the **zero cost model** (dispatch
charges 0s) therefore reproduces a pure-virtual live run's per-tenant
latency distribution exactly; with a **fitted** cost model it
approximates a measuring live run to within the model's stated
calibration error.

Known approximation: the simulator sees signature digests, not plans,
so it cannot detect parameterless queries — every size-1 group is
scalar, every larger group is batched. All Q1-Q12 serving templates
are parameterized, so the recorded-trace replays this module is gated
on never hit the difference.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional

from repro_torch.core.obs.costmodel import CostModel
from repro_torch.core.serving.bucketing import make_policy
from repro_torch.core.serving.queue import AdmissionQueue, Ticket, VirtualClock
from repro_torch.core.serving.scheduler import FairScheduler, RuntimeStats


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One arrival of the replayed trace. ``sig`` is the erased
    signature digest (the grouping key for batching); ``slo`` of None
    takes the runtime default (2x admission window)."""
    arrival: float
    tenant: str
    sig: str
    slo: Optional[float] = None
    template: Optional[str] = None


class SimQuery:
    """Stand-in for a PreparedQuery: carries only what the control
    plane reads — the signature (grouping key) and a truthy ``specs``
    so groups >1 take the batched path (see module docstring)."""

    __slots__ = ("signature", "specs")

    def __init__(self, sig: str):
        self.signature = sig
        self.specs = (True,)


def events_from_trace(trace) -> list[SimEvent]:
    """A recorded ``FlightTrace`` as replayable events (already in
    admission order — the recorder captured them at submit)."""
    return [SimEvent(arrival=e["arrival"], tenant=e["tenant"],
                     sig=e["sig"], slo=e["slo"],
                     template=e["template"])
            for e in trace.events]


def events_from_traffic(traffic, template_sigs: Optional[dict] = None,
                        *, slo: Optional[float] = None,
                        load: float = 1.0) -> list[SimEvent]:
    """Synthetic ``make_tenant_traffic`` output — ``(arrival, tenant,
    template, text)`` tuples — as replayable events. ``template_sigs``
    (e.g. ``FlightTrace.template_signatures()``) joins template names
    onto the cost model's signature digests; unmapped templates use
    their own name as the signature, which groups correctly but
    predicts at the model's global default. ``load`` scales the
    offered rate: arrivals compress by 1/load (2.0 = twice the traffic
    per virtual second)."""
    assert load > 0, load
    sigs = template_sigs or {}
    return [SimEvent(arrival=at / load, tenant=tenant,
                     sig=sigs.get(template, template), slo=slo,
                     template=template)
            for at, tenant, template, _text in traffic]


@dataclasses.dataclass
class SimReport:
    """What a replay produces: the served tickets, the runtime-shape
    stats, and per-tenant latency samples (virtual seconds, sorted)."""
    stats: RuntimeStats
    tickets: list
    latencies_by_tenant: dict
    queue_samples: list         # (virtual t, queue depth, backlog)
    makespan: float

    def latencies(self) -> list:
        out = sorted(x for xs in self.latencies_by_tenant.values()
                     for x in xs)
        return out

    def percentile(self, p: float,
                   tenant: Optional[str] = None) -> float:
        """Nearest-rank percentile (matches the benchmark's ``_pct``)
        over all latencies or one tenant's."""
        vals = (sorted(self.latencies_by_tenant.get(tenant, []))
                if tenant is not None else self.latencies())
        if not vals:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * len(vals)))
        return vals[rank - 1]

    def summary(self) -> dict:
        per_tenant = {
            t: {"n": len(xs),
                "p50_vs": self.percentile(50, t),
                "p99_vs": self.percentile(99, t)}
            for t, xs in sorted(self.latencies_by_tenant.items())}
        return {
            "requests": self.stats.submitted,
            "completed": self.stats.dispatched,
            "makespan_vs": self.makespan,
            "p50_vs": self.percentile(50),
            "p99_vs": self.percentile(99),
            "slo_misses": self.stats.slo_misses,
            "slo_misses_by_tenant": dict(
                self.stats.slo_misses_by_tenant),
            "slo_miss_causes": dict(self.stats.slo_miss_causes),
            "tenants": per_tenant,
        }


class Simulation:
    """The ServingRuntime control loop with cost-model dispatch.

    Every scheduling decision runs through the real components; only
    ``_dispatch`` differs — it advances the clock by the model's
    predicted service time instead of executing a device dispatch
    (first touch of a (sig, bucket) pair charges the cold prediction,
    mirroring the compiled-plan cache)."""

    def __init__(self, *, window: float = 1.0, max_fill: int = 16,
                 quantum: int = 4, policy="pow2",
                 cost_model: Optional[CostModel] = None,
                 clock: Optional[VirtualClock] = None):
        self.clock = clock or VirtualClock()
        self.queue = AdmissionQueue(self.clock, window=window,
                                    max_fill=max_fill)
        self.scheduler = FairScheduler(quantum=quantum)
        self.policy = (make_policy(policy) if isinstance(policy, str)
                       else policy)
        self.cost = cost_model if cost_model is not None else CostModel()
        self.stats = RuntimeStats()
        self._compiled: set[tuple[str, int]] = set()
        self._tickets: list[Ticket] = []
        self.queue_samples: list[tuple[float, int, int]] = []

    # -- the ServingRuntime-mirroring loop (keep in lockstep with
    # serving/scheduler.py: the fidelity gate depends on it) ---------------

    def submit(self, ev: SimEvent) -> Ticket:
        at = ev.arrival
        nxt = self.queue.next_close()
        while nxt is not None and nxt < at:
            self.clock.advance_to(nxt)
            self.step()
            nxt = self.queue.next_close()
        self.clock.advance_to(at)
        # Stamp the OFFERED arrival, not clock.now(): costed
        # dispatches can push the clock past ``at``, and latency /
        # deadline must keep measuring from when the request was
        # offered — that is where queueing delay shows up once the
        # sweep drives the system past saturation. In a zero-cost
        # replay the clock never outruns arrivals, the two coincide,
        # and the live-fidelity gate is unaffected.
        deadline = at + (ev.slo if ev.slo is not None
                         else 2.0 * self.queue.window)
        t = Ticket(seq=self.stats.submitted, tenant=ev.tenant,
                   query=SimQuery(ev.sig), values=(), arrival=at,
                   deadline=deadline, template=ev.template)
        self._tickets.append(t)
        self.queue.submit(t)
        self.stats.submitted += 1
        self.step()
        return t

    def step(self, budget: Optional[int] = None) -> int:
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
        self.stats.queue_depth = len(self.queue)
        self.stats.sched_backlog = self.scheduler.backlog()
        self.queue_samples.append((self.clock.now(),
                                   self.stats.queue_depth,
                                   self.stats.sched_backlog))

    def _dispatch(self, sig: str, tickets: list[Ticket]) -> int:
        size = len(tickets)
        if size == 1:
            bucket = size
            self.stats.scalar_dispatches += size
        else:
            # decide-then-learn, same order as the live runtime
            bucket = self.policy.bucket_for(sig, size)
            self.policy.observe(sig, size)
            self.stats.batches += 1
            self.stats.padded_slots += bucket - size
        key = (sig, bucket)
        if key in self._compiled:
            cause = "queued-behind"
            self.clock.advance(self.cost.predict(sig, bucket))
        else:
            self._compiled.add(key)
            cause = "compile-on-path"
            self.clock.advance(self.cost.predict_cold(sig, bucket))
        now = self.clock.now()
        for t in tickets:
            t.result = True     # simulated completion marker
            t.completion = now
            if now > t.deadline:
                t.slo_cause = cause
                self.stats.slo_misses += 1
                self.stats.slo_misses_by_tenant[t.tenant] = \
                    self.stats.slo_misses_by_tenant.get(t.tenant,
                                                        0) + 1
                self.stats.slo_miss_causes[cause] = \
                    self.stats.slo_miss_causes.get(cause, 0) + 1
        self.stats.dispatched += size
        return size

    def drain(self, budget: Optional[int] = None) -> list[Ticket]:
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


def simulate(events, *, window: float = 1.0, max_fill: int = 16,
             quantum: int = 4, policy="pow2",
             cost_model: Optional[CostModel] = None) -> SimReport:
    """Replay ``events`` (SimEvents, in arrival order) open-loop and
    drain; return the report. This is the whole capacity-planning
    entry point: deterministic — same events + same model, same
    report, bit for bit."""
    sim = Simulation(window=window, max_fill=max_fill,
                     quantum=quantum, policy=policy,
                     cost_model=cost_model)
    last = -math.inf
    for ev in events:
        assert ev.arrival >= last, \
            "events must be sorted by arrival time"
        last = ev.arrival
        sim.submit(ev)
    tickets = sim.drain()
    by_tenant: dict[str, list[float]] = {}
    for t in tickets:
        by_tenant.setdefault(t.tenant, []).append(t.latency)
    for xs in by_tenant.values():
        xs.sort()
    return SimReport(stats=sim.stats, tickets=tickets,
                     latencies_by_tenant=by_tenant,
                     queue_samples=sim.queue_samples,
                     makespan=sim.clock.now())
