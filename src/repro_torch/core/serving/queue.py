"""SLO-windowed admission on a deterministic virtual clock.

An open-loop serving tier cannot batch requests that arrive one call
at a time unless something *holds* them — but holding trades latency
for batch size. The admission queue makes that trade explicit: each
request joins the currently open *window*; a window closes when its
oldest request has waited the admission share of the latency SLO
(deadline close) or when it reaches the fill bound (fill close),
whichever first. Everything is driven by a ``VirtualClock`` the caller
advances, so tests and benchmarks replay identical traffic and get
identical window boundaries — no wall-clock nondeterminism in any
scheduling decision.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

from repro_torch.core.obs.trace import NULL_TRACER


class VirtualClock:
    """Deterministic monotonic time source. The runtime advances it
    from arrival timestamps (open-loop traffic) and, optionally, from
    measured dispatch durations; nothing in the serving layer reads
    wall time directly."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        assert dt >= 0, "virtual time is monotonic"
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        """Move to ``t`` if it is in the future (arrivals may carry
        timestamps the clock has already passed while dispatching —
        those requests are simply admitted late)."""
        if t > self._now:
            self._now = t
        return self._now


@dataclasses.dataclass
class Ticket:
    """One submitted request's lifecycle: admission through result.

    ``arrival``/``deadline``/``completion`` are virtual times;
    ``latency`` is the end-to-end virtual latency the SLO governs.
    ``result``/``error`` are filled by the scheduler at dispatch.
    ``stream`` names the windowed grouped stream this request's
    partial result folds into (serving/window.py), or None for
    ordinary one-shot requests. ``template`` is the workload template
    name the request was instantiated from (Q1..Q12), when known — the
    flight recorder (obs/recorder.py) persists it so synthetic traces,
    which speak in template names, can be joined against recorded ones.
    """
    seq: int
    tenant: str
    query: Any                      # PreparedQuery (prepared at submit)
    values: tuple                   # parameter binding values
    arrival: float
    deadline: float
    result: Any = None
    error: Optional[Exception] = None
    completion: Optional[float] = None
    stream: Optional[str] = None
    template: Optional[str] = None
    # filled when the ticket completes past its deadline: what the
    # completing dispatch paid for — "compile-on-path",
    # "regrowth-retry", or "queued-behind" (see RuntimeStats)
    slo_cause: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.result is not None or self.error is not None

    @property
    def latency(self) -> float:
        assert self.completion is not None, "ticket not served yet"
        return self.completion - self.arrival


class AdmissionQueue:
    """Time-windowed admission: accumulate tickets into FIFO windows
    that close by deadline or fill.

    ``window`` is the admission share of the SLO — how long the oldest
    ticket in a window may wait before the window must close (the rest
    of the SLO budget belongs to dispatch). ``max_fill`` closes a
    window early once batching gains saturate; later submissions open
    the next window.
    """

    def __init__(self, clock: VirtualClock, *, window: float,
                 max_fill: int, tracer=NULL_TRACER):
        assert window >= 0 and max_fill >= 1
        self.clock = clock
        self.window = window
        self.max_fill = max_fill
        self.tracer = tracer        # window-close instant events
        # each entry: (close_time, [tickets]) — FIFO, oldest first
        self._windows: deque[tuple[float, list[Ticket]]] = deque()
        self.admitted = 0
        self.closed_by_deadline = 0
        self.closed_by_fill = 0

    def __len__(self) -> int:
        return sum(len(ts) for _, ts in self._windows)

    def submit(self, ticket: Ticket) -> None:
        """Admit into the open window (opening one as needed). The
        window's close time is fixed by its FIRST ticket's arrival —
        admission latency is bounded for the oldest request, which is
        the one the SLO is tightest for. A window that is already full
        or past its close time never accepts new tickets (joining an
        overdue window would batch this request with ones whose SLO
        budget is spent)."""
        if (self._windows
                and len(self._windows[-1][1]) < self.max_fill
                and self._windows[-1][0] > self.clock.now()):
            self._windows[-1][1].append(ticket)
        else:
            self._windows.append((ticket.arrival + self.window,
                                  [ticket]))
        self.admitted += 1

    def pop_due(self) -> list[Ticket]:
        """Tickets of every window that is due now: past its close
        time, or full. Full windows are due immediately — holding a
        full window buys no batching and only spends SLO."""
        now = self.clock.now()
        out: list[Ticket] = []
        while self._windows:
            close, tickets = self._windows[0]
            if len(tickets) >= self.max_fill:
                self.closed_by_fill += 1
                cause = "fill"
            elif close <= now:
                self.closed_by_deadline += 1
                cause = "deadline"
            else:
                break
            self.tracer.event("window-close", cat="serving",
                              cause=cause, size=len(tickets))
            out.extend(tickets)
            self._windows.popleft()
        return out

    def next_close(self) -> Optional[float]:
        """Virtual time of the earliest pending window close (None
        when empty) — the drain loop advances the clock here when no
        window is due yet."""
        return self._windows[0][0] if self._windows else None

    def flush(self) -> list[Ticket]:
        """Close everything regardless of deadline (end-of-stream
        drain)."""
        out: list[Ticket] = []
        while self._windows:
            _, tickets = self._windows.popleft()
            self.closed_by_deadline += 1
            self.tracer.event("window-close", cat="serving",
                              cause="flush", size=len(tickets))
            out.extend(tickets)
        return out
