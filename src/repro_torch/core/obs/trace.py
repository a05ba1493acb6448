"""Span tracer on dual clocks: wall time for host stages, the
serving tier's deterministic virtual clock for scheduling stages.

Span taxonomy (the ``name`` field; ``cat`` groups them):

====================  =========  =====================================
name                  cat        emitted by
====================  =========  =====================================
prepare               prepare    QueryService.prepare (parse→optimize→
                                 lift→verify, whole pipeline)
lift                  prepare    prepared.prepare_plan (literal lift +
                                 param-type re-verification)
verify                prepare    QueryService._prepare_plan (schema +
                                 capacity-flow static verifier)
rewrite.<stage>       rewrite    rewrite.engine.optimize, one span per
                                 rule stage (path/parallel/cleanup)
rewrite-rule          rewrite    instant per rule firing (args: rule)
compile               service    QueryService.compiled on cache miss
                                 (trace+jit of one cap/batch variant)
execute               service    QueryService.execute (regrowth ladder
                                 included)
serve-group           service    QueryService.serve_group (one batched
                                 dispatch + its regrowth retries)
regrow-retry          service    instant per regrowth rung (args: the
                                 caps that grew)
admit                 serving    ServingRuntime.submit (virtual-time
                                 stamps; one span per ticket)
window-close          serving    instant when an admission window
                                 closes (args: cause=deadline|fill|
                                 flush, size)
dispatch              serving    ServingRuntime._dispatch (one
                                 signature group leaving the DRR
                                 scheduler)
bucket                serving    instant per bucket decision (args:
                                 size, bucket)
bucket-refit          serving    instant when cost-based bucketing
                                 refits a signature's ladder
stream-absorb         serving    instant per windowed-stream partial
                                 absorbed
====================  =========  =====================================

Host stages carry wall timestamps only; spans opened while the tracer
is bound to a ``VirtualClock`` (``bind_clock``) additionally carry
virtual timestamps. ``virtual_log()`` renders ONLY the virtual-time
facts (never wall durations), so replaying the same seeded trace
yields byte-identical logs; ``chrome_trace()`` exports either clock as
Chrome/Perfetto ``trace_event`` JSON.

No jax at import time, and zero cost when tracing is off: the module
ships a ``NULL_TRACER`` whose ``span()`` returns one shared no-op
context manager — the service default, i.e. the pre-instrumentation
warm path. Nothing here ever runs inside jitted code; every emit site
sits at a host-side stage boundary.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Any, Optional


def sig_digest(sig) -> str:
    """Short stable digest of a plan signature (or any repr-able key)
    for span args / metric labels — full signatures are huge tuples."""
    r = sig if isinstance(sig, str) else repr(sig)
    return hashlib.md5(r.encode()).hexdigest()[:8]


class Span:
    """One recorded span (or instant event, when ``kind == 'event'``).

    ``wall0/wall1`` are ``time.perf_counter`` stamps; ``vt0/vt1`` are
    virtual-clock stamps, present only when the tracer had a clock
    bound while the span was open."""

    __slots__ = ("tracer", "sid", "parent", "name", "cat", "kind",
                 "wall0", "wall1", "vt0", "vt1", "args")

    def __init__(self, tracer: "Tracer", sid: int, name: str,
                 cat: str, args: dict):
        self.tracer = tracer
        self.sid = sid
        self.parent: Optional[int] = None
        self.name = name
        self.cat = cat
        self.kind = "span"
        self.wall0 = self.wall1 = None
        self.vt0 = self.vt1 = None
        self.args = args

    def set(self, **kw) -> None:
        """Attach args to an open span. Keep values deterministic
        (sizes, digests, names) — wall-derived values belong in the
        wall stamps, not args, or ``virtual_log`` loses replayability."""
        self.args.update(kw)

    @property
    def wall_dur(self) -> Optional[float]:
        if self.wall0 is None or self.wall1 is None:
            return None
        return self.wall1 - self.wall0

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.parent = tr._stack[-1] if tr._stack else None
        self.wall0 = time.perf_counter()  # lint: allow(DET001)
        if tr.clock is not None:
            self.vt0 = tr.clock.now()
        tr._stack.append(self.sid)
        tr._record(self)
        return self

    def __exit__(self, et, ev, tb):
        tr = self.tracer
        self.wall1 = time.perf_counter()  # lint: allow(DET001)
        if tr.clock is not None:
            self.vt1 = tr.clock.now()
        if et is not None:
            self.args.setdefault("error", et.__name__)
        tr._stack.pop()
        return False


class _NullSpan:
    """Shared no-op span: what NULL_TRACER (and a disabled Tracer)
    hands out. Supports the same surface at ~zero cost."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, et, ev, tb):
        return False


NULL_SPAN = _NullSpan()


#: default ``Tracer`` record bound — generous (a full 64-variant
#: benchmark pass emits a few thousand records), but finite, so
#: long-running serving with tracing on has bounded host memory.
DEFAULT_MAX_EVENTS = 262144


class Tracer:
    """Collects spans + instant events. ``enabled=False`` keeps the
    object attachable but makes every emit a no-op (the benchmarked
    "tracing disabled" configuration).

    ``max_events`` bounds ``records``: when the bound is exceeded the
    oldest half is evicted in one slice (amortized O(1) per record,
    and ``records`` stays a plain list so exports and tests index it
    directly). Evictions accumulate in ``dropped`` — surfaced as the
    ``tracer_dropped_events`` gauge in the metrics registry, because a
    trace that silently lost its head reads as a shorter run, not a
    truncated one. ``None`` means unlimited (the historical
    behaviour)."""

    def __init__(self, clock=None, enabled: bool = True,
                 max_events: Optional[int] = DEFAULT_MAX_EVENTS):
        assert max_events is None or max_events >= 2, max_events
        self.enabled = enabled
        self.clock = clock          # VirtualClock or None
        self.max_events = max_events
        self.dropped = 0
        self.records: list[Span] = []
        self._stack: list[int] = []
        self._seq = 0

    def _record(self, s: "Span") -> None:
        self.records.append(s)
        if (self.max_events is not None
                and len(self.records) > self.max_events):
            cut = max(1, self.max_events // 2)
            self.dropped += cut
            del self.records[:cut]

    # -- binding ----------------------------------------------------------

    def bind_clock(self, clock) -> None:
        """Bind the serving tier's virtual clock; spans opened while
        bound get vt0/vt1 stamps."""
        self.clock = clock

    # -- emission ---------------------------------------------------------

    def span(self, name: str, cat: str = "host", **args):
        if not self.enabled:
            return NULL_SPAN
        self._seq += 1
        return Span(self, self._seq, name, cat, args)

    def event(self, name: str, cat: str = "host", **args) -> None:
        """Instant event (Chrome ph "i")."""
        if not self.enabled:
            return
        self._seq += 1
        s = Span(self, self._seq, name, cat, args)
        s.kind = "event"
        s.parent = self._stack[-1] if self._stack else None
        s.wall0 = s.wall1 = time.perf_counter()  # lint: allow(DET001)
        if self.clock is not None:
            s.vt0 = s.vt1 = self.clock.now()
        self._record(s)

    # -- export -----------------------------------------------------------

    _TIDS = {"prepare": 1, "rewrite": 1, "service": 2, "serving": 3,
             "host": 4}

    def chrome_trace(self, clock: str = "wall") -> list[dict]:
        """Chrome/Perfetto ``trace_event`` JSON array (the subset with
        ph M/X/i). ``clock="virtual"`` exports virtual-time stamps
        (serving stages only — spans without vt are skipped);
        ``clock="wall"`` exports every record on wall time. Timestamps
        are microseconds per the spec."""
        assert clock in ("wall", "virtual"), clock
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": f"repro-serving ({clock} clock)"}},
        ]
        base = None
        for s in self.records:
            if clock == "virtual":
                if s.vt0 is None:
                    continue
                t0, t1 = s.vt0, (s.vt1 if s.vt1 is not None else s.vt0)
            else:
                if s.wall0 is None:
                    continue
                t0, t1 = s.wall0, (s.wall1 if s.wall1 is not None
                                   else s.wall0)
            if base is None:
                base = t0
            rec: dict[str, Any] = {
                "name": s.name, "cat": s.cat, "pid": 1,
                "tid": self._TIDS.get(s.cat, 4),
                "ts": round((t0 - base) * 1e6, 3),
            }
            if s.args:
                rec["args"] = dict(s.args)
            if s.kind == "event":
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(max(t1 - t0, 0.0) * 1e6, 3)
            events.append(rec)
        return events

    def virtual_log(self) -> list[str]:
        """Canonical virtual-time log: one line per record that carries
        virtual stamps, args JSON-rendered with sorted keys, wall times
        excluded — byte-identical across replays of the same seeded
        trace."""
        out = []
        for s in self.records:
            if s.vt0 is None:
                continue
            vt1 = s.vt1 if s.vt1 is not None else s.vt0
            args = json.dumps(s.args, sort_keys=True, default=str)
            out.append(f"{s.kind} {s.cat}:{s.name} "
                       f"vt0={s.vt0:.6f} vt1={vt1:.6f} {args}")
        return out

    def clear(self) -> None:
        self.records.clear()
        self._stack.clear()
        self._seq = 0
        self.dropped = 0


class _NullTracer(Tracer):
    """The default tracer: permanently disabled, shared, stateless."""

    def __init__(self):
        super().__init__(enabled=False)

    def bind_clock(self, clock) -> None:
        pass


NULL_TRACER = _NullTracer()


# -- ambient tracer ---------------------------------------------------------
#
# Deep stages (rewrite rules, literal lifting, windowed-stream
# absorption, bucket refits) emit through a module-level tracer stack
# instead of threading a tracer argument through every call chain:
# the service/runtime installs its tracer with ``using(...)`` around
# the stage, the leaf calls ``current().event(...)``.

_STACK: list[Tracer] = [NULL_TRACER]


def current() -> Tracer:
    return _STACK[-1]


@contextlib.contextmanager
def using(tracer: Optional[Tracer]):
    _STACK.append(tracer if tracer is not None else NULL_TRACER)
    try:
        yield
    finally:
        _STACK.pop()


# -- validation -------------------------------------------------------------

_PHASES = {"M", "X", "i", "B", "E", "C", "b", "e", "n"}
_INSTANT_SCOPES = {"g", "p", "t"}


def validate_trace_events(events) -> list[str]:
    """Validate a JSON-ready event list against the Chrome
    ``trace_event`` format (the "JSON Array" flavor). Returns a list
    of problems — empty means valid. Checks the spec's required
    fields: ``ph``/``name``/``pid``/``tid`` everywhere, numeric
    ``ts`` (+ nonnegative ``dur``) on complete events, an instant
    scope in {g,p,t}, dict ``args``."""
    problems: list[str] = []
    if not isinstance(events, list):
        return ["trace must be a JSON array of event objects"]
    for i, e in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad or missing ph {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in e:
                problems.append(f"{where}: missing {key!r}")
        if not isinstance(e.get("name"), str):
            problems.append(f"{where}: name must be a string")
        if "args" in e and not isinstance(e["args"], dict):
            problems.append(f"{where}: args must be an object")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"{where}: missing numeric ts")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: complete event needs "
                                f"nonnegative numeric dur, got {dur!r}")
        if ph == "i" and e.get("s") not in _INSTANT_SCOPES:
            problems.append(f"{where}: instant scope s must be one of "
                            f"g/p/t, got {e.get('s')!r}")
        try:
            json.dumps(e)
        except TypeError as ex:
            problems.append(f"{where}: not JSON-serializable ({ex})")
    return problems
