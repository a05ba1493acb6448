"""Workload flight recorder: bounded capture of admitted traffic into
a versioned, schema-validated JSONL trace format.

``FlightRecorder`` hooks into ``ServingRuntime.submit()`` (pass
``recorder=`` when building the runtime): every admitted ticket is
captured as one event — tenant, template name, parameter bindings,
virtual arrival time, SLO window, erased-signature digest — into a
bounded ring buffer, so a long-running service records the *recent*
production-shaped traffic at O(capacity) memory (evictions are counted
in ``dropped``). A finished recording renders as a ``FlightTrace``:

  line 1   header — ``{"format": "repro.flight-trace", "version": 1}``
  line 2+  one canonical-JSON event per admitted ticket

The serialization is canonical (sorted keys, fixed separators), so
``load_trace(trace.dumps()).dumps() == trace.dumps()`` byte-for-byte —
the round-trip property tests pin this. ``load_trace`` validates the
schema version and every event's required fields/types and rejects
violations with a caret-anchored ``core.errors.TraceFormatError``
(the trace is an interchange format: a simulator fed a silently
misparsed trace would produce confidently wrong capacity curves).

The trace is the capacity observatory's interchange unit: the
discrete-event simulator (``serving/simulate.py``) replays it
devicelessly against a fitted cost model (``obs/costmodel.py``), and
``chrome_events()`` renders the admissions on the virtual clock for
Perfetto inspection next to the live tracer export.

Host-only.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Optional

from repro_torch.core.errors import TraceFormatError
from repro_torch.core.obs.trace import sig_digest

#: the header's ``format`` tag — anything else is not ours.
TRACE_FORMAT = "repro.flight-trace"
#: current schema version; ``load_trace`` rejects any other.
TRACE_VERSION = 1

#: required event fields and their accepted types. ``template`` may be
#: null (plan-object submissions have no template name); everything
#: else is mandatory and typed.
EVENT_SCHEMA: dict[str, tuple] = {
    "seq": (int,),
    "tenant": (str,),
    "template": (str, type(None)),
    "bindings": (list,),
    "arrival": (int, float),
    "slo": (int, float),
    "sig": (str,),
}


def _canon(obj) -> str:
    """Canonical JSON: sorted keys, no whitespace — the byte-identity
    contract of the round trip."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _jsonable(v):
    """Binding values as JSON scalars (tuples become lists — the
    simulator never re-binds, so the lossy tuple/list distinction is
    acceptable and documented)."""
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


@dataclasses.dataclass
class FlightTrace:
    """A validated recorded trace: header + event dicts (each already
    schema-checked). ``dumps()`` is canonical JSONL."""

    header: dict
    events: list[dict]

    def dumps(self) -> str:
        lines = [_canon(self.header)]
        lines.extend(_canon(e) for e in self.events)
        return "\n".join(lines) + "\n"

    def dump(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    def template_signatures(self) -> dict[str, str]:
        """template name -> erased-signature digest, from the recorded
        events (templates seen with no name are skipped). This is how
        a synthetic ``make_tenant_traffic`` trace — which knows only
        template names — maps onto the cost model's signature keys."""
        out: dict[str, str] = {}
        for e in self.events:
            if e["template"] is not None:
                out[e["template"]] = e["sig"]
        return out

    def chrome_events(self) -> list[dict]:
        """The admissions as Chrome/Perfetto instant events on the
        virtual clock (validated by ``trace.validate_trace_events``) —
        drop-in next to the live tracer's ``chrome_trace`` export."""
        out: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "repro-flight-trace (virtual clock)"}},
        ]
        for e in self.events:
            out.append({
                "ph": "i", "s": "t", "name": "admit", "cat": "serving",
                "pid": 1, "tid": 3, "ts": round(e["arrival"] * 1e6, 3),
                "args": {"seq": e["seq"], "tenant": e["tenant"],
                         "template": e["template"], "sig": e["sig"],
                         "slo": e["slo"]},
            })
        return out


class FlightRecorder:
    """Bounded ring-buffer recorder for admitted tickets.

    ``capacity`` bounds host memory: once full, recording a new event
    evicts the oldest (counted in ``dropped`` — a trace that silently
    lost its head would skew replayed arrival gaps, so the loss is
    observable). Hook it into the runtime with
    ``service.runtime(recorder=FlightRecorder())``.
    """

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self.capacity = capacity
        self._events: "deque[dict]" = deque(maxlen=capacity)
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def record(self, ticket, *, template: Optional[str] = None) -> dict:
        """Capture one admitted ticket (called by
        ``ServingRuntime.submit`` at admission time — arrival and
        deadline are virtual-clock stamps)."""
        tpl = template if template is not None \
            else getattr(ticket, "template", None)
        event = {
            "seq": ticket.seq,
            "tenant": ticket.tenant,
            "template": tpl,
            "bindings": [_jsonable(v) for v in ticket.values],
            "arrival": ticket.arrival,
            "slo": ticket.deadline - ticket.arrival,
            "sig": sig_digest(ticket.query.signature),
        }
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(event)
        return event

    def events(self) -> list[dict]:
        return list(self._events)

    def trace(self) -> FlightTrace:
        header = {"format": TRACE_FORMAT, "version": TRACE_VERSION,
                  "events": len(self._events), "dropped": self.dropped}
        return FlightTrace(header, self.events())


# -- loading / validation ----------------------------------------------------


def _reject(msg: str, line: str, lineno: int,
            anchor: Optional[str] = None) -> TraceFormatError:
    """A caret-anchored rejection: ``anchor`` positions the caret at
    the offending token within the line (line start otherwise)."""
    pos = line.find(anchor) if anchor else 0
    return TraceFormatError(f"line {lineno}: {msg}",
                            pos=max(pos, 0), text=line)


def validate_event(event: Any, line: str, lineno: int) -> dict:
    """One event object against ``EVENT_SCHEMA`` — returns it, or
    raises ``TraceFormatError`` naming the missing/ill-typed field."""
    if not isinstance(event, dict):
        raise _reject("event is not a JSON object", line, lineno)
    for field, types in EVENT_SCHEMA.items():
        if field not in event:
            raise _reject(f"event missing required field {field!r}",
                          line, lineno)
        v = event[field]
        # bool is an int subclass; a true/false arrival is a bug
        if isinstance(v, bool) and bool not in types:
            raise _reject(f"event field {field!r} has wrong type "
                          f"bool", line, lineno, f'"{field}"')
        if not isinstance(v, types):
            raise _reject(
                f"event field {field!r} has wrong type "
                f"{type(v).__name__}", line, lineno, f'"{field}"')
    return event


def load_trace(text: str) -> FlightTrace:
    """Parse + validate a JSONL flight trace. Round trip is
    byte-identical: ``load_trace(t.dumps()).dumps() == t.dumps()``.
    Raises ``TraceFormatError`` (a caret diagnostic into the offending
    line) on unknown format/version, malformed JSON, or a
    missing/ill-typed event field."""
    lines = text.splitlines()
    if not lines or not lines[0].strip():
        raise TraceFormatError("empty trace: missing header line")
    try:
        header = json.loads(lines[0])
    except ValueError as e:
        raise _reject(f"header is not valid JSON ({e})",
                      lines[0], 1) from None
    if not isinstance(header, dict) \
            or header.get("format") != TRACE_FORMAT:
        raise _reject(
            f"not a {TRACE_FORMAT} trace "
            f"(format={header.get('format')!r} "
            if isinstance(header, dict) else
            "header is not a JSON object", lines[0], 1, '"format"')
    if header.get("version") != TRACE_VERSION:
        raise _reject(
            f"unknown schema version {header.get('version')!r} "
            f"(this reader understands version {TRACE_VERSION})",
            lines[0], 1, '"version"')
    events: list[dict] = []
    for i, line in enumerate(lines[1:], start=2):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError as e:
            raise _reject(f"event is not valid JSON ({e})",
                          line, i) from None
        events.append(validate_event(obj, line, i))
    return FlightTrace(header, events)


def load_trace_file(path) -> FlightTrace:
    with open(path) as f:
        return load_trace(f.read())
