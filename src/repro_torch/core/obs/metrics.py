"""Metrics registry: named counters/gauges/histograms with labels,
Prometheus-style text exposition, and a JSONL event sink.

The stats dataclasses the repo already exposes (``ServiceStats``,
``RuntimeStats``) stay the compatible facade — tests and benchmarks
keep reading plain attributes — and the registry *binds* them
(``register_stats``): exposition reads the live fields through the
``REGISTERED_STATS`` table below, so every counter the service
increments is exported without a second increment site on the warm
path. ``REGISTERED_STATS`` is deliberately a module-level literal:
``analysis/lint.py`` (OBS001/OBS002) parses it without importing and
cross-checks that every ``self.stats.<field> += ...`` site in core/
maps to a registered metric, and that no registered name is stale.
``register_stats`` enforces the same completeness at runtime.

Histograms use fixed bucket bounds, so merging two histograms is a
per-bucket count add — commutative and associative, hence
merge-order-invariant (property-tested). Percentiles are
nearest-rank over the bucket upper edges.

Host-only.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from collections import OrderedDict
from typing import Any, Optional

# Stats-dataclass field -> exported metric. Plain int fields map to a
# counter name; dict-valued fields map to ``(name, label_key)`` — one
# labeled sample per dict entry. Names follow Prometheus conventions
# (``_total`` for counters); ``register_stats`` prefixes them with the
# binding prefix (``service_`` / ``runtime_``) so same-named fields of
# different stats objects stay distinct.
REGISTERED_STATS = {
    # ServiceStats (core/service.py)
    "executions": "executions_total",
    "runs": "runs_total",
    "retries": "retries_total",
    "cache_hits": "cache_hits_total",
    "cache_misses": "cache_misses_total",
    "compiles": "compiles_total",
    "evictions": "evictions_total",
    "exact_hits": "exact_hits_total",
    "exact_misses": "exact_misses_total",
    "batches": "batches_total",
    "batched_requests": "batched_requests_total",
    "overflows_by_cap": ("overflows_total", "cap"),
    # persistent compiled-plan cache (core/persist.py via service.py)
    "persist_hits": "persist_hits_total",
    "persist_misses": "persist_misses_total",
    "persist_invalidations": "persist_invalidations_total",
    "persist_stores": "persist_stores_total",
    # per-cache eviction attribution: every LRU-bounded map in the
    # service (plans, profile plans, bindings, good configs, signature
    # histories, row costs, persisted files) counts its own evictions
    # — "evictions" above stays the level-1 total for compatibility
    "evictions_by_cache": ("cache_evictions_total", "cache"),
    # RuntimeStats (core/serving/scheduler.py)
    "submitted": "submitted_total",
    "dispatched": "dispatched_total",
    "scalar_dispatches": "scalar_dispatches_total",
    "padded_slots": "padded_slots_total",
    "padded_rows": "padded_rows_total",
    "real_rows": "real_rows_total",
    "steps": "steps_total",
    "slo_misses": "slo_misses_total",
    "slo_misses_by_tenant": ("slo_misses_tenant_total", "tenant"),
    "slo_miss_causes": ("slo_misses_cause_total", "cause"),
    # gauges — names without the ``_total`` suffix export with TYPE
    # gauge (instantaneous occupancy, sampled each scheduler sweep)
    "queue_depth": "queue_depth",
    "sched_backlog": "sched_backlog",
}


def stats_snapshot(obj):
    """Copy of a stats dataclass (dict fields deep-copied one level)
    — the ``since`` argument for ``stats_diff``."""
    kw = {f.name: (dict(v) if isinstance(v := getattr(obj, f.name),
                                         dict) else v)
          for f in dataclasses.fields(obj)}
    return type(obj)(**kw)


def stats_diff(obj, since):
    """Per-field ``obj - since``; dict fields subtract per-key over
    the union of keys."""
    assert type(obj) is type(since), (type(obj), type(since))
    kw = {}
    for f in dataclasses.fields(obj):
        a, b = getattr(obj, f.name), getattr(since, f.name)
        if isinstance(a, dict):
            kw[f.name] = {k: a.get(k, 0) - b.get(k, 0)
                          for k in sorted(set(a) | set(b))}
        else:
            kw[f.name] = a - b
    return type(obj)(**kw)


class _Labeled:
    """Shared child-metric machinery: ``labels(k=v)`` returns a child
    keyed by the sorted label items."""

    def __init__(self):
        self._children: "OrderedDict[tuple, Any]" = OrderedDict()

    def labels(self, **kv):
        key = tuple(sorted(kv.items()))
        child = self._children.get(key)
        if child is None:
            child = self._child()
            self._children[key] = child
        return child


class Counter(_Labeled):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__()
        self.name = name
        self.help = help
        self.value = 0

    def _child(self) -> "Counter":
        return Counter(self.name)

    def inc(self, n=1) -> None:
        assert n >= 0, "counters only go up"
        self.value += n

    def samples(self):
        if self.value or not self._children:
            yield {}, self.value
        for key, child in self._children.items():
            yield dict(key), child.value


class Gauge(_Labeled):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", fn=None):
        super().__init__()
        self.name = name
        self.help = help
        self.fn = fn                 # callable -> value (lazy gauge)
        self.value = 0.0

    def _child(self) -> "Gauge":
        return Gauge(self.name)

    def set(self, v) -> None:
        self.value = v

    def samples(self):
        if self.fn is not None:
            yield {}, self.fn()
        elif self.value or not self._children:
            yield {}, self.value
        for key, child in self._children.items():
            yield dict(key), (child.fn() if child.fn is not None
                              else child.value)


#: default bounds suit virtual-clock latencies (admission windows are
#: O(1) virtual seconds) and warm wall latencies alike.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.0, 4.0, 8.0, 16.0, 64.0, math.inf)


class Histogram(_Labeled):
    """Fixed-bucket histogram. ``merge`` adds per-bucket counts —
    commutative/associative by construction, so fan-in order can never
    change the merged distribution. ``percentile`` is nearest-rank on
    the bucket upper edges (the +inf bucket reports the largest finite
    edge)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__()
        assert buckets and buckets[-1] == math.inf, \
            "bucket bounds must end with +inf"
        assert tuple(sorted(buckets)) == tuple(buckets), buckets
        self.name = name
        self.help = help
        self.bounds = tuple(buckets)
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0

    def _child(self) -> "Histogram":
        return Histogram(self.name, buckets=self.bounds)

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def merge(self, other: "Histogram") -> "Histogram":
        assert self.bounds == other.bounds, "bucket layouts differ"
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        return self

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile resolved to a bucket upper edge
        (0.0 on an empty histogram)."""
        assert 0.0 < p <= 1.0, p
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(p * self.count))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                edge = self.bounds[i]
                if edge == math.inf:
                    return max(b for b in self.bounds[:-1])
                return edge
        return max(b for b in self.bounds[:-1])

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(0.50),
                "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Names -> metric objects, plus live bindings onto the repo's
    stats dataclasses. ``exposition()`` renders everything in
    Prometheus text format; ``to_dict()`` gives the same content as
    plain data for JSON records."""

    def __init__(self):
        self._metrics: "OrderedDict[str, Any]" = OrderedDict()
        self._bindings: "OrderedDict[str, Any]" = OrderedDict()

    # -- construction ------------------------------------------------------

    def _named(self, cls, name, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        else:
            assert isinstance(m, cls), \
                f"{name} already registered as {m.kind}"
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._named(Counter, name, help=help)

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        return self._named(Gauge, name, help=help, fn=fn)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._named(Histogram, name, help=help, buckets=buckets)

    def register_stats(self, prefix: str, obj) -> None:
        """Bind a stats dataclass for live exposition under
        ``<prefix>_<metric>``. Every field must appear in
        ``REGISTERED_STATS`` — adding a counter field without
        registering its metric fails here (and at lint time, OBS001).
        Re-binding a prefix replaces the previous object (a service
        may build several runtimes; the live one wins)."""
        for f in dataclasses.fields(obj):
            assert f.name in REGISTERED_STATS, \
                (f"stats field {type(obj).__name__}.{f.name} has no "
                 f"entry in obs.metrics.REGISTERED_STATS")
        self._bindings[prefix] = obj

    # -- exposition --------------------------------------------------------

    def _bound_samples(self):
        """(name, labels, value) triples read live from the bound
        stats objects."""
        for prefix, obj in self._bindings.items():
            for f in dataclasses.fields(obj):
                spec = REGISTERED_STATS[f.name]
                value = getattr(obj, f.name)
                if isinstance(spec, tuple):
                    name, label = spec
                    for k in sorted(value):
                        yield (f"{prefix}_{name}", {label: str(k)},
                               value[k])
                else:
                    yield f"{prefix}_{spec}", {}, value

    @staticmethod
    def _render_labels(labels: dict) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{v}"'
                         for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    @staticmethod
    def _render_value(v) -> str:
        if v == math.inf:
            return "+Inf"
        f = float(v)
        return str(int(f)) if f.is_integer() else repr(f)

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list[str] = []

        def header(name, kind, help_=""):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")

        for name, labels, value in self._bound_samples():
            # naming convention carries the type: counters end
            # ``_total``; everything else bound from stats fields is
            # an instantaneous gauge
            header(name, "counter" if name.endswith("_total")
                   else "gauge")
            lines.append(f"{name}{self._render_labels(labels)} "
                         f"{self._render_value(value)}")
        for name, m in self._metrics.items():
            header(name, m.kind, m.help)
            if m.kind == "histogram":
                groups = [({}, m)] + [(dict(k), c)
                                      for k, c in m._children.items()]
                for labels, h in groups:
                    if not h.count and len(groups) > 1 and not labels:
                        continue
                    acc = 0
                    for bound, c in zip(h.bounds, h.counts):
                        acc += c
                        lab = dict(labels)
                        lab["le"] = self._render_value(bound)
                        lines.append(
                            f"{name}_bucket"
                            f"{self._render_labels(lab)} {acc}")
                    lines.append(f"{name}_sum"
                                 f"{self._render_labels(labels)} "
                                 f"{self._render_value(h.sum)}")
                    lines.append(f"{name}_count"
                                 f"{self._render_labels(labels)} "
                                 f"{h.count}")
            else:
                for labels, value in m.samples():
                    lines.append(f"{name}"
                                 f"{self._render_labels(labels)} "
                                 f"{self._render_value(value)}")
        return "\n".join(lines) + "\n"

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for name, labels, value in self._bound_samples():
            key = name + self._render_labels(labels)
            out[key] = value
        for name, m in self._metrics.items():
            if m.kind == "histogram":
                groups = [({}, m)] + [(dict(k), c)
                                      for k, c in m._children.items()]
                for labels, h in groups:
                    if not h.count and len(groups) > 1 and not labels:
                        continue
                    out[name + self._render_labels(labels)] = \
                        h.summary()
            else:
                for labels, value in m.samples():
                    out[name + self._render_labels(labels)] = value
        return out


class EventSink:
    """Append-only JSONL event sink (structured log records; the
    benchmark writes one per suite gate, the runtime can mirror trace
    instants)."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: str, **fields) -> None:
        self.events.append({"event": event, **fields})

    def jsonl(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True, default=str)
                         for e in self.events) + ("\n" if self.events
                                                  else "")

    def write(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.jsonl())
