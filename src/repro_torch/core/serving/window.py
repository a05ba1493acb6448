"""Streaming-window grouped serving: mergeable partial group states.

A dashboard-style grouped query over a live stream cannot wait for the
stream to end: each admission window's slice of the data (e.g. one
year, one shard, one ingest batch) is served as an ordinary grouped
query, and its per-group partial aggregates are folded into a running
state. This module is that fold, with two guarantees the property
suite pins (tests/test_properties.py):

1. **Merge-order invariance by construction.** A state is a map
   ``window_id -> partial rows``; ``absorb`` and ``merge`` only ever
   union that map, and ``finalize`` folds the partials in canonical
   (sorted window-id) order. Any interleaving of absorbs and merges —
   batches completing out of order, states combined pairwise in any
   tree shape — therefore produces bit-identical finals.

2. **One-shot equivalence.** Aggregation state per key is the
   (count, sum, min, max) semiring, accumulated in ``np.float32`` —
   the executor's device dtype — so for f32-exact data (integer
   values, the weather corpus) the merged result equals the one-shot
   grouped query over the union of all windows bit for bit.

Only associatively mergeable plans qualify: a single GROUP-BY whose
aggregates are count/sum/min/max, with no HAVING SELECTs and no
post-group ASSIGN wrappers (an ``avg`` — or a threshold applied to a
partial — cannot be merged from per-window finals; ``avg`` callers
stream sum and count instead). ``group_spec_of`` validates this once
at stream-open time and maps result columns to merge functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import algebra as A

MERGEABLE = ("count", "sum", "min", "max")


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Column layout of a mergeable grouped result: ``key_col`` is the
    grouping key's position in each result row; ``agg_fns[i]`` is the
    merge function of every other column, in row order."""
    key_col: int
    agg_fns: tuple[tuple[int, str], ...]    # (column index, fn)

    @property
    def arity(self) -> int:
        return 1 + len(self.agg_fns)


def group_spec_of(plan: A.Op) -> GroupSpec:
    """Validate a plan as windowed-mergeable and derive its column
    spec. Raises ValueError with the reason when the plan's grouped
    output cannot be merged from per-window partials."""
    if not isinstance(plan, A.DistributeResult):
        raise ValueError("windowed streams need a DISTRIBUTE-RESULT "
                         "grouped plan")
    gbs = [op for op in A.walk(plan) if isinstance(op, A.GroupBy)]
    if len(gbs) != 1:
        raise ValueError(f"windowed streams need exactly one GROUP-BY "
                         f"(found {len(gbs)})")
    gb = gbs[0]
    blockers = [type(op).__name__ for op in A.walk(plan)
                if isinstance(op, (A.Select, A.Assign, A.OrderBy,
                                   A.Limit))
                and _is_above(plan, op, gb)]
    if blockers:
        raise ValueError(
            f"post-group operator(s) {sorted(set(blockers))} break "
            "associative merging: HAVING thresholds, post-group "
            "arithmetic and ordering apply to finals, not partials — "
            "stream the raw aggregates and apply them after finalize")
    fns = {v: fn for v, fn, _ in gb.aggs}
    key_col: Optional[int] = None
    agg_fns: list[tuple[int, str]] = []
    for i, v in enumerate(plan.vars):
        if v == gb.key_var:
            if key_col is not None:
                raise ValueError("grouping key returned twice")
            key_col = i
        elif v in fns:
            if fns[v] not in MERGEABLE:
                raise ValueError(
                    f"aggregate {fns[v]!r} is not associatively "
                    f"mergeable (stream sum and count instead of avg)")
            agg_fns.append((i, fns[v]))
        else:
            raise ValueError(f"result var {v} is neither the grouping "
                             f"key nor a GROUP-BY aggregate")
    if key_col is None:
        raise ValueError("grouped stream result must include the "
                         "grouping key")
    return GroupSpec(key_col, tuple(agg_fns))


def _is_above(root: A.Op, op: A.Op, gb: A.GroupBy) -> bool:
    """True when ``op`` sits on the path from ``root`` down to the
    GROUP-BY (i.e. applies to grouped output, not the input stream)."""
    if root is gb:
        return False
    if root is op:
        return any(o is gb for o in A.walk(root))
    return any(_is_above(c, op, gb) for c in A.children(root))


class WindowedGroupState:
    """The running state of one grouped stream.

    ``absorb(window_id, rows)`` files one window's partial grouped
    result (each row shaped by the ``GroupSpec``); ``merge(other)``
    unions two states (disjoint window ids — each window's partial is
    computed once); ``finalize()`` folds all partials in sorted
    window-id order into final (key, aggregates...) rows sorted by
    key string. Both operations are pure map unions, so the final is
    invariant to absorb/merge interleaving by construction.
    """

    def __init__(self, spec: GroupSpec):
        self.spec = spec
        self._windows: dict[int, list[tuple]] = {}

    def __len__(self) -> int:
        return len(self._windows)

    def absorb(self, window_id: int, rows: Sequence[tuple]) -> None:
        if window_id in self._windows:
            raise ValueError(f"window {window_id} already absorbed "
                             "(each window's partial merges once)")
        for r in rows:
            if len(r) != self.spec.arity:
                raise ValueError(f"row arity {len(r)} != spec arity "
                                 f"{self.spec.arity}")
        self._windows[window_id] = [tuple(r) for r in rows]
        from repro_torch.core.obs import trace as obs_trace
        obs_trace.current().event("stream-absorb", cat="serving",
                                  window=window_id, rows=len(rows))

    def merge(self, other: "WindowedGroupState") -> "WindowedGroupState":
        if other.spec != self.spec:
            raise ValueError("cannot merge streams of different specs")
        dup = self._windows.keys() & other._windows.keys()
        if dup:
            raise ValueError(f"windows absorbed on both sides: "
                             f"{sorted(dup)}")
        out = WindowedGroupState(self.spec)
        out._windows = {**self._windows, **other._windows}
        return out

    def finalize(self) -> list[tuple]:
        """Final grouped rows over every absorbed window, in the
        result-row layout of the spec, sorted by key string. The fold
        runs in sorted window-id order with np.float32 accumulation —
        the canonical order that makes any merge history bit-identical
        (and, for f32-exact data, equal to the one-shot grouped query
        over the union of the windows)."""
        acc: dict[str, list] = {}
        for wid in sorted(self._windows):
            for row in self._windows[wid]:
                key = row[self.spec.key_col]
                cur = acc.get(key)
                if cur is None:
                    acc[key] = [np.float32(row[i])
                                for i, _ in self.spec.agg_fns]
                    continue
                for j, (i, fn) in enumerate(self.spec.agg_fns):
                    v = np.float32(row[i])
                    if fn in ("count", "sum"):
                        cur[j] = np.float32(cur[j] + v)
                    elif fn == "min":
                        cur[j] = min(cur[j], v)
                    else:
                        cur[j] = max(cur[j], v)
        out = []
        for key in sorted(acc):
            row: list = [None] * self.spec.arity
            row[self.spec.key_col] = key
            for j, (i, _) in enumerate(self.spec.agg_fns):
                row[i] = float(acc[key][j])
            out.append(tuple(row))
        return out
