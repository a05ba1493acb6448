"""Capacity-flow analysis: which ExecConfig caps can a plan overflow.

A host-only dataflow pass over the algebra plan that derives, per
plan, the exact set of capacity-bounded stages it contains — each one
an (ExecConfig knob, overflow flag, operator path) *site* — together
with a static per-partition cardinality upper bound from
``CollectionStats`` where statistics resolve.

Three consumers:

* ``check.verify_plan`` asserts every site agrees with the executor's
  ``OVERFLOW_FLAGS`` registry (a capacity-bounded operator whose flag
  the executor does not thread would silently lose its regrowth rung);
* the rewrite-soundness checker asserts capacity-set *monotonicity*
  (a rule may introduce capacity-bounded stages, never drop one while
  keeping the operator that needed it);
* ``cross_validate`` compares the static bounds against a presized
  ``ExecConfig`` — a presized cap smaller than the static bound means
  a first-shot overflow the statistics should have prevented — and
  the max scan bound feeds the serving cost model
  (``QueryService.row_cost``).

Host-only: the pass runs on plain plans + build-time statistics; the
executor registry is imported lazily where compared.

The kernel-route knobs (``use_kernel_join`` / ``use_kernel_segments``)
are invisible to this pass by design: they select an implementation
(CUDA kernel vs plain PyTorch version) for a capacity-bounded stage, never the
stage's capacity semantics — both paths read the same resolved caps
and raise the same overflow flags, so a plan's capacity-site set is
kernel-policy-independent (pinned by the analysis-suite cross-check).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import algebra as A
from repro_torch.core.errors import CapFlowError
from repro_torch.core.analysis.schema import op_label

#: the (cap -> flag) pairs this analysis can derive, one per
#: capacity-bounded operator class: DATASCAN / child-chain UNNEST
#: (scan_cap), JOIN (join_bucket + join_cap), GROUP-BY (group_cap),
#: ORDER-BY (topk_cap).  ``verify`` asserts this literally equals
#: executor.OVERFLOW_FLAGS — an ExecConfig knob with no analyzable
#: operator (or an operator with no knob) is an orphan either way.
_EMITTED = {
    "scan_cap": "overflow_scan",
    "join_bucket": "overflow_join",
    "join_cap": "overflow_join_cap",
    "group_cap": "overflow_group_cap",
    "topk_cap": "overflow_topk_cap",
}


@dataclasses.dataclass(frozen=True)
class CapSite:
    """One capacity-bounded stage of a plan."""
    cap: str                      # ExecConfig field that bounds it
    flag: str                     # executor overflow flag it raises
    op: str                       # operator label
    path: tuple[str, ...]         # root -> operator chain
    bound: Optional[int] = None   # static row bound (pre-round_cap);
    #                               None when statistics don't resolve


@dataclasses.dataclass(frozen=True)
class CapFlow:
    sites: tuple[CapSite, ...]

    @property
    def caps(self) -> frozenset:
        return frozenset(s.cap for s in self.sites)

    @property
    def flags(self) -> frozenset:
        return frozenset(s.flag for s in self.sites)

    def bound_for(self, cap: str) -> Optional[int]:
        """Max static bound across this cap's sites; None if any site
        is unresolved (an unknown site can need more than the known
        ones)."""
        bounds = [s.bound for s in self.sites if s.cap == cap]
        if not bounds or any(b is None for b in bounds):
            return None
        return max(bounds)


def registry_coverage() -> dict[str, str]:
    return dict(_EMITTED)


class _Flow:
    def __init__(self, db=None) -> None:
        self.db = db
        self.sites: list[CapSite] = []
        self._path: list[str] = []

    def _site(self, cap: str, op: A.Op,
              bound: Optional[int]) -> None:
        self.sites.append(CapSite(cap, _EMITTED[cap], op_label(op),
                                  tuple(self._path), bound))

    # -- statistics helpers ---------------------------------------------

    def _scan_bound(self, op: A.DataScan) -> Optional[int]:
        if self.db is None:
            return None
        stats = getattr(self.db, "stats", {}).get(op.collection)
        if stats is None:
            return None
        return stats.path_match_bound(self.db.names, tuple(op.path))

    def _unnest_chain_bound(self, names: list[str]) -> Optional[int]:
        """Final-tag count maxed over collections (the op alone does
        not name its source collection) — the raw form of
        ``QueryService._unnest_bound``."""
        if self.db is None or not names:
            return None
        stats = getattr(self.db, "stats", {})
        bounds = [s.path_match_bound(self.db.names, (names[-1],))
                  for s in stats.values()]
        known = [b for b in bounds if b is not None]
        return max(known) if known else None

    def _group_bound(self, key_expr: A.Expr,
                     assigns: dict[int, A.Expr]) -> Optional[int]:
        """Distinct-value bound for a GROUP-BY key resolved through
        ASSIGN chains to its child-chain's final tag — the raw form of
        ``QueryService._group_bound``."""
        if self.db is None:
            return None
        from repro_torch.core.rewrite.parallel_rules import _child_chain
        e = key_expr
        seen: set[int] = set()
        while (isinstance(e, A.Var) and e.n in assigns
               and e.n not in seen):
            seen.add(e.n)
            e = assigns[e.n]
        got = _child_chain(e) if isinstance(e, A.Call) else None
        if got is None or not got[1]:
            return None
        tag = got[1][-1]
        stats = getattr(self.db, "stats", {})
        if not stats:
            return None
        return max(s.group_key_bound(self.db.names, tag)
                   for s in stats.values())

    # -- the pass --------------------------------------------------------

    def flow(self, op: A.Op, assigns: dict[int, A.Expr],
             limit: Optional[int] = None) -> Optional[int]:
        """Returns the static per-partition output-cardinality bound
        of ``op`` (None unknown), appending capacity sites on the
        way.  ``limit`` is the enclosing LIMIT's k when ``op`` is the
        ORDER-BY directly under it."""
        self._path.append(op_label(op))
        try:
            return self._visit(op, assigns, limit)
        finally:
            self._path.pop()

    def _visit(self, op: A.Op, assigns, limit) -> Optional[int]:
        if isinstance(op, (A.EmptyTupleSource, A.NestedTupleSource)):
            return 1
        if isinstance(op, A.DataScan):
            self.flow(op.child, assigns)
            bound = self._scan_bound(op)
            self._site("scan_cap", op, bound)
            return bound
        if isinstance(op, A.Assign):
            return self.flow(op.child, assigns)
        if isinstance(op, A.Select):
            return self.flow(op.child, assigns)   # filter: upper bound
        if isinstance(op, A.Unnest):
            card = self.flow(op.child, assigns)
            e = op.expr
            if isinstance(e, A.Call) and e.fn == "iterate":
                return card                       # alias, no capacity
            from repro_torch.core.rewrite.parallel_rules import _child_chain
            got = _child_chain(e) if isinstance(e, A.Call) else None
            bound = (self._unnest_chain_bound(got[1])
                     if got is not None else None)
            self._site("scan_cap", op, bound)
            return bound
        if isinstance(op, A.Subplan):
            self.flow(op.child, assigns)
            self.flow(op.plan, assigns)
            return 1          # scalar aggregate: one (central) row
        if isinstance(op, A.Aggregate):
            self.flow(op.child, assigns)
            return 1
        if isinstance(op, A.Join):
            self.flow(op.left, assigns)
            probe = self.flow(op.right, assigns)
            # probe width bounds the bucketed match and the compacted
            # output (M:1 equi-join: at most one build row per probe
            # row; under grace repartition skew can concentrate
            # matches, which presizing covers with the partition
            # multiplier — the bound here is the broadcast-strategy
            # one)
            self._site("join_bucket", op, None)
            self._site("join_cap", op, probe)
            return probe
        if isinstance(op, A.GroupBy):
            self.flow(op.child, assigns)
            bound = self._group_bound(op.key_expr, assigns)
            self._site("group_cap", op, bound)
            return bound
        if isinstance(op, A.OrderBy):
            card = self.flow(op.child, assigns)
            known = [b for b in (card, limit) if b is not None]
            self._site("topk_cap", op, min(known) if known else None)
            return min(known) if known else None
        if isinstance(op, A.Limit):
            card = self.flow(op.child, assigns,
                             limit=(op.k if isinstance(op.child,
                                                       A.OrderBy)
                                    else None))
            if card is None:
                return op.k
            return min(card, op.k)
        if isinstance(op, A.DistributeResult):
            return self.flow(op.child, assigns)
        raise CapFlowError(f"unknown operator {type(op).__name__}",
                           path=tuple(self._path))


def analyze(plan: A.Op, db=None) -> CapFlow:
    """Derive the plan's capacity sites (+ static bounds when ``db``
    statistics resolve)."""
    f = _Flow(db=db)
    assigns = {op.var: op.expr for op in A.walk(plan)
               if isinstance(op, A.Assign)}
    f.flow(plan, assigns)
    return CapFlow(tuple(f.sites))


def check_registry(flow: CapFlow) -> None:
    """Every site's (cap, flag) pair must match the executor-side
    overflow-flag registry — the completeness half is checked by
    ``verify`` (registry_coverage == executor.OVERFLOW_FLAGS) and the
    cap-registry lint."""
    from repro_torch.core.executor import OVERFLOW_FLAGS
    for s in flow.sites:
        if OVERFLOW_FLAGS.get(s.cap) != s.flag:
            raise CapFlowError(
                f"capacity site {s.cap} at {s.op} expects flag "
                f"{s.flag!r} but the executor registry says "
                f"{OVERFLOW_FLAGS.get(s.cap)!r}", path=s.path)


def cross_validate(plan: A.Op, db, cfg) -> list[str]:
    """Compare static bounds against a presized ExecConfig: returns a
    list of problems (empty = every presized cap covers the static
    bound, i.e. statistics presizing agrees with — or is tightened
    by — the dataflow bounds)."""
    problems: list[str] = []
    flow = analyze(plan, db=db)
    for s in flow.sites:
        if s.bound is None or s.cap == "join_bucket":
            continue
        cap_val = getattr(cfg, s.cap, None)
        if isinstance(cap_val, int) and cap_val < s.bound:
            problems.append(
                f"{s.cap}={cap_val} at {s.op} is below the static "
                f"bound {s.bound} (first-shot overflow)")
    return problems
