"""Prepared queries: parameterized plans for cross-query plan sharing.

The paper's VXQuery pays trace + compile per submitted Hyracks job; our
serving tier (service.py) caches compiled plans, but an exact-signature
cache still compiles ``station eq "GHCND:USW00012836"`` and
``station eq "GHCND:USW00014771"`` separately although their plans are
shape-identical. This module makes constants *incidental to plan
shape* (the lesson of Grust et al.'s join-graph isolation: lift the
query to a plan where literals are leaves you can swap):

1. ``lift_params(plan)`` walks an optimized plan and replaces every
   comparison/arithmetic literal with a typed ``algebra.Param`` leaf,
   returning the parameter-erased plan, the parameter type vector, and
   the literal values it lifted (the query's *default binding*).
2. The erased plan's ``repr`` is the **parameter-erased signature**:
   all constant-variants of a template map to one cache key, so a
   variant never seen before can still be a compile-free cache hit.
3. ``bind_params`` converts host literal values into the device scalar
   representation each Param type needs (string -> dictionary sid,
   number -> f32, date string -> packed yyyymmdd i32) as 0-d tensors
   on the executor's device; the compiled plan reads them as runtime
   inputs, so no recompilation occurs when only the binding changes.
4. ``stack_params`` stacks many bindings of one erased signature into
   [B]-leading parameter arrays for the batch-admission frontend (one
   device dispatch serves B concurrent requests).

Only *value* literals are lifted. Structural constants — element names
under ``child``/``treat``, collection paths, type annotations — select
columns and tables at trace time and must stay baked: lifting them
would change which plan gets compiled, not which scalars flow in.

Group-by templates lift like every other query class: literals inside
GROUP-BY key/aggregate expressions, HAVING-style post-filters (the
SELECTs the translator places above GROUP-BY — e.g. an aggregate
threshold ``sum($r/value) ge 100``) and post-group arithmetic
(``avg(..) div 10`` ASSIGNs) all reach the same comparison/arithmetic
walk, so constant-variants of a keyed-aggregation template share one
compiled executable and batch through ``execute_batch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import algebra as A
from repro_torch.core import xdm
from repro_torch.core.errors import InvalidArgumentError
from repro_torch.core.obs import trace as obs_trace

# Literals appearing directly under these calls are runtime values, not
# plan structure: comparisons and arithmetic.
LIFTABLE_FNS = frozenset((
    "value-eq", "value-ne", "value-lt", "value-le", "value-gt",
    "value-ge", "algebricks-eq",
    "add", "subtract", "multiply", "divide",
))


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Type of one lifted parameter slot.

    typ: "str" (dictionary sid, i32), "num" (f32), "date" (packed
    yyyymmdd, i32).
    """
    typ: str


@dataclasses.dataclass(frozen=True)
class PreparedQuery:
    """A compile-shareable query: erased plan + parameter layout.

    ``defaults`` is the binding extracted from the source query's own
    literals, so ``execute(prepared)`` with no bindings reproduces the
    original query exactly (None when prepared from an already-erased
    plan, whose literals are unrecoverable — execution then requires
    explicit bindings). ``signature`` is the parameter-erased
    structural signature — the plan-cache sharing key.
    """
    plan: A.Op
    specs: tuple[ParamSpec, ...]
    defaults: Optional[tuple[Any, ...]]
    signature: str
    text: Optional[str] = None

    @property
    def num_params(self) -> int:
        return len(self.specs)


# ---------------------------------------------------------------------------
# Lifting pass
# ---------------------------------------------------------------------------


class _Lifter:
    """Single deterministic pre-order walk: same template -> same slot
    order, so constant-variants agree on parameter indices."""

    def __init__(self) -> None:
        self.specs: list[ParamSpec] = []
        self.values: list[Any] = []

    def _param(self, typ: str, value: Any) -> A.Param:
        idx = len(self.specs)
        self.specs.append(ParamSpec(typ))
        self.values.append(value)
        return A.Param(idx, typ)

    def _lift_arg(self, e: A.Expr) -> A.Expr:
        """An argument of a liftable call: literal -> Param."""
        if isinstance(e, A.Const):
            if e.typ in ("double", "integer"):
                return self._param("num", float(e.value))
            if e.typ == "string":
                return self._param("str", str(e.value))
        # dateTime("1976-07-04T...") is a date literal in call clothing
        if (isinstance(e, A.Call) and e.fn == "dateTime"
                and len(e.args) == 1 and isinstance(e.args[0], A.Const)):
            return self._param("date", str(e.args[0].value))
        return self.expr(e)

    def expr(self, e: A.Expr) -> A.Expr:
        if isinstance(e, A.Call):
            lift = self._lift_arg if e.fn in LIFTABLE_FNS else self.expr
            return A.Call(e.fn, tuple(lift(a) for a in e.args))
        if isinstance(e, A.Some):
            return A.Some(e.var, self.expr(e.source), self.expr(e.cond))
        return e

    def op(self, op: A.Op) -> A.Op:
        if isinstance(op, (A.EmptyTupleSource, A.NestedTupleSource)):
            return op
        if isinstance(op, (A.Assign, A.Unnest, A.Aggregate)):
            return op.replace(expr=self.expr(op.expr),
                              child=self.op(op.child))
        if isinstance(op, A.Select):
            return op.replace(expr=self.expr(op.expr),
                              child=self.op(op.child))
        if isinstance(op, A.Subplan):
            return op.replace(plan=self.op(op.plan),
                              child=self.op(op.child))
        if isinstance(op, A.Join):
            cond = self.expr(op.cond)
            keys = tuple((self.expr(l), self.expr(r))
                         for l, r in op.hash_keys)
            return op.replace(cond=cond, hash_keys=keys,
                              left=self.op(op.left),
                              right=self.op(op.right))
        if isinstance(op, A.GroupBy):
            aggs = tuple((v, fn, self.expr(e)) for v, fn, e in op.aggs)
            return op.replace(key_expr=self.expr(op.key_expr),
                              aggs=aggs, child=self.op(op.child))
        if isinstance(op, A.OrderBy):
            keys = tuple((self.expr(e), d) for e, d in op.keys)
            return op.replace(keys=keys, child=self.op(op.child))
        if isinstance(op, (A.DataScan, A.DistributeResult, A.Limit)):
            # Limit.k is structural (it fixes compiled output shapes)
            # and stays baked, like element names and collection paths
            return op.replace(child=self.op(op.child))
        raise TypeError(op)


def lift_params(plan: A.Op
                ) -> tuple[A.Op, tuple[ParamSpec, ...], tuple[Any, ...]]:
    """Optimized plan -> (erased plan, parameter specs, default
    binding). The erased plan evaluates identically to the input when
    executed with the default binding."""
    lf = _Lifter()
    erased = lf.op(plan)
    return erased, tuple(lf.specs), tuple(lf.values)


def prepare_plan(plan: A.Op, text: Optional[str] = None) -> PreparedQuery:
    """Optimized plan -> PreparedQuery. Idempotent on already-erased
    plans (e.g. a PreparedQuery's own ``.plan``): their Param layout is
    recovered as-is instead of re-lifting, and ``defaults`` is None
    because the original literals are gone.  Either way, every lifted
    ``Param``'s declared type is verified against its use sites via
    schema inference — an externally built erased plan cannot smuggle
    a sid parameter into an f32 comparison."""
    with obs_trace.current().span("lift", cat="prepare") as span:
        existing = collect_params(plan)
        if existing:
            pq = PreparedQuery(plan, existing, None, repr(plan), text)
        else:
            erased, specs, defaults = lift_params(plan)
            pq = PreparedQuery(erased, specs, defaults, repr(erased),
                               text)
        span.set(params=len(pq.specs))
        from repro_torch.core.analysis.schema import check_param_uses
        from repro_torch.core.errors import QueryError
        try:
            check_param_uses(pq.plan)
        except QueryError as e:
            raise e.with_text(text)
    return pq


def collect_params(plan: A.Op) -> tuple[ParamSpec, ...]:
    """Parameter layout of an already-erased plan: one spec per Param
    leaf, indexed by ``Param.idx``. Empty for ordinary plans."""
    found: dict[int, str] = {}

    def visit(e: A.Expr) -> None:
        if isinstance(e, A.Param):
            found[e.idx] = e.typ
        elif isinstance(e, A.Call):
            for a in e.args:
                visit(a)
        elif isinstance(e, A.Some):
            visit(e.source)
            visit(e.cond)

    for op in A.walk(plan):
        for e in A.used_exprs(op):
            visit(e)
        if isinstance(op, A.Join):
            for l, r in op.hash_keys:
                visit(l)
                visit(r)
    if not found:
        return ()
    n = max(found) + 1
    if sorted(found) != list(range(n)):
        raise ValueError(f"plan parameter indices not contiguous: "
                         f"{sorted(found)}")
    return tuple(ParamSpec(found[i]) for i in range(n))


# ---------------------------------------------------------------------------
# Binding: host values -> device scalar representation
# ---------------------------------------------------------------------------


def _bind_one(db: xdm.Database, spec: ParamSpec, value: Any):
    if spec.typ == "num":
        return np.float32(value)
    if spec.typ == "str":
        # absent string -> sid that matches nothing (StringDict.lookup
        # contract), so an unknown constant yields an empty result, not
        # an error — same as the baked-constant path
        return np.int32(db.strings.lookup(str(value)))
    if spec.typ == "date":
        if isinstance(value, str):
            m = xdm._DATE_RE.match(value)
            if not m:
                raise ValueError(f"unparseable date binding {value!r}")
            return np.int32(xdm.pack_date(int(m.group(1)),
                                          int(m.group(2)),
                                          int(m.group(3))))
        return np.int32(value)   # already packed
    raise TypeError(spec.typ)


def bind_params(db: xdm.Database, specs: Sequence[ParamSpec],
                values: Sequence[Any], device="cpu") -> tuple:
    """One request's binding: tuple of 0-d tensors on ``device``, one
    per spec — float32 numbers, int32 string ids and packed dates."""
    if len(values) != len(specs):
        raise ValueError(f"binding has {len(values)} values for "
                         f"{len(specs)} parameters")
    return tuple(torch.tensor(_bind_one(db, s, v), device=device)
                 for s, v in zip(specs, values))


def stack_params(bindings: Sequence[tuple], pad_to: int) -> tuple:
    """Stack B bound parameter tuples into [pad_to]-leading tensors for
    one batched dispatch; the pad rows repeat the last binding (their
    results are discarded, never returned). Typed validation, not
    ``assert`` — these are user-facing batch widths and must diagnose
    under ``python -O`` too."""
    if not bindings:
        raise InvalidArgumentError(
            "stack_params needs at least one binding")
    if pad_to < len(bindings):
        raise InvalidArgumentError(
            f"pad_to={pad_to} is smaller than the batch "
            f"({len(bindings)} bindings) — the padded width must "
            f"cover every request")
    padded = list(bindings) + [bindings[-1]] * (pad_to - len(bindings))
    return tuple(torch.stack([b[i] for b in padded])
                 for i in range(len(bindings[0])))
