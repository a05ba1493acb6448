"""Algebricks-style logical algebra for the XQuery compiler (paper §3.2).

Operators are immutable dataclasses forming a chain (``child``), with
SUBPLAN holding a nested plan rooted at NESTED-TUPLE-SOURCE and JOIN
holding two branches. Expressions are Const/Var/Call trees; ``Call.fn``
names are the paper's expression vocabulary (child, iterate,
create_sequence, sort-distinct-nodes-asc-or-atomics, value-eq, ...).

Each expression function is registered with its *kind* (scalar /
aggregate / unnesting) and the properties the rewrite engine tracks:
document-order/duplicate-freedom propagation (rule 4.1.1) and
cardinality (singleton inlining). This is the Algebricks "expression
metadata" the paper's rules key on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    pass


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    value: Any
    typ: str = "string"     # string | double | integer | boolean

    def __str__(self) -> str:
        if self.typ == "string":
            return f'"{self.value}"'
        return str(self.value)


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    n: int

    def __str__(self) -> str:
        return f"$${self.n}"


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """Runtime query parameter: a lifted literal (prepared.py).

    ``idx`` indexes the prepared query's parameter vector; ``typ`` is
    the runtime representation ("str" = dictionary sid, "num" = float,
    "date" = packed yyyymmdd int). Two plans that differ only in lifted
    constants are structurally equal after lifting — the basis of the
    parameter-erased plan-cache signature.
    """
    idx: int
    typ: str            # str | num | date

    def __str__(self) -> str:
        return f"?{self.idx}:{self.typ}"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    fn: str
    args: tuple[Expr, ...]

    def __str__(self) -> str:
        return f"{self.fn}({', '.join(map(str, self.args))})"


@dataclasses.dataclass(frozen=True)
class Some(Expr):
    """Quantified expression ``some $var in source satisfies cond``.

    Kept as a composite scalar (cond references Var(var)); evaluated
    vectorized over the repeated-field index (DESIGN.md §4 deviation
    note: quantifiers are not expanded into SUBPLANs).
    """
    var: int
    source: Expr
    cond: Expr

    def __str__(self) -> str:
        return (f"some $${self.var} in {self.source} "
                f"satisfies {self.cond}")


# --- function registry -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FnInfo:
    kind: str                     # scalar | aggregate | unnesting
    # document-order / dup-free propagation: given input (ordered,
    # nodup) booleans, does output keep them? (rule 4.1.1 lattice,
    # after Fernandez et al. [19])
    preserves_order: bool = True
    preserves_nodup: bool = True
    # cardinality: "one" (singleton out for singleton in), "many",
    # "same" (cardinality of the argument)
    card: str = "one"
    unnest_form: Optional[str] = None   # rule 4.1.3 mapping
    aggregate_form: Optional[str] = None  # rule 4.2.2 mapping
    # two-step decomposition for partitioned aggregation (local, global)
    two_step: Optional[tuple[str, str]] = None


FUNCTIONS: dict[str, FnInfo] = {
    # path machinery
    "doc": FnInfo("scalar", card="one"),
    "collection": FnInfo("scalar", card="many"),
    "child": FnInfo("scalar", card="many", unnest_form="child"),
    "iterate": FnInfo("unnesting", card="same"),
    "treat": FnInfo("scalar", card="same"),
    "promote": FnInfo("scalar", card="same"),
    "data": FnInfo("scalar", card="same"),
    "sort-distinct-nodes-asc-or-atomics": FnInfo("scalar", card="same"),
    "sort-nodes-asc-or-atomics": FnInfo("scalar", card="same"),
    "distinct-nodes-or-atomics": FnInfo("scalar", card="same"),
    # EBV / logic
    "boolean": FnInfo("scalar"),
    "and": FnInfo("scalar"), "or": FnInfo("scalar"),
    "not": FnInfo("scalar"),
    # value comparisons (XQuery) + the Algebricks generic forms the
    # join rule converts to (§4.2.3)
    "value-eq": FnInfo("scalar"), "value-ne": FnInfo("scalar"),
    "value-lt": FnInfo("scalar"), "value-le": FnInfo("scalar"),
    "value-gt": FnInfo("scalar"), "value-ge": FnInfo("scalar"),
    "algebricks-eq": FnInfo("scalar"),
    # casts / accessors
    "decimal": FnInfo("scalar"), "string": FnInfo("scalar"),
    "dateTime": FnInfo("scalar"),
    "year-from-dateTime": FnInfo("scalar"),
    "month-from-dateTime": FnInfo("scalar"),
    "day-from-dateTime": FnInfo("scalar"),
    "upper-case": FnInfo("scalar"),
    # arithmetic
    "add": FnInfo("scalar"), "subtract": FnInfo("scalar"),
    "multiply": FnInfo("scalar"), "divide": FnInfo("scalar"),
    # aggregates: scalar forms (over a sequence item) + AGGREGATE-op
    # forms; two_step gives the local/global split of rule 4.2.2
    "count": FnInfo("scalar", aggregate_form="count",
                    two_step=("count", "sum")),
    "sum": FnInfo("scalar", aggregate_form="sum",
                  two_step=("sum", "sum")),
    "min": FnInfo("scalar", aggregate_form="min",
                  two_step=("min", "min")),
    "max": FnInfo("scalar", aggregate_form="max",
                  two_step=("max", "max")),
    "avg": FnInfo("scalar", aggregate_form="avg",
                  two_step=("sum_count", "avg_combine")),
    # aggregate expressions (inside AGGREGATE op)
    "create_sequence": FnInfo("aggregate", card="one"),
}


def fn_info(name: str) -> FnInfo:
    return FUNCTIONS[name]


def free_vars(e: Expr) -> set[int]:
    if isinstance(e, Var):
        return {e.n}
    if isinstance(e, Call):
        out: set[int] = set()
        for a in e.args:
            out |= free_vars(a)
        return out
    if isinstance(e, Some):
        return (free_vars(e.source) | free_vars(e.cond)) - {e.var}
    return set()


def substitute(e: Expr, mapping: dict[int, Expr]) -> Expr:
    if isinstance(e, Var) and e.n in mapping:
        return mapping[e.n]
    if isinstance(e, Call):
        return Call(e.fn, tuple(substitute(a, mapping) for a in e.args))
    if isinstance(e, Some):
        m = {k: v for k, v in mapping.items() if k != e.var}
        return Some(e.var, substitute(e.source, m), substitute(e.cond, m))
    return e


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Op:
    def replace(self, **kw) -> "Op":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EmptyTupleSource(Op):
    pass


@dataclasses.dataclass(frozen=True)
class NestedTupleSource(Op):
    pass


@dataclasses.dataclass(frozen=True)
class Assign(Op):
    var: int
    expr: Expr
    child: Op


@dataclasses.dataclass(frozen=True)
class Unnest(Op):
    var: int
    expr: Expr          # unnesting expression (iterate / child / ...)
    child: Op


@dataclasses.dataclass(frozen=True)
class Select(Op):
    expr: Expr
    child: Op


@dataclasses.dataclass(frozen=True)
class Subplan(Op):
    plan: Op            # nested plan rooted at NestedTupleSource
    child: Op


@dataclasses.dataclass(frozen=True)
class Aggregate(Op):
    var: int
    expr: Expr          # aggregate expression
    child: Op
    # rule 4.2.2 two-step annotation (set by the parallel rewriter):
    local_fn: Optional[str] = None
    global_fn: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataScan(Op):
    collection: str
    var: int
    path: tuple[str, ...]      # pushed-down child path steps (4.2.1)
    child: Op
    partitioned: bool = True   # partition-property annotation


@dataclasses.dataclass(frozen=True)
class Join(Op):
    cond: Expr
    left: Op
    right: Op
    # physical annotation (§4.2.3): equi-key pairs for hybrid hash join
    hash_keys: tuple[tuple[Expr, Expr], ...] = ()


@dataclasses.dataclass(frozen=True)
class GroupBy(Op):
    """XQuery 3.0 group-by (the paper's §6 'planned next step'): one
    output tuple per distinct grouping key. ``aggs`` are (out_var, fn,
    value_expr); two-step execution uses the segmented-reduce kernel
    locally and psum globally (rule 4.2.2 generalized to keyed form)."""
    key_var: int
    key_expr: Expr
    aggs: tuple[tuple[int, str, Expr], ...]
    child: Op


@dataclasses.dataclass(frozen=True)
class OrderBy(Op):
    """Ordered output (XQuery ``order by`` after ``group by``): sort
    the tuple stream by ``keys`` — (expr, descending) pairs, most
    significant first. The translator appends the grouping key as a
    final ascending tiebreak so grouped orderings are total (and
    therefore identical across engines and batch layouts). Lowered to
    a capacity-bounded segmented sort (``ExecConfig.topk_cap``)."""
    keys: tuple[tuple[Expr, bool], ...]
    child: Op


@dataclasses.dataclass(frozen=True)
class Limit(Op):
    """Top-k output (``limit k``): keep the first ``k`` tuples of the
    (ordered) stream. ``k`` is structural — it bounds compiled output
    shapes, so it stays baked in the plan signature rather than
    lifting into the parameter vector."""
    k: int
    child: Op


@dataclasses.dataclass(frozen=True)
class DistributeResult(Op):
    vars: tuple[int, ...]
    child: Op


def children(op: Op) -> tuple[Op, ...]:
    if isinstance(op, Join):
        return (op.left, op.right)
    if isinstance(op, (EmptyTupleSource, NestedTupleSource)):
        return ()
    return (op.child,)


def with_children(op: Op, kids: tuple[Op, ...]) -> Op:
    if isinstance(op, Join):
        return op.replace(left=kids[0], right=kids[1])
    if isinstance(op, (EmptyTupleSource, NestedTupleSource)):
        return op
    return op.replace(child=kids[0])


def walk(op: Op) -> Iterator[Op]:
    """Pre-order over the operator DAG, including nested plans."""
    yield op
    if isinstance(op, Subplan):
        yield from walk(op.plan)
    for c in children(op):
        yield from walk(c)


def transform_bottom_up(op: Op, f: Callable[[Op], Op]) -> Op:
    kids = tuple(transform_bottom_up(c, f) for c in children(op))
    op = with_children(op, kids)
    if isinstance(op, Subplan):
        op = op.replace(plan=transform_bottom_up(op.plan, f))
    return f(op)


def defined_var(op: Op) -> Optional[int]:
    if isinstance(op, (Assign, Unnest, Aggregate)):
        return op.var
    if isinstance(op, DataScan):
        return op.var
    return None


def groupby_defined_vars(op: "GroupBy") -> tuple[int, ...]:
    return (op.key_var,) + tuple(v for v, _, _ in op.aggs)


def defined_vars(op: Op) -> tuple[int, ...]:
    """Every variable ``op`` defines — the multi-var generalization of
    ``defined_var`` (GROUP-BY defines its key and one var per
    aggregate)."""
    if isinstance(op, GroupBy):
        return groupby_defined_vars(op)
    v = defined_var(op)
    return () if v is None else (v,)


def used_exprs(op: Op) -> tuple[Expr, ...]:
    if isinstance(op, (Assign, Unnest, Aggregate, Select)):
        return (op.expr,)
    if isinstance(op, Join):
        return (op.cond,)
    if isinstance(op, GroupBy):
        return (op.key_expr,) + tuple(e for _, _, e in op.aggs)
    if isinstance(op, OrderBy):
        return tuple(e for e, _ in op.keys)
    return ()


def var_use_counts(root: Op) -> dict[int, int]:
    counts: dict[int, int] = {}
    for op in walk(root):
        for e in used_exprs(op):
            for v in free_vars(e):
                counts[v] = counts.get(v, 0) + 1
        if isinstance(op, DistributeResult):
            for v in op.vars:
                counts[v] = counts.get(v, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# Printing (paper-style traces)
# ---------------------------------------------------------------------------

def _fmt_op(op: Op) -> str:
    if isinstance(op, DistributeResult):
        return f"DISTRIBUTE-RESULT( {', '.join(f'$${v}' for v in op.vars)} )"
    if isinstance(op, Assign):
        return f"ASSIGN( $${op.var}:{op.expr} )"
    if isinstance(op, Unnest):
        return f"UNNEST( $${op.var}:{op.expr} )"
    if isinstance(op, Select):
        return f"SELECT( {op.expr} )"
    if isinstance(op, Aggregate):
        two = (f" [local={op.local_fn}, global={op.global_fn}]"
               if op.local_fn else "")
        return f"AGGREGATE( $${op.var}:{op.expr} ){two}"
    if isinstance(op, DataScan):
        path = "/" + "/".join(op.path) if op.path else ""
        extra = f', "{path}"' if path else ""
        return (f'DATASCAN( collection("{op.collection}"), '
                f"$${op.var}{extra} )")
    if isinstance(op, EmptyTupleSource):
        return "EMPTY-TUPLE-SOURCE"
    if isinstance(op, NestedTupleSource):
        return "NESTED-TUPLE-SOURCE"
    if isinstance(op, GroupBy):
        aggs = ", ".join(f"$${v}:{fn}({e})" for v, fn, e in op.aggs)
        return (f"GROUP-BY( $${op.key_var}:{op.key_expr} | {aggs} )")
    if isinstance(op, OrderBy):
        keys = ", ".join(f"{e} {'desc' if d else 'asc'}"
                         for e, d in op.keys)
        return f"ORDER-BY( {keys} )"
    if isinstance(op, Limit):
        return f"LIMIT( {op.k} )"
    if isinstance(op, Subplan):
        return "SUBPLAN {"
    if isinstance(op, Join):
        keys = " [hash]" if op.hash_keys else ""
        return f"JOIN( {op.cond} ){keys} {{"
    raise TypeError(op)


def pretty(op: Op, indent: int = 0, renumber: bool = True) -> str:
    """Paper-style plan trace (top = consumer, like §4's listings)."""
    lines: list[str] = []

    def rec(op: Op, ind: int) -> None:
        pad = "  " * ind
        if isinstance(op, Subplan):
            lines.append(pad + "SUBPLAN {")
            rec(op.plan, ind + 1)
            lines.append(pad + "}")
            rec(op.child, ind)
            return
        if isinstance(op, Join):
            lines.append(pad + _fmt_op(op))
            rec(op.left, ind + 1)
            lines.append(pad + "} {")
            rec(op.right, ind + 1)
            lines.append(pad + "}")
            return
        lines.append(pad + _fmt_op(op))
        for c in children(op):
            rec(c, ind)

    rec(op, indent)
    text = "\n".join(lines)
    if renumber:
        text = _renumber(text)
    return text


def _renumber(text: str) -> str:
    """Renumber $$N in first-appearance order so traces are stable."""
    import re
    mapping: dict[str, str] = {}

    def sub(m):
        k = m.group(0)
        if k not in mapping:
            mapping[k] = f"$${len(mapping) + 1}"
        return mapping[k]

    return re.sub(r"\$\$\d+", sub, text)


def signature(op: Op) -> list[str]:
    """Compact structural signature (op + head function names)."""
    out = []
    for o in walk(op):
        if isinstance(o, (Assign, Unnest, Aggregate)):
            head = o.expr.fn if isinstance(o.expr, Call) else "var"
            out.append(f"{type(o).__name__}:{head}")
        elif isinstance(o, DataScan):
            p = "/" + "/".join(o.path) if o.path else ""
            out.append(f"DataScan:{o.collection}{p}")
        else:
            out.append(type(o).__name__)
    return out
