"""Path expression rewrite rules (paper §4.1) + generic cleanups.

Rule names map 1:1 onto the paper's subsections:
  4.1.1 remove_sort_distinct
  4.1.2 remove_subplan_iterate
  4.1.3 scalar_to_unnest
  4.1.4 combine_unnest
plus the Algebricks-generic rules the paper leans on implicitly:
  inline_singleton_subplan  (collapse inner focus for singleton input —
                             what turns where-clause steps into plain
                             ASSIGN(child(...)), visible in §4.2.3's
                             ASSIGN($$28:data(child($$26,"title"))))
  inline_single_use_assign / inline_var_assign / remove_dead_assign
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.algebra import (Aggregate, Assign, Call, Expr,
                                NestedTupleSource, Op, Select, Some,
                                Subplan, Unnest, Var, fn_info, free_vars,
                                substitute, transform_bottom_up)
from repro_torch.core.rewrite.engine import Context, expr_props


# --- 4.1.1 ------------------------------------------------------------------

def remove_sort_distinct(op: Op, ctx: Context) -> Optional[Op]:
    """ASSIGN($v: sort-distinct(...)($u)) -> weaker/no-op form when the
    tracked (order, nodup) properties are already intact."""
    if not (isinstance(op, Assign) and isinstance(op.expr, Call)):
        return None
    fn = op.expr.fn
    if fn not in ("sort-distinct-nodes-asc-or-atomics",
                  "sort-nodes-asc-or-atomics",
                  "distinct-nodes-or-atomics"):
        return None
    arg = op.expr.args[0]
    ordered, nodup = expr_props(arg, ctx.props)
    need_sort = "sort" in fn and not ordered
    need_distinct = "distinct" in fn and not nodup
    if need_sort and need_distinct:
        return None
    if need_sort:
        new = Call("sort-nodes-asc-or-atomics", (arg,))
    elif need_distinct:
        new = Call("distinct-nodes-or-atomics", (arg,))
    else:
        new = arg   # both properties intact: drop the expression
    if new == op.expr:
        return None
    return op.replace(expr=new)


# --- 4.1.2 ------------------------------------------------------------------

def _splice_nested(nested: Op, onto: Op) -> Op:
    """Replace the NESTED-TUPLE-SOURCE leaf of ``nested`` with ``onto``
    (merging @NESTED into the outer plan)."""

    def f(o: Op) -> Op:
        return onto if isinstance(o, NestedTupleSource) else o

    return transform_bottom_up(nested, f)


def remove_subplan_iterate(op: Op, ctx: Context) -> Optional[Op]:
    """UNNEST($r: iterate($s)) over SUBPLAN{AGGREGATE($s:
    create_sequence(@exp0)) @NESTED NTS} ->
    UNNEST($r: iterate($t)) over ASSIGN($t: @exp0) over @NESTED."""
    if not (isinstance(op, Unnest) and isinstance(op.expr, Call)
            and op.expr.fn == "iterate"
            and isinstance(op.expr.args[0], Var)
            and isinstance(op.child, Subplan)):
        return None
    s = op.expr.args[0].n
    sp = op.child
    agg = sp.plan
    if not (isinstance(agg, Aggregate) and agg.var == s
            and isinstance(agg.expr, Call)
            and agg.expr.fn == "create_sequence"
            and ctx.use.get(s, 0) == 1):
        return None
    exp0 = agg.expr.args[0]
    tmp = ctx.fresh()
    merged = _splice_nested(agg.child, sp.child)
    return Unnest(op.var, Call("iterate", (Var(tmp),)),
                  Assign(tmp, exp0, merged))


# --- generic: collapse inner focus when the input is a singleton ------------

def inline_singleton_subplan(op: Op, ctx: Context) -> Optional[Op]:
    """SUBPLAN{AGGREGATE($s: create_sequence(e0)) UNNEST($it:
    iterate($v)) NTS} with singleton $v  ->  ASSIGN($s: e0[$it := $v]).

    The inner focus iterates a single item; the aggregate re-wraps it.
    Both are identities, leaving a scalar assign (cf. the plain
    ASSIGN(child(...)) ops in the paper's §4.2.3 plans)."""
    if not isinstance(op, Subplan):
        return None
    agg = op.plan
    if not (isinstance(agg, Aggregate) and isinstance(agg.expr, Call)
            and agg.expr.fn == "create_sequence"):
        return None
    un = agg.child
    if not (isinstance(un, Unnest) and isinstance(un.expr, Call)
            and un.expr.fn == "iterate"
            and isinstance(un.expr.args[0], Var)
            and isinstance(un.child, NestedTupleSource)):
        return None
    v = un.expr.args[0].n
    if not ctx.singleton.get(v, False):
        return None
    e0 = substitute(agg.expr.args[0], {un.var: Var(v)})
    return Assign(agg.var, e0, op.child)


# --- 4.1.3 ------------------------------------------------------------------

def scalar_to_unnest(op: Op, ctx: Context) -> Optional[Op]:
    """UNNEST($r: iterate($sv)) over ASSIGN($sv: scalar-with-unnest-form)
    -> UNNEST($r: unnest_form(...)) when $sv is used once."""
    if not (isinstance(op, Unnest) and isinstance(op.expr, Call)
            and op.expr.fn == "iterate"
            and isinstance(op.expr.args[0], Var)
            and isinstance(op.child, Assign)):
        return None
    sv = op.expr.args[0].n
    a = op.child
    if a.var != sv or ctx.use.get(sv, 0) != 1:
        return None
    if not (isinstance(a.expr, Call)
            and fn_info(a.expr.fn).unnest_form is not None):
        return None
    return Unnest(op.var, a.expr, a.child)


# --- 4.1.4 ------------------------------------------------------------------

def _is_unnest_child_form(e: Expr) -> bool:
    return isinstance(e, Call) and e.fn == "child"


def combine_unnest(op: Op, ctx: Context) -> Optional[Op]:
    """UNNEST($r: child(..$u..)) over UNNEST($u: child(...)) -> merge
    the two path steps into one UNNEST (input var substituted)."""
    if not (isinstance(op, Unnest) and _is_unnest_child_form(op.expr)
            and isinstance(op.child, Unnest)
            and _is_unnest_child_form(op.child.expr)):
        return None
    u = op.child.var
    if ctx.use.get(u, 0) != 1 or u not in free_vars(op.expr):
        return None
    merged = substitute(op.expr, {u: op.child.expr})
    return Unnest(op.var, merged, op.child.child)


# --- generic cleanups --------------------------------------------------------

def inline_single_use_assign(op: Op, ctx: Context) -> Optional[Op]:
    """Merge ASSIGN($v: e) into its single consumer directly above
    (Algebricks InlineVariables), for pure scalar e."""
    if not isinstance(op, (Assign, Select, Aggregate)):
        return None
    child = getattr(op, "child", None)
    if not isinstance(child, Assign):
        return None
    v = child.var
    if ctx.use.get(v, 0) != 1:
        return None
    expr = op.expr
    if v not in free_vars(expr):
        return None
    if isinstance(child.expr, Some):
        return None
    # don't fold unnesting sources into scalar positions other than
    # plain variable refs; conservative: inline only scalar calls,
    # vars and consts
    new_expr = substitute(expr, {v: child.expr})
    return op.replace(expr=new_expr, child=child.child)


def remove_dead_assign(op: Op, ctx: Context) -> Optional[Op]:
    if isinstance(op, Assign) and ctx.use.get(op.var, 0) == 0:
        return op.child
    if isinstance(op, Subplan):
        agg = op.plan
        if isinstance(agg, Aggregate) and ctx.use.get(agg.var, 0) == 0:
            return op.child
    return None


# Order mirrors the paper's §4.1 cascade: sort removal enables subplan
# removal, which enables unnest conversion, which enables merging; the
# singleton collapse (paper-implicit) runs last so 4.1.2 gets first go.
RULES = [
    remove_sort_distinct,
    remove_subplan_iterate,
    scalar_to_unnest,
    combine_unnest,
    inline_singleton_subplan,
    remove_dead_assign,
]

CLEANUP_RULES = [
    inline_single_use_assign,
    remove_dead_assign,
]
