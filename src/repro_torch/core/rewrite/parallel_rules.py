"""Parallel rewrite rules (paper §4.2).

  4.2.1 introduce_datascan + push_path_into_datascan
  4.2.2 scalar_agg_to_aggregate + annotate_two_step
  4.2.3 introduce_join (cross product from independent DATASCANs),
        push_into_join (operator pushdown + SELECT/JOIN merge with the
        EBV(value-eq) -> algebricks-eq conversion and hash annotation)
plus split_select_conjunctions (Algebricks-generic, feeds 4.2.3).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.algebra import (Aggregate, Assign, Call, Const, DataScan,
                                EmptyTupleSource, Expr, Join, Op, Select,
                                Some, Subplan, Unnest, Var, defined_var,
                                defined_vars, fn_info, free_vars,
                                substitute, walk)
from repro_torch.core.rewrite.engine import Context

TRUE = Const("true", "boolean")


# --- helpers -----------------------------------------------------------------

def _collection_literal(e: Expr) -> Optional[str]:
    """collection(promote(data("/x"), string)) -> "/x"."""
    if not (isinstance(e, Call) and e.fn == "collection"):
        return None
    a = e.args[0]
    while isinstance(a, Call) and a.fn in ("promote", "data"):
        a = a.args[0]
    if isinstance(a, Const):
        return str(a.value)
    return None


def _child_chain(e: Expr) -> Optional[tuple[int, list[str]]]:
    """child(treat(child(treat($v,..),"a"),..),"b") -> ($v, [a, b])."""
    if isinstance(e, Var):
        return e.n, []
    if isinstance(e, Call) and e.fn == "child":
        inner, name = e.args
        if isinstance(inner, Call) and inner.fn == "treat":
            inner = inner.args[0]
        if not isinstance(name, Const):
            return None
        got = _child_chain(inner)
        if got is None:
            return None
        v, names = got
        return v, names + [str(name.value)]
    return None


def _defined_vars(op: Op) -> set[int]:
    out = set()
    for o in walk(op):
        out.update(defined_vars(o))
    return out


# --- 4.2.1 --------------------------------------------------------------------

def introduce_datascan(op: Op, ctx: Context) -> Optional[Op]:
    """UNNEST($r: iterate($c)) over ASSIGN($c: collection(...)) ->
    DATASCAN(collection, $r)."""
    if not (isinstance(op, Unnest) and isinstance(op.expr, Call)
            and op.expr.fn == "iterate"
            and isinstance(op.expr.args[0], Var)
            and isinstance(op.child, Assign)):
        return None
    c = op.expr.args[0].n
    a = op.child
    if a.var != c or ctx.use.get(c, 0) != 1:
        return None
    coll = _collection_literal(a.expr)
    if coll is None:
        return None
    return DataScan(coll, op.var, (), a.child)


def push_path_into_datascan(op: Op, ctx: Context) -> Optional[Op]:
    """UNNEST($r: child-chain($d)) over DATASCAN(...,$d,...) ->
    DATASCAN with the path appended (smaller tuples, §4.2.1)."""
    if not (isinstance(op, Unnest) and isinstance(op.child, DataScan)):
        return None
    got = _child_chain(op.expr)
    if got is None:
        return None
    v, names = got
    ds = op.child
    if v != ds.var or not names or ctx.use.get(v, 0) != 1:
        return None
    return ds.replace(var=op.var, path=ds.path + tuple(names))


# --- 4.2.2 --------------------------------------------------------------------

_AGG_FNS = ("count", "sum", "min", "max", "avg")


def _find_agg_subcall(e: Expr, seqvar: int) -> Optional[Call]:
    """Find fn(treat($seqvar, any_type)) anywhere inside e."""
    if isinstance(e, Call):
        if e.fn in _AGG_FNS and len(e.args) == 1:
            a = e.args[0]
            if (isinstance(a, Call) and a.fn == "treat"
                    and isinstance(a.args[0], Var)
                    and a.args[0].n == seqvar):
                return e
        for a in e.args:
            r = _find_agg_subcall(a, seqvar)
            if r is not None:
                return r
    return None


def _replace_subexpr(e: Expr, old: Expr, new: Expr) -> Expr:
    if e == old:
        return new
    if isinstance(e, Call):
        return Call(e.fn, tuple(_replace_subexpr(a, old, new)
                                for a in e.args))
    return e


def scalar_agg_to_aggregate(op: Op, ctx: Context) -> Optional[Op]:
    """ASSIGN($v: ..count(treat($s, any_type))..) over SUBPLAN{
    AGGREGATE($s: create_sequence(e0)) ...} -> move the aggregate into
    the AGGREGATE operator (incremental aggregation, §4.2.2)."""
    if not (isinstance(op, Assign) and isinstance(op.child, Subplan)):
        return None
    sp = op.child
    agg = sp.plan
    if not (isinstance(agg, Aggregate) and isinstance(agg.expr, Call)
            and agg.expr.fn == "create_sequence"):
        return None
    s = agg.var
    if ctx.use.get(s, 0) != 1:
        return None
    call = _find_agg_subcall(op.expr, s)
    if call is None:
        return None
    e0 = agg.expr.args[0]
    new_agg_expr = Call(call.fn,
                        (Call("treat", (e0, Const("any_type", "type"))),))
    if op.expr == call:
        # the assign IS the aggregate: retarget the AGGREGATE var
        new_nested = agg.replace(var=op.var, expr=new_agg_expr)
        return sp.replace(plan=new_nested)
    # aggregate appears inside a wider expression (e.g. sum(..) div 10):
    # keep an ASSIGN for the wrapper, aggregate into a fresh var
    w = ctx.fresh()
    new_nested = agg.replace(var=w, expr=new_agg_expr)
    wrapper = _replace_subexpr(op.expr, call, Var(w))
    return Assign(op.var, wrapper, sp.replace(plan=new_nested))


def annotate_two_step(op: Op, ctx: Context) -> Optional[Op]:
    """Annotate AGGREGATE ops over partitioned scans with the
    local/global split (enables partitioned two-step aggregation)."""
    if not (isinstance(op, Aggregate) and op.local_fn is None
            and isinstance(op.expr, Call)):
        return None
    info = fn_info(op.expr.fn)
    if info.two_step is None:
        return None
    if not any(isinstance(o, DataScan) and o.partitioned
               for o in walk(op.child)):
        return None
    loc, glob = info.two_step
    return op.replace(local_fn=loc, global_fn=glob)


# --- generic: conjunct splitting ------------------------------------------------

def split_select_conjunctions(op: Op, ctx: Context) -> Optional[Op]:
    """SELECT(boolean(and(a, b))) -> SELECT(boolean(a)) over
    SELECT(boolean(b)) (enables per-side pushdown)."""
    if not isinstance(op, Select):
        return None
    e = op.expr
    ebv = isinstance(e, Call) and e.fn == "boolean"
    inner = e.args[0] if ebv else e
    if not (isinstance(inner, Call) and inner.fn == "and"):
        return None
    a, b = inner.args
    wrap = (lambda x: Call("boolean", (x,))) if ebv else (lambda x: x)
    return Select(wrap(a), Select(wrap(b), op.child))


# --- 4.2.3 --------------------------------------------------------------------

def introduce_join(op: Op, ctx: Context) -> Optional[Op]:
    """A DATASCAN whose input subtree already contains a DATASCAN is a
    dependent nested loop over independent sources -> cross-product
    JOIN (condition true); predicates merge later."""
    if not isinstance(op, DataScan):
        return None
    if isinstance(op.child, EmptyTupleSource):
        return None
    has_source_below = any(isinstance(o, (DataScan, Join))
                           for o in walk(op.child))
    if not has_source_below:
        return None
    return Join(TRUE, op.child, op.replace(child=EmptyTupleSource()))


def _cross_eq_key(e: Expr, lvars: set[int], rvars: set[int]
                  ) -> Optional[tuple[Expr, Expr]]:
    if not (isinstance(e, Call) and e.fn == "value-eq"):
        return None
    a, b = e.args
    av, bv = free_vars(a), free_vars(b)
    if av and bv:
        if av <= lvars and bv <= rvars:
            return (a, b)
        if av <= rvars and bv <= lvars:
            return (b, a)
    return None


def push_into_join(op: Op, ctx: Context) -> Optional[Op]:
    """Push SELECT/ASSIGN just above a JOIN into the proper branch, or
    merge an equi-SELECT into the JOIN condition (converting the XQuery
    EBV boolean(value-eq(..)) into Algebricks' equal so the physical
    optimizer can pick the hybrid hash join, §4.2.3)."""
    if isinstance(op, (Select, Assign)) and isinstance(op.child, Join):
        j = op.child
        lvars, rvars = _defined_vars(j.left), _defined_vars(j.right)
        e = op.expr
        used = free_vars(e)
        if isinstance(op, Assign):
            if used <= lvars:
                return j.replace(left=op.replace(child=j.left))
            if used <= rvars:
                return j.replace(right=op.replace(child=j.right))
            return None
        # SELECT
        inner = e.args[0] if (isinstance(e, Call) and e.fn == "boolean") \
            else e
        if used <= lvars:
            return j.replace(left=Select(e, j.left))
        if used <= rvars:
            return j.replace(right=Select(e, j.right))
        key = _cross_eq_key(inner, lvars, rvars)
        if key is not None:
            eq = Call("algebricks-eq", key)
            cond = eq if j.cond == TRUE else Call("and", (j.cond, eq))
            return j.replace(cond=cond, hash_keys=j.hash_keys + (key,))
        return None
    return None


RULES = [
    introduce_datascan,
    push_path_into_datascan,
    scalar_agg_to_aggregate,
    split_select_conjunctions,
    introduce_join,
    push_into_join,
    annotate_two_step,
]
