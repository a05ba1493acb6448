"""AST -> normalized Algebricks logical plan (paper §3.3 / §4 intro).

Normalization deliberately over-protects correctness, exactly as the
paper describes, so the rewrite rules have something real to remove:

* every child path step becomes
    ASSIGN( $sorted : sort-distinct-nodes-asc-or-atomics($agg) )
    SUBPLAN { AGGREGATE( $agg : create_sequence(
                  child(treat($it, element_node), "name")) )
              UNNEST( $it : iterate($in) )
              NESTED-TUPLE-SOURCE }
* ``doc``/``collection`` become ASSIGN(doc(promote(data(lit), string)))
* FLWOR ``for`` -> UNNEST(iterate), ``let`` -> ASSIGN,
  ``where`` -> SELECT(boolean(...))
* scalar aggregates over a FLWOR become the §4.2.2 shape:
    ASSIGN( $v : count(treat($seq, any_type)) )
    SUBPLAN { AGGREGATE( $seq : create_sequence($ret) ) <flwor ops> NTS }
* the query result is unnested (UNNEST iterate) into DISTRIBUTE-RESULT.

Deviations (documented, DESIGN.md §4): quantified expressions stay
composite ``Some`` scalars; multi-item ``return (a, b, c)`` keeps tuple
shape in DISTRIBUTE-RESULT instead of flattening.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import xqparser as xq
from repro_torch.core.algebra import (FUNCTIONS, Aggregate, Assign, Call, Const,
                                DistributeResult, EmptyTupleSource, Expr,
                                GroupBy, Limit, NestedTupleSource, Op,
                                OrderBy, Select, Some, Subplan, Unnest,
                                Var)
from repro_torch.core.errors import QueryError, TranslateError, UnsupportedError

_CMP = {"eq": "value-eq", "ne": "value-ne", "lt": "value-lt",
        "le": "value-le", "gt": "value-gt", "ge": "value-ge"}
_ARITH = {"add": "add", "sub": "subtract", "mul": "multiply",
          "div": "divide"}
_AGG_FNS = ("count", "sum", "min", "max", "avg")


@dataclasses.dataclass
class _Env:
    vars: dict[str, int]
    node_valued: dict[int, bool]


class Translator:
    def __init__(self) -> None:
        self._next = 0

    def new_var(self) -> int:
        self._next += 1
        return self._next

    # -- expression helpers ---------------------------------------------

    def _atomize(self, e: Expr, is_node: bool) -> Expr:
        return Call("data", (e,)) if is_node else e

    def _lookup(self, ast: xq.Ref, env: _Env) -> int:
        v = env.vars.get(ast.name)
        if v is None:
            raise TranslateError(f"unbound variable ${ast.name}",
                                 pos=ast.pos)
        return v

    def _check_fn(self, ast: xq.Fn) -> None:
        if ast.name not in FUNCTIONS:
            raise TranslateError(f"unknown function {ast.name}()",
                                 pos=ast.pos)

    def _is_node_ast(self, ast: xq.Ast, env: _Env) -> bool:
        if isinstance(ast, xq.Path):
            return True
        if isinstance(ast, xq.Ref):
            return env.node_valued.get(self._lookup(ast, env), True)
        if isinstance(ast, xq.Fn):
            return ast.name in ("doc", "collection")
        return False

    # -- pure translation (no plan ops): quantifier bodies ---------------

    def pure_expr(self, ast: xq.Ast, env: _Env) -> Expr:
        if isinstance(ast, xq.Lit):
            return Const(ast.value, ast.typ)
        if isinstance(ast, xq.Ref):
            return Var(self._lookup(ast, env))
        if isinstance(ast, xq.Path):
            e = self.pure_expr(ast.base, env)
            for step in ast.steps:
                e = Call("child", (Call("treat",
                                        (e, Const("element_node", "type"))),
                                   Const(step, "string")))
            return e
        if isinstance(ast, xq.Bin):
            if ast.op in ("and", "or"):
                return Call(ast.op, (self.pure_expr(ast.left, env),
                                     self.pure_expr(ast.right, env)))
            fn = _CMP.get(ast.op) or _ARITH[ast.op]
            le = self._atomize(self.pure_expr(ast.left, env),
                               self._is_node_ast(ast.left, env))
            re_ = self._atomize(self.pure_expr(ast.right, env),
                                self._is_node_ast(ast.right, env))
            return Call(fn, (le, re_))
        if isinstance(ast, xq.Fn):
            self._check_fn(ast)
            args = tuple(self.pure_expr(a, env) for a in ast.args)
            return Call(ast.name, args)
        raise UnsupportedError(
            f"unsupported expression in quantifier body: {ast}",
            pos=getattr(ast, "pos", -1))

    # -- plan-building translation ---------------------------------------

    def path_step(self, plan: Op, invar: int, step: str
                  ) -> tuple[Op, int]:
        """The paper's 3-stage path step (iterate/collect/sort)."""
        it, agg, srt = self.new_var(), self.new_var(), self.new_var()
        nested: Op = NestedTupleSource()
        nested = Unnest(it, Call("iterate", (Var(invar),)), nested)
        step_expr = Call("child",
                         (Call("treat", (Var(it),
                                         Const("element_node", "type"))),
                          Const(step, "string")))
        nested = Aggregate(agg, Call("create_sequence", (step_expr,)),
                           nested)
        plan = Subplan(nested, plan)
        plan = Assign(srt,
                      Call("sort-distinct-nodes-asc-or-atomics",
                           (Var(agg),)), plan)
        return plan, srt

    def expr(self, ast: xq.Ast, env: _Env, plan: Op
             ) -> tuple[Op, Expr, bool]:
        """Returns (plan, expr, is_node_valued)."""
        if isinstance(ast, xq.Lit):
            return plan, Const(ast.value, ast.typ), False
        if isinstance(ast, xq.Ref):
            v = self._lookup(ast, env)
            return plan, Var(v), env.node_valued.get(v, True)
        if isinstance(ast, xq.Path):
            plan, base, _ = self.expr(ast.base, env, plan)
            if not isinstance(base, Var):
                bv = self.new_var()
                plan = Assign(bv, base, plan)
                base = Var(bv)
            v = base.n
            for step in ast.steps:
                plan, v = self.path_step(plan, v, step)
            return plan, Var(v), True
        if isinstance(ast, xq.Fn):
            self._check_fn(ast)
            if ast.name in ("doc", "collection"):
                lit = ast.args[0] if ast.args else None
                if not isinstance(lit, xq.Lit):
                    raise TranslateError(
                        f"{ast.name}() needs a string-literal argument",
                        pos=ast.pos)
                inner = Call("promote", (Call("data",
                                              (Const(lit.value, "string"),)),
                                         Const("string", "type")))
                v = self.new_var()
                plan = Assign(v, Call(ast.name, (inner,)), plan)
                return plan, Var(v), True
            if ast.name in _AGG_FNS:
                return self.aggregate_call(ast, env, plan)
            args = []
            for a in ast.args:
                plan, e, _ = self.expr(a, env, plan)
                args.append(e)
            return plan, Call(ast.name, tuple(args)), False
        if isinstance(ast, xq.Bin):
            if ast.op in ("and", "or"):
                plan, le, _ = self.expr(ast.left, env, plan)
                plan, re_, _ = self.expr(ast.right, env, plan)
                return plan, Call(ast.op, (le, re_)), False
            fn = _CMP.get(ast.op) or _ARITH[ast.op]
            plan, le, ln = self.expr(ast.left, env, plan)
            plan, re_, rn = self.expr(ast.right, env, plan)
            return plan, Call(fn, (self._atomize(le, ln),
                                   self._atomize(re_, rn))), False
        if isinstance(ast, xq.SomeQ):
            plan, src, _ = self.expr(ast.source, env, plan)
            qv = self.new_var()
            inner_env = _Env({**env.vars, ast.var: qv},
                             {**env.node_valued, qv: True})
            cond = self.pure_expr(ast.cond, inner_env)
            return plan, Some(qv, src, cond), False
        if isinstance(ast, xq.Seq):
            raise UnsupportedError(
                "sequence construction is only supported in return "
                "position", pos=ast.pos)
        if isinstance(ast, xq.Flwor):
            # FLWOR in expression position: collect its stream into a
            # sequence (create_sequence SUBPLAN), §4.2.2 shape.
            nested, ret_vars = self.flwor_stream(ast, env,
                                                 NestedTupleSource())
            if len(ret_vars) != 1:
                raise TranslateError(
                    "a FLWOR in expression position must return a "
                    "single item", pos=ast.pos)
            seq = self.new_var()
            nested = Aggregate(seq, Call("create_sequence",
                                         (Var(ret_vars[0]),)), nested)
            plan = Subplan(nested, plan)
            return plan, Var(seq), True
        raise UnsupportedError(f"unsupported expression: {ast}",
                               pos=getattr(ast, "pos", -1))

    def aggregate_call(self, ast: xq.Fn, env: _Env, plan: Op
                       ) -> tuple[Op, Expr, bool]:
        """count/sum/... over FLWOR or path: ASSIGN(scalar agg) over
        SUBPLAN{AGGREGATE(create_sequence)}, per §4.2.2."""
        (arg,) = ast.args
        plan, seq_expr, _ = self.expr(arg, env, plan)
        call = Call(ast.name, (Call("treat", (seq_expr,
                                              Const("any_type", "type"))),))
        return plan, call, False

    def flwor_stream(self, ast: xq.Flwor, env: _Env, plan: Op
                     ) -> tuple[Op, list[int]]:
        """Translate FLWOR clauses onto ``plan`` as a tuple stream;
        returns (plan, return-item vars)."""
        env = _Env(dict(env.vars), dict(env.node_valued))
        for ci, cl in enumerate(ast.clauses):
            if cl[0] == "groupby":
                return self._group_by(cl, ast.clauses[ci + 1:], ast,
                                      env, plan)
            if cl[0] == "for":
                _, name, src = cl
                plan, e, is_node = self.expr(src, env, plan)
                if not isinstance(e, Var):
                    sv = self.new_var()
                    plan = Assign(sv, e, plan)
                    e = Var(sv)
                x = self.new_var()
                plan = Unnest(x, Call("iterate", (e,)), plan)
                env.vars[name] = x
                env.node_valued[x] = is_node
            elif cl[0] == "let":
                _, name, src = cl
                plan, e, is_node = self.expr(src, env, plan)
                x = self.new_var()
                plan = Assign(x, e, plan)
                env.vars[name] = x
                env.node_valued[x] = is_node
            elif cl[0] == "where":
                plan, e, _ = self.expr(cl[1], env, plan)
                plan = Select(Call("boolean", (e,)), plan)
            elif cl[0] in ("orderby", "limit"):
                raise UnsupportedError(
                    "order by / limit are supported after group by "
                    "only (ordered grouped output)",
                    pos=(cl[1].pos if isinstance(cl[1], xq.Ast)
                         else ast.pos))
            else:
                raise TranslateError(
                    f"unsupported FLWOR clause {cl[0]!r}", pos=ast.pos)
        # return clause
        items = (ast.ret.items if isinstance(ast.ret, xq.Seq)
                 else (ast.ret,))
        ret_vars: list[int] = []
        for item in items:
            plan, e, _ = self.expr(item, env, plan)
            if isinstance(e, Var):
                ret_vars.append(e.n)
            else:
                rv = self.new_var()
                plan = Assign(rv, e, plan)
                ret_vars.append(rv)
        return plan, ret_vars

    def _group_by(self, cl, rest: tuple, ast: xq.Flwor, env: _Env,
                  plan: Op) -> tuple[Op, list[int]]:
        """XQuery 3.0-lite group-by (paper §6 future work). Return
        items — and any HAVING-style ``where``, ``order by`` and
        ``limit`` clauses *after* the group-by — are expressions over
        the grouping key and aggregate functions of per-tuple
        expressions. Lowered to the keyed two-step GROUP-BY operator
        (segmented reduce locally, psum globally — rule 4.2.2
        generalized), with post-group SELECTs for the HAVING filters,
        post-group ASSIGNs for non-variable return expressions (e.g.
        ``avg(..) div 10``), ORDER-BY over the grouped stream (keys
        share aggregate slots with HAVING/return; the grouping key is
        appended as a total-order tiebreak) and LIMIT for top-k."""
        _, gname, key_ast = cl
        plan, key_e, _ = self.expr(key_ast, env, plan)
        key_var = self.new_var()
        aggs: list[tuple[int, str, Expr]] = []
        slots: dict[xq.Ast, int] = {}

        def agg_slot(item: xq.Fn) -> int:
            """One GROUP-BY aggregate slot per distinct (fn, arg) call
            — shared between HAVING conditions and return items."""
            nonlocal plan
            if item in slots:
                return slots[item]
            plan, val_e, _ = self.expr(item.args[0], env, plan)
            v = self.new_var()
            aggs.append((v, item.name, val_e))
            slots[item] = v
            return v

        def post(a: xq.Ast) -> Expr:
            """Post-group expression: aggregate calls and the grouping
            key become GROUP-BY output variables; scalar structure on
            top stays expression-level."""
            if isinstance(a, xq.Ref) and a.name == gname:
                return Var(key_var)
            if isinstance(a, xq.Fn) and a.name in _AGG_FNS:
                return Var(agg_slot(a))
            if isinstance(a, xq.Lit):
                return Const(a.value, a.typ)
            if isinstance(a, xq.Bin):
                if a.op in ("and", "or"):
                    return Call(a.op, (post(a.left), post(a.right)))
                fn = _CMP.get(a.op) or _ARITH[a.op]
                return Call(fn, (post(a.left), post(a.right)))
            if isinstance(a, xq.Fn):
                self._check_fn(a)
                return Call(a.name, tuple(post(x) for x in a.args))
            raise UnsupportedError(
                "post-group expressions must be built from the "
                f"grouping key and aggregates, got {a}",
                pos=getattr(a, "pos", -1))

        havings: list[Expr] = []
        order_keys: list[tuple[Expr, bool]] = []
        limit_k: int | None = None
        for rc in rest:
            rc_pos = (rc[1].pos if len(rc) > 1 and isinstance(rc[1], xq.Ast)
                      else ast.pos)
            if rc[0] == "where":
                if order_keys or limit_k is not None:
                    raise UnsupportedError(
                        "HAVING where must precede order by / limit",
                        pos=rc_pos)
                havings.append(post(rc[1]))
            elif rc[0] == "orderby":
                order_keys.append((post(rc[1]), rc[2]))
            elif rc[0] == "limit":
                if not order_keys:
                    raise UnsupportedError(
                        "limit without order by has no deterministic "
                        "row selection; add an order by clause",
                        pos=rc_pos)
                if limit_k is not None:
                    raise UnsupportedError("duplicate limit clause",
                                           pos=rc_pos)
                if rc[1] < 1:
                    raise TranslateError(
                        f"limit must be >= 1, got {rc[1]}", pos=rc_pos)
                limit_k = rc[1]
            else:
                raise UnsupportedError(
                    f"only where (HAVING) / order by / limit may "
                    f"follow group by, got {rc[0]}", pos=rc_pos)
        items = (ast.ret.items if isinstance(ast.ret, xq.Seq)
                 else (ast.ret,))
        ret_vars: list[int] = []
        deferred: list[tuple[int, Expr]] = []
        for item in items:
            e = post(item)
            if isinstance(e, Var):
                ret_vars.append(e.n)
            else:
                rv = self.new_var()
                deferred.append((rv, e))
                ret_vars.append(rv)
        plan = GroupBy(key_var, key_e, tuple(aggs), plan)
        for hv in havings:
            plan = Select(Call("boolean", (hv,)), plan)
        for rv, e in deferred:
            plan = Assign(rv, e, plan)
        if order_keys:
            # the grouping key (unique per output tuple) as a final
            # ascending tiebreak makes the ordering total, so device
            # sort, host oracles and batch layouts all agree exactly
            order_keys.append((Var(key_var), False))
            plan = OrderBy(tuple(order_keys), plan)
        if limit_k is not None:
            plan = Limit(limit_k, plan)
        return plan, ret_vars

    # -- entry point -------------------------------------------------------

    def translate(self, ast: xq.Ast) -> Op:
        env = _Env({}, {})
        plan: Op = EmptyTupleSource()
        if isinstance(ast, xq.Flwor):
            plan, ret_vars = self.flwor_stream(ast, env, plan)
            if len(ret_vars) == 1:
                out = self.new_var()
                plan = Unnest(out, Call("iterate", (Var(ret_vars[0]),)),
                              plan)
                return DistributeResult((out,), plan)
            return DistributeResult(tuple(ret_vars), plan)
        plan, e, _ = self.expr(ast, env, plan)
        if not isinstance(e, Var):
            v = self.new_var()
            plan = Assign(v, e, plan)
            e = Var(v)
        out = self.new_var()
        plan = Unnest(out, Call("iterate", (e,)), plan)
        return DistributeResult((out,), plan)


def translate(query: str) -> Op:
    try:
        return Translator().translate(xq.parse(query))
    except QueryError as e:
        raise e.with_text(query)
