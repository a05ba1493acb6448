"""Bottom-up schema/type inference over algebra plans.

Assigns every operator a static schema ``{var: ColType}`` mirroring
the runtime column kinds of ``physical.Col`` (``str`` = dictionary
sid / int32, ``num`` = f32, ``date`` = packed int32 date, ``bool``,
``node``/``atom`` = table-anchored node references that can project
into any atom domain).  Plans that would die deep inside a JAX trace
— ``atom_num`` over a sid column, ``atom_sid`` over an f32 column,
ORDER BY a column the plan never produces, a HAVING filter referencing
an unshared aggregate slot — are rejected here with an operator-path
diagnostic (``errors.PlanTypeError``) at ``QueryService.prepare()``
time instead.

Two modes:

* ``mode="executor"`` (default) checks the exact structural contract
  ``Executor._eval`` enforces: DATASCAN over trivial input only,
  SUBPLANs rewritten to scalar AGGREGATEs, equi-joins with hash keys,
  sid-able GROUP-BY keys.  Run on optimized/prepared plans.
* ``mode="logical"`` types mid-rewrite plans (``collection()`` calls
  still in expression position, ``create_sequence`` subplans, scans
  not yet introduced).  Run by the rewrite-soundness checker on every
  intermediate plan of the optimizer fixpoint.

Nullability is valid-mask provenance: a column is nullable when its
value can be an absent marker under a *set* valid bit (e.g. a missing
child step, or left-side columns of a join gathered with fill).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

from repro_torch.core import algebra as A
from repro_torch.core.errors import PlanTypeError

#: value kinds, mirroring physical.Col (``const`` folds into ``num``;
#: ``det``/``xnode`` are runtime exchange encodings, never inferred)
VALUE_KINDS = ("node", "atom", "num", "str", "date", "bool")

#: kinds a given atom projection accepts (TypeError at trace time
#: otherwise — see ExprEval.atom_num / atom_sid / atom_date)
_NUM_OK = frozenset(("num", "date", "node", "atom"))
_SID_OK = frozenset(("str", "node", "atom"))
_DATE_OK = frozenset(("date", "node", "atom"))

_AGG_FNS = ("count", "sum", "min", "max", "avg")

_DATE_LIT_RE = re.compile(r"(\d{4})-(\d{2})-(\d{2})")


@dataclasses.dataclass(frozen=True)
class ColType:
    """Static type of one column: dtype class, anchoring node table
    (for node/atom kinds), nullability, and sequence-ness (logical
    plans only; erased by UNNEST)."""
    kind: str
    table: Optional[str] = None
    nullable: bool = False
    seq: bool = False

    def __str__(self) -> str:
        s = self.kind + (f"[{self.table}]" if self.table else "")
        if self.seq:
            s += "*"
        if self.nullable:
            s += "?"
        return s

    def item(self) -> "ColType":
        return dataclasses.replace(self, seq=False)


Schema = Dict[int, ColType]


def op_label(op: A.Op) -> str:
    """Short operator label for diagnostics paths."""
    n = type(op).__name__
    names = {"EmptyTupleSource": "ETS", "NestedTupleSource": "NTS",
             "DistributeResult": "DISTRIBUTE-RESULT",
             "OrderBy": "ORDER-BY", "GroupBy": "GROUP-BY"}
    n = names.get(n, n.upper())
    if isinstance(op, (A.Assign, A.Unnest, A.Aggregate)):
        return f"{n}($${op.var})"
    if isinstance(op, A.DataScan):
        return f"DATASCAN({op.collection})"
    if isinstance(op, A.GroupBy):
        return f"GROUP-BY($${op.key_var})"
    if isinstance(op, A.Limit):
        return f"LIMIT({op.k})"
    return n


class _Infer:
    def __init__(self, db=None, mode: str = "executor") -> None:
        assert mode in ("executor", "logical"), mode
        self.db = db
        self.mode = mode
        self._path: list[str] = []

    def err(self, message: str) -> PlanTypeError:
        return PlanTypeError(message, path=tuple(self._path))

    # -- expressions -----------------------------------------------------

    def expr_type(self, e: A.Expr, env: Schema) -> ColType:
        if isinstance(e, A.Const):
            if e.typ == "string":
                return ColType("str")
            if e.typ in ("double", "integer"):
                return ColType("num")
            if e.typ == "boolean":
                return ColType("bool")
            raise self.err(f"constant of unknown type {e.typ!r}")
        if isinstance(e, A.Param):
            try:
                return ColType({"str": "str", "num": "num",
                                "date": "date"}[e.typ])
            except KeyError:
                raise self.err(
                    f"parameter ${e.idx} of unknown type {e.typ!r}"
                ) from None
        if isinstance(e, A.Var):
            t = env.get(e.n)
            if t is None:
                raise self.err(
                    f"undefined column $${e.n}: the operators below "
                    f"never produce it (available: "
                    f"{self._fmt_env(env)})")
            return t
        if isinstance(e, A.Some):
            return self._some_type(e, env)
        assert isinstance(e, A.Call), e
        return self._call_type(e, env)

    @staticmethod
    def _fmt_env(env: Schema) -> str:
        if not env:
            return "none"
        return ", ".join(f"$${n}:{t}" for n, t in sorted(env.items()))

    def _arg(self, e: A.Call, i: int, env: Schema) -> ColType:
        if i >= len(e.args):
            raise self.err(f"{e.fn}() wants {i + 1}+ arguments, "
                           f"got {len(e.args)}")
        return self.expr_type(e.args[i], env)

    def _call_type(self, e: A.Call, env: Schema) -> ColType:
        fn = e.fn
        if fn in ("treat", "promote", "iterate",
                  "sort-distinct-nodes-asc-or-atomics",
                  "sort-nodes-asc-or-atomics",
                  "distinct-nodes-or-atomics"):
            # representation no-ops (and scalar iterate pass-through)
            return self._arg(e, 0, env)
        if fn == "boolean":
            # EBV: identity on this representation — the *inner* type
            # flows through, SELECT enforces boolness at the operator
            return self._arg(e, 0, env)
        if fn == "child":
            base = self._arg(e, 0, env)
            nm = e.args[1].value if isinstance(e.args[1], A.Const) else "?"
            if base.seq:
                base = base.item()      # logical: step maps over items
            if base.kind not in ("node", "atom"):
                raise self.err(
                    f"path step child::{nm} over a {base} column "
                    f"(only node values have children)")
            # a child may be absent for a valid row -> nullable
            return ColType("node", base.table, nullable=True,
                           seq=base.seq)
        if fn == "data":
            base = self._arg(e, 0, env)
            if base.kind in ("node", "atom"):
                return dataclasses.replace(base, kind="atom")
            return base
        if fn == "decimal":
            base = self._arg(e, 0, env)
            if base.item().kind not in _NUM_OK:
                raise self.err(f"decimal() over a {base} column")
            return ColType("num", nullable=base.nullable)
        if fn == "string":
            base = self._arg(e, 0, env)
            if base.item().kind not in _SID_OK:
                raise self.err(f"string() over a {base} column")
            return ColType("str", nullable=base.nullable)
        if fn == "dateTime":
            a = e.args[0]
            if isinstance(a, A.Const):
                if not _DATE_LIT_RE.match(str(a.value)):
                    raise self.err(
                        f"unparseable dateTime literal {a.value!r}")
                return ColType("date")
            base = self._arg(e, 0, env)
            if base.item().kind == "bool":
                raise self.err(f"dateTime() over a {base} column")
            return ColType("date", nullable=base.nullable)
        if fn in ("year-from-dateTime", "month-from-dateTime",
                  "day-from-dateTime"):
            base = self._arg(e, 0, env)
            if base.item().kind not in _DATE_OK:
                raise self.err(f"{fn}() over a {base} column "
                               f"(not a packed date)")
            return ColType("num", nullable=base.nullable)
        if fn == "upper-case":
            base = self._arg(e, 0, env)
            if base.item().kind not in _SID_OK:
                raise self.err(f"upper-case() over a {base} column")
            return ColType("str", nullable=base.nullable)
        if fn in ("value-eq", "value-ne", "value-lt", "value-le",
                  "value-gt", "value-ge", "algebricks-eq"):
            a = self._arg(e, 0, env)
            b = self._arg(e, 1, env)
            self._check_cmp(fn, a, b)
            return ColType("bool")
        if fn in ("and", "or"):
            for i in range(2):
                t = self._arg(e, i, env)
                if t.kind != "bool":
                    raise self.err(
                        f"{fn}() wants boolean operands, got {t}")
            return ColType("bool")
        if fn == "not":
            t = self._arg(e, 0, env)
            if t.kind != "bool":
                raise self.err(f"not() wants a boolean operand, got {t}")
            return ColType("bool")
        if fn in ("add", "subtract", "multiply", "divide"):
            for i in range(2):
                t = self._arg(e, i, env)
                if t.item().kind not in _NUM_OK:
                    raise self.err(f"{fn}() over a {t} column "
                                   f"(arithmetic needs numeric values)")
            return ColType("num",
                           nullable=any(self._arg(e, i, env).nullable
                                        for i in range(2)))
        if fn in ("doc", "collection"):
            table = self._literal_str(e.args[0]) if e.args else None
            if (self.db is not None and table is not None
                    and table not in self.db.collections):
                raise self.err(
                    f"unknown collection {table!r} (loaded: "
                    f"{sorted(self.db.collections)})")
            return ColType("node", table, seq=(fn == "collection"))
        if fn == "create_sequence":
            t = self._arg(e, 0, env)
            return dataclasses.replace(t, seq=True)
        if fn in _AGG_FNS:
            # scalar aggregate call (pre-rewrite §4.2.2 wrapper shape)
            if fn != "count":
                t = self._arg(e, 0, env)
                if t.item().kind not in _NUM_OK:
                    raise self.err(
                        f"{fn.upper()}() over a {t} column "
                        f"(aggregates reduce numeric values)")
            return ColType("num")
        raise self.err(f"unknown function {fn}()")

    def _literal_str(self, e: A.Expr) -> Optional[str]:
        """Unwrap promote/data around a string Const (the normalized
        doc/collection argument shape)."""
        while isinstance(e, A.Call) and e.fn in ("promote", "data"):
            e = e.args[0]
        return str(e.value) if isinstance(e, A.Const) else None

    def _check_cmp(self, fn: str, a: ColType, b: ColType) -> None:
        """Mirror ExprEval._cmp's domain choice: a static kind pair
        that would make atom_sid/atom_date/atom_num raise at trace
        time is rejected here."""
        a, b = a.item(), b.item()
        if "str" in (a.kind, b.kind):
            bad = a if a.kind not in _SID_OK else (
                b if b.kind not in _SID_OK else None)
            if bad is not None:
                raise self.err(
                    f"cannot compare ({fn}) a string sid with a "
                    f"{bad} column")
        elif "date" in (a.kind, b.kind):
            bad = a if a.kind not in _DATE_OK else (
                b if b.kind not in _DATE_OK else None)
            if bad is not None:
                raise self.err(
                    f"cannot compare ({fn}) a packed date with a "
                    f"{bad} column")
        elif "num" in (a.kind, b.kind):
            bad = a if a.kind not in _NUM_OK else (
                b if b.kind not in _NUM_OK else None)
            if bad is not None:
                raise self.err(
                    f"cannot compare ({fn}) an f32 number with a "
                    f"{bad} column")
        else:
            for t in (a, b):
                if t.kind == "bool":
                    raise self.err(
                        f"cannot compare ({fn}) boolean values")

    def _some_type(self, e: A.Some, env: Schema) -> ColType:
        src = e.source
        if not (isinstance(src, A.Call) and src.fn == "child"):
            if self.mode == "executor":
                raise self.err(
                    "quantifier source must be a child step over a "
                    "node column (repeated-field index)")
            # logical: path-step subplans not yet inlined — a
            # node-valued source is enough to type the quantifier
            base = self.expr_type(src, env).item()
            if base.kind not in ("node", "atom"):
                raise self.err(
                    f"quantifier source must be node-valued, got "
                    f"{base}")
            kid = ColType("node", base.table, nullable=True)
            t = self.expr_type(e.cond, {**env, e.var: kid})
            if t.kind != "bool":
                raise self.err(
                    f"quantifier condition must be boolean, got {t}")
            return ColType("bool")
        inner, nm = src.args[0], src.args[1]
        if isinstance(inner, A.Call) and inner.fn == "treat":
            inner = inner.args[0]
        base = self.expr_type(inner, env).item()
        if base.kind not in ("node", "atom"):
            raise self.err(
                f"quantifier source child step over a {base} column")
        name = str(nm.value) if isinstance(nm, A.Const) else None
        if (self.db is not None and base.table is not None
                and name is not None):
            coll = self.db.collections.get(base.table)
            if coll is not None and coll.partitions:
                multi = getattr(coll.partitions[0], "multi", None)
                if multi is not None and name not in multi:
                    raise self.err(
                        f"collection {base.table!r} has no repeated-"
                        f"field index for {name!r} (indexed: "
                        f"{sorted(multi)})")
        kid = ColType("node", base.table, nullable=True)
        t = self.expr_type(e.cond, {**env, e.var: kid})
        if t.kind != "bool":
            raise self.err(
                f"quantifier condition must be boolean, got {t}")
        return ColType("bool")

    # -- operators -------------------------------------------------------

    def infer(self, op: A.Op, nts: Optional[Schema] = None) -> Schema:
        self._path.append(op_label(op))
        try:
            return self._visit(op, nts)
        finally:
            self._path.pop()

    def _define(self, s: Schema, var: int, t: ColType) -> Schema:
        if var in s:
            raise self.err(
                f"column $${var} redefined (already {s[var]}, "
                f"now {t})")
        s[var] = t
        return s

    def _visit(self, op: A.Op, nts: Optional[Schema]) -> Schema:
        if isinstance(op, A.EmptyTupleSource):
            return {}
        if isinstance(op, A.NestedTupleSource):
            if nts is None:
                raise self.err(
                    "NESTED-TUPLE-SOURCE outside a SUBPLAN")
            return dict(nts)
        if isinstance(op, A.DataScan):
            s = self.infer(op.child, nts)
            if self.mode == "executor" and s:
                raise self.err(
                    "DATASCAN over a non-trivial input (correlated "
                    "scans are not executable; the optimizer lowers "
                    "them to JOINs)")
            if (self.db is not None
                    and op.collection not in self.db.collections):
                raise self.err(
                    f"unknown collection {op.collection!r} (loaded: "
                    f"{sorted(self.db.collections)})")
            return self._define(s, op.var,
                                ColType("node", op.collection))
        if isinstance(op, A.Assign):
            s = self.infer(op.child, nts)
            return self._define(s, op.var, self.expr_type(op.expr, s))
        if isinstance(op, A.Select):
            s = self.infer(op.child, nts)
            t = self.expr_type(op.expr, s)
            if t.kind != "bool":
                raise self.err(
                    f"SELECT predicate must be boolean, got {t}")
            return s
        if isinstance(op, A.Unnest):
            return self._unnest(op, nts)
        if isinstance(op, A.Subplan):
            return self._subplan(op, nts)
        if isinstance(op, A.Aggregate):
            raise self.err("AGGREGATE outside a SUBPLAN")
        if isinstance(op, A.Join):
            return self._join(op, nts)
        if isinstance(op, A.GroupBy):
            return self._group_by(op, nts)
        if isinstance(op, A.OrderBy):
            s = self.infer(op.child, nts)
            for ke, _desc in op.keys:
                t = self.expr_type(ke, s)
                if t.item().kind == "bool":
                    raise self.err(
                        f"cannot ORDER BY a {t} column (no sort "
                        f"domain for booleans)")
            return s
        if isinstance(op, A.Limit):
            if op.k < 1:
                raise self.err(f"LIMIT must be >= 1, got {op.k}")
            return self.infer(op.child, nts)
        if isinstance(op, A.DistributeResult):
            s = self.infer(op.child, nts)
            for v in op.vars:
                if v not in s:
                    raise self.err(
                        f"result column $${v} is never produced by "
                        f"the plan (available: {self._fmt_env(s)})")
            return s
        raise self.err(f"unknown operator {type(op).__name__}")

    def _unnest(self, op: A.Unnest, nts: Optional[Schema]) -> Schema:
        s = self.infer(op.child, nts)
        e = op.expr
        if isinstance(e, A.Call) and e.fn == "iterate":
            t = self.expr_type(e.args[0], s)
            return self._define(s, op.var, t.item())
        if isinstance(e, A.Call) and e.fn == "child":
            t = self.expr_type(e, s)
            return self._define(s, op.var, t.item())
        raise self.err(
            "unsupported UNNEST expression (iterate or child-chain "
            "only)")

    def _subplan(self, op: A.Subplan, nts: Optional[Schema]) -> Schema:
        outer = self.infer(op.child, nts)
        agg = op.plan
        if not isinstance(agg, A.Aggregate):
            raise self.err(
                "SUBPLAN plan must be rooted at an AGGREGATE")
        self._path.append(op_label(agg))
        try:
            inner = self.infer(agg.child, nts=outer)
            t = self._aggregate_type(agg, inner)
        finally:
            self._path.pop()
        if self.mode == "executor":
            # the executor emits only the aggregate column (central
            # partition); outer columns do not survive the subplan
            return {agg.var: t}
        out = dict(outer)
        return self._define(out, agg.var, t)

    def _aggregate_type(self, agg: A.Aggregate, inner: Schema
                        ) -> ColType:
        e = agg.expr
        if not isinstance(e, A.Call):
            raise self.err("AGGREGATE expression must be a call")
        if e.fn == "create_sequence":
            if self.mode == "executor":
                raise self.err(
                    "SUBPLAN aggregate create_sequence not rewritten "
                    "to a scalar aggregate (run the optimizer)")
            t = self.expr_type(e.args[0], inner)
            return dataclasses.replace(t, seq=True)
        if e.fn in _AGG_FNS:
            if e.fn != "count":
                arg = e.args[0]
                if isinstance(arg, A.Call) and arg.fn == "treat":
                    arg = arg.args[0]
                t = self.expr_type(arg, inner)
                if t.item().kind not in _NUM_OK:
                    raise self.err(
                        f"{e.fn.upper()}() over a {t} column "
                        f"(aggregates reduce numeric values)")
            return ColType("num")
        raise self.err(f"unsupported aggregate function {e.fn}()")

    def _join(self, op: A.Join, nts: Optional[Schema]) -> Schema:
        left = self.infer(op.left, nts)
        right = self.infer(op.right, nts)
        if self.mode == "executor" and not op.hash_keys:
            raise self.err(
                "non-equi JOIN (no hash keys) is not executable; "
                "the optimizer extracts equality conjuncts")
        for le, re_ in (op.hash_keys or ()):
            lt = self.expr_type(le, left).item()
            rt = self.expr_type(re_, right).item()
            for t in (lt, rt):
                if t.kind == "bool":
                    raise self.err(
                        f"JOIN key cannot be a {t} column")
            cats = {"str": "str", "date": "date", "num": "num"}
            lc, rc = cats.get(lt.kind), cats.get(rt.kind)
            if lc is not None and rc is not None and lc != rc:
                raise self.err(
                    f"JOIN key type mismatch: {lt} vs {rt}")
        out = dict(right)
        for v, t in left.items():
            prev = out.get(v)
            if prev is not None and (prev.kind, prev.table) != (
                    t.kind, t.table):
                raise self.err(
                    f"JOIN branches define $${v} with conflicting "
                    f"types {prev} vs {t}")
            # left columns are gathered through the probe match with
            # fill -> nullable
            out[v] = dataclasses.replace(t, nullable=True)
        if op.cond is not None:
            t = self.expr_type(op.cond, out)
            if t.kind != "bool":
                raise self.err(
                    f"JOIN condition must be boolean, got {t}")
        return out

    def _group_by(self, op: A.GroupBy, nts: Optional[Schema]) -> Schema:
        s = self.infer(op.child, nts)
        kt = self.expr_type(op.key_expr, s)
        if kt.item().kind not in _SID_OK:
            raise self.err(
                f"GROUP-BY key must be string-valued (dictionary "
                f"sid), got {kt}")
        out: Schema = {}
        self._define(out, op.key_var, ColType("str"))
        for var, fn, val_e in op.aggs:
            if fn not in _AGG_FNS:
                raise self.err(
                    f"unsupported GROUP-BY aggregate {fn}()")
            if fn != "count":
                t = self.expr_type(val_e, s)
                if t.item().kind not in _NUM_OK:
                    raise self.err(
                        f"{fn.upper()}() over a {t} column "
                        f"(aggregates reduce numeric values)")
            self._define(out, var, ColType("num"))
        return out


# -- public API -------------------------------------------------------------


def infer_schema(plan: A.Op, db=None, mode: str = "executor") -> Schema:
    """Infer the root schema of ``plan``; raises PlanTypeError with an
    operator path on any static type violation."""
    return _Infer(db=db, mode=mode).infer(plan)


def check_param_uses(plan: A.Op, db=None) -> None:
    """Verify every lifted ``Param``'s declared type against its use
    sites: full executor-mode inference over the parameter-erased
    plan, where each ``Param`` types as its declaration (prepared.py
    calls this after lifting/collection)."""
    if any(isinstance(x, A.Param)
           for op in A.walk(plan) for e in A.used_exprs(op)
           for x in _walk_expr(e)):
        infer_schema(plan, db=db, mode="executor")


def _walk_expr(e):
    if e is None:
        return
    yield e
    if isinstance(e, A.Call):
        for a in e.args:
            yield from _walk_expr(a)
    elif isinstance(e, A.Some):
        yield from _walk_expr(e.source)
        yield from _walk_expr(e.cond)
