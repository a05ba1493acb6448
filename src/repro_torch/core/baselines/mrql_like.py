"""Apache-MRQL-on-Hadoop stand-in: staged MapReduce execution.

The port of the JAX package's ``core/baselines/mrql_like.py``. Same
optimized logical plan as the VXQuery executor, but run the way a
MapReduce stack runs it (paper §2, §5.3.2):

  * map tasks = per-partition operator evaluation, one partition at a
    time (the executor's operators over that partition's tables, with
    a ``Comm`` of one partition), eagerly on the executor's device —
    the card unless ``device="cpu"`` is asked for;
  * every job boundary **materializes to host numpy** (Hadoop's
    write-map-output-to-disk; mapper and reducer share no state);
  * joins are **Grace hash joins**: map-side partitioning, host
    shuffle, reducer-side per-bucket join — versus the executor's
    hybrid hash (build side stays device-resident, one fused program);
  * aggregation over joins happens in the reducer (host), as Hadoop
    reducers do.

This is a structural analogue, not a Hadoop deployment (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import algebra as A
from repro_torch.core import xdm
from repro_torch.core.executor import (Comm, EvalCtx, ExecConfig, Executor,
                                       node_fingerprint,
                                       resolve_kernel_policy)
from repro_torch.core.physical import ExprEval


def _host(x: torch.Tensor) -> np.ndarray:
    """A map task's [1, ...] tensor -> its one partition's host array
    (the shuffle write); a row-invariant 0-d value stays 0-d."""
    a = x.detach().cpu().numpy()
    return a[0] if a.ndim else a


@dataclasses.dataclass
class MrqlResult:
    _rows: list[tuple]
    overflow: bool
    jobs: int

    def rows(self) -> list[tuple]:
        return self._rows

    def scalar(self) -> float:
        assert len(self._rows) == 1 and len(self._rows[0]) == 1
        return float(self._rows[0][0])


class MrqlLike:
    """``MrqlLike(db)`` runs its map tasks on the GPU and raises without
    one; ``device="cpu"`` runs them on the CPU."""

    def __init__(self, db: xdm.Database,
                 config: Optional[ExecConfig] = None, device=None):
        self.db = db
        self.config = config or ExecConfig()
        self.ex = Executor(self.db, self.config, device=device)
        self.local_comm = Comm(1, self.ex.device)
        self._cfg = self.config        # resolved per run()

    # -- task plumbing -----------------------------------------------------

    def _eval_at(self, op: A.Op, part: int):
        """One map task's operators over partition ``part`` alone:
        (evaluator, tile with a leading dimension of 1)."""
        ev = ExprEval(self.db, self.ex.partition_tables(part),
                      self.ex.device)
        with torch.no_grad():
            tile = self.ex._eval(op, ev, self.local_comm, None,
                                 EvalCtx(self._cfg))
        return ev, tile

    def _map_task(self, op: A.Op, part: int,
                  key_exprs: tuple = ()) -> dict:
        """Evaluate a local operator chain eagerly; materialize tile +
        join keys to host (the shuffle write)."""
        ev, tile = self._eval_at(op, part)
        cols = {}
        for v, c in tile.cols.items():
            if c.kind in ("node", "atom"):
                d = ev.detach(c)
                cols[v] = {"kind": "node", "idx": _host(c.data),
                           "table": c.table,
                           "num": _host(d.data[0]),
                           "sid": _host(d.data[1]),
                           "date": _host(d.data[2])}
            elif c.kind == "det":
                cols[v] = {"kind": "det",
                           "num": _host(c.data[0]),
                           "sid": _host(c.data[1]),
                           "date": _host(c.data[2])}
            else:
                cols[v] = {"kind": c.kind, "data": _host(c.data)}
        keys = []
        for ke in key_exprs:
            kc = ev.eval(ke, tile.cols)
            sid = _host(torch.broadcast_to(ev.atom_sid(kc),
                                           tile.valid.shape)
                        ).astype(np.int64)
            date = _host(torch.broadcast_to(ev.atom_date(kc),
                                            tile.valid.shape)
                         ).astype(np.int64)
            keys.append(np.where(sid >= 0, sid, (1 << 40) + date))
        return {"cols": cols, "valid": _host(tile.valid),
                "overflow": bool(tile.overflow.any()),
                "keys": keys, "part": part}

    # -- value decoding -------------------------------------------------------

    def _value(self, col: dict, part: int, r: int):
        if col["kind"] == "node":
            return node_fingerprint(self.db, col["table"], part,
                                    int(col["idx"][r]))
        if col["kind"] == "det":
            sid = int(col["sid"][r])
            if sid >= 0:
                return self.db.strings.str(sid)
            return float(col["num"][r])
        if col["kind"] == "num":
            return float(col["data"][r])
        if col["kind"] == "str":
            sid = int(col["data"][r])
            return self.db.strings.str(sid) if sid >= 0 else None
        raise TypeError(col["kind"])

    def _num_of(self, col: dict, r: int) -> float:
        if col["kind"] in ("node", "det"):
            return float(col["num"][r])
        return float(col["data"][r])

    # -- wrapper resolution -----------------------------------------------------

    @staticmethod
    def _resolve(wrappers: list[A.Op], var: int
                 ) -> tuple[int, float]:
        """Follow top-level iterate/divide wrappers down to the
        producing var; returns (source var, post-scale divisor)."""
        scale = 1.0
        for w in wrappers:
            dv = A.defined_var(w)
            if dv != var:
                continue
            e = w.expr
            if isinstance(e, A.Call) and e.fn == "iterate" \
                    and isinstance(e.args[0], A.Var):
                var = e.args[0].n
            elif isinstance(e, A.Var):
                var = e.n
            elif isinstance(e, A.Call) and e.fn == "divide" \
                    and isinstance(e.args[0], A.Var):
                scale *= float(e.args[1].value)
                var = e.args[0].n
        return var, scale

    # -- driver -------------------------------------------------------------------

    def run(self, plan: A.Op) -> MrqlResult:
        assert isinstance(plan, A.DistributeResult)
        p = self.ex.num_partitions
        # a probe inside a map task takes the executor's kernel route on
        # the card, as the executor's own runs do
        self._cfg = resolve_kernel_policy(plan, self.config, self.ex.device)
        body = plan.child
        # ordered grouped output: LIMIT/ORDER-BY peel off the top and
        # run as a final host sort job after the reduce (the MapReduce
        # "total order" job), versus the executor's fused capacity-
        # bounded segmented sort
        limit_k: Optional[int] = None
        order_keys: Optional[tuple] = None
        if isinstance(body, A.Limit):
            limit_k = body.k
            body = body.child
        if isinstance(body, A.OrderBy):
            order_keys = body.keys
            body = body.child
        wrappers: list[A.Op] = []
        while isinstance(body, (A.Unnest, A.Assign)):
            wrappers.append(body)
            body = body.child

        # group-by plans: optional HAVING SELECTs directly above the
        # GROUP-BY operator
        having: list[A.Expr] = []
        sel_body = body
        while isinstance(sel_body, A.Select):
            having.append(sel_body.expr)
            sel_body = sel_body.child
        if isinstance(sel_body, A.GroupBy):
            if any(isinstance(o, A.Join) for o in A.walk(sel_body.child)):
                raise NotImplementedError(
                    "MrqlLike group-by maps are partition-local; a "
                    "grouped join would need a join job first")
            return self._run_groupby(plan, wrappers, having, sel_body, p,
                                     order_keys=order_keys,
                                     limit_k=limit_k)
        if order_keys is not None or limit_k is not None:
            raise NotImplementedError(
                "MrqlLike order by / limit apply to grouped plans")

        agg: Optional[A.Aggregate] = None
        if isinstance(body, A.Subplan):
            agg = body.plan
            assert isinstance(agg, A.Aggregate)
            inner = agg.child
        else:
            inner = body

        if isinstance(inner, A.Join):
            return self._run_join(plan, wrappers, agg, inner, p)
        if agg is not None:
            return self._run_aggregate(plan, wrappers, agg, p)
        return self._run_selection(plan, wrappers, inner, p)

    def _run_selection(self, plan, wrappers, body, p) -> MrqlResult:
        rows, overflow = [], False
        for part in range(p):                     # one map job
            t = self._map_task(body, part)
            overflow |= t["overflow"]
            for r in np.nonzero(t["valid"])[0]:
                row = []
                for v in plan.vars:
                    src, _ = self._resolve(wrappers, v)
                    row.append(self._value(t["cols"][src], part, int(r)))
                rows.append(tuple(row))
        return MrqlResult(rows, overflow, jobs=1)

    def _run_aggregate(self, plan, wrappers, agg, p) -> MrqlResult:
        fn = agg.expr.fn
        arg = agg.expr.args[0]
        if isinstance(arg, A.Call) and arg.fn == "treat":
            arg = arg.args[0]
        partials, overflow = [], False
        for part in range(p):                     # map job: local agg
            ev, tile = self._eval_at(agg.child, part)
            overflow |= bool(tile.overflow.any())
            valid = _host(tile.valid)
            if fn == "count":
                partials.append(("c", float(valid.sum())))
            else:
                v = _host(torch.broadcast_to(
                    ev.atom_num(ev.eval(arg, tile.cols)), tile.valid.shape))
                ok = valid & ~np.isnan(v)
                partials.append((fn, v[ok]))
        total = self._combine(fn, partials)       # reduce job
        (var,) = plan.vars
        _, scale = self._resolve(wrappers, var)
        return MrqlResult([(total / scale,)], overflow, jobs=2)

    def _run_groupby(self, plan, wrappers, having: list[A.Expr],
                     gb: A.GroupBy, p, order_keys=None,
                     limit_k: Optional[int] = None) -> MrqlResult:
        """Staged MapReduce group-by: map tasks emit flat (key sid,
        values) records per partition (the shuffle write), one reducer
        per key aggregates on the host, HAVING predicates run in the
        reducer. Mirrors how MRQL lowers a group-by to a MapReduce
        job — versus the executor's fused segmented-reduce + psum.
        ``order_keys``/``limit_k`` add a final host sort-and-slice job
        (multi-pass stable sort, least-significant key first; key
        exprs evaluate in the per-group env like HAVING predicates)."""
        shuffle: list[tuple] = []
        overflow = False
        agg_vals = [(v, fn, e) for v, fn, e in gb.aggs if fn != "count"]
        for part in range(p):                     # map job
            ev, tile = self._eval_at(gb.child, part)
            overflow |= bool(tile.overflow.any())
            valid = _host(tile.valid)
            shape = tile.valid.shape
            sid = _host(torch.broadcast_to(
                ev.atom_sid(ev.eval(gb.key_expr, tile.cols)), shape))
            cols = {v: _host(torch.broadcast_to(
                ev.atom_num(ev.eval(e, tile.cols)), shape))
                for v, _, e in agg_vals}
            ok = valid & (sid >= 0)
            for r in np.nonzero(ok)[0]:
                shuffle.append((int(sid[r]),
                                {v: np.float32(cols[v][r])
                                 for v in cols}))
        groups: dict[int, list[dict]] = {}
        for s, rec in shuffle:                    # reduce job
            groups.setdefault(s, []).append(rec)
        rows: list[tuple] = []
        for s in sorted(groups):
            recs = groups[s]
            env: dict[int, Any] = {gb.key_var: self.db.strings.str(s)}
            for v, fn, _ in gb.aggs:
                if fn == "count":
                    env[v] = float(len(recs))
                    continue
                vals = np.asarray([rec[v] for rec in recs], np.float32)
                vals = vals[~np.isnan(vals)]
                if fn == "sum":
                    env[v] = float(vals.sum())
                elif fn == "min":
                    env[v] = float(vals.min()) if vals.size else np.inf
                elif fn == "max":
                    env[v] = float(vals.max()) if vals.size \
                        else -np.inf
                else:   # avg — executor semantics: sum over count
                    env[v] = float(vals.sum()) / max(len(recs), 1)
            if not all(self._host_ebv(h, env) for h in having):
                continue
            row = []
            for v in plan.vars:
                src, scale = self._resolve(wrappers, v)
                if src not in env:
                    raise NotImplementedError(
                        "MrqlLike post-group wrappers support only "
                        "iterate/divide shapes; cannot resolve "
                        f"result var {v}")
                x = env[src]
                row.append(x / scale if isinstance(x, float)
                           and scale != 1.0 else x)
            rows.append((env, tuple(row)))
        jobs = 2
        if order_keys is not None:
            for e, desc in reversed(order_keys):
                rows.sort(key=lambda g, e=e: self._host_value(e, g[0]),
                          reverse=desc)
            jobs += 1       # the final total-order job
        if limit_k is not None:
            rows = rows[:limit_k]
        return MrqlResult([r for _, r in rows], overflow, jobs=jobs)

    def _host_ebv(self, e: A.Expr, env: dict) -> bool:
        return bool(self._host_value(e, env))

    def _host_value(self, e: A.Expr, env: dict):
        """Reducer-side predicate evaluation over per-group values
        (HAVING filters: comparisons/logic over key + aggregates)."""
        if isinstance(e, A.Const):
            if e.typ in ("double", "integer"):
                return float(e.value)
            if e.typ == "boolean":
                return str(e.value) == "true"
            return str(e.value)
        if isinstance(e, A.Var):
            return env[e.n]
        assert isinstance(e, A.Call), e
        if e.fn == "boolean":
            return self._host_value(e.args[0], env)
        if e.fn in ("and", "or"):
            a = bool(self._host_value(e.args[0], env))
            b = bool(self._host_value(e.args[1], env))
            return (a and b) if e.fn == "and" else (a or b)
        if e.fn == "not":
            return not self._host_value(e.args[0], env)
        import operator
        cmps = {"value-eq": operator.eq, "value-ne": operator.ne,
                "value-lt": operator.lt, "value-le": operator.le,
                "value-gt": operator.gt, "value-ge": operator.ge,
                "algebricks-eq": operator.eq}
        if e.fn in cmps:
            a = self._host_value(e.args[0], env)
            b = self._host_value(e.args[1], env)
            if isinstance(a, float) or isinstance(b, float):
                return cmps[e.fn](float(a), float(b))
            return cmps[e.fn](str(a), str(b))
        ariths = {"add": operator.add, "subtract": operator.sub,
                  "multiply": operator.mul, "divide": operator.truediv}
        if e.fn in ariths:
            return ariths[e.fn](float(self._host_value(e.args[0], env)),
                                float(self._host_value(e.args[1], env)))
        raise NotImplementedError(e.fn)

    @staticmethod
    def _combine(fn: str, partials) -> float:
        if fn == "count":
            return float(sum(x for _, x in partials))
        vals = np.concatenate([v for _, v in partials]) \
            if partials else np.zeros(0)
        if fn == "sum":
            return float(vals.sum())
        if fn == "min":
            return float(vals.min())
        if fn == "max":
            return float(vals.max())
        if fn == "avg":
            return float(vals.mean())
        raise ValueError(fn)

    def _run_join(self, plan, wrappers, agg, join: A.Join, p
                  ) -> MrqlResult:
        lkeys = tuple(le for le, _ in join.hash_keys)
        rkeys = tuple(re for _, re in join.hash_keys)
        # map job 1: build side; map job 2: probe side (shuffle writes)
        left = [self._map_task(join.left, part, lkeys)
                for part in range(p)]
        right = [self._map_task(join.right, part, rkeys)
                 for part in range(p)]
        overflow = any(t["overflow"] for t in left + right)

        # shuffle + reducer-side grace join (host)
        def flatten(tasks):
            keys = np.stack([np.concatenate([t["keys"][i] for t in tasks])
                             for i in range(len(tasks[0]["keys"]))])
            valid = np.concatenate([t["valid"] for t in tasks])
            parts = np.concatenate([np.full(t["valid"].shape, t["part"])
                                    for t in tasks])
            rows = np.concatenate([np.arange(t["valid"].shape[0])
                                   for t in tasks])
            return keys, valid, parts, rows

        bk, bvalid, bpart, brow = flatten(left)
        pk, pvalid, ppart, prow = flatten(right)
        comb_b = bk[0] if bk.shape[0] == 1 else bk[0] * (1 << 41) + bk[1]
        comb_p = pk[0] if pk.shape[0] == 1 else pk[0] * (1 << 41) + pk[1]
        comb_b = np.where(bvalid, comb_b, np.int64(-(1 << 60)))
        lut = {int(k): i for i, k in enumerate(comb_b) if bvalid[i]}
        match = np.asarray([lut.get(int(k), -1) if v else -1
                            for k, v in zip(comb_p, pvalid)])
        sel = match >= 0
        jobs = 3   # 2 map jobs + 1 reduce (join) job

        if agg is None:
            rows = []
            for i in np.nonzero(sel)[0]:
                b = match[i]
                row = []
                for v in plan.vars:
                    src, _ = self._resolve(wrappers, v)
                    if src in right[0]["cols"]:
                        t = right[int(ppart[i])]
                        row.append(self._value(t["cols"][src],
                                               int(ppart[i]),
                                               int(prow[i])))
                    else:
                        t = left[int(bpart[b])]
                        row.append(self._value(t["cols"][src],
                                               int(bpart[b]),
                                               int(brow[b])))
                rows.append(tuple(row))
            return MrqlResult(rows, overflow, jobs)

        # aggregate over the joined stream (reducer-side)
        fn = agg.expr.fn
        arg = agg.expr.args[0]
        if isinstance(arg, A.Call) and arg.fn == "treat":
            arg = arg.args[0]
        vals = []
        for i in np.nonzero(sel)[0]:
            b = match[i]
            env_val = self._agg_value(arg, left, right,
                                      int(bpart[b]), int(brow[b]),
                                      int(ppart[i]), int(prow[i]))
            if env_val is not None and not np.isnan(env_val):
                vals.append(env_val)
        jobs += 1
        total = self._combine(fn if fn != "count" else "count",
                              [(fn, np.asarray(vals))] if fn != "count"
                              else [("c", float(len(vals)))])
        (var,) = plan.vars
        _, scale = self._resolve(wrappers, var)
        return MrqlResult([(total / scale,)], overflow, jobs)

    def _agg_value(self, e: A.Expr, left, right, bp, br, pp, pr
                   ) -> Optional[float]:
        """Evaluate the aggregate's argument expression on one joined
        row (reducer-side scalar evaluation)."""
        if isinstance(e, A.Var):
            col, part, row = self._locate(e.n, left, right, bp, br, pp, pr)
            return self._num_of(col, row)
        if isinstance(e, A.Call):
            if e.fn == "data":
                return self._agg_value(e.args[0], left, right,
                                       bp, br, pp, pr)
            if e.fn in ("add", "subtract", "multiply", "divide"):
                a = self._agg_value(e.args[0], left, right, bp, br, pp, pr)
                b = self._agg_value(e.args[1], left, right, bp, br, pp, pr)
                if e.fn == "add":
                    return a + b
                if e.fn == "subtract":
                    return a - b
                if e.fn == "multiply":
                    return a * b
                return a / b
        raise NotImplementedError(str(e))

    def _locate(self, var: int, left, right, bp, br, pp, pr):
        if var in right[0]["cols"]:
            return right[pp]["cols"][var], pp, pr
        return left[bp]["cols"][var], bp, br
