"""Saxon stand-in: single-threaded tree-walking XQuery interpreter.

Evaluates the *source AST* directly over the host NodeTables with
Python loops and full XQuery-ish dynamic semantics — no algebra, no
rewrites, no vectorization. This is the differential-testing oracle
(optimized SPMD plan must produce identical results) and the
single-node comparison baseline of the paper's Fig. 5 (§5.3.1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np

from repro_torch.core import xdm
from repro_torch.core import xqparser as xq
from repro_torch.core.executor import node_fingerprint

Node = tuple[str, int, int]      # (collection, partition, node index)


@dataclasses.dataclass
class SaxonLike:
    db: xdm.Database

    # -- node helpers --------------------------------------------------------

    def _table(self, node: Node) -> xdm.NodeTable:
        return self.db.collection(node[0]).partitions[node[1]]

    def children(self, node: Node, name: str) -> list[Node]:
        coll, p, idx = node
        t = self._table(node)
        f = self.db.names.lookup(name)
        if f < 0:
            return []
        out = []
        js = np.nonzero(t.parent == idx)[0]
        for j in js:
            if t.name[j] == f:
                out.append((coll, p, int(j)))
        return out

    def string_value(self, node: Node) -> str:
        return node_fingerprint(self.db, node[0], node[1], node[2])

    def atomize(self, item: Any) -> Any:
        if isinstance(item, tuple) and len(item) == 3 \
                and isinstance(item[0], str):
            t = self._table(item)
            idx = item[2]
            sid = int(t.text_sid[idx])
            if sid >= 0:
                return self.db.strings.str(sid)
            num = float(t.text_num[idx])
            if not np.isnan(num):
                return num
            return self.string_value(item)
        return item

    # -- dynamic values ---------------------------------------------------------

    def _num(self, v: Any) -> float:
        if isinstance(v, (int, float)):
            return float(v)
        return float(str(v))

    def _cmp_pair(self, a: Any, b: Any):
        a, b = self.atomize(a), self.atomize(b)
        if isinstance(a, (int, float)) or isinstance(b, (int, float)):
            try:
                return self._num(a), self._num(b)
            except ValueError:
                return str(a), str(b)
        return str(a), str(b)

    # -- evaluation -------------------------------------------------------------

    def collection_nodes(self, path: str) -> list[Node]:
        coll = self.db.collection(path)
        out = []
        for p, t in enumerate(coll.partitions):
            for i in np.nonzero(t.kind == xdm.DOCUMENT)[0]:
                out.append((path, p, int(i)))
        return out

    def eval(self, ast: xq.Ast, env: dict[str, Any]) -> list[Any]:
        """Returns a sequence (python list) of items."""
        if isinstance(ast, xq.Lit):
            return [ast.value]
        if isinstance(ast, xq.Ref):
            v = env[ast.name]
            return v if isinstance(v, list) else [v]
        if isinstance(ast, xq.Path):
            seq = self.eval(ast.base, env)
            for step in ast.steps:
                nxt: list[Node] = []
                for item in seq:
                    nxt.extend(self.children(item, step))
                seq = nxt       # document order is per-partition scan
            return seq
        if isinstance(ast, xq.Seq):
            out = []
            for it in ast.items:
                out.extend(self.eval(it, env))
            return out
        if isinstance(ast, xq.Bin):
            return [self._eval_bin(ast, env)]
        if isinstance(ast, xq.SomeQ):
            src = self.eval(ast.source, env)
            for item in src:
                if self._ebv(self.eval(ast.cond, {**env, ast.var: item})):
                    return [True]
            return [False]
        if isinstance(ast, xq.Fn):
            return self._eval_fn(ast, env)
        if isinstance(ast, xq.Flwor):
            if any(cl[0] == "groupby" for cl in ast.clauses):
                return self._flwor_grouped(ast, env)
            return list(self._flwor(ast.clauses, 0, env, ast.ret))
        raise NotImplementedError(str(ast))

    def _flwor(self, clauses, i, env, ret) -> Iterator[Any]:
        if i == len(clauses):
            yield from self.eval(ret, env)
            return
        cl = clauses[i]
        if cl[0] == "for":
            for item in self.eval(cl[2], env):
                yield from self._flwor(clauses, i + 1,
                                       {**env, cl[1]: item}, ret)
        elif cl[0] == "let":
            yield from self._flwor(clauses, i + 1,
                                   {**env, cl[1]: self.eval(cl[2], env)},
                                   ret)
        elif cl[0] == "where":
            if self._ebv(self.eval(cl[1], env)):
                yield from self._flwor(clauses, i + 1, env, ret)
        else:
            raise ValueError(cl)

    # -- group-by (XQuery 3.0-lite; matches translator._group_by) -------------

    _AGG_NAMES = ("count", "sum", "min", "max", "avg")

    def _flwor_grouped(self, ast: xq.Flwor, env) -> list[Any]:
        """FLWOR with a group-by clause: materialize the tuple stream
        of the pre-group clauses, bucket by the key's *string value*
        (the executor groups on dictionary sids — exact string
        identity), then evaluate HAVING ``where`` clauses, ``order
        by`` (aggregate keys, grouping-key string as the final
        ascending tiebreak — the executor's total order) and
        ``limit``, and return items per group with aggregate-call
        semantics."""
        idx = next(i for i, cl in enumerate(ast.clauses)
                   if cl[0] == "groupby")
        pre, (_, gname, key_ast) = ast.clauses[:idx], ast.clauses[idx]
        post = ast.clauses[idx + 1:]
        envs: list[dict] = []

        def collect(i: int, e: dict) -> None:
            if i == len(pre):
                envs.append(e)
                return
            cl = pre[i]
            if cl[0] == "for":
                for item in self.eval(cl[2], e):
                    collect(i + 1, {**e, cl[1]: item})
            elif cl[0] == "let":
                collect(i + 1, {**e, cl[1]: self.eval(cl[2], e)})
            elif cl[0] == "where":
                if self._ebv(self.eval(cl[1], e)):
                    collect(i + 1, e)
            else:
                raise ValueError(cl)

        collect(0, env)
        groups: dict[str, list[dict]] = {}
        for e in envs:
            ks = self.eval(key_ast, e)
            if not ks:
                continue
            k = self._key_str(ks[0])
            if k is None:       # no string value -> no group (sid < 0)
                continue
            groups.setdefault(k, []).append(e)
        items = (ast.ret.items if isinstance(ast.ret, xq.Seq)
                 else (ast.ret,))
        havings, order_keys, limits = [], [], []
        for cl in post:
            if cl[0] == "where":
                havings.append(cl)
            elif cl[0] == "orderby":
                order_keys.append((cl[1], cl[2]))
            elif cl[0] == "limit":
                limits.append(cl[1])
            else:       # the oracle must fail loudly, never guess
                raise NotImplementedError(
                    f"post-group clause {cl[0]!r}")
        kept: list[tuple[str, list[dict], dict]] = []
        for k, members in groups.items():
            genv = {**env, gname: k}
            keep = True
            for cl in havings:
                cond = self._agg_substitute(cl[1], members)
                if not self._ebv(self.eval(cond, genv)):
                    keep = False
                    break
            if keep:
                kept.append((k, members, genv))
        if order_keys:
            # multi-pass stable sort, least-significant key first; the
            # grouping-key string is the final ascending tiebreak (the
            # translator appends it on the device side too), so the
            # ordering is total and engine-independent
            kept.sort(key=lambda g: g[0])
            for key_ast, desc in reversed(order_keys):
                def val(g):
                    k, members, genv = g
                    e = self._agg_substitute(key_ast, members)
                    got = self.eval(e, genv)
                    v = self.atomize(got[0]) if got else float("nan")
                    return self._num(v) if not isinstance(v, str) else v
                kept.sort(key=val, reverse=desc)
        if limits:
            kept = kept[:min(limits)]
        out: list[Any] = []
        for k, members, genv in kept:
            for item in items:
                out.extend(self.eval(
                    self._agg_substitute(item, members), genv))
        return out

    def _key_str(self, item: Any) -> Any:
        """Grouping key as the executor sees it: the node's dictionary
        string (None when the node has no string value)."""
        if isinstance(item, tuple) and len(item) == 3 \
                and isinstance(item[0], str):
            t = self._table(item)
            sid = int(t.text_sid[item[2]])
            return self.db.strings.str(sid) if sid >= 0 else None
        return str(item)

    def _agg_substitute(self, a: xq.Ast, members: list[dict]) -> xq.Ast:
        """Replace aggregate calls with their per-group value (as a
        literal) so the remaining expression evaluates normally in the
        group environment."""
        if isinstance(a, xq.Fn) and a.name in self._AGG_NAMES:
            vals: list[Any] = []
            for me in members:
                vals.extend(self.eval(a.args[0], me))
            vals = [self.atomize(x) for x in vals]
            if a.name == "count":
                return xq.Lit(float(len(vals)), "double")
            nums = [self._num(v) for v in vals]
            v = {"sum": sum(nums),
                 "min": min(nums) if nums else float("nan"),
                 "max": max(nums) if nums else float("nan"),
                 "avg": (sum(nums) / len(nums)) if nums
                 else float("nan")}[a.name]
            return xq.Lit(float(v), "double")
        if isinstance(a, xq.Bin):
            return xq.Bin(a.op, self._agg_substitute(a.left, members),
                          self._agg_substitute(a.right, members))
        if isinstance(a, xq.Fn):
            return xq.Fn(a.name, tuple(self._agg_substitute(x, members)
                                       for x in a.args))
        if isinstance(a, xq.Seq):
            return xq.Seq(tuple(self._agg_substitute(x, members)
                                for x in a.items))
        return a

    def _ebv(self, seq: list) -> bool:
        if not seq:
            return False
        v = seq[0]
        if isinstance(v, bool):
            return v
        return bool(seq)

    def _eval_bin(self, ast: xq.Bin, env) -> Any:
        if ast.op in ("and", "or"):
            le = self._ebv(self.eval(ast.left, env))
            if ast.op == "and":
                return le and self._ebv(self.eval(ast.right, env))
            return le or self._ebv(self.eval(ast.right, env))
        ls = self.eval(ast.left, env)
        rs = self.eval(ast.right, env)
        if ast.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            if not ls or not rs:
                return False
            a, b = self._cmp_pair(ls[0], rs[0])
            import operator
            ops = {"eq": operator.eq, "ne": operator.ne,
                   "lt": operator.lt, "le": operator.le,
                   "gt": operator.gt, "ge": operator.ge}
            return ops[ast.op](a, b)
        a = self._num(self.atomize(ls[0]))
        b = self._num(self.atomize(rs[0]))
        return {"add": a + b, "sub": a - b, "mul": a * b,
                "div": a / b}[ast.op]

    def _eval_fn(self, ast: xq.Fn, env) -> list[Any]:
        name = ast.name
        if name == "collection":
            (arg,) = ast.args
            assert isinstance(arg, xq.Lit)
            return self.collection_nodes(str(arg.value))
        if name == "doc":
            (arg,) = ast.args
            assert isinstance(arg, xq.Lit)
            return self.collection_nodes(str(arg.value))[:1]
        if name == "data":
            return [self.atomize(x) for x in self.eval(ast.args[0], env)]
        if name == "decimal":
            return [self._num(self.atomize(x))
                    for x in self.eval(ast.args[0], env)]
        if name == "string":
            return [str(self.atomize(x))
                    for x in self.eval(ast.args[0], env)]
        if name == "upper-case":
            return [str(self.atomize(x)).upper()
                    for x in self.eval(ast.args[0], env)]
        if name == "dateTime":
            out = []
            for x in self.eval(ast.args[0], env):
                s = str(self.atomize(x))
                m = xdm._DATE_RE.match(s)
                assert m, s
                out.append(("dt", xdm.pack_date(int(m.group(1)),
                                                int(m.group(2)),
                                                int(m.group(3)))))
            return out
        if name in ("year-from-dateTime", "month-from-dateTime",
                    "day-from-dateTime"):
            (arg,) = ast.args
            vals = self.eval(arg, env)
            out = []
            for v in vals:
                assert isinstance(v, tuple) and v[0] == "dt", v
                packed = v[1]
                if name.startswith("year"):
                    out.append(packed // 10000)
                elif name.startswith("month"):
                    out.append(packed // 100 % 100)
                else:
                    out.append(packed % 100)
            return out
        if name in ("count", "sum", "min", "max", "avg"):
            seq = [self.atomize(x) for x in self.eval(ast.args[0], env)]
            if name == "count":
                return [float(len(seq))]
            nums = [self._num(x) for x in seq]
            if name == "sum":
                return [float(sum(nums))]
            if not nums:
                return []
            if name == "min":
                return [float(min(nums))]
            if name == "max":
                return [float(max(nums))]
            return [float(sum(nums) / len(nums))]
        raise NotImplementedError(name)

    # -- public API -------------------------------------------------------------

    def run(self, query: str) -> list[Any]:
        ast = xq.parse(query)
        seq = self.eval(ast, {})
        # canonicalize: nodes -> fingerprints (same as ResultSet)
        out = []
        for item in seq:
            if isinstance(item, tuple) and len(item) == 3 \
                    and isinstance(item[0], str):
                out.append(self.string_value(item))
            elif isinstance(item, tuple) and item and item[0] == "dt":
                out.append(item[1])
            else:
                out.append(item)
        return out

    def run_rows(self, query: str) -> list[tuple]:
        """For multi-item returns: group flat results into row tuples
        of the return arity."""
        ast = xq.parse(query)
        arity = 1
        if isinstance(ast, xq.Flwor) and isinstance(ast.ret, xq.Seq):
            arity = len(ast.ret.items)
        flat = self.run(query)
        assert len(flat) % arity == 0, (len(flat), arity)
        return [tuple(flat[i:i + arity])
                for i in range(0, len(flat), arity)]
