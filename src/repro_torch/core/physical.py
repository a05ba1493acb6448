"""Physical operators: the logical plan as PyTorch over columnar tiles.

Every operator is a function over a fixed-capacity **Tile** (columns +
validity mask), as in the JAX package's ``core/physical.py``. The JAX
package runs one partition's function under ``vmap``; here the
partitions are a leading ``[P]`` dimension written out: every table
and tile tensor is ``[P, ...]``, and the derived per-string arrays
(``__derived__``), which all partitions share, have no ``[P]``
dimension. A per-partition scalar is a ``[P]`` tensor; a row-invariant
constant stays a 0-d tensor and broadcasts.

Cardinality changes (DATASCAN, UNNEST) produce fixed-capacity index
tiles with an overflow flag — the moral equivalent of Hyracks'
frame-size limit, surfaced instead of crashed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import algebra as A
from repro_torch.core import xdm
from repro_torch.kernels import ref as kref

I32 = torch.int32
F32 = torch.float32
I32_MAX = 2**31 - 1
NEG = -1


# ---------------------------------------------------------------------------
# Device-side table bundle
# ---------------------------------------------------------------------------

def device_tables(db: xdm.Database, device: torch.device,
                  parts: slice = slice(None),
                  derived: Optional[dict] = None) -> dict:
    """Pack a Database into tensors on ``device``:
    {collection: {col: [P, ...]}} plus the shared per-sid derived
    arrays under ``__derived__``. ``parts`` keeps a slice of the
    partitions (spmd mode: one rank's own); ``derived`` is
    ``db.derived()`` when the caller already has it."""
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if derived is None:
        derived = db.derived()
    out: dict[str, Any] = {"__derived__": {
        k: put(v) for k, v in derived.items()}}
    for name, coll in db.collections.items():
        t = coll.padded()
        out[name] = {
            "kind": put(t.kind[parts]), "name": put(t.name[parts]),
            "parent": put(t.parent[parts]),
            "text_sid": put(t.text_sid[parts]),
            "text_num": put(t.text_num[parts]),
            "text_date": put(t.text_date[parts]),
            "field_map": put(t.field_map[parts]),
            "multi": {k: put(v[parts]) for k, v in t.multi.items()},
        }
    return out


def _fill_like(val: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    # fill stays a Python scalar: a tensor made from it on the host
    # would be a blocking host-to-device copy
    mask = idx >= 0
    while mask.dim() < val.dim():
        mask = mask[..., None]
    return torch.where(mask, val, fill)


def _gather(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Per-partition safe gather: arr [P, N, ...], idx [P, ...] ->
    arr[p, idx[p, ...]], with fill where idx < 0."""
    p, n = arr.shape[0], arr.shape[1]
    safe = idx.clamp(0, n - 1).long()
    part = torch.arange(p, device=arr.device).view(
        (p,) + (1,) * (idx.dim() - 1))
    return _fill_like(arr[part, safe], idx, fill)


def _take(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """Safe gather from a shared (partition-free) array: arr [N, ...],
    idx of any shape -> arr[idx], with fill where idx < 0."""
    safe = idx.clamp(0, arr.shape[0] - 1).long()
    return _fill_like(arr[safe], idx, fill)


# ---------------------------------------------------------------------------
# Columns and tiles
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Col:
    """One tile column. ``kind`` is static:
      node  data=int32 row index into ``table``'s node arrays
      atom  data=int32 node index (value not yet projected)
      num / str / date / bool   projected values
      det   detached atom: data=(num, sid, date) triple
      xnode cross-partition node: data=(part, idx, num, sid, date) —
            the "serialized node" of a Hyracks exchange; host-side
            result extraction dereferences (part, idx)
    """
    kind: str
    data: Any
    table: Optional[str] = None


@dataclasses.dataclass
class Tile:
    cols: dict[int, Col]
    valid: torch.Tensor         # bool [P, T]
    overflow: torch.Tensor      # bool [P] — capacity exceeded anywhere


# ---------------------------------------------------------------------------
# Expression compiler
# ---------------------------------------------------------------------------

_CMP = {"value-eq": torch.eq, "value-ne": torch.ne,
        "value-lt": torch.lt, "value-le": torch.le,
        "value-gt": torch.gt, "value-ge": torch.ge,
        "algebricks-eq": torch.eq}
_ARITH = {"add": torch.add, "subtract": torch.sub,
          "multiply": torch.mul, "divide": torch.div}


class ExprEval:
    """Vectorized evaluator for scalar expressions over a tile.

    Compile-time context: the host Database (dictionary lookups for
    string constants and element names) + device tables.
    """

    def __init__(self, db: xdm.Database, tables: dict,
                 device: torch.device, params: tuple = ()):
        self.db = db
        self.tables = tables
        self.device = device
        # prepared-query parameter vector: 0-d tensors on the device
        # (one per algebra.Param slot), so a binding change is a new
        # input, not a new compilation
        self.params = params

    def _scalar(self, value, dtype) -> torch.Tensor:
        # a fill on the device, not a blocking host-to-device copy
        return torch.full((), value, dtype=dtype, device=self.device)

    # -- atom projections
    def _tab(self, col: Col) -> dict:
        assert col.table is not None, "node column lost its table"
        return self.tables[col.table]

    def atom_num(self, col: Col) -> torch.Tensor:
        if col.kind == "num":
            return col.data
        if col.kind == "date":
            return col.data.to(F32)
        if col.kind in ("node", "atom"):
            return _gather(self._tab(col)["text_num"], col.data, np.nan)
        if col.kind == "det":
            return col.data[0]
        if col.kind == "xnode":
            return col.data[2]
        if col.kind == "const":
            return col.data
        raise TypeError(col.kind)

    def atom_sid(self, col: Col) -> torch.Tensor:
        if col.kind == "str":
            return col.data
        if col.kind in ("node", "atom"):
            return _gather(self._tab(col)["text_sid"], col.data, NEG)
        if col.kind == "det":
            return col.data[1]
        if col.kind == "xnode":
            return col.data[3]
        raise TypeError(col.kind)

    def atom_date(self, col: Col) -> torch.Tensor:
        if col.kind == "date":
            return col.data
        if col.kind in ("node", "atom"):
            return _gather(self._tab(col)["text_date"], col.data, NEG)
        if col.kind == "det":
            return col.data[2]
        if col.kind == "xnode":
            return col.data[4]
        raise TypeError(col.kind)

    def detach(self, col: Col) -> Col:
        """Materialize to a (num, sid, date) triple — required before a
        column crosses a partition-exchange boundary (join/gather)."""
        if col.kind in ("det", "xnode"):
            return col
        return Col("det", (self.atom_num(col), self.atom_sid(col),
                           self.atom_date(col)))

    def to_xnode(self, col: Col, part_index: torch.Tensor) -> Col:
        """Serialize a node column for a partition exchange: carry the
        (origin partition, node index) reference plus the projected
        atoms — the analogue of Hyracks serializing the XDM subtree
        into the connector frame. ``part_index`` is [P, 1]."""
        if col.kind not in ("node", "atom"):
            return col
        part = torch.broadcast_to(part_index.to(I32), col.data.shape)
        return Col("xnode", (part, col.data, self.atom_num(col),
                             self.atom_sid(col), self.atom_date(col)),
                   col.table)

    # -- comparisons
    def _cmp(self, fn: str, a: Col, b: Col) -> Col:
        op = _CMP[fn]
        # choose comparison domain by static kinds
        if "str" in (a.kind, b.kind):
            return Col("bool", op(self.atom_sid(a), self.atom_sid(b)))
        if "date" in (a.kind, b.kind):
            return Col("bool", op(self.atom_date(a), self.atom_date(b)))
        if "num" in (a.kind, b.kind) or "const" in (a.kind, b.kind):
            return Col("bool", op(self.atom_num(a), self.atom_num(b)))
        # both atoms/dets: string-compare when both have sids, else num
        sa, sb = self.atom_sid(a), self.atom_sid(b)
        both_str = (sa >= 0) & (sb >= 0)
        r_str = op(sa, sb)
        r_num = op(self.atom_num(a), self.atom_num(b))
        return Col("bool", torch.where(both_str, r_str, r_num))

    def const(self, c: A.Const) -> Col:
        if c.typ == "string":
            sid = self.db.strings.lookup(str(c.value))
            if sid < 0:
                sid = -3   # absent: matches nothing
            return Col("str", self._scalar(sid, I32))
        if c.typ in ("double", "integer"):
            return Col("const", self._scalar(float(c.value), F32))
        if c.typ == "boolean":
            return Col("bool", self._scalar(c.value == "true", torch.bool))
        raise TypeError(c)

    def param(self, e: A.Param) -> Col:
        p = self.params[e.idx]
        if e.typ == "str":
            return Col("str", p)
        if e.typ == "num":
            return Col("const", p)
        if e.typ == "date":
            return Col("date", p)
        raise TypeError(e.typ)

    def eval(self, e: A.Expr, env: dict[int, Col]) -> Col:
        if isinstance(e, A.Const):
            return self.const(e)
        if isinstance(e, A.Param):
            return self.param(e)
        if isinstance(e, A.Var):
            return env[e.n]
        if isinstance(e, A.Some):
            return self.eval_some(e, env)
        assert isinstance(e, A.Call), e
        fn = e.fn
        if fn in ("treat", "promote", "boolean",
                  "sort-distinct-nodes-asc-or-atomics",
                  "sort-nodes-asc-or-atomics",
                  "distinct-nodes-or-atomics"):
            # no-ops on this representation: masks/row-order already
            # encode document order & distinctness; EBV of bool is id
            return self.eval(e.args[0], env)
        if fn == "child":
            base = self.eval(e.args[0], env)
            assert base.kind in ("node", "atom"), base.kind
            nm = str(e.args[1].value)
            f = self.db.names.lookup(nm)
            if f < 0:
                return Col("node", torch.full_like(base.data, NEG),
                           base.table)
            # gather only field f of field_map [P, N, F]
            fm = self._tab(base)["field_map"][:, :, f]
            return Col("node", _gather(fm, base.data, NEG), base.table)
        if fn == "data":
            base = self.eval(e.args[0], env)
            if base.kind in ("node", "atom"):
                return Col("atom", base.data, base.table)
            return base
        if fn == "decimal":
            return Col("num", self.atom_num(self.eval(e.args[0], env)))
        if fn == "string":
            return Col("str", self.atom_sid(self.eval(e.args[0], env)))
        if fn == "dateTime":
            a = e.args[0]
            if isinstance(a, A.Const):       # dateTime("1976-07-04T..")
                m = xdm._DATE_RE.match(str(a.value))
                assert m, a
                packed = xdm.pack_date(int(m.group(1)), int(m.group(2)),
                                       int(m.group(3)))
                return Col("date", self._scalar(packed, I32))
            base = self.eval(a, env)
            if base.kind in ("node", "atom"):
                return Col("date", self.atom_date(base))
            if base.kind == "str":
                der = self.tables["__derived__"]["date_of_sid"]
                return Col("date", _take(der, base.data, NEG))
            return Col("date", base.data.to(I32))
        # floor division and modulo as in jnp, so that a missing date
        # (-1) gives the same numbers
        if fn == "year-from-dateTime":
            d = self.atom_date(self.eval(e.args[0], env))
            return Col("num", torch.div(d, 10000,
                                        rounding_mode="floor").to(F32))
        if fn == "month-from-dateTime":
            d = self.atom_date(self.eval(e.args[0], env))
            m = torch.remainder(torch.div(d, 100, rounding_mode="floor"),
                                100)
            return Col("num", m.to(F32))
        if fn == "day-from-dateTime":
            d = self.atom_date(self.eval(e.args[0], env))
            return Col("num", torch.remainder(d, 100).to(F32))
        if fn == "upper-case":
            s = self.eval(e.args[0], env)
            der = self.tables["__derived__"]["ucase_sid"]
            return Col("str", _take(der, self.atom_sid(s), NEG))
        if fn in _CMP:
            return self._cmp(fn, self.eval(e.args[0], env),
                             self.eval(e.args[1], env))
        if fn in ("and", "or"):
            a = self.eval(e.args[0], env).data
            b = self.eval(e.args[1], env).data
            return Col("bool", (a & b) if fn == "and" else (a | b))
        if fn == "not":
            return Col("bool", ~self.eval(e.args[0], env).data)
        if fn in _ARITH:
            a = self.atom_num(self.eval(e.args[0], env))
            b = self.atom_num(self.eval(e.args[1], env))
            if fn == "divide" and isinstance(e.args[1],
                                             (A.Const, A.Param)):
                # division by a literal or a parameter is a multiply by
                # its float32 reciprocal, as the JAX package computes a
                # lifted divisor: a prepared plan then gives the baked
                # plan's bits
                return Col("num", a * (1.0 / b))
            return Col("num", _ARITH[fn](a, b))
        if fn == "iterate":
            # singleton pass-through (the executor handles sequence
            # unnesting at the operator level)
            return self.eval(e.args[0], env)
        raise NotImplementedError(fn)

    def eval_some(self, e: A.Some, env: dict[int, Col]) -> Col:
        """Quantified expression over a repeated child field: evaluate
        the condition on the [P, T, W] expansion and OR-reduce."""
        got = self._multi_source(e.source, env)
        assert got is not None, f"some: unsupported source {e.source}"
        base, nm = got
        tab = self._tab(base)
        assert nm in tab["multi"], (
            f"collection {base.table!r} lacks a repeated-field index for "
            f"{nm!r}; add it to multi_names at shred time")
        mm = tab["multi"][nm]                       # [P, N, W]
        kids = _gather(mm, base.data, NEG)          # [P, T, W]
        kid_col = Col("node", kids, base.table)
        cond = self.eval(e.cond, {**env, e.var: kid_col})
        ok = cond.data & (kids >= 0)
        return Col("bool", ok.any(dim=-1))

    def _multi_source(self, e: A.Expr, env: dict[int, Col]
                      ) -> Optional[tuple[Col, str]]:
        """child(treat($v,..), "name") -> (eval($v), "name")."""
        if isinstance(e, A.Call) and e.fn == "child":
            inner, nm = e.args
            if isinstance(inner, A.Call) and inner.fn == "treat":
                inner = inner.args[0]
            base = self.eval(inner, env)
            return base, str(nm.value)
        return None


# ---------------------------------------------------------------------------
# Path matching (DATASCAN / UNNEST-child machinery)
# ---------------------------------------------------------------------------

def path_match_mask(tab: dict, names: xdm.NameDict,
                    steps: tuple[str, ...]) -> torch.Tensor:
    """Vectorized child-path evaluation over the node table: mask
    [P, N] of nodes matching /step1/step2/... from the document roots."""
    kind, name, parent = tab["kind"], tab["name"], tab["parent"]
    frontier = kind == xdm.DOCUMENT
    for s in steps:
        f = names.lookup(s)
        up = _gather(frontier, parent, False)
        frontier = up & (name == (f if f >= 0 else -99))
    return frontier


def round_cap(n: int, multiple: int = 16) -> int:
    """Round a capacity up to an alignment multiple. Bucketing caps
    keeps the number of distinct compiled shapes (and therefore plan-
    cache entries) small as estimates drift."""
    n = max(int(n), multiple)
    return ((n + multiple - 1) // multiple) * multiple


def estimate_scan_cap(db: xdm.Database, collection: str,
                      steps: tuple[str, ...]) -> Optional[int]:
    """Statistics-based per-partition capacity for a DATASCAN/UNNEST of
    ``/step1/step2/...`` over ``collection``: the build-time per-tag
    count is an exact upper bound for child-path matches (every match
    is a node with the path's final tag). None when no stats exist."""
    stats = getattr(db, "stats", {}).get(collection)
    if stats is None:
        return None
    bound = stats.path_match_bound(db.names, tuple(steps))
    if bound is None:
        return None
    return round_cap(bound)


def estimate_group_cap(db: xdm.Database, tag: str) -> Optional[int]:
    """Statistics-based segment capacity for a GROUP-BY whose key is
    drawn from ``.../tag`` children: the build-time global distinct-
    value count is an exact upper bound on the number of groups. Maxed
    over collections (the key expression alone does not always name
    its source collection); None when no statistics exist."""
    stats = getattr(db, "stats", {})
    if not stats:
        return None
    bounds = [s.group_key_bound(db.names, tag) for s in stats.values()]
    return round_cap(max(bounds))


def estimate_topk_cap(db: xdm.Database, tag: str,
                      k: Optional[int]) -> Optional[int]:
    """Statistics-based ordered-output capacity for an ORDER BY /
    LIMIT over a GROUP-BY on ``.../tag`` keys: the sorted tile never
    needs more rows than min(limit k, distinct group keys) — the same
    ``tag_distinct`` bound that presizes the segment space, clipped by
    the top-k pushdown. None when no statistics exist and no limit is
    given (the full segment width then keeps results exact)."""
    bound = estimate_group_cap(db, tag)
    if k is not None:
        cap = round_cap(k)
        return min(cap, bound) if bound is not None else cap
    return bound


def row_counts(mask: torch.Tensor) -> torch.Tensor:
    """Running count of set entries along each partition row of a bool
    [P, N] mask, int32. One scan over the flattened mask minus each
    row's starting offset: a scan along dim 1 of a [P, N] tensor with
    few long rows runs on a handful of blocks and took ~8 ms at
    [4, 5M] on an H100 (``benchmarks/torch_trace.py``)."""
    p, n = mask.shape
    dtype = I32 if p * n < 2**31 else torch.int64
    flat = torch.cumsum(mask.reshape(-1), dim=0, dtype=dtype).view(p, n)
    start = torch.zeros((p, 1), dtype=dtype, device=mask.device)
    start[1:, 0] = flat[:-1, -1]
    return (flat - start).to(I32)


def rows_from_mask(mask: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask [P, N] -> (idx [P, cap] int32, valid [P, cap],
    overflow [P]). Row order is node-table order == document order
    (rule 4.1.1's free sort). The j-th output slot is the first
    position whose running set-bit count reaches j+1 (prefix count +
    batched binary search)."""
    p, n = mask.shape
    cap = min(cap, n)
    pos = row_counts(mask)
    total = pos[:, -1]
    want = torch.arange(1, cap + 1, dtype=I32, device=mask.device)
    idx = torch.searchsorted(pos, want.expand(p, cap).contiguous())
    valid = want[None, :] <= total[:, None]
    idx = torch.where(valid, idx, torch.full_like(idx, NEG))
    return idx.to(I32), valid, total > cap


def topk_rows(sort_keys: list[tuple[torch.Tensor, bool]],
              valid: torch.Tensor, cap: Optional[int],
              limit: Optional[int], fused: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-bounded segmented sort: the ORDER BY / top-k core.

    ``sort_keys`` are (key [P, N], descending) pairs, most significant
    first; keys are numeric (i32 lexicographic string ranks, packed
    dates, or f32 aggregate values). Valid rows sort first by the
    keys; invalid rows sink to the end. Returns (idx [P, C],
    valid [P, C], overflow [P]) with C = min(cap or N, N): the gather
    order of the sorted tile. ``limit`` masks output rows past the top
    k; ``overflow`` is raised iff the C output slots cannot hold every
    row the query needs — min(#valid, limit).

    ``fused=True`` routes the selection through the segment top-k
    entry point (kernels.ops.segment_topk — the CUDA kernel on a CUDA
    tensor); otherwise the plain stable-sort chain runs. Both get the
    same operand stack and agree index for index."""
    p, n = valid.shape
    cap = n if cap is None else min(int(cap), n)
    ops = []
    for key, desc in sort_keys:
        if key.dtype == torch.bool:
            key = key.to(I32)
        k = torch.where(valid, key, torch.zeros((), dtype=key.dtype,
                                                device=key.device))
        ops.append(-k if desc else k)
    flag = (~valid).to(I32)
    if fused:
        from repro_torch.kernels import ops as kops
        idx = kops.segment_topk((flag,) + tuple(ops), cap)
    else:
        idx = kref.segment_topk((flag,) + tuple(ops), cap)
    out_valid = valid.gather(1, idx.long())
    if limit is not None:
        out_valid = out_valid & (torch.arange(cap, device=valid.device)
                                 < limit)[None, :]
    n_valid = valid.sum(dim=1)
    need = n_valid if limit is None else n_valid.clamp(max=limit)
    return idx, out_valid, need > cap
