"""Plan executor: logical plan -> one eager PyTorch function.

Execution model: a query compiles to a function over the node tables
of all P partitions at once. Where the JAX package runs one partition's
function under ``jax.vmap(axis_name="data")``, every tensor here carries
a leading ``[P]`` dimension, and the collectives of a Hyracks job become
reductions over that dimension (``Comm``): psum for two-step
aggregation, all_gather for the hybrid-hash build broadcast, an
all_gather + own-slot select for grace-style repartition.

"Compile" in this slice builds an eager closure over the device tables;
nothing is traced or captured. The raw-output dict it returns has the
layout of the JAX ``Executor._outputs`` (``valid`` and ``var{v}`` as
[P, T], tuples for ``det``/``xnode`` columns, one [P] flag per stage),
so port and reference compare dict to dict.

Entry points run on the GPU unless the caller asks for the CPU:
``Executor(db)`` takes ``device="cuda"`` and raises where there is no
CUDA device; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import algebra as A
from repro_torch.core import xdm
from repro_torch.core.physical import (Col, ExprEval, Tile, _gather, _take,
                                       device_tables, path_match_mask,
                                       row_counts, rows_from_mask, topk_rows)
from repro_torch.kernels import ref as kref

I32 = torch.int32
F32 = torch.float32
I32_MAX = 2**31 - 1
_LATER = "ROADMAP.md, modules to port: "


@dataclasses.dataclass
class ExecConfig:
    scan_cap: Optional[int] = None        # None: padded table size
    join_cap: Optional[int] = None        # probe-side output capacity
                                          # (None: uncompacted probe width)
    group_cap: Optional[int] = None       # group-by segment capacity
                                          # (None: full string dictionary)
    topk_cap: Optional[int] = None        # ordered-output capacity: the
                                          # ORDER BY / LIMIT sorted tile
                                          # width (None: the child tile's
                                          # full segment width)
    join_strategy: str = "broadcast"      # broadcast | repartition
    join_bucket: int = 4                  # hash-bucket probe width
    # Kernel-route knobs (the JAX package's use_pallas_join and
    # use_pallas_segments) are tri-state: None defers to
    # ``resolve_kernel_policy`` at compile time; True/False pins the
    # route. False runs the plain PyTorch routes on any device.
    use_kernel_join: Optional[bool] = None      # join probe kernel
    use_kernel_segments: Optional[bool] = None  # fused group-by/top-k
                                                # segment kernels

    def signature(self) -> tuple:
        """Every config field in declaration order, derived from
        ``dataclasses.fields`` — a new capacity knob joins the
        plan-cache key by construction rather than by remembering to
        extend a hand-maintained tuple."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))

    def cap_key(self) -> tuple:
        """The fields that change compiled shapes/semantics — the
        plan-cache key component (service.py)."""
        return self.signature()


# Executor-side overflow-flag registry: for every capacity-bounded
# stage, the ExecConfig knob that bounds it -> the output flag that
# reports its saturation. EvalCtx accumulation, `_outputs`, and
# ResultSet attributes are all driven from this table.
OVERFLOW_FLAGS: dict[str, str] = {
    "scan_cap": "overflow_scan",
    "join_bucket": "overflow_join",
    "join_cap": "overflow_join_cap",
    "group_cap": "overflow_group_cap",
    "topk_cap": "overflow_topk_cap",
}


def resolve_kernel_policy(plan: A.Op, cfg: ExecConfig,
                          device: torch.device) -> ExecConfig:
    """Resolve the tri-state kernel knobs for one compilation.

    * ``use_kernel_segments``: True — the fused segment route (one
      aggregate pass for every value column; top-k selection). The one
      exception is a plan that sorts at *full width* (an OrderBy with
      ``topk_cap=None``): a whole-segment-space sort, outside the
      bounded-tile contract of the selection kernel, keeps the plain
      stable sort.
    * ``use_kernel_join``: True on a CUDA device, where the probe
      kernel runs; False on the CPU, where the sorted-hash probe is
      the fast route (as in the JAX package on a CPU).

    On the CPU the segment route runs the kernels' plain versions.
    Pure function of (plan, cfg, device); never mutates ``cfg``."""
    seg, join = cfg.use_kernel_segments, cfg.use_kernel_join
    if join is None:
        join = device.type == "cuda"
    if seg is None:
        full_width_sort = cfg.topk_cap is None and any(
            isinstance(op, A.OrderBy) for op in A.walk(plan))
        seg = not full_width_sort
    if seg == cfg.use_kernel_segments and join == cfg.use_kernel_join:
        return cfg
    return dataclasses.replace(cfg, use_kernel_segments=seg,
                               use_kernel_join=join)


def example_params(param_specs: tuple, batch: Optional[int] = None,
                   device="cpu") -> tuple:
    """Canonical example arguments, one per spec, of the dtypes and
    shapes ``prepared.bind_params`` (0-d) and ``prepared.stack_params``
    ([B]-leading) give at serving time: float32 for "num", int32 for
    "str"/"date"."""
    shape = () if batch is None else (batch,)
    return tuple(torch.zeros(shape, dtype=F32 if spec.typ == "num"
                             else I32, device=device)
                 for spec in param_specs)


@dataclasses.dataclass
class EvalCtx:
    """Per-run evaluation context: the active config plus per-stage
    overflow accumulators ([P] bool each), one list per
    OVERFLOW_FLAGS entry, so an adaptive layer can regrow exactly the
    capacity that saturated."""
    cfg: ExecConfig
    ovf: dict[str, list] = dataclasses.field(
        default_factory=lambda: {f: [] for f in OVERFLOW_FLAGS.values()})
    # profile mode (Executor.compile(profile=True)): per-op [P] valid-row
    # counts keyed by the plan's pre-order index, plus the host-side
    # meta dict the run fills in (obs/profile.py joins it with the
    # static plan). None on normal compiles — the warm path never pays
    # for profiling.
    prof: Optional[dict] = None          # pre-order index -> [P] count
    op_index: Optional[dict] = None      # id(op) -> pre-order index
    prof_meta: Optional[dict] = None     # filled at run time

    def note(self, flag: str, value: torch.Tensor) -> None:
        """Record one stage's overflow predicate under its registry
        flag (unregistered flags are a programming error)."""
        self.ovf[flag].append(value)


class Comm:
    """Collectives over the leading partition dimension: what
    ``lax.psum``/``all_gather``/``axis_index`` give each partition under
    ``vmap``, computed for all partitions at once."""

    def __init__(self, num_partitions: int, device: torch.device):
        self.p = num_partitions
        self.device = device

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(dim=0, keepdim=True).expand_as(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[P, ...] -> [P, P, ...]: every partition sees the stack."""
        return x.unsqueeze(0).expand((self.p,) + tuple(x.shape))

    def index(self) -> torch.Tensor:
        """[P, 1]: each partition's own index, shaped to broadcast."""
        return torch.arange(self.p, device=self.device).view(self.p, 1)

    def size(self) -> int:
        return self.p


# ---------------------------------------------------------------------------
# Join machinery
# ---------------------------------------------------------------------------

_HASH_MUL = 2654435761          # < 2**32: uint32 multiply, emulated below


def _hash_u32(keys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The JAX package's uint32 key mix, emulated exactly in int64:
    h = ((h ^ k) * 2654435761) mod 2**32; h ^= h >> 15. The multiply is
    split into 16-bit halves so no int64 product overflows. Returns
    the unsigned 32-bit value in an int64 tensor."""
    h = torch.zeros(keys[0].shape, dtype=torch.int64,
                    device=keys[0].device)
    for k in keys:
        x = h ^ (k.to(torch.int64) & 0xFFFFFFFF)
        h = (x * (_HASH_MUL & 0xFFFF)
             + (((x * (_HASH_MUL >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
        h = h ^ (h >> 15)
    return h


def _hash_keys(keys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Mix int32 key columns into one int32 hash (verified exactly at
    probe time, so collisions cost a bucket slot, not correctness)."""
    h = _hash_u32(keys)
    return torch.where(h >= 2**31, h - 2**32, h).to(I32)


def hash_join_probe(build_keys: tuple[torch.Tensor, ...],
                    build_valid: torch.Tensor,
                    probe_keys: tuple[torch.Tensor, ...],
                    probe_valid: torch.Tensor,
                    bucket: int,
                    use_kernel: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match each probe row to a build row with equal keys.

    build [P, NB], probe [P, NP] -> (build_pos [P, NP] int32 with -1 for
    no match, matched [P, NP] bool, bucket_overflow [P] bool). Build
    keys are assumed unique among valid rows (M:1 join — the paper's
    queries). Sorted-hash + verified bucket probe, the plain route;
    ``use_kernel`` takes the exact probe entry point instead."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.hash_join_probe(build_keys, build_valid, probe_keys,
                                    probe_valid)
    nb = build_keys[0].shape[1]
    hb = _hash_keys(build_keys)
    hb = torch.where(build_valid, hb, torch.full_like(hb, I32_MAX))
    hs, order = torch.sort(hb, dim=1, stable=True)
    hp = _hash_keys(probe_keys)
    lo = torch.searchsorted(hs, hp)
    hi = torch.searchsorted(hs, hp, right=True)
    bucket_overflow = ((hi - lo) > bucket).any(dim=1) & probe_valid.any(dim=1)
    pos = torch.full(probe_keys[0].shape, -1, dtype=I32,
                     device=probe_valid.device)
    for j in range(bucket):
        cand = (lo + j).clamp(0, nb - 1)
        bidx = order.gather(1, cand)
        ok = (lo + j) < hi
        for bk, pk in zip(build_keys, probe_keys):
            ok = ok & (bk.gather(1, bidx) == pk)
        ok = ok & build_valid.gather(1, bidx) & probe_valid
        pos = torch.where((pos < 0) & ok, bidx.to(I32), pos)
    return pos, pos >= 0, bucket_overflow


# dense-compare segment mapping limit (the JAX package measured its
# crossover with searchsorted on a CPU; both give the same segments)
SEG_COMPARE_CAP_MAX = 256


def _sorted_distinct(x: torch.Tensor, k: int) -> torch.Tensor:
    """Per partition, the smallest ``k`` distinct values of ``x``
    [P, N] below int32-max, ascending, padded with int32-max — what
    ``jnp.unique(x, size=k, fill_value=int32max)`` gives when int32-max
    marks invalid entries: one sort, then a cumsum-rank compaction via
    batched searchsorted."""
    p, n = x.shape
    xs, _ = torch.sort(x, dim=1)
    isnew = torch.ones_like(xs, dtype=torch.bool)
    isnew[:, 1:] = xs[:, 1:] != xs[:, :-1]
    isnew &= xs < I32_MAX
    rank = row_counts(isnew)                   # 1-based, steps at news
    want = torch.arange(1, k + 1, dtype=I32, device=x.device)
    idx = torch.searchsorted(rank, want.expand(p, k).contiguous())
    vals = xs.gather(1, idx.clamp(0, n - 1))
    return torch.where(want[None, :] <= rank[:, -1:], vals,
                       torch.full_like(vals, I32_MAX))


def _capped_uniques(masked_sid: torch.Tensor, k: int,
                    comm: Comm) -> torch.Tensor:
    """Globally consistent smallest ``k`` distinct sids (invalid rows
    pre-masked to int32-max), big-padded — the capped group
    dictionary, [P, k] with equal rows. Compacts per partition first
    (the global smallest k distinct values are each among some
    partition's smallest k distinct), then all-gathers only [P, k]."""
    local = _sorted_distinct(masked_sid, k)
    gathered = comm.all_gather(local)
    return _sorted_distinct(gathered.reshape(comm.p, -1), k)


def _flat(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """all_gather then merge the source-partition dimension:
    [P, N, ...] -> [P, P * N, ...]."""
    return comm.all_gather(x).reshape((comm.p, -1) + tuple(x.shape[2:]))


def _exchange(keys: tuple, valid, cols: dict, comm: Comm,
              dest) -> tuple[tuple, Any, dict]:
    """Partition exchange. ``dest=None``: broadcast (all_gather, the
    hybrid-hash build). Otherwise keep only rows hashed to this
    partition (grace repartition, built from all_gather + own-slot
    select)."""
    out_keys = tuple(_flat(k, comm) for k in keys)
    v = _flat(valid, comm)
    if dest is not None:
        v = v & (_flat(dest, comm) == comm.index())
    out_cols = {}
    for var, c in cols.items():
        if c.kind in ("det", "xnode"):
            out_cols[var] = Col(c.kind, tuple(_flat(d, comm) for d in c.data),
                                c.table)
        else:
            out_cols[var] = Col(c.kind, _flat(c.data, comm), c.table)
    return out_keys, v, out_cols


def _fill_for(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return np.nan if dtype == F32 else -1


def _regather(c: Col, idx: torch.Tensor) -> Col:
    """A tile column re-gathered by per-partition row indices idx
    (-1: fill); row-invariant scalars pass through."""
    if c.kind in ("det", "xnode"):
        return Col(c.kind, tuple(_gather(d, idx, _fill_for(d.dtype))
                                 for d in c.data), c.table)
    if c.data.dim() == 0:
        return c    # row-invariant scalar (const/param)
    return Col(c.kind, _gather(c.data, idx, _fill_for(c.data.dtype)),
               c.table)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class PlanError(ValueError):
    pass


def resolve_device(device) -> torch.device:
    """``None`` means the GPU; the CPU runs only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class Executor:
    """Compiles logical plans against a Database and runs them on one
    device (``device=None``: the GPU)."""

    def __init__(self, db: xdm.Database, config: ExecConfig = None,
                 device=None):
        self.db = db
        self.config = config or ExecConfig()
        self.device = resolve_device(device)
        self.tables = device_tables(db, self.device)
        parts = {len(c.partitions) for c in db.collections.values()}
        assert len(parts) == 1, "collections must agree on partitioning"
        self.num_partitions = parts.pop()
        # observability for the service layer's cache assertions
        self.compile_count = 0      # Executor.compile invocations

    # -- plan compilation ----------------------------------------------------

    def compile(self, plan: A.Op, mode: str = "sim",
                config: Optional[ExecConfig] = None,
                param_specs: tuple = (), batch: Optional[int] = None,
                profile: bool = False, aot: bool = False,
                donate: bool = False) -> "CompiledPlan":
        """Returns a CompiledPlan whose fn maps tables -> the raw-output
        dict; the static column schema is filled in on each call.
        ``config`` overrides the executor's default ExecConfig for this
        compilation only (the service recompiles one plan with grown
        capacities against the same device tables).

        ``param_specs`` enables the prepared-query calling convention:
        the plan may hold ``algebra.Param`` leaves, and fn takes
        ``(tables, params)`` with one 0-d tensor per spec — a binding
        change is a new argument, never a new compilation. ``batch=B``
        makes fn take [B]-leading parameter tensors and evaluate the B
        bindings in turn, stacking every output to [B, P, ...]: the
        bindings share one call and one host copy of the outputs, not
        one device pass.

        ``profile=True`` adds a per-operator valid-row count to the
        outputs (``prof_rows`` [P, ops], one slot per pre-order plan op
        that executes unfused) — the runtime half of
        ``QueryService.explain(profile=True)``.

        "Compile" builds an eager closure; nothing is traced or
        captured. Only the partition-simulating ``sim`` mode is ported;
        ``spmd``, ``aot`` and ``donate`` wait for later slices and
        raise."""
        if mode != "sim":
            raise NotImplementedError(
                f"mode={mode!r} is not ported yet ({_LATER}item 6, "
                "SPMD mode)")
        if aot or donate:
            raise NotImplementedError(
                f"aot/donate are not ported yet ({_LATER}item 4, "
                "core/persist.py)")
        if batch is not None and not param_specs:
            raise ValueError("batched compilation needs parameters")
        cfg = resolve_kernel_policy(plan, config or self.config,
                                    self.device)
        self.compile_count += 1
        schema: dict[int, tuple] = {}
        prof_meta: Optional[dict] = {} if profile else None
        op_index = ({id(op): i for i, op in enumerate(A.walk(plan))}
                    if profile else None)

        def local(tables: dict, params: tuple) -> dict:
            ev = ExprEval(self.db, tables, self.device, params=params)
            comm = Comm(self.num_partitions, self.device)
            ctx = (EvalCtx(cfg, prof={}, op_index=op_index,
                           prof_meta=prof_meta) if profile
                   else EvalCtx(cfg))
            with torch.no_grad():
                tile = self._eval(plan, ev, comm, None, ctx)
                return self._outputs(plan, tile, ev, schema, ctx, comm)

        if batch is None:
            def fn(tables: dict, params: tuple = ()) -> dict:
                return local(tables, tuple(params))
        else:
            def fn(tables: dict, params: tuple) -> dict:
                outs = [local(tables, tuple(p[b] for p in params))
                        for b in range(batch)]
                return {k: (tuple(torch.stack([o[k][i] for o in outs])
                                  for i in range(len(v)))
                            if isinstance(v, tuple) else
                            torch.stack([o[k] for o in outs]))
                        for k, v in outs[0].items()}

        return CompiledPlan(fn, schema, plan, cfg,
                            param_specs=tuple(param_specs), batch=batch,
                            profile_meta=prof_meta)

    def run(self, plan: A.Op, mode: str = "sim",
            config: Optional[ExecConfig] = None) -> "ResultSet":
        return self.run_compiled(self.compile(plan, mode=mode,
                                              config=config))

    def run_raw(self, cp: "CompiledPlan",
                params: Optional[tuple] = None) -> dict:
        """The raw-output dict of one (unbatched) run, as device
        tensors."""
        if cp.batch is not None:
            raise RuntimeError("batched plans go through "
                               "run_compiled_batch")
        if cp.param_specs:
            if params is None or len(params) != len(cp.param_specs):
                raise ValueError(
                    f"plan expects {len(cp.param_specs)} parameters, "
                    f"got {None if params is None else len(params)}")
            return cp.fn(self.tables, tuple(params))
        return cp.fn(self.tables)

    def run_compiled(self, cp: "CompiledPlan",
                     params: Optional[tuple] = None) -> "ResultSet":
        """Execute an already-compiled plan against the bound tables and
        decode the result on the host. Parameterized plans take their
        binding via ``params`` (0-d tensors matching
        ``cp.param_specs``)."""
        return ResultSet(self.db, cp.plan, to_numpy(self.run_raw(cp, params)),
                         cp.schema, profile_meta=cp.profile_meta)

    def run_compiled_batch(self, cp: "CompiledPlan", stacked: tuple,
                           count: int) -> list["ResultSet"]:
        """One batched call: ``stacked`` holds [B]-leading parameter
        tensors (B = cp.batch); the first ``count`` slices are real
        requests, the rest padding. The [B, P, ...] outputs reach the
        host in one copy each. Returns one ResultSet per real
        request."""
        assert cp.batch is not None and count <= cp.batch
        raw = to_numpy(cp.fn(self.tables, tuple(stacked)))

        def take(v, b):
            return tuple(d[b] for d in v) if isinstance(v, tuple) \
                else v[b]

        return [ResultSet(self.db, cp.plan,
                          {k: take(v, b) for k, v in raw.items()},
                          cp.schema, profile_meta=cp.profile_meta)
                for b in range(count)]

    # -- recursive evaluation -------------------------------------------------

    def _trivial_tile(self) -> Tile:
        p = self.num_partitions
        return Tile(cols={},
                    valid=torch.ones((p, 1), dtype=torch.bool,
                                     device=self.device),
                    overflow=torch.zeros(p, dtype=torch.bool,
                                         device=self.device))

    def _eval(self, op: A.Op, ev: ExprEval, comm: Comm,
              nts_input: Optional[Tile], ctx: EvalCtx) -> Tile:
        tile = self._eval_op(op, ev, comm, nts_input, ctx)
        if ctx.prof is not None:
            # profile mode: record each op's per-partition valid-row
            # count. Ops that execute fused into a parent (OrderBy
            # under Limit, Aggregate under Subplan) never pass through
            # here and stay absent — obs/profile marks them fused.
            idx = ctx.op_index.get(id(op))
            if idx is not None:
                ctx.prof[idx] = tile.valid.reshape(
                    self.num_partitions, -1).sum(dim=1, dtype=I32)
        return tile

    def _eval_op(self, op: A.Op, ev: ExprEval, comm: Comm,
                 nts_input: Optional[Tile], ctx: EvalCtx) -> Tile:
        if isinstance(op, A.EmptyTupleSource):
            return self._trivial_tile()
        if isinstance(op, A.NestedTupleSource):
            return nts_input if nts_input is not None \
                else self._trivial_tile()
        if isinstance(op, A.DataScan):
            below = self._eval(op.child, ev, comm, nts_input, ctx)
            if below.cols:
                raise PlanError("DATASCAN over non-trivial input "
                                "(correlated scan not supported)")
            tab = ev.tables.get(op.collection)
            if tab is None:
                known = sorted(k for k in ev.tables if k != "__derived__")
                raise PlanError(f"unknown collection {op.collection!r}; "
                                f"known: {known}")
            mask = path_match_mask(tab, self.db.names, op.path)
            cap = ctx.cfg.scan_cap or tab["kind"].shape[1]
            idx, valid, ovf = rows_from_mask(mask, cap)
            ctx.note("overflow_scan", ovf)
            return Tile(cols={op.var: Col("node", idx, op.collection)},
                        valid=valid, overflow=below.overflow | ovf)
        if isinstance(op, A.Assign):
            t = self._eval(op.child, ev, comm, nts_input, ctx)
            t.cols[op.var] = ev.eval(op.expr, t.cols)
            return t
        if isinstance(op, A.Select):
            t = self._eval(op.child, ev, comm, nts_input, ctx)
            b = ev.eval(op.expr, t.cols)
            return Tile(t.cols, t.valid & b.data, t.overflow)
        if isinstance(op, A.Unnest):
            return self._eval_unnest(op, ev, comm, nts_input, ctx)
        if isinstance(op, A.Subplan):
            outer = self._eval(op.child, ev, comm, nts_input, ctx)
            if not isinstance(op.plan, A.Aggregate):
                raise PlanError("SUBPLAN must have been rewritten to an "
                                "aggregate (run the optimizer first)")
            return self._eval_aggregate(op.plan, ev, comm, outer, ctx)
        if isinstance(op, A.Join):
            return self._eval_join(op, ev, comm, nts_input, ctx)
        if isinstance(op, A.GroupBy):
            return self._eval_group_by(op, ev, comm, nts_input, ctx)
        if isinstance(op, A.OrderBy):
            return self._eval_orderby(op, ev, comm, nts_input, ctx,
                                      limit=None)
        if isinstance(op, A.Limit):
            if isinstance(op.child, A.OrderBy):
                # top-k pushdown: the limit fuses into the sort, so the
                # effective output need is k rows, not every valid group
                return self._eval_orderby(op.child, ev, comm,
                                          nts_input, ctx, limit=op.k)
            t = self._eval(op.child, ev, comm, nts_input, ctx)
            keep = row_counts(t.valid) <= op.k
            return Tile(t.cols, t.valid & keep, t.overflow)
        if isinstance(op, A.DistributeResult):
            return self._eval(op.child, ev, comm, nts_input, ctx)
        raise PlanError(f"cannot execute {type(op).__name__}")

    def _eval_group_by(self, op: "A.GroupBy", ev, comm, nts_input,
                       ctx: EvalCtx) -> Tile:
        """Keyed two-step aggregation (XQuery 3.0 group-by, the
        paper's §6 future work): grouping keys are dictionary-encoded
        strings, so the segment space is the string dictionary; the
        local step is a segmented reduce, the global step psums the
        [P, S] partials over the partition dimension.

        ``group_cap`` bounds the segment space with a dense, globally
        consistent dictionary of the observed key sids; a (cap+1)-th
        distinct key raises ``overflow_group_cap``. At cap >= dictionary
        size the full-dictionary layout is used, where overflow is
        impossible.

        The resolved ``use_kernel_segments`` knob picks the fused route
        (capped dictionary by per-partition compaction, one
        ``kernels.ops.segmented_aggregate`` pass for every value
        column) or the legacy route (unique over the gathered keys,
        one scatter pass per aggregate). Both read the same
        ``group_cap`` and raise the same flag."""
        t = self._eval(op.child, ev, comm, nts_input, ctx)
        key = ev.eval(op.key_expr, t.cols)
        sid = torch.broadcast_to(ev.atom_sid(key), t.valid.shape)
        dict_size = len(self.db.strings)
        valid = t.valid & (sid >= 0)
        cap = ctx.cfg.group_cap
        fused = bool(ctx.cfg.use_kernel_segments)
        p = comm.p
        if cap is not None and cap < dict_size:
            # capped segment space: dense dynamic key dictionary
            nseg = cap
            masked = torch.where(valid, sid, torch.full_like(sid, I32_MAX))
            if fused:
                uniq = _capped_uniques(masked, cap + 1, comm)
            else:
                gathered = comm.all_gather(masked).reshape(p, -1)
                uniq = _sorted_distinct(gathered, cap + 1)
            govf = uniq[:, cap] < I32_MAX        # a (cap+1)-th distinct key
            seg_keys = uniq[:, :cap].contiguous()   # ascending, big-padded
            if fused and cap <= SEG_COMPARE_CAP_MAX:
                # == searchsorted-left over the sorted dictionary, as
                # a dense compare
                seg = (sid[:, :, None] > seg_keys[:, None, :]).sum(
                    dim=2, dtype=I32)
            else:
                seg = torch.searchsorted(seg_keys, sid.contiguous()).to(I32)
            seg = seg.clamp(0, cap - 1)
            valid = valid & (seg_keys.gather(1, seg.long()) == sid)
            key_col = torch.where(seg_keys == I32_MAX,
                                  torch.full_like(seg_keys, -1), seg_keys)
        else:
            # full-dictionary segment space: one slot per string sid
            nseg = dict_size
            seg = sid.to(I32)
            govf = torch.zeros(p, dtype=torch.bool, device=sid.device)
            key_col = torch.arange(nseg, dtype=I32, device=sid.device
                                   ).expand(p, nseg)
        ctx.note("overflow_group_cap", govf)
        cols, g_counts = (
            self._group_aggs_fused(op, ev, t, comm, seg, valid, nseg,
                                   key_col)
            if fused else
            self._group_aggs_legacy(op, ev, t, comm, seg, valid, nseg,
                                    key_col))
        out_valid = (g_counts > 0) & (comm.index() == 0)
        return Tile(cols, out_valid, t.overflow | govf)

    def _group_aggs_fused(self, op, ev, t, comm, seg, valid, nseg,
                          key_col):
        """One fused segmented pass for every aggregate column: stack
        the value columns [P, N, C], run ``kernels.ops.segmented_
        aggregate`` once (count/sum/min/max together), then the global
        step (psum for counts/sums, pmin/pmax for extrema)."""
        from repro_torch.kernels import ops as kops
        specs = []                       # (var, fn, value column idx)
        vcols = []
        for var, fn, val_e in op.aggs:
            if fn == "count":
                specs.append((var, fn, -1))
                continue
            if fn not in ("sum", "avg", "min", "max"):
                raise PlanError(f"group-by aggregate {fn}")
            v = ev.atom_num(ev.eval(val_e, t.cols))
            specs.append((var, fn, len(vcols)))
            vcols.append(torch.broadcast_to(v, seg.shape))
        p, n = seg.shape
        if vcols:
            vals = torch.stack(vcols, dim=2).contiguous()
            # NaN-valued rows are excluded from every aggregate value
            # (count still counts them: avg = sum(non-NaN)/count(valid))
            oks = valid[:, :, None] & ~torch.isnan(vals)
        else:
            vals = torch.zeros((p, n, 0), dtype=F32, device=seg.device)
            oks = torch.zeros((p, n, 0), dtype=torch.bool,
                              device=seg.device)
        counts, sums, mins, maxs = kops.segmented_aggregate(
            vals, oks, seg.contiguous(), valid.contiguous(), nseg)
        g_counts = comm.psum(counts)
        cols: dict[int, Col] = {op.key_var: Col("str", key_col)}
        for var, fn, j in specs:
            if fn == "count":
                cols[var] = Col("num", g_counts)
            elif fn in ("sum", "avg"):
                g = comm.psum(sums[:, :, j])
                if fn == "avg":
                    g = g / g_counts.clamp(min=1.0)
                cols[var] = Col("num", g)
            elif fn == "min":
                cols[var] = Col("num", comm.pmin(mins[:, :, j]))
            else:
                cols[var] = Col("num", comm.pmax(maxs[:, :, j]))
        return cols, g_counts

    def _group_aggs_legacy(self, op, ev, t, comm, seg, valid, nseg,
                           key_col):
        """Per-aggregate scatter path — the plain route the fused one
        must match."""
        def seg_sum_count(vals):
            return kref.segmented_sum_count(vals, seg, valid, nseg)

        ones = torch.ones(seg.shape, dtype=F32, device=seg.device)
        _, counts = seg_sum_count(ones)
        g_counts = comm.psum(counts)
        cols: dict[int, Col] = {op.key_var: Col("str", key_col)}
        for var, fn, val_e in op.aggs:
            if fn == "count":
                cols[var] = Col("num", g_counts)
                continue
            v = torch.broadcast_to(ev.atom_num(ev.eval(val_e, t.cols)),
                                   seg.shape)
            # NaN-valued rows are excluded from every aggregate value
            # (count still counts them: avg = sum(non-NaN)/count(valid))
            ok = valid & ~torch.isnan(v)
            if fn in ("sum", "avg"):
                sums, _ = seg_sum_count(torch.where(ok, v,
                                                    torch.zeros_like(v)))
                g = comm.psum(sums)
                if fn == "avg":
                    g = g / g_counts.clamp(min=1.0)
                cols[var] = Col("num", g)
            elif fn in ("min", "max"):
                safe = seg.clamp(0, nseg - 1).long()
                fill = float("inf") if fn == "min" else float("-inf")
                init = torch.full((comm.p, nseg), fill, dtype=F32,
                                  device=seg.device)
                vv = torch.where(ok, v, torch.full_like(v, fill))
                local = init.scatter_reduce(
                    1, safe, vv, "amin" if fn == "min" else "amax")
                g = comm.pmin(local) if fn == "min" else comm.pmax(local)
                cols[var] = Col("num", g)
            else:
                raise PlanError(f"group-by aggregate {fn}")
        return cols, g_counts

    def _eval_orderby(self, op: "A.OrderBy", ev, comm, nts_input,
                      ctx: EvalCtx, limit: Optional[int]) -> Tile:
        """Capacity-bounded segmented sort over the (grouped) tuple
        stream — ORDER BY, with the top-k pushdown when a LIMIT sits
        directly above. The sorted tile is ``topk_cap`` wide (None: the
        child's full width); too-small caps raise ``overflow_topk_cap``
        — never a silent truncation of the ranking."""
        t = self._eval(op.child, ev, comm, nts_input, ctx)
        sort_keys: list[tuple] = []
        for e, desc in op.keys:
            col = ev.eval(e, t.cols)
            if col.kind == "str":
                # dictionary sids are insertion-ordered; compare by the
                # derived lexicographic rank so device order == host
                # string order
                rank = ev.tables["__derived__"]["rank_of_sid"]
                key = _take(rank, col.data, I32_MAX)
            elif col.kind == "date":
                key = col.data
            else:
                key = ev.atom_num(col)
            sort_keys.append((torch.broadcast_to(key, t.valid.shape), desc))
        fused = bool(ctx.cfg.use_kernel_segments) \
            and ctx.cfg.topk_cap is not None
        idx, valid, ovf = topk_rows(sort_keys, t.valid, ctx.cfg.topk_cap,
                                    limit, fused=fused)
        ctx.note("overflow_topk_cap", ovf)
        cols = {v: _regather(c, idx) for v, c in t.cols.items()}
        return Tile(cols, valid, t.overflow | ovf)

    def _eval_unnest(self, op: A.Unnest, ev, comm, nts_input,
                     ctx: EvalCtx) -> Tile:
        t = self._eval(op.child, ev, comm, nts_input, ctx)
        e = op.expr
        if isinstance(e, A.Call) and e.fn == "iterate":
            # singleton iterate == pass-through alias
            t.cols[op.var] = ev.eval(e.args[0], t.cols)
            return t
        if isinstance(e, A.Call) and e.fn == "child":
            return self._unnest_child(t, op.var, e, ev, ctx)
        raise PlanError(f"unnest expr {e}")

    def _unnest_child(self, t: Tile, var: int, e: A.Expr, ev,
                      ctx: EvalCtx) -> Tile:
        """UNNEST child-chain: expand matching descendants, re-gather
        the other columns from each row's ancestor context tuple."""
        from repro_torch.core.rewrite.parallel_rules import _child_chain
        got = _child_chain(e)
        if got is None:
            raise PlanError(f"unsupported unnest chain {e}")
        base_var, names = got
        base = t.cols[base_var]
        assert base.kind == "node"
        tab = ev.tables[base.table]
        p, n = tab["kind"].shape
        tsize = base.data.shape[1]
        dev = base.data.device
        ctx_valid = t.valid & (base.data >= 0)
        # scatter only the valid context rows: invalid ones go to a dump
        # slot past the [P * N] flat slots. A node that several rows
        # reference keeps the last of them (amax), the row a sequential
        # scatter would leave behind.
        slot = torch.where(ctx_valid, torch.arange(p, device=dev)[:, None]
                           * n + base.data.long(), p * n).reshape(-1)
        rows = torch.arange(tsize, dtype=I32, device=dev).expand(p, tsize)
        in_mask = torch.zeros(p * n + 1, dtype=torch.bool, device=dev)
        in_mask.scatter_(0, slot, True)
        row_of = torch.full((p * n + 1,), -1, dtype=I32, device=dev)
        row_of.scatter_reduce_(0, slot, rows.reshape(-1), "amax")
        in_mask, row_of = in_mask[:-1], row_of[:-1]
        frontier = in_mask.view(p, n)
        row_of = row_of.view(p, n)
        name_arr, parent = tab["name"], tab["parent"]
        for nm in names:
            f = self.db.names.lookup(nm)
            up = _gather(frontier, parent, False)
            frontier = up & (name_arr == (f if f >= 0 else -99))
        cap = ctx.cfg.scan_cap or n
        idx, valid, ovf = rows_from_mask(frontier, cap)
        ctx.note("overflow_scan", ovf)
        anc = idx
        for _ in names:
            anc = _gather(parent, anc, -1)
        src = _gather(row_of, anc, -1)
        valid = valid & (src >= 0)
        cols = {v: _regather(c, src) for v, c in t.cols.items()}
        cols[var] = Col("node", idx, base.table)
        return Tile(cols, valid, t.overflow | ovf)

    # -- aggregation ---------------------------------------------------------

    def _eval_aggregate(self, agg: A.Aggregate, ev, comm,
                        outer: Tile, ctx: EvalCtx) -> Tile:
        inner = self._eval(agg.child, ev, comm, outer, ctx)
        expr = agg.expr
        assert isinstance(expr, A.Call)
        fn = expr.fn
        arg = expr.args[0]
        if isinstance(arg, A.Call) and arg.fn == "treat":
            arg = arg.args[0]
        p = comm.p

        def local(x):               # per-partition reduction input
            return x.reshape(p, -1)

        if fn == "count":
            total = comm.psum(local(inner.valid.to(F32)).sum(dim=1))
        else:
            v = torch.broadcast_to(ev.atom_num(ev.eval(arg, inner.cols)),
                                   inner.valid.shape)
            ok = inner.valid & ~torch.isnan(v)
            zero = torch.zeros_like(v)
            if fn == "sum":
                total = comm.psum(local(torch.where(ok, v, zero)).sum(1))
            elif fn == "min":
                total = comm.pmin(local(torch.where(
                    ok, v, torch.full_like(v, float("inf")))).amin(1))
            elif fn == "max":
                total = comm.pmax(local(torch.where(
                    ok, v, torch.full_like(v, float("-inf")))).amax(1))
            elif fn == "avg":
                s = comm.psum(local(torch.where(ok, v, zero)).sum(1))
                c = comm.psum(local(ok.to(F32)).sum(1))
                total = s / c.clamp(min=1.0)
            else:
                raise PlanError(f"aggregate {fn}")
        # after the global step every partition holds the total; emit
        # the result tuple only on the "central partition" (§4.2.2)
        return Tile(cols={agg.var: Col("num", total[:, None])},
                    valid=comm.index() == 0,
                    overflow=inner.overflow | outer.overflow)

    # -- join ----------------------------------------------------------------

    def _eval_join(self, op: A.Join, ev, comm, nts_input,
                   ctx: EvalCtx) -> Tile:
        if not op.hash_keys:
            raise PlanError("non-equi JOIN not supported (no hash keys)")
        cfg = ctx.cfg
        left = self._eval(op.left, ev, comm, nts_input, ctx)
        right = self._eval(op.right, ev, comm, nts_input, ctx)

        def key_arr(col: Col, shape) -> torch.Tensor:
            # string-dictionary id when present, else packed date,
            # else float bits — all int32, exact
            sid = torch.broadcast_to(ev.atom_sid(col), shape)
            date = torch.broadcast_to(ev.atom_date(col), shape)
            num = torch.broadcast_to(ev.atom_num(col), shape)
            bits = num.contiguous().view(I32)
            return torch.where(sid >= 0, sid,
                               torch.where(date >= 0, (1 << 28) + date,
                                           bits))

        lkeys = tuple(key_arr(ev.eval(le, left.cols), left.valid.shape)
                      for le, _ in op.hash_keys)
        rkeys = tuple(key_arr(ev.eval(re_, right.cols), right.valid.shape)
                      for _, re_ in op.hash_keys)

        # build-side columns flow upward across the exchange: serialize
        # node refs (Hyracks frame-serialization analogue)
        mine = comm.index()
        lcols = {v: ev.to_xnode(c, mine) for v, c in left.cols.items()}

        if cfg.join_strategy == "broadcast":
            # hybrid-hash analogue: the build side becomes resident on
            # every partition via all_gather; probe stays local
            bkeys, bvalid, bcols = _exchange(
                lkeys, left.valid, lcols, comm, dest=None)
            pkeys, pvalid, pcols = rkeys, right.valid, dict(right.cols)
        elif cfg.join_strategy == "repartition":
            # grace analogue: co-partition BOTH sides by key hash (the
            # destinations are the JAX package's, bit for bit)
            p = max(comm.size(), 1)
            ldest = (_hash_u32(lkeys) % p).to(I32)
            rdest = (_hash_u32(rkeys) % p).to(I32)
            bkeys, bvalid, bcols = _exchange(
                lkeys, left.valid, lcols, comm, dest=ldest)
            rcols = {v: ev.to_xnode(c, mine)
                     for v, c in right.cols.items()}
            pkeys, pvalid, pcols = _exchange(
                rkeys, right.valid, rcols, comm, dest=rdest)
        else:
            raise ValueError(cfg.join_strategy)

        pos, matched, bovf = hash_join_probe(
            tuple(k.contiguous() for k in bkeys), bvalid.contiguous(),
            tuple(k.contiguous() for k in pkeys), pvalid.contiguous(),
            cfg.join_bucket, use_kernel=bool(cfg.use_kernel_join))
        ctx.note("overflow_join", bovf)

        cols = dict(pcols)
        for v, c in bcols.items():
            cols[v] = _regather(c, pos)
        valid = pvalid & matched
        overflow = left.overflow | right.overflow | bovf

        if cfg.join_cap is not None:
            # capacity-bounded probe output: compact matched rows into
            # a fixed-width tile; overflow surfaces on its own flag
            idx, valid2, jovf = rows_from_mask(valid, cfg.join_cap)
            ctx.note("overflow_join_cap", jovf)
            cols = {v: _regather(c, idx) for v, c in cols.items()}
            valid = valid2
            overflow = overflow | jovf
        return Tile(cols, valid, overflow)

    # -- outputs --------------------------------------------------------------

    def _outputs(self, plan: A.Op, tile: Tile, ev: ExprEval,
                 schema: dict[int, tuple], ctx: EvalCtx,
                 comm: Comm) -> dict:
        """The raw-output dict; static (kind, table) goes to
        ``schema``."""
        assert isinstance(plan, A.DistributeResult)
        out: dict[str, Any] = {"valid": tile.valid,
                               "overflow": tile.overflow}
        for flag in OVERFLOW_FLAGS.values():
            acc = torch.zeros(comm.p, dtype=torch.bool, device=self.device)
            for f in ctx.ovf[flag]:
                acc = acc | f
            out[flag] = acc
        if ctx.prof is not None:
            # per-op profile counts in pre-order, [P, ops]; the static
            # order list reaches the host through the meta dict (as
            # ``schema`` does)
            order = sorted(ctx.prof)
            out["prof_rows"] = torch.stack([ctx.prof[i] for i in order],
                                           dim=1)
            ctx.prof_meta["order"] = order
        for v in plan.vars:
            c = tile.cols[v]
            if c.kind == "node":
                schema[v] = ("node", c.table)
                out[f"var{v}"] = c.data
            elif c.kind == "xnode":
                schema[v] = ("xnode", c.table)
                out[f"var{v}"] = c.data       # (part, idx, num, sid, date)
            elif c.kind in ("atom", "det"):
                d = ev.detach(c)
                schema[v] = ("det", None)
                out[f"var{v}"] = d.data       # (num, sid, date) tuple
            else:
                schema[v] = (c.kind, None)
                out[f"var{v}"] = c.data
        return out


def to_numpy(raw: dict) -> dict:
    """Raw-output dict of tensors -> the same dict of numpy arrays."""
    def conv(x):
        return x.detach().contiguous().cpu().numpy()

    return {k: tuple(conv(d) for d in v) if isinstance(v, tuple)
            else conv(v) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# Result extraction (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledPlan:
    fn: Callable
    schema: dict[int, tuple]
    plan: A.Op
    config: Optional[ExecConfig] = None   # resolved config of this plan
    param_specs: tuple = ()               # prepared-query parameter types
    batch: Optional[int] = None           # B of a batched fn
    profile_meta: Optional[dict] = None   # profile=True: op order,
    #                                       filled at run time


class ResultSet:
    """Host-side result decoding: rows of python values, plus node
    fingerprints (concatenated descendant text, document order) so
    differential tests can compare against the tree-walking baseline."""

    def __init__(self, db: xdm.Database, plan: A.Op, raw: dict,
                 schema: dict[int, tuple], profile_meta: dict = None):
        self.db = db
        self.plan = plan
        self.raw = raw
        self.schema = schema
        self.profile_meta = profile_meta
        self.overflow = bool(np.any(raw["overflow"]))
        for flag in OVERFLOW_FLAGS.values():    # overflow_scan, ...
            setattr(self, flag, bool(np.any(raw.get(flag, False))))

    def _prof_rows(self) -> Optional[tuple[list, np.ndarray]]:
        if self.profile_meta is None or "prof_rows" not in self.raw:
            return None
        order = self.profile_meta.get("order")
        if order is None:
            return None
        pr = np.asarray(self.raw["prof_rows"])
        return order, pr.reshape(-1, pr.shape[-1])

    def op_rows(self) -> Optional[dict]:
        """Profile-mode runs only: pre-order plan-op index -> global
        valid rows out of that operator (partition axis summed). None
        on normal runs."""
        got = self._prof_rows()
        if got is None:
            return None
        order, pr = got
        per_op = pr.sum(axis=0)
        return {idx: int(per_op[j]) for j, idx in enumerate(order)}

    def op_rows_peak(self) -> Optional[dict]:
        """Profile-mode runs only: pre-order plan-op index -> valid
        rows out of that operator on the busiest partition (caps are
        per-partition tile sizes). None on normal runs."""
        got = self._prof_rows()
        if got is None:
            return None
        order, pr = got
        per_op = pr.max(axis=0)
        return {idx: int(per_op[j]) for j, idx in enumerate(order)}

    def rows(self) -> list[tuple]:
        assert isinstance(self.plan, A.DistributeResult)
        valid = np.asarray(self.raw["valid"])       # [P, T]
        npart, t = valid.shape
        out = []
        for p in range(npart):
            for r in range(t):
                if not valid[p, r]:
                    continue
                row = []
                for v in self.plan.vars:
                    row.append(self._value(v, p, r))
                out.append(tuple(row))
        return out

    def _value(self, v: int, p: int, r: int):
        kind, table = self.schema[v]
        data = self.raw[f"var{v}"]
        if kind == "node":
            return node_fingerprint(self.db, table, p,
                                    int(data[p, r]))
        if kind == "xnode":
            part, idx = int(data[0][p, r]), int(data[1][p, r])
            return node_fingerprint(self.db, table, part, idx)
        if kind == "det":
            num, sid, date = data
            s = int(sid[p, r])
            if s >= 0:
                return self.db.strings.str(s)
            return float(num[p, r])
        if kind == "num":
            return float(data[p, r])
        if kind == "str":
            s = int(data[p, r])
            return self.db.strings.str(s) if s >= 0 else None
        if kind == "date":
            return int(data[p, r])
        if kind == "bool":
            return bool(data[p, r])
        raise TypeError(kind)

    def scalar(self) -> float:
        rows = self.rows()
        assert len(rows) == 1 and len(rows[0]) == 1, rows
        return rows[0][0]


def node_fingerprint(db: xdm.Database, collection: str, part: int,
                     idx: int) -> str:
    """Serialize a node as its descendant text values in doc order."""
    t = db.collection(collection).partitions[part]
    if idx < 0 or idx >= t.num_nodes:
        return "<invalid>"
    out = []
    stop = t.num_nodes
    # children are contiguous after the parent in our shred layouts;
    # generic walk: collect all descendants via parent chains
    desc = [idx]
    parents = {idx}
    for j in range(idx + 1, stop):
        par = int(t.parent[j])
        if par in parents:
            parents.add(j)
            desc.append(j)
        elif par < idx:
            break
    for j in desc:
        sid = int(t.text_sid[j])
        if sid >= 0:
            out.append(db.strings.str(sid))
        elif not np.isnan(t.text_num[j]):
            v = float(t.text_num[j])
            out.append(str(int(v)) if v.is_integer() else f"{v:.1f}")
    return "|".join(out)
