"""QueryService: the serving tier on top of Executor.

The port of the JAX package's ``core/service.py``. The raw executor is
a batch tool: capacities are fixed at config time, and a too-small
capacity surfaces as an overflow flag the caller must handle. The
service adds:

1. **Prepared queries (prepare/execute lifecycle).** ``prepare(query)``
   parses, normalizes and optimizes once, then lifts every
   comparison/arithmetic literal into a typed parameter vector
   (prepared.py), returning a ``PreparedQuery`` whose *parameter-erased
   signature* identifies the plan shape with constants removed.
   ``execute(prepared, bindings)`` binds the values as 0-d tensors on
   the device and runs the shared compiled plan — two queries differing
   only in a constant compile **once**. Plain ``execute(query_text)``
   prepares implicitly and binds the query's own literals.

2. **LRU-bounded two-level compiled-plan cache.** Level 1 maps (erased
   signature, ``ExecConfig.cap_key()``, mode, partitions, batch) ->
   compiled plan, bounded to ``cache_capacity`` entries. Level 2 is
   stats-only: exact (signature, binding) pairs are counted
   (``binding_stats``) but never create cache entries.

3. **Batch admission.** ``execute_batch(requests)`` groups concurrent
   requests by erased signature; each group becomes ONE call of a
   batch-compiled plan over stacked parameter tensors (executor
   ``batch=B``), padded to power-of-two buckets. The bindings of a
   group share the call and one host copy of the outputs. A batch that
   overflows is retried as ONE regrown batch (``serve_group``).

3b. **Async multi-tenant frontend.** ``submit()``/``drain()`` put the
   serving/ runtime in front of everything above: SLO-deadlined
   admission windows on a virtual clock, deficit-round-robin tenant
   fairness and cost-based batch bucketing. Results stay identical to
   per-request ``execute``.

4. **Overflow-driven capacity regrowth.** Results are *always exact*:
   each per-stage overflow flag of ``executor.OVERFLOW_FLAGS`` grows
   only its own capacity, geometrically, up to a ceiling where that
   overflow is impossible (the padded table for scans, every
   partition's rows for the join output, the full string dictionary for
   group and top-k capacities, 64 for the join bucket). Each grown
   variant lands in the cache, so a workload pays each step once.

5. **Statistics-based cap pre-sizing** (``presize.presized_config``):
   first-shot caps from build-time per-tag counts and distinct-value
   counts, with the top-k pushdown (``pushdown_topk=False`` restores
   full-sort-then-slice).

6. **Restart survival.** With ``persist_dir`` set, every serving
   variant's compiled plan is written to a disk cache
   (core/persist.py) after its first run; a restarted service on the
   same directory loads it instead of compiling (``stats.compiles``
   stays 0). A corrupt or foreign-fingerprint entry is invalidated and
   recompiled, never served. A load and a compile are followed by the
   same runs, so spmd ranks whose disk caches differ stay in
   lockstep.

7. **SPMD.** ``mode="spmd", mesh=...`` runs every plan one partition a
   rank of the mesh's process group (``launch.mesh.make_data_mesh``).
   Every rank's service must receive the same requests in the same
   order; each reads the same all-gathered outputs and flags, so the
   plan cache, the regrowth ladder, batching and the admission runtime
   stay in lockstep across ranks.

The service builds its ``Executor`` on the GPU unless the caller asks
for the CPU (``device="cpu"``); the executor's three query kernels
(join probe, segment aggregate, segment top-k) run on its path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import types
from collections import OrderedDict
from typing import Optional, Sequence, Union

from repro_torch.core import algebra as A
from repro_torch.core import persist as persist_mod
from repro_torch.core import xdm
from repro_torch.core.errors import InvalidArgumentError
from repro_torch.core.executor import (MODES, CompiledPlan, ExecConfig,
                                       Executor, ResultSet,
                                       resolve_kernel_policy)
from repro_torch.core.obs import trace as obs_trace
from repro_torch.core.obs.metrics import (MetricsRegistry, stats_diff,
                                          stats_snapshot)
from repro_torch.core.obs.trace import NULL_TRACER, sig_digest
from repro_torch.core.physical import round_cap
from repro_torch.core.prepared import (PreparedQuery, bind_params,
                                       prepare_plan, stack_params)
from repro_torch.core.presize import presized_config
from repro_torch.core.rewrite import optimize
from repro_torch.core.serving.bucketing import next_pow2 as _next_pow2
from repro_torch.core.translator import translate

Query = Union[str, A.Op, PreparedQuery]


class QueryOverflowError(RuntimeError):
    """Raised when a query still overflows after bounded regrowth."""


@dataclasses.dataclass
class ServiceStats:
    executions: int = 0     # queries served
    runs: int = 0           # device executions (executions + retries,
                            # a batched dispatch counting once)
    retries: int = 0        # overflow-triggered re-executions
    cache_hits: int = 0     # compiled-plan (erased-signature) hits
    cache_misses: int = 0
    compiles: int = 0       # actual trace+compile events. A
                            # parameterized hit (new binding, known
                            # template) is an exact-binding miss but
                            # NOT a compile — see exact_misses.
    evictions: int = 0      # LRU-bounded cache evictions
    exact_hits: int = 0     # (signature, binding) seen before
    exact_misses: int = 0   # new binding (shared plan may still hit)
    batches: int = 0        # batched device dispatches
    batched_requests: int = 0   # requests served by those dispatches
    # persistent compiled-plan cache (core/persist.py): disk loads
    # that replaced a compile, probes that found nothing, entries
    # found unsafe (corrupt, foreign fingerprint) and deleted, stores
    persist_hits: int = 0
    persist_misses: int = 0
    persist_invalidations: int = 0
    persist_stores: int = 0
    # regrowth events per ExecConfig cap (scan_cap/join_bucket/...),
    # keyed by the OVERFLOW_FLAGS registry's knob names — the
    # "overflow-by-cap" metric (obs/metrics.REGISTERED_STATS)
    overflows_by_cap: dict = dataclasses.field(default_factory=dict)
    # evictions attributed per LRU-bounded service cache ("plans",
    # "profile_plans", "bindings", "good_cfg", "sig_history",
    # "row_cost", "persist") — ``evictions`` above counts only the
    # level-1 plan cache and stays for compatibility; the rest used
    # to evict silently
    evictions_by_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def snapshot(self) -> "ServiceStats":
        """Point-in-time copy; pair with ``diff`` so tests and
        benchmarks stop hand-subtracting counter fields."""
        return stats_snapshot(self)

    def diff(self, since: "ServiceStats") -> "ServiceStats":
        """Per-field delta vs an earlier ``snapshot()``."""
        return stats_diff(self, since)


class QueryService:
    """Serving tier: prepared queries + LRU plan cache + batch
    admission + regrowth + pre-sizing.

    ``execute`` accepts XQuery text, an optimized plan, or a
    ``PreparedQuery`` (with optional ``bindings``) and returns an exact
    (non-overflow) ResultSet or raises QueryOverflowError.
    ``parameterize=False`` restores the exact-signature cache (every
    constant-variant compiles separately) — kept for ablation.
    ``warmup(templates)`` pre-loads the workload mix at boot.
    ``device=None`` runs on the GPU and raises without one; tests pass
    ``device="cpu"``. ``persist_dir`` attaches the disk-backed plan
    cache (``persist_max_bytes`` bounds it); ``mode="spmd"`` with a
    ``mesh`` runs one partition a rank of the mesh's process group.
    """

    def __init__(self, db: xdm.Database,
                 config: Optional[ExecConfig] = None, *,
                 mode: str = "sim", mesh=None, max_retries: int = 8,
                 growth: int = 4, presize: bool = True,
                 cache_capacity: int = 64, parameterize: bool = True,
                 binding_stats_capacity: int = 4096,
                 pushdown_topk: bool = True, verify: bool = True,
                 tracer=None, persist_dir: Optional[str] = None,
                 persist_max_bytes: Optional[int] = None, device=None):
        # typed validation, not assert: these are user-facing knobs
        # and must still diagnose under ``python -O``
        if growth <= 1:
            raise InvalidArgumentError(
                f"growth={growth}: capacity growth must be geometric "
                f"(> 1), or the regrowth ladder cannot make progress")
        if cache_capacity < 1:
            raise InvalidArgumentError(
                f"cache_capacity={cache_capacity}: the compiled-plan "
                f"cache needs at least one slot")
        if binding_stats_capacity < 1:
            raise InvalidArgumentError(
                f"binding_stats_capacity={binding_stats_capacity}: "
                f"the binding-stats cache needs at least one slot")
        if max_retries < 0:
            raise InvalidArgumentError(
                f"max_retries={max_retries} must be >= 0")
        if persist_max_bytes is not None and persist_max_bytes < 0:
            raise InvalidArgumentError(
                f"persist_max_bytes={persist_max_bytes} must be "
                f">= 0 (or None for unbounded)")
        if mode not in MODES:
            raise InvalidArgumentError(f"mode={mode!r}; one of {MODES}")
        if (mode == "spmd") != (mesh is not None):
            raise InvalidArgumentError(
                "mode='spmd' runs over a mesh, and only spmd takes one")
        self.db = db
        self.base_config = config or ExecConfig()
        self.mode = mode
        self.mesh = mesh
        self.max_retries = max_retries
        self.growth = growth
        self.presize = presize
        # top-k pushdown: presize the ordered-output tile (topk_cap)
        # to ~limit k instead of the full segment width. False keeps
        # full-sort-then-slice — the ablation baseline of the
        # "ordered" benchmark suite
        self.pushdown_topk = pushdown_topk
        self.cache_capacity = cache_capacity
        self.parameterize = parameterize
        # prepare-time static verification (analysis/check.verify_plan):
        # schema inference + capacity-flow + registry agreement, run
        # once per prepared plan — memoization keeps the warm execute
        # path free of it. Off only for ablation/benchmark isolation.
        self.verify = verify
        self.executor = Executor(db, self.base_config, device=device)
        # the tables go to the device here, at build time, so the first
        # request's latency holds no upload: sim mode's P partitions,
        # or under spmd (one partition a rank, checked before any
        # request) this rank's own
        if mesh is not None:
            _, rank, _ = self.executor.spmd_group(mesh)
            self.executor.partition_tables(rank)
        else:
            self.executor.tables
        self.stats = ServiceStats()
        # observability: spans go to the attached tracer (default: the
        # shared no-op NULL_TRACER — the pre-instrumentation warm
        # path); counters stay plain dataclass fields and the metrics
        # registry binds them for live Prometheus/JSON exposition
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = MetricsRegistry()
        self.metrics.register_stats("service", self.stats)
        # tracer ring evictions surface as a lazy gauge: a bounded
        # trace that lost records must read as truncated, not short
        self.metrics.gauge(
            "tracer_dropped_events",
            help="trace records evicted by the Tracer max_events ring",
            fn=lambda: getattr(self.tracer, "dropped", 0))
        # per-signature observability history feeding explain():
        # compile count/wall seconds and regrowth (cap, old, new)
        # events. Only cold paths (compile, regrow) write here.
        self._sig_history: OrderedDict[str, dict] = OrderedDict()
        # explain(profile=True) arms this around its run: compiled()
        # keys + compiles profile variants (executor profile=True)
        # separately from serving variants
        self._profile_mode = False
        # profile variants live in their OWN bounded cache: repeated
        # explain(profile=True) calls must never evict hot warm-path
        # executables from the serving cache below (the old shared-LRU
        # bug), and profile entries are never persisted to disk
        self._profile_cache: OrderedDict[tuple, CompiledPlan] = \
            OrderedDict()
        # disk-backed persistent compiled-plan cache (core/persist.py).
        # A fresh compile is stored after its first run, which fills
        # the column schema: a disk hit and a compile then issue the
        # same runs (and, under spmd, the same collectives). Loads are
        # fingerprint-checked (torch/CUDA versions, device, world size,
        # partitions, kernel sources, db digest) so a foreign
        # environment's entry is invalidated and recompiled, never
        # served
        self._persist = None
        self._fingerprint: Optional[dict] = None
        # id(cp) -> (cp, sig, batch): compiled, not yet run or stored
        self._unstored: dict[int, tuple] = {}
        if persist_dir is not None:
            self._persist = persist_mod.PlanDiskCache(
                persist_dir, max_bytes=persist_max_bytes)
            self._fingerprint = persist_mod.service_fingerprint(
                db, persist_mod.host_tables(db), mode,
                self.executor.num_partitions, self.executor.device,
                mesh.size() if mesh is not None else 1)
            self.metrics.gauge(
                "persist_entries",
                help="entries in the disk-backed compiled-plan cache",
                fn=lambda: self._persist.info().entries)
        # level-1 cache: erased signature -> compiled plan, LRU-bounded
        self._cache: OrderedDict[tuple, CompiledPlan] = OrderedDict()
        # level-2, stats only: exact (signature, binding) -> hit count,
        # LRU-bounded like the plan cache (distinct bindings are
        # user-cardinality — unbounded by nature, so a long-running
        # service must cap this or leak host memory; the capacity is a
        # constructor knob for deployments with wide binding spaces)
        self._bindings: OrderedDict[tuple, int] = OrderedDict()
        self._bindings_capacity = binding_stats_capacity
        # last config that produced an exact result, per erased
        # signature — repeats (and all constant-variants of a template)
        # skip the regrowth ladder, not just the compiles. Bounded like
        # every other per-signature map (keys are full plan reprs)
        self._good_cfg: OrderedDict[str, ExecConfig] = OrderedDict()
        self._good_cfg_capacity = 4096
        # query text -> PreparedQuery (parse/rewrite/lift off the warm
        # path)
        self._prepared_memo: dict[str, PreparedQuery] = {}
        # id(plan) -> (plan ref, PreparedQuery): the held reference
        # keeps the id stable, making the warm path a pure dict probe
        # instead of an O(plan-size) lift+repr walk per request
        self._plan_prep_memo: dict[int, tuple[A.Op, PreparedQuery]] = {}
        # scan caps are clamped to the padded per-partition table size,
        # where rows_from_mask can no longer overflow — the regrowth
        # ceiling and the proof the retry loop terminates exactly
        self._scan_ceiling = self.executor.padded_rows()
        # join_cap's ceiling: the widest possible probe side is every
        # partition's padded rows gathered to one partition, where
        # compaction can no longer overflow
        self._joincap_ceiling = (self._scan_ceiling
                                 * self.executor.num_partitions)
        # the probe unrolls `join_bucket` times at trace time, so the
        # ladder must stop well before trace blowup; widths past this
        # mean duplicate build keys (M:N join — unsupported), not hash
        # collisions, and regrowth cannot fix those
        self._bucket_ceiling = 64
        # group_cap's ceiling: the full string dictionary (frozen by
        # the executor's derived-array build above), where every
        # possible key sid has its own segment slot and group-cap
        # overflow is impossible by construction
        self._group_ceiling = len(db.strings)
        # the async admission/scheduling runtime behind submit()/
        # drain(), created lazily (or explicitly via runtime(...))
        self._runtime = None
        # signature -> per-request row cost (presized scan capacity),
        # the padding-waste weight the bucketing policy reads
        self._row_cost: OrderedDict[str, int] = OrderedDict()

    # -- prepare -----------------------------------------------------------

    def plan_for(self, query: Union[str, A.Op]) -> A.Op:
        """Query text -> a directly runnable optimized plan (constants
        baked, no Param leaves) — Executor-compatible standalone. The
        serving path itself goes through ``prepare``."""
        if isinstance(query, A.Op):
            return query
        return optimize(translate(query))

    def prepare(self, query: Query) -> PreparedQuery:
        """Query -> PreparedQuery: parse + normalize + optimize + lift
        literals into the parameter vector. Memoized; all constant-
        variants of a template produce equal erased signatures."""
        if isinstance(query, PreparedQuery):
            return query
        if isinstance(query, str):
            pq = self._prepared_memo.get(query)
            if pq is None:
                # ambient tracer installed around the cold prepare
                # pipeline so rewrite-rule firings (rewrite/engine)
                # and the literal lift (prepared) emit through it
                with obs_trace.using(self.tracer), \
                        self.tracer.span("prepare", cat="prepare") as sp:
                    pq = self._prepare_plan(optimize(translate(query)),
                                            query)
                    sp.set(sig=sig_digest(pq.signature),
                           params=len(pq.specs))
                if len(self._prepared_memo) >= 4096:
                    # adversarially unique query texts must not grow
                    # host memory forever; a flush re-prepares
                    self._prepared_memo.clear()
                self._prepared_memo[query] = pq
            return pq
        ent = self._plan_prep_memo.get(id(query))
        if ent is not None and ent[0] is query:
            return ent[1]
        pq = self._prepare_plan(query, None)
        if len(self._plan_prep_memo) >= 4096:
            # callers passing a fresh A.Op per request would otherwise
            # grow this forever; a flush costs one lift walk per entry
            self._plan_prep_memo.clear()
        self._plan_prep_memo[id(query)] = (query, pq)
        return pq

    def _prepare_plan(self, plan: A.Op,
                      text: Optional[str]) -> PreparedQuery:
        if not self.parameterize:
            # ablation mode: exact-signature cache, constants baked
            pq = PreparedQuery(plan, (), (), repr(plan), text)
        else:
            # prepare_plan is idempotent: an already-erased plan (a
            # PreparedQuery's .plan fed back in) keeps its Param layout
            pq = prepare_plan(plan, text)
        if self.verify:
            # static plan verifier — both callers of _prepare_plan
            # memoize, so this runs once per template, never on the
            # warm path
            from repro_torch.core.analysis.check import verify_plan
            with self.tracer.span("verify", cat="prepare"):
                verify_plan(pq.plan, db=self.db, text=text)
        return pq

    @staticmethod
    def _values_for(pq: PreparedQuery,
                    bindings: Optional[Sequence]) -> tuple:
        if bindings is not None:
            return tuple(bindings)
        if pq.defaults is None:
            raise ValueError(
                "this PreparedQuery came from an already-erased plan "
                "and has no default binding; pass bindings=")
        return pq.defaults

    # -- cache plumbing ----------------------------------------------------

    def _key(self, sig: str, cfg: ExecConfig,
             batch: Optional[int] = None,
             profile: bool = False) -> tuple:
        return (sig, cfg.cap_key(), self.mode,
                self.executor.num_partitions, batch, profile)

    def compiled(self, plan: A.Op, cfg: ExecConfig,
                 sig: Optional[str] = None, param_specs: tuple = (),
                 batch: Optional[int] = None) -> CompiledPlan:
        sig = sig if sig is not None else repr(plan)
        if self._profile_mode:
            # profile variants: own bounded cache, never persisted,
            # and no serving-cache counter traffic — explain() is a
            # diagnostic, not a serving event
            key = self._key(sig, cfg, batch, True)
            cp = self._profile_cache.get(key)
            if cp is not None:
                self._profile_cache.move_to_end(key)
                return cp
            cp = self._compile(plan, cfg, sig, param_specs, batch,
                               profile=True)
            self._profile_cache[key] = cp
            self._evict(self._profile_cache, self.cache_capacity,
                        "profile_plans")
            return cp
        key = self._key(sig, cfg, batch, False)
        cp = self._cache.get(key)
        if cp is not None:
            self._cache.move_to_end(key)
            self.stats.cache_hits += 1
            return cp
        self.stats.cache_misses += 1
        cp = self._persist_load(plan, cfg, sig, param_specs, batch)
        if cp is None:
            cp = self._compile(plan, cfg, sig, param_specs, batch,
                               profile=False)
            if self._persist is not None:
                self._unstored[id(cp)] = (cp, sig, batch)
        self._cache[key] = cp
        before = len(self._cache)
        self._evict(self._cache, self.cache_capacity, "plans")
        self.stats.evictions += before - len(self._cache)
        return cp

    def _compile(self, plan: A.Op, cfg: ExecConfig, sig: str,
                 param_specs: tuple, batch: Optional[int],
                 profile: bool) -> CompiledPlan:
        """One real compile (the only site)."""
        t0 = time.perf_counter()  # lint: allow(DET001) — compile-time metric, cold path only
        with self.tracer.span("compile", cat="service") as span:
            cp = self.executor.compile(
                plan, mode=self.mode, mesh=self.mesh, config=cfg,
                param_specs=param_specs, batch=batch, profile=profile)
            span.set(sig=sig_digest(sig), batch=batch,
                     profile=profile)
        # counted after the compile succeeds, so `stats.compiles` stays
        # the exact mirror of `executor.compile_count` on every path —
        # including regrowth-retry recompiles (scan / join_bucket /
        # join_cap / group_cap) and explain's profile-mode compiles,
        # which tests pin as an invariant
        self.stats.compiles += 1
        h = self._history_for(sig)
        h["compiles"] += 1
        h["compile_s"] += time.perf_counter() - t0  # lint: allow(DET001)
        return cp

    # -- persistent cache plumbing ---------------------------------------

    def _persist_load(self, plan: A.Op, cfg: ExecConfig, sig: str,
                      param_specs: tuple,
                      batch: Optional[int]) -> Optional[CompiledPlan]:
        """Disk probe for one compiled variant. Any unsafe state —
        corrupt file, foreign fingerprint, an entry of another plan —
        invalidates the entry and returns None (the caller compiles),
        so the persistent tier can degrade but never mis-serve."""
        if self._persist is None:
            return None
        rcfg = resolve_kernel_policy(plan, cfg, self.executor.device)
        pkey = persist_mod.entry_key(sig, rcfg, self.mode,
                                     self.executor.num_partitions, batch)
        status, entry = self._persist.lookup(pkey, self._fingerprint)
        if status == "invalid":
            self.stats.persist_invalidations += 1
            return None
        if status == "miss":
            self.stats.persist_misses += 1
            return None
        try:
            cp = persist_mod.load_compiled(self.executor, entry, plan,
                                           self.mode, self.mesh)
        except Exception:
            self._persist.invalidate(pkey)
            self.stats.persist_invalidations += 1
            return None
        self.stats.persist_hits += 1
        self.tracer.event("persist-hit", cat="service",
                          sig=sig_digest(sig), batch=batch)
        return cp

    def _ran(self, cp: CompiledPlan) -> None:
        """After a run of ``cp``: a fresh compile's schema is now
        filled, so its entry goes to disk (once)."""
        pending = self._unstored.pop(id(cp), None)
        if pending is not None and pending[0] is cp:
            self._persist_store(cp, pending[1], pending[2])

    def _persist_store(self, cp: CompiledPlan, sig: str,
                       batch: Optional[int]) -> None:
        """Persist a freshly compiled serving variant after its first
        run (best-effort: a failing disk skips the store, serving is
        unaffected)."""
        entry = persist_mod.pack_compiled(cp)
        if entry is None:
            return
        pkey = persist_mod.entry_key(sig, cp.config, self.mode,
                                     self.executor.num_partitions, batch)
        pruned = self._persist.store(pkey, self._fingerprint, entry)
        if pruned is None:
            return
        self.stats.persist_stores += 1
        if pruned:
            self.stats.evictions_by_cache["persist"] = \
                self.stats.evictions_by_cache.get("persist", 0) + pruned

    def persist_info(self):
        """``persist.DiskCacheInfo`` of the attached disk cache, or
        None when persistence is off."""
        return (self._persist.info() if self._persist is not None
                else None)

    def cache_size(self) -> int:
        return len(self._cache)

    def cached_configs(self) -> list[ExecConfig]:
        """ExecConfig of every cached compilation (observability for
        benchmarks/tests without leaking the cache-key layout)."""
        return [cp.config for cp in self._cache.values()]

    def binding_stats(self) -> dict[tuple, int]:
        """Exact (signature, binding) hit counts — the stats-only
        second cache level (template-skew observability)."""
        return dict(self._bindings)

    def _evict(self, od: OrderedDict, capacity: int,
               cache_name: str) -> None:
        """LRU-bound one of the service's OrderedDict caches,
        attributing every eviction to its per-cache counter
        (``evictions_by_cache`` — OBS001-registered). The bounded
        maps used to popitem silently, so cache pressure on e.g. the
        known-good-config map was invisible to operators."""
        while len(od) > capacity:
            od.popitem(last=False)
            self.stats.evictions_by_cache[cache_name] = \
                self.stats.evictions_by_cache.get(cache_name, 0) + 1

    def _note_good_cfg(self, sig: str, cfg: ExecConfig) -> None:
        self._good_cfg[sig] = cfg
        self._good_cfg.move_to_end(sig)
        self._evict(self._good_cfg, self._good_cfg_capacity,
                    "good_cfg")

    def _history_for(self, sig: str) -> dict:
        """Per-signature compile/regrowth history (explain's
        compile-vs-execute split and regrowth annotations). Written
        only on cold paths."""
        h = self._sig_history.get(sig)
        if h is None:
            h = {"compiles": 0, "compile_s": 0.0, "regrowths": []}
            self._sig_history[sig] = h
            self._evict(self._sig_history, self._good_cfg_capacity,
                        "sig_history")
        return h

    def _note_regrow(self, sig: str, old: ExecConfig,
                     new: ExecConfig) -> None:
        """Record one regrowth rung: which caps grew (overflow-by-cap
        metric, per-signature history, tracer instant)."""
        grown = [(f.name, getattr(old, f.name), getattr(new, f.name))
                 for f in dataclasses.fields(ExecConfig)
                 if getattr(old, f.name) != getattr(new, f.name)]
        for cap, _, _ in grown:
            self.stats.overflows_by_cap[cap] = \
                self.stats.overflows_by_cap.get(cap, 0) + 1
        self._history_for(sig)["regrowths"].extend(grown)
        self.tracer.event("regrow-retry", cat="service",
                          sig=sig_digest(sig),
                          **{cap: n for cap, _, n in grown})

    def _note_binding(self, sig: str, values: tuple) -> None:
        key = (sig, values)
        seen = self._bindings.get(key)
        if seen is None:
            self.stats.exact_misses += 1
            self._bindings[key] = 1
            self._evict(self._bindings, self._bindings_capacity,
                        "bindings")
        else:
            self.stats.exact_hits += 1
            self._bindings[key] = seen + 1
            self._bindings.move_to_end(key)

    # -- cap pre-sizing ------------------------------------------------------

    def _presized_config(self, plan: A.Op) -> ExecConfig:
        """First-shot ExecConfig from build-time statistics
        (``presize.presized_config``): explicit caps in the base config
        win; ``presize=False`` runs the base config as it is."""
        if not self.presize:
            return self.base_config
        return presized_config(
            self.db, plan, self.base_config,
            pushdown_topk=self.pushdown_topk,
            num_partitions=self.executor.num_partitions)

    # -- capacity regrowth -----------------------------------------------------

    def _grown_config(self, cfg: ExecConfig, rs: ResultSet) -> ExecConfig:
        grew = False
        if rs.overflow_scan:
            cur = cfg.scan_cap if cfg.scan_cap else self._scan_ceiling
            new_cap = min(round_cap(cur * self.growth),
                          self._scan_ceiling)
            if new_cap > cur:
                cfg = dataclasses.replace(cfg, scan_cap=new_cap)
                grew = True
        if rs.overflow_join:
            new_bucket = min(cfg.join_bucket * self.growth,
                             self._bucket_ceiling)
            if new_bucket > cfg.join_bucket:
                cfg = dataclasses.replace(cfg, join_bucket=new_bucket)
                grew = True
        if rs.overflow_join_cap and cfg.join_cap is not None:
            new_jcap = min(round_cap(cfg.join_cap * self.growth),
                           self._joincap_ceiling)
            if new_jcap > cfg.join_cap:
                cfg = dataclasses.replace(cfg, join_cap=new_jcap)
                grew = True
        if rs.overflow_group_cap and cfg.group_cap is not None:
            new_gcap = min(round_cap(cfg.group_cap * self.growth),
                           self._group_ceiling)
            if new_gcap > cfg.group_cap:
                cfg = dataclasses.replace(cfg, group_cap=new_gcap)
                grew = True
        if rs.overflow_topk_cap and cfg.topk_cap is not None:
            # the sorted tile clips to its child's width, so the full
            # string dictionary — the widest any segment space gets —
            # is the ceiling where topk overflow becomes impossible
            new_tcap = min(round_cap(cfg.topk_cap * self.growth),
                           self._group_ceiling)
            if new_tcap > cfg.topk_cap:
                cfg = dataclasses.replace(cfg, topk_cap=new_tcap)
                grew = True
        if not grew:
            raise QueryOverflowError(
                "overflow persists with capacities at their ceilings "
                f"(scan_cap={cfg.scan_cap}, join_cap={cfg.join_cap}, "
                f"group_cap={cfg.group_cap}, "
                f"topk_cap={cfg.topk_cap}, "
                f"join_bucket={cfg.join_bucket}) — result would be "
                "inexact")
        return cfg

    # -- serving ------------------------------------------------------------------

    def execute(self, query: Query,
                bindings: Optional[Sequence] = None) -> ResultSet:
        """Run to an exact result: cache-hit fast path (shared across
        all constant-variants of a template), overflow-driven regrowth
        slow path (bounded retries, each landing in the cache so the
        workload pays a growth step once). ``bindings`` overrides the
        prepared query's parameter values (defaults: the literals of
        the source query)."""
        pq = self.prepare(query)
        values = self._values_for(pq, bindings)
        params = bind_params(self.db, pq.specs, values,
                             device=self.executor.device)
        self.stats.executions += 1
        self._note_binding(pq.signature, values)
        cfg = (self._good_cfg.get(pq.signature)
               or self._presized_config(pq.plan))
        with self.tracer.span("execute", cat="service") as span:
            span.set(sig=sig_digest(pq.signature))
            for attempt in range(self.max_retries + 1):
                cp = self.compiled(pq.plan, cfg, sig=pq.signature,
                                   param_specs=pq.specs)
                rs = self.executor.run_compiled(cp, params=params)
                self._ran(cp)
                self.stats.runs += 1
                if not rs.overflow:
                    self._note_good_cfg(pq.signature, cfg)
                    return rs
                if attempt == self.max_retries:
                    break
                grown = self._grown_config(cfg, rs)
                self._note_regrow(pq.signature, cfg, grown)
                cfg = grown
                self.stats.retries += 1
        raise QueryOverflowError(
            f"still overflowing after {self.max_retries} regrowth "
            f"retries (scan_cap={cfg.scan_cap}, "
            f"join_cap={cfg.join_cap}, group_cap={cfg.group_cap}, "
            f"topk_cap={cfg.topk_cap}, "
            f"join_bucket={cfg.join_bucket})")

    # -- batch admission ---------------------------------------------------

    def serve_group(self, pq: PreparedQuery, values_list: Sequence,
                    bucket: Optional[int] = None) -> list[ResultSet]:
        """One same-signature admission group -> ONE batched call, with
        **batched regrowth**: a batch that overflows is retried as one
        regrown batch through the same capacity ladder as scalar
        execution — it is never unbatched into per-request executions.
        ``bucket`` is the padded batch width (default: next power of
        two; the serving runtime passes cost-based buckets instead)."""
        assert pq.specs, "parameterless plans have nothing to stack"
        sig = pq.signature
        values_list = [tuple(v) for v in values_list]
        dev = self.executor.device
        bound = [bind_params(self.db, pq.specs, v, device=dev)
                 for v in values_list]
        if bucket is None:
            bucket = _next_pow2(len(bound))
        assert bucket >= len(bound)
        stacked = stack_params(bound, bucket)
        cfg = (self._good_cfg.get(sig)
               or self._presized_config(pq.plan))
        with self.tracer.span("serve-group", cat="service") as span:
            span.set(sig=sig_digest(sig), requests=len(bound),
                     bucket=bucket)
            for attempt in range(self.max_retries + 1):
                cp = self.compiled(pq.plan, cfg, sig=sig,
                                   param_specs=pq.specs, batch=bucket)
                rss = self.executor.run_compiled_batch(cp, stacked,
                                                       len(bound))
                self._ran(cp)
                self.stats.runs += 1
                if not any(rs.overflow for rs in rss):
                    self._note_good_cfg(sig, cfg)
                    self.stats.executions += len(bound)
                    self.stats.batches += 1
                    self.stats.batched_requests += len(bound)
                    for v in values_list:
                        self._note_binding(sig, v)
                    return rss
                if attempt == self.max_retries:
                    break
                grown = self._grown_config(cfg, _merged_overflow(rss))
                self._note_regrow(sig, cfg, grown)
                cfg = grown
                self.stats.retries += 1
        raise QueryOverflowError(
            f"batch still overflowing after {self.max_retries} "
            f"regrowth retries (scan_cap={cfg.scan_cap}, "
            f"join_cap={cfg.join_cap}, group_cap={cfg.group_cap}, "
            f"topk_cap={cfg.topk_cap}, "
            f"join_bucket={cfg.join_bucket})")

    def execute_batch(self, requests: Sequence) -> list[ResultSet]:
        """Serve concurrent requests with one device dispatch per
        distinct plan shape. Each request is a query (text / plan /
        PreparedQuery) or a ``(query, bindings)`` pair. Requests
        sharing an erased signature are stacked into a batched
        executable (parameter vectors get a leading [B] axis, padded
        to a power-of-two bucket — the async runtime substitutes
        cost-based buckets); singleton or parameterless groups go
        through the scalar path. Results keep request order and are
        exactly what per-request ``execute`` would return — a batch
        that overflows regrows and retries as one batch
        (``serve_group``)."""
        norm: list[tuple[PreparedQuery, tuple]] = []
        for r in requests:
            q, b = r if isinstance(r, tuple) else (r, None)
            pq = self.prepare(q)
            norm.append((pq, self._values_for(pq, b)))
        results: list[Optional[ResultSet]] = [None] * len(norm)
        groups: OrderedDict[str, list[int]] = OrderedDict()
        for i, (pq, _) in enumerate(norm):
            groups.setdefault(pq.signature, []).append(i)
        for sig, idxs in groups.items():
            pq = norm[idxs[0]][0]
            if len(idxs) == 1 or not pq.specs:
                # no batching win: scalar path per request
                for i in idxs:
                    results[i] = self.execute(pq, norm[i][1])
                continue
            rss = self.serve_group(pq, [norm[i][1] for i in idxs])
            for i, rs in zip(idxs, rss):
                results[i] = rs
        return results

    # -- warmup ------------------------------------------------------------

    def warmup(self, templates: Sequence,
               batches: Sequence[int] = ()) -> dict:
        """Compile the known workload mix at boot: prepare every
        template (parse, rewrite, lift, verify) and build its compiled
        plan, so the first real request of each template is a pure
        in-memory cache hit.

        ``templates`` entries are queries (text / plan /
        ``PreparedQuery``) or ``(query, batch_width)`` pairs; each
        entry warms its scalar variant plus the entry's own batch
        width, and ``batches`` adds extra batch widths warmed for
        every parameterized template (the bucket ladder the serving
        runtime is expected to dispatch). Parameterless plans have no
        batched variant and skip the widths. Capacities come from the
        same known-good/presized configs serving would use, so the
        warmed executables ARE the ones requests hit.

        With ``persist_dir`` set, each variant new to the in-memory
        cache also runs once against example parameters, so a fresh
        compile's entry reaches the disk.

        Returns a summary dict: templates prepared, variants warmed,
        compiles actually paid, persist/in-memory hits, and wall
        seconds."""
        t0 = time.perf_counter()  # lint: allow(DET001) — boot-time metric, not on the serving path
        snap = self.stats.snapshot()
        warmed = 0
        seen: set[tuple] = set()
        with self.tracer.span("warmup", cat="service") as span:
            for entry in templates:
                q, width = (entry if isinstance(entry, tuple)
                            else (entry, None))
                if width is not None and (not isinstance(width, int)
                                          or width < 1):
                    raise InvalidArgumentError(
                        f"warmup batch width {width!r} must be a "
                        f"positive int")
                pq = self.prepare(q)
                cfg = (self._good_cfg.get(pq.signature)
                       or self._presized_config(pq.plan))
                widths: list = [None]
                if pq.specs:
                    widths += [w for w in (*batches, width)
                               if w is not None]
                for w in widths:
                    k = (pq.signature, w)
                    if k in seen:
                        continue
                    seen.add(k)
                    misses = self.stats.cache_misses
                    cp = self.compiled(pq.plan, cfg, sig=pq.signature,
                                       param_specs=pq.specs, batch=w)
                    if (self._persist is not None
                            and self.stats.cache_misses > misses):
                        # a variant new to memory runs once, so a fresh
                        # compile can be stored; whether it runs does
                        # not depend on the disk's answer, which may
                        # differ between spmd ranks, so their
                        # collectives stay paired
                        self.executor.prime(cp)
                        self._ran(cp)
                    warmed += 1
            span.set(variants=warmed)
        d = self.stats.diff(snap)
        return {
            "templates": len(set(s for s, _ in seen)),
            "variants": warmed,
            "compiles": d.compiles,
            "persist_hits": d.persist_hits,
            "cache_hits": d.cache_hits,
            "seconds": time.perf_counter() - t0,  # lint: allow(DET001)
        }

    # -- async multi-tenant frontend ---------------------------------------

    def runtime(self, **kwargs):
        """Create (replacing any existing) the serving/ runtime behind
        ``submit()``/``drain()``: SLO-windowed admission on a virtual
        clock, deficit-round-robin tenant fairness, cost-based batch
        bucketing. Keyword arguments go to ``ServingRuntime`` (window,
        max_fill, quantum, policy, clock, measure_service_time)."""
        from repro_torch.core.serving import ServingRuntime
        if self._runtime is not None and (
                len(self._runtime.queue)
                or self._runtime.scheduler.backlog()):
            raise RuntimeError(
                "the current serving runtime still holds admitted, "
                "undispatched requests; drain() before replacing it")
        self._runtime = ServingRuntime(self, **kwargs)
        return self._runtime

    def submit(self, query: Query, bindings: Optional[Sequence] = None,
               *, tenant: str = "default", at: Optional[float] = None,
               slo: Optional[float] = None,
               stream: Optional[str] = None,
               template: Optional[str] = None):
        """Asynchronously admit one request into the serving runtime
        (created with defaults on first use). Returns a ``Ticket``
        whose ``result`` is filled by ``drain()``. ``at`` is the
        request's virtual arrival time; ``tenant`` feeds cross-tenant
        fairness; ``stream`` folds the request's grouped result into
        the named windowed stream (serving/window.py) as one window's
        partial; ``template`` names the workload template (Q1..Q12)
        for the flight recorder, when one is attached."""
        if self._runtime is None:
            self.runtime()
        return self._runtime.submit(query, bindings, tenant=tenant,
                                    at=at, slo=slo, stream=stream,
                                    template=template)

    def stream_result(self, name: str) -> list:
        """Finalized grouped rows of a windowed stream accumulated via
        ``submit(..., stream=name)`` — merged across every absorbed
        admission window in canonical order."""
        if self._runtime is None:
            raise KeyError(name)
        return self._runtime.stream_result(name)

    def drain(self, budget: Optional[int] = None) -> list:
        """Dispatch every admitted request to completion (closing
        admission windows at their virtual deadlines) and return all
        tickets in submission order."""
        if self._runtime is None:
            return []
        return self._runtime.drain(budget)

    # -- bucketing cost inputs ---------------------------------------------

    def row_cost(self, pq: PreparedQuery) -> int:
        """Per-request padded row cost of one signature: the
        per-partition scan capacity of its CURRENT serving config
        (every padded batch slot re-executes the plan over this many
        rows). A known-good config — which regrowth keeps current — is
        always read live so the cost tracks grown capacities; only the
        statistics-presized first estimate is memoized (its plan walk
        is the expensive part, and it never changes)."""
        sig = pq.signature
        good = self._good_cfg.get(sig)
        if good is not None:
            return good.scan_cap or self._scan_ceiling
        cost = self._row_cost.get(sig)
        if cost is None:
            cfg = self._presized_config(pq.plan)
            cost = cfg.scan_cap
            if cost is None:
                # presize estimation failed (no stats / ambiguous
                # unnest source): fall back to the capacity-flow
                # analysis' static scan bound before assuming the
                # full padded table
                from repro_torch.core.analysis import capflow
                bound = capflow.analyze(
                    pq.plan, db=self.db).bound_for("scan_cap")
                if bound is not None:
                    cost = round_cap(bound)
            cost = cost or self._scan_ceiling
            self._row_cost[sig] = cost
            self._evict(self._row_cost, self._good_cfg_capacity,
                        "row_cost")
        return cost

    def row_cost_for_signature(self, sig: str) -> int:
        """Signature-keyed row cost for the bucketing policy: the
        live known-good config when one exists, else the memoized
        presized estimate, else the scan ceiling."""
        good = self._good_cfg.get(sig)
        if good is not None:
            return good.scan_cap or self._scan_ceiling
        return self._row_cost.get(sig, self._scan_ceiling)

    # -- explain / profiling -----------------------------------------------

    @contextlib.contextmanager
    def _profiling(self):
        """Arm profile-mode compilation: while active, ``compiled()``
        keys and compiles profile variants (executor ``profile=True``,
        per-op row counts in the outputs) separately from serving
        variants — the serving cache entries and the warm path are
        untouched."""
        prev = self._profile_mode
        self._profile_mode = True
        try:
            yield
        finally:
            self._profile_mode = prev

    def explain(self, query: Query,
                bindings: Optional[Sequence] = None, *,
                profile: bool = False, path: str = "prepared"):
        """Operator-annotated plan profile (obs/profile.QueryProfile).

        ``profile=False`` joins only static facts: the plan tree, the
        cap that bounds each operator, capacity-flow static bounds and
        the config the service would run. ``profile=True`` runs the
        query once through a profile-mode compilation and adds runtime
        facts: global valid rows out of every (unfused) operator, cap
        utilization vs the actual (possibly regrown) capacity,
        overflow/regrowth events, and the compile-vs-execute wall
        split. ``path`` picks the serving route of the profiled run:
        "prepared" (scalar execute), "batched" (a serve_group
        dispatch), or "scheduled" (a standalone admission/DRR runtime
        in front of the same service). Profiled results stay exact —
        the profile run goes through the same regrowth ladder."""
        assert path in ("prepared", "batched", "scheduled"), path
        from repro_torch.core.obs.profile import build_profile
        pq = self.prepare(query)
        sig = pq.signature
        if not profile:
            cfg = (self._good_cfg.get(sig)
                   or self._presized_config(pq.plan))
            return build_profile(pq, db=self.db, config=cfg,
                                 path="static", mode=self.mode)
        h = self._history_for(sig)
        compile_s0, nregrow0 = h["compile_s"], len(h["regrowths"])
        snap = self.stats.snapshot()
        t0 = time.perf_counter()  # lint: allow(DET001) — explain-only wall split
        with self._profiling():
            if path == "batched" and pq.specs:
                values = self._values_for(pq, bindings)
                rs = self.serve_group(pq, [values, values])[0]
            elif path == "scheduled":
                from repro_torch.core.serving.scheduler import ServingRuntime
                prev_clock = self.tracer.clock
                try:
                    # standalone runtime: the service's main runtime
                    # (and its backlog) stays untouched
                    rt = ServingRuntime(self)
                    ticket = rt.submit(pq, bindings)
                    rt.drain()
                finally:
                    self.tracer.clock = prev_clock
                if ticket.error is not None:
                    raise ticket.error
                rs = ticket.result
            else:
                # "prepared" (and "batched" on a parameterless plan,
                # which has nothing to stack)
                rs = self.execute(pq, bindings)
        total_s = time.perf_counter() - t0  # lint: allow(DET001)
        delta = self.stats.diff(snap)
        compile_s = h["compile_s"] - compile_s0
        cfg = (self._good_cfg.get(sig)
               or self._presized_config(pq.plan))
        return build_profile(
            pq, db=self.db, config=cfg, rs=rs, path=path,
            mode=self.mode, compile_s=compile_s,
            execute_s=max(total_s - compile_s, 0.0),
            compiles=delta.compiles, retries=delta.retries,
            regrowths=h["regrowths"][nregrow0:])


def _merged_overflow(rss: Sequence[ResultSet]):
    """The union of per-stage overflow flags across one batch — what
    the regrowth ladder reads to grow exactly the saturated capacity
    for the whole batch at once."""
    return types.SimpleNamespace(
        overflow_scan=any(rs.overflow_scan for rs in rss),
        overflow_join=any(rs.overflow_join for rs in rss),
        overflow_join_cap=any(rs.overflow_join_cap for rs in rss),
        overflow_group_cap=any(rs.overflow_group_cap for rs in rss),
        overflow_topk_cap=any(rs.overflow_topk_cap for rs in rss))
