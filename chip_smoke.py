#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed as it runs:

1. environment: torch/CUDA versions, the card, the kernels' build time
   (every ``csrc/*.cu`` is compiled by nvcc at first use);
2. each CUDA kernel against its plain PyTorch version on the card, on
   seeded edge-shape inputs (ragged sizes, duplicate join keys, invalid
   rows, segment ids outside [0, S), masked NaNs, C = 0, S >= 4096,
   cap == N, tie-heavy keys);
3. the main path: the NOAA-GHCN-shaped weather collections of the
   paper's §5 at 2000 stations x 50 years x 8 days (4,000,000 /sensors
   readings, P = 4 partitions), Q1–Q12 through ``compile_query`` ->
   ``Executor(db).run`` with statistics-presized caps, once on the
   kernel route and once on the plain route (kernel knobs pinned
   False); the two raw-output dicts must agree, and every result must
   agree with a numpy computation straight from the generated records;
4. each kernel again, on the largest input the main path gave it,
   timed beside its plain version, a PyTorch library call where one
   computes the same function, and its bound.

Then one JSON line with the kernels' numbers, the card's name and
power limit, and the last line ``{"ok": true, "device": {...}}``. Any
failure exits non-zero without that line, as does a machine without
CUDA or a directory without the port's sources.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPEC = {"num_stations": 2000, "years": tuple(range(1955, 2005)),
        "days_per_year": 8}
PARTITIONS = 4
SEED = 0
SUM_RTOL = 1e-5      # float sums (another order, or another association)
REF_RTOL = 1e-5      # float32 results vs the float64 numpy reference
# H100 SXM HBM3 memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
# result positions (DistributeResult order) that are sums, averages or
# divisions: compared to SUM_RTOL between routes, all else exactly
TOLERANT = {"Q3": {0}, "Q4": {0}, "Q7": {0}, "Q8": {0}, "Q9": {2},
            "Q10": {1}, "Q11": {2}, "Q12": {2}}


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, budget_s: float = 0.25, max_iters: int = 50) -> float:
    """Mean device time of ``fn`` in ms over a run of launches, timed
    with CUDA events after two warm-up calls."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(max(3, min(max_iters, budget_s * 1e3 / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions on seeded edge shapes
# ---------------------------------------------------------------------------

def _gen(seed: int, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def join_inputs(p, nb, np_, nkeys, seed, dev):
    """Duplicate build keys, probe keys that mostly hit, ~15 % invalid."""
    import torch
    g = _gen(seed, dev)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    bk = [ints(0, nb // 2 + 1, (p, nb))]
    pk = [ints(0, nb // 2 + 20, (p, np_))]
    if nkeys == 2:
        bk.append(ints(-3, 3, (p, nb)))
        pk.append(ints(-3, 3, (p, np_)))
    bv = torch.rand((p, nb), generator=g, device=dev) > 0.15
    pv = torch.rand((p, np_), generator=g, device=dev) > 0.15
    return tuple(bk), bv, tuple(pk), pv


def agg_inputs(p, n, s, nc, seed, dev):
    """Tenths-valued columns, NaNs masked through ``ok``, invalid rows,
    segment ids outside [0, S)."""
    import torch
    g = _gen(seed, dev)
    vals = torch.randint(-400, 400, (p, n, nc), generator=g,
                         device=dev).float() / 10
    vals[torch.rand((p, n, nc), generator=g, device=dev) < 0.05] = float("nan")
    ok = (torch.rand((p, n, nc), generator=g, device=dev) > 0.1) \
        & ~torch.isnan(vals)
    segs = torch.randint(-1, s + 2, (p, n), generator=g, device=dev,
                         dtype=torch.int32)
    valid = torch.rand((p, n), generator=g, device=dev) > 0.2
    return vals, ok, segs, valid, s


def topk_inputs(p, n, seed, dev, float_key=True):
    """Flag, a tie-heavy float key holding both zeros, an int key."""
    import torch
    g = _gen(seed, dev)
    valid = torch.rand((p, n), generator=g, device=dev) > 0.3
    f = torch.randint(-3, 4, (p, n), generator=g, device=dev).float()
    negz = (f == 0) & (torch.rand((p, n), generator=g, device=dev) < 0.5)
    f = torch.where(negz, torch.full_like(f, -0.0), f)
    i = torch.randint(0, 5, (p, n), generator=g, device=dev,
                      dtype=torch.int32)
    return ((~valid).to(torch.int32), f if float_key else f.to(torch.int32), i)


def check_join(args) -> float:
    import torch
    from repro_torch.kernels import hash_join, ref
    pos, matched = hash_join.block_join_probe(*args)
    want, wm = ref.block_join_probe(*args)
    torch.cuda.synchronize()
    require(torch.equal(pos, want) and torch.equal(matched, wm),
            "block_join_probe disagrees with its plain version")
    return 0.0


def check_agg(args) -> float:
    """Counts, mins and maxs exact; each sum within SUM_RTOL of the sum
    of its values' magnitudes (the float-sum error bound). Returns the
    largest absolute difference of the sums."""
    import torch
    from repro_torch.kernels import ref, seg_aggregate
    vals, ok, segs, valid, s = args
    got = seg_aggregate.segmented_aggregate(vals, ok, segs, valid, s)
    want = ref.segmented_aggregate(vals, ok, segs, valid, s)
    mag = ref.segmented_aggregate(vals.abs(), ok, segs, valid, s)[1]
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]), "segmented_aggregate counts")
    require(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
            "segmented_aggregate mins/maxs")
    err = (got[1] - want[1]).abs()
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= SUM_RTOL * mag + 1e-30).all()),
            f"segmented_aggregate sums off by up to {worst}")
    again = seg_aggregate.segmented_aggregate(vals, ok, segs, valid, s)
    require(torch.equal(again[1], got[1]),
            "segmented_aggregate sums differ from run to run")
    return worst


def check_topk(keys, cap) -> float:
    import torch
    from repro_torch.kernels import ref, seg_topk
    got = seg_topk.segment_topk(keys, cap)
    want = ref.segment_topk(keys, cap)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "segment_topk disagrees with its plain "
            "version")
    return 0.0


def edge_checks(dev) -> dict[str, float]:
    errs = {"block_join_probe": 0.0, "segmented_aggregate": 0.0,
            "segment_topk": 0.0}
    for i, (p, nb, np_, nk) in enumerate([(4, 1000, 777, 1),
                                          (4, 2049, 3000, 2),
                                          (1, 5, 1, 2), (2, 1, 300, 1)]):
        e = check_join(join_inputs(p, nb, np_, nk, SEED + i, dev))
        errs["block_join_probe"] = max(errs["block_join_probe"], e)
    for i, (p, n, s, nc) in enumerate([(4, 5000, 37, 2), (4, 3001, 4500, 3),
                                       (2, 700, 9000, 4), (3, 999, 16, 0),
                                       (4, 300000, 2000, 1)]):
        e = check_agg(agg_inputs(p, n, s, nc, SEED + 10 + i, dev))
        errs["segmented_aggregate"] = max(errs["segmented_aggregate"], e)
    for i, (p, n, cap, fk) in enumerate([(4, 2000, 16, True),
                                         (2, 1500, 1500, True),
                                         (3, 33, 5, False), (1, 1, 1, True)]):
        e = check_topk(topk_inputs(p, n, SEED + 20 + i, dev, fk), cap)
        errs["segment_topk"] = max(errs["segment_topk"], e)
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def reference_results(spec) -> dict:
    """Q1–Q12 computed with numpy straight from the generated records
    (no XML, no plans, no tensors): row counts for the row queries,
    values for the scalar and grouped ones (station id order; Q11 in
    ranking order)."""
    import numpy as np
    from repro_torch.data.weather import _make_records
    rec = _make_records(spec)
    ns, nd, nt = spec.num_stations, len(spec.dates()), len(spec.datatypes)
    st, di = rec["station"], rec["date"]
    val = rec["value"].astype(np.float64)
    tname = np.asarray(spec.datatypes)[rec["dtype"]]
    year = np.asarray([d[0] for d in spec.dates()])[di]
    mday = np.asarray([d[1] * 100 + d[2] for d in spec.dates()])[di]
    sid = np.asarray([spec.station_id(i) for i in range(ns)])
    wash = np.asarray([spec.station_state(i) == "WASHINGTON"
                       for i in range(ns)])
    us = np.asarray([spec.station_is_us(i) for i in range(ns)])
    v3 = val.reshape(ns, nd, nt)
    tmax, tmin = (spec.datatypes.index(t) for t in ("TMAX", "TMIN"))

    def per_station(mask):
        cnt = np.bincount(st[mask], minlength=ns).astype(np.float64)
        tot = np.bincount(st[mask], weights=val[mask], minlength=ns)
        lo = np.full(ns, np.inf)
        hi = np.full(ns, -np.inf)
        np.minimum.at(lo, st[mask], val[mask])
        np.maximum.at(hi, st[mask], val[mask])
        return cnt, tot, lo, hi

    out = {
        "Q1": int(np.sum((st == 0) & (year >= 2003) & (mday == 1225))),
        "Q2": int(np.sum((tname == "AWND") & (val > 491.744))),
        "Q3": val[(st == 1) & (tname == "PRCP") & (year == 1999)].sum() / 10,
        "Q4": val[tname == "TMAX"].max() / 10,
        "Q5": int(np.sum(wash[st] & (year == 1976) & (mday == 704))),
        "Q6": int(np.sum((tname == "TMAX") & (year == 2000))),
        "Q7": val[us[st] & (tname == "TMIN") & (year == 2001)].min() / 10,
        "Q8": (v3[:, :, tmax] - v3[:, :, tmin]).mean() / 10,
    }
    cnt, tot, _, _ = per_station(tname == "TMAX")
    order = np.argsort(sid)
    out["Q9"] = [(sid[i], cnt[i], tot[i] / cnt[i]) for i in order if cnt[i]]
    rank = sorted(range(ns), key=lambda i: (-tot[i], sid[i]))[:3]
    out["Q11"] = [(sid[i], cnt[i], tot[i]) for i in rank]
    cnt, tot, _, hi = per_station(tname == "PRCP")
    out["Q10"] = [(sid[i], tot[i], hi[i]) for i in order
                  if cnt[i] and tot[i] >= 100]
    cnt, tot, lo, hi = per_station((tname == "PRCP") & (year == 2000))
    out["Q12"] = [(sid[i], cnt[i], tot[i], lo[i], hi[i]) for i in order
                  if cnt[i]]
    return out


def check_reference(name: str, rows: list, want) -> None:
    import numpy as np
    if isinstance(want, int):
        require(len(rows) == want, f"{name}: {len(rows)} rows, want {want}")
        return
    if not isinstance(want, list):
        require(len(rows) == 1 and np.isclose(rows[0][0], want,
                                              rtol=REF_RTOL, atol=0),
                f"{name}: {rows} vs {want}")
        return
    got = rows if name == "Q11" else sorted(rows, key=lambda r: r[0])
    require(len(got) == len(want), f"{name}: {len(got)} groups, want "
            f"{len(want)}")
    for g, w in zip(got, want):
        require(g[0] == w[0] and np.allclose(g[1:], w[1:], rtol=REF_RTOL,
                                             atol=0),
                f"{name}: {g} vs {w}")


def raw_agree(name: str, plan, a: dict, b: dict) -> None:
    """Kernel route vs plain route: valid, the flags and integer columns
    exact; floats from sums/avgs/divisions to SUM_RTOL, others exact."""
    import numpy as np
    require(set(a) == set(b), f"{name}: raw keys differ")
    valid = a["valid"]
    require(np.array_equal(valid, b["valid"]), f"{name}: valid differs")
    for k in a:
        if k.startswith("overflow"):
            require(np.array_equal(a[k], b[k]), f"{name}: {k} differs")
    for pos, v in enumerate(plan.vars):
        ga, gb = a[f"var{v}"], b[f"var{v}"]
        for x, y in (zip(ga, gb) if isinstance(ga, tuple) else [(ga, gb)]):
            x, y = x[valid], y[valid]
            if x.dtype == np.float32 and pos in TOLERANT.get(name, ()):
                ok = np.allclose(x, y, rtol=SUM_RTOL, atol=0, equal_nan=True)
            else:
                ok = np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
            require(ok, f"{name}: var{v} differs between routes")


class Capture:
    """Wraps the executor-facing kernel entry points during the
    kernel-route runs and keeps, per kernel, the arguments of the call
    with the most work — the main path's own inputs for phase 4."""

    def __init__(self, ops):
        self.ops = ops
        self.saved = {}
        self.best: dict[str, tuple] = {}

    def _wrap(self, attr, kernel, work):
        fn = getattr(self.ops, attr)
        self.saved[attr] = fn

        def wrapped(*args, **kw):
            w = work(*args)
            if kernel not in self.best or w > self.best[kernel][0]:
                self.best[kernel] = (w, args)
            return fn(*args, **kw)

        setattr(self.ops, attr, wrapped)

    def __enter__(self):
        self._wrap("hash_join_probe", "block_join_probe",
                   lambda bk, bv, pk, pv: bv.numel() * pv.shape[1])
        self._wrap("segmented_aggregate", "segmented_aggregate",
                   lambda v, ok, s, vl, ns: s.numel() * ns * (1 + v.shape[2]))
        self._wrap("segment_topk", "segment_topk",
                   lambda keys, cap: keys[0].numel() * len(keys) * cap)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.ops, attr, fn)


def run_query(ex, plan, cfg) -> tuple:
    """(numpy raw dict, ResultSet, ms) of one ``Executor.run_compiled``:
    the device run and the copy of its raw outputs to the host (rows
    are decoded from them afterwards, outside the time)."""
    import torch
    cp = ex.compile(plan, config=cfg)
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    t0 = time.perf_counter()
    rs = ex.run_compiled(cp)
    return rs.raw, rs, (time.perf_counter() - t0) * 1e3


def main_path(ex, spec, capture=None) -> list[dict]:
    """Q1–Q12 on the kernel route (cold and warm) and on the plain route,
    checked against each other and against ``reference_results``."""
    import torch
    from repro_torch.core import compile_query
    from repro_torch.core.presize import presized_config
    from repro_torch.core.queries import ALL
    want = reference_results(spec)
    on_cuda = ex.device.type == "cuda"
    records = []
    for name, text in ALL.items():
        plan = compile_query(text)
        cfg = presized_config(ex.db, plan)
        plain = dataclasses.replace(cfg, use_kernel_join=False,
                                    use_kernel_segments=False)
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(ex.device)
        _, _, cold_ms = run_query(ex, plan, cfg)
        with capture if capture is not None else contextlib.nullcontext():
            raw, rs, warm_ms = run_query(ex, plan, cfg)
        peak = torch.cuda.max_memory_allocated(ex.device) if on_cuda else 0
        praw, _, plain_ms = run_query(ex, plan, plain)
        require(not rs.overflow, f"{name}: overflow at presized caps {cfg}")
        raw_agree(name, plan, raw, praw)
        rows = rs.rows()
        check_reference(name, rows, want[name])
        rec = {"query": name, "rows": len(rows), "cold_ms": cold_ms,
               "warm_ms": warm_ms, "plain_warm_ms": plain_ms,
               "peak_mib": peak / 2**20,
               "caps": {k: getattr(cfg, k) for k in
                        ("scan_cap", "join_cap", "group_cap", "topk_cap")}}
        log("query " + json.dumps(rec))
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 4: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

def _ordered_u32(k):
    """Order-preserving unsigned bits of an int32/float32 key, int64."""
    import torch
    if k.dtype == torch.float32:
        b = (k + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    return (k.to(torch.int64) + 2**31)


def topk_library(keys, cap):
    """One stable torch.sort over the keys packed into an int64 — the
    same selection when this run's key ranges fit in 63 bits, else
    None."""
    import torch
    parts = []
    for k in keys:
        u = _ordered_u32(k)
        lo, hi = int(u.min()), int(u.max())
        parts.append((u - lo, max(1, (hi - lo).bit_length())))
    if sum(b for _, b in parts) > 63:
        return None
    packed = torch.zeros_like(parts[0][0])
    for u, bits in parts:
        packed = (packed << bits) | u

    def fn():
        return torch.sort(packed, dim=1, stable=True)[1][:, :cap]

    return fn


def agg_library(vals, ok, segs, valid, s):
    """scatter_reduce over the flat [P * S + 1] slots: one sum over
    [count | values], one amin, one amax."""
    import torch
    p, n, nc = vals.shape
    keep = valid & (segs >= 0) & (segs < s)
    slot = torch.where(keep, torch.arange(p, device=vals.device)[:, None] * s
                       + segs, torch.full_like(segs, p * s)).long()
    okm = ok & keep[:, :, None]
    src = torch.cat([keep[:, :, None].float(),
                     torch.where(okm, vals, 0.0)], 2).reshape(p * n, nc + 1)
    lo = torch.where(okm, vals, float("inf")).reshape(p * n, nc)
    hi = torch.where(okm, vals, float("-inf")).reshape(p * n, nc)
    idx1 = slot.reshape(-1, 1).expand(-1, nc + 1)
    idx = slot.reshape(-1, 1).expand(-1, nc)

    def fn():
        a = torch.zeros(p * s + 1, nc + 1, device=vals.device)
        a.scatter_reduce_(0, idx1, src, "sum")
        b = torch.full((p * s + 1, nc), float("inf"), device=vals.device)
        b.scatter_reduce_(0, idx, lo, "amin")
        c = torch.full((p * s + 1, nc), float("-inf"), device=vals.device)
        c.scatter_reduce_(0, idx, hi, "amax")
        return a, b, c

    return fn


def main_shape_timings(best: dict, launches: dict, edge_errs: dict) -> list:
    """Phase 4: each kernel on the largest input the main path gave it:
    parity with the plain version, device times, and the bound."""
    from repro_torch.kernels import hash_join, ref, seg_aggregate, seg_topk
    from repro_torch.kernels.registry import KERNELS
    out = []
    for name, entry in KERNELS.items():
        require(name in best, f"the main path never reached {name}")
        args = best[name][1]
        lib = None
        if name == "block_join_probe":
            bk, bv, pk, pv = args
            err = check_join((tuple(bk), bv, tuple(pk), pv))

            def run():
                return hash_join.block_join_probe(tuple(bk), bv, tuple(pk),
                                                  pv)

            def plain():
                return ref.block_join_probe(tuple(bk), bv, tuple(pk), pv)

            # each key read once, positions and flags written once
            nbytes = sum(k.numel() * 4 for k in bk + pk) + bv.numel() \
                + pv.numel() + pv.numel() * 5
            shape = {"P": pv.shape[0], "NP": pv.shape[1], "NB": bv.shape[1],
                     "keys": len(bk)}
        elif name == "segmented_aggregate":
            vals, ok, segs, valid, s = args
            err = check_agg(args)

            def run():
                return seg_aggregate.segmented_aggregate(*args)

            def plain():
                return ref.segmented_aggregate(*args)

            lib = agg_library(*args)
            p, n, nc = vals.shape
            nbytes = vals.numel() * 4 + ok.numel() + segs.numel() * 4 \
                + valid.numel() + p * s * 4 * (1 + 3 * nc)
            shape = {"P": p, "N": n, "S": s, "C": nc}
        else:
            keys, cap = args
            err = check_topk(keys, cap)

            def run():
                return seg_topk.segment_topk(keys, cap)

            def plain():
                return ref.segment_topk(keys, cap)

            lib = topk_library(keys, cap)
            nbytes = sum(k.numel() * 4 for k in keys) \
                + keys[0].shape[0] * cap * 4
            shape = {"P": keys[0].shape[0], "N": keys[0].shape[1],
                     "keys": len(keys), "cap": cap}
        rec = {"name": name, "route": "cuda", "source": entry["source"],
               "replaces": entry["replaces"], "launches": launches[name],
               "max_abs_err": max(err, edge_errs[name]),
               "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": cuda_ms(lib) if lib is not None else None}
        log(f"kernel {name} at main-path shape {json.dumps(shape)}: "
            + json.dumps(rec))
        out.append(rec)
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on a GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Executor
    from repro_torch.data.weather import WeatherSpec, build_database
    from repro_torch.kernels import _build, hash_join, ops, seg_aggregate
    from repro_torch.kernels import seg_topk
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"env python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} | {smi}")
    build_s = _build.build_all()
    log(f"env kernels built in {build_s:.3f} s into {_build.BUILD_DIR}")

    t0 = time.perf_counter()
    edge_errs = edge_checks(dev)
    log(f"kernels edge-shape parity ok {json.dumps(edge_errs)} "
        f"({time.perf_counter() - t0:.1f} s)")

    spec = WeatherSpec(**SPEC)
    t0 = time.perf_counter()
    db = build_database(spec, PARTITIONS)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = Executor(db, device=dev)
    torch.cuda.synchronize()
    nodes = sum(t["kind"].numel() for k, t in ex.tables.items()
                if k != "__derived__")
    log(f"data {json.dumps(SPEC)} P={PARTITIONS}: {nodes} padded nodes, "
        f"{len(db.strings)} strings, ingest {ingest_s:.1f} s, upload "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")

    wrappers = {"block_join_probe": hash_join.block_join_probe,
                "segmented_aggregate": seg_aggregate.segmented_aggregate,
                "segment_topk": seg_topk.segment_topk}
    for w in wrappers.values():
        w.launches = 0
    capture = Capture(ops)
    main_path(ex, spec, capture)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"main path launches {json.dumps(launches)}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    kernels = main_shape_timings(capture.best, launches, edge_errs)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
