#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printed as it runs:

1. environment: torch/CUDA versions, the card, the kernels' build time
   (every ``csrc/*.cu`` is compiled by nvcc at first use);
2. each CUDA kernel against its plain PyTorch version on the card, on
   seeded edge-shape inputs (ragged sizes, duplicate join keys, invalid
   rows; the join's hash table at its worst: every build key equal, no
   probe key present, keys at INT32_MIN/INT32_MAX, k0 equal with k1
   different and swapped, NB = 2^20 + 3, NB = 1 and NB = 0, bit-equal;
   segment ids outside [0, S), masked NaNs, C = 0, S >= 4096,
   cap == N, tie-heavy keys, N over several sorted chunks (the top-k
   merge), all rows invalid; attention causal and not, windows 4096,
   100 and 16, softcap 50, GQA g in {1, 2, 8}, ragged Sq/Sk and Sq < Sk,
   head_dim 64/80/128/256 at several tiles, bf16 and float32, the same bits
   from launch to launch; decode in bf16 and float32 with kv_len in
   {0, 1, ragged, Smax}, an Smax that is no multiple of a tile, one
   split, more heads than resident CTAs, and two calls in a row (the
   fused combine's counters); both aggregate kernels also on
   station-major sorted runs (97 equal ids in a row, across tiles), one
   hot segment, 0.4 % valid rows in clusters, S = 1, N no multiple of
   the flag vector or of a warp, and no row valid; sums the same bits
   on a second launch);
3. the query path: the NOAA-GHCN-shaped weather collections of the
   paper's §5 at 2000 stations x 50 years x 8 days (4,000,000 /sensors
   readings, P = 4 partitions), Q1–Q12 through ``compile_query`` ->
   ``Executor(db).run`` with statistics-presized caps, once on the
   kernel route and once on the plain route (kernel knobs pinned
   False); the two raw-output dicts must agree, and every result must
   agree with a numpy computation straight from the generated records;
4. each executor kernel again, on the largest input the query path
   gave it, timed beside its plain version, a PyTorch library call
   where one computes the same function, and its bound
   (``segmented_aggregate`` also on the input with the most valid rows,
   its bound counting the flags and the valid rows only;
   ``segmented_sum_count``, which no path launches, on the value
   column of the largest group-by input);
5. the LM serving path: qwen3-1.7b at its full published size (28
   layers, d_model 2048, 16/8 heads, vocab 151936; seeded random
   weights on the card) through ``launch.serve.serve_batch`` with 8
   requests of up to 2048 prompt tokens and 32 generated tokens, twice
   on the kernel route (cold, warm: 28 flash-kernel launches and
   28 x 32 decode-kernel launches each), then once on the plain route
   (dense attention in prefill and decode) teacher-forced with the
   kernel route's tokens; prefill logits and every decode step's logits
   must agree within LOGIT_ATOL. Then the two attention kernels, as in
   phase 4, on the inputs the serve gave them.

6. the service path, on phase 3's database once phase 3's executor is
   freed: Q1–Q12 through ``QueryService(db).execute`` cold and warm,
   against the numpy reference and against a service whose base config
   pins the plain routes; the 64 constant-variants of
   ``workload.make_workload`` through ``execute`` (one compile per
   template, each variant equal to an executor run of its baked plan)
   and through ``execute_batch`` (one batch per template, equal to the
   per-request results); Q8, Q10 and Q11 regrown from caps of 1;
   64 requests of multi-tenant traffic through ``submit``/``drain``,
   each equal to a direct ``execute``; ``explain(Q8, profile=True)``
   with the same operator rows on both routes. The three query kernels
   must launch on this path and the attention kernels not.

Phase 3's ``query`` lines also give each query's peak device memory and
the join kernel's hash-table scratch (``join_table_mib``); phase 6's
``service`` lines give cold and warm ms, caps, retries, compiles, peak
memory and the bytes copied to the host. Phase 4 also times the flash
kernel at hubert-xlarge's attention shape (16 heads, head_dim 80,
2048 frames, not causal, bf16) beside ``scaled_dot_product_attention``.

Then one JSON line with the six kernels' numbers, the card's name and
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
# H100 SXM HBM3 memory rate and dense tensor-core peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# attention kernel vs plain version: float32 another summation order,
# bf16 outputs rounded to bf16 (one ulp below 4 is at most 1.6e-2)
ATT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the LM path (phase 5)
LM_ARCH = "qwen3-1.7b"
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 2048, 32
# kernel route vs plain route, teacher-forced: largest absolute
# difference of any prefill or decode-step logit. Both routes compute in
# bf16; the attention outputs differ in the last bf16 bit here and there,
# and 28 layers carry that into logits of standard deviation ~1.
LOGIT_ATOL = 0.25
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


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def join_edge_inputs(kind, p, nb, np_, nkeys, seed, dev):
    """The hash table's worst cases, ~15 % invalid rows on both sides:
    ``equal`` every build key equal; ``miss`` no probe key present;
    ``extreme`` keys at INT32_MIN/INT32_MAX and negative, duplicated;
    ``k0`` k0 equal everywhere, k1 different, and probes that swap
    (k0, k1); ``random`` ``join_inputs``."""
    import torch
    if kind == "random":
        return join_inputs(p, nb, np_, nkeys, seed, dev)
    g = _gen(seed, dev)

    def ints(lo, hi, n):
        return torch.randint(lo, hi + 1, (p, n), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def share(n, x):
        return torch.rand((p, n), generator=g, device=dev) < x

    if kind == "equal":
        bk = [torch.full((p, nb), 7, dtype=torch.int32, device=dev),
              torch.full((p, nb), -2, dtype=torch.int32, device=dev)]
        hit = share(np_, 0.5)
        pk = [torch.where(hit, 7, ints(-9, 9, np_)).int(),
              torch.where(hit, -2, ints(-3, 3, np_)).int()]
    elif kind == "miss":
        bk = [ints(0, nb, nb), ints(-5, 5, nb)]
        pk = [ints(nb + 1, 3 * nb + 1, np_), ints(-5, 5, np_)]
    elif kind == "extreme":
        pool = torch.tensor([I32_MIN, I32_MIN + 1, -2, -1, 0, 1,
                             I32_MAX - 1, I32_MAX], dtype=torch.int32,
                            device=dev)
        bk = [pool[ints(0, 7, nb).long()], pool[ints(0, 7, nb).long()]]
        pk = [pool[ints(0, 7, np_).long()], pool[ints(0, 7, np_).long()]]
        bk[0] = torch.where(share(nb, 0.3), ints(I32_MIN, -1, nb), bk[0])
        pk[0] = torch.where(share(np_, 0.3),
                            bk[0][:, ints(0, nb - 1, np_)[0].long()], pk[0])
    elif kind == "k0":
        bk = [torch.full((p, nb), 3, dtype=torch.int32, device=dev),
              ints(0, nb, nb)]
        pk = [torch.full((p, np_), 3, dtype=torch.int32, device=dev),
              ints(0, 2 * nb, np_)]
        swap = share(np_, 0.3)
        pk = [torch.where(swap, pk[1], pk[0]), torch.where(swap, pk[0], pk[1])]
    else:
        raise ValueError(kind)
    return (tuple(bk[:nkeys]), ~share(nb, 0.15), tuple(pk[:nkeys]),
            ~share(np_, 0.15))


# the join's edge inputs: kind, P, NB, NP, keys
JOIN_EDGES = [
    ("random", 4, 1000, 777, 1), ("random", 4, 2049, 3000, 2),
    ("random", 1, 5, 1, 2), ("random", 2, 1, 300, 1),
    ("equal", 4, 200000, 50000, 2), ("equal", 2, 64, 100, 1),
    ("miss", 4, 100000, 100000, 2), ("extreme", 4, 50000, 40000, 2),
    ("extreme", 2, 257, 129, 1), ("k0", 4, 30000, 40000, 2),
    ("random", 2, 2**20 + 3, 100000, 2),   # 2^22 table slots
    ("random", 2, 1, 50, 2), ("random", 2, 0, 300, 2),
]


def seg_layout(g, p, n, s, kind, dev):
    """Segment ids and valid flags [P, N] of the aggregate edge cases:
    ``runs`` station-major runs of 97 rows of one id (a run crosses the
    kernels' 4096-row tiles), ids cycling over [-1, S], 20 % valid;
    ``hot`` every valid row in segment 0 but a few ids outside [0, S);
    ``sparse`` the runs with 0.4 % of rows valid, in clusters of two
    (Q12's selection); ``none`` the runs with no row valid."""
    import torch
    rows = torch.arange(n, device=dev)[None, :]
    part = torch.arange(p, device=dev)[:, None]
    segs = ((rows // 97 + 13 * part) % (s + 2) - 1).to(torch.int32)
    valid = torch.rand((p, n), generator=g, device=dev) < 0.2
    if kind == "hot":
        far = torch.rand((p, n), generator=g, device=dev) < 0.02
        segs = torch.where(far, s, 0).to(torch.int32)
        valid = torch.rand((p, n), generator=g, device=dev) < 0.9
    elif kind == "sparse":
        valid = (rows + 7 * part) % 500 < 2
    elif kind == "none":
        valid = torch.zeros((p, n), dtype=torch.bool, device=dev)
    elif kind != "runs":
        raise ValueError(kind)
    return segs, valid


def agg_inputs(p, n, s, nc, seed, dev, kind="random"):
    """Tenths-valued columns, NaNs masked through ``ok``; ``random``:
    invalid rows, segment ids outside [0, S); else ``seg_layout``."""
    import torch
    g = _gen(seed, dev)
    vals = torch.randint(-400, 400, (p, n, nc), generator=g,
                         device=dev).float() / 10
    vals[torch.rand((p, n, nc), generator=g, device=dev) < 0.05] = float("nan")
    ok = (torch.rand((p, n, nc), generator=g, device=dev) > 0.1) \
        & ~torch.isnan(vals)
    if kind != "random":
        return (vals, ok) + seg_layout(g, p, n, s, kind, dev) + (s,)
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
    """Bit-equal to the plain version, twice (the table is rebuilt)."""
    import torch
    from repro_torch.kernels import hash_join, ref
    pos, matched = hash_join.block_join_probe(*args)
    want, wm = ref.block_join_probe(*args)
    torch.cuda.synchronize()
    shape = tuple(args[3].shape) + (args[1].shape[1], len(args[0]))
    require(torch.equal(pos, want) and torch.equal(matched, wm),
            f"block_join_probe disagrees with its plain version at "
            f"(P, NP, NB, keys) = {shape}")
    require(torch.equal(hash_join.block_join_probe(*args)[0], pos),
            "block_join_probe differs from run to run")
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


def attn_err(got, want, dtype_name: str, what: str) -> float:
    """Largest |got - want|; fails past ATT_TOL[dtype] (atol and rtol)."""
    import torch
    torch.cuda.synchronize()
    tol = ATT_TOL[dtype_name]
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = (g - w).abs()
    worst = float(err.max())
    require(bool((err <= tol + tol * w.abs()).all()),
            f"{what} disagrees with its plain version by up to {worst}")
    return worst


def normal(shape, seed, dev, dtype):
    import torch
    return torch.randn(shape, generator=_gen(seed, dev), device=dev).to(dtype)


FLASH_EDGES = [
    # causal, window, softcap, g, sq, sk, d, dtype
    (True, None, None, 2, 256, 256, 128, "bfloat16"),
    (False, None, None, 1, 100, 77, 64, "float32"),
    (True, 4096, None, 2, 300, 300, 128, "bfloat16"),
    (True, 16, None, 8, 130, 200, 64, "float32"),
    (False, 16, None, 1, 200, 100, 64, "bfloat16"),   # rows with no live key
    (True, None, 50.0, 2, 129, 129, 256, "bfloat16"),
    (True, 16, 50.0, 1, 65, 65, 256, "float32"),
    # the bf16 tensor-core tiling: 128 query rows, 128 keys (64 at D = 256)
    (True, None, None, 2, 1000, 1000, 128, "bfloat16"),   # no tile multiple
    (True, None, None, 2, 100, 300, 128, "bfloat16"),     # Sq < Sk
    (True, 100, None, 2, 700, 700, 128, "bfloat16"),      # window across tiles
    (True, None, None, 1, 640, 640, 64, "bfloat16"),
    (True, None, None, 2, 600, 600, 256, "bfloat16"),
    # head_dim 80 (hubert-xlarge): the 128-wide tiling, zero-padded
    (False, None, None, 1, 256, 256, 80, "bfloat16"),
    (False, None, None, 1, 256, 256, 80, "float32"),
    (True, 100, 50.0, 2, 700, 700, 80, "bfloat16"),
    (True, 100, 50.0, 2, 300, 300, 80, "float32"),
    (False, None, None, 2, 100, 77, 80, "bfloat16"),     # ragged Sq, Sk
    (True, None, None, 1, 100, 300, 80, "float32"),      # Sq < Sk
]
# hubert-xlarge's attention (configs/hubert_xlarge.py): 16 heads of 80,
# not causal; 2048 frames of one utterance
HUBERT_FLASH = dict(bh=16, s=2048, d=80)
DECODE_EDGES = [
    # heads, g, smax, d, window, softcap; each in bf16 and float32. Six
    # heads with kv_len 1, 2, ragged, Smax - 1, Smax and 0 (no live slot):
    # the short heads use one split, the long ones many
    (6, 2, 2080, 128, None, None),
    (6, 1, 1000, 64, None, None),
    (6, 8, 333, 256, None, 50.0),
    (6, 4, 2080, 128, 16, None),
    (6, 2, 65, 128, 4096, 30.0),
    (6, 2, 20, 128, None, None),     # one split per head (Smax < a tile)
    (6, 4, 700, 64, 100, 20.0),
    (400, 2, 300, 128, None, None),  # more heads than resident CTAs
    (6, 2, 100, 16, None, None),     # bf16 off the tensor-core kernel
    (6, 4, 257, 32, 50, None),
]
AGG_EDGES = [
    # P, N, S, C, kind: uniform ids (some outside [0, S)); station-major
    # runs with N no multiple of 16 (the flag vectors) and runs across
    # tiles; one hot segment; Q12-like 0.4 % valid; S = 1; N below a warp;
    # no row valid; runs at a large S (the global accumulator); C = 5 (the
    # runtime column count)
    (4, 5000, 37, 2, "random"), (4, 3001, 4500, 3, "random"),
    (2, 700, 9000, 4, "random"), (3, 999, 16, 0, "random"),
    (4, 300000, 2000, 1, "random"),
    (4, 100003, 2000, 3, "runs"), (2, 50000, 64, 2, "hot"),
    (4, 200000, 2000, 3, "sparse"), (2, 9000, 1, 1, "runs"),
    (3, 33, 5, 4, "runs"), (3, 5000, 37, 2, "none"),
    (2, 300000, 9000, 4, "runs"), (2, 3000, 50, 5, "random")]
# P, N, S, valid share (``random`` ids) or a ``seg_layout`` kind
SUM_COUNT_EDGES = [(4, 5000, 37, 0.8), (2, 3001, 9000, 0.8),
                   (3, 999, 4096, 0.0), (4, 300000, 2000, 0.8),
                   (4, 100003, 2000, "runs"), (2, 50000, 64, "hot"),
                   (4, 200000, 2000, "sparse"), (2, 9000, 1, "runs"),
                   (3, 33, 5, "runs"), (3, 5000, 37, "none")]


def check_flash(q, k, v, kw) -> float:
    import torch
    from repro_torch.kernels import flash_attention, ref
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    err = attn_err(got, want, str(q.dtype).split(".")[1], "flash_attention")
    again = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    require(torch.equal(again, got),
            "flash_attention differs from run to run")
    return err


def check_decode(q, k, v, kv_len, kw) -> float:
    import torch
    from repro_torch.kernels import decode_attention, ref
    got = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    want = ref.decode_attention(q, k, v, kv_len, **kw)
    err = attn_err(got, want, str(q.dtype).split(".")[1], "decode_attention")
    # a second call right after: an arrival counter of the fused combine
    # left non-zero would combine early and differ
    again = decode_attention.decode_attention_bhgd(q, k, v, kv_len, **kw)
    require(torch.equal(again, got),
            "decode_attention differs from run to run")
    return err


def check_sum_count(vals, segs, valid, s) -> float:
    """Counts exact, sums within SUM_RTOL of the summed magnitudes, the
    same bits from launch to launch; returns the largest sum error."""
    import torch
    from repro_torch.kernels import ref, seg_aggregate
    sums, counts = seg_aggregate.segmented_sum_count(vals, segs, valid, s)
    wsums, wcounts = ref.segmented_sum_count(vals, segs, valid, s)
    mag, _ = ref.segmented_sum_count(vals.abs(), segs, valid, s)
    torch.cuda.synchronize()
    require(torch.equal(counts, wcounts), "segmented_sum_count counts")
    err = (sums - wsums).abs()
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= SUM_RTOL * mag + 1e-30).all()),
            f"segmented_sum_count sums off by up to {worst}")
    again, _ = seg_aggregate.segmented_sum_count(vals, segs, valid, s)
    require(torch.equal(again, sums),
            "segmented_sum_count sums differ from run to run")
    return worst


def attention_edge_checks(dev, errs: dict) -> None:
    import torch
    for i, (causal, window, cap, g, sq, sk, d, dt) in enumerate(FLASH_EDGES):
        dtype = getattr(torch, dt)
        q = normal((2 * g, sq, d), SEED + 30 + i, dev, dtype)
        k = normal((2, sk, d), SEED + 40 + i, dev, dtype)
        v = normal((2, sk, d), SEED + 50 + i, dev, dtype)
        e = check_flash(q, k, v, dict(g=g, causal=causal, window=window,
                                      softcap=cap))
        errs["flash_attention"] = max(errs["flash_attention"], e)
    for i, (bh, g, smax, d, window, cap) in enumerate(DECODE_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            q = normal((bh, g, d), SEED + 60 + i, dev, dtype)
            k = normal((bh, smax, d), SEED + 70 + i, dev, dtype)
            v = normal((bh, smax, d), SEED + 80 + i, dev, dtype)
            kv_len = torch.tensor([1, 2, smax // 2 + 3, smax - 1, smax, 0],
                                  dtype=torch.int32, device=dev)
            kv_len = kv_len.repeat(-(-bh // 6))[:bh].contiguous()
            e = check_decode(q, k, v, kv_len, dict(window=window,
                                                   softcap=cap))
            errs["decode_attention"] = max(errs["decode_attention"], e)
    for i, (p, n, s, share) in enumerate(SUM_COUNT_EDGES):
        g = _gen(SEED + 90 + i, dev)
        vals = torch.randint(-400, 400, (p, n), generator=g,
                             device=dev).float() / 10
        if isinstance(share, str):
            segs, valid = seg_layout(g, p, n, s, share, dev)
        else:
            segs = torch.randint(-3, s + 3, (p, n), generator=g, device=dev,
                                 dtype=torch.int32)
            valid = torch.rand((p, n), generator=g, device=dev) < share
        e = check_sum_count(vals, segs, valid, s)
        errs["segmented_sum_count"] = max(errs["segmented_sum_count"], e)


def edge_checks(dev) -> dict[str, float]:
    import torch
    errs = {"block_join_probe": 0.0, "segmented_aggregate": 0.0,
            "segment_topk": 0.0, "segmented_sum_count": 0.0,
            "flash_attention": 0.0, "decode_attention": 0.0}
    for i, (kind, p, nb, np_, nk) in enumerate(JOIN_EDGES):
        e = check_join(join_edge_inputs(kind, p, nb, np_, nk, SEED + i, dev))
        errs["block_join_probe"] = max(errs["block_join_probe"], e)
    for i, (p, n, s, nc, kind) in enumerate(AGG_EDGES):
        e = check_agg(agg_inputs(p, n, s, nc, SEED + 10 + i, dev, kind))
        errs["segmented_aggregate"] = max(errs["segmented_aggregate"], e)
    # the last three span several sorted chunks (the merge runs)
    for i, (p, n, cap, fk, none_valid) in enumerate([
            (4, 2000, 16, True, False), (2, 1500, 1500, True, False),
            (3, 33, 5, False, False), (1, 1, 1, True, False),
            (2, 50000, 64, True, False), (2, 12000, 12000, True, False),
            (3, 20000, 100, True, True)]):
        keys = topk_inputs(p, n, SEED + 20 + i, dev, fk)
        if none_valid:
            keys = (torch.ones_like(keys[0]),) + keys[1:]
        e = check_topk(keys, cap)
        errs["segment_topk"] = max(errs["segment_topk"], e)
    attention_edge_checks(dev, errs)
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
        self.join_builds: list[tuple] = []   # (P, NB) of each join call
        self.agg_calls: list[tuple] = []     # every aggregate call's args

    def _wrap(self, attr, kernel, work):
        fn = getattr(self.ops, attr)
        self.saved[attr] = fn

        def wrapped(*args, **kw):
            w = work(*args)
            if kernel not in self.best or w > self.best[kernel][0]:
                self.best[kernel] = (w, args)
            if kernel == "block_join_probe":
                self.join_builds.append(tuple(args[1].shape))
            if kernel == "segmented_aggregate":
                self.agg_calls.append(args)
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
    from repro_torch.kernels.hash_join import table_slots
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
        if capture is not None:
            capture.join_builds.clear()
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
               # the join kernel's hash-table scratch, the largest call's
               "join_table_mib": max(
                   [p * table_slots(nb) * 4 / 2**20 for p, nb in
                    (capture.join_builds if capture is not None else [])],
                   default=0.0),
               "caps": {k: getattr(cfg, k) for k in
                        ("scan_cap", "join_cap", "group_cap", "topk_cap")}}
        log("query " + json.dumps(rec))
        records.append(rec)
    return records


# ---------------------------------------------------------------------------
# phase 6: the service path
# ---------------------------------------------------------------------------

# caps of 1 (2 groups) regrow by x4 a rung: the scan cap needs nine rungs
# to pass a million rows per partition, and a join or group cap may start
# growing only once the scan feeds it, so the default of 8 retries (sized
# for presized first caps) is too few from here
TINY_CAPS = dict(scan_cap=1, join_bucket=1, join_cap=1, group_cap=2)
TINY_RETRIES = 24


def host_bytes(raw: dict) -> int:
    """Bytes of a raw-output dict copied to the host."""
    return sum(a.nbytes for v in raw.values()
               for a in (v if isinstance(v, tuple) else (v,)))


def raw_identical(a: dict, b: dict) -> bool:
    """Two raw-output dicts of one plan at one config, bit for bit (the
    arrays are compared whole: decoding 4M slots into rows on the host
    would take seconds a result)."""
    import numpy as np

    def parts(v):
        return v if isinstance(v, tuple) else (v,)

    return set(a) == set(b) and all(
        len(parts(a[k])) == len(parts(b[k])) and all(
            x.shape == y.shape and np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f")
            for x, y in zip(parts(a[k]), parts(b[k])))
        for k in a)


def rows_agree(name: str, got: list, want: list, what: str) -> None:
    """Row for row: strings and ints exact, floats within SUM_RTOL."""
    import numpy as np
    require(len(got) == len(want),
            f"{name}: {len(got)} rows vs {len(want)} ({what})")
    for g, w in zip(got, want):
        ok = len(g) == len(w) and all(
            np.isclose(x, y, rtol=SUM_RTOL, atol=0)
            if isinstance(x, float) and isinstance(y, float) else x == y
            for x, y in zip(g, w))
        require(ok, f"{name}: {g} vs {w} ({what})")


def profile_rows(prof) -> list:
    return [(o.index, o.label, o.rows, o.rows_peak) for o in prof.ops]


def service_path(db, spec, dev, exec_ms: dict | None = None,
                 total: int = 64, counters: dict | None = None) -> dict:
    """Phase 6: the serving tier on ``db``. One service holds the tables
    at a time: the plain-route service runs first and is freed, then
    the kernel-route service, the workload service and the regrowth
    service in turn. ``exec_ms``: phase 3's warm ms per query, printed
    beside the service's; ``counters``: the query kernels' wrappers,
    whose launches during each query's cold and warm runs go into its
    ``service`` line."""
    import torch
    from repro_torch.core import ExecConfig, QueryService, compile_query
    from repro_torch.core.queries import ALL
    from repro_torch.core.workload import (DEFAULT_TENANTS,
                                           make_tenant_traffic, make_workload)
    want = reference_results(spec)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def free():
        if on_cuda:
            torch.cuda.empty_cache()

    # the plain routes: raw dicts and Q8's operator rows
    plain_cfg = ExecConfig(use_kernel_join=False, use_kernel_segments=False)
    svc = QueryService(db, plain_cfg, device=dev)
    plain = {name: svc.execute(text).raw for name, text in ALL.items()}
    plain_prof = profile_rows(svc.explain(ALL["Q8"], profile=True))
    del svc
    free()

    # the kernel routes: Q1-Q12 cold and warm
    svc = QueryService(db, device=dev)
    records, results = [], {}
    for name, text in ALL.items():
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        before = svc.stats.snapshot()
        launched = {k: w.launches for k, w in (counters or {}).items()}
        sync()
        t0 = time.perf_counter()
        svc.execute(text)
        cold_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rs = svc.execute(text)
        warm_ms = (time.perf_counter() - t0) * 1e3
        d = svc.stats.diff(before)
        pq = svc.prepare(text)
        require(not rs.overflow, f"{name}: the service returned an overflow")
        raw_agree(name, pq.plan, rs.raw, plain[name])
        rows = rs.rows()
        check_reference(name, rows, want[name])
        results[name] = rows
        cfg = svc._good_cfg[pq.signature]
        rec = {"query": name, "rows": len(rows), "cold_ms": cold_ms,
               "warm_ms": warm_ms, "retries": d.retries,
               "compiles": d.compiles,
               "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                            if on_cuda else 0.0),
               "host_bytes": host_bytes(rs.raw),
               "caps": {k: getattr(cfg, k) for k in
                        ("scan_cap", "join_cap", "group_cap", "topk_cap")},
               "launches": {k: w.launches - launched[k]
                            for k, w in (counters or {}).items()}}
        if exec_ms is not None:
            rec["executor_warm_ms"] = exec_ms[name]
        log("service " + json.dumps(rec))
        records.append(rec)
    if exec_ms is not None:
        q6 = next(r for r in records if r["query"] == "Q6")
        log(f"service Q6 warm {q6['warm_ms']:.3f} ms through the service, "
            f"{exec_ms['Q6']:.3f} ms through the bare executor (phase 3); "
            f"{q6['host_bytes']} bytes to the host")
    kernel_prof = profile_rows(svc.explain(ALL["Q8"], profile=True))
    require(kernel_prof == plain_prof and any(r[2] for r in kernel_prof),
            f"Q8 operator rows differ between routes: {kernel_prof} vs "
            f"{plain_prof}")
    log(f"service explain Q8 profile: {len(kernel_prof)} operators, the "
        "same rows on both routes")

    # the admission runtime: multi-tenant traffic, each ticket equal to
    # a direct execute
    stations = [spec.station_id(i) for i in range(spec.num_stations)]
    years = sorted({y for y, _, _ in spec.dates()})
    traffic = make_tenant_traffic(DEFAULT_TENANTS, stations, years,
                                  total=total, seed=SEED)
    before = svc.stats.snapshot()
    t0 = time.perf_counter()
    for at, tenant, template, text in traffic:
        svc.submit(text, tenant=tenant, at=at, template=template)
    tickets = svc.drain()
    drain_s = time.perf_counter() - t0
    d = svc.stats.diff(before)
    require(len(tickets) == len(traffic), "the runtime lost tickets")
    for t, (_, _, template, text) in zip(tickets, traffic):
        require(t.error is None, f"runtime {template}: {t.error!r}")
        require(raw_identical(t.result.raw, svc.execute(text).raw),
                f"runtime {template}: the ticket differs from execute")
    log("service runtime " + json.dumps(
        {"requests": len(traffic), "drain_s": drain_s,
         "batches": d.batches, "batched_requests": d.batched_requests,
         "compiles": d.compiles, "tenants": sorted({t.tenant
                                                    for t in tickets})}))
    del svc, tickets
    free()

    # prepared constant-variants: one compile per template, each equal to
    # the executor's run of its baked plan; then the same requests batched
    wl = make_workload(stations, years, total=total)
    texts = [text for _, text in wl]
    templates = {t for t, _ in wl}
    svc = QueryService(db, device=dev)
    t0 = time.perf_counter()
    singles = [svc.execute(text) for text in texts]
    exec_s = time.perf_counter() - t0
    compiles = svc.stats.compiles
    require(compiles == len(templates),
            f"{compiles} compiles for {len(templates)} templates")
    for (template, text), rs in zip(wl, singles):
        pq = svc.prepare(text)
        require(not rs.overflow, f"{template}: overflow")
        raw_agree(template, pq.plan, rs.raw, svc.executor.run(
            compile_query(text), config=svc._good_cfg[pq.signature]).raw)
    before = svc.stats.snapshot()
    t0 = time.perf_counter()
    batched = svc.execute_batch(texts)
    batch_s = time.perf_counter() - t0
    d = svc.stats.diff(before)
    require(d.batches == len(templates),
            f"{d.batches} batches for {len(templates)} templates")
    for (template, _), a, b in zip(wl, singles, batched):
        require(raw_identical(a.raw, b.raw),
                f"{template}: execute_batch differs from execute")
    workload = {"requests": len(wl), "templates": len(templates),
                "compiles": compiles, "execute_s": exec_s,
                "batch_s": batch_s, "batches": d.batches,
                "batch_compiles": d.compiles}
    log("service workload " + json.dumps(workload))
    del svc, singles, batched
    free()

    # regrowth from caps of 1
    svc = QueryService(db, ExecConfig(**TINY_CAPS), presize=False,
                       max_retries=TINY_RETRIES, device=dev)
    regrowth = {}
    for name in ("Q8", "Q10", "Q11"):
        before = svc.stats.snapshot()
        rs = svc.execute(ALL[name])
        require(not rs.overflow, f"{name}: overflow after regrowth")
        rows_agree(name, rs.rows(), results[name], "regrown vs presized")
        cfg = svc._good_cfg[svc.prepare(ALL[name]).signature]
        regrowth[name] = {"retries": svc.stats.diff(before).retries,
                          "caps": {k: getattr(cfg, k) for k in (
                              "scan_cap", "join_cap", "group_cap",
                              "topk_cap", "join_bucket")}}
    log("service regrowth " + json.dumps(regrowth))
    del svc
    free()
    return {"queries": records, "workload": workload, "regrowth": regrowth}


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


def kernel_record(name: str, launches: dict, err: float, run, plain, lib,
                  nbytes: float, flops: float, dtype: str, shape: dict,
                  where: str = "main-path shape") -> dict:
    """Time one kernel beside its plain version and library call; the
    bound is the larger of bytes over the memory rate and operations
    over the peak rate of the input type."""
    from repro_torch.kernels.registry import KERNELS
    entry = KERNELS[name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {"name": name, "route": "cuda", "source": entry["source"],
           "replaces": entry["replaces"], "launches": launches[name],
           "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": cuda_ms(lib) if lib is not None else None}
    log(f"kernel {name} at {where} {json.dumps(shape)}: " + json.dumps(rec))
    return rec


def sum_count_library(vals, segs, valid, s):
    """One index_add_ of [value, 1] rows into the flat [P * S + 1]
    slots (the last collects dropped rows)."""
    import torch
    p, n = vals.shape
    keep = valid & (segs >= 0) & (segs < s)
    slot = torch.where(keep, torch.arange(p, device=vals.device)[:, None] * s
                       + segs, torch.full_like(segs, p * s)).long().reshape(-1)
    src = torch.stack([torch.where(keep, vals, 0.0), keep.float()],
                      2).reshape(p * n, 2)

    def fn():
        return torch.zeros(p * s + 1, 2, device=vals.device).index_add_(
            0, slot, src)

    return fn


def agg_record(args, launches: dict, edge_errs: dict) -> dict:
    """``segmented_aggregate`` on one main-path input. The bound counts
    the bytes the work needs: every valid flag, the valid rows' segment
    ids, values and ok flags, and the outputs; the shape record keeps
    the earlier bound (every input read once) as ``bound_all_inputs_ms``
    and the share of valid rows."""
    from repro_torch.kernels import ref, seg_aggregate
    vals, ok, segs, valid, s = args
    err = check_agg(args)
    p, n, nc = vals.shape
    nvalid = int(valid.sum())
    out_bytes = p * s * 4 * (1 + 3 * nc)
    nbytes = valid.numel() + nvalid * (4 + 5 * nc) + out_bytes
    every = vals.numel() * 4 + ok.numel() + segs.numel() * 4 \
        + valid.numel() + out_bytes
    shape = {"P": p, "N": n, "S": s, "C": nc,
             "valid_share": nvalid / max(valid.numel(), 1),
             "bound_all_inputs_ms": every / HBM_BYTES_PER_S * 1e3}
    return kernel_record(
        "segmented_aggregate", launches,
        max(err, edge_errs["segmented_aggregate"]),
        lambda: seg_aggregate.segmented_aggregate(*args),
        lambda: ref.segmented_aggregate(*args), agg_library(*args), nbytes,
        0.0, "float32", shape)


def main_shape_timings(best: dict, agg_calls: list, launches: dict,
                       edge_errs: dict) -> list:
    """Phase 4: each executor kernel on the largest input the query path
    gave it (``segmented_sum_count``: the first value column of the
    largest aggregate input, rows not ``ok`` invalid): parity with the
    plain version, device times, and the bound. ``segmented_aggregate``
    also on the input with the most valid rows (logged; the returned
    record is the largest input's)."""
    from repro_torch.kernels import hash_join, ref, seg_aggregate, seg_topk
    require(agg_calls, "the query path never reached segmented_aggregate")
    dense = max(agg_calls, key=lambda a: (int(a[3].sum()), a[0].shape[2]))
    out = []
    for name in ("block_join_probe", "segmented_aggregate", "segment_topk",
                 "segmented_sum_count"):
        src = "segmented_aggregate" if name == "segmented_sum_count" else name
        require(src in best, f"the query path never reached {src}")
        args = best[src][1]
        lib = None
        if name == "segmented_aggregate":
            log("kernel segmented_aggregate at the densest main-path input:")
            agg_record(dense, launches, edge_errs)
            log("kernel segmented_aggregate at the largest main-path input:")
            out.append(agg_record(args, launches, edge_errs))
            continue
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
        elif name == "segment_topk":
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
        else:
            vals3, ok, segs, valid, s = args
            sc = (vals3[:, :, 0].contiguous(), segs,
                  (valid & ok[:, :, 0]).contiguous(), s)
            err = check_sum_count(*sc)

            def run():
                return seg_aggregate.segmented_sum_count(*sc)

            def plain():
                return ref.segmented_sum_count(*sc)

            lib = sum_count_library(*sc)
            p, n = sc[0].shape
            nvalid = int(sc[2].sum())
            # the flags, the valid rows' ids and values, the outputs
            nbytes = p * n + nvalid * 8 + p * s * 8
            shape = {"P": p, "N": n, "S": s,
                     "valid_share": nvalid / max(p * n, 1),
                     "bound_all_inputs_ms":
                         (p * n * 9 + p * s * 8) / HBM_BYTES_PER_S * 1e3}
        out.append(kernel_record(name, launches, max(err, edge_errs[name]),
                                 run, plain, lib, nbytes, 0.0, "float32",
                                 shape))
    return out


# ---------------------------------------------------------------------------
# phase 5: the LM serving path
# ---------------------------------------------------------------------------

class LastCall:
    """Wraps the attention entry points of ``kernels.ops`` and keeps the
    arguments of each one's last call: the inputs of the last layer of
    the prefill and of the last (longest) decode step."""

    NAMES = ("flash_attention", "decode_attention")

    def __init__(self, ops):
        self.ops = ops
        self.saved = {}
        self.calls: dict[str, tuple] = {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.ops, name)
            self.saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.calls[_name] = (args, kw)
                return _fn(*args, **kw)

            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.ops, attr, fn)


def lm_path(dev, *, smoke: bool = False, requests: int = LM_REQUESTS,
            prompt_len: int = LM_PROMPT, gen_len: int = LM_GEN,
            counters: dict | None = None, capture=None) -> dict:
    """Phase 5: ``serve_batch`` of LM_ARCH twice on the kernel route
    (cold, warm) and once on the plain route, teacher-forced with the
    kernel route's tokens; prefill and per-step logits must agree within
    LOGIT_ATOL. ``counters``: the attention kernel wrappers, set to 0
    before each kernel-route serve and read after it (each must launch
    once per layer, and once per layer per generated token);
    ``capture``: a context that sees the cold serve's kernel calls."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model
    cfg = get_smoke_config(LM_ARCH) if smoke else get_config(LM_ARCH)
    on_cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    params = model.init_params(cfg, SEED, dev)
    if on_cuda:
        torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for t in model._leaves(params))
    log(f"lm {LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, "
        f"vocab {cfg.vocab_size}: {n_params} params initialised on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(smoke=smoke, num_requests=requests, prompt_len=prompt_len,
              gen_len=gen_len, seed=SEED, device=dev, params=params)
    runs = {}
    for label in ("cold", "warm"):
        for w in (counters or {}).values():
            w.launches = 0
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        with capture if capture is not None and label == "cold" \
                else contextlib.nullcontext():
            out = serve_batch(LM_ARCH, **kw)
        rec = {"route": "kernel", "run": label,
               "prefill_ms": out["prefill_s"] * 1e3,
               "decode_ms_per_token": out["decode_s"] * 1e3 / gen_len,
               "tok_per_s": out["tok_per_s"],
               "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                            if on_cuda else 0.0)}
        if counters:
            rec["launches"] = {k: w.launches for k, w in counters.items()}
            want = {"flash_attention": cfg.num_layers,
                    "decode_attention": cfg.num_layers * gen_len}
            require(rec["launches"] == want, f"lm {label} serve launched "
                    f"{rec['launches']}, want {want}")
        log("lm serve " + json.dumps(rec))
        runs[label] = (rec, out)
    kernel = runs["warm"][1]
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    plain = serve_batch(LM_ARCH, **kw, overrides={"attn_impl": "dense"},
                        force_tokens=kernel["generated"])
    prec = {"route": "plain", "run": "teacher-forced",
            "prefill_ms": plain["prefill_s"] * 1e3,
            "decode_ms_per_token": plain["decode_s"] * 1e3 / gen_len,
            "tok_per_s": plain["tok_per_s"],
            "peak_mib": (torch.cuda.max_memory_allocated(dev) / 2**20
                         if on_cuda else 0.0)}
    log("lm serve " + json.dumps(prec))
    errs = {}
    for key, shape in (("prefill_logits", (requests, 1, cfg.vocab_size)),
                       ("step_logits", (requests, gen_len, cfg.vocab_size))):
        a, b = kernel[key], plain[key]
        require(tuple(a.shape) == shape and tuple(b.shape) == shape,
                f"lm {key}: shapes {tuple(a.shape)}, {tuple(b.shape)}, "
                f"want {shape}")
        require(bool(torch.isfinite(a).all() & torch.isfinite(b).all()),
                f"lm {key}: non-finite logits")
        errs[key] = float((a - b).abs().max())
    require(max(errs.values()) <= LOGIT_ATOL,
            f"lm kernel and plain routes disagree: {errs} > {LOGIT_ATOL}")
    same = float((torch.from_numpy(plain["generated"])
                  == torch.from_numpy(kernel["generated"])).float().mean())
    cold_same = bool((runs["cold"][1]["generated"]
                      == kernel["generated"]).all())
    summary = {"logit_max_abs_err": errs, "logit_atol": LOGIT_ATOL,
               "plain_argmax_agrees": same, "cold_warm_tokens_equal":
               cold_same, "generated_shape": list(kernel["generated"].shape),
               "warm": runs["warm"][0], "cold": runs["cold"][0],
               "plain": prec}
    log("lm check " + json.dumps({k: summary[k] for k in (
        "logit_max_abs_err", "logit_atol", "plain_argmax_agrees",
        "cold_warm_tokens_equal", "generated_shape")}))
    return summary


def live_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs a causal/windowed mask keeps."""
    import torch
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return int(ok.sum())


def lm_kernel_timings(calls: dict, launches: dict, edge_errs: dict) -> list:
    """The attention kernels on the inputs the serve gave them (the last
    prefill layer's q/k/v; the last decode step's q and caches)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_attention, ref
    out = []
    require("flash_attention" in calls and "decode_attention" in calls,
            f"the LM path never reached the attention kernels: {set(calls)}")
    (q, k, v), kw = calls["flash_attention"]
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    fkw = dict(g=g, causal=kw.get("causal", True), window=kw.get("window"),
               softcap=kw.get("logit_softcap"), scale=kw.get("scale"))
    qv, kv, vv = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    qb = qv.reshape(b * hq, sq, d)
    kb, vb = kv.reshape(b * hkv, sk, d), vv.reshape(b * hkv, sk, d)
    dt = str(q.dtype).split(".")[1]
    got = flash_attention.flash_attention_bhsd(qv, kv, vv, **fkw)
    err = attn_err(got.reshape(b * hq, sq, d), ref.flash_attention(
        qb, kb, vb, **fkw), dt, "flash_attention (serve shape)")
    lib = None
    if fkw["window"] is None and fkw["softcap"] is None:
        def lib():
            return F.scaled_dot_product_attention(
                qv, kv, vv, is_causal=fkw["causal"], enable_gqa=True,
                scale=fkw["scale"])
    flops = 4.0 * d * b * hq * live_pairs(sq, sk, fkw["causal"],
                                          fkw["window"])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    out.append(kernel_record(
        "flash_attention", launches, max(err, edge_errs["flash_attention"]),
        lambda: flash_attention.flash_attention_bhsd(qv, kv, vv, **fkw),
        lambda: ref.flash_attention(qb, kb, vb, **fkw), lib, nbytes, flops,
        dt, {"B*Hq": b * hq, "Sq": sq, "Sk": sk, "D": d, "g": g,
             "causal": fkw["causal"], "dtype": dt}))

    (q, kc, vc, kv_len), kw = calls["decode_attention"]
    b, _, hq, d = q.shape
    _, smax, hkv, _ = kc.shape
    g = hq // hkv
    dkw = dict(window=kw.get("window"), softcap=kw.get("logit_softcap"),
               scale=kw.get("scale"))
    q4 = q.reshape(b, hkv, g, d)
    k4, v4 = kc.transpose(1, 2), vc.transpose(1, 2)
    kl = kv_len[:, None].expand(b, hkv)
    qb = q.reshape(b * hkv, g, d)
    kb, vb = k4.reshape(b * hkv, smax, d), v4.reshape(b * hkv, smax, d)
    klb = torch.repeat_interleave(kv_len, hkv)
    got = decode_attention.decode_attention_bhgd(q4, k4, v4, kl, **dkw)
    err = attn_err(got.reshape(b * hkv, g, d),
                   ref.decode_attention(qb, kb, vb, klb, **dkw), dt,
                   "decode_attention (serve shape)")
    lib = None
    if dkw["window"] is None and dkw["softcap"] is None:
        live = (torch.arange(smax, device=q.device)[None, :]
                < kv_len[:, None])[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k4, v4, attn_mask=live, enable_gqa=True,
                scale=dkw["scale"])
    lo = (kv_len - dkw["window"]).clamp(min=0) if dkw["window"] \
        else torch.zeros_like(kv_len)
    slots = int((kv_len.clamp(max=smax) - lo).clamp(min=0).sum()) * hkv
    nbytes = (2 * slots * d + 2 * q.numel()) * q.element_size()
    flops = 4.0 * g * d * slots
    out.append(kernel_record(
        "decode_attention", launches,
        max(err, edge_errs["decode_attention"]),
        lambda: decode_attention.decode_attention_bhgd(q4, k4, v4, kl, **dkw),
        lambda: ref.decode_attention(qb, kb, vb, klb, **dkw), lib, nbytes,
        flops, dt, {"B*Hkv": b * hkv, "G": g, "Smax": smax, "D": d,
                    "kv_len": [int(x) for x in kv_len], "dtype": dt}))
    return out


def hubert_flash_record(dev) -> dict:
    """The flash kernel at hubert-xlarge's attention shape, seeded
    inputs, beside its plain version and scaled_dot_product_attention.
    No path of the port runs this model yet (its front end waits), so
    the record's launches are 0."""
    import torch.nn.functional as F
    import torch
    from repro_torch.kernels import flash_attention, ref
    bh, s, d = (HUBERT_FLASH[k] for k in ("bh", "s", "d"))
    q, k, v = (normal((bh, s, d), SEED + 120 + i, dev, torch.bfloat16)
               for i in range(3))
    kw = dict(g=1, causal=False)
    err = attn_err(flash_attention.flash_attention_bhsd(q, k, v, **kw),
                   ref.flash_attention(q, k, v, **kw), "bfloat16",
                   "flash_attention (hubert-xlarge shape)")
    q4, k4, v4 = (x[None] for x in (q, k, v))
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4.0 * d * bh * s * s
    return kernel_record(
        "flash_attention", {"flash_attention": 0}, err,
        lambda: flash_attention.flash_attention_bhsd(q, k, v, **kw),
        lambda: ref.flash_attention(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(q4, k4, v4), nbytes, flops,
        "bfloat16", {"B*Hq": bh, "Sq": s, "Sk": s, "D": d, "g": 1,
                     "causal": False, "dtype": "bfloat16"},
        where="hubert-xlarge's shape")


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
    from repro_torch.core.queries import GROUPED
    from repro_torch.data.weather import WeatherSpec, build_database
    from repro_torch.kernels import _build, decode_attention, flash_attention
    from repro_torch.kernels import hash_join, ops, seg_aggregate, seg_topk
    from repro_torch.kernels.registry import KERNELS
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
                "segment_topk": seg_topk.segment_topk,
                "segmented_sum_count": seg_aggregate.segmented_sum_count,
                "flash_attention": flash_attention.flash_attention_bhsd,
                "decode_attention": decode_attention.decode_attention_bhgd}
    query_kernels = ("block_join_probe", "segmented_aggregate",
                     "segment_topk")
    lm_kernels = ("flash_attention", "decode_attention")
    for w in wrappers.values():
        w.launches = 0
    capture = Capture(ops)
    query_records = main_path(ex, spec, capture)
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"query path launches {json.dumps(launches)}")
    require(all(launches[k] > 0 for k in query_kernels),
            f"a kernel of the query path never launched: {launches}")
    # one launch per group-by query run: cold and warm on the kernel route
    require(launches["segmented_aggregate"] == 2 * len(GROUPED),
            f"segmented_aggregate launched {launches['segmented_aggregate']}"
            f" times, not once per run of {GROUPED}")
    require(all(launches[k] == 0 for k in lm_kernels),
            f"the query path launched an attention kernel: {launches}")
    records = {r["name"]: r for r in
               main_shape_timings(capture.best, capture.agg_calls,
                                  launches, edge_errs)}
    hubert_flash_record(dev)
    del ex, capture
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    service_path(db, spec, dev, {r["query"]: r["warm_ms"]
                                 for r in query_records},
                 counters={k: wrappers[k] for k in query_kernels})
    service_launches = {k: w.launches for k, w in wrappers.items()}
    log(f"service path launches {json.dumps(service_launches)} "
        f"({time.perf_counter() - t0:.1f} s)")
    require(all(service_launches[k] > 0 for k in query_kernels),
            f"a query kernel never launched on the service path: "
            f"{service_launches}")
    require(all(service_launches[k] == 0 for k in lm_kernels),
            f"the service path launched an attention kernel: "
            f"{service_launches}")
    del db
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    last = LastCall(ops)
    lm = lm_path(dev, counters={k: wrappers[k] for k in lm_kernels},
                 capture=last)
    launches.update(lm["warm"]["launches"])
    log(f"lm path ok ({time.perf_counter() - t0:.1f} s)")
    for r in lm_kernel_timings(last.calls, launches, edge_errs):
        records[r["name"]] = r
    kernels = [records[name] for name in KERNELS]
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
