"""Cost-based batch-bucket selection (replacing blind pow2 padding).

A batched executable is compiled per (signature, bucket) pair, so the
bucket ladder trades two real costs against each other:

  padding waste   every dispatch of a group of size s through bucket
                  b >= s executes (b - s) phantom requests; each
                  phantom re-runs the whole plan, so waste is measured
                  in *padded rows* — (b - s) x the plan's per-request
                  row cost (its statistics-presized scan capacity,
                  i.e. ``CollectionStats`` through the service's
                  presizer)
  compile count   every distinct bucket is one more trace + XLA
                  compile and one more plan-cache entry

Pow2 fixes the ladder blindly: group sizes land in [b/2, b], so up to
half of every dispatch can be phantom work. The cost-based policy
instead fits the ladder to the *observed* group-size mix of each
signature (the same per-template skew ``binding_stats()`` exposes):
an optimal-partition DP over the size histogram picks at most
``max_buckets`` bucket sizes minimizing

    row_cost x sum_s count(s) * (bucket(s) - s)  +  compile_cost x #buckets

which is exactly "padding waste x compile count" made commensurable
(``compile_cost`` is denominated in padded rows per extra compile).
Sizes never observed before fall back to pow2 — exactness and
cold-start behavior are unchanged, only the steady-state ladder moves.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class Pow2Bucketing:
    """The baseline policy: smallest power of two >= group size. One
    ladder for every signature, no state — kept for ablation and as
    the cold-start fallback of the cost-based policy."""

    def observe(self, sig: str, size: int) -> None:
        pass

    def bucket_for(self, sig: str, size: int) -> int:
        return next_pow2(size)

    def buckets(self, sig: str) -> tuple[int, ...]:
        return ()


def fit_buckets(hist: dict[int, int], *, max_buckets: int,
                row_cost: int, compile_cost: float) -> tuple[int, ...]:
    """Optimal bucket ladder for one signature's size histogram.

    Partitions the sorted distinct sizes into at most ``max_buckets``
    contiguous runs; each run is served by its largest size. DP over
    (runs used, prefix) minimizes total padded rows plus the compile
    charge — O(k n^2) with n = distinct sizes (tiny: group sizes are
    bounded by the admission fill)."""
    assert max_buckets >= 1
    sizes = sorted(hist)
    if not sizes:
        return ()
    n = len(sizes)

    def seg_cost(i: int, j: int) -> float:
        # sizes[i..j] served by bucket sizes[j]
        b = sizes[j]
        return row_cost * sum(hist[sizes[t]] * (b - sizes[t])
                              for t in range(i, j + 1))

    inf = float("inf")
    # best[k][j]: cost of covering sizes[0..j] with exactly k buckets
    best = [[inf] * n for _ in range(max_buckets + 1)]
    back: dict[tuple[int, int], int] = {}
    for j in range(n):
        best[1][j] = seg_cost(0, j)
    for k in range(2, max_buckets + 1):
        for j in range(k - 1, n):
            for i in range(k - 2, j):
                c = best[k - 1][i] + seg_cost(i + 1, j)
                if c < best[k][j]:
                    best[k][j] = c
                    back[(k, j)] = i
    k_best = min(range(1, max_buckets + 1),
                 key=lambda k: best[k][n - 1] + compile_cost * k)
    # walk the partition back into bucket sizes (the max of each run)
    out: list[int] = []
    k, j = k_best, n - 1
    while k > 1:
        i = back[(k, j)]
        out.append(sizes[j])
        j, k = i, k - 1
    out.append(sizes[j])
    return tuple(sorted(out))


class CostBasedBucketing:
    """Per-signature bucket ladders fitted to the observed group-size
    mix.

    ``observe(sig, size)`` records one admitted group; the ladder is
    refit lazily on the next ``bucket_for`` after history changed
    (``frozen=True`` stops refitting — the benchmark's trace-fitted
    mode, where a ladder learned from recorded traffic serves a fresh
    run so compile counts are comparable). ``row_cost_for`` maps a
    signature to its per-request row cost (the service wires this to
    the statistics-presized scan capacity); without it all signatures
    weigh padding equally."""

    def __init__(self, *, max_buckets: int = 3,
                 compile_cost: float = 4096.0,
                 row_cost_for=None, frozen: bool = False,
                 max_buckets_for=None):
        assert max_buckets >= 1
        self.max_buckets = max_buckets
        self.compile_cost = compile_cost
        self.row_cost_for = row_cost_for
        self.frozen = frozen
        # optional per-signature bucket budget (sig -> int). The
        # benchmark sets it to the number of pow2 buckets the same
        # traffic used, making "equal or lower compile count" a
        # structural guarantee: a DP partition into k segments served
        # by segment MAXES never pads more than any k-bucket pow2
        # assignment of the same sizes.
        self.max_buckets_for = max_buckets_for
        self._hist: dict[str, Counter] = {}
        self._ladder: dict[str, tuple[int, ...]] = {}
        self._dirty: set[str] = set()
        self.fallbacks = 0      # sizes no fitted bucket covered

    def observe(self, sig: str, size: int) -> None:
        self._hist.setdefault(sig, Counter())[size] += 1
        if not self.frozen:
            self._dirty.add(sig)

    def preseed(self, sig: str, sizes: Sequence[int]) -> None:
        """Bulk-load a recorded size mix (e.g. replayed from an
        operator's ``binding_stats()`` skew log) before serving."""
        self._hist.setdefault(sig, Counter()).update(sizes)
        self._dirty.add(sig)

    def buckets(self, sig: str) -> tuple[int, ...]:
        if sig in self._dirty:
            row_cost = (self.row_cost_for(sig)
                        if self.row_cost_for else 1)
            mb = (max(1, int(self.max_buckets_for(sig)))
                  if self.max_buckets_for else self.max_buckets)
            self._ladder[sig] = fit_buckets(
                self._hist[sig], max_buckets=mb,
                row_cost=max(int(row_cost), 1),
                compile_cost=self.compile_cost)
            self._dirty.discard(sig)
            from repro_torch.core.obs import trace as obs_trace
            from repro_torch.core.obs.trace import sig_digest
            obs_trace.current().event(
                "bucket-refit", cat="serving", sig=sig_digest(sig),
                ladder=list(self._ladder[sig]))
        return self._ladder.get(sig, ())

    def bucket_for(self, sig: str, size: int) -> int:
        for b in self.buckets(sig):
            if b >= size:
                return b
        # cold start, or a size beyond everything observed: pow2 keeps
        # the variant count bounded while history accumulates
        self.fallbacks += 1
        return next_pow2(size)


def padded_rows(dispatches: Sequence[tuple[str, int, int, int]]) -> int:
    """Padding-waste metric over a ``ServingRuntime.dispatch_log`` —
    (signature, group_size, bucket, row_cost) tuples: total phantom
    rows executed."""
    return sum((b - s) * rc for _, s, b, rc in dispatches)


def make_policy(name: str, **kw) -> object:
    """Policy registry for benchmarks/CLI: 'pow2' | 'cost'."""
    if name == "pow2":
        return Pow2Bucketing()
    if name == "cost":
        return CostBasedBucketing(**kw)
    raise KeyError(name)
