// Fused segment aggregation over a leading partition dimension.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/seg_aggregate.py:
//   segmented_aggregate (:80, body _agg_kernel :44): per segment, the count
//     of valid rows and, per value column, the sum, min and max of the
//     values whose `ok` flag is set;
//   segmented_sum_count (:125, body _kernel :23): per segment, the sum of
//     one value column over the valid rows and their count.
// Rows that are not valid, or whose segment id lies outside [0, S), are
// dropped; `ok` masks values, not counts; empty slots read 0 / +inf / -inf;
// an ok NaN poisons min and max (min_nan / max_nan). segmented_sum_count is
// the C = 1 case without `ok` and without min/max: both entry points
// instantiate one templated pass 1 (seg_pass1_kernel<C, kFull>) and share
// one combine kernel.
//
// Bound on the H100: bytes. The work is every `valid` flag plus, for the
// valid rows only, their segment id, values and ok flags, plus the outputs.
// On the query path few rows are valid (Q12 keeps 0.4 % of the /sensors
// capacity tile, Q9-Q11 20 %) and valid rows come in runs of one segment
// (records are station-major). The design follows from that:
//
// 1. Skip invalid rows for the price of their flag. A CTA walks its chunk
//    of rows in steps of 16384: each thread reads the flags of its 64 rows
//    (four 16-byte loads), a block scan places the valid rows in row order
//    in a list in shared memory (1024 rows at a time), and only then are
//    their segment ids, values and ok flags read, by all threads at once.
//    A step with no valid row reads nothing else.
// 2. Ownership instead of atomics. Warp w merges only the listed rows whose
//    segment s has s % 8 == w (consecutive stations spread over the eight
//    warps), so no two warps ever touch one accumulator slot. A warp queues
//    its rows in list order and merges them 128 at a time.
// 3. Pre-aggregation in a fixed order. When the 128 rows' ids ascend (the
//    station-major case), each lane folds 4 consecutive rows into a running
//    record; a run that ends inside the lane's rows is applied at once (no
//    other lane holds that id's end) and the lane's last run joins a
//    segmented tree over the lanes (shfl_down by 1, 2, 4, 8, 16 within the
//    run of lanes with that id), whose first lane applies the run's count,
//    sums, mins and maxs. 128 rows of one segment cost one update. Other
//    batches (and any C above 4) go in rounds of 32, one row a lane, through
//    the same segmented tree; a round whose ids do not ascend applies its
//    run heads one after another in lane order.
// 4. The order of every float sum depends on the input alone: list order
//    within a step, batches in order within the owning warp, steps in order
//    within the chunk, chunks in order in the combine. So the sums are the
//    same bits from launch to launch, with no float atomics.
// 5. Little partials traffic. The grid is one resident wave (the wrapper's
//    plan: 132 SMs x the CTAs an SM holds, split over the partitions); each
//    CTA writes only the segment range [lo, hi] it touched, with the range
//    itself, and the combine reads, in chunk order, only the chunks whose
//    range holds its segment. On station-major data a chunk touches ~1/60
//    of S. (Combining in the last CTA of each partition instead, to save
//    the second launch, made the kernel slower: one CTA folding every
//    segment over every chunk range is a serial chain of L2 reads.)
// The accumulator (counts [S] | sums [C][S] | mins [C][S] | maxs [C][S];
// sum/count: counts [S] | sums [S]) lives in shared memory when it fits
// beside the row list, else in the CTA's slot of the global partials
// buffer (same code, another pointer; the slot is initialised whole).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 64;         // four 16-byte flag vectors
constexpr int kStepRows = kRowsPerThread * kThreads;
constexpr int kLaneRows = 4;               // rows a lane folds per batch
constexpr int kBatch = 32 * kLaneRows;     // queued rows merged at once
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float min_nan(float m, float v) {
  // jnp.minimum semantics: a NaN value (ok but NaN) poisons the slot
  return (v < m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

struct Args {
  const float* vals;      // [P, N, C]
  const uint8_t* ok;      // [P, N, C] (kFull only)
  const int32_t* seg;     // [P, N]
  const uint8_t* valid;   // [P, N]
  float* partials;        // [P, chunks, W], W = S x (1 + nstat x C)
  int2* ranges;           // [P, chunks]: segments [lo, hi] each CTA wrote
  float* counts;          // [P, S]
  float* sums;            // [P, S, C]
  float* mins;            // [P, S, C] (kFull only)
  float* maxs;            // [P, S, C] (kFull only)
  int n, c, s, chunks, chunk_rows, list_cap, use_smem;
};

__host__ __device__ constexpr int nstat_of(bool full) { return full ? 3 : 1; }

// bytes of one listed row: segment id, C values, C ok flags (kFull)
__host__ __device__ inline size_t list_row_bytes(int c, bool full) {
  return 4 + 4 * static_cast<size_t>(c) + (full ? c : 0);
}

// Sixteen flag bytes of rows [r, r + 16) (zeros past `end`): one 16-byte
// load when the address is aligned and the rows are whole.
__device__ __forceinline__ uint4 load_flags(const uint8_t* v, int64_t r,
                                            int64_t end, bool vec) {
  if (vec && r + 16 <= end)
    return *reinterpret_cast<const uint4*>(v + r);
  uint32_t w[4] = {0, 0, 0, 0};
  for (int k = 0; k < 16; ++k)
    if (r + k < end && v[r + k]) w[k >> 2] |= 1u << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bit k set when flag byte k is non-zero
__device__ __forceinline__ uint32_t flag_mask(uint4 f) {
  const uint32_t x[4] = {f.x, f.y, f.z, f.w};
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    m |= static_cast<uint32_t>(((x[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0)
         << k;
  return m;
}

// The flags of one thread's kRowsPerThread rows, from row r on.
struct Flags {
  uint4 v[kRowsPerThread / 16];

  __device__ __forceinline__ void load(const uint8_t* valid, int64_t r,
                                       int64_t end, bool vec) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread / 16; ++k)
      v[k] = load_flags(valid, r + 16 * k, end, vec);
  }

  __device__ __forceinline__ uint64_t mask() const {
    uint64_t m = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread / 16; ++k)
      m |= static_cast<uint64_t>(flag_mask(v[k])) << (16 * k);
    return m;
  }
};

// Read the segment id, values and ok flags of the listed rows; l_seg holds
// row indices on entry and segment ids (-1: dropped) on exit. Four rows a
// thread are loaded before any is stored, so their loads overlap.
template <int C, bool kFull>
__device__ __forceinline__ void load_list(const Args& a, const int32_t* seg,
                                          const float* vals,
                                          const uint8_t* ok, int32_t* l_seg,
                                          float* l_val, uint8_t* l_ok,
                                          int n_list, int c) {
  constexpr int kU = 4;
  constexpr int kC = C > 0 ? C : 1;
  for (int i0 = threadIdx.x; i0 < n_list; i0 += kU * kThreads) {
    int r[kU], sg[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      r[u] = i < n_list ? l_seg[i] : -1;
    }
    if constexpr (C >= 0) {
      float v[kU][kC];
      uint8_t o[kU][kC];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r[u] < 0) continue;
        const int64_t rc = static_cast<int64_t>(r[u]) * C;
        sg[u] = seg[r[u]];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          v[u][j] = vals[rc + j];
          if constexpr (kFull) o[u][j] = ok[rc + j];
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r[u] < 0) continue;
        const int i = i0 + u * kThreads;
        l_seg[i] = (sg[u] >= 0 && sg[u] < a.s) ? sg[u] : -1;
#pragma unroll
        for (int j = 0; j < C; ++j) {
          l_val[i * C + j] = v[u][j];
          if constexpr (kFull) l_ok[i * C + j] = o[u][j];
        }
      }
    } else {   // runtime column count
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (r[u] < 0) continue;
        const int i = i0 + u * kThreads;
        const int64_t rc = static_cast<int64_t>(r[u]) * c;
        const int x = seg[r[u]];
        const int64_t ic = static_cast<int64_t>(i) * c;
        for (int j = 0; j < c; ++j) {
          l_val[ic + j] = vals[rc + j];
          if constexpr (kFull) l_ok[ic + j] = ok[rc + j];
        }
        l_seg[i] = (x >= 0 && x < a.s) ? x : -1;
      }
    }
  }
}

// One round of up to 32 queued rows of one warp, in list (so row) order:
// each run of lanes with one segment id is reduced by a fixed tree and its
// first lane applies the result. When the ids ascend over the round (the
// station-major case) the runs' ids are distinct and the heads apply at
// once; else they apply one after another in lane order.
template <int C, bool kFull>
__device__ __forceinline__ void merge_round(
    const uint16_t* queue, int nq, const int32_t* l_seg, const float* l_val,
    const uint8_t* l_ok, int c, int s, float* acc, int lane, int& lo,
    int& hi) {
  const int e = lane < nq ? queue[lane] : -1;    // list entry of this lane
  const int sg = e >= 0 ? l_seg[e] : -1;
  const int prev = __shfl_up_sync(kAll, sg, 1);
  const bool head = e >= 0 && (lane == 0 || prev != sg);
  const unsigned heads = __ballot_sync(kAll, head);
  const unsigned later = lane < 31 ? heads & (~0u << (lane + 1)) : 0u;
  const int end = later ? __ffs(later) - 1 : nq;   // one past this run
  const bool serial =
      __ballot_sync(kAll, e >= 0 && lane > 0 && sg < prev) != 0;
  auto each_head = [&](auto&& apply) {
    if (!serial) {
      if (head) apply();
    } else {
      for (unsigned h = heads; h; h &= h - 1) {
        if (lane == __ffs(h) - 1) apply();
        __syncwarp();
      }
    }
  };
  each_head([&] {
    acc[sg] += static_cast<float>(end - lane);     // the run's row count
    lo = min(lo, sg);
    hi = max(hi, sg);
  });
  const int cc = C >= 0 ? C : c;
#pragma unroll
  for (int j = 0; j < cc; ++j) {
    float sum = 0.f, mn = INFINITY, mx = -INFINITY;
    if (e >= 0 && (!kFull || l_ok[e * cc + j])) {
      const float v = l_val[e * cc + j];
      sum = v;
      mn = v;
      mx = v;
    }
    // after step k, lane l holds [l, min(l + 2k, end))
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const float s2 = __shfl_down_sync(kAll, sum, k);
      if constexpr (kFull) {
        const float mn2 = __shfl_down_sync(kAll, mn, k);
        const float mx2 = __shfl_down_sync(kAll, mx, k);
        if (lane + k < end) {
          mn = min_nan(mn, mn2);
          mx = max_nan(mx, mx2);
        }
      }
      if (lane + k < end) sum += s2;
    }
    each_head([&] {
      acc[static_cast<int64_t>(1 + j) * s + sg] += sum;
      if constexpr (kFull) {
        float* pm = acc + static_cast<int64_t>(1 + cc + j) * s + sg;
        float* px = acc + static_cast<int64_t>(1 + 2 * cc + j) * s + sg;
        *pm = min_nan(*pm, mn);
        *px = max_nan(*px, mx);
      }
    });
  }
  __syncwarp();   // the next round's lanes see these updates
}

// A batch of up to 32 x kLaneRows queued rows whose ids ascend in queue
// order (compile-time C): lane l folds rows [l kLaneRows, +kLaneRows) in
// order into a running record; a run that ends inside the lane's rows is
// applied at once (no other lane holds the end of that id), and the lane's
// last run joins a segmented tree over the lanes whose heads apply after.
template <int C, bool kFull>
__device__ __forceinline__ void merge_batch(
    const uint16_t* queue, int m, const int32_t* l_seg, const float* l_val,
    const uint8_t* l_ok, int s, float* acc, int lane, int& lo, int& hi) {
  constexpr int kC = C > 0 ? C : 1;
  int id = -1, cnt = 0;
  float sum[kC], mn[kC], mx[kC];
  auto reset = [&] {
    cnt = 0;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      sum[j] = 0.f;
      mn[j] = INFINITY;
      mx[j] = -INFINITY;
    }
  };
  auto apply = [&] {
    acc[id] += static_cast<float>(cnt);
    lo = min(lo, id);
    hi = max(hi, id);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      acc[static_cast<int64_t>(1 + j) * s + id] += sum[j];
      if constexpr (kFull) {
        float* pm = acc + static_cast<int64_t>(1 + C + j) * s + id;
        float* px = acc + static_cast<int64_t>(1 + 2 * C + j) * s + id;
        *pm = min_nan(*pm, mn[j]);
        *px = max_nan(*px, mx[j]);
      }
    }
  };
  reset();
#pragma unroll
  for (int t = 0; t < kLaneRows; ++t) {
    const int i = lane * kLaneRows + t;
    if (i >= m) break;
    const int e = queue[i];
    const int x = l_seg[e];
    if (x != id) {
      if (id >= 0) apply();
      reset();
      id = x;
    }
    ++cnt;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (kFull && !l_ok[e * C + j]) continue;
      const float v = l_val[e * C + j];
      sum[j] += v;
      mn[j] = min_nan(mn[j], v);
      mx[j] = max_nan(mx[j], v);
    }
  }
  __syncwarp();   // the direct applies before the tree's
  const int prev = __shfl_up_sync(kAll, id, 1);
  const bool head = id >= 0 && (lane == 0 || prev != id);
  const unsigned heads = __ballot_sync(kAll, head);
  const unsigned later = lane < 31 ? heads & (~0u << (lane + 1)) : 0u;
  const int lanes = (m + kLaneRows - 1) / kLaneRows;   // lanes with rows
  const int end = later ? __ffs(later) - 1 : lanes;    // one past my run
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const int c2 = __shfl_down_sync(kAll, cnt, k);
    if (lane + k < end) cnt += c2;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float s2 = __shfl_down_sync(kAll, sum[j], k);
      if constexpr (kFull) {
        const float mn2 = __shfl_down_sync(kAll, mn[j], k);
        const float mx2 = __shfl_down_sync(kAll, mx[j], k);
        if (lane + k < end) {
          mn[j] = min_nan(mn[j], mn2);
          mx[j] = max_nan(mx[j], mx2);
        }
      }
      if (lane + k < end) sum[j] += s2;
    }
  }
  if (head) apply();
  __syncwarp();   // the next batch's lanes see these updates
}

// Merge m <= 32 x kLaneRows queued rows: as one batch when their ids
// ascend (compile-time C), else in rounds of 32.
template <int C, bool kFull>
__device__ __forceinline__ void merge_queued(
    const uint16_t* queue, int m, const int32_t* l_seg, const float* l_val,
    const uint8_t* l_ok, int c, int s, float* acc, int lane, int& lo,
    int& hi) {
  if constexpr (C >= 0) {
    bool down = false;
#pragma unroll
    for (int t = 0; t < kLaneRows; ++t) {
      const int i = lane * kLaneRows + t;
      if (i >= 1 && i < m) down |= l_seg[queue[i]] < l_seg[queue[i - 1]];
    }
    if (!__any_sync(kAll, down)) {
      merge_batch<C, kFull>(queue, m, l_seg, l_val, l_ok, s, acc, lane, lo,
                            hi);
      return;
    }
  }
  for (int r = 0; r < m; r += 32)
    merge_round<C, kFull>(queue + r, min(32, m - r), l_seg, l_val, l_ok, c,
                          s, acc, lane, lo, hi);
}

// Warp `warp` merges the listed rows of the segments it owns, in list
// order, kBatch at a time.
template <int C, bool kFull>
__device__ __forceinline__ void warp_merge(
    const int32_t* l_seg, const float* l_val, const uint8_t* l_ok,
    int n_list, int c, int s, float* acc, uint16_t* queue, int warp,
    int lane, int& lo, int& hi) {
  constexpr int kU = 4;     // list reads in flight
  int qlen = 0;
  for (int b = 0; b < n_list; b += 32 * kU) {
    unsigned mine = 0;      // bit u: this lane owns entry b + 32u + lane
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = b + 32 * u + lane;
      const int sg = i < n_list ? l_seg[i] : -1;
      mine |= static_cast<unsigned>(sg >= 0 && (sg & (kWarps - 1)) == warp)
              << u;
    }
#pragma unroll 1   // one copy of merge_queued: registers, not code
    for (int u = 0; u < kU; ++u) {
      const bool own = (mine >> u) & 1u;
      const unsigned bal = __ballot_sync(kAll, own);
      if (bal == 0) continue;
      if (own)
        queue[qlen + __popc(bal & ((1u << lane) - 1))] =
            static_cast<uint16_t>(b + 32 * u + lane);
      qlen += __popc(bal);
      __syncwarp();
      if (qlen >= kBatch) {
        merge_queued<C, kFull>(queue, kBatch, l_seg, l_val, l_ok, c, s, acc,
                               lane, lo, hi);
        const int rest = qlen - kBatch;
        const uint16_t t = lane < rest ? queue[kBatch + lane] : 0;
        __syncwarp();
        if (lane < rest) queue[lane] = t;
        __syncwarp();
        qlen = rest;
      }
    }
  }
  if (qlen > 0)
    merge_queued<C, kFull>(queue, qlen, l_seg, l_val, l_ok, c, s, acc, lane,
                           lo, hi);
}

// CTAs an SM should hold by registers: more CTAs overlap one CTA's row
// loads with another's merge; the narrow cases have the shared memory.
template <int C>
constexpr int kMinBlocks = C >= 0 && C <= 2 ? 3 : 2;

// Pass 1: grid (chunks, P); CTA (chunk, p) reduces rows
// [chunk x chunk_rows, +chunk_rows) of partition p into its accumulator,
// then records the segment range it touched.
template <int C, bool kFull>
__global__ void __launch_bounds__(kThreads, kMinBlocks<C>)
seg_pass1_kernel(Args a) {
  extern __shared__ float4 smem_raw[];
  __shared__ int s_total[2][kWarps];
  __shared__ int s_lo, s_hi;
  __shared__ uint16_t s_queue[kWarps][kBatch + 32];

  const int c = C >= 0 ? C : a.c;
  const int s = a.s;
  const int parts = 1 + nstat_of(kFull) * c;
  const int64_t w = static_cast<int64_t>(s) * parts;
  const int p = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t slot = static_cast<int64_t>(p) * a.chunks + chunk;

  char* base = reinterpret_cast<char*>(smem_raw);
  float* acc = a.partials + slot * w;
  if (a.use_smem) {
    acc = reinterpret_cast<float*>(base);
    base += (w * 4 + 15) / 16 * 16;
  }
  int32_t* l_seg = reinterpret_cast<int32_t*>(base);
  float* l_val = reinterpret_cast<float*>(l_seg + a.list_cap);
  uint8_t* l_ok =
      reinterpret_cast<uint8_t*>(l_val + static_cast<int64_t>(a.list_cap) * c);

  for (int part = 0; part < parts; ++part) {
    const int stat = part == 0 ? 0 : (part - 1) / c;
    const float id = stat == 1 ? INFINITY : (stat == 2 ? -INFINITY : 0.f);
    float* dst = acc + static_cast<int64_t>(part) * s;
    for (int i = tid; i < s; i += kThreads) dst[i] = id;
  }
  if (tid == 0) {
    s_lo = s;
    s_hi = -1;
  }
  __syncthreads();

  const int64_t pn = static_cast<int64_t>(p) * a.n;
  const uint8_t* valid = a.valid + pn;
  const int32_t* seg = a.seg + pn;
  const float* vals = a.vals + pn * c;
  const uint8_t* ok = kFull ? a.ok + pn * c : nullptr;
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  const int64_t row0 = static_cast<int64_t>(chunk) * a.chunk_rows;
  const int64_t row_end = min(static_cast<int64_t>(a.n),
                              row0 + a.chunk_rows);
  int lo = s, hi = -1;   // segments this warp's heads applied
  int parity = 0;
  for (int64_t t0 = row0; t0 < row_end; t0 += kStepRows, parity ^= 1) {
    Flags f;
    f.load(valid, t0 + kRowsPerThread * tid, row_end, vec);
    const uint64_t m = f.mask();
    // block-wide exclusive scan of the valid rows per thread
    const int cnt = __popcll(m);
    int incl = cnt;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, k);
      if (lane >= k) incl += y;
    }
    if (lane == 31) s_total[parity][warp] = incl;
    __syncthreads();
    int first = incl - cnt, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int t = s_total[parity][k];
      first += k < warp ? t : 0;
      total += t;
    }
    if (total == 0) continue;      // block-uniform: nothing else is read
    for (int lo_pos = 0; lo_pos < total; lo_pos += a.list_cap) {
      const int n_list = min(a.list_cap, total - lo_pos);
      // the window's rows, in row order
      if (first < lo_pos + n_list && first + cnt > lo_pos) {
        int pos = first;
        for (uint64_t mm = m; mm; mm &= mm - 1, ++pos)
          if (pos >= lo_pos && pos < lo_pos + n_list)
            l_seg[pos - lo_pos] = static_cast<int>(t0)
                + kRowsPerThread * tid + (__ffsll(mm) - 1);
      }
      __syncthreads();
      load_list<C, kFull>(a, seg, vals, ok, l_seg, l_val, l_ok, n_list, c);
      __syncthreads();
      warp_merge<C, kFull>(l_seg, l_val, l_ok, n_list, c, s, acc,
                           s_queue[warp], warp, lane, lo, hi);
      __syncthreads();   // the list is rewritten next
    }
  }

#pragma unroll
  for (int k = 16; k; k >>= 1) {
    lo = min(lo, __shfl_xor_sync(kAll, lo, k));
    hi = max(hi, __shfl_xor_sync(kAll, hi, k));
  }
  if (lane == 0 && hi >= lo) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int lo_b = s_lo, hi_b = s_hi;
  if (tid == 0) a.ranges[slot] = make_int2(lo_b, hi_b);
  if (a.use_smem) {
    float* out = a.partials + slot * w;
    for (int part = 0; part < parts; ++part) {
      const int64_t off = static_cast<int64_t>(part) * s;
      for (int i = lo_b + tid; i <= hi_b; i += kThreads)
        out[off + i] = acc[off + i];
    }
  }
}

// Pass 2: grid (ceil(W / 256), P); one thread per output slot combines the
// chunks of its partition in chunk order, reading only those whose range
// holds its segment.
__global__ void __launch_bounds__(256)
seg_combine_kernel(Args a, int nstat) {
  extern __shared__ int2 s_rng[];
  const int p = blockIdx.y;
  for (int k = threadIdx.x; k < a.chunks; k += blockDim.x)
    s_rng[k] = a.ranges[static_cast<int64_t>(p) * a.chunks + k];
  __syncthreads();
  const int c = a.c, s = a.s;
  const int64_t w = static_cast<int64_t>(s) * (1 + nstat * c);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= w) return;
  const int part = static_cast<int>(i / s);
  const int sg = static_cast<int>(i - static_cast<int64_t>(part) * s);
  const int stat = part == 0 ? 0 : (part - 1) / c;   // 0 sum, 1 min, 2 max
  const int j = part == 0 ? 0 : (part - 1) % c;
  float v = stat == 1 ? INFINITY : (stat == 2 ? -INFINITY : 0.f);
  const float* src = a.partials + static_cast<int64_t>(p) * a.chunks * w + i;
#pragma unroll 4
  for (int k = 0; k < a.chunks; ++k) {
    const int2 r = s_rng[k];
    if (sg < r.x || sg > r.y) continue;
    const float x = src[static_cast<int64_t>(k) * w];
    v = stat == 1 ? min_nan(v, x) : (stat == 2 ? max_nan(v, x) : v + x);
  }
  const int64_t o = static_cast<int64_t>(p) * s + sg;
  if (part == 0)
    a.counts[o] = v;
  else
    (stat == 0 ? a.sums : (stat == 1 ? a.mins : a.maxs))[o * c + j] = v;
}

template <int C, bool kFull>
int launch(const Args& a, int p, int device, cudaStream_t st) {
  const int c = C >= 0 ? C : a.c;
  const int64_t w = static_cast<int64_t>(a.s) * (1 + nstat_of(kFull) * c);
  const size_t smem = (a.use_smem ? (w * 4 + 15) / 16 * 16 : 0)
                      + a.list_cap * list_row_bytes(c, kFull);
  // raise the dynamic shared-memory limit once per device and size
  static size_t limit[64];
  auto* kern = seg_pass1_kernel<C, kFull>;
  if (device < 0 || device >= 64 || smem > limit[device]) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    if (device >= 0 && device < 64) limit[device] = smem;
  }
  kern<<<dim3(a.chunks, p), kThreads, smem, st>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid2(static_cast<unsigned>((w + 255) / 256), p);
  seg_combine_kernel<<<grid2, 256, a.chunks * sizeof(int2), st>>>(
      a, nstat_of(kFull));
  return static_cast<int>(cudaGetLastError());
}

// Both entry points take ptr = {vals, ok, seg, valid, partials, ranges,
// counts, sums, mins, maxs} and cfg = {P, N, C, S, chunks, chunk_rows,
// list_cap, use_smem, device}, the plan from the wrapper's
// seg_aggregate.plan_for.

Args make_args(const void* const* ptr, const int* cfg, bool full) {
  auto f = [&](int i) {
    return static_cast<float*>(const_cast<void*>(ptr[i]));
  };
  Args a{};
  a.vals = f(0);
  a.ok = full ? static_cast<const uint8_t*>(ptr[1]) : nullptr;
  a.seg = static_cast<const int32_t*>(ptr[2]);
  a.valid = static_cast<const uint8_t*>(ptr[3]);
  a.partials = f(4);
  a.ranges = reinterpret_cast<int2*>(f(5));
  a.counts = f(6);
  a.sums = f(7);
  a.mins = full ? f(8) : nullptr;
  a.maxs = full ? f(9) : nullptr;
  a.n = cfg[1];
  a.c = full ? cfg[2] : 1;
  a.s = cfg[3];
  a.chunks = cfg[4];
  a.chunk_rows = cfg[5];
  a.list_cap = cfg[6];
  a.use_smem = cfg[7];
  return a;
}

template <int C, bool kFull>
int resident(int smem) {
  auto* kern = seg_pass1_kernel<C, kFull>;
  int n = 0;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, kThreads, smem));
  return err ? -err : n;
}

}  // namespace

// Pass-1 CTAs one SM holds for C columns (full: the aggregate, else
// sum/count) at `smem` dynamic bytes, by registers, threads and shared
// memory together; a negative cudaError_t on failure. The wrapper's plan
// sizes the grid to one wave of them.
extern "C" int repro_seg_resident(int c, int full, int smem, int device) {
  int err = repro::select_device(device);
  if (err) return -err;
  if (!full) return resident<1, false>(smem);
  switch (c) {
    case 0: return resident<0, true>(smem);
    case 1: return resident<1, true>(smem);
    case 2: return resident<2, true>(smem);
    case 3: return resident<3, true>(smem);
    case 4: return resident<4, true>(smem);
    default: return resident<-1, true>(smem);
  }
}

// vals/ok [P, N, C] (f32, bool bytes), seg/valid [P, N] (i32, bool bytes);
// scratch: partials P x chunks x (1 + 3C) x S floats and ranges P x chunks
// int2; outputs counts [P, S], sums/mins/maxs [P, S, C] f32.
extern "C" int repro_seg_agg(const void* const* ptr, const int* cfg,
                             void* stream) {
  int err = repro::select_device(cfg[8]);
  if (err) return err;
  const int p = cfg[0], c = cfg[2], s = cfg[3], device = cfg[8];
  if (p == 0 || s == 0) return 0;
  const Args a = make_args(ptr, cfg, true);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 0: return launch<0, true>(a, p, device, st);
    case 1: return launch<1, true>(a, p, device, st);
    case 2: return launch<2, true>(a, p, device, st);
    case 3: return launch<3, true>(a, p, device, st);
    case 4: return launch<4, true>(a, p, device, st);
    default: return launch<-1, true>(a, p, device, st);
  }
}

// vals [P, N] f32, seg/valid [P, N] (i32, bool bytes); scratch: partials
// P x chunks x 2S floats and ranges P x chunks int2; outputs counts and
// sums [P, S] f32 (ok, mins, maxs and C unused).
extern "C" int repro_seg_sum_count(const void* const* ptr, const int* cfg,
                                   void* stream) {
  int err = repro::select_device(cfg[8]);
  if (err) return err;
  if (cfg[0] == 0 || cfg[3] == 0) return 0;
  return launch<1, false>(make_args(ptr, cfg, false), cfg[0], cfg[8],
                          static_cast<cudaStream_t>(stream));
}
