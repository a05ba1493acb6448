// Segment top-k selection over a leading partition dimension.
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_topk.py
// (segment_topk -> _topk_kernel): the first `cap` row indices of the
// stable ascending lexicographic order over the key rows. Key 0 is the
// invalid-sink flag (int32 0/1), then the sort keys most significant
// first, descending keys already negated; ties break on the row index.
// Keys are int32 or float32 and NaN-free.
//
// Design: a sort in shared memory, then a merge of the sorted runs.
//
// 1. sort_chunks: one CTA per (chunk, partition). A chunk is `chunk`
//    consecutive rows, a power of two chosen by the wrapper so that the
//    chunk's records fit in shared memory. The CTA reads every key row in
//    place (a pointer and a partition stride per key, passed by value; no
//    stacked copy) and writes one record per row: each key rewritten as an
//    order-preserving uint32 (int32: flip the sign bit; float32:
//    canonicalise -0.0 to +0.0, which the reference's lexsort ranks equal,
//    then flip all bits of negatives and the sign bit of the rest), then
//    the row's position, padded with zeros to whole uint4s (16 bytes a row
//    for up to 3 sort keys and the flag). Rows past the chunk's end are all
//    ones. Records then compare as plain lexicographic uint32 sequences
//    with the position last: a total order, so the unstable bitonic
//    network gives the stable result. The network moves whole records (no
//    indirection through an index array). Only the first min(cap, rows)
//    are wanted, so the CTA sorts groups of G records (G the power of two
//    >= cap) and then halves the candidates round by round: two sorted
//    groups become the G smallest of both, sorted (the bitonic top-k
//    merge), until one group is left; with G >= chunk this is the full
//    sort. Steps whose pairs stay inside a warp sync the warp only. The
//    first min(cap, rows) records are written out as row indices.
// 2. merge_runs (only when N spans several chunks): sorted runs are merged
//    pairwise, keeping the first `cap` of each merged run, until one run is
//    left. An element's place in the merged run is its rank in its own run
//    plus the number of elements of the other run that precede it, by
//    binary search (lower bound for the left run's elements, upper bound
//    for the right's, so equal elements keep the left run first; with the
//    row index in the compare none are equal). Keys are read in place by
//    row index. A run covering rows [r0, r1) is stored at offset r0 of a
//    [P, N] buffer, so runs never overlap; two such buffers alternate and
//    the last merge writes the output.
//
// Bound on the H100: bytes (keys read once, cap indices written), well
// under a microsecond at Q11's shape (P = 4, N = 2000, 3 keys, cap = 16),
// where the whole selection is one launch of P CTAs, each sorting groups
// of 16 of its 2048 records (10 steps inside warps) and merging them in 7
// rounds. What the design pays above the bound is the steps' latency and
// barriers, and the launch.
#include "common.cuh"

namespace {

constexpr int kMaxKeys = 32;
constexpr int kSortThreads = 1024;
constexpr int kMergeThreads = 256;

struct Keys {
  const int32_t* ptr[kMaxKeys];   // key rows, [P, N] with unit row stride
  long long stride[kMaxKeys];     // partition stride in elements
  int nkeys;
  unsigned float_mask;            // bit k: key k holds float32 bits
  int n;
};

__device__ __forceinline__ uint32_t ordered_bits(int32_t raw, bool is_float) {
  uint32_t b = static_cast<uint32_t>(raw);
  if (!is_float) return b ^ 0x80000000u;
  if (b == 0x80000000u) b = 0u;                     // -0.0 == +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_word(const Keys& k, int key, int p,
                                             int row) {
  return ordered_bits(k.ptr[key][p * k.stride[key] + row],
                      (k.float_mask >> key) & 1u);
}

// Records of a chunk in shared memory: W uint4 a row, holding the nkeys
// ordered words, then the row's position in the chunk, then zeros. Rows
// past the chunk's end are all ones and sort last. Record order is plain
// lexicographic order over the 4W words.
template <int W>
__device__ __forceinline__ bool rec_less(const uint4* a, const uint4* b) {
#pragma unroll
  for (int v = 0; v < W; ++v) {
    const uint4 x = a[v];
    const uint4 y = b[v];
    if (x.x != y.x) return x.x < y.x;
    if (x.y != y.y) return x.y < y.y;
    if (x.z != y.z) return x.z < y.z;
    if (x.w != y.w) return x.w < y.w;
  }
  return false;
}

// Orders records a, b ascending (up) or descending.
template <int W>
__device__ __forceinline__ void exchange(uint4* a, uint4* b, bool up) {
  if (up ? rec_less<W>(b, a) : rec_less<W>(a, b)) {
#pragma unroll
    for (int v = 0; v < W; ++v) {
      const uint4 x = a[v];
      a[v] = b[v];
      b[v] = x;
    }
  }
}

// Barrier between two steps of the network. Step stride j maps thread t
// to the pair (lo, lo + j), lo = 2t - (t & (j - 1)): while j <= 32 the
// pairs of a warp stay inside its own 64-record blocks, so two such steps
// in a row need only the warp's barrier.
__device__ __forceinline__ void step_barrier(bool whole_block) {
  if (whole_block) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

template <int W>
__global__ void __launch_bounds__(kSortThreads)
sort_chunks(const __grid_constant__ Keys k, int chunk, int group, int cap,
            int32_t* out, bool to_runs) {
  extern __shared__ uint4 recs[];
  uint32_t* words = reinterpret_cast<uint32_t*>(recs);
  const int c0 = blockIdx.x * chunk;
  const int p = blockIdx.y;
  const int rows = min(chunk, k.n - c0);
  const int tid = threadIdx.x;
  for (int key = 0; key < k.nkeys; ++key)
    for (int i = tid; i < rows; i += kSortThreads)
      words[i * 4 * W + key] = key_word(k, key, p, c0 + i);
  for (int i = tid; i < chunk; i += kSortThreads) {
    uint32_t* r = words + i * 4 * W;
    if (i < rows) {
      r[k.nkeys] = i;
      for (int w = k.nkeys + 1; w < 4 * W; ++w) r[w] = 0u;
    } else {
      for (int w = 0; w < 4 * W; ++w) r[w] = 0xFFFFFFFFu;
    }
  }
  __syncthreads();
  // 1. every group of `group` records sorted ascending (a bitonic network
  //    whose last stage runs all ascending)
  for (int size = 2; size <= group; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < chunk / 2; t += kSortThreads) {
        const int lo = 2 * t - (t & (j - 1));
        exchange<W>(recs + lo * W, recs + (lo + j) * W,
                    size == group || (lo & size) == 0);
      }
      const int next = j > 1 ? j / 2 : size;
      step_barrier(j >= 64 || next >= 64);
    }
  }
  __syncthreads();
  // 2. rounds: each pair of sorted groups A, B `span` records apart becomes
  //    the `group` smallest of both, sorted, in A's place: A[i] = min(A[i],
  //    B[group - 1 - i]) is a bitonic sequence holding them, which a
  //    half-cleaner cascade sorts
  for (int span = group; span < chunk; span *= 2) {
    const int pairs = chunk / (2 * span);
    for (int t = tid; t < pairs * group; t += kSortThreads) {
      const int base = (t / group) * 2 * span;
      const int i = t % group;
      uint4* a = recs + (base + i) * W;
      const uint4* b = recs + (base + span + group - 1 - i) * W;
      if (rec_less<W>(b, a)) {
#pragma unroll
        for (int v = 0; v < W; ++v) a[v] = b[v];
      }
    }
    __syncthreads();
    for (int j = group >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < pairs * (group / 2); t += kSortThreads) {
        const int u = t % (group / 2);
        const int lo = (t / (group / 2)) * 2 * span + 2 * u - (u & (j - 1));
        exchange<W>(recs + lo * W, recs + (lo + j) * W, true);
      }
      // a group's steps stay in one warp while it has <= 64 records
      step_barrier(group > 64 || j == 1);
    }
  }
  // the first `group` records are the chunk's smallest, sorted
  const int keep = min(cap, rows);
  int32_t* dst = to_runs ? out + static_cast<long long>(p) * k.n + c0
                         : out + static_cast<long long>(p) * cap;
  for (int i = tid; i < keep; i += kSortThreads)
    dst[i] = c0 + static_cast<int>(words[i * 4 * W + k.nkeys]);
}

// Row indices a, b of partition p: true iff a precedes b.
__device__ __forceinline__ bool row_precedes(const Keys& k, int p, int a,
                                             int b) {
  for (int key = 0; key < k.nkeys; ++key) {
    const uint32_t wa = key_word(k, key, p, a);
    const uint32_t wb = key_word(k, key, p, b);
    if (wa != wb) return wa < wb;
  }
  return a < b;
}

// One level of the merge. Runs of this level cover `span` rows each (the
// last may cover fewer); run r of partition p sits at src[p * n + r * span]
// with min(cap, rows covered) elements. Pair (2q, 2q + 1) becomes run q of
// the next level, at dst[p * n + 2q * span], or at dst[p * cap] (the
// output) when `last`. blockIdx.y is the pair, blockIdx.z the partition;
// one thread per element of the pair.
__global__ void __launch_bounds__(kMergeThreads)
merge_runs(const __grid_constant__ Keys k, const int32_t* src, int32_t* dst,
           bool last, int span, int cap) {
  const int q = blockIdx.y;
  const int p = blockIdx.z;
  const int a0 = 2 * q * span;
  const int b0 = a0 + span;
  const int len_a = min(cap, min(span, k.n - a0));
  const int len_b = b0 < k.n ? min(cap, min(span, k.n - b0)) : 0;
  const int keep = min(cap, len_a + len_b);
  const int32_t* ra = src + static_cast<long long>(p) * k.n + a0;
  const int32_t* rb = src + static_cast<long long>(p) * k.n + b0;
  int32_t* out = last ? dst + static_cast<long long>(p) * cap
                      : dst + static_cast<long long>(p) * k.n + a0;
  const int e = blockIdx.x * kMergeThreads + threadIdx.x;
  if (e >= len_a + len_b) return;
  const bool in_a = e < len_a;
  const int i = in_a ? e : e - len_a;
  if (i >= keep) return;                 // lands at or past `keep`
  const int row = in_a ? ra[i] : rb[i];
  const int32_t* other = in_a ? rb : ra;
  // lower bound in b of a's element: b elements strictly before it;
  // upper bound in a of b's element: a elements before or equal to it
  int lo = 0;
  int hi = in_a ? len_b : len_a;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int o = other[mid];
    const bool before = in_a ? row_precedes(k, p, o, row)
                             : !row_precedes(k, p, row, o);
    if (before) lo = mid + 1;
    else hi = mid;
  }
  const int at = i + lo;
  if (at < keep) out[at] = row;
}

// Sorts every chunk: records of W uint4, chunk * 16 W bytes of shared
// memory. One chunk writes the output, several write sorted runs.
template <int W>
int sort_all(const Keys& k, int chunk, int cap, int chunks, int p,
             int32_t* out, int32_t* runs, cudaStream_t st) {
  const int smem = chunk * 16 * W;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      sort_chunks<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  int group = 1;              // the smallest power of two >= cap
  while (group < cap && group < chunk) group *= 2;
  sort_chunks<W><<<dim3(chunks, p), kSortThreads, smem, st>>>(
      k, chunk, group, cap, chunks == 1 ? out : runs, chunks > 1);
  return 0;
}

}  // namespace

// keys: 2 * nkeys values, the nkeys key-row pointers, then their partition
// strides (elements): rows [P, N] int32 with unit column stride (float
// keys as their bits, bit k of float_mask set). out: [P, cap] int32,
// 0 < cap <= N. chunk: rows sorted per CTA, a power of two with
// chunk * 16 * ((nkeys + 4) / 4) bytes of shared memory. runs: two [P, N]
// int32 buffers (2 * P * N elements), used when N > chunk, else may be
// null.
extern "C" int repro_segment_topk(const long long* keys, int nkeys,
                                  unsigned float_mask, int p, int n, int cap,
                                  int chunk, void* out, void* runs,
                                  int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || cap == 0) return 0;
  if (nkeys < 1 || nkeys > kMaxKeys || chunk < 2 || (chunk & (chunk - 1))
      || cap > n || (n > chunk && runs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Keys k;
  for (int i = 0; i < nkeys; ++i) {
    k.ptr[i] = reinterpret_cast<const int32_t*>(keys[i]);
    k.stride[i] = keys[nkeys + i];
  }
  k.nkeys = nkeys;
  k.float_mask = float_mask;
  k.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  const int chunks = (n + chunk - 1) / chunk;
  int32_t* buf[2] = {static_cast<int32_t*>(runs), nullptr};
  if (chunks > 1) buf[1] = buf[0] + static_cast<long long>(p) * n;
  switch ((nkeys + 4) / 4) {
    case 1: err = sort_all<1>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 2: err = sort_all<2>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 3: err = sort_all<3>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 4: err = sort_all<4>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 5: err = sort_all<5>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 6: err = sort_all<6>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 7: err = sort_all<7>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    case 8: err = sort_all<8>(k, chunk, cap, chunks, p, o, buf[0], st); break;
    default: err = sort_all<9>(k, chunk, cap, chunks, p, o, buf[0], st); break;
  }
  if (err) return err;
  int cur = 0;
  for (int span = chunk, runs_left = chunks; runs_left > 1;
       span *= 2, runs_left = (runs_left + 1) / 2, cur ^= 1) {
    const bool last = runs_left <= 2;
    const int elems = 2 * min(cap, span);
    merge_runs<<<dim3((elems + kMergeThreads - 1) / kMergeThreads,
                      (runs_left + 1) / 2, p), kMergeThreads, 0, st>>>(
        k, buf[cur], last ? o : buf[cur ^ 1], last, span, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
