// Segment top-k selection over a leading partition dimension.
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_topk.py
// (segment_topk -> _topk_kernel): the first `cap` row indices of the
// stable ascending lexicographic order over the key rows. Key 0 is the
// invalid-sink flag (int32 0/1), then the sort keys most significant
// first, descending keys already negated; ties break on the row index.
// Keys are int32 or float32 and NaN-free.
//
// Design. One CTA of 1024 threads per partition (grid = P); N is a group
// tile, a few thousand rows. The CTA first rewrites every key as an
// order-preserving uint32 (int32: flip the sign bit; float32: canonicalise
// -0.0 to +0.0, which the reference's lexsort ranks equal, then flip all
// bits of negatives and the sign bit of the rest) into a scratch buffer,
// so every later compare is an unsigned integer compare. Then `cap` rounds
// of a block-wide lexicographic argmin: each thread scans its strided rows,
// warps reduce by shuffles, warp 0 reduces the 32 warp winners, and the
// winner's flag is set to 0xFFFFFFFF so that later rounds skip it (real
// flags are 0 or 1). Comparisons carry the row index last, which is the
// stable order.
//
// Bound on the H100: bytes, well under a microsecond at Q11's shapes
// (keys read once, cap indices written). The cap serial rounds, each a
// block reduction, are what this design pays above it; a shared-memory
// bitonic sort on packed keys is the later, faster form.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kTaken = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t ordered_bits(int32_t raw, bool is_float) {
  uint32_t b = static_cast<uint32_t>(raw);
  if (!is_float) return b ^ 0x80000000u;
  if (b == 0x80000000u) b = 0u;                     // -0.0 == +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// true iff row a precedes row b; -1 stands for "no row" and loses
__device__ __forceinline__ bool precedes(const uint32_t* keys, int64_t n,
                                         int nkeys, int a, int b) {
  if (a < 0) return false;
  if (b < 0) return true;
  for (int k = 0; k < nkeys; ++k) {
    const uint32_t ka = keys[k * n + a];
    const uint32_t kb = keys[k * n + b];
    if (ka != kb) return ka < kb;
  }
  return a < b;
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const int32_t* __restrict__ raw, uint32_t* scratch,
            int32_t* __restrict__ out, int p_count, int n, int nkeys,
            unsigned float_mask, int cap) {
  __shared__ int s_best[kThreads / 32];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t nn = n;
  uint32_t* keys = scratch + static_cast<int64_t>(p) * nkeys * nn;
  for (int k = 0; k < nkeys; ++k) {
    const int32_t* src = raw + (static_cast<int64_t>(k) * p_count + p) * nn;
    const bool is_float = (float_mask >> k) & 1u;
    for (int i = tid; i < n; i += kThreads)
      keys[k * nn + i] = ordered_bits(src[i], is_float);
  }
  for (int m = 0; m < cap; ++m) {
    __syncthreads();   // keys written / previous winner marked
    int best = -1;
    for (int i = tid; i < n; i += kThreads)
      if (keys[i] != kTaken && precedes(keys, nn, nkeys, i, best)) best = i;
    for (int off = 16; off > 0; off >>= 1) {
      const int other = __shfl_down_sync(0xFFFFFFFFu, best, off);
      if (precedes(keys, nn, nkeys, other, best)) best = other;
    }
    if ((tid & 31) == 0) s_best[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      best = s_best[tid];
      for (int off = 16; off > 0; off >>= 1) {
        const int other = __shfl_down_sync(0xFFFFFFFFu, best, off);
        if (precedes(keys, nn, nkeys, other, best)) best = other;
      }
      if (tid == 0) {
        out[static_cast<int64_t>(p) * cap + m] = best;
        if (best >= 0) keys[best] = kTaken;
      }
    }
  }
}

}  // namespace

// raw: [nkeys, P, N] int32 (float keys as their bits, bit k of float_mask
// set); scratch: [P, nkeys, N] uint32; out: [P, cap] int32, cap <= N.
extern "C" int repro_segment_topk(const void* raw, void* scratch, void* out,
                                  int p, int n, int nkeys,
                                  unsigned float_mask, int cap, int device,
                                  void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || cap == 0) return 0;
  topk_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(raw), static_cast<uint32_t*>(scratch),
      static_cast<int32_t*>(out), p, n, nkeys, float_mask, cap);
  return static_cast<int>(cudaGetLastError());
}
