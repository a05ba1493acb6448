// Fused segment aggregation over a leading partition dimension.
//
// Replaces the Pallas TPU kernel src/repro/kernels/seg_aggregate.py
// (segmented_aggregate -> _agg_kernel): one pass over the rows gives, per
// segment, the count of valid rows and, per value column, the sum, min and
// max of the values whose `ok` flag is set. Rows that are not valid, or
// whose segment id lies outside [0, S), are dropped. Empty slots read
// 0 / +inf / -inf.
//
// Design. The TPU kernel built a one-hot (rows x S) tile for the matrix
// unit; here that would cost O(N x S). Instead, pass 1 runs grid =
// (chunks, P): each CTA takes a contiguous chunk of one partition's rows
// and accumulates per-segment partials, one slot per (segment, output).
// Within the CTA, thread t owns the segments s with s % 256 == t. Rows are
// staged 256 at a time in shared memory and every thread walks the staged
// rows in row order, updating only the segments it owns. No two threads
// ever touch one slot, so no atomics are needed, and every sum is taken in
// row order: the result is the same bit for bit from run to run. The
// partials live in shared memory when (1 + 3C) x S floats fit, else in the
// CTA's slot of the global partials buffer (same code, another pointer).
// Pass 2 combines the chunks of each partition in chunk order, again
// deterministic, and writes counts [P, S] and sums/mins/maxs [P, S, C].
//
// Bound on the H100: bytes. Each row is read once (4 + 5C bytes of values,
// ok flags and segment id, plus its valid byte) and (1 + 3C) x S floats per
// partition are written; the inner loop costs 256 shared-memory reads per
// staged row per CTA, which is what this simple design pays above the bound.
//
// The same file replaces the module's second Pallas kernel,
// segmented_sum_count (src/repro/kernels/seg_aggregate.py:125): per segment,
// the sum of one value column over the valid rows and their count. Its own
// pair of kernels (repro_seg_sum_count) uses the same owner-per-segment
// pass and fixed-order combine, with partials sums [S] | counts [S]: no
// atomics, sums in row order, the same bits from launch to launch. Bound:
// bytes (9 bytes a row read, 8 x S bytes a partition written).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // also the number of rows staged per step
constexpr size_t kSmemLimit = 200 * 1024;

__device__ __forceinline__ float min_nan(float m, float v) {
  // jnp.minimum semantics: a NaN value (ok but NaN) poisons the slot
  return (v < m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// acc layout per (partition, chunk): counts [S] | sums [C][S] |
// mins [C][S] | maxs [C][S]
__global__ void __launch_bounds__(kThreads)
seg_agg_partial_kernel(const float* __restrict__ vals,
                       const uint8_t* __restrict__ ok,
                       const int32_t* __restrict__ seg,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ partials, int n, int c, int s,
                       int chunk_rows, int use_smem) {
  extern __shared__ float4 smem_raw[];
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem_raw);        // [256]
  float* s_val = reinterpret_cast<float*>(s_seg + kThreads);     // [256*C]
  uint8_t* s_ok = reinterpret_cast<uint8_t*>(s_val + kThreads * c);
  // acc (if in shared memory) starts after the 16-byte-rounded stage
  const size_t stage = (static_cast<size_t>(kThreads) * (4 + 5 * c) + 15)
                       / 16 * 16;
  const int p = blockIdx.y;
  const int chunk = blockIdx.x;
  const int64_t w = static_cast<int64_t>(s) * (1 + 3 * c);
  float* acc = use_smem
      ? reinterpret_cast<float*>(reinterpret_cast<char*>(smem_raw) + stage)
      : partials + (static_cast<int64_t>(p) * gridDim.x + chunk) * w;
  const int64_t zero_end = static_cast<int64_t>(s) * (1 + c);
  const int64_t min_end = static_cast<int64_t>(s) * (1 + 2 * c);
  for (int64_t i = threadIdx.x; i < w; i += kThreads)
    acc[i] = i < zero_end ? 0.f : (i < min_end ? INFINITY : -INFINITY);
  const int64_t row0 = static_cast<int64_t>(chunk) * chunk_rows;
  const int64_t row_end = min(static_cast<int64_t>(n), row0 + chunk_rows);
  const int64_t pbase = static_cast<int64_t>(p) * n;
  const int tid = threadIdx.x;
  for (int64_t t0 = row0; t0 < row_end; t0 += kThreads) {
    __syncthreads();   // acc initialised / previous stage consumed
    const int64_t r = t0 + tid;
    int sg = -1;
    if (r < row_end && valid[pbase + r]) {
      const int v = seg[pbase + r];
      if (v >= 0 && v < s) sg = v;
    }
    s_seg[tid] = sg;
    for (int j = 0; j < c; ++j) {
      const bool in = r < row_end;
      s_val[tid * c + j] = in ? vals[(pbase + r) * c + j] : 0.f;
      s_ok[tid * c + j] = in ? ok[(pbase + r) * c + j] : 0;
    }
    __syncthreads();
    const int rows = static_cast<int>(min(static_cast<int64_t>(kThreads),
                                          row_end - t0));
    for (int i = 0; i < rows; ++i) {
      const int sg_i = s_seg[i];
      if (sg_i < 0 || (sg_i % kThreads) != tid) continue;
      acc[sg_i] += 1.f;
      for (int j = 0; j < c; ++j) {
        if (!s_ok[i * c + j]) continue;
        const float v = s_val[i * c + j];
        float* col = acc + s + static_cast<int64_t>(j) * s + sg_i;
        col[0] += v;
        col[static_cast<int64_t>(c) * s] =
            min_nan(col[static_cast<int64_t>(c) * s], v);
        col[static_cast<int64_t>(2 * c) * s] =
            max_nan(col[static_cast<int64_t>(2 * c) * s], v);
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    float* out = partials + (static_cast<int64_t>(p) * gridDim.x + chunk) * w;
    for (int64_t i = threadIdx.x; i < w; i += kThreads) out[i] = acc[i];
  }
}

__global__ void seg_agg_combine_kernel(const float* __restrict__ partials,
                                       float* __restrict__ counts,
                                       float* __restrict__ sums,
                                       float* __restrict__ mins,
                                       float* __restrict__ maxs, int c,
                                       int s, int chunks) {
  const int p = blockIdx.y;
  const int64_t w = static_cast<int64_t>(s) * (1 + 3 * c);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= w) return;
  const float* src = partials + static_cast<int64_t>(p) * chunks * w + i;
  if (i < s) {
    float a = 0.f;
    for (int k = 0; k < chunks; ++k) a += src[k * w];
    counts[static_cast<int64_t>(p) * s + i] = a;
    return;
  }
  const int64_t q = i - s;                     // within sums|mins|maxs
  const int part = static_cast<int>(q / (static_cast<int64_t>(c) * s));
  const int64_t r = q % (static_cast<int64_t>(c) * s);
  const int j = static_cast<int>(r / s);       // value column
  const int64_t sg = r % s;                    // segment
  const int64_t dst = (static_cast<int64_t>(p) * s + sg) * c + j;
  float a = part == 0 ? 0.f : (part == 1 ? INFINITY : -INFINITY);
  for (int k = 0; k < chunks; ++k) {
    const float v = src[k * w];
    a = part == 0 ? a + v : (part == 1 ? min_nan(a, v) : max_nan(a, v));
  }
  (part == 0 ? sums : (part == 1 ? mins : maxs))[dst] = a;
}

// acc layout per (partition, chunk): sums [S] | counts [S]
__global__ void __launch_bounds__(kThreads)
seg_sum_count_partial_kernel(const float* __restrict__ vals,
                             const int32_t* __restrict__ seg,
                             const uint8_t* __restrict__ valid,
                             float* __restrict__ partials, int n, int s,
                             int chunk_rows, int use_smem) {
  extern __shared__ float4 smem_raw[];
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem_raw);        // [256]
  float* s_val = reinterpret_cast<float*>(s_seg + kThreads);     // [256]
  const int p = blockIdx.y;
  const int chunk = blockIdx.x;
  const int64_t w = 2 * static_cast<int64_t>(s);
  float* acc = use_smem
      ? s_val + kThreads
      : partials + (static_cast<int64_t>(p) * gridDim.x + chunk) * w;
  for (int64_t i = threadIdx.x; i < w; i += kThreads) acc[i] = 0.f;
  const int64_t row0 = static_cast<int64_t>(chunk) * chunk_rows;
  const int64_t row_end = min(static_cast<int64_t>(n), row0 + chunk_rows);
  const int64_t pbase = static_cast<int64_t>(p) * n;
  const int tid = threadIdx.x;
  for (int64_t t0 = row0; t0 < row_end; t0 += kThreads) {
    __syncthreads();   // acc initialised / previous stage consumed
    const int64_t r = t0 + tid;
    int sg = -1;
    float v = 0.f;
    if (r < row_end && valid[pbase + r]) {
      const int x = seg[pbase + r];
      if (x >= 0 && x < s) {
        sg = x;
        v = vals[pbase + r];
      }
    }
    s_seg[tid] = sg;
    s_val[tid] = v;
    __syncthreads();
    const int rows = static_cast<int>(min(static_cast<int64_t>(kThreads),
                                          row_end - t0));
    for (int i = 0; i < rows; ++i) {
      const int sg_i = s_seg[i];
      if (sg_i < 0 || (sg_i % kThreads) != tid) continue;
      acc[sg_i] += s_val[i];
      acc[s + sg_i] += 1.f;
    }
  }
  if (use_smem) {
    __syncthreads();
    float* out = partials + (static_cast<int64_t>(p) * gridDim.x + chunk) * w;
    for (int64_t i = threadIdx.x; i < w; i += kThreads) out[i] = acc[i];
  }
}

__global__ void seg_sum_count_combine_kernel(const float* __restrict__ partials,
                                             float* __restrict__ sums,
                                             float* __restrict__ counts,
                                             int s, int chunks) {
  const int p = blockIdx.y;
  const int64_t w = 2 * static_cast<int64_t>(s);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (i >= w) return;
  const float* src = partials + static_cast<int64_t>(p) * chunks * w + i;
  float a = 0.f;
  for (int k = 0; k < chunks; ++k) a += src[k * w];
  if (i < s)
    sums[static_cast<int64_t>(p) * s + i] = a;
  else
    counts[static_cast<int64_t>(p) * s + (i - s)] = a;
}

}  // namespace

// vals [P, N] f32, seg [P, N] i32, valid [P, N] bool bytes; partials:
// P x chunks x 2S floats of scratch; outputs sums, counts [P, S] f32.
extern "C" int repro_seg_sum_count(const void* vals, const void* seg,
                                   const void* valid, void* partials,
                                   void* sums, void* counts, int p, int n,
                                   int s, int chunks, int device,
                                   void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk_rows = (n + chunks - 1) / chunks;
  const size_t stage = static_cast<size_t>(kThreads) * 8;
  const size_t acc_bytes = static_cast<size_t>(s) * 2 * sizeof(float);
  const int use_smem = stage + acc_bytes <= kSmemLimit;
  const size_t smem = stage + (use_smem ? acc_bytes : 0);
  err = static_cast<int>(cudaFuncSetAttribute(
      seg_sum_count_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  seg_sum_count_partial_kernel<<<dim3(chunks, p), kThreads, smem, st>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(seg),
      static_cast<const uint8_t*>(valid), static_cast<float*>(partials), n,
      s, chunk_rows, use_smem);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid2(static_cast<unsigned>((2 * static_cast<int64_t>(s) + 255) / 256),
             p);
  seg_sum_count_combine_kernel<<<grid2, 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(sums),
      static_cast<float*>(counts), s, chunks);
  return static_cast<int>(cudaGetLastError());
}

// vals/ok [P, N, C] (f32, bool bytes), seg/valid [P, N] (i32, bool bytes);
// partials: P x chunks x (1 + 3C) x S floats of scratch; outputs counts
// [P, S], sums/mins/maxs [P, S, C] f32. `chunks` CTAs per partition.
extern "C" int repro_seg_agg(const void* vals, const void* ok,
                             const void* seg, const void* valid,
                             void* partials, void* counts, void* sums,
                             void* mins, void* maxs, int p, int n, int c,
                             int s, int chunks, int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk_rows = (n + chunks - 1) / chunks;
  const size_t stage = (static_cast<size_t>(kThreads) * (4 + 5 * c) + 15)
                       / 16 * 16;
  const size_t acc_bytes = static_cast<size_t>(s) * (1 + 3 * c)
                           * sizeof(float);
  const int use_smem = stage + acc_bytes <= kSmemLimit;
  const size_t smem = stage + (use_smem ? acc_bytes : 0);
  err = static_cast<int>(cudaFuncSetAttribute(
      seg_agg_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  seg_agg_partial_kernel<<<dim3(chunks, p), kThreads, smem, st>>>(
      static_cast<const float*>(vals), static_cast<const uint8_t*>(ok),
      static_cast<const int32_t*>(seg), static_cast<const uint8_t*>(valid),
      static_cast<float*>(partials), n, c, s, chunk_rows, use_smem);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t w = static_cast<int64_t>(s) * (1 + 3 * c);
  dim3 grid2(static_cast<unsigned>((w + 255) / 256), p);
  seg_agg_combine_kernel<<<grid2, 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(counts),
      static_cast<float*>(sums), static_cast<float*>(mins),
      static_cast<float*>(maxs), c, s, chunks);
  return static_cast<int>(cudaGetLastError());
}
