// One-token decode attention over a key/value cache, split over the keys.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_bhgd -> _kernel): the G query heads that share one
// key/value head (the GQA group, folded into rows) attend to that head's
// cache slots below kv_len, with an optional sliding window and logit
// softcap. The TPU kernel walks the cache in order, one grid step per key
// block, carrying (acc, m, l) in VMEM.
//
// Design: split-K, as the JAX kernel's docstring describes for a sharded
// cache. Pass 1 runs grid (splits, B*Hkv): each CTA takes the G rows of one
// head against one contiguous slice of that head's live slots (those below
// kv_len and inside the window; kv_len is read on the device, so the grid
// is fixed and the slices follow the data) and writes its partial
// (acc, m, l). 128 threads; 64-slot key and value tiles are staged in
// shared memory, thread t scores (g, slot) pairs, one warp per row runs
// the online softmax, and thread t accumulates outputs t + 128j of the
// G x D block. Pass 2 combines the splits of each head in split order, so
// the result is the same from run to run. B*Hkv = 64 heads alone would
// leave half of the 132 SMs idle; the splits fill the card.
//
// The cache is read through strides in (batch, head, slot, dim) order, so
// the model's (B, Smax, Hkv, D) cache is read in place (never as a
// transposed copy), and only live slots are read. Any Smax; head_dim a
// multiple of 4 with G * D <= 4096. Masked scores are NEG_INF = -2e38 and
// the denominator is max(l, 1e-30), as in the TPU kernel; a head with no
// live slot (kv_len < 1) gets the TPU's mean of V over all Smax slots.
//
// Bound on the H100: bytes. Each live key and value row is read once
// (2 x kv_len x D x 2 bytes per head in bf16); the arithmetic is 4 G D
// FLOP per slot, far below the card's operations-to-bytes ratio.
#include <math.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load4;

constexpr int kTK = 64;          // slots per tile
constexpr int kThreads = 128;
constexpr int kMaxOut = 32;      // outputs per thread: G * D <= 4096

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_len;
  void* o;
  // element strides: batch, head, row (the dim stride is 1)
  long long q_sb, q_sh, q_sg;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_sg;
  long long l_sb, l_sh;          // kv_len strides (batch, head)
  int hkv, g, sk, d, splits;
  int window;                    // <= 0: no window
  float scale, softcap;          // softcap <= 0: no softcap
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The slots one split reads: [lo, hi) of the head's live range, and
// whether the head has no live slot (then the range is all Smax slots,
// all masked, as the TPU kernel would see them).
__device__ __forceinline__ void split_range(const Params& p, int kv_len,
                                            int split, int* lo, int* hi) {
  int r0 = p.window > 0 ? max(0, kv_len - p.window) : 0;
  int r1 = min(kv_len, p.sk);
  if (r0 >= r1) {
    r0 = 0;
    r1 = p.sk;
  }
  int chunk = (r1 - r0 + p.splits - 1) / p.splits;
  chunk = (chunk + kTK - 1) / kTK * kTK;
  *lo = min(r1, r0 + split * chunk);
  *hi = min(r1, *lo + chunk);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(Params p, float* part_acc, float* part_ml) {
  extern __shared__ float4 smem4[];
  const int d = p.d;
  const int g = p.g;
  float* qs = reinterpret_cast<float*>(smem4);   // [G][D], scaled
  float* ks = qs + g * d;                        // [64][D + 1]
  float* vs = ks + kTK * (d + 1);                // [64][D]
  float* ss = vs + kTK * d;                      // [G][64]
  float* row_m = ss + g * kTK;                   // [G]
  float* row_l = row_m + g;                      // [G]
  float* row_c = row_l + g;                      // [G] correction

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.hkv;
  const int h = bh % p.hkv;
  const int tid = threadIdx.x;
  const int kv_len = p.kv_len[b * p.l_sb + h * p.l_sh];
  int lo, hi;
  split_range(p, kv_len, split, &lo, &hi);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int d4 = d / 4;
  for (int c = tid; c < g * d4; c += kThreads) {
    const int r = c / d4;
    const int e = (c % d4) * 4;
    const float4 x = load4(qg + r * p.q_sg + e);
    qs[r * d + e + 0] = x.x * p.scale;
    qs[r * d + e + 1] = x.y * p.scale;
    qs[r * d + e + 2] = x.z * p.scale;
    qs[r * d + e + 3] = x.w * p.scale;
  }
  for (int r = tid; r < g; r += kThreads) {
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }
  const int n_out = g * d;
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int k0 = lo; k0 < hi; k0 += kTK) {
    const int rows = min(kTK, hi - k0);
    __syncthreads();   // previous tile consumed; q and row stats written
    for (int c = tid; c < kTK * d4; c += kThreads) {
      const int r = c / d4;
      const int e = (c % d4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = x;
      if (r < rows) {
        x = load4(kg + (k0 + r) * p.k_ss + e);
        y = load4(vg + (k0 + r) * p.v_ss + e);
      }
      float* kr = ks + r * (d + 1) + e;
      kr[0] = x.x;
      kr[1] = x.y;
      kr[2] = x.z;
      kr[3] = x.w;
      float* vr = vs + r * d + e;
      vr[0] = y.x;
      vr[1] = y.y;
      vr[2] = y.z;
      vr[3] = y.w;
    }
    __syncthreads();
    // scores of (row, slot) pairs; a warp takes 32 slots of one row
    for (int c = tid; c < g * kTK; c += kThreads) {
      const int r = c / kTK;
      const int j = c % kTK;
      const int k_pos = k0 + j;
      float x;
      if (j >= rows) {
        x = -INFINITY;               // past the split: not a slot at all
      } else {
        const float* qr = qs + r * d;
        const float* kr = ks + j * (d + 1);
        x = 0.f;
        for (int e = 0; e < d; ++e) x = fmaf(qr[e], kr[e], x);
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const bool ok = k_pos < kv_len
            && (p.window <= 0 || k_pos > kv_len - 1 - p.window);
        if (!ok) x = kNegInf;
      }
      ss[r * kTK + j] = x;
    }
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < g; r += kThreads / 32) {
      const float a = ss[r * kTK + lane];
      const float c2 = ss[r * kTK + lane + 32];
      float mx = fmaxf(a, c2);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new);
      const float pc = expf(c2 - m_new);
      ss[r * kTK + lane] = pa;
      ss[r * kTK + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o >= n_out) break;
      const int r = o / d;
      const int e = o % d;
      const float* pr = ss + r * kTK;
      float a = acc[j] * row_c[r];
      for (int kk = 0; kk < rows; ++kk) a = fmaf(pr[kk], vs[kk * d + e], a);
      acc[j] = a;
    }
  }
  __syncthreads();
  const long long part = static_cast<long long>(bh) * p.splits + split;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o >= n_out) break;
    part_acc[part * n_out + o] = acc[j];
  }
  for (int r = tid; r < g; r += kThreads) {
    // an empty split contributes nothing, even where every score is NEG_INF
    part_ml[(part * g + r) * 2 + 0] = lo < hi ? row_m[r] : -INFINITY;
    part_ml[(part * g + r) * 2 + 1] = row_l[r];
  }
}

template <typename T>
__global__ void decode_combine_kernel(Params p, const float* part_acc,
                                      const float* part_ml) {
  const int bh = blockIdx.x;
  const int b = bh / p.hkv;
  const int h = bh % p.hkv;
  const int n_out = p.g * p.d;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int r = o / p.d;
    const int e = o % p.d;
    const long long base = static_cast<long long>(bh) * p.splits;
    float mx = -INFINITY;
    for (int s = 0; s < p.splits; ++s)
      mx = fmaxf(mx, part_ml[((base + s) * p.g + r) * 2]);
    float num = 0.f;
    float den = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float w = expf(part_ml[((base + s) * p.g + r) * 2] - mx);
      num = fmaf(part_acc[(base + s) * n_out + o], w, num);
      den = fmaf(part_ml[((base + s) * p.g + r) * 2 + 1], w, den);
    }
    store1(og + r * p.o_sg + e, num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const Params& p, int batch, float* part_acc, float* part_ml,
           cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(p.g) * p.d
                       + static_cast<size_t>(kTK) * (p.d + 1)
                       + static_cast<size_t>(kTK) * p.d
                       + static_cast<size_t>(p.g) * kTK + 3 * p.g)
                      * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      decode_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  decode_partial_kernel<T><<<dim3(p.splits, batch * p.hkv), kThreads, smem,
                             st>>>(p, part_acc, part_ml);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  decode_combine_kernel<T><<<batch * p.hkv, 256, 0, st>>>(p, part_acc,
                                                         part_ml);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hkv, G, D], k/v [B, Hkv, Smax, D], o [B, Hkv, G, D] through element
// strides (14 values: q, k, v, o each batch / head / row, then kv_len's
// batch / head strides; the dim stride is 1); kv_len int32. Scratch:
// part_acc B*Hkv*splits*G*D floats, part_ml B*Hkv*splits*G*2 floats.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* o, void* part_acc, void* part_ml,
                                      const long long* strides, int batch,
                                      int hkv, int g, int sk, int d,
                                      int splits, int dtype, int window,
                                      float scale, float softcap, int device,
                                      void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (batch == 0 || hkv == 0 || g == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sg = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_sg = strides[11];
  p.l_sb = strides[12]; p.l_sh = strides[13];
  p.hkv = hkv;
  p.g = g;
  p.sk = sk;
  p.d = d;
  p.splits = splits;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  return dtype == 1 ? launch<__nv_bfloat16>(p, batch, pa, pm, st)
                    : launch<float>(p, batch, pa, pm, st);
}
