// Flash-attention forward: online-softmax attention over key tiles, with
// causal masking, a sliding window, logit softcap and grouped-query heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd -> _kernel). The TPU kernel walks a grid
// (B*Hq, Sq/bq, Sk/bk) whose innermost axis runs in order on one core and
// carries (acc, m, l) in VMEM scratch from one key block to the next.
//
// Design. On Hopper the grid runs in no order, so one CTA owns one
// (batch*head, 64-row query tile) and loops over 64-key tiles itself,
// carrying (acc, m, l) in registers: the loop inside the CTA takes the
// place of the TPU's sequential third grid axis. 256 threads; thread
// (ri, ci) = (tid / 16, tid % 16) computes the 4 x 4 scores of query rows
// 4ri..4ri+3 against keys 4ci..4ci+3 of the tile, and owns output rows
// 4ri..4ri+3 at columns {64t + 4ci + e}. The 16 threads of one row group
// are 16 lanes of one warp, so the row max and row sum of the online
// softmax are warp shuffles. Q (scaled) and K are staged transposed in
// shared memory ([D][64], so both operands of the score loop are float4
// reads), V row-major, and the probabilities transposed ([key][row]) for
// the P.V loop. Everything is float32 inside; inputs and output are bf16
// or float32.
//
// Inputs are read through strides in (batch, head, seq, dim) order with a
// unit dim stride, so the model's (B, S, H, D) tensors are read in place:
// no transposed copy of q, k or v is made. Query head h of batch b reads
// key/value head h / g of batch b. Any Sq and Sk (ragged tiles are
// zero-filled and their keys excluded); head_dim 64, 128 or 256.
//
// Masking follows the TPU kernel exactly: masked scores are NEG_INF =
// -2e38 (not -inf), the denominator is max(l, 1e-30). Key tiles wholly
// above the causal diagonal or wholly before the window of every row of
// the CTA are skipped. In the TPU kernel such tiles add junk while the
// running max is still NEG_INF (exp(NEG_INF - NEG_INF) = 1), and the first
// live tile wipes it exactly (corr = exp(NEG_INF - m) = 0), so skipping
// them changes nothing. Skipping is only done when every row of the CTA
// has a live key; a row with none (a window that ends before the first
// key) gets the TPU's mean of V over all Sk keys.
//
// Bound on the H100: operations. At the prefill shape of qwen3-1.7b
// (B*Hq = 128, Sq = Sk = 2048, D = 128, causal) the two products are about
// 1.37e11 FLOP against about 200 MB moved. This simple kernel runs them on
// the FP32 cores from shared memory (4 x 4 register tiles), far from the
// bf16 tensor-core rate that bounds it; wgmma/TMA are later work.
#include <math.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load4;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides: batch, head, seq (the dim stride is 1)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int hq, g, sq, sk;
  int causal, window;          // window <= 0: no window
  float scale, softcap;        // softcap <= 0: no softcap
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// rows x D elements at src (row stride `ld` elements) -> dst[d][row]
// (leading dimension 64), times `mul`; rows >= `rows` are zero. Row-fastest
// mapping: a warp writes 32 consecutive rows of one d (no bank conflict).
template <typename T, int D>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long ld, int rows,
                                                float mul) {
  for (int c = threadIdx.x; c < 64 * (D / 4); c += kThreads) {
    const int r = c % 64;
    const int d = (c / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(src + r * ld + d);
    dst[(d + 0) * 64 + r] = x.x * mul;
    dst[(d + 1) * 64 + r] = x.y * mul;
    dst[(d + 2) * 64 + r] = x.z * mul;
    dst[(d + 3) * 64 + r] = x.w * mul;
  }
}

// rows x D elements -> dst[row][d] (leading dimension D); dim-fastest
// mapping, so the global reads are coalesced.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ld, int rows) {
  for (int c = threadIdx.x; c < 64 * (D / 4); c += kThreads) {
    const int r = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) x = load4(src + r * ld + d);
    store4(dst + r * D + d, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][64], scaled
  float* kt = qt + D * kBQ;                      // [D][64]
  float* vs = kt + D * kBK;                      // [64][D]
  float* pt = vs + kBK * D;                      // [64 keys][64 rows]
  constexpr int kCols = D / 64;                  // float4 column groups

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest (causal) first
  const int bh = blockIdx.y;
  const int b = bh / p.hq;
  const int h = bh % p.hq;
  const int hk = h / p.g;
  const int q0 = qtile * kBQ;
  const int q_rows = min(kBQ, p.sq - q0);
  const int q_last = q0 + q_rows - 1;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
                + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  const int tid = threadIdx.x;
  const int ri = tid >> 4;
  const int ci = tid & 15;

  load_transposed<T, D>(qt, qg, p.q_ss, q_rows, p.scale);

  // key range: skip tiles no row of the CTA can see (see the header)
  int k_begin = 0;
  int k_end = p.sk;
  const bool every_row_live =
      p.window <= 0 || q_last - p.window + 1 <= p.sk - 1;
  if (every_row_live) {
    if (p.causal) k_end = min(p.sk, q_last + 1);
    if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  }

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();   // previous tile's P.V done with kt/vs/pt
    const int k_rows = min(kBK, p.sk - k0);
    load_transposed<T, D>(kt, kg + k0 * p.k_ss, p.k_ss, k_rows, 1.f);
    load_rows<T, D>(vs, vg + k0 * p.v_ss, p.v_ss, k_rows);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + ri * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kBK + ci * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ri * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + ci * 4 + j;
        float x = s[i][j];
        if (k_pos >= p.sk) {
          x = -INFINITY;              // ragged tile: not a key at all
        } else {
          if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
          if ((p.causal && k_pos > q_pos)
              || (p.window > 0 && k_pos <= q_pos - p.window))
            x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(pt + (ci * 4 + j) * kBQ + ri * 4,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= corr[i];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(pt + kk * kBQ
                                                         + ri * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + kk * D + t * 64 + ci * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][t * 4 + 0] = fmaf(pv[i], vv.x, acc[i][t * 4 + 0]);
          acc[i][t * 4 + 1] = fmaf(pv[i], vv.y, acc[i][t * 4 + 1]);
          acc[i][t * 4 + 2] = fmaf(pv[i], vv.z, acc[i][t * 4 + 2]);
          acc[i][t * 4 + 3] = fmaf(pv[i], vv.w, acc[i][t * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ri * 4 + i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < kCols; ++t)
      store4(og + r * p.o_ss + t * 64 + ci * 4,
             make_float4(acc[i][t * 4 + 0] * inv, acc[i][t * 4 + 1] * inv,
                         acc[i][t * 4 + 2] * inv, acc[i][t * 4 + 3] * inv));
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(3 * kBQ) * D + kBK * kBQ)
                      * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const Params& p, int batch, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64>(p, batch, st);
    case 128: return launch<T, 128>(p, batch, st);
    case 256: return launch<T, 256>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hq/g, Sk, D], o [B, Hq, Sq, D], all read and
// written through element strides (12 values: q, k, v, o, each batch /
// head / seq; the dim stride is 1). dtype: 0 float32, 1 bfloat16 (all four
// tensors). window <= 0 and softcap <= 0 switch those off.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int batch,
                                     int hq, int g, int sq, int sk, int d,
                                     int dtype, int causal, int window,
                                     float scale, float softcap, int device,
                                     void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (batch == 0 || hq == 0 || sq == 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.hq = hq;
  p.g = g;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch_dim<__nv_bfloat16>(p, batch, d, st)
                    : dispatch_dim<float>(p, batch, d, st);
}
