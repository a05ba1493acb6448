// Flash-attention backward: dQ, dK and dV of the forward in
// flash_attention.cu (causal masking, a sliding window, logit softcap and
// grouped-query heads), given dO and the forward's output O.
//
// The JAX package has no Pallas kernel for this: its train step takes
// jax.value_and_grad through the dense/chunked attention of
// src/repro/models/attention.py, and XLA differentiates it. This kernel
// computes the same gradient by the flash recurrences:
//
//   S = scale Q K^T (softcapped: cap tanh(S/cap)), masked to NEG_INF
//   P = exp(S - L)           L the row's log-sum-exp over its live keys
//   D = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D) o (1 - tanh^2)
//   dQ = scale dS K,  dK = scale dS^T Q
//
// A row with no live key (a window that ends before the first key) gets the
// forward's mean of V over all Sk keys: its P is 1/Sk on every key and its
// dS is 0 (the output does not depend on its scores), so it adds dO/Sk to
// every dV row and nothing to dQ or dK.
//
// Two kernels, launched one after the other on the stream; no float
// atomics, so the result has the same bits from launch to launch:
//
// bwd_dq: one CTA owns (batch, query head, BR query rows). It computes D
//   from O and dO, makes a first pass over the live key tiles for the
//   rows' online max and sum (L; the forward is not asked for it, so the
//   serve path's forward stays as it is), then a second pass that
//   recomputes P, dP and dS and accumulates dQ in registers. It writes
//   L and D to float32 scratch [B][Hq][Sq] for the second kernel.
// bwd_dkdv: one CTA owns (batch, kv head, BR keys). It loops over the g
//   query heads that read the kv head and over every query tile that sees
//   a key of its tile (or has no live key at all), recomputes P and dS
//   from L and D, and accumulates dK and dV in registers; each is written
//   once. This is GQA's sum over the g heads without a reduction pass.
//
// Both run on the FP32 cores for bf16 and float32 inputs alike: tiles are
// staged in shared memory as float32 and every product is a 16 x 16 grid
// of threads, each owning a RM x 4 block of a 64-wide tile (or RM rows x
// DP/16 columns of a DP-wide one), as the forward's float32 kernel does.
// The operand of each product is staged with its reduction dimension
// outermost (K^T [d][key] for Q K^T, P [query][key] for P^T dO, ...), so
// a thread reads RM + 4 consecutive floats per step. Q and dO (dK/dV
// kernel) or K (dQ kernel) are needed both ways round; the buffer is
// refilled row-major from global memory (L2) after the transposed use.
// head_dim 80 runs the 128-wide tiling with the columns past 80 zero.
//
// Bound on the H100: operations. The five products are 10 D FLOP a live
// (query, key) pair; at the training shape of qwen3-1.7b (B*Hq = 64,
// Sq = Sk = 2048, D = 128, causal) about 1.72e11 FLOP, 0.174 ms at the
// bf16 tensor-core peak of 989 TFLOP/s, against about 185 MB moved. This
// kernel does 16 D FLOP a pair (the dQ kernel's two passes of Q K^T, and
// the dK/dV kernel's own S and dP) on FP32 cores (67 TFLOP/s peak): it is
// the simple, exact first kernel and runs far over its bound (PERF.md).
// A wgmma/TMA redesign (bf16 products, the forward emitting L) is the
// later step.
#include <math.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::load4;

constexpr int kThreads = 256;
constexpr int kBC = 64;        // rows of the iterated tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                  // [B][Hq][Sq] scratch
  float* delta;                // [B][Hq][Sq] scratch
  // element strides (batch, head, seq; the dim stride is 1) of q, k, v, o,
  // dout, dq, dk, dv
  long long st[8][3];
  int hq, g, sq, sk;
  int causal, window;          // window <= 0: no window
  float scale, softcap;        // softcap <= 0: no softcap
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ const T* at(const Params& p, int which, int b,
                                       int h, int s) {
  return static_cast<const T*>(which == kQ ? p.q : which == kK ? p.k
                               : which == kV ? p.v : which == kO ? p.o
                               : p.dout)
         + b * p.st[which][0] + h * p.st[which][1] + s * p.st[which][2];
}

// rows x DR elements at src (row stride `ld`) -> dst[d * ROWS + r], times
// `mul`; rows >= `rows` and columns DR..DP zero. Row-fastest mapping: a
// warp writes consecutive rows of one d (no bank conflict).
template <typename T, int DP, int DR, int ROWS>
__device__ __forceinline__ void load_t(float* dst, const T* src,
                                       long long ld, int rows, float mul) {
  for (int c = threadIdx.x; c < ROWS * (DP / 4); c += kThreads) {
    const int r = c % ROWS;
    const int d = (c / ROWS) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < DR) x = load4(src + r * ld + d);
    dst[(d + 0) * ROWS + r] = x.x * mul;
    dst[(d + 1) * ROWS + r] = x.y * mul;
    dst[(d + 2) * ROWS + r] = x.z * mul;
    dst[(d + 3) * ROWS + r] = x.w * mul;
  }
}

// rows x DR elements -> dst[r * DP + d], times `mul`; dim-fastest mapping,
// so the global reads are coalesced.
template <typename T, int DP, int DR, int ROWS>
__device__ __forceinline__ void load_r(float* dst, const T* src,
                                       long long ld, int rows, float mul) {
  for (int c = threadIdx.x; c < ROWS * (DP / 4); c += kThreads) {
    const int r = c / (DP / 4);
    const int d = (c % (DP / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < DR) x = load4(src + r * ld + d);
    store4(dst + r * DP + d,
           make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul));
  }
}

template <int RM>
__device__ __forceinline__ void load_rm(float (&a)[RM], const float* p) {
  if constexpr (RM == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    a[0] = x.x; a[1] = x.y;
  }
}

// acc[i][4t + e] += sum_{x < K} A[x * LDA + r0 + i] * B[x * LDB + 64t + c0 + e]
// for i < RM, t < NT, e < 4: both operands with the reduction outermost.
template <int RM, int NT, int LDA, int LDB, int K>
__device__ __forceinline__ void mm(float (&acc)[RM][4 * NT], const float* A,
                                   const float* B, int r0, int c0) {
#pragma unroll 4
  for (int x = 0; x < K; ++x) {
    float a[RM];
    load_rm<RM>(a, A + x * LDA + r0);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float4 bv = *reinterpret_cast<const float4*>(B + x * LDB + t * 64
                                                         + c0);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][4 * t + 0] = fmaf(a[i], bv.x, acc[i][4 * t + 0]);
        acc[i][4 * t + 1] = fmaf(a[i], bv.y, acc[i][4 * t + 1]);
        acc[i][4 * t + 2] = fmaf(a[i], bv.z, acc[i][4 * t + 2]);
        acc[i][4 * t + 3] = fmaf(a[i], bv.w, acc[i][4 * t + 3]);
      }
    }
  }
}

template <int RM, int N>
__device__ __forceinline__ void zero(float (&acc)[RM][N]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ bool masked(const Params& p, int q_pos,
                                       int k_pos) {
  return (p.causal && k_pos > q_pos)
         || (p.window > 0 && k_pos <= q_pos - p.window);
}

// The first query position with no live key: past Sk - 1 + window (a
// window that ends before the first key); none without a window.
__device__ __forceinline__ long long dead_from(const Params& p) {
  return p.window > 0 ? static_cast<long long>(p.sk) - 1 + p.window
                      : (1ll << 40);
}

// The softcapped score of a raw one and the cap's derivative (1 - tanh^2).
__device__ __forceinline__ float capped(const Params& p, float x, float& f) {
  f = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    f = 1.f - t * t;
    return t * p.softcap;
  }
  return x;
}

// One CTA: BR query rows of one (batch, query head). RM = BR / 16 rows a
// thread.
template <typename T, int DP, int DR, int BR>
__global__ void __launch_bounds__(kThreads)
bwd_dq(Params p) {
  constexpr int RM = BR / 16;
  constexpr int NT = DP / 64;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DP][BR] scaled Q^T
  float* dot = qt + DP * BR;                    // [DP][BR] dO^T
  float* kb = dot + DP * BR;                    // [DP][kBC] K^T / [kBC][DP] K
  float* vt = kb + DP * kBC;                    // [DP][kBC] V^T
  float* dst = vt + DP * kBC;                   // [kBC][BR] dS^T
  float* row_l = dst + kBC * BR;                // [BR] L
  float* row_d = row_l + BR;                    // [BR] D

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest (causal) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.g;
  const int q0 = qtile * BR;
  const int q_rows = min(BR, p.sq - q0);
  const int q_last = q0 + q_rows - 1;
  const long long row0 = (static_cast<long long>(b) * p.hq + h) * p.sq + q0;
  const int tid = threadIdx.x;
  const int ri = tid >> 4;
  const int ci = tid & 15;

  load_t<T, DP, DR, BR>(qt, at<T>(p, kQ, b, h, q0), p.st[kQ][2], q_rows,
                        p.scale);
  load_t<T, DP, DR, BR>(dot, at<T>(p, kDO, b, h, q0), p.st[kDO][2], q_rows,
                        1.f);
  __syncthreads();
  {  // D = rowsum(dO o O): kThreads / BR neighbouring lanes a row
    constexpr int kPer = kThreads / BR;
    const int r = tid / kPer;
    const int part = tid % kPer;
    float s = 0.f;
    if (r < q_rows) {
      const T* og = at<T>(p, kO, b, h, q0 + r);
      for (int d = part * 4; d < DR; d += kPer * 4) {
        const float4 o4 = load4(og + d);
        s += o4.x * dot[(d + 0) * BR + r] + o4.y * dot[(d + 1) * BR + r]
             + o4.z * dot[(d + 2) * BR + r] + o4.w * dot[(d + 3) * BR + r];
      }
    }
#pragma unroll
    for (int off = kPer / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (part == 0) {
      row_d[r] = s;
      if (r < q_rows) p.delta[row0 + r] = s;
    }
  }

  // the live key range of the tile's rows (the forward's, for rows that
  // have a live key; rows with none need no L and get dQ = 0)
  int k_begin = 0;
  int k_end = p.sk;
  if (p.causal) k_end = min(p.sk, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);

  const T* kg = at<T>(p, kK, b, hk, 0);
  const T* vg = at<T>(p, kV, b, hk, 0);

  // pass 1: the rows' running max m and sum l over the live key tiles
  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBC) {
    __syncthreads();
    const int k_rows = min(kBC, p.sk - k0);
    load_t<T, DP, DR, kBC>(kb, kg + k0 * p.st[kK][2], p.st[kK][2], k_rows,
                           1.f);
    __syncthreads();
    float s[RM][4];
    zero(s);
    mm<RM, 1, BR, kBC, DR>(s, qt, kb, ri * RM, ci * 4);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int q_pos = q0 + ri * RM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + ci * 4 + j;
        float f;
        float x = capped(p, s[i][j], f);
        if (k_pos >= p.sk) x = -INFINITY;      // not a key at all
        else if (masked(p, q_pos, k_pos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
  if (ci == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ri * RM + i;
      const float lse = m[i] + logf(fmaxf(l[i], 1e-30f));
      row_l[r] = lse;
      if (r < q_rows) p.lse[row0 + r] = lse;
    }
  }

  // pass 2: dS over the live key tiles, dQ += dS K
  float acc[RM][4 * NT];
  zero(acc);
  for (int k0 = k_begin; k0 < k_end; k0 += kBC) {
    __syncthreads();   // previous tile's dQ product done with kb and dst
    const int k_rows = min(kBC, p.sk - k0);
    load_t<T, DP, DR, kBC>(kb, kg + k0 * p.st[kK][2], p.st[kK][2], k_rows,
                           1.f);
    load_t<T, DP, DR, kBC>(vt, vg + k0 * p.st[kV][2], p.st[kV][2], k_rows,
                           1.f);
    __syncthreads();
    float s[RM][4], dp[RM][4];
    zero(s);
    zero(dp);
    mm<RM, 1, BR, kBC, DR>(s, qt, kb, ri * RM, ci * 4);
    mm<RM, 1, BR, kBC, DR>(dp, dot, vt, ri * RM, ci * 4);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ri * RM + i;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + ci * 4 + j;
        float ds = 0.f;
        if (k_pos < p.sk && r < q_rows && !masked(p, q_pos, k_pos)) {
          float f;
          const float x = capped(p, s[i][j], f);
          ds = expf(x - row_l[r]) * (dp[i][j] - row_d[r]) * f;
        }
        dst[(ci * 4 + j) * BR + r] = ds;
      }
    }
    __syncthreads();   // dst written; everyone done reading kb as K^T
    load_r<T, DP, DR, kBC>(kb, kg + k0 * p.st[kK][2], p.st[kK][2], k_rows,
                           1.f);
    __syncthreads();
    mm<RM, NT, BR, DP, kBC>(acc, dst, kb, ri * RM, ci * 4);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.st[kDQ][0] + h * p.st[kDQ][1]
           + q0 * p.st[kDQ][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ri * RM + i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t * 64 + ci * 4 >= DR) continue;
      store4(dqg + r * p.st[kDQ][2] + t * 64 + ci * 4,
             make_float4(acc[i][4 * t + 0] * p.scale,
                         acc[i][4 * t + 1] * p.scale,
                         acc[i][4 * t + 2] * p.scale,
                         acc[i][4 * t + 3] * p.scale));
    }
  }
}

// One CTA: BR keys of one (batch, kv head), over its g query heads.
template <typename T, int DP, int DR, int BR>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv(Params p) {
  constexpr int RM = BR / 16;
  constexpr int NT = DP / 64;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);  // [DP][BR] K^T
  float* vt = kt + DP * BR;                     // [DP][BR] V^T
  float* xq = vt + DP * BR;                     // [DP][kBC] Q^T / [kBC][DP] Q
  float* xo = xq + DP * kBC;                    // dO^T / dO, the same
  float* ps = xo + DP * kBC;                    // [kBC][BR] P
  float* dss = ps + kBC * BR;                   // [kBC][BR] dS
  float* row_l = dss + kBC * BR;                // [kBC] L
  float* row_d = row_l + kBC;                   // [kBC] D

  const int ktile = blockIdx.x;   // causal: the first keys see the most rows
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = ktile * BR;
  const int k_rows = min(BR, p.sk - k0);
  const int k_last = k0 + k_rows - 1;
  const int tid = threadIdx.x;
  const int ri = tid >> 4;
  const int ci = tid & 15;

  load_t<T, DP, DR, BR>(kt, at<T>(p, kK, b, hk, k0), p.st[kK][2], k_rows,
                        1.f);
  load_t<T, DP, DR, BR>(vt, at<T>(p, kV, b, hk, k0), p.st[kV][2], k_rows,
                        1.f);

  // query rows that see a key of the tile: [q_lo, q_hi]; rows from `dead`
  // on have no live key and add dO / Sk to every dV row
  const long long q_lo = p.causal ? k0 : 0;
  const long long q_hi = p.window > 0
      ? static_cast<long long>(k_last) + p.window - 1 : (1ll << 40);
  const long long dead = dead_from(p);
  const float inv_sk = 1.f / static_cast<float>(p.sk);

  float adk[RM][4 * NT], adv[RM][4 * NT];
  zero(adk);
  zero(adv);
  for (int hh = 0; hh < p.g; ++hh) {
    const int h = hk * p.g + hh;
    const long long rows0 = (static_cast<long long>(b) * p.hq + h) * p.sq;
    const T* qg = at<T>(p, kQ, b, h, 0);
    const T* dog = at<T>(p, kDO, b, h, 0);
    for (int q0 = 0; q0 < p.sq; q0 += kBC) {
      const int q_rows = min(kBC, p.sq - q0);
      const int q_end = q0 + q_rows - 1;
      const bool live = q_end >= q_lo && q0 <= q_hi;
      if (!live && q_end < dead) continue;      // uniform over the CTA
      __syncthreads();   // previous tile's products done with xq/xo/ps/dss
      load_t<T, DP, DR, kBC>(xq, qg + q0 * p.st[kQ][2], p.st[kQ][2], q_rows,
                             p.scale);
      load_t<T, DP, DR, kBC>(xo, dog + q0 * p.st[kDO][2], p.st[kDO][2],
                             q_rows, 1.f);
      if (tid < kBC) {
        row_l[tid] = tid < q_rows ? p.lse[rows0 + q0 + tid] : 0.f;
        row_d[tid] = tid < q_rows ? p.delta[rows0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[RM][4], dp[RM][4];
      zero(s);
      zero(dp);
      mm<RM, 1, BR, kBC, DR>(s, kt, xq, ri * RM, ci * 4);   // S^T
      mm<RM, 1, BR, kBC, DR>(dp, vt, xo, ri * RM, ci * 4);  // dP^T
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int k_pos = k0 + ri * RM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ci * 4 + j;
          const int q_pos = q0 + c;
          float pr = 0.f;
          float ds = 0.f;
          if (k_pos < p.sk && c < q_rows) {
            if (q_pos >= dead) {
              pr = inv_sk;
            } else if (!masked(p, q_pos, k_pos)) {
              float f;
              const float x = capped(p, s[i][j], f);
              pr = expf(x - row_l[c]);
              ds = pr * (dp[i][j] - row_d[c]) * f;
            }
          }
          ps[c * BR + ri * RM + i] = pr;
          dss[c * BR + ri * RM + i] = ds;
        }
      }
      __syncthreads();   // P, dS written; xq/xo read as Q^T/dO^T
      load_r<T, DP, DR, kBC>(xq, qg + q0 * p.st[kQ][2], p.st[kQ][2], q_rows,
                             p.scale);
      load_r<T, DP, DR, kBC>(xo, dog + q0 * p.st[kDO][2], p.st[kDO][2],
                             q_rows, 1.f);
      __syncthreads();
      mm<RM, NT, BR, DP, kBC>(adv, ps, xo, ri * RM, ci * 4);
      mm<RM, NT, BR, DP, kBC>(adk, dss, xq, ri * RM, ci * 4);
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.st[kDK][0] + hk * p.st[kDK][1]
           + k0 * p.st[kDK][2];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[kDV][0] + hk * p.st[kDV][1]
           + k0 * p.st[kDV][2];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ri * RM + i;
    if (r >= k_rows) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 64 + ci * 4;
      if (c >= DR) continue;
      store4(dkg + r * p.st[kDK][2] + c,
             make_float4(adk[i][4 * t + 0], adk[i][4 * t + 1],
                         adk[i][4 * t + 2], adk[i][4 * t + 3]));
      store4(dvg + r * p.st[kDV][2] + c,
             make_float4(adv[i][4 * t + 0], adv[i][4 * t + 1],
                         adv[i][4 * t + 2], adv[i][4 * t + 3]));
    }
  }
}

template <typename T, int DP, int DR>
int launch(const Params& p, int batch, cudaStream_t st) {
  constexpr int BR = DP == 256 ? 32 : 64;
  const size_t dq_smem = (static_cast<size_t>(2 * DP * BR) + 2 * DP * kBC
                          + kBC * BR + 2 * BR) * sizeof(float);
  const size_t kv_smem = (static_cast<size_t>(2 * DP * BR) + 2 * DP * kBC
                          + 2 * kBC * BR + 2 * kBC) * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dq<T, DP, DR, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem)));
  if (!err) err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dkdv<T, DP, DR, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem)));
  if (err) return err;
  // L and D first (bwd_dq writes them), then dK/dV, in stream order
  dim3 gq((p.sq + BR - 1) / BR, p.hq, batch);
  bwd_dq<T, DP, DR, BR><<<gq, kThreads, dq_smem, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 gk((p.sk + BR - 1) / BR, p.hq / p.g, batch);
  bwd_dkdv<T, DP, DR, BR><<<gk, kThreads, kv_smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, int batch, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<T, 64, 64>(p, batch, st);
    case 80: return launch<T, 128, 80>(p, batch, st);
    case 128: return launch<T, 128, 128>(p, batch, st);
    case 256: return launch<T, 256, 256>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/o/dout/dq [B, Hq, Sq, D], k/v/dk/dv [B, Hq/g, Sk, D], each read or
// written through element strides (24 values: q, k, v, o, dout, dq, dk,
// dv, each batch / head / seq; the dim stride is 1). lse and delta:
// float32 scratch of B * Hq * Sq each. dtype: 0 float32, 1 bfloat16
// (strides multiples of 4 elements). window <= 0 and softcap <= 0 switch
// those off. Two launches, one after the other on `stream`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    const long long* strides, int batch, int hq, int g, int sq, int sk,
    int d, int dtype, int causal, int window, float scale, float softcap,
    int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (batch == 0 || hq == 0 || sq == 0 || sk == 0) return 0;  // the wrapper
                                                              // zero-fills
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.hq = hq;
  p.g = g;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, batch, d, st);
  return launch_d<float>(p, batch, d, st);
}
