// Flash-attention backward: dQ, dK and dV of the forward in
// flash_attention.cu (causal masking, a sliding window, logit softcap and
// grouped-query heads), given dO, the forward's output O and each row's
// log-sum-exp L, which the forward stores for it.
//
// What it replaces: the JAX package has no Pallas kernel for this. Its
// train step takes jax.value_and_grad through the dense/chunked attention
// of src/repro/models/attention.py and XLA differentiates it. These
// kernels compute the same gradient by the flash recurrences:
//
//   S = scale Q K^T (softcapped: cap tanh(S/cap)), masked to NEG_INF
//   P = exp(S - L)           L the row's log-sum-exp, from the forward
//   D = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D) o (1 - tanh^2)
//   dQ = scale dS K,  dK = scale dS^T Q
//
// A row with no live key (a window that ends before the first key) gets the
// forward's mean of V over all Sk keys: its P is 1/Sk on every key and its
// dS is 0 (the output does not depend on its scores), so it adds dO/Sk to
// every dV row and nothing to dQ or dK. Its L (the forward stores NEG_INF
// there) is not read.
//
// Two launches, one after the other on the stream, and no float atomics,
// so every launch gives the same bits: a dQ kernel, one CTA per (batch,
// query head, query tile), which also writes D for the second; and a
// dK/dV kernel, one CTA per (batch, kv head, key tile), which loops over
// the g query heads of its kv head and over every query tile that sees a
// key of its tile (or has no live key at all), so GQA's sum over the g
// heads stays in registers and dK and dV are written once.
//
// Dispatch, by dtype (none of it a fallback):
//
// bf16, every head_dim (64, 80, 128: qwen3, llama3, granite, qwen2-vl,
// hubert; 256: gemma2-9b, gemma3-12b): bwd_dq_tc and bwd_dkdv_tc, on the
// tensor cores. Both are the forward's shape: two consumer warpgroups, and
// a producer warpgroup that gives its registers to them (setmaxnreg: 24
// and 240 a thread, 64,512 of the register file's 65,536, as 168 a thread
// for 384 threads at launch; ptxas reports no spill) and of which one
// lane issues every TMA copy into a two-stage ring of tiles with
// mbarriers (hopper.cuh, shared with the forward). The products are the
// forward's two wgmma forms: both operands K-major in shared memory (S =
// Q K^T), or A from registers (P or dS rounded to bf16: the accumulator
// fragment is the A fragment) and B read through the descriptor's
// transpose bit (as the forward's P V reads V [keys][D]). The tiling's
// key counts are Tiling<D>'s.
//   bwd_dq_tc: 128 query rows, 64 a warpgroup. Q and dO are read once by
//   TMA; K and V stream through the ring in tiles of 64 keys (32 at D =
//   256, so that Q and dO, 128 KB, and two stages of K and V, 64 KB, fit
//   in shared memory). Per tile: S = Q K^T and dP = dO V^T (shared x
//   shared), P and dS in registers, dQ += dS K (K through the transpose
//   bit): 3 products. Registers a consumer thread: dQ D/2, S and dP one
//   per two keys of the tile each, dS one per four (168 at D = 256).
//   bwd_dkdv_tc: 128 keys, 64 a warpgroup, K and V read once. Q, dO and
//   the rows' (L log2 e, D) pairs, which bwd_dq_tc writes to float32
//   scratch [B][Hq][Sq rounded up to 128], stream through the ring in tiles
//   of 64 query rows. Per tile: S^T = K Q^T and dP^T = V dO^T, P^T and
//   dS^T in registers, dV += P^T dO and dK += dS^T Q (dO and Q through the
//   transpose bit): 4 products. Registers a consumer thread: dK and dV D/2
//   each (128 at D = 128), S^T and dP^T 32 each, P^T and dS^T 16 each.
//   At D = 256 the dK and dV of 64 keys would take 256 registers a thread,
//   past the 240 that setmaxnreg gives, so there a CTA owns 64 keys and
//   its two warpgroups split dK's and dV's columns: warpgroup w keeps
//   columns [128 w, 128 w + 128), 64 + 64 registers as at D = 128. Both
//   need P^T and dS^T of all 64 keys; rather than compute both products
//   twice, warpgroup 0 computes S^T and warpgroup 1 dP^T, 1 hands dP^T to
//   0 through 16 KB of shared memory under a named barrier, 0 forms P^T
//   and dS^T and hands their bf16 fragments back the same way. Then each
//   does dV[:, own] += P^T dO[:, own] and dK[:, own] += dS^T Q[:, own],
//   reading its two 64-column blocks of the tiles. Shared memory: K and V
//   64 KB, two stages of Q and dO 128 KB, the exchange 16 KB. (Both
//   forming P^T and dS^T, each product handed both ways under two
//   barriers a tile, was slower: the two warpgroups then run their
//   elementwise passes in step and the tensor cores wait.)
//   A warpgroup whose rows (or keys) see none of a tile skips its products;
//   one whose tile is partly masked, ragged (Sq, Sk) or holds rows with no
//   live key takes the masked path. Ragged tiles read zeros (TMA out of
//   bounds). head_dim 80 runs the 128 tiling: the maps' inner dimension is
//   80 and the boxes past it read zeros, S and dP take 5 of 8 steps of 16.
// float32, every head_dim: bwd_dq and bwd_dkdv below, on the FP32 cores.
//   A tensor-core product in float32 runs in TF32 (about three decimal
//   digits), which is not the float32 contract. They stage tiles in
//   shared memory as float32; every product is a 16 x 16 grid of threads,
//   each owning a RM x 4 block of a 64-wide tile (or RM rows x DP/16
//   columns of a DP-wide one), as the forward's float32 kernel does, with
//   the reduction dimension outermost.
//
// Bound on the H100: operations. The five products (S, dP, dV, dQ, dK)
// are 10 D FLOP a live (query, key) pair; at the training shape of
// qwen3-1.7b (B*Hq = 64, Sq = Sk = 2048, D = 128, g = 2, causal) about
// 1.72e11 FLOP, 0.174 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// against about 200 MB moved (0.06 ms at 3.35 TB/s); at gemma2-9b's (B*Hq
// = 64, S = 2048, D = 256, causal) 3.44e11 FLOP, 0.348 ms. The tensor-core
// kernels do 14 D FLOP a live pair (plus the masked halves of diagonal
// tiles): S and dP are computed in both kernels. That is the price of dQ
// without atomics: the dK/dV kernel owns a key tile and sees every query
// row of it, so it could add dS K into dQ only through a float atomic (or
// a per-key-tile copy of dQ and a reduction pass), which would give other
// bits from launch to launch; the dQ kernel instead owns its query rows
// and recomputes their S and dP. At D = 256 the dK/dV kernel's exchange
// keeps it at 14 D (computing S^T and dP^T in both warpgroups would be
// 18 D).
#include <math.h>

#include "hopper.cuh"

namespace {

using repro::kNegInf;
using repro::load4;

// element strides (batch, head, seq) of the eight tensors, in this order
enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

// ---------------------------------------------------------------------------
// float32: the FP32-core kernels
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kThreads = 256;
constexpr int kBC = 64;        // rows of the iterated tile

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  const float* lse;            // [B][Hq][Sq], the forward's
  float* delta;                // [B][Hq][Sq] scratch
  // element strides (batch, head, seq; the dim stride is 1) of q, k, v, o,
  // dout, dq, dk, dv
  long long st[8][3];
  int hq, g, sq, sk;
  int causal, window;          // window <= 0: no window
  float scale, softcap;        // softcap <= 0: no softcap
};

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ const float* at(const Params& p, int which, int b,
                                           int h, int s) {
  return (which == kQ ? p.q : which == kK ? p.k : which == kV ? p.v
          : which == kO ? p.o : p.dout)
         + b * p.st[which][0] + h * p.st[which][1] + s * p.st[which][2];
}

// rows x DR elements at src (row stride `ld`) -> dst[d * ROWS + r], times
// `mul`; rows >= `rows` and columns DR..DP zero. Row-fastest mapping: a
// warp writes consecutive rows of one d (no bank conflict).
template <int DP, int DR, int ROWS>
__device__ __forceinline__ void load_t(float* dst, const float* src,
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
template <int DP, int DR, int ROWS>
__device__ __forceinline__ void load_r(float* dst, const float* src,
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
template <int DP, int DR, int BR>
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

  load_t<DP, DR, BR>(qt, at(p, kQ, b, h, q0), p.st[kQ][2], q_rows,
                        p.scale);
  load_t<DP, DR, BR>(dot, at(p, kDO, b, h, q0), p.st[kDO][2], q_rows,
                        1.f);
  __syncthreads();
  {  // D = rowsum(dO o O): kThreads / BR neighbouring lanes a row
    constexpr int kPer = kThreads / BR;
    const int r = tid / kPer;
    const int part = tid % kPer;
    float s = 0.f;
    if (r < q_rows) {
      const float* og = at(p, kO, b, h, q0 + r);
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

  if (tid < BR) row_l[tid] = tid < q_rows ? p.lse[row0 + tid] : 0.f;

  // the live key range of the tile's rows (the forward's, for rows that
  // have a live key; rows with none get dQ = 0)
  int k_begin = 0;
  int k_end = p.sk;
  if (p.causal) k_end = min(p.sk, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);

  const float* kg = at(p, kK, b, hk, 0);
  const float* vg = at(p, kV, b, hk, 0);

  // dS over the live key tiles, dQ += dS K
  float acc[RM][4 * NT];
  zero(acc);
  for (int k0 = k_begin; k0 < k_end; k0 += kBC) {
    __syncthreads();   // previous tile's dQ product done with kb and dst
    const int k_rows = min(kBC, p.sk - k0);
    load_t<DP, DR, kBC>(kb, kg + k0 * p.st[kK][2], p.st[kK][2], k_rows,
                           1.f);
    load_t<DP, DR, kBC>(vt, vg + k0 * p.st[kV][2], p.st[kV][2], k_rows,
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
    load_r<DP, DR, kBC>(kb, kg + k0 * p.st[kK][2], p.st[kK][2], k_rows,
                           1.f);
    __syncthreads();
    mm<RM, NT, BR, DP, kBC>(acc, dst, kb, ri * RM, ci * 4);
  }

  float* dqg = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1]
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
template <int DP, int DR, int BR>
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

  load_t<DP, DR, BR>(kt, at(p, kK, b, hk, k0), p.st[kK][2], k_rows,
                        1.f);
  load_t<DP, DR, BR>(vt, at(p, kV, b, hk, k0), p.st[kV][2], k_rows,
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
    const float* qg = at(p, kQ, b, h, 0);
    const float* dog = at(p, kDO, b, h, 0);
    for (int q0 = 0; q0 < p.sq; q0 += kBC) {
      const int q_rows = min(kBC, p.sq - q0);
      const int q_end = q0 + q_rows - 1;
      const bool live = q_end >= q_lo && q0 <= q_hi;
      if (!live && q_end < dead) continue;      // uniform over the CTA
      __syncthreads();   // previous tile's products done with xq/xo/ps/dss
      load_t<DP, DR, kBC>(xq, qg + q0 * p.st[kQ][2], p.st[kQ][2], q_rows,
                             p.scale);
      load_t<DP, DR, kBC>(xo, dog + q0 * p.st[kDO][2], p.st[kDO][2],
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
      load_r<DP, DR, kBC>(xq, qg + q0 * p.st[kQ][2], p.st[kQ][2], q_rows,
                             p.scale);
      load_r<DP, DR, kBC>(xo, dog + q0 * p.st[kDO][2], p.st[kDO][2],
                             q_rows, 1.f);
      __syncthreads();
      mm<RM, NT, BR, DP, kBC>(adv, ps, xo, ri * RM, ci * 4);
      mm<RM, NT, BR, DP, kBC>(adk, dss, xq, ri * RM, ci * 4);
    }
  }

  float* dkg = p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1]
           + k0 * p.st[kDK][2];
  float* dvg = p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1]
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

template <int DP, int DR>
int launch(const Params& p, int batch, cudaStream_t st) {
  constexpr int BR = DP == 256 ? 32 : 64;
  const size_t dq_smem = (static_cast<size_t>(2 * DP * BR) + 2 * DP * kBC
                          + kBC * BR + 2 * BR) * sizeof(float);
  const size_t kv_smem = (static_cast<size_t>(2 * DP * BR) + 2 * DP * kBC
                          + 2 * kBC * BR + 2 * kBC) * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dq<DP, DR, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem)));
  if (!err) err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dkdv<DP, DR, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_smem)));
  if (err) return err;
  // D first (bwd_dq writes it), then dK/dV, in stream order
  dim3 gq((p.sq + BR - 1) / BR, p.hq, batch);
  bwd_dq<DP, DR, BR><<<gq, kThreads, dq_smem, st>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 gk((p.sk + BR - 1) / BR, p.hq / p.g, batch);
  bwd_dkdv<DP, DR, BR><<<gk, kThreads, kv_smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// float32 at every head_dim
int launch_d(const Params& p, int batch, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<64, 64>(p, batch, st);
    case 80: return launch<128, 80>(p, batch, st);
    case 128: return launch<128, 128>(p, batch, st);
    case 256: return launch<256, 256>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (wgmma, TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kThreads = kConsumers + 128;      // + the producer warpgroup
constexpr int kBox = 64;                        // Q's and dO's box rows
constexpr int kDqRows = 128;                    // bwd_dq_tc: query rows
constexpr int kKvRows = 64;                     // bwd_dkdv_tc's query tiles

// The key counts of the tiling at head width D. bwd_dq_tc streams K and V
// in tiles of kDqKeys (also the K and V maps' box rows); a bwd_dkdv_tc CTA
// owns kKvKeys keys, 64 a warpgroup, or at D = 256 (kSplit) all 64 in
// both warpgroups, each keeping half of dK's and dV's columns.
template <int D>
struct Tiling {
  static constexpr bool kSplit = D == 256;
  static constexpr int kDqKeys = kSplit ? 32 : 64;
  static constexpr int kKvKeys = kSplit ? 64 : 128;
};

// the producer lane's loop fits in 24 registers; 240 a consumer thread
// hold bwd_dkdv_tc's dK, dV, S^T, dP^T, P^T and dS^T without a spill
// (232 spilled 8 bytes at D = 128)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536,
              "register file");

struct Params {
  CUtensorMap q, k, v, dout;          // (D, S, H, B) views: Q and dO in
                                      // boxes of kBox rows, K and V of
                                      // kDqKeys
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout_ptr;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* lse;                   // [B][Hq][Sq], the forward's
  float2* rows;                       // [B][Hq][sq_pad]: (L log2 e, D)
  long long st[8][3];                 // element strides, kQ..kDV order
  int hq, g, sq, sk, sq_pad;
  int causal, window;                 // window <= 0: no window
  float scale, softcap;               // softcap <= 0: no softcap
};

// Shared memory of bwd_dq_tc, from a 1024-byte aligned base: Q and dO
// [D/64][128][64], then per stage K and V [D/64][kDqKeys][64], then the
// mbarriers (full_fix, full_a[2], full_b[2], empty[2]).
template <int D>
struct DqLayout {
  static constexpr int kFix = kDqRows * D * 2;
  static constexpr int kTile = Tiling<D>::kDqKeys * D * 2;
  static constexpr int kBars = 2 * kFix + 2 * kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// bwd_dkdv_tc: K and V [D/64][kKvKeys][64], per stage Q and dO
// [D/64][64][64], per stage the 64 rows' (L log2 e, D) pairs, then the
// mbarriers.
template <int D>
struct KvLayout {
  static constexpr int kFix = Tiling<D>::kKvKeys * D * 2;
  static constexpr int kTile = kKvRows * D * 2;
  static constexpr int kRows = kKvRows * 8;
  static constexpr int kRowsAt = 2 * kFix + 2 * kStages * kTile;
  // at D = 256 (kSplit) the warpgroups' exchange: 32 words a consumer
  // thread of one warpgroup
  static constexpr int kXchAt = kRowsAt + kStages * kRows;
  static constexpr int kBars = kXchAt + (Tiling<D>::kSplit ? 128 * 32 * 4
                                                           : 0);
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

// a block's dynamic shared memory on the H100: 227 KB
static_assert(DqLayout<256>::kBytes <= 232448 && KvLayout<256>::kBytes
              <= 232448, "shared memory at head_dim 256");

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 v = __bfloat1622float2(y[i]);
    s += u.x * v.x + u.y * v.y;
  }
  return s;
}

// A score of the accumulator in log2 units and the softcap's derivative
// (1 - tanh^2; 1 without a softcap).
template <bool kCap>
__device__ __forceinline__ float score2(const Params& p, float raw,
                                        float& f) {
  if (kCap) {
    const float th = tanhf(raw * (p.scale / p.softcap));
    f = 1.f - th * th;
    return th * (p.softcap * kLog2e);
  }
  f = 1.f;
  return raw * (p.scale * kLog2e);
}

__device__ __forceinline__ bool masked(const Params& p, int qp, int kp) {
  return (p.causal && kp > qp) || (p.window > 0 && kp <= qp - p.window);
}

// dS of one tile of K keys of bwd_dq_tc, rounded to bf16 as the A
// fragments of dS K. sc[4jj + e] is row row0 + 8 (e / 2), key k0 + 8jj +
// col + e % 2.
template <int K, bool kCap, bool kMask>
__device__ __forceinline__ void dq_ds(const Params& p,
                                      const float (&sc)[K / 2],
                                      const float (&dp)[K / 2],
                                      uint32_t (&da)[K / 16][4],
                                      const float (&l2)[2],
                                      const float (&dd)[2], int k0, int row0,
                                      int col) {
#pragma unroll
  for (int i = 0; i < K / 2; i += 2) {
    const int r = (i % 4) / 2;
    float ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float f;
      const float x = score2<kCap>(p, sc[i + e], f);
      ds[e] = ex2(x - l2[r]) * (dp[i + e] - dd[r]) * f;
      if (kMask) {
        const int kp = k0 + 8 * (i / 4) + col + e;
        if (kp >= p.sk || masked(p, row0 + 8 * r, kp)) ds[e] = 0.f;
      }
    }
    da[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
  }
}

// A consumer warpgroup of bwd_dq_tc: query rows q0 + 64 wg .. + 63.
template <int D, int DR>
__device__ __forceinline__ void dq_consume(const Params& p, const Ring& r,
                                           int b, int h, int q0, int k_begin,
                                           int n_tiles) {
  using L = DqLayout<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wf = q0 + 64 * wg;                 // the warpgroup's rows
  const int wl = wf + 63;
  const int row0 = wf + 16 * warp + lane / 4;  // and row0 + 8
  const int col = 2 * (lane % 4);
  const long long bh = static_cast<long long>(b) * p.hq + h;

  // D = rowsum(dO o O) of this lane's two rows (the quad's lanes split the
  // columns in 16-byte chunks) and L from the forward, in log2 units;
  // stored as the rows' pairs for bwd_dkdv_tc (rows past Sq: zeros)
  float l2[2], dd[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qp = row0 + 8 * x;
    float s = 0.f;
    float lse = 0.f;
    if (qp < p.sq) {
      const __nv_bfloat16* orow = p.o + b * p.st[kO][0] + h * p.st[kO][1]
                                  + qp * p.st[kO][2];
      const __nv_bfloat16* drow = p.dout_ptr + b * p.st[kDO][0]
                                  + h * p.st[kDO][1] + qp * p.st[kDO][2];
      for (int c = lane % 4; c < DR / 8; c += 4)
        s += dot8(*reinterpret_cast<const uint4*>(orow + 8 * c),
                  *reinterpret_cast<const uint4*>(drow + 8 * c));
      lse = p.lse[bh * p.sq + qp];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dd[x] = s;
    l2[x] = lse * kLog2e;
    if (lane % 4 == 0) p.rows[bh * p.sq_pad + qp] = make_float2(l2[x], s);
  }

  constexpr int K = Tiling<D>::kDqKeys;
  const uint32_t s_q = r.s_fix + 64 * wg * kRowBytes;
  const uint32_t s_do = s_q + L::kFix;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[K / 2], dp[K / 2];
  uint32_t da[K / 16][4];

  mbar_wait(r.full_fix, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t s_k = r.s_ring + s * 2 * L::kTile;
    const uint32_t s_v = s_k + L::kTile;
    const int k0 = k_begin + j * K;
    mbar_wait(r.full_a + 8 * s, parity);
    mbar_wait(r.full_b + 8 * s, parity);
    // skip a tile none of whose keys this warpgroup's rows see
    const bool skip = wf >= p.sq || (p.causal && k0 > wl)
                      || (p.window > 0 && k0 + K - 1 <= wf - p.window);
    if (!skip) {
      // S = Q K^T, dP = dO V^T
#pragma unroll
      for (int i = 0; i < K / 2; ++i) {
        sc[i] = 0.f;
        dp[i] = 0.f;
      }
      wgmma_fence();
      issue_abt<DR, kDqRows>(sc, s_q, s_k);
      issue_abt<DR, kDqRows>(dp, s_do, s_v);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);
      // each branch uniform and around a whole loop
      const bool mask = k0 + K > p.sk || (p.causal && k0 + K - 1 > wf)
                        || (p.window > 0 && k0 <= wl - p.window);
      if (p.softcap > 0.f) {
        if (mask) dq_ds<K, true, true>(p, sc, dp, da, l2, dd, k0, row0, col);
        else dq_ds<K, true, false>(p, sc, dp, da, l2, dd, k0, row0, col);
      } else {
        if (mask) dq_ds<K, false, true>(p, sc, dp, da, l2, dd, k0, row0, col);
        else dq_ds<K, false, false>(p, sc, dp, da, l2, dd, k0, row0, col);
      }
      // dQ += dS K: K [keys][D] through the transpose bit
      wgmma_fence();
      issue_pb<K>(acc, da, s_k);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    }
    mbar_arrive(r.empty + 8 * s);
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int qp = row0 + 8 * x;
    if (qp >= p.sq) continue;
    __nv_bfloat16* out = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1]
                         + qp * p.st[kDQ][2];
#pragma unroll
    for (int jj = 0; jj < DR / 8; ++jj)
      *reinterpret_cast<uint32_t*>(out + 8 * jj + col) =
          pack_bf16(acc[4 * jj + 2 * x] * p.scale,
                    acc[4 * jj + 2 * x + 1] * p.scale);
  }
}

// One CTA: 128 query rows of one (batch, query head). D: the tiling's
// head width (64, 128, 256); DR <= D: the real one, the maps' inner
// dimension.
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_tc(const __grid_constant__ Params p) {
  using L = DqLayout<D>;
  constexpr int K = Tiling<D>::kDqKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;
  const Ring r = make_ring(base, 2 * L::kFix, L::kBars);
  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest (causal) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qtile * kDqRows;
  const int q_last = min(q0 + kDqRows, p.sq) - 1;
  // the keys the rows see (none: a window that ends before the first key)
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_end = p.causal ? min(p.sk, q_last + 1) : p.sk;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + K - 1) / K : 0;

  if (threadIdx.x == 0) init_ring(r, kConsumers);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* fix[2] = {&p.q, &p.dout};
      produce<D, kDqRows, K, kBox, K>(fix, q0, h, b, &p.k, &p.v, h / p.g,
                                      k_begin, n_tiles, r);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    dq_consume<D, DR>(p, r, b, h, q0, k_begin, n_tiles);
  }
}

// The query tiles (of kKvRows) a key tile's CTA visits, the same for each
// of its g heads: [lo, hi], the rows that see one of its keys, then from
// `dead` on, the rows with no live key (their P is 1/Sk on every key).
struct QWalk {
  int lo, hi, dead, n;
};

template <int D>
__device__ __forceinline__ QWalk make_walk(const Params& p, int k0) {
  const int k_last = min(k0 + Tiling<D>::kKvKeys, p.sk) - 1;
  QWalk w;
  w.n = (p.sq + kKvRows - 1) / kKvRows;
  const long long q_lo = p.causal ? k0 : 0;
  long long q_hi = p.sq - 1;
  if (p.window > 0)
    q_hi = min(q_hi, static_cast<long long>(k_last) + p.window - 1);
  w.lo = static_cast<int>(q_lo / kKvRows);
  w.hi = q_lo <= q_hi ? static_cast<int>(q_hi / kKvRows) : -1;
  const long long dead = p.window > 0
      ? static_cast<long long>(p.sk) - 1 + p.window : p.sq;
  w.dead = dead < p.sq ? static_cast<int>(dead / kKvRows) : w.n;
  return w;
}

// The tile after t (t = -1: the first); w.n and past: none left.
__device__ __forceinline__ int next_tile(const QWalk& w, int t) {
  ++t;
  return t <= w.hi ? max(t, w.lo) : max(t, w.dead);
}

// The producer's one lane of bwd_dkdv_tc: K and V once, then for each of
// the g heads and each tile of the walk Q (on full_a), dO and the rows'
// (L log2 e, D) pairs (on full_b).
template <int D>
__device__ __forceinline__ void kv_produce(const Params& p, const Ring& r,
                                           uint32_t s_rows, const QWalk& w,
                                           int k0, int hk, int b) {
  using L = KvLayout<D>;
  using T = Tiling<D>;
  mbar_expect_tx(r.full_fix, 2 * L::kFix);
  load_tile<D, T::kKvKeys, T::kDqKeys>(r.s_fix, &p.k, r.full_fix, k0, hk,
                                       b);
  load_tile<D, T::kKvKeys, T::kDqKeys>(r.s_fix + L::kFix, &p.v, r.full_fix,
                                       k0, hk, b);
  int j = 0;
  for (int hh = 0; hh < p.g; ++hh) {
    const int h = hk * p.g + hh;
    const float2* rows = p.rows + (static_cast<long long>(b) * p.hq + h)
                                  * p.sq_pad;
    for (int t = next_tile(w, -1); t < w.n; t = next_tile(w, t), ++j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(r.empty + 8 * s, (j / kStages - 1) & 1);
      const int q0 = t * kKvRows;
      const uint32_t s_a = r.s_ring + s * 2 * L::kTile;
      mbar_expect_tx(r.full_a + 8 * s, L::kTile);
      load_tile<D, kKvRows, kBox>(s_a, &p.q, r.full_a + 8 * s, q0, h, b);
      mbar_expect_tx(r.full_b + 8 * s, L::kTile + L::kRows);
      load_tile<D, kKvRows, kBox>(s_a + L::kTile, &p.dout, r.full_b + 8 * s,
                                  q0, h, b);
      bulk_load(s_rows + s * L::kRows, rows + q0, L::kRows,
                r.full_b + 8 * s);
    }
  }
}

// P^T and dS^T of one query tile of bwd_dkdv_tc, rounded to bf16 as the A
// fragments of P^T dO and dS^T Q. st[4jj + e] is key kp0 + 8 (e / 2),
// query q0 + 8jj + col + e % 2; rows[c / 2] holds the (L log2 e, D) pairs
// of queries c and c + 1.
template <bool kCap, bool kMask>
__device__ __forceinline__ void kv_pds(const Params& p, const float (&st)[32],
                                       const float (&dpt)[32],
                                       uint32_t (&pa)[4][4],
                                       uint32_t (&da)[4][4],
                                       const float4* rows, int kp0, int q0,
                                       int col, long long dead,
                                       float inv_sk) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = 8 * (i / 4) + col;
    const float4 ld = rows[c / 2];
    const int kp = kp0 + 8 * ((i % 4) / 2);
    float pr[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float f;
      const float x = score2<kCap>(p, st[i + e], f);
      pr[e] = ex2(x - (e ? ld.z : ld.x));
      ds[e] = pr[e] * (dpt[i + e] - (e ? ld.w : ld.y)) * f;
      if (kMask) {
        const int qp = q0 + c + e;
        if (kp >= p.sk || qp >= p.sq) {
          pr[e] = 0.f;
          ds[e] = 0.f;
        } else if (qp >= dead) {       // no live key: the mean of V
          pr[e] = inv_sk;
          ds[e] = 0.f;
        } else if (masked(p, qp, kp)) {
          pr[e] = 0.f;
          ds[e] = 0.f;
        }
      }
    }
    pa[i / 8][(i % 8) / 2] = pack_bf16(pr[0], pr[1]);
    da[i / 8][(i % 8) / 2] = pack_bf16(ds[0], ds[1]);
  }
}

// kv_pds through its softcap and mask branches, each uniform over the
// warpgroup and around a whole loop
__device__ __forceinline__ void kv_pds_any(const Params& p, bool mask,
                                           const float (&st)[32],
                                           const float (&dpt)[32],
                                           uint32_t (&pa)[4][4],
                                           uint32_t (&da)[4][4],
                                           const float4* rows, int kp0,
                                           int q0, int col, long long dead,
                                           float inv_sk) {
  if (p.softcap > 0.f) {
    if (mask) kv_pds<true, true>(p, st, dpt, pa, da, rows, kp0, q0, col,
                                 dead, inv_sk);
    else kv_pds<true, false>(p, st, dpt, pa, da, rows, kp0, q0, col, dead,
                             inv_sk);
  } else {
    if (mask) kv_pds<false, true>(p, st, dpt, pa, da, rows, kp0, q0, col,
                                  dead, inv_sk);
    else kv_pds<false, false>(p, st, dpt, pa, da, rows, kp0, q0, col, dead,
                              inv_sk);
  }
}

// the two consumer warpgroups of a CTA wait for each other (named barrier
// 1; the producer warpgroup takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// A consumer warpgroup of bwd_dkdv_tc: keys k0 + 64 wg .. + 63, all their
// columns of dK and dV; at D = 256 (kSplit) keys k0 .. k0 + 63, columns
// [128 wg, 128 wg + 128). `at`: the CTA's aligned shared memory.
template <int D, int DR>
__device__ __forceinline__ void kv_consume(const Params& p, const Ring& r,
                                           uint8_t* at, const QWalk& w,
                                           int k0, int hk, int b) {
  using L = KvLayout<D>;
  using T = Tiling<D>;
  constexpr int DW = T::kSplit ? D / 2 : D;    // the warpgroup's columns
  constexpr int kCols = T::kSplit ? DW : DR;   // of which real
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int kf = k0 + (T::kSplit ? 0 : 64 * wg);   // the warpgroup's keys
  const int kl = kf + 63;
  const int kp0 = kf + 16 * warp + lane / 4;   // and kp0 + 8
  const int col = 2 * (lane % 4);
  const int c0 = T::kSplit ? DW * wg : 0;      // its first column
  const uint32_t s_k = r.s_fix + (kf - k0) * kRowBytes;
  const uint32_t s_v = s_k + L::kFix;
  // its columns' 64-column blocks of a [D/64][64][64] query tile
  const uint32_t own = c0 / 64 * kKvRows * kRowBytes;
  const long long dead = p.window > 0
      ? static_cast<long long>(p.sk) - 1 + p.window : (1ll << 40);
  const float inv_sk = 1.f / static_cast<float>(p.sk);
  // this thread's exchange slots (kSplit), 128 words apart; the same
  // thread of the other warpgroup uses the same ones
  float* xch = reinterpret_cast<float*>(at + L::kXchAt) + threadIdx.x % 128;
  uint32_t* xchu = reinterpret_cast<uint32_t*>(xch);

  float dk[DW / 2], dv[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];

  mbar_wait(r.full_fix, 0);
  int j = 0;
  for (int hh = 0; hh < p.g; ++hh) {
    for (int t = next_tile(w, -1); t < w.n; t = next_tile(w, t), ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t s_q = r.s_ring + s * 2 * L::kTile;
      const uint32_t s_do = s_q + L::kTile;
      const int q0 = t * kKvRows;
      const int q_end = q0 + kKvRows - 1;
      const bool has_dead = q_end >= dead;
      mbar_wait(r.full_a + 8 * s, parity);
      mbar_wait(r.full_b + 8 * s, parity);
      // skip a tile none of whose rows sees this warpgroup's keys
      const bool skip = !has_dead
          && (kf >= p.sk || (p.causal && q_end < kf)
              || (p.window > 0 && q0 > kl + p.window - 1));
      if (!skip) {
        const float4* rows = reinterpret_cast<const float4*>(
            at + L::kRowsAt + s * L::kRows);
        const bool mask = has_dead || kl >= p.sk || q_end >= p.sq
                          || (p.causal && q0 < kl)
                          || (p.window > 0 && q_end >= kf + p.window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          st[i] = 0.f;
          dpt[i] = 0.f;
        }
        if constexpr (T::kSplit) {
          // both warpgroups hold the same keys: warpgroup 0 computes S^T =
          // K Q^T, warpgroup 1 dP^T = V dO^T and hands it over; 0 forms
          // P^T and dS^T and hands their bf16 fragments back (a thread's
          // fragment is the same in both warpgroups). The first barrier
          // also holds 0's writes of a tile until 1 has read the last's
          wgmma_fence();
          issue_abt<DR, T::kKvKeys>(st, wg ? s_v : s_k, wg ? s_do : s_q);
          wgmma_commit();
          wgmma_wait();
          fence_regs(st);
          if (wg) {
#pragma unroll
            for (int i = 0; i < 32; ++i) xch[128 * i] = st[i];
          }
          consumers_sync();
          if (!wg) {
#pragma unroll
            for (int i = 0; i < 32; ++i) dpt[i] = xch[128 * i];
            kv_pds_any(p, mask, st, dpt, pa, da, rows, kp0, q0, col, dead,
                       inv_sk);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              xchu[128 * i] = pa[i / 4][i % 4];
              xchu[128 * (16 + i)] = da[i / 4][i % 4];
            }
          }
          consumers_sync();
          if (wg) {
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              pa[i / 4][i % 4] = xchu[128 * i];
              da[i / 4][i % 4] = xchu[128 * (16 + i)];
            }
          }
        } else {
          // S^T = K Q^T, dP^T = V dO^T
          wgmma_fence();
          issue_abt<DR, T::kKvKeys>(st, s_k, s_q);
          issue_abt<DR, T::kKvKeys>(dpt, s_v, s_do);
          wgmma_commit();
          wgmma_wait();
          fence_regs(st);
          fence_regs(dpt);
          kv_pds_any(p, mask, st, dpt, pa, da, rows, kp0, q0, col, dead,
                     inv_sk);
        }
        // dV += P^T dO, dK += dS^T Q: dO and Q through the transpose bit
        wgmma_fence();
        issue_pb<kKvRows>(dv, pa, s_do + own);
        issue_pb<kKvRows>(dk, da, s_q + own);
        wgmma_commit();
        wgmma_wait();
        fence_regs(dv);
        fence_regs(dk);
      }
      mbar_arrive(r.empty + 8 * s);
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int kp = kp0 + 8 * x;
    if (kp >= p.sk) continue;
    __nv_bfloat16* dkr = p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1]
                         + kp * p.st[kDK][2] + c0;
    __nv_bfloat16* dvr = p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1]
                         + kp * p.st[kDV][2] + c0;
#pragma unroll
    for (int jj = 0; jj < kCols / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * jj + col) =
          pack_bf16(dk[4 * jj + 2 * x] * p.scale,
                    dk[4 * jj + 2 * x + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + 8 * jj + col) =
          pack_bf16(dv[4 * jj + 2 * x], dv[4 * jj + 2 * x + 1]);
    }
  }
}

// One CTA: kKvKeys keys of one (batch, kv head), over its g query heads.
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_tc(const __grid_constant__ Params p) {
  using L = KvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const Ring r = make_ring(base, 2 * L::kFix, L::kBars);
  // causal: the first keys see most
  const int k0 = blockIdx.x * Tiling<D>::kKvKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const QWalk w = make_walk<D>(p, k0);

  if (threadIdx.x == 0) init_ring(r, kConsumers);
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers)
      kv_produce<D>(p, r, base + L::kRowsAt, w, k0, hk, b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    kv_consume<D, DR>(p, r, smem_raw + (base - raw), w, k0, hk, b);
  }
}

template <int D, int DR = D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq, void* dk, void* dv,
           float* scratch, const long long* st, int batch, int hq, int g,
           int sq, int sk, int causal, int window, float scale,
           float softcap, cudaStream_t stream) {
  using T = Tiling<D>;
  Params p;
  const int hkv = hq / g;
  int err = encode(&p.q, q, DR, sq, hq, batch, st[0], st[1], st[2], kBox);
  if (!err) err = encode(&p.k, k, DR, sk, hkv, batch, st[3], st[4], st[5],
                         T::kDqKeys);
  if (!err) err = encode(&p.v, v, DR, sk, hkv, batch, st[6], st[7], st[8],
                         T::kDqKeys);
  if (!err) err = encode(&p.dout, dout, DR, sq, hq, batch, st[12], st[13],
                         st[14], kBox);
  if (err) return err;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout_ptr = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = lse;
  p.rows = reinterpret_cast<float2*>(scratch);
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = st[3 * t + j];
  p.hq = hq;
  p.g = g;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = (sq + kDqRows - 1) / kDqRows * kDqRows;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dq_tc<D, DR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqLayout<D>::kBytes));
  if (!err) err = static_cast<int>(cudaFuncSetAttribute(
      bwd_dkdv_tc<D, DR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      KvLayout<D>::kBytes));
  if (err) return err;
  // the rows' (L, D) pairs first (bwd_dq_tc writes them), then dK/dV
  dim3 gq((sq + kDqRows - 1) / kDqRows, hq, batch);
  bwd_dq_tc<D, DR><<<gq, kThreads, DqLayout<D>::kBytes, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 gk((sk + T::kKvKeys - 1) / T::kKvKeys, hkv, batch);
  bwd_dkdv_tc<D, DR><<<gk, kThreads, KvLayout<D>::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q/o/dout/dq [B, Hq, Sq, D], k/v/dk/dv [B, Hq/g, Sk, D], each read or
// written through element strides (24 values: q, k, v, o, dout, dq, dk,
// dv, each batch / head / seq; the dim stride is 1). lse: the forward's
// float32 [B][Hq][Sq], contiguous. scratch: float32 of B * Hq * Sq'
// * 2, Sq' = Sq rounded up to 128 (D for the FP32-core kernels; the rows'
// (L log2 e, D) pairs for the tensor-core ones). dtype: 0 float32 (the
// FP32-core kernels), 1 bfloat16 (the tensor-core kernels; strides
// multiples of 8 elements). window <= 0 and softcap <= 0
// switch those off. Two launches, one after the other on `stream`.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, const long long* strides, int batch, int hq, int g,
    int sq, int sk, int d, int dtype, int causal, int window, float scale,
    float softcap, int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (batch == 0 || hq == 0 || sq == 0 || sk == 0) return 0;  // the wrapper
                                                              // zero-fills
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 64: return tc::launch<64>(q, k, v, o, dout, lse, dq, dk, dv,
                                     scratch, strides, batch, hq, g, sq, sk,
                                     causal, window, scale, softcap, st);
      case 80: return tc::launch<128, 80>(q, k, v, o, dout, lse, dq, dk, dv,
                                          scratch, strides, batch, hq, g, sq,
                                          sk, causal, window, scale, softcap,
                                          st);
      case 128: return tc::launch<128>(q, k, v, o, dout, lse, dq, dk, dv,
                                       scratch, strides, batch, hq, g, sq,
                                       sk, causal, window, scale, softcap,
                                       st);
      case 256: return tc::launch<256>(q, k, v, o, dout, lse, dq, dk, dv,
                                       scratch, strides, batch, hq, g, sq,
                                       sk, causal, window, scale, softcap,
                                       st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  f32::Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.lse = lse;
  p.delta = scratch;
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
  return f32::launch_d(p, batch, d, st);
}
