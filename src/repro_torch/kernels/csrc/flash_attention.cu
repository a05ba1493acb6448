// Flash-attention forward: online-softmax attention over key tiles, with
// causal masking, a sliding window, logit softcap and grouped-query heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_bhsd -> _kernel). The TPU kernel walks a grid
// (B*Hq, Sq/bq, Sk/bk) whose innermost axis runs in order on one core and
// carries (acc, m, l) in VMEM scratch from one key block to the next. On
// Hopper the grid runs in no order, so one CTA owns one (batch*head, query
// tile) and loops over key tiles itself, carrying (acc, m, l) in
// registers: the loop inside the CTA takes the place of the TPU's
// sequential third grid axis.
//
// Two kernels, chosen by dtype (a dispatch, not a fallback):
//
// bf16: flash_fwd_tc, on the tensor cores. A CTA is two consumer
// warpgroups of 64 query rows each (128 rows) and one producer warpgroup,
// which hands most of its registers to the consumers (setmaxnreg) and of
// which one lane issues every copy. The producer loads the Q tile once and
// then K and V tiles of BK keys (128; 64 for D = 256, so that Q and two
// stages fit in shared memory) by TMA into a ring of two stages, with
// mbarriers that say when a stage's K and V have arrived and when the
// consumers are done with it; so tile j + 1 is in flight while tile j is
// multiplied. Tiles are 128-byte swizzled rows of 64 bf16 (the TMA box),
// as wgmma reads them.
// Each warpgroup computes S = Q K^T with wgmma (Q and K from shared
// memory, K-major), runs the online softmax on the accumulator fragment (a
// row lives in the 4 lanes of a quad: row max by two shuffles; the row sum
// stays per lane until the end), rounds P to bf16 in registers (the
// accumulator fragment is the A-operand fragment) and computes O += P V
// with wgmma, P from registers and V from shared memory through the
// descriptor's transpose bit (V stays [keys][D] as it lies in memory).
// While one warpgroup runs its softmax, the other's products can run on
// the tensor cores. Rounding P to bf16 is the one rounding the FP32-core
// kernel does not have.
//
// float32: flash_fwd_f32, on the FP32 cores. A tensor-core product in
// float32 would run in TF32 (about three decimal digits), which is not the
// float32 contract of this kernel. One CTA owns 64 query rows; 256 threads;
// thread (ri, ci) = (tid / 16, tid % 16) computes the 4 x 4 scores of
// query rows 4ri..4ri+3 against keys 4ci..4ci+3 of a 64-key tile, and owns
// output rows 4ri..4ri+3 at columns {64t + 4ci + e}. The 16 threads of a
// row group are 16 lanes of one warp, so the row max and row sum are warp
// shuffles. Q (scaled) and K are staged transposed in shared memory, V
// row-major, the probabilities transposed for the P.V loop.
//
// Inputs are read through strides in (batch, head, seq, dim) order with a
// unit dim stride, so the model's (B, S, H, D) tensors are read in place:
// no transposed copy of q, k or v is made (the bf16 kernel's TMA maps
// describe the strided (D, S, H, B) view; bf16 strides must be multiples
// of 8 elements, 16 bytes). Query head h of batch b reads key/value head
// h / g of batch b. Any Sq and Sk: ragged tiles are zero-filled (by TMA
// out of bounds, or by the loads) and their keys excluded with -inf;
// head_dim 64, 80, 128 or 256.
//
// head_dim 80 (hubert-xlarge) runs the head_dim-128 tiling with the
// columns past 80 zero, as the TPU kernel pads 64/80-dim heads to 128.
// Nothing is copied to pad: in the bf16 kernel the TMA maps describe the
// 80 real columns and the second 64-column box of each row reads past
// them, which TMA fills with zeros in shared memory; S = Q K^T takes the
// first five 16-column steps only, P V runs over all 128 columns of the
// zero-padded V and the store writes the first 80. The float32 kernel
// loads the 80 columns and leaves the rest zero in the same way. The
// softmax scale is the caller's (80^-1/2 by default), not the padded
// width's.
//
// For the backward (flash_attention_bwd.cu) both kernels can also store
// each row's log-sum-exp L = ln sum_k exp(s_k) of the scaled, softcapped,
// masked scores, float32 [B][Hq][Sq], from the running max and row sum
// they hold at the end anyway (the bf16 kernel in log2 units: L = (m +
// log2 l) / log2 e). A row with no live key stores NEG_INF, which is
// what the plain version's logsumexp of NEG_INF scores rounds to; the
// backward does not read it there. Storing L or not (a null pointer: the
// serve path) leaves O's bits as they are.
//
// The tensor-core building blocks (mbarriers, TMA, wgmma, the producer
// lane) are in hopper.cuh, shared with the backward.
//
// Masking follows the TPU kernel exactly: masked scores are NEG_INF =
// -2e38 (not -inf), the denominator is max(l, 1e-30). Key tiles wholly
// above the causal diagonal or wholly before the window of every row of
// the CTA are skipped. In the TPU kernel such tiles add junk while the
// running max is still NEG_INF (exp(NEG_INF - NEG_INF) = 1), and the first
// live tile wipes it exactly (corr = exp(NEG_INF - m) = 0), so skipping
// them changes nothing. Skipping is only done when every row of the CTA
// has a live key; a row with none (a window that ends before the first
// key) gets the TPU's mean of V over all Sk keys. The longest causal
// tiles are launched first.
//
// Bound on the H100: operations. At the prefill shape of qwen3-1.7b
// (B*Hq = 128, Sq = Sk = 2048, D = 128, causal) the two products are about
// 1.37e11 FLOP against about 200 MB moved: 0.139 ms at 989 TFLOP/s.
#include <math.h>

#include "hopper.cuh"

namespace {

using repro::kNegInf;

// ---------------------------------------------------------------------------
// float32: the FP32-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

using repro::load4;

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                  // [B][Hq][Sq], or null: not stored
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

// rows x DR elements at src (row stride `ld` elements) -> dst[d][row]
// (leading dimension 64), times `mul`; rows >= `rows` are zero. Row-fastest
// mapping: a warp writes 32 consecutive rows of one d (no bank conflict).
template <int DR>
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                long long ld, int rows,
                                                float mul) {
  for (int c = threadIdx.x; c < 64 * (DR / 4); c += kThreads) {
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

// rows x DR elements -> dst[row][d] (leading dimension D, columns DR..D
// zero); dim-fastest mapping, so the global reads are coalesced.
template <int D, int DR>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int rows) {
  for (int c = threadIdx.x; c < 64 * (D / 4); c += kThreads) {
    const int r = c / (D / 4);
    const int d = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < DR) x = load4(src + r * ld + d);
    store4(dst + r * D + d, x);
  }
}

// D: the tiling's head width (64, 128, 256); DR <= D: the real one
template <int D, int DR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(Params p) {
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
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh
                + q0 * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;

  const int tid = threadIdx.x;
  const int ri = tid >> 4;
  const int ci = tid & 15;

  load_transposed<DR>(qt, qg, p.q_ss, q_rows, p.scale);

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
    load_transposed<DR>(kt, kg + k0 * p.k_ss, p.k_ss, k_rows, 1.f);
    load_rows<D, DR>(vs, vg + k0 * p.v_ss, p.v_ss, k_rows);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DR; ++d) {
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
    // the row's log-sum-exp (see repro_flash_attention): m and l are the
    // whole row's in every thread of the row group
    if (p.lse != nullptr && ci == 0)
      p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + q0 + r] =
          m[i] == kNegInf ? kNegInf : m[i] + logf(l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      if (t * 64 + ci * 4 >= DR) continue;
      store4(og + r * p.o_ss + t * 64 + ci * 4,
             make_float4(acc[i][t * 4 + 0] * inv, acc[i][t * 4 + 1] * inv,
                         acc[i][t * 4 + 2] * inv, acc[i][t * 4 + 3] * inv));
    }
  }
}

template <int D, int DR = D>
int launch(const Params& p, int batch, cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(3 * kBQ) * D + kBK * kBQ)
                      * sizeof(float);
  int err = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_f32<D, DR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, batch * p.hq);
  flash_fwd_f32<D, DR><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Params& p, int batch, int d, cudaStream_t st) {
  switch (d) {
    case 64: return launch<64>(p, batch, st);
    case 80: return launch<128, 80>(p, batch, st);
    case 128: return launch<128>(p, batch, st);
    case 256: return launch<256>(p, batch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (wgmma, TMA)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;                 // query rows: two warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup

// Shared memory, from a 1024-byte aligned base: Q [D/64][kBQ][64], then
// per stage K and V [D/64][BK][64] (bf16, 128-byte swizzle), then the
// ring's mbarriers: Q's, K's and V's per stage, empty per stage.
template <int D>
struct Layout {
  static constexpr int kBK = D == 256 ? 64 : 128;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kBars = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

struct Params {
  CUtensorMap q, k, v;                   // (D, S, H, B) views
  __nv_bfloat16* o;
  float* lse;                            // [B][Hq][Sq], or null: not stored
  long long o_sb, o_sh, o_ss;            // element strides of o
  int hq, g, sq, sk;
  int causal, window;                    // window <= 0: no window
  float scale, softcap;                  // softcap <= 0: no softcap
};

// Where one CTA's tiles are: the ring (Q fixed; stage s: K, then V) and
// the key range.
struct Tile {
  Ring r;
  int b, h, hk, q0, k_begin, n_tiles;
};

// Online softmax of one tile's scores, in log2 units (scores times log2 e,
// so that exp is one ex2). sc[4jj + e] is row row0 + 8 (e / 2), key k0 +
// 8jj + col + e % 2. Masked scores are NEG_INF in these units: a huge
// finite value, the same for every masked key, is all the TPU's semantics
// need (exp(NEG_INF - NEG_INF) = 1, exp(NEG_INF - m) = 0). Updates the row
// max m and this lane's share of the row sums l, returns the factor that
// rescales what O holds, and P rounded to bf16 as the A operand of the
// P V product (the fragment of n8 blocks 2kk, 2kk + 1 is key step kk).
// Each branch is uniform and wraps a whole loop.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    const Params& p, float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
    float (&m)[2], float (&l)[2], float (&corr)[2], int k0, int row0,
    int col, int wg_first, int wg_last) {
  if (p.softcap > 0.f) {
    const float in = p.scale / p.softcap;
    const float out = p.softcap * kLog2e;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = tanhf(sc[i] * in) * out;
  } else {
    const float mul = p.scale * kLog2e;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= mul;
  }
  if (k0 + BK > p.sk || (p.causal && k0 + BK - 1 > wg_first)
      || (p.window > 0 && k0 <= wg_last - p.window)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kp = k0 + 8 * (i / 4) + col + (i % 2);
      const int qp = row0 + 8 * ((i % 4) / 2);
      if (kp >= p.sk) {
        sc[i] = -INFINITY;            // ragged tile: not a key at all
      } else if ((p.causal && kp > qp)
                 || (p.window > 0 && kp <= qp - p.window)) {
        sc[i] = kNegInf;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int r = (i % 4) / 2;
    const float p0 = ex2(sc[i] - m[r]);
    const float p1 = ex2(sc[i + 1] - m[r]);
    l[r] += p0 + p1;
    pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
  }
}

// This row's log-sum-exp in natural-log units of the scaled, softcapped
// scores, from the running max m (log2 units) and the row sum l; a row
// with no live key (m still NEG_INF) gets NEG_INF, as the plain version's
// logsumexp of NEG_INF scores rounds to.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == kNegInf ? kNegInf : (m + log2f(l)) / kLog2e;
}

// A consumer warpgroup: query rows q0 + 64 wg .. + 63.
template <int D, int DR>
__device__ __forceinline__ void consume(const Params& p, const Tile& t) {
  using L = Layout<D>;
  constexpr int BK = L::kBK;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = t.q0 + 64 * wg + 16 * warp + lane / 4;   // and row0 + 8
  const int col = 2 * (lane % 4);
  const int wg_first = t.q0 + 64 * wg;
  const int wg_last = wg_first + 63;
  const uint32_t s_qw = t.r.s_fix + 64 * wg * kRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float corr[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];

  mbar_wait(t.r.full_fix, 0);
  for (int j = 0; j < t.n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const uint32_t s_k = t.r.s_ring + s * 2 * L::kTileBytes;
    mbar_wait(t.r.full_a + 8 * s, parity);
    // S = Q K^T
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
    issue_abt<DR, kBQ>(sc, s_qw, s_k);
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);
    softmax_tile<BK>(p, sc, pa, m, l, corr, t.k_begin + j * BK, row0, col,
                     wg_first, wg_last);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i % 4) / 2];

    // O += P V: BK / 16 steps of 16 keys (2048 bytes of V each)
    mbar_wait(t.r.full_b + 8 * s, parity);
    wgmma_fence();
    issue_pb<BK>(o, pa, s_k + L::kTileBytes);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    mbar_arrive(t.r.empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = row0 + 8 * r;
    if (qp >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = p.o + t.b * p.o_sb + t.h * p.o_sh + qp * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < DR / 8; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj + col) =
          pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    if (p.lse != nullptr && col == 0)
      p.lse[(static_cast<long long>(t.b) * p.hq + t.h) * p.sq + qp] =
          row_lse(m[r], l[r]);
  }
}

// Register budget: the producer warpgroup gives registers back
// (setmaxnreg), so that each consumer thread may hold O, S and P.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536,
              "register file");

// D: the tiling's head width (64, 128, 256); DR <= D: the real one, the
// inner dimension of the TMA maps (columns DR..D arrive as zeros)
template <int D, int DR>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  Tile t;
  t.r = make_ring((static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))
                   + 1023) & ~1023u, L::kQBytes, L::kBars);

  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest (causal) first
  t.b = blockIdx.y / p.hq;
  t.h = blockIdx.y % p.hq;
  t.hk = t.h / p.g;
  t.q0 = qtile * kBQ;
  const int q_last = min(t.q0 + kBQ, p.sq) - 1;

  // key range: skip tiles no row of the CTA can see (see the header)
  int k_end = p.sk;
  t.k_begin = 0;
  const bool every_row_live =
      p.window <= 0 || q_last - p.window + 1 <= p.sk - 1;
  if (every_row_live) {
    if (p.causal) k_end = min(p.sk, q_last + 1);
    if (p.window > 0) t.k_begin = max(0, t.q0 - p.window + 1);
  }
  t.n_tiles = (k_end - t.k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) init_ring(t.r, kConsumers);
  __syncthreads();

  // one if/else for the whole lifetime of each role (setmaxnreg needs
  // the paths never to meet again)
  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      const CUtensorMap* fix[1] = {&p.q};
      produce<D, kBQ, BK, kBQ, BK>(fix, t.q0, t.h, t.b, &p.k, &p.v, t.hk,
                                   t.k_begin, t.n_tiles, t.r);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    consume<D, DR>(p, t);
  }
}

template <int D, int DR = D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* st, int batch, int hq, int g, int sq, int sk,
           int causal, int window, float scale, float softcap,
           cudaStream_t stream) {
  using L = Layout<D>;
  Params p;
  const int hkv = hq / g;
  int err = encode(&p.q, q, DR, sq, hq, batch, st[0], st[1], st[2], kBQ);
  if (!err) err = encode(&p.k, k, DR, sk, hkv, batch, st[3], st[4], st[5],
                         L::kBK);
  if (!err) err = encode(&p.v, v, DR, sk, hkv, batch, st[6], st[7], st[8],
                         L::kBK);
  if (err) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  p.hq = hq;
  p.g = g;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  err = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_tc<D, DR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes));
  if (err) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  flash_fwd_tc<D, DR><<<grid, kThreads, L::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hq/g, Sk, D], o [B, Hq, Sq, D], all read and
// written through element strides (12 values: q, k, v, o, each batch /
// head / seq; the dim stride is 1). lse: float32 [B][Hq][Sq], contiguous,
// each row's log-sum-exp for the backward, or null (nothing stored: the
// serve path; O's bits are the same either way). dtype: 0 float32
// (FP32-core kernel), 1 bfloat16 (tensor-core kernel; strides multiples
// of 8). window <= 0 and softcap <= 0 switch those off.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     const long long* strides, int batch,
                                     int hq, int g, int sq, int sk, int d,
                                     int dtype, int causal, int window,
                                     float scale, float softcap, int device,
                                     void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (batch == 0 || hq == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (d) {
      case 64: return tc::launch<64>(q, k, v, o, lse, strides, batch, hq, g,
                                     sq, sk, causal, window, scale, softcap,
                                     st);
      case 80: return tc::launch<128, 80>(q, k, v, o, lse, strides, batch,
                                          hq, g, sq, sk, causal, window,
                                          scale, softcap, st);
      case 128: return tc::launch<128>(q, k, v, o, lse, strides, batch, hq,
                                       g, sq, sk, causal, window, scale,
                                       softcap, st);
      case 256: return tc::launch<256>(q, k, v, o, lse, strides, batch, hq,
                                       g, sq, sk, causal, window, scale,
                                       softcap, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  f32::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
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
  return f32::launch_f32(p, batch, d, st);
}
