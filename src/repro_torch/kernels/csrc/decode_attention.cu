// One-token decode attention over a key/value cache, split over the keys,
// with the splits combined in the same launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention_bhgd -> _kernel): the G query heads that share one
// key/value head (the GQA group, folded into rows) attend to that head's
// cache slots below kv_len, with an optional sliding window and logit
// softcap. The TPU kernel walks the cache in order, one grid step per key
// block, carrying (acc, m, l) in VMEM.
//
// Bound on the H100: bytes. Each live key and value row is read once
// (2 x kv_len x D x 2 bytes per head in bf16); the arithmetic is 4 G D
// FLOP per slot, far below the card's operations-to-bytes ratio. So the
// design keeps many bytes in flight and spends few instructions a slot:
//
// - Grid (splits, B*Hkv, row blocks), 128 threads. Each CTA takes the
//   query rows of one head (the GQA group, in blocks of at most 8 rows on
//   the tensor cores, or of 1024 / D on the CUDA cores) against one contiguous
//   slice of that head's live slots (those below kv_len and inside the
//   window). kv_len is read on the device, so the grid is fixed and the
//   slices follow the data: every CTA sums the live slots of all heads
//   and cuts them into equal chunks, about one per CTA the card holds at
//   once (one wave), so a head with a longer cache uses more splits and
//   the CTAs that a head does not need return at once.
// - K and V stay in their own type (bf16 or float32) in shared memory: a
//   ring of 3-4 tiles, filled with 16-byte cp.async.cg copies, the other
//   stages ahead of the tile in use, so the loads of the next tiles overlap this
//   one's scores and PV. Tiles are swizzled by 16-byte chunk so that the
//   reads below are free of bank conflicts. Each warp takes a quarter of
//   every tile and runs its own online softmax, so a tile costs one CTA
//   barrier (the ring's); the four warps' states merge in shared memory
//   at the end, in warp order.
// - bf16 at D = 64, 128, 256 (the served models) runs on the tensor
//   cores (decode_mma_kernel): 32-slot tiles, 8 slots a warp; S = Q K^T
//   by mma.m16n8k16 with Q in registers and K by ldmatrix, then O += P V
//   by mma.m16n8k8 with P straight from S's accumulators (rounded to
//   bf16, as in the bf16 flash kernel) and V by ldmatrix.trans. A ring
//   of three 32-slot tiles is 48 KB at D = 128: four CTAs on each SM.
// - float32, and other bf16 head sizes, run on the CUDA cores
//   (decode_core_kernel): 8 KB tiles; the 32 lanes of a warp split its
//   slots and D (four 16-byte chunks of K each, in registers across the
//   query rows) and reduce with warp shuffles; a half-warp per row runs
//   the softmax; for PV each lane owns 16-byte chunks of the output.
// - The combine is fused: every CTA writes its partial (acc, m, l),
//   fences, and counts itself in on a per-head arrival counter; the last
//   CTA of a head combines the splits in split order (the result is the
//   same from run to run), writes the output and sets the counter back
//   to 0 for the next call.
//
// The cache is read through strides in (batch, head, slot, dim) order, so
// the model's (B, Smax, Hkv, D) cache is read in place (never as a
// transposed copy), and only live slots are read. Any Smax and G; D x
// size a power of two from 32 to 1024 bytes; pointers and strides 16-byte
// aligned (the wrapper checks). Masked scores are NEG_INF = -2e38 and the
// denominator is max(l, 1e-30), as in the TPU kernel; a head with no live
// slot (kv_len < 1) gets the TPU's mean of V over all Smax slots.
#include <math.h>

#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kTileBytes = 8192;   // one K (or V) tile
constexpr int kMaxTile = 64;       // slots per tile: 16 a warp in softmax
constexpr int kMaxAcc = 32;        // accumulator floats a lane holds
constexpr int kMaxDevices = 64;

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
  int hkv, g, sk, d;
  int splits;                    // grid.x: splits a head may use at most
  int window;                    // <= 0: no window
  float scale, softcap;          // softcap <= 0: no softcap
  // set by the launcher
  int rows;                      // query rows a CTA takes (row blocks)
  int target;                    // splits the card holds at once
};

// Elements of T in one 16-byte chunk, and the chunk as floats.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = a.z;
    x[3] = a.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A head's live slots [r0, r1): below kv_len and inside the window; a head
// with none reads all Smax slots, all masked, as the TPU kernel sees them.
__device__ __forceinline__ void live_range(const Params& p, int kv_len,
                                           int* r0, int* r1) {
  *r0 = p.window > 0 ? max(0, kv_len - p.window) : 0;
  *r1 = min(kv_len, p.sk);
  if (*r0 >= *r1) {
    *r0 = 0;
    *r1 = p.sk;
  }
}

// The slice of its head's live slots that this CTA reads, [lo, hi), and
// how many splits the head uses; false when the head uses fewer splits
// than this CTA's index. The live slots of all heads are spread evenly over about the CTAs
// the card holds at once (at most grid.x a head), a whole number of
// tiles: kv_len is read on the device, so every CTA derives the same
// chunk, and a head with more live slots uses more splits. All threads
// of the CTA call it (it syncs).
__device__ __forceinline__ bool cta_slice(const Params& p, int tk,
                                          long long (*red)[kWarps], int* lo,
                                          int* hi, int* nsplit) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  long long tot = 0;
  long long most = 0;
  for (int hh = tid; hh < static_cast<int>(gridDim.y); hh += kThreads) {
    int a, z;
    live_range(p, p.kv_len[(hh / p.hkv) * p.l_sb + (hh % p.hkv) * p.l_sh],
               &a, &z);
    tot += z - a;
    most = max(most, static_cast<long long>(z - a));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tot += __shfl_xor_sync(0xffffffffu, tot, off);
    most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
  }
  if (lane == 0) {
    red[0][warp] = tot;
    red[1][warp] = most;
  }
  __syncthreads();
  tot = 0;
  most = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    tot += red[0][w];
    most = max(most, red[1][w]);
  }
  long long chunk = max((tot + p.target - 1) / p.target,
                        (most + gridDim.x - 1) / gridDim.x);
  chunk = (chunk + tk - 1) / tk * tk;
  const int bh = blockIdx.y;
  int r0, r1;
  live_range(p, p.kv_len[(bh / p.hkv) * p.l_sb + (bh % p.hkv) * p.l_sh],
             &r0, &r1);
  *nsplit = static_cast<int>((r1 - r0 + chunk - 1) / chunk);
  if (static_cast<int>(blockIdx.x) >= *nsplit) return false;
  *lo = r0 + static_cast<int>(blockIdx.x * chunk);
  *hi = min(r1, *lo + static_cast<int>(chunk));
  return true;
}

// One 16-byte cp.async.cg copy to shared memory; with real false it
// reads nothing and writes zeros (rows past a slice, so that every row
// the tensor cores read holds numbers).
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool real) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}

// The end of every CTA: the four warps' states (red[w][row][D] in shared
// memory, row max and sum at wm[w * sstride + row] and
// wl[w * sstride + row]) merge in warp order into this split's partial;
// the last CTA of the head to arrive combines the splits in split order
// and writes the output.
template <typename T, int D>
__device__ void finish(const Params& p, const float* red, const float* wm,
                       const float* wl, int sstride, int nsplit,
                       float* part_acc, float* part_ml, int* arrivals,
                       int* s_last) {
  const int tid = threadIdx.x;
  const int g = p.g;
  const int rb = p.rows;
  const int row0 = blockIdx.z * rb;
  const int nrow = min(rb, g - row0);
  const int bh = blockIdx.y;
  const long long part = static_cast<long long>(bh) * p.splits + blockIdx.x;
  for (int o = tid; o < nrow * D; o += kThreads) {
    const int r = o / D;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * sstride + r]);
    float num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * sstride + r];
      const float wgt = mw == -INFINITY ? 0.f : expf(mw - m);
      num = fmaf(red[w * rb * D + o], wgt, num);
    }
    part_acc[part * g * D + row0 * D + o] = num;
  }
  for (int r = tid; r < nrow; r += kThreads) {
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * sstride + r]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * sstride + r];
      const float wgt = mw == -INFINITY ? 0.f : expf(mw - m);
      l = fmaf(wl[w * sstride + r], wgt, l);
    }
    part_ml[(part * g + row0 + r) * 2 + 0] = m;
    part_ml[(part * g + row0 + r) * 2 + 1] = l;
  }

  // arrival: the last CTA of this head (over splits and row blocks)
  // combines
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *s_last = atomicAdd(arrivals + bh, 1) == nsplit * gridDim.z - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid == 0) arrivals[bh] = 0;   // ready for the next call
  const int b = bh / p.hkv;
  const int h = bh % p.hkv;
  const int n_out = g * D;
  const long long base = static_cast<long long>(bh) * p.splits;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int o = tid; o < n_out; o += kThreads) {
    const int r = o / D;
    const int e = o % D;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + ((base + s) * g + r) * 2));
    float num = 0.f;
    float den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ms = __ldcg(part_ml + ((base + s) * g + r) * 2);
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      num = fmaf(__ldcg(part_acc + (base + s) * n_out + o), w, num);
      den = fmaf(__ldcg(part_ml + ((base + s) * g + r) * 2 + 1), w, den);
    }
    store1(og + r * p.o_sg + e, num / fmaxf(den, 1e-30f));
  }
}

// The score of slot j (position k_pos) after scale, softcap and mask.
__device__ __forceinline__ float score(const Params& p, float x, float inv_cap,
                                       bool live, int k_pos, int kv_len) {
  if (!live) return -INFINITY;   // past the slice: not a slot at all
  x *= p.scale;
  if (p.softcap > 0.f) x = tanhf(x * inv_cap) * p.softcap;
  const bool ok = k_pos < kv_len
      && (p.window <= 0 || k_pos > kv_len - 1 - p.window);
  return ok ? x : kNegInf;
}

// ---------------------------------------------------------------------------
// CUDA-core kernel: float32, and bf16 head sizes the tensor-core kernel
// does not take
// ---------------------------------------------------------------------------

template <typename T, int NC>
struct Shape {
  static constexpr int kE = Chunk<T>::kElems;     // elements per chunk
  static constexpr int kD = NC * kE;              // head_dim
  static constexpr int kTK =                      // slots per tile
      kTileBytes / (NC * 16) < kMaxTile ? kTileBytes / (NC * 16) : kMaxTile;
  static constexpr int kLocal = kTK / kWarps;     // slots per warp per tile
  static constexpr int kLanes = 32 / kLocal;      // lanes per slot (scores)
  static constexpr int kCpl = NC / kLanes;        // chunks per lane
  static constexpr int kOcMax = kMaxAcc / kE;     // output chunks per lane
  // The score reads: a quarter-warp reads 8 / kLanes rows, kLanes chunks
  // each; rows of >= 128 bytes start on one bank, so chunk c of row j sits
  // at c ^ (j % (8 / kLanes)) * kLanes within its row (conflict-free).
  static constexpr bool kSwizzle = NC >= 8 && kLanes < 8;
  static_assert(kLocal >= 2 && kLocal <= 16 && kCpl >= 1, "tile split");
  __device__ __forceinline__ static int at(int j, int c) {
    return kSwizzle ? c ^ ((j % (8 / kLanes)) * kLanes) : c;
  }
};

// Shared memory of one CTA, in bytes (the launcher's and the kernel's
// layout): the ring, q of the CTA's rows (as float32), then per warp
// its scores [rows][kLocal] and row stats m, l, correction [rows].
template <typename T, int NC>
constexpr size_t core_smem(int rows) {
  using S = Shape<T, NC>;
  return static_cast<size_t>(kStages) * 2 * S::kTK * NC * 16
      + (static_cast<size_t>(rows) * S::kD
         + static_cast<size_t>(kWarps) * rows * (S::kLocal + 3))
      * sizeof(float);
}

// Grid (splits, B*Hkv, row blocks); 128 threads. Warp w takes slots
// [w LOCAL, (w + 1) LOCAL) of every tile and runs its own online softmax
// over them, so a tile costs one CTA barrier.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
decode_core_kernel(Params p, float* __restrict__ part_acc,
                   float* __restrict__ part_ml, int* __restrict__ arrivals) {
  using C = Chunk<T>;
  using S = Shape<T, NC>;
  constexpr int E = S::kE;
  constexpr int D = S::kD;
  constexpr int TK = S::kTK;
  constexpr int LOCAL = S::kLocal;
  constexpr int LANES = S::kLanes;
  constexpr int CPL = S::kCpl;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ long long s_red[2][kWarps];
  const int g = p.g;
  const int rb = p.rows;                            // rows of this CTA
  const int row0 = blockIdx.z * rb;
  const int nrow = min(rb, g - row0);
  T* ring = reinterpret_cast<T*>(smem);             // [stage][K, V][TK][D]
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * TK * D);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tid = threadIdx.x;
  float* ws = qs + rb * D + warp * rb * (LOCAL + 3);  // [rows][LOCAL]
  float* wm = ws + rb * LOCAL;                        // [rows] max
  float* wl = wm + rb;                                // [rows] sum
  float* wc = wl + rb;                                // [rows] correction

  int lo, hi, nsplit;
  if (!cta_slice(p, TK, s_red, &lo, &hi, &nsplit)) return;
  const int ntiles = (hi - lo + TK - 1) / TK;
  const int b = blockIdx.y / p.hkv;
  const int h = blockIdx.y % p.hkv;
  const int kv_len = p.kv_len[b * p.l_sb + h * p.l_sh];
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  auto load_tile = [&](int t) {
    T* ks = ring + (t % kStages) * 2 * TK * D;
    T* vs = ks + TK * D;
    const int k0 = lo + t * TK;
    const int rows = min(TK, hi - k0);
#pragma unroll
    for (int i = 0; i < (TK * NC + kThreads - 1) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / NC;
      const int e = (c % NC) * E;
      if (r < rows) {
        const int x = S::at(r, c % NC) * E;
        copy_chunk(ks + r * D + x, kg + (k0 + r) * p.k_ss + e, true);
        copy_chunk(vs + r * D + x, vg + (k0 + r) * p.v_ss + e, true);
      }
    }
  };
  // one commit group per tile (empty past the last tile): in iteration t,
  // wait_group(kStages - 2) means "tile t has landed"
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  for (int c = tid; c < nrow * NC; c += kThreads) {
    const int r = c / NC;
    const int e = (c % NC) * E;
    float x[E];
    C::load(qg + (row0 + r) * p.q_sg + e, x);
#pragma unroll
    for (int i = 0; i < E; ++i) qs[r * D + e + i] = x[i];
  }
  for (int r = lane; r < nrow; r += 32) {
    wm[r] = -INFINITY;   // no slot seen yet
    wl[r] = 0.f;
  }
  // PV ownership: lane owns output chunks o = lane + 32 i, o = (row, chunk)
  const int n_oc = nrow * NC;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t visible to all; the stage of t - 1 is free
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const T* ks = ring + (t % kStages) * 2 * TK * D;
    const T* vs = ks + TK * D;
    const int k0 = lo + t * TK;
    const int rows = min(TK, hi - k0);
    // this warp's slots: tile slots warp * LOCAL + jl, jl < nloc
    const int nloc = min(LOCAL, max(0, rows - warp * LOCAL));
    if (nloc == 0) continue;   // uniform over the warp

    // scores: LANES lanes per slot, each with CPL chunks of K in registers
    // across the rows (two rows at a time), then a shuffle reduce
    {
      const int jl = lane / LANES;
      const int u = lane % LANES;
      const int j = warp * LOCAL + jl;
      const bool live = jl < nloc;
      float kf[CPL][E];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        if (live) {
          C::load(ks + j * D + S::at(j, u + i * LANES) * E, kf[i]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kf[i][e] = 0.f;
        }
      }
      for (int r0 = 0; r0 < nrow; r0 += 2) {
        float x[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (r0 + rr < nrow) {
#pragma unroll
            for (int i = 0; i < CPL; ++i) {
              const float4* qr = reinterpret_cast<const float4*>(
                  qs + (r0 + rr) * D + (u + i * LANES) * E);
#pragma unroll
              for (int e = 0; e < E / 4; ++e) {
                const float4 qv = qr[e];
                x[rr] = fmaf(qv.x, kf[i][4 * e], x[rr]);
                x[rr] = fmaf(qv.y, kf[i][4 * e + 1], x[rr]);
                x[rr] = fmaf(qv.z, kf[i][4 * e + 2], x[rr]);
                x[rr] = fmaf(qv.w, kf[i][4 * e + 3], x[rr]);
              }
            }
          }
        }
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) {
          x[0] += __shfl_xor_sync(0xffffffffu, x[0], off);
          x[1] += __shfl_xor_sync(0xffffffffu, x[1], off);
        }
        if (u == 0) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            if (r0 + rr >= nrow) break;
            ws[(r0 + rr) * LOCAL + jl] =
                score(p, x[rr], inv_cap, live, k0 + j, kv_len);
          }
        }
      }
    }
    __syncwarp();
    // online softmax: a half-warp per row, a lane per local slot
    for (int r0 = 0; r0 < nrow; r0 += 2) {
      const int r = r0 + lane / 16;
      const int jl = lane % 16;
      const bool on = r < nrow && jl < LOCAL;
      const float a = on ? ws[r * LOCAL + jl] : -INFINITY;
      float mx = a;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = r < nrow ? wm[r] : 0.f;
      const float m_new = fmaxf(m_old, mx);   // >= NEG_INF: nloc > 0
      const float pa = on ? expf(a - m_new) : 0.f;
      if (on) ws[r * LOCAL + jl] = pa;
      float sum = pa;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (jl == 0 && r < nrow) {
        const float corr = expf(m_old - m_new);
        wc[r] = corr;
        wl[r] = wl[r] * corr + sum;
        wm[r] = m_new;
      }
    }
    __syncwarp();
    // PV over this warp's live slots
#pragma unroll
    for (int i = 0; i < S::kOcMax; ++i) {
      const int o = lane + 32 * i;
      if (o >= n_oc) break;
      const int r = o / NC;
      const int c = o % NC;
      const float corr = wc[r];
      float a[E];
#pragma unroll
      for (int e = 0; e < E; ++e) a[e] = acc[i * E + e] * corr;
      const float* pr = ws + r * LOCAL;
#pragma unroll
      for (int jl = 0; jl < LOCAL; ++jl) {
        if (jl >= nloc) break;
        const int j = warp * LOCAL + jl;
        float vf[E];
        C::load(vs + j * D + S::at(j, c) * E, vf);
        const float pj = pr[jl];
#pragma unroll
        for (int e = 0; e < E; ++e) a[e] = fmaf(pj, vf[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i * E + e] = a[e];
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' accumulators to shared memory (the ring is free)
  float* red = reinterpret_cast<float*>(smem);      // [warp][rows][D]
#pragma unroll
  for (int i = 0; i < S::kOcMax; ++i) {
    const int o = lane + 32 * i;
    if (o >= n_oc) break;
    float* dst = red + warp * rb * D + (o / NC) * D + (o % NC) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = acc[i * E + e];
  }
  __syncthreads();
  float* wm0 = qs + rb * D + rb * LOCAL;            // warp 0's stats
  finish<T, D>(p, red, wm0, wm0 + rb, rb * (LOCAL + 3), nsplit, part_acc,
               part_ml, arrivals, &s_last);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel: bf16, D = 64, 128 or 256
// ---------------------------------------------------------------------------
//
// A warp takes 8 slots of each 32-slot tile. S = Q K^T is
// mma.m16n8k16 (rows: the CTA's <= 8 query rows, padded to 16 with zeros;
// columns: the warp's 8 slots; Q's fragments stay in registers, K's come
// by ldmatrix); the scores' accumulator layout is the A operand layout of
// O += P V (mma.m16n8k8, V by ldmatrix.trans), so P never leaves the
// registers. P is rounded to bf16 for that product, as in the bf16 flash
// kernel. The row max and sum live in registers (a row's 8 scores sit in
// 4 lanes: two shuffles). Tiles are swizzled by 16-byte chunk (c ^ (j &
// 7)), so the ldmatrix reads are free of bank conflicts.

constexpr int kMmaTile = 32;       // slots per tile: 8 a warp
constexpr int kMmaRows = 8;        // query rows a CTA takes
constexpr int kMmaStages = 3;      // ring depth: 4 CTAs an SM at D = 128

template <int NC>
constexpr size_t mma_smem() {
  return static_cast<size_t>(kMmaStages) * 2 * kMmaTile * NC * 16
      + static_cast<size_t>(kWarps) * 2 * kMmaRows * sizeof(float);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += A B, m16n8k16, A rows 8..15 zero
__device__ __forceinline__ void mma_k16(float (&c)[4], uint32_t a0,
                                        uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// c += A B, m16n8k8, A rows 8..15 zero
__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(Params p, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ arrivals) {
  using T = __nv_bfloat16;
  constexpr int D = NC * 8;
  constexpr int ST = kMmaStages;
  constexpr int TK = kMmaTile;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ long long s_red[2][kWarps];
  T* ring = reinterpret_cast<T*>(smem);             // [stage][K, V][TK][D]
  float* stats = reinterpret_cast<float*>(ring + ST * 2 * TK * D);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;                          // fragment row
  const int tq = lane % 4;                          // fragment column pair
  const int rb = p.rows;
  const int row0 = blockIdx.z * rb;
  const int nrow = min(rb, p.g - row0);

  int lo, hi, nsplit;
  if (!cta_slice(p, TK, s_red, &lo, &hi, &nsplit)) return;
  const int ntiles = (hi - lo + TK - 1) / TK;
  const int b = blockIdx.y / p.hkv;
  const int h = blockIdx.y % p.hkv;
  const int kv_len = p.kv_len[b * p.l_sb + h * p.l_sh];
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  auto load_tile = [&](int t) {
    T* ks = ring + (t % ST) * 2 * TK * D;
    T* vs = ks + TK * D;
    const int k0 = lo + t * TK;
    const int rows = min(TK, hi - k0);
#pragma unroll
    for (int i = 0; i < TK * NC / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / NC;
      const int e = (c % NC) * 8;
      const int x = ((c % NC) ^ (r & 7)) * 8;
      const bool real = r < rows;
      const int src = real ? k0 + r : lo;           // a valid address
      copy_chunk(ks + r * D + x, kg + src * p.k_ss + e, real);
      copy_chunk(vs + r * D + x, vg + src * p.v_ss + e, real);
    }
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // Q's A fragments: row gq, columns 16 ks + 2 tq (+ 8); rows past the
  // CTA's are zero
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = 0u;
    qa[ks][1] = 0u;
    if (gq < nrow) {
      const T* qr = qg + (row0 + gq) * p.q_sg + 16 * ks + 2 * tq;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run = -INFINITY;   // row gq: no slot seen yet
  float l_run = 0.f;
  const float inv_cap = p.softcap > 0.f ? 1.f / p.softcap : 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();   // tile t visible to all; the stage of t - 1 is free
    if (t + ST - 1 < ntiles) load_tile(t + ST - 1);
    cp_async_commit();
    const T* ks = ring + (t % ST) * 2 * TK * D;
    const T* vs = ks + TK * D;
    const int k0 = lo + t * TK;
    const int rows = min(TK, hi - k0);
    const int j0 = warp * 8;                        // this warp's slots
    if (j0 >= rows) continue;                       // uniform over the warp
    const int jr = j0 + lane % 8;                   // ldmatrix row address
    // S = Q K^T over the warp's 8 slots: c0, c1 = row gq, slots 2 tq, +1
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + jr * D + ((2 * kk + lane / 8) ^ (jr & 7)) * 8);
      mma_k16(sc, qa[kk][0], qa[kk][1], kb[0], kb[1]);
      mma_k16(sc, qa[kk + 1][0], qa[kk + 1][1], kb[2], kb[3]);
    }
    const int j = j0 + 2 * tq;
    const float s0 = score(p, sc[0], inv_cap, j < rows, k0 + j, kv_len);
    const float s1 = score(p, sc[1], inv_cap, j + 1 < rows, k0 + j + 1,
                           kv_len);
    // online softmax of row gq: its 8 scores sit in lanes 4 gq .. 4 gq + 3
    float mx = fmaxf(s0, s1);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);   // >= NEG_INF: slot j0 is live
    const float p0 = expf(s0 - m_new);
    const float p1 = expf(s1 - m_new);
    float sum = p0 + p1;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    // O += P V over the warp's 8 slots
    const uint32_t pa = pack_bf16(p0, p1);
#pragma unroll
    for (int nq = 0; nq < D / 8; nq += 4) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vs + jr * D + ((nq + lane / 8) ^ (jr & 7)) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[nq + i][0] *= corr;
        acc[nq + i][1] *= corr;
        mma_k8(acc[nq + i], pa, vb[i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' accumulators (row gq, columns 8 n + 2 tq, +1) and row stats
  // to shared memory (the ring is free)
  float* red = reinterpret_cast<float*>(smem);      // [warp][rows][D]
  if (gq < nrow) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float* dst = red + (warp * rb + gq) * D + 8 * n + 2 * tq;
      dst[0] = acc[n][0];
      dst[1] = acc[n][1];
    }
    if (tq == 0) {
      stats[warp * 2 * kMmaRows + gq] = m_run;
      stats[warp * 2 * kMmaRows + kMmaRows + gq] = l_run;
    }
  }
  __syncthreads();
  finish<T, D>(p, red, stats, stats + kMmaRows, 2 * kMmaRows, nsplit,
               part_acc, part_ml, arrivals, &s_last);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Raise the shared-memory opt-in above 48 KB once per kernel and device
// (only ever upwards), and ask once per size how many CTAs of it the card
// holds at once.
template <auto kernel>
int configure(size_t smem, int device, int* resident) {
  static size_t granted[kMaxDevices];
  static size_t sized[kMaxDevices];
  static int held[kMaxDevices];
  if (smem > granted[device]) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    granted[device] = smem;
  }
  if (sized[device] != smem) {
    int per_sm = 0;
    int sms = 0;
    int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, smem));
    if (!err)
      err = static_cast<int>(cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device));
    if (err) return err;
    held[device] = max(1, per_sm * sms);
    sized[device] = smem;
  }
  *resident = held[device];
  return 0;
}

template <typename T, int NC>
int launch_core(Params& p, int batch, float* part_acc, float* part_ml,
                int* arrivals, int device, cudaStream_t st) {
  using S = Shape<T, NC>;
  // rows a CTA holds: the PV accumulators of a lane cover rows x D / 32
  p.rows = min(p.g, kMaxAcc * 32 / S::kD);
  const int row_blocks = (p.g + p.rows - 1) / p.rows;
  const size_t smem = core_smem<T, NC>(p.rows);
  // the warps' merge reuses the ring
  if (static_cast<size_t>(kWarps) * p.rows * S::kD * sizeof(float)
      > static_cast<size_t>(kStages) * 2 * S::kTK * NC * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int err = configure<decode_core_kernel<T, NC>>(smem, device,
                                                       &resident);
  if (err) return err;
  p.target = max(1, resident / row_blocks);
  decode_core_kernel<T, NC><<<dim3(p.splits, batch * p.hkv, row_blocks),
                              kThreads, smem, st>>>(p, part_acc, part_ml,
                                                    arrivals);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_mma(Params& p, int batch, float* part_acc, float* part_ml,
               int* arrivals, int device, cudaStream_t st) {
  p.rows = min(p.g, kMmaRows);
  const int row_blocks = (p.g + p.rows - 1) / p.rows;
  const size_t smem = mma_smem<NC>();
  int resident = 0;
  const int err = configure<decode_mma_kernel<NC>>(smem, device, &resident);
  if (err) return err;
  p.target = max(1, resident / row_blocks);
  decode_mma_kernel<NC><<<dim3(p.splits, batch * p.hkv, row_blocks),
                          kThreads, smem, st>>>(p, part_acc, part_ml,
                                                arrivals);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Params& p, int batch, float* part_acc, float* part_ml,
           int* arrivals, int device, cudaStream_t st) {
  constexpr int E = Chunk<T>::kElems;
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (p.d % E) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = p.d / E;
  if (sizeof(T) == 2) {
    switch (nc) {
      case 8: return launch_mma<8>(p, batch, part_acc, part_ml, arrivals,
                                   device, st);
      case 16: return launch_mma<16>(p, batch, part_acc, part_ml, arrivals,
                                     device, st);
      case 32: return launch_mma<32>(p, batch, part_acc, part_ml, arrivals,
                                     device, st);
      default: break;
    }
  }
  switch (nc) {
    case 2: return launch_core<T, 2>(p, batch, part_acc, part_ml, arrivals,
                                     device, st);
    case 4: return launch_core<T, 4>(p, batch, part_acc, part_ml, arrivals,
                                     device, st);
    case 8: return launch_core<T, 8>(p, batch, part_acc, part_ml, arrivals,
                                     device, st);
    case 16: return launch_core<T, 16>(p, batch, part_acc, part_ml,
                                       arrivals, device, st);
    case 32: return launch_core<T, 32>(p, batch, part_acc, part_ml,
                                       arrivals, device, st);
    case 64: return launch_core<T, 64>(p, batch, part_acc, part_ml,
                                       arrivals, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hkv, G, D], k/v [B, Hkv, Smax, D], o [B, Hkv, G, D] through element
// strides; kv_len int32. cfg: 22 values, the strides (q, k, v, o each
// batch / head / row, then kv_len's batch / head; the dim stride is 1),
// then B, Hkv, G, Smax, D, splits, dtype (0 float32, 1 bfloat16: q, k, v
// and o), window (<= 0: none). fcfg: scale, softcap (<= 0: none).
// Scratch: part_acc B*Hkv*splits*G*D floats, part_ml B*Hkv*splits*G*2
// floats; arrivals B*Hkv int32, zero before the call and zero again
// after it.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* kv_len,
                                      void* o, void* part_acc, void* part_ml,
                                      void* arrivals, const long long* cfg,
                                      const float* fcfg, int device,
                                      void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  const int batch = static_cast<int>(cfg[14]);
  Params p;
  p.hkv = static_cast<int>(cfg[15]);
  p.g = static_cast<int>(cfg[16]);
  if (batch == 0 || p.hkv == 0 || p.g == 0) return 0;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int32_t*>(kv_len);
  p.o = o;
  p.q_sb = cfg[0]; p.q_sh = cfg[1]; p.q_sg = cfg[2];
  p.k_sb = cfg[3]; p.k_sh = cfg[4]; p.k_ss = cfg[5];
  p.v_sb = cfg[6]; p.v_sh = cfg[7]; p.v_ss = cfg[8];
  p.o_sb = cfg[9]; p.o_sh = cfg[10]; p.o_sg = cfg[11];
  p.l_sb = cfg[12]; p.l_sh = cfg[13];
  p.sk = static_cast<int>(cfg[17]);
  p.d = static_cast<int>(cfg[18]);
  p.splits = static_cast<int>(cfg[19]);
  const int dtype = static_cast<int>(cfg[20]);
  p.window = static_cast<int>(cfg[21]);
  p.scale = fcfg[0];
  p.softcap = fcfg[1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* arr = static_cast<int*>(arrivals);
  return dtype == 1
      ? launch<__nv_bfloat16>(p, batch, pa, pm, arr, device, st)
      : launch<float>(p, batch, pa, pm, arr, device, st);
}
