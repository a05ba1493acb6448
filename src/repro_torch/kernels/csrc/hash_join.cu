// Exact equi-join probe over a leading partition dimension.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_join.py
// (block_join_probe -> _kernel): for each probe row, the smallest build
// index whose 1-2 int32 keys are equal, where the build row and the
// probe row are both valid; -1 if there is none.
//
// Design. grid = (ceil(NP / 256), P): one thread owns one probe row and
// keeps its keys in registers. Build rows stream through shared memory in
// tiles of 1024 (keys + valid byte); every thread of the block reads the
// same build row at the same time (a broadcast, no bank conflicts), so a
// tile costs one compare per (probe row, build row). Tiles arrive in build
// order and a thread stops comparing at its first match, so that match is
// the smallest index: no min-reduce is needed. A block stops streaming
// tiles once all its threads have matched or are invalid
// (__syncthreads_and), which is what ends the scan early.
//
// Bound on the H100: the function reads each key once (bytes bound, about
// 12 microseconds at Q8's shapes); this dense form does up to
// NP x NB integer compares per partition instead, so it is bound by
// operations. The TPU tile compare carried over as it was; a hashed probe
// (sort + binary search, as the plain version does) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
join_probe_kernel(const int32_t* __restrict__ pk0,
                  const int32_t* __restrict__ pk1,
                  const uint8_t* __restrict__ pvalid,
                  const int32_t* __restrict__ bk0,
                  const int32_t* __restrict__ bk1,
                  const uint8_t* __restrict__ bvalid,
                  int32_t* __restrict__ pos, int np, int nb, int two_keys) {
  __shared__ int32_t s_k0[kTile];
  __shared__ int32_t s_k1[kTile];
  __shared__ uint8_t s_ok[kTile];
  const int p = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int64_t poff = static_cast<int64_t>(p) * np;
  const int64_t boff = static_cast<int64_t>(p) * nb;
  bool searching = row < np && pvalid[poff + row] != 0;
  const int32_t a0 = searching ? pk0[poff + row] : 0;
  const int32_t a1 = (searching && two_keys) ? pk1[poff + row] : 0;
  int32_t found = -1;
  for (int base = 0; base < nb; base += kTile) {
    // also the barrier that keeps the previous tile alive until every
    // thread is done with it
    if (__syncthreads_and(!searching)) break;
    const int n = min(kTile, nb - base);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int64_t b = boff + base + i;
      s_ok[i] = bvalid[b];
      s_k0[i] = bk0[b];
      s_k1[i] = two_keys ? bk1[b] : 0;
    }
    __syncthreads();
    if (searching) {
      for (int i = 0; i < n; ++i) {
        if (s_ok[i] && s_k0[i] == a0 && s_k1[i] == a1) {
          found = base + i;
          searching = false;
          break;
        }
      }
    }
  }
  if (row < np) pos[poff + row] = found;
}

}  // namespace

// keys/valid: probe [P, NP], build [P, NB] (int32 keys, bool as bytes);
// pk1/bk1 are ignored unless two_keys. pos: [P, NP] int32.
extern "C" int repro_join_probe(const void* pk0, const void* pk1,
                                const void* pvalid, const void* bk0,
                                const void* bk1, const void* bvalid,
                                void* pos, int p, int np, int nb,
                                int two_keys, int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || np == 0) return 0;
  dim3 grid((np + kThreads - 1) / kThreads, p);
  join_probe_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pk0),
      static_cast<const int32_t*>(two_keys ? pk1 : pk0),
      static_cast<const uint8_t*>(pvalid), static_cast<const int32_t*>(bk0),
      static_cast<const int32_t*>(two_keys ? bk1 : bk0),
      static_cast<const uint8_t*>(bvalid), static_cast<int32_t*>(pos), np,
      nb, two_keys);
  return static_cast<int>(cudaGetLastError());
}
