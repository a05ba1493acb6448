// Exact equi-join probe over a leading partition dimension, through a
// hash table built on the device.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_join.py
// (block_join_probe -> _kernel): for each probe row, the smallest build
// index whose 1-2 int32 keys are equal, where the build row and the
// probe row are both valid; -1 if there is none. Build keys may repeat.
// The TPU has no scattered hash table, so its kernel compares dense
// (probe tile x build tile) blocks: O(NP x NB) work. The H100 has fast
// atomics in its 50 MB L2, so this is the paper's in-memory hash join.
//
// Design. One table of T = next_pow2(2 NB) int32 slots per partition
// (scratch from the wrapper; load factor <= 1/2), filled with -1, holds
// build row indices under linear probing; the keys stay in the build
// arrays and are read through the stored index. Three launches on one
// stream:
//   1. memset the table to -1 (0xFF bytes);
//   2. build, one thread per valid build row b: from the hash of its
//      keys, walk the slots; an empty slot is claimed with
//      atomicCAS(slot, -1, b); a slot whose row has b's keys takes
//      atomicMin(slot, b) and ends the walk; any other slot is stepped
//      over. A slot only ever holds rows of one key and never empties,
//      so rows with equal keys walk the same slots to the same one and
//      the smallest index wins, whatever order the threads run in: the
//      table, and so the result, is deterministic;
//   3. probe, one thread per probe row: walk from the hash until an
//      empty slot (-1) or a slot whose row has equal keys (its index).
// The hash is murmur3's word mix over (k0[, k1]) and its finaliser:
// dictionary ids and packed dates are near-sequential, and (a, b) and
// (b, a) hash apart. Expected work is O(NP + NB); all build keys equal
// costs one slot and NB atomics on it at worst (a thread whose index is
// above the slot's skips the atomicMin).
//
// Bound on the H100: bytes. The function must read each key and valid
// flag once and write one int32 per probe row (about 12 microseconds at
// Q8's P = 4, NP = 200,000, NB = 800,000 with two keys); the design adds
// the table (4 x 2^21 x 4 B = 32 MiB at Q8, memset once and resident in
// the L2) and scattered 4-byte reads of it and of the build keys.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t k) {
  k *= 0xcc9e2d51u;
  k = rotl32(k, 15);
  k *= 0x1b873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}

template <bool kTwo>
__device__ __forceinline__ uint32_t key_hash(int32_t k0, int32_t k1) {
  uint32_t h = mix_word(0x9747b28cu, static_cast<uint32_t>(k0));
  if (kTwo) h = mix_word(h, static_cast<uint32_t>(k1));
  h ^= kTwo ? 8u : 4u;
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

template <bool kTwo>
__device__ __forceinline__ bool same_keys(const int32_t* __restrict__ k0,
                                          const int32_t* __restrict__ k1,
                                          int32_t row, int32_t a0,
                                          int32_t a1) {
  return __ldg(k0 + row) == a0 && (!kTwo || __ldg(k1 + row) == a1);
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
build_kernel(const int32_t* __restrict__ bk0, const int32_t* __restrict__ bk1,
             const uint8_t* __restrict__ bvalid, int32_t* __restrict__ table,
             int nb, uint64_t mask) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const int64_t boff = static_cast<int64_t>(blockIdx.y) * nb;
  if (b >= nb || !bvalid[boff + b]) return;
  const int32_t* k0 = bk0 + boff;
  const int32_t* k1 = kTwo ? bk1 + boff : nullptr;
  const int32_t a0 = k0[b];
  const int32_t a1 = kTwo ? k1[b] : 0;
  int32_t* t = table + static_cast<int64_t>(blockIdx.y) * (mask + 1);
  uint64_t s = key_hash<kTwo>(a0, a1) & mask;
  while (true) {
    // an L2 read: a stale -1 only sends the thread to the CAS, which
    // returns the slot's current row
    int32_t cur = __ldcg(t + s);
    if (cur == -1) {
      cur = atomicCAS(t + s, -1, b);
      if (cur == -1) return;
    }
    if (same_keys<kTwo>(k0, k1, cur, a0, a1)) {
      if (b < cur) atomicMin(t + s, b);
      return;
    }
    s = (s + 1) & mask;
  }
}

template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ pk0, const int32_t* __restrict__ pk1,
             const uint8_t* __restrict__ pvalid,
             const int32_t* __restrict__ bk0, const int32_t* __restrict__ bk1,
             const int32_t* __restrict__ table, int32_t* __restrict__ pos,
             int np, int nb, uint64_t mask) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= np) return;
  const int64_t poff = static_cast<int64_t>(blockIdx.y) * np + r;
  int32_t found = -1;
  if (pvalid[poff]) {
    const int64_t boff = static_cast<int64_t>(blockIdx.y) * nb;
    const int32_t* k0 = bk0 + boff;
    const int32_t* k1 = kTwo ? bk1 + boff : nullptr;
    const int32_t a0 = pk0[poff];
    const int32_t a1 = kTwo ? pk1[poff] : 0;
    const int32_t* t = table + static_cast<int64_t>(blockIdx.y) * (mask + 1);
    uint64_t s = key_hash<kTwo>(a0, a1) & mask;
    while (true) {
      const int32_t cur = __ldg(t + s);
      if (cur == -1) break;
      if (same_keys<kTwo>(k0, k1, cur, a0, a1)) {
        found = cur;
        break;
      }
      s = (s + 1) & mask;
    }
  }
  pos[poff] = found;
}

template <bool kTwo>
int launch(const int32_t* pk0, const int32_t* pk1, const uint8_t* pvalid,
           const int32_t* bk0, const int32_t* bk1, const uint8_t* bvalid,
           int32_t* table, int64_t tsize, int32_t* pos, int p, int np,
           int nb, cudaStream_t st) {
  int err = static_cast<int>(cudaMemsetAsync(
      table, 0xFF, static_cast<size_t>(p) * tsize * sizeof(int32_t), st));
  if (err) return err;
  const uint64_t mask = static_cast<uint64_t>(tsize) - 1;
  build_kernel<kTwo><<<dim3((nb + kThreads - 1) / kThreads, p), kThreads, 0,
                       st>>>(bk0, bk1, bvalid, table, nb, mask);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  probe_kernel<kTwo><<<dim3((np + kThreads - 1) / kThreads, p), kThreads, 0,
                       st>>>(pk0, pk1, pvalid, bk0, bk1, table, pos, np, nb,
                             mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys/valid: probe [P, NP], build [P, NB] (int32 keys, bool as bytes);
// pk1/bk1 are not read unless two_keys. table: P * tsize int32 scratch,
// tsize a power of two >= 2 NB (contents ignored; filled here). pos:
// [P, NP] int32.
extern "C" int repro_join_probe(const void* pk0, const void* pk1,
                                const void* pvalid, const void* bk0,
                                const void* bk1, const void* bvalid,
                                void* pos, void* table, long long tsize,
                                int p, int np, int nb, int two_keys,
                                int device, void* stream) {
  int err = repro::select_device(device);
  if (err) return err;
  if (p == 0 || np == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 0)   // nothing to match: every row is -1 (0xFF bytes)
    return static_cast<int>(cudaMemsetAsync(
        pos, 0xFF, static_cast<size_t>(p) * np * sizeof(int32_t), st));
  if (tsize < 2LL * nb || (tsize & (tsize - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<int32_t*>(table);
  auto* out = static_cast<int32_t*>(pos);
  const auto* pv = static_cast<const uint8_t*>(pvalid);
  const auto* bv = static_cast<const uint8_t*>(bvalid);
  const auto* p0 = static_cast<const int32_t*>(pk0);
  const auto* p1 = static_cast<const int32_t*>(pk1);
  const auto* b0 = static_cast<const int32_t*>(bk0);
  const auto* b1 = static_cast<const int32_t*>(bk1);
  return two_keys ? launch<true>(p0, p1, pv, b0, b1, bv, t, tsize, out, p,
                                 np, nb, st)
                  : launch<false>(p0, p0, pv, b0, b0, bv, t, tsize, out, p,
                                  np, nb, st);
}
