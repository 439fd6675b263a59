// The CRF chain scans' shared pieces for Hopper, sm_90a: the batch-minor
// K3/K4, K9 and K5 (crf_scan.cu) and the batch-major K11 forward and
// Viterbi scans (crf_bt.cu) are one frame over two layouts.
//
// A chain warp holds whole reads, lane = read * S + state, and takes a step
// with S __shfl_sync of its reads' states and no block barrier.  The CTA's
// last warp, the producer, fills each chain warp's ring of RING tiles of KT
// steps of weights in shared memory; a slot's ``full`` mbarrier completes
// when its copies land, its ``empty`` one when the chain warp has read it
// (one arrive a tile).  This header holds what does not depend on the
// layout: the ring's constants, the mbarrier and copy instructions, and a
// lane's step arithmetic, so that every scan sums and compares in the same
// order:
//  - sum semiring: z[j] = a[j] + w(j) in order j = 0..S-1, the max as an
//    exact tree, the sum of precise expf(z[j] - max) in order 0..S-1, then
//    max + logf(sum);
//  - max-plus: the max as a tree, the backpointer the least key
//    rank * 16 + j among the maxima (the lowest tie rank, then the lowest
//    j: what a strict-< scan over j in order keeps);
//  - invalid steps blend a = v*nxt + (1-v)*a with v 0 or 1, exact however
//    it is contracted.
// chip_smoke.py holds every scan that uses them to its plain version
// (K5 and K11's Viterbi bit-equal); compare_scans.py holds K3/K4, K9 and
// K5 bit-equal to, and times them against, an earlier checkout's.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace flappie {

constexpr int RANK_BIG = 1000000;
constexpr unsigned FULL = 0xffffffffu;

// Steps a ring tile, tiles in a warp's ring (ops/crf_bm_cuda.py and
// ops/crf_cuda.py mirror them).
constexpr int KT = 8, RING = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = smem_addr(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive on the barrier once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// max over z[0 .. S-1] as a tree: exact, so any order gives the same bits.
template <int S>
__device__ __forceinline__ float max_of(const float (&z)[S]) {
  float m[S];
#pragma unroll
  for (int j = 0; j < S; ++j) m[j] = z[j];
#pragma unroll
  for (int w = 1; w < S; w *= 2)
#pragma unroll
    for (int j = 0; j + w < S; j += 2 * w) m[j] = fmaxf(m[j], m[j + w]);
  return m[0];
}

// One sum-semiring step of a lane: lse over j of (state j of its read, held
// by lane base + j) + w(j).
template <int S, typename Weight>
__device__ __forceinline__ float lse_step(float a, int base, Weight&& w) {
  float z[S];
#pragma unroll
  for (int j = 0; j < S; ++j) z[j] = __shfl_sync(FULL, a, base + j) + w(j);
  const float mx = max_of<S>(z);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < S; ++j) sum += expf(z[j] - mx);
  return mx + logf(sum);
}

// The backpointer keys of a lane's to-state: key[f] = rank[f][to] * 16 + f
// for a maximum, nokey[f] = RANK_BIG * 16 + f otherwise.
template <int S>
struct MaxKeys {
  int key[S], nokey[S];
  __device__ __forceinline__ MaxKeys(const int* __restrict__ rank, int to) {
#pragma unroll
    for (int f = 0; f < S; ++f) {
      key[f] = rank[f * S + to] * 16 + f;
      nokey[f] = RANK_BIG * 16 + f;
    }
  }
};

// One max-plus step of a lane: the best of (state f held by lane base + f)
// + w(f), and in ``bp`` the from-state of the least key among the maxima.
template <int S, typename Weight>
__device__ __forceinline__ float maxplus_step(float a, int base, Weight&& w, const MaxKeys<S>& mk,
                                              int& bp) {
  float z[S];
#pragma unroll
  for (int f = 0; f < S; ++f) z[f] = __shfl_sync(FULL, a, base + f) + w(f);
  const float best = max_of<S>(z);
  int k[S];
#pragma unroll
  for (int f = 0; f < S; ++f) k[f] = z[f] == best ? mk.key[f] : mk.nokey[f];
#pragma unroll
  for (int w = 1; w < S; w *= 2)
#pragma unroll
    for (int f = 0; f + w < S; f += 2 * w) k[f] = min(k[f], k[f + w]);
  bp = k[0] & 15;
  return best;
}

}  // namespace flappie
