// The backpointer tracebacks for Hopper, sm_90a: K6 (crf_scan.cu, the
// batch-minor int32 backpointers) and K11's traceback (crf_bt.cu, the
// batch-major, time-reversed int8 ones) are one time-parallel kernel over
// two layouts.
//
// A traceback walks each read's state back through its backpointers, one
// step a block: s <- valid ? bp[s] : s.  The serial walk (one thread a read,
// the first design of both) waits one memory round trip for every few steps
// and leaves the card idle: 0.37-0.51 ms at T=2560, B=256 on 2 of 132 SMs,
// ~2% of the bytes' bound.  But a step is a map f(s) = valid ? bp[s] : s of S
// states onto S states, and a run of steps is the composition of their maps,
// again an S-entry table: exact integer work, so the walk splits in time:
//  1. the walk is cut into segments of L steps; a warp walks one segment for
//     R = 32 / S reads from every start state at once (lane = read * S +
//     start state: 8 reads at S=4, 4 at S=8, 3 at S=10 with lanes 30-31
//     idle),
//     recording the state after each step as an int8 candidate in shared
//     memory; where a lane ends is its segment's map;
//  2. one warp composes the CTA's W segment maps in order (the table of the
//     segments before each, and the CTA's whole map); the cluster's C CTA
//     maps are read through distributed shared memory, and each CTA's entry
//     state follows from the read's entry state by at most C look-ups, each
//     warp's by one more;
//  3. each segment writes its outputs by selecting, for each read, the
//     candidate of the lane that started from its entry state.
// Every output is the state the serial walk reaches, so the result is
// bit-equal to it by construction.
//
// A cluster holds one read group (R reads) over the whole walk: C CTAs of W
// warps cover C * W * L steps a round, and a longer walk takes several
// rounds in order, the next round's entry state carried in shared memory.
// The backpointers of a warp's segment are staged in shared memory by
// cp.async before its walk, so no load sits on the dependent chain (a step
// is one shared load, a select and a byte store); the next round's copies
// are issued right after a walk and land during the exchange.  The plan
// (tb_plan, mirrored by ops/crf_bm_cuda.py _tb_plan) sets L, W, C and the
// rounds from (T, S, B): as many CTAs as two an SM over the card (at most 8
// a cluster) and at most TB_BUDGET bytes of staged steps a CTA, so that
// every cluster is resident at once (chip_smoke.py asks
// cudaOccupancyMaxActiveClusters).
//
// A source (crf_scan.cu's BmTrace, crf_bt.cu's BtTrace) says how its layout
// maps walk step k to time, stages a segment's backpointers (WORDS words a
// step) and picks a lane's backpointer from them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "crf_chain.cuh"

namespace flappie {

namespace tb_cg = cooperative_groups;

// Segments (warps) a CTA, CTAs a cluster at most (the portable size), CTAs
// the grid aims at (two on each of the H100's 132 SMs), bytes of staged
// steps a CTA at most (two CTAs an SM), reads a warp at most (S = 4).
constexpr int TB_WARPS = 8, TB_CLUSTER = 8, TB_CTAS = 264, TB_BUDGET = 72 * 1024, TB_MAX_R = 8;

// Slots for a warp's reads in a staged step's valid flags and in the entry
// states: R = 32 / S, but at least 4, the layout of S = 8 and 10 before S = 4
// (R = 8) was compiled, so that their plans did not move.
__host__ __device__ constexpr int tb_slots(int S) { return 32 / S > 4 ? 32 / S : 4; }

// Shared bytes of one staged step: a source's words, the valid flags of
// ``slots`` reads, 32 candidates.
__host__ __device__ constexpr int tb_step_bytes(int words, int slots) {
  return 4 * words + 4 * slots + 32;
}

// Shared bytes of a CTA besides its staged steps: the entry states (round,
// CTA, each warp's), the CTA's map by round parity, the cluster's maps
// copied, and each segment's map and prefix table.
__host__ __device__ constexpr int tb_fixed_bytes(int W, int slots) {
  return 2 * 4 * slots + W * 4 * slots + 2 * 32 + TB_CLUSTER * 32 + 2 * W * 32;
}

struct TbPlan {
  int L, W, C, ctas, rounds, smem;
};

// Steps a segment, warps a CTA, CTAs a cluster, CTAs, rounds and shared
// bytes a CTA of a traceback over T steps, S states and B reads, a step
// staged in ``words`` words.
inline TbPlan tb_plan(int T, int S, int B, int words) {
  const int R = 32 / S, groups = (B + R - 1) / R;
  int C = groups > 0 ? TB_CTAS / groups : 1;
  C = C < 1 ? 1 : C > TB_CLUSTER ? TB_CLUSTER : C;
  const int slots = tb_slots(S), step = tb_step_bytes(words, slots);
  const int W = TB_WARPS, lmax = TB_BUDGET / (W * step);
  const long long span = (long long)C * W * lmax;
  const int rounds = T > 0 ? (int)((T + span - 1) / span) : 0;
  const int segments = rounds * C * W;
  const int L = rounds > 0 ? (T + segments - 1) / segments : 1;
  return {L, W, C, groups * C, rounds, W * L * step + tb_fixed_bytes(W, slots)};
}

// One cluster a read group.  Src: the source's layout (above); valid [T, B]
// int32 in time order; last [B]; out[time * B + b] the state before step
// time (with out[T * B + b] = last[b] when write_last).
template <class Src>
__global__ void __launch_bounds__(32 * TB_WARPS)
    traceback_kernel(const Src src, const int* __restrict__ valid, const int* __restrict__ last,
                     int* __restrict__ out, int T, int B, int L, int rounds, int write_last) {
  constexpr int S = Src::S, R = 32 / S, WORDS = Src::WORDS, MR = tb_slots(S);
  static_assert(R <= MR && MR <= TB_MAX_R, "a warp's reads' flags fit a step's slots");
  tb_cg::cluster_group cluster = tb_cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = (blockIdx.x / C) * R;
  // a lane's read (rr: idle lanes 30-31 at S=10 shadow read 0 and never
  // store), the lane of its read's state 0, and its start state; the 32
  // lanes' candidates and maps are bytes at any S
  const int r = lane / S, rr = r < R ? r : 0, base = rr * S, st = lane - r * S;

  extern __shared__ __align__(16) unsigned char smem[];
  int* ent = reinterpret_cast<int*>(smem);  // [MR] each read's entry state to this round
  int* entc = ent + MR;                     // [MR] ... to this CTA's span
  int* went = entc + MR;                    // [W][MR] ... to each warp's segment
  unsigned char* ctam = reinterpret_cast<unsigned char*>(went + W * MR);  // [2][32] CTA map
  unsigned char* peer = ctam + 2 * 32;           // [TB_CLUSTER][32] the cluster's CTA maps
  unsigned char* maps = peer + TB_CLUSTER * 32;  // [W][32] each segment's map
  unsigned char* pre = maps + W * 32;            // [W][32] the segments before it, composed
  unsigned* words =
      reinterpret_cast<unsigned*>(pre + W * 32 + warp * L * tb_step_bytes(WORDS, MR));
  int* flags = reinterpret_cast<int*>(words + L * WORDS);                    // [L][MR]
  unsigned char* cand = reinterpret_cast<unsigned char*>(flags + L * MR);  // [L][32]

  if (warp == 0 && lane < R) {
    const bool ok = b0 + lane < B;
    ent[lane] = ok ? last[b0 + lane] : 0;
    if (ok && write_last && rank == 0) out[(long long)T * B + b0 + lane] = last[b0 + lane];
  }
  // the walk steps of this warp's segment in round j: [first(j), first(j) + count)
  auto first = [&](int j) { return ((j * C + rank) * W + warp) * L; };
  auto count = [&](int k0) { return max(0, min(L, T - k0)); };
  auto stage = [&](int j) {
    const int k0 = first(j), n = count(k0);
    src.stage(words, k0, n, b0, lane);
    for (int i = lane; i < n * R; i += 32) {
      const int k = i / R, q = i - k * R, b = b0 + q;
      const bool ok = b < B;
      cp_async<4>(flags + k * MR + q, ok ? valid + (long long)src.time(k0 + k) * B + b : valid,
                  ok ? 4 : 0);
    }
  };
  if (rounds > 0) stage(0);
  for (int j = 0; j < rounds; ++j) {
    const int k0 = first(j), n = count(k0), par = j & 1;
    cp_async_wait_all();
    __syncwarp();
    // 1. the segment from every start state at once
    int s = st;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int p = src.pick(words + k * WORDS, k0 + k, b0, rr, s);
      s = flags[k * MR + rr] ? p : s;
      cand[k * 32 + lane] = (unsigned char)s;
    }
    maps[warp * 32 + lane] = (unsigned char)s;
    __syncwarp();
    if (j + 1 < rounds) stage(j + 1);  // lands during this round's exchange
    __syncthreads();
    // 2. the maps composed: the segments before each warp's, the CTA's
    if (warp == 0) {
      int e = st;
      for (int w = 0; w < W; ++w) {
        pre[w * 32 + lane] = (unsigned char)e;
        e = maps[w * 32 + base + e];
      }
      ctam[par * 32 + lane] = (unsigned char)e;
    }
    cluster.sync();
    if (warp == 0) {
      for (int i = lane; i < C * 8; i += 32) {
        const unsigned* m =
            cluster.map_shared_rank(reinterpret_cast<unsigned*>(ctam + par * 32), i / 8);
        reinterpret_cast<unsigned*>(peer)[i] = m[i % 8];
      }
      __syncwarp();
      if (lane < R) {
        int e = ent[lane];
        for (int c = 0; c < C; ++c) {
          if (c == rank) entc[lane] = e;
          e = peer[c * 32 + lane * S + e];
        }
        ent[lane] = e;
      }
    }
    __syncthreads();
    // 3. each read's candidate from the lane that started at its entry
    if (lane < R) went[warp * MR + lane] = pre[warp * 32 + lane * S + entc[lane]];
    __syncwarp();
    for (int i = lane; i < n * R; i += 32) {
      const int k = i / R, q = i - k * R;
      if (b0 + q < B)
        out[(long long)src.time(k0 + k) * B + b0 + q] = cand[k * 32 + q * S + went[warp * MR + q]];
    }
  }
  // no CTA leaves while a peer may still read its map
  cluster.sync();
}

// Launch the traceback at ``p``, or, with max_active, only ask how many of
// its clusters the card holds at once (cudaOccupancyMaxActiveClusters).
// Returns the error code.
template <class Src>
int tb_launch(const TbPlan& p, const Src& src, const int* valid, const int* last, int* out, int T,
              int B, int write_last, cudaStream_t st, int* max_active = nullptr) {
  auto kernel = traceback_kernel<Src>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(32 * p.W);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active != nullptr)
    return cudaOccupancyMaxActiveClusters(max_active, reinterpret_cast<const void*>(kernel), &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, src, valid, last, out, T, B, p.L, p.rounds, write_last);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// info = {L, W, C, CTAs, rounds, shared bytes a CTA, clusters the card
// holds at once}.
template <class Src>
int tb_info(int T, int B, int* info) {
  const TbPlan p = tb_plan(T, Src::S, B, Src::WORDS);
  int n = 0;
  const int err = tb_launch(p, Src{}, nullptr, nullptr, nullptr, T, B, 0, 0, &n);
  if (err != 0) return err;
  const int v[7] = {p.L, p.W, p.C, p.ctas, p.rounds, p.smem, n};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}

}  // namespace flappie
