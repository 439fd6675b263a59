// Batch-minor CRF decode scans (K3/K4, K9, K5, K6) for Hopper, sm_90a.
//
// Replaces, in flappie_tpu/ops/crf_bm_pallas.py:
//   crf_sum_kernel       <- _sum_kernel:69 (one kernel, direction flag), reached
//                           through fwd_states_pallas:194 (K3) and
//                           bwd_states_pallas:218 (K4);
//   crf_fwdbwd_kernel    <- _fwdbwd_kernel:95 via fwdbwd_states_pallas:251 (K9:
//                           K3's and K4's chains in one launch);
//   crf_viterbi_kernel   <- _viterbi_kernel:135 via viterbi_fwd_pallas:300 (K5);
//   traceback_kernel<BmTrace<S>> (traceback.cuh)
//                        <- _traceback_kernel:170 via traceback_pallas:333 (K6).
// K3/K4, K5 and K6 are compiled for S = 4 (the V1 run-length chain), 8
// (flip-flop over 4 bases) and 10 (5 bases); K9 for S = 8 and 10, the only
// S whose paths reach it.
//
// Layout is the JAX package's batch-minor one: dense transition blocks
// [T, S, S, B] (from, to, read), validity [T, B], states [T+1, S, B].
//
// What bounds them on this card: not bytes (the dense input is T.S.S.B.4 B =
// 168 MB at T=2560, S=8, B=256: ~50 us of HBM time) and not arithmetic
// (~50 flops per (step, state, read)), but the serial chain over T: every
// step needs the previous step's S states of the same read, so a kernel
// takes T times the time of one step of one warp.  The first design (one
// thread per (state, read), 32 reads x S states a block, the states
// exchanged through shared memory under a __syncthreads over S warps every
// step, 2.KT.S floats of prefetched weights in registers) took ~570 ns a
// step for K3 at S=8 and ~850 ns at S=10 (1.44-1.50 and 2.13-2.24 ms at
// T=2560, B=256; K5 ~560 ns), on 8 blocks at B=256 and one at B <= 32.
// This design takes ~225 ns (K3, S=8), ~340 ns (S=10) and 160-175 ns (K5,
// S=8) a step (0.58, 0.86-0.88, 0.40-0.45 ms; NVIDIA H100 80GB HBM3,
// 700.00 W, chip_smoke.py), and at S=4 ~164 ns (K3) and 105-115 ns (K5) a
// step (0.419, 0.27-0.29 ms):
//  - a chain warp holds whole reads, lane = read * S + state (R = 32 / S
//    reads: 8 at S=4, 4 at S=8, 3 at S=10 with lanes 30-31 idle), so a
//    step exchanges the S states of a read with S __shfl_sync and no block
//    barrier;
//  - chain warps are independent: a CTA holds W of them (kWarps: 1 at S=4
//    and S=8, 2 at S=10, the fastest of 1, 2, 4; scan_plan, mirrored by
//    ops/crf_bm_cuda.py _scan_plan), so B=256 spreads over 64 warps (32 at
//    S=4) and runnie's B=24 over 6;
//  - the weights do not pass through the chain warp's registers or
//    instructions: a producer warp (the CTA's last) streams each chain
//    warp's slice dense[t, :, :, b0:b0+R] and valid flags into that warp's
//    ring of RING tiles of KT steps in shared memory with cp.async (16-byte
//    copies of 4 reads when aligned: R a multiple of 4, i.e. S=4 or 8, and B
//    % 4 == 0; else 4-byte copies, zero-filled past B; a tile's KT * R valid
//    flags take one or two copies a lane), and each slot's mbarrier
//    completes when its copies land.  The
//    chain warp waits once a tile and frees the slot with one arrive.
//    With each chain warp issuing its own copies, K3 took ~330 ns a step
//    at S=8.  Runs sit in the ring at swz(from, to), so that both
//    directions read it without bank conflicts;
//  - outputs (alpha/beta, backpointers) are staged a tile in shared memory
//    and written out after it, 16 bytes a run where aligned (not timed
//    against per-lane stores on this design).
// What is left a step (K3, S=8) is the arithmetic's own dependent chain,
// ~150 instructions issued in order by one warp: S shuffles, the max, S
// precise expf, the sequential sum, one precise logf and the blend.
//
// Arithmetic follows the TPU kernels exactly: lse = max + log(sum(exp(z -
// max))), the sum over j in sequential order, with forbidden transitions at
// the finite NEG_BIG; invalid steps blend a = v*nxt + (1-v)*a
// (crf_bm_pallas.py:88); the Viterbi backpointer is the lowest tie_rank among
// the maxima, scanned per from-state (crf_bm_pallas.py:153-157), identity on
// invalid steps.  The max-plus pass uses only adds and compares, so it is
// bit-equal to its plain version; K9 runs K3's and K4's chain function in
// different CTAs of one launch, so it is bit-equal to them.  The ring's
// constants, the mbarrier and copy instructions and the step arithmetic are
// crf_chain.cuh's, shared with K11's forward and Viterbi scans (crf_bt.cu).
//
// K6, the traceback, is not a chain of arithmetic but of look-ups: path[t] =
// bp[t][path[t+1]] on valid steps.  Its first design walked one read a
// thread over T, loading the S backpointers of the next 8 steps a tile
// ahead: ~160 ns a step, one memory round trip a tile with almost nothing
// else in flight (0.41 ms at T=2560, B=256, S=8 on 2 CTAs; the bytes' bound
// 0.008 ms).  It now runs traceback.cuh's time-parallel walk: segments of
// the walk taken from every start state at once, their maps composed
// through a cluster's shared memory, each output the candidate of the lane
// that started at its segment's entry state.  What bounds it is the bytes
// (T*S*B*4 of backpointers, read once) and the walk of one segment, L
// dependent shared-memory look-ups.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "crf_chain.cuh"
#include "traceback.cuh"

namespace {

using namespace flappie;

// One warp's ring: R reads' slice of KT steps a tile and their valid flags,
// and the outputs of its last two tiles, staged for writing out.
template <int S>
struct Ring {
  static constexpr int R = 32 / S;        // reads a warp
  static constexpr int STEP = S * S * R;  // floats of one step's slice
  static constexpr int NV = (KT * R + 31) / 32;  // valid-flag copies a lane a tile
  static_assert(NV <= 2, "a tile's valid flags take at most two copies a lane");
  unsigned long long full[RING], empty[RING];  // mbarriers: slot filled, slot read
  float m[RING][KT][STEP];
  int v[RING][KT][R];
  unsigned o[2][KT][S][R];
};

// Chain warps a CTA: the fastest of 1, 2 and 4 on the H100 (chip_smoke.py
// times the others in builds with -DSCAN_WARPS=n; at S=4 one and two tie
// within the runs' spread, four is 10-14% slower); at most 4, as
// __launch_bounds__(160) allows with the producer warp.
#ifdef SCAN_WARPS
template <int S>
constexpr int kWarps = SCAN_WARPS;
#else
template <int S>
constexpr int kWarps = S == 10 ? 2 : 1;
#endif
static_assert(kWarps<4> >= 1 && kWarps<4> <= 4 && kWarps<8> >= 1 && kWarps<8> <= 4 &&
                  kWarps<10> >= 1 && kWarps<10> <= 4,
              "1 to 4 chain warps a CTA");

struct ScanPlan {
  int R, W, ctas, smem;
};

// Reads a warp, chain warps a CTA (kWarps, never more than the batch
// needs), CTAs, shared bytes a CTA.  Each CTA also runs one producer warp.
template <int S>
ScanPlan scan_plan(int B) {
  constexpr int R = Ring<S>::R;
  const int nw = (B + R - 1) / R;
  int W = kWarps<S>;
  if (W > nw) W = nw;
  if (W < 1) W = 1;
  return {R, W, (nw + W - 1) / W, W * static_cast<int>(sizeof(Ring<S>))};
}

// Where the run (from f, to t) of a step's slice sits in the ring: rotated
// by f, so that lanes reading one run per state (forward: (j, st); backward:
// (st, j)) hit distinct banks.
template <int S>
__device__ __forceinline__ int swz(int f, int t) {
  return f * S + (t + f) % S;
}

// A lane's share of the copies that fill one tile of the ring: VEC copies 4
// reads' floats of a run (from f, to t) at once, 16 bytes (one copy a run
// at R = 4, two at R = 8), else one float, zero-filled for reads past B;
// the tile's KT * R valid flags take NV copies of an int a lane (two at R =
// 8).  Offsets are computed once; bytes < 0 marks no copy.
template <int S, bool VEC>
struct Copier {
  static constexpr int R = Ring<S>::R, NV = Ring<S>::NV;
  static constexpr int PER = VEC ? 4 : 1;     // floats a copy
  static constexpr int CPR = R / PER;         // copies a run
  static constexpr int N = S * S * CPR;       // copies of one step's slice
  static constexpr int NE = (N + 31) / 32;    // of them a lane's
  static_assert(R % PER == 0, "a 16-byte copy holds 4 reads of a run");
  int src[NE], dst[NE], bytes[NE];
  int vk[NV], vr[NV], vbytes[NV];  // the valid flags this lane copies: step vk, read vr

  __device__ __forceinline__ Copier(int lane, int B, int b0) {
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = q * 32 + lane;
      const int run = e / CPR, r = (e % CPR) * PER;
      const int f = run / S, t = run % S;
      const bool ok = b0 + r < B;
      src[q] = ok ? (f * S + t) * B + b0 + r : 0;
      dst[q] = e < N ? swz<S>(f, t) * R + r : 0;
      bytes[q] = e >= N ? -1 : ok ? 4 * PER : 0;
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int e = q * 32 + lane;
      vk[q] = e / R;
      vr[q] = e % R;
      vbytes[q] = vk[q] >= KT ? -1 : b0 + vr[q] < B ? 4 : 0;
    }
  }

  // Start the copies of step k of a tile: time t into ``slot``.
  __device__ __forceinline__ void step(Ring<S>& ring, int slot, int k, int t, const float* dense,
                                       int B) const {
    const float* src_t = dense + (long)t * S * S * B;
#pragma unroll
    for (int q = 0; q < NE; ++q)
      if (bytes[q] >= 0) cp_async<4 * PER>(ring.m[slot][k] + dst[q], src_t + src[q], bytes[q]);
  }

  // Start the copies of ring tile ``tile`` (steps tile*KT ...) into ``slot``.
  __device__ __forceinline__ void issue(Ring<S>& ring, int slot, int tile, const float* dense,
                                        const int* valid, int T, int B, int b0,
                                        bool backward) const {
    const int s0 = tile * KT;
    auto time = [&](int k) { return backward ? T - 1 - s0 - k : s0 + k; };
    if (s0 + KT <= T) {
#pragma unroll
      for (int k = 0; k < KT; ++k) step(ring, slot, k, time(k), dense, B);
    } else {
      for (int k = 0; k < T - s0; ++k) step(ring, slot, k, time(k), dense, B);
    }
#pragma unroll
    for (int q = 0; q < NV; ++q)
      if (vbytes[q] >= 0 && s0 + vk[q] < T)
        cp_async<4>(&ring.v[slot][vk[q]][vr[q]],
                    valid + (long)time(vk[q]) * B + (vbytes[q] ? b0 + vr[q] : 0), vbytes[q]);
  }
};

// Write the staged outputs of one tile (n steps): step k's S x R words go to
// row row0 + drow * k of out [rows, S, B], 16 bytes (4 reads) a store where
// VEC.
template <int S, bool VEC>
__device__ __forceinline__ void write_out(const Ring<S>& ring, int tile, int n, unsigned* out, int B,
                                      int b0, int row0, int drow) {
  constexpr int R = Ring<S>::R, PER = VEC ? 4 : 1, CPR = R / PER, N = KT * S * CPR;
  const int lane = threadIdx.x & 31;
  const unsigned(&o)[KT][S][R] = ring.o[tile & 1];
#pragma unroll
  for (int q = 0; q < (N + 31) / 32; ++q) {
    const int e = q * 32 + lane;
    const int run = e / CPR, r = (e % CPR) * PER;
    const int k = run / S, st = run % S;
    if (k >= n || b0 + r >= B) continue;
    unsigned* dst = out + ((long)(row0 + drow * k) * S + st) * B + b0 + r;
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&o[k][st][r]);
    else
      *dst = o[k][st][r];
  }
}

// The producer warp (the last of the CTA): fill each chain warp's ring, tile
// by tile, RING tiles ahead of it at most.  A slot's ``full`` barrier
// completes when the 32 lanes' copies into it have landed; its ``empty``
// barrier when the chain warp has read it.
template <int S, bool VEC>
__device__ __forceinline__ void produce(Ring<S>* rings, int W, const float* dense,
                                        const int* valid, int T, int B, bool backward) {
  const int lane = threadIdx.x & 31, w0 = blockIdx.x * W;
  int nc = 0;  // chain warps of this CTA that hold reads
  while (nc < W && (w0 + nc) * Ring<S>::R < B) ++nc;
  const int ntile = (T + KT - 1) / KT;
  for (int tile = 0; tile < ntile; ++tile) {
    const int slot = tile % RING, fill = tile / RING;
    for (int c = 0; c < nc; ++c) {
      Ring<S>& ring = rings[c];
      const int b0 = (w0 + c) * Ring<S>::R;
      if (fill > 0) mbar_wait(&ring.empty[slot], (fill - 1) & 1);
      Copier<S, VEC>(lane, B, b0).issue(ring, slot, tile, dense, valid, T, B, b0, backward);
      cp_async_arrive(&ring.full[slot]);
    }
  }
  cp_async_wait_all();
}

// Walk a chain warp's T steps in the order the producer fills them,
// calling step(slice, valid flags, staging row) with each step's slice in
// the ring, and flush(tile, steps) once a tile's outputs are staged.  Every
// lane of the warp calls it with the same T.
template <int S, typename Step, typename Flush>
__device__ __forceinline__ void walk(Ring<S>& ring, int T, Step&& step, Flush&& flush) {
  const int ntile = (T + KT - 1) / KT;
  for (int tile = 0; tile < ntile; ++tile) {
    const int slot = tile % RING, n = min(KT, T - tile * KT);
    mbar_wait(&ring.full[slot], (tile / RING) & 1);
    unsigned(&o)[KT][S][Ring<S>::R] = ring.o[tile & 1];
    if (n == KT) {
      // a whole tile: no exit test between steps, so the compiler may move
      // one step's loads into the next step's chain
#pragma unroll
      for (int k = 0; k < KT; ++k) step(ring.m[slot][k], ring.v[slot][k], o[k]);
    } else {
      for (int k = 0; k < n; ++k) step(ring.m[slot][k], ring.v[slot][k], o[k]);
    }
    __syncwarp();  // the slot is read and the tile's outputs staged
    if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[slot]);
    flush(tile, n);
  }
}

// A lane's place: read r of the warp (rr: r clamped into the ring for the
// idle lanes 30-31 at S=10), state st, the lane holding state 0 of its read,
// and the ring offsets of the S weights it sums over (forward: from-states j
// into st; backward: to-states j out of st).
template <int S>
struct Lane {
  int r, rr, st, base, rd[S];
  __device__ __forceinline__ explicit Lane(bool backward) {
    constexpr int R = Ring<S>::R;
    const int lane = threadIdx.x & 31;
    r = lane / S;
    st = lane % S;
    rr = r < R ? r : 0;
    base = r * S;
#pragma unroll
    for (int j = 0; j < S; ++j) rd[j] = (backward ? swz<S>(st, j) : swz<S>(j, st)) * R + rr;
  }
};

// One warp's sum-semiring chain over its reads (K3/K4, and each of K9's two
// chains).  Forward: st is the to-state and the lane reduces over from-states
// j of alpha_t[j] + m_t[j][st].  Backward: st is the from-state and the lane
// reduces over to-states j of m_t[st][j] + beta_{t+1}[j], walking t from T-1
// down.
template <int S, bool VEC>
__device__ __forceinline__ void sum_warp(Ring<S>& ring, float* __restrict__ out, int T, int B,
                                         int b0, bool backward) {
  constexpr int R = Ring<S>::R;
  const Lane<S> L(backward);
  const int b = b0 + L.r;
  if (L.r < R && b < B) out[((long)(backward ? T : 0) * S + L.st) * B + b] = 0.f;
  float a = 0.f;
  walk<S>(
      ring, T,
      [&](const float* m, const int* vf, unsigned(&o)[S][R]) {
        const float nxt = lse_step<S>(a, L.base, [&](int j) { return m[L.rd[j]]; });
        const float v = (float)vf[L.rr];
        a = v * nxt + (1.f - v) * a;
        if (L.r < R) o[L.st][L.r] = __float_as_uint(a);
      },
      [&](int tile, int n) {
        // step s = tile * KT + k writes alpha_{s+1} or beta_{T-1-s}
        const int s0 = tile * KT;
        write_out<S, VEC>(ring, tile, n, reinterpret_cast<unsigned*>(out), B, b0,
                      backward ? T - 1 - s0 : s0 + 1, backward ? -1 : 1);
      });
}

// Set up the CTA: W chain warps, each with its ring, and the producer warp
// (the last), which fills them and returns nullptr.  A chain warp gets its
// ring and first read b0, or nullptr past the batch.
template <int S, bool VEC>
__device__ __forceinline__ Ring<S>* chain_warp(const float* dense, const int* valid, int T, int B,
                                               bool backward, int& b0) {
  extern __shared__ __align__(16) unsigned char smem[];
  Ring<S>* rings = reinterpret_cast<Ring<S>*>(smem);
  const int W = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5;
  if (threadIdx.x < W * RING) {
    mbar_init(&rings[threadIdx.x / RING].full[threadIdx.x % RING], 32);
    mbar_init(&rings[threadIdx.x / RING].empty[threadIdx.x % RING], 1);
  }
  __syncthreads();  // once, before any chain starts
  if (warp == W) {
    produce<S, VEC>(rings, W, dense, valid, T, B, backward);
    return nullptr;
  }
  b0 = (blockIdx.x * W + warp) * Ring<S>::R;
  return b0 < B ? rings + warp : nullptr;
}

// K3/K4: one chain.
template <int S, bool VEC>
__global__ void __launch_bounds__(160) crf_sum_kernel(const float* __restrict__ dense,
                                                      const int* __restrict__ valid,
                                                      float* __restrict__ out, int T, int B,
                                                      int backward) {
  int b0;
  Ring<S>* ring = chain_warp<S, VEC>(dense, valid, T, B, backward != 0, b0);
  if (ring) sum_warp<S, VEC>(*ring, out, T, B, b0, backward != 0);
}

// K9: the alpha chain (blockIdx.y = 0) and the beta chain (blockIdx.y = 1)
// of the same reads in one launch, each warp running K3's/K4's own chain.
template <int S, bool VEC>
__global__ void __launch_bounds__(160) crf_fwdbwd_kernel(const float* __restrict__ dense,
                                                         const int* __restrict__ valid,
                                                         float* __restrict__ alphas,  // [T+1, S, B]
                                                         float* __restrict__ betas,   // [T+1, S, B]
                                                         int T, int B) {
  int b0;
  Ring<S>* ring = chain_warp<S, VEC>(dense, valid, T, B, blockIdx.y != 0, b0);
  if (ring) sum_warp<S, VEC>(*ring, blockIdx.y ? betas : alphas, T, B, b0, blockIdx.y != 0);
}

// K5: max-plus forward; lane (read, to-state).
template <int S, bool VEC>
__global__ void __launch_bounds__(160) crf_viterbi_kernel(
    const float* __restrict__ dense,  // [T, S, S, B]
    const int* __restrict__ valid,    // [T, B]
    const int* __restrict__ rank,     // [S, S] (from, to)
    float* __restrict__ alpha_out,    // [S, B]
    int* __restrict__ bp_out,         // [T, S, B]
    int T, int B) {
  int b0;
  Ring<S>* ring = chain_warp<S, VEC>(dense, valid, T, B, false, b0);
  if (!ring) return;
  const Lane<S> L(false);
  const int to = L.st, b = b0 + L.r;
  const bool live = L.r < Ring<S>::R && b < B;
  // the backpointer is the lowest tie rank among the maxima, the first
  // from-state among equal ranks: the least key rank * 16 + f
  const MaxKeys<S> mk(rank, to);
  float a = 0.f;
  walk<S>(
      *ring, T,
      [&](const float* m, const int* vf, unsigned(&o)[S][Ring<S>::R]) {
        int bp;
        const float best = maxplus_step<S>(a, L.base, [&](int f) { return m[L.rd[f]]; }, mk, bp);
        const float v = (float)vf[L.rr];
        a = v * best + (1.f - v) * a;
        if (L.r < Ring<S>::R) o[to][L.r] = v != 0.f ? bp : to;
      },
      [&](int tile, int n) {
        write_out<S, VEC>(*ring, tile, n, reinterpret_cast<unsigned*>(bp_out), B, b0, tile * KT, 1);
      });
  if (live) alpha_out[(long)to * B + b] = a;
}

// K6's layout for traceback.cuh: backpointers [T, S, B] int32 (from-state
// of each to-state, read), walked from t = T-1 down, so walk step k is time
// T-1-k.  A step's R * S staged words are bp[t][s][b0 + r] at s * R + r: with
// ``vec`` (R a multiple of 4, B % 4 == 0, bp on a 16-byte boundary) one
// 16-byte copy of 4 reads a state (two at R = 8; reads past B zero-filled),
// else one 4-byte copy a lane (no copy for a read past B: its valid flags
// are zero-filled, so its lanes never move).
template <int S_>
struct BmTrace {
  static constexpr int S = S_, R = 32 / S, WORDS = R * S, Q = R / 4;  // Q: 16-byte copies a state
  const int* bp;
  int T, B;
  bool vec;
  __device__ __forceinline__ int time(int k) const { return T - 1 - k; }
  __device__ __forceinline__ void stage(unsigned* words, int k0, int n, int b0, int lane) const {
    if constexpr (Q > 0) {
      if (vec) {
        for (int i = lane; i < n * S * Q; i += 32) {
          const int k = i / (S * Q), sq = i - k * S * Q, s = sq / Q, r = (sq - s * Q) * 4;
          const bool ok = b0 + r < B;
          const int* src = ok ? bp + ((long long)time(k0 + k) * S + s) * B + b0 + r : bp;
          cp_async<16>(words + k * WORDS + s * R + r, src, ok ? 16 : 0);
        }
        return;
      }
    }
    const int r = lane / S, s = lane - r * S;
    if (r >= R || b0 + r >= B) return;
    const int* src = bp + ((long long)time(k0) * S + s) * B + b0 + r;
    for (int k = 0; k < n; ++k)
      cp_async<4>(words + k * WORDS + s * R + r, src - (long long)k * S * B, 4);
  }
  __device__ __forceinline__ int pick(const unsigned* w, int, int, int rr, int s) const {
    return (int)w[s * R + rr];
  }
};

// Launch a chain kernel at ``plan``: the 16-byte copy and write-out path
// when every 4 reads of a run of the slices and outputs are 16-byte aligned
// (R = 4 or 8 reads a warp, B % 4 == 0, each tensor on a 16-byte boundary),
// else the 4-byte one.
// ``kernel(vec)`` names the instantiation; returns the launch error code.
template <int S, typename Kernel, typename... Args>
int launch_chain(const ScanPlan& plan, int grid_y, int B, std::initializer_list<const void*> ptrs,
                 cudaStream_t st, Kernel&& kernel, Args... args) {
  auto go = [&](auto fn) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (err != cudaSuccess) return (int)err;
    fn<<<dim3(plan.ctas, grid_y), 32 * (plan.W + 1), plan.smem, st>>>(args...);
    return (int)cudaGetLastError();
  };
  if constexpr (Ring<S>::R % 4 == 0) {
    bool vec = B % 4 == 0;
    for (const void* p : ptrs) vec = vec && reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
    if (vec) return go(kernel(std::true_type{}));
  }
  return go(kernel(std::false_type{}));
}

template <int S>
int launch_sum(const float* dense, const int* valid, float* out, int T, int B, int backward,
               cudaStream_t st) {
  return launch_chain<S>(
      scan_plan<S>(B), 1, B, {dense, out}, st,
      [](auto vec) { return crf_sum_kernel<S, decltype(vec)::value>; }, dense, valid, out, T, B,
      backward);
}

template <int S>
int launch_fwdbwd(const float* dense, const int* valid, float* alphas, float* betas, int T,
                  int B, cudaStream_t st) {
  return launch_chain<S>(
      scan_plan<S>(B), 2, B, {dense, alphas, betas}, st,
      [](auto vec) { return crf_fwdbwd_kernel<S, decltype(vec)::value>; }, dense, valid, alphas,
      betas, T, B);
}

template <int S>
int launch_viterbi(const float* dense, const int* valid, const int* rank, float* alpha, int* bp,
                   int T, int B, cudaStream_t st) {
  return launch_chain<S>(
      scan_plan<S>(B), 1, B, {dense, bp}, st,
      [](auto vec) { return crf_viterbi_kernel<S, decltype(vec)::value>; }, dense, valid, rank,
      alpha, bp, T, B);
}

template <int S>
int launch_traceback(const int* bp, const int* valid, const int* last, int* out, int T, int B,
                     cudaStream_t st) {
  const bool vec =
      BmTrace<S>::R % 4 == 0 && B % 4 == 0 && reinterpret_cast<std::uintptr_t>(bp) % 16 == 0;
  return tb_launch(tb_plan(T, S, B, BmTrace<S>::WORDS), BmTrace<S>{bp, T, B, vec}, valid, last, out,
                   T, B, 1, st);
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan of the chain kernels (K3/K4, K9, K5) for S states and B reads:
// info = {reads a warp, chain warps a CTA, CTAs (K9 launches two rows of
// them), shared bytes a CTA}.
extern "C" int flappie_crf_scan_info(int S, int B, int* info) {
  if (S != 4 && S != 8 && S != 10) return cudaErrorInvalidValue;
  const ScanPlan p = S == 4 ? scan_plan<4>(B) : S == 8 ? scan_plan<8>(B) : scan_plan<10>(B);
  info[0] = p.R;
  info[1] = p.W;
  info[2] = p.ctas;
  info[3] = p.smem;
  return 0;
}

// S = 4 (the V1 run-length chain), 8 (flip-flop over 4 bases) and 10 (5
// bases) are compiled; K9 at S = 8 and 10 only.
extern "C" int flappie_crf_sum(const float* dense, const int* valid, float* out, int T,
                               int S, int B, int backward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_sum<4>(dense, valid, out, T, B, backward, st);
  if (S == 8) return launch_sum<8>(dense, valid, out, T, B, backward, st);
  if (S == 10) return launch_sum<10>(dense, valid, out, T, B, backward, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_fwdbwd(const float* dense, const int* valid, float* alphas,
                                  float* betas, int T, int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 8) return launch_fwdbwd<8>(dense, valid, alphas, betas, T, B, st);
  if (S == 10) return launch_fwdbwd<10>(dense, valid, alphas, betas, T, B, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_viterbi(const float* dense, const int* valid, const int* rank,
                                   float* alpha, int* bp, int T, int S, int B,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_viterbi<4>(dense, valid, rank, alpha, bp, T, B, st);
  if (S == 8) return launch_viterbi<8>(dense, valid, rank, alpha, bp, T, B, st);
  if (S == 10) return launch_viterbi<10>(dense, valid, rank, alpha, bp, T, B, st);
  return cudaErrorInvalidValue;
}

// The plan of K6 (traceback.cuh) over T steps, S states and B reads: info =
// {steps a segment, warps a CTA, CTAs a cluster, CTAs, rounds, shared bytes a
// CTA, clusters the card holds at once}.
extern "C" int flappie_crf_traceback_info(int T, int S, int B, int* info) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  if (S == 4) return tb_info<BmTrace<4>>(T, B, info);
  if (S == 8) return tb_info<BmTrace<8>>(T, B, info);
  if (S == 10) return tb_info<BmTrace<10>>(T, B, info);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_traceback(const int* bp, const int* valid, const int* last,
                                     int* out, int T, int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_traceback<4>(bp, valid, last, out, T, B, st);
  if (S == 8) return launch_traceback<8>(bp, valid, last, out, T, B, st);
  if (S == 10) return launch_traceback<10>(bp, valid, last, out, T, B, st);
  return cudaErrorInvalidValue;
}
