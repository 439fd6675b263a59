// Batch-major CRF scans (K11) for Hopper, sm_90a.
//
// Replaces, in flappie_tpu/ops/crf_pallas.py:
//   crf_bt_fwd_kernel       <- _fwd_kernel:45 via fwd_scan_pallas:153 (the sum
//                              scan; the backward pass runs it on transposed,
//                              time-reversed blocks, ops/crf.py crf_backward);
//   crf_bt_viterbi_kernel   <- _viterbi_kernel:73 via viterbi_scan_pallas:178;
//   traceback_kernel<BtTrace<S>> (traceback.cuh)
//                           <- _traceback_kernel:115 via traceback_pallas:217.
// All three are compiled for S = 4 (the V1 run-length chain), 8 and 10.
//
// Layout is crf_pallas.py's batch-major one: transition blocks [T, B, S, S]
// (step, read, from, to: one read's S*S weights of a step are contiguous),
// validity [T, B], states [T, B, S] -- the state AFTER each block, with no
// alpha_0 row.  The kernels read it as it is; nothing is transposed to the
// batch-minor layout of csrc/crf_scan.cu.
//
// What bounds them on this card: not bytes (T.B.S.S.4 B = 168 MB at T=2560,
// B=256, S=8: ~50 us of HBM time) and not arithmetic, but the serial chain
// over T: a kernel takes T times one step of one warp.  The first design
// (one thread per (state, read), 32 reads x S states a block, the states
// exchanged through shared memory under a __syncthreads over S warps every
// step, each thread loading its next KT steps of weights into registers)
// took ~470 ns a step at S=8, on one block at runnie's B=24.  The forward
// and Viterbi scans now run K3/K5's frame (crf_chain.cuh, crf_scan.cu):
//  - a chain warp holds R = 32 / S whole reads, lane = read * S + to-state (8
//    reads at S=4, 4 at S=8, 3 at S=10 with lanes 30-31 idle); a step gathers the S
//    states of a read with S __shfl_sync, and no block barrier sits on the
//    chain;
//  - chain warps are independent, one a CTA (kBtWarps; bt_plan, mirrored by
//    ops/crf_cuda.py _bt_plan), so B=256 spreads over 64 CTAs (86 at S=10)
//    and runnie's B=24 over 6.  Two or four a CTA, sharing an SM, were
//    slower at both S: Viterbi at S=10 0.61 against 0.37 ms with two;
//  - the weights never pass through the chain warp's registers: the CTA's
//    last warp, the producer, fills each chain warp's ring of RING tiles of
//    KT steps.  One step's R reads' S*S blocks are contiguous in the
//    batch-major layout (512, 1024 or 1200 bytes at S = 4, 8, 10, at a
//    16-byte aligned offset), and the producer lanes bring them by one
//    16-byte cp.async each, each read's block to its padded place in the
//    ring; the valid flags go by 4-byte cp.async, both zero-filled past B
//    or T, and each lane's cp.async arrival completes the slot's full
//    mbarrier.  A bulk copy a read (cp.async.bulk), the earlier design, held the
//    S=4 chain at ~265 ns a step, 8 copies of 64 bytes a step, where these
//    copies take ~150-180 ns;
//  - bank layout: lane (r, to) reads from-row f of its read at r*P + f*S +
//    to.  With the blocks packed (P = S*S) the 4 reads of S=8 fall on one
//    bank (64 = 0 mod 32): a 4-way conflict on every load of the chain.
//    Each read's block lands at a padded stride P (20 floats at S=4: the 8
//    reads' rows on banks 0, 20, 8, 28, 16, 4, 24, 12, no conflict; 72 at
//    S=8: reads on banks 0, 8, 16, 24, no conflict; 104 at S=10, where no
//    stride that keeps the blocks 16-byte aligned separates three runs of
//    10 banks: at most 2-way, against 3-way packed);
//  - outputs of a step are R*S contiguous floats (and int8 backpointers),
//    one coalesced store a warp.  The forward scan holds a tile of them in
//    registers and stores them after the tile (S=10: 0.58 against 0.71 ms
//    when stored at every step; S=8 equal or 2-4% faster), the Viterbi
//    scan stores them at every step (holding them: 2-17% slower, and
//    spills).
// Measured (chip_smoke.py, compare_scans.py; NVIDIA H100 80GB HBM3, 700.00
// W): at T=2560, B=256 the forward scan takes ~0.55-0.57 ms at S=8 (~213-223
// ns a step; the first design 1.20 ms in the same call) and ~0.58-0.65 at
// S=10 (1.76), the Viterbi scan ~0.39-0.45 (1.08) and ~0.36-0.37 (1.66); at
// runnie's T=13,108, B=24, 2.49-2.76 (5.69) and 1.60-1.84 (4.89).  Against
// a bulk copy a read, in the same call, the 16-byte copies took the forward
// scan 0.545 against 0.569 ms at S=8 and 0.653 against 0.633 at S=10, the
// Viterbi 0.392 against 0.430 and 0.362 against 0.399, runnie's shape 2.49
// against 2.62 and 1.60 against 1.81, and at S=4 ~0.39-0.46 against
// 0.67-0.73.  ptxas: forward 48 registers at S=4 and 8, 128 at S=10 (56 on
// bulk copies: the producer's 19 unrolled copies a lane a tile); Viterbi 44,
// 64 and 128 (72 at S=8 and 10 on bulk copies); no spills.
// Arithmetic (crf_chain.cuh) follows crf_pallas.py exactly: from-states are
// taken in order 0..S-1 for the sum of exps, the max is exact in any order,
// lse = max + log(sum(exp(z - max))) with forbidden transitions at the
// finite NEG_BIG; invalid steps blend a = v*nxt + (1-v)*a (v is 0 or 1, so
// the blend is exact however it is contracted); the Viterbi backpointer is
// the lowest tie_rank among the maxima, the first from-state among equal
// ranks (what crf_pallas.py's strict-< scan keeps), the identity on invalid
// steps, written as int8.  The max-plus pass uses only adds and compares, so
// it is bit-equal to its plain version.
// The traceback's first design walked one read a thread over the
// time-reversed backpointers from last, the S int8 backpointers of the next
// 8 steps loaded ahead: ~145 ns a step (0.37 ms at T=2560, B=256 on 2 CTAs;
// one warp at runnie's B=24), each tile waiting one memory round trip with
// little else in flight, against a bytes' bound of 0.003 ms.  It now runs
// traceback.cuh's time-parallel walk (segments walked from every start state
// at once, their maps composed through a cluster's shared memory) with K6;
// bounded by the bytes and one segment's L dependent shared-memory look-ups.

#include <cuda_runtime.h>

#include <cstdint>

#include "crf_chain.cuh"
#include "traceback.cuh"

namespace {

using namespace flappie;

// Chain warps a CTA (besides the producer warp): 1, the fastest of 1, 2
// and 4 at S = 8 and 10 (chip_smoke.py times the others in builds with
// -DBT_WARPS=n); at most 4, as __launch_bounds__(160) allows.
#ifdef BT_WARPS
template <int S>
constexpr int kBtWarps = BT_WARPS;
#else
template <int S>
constexpr int kBtWarps = 1;
#endif
static_assert(kBtWarps<4> >= 1 && kBtWarps<4> <= 4 && kBtWarps<8> >= 1 && kBtWarps<8> <= 4 &&
                  kBtWarps<10> >= 1 && kBtWarps<10> <= 4,
              "1 to 4 chain warps a CTA");

// One chain warp's ring: R reads' S*S blocks of KT steps a tile, each read's
// block at stride P, and their valid flags.
template <int S>
struct alignas(16) BtRing {
  static constexpr int R = 32 / S;  // reads a warp
  // floats from one read's block to the next
  static constexpr int P = S == 4 ? 20 : S == 8 ? 72 : 104;
  static constexpr int CH = S * S / 4;           // 16-byte chunks of one read's block of a step
  static constexpr int NQ = (KT * R + 31) / 32;  // a tile's valid flags a producer lane
  static constexpr int NC = (KT * R * CH + 31) / 32;  // a tile's 16-byte chunks a producer lane
  static_assert(NQ <= 2, "a tile's flags take at most two producer lanes' turns");
  static_assert(P >= S * S && P % 4 == 0 && S * S % 4 == 0, "16-byte aligned blocks");
  unsigned long long full[RING], empty[RING];  // mbarriers: slot filled, slot read
  float m[RING][KT][R * P];
  int v[RING][KT][R];
};

struct BtPlan {
  int R, W, ctas, smem, P;
};

// Reads a warp, chain warps a CTA (kBtWarps, never more than the batch
// needs), CTAs, shared bytes a CTA, the ring's read stride in floats.
template <int S>
BtPlan bt_plan(int B) {
  constexpr int R = BtRing<S>::R;
  const int nw = (B + R - 1) / R;
  int W = kBtWarps<S>;
  if (W > nw) W = nw;
  if (W < 1) W = 1;
  return {R, W, (nw + W - 1) / W, W * static_cast<int>(sizeof(BtRing<S>)), BtRing<S>::P};
}

// The producer warp (the last of the CTA): fill each chain warp's ring, tile
// by tile, RING tiles ahead of it at most.  Flag e = q * 32 + lane (q < NQ)
// of a tile is step e / R's flag of read e % R; chunk e = i * 32 + lane (i
// < NC) is step k = e / (R * CH)'s chunk j = e % (R * CH) of the warp's
// contiguous R blocks, chunk j % CH of read j / CH, which lands at that
// read's stride P in the ring.  A slot's full barrier takes the 32 lanes'
// cp.async arrivals, its empty barrier the chain warp's one arrive.
template <int S>
__device__ __forceinline__ void bt_produce(BtRing<S>* rings, int W, const float* __restrict__ dense,
                                           const int* __restrict__ valid, int T, int B) {
  constexpr int R = BtRing<S>::R, P = BtRing<S>::P, CH = BtRing<S>::CH;
  const int lane = threadIdx.x & 31, w0 = blockIdx.x * W;
  int nc = 0;  // chain warps of this CTA that hold reads
  while (nc < W && (w0 + nc) * R < B) ++nc;
  const int ntile = (T + KT - 1) / KT;
  for (int tile = 0; tile < ntile; ++tile) {
    const int slot = tile % RING, fill = tile / RING;
    for (int c = 0; c < nc; ++c) {
      BtRing<S>& ring = rings[c];
      const int b0 = (w0 + c) * R;
      if (fill > 0) mbar_wait(&ring.empty[slot], (fill - 1) & 1);
#pragma unroll
      for (int q = 0; q < BtRing<S>::NQ; ++q) {
        const int e = q * 32 + lane, k = e / R, r = e % R, t = tile * KT + k;
        const bool ok = t < T && b0 + r < B;
        if (e < KT * R)
          cp_async<4>(&ring.v[slot][k][r], ok ? valid + (long)t * B + b0 + r : valid, ok ? 4 : 0);
      }
#pragma unroll
      for (int i = 0; i < BtRing<S>::NC; ++i) {
        const int e = i * 32 + lane, k = e / (R * CH), j = e % (R * CH), r = j / CH;
        const int t = tile * KT + k;
        const bool ok = t < T && b0 + r < B;
        if (e < KT * R * CH)
          cp_async<16>(&ring.m[slot][k][r * P + 4 * (j % CH)],
                       ok ? dense + ((long)t * B + b0) * S * S + 4 * j : dense, ok ? 16 : 0);
      }
      cp_async_arrive(&ring.full[slot]);
    }
  }
  cp_async_wait_all();
}

// Set up the CTA: W chain warps, each with its ring, and the producer warp
// (the last), which fills them and returns nullptr.  A chain warp gets its
// ring and first read b0, or nullptr past the batch.
template <int S>
__device__ __forceinline__ BtRing<S>* bt_chain_warp(const float* dense, const int* valid, int T,
                                                    int B, int& b0) {
  extern __shared__ __align__(16) unsigned char smem[];
  BtRing<S>* rings = reinterpret_cast<BtRing<S>*>(smem);
  const int W = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5;
  if (threadIdx.x < W * RING) {
    mbar_init(&rings[threadIdx.x / RING].full[threadIdx.x % RING], 32);
    mbar_init(&rings[threadIdx.x / RING].empty[threadIdx.x % RING], 1);
  }
  __syncthreads();  // once, before any chain starts
  if (warp == W) {
    bt_produce<S>(rings, W, dense, valid, T, B);
    return nullptr;
  }
  b0 = (blockIdx.x * W + warp) * BtRing<S>::R;
  return b0 < B ? rings + warp : nullptr;
}

// Walk a chain warp's T steps, calling step(t, k, slice, valid flags) with
// step t = tile * KT + k's blocks in the ring, and flush(t0, n) after each
// tile of n steps from t0.  Every lane of the warp calls it with the same T.
template <int S, typename Step, typename Flush>
__device__ __forceinline__ void bt_walk(BtRing<S>& ring, int T, Step&& step, Flush&& flush) {
  const int ntile = (T + KT - 1) / KT;
  for (int tile = 0; tile < ntile; ++tile) {
    const int slot = tile % RING, t0 = tile * KT, n = min(KT, T - t0);
    mbar_wait(&ring.full[slot], (tile / RING) & 1);
    if (n == KT) {
      // a whole tile: no exit test between steps, so the compiler may move
      // one step's loads into the previous step's chain
#pragma unroll
      for (int k = 0; k < KT; ++k) step(t0 + k, k, ring.m[slot][k], ring.v[slot][k]);
    } else {
      for (int k = 0; k < n; ++k) step(t0 + k, k, ring.m[slot][k], ring.v[slot][k]);
    }
    __syncwarp();  // the slot is read
    if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[slot]);
    flush(t0, n);
  }
}

// A lane's place: read r of the warp (rr: r clamped into the ring for the
// idle lanes 30-31 at S=10), to-state st, the lane holding state 0 of its
// read, the ring offset of its column in from-row 0, and whether it stores.
template <int S>
struct BtLane {
  int rr, st, base, off;
  bool live;
  __device__ __forceinline__ BtLane(int B, int b0) {
    constexpr int R = BtRing<S>::R;
    const int lane = threadIdx.x & 31, r = lane / S;
    st = lane % S;
    rr = r < R ? r : 0;
    base = r * S;
    off = rr * BtRing<S>::P + st;
    live = r < R && b0 + r < B;
  }
};

// A lane's output [T, B, S] at (t, read, state): element (t * B + b0) * S +
// lane.  put() stores it at once, or (HOLD) holds a tile of them in
// registers for flush() to store after the tile: the forward scan holds its
// outputs, the Viterbi scan stores them, the faster choice for each (header).
template <typename T, bool HOLD>
struct LaneOut {
  T* p;
  long stride;
  bool live;
  T held[KT];
  __device__ __forceinline__ LaneOut(T* out, int B, int S, int b0, bool live_)
      : p(out + (long)b0 * S + (threadIdx.x & 31)), stride((long)B * S), live(live_) {}
  __device__ __forceinline__ void put(int t, int k, T x) {
    if constexpr (HOLD)
      held[k] = x;
    else if (live)
      p[t * stride] = x;
  }
  __device__ __forceinline__ void flush(int t0, int n) {
    if constexpr (HOLD) {
      if (live)
        for (int k = 0; k < n; ++k) p[(t0 + k) * stride] = held[k];
    }
  }
};

// Sum-semiring forward scan (K11 forward): out[t] = the state after block t.
template <int S>
__global__ void __launch_bounds__(160) crf_bt_fwd_kernel(const float* __restrict__ dense,  // [T, B, S, S]
                                                         const int* __restrict__ valid,    // [T, B]
                                                         float* __restrict__ out,          // [T, B, S]
                                                         int T, int B) {
  int b0;
  BtRing<S>* ring = bt_chain_warp<S>(dense, valid, T, B, b0);
  if (!ring) return;
  const BtLane<S> L(B, b0);
  LaneOut<float, true> o(out, B, S, b0, L.live);
  float a = 0.f;
  bt_walk<S>(
      *ring, T,
      [&](int t, int k, const float* m, const int* vf) {
        const float nxt = lse_step<S>(a, L.base, [&](int f) { return m[L.off + f * S]; });
        const float v = (float)vf[L.rr];
        a = v * nxt + (1.f - v) * a;
        o.put(t, k, a);
      },
      [&](int t0, int n) { o.flush(t0, n); });
}

// Max-plus forward (K11 Viterbi): the state after every block (crf_pallas.py's
// alphas output) and int8 backpointers.
template <int S>
__global__ void __launch_bounds__(160) crf_bt_viterbi_kernel(
    const float* __restrict__ dense,  // [T, B, S, S]
    const int* __restrict__ valid,    // [T, B]
    const int* __restrict__ rank,     // [S, S] (from, to)
    float* __restrict__ alphas,       // [T, B, S]
    int8_t* __restrict__ bp_out,      // [T, B, S]
    int T, int B) {
  int b0;
  BtRing<S>* ring = bt_chain_warp<S>(dense, valid, T, B, b0);
  if (!ring) return;
  const BtLane<S> L(B, b0);
  const MaxKeys<S> mk(rank, L.st);
  LaneOut<float, false> oa(alphas, B, S, b0, L.live);
  LaneOut<int8_t, false> ob(bp_out, B, S, b0, L.live);
  float a = 0.f;
  bt_walk<S>(
      *ring, T,
      [&](int t, int k, const float* m, const int* vf) {
        int bp;
        const float best = maxplus_step<S>(a, L.base, [&](int f) { return m[L.off + f * S]; }, mk, bp);
        const float v = (float)vf[L.rr];
        a = v * best + (1.f - v) * a;
        oa.put(t, k, a);
        ob.put(t, k, (int8_t)(v != 0.f ? bp : L.st));
      },
      [&](int t0, int n) {
        oa.flush(t0, n);
        ob.flush(t0, n);
      });
}

// K11's traceback layout for traceback.cuh: backpointers [T, B, S] int8,
// already time-reversed, so walk step k is time k.  A step's R reads' R*S
// bytes are contiguous at (t*B + b0)*S, at any offset mod 4 (30 bytes at
// S=10 are no multiple of a copy's 4 or 16): WORDS aligned 4-byte words hold
// them at any offset, one cp.async each, the last word cut at the tensor's
// end (bp is 4-byte aligned).  pick() finds the step's offset again.
template <int S_>
struct BtTrace {
  static constexpr int S = S_, R = 32 / S, WORDS = (R * S + 3) / 4 + 1;
  const int8_t* bp;
  int T, B;
  __device__ __forceinline__ int time(int k) const { return k; }
  __device__ __forceinline__ void stage(unsigned* words, int k0, int n, int b0, int lane) const {
    const long long total = (long long)T * B * S;
    for (int i = lane; i < n * WORDS; i += 32) {
      const int k = i / WORDS, j = i - k * WORDS;
      const long long w = ((((long long)(k0 + k) * B + b0) * S) & ~3LL) + 4 * j;
      const long long left = total - w;
      const int bytes = left >= 4 ? 4 : left > 0 ? (int)left : 0;
      cp_async<4>(words + i, bytes ? bp + w : bp, bytes);
    }
  }
  __device__ __forceinline__ int pick(const unsigned* w, int k, int b0, int rr, int s) const {
    const unsigned off = (((unsigned)k * (unsigned)B + (unsigned)b0) * (unsigned)S) & 3u;
    return reinterpret_cast<const unsigned char*>(w)[off + rr * S + s];
  }
};

// Launch a chain kernel (K11 forward or Viterbi) at bt_plan<S>(B); the
// 16-byte copies need ``dense`` on a 16-byte boundary.  Returns the launch
// error code.
template <int S, typename Kernel, typename... Args>
int launch_chain(int B, const float* dense, cudaStream_t st, Kernel kernel, Args... args) {
  if (reinterpret_cast<std::uintptr_t>(dense) % 16 != 0) return cudaErrorMisalignedAddress;
  const BtPlan plan = bt_plan<S>(B);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  kernel<<<plan.ctas, 32 * (plan.W + 1), plan.smem, st>>>(args...);
  return cudaGetLastError();
}

template <int S>
int launch_fwd(const float* dense, const int* valid, float* out, int T, int B,
               cudaStream_t st) {
  return launch_chain<S>(B, dense, st, crf_bt_fwd_kernel<S>, dense, valid, out, T, B);
}

template <int S>
int launch_viterbi(const float* dense, const int* valid, const int* rank, float* alphas,
                   int8_t* bp, int T, int B, cudaStream_t st) {
  return launch_chain<S>(B, dense, st, crf_bt_viterbi_kernel<S>, dense, valid, rank, alphas, bp,
                         T, B);
}

template <int S>
int launch_traceback(const int8_t* bp, const int* valid, const int* last, int* out, int T, int B,
                     cudaStream_t st) {
  if (reinterpret_cast<std::uintptr_t>(bp) % 4 != 0) return cudaErrorMisalignedAddress;
  if (T == 0) return 0;
  return tb_launch(tb_plan(T, S, B, BtTrace<S>::WORDS), BtTrace<S>{bp, T, B}, valid, last, out, T,
                   B, 0, st);
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The plan of the forward and Viterbi chain kernels for S states and B
// reads: info = {reads a warp, chain warps a CTA, CTAs, shared bytes a CTA,
// floats from one read's block to the next in the ring}.
extern "C" int flappie_crf_bt_info(int S, int B, int* info) {
  if (S != 4 && S != 8 && S != 10) return cudaErrorInvalidValue;
  const BtPlan p = S == 4 ? bt_plan<4>(B) : S == 8 ? bt_plan<8>(B) : bt_plan<10>(B);
  info[0] = p.R;
  info[1] = p.W;
  info[2] = p.ctas;
  info[3] = p.smem;
  info[4] = p.P;
  return 0;
}

// S = 4 (the V1 run-length chain), 8 (flip-flop and run-length V2 over 4
// bases) and S = 10 (5 bases) are compiled.
extern "C" int flappie_crf_bt_fwd(const float* dense, const int* valid, float* out, int T,
                                  int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_fwd<4>(dense, valid, out, T, B, st);
  if (S == 8) return launch_fwd<8>(dense, valid, out, T, B, st);
  if (S == 10) return launch_fwd<10>(dense, valid, out, T, B, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_bt_viterbi(const float* dense, const int* valid, const int* rank,
                                      float* alphas, int8_t* bp, int T, int S, int B,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_viterbi<4>(dense, valid, rank, alphas, bp, T, B, st);
  if (S == 8) return launch_viterbi<8>(dense, valid, rank, alphas, bp, T, B, st);
  if (S == 10) return launch_viterbi<10>(dense, valid, rank, alphas, bp, T, B, st);
  return cudaErrorInvalidValue;
}

// The plan of K11's traceback (traceback.cuh) over T steps, S states and B
// reads: info as flappie_crf_traceback_info's.
extern "C" int flappie_crf_bt_traceback_info(int T, int S, int B, int* info) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  if (S == 4) return tb_info<BtTrace<4>>(T, B, info);
  if (S == 8) return tb_info<BtTrace<8>>(T, B, info);
  if (S == 10) return tb_info<BtTrace<10>>(T, B, info);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_bt_traceback(const int8_t* bp, const int* valid, const int* last,
                                        int* out, int T, int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 4) return launch_traceback<4>(bp, valid, last, out, T, B, st);
  if (S == 8) return launch_traceback<8>(bp, valid, last, out, T, B, st);
  if (S == 10) return launch_traceback<10>(bp, valid, last, out, T, B, st);
  return cudaErrorInvalidValue;
}
