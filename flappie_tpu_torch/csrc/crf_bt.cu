// Batch-major CRF scans (K11) for Hopper, sm_90a.
//
// Replaces, in flappie_tpu/ops/crf_pallas.py:
//   crf_bt_fwd_kernel       <- _fwd_kernel:45 via fwd_scan_pallas:153 (the sum
//                              scan; the backward pass runs it on transposed,
//                              time-reversed blocks, ops/crf.py crf_backward);
//   crf_bt_viterbi_kernel   <- _viterbi_kernel:73 via viterbi_scan_pallas:178;
//   crf_bt_traceback_kernel <- _traceback_kernel:115 via traceback_pallas:217.
//
// Layout is crf_pallas.py's batch-major one: transition blocks [T, B, S, S]
// (step, read, from, to: one read's S*S weights of a step are contiguous),
// validity [T, B], states [T, B, S] -- the state AFTER each block, with no
// alpha_0 row.  The kernels read it as it is; nothing is transposed to the
// batch-minor layout of csrc/crf_scan.cu.
//
// What bounds them on this card: as for K3/K5/K6 (crf_scan.cu), not bytes
// (T.B.S.S.4 B = 168 MB at T=2560, B=256, S=8: ~50 us of HBM time) and not
// arithmetic, but the serial chain over T.  The frame is K3's:
//  - sum / Viterbi: a block holds 32 reads x S states, one thread per (state,
//    read); the S states of a read are exchanged through shared memory
//    (double-buffered, one __syncthreads per step), and each thread loads the
//    weights of the next KT steps into registers while it computes the
//    current KT, so no step waits on DRAM.  Thread (to, x) reads the
//    from-column m[b][0..S-1][to] of its read's contiguous S*S block.  The
//    state is the fastest thread index: a warp's load of one from-row then
//    covers whole rows of consecutive reads (4 sectors at S=8), where a warp
//    of 32 reads at one state touched 32 sectors a load and ran 2.4x slower
//    (3.5 against K3's 1.5 ms at T=2560, B=256 on an H100 SXM at 700 W, timed
//    by chip_smoke.py); the shared state is laid out
//    [read][state] for the same reason, so neither its reads nor its writes
//    conflict on a bank;
//  - traceback: one thread per read walks the time-reversed backpointers
//    from last; the S int8 backpointers of the next KT steps are loaded ahead
//    (they do not depend on the walk) and the walk selects among registers.
// Arithmetic follows crf_pallas.py exactly: from-states are taken in order
// 0..S-1 for the max and for the sum of exps, lse = max + log(sum(exp(z -
// max))) with forbidden transitions at the finite NEG_BIG; invalid steps blend
// a = v*nxt + (1-v)*a (v is 0 or 1, so the blend is exact however it is
// contracted); the Viterbi backpointer is the lowest tie_rank among the
// maxima, scanned per from-state with a strict <, the identity on invalid
// steps, written as int8.  The max-plus pass uses only adds and compares, so
// it is bit-equal to its plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 32;  // reads per block (threadIdx.y; the state is threadIdx.x)
constexpr int RANK_BIG = 1000000;

template <int S>
struct Tile {
  static constexpr int KT = S <= 8 ? 8 : 4;  // steps loaded ahead
};

// mm[k][f] = dense[t0 + k, b, f, to] and vv[k] = valid[t0 + k, b] for the KT
// steps from t0 (zeros past T or for a dead lane).
template <int S, int KT>
__device__ __forceinline__ void load_cols(const float* __restrict__ dense,
                                          const int* __restrict__ valid, int t0, int T,
                                          int B, int b, bool live, int to,
                                          float (&mm)[KT][S], float (&vv)[KT]) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int t = t0 + k;
    const bool ok = live && t < T;
    const long base = (((long)t * B + b) * S) * S + to;
    vv[k] = ok ? (float)valid[(long)t * B + b] : 0.f;
#pragma unroll
    for (int f = 0; f < S; ++f) mm[k][f] = ok ? dense[base + f * S] : 0.f;
  }
}

template <int S, int KT>
__device__ __forceinline__ void shift_tile(float (&m)[KT][S], float (&v)[KT],
                                           const float (&mn)[KT][S], const float (&vn)[KT]) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    v[k] = vn[k];
#pragma unroll
    for (int f = 0; f < S; ++f) m[k][f] = mn[k][f];
  }
}

// Sum-semiring forward scan; one thread per (to-state, read), the state fastest.
template <int S>
__global__ void crf_bt_fwd_kernel(const float* __restrict__ dense,  // [T, B, S, S]
                                  const int* __restrict__ valid,    // [T, B]
                                  float* __restrict__ out,          // [T, B, S]
                                  int T, int B) {
  constexpr int KT = Tile<S>::KT;
  __shared__ float a_s[2][RB][S];
  const int to = threadIdx.x, x = threadIdx.y;
  const int b = blockIdx.x * RB + x;
  const bool live = b < B;
  float a = 0.f;
  a_s[0][x][to] = 0.f;

  float m[KT][S], mn[KT][S], v[KT], vn[KT];
  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_cols<S, KT>(dense, valid, 0, T, B, b, live, to, m, v);
  __syncthreads();
  int cur = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile)
      load_cols<S, KT>(dense, valid, (tile + 1) * KT, T, B, b, live, to, mn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      if (t >= T) break;  // uniform across the block
      float z[S];
#pragma unroll
      for (int f = 0; f < S; ++f) z[f] = a_s[cur][x][f] + m[k][f];
      float mx = z[0];
#pragma unroll
      for (int f = 1; f < S; ++f) mx = fmaxf(mx, z[f]);
      float sum = 0.f;
#pragma unroll
      for (int f = 0; f < S; ++f) sum += expf(z[f] - mx);
      const float nxt = mx + logf(sum);
      a = v[k] * nxt + (1.f - v[k]) * a;
      if (live) out[((long)t * B + b) * S + to] = a;
      a_s[cur ^ 1][x][to] = a;
      cur ^= 1;
      __syncthreads();
    }
    shift_tile<S, KT>(m, v, mn, vn);
  }
}

// Max-plus forward; one thread per (to-state, read), the state fastest.  Writes
// the state after every block (crf_pallas.py's alphas output) and int8
// backpointers.
template <int S>
__global__ void crf_bt_viterbi_kernel(const float* __restrict__ dense,  // [T, B, S, S]
                                      const int* __restrict__ valid,    // [T, B]
                                      const int* __restrict__ rank,     // [S, S] (from, to)
                                      float* __restrict__ alphas,       // [T, B, S]
                                      int8_t* __restrict__ bp_out,      // [T, B, S]
                                      int T, int B) {
  constexpr int KT = Tile<S>::KT;
  __shared__ float a_s[2][RB][S];
  __shared__ int rk[S][S];
  const int to = threadIdx.x, x = threadIdx.y;
  const int b = blockIdx.x * RB + x;
  const bool live = b < B;
  for (int i = x * S + to; i < S * S; i += RB * S) rk[i / S][i % S] = rank[i];
  float a = 0.f;
  a_s[0][x][to] = 0.f;

  float m[KT][S], mn[KT][S], v[KT], vn[KT];
  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_cols<S, KT>(dense, valid, 0, T, B, b, live, to, m, v);
  __syncthreads();
  int cur = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile)
      load_cols<S, KT>(dense, valid, (tile + 1) * KT, T, B, b, live, to, mn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      if (t >= T) break;  // uniform across the block
      float z[S];
#pragma unroll
      for (int f = 0; f < S; ++f) z[f] = a_s[cur][x][f] + m[k][f];
      float best = z[0];
#pragma unroll
      for (int f = 1; f < S; ++f) best = fmaxf(best, z[f]);
      int minrank = RANK_BIG, bp = 0;
#pragma unroll
      for (int f = 0; f < S; ++f) {
        const int rf = z[f] == best ? rk[f][to] : RANK_BIG;
        if (rf < minrank) {
          minrank = rf;
          bp = f;
        }
      }
      a = v[k] * best + (1.f - v[k]) * a;
      if (live) {
        const long o = ((long)t * B + b) * S + to;
        alphas[o] = a;
        bp_out[o] = (int8_t)(v[k] != 0.f ? bp : to);
      }
      a_s[cur ^ 1][x][to] = a;
      cur ^= 1;
      __syncthreads();
    }
    shift_tile<S, KT>(m, v, mn, vn);
  }
}

// Serial walk over time-reversed backpointers; one thread per read.
// out[k] is the state before block T-1-k.
template <int S>
__global__ void crf_bt_traceback_kernel(const int8_t* __restrict__ bp,  // [T, B, S], reversed
                                        const int* __restrict__ valid,  // [T, B], reversed
                                        const int* __restrict__ last,   // [B]
                                        int* __restrict__ out,          // [T, B]
                                        int T, int B) {
  constexpr int KT = Tile<S>::KT;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = last[b];
  int p[KT][S], pn[KT][S], v[KT], vn[KT];
  auto load_tile = [&](int tile, int (&pp)[KT][S], int (&vv)[KT]) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      const bool ok = t < T;
      vv[k] = ok ? valid[(long)t * B + b] : 0;
#pragma unroll
      for (int q = 0; q < S; ++q) pp[k][q] = ok ? (int)bp[((long)t * B + b) * S + q] : 0;
    }
  };
  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_tile(0, p, v);
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) load_tile(tile + 1, pn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      if (t >= T) break;
      int prev = p[k][0];
#pragma unroll
      for (int q = 1; q < S; ++q) prev = s == q ? p[k][q] : prev;
      s = v[k] ? prev : s;
      out[(long)t * B + b] = s;
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      v[k] = vn[k];
#pragma unroll
      for (int q = 0; q < S; ++q) p[k][q] = pn[k][q];
    }
  }
}

template <int S>
int launch_fwd(const float* dense, const int* valid, float* out, int T, int B,
               cudaStream_t st) {
  crf_bt_fwd_kernel<S><<<(B + RB - 1) / RB, dim3(S, RB), 0, st>>>(dense, valid, out, T, B);
  return cudaGetLastError();
}

template <int S>
int launch_viterbi(const float* dense, const int* valid, const int* rank, float* alphas,
                   int8_t* bp, int T, int B, cudaStream_t st) {
  crf_bt_viterbi_kernel<S><<<(B + RB - 1) / RB, dim3(S, RB), 0, st>>>(dense, valid, rank,
                                                                       alphas, bp, T, B);
  return cudaGetLastError();
}

template <int S>
int launch_traceback(const int8_t* bp, const int* valid, const int* last, int* out, int T,
                     int B, cudaStream_t st) {
  crf_bt_traceback_kernel<S><<<(B + 127) / 128, 128, 0, st>>>(bp, valid, last, out, T, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// S = 8 (flip-flop and run-length over 4 bases) and S = 10 (5 bases) are compiled.
extern "C" int flappie_crf_bt_fwd(const float* dense, const int* valid, float* out, int T,
                                  int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 8) return launch_fwd<8>(dense, valid, out, T, B, st);
  if (S == 10) return launch_fwd<10>(dense, valid, out, T, B, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_bt_viterbi(const float* dense, const int* valid, const int* rank,
                                      float* alphas, int8_t* bp, int T, int S, int B,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 8) return launch_viterbi<8>(dense, valid, rank, alphas, bp, T, B, st);
  if (S == 10) return launch_viterbi<10>(dense, valid, rank, alphas, bp, T, B, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_bt_traceback(const int8_t* bp, const int* valid, const int* last,
                                        int* out, int T, int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 8) return launch_traceback<8>(bp, valid, last, out, T, B, st);
  if (S == 10) return launch_traceback<10>(bp, valid, last, out, T, B, st);
  return cudaErrorInvalidValue;
}
