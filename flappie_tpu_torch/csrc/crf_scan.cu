// Batch-minor CRF decode scans (K3/K4, K9, K5, K6) for Hopper, sm_90a.
//
// Replaces, in flappie_tpu/ops/crf_bm_pallas.py:
//   crf_sum_kernel       <- _sum_kernel:69 (one kernel, direction flag), reached
//                           through fwd_states_pallas:194 (K3) and
//                           bwd_states_pallas:218 (K4);
//   crf_fwdbwd_kernel    <- _fwdbwd_kernel:95 via fwdbwd_states_pallas:251 (K9:
//                           K3's and K4's chains interleaved in one launch);
//   crf_viterbi_kernel   <- _viterbi_kernel:135 via viterbi_fwd_pallas:300 (K5);
//   crf_traceback_kernel <- _traceback_kernel:170 via traceback_pallas:333 (K6).
//
// Layout is the JAX package's batch-minor one: dense transition blocks
// [T, S, S, B] (from, to, read), validity [T, B], states [T+1, S, B].
//
// What bounds them on this card: not bytes (the dense input is T.S.S.B.4 B =
// 168 MB at T=2560, S=8, B=256: ~50 us of HBM time) and not arithmetic
// (~50 flops per (step, state, read)), but the serial chain over T: every
// step needs the previous step's S states of the same read.  The design keeps
// that chain short and never waits on memory inside it:
//  - sum / Viterbi: a block holds 32 reads x S states, one thread per
//    (state, read); the S states of a read are exchanged through shared
//    memory (double-buffered, one __syncthreads per step), and each thread
//    loads the transition weights it needs for the next KT steps into
//    registers while it computes the current KT, so no step waits on DRAM;
//  - traceback: one thread per read walks back from last_state; the S
//    backpointers of the next KT steps are loaded ahead (they do not depend
//    on the walk) and the walk selects among registers.
// Arithmetic follows the TPU kernels exactly: lse = max + log(sum(exp(z -
// max))) with forbidden transitions at the finite NEG_BIG; invalid steps
// blend a = v*nxt + (1-v)*a (crf_bm_pallas.py:88); the Viterbi backpointer is
// the lowest tie_rank among the maxima, scanned per from-state
// (crf_bm_pallas.py:153-157), identity on invalid steps.  The max-plus pass
// uses only adds and compares, so it is bit-equal to its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int RB = 32;           // reads per block (threadIdx.x)
constexpr int FB_RB = 16;        // reads per block of the fused K9
constexpr int RANK_BIG = 1000000;

template <int S>
struct Tile {
  static constexpr int KT = S <= 8 ? 8 : 4;  // steps loaded ahead
};

// One chain of the sum-semiring scan, run by a group of NR x S threads: one
// thread per (state st, read b = the group's read x).  Forward: st is the
// to-state and the thread reduces over from-states j of alpha_t[j] +
// m_t[j][st].  Backward: st is the from-state and the thread reduces over
// to-states j of m_t[st][j] + beta_{t+1}[j], walking t from T-1 down.  Every
// thread of the block calls it once, with the same T, so its __syncthreads
// match across groups.
template <int S, int NR>
__device__ __forceinline__ void sum_chain(const float* __restrict__ dense,  // [T, S, S, B]
                                          const int* __restrict__ valid,    // [T, B]
                                          float* __restrict__ out,          // [T+1, S, B]
                                          int T, int B, int b, int x, int st, bool backward,
                                          float (&a_s)[2][S][NR]) {
  constexpr int KT = Tile<S>::KT;
  const bool live = b < B;
  float a = 0.f;
  a_s[0][st][x] = 0.f;
  if (live) out[((long)(backward ? T : 0) * S + st) * B + b] = 0.f;

  float m[KT][S], mn[KT][S], v[KT], vn[KT];
  auto load_tile = [&](int tile, float (&mm)[KT][S], float (&vv)[KT]) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int s = tile * KT + k;
      const bool ok = live && s < T;
      const int t = backward ? T - 1 - s : s;
      vv[k] = ok ? (float)valid[(long)t * B + b] : 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const long idx = backward ? (((long)t * S + st) * S + j) * B + b
                                  : (((long)t * S + j) * S + st) * B + b;
        mm[k][j] = ok ? dense[idx] : 0.f;
      }
    }
  };

  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_tile(0, m, v);
  __syncthreads();
  int cur = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) load_tile(tile + 1, mn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int s = tile * KT + k;
      if (s >= T) break;  // uniform across the block
      const int t = backward ? T - 1 - s : s;
      float z[S];
#pragma unroll
      for (int j = 0; j < S; ++j) z[j] = a_s[cur][j][x] + m[k][j];
      float mx = z[0];
#pragma unroll
      for (int j = 1; j < S; ++j) mx = fmaxf(mx, z[j]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j) sum += expf(z[j] - mx);
      const float nxt = mx + logf(sum);
      a = v[k] * nxt + (1.f - v[k]) * a;
      if (live) out[((long)(backward ? t : t + 1) * S + st) * B + b] = a;
      a_s[cur ^ 1][st][x] = a;
      cur ^= 1;
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      v[k] = vn[k];
#pragma unroll
      for (int j = 0; j < S; ++j) m[k][j] = mn[k][j];
    }
  }
}

// K3/K4: one chain, 32 reads x S states a block.
template <int S>
__global__ void crf_sum_kernel(const float* __restrict__ dense, const int* __restrict__ valid,
                               float* __restrict__ out, int T, int B, int backward) {
  __shared__ float a_s[2][S][RB];
  sum_chain<S, RB>(dense, valid, out, T, B, blockIdx.x * RB + threadIdx.x, threadIdx.x,
                   threadIdx.y, backward != 0, a_s);
}

// K9: the alpha chain (threadIdx.z = 0) and the beta chain (threadIdx.z = 1)
// of the same FB_RB reads in one block.  Each group runs K3's/K4's own step
// code (sum_chain), so the outputs are bit-equal to theirs by construction;
// the two chains share each step's barrier.  FB_RB = 16 keeps the block at
// K3's 256 threads (S=8), within K3's register budget per thread.
template <int S>
__global__ void crf_fwdbwd_kernel(const float* __restrict__ dense,
                                  const int* __restrict__ valid,
                                  float* __restrict__ alphas,  // [T+1, S, B]
                                  float* __restrict__ betas,   // [T+1, S, B]
                                  int T, int B) {
  __shared__ float a_s[2][2][S][FB_RB];
  const int chain = threadIdx.z;
  sum_chain<S, FB_RB>(dense, valid, chain ? betas : alphas, T, B,
                      blockIdx.x * FB_RB + threadIdx.x, threadIdx.x, threadIdx.y, chain != 0,
                      a_s[chain]);
}

// Max-plus forward; one thread per (to-state, read).
template <int S>
__global__ void crf_viterbi_kernel(const float* __restrict__ dense,  // [T, S, S, B]
                                   const int* __restrict__ valid,    // [T, B]
                                   const int* __restrict__ rank,     // [S, S] (from, to)
                                   float* __restrict__ alpha_out,    // [S, B]
                                   int* __restrict__ bp_out,         // [T, S, B]
                                   int T, int B) {
  constexpr int KT = Tile<S>::KT;
  __shared__ float a_s[2][S][RB];
  __shared__ int rk[S][S];
  const int x = threadIdx.x, to = threadIdx.y;
  const int b = blockIdx.x * RB + x;
  const bool live = b < B;
  for (int i = to * RB + x; i < S * S; i += RB * S) rk[i / S][i % S] = rank[i];
  float a = 0.f;
  a_s[0][to][x] = 0.f;

  float m[KT][S], mn[KT][S], v[KT], vn[KT];
  auto load_tile = [&](int tile, float (&mm)[KT][S], float (&vv)[KT]) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      const bool ok = live && t < T;
      vv[k] = ok ? (float)valid[(long)t * B + b] : 0.f;
#pragma unroll
      for (int j = 0; j < S; ++j)
        mm[k][j] = ok ? dense[(((long)t * S + j) * S + to) * B + b] : 0.f;
    }
  };

  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_tile(0, m, v);
  __syncthreads();
  int cur = 0;
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) load_tile(tile + 1, mn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = tile * KT + k;
      if (t >= T) break;  // uniform across the block
      float z[S];
#pragma unroll
      for (int f = 0; f < S; ++f) z[f] = a_s[cur][f][x] + m[k][f];
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
      if (live) bp_out[((long)t * S + to) * B + b] = v[k] != 0.f ? bp : to;
      a_s[cur ^ 1][to][x] = a;
      cur ^= 1;
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      v[k] = vn[k];
#pragma unroll
      for (int j = 0; j < S; ++j) m[k][j] = mn[k][j];
    }
  }
  if (live) alpha_out[(long)to * B + b] = a;
}

// Serial backpointer walk; one thread per read.
template <int S>
__global__ void crf_traceback_kernel(const int* __restrict__ bp,     // [T, S, B]
                                     const int* __restrict__ valid,  // [T, B]
                                     const int* __restrict__ last,   // [B]
                                     int* __restrict__ out,          // [T+1, B]
                                     int T, int B) {
  constexpr int KT = Tile<S>::KT;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int s = last[b];
  out[(long)T * B + b] = s;
  int p[KT][S], pn[KT][S], v[KT], vn[KT];
  auto load_tile = [&](int tile, int (&pp)[KT][S], int (&vv)[KT]) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = T - 1 - (tile * KT + k);
      const bool ok = t >= 0;
      vv[k] = ok ? valid[(long)t * B + b] : 0;
#pragma unroll
      for (int q = 0; q < S; ++q) pp[k][q] = ok ? bp[((long)t * S + q) * B + b] : 0;
    }
  };
  const int ntile = (T + KT - 1) / KT;
  if (ntile > 0) load_tile(0, p, v);
  for (int tile = 0; tile < ntile; ++tile) {
    if (tile + 1 < ntile) load_tile(tile + 1, pn, vn);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int t = T - 1 - (tile * KT + k);
      if (t < 0) break;
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
int launch_sum(const float* dense, const int* valid, float* out, int T, int B,
               int backward, cudaStream_t st) {
  crf_sum_kernel<S><<<(B + RB - 1) / RB, dim3(RB, S), 0, st>>>(dense, valid, out, T, B,
                                                                backward);
  return cudaGetLastError();
}

template <int S>
int launch_fwdbwd(const float* dense, const int* valid, float* alphas, float* betas, int T,
                  int B, cudaStream_t st) {
  crf_fwdbwd_kernel<S><<<(B + FB_RB - 1) / FB_RB, dim3(FB_RB, S, 2), 0, st>>>(
      dense, valid, alphas, betas, T, B);
  return cudaGetLastError();
}

template <int S>
int launch_viterbi(const float* dense, const int* valid, const int* rank,
                   float* alpha, int* bp, int T, int B, cudaStream_t st) {
  crf_viterbi_kernel<S><<<(B + RB - 1) / RB, dim3(RB, S), 0, st>>>(dense, valid, rank,
                                                                    alpha, bp, T, B);
  return cudaGetLastError();
}

template <int S>
int launch_traceback(const int* bp, const int* valid, const int* last, int* out,
                     int T, int B, cudaStream_t st) {
  crf_traceback_kernel<S><<<(B + 127) / 128, 128, 0, st>>>(bp, valid, last, out, T, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// S = 8 (flip-flop over 4 bases) and S = 10 (5 bases) are compiled.
extern "C" int flappie_crf_sum(const float* dense, const int* valid, float* out, int T,
                               int S, int B, int backward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
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
  if (S == 8) return launch_viterbi<8>(dense, valid, rank, alpha, bp, T, B, st);
  if (S == 10) return launch_viterbi<10>(dense, valid, rank, alpha, bp, T, B, st);
  return cudaErrorInvalidValue;
}

extern "C" int flappie_crf_traceback(const int* bp, const int* valid, const int* last,
                                     int* out, int T, int S, int B, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (S == 8) return launch_traceback<8>(bp, valid, last, out, T, B, st);
  if (S == 10) return launch_traceback<10>(bp, valid, last, out, T, B, st);
  return cudaErrorInvalidValue;
}
