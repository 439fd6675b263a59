// Fused GRU-mod layer (K7) for Hopper, sm_90a.
//
// Replaces flappie_tpu/ops/rnn_pallas.py:290 _grumod_fused_kernel (its
// bit-equal two-chain twin _grumod_fused_dual_kernel :386 is TPU scheduling
// and is covered too), reached through grumod_layer_tm:578.
//
// Work per layer: the block input affine xa = x.iW + b over [T*B, IN] x
// [IN, 3H], then T dependent steps of (gate order z, r, hbar)
//   v = h.sW,  z = sig(xa_z + v_z),  r = sig(xa_r + v_r),
//   hbar = tanh(r*v_h + xa_h),  h = z*h + (1-z)*hbar.
// The candidate's input term xa_h is added AFTER the multiply by r: it must
// never be summed into v (reference src/layers.c:664-715 zeroes that third
// of xF before the sgemv).  At T=2560, B=256, IN=H=256 that is
// 2.T.B.(IN+H).3H ~ 515 GFLOP of f32 FMA.
//
// What bounds it on this card: as for K1 (lstm.cu), true f32, so no tensor
// cores: the affine half is bound by the f32 CUDA-core rate; the recurrent
// half is a chain of T steps, each of which must read all of sW.  sW is
// H.3H.4 B = 768 KiB, more than one block's 227 KB of shared memory, so it
// is read from L2 (where it stays resident) once per step per block.
//
// Design (simple and right first; K1's frame):
//  1. affine_kernel (affine.cuh, shared with K1) writes xa [T, B, 3H].
//  2. grumod_recurrence_kernel splits the batch across blocks of R=8 rows;
//     each block walks all T steps.  Its 3H/2 threads split the product
//     h.sW in two halves of the k range; each thread owns 4 consecutive of
//     the 3H gate columns (3H/4 threads per half), reads them as one float4
//     of sW per k through L2 with h broadcast from shared memory, and keeps
//     4R independent FMA chains.  In the first half only the z and r
//     columns start from xa; the candidate columns start from 0 and park
//     their xa_h in shared memory (xh_s) for the update.  After one
//     barrier every thread updates (row, unit) cells in a strided loop: it
//     reads the cell's old h from h_s, then writes the new one (each cell
//     has one owner, and no thread reads h_s for the product until the
//     second barrier).  The next step's xa is loaded before the current
//     step's sW loop.  Backward layers walk t from T-1 down; a step at or
//     past a read's length freezes h and writes 0 (rnn_pallas.py:307-317).
// The cluster / distributed-shared-memory design that keeps sW on chip is
// later work, as for K1.
//
// K12's GRU-mod half (flappie_grumod_seq) replaces rnn_pallas.py:69
// _grumod_kernel (its pallas_call at :129 in _run_recurrent:113), reached
// through grumod_seq_pallas:149: the recurrence alone over a caller's
// affine, batch-major [B, T, 3H] -> [B, T, H], forward, zero initial state,
// no length mask.  As in lstm.cu, the same recurrence kernel under a
// BATCH_MAJOR template flag (K7's instantiation unchanged), with lengths
// all equal to T.  Bound: operations, 2.T.B.H.3H of f32 FMA (257.7 GFLOP
// at T=2560, B=256, H=256).

#include <cuda_runtime.h>

#include "affine.cuh"

namespace {

using flappie::sigmoidf_;

constexpr int ROWS = 8;         // batch rows per recurrence block
constexpr int MAX_THREADS = 384;  // 3H/2 at H = 256

template <int R, bool BATCH_MAJOR>
__global__ void __launch_bounds__(MAX_THREADS)
grumod_recurrence_kernel(const float* __restrict__ xa,     // [T, B, 3H] or [B, T, 3H]
                         const float* __restrict__ sW,     // [H, 3H]
                         const int* __restrict__ lengths,  // [B]
                         float* __restrict__ out,          // [T, B, H] or [B, T, H]
                         int T, int B, int H, int backward) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int len_s[R];
  const int G = 3 * H;
  const int NT = G / 4;           // threads per half of the k range
  float* h_s = smem;              // [H][R]: h of the block's rows, unit-major
  float* xh_s = h_s + H * R;      // [R][H]: this step's candidate input term
  float* g_s = xh_s + R * H;      // [2][R][3H]: the two halves' partial sums
  const int tid = threadIdx.x;    // blockDim.x == 2 * NT
  const int nthreads = blockDim.x;
  const int half = tid / NT;
  const int col = 4 * (tid % NT);
  const int k0 = half * (H / 2), k1 = k0 + H / 2;
  const int row0 = blockIdx.x * R;
  const bool seed = half == 0 && col < 2 * H;   // z, r columns start from xa
  const bool cand = half == 0 && col >= 2 * H;  // candidate columns park xa_h
  // row-major offsets of (t, row) in xa (in units of G) and out (of H):
  // time-major [T, B, .] (K7) or batch-major [B, T, .] (K12)
  auto at = [&](int t, int row) {
    return BATCH_MAJOR ? (long)row * T + t : (long)t * B + row;
  };

  for (int i = tid; i < H * R; i += nthreads) h_s[i] = 0.f;
  if (tid < R) len_s[tid] = row0 + tid < B ? lengths[row0 + tid] : 0;
  float4 nx[R];
  auto load_xa = [&](int t) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      nx[r] = (row < B && half == 0)
                  ? *reinterpret_cast<const float4*>(xa + at(t, row) * G + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (T > 0) load_xa(backward ? T - 1 : 0);
  __syncthreads();
  const float4* w = reinterpret_cast<const float4*>(sW + col);
  float* g_mine = g_s + half * R * G;

  for (int s = 0; s < T; ++s) {
    const int t = backward ? T - 1 - s : s;
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = seed ? nx[r] : make_float4(0.f, 0.f, 0.f, 0.f);
      // xh_s was last read in the previous step's update, before its
      // closing barrier
      if (cand) *reinterpret_cast<float4*>(xh_s + r * H + col - 2 * H) = nx[r];
    }
    if (s + 1 < T) load_xa(backward ? t - 1 : t + 1);
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float4 wv = __ldg(w + (long)k * (G / 4));
      float hr[R];
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 hv = *reinterpret_cast<const float4*>(h_s + k * R + 4 * r4);
        hr[4 * r4 + 0] = hv.x;
        hr[4 * r4 + 1] = hv.y;
        hr[4 * r4 + 2] = hv.z;
        hr[4 * r4 + 3] = hv.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x = fmaf(hr[r], wv.x, acc[r].x);
        acc[r].y = fmaf(hr[r], wv.y, acc[r].y);
        acc[r].z = fmaf(hr[r], wv.z, acc[r].z);
        acc[r].w = fmaf(hr[r], wv.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) *reinterpret_cast<float4*>(g_mine + r * G + col) = acc[r];
    __syncthreads();
    for (int i = tid; i < R * H; i += nthreads) {
      const int r = i / H, j = i % H;
      const int row = row0 + r;
      const float* ga = g_s + r * G;
      const float* gb = g_s + (R + r) * G;
      const float z = sigmoidf_(ga[j] + gb[j]);
      const float rg = sigmoidf_(ga[H + j] + gb[H + j]);
      const float hbar = tanhf(rg * (ga[2 * H + j] + gb[2 * H + j]) + xh_s[r * H + j]);
      const float h_old = h_s[j * R + r];
      const float h2 = z * h_old + (1.f - z) * hbar;
      const bool valid = t < len_s[r];
      if (row < B) out[at(t, row) * H + j] = valid ? h2 : 0.f;
      if (valid) h_s[j * R + r] = h2;
    }
    __syncthreads();
  }
}

// The recurrence alone over xa; returns the launch error code.  Needs
// H % 16 == 0 and H <= 256.
template <bool BATCH_MAJOR>
cudaError_t launch_recurrence(const float* xa, const float* sW, const int* lengths, float* out,
                              int T, int B, int H, int backward, cudaStream_t st) {
  if (H % 16 != 0 || 3 * H / 2 > MAX_THREADS) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * H * ROWS + 2 * ROWS * 3 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(grumod_recurrence_kernel<ROWS, BATCH_MAJOR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + ROWS - 1) / ROWS;
  grumod_recurrence_kernel<ROWS, BATCH_MAJOR><<<blocks, 3 * H / 2, smem, st>>>(
      xa, sW, lengths, out, T, B, H, backward);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One fused layer: affine into the xa scratch [T*B, 3H], then the
// recurrence into out [T, B, H].  Needs H % 16 == 0 and H <= 256.
// Returns the launch error code (0 = ok).
extern "C" int flappie_grumod_layer(const float* x, const float* iW, const float* b,
                                    const float* sW, const int* lengths, float* xa,
                                    float* out, int T, int B, int IN, int H,
                                    int backward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)T * B;
  if (M == 0) return 0;
  if (H % 16 != 0 || 3 * H / 2 > MAX_THREADS) return cudaErrorInvalidValue;
  const cudaError_t err = flappie::launch_affine(x, iW, b, xa, M, 3 * H, IN, st);
  if (err != cudaSuccess) return err;
  return launch_recurrence<false>(xa, sW, lengths, out, T, B, H, backward, st);
}

// K12 (GRU-mod): the recurrence alone over a caller's affine, batch-major
// xa [B, T, 3H] -> out [B, T, H], forward, zero initial state, no length
// mask: the caller passes lengths [B] all equal to T.  Needs H % 16 == 0
// and H <= 256.  Returns the launch error code.
extern "C" int flappie_grumod_seq(const float* xa, const float* sW, const int* lengths,
                                  float* out, int T, int B, int H, void* stream) {
  if ((long)T * B == 0) return 0;
  return launch_recurrence<true>(xa, sW, lengths, out, T, B, H, 0,
                                 static_cast<cudaStream_t>(stream));
}
