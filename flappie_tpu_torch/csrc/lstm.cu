// Fused LSTM layer (K1) for Hopper, sm_90a.
//
// Replaces flappie_tpu/ops/rnn_pallas.py:273 _lstm_fused_kernel (step body
// _lstm_fused_body:219; its bit-equal two-chain twin _lstm_fused_dual_kernel
// :322 is covered too), reached through lstm_layer_tm:563.
//
// Work per layer: the block input affine xa = x.iW + b over [T*B, IN] x
// [IN, 4H], then T dependent steps of xF = xa_t + h.sW (gate order u, f, g,
// o), c = f*c + u*g, h = o*tanh(c).  At T=2560, B=256, IN=H=256 that is
// 2.T.B.(IN+H).4H ~ 687 GFLOP of f32 FMA.
//
// What bounds it on this card: the parity tier is true f32, so no tensor
// cores: the affine half is bound by the f32 CUDA-core rate; the recurrent
// half is a chain of T steps, each of which must read all of sW.  sW is
// H.4H.4 B = 1 MiB, more than one block's 227 KB of shared memory, so it is
// read from L2 (where it stays resident: 50 MB) once per step per block.
//
// Design (simple and right first):
//  1. affine_kernel (affine.cuh, shared with K7), a tiled f32 SGEMM
//     (128x128 tiles, 8x8 outputs per thread, bias added after the dot as
//     in the TPU kernel) writes xa [T, B, 4H] to device memory.  It is
//     fully parallel.
//  2. lstm_recurrence_kernel splits the batch across blocks of R=8 rows
//     (32 blocks at B=256); each block walks all T steps.  Its 2H threads
//     split the product h.sW in two halves of the k (hidden unit) range;
//     each thread owns 4 consecutive gate columns, reads them as one float4
//     of sW per k through L2 (h broadcast from shared memory), and keeps
//     4R independent f32 FMA chains, so enough loads stay in flight to hide
//     L2 latency.  The two halves' partial sums meet in shared memory, and
//     each thread then updates R/2 (row, unit) cells whose c stays in
//     registers.  The next step's xa is loaded before the current step's sW
//     loop, hiding its latency.  Backward layers walk t from T-1 down; a
//     step at or past a read's length freezes (h, c) and writes 0, so a
//     backward read starts from the zero state at its own last valid step
//     (rnn_pallas.py:236-266).
// The fast design -- a thread-block cluster splitting sW's columns across
// blocks and exchanging h through distributed shared memory -- is later work.
//
// K8, the training forward (flappie_lstm_layer_train), replaces
// rnn_pallas.py:278 _lstm_fused_train_kernel (reached through
// lstm_layer_tm_train:584): the same kernel with a second [T, B, H] output,
// the carried cell state c at each step (0 at invalid steps), which the
// recompute-gates adjoint (ops/rnn_vjp.py) needs.  As in the TPU kernels,
// one step body serves both: WANT_C is a template flag, so K1's
// instantiation carries no c store at all, and K8's h is K1's h bit for bit.
// The extra write, T.B.H.4 bytes, is the only added traffic.
//
// K12's LSTM half (flappie_lstm_seq) replaces rnn_pallas.py:37 _lstm_kernel
// (its pallas_call at :129 in _run_recurrent:113), reached through
// lstm_seq_pallas:144: the recurrence alone over an affine the caller has
// computed, batch-major [B, T, 4H] -> [B, T, H], forward, zero initial
// state, no length mask.  It is the same recurrence kernel: a template
// flag (BATCH_MAJOR) switches its row offsets, so the batch-major tensors
// are read and written in place with no transpose and K1's and K8's
// instantiations are unchanged; lengths all equal to T drop the mask.
// Bound: operations, 2.T.B.H.4H of f32 FMA (343.6 GFLOP at T=2560, B=256,
// H=256).

#include <cuda_runtime.h>

#include "affine.cuh"

namespace {

using flappie::sigmoidf_;

constexpr int ROWS = 8;  // batch rows per recurrence block

template <int R, bool WANT_C, bool BATCH_MAJOR>
__global__ void __launch_bounds__(512)
lstm_recurrence_kernel(const float* __restrict__ xa,     // [T, B, 4H] or [B, T, 4H]
                       const float* __restrict__ sW,     // [H, 4H]
                       const int* __restrict__ lengths,  // [B]
                       float* __restrict__ out,          // [T, B, H] or [B, T, H]
                       float* __restrict__ c_out,        // [T, B, H] if WANT_C
                       int T, int B, int H, int backward) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* h_s = smem;          // [H][R]: h of the block's rows, unit-major
  float* g_s = smem + H * R;  // [2][R][4H]: the two halves' partial sums
  // row-major offsets of (t, row) in xa (in units of G) and out (of H):
  // time-major [T, B, .] (K1, K8) or batch-major [B, T, .] (K12)
  auto at = [&](int t, int row) {
    return BATCH_MAJOR ? (long)row * T + t : (long)t * B + row;
  };
  const int tid = threadIdx.x;  // blockDim.x == 2H
  const int half = tid / H;     // which half of the k (hidden unit) range
  const int col = 4 * (tid % H);
  const int k0 = half * (H / 2), k1 = k0 + H / 2;
  const int row0 = blockIdx.x * R;
  constexpr int NC = R / 2;  // (row, unit) cells per thread in the update

  for (int i = tid; i < H * R; i += 2 * H) h_s[i] = 0.f;
  float c[NC];
  int len[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    c[q] = 0.f;
    const int row = row0 + tid / H + 2 * q;
    len[q] = row < B ? lengths[row] : 0;
  }
  // the first half starts from xa, the second from zero
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
    for (int r = 0; r < R; ++r) acc[r] = nx[r];
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
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int r = tid / H + 2 * q;
      const int j = tid % H;
      const int row = row0 + r;
      const float* ga = g_s + r * G;
      const float* gb = g_s + (R + r) * G;
      const float u = sigmoidf_(ga[j] + gb[j]);
      const float f = sigmoidf_(ga[H + j] + gb[H + j]);
      const float gg = tanhf(ga[2 * H + j] + gb[2 * H + j]);
      const float o = sigmoidf_(ga[3 * H + j] + gb[3 * H + j]);
      const float c2 = f * c[q] + u * gg;
      const float h2 = o * tanhf(c2);
      const bool valid = t < len[q];
      if (row < B) {
        out[at(t, row) * H + j] = valid ? h2 : 0.f;
        if (WANT_C) c_out[at(t, row) * H + j] = valid ? c2 : 0.f;
      }
      if (valid) {
        c[q] = c2;
        h_s[j * R + r] = h2;
      }
    }
    __syncthreads();
  }
}

// The recurrence alone over xa; returns the launch error code.
template <bool WANT_C, bool BATCH_MAJOR>
cudaError_t launch_recurrence(const float* xa, const float* sW, const int* lengths,
                              float* out, float* c_out, int T, int B, int H, int backward,
                              cudaStream_t st) {
  const size_t smem = (size_t)(H * ROWS + 2 * ROWS * 4 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_recurrence_kernel<ROWS, WANT_C, BATCH_MAJOR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + ROWS - 1) / ROWS;
  lstm_recurrence_kernel<ROWS, WANT_C, BATCH_MAJOR><<<blocks, 2 * H, smem, st>>>(
      xa, sW, lengths, out, c_out, T, B, H, backward);
  return cudaGetLastError();
}

template <bool WANT_C>
int lstm_layer(const float* x, const float* iW, const float* b, const float* sW,
               const int* lengths, float* xa, float* out, float* c_out, int T, int B,
               int IN, int H, int backward, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)T * B;
  if (M == 0) return 0;
  const cudaError_t err = flappie::launch_affine(x, iW, b, xa, M, 4 * H, IN, st);
  if (err != cudaSuccess) return err;
  return launch_recurrence<WANT_C, false>(xa, sW, lengths, out, c_out, T, B, H, backward,
                                          st);
}

}  // namespace

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One fused layer (K1): affine into the xa scratch [T*B, 4H], then the
// recurrence into out [T, B, H].  Returns the launch error code (0 = ok).
extern "C" int flappie_lstm_layer(const float* x, const float* iW, const float* b,
                                  const float* sW, const int* lengths, float* xa,
                                  float* out, int T, int B, int IN, int H,
                                  int backward, void* stream) {
  return lstm_layer<false>(x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN, H,
                           backward, stream);
}

// The training forward (K8): K1 plus the cell state c_out [T, B, H].
extern "C" int flappie_lstm_layer_train(const float* x, const float* iW, const float* b,
                                        const float* sW, const int* lengths, float* xa,
                                        float* out, float* c_out, int T, int B, int IN,
                                        int H, int backward, void* stream) {
  return lstm_layer<true>(x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H, backward,
                          stream);
}

// K12 (LSTM): the recurrence alone over a caller's affine, batch-major
// xa [B, T, 4H] -> out [B, T, H], forward, zero initial state, no length
// mask: the caller passes lengths [B] all equal to T.  Returns the launch
// error code (0 = ok).
extern "C" int flappie_lstm_seq(const float* xa, const float* sW, const int* lengths, float* out,
                                int T, int B, int H, void* stream) {
  if ((long)T * B == 0) return 0;
  return launch_recurrence<false, true>(xa, sW, lengths, out, nullptr, T, B, H, 0,
                                        static_cast<cudaStream_t>(stream));
}
