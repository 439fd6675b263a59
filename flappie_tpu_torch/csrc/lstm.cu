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
// half is a chain of T steps, each of which needs all of sW (H.4H.4 B =
// 1 MiB, more than one block's 227 KB of shared memory).
//
// Design:
//  1. affine_kernel (affine.cuh, shared with K7), a pipelined f32 SGEMM
//     (128x128 tiles, 8x8 outputs per thread, K through a 3-stage cp.async
//     ring, bias added after the dot as in the TPU kernel) writes xa
//     [T, B, 4H] to device memory.  It is fully parallel.
//  2. cluster_rnn_kernel (cluster_rnn.cuh, shared with K7): a cluster of 8
//     CTAs keeps sW split by hidden unit in its shared memory (128 KiB a
//     CTA) for the whole walk and exchanges h through distributed shared
//     memory once a step; 1-20 rows a cluster.  Backward layers walk t from
//     T-1 down; a step at or past a read's length freezes (h, c) and writes
//     0, so a backward read starts from the zero state at its own last valid
//     step (rnn_pallas.py:236-266).  Needs H % 16 == 0 and H <= 256.
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
// are read and written in place with no transpose; lengths all equal to T
// drop the mask.  Bound: operations, 2.T.B.H.4H of f32 FMA (343.6 GFLOP at
// T=2560, B=256, H=256).
//
// K1-bf16 (flappie_lstm_layer_bf16) is K1 under the bf16 stream (--fast,
// FLAPPIE_TPU_RNN_STREAM=bf16 in the JAX package: rnn_pallas.py:515-519
// and _lstm_fused_body:243-245, :263): x and iW in bf16, the block affine
// on the tensor cores (affine_bf16_kernel, affine.cuh) into a bf16 xa, then
// the same recurrence with xa widened to f32 at its load and the output
// rounded to bf16 at its store; state, step product and order stay f32.
// Bound: the affine by its bytes (~0.50 ms at T=2560, B=256, IN=256)
// plus the recurrence's f32 FMA (5.13 ms).  flappie_affine_f32 and
// flappie_affine_bf16 launch the affines alone, for their measurement;
// flappie_affine_info reports their plans.
//
// K8-bf16 (flappie_lstm_layer_train_bf16) is K8 under the bf16 stream, the
// training forward under --fast's stream (rnn_pallas.py:278
// _lstm_fused_train_kernel through _run_fused:514-519, both outputs at
// xa_dtype, :542): K1-bf16 with the cell state c stored in bf16 (rounded to
// nearest even; the carried c stays f32), so its h is K1-bf16's bit for
// bit.  The extra write, T.B.H.2 bytes, is the only added traffic.
//
// The layers that only precision ``default`` reaches (ops/precision.py),
// the one-pass step product and the one-pass affine before the f32 step,
// are in lstm_p1.cu; flappie_affine_bf16_f32 launches that affine (the
// bf16 kernels with an f32 output, affine.cuh) alone.  Every layer entry
// is one call of fused_layer (layer.cuh): the affine, then the recurrence,
// on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layer.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flappie::fused_layer;

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
  return fused_layer<4, false, float, 0, flappie::AFFINE_F32>(
      x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN, H, backward, stream);
}

// The training forward (K8): K1 plus the cell state c_out [T, B, H].
extern "C" int flappie_lstm_layer_train(const float* x, const float* iW, const float* b,
                                        const float* sW, const int* lengths, float* xa,
                                        float* out, float* c_out, int T, int B, int IN,
                                        int H, int backward, void* stream) {
  return fused_layer<4, true, float, 0, flappie::AFFINE_F32>(
      x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H, backward, stream);
}

// K12 (LSTM): the recurrence alone over a caller's affine, batch-major
// xa [B, T, 4H] -> out [B, T, H], forward, zero initial state, no length
// mask: the caller passes lengths [B] all equal to T.  Returns the launch
// error code (0 = ok).
extern "C" int flappie_lstm_seq(const float* xa, const float* sW, const int* lengths, float* out,
                                int T, int B, int H, void* stream) {
  if ((long)T * B == 0) return 0;
  return flappie::cluster_rnn<4, false, true>(
      {xa, sW, lengths, out, nullptr, T, B, H, 0, static_cast<cudaStream_t>(stream)});
}

// K1-bf16: K1 under the bf16 stream.  x [T*B, IN], iW [IN, 4H], the xa
// scratch [T*B, 4H] and out [T, B, H] in bf16; b, sW f32.  One affine
// launch, then one recurrence launch.  Returns the launch error code.
extern "C" int flappie_lstm_layer_bf16(const bf16* x, const bf16* iW, const float* b,
                                       const float* sW, const int* lengths, bf16* xa, bf16* out,
                                       int T, int B, int IN, int H, int backward, void* stream) {
  return fused_layer<4, false, bf16, 0, flappie::AFFINE_BF16>(
      x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN, H, backward, stream);
}

// K8-bf16: K1-bf16 plus the cell state c_out [T, B, H] in bf16.  One
// affine launch, then one recurrence launch.  Returns the launch error code.
extern "C" int flappie_lstm_layer_train_bf16(const bf16* x, const bf16* iW, const float* b,
                                             const float* sW, const int* lengths, bf16* xa,
                                             bf16* out, bf16* c_out, int T, int B, int IN, int H,
                                             int backward, void* stream) {
  return fused_layer<4, true, bf16, 0, flappie::AFFINE_BF16>(
      x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H, backward, stream);
}

// The one-pass affine with an f32 output: xa [M, N] = x [M, K] . iW [K, N]
// + b [N], x and iW bf16, f32 sums, xa f32.  Returns the launch error code.
extern "C" int flappie_affine_bf16_f32(const __nv_bfloat16* x, const __nv_bfloat16* iW,
                                       const float* b, float* xa, long M, int N, int K,
                                       void* stream) {
  return flappie::launch_affine_bf16(x, iW, b, xa, M, N, K, static_cast<cudaStream_t>(stream));
}

// The bf16 affine alone: xa [M, N] = bf16(x [M, K] . iW [K, N] + b [N]).
// Returns the launch error code.
extern "C" int flappie_affine_bf16(const __nv_bfloat16* x, const __nv_bfloat16* iW,
                                   const float* b, __nv_bfloat16* xa, long M, int N, int K,
                                   void* stream) {
  return flappie::launch_affine_bf16(x, iW, b, xa, M, N, K, static_cast<cudaStream_t>(stream));
}

// The f32 affine alone (K1's, K7's and K8's): xa [M, N] = x [M, K] .
// iW [K, N] + b [N].  Returns the launch error code.
extern "C" int flappie_affine_f32(const float* x, const float* iW, const float* b, float* xa,
                                  long M, int N, int K, void* stream) {
  return flappie::launch_affine(x, iW, b, xa, M, N, K, static_cast<cudaStream_t>(stream));
}

// The plan of the f32 (bf16 = 0) or the bf16 (1) affine at [M, K] x [K, N]
// on this card: info = {path (0 f32, 1 bf16 wmma, 2 bf16 wgmma), tile rows,
// tile columns, k step, stages, shared bytes, CTAs, output tiles}.
// Returns the error code.
extern "C" int flappie_affine_info(long M, int N, int K, int bf16, int* info) {
  return flappie::affine_info(M, N, K, bf16, info);
}

// The cluster plan of K1 (variant 0), K8 (1), K12 (2), K1-bf16 (3) or
// K8-bf16 (4) for a batch of B: info = {rows a cluster, clusters, shared
// bytes a CTA, clusters the card holds at once}; the bf16 variants' are the
// f32 ones', as xa never enters shared memory.  Returns the error code.
extern "C" int flappie_lstm_cluster_info(int B, int H, int variant, int* info) {
  if (variant == 4) return flappie::cluster_info<4, true, false, __nv_bfloat16>(B, H, info);
  if (variant == 1) return flappie::cluster_info<4, true, false>(B, H, info);
  if (variant == 2) return flappie::cluster_info<4, false, true>(B, H, info);
  if (variant == 3) return flappie::cluster_info<4, false, false, __nv_bfloat16>(B, H, info);
  return flappie::cluster_info<4, false, false>(B, H, info);
}
