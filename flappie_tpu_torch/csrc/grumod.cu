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
// half is a chain of T steps, each of which needs all of sW (H.3H.4 B =
// 768 KiB, more than one block's 227 KB of shared memory).
//
// Design (K1's frame):
//  1. affine_kernel (affine.cuh, shared with K1, the pipelined f32 SGEMM)
//     writes xa [T, B, 3H].
//  2. cluster_rnn_kernel (cluster_rnn.cuh, shared with K1) with three gates
//     a unit: a cluster of 8 CTAs keeps sW split by hidden unit in shared
//     memory (96 KiB a CTA) for the whole walk and exchanges h through
//     distributed shared memory once a step.  The z and r sums start from
//     xa, the candidate's from 0; xa_h joins after the multiply by r.
//     Backward layers walk t from T-1 down; a step at or past a read's
//     length freezes h and writes 0 (rnn_pallas.py:307-317).  Needs
//     H % 16 == 0 and H <= 256.
//
// K12's GRU-mod half (flappie_grumod_seq) replaces rnn_pallas.py:69
// _grumod_kernel (its pallas_call at :129 in _run_recurrent:113), reached
// through grumod_seq_pallas:149: the recurrence alone over a caller's
// affine, batch-major [B, T, 3H] -> [B, T, H], forward, zero initial state,
// no length mask.  As in lstm.cu, the same recurrence kernel under a
// BATCH_MAJOR template flag, with lengths all equal to T.  Bound:
// operations, 2.T.B.H.3H of f32 FMA (257.7 GFLOP at T=2560, B=256, H=256).
//
// K7-bf16 (flappie_grumod_layer_bf16) is K7 under the bf16 stream (--fast;
// rnn_pallas.py:515-519, _grumod_fused_kernel:303-305, :316): x and iW in
// bf16, the block affine on the tensor cores (affine_bf16_kernel,
// affine.cuh) into a bf16 xa, then the same recurrence with xa widened to
// f32 at its load and the output rounded to bf16 at its store.

// The layers that only precision ``default`` reaches, the one-pass step
// product and the one-pass affine before the f32 step, are in
// grumod_p1.cu: the f32-output affine kernels are not instantiated here
// (a build of this file that held them gave K7-bf16's R=12 recurrence
// other SASS, compare_rnn.py).  Every
// layer entry is one call of fused_layer (layer.cuh).

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

// One fused layer: affine into the xa scratch [T*B, 3H], then the
// recurrence into out [T, B, H].  Returns the launch error code (0 = ok).
extern "C" int flappie_grumod_layer(const float* x, const float* iW, const float* b,
                                    const float* sW, const int* lengths, float* xa,
                                    float* out, int T, int B, int IN, int H,
                                    int backward, void* stream) {
  return fused_layer<3, false, float, 0, flappie::AFFINE_F32>(
      x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN, H, backward, stream);
}

// K12 (GRU-mod): the recurrence alone over a caller's affine, batch-major
// xa [B, T, 3H] -> out [B, T, H], forward, zero initial state, no length
// mask: the caller passes lengths [B] all equal to T.  Returns the launch
// error code.
extern "C" int flappie_grumod_seq(const float* xa, const float* sW, const int* lengths,
                                  float* out, int T, int B, int H, void* stream) {
  if ((long)T * B == 0) return 0;
  return flappie::cluster_rnn<3, false, true>(
      {xa, sW, lengths, out, nullptr, T, B, H, 0, static_cast<cudaStream_t>(stream)});
}

// K7-bf16: K7 under the bf16 stream.  x [T*B, IN], iW [IN, 3H], the xa
// scratch [T*B, 3H] and out [T, B, H] in bf16; b, sW f32.  One affine
// launch, then one recurrence launch.  Returns the launch error code.
extern "C" int flappie_grumod_layer_bf16(const bf16* x, const bf16* iW, const float* b,
                                         const float* sW, const int* lengths, bf16* xa, bf16* out,
                                         int T, int B, int IN, int H, int backward, void* stream) {
  return fused_layer<3, false, bf16, 0, flappie::AFFINE_BF16>(
      x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN, H, backward, stream);
}

// The cluster plan of K7 (variant 0), K12 (2) or K7-bf16 (3, K7's: xa never
// enters shared memory) for a batch of B: info = {rows a cluster, clusters,
// shared bytes a CTA, clusters the card holds at once}.  Returns the error
// code.
extern "C" int flappie_grumod_cluster_info(int B, int H, int variant, int* info) {
  if (variant == 2) return flappie::cluster_info<3, false, true>(B, H, info);
  if (variant == 3) return flappie::cluster_info<3, false, false, __nv_bfloat16>(B, H, info);
  return flappie::cluster_info<3, false, false>(B, H, info);
}
