// One fused recurrent layer on the host side: the block affine of x into
// the layer's xa scratch, then the cluster recurrence over it, both on one
// stream.  Every layer entry of lstm.cu, grumod.cu, lstm_p1.cu,
// grumod_p1.cu, lstm_h3.cu and grumod_h3.cu is an instantiation of
// fused_layer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "affine.cuh"
#include "cluster_rnn.cuh"
#include "cluster_rnn_mma.cuh"

namespace flappie {

// The block affine a layer runs: f32 (x, iW and xa f32), one pass with an
// f32 output (x and iW bf16, xa f32: FLAPPIE_TPU_MATMUL_PRECISION=default
// on the f32 stream) or bf16 (x, iW and xa bf16: the bf16 stream).
enum BlockAffine { AFFINE_F32 = 0, AFFINE_ONE_PASS = 1, AFFINE_BF16 = 2 };

// xa [M, N] = x [M, K] . iW [K, N] + b [N] by AFFINE (a BlockAffine, a
// template argument so that a source instantiates only the affine kernels
// it launches); returns the launch error code (0 = ok).
template <int AFFINE>
cudaError_t launch_block_affine(const void* x, const void* iW, const float* b, void* xa, long M,
                                int N, int K, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const auto* xh = static_cast<const bf16*>(x);
  const auto* wh = static_cast<const bf16*>(iW);
  if constexpr (AFFINE == AFFINE_BF16)
    return launch_affine_bf16(xh, wh, b, static_cast<bf16*>(xa), M, N, K, st);
  else if constexpr (AFFINE == AFFINE_ONE_PASS)
    return launch_affine_bf16(xh, wh, b, static_cast<float*>(xa), M, N, K, st);
  else
    return launch_affine(static_cast<const float*>(x), static_cast<const float*>(iW), b,
                         static_cast<float*>(xa), M, N, K, st);
}

// One layer of GN gates: the block affine of x [T*B, IN] by AFFINE into
// xa [T*B, GN*H], then the recurrence over it (xa, out and, with WANT_C,
// c_out [T, B, H] of type XT; STEP the step product: 0 cluster_rnn.cuh's
// f32 step, 1 one bf16 pass or 3 three bf16 passes on the tensor cores,
// cluster_rnn_mma.cuh).  Returns the launch error code (0 = ok).
template <int GN, bool WANT_C, typename XT, int STEP, int AFFINE>
int fused_layer(const void* x, const void* iW, const float* b, const float* sW,
                const int* lengths, void* xa, void* out, void* c_out, int T, int B, int IN,
                int H, int backward, void* stream) {
  static_assert(STEP == 0 || STEP == 1 || STEP == 3, "the f32 step, one pass or three");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long M = (long)T * B;
  if (M == 0) return 0;
  if (!cluster_h_ok(H)) return cudaErrorInvalidValue;
  const cudaError_t err = launch_block_affine<AFFINE>(x, iW, b, xa, M, GN * H, IN, st);
  if (err != cudaSuccess) return err;
  const RnnArgs<XT> args = {static_cast<const XT*>(xa), sW, lengths, static_cast<XT*>(out),
                            static_cast<XT*>(c_out), T, B, H, backward, st};
  if constexpr (STEP != 0)
    return cluster_rnn_mma<GN, WANT_C, XT, STEP>(args);
  else
    return cluster_rnn<GN, WANT_C, false, XT>(args);
}

// A layer of rnn precision ``default`` (lstm_p1.cu, grumod_p1.cu; PASSES =
// 1) or ``high`` on the card (lstm_h3.cu, grumod_h3.cu; PASSES = 3) by the
// caller's (affine, step), step the step product's bf16 passes (0: the f32
// step): the tensor-core step of PASSES passes over the f32 affine (0,
// PASSES), over the one-pass affine (1, PASSES) or under the bf16 stream
// (2, PASSES), and with PASSES = 1 the f32 step over the one-pass affine
// (1, 0); any other pair is a layer of another source and returns
// cudaErrorInvalidValue.
template <int GN, bool WANT_C, int PASSES>
int default_layer(const void* x, const void* iW, const float* b, const float* sW,
                  const int* lengths, void* xa, void* out, void* c_out, int T, int B, int IN,
                  int H, int backward, int affine, int step, void* stream) {
  using bf16 = __nv_bfloat16;
  static_assert(PASSES == 1 || PASSES == 3, "one pass or three");
  if (affine == AFFINE_BF16 && step == PASSES)
    return fused_layer<GN, WANT_C, bf16, PASSES, AFFINE_BF16>(x, iW, b, sW, lengths, xa, out,
                                                              c_out, T, B, IN, H, backward, stream);
  if (affine == AFFINE_ONE_PASS && step == PASSES)
    return fused_layer<GN, WANT_C, float, PASSES, AFFINE_ONE_PASS>(
        x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H, backward, stream);
  if constexpr (PASSES == 1) {
    if (affine == AFFINE_ONE_PASS && step == 0)
      return fused_layer<GN, WANT_C, float, 0, AFFINE_ONE_PASS>(
          x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H, backward, stream);
  }
  if (affine == AFFINE_F32 && step == PASSES)
    return fused_layer<GN, WANT_C, float, PASSES, AFFINE_F32>(x, iW, b, sW, lengths, xa, out,
                                                              c_out, T, B, IN, H, backward, stream);
  return cudaErrorInvalidValue;
}

}  // namespace flappie
