// The LSTM layers of precision ``default``, for Hopper, sm_90a: K1, K8,
// K1-bf16 and K8-bf16 with the step product one bf16 pass
// (FLAPPIE_TPU_RNN_PRECISION=default), and K1 and K8 after the one-pass
// affine alone (FLAPPIE_TPU_MATMUL_PRECISION=default).
//
// Replaces the step product of flappie_tpu/ops/rnn_pallas.py:219
// _lstm_fused_body (K1 :273, K8 :278, the dual kernel :322) when
// _make_rdot:172 runs at lax.Precision.DEFAULT: one bf16 MXU pass with f32
// accumulation, h and sW rounded to bf16.  The kernel is the one-pass step
// on the tensor cores (cluster_rnn_mma.cuh): the cluster recurrence's CTAs
// and rows, the product on mma.sync with sW's slice held in registers as
// bf16 A fragments, h rounded to bf16 where it is made and exchanged as
// bf16; the carried h and c, the update and the freeze stay f32.  Bound as
// every recurrence: the chain of T dependent steps.  Each entry is one
// fused layer (layer.cuh default_layer): the block affine the caller names
// (f32, the one-pass affine with an f32 output, or under the bf16 stream
// the bf16 one; affine.cuh), then the recurrence, on the caller's stream.
// The f32 step after the one-pass affine (FLAPPIE_TPU_MATMUL_PRECISION=
// default alone) is here too, so that lstm.cu keeps its kernels; it is
// cluster_rnn.cuh's f32 step, unchanged.
//
// These layers live in a source of their own so that a run that never
// sets ``default`` never builds them, and so that their build runs beside
// lstm.cu's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layer.cuh"

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 (or K1-bf16) at precision default: the block affine of x [T*B, IN]
// by ``affine`` (layer.cuh's BlockAffine: 0 f32, 1 one pass with an f32
// output, 2 bf16, the bf16 stream) into the xa scratch [T*B, 4H], then the
// recurrence into out [T, B, H], its step product one bf16 pass when dot1
// (else f32, after the one-pass affine only); xa and out are bf16 under the
// bf16 stream, else f32.  Returns the launch error code.
extern "C" int flappie_lstm_p1_layer(const void* x, const void* iW, const float* b,
                                     const float* sW, const int* lengths, void* xa, void* out,
                                     int T, int B, int IN, int H, int backward, int affine,
                                     int dot1, void* stream) {
  return flappie::default_layer<4, false, 1>(x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN,
                                             H, backward, affine, dot1, stream);
}

// K8 (or K8-bf16) at precision default: flappie_lstm_p1_layer plus the
// cell state c_out [T, B, H] in out's type.
extern "C" int flappie_lstm_p1_layer_train(const void* x, const void* iW, const float* b,
                                           const float* sW, const int* lengths, void* xa,
                                           void* out, void* c_out, int T, int B, int IN, int H,
                                           int backward, int affine, int dot1, void* stream) {
  return flappie::default_layer<4, true, 1>(x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H,
                                            backward, affine, dot1, stream);
}

// The cluster plan of K1 (variant 0), K8 (1), K1-bf16 (3) or K8-bf16 (4)
// at precision default for a batch of B (the tensor-core step's): info =
// {rows a cluster, clusters, shared bytes a CTA, clusters the card holds at
// once}.  Returns the error code.
extern "C" int flappie_lstm_p1_cluster_info(int B, int H, int variant, int* info) {
  if (variant == 1) return flappie::cluster_mma_info<4, true, float>(B, H, info);
  if (variant == 3) return flappie::cluster_mma_info<4, false, __nv_bfloat16>(B, H, info);
  if (variant == 4) return flappie::cluster_mma_info<4, true, __nv_bfloat16>(B, H, info);
  return flappie::cluster_mma_info<4, false, float>(B, H, info);
}
