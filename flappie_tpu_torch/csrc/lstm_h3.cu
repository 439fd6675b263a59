// The LSTM layers of rnn precision ``high`` on the card, for Hopper,
// sm_90a: K1, K8, K1-bf16 and K8-bf16 with the step product three bf16
// passes (FLAPPIE_TPU_RNN_PRECISION=high; K1-high3, K8-high3 and their
// -bf16 twins).
//
// Replaces the step product of flappie_tpu/ops/rnn_pallas.py:219
// _lstm_fused_body (K1 :273, K8 :278, the dual kernel :322) when
// _make_rdot:172 runs at "high3" (rnn level HIGH, :505-507):
// :161 _dot_bf16x3, h and sW split into bf16 high parts and remainders
// (:154 _split_bf16, sW's split hoisted out of the step loop), h_hi.sW_hi
// + h_hi.sW_lo + h_lo.sW_hi, each pass's exact products summed in f32.
// The kernel is the tensor-core step at PASSES = 3 (cluster_rnn_mma.cuh:
// sW_hi in registers as bf16 A fragments, sW_lo's fragments in shared
// memory, h_hi and h_lo made where h is and exchanged side by side; the
// order of the passes is in that header); the carried h and c, the update
// and the freeze stay f32.  Bound as every recurrence: the chain of T
// dependent steps.  Each entry is one fused layer (layer.cuh
// default_layer): the block affine the caller names (f32, the one-pass
// affine with an f32 output, or under the bf16 stream the bf16 one;
// affine.cuh), then the recurrence, on the caller's stream.
//
// These layers live in a source of their own so that a run that never
// sets rnn ``high`` never builds them, and so that their build runs beside
// lstm_p1.cu's, the longest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layer.cuh"

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1 (or K1-bf16) at rnn precision high: the block affine of x [T*B, IN]
// by ``affine`` (layer.cuh's BlockAffine: 0 f32, 1 one pass with an f32
// output, 2 bf16, the bf16 stream) into the xa scratch [T*B, 4H], then the
// three-pass recurrence into out [T, B, H]; xa and out are bf16 under the
// bf16 stream, else f32.  Returns the launch error code.
extern "C" int flappie_lstm_h3_layer(const void* x, const void* iW, const float* b,
                                     const float* sW, const int* lengths, void* xa, void* out,
                                     int T, int B, int IN, int H, int backward, int affine,
                                     void* stream) {
  return flappie::default_layer<4, false, 3>(x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN,
                                             H, backward, affine, 3, stream);
}

// K8 (or K8-bf16) at rnn precision high: flappie_lstm_h3_layer plus the
// cell state c_out [T, B, H] in out's type.
extern "C" int flappie_lstm_h3_layer_train(const void* x, const void* iW, const float* b,
                                           const float* sW, const int* lengths, void* xa,
                                           void* out, void* c_out, int T, int B, int IN, int H,
                                           int backward, int affine, void* stream) {
  return flappie::default_layer<4, true, 3>(x, iW, b, sW, lengths, xa, out, c_out, T, B, IN, H,
                                            backward, affine, 3, stream);
}

// The cluster plan of K1 (variant 0), K8 (1), K1-bf16 (3) or K8-bf16 (4)
// at rnn precision high for a batch of B (the three-pass tensor-core
// step's): info = {rows a cluster, clusters, shared bytes a CTA, clusters
// the card holds at once}.  Returns the error code.
extern "C" int flappie_lstm_h3_cluster_info(int B, int H, int variant, int* info) {
  using bf16 = __nv_bfloat16;
  if (variant == 1) return flappie::cluster_mma_info<4, true, float, 3>(B, H, info);
  if (variant == 3) return flappie::cluster_mma_info<4, false, bf16, 3>(B, H, info);
  if (variant == 4) return flappie::cluster_mma_info<4, true, bf16, 3>(B, H, info);
  return flappie::cluster_mma_info<4, false, float, 3>(B, H, info);
}
