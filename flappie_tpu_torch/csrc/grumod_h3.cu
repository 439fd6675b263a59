// The GRU-mod layers of rnn precision ``high`` on the card, for Hopper,
// sm_90a: K7 and K7-bf16 with the step product three bf16 passes
// (FLAPPIE_TPU_RNN_PRECISION=high; K7-high3 and K7-high3-bf16).
//
// Replaces the step product of flappie_tpu/ops/rnn_pallas.py:290
// _grumod_fused_kernel (and the dual kernel :386) when _make_rdot:172 runs
// at "high3" (rnn level HIGH, :505-507): :161 _dot_bf16x3, h_hi.sW_hi +
// h_hi.sW_lo + h_lo.sW_hi with each pass's exact products summed in f32.
// As lstm_h3.cu: the tensor-core step at PASSES = 3 (cluster_rnn_mma.cuh
// at GN = 3: m-tile 0 gates z | r, m-tile 1 the candidate hbar | zero
// rows, which sW_lo's shared-memory fragments do not store; z.h, the
// update and the freeze on the carried f32 h, the candidate's xa added
// after the multiply by r, r.P + xa_h), bound by the chain of steps; each
// entry is one fused layer (layer.cuh default_layer), the block affine the
// caller names first.  A source of its own, built only when rnn ``high``
// runs on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layer.cuh"

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7 (or K7-bf16) at rnn precision high: the block affine of x [T*B, IN]
// by ``affine`` (layer.cuh's BlockAffine: 0 f32, 1 one pass with an f32
// output, 2 bf16, the bf16 stream) into the xa scratch [T*B, 3H], then the
// three-pass recurrence into out [T, B, H]; xa and out are bf16 under the
// bf16 stream, else f32.  Returns the launch error code.
extern "C" int flappie_grumod_h3_layer(const void* x, const void* iW, const float* b,
                                       const float* sW, const int* lengths, void* xa, void* out,
                                       int T, int B, int IN, int H, int backward, int affine,
                                       void* stream) {
  return flappie::default_layer<3, false, 3>(x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN,
                                             H, backward, affine, 3, stream);
}

// The cluster plan of K7 (variant 0) or K7-bf16 (3) at rnn precision high
// for a batch of B (the three-pass tensor-core step's): info = {rows a
// cluster, clusters, shared bytes a CTA, clusters the card holds at once}.
// Returns the error code.
extern "C" int flappie_grumod_h3_cluster_info(int B, int H, int variant, int* info) {
  if (variant == 3) return flappie::cluster_mma_info<3, false, __nv_bfloat16, 3>(B, H, info);
  return flappie::cluster_mma_info<3, false, float, 3>(B, H, info);
}
