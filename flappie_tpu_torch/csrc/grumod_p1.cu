// The GRU-mod layers of precision ``default``, for Hopper, sm_90a: K7 and
// K7-bf16 with the step product one bf16 pass
// (FLAPPIE_TPU_RNN_PRECISION=default), and K7 after the one-pass affine
// alone (FLAPPIE_TPU_MATMUL_PRECISION=default).
//
// Replaces the step product of flappie_tpu/ops/rnn_pallas.py:290
// _grumod_fused_kernel (and the dual kernel :386) when _make_rdot:172 runs
// at lax.Precision.DEFAULT: one bf16 MXU pass with f32 accumulation, h and
// sW rounded to bf16.  As lstm_p1.cu: the one-pass step on the tensor
// cores (cluster_rnn_mma.cuh at GN = 3: m-tile 0 gates z | r, m-tile 1 the
// candidate hbar | zero rows, sW's slice held in registers as bf16 A
// fragments, h rounded to bf16 where it is made and exchanged as bf16; z.h,
// the update and the freeze on the carried f32 h, the candidate's xa added
// after the multiply by r), bound by the chain of steps; each entry is one
// fused layer (layer.cuh default_layer), the block affine the caller names
// first.  The f32 step after the one-pass affine is here too, so that
// grumod.cu keeps its kernels; it is cluster_rnn.cuh's f32 step,
// unchanged.  A source of its own, built only when ``default`` is asked
// for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "layer.cuh"

extern "C" const char* flappie_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7 (or K7-bf16) at precision default: the block affine of x [T*B, IN]
// by ``affine`` (layer.cuh's BlockAffine: 0 f32, 1 one pass with an f32
// output, 2 bf16, the bf16 stream) into the xa scratch [T*B, 3H], then the
// recurrence into out [T, B, H], its step product one bf16 pass when dot1
// (else f32, after the one-pass affine only); xa and out are bf16 under the
// bf16 stream, else f32.  Returns the launch error code.
extern "C" int flappie_grumod_p1_layer(const void* x, const void* iW, const float* b,
                                       const float* sW, const int* lengths, void* xa, void* out,
                                       int T, int B, int IN, int H, int backward, int affine,
                                       int dot1, void* stream) {
  return flappie::default_layer<3, false, 1>(x, iW, b, sW, lengths, xa, out, nullptr, T, B, IN,
                                             H, backward, affine, dot1, stream);
}

// The cluster plan of K7 (variant 0) or K7-bf16 (3) at precision default
// for a batch of B (the tensor-core step's): info = {rows a cluster,
// clusters, shared bytes a CTA, clusters the card holds at once}.  Returns
// the error code.
extern "C" int flappie_grumod_p1_cluster_info(int B, int H, int variant, int* info) {
  if (variant == 3) return flappie::cluster_mma_info<3, false, __nv_bfloat16>(B, H, info);
  return flappie::cluster_mma_info<3, false, float>(B, H, info);
}
