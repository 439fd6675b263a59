// Shared by the fused recurrent layers (lstm.cu: K1, grumod.cu: K7).
//
// affine_kernel: the block input affine C = A.W + bias over [M, K] x [K, N],
// a tiled f32 SGEMM (128x128 tiles, 8x8 outputs per thread, 256 threads;
// bias added after the dot, as in the TPU kernels' _ff_dot + b).  It is
// fully parallel and bound by the f32 CUDA-core rate at the layer shapes.

#pragma once

#include <cuda_runtime.h>

namespace flappie {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;  // 256 threads

__global__ void __launch_bounds__(256)
affine_kernel(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ C,
              long M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];  // padded: conflict-free stores
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const long row0 = (long)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * 256;
      const int r = i / BK, c = i % BK;
      const long gr = row0 + r;
      const int gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[gr * K + gc] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = tid + q * 256;
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? W[(long)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tr * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tc * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long gr = row0 + tr * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + (j < 4 ? tc * 4 + j : BN / 2 + tc * 4 + j - 4);
      if (gc < N) C[gr * N + gc] = acc[i][j] + bias[gc];
    }
  }
}

// xa [M, N] = A [M, K] . W [K, N] + bias [N] on stream st; returns the
// launch error code (0 = ok).
inline cudaError_t launch_affine(const float* A, const float* W, const float* bias,
                                 float* C, long M, int N, int K, cudaStream_t st) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  affine_kernel<<<grid, 256, 0, st>>>(A, W, bias, C, M, N, K);
  return cudaGetLastError();
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace flappie
