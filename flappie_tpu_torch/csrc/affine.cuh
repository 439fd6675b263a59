// Shared by the fused recurrent layers (lstm.cu: K1, grumod.cu: K7).
//
// affine_kernel: the block input affine C = A.W + bias over [M, K] x [K, N],
// a tiled f32 SGEMM (128x128 tiles, 8x8 outputs per thread, 256 threads;
// bias added after the dot, as in the TPU kernels' _ff_dot + b).  It is
// fully parallel and bound by the f32 CUDA-core rate at the layer shapes.
//
// affine_bf16_kernel: the same affine under the bf16 stream (--fast), the
// product inside flappie_tpu/ops/rnn_pallas.py's fused kernels
// (_lstm_fused_body:243-245, _grumod_fused_kernel:303-305) when
// FLAPPIE_TPU_RNN_STREAM=bf16: C = bf16(A.W + bias) with A [M, K] and
// W [K, N] in bf16, the products on the tensor cores with f32
// accumulation, the f32 bias added after the dot, one round to nearest
// even into bf16.  What bounds it on this card: bytes (at M = 655,360,
// K = 256, N = 1024: 343.6 GFLOP, 0.35 ms at the bf16 tensor rate, against
// 335 MB read and 1.34 GB written, 0.50 ms at 3.35 TB/s).  Design, simple
// first: a CTA computes a 128x128 tile of C with 8 warps of nvcuda::wmma
// bf16 16x16x16 fragments (each warp 32x64: 2x4 accumulators in
// registers), K in steps of 32 staged through two shared-memory buffers
// by 16-byte cp.async (step s + 1's copies in flight while step s is
// multiplied; rows padded against bank conflicts; past an edge the copy
// zero-fills; a K or N that is not a multiple of 8 loads element by
// element);
// the epilogue passes each accumulator through a warp's 16x16 f32
// scratch so that each lane adds the bias to 8 neighbouring columns and
// stores them as one 16-byte bf16 vector.  wgmma and TMA are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

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

// the bf16 affine's tile: a CTA's 128x128 of C, K 32 a stage, rows padded
// (multiples of 8 bf16), 8 warps (4 along M x 2 along N)
constexpr int HM = 128, HN = 128, HK = 32;
constexpr int H_ALD = HK + 8, H_BLD = HN + 8;
constexpr int H_THREADS = 256;

// 8 consecutive bf16 of one row of a [rows, cols] matrix from column c,
// element by element (any cols); zero past the edge.
__device__ __forceinline__ uint4 load8_bf16(const uint16_t* __restrict__ p, long row,
                                            long rows, int c, int cols) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const uint16_t* q = p + row * cols + c;
  uint16_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = c + i < cols ? q[i] : (uint16_t)0;
  v.x = e[0] | ((uint32_t)e[1] << 16);
  v.y = e[2] | ((uint32_t)e[3] << 16);
  v.z = e[4] | ((uint32_t)e[5] << 16);
  v.w = e[6] | ((uint32_t)e[7] << 16);
  return v;
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(valid ? 16 : 0) : "memory");
}

__global__ void __launch_bounds__(H_THREADS)
affine_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ C,
                   long M, int N, int K) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(32) __nv_bfloat16 As[2][HM][H_ALD];  // by step parity
  __shared__ __align__(32) __nv_bfloat16 Bs[2][HK][H_BLD];
  __shared__ __align__(32) float Cs[H_THREADS / 32][16][16];  // a warp's epilogue scratch
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // this warp's 32x64 of the tile
  const long row0 = (long)blockIdx.x * HM;
  const int col0 = blockIdx.y * HN;
  const uint16_t* A16 = reinterpret_cast<const uint16_t*>(A);
  const uint16_t* W16 = reinterpret_cast<const uint16_t*>(W);
  const bool vecA = K % 8 == 0, vecB = N % 8 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // step k0's A (128 rows x 32 k) and W (32 k x 128 columns) into buffer
  // s: 512 runs of 8 each, by cp.async (one commit group a step) or, off
  // the 8-element grid, element by element
  auto load_step = [&](int s, int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * H_THREADS;
      const int r = c / (HK / 8), kc = (c % (HK / 8)) * 8;
      const long gr = row0 + r;
      if (vecA) {
        const bool ok = gr < M && k0 + kc < K;
        cp_async16(&As[s][r][kc], ok ? A16 + gr * K + k0 + kc : A16, ok);
      } else {
        *reinterpret_cast<uint4*>(&As[s][r][kc]) = load8_bf16(A16, gr, M, k0 + kc, K);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tid + q * H_THREADS;
      const int r = c / (HN / 8), nc = (c % (HN / 8)) * 8;
      const int gk = k0 + r, gc = col0 + nc;
      if (vecB) {
        const bool ok = gk < K && gc < N;
        cp_async16(&Bs[s][r][nc], ok ? W16 + (long)gk * N + gc : W16, ok);
      } else {
        *reinterpret_cast<uint4*>(&Bs[s][r][nc]) =
            gc < N ? load8_bf16(W16, gk, K, gc, N) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int steps = (K + HK - 1) / HK;
  if (steps > 0) load_step(0, 0);
  for (int s = 0; s < steps; ++s) {
    // step s + 1's copies go out before step s's are awaited
    if (s + 1 < steps) {
      load_step((s + 1) & 1, (s + 1) * HK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int p = s & 1;
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[p][wm * 32 + i * 16][kk], H_ALD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], &Bs[p][kk][wn * 64 + j * 16], H_BLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // buffer p is read before step s + 2's copies refill it
    __syncthreads();
  }

  // epilogue: lane (r, half) of a 16x16 accumulator takes row r, columns
  // 8*half .. 8*half + 7; bias after the dot, round to nearest even
  float* cs = &Cs[warp][0][0];
  uint16_t* C16 = reinterpret_cast<uint16_t*>(C);
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long gr = row0 + wm * 32 + i * 16 + r;
      const int gc = col0 + wn * 64 + j * 16 + c8;
      if (gr < M) {
        uint16_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float v = cs[r * 16 + c8 + e] + (gc + e < N ? bias[gc + e] : 0.f);
          o[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
        uint16_t* dst = C16 + gr * N + gc;
        if (vecB && gc + 8 <= N) {
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(o[0] | ((uint32_t)o[1] << 16), o[2] | ((uint32_t)o[3] << 16),
                         o[4] | ((uint32_t)o[5] << 16), o[6] | ((uint32_t)o[7] << 16));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (gc + e < N) dst[e] = o[e];
        }
      }
      __syncwarp();
    }
}

// xa [M, N] = bf16(A [M, K] . W [K, N] + bias [N]), A and W bf16, on
// stream st; returns the launch error code (0 = ok).
inline cudaError_t launch_affine_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W,
                                      const float* bias, __nv_bfloat16* C, long M, int N,
                                      int K, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  dim3 grid((unsigned)((M + HM - 1) / HM), (unsigned)((N + HN - 1) / HN));
  affine_bf16_kernel<<<grid, H_THREADS, 0, st>>>(A, W, bias, C, M, N, K);
  return cudaGetLastError();
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace flappie
