// The block input affine of the fused recurrent layers (lstm.cu: K1, K8,
// K1-bf16, K8-bf16; grumod.cu: K7, K7-bf16; launched alone before the
// recurrences of precision default): C = A.W + bias over [M, K] x [K, N],
// the bias added after the dot, as in the TPU kernels' _ff_dot(x, iW) + b
// (flappie_tpu/ops/rnn_pallas.py:244, :304, :349, :403).  A library call
// cannot stand in: the affine sits inside each fused layer's one launch.
//
// affine_kernel: the f32 affine of K1, K7 and K8, the parity tier: true f32
// FMA on the CUDA cores (no TF32, no split).  What bounds it on this card:
// operations (M = 655,360, K = 256, N = 1024: 343.6 GFLOP, 5.13 ms at 67
// TFLOP/s, against 1.0 ms of bytes).  Design: 128x128 tiles of 256
// threads, each an 8x8 register tile; K in steps of 16 through a ring of
// F_STAGES = 3 shared-memory stages filled by 16-byte cp.async (the copies
// of step s + 2 fly while step s is multiplied; one barrier a step), two
// CTAs an SM at 128 registers.  A stays
// k-contiguous at a padded row stride: a thread reads 4 k of one of its
// rows as one float4 (a quarter-warp reads one address) and a row of B as
// float4s without bank conflicts.  The bias sits in registers; the outputs
// leave as float4 rows, so a warp writes whole 32-byte sectors.  Every
// element sums its K products by fmaf in k order 0..K-1, then adds the
// bias: one order for every caller (K8's h stays K1's bit for bit), and
// the order of the kernel it replaced.  Off the 4-element grid (K or N not
// a multiple of 4) the copies go element by element.
//
// affine_bf16_kernel: the affine under the bf16 stream (--fast): C =
// bf16(A.W + bias), A and W bf16, f32 sums on the tensor cores, the f32 bias
// after the dot, one round to nearest even.  What bounds it: bytes (335 MB
// read, 1.34 GB written at N = 1024: 0.50 ms at 3.35 TB/s, against 0.35 ms
// at the bf16 tensor rate).  Design: a persistent grid, one CTA an SM.
// CTA c keeps N tile c % nN (256 columns) for its whole life and walks the
// 128-row M blocks c / nN, c / nN + groups, ...: the nN CTAs of a group run
// one M block at about the same time, so A comes from HBM once and from L2
// after.  The CTA's slice of W (K <= 256 rows x 256 columns, 128 KB) comes
// once by TMA, as four 64-column slabs in 128B swizzle, and stays
// resident.  Two consumer warpgroups hold 64 rows of a tile each (128
// f32 sums a thread: setmaxnreg gives them 232 registers, the producers'
// warpgroup 40) and run wgmma.m64n256k16 from shared memory (A K-major; W
// MN-major through the transpose bit, so iW is read as the layers hold
// it), 4 k-steps a 64-deep slot.  They take turns on the tensor cores
// (named barriers), so one warpgroup's epilogue runs under the other's
// products.  Each has its own ring of G_STAGES slots of [64 x 64] A tiles
// (a full and an empty mbarrier a slot), filled by TMA from its own
// producer warp.  The epilogue adds the bias (shared memory, loaded once),
// rounds to bf16, stages 64-column boxes in 128B-swizzled shared memory
// (two buffers a warpgroup, so a box is written while the last one
// leaves) and stores them by TMA, which clips the ragged edges.  TMA needs
// 16-byte strides, so this path takes K % 8 == 0,
// N % 8 == 0 and 0 < K <= 256 (W's slice must fit): every model shape
// (IN = 256; N = 1024 or 768).  Tensor maps are encoded on the host per
// call through cudaGetDriverEntryPoint (no -lcuda).
//
// affine_bf16_wmma_kernel: the bf16 affine for shapes off that grid, which
// no model reaches: nvcuda::wmma bf16 16x16x16 fragments, 128x128 tiles, K
// 32 a step in two cp.async buffers, the epilogue through a warp's f32
// scratch.
//
// Both bf16 kernels take their output type OT as a template argument:
// __nv_bfloat16 (the bf16 stream's xa) or float, the f32-output epilogue of
// the one-pass affine at precision ``default`` on the f32 stream
// (FLAPPIE_TPU_MATMUL_PRECISION=default: rnn_pallas.py:183 _ff_dot at
// lax.Precision.DEFAULT, one bf16 MXU pass with f32 sums, plus the f32 bias,
// into an f32 xa, :243-245 with xa_dtype f32).  The caller rounds x and iW
// to bf16 once before it; the products and sums are the bf16 kernel's, and
// the sum plus the bias is stored as it is: the wgmma path stages 32-column
// f32 boxes (128 bytes a row, 128B swizzle) and stores them by TMA, the wmma
// path writes float4 rows.  What bounds it: bytes (335 MB read, 2.68 GB
// written at M = 655,360, N = 1024: 0.90 ms at 3.35 TB/s).  The bf16-output
// instantiations' code does not depend on OT.
//
// affine_plan picks the path by shape (never on failure) and is mirrored by
// ops/rnn_cuda.py _affine_plan; lstm.cu's flappie_affine_info reports it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace flappie {

// 16 bytes from device memory into shared memory, asynchronously; zeros
// when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(valid ? 16 : 0) : "memory");
}

// ---- the f32 affine ---------------------------------------------------------

constexpr int F_BM = 128, F_BN = 128, F_BK = 16, F_STAGES = 3, F_THREADS = 256;
// a thread's register tile: rows 8*tr .. 8*tr + 7, columns tc*4 .. tc*4 + 3
// and F_GAP + tc*4 .. F_GAP + tc*4 + 3
constexpr int F_TN = 8, F_TC = F_BN / F_TN, F_GAP = F_BN / 2;
constexpr int F_ALD = F_BK + 4;  // A's row stride in floats: padded, 16-byte rows
constexpr int F_A_FLOATS = F_BM * F_ALD;
constexpr int F_STAGE_FLOATS = F_A_FLOATS + F_BK * F_BN;
constexpr int F_SMEM = F_STAGES * F_STAGE_FLOATS * 4;

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// k step k0's A [128 rows x F_BK k] and W [F_BK k x 128 columns] into
// stage (As, Bs), runs of 4, by cp.async (zeros past an edge) or, off the
// 4-element grid, element by element
__device__ __forceinline__ void f_load(float* As, float* Bs, const float* __restrict__ A,
                                       const float* __restrict__ W, long row0, int col0,
                                       int k0, long M, int N, int K, bool vecA, bool vecB) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int q = 0; q < F_BM * F_BK / 4 / F_THREADS; ++q) {
    const int c = tid + q * F_THREADS;
    const int r = c / (F_BK / 4), kc = (c % (F_BK / 4)) * 4;
    const long gr = row0 + r;
    const int gk = k0 + kc;
    float* dst = As + r * F_ALD + kc;
    if (vecA) {
      const bool ok = gr < M && gk < K;
      cp_async16(dst, ok ? A + gr * K + gk : A, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = gr < M && gk + e < K ? A[gr * K + gk + e] : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < F_BK * F_BN / 4 / F_THREADS; ++q) {
    const int c = tid + q * F_THREADS;
    const int r = c / (F_BN / 4), nc = (c % (F_BN / 4)) * 4;
    const int gk = k0 + r, gc = col0 + nc;
    float* dst = Bs + r * F_BN + nc;
    if (vecB) {
      const bool ok = gk < K && gc < N;
      cp_async16(dst, ok ? W + (long)gk * N + gc : W, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[e] = gk < K && gc + e < N ? W[(long)gk * N + gc + e] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(F_THREADS, 2)
affine_kernel(const float* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ bias, float* __restrict__ C,
              long M, int N, int K, bool vecA, bool vecB) {
  extern __shared__ __align__(16) float f_smem[];
  const int tid = threadIdx.x;
  // thread (tr, tc): rows tr*8 .. tr*8+7 of the tile, columns q*F_GAP +
  // tc*4 .. q*F_GAP + tc*4 + 3 for q < F_TN / 4
  const int tr = tid / F_TC, tc = tid % F_TC;
  const long row0 = (long)blockIdx.x * F_BM;
  const int col0 = blockIdx.y * F_BN;
  float acc[8][F_TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < F_TN; ++j) acc[i][j] = 0.f;

  const int steps = (K + F_BK - 1) / F_BK;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < steps) {
      float* st = f_smem + s * F_STAGE_FLOATS;
      f_load(st, st + F_A_FLOATS, A, W, row0, col0, s * F_BK, M, N, K, vecA, vecB);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int s = 0; s < steps; ++s) {
    // step s's copies have landed, and every thread is past step s - 1,
    // whose stage the copies of step s + F_STAGES - 1 refill
    asm volatile("cp.async.wait_group %0;\n" :: "n"(F_STAGES - 2) : "memory");
    __syncthreads();
    const int nxt = s + F_STAGES - 1;
    if (nxt < steps) {
      float* st = f_smem + (nxt % F_STAGES) * F_STAGE_FLOATS;
      f_load(st, st + F_A_FLOATS, A, W, row0, col0, nxt * F_BK, M, N, K, vecA, vecB);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* bs = f_smem + (s % F_STAGES) * F_STAGE_FLOATS + F_A_FLOATS + tc * 4;
    const float* as = f_smem + (s % F_STAGES) * F_STAGE_FLOATS + tr * 8 * F_ALD;
#pragma unroll
    for (int kq = 0; kq < F_BK; kq += 4) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a4[i] = *reinterpret_cast<const float4*>(as + i * F_ALD + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b4[F_TN / 4];
#pragma unroll
        for (int q = 0; q < F_TN / 4; ++q)
          b4[q] = *reinterpret_cast<const float4*>(bs + (kq + kk) * F_BN + q * F_GAP);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = lane_of(a4[i], kk);
#pragma unroll
          for (int j = 0; j < F_TN; ++j) acc[i][j] = fmaf(a, lane_of(b4[j / 4], j % 4), acc[i][j]);
        }
      }
    }
  }

  // epilogue: the bias after the dot, float4 rows where the grid allows
  float bv[F_TN];
#pragma unroll
  for (int j = 0; j < F_TN; ++j) {
    const int gc = col0 + (j / 4) * F_GAP + tc * 4 + j % 4;
    bv[j] = gc < N ? bias[gc] : 0.f;
  }
  const bool vecC = N % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long gr = row0 + tr * 8 + i;
    if (gr >= M) break;
#pragma unroll
    for (int h = 0; h < F_TN / 4; ++h) {
      const int gc = col0 + h * F_GAP + tc * 4;
      const float4 v = make_float4(acc[i][4 * h] + bv[4 * h], acc[i][4 * h + 1] + bv[4 * h + 1],
                                   acc[i][4 * h + 2] + bv[4 * h + 2],
                                   acc[i][4 * h + 3] + bv[4 * h + 3]);
      float* dst = C + gr * N + gc;
      if (vecC && gc + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gc + e < N) dst[e] = lane_of(v, e);
      }
    }
  }
}

// ---- the bf16 affine on wgmma + TMA ----------------------------------------

constexpr int G_BM = 128, G_BN = 256, G_BK = 64, G_STAGES = 4, G_KMAX = 256;
// warpgroups 0 and 1 consume (64 rows of a tile each); warpgroup 2 holds
// the producer warps (warp 8 for warpgroup 0's ring and W, warp 9 for
// warpgroup 1's)
constexpr int G_THREADS = 384;
constexpr int G_SLAB = G_KMAX * 128;           // one 64-column slab of W, bytes
constexpr int G_A_STAGE = 64 * G_BK * 2;       // one warpgroup's A tile, bytes
constexpr int G_BOX = 64 * 64 * 2;             // one staged output box, bytes
constexpr int G_OFF_A = 4 * G_SLAB;            // W's 4 slabs first
constexpr int G_OFF_C = G_OFF_A + 2 * G_STAGES * G_A_STAGE;  // a ring a warpgroup
constexpr int G_OFF_BIAS = G_OFF_C + 2 * 2 * G_BOX;  // 2 warpgroups x 2 buffers
constexpr int G_OFF_BAR = G_OFF_BIAS + G_BN * 4;
constexpr int G_SMEM = G_OFF_BAR + (4 * G_STAGES + 1) * 8 + 1024;  // + alignment slack

// the wmma path's tile: a CTA's 128x128 of C, K 32 a stage, rows padded
// (multiples of 8 bf16), 8 warps (4 along M x 2 along N)
constexpr int HM = 128, HN = 128, HK = 32;
constexpr int H_ALD = HK + 8, H_BLD = HN + 8;
constexpr int H_THREADS = 256;
constexpr int H_SMEM = (2 * HM * H_ALD + 2 * HK * H_BLD) * 2 + (H_THREADS / 32) * 256 * 4;

enum AffinePath { kF32 = 0, kBf16Wmma = 1, kBf16Wgmma = 2 };

// What a launch of the affine does: path, tile rows and columns, k step,
// stages, dynamic (or, for wmma, static) shared bytes, CTAs, output tiles.
struct AffinePlan {
  int path, bm, bn, bk, stages, smem;
  long ctas, tiles;
};

inline bool wgmma_shape(long M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 8 == 0 && N % 8 == 0 && K <= G_KMAX;
}

// the plan of the f32 (bf16 = false) or the bf16 affine on a card of sms
// SMs (ops/rnn_cuda.py _affine_plan mirrors it)
inline AffinePlan affine_plan(long M, int N, int K, bool bf16, int sms) {
  if (!bf16) {
    const long t = ((M + F_BM - 1) / F_BM) * ((N + F_BN - 1) / F_BN);
    return {kF32, F_BM, F_BN, F_BK, F_STAGES, F_SMEM, t, t};
  }
  if (!wgmma_shape(M, N, K)) {
    const long t = ((M + HM - 1) / HM) * ((N + HN - 1) / HN);
    return {kBf16Wmma, HM, HN, HK, 2, H_SMEM, t, t};
  }
  const long mblocks = (M + G_BM - 1) / G_BM;
  const int nN = (N + G_BN - 1) / G_BN;
  long groups = sms / nN;
  if (groups < 1) groups = 1;
  if (groups > mblocks) groups = mblocks;
  return {kBf16Wgmma, G_BM, G_BN, G_BK, G_STAGES, G_SMEM, groups * nN, mblocks * nN};
}

namespace aff {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(saddr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(saddr(bar)) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(saddr(bar)), "r"(parity) : "memory");
}

// the box at (c0 inner, c1 outer) of map into shared memory; its bytes
// complete bar's transaction count
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(saddr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(saddr(src))
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// W is MN-major: 64-column slabs G_SLAB bytes apart (leading), groups of 8
// k rows 1024 bytes apart (stride)
constexpr uint32_t B_LBO = G_SLAB, B_SBO = 1024;

#define FLAPPIE_ACC8(i)                                                               \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] (+)= A[64 x 16] . W[16 x 256], A K-major, W MN-major
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n\t}"
      : FLAPPIE_ACC8(0), FLAPPIE_ACC8(8), FLAPPIE_ACC8(16), FLAPPIE_ACC8(24),
        FLAPPIE_ACC8(32), FLAPPIE_ACC8(40), FLAPPIE_ACC8(48), FLAPPIE_ACC8(56),
        FLAPPIE_ACC8(64), FLAPPIE_ACC8(72), FLAPPIE_ACC8(80), FLAPPIE_ACC8(88),
        FLAPPIE_ACC8(96), FLAPPIE_ACC8(104), FLAPPIE_ACC8(112), FLAPPIE_ACC8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef FLAPPIE_ACC8

// the accumulators are not read or written across this point: the
// compiler sees wgmma's results only when its wait says they are there
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

}  // namespace aff

template <typename OT>
__global__ void __launch_bounds__(G_THREADS, 1)
affine_bf16_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap, const float* __restrict__ bias,
                   long M, int N, int K) {
  // the base rounded up to the 1024-byte swizzle atom here: an extern
  // array declared __align__(1024) would move every kernel's shared
  // window in the module (and change the cluster recurrence's code)
  extern __shared__ __align__(16) uint8_t g_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* Bs = sm;            // W's slabs [4][K rows][64 columns]
  uint8_t* As = sm + G_OFF_A;  // the A rings [2 warpgroups][G_STAGES][64 rows][64 k]
  uint8_t* Cs = sm + G_OFF_C;  // output boxes [2 warpgroups][2][64 rows][64 columns]
  float* bias_s = reinterpret_cast<float*>(sm + G_OFF_BIAS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G_OFF_BAR);  // [2][G_STAGES]
  uint64_t* empty = full + 2 * G_STAGES;                         // [2][G_STAGES]
  uint64_t* wfull = empty + 2 * G_STAGES;

  const int warp = threadIdx.x / 32;
  const int nN = (N + G_BN - 1) / G_BN;
  const int n = blockIdx.x % nN;
  const long groups = gridDim.x / nN;
  const long mblocks = (M + G_BM - 1) / G_BM;
  const long m0 = blockIdx.x / nN;
  const int col0 = n * G_BN;
  const int kblocks = (K + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * G_STAGES; ++s) {
      aff::bar_init(&full[s], 1);
      aff::bar_init(&empty[s], 1);
    }
    aff::bar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producers: warp 8 brings W's slice once and warpgroup 0's A tiles,
    // warp 9 warpgroup 1's; a warpgroup's tile past M is not loaded
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int wg = warp - 8;
    if (wg < 2 && threadIdx.x % 32 == 0) {
      if (wg == 0) {
        const int slabs = min(4, (N - col0 + 63) / 64);
        aff::bar_expect(wfull, (uint32_t)(slabs * kblocks * G_BK * 128));
        for (int s = 0; s < slabs; ++s)
          aff::tma_load(&bmap, Bs + s * G_SLAB, wfull, col0 + s * 64, 0);
      }
      uint8_t* ring = As + wg * G_STAGES * G_A_STAGE;
      int stage = 0;
      uint32_t phase = 0;
      for (long m = m0; m < mblocks; m += groups) {
        const int row = (int)(m * G_BM) + wg * 64;
        if (row >= M) continue;
        for (int kb = 0; kb < kblocks; ++kb) {
          uint64_t* slot = &full[wg * G_STAGES + stage];
          aff::bar_wait(&empty[wg * G_STAGES + stage], phase ^ 1);
          aff::bar_expect(slot, G_A_STAGE);
          aff::tma_load(&amap, ring + stage * G_A_STAGE, slot, kb * G_BK, row);
          if (++stage == G_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows wg*64 .. wg*64+63 of each tile.
  // The two take turns on the tensor cores (named barriers 4 and 5): while
  // one multiplies its tile, the other runs its epilogue.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = warp / 4, t = threadIdx.x % 128, w = t / 32, l = t % 32;
  for (int i = threadIdx.x; i < G_BN; i += 256) bias_s[i] = col0 + i < N ? bias[col0 + i] : 0.f;
  aff::named_sync(1, 256);
  aff::bar_wait(wfull, 0);

  const uint32_t a_base = aff::saddr(As) + wg * G_STAGES * G_A_STAGE;
  const uint32_t b_base = aff::saddr(Bs);
  uint64_t* wfullp = full + wg * G_STAGES;
  uint64_t* wemptyp = empty + wg * G_STAGES;
  // the accumulator layout of m64nNk16: register 4j + e holds row
  // w*16 + l/4 (+8 for e >= 2), column 8j + 2*(l%4) + (e & 1)
  const int r0 = w * 16 + l / 4;
  const int cq = (l % 4) * 2;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  int stage = 0, boxes = 0;  // boxes: this warpgroup's stores so far
  uint32_t phase = 0;
  for (long m = m0; m < mblocks; m += groups) {
    const int grow = (int)(m * G_BM) + wg * 64;
    const bool live = grow < M;
    if (wg == 1) aff::named_sync(4, 256);         // warpgroup 0 has multiplied
    else if (m != m0) aff::named_sync(5, 256);    // warpgroup 1 has multiplied
    int prev = 0;
    if (live) {
      for (int kb = 0; kb < kblocks; ++kb) {
        aff::bar_wait(&wfullp[stage], phase);
        aff::fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < G_BK / 16; ++kk) {
          const uint64_t da = aff::desc(a_base + stage * G_A_STAGE + kk * 32, 16, 1024);
          const uint64_t db =
              aff::desc(b_base + (kb * G_BK + kk * 16) * 128, aff::B_LBO, aff::B_SBO);
          aff::wgmma_256(d, da, db, kb > 0 || kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // the last k block's products may still run; the one before is done
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (kb > 0 && t == 0) aff::bar_arrive(&wemptyp[prev]);
        prev = stage;
        if (++stage == G_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (live) {
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      aff::fence_acc(d);
      if (t == 0) aff::bar_arrive(&wemptyp[prev]);
    }
    // the tensor cores pass to the other warpgroup (handing over before the
    // last products finish measured no faster)
    if (wg == 0) asm volatile("bar.arrive 4, 256;" ::: "memory");
    else if (m + groups < mblocks) asm volatile("bar.arrive 5, 256;" ::: "memory");
    if (!live) continue;

    if constexpr (std::is_same_v<OT, float>) {
      // f32 epilogue: 8 boxes of 32 columns (128 bytes a row), the bias
      // after the dot, staged 128B-swizzled as below and stored by TMA
#pragma unroll
      for (int c = 0; c < G_BN / 32; ++c) {
        if (col0 + c * 32 >= N) break;
        if (t == 0) aff::store_wait_read<1>();  // this buffer's last box has left
        aff::named_sync(2 + wg, 128);
        uint8_t* box = Cs + (wg * 2 + (boxes++ & 1)) * G_BOX;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = c * 4 + jj;
          const float2 bb = *reinterpret_cast<const float2*>(bias_s + c * 32 + jj * 8 + cq);
          // columns jj*8 + cq, +1 of the box: bytes (jj*8 + cq)*4 of the row
          const int chunk = jj * 2 + (cq >> 2), within = (cq & 3) * 4;
          *reinterpret_cast<float2*>(box + r0 * 128 + ((chunk ^ (r0 & 7)) << 4) + within) =
              make_float2(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
          *reinterpret_cast<float2*>(box + (r0 + 8) * 128 + ((chunk ^ (r0 & 7)) << 4) + within) =
              make_float2(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        aff::named_sync(2 + wg, 128);
        if (t == 0) aff::tma_store(&cmap, box, col0 + c * 32, grow);
      }
      continue;
    }
    // epilogue: 4 boxes of 64 columns, the bias after the dot, one round
    // to nearest even, staged 128B-swizzled (16-byte chunk jj of row r at
    // chunk jj ^ (r % 8), as TMA reads it) and stored by TMA
#pragma unroll
    for (int c = 0; c < G_BN / 64; ++c) {
      if (col0 + c * 64 >= N) break;
      if (t == 0) aff::store_wait_read<1>();  // this buffer's last box has left
      aff::named_sync(2 + wg, 128);
      uint8_t* box = Cs + (wg * 2 + (boxes++ & 1)) * G_BOX;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = c * 8 + jj;
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + c * 64 + jj * 8 + cq);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(d[4 * j] + bb.x, d[4 * j + 1] + bb.y);
        const __nv_bfloat162 hi =
            __floats2bfloat162_rn(d[4 * j + 2] + bb.x, d[4 * j + 3] + bb.y);
        const int chunk = ((jj ^ (r0 & 7)) << 4) + cq * 2;
        *reinterpret_cast<__nv_bfloat162*>(box + r0 * 128 + chunk) = lo;
        *reinterpret_cast<__nv_bfloat162*>(box + (r0 + 8) * 128 + chunk) = hi;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      aff::named_sync(2 + wg, 128);
      if (t == 0) aff::tma_store(&cmap, box, col0 + c * 64, grow);
    }
  }
  if (t == 0) aff::store_wait_all();
}

// ---- the bf16 affine off the TMA grid: wmma ---------------------------------

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

template <typename OT>
__global__ void __launch_bounds__(H_THREADS)
affine_bf16_wmma_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                        const float* __restrict__ bias, OT* __restrict__ C,
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
  // 8*half .. 8*half + 7; bias after the dot, round to nearest even (f32
  // output: stored as it is)
  float* cs = &Cs[warp][0][0];
  [[maybe_unused]] uint16_t* C16 = reinterpret_cast<uint16_t*>(C);
  const int r = lane / 2, c8 = (lane % 2) * 8;
  if constexpr (std::is_same_v<OT, float>) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const long gr = row0 + wm * 32 + i * 16 + r;
        const int gc = col0 + wn * 64 + j * 16 + c8;
        if (gr < M) {
          float o[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = cs[r * 16 + c8 + e] + (gc + e < N ? bias[gc + e] : 0.f);
          float* dst = C + gr * N + gc;
          if (N % 4 == 0 && gc + 8 <= N) {
            reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
            reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (gc + e < N) dst[e] = o[e];
          }
        }
        __syncwarp();
      }
    return;
  }
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

// ---- host side -------------------------------------------------------------

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// xa [M, N] = A [M, K] . W [K, N] + bias [N] on stream st; returns the
// launch error code (0 = ok).
inline cudaError_t launch_affine(const float* A, const float* W, const float* bias,
                                 float* C, long M, int N, int K, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(affine_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return err;
  const bool vecA = K % 4 == 0 && aligned16(A), vecB = N % 4 == 0 && aligned16(W);
  dim3 grid((unsigned)((M + F_BM - 1) / F_BM), (unsigned)((N + F_BN - 1) / F_BN));
  affine_kernel<<<grid, F_THREADS, F_SMEM, st>>>(A, W, bias, C, M, N, K, vecA, vecB);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once (null if missing)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major [outer, inner] matrix of bf16 (or, with f32, float) at base,
// read or written in boxes of [box_outer, box_inner], 128B swizzle, zeros
// past the edges
inline bool tile_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                     uint32_t box_inner, uint32_t box_outer, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// xa [M, N] = A [M, K] . W [K, N] + bias [N], A and W bf16, f32 sums, the
// result rounded to bf16 (OT = __nv_bfloat16) or stored as f32 (OT =
// float), on stream st, by the path affine_plan picks; returns the launch
// error code (0 = ok; cudaErrorMisalignedAddress for a TMA operand off 16
// bytes).
template <typename OT = __nv_bfloat16>
inline cudaError_t launch_affine_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W,
                                      const float* bias, OT* C, long M, int N, int K,
                                      cudaStream_t st) {
  constexpr bool F32 = std::is_same_v<OT, float>;
  if (M == 0 || N == 0) return cudaSuccess;
  const AffinePlan p = affine_plan(M, N, K, true, sm_count());
  if (p.path == kBf16Wmma) {
    dim3 grid((unsigned)((M + HM - 1) / HM), (unsigned)((N + HN - 1) / HN));
    affine_bf16_wmma_kernel<OT><<<grid, H_THREADS, 0, st>>>(A, W, bias, C, M, N, K);
    return cudaGetLastError();
  }
  if (!aligned16(A) || !aligned16(W) || !aligned16(C)) return cudaErrorMisalignedAddress;
  const uint32_t krows = (uint32_t)((K + G_BK - 1) / G_BK * G_BK);
  CUtensorMap amap, bmap, cmap;
  if (!tile_map(&amap, A, K, M, G_BK, 64) || !tile_map(&bmap, W, N, K, 64, krows) ||
      !tile_map(&cmap, C, N, M, F32 ? 32 : 64, 64, F32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(affine_bf16_kernel<OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return err;
  affine_bf16_kernel<OT><<<(unsigned)p.ctas, G_THREADS, G_SMEM, st>>>(amap, bmap, cmap, bias, M,
                                                                      N, K);
  return cudaGetLastError();
}

// info = {path, tile rows, tile columns, k step, stages, shared bytes,
// CTAs, output tiles} of the f32 (bf16 = 0) or bf16 (1) affine on this
// card; returns the error code.
inline int affine_info(long M, int N, int K, int bf16, int* info) {
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  const AffinePlan p = affine_plan(M, N, K, bf16 != 0, sms);
  const long v[8] = {p.path, p.bm, p.bn, p.bk, p.stages, p.smem, p.ctas, p.tiles};
  for (int i = 0; i < 8; ++i) info[i] = (int)v[i];
  return 0;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace flappie
