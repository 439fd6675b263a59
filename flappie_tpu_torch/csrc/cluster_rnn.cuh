// The cluster recurrence for Hopper, sm_90a: one kernel for the LSTM steps
// of K1, K8 and K12 (lstm.cu) and the GRU-mod steps of K7 and K12
// (grumod.cu).
//
// What bounds a recurrence on this card: T dependent steps, each of which
// needs all of sW (H.GN.H f32: 1 MiB for LSTM, 768 KiB for GRU-mod), more
// than one block's 227 KB of shared memory.  A block that reads sW from L2
// at every step paid ~17-22 us a step whatever its rows (H100 80GB HBM3 at
// 700 W).
//
// Design: a thread-block cluster of CLUSTER = 8 CTAs (the portable size,
// one CTA per SM) walks R batch rows.
//  - CTA q owns hidden units [q.U, (q+1).U), U = H/8, and every gate column
//    of those units: GN.U columns (128 for LSTM, 96 for GRU-mod at H=256).
//    Its slice of sW, [H][U][GN] (128 KiB or 96 KiB), is loaded into shared
//    memory once and stays there for the whole walk: no step reads sW from
//    global memory.  All gates of a unit sit in one CTA, so the cell update
//    is local.
//  - Each CTA holds the whole h [H][R] of its cluster's rows, double-
//    buffered by step parity.  Its H/2 threads are (unit u, k slice ks):
//    thread (u, ks) sums the GN.R gate columns of unit u over the k range
//    [ks.H/4, (ks+1).H/4) into registers (h broadcast from shared memory,
//    GN weights a k as one vector load), and writes the partial sums to
//    shared memory.  After one block barrier, thread (u, ks) updates unit u
//    for its R/4 rows (or row ks when R < 4): it adds the slices' partial
//    sums in slice order, applies the cell (LSTM's c stays in registers),
//    and writes out (and c_out).
//  - The new h goes to every peer's next-step buffer with st.async, whose
//    bytes complete the transaction count of that peer's mbarrier for the
//    step; a CTA waits on its own barrier for its peers' h before the next
//    step: it waits for the bytes it needs, not for every thread of the
//    cluster at a cluster-wide barrier.  The next buffer is
//    free: a peer writes step s+2's h into it only after it has received
//    this CTA's h of step s+1, which is sent after this CTA's product of
//    step s has read that buffer.  The last step sends nothing, and one
//    cluster barrier before exit keeps every CTA until no peer touches its
//    shared memory.
//  - The updating thread loads its xa one step ahead into registers, so
//    device-memory latency stays off the chain.
//  - Rows: R in {1, 2, 4, 8, 12, 16, 20} from B (cluster_rows: the fewest
//    rows that let every cluster be resident at once; the H100 holds 15
//    clusters of 8 at one CTA an SM, cudaOccupancyMaxActiveClusters), so a
//    batch of 24 or 32 rows still spreads over 8-12 clusters and 256 rows
//    run in 13.  Clusters share nothing: more than fit run in waves.
//
// Summation order (one order for every R, row and instantiation): column
// (g, j) of a row is xa + s0 + s1 + s2 + s3, added left to right, where s_i
// is the sum over slice i's k in ascending order; GRU-mod's candidate
// column starts from s0 (its xa_h is added after the multiply by r, never
// summed into v).  So K8's h is K1's h bit for bit, and K12 over a caller's
// affine is K1 over the same affine bit for bit, whatever the batch.
//
// Stream type XT (float, or __nv_bfloat16 under the bf16 stream, --fast;
// instantiated for K1, K7 and K8): the type of xa, out and c_out.  A bf16
// xa is loaded a step ahead as it is and widened to f32 where the step
// takes it, and the outputs are rounded to bf16 (nearest even) where they
// are stored; h, the DSMEM exchange, the partial sums, the carried c and
// the summation order stay f32 and unchanged, as in the TPU kernels
// (rnn_pallas.py:255, :263-265: xa.astype(f32) + h.sW, the carry f32, the
// stored outputs cast; K8's c at xa_dtype, :542).
//
// The one-pass step product of precision ``default`` is not here: it runs
// on the tensor cores for both cell types (cluster_rnn_mma.cuh).  The
// float instantiations' code does not depend on XT (compare_rnn.py matches
// their SASS with an earlier build's).
//
// Semantics (flappie_tpu/ops/rnn_pallas.py:236-266, :307-317): backward
// walks t from T-1 down; a step at or past a row's length freezes (h, c)
// and writes 0 to out and c_out; padding rows >= B neither read nor write.
// Limits: H % 16 == 0 and H <= 256 (an eighth of sW at H=512 is 512 KiB,
// more than an SM has).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "affine.cuh"
#include "step_probe.cuh"

namespace flappie {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;       // CTAs a cluster, one SM each
constexpr int KSPLIT = 4;        // k slices a gate column is summed in
constexpr int MAX_H = 256;       // H.GN.H/8 floats of sW must fit an SM
// clusters of 8 the H100 SXM holds at once at one CTA an SM
// (cudaOccupancyMaxActiveClusters; its GPCs do not all hold two)
constexpr int MAX_CLUSTERS = 15;
constexpr int ROWS[] = {1, 2, 4, 8, 12, 16, 20};  // rows a cluster, instantiated

// The fewest rows of ROWS that keep a batch of B within ``most`` clusters,
// else the most (ops/rnn_cuda.py _rows).
inline int rows_within(int B, int most) {
  for (int R : ROWS)
    if ((B + R - 1) / R <= most) return R;
  return ROWS[sizeof(ROWS) / sizeof(ROWS[0]) - 1];
}

// Rows a cluster walks for a batch of B (ops/rnn_cuda.py _cluster_plan):
// the fewest that let every cluster run at once, else the most.
inline int cluster_rows(int B) { return rows_within(B, MAX_CLUSTERS); }

// Dynamic shared memory of one CTA: sW's slice, h by step parity, and the
// k slices' partial sums.
inline size_t cluster_smem(int H, int GN, int R) {
  const size_t C = (size_t)GN * (H / CLUSTER);
  return sizeof(float) * (H * C + 2 * (size_t)H * R + KSPLIT * R * C);
}

inline bool cluster_h_ok(int H) { return H > 0 && H % 16 == 0 && H <= MAX_H; }

template <int N>
__device__ __forceinline__ void load_vec(float (&d)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      d[4 * i] = v.x;
      d[4 * i + 1] = v.y;
      d[4 * i + 2] = v.z;
      d[4 * i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x;
    d[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = p[i];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the address of this CTA's shared-memory word at ``a`` in CTA ``rank``
__device__ __forceinline__ uint32_t map_rank(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// N floats into a peer's shared memory; their bytes complete the
// transaction count of the peer's mbarrier at ``bar``
template <int N>
__device__ __forceinline__ void st_async(uint32_t a, const float (&s)[N], uint32_t bar) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
          :: "r"(a + 16 * i), "r"(__float_as_uint(s[4 * i])), "r"(__float_as_uint(s[4 * i + 1])),
             "r"(__float_as_uint(s[4 * i + 2])), "r"(__float_as_uint(s[4 * i + 3])), "r"(bar)
          : "memory");
  } else if constexpr (N == 2) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
        :: "r"(a), "r"(__float_as_uint(s[0])), "r"(__float_as_uint(s[1])), "r"(bar)
        : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                   :: "r"(a + 4 * i), "r"(__float_as_uint(s[i])), "r"(bar) : "memory");
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// this CTA's one arrival of a phase, which also expects ``bytes``
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// a stream value to f32 and back (XT = float: nothing)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename XT>
__device__ __forceinline__ XT from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive bf16 values widened to f32 (a bf16 is the high half of
// its f32): one 8-byte load for N = 4, else element by element
template <int N>
__device__ __forceinline__ void load_vec(float (&d)[N], const __nv_bfloat16* p) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    d[0] = __uint_as_float(v.x << 16);
    d[1] = __uint_as_float(v.x & 0xFFFF0000u);
    d[2] = __uint_as_float(v.y << 16);
    d[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = __bfloat162float(p[i]);
  }
}

// v rounded to bf16 (nearest even), as f32
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&s)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = s[i];
  }
}

// GN = 4: LSTM, gates (u, f, g, o), c = f*c + u*g, h = o*tanh(c).
// GN = 3: GRU-mod, gates (z, r, hbar), hbar = tanh(r*v_h + xa_h),
//         h = z*h + (1-z)*hbar.
template <int GN, int R, bool WANT_C, bool BATCH_MAJOR, typename XT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_H / 2)
cluster_rnn_kernel(const XT* __restrict__ xa,        // [T, B, GN.H] or [B, T, GN.H]
                   const float* __restrict__ sW,     // [H, GN.H]
                   const int* __restrict__ lengths,  // [B]
                   XT* __restrict__ out,             // [T, B, H] or [B, T, H]
                   XT* __restrict__ c_out,           // [T, B, H] if WANT_C
                   int T, int B, int H, int backward) {
  constexpr bool LSTM = GN == 4;
  constexpr int RP = R >= KSPLIT ? R / KSPLIT : 1;  // rows a thread updates
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar_s[2];  // h of step s arrived: bar_s[s % 2]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int U = H / CLUSTER;  // hidden units of this CTA
  const int C = GN * U;       // its gate columns, unit-major: u.GN + g
  const int G = GN * H;
  const int KS = H / KSPLIT;  // k a slice
  float* w_s = smem;              // [H][U][GN]: this CTA's columns of sW
  float* h_s = w_s + H * C;       // [2][H][R]: h by step parity
  float* p_s = h_s + 2 * H * R;   // [KSPLIT][R][U][GN]: the slices' partial sums
  const int tid = threadIdx.x;    // blockDim.x == U * KSPLIT == H / 2
  const int u = tid % U, ks = tid / U;
  const int j = q * U + u;        // the hidden unit of this thread's columns
  const int row0 = (int)(blockIdx.x / CLUSTER) * R;
  // the bytes of h the peers send a CTA each step
  const uint32_t step_bytes = (uint32_t)((CLUSTER - 1) * U * R * sizeof(float));
  // row-major offsets of (t, row) in xa (in units of G) and out (of H)
  auto at = [&](int t, int row) {
    return BATCH_MAJOR ? (long)row * T + t : (long)t * B + row;
  };

  // sW's columns of this CTA's units, once for the whole walk (u fastest:
  // coalesced reads)
  for (int i = tid; i < H * C; i += blockDim.x) {
    const int k = i / C, g = (i % C) / U, uu = i % U;
    w_s[k * C + uu * GN + g] = sW[(long)k * G + g * H + q * U + uu];
  }
  for (int i = tid; i < 2 * H * R; i += blockDim.x) h_s[i] = 0.f;
  if (tid == 0) {
    mbar_init(smem_u32(&bar_s[0]));
    mbar_init(smem_u32(&bar_s[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (T > 1) mbar_expect(smem_u32(&bar_s[1]), step_bytes);  // h of step 1
  }

  // the update role: unit j, rows r0 .. r0 + RP - 1 of the cluster
  const int r0 = ks * RP;
  const bool updater = r0 < R;
  int len[RP];
  float c[RP];
  XT nx[RP][GN];  // the next step's xa, as loaded (widened when the step takes it)
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int row = row0 + r0 + i;
    len[i] = (updater && row < B) ? lengths[row] : 0;
    c[i] = 0.f;
  }
  auto load_xa = [&](int t) {
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int row = row0 + r0 + i;
      const bool live = updater && row < B;
#pragma unroll
      for (int g = 0; g < GN; ++g) nx[i][g] = live ? xa[at(t, row) * G + g * H + j] : from_f32<XT>(0.f);
    }
  };
  load_xa(backward ? T - 1 : 0);
  // every CTA of the cluster has started (its shared memory, barriers
  // included, may now be written by peers) and this CTA's sW slice and h
  // are in place
  cluster.sync();
  PROBE_INIT()

  const float* w_mine = w_s + u * GN;
  float* p_mine = p_s + ks * R * C + u * GN;
  for (int s = 0; s < T; ++s) {
    const int t = backward ? T - 1 - s : s;
    const float* h_cur = h_s + (s & 1) * H * R;
    float* h_nxt = h_s + ((s + 1) & 1) * H * R;
    // the peers' h of step s (step 0's is the zero state); then the
    // barrier's next phase expects step s + 2's
    if (s > 0) mbar_wait(smem_u32(&bar_s[s & 1]), ((s - 1) >> 1) & 1);
    if (tid == 0 && s + 2 < T) mbar_expect(smem_u32(&bar_s[s & 1]), step_bytes);
    PROBE_MARK(0)
    float xcur[RP][GN];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int g = 0; g < GN; ++g) xcur[i][g] = to_f32(nx[i][g]);
    if (s + 1 < T) load_xa(backward ? t - 1 : t + 1);

    float acc[R][GN];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < GN; ++g) acc[r][g] = 0.f;
#pragma unroll 4
    for (int k = ks * KS; k < (ks + 1) * KS; ++k) {
      float w[GN], hr[R];
      load_vec(w, w_mine + k * C);
      load_vec(hr, h_cur + k * R);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < GN; ++g) acc[r][g] = fmaf(hr[r], w[g], acc[r][g]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) store_vec(p_mine + r * C, acc[r]);
    __syncthreads();
    PROBE_MARK(1)

    float hn[RP], ho[RP], co[RP];  // next h, out, c_out
    if (updater) {
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int r = r0 + i;
        float v[GN];
#pragma unroll
        for (int g = 0; g < GN; ++g) {
          // xa first (GRU-mod's candidate: 0), then the slices in order
          v[g] = (LSTM || g < 2) ? xcur[i][g] : 0.f;
#pragma unroll
          for (int kk = 0; kk < KSPLIT; ++kk) v[g] += p_s[(kk * R + r) * C + u * GN + g];
        }
        const float h_old = h_cur[j * R + r];
        const bool valid = t < len[i];
        float h2;
        if constexpr (LSTM) {
          const float ug = sigmoidf_(v[0]);
          const float f = sigmoidf_(v[1]);
          const float gg = tanhf(v[2]);
          const float o = sigmoidf_(v[3]);
          const float c2 = f * c[i] + ug * gg;
          h2 = o * tanhf(c2);
          co[i] = valid ? c2 : 0.f;
          if (valid) c[i] = c2;
        } else {
          const float z = sigmoidf_(v[0]);
          const float rg = sigmoidf_(v[1]);
          const float hbar = tanhf(rg * v[2] + xcur[i][2]);
          h2 = z * h_old + (1.f - z) * hbar;
        }
        ho[i] = valid ? h2 : 0.f;
        hn[i] = valid ? h2 : h_old;
      }
      PROBE_MARK(2)
      // the new h of unit j into this CTA's next-step buffer and, unless
      // this is the last step, every peer's (st.async completes the bytes
      // on the peer's barrier of that step)
      float* mine = h_nxt + j * R + r0;
      store_vec(mine, hn);
      if (s + 1 < T) {
        const uint32_t a = smem_u32(mine), bar = smem_u32(&bar_s[(s + 1) & 1]);
#pragma unroll
        for (int p = 1; p < CLUSTER; ++p) {
          const uint32_t rank = (uint32_t)((q + p) % CLUSTER);
          st_async(map_rank(a, rank), hn, map_rank(bar, rank));
        }
      }
      PROBE_MARK(3)
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int row = row0 + r0 + i;
        if (row < B) {
          out[at(t, row) * H + j] = from_f32<XT>(ho[i]);
          if (WANT_C) c_out[at(t, row) * H + j] = from_f32<XT>(co[i]);
        }
      }
    }
    // the partial sums and this CTA's own h are read before the next step
    // writes them
    __syncthreads();
    PROBE_MARK(4)
  }
  PROBE_END(T)
  // no CTA leaves while a peer may still touch its shared memory
  cluster.sync();
}

template <typename XT = float>
struct RnnArgs {
  const XT* xa;
  const float* sW;
  const int* lengths;
  XT* out;
  XT* c_out;
  int T, B, H, backward;
  cudaStream_t st;
};

// a cluster recurrence kernel: (xa, sW, lengths, out, c_out, T, B, H,
// backward, then the kernel's own arguments Extra)
template <typename XT, typename... Extra>
using RnnKernel = void (*)(const XT*, const float*, const int*, XT*, XT*, int, int, int, int,
                           Extra...);

// Launch a cluster recurrence ``kernel`` over a's batch at R rows a
// cluster (clusters of CLUSTER CTAs of ``threads`` threads, ``smem``
// dynamic shared bytes a CTA), or, with max_active, only ask how many of
// its clusters the card holds at once (cudaOccupancyMaxActiveClusters);
// ``extra``: the kernel's own arguments after a's.
template <typename XT, typename... Extra>
cudaError_t launch_clusters(RnnKernel<XT, Extra...> kernel, int R, int threads, size_t smem,
                            const RnnArgs<XT>& a, int* max_active, Extra... extra) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int clusters = (a.B + R - 1) / R;
  if (max_active != nullptr) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CLUSTER);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(max_active, reinterpret_cast<const void*>(kernel),
                                          &cfg);
  }
  kernel<<<clusters * CLUSTER, threads, smem, a.st>>>(a.xa, a.sW, a.lengths, a.out, a.c_out, a.T,
                                                      a.B, a.H, a.backward, extra...);
  return cudaGetLastError();
}

// Launch one instantiation, or, with max_active, only ask how many of its
// clusters the card holds at once.
template <int GN, int R, bool WANT_C, bool BATCH_MAJOR, typename XT>
cudaError_t cluster_rnn_r(const RnnArgs<XT>& a, int* max_active) {
  return launch_clusters<XT>(cluster_rnn_kernel<GN, R, WANT_C, BATCH_MAJOR, XT>, R, a.H / 2,
                             cluster_smem(a.H, GN, R), a, max_active);
}

// The recurrence over xa at the rows cluster_rows(B) picks; returns the
// launch error code (a refused launch, e.g. cudaErrorClusterOutOfResources,
// included).  XT: the stream type of xa, out and c_out.
template <int GN, bool WANT_C, bool BATCH_MAJOR, typename XT = float>
cudaError_t cluster_rnn(const RnnArgs<XT>& a, int* max_active = nullptr) {
  if (!cluster_h_ok(a.H) || a.B <= 0) return cudaErrorInvalidValue;
  switch (cluster_rows(a.B)) {
    case 1: return cluster_rnn_r<GN, 1, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    case 2: return cluster_rnn_r<GN, 2, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    case 4: return cluster_rnn_r<GN, 4, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    case 8: return cluster_rnn_r<GN, 8, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    case 12: return cluster_rnn_r<GN, 12, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    case 16: return cluster_rnn_r<GN, 16, WANT_C, BATCH_MAJOR, XT>(a, max_active);
    default: return cluster_rnn_r<GN, 20, WANT_C, BATCH_MAJOR, XT>(a, max_active);
  }
}

// info = {rows a cluster, clusters, shared bytes a CTA, clusters the card
// holds at once} for a batch of B; returns the error code.
template <int GN, bool WANT_C, bool BATCH_MAJOR, typename XT = float>
int cluster_info(int B, int H, int* info) {
  RnnArgs<XT> a = {};
  a.T = 1;
  a.B = B;
  a.H = H;
  int n = 0;
  const cudaError_t err = cluster_rnn<GN, WANT_C, BATCH_MAJOR, XT>(a, &n);
  if (err != cudaSuccess) return err;
  const int R = cluster_rows(B);
  info[0] = R;
  info[1] = (B + R - 1) / R;
  info[2] = (int)cluster_smem(H, GN, R);
  info[3] = n;
  return 0;
}

}  // namespace flappie
