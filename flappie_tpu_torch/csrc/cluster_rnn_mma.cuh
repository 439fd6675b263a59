// The one-pass step on Hopper's tensor cores, sm_90a: the recurrence of
// the layers of precision ``default``, the LSTM's (K1-default, K8-default,
// K1-default-bf16, K8-default-bf16; lstm_p1.cu, GN = 4) and GRU-mod's
// (K7-default, K7-default-bf16; grumod_p1.cu, GN = 3).  With PASSES = 3,
// the three-pass step of rnn precision ``high`` (lstm_h3.cu, grumod_h3.cu;
// the last section below).
//
// Replaces the step product of flappie_tpu/ops/rnn_pallas.py:219
// _lstm_fused_body and :290 _grumod_fused_kernel (dual kernels :322, :386)
// when _make_rdot:172 runs at lax.Precision.DEFAULT: one bf16 MXU pass with
// f32 sums, h and sW rounded to bf16.  The same product on CUDA cores (fmaf
// over operands widened from bf16, 5,120 FMAs a thread a step at R=20, then
// the k slices' partial sums through shared memory) ran slower than the f32
// step it should undercut (PERF.md).
//
// What bounds it: as every cluster recurrence, the chain of T dependent
// steps; a step's work is small (a CTA's product at H=256, R=16 is GN.32
// gate columns x 256 x 16 rows), so the step's latency is its product's
// chain, the cell update, and the exchange of h between the cluster's CTAs.
//
// Design (the cluster of cluster_rnn.cuh: CLUSTER = 8 CTAs on R rows, CTA q
// owning hidden units [q.U, (q+1).U), U = H/8, and every gate of them):
//  - The product is mma.sync.m16n8k16 bf16 -> f32: M the CTA's gate
//    columns, N the cluster's rows padded to n-tiles of 8 (NP), K the
//    exchanged h.  A warp owns MMA_UNITS = 8 units and two m-tiles ordered
//    gate-major: row m of m-tile mt is gate 2.mt + m / 8 of unit slot
//    m % 8 (ops/rnn_cuda.py's _mma_gate_rows mirrors the map).  LSTM: m-tile 0
//    holds gates u | f, m-tile 1 g | o.  GRU-mod: m-tile 0 z | r, m-tile 1
//    hbar | zero rows (gate 3 is a compile-time zero: its A words are the
//    constant 0, a quarter of the MMAs multiply them).  So the accumulator
//    fragment of lane (g, t) holds every gate of unit g for rows 2t and
//    2t+1 of each n-tile: the cell update runs from registers, with no
//    partial sums in shared memory and no block barrier in the step.
//    (One m-tile a gate over 16 units instead would hold 192 A registers
//    at GN = 3, which the accumulators and the state would spill.)
//  - sW's slice, rounded to bf16 once, is held as the warp's A fragments
//    for the whole walk: 2 m-tiles x 16 k-tiles x 4 registers = 128
//    registers a thread at H=256, GN.32 of them not zero (read from shared
//    memory every step instead, they ran 1.3x slower at B=256, 1.15x at
//    B=24: PERF.md).
//  - Rows: R of cluster_rnn.cuh's ROWS from B by mma_cluster_rows, the
//    fewest that keep the clusters within MMA_MAX_CLUSTERS = 16, one CTA
//    an SM for 128 of the 132 (at most 24 KiB of shared memory and 128
//    threads a CTA: the card holds 30 such clusters at once, two CTAs an
//    SM).  A step costs about 1.5, 2.6 and 3.5 us at one, two and three
//    n-tiles, so at B=256 R=16 (two n-tiles, 16 clusters) beats
//    cluster_rows' R=20 (three, 13 clusters) by a quarter, while at B=24
//    R=1 (24 clusters, SMs shared) is slower than R=2 (step_split.py).
//    The kernel is instantiated by its n-tiles NT (1 for R <= 8, 2 for 12
//    and 16, 3 for 20) and takes R at run time: R only bounds the rows a
//    lane loads and stores, and the step's code is NT's.
//  - h, rounded to bf16 where it is made, is exchanged as bf16 in chunks
//    of 8 units: the buffer is [step parity][chunk][NP rows][8 bf16], so a
//    chunk's rows are consecutive 16-byte lines and ldmatrix.x4 reads the B
//    fragments of two k-tiles of an n-tile without a bank conflict.  Chunk
//    c holds the units of warp c % W of CTA c / W (W warps a CTA): K is
//    padded to 64.W, and the padding units' rows of A are zero.
//  - A warp writes its chunk into its own buffer (pairs of units packed to
//    32-bit words by one shuffle), gathers each row's 16 bytes into one
//    lane (four shuffles) and sends each row to each of the 7 peers with
//    one st.async, whose bytes complete the transaction count of the
//    peer's mbarrier for that step (one cp.async.bulk of the chunk a peer
//    instead ran 1.17x slower at B=256, 1.09x at B=24: PERF.md).
//    The barrier of a step counts W + 1 arrivals (each warp once, after its
//    chunk is in place, and thread 0's expect_tx) and the peers' bytes, so
//    a warp waits for its own CTA's warps and its peers' alike: a buffer
//    is rewritten only after every reader of it has sent the step it read
//    it for.  As in cluster_rnn.cuh, xa is loaded a step ahead, each
//    barrier is re-armed by parity, the last step sends nothing, and one
//    cluster barrier before exit keeps every CTA until no peer touches its
//    shared memory.
//
// Summation order (one order for every R, row, stream and WANT_C): column
// (gate, unit) of a row is xa + P, where P is the tensor core's sum over
// each 16-wide k-tile accumulated in f32 over the k-tiles in ascending
// order from 0 (JAX's xa + rdot(h)); GRU-mod's candidate is r.P + xa_h
// (its xa never summed into P).  So K8-default's h is K1-default's bit for
// bit on each stream.
//
// Semantics as cluster_rnn.cuh's (rnn_pallas.py:219-266, :307-317): LSTM
// gates (u, f, g, o), c = f.c + u.g, h = o.tanh(c); GRU-mod gates (z, r,
// hbar), hbar = tanh(r.v_h + xa_h), h = z.h + (1-z).hbar; backward walks t
// from T-1 down, a step at or past a row's length freezes the state and
// writes 0 to out and c_out, padding rows neither read nor write; h (and
// c) are carried in f32 and h is rounded to bf16 once a step, for the
// product; XT (float, or bf16 under the bf16 stream) is the type of xa,
// out and c_out.  WANT_C only with GN = 4.  Limits: H % 16 == 0 and
// H <= 256.
//
// Three passes (PASSES = 3; FLAPPIE_TPU_RNN_PRECISION=high on the card).
// Replaces flappie_tpu/ops/rnn_pallas.py:161 _dot_bf16x3, which _make_rdot
// :172 runs at "high3" (rnn level HIGH, :505-507): h and sW each split into
// a bf16 high part and a bf16 remainder (:154 _split_bf16: hi = bf16(a),
// lo = bf16(a - hi), nearest even), the product h_hi.sW_hi + h_hi.sW_lo +
// h_lo.sW_hi, each pass's exact bf16 products summed in f32 (the lo.lo
// term, ~2^-16 of a product, is dropped; about 2^-21 of mantissa).
//  - sW_hi stays the A fragments in registers.  sW_lo's A fragments, split
//    once, live in shared memory for the whole walk in ldmatrix order: per
//    warp, per k-tile, per m-tile a block of 32 16-byte lines (line 8 i + g
//    holds register i of the lanes 4 g .. 4 g + 3), read every step by one
//    ldmatrix.x4 (64 KiB a CTA at H=256 for the LSTM).  GRU-mod's m-tile 1
//    stores only its gate-2 half (16 lines, ldmatrix.x2): its rows 8-15
//    stay the constant 0 (48 KiB).  A second register copy would not fit
//    beside the first (the one-pass kernel holds 240-243 registers at NT=2).
//  - h_lo = bf16(h - h_hi) is made where h_hi is, and exchanged beside it:
//    the h buffer holds two parts a step parity, [2][hi | lo][KC][NP], each
//    read by ldmatrix as the one-pass kernel reads h; a row's lo line goes
//    to the peers by st.async from other lanes than its hi line, in the
//    same instructions, and the barrier's step bytes double.
//  - Order: for each k-tile in ascending order, acc += A_hi.B_hi, then
//    the correction passes corr += A_hi.B_lo and corr += A_lo.B_hi into a
//    second accumulator; P = acc + corr after the last k-tile: h_hi.sW_hi
//    + (h_hi.sW_lo + h_lo.sW_hi), JAX's (h_hi.sW_hi + h_hi.sW_lo) +
//    h_lo.sW_hi reassociated.  (All three passes in one accumulator save
//    8.NT registers, but the tensor core aligns each small correction to
//    the large running sum and drops its low bits, one way: on chip_smoke's
//    crafted probe that order lay as far from the three-pass twin as the
//    f32 step does, and at one n-tile it ran up to 1.27x slower; PERF.md.)
//    One order for every R, row and WANT_C: K8-high3's h is K1-high3's bit
//    for bit on each stream.
//  - The next step's xa is loaded after the update (not before the
//    product), so that the product holds one set of xa registers, not two.

#pragma once

#include "cluster_rnn.cuh"

namespace flappie {

constexpr int MMA_UNITS = 8;  // hidden units a warp: one 16-byte chunk of h a row

// warps a CTA: the CTA's units in chunks of MMA_UNITS (the last may pad)
inline int mma_warps(int H) { return (H / CLUSTER + MMA_UNITS - 1) / MMA_UNITS; }

// the cluster's rows padded to n-tiles of 8
inline int mma_rows(int R) { return (R + 7) / 8 * 8; }

// clusters of 8 at one CTA an SM within the H100's 132 SMs
constexpr int MMA_MAX_CLUSTERS = 16;

// Rows a cluster walks for a batch of B (ops/rnn_cuda.py _cluster_plan):
// cluster_rows' rule at MMA_MAX_CLUSTERS.
inline int mma_cluster_rows(int B) { return rows_within(B, MMA_MAX_CLUSTERS); }

// 16-byte lines of sW_lo's A fragments a warp keeps for one k-tile (three
// passes): 32 for m-tile 0, and 32 for m-tile 1, or 16 at GN = 3
inline int mma_lo_lines(int GN) { return 32 + (GN == 4 ? 32 : 16); }

// Dynamic shared memory of one CTA: h by step parity (and, with three
// passes, part: hi, lo), CLUSTER.W chunks of NP 16-byte rows; with three
// passes then sW_lo's A fragments, W warps x KT k-tiles x mma_lo_lines.
inline size_t cluster_mma_smem(int H, int R, int GN = 4, int passes = 1) {
  const size_t parts = passes == 3 ? 2 : 1;
  const size_t h = 2 * parts * CLUSTER * mma_warps(H) * mma_rows(R) * 16;
  if (passes != 3) return h;
  const int W = mma_warps(H);
  return h + (size_t)W * (CLUSTER * W / 2) * mma_lo_lines(GN) * 16;
}

// lo and hi rounded to bf16 (nearest even) in one 32-bit word, lo in the
// low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four 8x8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the row
// addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

// two 8x8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the row
// addresses of matrix i (lanes 16-31 give valid addresses, unused)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr)
               : "memory");
}

// d += A (16x16, row) . B (16x8, col), bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void st_async_v4(uint32_t a, const uint32_t (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(a), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(bar) : "memory");
}

template <int GN, int NT, bool WANT_C, typename XT, int PASSES>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_H / 2)
cluster_rnn_mma_kernel(const XT* __restrict__ xa,        // [T, B, GN.H]
                       const float* __restrict__ sW,     // [H, GN.H]
                       const int* __restrict__ lengths,  // [B]
                       XT* __restrict__ out,             // [T, B, H]
                       XT* __restrict__ c_out,           // [T, B, H] if WANT_C
                       int T, int B, int H, int backward,
                       int R) {                          // rows a cluster, in (8.NT - 8, 8.NT]
  static_assert(GN == 4 || (GN == 3 && !WANT_C), "LSTM (with or without c) or GRU-mod");
  static_assert(PASSES == 1 || PASSES == 3, "one bf16 pass or three");
  constexpr bool LSTM = GN == 4;
  constexpr bool H3 = PASSES == 3;
  constexpr int PARTS = H3 ? 2 : 1;     // h's exchanged bf16 parts: hi (and lo)
  constexpr int NP = 8 * NT;            // rows, padded to NT n-tiles of 8
  constexpr int RT = 2 * NT;            // rows a thread updates
  constexpr int KT_MAX = MAX_H / 16;    // k-tiles at H = 256
  constexpr int LO0 = 32, LO1 = GN == 4 ? 32 : 16;  // sW_lo lines of m-tiles 0 and 1
  extern __shared__ __align__(16) uint4 mma_smem[];
  __shared__ __align__(8) uint64_t bar_s[2];  // h of step s arrived: bar_s[s % 2]
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int U = H / CLUSTER;              // hidden units of this CTA
  const int W = (int)blockDim.x / 32;     // warps, mma_warps(H)
  const int KC = CLUSTER * W;             // chunks of the exchanged h
  const int KT = KC / 2;                  // k-tiles of the product
  const int G = GN * H;
  const int warp = (int)threadIdx.x / 32, lane = (int)threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // the fragments' group and thread in group
  const int u = warp * MMA_UNITS + g;     // this lane's unit slot in the CTA
  const bool unit_ok = u < U;
  const int j = q * U + u;                // its hidden unit
  const int row0 = (int)(blockIdx.x / CLUSTER) * R;
  uint4* h_s = mma_smem;                  // [2][PARTS][KC][NP]: 8 bf16 of h a chunk and row
  const int c_me = q * W + warp;          // this warp's chunk
  // the bytes of h the peers send a CTA each step
  const uint32_t step_bytes = (uint32_t)((CLUSTER - 1) * W * NP * 16 * PARTS);
  auto at = [&](int t, int row) { return (long)t * B + row; };

  // sW as the A operand, rounded to bf16 once: A[m][k] of m-tile mt is
  // gate 2.mt (m < 8) or 2.mt + 1 of this warp's unit slot m % 8, at the
  // padded k of chunk k / 8 (zero for a padding unit); a_word packs A[m][k]
  // and A[m][k + 1], the constant 0 on GRU-mod's zero rows (gate 3)
  auto w_at = [&](int gate, int k) -> float {
    const int c = k / MMA_UNITS, uu = (c % W) * MMA_UNITS + k % MMA_UNITS;
    if (!unit_ok || uu >= U) return 0.f;
    return sW[(long)((c / W) * U + uu) * G + gate * H + j];
  };
  auto a_word = [&](int gate, int k) -> uint32_t {
    return gate < GN ? pack_bf16(w_at(gate, k), w_at(gate, k + 1)) : 0u;
  };
  uint32_t a[2][KT_MAX][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kt = 0; kt < KT_MAX; ++kt) {
      const int k = 16 * kt + 2 * tq;
      const bool in = kt < KT;
      const uint32_t f0 = in ? a_word(2 * mt, k) : 0u;
      const uint32_t f1 = in ? a_word(2 * mt + 1, k) : 0u;
      const uint32_t f2 = in ? a_word(2 * mt, k + 8) : 0u;
      const uint32_t f3 = in ? a_word(2 * mt + 1, k + 8) : 0u;
      a[mt][kt][0] = f0;
      a[mt][kt][1] = f1;
      a[mt][kt][2] = f2;
      a[mt][kt][3] = f3;
    }
  // three passes: sW_lo's A fragments, split once, in ldmatrix order into
  // this warp's blocks [KT][LO0 + LO1 lines]: register i of lane (g, tq) at
  // word tq of line 8 i + g (GRU-mod's m-tile 1: registers 0 and 2 at lines
  // g and 8 + g, its gate-3 rows never stored)
  uint4* lo_s = h_s + 2 * PARTS * KC * NP;  // [W][KT][LO0 + LO1]
  if constexpr (H3) {
    auto lo_word = [&](int gate, int k) -> uint32_t {
      if (gate >= GN) return 0u;
      const float w0 = w_at(gate, k), w1 = w_at(gate, k + 1);
      return pack_bf16(w0 - round_bf16(w0), w1 - round_bf16(w1));
    };
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int k = 16 * kt + 2 * tq;
        const uint32_t f[4] = {lo_word(2 * mt, k), lo_word(2 * mt + 1, k),
                               lo_word(2 * mt, k + 8), lo_word(2 * mt + 1, k + 8)};
        uint32_t* blk =
            reinterpret_cast<uint32_t*>(lo_s + (warp * KT + kt) * (LO0 + LO1) + mt * LO0);
        if (mt == 1 && !LSTM) {
          blk[g * 4 + tq] = f[0];
          blk[(8 + g) * 4 + tq] = f[2];
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) blk[(8 * i + g) * 4 + tq] = f[i];
        }
      }
  }
  for (int i = threadIdx.x; i < 2 * PARTS * KC * NP; i += blockDim.x)
    h_s[i] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x == 0) {
    aff::bar_init(&bar_s[0], W + 1);
    aff::bar_init(&bar_s[1], W + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (T > 1) mbar_expect(smem_u32(&bar_s[1]), step_bytes);  // h of step 1
  }

  // the update role: unit j, rows 2.tq and 2.tq + 1 of each n-tile
  int len[RT];
  float c[RT], hreg[RT];  // the carried f32 state (c: LSTM only)
  XT nx[RT][GN];          // the next step's xa, as loaded
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int n = 8 * (r / 2) + 2 * tq + r % 2, row = row0 + n;
    len[r] = (n < R && row < B) ? lengths[row] : 0;
    c[r] = 0.f;
    hreg[r] = 0.f;
  }
  auto load_xa = [&](int t) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int n = 8 * (r / 2) + 2 * tq + r % 2, row = row0 + n;
      const bool live = unit_ok && n < R && row < B;
#pragma unroll
      for (int gt = 0; gt < GN; ++gt)
        nx[r][gt] = live ? xa[at(t, row) * G + gt * H + j] : from_f32<XT>(0.f);
    }
  };
  load_xa(backward ? T - 1 : 0);
  // every CTA of the cluster has started (its barriers may now be armed by
  // peers) and this CTA's A fragments and zero h are in place
  cluster.sync();
  PROBE_INIT()

  const uint32_t h_base = smem_u32(h_s);
  // this lane's ldmatrix row: matrix lane / 8 (chunk 2.kt + lane / 8), row
  // lane % 8 of an n-tile
  const uint32_t lm_off = (uint32_t)(((lane / 8) * NP + lane % 8) * 16);
  // three passes: this warp's sW_lo blocks, and the lo part's offset in a
  // step's h buffer
  const uint32_t lo_base = smem_u32(lo_s) + (uint32_t)(warp * KT * (LO0 + LO1) * 16);
  const uint32_t lo_part = (uint32_t)(KC * NP * 16);
  for (int s = 0; s < T; ++s) {
    const int t = backward ? T - 1 - s : s;
    const uint32_t cur = h_base + (uint32_t)((s & 1) * PARTS * KC * NP * 16);
    uint4* nxt = h_s + ((s + 1) & 1) * PARTS * KC * NP;
    // step s's h of every warp of the cluster (step 0's is the zero
    // state); then the barrier's next phase expects step s + 2's
    if (s > 0) mbar_wait(smem_u32(&bar_s[s & 1]), ((s - 1) >> 1) & 1);
    if (threadIdx.x == 0 && s + 2 < T) mbar_expect(smem_u32(&bar_s[s & 1]), step_bytes);
    PROBE_MARK(0)
    float xcur[RT][GN];
    if constexpr (!H3) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int gt = 0; gt < GN; ++gt) xcur[r][gt] = to_f32(nx[r][gt]);
      if (s + 1 < T) load_xa(backward ? t - 1 : t + 1);
    }

    // P = h . sW: k-tiles in ascending order into each accumulator (three
    // passes: h_hi.sW_hi into acc, the corrections h_hi.sW_lo and
    // h_lo.sW_hi after it into corr)
    float acc[2][NT][4];
    float corr[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[mt][nt][i] = 0.f;
          if constexpr (H3) corr[mt][nt][i] = 0.f;
        }
#pragma unroll
    for (int kt = 0; kt < KT_MAX; kt += 2) {
      if (kt < KT) {
        uint32_t b[NT][4];  // k-tiles kt and kt + 1 of each n-tile
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          ldmatrix_x4(b[nt], cur + lm_off + (uint32_t)((2 * kt * NP + 8 * nt) * 16));
        uint32_t bl[NT][4];  // three passes: h_lo's, the same k-tiles
        if constexpr (H3) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            ldmatrix_x4(bl[nt], cur + lo_part + lm_off + (uint32_t)((2 * kt * NP + 8 * nt) * 16));
        }
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            uint32_t al[4];  // three passes: sW_lo's A fragment of (mt, kt + k2)
            if constexpr (H3) {
              const uint32_t blk =
                  lo_base + (uint32_t)(((kt + k2) * (LO0 + LO1) + mt * LO0) * 16);
              if (mt == 1 && !LSTM) {
                uint32_t d[2];
                ldmatrix_x2(d, blk + (uint32_t)((lane % 16) * 16));
                al[0] = d[0];
                al[1] = 0u;
                al[2] = d[1];
                al[3] = 0u;
              } else {
                ldmatrix_x4(al, blk + (uint32_t)(lane * 16));
              }
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint32_t(&f)[4] = a[mt][kt + k2];
              mma_bf16(acc[mt][nt], f[0], f[1], f[2], f[3], b[nt][2 * k2], b[nt][2 * k2 + 1]);
              if constexpr (H3) {
                mma_bf16(corr[mt][nt], f[0], f[1], f[2], f[3], bl[nt][2 * k2],
                         bl[nt][2 * k2 + 1]);
                mma_bf16(corr[mt][nt], al[0], al[1], al[2], al[3], b[nt][2 * k2],
                         b[nt][2 * k2 + 1]);
              }
            }
          }
      }
    }
    if constexpr (H3) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += corr[mt][nt][i];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int gt = 0; gt < GN; ++gt) xcur[r][gt] = to_f32(nx[r][gt]);
    }
    PROBE_MARK(1)

    float hn[RT], ho[RT], co[RT];  // next h (rounded to bf16), out, c_out
    float hl[RT];                  // three passes: the next h's bf16 remainder
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int nt = r / 2, i = r % 2;
      if constexpr (LSTM) {
        const float vu = xcur[r][0] + acc[0][nt][i];
        const float vf = xcur[r][1] + acc[0][nt][2 + i];
        const float vg = xcur[r][2] + acc[1][nt][i];
        const float vo = xcur[r][3] + acc[1][nt][2 + i];
        const bool valid = t < len[r];
        const float ug = sigmoidf_(vu);
        const float f = sigmoidf_(vf);
        const float gg = tanhf(vg);
        const float o = sigmoidf_(vo);
        const float c2 = f * c[r] + ug * gg;
        const float h2 = o * tanhf(c2);
        co[r] = valid ? c2 : 0.f;
        ho[r] = valid ? h2 : 0.f;
        if (valid) {
          c[r] = c2;
          hreg[r] = h2;
        }
      } else {
        // the candidate's product times r, then its xa (never summed into P)
        const float z = sigmoidf_(xcur[r][0] + acc[0][nt][i]);
        const float rg = sigmoidf_(xcur[r][1] + acc[0][nt][2 + i]);
        const float hbar = tanhf(rg * acc[1][nt][i] + xcur[r][2]);
        const bool valid = t < len[r];
        const float h2 = z * hreg[r] + (1.f - z) * hbar;
        ho[r] = valid ? h2 : 0.f;
        if (valid) hreg[r] = h2;
      }
      hn[r] = unit_ok ? round_bf16(hreg[r]) : 0.f;
      if constexpr (H3) hl[r] = unit_ok ? round_bf16(hreg[r] - hn[r]) : 0.f;
    }
    if constexpr (H3) {
      if (s + 1 < T) load_xa(backward ? t - 1 : t + 1);
    }
    PROBE_MARK(2)

    // the new h into this warp's chunk of the next-step buffer, units 2p
    // and 2p + 1 of a row in word p (lanes g and g ^ 1 trade the row the
    // other keeps), then to every peer's, unless this is the last step
    // (three passes: h_lo likewise into the lo part)
    if (s + 1 < T) {
      const bool odd = g & 1;
      uint32_t word[NT];
      uint32_t wlo[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float got = __shfl_xor_sync(0xffffffffu, odd ? hn[2 * nt] : hn[2 * nt + 1], 4);
        word[nt] = odd ? pack_bf16(got, hn[2 * nt + 1]) : pack_bf16(hn[2 * nt], got);
        const int n = 8 * nt + 2 * tq + odd;
        reinterpret_cast<uint32_t*>(nxt + c_me * NP + n)[g >> 1] = word[nt];
        if constexpr (H3) {
          const float gl = __shfl_xor_sync(0xffffffffu, odd ? hl[2 * nt] : hl[2 * nt + 1], 4);
          wlo[nt] = odd ? pack_bf16(gl, hl[2 * nt + 1]) : pack_bf16(hl[2 * nt], gl);
          reinterpret_cast<uint32_t*>(nxt + KC * NP + c_me * NP + n)[g >> 1] = wlo[nt];
        }
      }
      const uint32_t bar = smem_u32(&bar_s[(s + 1) & 1]);
      // each row's four words gathered in the lanes of that row; one of
      // them sends it to each peer (three passes: the hi line from lanes
      // g / 2 == nt % 4, the lo line from lanes g / 2 == (nt + 2) % 4)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t row4[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          row4[p] = __shfl_sync(0xffffffffu, word[nt], 4 * (2 * p + odd) + tq);
        if constexpr (!H3) {
          if ((g >> 1) == (nt & 3)) {
            const uint32_t a_row = smem_u32(nxt + c_me * NP + 8 * nt + 2 * tq + odd);
#pragma unroll
            for (int p = 1; p < CLUSTER; ++p) {
              const uint32_t rank = (uint32_t)((q + p) % CLUSTER);
              st_async_v4(map_rank(a_row, rank), row4, map_rank(bar, rank));
            }
          }
        } else {
          uint32_t row4l[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            row4l[p] = __shfl_sync(0xffffffffu, wlo[nt], 4 * (2 * p + odd) + tq);
          const bool hi_lane = (g >> 1) == (nt & 3), lo_lane = (g >> 1) == ((nt + 2) & 3);
          if (hi_lane || lo_lane) {
            uint32_t v[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) v[p] = lo_lane ? row4l[p] : row4[p];
            const uint32_t a_row =
                smem_u32(nxt + (lo_lane ? KC * NP : 0) + c_me * NP + 8 * nt + 2 * tq + odd);
#pragma unroll
            for (int p = 1; p < CLUSTER; ++p) {
              const uint32_t rank = (uint32_t)((q + p) % CLUSTER);
              st_async_v4(map_rank(a_row, rank), v, map_rank(bar, rank));
            }
          }
        }
      }
      // the warp's arrival releases its lanes' stores (after __syncwarp)
      __syncwarp();
      if (lane == 0) aff::bar_arrive(&bar_s[(s + 1) & 1]);
    }
    PROBE_MARK(3)

#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int n = 8 * (r / 2) + 2 * tq + r % 2, row = row0 + n;
      if (unit_ok && n < R && row < B) {
        out[at(t, row) * H + j] = from_f32<XT>(ho[r]);
        if (WANT_C) c_out[at(t, row) * H + j] = from_f32<XT>(co[r]);
      }
    }
    PROBE_MARK(4)
  }
  PROBE_END(T)
  // no CTA leaves while a peer may still touch its shared memory
  cluster.sync();
}

// Launch the instantiation of R's n-tiles at R rows a cluster (any R of
// ROWS, whatever B), or, with max_active, only ask how many of its
// clusters the card holds at once.
template <int GN, int NT, bool WANT_C, typename XT, int PASSES>
cudaError_t cluster_rnn_mma_nt(const RnnArgs<XT>& a, int R, int* max_active) {
  return launch_clusters<XT>(cluster_rnn_mma_kernel<GN, NT, WANT_C, XT, PASSES>, R,
                             32 * mma_warps(a.H), cluster_mma_smem(a.H, R, GN, PASSES), a,
                             max_active, R);
}

template <int GN, bool WANT_C, typename XT, int PASSES = 1>
cudaError_t cluster_rnn_mma_r(const RnnArgs<XT>& a, int R, int* max_active) {
  if (!cluster_h_ok(a.H) || a.B <= 0 || R <= 0) return cudaErrorInvalidValue;
  switch (mma_rows(R) / 8) {
    case 1: return cluster_rnn_mma_nt<GN, 1, WANT_C, XT, PASSES>(a, R, max_active);
    case 2: return cluster_rnn_mma_nt<GN, 2, WANT_C, XT, PASSES>(a, R, max_active);
    case 3: return cluster_rnn_mma_nt<GN, 3, WANT_C, XT, PASSES>(a, R, max_active);
    default: return cudaErrorInvalidValue;
  }
}

// The one-pass (or, with PASSES = 3, three-pass) recurrence of GN gates (4
// LSTM, 3 GRU-mod) over a time-major xa at the rows mma_cluster_rows(B)
// picks; returns the launch error code.
template <int GN, bool WANT_C, typename XT, int PASSES = 1>
cudaError_t cluster_rnn_mma(const RnnArgs<XT>& a, int* max_active = nullptr) {
  return cluster_rnn_mma_r<GN, WANT_C, XT, PASSES>(a, mma_cluster_rows(a.B), max_active);
}

// info = {rows a cluster, clusters, shared bytes a CTA, clusters the card
// holds at once} for a batch of B; returns the error code.
template <int GN, bool WANT_C, typename XT, int PASSES = 1>
int cluster_mma_info(int B, int H, int* info) {
  RnnArgs<XT> a = {};
  a.T = 1;
  a.B = B;
  a.H = H;
  int n = 0;
  const cudaError_t err = cluster_rnn_mma<GN, WANT_C, XT, PASSES>(a, &n);
  if (err != cudaSuccess) return err;
  const int R = mma_cluster_rows(B);
  info[0] = R;
  info[1] = (B + R - 1) / R;
  info[2] = (int)cluster_mma_smem(H, R, GN, PASSES);
  info[3] = n;
  return 0;
}

}  // namespace flappie
