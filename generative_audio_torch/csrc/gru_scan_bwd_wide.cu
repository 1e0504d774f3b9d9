// GRU backward scan over time-major residuals redesigned for the sub-band
// batch (H <= 512 over thousands of rows) as a wide cluster with both
// per-step products on Hopper's warpgroup MMA (wgmma), for sm_90a:
// gru_scan_bwd_wide.
//
// Replaces the same TPU kernel as csrc/gru_scan_bwd.cu's resident cluster,
// where ops/lstm.py plan_bwd (through ops/gru.py plan_bwd_scan) finds this
// design faster: generative_audio_tpu/ops/pallas_lstm.py:1019
// _gru_pallas_call_bwd / _gru_bwd_kernel (pl.pallas_call at :1043), the
// reverse-time backward that recomputes the h-side gates from the bf16 h
// sequence. What it computes is gru_scan_bwd.cu's scan, bit for bit (see
// Numerics below):
//   h_prev = h_seq one processing step earlier (bf16); zero at p = 0
//   gh     = h_prev @ W_hh + b_hh                                (fp32 acc)
//   r, z   = sigmoid(x_r + gh_r), sigmoid(x_z + gh_z); n = tanh(x_n + r*gh_n)
//   dh_tot = float(gout[t]) + dh
//   dn = dh_tot*(1-z); dz = dh_tot*(float(h_prev) - n); dxn = dn*(1-n^2)
//   dgr = dxn*gh_n*r*(1-r); dgz = dz*z*(1-z); dhn = dxn*r
//   dgx[t] = bf16([dgr, dgz, dxn]);  dhn[t] = bf16(dhn)
//   dh    = bf16([dgr, dgz, dhn]) @ W_hh^T + dh_tot*z               (fp32 acc)
//   db_hh += sum over rows of [dgr, dgz, dhn], one fp32 partial per 16-row tile
// gates, dgx [T, B, 3H] bf16 (torch gate order r, z, n); h_seq, gout, dhn
// [T, B, H] bf16; b_hh [3H] fp32. W_hh comes packed twice by the wrapper
// as wgmma's K-major B operands (ops/gru.py _wide_bwd_weights): wrec, each
// CTA's W_hh^T slice in 64-deep chunks, [C][H/64][8 k8 groups][3U][8] bf16
// (row n = q U + u holds gate q of the CTA's unit u), and wdh, the W_hh
// rows of each CTA's units in 64-deep chunks over the 3H columns,
// [C][3H/64][8][U][8] bf16. dW_hh is the contraction of gru_scan_bwd.cu.
//
// What bounds it on an H100. At the training shape (T = 195, 2304 rows, H =
// 384) the scan does 2 * 2*T*rows*H*3H = 0.80 TFLOP of bf16 products and
// must move T*rows*(3H + H + H + 3H + H)*2 B = 3.1 GB: 0.93 ms, by bytes.
// The chain of 195 steps is serial. The resident cluster of gru_scan_bwd.cu
// fits 16 rows a cluster of 8 (ten waves); the first wide design (kernel
// D's, mma.sync) fits 80 (two waves). Here a CTA owns U = H / C units and
// R = 64, 128 or 192 rows, R / 64 consumer warpgroups of 64 rows each, so a
// cluster of 8 takes 192 rows and 2304 rows run in one wave of 12 clusters:
//   * Both products run on wgmma with M = the warpgroup's 64 rows and N =
//     gate columns: the recompute [64 x 3U] (m64n144k16 at U = 48) and the
//     second product [64 x U] (m64n48k16). The A operands are TMA's
//     128-byte-swizzled boxes of 64 columns as they arrive (h_prev, and the
//     dgh pieces read back from L2), described K-major with the swizzle
//     (8 rows 1024 bytes apart, a k16 step 32 bytes on within the atom);
//     the B operands are the packed weights, K-major without swizzle. In
//     wgmma's accumulator layout a thread holds rows lane / 4 and + 8 of
//     its warp's 16 and, for each 8-column block, columns 2 (lane % 4) and
//     + 1: with the recompute's columns gate-major (q U + u) it holds r, z,
//     n and dh of the same (row, unit) pairs, which is what the cell needs,
//     and each warp's 16 rows are one m16 tile of the batch, as each warp
//     of the mma.sync designs had.
//   * One ring of `stages` slots carries everything a step reads, in the
//     order the warps take it: the cell's operands of step s in U/8 blocks
//     of 8 units ([5][R][8] bf16: the gates r, z, n, gout, h_prev), the
//     H/64 h_prev boxes of step s+1, each with its W_hh^T chunk [3U][64],
//     and the 3H/64 dgh pieces of step s (dgx's r and z columns, then dhn,
//     two tensor maps), each with its W_hh rows [U][64]. A product's stage
//     is one wgmma commit group of four k16 steps; its slot goes back once
//     the next stage's group is issued and wait_group 1 retires it (so a
//     ring needs two slots). One warp of a producer warpgroup issues every
//     copy (the pieces after the cluster barrier's wait); the warpgroup
//     hands its registers to the consumers (setmaxnreg, consumer_regs).
//   * The dgh exchange goes through L2, as the first wide design's: each CTA
//     writes its slice of step t's dgx and dhn to the outputs, then a
//     cluster barrier (release / acquire, with proxy fences) makes the
//     cluster's rows whole, and TMA reads them back. A block's outputs are
//     written into the rest of its operands' slot and stored by TMA, one
//     thread a warpgroup, 64 rows x 8 columns a box (rows beyond B are not
//     written).
//   * A step of a warpgroup: the cell of step s (dgx, dhn out), the cluster
//     barrier's arrive, the recompute of step s+1 (off the serial chain: it
//     runs while the peers finish their cells), the second product of step
//     s, then `+ dh_tot*z`, the barrier's wait. Rows beyond B and the step
//     before the first processed position (array time -1 or T) read as
//     zero, which makes their dgh and dh exactly zero: they add nothing to
//     db_hh.
//   * Registers: the recompute's accumulators (3U / 2 a thread) and the
//     second product's (U / 2) stay in registers; dh, the tiles' db_hh
//     sums and the operands live in shared memory, b_hh is read through the
//     read-only cache. With dh in registers too ptxas spilled at U = 48 (a
//     thread of three warpgroups has 152 registers beside the producer's,
//     168 without it); the operands' blocks in the ring, not a buffer of
//     their own, make room for dh and for a ring of four slots at 192 rows.
//     Rows and units are template parameters, so the cell's shared-memory
//     offsets are immediates.
//
// Numerics: wgmma with bf16 operands and fp32 accumulators, each
// accumulator's k16 steps in the resident cluster's order in both products
// (the recompute's k ascending; the second product's 3H columns in order,
// gate-major, as the resident cluster's k-step table walks its owner-laid
// tile), gh = product + b_hh, dh = product + dh_tot*z, the same cell
// expressions and the same db_hh sums (the two rows of a thread, the
// shuffle over the eight row groups, one add a step) as gru_scan_bwd.cu. On
// an H100 wgmma's sums equal mma.sync's (chip_smoke.py phase 26,
// WGMMA_EQUALS_MMA_SYNC), so dgx, dhn and every db_hh partial equal its
// resident cluster's and single block's bit for bit (phase 28 holds them).
//
// The launch plan (C, R, stages, shared bytes) comes from the caller
// (ops/gru.py plan_bwd_wide_scan, against cudaOccupancyMaxActiveClusters of
// gru_scan_bwd_wide_max_clusters below); the entries refuse a plan whose
// bytes are not this layout's or whose ring has one slot. H must be a
// multiple of 64 with (U = H / C, R) one of the instances'
// (GRU_BWD_INSTANCES). gru_scan_bwd_wide_trace also writes a clock64 trace
// of the first steps of one warp (BWD_TRACE_POINTS below) at U = 48, R =
// 192.
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_fwd_wide.cuh"

namespace {

// The instances: (units a CTA, rows a cluster). The recompute's N is 3U,
// the second product's U; their accumulators take 2U registers a thread.
// Only (48, 192), v1's sub-band plan, has a traced twin.
#define GRU_BWD_INSTANCES(X) \
  X(16, 64) X(16, 128) X(16, 192) X(32, 64) X(32, 128) X(32, 192) \
  X(48, 64) X(48, 128) X(48, 192)

// Registers a thread of the R / 64 warpgroups takes (setmaxnreg) from the
// producer's warpgroup, which keeps WIDE_PRODUCER_REGS: all that it gives
// up (a CTA launches with 128 a thread).
__host__ __device__ constexpr int consumer_regs(int R) {
  return R == 192 ? 152 : R == 128 ? 160 : 200;
}

// Bytes of a ring slot's A part (a box of R rows x 64 bf16, 128-byte
// swizzled; or a block of the cell's operands, [5][R][8] bf16, and then the
// block's dgx [3][R][8]) and of its W part (3U rows x 64 bf16: a
// recompute's W_hh^T chunk; or the W_hh rows of a dgh piece, [U][64]; or
// a block's dhn, [R][8]).
__host__ __device__ constexpr size_t a_slot(int R) { return (size_t)R * 128; }
__host__ __device__ constexpr size_t w_slot(int U) { return (size_t)U * 384; }

// Shared bytes of one CTA, in the order the kernel lays them out: 1024
// bytes of slack to align the swizzled boxes, the ring's A parts
// [stages][R][128 B] and W parts [stages][3U][128 B], the tiles' db_hh
// sums [R/16][3U] fp32, dh of the warps' (row, unit) pairs [U/2][2R] fp32
// and the ring's mbarriers, full and empty.
size_t wide_bwd_smem(int H, int C, int R, int stages) {
  const size_t U = H / C, r = R;
  return 1024 + stages * (a_slot(R) + w_slot(U)) + 12 * (r / 16) * U +
         4 * r * U + 16 * (size_t)stages;
}

// The trace's readings of a step (the first CTA's consumer warp 0): the
// step's start, its first block of cell operands arrived, the cell done
// and the cluster barrier arrived, the recompute of the next step issued
// (every box waited for), the first dgh piece arrived, the second product
// done, the cluster barrier's wait done; then the clocks spent waiting
// for ring slots in the step.
constexpr int BWD_TRACE_POINTS = 8;

// wgmma descriptor of a K-major operand in a 128-byte-swizzled box (8 rows
// 1024 bytes apart; the leading offset is unused): a k16 step lies 32
// bytes on from the step before it within the swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// One box {col, row, t} of a 3-D tensor map from shared memory (src, 128-
// byte aligned) to global memory, in this thread's bulk async-group; rows
// beyond the tensor's are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int col,
                                             int row, int t, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(t),
         "r"(src)
      : "memory");
}

// One ring stage's four k16 steps into acc [64 x N]: A from the swizzled
// box at `a` (the warpgroup's 64 rows), B from the packed chunk at `w`
// ([8 k8 groups][N][8] bf16); `first` overwrites acc (the product's first
// k16 step).
template <int N>
__device__ __forceinline__ void stage_mma(float (&acc)[N / 2], uint32_t a,
                                          uint32_t w, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rows<N>(acc, sw128_desc(a + 32 * kk),
                  kmajor_desc(w + 2 * kk * N * 16, N * 16, 128),
                  first && kk == 0 ? 0 : 1);
}

template <int U, int R, bool TRACE>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
gru_bwd_wide_kernel(const __grid_constant__ CUtensorMap hmap,   // h_seq, 64
                    const __grid_constant__ CUtensorMap pmap,   // h_seq, 8
                    const __grid_constant__ CUtensorMap dmap1,  // dgx
                    const __grid_constant__ CUtensorMap dmap2,  // dhn
                    const __grid_constant__ CUtensorMap gmap,   // gates, 8
                    const __grid_constant__ CUtensorMap omap,   // gout, 8
                    const __grid_constant__ CUtensorMap smap1,  // dgx, 8 x 64
                    const __grid_constant__ CUtensorMap smap2,  // dhn, 8 x 64
                    const unsigned char* __restrict__ wrec,
                    const unsigned char* __restrict__ wdh,
                    const float* __restrict__ bhh,              // [3H]
                    float* __restrict__ dbhh,                   // [blocks, 3H]
                    long long* __restrict__ trace,
                    int T, int B, int H, int stages, int reverse) {
  constexpr int N3 = 3 * U, UB = U / 8, NCW = R / 16;  // consumer warps
  constexpr uint32_t BOX_A = a_slot(R), SLOT_W = w_slot(U);
  constexpr uint32_t PIECE_W = U * 128;       // a dgh piece's W_hh rows
  constexpr uint32_t OPS = R * 16;            // bytes of one operand's block
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int HB = H / 64, NC = 3 * H / 64, NC1 = 2 * H / 64, D = stages;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster

  // aligned by an offset into the shared array itself, so that the
  // compiler keeps every pointer below in the shared address space
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (cta_addr(smem_raw) & 1023)) & 1023);
  unsigned char* aring = smem;                                 // [D][R][128 B]
  unsigned char* wring = aring + (size_t)D * BOX_A;            // [D][3U][128 B]
  float* dbs = reinterpret_cast<float*>(wring + (size_t)D * SLOT_W);  // [R/16][3U]
  float* dhs = dbs + (R / 16) * N3;                            // [U/2][2R]
  uint64_t* full = reinterpret_cast<uint64_t*>(dhs + R * U);   // [D]
  uint64_t* empty = full + D;                                  // [D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // accumulator coordinates

  for (int i = threadIdx.x; i < (R / 16) * N3; i += blockDim.x) dbs[i] = 0.0f;
  for (int i = threadIdx.x; i < R * U; i += blockDim.x) dhs[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      mbar_init(cta_addr(full + d), 1);
      mbar_init(cta_addr(empty + d), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it (out of range at p = 0: TMA reads zero)
  const int step = reverse ? 1 : -1;          // t(p-1) = t(p) + step
  auto time_of = [&](int s) { return reverse ? s : T - 1 - s; };

  cluster.sync();      // every CTA has started and set its barriers

  if (warp >= NCW) {
    // ---- the producer's warpgroup: its first warp's lane 0 issues every
    // stage of the ring in the order the warps take them (the HB boxes of
    // step 0; then each step s its UB blocks of cell operands, the HB
    // boxes of step s+1 and its NC dgh pieces); all of it meets the
    // consumers at the cluster barriers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(WIDE_PRODUCER_REGS));
    const bool leader = warp == NCW && lane == 0;
    int n = 0;                        // ring stages issued
    auto slot_free = [&]() {          // stage n's slot, once emptied
      const int slot = n % D, use = n / D;
      if (use > 0) xbar_wait(cta_addr(empty + slot), (use - 1) & 1);
      return slot;
    };
    auto load_boxes = [&](int s) {    // the recompute of step s
      for (int b = 0; b < HB; ++b, ++n) {
        const int slot = slot_free();
        const uint32_t bar = cta_addr(full + slot);
        xbar_expect(bar, BOX_A + SLOT_W);
        tma_load_3d(cta_addr(aring + (size_t)slot * BOX_A), &hmap, 64 * b,
                    row0, time_of(s) + step, bar);
        bulk_from_global(cta_addr(wring + (size_t)slot * SLOT_W),
                         wrec + ((size_t)rank * HB + b) * SLOT_W, SLOT_W, bar);
      }
    };
    auto load_ops = [&](int s) {      // the cell's operands of step s
      const int t = time_of(s);
      for (int j = 0; j < UB; ++j, ++n) {
        const int slot = slot_free(), col = col0 + 8 * j;
        const uint32_t a = cta_addr(aring + (size_t)slot * BOX_A);
        const uint32_t bar = cta_addr(full + slot);
        xbar_expect(bar, 5 * OPS);
        for (int q = 0; q < 3; ++q)
          tma_load_3d(a + q * OPS, &gmap, q * H + col, row0, t, bar);
        tma_load_3d(a + 3 * OPS, &omap, col, row0, t, bar);
        tma_load_3d(a + 4 * OPS, &pmap, col, row0, t + step, bar);
      }
    };
    auto load_pieces = [&](int s) {   // the second product of step s
      for (int c = 0; c < NC; ++c, ++n) {
        const int slot = slot_free();
        const uint32_t a = cta_addr(aring + (size_t)slot * BOX_A);
        const uint32_t bar = cta_addr(full + slot);
        xbar_expect(bar, BOX_A + PIECE_W);
        if (c < NC1)
          tma_load_3d(a, &dmap1, 64 * c, row0, time_of(s), bar);
        else
          tma_load_3d(a, &dmap2, 64 * (c - NC1), row0, time_of(s), bar);
        bulk_from_global(cta_addr(wring + (size_t)slot * SLOT_W),
                         wdh + ((size_t)rank * NC + c) * PIECE_W, PIECE_W,
                         bar);
      }
    };
    if (leader) load_boxes(0);
    for (int s = 0; s < T; ++s) {
      cluster_arrive();
      if (leader) {
        load_ops(s);
        if (s + 1 < T) load_boxes(s + 1);
      }
      __syncwarp();
      cluster_wait();                 // every CTA's slice of step t(s)
      if (leader && s + 1 < T) {
        fence_proxy_async_global();
        load_pieces(s);
      }
      __syncwarp();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(consumer_regs(R)));

  // ---- a consumer warp: the m16 tile `warp` of the cluster's rows, in
  // warpgroup warp / 4. Accumulator 4 j + 2 half + e of an [64 x N] product
  // is row 16 warp + grp + 8 half, column 8 j + 2 tq + e; the recompute's
  // column q U + u is gate q of unit u
  const bool tracing = TRACE && cluster_id == 0 && rank == 0 &&
                       threadIdx.x == 0;
  const uint32_t abase = cta_addr(aring) + (warp >> 2) * 8192;
  const uint32_t wbase = cta_addr(wring);
  // dh of the thread's (row, unit) pairs in its own column of the shared
  // array (element i at dh[2R i]); after the cell, dh_tot * z
  float* dh = dhs + threadIdx.x;
  // the thread that stores its warpgroup's outputs of the cell by TMA
  const bool leader = (threadIdx.x & 127) == 0;
  float zacc[N3 / 2];   // the recomputed product of the next cell
  int n = 0;            // ring stages taken
  unsigned int waited = 0;
  auto take = [&]() {   // stage n's slot, once full
    const int slot = n % D;
    unsigned int w0 = 0;
    if (TRACE && tracing) w0 = (unsigned int)clock();
    xbar_wait(cta_addr(full + slot), (n / D) & 1);
    if (TRACE && tracing) waited += (unsigned int)clock() - w0;
    return (uint32_t)slot;
  };
  // after a stage's group is issued: retire the one before and hand its
  // slot back (not at the first stage of a run)
  auto retire = [&](bool has_previous) {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (has_previous && lane == 0) mbar_arrive(cta_addr(empty + (n - 1) % D));
    ++n;
  };
  // the gates recompute of step s (h_prev @ W_hh, the scan's first
  // product) into zacc, k ascending, starting a run of stages
  auto recompute = [&]() {
    for (int b = 0; b < HB; ++b) {
      const uint32_t slot = take();
      stage_mma<N3>(zacc, abase + slot * BOX_A, wbase + slot * SLOT_W,
                    b == 0);
      retire(b > 0);
    }
  };
  // the end of a run: every group retired, the last slot handed back
  auto drain = [&]() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(cta_addr(empty + (n - 1) % D));
  };

  fence_acc<N3>(zacc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  recompute();
  drain();
  fence_acc<N3>(zacc);
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    // the trace's readings of this step, where it is traced
    const bool tr = TRACE && tracing && s < TRACE_STEPS;
    auto mark = [&](int point) {
      trace[s * BWD_TRACE_POINTS + point] = clock_now();
    };
    if (tr) {
      waited = 0;
      mark(0);
    }
    // ---- the elementwise backward (the scan's cell), a block of 8 units
    // at a time as its operands arrive: [5][R][8] bf16 (the gates r, z, n,
    // gout, h_prev) in a ring slot. The block's outputs go into the rest of
    // the slot, dgx's three planes [3][R][8] after the operands and dhn's
    // [R][8] in its W part, and one thread a warpgroup stores its 64 rows
    // of them by TMA (no thread writes 16-byte pieces of rows 6H bytes
    // apart, and few TMA operations: tiny boxes cost the cell 3 us a
    // step); a slot goes back once the stores of it have read it
#pragma unroll
    for (int jj = 0; jj < UB; ++jj) {
      const int jl = 8 * jj + 2 * tq;
      const uint32_t slot = take();
      const __nv_bfloat16* ops = reinterpret_cast<const __nv_bfloat16*>(
          aring + slot * BOX_A) + 2 * tq;
      __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(
          aring + slot * BOX_A + 5 * OPS) + 2 * tq;   // [3][R][8]
      __nv_bfloat16* outn = reinterpret_cast<__nv_bfloat16*>(
          wring + slot * SLOT_W) + 2 * tq;            // [R][8]
      if (tr && jj == 0) mark(1);
      float bias[3][2], dbsum[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 b2 =
            __ldg(reinterpret_cast<const float2*>(bhh + q * H + col0 + jl));
        bias[q][0] = b2.x;
        bias[q][1] = b2.y;
        dbsum[q][0] = dbsum[q][1] = 0.0f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + grp + 8 * half;
        float x[3][2], gh[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float2 gx = load_pair(ops + (q * R + r) * 8);
          x[q][0] = gx.x;
          x[q][1] = gx.y;
          gh[q][0] = zacc[4 * (q * UB + jj) + 2 * half] + bias[q][0];
          gh[q][1] = zacc[4 * (q * UB + jj) + 2 * half + 1] + bias[q][1];
        }
        const float2 go = load_pair(ops + (3 * R + r) * 8);
        // the bf16 residual, upcast; zero at the first processed position
        const float2 hp2 = load_pair(ops + (4 * R + r) * 8);
        const float g_out[2] = {go.x, go.y}, h_prev[2] = {hp2.x, hp2.y};
        float dg[3][2], dxn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* dhe = dh + (4 * jj + 2 * half + e) * 2 * R;
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          const float dh_tot = g_out[e] + *dhe;
          const float dn = dh_tot * (1.0f - zg);
          const float dz = dh_tot * (h_prev[e] - ng);
          dxn[e] = dn * (1.0f - ng * ng);
          dg[0][e] = dxn[e] * gh[2][e] * rg * (1.0f - rg);
          dg[1][e] = dz * zg * (1.0f - zg);
          dg[2][e] = dxn[e] * rg;
          *dhe = dh_tot * zg;        // the product is added below
#pragma unroll
          for (int q = 0; q < 3; ++q) dbsum[q][e] += dg[q][e];
        }
        store_pair(outs + r * 8, dg[0][0], dg[0][1]);
        store_pair(outs + (R + r) * 8, dg[1][0], dg[1][1]);
        store_pair(outs + (2 * R + r) * 8, dxn[0], dxn[1]);
        store_pair(outn + r * 8, dg[2][0], dg[2][1]);
      }
      fence_proxy_async();           // the outputs are read by TMA
      // the warpgroup's 64 rows of outputs are whole (named barrier 1 + g)
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + (warp >> 2)) : "memory");
      if (leader) {
        const uint32_t rows = cta_addr(aring + slot * BOX_A + 5 * OPS) +
                              (warp >> 2) * 1024;
        for (int q = 0; q < 3; ++q)
          tma_store_3d(&smap1, q * H + col0 + 8 * jj, row0 + 64 * (warp >> 2),
                       t, rows + q * OPS);
        tma_store_3d(&smap2, col0 + 8 * jj, row0 + 64 * (warp >> 2), t,
                     cta_addr(wring + slot * SLOT_W) + (warp >> 2) * 1024);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the previous block's stores have read its slot
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        if (jj > 0) mbar_arrive(cta_addr(empty + (n - 1) % D));
      } else if (lane == 0) {
        mbar_arrive(cta_addr(empty + n % D));   // its operands are read
      }
      ++n;
      // db_hh: add the eight row groups of the warp (lanes that share tq;
      // every lane gets the same sum), one lane of them adds it to the
      // tile's sum of the column
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dbsum[q][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (grp == (((q * UB + jj) * 2 + e) & 7))
            dbs[warp * N3 + q * U + jl + e] += v;
        }
    }
    if (leader) {
      // the last block's stores have read its slot; every store of the
      // step has been written, for the peers' TMA to read back
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(cta_addr(empty + (n - 1) % D));
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    // (named barrier 1 + g: the warpgroup's stores are written)
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + (warp >> 2)) : "memory");
    fence_proxy_async_global();
    cluster_arrive();
    if (tr) mark(2);
    if (s + 1 < T) {
      // the recompute of step s+1 (off the serial chain), then dh =
      // bf16(dgh of step s) @ W_hh^T over all 3H columns in order (piece c
      // holds k-steps 4c .. 4c + 3), then + dh_tot * z
      float acc[U / 2];
      fence_acc<N3>(zacc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      recompute();
      if (tr) mark(3);
      fence_acc<U>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int c = 0; c < NC; ++c) {
        const uint32_t slot = take();
        if (tr && c == 0) mark(4);
        stage_mma<U>(acc, abase + slot * BOX_A, wbase + slot * SLOT_W, c == 0);
        retire(true);
      }
      drain();
      fence_acc<N3>(zacc);
      fence_acc<U>(acc);
#pragma unroll
      for (int i = 0; i < U / 2; ++i) dh[2 * R * i] = acc[i] + dh[2 * R * i];
      if (tr) mark(5);
    }
    cluster_wait();
    if (tr) {
      mark(6);
      trace[s * BWD_TRACE_POINTS + 7] = waited;
    }
  }

  // one db_hh partial per 16-row tile of the batch, as the single block
  __syncwarp();
  const int tile_row = row0 + 16 * warp;
  if (tile_row < B) {
    float* out = dbhh + (size_t)(tile_row / 16) * (3 * H);
    for (int i = lane; i < N3; i += 32)
      out[i / U * H + col0 + i % U] = dbs[warp * N3 + i];
  }
}

template <int U, int R, bool TRACE>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = gru_bwd_wide_kernel<U, R, TRACE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool instance_fits(int U, int R) {
#define GRU_BWD_IS(UU, RR) if (U == UU && R == RR) return true;
  GRU_BWD_INSTANCES(GRU_BWD_IS)
#undef GRU_BWD_IS
  return false;
}

// A plan the kernel takes: clusters of 8 or 16 CTAs of an instance's units
// and rows (H a multiple of 64) and a ring of two slots at least.
bool bwd_plan_fits(int H, int C, int R, int stages) {
  return (C == 8 || C == 16) && H > 0 && H % C == 0 && H % 64 == 0 &&
         instance_fits(H / C, R) && stages >= 2;
}

// The instance's launch (operands given) or, with n set, its occupancy
// query.
template <int U, int R, bool TRACE>
int run(const void* gates, const void* h_seq, const void* gout,
        const void* wrec, const void* wdh, const void* bhh, void* dgx,
        void* dhn, void* dbhh, void* trace, int T, int B, int H, int reverse,
        int C, int stages, size_t smem, void* stream, int* n) {
  cudaError_t err = prepare<U, R, TRACE>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(2 * R + 128);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = gru_bwd_wide_kernel<U, R, TRACE>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  // the boxes of the recompute and of the dgh pieces: 64 columns, swizzled;
  // the cell's operands: 8 columns a block of units; its outputs: 8 columns
  // of a warpgroup's 64 rows
  CUtensorMap hmap = {}, pmap = {}, dmap1 = {}, dmap2 = {}, gmap = {},
              omap = {}, smap1 = {}, smap2 = {};
  if (!tensor_map(&hmap, h_seq, T, B, H, 64, R, true) ||
      !tensor_map(&pmap, h_seq, T, B, H, 8, R, false) ||
      !tensor_map(&dmap1, dgx, T, B, 3 * H, 64, R, true) ||
      !tensor_map(&dmap2, dhn, T, B, H, 64, R, true) ||
      !tensor_map(&gmap, gates, T, B, 3 * H, 8, R, false) ||
      !tensor_map(&omap, gout, T, B, H, 8, R, false) ||
      !tensor_map(&smap1, dgx, T, B, 3 * H, 8, 64, false) ||
      !tensor_map(&smap2, dhn, T, B, H, 8, 64, false))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, hmap, pmap, dmap1, dmap2, gmap, omap,
                           smap1, smap2, (const unsigned char*)wrec,
                           (const unsigned char*)wdh, (const float*)bhh,
                           (float*)dbhh, (long long*)trace, T, B, H, stages,
                           reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance for the plan,
// refusing a plan the kernel does not take or shared bytes that are not
// its layout's (and a trace of another instance than the traced one).
int dispatch(const void* gates, const void* h_seq, const void* gout,
             const void* wrec, const void* wdh, const void* bhh, void* dgx,
             void* dhn, void* dbhh, void* trace, int T, int B, int H,
             int reverse, int C, int R, int stages, size_t smem_bytes,
             void* stream, int* n) {
  if (!bwd_plan_fits(H, C, R, stages) ||
      smem_bytes != wide_bwd_smem(H, C, R, stages))
    return (int)cudaErrorInvalidValue;
  if (trace != nullptr)
    return H / C == 48 && R == 192
               ? run<48, 192, true>(gates, h_seq, gout, wrec, wdh, bhh, dgx,
                                    dhn, dbhh, trace, T, B, H, reverse, C,
                                    stages, smem_bytes, stream, n)
               : (int)cudaErrorInvalidValue;
#define GRU_BWD_RUN(UU, RR)                                                  \
  if (H / C == UU && R == RR)                                                \
    return run<UU, RR, false>(gates, h_seq, gout, wrec, wdh, bhh, dgx, dhn,  \
                              dbhh, nullptr, T, B, H, reverse, C, stages,   \
                              smem_bytes, stream, n);
  GRU_BWD_INSTANCES(GRU_BWD_RUN)
#undef GRU_BWD_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The GRU backward scan as a wide cluster. gates [T, B, 3H], h_seq, gout
// [T, B, H], all bf16, bhh [3H] fp32 -> dgx [T, B, 3H] bf16, dhn [T, B, H]
// bf16, dbhh [n_blocks, 3H] fp32 (one row per 16-row tile of the batch;
// n_blocks must be ceil(B / 16)), as gru_scan_bwd; wrec and wdh packed as
// above. The plan (ops/gru.py plan_bwd_wide_scan): clusters of `cluster`
// CTAs (8 or 16; H a multiple of 64 with H / cluster 16, 32 or 48 units)
// over `rows` rows each (64, 128 or 192: a consumer warpgroup a 64) and a
// ring of `stages` slots (at least 2); smem_bytes must be the layout's
// (ops/gru.py bwd_wide_smem_bytes).
int gru_scan_bwd_wide(const void* gates, const void* h_seq, const void* gout,
                      const void* wrec, const void* wdh, const void* bhh,
                      void* dgx, void* dhn, void* dbhh, int n_blocks, int T,
                      int B, int H, int reverse, int cluster, int rows,
                      int stages, int smem_bytes, void* stream) {
  if (n_blocks != row_blocks(B)) return (int)cudaErrorInvalidValue;
  return dispatch(gates, h_seq, gout, wrec, wdh, bhh, dgx, dhn, dbhh, nullptr,
                  T, B, H, reverse, cluster, rows, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// gru_scan_bwd_wide that also writes trace [TRACE_STEPS][BWD_TRACE_POINTS]
// int64 (the clock64 readings of the first CTA's consumer warp 0; see
// BWD_TRACE_POINTS above).
int gru_scan_bwd_wide_trace(const void* gates, const void* h_seq,
                            const void* gout, const void* wrec,
                            const void* wdh, const void* bhh, void* dgx,
                            void* dhn, void* dbhh, int n_blocks, int T, int B,
                            int H, int reverse, int cluster, int rows,
                            int stages, int smem_bytes, void* trace,
                            void* stream) {
  if (n_blocks != row_blocks(B) || trace == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(gates, h_seq, gout, wrec, wdh, bhh, dgx, dhn, dbhh, trace,
                  T, B, H, reverse, cluster, rows, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance with the plan's ring of
// `stages` slots, for a cluster of `cluster` CTAs over `rows` rows at H:
// *n clusters can run at once.
int gru_scan_bwd_wide_max_clusters(int stages, int H, int cluster, int rows,
                                   int* n) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, 0, 0, H, 0, cluster,
                  rows, stages, wide_bwd_smem(H, cluster, rows, stages),
                  nullptr, n);
}

const char* gru_scan_bwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
