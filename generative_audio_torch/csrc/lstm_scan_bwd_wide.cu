// LSTM backward scan over time-major residuals (kernel D) redesigned for the
// sub-band batch (H <= 512 over thousands of rows) as a wide cluster, for
// sm_90a: lstm_scan_bwd_wide.
//
// Replaces the same TPU kernel as csrc/lstm_scan_bwd.cu's resident cluster,
// where ops/lstm.py plan_bwd finds this design faster:
// generative_audio_tpu/ops/pallas_lstm.py:300 _lstm_pallas_call_bwd /
// _lstm_bwd_kernel (pl.pallas_call at :329), the reverse-time backward that
// recomputes the gates and emits bf16 dgates. What it computes is
// lstm_scan_bwd.cu's, bit for bit (see Numerics below):
//   h_prev, c_prev = h_seq, c_seq one processing step earlier; zero at p = 0
//   z      = float(gates[t]) + h_prev(bf16) @ W_hh              (fp32 acc)
//   dgates = the cell's derivatives of (dh_tot, dc_tot)          (bf16 out)
//   dh     = bf16(dgates) @ W_hh^T                               (fp32 acc)
// gates, dgates [T, B, 4H] bf16 (torch gate order i, f, g, o); h_seq, c_seq,
// gout [T, B, H] bf16. W_hh comes packed twice by the wrapper, as the
// streamed backward (csrc/scan_bwd_stream.cu) takes it: wrec, each CTA's
// W_hh^T slice in MMA fragment order k-pair after k-pair (ops/lstm.py
// _stream_weight: [C][H/32][4][U/8][32 lanes][8] bf16), and wdh, the W_hh
// rows of each CTA's units in fragment order (_stream_dh_weight:
// [C][4H/32][U/8][32 lanes][8] bf16). dW_hh is the caller's contraction.
//
// What bounds it on an H100. At the training shape (T = 195, 2304 rows, H =
// 384) a layer does 1.06 TFLOP of bf16 products and must move 3.8 GB: 1.13
// ms either way. The resident cluster of lstm_scan_bwd.cu holds each CTA's
// W_hh slice and the whole owner-laid dgates tile (3.2 KB a row), so it fits
// 16 rows a cluster of 8: 144 clusters, 15 at once, ten waves of a 195-step
// serial chain, each step about 8.5 us of barriers, exchange and a few
// products. This design holds neither the tile nor a weight slice whole:
//   * The dgates exchange goes through L2. Each CTA writes its slice of
//     step t's dgates to the output (it must anyway), then a cluster barrier
//     (release / acquire, with proxy fences) makes the cluster's rows of
//     dgates[t] whole in L2, and a producer warp reads them back by TMA, 64
//     columns (four k-steps) at a time in kernel D's k order, into a ring
//     that the second product consumes as the pieces arrive. (A bulk copy
//     of the slice into every peer's shared memory, the resident cluster's
//     exchange, moves about 25 GB/s a CTA, and the whole tile does not fit
//     beside more than about 48 rows.) The A fragments come from the
//     swizzled TMA boxes by ldmatrix.
//   * Both W_hh operands stream from L2 (where the packed copies, 1.2 MB
//     each at H = 384, stay) through rings of bulk copies: the recompute's
//     W_hh^T slice k-pair after k-pair (its first `resident` k-steps may
//     stay in shared memory), the second product's W_hh rows beside each
//     dgates piece in the same slot.
//   * h_prev arrives by TMA, [R][H] in swizzled boxes of 64 columns, one
//     step ahead; the cell's operands of a step (the x-side gates of the
//     CTA's units, c_t, c_prev and gout) by TMA into one buffer, one step
//     ahead. Rows beyond B and the step before the first processed position
//     (array time -1 or T) read as zero.
//   * A warp owns an item of MT m16 row tiles x NG 8-unit groups (template
//     parameters: 1 x 2, 1 x 3 or 2 x 3) and keeps in registers all that
//     its (row, unit) pairs carry from step to step: the recomputed z of
//     the next step (16 fp32 an item), dh and dc (4 each). Each B fragment
//     it loads serves every tile and each A fragment every group. A step of
//     a warp: the cell of step s (dgates out), the cluster barrier's arrive,
//     the recompute of step s+1 (off the serial chain: it runs while the
//     peers finish their cells and the exchange lands), the second product
//     of step s, the barrier's wait.
//   * Two producer warps: one fills the h tile, the cell's operands and the
//     recompute's ring, the other waits on the cluster barrier and fills the
//     second product's ring, so that neither blocks the other.
//
// Numerics: the same mma.sync m16n8k16, bf16 operands (ldmatrix gives the A
// fragment load_a gives), fp32 accumulators from zero, each accumulator's
// k-steps in kernel D's order in both products (the recompute's resident
// k-pairs, then the streamed ones; the second product's 4H columns in
// order), the same z = gates + product and the same cell expressions as
// lstm_scan_bwd.cu, so dgates are bit-identical to its resident cluster's
// and single block's.
//
// The launch plan (C, R, tiles and groups an item, resident k-steps, the
// two rings' stages, shared bytes) comes from the caller (ops/lstm.py
// plan_bwd_wide, against cudaOccupancyMaxActiveClusters of
// lstm_scan_bwd_wide_max_clusters below); the entries refuse a plan whose
// bytes are not this layout's. H must be a multiple of 8 * groups * C and
// of 64, R a multiple of 16 * tiles, U = H / C and R at most 256 (a TMA
// box). lstm_scan_bwd_wide_trace also writes a clock64 trace of the first
// steps of one warp (see TRACE_STEPS).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Consumer warps of an instance, at most: with the two producers, few
// enough that a thread may hold what the item keeps in registers (255 for
// 2 x 3, 168 for 1 x 3, 128 for 1 x 2).
template <int MT, int NG>
__host__ __device__ constexpr int max_items() {
  return MT * NG == 6 ? 6 : NG == 3 ? 10 : 14;
}

// Steps of a trace, and the clock64 readings of each: consumer warp 0 of
// the first CTA at the step's start, after the cell's operands arrived,
// after its cell and the barrier's arrive, after the recompute, when the
// first dgates piece arrived, after the second product and after the
// barrier's wait; and the exchange producer when its wait completed.
constexpr int TRACE_STEPS = 64, TRACE_POINTS = 8;

// Bytes of one k-pair of a CTA's W_hh^T slice (4 gates x U units x 32).
__host__ __device__ inline size_t pair_bytes(int U) { return (size_t)U * 256; }

// Shared bytes of one CTA, in the order the kernel lays them out: 1024
// bytes of slack to align the swizzled boxes, h_prev [H/64][R][64] bf16,
// the second product's ring [stages2] of a dgates piece [R][64] bf16 and
// the W_hh rows of its four k-steps [U][64] bf16, the recompute's ring
// [stages1] and its resident k-pairs [resident/2] of the W_hh^T slice, the
// cell's operands [7][R][U] bf16 (4 gates, c_t, c_prev, gout), and the
// mbarriers: both rings' full and empty, the h tile's and the operands'.
size_t wide_bwd_smem(int H, int C, int R, int resident, int stages1,
                     int stages2) {
  const size_t U = H / C, r = R;
  return 1024 + r * 128 * (H / 64 + stages2) + stages2 * U * 128 +
         (stages1 + resident / 2) * pair_bytes(H / C) + 14 * r * U +
         8 * (2 * (size_t)stages1 + 2 * stages2 + 4);
}

// Consumer warps of a CTA: one per item of `mt` m16 tiles x `ng` groups.
int wide_bwd_items(int H, int C, int R, int mt, int ng) {
  return R / 16 / mt * (H / C / 8 / ng);
}

// mma.sync m16n8k16 as lstm_scan_bwd.cu's (not volatile: the compiler may
// move fragment loads ahead of it; the order of the products into one
// accumulator is their data dependence).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The A fragment (16x16, row-major) of the m16 tile at `row` (lane l reads
// row row + (l & 15), columns 8 (l >> 4) .. + 7 of k-step kk) in a box of
// 64 bf16 columns, 128 bytes a row, swizzled as TMA's SWIZZLE_128B writes
// it (box 1024-byte aligned: the 16-byte piece c of row r lies at c ^ (r &
// 7)).
__device__ __forceinline__ void load_a_box(uint32_t (&a)[4], uint32_t box,
                                           int row, int kk, int lane) {
  const int r = row + (lane & 15), c = 2 * kk + (lane >> 4);
  ldmatrix_x4(a, box + r * 128 + ((c ^ (r & 7)) << 4));
}

// One box {col, row, t} of a 3-D tensor map into shared memory, completing
// on the mbarrier `bar` (as csrc/lstm_scan_wide.cu's).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int col, int row, int t,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(t), "r"(bar)
      : "memory");
}

// Generic-proxy writes to global memory become visible to (and ordered
// with) the async proxy's reads: the dgates pieces read back by TMA.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ long long clock_now() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}

template <int MT, int NG>
__global__ void __launch_bounds__((max_items<MT, NG>() + 2) * 32, 1)
lstm_bwd_wide_kernel(const __grid_constant__ CUtensorMap hmap,   // h_seq
                     const __grid_constant__ CUtensorMap dmap,   // dgates
                     const __grid_constant__ CUtensorMap gmap,   // gates
                     const __grid_constant__ CUtensorMap cmap,   // c_seq
                     const __grid_constant__ CUtensorMap omap,   // gout
                     const unsigned char* __restrict__ wrec,
                     const unsigned char* __restrict__ wdh,
                     __nv_bfloat16* __restrict__ dgates,
                     long long* __restrict__ trace, int T, int B, int H,
                     int R, int resident, int stages1, int stages2,
                     int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, G = U / 8, GB = G / NG, G4 = 4 * H;
  const int HB = H / 64, KP = H / 32, KR = resident / 2, NS1 = KP - KR;
  const int NC = G4 / 64, D1 = stages1, D2 = stages2;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const uint32_t box_h = (uint32_t)R * 128;   // bytes of a 64-column box
  const uint32_t slot_w2 = (uint32_t)U * 128;
  const uint32_t slot_w1 = (uint32_t)pair_bytes(U);
  const uint32_t box_x = (uint32_t)R * U * 2; // bytes of one operand's box

  // aligned by an offset into the shared array itself, so that the
  // compiler keeps every pointer below in the shared address space
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (cta_addr(smem_raw) & 1023)) & 1023);
  unsigned char* htile = smem;                                 // [HB][R][128 B]
  unsigned char* aring = htile + (size_t)HB * box_h;           // [D2][R][128 B]
  unsigned char* wring2 = aring + (size_t)D2 * box_h;          // [D2][U][128 B]
  unsigned char* ring1 = wring2 + (size_t)D2 * slot_w2;        // [D1][pair]
  unsigned char* wres = ring1 + (size_t)D1 * slot_w1;          // [KR][pair]
  __nv_bfloat16* xg = reinterpret_cast<__nv_bfloat16*>(
      wres + (size_t)KR * slot_w1);                            // [4][R][U]
  __nv_bfloat16* xct = xg + 4 * R * U;                         // [R][U]
  __nv_bfloat16* xcp = xct + R * U;                            // [R][U]
  __nv_bfloat16* xgo = xcp + R * U;                            // [R][U]
  uint64_t* full1 = reinterpret_cast<uint64_t*>(xgo + R * U);  // [D1]
  uint64_t* empty1 = full1 + D1;                               // [D1]
  uint64_t* full2 = empty1 + D1;                               // [D2]
  uint64_t* empty2 = full2 + D2;                               // [D2]
  uint64_t* hfull = empty2 + D2;
  uint64_t* hempty = hfull + 1;
  uint64_t* xfull = hempty + 1;
  uint64_t* xempty = xfull + 1;

  const int nthreads = blockDim.x, nc = nthreads / 32 - 2;   // consumer warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates

  // this CTA's W_hh^T slice k-pair after k-pair; the resident k-pairs
  const unsigned char* wsrc1 = wrec + (size_t)rank * KP * slot_w1;
  for (int i = threadIdx.x; i < KR * (int)(slot_w1 / 16); i += nthreads)
    reinterpret_cast<uint4*>(wres)[i] = reinterpret_cast<const uint4*>(wsrc1)[i];
  // the W_hh rows of this CTA's units, two k-pairs a piece
  const unsigned char* wsrc2 = wdh + (size_t)rank * (G4 / 32) * (slot_w2 / 2);
  if (threadIdx.x == 0) {
    for (int d = 0; d < D1; ++d) {
      mbar_init(cta_addr(full1 + d), 1);
      mbar_init(cta_addr(empty1 + d), nc);
    }
    for (int d = 0; d < D2; ++d) {
      mbar_init(cta_addr(full2 + d), 1);
      mbar_init(cta_addr(empty2 + d), nc);
    }
    mbar_init(cta_addr(hfull), 1);
    mbar_init(cta_addr(hempty), nc);
    mbar_init(cta_addr(xfull), 1);
    mbar_init(cta_addr(xempty), nc);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it (out of range at p = 0: TMA reads zero)
  const int step = reverse ? 1 : -1;          // t(p-1) = t(p) + step
  auto time_of = [&](int s) { return reverse ? s : T - 1 - s; };
  const bool tracing = trace != nullptr && cluster_id == 0 && rank == 0;

  cluster.sync();      // every CTA has started and set its barriers

  if (warp == nc) {
    // ---- producer 1: the h tile, the cell's operands, the recompute's ring
    int issued = 0;
    const int total = T * NS1;
    auto produce = [&](int upto) {     // stage n: k-pair KR + n % NS1
      for (upto = min(upto, total); issued < upto; ++issued) {
        const int slot = issued % D1, use = issued / D1;
        if (use > 0) xbar_wait(cta_addr(empty1 + slot), (use - 1) & 1);
        xbar_expect(cta_addr(full1 + slot), slot_w1);
        bulk_from_global(cta_addr(ring1 + (size_t)slot * slot_w1),
                         wsrc1 + (size_t)(KR + issued % NS1) * slot_w1,
                         slot_w1, cta_addr(full1 + slot));
      }
    };
    auto load_h = [&](int s) {         // h_prev of step s
      xbar_expect(cta_addr(hfull), HB * box_h);
      for (int b = 0; b < HB; ++b)
        tma_load_3d(cta_addr(htile + (size_t)b * box_h), &hmap, 64 * b, row0,
                    time_of(s) + step, cta_addr(hfull));
    };
    auto load_x = [&](int s) {         // the cell's operands of step s
      const int t = time_of(s);
      xbar_expect(cta_addr(xfull), 7 * box_x);
      for (int q = 0; q < 4; ++q)
        tma_load_3d(cta_addr(xg + q * R * U), &gmap, q * H + col0, row0, t,
                    cta_addr(xfull));
      tma_load_3d(cta_addr(xct), &cmap, col0, row0, t, cta_addr(xfull));
      tma_load_3d(cta_addr(xcp), &cmap, col0, row0, t + step, cta_addr(xfull));
      tma_load_3d(cta_addr(xgo), &omap, col0, row0, t, cta_addr(xfull));
    };
    if (lane == 0) {
      load_h(0);
      load_x(0);
      produce(NS1);
    }
    for (int s = 0; s < T; ++s) {
      cluster_arrive();
      if (lane == 0 && s + 1 < T) {
        xbar_wait(cta_addr(hempty), s & 1);   // the recompute of step s read it
        load_h(s + 1);
        produce(NS1 * (s + 1) + min(D1, NS1));
        xbar_wait(cta_addr(xempty), s & 1);   // the cell of step s read them
        load_x(s + 1);
        produce(NS1 * (s + 2));
      }
      __syncwarp();
      cluster_wait();
    }
    return;
  }
  if (warp == nc + 1) {
    // ---- producer 2: step s's dgates pieces, once the cluster wrote them,
    // and the W_hh rows of their k-steps, into the second product's ring
    for (int s = 0; s < T; ++s) {
      cluster_arrive();
      cluster_wait();                // every CTA's slice of dgates[t(s)]
      if (tracing && lane == 0 && s < TRACE_STEPS)
        trace[s * TRACE_POINTS + 7] = clock_now();
      if (lane == 0 && s + 1 < T) {
        fence_proxy_async_global();
        for (int c = 0; c < NC; ++c) {
          const int n = s * NC + c, slot = n % D2, use = n / D2;
          if (use > 0) xbar_wait(cta_addr(empty2 + slot), (use - 1) & 1);
          xbar_expect(cta_addr(full2 + slot), box_h + slot_w2);
          tma_load_3d(cta_addr(aring + (size_t)slot * box_h), &dmap, 64 * c,
                      row0, time_of(s), cta_addr(full2 + slot));
          bulk_from_global(cta_addr(wring2 + (size_t)slot * slot_w2),
                           wsrc2 + (size_t)c * slot_w2, slot_w2,
                           cta_addr(full2 + slot));
        }
      }
      __syncwarp();
    }
    return;
  }

  // ---- a consumer warp: tiles m0 .. m0 + MT - 1, groups g0 .. g0 + NG - 1
  const int m0 = warp / GB * MT, g0 = warp % GB * NG;
  const bool tw = tracing && warp == 0 && lane == 0;
  // index 2 * half + e of (tile m, group n) is row (m0 + m) * 16 + grp +
  // 8 half, unit col0 + 8 (g0 + n) + 2 tq + e
  float zacc[MT][NG][4][4];   // the recomputed product of the next cell
  float dh[MT][NG][4], dc[MT][NG][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[m][n][e] = dc[m][n][e] = 0.0f;
  const uint32_t hbase = cta_addr(htile), abase = cta_addr(aring);

  // the gates recompute of step s (h_prev @ W_hh, kernel D's first
  // product) into zacc: k-pair p's fragments at wp, k-step 2p then 2p + 1,
  // each for every gate and (tile, group) accumulator
  auto recompute = [&](int s) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) zacc[m][n][q][e] = 0.0f;
    auto pair_mma = [&](const unsigned char* wp, int p) {
      const uint2* wb = reinterpret_cast<const uint2*>(wp);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k = 2 * p + kk;
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a_box(a[m], hbase + (k >> 2) * box_h, (m0 + m) * 16, k & 3,
                     lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint2 b[NG];
#pragma unroll
          for (int n = 0; n < NG; ++n)
            b[n] = wb[((q * G + g0 + n) * 32 + lane) * 2 + kk];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NG; ++n)
              mma16816(zacc[m][n][q], a[m], b[n].x, b[n].y);
        }
      }
    };
    xbar_wait(cta_addr(hfull), s & 1);
    for (int p = 0; p < KR; ++p) pair_mma(wres + (size_t)p * slot_w1, p);
    for (int j = 0; j < NS1; ++j) {
      const int n = s * NS1 + j, slot = n % D1;
      xbar_wait(cta_addr(full1 + slot), (n / D1) & 1);
      pair_mma(ring1 + (size_t)slot * slot_w1, KR + j);
      __syncwarp();
      if (lane == 0) mbar_arrive(cta_addr(empty1 + slot));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(cta_addr(hempty));
  };

  // dh = bf16(dgates of step s) @ W_hh^T over all 4H columns in order, for
  // the warp's units: piece c holds k-steps 4c .. 4c + 3
  auto second = [&](int s) {
    float acc[MT][NG][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    for (int c = 0; c < NC; ++c) {
      const int n = s * NC + c, slot = n % D2;
      xbar_wait(cta_addr(full2 + slot), (n / D2) & 1);
      if (tw && c == 0 && s < TRACE_STEPS)
        trace[s * TRACE_POINTS + 4] = clock_now();
      const uint32_t box = abase + slot * box_h;
      const uint4* wb =
          reinterpret_cast<const uint4*>(wring2 + (size_t)slot * slot_w2);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint4 b[NG];
#pragma unroll
        for (int n2 = 0; n2 < NG; ++n2) b[n2] = wb[(pp * G + g0 + n2) * 32 + lane];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            load_a_box(a[m], box, (m0 + m) * 16, 2 * pp + kh, lane);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n2 = 0; n2 < NG; ++n2)
              mma16816(acc[m][n2], a[m], kh ? b[n2].z : b[n2].x,
                       kh ? b[n2].w : b[n2].y);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(cta_addr(empty2 + slot));
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dh[m][n][e] = acc[m][n][e];
  };

  recompute(0);
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS] = clock_now();
    xbar_wait(cta_addr(xfull), s & 1);        // step s's cell operands
    if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS + 1] = clock_now();
    // ---- the elementwise backward (kernel D's cell) ---------------------
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (m0 + m) * 16 + grp + 8 * half, row = row0 + r;
          const int jl = 8 * (g0 + n) + 2 * tq;
          float z[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 gx = load_pair(xg + (q * R + r) * U + jl);
            z[q][0] = gx.x + zacc[m][n][q][2 * half];
            z[q][1] = gx.y + zacc[m][n][q][2 * half + 1];
          }
          const float2 ct = load_pair(xct + r * U + jl),
                       cp = load_pair(xcp + r * U + jl),
                       go = load_pair(xgo + r * U + jl);
          const float c_t[2] = {ct.x, ct.y}, c_prev[2] = {cp.x, cp.y},
                      g_out[2] = {go.x, go.y};
          float dg[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gi = sigmoidf_(z[0][e]), gf = sigmoidf_(z[1][e]),
                        gg = tanhf(z[2][e]), og = sigmoidf_(z[3][e]);
            const float tc = tanhf(c_t[e]);
            const float dh_tot = g_out[e] + dh[m][n][2 * half + e];
            const float dc_tot =
                dc[m][n][2 * half + e] + dh_tot * og * (1.0f - tc * tc);
            dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
            dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
            dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
            dg[3][e] = dh_tot * tc * og * (1.0f - og);
            dc[m][n][2 * half + e] = dc_tot * gf;
          }
          if (row < B) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<__nv_bfloat162*>(
                  dgates + ((size_t)t * B + row) * G4 + q * H + col0 + jl) =
                  __floats2bfloat162_rn(dg[q][0], dg[q][1]);
          }
        }
    __syncwarp();
    if (lane == 0) mbar_arrive(cta_addr(xempty));
    fence_proxy_async_global();     // read back by the peers' TMA
    cluster_arrive();
    if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS + 2] = clock_now();
    if (s + 1 < T) {
      recompute(s + 1);             // off the serial chain
      if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS + 3] = clock_now();
      second(s);
    }
    if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS + 5] = clock_now();
    cluster_wait();
    if (tw && s < TRACE_STEPS) trace[s * TRACE_POINTS + 6] = clock_now();
  }
}

template <int MT, int NG>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = lstm_bwd_wide_kernel<MT, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The instances: (tiles, groups) of an item.
bool item_fits(int mt, int ng) {
  return (mt == 1 && (ng == 2 || ng == 3)) || (mt == 2 && ng == 3);
}

int item_limit(int mt, int ng) {
  return mt == 1 && ng == 2 ? max_items<1, 2>()
         : mt == 1          ? max_items<1, 3>()
                            : max_items<2, 3>();
}

bool plan_fits(int H, int C, int R, int mt, int ng, int resident,
               int stages1, int stages2) {
  if (!((C == 8 || C == 16) && H > 0 && item_fits(mt, ng) &&
        H % (8 * ng * C) == 0 && H % 64 == 0 && H / C <= 256 && R > 0 &&
        R <= 256 && R % (16 * mt) == 0))
    return false;
  const int items = wide_bwd_items(H, C, R, mt, ng);
  return items >= 1 && items <= item_limit(mt, ng) && resident >= 0 &&
         resident % 2 == 0 && resident <= H / 16 && stages2 >= 1 &&
         stages1 >= 0 && (stages1 == 0) == (resident == H / 16);
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links no libcuda (as lstm_scan_wide.cu).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [T][B][width] array in boxes of one step's R rows x `cols`
// columns, swizzled (128-byte rows) or not; out-of-range rows and steps
// read as zero.
bool tensor_map(CUtensorMap* map, const void* base, int T, int B, int width,
                int cols, int R, bool swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)B * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)R, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The instance's launch (operands given) or, with n set, its occupancy
// query.
template <int MT, int NG>
int run(const void* gates, const void* h_seq, const void* c_seq,
        const void* gout, const void* wrec, const void* wdh, void* dgates,
        void* trace, int T, int B, int H, int reverse, int C, int R,
        int resident, int stages1, int stages2, size_t smem, void* stream,
        int* n) {
  cudaError_t err = prepare<MT, NG>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * (wide_bwd_items(H, C, R, MT, NG) + 2));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = lstm_bwd_wide_kernel<MT, NG>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  const int U = H / C;
  CUtensorMap hmap = {}, dmap = {}, gmap = {}, cmap = {}, omap = {};
  if (!tensor_map(&hmap, h_seq, T, B, H, 64, R, true) ||
      !tensor_map(&dmap, dgates, T, B, 4 * H, 64, R, true) ||
      !tensor_map(&gmap, gates, T, B, 4 * H, U, R, false) ||
      !tensor_map(&cmap, c_seq, T, B, H, U, R, false) ||
      !tensor_map(&omap, gout, T, B, H, U, R, false))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, hmap, dmap, gmap, cmap, omap,
                           (const unsigned char*)wrec,
                           (const unsigned char*)wdh, (__nv_bfloat16*)dgates,
                           (long long*)trace, T, B, H, R, resident, stages1,
                           stages2, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance for the plan,
// refusing a plan the kernel does not take or shared bytes that are not
// its layout's.
int dispatch(const void* gates, const void* h_seq, const void* c_seq,
             const void* gout, const void* wrec, const void* wdh,
             void* dgates, void* trace, int T, int B, int H, int reverse,
             int C, int R, int mt, int ng, int resident, int stages1,
             int stages2, size_t smem_bytes, void* stream, int* n) {
  if (!plan_fits(H, C, R, mt, ng, resident, stages1, stages2) ||
      smem_bytes != wide_bwd_smem(H, C, R, resident, stages1, stages2))
    return (int)cudaErrorInvalidValue;
#define WIDE_BWD_ITEM(MT, NG)                                                \
  if (mt == MT && ng == NG)                                                  \
    return run<MT, NG>(gates, h_seq, c_seq, gout, wrec, wdh, dgates, trace,  \
                       T, B, H, reverse, C, R, resident, stages1, stages2,   \
                       smem_bytes, stream, n);
  WIDE_BWD_ITEM(1, 2)
  WIDE_BWD_ITEM(1, 3)
  WIDE_BWD_ITEM(2, 3)
#undef WIDE_BWD_ITEM
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel D as a wide cluster. gates [T, B, 4H], h_seq, c_seq, gout
// [T, B, H], all bf16 -> dgates [T, B, 4H] bf16, as lstm_scan_bwd; wrec and
// wdh as lstm_scan_bwd_stream's (see above). The plan (ops/lstm.py
// plan_bwd_wide): clusters of `cluster` CTAs (8 or 16; H a multiple of 8 *
// groups * cluster and of 64, H / cluster at most 256) over `rows` rows
// each (a multiple of 16 * tiles, at most 256), items of `tiles` m16 tiles
// x `groups` 8-unit groups (1 x 2, 1 x 3 or 2 x 3; at most 14, 10 or 6
// items a CTA), `resident` k-steps of the recompute's slice resident (even;
// all H / 16 with no ring), its ring of `stages1` k-pairs (0 only then)
// and the second product's of `stages2` pieces; smem_bytes must be the
// layout's (ops/lstm.py bwd_wide_smem_bytes).
int lstm_scan_bwd_wide(const void* gates, const void* h_seq,
                       const void* c_seq, const void* gout, const void* wrec,
                       const void* wdh, void* dgates, int T, int B, int H,
                       int reverse, int cluster, int rows, int tiles,
                       int groups, int resident, int stages1, int stages2,
                       int smem_bytes, void* stream) {
  return dispatch(gates, h_seq, c_seq, gout, wrec, wdh, dgates, nullptr, T, B,
                  H, reverse, cluster, rows, tiles, groups, resident, stages1,
                  stages2, (size_t)smem_bytes, stream, nullptr);
}

// lstm_scan_bwd_wide that also writes trace [TRACE_STEPS][TRACE_POINTS]
// int64 (clock64 readings of the first CTA; see TRACE_POINTS).
int lstm_scan_bwd_wide_trace(const void* gates, const void* h_seq,
                             const void* c_seq, const void* gout,
                             const void* wrec, const void* wdh, void* dgates,
                             int T, int B, int H, int reverse, int cluster,
                             int rows, int tiles, int groups, int resident,
                             int stages1, int stages2, int smem_bytes,
                             void* trace, void* stream) {
  if (trace == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(gates, h_seq, c_seq, gout, wrec, wdh, dgates, trace, T, B,
                  H, reverse, cluster, rows, tiles, groups, resident, stages1,
                  stages2, (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance with the plan's item
// (tiles x groups), resident k-steps and stages, for a cluster of
// `cluster` CTAs over `rows` rows at H: *n clusters can run at once.
int lstm_scan_bwd_wide_max_clusters(int tiles, int groups, int resident,
                                    int stages1, int stages2, int H,
                                    int cluster, int rows, int* n) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0, 0, H, 0, cluster, rows, tiles, groups,
                  resident, stages1, stages2,
                  wide_bwd_smem(H, cluster, rows, resident, stages1, stages2),
                  nullptr, n);
}

const char* lstm_scan_bwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
