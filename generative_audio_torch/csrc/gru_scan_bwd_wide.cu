// GRU backward scan over time-major residuals redesigned for the sub-band
// batch (H <= 512 over thousands of rows) as a wide cluster, for sm_90a:
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
// [T, B, H] bf16; b_hh [3H] fp32. W_hh comes packed twice by the wrapper, as
// the streamed backward (csrc/scan_bwd_stream.cu) takes it: wrec, each
// CTA's W_hh^T slice in MMA fragment order k-pair after k-pair (ops/lstm.py
// _stream_weight: [C][H/32][3][U/8][32 lanes][8] bf16), and wdh, the W_hh
// rows of each CTA's units in fragment order (_stream_dh_weight:
// [C][3H/32][U/8][32 lanes][8] bf16). dW_hh is the contraction of
// gru_scan_bwd.cu.
//
// What bounds it on an H100. At the training shape (T = 195, 2304 rows, H =
// 384) the scan does 2 * 2*T*rows*H*3H = 0.80 TFLOP of bf16 products and
// must move T*rows*(3H + H + H + 3H + H)*2 B = 3.1 GB: 0.93 ms, by bytes.
// The resident cluster of gru_scan_bwd.cu holds each CTA's W_hh slice and
// the whole owner-laid dgh tile, so it fits 16 rows a cluster of 8: 144
// clusters, 15 at once, ten waves of a 195-step serial chain. This design
// is kernel D's wide cluster (csrc/lstm_scan_bwd_wide.cu) with the GRU cell
// and three gate columns a unit; it holds neither the tile nor a weight
// slice whole:
//   * The dgh exchange goes through L2. Each CTA writes its slice of step
//     t's dgx and dhn to the outputs (it must anyway), then a cluster
//     barrier (release / acquire, with proxy fences) makes the cluster's
//     rows whole in L2, and a producer warp reads them back by TMA, 64
//     columns (four k-steps) at a time in the resident cluster's k order
//     (the 3H columns of dgh in order: r and z from dgx's first 2H, n from
//     dhn, so two tensor maps), into a ring that the second product
//     consumes as the pieces arrive. The A fragments come from the swizzled
//     TMA boxes by ldmatrix.
//   * Both W_hh operands stream from L2 through rings of bulk copies: the
//     recompute's W_hh^T slice k-pair after k-pair (its first `resident`
//     k-steps may stay in shared memory), the second product's W_hh rows
//     beside each dgh piece in the same slot.
//   * h_prev arrives by TMA, [R][H] in swizzled boxes of 64 columns, one
//     step ahead; the cell's operands of a step (the x-side gates of the
//     CTA's units, gout and h_prev of those units) by TMA into one buffer,
//     one step ahead. Rows beyond B and the step before the first processed
//     position (array time -1 or T) read as zero, which makes their dgh and
//     dh exactly zero: they add nothing to db_hh and are not written.
//   * A warp owns an item of MT m16 row tiles x NG 8-unit groups (template
//     parameters: 1 x 2, 1 x 3 or 2 x 3) and keeps in registers all that its
//     (row, unit) pairs carry from step to step: the recomputed product of
//     the next step (12 fp32 an item), dh (4), b_hh of its columns and, in
//     the lanes of row group 0, its tiles' db_hh sums (6 an item). Each B
//     fragment it loads serves every tile and each A fragment every group.
//     A step of a warp: the cell of step s (dgx, dhn out), the cluster
//     barrier's arrive, the recompute of step s+1 (off the serial chain:
//     it runs while the peers finish their cells and the exchange lands),
//     the second product of step s, then `+ dh_tot*z`, the barrier's wait.
//   * Two producer warps: one fills the h tile, the cell's operands and the
//     recompute's ring, the other waits on the cluster barrier and fills the
//     second product's ring, so that neither blocks the other.
//
// Numerics: the same mma.sync m16n8k16, bf16 operands (ldmatrix gives the A
// fragment load_a gives), fp32 accumulators from zero, each accumulator's
// k-steps in the resident cluster's order in both products (the
// recompute's resident k-pairs, then the streamed ones; the second
// product's 3H columns in order, gate-major, as the resident cluster's
// k-step table walks its owner-laid tile), gh = product + b_hh, dh =
// product + dh_tot*z, the same cell expressions and the same db_hh sums
// (the two rows of a thread, the shuffle over the eight row groups, one
// add a step) as gru_scan_bwd.cu, so dgx, dhn and every db_hh partial are
// bit-identical to its resident cluster's and single block's.
//
// The launch plan (C, R, tiles and groups an item, resident k-steps, the
// two rings' stages, shared bytes) comes from the caller (ops/gru.py
// plan_bwd_wide_scan, against cudaOccupancyMaxActiveClusters of
// gru_scan_bwd_wide_max_clusters below); the entries refuse a plan whose
// bytes are not this layout's. H must be a multiple of 8 * groups * C and
// of 64, R a multiple of 16 * tiles, U = H / C and R at most 256 (a TMA
// box).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>

#include "scan_bwd_wide.cuh"

namespace cg = cooperative_groups;

namespace {

// Consumer warps of an instance, at most: with the two producers, few
// enough that a thread may hold what the item keeps in registers (255 for
// 2 x 3, 168 for 1 x 3, 128 for 1 x 2), as kernel D's.
template <int MT, int NG>
__host__ __device__ constexpr int max_items() {
  return MT * NG == 6 ? 6 : NG == 3 ? 10 : 14;
}

// Bytes of one k-pair of a CTA's W_hh^T slice (3 gates x U units x 32).
__host__ __device__ inline size_t pair_bytes(int U) { return (size_t)U * 192; }

// Shared bytes of one CTA, in the order the kernel lays them out: 1024
// bytes of slack to align the swizzled boxes, h_prev [H/64][R][64] bf16,
// the second product's ring [stages2] of a dgh piece [R][64] bf16 and the
// W_hh rows of its four k-steps [U][64] bf16, the recompute's ring
// [stages1] and its resident k-pairs [resident/2] of the W_hh^T slice, the
// cell's operands [5][R][U] bf16 (3 gates, gout, h_prev), and the
// mbarriers: both rings' full and empty, the h tile's and the operands'.
size_t wide_bwd_smem(int H, int C, int R, int resident, int stages1,
                     int stages2) {
  const size_t U = H / C, r = R;
  return 1024 + r * 128 * (H / 64 + stages2) + stages2 * U * 128 +
         (stages1 + resident / 2) * pair_bytes(H / C) + 10 * r * U +
         8 * (2 * (size_t)stages1 + 2 * stages2 + 4);
}

// Consumer warps of a CTA: one per item of `mt` m16 tiles x `ng` groups.
int wide_bwd_items(int H, int C, int R, int mt, int ng) {
  return R / 16 / mt * (H / C / 8 / ng);
}

template <int MT, int NG>
__global__ void __launch_bounds__((max_items<MT, NG>() + 2) * 32, 1)
gru_bwd_wide_kernel(const __grid_constant__ CUtensorMap hmap,   // h_seq, 64
                    const __grid_constant__ CUtensorMap pmap,   // h_seq, U
                    const __grid_constant__ CUtensorMap dmap1,  // dgx
                    const __grid_constant__ CUtensorMap dmap2,  // dhn
                    const __grid_constant__ CUtensorMap gmap,   // gates
                    const __grid_constant__ CUtensorMap omap,   // gout
                    const unsigned char* __restrict__ wrec,
                    const unsigned char* __restrict__ wdh,
                    const float* __restrict__ bhh,              // [3H]
                    __nv_bfloat16* __restrict__ dgx,            // [T, B, 3H]
                    __nv_bfloat16* __restrict__ dhn,            // [T, B, H]
                    float* __restrict__ dbhh,                   // [blocks, 3H]
                    int T, int B, int H, int R, int resident, int stages1,
                    int stages2, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, G = U / 8, GB = G / NG, G3 = 3 * H;
  const int HB = H / 64, KP = H / 32, KR = resident / 2, NS1 = KP - KR;
  const int NC = G3 / 64, NC1 = 2 * H / 64, D1 = stages1, D2 = stages2;
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
      wres + (size_t)KR * slot_w1);                            // [3][R][U]
  __nv_bfloat16* xgo = xg + 3 * R * U;                         // [R][U]
  __nv_bfloat16* xhp = xgo + R * U;                            // [R][U]
  uint64_t* full1 = reinterpret_cast<uint64_t*>(xhp + R * U);  // [D1]
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
  const unsigned char* wsrc2 = wdh + (size_t)rank * (G3 / 32) * (slot_w2 / 2);
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
      xbar_expect(cta_addr(xfull), 5 * box_x);
      for (int q = 0; q < 3; ++q)
        tma_load_3d(cta_addr(xg + q * R * U), &gmap, q * H + col0, row0, t,
                    cta_addr(xfull));
      tma_load_3d(cta_addr(xgo), &omap, col0, row0, t, cta_addr(xfull));
      tma_load_3d(cta_addr(xhp), &pmap, col0, row0, t + step, cta_addr(xfull));
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
    // ---- producer 2: step s's dgh pieces (dgx's r and z columns, then
    // dhn), once the cluster wrote them, and the W_hh rows of their
    // k-steps, into the second product's ring
    for (int s = 0; s < T; ++s) {
      cluster_arrive();
      cluster_wait();                // every CTA's slice of step t(s)
      if (lane == 0 && s + 1 < T) {
        fence_proxy_async_global();
        for (int c = 0; c < NC; ++c) {
          const int n = s * NC + c, slot = n % D2, use = n / D2;
          if (use > 0) xbar_wait(cta_addr(empty2 + slot), (use - 1) & 1);
          xbar_expect(cta_addr(full2 + slot), box_h + slot_w2);
          if (c < NC1)
            tma_load_3d(cta_addr(aring + (size_t)slot * box_h), &dmap1,
                        64 * c, row0, time_of(s), cta_addr(full2 + slot));
          else
            tma_load_3d(cta_addr(aring + (size_t)slot * box_h), &dmap2,
                        64 * (c - NC1), row0, time_of(s),
                        cta_addr(full2 + slot));
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
  // index 2 * half + e of (tile m, group n) is row (m0 + m) * 16 + grp +
  // 8 half, unit col0 + 8 (g0 + n) + 2 tq + e
  float zacc[MT][NG][3][4];   // the recomputed product of the next cell
  float dh[MT][NG][4];        // dh; after the cell, dh_tot * z
  float dbacc[MT][NG][3][2];  // the tiles' db_hh sums (row group 0's lanes)
  float bias[NG][3][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[m][n][e] = 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q) dbacc[m][n][q][0] = dbacc[m][n][q][1] = 0.0f;
    }
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[n][q][e] = bhh[q * H + col0 + 8 * (g0 + n) + 2 * tq + e];
  const uint32_t hbase = cta_addr(htile), abase = cta_addr(aring);

  // the gates recompute of step s (h_prev @ W_hh, the scan's first
  // product) into zacc: k-pair p's fragments at wp, k-step 2p then 2p + 1,
  // each for every gate and (tile, group) accumulator
  auto recompute = [&](int s) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 3; ++q)
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
        for (int q = 0; q < 3; ++q) {
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

  // dh = bf16(dgh of step s) @ W_hh^T over all 3H columns in order, for the
  // warp's units (piece c holds k-steps 4c .. 4c + 3), then + dh_tot * z
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
        for (int e = 0; e < 4; ++e) dh[m][n][e] = acc[m][n][e] + dh[m][n][e];
  };

  recompute(0);
  for (int s = 0; s < T; ++s) {
    const int t = time_of(s);
    xbar_wait(cta_addr(xfull), s & 1);        // step s's cell operands
    // ---- the elementwise backward (the scan's cell) -----------------------
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const int jl = 8 * (g0 + n) + 2 * tq;
        float dbsum[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) dbsum[q][0] = dbsum[q][1] = 0.0f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (m0 + m) * 16 + grp + 8 * half, row = row0 + r;
          float x[3][2], gh[3][2];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float2 gx = load_pair(xg + (q * R + r) * U + jl);
            x[q][0] = gx.x;
            x[q][1] = gx.y;
            gh[q][0] = zacc[m][n][q][2 * half] + bias[n][q][0];
            gh[q][1] = zacc[m][n][q][2 * half + 1] + bias[n][q][1];
          }
          const float2 go = load_pair(xgo + r * U + jl);
          // the bf16 residual, upcast; zero at the first processed position
          const float2 hp2 = load_pair(xhp + r * U + jl);
          const float g_out[2] = {go.x, go.y}, h_prev[2] = {hp2.x, hp2.y};
          float dg[3][2], dxn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float rg = sigmoidf_(x[0][e] + gh[0][e]);
            const float zg = sigmoidf_(x[1][e] + gh[1][e]);
            const float ng = tanhf(x[2][e] + rg * gh[2][e]);
            const float dh_tot = g_out[e] + dh[m][n][2 * half + e];
            const float dn = dh_tot * (1.0f - zg);
            const float dz = dh_tot * (h_prev[e] - ng);
            dxn[e] = dn * (1.0f - ng * ng);
            dg[0][e] = dxn[e] * gh[2][e] * rg * (1.0f - rg);
            dg[1][e] = dz * zg * (1.0f - zg);
            dg[2][e] = dxn[e] * rg;
            dh[m][n][2 * half + e] = dh_tot * zg;  // the product is added below
#pragma unroll
            for (int q = 0; q < 3; ++q) dbsum[q][e] += dg[q][e];
          }
          if (row < B) {
            __nv_bfloat16* gp = dgx + ((size_t)t * B + row) * G3 + col0 + jl;
            *reinterpret_cast<__nv_bfloat162*>(gp) =
                __floats2bfloat162_rn(dg[0][0], dg[0][1]);
            *reinterpret_cast<__nv_bfloat162*>(gp + H) =
                __floats2bfloat162_rn(dg[1][0], dg[1][1]);
            *reinterpret_cast<__nv_bfloat162*>(gp + 2 * H) =
                __floats2bfloat162_rn(dxn[0], dxn[1]);
            *reinterpret_cast<__nv_bfloat162*>(
                dhn + ((size_t)t * B + row) * H + col0 + jl) =
                __floats2bfloat162_rn(dg[2][0], dg[2][1]);
          }
        }
        // db_hh: add the eight row groups of the warp (lanes that share tq)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = dbsum[q][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            dbacc[m][n][q][e] += v;
          }
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(cta_addr(xempty));
    fence_proxy_async_global();     // read back by the peers' TMA
    cluster_arrive();
    if (s + 1 < T) {
      recompute(s + 1);             // off the serial chain
      second(s);
    }
    cluster_wait();
  }

  // one db_hh partial per 16-row tile of the batch, as the single block
  if (grp == 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int tile_row = row0 + (m0 + m) * 16;
      if (tile_row >= B) continue;
      float* out = dbhh + (size_t)(tile_row / 16) * G3 + col0;
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[q * H + 8 * (g0 + n) + 2 * tq + e] = dbacc[m][n][q][e];
    }
  }
}

template <int MT, int NG>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = gru_bwd_wide_kernel<MT, NG>;
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

// The instance's launch (operands given) or, with n set, its occupancy
// query.
template <int MT, int NG>
int run(const void* gates, const void* h_seq, const void* gout,
        const void* wrec, const void* wdh, const void* bhh, void* dgx,
        void* dhn, void* dbhh, int T, int B, int H, int reverse, int C,
        int R, int resident, int stages1, int stages2, size_t smem,
        void* stream, int* n) {
  cudaError_t err = prepare<MT, NG>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * (wide_bwd_items(H, C, R, MT, NG) + 2));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = gru_bwd_wide_kernel<MT, NG>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  const int U = H / C;
  CUtensorMap hmap = {}, pmap = {}, dmap1 = {}, dmap2 = {}, gmap = {},
              omap = {};
  if (!tensor_map(&hmap, h_seq, T, B, H, 64, R, true) ||
      !tensor_map(&pmap, h_seq, T, B, H, U, R, false) ||
      !tensor_map(&dmap1, dgx, T, B, 3 * H, 64, R, true) ||
      !tensor_map(&dmap2, dhn, T, B, H, 64, R, true) ||
      !tensor_map(&gmap, gates, T, B, 3 * H, U, R, false) ||
      !tensor_map(&omap, gout, T, B, H, U, R, false))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, hmap, pmap, dmap1, dmap2, gmap, omap,
                           (const unsigned char*)wrec,
                           (const unsigned char*)wdh, (const float*)bhh,
                           (__nv_bfloat16*)dgx, (__nv_bfloat16*)dhn,
                           (float*)dbhh, T, B, H, R, resident, stages1,
                           stages2, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance for the plan,
// refusing a plan the kernel does not take or shared bytes that are not
// its layout's.
int dispatch(const void* gates, const void* h_seq, const void* gout,
             const void* wrec, const void* wdh, const void* bhh, void* dgx,
             void* dhn, void* dbhh, int T, int B, int H, int reverse, int C,
             int R, int mt, int ng, int resident, int stages1, int stages2,
             size_t smem_bytes, void* stream, int* n) {
  if (!plan_fits(H, C, R, mt, ng, resident, stages1, stages2) ||
      smem_bytes != wide_bwd_smem(H, C, R, resident, stages1, stages2))
    return (int)cudaErrorInvalidValue;
#define WIDE_BWD_ITEM(MT, NG)                                                \
  if (mt == MT && ng == NG)                                                  \
    return run<MT, NG>(gates, h_seq, gout, wrec, wdh, bhh, dgx, dhn, dbhh,   \
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

// The GRU backward scan as a wide cluster. gates [T, B, 3H], h_seq, gout
// [T, B, H], all bf16, bhh [3H] fp32 -> dgx [T, B, 3H] bf16, dhn [T, B, H]
// bf16, dbhh [n_blocks, 3H] fp32 (one row per 16-row tile of the batch;
// n_blocks must be ceil(B / 16)), as gru_scan_bwd; wrec and wdh as
// gru_scan_bwd_stream's (see above). The plan (ops/gru.py
// plan_bwd_wide_scan): clusters of `cluster` CTAs (8 or 16; H a multiple of
// 8 * groups * cluster and of 64, H / cluster at most 256) over `rows` rows
// each (a multiple of 16 * tiles, at most 256), items of `tiles` m16 tiles
// x `groups` 8-unit groups (1 x 2, 1 x 3 or 2 x 3; at most 14, 10 or 6
// items a CTA), `resident` k-steps of the recompute's slice resident (even;
// all H / 16 with no ring), its ring of `stages1` k-pairs (0 only then) and
// the second product's of `stages2` pieces; smem_bytes must be the layout's
// (ops/gru.py bwd_wide_smem_bytes).
int gru_scan_bwd_wide(const void* gates, const void* h_seq, const void* gout,
                      const void* wrec, const void* wdh, const void* bhh,
                      void* dgx, void* dhn, void* dbhh, int n_blocks, int T,
                      int B, int H, int reverse, int cluster, int rows,
                      int tiles, int groups, int resident, int stages1,
                      int stages2, int smem_bytes, void* stream) {
  if (n_blocks != row_blocks(B)) return (int)cudaErrorInvalidValue;
  return dispatch(gates, h_seq, gout, wrec, wdh, bhh, dgx, dhn, dbhh, T, B, H,
                  reverse, cluster, rows, tiles, groups, resident, stages1,
                  stages2, (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance with the plan's item
// (tiles x groups), resident k-steps and stages, for a cluster of
// `cluster` CTAs over `rows` rows at H: *n clusters can run at once.
int gru_scan_bwd_wide_max_clusters(int tiles, int groups, int resident,
                                   int stages1, int stages2, int H,
                                   int cluster, int rows, int* n) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, 0, 0, H, 0, cluster, rows, tiles,
                  groups, resident, stages1, stages2,
                  wide_bwd_smem(H, cluster, rows, resident, stages1, stages2),
                  nullptr, n);
}

const char* gru_scan_bwd_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
