// LSTM forward scan over precomputed time-major gates, kernels A and B
// redesigned for the sub-band batch (H <= 512 over thousands of rows), for
// sm_90a.
//
// Replaces the same TPU kernels as csrc/lstm_scan.cu's resident cluster,
// where ops/lstm.py plan_forward's step models find this design faster:
//   * kernel A (lstm_scan_fwd_wide)       <- generative_audio_tpu/ops/
//     pallas_lstm.py:142 _lstm_pallas_call / _lstm_kernel (h and c start at
//     zero), used by lstm_scan_tm without grad;
//   * kernel B (lstm_scan_fwd_carry_wide) <- :725 _lstm_pallas_call_carry /
//     _lstm_carry_kernel (h0, c0 in; h_T, c_T out), used by
//     lstm_layer_tm_chunked.
// What it computes is lstm_scan.cu's, bit for bit (see Numerics below):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// gates [T, B, 4H] bf16 (torch gate order i, f, g, o), h [T, B, H] in bf16
// or fp32, W_hh^T packed by the wrapper in MMA fragment order, as the
// streamed variant of lstm_scan.cu takes it (ops/lstm.py _stream_weight:
// [C][H/32][4][U/8][32 lanes][8] bf16). reverse=1 walks t from T-1 to 0.
//
// What bounds it on an H100. At the serving shape (8 x 10 s: T = 628, 2056
// rows, H = 384) a layer does 1.52 TFLOP of bf16 products and moves 4.96 GB
// (gates in, h out): about 1.5 ms either way. The resident cluster of
// lstm_scan.cu holds each CTA's whole W_hh^T slice and two h buffers, so it
// fits 32 rows a cluster of 8: 65 clusters, of which the card runs 15 at
// once, five waves of the 628-step serial chain, each step a few microseconds
// of latency (products, cell, the h exchange as 16-byte DSMEM stores, the
// cluster barrier) over little arithmetic. This design fits up to 144 rows a
// cluster of 8 (one wave of 15 clusters), so the chain runs once, each step
// doing about five times the arithmetic:
//   * h once a CTA, not twice, laid out slice-major [C][R][SU] bf16 (SU = U
//     units padded to an odd number of 16-byte pieces, so that ldmatrix's
//     eight row addresses fall in distinct banks): the slice of CTA k's units
//     is one contiguous block in every CTA. After its cell a CTA writes its
//     new slice into its own buffer and sends it to each peer with one
//     cp.async.bulk (shared::cta to shared::cluster) that completes on the
//     peer's mbarrier: C - 1 bulk copies a step in place of R * U / 8 * (C-1)
//     16-byte stores. With one buffer, a peer may overwrite h_{t-1} only
//     after every CTA has read it: each thread arrives on the cluster barrier
//     right after its products and waits on it after its cell, so the
//     barrier's latency lies under the cell arithmetic; the data of step t
//     is then waited for on the CTA's own mbarrier.
//   * W_hh^T: the first `resident` k-steps of the CTA's slice stay in shared
//     memory, the others stream from L2 (the whole W_hh^T, 1.18 MB at H =
//     384, stays there) through a ring of `stages` slots of one k-pair, each
//     filled by one bulk copy that completes on the slot's mbarrier, from a
//     producer warp: lstm_scan.cu's streamed ring.
//   * The x-side gates of step t arrive by TMA (a 3-D tensor map over
//     [T][B][4H], four boxes of R rows x U units a step, one per gate) into
//     one buffer, issued right after step t-1's cell has read it, so the
//     copy runs under the exchange and the products; rows beyond B read as
//     zero. c stays in registers.
//   * A warp owns an item of MT m16 row tiles x NG 8-unit groups (template
//     parameters: 1 x 2, 3 x 2 or 3 x 3) and keeps all their accumulators
//     (MT x NG x 4 gates x 4): each W_hh^T fragment it loads serves every
//     tile and each h fragment (ldmatrix.x4) every group, which cuts the
//     shared-memory reads of a step by 2.6-3x against one (tile, group) a
//     warp. The loops have no runtime bounds, so consecutive products go to
//     independent accumulators. At most seven consumer warps and the
//     producer: two warps a quarter of the SM, so that a thread may hold
//     255 registers and the accumulators do not spill (ten warps left 168,
//     and the 3 x 2 item spilled).
//   * bf16 h is written to global memory from the CTA's slice in 16-byte
//     pieces; fp32 h from the registers as float2.
//
// Numerics: the same mma.sync m16n8k16, bf16 operands (ldmatrix gives the
// A fragment load_a gives), fp32 accumulators from zero, each accumulator's
// k-steps in order (the resident ones, then the streamed ones), and the same
// cell expression as lstm_scan.cu, so h (and kernel B's h_T, c_T) are
// bit-identical to its resident cluster's, and a chunked run to an
// unchunked one.
//
// The launch plan (C, R, tiles an item, resident k-steps, stages, shared
// bytes) comes from the caller (ops/lstm.py plan_wide_scan, against
// cudaOccupancyMaxActiveClusters of lstm_scan_wide_max_clusters below); the
// entries refuse a plan whose bytes are not this layout's. H must be a
// multiple of 8 * groups * C and of 32 (the wrappers pad it with zero
// units), R a multiple of 16 * tiles, and U = H / C and R at most 256 (a
// TMA box).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WIDE_MAX_ITEMS = 7;   // consumer warps of a CTA, at most

// Row stride (bf16) of a CTA's h slice of U units: U padded to an odd number
// of 16-byte pieces.
__host__ __device__ inline int slice_stride(int U) { return 8 * ((U / 8) | 1); }

// Bytes of one k-pair (32 columns) of a CTA's W_hh^T slice of 4 gates x U.
__host__ __device__ inline size_t pair_bytes(int U) { return (size_t)U * 256; }

// Shared bytes of one CTA, in the order the kernel lays them out: 128 bytes
// of slack to align the gates to 128, one step of x-side gates [4][R][U]
// bf16 (the TMA boxes), the ring [stages][k-pair] and the resident k-pairs
// [resident / 2][k-pair] in fragment order, h [C][R][SU] bf16, the
// A-fragment column offsets of the k-steps [H / 16][2] int, and the
// mbarriers: the ring's full and empty [2][stages], the exchange's and the
// gates'.
size_t wide_smem(int H, int C, int R, int resident, int stages) {
  const size_t U = H / C, su = slice_stride(H / C), c = C, r = R;
  return 128 + 8 * r * U + (stages + resident / 2) * pair_bytes(U) +
         c * r * su * 2 + H / 2 + 8 * (2 * stages + 2);
}

// Consumer warps of a CTA: one per item of `mt` m16 tiles x `ng` unit
// groups.
int wide_items(int H, int C, int R, int mt, int ng) {
  return R / 16 / mt * (H / C / 8 / ng);
}

// mma.sync m16n8k16 as lstm_scan.cu's (not volatile: the compiler may move
// fragment loads ahead of it; the order of the products into one
// accumulator is their data dependence).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16x16, row-major) of an m16 tile: lane l gives the address
// of row l & 15, columns 8 (l >> 4) .. + 7 of the k-step.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(cta_addr(p)));
}

// One box {col, row, t} of a 3-D tensor map into shared memory, completing
// on the mbarrier `bar` (as csrc/lstm_scan_staged.cu's).
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

template <typename OutT, bool CARRY, int MT, int NG>
__global__ void __launch_bounds__((WIDE_MAX_ITEMS + 1) * 32, 1)
lstm_wide_kernel(const __grid_constant__ CUtensorMap gmap,  // gates [T, B, 4H]
                 const __nv_bfloat16* __restrict__ wf,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 OutT* __restrict__ out, float* __restrict__ h_T,
                 float* __restrict__ c_T, int T, int B, int H, int R,
                 int resident, int stages, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, G = U / 8, GB = G / NG;
  const int SU = slice_stride(U), KS = H / 16, KP = H / 32;
  const int KR = resident / 2, NS = KP - KR, D = stages;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const uint32_t pair = (uint32_t)pair_bytes(U);
  const uint32_t box = (uint32_t)R * U;       // elements of one gate's box

  // aligned by an offset into the shared array itself (not by a round trip
  // through an integer), so that the compiler keeps every pointer below in
  // the shared address space
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (cta_addr(smem_raw) & 127)) & 127);
  __nv_bfloat16* gx = reinterpret_cast<__nv_bfloat16*>(smem);      // [4][R][U]
  unsigned char* ring = smem + (size_t)8 * box;                     // [D][pair]
  unsigned char* wres = ring + (size_t)D * pair;                    // [KR][pair]
  __nv_bfloat16* hbuf =
      reinterpret_cast<__nv_bfloat16*>(wres + (size_t)KR * pair);  // [C][R][SU]
  int2* koff = reinterpret_cast<int2*>(hbuf + (size_t)C * R * SU);  // [KS]
  uint64_t* full = reinterpret_cast<uint64_t*>(koff + KS);          // [D]
  uint64_t* empty = full + D;                                       // [D]
  uint64_t* hfull = empty + D;                                      // [1]
  uint64_t* gfull = hfull + 1;                                      // [1]
  __nv_bfloat16* hown = hbuf + (size_t)rank * R * SU;               // [R][SU]

  // the last warp is the producer; the others are consumers
  const int nthreads = blockDim.x, nwarps = nthreads / 32 - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int vt = (nrows + 15) / 16;           // m16 tiles with a valid row
  const int n_items = (vt + MT - 1) / MT * GB;

  // this CTA's slice, k-pair after k-pair; the resident k-pairs, 16-byte copies
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(wf) + (size_t)rank * KP * pair;
  for (int i = threadIdx.x; i < KR * (int)(pair / 16); i += nthreads)
    reinterpret_cast<uint4*>(wres)[i] = reinterpret_cast<const uint4*>(wsrc)[i];
  // h_{-1} in every slice, bf16; zero in the padding and beyond the rows
  for (int i = threadIdx.x; i < C * R * SU; i += nthreads) {
    const int s = i / (R * SU), r = (i / SU) % R, j = i % SU;
    float h = 0.0f;
    if (CARRY && r < nrows && j < U) h = h0[(size_t)(row0 + r) * H + s * U + j];
    hbuf[i] = __float2bfloat16(h);
  }
  // k-step k's A columns 16k + 8 half lie in the slice of the CTA that owns
  // them: their offset in hbuf
  for (int k = threadIdx.x; k < KS; k += nthreads) {
    const int a = 16 * k, b = 16 * k + 8;
    koff[k] = make_int2((a / U) * R * SU + a % U, (b / U) * R * SU + b % U);
  }
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      mbar_init(cta_addr(full + d), 1);
      mbar_init(cta_addr(empty + d), n_items);
    }
    mbar_init(cta_addr(hfull), 1);
    mbar_init(cta_addr(gfull), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // step t's gates: four boxes (one a gate) of the CTA's rows and units
  const int dir = reverse ? -1 : 1, t0 = reverse ? T - 1 : 0;
  auto fetch_gates = [&](int t) {
    xbar_expect(cta_addr(gfull), 8 * box);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_3d(cta_addr(gx + q * box), &gmap, q * H + col0, row0, t,
                  cta_addr(gfull));
  };
  if (threadIdx.x == 0) fetch_gates(t0);

  // the producer: stage n (n < T * NS) is k-pair KR + n % NS of the slice
  // into slot n % D, once the consumers have emptied its previous stage n - D
  const bool producer = warp == nwarps && lane == 0;
  const int total = T * NS, ahead = min(D, NS);
  int issued = 0;
  auto produce = [&](int upto) {
    for (upto = min(upto, total); issued < upto; ++issued) {
      const int slot = issued % D, use = issued / D;
      if (use > 0) xbar_wait(cta_addr(empty + slot), (use - 1) & 1);
      xbar_expect(cta_addr(full + slot), pair);
      bulk_from_global(cta_addr(ring + (size_t)slot * pair),
                       wsrc + (size_t)(KR + issued % NS) * pair, pair,
                       cta_addr(full + slot));
    }
  };
  if (producer) produce(ahead);

  // this warp's item: tiles m0 .. m0 + MT - 1, unit groups g0 .. g0 + NG - 1
  const bool consumer = warp < n_items;
  const int m0 = warp / GB * MT, g0 = warp % GB * NG;
  // c of (tile m, group n): index 2 * half + e is row (m0 + m) * 16 + grp +
  // 8 half, unit col0 + 8 (g0 + n) + 2 tq + e
  float cst[MT][NG][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (m0 + m) * 16 + grp + 8 * (i >> 1);
        cst[m][n][i] = 0.0f;
        if (CARRY && consumer && r < nrows)
          cst[m][n][i] =
              c0[(size_t)(row0 + r) * H + col0 + 8 * (g0 + n) + 2 * tq + (i & 1)];
      }
  cluster.sync();      // every CTA has started and filled its buffers

  const __nv_bfloat16* arow = hbuf + (size_t)(m0 * 16 + (lane & 15)) * SU;
  const int ahalf = lane >> 4;
  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const bool last = s == T - 1;

    float acc[MT][NG][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][q][e] = 0.0f;

    if (consumer) {
      // the products of k-pair p, whose fragments lie at wp: k-step 2p, then
      // 2p + 1, each for every gate and (tile, group) accumulator, the
      // consecutive products on different accumulators; the fragments of
      // one k-step at a time, to keep the registers for the accumulators
      auto pair_mma = [&](const unsigned char* wp, int p) {
        const uint2* wb = reinterpret_cast<const uint2*>(wp);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int2 o = koff[2 * p + kk];
          const int off = ahalf ? o.y : o.x;
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            ldmatrix_x4(a[m], arow + m * 16 * SU + off);
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
                mma16816(acc[m][n][q], a[m], b[n].x, b[n].y);
          }
        }
      };
      for (int p = 0; p < KR; ++p) pair_mma(wres + (size_t)p * pair, p);
      for (int j = 0; j < NS; ++j) {
        const int n = s * NS + j, slot = n % D;
        xbar_wait(cta_addr(full + slot), (n / D) & 1);
        pair_mma(ring + (size_t)slot * pair, KR + j);
        __syncwarp();
        if (lane == 0) mbar_arrive(cta_addr(empty + slot));
      }
    }
    // the next step's first stages, as the consumers empty this step's last
    // slots: their copies run under the cell and the exchange
    if (producer) produce((s + 1) * NS + ahead);
    __syncwarp();
    // this CTA has read h_{t-1}: peers may overwrite it once all have; its
    // own slice, which only this CTA reads, once its warps have
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    __syncthreads();

    // the cell, on the accumulators; bf16 h_t into the CTA's own slice
    if (consumer) {
      xbar_wait(cta_addr(gfull), s & 1);      // step t's gates
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = (m0 + m) * 16 + grp + 8 * half;
            const int jl = 8 * (g0 + n) + 2 * tq;
            const bool valid = r < nrows;
            float z[4][2];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 gv = load_pair(gx + q * box + r * U + jl);
              z[q][0] = gv.x + acc[m][n][q][2 * half];
              z[q][1] = gv.y + acc[m][n][q][2 * half + 1];
            }
            float hn[2], cn[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float c = sigmoidf_(z[1][e]) * cst[m][n][2 * half + e] +
                              sigmoidf_(z[0][e]) * tanhf(z[2][e]);
              cn[e] = c;
              hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
              cst[m][n][2 * half + e] = c;
            }
            store_pair(hown + r * SU + jl, hn[0], hn[1]);
            if (valid) {
              const size_t o = ((size_t)t * B + row0 + r) * H + col0 + jl;
              if (sizeof(OutT) == 4) store_pair(out + o, hn[0], hn[1]);
              if (CARRY && last) {
                store_pair(h_T + (size_t)(row0 + r) * H + col0 + jl, hn[0],
                           hn[1]);
                store_pair(c_T + (size_t)(row0 + r) * H + col0 + jl, cn[0],
                           cn[1]);
              }
            }
          }
      fence_proxy_async();   // the slice is read by the bulk copies below
    }
    // every CTA has read h_{t-1}
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (last && sizeof(OutT) == 4) break;
    __syncthreads();       // the slice is whole; the gates tile is read
    // ... and on to each peer (rank+1, rank+2, ...): one bulk copy of its
    // valid rows, completing on the peer's barrier; the next step's gates
    const uint32_t bytes = (uint32_t)nrows * SU * 2;
    if (!last) {
      if (threadIdx.x == 0) {
        xbar_expect(cta_addr(hfull), (C - 1) * bytes);
        fetch_gates(t + dir);
      }
      if (threadIdx.x < C - 1) {
        const int peer = (rank + 1 + threadIdx.x) % C;
        const uint32_t src = cta_addr(hown);
        bulk_to_peer(peer_addr(src, peer), src, bytes,
                     peer_addr(cta_addr(hfull), peer));
      }
    }
    if (sizeof(OutT) == 2) {   // bf16 h out, 16-byte pieces of the slice
      const int chunks = U / 8;
      for (int i = threadIdx.x; i < nrows * chunks; i += nthreads) {
        const int r = i / chunks, j = 8 * (i % chunks);
        *reinterpret_cast<uint4*>(out + ((size_t)t * B + row0 + r) * H + col0 +
                                  j) =
            *reinterpret_cast<const uint4*>(hown + r * SU + j);
      }
    }
    if (!last) {
      xbar_wait(cta_addr(hfull), s & 1);      // the peers' slices of h_t
      if (threadIdx.x < C - 1) bulk_wait_read();   // before hown is written
    }
  }
}

template <typename OutT, bool CARRY, int MT, int NG>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = lstm_wide_kernel<OutT, CARRY, MT, NG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The instances: (tiles, groups) of an item.
bool item_fits(int mt, int ng) {
  return (mt == 1 && ng == 2) || (mt == 3 && (ng == 2 || ng == 3));
}

bool plan_fits(int H, int C, int R, int mt, int ng, int resident,
               int stages) {
  if (!((C == 8 || C == 16) && H > 0 && item_fits(mt, ng) &&
        H % (8 * ng * C) == 0 && H % 32 == 0 && H / C <= 256 && R > 0 &&
        R <= 256 && R % (16 * mt) == 0))
    return false;
  return wide_items(H, C, R, mt, ng) <= WIDE_MAX_ITEMS && resident >= 0 &&
         resident % 2 == 0 && resident <= H / 16 && stages >= 0 &&
         (stages == 0) == (resident == H / 16);
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
// query, so the library links no libcuda (as lstm_scan_staged.cu).
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

// gates [T, B, 4H] bf16 in boxes of one step's R rows x U columns of one
// gate, no swizzle; rows beyond B read as zero.
bool gates_map(CUtensorMap* map, const void* gates, int T, int B, int H,
               int U, int R) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)4 * H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * H * 2,
                                 (cuuint64_t)B * 4 * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)U, (cuuint32_t)R, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(gates), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The instance's launch (gates given) or, with n set, its occupancy query.
template <typename OutT, bool CARRY, int MT, int NG>
int run(const void* gates, const void* wf, const void* h0, const void* c0,
        void* out, void* h_T, void* c_T, int T, int B, int H, int reverse,
        int C, int R, int resident, int stages, size_t smem, void* stream,
        int* n) {
  cudaError_t err = prepare<OutT, CARRY, MT, NG>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(32 * (wide_items(H, C, R, MT, NG) + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = lstm_wide_kernel<OutT, CARRY, MT, NG>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  CUtensorMap map = {};
  if (!gates_map(&map, gates, T, B, H, H / C, R))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, map, (const __nv_bfloat16*)wf,
                           (const float*)h0, (const float*)c0, (OutT*)out,
                           (float*)h_T, (float*)c_T, T, B, H, R, resident,
                           stages, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance (out_f32, carry)
// for the plan, refusing a plan the kernel does not take or shared bytes
// that are not its layout's.
int dispatch(int out_f32, int carry, const void* gates, const void* wf,
             const void* h0, const void* c0, void* out, void* h_T, void* c_T,
             int T, int B, int H, int reverse, int C, int R, int mt, int ng,
             int resident, int stages, size_t smem_bytes, void* stream,
             int* n) {
  if (!plan_fits(H, C, R, mt, ng, resident, stages) ||
      smem_bytes != wide_smem(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
#define WIDE_RUN(OutT, CARRY, MT, NG)                                        \
  run<OutT, CARRY, MT, NG>(gates, wf, h0, c0, out, h_T, c_T, T, B, H,        \
                           reverse, C, R, resident, stages, smem_bytes,      \
                           stream, n)
#define WIDE_ITEM(MT, NG)                                                    \
  if (mt == MT && ng == NG) {                                                \
    if (out_f32)                                                             \
      return carry ? WIDE_RUN(float, true, MT, NG)                           \
                   : WIDE_RUN(float, false, MT, NG);                         \
    return carry ? WIDE_RUN(__nv_bfloat16, true, MT, NG)                     \
                 : WIDE_RUN(__nv_bfloat16, false, MT, NG);                   \
  }
  WIDE_ITEM(1, 2)
  WIDE_ITEM(3, 2)
  WIDE_ITEM(3, 3)
#undef WIDE_ITEM
#undef WIDE_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel A. gates [T, B, 4H] bf16, wf (W_hh^T in fragment order, see above)
// -> out [T, B, H] (bf16, or fp32 when out_f32), as clusters of `cluster`
// CTAs (8 or 16; H a multiple of 8 * groups * cluster and of 32, H /
// cluster at most 256) over `rows` batch rows each (a multiple of 16 *
// tiles, at most 256), items of `tiles` m16 tiles x `groups` 8-unit groups
// (1 x 2, 3 x 2 or 3 x 3; at most seven items a CTA), `resident` k-steps of
// each slice resident (even; all H / 16 with no ring) and a ring of
// `stages` k-pairs (0 only then); smem_bytes must be the layout's
// (ops/lstm.py wide_smem_bytes).
int lstm_scan_fwd_wide(const void* gates, const void* wf, void* out,
                       int out_f32, int T, int B, int H, int reverse,
                       int cluster, int rows, int tiles, int groups,
                       int resident, int stages, int smem_bytes,
                       void* stream) {
  return dispatch(out_f32, 0, gates, wf, nullptr, nullptr, out, nullptr,
                  nullptr, T, B, H, reverse, cluster, rows, tiles, groups,
                  resident, stages, (size_t)smem_bytes, stream, nullptr);
}

// Kernel B. As kernel A, plus h0, c0 [B, H] fp32 in and h_T, c_T [B, H]
// fp32 out (the state after the last processed step).
int lstm_scan_fwd_carry_wide(const void* gates, const void* wf,
                             const void* h0, const void* c0, void* out,
                             void* h_T, void* c_T, int out_f32, int T, int B,
                             int H, int reverse, int cluster, int rows,
                             int tiles, int groups, int resident, int stages,
                             int smem_bytes, void* stream) {
  return dispatch(out_f32, 1, gates, wf, h0, c0, out, h_T, c_T, T, B, H,
                  reverse, cluster, rows, tiles, groups, resident, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance (out_f32, carry) with the
// plan's item (tiles x groups), resident k-steps and stages, for a cluster
// of `cluster` CTAs over `rows` rows at H: *n clusters can run at once.
int lstm_scan_wide_max_clusters(int out_f32, int carry, int tiles,
                                int groups, int resident, int stages, int H,
                                int cluster, int rows, int* n) {
  return dispatch(out_f32, carry, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, 0, 0, H, 0, cluster, rows, tiles, groups,
                  resident, stages, wide_smem(H, cluster, rows, resident,
                                              stages), nullptr, n);
}

const char* lstm_scan_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
