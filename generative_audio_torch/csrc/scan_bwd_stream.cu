// Streamed cluster backwards of the LSTM scan (kernel D) and of the GRU
// scan, for sm_90a: lstm_scan_bwd_stream and gru_scan_bwd_stream.
//
// They replace, where no resident cluster holds H, two Pallas TPU kernels of
// generative_audio_tpu/ops/pallas_lstm.py:
//   * lstm_scan_bwd_stream <- :300 _lstm_pallas_call_bwd / _lstm_bwd_kernel
//     (pl.pallas_call at :329), the reverse-time LSTM backward that
//     recomputes the gates and emits bf16 dgates;
//   * gru_scan_bwd_stream <- :1019 _gru_pallas_call_bwd / _gru_bwd_kernel
//     (pl.pallas_call at :1043): dgx, the bf16 dhn stream and the db_hh
//     partials; its dW_hh line (:1011) stays the contraction
//     gru_scan_bwd_dwhh of gru_scan_bwd.cu.
// What each step computes is the single block's and the resident cluster's
// (csrc/lstm_scan_bwd.cu, csrc/gru_scan_bwd.cu): the gates recompute from
// h_prev (h_seq one processing step earlier), the elementwise backward with
// dh (and the LSTM's dc) in fp32, and dh = bf16(dgates) @ W_hh^T.
//
// What bounds them on an H100. The serial chain of T steps, each two
// dependent products over W_hh: n H x H bf16 (n = 4 LSTM, 3 GRU), 8.4 MB at
// H = 1024 and 42.5 MB at H = 2304 for the LSTM, too large for the shared
// memory of a cluster (16 x 227 KB), so each CTA reads its part of both
// layouts from L2 at every step. The single block (16 rows, 8 warps, both
// layouts from L2 in dependent 4-byte loads, 2 of 132 SMs busy at 18 rows)
// took 132.7 ms at H = 1024 x 18 rows x T = 195, about 25 GB/s an SM.
//
// Design: the resident cluster backward (lstm_bwd_cluster_kernel,
// gru_bwd_cluster_kernel), its weight slices streamed.
//   * A cluster of C CTAs (16, or 8) owns R rows; CTA k owns units
//     [k U, (k+1) U), U = H / C, and their n gate columns. A compute warp
//     runs the elementwise part and the second product of up to
//     ITEMS_PER_WARP (m16 row tile, 8 units) items of one row tile, with
//     their dh and dc (GRU: dh, the carry dh_tot * z and the db_hh sums) in
//     its registers; a recompute warp runs the gates recompute of the same
//     items one step ahead, reading h_prev from h_seq, while the step's
//     exchange and second product run. At most ROLE_WARPS warps of each
//     role and MAX_ITEMS items a CTA (H up to 2304 at C = 16, the forwards'
//     limit); one B fragment load feeds no more MMAs than one item's, but
//     the A fragments of a k-step are loaded once for all of a warp's items.
//   * Both weight operands stream. The recompute's W_hh^T slice (n U rows
//     of wt) and the second product's W_hh slice (the U rows of w [H, n H]
//     of the CTA's units) are packed by the wrapper in MMA fragment order,
//     in the order their k loops consume them, as H / 32 slots of n U 64
//     bytes each: one k-pair (32 columns) of the recompute's slice, or n
//     k-pairs of the second product's. The first `resident` slots of each
//     stay in shared memory; the others pass through two rings of `stages`
//     slots, one for each product, each slot filled by one cp.async.bulk
//     from L2 that completes on the slot's full mbarrier, with an empty
//     mbarrier a slot (PR 20's machinery of csrc/lstm_scan.cu). The two
//     products run at the same time on different warps, so one ring filled
//     in a fixed interleaved order could hold one product's next slot behind
//     a slot that the other has not yet emptied: each product has its own
//     ring, and the producer (one thread of the last warp) polls both rings'
//     empty barriers without blocking (mbarrier.test_wait) and refills
//     whichever slot is free, up to the next step's first slots, so that
//     neither waits on the other.
//   * The dgates tile. Where it fits beside the rings (H up to about 1024),
//     each CTA keeps the whole owner-laid tile [C][R][n U + pad] and sends
//     its slice to each peer with one bulk copy that completes on the
//     peer's mbarrier (TILE, today's exchange). Above, a CTA keeps only its
//     own slice [R][n U + pad]: after a cluster barrier (release / acquire)
//     the compute warps of a row tile pull each weight slot's 2n k-steps of
//     A from the owners' slices over distributed shared memory, in 16-byte
//     pieces (ld.shared::cluster) found through a table of each k-step's
//     two 8-column halves,
//     into a double-buffered staging tile, one slot ahead of the products
//     (every warp reading its A fragments in place, 4-byte loads from the
//     peers, took 3x the whole tile's step); a second cluster barrier keeps
//     each slice until every CTA has read it.
//   * Numerics unchanged: mma.sync m16n8k16, bf16 operands, fp32
//     accumulators from zero, kernel D's k order in both products (the
//     resident k-steps, then the streamed ones, each accumulator's k-steps
//     in order), and the single block's cell expressions, so dgates (GRU:
//     dgx, dhn and every db_hh partial) are bit-identical to the single
//     block's and to the resident cluster's.
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>

#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ITEMS_PER_WARP = 3;   // (m16 tile, 8 units) items a warp, at most
constexpr int ROLE_WARPS = 7;       // compute (and recompute) warps, at most
constexpr int MAX_ITEMS = 18;       // items a CTA, at most
// Warps of a CTA at most: both roles and the producer. Fifteen, so that no
// quarter of the SM holds more than four and a thread may use 128 registers
// (seventeen put five in one quarter and left 96).
constexpr int STREAM_BWD_WARPS = 2 * ROLE_WARPS + 1;

// Row stride (bf16) of one CTA's slice of the dgates tile: its n U gate
// columns and a pad that makes the stride 4 words past a multiple of 8.
__host__ __device__ inline int slice_stride(int U, int n) {
  return n * U + (n * U % 16 == 0 ? 8 : 16);
}

// Bytes of one slot of either ring: n gates x U units x 32 columns bf16.
__host__ __device__ inline int slot_bytes(int U, int n) {
  return n * U * 64;
}

// Items a warp carries for `tiles` m16 row tiles of G unit groups: the
// fewest that leave each role at most ROLE_WARPS warps; 0 where none does.
__host__ __device__ inline int warp_items(int tiles, int G) {
  if (tiles * G > MAX_ITEMS) return 0;
  for (int ni = 1; ni <= ITEMS_PER_WARP; ++ni)
    if (tiles * ((G + ni - 1) / ni) <= ROLE_WARPS) return ni;
  return 0;
}

// Warps of each role (compute, recompute) of a CTA.
__host__ __device__ inline int role_warps(int tiles, int G) {
  const int ni = warp_items(tiles, G);
  return ni ? tiles * ((G + ni - 1) / ni) : 0;
}

// Shared bytes of one CTA, in the order the kernel lays them out: the two
// rings [2][stages][slot] and the resident slots [2][resident][slot],
// h_prev [R][H + PAD] bf16, the dgates tile [C][R][slice_stride] (TILE) or
// the CTA's slice [R][slice_stride] and the second product's A operand of
// one slot's 2n k-steps, pulled from the owners' slices, double buffered
// [2][R][32 n + PAD] bf16, what the recompute hands the
// elementwise part (22 bytes a (row, unit) pair: LSTM z [R][4U] fp32 and
// c_t, c_prev, gout [3][R][U] bf16; GRU gh [R][3U] fp32, the x-side gates
// [R][3U], gout and h_prev [R][U] bf16), the second product's k-step table
// [n H / 16][2] of 4 bytes, the exchange's mbarrier (16 bytes) and the
// rings' full and empty mbarriers [4][stages]. Every region is a multiple
// of 16 bytes.
size_t stream_bwd_smem(int H, int C, int R, int n, int resident, int stages,
                       int tile) {
  const size_t U = H / C, r = R;
  return 2 * (size_t)(stages + resident) * slot_bytes(U, n) +
         r * (H + PAD) * 2 + (tile ? C : 1) * r * slice_stride(U, n) * 2 +
         (tile ? 0 : 2) * r * (32 * n + PAD) * 2 + 22 * r * U +
         (size_t)n * H / 16 * 8 + 16 + 32 * (size_t)stages;
}

bool stream_bwd_fits(int H, int C, int R, int resident, int stages) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && H % 32 == 0 &&
         R > 0 && R % 16 == 0 && warp_items(R / 16, H / C / 8) > 0 &&
         resident >= 0 && resident < H / 32 && stages >= 1;
}

// Non-blocking: has the phase of the barrier of the given parity completed?
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// 16 bytes of another CTA's shared memory (a shared::cluster address).
__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// NG gate columns a unit: 4 for the LSTM (dgates [T, B, 4H]), 3 for the GRU
// (dgx [T, B, 3H], dhn [T, B, H], db_hh partials [ceil(B / 16), 3H]).
template <int NG, bool TILE>
__global__ void __launch_bounds__(STREAM_BWD_WARPS * 32, 1)
bwd_stream_kernel(const __nv_bfloat16* __restrict__ gates,   // [T, B, NG H]
                  const __nv_bfloat16* __restrict__ h_seq,   // [T, B, H]
                  const __nv_bfloat16* __restrict__ c_seq,   // LSTM [T, B, H]
                  const __nv_bfloat16* __restrict__ gout,    // [T, B, H]
                  const unsigned char* __restrict__ wrec,    // [C][H/32][slot]
                  const unsigned char* __restrict__ wdh,     // [C][H/32][slot]
                  const float* __restrict__ bhh,             // GRU [3H]
                  __nv_bfloat16* __restrict__ dg_out,        // [T, B, NG H]
                  __nv_bfloat16* __restrict__ dhn,           // GRU [T, B, H]
                  float* __restrict__ dbhh,                  // GRU partials
                  int T, int B, int H, int R, int resident, int stages,
                  int reverse) {
  constexpr int NI = ITEMS_PER_WARP;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, UN = NG * U, hs = H + PAD, GN = NG * H;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int mrows = (nrows + 15) / 16 * 16;   // rows of the valid m16 tiles
  const int sw = slice_stride(U, NG);
  const int G = U / 8, ni = warp_items(R / 16, G), wpt = (G + ni - 1) / ni;
  const int nw = R / 16 * wpt;                // warps of each role
  const int busy = mrows / 16 * wpt;          // of them, those with items
  const int KS = H / 32, NS = KS - resident, D = stages;
  const uint32_t slot = (uint32_t)slot_bytes(U, NG);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring1 = smem;                                  // [D][slot]
  unsigned char* ring2 = ring1 + (size_t)D * slot;              // [D][slot]
  unsigned char* res1 = ring2 + (size_t)D * slot;               // [resident]
  unsigned char* res2 = res1 + (size_t)resident * slot;         // [resident]
  __nv_bfloat16* htile =
      reinterpret_cast<__nv_bfloat16*>(res2 + (size_t)resident * slot);
  __nv_bfloat16* dgt = htile + R * hs;        // [C][R][sw] or [R][sw]
  // (not TILE) the staged A operand of a slot: [2][R][SA]
  __nv_bfloat16* stg = dgt + (TILE ? C : 1) * R * sw;
  const int SA = 32 * NG + PAD;
  float* zt = reinterpret_cast<float*>(stg + (TILE ? 0 : 2) * R * SA);
  uint32_t* hand = reinterpret_cast<uint32_t*>(zt + R * UN);
  // LSTM: c_t, c_prev and gout [3][R][U/2]; GRU: the x-side gates
  // [R][3U/2], gout and h_prev [2][R][U/2]
  uint32_t* const ct_s = hand;
  uint32_t* const cp_s = hand + R * U / 2;
  uint32_t* const gx_s = hand;
  uint32_t* const go_s = hand + (NG == 4 ? R * U : R * UN / 2);
  uint32_t* const hp_s = go_s + R * U / 2;
  // the second product's k-steps: where each one's two 8-column halves lie
  // (TILE: element offsets in dgt; else shared::cluster addresses in the
  // owners' slices)
  uint32_t* ktab = hand + (NG == 4 ? 3 : 5) * R * U / 2;   // [GN/16][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ktab + 2 * (GN / 16));
  const uint32_t xbar = cta_addr(bars);
  // ring barriers: 0 full / 1 empty of the recompute's, 2 / 3 of the second
  // product's
  auto bar = [&](int which, int d) { return cta_addr(bars + 2 + which * D + d); };
  const int nthreads = blockDim.x;

  // this CTA's slots of both operands; the resident ones, 16-byte copies
  const unsigned char* src1 = wrec + (size_t)rank * KS * slot;
  const unsigned char* src2 = wdh + (size_t)rank * KS * slot;
  for (int i = threadIdx.x; i < resident * (int)(slot / 16); i += nthreads) {
    reinterpret_cast<uint4*>(res1)[i] = reinterpret_cast<const uint4*>(src1)[i];
    reinterpret_cast<uint4*>(res2)[i] = reinterpret_cast<const uint4*>(src2)[i];
  }
  // column q H + u of the dgates row lies in the slice of CTA u / U, at
  // q U + u % U; a k-step's 16 columns are two groups of 8 units
  for (int k = threadIdx.x; k < GN / 16; k += nthreads) {
    const int q = k * 16 / H;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int u = k * 16 % H + 8 * h2, owner = u / U, col = q * U + u % U;
      if constexpr (TILE)
        ktab[2 * k + h2] = owner * R * sw + col;
      else
        ktab[2 * k + h2] = peer_addr(cta_addr(dgt + col), owner);
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    for (int d = 0; d < D; ++d) {
      mbar_init(bar(0, d), 1);
      mbar_init(bar(1, d), busy);
      mbar_init(bar(2, d), 1);
      mbar_init(bar(3, d), busy);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  // warps [0, nw) compute, [nw, 2 nw) recompute, 2 nw the producer; warp w
  // of a role takes row tile w / wpt and unit groups from (w % wpt) ni
  const bool is_cmp = warp < busy;
  const bool in_rec = warp >= nw && warp < 2 * nw;
  const bool is_rec = in_rec && warp - nw < busy;
  const bool producer = warp == 2 * nw && lane == 0;
  const int rw = is_cmp ? warp : is_rec ? warp - nw : 0;
  const int mt = rw / wpt, g0 = rw % wpt * ni;
  const int nit = (is_cmp || is_rec) ? min(ni, G - g0) : 0;
  const int arow = mt * 16 + grp;             // the A fragments' first row

  // h_prev of the cluster's rows at array time t (zero beyond B or when
  // `zero`), into htile; 16-byte copies by the threads [first, first + n)
  auto load_h = [&](int t, bool zero, int first, int n) {
    const int per_row = H / 8;
    for (int i = threadIdx.x - first; i < R * per_row; i += n) {
      const int r = i / per_row, j = (i % per_row) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!zero && r < nrows)
        v = *reinterpret_cast<const uint4*>(h_seq +
                                            ((size_t)t * B + row0 + r) * H + j);
      *reinterpret_cast<uint4*>(htile + r * hs + j) = v;
    }
  };
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it
  const int step = reverse ? 1 : -1;          // t(p-1) = t(p) + step
  const int t_first = reverse ? 0 : T - 1;
  load_h(t_first + step, T == 1, 0, nthreads);

  // a recompute warp: the gates recompute of step s (z = gates + h_prev @
  // W_hh; GRU gh = h_prev @ W_hh + b_hh) for its items into zt, and that
  // step's operands of the elementwise part into the hand-over
  auto recompute = [&](int s) {
    const int t = reverse ? s : T - 1 - s, tprev = t + step;
    const bool first = (s == T - 1);          // p == 0: zero c_prev
    float acc[NI][NG][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.0f;
    const __nv_bfloat16* ap = htile + arow * hs + 2 * tq;
    // k-pair p (k-steps 2p, 2p + 1; A loaded by load_pair) from the slot at
    // wp: for each item the n gates of k-step 2p, then of 2p + 1, each
    // accumulator in k order
    uint32_t a[2][4];
    auto load_pair = [&](int p) {
      load_a(a[0], ap + 32 * p, hs);
      load_a(a[1], ap + 32 * p + 16, hs);
    };
    auto pair = [&](const unsigned char* wp) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i >= nit) break;
        uint4 b[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q)
          b[q] = reinterpret_cast<const uint4*>(wp)[(q * G + g0 + i) * 32 + lane];
#pragma unroll
        for (int q = 0; q < NG; ++q)
          mma_bf16_16816(acc[i][q], a[0], b[q].x, b[q].y);
#pragma unroll
        for (int q = 0; q < NG; ++q)
          mma_bf16_16816(acc[i][q], a[1], b[q].z, b[q].w);
      }
    };
    for (int p = 0; p < resident; ++p) {
      load_pair(p);
      pair(res1 + (size_t)p * slot);
    }
    for (int j = 0; j < NS; ++j) {
      const int n = s * NS + j, d = n % D;
      load_pair(resident + j);
      xbar_wait(bar(0, d), (n / D) & 1);
      pair(ring1 + (size_t)d * slot);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(1, d));
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i >= nit) break;
      const int jl = 8 * (g0 + i) + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = arow + 8 * half, row = row0 + r;
        const bool valid = r < nrows;
        const size_t at = ((size_t)t * B + row) * H + col0 + jl;
        const __nv_bfloat16* gp = gates + ((size_t)t * B + row) * GN + col0 + jl;
        if constexpr (NG == 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 gx = bf2(valid ? ldg32(gp + q * H) : 0u);
            *reinterpret_cast<float2*>(zt + r * UN + q * U + jl) =
                make_float2(gx.x + acc[i][q][2 * half],
                            gx.y + acc[i][q][2 * half + 1]);
          }
          ct_s[r * U / 2 + jl / 2] = valid ? ldg32(c_seq + at) : 0u;
          cp_s[r * U / 2 + jl / 2] =
              valid && !first
                  ? ldg32(c_seq + ((size_t)tprev * B + row) * H + col0 + jl)
                  : 0u;
          go_s[r * U / 2 + jl / 2] = valid ? ldg32(gout + at) : 0u;
        } else {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float* bq = bhh + q * H + col0 + jl;
            *reinterpret_cast<float2*>(zt + r * UN + q * U + jl) =
                make_float2(acc[i][q][2 * half] + __ldg(bq),
                            acc[i][q][2 * half + 1] + __ldg(bq + 1));
            gx_s[r * UN / 2 + (q * U + jl) / 2] = valid ? ldg32(gp + q * H) : 0u;
          }
          go_s[r * U / 2 + jl / 2] = valid ? ldg32(gout + at) : 0u;
          hp_s[r * U / 2 + jl / 2] = ld32(htile + r * hs + col0 + jl);
        }
      }
    }
  };

  // a compute warp's state for item i's (row, unit) pairs: index 2 half + e
  // is row mt*16 + grp + 8 half, unit col0 + 8 (g0 + i) + 2 tq + e; the GRU's
  // db_hh sums of the item's columns in the lanes with grp == 0
  float dh[NI][4], dc[NI][4], carry[NI][4], dbacc[NI][3][2];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dh[i][e] = dc[i][e] = carry[i][e] = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) dbacc[i][q][0] = dbacc[i][q][1] = 0.0f;
  }

  // a compute warp: the elementwise backward of step s for its items into
  // the CTA's slice of the dgates tile and the outputs
  auto elementwise = [&](int s) {
    const int t = reverse ? s : T - 1 - s;
    __nv_bfloat16* own = TILE ? dgt + rank * R * sw : dgt;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      if (i >= nit) break;
      const int jl = 8 * (g0 + i) + 2 * tq;
      float dbsum[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) dbsum[q][0] = dbsum[q][1] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = arow + 8 * half, row = row0 + r;
        const bool valid = r < nrows;
        __nv_bfloat16* go = dg_out + ((size_t)t * B + row) * GN + col0 + jl;
        if constexpr (NG == 4) {     // kernel D's cell
          float z[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 zq =
                *reinterpret_cast<const float2*>(zt + r * UN + q * U + jl);
            z[q][0] = zq.x;
            z[q][1] = zq.y;
          }
          const float2 ct = bf2(ct_s[r * U / 2 + jl / 2]),
                       cp = bf2(cp_s[r * U / 2 + jl / 2]),
                       gv = bf2(go_s[r * U / 2 + jl / 2]);
          const float c_t[2] = {ct.x, ct.y}, c_prev[2] = {cp.x, cp.y},
                      g_out[2] = {gv.x, gv.y};
          float dg[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float gi = sigmoidf_(z[0][e]), gf = sigmoidf_(z[1][e]),
                        gg = tanhf(z[2][e]), og = sigmoidf_(z[3][e]);
            const float tc = tanhf(c_t[e]);
            const float dh_tot = g_out[e] + dh[i][2 * half + e];
            const float dc_tot =
                dc[i][2 * half + e] + dh_tot * og * (1.0f - tc * tc);
            dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
            dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
            dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
            dg[3][e] = dh_tot * tc * og * (1.0f - og);
            dc[i][2 * half + e] = dc_tot * gf;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
            *reinterpret_cast<__nv_bfloat162*>(own + r * sw + q * U + jl) = v;
            if (valid) *reinterpret_cast<__nv_bfloat162*>(go + q * H) = v;
          }
        } else {                     // the GRU scan's cell
          float x[3][2], gh[3][2];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float2 gxv = bf2(gx_s[r * UN / 2 + (q * U + jl) / 2]);
            const float2 ghv =
                *reinterpret_cast<const float2*>(zt + r * UN + q * U + jl);
            x[q][0] = gxv.x;
            x[q][1] = gxv.y;
            gh[q][0] = ghv.x;
            gh[q][1] = ghv.y;
          }
          const float2 gv = bf2(go_s[r * U / 2 + jl / 2]);
          // the bf16 residual, upcast; zero at the first processed position
          const float2 hp2 = bf2(hp_s[r * U / 2 + jl / 2]);
          const float g_out[2] = {gv.x, gv.y}, h_prev[2] = {hp2.x, hp2.y};
          float dg[3][2], dxn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float rg = sigmoidf_(x[0][e] + gh[0][e]);
            const float zg = sigmoidf_(x[1][e] + gh[1][e]);
            const float ng = tanhf(x[2][e] + rg * gh[2][e]);
            const float dh_tot = g_out[e] + dh[i][2 * half + e];
            const float dn = dh_tot * (1.0f - zg);
            const float dz = dh_tot * (h_prev[e] - ng);
            dxn[e] = dn * (1.0f - ng * ng);
            dg[0][e] = dxn[e] * gh[2][e] * rg * (1.0f - rg);
            dg[1][e] = dz * zg * (1.0f - zg);
            dg[2][e] = dxn[e] * rg;
            carry[i][2 * half + e] = dh_tot * zg;   // the product is added below
#pragma unroll
            for (int q = 0; q < 3; ++q) dbsum[q][e] += dg[q][e];
          }
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
            *reinterpret_cast<__nv_bfloat162*>(own + r * sw + q * U + jl) = v;
            if (valid) {
              if (q < 2)
                *reinterpret_cast<__nv_bfloat162*>(go + q * H) = v;
              else
                *reinterpret_cast<__nv_bfloat162*>(
                    dhn + ((size_t)t * B + row) * H + col0 + jl) = v;
            }
          }
          if (valid)
            *reinterpret_cast<__nv_bfloat162*>(go + 2 * H) =
                __floats2bfloat162_rn(dxn[0], dxn[1]);
        }
      }
      if constexpr (NG == 3) {
        // db_hh: add the eight row groups of the warp (lanes that share tq)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = dbsum[q][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (grp == 0) dbacc[i][q][e] += v;
          }
      }
    }
    if constexpr (TILE) fence_proxy_async();   // read by the bulk copies
  };

  // a compute warp: dh = bf16(dgates) @ W_hh^T over all n H for its items'
  // units (GRU: + dh_tot * z), from the whole tile (TILE) or the owners'
  // slices
  auto second = [&](int s) {
    float acc2[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][e] = 0.0f;
    uint32_t a[2 * NG][4];   // the A fragments of a slot's 2n k-steps
    // the slot's n k-pairs from the weight slot at wp: for each item
    // k-step 2pp, then 2pp + 1, each accumulator in k order
    auto slot_mma = [&](const unsigned char* wp) {
#pragma unroll
      for (int pp = 0; pp < NG; ++pp)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i >= nit) break;
          const uint4 b =
              reinterpret_cast<const uint4*>(wp)[(pp * G + g0 + i) * 32 + lane];
          mma_bf16_16816(acc2[i], a[2 * pp], b.x, b.y);
          mma_bf16_16816(acc2[i], a[2 * pp + 1], b.z, b.w);
        }
    };
    // the weight slot sl: resident, or streamed once its full barrier
    // completes; and, after its products, the streamed slot's release
    auto weights = [&](int sl) -> const unsigned char* {
      if (sl < resident) return res2 + (size_t)sl * slot;
      const int n = s * NS + sl - resident, d = n % D;
      xbar_wait(bar(2, d), (n / D) & 1);
      return ring2 + (size_t)d * slot;
    };
    auto release = [&](int sl) {
      if (sl < resident) return;
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(3, (s * NS + sl - resident) % D));
    };
    if constexpr (TILE) {
      // A (16x16, row-major) of each k-step from the whole tile: its two
      // 8-column halves lie in the slices of the CTAs that own their units
      const int aoff = arow * sw + 2 * tq;
      for (int sl = 0; sl < KS; ++sl) {
#pragma unroll
        for (int kk = 0; kk < 2 * NG; ++kk) {
          const uint32_t* kt = ktab + 2 * (2 * NG * sl + kk);
          const __nv_bfloat16* p0 = dgt + kt[0] + aoff;
          const __nv_bfloat16* p1 = dgt + kt[1] + aoff;
          a[kk][0] = ld32(p0);
          a[kk][1] = ld32(p0 + 8 * sw);
          a[kk][2] = ld32(p1);
          a[kk][3] = ld32(p1 + 8 * sw);
        }
        slot_mma(weights(sl));
        release(sl);
      }
    } else {
      // The warps of a row tile pull each slot's A from the owners' slices
      // in 16-byte pieces (a row's 8-column half of a k-step) into the
      // staging buffer, one slot ahead: the next slot's pieces are loaded
      // into registers before this slot's products and stored after them,
      // and a barrier of the row tile's warps completes a buffer. Pieces
      // beyond HOLD a thread are loaded and stored at once.
      constexpr int HOLD = 3;
      const int gsize = wpt * 32, tg = rw % wpt * 32 + lane;
      const int pieces = 16 * 4 * NG;            // rows x k-steps x halves
      const int tiles = R / 16;
      auto src = [&](int sl, int i) {
        const int r = i / (4 * NG), kk = i % (4 * NG) / 2, h2 = i % 2;
        return ld_cluster16(ktab[2 * (2 * NG * sl + kk) + h2] +
                            (mt * 16 + r) * sw * 2);
      };
      auto dst = [&](int buf, int i) {
        const int r = i / (4 * NG), kk = i % (4 * NG) / 2, h2 = i % 2;
        return reinterpret_cast<uint4*>(
            stg + ((buf * tiles + mt) * 16 + r) * SA + kk * 16 + h2 * 8);
      };
      uint4 hold[HOLD];
      auto fetch = [&](int sl) {
#pragma unroll
        for (int j = 0; j < HOLD; ++j)
          if (tg + j * gsize < pieces) hold[j] = src(sl, tg + j * gsize);
      };
      auto commit = [&](int sl, int buf) {
#pragma unroll
        for (int j = 0; j < HOLD; ++j)
          if (tg + j * gsize < pieces) *dst(buf, tg + j * gsize) = hold[j];
        for (int i = tg + HOLD * gsize; i < pieces; i += gsize)
          *dst(buf, i) = src(sl, i);
      };
      auto group_sync = [&]() {
        asm volatile("bar.sync %0, %1;\n" :: "r"(1 + mt), "r"(gsize)
                     : "memory");
      };
      fetch(0);
      commit(0, 0);
      group_sync();
      for (int sl = 0; sl < KS; ++sl) {
        if (sl + 1 < KS) fetch(sl + 1);
        const __nv_bfloat16* ap = stg + ((sl & 1) * tiles + mt) * 16 * SA +
                                  grp * SA + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < 2 * NG; ++kk) load_a(a[kk], ap + kk * 16, SA);
        slot_mma(weights(sl));
        release(sl);
        if (sl + 1 < KS) commit(sl + 1, (sl + 1) & 1);
        group_sync();
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dh[i][e] = NG == 4 ? acc2[i][e] : acc2[i][e] + carry[i][e];
  };

  // the producer: stage n of a ring (n < T NS) is streamed slot
  // resident + n % NS of the CTA's operand, into slot n % D, once the
  // consumers have emptied that slot's stage n - D; it issues whichever
  // ring's next stage is free, up to t1 (recompute) and t2 (second product)
  int is1 = 0, is2 = 0;
  const int total = T * NS, ahead = min(D, NS);
  auto produce = [&](int t1, int t2) {
    t1 = min(t1, total);
    t2 = min(t2, total);
    while (is1 < t1 || is2 < t2) {
      bool issued = false;
      if (is1 < t1 && (is1 < D || mbar_test(bar(1, is1 % D), (is1 / D - 1) & 1))) {
        const int d = is1 % D;
        xbar_expect(bar(0, d), slot);
        bulk_from_global(cta_addr(ring1 + (size_t)d * slot),
                         src1 + (size_t)(resident + is1 % NS) * slot, slot,
                         bar(0, d));
        ++is1;
        issued = true;
      }
      if (is2 < t2 && (is2 < D || mbar_test(bar(3, is2 % D), (is2 / D - 1) & 1))) {
        const int d = is2 % D;
        xbar_expect(bar(2, d), slot);
        bulk_from_global(cta_addr(ring2 + (size_t)d * slot),
                         src2 + (size_t)(resident + is2 % NS) * slot, slot,
                         bar(2, d));
        ++is2;
        issued = true;
      }
      if (!issued) __nanosleep(32);
    }
  };

  cluster.sync();      // every CTA has started and filled its slots and table
  if (producer) produce(NS + ahead, ahead);
  else if (is_rec) recompute(0);
  __syncwarp();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s, tprev = t + step;
    // (not TILE) every CTA has read this CTA's slice of step s-1
    if (!TILE && s > 0) cluster_wait();
    __syncthreads();   // step s's recompute is in zt; the last product is done

    if (is_cmp) elementwise(s);
    else if (in_rec && s + 1 < T)          // the next h_prev
      load_h(tprev + step, s + 2 == T, nw * 32, nw * 32);
    __syncthreads();   // the CTA's dgates slice is written; zt is read

    if constexpr (TILE) {
      // every peer has read its copy of this CTA's slice of step s-1; hand
      // the slice on: one bulk copy of its valid rows to each peer (rank+1,
      // rank+2, ...), completing on the peer's barrier
      if (s > 0) cluster_wait();
      const uint32_t bytes = mrows * sw * 2;
      if (threadIdx.x == 0) xbar_expect(xbar, (C - 1) * bytes);
      if (threadIdx.x < C - 1) {
        const int peer = (rank + 1 + threadIdx.x) % C;
        const uint32_t src = cta_addr(dgt + rank * R * sw);
        bulk_to_peer(peer_addr(src, peer), src, bytes, peer_addr(xbar, peer));
      }
    } else {
      cluster_arrive();                        // this CTA's slice of step s
      if (is_cmp) cluster_wait();              // and every peer's
    }

    if (is_cmp) {
      if constexpr (TILE) xbar_wait(xbar, s & 1);   // the peers' slices
      second(s);
    } else if (is_rec) {
      if (s + 1 < T) recompute(s + 1);         // off the serial chain
    } else if (producer) {
      produce((s + 2) * NS + ahead, (s + 1) * NS + ahead);
    }
    __syncwarp();
    if constexpr (TILE) {
      if (threadIdx.x < C - 1) bulk_wait_read();   // before dgt is written again
    } else {
      if (!is_cmp) cluster_wait();
    }
    cluster_arrive();
  }
  cluster_wait();

  if constexpr (NG == 3) {
    // one db_hh partial per 16-row tile of the batch, as the single block
    if (is_cmp && grp == 0) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i >= nit) break;
        float* out = dbhh + (size_t)(row0 / ROWS + mt) * GN + col0 +
                     8 * (g0 + i) + 2 * tq;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) out[q * H + e] = dbacc[i][q][e];
      }
    }
  }
}

template <int NG, bool TILE>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = bwd_stream_kernel<NG, TILE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// The launch configuration of a plan (the grid for B rows; one cluster for
// the occupancy query when B is 0).
template <int NG, bool TILE>
cudaLaunchConfig_t stream_config(int B, int H, int C, int R, int resident,
                                 int stages, cudaLaunchAttribute* attr,
                                 void* stream, cudaError_t* err) {
  const size_t smem = stream_bwd_smem(H, C, R, NG, resident, stages, TILE);
  *err = prepare<NG, TILE>(C, smem);
  *attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B > 0 ? C * ((B + R - 1) / R) : C);
  cfg.blockDim = dim3(32 * (2 * role_warps(R / 16, H / C / 8) + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int NG, bool TILE>
int launch(const void* gates, const void* h_seq, const void* c_seq,
           const void* gout, const void* wrec, const void* wdh,
           const void* bhh, void* dg_out, void* dhn, void* dbhh, int T, int B,
           int H, int reverse, int C, int R, int resident, int stages,
           void* stream) {
  cudaLaunchAttribute attr;
  cudaError_t err;
  cudaLaunchConfig_t cfg = stream_config<NG, TILE>(B, H, C, R, resident,
                                                   stages, &attr, stream, &err);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, bwd_stream_kernel<NG, TILE>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)h_seq,
                           (const __nv_bfloat16*)c_seq,
                           (const __nv_bfloat16*)gout,
                           (const unsigned char*)wrec,
                           (const unsigned char*)wdh, (const float*)bhh,
                           (__nv_bfloat16*)dg_out, (__nv_bfloat16*)dhn,
                           (float*)dbhh, T, B, H, R, resident, stages,
                           reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NG>
int max_clusters(int tile, int resident, int stages, int H, int C, int R,
                 int* n) {
  if (!stream_bwd_fits(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (tile) {
    cudaLaunchConfig_t cfg = stream_config<NG, true>(0, H, C, R, resident,
                                                     stages, &attr, nullptr,
                                                     &err);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveClusters(n, bwd_stream_kernel<NG, true>,
                                               &cfg);
  }
  cudaLaunchConfig_t cfg = stream_config<NG, false>(0, H, C, R, resident,
                                                    stages, &attr, nullptr,
                                                    &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(n, bwd_stream_kernel<NG, false>,
                                             &cfg);
}

}  // namespace

extern "C" {

// Kernel D's streamed cluster. gates [T, B, 4H], h_seq, c_seq, gout
// [T, B, H], all bf16 -> dgates [T, B, 4H] bf16, as lstm_scan_bwd. wrec is
// the recompute's W_hh^T slices and wdh the second product's W_hh slices,
// both [cluster][H/32][4 U/8][32][8] bf16 (ops/lstm.py _stream_weight and
// _stream_dh_weight). The launch plan (ops/lstm.py plan_bwd_scan): clusters
// of `cluster` CTAs (8 or 16; H a multiple of 8 cluster and of 32) over
// `rows` rows each, `resident` slots of each operand in shared memory (fewer
// than H/32), rings of `stages` slots, the whole dgates tile (`tile`) or a
// CTA's slice; smem_bytes must be the layout's.
int lstm_scan_bwd_stream(const void* gates, const void* h_seq,
                         const void* c_seq, const void* gout,
                         const void* wrec, const void* wdh, void* dgates,
                         int T, int B, int H, int reverse, int cluster,
                         int rows, int resident, int stages, int tile,
                         int smem_bytes, void* stream) {
  if (!stream_bwd_fits(H, cluster, rows, resident, stages) ||
      (size_t)smem_bytes !=
          stream_bwd_smem(H, cluster, rows, 4, resident, stages, tile))
    return (int)cudaErrorInvalidValue;
  if (tile)
    return launch<4, true>(gates, h_seq, c_seq, gout, wrec, wdh, nullptr,
                           dgates, nullptr, nullptr, T, B, H, reverse,
                           cluster, rows, resident, stages, stream);
  return launch<4, false>(gates, h_seq, c_seq, gout, wrec, wdh, nullptr,
                          dgates, nullptr, nullptr, T, B, H, reverse, cluster,
                          rows, resident, stages, stream);
}

// The GRU backward scan's streamed cluster. gates [T, B, 3H], h_seq, gout
// [T, B, H], all bf16, bhh [3H] fp32 -> dgx [T, B, 3H] bf16, dhn [T, B, H]
// bf16, dbhh [n_blocks, 3H] fp32 (one row per 16-row tile of the batch;
// n_blocks must be ceil(B / 16)), as gru_scan_bwd; wrec and wdh as above
// with 3 gates; the same plan.
int gru_scan_bwd_stream(const void* gates, const void* h_seq,
                        const void* gout, const void* wrec, const void* wdh,
                        const void* bhh, void* dgx, void* dhn, void* dbhh,
                        int n_blocks, int T, int B, int H, int reverse,
                        int cluster, int rows, int resident, int stages,
                        int tile, int smem_bytes, void* stream) {
  if (n_blocks != row_blocks(B) ||
      !stream_bwd_fits(H, cluster, rows, resident, stages) ||
      (size_t)smem_bytes !=
          stream_bwd_smem(H, cluster, rows, 3, resident, stages, tile))
    return (int)cudaErrorInvalidValue;
  if (tile)
    return launch<3, true>(gates, h_seq, nullptr, gout, wrec, wdh, bhh, dgx,
                           dhn, dbhh, T, B, H, reverse, cluster, rows,
                           resident, stages, stream);
  return launch<3, false>(gates, h_seq, nullptr, gout, wrec, wdh, bhh, dgx,
                          dhn, dbhh, T, B, H, reverse, cluster, rows,
                          resident, stages, stream);
}

// cudaOccupancyMaxActiveClusters of the streamed instance (tile or not) with
// `resident` slots and rings of `stages`, for a cluster of `cluster` CTAs
// over `rows` rows at H: *n clusters can run at once on the current device.
int lstm_scan_bwd_stream_max_clusters(int tile, int resident, int stages,
                                      int H, int cluster, int rows, int* n) {
  return max_clusters<4>(tile, resident, stages, H, cluster, rows, n);
}

int gru_scan_bwd_stream_max_clusters(int tile, int resident, int stages,
                                     int H, int cluster, int rows, int* n) {
  return max_clusters<3>(tile, resident, stages, H, cluster, rows, n);
}

const char* scan_bwd_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
