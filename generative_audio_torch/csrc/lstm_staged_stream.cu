// The staged LSTM forward scans as streamed thread-block clusters, for
// sm_90a: kernels E and F where no resident cluster of lstm_scan_staged.cu
// holds the W_hh^T slice (above H = 512), in place of their single blocks
// (csrc/lstm_scan_unrolled_block.cu, csrc/lstm_layer_block.cu).
//
// Replaces, for those H, the same two Pallas TPU kernels as
// lstm_scan_staged.cu:
//   * kernel E streamed (lstm_scan_fwd_unrolled_stream) <- lstm_unrolled /
//     _unroll_kernel of scripts/perf_lstm_unroll.py:59: kernel A (bf16 out,
//     forward) whose x-side gates arrive K steps at a time;
//   * kernel F streamed (lstm_layer_fwd_stream) <- _lstm_layer_pallas_call
//     / _lstm_layer_kernel of generative_audio_tpu/ops/pallas_lstm.py:542:
//     the LSTM layer with x_t @ W_ih inside the scan.
// A source of its own, as lstm_scan_staged.cu is, so that the instances of
// lstm_scan.cu and lstm_scan_staged.cu keep their registers.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (kernel E)
//   z   = x_t @ W_ih + bf16(h_{t-1}) @ W_hh + bias       (kernel F)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// with bf16 operands and fp32 accumulation, exactly as the single blocks and
// the resident clusters compute it: kernel F sums x_t @ W_ih's k-steps from
// zero, then h's k-steps into the same accumulators, then adds the fp32
// bias; kernel E adds the gates to h's k-steps summed from zero. gates
// [T, B, 4H] bf16; x [T, B, F] bf16 (F even); W_ih passed as wif, W_ih^T
// [4H, F32] (F32 = F rounded up to 32, zero columns) in MMA fragment order
// (ops/lstm.py _fragment_rows); W_hh as wf, each CTA's W_hh^T slice in
// fragment order, k-pair after k-pair (ops/lstm.py _stream_weight, as
// lstm_scan.cu's streamed variant takes it); bias [4H] fp32; h [T, B, H] in
// bf16 (or fp32 for kernel F).
//
// What bounds it on an H100: the serial chain of T steps, and in each step
// the part of the CTA's W_hh^T slice that shared memory does not hold,
// which every CTA reads again from L2 (W_hh^T, 2 x 4H x H bytes: 4.7 MB at
// H = 768, 42.5 MB at H = 2304). The single blocks read all of W_hh^T (and
// kernel F also W_ih^T) from L2 at every step in dependent 4-byte loads:
// 178-337 us a step at H = 768 (kernel E), 62-139 us at H = 384 (kernel F).
// The products (2 T rows (F + H) 4H operations) and the bytes (x or gates
// in, h out) lie far below that. Kernel F with F = H reads W_ih^T from L2
// at every step as well: at H = 2304 W_ih^T and W_hh^T, 42.5 MB each, no
// longer fit the 50 MB L2 together, and part of each step's reads go to
// device memory.
//
// Design: lstm_scan.cu's streamed cluster (lstm_stream_kernel). A cluster
// of C CTAs (8 or 16) owns R batch rows; CTA k owns units [k*U, (k+1)*U),
// U = H / C; every CTA keeps the cluster's bf16 h_{t-1} (double buffered)
// and hands its new slice to the peers through distributed shared memory,
// with one cluster barrier a step. The first `resident` k-steps of the
// CTA's W_hh^T slice are copied into shared memory once; the other k-pairs
// stream through a ring of `stages` slots, each filled by one
// cp.async.bulk from L2 that completes on the slot's mbarrier. The last
// warp is the producer (one thread keeps the ring full); each consumer warp
// owns one (m16 row tile, 8 units) item, so it reads each slot once a step
// and keeps the item's c (and kernel F's accumulators) in registers: there
// is no c in shared memory. What each adds:
//   * Kernel E: the x-side gates of K steps come by TMA, as in
//     lstm_scan_staged.cu's kernel E: one tensor map over gates [T, B, 4H]
//     with a box of [K, R, U], four copies a group (one a gate; rows beyond
//     B arrive as zeros) issued by the producer into a ring of `groups`
//     groups (1 or 2) on an mbarrier each, which the consumer warps wait on
//     once per K steps. A group's slot is refilled (group g + groups) once
//     the CTA has read it, at the end of the group's last step. With two
//     groups the copies run K to 2K steps ahead, off the serial chain; with
//     one (where two do not fit beside the h buffers and the ring, above
//     H = 2048 at K = 2 and 1536 at K = 4, or where the slots are worth more
//     as resident k-pairs) each group's copy waits under the exchange and
//     the first step of the group. The planner picks the depth.
//   * Kernel F: x_{t+1} @ W_ih depends on no h, so it leaves the serial
//     chain as in the resident cluster: after the step's exchange each
//     consumer warp arrives at the cluster barrier, computes the x product
//     of the next step for its item into fp32 accumulators from zero, and
//     only then waits; the next step's h product continues from them. The
//     x fragments come from global memory, where one bulk prefetch a CTA
//     brings the cluster's rows of x into L2 two steps ahead; W_ih^T's
//     slice comes from L2 in fragment order (each lane's B fragments of two
//     k-steps in 16 contiguous bytes), two k-pairs of loads in flight.
//     W_ih^T does not go through the ring: the ring is sized for the h
//     product's k-pairs, which at large H hold one slot, and the x product
//     would wait a copy's latency (about 0.55 us) a k-pair there, while its
//     L2 loads run between the arrive and the wait of the cluster barrier.
//   * Numerics: the same mma.sync m16n8k16, bf16 operands and fp32
//     accumulators from zero, each accumulator's k-steps in order (x's,
//     then h's resident and streamed ones), and the same cell expression:
//     h is bit-identical to the single blocks', to the resident clusters'
//     and, for kernel E, to lstm_scan.cu's lstm_scan_fwd_stream.
//   * The launch plan (C, R, resident k-steps, stages, and kernel E's
//     groups, and the shared bytes) comes from the caller (ops/lstm.py
//     plan_unrolled_stream and plan_layer_stream, which weigh the shared
//     bytes against lstm_staged_stream_max_clusters below and step models
//     fitted on the card); the entries refuse a plan whose bytes are not the
//     layout's. H must be a multiple of 8 * C and of 32, and a CTA takes at
//     most 18 items: H up to 2304 (the wrappers pad H with zero units).
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_WARPS = 8;          // consumer warps, at least
constexpr int STREAM_MAX_WARPS = 18;  // consumer warps (items), at most

// Bytes of one k-pair (32 columns) of a CTA's W_hh^T slice of 4 gates x U
// units in fragment order.
__host__ __device__ inline size_t pair_bytes(int U) {
  return (size_t)4 * U * 64;
}

// Shared bytes of one CTA of kernel E streamed, in the order the kernel
// lays them out: the gates ring [groups][4][K][R][U] bf16 (128-byte aligned:
// 128 bytes of slack), the W_hh^T ring [stages][k-pair] and the resident
// k-pairs [resident / 2][k-pair], two bf16 h buffers [R][H + PAD], and the
// mbarriers: full and empty a stage, one a gate group.
size_t unrolled_stream_smem(int H, int C, int R, int K, int resident,
                            int stages, int groups) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return groups * 4 * (size_t)K * r * U * 2 +
         (stages + resident / 2) * pair_bytes(U) + 2 * r * hs * 2 +
         16 * (size_t)stages + 8 * (size_t)groups + 128;
}

// Shared bytes of one CTA of kernel F streamed: the W_hh^T ring and the
// resident k-pairs, two bf16 h buffers [R][H + PAD] and the ring's full and
// empty mbarriers.
size_t layer_stream_smem(int H, int C, int R, int resident, int stages) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (stages + resident / 2) * pair_bytes(U) + 2 * r * hs * 2 +
         16 * (size_t)stages;
}

// Warps of a CTA: one consumer warp per item (at least MIN_WARPS, which
// share the exchange's stores) and the producer.
int stream_warps(int H, int C, int R) {
  return max(MIN_WARPS, (R / 16) * (H / C / 8)) + 1;
}

bool plan_fits(int H, int C, int R, int resident, int stages) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && H % 32 == 0 &&
         R > 0 && R % 16 == 0 && (R / 16) * (H / C / 8) <= STREAM_MAX_WARPS &&
         resident >= 0 && resident % 2 == 0 && resident < H / 16 &&
         stages >= 1;
}

// mma.sync m16n8k16 as lstm_scan_staged.cu's, not volatile.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte-aligned bytes of [p, p + bytes) into L2 (one bulk prefetch).
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = (a + 15) & ~(uintptr_t)15, hi = (a + bytes) & ~(uintptr_t)15;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                 :: "l"(lo), "r"((uint32_t)(hi - lo)) : "memory");
}

// One box {col, row, t} of a 3-D tensor map into shared memory, completing
// on the mbarrier `bar`.
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

// The W_hh^T ring of one CTA: `stages` slots of a k-pair, their full and
// empty mbarriers, and the slice in global memory.
struct Ring {
  const unsigned char* src;     // the CTA's slice, k-pair after k-pair
  unsigned char* slots;         // [stages][pair]
  unsigned char* res;           // the resident k-pairs [KR][pair]
  uint64_t* full;               // [stages]
  uint64_t* empty;              // [stages]
  uint32_t pair;                // bytes of a k-pair
  int KR, NS, D;                // resident and streamed k-pairs, stages
};

// Both bf16 h buffers [2][R][hs] zeroed (h_{-1} = 0), the resident k-pairs
// copied, and the ring's mbarriers initialised (empty: one arrival of each
// of the n_items consumer warps a use).
__device__ __forceinline__ void stream_setup(const Ring& ring,
                                             __nv_bfloat16* hbuf, int H,
                                             int R, int n_items) {
  const int per_row = H / 8, hs = H + PAD;
  for (int i = threadIdx.x; i < ring.KR * (int)(ring.pair / 16);
       i += blockDim.x)
    reinterpret_cast<uint4*>(ring.res)[i] =
        reinterpret_cast<const uint4*>(ring.src)[i];
  for (int i = threadIdx.x; i < 2 * R * per_row; i += blockDim.x)
    *reinterpret_cast<uint4*>(hbuf + (i / per_row) * hs + (i % per_row) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0)
    for (int d = 0; d < ring.D; ++d) {
      mbar_init(cta_addr(ring.full + d), 1);
      mbar_init(cta_addr(ring.empty + d), n_items);
    }
}

// The producer's stages up to (not including) `upto` of `total`: stage n is
// streamed k-pair n % NS of the slice into slot n % D, once the consumers
// have emptied the slot's previous stage n - D.
__device__ __forceinline__ void produce(const Ring& ring, int& issued,
                                        int upto, int total) {
  for (upto = min(upto, total); issued < upto; ++issued) {
    const int slot = issued % ring.D, use = issued / ring.D;
    if (use > 0) xbar_wait(cta_addr(ring.empty + slot), (use - 1) & 1);
    xbar_expect(cta_addr(ring.full + slot), ring.pair);
    bulk_from_global(cta_addr(ring.slots + (size_t)slot * ring.pair),
                     ring.src + (size_t)(ring.KR + issued % ring.NS) * ring.pair,
                     ring.pair, cta_addr(ring.full + slot));
  }
}

// acc += bf16(h_{t-1}) @ W_hh at step s for the warp's item (m16 tile mt,
// unit group g of G): the resident k-pairs, then the streamed ones as their
// slots fill; the warp releases each slot once its fragments are in
// registers. Each k-pair: k-step 2p for the four gates, then 2p + 1, so
// each accumulator takes its k-steps in order.
__device__ __forceinline__ void h_product(float (&acc)[4][4], const Ring& ring,
                                          const __nv_bfloat16* hcur, int hs,
                                          int mt, int g, int G, int s) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* ap = hcur + (mt * 16 + grp) * hs + 2 * tq;
  const int frag = g * 32 + lane;
  auto pair_mma = [&](const unsigned char* wp, int p) {
    uint32_t a[2][4];
    load_a(a[0], ap + 32 * p, hs);          // A (16x16, row-major): h_{t-1}
    load_a(a[1], ap + 32 * p + 16, hs);
    uint4 b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      b[q] = reinterpret_cast<const uint4*>(wp)[q * G * 32 + frag];
#pragma unroll
    for (int q = 0; q < 4; ++q) mma16816(acc[q], a[0], b[q].x, b[q].y);
#pragma unroll
    for (int q = 0; q < 4; ++q) mma16816(acc[q], a[1], b[q].z, b[q].w);
  };
  for (int p = 0; p < ring.KR; ++p) pair_mma(ring.res + (size_t)p * ring.pair, p);
  for (int j = 0; j < ring.NS; ++j) {
    const int n = s * ring.NS + j, slot = n % ring.D;
    xbar_wait(cta_addr(ring.full + slot), (n / ring.D) & 1);
    pair_mma(ring.slots + (size_t)slot * ring.pair, ring.KR + j);
    __syncwarp();
    if (lane == 0) mbar_arrive(cta_addr(ring.empty + slot));
  }
}

// Hand the CTA's new bf16 slice of h (rows < nrows of hnext) on to the other
// CTAs of the cluster, as lstm_scan.cu's exchange does.
__device__ __forceinline__ void exchange(cg::cluster_group& cluster,
                                         __nv_bfloat16* hnext, int hs,
                                         int col0, int U, int nrows, int C,
                                         int rank) {
  const int chunks = U / 8;
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    uint4* piece = reinterpret_cast<uint4*>(hnext + (i / chunks) * hs + col0 +
                                            8 * (i % chunks));
    const uint4 v = *piece;
    for (int p = 1; p < C; ++p)
      *cluster.map_shared_rank(piece, (rank + p) % C) = v;
  }
}

// The cell of the item's (row, unit) pairs: z = pre[q][.] + acc, c in
// registers (cr), h into hnext and, for rows < nrows, into out at step t.
template <typename OutT>
__device__ __forceinline__ void cell(const float (&acc)[4][4],
                                     const float2 (&pre)[2][4],
                                     float (&cr)[2][2], __nv_bfloat16* hnext,
                                     OutT* out, int hs, int r0, int nrows,
                                     size_t out_row0, int H, int col) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    float z[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[q][0] = pre[half][q].x + acc[q][2 * half];
      z[q][1] = pre[half][q].y + acc[q][2 * half + 1];
    }
    float hn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float c = sigmoidf_(z[1][e]) * cr[half][e] +
                      sigmoidf_(z[0][e]) * tanhf(z[2][e]);
      hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
      cr[half][e] = c;
    }
    store_pair(hnext + r * hs + col, hn[0], hn[1]);
    if (r < nrows)
      store_pair(out + (out_row0 + r) * H + col, hn[0], hn[1]);
  }
}

// ---- kernel E streamed ------------------------------------------------------

template <int K>
__global__ void __launch_bounds__((STREAM_MAX_WARPS + 1) * 32, 1)
lstm_unrolled_stream_kernel(const __grid_constant__ CUtensorMap gmap,  // gates [T, B, 4H]
                            const __nv_bfloat16* __restrict__ wf,
                            __nv_bfloat16* __restrict__ out, int T, int B,
                            int H, int R, int resident, int stages,
                            int groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, hs = H + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int G = U / 8, KP = H / 32;
  const uint32_t pair = (uint32_t)pair_bytes(U);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = cta_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  const int box = K * R * U;                  // elements of one gate's box
  __nv_bfloat16* gring = reinterpret_cast<__nv_bfloat16*>(smem);  // [groups][4][K][R][U]
  Ring ring;
  ring.src = reinterpret_cast<const unsigned char*>(wf) + (size_t)rank * KP * pair;
  ring.slots = smem + (size_t)groups * 4 * box * 2;                // [D][pair]
  ring.res = ring.slots + (size_t)stages * pair;                   // [KR][pair]
  ring.pair = pair;
  ring.KR = resident / 2;
  ring.NS = KP - ring.KR;
  ring.D = stages;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(
      ring.res + (size_t)ring.KR * pair);                          // [2][R][hs]
  ring.full = reinterpret_cast<uint64_t*>(hbuf + 2 * R * hs);      // [D]
  ring.empty = ring.full + stages;                                 // [D]
  uint64_t* gbar = ring.empty + stages;                            // [groups]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int nwarps = blockDim.x / 32 - 1;     // consumers; the last produces
  const int n_items = (nrows + 15) / 16 * G;
  const bool has_item = warp < n_items;       // item i in consumer warp i
  const int mt = warp / G, gi = warp % G, jl = 8 * gi + 2 * tq;
  const bool producer = warp == nwarps && lane == 0;

  stream_setup(ring, hbuf, H, R, n_items);
  if (threadIdx.x == 0) {
    for (int g = 0; g < groups; ++g) mbar_init(cta_addr(gbar + g), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_groups = T / K;
  const CUtensorMap* map = &gmap;
  // group g's boxes (steps gK .. gK+K-1, the cluster's rows, this CTA's
  // columns of each gate) into slot g % groups
  auto issue = [&](int g) {
    const int slot = g % groups;
    const uint32_t bar = cta_addr(gbar + slot);
    const uint32_t dst = cta_addr(gring + (size_t)slot * 4 * box);
    xbar_expect(bar, 4 * box * 2);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_3d(dst + q * box * 2, map, q * H + col0, row0, g * K, bar);
  };
  const int total = T * ring.NS, ahead = min(stages, ring.NS);
  int issued = 0;
  if (producer) {
    for (int g = 0; g < min(groups, n_groups); ++g) issue(g);
    produce(ring, issued, ahead, total);
  }
  cluster.sync();      // every CTA has started and set up its buffers

  float cr[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};   // c of the thread's pairs
  for (int s = 0; s < T; ++s) {
    const int g = s / K, kk = s % K;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;
    if (has_item) {
      if (kk == 0) xbar_wait(cta_addr(gbar + g % groups), (g / groups) & 1);
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
      h_product(acc, ring, hcur, hs, mt, gi, G, s);
      // step s's gates: gate q of row r at gcur + q * box + r * U
      const __nv_bfloat16* gcur = gring + (size_t)(g % groups) * 4 * box +
                                  kk * R * U;
      float2 pre[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pre[half][q] = r < nrows ? load_pair(gcur + q * box + r * U + jl)
                                   : make_float2(0.0f, 0.0f);
      }
      cell(acc, pre, cr, hnext, out, hs, mt * 16 + grp, nrows,
           (size_t)s * B + row0, H, col0 + jl);
    }
    // the next step's first stages, as the consumers empty this step's
    // last slots: their copies run under the exchange and the barrier
    if (producer) produce(ring, issued, (s + 1) * ring.NS + ahead, total);
    __syncwarp();
    __syncthreads();   // the CTA's slice of h_t is in hnext; gcur is read
    if (producer && kk == K - 1 && g + groups < n_groups) {
      fence_proxy_async();
      issue(g + groups);   // into the slot just read
    }
    exchange(cluster, hnext, hs, col0, U, nrows, C, rank);
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// ---- kernel F streamed ------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__((STREAM_MAX_WARPS + 1) * 32, 1)
lstm_layer_stream_kernel(const __nv_bfloat16* __restrict__ x,   // [T, B, F]
                         const uint4* __restrict__ wif,  // W_ih^T, fragment order
                         const float* __restrict__ bias,         // [4H]
                         const __nv_bfloat16* __restrict__ wf,   // W_hh^T slices
                         OutT* __restrict__ out, int T, int B, int F, int H,
                         int R, int resident, int stages, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, hs = H + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int G = U / 8, KP = H / 32;
  const int fk = (F + 15) / 16;               // the x product's k-steps
  const int fp = (F + 31) / 32;               // k-step pairs of a wif row
  const uint32_t pair = (uint32_t)pair_bytes(U);

  extern __shared__ __align__(16) unsigned char smem[];
  Ring ring;
  ring.src = reinterpret_cast<const unsigned char*>(wf) + (size_t)rank * KP * pair;
  ring.slots = smem;                                               // [D][pair]
  ring.res = smem + (size_t)stages * pair;                         // [KR][pair]
  ring.pair = pair;
  ring.KR = resident / 2;
  ring.NS = KP - ring.KR;
  ring.D = stages;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(
      ring.res + (size_t)ring.KR * pair);                          // [2][R][hs]
  ring.full = reinterpret_cast<uint64_t*>(hbuf + 2 * R * hs);      // [D]
  ring.empty = ring.full + stages;                                 // [D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int nwarps = blockDim.x / 32 - 1;     // consumers; the last produces
  const int n_items = (nrows + 15) / 16 * G;
  const bool has_item = warp < n_items;       // item i in consumer warp i
  const int mt = warp / G, gi = warp % G, jl = 8 * gi + 2 * tq;
  const int arow = mt * 16 + grp;             // the A fragments' first row
  const bool v0 = arow < nrows, v1 = arow + 8 < nrows;
  const bool producer = warp == nwarps && lane == 0;

  stream_setup(ring, hbuf, H, R, n_items);
  if (threadIdx.x == 0)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // the CTA's units of each gate are contiguous in wif: groups
  // (q*H + col0)/8 .. +G-1 of 8 rows; this lane's B fragments of gate q,
  // k-step pair p at wb + q * wqs + p * 32
  const size_t per_group = (size_t)fp * 32;             // uint4 of 8 rows
  const uint4* wb = wif + (size_t)(col0 / 8 + gi) * per_group + lane;
  const size_t wqs = (size_t)(H / 8) * per_group;
  // the cluster's rows of x at step s, into L2 (thread 0 of each CTA)
  const int dir = reverse ? -1 : 1, t0 = reverse ? T - 1 : 0;
  auto prefetch_x = [&](int s) {
    if (threadIdx.x == 0 && s < T)
      prefetch_l2(x + ((size_t)(t0 + dir * s) * B + row0) * F,
                  (size_t)nrows * F * 2);
  };

  float acc[4][4];
  float cr[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};   // c of the thread's pairs
  // acc = x_t @ W_ih for the warp's item, from zero, k-steps in order; the
  // x fragments from global memory (zero beyond B and beyond F), two pairs
  // of k-steps' loads in flight before their products
  auto x_product = [&](int t) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    const __nv_bfloat16* x0 = x + ((size_t)t * B + row0 + arow) * F;
    const __nv_bfloat16* x1 = x0 + 8 * (size_t)F;
    for (int p0 = 0; p0 < fp; p0 += 2) {
      uint4 bv[2][4];
      uint32_t a[4][4];
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (p0 + pp < fp) bv[pp][q] = __ldg(wb + q * wqs + (p0 + pp) * 32);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = (2 * p0 + kk) * 16 + 2 * tq;
        a[kk][0] = v0 && c < F ? ldg32(x0 + c) : 0u;
        a[kk][1] = v1 && c < F ? ldg32(x1 + c) : 0u;
        a[kk][2] = v0 && c + 8 < F ? ldg32(x0 + c + 8) : 0u;
        a[kk][3] = v1 && c + 8 < F ? ldg32(x1 + c + 8) : 0u;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (2 * p0 + kk < fk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4& v = bv[kk >> 1][q];
            if (kk & 1)
              mma16816(acc[q], a[kk], v.z, v.w);
            else
              mma16816(acc[q], a[kk], v.x, v.y);
          }
        }
    }
  };

  const int total = T * ring.NS, ahead = min(stages, ring.NS);
  int issued = 0;
  if (producer) produce(ring, issued, ahead, total);
  prefetch_x(0);
  prefetch_x(1);
  cluster.sync();      // every CTA has started and set up its buffers
  if (has_item) x_product(t0);

  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;

    prefetch_x(s + 2);
    if (has_item) {
      // the h k-steps continue from x_t @ W_ih, then the bias
      h_product(acc, ring, hcur, hs, mt, gi, G, s);
      float2 pre[2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bq = __ldg(reinterpret_cast<const float2*>(
            bias + q * H + col0 + jl));
        pre[0][q] = bq;
        pre[1][q] = bq;
      }
      cell(acc, pre, cr, hnext, out, hs, arow, nrows, (size_t)t * B + row0,
           H, col0 + jl);
    }
    if (producer) produce(ring, issued, (s + 1) * ring.NS + ahead, total);
    __syncwarp();
    __syncthreads();   // the CTA's slice of h_t is in hnext
    exchange(cluster, hnext, hs, col0, U, nrows, C, rank);
    // arrive (release), the next step's x product, then wait (acquire)
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    if (has_item && s + 1 < T) x_product(t + dir);
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// ---- launches -----------------------------------------------------------------

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Launch `kernel` as clusters of C CTAs over R rows each, or, with n set,
// ask for its cudaOccupancyMaxActiveClusters instead.
template <typename Kernel, typename... Args>
int run(Kernel kernel, int H, int B, int C, int R, size_t smem, void* stream,
        int* n, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n ? C : C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * stream_warps(H, C, R));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (n) return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// gates [T, B, 4H] bf16 in boxes of [K, R, U] (U columns of one gate, R
// rows, K steps), no swizzle; rows beyond B read as zero.
bool gates_map(CUtensorMap* map, const void* gates, int T, int B, int H,
               int U, int R, int K) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)4 * H, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)4 * H * 2,
                                 (cuuint64_t)B * 4 * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)U, (cuuint32_t)R, (cuuint32_t)K};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(gates), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int K>
int unrolled(const void* gates, const void* wf, void* out, int T, int B, int H,
             int C, int R, int resident, int stages, int groups, void* stream,
             int* n) {
  CUtensorMap map = {};
  if (n == nullptr && !gates_map(&map, gates, T, B, H, H / C, R, K))
    return (int)cudaErrorInvalidValue;
  return run(lstm_unrolled_stream_kernel<K>, H, B, C, R,
             unrolled_stream_smem(H, C, R, K, resident, stages, groups),
             stream, n, map, (const __nv_bfloat16*)wf, (__nv_bfloat16*)out, T,
             B, H, R, resident, stages, groups);
}

template <typename OutT>
int layer(const void* x, const void* wif, const void* wf, const void* bias,
          void* out, int T, int B, int F, int H, int reverse, int C, int R,
          int resident, int stages, void* stream, int* n) {
  return run(lstm_layer_stream_kernel<OutT>, H, B, C, R,
             layer_stream_smem(H, C, R, resident, stages), stream, n,
             (const __nv_bfloat16*)x, (const uint4*)wif, (const float*)bias,
             (const __nv_bfloat16*)wf, (OutT*)out, T, B, F, H, R, resident,
             stages, reverse);
}

}  // namespace

extern "C" {

// Kernel E streamed. gates [T, B, 4H] bf16, wf (W_hh^T's slices in fragment
// order, [cluster][H/32][4][U/8][32][8] bf16) -> out [T, B, H] bf16,
// forward, the gates arriving in groups of k = 2 or 4 steps (T % k == 0)
// through a TMA ring of `groups` groups (1 or 2), as clusters of `cluster`
// CTAs over `rows` rows each with `resident` k-steps of the slice resident
// and a ring of `stages` k-pairs; smem_bytes must be the layout's
// (ops/lstm.py unrolled_stream_smem_bytes). Bit-identical to
// lstm_scan_fwd_stream and to lstm_scan_fwd_unrolled_block.
int lstm_scan_fwd_unrolled_stream(const void* gates, const void* wf,
                                  void* out, int T, int B, int H, int k,
                                  int cluster, int rows, int resident,
                                  int stages, int groups, int smem_bytes,
                                  void* stream) {
  if ((k != 2 && k != 4) || T % k != 0 || (groups != 1 && groups != 2) ||
      !plan_fits(H, cluster, rows, resident, stages) ||
      (size_t)smem_bytes !=
          unrolled_stream_smem(H, cluster, rows, k, resident, stages, groups))
    return (int)cudaErrorInvalidValue;
  if (k == 2)
    return unrolled<2>(gates, wf, out, T, B, H, cluster, rows, resident,
                       stages, groups, stream, nullptr);
  return unrolled<4>(gates, wf, out, T, B, H, cluster, rows, resident, stages,
                     groups, stream, nullptr);
}

// Kernel F streamed. x [T, B, F] bf16 (F even), wif = W_ih^T [4H, F32] in
// fragment order (zero columns beyond F), wf as above, bias [4H] fp32 ->
// out [T, B, H] (bf16, or fp32 when out_f32), as clusters of `cluster`
// CTAs over `rows` rows with `resident` k-steps resident and a ring of
// `stages` k-pairs; smem_bytes must be the layout's (ops/lstm.py
// layer_stream_smem_bytes). Bit-identical to lstm_layer_fwd_block.
int lstm_layer_fwd_stream(const void* x, const void* wif, const void* wf,
                          const void* bias, void* out, int out_f32, int T,
                          int B, int F, int H, int reverse, int cluster,
                          int rows, int resident, int stages, int smem_bytes,
                          void* stream) {
  if (F <= 0 || F % 2 || !plan_fits(H, cluster, rows, resident, stages) ||
      (size_t)smem_bytes != layer_stream_smem(H, cluster, rows, resident,
                                              stages))
    return (int)cudaErrorInvalidValue;
  if (out_f32)
    return layer<float>(x, wif, wf, bias, out, T, B, F, H, reverse, cluster,
                        rows, resident, stages, stream, nullptr);
  return layer<__nv_bfloat16>(x, wif, wf, bias, out, T, B, F, H, reverse,
                              cluster, rows, resident, stages, stream,
                              nullptr);
}

// cudaOccupancyMaxActiveClusters of kernel E streamed (k = 2 or 4, with
// `groups` gate groups) or of kernel F streamed (k = 1, the instance
// out_f32), with `resident` k-steps resident and a ring of `stages`, for a
// cluster of `cluster` CTAs over `rows` rows at H: *n clusters can run at
// once on the current device.
int lstm_staged_stream_max_clusters(int k, int out_f32, int resident,
                                    int stages, int groups, int H,
                                    int cluster, int rows, int* n) {
  if (!plan_fits(H, cluster, rows, resident, stages))
    return (int)cudaErrorInvalidValue;
  if (k == 2 || k == 4) {
    if (groups != 1 && groups != 2) return (int)cudaErrorInvalidValue;
    return k == 2 ? unrolled<2>(nullptr, nullptr, nullptr, 0, 0, H, cluster,
                                rows, resident, stages, groups, nullptr, n)
                  : unrolled<4>(nullptr, nullptr, nullptr, 0, 0, H, cluster,
                                rows, resident, stages, groups, nullptr, n);
  }
  if (k != 1) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return layer<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                        H, 0, cluster, rows, resident, stages, nullptr, n);
  return layer<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, 0,
                              0, 0, H, 0, cluster, rows, resident, stages,
                              nullptr, n);
}

const char* lstm_staged_stream_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
