// LSTM forward scans that stage their inputs on chip, as thread-block
// clusters, for sm_90a.
//
// Replaces two Pallas TPU kernels:
//   * kernel E (lstm_scan_fwd_unrolled) <- lstm_unrolled / _unroll_kernel of
//     scripts/perf_lstm_unroll.py: kernel A of lstm_scan.cu (bf16 out,
//     forward) whose x-side gates arrive K steps at a time, as the script's
//     grid step runs K steps from one [K, block_b, 4H] tile;
//   * kernel F (lstm_layer_fwd) <- _lstm_layer_pallas_call /
//     _lstm_layer_kernel of generative_audio_tpu/ops/pallas_lstm.py: the
//     LSTM layer with x_t @ W_ih computed inside the scan, so the
//     [T, B, 4H] gates never exist. Used by lstm_layer_tm without grad.
// Both reuse lstm_scan.cu's cluster design (its products, cell update and
// h exchange, operation for operation) but live in a source of their own:
// folding K and the projection into lstm_scan.cu's template moved the
// registers of kernels A-C.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (kernel E)
//   z   = x_t @ W_ih + bf16(h_{t-1}) @ W_hh + bias       (kernel F)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// with bf16 operands and fp32 accumulation: kernel F sums x_t @ W_ih's
// k-steps from zero, then h's k-steps into the same accumulators, then adds
// the fp32 bias. gates [T, B, 4H] bf16; x [T, B, F] bf16 (F even); W_ih
// passed as wif, W_ih^T [4H, F32] (F32 = F rounded up to 32, zero columns)
// in MMA fragment order (ops/lstm.py _fragment_rows); W_hh as wt [4H, H]
// bf16; bias [4H] fp32; h [T, B, H] in bf16 (or fp32 for kernel F).
//
// What bounds it on an H100. Kernel E does kernel A's work: at T = 628,
// 2304 rows, H = 384, 1.71 TFLOP of bf16 products (1.73 ms at 989 TFLOP/s)
// against 5.6 GB of gates in and h out (1.66 ms at 3.35 TB/s). Kernel F
// moves only x and h, T*rows*(F + H)*2 B, but adds 2*T*rows*F*4H of
// products: at FullSubNet+'s sub-band layers (T = 628, 2056 rows) 1.66
// TFLOP for F = 34 and 3.05 TFLOP for F = 384, bound by operations (1.68
// and 3.08 ms). As for kernel A, the serial chain of T steps is what the
// design pays: its first design (16-row blocks, W_hh and W_ih re-read from
// L2 every step, csrc/lstm_layer_block.cu) took 62 and 140 us a step.
//
// Design: lstm_scan.cu's. A cluster of C CTAs (8 or 16) owns R batch rows;
// CTA k owns units [k*U, (k+1)*U), U = H/C, and their four gate columns; its
// W_hh^T slice stays in shared memory for the whole scan, every CTA keeps a
// bf16 copy of the cluster's h_{t-1} (double buffered) and hands its new
// slice to the peers through distributed shared memory (16-byte stores),
// with one cluster barrier a step. The product and the cell are kernel A's
// element for element, so h is bit-identical to kernel A's (E) and to the
// first design of kernel F (F). What each adds:
//   * Kernel E: the x-side gates of K steps come by TMA. One tensor map over
//     gates [T, B, 4H] with a box of [K, R, U]: four copies a group (one a
//     gate, rows beyond B arrive as zeros), issued by one thread into a ring
//     of two groups, each completing on an mbarrier that every thread waits
//     on once per K steps. A group's slot is refilled (group g + 2) as soon
//     as the CTA has read it, so the copies run K to 2K steps ahead, off the
//     serial chain. c lives in shared memory as in kernel A. (Kernel A's
//     own gates come by 4-byte cp.async of each thread's pairs, two steps
//     ahead.)
//   * Kernel F: x_{t+1} @ W_ih depends on no h, so it leaves the serial
//     chain: after the step's exchange each warp arrives at the cluster
//     barrier, computes the x product of the next step for its (m16 row
//     tile, 8 units) item into fp32 accumulators from zero, and only then
//     waits; the next step's h product continues from those accumulators.
//     Each warp owns one item (at most MAX_WARPS items a CTA), so the
//     accumulators and c stay in its registers. The x fragments come from
//     global memory, where one bulk prefetch a CTA has brought the
//     cluster's rows of x into L2 two steps ahead (from device memory each
//     round of x loads waited about 2 us a step, the first sweep of
//     scripts/perf_staged_scan.py); W_ih^T's slice of the CTA's columns comes
//     from L2 in fragment order (each lane's B fragments of two k-steps in
//     16 contiguous bytes).
//   * The launch plan (C, R and the shared bytes) comes from the
//     caller (ops/lstm.py plan_unrolled and plan_layer, through
//     plan_cluster_scan, which weigh the shared bytes against
//     lstm_scan_staged_max_clusters below and a step model fitted on the
//     card); the entries refuse a plan whose bytes are not the layout's. H
//     must be a multiple of 8 * C (the wrappers pad it with zero units).
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_WARPS = 8, MAX_WARPS = 18;

// Shared bytes of one CTA of kernel E for a cluster of C over R rows with K
// steps a group, in the order the kernel lays them out: the gates ring
// [2][4][K][R][U] bf16 (128-byte aligned: 128 bytes of slack), the W_hh^T
// slice [4U][H + PAD] and two bf16 h buffers [R][H + PAD], the CTA's fp32
// c [R][U] and the ring's two mbarriers.
size_t unrolled_smem(int H, int C, int R, int K) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return 2 * 4 * (size_t)K * r * U * 2 + (4 * U + 2 * r) * hs * 2 +
         r * U * 4 + 16 + 128;
}

// Shared bytes of one CTA of kernel F: the W_hh^T slice [4U][H + PAD] and
// two bf16 h buffers [R][H + PAD].
size_t layer_smem(int H, int C, int R) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (4 * U + 2 * r) * hs * 2;
}

// Warps of a CTA: one per (m16 row tile, group of 8 units) item, at least
// MIN_WARPS (they share the exchange's stores) and at most MAX_WARPS.
int cluster_warps(int H, int C, int R) {
  return max(MIN_WARPS, min(MAX_WARPS, (R / 16) * (H / C / 8)));
}

// C of 8 or 16 splits H into groups of 8 units (H % 32 == 0: the h product
// takes k-steps in pairs); R is whole m16 tiles. Kernel F gives each item a
// warp of its own.
bool plan_fits(int H, int C, int R, bool one_item_a_warp) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && H % 32 == 0 &&
         R > 0 && R % 16 == 0 &&
         (!one_item_a_warp || (R / 16) * (H / C / 8) <= MAX_WARPS);
}

// mma.sync m16n8k16 as scan_common.cuh's, but not volatile (lstm_scan.cu's):
// the compiler may move the next k-step's fragment loads ahead of it.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte-aligned bytes of [p, p + bytes) into L2 (one bulk prefetch;
// the few bytes outside the aligned range are left to the loads).
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

// The cluster's common part: the CTA's W_hh^T slice (rows q*H + col0 + u of
// wt, q < 4, u < U) into ws [4U][hs] with 16-byte copies, and both bf16 h
// buffers [2][R][hs] zeroed (h_{-1} = 0).
__device__ __forceinline__ void load_slice(__nv_bfloat16* ws,
                                           __nv_bfloat16* hbuf,
                                           const __nv_bfloat16* wt, int H,
                                           int U, int R, int col0) {
  const int hs = H + PAD, per_row = H / 8;
  for (int i = threadIdx.x; i < 4 * U * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const int q = r / U, u = r % U;
    *reinterpret_cast<uint4*>(ws + r * hs + c) =
        *reinterpret_cast<const uint4*>(wt + (size_t)(q * H + col0 + u) * H + c);
  }
  for (int i = threadIdx.x; i < 2 * R * per_row; i += blockDim.x)
    *reinterpret_cast<uint4*>(hbuf + (i / per_row) * hs + (i % per_row) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// acc += bf16(h_{t-1}) @ W_hh for the item (m16 tile mt, unit group g):
// kernel A's product, k-steps in pairs, the next k-step's fragments loaded
// while this one's products run.
__device__ __forceinline__ void h_product(float (&acc)[4][4],
                                          const __nv_bfloat16* hcur,
                                          const __nv_bfloat16* ws, int hs,
                                          int U, int mt, int g, int ksteps) {
  const int lane = threadIdx.x & 31, grp = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* ap = hcur + (mt * 16 + grp) * hs + 2 * tq;
  const __nv_bfloat16* bp = ws + (8 * g + grp) * hs + 2 * tq;
  uint32_t a[2][4], b[2][4][2];
  auto load_k = [&](int k, int slot) {
    load_a(a[slot], ap + k * 16, hs);     // A (16x16, row-major): h_{t-1}
#pragma unroll
    for (int q = 0; q < 4; ++q) {         // B (16x8, col-major): W^T rows
      const __nv_bfloat16* wp = bp + q * U * hs + k * 16;
      b[slot][q][0] = *reinterpret_cast<const uint32_t*>(wp);
      b[slot][q][1] = *reinterpret_cast<const uint32_t*>(wp + 8);
    }
  };
  load_k(0, 0);
  for (int k = 0; k < ksteps; k += 2) {
    load_k(k + 1, 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) mma16816(acc[q], a[0], b[0][q][0], b[0][q][1]);
    if (k + 2 < ksteps) load_k(k + 2, 0);
#pragma unroll
    for (int q = 0; q < 4; ++q) mma16816(acc[q], a[1], b[1][q][0], b[1][q][1]);
  }
}

// Hand the CTA's new bf16 slice of h (rows < nrows of hnext) on to the other
// CTAs of the cluster: each thread reads a 16-byte piece once and stores it
// to the peers rank+1, rank+2, ..., so that the CTAs of a cluster write to
// different peers at a time (lstm_scan.cu's exchange).
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

// ---- kernel E ---------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
lstm_unrolled_kernel(const __grid_constant__ CUtensorMap gmap,  // gates [T, B, 4H]
                     const __nv_bfloat16* __restrict__ wt,
                     __nv_bfloat16* __restrict__ out, int T, int B, int H,
                     int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, hs = H + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = cta_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  const int box = K * R * U;                  // elements of one gate's box
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][4][K][R][U]
  __nv_bfloat16* ws = ring + 2 * 4 * box;                          // [4U][hs]
  __nv_bfloat16* hbuf = ws + 4 * U * hs;                           // [2][R][hs]
  float* cf = reinterpret_cast<float*>(hbuf + 2 * R * hs);         // [R][U]
  const uint32_t bar0 = cta_addr(cf + R * U);                      // [2] mbarriers

  load_slice(ws, hbuf, wt, H, U, R, col0);
  for (int i = threadIdx.x; i < R * U; i += blockDim.x) cf[i] = 0.0f;
  if (threadIdx.x == 0) {
    xbar_init(bar0);
    xbar_init(bar0 + 8);
  }

  const int groups = T / K;
  const CUtensorMap* map = &gmap;
  // group g's boxes (steps gK .. gK+K-1, the cluster's rows, this CTA's
  // columns of each gate) into slot g & 1, by thread 0
  auto issue = [&](int g) {
    const uint32_t bar = bar0 + 8 * (g & 1);
    const uint32_t dst = cta_addr(ring + (g & 1) * 4 * box);
    xbar_expect(bar, 4 * box * 2);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tma_load_3d(dst + q * box * 2, map, q * H + col0, row0, g * K, bar);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int G = U / 8, ksteps = H / 16;
  const int n_items = (nrows + 15) / 16 * G;
  const int nwarps = blockDim.x / 32;

  cluster.sync();      // every CTA has started; the barriers are initialised
  if (threadIdx.x == 0) {
    issue(0);
    if (groups > 1) issue(1);
  }

  for (int s = 0; s < T; ++s) {
    const int g = s / K, kk = s % K;
    if (kk == 0) xbar_wait(bar0 + 8 * (g & 1), (g >> 1) & 1);
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;
    // step s's gates: gate q of row r at gcur + q * box + r * U
    const __nv_bfloat16* gcur = ring + (g & 1) * 4 * box + kk * R * U;

    for (int i = warp; i < n_items; i += nwarps) {
      const int mt = i / G, gi = i % G;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
      h_product(acc, hcur, ws, hs, U, mt, gi, ksteps);

      // accumulator (half, e): row 16 mt + grp + 8 half, unit jl + e
      const int jl = 8 * gi + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
        const bool valid = r < nrows;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 gv = make_float2(0.0f, 0.0f);
          if (valid) gv = load_pair(gcur + q * box + r * U + jl);
          z[q][0] = gv.x + acc[q][2 * half];
          z[q][1] = gv.y + acc[q][2 * half + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cf[r * U + jl + e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cf[r * U + jl + e] = c;
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (valid)
          store_pair(out + ((size_t)s * B + row0 + r) * H + col0 + jl, hn[0],
                     hn[1]);
      }
    }
    __syncthreads();   // the CTA's slice of h_t is in hnext; gcur is read
    if (kk == K - 1 && g + 2 < groups && threadIdx.x == 0) {
      fence_proxy_async();
      issue(g + 2);    // into the slot just read
    }
    exchange(cluster, hnext, hs, col0, U, nrows, C, rank);
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// ---- kernel F ---------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
lstm_layer_cluster_kernel(const __nv_bfloat16* __restrict__ x,   // [T, B, F]
                          const uint4* __restrict__ wif,  // W_ih^T, fragment order
                          const float* __restrict__ bias,         // [4H]
                          const __nv_bfloat16* __restrict__ wt,   // [4H, H]
                          OutT* __restrict__ out, int T, int B, int F, int H,
                          int R, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, hs = H + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int fk = (F + 15) / 16;               // the x product's k-steps
  const int fp = (F + 31) / 32;               // k-step pairs of a wif row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);     // [4U][hs]
  __nv_bfloat16* hbuf = ws + 4 * U * hs;                           // [2][R][hs]

  load_slice(ws, hbuf, wt, H, U, R, col0);
  const int G = U / 8;
  // the CTA's units of each gate are contiguous in wif: groups
  // (q*H + col0)/8 .. +G-1 of 8 rows
  const size_t per_group = (size_t)fp * 32;             // uint4 of 8 rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int n_items = (nrows + 15) / 16 * G;
  const bool has_item = warp < n_items;       // one item a warp
  const int mt = warp / G, gi = warp % G, jl = 8 * gi + 2 * tq;
  const int arow = mt * 16 + grp;             // the A fragments' first row
  const bool v0 = arow < nrows, v1 = arow + 8 < nrows;
  // this lane's B fragments of gate q, k-step pair p: wb + q * wqs + p * 32
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
          if (p0 + pp < fp) {
            const uint4* src = wb + q * wqs + (p0 + pp) * 32;
            bv[pp][q] = __ldg(src);
          }
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

  prefetch_x(0);
  prefetch_x(1);
  cluster.sync();      // every CTA has started and filled its slices
  if (has_item) x_product(t0);

  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;

    prefetch_x(s + 2);
    if (has_item) {
      // the h k-steps continue from x_t @ W_ih, then the bias
      h_product(acc, hcur, ws, hs, U, mt, gi, H / 16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = arow + 8 * half;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 bq = __ldg(reinterpret_cast<const float2*>(
              bias + q * H + col0 + jl));
          z[q][0] = bq.x + acc[q][2 * half];
          z[q][1] = bq.y + acc[q][2 * half + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cr[half][e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cr[half][e] = c;
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (r < nrows)
          store_pair(out + ((size_t)t * B + row0 + r) * H + col0 + jl, hn[0],
                     hn[1]);
      }
    }
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

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Launch `kernel` as clusters of C CTAs over R rows each, or, with n set,
// ask for its cudaOccupancyMaxActiveClusters instead.
template <typename Kernel, typename... Args>
int run(Kernel kernel, int H, int B, int C, int R, size_t smem, void* stream,
        int* n, Args... args) {
  cudaError_t err = prepare(kernel, C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n ? C : C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * cluster_warps(H, C, R));
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
// query, so the library links no libcuda (as gru_scan_bwd.cu).
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
int unrolled(const void* gates, const void* wt, void* out, int T, int B, int H,
             int C, int R, void* stream, int* n) {
  CUtensorMap map = {};
  if (n == nullptr && !gates_map(&map, gates, T, B, H, H / C, R, K))
    return (int)cudaErrorInvalidValue;
  return run(lstm_unrolled_kernel<K>, H, B, C, R, unrolled_smem(H, C, R, K),
             stream, n, map, (const __nv_bfloat16*)wt, (__nv_bfloat16*)out, T,
             B, H, R);
}

template <typename OutT>
int layer(const void* x, const void* wif, const void* wt, const void* bias,
          void* out, int T, int B, int F, int H, int reverse, int C, int R,
          void* stream, int* n) {
  return run(lstm_layer_cluster_kernel<OutT>, H, B, C, R, layer_smem(H, C, R),
             stream, n,
             (const __nv_bfloat16*)x, (const uint4*)wif, (const float*)bias,
             (const __nv_bfloat16*)wt, (OutT*)out, T, B, F, H, R, reverse);
}

// Kernel E (k = 2 or 4) or, with k = 1, kernel F in the instance out_f32:
// launch, or with n set the occupancy query.
int dispatch(int k, int out_f32, const void* a, const void* wif,
             const void* wt, const void* bias, void* out, int T, int B, int F,
             int H, int reverse, int C, int R, void* stream, int* n) {
  if (k == 2) return unrolled<2>(a, wt, out, T, B, H, C, R, stream, n);
  if (k == 4) return unrolled<4>(a, wt, out, T, B, H, C, R, stream, n);
  if (k != 1) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return layer<float>(a, wif, wt, bias, out, T, B, F, H, reverse, C, R,
                        stream, n);
  return layer<__nv_bfloat16>(a, wif, wt, bias, out, T, B, F, H, reverse, C,
                              R, stream, n);
}

}  // namespace

extern "C" {

// Kernel E. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out [T, B, H] bf16,
// forward, the gates arriving in groups of k = 2 or 4 steps (T % k == 0),
// as clusters of `cluster` CTAs (8 or 16, H a multiple of 8 * cluster) over
// `rows` batch rows each (a multiple of 16); smem_bytes must be the
// layout's (ops/lstm.py unrolled_smem_bytes). Bit-identical to kernel A.
int lstm_scan_fwd_unrolled(const void* gates, const void* wt, void* out,
                           int T, int B, int H, int k, int cluster, int rows,
                           int smem_bytes, void* stream) {
  if ((k != 2 && k != 4) || T % k != 0 || !plan_fits(H, cluster, rows, false) ||
      (size_t)smem_bytes != unrolled_smem(H, cluster, rows, k))
    return (int)cudaErrorInvalidValue;
  return dispatch(k, 0, gates, nullptr, wt, nullptr, out, T, B, 0, H, 0,
                  cluster, rows, stream, nullptr);
}

// Kernel F. x [T, B, F] bf16 (F even), wif = W_ih^T [4H, F32] in fragment
// order (zero columns beyond F), wt [4H, H] bf16, bias [4H] fp32 -> out
// [T, B, H] (bf16, or fp32 when out_f32), as clusters of `cluster` CTAs over
// `rows` rows, one (m16 tile, 8 units) item a warp; smem_bytes must be the
// layout's (ops/lstm.py layer_smem_bytes).
int lstm_layer_fwd(const void* x, const void* wif, const void* wt,
                   const void* bias, void* out, int out_f32, int T, int B,
                   int F, int H, int reverse, int cluster, int rows,
                   int smem_bytes, void* stream) {
  if (F <= 0 || F % 2 || !plan_fits(H, cluster, rows, true) ||
      (size_t)smem_bytes != layer_smem(H, cluster, rows))
    return (int)cudaErrorInvalidValue;
  return dispatch(1, out_f32, x, wif, wt, bias, out, T, B, F, H,
                  reverse, cluster, rows, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of kernel E (k = 2 or 4) or of kernel F
// (k = 1) in the instance out_f32, for a cluster of `cluster` CTAs over
// `rows` rows at H: *n clusters can run at once on the current device.
int lstm_scan_staged_max_clusters(int k, int out_f32, int H, int cluster,
                                  int rows, int* n) {
  if (!plan_fits(H, cluster, rows, k == 1)) return (int)cudaErrorInvalidValue;
  return dispatch(k, out_f32, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 0, 0, 0, H, 0, cluster, rows, nullptr, n);
}

const char* lstm_scan_staged_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
