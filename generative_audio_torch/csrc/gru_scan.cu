// GRU forward scan over precomputed time-major x-side gates, for sm_90a.
//
// Replaces two Pallas TPU kernels of generative_audio_tpu/ops/pallas_lstm.py
// (:888-952 and :1127-1195):
//   * gru_scan_fwd       <- _gru_pallas_call / _gru_kernel (h starts at
//     zero), used by gru_scan_tm without grad and as GRUScan's forward;
//   * gru_scan_fwd_carry <- _gru_pallas_call_carry / _gru_carry_kernel (h0
//     in, h_T out), used by gru_layer_tm_chunked.
// Both are one template, so a chunked and an unchunked run of the same bf16
// gates give bit-identical h: every step does the same arithmetic on the
// same operands in the same order, and the carry crosses a chunk boundary as
// the fp32 h the next step would have read anyway.
//
// What it computes, per row b and step t (torch gate order r, z, n):
//   gh  = bf16(h_{t-1}) @ W_hh + b_hh              (fp32 accumulation and bias)
//   r   = sigmoid(x_r + gh_r),  z = sigmoid(x_z + gh_z)
//   n   = tanh(x_n + r * gh_n)
//   h_t = (1 - z) * n + z * h_{t-1}                (h_{t-1} in fp32)
// with x = float(gates[t, b, :]). gates [T, B, 3H] bf16 (b_ih already
// added), W_hh passed transposed as wt [3H, H] bf16 (torch's weight_hh
// layout), b_hh [3H] fp32, h [T, B, H] in bf16 or fp32. b_hh is an input
// and not part of the gates because r multiplies (h W_hn + b_hn). reverse=1
// walks t from T-1 down to 0 (an index flip; nothing is copied).
//
// What bounds it on an H100. At the sub-band serving shape (batch 8 x 10 s:
// T = 628, 2056 rows, H = 384) one layer does 2*T*rows*H*3H = 1.14 TFLOP of
// bf16 products (1.16 ms at 989 TFLOP/s) and must move T*rows*(3H + H)*2 B
// = 3.97 GB (1.18 ms at 3.35 TB/s): at the ridge, bytes slightly ahead. The
// full-band model of FullSubNet runs it at H = 512 over as many rows as the
// batch has clips (1 to 18): there only the serial chain of T dependent
// steps counts. Either way a step cannot start before the whole h of the
// step before is known, so the time is T times the latency of one step.
//
// Design: a thread-block cluster of C CTAs (8 or 16) owns R batch rows and
// splits the 3H columns of W_hh by units.
//   * CTA k of the cluster owns units [k*U, (k+1)*U), U = H/C, and with them
//     the three gate columns r, z, n of each unit, so every (row, unit)
//     update still needs nothing from another thread. Its W_hh^T slice (3U
//     rows of wt, 113 KB at H = 384, C = 8; 100 KB at H = 512, C = 16) is
//     copied into shared memory once: no step reads W_hh from L2, where the
//     single-block design streamed all of it through every block every step
//     and waited on a few hundred dependent L2 round trips per step.
//   * Every CTA keeps a bf16 copy of the whole h_{t-1} of the cluster's rows
//     in shared memory, double buffered, and its own units' h in fp32. After
//     its update it writes its new bf16 slice into its own next buffer, then
//     into the next buffer of every other CTA of the cluster (distributed
//     shared memory, 16-byte stores, to the peers rank+1, rank+2, ... in
//     turn, so that a cluster's CTAs do not all write to one peer at once),
//     and meets them at one cluster barrier (release/acquire). The barrier
//     after step s also means that every CTA has read buffer s&1 before
//     anyone writes it in step s+1, so one barrier a step is enough; the last
//     one comes before any CTA exits. This exchange, R*H*2*(C-1) bytes a
//     cluster a step, and the barrier bound a step about as much as the
//     products do at 48 rows, so clusters of 8 beat 16 at the sub-band.
//   * The x-side gates of step t+2 for the thread's own (row, unit) pairs are
//     copied (4-byte cp.async, two tiles) while steps t and t+1 run, so they
//     leave the serial chain; each thread waits only for its own copies, in
//     the shadow of the cluster barrier (between its arrive and its wait).
//   * The product is the single-block design's, element for element:
//     mma.sync m16n8k16, bf16 operands, fp32 accumulators from zero, the k
//     loop in the same order. A warp owns one m16 row tile and 8 units (one
//     warp per such item, 8 to 18 warps) and computes the n8 tiles of their
//     r, z and n columns, loading the next k-step's fragments while this
//     one's products run; the cell arithmetic is the same expression.
//     Splitting the columns changes no element's sum, so h is bit-identical
//     to the single-block kernel's.
//   * The launch plan (C, R and the shared bytes) comes from the caller
//     (ops/gru.py plan_scan, which weighs the shared bytes against
//     cudaOccupancyMaxActiveClusters, gru_scan_max_clusters below); the
//     entries refuse a plan whose bytes are not this layout's. A cluster of
//     16 is non-portable and is opted into; a launch the card refuses
//     returns its error.
//
// The streamed variant (gru_stream_kernel; entries gru_scan_fwd_stream and
// gru_scan_fwd_carry_stream) runs both where no resident cluster holds the
// slice, in place of the single block of csrc/gru_scan_block.cu (above
// H = 640: at H = 768 a CTA of 16 needs 223,488 B of slice beside 62,528 B of
// h buffers, h, gates and b_hh, over the 232,448 B a block may use). It
// replaces the same TPU kernels, generative_audio_tpu/ops/pallas_lstm.py:907
// (_gru_pallas_call) and :1151 (_gru_pallas_call_carry), there.
//   * What bounds it: the serial chain as above, plus the part of the slice
//     that does not fit, which every CTA reads again at every step from L2
//     (W_hh^T is 3.5 MB at H = 768 and 6.3 MB at H = 1024), where the single
//     block read all of it a step through each CTA in 4-byte loads.
//   * Design: lstm_scan.cu's streamed variant with three gates: the first
//     `resident` k-steps of the slice in shared memory, the others through a
//     ring of `stages` k-pair slots that one producer thread fills with
//     cp.async.bulk (completion on the slot's full mbarrier, refill after its
//     empty mbarrier), ahead into the next step while the exchange and the
//     cluster barrier run; one consumer warp an item.
//   * Numerics: the same products in the same k order from zero and the same
//     cell, so h is bit-identical to the resident cluster's and to the
//     single block's.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MIN_WARPS = 8, MAX_WARPS = 18;

// Shared bytes of one CTA for a cluster of C over R rows, in the order the
// kernel lays them out: W_hh^T slice [3U][H + PAD] bf16, h [2][R][H + PAD]
// bf16, own h [R][U] fp32, x-side gates of two steps [2][R][3U] bf16, b_hh
// slice [3U] fp32. Every region is a multiple of 16 bytes when U % 8 == 0.
size_t cluster_smem(int H, int C, int R) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (3 * U + 2 * r) * hs * 2 + r * U * 4 + 2 * r * 3 * U * 2 + 3 * U * 4;
}

// Warps of a CTA: one per (m16 row tile, group of 8 units) item, at least
// MIN_WARPS (they share the exchange's stores) and at most MAX_WARPS.
int cluster_warps(int H, int C, int R) {
  return max(MIN_WARPS, min(MAX_WARPS, (R / 16) * (H / C / 8)));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// Wait until at most `n` of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// mma.sync m16n8k16 as scan_common.cuh's, but not volatile: the compiler may
// move the next k-step's fragment loads ahead of it. The order of the
// products into one accumulator is their data dependence, so it is kept.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT, bool CARRY>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
gru_cluster_kernel(const __nv_bfloat16* __restrict__ gates,
                   const __nv_bfloat16* __restrict__ wt,
                   const float* __restrict__ bhh, const float* __restrict__ h0,
                   OutT* __restrict__ out, float* __restrict__ h_T,
                   int T, int B, int H, int R, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U3 = 3 * U, hs = H + PAD, G3 = 3 * H;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);      // [3U][hs]
  __nv_bfloat16* hbuf = ws + U3 * hs;                               // [2][R][hs]
  float* hf = reinterpret_cast<float*>(hbuf + 2 * R * hs);          // [R][U]
  __nv_bfloat16* gx = reinterpret_cast<__nv_bfloat16*>(hf + R * U); // [2][R][3U]
  float* bias = reinterpret_cast<float*>(gx + 2 * R * U3);          // [3U]
  const int nthreads = blockDim.x, nwarps = nthreads / 32;

  // W^T slice: rows q*H + col0 + u of wt (q < 3, u < U), 16-byte copies
  const int per_row = H / 8;
  for (int i = threadIdx.x; i < U3 * per_row; i += nthreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const int q = r / U, u = r % U;
    *reinterpret_cast<uint4*>(ws + r * hs + c) =
        *reinterpret_cast<const uint4*>(wt + (size_t)(q * H + col0 + u) * H + c);
  }
  for (int i = threadIdx.x; i < U3; i += nthreads)
    bias[i] = bhh[(i / U) * H + col0 + i % U];
  // h_{-1}: all units in bf16 (buffer 0; buffer 1 zeroed), own units in fp32
  for (int i = threadIdx.x; i < R * H; i += nthreads) {
    const int r = i / H, j = i % H;
    float h = 0.0f;
    if (CARRY && r < nrows) h = h0[(size_t)(row0 + r) * H + j];
    hbuf[r * hs + j] = __float2bfloat16(h);
    hbuf[(R + r) * hs + j] = __float2bfloat16(0.0f);
    if (j >= col0 && j < col0 + U) hf[r * U + j - col0] = h;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int G = U / 8, ksteps = H / 16;
  // a warp's items: (m16 row tile, group of 8 units) pairs over valid rows
  const int n_items = (nrows + 15) / 16 * G;

  // step t's x-side gates of this thread's own (row, unit) pairs, into tile
  // `buf`; one cp.async group per call, empty when t is past the end
  auto fetch_gates = [&](int t, int buf) {
    for (int i = warp; i < n_items && t >= 0 && t < T; i += nwarps) {
      const int jl = 8 * (i % G) + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (i / G) * 16 + grp + 8 * half;
        if (r >= nrows) continue;
        const __nv_bfloat16* src =
            gates + ((size_t)t * B + row0 + r) * G3 + col0 + jl;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          cp_async4(gx + (buf * R + r) * U3 + q * U + jl, src + q * H);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int dir = reverse ? -1 : 1, t0 = reverse ? T - 1 : 0;

  fetch_gates(t0, 0);
  fetch_gates(t0 + dir, 1);
  cluster.sync();      // every CTA has started and filled its buffers
  cp_async_wait<1>();  // step 0's gates (own copies)

  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;
    const __nv_bfloat16* gcur = gx + (s & 1) * R * U3;

    for (int i = warp; i < n_items; i += nwarps) {
      const int mt = i / G, g = i % G;
      float acc[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      // k-steps in pairs (H % 32 == 0), the next k-step's fragments loaded
      // while this one's products run
      const __nv_bfloat16* ap = hcur + (mt * 16 + grp) * hs + 2 * tq;
      const __nv_bfloat16* bp = ws + (8 * g + grp) * hs + 2 * tq;
      uint32_t a[2][4], b[2][3][2];
      auto load_k = [&](int k, int slot) {
        load_a(a[slot], ap + k * 16, hs);     // A (16x16, row-major): h_{t-1}
#pragma unroll
        for (int q = 0; q < 3; ++q) {         // B (16x8, col-major): W^T rows
          const __nv_bfloat16* wp = bp + q * U * hs + k * 16;
          b[slot][q][0] = *reinterpret_cast<const uint32_t*>(wp);
          b[slot][q][1] = *reinterpret_cast<const uint32_t*>(wp + 8);
        }
      };
      load_k(0, 0);
      for (int k = 0; k < ksteps; k += 2) {
        load_k(k + 1, 1);
#pragma unroll
        for (int q = 0; q < 3; ++q) mma16816(acc[q], a[0], b[0][q]);
        if (k + 2 < ksteps) load_k(k + 2, 0);
#pragma unroll
        for (int q = 0; q < 3; ++q) mma16816(acc[q], a[1], b[1][q]);
      }

      // accumulator (half, e): row 16 mt + grp + 8 half, unit jl + e
      const int jl = 8 * g + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
        const bool valid = r < nrows;
        float x[3][2], gh[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float2 gv = make_float2(0.0f, 0.0f);
          if (valid) gv = load_pair(gcur + r * U3 + q * U + jl);
          x[q][0] = gv.x;
          x[q][1] = gv.y;
          gh[q][0] = acc[q][2 * half] + bias[q * U + jl];
          gh[q][1] = acc[q][2 * half + 1] + bias[q * U + jl + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          hn[e] = (1.0f - zg) * ng + zg * hf[r * U + jl + e];
          hf[r * U + jl + e] = hn[e];
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (valid) {
          const size_t o = ((size_t)t * B + row0 + r) * H + col0 + jl;
          store_pair(out + o, hn[0], hn[1]);
          if (CARRY && s == T - 1)
            store_pair(h_T + (size_t)(row0 + r) * H + col0 + jl, hn[0], hn[1]);
        }
      }
    }
    fetch_gates(t + 2 * dir, s & 1);         // into the tile just read
    __syncthreads();                          // the CTA's slice of h_t is in hnext

    // hand the slice on to the other CTAs of the cluster: each thread reads
    // a 16-byte piece once and stores it to the peers rank+1, rank+2, ...,
    // so that the CTAs of a cluster write to different peers at a time
    const int chunks = U / 8;
    for (int i = threadIdx.x; i < nrows * chunks; i += nthreads) {
      uint4* piece = reinterpret_cast<uint4*>(hnext + (i / chunks) * hs + col0 +
                                              8 * (i % chunks));
      const uint4 v = *piece;
      for (int p = 1; p < C; ++p)
        *cluster.map_shared_rank(piece, (rank + p) % C) = v;
    }
    // arrive (release), wait for the next step's gates, then wait (acquire)
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    cp_async_wait<1>();
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

template <typename OutT, bool CARRY>
cudaError_t prepare(int H, int C, size_t smem) {
  auto kernel = gru_cluster_kernel<OutT, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool plan_fits(int H, int C, int R) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && H % 32 == 0 &&
         R > 0 && R % 16 == 0;
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <typename OutT, bool CARRY>
int launch(const void* gates, const void* wt, const void* bhh, const void* h0,
           void* out, void* h_T, int T, int B, int H, int reverse, int C,
           int R, int smem_bytes, void* stream) {
  if (!plan_fits(H, C, R) || (size_t)smem_bytes != cluster_smem(H, C, R))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<OutT, CARRY>(H, C, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * cluster_warps(H, C, R));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_cluster_kernel<OutT, CARRY>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)wt, (const float*)bhh,
                           (const float*)h0, (OutT*)out, (float*)h_T, T, B, H,
                           R, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename OutT, bool CARRY>
int max_clusters(int H, int C, int R, int* n) {
  if (!plan_fits(H, C, R)) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(H, C, R);
  cudaError_t err = prepare<OutT, CARRY>(H, C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(32 * cluster_warps(H, C, R));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, gru_cluster_kernel<OutT, CARRY>, &cfg);
}

// ---- the streamed variant: H that no resident cluster holds ---------------
//
// The same cluster, units, h exchange, gates and cell as gru_cluster_kernel;
// only the W_hh^T slice moves, as in lstm_scan.cu's streamed variant. The
// wrapper packs wt once per call in MMA fragment order, [C][H/32][3][U/8][32
// lanes][8] bf16 (ops/gru.py, ops/lstm.py _stream_weight): a k-pair of a
// CTA's slice is one contiguous piece of 192 U bytes. The first `resident`
// k-steps (an even number) are copied into shared memory once; the other
// k-pairs pass through a ring of `stages` slots, one k-pair a slot, at every
// step.

// Consumer warps of a CTA of the streamed variant at most: one (m16 tile, 8
// units) item each, so that every warp reads each ring slot once a step.
constexpr int STREAM_MAX_WARPS = 18;

// Bytes of one k-pair (32 columns) of a CTA's slice of n gates x U units.
__host__ __device__ inline size_t stream_pair_bytes(int U, int n_gates) {
  return (size_t)n_gates * U * 64;
}

// Shared bytes of one CTA of the streamed variant, in the order the kernel
// lays them out: the ring [stages][k-pair] and the resident k-pairs
// [resident / 2][k-pair] in fragment order, h [2][R][H + PAD] bf16, own h
// [R][U] fp32, x-side gates of two steps [2][R][3U] bf16, b_hh slice [3U]
// fp32, and the ring's full and empty mbarriers [2][stages]. Every region
// is a multiple of 16 bytes when U % 8 == 0.
size_t stream_smem(int H, int C, int R, int resident, int stages) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (stages + resident / 2) * stream_pair_bytes(U, 3) + 2 * r * hs * 2 +
         r * U * 4 + 2 * r * 3 * U * 2 + 3 * U * 4 + 16 * stages;
}

// Warps of a CTA of the streamed variant: one consumer warp per item (at
// least MIN_WARPS, which share the exchange's stores) and the producer.
int stream_warps(int H, int C, int R) {
  return max(MIN_WARPS, (R / 16) * (H / C / 8)) + 1;
}

template <typename OutT, bool CARRY>
__global__ void __launch_bounds__((STREAM_MAX_WARPS + 1) * 32, 1)
gru_stream_kernel(const __nv_bfloat16* __restrict__ gates,
                  const __nv_bfloat16* __restrict__ wf,
                  const float* __restrict__ bhh, const float* __restrict__ h0,
                  OutT* __restrict__ out, float* __restrict__ h_T,
                  int T, int B, int H, int R, int resident, int stages,
                  int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U3 = 3 * U, hs = H + PAD, G3 = 3 * H;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int G = U / 8, KP = H / 32, KR = resident / 2, NS = KP - KR;
  const int D = stages;
  const uint32_t pair = (uint32_t)stream_pair_bytes(U, 3);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                   // [D][pair]
  unsigned char* wres = ring + (size_t)D * pair;                // [KR][pair]
  __nv_bfloat16* hbuf =
      reinterpret_cast<__nv_bfloat16*>(wres + (size_t)KR * pair);  // [2][R][hs]
  float* hf = reinterpret_cast<float*>(hbuf + 2 * R * hs);          // [R][U]
  __nv_bfloat16* gx = reinterpret_cast<__nv_bfloat16*>(hf + R * U); // [2][R][3U]
  float* bias = reinterpret_cast<float*>(gx + 2 * R * U3);          // [3U]
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + U3);          // [D]
  uint64_t* empty = full + D;                                       // [D]
  // the last warp is the producer; the others are consumers
  const int nthreads = blockDim.x, nwarps = nthreads / 32 - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  // items: (m16 row tile, group of 8 units) pairs over valid rows, item i in
  // consumer warp i
  const int n_items = (nrows + 15) / 16 * G;

  // this CTA's slice, k-pair after k-pair; the resident k-pairs, 16-byte copies
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(wf) + (size_t)rank * KP * pair;
  for (int i = threadIdx.x; i < KR * (int)(pair / 16); i += nthreads)
    reinterpret_cast<uint4*>(wres)[i] = reinterpret_cast<const uint4*>(wsrc)[i];
  for (int i = threadIdx.x; i < U3; i += nthreads)
    bias[i] = bhh[(i / U) * H + col0 + i % U];
  // h_{-1}: all units in bf16 (buffer 0; buffer 1 zeroed), own units in fp32
  for (int i = threadIdx.x; i < R * H; i += nthreads) {
    const int r = i / H, j = i % H;
    float h = 0.0f;
    if (CARRY && r < nrows) h = h0[(size_t)(row0 + r) * H + j];
    hbuf[r * hs + j] = __float2bfloat16(h);
    hbuf[(R + r) * hs + j] = __float2bfloat16(0.0f);
    if (j >= col0 && j < col0 + U) hf[r * U + j - col0] = h;
  }
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      mbar_init(cta_addr(full + d), 1);
      mbar_init(cta_addr(empty + d), n_items);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer: stage n (n < T * NS) is k-pair KR + n % NS of the slice
  // into slot n % D, once the consumers have emptied the slot's previous
  // stage n - D
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

  // step t's x-side gates of this thread's own (row, unit) pairs, into tile
  // `buf`; one cp.async group per call, empty when t is past the end
  auto fetch_gates = [&](int t, int buf) {
    for (int i = warp; i < n_items && t >= 0 && t < T; i += nwarps) {
      const int jl = 8 * (i % G) + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (i / G) * 16 + grp + 8 * half;
        if (r >= nrows) continue;
        const __nv_bfloat16* src =
            gates + ((size_t)t * B + row0 + r) * G3 + col0 + jl;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          cp_async4(gx + (buf * R + r) * U3 + q * U + jl, src + q * H);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int dir = reverse ? -1 : 1, t0 = reverse ? T - 1 : 0;

  fetch_gates(t0, 0);
  fetch_gates(t0 + dir, 1);
  cluster.sync();      // every CTA has started and filled its buffers
  cp_async_wait<1>();  // step 0's gates (own copies)

  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * R * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * R * hs;
    const __nv_bfloat16* gcur = gx + (s & 1) * R * U3;

    if (warp < n_items) {
      const int mt = warp / G, g = warp % G;
      float acc[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      // the products of k-pair p, whose fragments lie at wp: k-step 2p for
      // the three gates, then k-step 2p + 1, each accumulator in k order
      const __nv_bfloat16* ap = hcur + (mt * 16 + grp) * hs + 2 * tq;
      const int frag = g * 32 + lane;
      auto pair_mma = [&](const unsigned char* wp, int p) {
        uint32_t a[2][4];
        load_a(a[0], ap + 32 * p, hs);        // A (16x16, row-major): h_{t-1}
        load_a(a[1], ap + 32 * p + 16, hs);
        uint4 b[3];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          b[q] = reinterpret_cast<const uint4*>(wp)[q * G * 32 + frag];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint32_t b0[2] = {b[q].x, b[q].y};
          mma16816(acc[q], a[0], b0);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint32_t b1[2] = {b[q].z, b[q].w};
          mma16816(acc[q], a[1], b1);
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

      // accumulator (half, e): row 16 mt + grp + 8 half, unit jl + e
      const int jl = 8 * g + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
        const bool valid = r < nrows;
        float x[3][2], gh[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float2 gv = make_float2(0.0f, 0.0f);
          if (valid) gv = load_pair(gcur + r * U3 + q * U + jl);
          x[q][0] = gv.x;
          x[q][1] = gv.y;
          gh[q][0] = acc[q][2 * half] + bias[q * U + jl];
          gh[q][1] = acc[q][2 * half + 1] + bias[q * U + jl + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          hn[e] = (1.0f - zg) * ng + zg * hf[r * U + jl + e];
          hf[r * U + jl + e] = hn[e];
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (valid) {
          const size_t o = ((size_t)t * B + row0 + r) * H + col0 + jl;
          store_pair(out + o, hn[0], hn[1]);
          if (CARRY && s == T - 1)
            store_pair(h_T + (size_t)(row0 + r) * H + col0 + jl, hn[0], hn[1]);
        }
      }
    }
    // the next step's first stages, as the consumers empty this step's last
    // slots: their copies run under the exchange and the cluster barrier
    if (producer) produce((s + 1) * NS + ahead);
    __syncwarp();
    fetch_gates(t + 2 * dir, s & 1);         // into the tile just read
    __syncthreads();                          // the CTA's slice of h_t is in hnext

    // hand the slice on to the other CTAs of the cluster, as
    // gru_cluster_kernel does
    const int chunks = U / 8;
    for (int i = threadIdx.x; i < nrows * chunks; i += nthreads) {
      uint4* piece = reinterpret_cast<uint4*>(hnext + (i / chunks) * hs + col0 +
                                              8 * (i % chunks));
      const uint4 v = *piece;
      for (int p = 1; p < C; ++p)
        *cluster.map_shared_rank(piece, (rank + p) % C) = v;
    }
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    cp_async_wait<1>();
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

template <typename OutT, bool CARRY>
cudaError_t prepare_stream(int C, size_t smem) {
  auto kernel = gru_stream_kernel<OutT, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool stream_plan_fits(int H, int C, int R, int resident, int stages) {
  return plan_fits(H, C, R) &&
         (R / 16) * (H / C / 8) <= STREAM_MAX_WARPS && resident >= 0 &&
         resident % 2 == 0 && resident < H / 16 && stages >= 1;
}

template <typename OutT, bool CARRY>
int launch_stream(const void* gates, const void* wf, const void* bhh,
                  const void* h0, void* out, void* h_T, int T, int B, int H,
                  int reverse, int C, int R, int resident, int stages,
                  int smem_bytes, void* stream) {
  if (!stream_plan_fits(H, C, R, resident, stages) ||
      (size_t)smem_bytes != stream_smem(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_stream<OutT, CARRY>(C, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * stream_warps(H, C, R));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_stream_kernel<OutT, CARRY>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)wf, (const float*)bhh,
                           (const float*)h0, (OutT*)out, (float*)h_T, T, B, H,
                           R, resident, stages, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename OutT, bool CARRY>
int max_stream_clusters(int H, int C, int R, int resident, int stages,
                        int* n) {
  if (!stream_plan_fits(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(H, C, R, resident, stages);
  cudaError_t err = prepare_stream<OutT, CARRY>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(32 * stream_warps(H, C, R));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, gru_stream_kernel<OutT, CARRY>, &cfg);
}

}  // namespace

extern "C" {

// gates [T, B, 3H] bf16, wt [3H, H] bf16, bhh [3H] fp32 -> out [T, B, H]
// (bf16, or fp32 when out_f32), as clusters of `cluster` CTAs (8 or 16, H a
// multiple of 8 * cluster) over `rows` batch rows each (a multiple of 16);
// smem_bytes must be the layout's (ops/gru.py scan_smem_bytes).
int gru_scan_fwd(const void* gates, const void* wt, const void* bhh,
                 void* out, int out_f32, int T, int B, int H, int reverse,
                 int cluster, int rows, int smem_bytes, void* stream) {
  if (out_f32)
    return launch<float, false>(gates, wt, bhh, nullptr, out, nullptr, T, B,
                                H, reverse, cluster, rows, smem_bytes, stream);
  return launch<__nv_bfloat16, false>(gates, wt, bhh, nullptr, out, nullptr,
                                      T, B, H, reverse, cluster, rows,
                                      smem_bytes, stream);
}

// As gru_scan_fwd, plus h0 [B, H] fp32 in and h_T [B, H] fp32 out (the
// state after the last processed step).
int gru_scan_fwd_carry(const void* gates, const void* wt, const void* bhh,
                       const void* h0, void* out, void* h_T, int out_f32,
                       int T, int B, int H, int reverse, int cluster,
                       int rows, int smem_bytes, void* stream) {
  if (out_f32)
    return launch<float, true>(gates, wt, bhh, h0, out, h_T, T, B, H,
                               reverse, cluster, rows, smem_bytes, stream);
  return launch<__nv_bfloat16, true>(gates, wt, bhh, h0, out, h_T, T, B, H,
                                     reverse, cluster, rows, smem_bytes,
                                     stream);
}

// cudaOccupancyMaxActiveClusters of the instance (out_f32, carry) for a
// cluster of `cluster` CTAs over `rows` rows at H: *n clusters can run at
// once on the current device.
int gru_scan_max_clusters(int out_f32, int carry, int H, int cluster,
                          int rows, int* n) {
  if (out_f32)
    return carry ? max_clusters<float, true>(H, cluster, rows, n)
                 : max_clusters<float, false>(H, cluster, rows, n);
  return carry ? max_clusters<__nv_bfloat16, true>(H, cluster, rows, n)
               : max_clusters<__nv_bfloat16, false>(H, cluster, rows, n);
}

// The streamed variant: the same arguments, with wt replaced by wf, the
// W_hh^T slices packed in fragment order ([cluster][H/32][3][U/8][32][8]
// bf16), and a plan that adds the resident k-steps (even, fewer than H/16)
// and the ring's stages (two k-steps each); smem_bytes must be the layout's
// (ops/gru.py stream_smem_bytes), and rows / 16 x H / cluster / 8 at most 18.
int gru_scan_fwd_stream(const void* gates, const void* wf, const void* bhh,
                        void* out, int out_f32, int T, int B, int H,
                        int reverse, int cluster, int rows, int resident,
                        int stages, int smem_bytes, void* stream) {
  if (out_f32)
    return launch_stream<float, false>(gates, wf, bhh, nullptr, out, nullptr,
                                       T, B, H, reverse, cluster, rows,
                                       resident, stages, smem_bytes, stream);
  return launch_stream<__nv_bfloat16, false>(
      gates, wf, bhh, nullptr, out, nullptr, T, B, H, reverse, cluster, rows,
      resident, stages, smem_bytes, stream);
}

int gru_scan_fwd_carry_stream(const void* gates, const void* wf,
                              const void* bhh, const void* h0, void* out,
                              void* h_T, int out_f32, int T, int B, int H,
                              int reverse, int cluster, int rows, int resident,
                              int stages, int smem_bytes, void* stream) {
  if (out_f32)
    return launch_stream<float, true>(gates, wf, bhh, h0, out, h_T, T, B, H,
                                      reverse, cluster, rows, resident,
                                      stages, smem_bytes, stream);
  return launch_stream<__nv_bfloat16, true>(
      gates, wf, bhh, h0, out, h_T, T, B, H, reverse, cluster, rows, resident,
      stages, smem_bytes, stream);
}

// cudaOccupancyMaxActiveClusters of the streamed instance (out_f32, carry)
// with `resident` k-steps resident and a ring of `stages`, for a cluster of
// `cluster` CTAs over `rows` rows at H.
int gru_scan_stream_max_clusters(int out_f32, int carry, int resident,
                                 int stages, int H, int cluster, int rows,
                                 int* n) {
  if (out_f32)
    return carry ? max_stream_clusters<float, true>(H, cluster, rows,
                                                    resident, stages, n)
                 : max_stream_clusters<float, false>(H, cluster, rows,
                                                     resident, stages, n);
  return carry ? max_stream_clusters<__nv_bfloat16, true>(
                     H, cluster, rows, resident, stages, n)
               : max_stream_clusters<__nv_bfloat16, false>(
                     H, cluster, rows, resident, stages, n);
}

const char* gru_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
