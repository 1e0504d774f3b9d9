// LSTM forward scan over precomputed time-major gates, for sm_90a.
//
// Replaces three Pallas TPU kernels of generative_audio_tpu/ops/pallas_lstm.py:
//   * kernel A (lstm_scan_fwd)       <- _lstm_pallas_call / _lstm_kernel
//     (h and c start at zero), used by lstm_scan_tm without grad;
//   * kernel B (lstm_scan_fwd_carry) <- _lstm_pallas_call_carry /
//     _lstm_carry_kernel (h0, c0 in; h_T, c_T out), used by
//     lstm_layer_tm_chunked;
//   * kernel C (lstm_scan_fwd_train) <- _lstm_pallas_call_train /
//     _lstm_train_kernel (kernel A that also writes the c sequence, rounded
//     to bf16: the residual the backward scan needs), used by LSTMScan.
// All are one template, so a chunked run, an unchunked run and a training
// run of the same bf16 gates give bit-identical h: every step does the same
// arithmetic on the same operands in the same order, and the carry crosses
// a chunk boundary as the fp32 h and c the next step would have read anyway.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// gates [T, B, 4H] bf16, W_hh passed transposed as wt [4H, H] bf16 (torch's
// weight_hh layout), h [T, B, H] in bf16 or fp32. reverse=1 walks t from
// T-1 down to 0 (an index flip; nothing is copied).
//
// What bounds it on an H100. At the serving shape (batch 8 x 10 s: T = 628,
// 2056 rows, H = 384) one layer does 2*T*rows*H*4H = 1.52 TFLOP of bf16
// products and must move T*rows*(4H + H)*2 B = 4.96 GB (gates in, h out).
// Against 989 TFLOP/s and 3.35 TB/s both give about 1.5 ms, so the layer
// sits near the ridge. On top of that there is a serial chain of T
// dependent steps: no step can start before the whole h of the step before
// is known, so the time is T times the latency of one step. The first
// design (16-row blocks, each re-reading all of W_hh, 1.18 MB at H = 384,
// from L2 every step) waited on a few hundred dependent L2 round trips a
// step, about 66 us, at 257 rows as at 2056.
//
// Design: a thread-block cluster of C CTAs (8 or 16) owns R batch rows and
// splits the 4H columns of W_hh by units, as csrc/gru_scan.cu does for the
// GRU's 3H.
//   * CTA k of the cluster owns units [k*U, (k+1)*U), U = H/C, and with them
//     the four gate columns i, f, g, o of each unit, so every (row, unit)
//     update still needs nothing from another thread. Its W_hh^T slice (4U
//     rows of wt: 75 KB at H = 384, C = 16; 147 KB at H = 384, C = 8; 130 KB
//     at H = 512, C = 16) is copied into shared memory once: no step reads
//     W_hh from L2.
//   * Every CTA keeps a bf16 copy of the whole h_{t-1} of the cluster's rows
//     in shared memory, double buffered, and its own units' fp32 c. No fp32
//     h is kept: the cell reads only c, and kernel B's h_T is the fp32 h of
//     the last step. After its update a CTA writes its new bf16 slice into
//     its own next buffer, then into the next buffer of every other CTA of
//     the cluster (distributed shared memory, 16-byte stores, to the peers
//     rank+1, rank+2, ... in turn, so that a cluster's CTAs do not all write
//     to one peer at once), and meets them at one cluster barrier
//     (release/acquire). The barrier after step s also means that every CTA
//     has read buffer s&1 before anyone writes it in step s+1, so one
//     barrier a step is enough; the last one comes before any CTA exits.
//   * The x-side gates of step t+2 for the thread's own (row, unit) pairs are
//     copied (4-byte cp.async, two tiles) while steps t and t+1 run, so they
//     leave the serial chain; each thread waits only for its own copies, in
//     the shadow of the cluster barrier (between its arrive and its wait).
//   * The product is the single-block design's, element for element:
//     mma.sync m16n8k16, bf16 operands, fp32 accumulators from zero, the k
//     loop in the same order. A warp owns one m16 row tile and 8 units (one
//     warp per such item, 8 to 18 warps) and computes the n8 tiles of their
//     i, f, g and o columns, loading the next k-step's fragments while this
//     one's products run; the cell arithmetic is the same expression.
//     Splitting the columns changes no element's sum, so h is bit-identical
//     to the single-block kernel's (and to kernel E's, lstm_scan_staged.cu,
//     which reorganises that kernel).
//   * The launch plan (C, R and the shared bytes) comes from the caller
//     (ops/lstm.py plan_scan, which weighs the shared bytes against
//     cudaOccupancyMaxActiveClusters, lstm_scan_max_clusters below); the
//     entries refuse a plan whose bytes are not this layout's. A cluster of
//     16 is non-portable and is opted into; a launch the card refuses
//     returns its error. H must be a multiple of 8 * C (the wrappers pad it
//     with zero units).
//
// The streamed variant (lstm_stream_kernel; entries lstm_scan_fwd_stream,
// lstm_scan_fwd_carry_stream, lstm_scan_fwd_train_stream) runs kernels A, B
// and C where no resident cluster holds the slice, in place of the single
// block of csrc/lstm_scan_block.cu (above H = 512: at H = 768 a CTA of 16
// needs 297,984 B of slice beside 65,024 B of h buffers, c and gates, over
// the 232,448 B a block may use). It replaces the same TPU kernels,
// generative_audio_tpu/ops/pallas_lstm.py:142 (_lstm_pallas_call), :205
// (_lstm_pallas_call_train) and :725 (_lstm_pallas_call_carry), there.
//   * What bounds it: the serial chain as above, plus the part of the slice
//     that does not fit, which every CTA must read again at every step. At
//     H = 768, C = 16 that is 160-190 KB a step a CTA from L2 (W_hh^T, 4.7
//     MB, stays in the 50 MB L2), where the single block read all 4.7 MB a
//     step through each CTA in dependent 4-byte loads.
//   * Design: the cluster, the units, the h exchange, the gates and the cell
//     are the resident kernel's. The slice is split by k: its first
//     `resident` k-steps are copied into shared memory once, the others
//     stream through a ring of `stages` slots of two k-steps (a k-pair),
//     each filled by one cp.async.bulk from L2 that completes on the slot's
//     mbarrier. The last warp of the CTA is the producer: one thread keeps
//     the ring full, waiting on a slot's `empty` barrier, on which each
//     consumer warp arrives once its fragments are in registers. The weight
//     is constant, so the producer fills the next step's first slots while
//     this step's exchange and cluster barrier run. One consumer warp takes
//     one (m16 tile, 8 units) item, so every warp reads each slot once a
//     step (at most 18 items a CTA).
//   * Numerics: the same mma.sync m16n8k16, bf16 operands and fp32
//     accumulators from zero, each accumulator's k-steps in order (the
//     resident ones, then the streamed ones), and the same cell expression:
//     h is bit-identical to the resident cluster's and to the single
//     block's.
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
// kernel lays them out: W_hh^T slice [4U][H + PAD] bf16, h [2][R][H + PAD]
// bf16, own c [R][U] fp32, x-side gates of two steps [2][R][4U] bf16. Every
// region is a multiple of 16 bytes when U % 8 == 0.
size_t cluster_smem(int H, int C, int R) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (4 * U + 2 * r) * hs * 2 + r * U * 4 + 2 * r * 4 * U * 2;
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

template <typename OutT, bool CARRY, bool STREAM_C>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
lstm_cluster_kernel(const __nv_bfloat16* __restrict__ gates,
                    const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    OutT* __restrict__ out, float* __restrict__ h_T,
                    float* __restrict__ c_T, __nv_bfloat16* __restrict__ c_seq,
                    int T, int B, int H, int R, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U4 = 4 * U, hs = H + PAD, G4 = 4 * H;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);      // [4U][hs]
  __nv_bfloat16* hbuf = ws + U4 * hs;                               // [2][R][hs]
  float* cf = reinterpret_cast<float*>(hbuf + 2 * R * hs);          // [R][U]
  __nv_bfloat16* gx = reinterpret_cast<__nv_bfloat16*>(cf + R * U); // [2][R][4U]
  const int nthreads = blockDim.x, nwarps = nthreads / 32;

  // W^T slice: rows q*H + col0 + u of wt (q < 4, u < U), 16-byte copies
  const int per_row = H / 8;
  for (int i = threadIdx.x; i < U4 * per_row; i += nthreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const int q = r / U, u = r % U;
    *reinterpret_cast<uint4*>(ws + r * hs + c) =
        *reinterpret_cast<const uint4*>(wt + (size_t)(q * H + col0 + u) * H + c);
  }
  // h_{-1}: all units in bf16 (buffer 0; buffer 1 zeroed); c_{-1}: own units
  for (int i = threadIdx.x; i < R * H; i += nthreads) {
    const int r = i / H, j = i % H;
    float h = 0.0f, c = 0.0f;
    if (CARRY && r < nrows) {
      h = h0[(size_t)(row0 + r) * H + j];
      c = c0[(size_t)(row0 + r) * H + j];
    }
    hbuf[r * hs + j] = __float2bfloat16(h);
    hbuf[(R + r) * hs + j] = __float2bfloat16(0.0f);
    if (j >= col0 && j < col0 + U) cf[r * U + j - col0] = c;
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
            gates + ((size_t)t * B + row0 + r) * G4 + col0 + jl;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async4(gx + (buf * R + r) * U4 + q * U + jl, src + q * H);
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
    const __nv_bfloat16* gcur = gx + (s & 1) * R * U4;

    for (int i = warp; i < n_items; i += nwarps) {
      const int mt = i / G, g = i % G;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      // k-steps in pairs (H % 32 == 0), the next k-step's fragments loaded
      // while this one's products run
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
        for (int q = 0; q < 4; ++q) mma16816(acc[q], a[0], b[0][q]);
        if (k + 2 < ksteps) load_k(k + 2, 0);
#pragma unroll
        for (int q = 0; q < 4; ++q) mma16816(acc[q], a[1], b[1][q]);
      }

      // accumulator (half, e): row 16 mt + grp + 8 half, unit jl + e
      const int jl = 8 * g + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
        const bool valid = r < nrows;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 gv = make_float2(0.0f, 0.0f);
          if (valid) gv = load_pair(gcur + r * U4 + q * U + jl);
          z[q][0] = gv.x + acc[q][2 * half];
          z[q][1] = gv.y + acc[q][2 * half + 1];
        }
        float hn[2], cn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cf[r * U + jl + e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          cn[e] = c;
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cf[r * U + jl + e] = c;
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (valid) {
          const size_t o = ((size_t)t * B + row0 + r) * H + col0 + jl;
          store_pair(out + o, hn[0], hn[1]);
          if (STREAM_C) store_pair(c_seq + o, cn[0], cn[1]);
          if (CARRY && s == T - 1) {
            store_pair(h_T + (size_t)(row0 + r) * H + col0 + jl, hn[0], hn[1]);
            store_pair(c_T + (size_t)(row0 + r) * H + col0 + jl, cn[0], cn[1]);
          }
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

template <typename OutT, bool CARRY, bool STREAM_C>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = lstm_cluster_kernel<OutT, CARRY, STREAM_C>;
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

template <typename OutT, bool CARRY, bool STREAM_C = false>
int launch(const void* gates, const void* wt, const void* h0, const void* c0,
           void* out, void* h_T, void* c_T, void* c_seq, int T, int B, int H,
           int reverse, int C, int R, int smem_bytes, void* stream) {
  if (!plan_fits(H, C, R) || (size_t)smem_bytes != cluster_smem(H, C, R))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<OutT, CARRY, STREAM_C>(C, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * cluster_warps(H, C, R));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_cluster_kernel<OutT, CARRY, STREAM_C>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)wt, (const float*)h0,
                           (const float*)c0, (OutT*)out, (float*)h_T,
                           (float*)c_T, (__nv_bfloat16*)c_seq, T, B, H, R,
                           reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename OutT, bool CARRY, bool STREAM_C = false>
int max_clusters(int H, int C, int R, int* n) {
  if (!plan_fits(H, C, R)) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(H, C, R);
  cudaError_t err = prepare<OutT, CARRY, STREAM_C>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(32 * cluster_warps(H, C, R));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, lstm_cluster_kernel<OutT, CARRY, STREAM_C>, &cfg);
}

// ---- the streamed variant: H that no resident cluster holds ---------------
//
// The same cluster, units, h exchange, gates and cell as lstm_cluster_kernel;
// only the W_hh^T slice moves. The wrapper packs wt once per call in MMA
// fragment order, [C][H/32][4][U/8][32 lanes][8] bf16 (ops/lstm.py
// _stream_weight): for CTA rank k and k-pair p (k-steps 2p and 2p + 1), gate
// q, unit group g and lane (grp, tq), the B fragments (b0, b1) of both
// k-steps of slice row q*H + k*U + 8g + grp. A k-pair of a CTA's slice is
// then one contiguous piece of 256 U bytes, and a warp reads a gate's
// fragments of both k-steps as one 16-byte load a lane, in 512 contiguous
// bytes. The first `resident` k-steps (an even number) are copied into
// shared memory once; the other H/32 - resident/2 k-pairs pass through a
// ring of `stages` slots, one k-pair a slot, at every step.

// Consumer warps of a CTA of the streamed variant at most: one (m16 tile, 8
// units) item each, so that every warp reads each ring slot once a step.
constexpr int STREAM_MAX_WARPS = 18;

// Bytes of one k-pair (32 columns) of a CTA's slice of n gates x U units.
__host__ __device__ inline size_t stream_pair_bytes(int U, int n_gates) {
  return (size_t)n_gates * U * 64;
}

// Shared bytes of one CTA of the streamed variant, in the order the kernel
// lays them out: the ring [stages][k-pair] and the resident k-pairs
// [resident / 2][k-pair] in fragment order, h [2][R][H + PAD] bf16, own c
// [R][U] fp32, x-side gates of two steps [2][R][4U] bf16, and the ring's
// full and empty mbarriers [2][stages]. Every region is a multiple of 16
// bytes when U % 8 == 0.
size_t stream_smem(int H, int C, int R, int resident, int stages) {
  const size_t U = H / C, hs = H + PAD, r = R;
  return (stages + resident / 2) * stream_pair_bytes(U, 4) + 2 * r * hs * 2 +
         r * U * 4 + 2 * r * 4 * U * 2 + 16 * stages;
}

// Warps of a CTA of the streamed variant: one consumer warp per item (at
// least MIN_WARPS, which share the exchange's stores) and the producer.
int stream_warps(int H, int C, int R) {
  return max(MIN_WARPS, (R / 16) * (H / C / 8)) + 1;
}

template <typename OutT, bool CARRY, bool STREAM_C>
__global__ void __launch_bounds__((STREAM_MAX_WARPS + 1) * 32, 1)
lstm_stream_kernel(const __nv_bfloat16* __restrict__ gates,
                   const __nv_bfloat16* __restrict__ wf,
                   const float* __restrict__ h0, const float* __restrict__ c0,
                   OutT* __restrict__ out, float* __restrict__ h_T,
                   float* __restrict__ c_T, __nv_bfloat16* __restrict__ c_seq,
                   int T, int B, int H, int R, int resident, int stages,
                   int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U4 = 4 * U, hs = H + PAD, G4 = 4 * H;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int G = U / 8, KP = H / 32, KR = resident / 2, NS = KP - KR;
  const int D = stages;
  const uint32_t pair = (uint32_t)stream_pair_bytes(U, 4);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                   // [D][pair]
  unsigned char* wres = ring + (size_t)D * pair;                // [KR][pair]
  __nv_bfloat16* hbuf =
      reinterpret_cast<__nv_bfloat16*>(wres + (size_t)KR * pair);  // [2][R][hs]
  float* cf = reinterpret_cast<float*>(hbuf + 2 * R * hs);          // [R][U]
  __nv_bfloat16* gx = reinterpret_cast<__nv_bfloat16*>(cf + R * U); // [2][R][4U]
  uint64_t* full = reinterpret_cast<uint64_t*>(gx + 2 * R * U4);    // [D]
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
  // h_{-1}: all units in bf16 (buffer 0; buffer 1 zeroed); c_{-1}: own units
  for (int i = threadIdx.x; i < R * H; i += nthreads) {
    const int r = i / H, j = i % H;
    float h = 0.0f, c = 0.0f;
    if (CARRY && r < nrows) {
      h = h0[(size_t)(row0 + r) * H + j];
      c = c0[(size_t)(row0 + r) * H + j];
    }
    hbuf[r * hs + j] = __float2bfloat16(h);
    hbuf[(R + r) * hs + j] = __float2bfloat16(0.0f);
    if (j >= col0 && j < col0 + U) cf[r * U + j - col0] = c;
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
            gates + ((size_t)t * B + row0 + r) * G4 + col0 + jl;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async4(gx + (buf * R + r) * U4 + q * U + jl, src + q * H);
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
    const __nv_bfloat16* gcur = gx + (s & 1) * R * U4;

    if (warp < n_items) {
      const int mt = warp / G, g = warp % G;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      // the products of k-pair p, whose fragments lie at wp: k-step 2p for
      // the four gates, then k-step 2p + 1, each accumulator in k order
      const __nv_bfloat16* ap = hcur + (mt * 16 + grp) * hs + 2 * tq;
      const int frag = g * 32 + lane;
      auto pair_mma = [&](const unsigned char* wp, int p) {
        uint32_t a[2][4];
        load_a(a[0], ap + 32 * p, hs);        // A (16x16, row-major): h_{t-1}
        load_a(a[1], ap + 32 * p + 16, hs);
        uint4 b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = reinterpret_cast<const uint4*>(wp)[q * G * 32 + frag];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t b0[2] = {b[q].x, b[q].y};
          mma16816(acc[q], a[0], b0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
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
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 gv = make_float2(0.0f, 0.0f);
          if (valid) gv = load_pair(gcur + r * U4 + q * U + jl);
          z[q][0] = gv.x + acc[q][2 * half];
          z[q][1] = gv.y + acc[q][2 * half + 1];
        }
        float hn[2], cn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cf[r * U + jl + e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          cn[e] = c;
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cf[r * U + jl + e] = c;
        }
        store_pair(hnext + r * hs + col0 + jl, hn[0], hn[1]);
        if (valid) {
          const size_t o = ((size_t)t * B + row0 + r) * H + col0 + jl;
          store_pair(out + o, hn[0], hn[1]);
          if (STREAM_C) store_pair(c_seq + o, cn[0], cn[1]);
          if (CARRY && s == T - 1) {
            store_pair(h_T + (size_t)(row0 + r) * H + col0 + jl, hn[0], hn[1]);
            store_pair(c_T + (size_t)(row0 + r) * H + col0 + jl, cn[0], cn[1]);
          }
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
    // lstm_cluster_kernel does
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

template <typename OutT, bool CARRY, bool STREAM_C>
cudaError_t prepare_stream(int C, size_t smem) {
  auto kernel = lstm_stream_kernel<OutT, CARRY, STREAM_C>;
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

template <typename OutT, bool CARRY, bool STREAM_C = false>
int launch_stream(const void* gates, const void* wf, const void* h0,
                  const void* c0, void* out, void* h_T, void* c_T,
                  void* c_seq, int T, int B, int H, int reverse, int C, int R,
                  int resident, int stages, int smem_bytes, void* stream) {
  if (!stream_plan_fits(H, C, R, resident, stages) ||
      (size_t)smem_bytes != stream_smem(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_stream<OutT, CARRY, STREAM_C>(C, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * stream_warps(H, C, R));
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_stream_kernel<OutT, CARRY, STREAM_C>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)wf, (const float*)h0,
                           (const float*)c0, (OutT*)out, (float*)h_T,
                           (float*)c_T, (__nv_bfloat16*)c_seq, T, B, H, R,
                           resident, stages, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename OutT, bool CARRY, bool STREAM_C = false>
int max_stream_clusters(int H, int C, int R, int resident, int stages,
                        int* n) {
  if (!stream_plan_fits(H, C, R, resident, stages))
    return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem(H, C, R, resident, stages);
  cudaError_t err = prepare_stream<OutT, CARRY, STREAM_C>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(32 * stream_warps(H, C, R));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, lstm_stream_kernel<OutT, CARRY, STREAM_C>, &cfg);
}

}  // namespace

extern "C" {

// Kernel A. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out [T, B, H] (bf16,
// or fp32 when out_f32), as clusters of `cluster` CTAs (8 or 16, H a
// multiple of 8 * cluster) over `rows` batch rows each (a multiple of 16);
// smem_bytes must be the layout's (ops/lstm.py scan_smem_bytes).
int lstm_scan_fwd(const void* gates, const void* wt, void* out, int out_f32,
                  int T, int B, int H, int reverse, int cluster, int rows,
                  int smem_bytes, void* stream) {
  if (out_f32)
    return launch<float, false>(gates, wt, nullptr, nullptr, out, nullptr,
                                nullptr, nullptr, T, B, H, reverse, cluster,
                                rows, smem_bytes, stream);
  return launch<__nv_bfloat16, false>(gates, wt, nullptr, nullptr, out,
                                      nullptr, nullptr, nullptr, T, B, H,
                                      reverse, cluster, rows, smem_bytes,
                                      stream);
}

// Kernel B. As kernel A, plus h0, c0 [B, H] fp32 in and h_T, c_T [B, H]
// fp32 out (the state after the last processed step).
int lstm_scan_fwd_carry(const void* gates, const void* wt, const void* h0,
                        const void* c0, void* out, void* h_T, void* c_T,
                        int out_f32, int T, int B, int H, int reverse,
                        int cluster, int rows, int smem_bytes, void* stream) {
  if (out_f32)
    return launch<float, true>(gates, wt, h0, c0, out, h_T, c_T, nullptr, T,
                               B, H, reverse, cluster, rows, smem_bytes,
                               stream);
  return launch<__nv_bfloat16, true>(gates, wt, h0, c0, out, h_T, c_T,
                                     nullptr, T, B, H, reverse, cluster, rows,
                                     smem_bytes, stream);
}

// Kernel C. As kernel A with bf16 output, plus c_seq [T, B, H] bf16 out:
// c_t after each step, rounded once (the state itself stays fp32 on chip).
int lstm_scan_fwd_train(const void* gates, const void* wt, void* h_seq,
                        void* c_seq, int T, int B, int H, int reverse,
                        int cluster, int rows, int smem_bytes, void* stream) {
  return launch<__nv_bfloat16, false, true>(gates, wt, nullptr, nullptr, h_seq,
                                            nullptr, nullptr, c_seq, T, B, H,
                                            reverse, cluster, rows, smem_bytes,
                                            stream);
}

// cudaOccupancyMaxActiveClusters of the instance (out_f32, carry, train) for
// a cluster of `cluster` CTAs over `rows` rows at H: *n clusters can run at
// once on the current device.
int lstm_scan_max_clusters(int out_f32, int carry, int train, int H,
                           int cluster, int rows, int* n) {
  if (train)
    return max_clusters<__nv_bfloat16, false, true>(H, cluster, rows, n);
  if (out_f32)
    return carry ? max_clusters<float, true>(H, cluster, rows, n)
                 : max_clusters<float, false>(H, cluster, rows, n);
  return carry ? max_clusters<__nv_bfloat16, true>(H, cluster, rows, n)
               : max_clusters<__nv_bfloat16, false>(H, cluster, rows, n);
}

// The streamed variant of kernels A, B and C: the same arguments, with
// wt replaced by wf, the W_hh^T slices packed in fragment order
// ([cluster][H/32][4][U/8][32][8] bf16, ops/lstm.py _stream_weight), and a
// plan that adds the resident k-steps (even, fewer than H/16) and the ring's
// stages (two k-steps each); smem_bytes must be the layout's (ops/lstm.py
// stream_smem_bytes), and rows / 16 x H / cluster / 8 at most 18.
int lstm_scan_fwd_stream(const void* gates, const void* wf, void* out,
                         int out_f32, int T, int B, int H, int reverse,
                         int cluster, int rows, int resident, int stages,
                         int smem_bytes, void* stream) {
  if (out_f32)
    return launch_stream<float, false>(gates, wf, nullptr, nullptr, out,
                                       nullptr, nullptr, nullptr, T, B, H,
                                       reverse, cluster, rows, resident,
                                       stages, smem_bytes, stream);
  return launch_stream<__nv_bfloat16, false>(
      gates, wf, nullptr, nullptr, out, nullptr, nullptr, nullptr, T, B, H,
      reverse, cluster, rows, resident, stages, smem_bytes, stream);
}

int lstm_scan_fwd_carry_stream(const void* gates, const void* wf,
                               const void* h0, const void* c0, void* out,
                               void* h_T, void* c_T, int out_f32, int T,
                               int B, int H, int reverse, int cluster,
                               int rows, int resident, int stages,
                               int smem_bytes, void* stream) {
  if (out_f32)
    return launch_stream<float, true>(gates, wf, h0, c0, out, h_T, c_T,
                                      nullptr, T, B, H, reverse, cluster,
                                      rows, resident, stages, smem_bytes,
                                      stream);
  return launch_stream<__nv_bfloat16, true>(
      gates, wf, h0, c0, out, h_T, c_T, nullptr, T, B, H, reverse, cluster,
      rows, resident, stages, smem_bytes, stream);
}

int lstm_scan_fwd_train_stream(const void* gates, const void* wf,
                               void* h_seq, void* c_seq, int T, int B, int H,
                               int reverse, int cluster, int rows,
                               int resident, int stages, int smem_bytes,
                               void* stream) {
  return launch_stream<__nv_bfloat16, false, true>(
      gates, wf, nullptr, nullptr, h_seq, nullptr, nullptr, c_seq, T, B, H,
      reverse, cluster, rows, resident, stages, smem_bytes, stream);
}

// cudaOccupancyMaxActiveClusters of the streamed instance (out_f32, carry,
// train) with `resident` k-steps resident and a ring of `stages`, for a
// cluster of `cluster` CTAs over `rows` rows at H.
int lstm_scan_stream_max_clusters(int out_f32, int carry, int train,
                                  int resident, int stages, int H,
                                  int cluster, int rows, int* n) {
  if (train)
    return max_stream_clusters<__nv_bfloat16, false, true>(
        H, cluster, rows, resident, stages, n);
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

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
