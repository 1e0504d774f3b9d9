// GRU forward scan over precomputed time-major x-side gates, redesigned for
// the sub-band batch (H <= 512 over thousands of rows) as a wide cluster
// with each step's product on Hopper's warpgroup MMA (wgmma), for sm_90a.
//
// Replaces the same TPU kernels as csrc/gru_scan.cu's resident cluster,
// where ops/gru.py's route (ops/lstm.py plan_forward's step models) finds
// this design faster:
//   * gru_scan_fwd_wide       <- generative_audio_tpu/ops/pallas_lstm.py:907
//     _gru_pallas_call / _gru_kernel (h starts at zero), used by gru_scan_tm
//     without grad and as GRUScan's forward;
//   * gru_scan_fwd_carry_wide <- :1151 _gru_pallas_call_carry /
//     _gru_carry_kernel (h0 in, h_T out), used by gru_layer_tm_chunked.
// What it computes is gru_scan.cu's, per row b and step t (torch gate order
// r, z, n):
//   gh  = bf16(h_{t-1}) @ W_hh + b_hh              (fp32 accumulation and bias)
//   r   = sigmoid(x_r + gh_r),  z = sigmoid(x_z + gh_z)
//   n   = tanh(x_n + r * gh_n)
//   h_t = (1 - z) * n + z * h_{t-1}                (h_{t-1} in fp32)
// with x = float(gates[t, b, :]). gates [T, B, 3H] bf16 (b_ih added), W_hh^T
// packed by the wrapper for wgmma (ops/lstm.py _wide_weight with three
// gates, below), b_hh [3H] fp32, h [T, B, H] in bf16 or fp32. reverse=1
// walks t from T-1 to 0.
//
// What bounds it on an H100. At the serving shape (8 x 10 s: T = 628, 2056
// rows, H = 384) a layer does 1.14 TFLOP of bf16 products and moves 3.97 GB
// (gates in, h out): about 1.2 ms either way. The chain of 628 steps is
// serial; the resident cluster holds each CTA's whole W_hh^T slice (113 KB
// at H = 384, C = 8) and so only a few dozen rows a cluster, which gives
// 2056 rows five waves of 628 steps. Here, as kernel A's wide cluster
// (csrc/lstm_scan_wide.cu, whose layout, ring, products and exchange
// csrc/scan_fwd_wide.cuh holds for both):
//   * W_hh^T streams from L2 (its first `resident` k-steps stay in shared
//     memory) through a ring of k-pair slots that a producer warp fills by
//     bulk copies, so a cluster of 8 takes up to 160 rows: 2056 rows run in
//     one wave of 13 clusters.
//   * The product of a CTA is Z^T [4U x R] = W_hh^T slice [4U x H] . h^T
//     [H x R] on wgmma m64nRk16 (M = 64 gate rows a warpgroup, N = the
//     cluster's R rows, an instance a row count). A GRU unit has three
//     gates; at H = 384 and C = 8 a CTA's 48 units have 144 gate rows, no
//     multiple of wgmma's M = 64. So each unit takes a fourth gate row of
//     zeros, (r, z, n, 0), and kernel A's row order: row 64 wg + 16 w + 8 hi
//     + r of warpgroup wg's warp w is gate 2 hi + (r & 1) of unit 16 wg + 4 w
//     + r / 2. A thread holds accumulator rows lane / 4 and lane / 4 + 8 of
//     its warp's 16: r and n of one unit (lane / 4 even) or z and the zero
//     row (odd), and one exchange of two values by shuffle with its partner
//     lane ^ 4 gives each of the pair r, z and n of one of the two columns
//     it holds. The zero rows cost a third more products and a third more
//     W_hh^T bytes from L2 than the three gates need.
//   * The cell adds the unit's three b_hh values (in registers) to the
//     accumulators in fp32, as the resident cluster does; fp32 h_{t-1} stays
//     in registers (a thread owns one unit of R / 8 rows); the x-side gates
//     of step t arrive by TMA, three boxes of R rows x U units a step (one a
//     gate), right after step t-1's cell has read them.
//   * h once a CTA, [H / 8][R][8] bf16, read by wgmma as B; after its cell a
//     CTA writes its new slice into its own buffer and sends it to each peer
//     with one cp.async.bulk completing on the peer's mbarrier. bf16 h goes
//     to global memory from the slice in 16-byte pieces, fp32 h (and h_T)
//     from the registers.
//
// Numerics: fp32 accumulators from zero, bf16 operands, the k16 steps in
// the resident cluster's order (the resident k-pairs, then the streamed
// ones, k ascending) and the same cell expression as gru_scan.cu. On an
// H100 wgmma's sums equal mma.sync's bit for bit (chip_smoke.py phase 26),
// so h and h_T equal the resident cluster's (chip_smoke.py phase 30 holds
// them to it); a chunked run of the carry entry equals an unchunked one bit
// for bit (the carry crosses a chunk as the fp32 h the next step would have
// read), and two runs of one plan agree.
//
// The launch plan (C, R, resident k-steps, stages, shared bytes) comes from
// the caller (ops/gru.py plan_gru_wide_scan, against
// cudaOccupancyMaxActiveClusters of gru_scan_wide_max_clusters below; one
// instance a row count serves both entries and both output types); the
// entries refuse a plan whose bytes are not this layout's. H must be a
// multiple of 16 C with at most 48 units a CTA (the wrappers pad it with
// zero units), R one of the instances' row counts (WIDE_INSTANCES).
// gru_scan_wide_trace also writes a clock64 trace of the first steps of
// one warp (scan_fwd_wide.cuh TRACE_POINTS).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_fwd_wide.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
gru_wide_kernel(const __grid_constant__ CUtensorMap gmap,  // gates [T, B, 3H]
                const __nv_bfloat16* __restrict__ wf,
                const float* __restrict__ bhh, const float* __restrict__ h0,
                void* __restrict__ out, float* __restrict__ h_T,
                long long* __restrict__ trace,
                int T, int B, int H, int resident, int stages, int reverse,
                int out_f32, int carry) {
  constexpr int R = N;                        // rows a cluster
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideCta w = wide_cta<R>(smem_raw, wf, B, H, resident, stages, 3);
  const int U = w.U, col0 = w.col0, row0 = w.row0, nrows = w.nrows;
  const uint32_t box = w.box;
  const __nv_bfloat16* gx = w.gx;

  // warps 0 .. 4 U / 16 - 1 are consumers, a warpgroup a 16 units; the
  // last warpgroup's first warp is the producer, the rest of it idle
  const int nthreads = blockDim.x, ncons = U / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool consumer = warp < ncons;
  const bool tracing = trace != nullptr && w.row0 == 0 && w.rank == 0 &&
                       threadIdx.x == 0;

  wide_fill(w, H, R, h0, carry, ncons);
  const int dir = reverse ? -1 : 1, t0 = reverse ? T - 1 : 0;
  if (threadIdx.x == 0) wide_fetch_gates<3>(w, &gmap, H, t0);
  const bool producer = warp == ncons && lane == 0;
  WideRing ring{0, T * w.NS, min(w.D, w.NS)};
  if (producer) ring.produce(w, ring.ahead);

  // this thread's unit of the CTA (its lane pair's), and which of the two
  // columns of each 8-row chunk its cell takes (the one of its gates' pair
  // that its partner's exchange completes): row 8 i + 2 tq + e of chunk i;
  // its fp32 h of those rows and the unit's b_hh
  const int wg = warp >> 2, r8 = lane >> 2, tq = lane & 3, e = r8 & 1;
  const int ul = 16 * wg + 4 * (warp & 3) + (r8 >> 1);
  float hst[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int n = 8 * i + 2 * tq + e;
    hst[i] = 0.0f;
    if (carry && consumer && n < nrows)
      hst[i] = h0[(size_t)(row0 + n) * H + col0 + ul];
  }
  float b_r = 0.0f, b_z = 0.0f, b_n = 0.0f;
  if (consumer) {
    b_r = bhh[col0 + ul];
    b_z = bhh[H + col0 + ul];
    b_n = bhh[2 * H + col0 + ul];
  }
  cluster.sync();      // every CTA has started and filled its buffers

  // The steps, in two paths that meet at the same barriers a step: the
  // cluster barrier's arrive and wait and two CTA barriers (bar 1 of every
  // thread), so that each path's registers are its own.
  if (!consumer) {
    wide_producer_steps(w, ring, producer, T, out_f32);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(WIDE_CONSUMER_REGS));

  const WideMma m = wide_mma(w, R, wg);
  const int cthreads = 32 * ncons;
  for (int s = 0; s < T; ++s) {
    const int t = t0 + dir * s;
    const bool last = s == T - 1;
    long long waited = 0;
    if (tracing && s < TRACE_STEPS)
      trace[s * TRACE_POINTS] = clock_now();
    // the strides of the cell's addresses, opaque to the compiler a step at
    // a time (as kernel A's)
    int Us = U, Hs = H;
    asm volatile("" : "+r"(Us), "+r"(Hs));

    float acc[N / 2];
    wide_products<N>(acc, w, m, s, lane, tracing, waited);
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 1] = clock_now();
    // this CTA's wgmma has read h_{t-1}: peers may overwrite it once all
    // have; its own slice, which only this CTA reads, once its warps have
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    wide_cta_sync(nthreads);
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 2] = clock_now();

    // the cell, on the accumulators; bf16 h_t into the CTA's own slice
    xbar_wait(cta_addr(w.gfull), s & 1);    // step t's gates
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 3] = clock_now();
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      // accumulators 4i, 4i + 1: this thread's first gate row (r, or z for
      // odd e) at columns 8i + 2 tq, + 1; 4i + 2, 4i + 3: its second (n,
      // or the zero row); the partner sends its two gates of this thread's
      // column (for odd e, r and n; for even e, z and a zero)
      const float ra =
          __shfl_xor_sync(0xffffffffu, e ? acc[4 * i] : acc[4 * i + 1], 4);
      const float rb =
          __shfl_xor_sync(0xffffffffu, e ? acc[4 * i + 2] : acc[4 * i + 3], 4);
      const float ar = e ? ra : acc[4 * i], az = e ? acc[4 * i + 1] : ra;
      const float an = e ? rb : acc[4 * i + 2];
      const int n = 8 * i + 2 * tq + e;
      const __nv_bfloat16* gp = gx + n * Us + ul;
      const float gh_r = ar + b_r, gh_z = az + b_z, gh_n = an + b_n;
      const float rg = sigmoidf_(__bfloat162float(gp[0]) + gh_r);
      const float zg = sigmoidf_(__bfloat162float(gp[box]) + gh_z);
      const float ng = tanhf(__bfloat162float(gp[2 * box]) + rg * gh_n);
      const float h = (1.0f - zg) * ng + zg * hst[i];
      hst[i] = h;
      w.hown[h_index(ul, n, R)] = __float2bfloat16(h);
      if (n < nrows) {
        const size_t o = (size_t)(row0 + n) * Hs + col0 + ul;
        if (out_f32) reinterpret_cast<float*>(out)[(size_t)t * B * Hs + o] = h;
        if (carry && last) h_T[o] = h;
      }
    }
    fence_proxy_async();   // the slice is read by the bulk copies and wgmma
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 4] = clock_now();
    // every CTA has read h_{t-1}
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 5] = clock_now();
    if (last && out_f32) break;
    wide_cta_sync(nthreads);   // the slice is whole; the gates tile is read
    // ... and on to each peer, with the next step's gates
    if (!last) wide_send<3>(w, R, H, &gmap, t + dir);
    if (!out_f32) wide_store_h(w, R, H, B, t, out, cthreads);
    if (!last) wide_wait_peers(w, s);
    if (tracing && s < TRACE_STEPS) {
      trace[s * TRACE_POINTS + 6] = clock_now();
      trace[s * TRACE_POINTS + 7] = waited;
    }
  }
}

template <int N>
cudaError_t prepare(int C, size_t smem) {
  auto kernel = gru_wide_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The instance's launch (gates given) or, with n set, its occupancy query.
template <int N>
int run(const void* gates, const void* wf, const void* bhh, const void* h0,
        void* out, void* h_T, void* trace, int T, int B, int H, int reverse,
        int out_f32, int carry, int C, int resident, int stages, size_t smem,
        void* stream, int* n) {
  cudaError_t err = prepare<N>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(128 * (H / C / 16 + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = gru_wide_kernel<N>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  // gates [T, B, 3H] bf16 in boxes of one step's R rows x U columns of one
  // gate, no swizzle; rows beyond B read as zero
  CUtensorMap map = {};
  if (!tensor_map(&map, gates, T, B, 3 * H, H / C, N, false))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + N - 1) / N));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, map, (const __nv_bfloat16*)wf,
                           (const float*)bhh, (const float*)h0, out,
                           (float*)h_T, (long long*)trace, T, B, H, resident,
                           stages, reverse, out_f32, carry);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance for the plan,
// refusing a plan the kernel does not take or shared bytes that are not
// its layout's.
int dispatch(int out_f32, int carry, const void* gates, const void* wf,
             const void* bhh, const void* h0, void* out, void* h_T,
             void* trace, int T, int B, int H, int reverse, int C, int R,
             int resident, int stages, size_t smem_bytes, void* stream,
             int* n) {
  if (!plan_fits(H, C, R, resident, stages) ||
      smem_bytes != wide_smem(H, C, R, resident, stages, 3))
    return (int)cudaErrorInvalidValue;
#define WIDE_RUN(N)                                                          \
  if (R == N)                                                                \
    return run<N>(gates, wf, bhh, h0, out, h_T, trace, T, B, H, reverse,    \
                  out_f32, carry, C, resident, stages, smem_bytes, stream,   \
                  n);
  WIDE_INSTANCES(WIDE_RUN)
#undef WIDE_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// gates [T, B, 3H] bf16, wf (W_hh^T packed for wgmma, see above), bhh [3H]
// fp32 -> out [T, B, H] (bf16, or fp32 when out_f32), as clusters of
// `cluster` CTAs (8 or 16; H a multiple of 16 * cluster, at most 48 units a
// CTA) over `rows` batch rows each (an instance's: 16, 32, ..., 160),
// `resident` k-steps of each slice resident (even; all H / 16 with no ring)
// and a ring of `stages` k-pairs (at least 2; 0 only then); smem_bytes must
// be the layout's (ops/gru.py gru_wide_smem_bytes).
int gru_scan_fwd_wide(const void* gates, const void* wf, const void* bhh,
                      void* out, int out_f32, int T, int B, int H,
                      int reverse, int cluster, int rows, int resident,
                      int stages, int smem_bytes, void* stream) {
  return dispatch(out_f32, 0, gates, wf, bhh, nullptr, out, nullptr, nullptr,
                  T, B, H, reverse, cluster, rows, resident, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// As gru_scan_fwd_wide, plus h0 [B, H] fp32 in and h_T [B, H] fp32 out (the
// state after the last processed step).
int gru_scan_fwd_carry_wide(const void* gates, const void* wf,
                            const void* bhh, const void* h0, void* out,
                            void* h_T, int out_f32, int T, int B, int H,
                            int reverse, int cluster, int rows, int resident,
                            int stages, int smem_bytes, void* stream) {
  return dispatch(out_f32, 1, gates, wf, bhh, h0, out, h_T, nullptr, T, B, H,
                  reverse, cluster, rows, resident, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// gru_scan_fwd_wide that also writes trace [TRACE_STEPS][TRACE_POINTS]
// int64 (the clock64 readings of the first CTA's consumer warp 0; see
// scan_fwd_wide.cuh TRACE_POINTS).
int gru_scan_wide_trace(const void* gates, const void* wf, const void* bhh,
                        void* out, int out_f32, int T, int B, int H,
                        int reverse, int cluster, int rows, int resident,
                        int stages, int smem_bytes, void* trace,
                        void* stream) {
  if (trace == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(out_f32, 0, gates, wf, bhh, nullptr, out, nullptr, trace, T,
                  B, H, reverse, cluster, rows, resident, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance of `rows` rows with the
// plan's resident k-steps and stages, for a cluster of `cluster` CTAs at H:
// *n clusters can run at once.
int gru_scan_wide_max_clusters(int resident, int stages, int H, int cluster,
                               int rows, int* n) {
  return dispatch(0, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, 0, 0, H, 0, cluster, rows, resident, stages,
                  wide_smem(H, cluster, rows, resident, stages, 3), nullptr,
                  n);
}

const char* gru_scan_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
