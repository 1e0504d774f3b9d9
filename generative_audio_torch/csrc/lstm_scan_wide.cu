// LSTM forward scan over precomputed time-major gates, kernels A, B and C
// redesigned for the sub-band batch (H <= 512 over thousands of rows), for
// sm_90a, with each step's product on Hopper's warpgroup MMA (wgmma).
//
// Replaces the same TPU kernels as csrc/lstm_scan.cu's resident cluster,
// where ops/lstm.py plan_forward's step models find this design faster:
//   * kernel A (lstm_scan_fwd_wide)       <- generative_audio_tpu/ops/
//     pallas_lstm.py:142 _lstm_pallas_call / _lstm_kernel (h and c start at
//     zero), used by lstm_scan_tm without grad;
//   * kernel B (lstm_scan_fwd_carry_wide) <- :725 _lstm_pallas_call_carry /
//     _lstm_carry_kernel (h0, c0 in; h_T, c_T out), used by
//     lstm_layer_tm_chunked;
//   * kernel C (lstm_scan_fwd_train_wide) <- :205 _lstm_pallas_call_train /
//     _lstm_train_kernel (kernel A with bf16 h that also writes the bf16 c
//     sequence, the residuals of the backward), used by lstm_scan_train_tm
//     (LSTMScan's forward).
// What it computes is lstm_scan.cu's:
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// gates [T, B, 4H] bf16 (torch gate order i, f, g, o), h [T, B, H] in bf16
// or fp32, W_hh^T packed by the wrapper for wgmma (ops/lstm.py
// _wide_weight, below). reverse=1 walks t from T-1 to 0.
//
// What bounds it on an H100. At the serving shape (8 x 10 s: T = 628, 2056
// rows, H = 384) a layer does 1.52 TFLOP of bf16 products and moves 4.96 GB
// (gates in, h out): about 1.5 ms either way. The chain of 628 steps is
// serial, so the card runs it once, in one wave of clusters of 8 CTAs (one
// an SM) over up to 160 rows each; a step is the CTA's product, the cell
// and the exchange of h. Issued as warp-level mma.sync m16n8k16, the
// product ran at about a fifth of an SM's tensor rate; here:
//   * The product of a CTA is Z^T [4U x R] = W_hh^T slice [4U x H] . h^T
//     [H x R]: M = the CTA's 4U gate columns (U = H / C units, a multiple of
//     16: one warpgroup of four consumer warps a 64 columns, at most three),
//     N = the cluster's R rows (an instance a row count, wgmma's N), K = H.
//     Each warpgroup issues wgmma m64nRk16 with both operands in shared
//     memory by descriptor, K-major without swizzle (core matrices of 8
//     rows x 16 bytes): A from the W_hh^T ring or the resident k-pairs, B
//     from the h buffer. The k16 steps run in the order of the resident
//     cluster: the resident k-pairs, then the streamed ones, k ascending.
//     The accumulators (R / 2 a thread) and c (R / 8) want more than the
//     128 registers a thread that a CTA of 16 warps launches with: the
//     producer's warpgroup hands its registers to the consumers
//     (setmaxnreg, 152 a consumer thread).
//   * W_hh^T: the first `resident` k-steps of the CTA's slice stay in shared
//     memory, the others stream from L2 (the whole W_hh^T, 1.18 MB at H =
//     384, stays there) through a ring of `stages` slots of one k-pair, each
//     filled by one bulk copy that completes on the slot's mbarrier, from a
//     producer warp (the first of the last warpgroup). A k-pair is [4 k8
//     groups][4U rows][8] bf16, so that one bulk copy fills a slot. Its 4U
//     rows are ordered so that the cell finds a unit's four gates in one
//     lane pair: row 64 wg + 16 w + 8 hi + r of warpgroup wg's warp w is
//     gate 2 hi + (r & 1) of unit 16 wg + 4 w + r / 2. A thread holds accumulator rows lane / 4 and
//     lane / 4 + 8 of its warp's 16 (gates i and g, or f and o, of one
//     unit), and its partner lane ^ 4 the other two; one exchange of two
//     values by shuffle gives each of the pair the four gates of one of the
//     two columns it holds.
//   * h once a CTA, [H / 8][R][8] bf16 (h_index): the k16 step k reads unit
//     groups 2k and 2k + 1, R core matrices of 16 bytes each, and the slice
//     of CTA k's units is one contiguous block in every CTA. After its cell
//     a CTA writes its new slice into its own buffer (generic stores,
//     fenced to the async proxy) and sends it to each peer with one
//     cp.async.bulk (shared::cta to shared::cluster) that completes on the
//     peer's mbarrier: C - 1 bulk copies a step. With one buffer, a peer may
//     overwrite h_{t-1} only after every CTA's wgmma has read it: each
//     thread arrives on the cluster barrier after wgmma.wait_group 0 and
//     waits on it after its cell.
//   * A ring slot goes back to the producer once the wgmma group that read
//     it has completed: each streamed k-pair is one commit group, and
//     wait_group 1 after the next pair's commit retires it.
//   * The x-side gates of step t arrive by TMA (a 3-D tensor map over
//     [T][B][4H], four boxes of R rows x U units a step, one per gate) into
//     one buffer, issued right after step t-1's cell has read it, so the
//     copy runs under the exchange and the products; rows beyond B read as
//     zero. c stays in registers: a thread owns one unit of R / 8 rows.
//   * bf16 h is written to global memory from the CTA's slice in 16-byte
//     pieces; fp32 h from the registers. Kernel C's bf16 c goes from the
//     registers too, each thread its unit's value of each of its rows (a
//     warp's store covers 4 units x 8 rows), so that its layout is kernel
//     A's: a staged c slice [U / 8][R][8] would take 15 360 bytes at 160
//     rows and 48 units, a stage of the ring.
//
// Numerics: fp32 accumulators from zero, bf16 operands, the k16 steps in
// the resident cluster's order and the same cell expression as
// lstm_scan.cu. On an H100 wgmma's sums equal mma.sync's bit for bit, so h
// (and kernel B's h_T, c_T, kernel C's c sequence) equal the resident
// cluster's (chip_smoke.py phases 26 and 29 hold them to it); kernel C's h
// equals kernel A's; a chunked run of kernel B equals an unchunked one bit
// for bit, and two runs of one plan agree.
//
// The launch plan (C, R, resident k-steps, stages, shared bytes) comes from
// the caller (ops/lstm.py plan_wide_scan, against
// cudaOccupancyMaxActiveClusters of lstm_scan_wide_max_clusters below; one
// instance a row count serves all three entries); the entries refuse a plan
// whose bytes are not this layout's. H must be a
// multiple of 16 C with at most 48 units a CTA (the wrappers pad it with
// zero units), R one of the instances' row counts (WIDE_INSTANCES).
// lstm_scan_wide_trace also writes a clock64 trace of the first steps of
// one warp (see TRACE_POINTS). The layout, the ring, the products, the
// exchange and the trace are csrc/scan_fwd_wide.cuh's, which the GRU's
// wide cluster (csrc/gru_scan_wide.cu) shares.
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_fwd_wide.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
lstm_wide_kernel(const __grid_constant__ CUtensorMap gmap,  // gates [T, B, 4H]
                 const __nv_bfloat16* __restrict__ wf,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 void* __restrict__ out, __nv_bfloat16* __restrict__ c_seq,
                 float* __restrict__ h_T, float* __restrict__ c_T,
                 long long* __restrict__ trace,
                 int T, int B, int H, int resident, int stages, int reverse,
                 int out_f32, int carry) {
  constexpr int R = N;                        // rows a cluster
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideCta w = wide_cta<R>(smem_raw, wf, B, H, resident, stages, 4);
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
  if (threadIdx.x == 0) wide_fetch_gates<4>(w, &gmap, H, t0);
  const bool producer = warp == ncons && lane == 0;
  WideRing ring{0, T * w.NS, min(w.D, w.NS)};
  if (producer) ring.produce(w, ring.ahead);

  // this thread's unit of the CTA (its lane pair's), and which of the two
  // columns of each 8-row chunk its cell takes (the one of its gates' pair
  // that its partner's exchange completes): row 8 i + 2 tq + e of chunk i
  const int wg = warp >> 2, r8 = lane >> 2, tq = lane & 3, e = r8 & 1;
  const int ul = 16 * wg + 4 * (warp & 3) + (r8 >> 1);
  float cst[N / 8];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int n = 8 * i + 2 * tq + e;
    cst[i] = 0.0f;
    if (carry && consumer && n < nrows)
      cst[i] = c0[(size_t)(row0 + n) * H + col0 + ul];
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
    // a time: hoisted out of the loop, an unrolled cell's addresses (three
    // a chunk) outgrew the registers
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
      // accumulators 4i, 4i + 1: this thread's first gate (i, or f for odd
      // e) at columns 8i + 2 tq, + 1; 4i + 2, 4i + 3: its second (g or o);
      // the partner sends its two gates of this thread's column
      const float ra =
          __shfl_xor_sync(0xffffffffu, e ? acc[4 * i] : acc[4 * i + 1], 4);
      const float rb =
          __shfl_xor_sync(0xffffffffu, e ? acc[4 * i + 2] : acc[4 * i + 3], 4);
      const float zi = e ? ra : acc[4 * i], zf = e ? acc[4 * i + 1] : ra;
      const float zg = e ? rb : acc[4 * i + 2], zo = e ? acc[4 * i + 3] : rb;
      const int n = 8 * i + 2 * tq + e;
      const __nv_bfloat16* gp = gx + n * Us + ul;
      const float z0 = __bfloat162float(gp[0]) + zi;
      const float z1 = __bfloat162float(gp[box]) + zf;
      const float z2 = __bfloat162float(gp[2 * box]) + zg;
      const float z3 = __bfloat162float(gp[3 * box]) + zo;
      const float c = sigmoidf_(z1) * cst[i] + sigmoidf_(z0) * tanhf(z2);
      const float h = sigmoidf_(z3) * tanhf(c);
      cst[i] = c;
      w.hown[h_index(ul, n, R)] = __float2bfloat16(h);
      if (n < nrows) {
        const size_t o = (size_t)(row0 + n) * Hs + col0 + ul;
        if (out_f32) reinterpret_cast<float*>(out)[(size_t)t * B * Hs + o] = h;
        if (c_seq != nullptr)     // kernel C
          c_seq[(size_t)t * B * Hs + o] = __float2bfloat16(c);
        if (carry && last) {
          h_T[o] = h;
          c_T[o] = c;
        }
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
    if (!last) wide_send<4>(w, R, H, &gmap, t + dir);
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
  auto kernel = lstm_wide_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The instance's launch (gates given) or, with n set, its occupancy query.
template <int N>
int run(const void* gates, const void* wf, const void* h0, const void* c0,
        void* out, void* c_seq, void* h_T, void* c_T, void* trace, int T,
        int B, int H,
        int reverse, int out_f32, int carry, int C, int resident, int stages,
        size_t smem, void* stream, int* n) {
  cudaError_t err = prepare<N>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(128 * (H / C / 16 + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto kernel = lstm_wide_kernel<N>;
  if (n != nullptr) {
    cfg.gridDim = dim3(C);
    return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  }
  // gates [T, B, 4H] bf16 in boxes of one step's R rows x U columns of one
  // gate, no swizzle; rows beyond B read as zero
  CUtensorMap map = {};
  if (!tensor_map(&map, gates, T, B, 4 * H, H / C, N, false))
    return (int)cudaErrorInvalidValue;
  cfg.gridDim = dim3(C * ((B + N - 1) / N));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, map, (const __nv_bfloat16*)wf,
                           (const float*)h0, (const float*)c0, out,
                           (__nv_bfloat16*)c_seq, (float*)h_T, (float*)c_T,
                           (long long*)trace, T, B, H, resident, stages,
                           reverse, out_f32, carry);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// A launch (n null) or an occupancy query of the instance for the plan,
// refusing a plan the kernel does not take or shared bytes that are not
// its layout's.
int dispatch(int out_f32, int carry, const void* gates, const void* wf,
             const void* h0, const void* c0, void* out, void* c_seq,
             void* h_T, void* c_T, void* trace, int T, int B, int H,
             int reverse, int C, int R,
             int resident, int stages, size_t smem_bytes, void* stream,
             int* n) {
  if (!plan_fits(H, C, R, resident, stages) ||
      smem_bytes != wide_smem(H, C, R, resident, stages, 4))
    return (int)cudaErrorInvalidValue;
#define WIDE_RUN(N)                                                          \
  if (R == N)                                                                \
    return run<N>(gates, wf, h0, c0, out, c_seq, h_T, c_T, trace, T, B, H,  \
                  reverse, out_f32, carry, C, resident, stages, smem_bytes,  \
                  stream, n);
  WIDE_INSTANCES(WIDE_RUN)
#undef WIDE_RUN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Kernel A. gates [T, B, 4H] bf16, wf (W_hh^T packed for wgmma, see above)
// -> out [T, B, H] (bf16, or fp32 when out_f32), as clusters of `cluster`
// CTAs (8 or 16; H a multiple of 16 * cluster, at most 48 units a CTA) over
// `rows` batch rows each (an instance's: 16, 32, ..., 160), `resident`
// k-steps of each slice resident (even; all H / 16 with no ring) and a ring
// of `stages` k-pairs (at least 2; 0 only then); smem_bytes must be the
// layout's
// (ops/lstm.py wide_smem_bytes).
int lstm_scan_fwd_wide(const void* gates, const void* wf, void* out,
                       int out_f32, int T, int B, int H, int reverse,
                       int cluster, int rows, int resident, int stages,
                       int smem_bytes, void* stream) {
  return dispatch(out_f32, 0, gates, wf, nullptr, nullptr, out, nullptr,
                  nullptr, nullptr, nullptr, T, B, H, reverse, cluster, rows,
                  resident, stages, (size_t)smem_bytes, stream, nullptr);
}

// Kernel B. As kernel A, plus h0, c0 [B, H] fp32 in and h_T, c_T [B, H]
// fp32 out (the state after the last processed step).
int lstm_scan_fwd_carry_wide(const void* gates, const void* wf,
                             const void* h0, const void* c0, void* out,
                             void* h_T, void* c_T, int out_f32, int T, int B,
                             int H, int reverse, int cluster, int rows,
                             int resident, int stages, int smem_bytes,
                             void* stream) {
  return dispatch(out_f32, 1, gates, wf, h0, c0, out, nullptr, h_T, c_T,
                  nullptr, T, B, H, reverse, cluster, rows, resident, stages,
                  (size_t)smem_bytes, stream, nullptr);
}

// Kernel C. As kernel A with bf16 out (h_seq), plus c_seq [T, B, H] bf16
// out: c_t after each step, rounded once (the state itself stays fp32 in
// registers). The same instances, plans and shared bytes as kernel A.
int lstm_scan_fwd_train_wide(const void* gates, const void* wf, void* h_seq,
                             void* c_seq, int T, int B, int H, int reverse,
                             int cluster, int rows, int resident, int stages,
                             int smem_bytes, void* stream) {
  if (c_seq == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(0, 0, gates, wf, nullptr, nullptr, h_seq, c_seq, nullptr,
                  nullptr, nullptr, T, B, H, reverse, cluster, rows, resident,
                  stages, (size_t)smem_bytes, stream, nullptr);
}

// Kernel A that also writes trace [TRACE_STEPS][TRACE_POINTS] int64 (the
// clock64 readings of the first CTA's consumer warp 0; see TRACE_POINTS).
int lstm_scan_wide_trace(const void* gates, const void* wf, void* out,
                         int out_f32, int T, int B, int H, int reverse,
                         int cluster, int rows, int resident, int stages,
                         int smem_bytes, void* trace, void* stream) {
  if (trace == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(out_f32, 0, gates, wf, nullptr, nullptr, out, nullptr,
                  nullptr, nullptr, trace, T, B, H, reverse, cluster, rows,
                  resident, stages, (size_t)smem_bytes, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance of `rows` rows with the
// plan's resident k-steps and stages, for a cluster of `cluster` CTAs at H:
// *n clusters can run at once.
int lstm_scan_wide_max_clusters(int resident, int stages, int H, int cluster,
                                int rows, int* n) {
  return dispatch(0, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, 0, 0, H, 0, cluster, rows,
                  resident, stages,
                  wide_smem(H, cluster, rows, resident, stages, 4), nullptr,
                  n);
}

const char* lstm_scan_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
