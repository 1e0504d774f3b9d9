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
// one warp (see TRACE_POINTS).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Consumer warpgroups of a CTA, at most, and the threads of a CTA with the
// producer's warpgroup. Registers are handed out four warps at a time, so
// a CTA of 16 warps launches with 128 a thread; the producer's warpgroup
// gives up all but WIDE_PRODUCER_REGS of its own and the consumers take
// WIDE_CONSUMER_REGS (setmaxnreg): 12 x 152 + 4 x 56 = 16 x 128.
constexpr int WIDE_MAX_WG = 3;
constexpr int WIDE_THREADS = (WIDE_MAX_WG + 1) * 128;
constexpr int WIDE_CONSUMER_REGS = 152, WIDE_PRODUCER_REGS = 56;

// Steps of a trace, and the clock64 readings of each: consumer warp 0 of
// the first CTA at the step's start, when its products have completed,
// after the CTA's barrier (every warpgroup's products done), when the
// step's gates have arrived, after its cell, after the cluster barrier's
// wait and at the step's end (the peers' slices arrived); then the clocks
// it spent waiting for ring slots in the step.
constexpr int TRACE_STEPS = 64, TRACE_POINTS = 8;

// Bytes of one k-pair (32 columns) of a CTA's W_hh^T slice of 4 gates x U.
__host__ __device__ inline size_t pair_bytes(int U) { return (size_t)U * 256; }

// Element offset of h(unit u, row n) in the h buffer [H / 8][R][8] bf16.
__host__ __device__ inline int h_index(int u, int n, int R) {
  return ((u >> 3) * R + n) * 8 + (u & 7);
}

// Shared bytes of one CTA, in the order the kernel lays them out: 128 bytes
// of slack to align the gates to 128, one step of x-side gates [4][R][U]
// bf16 (the TMA boxes), the ring [stages][k-pair] and the resident k-pairs
// [resident / 2][k-pair], h [H / 8][R][8] bf16, and the mbarriers: the
// ring's full and empty [2][stages], the exchange's and the gates'.
size_t wide_smem(int H, int C, int R, int resident, int stages) {
  const size_t U = H / C, r = R;
  return 128 + 8 * r * U + (stages + resident / 2) * pair_bytes(U) +
         2 * r * H + 8 * (2 * stages + 2);
}

// wgmma descriptor of a K-major operand in shared memory without swizzle:
// start address, leading byte offset (between the core matrices of a k16
// step along K) and stride byte offset (between core matrices 8 rows apart
// along M or N), all >> 4.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x N] (+)= A[64 x 16] @ B[16 x N], bf16, both K-major in shared
// memory, fp32 in registers; `scale` 0 overwrites d (the first k16 step).
template <int N>
__device__ __forceinline__ void wgmma_rows(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale);

template <>
__device__ __forceinline__ void wgmma_rows<16>(float (&d)[8], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<32>(float (&d)[16], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<48>(float (&d)[24], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23},"
      " %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<64>(float (&d)[32], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<80>(float (&d)[40], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39},"
      " %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<96>(float (&d)[48], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      " %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<112>(float (&d)[56], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55},"
      " %56, %57, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<128>(float (&d)[64], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<144>(float (&d)[72], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71},"
      " %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(da), "l"(db), "r"(scale));
}

template <>
__device__ __forceinline__ void wgmma_rows<160>(float (&d)[80], uint64_t da,
                                               uint64_t db,
                                               int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79},"
      " %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(scale));
}

// The accumulators as the wgmma pipeline leaves them: the compiler may not
// move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ long long clock_now() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
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
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, KP = H / 32;
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
      reinterpret_cast<__nv_bfloat16*>(wres + (size_t)KR * pair);  // [H/8][R][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(hbuf + (size_t)H * R);  // [D]
  uint64_t* empty = full + D;                                       // [D]
  uint64_t* hfull = empty + D;                                      // [1]
  uint64_t* gfull = hfull + 1;                                      // [1]
  __nv_bfloat16* hown = hbuf + (size_t)rank * U * R;                // [U/8][R][8]

  // warps 0 .. 4 U / 16 - 1 are consumers, a warpgroup a 16 units; the
  // last warpgroup's first warp is the producer, the rest of it idle
  const int nthreads = blockDim.x, ncons = U / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool consumer = warp < ncons;
  const bool tracing = trace != nullptr && cluster_id == 0 && rank == 0 &&
                       threadIdx.x == 0;

  // this CTA's slice, k-pair after k-pair; the resident k-pairs, 16-byte copies
  const unsigned char* wsrc =
      reinterpret_cast<const unsigned char*>(wf) + (size_t)rank * KP * pair;
  for (int i = threadIdx.x; i < KR * (int)(pair / 16); i += nthreads)
    reinterpret_cast<uint4*>(wres)[i] = reinterpret_cast<const uint4*>(wsrc)[i];
  // h_{-1} in every slice, bf16 (element i is h_index(u, r, R)); zero beyond
  // the rows
  for (int i = threadIdx.x; i < H * R; i += nthreads) {
    const int u = i / (8 * R) * 8 + i % 8, r = i / 8 % R;
    float h = 0.0f;
    if (carry && r < nrows) h = h0[(size_t)(row0 + r) * H + u];
    hbuf[i] = __float2bfloat16(h);
  }
  fence_proxy_async();   // the resident k-pairs and h are read by wgmma
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      mbar_init(cta_addr(full + d), 1);
      mbar_init(cta_addr(empty + d), ncons);
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
  const bool producer = warp == ncons && lane == 0;
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
  auto cta_sync = [&]() {
    asm volatile("bar.sync 1, %0;\n" :: "r"(nthreads) : "memory");
  };
  if (!consumer) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(WIDE_PRODUCER_REGS));
    for (int s = 0; s < T; ++s) {
      // the next step's first stages, as the consumers empty this step's
      // slots: their copies run under the cell and the exchange
      if (producer) produce((s + 1) * NS + ahead);
      __syncwarp();
      asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
      cta_sync();
      asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
      if (s == T - 1 && out_f32) break;
      cta_sync();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(WIDE_CONSUMER_REGS));

  // descriptors: A, this warpgroup's 64 gate rows of a k-pair [4][4U][8]
  // (k8 groups 4U x 16 bytes apart, 8 rows 128 bytes apart); B, the k16
  // step's two unit groups of h [H / 8][R][8] (R x 16 bytes apart, 8 rows
  // 128 bytes apart)
  const uint32_t a_lbo = 64 * U, b_lbo = 16 * R;
  const uint32_t a_wg = 1024 * wg, hbase = cta_addr(hbuf);
  const uint32_t ring_a = cta_addr(ring) + a_wg, wres_a = cta_addr(wres) + a_wg;
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

    // the products of k-pair p, whose A rows lie at `a` (a shared address):
    // k-step 2p, then 2p + 1; the first overwrites the accumulators
    float acc[N / 2];
    int scale = 0;
    auto pair_mma = [&](uint32_t a, int p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_rows<N>(acc, kmajor_desc(a + 2 * kk * a_lbo, a_lbo, 128),
                      kmajor_desc(hbase + (2 * p + kk) * 2 * b_lbo, b_lbo,
                                  128),
                      scale);
        scale = 1;
      }
    };
    fence_acc<N>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int p = 0; p < KR; ++p) pair_mma(wres_a + p * pair, p);
    for (int j = 0; j < NS; ++j) {
      const int n = s * NS + j, slot = n % D;
      const long long w0 = tracing ? clock_now() : 0;
      xbar_wait(cta_addr(full + slot), (n / D) & 1);
      if (tracing) waited += clock_now() - w0;
      pair_mma(ring_a + slot * pair, KR + j);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the group of the previous k-pair has completed: its slot may be
      // refilled (so a ring needs two slots)
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (j > 0 && lane == 0) mbar_arrive(cta_addr(empty + (n - 1) % D));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<N>(acc);
    if (NS > 0 && lane == 0)
      mbar_arrive(cta_addr(empty + (s * NS + NS - 1) % D));
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 1] = clock_now();
    // this CTA's wgmma has read h_{t-1}: peers may overwrite it once all
    // have; its own slice, which only this CTA reads, once its warps have
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    cta_sync();
    if (tracing && s < TRACE_STEPS) trace[s * TRACE_POINTS + 2] = clock_now();

    // the cell, on the accumulators; bf16 h_t into the CTA's own slice
    xbar_wait(cta_addr(gfull), s & 1);      // step t's gates
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
      hown[h_index(ul, n, R)] = __float2bfloat16(h);
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
    cta_sync();            // the slice is whole; the gates tile is read
    // ... and on to each peer (rank+1, rank+2, ...): one bulk copy of the
    // slice through its last valid row, completing on the peer's barrier;
    // the next step's gates
    const uint32_t bytes = (uint32_t)(((U / 8 - 1) * R + nrows) * 16);
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
    if (!out_f32) {        // bf16 h out, 16-byte pieces of the slice
      const int chunks = U / 8;
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
      for (int i = threadIdx.x; i < nrows * chunks; i += cthreads) {
        const int r = i / chunks, g = i % chunks;
        *reinterpret_cast<uint4*>(o + ((size_t)t * B + row0 + r) * H + col0 +
                                  8 * g) =
            *reinterpret_cast<const uint4*>(hown + h_index(8 * g, r, R));
      }
    }
    if (!last) {
      xbar_wait(cta_addr(hfull), s & 1);      // the peers' slices of h_t
      if (threadIdx.x < C - 1) bulk_wait_read();   // before hown is written
    }
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

// The instances: rows a cluster (wgmma's N).
#define WIDE_INSTANCES(X) \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160)

bool rows_fit(int R) {
#define WIDE_IS(N) if (R == N) return true;
  WIDE_INSTANCES(WIDE_IS)
#undef WIDE_IS
  return false;
}

bool plan_fits(int H, int C, int R, int resident, int stages) {
  if (!((C == 8 || C == 16) && H > 0 && H % (16 * C) == 0 &&
        H / C / 16 <= WIDE_MAX_WG && rows_fit(R)))
    return false;
  return resident >= 0 && resident % 2 == 0 && resident <= H / 16 &&
         (stages == 0 || stages >= 2) && (stages == 0) == (resident == H / 16);
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
  CUtensorMap map = {};
  if (!gates_map(&map, gates, T, B, H, H / C, N))
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
      smem_bytes != wide_smem(H, C, R, resident, stages))
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
                  wide_smem(H, cluster, rows, resident, stages), nullptr, n);
}

const char* lstm_scan_wide_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
