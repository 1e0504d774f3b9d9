// What the wide cluster forwards share: csrc/lstm_scan_wide.cu (kernels A,
// B and C) and csrc/gru_scan_wide.cu (the GRU forward and carry). A CTA of
// a cluster owns U = H / C units and R batch rows; each step's product Z^T
// [4U x R] = W_hh^T slice [4U x H] . h^T [H x R] runs on wgmma m64nRk16,
// one warpgroup of four consumer warps a 16 units, both operands K-major in
// shared memory without swizzle. A unit takes four gate rows of the product
// (the GRU's fourth is a row of zeros), ordered so that one lane pair holds
// a unit's gates (see the sources). What lives here:
//   * the CTA's layout (wide_smem, WideCta): one step of x-side gates
//     [boxes][R][U] bf16 from TMA boxes (the gates' tensor map is
//     scan_bwd_wide.cuh's tensor_map), the W_hh^T ring [stages][k-pair] and
//     the resident k-pairs, the bf16 h buffer [H / 8][R][8] and the
//     mbarriers;
//   * the producer warp's ring (WideRing): stage n is k-pair KR + n % NS of
//     the slice, one bulk copy into slot n % D once the consumers have
//     emptied it, completing on the slot's full mbarrier;
//   * the products (wide_products): the resident k-pairs, then the streamed
//     ones, k ascending, each streamed k-pair one wgmma commit group whose
//     slot goes back to the producer once the next pair's group is issued;
//   * setmaxnreg 152 / 56: the producer's warpgroup hands its registers to
//     the consumers (wide_producer_steps runs the producer's side of every
//     step's barriers);
//   * the exchange (wide_send, wide_store_h, wide_wait_peers): a CTA's new
//     slice into its own buffer, then to each peer by one cp.async.bulk
//     completing on the peer's mbarrier;
//   * the clock64 trace (TRACE_STEPS x TRACE_POINTS of the first CTA's
//     consumer warp 0).
// Internal linkage: a source includes it once and may leave any unused.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "scan_bwd_wide.cuh"

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

// Bytes of one k-pair (32 columns) of a CTA's W_hh^T slice of 4 gate rows
// x U units.
__host__ __device__ inline size_t pair_bytes(int U) { return (size_t)U * 256; }

// Element offset of h(unit u, row n) in the h buffer [H / 8][R][8] bf16.
__host__ __device__ inline int h_index(int u, int n, int R) {
  return ((u >> 3) * R + n) * 8 + (u & 7);
}

// Shared bytes of one CTA, in the order the kernels lay them out: 128 bytes
// of slack to align the gates to 128, one step of x-side gates [boxes][R][U]
// bf16 (the TMA boxes: 4 for the LSTM, 3 for the GRU), the ring
// [stages][k-pair] and the resident k-pairs [resident / 2][k-pair], h
// [H / 8][R][8] bf16, and the mbarriers: the ring's full and empty
// [2][stages], the exchange's and the gates'.
size_t wide_smem(int H, int C, int R, int resident, int stages, int boxes) {
  const size_t U = H / C, r = R;
  return 128 + 2 * boxes * r * U + (stages + resident / 2) * pair_bytes(U) +
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

// One wide CTA: its place in the cluster and its shared memory as
// wide_smem lays it out for R rows and `boxes` gate boxes a step.
struct WideCta {
  int C, rank, U, KP, KR, NS, D, col0, row0, nrows;
  uint32_t pair, box;                   // bytes of a k-pair, elements of a box
  __nv_bfloat16* gx;                    // [boxes][R][U]
  unsigned char* ring;                  // [D][pair]
  unsigned char* wres;                  // [KR][pair]
  __nv_bfloat16* hbuf;                  // [H/8][R][8]
  __nv_bfloat16* hown;                  // this CTA's slice [U/8][R][8]
  uint64_t *full, *empty, *hfull, *gfull;
  const unsigned char* wsrc;            // this CTA's W_hh^T slice, packed
};

template <int R>
__device__ __forceinline__ WideCta wide_cta(unsigned char* smem_raw,
                                            const __nv_bfloat16* wf, int B,
                                            int H, int resident, int stages,
                                            int boxes) {
  cg::cluster_group cluster = cg::this_cluster();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));
  WideCta w;
  w.C = (int)cluster.num_blocks();
  w.rank = (int)cluster.block_rank();
  w.U = H / w.C;
  w.KP = H / 32;
  w.KR = resident / 2;
  w.NS = w.KP - w.KR;
  w.D = stages;
  w.col0 = w.rank * w.U;                 // first unit of this CTA
  w.row0 = (int)cluster_id * R;          // first batch row of the cluster
  w.nrows = min(R, B - w.row0);          // valid rows, at least 1
  w.pair = (uint32_t)pair_bytes(w.U);
  w.box = (uint32_t)R * w.U;
  // aligned by an offset into the shared array itself (not by a round trip
  // through an integer), so that the compiler keeps every pointer below in
  // the shared address space
  unsigned char* smem = smem_raw + ((128 - (cta_addr(smem_raw) & 127)) & 127);
  w.gx = reinterpret_cast<__nv_bfloat16*>(smem);
  w.ring = smem + (size_t)2 * boxes * w.box;
  w.wres = w.ring + (size_t)w.D * w.pair;
  w.hbuf = reinterpret_cast<__nv_bfloat16*>(w.wres + (size_t)w.KR * w.pair);
  w.full = reinterpret_cast<uint64_t*>(w.hbuf + (size_t)H * R);
  w.empty = w.full + w.D;
  w.hfull = w.empty + w.D;
  w.gfull = w.hfull + 1;
  w.hown = w.hbuf + (size_t)w.rank * w.U * R;
  w.wsrc = reinterpret_cast<const unsigned char*>(wf) +
           (size_t)w.rank * w.KP * w.pair;
  return w;
}

// The resident k-pairs (16-byte copies) and h_{-1} in every slice, bf16
// (element i is h_index(u, r, R); h0 [B, H] fp32 with `carry`, else zero;
// zero beyond the rows), then the mbarriers: the ring's (full: the
// producer's one arrival and the bytes; empty: the `ncons` consumer warps),
// the exchange's and the gates'.
__device__ __forceinline__ void wide_fill(const WideCta& w, int H, int R,
                                          const float* h0, int carry,
                                          int ncons) {
  const int nthreads = blockDim.x;
  for (int i = threadIdx.x; i < w.KR * (int)(w.pair / 16); i += nthreads)
    reinterpret_cast<uint4*>(w.wres)[i] =
        reinterpret_cast<const uint4*>(w.wsrc)[i];
  for (int i = threadIdx.x; i < H * R; i += nthreads) {
    const int u = i / (8 * R) * 8 + i % 8, r = i / 8 % R;
    float h = 0.0f;
    if (carry && r < w.nrows) h = h0[(size_t)(w.row0 + r) * H + u];
    w.hbuf[i] = __float2bfloat16(h);
  }
  fence_proxy_async();   // the resident k-pairs and h are read by wgmma
  if (threadIdx.x == 0) {
    for (int d = 0; d < w.D; ++d) {
      mbar_init(cta_addr(w.full + d), 1);
      mbar_init(cta_addr(w.empty + d), ncons);
    }
    mbar_init(cta_addr(w.hfull), 1);
    mbar_init(cta_addr(w.gfull), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Step t's x-side gates: `boxes` TMA boxes (one a gate) of the CTA's rows
// and units out of the gates [T][B][boxes * H], completing on gfull.
template <int BOXES>
__device__ __forceinline__ void wide_fetch_gates(const WideCta& w,
                                                 const CUtensorMap* map,
                                                 int H, int t) {
  xbar_expect(cta_addr(w.gfull), 2 * BOXES * w.box);
#pragma unroll
  for (int q = 0; q < BOXES; ++q)
    tma_load_3d(cta_addr(w.gx + q * w.box), map, q * H + w.col0, w.row0, t,
                cta_addr(w.gfull));
}

// The producer: stage n (n < T * NS) is k-pair KR + n % NS of the slice
// into slot n % D, once the consumers have emptied its previous stage n - D.
struct WideRing {
  int issued, total, ahead;

  __device__ __forceinline__ void produce(const WideCta& w, int upto) {
    for (upto = min(upto, total); issued < upto; ++issued) {
      const int slot = issued % w.D, use = issued / w.D;
      if (use > 0) xbar_wait(cta_addr(w.empty + slot), (use - 1) & 1);
      xbar_expect(cta_addr(w.full + slot), w.pair);
      bulk_from_global(cta_addr(w.ring + (size_t)slot * w.pair),
                       w.wsrc + (size_t)(w.KR + issued % w.NS) * w.pair,
                       w.pair, cta_addr(w.full + slot));
    }
  }
};

__device__ __forceinline__ void wide_cta_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(nthreads) : "memory");
}

// The producer's warpgroup at every step: it gives up its registers, issues
// the next step's first stages (as the consumers empty this step's slots:
// their copies run under the cell and the exchange) and meets the
// consumers at the step's barriers (the cluster barrier's arrive and wait
// and two CTA barriers; one fewer after the last step with fp32 out).
__device__ __forceinline__ void wide_producer_steps(const WideCta& w,
                                                    WideRing& ring,
                                                    bool producer, int T,
                                                    int out_f32) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
               :: "n"(WIDE_PRODUCER_REGS));
  for (int s = 0; s < T; ++s) {
    if (producer) ring.produce(w, (s + 1) * w.NS + ring.ahead);
    __syncwarp();
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    wide_cta_sync(blockDim.x);
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    if (s == T - 1 && out_f32) break;
    wide_cta_sync(blockDim.x);
  }
}

// A consumer warpgroup's descriptors: A, its 64 gate rows of a k-pair
// [4][4U][8] (k8 groups 4U x 16 bytes apart, 8 rows 128 bytes apart); B,
// the k16 step's two unit groups of h [H / 8][R][8] (R x 16 bytes apart, 8
// rows 128 bytes apart).
struct WideMma {
  uint32_t a_lbo, b_lbo, hbase, ring_a, wres_a;
};

__device__ __forceinline__ WideMma wide_mma(const WideCta& w, int R, int wg) {
  const int U = w.U;
  WideMma m;
  m.a_lbo = 64 * U;
  m.b_lbo = 16 * R;
  m.hbase = cta_addr(w.hbuf);
  m.ring_a = cta_addr(w.ring) + 1024 * wg;
  m.wres_a = cta_addr(w.wres) + 1024 * wg;
  return m;
}

// Step s's products into acc: the resident k-pairs, then the streamed ones
// from the ring (each one commit group; the slot of a k-pair goes back to
// the producer once the next pair's group is issued and the one before
// has completed, so a ring needs two slots), k ascending; the first k16
// step overwrites the accumulators. Returns with every group completed and
// the step's last slot handed back; `waited` adds the clocks spent waiting
// for slots when tracing.
template <int N>
__device__ __forceinline__ void wide_products(float (&acc)[N / 2],
                                              const WideCta& w,
                                              const WideMma& m, int s,
                                              int lane, bool tracing,
                                              long long& waited) {
  int scale = 0;
  auto pair_mma = [&](uint32_t a, int p) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_rows<N>(acc, kmajor_desc(a + 2 * kk * m.a_lbo, m.a_lbo, 128),
                    kmajor_desc(m.hbase + (2 * p + kk) * 2 * m.b_lbo, m.b_lbo,
                                128),
                    scale);
      scale = 1;
    }
  };
  fence_acc<N>(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int p = 0; p < w.KR; ++p) pair_mma(m.wres_a + p * w.pair, p);
  for (int j = 0; j < w.NS; ++j) {
    const int n = s * w.NS + j, slot = n % w.D;
    const long long w0 = tracing ? clock_now() : 0;
    xbar_wait(cta_addr(w.full + slot), (n / w.D) & 1);
    if (tracing) waited += clock_now() - w0;
    pair_mma(m.ring_a + slot * w.pair, w.KR + j);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the group of the previous k-pair has completed: its slot may be
    // refilled (so a ring needs two slots)
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (j > 0 && lane == 0) mbar_arrive(cta_addr(w.empty + (n - 1) % w.D));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<N>(acc);
  if (w.NS > 0 && lane == 0)
    mbar_arrive(cta_addr(w.empty + (s * w.NS + w.NS - 1) % w.D));
}

// Bytes of a CTA's slice through its last valid row: what each peer gets.
__device__ __forceinline__ uint32_t wide_slice_bytes(const WideCta& w, int R) {
  return (uint32_t)(((w.U / 8 - 1) * R + w.nrows) * 16);
}

// After the cell and the CTA barrier (the slice whole, the gates tile
// read): thread 0 arms the exchange's barrier for the peers' slices and
// fetches step t_next's gates; threads 0 .. C - 2 each send the slice to
// one peer (rank+1, rank+2, ...) by one bulk copy through its last valid
// row, completing on the peer's barrier.
template <int BOXES>
__device__ __forceinline__ void wide_send(const WideCta& w, int R, int H,
                                          const CUtensorMap* map,
                                          int t_next) {
  const uint32_t bytes = wide_slice_bytes(w, R);
  if (threadIdx.x == 0) {
    xbar_expect(cta_addr(w.hfull), (w.C - 1) * bytes);
    wide_fetch_gates<BOXES>(w, map, H, t_next);
  }
  if (threadIdx.x < w.C - 1) {
    const int peer = (w.rank + 1 + threadIdx.x) % w.C;
    const uint32_t src = cta_addr(w.hown);
    bulk_to_peer(peer_addr(src, peer), src, bytes,
                 peer_addr(cta_addr(w.hfull), peer));
  }
}

// bf16 h_t out [T, B, H] from the CTA's slice, 16-byte pieces, by the
// `cthreads` consumer threads.
__device__ __forceinline__ void wide_store_h(const WideCta& w, int R, int H,
                                             int B, int t, void* out,
                                             int cthreads) {
  const int chunks = w.U / 8;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  for (int i = threadIdx.x; i < w.nrows * chunks; i += cthreads) {
    const int r = i / chunks, g = i % chunks;
    *reinterpret_cast<uint4*>(o + ((size_t)t * B + w.row0 + r) * H + w.col0 +
                              8 * g) =
        *reinterpret_cast<const uint4*>(w.hown + h_index(8 * g, r, R));
  }
}

// The peers' slices of h_t have arrived; this thread's bulk copies have
// read the slice (before it is written again).
__device__ __forceinline__ void wide_wait_peers(const WideCta& w, int s) {
  xbar_wait(cta_addr(w.hfull), s & 1);
  if (threadIdx.x < w.C - 1) bulk_wait_read();
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

// A plan the wide kernels take: clusters of 8 or 16 CTAs of at most
// WIDE_MAX_WG warpgroups of 16 units, an instance's rows, an even number of
// resident k-steps and a ring of two stages at least (none only when the
// whole slice is resident).
bool plan_fits(int H, int C, int R, int resident, int stages) {
  if (!((C == 8 || C == 16) && H > 0 && H % (16 * C) == 0 &&
        H / C / 16 <= WIDE_MAX_WG && rows_fit(R)))
    return false;
  return resident >= 0 && resident % 2 == 0 && resident <= H / 16 &&
         (stages == 0 || stages >= 2) && (stages == 0) == (resident == H / 16);
}

}  // namespace
