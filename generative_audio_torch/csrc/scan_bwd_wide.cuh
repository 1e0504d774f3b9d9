// What the wide cluster backwards (csrc/lstm_scan_bwd_wide.cu, kernel D, and
// csrc/gru_scan_bwd_wide.cu, the GRU backward scan) share: the mma.sync and
// ldmatrix helpers that read A fragments out of TMA's swizzled boxes, the
// 3-D TMA load, the fences and cluster barrier halves of the dgates
// exchange through L2, and the host side of their launches (the cluster
// attribute and the tensor maps). The wide cluster forwards
// (csrc/scan_fwd_wide.cuh) take the TMA load and the host side from here
// too. Internal linkage: a source includes it once and may leave any
// unused.

#pragma once

#include <cuda.h>

#include "scan_common.cuh"

namespace {

// mma.sync m16n8k16 as the cluster backwards' (not volatile: the compiler
// may move fragment loads ahead of it; the order of the products into one
// accumulator is their data dependence).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The A fragment (16x16, row-major) of the m16 tile at `row` (lane l reads
// row row + (l & 15), columns 8 (l >> 4) .. + 7 of k-step kk) in a box of
// 64 bf16 columns, 128 bytes a row, swizzled as TMA's SWIZZLE_128B writes
// it (box 1024-byte aligned: the 16-byte piece c of row r lies at c ^ (r &
// 7)).
__device__ __forceinline__ void load_a_box(uint32_t (&a)[4], uint32_t box,
                                           int row, int kk, int lane) {
  const int r = row + (lane & 15), c = 2 * kk + (lane >> 4);
  ldmatrix_x4(a, box + r * 128 + ((c ^ (r & 7)) << 4));
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

// Generic-proxy writes to global memory become visible to (and ordered
// with) the async proxy's reads: the dgates pieces read back by TMA.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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
// query, so the library links no libcuda.
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

// A bf16 [T][B][width] array in boxes of one step's R rows x `cols`
// columns, swizzled (128-byte rows) or not; out-of-range rows and steps
// read as zero.
bool tensor_map(CUtensorMap* map, const void* base, int T, int B, int width,
                int cols, int R, bool swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)B * width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)R, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
