// What the scan sources (csrc/*.cu) share: the tile constants of a block,
// the device helpers around one mma.sync m16n8k16 tile, the bulk-copy
// exchange of the cluster backwards and the W_hh^T ring of the streamed
// cluster forwards. The constants have internal linkage
// and the functions are inline, so a source may leave any unused.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int ROWS = 16;           // batch rows per block (one MMA m-tile)
constexpr int NWARPS = 8;          // warps per block
constexpr int PAD = 8;             // bf16 pad per shared row: spreads banks

// Blocks of a scan over B batch rows (the grid, and the number of per-block
// partials a backward writes).
inline int row_blocks(int B) { return (B + ROWS - 1) / ROWS; }

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two bf16 as one 32-bit word (an MMA fragment register), from shared or
// global memory (read-only path), and back to two floats.
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A fragment (16x16, row-major) of a bf16 tile in shared memory
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p,
                                       int stride) {
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 8);
}

// Rows row0..row0+15 of src[t] ([B, H] bf16) -> tile [ROWS][hs]; zero where
// the row is beyond B or `zero` is set. 16-byte copies: H % 8 == 0.
__device__ __forceinline__ void load_h_tile(__nv_bfloat16* tile,
                                            const __nv_bfloat16* src, int t,
                                            int row0, int B, int H, int hs,
                                            bool zero) {
  const int per_row = H / 8;
  for (int i = threadIdx.x; i < ROWS * per_row; i += blockDim.x) {
    const int r = i / per_row, j = (i % per_row) * 8, row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!zero && row < B)
      v = *reinterpret_cast<const uint4*>(src + ((size_t)t * B + row) * H + j);
    *reinterpret_cast<uint4*>(tile + r * hs + j) = v;
  }
}

// ---- the dgates exchange of the cluster backwards: bulk copies ------------
// A CTA copies its slice into a peer's shared memory with one
// cp.async.bulk (shared::cta to shared::cluster); the copy completes on an
// mbarrier in the peer, which waits for the bytes of all its peers.

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory location in the CTA of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void xbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" :: "r"(bar) : "memory");
}

// The barrier's one arrival of a phase, expecting `bytes` from the peers.
__device__ __forceinline__ void xbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void xbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Writes of this thread to shared memory become visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from src (this CTA) to dst in a peer, completing
// on the peer's barrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      "cp.async.bulk.commit_group;\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait until this thread's bulk copies have read their source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- the W_hh^T ring of the streamed cluster forwards ----------------------
// One producer thread copies a stage of the slice from global memory with one
// cp.async.bulk that completes on the stage's `full` barrier; the consumer
// warps wait on it and, once their fragments are in registers, arrive on the
// stage's `empty` barrier, which the producer waits on before it refills the
// slot.

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// `bytes` (a multiple of 16) from global memory to dst (this CTA's shared
// memory, 16-byte aligned), completing on the barrier `bar` of this CTA.
__device__ __forceinline__ void bulk_from_global(uint32_t dst, const void* src,
                                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
