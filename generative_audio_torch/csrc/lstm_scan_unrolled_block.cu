// Kernel E's single-block route, for sm_90a: the LSTM forward inference
// scan whose x-side gates are staged K steps ahead in shared memory, for
// hidden sizes that no thread-block cluster of lstm_scan_staged.cu holds.
//
// Replaces, for those H, lstm_unrolled / _unroll_kernel of
// scripts/perf_lstm_unroll.py, as lstm_scan_staged.cu's kernel E does below
// them: the script's grid step runs K steps from one [K, block_b, 4H] gates
// tile. The cluster keeps W_hh's column slice beside a ring of K-step gate
// tiles in shared memory, which no cluster holds above H = 512
// (ops/lstm.py unrolled_route); the JAX kernel takes any H. This design is
// lstm_scan_block.cu's single block (W_hh read from L2 every step, h and c
// in shared memory; lstm_scan_fwd_block), whose every element it computes
// with the same operands, k order from zero accumulators and cell
// expression, so that at the same H (padded to 16) the two agree bit for
// bit.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// gates [T, B, 4H] bf16, W_hh as wt [4H, H] bf16, h [T, B, H] bf16, forward
// only, T a multiple of K.
//
// What bounds it on an H100: as lstm_scan_fwd_block, the serial chain of T
// steps, each waiting on W_hh's 2 x 4H x H bytes from L2; the gates it
// stages leave that chain.
//
// Design:
//   * A block owns RB = 16, 8 or 4 batch rows (the caller picks the most
//     whose shared memory fits) and runs the time loop; a warp owns 8-unit
//     groups and the four n8 tiles of columns (u, H+u, 2H+u, 3H+u) of
//     mma.sync m16n8k16, as in lstm_scan_block.cu. Below 16 rows the m16
//     tile's other rows of h stay zero and their accumulators are not
//     used: a product row depends on its own A row only.
//   * The gates: a tile of K step slots [K][RB][4H] bf16. Step s reads slot
//     s % K; as soon as every warp has read it (the step's closing
//     __syncthreads), the slot is refilled with the gates of step s + K by
//     cp.async (16-byte pieces; rows beyond B are zeros, written once), so
//     the gates arrive K steps ahead and their loads leave the serial
//     chain. Each thread waits for its own copies of the next step before
//     that barrier, which publishes them.
//   * Shared memory: two bf16 h tiles [16][H + 8], fp32 c [RB][H] and the
//     gates tile: 64 H + 512 + 4 RB H + 8 K RB H bytes.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_common.cuh"

namespace {

// Shared bytes of one block of RB rows with K steps of gates.
size_t unrolled_block_smem(int H, int RB, int K) {
  return 2 * (size_t)ROWS * (H + PAD) * 2 + (size_t)RB * H * 4 +
         (size_t)K * RB * 4 * H * 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int K>
__global__ void __launch_bounds__(NWARPS * 32)
lstm_unrolled_block_kernel(const __nv_bfloat16* __restrict__ gates,
                           const __nv_bfloat16* __restrict__ wt,
                           __nv_bfloat16* __restrict__ out, int T, int B,
                           int H, int RB) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = H + PAD, G4 = 4 * H;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ROWS][hs]
  float* cbuf = reinterpret_cast<float*>(hbuf + 2 * ROWS * hs);   // [RB][H]
  __nv_bfloat16* gtile = reinterpret_cast<__nv_bfloat16*>(cbuf + RB * H);  // [K][RB][4H]

  const int row0 = blockIdx.x * RB;
  const int nvalid = min(RB, B - row0);       // rows of this block within B
  for (int i = threadIdx.x; i < 2 * ROWS * hs; i += blockDim.x)
    hbuf[i] = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < RB * H; i += blockDim.x) cbuf[i] = 0.0f;
  // rows beyond B read zero gates in every slot
  const int per_row = G4 / 8;
  for (int i = threadIdx.x; i < K * RB * per_row; i += blockDim.x) {
    const int r = i / per_row % RB;
    if (r >= nvalid)
      *reinterpret_cast<uint4*>(gtile + (size_t)i * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the gates of step s into slot s % K (this thread's pieces), one group
  auto stage = [&](int s) {
    if (s < T) {
      __nv_bfloat16* slot = gtile + (size_t)(s % K) * RB * G4;
      for (int i = threadIdx.x; i < nvalid * per_row; i += blockDim.x) {
        const int r = i / per_row, col = (i % per_row) * 8;
        cp_async16(slot + r * G4 + col,
                   gates + ((size_t)s * B + row0 + r) * G4 + col);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < K; ++s) stage(s);
  cp_async_wait<K - 1>();                     // step 0's gates
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int ngroups = H / 8, ksteps = H / 16;

  for (int s = 0; s < T; ++s) {
    const __nv_bfloat16* hcur = hbuf + (s & 1) * ROWS * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * ROWS * hs;
    const __nv_bfloat16* gk = gtile + (size_t)(s % K) * RB * G4;

    for (int u = warp; u < ngroups; u += NWARPS) {
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      for (int k = 0; k < ksteps; ++k) {
        // A fragment (16x16, row-major) of bf16 h_{t-1}
        uint32_t a[4];
        load_a(a, hcur + grp * hs + k * 16 + 2 * tq, hs);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // B fragment (16x8, col-major) = rows of wt [4H, H]
          const __nv_bfloat16* wp =
              wt + (size_t)(q * H + 8 * u + grp) * H + k * 16 + 2 * tq;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
          mma_bf16_16816(acc[q], a, b0, b1);
        }
      }

      // accumulator (half, e): row grp + 8*half, unit 8u + 2*tq + e
      const int j = 8 * u + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = grp + 8 * half, row = row0 + r;
        if (r >= RB) continue;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 gx = load_pair(gk + r * G4 + q * H + j);
          z[q][0] = gx.x + acc[q][2 * half];
          z[q][1] = gx.y + acc[q][2 * half + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cbuf[r * H + j + e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cbuf[r * H + j + e] = c;
        }
        store_pair(hnext + r * hs + j, hn[0], hn[1]);
        if (r < nvalid)
          store_pair(out + ((size_t)s * B + row) * H + j, hn[0], hn[1]);
      }
    }
    cp_async_wait<K - 2>();                   // this thread's gates of step s+1
    __syncthreads();   // h_t is in hnext, slot s % K is read, step s+1's gates are in
    stage(s + K);      // refill the slot just read
  }
  cp_async_wait<0>();
}

template <int K>
int launch(const void* gates, const void* wt, void* out, int T, int B, int H,
           int RB, void* stream) {
  const size_t smem = unrolled_block_smem(H, RB, K);
  auto kernel = lstm_unrolled_block_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + RB - 1) / RB);
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)wt,
      (__nv_bfloat16*)out, T, B, H, RB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel E, single blocks. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out
// [T, B, H] bf16, forward, the gates staged k = 2 or 4 steps ahead (T % k
// == 0), `rows` = 16, 8 or 4 batch rows a block; H a multiple of 16;
// smem_bytes must be the layout's (ops/lstm.py unrolled_block_smem_bytes).
// Bit-identical to lstm_scan_fwd_block.
int lstm_scan_fwd_unrolled_block(const void* gates, const void* wt, void* out,
                                 int T, int B, int H, int k, int rows,
                                 int smem_bytes, void* stream) {
  if (H <= 0 || H % 16 || (k != 2 && k != 4) || T % k != 0 ||
      (rows != 16 && rows != 8 && rows != 4) ||
      (size_t)smem_bytes != unrolled_block_smem(H, rows, k))
    return (int)cudaErrorInvalidValue;
  if (k == 2) return launch<2>(gates, wt, out, T, B, H, rows, stream);
  return launch<4>(gates, wt, out, T, B, H, rows, stream);
}

const char* lstm_scan_unrolled_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
