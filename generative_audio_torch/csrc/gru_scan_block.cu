// GRU forward scan over precomputed time-major x-side gates, one 16-row
// block per CTA, for sm_90a: the single-block route of the GRU forward for
// hidden sizes that no thread-block cluster of gru_scan.cu holds.
//
// Replaces, for those H, the same two Pallas TPU kernels of
// generative_audio_tpu/ops/pallas_lstm.py as gru_scan.cu:
//   * gru_scan_fwd_block       <- _gru_pallas_call / _gru_kernel;
//   * gru_scan_fwd_carry_block <- _gru_pallas_call_carry / _gru_carry_kernel
//     (h0 in, h_T out).
// The cluster scan keeps W_hh's column slice in shared memory, so it takes
// H up to 640 (ops/gru.py scan_hidden); the JAX kernels take any H. Above
// that, ops/gru.py pads H to 16 and launches this design, the port's first
// GRU forward (before the cluster): W_hh is read from L2 every step. It
// computes every element as the cluster kernel does (the same operands, k
// order from zero accumulators and cell expression), so at an H that both
// take they agree bit for bit.
//
// What it computes, per row b and step t (torch gate order r, z, n):
//   gh  = bf16(h_{t-1}) @ W_hh + b_hh              (fp32 accumulation and bias)
//   r   = sigmoid(x_r + gh_r),  z = sigmoid(x_z + gh_z)
//   n   = tanh(x_n + r * gh_n)
//   h_t = (1 - z) * n + z * h_{t-1}                (h_{t-1} in fp32)
// with x = float(gates[t, b, :]). gates [T, B, 3H] bf16 (b_ih already
// added), W_hh passed transposed as wt [3H, H] bf16, b_hh [3H] fp32, h
// [T, B, H] in bf16 or fp32. reverse=1 walks t from T-1 down to 0.
//
// What bounds it on an H100: the serial chain of T steps, each waiting on
// W_hh's 2 x 3H x H bytes from L2; the bytes and products of the layer are
// far below that.
//
// Design: tiles of ROWS = 16 batch rows, the time loop inside the block; a
// warp owns units 8u..8u+7 and the three n8 tiles of columns (u, H+u,
// 2H+u) of mma.sync m16n8k16, so r, z, n and the fp32 h of each (row, unit)
// sit in one thread; h_{t-1} is bf16 in shared memory, double buffered (one
// __syncthreads a step), the fp32 h and b_hh in shared memory.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_common.cuh"

namespace {

template <typename OutT, bool CARRY>
__global__ void __launch_bounds__(NWARPS * 32)
gru_scan_kernel(const __nv_bfloat16* __restrict__ gates,
                const __nv_bfloat16* __restrict__ wt,
                const float* __restrict__ bhh, const float* __restrict__ h0,
                OutT* __restrict__ out, float* __restrict__ h_T,
                int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = H + PAD;                                   // bf16 h row stride
  const int G3 = 3 * H;
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ROWS][hs]
  float* hf = reinterpret_cast<float*>(smem + 2 * ROWS * hs * sizeof(__nv_bfloat16));
  float* bias = hf + ROWS * H;                                   // [3H]

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    const int r = i / H, j = i % H, row = row0 + r;
    float h = 0.0f;
    if (CARRY && row < B) h = h0[(size_t)row * H + j];
    hbuf[r * hs + j] = __float2bfloat16(h);
    hf[r * H + j] = h;
  }
  for (int i = threadIdx.x; i < G3; i += blockDim.x) bias[i] = bhh[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int ngroups = H / 8, ksteps = H / 16;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * ROWS * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * ROWS * hs;

    for (int u = warp; u < ngroups; u += NWARPS) {
      float acc[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      for (int k = 0; k < ksteps; ++k) {
        // A fragment (16x16, row-major) of bf16 h_{t-1}
        uint32_t a[4];
        load_a(a, hcur + grp * hs + k * 16 + 2 * tq, hs);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          // B fragment (16x8, col-major) = rows of wt [3H, H]
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
        const bool valid = row < B;
        float x[3][2], gh[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float2 gx = make_float2(0.0f, 0.0f);
          if (valid)
            gx = load_pair(gates + ((size_t)t * B + row) * G3 + q * H + j);
          x[q][0] = gx.x;
          x[q][1] = gx.y;
          gh[q][0] = acc[q][2 * half] + bias[q * H + j];
          gh[q][1] = acc[q][2 * half + 1] + bias[q * H + j + 1];
        }
        float hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          hn[e] = (1.0f - zg) * ng + zg * hf[r * H + j + e];
          hf[r * H + j + e] = hn[e];
        }
        store_pair(hnext + r * hs + j, hn[0], hn[1]);
        if (valid) {
          store_pair(out + ((size_t)t * B + row) * H + j, hn[0], hn[1]);
          if (CARRY && s == T - 1)
            store_pair(h_T + (size_t)row * H + j, hn[0], hn[1]);
        }
      }
    }
    __syncthreads();
  }
}

template <typename OutT, bool CARRY>
int launch(const void* gates, const void* wt, const void* bhh, const void* h0,
           void* out, void* h_T, int T, int B, int H, int reverse,
           void* stream) {
  const size_t smem = 2 * ROWS * (H + PAD) * sizeof(__nv_bfloat16) +
                      ROWS * H * sizeof(float) + 3 * H * sizeof(float);
  auto kernel = gru_scan_kernel<OutT, CARRY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(B));
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)wt,
      (const float*)bhh, (const float*)h0, (OutT*)out, (float*)h_T, T, B, H,
      reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gates [T, B, 3H] bf16, wt [3H, H] bf16, bhh [3H] fp32 -> out [T, B, H]
// (bf16, or fp32 when out_f32). H must be a multiple of 16.
int gru_scan_fwd_block(const void* gates, const void* wt, const void* bhh,
                 void* out, int out_f32, int T, int B, int H, int reverse,
                 void* stream) {
  if (out_f32)
    return launch<float, false>(gates, wt, bhh, nullptr, out, nullptr, T, B,
                                H, reverse, stream);
  return launch<__nv_bfloat16, false>(gates, wt, bhh, nullptr, out, nullptr,
                                      T, B, H, reverse, stream);
}

// As gru_scan_fwd_block, plus h0 [B, H] fp32 in and h_T [B, H] fp32 out (the
// state after the last processed step).
int gru_scan_fwd_carry_block(const void* gates, const void* wt, const void* bhh,
                       const void* h0, void* out, void* h_T, int out_f32,
                       int T, int B, int H, int reverse, void* stream) {
  if (out_f32)
    return launch<float, true>(gates, wt, bhh, h0, out, h_T, T, B, H,
                               reverse, stream);
  return launch<__nv_bfloat16, true>(gates, wt, bhh, h0, out, h_T, T, B, H,
                                     reverse, stream);
}

const char* gru_scan_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
