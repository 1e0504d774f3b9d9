// LSTM forward scan over precomputed time-major gates, one 16-row block per
// CTA, for sm_90a: the single-block route of kernels A, B and C for hidden
// sizes that no thread-block cluster of lstm_scan.cu holds.
//
// Replaces, for those H, the same three Pallas TPU kernels of
// generative_audio_tpu/ops/pallas_lstm.py as lstm_scan.cu:
//   * lstm_scan_fwd_block       <- _lstm_pallas_call / _lstm_kernel;
//   * lstm_scan_fwd_carry_block <- _lstm_pallas_call_carry /
//     _lstm_carry_kernel (h0, c0 in; h_T, c_T out);
//   * lstm_scan_fwd_train_block <- _lstm_pallas_call_train /
//     _lstm_train_kernel (also the bf16 c sequence).
// The cluster scans keep W_hh's column slice in shared memory, so they take
// H up to 512 (ops/lstm.py scan_hidden); the JAX kernels take any H. Above
// that, ops/lstm.py pads H to 16 and launches this design, which is the
// port's first forward (before the cluster): W_hh is read from L2 every
// step, so it needs only 2 x 16 bf16 rows of h and 16 fp32 rows of c in
// shared memory. It computes every element as the cluster kernels do (the
// same operands, k order from zero accumulators and cell expression), so at
// an H that both take they agree bit for bit.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// gates [T, B, 4H] bf16, W_hh passed transposed as wt [4H, H] bf16 (torch's
// weight_hh layout), h [T, B, H] in bf16 or fp32. reverse=1 walks t from
// T-1 down to 0 (an index flip; nothing is copied).
//
// What bounds it on an H100: the serial chain of T steps, each waiting on
// W_hh's 2 x 4H x H bytes from L2 (about 66 us a step at H = 384 on the
// card); the bytes and products of the layer (about 1.5 ms each at the
// serving shape) are far below that.
//
// Design: rows are independent, so the grid is over tiles of ROWS = 16
// batch rows and the serial time loop runs inside the block; a warp owns
// units 8u..8u+7 and the four n8 tiles of columns (u, H+u, 2H+u, 3H+u) of
// mma.sync m16n8k16, so the four gates of each (row, unit) are in one
// thread; h_{t-1} is bf16 in shared memory, double buffered (one
// __syncthreads a step), c fp32 in shared memory.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_common.cuh"

namespace {

template <typename OutT, bool CARRY, bool STREAM_C>
__global__ void __launch_bounds__(NWARPS * 32)
lstm_scan_kernel(const __nv_bfloat16* __restrict__ gates,
                 const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 OutT* __restrict__ out, float* __restrict__ h_T,
                 float* __restrict__ c_T, __nv_bfloat16* __restrict__ c_seq,
                 int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = H + PAD;                                   // h row stride
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ROWS][hs]
  float* cbuf = reinterpret_cast<float*>(smem + 2 * ROWS * hs * sizeof(__nv_bfloat16));

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    const int r = i / H, j = i % H, row = row0 + r;
    float h = 0.0f, c = 0.0f;
    if (CARRY && row < B) {
      h = h0[(size_t)row * H + j];
      c = c0[(size_t)row * H + j];
    }
    hbuf[r * hs + j] = __float2bfloat16(h);
    cbuf[r * H + j] = c;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int G4 = 4 * H, ngroups = H / 8, ksteps = H / 16;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * ROWS * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * ROWS * hs;

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
        const bool valid = row < B;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 gx = make_float2(0.0f, 0.0f);
          if (valid)
            gx = load_pair(gates + ((size_t)t * B + row) * G4 + q * H + j);
          z[q][0] = gx.x + acc[q][2 * half];
          z[q][1] = gx.y + acc[q][2 * half + 1];
        }
        float hn[2], cn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c = sigmoidf_(z[1][e]) * cbuf[r * H + j + e] +
                          sigmoidf_(z[0][e]) * tanhf(z[2][e]);
          cn[e] = c;
          hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
          cbuf[r * H + j + e] = c;
        }
        store_pair(hnext + r * hs + j, hn[0], hn[1]);
        if (valid) {
          store_pair(out + ((size_t)t * B + row) * H + j, hn[0], hn[1]);
          if (STREAM_C)
            store_pair(c_seq + ((size_t)t * B + row) * H + j, cn[0], cn[1]);
          if (CARRY && s == T - 1) {
            store_pair(h_T + (size_t)row * H + j, hn[0], hn[1]);
            store_pair(c_T + (size_t)row * H + j, cn[0], cn[1]);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename OutT, bool CARRY, bool STREAM_C = false>
int launch(const void* gates, const void* wt, const void* h0, const void* c0,
           void* out, void* h_T, void* c_T, void* c_seq, int T, int B, int H,
           int reverse, void* stream) {
  const size_t smem = 2 * ROWS * (H + PAD) * sizeof(__nv_bfloat16) +
                      ROWS * H * sizeof(float);
  auto kernel = lstm_scan_kernel<OutT, CARRY, STREAM_C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(B));
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)wt,
      (const float*)h0, (const float*)c0, (OutT*)out, (float*)h_T,
      (float*)c_T, (__nv_bfloat16*)c_seq, T, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A, single blocks. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out [T, B, H]
// (bf16, or fp32 when out_f32). H must be a multiple of 16.
int lstm_scan_fwd_block(const void* gates, const void* wt, void* out, int out_f32,
                  int T, int B, int H, int reverse, void* stream) {
  if (out_f32)
    return launch<float, false>(gates, wt, nullptr, nullptr, out, nullptr,
                                nullptr, nullptr, T, B, H, reverse, stream);
  return launch<__nv_bfloat16, false>(gates, wt, nullptr, nullptr, out,
                                      nullptr, nullptr, nullptr, T, B, H,
                                      reverse, stream);
}

// Kernel B, single blocks. As kernel A, plus h0, c0 [B, H] fp32 in and h_T, c_T [B, H]
// fp32 out (the state after the last processed step).
int lstm_scan_fwd_carry_block(const void* gates, const void* wt, const void* h0,
                        const void* c0, void* out, void* h_T, void* c_T,
                        int out_f32, int T, int B, int H, int reverse,
                        void* stream) {
  if (out_f32)
    return launch<float, true>(gates, wt, h0, c0, out, h_T, c_T, nullptr, T,
                               B, H, reverse, stream);
  return launch<__nv_bfloat16, true>(gates, wt, h0, c0, out, h_T, c_T,
                                     nullptr, T, B, H, reverse, stream);
}

// Kernel C, single blocks. As kernel A with bf16 output, plus c_seq [T, B, H] bf16 out:
// c_t after each step, rounded once (the state itself stays fp32 on chip).
int lstm_scan_fwd_train_block(const void* gates, const void* wt, void* h_seq,
                        void* c_seq, int T, int B, int H, int reverse,
                        void* stream) {
  return launch<__nv_bfloat16, false, true>(gates, wt, nullptr, nullptr, h_seq,
                                            nullptr, nullptr, c_seq, T, B, H,
                                            reverse, stream);
}

const char* lstm_scan_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
