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
// dependent steps, each a [rows, H] x [H, 4H] product that no block can
// start before the previous step's h exists.
//
// Design (right and simple first; later PRs make it fast):
//   * Rows are independent, so the grid is over tiles of ROWS = 16 batch
//     rows (one m16 MMA tile) and the serial time loop runs inside the
//     block. This replaces the Pallas grid's serial T axis. 2056 rows give
//     129 blocks for 132 SMs; a ragged last tile is masked, not padded.
//   * The block keeps its rows' h_{t-1} in shared memory as bf16 (double
//     buffered, one __syncthreads per step) and c in fp32 in shared memory.
//   * W_hh (384 x 1536 bf16 = 1.18 MB) does not fit a block's 227 KB of
//     shared memory, so every step re-reads it from global memory, where it
//     stays resident in the 50 MB L2. That L2 stream (1.18 MB per block per
//     step) is what this design pays, and is expected to bound it well
//     above the 1.5 ms floor.
//   * Products are mma.sync m16n8k16 with bf16 operands and fp32
//     accumulators. A warp owns units 8u..8u+7 and computes the four n8
//     tiles of columns (u, H+u, 2H+u, 3H+u); the accumulator layout then
//     puts the four gates of each (row, unit) in one thread, so the cell
//     update needs no exchange between threads.
//   * Considered and not taken now: a thread-block cluster that splits the
//     4H columns of W_hh across the blocks of a cluster, keeps each slice
//     in shared memory, and exchanges h through distributed shared memory
//     every step. It removes the L2 stream but adds a cluster barrier per
//     step; it is the first candidate for the PR that makes this fast.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;           // batch rows per block (one MMA m-tile)
constexpr int NWARPS = 8;          // warps per block
constexpr int HPAD = 8;            // bf16 pad per h row: spreads smem banks

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

template <typename OutT, bool CARRY, bool STREAM_C>
__global__ void __launch_bounds__(NWARPS * 32)
lstm_scan_kernel(const __nv_bfloat16* __restrict__ gates,
                 const __nv_bfloat16* __restrict__ wt,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 OutT* __restrict__ out, float* __restrict__ h_T,
                 float* __restrict__ c_T, __nv_bfloat16* __restrict__ c_seq,
                 int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hs = H + HPAD;                                  // h row stride
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
        const __nv_bfloat16* hp = hcur + grp * hs + k * 16 + 2 * tq;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(hp);
        a[1] = *reinterpret_cast<const uint32_t*>(hp + 8 * hs);
        a[2] = *reinterpret_cast<const uint32_t*>(hp + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(hp + 8 * hs + 8);
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
          if (valid) {
            gx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                gates + ((size_t)t * B + row) * G4 + q * H + j));
          }
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
  const size_t smem = 2 * ROWS * (H + HPAD) * sizeof(__nv_bfloat16) +
                      ROWS * H * sizeof(float);
  auto kernel = lstm_scan_kernel<OutT, CARRY, STREAM_C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ROWS - 1) / ROWS);
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)wt,
      (const float*)h0, (const float*)c0, (OutT*)out, (float*)h_T,
      (float*)c_T, (__nv_bfloat16*)c_seq, T, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out [T, B, H]
// (bf16, or fp32 when out_f32). H must be a multiple of 16.
int lstm_scan_fwd(const void* gates, const void* wt, void* out, int out_f32,
                  int T, int B, int H, int reverse, void* stream) {
  if (out_f32)
    return launch<float, false>(gates, wt, nullptr, nullptr, out, nullptr,
                                nullptr, nullptr, T, B, H, reverse, stream);
  return launch<__nv_bfloat16, false>(gates, wt, nullptr, nullptr, out,
                                      nullptr, nullptr, nullptr, T, B, H,
                                      reverse, stream);
}

// Kernel B. As kernel A, plus h0, c0 [B, H] fp32 in and h_T, c_T [B, H]
// fp32 out (the state after the last processed step).
int lstm_scan_fwd_carry(const void* gates, const void* wt, const void* h0,
                        const void* c0, void* out, void* h_T, void* c_T,
                        int out_f32, int T, int B, int H, int reverse,
                        void* stream) {
  if (out_f32)
    return launch<float, true>(gates, wt, h0, c0, out, h_T, c_T, nullptr, T,
                               B, H, reverse, stream);
  return launch<__nv_bfloat16, true>(gates, wt, h0, c0, out, h_T, c_T,
                                     nullptr, T, B, H, reverse, stream);
}

// Kernel C. As kernel A with bf16 output, plus c_seq [T, B, H] bf16 out:
// c_t after each step, rounded once (the state itself stays fp32 on chip).
int lstm_scan_fwd_train(const void* gates, const void* wt, void* h_seq,
                        void* c_seq, int T, int B, int H, int reverse,
                        void* stream) {
  return launch<__nv_bfloat16, false, true>(gates, wt, nullptr, nullptr, h_seq,
                                            nullptr, nullptr, c_seq, T, B, H,
                                            reverse, stream);
}

const char* lstm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
