// The LSTM layer with the input projection inside the scan, one 16-row block
// per CTA, for sm_90a: the single-block route of kernel F for hidden sizes
// that no thread-block cluster of lstm_scan_staged.cu holds.
//
// Replaces, for those H, the same Pallas TPU kernel as lstm_scan_staged.cu's
// kernel F: _lstm_layer_pallas_call / _lstm_layer_kernel of
// generative_audio_tpu/ops/pallas_lstm.py. The cluster keeps W_hh's column
// slice in shared memory, so it takes H up to 512 (ops/lstm.py
// layer_route); the JAX kernel takes any H. Above that, ops/lstm.py pads H
// to 16 and launches this design, the port's first kernel F (before the
// cluster): W_hh and W_ih are read from L2 every step, so a block needs only
// two 16-row bf16 h tiles, 16 fp32 rows of c and two x tiles. It computes
// every element as the cluster does (the same operands, the x k-steps and
// then the h k-steps from zero accumulators, then the fp32 bias, and the
// same cell expression), so at an H that both take they agree bit for bit.
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = x_t @ W_ih + bf16(h_{t-1}) @ W_hh + bias         (fp32 accumulation)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// x [T, B, F] bf16 (F even); W_ih passed as wih_t [4H, F_pad] bf16, F_pad =
// F rounded up to 16 with zero columns; W_hh as wt [4H, H] bf16; bias [4H]
// fp32; h [T, B, H] in bf16 or fp32. reverse=1 walks t from T-1 down to 0.
//
// What bounds it on an H100: the serial chain of T steps, each waiting on
// W_hh's and W_ih's 2 x 4H x (H + F) bytes from L2 (at H = 384 about 62 us a
// step for F = 34 and 140 us for F = 384 on the card); the bytes and
// products of the layer (1.7-3.1 ms at FullSubNet+'s sub-band layers) are
// far below that.
//
// Design: the grid is over tiles of ROWS = 16 batch rows and the serial time
// loop runs inside the block; a warp owns units 8u..8u+7 and the four n8
// tiles of columns (u, H+u, 2H+u, 3H+u) of mma.sync m16n8k16, so the four
// gates of each (row, unit) are in one thread; x_{t+1} is copied into the
// second of two x tiles with cp.async while step t computes; h_{t-1} is bf16
// in shared memory, double buffered (one __syncthreads a step), c fp32 in
// shared memory.
//
// Plain C interface for ctypes; the entry returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_common.cuh"

namespace {

struct LayerArgs {
  const __nv_bfloat16* x;       // [T, B, F]
  const __nv_bfloat16* wih_t;   // [4H, F_pad]
  const float* bias;            // [4H]
  const __nv_bfloat16* wt;      // [4H, H]
  int T, B, H, F, reverse;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x_t of rows row0 .. row0+15 -> tile [ROWS][xs] by cp.async: 16 B pieces
// when F % 8 == 0, else 4 B (F is even). Columns F .. F_pad-1 and rows
// beyond B are not written: they keep the zeros the tile started with.
__device__ __forceinline__ void stage_x(__nv_bfloat16* tile,
                                        const __nv_bfloat16* x, int t, int B,
                                        int F, int xs, int row0) {
  const int w = (F % 8 == 0) ? 8 : 2, per_row = F / w;
  for (int i = threadIdx.x; i < ROWS * per_row; i += blockDim.x) {
    const int r = i / per_row, f = (i % per_row) * w, row = row0 + r;
    if (row >= B) continue;
    const __nv_bfloat16* src = x + ((size_t)t * B + row) * F + f;
    if (w == 8)
      cp_async16(tile + r * xs + f, src);
    else
      cp_async4(tile + r * xs + f, src);
  }
}

// One step of one warp's unit group u: x_t @ W_ih, then bf16(h_{t-1}) @
// W_hh into the same accumulators, then the bias and the cell update of the
// (row, unit) pairs the accumulators give this thread.
template <typename OutT>
__device__ __forceinline__ void step_group(const LayerArgs& p, OutT* out,
                                           int u, int t, int row0,
                                           const __nv_bfloat16* hcur,
                                           __nv_bfloat16* hnext, int hs,
                                           const __nv_bfloat16* xcur, int xs,
                                           int fpad, float* cbuf) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int H = p.H, ksteps = H / 16;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

  for (int k = 0; k < fpad / 16; ++k) {
    // A fragment of bf16 x_t, B fragment = rows of wih_t [4H, F_pad]
    uint32_t a[4];
    load_a(a, xcur + grp * xs + k * 16 + 2 * tq, xs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat16* wp =
          p.wih_t + (size_t)(q * H + 8 * u + grp) * fpad + k * 16 + 2 * tq;
      const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
      const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
      mma_bf16_16816(acc[q], a, b0, b1);
    }
  }
  for (int k = 0; k < ksteps; ++k) {
    // A fragment (16x16, row-major) of bf16 h_{t-1}
    uint32_t a[4];
    load_a(a, hcur + grp * hs + k * 16 + 2 * tq, hs);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // B fragment (16x8, col-major) = rows of wt [4H, H]
      const __nv_bfloat16* wp =
          p.wt + (size_t)(q * H + 8 * u + grp) * H + k * 16 + 2 * tq;
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
    float z[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 gx = *reinterpret_cast<const float2*>(p.bias + q * H + j);
      z[q][0] = gx.x + acc[q][2 * half];
      z[q][1] = gx.y + acc[q][2 * half + 1];
    }
    float hn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& c_state = cbuf[r * H + j + e];
      const float c = sigmoidf_(z[1][e]) * c_state +
                      sigmoidf_(z[0][e]) * tanhf(z[2][e]);
      hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
      c_state = c;
    }
    store_pair(hnext + r * hs + j, hn[0], hn[1]);
    if (row < p.B)
      store_pair(out + ((size_t)t * p.B + row) * H + j, hn[0], hn[1]);
  }
}

// Shared memory of one block: h (bf16, two buffers), c (fp32) and two x
// tiles of F_pad columns. ops/lstm.py block_layer_smem_bytes repeats this
// sum to refuse a launch above the opt-in limit.
inline size_t layer_block_smem(int H, int fpad) {
  return 2 * ROWS * (H + PAD) * sizeof(__nv_bfloat16) +
         (size_t)ROWS * H * sizeof(float) +
         2 * ROWS * (fpad + PAD) * sizeof(__nv_bfloat16);
}

template <typename OutT>
__global__ void __launch_bounds__(NWARPS * 32)
lstm_layer_block_kernel(const LayerArgs p, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, T = p.T;
  const int hs = H + PAD;                                   // h row stride
  const int fpad = (p.F + 15) / 16 * 16, xs = fpad + PAD;   // x tile row stride
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ROWS][hs]
  float* cbuf = reinterpret_cast<float*>(hbuf + 2 * ROWS * hs);   // [ROWS][H]
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(cbuf + ROWS * H);  // [2][ROWS][xs]

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < 2 * ROWS * hs; i += blockDim.x)
    hbuf[i] = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) cbuf[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * ROWS * xs; i += blockDim.x)
    xbuf[i] = __float2bfloat16(0.0f);
  __syncthreads();                    // the zeros land before the copies
  stage_x(xbuf, p.x, p.reverse ? T - 1 : 0, p.B, p.F, xs, row0);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int ngroups = H / 8;
  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * ROWS * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * ROWS * hs;
    if (s + 1 < T)                    // x of the next step, while this one computes
      stage_x(xbuf + ((s + 1) & 1) * ROWS * xs, p.x,
              p.reverse ? T - 2 - s : s + 1, p.B, p.F, xs, row0);
    const __nv_bfloat16* xcur = xbuf + (s & 1) * ROWS * xs;
    for (int u = warp; u < ngroups; u += NWARPS)
      step_group<OutT>(p, out, u, t, row0, hcur, hnext, hs, xcur, xs, fpad,
                       cbuf);
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename OutT>
int launch(const LayerArgs& p, void* out, void* stream) {
  const size_t smem = layer_block_smem(p.H, (p.F + 15) / 16 * 16);
  auto kernel = lstm_layer_block_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(p.B));
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(p, (OutT*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel F, single blocks. x [T, B, F] bf16 (F even), wih_t [4H, F_pad] bf16
// (zero columns beyond F), wt [4H, H] bf16, bias [4H] fp32 -> out [T, B, H]
// (bf16, or fp32 when out_f32). H must be a multiple of 16.
int lstm_layer_fwd_block(const void* x, const void* wih_t, const void* wt,
                         const void* bias, void* out, int out_f32, int T,
                         int B, int F, int H, int reverse, void* stream) {
  if (F % 2 || H <= 0 || H % 16) return (int)cudaErrorInvalidValue;
  const LayerArgs p{(const __nv_bfloat16*)x, (const __nv_bfloat16*)wih_t,
                    (const float*)bias, (const __nv_bfloat16*)wt,
                    T, B, H, F, reverse};
  if (out_f32) return launch<float>(p, out, stream);
  return launch<__nv_bfloat16>(p, out, stream);
}

const char* lstm_layer_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
