// LSTM forward scans that stage their inputs in shared memory, for sm_90a.
//
// Replaces two Pallas TPU kernels:
//   * kernel E (lstm_scan_fwd_unrolled) <- lstm_unrolled / _unroll_kernel of
//     scripts/perf_lstm_unroll.py: kernel A of lstm_scan.cu (bf16 out,
//     forward) whose time loop runs in groups of K steps from one staged
//     [K, rows, 4H] gate tile, as the script's grid step runs K steps from
//     one [K, block_b, 4H] tile;
//   * kernel F (lstm_layer_fwd) <- _lstm_layer_pallas_call /
//     _lstm_layer_kernel of generative_audio_tpu/ops/pallas_lstm.py: the
//     LSTM layer with x_t @ W_ih computed inside each step, so the
//     [T, B, 4H] gates never exist. Used by lstm_layer_tm without grad.
// Both are one template beside lstm_scan.cu's, whose products, cell update
// and stores they repeat operation for operation: kernel E's h is
// bit-identical to kernel A's for the same gates. (Folding K and the
// projection into lstm_scan.cu's template itself moved the registers of
// kernels A-C, so they live here.)
//
// What it computes, per row b and step t (torch gate order i, f, g, o):
//   z   = float(gates[t, b, :]) + bf16(h_{t-1}) @ W_hh    (kernel E)
//   z   = x_t @ W_ih + bf16(h_{t-1}) @ W_hh + bias       (kernel F)
//   c_t = sigmoid(z_f) * c_{t-1} + sigmoid(z_i) * tanh(z_g)
//   h_t = sigmoid(z_o) * tanh(c_t)
// with bf16 operands and fp32 accumulation: both of kernel F's products go
// into the same fp32 accumulators, then the fp32 bias. gates [T, B, 4H]
// bf16; x [T, B, F] bf16 (F even); W_ih passed as wih_t [4H, F_pad] bf16,
// F_pad = F rounded up to 16 with zero columns; W_hh as wt [4H, H] bf16;
// bias [4H] fp32; h [T, B, H] in bf16 (or fp32 for kernel F).
//
// What bounds it on an H100. Kernel E does kernel A's work: at T = 628,
// 2304 rows, H = 384, 1.71 TFLOP of bf16 products (1.73 ms at 989 TFLOP/s)
// against 5.6 GB of gates in and h out (1.66 ms at 3.35 TB/s). Kernel F
// moves only x and h, T*rows*(F + H)*2 B, but adds 2*T*rows*F*4H of
// products: at FullSubNet+'s sub-band layers (T = 628, 2056 rows) 1.66
// TFLOP for F = 34 and 3.05 TFLOP for F = 384, bound by operations (1.68
// and 3.08 ms). As for kernel A, the serial chain of T steps is what the
// simple design pays.
//
// Design (right and simple first), on top of kernel A's (16-row blocks, a
// warp owns 8-unit groups and all four gates of its (row, unit) pairs,
// mma.sync m16n8k16, W_hh re-read from L2 every step, h double-buffered in
// shared memory as bf16):
//   * Kernel E (K = 2 or 4): at the first step of each group of K steps the
//     block copies the K steps' gate tiles into shared memory with cp.async
//     (16 B pieces) and waits for them once, so the gate loads leave the
//     serial chain. At H = 384 one step's tile is 49 KB; four fit beside h
//     only because c moves from shared memory into registers (each thread
//     owns its (row, unit) pairs; at most MAX_GROUPS unit groups per warp,
//     so H <= 512).
//   * Kernel F: x_{t+1} is copied into the second of two x tiles with
//     cp.async while step t computes; W_ih [4H, F_pad] streams from L2 as
//     W_hh does. F = 34 adds 3 k-steps to the 24 of H = 384; F = 384 adds
//     24 and a second 1.18 MB L2 stream.
//
// Plain C interface for ctypes; each function returns the cudaError_t of
// its launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include "scan_common.cuh"

namespace {

// Kernel E keeps c in registers: a warp owns at most this many 8-unit
// groups, so H <= 8 * NWARPS * MAX_GROUPS = 512.
constexpr int MAX_GROUPS = 8;

template <typename OutT>
struct StagedArgs {
  const __nv_bfloat16* gates;   // [T, B, 4H] (kernel E)
  const __nv_bfloat16* x;       // [T, B, F] (kernel F)
  const __nv_bfloat16* wih_t;   // [4H, F_pad] (kernel F)
  const float* bias;            // [4H] (kernel F)
  const __nv_bfloat16* wt;      // [4H, H]
  OutT* out;                    // [T, B, H]
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

// The gates of processing steps s .. s+K-1, rows row0 .. row0+15 -> tile
// [K][ROWS][gs] by cp.async; rows beyond B get zeros. 4H % 8 == 0.
template <int K>
__device__ __forceinline__ void stage_gates(__nv_bfloat16* tile,
                                            const __nv_bfloat16* gates, int s,
                                            int T, int B, int G4, int gs,
                                            int row0, int reverse) {
  const int per_row = G4 / 8, per_step = ROWS * per_row;
  for (int i = threadIdx.x; i < K * per_step; i += blockDim.x) {
    const int kk = i / per_step, r = (i % per_step) / per_row;
    const int col = (i % per_row) * 8, row = row0 + r;
    const int t = reverse ? T - 1 - (s + kk) : s + kk;
    __nv_bfloat16* dst = tile + (kk * ROWS + r) * gs + col;
    if (row < B)
      cp_async16(dst, gates + ((size_t)t * B + row) * G4 + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
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

// One step of one warp's unit group u: the products, then the cell update
// of the (row, unit) pairs the accumulators give this thread, as in
// lstm_scan.cu. The x-side gates come from the staged tile gk (kernel E)
// or, as x_t @ W_ih + bias, from the x tile xcur (kernel F); c lives in the
// registers cr (kernel E) or in cbuf (kernel F).
template <typename OutT, int K, bool PROJ>
__device__ __forceinline__ void step_group(
    const StagedArgs<OutT>& p, int u, int t, int row0,
    const __nv_bfloat16* hcur, __nv_bfloat16* hnext, int hs,
    const __nv_bfloat16* gk, int gs, const __nv_bfloat16* xcur, int xs,
    int fpad, float* cbuf, float (&cr)[2][2]) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int H = p.H, ksteps = H / 16;
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

  if constexpr (PROJ) {
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
      float2 gx;
      if constexpr (PROJ)
        gx = *reinterpret_cast<const float2*>(p.bias + q * H + j);
      else
        gx = load_pair(gk + r * gs + q * H + j);
      z[q][0] = gx.x + acc[q][2 * half];
      z[q][1] = gx.y + acc[q][2 * half + 1];
    }
    float hn[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& c_state = PROJ ? cbuf[r * H + j + e] : cr[half][e];
      const float c = sigmoidf_(z[1][e]) * c_state +
                      sigmoidf_(z[0][e]) * tanhf(z[2][e]);
      hn[e] = sigmoidf_(z[3][e]) * tanhf(c);
      c_state = c;
    }
    store_pair(hnext + r * hs + j, hn[0], hn[1]);
    if (row < p.B)
      store_pair(p.out + ((size_t)t * p.B + row) * H + j, hn[0], hn[1]);
  }
}

// Shared memory of one block: h (bf16, two buffers), then the K steps'
// gate tiles (kernel E), or c (fp32) and two x tiles (kernel F).
// ops/lstm.py repeats this sum to refuse a launch above the opt-in limit.
inline size_t staged_smem(int H, int K, int fpad) {
  const size_t h_tiles = 2 * ROWS * (H + PAD) * sizeof(__nv_bfloat16);
  if (K > 1)
    return h_tiles + (size_t)K * ROWS * (4 * H + PAD) * sizeof(__nv_bfloat16);
  return h_tiles + (size_t)ROWS * H * sizeof(float) +
         2 * ROWS * (fpad + PAD) * sizeof(__nv_bfloat16);
}

template <typename OutT, int K, bool PROJ>
__global__ void __launch_bounds__(NWARPS * 32)
lstm_scan_staged_kernel(const StagedArgs<OutT> p) {
  static_assert((K > 1) != PROJ, "kernel E stages gates, kernel F x");
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, T = p.T;
  const int hs = H + PAD;                                   // h row stride
  const int gs = 4 * H + PAD;                               // gate tile row stride
  const int fpad = (p.F + 15) / 16 * 16, xs = fpad + PAD;   // x tile row stride
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][ROWS][hs]
  __nv_bfloat16* gtile = hbuf + 2 * ROWS * hs;              // [K][ROWS][gs]
  float* cbuf = reinterpret_cast<float*>(hbuf + 2 * ROWS * hs);   // [ROWS][H]
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(cbuf + ROWS * H);  // [2][ROWS][xs]

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < 2 * ROWS * hs; i += blockDim.x)
    hbuf[i] = __float2bfloat16(0.0f);
  if constexpr (PROJ) {
    for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) cbuf[i] = 0.0f;
    for (int i = threadIdx.x; i < 2 * ROWS * xs; i += blockDim.x)
      xbuf[i] = __float2bfloat16(0.0f);
    __syncthreads();                  // the zeros land before the copies
    stage_x(xbuf, p.x, p.reverse ? T - 1 : 0, p.B, p.F, xs, row0);
    cp_async_wait_all();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int ngroups = H / 8;
  float creg[MAX_GROUPS][2][2] = {};  // c, kernel E

  for (int s = 0; s < T; ++s) {
    const int t = p.reverse ? T - 1 - s : s;
    const __nv_bfloat16* hcur = hbuf + (s & 1) * ROWS * hs;
    __nv_bfloat16* hnext = hbuf + ((s + 1) & 1) * ROWS * hs;

    if constexpr (K > 1) {
      if (s % K == 0) {               // the group's K gate tiles, at once
        stage_gates<K>(gtile, p.gates, s, T, p.B, 4 * H, gs, row0, p.reverse);
        cp_async_wait_all();
        __syncthreads();
      }
      const __nv_bfloat16* gk = gtile + (s % K) * ROWS * gs;
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        const int u = warp + g * NWARPS;
        if (u < ngroups)
          step_group<OutT, K, PROJ>(p, u, t, row0, hcur, hnext, hs, gk, gs,
                                    nullptr, xs, fpad, cbuf, creg[g]);
      }
    } else {
      if (s + 1 < T)                  // x of the next step, while this one computes
        stage_x(xbuf + ((s + 1) & 1) * ROWS * xs, p.x,
                p.reverse ? T - 2 - s : s + 1, p.B, p.F, xs, row0);
      const __nv_bfloat16* xcur = xbuf + (s & 1) * ROWS * xs;
      for (int u = warp; u < ngroups; u += NWARPS)
        step_group<OutT, K, PROJ>(p, u, t, row0, hcur, hnext, hs, nullptr, gs,
                                  xcur, xs, fpad, cbuf, creg[0]);
      cp_async_wait_all();
    }
    __syncthreads();
  }
}

template <typename OutT, int K, bool PROJ>
int launch(const StagedArgs<OutT>& p, void* stream) {
  const size_t smem = staged_smem(p.H, K, (p.F + 15) / 16 * 16);
  auto kernel = lstm_scan_staged_kernel<OutT, K, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(p.B));
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_layer(const void* x, const void* wih_t, const void* wt,
                 const void* bias, void* out, int T, int B, int F, int H,
                 int reverse, void* stream) {
  const StagedArgs<OutT> p{nullptr, (const __nv_bfloat16*)x,
                           (const __nv_bfloat16*)wih_t, (const float*)bias,
                           (const __nv_bfloat16*)wt, (OutT*)out,
                           T, B, H, F, reverse};
  return launch<OutT, 1, true>(p, stream);
}

}  // namespace

extern "C" {

// Kernel E. gates [T, B, 4H] bf16, wt [4H, H] bf16 -> out [T, B, H] bf16,
// forward, in groups of k = 2 or 4 steps per staged gate tile. T % k == 0,
// H a multiple of 16 and at most 512. Bit-identical to kernel A.
int lstm_scan_fwd_unrolled(const void* gates, const void* wt, void* out,
                           int T, int B, int H, int k, void* stream) {
  if (T % k != 0 || H > 8 * NWARPS * MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  const StagedArgs<__nv_bfloat16> p{
      (const __nv_bfloat16*)gates, nullptr, nullptr, nullptr,
      (const __nv_bfloat16*)wt, (__nv_bfloat16*)out, T, B, H, 0, 0};
  if (k == 2) return launch<__nv_bfloat16, 2, false>(p, stream);
  if (k == 4) return launch<__nv_bfloat16, 4, false>(p, stream);
  return (int)cudaErrorInvalidValue;
}

// Kernel F. x [T, B, F] bf16 (F even), wih_t [4H, F_pad] bf16 (zero columns
// beyond F), wt [4H, H] bf16, bias [4H] fp32 -> out [T, B, H] (bf16, or
// fp32 when out_f32). H must be a multiple of 16.
int lstm_layer_fwd(const void* x, const void* wih_t, const void* wt,
                   const void* bias, void* out, int out_f32, int T, int B,
                   int F, int H, int reverse, void* stream) {
  if (F % 2) return (int)cudaErrorInvalidValue;
  if (out_f32)
    return launch_layer<float>(x, wih_t, wt, bias, out, T, B, F, H, reverse,
                               stream);
  return launch_layer<__nv_bfloat16>(x, wih_t, wt, bias, out, T, B, F, H,
                                     reverse, stream);
}

const char* lstm_scan_staged_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
