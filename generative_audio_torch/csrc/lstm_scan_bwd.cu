// LSTM backward scan over time-major residuals, for sm_90a.
//
// Kernel D (lstm_scan_bwd) replaces the Pallas TPU kernel
// _lstm_pallas_call_bwd / _lstm_bwd_kernel of
// generative_audio_tpu/ops/pallas_lstm.py. It is the backward of the scan in
// lstm_scan.cu (kernel C wrote its residuals h_seq and c_seq).
//
// What it computes. The forward processed positions p = 0..T-1 (array time
// t = p, or T-1-p with reverse). This kernel walks p = T-1..0 per tile of
// batch rows, with dh and dc (fp32) kept on chip and zero at the start:
//   h_prev, c_prev = h_seq, c_seq one processing step earlier; zero at p = 0
//   z      = float(gates[t]) + h_prev(bf16) @ W_hh              (fp32 acc)
//   i,f,o  = sigmoid(z_i, z_f, z_o); g = tanh(z_g); tc = tanh(float(c_seq[t]))
//   dh_tot = float(gout[t]) + dh
//   dc_tot = dc + dh_tot * o * (1 - tc^2)
//   dgates = [dc_tot*g*i*(1-i), dc_tot*c_prev*f*(1-f),
//             dc_tot*i*(1-g^2), dh_tot*tc*o*(1-o)]
//   dgates[t] = bf16(dgates);  dc = dc_tot * f
//   dh = bf16(dgates) @ W_hh^T                                  (fp32 acc)
// gates, dgates [T, B, 4H] bf16 (torch gate order i, f, g, o); h_seq, c_seq,
// gout [T, B, H] bf16. W_hh comes in both layouts: wt [4H, H] (torch's
// weight_hh, the B operand of the first product, as in lstm_scan.cu) and
// w [H, 4H] (the 4H axis contiguous, the B operand of the second). dW_hh is
// not accumulated here: the caller contracts h_seq, shifted by one
// processing step, against dgates in one large matmul.
//
// What bounds it on an H100. At the training shape (batch 18 x 3.072 s with
// drop_band 2: T = 195, 2304 rows, H = 384) one layer does
// 2 * 2*T*rows*H*4H = 1.06 TFLOP of bf16 products (1.07 ms at 989 TFLOP/s)
// and must move T*rows*(4H + H + H + H + 4H)*2 B = 3.8 GB (1.13 ms at
// 3.35 TB/s): it sits at the ridge, bytes slightly ahead. As in the
// forward, the serial chain of T steps, each now two dependent products, is
// what the simple design pays.
//
// Design (right and simple first):
//   * Tiles of ROWS = 16 batch rows per block, the time loop inside the
//     block, 8 warps; a ragged last tile is masked, not padded, and rows
//     beyond B write nothing.
//   * First product: the forward's layout. A warp owns units 8u..8u+7 and
//     computes the four n8 tiles of columns (u, H+u, 2H+u, 3H+u) with
//     mma.sync m16n8k16, so one thread holds all four gates of its (row,
//     unit) pairs, and c_prev, c_t, gout, dh and dc, which are all per (row,
//     unit), need no exchange between threads. h_prev comes from h_seq in
//     global memory into shared memory (it is bf16 already).
//   * Second product: it contracts over 4H, so every warp must see the
//     whole bf16 dgates tile: 16 x (4H + 8) x 2 B = 49 KB of shared memory
//     at H = 384, and a second __syncthreads per step. A warp owns pairs of
//     n8 tiles (16 output units) and reads B fragments from w [H, 4H] in
//     L2; the result goes to a fp32 dh tile in shared memory because the
//     accumulator layout gives the (row, unit) pairs to other threads than
//     the first product's.
//   * The next step's h_prev is copied into shared memory during the second
//     product (nothing reads that buffer then), so a step has two block
//     barriers, not three.
//   * Both weight copies (1.18 MB each) stay in L2 and are re-read every
//     step, as W_hh is in the forward.
//
// Plain C interface for ctypes; the function returns the cudaError_t of its
// launch (0 on success). The launch goes to the caller's stream and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;           // batch rows per block (one MMA m-tile)
constexpr int NWARPS = 8;          // warps per block
constexpr int PAD = 8;             // bf16 pad per shared row: spreads banks

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

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

__global__ void __launch_bounds__(NWARPS * 32)
lstm_scan_bwd_kernel(const __nv_bfloat16* __restrict__ gates,
                     const __nv_bfloat16* __restrict__ h_seq,
                     const __nv_bfloat16* __restrict__ c_seq,
                     const __nv_bfloat16* __restrict__ gout,
                     const __nv_bfloat16* __restrict__ wt,   // [4H, H]
                     const __nv_bfloat16* __restrict__ w,    // [H, 4H]
                     __nv_bfloat16* __restrict__ dgates,
                     int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G4 = 4 * H;
  const int hs = H + PAD;                                   // h_prev row stride
  const int gs = G4 + PAD;                                  // dgates row stride
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [ROWS][hs]
  __nv_bfloat16* dgbuf = hbuf + ROWS * hs;                         // [ROWS][gs]
  float* dhbuf = reinterpret_cast<float*>(dgbuf + ROWS * gs);      // [ROWS][H]
  float* dcbuf = dhbuf + ROWS * H;                                 // [ROWS][H]

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    dhbuf[i] = 0.0f;
    dcbuf[i] = 0.0f;
  }
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it
  const int step = reverse ? 1 : -1;            // t(p-1) = t(p) + step
  {
    const int t = reverse ? 0 : T - 1;
    load_h_tile(hbuf, h_seq, t + step, row0, B, H, hs, T == 1);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int ngroups = H / 8, npairs = H / 16;

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const bool first = (s == T - 1);            // p == 0: zero h_prev, c_prev
    const int tprev = t + step;

    // ---- gates recompute and the elementwise backward -> dgates ---------
    for (int u = warp; u < ngroups; u += NWARPS) {
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      for (int k = 0; k < H / 16; ++k) {
        uint32_t a[4];
        load_a(a, hbuf + grp * hs + k * 16 + 2 * tq, hs);
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
        const size_t at = ((size_t)t * B + row) * H + j;
        float z[4][2];
        float2 ct = make_float2(0.0f, 0.0f), cp = ct, go = ct;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 gx = make_float2(0.0f, 0.0f);
          if (valid)
            gx = load_pair(gates + ((size_t)t * B + row) * G4 + q * H + j);
          z[q][0] = gx.x + acc[q][2 * half];
          z[q][1] = gx.y + acc[q][2 * half + 1];
        }
        if (valid) {
          ct = load_pair(c_seq + at);
          go = load_pair(gout + at);
          if (!first) cp = load_pair(c_seq + ((size_t)tprev * B + row) * H + j);
        }
        const float c_t[2] = {ct.x, ct.y}, c_prev[2] = {cp.x, cp.y},
                    g_out[2] = {go.x, go.y};
        float dg[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gi = sigmoidf_(z[0][e]), gf = sigmoidf_(z[1][e]),
                      gg = tanhf(z[2][e]), og = sigmoidf_(z[3][e]);
          const float tc = tanhf(c_t[e]);
          const float dh_tot = g_out[e] + dhbuf[r * H + j + e];
          const float dc_tot =
              dcbuf[r * H + j + e] + dh_tot * og * (1.0f - tc * tc);
          dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
          dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
          dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
          dg[3][e] = dh_tot * tc * og * (1.0f - og);
          dcbuf[r * H + j + e] = dc_tot * gf;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
          *reinterpret_cast<__nv_bfloat162*>(dgbuf + r * gs + q * H + j) = v;
          if (valid)
            *reinterpret_cast<__nv_bfloat162*>(
                dgates + ((size_t)t * B + row) * G4 + q * H + j) = v;
        }
      }
    }
    __syncthreads();

    // ---- dh = bf16(dgates) @ W_hh^T, and the next step's h_prev ---------
    if (s + 1 < T)
      load_h_tile(hbuf, h_seq, tprev + step, row0, B, H, hs, s + 2 == T);

    for (int pair = warp; pair < npairs; pair += NWARPS) {
      float acc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

      for (int k = 0; k < G4 / 16; ++k) {
        uint32_t a[4];
        load_a(a, dgbuf + grp * gs + k * 16 + 2 * tq, gs);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B fragment (16x8, col-major) = rows of w [H, 4H]
          const __nv_bfloat16* wp =
              w + (size_t)(16 * pair + 8 * n + grp) * G4 + k * 16 + 2 * tq;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
          mma_bf16_16816(acc[n], a, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = 16 * pair + 8 * n + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(dhbuf + (grp + 8 * half) * H + j) =
              make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Kernel D. gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], wt [4H, H],
// w [H, 4H], all bf16 -> dgates [T, B, 4H] bf16. H must be a multiple of 16.
int lstm_scan_bwd(const void* gates, const void* h_seq, const void* c_seq,
                  const void* gout, const void* wt, const void* w,
                  void* dgates, int T, int B, int H, int reverse,
                  void* stream) {
  const size_t smem =
      ((size_t)ROWS * (H + PAD) + (size_t)ROWS * (4 * H + PAD)) *
          sizeof(__nv_bfloat16) +
      2 * (size_t)ROWS * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + ROWS - 1) / ROWS);
  lstm_scan_bwd_kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)h_seq,
      (const __nv_bfloat16*)c_seq, (const __nv_bfloat16*)gout,
      (const __nv_bfloat16*)wt, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)dgates, T, B, H, reverse);
  return (int)cudaGetLastError();
}

const char* lstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
