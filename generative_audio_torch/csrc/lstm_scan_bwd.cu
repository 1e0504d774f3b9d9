// LSTM backward scan over time-major residuals, for sm_90a.
//
// Kernel D (lstm_scan_bwd) replaces the Pallas TPU kernel
// _lstm_pallas_call_bwd / _lstm_bwd_kernel of
// generative_audio_tpu/ops/pallas_lstm.py. It is the backward of the scan in
// lstm_scan.cu (kernel C wrote its residuals h_seq and c_seq). Kernel G
// (lstm_scan_bwd_chains) replaces chains_bwd / _chains_bwd_kernel of
// scripts/perf_lstm_chains.py: kernel D whose block holds CHAINS independent
// 16-row chains and runs each phase for all of them before the next phase.
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
//   * Kernel G (CHAINS = 2 or 4; kernel D is CHAINS = 1): a block holds
//     CHAINS x 16 rows, each chain with kernel D's shared-memory layout, and
//     every B fragment of W_hh a warp reads from L2 feeds CHAINS mma.sync
//     tiles, so the L2 stream per row halves at CHAINS = 2 and each warp has
//     CHAINS independent accumulator chains. The phases follow
//     _chains_bwd_kernel: all gate-recompute products, then all gate
//     derivatives, then all dh products. Each row sees kernel D's operations
//     in kernel D's order, so dgates are bit-identical. One chain takes
//     111 104 B at H = 384: two fit the 227 KB opt-in limit, four do not.
//
// Plain C interface for ctypes; the function returns the cudaError_t of its
// launch (0 on success). The launch goes to the caller's stream and does
// not synchronise.

#include "scan_common.cuh"

namespace {

template <int CHAINS>
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
  // per chain: [ROWS][hs] h_prev, [ROWS][gs] dgates, [ROWS][H] dh and dc
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [CHAINS][ROWS][hs]
  __nv_bfloat16* dgbuf = hbuf + CHAINS * ROWS * hs;                // [CHAINS][ROWS][gs]
  float* dhbuf = reinterpret_cast<float*>(dgbuf + CHAINS * ROWS * gs);  // [CHAINS][ROWS][H]
  float* dcbuf = dhbuf + CHAINS * ROWS * H;                        // [CHAINS][ROWS][H]

  const int row0 = blockIdx.x * CHAINS * ROWS;              // chain ch: + ch * ROWS
  for (int i = threadIdx.x; i < CHAINS * ROWS * H; i += blockDim.x) {
    dhbuf[i] = 0.0f;
    dcbuf[i] = 0.0f;
  }
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it
  const int step = reverse ? 1 : -1;            // t(p-1) = t(p) + step
  {
    const int t = reverse ? 0 : T - 1;
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch)
      load_h_tile(hbuf + ch * ROWS * hs, h_seq, t + step, row0 + ch * ROWS, B,
                  H, hs, T == 1);
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
      float acc[CHAINS][4][4];
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ch][q][e] = 0.0f;

      for (int k = 0; k < H / 16; ++k) {
        uint32_t a[CHAINS][4];
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch)
          load_a(a[ch], hbuf + ch * ROWS * hs + grp * hs + k * 16 + 2 * tq, hs);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // B fragment (16x8, col-major) = rows of wt [4H, H]
          const __nv_bfloat16* wp =
              wt + (size_t)(q * H + 8 * u + grp) * H + k * 16 + 2 * tq;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
          for (int ch = 0; ch < CHAINS; ++ch)
            mma_bf16_16816(acc[ch][q], a[ch], b0, b1);
        }
      }

      // accumulator (half, e): row grp + 8*half, unit 8u + 2*tq + e
      const int j = 8 * u + 2 * tq;
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch) {
        __nv_bfloat16* dgc = dgbuf + ch * ROWS * gs;
        float* dhc = dhbuf + ch * ROWS * H;
        float* dcc = dcbuf + ch * ROWS * H;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = grp + 8 * half, row = row0 + ch * ROWS + r;
          const bool valid = row < B;
          const size_t at = ((size_t)t * B + row) * H + j;
          float z[4][2];
          float2 ct = make_float2(0.0f, 0.0f), cp = ct, go = ct;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float2 gx = make_float2(0.0f, 0.0f);
            if (valid)
              gx = load_pair(gates + ((size_t)t * B + row) * G4 + q * H + j);
            z[q][0] = gx.x + acc[ch][q][2 * half];
            z[q][1] = gx.y + acc[ch][q][2 * half + 1];
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
            const float dh_tot = g_out[e] + dhc[r * H + j + e];
            const float dc_tot =
                dcc[r * H + j + e] + dh_tot * og * (1.0f - tc * tc);
            dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
            dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
            dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
            dg[3][e] = dh_tot * tc * og * (1.0f - og);
            dcc[r * H + j + e] = dc_tot * gf;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
            *reinterpret_cast<__nv_bfloat162*>(dgc + r * gs + q * H + j) = v;
            if (valid)
              *reinterpret_cast<__nv_bfloat162*>(
                  dgates + ((size_t)t * B + row) * G4 + q * H + j) = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- dh = bf16(dgates) @ W_hh^T, and the next step's h_prev ---------
    if (s + 1 < T) {
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch)
        load_h_tile(hbuf + ch * ROWS * hs, h_seq, tprev + step,
                    row0 + ch * ROWS, B, H, hs, s + 2 == T);
    }

    for (int pair = warp; pair < npairs; pair += NWARPS) {
      float acc[CHAINS][2][4];
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ch][n][e] = 0.0f;

      for (int k = 0; k < G4 / 16; ++k) {
        uint32_t a[CHAINS][4];
#pragma unroll
        for (int ch = 0; ch < CHAINS; ++ch)
          load_a(a[ch], dgbuf + ch * ROWS * gs + grp * gs + k * 16 + 2 * tq, gs);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B fragment (16x8, col-major) = rows of w [H, 4H]
          const __nv_bfloat16* wp =
              w + (size_t)(16 * pair + 8 * n + grp) * G4 + k * 16 + 2 * tq;
          const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(wp));
          const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(wp + 8));
#pragma unroll
          for (int ch = 0; ch < CHAINS; ++ch)
            mma_bf16_16816(acc[ch][n], a[ch], b0, b1);
        }
      }
#pragma unroll
      for (int ch = 0; ch < CHAINS; ++ch)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int j = 16 * pair + 8 * n + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<float2*>(dhbuf + ch * ROWS * H +
                                       (grp + 8 * half) * H + j) =
                make_float2(acc[ch][n][2 * half], acc[ch][n][2 * half + 1]);
          }
        }
    }
    __syncthreads();
  }
}

template <int CHAINS>
int launch(const void* gates, const void* h_seq, const void* c_seq,
           const void* gout, const void* wt, const void* w, void* dgates,
           int T, int B, int H, int reverse, void* stream) {
  // ops/lstm.py repeats this sum to refuse a launch above the opt-in limit
  const size_t smem =
      CHAINS * (((size_t)ROWS * (H + PAD) + (size_t)ROWS * (4 * H + PAD)) *
                    sizeof(__nv_bfloat16) +
                2 * (size_t)ROWS * H * sizeof(float));
  auto kernel = lstm_scan_bwd_kernel<CHAINS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + CHAINS * ROWS - 1) / (CHAINS * ROWS));
  kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)h_seq,
      (const __nv_bfloat16*)c_seq, (const __nv_bfloat16*)gout,
      (const __nv_bfloat16*)wt, (const __nv_bfloat16*)w,
      (__nv_bfloat16*)dgates, T, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel D. gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], wt [4H, H],
// w [H, 4H], all bf16 -> dgates [T, B, 4H] bf16. H must be a multiple of 16.
int lstm_scan_bwd(const void* gates, const void* h_seq, const void* c_seq,
                  const void* gout, const void* wt, const void* w,
                  void* dgates, int T, int B, int H, int reverse,
                  void* stream) {
  return launch<1>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H, reverse,
                   stream);
}

// Kernel G. Kernel D with n_chains = 2 or 4 chains of 16 rows per block,
// forward not reversed (as the script). Bit-identical to kernel D.
int lstm_scan_bwd_chains(const void* gates, const void* h_seq,
                         const void* c_seq, const void* gout, const void* wt,
                         const void* w, void* dgates, int T, int B, int H,
                         int n_chains, void* stream) {
  if (n_chains == 2)
    return launch<2>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H, 0,
                     stream);
  if (n_chains == 4)
    return launch<4>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H, 0,
                     stream);
  return (int)cudaErrorInvalidValue;
}

const char* lstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
