// LSTM backward scan over time-major residuals, for sm_90a.
//
// Kernel D (lstm_scan_bwd) replaces the Pallas TPU kernel
// _lstm_pallas_call_bwd / _lstm_bwd_kernel of
// generative_audio_tpu/ops/pallas_lstm.py. It is the backward of the scan in
// lstm_scan.cu (kernel C wrote its residuals h_seq and c_seq). This source
// also holds the single-block route of kernel G
// (lstm_scan_bwd_chains_block), which replaces chains_bwd /
// _chains_bwd_kernel of scripts/perf_lstm_chains.py where no cluster of
// lstm_scan_bwd_chains.cu holds H: kernel D's single block whose block holds
// CHAINS independent 16-row chains and runs each phase for all of them
// before the next phase.
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
// Design of the single block (right and simple first):
//   * Tiles of ROWS = 16 batch rows per block, the time loop inside the
//     block, 8 warps; a ragged last tile is masked, not padded, and rows
//     beyond B write nothing.
//   * First product: the forward's layout. A warp owns units 8u..8u+7 and
//     computes the four n8 tiles of columns (u, H+u, 2H+u, 3H+u) with
//     mma.sync m16n8k16, so one thread holds all four gates of its (row,
//     unit) pairs, and c_prev, c_t, gout, dh and dc, which are all per (row,
//     unit), need no exchange between threads. dc therefore lives in the
//     thread's registers: a warp owns at most 16 / CHAINS unit groups (H <=
//     1024 for kernel D, 512 for two chains, 256 for four), each of its
//     groups' rounds unrolled. h_prev comes from h_seq in global memory into
//     shared memory (it is bf16 already).
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
//   * Shared memory: h_prev, the dgates tile and dh, 224 H + 512 bytes a
//     chain: 229 888 B at H = 1024. (With dc in shared memory too, as
//     before, H = 1024 needed 295 424 B and no block held it.)
//   * Kernel G's single block (CHAINS = 2 or 4; kernel D is CHAINS = 1): a
//     block holds CHAINS x 16 rows, each chain with kernel D's layout, and
//     every B fragment of W_hh a warp reads from L2 feeds CHAINS mma.sync
//     tiles, so each warp has CHAINS independent accumulator chains. The
//     phases follow _chains_bwd_kernel: all gate-recompute products, then
//     all gate derivatives, then all dh products. Each row sees kernel D's
//     operations in kernel D's order, so dgates are bit-identical. Kernel
//     G's cluster (lstm_scan_bwd_chains.cu) takes its place wherever a
//     cluster holds H.
//
// Kernel D as a thread-block cluster (lstm_bwd_cluster_kernel): the
// backward of the cluster forward (lstm_scan.cu), turned round. The entry
// lstm_scan_bwd takes a launch plan (ops/lstm.py plan_bwd_scan) and runs
// either design; both give the same dgates bit for bit.
//   * A cluster of C CTAs (8 or 16) owns R batch rows. CTA k owns units
//     [k*U, (k+1)*U), U = H/C, and the four gate columns of each, so dh, dc,
//     gout, c_t and c_prev of its (row, unit) pairs stay in the thread that
//     computes them: one warp per (m16 row tile, 8 units) item runs its
//     elementwise part and its second product, so dh and dc live in its
//     registers.
//   * The second product contracts over 4H, so every CTA needs the whole
//     bf16 dgates tile of the cluster's rows. The tile is laid out by owner,
//     [C][R][4U + pad], so that each CTA's slice is contiguous: after the
//     elementwise part a CTA writes its slice into its own tile and sends it
//     to each peer (rank+1, rank+2, ...) with one bulk copy
//     (cp.async.bulk shared::cta to shared::cluster) that completes on an
//     mbarrier in the peer, which waits for the bytes of all its peers. (The
//     first design's 16-byte DSMEM stores, R * U / 2 * (C - 1) of them a CTA
//     a step, cost 1-2 us a step more: scripts/perf_bwd_scan.py.) Then it
//     computes dh of its U units over the whole 4H, in kernel D's k order
//     from zero accumulators (a table gives each k-step's two 8-column
//     halves their place in the tile), from its resident slice of w
//     [H, 4H] (the rows of its units). A cluster barrier keeps the tile until every CTA has read
//     it (one dgates buffer: a second one rarely fits); its wait comes just
//     before the next step's copies, so the next elementwise part runs in
//     its shadow.
//   * The first product (the gates recompute) reads h_prev from the
//     forward's residual h_seq, not from the backward's chain, so the
//     product for step s+1, and the loads of that step's gates, c and gout,
//     run on warps of their own (two warps an item: one for the elementwise
//     part and the second product, one for the recompute of the next step)
//     while step s's exchange and second product run. Its B operand comes
//     from wf, W_hh^T in MMA fragment order (each lane's fragments of two
//     k-steps in 16 contiguous bytes): the CTA's slice copied into shared
//     memory where it fits beside the rest (RESIDENT), else read from L2.
//     (Rows of wt read 4 bytes at a time from L2 held up the second
//     product's shared-memory loads; a clock64 trace of the steps showed
//     the product twice as long with the slice streamed.)
//   * Every element keeps its operands, its k order and its cell
//     expression, so dgates equal the single-block kernel's bit for bit.
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <type_traits>

#include "scan_common.cuh"

namespace {

// Unit groups (of 8) a warp of the single block owns at most, each with its
// dc in registers: H <= 8 * NWARPS * block_groups<CHAINS>().
template <int CHAINS>
__host__ __device__ constexpr int block_groups() { return 16 / CHAINS; }

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
  constexpr int MAXG = block_groups<CHAINS>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G4 = 4 * H;
  const int hs = H + PAD;                                   // h_prev row stride
  const int gs = G4 + PAD;                                  // dgates row stride
  // per chain: [ROWS][hs] h_prev, [ROWS][gs] dgates, [ROWS][H] dh
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [CHAINS][ROWS][hs]
  __nv_bfloat16* dgbuf = hbuf + CHAINS * ROWS * hs;                // [CHAINS][ROWS][gs]
  float* dhbuf = reinterpret_cast<float*>(dgbuf + CHAINS * ROWS * gs);  // [CHAINS][ROWS][H]

  const int row0 = blockIdx.x * CHAINS * ROWS;              // chain ch: + ch * ROWS
  for (int i = threadIdx.x; i < CHAINS * ROWS * H; i += blockDim.x)
    dhbuf[i] = 0.0f;
  // dc of the thread's (row, unit) pairs: round gi (unit group warp + 8 gi),
  // chain ch, pair 2 * half + e (row grp + 8 half, unit 8u + 2tq + e)
  float dc[MAXG][CHAINS][4];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int ch = 0; ch < CHAINS; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[gi][ch][e] = 0.0f;
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
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int u = warp + gi * NWARPS;
      if (u >= ngroups) break;
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
        const float* dhc = dhbuf + ch * ROWS * H;
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
            const float gi_ = sigmoidf_(z[0][e]), gf = sigmoidf_(z[1][e]),
                        gg = tanhf(z[2][e]), og = sigmoidf_(z[3][e]);
            const float tc = tanhf(c_t[e]);
            const float dh_tot = g_out[e] + dhc[r * H + j + e];
            const float dc_tot =
                dc[gi][ch][2 * half + e] + dh_tot * og * (1.0f - tc * tc);
            dg[0][e] = dc_tot * gg * gi_ * (1.0f - gi_);
            dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
            dg[2][e] = dc_tot * gi_ * (1.0f - gg * gg);
            dg[3][e] = dh_tot * tc * og * (1.0f - og);
            dc[gi][ch][2 * half + e] = dc_tot * gf;
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

// Shared bytes of one 16-row chain of the single block: h_prev [16][H + 8]
// and the dgates tile [16][4H + 8], bf16, and dh [16][H] fp32.
size_t block_smem(int H) {
  return ((size_t)ROWS * (H + PAD) + (size_t)ROWS * (4 * H + PAD)) *
             sizeof(__nv_bfloat16) +
         (size_t)ROWS * H * sizeof(float);
}

// The single block of CHAINS chains takes H (a multiple of 16) whose unit
// groups' dc fit the warps' registers.
template <int CHAINS>
bool block_fits(int H) {
  return H > 0 && H % 16 == 0 && H <= 8 * NWARPS * block_groups<CHAINS>();
}

template <int CHAINS>
int launch(const void* gates, const void* h_seq, const void* c_seq,
           const void* gout, const void* wt, const void* w, void* dgates,
           int T, int B, int H, int reverse, void* stream) {
  const size_t smem = CHAINS * block_smem(H);
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

// ---- kernel D as a thread-block cluster ------------------------------------

constexpr int BWD_WARPS = 16;      // warps per CTA of the cluster design

namespace cg = cooperative_groups;

// Row stride (bf16) of one CTA's slice of the dgates tile: its 4U gate
// columns and a pad that makes the stride 4 words past a multiple of 8, so
// the eight rows of an A fragment fall in different banks.
__host__ __device__ inline int slice_stride(int U) {
  return 4 * U + (4 * U % 16 == 0 ? 8 : 16);
}

// Shared bytes of one CTA for a cluster of C over R rows, in the order the
// kernel lays them out: the W_hh^T slice [4U][H] in fragment order (only when
// RESIDENT),
// the W_hh slice [U][4H + PAD], h_prev [R][H + PAD] and the dgates tile
// [C][R][slice_stride(U)], all bf16; the recomputed z [R][4U] fp32, the
// step's c_t, c_prev and gout [3][R][U] bf16, the k-step table [4H/16] int2
// and the exchange's mbarrier (16 bytes). Every region is a multiple of 16
// bytes.
size_t bwd_cluster_smem(int H, int C, int R, bool resident) {
  const size_t U = H / C, hs = H + PAD, gs = 4 * (size_t)H + PAD, r = R;
  return ((resident ? 4 * U * (size_t)H : 0) + U * gs + r * hs +
          C * r * slice_stride(U)) * 2 +
         r * 4 * U * 4 + 3 * r * U / 2 * 4 + 4 * (size_t)H / 16 * 8 + 16;
}

// C of 8 or 16 splits H into groups of 8 units; R is whole m16 tiles, and
// every (m16 tile, 8-unit group) item has two warps of its own.
bool bwd_plan_fits(int H, int C, int R) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && R > 0 &&
         R % 16 == 0 && 2 * (R / 16) * (H / C / 8) <= BWD_WARPS;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
lstm_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ gates,
                        const __nv_bfloat16* __restrict__ h_seq,
                        const __nv_bfloat16* __restrict__ c_seq,
                        const __nv_bfloat16* __restrict__ gout,
                        const __nv_bfloat16* __restrict__ w,    // [H, 4H]
                        const uint4* __restrict__ wf,   // wt, fragment order
                        __nv_bfloat16* __restrict__ dgates,
                        int T, int B, int H, int R, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U4 = 4 * U, hs = H + PAD, G4 = 4 * H, gs = G4 + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int mrows = (nrows + 15) / 16 * 16;   // rows of the valid m16 tiles
  const int sw = slice_stride(U);

  extern __shared__ __align__(16) unsigned char smem[];
  // the recompute's W_hh^T slice in fragment order: [4][U/8][H/32][32]
  uint4* wts = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem) + (RESIDENT ? U4 * H : 0);  // [U][gs]
  __nv_bfloat16* htile = ws + U * gs;                            // [R][hs]
  __nv_bfloat16* dgt = htile + R * hs;                           // [C][R][sw]
  float* zt = reinterpret_cast<float*>(dgt + C * R * sw);        // [R][4U]
  uint32_t* ct_s = reinterpret_cast<uint32_t*>(zt + R * U4);     // [R][U/2]
  uint32_t* cp_s = ct_s + R * U / 2;                             // [R][U/2]
  uint32_t* go_s = cp_s + R * U / 2;                             // [R][U/2]
  // the second product's k-steps: offsets in dgt of each one's two halves
  int2* koff = reinterpret_cast<int2*>(go_s + R * U / 2);        // [4H/16]
  const uint32_t xbar = cta_addr(koff + 4 * H / 16);
  const int nthreads = blockDim.x;

  if (RESIDENT) {    // the CTA's units of each gate: contiguous in wf
    const int per_gate = U / 8 * (H / 32) * 32;     // uint4 of a gate's slice
    for (int i = threadIdx.x; i < 4 * per_gate; i += nthreads) {
      const int q = i / per_gate;
      wts[i] = wf[((size_t)q * (H / 8) + col0 / 8) * (H / 32) * 32 + i % per_gate];
    }
  }
  {                  // rows col0 + u of w (u < U)
    const int per_row = G4 / 8;
    for (int i = threadIdx.x; i < U * per_row; i += nthreads) {
      const int u = i / per_row, c = (i % per_row) * 8;
      *reinterpret_cast<uint4*>(ws + u * gs + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(col0 + u) * G4 + c);
    }
  }
  // column q*H + u of the dgates row lies in the slice of CTA u / U, at
  // q*U + u % U; a k-step's 16 columns are two groups of 8 units
  for (int k = threadIdx.x; k < 4 * H / 16; k += nthreads) {
    const int q = k * 16 / H, u = k * 16 % H;
    koff[k] = make_int2(u / U * R * sw + q * U + u % U,
                        (u + 8) / U * R * sw + q * U + (u + 8) % U);
  }
  if (threadIdx.x == 0) xbar_init(xbar);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tq = lane & 3;   // MMA fragment coordinates
  const int G = U / 8, n_items = mrows / 16 * G;
  // warps [0, n_items) run the elementwise part and the second product of
  // their (m16 tile, 8 units) item; warps [n_items, 2 n_items) the gates
  // recompute of the same items, one step ahead
  const bool is_cmp = warp < n_items;
  const bool is_rec = !is_cmp && warp < 2 * n_items;
  const int item = is_cmp ? warp : is_rec ? warp - n_items : 0;
  const int mt = item / G, jl = 8 * (item % G) + 2 * tq;
  const int arow = mt * 16 + grp;             // the A fragments' first row
  const int rec0 = n_items * 32, n_rec = n_items * 32;   // recompute threads

  // h_prev of the cluster's rows at array time t (zero beyond B or when
  // `zero`), into htile; 16-byte copies by the threads [first, first + n)
  auto load_h = [&](int t, bool zero, int first, int n) {
    const int per_row = H / 8;
    for (int i = threadIdx.x - first; i < R * per_row; i += n) {
      const int r = i / per_row, j = (i % per_row) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (!zero && r < nrows)
        v = *reinterpret_cast<const uint4*>(h_seq +
                                            ((size_t)t * B + row0 + r) * H + j);
      *reinterpret_cast<uint4*>(htile + r * hs + j) = v;
    }
  };
  // position p = T-1-s is processed at backward step s; its array time and
  // that of the position before it
  const int step = reverse ? 1 : -1;          // t(p-1) = t(p) + step
  const int t_first = reverse ? 0 : T - 1;
  load_h(t_first + step, T == 1, 0, nthreads);

  // a recompute warp: z = gates + h_prev @ W_hh (kernel D's first product)
  // of step s into zt, and that step's c_t, c_prev and gout into ct_s, cp_s
  // and go_s, for its item
  auto recompute = [&](int s) {
    const int t = reverse ? s : T - 1 - s, tprev = t + step;
    const bool first = (s == T - 1);          // p == 0: zero c_prev
    uint32_t gx_raw[2][4], ct_raw[2], cp_raw[2], go_raw[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = arow + 8 * half, row = row0 + r;
      const bool valid = r < nrows;
      const size_t at = ((size_t)t * B + row) * H + col0 + jl;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gx_raw[half][q] =
            valid ? ldg32(gates + ((size_t)t * B + row) * G4 + q * H + col0 + jl)
                  : 0u;
      ct_raw[half] = valid ? ldg32(c_seq + at) : 0u;
      go_raw[half] = valid ? ldg32(gout + at) : 0u;
      cp_raw[half] = valid && !first
                         ? ldg32(c_seq + ((size_t)tprev * B + row) * H + col0 + jl)
                         : 0u;
    }
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    // k-steps in chunks of 8, and one of 4 when H / 16 leaves 4 (H % 64 ==
    // 0). B fragments come from W_hh^T in fragment order (ops: wf), one
    // 16-byte load a lane for two k-steps of a gate, all of a chunk loaded
    // before its products, so that the reads from L2 of a streamed slice
    // are few and in flight together; each accumulator still sums its
    // k-steps in order
    const size_t per_q = RESIDENT ? (size_t)(U / 8) * (H / 32) * 32
                                  : (size_t)(H / 8) * (H / 32) * 32;
    const uint4* fsrc =
        (RESIDENT ? wts + (size_t)(item % G) * (H / 32) * 32
                  : wf + (size_t)((col0 + jl - 2 * tq) / 8) * (H / 32) * 32) +
        lane;
    auto chunk = [&](int k0, auto kc) {
      constexpr int KC = decltype(kc)::value;
      uint32_t b[KC][4][2];
#pragma unroll
      for (int kp = 0; kp < KC / 2; ++kp)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4* p = fsrc + q * per_q + (k0 / 2 + kp) * 32;
          const uint4 v = RESIDENT ? *p : __ldg(p);
          b[2 * kp][q][0] = v.x;
          b[2 * kp][q][1] = v.y;
          b[2 * kp + 1][q][0] = v.z;
          b[2 * kp + 1][q][1] = v.w;
        }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t a[4];
        load_a(a, htile + arow * hs + (k0 + kk) * 16 + 2 * tq, hs);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16_16816(acc[q], a, b[kk][q][0], b[kk][q][1]);
      }
    };
    int k0 = 0;
    for (; k0 + 8 <= H / 16; k0 += 8) chunk(k0, std::integral_constant<int, 8>());
    if (k0 < H / 16) chunk(k0, std::integral_constant<int, 4>());
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = arow + 8 * half;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 gx = bf2(gx_raw[half][q]);
        *reinterpret_cast<float2*>(zt + r * U4 + q * U + jl) =
            make_float2(gx.x + acc[q][2 * half], gx.y + acc[q][2 * half + 1]);
      }
      ct_s[r * U / 2 + jl / 2] = ct_raw[half];
      cp_s[r * U / 2 + jl / 2] = cp_raw[half];
      go_s[r * U / 2 + jl / 2] = go_raw[half];
    }
  };

  // a compute warp's state for its (row, unit) pairs: index 2 * half + e is
  // row mt*16 + grp + 8 half, unit col0 + jl + e
  float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  cluster.sync();      // every CTA has started and filled its slices
  if (is_rec) recompute(0);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s, tprev = t + step;
    __syncthreads();   // step s's z is in zt; the last second product is done

    if (is_cmp) {      // ---- the elementwise backward (kernel D's) -------
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = arow + 8 * half, row = row0 + r;
        const bool valid = r < nrows;
        float z[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 zq = *reinterpret_cast<const float2*>(zt + r * U4 + q * U + jl);
          z[q][0] = zq.x;
          z[q][1] = zq.y;
        }
        const float2 ct = bf2(ct_s[r * U / 2 + jl / 2]),
                     cp = bf2(cp_s[r * U / 2 + jl / 2]),
                     go = bf2(go_s[r * U / 2 + jl / 2]);
        const float c_t[2] = {ct.x, ct.y}, c_prev[2] = {cp.x, cp.y},
                    g_out[2] = {go.x, go.y};
        float dg[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gi = sigmoidf_(z[0][e]), gf = sigmoidf_(z[1][e]),
                      gg = tanhf(z[2][e]), og = sigmoidf_(z[3][e]);
          const float tc = tanhf(c_t[e]);
          const float dh_tot = g_out[e] + dh[2 * half + e];
          const float dc_tot = dc[2 * half + e] + dh_tot * og * (1.0f - tc * tc);
          dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
          dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
          dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
          dg[3][e] = dh_tot * tc * og * (1.0f - og);
          dc[2 * half + e] = dc_tot * gf;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
          *reinterpret_cast<__nv_bfloat162*>(dgt + (rank * R + r) * sw + q * U + jl) = v;
          if (valid)
            *reinterpret_cast<__nv_bfloat162*>(
                dgates + ((size_t)t * B + row) * G4 + q * H + col0 + jl) = v;
        }
      }
      fence_proxy_async();   // the slice is read by the bulk copies below
    } else if (is_rec && s + 1 < T) {
      load_h(tprev + step, s + 2 == T, rec0, n_rec);   // the next h_prev
    }
    __syncthreads();   // the CTA's dgates slice is in dgt; zt is read

    // every peer has read its copy of this CTA's slice of step s-1
    if (s > 0) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    // hand the slice on: one bulk copy of its valid rows to each peer
    // (rank+1, rank+2, ...), completing on the peer's barrier
    const uint32_t bytes = mrows * sw * 2;
    if (threadIdx.x == 0) xbar_expect(xbar, (C - 1) * bytes);
    if (threadIdx.x < C - 1) {
      const int peer = (rank + 1 + threadIdx.x) % C;
      const uint32_t src = cta_addr(dgt + rank * R * sw);
      bulk_to_peer(peer_addr(src, peer), src, bytes, peer_addr(xbar, peer));
    }

    if (is_cmp) {      // ---- dh = bf16(dgates) @ W_hh^T, own units, all 4H
      xbar_wait(xbar, s & 1);                 // the peers' slices of step s
      float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* ap = dgt + arow * sw + 2 * tq;
      const __nv_bfloat16* bp = ws + (jl - 2 * tq + grp) * gs + 2 * tq;
#pragma unroll 4
      for (int k = 0; k < G4 / 16; ++k) {
        // A fragment (16x16, row-major) of the k-step's columns, whose two
        // halves lie in the slices of the CTAs that own their units
        const int2 o = koff[k];
        uint32_t a[4];
        a[0] = ld32(ap + o.x);
        a[1] = ld32(ap + o.x + 8 * sw);
        a[2] = ld32(ap + o.y);
        a[3] = ld32(ap + o.y + 8 * sw);
        mma_bf16_16816(acc2, a, ld32(bp + k * 16), ld32(bp + k * 16 + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dh[i] = acc2[i];
    } else if (is_rec && s + 1 < T) {
      recompute(s + 1);                       // off the serial chain
    }
    if (threadIdx.x < C - 1) bulk_wait_read();   // before dgt is written again
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <bool RESIDENT>
cudaError_t prepare_cluster(int C, size_t smem) {
  auto kernel = lstm_bwd_cluster_kernel<RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

template <bool RESIDENT>
int launch_cluster(const void* gates, const void* h_seq, const void* c_seq,
                   const void* gout, const void* w, const void* wf,
                   void* dgates, int T, int B, int H, int reverse, int C,
                   int R, void* stream) {
  const size_t smem = bwd_cluster_smem(H, C, R, RESIDENT);
  cudaError_t err = prepare_cluster<RESIDENT>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * BWD_WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel<RESIDENT>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)h_seq,
                           (const __nv_bfloat16*)c_seq,
                           (const __nv_bfloat16*)gout,
                           (const __nv_bfloat16*)w, (const uint4*)wf,
                           (__nv_bfloat16*)dgates, T, B, H, R, reverse);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool RESIDENT>
int max_clusters(int H, int C, int R, int* n) {
  const size_t smem = bwd_cluster_smem(H, C, R, RESIDENT);
  cudaError_t err = prepare_cluster<RESIDENT>(C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(32 * BWD_WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, lstm_bwd_cluster_kernel<RESIDENT>, &cfg);
}

}  // namespace

extern "C" {

// Kernel D. gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], wt [4H, H],
// w [H, 4H], all bf16 -> dgates [T, B, 4H] bf16. H must be a multiple of 16
// (at most 1024 for the single block).
// wf is wt in MMA fragment order, [4][H/8][H/32][32] of 16 bytes (ops/lstm.py
// _fragment_weight), read by the cluster design (H % 64 == 0 there); the
// single block reads wt.
// The launch plan (ops/lstm.py plan_bwd_scan): cluster = 1 runs the
// single-block design (rows 16, resident 0); cluster = 8 or 16 a cluster of
// that many CTAs over `rows` rows each, with the recompute's W_hh^T slice in
// shared memory when `resident`. smem_bytes must be the design's.
int lstm_scan_bwd(const void* gates, const void* h_seq, const void* c_seq,
                  const void* gout, const void* wt, const void* w,
                  const void* wf, void* dgates, int T, int B, int H,
                  int reverse, int cluster, int rows, int resident,
                  int smem_bytes, void* stream) {
  if (H <= 0 || H % 16) return (int)cudaErrorInvalidValue;
  if (cluster == 1) {
    if (!block_fits<1>(H) || rows != ROWS || resident ||
        (size_t)smem_bytes != block_smem(H))
      return (int)cudaErrorInvalidValue;
    return launch<1>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H,
                     reverse, stream);
  }
  if (!bwd_plan_fits(H, cluster, rows) ||
      (size_t)smem_bytes != bwd_cluster_smem(H, cluster, rows, resident))
    return (int)cudaErrorInvalidValue;
  if (resident)
    return launch_cluster<true>(gates, h_seq, c_seq, gout, w, wf, dgates, T,
                                B, H, reverse, cluster, rows, stream);
  return launch_cluster<false>(gates, h_seq, c_seq, gout, w, wf, dgates, T, B,
                               H, reverse, cluster, rows, stream);
}

// Kernel G's single block: kernel D's single block with n_chains = 2 or 4
// chains of 16 rows a block, forward not reversed (as the script), H up to
// 512 (two chains) or 256 (four); smem_bytes must be n_chains chains'.
// Bit-identical to kernel D.
int lstm_scan_bwd_chains_block(const void* gates, const void* h_seq,
                               const void* c_seq, const void* gout,
                               const void* wt, const void* w, void* dgates,
                               int T, int B, int H, int n_chains,
                               int smem_bytes, void* stream) {
  if ((size_t)smem_bytes != n_chains * block_smem(H))
    return (int)cudaErrorInvalidValue;
  if (n_chains == 2 && block_fits<2>(H))
    return launch<2>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H, 0,
                     stream);
  if (n_chains == 4 && block_fits<4>(H))
    return launch<4>(gates, h_seq, c_seq, gout, wt, w, dgates, T, B, H, 0,
                     stream);
  return (int)cudaErrorInvalidValue;
}

// cudaOccupancyMaxActiveClusters of the cluster design (resident or not)
// for a cluster of `cluster` CTAs over `rows` rows at H: *n clusters can run
// at once on the current device.
int lstm_scan_bwd_max_clusters(int resident, int H, int cluster, int rows,
                               int* n) {
  if (!bwd_plan_fits(H, cluster, rows)) return (int)cudaErrorInvalidValue;
  return resident ? max_clusters<true>(H, cluster, rows, n)
                  : max_clusters<false>(H, cluster, rows, n);
}

const char* lstm_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
