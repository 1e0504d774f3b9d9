// GRU backward over time-major residuals, for sm_90a: two kernels.
//
// Together they replace the Pallas TPU kernel _gru_pallas_call_bwd /
// _gru_bwd_kernel of generative_audio_tpu/ops/pallas_lstm.py (:1019; its
// dW_hh line at :1011), the backward of the scan in gru_scan.cu. The only
// residual of the forward is its bf16 h sequence; the h-side gates are
// recomputed.
//
// What the TPU kernel computes. The forward processed positions p = 0..T-1
// (array time t = p, or T-1-p with reverse). The backward walks p = T-1..0
// per block of batch rows, with dh (fp32) kept on chip and zero at the start:
//   h_prev = h_seq one processing step earlier (bf16); zero at p = 0
//   gh     = h_prev @ W_hh + b_hh                                (fp32 acc)
//   r, z   = sigmoid(x_r + gh_r), sigmoid(x_z + gh_z); n = tanh(x_n + r*gh_n)
//   dh_tot = float(gout[t]) + dh
//   dn = dh_tot*(1-z); dz = dh_tot*(float(h_prev) - n); dxn = dn*(1-n^2)
//   dgr = dxn*gh_n*r*(1-r); dgz = dz*z*(1-z); dhn = dxn*r
//   dgx[t] = bf16([dgr, dgz, dxn]);  dgh = [dgr, dgz, dhn]
//   dh    = bf16(dgh) @ W_hh^T + dh_tot*z                        (fp32 acc)
//   dW_hh += h_prev^T @ bf16(dgh);  db_hh += sum over rows of dgh (fp32)
// and it keeps one fp32 dW_hh [H, 3H] and db_hh per batch block in VMEM,
// which its caller sums.
//
// Why two kernels here. A fp32 [H, 3H] accumulator is 1.77 MB at H = 384
// (3.1 MB at H = 512), far over a block's 227 KB of shared memory, and one
// partial per 16-row block in global memory would be 144 x 1.77 MB at the
// training shape, re-read and re-written every step; atomics into one
// [H, 3H] from every block and step would be about 1e10 of them. dW_hh has
// no serial dependence on time, so it is taken out of the time loop:
//   * gru_scan_bwd, the scan: per 16-row block, the time loop above without
//     the dW_hh line. It writes dgx, the bf16 dhn stream [T, B, H] (the
//     third part of dgh, which differs from dgx's) and one fp32 db_hh [3H]
//     per block, summed on chip over the block's rows and steps.
//   * gru_scan_bwd_dwhh, the contraction: dW_hh = A^T @ D over N = (T-1)*B
//     rows, where A = h_seq shifted by one processing step and
//     D = [dgx[:, :2H], dhn] (the caller passes the shifted slices; the
//     first processed step saw h = 0 and adds nothing). The N axis is cut
//     into slices; each CTA writes its fp32 tile of its slice's partial
//     [n_slices, H, 3H], and the caller sums the slices in a fixed order, as
//     the JAX caller sums the blocks. No atomics, so the result does not
//     change from run to run.
//
// What bounds them on an H100, at the training shape (batch 18 x 3.072 s
// with drop_band 2: T = 195, 2304 rows, H = 384). The scan does
// 2 * 2*T*rows*H*3H = 0.79 TFLOP (0.80 ms at 989 TFLOP/s) and moves
// T*rows*(3H + H + H + 3H + H)*2 B = 3.1 GB (0.93 ms at 3.35 TB/s): at the
// ridge, bytes ahead; the serial chain of T steps of two dependent products
// is what the simple design pays. The contraction does 2*N*H*3H = 0.40 TFLOP
// (0.40 ms) and must move N*(H + 2H + H)*2 B = 1.4 GB in and one fp32
// [H, 3H] out (0.41 ms): at the ridge too. The fp32 partials per slice are
// this design's own traffic on top of that (1.8 MB a slice), and so are
// the operand rows each output tile reads again: A once per column tile, D
// once per row tile.
//
// Design of the scan (the LSTM backward's, lstm_scan_bwd.cu):
//   * First product in the forward's layout: a warp owns units 8u..8u+7 and
//     the three n8 tiles of columns (u, H+u, 2H+u), so r, z, n, gout, dh and
//     h_prev of a (row, unit) sit in one thread.
//   * Second product contracts over 3H, so every warp needs the whole bf16
//     dgh tile (16 x (3H + 8) x 2 B = 37 KB at H = 384, 49 KB at H = 512) in
//     shared memory, and a second __syncthreads per step. Its result lands
//     in other threads than the first product's layout, so dh lives in a
//     fp32 tile in shared memory: the first phase leaves dh_tot*z there, the
//     second adds the product.
//   * h_prev is zero at the first processed position by a flag, not by a
//     clamped index; the next step's tile is copied in during the second
//     product.
//   * db_hh: each thread adds its two rows, a warp shuffle adds the eight
//     row groups, and one lane per column adds into a fp32 [3H] array in
//     shared memory that only it touches.
//   * Rows beyond B read zero gates, gout and h, which makes their dgh and
//     dh exactly zero: they add nothing to db_hh and write nothing.
// The scan as a thread-block cluster (gru_bwd_cluster_kernel; the entry
// gru_scan_bwd takes a launch plan, ops/gru.py plan_bwd_scan, and runs
// either design, the same bits): the LSTM backward's cluster design
// (lstm_scan_bwd.cu) with three gate columns a unit.
//   * A cluster of C CTAs owns R rows; CTA k owns units [k*U, (k+1)*U) and
//     their r, z, n columns. One warp per (m16 tile, 8 units) item keeps
//     dh, b_hh of its columns and, in the lanes of row group 0, the tile's
//     db_hh sums in registers. The db_hh partial stays one per 16-row tile
//     of the batch, summed over steps in the single block's order (the
//     shuffle over the eight row groups, then one add a step), so
//     `db_blocks` keeps its shape and its bits.
//   * After the elementwise part each CTA sends its bf16 dgh slice to every
//     peer with one bulk copy into the peer's dgh tile, laid out by owner
//     [C][R][3U + pad], completing on the peer's mbarrier; then dh =
//     bf16(dgh) @ W_hh^T over all 3H for its units from its resident slice
//     of w [H, 3H], then `+ dh_tot * z`, in that order, as the single block
//     adds its carry. A cluster barrier keeps the tile until every CTA has
//     read it.
//   * The gates recompute of step s+1 (h_prev from h_seq, off the chain) and
//     the loads of that step's gates and gout run between the arrive and
//     the wait of step s's second barrier, from the W_hh^T slice in shared
//     memory where it fits (RESIDENT), else from L2.
// Design of the contraction, for Hopper's asynchronous units:
//   * A CTA owns a 128 x 256 tile of dW_hh and one slice of rows. The tile's
//     columns come whole from dgx (2H = 768 or 1024, a multiple of 256) or
//     from dhn, so each operand has one TMA descriptor; dhn's last tile may
//     be ragged, and the columns beyond H are neither loaded nor written.
//   * TMA brings the operands in: one producer warp keeps 4 stages of 64
//     rows in flight (2 boxes of A and 4 of D, 64 columns x 64 rows each,
//     48 KB a stage), with mbarrier completion and the 128-byte swizzle.
//     Rows beyond N arrive as zeros, so a ragged last slice needs no mask.
//     No thread spends registers or instructions on the copies, and the
//     product of one stage overlaps the loads of the next three.
//   * Two consumer warpgroups each run wgmma m64n256k16 on 64 of the tile's
//     rows, both operands MN-major in shared memory (the contraction index
//     is the slow axis of A and of D, which the transpose flags take as
//     stored: no ldmatrix.trans pass), with the fp32 sum in registers. One
//     stage's group of products stays in flight while the next stage's is
//     issued (wait_group 1); the slot of a stage goes back to the producer
//     after the wait that retires its group. (The first design waited for
//     every group at once, wait_group 0; the entry still takes it.)
//   * The slices (ops/gru.py plan_dwhh) fill the card's SMs by a model:
//     each extra slice shortens every CTA's run of stages and adds one fp32
//     partial [H, 3H] written here and read back by the caller's sum (1.8
//     MB at H = 384, 3.1 MB at H = 512). A narrow tile (dhn's ragged last
//     one at H = 384, 4 boxes a stage against 6) may take fewer slices than
//     the others, so that the tiles' runs come out even: 12 tiles x 9
//     slices and 3 x 8 fill 132 SMs at H = 384; the full band (H = 512, N =
//     3492, 24 tiles, 55 stages) takes a few slices where it took one.
//   * The TMA descriptors are encoded on the host for each call with
//     cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, and
//     passed as __grid_constant__ kernel parameters.
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <type_traits>
#include <cuda.h>

#include "scan_common.cuh"

namespace {

__global__ void __launch_bounds__(NWARPS * 32)
gru_scan_bwd_kernel(const __nv_bfloat16* __restrict__ gates,
                    const __nv_bfloat16* __restrict__ h_seq,
                    const __nv_bfloat16* __restrict__ gout,
                    const __nv_bfloat16* __restrict__ wt,   // [3H, H]
                    const __nv_bfloat16* __restrict__ w,    // [H, 3H]
                    const float* __restrict__ bhh,          // [3H]
                    __nv_bfloat16* __restrict__ dgx,        // [T, B, 3H]
                    __nv_bfloat16* __restrict__ dhn,        // [T, B, H]
                    float* __restrict__ dbhh,               // [blocks, 3H]
                    int T, int B, int H, int reverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G3 = 3 * H;
  const int hs = H + PAD;                                   // h_prev row stride
  const int gs = G3 + PAD;                                  // dgh row stride
  __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem);   // [ROWS][hs]
  __nv_bfloat16* dgbuf = hbuf + ROWS * hs;                         // [ROWS][gs]
  float* dhbuf = reinterpret_cast<float*>(dgbuf + ROWS * gs);      // [ROWS][H]
  float* bias = dhbuf + ROWS * H;                                  // [3H]
  float* dbacc = bias + G3;                                        // [3H]

  const int row0 = blockIdx.x * ROWS;
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) dhbuf[i] = 0.0f;
  for (int i = threadIdx.x; i < G3; i += blockDim.x) {
    bias[i] = bhh[i];
    dbacc[i] = 0.0f;
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
    const int tprev = t + step;

    // ---- h-side gates recompute and the elementwise backward -> dgx, dgh --
    for (int u = warp; u < ngroups; u += NWARPS) {
      float acc[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;

      for (int k = 0; k < H / 16; ++k) {
        uint32_t a[4];
        load_a(a, hbuf + grp * hs + k * 16 + 2 * tq, hs);
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
      float dbsum[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) dbsum[q][0] = dbsum[q][1] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = grp + 8 * half, row = row0 + r;
        const bool valid = row < B;
        float x[3][2], gh[3][2];
        float2 go = make_float2(0.0f, 0.0f);
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
        if (valid) go = load_pair(gout + ((size_t)t * B + row) * H + j);
        // the bf16 residual, upcast; zero at the first processed position
        const float2 hp2 = load_pair(hbuf + r * hs + j);
        const float g_out[2] = {go.x, go.y}, h_prev[2] = {hp2.x, hp2.y};
        float dg[3][2], dxn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          const float dh_tot = g_out[e] + dhbuf[r * H + j + e];
          const float dn = dh_tot * (1.0f - zg);
          const float dz = dh_tot * (h_prev[e] - ng);
          dxn[e] = dn * (1.0f - ng * ng);
          dg[0][e] = dxn[e] * gh[2][e] * rg * (1.0f - rg);
          dg[1][e] = dz * zg * (1.0f - zg);
          dg[2][e] = dxn[e] * rg;
          dhbuf[r * H + j + e] = dh_tot * zg;     // the product is added below
#pragma unroll
          for (int q = 0; q < 3; ++q) dbsum[q][e] += dg[q][e];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
          *reinterpret_cast<__nv_bfloat162*>(dgbuf + r * gs + q * H + j) = v;
          if (valid) {
            if (q < 2)
              *reinterpret_cast<__nv_bfloat162*>(
                  dgx + ((size_t)t * B + row) * G3 + q * H + j) = v;
            else
              *reinterpret_cast<__nv_bfloat162*>(
                  dhn + ((size_t)t * B + row) * H + j) = v;
          }
        }
        if (valid)
          *reinterpret_cast<__nv_bfloat162*>(
              dgx + ((size_t)t * B + row) * G3 + 2 * H + j) =
              __floats2bfloat162_rn(dxn[0], dxn[1]);
      }
      // db_hh: add the eight row groups of the warp (lanes that share tq)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dbsum[q][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (grp == 0) dbacc[q * H + j + e] += v;
        }
    }
    __syncthreads();

    // ---- dh += bf16(dgh) @ W_hh^T, and the next step's h_prev -------------
    if (s + 1 < T)
      load_h_tile(hbuf, h_seq, tprev + step, row0, B, H, hs, s + 2 == T);

    for (int pair = warp; pair < npairs; pair += NWARPS) {
      float acc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

      for (int k = 0; k < G3 / 16; ++k) {
        uint32_t a[4];
        load_a(a, dgbuf + grp * gs + k * 16 + 2 * tq, gs);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B fragment (16x8, col-major) = rows of w [H, 3H]
          const __nv_bfloat16* wp =
              w + (size_t)(16 * pair + 8 * n + grp) * G3 + k * 16 + 2 * tq;
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
          float2* p = reinterpret_cast<float2*>(dhbuf + (grp + 8 * half) * H + j);
          const float2 carry = *p;
          *p = make_float2(acc[n][2 * half] + carry.x,
                           acc[n][2 * half + 1] + carry.y);
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < G3; i += blockDim.x)
    dbhh[(size_t)blockIdx.x * G3 + i] = dbacc[i];
}

// ---- the scan as a thread-block cluster ------------------------------------

constexpr int BWD_WARPS = 16;      // warps per CTA of the cluster design

namespace cg = cooperative_groups;

// Row stride (bf16) of one CTA's slice of the dgates tile: its 3U gate
// columns and a pad that makes the stride 4 words past a multiple of 8, so
// the eight rows of an A fragment fall in different banks.
__host__ __device__ inline int slice_stride(int U) {
  return 3 * U + (3 * U % 16 == 0 ? 8 : 16);
}

// Shared bytes of one CTA for a cluster of C over R rows, in the order the
// kernel lays them out: the W_hh^T slice [3U][H] in fragment order (only when
// RESIDENT),
// the W_hh slice [U][3H + PAD], h_prev [R][H + PAD] and the dgh tile
// [C][R][slice_stride(U)], all bf16; the recomputed gh [R][3U] fp32, the
// step's x-side gates [R][3U], gout and h_prev [R][U] bf16, the k-step table
// [3H/16] int2 and the exchange's mbarrier (16 bytes). b_hh and the db_hh
// sums of the thread's columns live in registers. Every region is a
// multiple of 16 bytes.
size_t bwd_cluster_smem(int H, int C, int R, bool resident) {
  const size_t U = H / C, hs = H + PAD, gs = 3 * (size_t)H + PAD, r = R;
  return ((resident ? 3 * U * (size_t)H : 0) + U * gs + r * hs +
          C * r * slice_stride(U)) * 2 +
         r * 3 * U * 4 + r * 5 * U / 2 * 4 + 3 * (size_t)H / 16 * 8 + 16;
}

// C of 8 or 16 splits H into groups of 8 units; R is whole m16 tiles, and
// every (m16 tile, 8-unit group) item has two warps of its own.
bool bwd_plan_fits(int H, int C, int R) {
  return (C == 8 || C == 16) && H > 0 && H % (8 * C) == 0 && R > 0 &&
         R % 16 == 0 && 2 * (R / 16) * (H / C / 8) <= BWD_WARPS;
}

template <bool RESIDENT>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
gru_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ gates,
                       const __nv_bfloat16* __restrict__ h_seq,
                       const __nv_bfloat16* __restrict__ gout,
                       const __nv_bfloat16* __restrict__ w,    // [H, 3H]
                       const uint4* __restrict__ wf,   // wt, fragment order
                       const float* __restrict__ bhh,          // [3H]
                       __nv_bfloat16* __restrict__ dgx,        // [T, B, 3H]
                       __nv_bfloat16* __restrict__ dhn,        // [T, B, H]
                       float* __restrict__ dbhh,               // [blocks, 3H]
                       int T, int B, int H, int R, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned int cluster_id;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(cluster_id));

  const int U = H / C, U3 = 3 * U, hs = H + PAD, G3 = 3 * H, gs = G3 + PAD;
  const int col0 = rank * U;                  // first unit of this CTA
  const int row0 = (int)cluster_id * R;       // first batch row of the cluster
  const int nrows = min(R, B - row0);         // valid rows, at least 1
  const int mrows = (nrows + 15) / 16 * 16;   // rows of the valid m16 tiles
  const int sw = slice_stride(U);

  extern __shared__ __align__(16) unsigned char smem[];
  // the recompute's W_hh^T slice in fragment order: [3][U/8][H/32][32]
  uint4* wts = reinterpret_cast<uint4*>(smem);
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(smem) + (RESIDENT ? U3 * H : 0);  // [U][gs]
  __nv_bfloat16* htile = ws + U * gs;                            // [R][hs]
  __nv_bfloat16* dgt = htile + R * hs;                           // [C][R][sw]
  float* ght = reinterpret_cast<float*>(dgt + C * R * sw);       // [R][3U]
  uint32_t* gx_s = reinterpret_cast<uint32_t*>(ght + R * U3);    // [R][3U/2]
  uint32_t* go_s = gx_s + R * U3 / 2;                            // [R][U/2]
  uint32_t* hp_s = go_s + R * U / 2;                             // [R][U/2]
  // the second product's k-steps: offsets in dgt of each one's two halves
  int2* koff = reinterpret_cast<int2*>(hp_s + R * U / 2);        // [3H/16]
  const uint32_t xbar = cta_addr(koff + 3 * H / 16);
  const int nthreads = blockDim.x;

  if (RESIDENT) {    // the CTA's units of each gate: contiguous in wf
    const int per_gate = U / 8 * (H / 32) * 32;     // uint4 of a gate's slice
    for (int i = threadIdx.x; i < 3 * per_gate; i += nthreads) {
      const int q = i / per_gate;
      wts[i] = wf[((size_t)q * (H / 8) + col0 / 8) * (H / 32) * 32 + i % per_gate];
    }
  }
  {                  // rows col0 + u of w (u < U)
    const int per_row = G3 / 8;
    for (int i = threadIdx.x; i < U * per_row; i += nthreads) {
      const int u = i / per_row, c = (i % per_row) * 8;
      *reinterpret_cast<uint4*>(ws + u * gs + c) =
          *reinterpret_cast<const uint4*>(w + (size_t)(col0 + u) * G3 + c);
    }
  }
  // column q*H + u of the dgh row lies in the slice of CTA u / U, at
  // q*U + u % U; a k-step's 16 columns are two groups of 8 units
  for (int k = threadIdx.x; k < 3 * H / 16; k += nthreads) {
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

  // a recompute warp: gh = h_prev @ W_hh + b_hh (the scan's first product)
  // of step s into ght, and that step's x-side gates, gout and h_prev into
  // gx_s, go_s and hp_s, for its item
  float bias[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[q][e] = bhh[q * H + col0 + jl + e];
  auto recompute = [&](int s) {
    const int t = reverse ? s : T - 1 - s;
    uint32_t gx_raw[2][3], go_raw[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = arow + 8 * half, row = row0 + r;
      const bool valid = r < nrows;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        gx_raw[half][q] =
            valid ? ldg32(gates + ((size_t)t * B + row) * G3 + q * H + col0 + jl)
                  : 0u;
      go_raw[half] =
          valid ? ldg32(gout + ((size_t)t * B + row) * H + col0 + jl) : 0u;
    }
    float acc[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q)
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
      uint32_t b[KC][3][2];
#pragma unroll
      for (int kp = 0; kp < KC / 2; ++kp)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
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
        for (int q = 0; q < 3; ++q)
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
      for (int q = 0; q < 3; ++q) {
        *reinterpret_cast<float2*>(ght + r * U3 + q * U + jl) =
            make_float2(acc[q][2 * half] + bias[q][0],
                        acc[q][2 * half + 1] + bias[q][1]);
        gx_s[r * U3 / 2 + (q * U + jl) / 2] = gx_raw[half][q];
      }
      go_s[r * U / 2 + jl / 2] = go_raw[half];
      hp_s[r * U / 2 + jl / 2] = ld32(htile + r * hs + col0 + jl);
    }
  };

  // a compute warp's dh of its (row, unit) pairs (index 2 * half + e: row
  // mt*16 + grp + 8 half, unit col0 + jl + e) and, in lanes with grp == 0,
  // the m-tile's db_hh sums of its columns
  float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, carry[4], dbacc[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q) dbacc[q][0] = dbacc[q][1] = 0.0f;

  cluster.sync();      // every CTA has started and filled its slices
  if (is_rec) recompute(0);

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s, tprev = t + step;
    __syncthreads();   // step s's gh is in ght; the last second product is done

    if (is_cmp) {      // ---- the elementwise backward (the scan's) --------
      float dbsum[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) dbsum[q][0] = dbsum[q][1] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = arow + 8 * half, row = row0 + r;
        const bool valid = r < nrows;
        float x[3][2], gh[3][2];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float2 gxv = bf2(gx_s[r * U3 / 2 + (q * U + jl) / 2]);
          const float2 ghv =
              *reinterpret_cast<const float2*>(ght + r * U3 + q * U + jl);
          x[q][0] = gxv.x;
          x[q][1] = gxv.y;
          gh[q][0] = ghv.x;
          gh[q][1] = ghv.y;
        }
        const float2 go = bf2(go_s[r * U / 2 + jl / 2]);
        // the bf16 residual, upcast; zero at the first processed position
        const float2 hp2 = bf2(hp_s[r * U / 2 + jl / 2]);
        const float g_out[2] = {go.x, go.y}, h_prev[2] = {hp2.x, hp2.y};
        float dg[3][2], dxn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float rg = sigmoidf_(x[0][e] + gh[0][e]);
          const float zg = sigmoidf_(x[1][e] + gh[1][e]);
          const float ng = tanhf(x[2][e] + rg * gh[2][e]);
          const float dh_tot = g_out[e] + dh[2 * half + e];
          const float dn = dh_tot * (1.0f - zg);
          const float dz = dh_tot * (h_prev[e] - ng);
          dxn[e] = dn * (1.0f - ng * ng);
          dg[0][e] = dxn[e] * gh[2][e] * rg * (1.0f - rg);
          dg[1][e] = dz * zg * (1.0f - zg);
          dg[2][e] = dxn[e] * rg;
          carry[2 * half + e] = dh_tot * zg;  // the product is added below
#pragma unroll
          for (int q = 0; q < 3; ++q) dbsum[q][e] += dg[q][e];
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(dg[q][0], dg[q][1]);
          *reinterpret_cast<__nv_bfloat162*>(dgt + (rank * R + r) * sw + q * U + jl) = v;
          if (valid) {
            if (q < 2)
              *reinterpret_cast<__nv_bfloat162*>(
                  dgx + ((size_t)t * B + row) * G3 + q * H + col0 + jl) = v;
            else
              *reinterpret_cast<__nv_bfloat162*>(
                  dhn + ((size_t)t * B + row) * H + col0 + jl) = v;
          }
        }
        if (valid)
          *reinterpret_cast<__nv_bfloat162*>(
              dgx + ((size_t)t * B + row) * G3 + 2 * H + col0 + jl) =
              __floats2bfloat162_rn(dxn[0], dxn[1]);
      }
      // db_hh: add the eight row groups of the warp (lanes that share tq)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = dbsum[q][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (grp == 0) dbacc[q][e] += v;
        }
      fence_proxy_async();   // the slice is read by the bulk copies below
    } else if (is_rec && s + 1 < T) {
      load_h(tprev + step, s + 2 == T, rec0, n_rec);   // the next h_prev
    }
    __syncthreads();   // the CTA's dgh slice is in dgt; ght is read

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

    if (is_cmp) {      // ---- dh = bf16(dgh) @ W_hh^T + dh_tot * z ----------
      xbar_wait(xbar, s & 1);                 // the peers' slices of step s
      float acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const __nv_bfloat16* ap = dgt + arow * sw + 2 * tq;
      const __nv_bfloat16* bp = ws + (jl - 2 * tq + grp) * gs + 2 * tq;
#pragma unroll 4
      for (int k = 0; k < G3 / 16; ++k) {
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
      for (int i = 0; i < 4; ++i) dh[i] = acc2[i] + carry[i];
    } else if (is_rec && s + 1 < T) {
      recompute(s + 1);                       // off the serial chain
    }
    if (threadIdx.x < C - 1) bulk_wait_read();   // before dgt is written again
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");

  // one db_hh partial per 16-row tile of the batch, as the single block
  if (is_cmp && grp == 0) {
    float* out = dbhh + (size_t)(row0 / ROWS + mt) * G3 + col0 + jl;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) out[q * H + e] = dbacc[q][e];
  }
}

template <bool RESIDENT>
cudaError_t prepare_cluster(int C, size_t smem) {
  auto kernel = gru_bwd_cluster_kernel<RESIDENT>;
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
int launch_cluster(const void* gates, const void* h_seq, const void* gout,
                   const void* w, const void* wf, const void* bhh, void* dgx,
                   void* dhn, void* dbhh, int T, int B, int H, int reverse,
                   int C, int R, void* stream) {
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
  err = cudaLaunchKernelEx(&cfg, gru_bwd_cluster_kernel<RESIDENT>,
                           (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)h_seq,
                           (const __nv_bfloat16*)gout,
                           (const __nv_bfloat16*)w, (const uint4*)wf,
                           (const float*)bhh, (__nv_bfloat16*)dgx,
                           (__nv_bfloat16*)dhn, (float*)dbhh, T, B, H, R,
                           reverse);
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
      n, gru_bwd_cluster_kernel<RESIDENT>, &cfg);
}

// Shared bytes of one block of the single-block scan.
size_t block_smem(int H) {
  return ((size_t)ROWS * (H + PAD) + (size_t)ROWS * (3 * H + PAD)) *
             sizeof(__nv_bfloat16) +
         ((size_t)ROWS * H + 2 * (size_t)3 * H) * sizeof(float);
}

// ---- dW_hh = A^T @ [D1[:, :2H], D2] over N rows, in slices ----------------

constexpr int DW_TM = 128;                   // dW_hh rows (units) per CTA
constexpr int DW_TN = 256;                   // dW_hh columns per CTA
constexpr int DW_TK = 64;                    // rows of A and D per stage
constexpr int DW_STAGES = 4;
constexpr int DW_BOX = DW_TK * 64 * 2;       // one TMA box: 64 rows x 128 B
constexpr int DW_STAGE = (DW_TM / 64 + DW_TN / 64) * DW_BOX;   // 48 KB
constexpr int DW_THREADS = 9 * 32;           // warps 0-7 compute, warp 8 loads
constexpr size_t DW_SMEM = DW_STAGES * DW_STAGE + 2 * DW_STAGES * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One box of a 2-D tensor map, {column, row}, into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(bar)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading byte offset (between 64-element blocks along M or
// N), stride byte offset (between 8-row groups along K), all >> 4.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[64 x 256] += A[64 x 16] @ B[16 x 256], bf16 from shared memory, both
// MN-major (the transpose flags: K is the slow axis of both tiles), fp32 in
// registers.
__device__ __forceinline__ void wgmma_m64n256k16_tt(float (&d)[128],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] @ B[16 x 128], as wgmma_m64n256k16_tt on the
// first 128 columns: the first 64 accumulators of d.
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&d)[128],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// A consumer warpgroup's stages: wait for the stage's boxes, run its four
// k16 products (m64n128k16 for HALF_N, else m64n256k16) on its 64 rows,
// and hand the slot back to the producer once the wait that retires its
// group returns: at once (INFLIGHT 0), or after the next stage's products
// were issued (INFLIGHT 1). The loop holds no branch around its products:
// with one there, the products ran slower a stage on an H100 than with
// every group waited for.
template <int INFLIGHT, bool HALF_N>
__device__ __forceinline__ void dwhh_stages(float (&acc)[128], uint32_t base,
                                            uint32_t full, uint32_t empty,
                                            int iters, int wg, bool leader) {
  for (int it = 0; it < iters; ++it) {
    const int s = it % DW_STAGES;
    mbar_wait(full + 8 * s, (it / DW_STAGES) & 1);
    const uint32_t a_tile = base + s * DW_STAGE + wg * DW_BOX;
    const uint32_t d_tile = base + s * DW_STAGE + (DW_TM / 64) * DW_BOX;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < DW_TK / 16; ++kk) {   // 16 rows = 2048 B of a box
      const uint64_t da = wgmma_desc(a_tile + 2048 * kk, DW_BOX, 1024);
      const uint64_t db = wgmma_desc(d_tile + 2048 * kk, DW_BOX, 1024);
      if constexpr (HALF_N)
        wgmma_m64n128k16_tt(acc, da, db);
      else
        wgmma_m64n256k16_tt(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if constexpr (INFLIGHT == 1) {
      // the group of stage it - 1 has retired: its slot may be refilled
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (leader && it > 0) mbar_arrive(empty + 8 * ((it - 1) % DW_STAGES));
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (leader) mbar_arrive(empty + 8 * s);
    }
  }
  if constexpr (INFLIGHT == 1)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// part[z] = A[n0:n1]^T @ D[n0:n1] for one 128 x 256 tile of dW_hh. The tile's
// columns come whole from dgx (the first 2H) or from dhn. Warp 8 keeps
// DW_STAGES stages of TMA boxes in flight; warpgroups 0 and 1 each run
// wgmma on 64 of the tile's rows.
//   * INFLIGHT 0 is the first design: every stage's group waited for at
//     once, m64n256k16 on every tile.
//   * INFLIGHT 1: one group of products stays in flight while the next
//     stage's is issued; a tile of at most 128 columns runs m64n128k16
//     (half the products), and a warpgroup whose 64 rows lie beyond H runs
//     none.
// A tile of fewer columns than DW_TN (dhn's ragged last one) is narrow: it
// is cut into `narrow_slices` slices of narrow_rows rows, and its partials
// z >= narrow_slices are written zero.
template <int INFLIGHT>
__global__ void __launch_bounds__(DW_THREADS, 1)
gru_dwhh_kernel(const __grid_constant__ CUtensorMap map_a,    // h_prev [N, H]
                const __grid_constant__ CUtensorMap map_d1,   // dgx [N, :2H]
                const __grid_constant__ CUtensorMap map_d2,   // dhn [N, H]
                float* __restrict__ part,                     // [slices, H, 3H]
                int N, int H, int rows_per_slice, int narrow_slices,
                int narrow_rows) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + DW_STAGES * DW_STAGE;   // DW_STAGES barriers
  const uint32_t empty = full + DW_STAGES * 8;         // DW_STAGES barriers

  const int n_d1 = (2 * H + DW_TN - 1) / DW_TN;
  const bool from_d2 = (int)blockIdx.y >= n_d1;
  const int c0 = ((int)blockIdx.y - (from_d2 ? n_d1 : 0)) * DW_TN;
  const int c_end = from_d2 ? H : 2 * H;      // columns of the source
  const int m0 = blockIdx.x * DW_TM;
  // boxes wholly outside the tile's rows or its source's columns are not
  // loaded: they could only reach outputs that are not written
  const int a_boxes = min(DW_TM / 64, (H - m0 + 63) / 64);
  const int d_boxes = min(DW_TN / 64, (c_end - c0 + 63) / 64);
  const bool narrow = d_boxes < DW_TN / 64;
  const int per = narrow ? narrow_rows : rows_per_slice;
  const int n0 = blockIdx.z * per;
  const int n1 = narrow && (int)blockIdx.z >= narrow_slices ? n0
                                                            : min(N, n0 + per);
  const int iters = n1 > n0 ? (n1 - n0 + DW_TK - 1) / DW_TK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);            // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    if (lane != 0) return;
    const int bytes = (a_boxes + d_boxes) * DW_BOX;
    const CUtensorMap* dmap = from_d2 ? &map_d2 : &map_d1;
    for (int it = 0; it < iters; ++it) {
      const int s = it % DW_STAGES;
      if (it >= DW_STAGES) mbar_wait(empty + 8 * s, ((it / DW_STAGES) - 1) & 1);
      const uint32_t bar = full + 8 * s, st = base + s * DW_STAGE;
      mbar_expect_tx(bar, bytes);
      const int n = n0 + it * DW_TK;          // rows beyond N arrive as zeros
      for (int b = 0; b < a_boxes; ++b)
        tma_load(st + b * DW_BOX, &map_a, m0 + 64 * b, n, bar);
      for (int b = 0; b < d_boxes; ++b)
        tma_load(st + (DW_TM / 64 + b) * DW_BOX, dmap, c0 + 64 * b, n, bar);
    }
    return;
  }

  const int wg = warp >> 2;                 // rows m0 + 64 wg .. + 63
  const bool leader = (threadIdx.x & 127) == 0;
  // the first design (INFLIGHT 0) ran n256 and both warpgroups everywhere
  const bool mma_on = !INFLIGHT || m0 + 64 * wg < H;   // warpgroup-uniform
  const bool half_n = INFLIGHT && d_boxes <= 2;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if (!mma_on) {            // rows beyond H: only hand the slots back
    for (int it = 0; it < iters; ++it) {
      const int s = it % DW_STAGES;
      mbar_wait(full + 8 * s, (it / DW_STAGES) & 1);
      if (leader) mbar_arrive(empty + 8 * s);
    }
  } else if (half_n) {
    dwhh_stages<INFLIGHT, true>(acc, base, full, empty, iters, wg, leader);
  } else {
    dwhh_stages<INFLIGHT, false>(acc, base, full, empty, iters, wg, leader);
  }

  // accumulator 4i + 2 half + e: row 16 (warp % 4) + lane/4 + 8 half of
  // the warpgroup's 64, column 8i + 2 (lane % 4) + e of the tile's 256
  const int G3 = 3 * H, col_off = from_d2 ? 2 * H : 0;
  float* out = part + (size_t)blockIdx.z * H * G3;
  const int m = m0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < DW_TN / 8; ++i) {
    const int c = c0 + 8 * i + 2 * (lane & 3);
    if (c >= c_end) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (m + 8 * half < H)
        *reinterpret_cast<float2*>(out + (size_t)(m + 8 * half) * G3 +
                                   col_off + c) =
            make_float2(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 [rows, cols] with row stride ld elements, in boxes of 64 columns x
// DW_TK rows, 128-byte swizzle; elements outside [rows, cols] read as zero.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows,
              int cols, int ld) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, DW_TK};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// The scan. gates [T, B, 3H], h_seq, gout [T, B, H], wt [3H, H], w [H, 3H],
// all bf16, bhh [3H] fp32 -> dgx [T, B, 3H] bf16, dhn [T, B, H] bf16,
// dbhh [n_blocks, 3H] fp32, one row per 16-row tile of the batch: the call
// is refused unless n_blocks is ceil(B / 16). H must be a multiple of 16.
// wf is wt in MMA fragment order, [3][H/8][H/32][32] of 16 bytes (ops/gru.py
// via ops/lstm.py _fragment_weight), read by the cluster design (H % 64 ==
// 0 there); the single block reads wt.
// The launch plan (ops/gru.py plan_bwd_scan): cluster = 1 runs the
// single-block design (rows 16, resident 0); cluster = 8 or 16 a cluster of
// that many CTAs over `rows` rows each, with the recompute's W_hh^T slice in
// shared memory when `resident`. smem_bytes must be the design's.
int gru_scan_bwd(const void* gates, const void* h_seq, const void* gout,
                 const void* wt, const void* w, const void* wf,
                 const void* bhh, void* dgx, void* dhn, void* dbhh,
                 int n_blocks, int T, int B, int H, int reverse, int cluster,
                 int rows, int resident, int smem_bytes, void* stream) {
  if (n_blocks != row_blocks(B) || H <= 0 || H % 16)
    return (int)cudaErrorInvalidValue;
  if (cluster != 1) {
    if (!bwd_plan_fits(H, cluster, rows) ||
        (size_t)smem_bytes != bwd_cluster_smem(H, cluster, rows, resident))
      return (int)cudaErrorInvalidValue;
    if (resident)
      return launch_cluster<true>(gates, h_seq, gout, w, wf, bhh, dgx, dhn,
                                  dbhh, T, B, H, reverse, cluster, rows,
                                  stream);
    return launch_cluster<false>(gates, h_seq, gout, w, wf, bhh, dgx, dhn,
                                 dbhh, T, B, H, reverse, cluster, rows, stream);
  }
  const size_t smem = block_smem(H);
  if (rows != ROWS || resident || (size_t)smem_bytes != smem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(row_blocks(B));
  gru_scan_bwd_kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)gates, (const __nv_bfloat16*)h_seq,
      (const __nv_bfloat16*)gout, (const __nv_bfloat16*)wt,
      (const __nv_bfloat16*)w, (const float*)bhh, (__nv_bfloat16*)dgx,
      (__nv_bfloat16*)dhn, (float*)dbhh, T, B, H, reverse);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the scan's cluster design (resident or
// not) for a cluster of `cluster` CTAs over `rows` rows at H: *n clusters
// can run at once on the current device.
int gru_scan_bwd_max_clusters(int resident, int H, int cluster, int rows,
                              int* n) {
  if (!bwd_plan_fits(H, cluster, rows)) return (int)cudaErrorInvalidValue;
  return resident ? max_clusters<true>(H, cluster, rows, n)
                  : max_clusters<false>(H, cluster, rows, n);
}

// The contraction. a [N, H], d1 [N, 3H], d2 [N, H], all bf16, 16-byte
// aligned, H a multiple of 8 -> part [n_slices, H, 3H] fp32 with sum over
// slices = a^T @ [d1[:, :2H], d2]. Slice z of a tile takes rows [z*P,
// (z+1)*P) with P = ceil(ceil(N / n_slices) / 64) * 64, and of a narrow tile
// (one that loads fewer boxes a stage) rows [z*P', (z+1)*P') with P' from
// narrow_slices (1 <= narrow_slices <= n_slices) the same way, the partials
// beyond written zero (ops/gru.py plan_dwhh); every element of part is
// written, zero for an empty slice. in_flight (0 or 1): wgmma groups of a
// stage left running while the next stage's are issued; 1 also runs the
// half-width product on a tile of at most 128 columns and none in a
// warpgroup beyond H, 0 is the first design's loop as it was.
int gru_scan_bwd_dwhh(const void* a, const void* d1, const void* d2,
                      void* part, int N, int H, int n_slices,
                      int narrow_slices, int in_flight, void* stream) {
  if (N <= 0 || H <= 0 || H % 8 || n_slices <= 0 || narrow_slices <= 0 ||
      narrow_slices > n_slices || (in_flight != 0 && in_flight != 1))
    return (int)cudaErrorInvalidValue;
  auto rows_of = [N](int slices) {
    const int per = (N + slices - 1) / slices;
    return (per + DW_TK - 1) / DW_TK * DW_TK;
  };
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_d1, map_d2;
  if (!make_map(encode, &map_a, a, N, H, H) ||
      !make_map(encode, &map_d1, d1, N, 2 * H, 3 * H) ||
      !make_map(encode, &map_d2, d2, N, H, H))
    return (int)cudaErrorInvalidValue;
  auto kernel = in_flight ? gru_dwhh_kernel<1> : gru_dwhh_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + DW_TM - 1) / DW_TM,
                  (2 * H + DW_TN - 1) / DW_TN + (H + DW_TN - 1) / DW_TN,
                  n_slices);
  kernel<<<grid, DW_THREADS, DW_SMEM, (cudaStream_t)stream>>>(
      map_a, map_d1, map_d2, (float*)part, N, H, rows_of(n_slices),
      narrow_slices, rows_of(narrow_slices));
  return (int)cudaGetLastError();
}

const char* gru_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
