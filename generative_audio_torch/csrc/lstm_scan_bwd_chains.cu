// Kernel G: the LSTM backward scan with independent accumulator chains, as a
// thread-block cluster, for sm_90a.
//
// Replaces chains_bwd / _chains_bwd_kernel of scripts/perf_lstm_chains.py:
// the production backward (_lstm_pallas_call_bwd of
// generative_audio_tpu/ops/pallas_lstm.py, kernel D here) whose block is
// split into independent chunks, each phase run for all chunks before the
// next. It computes kernel D's dgates bit for bit (lstm_scan_bwd.cu states
// the recurrence) for a forward that was not reversed; the single-block
// route of kernel G, for an H that no cluster holds, is lstm_scan_bwd.cu's
// lstm_scan_bwd_chains_block.
//
// What bounds it on an H100: what bounds kernel D. At the training shape
// (T = 195, 2304 rows, H = 384) 3.8 GB of streams (1.13 ms at 3.35 TB/s)
// against 1.06 TFLOP (1.07 ms); what the design pays is the serial chain of
// T steps, and in each step the second product: 4H / 16 = 96 dependent
// mma.sync k-steps of one accumulator, kept in kernel D's k order so that
// dgates stay bit-identical.
//
// Design: kernel D's cluster (lstm_scan_bwd.cu lstm_bwd_cluster_kernel):
// C = 8 or 16 CTAs split the units, each keeps its W_hh slice resident, the
// dgates slices go to the peers by cp.async.bulk on an mbarrier, and warps
// of their own recompute the next step's gates, one (m16 row tile, 8 units)
// item each, with kernel D's code. What differs is the compute warp: where
// kernel D gives one item to a warp, kernel G gives it up to N (the chain
// count, 2 or 4) and runs each phase for all of them before the next: the
// elementwise backward of every chain, then the sends, then the second
// product, in which the chains' mma.sync follow one another k-step by
// k-step, so that one warp has N independent accumulator chains in flight.
// The chains of a warp are either
//   * row tiles of one group of 8 units (ARRANGE_ROWS, the script's
//     meaning): each k-step's B fragment from the resident W_hh slice is
//     loaded once and feeds all N products; or
//   * groups of units of one row tile (ARRANGE_UNITS, where the cluster has
//     fewer row tiles than chains): the A fragment from the dgates tile is
//     loaded once and feeds all N.
// A warp takes fewer chains where the items do not divide. Each chain keeps
// kernel D's operands, k order from zero accumulators and cell expression.
// The layout of shared memory is kernel D's (bwd_cluster_smem), the warps
// are ceil(items / N) compute warps and one recompute warp an item, out of
// chain_cta_warps(N).
//
// Plain C interface for ctypes; each function returns the cudaError_t of its
// launch (0 on success). Launches go to the caller's stream and do not
// synchronise.

#include <cooperative_groups.h>
#include <type_traits>

#include "scan_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int ARRANGE_ROWS = 0, ARRANGE_UNITS = 1;

// Warps of a CTA with N chains a compute warp: 12 for two chains and 8 for
// four, so that ptxas may give a thread 168 or 255 registers (at 16 warps,
// kernel D's count, it capped them at 128 and every instance spilled:
// 24-424 B). Every plan at H = 384 and 512 fits (items + compute warps).
__host__ __device__ constexpr int chain_cta_warps(int N) {
  return N == 2 ? 12 : 8;
}

// Row stride (bf16) of one CTA's slice of the dgates tile: kernel D's.
__host__ __device__ inline int slice_stride(int U) {
  return 4 * U + (4 * U % 16 == 0 ? 8 : 16);
}

// Shared bytes of one CTA: kernel D's layout (lstm_scan_bwd.cu
// bwd_cluster_smem): the W_hh^T slice in fragment order when RESIDENT, the
// W_hh slice [U][4H + PAD], h_prev [R][H + PAD], the dgates tile
// [C][R][slice_stride(U)], the recomputed z [R][4U] fp32, c_t, c_prev and
// gout [3][R][U] bf16, the k-step table and the exchange's mbarrier.
size_t chains_cluster_smem(int H, int C, int R, bool resident) {
  const size_t U = H / C, hs = H + PAD, gs = 4 * (size_t)H + PAD, r = R;
  return ((resident ? 4 * U * (size_t)H : 0) + U * gs + r * hs +
          C * r * slice_stride(U)) * 2 +
         r * 4 * U * 4 + 3 * r * U / 2 * 4 + 4 * (size_t)H / 16 * 8 + 16;
}

// Compute warps of a CTA with mt row tiles and g groups of 8 units, N
// chains a warp.
__host__ __device__ inline int compute_warps(int mt, int g, int N,
                                             int arrange) {
  return arrange == ARRANGE_ROWS ? (mt + N - 1) / N * g
                                 : mt * ((g + N - 1) / N);
}

bool chains_plan_fits(int H, int C, int R, int N, int arrange) {
  if (!(C == 8 || C == 16) || H <= 0 || H % (8 * C) || R <= 0 || R % 16 ||
      !(N == 2 || N == 4) || !(arrange == ARRANGE_ROWS || arrange == ARRANGE_UNITS))
    return false;
  const int items = R / 16 * (H / C / 8);
  return compute_warps(R / 16, H / C / 8, N, arrange) + items <=
         chain_cta_warps(N);
}

template <int N, int ARRANGE, bool RESIDENT>
__global__ void __launch_bounds__(chain_cta_warps(N) * 32, 1)
lstm_chains_cluster_kernel(const __nv_bfloat16* __restrict__ gates,
                           const __nv_bfloat16* __restrict__ h_seq,
                           const __nv_bfloat16* __restrict__ c_seq,
                           const __nv_bfloat16* __restrict__ gout,
                           const __nv_bfloat16* __restrict__ w,    // [H, 4H]
                           const uint4* __restrict__ wf,   // wt, fragment order
                           __nv_bfloat16* __restrict__ dgates,
                           int T, int B, int H, int R) {
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
  const int G = U / 8, MT = mrows / 16, n_items = MT * G;
  const int n_cmp = compute_warps(MT, G, N, ARRANGE);
  // warps [0, n_cmp) run the elementwise part and the second product of up
  // to N items each; warps [n_cmp, n_cmp + n_items) the gates recompute of
  // one item each (item = row tile * G + unit group), one step ahead
  const bool is_cmp = warp < n_cmp;
  const bool is_rec = !is_cmp && warp < n_cmp + n_items;
  const int rec0 = n_cmp * 32, n_rec = n_items * 32;   // recompute threads

  // a compute warp's chains: chain c is (row tile mt0 + c * dmt, unit group
  // g0 + c * dg), c < nc
  int mt0 = 0, g0 = 0, nc = 0;
  if (is_cmp) {
    if (ARRANGE == ARRANGE_ROWS) {
      mt0 = warp / G * N;
      g0 = warp % G;
      nc = min(N, MT - mt0);
    } else {
      const int gb = (G + N - 1) / N;
      mt0 = warp / gb;
      g0 = warp % gb * N;
      nc = min(N, G - g0);
    }
  }
  constexpr int DMT = ARRANGE == ARRANGE_ROWS ? 1 : 0, DG = 1 - DMT;

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
  // backward step s processes array time T-1-s (the forward was not
  // reversed); the position before it is one earlier
  load_h(T - 2, T == 1, 0, nthreads);

  // a recompute warp: z = gates + h_prev @ W_hh (kernel D's first product)
  // of step s into zt, and that step's c_t, c_prev and gout into ct_s, cp_s
  // and go_s, for its item (kernel D's recompute, unchanged)
  const int ritem = is_rec ? warp - n_cmp : 0;
  const int rmt = ritem / G, rjl = 8 * (ritem % G) + 2 * tq;
  const int rrow = rmt * 16 + grp;            // its A fragments' first row
  auto recompute = [&](int s) {
    const int t = T - 1 - s, tprev = t - 1;
    const bool first = (s == T - 1);          // p == 0: zero c_prev
    uint32_t gx_raw[2][4], ct_raw[2], cp_raw[2], go_raw[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rrow + 8 * half, row = row0 + r;
      const bool valid = r < nrows;
      const size_t at = ((size_t)t * B + row) * H + col0 + rjl;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gx_raw[half][q] =
            valid ? ldg32(gates + ((size_t)t * B + row) * G4 + q * H + col0 + rjl)
                  : 0u;
      ct_raw[half] = valid ? ldg32(c_seq + at) : 0u;
      go_raw[half] = valid ? ldg32(gout + at) : 0u;
      cp_raw[half] = valid && !first
                         ? ldg32(c_seq + ((size_t)tprev * B + row) * H + col0 + rjl)
                         : 0u;
    }
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    const size_t per_q = RESIDENT ? (size_t)(U / 8) * (H / 32) * 32
                                  : (size_t)(H / 8) * (H / 32) * 32;
    const uint4* fsrc =
        (RESIDENT ? wts + (size_t)(ritem % G) * (H / 32) * 32
                  : wf + (size_t)((col0 + rjl - 2 * tq) / 8) * (H / 32) * 32) +
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
        load_a(a, htile + rrow * hs + (k0 + kk) * 16 + 2 * tq, hs);
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
      const int r = rrow + 8 * half;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 gx = bf2(gx_raw[half][q]);
        *reinterpret_cast<float2*>(zt + r * U4 + q * U + rjl) =
            make_float2(gx.x + acc[q][2 * half], gx.y + acc[q][2 * half + 1]);
      }
      ct_s[r * U / 2 + rjl / 2] = ct_raw[half];
      cp_s[r * U / 2 + rjl / 2] = cp_raw[half];
      go_s[r * U / 2 + rjl / 2] = go_raw[half];
    }
  };

  // a compute warp's state for its chains' (row, unit) pairs: dh[c][2 half
  // + e] is row (mt0 + c dmt)*16 + grp + 8 half, unit col0 + 8 (g0 + c dg)
  // + 2 tq + e
  float dh[N][4], dc[N][4];
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) dh[c][i] = dc[c][i] = 0.0f;

  cluster.sync();      // every CTA has started and filled its slices
  if (is_rec) recompute(0);

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s, tprev = t - 1;
    __syncthreads();   // step s's z is in zt; the last second product is done

    if (is_cmp) {      // ---- the elementwise backward of every chain ------
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (c >= nc) break;
        const int arow = (mt0 + c * DMT) * 16 + grp;
        const int jl = 8 * (g0 + c * DG) + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = arow + 8 * half, row = row0 + r;
          const bool valid = r < nrows;
          float z[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 zq =
                *reinterpret_cast<const float2*>(zt + r * U4 + q * U + jl);
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
            const float dh_tot = g_out[e] + dh[c][2 * half + e];
            const float dc_tot =
                dc[c][2 * half + e] + dh_tot * og * (1.0f - tc * tc);
            dg[0][e] = dc_tot * gg * gi * (1.0f - gi);
            dg[1][e] = dc_tot * c_prev[e] * gf * (1.0f - gf);
            dg[2][e] = dc_tot * gi * (1.0f - gg * gg);
            dg[3][e] = dh_tot * tc * og * (1.0f - og);
            dc[c][2 * half + e] = dc_tot * gf;
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
      }
      fence_proxy_async();   // the slice is read by the bulk copies below
    } else if (is_rec && s + 1 < T) {
      load_h(tprev - 1, s + 2 == T, rec0, n_rec);   // the next h_prev
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

    if (is_cmp) {      // ---- dh = bf16(dgates) @ W_hh^T, every chain -----
      xbar_wait(xbar, s & 1);                 // the peers' slices of step s
      float acc2[N][4];
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc2[c][i] = 0.0f;
      // chain c's A fragments (dgates rows of its tile) and B fragments
      // (rows of its units in the resident W_hh slice)
      const __nv_bfloat16* ap = dgt + (mt0 * 16 + grp) * sw + 2 * tq;
      const __nv_bfloat16* bp = ws + (8 * g0 + grp) * gs + 2 * tq;
#pragma unroll 2
      for (int k = 0; k < G4 / 16; ++k) {
        // the k-step's columns, whose two halves lie in the slices of the
        // CTAs that own their units
        const int2 o = koff[k];
        if (ARRANGE == ARRANGE_ROWS) {        // one B fragment, N tiles of A
          const uint32_t b0 = ld32(bp + k * 16), b1 = ld32(bp + k * 16 + 8);
#pragma unroll
          for (int c = 0; c < N; ++c) {
            if (c < nc) {
              const __nv_bfloat16* a_c = ap + c * 16 * sw;
              uint32_t a[4];
              a[0] = ld32(a_c + o.x);
              a[1] = ld32(a_c + o.x + 8 * sw);
              a[2] = ld32(a_c + o.y);
              a[3] = ld32(a_c + o.y + 8 * sw);
              mma_bf16_16816(acc2[c], a, b0, b1);
            }
          }
        } else {                              // one A fragment, N unit groups
          uint32_t a[4];
          a[0] = ld32(ap + o.x);
          a[1] = ld32(ap + o.x + 8 * sw);
          a[2] = ld32(ap + o.y);
          a[3] = ld32(ap + o.y + 8 * sw);
#pragma unroll
          for (int c = 0; c < N; ++c) {
            if (c < nc) {
              const __nv_bfloat16* b_c = bp + c * 8 * gs + k * 16;
              mma_bf16_16816(acc2[c], a, ld32(b_c), ld32(b_c + 8));
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) dh[c][i] = acc2[c][i];
    } else if (is_rec && s + 1 < T) {
      recompute(s + 1);                       // off the serial chain
    }
    if (threadIdx.x < C - 1) bulk_wait_read();   // before dgt is written again
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

cudaLaunchAttribute cluster_attr(int C) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Launch an instance as clusters of C CTAs over R rows each, or, with n
// set, ask for its cudaOccupancyMaxActiveClusters instead.
template <int N, int ARRANGE, bool RESIDENT>
int run(const void* gates, const void* h_seq, const void* c_seq,
        const void* gout, const void* w, const void* wf, void* dgates, int T,
        int B, int H, int C, int R, void* stream, int* n) {
  auto kernel = lstm_chains_cluster_kernel<N, ARRANGE, RESIDENT>;
  const size_t smem = chains_cluster_smem(H, C, R, RESIDENT);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr = cluster_attr(C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n ? C : C * ((B + R - 1) / R));
  cfg.blockDim = dim3(32 * chain_cta_warps(N));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (n) return (int)cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, (const __nv_bfloat16*)gates,
                           (const __nv_bfloat16*)h_seq,
                           (const __nv_bfloat16*)c_seq,
                           (const __nv_bfloat16*)gout,
                           (const __nv_bfloat16*)w, (const uint4*)wf,
                           (__nv_bfloat16*)dgates, T, B, H, R);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int N, int ARRANGE>
int run_resident(int resident, const void* gates, const void* h_seq,
                 const void* c_seq, const void* gout, const void* w,
                 const void* wf, void* dgates, int T, int B, int H, int C,
                 int R, void* stream, int* n) {
  if (resident)
    return run<N, ARRANGE, true>(gates, h_seq, c_seq, gout, w, wf, dgates, T,
                                 B, H, C, R, stream, n);
  return run<N, ARRANGE, false>(gates, h_seq, c_seq, gout, w, wf, dgates, T,
                                B, H, C, R, stream, n);
}

// The instance of (N, arrangement, resident): launch, or with n set the
// occupancy query. The plan must fit (chains_plan_fits).
int dispatch(int N, int arrange, int resident, const void* gates,
             const void* h_seq, const void* c_seq, const void* gout,
             const void* w, const void* wf, void* dgates, int T, int B, int H,
             int C, int R, void* stream, int* n) {
  if (N == 2 && arrange == ARRANGE_ROWS)
    return run_resident<2, ARRANGE_ROWS>(resident, gates, h_seq, c_seq, gout,
                                         w, wf, dgates, T, B, H, C, R, stream, n);
  if (N == 2)
    return run_resident<2, ARRANGE_UNITS>(resident, gates, h_seq, c_seq, gout,
                                          w, wf, dgates, T, B, H, C, R, stream, n);
  if (arrange == ARRANGE_ROWS)
    return run_resident<4, ARRANGE_ROWS>(resident, gates, h_seq, c_seq, gout,
                                         w, wf, dgates, T, B, H, C, R, stream, n);
  return run_resident<4, ARRANGE_UNITS>(resident, gates, h_seq, c_seq, gout,
                                        w, wf, dgates, T, B, H, C, R, stream, n);
}

}  // namespace

extern "C" {

// Kernel G. gates [T, B, 4H], h_seq, c_seq, gout [T, B, H], w [H, 4H], all
// bf16, wf = W_hh^T [4H, H] in MMA fragment order (ops/lstm.py
// _fragment_weight) -> dgates [T, B, 4H] bf16, the backward of a forward
// that was not reversed, bit-identical to kernel D (lstm_scan_bwd). The
// launch plan (ops/lstm.py plan_chains_scan): n_chains = 2 or 4 chains a
// compute warp, clusters of `cluster` CTAs (8 or 16, H a multiple of 8 *
// cluster) over `rows` rows each (a multiple of 16), the recompute's W_hh^T
// slice in shared memory when `resident`, the chains of a warp row tiles
// (arrange 0) or unit groups (arrange 1); smem_bytes must be the layout's.
int lstm_scan_bwd_chains(const void* gates, const void* h_seq,
                         const void* c_seq, const void* gout, const void* w,
                         const void* wf, void* dgates, int T, int B, int H,
                         int n_chains, int cluster, int rows, int resident,
                         int arrange, int smem_bytes, void* stream) {
  if (!chains_plan_fits(H, cluster, rows, n_chains, arrange) ||
      (size_t)smem_bytes != chains_cluster_smem(H, cluster, rows, resident))
    return (int)cudaErrorInvalidValue;
  return dispatch(n_chains, arrange, resident, gates, h_seq, c_seq, gout, w,
                  wf, dgates, T, B, H, cluster, rows, stream, nullptr);
}

// cudaOccupancyMaxActiveClusters of the instance (n_chains, arrange,
// resident) for a cluster of `cluster` CTAs over `rows` rows at H: *n
// clusters can run at once on the current device.
int lstm_scan_bwd_chains_max_clusters(int n_chains, int arrange, int resident,
                                      int H, int cluster, int rows, int* n) {
  if (!chains_plan_fits(H, cluster, rows, n_chains, arrange))
    return (int)cudaErrorInvalidValue;
  return dispatch(n_chains, arrange, resident, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, 0, 0, H, cluster, rows,
                  nullptr, n);
}

const char* lstm_scan_bwd_chains_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
