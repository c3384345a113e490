// The general-shape ConvLSTM kernels: K5 and K6 at every shape the TPU
// kernels take (any B, T, H, W, F and C; bf16 or f32 activations; f32 or
// bf16 gates), where the wgmma kernels of convlstm_wgmma.cuh do not run
// (convlstm_launch.cuh's route: H*W > 64, F off their multiples, f32 above
// F = 128, C off the multiples of 16 or too wide for their rings).
//
// Design.  One launch runs a recurrence's whole time loop, as the TPU's one
// pallas_call does: a cluster of `cl` CTAs a sample (1-8, the wrapper's
// choice), CTA r owning channels [F r / cl, F (r + 1) / cl) of all four
// gates so that the cell math stays in the CTA.  The recurrent operand
// (h_{t-1} in the forward, dgates_t in the BPTT) lives in global memory
// (double-buffered h; the dgates scratch itself), each CTA writing its own
// channels, and one cluster barrier a step (after a __threadfence) makes a
// step's writes visible to the cluster; the cell state and the carried
// (dh, dc) are f32 in global memory, each cell read and written by one
// thread.  Every product is an f32 FMA on operands converted from the
// activation type (exact products in bf16, f32-accurate in f32: no TF32),
// in tiles of bm positions x bn columns staged through shared memory, 4 x 4
// outputs a thread, summed in a fixed order.
// - forward: per step and tile, K5's x segment (x_t Wx) and the 9 taps
//   (conv3x3 of h_{t-1}) in two accumulators; the epilogue rounds the x
//   segment with its bias (K5) or xg_t (K6) and the taps to the gate dtype
//   apart and adds them in it, as the TPU kernel does; then it runs the
//   cell (lstm_cell_ieee) on the 4
//   gates of one channel, which the weight packing puts in one thread's 4
//   columns (column 4 ch + q);
// - BPTT: per step a pointwise pass (the cell backward from the saved
//   residuals; dgates rounded to the activation type into the scratch dG;
//   K5's dbx from per-channel sums of the unrounded dgates over positions,
//   in a fixed order; K6's time-constant dxg summed over t in f32, each
//   cell by one thread), the cluster barrier, then dh_{t-1} by the
//   transposed taps (K = 9 x 4F);
// - after the BPTT: K5's dx = dG Wx^T (gen_dx_kernel) and the weight GEMM
//   (gen_wgrad_kernel: dW and dWx as one (C + 9F) x 4F product over the B T
//   H W rows, split in K with the partials summed in split order).
// No float atomics: two calls give bit-identical results.
//
// What bounds it: at the full-width shapes the products, (C + 9F) x 4F per
// position and step, on the CUDA cores' f32 FMA (67 TFLOP/s on the H100 at
// best) instead of the tensor cores; PERF.md gives the times beside the
// bounds of the same work.  A simple design first: making it fast
// (mma.sync or wgmma tiles, h in shared memory) is later work.
#pragma once

#include "convlstm_wgmma.cuh"

namespace mmvae {
namespace {

constexpr int GEN_THREADS = 256, GEN_BK = 16, GEN_MAX_BM = 256, GEN_MAX_BN = 64;

// The cell with bf16 gates from IEEE expf, division and tanhf, each op
// rounded to bf16 as torch's bf16 ops round it, so that from the same
// pre-activations it gives the plain version's bits (lstm_cell_fast's
// special-function unit errs by a few f32 ulps, which can flip a bf16
// rounding); with f32 gates it is lstm_cell_fast, bit for bit.
template <typename G>
__device__ __forceinline__ Cell lstm_cell_ieee(float pi, float pf, float pg, float po, float c) {
  if constexpr (std::is_same<G, float>::value) {
    return lstm_cell_fast<G>(pi, pf, pg, po, c);
  } else {
    auto sig = [](float v) {
      return round_to<G>(1.f / round_to<G>(1.f + round_to<G>(expf(-v))));
    };
    Cell r;
    r.i = sig(pi);
    r.f = sig(round_to<G>(pf + 1.f));
    r.g = round_to<G>(tanhf(pg));
    r.o = sig(po);
    r.c = round_to<G>(round_to<G>(r.f * c) + round_to<G>(r.i * r.g));
    r.h = round_to<G>(r.o * round_to<G>(tanhf(r.c)));
    return r;
  }
}

// The output tile of a pass with `cols` columns: bn columns (16, 32 or 64)
// and bm = 4096 / bn positions, 4 x 4 outputs a thread; lbn = log2(bn / 4).
struct GenTile {
  int bm, bn, lbn;
};
__host__ __device__ inline GenTile gen_tile(int cols) {
  if (cols <= 16) return {256, 16, 2};
  if (cols <= 32) return {128, 32, 3};
  return {64, 64, 4};
}

// Rows of the weight GEMM summed in one FMA chain before they join the total.
constexpr int GEN_WGRAD_RUN = 1024;

// CTAs a sample the general kernels may take.
constexpr int GEN_MAX_CLUSTER = 8;

struct GenSmem {
  float a[GEN_BK * (GEN_MAX_BM + 4)];  // [k][position], rows padded by 4 floats
  float b[GEN_BK * GEN_MAX_BN];        // [k][column]
  float red[GEN_THREADS * 4];          // K5's BPTT: per-slice column sums
};

// As[k][r] = src[q * ld + k0 + k] for the tile's positions p = m0 + r < H W,
// q = p shifted by (dy, dx) on the H x W grid; zero where q leaves the grid
// or k0 + k >= kmax.  (H = rows, W = 1: plain rows.)  Loads bypass L1
// (ld.global.cg): h and dgates are written by the cluster's other CTAs.
template <typename A>
__device__ __forceinline__ void gen_load_rows(float* as, const A* src, int ld,
                                              int k0, int kmax, int m0, int bm, int dy, int dx,
                                              int H, int W) {
  const int k = threadIdx.x & (GEN_BK - 1), kk = k0 + k;
  for (int r = threadIdx.x / GEN_BK; r < bm; r += GEN_THREADS / GEN_BK) {
    const int p = m0 + r;
    float v = 0.f;
    if (p < H * W && kk < kmax) {
      const int yy = p / W + dy, xx = p % W + dx;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = to_f(__ldcg(src + (size_t)(yy * W + xx) * ld + kk));
    }
    as[k * (bm + 4) + r] = v;
  }
}

// Bs[k][n] = w[(k0 + k) * ld + n0 + n], zero where k0 + k >= kmax or
// n0 + n >= nmax; bn = 1 << lbn columns.
__device__ __forceinline__ void gen_load_cols(float* bs, const float* __restrict__ w, size_t ld,
                                              int k0, int kmax, int n0, int nmax, int lbn) {
  const int bn = 1 << lbn;
  for (int e = threadIdx.x; e < GEN_BK * bn; e += GEN_THREADS) {
    const int k = e >> lbn, n = e & (bn - 1);
    bs[e] = k0 + k < kmax && n0 + n < nmax ? w[(size_t)(k0 + k) * ld + n0 + n] : 0.f;
  }
}

// acc[i][j] += sum_k As[k][4 ty + i] Bs[k][4 tx + j], k in order, between
// the barriers that end the tiles' loads and protect them from the next.
__device__ __forceinline__ void gen_chunk(const GenSmem& sm, const GenTile& tl, int ty, int tx,
                                          float (&acc)[4][4]) {
  __syncthreads();
#pragma unroll
  for (int k = 0; k < GEN_BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(sm.a + k * (tl.bm + 4) + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(sm.b + k * tl.bn + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  __syncthreads();
}

// The same in f64: the products of f32 operands are exact, and their sum
// rounds once where it is read.
__device__ __forceinline__ void gen_chunk(const GenSmem& sm, const GenTile& tl, int ty, int tx,
                                          double (&acc)[4][4]) {
  __syncthreads();
#pragma unroll
  for (int k = 0; k < GEN_BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(sm.a + k * (tl.bm + 4) + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(sm.b + k * tl.bn + 4 * tx);
    const double av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void gen_zero(T (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
}

// The cluster's writes to global memory of this step, seen by all its CTAs.
__device__ __forceinline__ void gen_step_barrier() {
  __threadfence();
  cluster_sync();
}

// All T steps of sample blockIdx.x / cl.  K5 (!XG): gates_t = G(G(x_t Wx +
// bx) + G(conv3x3(h_{t-1}, W))), x (B, T, HW, C); K6 (XG, C = 0): gates_t =
// G(G(conv3x3(h_{t-1}, W)) + G(xg_t)), xg (B, xg_steps, HW, 4F), read at
// step 0 throughout when xg_steps is 1.  wg: [Wx; W] as f32 (C + 9F, 4F)
// with column 4 ch + q holding gate q of channel ch; bg: bx as f32 in the
// same column order (K5).  Scratch: cst (B, HW, F) f32, the cell state in
// G; hbuf (B, 2, HW, F), h_t in buffer t & 1 (h_0 in buffer 1).
template <typename A, typename G, int MODE, bool XG>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_fwd_kernel(const A* __restrict__ x, const float* __restrict__ wg,
                   const float* __restrict__ bg, const A* __restrict__ c0,
                   const A* __restrict__ h0, A* __restrict__ out_h, A* __restrict__ out_c,
                   A* __restrict__ out_g, float* __restrict__ cst, A* hbuf, int Tn,
                   int H, int W, int C, int F, int xg_steps, int cl) {
  __shared__ __align__(16) GenSmem sm;
  const int rank = (int)cluster_rank(), tid = threadIdx.x;
  const size_t b = blockIdx.x / cl;
  const int HW = H * W, F4 = 4 * F;
  const int c_lo = F * rank / cl, nc = F * (rank + 1) / cl - c_lo, N = 4 * nc;
  const GenTile tl = gen_tile(N);
  const int ty = tid >> tl.lbn, tx = tid & ((1 << tl.lbn) - 1);
  float* cs_b = cst + b * HW * F;
  A* hb = hbuf + b * 2 * HW * F;
  for (int i = tid; i < HW * nc; i += GEN_THREADS) {
    const int p = i / nc, ch = c_lo + i % nc;
    const size_t o = (b * HW + p) * F + ch;
    cs_b[p * F + ch] = round_to<G>(to_f(c0[o]));
    hb[(size_t)HW * F + p * F + ch] = from_f<A>(round_to<G>(to_f(h0[o])));
  }
  gen_step_barrier();
  const int mtiles = (HW + tl.bm - 1) / tl.bm, ntiles = (N + tl.bn - 1) / tl.bn;
  const float* wcta = wg + 4 * c_lo;  // the CTA's first column
  for (int t = 0; t < Tn; ++t) {
    const A* hprev = hb + (size_t)((t + 1) & 1) * HW * F;
    A* hcur = hb + (size_t)(t & 1) * HW * F;
    for (int tile = 0; tile < mtiles * ntiles; ++tile) {
      const int m0 = tile / ntiles * tl.bm, n0 = tile % ntiles * tl.bn;
      // with bf16 gates the taps sum in f64: the f32 sums of the kernel and
      // of the plain version's convolution, in their two orders, round to
      // bf16 apart often enough that K6's cell state, carried over 20 steps
      // of a 16 x 16 grid, left its bound
      using TapAcc = std::conditional_t<std::is_same<G, float>::value, float, double>;
      TapAcc acc[4][4];
      float xacc[4][4];
      gen_zero(acc);
      gen_zero(xacc);
      if constexpr (!XG) {
        const A* xt = x + (b * Tn + t) * HW * C;
        for (int k0 = 0; k0 < C; k0 += GEN_BK) {
          gen_load_rows(sm.a, xt, C, k0, C, m0, tl.bm, 0, 0, H, W);
          gen_load_cols(sm.b, wcta, F4, k0, C, n0, N, tl.lbn + 2);
          gen_chunk(sm, tl, ty, tx, xacc);
        }
      }
      for (int tap = 0; tap < 9; ++tap)
        for (int j0 = 0; j0 < F; j0 += GEN_BK) {
          gen_load_rows(sm.a, hprev, F, j0, F, m0, tl.bm, tap / 3 - 1, tap % 3 - 1, H, W);
          gen_load_cols(sm.b, wcta + (size_t)(C + tap * F) * F4, F4, j0, F, n0, N, tl.lbn + 2);
          gen_chunk(sm, tl, ty, tx, acc);
        }
      // The cell of channel ch at the thread's 4 positions: its 4 columns
      // are that channel's i, f, g, o.
      const int lc = n0 / 4 + tx, ch = c_lo + lc;
      if (lc >= nc) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + 4 * ty + i;
        if (p >= HW) continue;
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (XG) {
            const size_t row = (b * xg_steps + (xg_steps > 1 ? t : 0)) * HW + p;
            pre[q] = round_to<G>(round_to<G>((float)acc[i][q]) +
                                 round_to<G>(to_f(x[row * F4 + q * F + ch])));
          } else {
            pre[q] = round_to<G>(round_to<G>(xacc[i][q] + bg[4 * ch + q]) +
                                 round_to<G>((float)acc[i][q]));
          }
        }
        float& c = cs_b[p * F + ch];
        const Cell r = lstm_cell_ieee<G>(pre[0], pre[1], pre[2], pre[3], c);
        c = r.c;
        hcur[p * F + ch] = from_f<A>(r.h);
        const size_t o = (b * Tn + t) * HW + p, last = b * HW + p;
        if (MODE == kSave) {
          out_h[o * F + ch] = from_f<A>(r.h);
          out_c[o * F + ch] = from_f<A>(r.c);
          const float gv[4] = {r.i, r.f, r.g, r.o};
#pragma unroll
          for (int q = 0; q < 4; ++q) out_g[o * F4 + q * F + ch] = from_f<A>(gv[q]);
        }
        if (MODE == kHiddens) out_h[o * F + ch] = from_f<A>(r.h);
        if (MODE != kSave && t == Tn - 1) {
          if (MODE == kLast) out_h[last * F + ch] = from_f<A>(r.h);
          out_c[last * F + ch] = from_f<A>(r.c);
        }
      }
    }
    gen_step_barrier();
  }
}

// Reverse time for sample blockIdx.x / cl, (dh, dc) carried in f32 in
// dhbuf and dcst (B, HW, F).  K5 (PROJ) and K6 with dh_T once
// (`last_only`): dhs (B, HW, F) enters once; else dhs (B, T, HW, F) is
// added to the carried dh every step.  wt: W^T as f32 (9, 4F, F), row
// (tap, n) = W[tap][:, n].  dG (B, T, HW, 4F): the dgates rounded to A.
// dsum: K5's per-sample dbx partials (B, 4F); K6 with a time-constant xg
// (const_x) its f32 dgates sum (B, HW, 4F), written rounded to A into dxg
// (B, HW, 4F) at the last step.
template <typename A, bool PROJ>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_bwd_kernel(const float* __restrict__ wt, const A* __restrict__ c0,
                   const A* __restrict__ cs, const A* __restrict__ ga,
                   const A* __restrict__ dhs, const A* __restrict__ dcl, A* dG,
                   float* __restrict__ dsum, A* __restrict__ dxg, A* __restrict__ dc0,
                   A* __restrict__ dh0, float* __restrict__ dhbuf, float* __restrict__ dcst,
                   int Tn, int H, int W, int F, int cl, int const_x, int last_only) {
  __shared__ __align__(16) GenSmem sm;
  const int rank = (int)cluster_rank(), tid = threadIdx.x;
  const size_t b = blockIdx.x / cl;
  const int HW = H * W, F4 = 4 * F;
  const int c_lo = F * rank / cl, nc = F * (rank + 1) / cl - c_lo;
  const GenTile tl = gen_tile(nc);
  const int ty = tid >> tl.lbn, tx = tid & ((1 << tl.lbn) - 1);
  const bool once = PROJ || last_only;
  float* dh_b = dhbuf + b * HW * F;
  float* dc_b = dcst + b * HW * F;
  for (int i = tid; i < HW * nc; i += GEN_THREADS) {
    const int p = i / nc, ch = c_lo + i % nc;
    const size_t o = (b * HW + p) * F + ch;
    dh_b[p * F + ch] = once ? to_f(dhs[o]) : 0.f;
    dc_b[p * F + ch] = to_f(dcl[o]);
  }
  if (PROJ)
    for (int i = tid; i < 4 * nc; i += GEN_THREADS)
      dsum[b * F4 + (i / nc) * F + c_lo + i % nc] = 0.f;
  if (!PROJ && const_x)
    for (int i = tid; i < HW * 4 * nc; i += GEN_THREADS) {
      const int p = i / (4 * nc), q = i / nc % 4;
      dsum[(b * HW + p) * F4 + q * F + c_lo + i % nc] = 0.f;
    }
  __syncthreads();
  // The pointwise pass: thread u < S nc takes channel u % nc at positions
  // u / nc, + S, ...; K5 sums its dgates over them, then the S slices in order.
  const int S = nc >= GEN_THREADS ? 1 : GEN_THREADS / nc;
  const int mtiles = (HW + tl.bm - 1) / tl.bm, ntiles = (nc + tl.bn - 1) / tl.bn;
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t st = (b * Tn + t) * HW;  // the row of (b, t, position 0)
    for (int u = tid; u < S * nc; u += GEN_THREADS) {
      const int s = u / nc, ch = c_lo + u % nc;
      float colsum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = s; p < HW; p += S) {
        float dh = dh_b[p * F + ch];
        if (!once) dh += to_f(dhs[(st + p) * F + ch]);
        const float ct = to_f(cs[(st + p) * F + ch]);
        const float cp =
            t > 0 ? to_f(cs[(st - HW + p) * F + ch]) : to_f(c0[(b * HW + p) * F + ch]);
        const A* g = ga + (st + p) * F4 + ch;
        float gq[4];
        const float dcn = lstm_cell_bwd_fast(dh, dc_b[p * F + ch], ct, cp, to_f(g[0]),
                                             to_f(g[F]), to_f(g[2 * F]), to_f(g[3 * F]), gq);
        dc_b[p * F + ch] = dcn;
        if (t == 0) dc0[(b * HW + p) * F + ch] = from_f<A>(dcn);
        A* d = dG + (st + p) * F4 + ch;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q * F] = from_f<A>(gq[q]);
          colsum[q] += gq[q];
        }
        if (!PROJ && const_x) {
          float* ds = dsum + (b * HW + p) * F4 + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ds[q * F] += gq[q];
            if (t == 0) dxg[(b * HW + p) * F4 + q * F + ch] = from_f<A>(ds[q * F]);
          }
        }
      }
      if (PROJ) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (S == 1)
            dsum[b * F4 + q * F + ch] += colsum[q];
          else
            sm.red[u * 4 + q] = colsum[q];
        }
      }
    }
    if (PROJ && S > 1) {
      __syncthreads();
      for (int lc = tid; lc < nc; lc += GEN_THREADS) {
        float tot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[q] += sm.red[(s * nc + lc) * 4 + q];
#pragma unroll
        for (int q = 0; q < 4; ++q) dsum[b * F4 + q * F + c_lo + lc] += tot[q];
      }
    }
    gen_step_barrier();  // dgates_t of every CTA of the cluster written
    // dh_{t-1} of the CTA's channels: the transposed taps of dgates_t.
    const A* dg_t = dG + st * F4;
    for (int tile = 0; tile < mtiles * ntiles; ++tile) {
      const int m0 = tile / ntiles * tl.bm, n0 = tile % ntiles * tl.bn;
      float acc[4][4];
      gen_zero(acc);
      for (int tap = 0; tap < 9; ++tap)
        for (int k0 = 0; k0 < F4; k0 += GEN_BK) {
          gen_load_rows(sm.a, dg_t, F4, k0, F4, m0, tl.bm, 1 - tap / 3, 1 - tap % 3, H, W);
          gen_load_cols(sm.b, wt + (size_t)tap * F4 * F + c_lo, F, k0, F4, n0, nc, tl.lbn + 2);
          gen_chunk(sm, tl, ty, tx, acc);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = m0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lc = n0 + 4 * tx + j;
          if (p >= HW || lc >= nc) continue;
          if (t > 0)
            dh_b[p * F + c_lo + lc] = acc[i][j];
          else
            dh0[(b * HW + p) * F + c_lo + lc] = from_f<A>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next step's pointwise pass reads dh from other threads
  }
}

// K5's dx = dG Wx^T: dG (R, 4F) in A, wxt (4F, C) f32, dx (R, C) in A;
// 64 x 64 tiles.
template <typename A>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_dx_kernel(const A* __restrict__ dG, const float* __restrict__ wxt, A* __restrict__ dx,
                  int R, int F4, int C) {
  __shared__ __align__(16) GenSmem sm;
  const GenTile tl = gen_tile(64);
  const int tid = threadIdx.x, ty = tid >> tl.lbn, tx = tid & ((1 << tl.lbn) - 1);
  const int m0 = blockIdx.x * tl.bm, n0 = blockIdx.y * tl.bn;
  float acc[4][4];
  gen_zero(acc);
  for (int k0 = 0; k0 < F4; k0 += GEN_BK) {
    gen_load_rows(sm.a, dG, F4, k0, F4, m0, tl.bm, 0, 0, R, 1);
    gen_load_cols(sm.b, wxt, C, k0, F4, n0, C, tl.lbn + 2);
    gen_chunk(sm, tl, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + 4 * ty + i, c = n0 + 4 * tx + j;
      if (r < R && c < C) dx[(size_t)r * C + c] = from_f<A>(acc[i][j]);
    }
}

// dW and dWx as one product: part[split][m][n] = sum over the split's rows
// r (b, t, position) of X[r][m] dG[r][n], X[r] = [x_r, the 3x3 taps of
// h_{t-1} at r's position] ((tap, channel) order; h_{-1} = h0), m < M = C +
// 9F, n < 4F; rows in order within a split of `chunk` rows, summed in runs
// of GEN_WGRAD_RUN rows that are then added up (a split holds up to B T H W
// rows: one FMA chain over them drifted by ~300 f32 ulps at 327,680 rows on
// the H100, against an f32 limit of 512).  64 x 64 tiles.
template <typename A>
__global__ void __launch_bounds__(GEN_THREADS)
    gen_wgrad_kernel(const A* __restrict__ x, const A* __restrict__ hs, const A* __restrict__ h0,
                     const A* __restrict__ dG, float* __restrict__ part, int Tn, int H, int W,
                     int C, int F, int R, int chunk) {
  __shared__ __align__(16) GenSmem sm;
  const GenTile tl = gen_tile(64);
  const int tid = threadIdx.x, ty = tid >> tl.lbn, tx = tid & ((1 << tl.lbn) - 1);
  const int HW = H * W, F4 = 4 * F, M = C + 9 * F;
  const int m0 = blockIdx.x * tl.bm, n0 = blockIdx.y * tl.bn, split = blockIdx.z;
  const int r_lo = split * chunk, r_hi = min(R, r_lo + chunk);
  // The thread's column of X in the A tile: row m of the weights.
  const int mm = tid % tl.bm, m = m0 + mm;
  const int tap = m < C ? -1 : (m - C) / F, j = m < C ? m : (m - C) % F;
  float acc[4][4], run[4][4];
  gen_zero(acc);
  gen_zero(run);
  for (int r0 = r_lo; r0 < r_hi; r0 += GEN_BK) {
    for (int k = tid / tl.bm; k < GEN_BK; k += GEN_THREADS / tl.bm) {
      const int r = r0 + k;
      float v = 0.f;
      if (r < r_hi && m < M) {
        if (tap < 0) {
          v = to_f(x[(size_t)r * C + j]);
        } else {
          const int bt = r / HW, p = r - bt * HW;
          const int yy = p / W + tap / 3 - 1, xx = p % W + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int q = yy * W + xx;
            v = to_f(bt % Tn > 0 ? hs[((size_t)(bt - 1) * HW + q) * F + j]
                                 : h0[((size_t)(bt / Tn) * HW + q) * F + j]);
          }
        }
      }
      sm.a[k * (tl.bm + 4) + mm] = v;
    }
    for (int e = tid; e < GEN_BK * tl.bn; e += GEN_THREADS) {
      const int k = e >> (tl.lbn + 2), n = e & (tl.bn - 1), r = r0 + k;
      sm.b[e] = r < r_hi && n0 + n < F4 ? to_f(dG[(size_t)r * F4 + n0 + n]) : 0.f;
    }
    gen_chunk(sm, tl, ty, tx, run);
    if ((r0 - r_lo + GEN_BK) % GEN_WGRAD_RUN == 0 || r0 + GEN_BK >= r_hi) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += run[i][j];
      gen_zero(run);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int mo = m0 + 4 * ty + i, n = n0 + 4 * tx + jj;
      if (mo < M && n < F4) part[((size_t)split * M + mo) * F4 + n] = acc[i][jj];
    }
}

}  // namespace
}  // namespace mmvae
