// ConvLSTM hidden recurrence given a precomputed input projection xg (K6).
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_pallas
//   (forward _fwd_kernel / _fwd_kernel_nores, backward _bwd_kernel, VJPs
//   _scan and _scan_last).
//
// Per step t:  gates_t = G(xg_t) + G(conv3x3_SAME(h_{t-1}, W))     (i, f, g, o)
//              c_t = sig(f + 1) * c_{t-1} + sig(i) * tanh(g);  h_t = sig(o) * tanh(c_t)
// with G() rounding to the gate dtype (f32 or bf16) and the pointwise chain
// and cell state in it, as the TPU kernel adds the two in its gate dtype.
// xg is streaming (B, T, HW, 4F) or time-constant (B, 1, HW, 4F), read with a
// time stride of 0 and never materialized T times.  The forward writes
// every h_t, or only h_T (last-only); the saving forward (for training)
// writes hs, cs and the post-activation gates in bf16 as residuals.
//
// What bounds it on the H100: arithmetic and the serial time loop, not bytes,
// as for K5.  At config 4's decoder (B=64, T=10, 8x8, F=128) the forward is
// 2*B*HW*9F*4F*T = 48 GFLOP and the backward about twice that (the dh
// recurrence and dW), while the forward moves ~0.1 GB.
//
// Design (simple first versions on K5's machinery, convlstm_mma.cuh; wgmma,
// TMA and batch blocking are later work).  bf16 activations, F a multiple of
// 16, F <= 128, H*W <= 64; the wrapper checks.
// - forward: one CTA per sample for all T steps, 2F threads; h in a swizzled
//   bf16 shared tile and c in f32 shared memory; the 9 tap products on
//   mma.sync accumulate from zero and xg_t is added in the gate epilogue.
// - backward: reverse time with (dh, dc) carried in f32 registers; dhs_t is
//   added to dh each step (full mode) or dh_T enters once (last-only).
//   dgates go to a f32 scratch (for dW) and, for a streaming input, to dxg in
//   bf16; for a const input the CTA sums dgates over t in f32 shared memory
//   (it owns its sample for all T, so the order is fixed without atomics) and
//   writes the sum once.  This replaces the TPU's dxg_stream knob, a
//   store-buffering choice of its own.  dh_{t-1} is the transposed conv of
//   the bf16 dgates on mma.sync.
// - dW: K5's deterministic tensor-core weight-gradient GEMM over the 9F
//   h-tap rows only (C = 0), split-K partials summed in split order.

#include "convlstm_mma.cuh"

namespace mmvae {
namespace {

enum ScanMode : int { kSave = 0, kHiddens = 1, kLast = 2 };

template <typename G, int MODE>
__global__ void __launch_bounds__(256, 1) scan_fwd_mma_kernel(
    const bf16* __restrict__ xg,    // (B, Tin, HW, 4F); time stride xg_ts (0: const)
    const uint2* __restrict__ wpk,  // W (9F x 4F) packed: [9F/16][4F/8][32 lanes]
    const bf16* __restrict__ c0, const bf16* __restrict__ h0,  // (B, HW, F)
    bf16* __restrict__ out_h, bf16* __restrict__ out_c, bf16* __restrict__ out_g,
    int Tn, long long xg_bs, long long xg_ts, int H, int W, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = H * W, F4 = 4 * F, NB = F4 / 8;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x;
  const SwzTile hsw = make_tile(reinterpret_cast<bf16*>(smem_raw), F);
  float* csm = reinterpret_cast<float*>(hsw.base + (size_t)(MROWS + 1) * F);  // (MROWS, F)

  for (int i = tid; i < (MROWS + 1 - HW) * F; i += nthr) *hsw.at(HW + i / F, i % F) = from_f<bf16>(0.f);
  for (int i = tid; i < HW * F; i += nthr) {
    csm[i] = round_to<G>(to_f(c0[b * HW * F + i]));
    *hsw.at(i / F, i % F) = from_f<bf16>(round_to<G>(to_f(h0[b * HW * F + i])));
  }
  int nbs[8];
  gate_tiles(nbs, warp, F);

  for (int t = 0; t < Tn; ++t) {
    __syncthreads();
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
    hidden_conv_mma(acc, hsw, wpk, 0, nbs, NB, lane, H, W, F);

    const bf16* xgt = xg + b * xg_bs + t * xg_ts;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + g + 8 * hr, ch = 16 * warp + 8 * hf + 2 * tq + e;
            const int k = hr * 2 + e;
            if (r >= HW) continue;
            const bf16* xr = xgt + (size_t)r * F4 + ch;
            const Cell cl = lstm_cell<G>(
                round_to<G>(round_to<G>(acc[mt][0 + hf][k]) + to_f(xr[0])),
                round_to<G>(round_to<G>(acc[mt][2 + hf][k]) + to_f(xr[F])),
                round_to<G>(round_to<G>(acc[mt][4 + hf][k]) + to_f(xr[2 * F])),
                round_to<G>(round_to<G>(acc[mt][6 + hf][k]) + to_f(xr[3 * F])),
                csm[r * F + ch]);
            csm[r * F + ch] = cl.c;
            acc[mt][0 + hf][k] = cl.h;
            const size_t o = (b * Tn + t) * HW + r;
            if (MODE == kSave) {
              out_h[o * F + ch] = from_f<bf16>(cl.h);
              out_c[o * F + ch] = from_f<bf16>(cl.c);
              out_g[o * F4 + ch] = from_f<bf16>(cl.i);
              out_g[o * F4 + F + ch] = from_f<bf16>(cl.f);
              out_g[o * F4 + 2 * F + ch] = from_f<bf16>(cl.g);
              out_g[o * F4 + 3 * F + ch] = from_f<bf16>(cl.o);
            } else {
              if (MODE == kHiddens) out_h[o * F + ch] = from_f<bf16>(cl.h);
              if (t == Tn - 1) {
                if (MODE == kLast) out_h[(b * HW + r) * F + ch] = from_f<bf16>(cl.h);
                out_c[(b * HW + r) * F + ch] = from_f<bf16>(cl.c);
              }
            }
          }
    __syncthreads();  // every warp is done reading hsw for step t
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + g + 8 * hr, ch = 16 * warp + 8 * hf + 2 * tq + e;
            if (r < HW) *hsw.at(r, ch) = from_f<bf16>(acc[mt][0 + hf][hr * 2 + e]);
          }
  }
}

// Row stride (floats) of the const-input dxg accumulator: padded so the
// threads of a warp, 8 rows apart, fall on different banks.
__host__ __device__ inline int dxs_stride(int F) { return 4 * F + 8; }

template <bool CONST_X, bool LAST_ONLY>
__global__ void __launch_bounds__(256, 1) scan_bwd_mma_kernel(
    const uint2* __restrict__ wtpk,  // W^T rows (tap, n) packed: [9*4F/16][F/8][32 lanes]
    const bf16* __restrict__ c0, const bf16* __restrict__ cs, const bf16* __restrict__ ga,
    const bf16* __restrict__ dhs,    // (B, T, HW, F), or (B, HW, F) when LAST_ONLY
    const bf16* __restrict__ dcl,    // (B, HW, F)
    float* __restrict__ dG,          // (B, T, HW, 4F) f32 scratch for dW
    bf16* __restrict__ dxg,          // (B, T, HW, 4F), or (B, HW, 4F) when CONST_X
    bf16* __restrict__ dc0, bf16* __restrict__ dh0, int Tn, int H, int W, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = H * W, F4 = 4 * F, XS = dxs_stride(F);
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x;
  const SwzTile dgs = make_tile(reinterpret_cast<bf16*>(smem_raw), F4);  // (MROWS + 1, 4F)
  float* dxs = reinterpret_cast<float*>(dgs.base + (size_t)(MROWS + 1) * F4);  // (MROWS, XS)
  for (int i = tid; i < (MROWS + 1 - HW) * F4; i += nthr) *dgs.at(HW + i / F4, i % F4) = from_f<bf16>(0.f);

  // acc = dh and dc, in the mma output layout: rows mt*16 + g + 8*hr,
  // channels 16*warp + 8*nt + 2*tq + e, slot hr*2 + e.  Each thread owns
  // its (row, channel) entries of dxs for all four gates.
  float acc[MT][2][4], dc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
        acc[mt][nt][k] = (LAST_ONLY && r < HW) ? to_f(dhs[(b * HW + r) * F + ch]) : 0.f;
        dc[mt][nt][k] = r < HW ? to_f(dcl[(b * HW + r) * F + ch]) : 0.f;
        if (CONST_X && r < HW) {
#pragma unroll
          for (int q = 0; q < 4; ++q) dxs[r * XS + q * F + ch] = 0.f;
        }
      }

  for (int t = Tn - 1; t >= 0; --t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
          if (r >= HW) continue;
          const size_t o = (b * Tn + t) * HW + r;
          const float ct = to_f(cs[o * F + ch]);
          const float cp = t > 0 ? to_f(cs[(o - HW) * F + ch]) : to_f(c0[(b * HW + r) * F + ch]);
          const float dh = LAST_ONLY ? acc[mt][nt][k] : acc[mt][nt][k] + to_f(dhs[o * F + ch]);
          float gq[4];
          dc[mt][nt][k] = lstm_cell_bwd(dh, dc[mt][nt][k], ct, cp, to_f(ga[o * F4 + ch]),
                                        to_f(ga[o * F4 + F + ch]), to_f(ga[o * F4 + 2 * F + ch]),
                                        to_f(ga[o * F4 + 3 * F + ch]), gq);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dG[o * F4 + q * F + ch] = gq[q];
            *dgs.at(r, q * F + ch) = from_f<bf16>(gq[q]);
            if (CONST_X) dxs[r * XS + q * F + ch] += gq[q];
            else dxg[o * F4 + q * F + ch] = from_f<bf16>(gq[q]);
          }
        }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
    hidden_conv_t_mma(acc, dgs, wtpk, warp, lane, H, W, F);
    __syncthreads();  // every warp is done reading dgs for step t
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
        if (r >= HW) continue;
        dh0[(b * HW + r) * F + ch] = from_f<bf16>(acc[mt][nt][k]);
        dc0[(b * HW + r) * F + ch] = from_f<bf16>(dc[mt][nt][k]);
        if (CONST_X) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dxg[(b * HW + r) * F4 + q * F + ch] = from_f<bf16>(dxs[r * XS + q * F + ch]);
        }
      }
}

size_t scan_fwd_smem(int F) {
  return (size_t)(MROWS + 1) * F * sizeof(bf16) + (size_t)MROWS * F * sizeof(float);
}
size_t scan_bwd_smem(int F, bool const_x) {
  return (size_t)(MROWS + 1) * 4 * F * sizeof(bf16) +
         (const_x ? (size_t)MROWS * dxs_stride(F) * sizeof(float) : 0);
}

template <typename G, int MODE>
cudaError_t launch_scan_fwd(const void* xg, const void* wpk, const void* c0, const void* h0,
                            void* oh, void* oc, void* og, int B, int Tn, int const_x, int H,
                            int W, int F, cudaStream_t stream) {
  auto kern = scan_fwd_mma_kernel<G, MODE>;
  const size_t smem = scan_fwd_smem(F);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long step = (long long)H * W * 4 * F;
  kern<<<B, 2 * F, smem, stream>>>((const bf16*)xg, (const uint2*)wpk, (const bf16*)c0,
                                   (const bf16*)h0, (bf16*)oh, (bf16*)oc, (bf16*)og, Tn,
                                   const_x ? step : step * Tn, const_x ? 0 : step, H, W, F);
  return cudaGetLastError();
}

template <bool CONST_X, bool LAST_ONLY>
cudaError_t launch_scan_bptt(const void* wtpk, const void* c0, const void* cs, const void* ga,
                             const void* dhs, const void* dcl, float* dG, void* dxg, void* dc0,
                             void* dh0, int B, int Tn, int H, int W, int F, cudaStream_t stream) {
  auto kern = scan_bwd_mma_kernel<CONST_X, LAST_ONLY>;
  const size_t smem = scan_bwd_smem(F, CONST_X);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, 2 * F, smem, stream>>>((const uint2*)wtpk, (const bf16*)c0, (const bf16*)cs,
                                   (const bf16*)ga, (const bf16*)dhs, (const bf16*)dcl, dG,
                                   (bf16*)dxg, (bf16*)dc0, (bf16*)dh0, Tn, H, W, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvae

using namespace mmvae;

extern "C" {

// mode: 0 saves hs, cs and gates; 1 writes every h_t and c_T; 2 writes h_T
// and c_T.  Weights pre-packed in mma fragment order by the wrapper.
int mmvae_convlstm_scan_fwd(const void* xg, const void* wpk, const void* c0, const void* h0,
                            void* out_h, void* out_c, void* out_g, int B, int Tn, int const_x,
                            int H, int W, int F, int gate_dtype, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MMVAE_SCAN_FWD(GG, MM)                                                             \
  return (int)launch_scan_fwd<GG, MM>(xg, wpk, c0, h0, out_h, out_c, out_g, B, Tn, const_x, \
                                      H, W, F, s)
#define MMVAE_SCAN_MODES(GG)                  \
  if (mode == kSave) MMVAE_SCAN_FWD(GG, kSave);       \
  if (mode == kHiddens) MMVAE_SCAN_FWD(GG, kHiddens); \
  if (mode == kLast) MMVAE_SCAN_FWD(GG, kLast);
  if (gate_dtype == kF32) { MMVAE_SCAN_MODES(float) }
  if (gate_dtype == kBF16) { MMVAE_SCAN_MODES(__nv_bfloat16) }
#undef MMVAE_SCAN_MODES
#undef MMVAE_SCAN_FWD
  return (int)cudaErrorInvalidValue;
}

// BPTT, then dW = the weight-gradient GEMM over the dgates scratch.
int mmvae_convlstm_scan_bwd(const void* wtpk, const void* c0, const void* h0, const void* hs,
                            const void* cs, const void* ga, const void* dhs, const void* dcl,
                            void* dG, void* dxg, void* dc0, void* dh0, void* dw_part,
                            void* dw_out, int B, int Tn, int H, int W, int F, int const_x,
                            int last_only, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* dGf = (float*)dG;
  cudaError_t err;
  if (const_x)
    err = last_only ? launch_scan_bptt<true, true>(wtpk, c0, cs, ga, dhs, dcl, dGf, dxg, dc0, dh0,
                                                   B, Tn, H, W, F, s)
                    : launch_scan_bptt<true, false>(wtpk, c0, cs, ga, dhs, dcl, dGf, dxg, dc0,
                                                    dh0, B, Tn, H, W, F, s);
  else
    err = last_only ? launch_scan_bptt<false, true>(wtpk, c0, cs, ga, dhs, dcl, dGf, dxg, dc0,
                                                    dh0, B, Tn, H, W, F, s)
                    : launch_scan_bptt<false, false>(wtpk, c0, cs, ga, dhs, dcl, dGf, dxg, dc0,
                                                     dh0, B, Tn, H, W, F, s);
  if (err != cudaSuccess) return (int)err;
  launch_weight_grad(nullptr, hs, h0, dGf, (float*)dw_part, (float*)dw_out, B, Tn, H, W, 0, F,
                     splits, s);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the kernels need (the const-input backward's is the
// largest); the wrapper checks it.
long long mmvae_convlstm_scan_smem(int F) {
  const size_t a = scan_fwd_smem(F), b = scan_bwd_smem(F, true);
  return (long long)(a > b ? a : b);
}

}  // extern "C"
