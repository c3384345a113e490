// ConvLSTM hidden recurrence given a precomputed input projection xg (K6).
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_pallas
//   (forward _fwd_kernel / _fwd_kernel_nores, backward _bwd_kernel, VJPs
//   _scan and _scan_last).
//
// Per step t:  gates_t = G(G(conv3x3_SAME(h_{t-1}, W)) + xg_t)      (i, f, g, o)
//              c_t = sig(f + 1) * c_{t-1} + sig(i) * tanh(g);  h_t = sig(o) * tanh(c_t)
// with G() rounding to the gate dtype (f32 or bf16) and the pointwise chain
// and cell state in it, as the TPU kernel adds the two in its gate dtype.
// xg is streaming (B, T, HW, 4F) or time-constant (B, 1, HW, 4F), read at
// step 0 throughout and never materialized T times.  The forward writes
// every h_t, or only h_T (last-only); the saving forward (for training)
// writes hs, cs and the post-activation gates in bf16 as residuals.
//
// What bounds it on the H100.  The work at config 4's decoder (B=64, T=10,
// 8x8, F=128, const xg): the forward is 40.6 GFLOP (0.041 ms at 989
// TFLOP/s) and moves ~0.1 GB, the backward twice the products (the dh
// recurrence and dW).  Measured there ("NVIDIA H100 80GB HBM3, 700.00 W",
// CUDA events over 20 calls), the forward takes ~0.18 ms and the backward
// ~0.63 ms, of which the BPTT ~0.36 and the weight GEMM the rest.  Like
// K5, whose kernels these are, the recurrences are bound by the latency of
// the serial step chain (36 slabs a step, each a handshake, fragment loads,
// products and a wait, then the cell and the exchange), not by either
// rate: with the weight copies taken out neither moved, with the products
// taken out the forward took 10-13 % less.
//
// Design: K5's Hopper kernels (convlstm_wgmma.cuh), instantiated with C = 0.
// - forward (rec_fwd_wgmma_kernel<XG = true>): one 2-CTA cluster per sample,
//   each CTA half the channels of all four gates, h_t exchanged through
//   distributed shared memory; the 9 tap products on wgmma from a bulk-copy
//   weight ring, accumulated from zero; each thread's cells of xg_t held in
//   registers, loaded a whole step ahead (once when time-constant), and
//   added in the gate epilogue; modes save / every h_t / last-only as
//   template parameters, the xg time stride (0 when constant) at run time;
// - BPTT (rec_bwd_wgmma_kernel<PROJ = false>): reverse time on the same
//   clusters with (dh, dc) in f32 registers, the per-step cotangent of hs
//   loaded while the products run and added to dh (or dh_T once,
//   last-only); bf16 dgates exchanged for the transposed conv (K = 9 x 4F).
//   A streaming xg's dxg is the bf16 dgates scratch itself; a time-constant
//   xg's is the f32 sum over t of the unrounded dgates, kept per CTA in
//   shared memory (it owns its sample for all T, so the order is fixed
//   without atomics) and written once, beside a bf16 scratch.  This replaces
//   the TPU's dxg_stream knob, a store-buffering choice of its own;
// - dW: K5's split-K wgmma weight GEMM over the bf16 scratch with C = 0
//   (mmvae_convlstm_wgrad, called by the wrapper), partials summed in split
//   order.
// No float atomics, so results are bit-reproducible.  bf16 activations, F a
// multiple of 16, F <= 128, H*W <= 64; the wrapper checks.

#include "convlstm_wgmma.cuh"

namespace mmvae {
namespace {

template <typename G, int MODE, int F>
cudaError_t launch_scan_fwd(const void* xg, const void* wpk, const void* c0, const void* h0,
                            void* oh, void* oc, void* og, int B, int Tn, int xg_steps, int H,
                            int W, cudaStream_t stream) {
  const FwdSmem L = fwd_smem_layout(0, F, false);
  if (L.stages < MIN_STAGES) return cudaErrorInvalidValue;
  const void* bx = nullptr;
  int C = 0;
  void* args[] = {&xg, &wpk, &bx, &c0, &h0, &oh, &oc, &og, &Tn, &H, &W, &C, &xg_steps};
  return cluster_launch((const void*)rec_fwd_wgmma_kernel<G, MODE, F, true>, 2 * B,
                        rec_threads(F), L.total, stream, args);
}

template <int F>
cudaError_t launch_scan_bwd(const void* wtpk, const void* c0, const void* cs, const void* ga,
                            const void* dhs, const void* dcl, void* dG, void* dxg, void* dc0,
                            void* dh0, int B, int Tn, int H, int W, int const_x, int last_only,
                            cudaStream_t stream) {
  const BwdSmem L = scan_bwd_smem_layout(F, const_x);
  if (L.stages < (const_x ? SCAN_BWD_MIN_STAGES : MIN_STAGES)) return cudaErrorInvalidValue;
  const void* none = nullptr;
  void* no_out = nullptr;
  void* dxg_sum = const_x ? dxg : nullptr;
  int C = 0;
  void* args[] = {&wtpk, &none, &c0, &cs, &ga, &dhs, &dcl, &dG, &no_out, &no_out, &dxg_sum,
                  &dc0, &dh0, &Tn, &H, &W, &C, &last_only};
  return cluster_launch((const void*)rec_bwd_wgmma_kernel<F, false>, 2 * B, BWD_THREADS,
                        L.total, stream, args);
}

}  // namespace
}  // namespace mmvae

using namespace mmvae;

extern "C" {

// mode: 0 saves hs, cs and gates; 1 writes every h_t and c_T; 2 writes h_T
// and c_T.  xg_steps: xg's steps, T (streaming) or 1 (time-constant).
// Weights pre-packed by the wrapper (convlstm_kernels.pack_proj_forward
// with an empty Wx).
int mmvae_convlstm_scan_fwd(const void* xg, const void* wpk, const void* c0, const void* h0,
                            void* out_h, void* out_c, void* out_g, int B, int Tn, int xg_steps,
                            int H, int W, int F, int gate_dtype, int mode, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MMVAE_SCAN_FWD(GG, MM) \
  return (int)launch_scan_fwd<GG, MM, FF>(xg, wpk, c0, h0, out_h, out_c, out_g, B, Tn, xg_steps, H, W, s)
#define MMVAE_SCAN_MODES(GG)                                          \
  if (mode == kSave) MMVAE_FOR_F(F, MMVAE_SCAN_FWD(GG, kSave));       \
  if (mode == kHiddens) MMVAE_FOR_F(F, MMVAE_SCAN_FWD(GG, kHiddens)); \
  if (mode == kLast) MMVAE_FOR_F(F, MMVAE_SCAN_FWD(GG, kLast));
  if (gate_dtype == kF32) { MMVAE_SCAN_MODES(float) }
  if (gate_dtype == kBF16) { MMVAE_SCAN_MODES(__nv_bfloat16) }
#undef MMVAE_SCAN_MODES
#undef MMVAE_SCAN_FWD
  return (int)cudaErrorInvalidValue;
}

// BPTT: dgates into the bf16 scratch dG (a streaming xg's dxg, which the
// wrapper passes as dG), dc0, dh0 and, when const_x, dxg (B, HW, 4F).  dhs:
// dh_T (B, HW, F) when last_only, else (B, T, HW, F).  dW follows from
// mmvae_convlstm_wgrad over dG.
int mmvae_convlstm_scan_bwd(const void* wtpk, const void* c0, const void* cs, const void* ga,
                            const void* dhs, const void* dcl, void* dG, void* dxg, void* dc0,
                            void* dh0, int B, int Tn, int H, int W, int F, int const_x,
                            int last_only, void* stream) {
  MMVAE_FOR_F(F, return (int)launch_scan_bwd<FF>(wtpk, c0, cs, ga, dhs, dcl, dG, dxg, dc0, dh0,
                                                 B, Tn, H, W, const_x, last_only,
                                                 (cudaStream_t)stream));
}

// The launch geometry the kernels use, for the wrapper to check against its
// own: {fwd stages, fwd smem, then bwd stages and bwd smem for a
// time-constant xg, then for a streaming one}.
void mmvae_convlstm_scan_layout(int F, int* out) {
  const FwdSmem f = fwd_smem_layout(0, F, false);
  out[0] = f.stages;
  out[1] = f.total;
  for (int k = 0; k < 2; ++k) {
    const BwdSmem b = scan_bwd_smem_layout(F, k == 0);
    out[2 + 2 * k] = b.stages;
    out[3 + 2 * k] = b.total;
  }
}

}  // extern "C"
