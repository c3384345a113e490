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
// - forward (rec_fwd_wgmma_kernel<XG = true>): one cluster per sample, 2
//   CTAs up to F = 128 and 4 for F in (128, 256], each CTA F/CL of the
//   channels of all four gates, h_t exchanged through distributed shared
//   memory; the 9 tap products on wgmma from a bulk-copy
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
//   shared memory (in a global scratch of its own with 4 CTAs a sample,
//   where the whole dgates tile leaves no room for it; it owns its sample
//   for all T, so the order is fixed without atomics) and written once,
//   beside a bf16 scratch.  This replaces
//   the TPU's dxg_stream knob, a store-buffering choice of its own;
// - dW: K5's split-K wgmma weight GEMM over the bf16 scratch with C = 0
//   (mmvae_convlstm_wgrad, called by the wrapper), partials summed in split
//   order.
// No float atomics, so results are bit-reproducible.  bf16 activations, F a
// multiple of 16 up to 128 or of 32 up to 256, or f32 activations, F a
// multiple of 16 up to 128 (convlstm_scan_f32.cu); H*W <= 64; every other
// shape goes to the general kernels (convlstm_general.cu).  This file holds the bf16 2-CTA widths and the entry points;
// convlstm_scan_wide.cu the 4-CTA widths.

#include "convlstm_launch.cuh"

using namespace mmvae;

extern "C" {

// mode: 0 saves hs, cs and gates; 1 writes every h_t and c_T; 2 writes h_T
// and c_T.  xg_steps: xg's steps, T (streaming) or 1 (time-constant).
// Weights pre-packed by the wrapper (convlstm_kernels.pack_proj_forward
// with an empty Wx).
int mmvae_convlstm_scan_fwd(const void* xg, const void* wpk, const void* c0, const void* h0,
                            void* out_h, void* out_c, void* out_g, int B, int Tn, int xg_steps,
                            int H, int W, int F, int gate_dtype, int mode, int act_dtype,
                            int gcl, void* scratch, void* stream) {
  const ScanFwdArgs a{xg, wpk, c0, h0, out_h, out_c, out_g, B, Tn, xg_steps, H, W, F,
                      gate_dtype, mode, act_dtype, gcl, scratch, (cudaStream_t)stream};
  switch (route(act_dtype, F, H * W, 0)) {
    case kHere: return scan_fwd<bf16>(NarrowF{}, a);
    case kWide: return scan_fwd_wide(a);
    case kF32Route: return scan_fwd_f32(a);
    case kGeneral: return scan_fwd_general(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// BPTT: dgates into the scratch dG (the activations' dtype; a streaming
// xg's dxg, which the wrapper passes as dG), dc0, dh0 and, when const_x,
// dxg (B, HW, 4F), summed in f32 in shared memory or, with 4 CTAs a sample
// or f32 activations, in dxs (B * 4 * 64 * F floats; on the general route
// B * HW * 4F).  dhs: dh_T (B, HW, F) when last_only, else (B, T, HW, F).
// dW follows from mmvae_convlstm_wgrad over dG.  The general route's
// scratch holds 2 B HW F floats.
int mmvae_convlstm_scan_bwd(const void* wtpk, const void* c0, const void* cs, const void* ga,
                            const void* dhs, const void* dcl, void* dG, void* dxg, void* dxs,
                            void* dc0, void* dh0, int B, int Tn, int H, int W, int F,
                            int const_x, int last_only, int act_dtype, int gcl, void* scratch,
                            void* stream) {
  const ScanBwdArgs a{wtpk, c0, cs, ga, dhs, dcl, dG, dxg, dxs, dc0, dh0, B, Tn, H, W, F,
                      const_x, last_only, act_dtype, gcl, scratch, (cudaStream_t)stream};
  switch (route(act_dtype, F, H * W, 0)) {
    case kHere: return scan_bwd<bf16>(NarrowF{}, a);
    case kWide: return scan_bwd_wide(a);
    case kF32Route: return scan_bwd_f32(a);
    case kGeneral: return scan_bwd_general(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The launch geometry the kernels use, for the wrapper to check against its
// own: {fwd stages, fwd smem, then bwd stages and bwd smem for a
// time-constant xg, then for a streaming one, then CTAs a sample}, for
// activations of `act_dtype`.
void mmvae_convlstm_scan_layout(int F, int act_dtype, int* out) {
  const int es = act_dtype == kF32 ? 4 : 2;
  const FwdSmem f = fwd_smem_layout(0, F, false, es);
  out[0] = f.stages;
  out[1] = f.total;
  for (int k = 0; k < 2; ++k) {
    const BwdSmem b = scan_bwd_smem_layout(F, k == 0, es);
    out[2 + 2 * k] = b.stages;
    out[3 + 2 * k] = b.total;
  }
  out[6] = rec_cluster(F);
}

}  // extern "C"
