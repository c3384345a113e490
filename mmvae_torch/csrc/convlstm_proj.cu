// Encoder ConvLSTM recurrence with the 1x1 input projection inside the kernel.
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_proj_pallas
//   (forward _fwd_proj_kernel / _fwd_proj_kernel_nores, backward
//   _bwd_proj_kernel, VJP _scan_proj_last).
//
// Per step t:  gates_t = x_t @ Wx + bx + conv3x3_SAME(h_{t-1}, W)
//              i, f, g, o = sig(gi), sig(gf + 1), tanh(gg), sig(go)
//              c_t = f * c_{t-1} + i * g;   h_t = o * tanh(c_t)
// with the pointwise chain and the cell state in the gate dtype G (f32 or
// bf16, every operation rounded to G as torch's bf16 ops round), matmul
// operands in bf16 (the activation dtype) and f32 accumulation.
//
// What bounds it on the H100.  The work: at the main path's shape (B=64,
// T=20, 8x8, C=F=128) the forward is 107 GFLOP (0.109 ms at 989 TFLOP/s)
// and moves ~0.15 GB; the backward is 215 GFLOP (dh recurrence 97, dW and
// dWx 107, dx 11).  Measured on the H100, the recurrences are bound by
// latency, not by either rate: at B=64, T=20 with one consumer warpgroup
// the forward took ~0.51 ms, 2 % less without the weight copies (slots
// never refilled) and 10 % less without the products.  A CTA walks 40 slabs
// a step, each a handshake, fragment loads, products and a wait, then the
// cell, the exchange and the residual stores (~0.2 ms of the forward
// without any slab), with few warps on the SM to hide their latency.  A
// second consumer warpgroup, each owning half the CTA's channels, brought
// the forward to ~0.44 ms; in the BPTT, whose products are m64n64, it did
// not pay.  The weight GEMM is bound by re-reading the dgates scratch
// (without those loads it took 43 % less).
//
// Design (device code in convlstm_wgmma.cuh and hopper.cuh, whose kernels
// K6 instantiates too; launchers in convlstm_launch.cuh):
// - forward and BPTT run one cluster per sample, 2 CTAs up to F = 128 (2B
//   CTAs: 128 at B=64) and 4 for F in (128, 256] (4B: 256 at B=64), each
//   CTA owning F/CL channels of all four gates (the forward's consumer
//   warpgroups, two where F/CL is a multiple of 16, a share each); the
//   CTAs exchange h_t (forward) or bf16 dgates_t (backward) through
//   distributed shared memory, with mbarriers of every CTA of the cluster in
//   place of __syncthreads.  Four CTAs halve each CTA's weight slab and
//   residual staging, which at C = 128 leave 4-8 forward slots where two
//   CTAs would leave 0-4; the BPTT's ring then takes 64-row slabs beside
//   the whole (65, 4F) dgates tile;
// - the products run on wgmma m64nNk16: A (the <= 64 positions) gathered
//   into registers by ldmatrix, tap by tap (a zero row for masked taps), B
//   a weight slab in shared memory, streamed by a producer warp with 1D bulk
//   copies through a ring of 4-8 slots (the weights, 0.66 MB a CTA at
//   C=F=128, are larger than shared memory); a slab's k16 steps issue back
//   to back, all of them, with one wait at its end (ptxas serializes every
//   wgmma of a kernel that branches around one or redefines an A fragment
//   while products are in flight); x_{t+1} and the backward's residuals are
//   bulk-copied a step ahead; residuals leave in 16-byte stores; the cell
//   uses the special-function unit's exp and reciprocal;
// - the BPTT computes dx_t = bf16(dgates_t) @ Wx^T from the dgates tile
//   (no dx kernel), dbx as per-sample column sums of the unrounded dgates
//   summed in a fixed order, and writes the dgates scratch in bf16 (the
//   rounding the weight gradient and the plain version use);
// - dW and dWx: a wgmma GEMM over the B*T*HW rows of the scratch, split in
//   K so the grid covers the card, partials summed in split order.
// No float atomics anywhere, so results are bit-reproducible.  The kernels
// take bf16 activations with C a multiple of 16, F a multiple of 16 up to
// 128 or of 32 up to 256, and H*W <= 64, and either gate dtype; f32
// activations at F a multiple of 16 up to 128 (convlstm_proj_f32.cu).  The
// entry points send every other shape to the general kernels
// (convlstm_general.cu; convlstm_launch.cuh's route, which the wrapper's
// route matches).  This file holds the bf16 2-CTA widths and the entry
// points; convlstm_proj_wide.cu the 4-CTA widths.

#include "convlstm_launch.cuh"

namespace mmvae {
namespace {

template <int BN>
cudaError_t launch_wgrad_bn(const void* x, const void* hs, const void* h0, const void* dG,
                            float* part, float* out, int B, int Tn, int H, int W, int C, int F,
                            int splits, cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  const int chunk = ((R + splits - 1) / splits + WW_BK - 1) / WW_BK * WW_BK;
  const int smem = wgrad_smem(F);
  auto kern = wgrad_wgmma_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + WW_BM - 1) / WW_BM, (F4 + BN - 1) / BN, splits);
  kern<<<grid, 256, smem, stream>>>((const bf16*)x, (const bf16*)hs, (const bf16*)h0,
                                    (const bf16*)dG, part, Tn, H, W, C, F, R, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(part, out, splits, M * F4);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvae

using namespace mmvae;

extern "C" {

// Which kernels a shape runs: 0 the wgmma kernels, 1 the general ones, -1
// refused (an activation dtype other than kBF16 and kF32).  C = 0 for K6.
int mmvae_convlstm_route(int act_dtype, int F, int HW, int C) {
  const Route r = route(act_dtype, F, HW, C);
  return r == kRefused ? -1 : r == kGeneral ? 1 : 0;
}

// Weights pre-packed by the wrapper (see convlstm_kernels.py) for the route
// of the shape; act_dtype the activations' (kBF16 or kF32); gcl and scratch
// the general route's CTAs a sample and f32 scratch (3 B HW F floats).
int mmvae_convlstm_proj_fwd(const void* x, const void* wpk, const void* bx, const void* c0,
                            const void* h0, void* out_h, void* out_c, void* out_g, int B,
                            int Tn, int H, int W, int C, int F, int gate_dtype, int save,
                            int act_dtype, int gcl, void* scratch, void* stream) {
  const ProjFwdArgs a{x, wpk, bx, c0, h0, out_h, out_c, out_g, B, Tn, H, W, C, F,
                      gate_dtype, save, act_dtype, gcl, scratch, (cudaStream_t)stream};
  switch (route(act_dtype, F, H * W, C)) {
    case kHere: return proj_fwd<bf16>(NarrowF{}, a);
    case kWide: return proj_fwd_wide(a);
    case kF32Route: return proj_fwd_f32(a);
    case kGeneral: return proj_fwd_general(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// BPTT (dgates scratch, dx, dc0, dh0, dbx); the general route's scratch
// holds 2 B HW F floats.
int mmvae_convlstm_proj_bwd(const void* wtpk, const void* wxpk, const void* c0, const void* cs,
                            const void* ga, const void* dhl, const void* dcl, void* dG, void* dx,
                            void* dbx_part, void* dbx_out, void* dc0, void* dh0, int B, int Tn,
                            int H, int W, int C, int F, int act_dtype, int gcl, void* scratch,
                            void* stream) {
  const ProjBwdArgs a{wtpk, wxpk, c0, cs, ga, dhl, dcl, dG, dx, dbx_part, dbx_out, dc0, dh0,
                      B, Tn, H, W, C, F, act_dtype, gcl, scratch, (cudaStream_t)stream};
  switch (route(act_dtype, F, H * W, C)) {
    case kHere: return proj_bwd<bf16>(NarrowF{}, a);
    case kWide: return proj_bwd_wide(a);
    case kF32Route: return proj_bwd_f32(a);
    case kGeneral: return proj_bwd_general(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dW and dWx ((C + 9F) x 4F, f32) from the dgates scratch (bf16, or f32
// with f32 activations); K6 passes C = 0 (dW alone) and hs for the x it
// does not have.
int mmvae_convlstm_wgrad(const void* x, const void* hs, const void* h0, const void* dG,
                         void* dw_part, void* dw_out, int B, int Tn, int H, int W, int C, int F,
                         int splits, int act_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Route r = route(act_dtype, F, H * W, C);
  if (r == kGeneral)
    return wgrad_general(x, hs, h0, dG, (float*)dw_part, (float*)dw_out, B, Tn, H, W, C, F,
                         splits, act_dtype, s);
  if (r == kF32Route)
    return wgrad_f32(x, hs, h0, dG, (float*)dw_part, (float*)dw_out, B, Tn, H, W, C, F, splits,
                     s);
  if (act_dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (wgrad_bn(F) == 256)
    return (int)launch_wgrad_bn<256>(x, hs, h0, dG, (float*)dw_part, (float*)dw_out, B, Tn, H,
                                     W, C, F, splits, s);
  return (int)launch_wgrad_bn<64>(x, hs, h0, dG, (float*)dw_part, (float*)dw_out, B, Tn, H, W,
                                  C, F, splits, s);
}

// The launch geometry the kernels use, for the wrapper to check against its
// own: {fwd stages, fwd smem, bwd stages, bwd smem, wgrad BN, wgrad smem,
// CTAs a sample}, for activations of `act_dtype`.
void mmvae_convlstm_proj_layout(int C, int F, int act_dtype, int* out) {
  const int es = act_dtype == kF32 ? 4 : 2;
  const FwdSmem f = fwd_smem_layout(C, F, true, es);
  const BwdSmem b = bwd_smem_layout(F, es);
  out[0] = f.stages;
  out[1] = f.total;
  out[2] = b.stages;
  out[3] = b.total;
  out[4] = es == 4 ? wgrad_f32_bn(F) : wgrad_bn(F);
  out[5] = es == 4 ? wgrad_f32_smem(F) : wgrad_smem(F);
  out[6] = rec_cluster(F);
}

}  // extern "C"
