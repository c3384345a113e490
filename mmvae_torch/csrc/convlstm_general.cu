// K5 and K6 at the shapes outside the wgmma kernels' domain: 16x16 grids
// and any other H*W, any F and C, f32 activations above F = 128 (kernels in
// convlstm_general.cuh; the entry points of convlstm_proj.cu and
// convlstm_scan.cu hand these shapes on, convlstm_launch.cuh's route).
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_proj_pallas
//   (K5: _fwd_proj_kernel, _fwd_proj_kernel_nores, _bwd_proj_kernel) and
//   ::convlstm_scan_pallas (K6: _fwd_kernel, _fwd_kernel_nores,
//   _bwd_kernel) at every shape VMEM holds on the TPU: the JAX package's
//   own small widths (enc_channels (8, 16), F = 16, a 16x16 grid), the
//   README's (F = C = 8), F off the multiples of 16 or 32, and the
//   reference's lstm_features=192 probe at the JAX package's default
//   float32 activations.
//
// What bounds it on the H100: the products on the CUDA cores' f32 FMA at
// 67 TFLOP/s at most, where the wgmma kernels reach the tensor cores; the
// recurrences' one CTA cluster a sample runs (C + 9F) x 4F products a
// position and step in 64 x 64 (or 128 x 32, 256 x 16) tiles, with a
// cluster barrier a step.  What the design does about it: the cluster of up
// to 8 CTAs a sample (`gcl`, convlstm_kernels.general_cluster) splits each
// step's columns so that B gcl CTAs fill the card, and every product stays
// f32-accurate.  Speed is later work; PERF.md holds the times and bounds.

#include "convlstm_launch.cuh"
#include "convlstm_general.cuh"

namespace mmvae {
namespace {

bool general_args_ok(int gcl, int F, const void* scratch) {
  return gcl >= 1 && gcl <= GEN_MAX_CLUSTER && gcl <= F && scratch != nullptr;
}

template <typename A, typename G, int MODE, bool XG>
int launch_gen_fwd(const void* x, const void* wg, const void* bg, const void* c0, const void* h0,
                   void* oh, void* oc, void* og, void* scratch, int B, int Tn, int H, int W,
                   int C, int F, int xg_steps, int gcl, cudaStream_t stream) {
  float* cst = static_cast<float*>(scratch);
  A* hbuf = reinterpret_cast<A*>(cst + (size_t)B * H * W * F);
  void* args[] = {&x, &wg, &bg, &c0, &h0, &oh, &oc, &og, &cst, &hbuf,
                  &Tn, &H, &W, &C, &F, &xg_steps, &gcl};
  return (int)cluster_launch((const void*)gen_fwd_kernel<A, G, MODE, XG>, gcl * B, GEN_THREADS,
                             0, stream, args, gcl);
}

template <typename A, bool XG, int MODE>
int gen_fwd_gate(int gate_dtype, const void* x, const void* wg, const void* bg, const void* c0,
                 const void* h0, void* oh, void* oc, void* og, void* scratch, int B, int Tn,
                 int H, int W, int C, int F, int xg_steps, int gcl, cudaStream_t stream) {
  if (gate_dtype == kF32)
    return launch_gen_fwd<A, float, MODE, XG>(x, wg, bg, c0, h0, oh, oc, og, scratch, B, Tn, H,
                                              W, C, F, xg_steps, gcl, stream);
  if (gate_dtype == kBF16)
    return launch_gen_fwd<A, bf16, MODE, XG>(x, wg, bg, c0, h0, oh, oc, og, scratch, B, Tn, H,
                                             W, C, F, xg_steps, gcl, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename A>
int gen_proj_fwd(const ProjFwdArgs& a) {
  if (a.save)
    return gen_fwd_gate<A, false, kSave>(a.gate_dtype, a.x, a.wpk, a.bx, a.c0, a.h0, a.oh, a.oc,
                                         a.og, a.scratch, a.B, a.Tn, a.H, a.W, a.C, a.F, 0,
                                         a.gcl, a.stream);
  return gen_fwd_gate<A, false, kLast>(a.gate_dtype, a.x, a.wpk, a.bx, a.c0, a.h0, a.oh, a.oc,
                                       a.og, a.scratch, a.B, a.Tn, a.H, a.W, a.C, a.F, 0, a.gcl,
                                       a.stream);
}

template <typename A>
int gen_scan_fwd(const ScanFwdArgs& a) {
  const void* no_bias = nullptr;
  switch (a.mode) {
    case kSave:
      return gen_fwd_gate<A, true, kSave>(a.gate_dtype, a.xg, a.wpk, no_bias, a.c0, a.h0, a.oh,
                                          a.oc, a.og, a.scratch, a.B, a.Tn, a.H, a.W, 0, a.F,
                                          a.xg_steps, a.gcl, a.stream);
    case kHiddens:
      return gen_fwd_gate<A, true, kHiddens>(a.gate_dtype, a.xg, a.wpk, no_bias, a.c0, a.h0,
                                             a.oh, a.oc, a.og, a.scratch, a.B, a.Tn, a.H, a.W, 0,
                                             a.F, a.xg_steps, a.gcl, a.stream);
    case kLast:
      return gen_fwd_gate<A, true, kLast>(a.gate_dtype, a.xg, a.wpk, no_bias, a.c0, a.h0, a.oh,
                                          a.oc, a.og, a.scratch, a.B, a.Tn, a.H, a.W, 0, a.F,
                                          a.xg_steps, a.gcl, a.stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename A, bool PROJ>
cudaError_t launch_gen_bwd(const void* wt, const void* c0, const void* cs, const void* ga,
                           const void* dhs, const void* dcl, void* dG, void* dsum, void* dxg,
                           void* dc0, void* dh0, void* scratch, int B, int Tn, int H, int W,
                           int F, int gcl, int const_x, int last_only, cudaStream_t stream) {
  float* dhbuf = static_cast<float*>(scratch);
  float* dcst = dhbuf + (size_t)B * H * W * F;
  void* args[] = {&wt, &c0, &cs, &ga, &dhs, &dcl, &dG, &dsum, &dxg, &dc0,
                  &dh0, &dhbuf, &dcst, &Tn, &H, &W, &F, &gcl, &const_x, &last_only};
  return cluster_launch((const void*)gen_bwd_kernel<A, PROJ>, gcl * B, GEN_THREADS, 0, stream,
                        args, gcl);
}

template <typename A>
int gen_proj_bwd(const ProjBwdArgs& a) {
  cudaError_t err = launch_gen_bwd<A, true>(a.wtpk, a.c0, a.cs, a.ga, a.dhl, a.dcl, a.dG,
                                            a.dbx_part, nullptr, a.dc0, a.dh0, a.scratch, a.B,
                                            a.Tn, a.H, a.W, a.F, a.gcl, 0, 1, a.stream);
  if (err != cudaSuccess) return (int)err;
  // dbx: the per-sample partials summed in sample order.
  reduce_splits_kernel<<<(4 * a.F + 255) / 256, 256, 0, a.stream>>>(
      (const float*)a.dbx_part, (float*)a.dbx_out, a.B, 4 * a.F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = a.B * a.Tn * a.H * a.W;
  gen_dx_kernel<A><<<dim3((R + 63) / 64, (a.C + 63) / 64), GEN_THREADS, 0, a.stream>>>(
      (const A*)a.dG, (const float*)a.wxpk, (A*)a.dx, R, 4 * a.F, a.C);
  return (int)cudaGetLastError();
}

template <typename A>
int gen_scan_bwd(const ScanBwdArgs& a) {
  if (a.const_x && a.dxs == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_gen_bwd<A, false>(a.wtpk, a.c0, a.cs, a.ga, a.dhs, a.dcl, a.dG,
                                       a.const_x ? a.dxs : nullptr, a.const_x ? a.dxg : nullptr,
                                       a.dc0, a.dh0, a.scratch, a.B, a.Tn, a.H, a.W, a.F, a.gcl,
                                       a.const_x, a.last_only, a.stream);
}

template <typename A>
int gen_wgrad(const void* x, const void* hs, const void* h0, const void* dG, float* part,
              float* out, int B, int Tn, int H, int W, int C, int F, int splits,
              cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  const int chunk = ((R + splits - 1) / splits + GEN_BK - 1) / GEN_BK * GEN_BK;
  dim3 grid((M + 63) / 64, (F4 + 63) / 64, splits);
  gen_wgrad_kernel<A><<<grid, GEN_THREADS, 0, stream>>>((const A*)x, (const A*)hs, (const A*)h0,
                                                        (const A*)dG, part, Tn, H, W, C, F, R,
                                                        chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(part, out, splits, M * F4);
  return (int)cudaGetLastError();
}

}  // namespace

int proj_fwd_general(const ProjFwdArgs& a) {
  if (!general_args_ok(a.gcl, a.F, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_proj_fwd<float>(a) : gen_proj_fwd<bf16>(a);
}

int proj_bwd_general(const ProjBwdArgs& a) {
  if (!general_args_ok(a.gcl, a.F, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_proj_bwd<float>(a) : gen_proj_bwd<bf16>(a);
}

int scan_fwd_general(const ScanFwdArgs& a) {
  if (!general_args_ok(a.gcl, a.F, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_scan_fwd<float>(a) : gen_scan_fwd<bf16>(a);
}

int scan_bwd_general(const ScanBwdArgs& a) {
  if (!general_args_ok(a.gcl, a.F, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_scan_bwd<float>(a) : gen_scan_bwd<bf16>(a);
}

int wgrad_general(const void* x, const void* hs, const void* h0, const void* dG, float* part,
                  float* out, int B, int Tn, int H, int W, int C, int F, int splits,
                  int act_dtype, cudaStream_t stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (act_dtype == kF32)
    return gen_wgrad<float>(x, hs, h0, dG, part, out, B, Tn, H, W, C, F, splits, stream);
  return gen_wgrad<bf16>(x, hs, h0, dG, part, out, B, Tn, H, W, C, F, splits, stream);
}

}  // namespace mmvae
