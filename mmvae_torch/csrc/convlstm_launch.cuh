// Host launchers of K5 and K6 (the kernels of convlstm_wgmma.cuh) and their
// dispatch over a list of compile-time widths F and the activation type A.
// convlstm_proj.cu and convlstm_scan.cu instantiate them for bf16 at the
// 2-CTA widths (F <= 128) and hold the library's entry points;
// convlstm_proj_wide.cu and convlstm_scan_wide.cu instantiate them for bf16
// at the 4-CTA widths (F in (128, 256]), convlstm_proj_f32.cu and
// convlstm_scan_f32.cu for f32 at F <= 128, which the entry points hand on,
// so that the six sources compile in parallel.  Every other shape goes to
// the general kernels (convlstm_general.cu, `route`).
#pragma once

#include "convlstm_wgmma.cuh"

namespace mmvae {

// The arguments of the library's entry points, as the wrappers pass them.
// act_dtype: the activations', bf16 (kBF16) or f32 (kF32).  gcl and
// scratch: on the general route, the CTAs a sample and the f32 scratch the
// wrapper allocates (unused on the wgmma routes).
struct ProjFwdArgs {
  const void *x, *wpk, *bx, *c0, *h0;
  void *oh, *oc, *og;
  int B, Tn, H, W, C, F, gate_dtype, save, act_dtype, gcl;
  void* scratch;
  cudaStream_t stream;
};
struct ProjBwdArgs {
  const void *wtpk, *wxpk, *c0, *cs, *ga, *dhl, *dcl;
  void *dG, *dx, *dbx_part, *dbx_out, *dc0, *dh0;
  int B, Tn, H, W, C, F, act_dtype, gcl;
  void* scratch;
  cudaStream_t stream;
};
struct ScanFwdArgs {
  const void *xg, *wpk, *c0, *h0;
  void *oh, *oc, *og;
  int B, Tn, xg_steps, H, W, F, gate_dtype, mode, act_dtype, gcl;
  void* scratch;
  cudaStream_t stream;
};
struct ScanBwdArgs {
  const void *wtpk, *c0, *cs, *ga, *dhs, *dcl;
  void *dG, *dxg, *dxs, *dc0, *dh0;
  int B, Tn, H, W, F, const_x, last_only, act_dtype, gcl;
  void* scratch;
  cudaStream_t stream;
};

// The 4-CTA widths (convlstm_proj_wide.cu, convlstm_scan_wide.cu).
int proj_fwd_wide(const ProjFwdArgs& a);
int proj_bwd_wide(const ProjBwdArgs& a);
int scan_fwd_wide(const ScanFwdArgs& a);
int scan_bwd_wide(const ScanBwdArgs& a);
// f32 activations (convlstm_proj_f32.cu, convlstm_scan_f32.cu): F <= 128.
int proj_fwd_f32(const ProjFwdArgs& a);
int proj_bwd_f32(const ProjBwdArgs& a);
int scan_fwd_f32(const ScanFwdArgs& a);
int scan_bwd_f32(const ScanBwdArgs& a);
int wgrad_f32(const void* x, const void* hs, const void* h0, const void* dG, float* part,
              float* out, int B, int Tn, int H, int W, int C, int F, int splits,
              cudaStream_t stream);
// Every other shape (convlstm_general.cu).
int proj_fwd_general(const ProjFwdArgs& a);
int proj_bwd_general(const ProjBwdArgs& a);
int scan_fwd_general(const ScanFwdArgs& a);
int scan_bwd_general(const ScanBwdArgs& a);
int wgrad_general(const void* x, const void* hs, const void* h0, const void* dG, float* part,
                  float* out, int B, int Tn, int H, int W, int C, int F, int splits,
                  int act_dtype, cudaStream_t stream);

namespace {

template <typename A, typename G, bool SAVE, int F>
cudaError_t launch_fwd(ProjFwdArgs a) {
  const FwdSmem L = fwd_smem_layout(a.C, F, true, sizeof(A));
  if (L.stages < MIN_STAGES) return cudaErrorInvalidValue;
  int xg_steps = 0;
  void* args[] = {&a.x,  &a.wpk, &a.bx, &a.c0, &a.h0, &a.oh, &a.oc,
                  &a.og, &a.Tn,  &a.H,  &a.W,  &a.C,  &xg_steps};
  return cluster_launch((const void*)rec_fwd_wgmma_kernel<A, G, SAVE ? kSave : kLast, F, false>,
                        rec_cluster(F) * a.B, rec_threads(F), L.total, a.stream, args,
                        rec_cluster(F));
}

template <typename A, int F>
cudaError_t launch_bwd(ProjBwdArgs a) {
  const BwdSmem L = bwd_smem_layout(F, sizeof(A));
  if (L.stages < MIN_STAGES) return cudaErrorInvalidValue;
  void* none = nullptr;
  int last_only = 1;
  void* args[] = {&a.wtpk,     &a.wxpk, &a.c0,  &a.cs,  &a.ga, &a.dhl, &a.dcl,
                  &a.dG,       &a.dx,   &a.dbx_part, &none, &none, &a.dc0, &a.dh0,
                  &a.Tn,       &a.H,    &a.W,   &a.C,   &last_only};
  cudaError_t err = cluster_launch((const void*)rec_bwd_wgmma_kernel<A, F, true>,
                                   rec_cluster(F) * a.B, BWD_THREADS, L.total, a.stream, args,
                                   rec_cluster(F));
  if (err != cudaSuccess) return err;
  // dbx: the per-sample partials summed in sample order.
  reduce_splits_kernel<<<(4 * F + 255) / 256, 256, 0, a.stream>>>(
      (const float*)a.dbx_part, (float*)a.dbx_out, a.B, 4 * F);
  return cudaGetLastError();
}

template <typename A, typename G, int MODE, int F>
cudaError_t launch_scan_fwd(ScanFwdArgs a) {
  const FwdSmem L = fwd_smem_layout(0, F, false, sizeof(A));
  if (L.stages < MIN_STAGES) return cudaErrorInvalidValue;
  const void* bx = nullptr;
  int C = 0;
  void* args[] = {&a.xg, &a.wpk, &bx,  &a.c0, &a.h0, &a.oh, &a.oc,
                  &a.og, &a.Tn,  &a.H, &a.W,  &C,    &a.xg_steps};
  return cluster_launch((const void*)rec_fwd_wgmma_kernel<A, G, MODE, F, true>,
                        rec_cluster(F) * a.B, rec_threads(F), L.total, a.stream, args,
                        rec_cluster(F));
}

template <typename A, int F>
cudaError_t launch_scan_bwd(ScanBwdArgs a) {
  constexpr int ES = sizeof(A);
  const BwdSmem L = scan_bwd_smem_layout(F, a.const_x, ES);
  if (L.stages < scan_bwd_min_stages(F, a.const_x, ES)) return cudaErrorInvalidValue;
  if (a.const_x && !scan_sum_in_smem(F, true, ES) && a.dxs == nullptr)
    return cudaErrorInvalidValue;
  const void* none = nullptr;
  void* no_out = nullptr;
  void* dxg_sum = a.const_x ? a.dxg : nullptr;
  int C = 0;
  void* args[] = {&a.wtpk, &none,   &a.c0,   &a.cs,    &a.ga,  &a.dhs, &a.dcl,
                  &a.dG,   &no_out, &no_out, &dxg_sum, &a.dxs, &a.dc0, &a.dh0,
                  &a.Tn,   &a.H,    &a.W,    &C,       &a.last_only};
  return cluster_launch((const void*)rec_bwd_wgmma_kernel<A, F, false>, rec_cluster(F) * a.B,
                        BWD_THREADS, L.total, a.stream, args, rec_cluster(F));
}

// The entry points' bodies over the widths of `fs`, for activations A.
template <typename A, typename G, bool SAVE, typename FS>
int proj_fwd_g(FS fs, const ProjFwdArgs& a) {
  return with_f(fs, a.F,
                [&](auto f) { return (int)launch_fwd<A, G, SAVE, decltype(f)::value>(a); });
}

template <typename A, typename FS>
int proj_fwd(FS fs, const ProjFwdArgs& a) {
  if (a.gate_dtype == kF32)
    return a.save ? proj_fwd_g<A, float, true>(fs, a) : proj_fwd_g<A, float, false>(fs, a);
  if (a.gate_dtype == kBF16)
    return a.save ? proj_fwd_g<A, bf16, true>(fs, a) : proj_fwd_g<A, bf16, false>(fs, a);
  return (int)cudaErrorInvalidValue;
}

template <typename A, typename FS>
int proj_bwd(FS fs, const ProjBwdArgs& a) {
  return with_f(fs, a.F, [&](auto f) { return (int)launch_bwd<A, decltype(f)::value>(a); });
}

template <typename A, typename G, int MODE, typename FS>
int scan_fwd_gm(FS fs, const ScanFwdArgs& a) {
  return with_f(fs, a.F,
                [&](auto f) { return (int)launch_scan_fwd<A, G, MODE, decltype(f)::value>(a); });
}

template <typename A, typename G, typename FS>
int scan_fwd_g(FS fs, const ScanFwdArgs& a) {
  if (a.mode == kSave) return scan_fwd_gm<A, G, kSave>(fs, a);
  if (a.mode == kHiddens) return scan_fwd_gm<A, G, kHiddens>(fs, a);
  if (a.mode == kLast) return scan_fwd_gm<A, G, kLast>(fs, a);
  return (int)cudaErrorInvalidValue;
}

template <typename A, typename FS>
int scan_fwd(FS fs, const ScanFwdArgs& a) {
  if (a.gate_dtype == kF32) return scan_fwd_g<A, float>(fs, a);
  if (a.gate_dtype == kBF16) return scan_fwd_g<A, bf16>(fs, a);
  return (int)cudaErrorInvalidValue;
}

template <typename A, typename FS>
int scan_bwd(FS fs, const ScanBwdArgs& a) {
  return with_f(fs, a.F, [&](auto f) { return (int)launch_scan_bwd<A, decltype(f)::value>(a); });
}

// Where an entry point's call goes (convlstm_kernels.route in Python picks
// the same).  The wgmma kernels' domain: F a multiple of 16 up to 128 (bf16
// or f32 activations) or of 32 up to 256 (bf16), H*W <= 64, and for K5 (C >
// 0; K6 passes C = 0) C a multiple of 16 with at least MIN_STAGES ring
// stages in both of its recurrences.  In it, f32 activations go to the f32
// sources, bf16 to the 4-CTA sources above F = 128, else here; every other
// shape with bf16 or f32 activations to the general kernels.
enum Route : int { kHere = 0, kWide = 1, kF32Route = 2, kGeneral = 3, kRefused = 4 };
inline Route route(int act_dtype, int F, int HW, int C) {
  if (act_dtype != kF32 && act_dtype != kBF16) return kRefused;
  const int es = act_dtype == kF32 ? 4 : 2;
  const bool narrow = F % 16 == 0 && F > 0 && F <= 128;
  const bool wide = es == 2 && F % 32 == 0 && F > 128 && F <= 256;
  bool wgmma = (narrow || wide) && HW <= 64 && C % 16 == 0;
  if (wgmma && C > 0)
    wgmma = fwd_smem_layout(C, F, true, es).stages >= MIN_STAGES &&
            bwd_smem_layout(F, es).stages >= MIN_STAGES;
  if (!wgmma) return kGeneral;
  if (es == 4) return kF32Route;
  return F > 128 ? kWide : kHere;
}

}  // namespace
}  // namespace mmvae
