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
// What bounds it on the H100: the products, (C + 9F) x 4F a position and
// step forward and twice that backward, on the tensor cores (mma.sync:
// bf16, or f64 for f32 activations, 3xTF32 in K5's dx), and
// the T dependent steps of a sample, each a chain of k-blocks on one CTA
// ending in a cluster barrier.  What the design does about it: a cluster of
// `cl` CTAs a sample (GenGeo) holds h_{t-1} (forward) or its own dgate
// columns (BPTT) in shared memory, so the taps read no global memory; the
// weights stream through a cp.async ring that runs on across steps; h_t
// and the partial dh go between the cluster's CTAs over distributed shared
// memory; K5's x projection runs once over all steps as a GEMM.  PERF.md
// holds the times beside the bounds.

#include "convlstm_launch.cuh"
#include "convlstm_general.cuh"

namespace mmvae {
namespace {

// A launch of `ctas` CTAs in clusters of `cluster` (above 8: a non-portable
// size) with `smem` bytes of dynamic shared memory.
cudaError_t gen_launch(const void* kern, int ctas, int smem, cudaStream_t stream, void** args,
                       int cluster) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(GEN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kern, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The wrapper's CTAs a sample and scratch must be the geometry's.
bool general_args_ok(const GenGeo& g, int gcl, long need, const void* scratch) {
  return gcl == g.cl && (need == 0 || scratch != nullptr);
}

template <typename A, typename G, typename XT, int MODE>
int launch_gen_fwd(GenFwdArgs p, int B, cudaStream_t stream) {
  void* args[] = {&p};
  return (int)gen_launch((const void*)gen_fwd_kernel<A, G, XT, MODE>, B * p.g.cl, p.g.f_smem,
                         stream, args, p.g.cl);
}

// The bytes of K5's x projection in the general scratch, before the
// recurrence's own (the wrapper allocates the same).
size_t gen_xproj_bytes(int R, int F, int gate_dtype) {
  return ((size_t)R * 4 * F * (gate_dtype == kF32 ? 4 : 2) + 255) / 256 * 256;
}

// K5: the x projection G(x Wx + bx) into the scratch, then the recurrence
// with it as xg.  wpk holds the recurrence's packed W, then Wx's fragments.
template <typename A, typename G>
int gen_proj_fwd_g(const ProjFwdArgs& a, const GenGeo& g) {
  const int R = a.B * a.Tn * a.H * a.W, F4 = 4 * a.F;
  G* xg = static_cast<G*>(a.scratch);
  const unsigned char* wxp = static_cast<const unsigned char*>(a.wpk) +
                             (size_t)g.cl * g.f.nkb * g.f.nt * gen_tile_bytes(sizeof(A));
  const int smem = gen_xproj_smem(a.C, sizeof(A));
  cudaError_t err = cudaFuncSetAttribute((const void*)gen_xproj_kernel<A, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gen_xproj_kernel<A, G><<<gceil(R, 128), GEN_THREADS, smem, a.stream>>>(
      (const A*)a.x, wxp, (const float*)a.bx, xg, R, a.C, F4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GenFwdArgs p{xg, a.wpk, a.c0, a.h0, a.oh, a.oc, a.og,
                     static_cast<unsigned char*>(a.scratch) + gen_xproj_bytes(R, a.F, a.gate_dtype),
                     a.Tn, a.H, a.W, a.F, a.Tn, g};
  if (a.save) return launch_gen_fwd<A, G, G, kSave>(p, a.B, a.stream);
  return launch_gen_fwd<A, G, G, kLast>(p, a.B, a.stream);
}

template <typename A>
int gen_proj_fwd(const ProjFwdArgs& a, const GenGeo& g) {
  if (a.gate_dtype == kF32) return gen_proj_fwd_g<A, float>(a, g);
  if (a.gate_dtype == kBF16) return gen_proj_fwd_g<A, bf16>(a, g);
  return (int)cudaErrorInvalidValue;
}

template <typename A, int MODE>
int gen_scan_fwd_mode(int gate_dtype, const GenFwdArgs& p, int B, cudaStream_t stream) {
  if (gate_dtype == kF32) return launch_gen_fwd<A, float, A, MODE>(p, B, stream);
  if (gate_dtype == kBF16) return launch_gen_fwd<A, bf16, A, MODE>(p, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename A>
int gen_scan_fwd(const ScanFwdArgs& a, const GenGeo& g) {
  const GenFwdArgs p{a.xg, a.wpk, a.c0, a.h0, a.oh, a.oc, a.og,
                     static_cast<unsigned char*>(a.scratch), a.Tn, a.H, a.W, a.F, a.xg_steps, g};
  switch (a.mode) {
    case kSave: return gen_scan_fwd_mode<A, kSave>(a.gate_dtype, p, a.B, a.stream);
    case kHiddens: return gen_scan_fwd_mode<A, kHiddens>(a.gate_dtype, p, a.B, a.stream);
    case kLast: return gen_scan_fwd_mode<A, kLast>(a.gate_dtype, p, a.B, a.stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename A, bool PROJ>
cudaError_t launch_gen_bwd(GenBwdArgs p, int B, cudaStream_t stream) {
  void* args[] = {&p};
  return gen_launch((const void*)gen_bwd_kernel<A, PROJ>, B * p.g.cl, p.g.b_smem, stream, args,
                    p.g.cl);
}

template <typename A>
int gen_proj_bwd(const ProjBwdArgs& a, const GenGeo& g) {
  const GenBwdArgs p{a.wtpk, a.c0, a.cs, a.ga, a.dhl, a.dcl, a.dG, nullptr, a.dc0, a.dh0,
                     static_cast<float*>(a.dbx_part), static_cast<unsigned char*>(a.scratch),
                     a.Tn, a.H, a.W, a.F, 0, 1, g};
  cudaError_t err = launch_gen_bwd<A, true>(p, a.B, a.stream);
  if (err != cudaSuccess) return (int)err;
  // dbx: the per-sample partials summed in sample order.
  reduce_splits_kernel<<<(4 * a.F + 255) / 256, 256, 0, a.stream>>>(
      (const float*)a.dbx_part, (float*)a.dbx_out, a.B, 4 * a.F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = a.B * a.Tn * a.H * a.W;
  gen_dx_kernel<A><<<dim3(gceil(R, 128), gceil(gceil(a.C, 8), 8)), GEN_THREADS, 0, a.stream>>>(
      (const A*)a.dG, (const unsigned char*)a.wxpk, (A*)a.dx, R, 4 * a.F, a.C);
  return (int)cudaGetLastError();
}

template <typename A>
int gen_scan_bwd(const ScanBwdArgs& a, const GenGeo& g) {
  if (a.const_x && a.dxs == nullptr) return (int)cudaErrorInvalidValue;
  const GenBwdArgs p{a.wtpk, a.c0, a.cs, a.ga, a.dhs, a.dcl, a.dG, a.const_x ? a.dxg : nullptr,
                     a.dc0, a.dh0, a.const_x ? static_cast<float*>(a.dxs) : nullptr,
                     static_cast<unsigned char*>(a.scratch), a.Tn, a.H, a.W, a.F, a.const_x,
                     a.last_only, g};
  return (int)launch_gen_bwd<A, false>(p, a.B, a.stream);
}

template <typename A>
int gen_wgrad(const void* x, const void* hs, const void* h0, const void* dG, float* part,
              float* out, int B, int Tn, int H, int W, int C, int F, int splits,
              cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  const int chunk = gup(gceil(R, splits), GEN_WG_BK);
  const int smem = gen_wgrad_smem(sizeof(A));
  const void* kern = (const void*)gen_wgrad_kernel<A>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(gceil(C, GEN_WG_BM) + 9 * gceil(F, GEN_WG_BM), gceil(F4, GEN_WG_BN), splits);
  gen_wgrad_kernel<A><<<grid, GEN_THREADS, smem, stream>>>((const A*)x, (const A*)hs,
                                                            (const A*)h0, (const A*)dG, part, Tn,
                                                            H, W, C, F, R, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(part, out, splits, M * F4);
  return (int)cudaGetLastError();
}

int es_of(int act_dtype) { return act_dtype == kF32 ? 4 : 2; }

}  // namespace

int proj_fwd_general(const ProjFwdArgs& a) {
  const GenGeo g = gen_geometry(a.B, a.H, a.W, a.F, es_of(a.act_dtype));
  if (!general_args_ok(g, a.gcl, 1, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_proj_fwd<float>(a, g) : gen_proj_fwd<bf16>(a, g);
}

int proj_bwd_general(const ProjBwdArgs& a) {
  const GenGeo g = gen_geometry(a.B, a.H, a.W, a.F, es_of(a.act_dtype));
  if (!general_args_ok(g, a.gcl, g.b_scratch, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_proj_bwd<float>(a, g) : gen_proj_bwd<bf16>(a, g);
}

int scan_fwd_general(const ScanFwdArgs& a) {
  const GenGeo g = gen_geometry(a.B, a.H, a.W, a.F, es_of(a.act_dtype));
  if (!general_args_ok(g, a.gcl, g.f_scratch, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_scan_fwd<float>(a, g) : gen_scan_fwd<bf16>(a, g);
}

int scan_bwd_general(const ScanBwdArgs& a) {
  const GenGeo g = gen_geometry(a.B, a.H, a.W, a.F, es_of(a.act_dtype));
  if (!general_args_ok(g, a.gcl, g.b_scratch, a.scratch)) return (int)cudaErrorInvalidValue;
  return a.act_dtype == kF32 ? gen_scan_bwd<float>(a, g) : gen_scan_bwd<bf16>(a, g);
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

using namespace mmvae;

extern "C" {

// The general kernels' geometry at (B, H, W, F) for activations of
// `act_dtype` (K5 and K6 alike), for the wrapper to check against its own
// (convlstm_kernels.general_geometry): {cl, nc, forward: nkb, nt, passes,
// pbk, stage bytes, state resident, h copies, gates staged, smem, scratch;
// BPTT: nkb, nt,
// passes, pbk, stage bytes, carries, dgates tile and partials resident,
// smem, scratch; the weight GEMM's smem}.
void mmvae_convlstm_general_layout(int B, int H, int W, int F, int act_dtype, long long* out) {
  const int es = es_of(act_dtype);
  const GenGeo g = gen_geometry(B, H, W, F, es);
  const long long v[] = {g.cl,        g.nc,       g.f.nkb,        g.f.nt,    g.f.passes,
                         g.f.pbk,     g.f.stage_bytes, g.state_res, g.hbuf,  g.gst_res, g.f_smem,
                         g.f_scratch, g.b.nkb,    g.b.nt,         g.b.passes, g.b.pbk,
                         g.b.stage_bytes, g.carry_res, g.dg_res,  g.part_res, g.b_smem,
                         g.b_scratch, gen_wgrad_smem(es)};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}

// The weight GEMM's split-K over `rows` rows.
int mmvae_convlstm_general_splits(int rows, int C, int F) { return gen_wgrad_splits(rows, C, F); }

#ifdef GEN_PHASE_TIMES
// The cycles the phases of the last launches took, and zeroes them
// (gen_phase_t: 16 uint64, forward then BPTT).
int mmvae_gen_phase_times(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mmvae::gen_phase_t, sizeof(mmvae::gen_phase_t));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(mmvae::gen_phase_t, zero, sizeof(zero));
}
#endif

}  // extern "C"
