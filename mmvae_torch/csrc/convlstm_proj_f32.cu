// K5 (convlstm_proj.cu) with f32 activations: F a multiple of 16 up to 128,
// one cluster of 2 CTAs a sample, and the f32 weight GEMM that K5 and K6
// share.  The entry points of convlstm_proj.cu hand these calls on; the
// instantiations sit apart so that nvcc builds them beside the bf16 ones.
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_proj_pallas
//   under model.dtype=float32, the JAX package's default activation dtype:
//   there the products run in the weights' dtype (f32) with f32
//   accumulation, and the BPTT rounds its dgates to the weights' dtype.
//
// Products: f32-accurate 3xTF32 on wgmma (hopper.cuh): each operand split
// into a TF32 hi part and a TF32 lo part, lo hi + hi lo + hi hi; the
// weights are split by the wrapper, the operand tiles (x, h, dgates) by the
// consumer threads as they gather their fragments.  TF32 wgmma takes both
// operands K-major, with k8 steps and A fragments of 32-bit elements, which
// the threads read from the tiles with 32-bit loads (ldmatrix moves 16-bit
// pieces).  The tensor cores add into their accumulators with truncation:
// summed there over a whole step (K = C + 9F) or a whole weight gradient,
// the products drifted by thousands of f32 ulps on the H100, as far from
// the plain version as a 1xTF32 product.  So each slab (the weight GEMM:
// each stage of 32 rows) is summed in a zeroed accumulator and added into
// f32 registers, which costs one add an accumulator a slab and brings the
// weight GEMM as close to an f64 product as cuBLAS's f32 GEMM
// (kernel_checks.wgrad_f64_readings).  The gates follow the TPU kernel's rounding: the x projection with
// the bias and the conv each rounded to the gate dtype, then added.
//
// What bounds it on the H100: three TF32 passes at 494.7 TFLOP/s (the
// card's fastest f32-accurate product rate, ~165 TFLOP/s of f32 products):
// at config 3's shape (B=64, T=20, 8x8, C=F=128) the forward's 92 GFLOP
// take at least 0.56 ms.  Like the bf16 kernels the recurrences run a
// serial chain of slabs a step, each a handshake, fragment loads, products
// and a wait; an f32 weight is 8 ring bytes (its two parts), so a slot holds
// 8 rows in the forward (160 slabs a step at C=F=128, against bf16's 40)
// and 32 in the BPTT.
//
// Shared memory: the f32 tiles are twice the bf16 ones, so nothing else is
// staged: the forward writes its residuals (hs, cs, gates) from registers,
// a float2 a thread, a whole 32-byte sector for each row of 8 channels, and
// the BPTT reads its residuals from global memory into registers.  Two CTAs
// a sample then keep 5-8 forward slots and 5-7 BPTT slots at F <= 128.  K6's
// BPTT keeps a time-constant xg's f32 dgates sum in a global scratch (as
// with 4 CTAs a sample).  The dgates scratch is f32, as JAX rounds dgates
// to the weights' dtype.  No float atomics: the results are
// bit-reproducible.

#include "convlstm_launch.cuh"

namespace mmvae {
namespace {

template <int BN>
cudaError_t launch_wgrad_f32(const void* x, const void* hs, const void* h0, const void* dG,
                             float* part, float* out, int B, int Tn, int H, int W, int C, int F,
                             int splits, cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  const int chunk = ((R + splits - 1) / splits + WF_BK - 1) / WF_BK * WF_BK;
  const int smem = wgrad_f32_smem(F);
  auto kern = wgrad_f32_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + WW_BM - 1) / WW_BM, (F4 + BN - 1) / BN, splits);
  kern<<<grid, 256, smem, stream>>>((const float*)x, (const float*)hs, (const float*)h0,
                                    (const float*)dG, part, Tn, H, W, C, F, R, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(part, out, splits, M * F4);
  return cudaGetLastError();
}

}  // namespace

int proj_fwd_f32(const ProjFwdArgs& a) { return proj_fwd<float>(NarrowF{}, a); }
int proj_bwd_f32(const ProjBwdArgs& a) { return proj_bwd<float>(NarrowF{}, a); }

int wgrad_f32(const void* x, const void* hs, const void* h0, const void* dG, float* part,
              float* out, int B, int Tn, int H, int W, int C, int F, int splits,
              cudaStream_t stream) {
  if (wgrad_f32_bn(F) == 128)
    return (int)launch_wgrad_f32<128>(x, hs, h0, dG, part, out, B, Tn, H, W, C, F, splits, stream);
  return (int)launch_wgrad_f32<64>(x, hs, h0, dG, part, out, B, Tn, H, W, C, F, splits, stream);
}

}  // namespace mmvae
