// K6 (convlstm_scan.cu) with f32 activations: F a multiple of 16 up to 128,
// one cluster of 2 CTAs a sample, 3xTF32 products (see convlstm_proj_f32.cu,
// whose weight GEMM K6's dW shares).  A time-constant xg's f32 dgates sum
// lives in a global scratch the wrapper passes, one (64, 2F) block a CTA,
// each cell read and written by the thread that owns it, so the sum keeps
// its step order.  A streaming xg's dxg is the f32 dgates scratch.  The
// entry points of convlstm_scan.cu hand these calls on; the instantiations
// sit apart so that nvcc builds them beside the bf16 ones.
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_pallas under
//   model.dtype=float32.

#include "convlstm_launch.cuh"

namespace mmvae {

int scan_fwd_f32(const ScanFwdArgs& a) { return scan_fwd<float>(NarrowF{}, a); }
int scan_bwd_f32(const ScanBwdArgs& a) { return scan_bwd<float>(NarrowF{}, a); }

}  // namespace mmvae
