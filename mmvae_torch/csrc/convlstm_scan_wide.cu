// K6 (convlstm_scan.cu) at the 4-CTA widths: F = 160, 192, 224 and 256, one
// cluster of 4 CTAs a sample (see convlstm_wgmma.cuh).  A time-constant
// xg's f32 dgates sum, which beside the whole dgates tile no longer fits a
// CTA's shared memory, lives in a global scratch the wrapper passes, one
// (64, F) block a CTA, each cell read and written by the thread that owns
// it, so the sum keeps its step order.  The entry points of convlstm_scan.cu
// hand these widths on; the instantiations sit apart so that nvcc builds
// them beside the 2-CTA ones.
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_pallas at
//   lstm_features 160-256.

#include "convlstm_launch.cuh"

namespace mmvae {

int scan_fwd_wide(const ScanFwdArgs& a) { return scan_fwd<bf16>(WideF{}, a); }
int scan_bwd_wide(const ScanBwdArgs& a) { return scan_bwd<bf16>(WideF{}, a); }

}  // namespace mmvae
