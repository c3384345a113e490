// K5 (convlstm_proj.cu) at the 4-CTA widths: F = 160, 192, 224 and 256, one
// cluster of 4 CTAs a sample, each CTA F/4 channels of every gate (see
// convlstm_wgmma.cuh).  The entry points of convlstm_proj.cu hand these
// widths on; the instantiations sit apart so that nvcc builds them beside
// the 2-CTA ones.
//
// Replaces: mmvae_tpu/ops/convlstm_pallas.py::convlstm_scan_proj_pallas at
//   lstm_features 160-256 (the reference's lstm_features=192 probe,
//   docs/RESULTS.md:56).

#include "convlstm_launch.cuh"

namespace mmvae {

int proj_fwd_wide(const ProjFwdArgs& a) { return proj_fwd<bf16>(WideF{}, a); }
int proj_bwd_wide(const ProjBwdArgs& a) { return proj_bwd<bf16>(WideF{}, a); }

}  // namespace mmvae
