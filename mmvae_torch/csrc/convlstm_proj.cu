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
// What bounds it on the H100: arithmetic and the serial time loop, not bytes.
// At the main path's shape (B=64, T=20, 8x8, C=F=128) the forward is 107
// GFLOP and the backward 215 GFLOP (dh recurrence 97, dW and dWx 107, dx 11),
// while the forward moves ~0.2 GB; the backward's f32 dgates scratch (168 MB)
// is written once and read once by each of the weight GEMM's 10 row blocks.
// The recurrence cannot be split across time, so the forward and the BPTT
// kernels run one CTA per sample for all T steps (64 CTAs on 132 SMs).
//
// Design (simple first versions; wgmma, TMA and batch blocking are later work).
// The kernels take bf16 activations with C and F multiples of 16, F <= 128 and
// H*W <= 64 (the wrapper checks), and either gate dtype.
// - forward: mma.sync m16n8k16 (bf16 operands, f32 accumulators), 2F threads
//   per CTA.  x_t and h live in swizzled bf16 shared-memory tiles and c in
//   f32 shared memory; the 3x3 conv is 9 row-shifted ldmatrix gathers, a
//   zero row standing in for the masked taps of _tap_masks; weights are
//   packed in fragment order by the wrapper and read from L2.  Each warp owns
//   16 channels of all four gates, so the gate math runs on its own
//   accumulators.  Residuals (hs, cs, post-activation gates) are written in
//   bf16, as the TPU kernel's are.
// - backward recurrence: reverse time, (dh, dc) carried in f32 registers;
//   dgates are written to a f32 scratch (B, T, HW, 4F), and dh_{t-1} is the
//   transposed 3x3 conv of dgates (rounded to bf16), on mma.sync from shared
//   memory.
// - weight gradients and dx from the scratch: dW and dWx are a GEMM over the
//   B*T*HW rows (wgrad_mma_kernel), reduced in a fixed order (split-K
//   partials summed in split order by a second kernel); dbx is column sums in
//   fixed chunks; dx is dgates @ Wx^T (dx_gemm_kernel, CUDA cores).  No
//   float atomics, so the results are deterministic.
// The tap gathers, mma fragments, cell math and weight-gradient GEMM are
// shared with the K6 kernels (convlstm_scan.cu) through convlstm_mma.cuh.

#include "convlstm_mma.cuh"

namespace mmvae {
namespace {

// ---------------------------------------------------------------------------
// dx = bf16(dgates) @ Wx^T on CUDA cores: out[m][c] = sum_n dG[m][n] * Wx[c][n],
// both operands contiguous in n (the K index).  64x64 tile, 256 threads, 4x4
// outputs per thread, f32 accumulation, bf16 output.
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(GEMM_THREADS) dx_gemm_kernel(
    const float* __restrict__ dG, const bf16* __restrict__ wx, bf16* __restrict__ dx,
    int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BK * BM; idx += GEMM_THREADS) {
      const int mm = idx / BK, kk = idx % BK, m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? round_to<bf16>(dG[(size_t)m * K + k]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += GEMM_THREADS) {
      const int nn = idx / BK, kk = idx % BK, n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? to_f(wx[(size_t)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + ty * TM + i, n = n0 + tx * TN + j;
      if (m < M && n < N) dx[(size_t)m * N + n] = from_f<bf16>(acc[i][j]);
    }
}

// Column sums of dG over a contiguous chunk of rows: partial[s][n].
__global__ void colsum_partial_kernel(const float* __restrict__ dG, float* __restrict__ part,
                                      int R, int N, int rows_per_split) {
  const int s = blockIdx.x;
  const int r0 = s * rows_per_split, r1 = min(R, r0 + rows_per_split);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) acc += dG[(size_t)r * N + n];
    part[(size_t)s * N + n] = acc;
  }
}

template <typename G, bool SAVE>
__global__ void __launch_bounds__(256, 1) proj_fwd_mma_kernel(
    const bf16* __restrict__ x,     // (B, Tn, HW, C)
    const uint2* __restrict__ wpk,  // [C + 9F rows of [Wx; W]] packed: [K/16][4F/8][32 lanes]
    const bf16* __restrict__ bx,    // (4F)
    const bf16* __restrict__ c0, const bf16* __restrict__ h0,  // (B, HW, F)
    bf16* __restrict__ out_h, bf16* __restrict__ out_c, bf16* __restrict__ out_g,
    int Tn, int H, int W, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = H * W, F4 = 4 * F, NB = F4 / 8;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x;
  const SwzTile xs = make_tile(reinterpret_cast<bf16*>(smem_raw), C);
  const SwzTile hsw = make_tile(xs.base + (size_t)(MROWS + 1) * C, F);
  float* csm = reinterpret_cast<float*>(hsw.base + (size_t)(MROWS + 1) * F);  // (MROWS, F)

  for (int i = tid; i < (MROWS + 1 - HW) * C; i += nthr) *xs.at(HW + i / C, i % C) = from_f<bf16>(0.f);
  for (int i = tid; i < (MROWS + 1 - HW) * F; i += nthr) *hsw.at(HW + i / F, i % F) = from_f<bf16>(0.f);
  for (int i = tid; i < HW * F; i += nthr) {
    csm[i] = round_to<G>(to_f(c0[b * HW * F + i]));
    *hsw.at(i / F, i % F) = from_f<bf16>(round_to<G>(to_f(h0[b * HW * F + i])));
  }
  const int cch = C / 8;
  for (int i = tid; i < HW * cch; i += nthr)
    *reinterpret_cast<uint4*>(xs.chunk(i / cch, i % cch)) =
        *reinterpret_cast<const uint4*>(x + (b * Tn * HW + i / cch) * C + (i % cch) * 8);

  int nbs[8];
  gate_tiles(nbs, warp, F);

  for (int t = 0; t < Tn; ++t) {
    __syncthreads();
    float acc[MT][8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nbs[nt] * 8 + 2 * tq;
      const float b0 = to_f(bx[col]), b1 = to_f(bx[col + 1]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][nt][0] = b0; acc[mt][nt][1] = b1; acc[mt][nt][2] = b0; acc[mt][nt][3] = b1;
      }
    }
    int xrows[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int p = mt * 16 + (lane & 15);
      xrows[mt] = p < HW ? p : MROWS;
    }
    mma_rows(acc, xs, xrows, wpk, 0, C / 16, nbs, NB, lane);
    hidden_conv_mma(acc, hsw, wpk, C / 16, nbs, NB, lane, H, W, F);

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + g + 8 * hr, ch = 16 * warp + 8 * hf + 2 * tq + e;
            const int k = hr * 2 + e;
            if (r >= HW) continue;
            const Cell cl = lstm_cell<G>(
                round_to<G>(acc[mt][0 + hf][k]), round_to<G>(acc[mt][2 + hf][k]),
                round_to<G>(acc[mt][4 + hf][k]), round_to<G>(acc[mt][6 + hf][k]),
                csm[r * F + ch]);
            csm[r * F + ch] = cl.c;
            acc[mt][0 + hf][k] = cl.h;
            if (SAVE) {
              const size_t o = (b * Tn + t) * HW + r;
              out_h[o * F + ch] = from_f<bf16>(cl.h);
              out_c[o * F + ch] = from_f<bf16>(cl.c);
              out_g[o * F4 + ch] = from_f<bf16>(cl.i);
              out_g[o * F4 + F + ch] = from_f<bf16>(cl.f);
              out_g[o * F4 + 2 * F + ch] = from_f<bf16>(cl.g);
              out_g[o * F4 + 3 * F + ch] = from_f<bf16>(cl.o);
            } else if (t == Tn - 1) {
              out_h[(b * HW + r) * F + ch] = from_f<bf16>(cl.h);
              out_c[(b * HW + r) * F + ch] = from_f<bf16>(cl.c);
            }
          }
    __syncthreads();  // every warp is done reading xs / hsw for step t
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = mt * 16 + g + 8 * hr, ch = 16 * warp + 8 * hf + 2 * tq + e;
            if (r < HW) *hsw.at(r, ch) = from_f<bf16>(acc[mt][0 + hf][hr * 2 + e]);
          }
    if (t + 1 < Tn)
      for (int i = tid; i < HW * cch; i += nthr)
        *reinterpret_cast<uint4*>(xs.chunk(i / cch, i % cch)) = *reinterpret_cast<const uint4*>(
            x + ((b * Tn + t + 1) * HW + i / cch) * C + (i % cch) * 8);
  }
}

__global__ void __launch_bounds__(256, 1) proj_bwd_mma_kernel(
    const uint2* __restrict__ wtpk,  // W^T rows (tap, n) packed: [9*4F/16][F/8][32 lanes]
    const bf16* __restrict__ c0, const bf16* __restrict__ cs, const bf16* __restrict__ ga,
    const bf16* __restrict__ dhl, const bf16* __restrict__ dcl,
    float* __restrict__ dG, bf16* __restrict__ dc0, bf16* __restrict__ dh0,
    int Tn, int H, int W, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HW = H * W, F4 = 4 * F;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x;
  const SwzTile dgs = make_tile(reinterpret_cast<bf16*>(smem_raw), F4);  // (MROWS + 1, 4F)
  for (int i = tid; i < (MROWS + 1 - HW) * F4; i += nthr) *dgs.at(HW + i / F4, i % F4) = from_f<bf16>(0.f);

  // acc = dh and dc, in the mma output layout: rows mt*16 + g + 8*hr,
  // channels 16*warp + 8*nt + 2*tq + e, slot hr*2 + e.
  float acc[MT][2][4], dc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
        acc[mt][nt][k] = r < HW ? to_f(dhl[(b * HW + r) * F + ch]) : 0.f;
        dc[mt][nt][k] = r < HW ? to_f(dcl[(b * HW + r) * F + ch]) : 0.f;
      }

  for (int t = Tn - 1; t >= 0; --t) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
          if (r >= HW) continue;
          const size_t o = (b * Tn + t) * HW + r;
          const float ct = to_f(cs[o * F + ch]);
          const float cp = t > 0 ? to_f(cs[(o - HW) * F + ch]) : to_f(c0[(b * HW + r) * F + ch]);
          const float ai = to_f(ga[o * F4 + ch]);
          const float af = to_f(ga[o * F4 + F + ch]);
          const float ag = to_f(ga[o * F4 + 2 * F + ch]);
          const float ao = to_f(ga[o * F4 + 3 * F + ch]);
          float gq[4];
          dc[mt][nt][k] = lstm_cell_bwd(acc[mt][nt][k], dc[mt][nt][k], ct, cp, ai, af, ag, ao, gq);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dG[o * F4 + q * F + ch] = gq[q];
            *dgs.at(r, q * F + ch) = from_f<bf16>(gq[q]);
          }
        }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
    hidden_conv_t_mma(acc, dgs, wtpk, warp, lane, H, W, F);
    __syncthreads();  // every warp is done reading dgs for step t
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = mt * 16 + g + 8 * (k >> 1), ch = 16 * warp + 8 * nt + 2 * tq + (k & 1);
        if (r >= HW) continue;
        dh0[(b * HW + r) * F + ch] = from_f<bf16>(acc[mt][nt][k]);
        dc0[(b * HW + r) * F + ch] = from_f<bf16>(dc[mt][nt][k]);
      }
}

size_t fwd_smem(int C, int F) {
  return (size_t)(MROWS + 1) * (C + F) * sizeof(bf16) + (size_t)MROWS * F * sizeof(float);
}
size_t bwd_smem(int F) { return (size_t)(MROWS + 1) * 4 * F * sizeof(bf16); }

template <typename G, bool SAVE>
cudaError_t launch_fwd(const void* x, const void* wpk, const void* bx, const void* c0,
                           const void* h0, void* oh, void* oc, void* og, int B, int Tn, int H,
                           int W, int C, int F, cudaStream_t stream) {
  auto kern = proj_fwd_mma_kernel<G, SAVE>;
  const size_t smem = fwd_smem(C, F);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, 2 * F, smem, stream>>>((const bf16*)x, (const uint2*)wpk, (const bf16*)bx,
                                   (const bf16*)c0, (const bf16*)h0, (bf16*)oh, (bf16*)oc,
                                   (bf16*)og, Tn, H, W, C, F);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const void* x, const void* hs, const void* h0, const float* dG,
                         const void* wx, float* dw_part, float* dw_out, float* db_part,
                         float* db_out, void* dx, int B, int Tn, int H, int W, int C, int F,
                         int splits, int bsplits, cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F;
  // dW and dWx: (C + 9F) x 4F.
  launch_weight_grad(x, hs, h0, dG, dw_part, dw_out, B, Tn, H, W, C, F, splits, stream);
  // dbx: column sums of the f32 dgates.
  const int rps = (R + bsplits - 1) / bsplits;
  colsum_partial_kernel<<<bsplits, 256, 0, stream>>>(dG, db_part, R, F4, rps);
  reduce_splits_kernel<<<(F4 + 255) / 256, 256, 0, stream>>>(db_part, db_out, bsplits, F4);
  // dx = dgates @ Wx^T  (R x C)
  dim3 grid_x((R + BM - 1) / BM, (C + BN - 1) / BN, 1);
  dx_gemm_kernel<<<grid_x, GEMM_THREADS, 0, stream>>>(dG, (const bf16*)wx, (bf16*)dx, R, C, F4);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const void* wtpk, const void* c0, const void* cs, const void* ga,
                           const void* dhl, const void* dcl, float* dG, void* dc0, void* dh0,
                           int B, int Tn, int H, int W, int F, cudaStream_t stream) {
  auto kern = proj_bwd_mma_kernel;
  const size_t smem = bwd_smem(F);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, 2 * F, smem, stream>>>((const uint2*)wtpk, (const bf16*)c0, (const bf16*)cs,
                                   (const bf16*)ga, (const bf16*)dhl, (const bf16*)dcl, dG,
                                   (bf16*)dc0, (bf16*)dh0, Tn, H, W, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvae

using namespace mmvae;

extern "C" {

// Weights pre-packed in mma fragment order by the wrapper.
int mmvae_convlstm_proj_fwd(const void* x, const void* wpk, const void* bx, const void* c0,
                            const void* h0, void* out_h, void* out_c, void* out_g, int B,
                            int Tn, int H, int W, int C, int F, int gate_dtype, int save,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MMVAE_FWD(GG)                                                                        \
  return save ? (int)launch_fwd<GG, true>(x, wpk, bx, c0, h0, out_h, out_c, out_g, B, Tn, H, \
                                          W, C, F, s)                                        \
              : (int)launch_fwd<GG, false>(x, wpk, bx, c0, h0, out_h, out_c, out_g, B, Tn,  \
                                           H, W, C, F, s)
  if (gate_dtype == kF32) MMVAE_FWD(float);
  if (gate_dtype == kBF16) MMVAE_FWD(__nv_bfloat16);
#undef MMVAE_FWD
  return (int)cudaErrorInvalidValue;
}

int mmvae_convlstm_proj_bwd(const void* wtpk, const void* c0, const void* cs, const void* ga,
                            const void* dhl, const void* dcl, void* dG, void* dc0, void* dh0,
                            int B, int Tn, int H, int W, int F, void* stream) {
  return (int)launch_bwd(wtpk, c0, cs, ga, dhl, dcl, (float*)dG, dc0, dh0, B, Tn, H, W, F,
                         (cudaStream_t)stream);
}

int mmvae_convlstm_proj_wgrad(const void* x, const void* hs, const void* h0, const void* dG,
                              const void* wx, void* dw_part, void* dw_out, void* db_part,
                              void* db_out, void* dx, int B, int Tn, int H, int W, int C, int F,
                              int splits, int bsplits, void* stream) {
  return (int)launch_wgrad(x, hs, h0, (const float*)dG, wx, (float*)dw_part, (float*)dw_out,
                           (float*)db_part, (float*)db_out, dx, B, Tn, H, W, C, F, splits,
                           bsplits, (cudaStream_t)stream);
}

// Dynamic shared memory the kernels need; the wrapper checks it.
long long mmvae_convlstm_proj_smem(int C, int F) {
  const size_t a = fwd_smem(C, F), b = bwd_smem(F);
  return (long long)(a > b ? a : b);
}

}  // extern "C"
