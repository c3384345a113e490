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

#include "common.cuh"

namespace mmvae {
namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

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

// out[i] = sum_s part[s][i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * MN + i];
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// The recurrences on tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate).
// A operands come from shared memory through ldmatrix, whose per-lane row
// addresses do the 3x3 tap gather (a zero row for masked taps); B operands
// (weights) are pre-packed on the host in mma fragment order and read from
// L2 with one coalesced 8-byte load per lane, so the K loop needs no
// barriers.  Warp w owns channels [16w, 16w + 16) of all four gates, so a
// thread's accumulators hold i, f, g, o of the same (position, channel)
// pairs and the gate math runs on them in place.
// ---------------------------------------------------------------------------
constexpr int MT = 4;            // m16 tiles: up to 64 positions
constexpr int MROWS = MT * 16;   // row MROWS of each operand tile is all zero

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Row-major bf16 tile in shared memory; 16-byte chunks are XOR-swizzled by
// row (when a row holds a multiple of 8 chunks) so ldmatrix is conflict-free.
struct SwzTile {
  bf16* base;
  int chunks, mask;
  __device__ bf16* at(int row, int col) const {
    return base + ((size_t)row * chunks + ((col >> 3) ^ (row & mask))) * 8 + (col & 7);
  }
  __device__ bf16* chunk(int row, int c) const {
    return base + ((size_t)row * chunks + (c ^ (row & mask))) * 8;
  }
};

__device__ __forceinline__ SwzTile make_tile(bf16* base, int cols) {
  const int chunks = cols / 8;
  return SwzTile{base, chunks, chunks % 8 == 0 ? 7 : 0};
}

// Source row of position p for tap `tap` (sign +1: h[p + shift], the forward;
// -1: dg[p - shift], the transposed conv), or MROWS when outside the image.
__device__ __forceinline__ int tap_row(int p, int tap, int sign, int H, int W, int HW) {
  if (p >= HW) return MROWS;
  const int yy = p / W + sign * (tap / 3 - 1), xx = p % W + sign * (tap % 3 - 1);
  return (yy >= 0 && yy < H && xx >= 0 && xx < W) ? yy * W + xx : MROWS;
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

  int nbs[8];  // n8 tiles of this warp: gate q = nt / 2, half nt % 2
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) nbs[nt] = ((nt >> 1) * F + 16 * warp) / 8 + (nt & 1);

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
    int kb = 0;
    for (int seg = 0; seg < 10; ++seg) {
      const SwzTile& A = seg == 0 ? xs : hsw;
      const int ksteps = (seg == 0 ? C : F) / 16;
      int rows[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int p = mt * 16 + (lane & 15);
        rows[mt] = seg == 0 ? (p < HW ? p : MROWS) : tap_row(p, seg - 1, 1, H, W, HW);
      }
      for (int kk = 0; kk < ksteps; ++kk) {
        uint2 bf[8];
        const uint2* src = wpk + (size_t)(kb + kk) * NB * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) bf[nt] = src[nbs[nt] * 32];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, A.chunk(rows[mt], kk * 2 + (lane >> 4)));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) mma16816(acc[mt][nt], a, bf[nt]);
        }
      }
      kb += ksteps;
    }

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
            const float ai = round_to<G>(sigm(round_to<G>(acc[mt][0 + hf][k])));
            const float af = round_to<G>(sigm(round_to<G>(round_to<G>(acc[mt][2 + hf][k]) + 1.f)));
            const float ag = round_to<G>(tanhf(round_to<G>(acc[mt][4 + hf][k])));
            const float ao = round_to<G>(sigm(round_to<G>(acc[mt][6 + hf][k])));
            const float cn = round_to<G>(round_to<G>(af * csm[r * F + ch]) + round_to<G>(ai * ag));
            const float hv = round_to<G>(ao * round_to<G>(tanhf(cn)));
            csm[r * F + ch] = cn;
            acc[mt][0 + hf][k] = hv;
            if (SAVE) {
              const size_t o = (b * Tn + t) * HW + r;
              out_h[o * F + ch] = from_f<bf16>(hv);
              out_c[o * F + ch] = from_f<bf16>(cn);
              out_g[o * F4 + ch] = from_f<bf16>(ai);
              out_g[o * F4 + F + ch] = from_f<bf16>(af);
              out_g[o * F4 + 2 * F + ch] = from_f<bf16>(ag);
              out_g[o * F4 + 3 * F + ch] = from_f<bf16>(ao);
            } else if (t == Tn - 1) {
              out_h[(b * HW + r) * F + ch] = from_f<bf16>(hv);
              out_c[(b * HW + r) * F + ch] = from_f<bf16>(cn);
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
  const int HW = H * W, F4 = 4 * F, NB = F / 8;
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
          const float dh = acc[mt][nt][k];
          const float th = tanhf(ct);
          const float d_o = dh * th;
          const float dct = dc[mt][nt][k] + dh * ao * (1.f - th * th);
          dc[mt][nt][k] = dct * af;
          const float gq[4] = {dct * ag * ai * (1.f - ai), dct * cp * af * (1.f - af),
                               dct * ai * (1.f - ag * ag), d_o * ao * (1.f - ao)};
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
    for (int tap = 0; tap < 9; ++tap) {
      int rows[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) rows[mt] = tap_row(mt * 16 + (lane & 15), tap, -1, H, W, HW);
      for (int kk = 0; kk < F4 / 16; ++kk) {
        const uint2* src = wtpk + ((size_t)(tap * F4 / 16 + kk) * NB + 2 * warp) * 32 + lane;
        const uint2 bf[2] = {src[0], src[32]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, dgs.chunk(rows[mt], kk * 2 + (lane >> 4)));
          mma16816(acc[mt][0], a, bf[0]);
          mma16816(acc[mt][1], a, bf[1]);
        }
      }
    }
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

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// dW / dWx on tensor cores (bf16 operands, f32 accumulate):
//   part[z][m][n] = sum over rows r of split z of A(m, r) * bf16(dG[r][n])
// with A(m, r) row m of [Wx; W]'s input: x_t[p][m] (m < C), else h_{t-1} at
// the shift of tap (m - C) / F.  Both
// operands are staged row-major in r ([r][m] and [r][n], 16-byte chunks
// swizzled) and read with ldmatrix.trans.  CTA tile 128 x 128, 8 warps of
// 64 x 32, 32 rows of r per stage.
constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 32;

__global__ void __launch_bounds__(256) wgrad_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ hs, const bf16* __restrict__ h0,
    const float* __restrict__ dG, float* __restrict__ part, int Tn, int H, int W, int C,
    int F, int R, int rows_per_split) {
  __shared__ __align__(16) bf16 a_raw[WG_BK * WG_BM];
  __shared__ __align__(16) bf16 b_raw[WG_BK * WG_BN];
  const SwzTile As{a_raw, WG_BM / 8, 7}, Bs{b_raw, WG_BN / 8, 7};
  const int HW = H * W, F4 = 4 * F, M = C + 9 * F;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int r_begin = blockIdx.z * rows_per_split, r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, wm = warp >> 2, wn = warp & 3;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  for (int k0 = r_begin; k0 < r_end; k0 += WG_BK) {
    for (int i = tid; i < WG_BK * (WG_BM / 8); i += 256) {
      const int kr = i / (WG_BM / 8), mc = i % (WG_BM / 8);
      const int r = k0 + kr, m = m0 + mc * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end && m < M) {
        if (m < C) {
          v = *reinterpret_cast<const uint4*>(x + (size_t)r * C + m);
        } else {
          const int q = m - C, tap = q / F, f = q - tap * F;
          const int bt = r / HW, p = r - bt * HW, t = bt % Tn, b = bt / Tn;
          const int yy = p / W + tap / 3 - 1, xx = p % W + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int src = yy * W + xx;
            const bf16* hp = t > 0 ? hs + ((size_t)(bt - 1) * HW + src) * F + f
                                   : h0 + ((size_t)b * HW + src) * F + f;
            v = *reinterpret_cast<const uint4*>(hp);
          }
        }
      }
      *reinterpret_cast<uint4*>(As.chunk(kr, mc)) = v;
    }
    for (int i = tid; i < WG_BK * (WG_BN / 8); i += 256) {
      const int kr = i / (WG_BN / 8), nc = i % (WG_BN / 8);
      const int r = k0 + kr, n = n0 + nc * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end && n < F4) {
        const float4 lo = *reinterpret_cast<const float4*>(dG + (size_t)r * F4 + n);
        const float4 hi = *reinterpret_cast<const float4*>(dG + (size_t)r * F4 + n + 4);
        __nv_bfloat162 pk[4] = {__floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
                                __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
        v = *reinterpret_cast<const uint4*>(pk);
      }
      *reinterpret_cast<uint4*>(Bs.chunk(kr, nc)) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WG_BK; kk += 16) {
      uint32_t a[4][4], bq[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(a[mt], As.chunk(kk + (lane >> 4) * 8 + (lane & 7),
                                  (wm * 64 + mt * 16 + ((lane >> 3) & 1) * 8) / 8));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4_t(bq[np], Bs.chunk(kk + ((lane >> 3) & 1) * 8 + (lane & 7),
                                   (wn * 32 + np * 16 + (lane >> 4) * 8) / 8));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], a[mt],
                   make_uint2(bq[nt >> 1][(nt & 1) * 2], bq[nt >> 1][(nt & 1) * 2 + 1]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * 64 + mt * 16 + g + 8 * hr;
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
        if (m < M && n < F4)
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + m) * F4 + n) =
              make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
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
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  // dW and dWx: M x 4F, reduced over R rows in `splits` fixed chunks.
  const int kchunk = ((R + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK;
  dim3 grid((M + WG_BM - 1) / WG_BM, (F4 + WG_BN - 1) / WG_BN, splits);
  wgrad_mma_kernel<<<grid, 256, 0, stream>>>((const bf16*)x, (const bf16*)hs, (const bf16*)h0,
                                             dG, dw_part, Tn, H, W, C, F, R, kchunk);
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(dw_part, dw_out, splits, M * F4);
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
