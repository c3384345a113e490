// Device code of the K6 recurrence (convlstm_scan.cu): mma.sync m16n8k16
// fragments (bf16 in, f32 accumulate), swizzled bf16 shared-memory tiles,
// the 3x3 SAME conv of h as 9 row-shifted ldmatrix gathers (a zero row
// stands in for the masked taps of convlstm_pallas.py::_tap_masks), the LSTM
// cell forward rounded in the gate dtype and its f32 backward, and the
// deterministic tensor-core weight gradient.  K5's Hopper kernels
// (convlstm_wgmma.cuh) share the tiles, the tap rows, the cell types and the
// split-order reduction.
//
// Layout of K6's kernels: one CTA per sample, 2F threads; warp w
// owns channels [16w, 16w + 16) of all four gates, so a thread's
// accumulators acc[mt][nt][k] hold i, f, g, o (n8 tiles 2q, 2q + 1) of the
// same (position, channel) pairs: position mt*16 + g + 8*(k >> 1), channel
// 16w + 8*(nt & 1) + 2*tq + (k & 1), with g = lane / 4, tq = lane % 4.
#pragma once

#include "common.cuh"

namespace mmvae {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int MT = 4;            // m16 tiles: up to 64 positions
constexpr int MROWS = MT * 16;   // row MROWS of each operand tile is all zero

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// The n8 weight tiles of warp w: gate q = nt / 2, half nt % 2.
__device__ __forceinline__ void gate_tiles(int (&nbs)[8], int warp, int F) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) nbs[nt] = ((nt >> 1) * F + 16 * warp) / 8 + (nt & 1);
}

// acc += A[rows] @ Wpk[kb .. kb + ksteps) for the warp's 8 n8 tiles.  Weights
// are packed in fragment order, [K/16][4F/8][32 lanes], and read from L2 with
// one coalesced 8-byte load per lane, so the K loop needs no barriers.
__device__ __forceinline__ void mma_rows(float (&acc)[MT][8][4], const SwzTile& A,
                                         const int (&rows)[MT], const uint2* __restrict__ wpk,
                                         int kb, int ksteps, const int (&nbs)[8], int NB,
                                         int lane) {
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
}

// acc += conv3x3_SAME(h, W): the 9 taps, in order, each a row-shifted gather
// of the h tile against W's rows [kb + tap*F/16, ...) of the packed weights.
__device__ __forceinline__ void hidden_conv_mma(float (&acc)[MT][8][4], const SwzTile& hsw,
                                                const uint2* __restrict__ wpk, int kb,
                                                const int (&nbs)[8], int NB, int lane, int H,
                                                int W, int F) {
  const int HW = H * W;
  for (int tap = 0; tap < 9; ++tap) {
    int rows[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) rows[mt] = tap_row(mt * 16 + (lane & 15), tap, 1, H, W, HW);
    mma_rows(acc, hsw, rows, wpk, kb + tap * (F / 16), F / 16, nbs, NB, lane);
  }
}

// acc = dh_{t-1} = the transposed 3x3 conv of the bf16 dgates tile: W^T rows
// (tap, n) packed [9*4F/16][F/8][32 lanes]; warp w owns channels 16w..16w+15.
__device__ __forceinline__ void hidden_conv_t_mma(float (&acc)[MT][2][4], const SwzTile& dgs,
                                                  const uint2* __restrict__ wtpk, int warp,
                                                  int lane, int H, int W, int F) {
  const int HW = H * W, F4 = 4 * F, NB = F / 8;
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
}

struct Cell {
  float i, f, g, o, c, h;
};

// One LSTM cell step from pre-activations already rounded to G: every
// operation rounded to the gate dtype G as torch's ops in G round.
template <typename G>
__device__ __forceinline__ Cell lstm_cell(float pi, float pf, float pg, float po, float c) {
  Cell r;
  r.i = round_to<G>(sigm(pi));
  r.f = round_to<G>(sigm(round_to<G>(pf + 1.f)));
  r.g = round_to<G>(tanhf(pg));
  r.o = round_to<G>(sigm(po));
  r.c = round_to<G>(round_to<G>(r.f * c) + round_to<G>(r.i * r.g));
  r.h = round_to<G>(r.o * round_to<G>(tanhf(r.c)));
  return r;
}

// Its backward in f32 from the saved post-activation gates: dgates (i, f, g,
// o pre-activation) into gq, returns dc_{t-1}.
__device__ __forceinline__ float lstm_cell_bwd(float dh, float dc, float ct, float cp, float ai,
                                               float af, float ag, float ao, float (&gq)[4]) {
  const float th = tanhf(ct);
  const float d_o = dh * th;
  const float dct = dc + dh * ao * (1.f - th * th);
  gq[0] = dct * ag * ai * (1.f - ai);
  gq[1] = dct * cp * af * (1.f - af);
  gq[2] = dct * ai * (1.f - ag * ag);
  gq[3] = d_o * ao * (1.f - ao);
  return dct * af;
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

// Weight gradients on tensor cores (bf16 operands, f32 accumulate):
//   part[z][m][n] = sum over rows r of split z of A(m, r) * bf16(dG[r][n])
// with A(m, r) row m of [Wx; W]'s input: x_t[p][m] (m < C), else h_{t-1} at
// the shift of tap (m - C) / F.  C = 0 gives the hidden kernel's gradient
// alone (K6).  Both operands are staged row-major in r ([r][m] and [r][n],
// 16-byte chunks swizzled) and read with ldmatrix.trans.  CTA tile 128 x 128,
// 8 warps of 64 x 32, 32 rows of r per stage.
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

// dW (M x 4F, M = C + 9F) reduced over the R = B*T*HW rows in `splits` fixed
// chunks, then summed in split order: deterministic, no float atomics.
__host__ inline void launch_weight_grad(const void* x, const void* hs, const void* h0,
                                        const float* dG, float* part, float* out, int B, int Tn,
                                        int H, int W, int C, int F, int splits,
                                        cudaStream_t stream) {
  const int R = B * Tn * H * W, F4 = 4 * F, M = C + 9 * F;
  const int kchunk = ((R + splits - 1) / splits + WG_BK - 1) / WG_BK * WG_BK;
  dim3 grid((M + WG_BM - 1) / WG_BM, (F4 + WG_BN - 1) / WG_BN, splits);
  wgrad_mma_kernel<<<grid, 256, 0, stream>>>((const bf16*)x, (const bf16*)hs, (const bf16*)h0,
                                             dG, part, Tn, H, W, C, F, R, kchunk);
  reduce_splits_kernel<<<(M * F4 + 255) / 256, 256, 0, stream>>>(part, out, splits, M * F4);
}

}  // namespace
}  // namespace mmvae
