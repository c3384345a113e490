// Small device pieces the ConvLSTM kernels (K5 and K6, convlstm_wgmma.cuh)
// share: swizzled shared-memory tiles and the ldmatrix that reads them
// transposed, the source row of each tap of the 3x3 SAME conv (a zero row
// stands in for the masked taps of convlstm_pallas.py::_tap_masks), the LSTM
// cell's result, and the split-order sum of the weight GEMM's partials.
#pragma once

#include "common.cuh"

namespace mmvae {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int MROWS = 64;  // positions a tile holds; row MROWS of an operand tile is all zero

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// Row-major tile of T (bf16 or f32) in shared memory; its 16-byte chunks
// (E = 16 / sizeof(T) elements) are XOR-swizzled by row (when a row holds a
// multiple of 8 chunks) so that ldmatrix (bf16) and the f32 fragment loads
// are conflict-free.
template <typename T>
struct SwzTileT {
  static constexpr int E = 16 / sizeof(T);
  T* base;
  int chunks, mask;
  __device__ T* at(int row, int col) const {
    return base + ((size_t)row * chunks + ((col / E) ^ (row & mask))) * E + (col % E);
  }
  __device__ T* chunk(int row, int c) const {
    return base + ((size_t)row * chunks + (c ^ (row & mask))) * E;
  }
};
using SwzTile = SwzTileT<bf16>;

template <typename T>
__device__ __forceinline__ SwzTileT<T> make_tile(T* base, int cols) {
  const int chunks = cols / SwzTileT<T>::E;
  return SwzTileT<T>{base, chunks, chunks % 8 == 0 ? 7 : 0};
}

// Source row of position p for tap `tap` (sign +1: h[p + shift], the forward;
// -1: dg[p - shift], the transposed conv), or MROWS when outside the image.
__device__ __forceinline__ int tap_row(int p, int tap, int sign, int H, int W, int HW) {
  if (p >= HW) return MROWS;
  const int yy = p / W + sign * (tap / 3 - 1), xx = p % W + sign * (tap % 3 - 1);
  return (yy >= 0 && yy < H && xx >= 0 && xx < W) ? yy * W + xx : MROWS;
}

// One LSTM cell step: the post-activation gates, the new cell state and h.
struct Cell {
  float i, f, g, o, c, h;
};

// out[i] = sum_s part[s][i], in split order.
__global__ void reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int S, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * MN + i];
  out[i] = acc;
}

}  // namespace
}  // namespace mmvae
