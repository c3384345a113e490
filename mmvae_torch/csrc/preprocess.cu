// Resident-batch gather + normalize / Bernoulli binarize: u8 rows -> frames.
//
// Replaces: mmvae_tpu/ops/preprocess_pallas.py::preprocess_pallas (_kernel)
//   and ::preprocess_packed_pallas (_packed_kernel).  Both compute one
//   function; the int32 chunk-planar packing of the second exists only for
//   the TPU's u8 row-gather cost (data/transforms.py:38-46), so here the
//   resident set stays a plain u8 tensor and the kernel reads
//   (dataset, row indices, seed) directly.  indices = arange(B) over a
//   streamed batch is preprocess_pallas.  The seed is a host value or the
//   train step's step seed read from device memory (philox.cuh `SeedArg`).
//
//   binarize:  out = 1 iff float(u24) < float(u8) * (2^24 / 255), u24 the 24
//              high bits of a Philox-4x32-10 word, i.e. P(on) = u8 / 255;
//   otherwise: out = float(u8) * (1 / 255).
//   Row indices outside [0, N) are clamped to it, so no index reads outside
//   the dataset.
//
// What bounds it on the H100: bytes.  At the main path's batch (64 clips of
// 20x64x64) it reads 5.2 MB of u8 and writes 10.5 MB of bf16: a few
// microseconds at 3.35 TB/s, so launch overhead and load width matter most.
// Design: each thread handles 16 consecutive output elements: one 16-byte
// load when rows are 16-byte multiples, 16-byte stores, and four Philox
// calls.  The Philox counter is the element's offset in the batch and the key
// the stream seed, so the bits do not depend on the launch shape.
#include "philox.cuh"

namespace mmvae {
namespace {

constexpr int EPT = 16;  // output elements per thread

__device__ __forceinline__ long long row_start(const int64_t* idx, long long b, long long n_rows,
                                               long long row_bytes) {
  const long long r = idx[b];
  return (r < 0 ? 0 : r >= n_rows ? n_rows - 1 : r) * row_bytes;
}

template <typename O, bool BIN, bool VEC>
__global__ void preprocess_gather_kernel(const uint8_t* __restrict__ data,
                                         const int64_t* __restrict__ idx, O* __restrict__ out,
                                         long long n_rows, long long row_bytes, long long total,
                                         SeedArg sa) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * EPT;
  if (e0 >= total) return;
  const bool full = e0 + EPT <= total;
  uint8_t px[EPT];
  if (VEC && full) {
    const long long b = e0 / row_bytes, j = e0 - b * row_bytes;
    const uint4 v = *reinterpret_cast<const uint4*>(data + row_start(idx, b, n_rows, row_bytes) + j);
    const uint8_t* pv = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int q = 0; q < EPT; ++q) px[q] = pv[q];
  } else {
#pragma unroll
    for (int q = 0; q < EPT; ++q) {
      const long long e = e0 + q;
      px[q] = 0;
      if (e < total) {
        const long long b = e / row_bytes;
        px[q] = data[row_start(idx, b, n_rows, row_bytes) + (e - b * row_bytes)];
      }
    }
  }
  float v[EPT];
  if (BIN) {
    const float scale = 16777216.0f / 255.0f;
    const uint32_t seed = seed_of(sa);
#pragma unroll
    for (int g = 0; g < EPT / 4; ++g) {
      const uint4 r = philox_draw((unsigned long long)(e0 / 4 + g), seed);
      const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float u24 = (float)(words[q] >> 8);
        v[4 * g + q] = u24 < (float)px[4 * g + q] * scale ? 1.f : 0.f;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < EPT; ++q) v[q] = (float)px[q] * (1.0f / 255.0f);
  }
  if (full) {
    __align__(16) O o[EPT];
#pragma unroll
    for (int q = 0; q < EPT; ++q) o[q] = from_f<O>(v[q]);
    uint4* dst = reinterpret_cast<uint4*>(out + e0);
    const uint4* src = reinterpret_cast<const uint4*>(o);
#pragma unroll
    for (int q = 0; q < (int)(EPT * sizeof(O) / 16); ++q) dst[q] = src[q];
  } else {
    for (int q = 0; q < EPT && e0 + q < total; ++q) out[e0 + q] = from_f<O>(v[q]);
  }
}

template <typename O>
cudaError_t launch(const void* data, const void* idx, void* out, long long n_rows,
                   long long row_bytes, long long batch, SeedArg seed, int binarize,
                   cudaStream_t stream) {
  const long long total = batch * row_bytes;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + (long long)threads * EPT - 1) / ((long long)threads * EPT);
  const bool vec = row_bytes % 16 == 0 && ((uintptr_t)data % 16) == 0;
  const uint8_t* d = (const uint8_t*)data;
  const int64_t* ix = (const int64_t*)idx;
  O* o = (O*)out;
#define MMVAE_LAUNCH(BIN, VEC) \
  preprocess_gather_kernel<O, BIN, VEC><<<(unsigned)blocks, threads, 0, stream>>>(d, ix, o, n_rows, row_bytes, total, seed)
  if (binarize) {
    if (vec) MMVAE_LAUNCH(true, true); else MMVAE_LAUNCH(true, false);
  } else {
    if (vec) MMVAE_LAUNCH(false, true); else MMVAE_LAUNCH(false, false);
  }
#undef MMVAE_LAUNCH
  return cudaGetLastError();
}

}  // namespace
}  // namespace mmvae

// seed_step: null (the stream seed is `seed_value`) or the int64 step seed on the
// device, from which the kernel takes stream `stream_id`'s seed under `salt`.
extern "C" int mmvae_preprocess_gather(const void* data, const void* idx, void* out,
                                       long long n_rows, long long row_bytes, long long batch,
                                       unsigned int seed_value, const void* seed_step,
                                       int stream_id, int salt, int binarize, int out_dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const mmvae::SeedArg seed{(const long long*)seed_step, seed_value, (uint32_t)stream_id,
                            (uint32_t)salt};
  if (out_dtype == mmvae::kF32)
    return (int)mmvae::launch<float>(data, idx, out, n_rows, row_bytes, batch, seed, binarize, s);
  if (out_dtype == mmvae::kBF16)
    return (int)mmvae::launch<__nv_bfloat16>(data, idx, out, n_rows, row_bytes, batch, seed, binarize, s);
  return (int)cudaErrorInvalidValue;
}
