// Philox-4x32-10 (Salmon et al., SC'11), the counter-based generator of the
// kernels that draw random bits: the preprocess kernel's Bernoulli bits and
// the Gaussian head's eps.  A draw is a pure function of (counter, key), so
// the bits do not depend on the launch shape.
#pragma once

#include "common.cuh"

namespace mmvae {
namespace {

// Second key word of every draw; the first is the stream seed (ops/seeds.py).
constexpr uint32_t kPhiloxKeyHi = 0x6D6D7661u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// A draw's stream seed: `value`, or where `step` is set, ops/seeds.py's
// stream_seed(*step, stream, salt) of the int64 step seed it points at.  A
// seed read from device memory lets a CUDA graph's replays draw each step's
// own bits (the train step keeps its step seed on the card).
struct SeedArg {
  const long long* step;
  uint32_t value, stream, salt;
};

__device__ __forceinline__ uint32_t seed_of(const SeedArg& a) {
  if (a.step == nullptr) return a.value;
  const uint32_t s = (uint32_t)(*a.step) + a.salt * 1000003u;
  return (s & 0x07FFFFFFu) | (a.stream << 27);
}

// The four words for 64-bit counter `c` under stream seed `seed`.
__device__ __forceinline__ uint4 philox_draw(unsigned long long c, uint32_t seed) {
  return philox4x32_10(make_uint4((uint32_t)c, (uint32_t)(c >> 32), 0u, 0u),
                       make_uint2(seed, kPhiloxKeyHi));
}

}  // namespace
}  // namespace mmvae
