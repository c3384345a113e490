// The Gaussian head and its sample: (mu, logvar, z) from the flattened
// encoder state x, as one forward kernel and one backward kernel.
//
// Replaces: the head of mmvae_tpu/models/base.py::GaussianHead (x cast to
//   f32, Dense(mu) and Dense(logvar) in f32) followed by
//   mmvae_tpu/ops/elbo_pallas.py::reparameterize_pallas (`_reparam_kernel`,
//   z = mu + exp(logvar / 2) eps) and its VJP (`_reparam_bwd`).  The TPU
//   left the two products to XLA; here they run in the same kernel as the
//   sample, so the head is one launch forward and one backward.
//
//   forward:  mu = x W_mu^T + b_mu,  logvar = x W_lv^T + b_lv   (f32)
//             z = mu + exp(logvar / 2) eps,  and the residual z - mu
//   backward: dmu = g_mu + g_z,  dlv = g_lv + g_z (z - mu) / 2
//             dx = dmu W_mu + dlv W_lv (x's dtype, f32 sums rounded once)
//             dW_mu = dmu^T x,  dW_lv = dlv^T x,  db = sums of dmu, dlv over the batch
//
//   x is (M, K) in bf16 or f32, the weights (N, K) f32 (nn.Linear's layout),
//   every other tensor (M, N) or (N,) f32.  eps comes from Philox-4x32-10
//   (philox.cuh) keyed by the stream seed, counter = the element's offset in
//   (M, N), through Box-Muller on 24-bit uniforms as the TPU kernel draws
//   (`_box_muller`); an eps tensor, where given, replaces the draw.  The
//   stream seed is a host value or derived from the train step's step seed
//   read from device memory (philox.cuh `SeedArg`).
//
// What bounds it on the H100: bytes.  The products run on the tensor cores
// as split TF32: each f32 operand v is split into a TF32 hi part and a TF32
// lo part (v = hi + lo to about 2^-22 |v|, hopper.cuh tf32_split), and a
// product a b is summed as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) in f32,
// which misses only lo lo, about 2^-22 of |a b|: f32-accurate, as the f32
// K5 and K6 compute (a 1xTF32 product, 2^-11, fails the kernels' check).  A
// bf16 x has 8 bits of significand against TF32's 11, so it is exact in
// TF32: its lo part is zero and the forward and dW run two passes, not
// three (the card tests hold them bit-identical to the f32 kernels' three
// passes on the same x cast to f32).  Counted at the passes it runs (494.7
// TFLOP/s of TF32 over two or three), the flagship head (M = 64, K = 8192,
// N = 128, bf16 x) forward is 268 MFLOP, 1.1 us, over 9.6 MB (8.4 MB of
// weights), 2.9 us; the backward twice the products (dW two passes, dx
// three), 2.7 us, over 19 MB, 5.7 us.
//
// Instructions.  The forward runs mma.sync m16n8k8 TF32: its x (M, K) and
// W (N, K) are both K-major, each warp gathers its fragments from the ring
// with plain shared loads, and the forward is bound by its loads and its
// cross-CTA sum, not by its products (bench/head_phases.py prints where a
// launch's time goes).  The backward runs wgmma m64nNk8 TF32, A from
// registers, B K-major from shared memory: on mma.sync its two products
// left it no faster than the FFMA kernel it replaces (mma.sync reaches a
// fraction of the card's TF32 rate on Hopper; wgmma reaches all of it).
// wgmma TF32 takes B only K-major, so the backward computes dx^T = W^T D^T
// (A: W^T gathered from the W tile in registers, B: D's cores, K-major in
// the weight rows) and dW = D^T x (A: D^T from D's cores, B: x^T's cores,
// K-major in the batch).  The tensor cores' own
// sums truncate, so a sum over more than a few dozen k steps runs in slabs
// added into f32 registers with IEEE adds (as the f32 K5 and K6 do): each
// warp's two k8 steps of a forward chunk, dW's 8 k steps of a batch block.
//
// Design, forward: split-K.  Each CTA owns 64 rows of x, 8 latent columns
// of BOTH W_mu and W_lv (16 weight rows), so that mu_j and logvar_j meet in
// one epilogue, and one of up to 8 slices of K (128 CTAs at the flagship
// head, one an SM).  It streams its slice through a ring of 128-wide K
// chunks (8 slots with bf16 x, 5 with f32: the flagship head's whole slice
// is in flight at once) by 16-byte cp.async from every thread.  Each of
// its 8 warps takes 16 columns of a chunk (two k8 steps) for the whole 64 x
// 16 tile: 4 x 2 mma tiles from 16 x fragments and 4 weight fragments a k8
// step.  The warps' partials are summed through shared memory in warp
// order, each CTA's go to a global scratch, and the CTA that finishes last
// (an integer ticket a tile) sums them in rank order and writes bias, eps
// and the four outputs: no float atomics, the same bits on every call.
// (The 8 slices of a tile as one thread-block cluster, summed through
// distributed shared memory, ran 0.0259 ms against 0.0154 for the same
// kernel launched without the cluster and without its sum: the clusters'
// placement cost it, not the sum, on an H100 SXM at 700 W.)
//
// Design, backward: tiles of (64 columns of K) x (a block of lb latent
// columns: lb rows of W_mu and lb of W_lv), so no CTA holds more than 256
// weight rows, whatever N: lb is the latent width rounded up to a power of
// two, at least 8 and at most 128 (the flagship head: 128 K tiles x 1
// block).  Each CTA keeps its W tile in shared memory (cp.async) and runs
// the batch in blocks of 64 rows: it forms D = [dmu | dlv] of its latent
// columns from the cotangents (coalesced loads, through a staging tile a
// warp so that the cores' stores fall on 32 banks), each element split
// into its TF32 parts once, and x^T's cores; then dW[weight rows, tile] +=
// D^T x over the block (the sum over the batch carried in registers from
// block to block), and dx^T[tile, block rows] = W^T D^T over its 2 lb
// weight rows, each warpgroup over half of them, the halves added through
// shared memory.  With one latent block dx is written there; with
// several, each CTA writes its partial dx to a global scratch and the last
// CTA of the K tile (an integer ticket) sums them in block order.  db sums
// D's columns over the batch in the first K tile's CTAs, each thread over
// fixed rows of one column, the warps' sums then added in warp order.
// Every sum runs in a fixed order.
//
// Shapes: any M, K and N.  16-byte copies need K * the element size a
// multiple of 16 bytes and 16-byte aligned tensors; other shapes load their
// tiles with plain loads (the same arithmetic).
#include <type_traits>

#include "hopper.cuh"
#include "philox.cuh"

namespace mmvae {

#ifdef HEAD_PHASE_TIMES
// Where a launch's time goes (bench/head_phases.py builds with this): the
// global timer (ns) at the end of each phase, in thread 0 of the first CTA
// and of the last CTA along x: [forward, backward][first, last][phase].
__device__ unsigned long long head_phase_t[2][2][16];
#define HEAD_PHASE(kernel, i)                                                                   \
  do {                                                                                          \
    if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) &&                 \
        blockIdx.y == 0 && blockIdx.z == 0) {                                                   \
      unsigned long long t_;                                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                                    \
      head_phase_t[kernel][blockIdx.x ? 1 : 0][i] = t_;                                         \
    }                                                                                           \
  } while (0)
#else
#define HEAD_PHASE(kernel, i) \
  do {                        \
  } while (0)
#endif

namespace {

constexpr int HS_THREADS = 256;  // 8 warps
constexpr int HS_WARPS = HS_THREADS / 32;
constexpr int HS_SMEM = 232448;  // shared bytes a block can use on the H100

// forward
constexpr int FW_MT = 64;         // rows of x a CTA owns: 4 m16 tiles
constexpr int FW_NT = 8;          // latent columns a CTA owns: 16 weight rows, 2 n8 tiles
constexpr int FW_KC = 128;        // K chunk a ring slot holds: 16 columns a warp
constexpr int FW_MAX_SPLIT = 8;   // CTAs splitting K
constexpr int FW_MAX_STAGES = 8;  // ring slots
constexpr int FW_WS = FW_KC + 4;  // weight row stride (floats): fragment loads on 32 banks
constexpr int FW_WFLOATS = 2 * FW_NT * FW_WS;
constexpr int FW_RS = 2 * FW_NT + 1;  // row stride of the warps' partials (floats)
static_assert(FW_KC == 16 * HS_WARPS, "two k8 steps a warp a chunk");

__host__ __device__ constexpr int fw_xs(int esize) { return FW_KC + 16 / esize; }
__host__ __device__ constexpr int fw_stage_bytes(int esize) {
  return FW_MT * fw_xs(esize) * esize + FW_WFLOATS * 4;
}
__host__ __device__ constexpr int fw_stages(int esize) {
  return HS_SMEM / fw_stage_bytes(esize) < FW_MAX_STAGES ? HS_SMEM / fw_stage_bytes(esize)
                                                          : FW_MAX_STAGES;
}
__host__ __device__ constexpr int fw_smem(int esize) {
  return fw_stages(esize) * fw_stage_bytes(esize);
}
static_assert(fw_stage_bytes(2) % 16 == 0 && fw_stage_bytes(4) % 16 == 0, "slot alignment");
static_assert(HS_WARPS * FW_MT * FW_RS * 4 <= fw_smem(2) && HS_WARPS * FW_MT * FW_RS * 4 <= fw_smem(4),
              "the warps' partials alias the ring");

// backward
constexpr int BW_KT = 64;         // K columns a CTA owns
constexpr int BW_MR = 64;         // rows of the batch a block holds
constexpr int BW_MAX_LB = 128;    // latent columns a CTA owns at most (256 weight rows)
constexpr int BW_XT = BW_MR * BW_KT * 4;  // bytes of x^T's hi (or lo) cores
constexpr int BW_STAGE = 36;      // row stride of a warp's D staging tile (floats)
static_assert(HS_WARPS * 2 * 8 * BW_STAGE * 4 <= 2 * BW_XT, "staging fits the x^T cores");
static_assert(BW_MAX_LB <= 32 * HS_WARPS && BW_MAX_LB % 32 == 0, "D's column blocks");

// Backward geometry (shared with ops/head_kernels.py::head_geometry): K
// tiles, latent columns a block (a power of two), latent blocks, weight
// rows a CTA, shared bytes: the W tile in f32, D's TF32 hi and lo cores,
// x^T's hi and lo cores.
struct BwdGeo {
  int tiles, lb, blocks, wr, smem;
};
__host__ __device__ inline BwdGeo bwd_geo(int K, int N) {
  BwdGeo g;
  g.tiles = (K + BW_KT - 1) / BW_KT;
  g.lb = 8;
  while (g.lb < N && g.lb < BW_MAX_LB) g.lb *= 2;
  g.blocks = (N + g.lb - 1) / g.lb;
  g.wr = 2 * g.lb;
  g.smem = g.wr * BW_KT * 4 + 2 * g.wr * BW_MR * 4 + 2 * BW_XT;
  return g;
}

// Byte offset of element (k, n) of a K-major TF32 operand of 64 columns n,
// packed as hopper.cuh's TF32 B cores: [k / 4][n / 8] cores of 8 n-rows of
// 4 consecutive k (16 bytes a row, 128 a core).
__device__ __forceinline__ int core_off(int k, int n) {
  return ((((k >> 2) << 3) + (n >> 3)) << 7) + ((n & 7) << 4) + ((k & 3) << 2);
}

inline int fw_splits(int K) {
  const int c = (K + FW_KC - 1) / FW_KC;
  return c < 1 ? 1 : c > FW_MAX_SPLIT ? FW_MAX_SPLIT : c;
}
inline int fw_slice(int K, int cs) {
  const int per = (K + cs - 1) / cs;
  return (per + FW_KC - 1) / FW_KC * FW_KC;
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads of it (wgmma operands written by the threads).
__device__ __forceinline__ void fence_view_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// v = hi + lo, each rounded to TF32 to nearest, ties away (the bits of
// hopper.cuh's tf32_split for every finite v), by integer ops on the bits:
// cvt.rna.tf32.f32 issues at a quarter of their rate, and the backward
// splits an operand for every product it feeds.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & ~0x1FFFu; }
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(v));
  lo = tf32_rna(__float_as_uint(v - __uint_as_float(hi)));
}

// An element of x as TF32 parts: an f32 split into hi and lo; a bf16 is
// exact in TF32 (lo = 0, and its pass is skipped: X_LO).
template <typename X>
constexpr bool X_LO = std::is_same<X, float>::value;
template <typename X>
__device__ __forceinline__ void x_parts(X v, uint32_t& hi, uint32_t& lo) {
  if constexpr (X_LO<X>) {
    split_tf32(to_f(v), hi, lo);
  } else {
    hi = __float_as_uint(to_f(v));
    lo = 0u;
  }
}

// d += a b in split TF32, the small terms first: lo(a) hi(b) (where a's lo
// pass runs), hi(a) lo(b), hi(a) hi(b).
template <bool ALO>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  if (ALO) mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// eps for element `e` of stream `seed`: Box-Muller on two 24-bit uniforms,
// u1 in (0, 1] offset by 2^-25 so the log stays finite.
__device__ __forceinline__ float philox_normal(unsigned long long e, uint32_t seed) {
  const uint4 r = philox_draw(e, seed);
  const float u1 = (float)(r.x >> 8) * (1.0f / 16777216.0f) + (1.0f / 33554432.0f);
  const float u2 = (float)(r.y >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(u1)) * cospif(2.0f * u2);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// One K chunk of this CTA's slice into ring slot `slot` (x rows, then the 8
// W_mu rows and the 8 W_lv rows), zeros past K, M and N: 16-byte cp.async
// by every thread (VEC), or plain loads.
template <typename X, bool VEC>
__device__ __forceinline__ void fw_load(unsigned char* slot, const X* x, const float* w_mu,
                                        const float* w_lv, int M, int K, int N, int m0, int j0,
                                        int kc0, int kend) {
  X* xs = reinterpret_cast<X*>(slot);
  float* ws = reinterpret_cast<float*>(slot + FW_MT * fw_xs(sizeof(X)) * sizeof(X));
  const int kv = min(FW_KC, kend - kc0);
  const int rows = min(FW_MT, M - m0), wrows = min(FW_NT, N - j0);
  if (VEC) {
    constexpr int XP = FW_KC * sizeof(X) / 16, WP = FW_KC * 4 / 16;  // 16-byte pieces a row
    for (int i = threadIdx.x; i < FW_MT * XP + 2 * FW_NT * WP; i += HS_THREADS) {
      if (i < FW_MT * XP) {
        const int r = i / XP, p = i % XP;
        const bool ok = r < rows && p * 16 < kv * (int)sizeof(X);
        cp_async16(reinterpret_cast<unsigned char*>(xs + r * fw_xs(sizeof(X))) + 16 * p,
                   x + (size_t)(m0 + (ok ? r : 0)) * K + kc0 + (ok ? p * 16 / sizeof(X) : 0), ok);
      } else {
        const int r = (i - FW_MT * XP) / WP, p = (i - FW_MT * XP) % WP;
        const int lv = r >= FW_NT, j = r % FW_NT;
        const bool ok = j < wrows && p * 16 < kv * 4;
        cp_async16(ws + r * FW_WS + 4 * p,
                   (lv ? w_lv : w_mu) + (size_t)(j0 + (ok ? j : 0)) * K + kc0 + (ok ? 4 * p : 0),
                   ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < FW_MT * FW_KC; i += HS_THREADS) {
      const int m = i / FW_KC, k = i % FW_KC;
      xs[m * fw_xs(sizeof(X)) + k] =
          m < rows && k < kv ? x[(size_t)(m0 + m) * K + kc0 + k] : from_f<X>(0.f);
    }
    for (int i = threadIdx.x; i < 2 * FW_NT * FW_KC; i += HS_THREADS) {
      const int r = i / FW_KC, k = i % FW_KC, lv = r >= FW_NT, j = r % FW_NT;
      ws[r * FW_WS + k] =
          j < wrows && k < kv ? (lv ? w_lv : w_mu)[(size_t)(j0 + j) * K + kc0 + k] : 0.f;
    }
  }
}

// grid (K splits, N tiles, M tiles); `partials` holds (tiles, splits, 64,
// 16) floats, `tickets` one int a tile, zero between launches.  Two launches
// in flight at once must not share `tickets` (the wrapper keeps one buffer
// a stream).
template <typename X, bool VEC>
__global__ void __launch_bounds__(HS_THREADS, 1)
head_sample_fwd_kernel(const X* __restrict__ x, const float* __restrict__ w_mu,
                       const float* __restrict__ b_mu, const float* __restrict__ w_lv,
                       const float* __restrict__ b_lv, const float* __restrict__ eps,
                       float* __restrict__ mu, float* __restrict__ logvar,
                       float* __restrict__ z, float* __restrict__ diff,
                       float* __restrict__ partials, int* __restrict__ tickets, int M, int K,
                       int N, int kslice, SeedArg sa) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ES = sizeof(X), XS = fw_xs(ES), STAGE = fw_stage_bytes(ES);
  constexpr int STAGES = fw_stages(ES);
  const int rank = blockIdx.x, nrank = gridDim.x, tile = blockIdx.z * gridDim.y + blockIdx.y;
  const int j0 = blockIdx.y * FW_NT, m0 = blockIdx.z * FW_MT;
  float* mine = partials + ((size_t)tile * nrank + rank) * FW_MT * 2 * FW_NT;  // [64][16]
  const int kbeg = min(K, rank * kslice), kend = min(K, kbeg + kslice);
  const int nch = (kend - kbeg + FW_KC - 1) / FW_KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;

  HEAD_PHASE(0, 0);
  // chunks 0..S-2 in flight; chunk c + S - 1 is issued once chunk c landed
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nch)
      fw_load<X, VEC>(smem + c * STAGE, x, w_mu, w_lv, M, K, N, m0, j0, kbeg + c * FW_KC, kend);
    cp_async_commit();
  }

  HEAD_PHASE(0, 1);
  // acc[mt][nt]: rows 16 mt + g (+ 8), columns 8 nt + 2 tq (+ 1): nt 0 mu, 1 logvar
  float acc[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in for every thread; slot (c - 1) % S is free
    const int cn = c + STAGES - 1;
    if (cn < nch)
      fw_load<X, VEC>(smem + (cn % STAGES) * STAGE, x, w_mu, w_lv, M, K, N, m0, j0,
                      kbeg + cn * FW_KC, kend);
    cp_async_commit();
    const unsigned char* slot = smem + (c % STAGES) * STAGE;
    const X* xs = reinterpret_cast<const X*>(slot);
    const float* ws = reinterpret_cast<const float*>(slot + FW_MT * XS * ES);
    // the warp's two k8 steps of the chunk (zeros past K), summed as a slab
    float part[4][2][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * warp + 8 * h + tq;
      uint32_t ah[4][4], al[4][4], bh[2][2], bl[2][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const X* r = xs + (16 * mt + g) * XS + k;
        x_parts<X>(r[0], ah[mt][0], al[mt][0]);
        x_parts<X>(r[8 * XS], ah[mt][1], al[mt][1]);
        x_parts<X>(r[4], ah[mt][2], al[mt][2]);
        x_parts<X>(r[8 * XS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* w = ws + (8 * nt + g) * FW_WS + k;
        split_tf32(w[0], bh[nt][0], bl[nt][0]);
        split_tf32(w[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_split<X_LO<X>>(part[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }
  HEAD_PHASE(0, 2);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the warps' partials, summed in warp order, in the ring: [warp][64][17]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * FW_MT + 16 * mt + g + 8 * (i >> 1)) * FW_RS + 8 * nt + 2 * tq + (i & 1)] =
            acc[mt][nt][i];
  __syncthreads();
  for (int i = threadIdx.x; i < FW_MT * 2 * FW_NT; i += HS_THREADS) {
    const int row = i / (2 * FW_NT), col = i % (2 * FW_NT);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < HS_WARPS; ++w) s += red[(w * FW_MT + row) * FW_RS + col];
    mine[i] = s;
  }
  HEAD_PHASE(0, 3);
  // The CTA that finishes last (an integer ticket a tile) sums the ranks'
  // partials in rank order and writes the tile.
  __shared__ int last;
  __threadfence();  // this rank's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[tile], 1) == nrank - 1;
  __syncthreads();
  HEAD_PHASE(0, 4);
  if (!last) return;
  __threadfence();
  const uint32_t seed = eps ? 0u : seed_of(sa);
  const float* all = partials + (size_t)tile * nrank * FW_MT * 2 * FW_NT;
  for (int i = threadIdx.x; i < FW_MT * FW_NT; i += HS_THREADS) {
    const int m = i / FW_NT, j = i % FW_NT;
    const int gm = m0 + m, gj = j0 + j;
    if (gm >= M || gj >= N) continue;
    float pmu[FW_MAX_SPLIT], plv[FW_MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < FW_MAX_SPLIT; ++q) {  // all loads first: one round trip
      if (q < nrank) {  // from L2: other CTAs wrote them
        pmu[q] = __ldcg(all + (q * FW_MT + m) * 2 * FW_NT + j);
        plv[q] = __ldcg(all + (q * FW_MT + m) * 2 * FW_NT + FW_NT + j);
      }
    }
    float smu = 0.f, slv = 0.f;
#pragma unroll
    for (int q = 0; q < FW_MAX_SPLIT; ++q) {
      if (q < nrank) {
        smu += pmu[q];
        slv += plv[q];
      }
    }
    const size_t e = (size_t)gm * N + gj;
    const float vmu = __fadd_rn(smu, b_mu[gj]), vlv = __fadd_rn(slv, b_lv[gj]);
    const float ep = eps ? eps[e] : philox_normal(e, seed);
    const float vz = __fadd_rn(vmu, __fmul_rn(expf(0.5f * vlv), ep));
    mu[e] = vmu;
    logvar[e] = vlv;
    z[e] = vz;
    diff[e] = __fsub_rn(vz, vmu);
  }
  if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
  HEAD_PHASE(0, 5);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// grid (K tiles, latent blocks).  CTA (kt, blk) owns columns [64 kt, 64 kt
// + 64) of K and latent columns [lb blk, lb blk + lb): weight rows [0, lb)
// of its tile are W_mu's, [lb, 2 lb) W_lv's, and D's columns follow them.
// `scratch` holds (tiles, blocks, M, 64) floats of partial dx and `tickets`
// one int a K tile, zero between launches (both unused with one block).
// Two warpgroups: in dW warpgroup h owns the 64-row tiles h and h + 2 of
// the weight rows, in dx^T the 32 batch rows [32 h, 32 h + 32) of a block.
// A tile or k step past 2 lb multiplies zeros: no branch around a wgmma.
template <typename X, bool VEC>
__global__ void __launch_bounds__(HS_THREADS, 1)
head_sample_bwd_kernel(const X* __restrict__ x, const float* __restrict__ w_mu,
                       const float* __restrict__ w_lv, const float* __restrict__ diff,
                       const float* __restrict__ g_mu, const float* __restrict__ g_lv,
                       const float* __restrict__ g_z, X* __restrict__ dx,
                       float* __restrict__ dw_mu, float* __restrict__ dw_lv,
                       float* __restrict__ db_mu, float* __restrict__ db_lv,
                       float* __restrict__ scratch, int* __restrict__ tickets, int M, int K,
                       int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdGeo geo = bwd_geo(K, N);
  const int lb = geo.lb, wr = geo.wr;
  float* W = reinterpret_cast<float*>(smem);                // [wr][64], w_at() swizzled
  unsigned char* d_hi = smem + wr * BW_KT * 4;              // D cores: k = weight row, n = batch row
  unsigned char* d_lo = d_hi + wr * BW_MR * 4;
  unsigned char* xt_hi = d_lo + wr * BW_MR * 4;             // x^T cores: k = batch row, n = column
  unsigned char* xt_lo = xt_hi + BW_XT;
  const int kt = blockIdx.x, blk = blockIdx.y;
  const int k0 = kt * BW_KT, kv = min(BW_KT, K - k0), j0 = blk * lb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wq = warp & 3;
  // W[c][n] lives at w_at(c, n): columns XOR-swizzled by 8 (c & 3), so the
  // A fragments' loads fall on 32 banks and 16-byte pieces stay whole
  auto w_at = [&](int c, int n) { return W + c * BW_KT + (n ^ ((c & 3) << 3)); };

  HEAD_PHASE(1, 0);
  // the W tile, once, zeros past N and K
  if (VEC) {
    constexpr int WP = BW_KT * 4 / 16;  // 16-byte pieces a row
    for (int i = tid; i < wr * WP; i += HS_THREADS) {
      const int r = i / WP, p = i % WP, lv = r >= lb, j = j0 + r - (lv ? lb : 0);
      const bool ok = j < N && 4 * p < kv;
      cp_async16(w_at(r, 4 * p),
                 (lv ? w_lv : w_mu) + (size_t)(ok ? j : 0) * K + k0 + (ok ? 4 * p : 0), ok);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < wr * BW_KT; i += HS_THREADS) {
      const int r = i / BW_KT, c = i % BW_KT, lv = r >= lb, j = j0 + r - (lv ? lb : 0);
      *w_at(r, c) = j < N && c < kv ? (lv ? w_lv : w_mu)[(size_t)j * K + k0 + c] : 0.f;
    }
  }

  HEAD_PHASE(1, 1);
  // D's latent column of this thread, 32 dcb + lane (dcb = warp % ncb), and
  // its sums of dmu and dlv over its rows of the batch, for db
  const int ncb = (lb + 31) / 32, dcb = warp % ncb;
  float dbs[2] = {0.f, 0.f};
  // dW: this warpgroup's weight-row tiles wg and wg + 2, the sum over the
  // batch carried from block to block; d[4 j + 2 h + e] of a tile is row
  // 16 wq + g + 8 h, column 8 j + 2 tq + e
  float dw[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) dw[t][i] = 0.f;

  for (int r0 = 0; r0 < M; r0 += BW_MR) {
    const int rows = min(BW_MR, M - r0);
    if (r0 > 0) __syncthreads();  // the last block's D and x^T are read
    // D = [dmu | dlv] of the block's rows as TF32 (hi, lo) cores, zeros
    // past the rows and N.  Each warp takes tiles of 32 latent columns x 8
    // rows (columns 32 cb + lane, cb = warp % ncb, fixed for the warp):
    // coalesced loads of the cotangents, dmu and dlv through a staging tile
    // of its own (in the x^T cores' space, filled later) read back
    // transposed, so that the cores' stores land on 32 banks
    {
      float* stage = reinterpret_cast<float*>(xt_hi) + warp * 2 * 8 * BW_STAGE;  // [2][8][36]
      const int c = 32 * dcb + lane, j = j0 + c, step = HS_WARPS / ncb;
      // two tiles' loads in flight at once
      for (int rb0 = warp / ncb; rb0 < BW_MR / 8; rb0 += 2 * step) {
        float gm[2][8], gl[2][8], gz[2][8], df[2][8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = 8 * (rb0 + h * step) + i;
            const bool ok = r < rows && c < lb && j < N;
            const size_t e = (size_t)(r0 + (ok ? r : 0)) * N + (ok ? j : 0);
            gm[h][i] = ok && g_mu ? g_mu[e] : 0.f;
            gl[h][i] = ok && g_lv ? g_lv[e] : 0.f;
            gz[h][i] = ok && g_z ? g_z[e] : 0.f;
            df[h][i] = ok && g_z ? diff[e] : 0.f;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rb = rb0 + h * step;
          if (rb >= BW_MR / 8) break;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float dmu = __fadd_rn(gm[h][i], gz[h][i]);
            const float dlv = __fadd_rn(gl[h][i], __fmul_rn(__fmul_rn(0.5f, gz[h][i]), df[h][i]));
            stage[i * BW_STAGE + lane] = dmu;
            stage[(8 + i) * BW_STAGE + lane] = dlv;
            dbs[0] += dmu;  // zeros past the rows
            dbs[1] += dlv;
          }
          __syncwarp();
          // read back: this lane's row 8 rb + (lane & 7), columns 4 q + (lane >> 3)
          const int rr = lane & 7, r = 8 * rb + rr;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int cc = 4 * q + (lane >> 3), cg = 32 * dcb + cc;
            if (cg < lb) {
              uint32_t hi, lo;
              split_tf32(stage[rr * BW_STAGE + cc], hi, lo);
              *reinterpret_cast<uint32_t*>(d_hi + core_off(cg, r)) = hi;
              *reinterpret_cast<uint32_t*>(d_lo + core_off(cg, r)) = lo;
              split_tf32(stage[(8 + rr) * BW_STAGE + cc], hi, lo);
              *reinterpret_cast<uint32_t*>(d_hi + core_off(lb + cg, r)) = hi;
              *reinterpret_cast<uint32_t*>(d_lo + core_off(lb + cg, r)) = lo;
            }
          }
          __syncwarp();  // the staging tile is read
        }
      }
    }
    HEAD_PHASE(1, 2);
    __syncthreads();  // every warp's staging tile is read: x^T may overwrite them
    // x^T's TF32 parts of the block's rows (a bf16 x is exact: its lo part
    // is zero), zeros past its rows and K: each warp 8 columns x 4 rows a
    // step, which land on 32 banks
    {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int b = warp + 8 * u, n = 8 * (b & 7) + (lane & 7), r = 4 * (b >> 3) + (lane >> 3);
        v[u] = r < rows && n < kv ? to_f(x[(size_t)(r0 + r) * K + k0 + n]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int b = warp + 8 * u, n = 8 * (b & 7) + (lane & 7), r = 4 * (b >> 3) + (lane >> 3);
        uint32_t hi, lo;
        split_tf32(v[u], hi, lo);
        *reinterpret_cast<uint32_t*>(xt_hi + core_off(r, n)) = hi;
        *reinterpret_cast<uint32_t*>(xt_lo + core_off(r, n)) = lo;
      }
    }
    HEAD_PHASE(1, 3);
    cp_async_wait<0>();         // the W tile has landed (the first block)
    fence_view_async_shared();  // the cores written by threads, read by wgmma
    __syncthreads();

    HEAD_PHASE(1, 4);
    // dW += D^T x over the block's rows (A: D^T from the D cores, k = the
    // batch; B: x^T's cores), the block's 8 k steps of a tile as one slab
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = 64 * (wg + 2 * t) + 16 * wq + g;  // this thread's weight rows c, c + 8
      uint32_t ah[BW_MR / 8][4], al[BW_MR / 8][4];
#pragma unroll
      for (int s = 0; s < BW_MR / 8; ++s) {
        const int m = 8 * s + tq;
        const int off[4] = {core_off(c, m), core_off(c + 8, m), core_off(c, m + 4),
                            core_off(c + 8, m + 4)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = c + 8 * (q & 1) < wr;
          ah[s][q] = in ? *reinterpret_cast<const uint32_t*>(d_hi + off[q]) : 0u;
          al[s][q] = in ? *reinterpret_cast<const uint32_t*>(d_lo + off[q]) : 0u;
        }
      }
      float part[32];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BW_MR / 8; ++s) {
        const uint32_t bx = smem_u32(xt_hi) + 2048 * s, bxl = smem_u32(xt_lo) + 2048 * s;
        // D's lo part against x's hi, x's lo (an f32 x's) against D's hi,
        // then hi hi
        wgmma_tf32<64>(part, al[s], smem_desc(bx, BW_KT * 16, 128), 128, s > 0);
        if constexpr (X_LO<X>)
          wgmma_tf32<64>(part, ah[s], smem_desc(bxl, BW_KT * 16, 128), 128, 1);
        wgmma_tf32<64>(part, ah[s], smem_desc(bx, BW_KT * 16, 128), 128, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < BW_MR / 8; ++s) {
        keep_regs4(ah[s]);
        keep_regs4(al[s]);
      }
      promote_slab(dw[t], part);
    }

    HEAD_PHASE(1, 5);
    // dx^T = W^T D^T over the 2 lb weight rows (A: W^T from the W tile, k =
    // the weight rows; B: the D cores), all 64 batch rows, warpgroup h over
    // its half of the weight rows: 4 k steps a group, the next group's
    // fragments gathered while one runs (two register buffers); every step
    // adds into acc (at most 32 k steps of a sum, no slab needed), and the
    // two halves are added through shared memory; d[4 j + 2 h + e] is
    // column 16 wq + g + 8 h of batch row 8 j + 2 tq + e
    {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      const int n = 16 * wq + g;
      const int half = (wr / 2 + 31) / 32 * 32, kb = wg * half, ke = kb + half;
      const int lim = min(wr, ke);  // this warpgroup's rows end here: zeros past
      uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
      auto gather = [&](uint32_t (&ah)[4][4], uint32_t (&al)[4][4], int s0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = s0 + 8 * i + tq;
          split_tf32(c < lim ? *w_at(c, n) : 0.f, ah[i][0], al[i][0]);
          split_tf32(c < lim ? *w_at(c, n + 8) : 0.f, ah[i][1], al[i][1]);
          split_tf32(c + 4 < lim ? *w_at(c + 4, n) : 0.f, ah[i][2], al[i][2]);
          split_tf32(c + 4 < lim ? *w_at(c + 4, n + 8) : 0.f, ah[i][3], al[i][3]);
        }
      };
      auto issue = [&](const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4], int s0) {
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t off = (s0 + 8 * i) * 256;  // k = s0 + 8 i
          wgmma_3xtf32<64>(acc, ah[i], al[i], smem_desc(smem_u32(d_hi) + off, BW_MR * 16, 128),
                           smem_desc(smem_u32(d_lo) + off, BW_MR * 16, 128), 128, 1);
        }
        wgmma_commit();
      };
      auto keep = [&](const uint32_t (&ah)[4][4], const uint32_t (&al)[4][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          keep_regs4(ah[i]);
          keep_regs4(al[i]);
        }
      };
      // groups of 32 weight rows in pairs (a half is a multiple of 32; a
      // group past the half or 2 lb multiplies zeros by finite shared memory)
      gather(ah0, al0, kb);
      for (int s0 = kb; s0 < ke; s0 += 64) {
        issue(ah0, al0, s0);
        wgmma_wait<1>();
        keep(ah1, al1);
        gather(ah1, al1, s0 + 32);
        issue(ah1, al1, s0 + 32);
        wgmma_wait<1>();
        keep(ah0, al0);
        if (s0 + 64 < ke) gather(ah0, al0, s0 + 64);
      }
      wgmma_wait<0>();
      keep(ah1, al1);
      fence_regs(acc);
      // warpgroup 1's half to warpgroup 0 through the x^T cores' space
      float* red = reinterpret_cast<float*>(xt_hi);  // [32][128]
      __syncthreads();  // dW has read the x^T cores
      if (wg == 1) {
#pragma unroll
        for (int q = 0; q < 32; ++q) red[q * 128 + (tid & 127)] = acc[q];
      }
      __syncthreads();
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const float v = acc[q] + red[q * 128 + tid];
          const int col = n + 8 * ((q >> 1) & 1), row = 8 * (q >> 2) + 2 * tq + (q & 1);
          if (row >= rows || col >= kv) continue;
          if (geo.blocks == 1)
            dx[(size_t)(r0 + row) * K + k0 + col] = from_f<X>(v);
          else
            scratch[(((size_t)kt * geo.blocks + blk) * M + r0 + row) * BW_KT + col] = v;
        }
      }
    }
  }

  HEAD_PHASE(1, 6);
  // dW and db out
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * (wg + 2 * t) + 16 * wq + g + 8 * h;
      const int lv = c >= lb, j = j0 + c - (lv ? lb : 0);
      if (c >= wr || j >= N) continue;
      float* out = (lv ? dw_lv : dw_mu) + (size_t)j * K + k0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = 8 * q + 2 * tq;
        const float v0 = dw[t][4 * q + 2 * h], v1 = dw[t][4 * q + 2 * h + 1];
        if (VEC) {  // K % 4 == 0 and the tensors 16-byte aligned: col + 1 < kv with col
          if (col < kv) *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
        } else {
          if (col < kv) out[col] = v0;
          if (col + 1 < kv) out[col + 1] = v1;
        }
      }
    }
  HEAD_PHASE(1, 7);
  if (kt == 0) {  // each column's sums over the warps' rows, added in warp order
    __syncthreads();  // the D cores are read: they hold the sums now
    float* sums = reinterpret_cast<float*>(d_hi);  // [2][HS_WARPS][32 ncb]
    const int c = 32 * dcb + lane, p = warp / ncb, w = 32 * ncb;
    sums[p * w + c] = dbs[0];
    sums[(HS_WARPS + p) * w + c] = dbs[1];
    __syncthreads();
    if (tid < lb && j0 + tid < N) {
      float smu = 0.f, slv = 0.f;
      for (int q = 0; q < HS_WARPS / ncb; ++q) {
        smu += sums[q * w + tid];
        slv += sums[(HS_WARPS + q) * w + tid];
      }
      db_mu[j0 + tid] = smu;
      db_lv[j0 + tid] = slv;
    }
  }
  HEAD_PHASE(1, 8);
  if (geo.blocks == 1) return;
  // dx: the last CTA of the K tile (an integer ticket) sums the latent
  // blocks' partials in block order
  __shared__ int last;
  __threadfence();  // this CTA's partial is visible before its ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[kt], 1) == geo.blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* part = scratch + (size_t)kt * geo.blocks * M * BW_KT;
  for (int i = tid; i < M * kv; i += HS_THREADS) {
    const int m = i / kv, c = i - m * kv;
    float s = 0.f;
    for (int b = 0; b < geo.blocks; ++b) s += __ldcg(part + ((size_t)b * M + m) * BW_KT + c);
    dx[(size_t)m * K + k0 + c] = from_f<X>(s);
  }
  if (tid == 0) tickets[kt] = 0;  // ready for the next launch
  HEAD_PHASE(1, 9);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

inline cudaError_t set_smem(const void* kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename X, bool VEC>
cudaError_t fwd_launch(const void* x, const void* w_mu, const void* b_mu, const void* w_lv,
                       const void* b_lv, const void* eps, void* mu, void* logvar, void* z,
                       void* diff, void* partials, void* tickets, int M, int K, int N,
                       SeedArg seed, cudaStream_t stream) {
  const int smem = fw_smem(sizeof(X));
  cudaError_t err = set_smem((const void*)head_sample_fwd_kernel<X, VEC>, smem);
  if (err != cudaSuccess) return err;
  const int splits = fw_splits(K);
  const dim3 grid(splits, (N + FW_NT - 1) / FW_NT, (M + FW_MT - 1) / FW_MT);
  head_sample_fwd_kernel<X, VEC><<<grid, HS_THREADS, smem, stream>>>(
      (const X*)x, (const float*)w_mu, (const float*)b_mu, (const float*)w_lv,
      (const float*)b_lv, (const float*)eps, (float*)mu, (float*)logvar, (float*)z,
      (float*)diff, (float*)partials, (int*)tickets, M, K, N, fw_slice(K, splits), seed);
  return cudaGetLastError();
}

template <typename X>
cudaError_t fwd(const void* x, const void* w_mu, const void* b_mu, const void* w_lv,
                const void* b_lv, const void* eps, void* mu, void* logvar, void* z, void* diff,
                void* partials, void* tickets, int M, int K, int N, SeedArg seed,
                cudaStream_t stream) {
  const bool vec = K % (16 / (int)sizeof(X)) == 0 && aligned16(x) && aligned16(w_mu) &&
                   aligned16(w_lv);
  return vec ? fwd_launch<X, true>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff,
                                   partials, tickets, M, K, N, seed, stream)
             : fwd_launch<X, false>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff,
                                    partials, tickets, M, K, N, seed, stream);
}

template <typename X, bool VEC>
cudaError_t bwd_launch(const void* x, const void* w_mu, const void* w_lv, const void* diff,
                       const void* g_mu, const void* g_lv, const void* g_z, void* dx, void* dw_mu,
                       void* dw_lv, void* db_mu, void* db_lv, void* scratch, void* tickets,
                       int M, int K, int N, cudaStream_t stream) {
  const void* kern = (const void*)head_sample_bwd_kernel<X, VEC>;
  const BwdGeo geo = bwd_geo(K, N);
  cudaError_t err = set_smem(kern, geo.smem);
  if (err != cudaSuccess) return err;
  head_sample_bwd_kernel<X, VEC><<<dim3(geo.tiles, geo.blocks), HS_THREADS, geo.smem,
                                   stream>>>(
      (const X*)x, (const float*)w_mu, (const float*)w_lv, (const float*)diff,
      (const float*)g_mu, (const float*)g_lv, (const float*)g_z, (X*)dx, (float*)dw_mu,
      (float*)dw_lv, (float*)db_mu, (float*)db_lv, (float*)scratch, (int*)tickets, M, K, N);
  return cudaGetLastError();
}

template <typename X>
cudaError_t bwd(const void* x, const void* w_mu, const void* w_lv, const void* diff,
                const void* g_mu, const void* g_lv, const void* g_z, void* dx, void* dw_mu,
                void* dw_lv, void* db_mu, void* db_lv, void* scratch, void* tickets, int M,
                int K, int N, cudaStream_t stream) {
  if (bwd_geo(K, N).blocks > 1 && (scratch == nullptr || tickets == nullptr))
    return cudaErrorInvalidValue;
  const bool vec = K % (16 / (int)sizeof(X)) == 0 && aligned16(x) && aligned16(w_mu) &&
                   aligned16(w_lv) && aligned16(dw_mu) && aligned16(dw_lv);
  return vec ? bwd_launch<X, true>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                   db_mu, db_lv, scratch, tickets, M, K, N, stream)
             : bwd_launch<X, false>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                    db_mu, db_lv, scratch, tickets, M, K, N, stream);
}

}  // namespace
}  // namespace mmvae

extern "C" {

// x_dtype: 0 f32, 1 bf16.  eps may be null (drawn from the stream seed:
// `seed_value`, or where `seed_step` is set, stream `stream_id`'s seed under
// `salt` of the int64 step seed it points at on the device).  partials:
// (N tiles x M tiles x splits x 1024) floats of scratch; tickets: one int a
// tile, zero, and left zero; not shared with a launch that may run at the
// same time.
int mmvae_head_sample_fwd(const void* x, const void* w_mu, const void* b_mu, const void* w_lv,
                          const void* b_lv, const void* eps, void* mu, void* logvar, void* z,
                          void* diff, void* partials, void* tickets, int M, int K, int N,
                          int x_dtype, unsigned int seed_value, const void* seed_step,
                          int stream_id, int salt, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const mmvae::SeedArg seed{(const long long*)seed_step, seed_value, (uint32_t)stream_id,
                            (uint32_t)salt};
  if (x_dtype == mmvae::kF32)
    return (int)mmvae::fwd<float>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff,
                                  partials, tickets, M, K, N, seed, s);
  if (x_dtype == mmvae::kBF16)
    return (int)mmvae::fwd<__nv_bfloat16>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff,
                                          partials, tickets, M, K, N, seed, s);
  return (int)cudaErrorInvalidValue;
}

// g_mu, g_lv and g_z may each be null (zeros).  scratch: (K tiles x latent
// blocks x M x 64) floats and tickets one int a K tile, zero and left zero,
// where the layout has more than one latent block (else unused, may be
// null).
int mmvae_head_sample_bwd(const void* x, const void* w_mu, const void* w_lv, const void* diff,
                          const void* g_mu, const void* g_lv, const void* g_z, void* dx,
                          void* dw_mu, void* dw_lv, void* db_mu, void* db_lv, void* scratch,
                          void* tickets, int M, int K, int N, int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == mmvae::kF32)
    return (int)mmvae::bwd<float>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                  db_mu, db_lv, scratch, tickets, M, K, N, s);
  if (x_dtype == mmvae::kBF16)
    return (int)mmvae::bwd<__nv_bfloat16>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu,
                                          dw_lv, db_mu, db_lv, scratch, tickets, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef HEAD_PHASE_TIMES
// The phase times of the last launches (see HEAD_PHASE): 64 uint64.
int mmvae_head_phase_times(void* out) {
  return (int)cudaMemcpyFromSymbol(out, mmvae::head_phase_t, sizeof(mmvae::head_phase_t));
}
#endif

// The launch geometry as the kernels compute it, for the wrapper to hold
// its own against: {forward K splits, forward K slice, forward shared
// bytes, backward shared bytes, backward K tiles, backward latent columns
// a block}.
void mmvae_head_sample_layout(int M, int K, int N, int x_dtype, int* out) {
  (void)M;  // no part of the layout depends on the batch
  const int esize = x_dtype == mmvae::kBF16 ? 2 : 4;
  const int splits = mmvae::fw_splits(K);
  const mmvae::BwdGeo geo = mmvae::bwd_geo(K, N);
  out[0] = splits;
  out[1] = mmvae::fw_slice(K, splits);
  out[2] = mmvae::fw_smem(esize);
  out[3] = geo.smem;
  out[4] = geo.tiles;
  out[5] = geo.lb;
}

}  // extern "C"
