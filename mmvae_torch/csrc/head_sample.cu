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
// What bounds it on the H100: operations.  At the flagship head (M = 64,
// K = 8192, N = 128, bf16 x) the forward is 268 MFLOP of f32 products over
// 9.6 MB (8.4 MB of weights): 32 FLOP per weight byte, above the card's f32
// ridge of 20, so 4.0 us of FFMA against 2.9 us of memory; the backward is
// twice the products over 19 MB, 8.0 us.  The products run on the FFMA
// pipe in full f32, as the reference (the port runs with TF32 off).
//
// Design, forward: split-K.  Each CTA owns 64 rows of x, 8 latent columns
// of BOTH W_mu and W_lv (16 weight rows), so that mu_j and logvar_j meet in
// one epilogue, and one of up to 8 slices of K (128 CTAs at the flagship
// head, one an SM).  It streams its slice through a 4-slot ring of 128-wide
// K chunks, 3 in flight, by 16-byte cp.async from every thread (1D bulk
// copies, one a row of a chunk, 256-512 bytes, ran 1.6x slower).  Its 8
// warps split each chunk's K between them; a lane keeps a 4 x 8 register
// tile (4 rows, 8 weight rows), so each 4-deep K step is 12 shared loads
// for 128 FFMA.  The warps' partials are summed through shared memory in
// warp order, each CTA's go to a global scratch, and the CTA that finishes
// last (an integer ticket a tile) sums them in rank order and writes bias,
// eps and the four outputs: no float atomics, the same bits on every call.
// (The 8 slices of a tile as one thread-block cluster, summed through
// distributed shared memory, ran 0.0259 ms against 0.0154 for the same
// kernel launched without the cluster and without its sum, and 0.0314 with
// one CTA an SM forced: the clusters' placement cost it, not the sum;
// PERF.md section 6, PR 5: H100 SXM at 700 W.)
//
// Design, backward: one launch, no reduction across CTAs.  Each CTA owns 32
// columns of K (two CTAs an SM at the flagship head) and computes
// dx[:, slice] = D [W_mu; W_lv][:, slice] and dW[:, slice] = D^T x[:, slice]
// over the whole batch, D = [dmu | dlv] (M x 2N), which each CTA forms
// itself from the cotangents while its x and W slices land (cp.async; dW
// runs while W is still on its way).  The batch runs in as few blocks of
// rows as shared memory allows (one at every sampling site), so it has no
// ceiling: each block's D and x tiles replace the last one's, W stays.
// Every sum runs in a fixed order: dx over the 2N columns of D, dW and db
// over the batch, one chain in row order that each block takes up from the
// output where the last one left it.  The first row of CTAs also writes db.
//
// Shapes: any M; N up to 656, past which the W tile and 8 rows of D
// outgrow shared memory (the wrapper checks).  16-byte
// copies need K * the element size a multiple of 16 bytes and 16-byte
// aligned tensors; other shapes load their tiles with plain loads (the same
// arithmetic).
#include "hopper.cuh"
#include "philox.cuh"

namespace mmvae {
namespace {

constexpr int HS_THREADS = 256;  // 8 warps
constexpr int HS_WARPS = HS_THREADS / 32;
constexpr int HS_UNROLL = 8;     // global loads in flight a thread in the backward's prologue

// forward
constexpr int FW_MT = 64;        // rows of x a CTA owns
constexpr int FW_NT = 8;         // latent columns a CTA owns (16 weight rows)
constexpr int FW_KC = 128;       // K chunk a ring slot holds
constexpr int FW_STAGES = 4;
constexpr int FW_MAX_SPLIT = 8;    // CTAs splitting K
constexpr int FW_WS = FW_KC + 4;          // weight row stride (floats): 528 bytes
constexpr int FW_LV_OFF = 16;             // logvar rows start 64 bytes later: other banks
constexpr int FW_WFLOATS = 2 * FW_NT * FW_WS + FW_LV_OFF;
constexpr int FW_RS = 2 * FW_NT + 1;      // row stride of the warps' partials (floats)

// backward
constexpr int BW_KT = 32;        // K columns a CTA owns
constexpr int BW_FILL = 132;     // CTAs that fill the card (one per SM)
constexpr int BW_MAX_PARTS = 32;
constexpr int BW_SMEM = 232448;  // shared bytes a block can use on the H100

__host__ __device__ constexpr int fw_xs(int esize) { return FW_KC + 16 / esize; }
__host__ __device__ constexpr int fw_stage_bytes(int esize) {
  return FW_MT * fw_xs(esize) * esize + FW_WFLOATS * 4;
}
__host__ __device__ constexpr int fw_smem(int esize) {
  return FW_STAGES * fw_stage_bytes(esize);
}
static_assert(fw_stage_bytes(2) % 16 == 0 && fw_stage_bytes(4) % 16 == 0, "slot alignment");
static_assert(HS_WARPS * FW_MT * FW_RS * 4 <= FW_STAGES * fw_stage_bytes(2),
              "the warps' partials alias the ring");

// Backward geometry (shared with ops/head_kernels.py::head_geometry).  The
// batch runs in blocks of mr rows: the whole batch where its D and x tiles
// fit beside W, else the fewest blocks that fit, of equal size.
struct BwdGeo {
  int mr, ds, wr, xs, smem;  // rows of a D / x block, D row stride, weight rows, x row stride
};
__host__ __device__ inline BwdGeo bwd_geo(int M, int N, int esize) {
  BwdGeo g;
  g.ds = (2 * N + 7) / 8 * 8 + 4;
  g.wr = (2 * N + 7) / 8 * 8;
  g.xs = BW_KT + 16 / esize;
  const int fixed = g.wr * (BW_KT + 4) * 4, row = g.ds * 4 + g.xs * esize;
  int cap = (BW_SMEM - fixed) / row / 8 * 8;
  cap = cap < 8 ? 8 : cap;  // N too large: the launch refuses the shared bytes
  const int blocks = (M + cap - 1) / cap;
  g.mr = ((M + blocks - 1) / blocks + 7) / 8 * 8;
  g.smem = fixed + g.mr * row;
  return g;
}

inline int bw_tiles(int K) { return (K + BW_KT - 1) / BW_KT; }
inline int bw_parts(int K) {
  const int p = BW_FILL / bw_tiles(K);
  return p < 1 ? 1 : p > BW_MAX_PARTS ? BW_MAX_PARTS : p;
}

inline int fw_splits(int K) {
  const int c = (K + FW_KC - 1) / FW_KC;
  return c < 1 ? 1 : c > FW_MAX_SPLIT ? FW_MAX_SPLIT : c;
}
inline int fw_slice(int K, int cs) {
  const int per = (K + cs - 1) / cs;
  return (per + FW_KC - 1) / FW_KC * FW_KC;
}

template <typename X>
__device__ __forceinline__ void load4(float (&v)[4], const X* p);
template <>
__device__ __forceinline__ void load4<float>(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(float (&v)[4], const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xFFFF0000u);
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

// One K chunk of this CTA's slice into ring slot `slot`, zeros past K, M
// and N: 16-byte cp.async by every thread (VEC), or plain loads.
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
        cp_async16(ws + (lv ? FW_NT * FW_WS + FW_LV_OFF : 0) + j * FW_WS + 4 * p,
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
      ws[(lv ? FW_NT * FW_WS + FW_LV_OFF : 0) + j * FW_WS + k] =
          j < wrows && k < kv ? (lv ? w_lv : w_mu)[(size_t)(j0 + j) * K + kc0 + k] : 0.f;
    }
  }
}

// One 4-deep K step of a lane's 4 x 8 tile: rows rg + 16 r of x (`xr` at
// row rg), the lane's 8 weight rows (`ws`).
template <typename X>
__device__ __forceinline__ void fw_kstep(float (&acc)[4][8], const X* xr, const float* ws,
                                         int kk) {
  constexpr int XS = fw_xs(sizeof(X));
  float xv[4][4], wv[8][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) load4<X>(xv[r], xr + 16 * r * XS + kk);
#pragma unroll
  for (int j = 0; j < 8; ++j) load4<float>(wv[j], ws + j * FW_WS + kk);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv[r][q], wv[j][q], acc[r][j]);
}

// grid (K splits, N tiles, M tiles); `partials` holds (tiles, splits, 64,
// 16) floats, `tickets` one int a tile, zero between launches.  Two launches
// in flight at once must not share `tickets` (the wrapper keeps one buffer
// a stream).
template <typename X, bool VEC>
__global__ void __launch_bounds__(HS_THREADS)
head_sample_fwd_kernel(const X* __restrict__ x, const float* __restrict__ w_mu,
                       const float* __restrict__ b_mu, const float* __restrict__ w_lv,
                       const float* __restrict__ b_lv, const float* __restrict__ eps,
                       float* __restrict__ mu, float* __restrict__ logvar,
                       float* __restrict__ z, float* __restrict__ diff,
                       float* __restrict__ partials, int* __restrict__ tickets, int M, int K,
                       int N, int kslice, SeedArg sa) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int XS = fw_xs(sizeof(X));
  constexpr int STAGE = fw_stage_bytes(sizeof(X));
  const int rank = blockIdx.x, nrank = gridDim.x, tile = blockIdx.z * gridDim.y + blockIdx.y;
  const int j0 = blockIdx.y * FW_NT, m0 = blockIdx.z * FW_MT;
  float* mine = partials + ((size_t)tile * nrank + rank) * FW_MT * 2 * FW_NT;  // [64][16]
  const int kbeg = min(K, rank * kslice), kend = min(K, kbeg + kslice);
  const int nch = (kend - kbeg + FW_KC - 1) / FW_KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane >> 1, cg = lane & 1;  // rows rg + 16r; weight rows 8cg + j

  // chunks 0..S-2 in flight; chunk c + S - 1 is issued once chunk c landed
  for (int c = 0; c < FW_STAGES - 1; ++c) {
    if (c < nch)
      fw_load<X, VEC>(smem + c * STAGE, x, w_mu, w_lv, M, K, N, m0, j0, kbeg + c * FW_KC, kend);
    cp_async_commit();
  }

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;

  for (int c = 0; c < nch; ++c) {
    cp_async_wait<FW_STAGES - 2>();
    __syncthreads();  // chunk c is in for every thread; slot (c - 1) % S is free
    const int cn = c + FW_STAGES - 1;
    if (cn < nch)
      fw_load<X, VEC>(smem + (cn % FW_STAGES) * STAGE, x, w_mu, w_lv, M, K, N, m0, j0,
                      kbeg + cn * FW_KC, kend);
    cp_async_commit();
    const int s = c % FW_STAGES;
    const X* xs = reinterpret_cast<const X*>(smem + s * STAGE);
    const float* ws = reinterpret_cast<const float*>(smem + s * STAGE + FW_MT * XS * sizeof(X)) +
                      (cg ? FW_NT * FW_WS + FW_LV_OFF : 0);
    const int kv4 = (min(FW_KC, kend - kbeg - c * FW_KC) + 3) & ~3;  // zeros up to here
    constexpr int PER = FW_KC / HS_WARPS;  // each warp's K of the chunk
    const int klo = warp * PER, khi = min(klo + PER, kv4);
    if (khi - klo == PER) {  // unrolled: the next step's loads go out under this one's FMAs
#pragma unroll
      for (int kk = 0; kk < PER; kk += 4) fw_kstep<X>(acc, xs + rg * XS, ws, klo + kk);
    } else {
      for (int kk = klo; kk < khi; kk += 4) fw_kstep<X>(acc, xs + rg * XS, ws, kk);
    }
  }
  __syncthreads();  // the ring is free

  // the warps' partials, summed in warp order, in the ring: [warp][64][17]
  // (17 floats a row: the lanes' stores fall on other banks)
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[(warp * FW_MT + rg + 16 * r) * FW_RS + 8 * cg + j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < FW_MT * 2 * FW_NT; i += HS_THREADS) {
    const int row = i / (2 * FW_NT), col = i % (2 * FW_NT);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < HS_WARPS; ++w) s += red[(w * FW_MT + row) * FW_RS + col];
    mine[i] = s;
  }
  // The CTA that finishes last (an integer ticket a tile) sums the ranks'
  // partials in rank order and writes the tile.
  __shared__ int last;
  __threadfence();  // this rank's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[tile], 1) == nrank - 1;
  __syncthreads();
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
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// grid (ceil(K / 32), parts); CTAs (b, *) own columns [32 b, 32 b + 32) of
// K and share its dx and dW tiles between them (parts > 1 only where K has
// too few columns of 32 to fill the card).  The batch runs in blocks of
// geo.mr rows: each block's D and x tiles replace the last one's in shared
// memory; dW and db carry their running sums from block to block through
// the output itself, each element always by the same thread, so every sum
// over the batch is one chain in row order whatever the block size.
template <typename X, bool VEC>
__global__ void __launch_bounds__(HS_THREADS)
head_sample_bwd_kernel(const X* __restrict__ x, const float* __restrict__ w_mu,
                       const float* __restrict__ w_lv, const float* __restrict__ diff,
                       const float* __restrict__ g_mu, const float* __restrict__ g_lv,
                       const float* __restrict__ g_z, X* __restrict__ dx,
                       float* __restrict__ dw_mu, float* __restrict__ dw_lv,
                       float* __restrict__ db_mu, float* __restrict__ db_lv, int M, int K,
                       int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdGeo geo = bwd_geo(M, N, sizeof(X));
  constexpr int WS = BW_KT + 4;
  float* D = reinterpret_cast<float*>(smem);                       // [mr][ds]
  float* W = D + geo.mr * geo.ds;                                  // [wr][WS]: W_mu, W_lv
  X* xs = reinterpret_cast<X*>(W + geo.wr * WS);                   // [mr][xs]
  const int k0 = blockIdx.x * BW_KT, kv = min(BW_KT, K - k0), n2 = 2 * N;
  const int tid = threadIdx.x;
  const int first = blockIdx.y * HS_THREADS + tid, stride = gridDim.y * HS_THREADS;

  for (int r0 = 0; r0 < M; r0 += geo.mr) {
    const int rows = min(geo.mr, M - r0), head = r0 == 0;
    if (!head) __syncthreads();  // the last block's D and x are read
    // this block's x tile and, with the first block, the W tile, zeros past
    // K, 2N and the block's rows (the dx sums read them): 16-byte cp.async
    // by every thread (VEC), landing under the prologue, or plain loads
    if (VEC) {  // x first (dW needs it first), then W: two groups
      constexpr int WP = BW_KT * 4 / 16, XP = BW_KT * sizeof(X) / 16;  // 16-byte pieces a row
      for (int i = tid; i < geo.mr * XP; i += HS_THREADS) {
        const int r = i / XP, p = i % XP;
        const bool ok = r < rows && p * 16 < kv * (int)sizeof(X);
        cp_async16(reinterpret_cast<unsigned char*>(xs + r * geo.xs) + 16 * p,
                   x + (size_t)(r0 + (ok ? r : 0)) * K + k0 + (ok ? p * 16 / sizeof(X) : 0), ok);
      }
      cp_async_commit();
      if (head) {
        for (int i = tid; i < geo.wr * WP; i += HS_THREADS) {
          const int r = i / WP, p = i % WP;
          const bool ok = r < n2 && p * 4 < kv;
          const float* src = (r < N ? w_mu + (size_t)r * K : w_lv + (size_t)(ok ? r - N : 0) * K);
          cp_async16(W + r * WS + 4 * p, src + k0 + (ok ? 4 * p : 0), ok);
        }
        cp_async_commit();
      }
    } else {
      if (head) {
        for (int i = tid; i < geo.wr * BW_KT; i += HS_THREADS) {
          const int r = i / BW_KT, k = i % BW_KT;
          float v = 0.f;
          if (r < n2 && k < kv)
            v = (r < N ? w_mu + (size_t)r * K : w_lv + (size_t)(r - N) * K)[k0 + k];
          W[r * WS + k] = v;
        }
      }
      for (int i = tid; i < geo.mr * BW_KT; i += HS_THREADS) {
        const int m = i / BW_KT, k = i % BW_KT;
        xs[m * geo.xs + k] = m < rows && k < kv ? x[(size_t)(r0 + m) * K + k0 + k] : from_f<X>(0.f);
      }
    }
    // the prologue, under the copies: D = [dmu | dlv] of the block's rows.
    // Each thread loads the cotangents of HS_UNROLL elements before it
    // writes any, so their L2 round trips overlap.
    const int mn = rows * N, dm = HS_THREADS / N, dn = HS_THREADS % N;
    const size_t e0 = (size_t)r0 * N;
    int m = tid / N, n = tid % N;  // element base + u * HS_THREADS, advanced in step
    for (int base = tid; base < mn; base += HS_THREADS * HS_UNROLL) {
      float gm[HS_UNROLL], gl[HS_UNROLL], gz[HS_UNROLL], df[HS_UNROLL];
#pragma unroll
      for (int u = 0; u < HS_UNROLL; ++u) {
        const int e = base + u * HS_THREADS;
        const bool ok = e < mn;
        gm[u] = ok && g_mu ? g_mu[e0 + e] : 0.f;
        gl[u] = ok && g_lv ? g_lv[e0 + e] : 0.f;
        gz[u] = ok && g_z ? g_z[e0 + e] : 0.f;
        df[u] = ok && g_z ? diff[e0 + e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < HS_UNROLL; ++u) {
        if (base + u * HS_THREADS < mn) {
          D[m * geo.ds + n] = __fadd_rn(gm[u], gz[u]);
          D[m * geo.ds + N + n] = __fadd_rn(gl[u], __fmul_rn(__fmul_rn(0.5f, gz[u]), df[u]));
        }
        m += dm;
        n += dn;
        if (n >= N) {
          n -= N;
          ++m;
        }
      }
    }
    // zeros past 2N and the block's rows: the dx sums read them
    const int padc = geo.ds - n2;
    for (int i = tid; i < geo.mr * padc; i += HS_THREADS) D[i / padc * geo.ds + n2 + i % padc] = 0.f;
    for (int i = tid; i < (geo.mr - rows) * n2; i += HS_THREADS)
      D[(rows + i / n2) * geo.ds + i % n2] = 0.f;
    if (head)
      cp_async_wait<1>();  // x has landed (W may still be on its way)
    else
      cp_async_wait<0>();
    __syncthreads();
    // db, as batch sums in row order, spread over the first row of CTAs
    if (blockIdx.y == 0) {
      for (int c = blockIdx.x + tid * gridDim.x; c < n2; c += HS_THREADS * gridDim.x) {
        float* out = (c < N ? db_mu : db_lv) + (c < N ? c : c - N);
        float sum = head ? 0.f : *out;
        for (int r = 0; r < rows; ++r) sum += D[r * geo.ds + c];
        *out = sum;
      }
    }

    // dW[n][k] += sum over the block's rows m of D[m][n] x[m][k]: 8 x 8 tiles
    const int dw_items = geo.wr / 8 * (BW_KT / 8);
    for (int it = first; it < dw_items; it += stride) {
      const int kg = it % (BW_KT / 8), ng = it / (BW_KT / 8);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nn = 8 * ng + i;
        const float* row = (nn < N ? dw_mu + (size_t)nn * K : dw_lv + (size_t)(nn - N) * K) + k0;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[i][c] = !head && nn < n2 && 8 * kg + c < kv ? row[8 * kg + c] : 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        float dv[8], xv[8];
        load4<float>(*reinterpret_cast<float(*)[4]>(dv), D + r * geo.ds + 8 * ng);
        load4<float>(*reinterpret_cast<float(*)[4]>(dv + 4), D + r * geo.ds + 8 * ng + 4);
        load4<X>(*reinterpret_cast<float(*)[4]>(xv), xs + r * geo.xs + 8 * kg);
        load4<X>(*reinterpret_cast<float(*)[4]>(xv + 4), xs + r * geo.xs + 8 * kg + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(dv[i], xv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nn = 8 * ng + i;
        if (nn >= n2) continue;
        float* row = (nn < N ? dw_mu + (size_t)nn * K : dw_lv + (size_t)(nn - N) * K) + k0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * kg + 4 * h;
          if (VEC) {  // K % 4 == 0 and the tensors 16-byte aligned
            if (k < kv)
              *reinterpret_cast<float4*>(row + k) = make_float4(
                  acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (k + c < kv) row[k + c] = acc[i][4 * h + c];
          }
        }
      }
    }
    if (head) {
      cp_async_wait<0>();  // W has landed
      __syncthreads();
    }

    // dx[m][k] = sum over n < 2N of D[m][n] W[n][k] for the block's rows: 4 x 4 tiles
    const int dx_items = (rows + 3) / 4 * (BW_KT / 4);
    for (int it = first; it < dx_items; it += stride) {
      const int kg = it % (BW_KT / 4), mg = it / (BW_KT / 4);
      float acc[4][4] = {};
#pragma unroll 2
      for (int n = 0; n < n2; n += 4) {
        float dv[4][4], wv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) load4<float>(dv[r], D + (4 * mg + r) * geo.ds + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) load4<float>(wv[q], W + (n + q) * WS + 4 * kg);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(dv[r][q], wv[q][c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int mm = 4 * mg + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * kg + c;
          if (mm < rows && k < kv) dx[(size_t)(r0 + mm) * K + k0 + k] = from_f<X>(acc[r][c]);
        }
      }
    }
  }
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
                       void* dw_lv, void* db_mu, void* db_lv, int M, int K, int N,
                       cudaStream_t stream) {
  const void* kern = (const void*)head_sample_bwd_kernel<X, VEC>;
  const int smem = bwd_geo(M, N, sizeof(X)).smem;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  head_sample_bwd_kernel<X, VEC><<<dim3(bw_tiles(K), bw_parts(K)), HS_THREADS, smem, stream>>>(
      (const X*)x, (const float*)w_mu, (const float*)w_lv, (const float*)diff,
      (const float*)g_mu, (const float*)g_lv, (const float*)g_z, (X*)dx, (float*)dw_mu,
      (float*)dw_lv, (float*)db_mu, (float*)db_lv, M, K, N);
  return cudaGetLastError();
}

template <typename X>
cudaError_t bwd(const void* x, const void* w_mu, const void* w_lv, const void* diff,
                const void* g_mu, const void* g_lv, const void* g_z, void* dx, void* dw_mu,
                void* dw_lv, void* db_mu, void* db_lv, int M, int K, int N, cudaStream_t stream) {
  if (bwd_geo(M, N, sizeof(X)).smem > BW_SMEM) return cudaErrorInvalidValue;
  const bool vec = K % (16 / (int)sizeof(X)) == 0 && aligned16(x) && aligned16(w_mu) &&
                   aligned16(w_lv) && aligned16(dw_mu) && aligned16(dw_lv);
  return vec ? bwd_launch<X, true>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                   db_mu, db_lv, M, K, N, stream)
             : bwd_launch<X, false>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                    db_mu, db_lv, M, K, N, stream);
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
    return (int)mmvae::fwd<float>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff, partials,
                                  tickets, M, K, N, seed, s);
  if (x_dtype == mmvae::kBF16)
    return (int)mmvae::fwd<__nv_bfloat16>(x, w_mu, b_mu, w_lv, b_lv, eps, mu, logvar, z, diff,
                                          partials, tickets, M, K, N, seed, s);
  return (int)cudaErrorInvalidValue;
}

// g_mu, g_lv and g_z may each be null (zeros).
int mmvae_head_sample_bwd(const void* x, const void* w_mu, const void* w_lv, const void* diff,
                          const void* g_mu, const void* g_lv, const void* g_z, void* dx,
                          void* dw_mu, void* dw_lv, void* db_mu, void* db_lv, int M, int K, int N,
                          int x_dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == mmvae::kF32)
    return (int)mmvae::bwd<float>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv, db_mu,
                                  db_lv, M, K, N, s);
  if (x_dtype == mmvae::kBF16)
    return (int)mmvae::bwd<__nv_bfloat16>(x, w_mu, w_lv, diff, g_mu, g_lv, g_z, dx, dw_mu, dw_lv,
                                          db_mu, db_lv, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}

// The launch geometry as the kernels compute it, for the wrapper to hold
// its own against: {forward K splits, forward K slice, forward shared
// bytes, backward shared bytes, backward CTAs a K tile}.
void mmvae_head_sample_layout(int M, int K, int N, int x_dtype, int* out) {
  const int esize = x_dtype == mmvae::kBF16 ? 2 : 4;
  const int splits = mmvae::fw_splits(K);
  out[0] = splits;
  out[1] = mmvae::fw_slice(K, splits);
  out[2] = mmvae::fw_smem(esize);
  out[3] = mmvae::bwd_geo(M, N, esize).smem;
  out[4] = mmvae::bw_parts(K);
}

}  // extern "C"
