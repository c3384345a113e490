// ConvLSTM recurrences on Hopper: clusters of 2 or 4 CTAs per sample, wgmma
// with A gathered into registers and B streamed through a shared-memory ring
// by bulk copies, and the deterministic weight-gradient GEMM on wgmma.  K5
// (convlstm_proj.cu) and K6 (convlstm_scan.cu) instantiate the same kernels:
// K5 with x_t and its 1x1 projection as the first K segment and the bias in
// the accumulator; K6 with C = 0 and the precomputed xg_t added in the gate
// epilogue (XG), its BPTT without dx and dbx (!PROJ).
//
// Layout of the recurrent kernels: a cluster of CL CTAs per sample b (CL =
// rec_cluster(F): 2 up to F = 128, 4 for F in (128, 256], where two CTAs'
// weight slabs, residual staging and rings no longer fit); CTA k of the
// cluster owns channels [k HF, (k+1) HF) of all four gates (HF = F/CL of
// each, 4 HF gate columns), so the cell math stays inside the CTA.  The
// consumer warpgroups come first (the forward's two, each with its own
// channels, where HF is a multiple of 16; the BPTT's one), then the producer
// warp, whose lane 0 streams the CTA's weight slabs, step after step, into a
// ring of `stages` slots (full / empty mbarriers).  Each CTA keeps the
// operand tile of the recurrence (h in the forward, dgates in the backward)
// whole: it writes its own columns into its own tile and, through
// distributed shared memory, into each peer's, and all CL CTAs arrive on
// mbarriers of every CTA of the cluster.
//
// Accumulator of warp w, lane (g = lane/4, tq = lane%4): the m64nN tile's
// d[4j + 2hr + e] = row 16w + g + 8hr, local column 8j + 2tq + e.  In the
// forward, warpgroup wg owns HFW = HF / wgs of the CTA's channels; a cell
// (hr, j8 < HFW/8, e) is position 16w + g + 8hr and channel rank HF + wg HFW
// + 8j8 + 2tq + e; its gate q sits in 8-column group q HFW/8 + j8 of the
// warpgroup's 4 HFW columns.  In the BPTT (one warpgroup, N = HF), column
// 8j8 + 2tq + e of the accumulator is channel rank HF + 8j8 + 2tq + e.
//
// The activation type A is bf16 or f32 (F <= 128, convlstm_proj_f32.cu,
// convlstm_scan_f32.cu).  f32 products are 3xTF32 (hopper.cuh): k8 steps,
// A fragments split into TF32 parts as the threads gather them with 32-bit
// loads, each weight's TF32 hi and lo parts in the ring (8 bytes), each
// slab summed apart and added into f32 registers (the tensor cores' own
// additions truncate); the f32 tiles are twice the bf16 ones, so the
// residuals leave and come back through registers and nothing is staged.
// K5 rounds the x segment's sum (with the bias) and the taps' to the gate
// dtype apart before adding them, as the TPU kernel does (bf16 K5 keeps its
// x segment as packed bf16 pairs while the taps run), and K6 rounds xg to
// it before adding it to the taps.
#pragma once

#include <type_traits>

#include "convlstm_tiles.cuh"
#include "hopper.cuh"

namespace mmvae {
namespace {

constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one CTA may use
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;
// K6's BPTT with a time-constant xg keeps the f32 sum of its dgates beside
// the ring (64 KB at F = 128), which leaves room for 3 slots of 16 KB.
constexpr int SCAN_BWD_MIN_STAGES = 3;
constexpr int FWD_ROWS = 32;   // weight rows (K) per forward stage
constexpr int BWD_ROWS = 128;  // per backward stage (half that with 4 CTAs a sample)
constexpr int DX_BLOCK = 64;   // dx columns per wgmma block (zero-padded)
// f32 activations (F <= 128, 2-CTA clusters): each weight is two TF32
// parts in the ring (8 bytes), so a slot holds fewer rows: one k8 step in
// the forward, four in the BPTT.
constexpr int FWD_ROWS_F32 = 8, BWD_ROWS_F32 = 32;

// Forward output modes: residuals for a backward (hs, cs, gates), every h_t
// and c_T, or h_T and c_T.  K5 runs kSave and kLast.
enum RecMode : int { kSave = 0, kHiddens = 1, kLast = 2 };

// CTAs a sample: 2 up to F = 128; 4 beyond (F a multiple of 32 up to 256),
// which halves each CTA's weight slabs and residual staging while its
// operand tiles stay whole.
__host__ __device__ constexpr int rec_cluster(int F) { return F > 128 ? 4 : 2; }
// Consumer warpgroups of a recurrent CTA: two when each can own a multiple
// of 8 of the CTA's F/CL channels, so that two latency chains share the SM;
// one otherwise.  Plus one producer warp.
__host__ __device__ constexpr int rec_wgs(int F) { return (F / rec_cluster(F)) % 16 == 0 ? 2 : 1; }
__host__ __device__ constexpr int rec_threads(int F) { return 128 * rec_wgs(F) + 32; }
// The BPTT's one consumer warpgroup (a second, splitting its m64n64
// products in two, ran slower on the H100) and its producer warp.
constexpr int BWD_CONS = 128, BWD_THREADS = BWD_CONS + 32;
// Weight rows a BPTT stage: 4-CTA clusters hold the whole (65, 4F) dgates
// tile beside their ring, which leaves room for enough slots only at half
// the rows.  `es` is the activations' element size: 2 (bf16) or 4 (f32).
__host__ __device__ constexpr int bwd_rows(int F, int es = 2) {
  return es == 4 ? BWD_ROWS_F32 : rec_cluster(F) == 2 ? BWD_ROWS : BWD_ROWS / 2;
}
// Ring bytes of one weight: bf16, or an f32 weight's TF32 hi and lo parts
// (a slot holds the hi slab, then the lo slab).
__host__ __device__ constexpr int weight_bytes(int es) { return es == 4 ? 8 : 2; }

__host__ __device__ inline int round128(int v) { return (v + 127) / 128 * 128; }

// Forward shared memory: [barriers 256 | bias 1024 | ring | x tiles x2 |
// h tiles x2 | residual staging (hs, cs, gates of the CTA's channels)].
// K5's x tiles hold x_t and x_{t+1} (a zero row for absent positions; rows
// padded by 16 bytes); K6 has none (x_tiles false): its threads hold their
// cells of xg in registers.  A slot holds FWD_ROWS rows (FWD_ROWS_F32 with
// f32 activations) of the CTA's 4F/CL gate columns.  With f32 activations
// (es = 4) the residuals leave from registers, 32 bytes a row of 8
// channels, and nothing is staged.
struct FwdSmem {
  int ring, xt, ht, stage, slot, xtile, htile, stages, total;
};
__host__ __device__ inline FwdSmem fwd_smem_layout(int C, int F, bool x_tiles = true,
                                                   int es = 2) {
  FwdSmem s;
  const int HF = F / rec_cluster(F);
  const int staging = es == 2 ? MROWS * 6 * HF * 2 : 0;
  s.slot = (es == 2 ? FWD_ROWS : FWD_ROWS_F32) * 4 * HF * weight_bytes(es);
  s.xtile = x_tiles ? round128((MROWS + 1) * (C + 16 / es) * es) : 0;
  s.htile = round128((MROWS + 1) * F * es);
  const int fixed = 1280 + 2 * s.xtile + 2 * s.htile + staging;
  s.stages = (SMEM_LIMIT - fixed) / s.slot;
  s.stages = s.stages > MAX_STAGES ? MAX_STAGES : s.stages;
  s.ring = 1280;
  s.xt = s.ring + s.stages * s.slot;
  s.ht = s.xt + 2 * s.xtile;
  s.stage = s.ht + 2 * s.htile;
  s.total = s.stage + staging;
  return s;
}

// Backward shared memory: [barriers 256 | ring | dgates tile | residuals
// (c_t, c_{t-1}, gates of the CTA's channels) | tail].  K5: slots of
// bwd_rows x DX_BLOCK (its dx blocks are its widest products), the tail its
// dbx warp partials.  K6: slots of bwd_rows x F/CL; the tail, for a
// time-constant xg in a 2-CTA cluster with bf16 activations, the f32 sum
// over t of the dgates of the CTA's 4F/CL columns (none when streaming; a
// 4-CTA cluster, or f32 activations, keep that sum in global memory, see
// rec_bwd_wgmma_kernel).  With f32 activations the threads read their
// residuals from global memory, and nothing is staged.
struct BwdSmem {
  int ring, dg, res, tail, slot, stages, total;
};
__host__ __device__ inline BwdSmem bwd_layout(int F, int slot, int tail, int es = 2) {
  BwdSmem s;
  s.slot = slot;
  const int HF = F / rec_cluster(F);
  const int dg = round128((MROWS + 1) * 4 * F * es);
  const int res = es == 2 ? MROWS * 6 * HF * 2 : 0;
  const int fixed = 256 + dg + res + tail;
  s.stages = (SMEM_LIMIT - fixed) / s.slot;
  s.stages = s.stages > MAX_STAGES ? MAX_STAGES : s.stages;
  s.ring = 256;
  s.dg = s.ring + s.stages * s.slot;
  s.res = s.dg + dg;
  s.tail = s.res + res;
  s.total = s.tail + tail;
  return s;
}
__host__ __device__ inline BwdSmem bwd_smem_layout(int F, int es = 2) {
  const int HF = F / rec_cluster(F);
  return bwd_layout(F, bwd_rows(F, es) * DX_BLOCK * weight_bytes(es), 4 * 4 * HF * 4, es);
}
// Whether K6's BPTT keeps a time-constant xg's f32 dgates sum in shared memory.
__host__ __device__ constexpr bool scan_sum_in_smem(int F, bool const_x, int es = 2) {
  return const_x && rec_cluster(F) == 2 && es == 2;
}
__host__ __device__ inline BwdSmem scan_bwd_smem_layout(int F, bool const_x, int es = 2) {
  const int HF = F / rec_cluster(F);
  return bwd_layout(F, bwd_rows(F, es) * HF * weight_bytes(es),
                    scan_sum_in_smem(F, const_x, es) ? MROWS * 4 * HF * 4 : 0, es);
}
// The fewest ring stages a K6 BPTT takes.
__host__ __device__ constexpr int scan_bwd_min_stages(int F, bool const_x, int es = 2) {
  return scan_sum_in_smem(F, const_x, es) ? SCAN_BWD_MIN_STAGES : MIN_STAGES;
}

// The activation type's pieces: element size, a pair of adjacent channels
// as one register-held value (bf16x2 in 32 bits, or float2) and its f32
// values.
template <typename A>
constexpr bool is_f32_v = std::is_same<A, float>::value;
template <typename A>
using Pair = std::conditional_t<is_f32_v<A>, float2, uint32_t>;
__device__ __forceinline__ float2 pair_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 pair_f2(float2 v) { return v; }
template <typename A>
__device__ __forceinline__ Pair<A> pair_of(float lo, float hi) {
  if constexpr (is_f32_v<A>) return make_float2(lo, hi);
  else return pack_bf16(lo, hi);
}
// Store a pair at `own` (this CTA's tile) and at the same place in the
// peers' tiles (cluster addresses of their bases), as one store each.
template <typename A, int NPEER>
__device__ __forceinline__ void store_pair_cluster(A* own, const A* base,
                                                   const uint32_t (&peer)[NPEER], Pair<A> v) {
  *reinterpret_cast<Pair<A>*>(own) = v;
  const uint32_t off = (uint32_t)((own - base) * sizeof(A));
#pragma unroll
  for (int k = 0; k < NPEER; ++k) {
    if constexpr (is_f32_v<A>) st_cluster_f2(peer[k] + off, v);
    else st_cluster_b32(peer[k] + off, v);
  }
}

// One f32 k8 step's A fragment (columns k..k+7) from the operand rows of
// positions 16w + g and 16w + g + 8, split into its TF32 hi and lo parts
// (see hopper.cuh's TF32 wgmma): from a swizzled tile, or from plain rows.
__device__ __forceinline__ void frag_f32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const SwzTileT<float>& t, int row0, int row1, int k,
                                         int tq) {
  tf32_split(*t.at(row0, k + tq), hi[0], lo[0]);
  tf32_split(*t.at(row1, k + tq), hi[1], lo[1]);
  tf32_split(*t.at(row0, k + tq + 4), hi[2], lo[2]);
  tf32_split(*t.at(row1, k + tq + 4), hi[3], lo[3]);
}
__device__ __forceinline__ void frag_f32(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* row0,
                                         const float* row1, int k, int tq) {
  tf32_split(row0[k + tq], hi[0], lo[0]);
  tf32_split(row1[k + tq], hi[1], lo[1]);
  tf32_split(row0[k + tq + 4], hi[2], lo[2]);
  tf32_split(row1[k + tq + 4], hi[3], lo[3]);
}
// Hands the A fragments of a slab to the wait that ends its products (see
// keep_regs4).
template <int KS>
__device__ __forceinline__ void keep_frags(const uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i) keep_regs4(a[i]);
}

// The LSTM cell with the pointwise chain rounded to the gate dtype G as
// torch's ops in G round, from pre-activations already rounded to G, and its
// f32 backward from the saved post-activation gates.  The sigmoid is the TPU
// kernel's 1 / (1 + exp(-v)) with every op rounded to G
// (convlstm_pallas.py:155-159; with G = float the roundings are no-ops).
// The exponential and the reciprocal come from the special-function unit
// (__expf, __fdividef): a few f32 ulps, far below the bf16 rounding that
// follows, and about a fifth of the instructions of IEEE expf, division and
// tanhf, which matters here because one warpgroup of a CTA runs the whole
// cell between two steps.
template <typename G>
__device__ __forceinline__ float sigm_fast(float v) {
  return round_to<G>(__fdividef(1.f, round_to<G>(1.f + round_to<G>(__expf(-v)))));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}
template <typename G>
__device__ __forceinline__ Cell lstm_cell_fast(float pi, float pf, float pg, float po, float c) {
  Cell r;
  r.i = sigm_fast<G>(pi);
  r.f = sigm_fast<G>(round_to<G>(pf + 1.f));
  r.g = round_to<G>(tanh_fast(pg));
  r.o = sigm_fast<G>(po);
  r.c = round_to<G>(round_to<G>(r.f * c) + round_to<G>(r.i * r.g));
  r.h = round_to<G>(r.o * round_to<G>(tanh_fast(r.c)));
  return r;
}
// dgates (i, f, g, o pre-activation) into gq; returns dc_{t-1}.
__device__ __forceinline__ float lstm_cell_bwd_fast(float dh, float dc, float ct, float cp,
                                                    float ai, float af, float ag, float ao,
                                                    float (&gq)[4]) {
  const float th = tanh_fast(ct);
  const float d_o = dh * th;
  const float dct = dc + dh * ao * (1.f - th * th);
  gq[0] = dct * ag * ai * (1.f - ai);
  gq[1] = dct * cp * af * (1.f - af);
  gq[2] = dct * ai * (1.f - ag * ag);
  gq[3] = d_o * ao * (1.f - ao);
  return dct * af;
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// The forward's accumulator from the bias of its columns (accumulator
// layout: column 8j + 2tq + e in d[4j + 2hr + e]).
template <int NA>
__device__ __forceinline__ void bias_init(float (&d)[NA], const float* bias, int tq) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(&bias[8 * j + 2 * tq]);
    d[4 * j + 0] = bv.x;
    d[4 * j + 1] = bv.y;
    d[4 * j + 2] = bv.x;
    d[4 * j + 3] = bv.y;
  }
}

// One f32 forward slab (ROWS = FWD_ROWS_F32 = one k8 step): wait for ring
// slot `slot`, part = the fragment (ah + al, TF32 parts) against the slot's
// hi and lo slabs at column byte offset `col`, wait for the products, dst
// += part, hand the slot back.
template <int NW, int N, int ROWS>
__device__ __forceinline__ void fwd_slab_f32(float (&dst)[NW / 2], float (&part)[NW / 2],
                                             const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                             uint64_t* full, uint64_t* empty, int& slot,
                                             uint32_t& ph, int stages, const unsigned char* ring,
                                             int slot_bytes, uint32_t col, int lane) {
  static_assert(ROWS == 8, "one k8 step a forward slab");
  mbar_wait(&full[slot], ph);
  const uint32_t slot_addr = smem_u32(ring + slot * slot_bytes);
  wgmma_fence();
  wgmma_3xtf32<NW>(part, ah, al, smem_desc(slot_addr + col, N * 16, 128),
                   smem_desc(slot_addr + ROWS * N * 4 + col, N * 16, 128), 128, 0);
  wgmma_commit();
  wgmma_wait<0>();
  keep_regs4(ah);
  keep_regs4(al);
  promote_slab(dst, part);
  if (lane == 0) mbar_arrive(&empty[slot]);
  if (++slot == stages) {
    slot = 0;
    ph ^= 1;
  }
}

// All T steps of sample blockIdx.x / CL.  K5 (!XG): gates_t = x_t @ Wx + bx +
// conv3x3(h_{t-1}, W), x (B, T, HW, C).  K6 (XG, C = 0): gates_t =
// G(G(conv3x3(h_{t-1}, W)) + xg_t) with xg (B, xg_steps, HW, 4F), read at
// step 0 throughout when xg_steps is 1 (a time-constant input); each
// consumer thread loads its cells of xg_{t+1} into registers once it has
// used those of xg_t, so the loads run under a whole step's products (a
// time-constant xg is loaded once).  wpk: per cluster rank, the CTA's 4F/CL
// columns of [Wx; W] (K = C + 9F rows) packed as K-major cores
// [K/8][4F/CL/8][8][8]; with f32 activations (A = float) the TF32 hi parts
// as cores [K/4][4F/CL/8][8][4] for every rank, then the lo parts, and the
// products 3xTF32.  Launched in clusters of CL (cluster_launch).
template <typename A, typename G, int MODE, int F, bool XG>
__global__ void __launch_bounds__(rec_threads(F), 1)
    rec_fwd_wgmma_kernel(const A* __restrict__ x, const A* __restrict__ wpk,
                         const A* __restrict__ bx, const A* __restrict__ c0,
                         const A* __restrict__ h0, A* __restrict__ out_h,
                         A* __restrict__ out_c, A* __restrict__ out_g, int Tn, int H, int W,
                         int C, int xg_steps) {
  // Warpgroup wg owns HFW of the CTA's HF channels, all four gates: NW of
  // the CTA's N gate columns, which the packing puts together.
  constexpr bool F32 = is_f32_v<A>;
  constexpr int ES = sizeof(A), E = 16 / ES;      // bytes an element, elements a 16-byte chunk
  constexpr int CL = rec_cluster(F);
  constexpr int NWG = rec_wgs(F), NCONS = 128 * NWG, NTHREADS = NCONS + 32;
  constexpr int HF = F / CL, HFW = HF / NWG, N = 4 * HF, NW = N / NWG;
  constexpr int J8 = HFW / 8, JC = HF / 8, NCELL = HFW / 2;
  constexpr int ROWS = F32 ? FWD_ROWS_F32 : FWD_ROWS;
  constexpr int SEG0 = XG ? 1 : 0;                // K6 has no x segment
  constexpr int NSTAGED = MODE == kSave ? 6 : 1;  // staged tensors (h, c, 4 gates)
  // K5 with bf16 activations and gates rounds its x segment (with the bias)
  // and its taps to bf16 apart, then adds them in bf16, as the TPU kernel
  // does (convlstm_pallas.py:408-409); with f32 gates the one f32 sum is
  // the same number
  constexpr bool SPLIT_X = !F32 && !XG && std::is_same<G, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem L = fwd_smem_layout(C, F, !XG, ES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;  // [2]
  uint64_t* hready = xfull + 2;          // [2]
  float* bias = reinterpret_cast<float*>(smem + 256);
  unsigned char* ring = smem + L.ring;
  const int xrow = C + E;
  A* xt[2] = {reinterpret_cast<A*>(smem + L.xt), reinterpret_cast<A*>(smem + L.xt + L.xtile)};
  const SwzTileT<A> ht[2] = {make_tile(reinterpret_cast<A*>(smem + L.ht), F),
                             make_tile(reinterpret_cast<A*>(smem + L.ht + L.htile), F)};
  A* st_h = reinterpret_cast<A*>(smem + L.stage);  // (64, HF); bf16 only
  A* st_c = st_h + MROWS * HF;                     // (64, HF)
  A* st_g = st_c + MROWS * HF;                     // (64, 4 HF)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, wg = warp >> 2, wq = warp & 3;
  const uint32_t rank = cluster_rank();
  const size_t b = blockIdx.x / CL;
  const int HW = H * W, K = C + 9 * F;
  const int stages = L.stages;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_init(&xfull[0], 1);
    mbar_init(&xfull[1], 1);
    mbar_init(&hready[0], CL * NCONS);  // the consumers of every CTA of the cluster
    mbar_init(&hready[1], CL * NCONS);
    mbar_init_fence();
  }
  if constexpr (!XG) {
    for (int i = tid; i < N; i += NTHREADS) {  // in the packed column order
      const int w = i / NW, q = (i - w * NW) / HFW, c = i - w * NW - q * HFW;
      bias[i] = to_f(bx[q * F + rank * HF + w * HFW + c]);
    }
  }
  // The ring starts zeroed: a slab shorter than a slot leaves older, finite
  // contents behind it, which zero A fragments then multiply.
  for (int i = tid; i < stages * L.slot / 16; i += NTHREADS)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  // Zero rows (row MROWS stands in for masked taps and absent positions).
  if constexpr (!XG) {
    for (int i = tid; i < 2 * (C + E); i += NTHREADS)
      xt[i / (C + E)][MROWS * xrow + i % (C + E)] = from_f<A>(0.f);
  }
  for (int i = tid; i < 2 * F; i += NTHREADS) *ht[i / F].at(MROWS, i % F) = from_f<A>(0.f);
  if constexpr (!XG) {
    // x_0, rounded as the reference rounds it.
    const int cch = C / E;
    for (int i = tid; i < HW * cch; i += NTHREADS)
      *reinterpret_cast<uint4*>(xt[0] + (i / cch) * xrow + (i % cch) * E) =
          *reinterpret_cast<const uint4*>(x + (b * Tn * HW + i / cch) * C + (i % cch) * E);
  }
  // h_0 (all F channels).
  for (int i = tid; i < HW * F; i += NTHREADS)
    *ht[0].at(i / F, i % F) = from_f<A>(round_to<G>(to_f(h0[b * HW * F + i])));
  cluster_sync();

  if (warp == 4 * NWG) {
    // Producer: the CTA's weight slabs, stage after stage, step after step.
    if (lane == 0) {
      const A* wsrc = wpk + (size_t)rank * K * N;
      const A* wlo = wpk + (size_t)(CL + rank) * K * N;  // f32: the TF32 lo parts
      int slot = 0;
      uint32_t ph = 0;
      // The consumers' order: K5's x segment (K = C), then the 9 taps (K =
      // F each), in ROWS-row slabs (a 16-row tail where a segment ends).
      for (int t = 0; t < Tn; ++t)
        for (int seg = SEG0; seg < 10; ++seg) {
          const int seglen = seg == 0 ? C : F, k0 = seg == 0 ? 0 : C + (seg - 1) * F;
          for (int off = 0; off < seglen; off += ROWS) {
            const uint32_t bytes = min(ROWS, seglen - off) * N * ES;
            mbar_wait(&empty[slot], ph ^ 1);
            mbar_expect_tx(&full[slot], F32 ? 2 * bytes : bytes);
            bulk_g2s(ring + slot * L.slot, wsrc + (size_t)(k0 + off) * N, bytes, &full[slot]);
            if constexpr (F32)
              bulk_g2s(ring + slot * L.slot + ROWS * N * ES, wlo + (size_t)(k0 + off) * N, bytes,
                       &full[slot]);
            if (++slot == stages) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
    }
  } else {
    // Consumers: the cell state of the CTA's cells in registers.
    float creg[NCELL];
#pragma unroll
    for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * wq + g + 8 * hr, ch = rank * HF + wg * HFW + 8 * j8 + 2 * tq + e;
          creg[(j8 * 2 + hr) * 2 + e] = r < HW ? round_to<G>(to_f(c0[(b * HW + r) * F + ch])) : 0.f;
        }
    // bf16: the position of this lane's ldmatrix row; f32: the positions of
    // the thread's fragment rows, 16 wq + g and 8 on.
    const int p = 16 * wq + (lane & 15), py = p / W, px = p % W;
    const int srow_x = p < HW ? p : MROWS;
    const int pf[2] = {16 * wq + g, 16 * wq + g + 8};
    // K6: the thread's cells of xg_t, pairs of channels, per (gate, j8, hr).
    Pair<A> xr[4][J8][2];
    auto load_xg = [&](int t) {
#pragma unroll
      for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * wq + g + 8 * hr, ch = rank * HF + wg * HFW + 8 * j8 + 2 * tq;
          const A* src = x + ((b * xg_steps + t) * HW + r) * 4 * F + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xr[q][j8][hr] = r < HW ? *reinterpret_cast<const Pair<A>*>(src + q * F) : Pair<A>{};
        }
    };
    if constexpr (XG) load_xg(0);
    // f32: each slab's products, added into acc after the slab (promote_slab)
    float part[F32 ? NW / 2 : 1];
#pragma unroll
    for (int i = 0; i < (F32 ? NW / 2 : 1); ++i) part[i] = 0.f;

    int slot = 0;
    uint32_t ph = 0;
    for (int t = 0; t < Tn; ++t) {
      const int cur = t & 1, nxt = cur ^ 1;
      if (t > 0) mbar_wait_cluster(&hready[cur], ((t - 1) >> 1) & 1);
      if constexpr (!XG) {
        if (t + 1 < Tn && warp == 0) {
          // x_{t+1} into the other x tile, one bulk copy a row.
          if (lane == 0) mbar_expect_tx(&xfull[nxt], HW * C * ES);
          __syncwarp();
          for (int r = lane; r < HW; r += 32)
            bulk_g2s(xt[nxt] + r * xrow, x + ((b * Tn + t + 1) * HW + r) * C, C * ES, &xfull[nxt]);
        }
        if (t > 0) mbar_wait(&xfull[cur], ((t - 1) >> 1) & 1);
      }

      // acc: the products, from the bias (K5) or zero (K6); f32 K5 sums the
      // taps' in acc from zero and the bias and the x segment's in xacc
      float acc[NW / 2], xacc[F32 && !XG ? NW / 2 : 1];
      uint32_t xpk[SPLIT_X ? NW / 4 : 1];
      if constexpr (XG || F32) {
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      }
      if constexpr (!XG) {
        if constexpr (F32)
          bias_init(xacc, bias + wg * NW, tq);
        else
          bias_init(acc, bias + wg * NW, tq);
      }
      fence_regs(acc);
      // The K loop: K5's x segment, then the 9 taps, each in ROWS-row
      // slabs; a slab's k steps run back to back, and the wait at its end
      // frees its A registers and its ring slot.
      if constexpr (F32) {
        // One k8 step a slab: the fragment's TF32 parts against the slot's
        // hi and lo slabs, summed in part and added into dst.  K5's x
        // segment goes into xacc, the taps into acc, each rounded to G on
        // its own before the two are added (the TPU kernel's rounding).
        // Segments are multiples of 16 rows: no tail.
        const uint32_t col = wg * (NW / 8) * 128;
        if constexpr (!XG) {
          const A* xr0 = xt[cur] + (pf[0] < HW ? pf[0] : MROWS) * xrow;
          const A* xr1 = xt[cur] + (pf[1] < HW ? pf[1] : MROWS) * xrow;
          for (int off = 0; off < C; off += ROWS) {
            uint32_t ah[4], al[4];
            frag_f32(ah, al, xr0, xr1, off, tq);
            fwd_slab_f32<NW, N, ROWS>(xacc, part, ah, al, full, empty, slot, ph, stages, ring,
                                      L.slot, col, lane);
          }
        }
        for (int tap = 0; tap < 9; ++tap) {
          const int fr0 = tap_row(pf[0], tap, 1, H, W, HW), fr1 = tap_row(pf[1], tap, 1, H, W, HW);
          for (int off = 0; off < F; off += ROWS) {
            uint32_t ah[4], al[4];
            frag_f32(ah, al, ht[cur], fr0, fr1, off, tq);
            fwd_slab_f32<NW, N, ROWS>(acc, part, ah, al, full, empty, slot, ph, stages, ring,
                                      L.slot, col, lane);
          }
        }
      } else {
        const uint32_t xrow_addr = smem_u32(xt[cur] + srow_x * xrow) + (lane >> 4) * 16;
        wgmma_fence();
        for (int seg = SEG0; seg < 10; ++seg) {
          if constexpr (SPLIT_X) {
            if (seg == 1) {
              // K5 with bf16 gates: the x segment with its bias, rounded to
              // bf16 pairs (half the registers of a second f32 accumulator,
              // which spilled); the taps' first wgmma then starts acc anew
              fence_regs(acc);
#pragma unroll
              for (int i = 0; i < NW / 4; ++i) xpk[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
            }
          }
          const bool is_x = !XG && seg == 0;
          int hrow = MROWS;
          if (!is_x) {
            const int yy = py + (seg - 1) / 3 - 1, xx = px + (seg - 1) % 3 - 1;
            if (p < HW && yy >= 0 && yy < H && xx >= 0 && xx < W) hrow = yy * W + xx;
          }
          const uint32_t hrow_addr = smem_u32(ht[cur].base + (size_t)hrow * F);
          const int hswz = hrow & ht[cur].mask;
          const int seglen = is_x ? C : F;
          for (int off = 0; off < seglen; off += ROWS) {
            const int ksteps = min(ROWS, seglen - off) / 16;
            uint32_t a[ROWS / 16][4];
            mbar_wait(&full[slot], ph);
#pragma unroll
            for (int i = 0; i < ROWS / 16; ++i) {
              const int k = off + 16 * (i < ksteps ? i : 0);
              const uint32_t addr =
                  is_x ? xrow_addr + k * 2
                       : hrow_addr + ((((k >> 3) + (lane >> 4)) ^ hswz) << 4);
              ldsm_x4_addr(a[i], addr);
              if (i >= ksteps) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0u;
            }
            // Every k step of the slab is issued: one past a 16-row tail
            // multiplies zeros by the slot's older, finite contents.  Branches
            // around a wgmma make ptxas serialize all of them.
            const uint32_t slot_addr = smem_u32(ring + slot * L.slot);
            // the first product of the taps replaces K5's x segment in acc
            // where SPLIT_X keeps that segment apart
            const int fresh = SPLIT_X && seg == 1 && off == 0;
            wgmma_fence();
#pragma unroll
            for (int i = 0; i < ROWS / 16; ++i)
              wgmma_rs<NW, 0>(acc, a[i],
                              smem_desc(slot_addr + (i * 2 * (N / 8) + wg * (NW / 8)) * 128,
                                        N * 16, 128),
                              128, !(fresh && i == 0));
            wgmma_commit();
            wgmma_wait<0>();
            keep_frags(a);
            if (lane == 0) mbar_arrive(&empty[slot]);
            if (++slot == stages) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
      }
      fence_regs(acc);

      // The cell; h_t into every CTA's next h tile, residuals into staging
      // (bf16) or straight out (f32).
      if (!F32 && MODE != kLast) named_sync(1, NCONS);  // the last step's staging is written out
      uint32_t hnext_peer[CL - 1];
#pragma unroll
      for (int k = 1; k < CL; ++k) hnext_peer[k - 1] = map_rank(ht[nxt].base, (rank + k) % CL);
#pragma unroll
      for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * wq + g + 8 * hr;
          if (r >= HW) continue;
          const int lc = wg * HFW + 8 * j8 + 2 * tq, ch = rank * HF + lc;
          float pre[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * (q * J8 + j8) + 2 * hr + e;
              if constexpr (F32 && !XG) {
                pre[q][e] = round_to<G>(round_to<G>(xacc[i]) + round_to<G>(acc[i]));
              } else if constexpr (SPLIT_X) {
                const float2 xv = pair_f2(xpk[i >> 1]);
                pre[q][e] = round_to<G>((e ? xv.y : xv.x) + round_to<G>(acc[i]));
              } else {
                pre[q][e] = round_to<G>(acc[i]);
              }
            }
          if constexpr (XG) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              // xg rounded to G before the add, as the TPU kernel rounds
              // it (convlstm_pallas.py:201; exact unless A is f32, G bf16)
              const float2 xv = pair_f2(xr[q][j8][hr]);
              pre[q][0] = round_to<G>(pre[q][0] + round_to<G>(xv.x));
              pre[q][1] = round_to<G>(pre[q][1] + round_to<G>(xv.y));
            }
          }
          float hv[2], cv[2], gv[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& cr = creg[(j8 * 2 + hr) * 2 + e];
            const Cell cl = lstm_cell_fast<G>(pre[0][e], pre[1][e], pre[2][e], pre[3][e], cr);
            cr = cl.c;
            hv[e] = cl.h;
            cv[e] = cl.c;
            gv[0][e] = cl.i;
            gv[1][e] = cl.f;
            gv[2][e] = cl.g;
            gv[3][e] = cl.o;
          }
          const Pair<A> hp = pair_of<A>(hv[0], hv[1]);
          store_pair_cluster<A>(ht[nxt].at(r, ch), ht[nxt].base, hnext_peer, hp);
          auto put = [&](A* dst, const Pair<A>& v) { *reinterpret_cast<Pair<A>*>(dst) = v; };
          if constexpr (F32) {
            // 32 bytes a row of 8 channels: a whole sector each
            const size_t o = (b * Tn + t) * HW + r;
            if (MODE != kLast) put(out_h + o * F + ch, hp);
            if (MODE == kSave) {
              put(out_c + o * F + ch, pair_of<A>(cv[0], cv[1]));
#pragma unroll
              for (int q = 0; q < 4; ++q)
                put(out_g + o * 4 * F + q * F + ch, pair_of<A>(gv[q][0], gv[q][1]));
            }
          } else {
            if (MODE != kLast) put(st_h + r * HF + lc, hp);
            if (MODE == kSave) {
              put(st_c + r * HF + lc, pair_of<A>(cv[0], cv[1]));
#pragma unroll
              for (int q = 0; q < 4; ++q)
                put(st_g + r * 4 * HF + q * HF + lc, pair_of<A>(gv[q][0], gv[q][1]));
            }
          }
          if (MODE != kSave && t == Tn - 1) {
            if (MODE == kLast) put(out_h + (b * HW + r) * F + ch, hp);
            put(out_c + (b * HW + r) * F + ch, pair_of<A>(cv[0], cv[1]));
          }
        }
      if (t + 1 < Tn) {
#pragma unroll
        for (int k = 0; k < CL; ++k) mbar_arrive_remote(map_rank(&hready[nxt], (rank + k) % CL));
        if (XG && xg_steps > 1) load_xg(t + 1);
      }
      if (!F32 && MODE != kLast) {
        // The CTA's channels of hs_t (and of cs_t and gates_t when saving),
        // 16 bytes a store.
        named_sync(1, NCONS);
        const size_t o = (b * Tn + t) * HW;
        for (int i = tid; i < HW * NSTAGED * JC; i += NCONS) {
          const int r = i / (NSTAGED * JC), c = i - r * (NSTAGED * JC);
          const A* src;
          A* dst;
          if (c < JC) {
            src = st_h + r * HF + 8 * c;
            dst = out_h + (o + r) * F + rank * HF + 8 * c;
          } else if (c < 2 * JC) {
            src = st_c + r * HF + 8 * (c - JC);
            dst = out_c + (o + r) * F + rank * HF + 8 * (c - JC);
          } else {
            const int q = (c - 2 * JC) / JC, c8 = (c - 2 * JC) - q * JC;
            src = st_g + r * 4 * HF + q * HF + 8 * c8;
            dst = out_g + (o + r) * 4 * F + q * F + rank * HF + 8 * c8;
          }
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still write into it
}


// ---------------------------------------------------------------------------
// Backward recurrence (BPTT)
// ---------------------------------------------------------------------------

// K5's backward stages of a step: 9 taps x 4F/ROWS slabs of W^T (N = HF),
// then, for each DX_BLOCK-column block of the CTA's C/CL columns of dx,
// 4F/ROWS slabs of Wx^T (N = DX_BLOCK, zero-padded past C/CL), ROWS =
// bwd_rows(F).  K6's: the 9 taps alone.
__host__ __device__ inline int bwd_dx_blocks(int C, int CL) {
  return (C / CL + DX_BLOCK - 1) / DX_BLOCK;
}

// One backward slab of ROWS weight rows: wait for ring slot `slot`, acc (+)=
// its `ksteps` k16 steps against the dgates tile row at `row_addr` (swizzle
// `swz`) from column `off` on, wait for the products, hand the slot back.
template <int N, int ROWS>
__device__ __forceinline__ void bwd_slab(float (&acc)[N / 2], uint64_t* full, uint64_t* empty,
                                         int& slot, uint32_t& ph, int stages,
                                         const unsigned char* ring, int slot_bytes,
                                         uint32_t row_addr, int swz, int off, int ksteps,
                                         int lane) {
  uint32_t a[ROWS / 16][4];
  mbar_wait(&full[slot], ph);
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const int k = off + 16 * (i < ksteps ? i : 0);
    ldsm_x4_addr(a[i], row_addr + ((((k >> 3) + (lane >> 4)) ^ swz) << 4));
    if (i >= ksteps) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0u;
  }
  // All k steps issued, zeros past a short slab (see the forward's slab).
  const uint32_t slot_addr = smem_u32(ring + slot * slot_bytes);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i)
    wgmma_rs<N, 0>(acc, a[i], smem_desc(slot_addr + i * 2 * (N / 8) * 128, N * 16, 128), 128, 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) keep_regs4(a[i]);
  if (lane == 0) mbar_arrive(&empty[slot]);
  if (++slot == stages) {
    slot = 0;
    ph ^= 1;
  }
}

// One f32 backward slab of ROWS weight rows (ROWS / 8 k8 steps), as
// bwd_slab: the fragment rows of positions 16w + g and 16w + g + 8 are
// `row0` and `row1` of the dgates tile, the slot holds the hi slab, then
// the lo slab, and the products are 3xTF32, summed in `part` (N/2 floats
// at least) and added into acc after the slab.
template <int N, int ROWS>
__device__ __forceinline__ void bwd_slab_f32(float (&acc)[N / 2], float* part, uint64_t* full,
                                             uint64_t* empty, int& slot, uint32_t& ph, int stages,
                                             const unsigned char* ring, int slot_bytes,
                                             const SwzTileT<float>& tile, int row0, int row1,
                                             int off, int lane) {
  const int tq = lane & 3;
  uint32_t ah[ROWS / 8][4], al[ROWS / 8][4];
  mbar_wait(&full[slot], ph);
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) frag_f32(ah[i], al[i], tile, row0, row1, off + 8 * i, tq);
  const uint32_t slot_addr = smem_u32(ring + slot * slot_bytes);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const uint32_t at = i * 2 * (N / 8) * 128;
    wgmma_3xtf32<N>(part, ah[i], al[i], smem_desc(slot_addr + at, N * 16, 128),
                    smem_desc(slot_addr + ROWS * N * 4 + at, N * 16, 128), 128, i == 0 ? 0 : 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep_frags(ah);
  keep_frags(al);
  promote_slab(acc, part);
  if (lane == 0) mbar_arrive(&empty[slot]);
  if (++slot == stages) {
    slot = 0;
    ph ^= 1;
  }
}

// Reverse time for sample blockIdx.x / CL, (dh, dc) carried in f32
// registers.  Per step: the cell backward of the CTA's cells from the saved
// c_t, c_{t-1} and gates (bf16: bulk-copied a step ahead; f32: each thread
// reads its cells from global memory); the dgates, rounded to the
// activation type A, into every CTA's dgates tile, and the CTA's columns of
// them into the scratch dG (A); then dh_{t-1} (the transposed 3x3 conv, K =
// 9 x 4F) on wgmma from the dgates tile.
// K5 (PROJ): dh_T (dhs, (B, HW, F)) enters once; dbx partials of the
// unrounded dgates (fixed-order sums) and dx_t = dgates_t @ Wx^T for the
// CTA's C/CL columns, on wgmma from the dgates tile.
// K6 (!PROJ, C = 0): dhs is dh_T when `last_only`, else the per-step
// cotangent of hs (B, T, HW, F), added to dh_t.  With a time-constant xg
// (dxg_sum given) the CTA sums its unrounded dgates over t in f32, in step
// order, and writes dxg = that sum once: in shared memory in a 2-CTA
// cluster with bf16 activations, else in `dxs_scratch` (B CL blocks of
// (64, 4F/CL) f32, one a CTA, each cell read and written by the one thread
// that owns it); a streaming xg's dxg is the scratch dG itself.
// wtpk: per rank, W^T rows (tap, n), the CTA's HF columns, K-major cores
// [9*4F/8][HF/8][8][8]; wxpk (K5): per rank, [C/CL blocks of 64][4F/8][8][8][8].
// f32 (A = float): cores [../4][..][8][4], the TF32 hi parts of every rank,
// then the lo parts, and the products 3xTF32.
template <typename A, int F, bool PROJ>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    rec_bwd_wgmma_kernel(const A* __restrict__ wtpk, const A* __restrict__ wxpk,
                         const A* __restrict__ c0, const A* __restrict__ cs,
                         const A* __restrict__ ga, const A* __restrict__ dhs,
                         const A* __restrict__ dcl, A* __restrict__ dG,
                         A* __restrict__ dx, float* __restrict__ dbx_part,
                         A* __restrict__ dxg_sum, float* __restrict__ dxs_scratch,
                         A* __restrict__ dc0, A* __restrict__ dh0, int Tn, int H, int W,
                         int C, int last_only) {
  constexpr bool F32 = is_f32_v<A>;
  constexpr int ES = sizeof(A), E = 16 / ES;
  constexpr int CL = rec_cluster(F), ROWS = bwd_rows(F, ES);
  constexpr int HF = F / CL, F4 = 4 * F, J8 = HF / 8, JC = HF / E;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool const_x = !PROJ && dxg_sum != nullptr;
  const BwdSmem L = PROJ ? bwd_smem_layout(F, ES) : scan_bwd_smem_layout(F, const_x, ES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* ready = empty + MAX_STAGES;
  uint64_t* freeb = ready + 1;
  uint64_t* rfull = freeb + 1;
  unsigned char* ring = smem + L.ring;
  const SwzTileT<A> dgs = make_tile(reinterpret_cast<A*>(smem + L.dg), F4);
  A* res_c = reinterpret_cast<A*>(smem + L.res);  // (64, HF) c_t; bf16 only
  A* res_p = res_c + MROWS * HF;                  // (64, HF) c_{t-1}
  A* res_g = res_p + MROWS * HF;                  // (64, 4 HF) gates
  float* wpart = reinterpret_cast<float*>(smem + L.tail);  // K5: (4 warps, 4 HF)
  // K6's f32 dgates sum, (64, 4HF).  In shared memory column c of row r
  // sits at c ^ 8 (r & 3), so that the float2 accesses of a half-warp (4
  // rows) hit 32 distinct banks; in the global scratch, at c.
  constexpr bool SUM_SMEM = scan_sum_in_smem(F, true, ES);
  float* dxs = SUM_SMEM ? reinterpret_cast<float*>(smem + L.tail)
                        : dxs_scratch + (size_t)blockIdx.x * MROWS * 4 * HF;
  auto dxs_at = [&](int r, int c) {
    return reinterpret_cast<float2*>(dxs + r * 4 * HF + (SUM_SMEM ? c ^ ((r & 3) << 3) : c));
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t rank = cluster_rank();
  const size_t b = blockIdx.x / CL;
  const int HW = H * W, C2 = C / CL, NXB = PROJ ? bwd_dx_blocks(C, CL) : 0;
  const int stages = L.stages;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init(ready, CL * BWD_CONS);
    mbar_init(freeb, CL * BWD_CONS);
    mbar_init(rfull, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < F4; i += BWD_THREADS) *dgs.at(MROWS, i) = from_f<A>(0.f);
  for (int i = tid; i < stages * L.slot / 16; i += BWD_THREADS)  // see the forward's ring
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (const_x)
    for (int i = tid; i < MROWS * 4 * HF; i += BWD_THREADS) dxs[i] = 0.f;
  cluster_sync();

  if (warp == 4) {
    if (lane == 0) {
      const size_t wt_all = (size_t)CL * 9 * F4 * HF, wx_all = (size_t)CL * NXB * F4 * DX_BLOCK;
      const A* wt = wtpk + (size_t)rank * 9 * F4 * HF;
      const A* wx = PROJ ? wxpk + (size_t)rank * NXB * F4 * DX_BLOCK : nullptr;
      int slot = 0;
      uint32_t ph = 0;
      for (int t = 0; t < Tn; ++t)
        for (int seg = 0; seg < 9 + NXB; ++seg) {
          const bool dh_part = seg < 9;
          const int ncol = dh_part ? HF : DX_BLOCK;
          const A* base =
              dh_part ? wt + (size_t)seg * F4 * HF : wx + (size_t)(seg - 9) * F4 * DX_BLOCK;
          for (int off = 0; off < F4; off += ROWS) {
            const uint32_t bytes = min(ROWS, F4 - off) * ncol * ES;
            mbar_wait(&empty[slot], ph ^ 1);
            mbar_expect_tx(&full[slot], F32 ? 2 * bytes : bytes);
            bulk_g2s(ring + slot * L.slot, base + (size_t)off * ncol, bytes, &full[slot]);
            if constexpr (F32)  // the lo parts, one block of every rank's on
              bulk_g2s(ring + slot * L.slot + ROWS * ncol * ES,
                       base + (dh_part ? wt_all : wx_all) + (size_t)off * ncol, bytes,
                       &full[slot]);
            if (++slot == stages) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
    }
  } else {
    // c_t, c_{t-1} and the gates of the CTA's channels at step t, by warp 0
    // (bf16).
    auto load_res = [&](int t) {
      if (lane == 0) mbar_expect_tx(rfull, HW * 6 * HF * 2);
      __syncwarp();
      for (int r = lane; r < HW; r += 32) {
        const size_t o = (b * Tn + t) * HW + r;
        bulk_g2s(res_c + r * HF, cs + o * F + rank * HF, HF * 2, rfull);
        bulk_g2s(res_p + r * HF,
                 t > 0 ? cs + (o - HW) * F + rank * HF : c0 + (b * HW + r) * F + rank * HF,
                 HF * 2, rfull);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bulk_g2s(res_g + r * 4 * HF + q * HF, ga + o * F4 + q * F + rank * HF, HF * 2, rfull);
      }
    };
    if constexpr (!F32) {
      if (warp == 0) load_res(Tn - 1);
    }

    // dh and dc of the CTA's cells, in the accumulator layout of N = HF: dh
    // starts as dh_T, or as dhs_{T-1} when the cotangent comes per step.
    const size_t dh_row0 = last_only ? b * HW : (b * Tn + Tn - 1) * HW;
    float dh[HF / 2], dc[HF / 2];
#pragma unroll
    for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * warp + g + 8 * hr, ch = rank * HF + 8 * j8 + 2 * tq + e;
          const int k = 4 * j8 + 2 * hr + e;
          dh[k] = r < HW ? to_f(dhs[(dh_row0 + r) * F + ch]) : 0.f;
          dc[k] = r < HW ? to_f(dcl[(b * HW + r) * F + ch]) : 0.f;
        }
    float dbx_run[2] = {0.f, 0.f};
    // bf16: the position of this lane's ldmatrix row; f32: the positions of
    // the thread's fragment rows, 16 warp + g and 8 on.
    const int p = 16 * warp + (lane & 15);
    int srow[9], frow[2][9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      srow[tap] = tap_row(p, tap, -1, H, W, HW);
#pragma unroll
      for (int u = 0; u < 2; ++u) frow[u][tap] = tap_row(16 * warp + g + 8 * u, tap, -1, H, W, HW);
    }
    uint32_t dg_peer[CL - 1];
#pragma unroll
    for (int k = 1; k < CL; ++k) dg_peer[k - 1] = map_rank(dgs.base, (rank + k) % CL);

    // f32: a slab's products, added into acc or xacc after the slab
    float part[F32 ? DX_BLOCK / 2 : 1];
#pragma unroll
    for (int i = 0; i < (F32 ? DX_BLOCK / 2 : 1); ++i) part[i] = 0.f;

    int slot = 0;
    uint32_t ph = 0;
    for (int t = Tn - 1; t >= 0; --t) {
      const int it = Tn - 1 - t;
      if constexpr (!F32) mbar_wait(rfull, it & 1);
      if (it > 0) mbar_wait_cluster(freeb, (it - 1) & 1);  // every tile read out
      // Cell backward; dgates into every tile; K5's dbx warp partials, K6's
      // dgates sum.
#pragma unroll
      for (int j8 = 0; j8 < J8; ++j8) {
        float colsum[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) colsum[q][0] = colsum[q][1] = 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * warp + g + 8 * hr, lc = 8 * j8 + 2 * tq;
          if (r >= HW) continue;
          float gq[2][4];
          if constexpr (F32) {
            // the residuals of the cell pair (r, lc..lc+1), from global memory
            const size_t o = (b * Tn + t) * HW + r;
            const size_t ch = rank * HF + lc;
            const float2 ct = *reinterpret_cast<const float2*>(cs + o * F + ch);
            const float2 cp = *reinterpret_cast<const float2*>(
                t > 0 ? cs + (o - HW) * F + ch : c0 + (b * HW + r) * F + ch);
            float2 gv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              gv[q] = *reinterpret_cast<const float2*>(ga + o * F4 + q * F + ch);
            const int k = 4 * j8 + 2 * hr;
            dc[k] = lstm_cell_bwd_fast(dh[k], dc[k], ct.x, cp.x, gv[0].x, gv[1].x, gv[2].x,
                                       gv[3].x, gq[0]);
            dc[k + 1] = lstm_cell_bwd_fast(dh[k + 1], dc[k + 1], ct.y, cp.y, gv[0].y, gv[1].y,
                                           gv[2].y, gv[3].y, gq[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 4 * j8 + 2 * hr + e, c = lc + e;
              dc[k] = lstm_cell_bwd_fast(dh[k], dc[k], to_f(res_c[r * HF + c]),
                                         to_f(res_p[r * HF + c]), to_f(res_g[r * 4 * HF + c]),
                                         to_f(res_g[r * 4 * HF + HF + c]),
                                         to_f(res_g[r * 4 * HF + 2 * HF + c]),
                                         to_f(res_g[r * 4 * HF + 3 * HF + c]), gq[e]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (PROJ) {
              colsum[q][0] += gq[0][q];
              colsum[q][1] += gq[1][q];
            }
            store_pair_cluster<A>(dgs.at(r, q * F + rank * HF + lc), dgs.base, dg_peer,
                                  pair_of<A>(gq[0][q], gq[1][q]));
            if (const_x) {
              float2* s = dxs_at(r, q * HF + lc);
              s->x += gq[0][q];
              s->y += gq[1][q];
            }
          }
        }
        if constexpr (PROJ) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = colsum[q][e];
              v += __shfl_xor_sync(0xffffffffu, v, 4);
              v += __shfl_xor_sync(0xffffffffu, v, 8);
              v += __shfl_xor_sync(0xffffffffu, v, 16);
              if (g == 0) wpart[warp * 4 * HF + q * HF + 8 * j8 + 2 * tq + e] = v;
            }
        }
      }
#pragma unroll
      for (int k = 0; k < CL; ++k) mbar_arrive_remote(map_rank(ready, (rank + k) % CL));
      mbar_wait_cluster(ready, it & 1);  // every CTA's dgates_t are in the tile
      if constexpr (!F32) {
        if (t > 0 && warp == 0) load_res(t - 1);
      }
      if constexpr (PROJ) {
        if (tid < 4 * HF)
          dbx_run[0] += ((wpart[tid] + wpart[4 * HF + tid]) + wpart[8 * HF + tid]) +
                        wpart[12 * HF + tid];
        if (tid + BWD_CONS < 4 * HF) {
          const int c = tid + BWD_CONS;
          dbx_run[1] += ((wpart[c] + wpart[4 * HF + c]) + wpart[8 * HF + c]) + wpart[12 * HF + c];
        }
      }
      // The CTA's columns of dgates_t into the scratch, 16 bytes a store.
      for (int i = tid; i < HW * 4 * JC; i += BWD_CONS) {
        const int r = i / (4 * JC), q = (i - r * 4 * JC) / JC, cc = i - r * 4 * JC - q * JC;
        const int col = q * F + rank * HF + E * cc;
        *reinterpret_cast<uint4*>(dG + ((b * Tn + t) * HW + r) * F4 + col) =
            *reinterpret_cast<const uint4*>(dgs.chunk(r, col / E));
      }
      // K6 with per-step cotangents: dhs_{t-1}, loaded while the products
      // run and added to dh_{t-1} after them.
      Pair<A> dnext[HF / 4];
      const bool add_dhs = !PROJ && !last_only && t > 0;
      if (add_dhs) {
#pragma unroll
        for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * warp + g + 8 * hr, ch = rank * HF + 8 * j8 + 2 * tq;
            dnext[2 * j8 + hr] =
                r < HW ? *reinterpret_cast<const Pair<A>*>(
                             dhs + ((b * Tn + t - 1) * HW + r) * F + ch)
                       : Pair<A>{};
          }
      }

      // dh_{t-1} for the CTA's channels: 9 taps x K = 4F.
      float acc[HF / 2];
#pragma unroll
      for (int i = 0; i < HF / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      wgmma_fence();
      for (int tap = 0; tap < 9; ++tap) {
        const int row = srow[tap];
        const uint32_t row_addr = smem_u32(dgs.base + (size_t)row * F4);
        for (int off = 0; off < F4; off += ROWS) {
          if constexpr (F32)
            bwd_slab_f32<HF, ROWS>(acc, part, full, empty, slot, ph, stages, ring, L.slot, dgs,
                                   frow[0][tap], frow[1][tap], off, lane);
          else
            bwd_slab<HF, ROWS>(acc, full, empty, slot, ph, stages, ring, L.slot, row_addr,
                               row & dgs.mask, off, min(ROWS, F4 - off) / 16, lane);
        }
      }
      fence_regs(acc);

      if constexpr (PROJ) {
        // dx_t = dgates_t (rounded to A) @ Wx^T: the centre tap's rows, K = 4F.
        const size_t orow = (b * Tn + t) * HW;
        for (int cb = 0; cb < NXB; ++cb) {
          float xacc[DX_BLOCK / 2];
#pragma unroll
          for (int i = 0; i < DX_BLOCK / 2; ++i) xacc[i] = 0.f;
          fence_regs(xacc);
          const uint32_t row_addr = smem_u32(dgs.base + (size_t)srow[4] * F4);
          wgmma_fence();
          for (int off = 0; off < F4; off += ROWS) {
            if constexpr (F32)
              bwd_slab_f32<DX_BLOCK, ROWS>(xacc, part, full, empty, slot, ph, stages, ring, L.slot,
                                           dgs, frow[0][4], frow[1][4], off, lane);
            else
              bwd_slab<DX_BLOCK, ROWS>(xacc, full, empty, slot, ph, stages, ring, L.slot,
                                       row_addr, srow[4] & dgs.mask, off,
                                       min(ROWS, F4 - off) / 16, lane);
          }
          fence_regs(xacc);
#pragma unroll
          for (int j = 0; j < DX_BLOCK / 8; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = 16 * warp + g + 8 * hr, c = cb * DX_BLOCK + 8 * j + 2 * tq;
              if (r < HW && c < C2)
                *reinterpret_cast<Pair<A>*>(dx + (orow + r) * C + rank * C2 + c) =
                    pair_of<A>(xacc[4 * j + 2 * hr], xacc[4 * j + 2 * hr + 1]);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < CL; ++k) mbar_arrive_remote(map_rank(freeb, (rank + k) % CL));
      if (add_dhs) {
#pragma unroll
        for (int i = 0; i < HF / 4; ++i) {
          const float2 d = pair_f2(dnext[i]);
          dh[2 * i] = acc[2 * i] + d.x;
          dh[2 * i + 1] = acc[2 * i + 1] + d.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < HF / 2; ++i) dh[i] = acc[i];
      }
    }

#pragma unroll
    for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr, lc = 8 * j8 + 2 * tq, ch = rank * HF + lc;
        const int k = 4 * j8 + 2 * hr;
        if (r >= HW) continue;
        *reinterpret_cast<Pair<A>*>(dh0 + (b * HW + r) * F + ch) = pair_of<A>(dh[k], dh[k + 1]);
        *reinterpret_cast<Pair<A>*>(dc0 + (b * HW + r) * F + ch) = pair_of<A>(dc[k], dc[k + 1]);
        if (const_x) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 s = *dxs_at(r, q * HF + lc);
            *reinterpret_cast<Pair<A>*>(dxg_sum + (b * HW + r) * F4 + q * F + ch) =
                pair_of<A>(s.x, s.y);
          }
        }
      }
    if constexpr (PROJ) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int lc = tid + k * BWD_CONS;
        if (lc < 4 * HF) {
          const int q = lc / HF, ch = lc - q * HF;
          dbx_part[b * F4 + q * F + rank * HF + ch] = dbx_run[k];
        }
      }
    }
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// Weight gradients on wgmma
// ---------------------------------------------------------------------------

// part[z][m][n] = sum over rows r of split z of A(m, r) * dG[r][n], with
// A(m, r) row m of [Wx; W]'s input (x_t[p][m] for m < C, else h_{t-1} at the
// shift of tap (m - C) / F) and dG the bf16 dgates scratch (R x 4F); C = 0
// gives K6's dW alone.  CTA tile 128 x BN over WW_BK rows of r a stage, two
// consumer warpgroups of 64 x BN, WW_STAGES stages of cp.async (A gathered
// with zero fill at the image border).  A reaches wgmma in registers through
// ldmatrix.trans from a [r][m] tile; B is read from shared memory as MN-major
// cores.  A stage's loads are issued while the products of the stage before
// run.
constexpr int WW_BM = 128, WW_BK = 64, WW_STAGES = 4;

__host__ __device__ inline int wgrad_bn(int F) { return 4 * F >= 256 ? 256 : 64; }
__host__ __device__ inline int wgrad_smem(int F) {
  return WW_STAGES * (WW_BK * WW_BM * 2 + WW_BK * wgrad_bn(F) * 2) + 256;
}

template <int BN>
__global__ void __launch_bounds__(256, 1) wgrad_wgmma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ hs, const bf16* __restrict__ h0,
    const bf16* __restrict__ dG, float* __restrict__ part, int Tn, int H, int W, int C, int F,
    int R, int rows_per_split) {
  constexpr int SA = WW_BK * WW_BM * 2, SB = WW_BK * BN * 2, NB8 = BN / 8;
  constexpr int AK = WW_BK * (WW_BM / 8) / 256;  // A chunks a thread loads a stage
  constexpr int BKN = WW_BK * NB8 / 256;         // B chunks
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* yx = reinterpret_cast<uint16_t*>(smem + WW_STAGES * (SA + SB));  // position -> (y, x)
  const int HW = H * W, F4 = 4 * F, M = C + 9 * F;
  const int m0 = blockIdx.x * WW_BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * rows_per_split, r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = r_end > r_begin ? (r_end - r_begin + WW_BK - 1) / WW_BK : 0;
  for (int p = tid; p < HW; p += 256) yx[p] = (uint16_t)((p / W) | ((p % W) << 8));

  // This thread's A column chunk is fixed: row m of [Wx; W]'s input.
  const int mc = tid % (WW_BM / 8), m = m0 + 8 * mc;
  const bool m_ok = m < M, is_x = m < C;
  const int q = m - C, tap = is_x ? 0 : q / F, f = q - tap * F;
  const int dy = tap / 3 - 1, dxx = tap % 3 - 1;
  // Its rows r = k0 + tid/16 + 16k, tracked as (sample bb, step t, position pp).
  int pp[AK], tt[AK], bb[AK];
#pragma unroll
  for (int k = 0; k < AK; ++k) {
    const int r = r_begin + tid / (WW_BM / 8) + k * (256 / (WW_BM / 8));
    const int bt = r / HW;
    pp[k] = r - bt * HW;
    tt[k] = bt % Tn;
    bb[k] = bt / Tn;
  }
  __syncthreads();

  auto a_tile = [&](int s) {
    return SwzTile{reinterpret_cast<bf16*>(smem + s * (SA + SB)), WW_BM / 8, 7};
  };
  auto b_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + s * (SA + SB) + SA); };
  // Stage `it` into slot s; advances the row trackers by WW_BK rows.
  auto load = [&](int it, int s) {
    const int k0 = r_begin + it * WW_BK;
    const SwzTile As = a_tile(s);
#pragma unroll
    for (int k = 0; k < AK; ++k) {
      const int kr = tid / (WW_BM / 8) + k * (256 / (WW_BM / 8));
      const int r = k0 + kr;
      const bf16* src = x;
      bool ok = false;
      if (r < r_end && m_ok) {
        if (is_x) {
          src = x + (size_t)r * C + m;
          ok = true;
        } else {
          const int v = yx[pp[k]];
          const int yy = (v & 0xff) + dy, xx = (v >> 8) + dxx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int sp = yy * W + xx;
            src = tt[k] > 0 ? hs + ((size_t)(bb[k] * Tn + tt[k] - 1) * HW + sp) * F + f
                            : h0 + ((size_t)bb[k] * HW + sp) * F + f;
            ok = true;
          }
        }
      }
      cp_async16(As.chunk(kr, mc), src, ok);
      pp[k] += WW_BK;
      while (pp[k] >= HW) {
        pp[k] -= HW;
        if (++tt[k] == Tn) {
          tt[k] = 0;
          ++bb[k];
        }
      }
    }
    bf16* Bs = b_tile(s);
#pragma unroll
    for (int k = 0; k < BKN; ++k) {
      const int i = tid + 256 * k, kr = i / NB8, nb = i - kr * NB8;
      const int r = k0 + kr, n = n0 + nb * 8;
      const bool ok = r < r_end && n < F4;
      cp_async16(Bs + ((kr / 8) * NB8 + nb) * 64 + (kr % 8) * 8,
                 ok ? dG + (size_t)r * F4 + n : dG, ok);
    }
  };

  for (int s = 0; s < WW_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<WW_STAGES - 2>();
    __syncthreads();  // stage it landed for every thread's copies; stage it - 1 read out
    if (it + WW_STAGES - 1 < nk) load(it + WW_STAGES - 1, (it + WW_STAGES - 1) % WW_STAGES);
    cp_async_commit();
    const int s = it % WW_STAGES;
    const SwzTile As = a_tile(s);
    uint32_t a[WW_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WW_BK / 16; ++kk)
      ldsm_x4_t(a[kk], As.chunk(16 * kk + (lane >> 4) * 8 + (lane & 7),
                                (64 * wg + 16 * warp + ((lane >> 3) & 1) * 8) / 8));
    wgmma_fence();
    const uint32_t bs = smem_u32(b_tile(s));
#pragma unroll
    for (int kk = 0; kk < WW_BK / 16; ++kk)
      wgmma_rs<BN, 1>(acc, a[kk], smem_desc(bs + kk * 2 * NB8 * 128, BN * 16, 128), 128, 1);
    wgmma_commit();
    wgmma_wait<0>();  // the other warpgroup's products fill this one's gaps
#pragma unroll
    for (int kk = 0; kk < WW_BK / 16; ++kk) keep_regs4(a[kk]);
  }
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int mm = m0 + 64 * wg + 16 * warp + g + 8 * hr, n = n0 + 8 * j + 2 * tq;
      if (mm < M && n < F4)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + mm) * F4 + n) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
}

// The weight GEMM with f32 activations and an f32 dgates scratch: the same
// sums, 3xTF32 on wgmma, each stage's products summed apart and added into
// f32 registers.  CTA tile 128 x BN over WF_BK rows of r a stage, two
// stages.  A (row m of [Wx; W]'s input, gathered as the bf16 kernel
// gathers it) lands by cp.async in an [r][m] tile padded by 4 floats a row
// and reaches the products as split TF32 fragments from 32-bit loads (the
// padding puts a warp's 32 loads in 32 banks); TF32 takes only K-major B,
// so dG's [r][n] rows go through registers into K-major cores, split into
// their TF32 hi and lo parts on the way.  A stage's loads are issued, and
// the next stage's dG read into registers, while the products of the stage
// before run.
constexpr int WF_BK = 32, WF_STAGES = 2, WF_APAD = 4;

__host__ __device__ inline int wgrad_f32_bn(int F) { return 4 * F >= 128 ? 128 : 64; }
__host__ __device__ inline int wgrad_f32_smem(int F) {
  return WF_STAGES * (WF_BK * (WW_BM + WF_APAD) * 4 + 2 * WF_BK * wgrad_f32_bn(F) * 4) + 256;
}

template <int BN>
__global__ void __launch_bounds__(256, 1) wgrad_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ hs, const float* __restrict__ h0,
    const float* __restrict__ dG, float* __restrict__ part, int Tn, int H, int W, int C, int F,
    int R, int rows_per_split) {
  constexpr int AROW = WW_BM + WF_APAD;                        // floats an A tile row
  constexpr int SA = WF_BK * AROW * 4, SB = WF_BK * BN * 4;  // bytes: A tile, one B part
  constexpr int AK = WF_BK * (WW_BM / 4) / 256;  // A chunks (4 floats) a thread loads a stage
  constexpr int BK4 = WF_BK * (BN / 4) / 256;    // dG float4s a thread moves a stage
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* yx = reinterpret_cast<uint16_t*>(smem + WF_STAGES * (SA + 2 * SB));
  const int HW = H * W, F4 = 4 * F, M = C + 9 * F;
  const int m0 = blockIdx.x * WW_BM, n0 = blockIdx.y * BN;
  const int r_begin = blockIdx.z * rows_per_split, r_end = min(R, r_begin + rows_per_split);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nk = r_end > r_begin ? (r_end - r_begin + WF_BK - 1) / WF_BK : 0;
  for (int p = tid; p < HW; p += 256) yx[p] = (uint16_t)((p / W) | ((p % W) << 8));

  // This thread's A column chunk is fixed: 4 consecutive m of [Wx; W]'s input.
  const int mc = tid % (WW_BM / 4), m = m0 + 4 * mc;
  const bool m_ok = m < M, is_x = m < C;
  const int q = m - C, tap = is_x ? 0 : q / F, f = q - tap * F;
  const int dy = tap / 3 - 1, dxx = tap % 3 - 1;
  // Its rows r = k0 + tid/32 + 8k, tracked as (sample bb, step t, position pp).
  int pp[AK], tt[AK], bb[AK];
#pragma unroll
  for (int k = 0; k < AK; ++k) {
    const int r = r_begin + tid / (WW_BM / 4) + k * (256 / (WW_BM / 4));
    const int bt = r / HW;
    pp[k] = r - bt * HW;
    tt[k] = bt % Tn;
    bb[k] = bt / Tn;
  }
  // The dG float4s of a stage: a warp covers 4 rows x 8 float4s, so that
  // its scalar stores into the K-major cores (word 4 BN (r/4) + 4n + r%4)
  // spread over 8 banks a store.
  int brow[BK4], bcol[BK4];
#pragma unroll
  for (int k = 0; k < BK4; ++k) {
    const int wb = (tid >> 5) + 8 * k;  // this warp's block of 4 rows x 32 columns
    brow[k] = 4 * (wb / (BN / 32)) + (lane & 3);
    bcol[k] = 32 * (wb % (BN / 32)) + 4 * (lane >> 2);
  }
  __syncthreads();

  auto a_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * (SA + 2 * SB)); };
  auto b_hi = [&](int s) { return reinterpret_cast<float*>(smem + s * (SA + 2 * SB) + SA); };
  // Stage `it`'s A rows into slot s by cp.async; advances the row trackers.
  auto load_a = [&](int it, int s) {
    const int k0 = r_begin + it * WF_BK;
    float* As = a_tile(s);
#pragma unroll
    for (int k = 0; k < AK; ++k) {
      const int kr = tid / (WW_BM / 4) + k * (256 / (WW_BM / 4));
      const int r = k0 + kr;
      const float* src = x;
      bool ok = false;
      if (r < r_end && m_ok) {
        if (is_x) {
          src = x + (size_t)r * C + m;
          ok = true;
        } else {
          const int v = yx[pp[k]];
          const int yy = (v & 0xff) + dy, xx = (v >> 8) + dxx;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int sp = yy * W + xx;
            src = tt[k] > 0 ? hs + ((size_t)(bb[k] * Tn + tt[k] - 1) * HW + sp) * F + f
                            : h0 + ((size_t)bb[k] * HW + sp) * F + f;
            ok = true;
          }
        }
      }
      cp_async16(As + kr * AROW + 4 * mc, src, ok);
      pp[k] += WF_BK;
      while (pp[k] >= HW) {
        pp[k] -= HW;
        if (++tt[k] == Tn) {
          tt[k] = 0;
          ++bb[k];
        }
      }
    }
  };
  float4 breg[BK4];
  auto fetch_b = [&](int it) {
    const int k0 = r_begin + it * WF_BK;
#pragma unroll
    for (int k = 0; k < BK4; ++k) {
      const int r = k0 + brow[k], n = n0 + bcol[k];
      breg[k] = r < r_end && n < F4 ? *reinterpret_cast<const float4*>(dG + (size_t)r * F4 + n)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_b = [&](int s) {
    float* hi = b_hi(s);
    float* lo = hi + WF_BK * BN;
#pragma unroll
    for (int k = 0; k < BK4; ++k) {
      const float v[4] = {breg[k].x, breg[k].y, breg[k].z, breg[k].w};
      const int base = 4 * BN * (brow[k] / 4) + 4 * bcol[k] + (brow[k] % 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t h, l;
        tf32_split(v[j], h, l);
        hi[base + 4 * j] = __uint_as_float(h);
        lo[base + 4 * j] = __uint_as_float(l);
      }
    }
  };

  if (nk > 0) {
    load_a(0, 0);
    fetch_b(0);
    store_b(0);
  }
  cp_async_commit();
  float acc[BN / 2], slab[BN / 2];  // slab: a stage's products, added into acc
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = slab[i] = 0.f;
  fence_regs(acc);
  const int mrow = 64 * wg + 16 * warp + g;
  for (int it = 0; it < nk; ++it) {
    const int s = it % WF_STAGES;
    if (it + 1 < nk) {
      load_a(it + 1, s ^ 1);
      fetch_b(it + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // stage it landed (A by cp.async, B by every thread's stores)
    const float* As = a_tile(s);
    uint32_t ah[WF_BK / 8][4], al[WF_BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < WF_BK / 8; ++kk) {
      const int k = 8 * kk + tq;
      tf32_split(As[k * AROW + mrow], ah[kk][0], al[kk][0]);
      tf32_split(As[k * AROW + mrow + 8], ah[kk][1], al[kk][1]);
      tf32_split(As[(k + 4) * AROW + mrow], ah[kk][2], al[kk][2]);
      tf32_split(As[(k + 4) * AROW + mrow + 8], ah[kk][3], al[kk][3]);
    }
    const uint32_t bh = smem_u32(b_hi(s)), bl = bh + SB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WF_BK / 8; ++kk)
      wgmma_3xtf32<BN>(slab, ah[kk], al[kk], smem_desc(bh + kk * 2 * (BN / 8) * 128, BN * 16, 128),
                       smem_desc(bl + kk * 2 * (BN / 8) * 128, BN * 16, 128), 128, kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<0>();
    keep_frags(ah);
    keep_frags(al);
    promote_slab(acc, slab);
    __syncthreads();  // slot s read out by both warpgroups
    if (it + 1 < nk) store_b(s ^ 1);
  }
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int mm = m0 + mrow + 8 * hr, n = n0 + 8 * j + 2 * tq;
      if (mm < M && n < F4)
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + mm) * F4 + n) =
            make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Launch `kern` on `ctas` CTAs in clusters of `cluster`.
inline cudaError_t cluster_launch(const void* kern, int ctas, int threads, int smem,
                                  cudaStream_t stream, void** args, int cluster) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelExC(&cfg, kern, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The recurrent kernels' widths, each a compile-time F: 2-CTA clusters for
// the multiples of 16 up to 128 (convlstm_proj.cu, convlstm_scan.cu), 4-CTA
// clusters for the multiples of 32 in (128, 256] (convlstm_proj_wide.cu,
// convlstm_scan_wide.cu, built in parallel with them).
template <int... FS>
struct FList {};
using NarrowF = FList<16, 32, 48, 64, 80, 96, 112, 128>;
using WideF = FList<160, 192, 224, 256>;

// fn(std::integral_constant<int, F>{}) for the F of the list that equals
// `F`; cudaErrorInvalidValue for an F outside it.
template <int... FS, typename Fn>
int with_f(FList<FS...>, int F, Fn&& fn) {
  int err = (int)cudaErrorInvalidValue;
  (void)((F == FS && ((err = fn(std::integral_constant<int, FS>{})), true)) || ...);
  return err;
}

}  // namespace
}  // namespace mmvae
