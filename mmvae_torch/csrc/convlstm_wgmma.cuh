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
// the rows.
__host__ __device__ constexpr int bwd_rows(int F) {
  return rec_cluster(F) == 2 ? BWD_ROWS : BWD_ROWS / 2;
}

__host__ __device__ inline int round128(int v) { return (v + 127) / 128 * 128; }

// Forward shared memory: [barriers 256 | bias 1024 | ring | x tiles x2 |
// h tiles x2 | residual staging (hs, cs, gates of the CTA's channels)].
// K5's x tiles hold x_t and x_{t+1} (a zero row for absent positions); K6
// has none (x_tiles false): its threads hold their cells of xg in registers.
// A slot holds FWD_ROWS rows of the CTA's 4F/CL gate columns.
struct FwdSmem {
  int ring, xt, ht, stage, slot, xtile, htile, stages, total;
};
__host__ __device__ inline FwdSmem fwd_smem_layout(int C, int F, bool x_tiles = true) {
  FwdSmem s;
  const int HF = F / rec_cluster(F);
  s.slot = FWD_ROWS * 4 * HF * 2;
  s.xtile = x_tiles ? round128((MROWS + 1) * (C + 8) * 2) : 0;
  s.htile = round128((MROWS + 1) * F * 2);
  const int fixed = 1280 + 2 * s.xtile + 2 * s.htile + MROWS * 6 * HF * 2;
  s.stages = (SMEM_LIMIT - fixed) / s.slot;
  s.stages = s.stages > MAX_STAGES ? MAX_STAGES : s.stages;
  s.ring = 1280;
  s.xt = s.ring + s.stages * s.slot;
  s.ht = s.xt + 2 * s.xtile;
  s.stage = s.ht + 2 * s.htile;
  s.total = s.stage + MROWS * 6 * HF * 2;
  return s;
}

// Backward shared memory: [barriers 256 | ring | dgates tile | residuals
// (c_t, c_{t-1}, gates of the CTA's channels) | tail].  K5: slots of
// bwd_rows x DX_BLOCK (its dx blocks are its widest products), the tail its
// dbx warp partials.  K6: slots of bwd_rows x F/CL; the tail, for a
// time-constant xg in a 2-CTA cluster, the f32 sum over t of the dgates of
// the CTA's 4F/CL columns (none when streaming; a 4-CTA cluster keeps that
// sum in global memory, see rec_bwd_wgmma_kernel).
struct BwdSmem {
  int ring, dg, res, tail, slot, stages, total;
};
__host__ __device__ inline BwdSmem bwd_layout(int F, int slot, int tail) {
  BwdSmem s;
  s.slot = slot;
  const int HF = F / rec_cluster(F);
  const int dg = round128((MROWS + 1) * 4 * F * 2);
  const int fixed = 256 + dg + MROWS * 6 * HF * 2 + tail;
  s.stages = (SMEM_LIMIT - fixed) / s.slot;
  s.stages = s.stages > MAX_STAGES ? MAX_STAGES : s.stages;
  s.ring = 256;
  s.dg = s.ring + s.stages * s.slot;
  s.res = s.dg + dg;
  s.tail = s.res + MROWS * 6 * HF * 2;
  s.total = s.tail + tail;
  return s;
}
__host__ __device__ inline BwdSmem bwd_smem_layout(int F) {
  const int HF = F / rec_cluster(F);
  return bwd_layout(F, bwd_rows(F) * DX_BLOCK * 2, 4 * 4 * HF * 4);
}
// Whether K6's BPTT keeps a time-constant xg's f32 dgates sum in shared memory.
__host__ __device__ constexpr bool scan_sum_in_smem(int F, bool const_x) {
  return const_x && rec_cluster(F) == 2;
}
__host__ __device__ inline BwdSmem scan_bwd_smem_layout(int F, bool const_x) {
  const int HF = F / rec_cluster(F);
  return bwd_layout(F, bwd_rows(F) * HF * 2,
                    scan_sum_in_smem(F, const_x) ? MROWS * 4 * HF * 4 : 0);
}
// The fewest ring stages a K6 BPTT takes.
__host__ __device__ constexpr int scan_bwd_min_stages(int F, bool const_x) {
  return scan_sum_in_smem(F, const_x) ? SCAN_BWD_MIN_STAGES : MIN_STAGES;
}

// The LSTM cell with the pointwise chain rounded to the gate dtype G as
// torch's ops in G round, from pre-activations already rounded to G, and its
// f32 backward from the saved post-activation gates.  The exponential and
// the reciprocal come from the special-function unit (__expf, __fdividef):
// a few f32 ulps, far below the bf16 rounding that follows, and about a
// fifth of the instructions of IEEE expf, division and tanhf, which matters
// here because one warpgroup of a CTA runs the whole cell between two steps.
__device__ __forceinline__ float sigm_fast(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}
template <typename G>
__device__ __forceinline__ Cell lstm_cell_fast(float pi, float pf, float pg, float po, float c) {
  Cell r;
  r.i = round_to<G>(sigm_fast(pi));
  r.f = round_to<G>(sigm_fast(round_to<G>(pf + 1.f)));
  r.g = round_to<G>(tanh_fast(pg));
  r.o = round_to<G>(sigm_fast(po));
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

// All T steps of sample blockIdx.x / CL.  K5 (!XG): gates_t = x_t @ Wx + bx +
// conv3x3(h_{t-1}, W), x (B, T, HW, C).  K6 (XG, C = 0): gates_t =
// G(G(conv3x3(h_{t-1}, W)) + xg_t) with xg (B, xg_steps, HW, 4F), read at
// step 0 throughout when xg_steps is 1 (a time-constant input); each
// consumer thread loads its cells of xg_{t+1} into registers once it has
// used those of xg_t, so the loads run under a whole step's products (a
// time-constant xg is loaded once).  wpk: per cluster rank, the CTA's 4F/CL
// columns of [Wx; W] (K = C + 9F rows) packed as K-major cores
// [K/8][4F/CL/8][8][8].  Launched in clusters of CL (cluster_launch).
template <typename G, int MODE, int F, bool XG>
__global__ void __launch_bounds__(rec_threads(F), 1)
    rec_fwd_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                         const bf16* __restrict__ bx, const bf16* __restrict__ c0,
                         const bf16* __restrict__ h0, bf16* __restrict__ out_h,
                         bf16* __restrict__ out_c, bf16* __restrict__ out_g, int Tn, int H, int W,
                         int C, int xg_steps) {
  // Warpgroup wg owns HFW of the CTA's HF channels, all four gates: NW of
  // the CTA's N gate columns, which the packing puts together.
  constexpr int CL = rec_cluster(F);
  constexpr int NWG = rec_wgs(F), NCONS = 128 * NWG, NTHREADS = NCONS + 32;
  constexpr int HF = F / CL, HFW = HF / NWG, N = 4 * HF, NW = N / NWG;
  constexpr int J8 = HFW / 8, JC = HF / 8, NCELL = HFW / 2;
  constexpr int SEG0 = XG ? 1 : 0;                // K6 has no x segment
  constexpr int NSTAGED = MODE == kSave ? 6 : 1;  // staged tensors (h, c, 4 gates)
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem L = fwd_smem_layout(C, F, !XG);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xfull = empty + MAX_STAGES;  // [2]
  uint64_t* hready = xfull + 2;          // [2]
  float* bias = reinterpret_cast<float*>(smem + 256);
  unsigned char* ring = smem + L.ring;
  const int xrow = C + 8;
  bf16* xt[2] = {reinterpret_cast<bf16*>(smem + L.xt),
                 reinterpret_cast<bf16*>(smem + L.xt + L.xtile)};
  const SwzTile ht[2] = {make_tile(reinterpret_cast<bf16*>(smem + L.ht), F),
                         make_tile(reinterpret_cast<bf16*>(smem + L.ht + L.htile), F)};
  bf16* st_h = reinterpret_cast<bf16*>(smem + L.stage);  // (64, HF)
  bf16* st_c = st_h + MROWS * HF;                        // (64, HF)
  bf16* st_g = st_c + MROWS * HF;                        // (64, 4 HF)

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
    for (int i = tid; i < 2 * (C + 8); i += NTHREADS)
      xt[i / (C + 8)][MROWS * xrow + i % (C + 8)] = from_f<bf16>(0.f);
  }
  for (int i = tid; i < 2 * F; i += NTHREADS) *ht[i / F].at(MROWS, i % F) = from_f<bf16>(0.f);
  if constexpr (!XG) {
    // x_0, rounded as the reference rounds it.
    const int cch = C / 8;
    for (int i = tid; i < HW * cch; i += NTHREADS)
      *reinterpret_cast<uint4*>(xt[0] + (i / cch) * xrow + (i % cch) * 8) =
          *reinterpret_cast<const uint4*>(x + (b * Tn * HW + i / cch) * C + (i % cch) * 8);
  }
  // h_0 (all F channels).
  for (int i = tid; i < HW * F; i += NTHREADS)
    *ht[0].at(i / F, i % F) = from_f<bf16>(round_to<G>(to_f(h0[b * HW * F + i])));
  cluster_sync();

  if (warp == 4 * NWG) {
    // Producer: the CTA's weight slabs, stage after stage, step after step.
    if (lane == 0) {
      const bf16* wsrc = wpk + (size_t)rank * K * N;
      int slot = 0;
      uint32_t ph = 0;
      // The consumers' order: K5's x segment (K = C), then the 9 taps (K =
      // F each), in FWD_ROWS-row slabs (a 16-row tail where a segment ends).
      for (int t = 0; t < Tn; ++t)
        for (int seg = SEG0; seg < 10; ++seg) {
          const int seglen = seg == 0 ? C : F, k0 = seg == 0 ? 0 : C + (seg - 1) * F;
          for (int off = 0; off < seglen; off += FWD_ROWS) {
            const uint32_t bytes = min(FWD_ROWS, seglen - off) * N * 2;
            mbar_wait(&empty[slot], ph ^ 1);
            mbar_expect_tx(&full[slot], bytes);
            bulk_g2s(ring + slot * L.slot, wsrc + (size_t)(k0 + off) * N, bytes, &full[slot]);
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
    const int p = 16 * wq + (lane & 15), py = p / W, px = p % W;
    const int srow_x = p < HW ? p : MROWS;
    // K6: the thread's cells of xg_t, bf16 pairs of channels, per (gate, j8, hr).
    uint32_t xr[4][J8][2];
    auto load_xg = [&](int t) {
#pragma unroll
      for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = 16 * wq + g + 8 * hr, ch = rank * HF + wg * HFW + 8 * j8 + 2 * tq;
          const bf16* src = x + ((b * xg_steps + t) * HW + r) * 4 * F + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xr[q][j8][hr] = r < HW ? *reinterpret_cast<const uint32_t*>(src + q * F) : 0u;
        }
    };
    if constexpr (XG) load_xg(0);

    int slot = 0;
    uint32_t ph = 0;
    for (int t = 0; t < Tn; ++t) {
      const int cur = t & 1, nxt = cur ^ 1;
      if (t > 0) mbar_wait_cluster(&hready[cur], ((t - 1) >> 1) & 1);
      if constexpr (!XG) {
        if (t + 1 < Tn && warp == 0) {
          // x_{t+1} into the other x tile, one bulk copy a row.
          if (lane == 0) mbar_expect_tx(&xfull[nxt], HW * C * 2);
          __syncwarp();
          for (int r = lane; r < HW; r += 32)
            bulk_g2s(xt[nxt] + r * xrow, x + ((b * Tn + t + 1) * HW + r) * C, C * 2, &xfull[nxt]);
        }
        if (t > 0) mbar_wait(&xfull[cur], ((t - 1) >> 1) & 1);
      }

      float acc[NW / 2];
      if constexpr (XG) {
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < NW / 8; ++j) {
          const float2 bv = *reinterpret_cast<const float2*>(&bias[wg * NW + 8 * j + 2 * tq]);
          acc[4 * j + 0] = bv.x;
          acc[4 * j + 1] = bv.y;
          acc[4 * j + 2] = bv.x;
          acc[4 * j + 3] = bv.y;
        }
      }
      fence_regs(acc);
      // The K loop: K5's x segment, then the 9 taps, each in FWD_ROWS-row
      // slabs; a slab's k16 steps run back to back, and the wait at its end
      // frees its A registers and its ring slot.
      const uint32_t xrow_addr = smem_u32(xt[cur] + srow_x * xrow) + (lane >> 4) * 16;
      wgmma_fence();
      for (int seg = SEG0; seg < 10; ++seg) {
        const bool is_x = !XG && seg == 0;
        int hrow = MROWS;
        if (!is_x) {
          const int yy = py + (seg - 1) / 3 - 1, xx = px + (seg - 1) % 3 - 1;
          if (p < HW && yy >= 0 && yy < H && xx >= 0 && xx < W) hrow = yy * W + xx;
        }
        const uint32_t hrow_addr = smem_u32(ht[cur].base + (size_t)hrow * F);
        const int hswz = hrow & ht[cur].mask;
        const int seglen = is_x ? C : F;
        for (int off = 0; off < seglen; off += FWD_ROWS) {
          const int ksteps = min(FWD_ROWS, seglen - off) / 16;
          uint32_t a[FWD_ROWS / 16][4];
          mbar_wait(&full[slot], ph);
#pragma unroll
          for (int i = 0; i < FWD_ROWS / 16; ++i) {
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
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < FWD_ROWS / 16; ++i)
            wgmma_rs<NW, 0>(acc, a[i],
                            smem_desc(slot_addr + (i * 2 * (N / 8) + wg * (NW / 8)) * 128,
                                      N * 16, 128),
                            128, 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < FWD_ROWS / 16; ++i) keep_regs4(a[i]);
          if (lane == 0) mbar_arrive(&empty[slot]);
          if (++slot == stages) {
            slot = 0;
            ph ^= 1;
          }
        }
      }
      fence_regs(acc);

      // The cell; h_t into every CTA's next h tile, residuals into staging.
      if (MODE != kLast) named_sync(1, NCONS);  // the last step's staging is written out
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
            for (int e = 0; e < 2; ++e) pre[q][e] = round_to<G>(acc[4 * (q * J8 + j8) + 2 * hr + e]);
          if constexpr (XG) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 xv =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[q][j8][hr]));
              pre[q][0] = round_to<G>(pre[q][0] + xv.x);
              pre[q][1] = round_to<G>(pre[q][1] + xv.y);
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
          const uint32_t hp = pack_bf16(hv[0], hv[1]);
          bf16* own = ht[nxt].at(r, ch);
          *reinterpret_cast<uint32_t*>(own) = hp;
#pragma unroll
          for (int k = 0; k < CL - 1; ++k)
            st_cluster_b32(hnext_peer[k] + (uint32_t)((own - ht[nxt].base) * 2), hp);
          if (MODE != kLast) *reinterpret_cast<uint32_t*>(st_h + r * HF + lc) = hp;
          if (MODE == kSave) {
            *reinterpret_cast<uint32_t*>(st_c + r * HF + lc) = pack_bf16(cv[0], cv[1]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<uint32_t*>(st_g + r * 4 * HF + q * HF + lc) =
                  pack_bf16(gv[q][0], gv[q][1]);
          } else if (t == Tn - 1) {
            if (MODE == kLast) *reinterpret_cast<uint32_t*>(out_h + (b * HW + r) * F + ch) = hp;
            *reinterpret_cast<uint32_t*>(out_c + (b * HW + r) * F + ch) = pack_bf16(cv[0], cv[1]);
          }
        }
      if (t + 1 < Tn) {
#pragma unroll
        for (int k = 0; k < CL; ++k) mbar_arrive_remote(map_rank(&hready[nxt], (rank + k) % CL));
        if (XG && xg_steps > 1) load_xg(t + 1);
      }
      if (MODE != kLast) {
        // The CTA's channels of hs_t (and of cs_t and gates_t when saving),
        // 16 bytes a store.
        named_sync(1, NCONS);
        const size_t o = (b * Tn + t) * HW;
        for (int i = tid; i < HW * NSTAGED * JC; i += NCONS) {
          const int r = i / (NSTAGED * JC), c = i - r * (NSTAGED * JC);
          const bf16* src;
          bf16* dst;
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

// Reverse time for sample blockIdx.x / CL, (dh, dc) carried in f32
// registers.  Per step: the cell backward of the CTA's cells from the saved
// c_t, c_{t-1} and gates (bulk-copied a step ahead); bf16 dgates into every
// CTA's dgates tile, and the CTA's columns of them into the bf16 scratch dG;
// then dh_{t-1} (the transposed 3x3 conv, K = 9 x 4F) on wgmma from the
// dgates tile.
// K5 (PROJ): dh_T (dhs, (B, HW, F)) enters once; dbx partials of the
// unrounded dgates (fixed-order sums) and dx_t = dgates_t @ Wx^T for the
// CTA's C/CL columns, on wgmma from the dgates tile.
// K6 (!PROJ, C = 0): dhs is dh_T when `last_only`, else the per-step
// cotangent of hs (B, T, HW, F), added to dh_t.  With a time-constant xg
// (dxg_sum given) the CTA sums its unrounded dgates over t in f32, in step
// order, and writes dxg = that sum once: in shared memory in a 2-CTA
// cluster, else in `dxs_scratch` (B CL blocks of (64, 4F/CL) f32, one a CTA,
// each cell read and written by the one thread that owns it); a streaming
// xg's dxg is the bf16 scratch dG itself.
// wtpk: per rank, W^T rows (tap, n), the CTA's HF columns, K-major cores
// [9*4F/8][HF/8][8][8]; wxpk (K5): per rank, [C/CL blocks of 64][4F/8][8][8][8].
template <int F, bool PROJ>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    rec_bwd_wgmma_kernel(const bf16* __restrict__ wtpk, const bf16* __restrict__ wxpk,
                         const bf16* __restrict__ c0, const bf16* __restrict__ cs,
                         const bf16* __restrict__ ga, const bf16* __restrict__ dhs,
                         const bf16* __restrict__ dcl, bf16* __restrict__ dG,
                         bf16* __restrict__ dx, float* __restrict__ dbx_part,
                         bf16* __restrict__ dxg_sum, float* __restrict__ dxs_scratch,
                         bf16* __restrict__ dc0, bf16* __restrict__ dh0, int Tn, int H, int W,
                         int C, int last_only) {
  constexpr int CL = rec_cluster(F), ROWS = bwd_rows(F);
  constexpr int HF = F / CL, F4 = 4 * F, J8 = HF / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool const_x = !PROJ && dxg_sum != nullptr;
  const BwdSmem L = PROJ ? bwd_smem_layout(F) : scan_bwd_smem_layout(F, const_x);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* ready = empty + MAX_STAGES;
  uint64_t* freeb = ready + 1;
  uint64_t* rfull = freeb + 1;
  unsigned char* ring = smem + L.ring;
  const SwzTile dgs = make_tile(reinterpret_cast<bf16*>(smem + L.dg), F4);
  bf16* res_c = reinterpret_cast<bf16*>(smem + L.res);  // (64, HF) c_t
  bf16* res_p = res_c + MROWS * HF;                      // (64, HF) c_{t-1}
  bf16* res_g = res_p + MROWS * HF;                      // (64, 4 HF) gates
  float* wpart = reinterpret_cast<float*>(smem + L.tail);  // K5: (4 warps, 4 HF)
  // K6's f32 dgates sum, (64, 4HF).  In shared memory column c of row r
  // sits at c ^ 8 (r & 3), so that the float2 accesses of a half-warp (4
  // rows) hit 32 distinct banks; in the global scratch, at c.
  constexpr bool SUM_SMEM = CL == 2;
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
  for (int i = tid; i < F4; i += BWD_THREADS) *dgs.at(MROWS, i) = from_f<bf16>(0.f);
  for (int i = tid; i < stages * L.slot / 16; i += BWD_THREADS)  // see the forward's ring
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (const_x)
    for (int i = tid; i < MROWS * 4 * HF; i += BWD_THREADS) dxs[i] = 0.f;
  cluster_sync();

  if (warp == 4) {
    if (lane == 0) {
      const bf16* wt = wtpk + (size_t)rank * 9 * F4 * HF;
      const bf16* wx = PROJ ? wxpk + (size_t)rank * NXB * F4 * DX_BLOCK : nullptr;
      int slot = 0;
      uint32_t ph = 0;
      for (int t = 0; t < Tn; ++t)
        for (int seg = 0; seg < 9 + NXB; ++seg) {
          const bool dh_part = seg < 9;
          const int ncol = dh_part ? HF : DX_BLOCK;
          const bf16* base =
              dh_part ? wt + (size_t)seg * F4 * HF : wx + (size_t)(seg - 9) * F4 * DX_BLOCK;
          for (int off = 0; off < F4; off += ROWS) {
            const uint32_t bytes = min(ROWS, F4 - off) * ncol * 2;
            mbar_wait(&empty[slot], ph ^ 1);
            mbar_expect_tx(&full[slot], bytes);
            bulk_g2s(ring + slot * L.slot, base + (size_t)off * ncol, bytes, &full[slot]);
            if (++slot == stages) {
              slot = 0;
              ph ^= 1;
            }
          }
        }
    }
  } else {
    // c_t, c_{t-1} and the gates of the CTA's channels at step t, by warp 0.
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
    if (warp == 0) load_res(Tn - 1);

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
    const int p = 16 * warp + (lane & 15);
    int srow[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) srow[tap] = tap_row(p, tap, -1, H, W, HW);
    uint32_t dg_peer[CL - 1];
#pragma unroll
    for (int k = 1; k < CL; ++k) dg_peer[k - 1] = map_rank(dgs.base, (rank + k) % CL);

    int slot = 0;
    uint32_t ph = 0;
    for (int t = Tn - 1; t >= 0; --t) {
      const int it = Tn - 1 - t;
      mbar_wait(rfull, it & 1);
      if (it > 0) mbar_wait_cluster(freeb, (it - 1) & 1);  // every tile read out
      // Cell backward; bf16 dgates into every tile; K5's dbx warp partials,
      // K6's dgates sum.
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
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * j8 + 2 * hr + e, c = lc + e;
            dc[k] = lstm_cell_bwd_fast(dh[k], dc[k], to_f(res_c[r * HF + c]), to_f(res_p[r * HF + c]),
                                  to_f(res_g[r * 4 * HF + c]), to_f(res_g[r * 4 * HF + HF + c]),
                                  to_f(res_g[r * 4 * HF + 2 * HF + c]),
                                  to_f(res_g[r * 4 * HF + 3 * HF + c]), gq[e]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if constexpr (PROJ) {
              colsum[q][0] += gq[0][q];
              colsum[q][1] += gq[1][q];
            }
            const uint32_t v = pack_bf16(gq[0][q], gq[1][q]);
            bf16* own = dgs.at(r, q * F + rank * HF + lc);
            *reinterpret_cast<uint32_t*>(own) = v;
#pragma unroll
            for (int k = 0; k < CL - 1; ++k)
              st_cluster_b32(dg_peer[k] + (uint32_t)((own - dgs.base) * 2), v);
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
      if (t > 0 && warp == 0) load_res(t - 1);
      if constexpr (PROJ) {
        if (tid < 4 * HF)
          dbx_run[0] += ((wpart[tid] + wpart[4 * HF + tid]) + wpart[8 * HF + tid]) +
                        wpart[12 * HF + tid];
        if (tid + BWD_CONS < 4 * HF) {
          const int c = tid + BWD_CONS;
          dbx_run[1] += ((wpart[c] + wpart[4 * HF + c]) + wpart[8 * HF + c]) + wpart[12 * HF + c];
        }
      }
      // The CTA's columns of dgates_t into the bf16 scratch, 16 bytes a store.
      for (int i = tid; i < HW * 4 * J8; i += BWD_CONS) {
        const int r = i / (4 * J8), q = (i - r * 4 * J8) / J8, c8 = i - r * 4 * J8 - q * J8;
        const int col = q * F + rank * HF + 8 * c8;
        *reinterpret_cast<uint4*>(dG + ((b * Tn + t) * HW + r) * F4 + col) =
            *reinterpret_cast<const uint4*>(dgs.chunk(r, col / 8));
      }
      // K6 with per-step cotangents: dhs_{t-1}, loaded while the products
      // run and added to dh_{t-1} after them.
      uint32_t dnext[HF / 4];
      const bool add_dhs = !PROJ && !last_only && t > 0;
      if (add_dhs) {
#pragma unroll
        for (int j8 = 0; j8 < J8; ++j8)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = 16 * warp + g + 8 * hr, ch = rank * HF + 8 * j8 + 2 * tq;
            dnext[2 * j8 + hr] =
                r < HW ? *reinterpret_cast<const uint32_t*>(
                             dhs + ((b * Tn + t - 1) * HW + r) * F + ch)
                       : 0u;
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
        for (int off = 0; off < F4; off += ROWS)
          bwd_slab<HF, ROWS>(acc, full, empty, slot, ph, stages, ring, L.slot, row_addr,
                             row & dgs.mask, off, min(ROWS, F4 - off) / 16, lane);
      }
      fence_regs(acc);

      if constexpr (PROJ) {
        // dx_t = bf16(dgates_t) @ Wx^T: the centre tap's rows, K = 4F.
        const size_t orow = (b * Tn + t) * HW;
        for (int cb = 0; cb < NXB; ++cb) {
          float xacc[DX_BLOCK / 2];
#pragma unroll
          for (int i = 0; i < DX_BLOCK / 2; ++i) xacc[i] = 0.f;
          fence_regs(xacc);
          const uint32_t row_addr = smem_u32(dgs.base + (size_t)srow[4] * F4);
          wgmma_fence();
          for (int off = 0; off < F4; off += ROWS)
            bwd_slab<DX_BLOCK, ROWS>(xacc, full, empty, slot, ph, stages, ring, L.slot,
                                     row_addr, srow[4] & dgs.mask, off,
                                     min(ROWS, F4 - off) / 16, lane);
          fence_regs(xacc);
#pragma unroll
          for (int j = 0; j < DX_BLOCK / 8; ++j)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = 16 * warp + g + 8 * hr, c = cb * DX_BLOCK + 8 * j + 2 * tq;
              if (r < HW && c < C2)
                *reinterpret_cast<uint32_t*>(dx + (orow + r) * C + rank * C2 + c) =
                    pack_bf16(xacc[4 * j + 2 * hr], xacc[4 * j + 2 * hr + 1]);
            }
        }
      }
#pragma unroll
      for (int k = 0; k < CL; ++k) mbar_arrive_remote(map_rank(freeb, (rank + k) % CL));
      if (add_dhs) {
#pragma unroll
        for (int i = 0; i < HF / 4; ++i) {
          const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dnext[i]));
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
        *reinterpret_cast<uint32_t*>(dh0 + (b * HW + r) * F + ch) = pack_bf16(dh[k], dh[k + 1]);
        *reinterpret_cast<uint32_t*>(dc0 + (b * HW + r) * F + ch) = pack_bf16(dc[k], dc[k + 1]);
        if (const_x) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 s = *dxs_at(r, q * HF + lc);
            *reinterpret_cast<uint32_t*>(dxg_sum + (b * HW + r) * F4 + q * F + ch) =
                pack_bf16(s.x, s.y);
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
