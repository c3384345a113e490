// The general-shape ConvLSTM kernels: K5 and K6 at every shape the TPU
// kernels take (any B, T, H, W, F and C; bf16 or f32 activations; f32 or
// bf16 gates), where the wgmma kernels of convlstm_wgmma.cuh do not run
// (convlstm_launch.cuh's route: H*W > 64, F off their multiples, f32 above
// F = 128, C off the multiples of 16 or too wide for their rings).
//
// Design.  One launch runs a recurrence's whole time loop, as the TPU's one
// pallas_call does: a cluster of `cl` CTAs a sample (GenGeo: the fewest, up
// to 16, that keep a sample's h and dgates in shared memory), CTA r owning
// channels [F r / cl, F (r + 1) / cl) of all four gates so that the cell
// stays in the CTA.  Every product runs on the tensor cores with mma.sync:
// bf16 m16n8k16 -> f32; with f32 activations on the f64 tensor cores
// (m16n8k16 f64: exact products, f64 sums; 3xTF32, hi hi + hi lo + lo hi on
// m16n8k8, in K5's dx).  Eight warps a CTA, each a 32 x 32 block of the
// output (2 m16 x 4 n8 tiles); a CTA's blocks run eight at a time
// ("passes").  Weights come packed by the wrapper in fragment order (K rows
// padded to 16 a tap, columns to 8) and stream through a
// 3-stage cp.async ring of slabs of up to 4 16-deep k-blocks; the stream
// repeats every step, so the ring runs on across steps and the next step's
// first slabs land during the epilogue.  The k-block loop is software-
// pipelined (the next k-block's A and this one's B load before its
// products).  Sums with bf16 gates: the tensor cores' f32 sums of at most
// GEN_PROMOTE_KB (4) k-blocks join an f64 sum (a tap's 8 read 1.03 of the
// cell-state bound); the taps' sum and the x projection (K5) or xg (K6)
// are rounded to the gate dtype apart and added in it, as the TPU kernel
// does.  With f32 gates and bf16 activations the sums are f32.
// - forward (gen_fwd_kernel): each CTA holds h_{t-1} of its whole sample
//   with a one-pixel zero halo in shared memory (channel rows padded so
//   that ldmatrix reads them without bank conflicts); the nine taps read it
//   through ldmatrix.  xg_t is read into registers before the products.
//   The epilogue runs the cell (lstm_cell_ieee) on a channel's four gates,
//   which the packing puts in two neighbouring lanes (one shuffle), keeps c
//   in shared memory, stages h_t and writes it into every CTA's copy over
//   distributed shared memory (st.shared::cluster); one cluster barrier a
//   step with two copies of h, two with one.  The step's outputs leave in
//   whole rows of the CTA's channels (hs and cs from the staging and the
//   cell state, the gates through a staged tile where it fits).  K5 first
//   runs its x
//   projection G(x Wx + bx) over all B T H W rows as one GEMM
//   (gen_xproj_kernel) and hands it to the same recurrence as xg.
// - BPTT (gen_bwd_kernel): per step a pointwise pass (the cell backward
//   from the saved residuals; dgates rounded to the activation type, into
//   the dgates output and into a zero-haloed tile of the CTA's own 4 nc
//   columns in shared memory; K5's dbx from per-channel sums in a fixed
//   order; K6's time-constant dxg summed in f32, each cell by one thread),
//   then each CTA multiplies its own dgate columns by W^T into a partial
//   dh_{t-1} over all F channels (the transposed taps, K = 9 x 4 nc), a
//   cluster barrier, and each CTA sums its channels' partials over the
//   cluster in rank order (ld.shared::cluster), so the result does not
//   depend on timing.  (dh, dc) are carried in shared memory.
// - after the BPTT: K5's dx = dG Wx^T (gen_dx_kernel, fragments of dG read
//   from global memory) and the weight GEMM (gen_wgrad_kernel: dW and dWx
//   as one (C + 9F) x 4F product over the B T H W rows, 64 x 128 tiles
//   staged by cp.async, split in K with the partials summed in split order).
// What does not fit a CTA's 227 KB (GenGeo decides, in this order) moves to
// global scratch with the same layout: the cell state and h staging, then
// h's copy (one for the cluster, double-buffered, read through L2); in the
// BPTT the carries, the dgates tile, then the partials.  No float atomics:
// two calls give bit-identical results.
//
// What bounds it: the products, (C + 9F) x 4F a position and step forward
// and twice that backward (PERF.md counts them at the tensor cores' bf16
// rate, or a third of their TF32 rate for f32), but on the H100 each step of
// a sample is a chain of dependent k-blocks on one CTA's eight warps: the
// f64 tensor cores (f32 forwards), the f64 promotion (bf16 gates), the
// epilogue's cell math and scattered stores and the cluster barrier take
// the step's time, not the card's tensor-core rate.
#pragma once

#include "convlstm_wgmma.cuh"

namespace mmvae {
namespace {

constexpr int GEN_THREADS = 256, GEN_WARPS = 8, GEN_STAGES = 3, GEN_MAX_CLUSTER = 16;
constexpr int GEN_SMS = 132;
constexpr int GEN_SMEM_LIMIT = 232448;
constexpr int GEN_RED_BYTES = GEN_THREADS * 4 * 4;  // K5's BPTT: per-slice column sums
// Rows of the weight GEMM summed in one run before they join the total.
constexpr int GEN_WGRAD_RUN = 1024;
constexpr int GEN_WG_BM = 64, GEN_WG_BN = 128, GEN_WG_BK = 32, GEN_WG_PAD = 8;
// bf16 gates: the tensor cores' f32 sums of this many 16-deep k-blocks at
// most join the f64 sum (a tap's 8 read 1.03 of the cell-state bound at
// (64, 20, 16, 16, 128) in PERF.md's log; 4 read as f64 does)
constexpr int GEN_PROMOTE_KB = 4;

__host__ __device__ inline int gceil(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int gup(int a, int b) { return gceil(a, b) * b; }
__host__ __device__ inline long gup128(long a) { return (a + 127) / 128 * 128; }
__host__ __device__ inline int gmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int gmax(int a, int b) { return a > b ? a : b; }

// A row of n elements of es bytes, padded so that its bytes are an odd
// multiple of 16: eight rows read by ldmatrix fall in eight bank groups.
__host__ __device__ inline int gen_stride(int n, int es) {
  const int e = 16 / es, s = gup(gmax(n, 1), e);
  return (s / e) % 2 ? s : s + e;
}

// The least CTAs a sample: at most 32 channels a CTA (4 n8 tiles of 32
// columns) and B cl at least the SMs (gen_geometry takes more where the
// sample's h or dgates do not fit shared memory).
__host__ __device__ inline int gen_cluster_base(int B, int F) {
  return gmin(gmax(gceil(F, 32), gceil(GEN_SMS, gmax(B, 1))), GEN_MAX_CLUSTER);
}

// Weight-tile bytes of one 16-deep k-block and one n8 tile of the
// recurrences: bf16 fragments (2 registers a lane), or f32 weights as they
// are (4: the f64 tensor cores' B fragments of four k4 steps, converted
// where they are used; packed as f64 they doubled the ring's bytes and
// cost more than the conversions).  K5's dx takes f32 weights as two k8
// halves of TF32 hi and lo (8 registers: 1024 bytes a tile).
__host__ __device__ inline int gen_tile_bytes(int es) { return es == 2 ? 256 : 512; }

// The n8 tiles pass p touches when the CTA's blocks (m fastest: block i is
// m-block i % mb, n-block i / mb) run eight a pass: [*lo, *hi).
__host__ __device__ inline void gen_pass_tiles(int p, int mb, int nt, int* lo, int* hi) {
  const int blocks = mb * gceil(nt, 4);
  const int first = p * GEN_WARPS, last = gmin(blocks, first + GEN_WARPS) - 1;
  *lo = first / mb * 4;
  *hi = gmin(nt, (last / mb + 1) * 4);
}

struct GenPlan {  // one GEMM of the recurrence: M positions x nt n8 tiles x nkb k-blocks
  int nkb, nt, mb, passes, pass_tiles, pbk, stage_bytes;
};

__host__ __device__ inline GenPlan gen_plan(int HW, int nt, int nkb, int tile_bytes) {
  GenPlan p;
  p.nkb = nkb;
  p.nt = nt;
  p.mb = gceil(HW, 32);
  p.passes = gceil(p.mb * gceil(nt, 4), GEN_WARPS);
  p.pass_tiles = 0;
  for (int q = 0; q < p.passes; ++q) {
    int lo, hi;
    gen_pass_tiles(q, p.mb, nt, &lo, &hi);
    p.pass_tiles = gmax(p.pass_tiles, hi - lo);
  }
  const int kb_bytes = p.pass_tiles * tile_bytes;
  p.pbk = gmax(1, gmin(4, 8192 / kb_bytes));
  p.stage_bytes = p.pbk * kb_bytes;
  return p;
}

// The launch geometry of the general kernels at (B, T, H, W, C, F) for
// activations of es bytes; convlstm_kernels.general_geometry computes the
// same numbers.  Offsets are bytes into shared memory or, for what did not
// fit, into the global scratch.
struct GenGeo {
  int cl, nc, Fp, es;
  // forward
  GenPlan f;
  int Fs;                          // the row stride of h's copy
  int state_res, hbuf, gst_res;    // cst / hst resident; h copies (2, 1, 0: global); gates staged
  int f_cst, f_hst, f_h, f_gst, f_smem;
  long fs_cst, fs_hst, fs_h, f_scratch;
  // BPTT
  GenPlan b;
  int Kt, Ks, Fq;                  // 4 nc padded to 16, the dgates tile's row, the partials'
  int carry_res, dg_res, part_res;
  int b_red, b_dh, b_dc, b_dg, b_part, b_smem;
  long bs_dh, bs_dc, bs_dg, bs_part, b_scratch;
};

__host__ __device__ inline GenGeo gen_geometry_cl(int B, int H, int W, int F, int es, int cl) {
  GenGeo g;
  const int HW = H * W, halo = (H + 2) * (W + 2);
  g.es = es;
  g.cl = cl;
  g.nc = gceil(F, g.cl);
  g.Fp = gup(F, 16);
  const long cells = (long)HW * g.nc;
  // forward: ring, then the state, h's copy, a second copy of h
  g.f = gen_plan(HW, gceil(4 * g.nc, 8), 9 * g.Fp / 16, gen_tile_bytes(es));
  g.Fs = gen_stride(g.Fp, es);
  long used = gup128((long)GEN_STAGES * g.f.stage_bytes);
  const long state = gup128(cells * 4) + gup128(cells * es);
  g.state_res = used + state <= GEN_SMEM_LIMIT;
  g.f_cst = (int)used;
  g.f_hst = (int)(used + gup128(cells * 4));
  used += g.state_res ? state : 0;
  const long hb = gup128((long)halo * g.Fs * es);
  g.hbuf = used + 2 * hb <= GEN_SMEM_LIMIT ? 2 : used + hb <= GEN_SMEM_LIMIT ? 1 : 0;
  used += g.hbuf * hb;
  g.f_h = g.state_res ? g.f_hst + (int)gup128(cells * es) : g.f_cst;
  // the saving forward's gates, staged for whole-row stores, where they fit
  const long gb = gup128(4 * cells * es);
  g.gst_res = g.state_res && used + gb <= GEN_SMEM_LIMIT;
  g.f_gst = (int)used;
  used += g.gst_res ? gb : 0;
  g.f_smem = (int)used;
  // its scratch: (B, cl) state slices, then (B, 2) copies of h
  long s = 0;
  g.fs_cst = s;
  g.fs_hst = s += g.state_res ? 0 : gup128((long)B * g.cl * cells * 4);
  s += g.state_res ? 0 : gup128((long)B * g.cl * cells * es);
  g.fs_h = s;
  s += g.hbuf ? 0 : gup128((long)B * 2 * halo * g.Fs * es);
  g.f_scratch = s;
  // BPTT: ring and K5's column sums, then the carries, the dgates tile, the partials
  g.Kt = gup(4 * g.nc, 16);
  g.Ks = gen_stride(g.Kt, es);
  g.Fq = gup(F, 8);
  g.Fq += (40 - g.Fq % 32) % 32;  // = 8 mod 32: the partials' float2 stores miss no bank
  g.b = gen_plan(HW, gceil(F, 8), 9 * g.Kt / 16, gen_tile_bytes(es));
  used = gup128((long)GEN_STAGES * g.b.stage_bytes);
  g.b_red = (int)used;
  used += GEN_RED_BYTES;
  const long carry = gup128(cells * 4);
  g.carry_res = used + 2 * carry <= GEN_SMEM_LIMIT;
  g.b_dh = (int)used;
  g.b_dc = (int)(used + carry);
  used += g.carry_res ? 2 * carry : 0;
  const long dgb = gup128((long)halo * g.Ks * es);
  g.dg_res = used + dgb <= GEN_SMEM_LIMIT;
  g.b_dg = (int)used;
  used += g.dg_res ? dgb : 0;
  const long pb = gup128((long)HW * g.Fq * 4);
  g.part_res = used + pb <= GEN_SMEM_LIMIT;
  g.b_part = (int)used;
  used += g.part_res ? pb : 0;
  g.b_smem = (int)used;
  s = 0;
  g.bs_dh = s;
  g.bs_dc = s += g.carry_res ? 0 : gup128((long)B * g.cl * cells * 4);
  s += g.carry_res ? 0 : gup128((long)B * g.cl * cells * 4);
  g.bs_dg = s;
  s += g.dg_res ? 0 : gup128((long)B * g.cl * halo * g.Ks * es);
  g.bs_part = s;
  s += g.part_res ? 0 : gup128((long)B * g.cl * HW * g.Fq * 4);
  g.b_scratch = s;
  return g;
}

// The geometry with the fewest CTAs a sample, from gen_cluster_base up to 8
// and then 16 (a non-portable cluster size), that keeps h's copy (forward),
// the dgates tile and the partials (BPTT) in shared memory; else 16.
__host__ __device__ inline GenGeo gen_geometry(int B, int H, int W, int F, int es) {
  const int top = gmin(GEN_MAX_CLUSTER, F);
  GenGeo g;
  for (int cl = gmin(gen_cluster_base(B, F), top);; cl = cl < 8 ? cl + 1 : GEN_MAX_CLUSTER) {
    cl = gmin(cl, top);
    g = gen_geometry_cl(B, H, W, F, es, cl);
    if ((g.hbuf > 0 && g.dg_res && g.part_res) || cl == top) return g;
  }
}

// The weight GEMM's shared memory.
__host__ __device__ inline int gen_wgrad_smem(int es) {
  return GEN_STAGES * GEN_WG_BK * (2 * GEN_WG_PAD + GEN_WG_BM + GEN_WG_BN) * es;
}

// Split-K of the weight GEMM over `rows` rows: about two CTAs an SM, each
// split at least 8 slabs of rows.
__host__ __device__ inline int gen_wgrad_splits(int rows, int C, int F) {
  const int mt = gceil(C, GEN_WG_BM) + 9 * gceil(F, GEN_WG_BM);
  const int tiles = mt * gceil(4 * F, GEN_WG_BN);
  return gmax(1, gmin(gceil(2 * GEN_SMS, tiles), rows / (8 * GEN_WG_BK)));
}

// The cell with bf16 gates from IEEE expf, division and tanhf, each op
// rounded to bf16 as torch's bf16 ops round it, so that from the same
// pre-activations it gives the plain version's bits (lstm_cell_fast's
// special-function unit errs by a few f32 ulps, which can flip a bf16
// rounding); with f32 gates it is lstm_cell_fast, bit for bit.
template <typename G>
__device__ __forceinline__ Cell lstm_cell_ieee(float pi, float pf, float pg, float po, float c) {
  if constexpr (std::is_same<G, float>::value) {
    return lstm_cell_fast<G>(pi, pf, pg, po, c);
  } else {
    auto sig = [](float v) {
      return round_to<G>(1.f / round_to<G>(1.f + round_to<G>(expf(-v))));
    };
    Cell r;
    r.i = sig(pi);
    r.f = sig(round_to<G>(pf + 1.f));
    r.g = round_to<G>(tanhf(pg));
    r.o = sig(po);
    r.c = round_to<G>(round_to<G>(r.f * c) + round_to<G>(r.i * r.g));
    r.h = round_to<G>(r.o * round_to<G>(tanhf(r.c)));
    return r;
  }
}

// ---------------------------------------------------------------------------
// Fragments
// ---------------------------------------------------------------------------

// An accumulator pair (columns n, n + 1 of a row) stored as one 4- or
// 8-byte word where both fit the row and the word is aligned, else alone.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int n, int ncols, float v0, float v1) {
  if (n + 1 < ncols && !(reinterpret_cast<uintptr_t>(row + n) & (2 * sizeof(T) - 1))) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
    else
      *reinterpret_cast<uint32_t*>(row + n) = pack_bf16(v0, v1);
  } else {
    if (n < ncols) row[n] = from_f<T>(v0);
    if (n + 1 < ncols) row[n + 1] = from_f<T>(v1);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// f32 operands on the f64 tensor cores (D64: the general forward's products).
struct D64 {};

// A k-block's A operand: bf16 one m16k16 fragment; f32 two m16k8 (TF32 hi,
// lo: K5's dx) or, D64, the same two m16k8 fragments' f32 values, which
// hold the f64 m16n8k16 fragment (row g or g + 8, column 4 s + tq): column
// 4 s + tq, row g + 8 h in v[s / 2][2 (s % 2) + h].
template <typename A>
struct AFrag;
template <>
struct AFrag<bf16> {
  uint32_t a[4];
};
template <>
struct AFrag<float> {
  uint32_t hi[2][4], lo[2][4];
};
template <>
struct AFrag<D64> {
  uint32_t v[2][4];
};
// The D64 fragment's values as f64, converted once a k-block.
struct D64Vals {
  double a[4][2];  // [k4 step][row g, g + 8]
};
__device__ __forceinline__ D64Vals d64_vals(const AFrag<D64>& f) {
  D64Vals d;
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int h = 0; h < 2; ++h) d.a[st][h] = __uint_as_float(f.v[st >> 1][2 * (st & 1) + h]);
  return d;
}

__device__ __forceinline__ void split_frag(const uint32_t (&v)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(__uint_as_float(v[i]), hi[i], lo[i]);
}

// A fragment through ldmatrix: `addr` is this lane's row (lane & 15) at the
// k-block's first column, plus 16 bytes for lanes 16-31.
__device__ __forceinline__ void lda_smem(AFrag<bf16>& f, uint32_t addr) { ldsm_x4_addr(f.a, addr); }
__device__ __forceinline__ void lda_smem(AFrag<D64>& f, uint32_t addr) {
  ldsm_x4_addr(f.v[0], addr);
  ldsm_x4_addr(f.v[1], addr + 32);
}

// A fragment from global memory, lane (g, tq): rows r0 (g) and r1 (g + 8)
// start at p0, p1 (the k-block's first column); columns at or past `kmax`
// read 0 (kmax >= 16: none).  `cg`: the data was written in this launch by
// other CTAs (ld.global.cg), else read-only input (ld.global.nc).
template <bool CG>
__device__ __forceinline__ float ldg_f(const float* p) {
  return CG ? __ldcg(p) : __ldg(p);
}
template <bool CG>
__device__ __forceinline__ float ldg_f(const bf16* p) {
  const unsigned short u = CG ? __ldcg(reinterpret_cast<const unsigned short*>(p))
                              : __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float((uint32_t)u << 16);
}
template <bool CG>
__device__ __forceinline__ void lda_global(AFrag<bf16>& f, const bf16* p0, const bf16* p1, int tq,
                                           int kmax) {
  const int k = 2 * tq;
  const bf16* rows[2] = {p0, p1};
  if (kmax >= 16 && !((reinterpret_cast<uintptr_t>(p0) | reinterpret_cast<uintptr_t>(p1)) & 3)) {
    // whole pairs on 4-byte boundaries: one 32-bit load a register
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned* q = reinterpret_cast<const unsigned*>(rows[i & 1] + k + 8 * (i >> 1));
      f.a[i] = CG ? __ldcg(q) : __ldg(q);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bf16* p = rows[i & 1] + k + 8 * (i >> 1);
    const int kk = k + 8 * (i >> 1);
    const float lo = kk < kmax ? ldg_f<CG>(p) : 0.f, hi = kk + 1 < kmax ? ldg_f<CG>(p + 1) : 0.f;
    f.a[i] = pack_bf16(lo, hi);  // exact: both are bf16 values
  }
}
template <bool CG>
__device__ __forceinline__ void lda_global_v(uint32_t (&v)[2][4], const float* p0, const float* p1,
                                             int tq, int kmax) {
  const float* rows[2] = {p0, p1};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = 8 * h + tq + 4 * (i >> 1);
      v[h][i] = __float_as_uint(kk < kmax ? ldg_f<CG>(rows[i & 1] + kk) : 0.f);
    }
}
template <bool CG>
__device__ __forceinline__ void lda_global(AFrag<float>& f, const float* p0, const float* p1, int tq,
                                           int kmax) {
  uint32_t v[2][4];
  lda_global_v<CG>(v, p0, p1, tq, kmax);
#pragma unroll
  for (int h = 0; h < 2; ++h) split_frag(v[h], f.hi[h], f.lo[h]);
}
template <bool CG>
__device__ __forceinline__ void lda_global(AFrag<D64>& f, const float* p0, const float* p1, int tq,
                                           int kmax) {
  lda_global_v<CG>(f.v, p0, p1, tq, kmax);
}

// A k-block's B fragments of one n8 tile, this lane's 8, 32 or 16 bytes
// of the packed tile: bf16 (b0, b1); f32 the k8 halves' (hi b0 b1, lo b0
// b1); D64 B[4 s + tq][g], s < 4.
template <typename A>
struct BFrag;
template <>
struct BFrag<bf16> {
  uint2 v;
};
template <>
struct BFrag<float> {
  uint4 v[2];
};
template <>
struct BFrag<D64> {
  float4 v;
};
__device__ __forceinline__ void ldb(BFrag<bf16>& b, const unsigned char* p) {
  b.v = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void ldb(BFrag<float>& b, const unsigned char* p) {
  b.v[0] = *reinterpret_cast<const uint4*>(p);
  b.v[1] = *reinterpret_cast<const uint4*>(p + 16);
}
__device__ __forceinline__ void ldb(BFrag<D64>& b, const unsigned char* p) {
  b.v = *reinterpret_cast<const float4*>(p);
}

// part += A B for one k-block and one n8 tile.
__device__ __forceinline__ void mma_kblock(float (&part)[4], const AFrag<bf16>& f,
                                           const BFrag<bf16>& b) {
  mma_bf16(part, f.a, b.v.x, b.v.y);
}
__device__ __forceinline__ void mma_kblock(float (&part)[4], const AFrag<float>& f,
                                           const BFrag<float>& b) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t bh[2] = {b.v[h].x, b.v[h].y}, bl[2] = {b.v[h].z, b.v[h].w};
    mma_tf32(part, f.lo[h], bh);
    mma_tf32(part, f.hi[h], bl);
    mma_tf32(part, f.hi[h], bh);
  }
}

// acc += A B for one k-block and one n8 tile on the f64 tensor cores
// (m16n8k16: A (row g + 8 h, column 4 s + tq) in a[s][h], B (4 s + tq, g)
// in b's s-th float): the f32 products exact, their sums in f64.
__device__ __forceinline__ void mma_kblock(double (&acc)[4], const D64Vals& a,
                                           const BFrag<D64>& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(acc[0]), "+d"(acc[1]), "+d"(acc[2]), "+d"(acc[3])
      : "d"(a.a[0][0]), "d"(a.a[0][1]), "d"(a.a[1][0]), "d"(a.a[1][1]), "d"(a.a[2][0]),
        "d"(a.a[2][1]), "d"(a.a[3][0]), "d"(a.a[3][1]), "d"((double)b.v.x), "d"((double)b.v.y),
        "d"((double)b.v.z), "d"((double)b.v.w));
}

// The fragment bytes of one lane in a weight tile.
template <typename A>
__host__ __device__ constexpr int gen_lane_bytes() {
  return std::is_same<A, float>::value ? 32 : std::is_same<A, D64>::value ? 16 : 8;
}

// One slab of the weight stream into ring stage `stage`: k-blocks [kb0,
// kb0 + n) of the pass's tiles [tlo, thi), the rank's packed weights
// (nkb, nt, 32 lanes) of `tile` bytes a tile.
__device__ __forceinline__ void gen_issue_slab(unsigned char* dst, const unsigned char* w, int nkb,
                                               int nt, int kb0, int n, int tlo, int thi,
                                               int tile) {
  const int row = (thi - tlo) * tile / 16;  // 16-byte chunks a k-block
  for (int c = threadIdx.x; c < n * row; c += GEN_THREADS) {
    const int k = c / row, o = c - k * row;
    cp_async16(dst + (size_t)c * 16, w + ((size_t)(kb0 + k) * nt + tlo) * tile + (size_t)o * 16,
               true);
  }
}

// acc += part; part = 0.
template <typename S>
__device__ __forceinline__ void gen_promote(S (&acc)[2][4][4], float (&part)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] += (S)part[i][j][e];
        part[i][j][e] = 0.f;
      }
}

template <typename S>
__device__ __forceinline__ void gen_zero(S (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Position p's row in a zero-haloed (H + 2) x (W + 2) grid.
__device__ __forceinline__ int gen_halo(int p, int W) { return (p / W + 1) * (W + 2) + p % W + 1; }

// Copy `count` elements from `src` (this CTA's shared memory or global
// memory) to `dst` in CTA `rank`'s shared memory or, rank < 0, global
// memory, in units of `unit` bytes (16, 8, 4 or 2; both addresses aligned).
__device__ __forceinline__ void gen_store_unit(unsigned char* dst, int rank,
                                               const unsigned char* src, int unit) {
  if (rank >= 0) {
    const uint32_t a = map_rank(dst, (uint32_t)rank);
    if (unit == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x),
                   "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    } else if (unit == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(v.x), "r"(v.y)
                   : "memory");
    } else if (unit == 4) {
      st_cluster_b32(a, *reinterpret_cast<const uint32_t*>(src));
    } else {
      asm volatile("st.shared::cluster.b16 [%0], %1;\n" ::"r"(a),
                   "h"(*reinterpret_cast<const unsigned short*>(src))
                   : "memory");
    }
  } else {
    if (unit == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else if (unit == 8)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
    else if (unit == 4)
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    else
      *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  }
}

// The widest unit of 16, 8, 4 or es bytes that divides each of the byte
// counts.
__device__ __forceinline__ int gen_unit(int es, int a, int b, int c, int d) {
  int u = 16;
  while (u > es && ((a | b | c | d) & (u - 1))) u >>= 1;
  return u;
}

#ifdef GEN_PHASE_TIMES
// Where a launch's cycles go (a diagnostic build): thread 0 of the first CTA
// adds each phase's clock64 cycles into gen_phase_t[kernel][phase].
__device__ unsigned long long gen_phase_t[2][8];
#define GEN_TICK(kernel, i)                                                      \
  do {                                                                           \
    if (threadIdx.x == 0 && blockIdx.x == 0) gen_phase_t[kernel][i] += clock64() - gen_tick_; \
    gen_tick_ = clock64();                                                       \
  } while (0)
#define GEN_TICK_INIT() long long gen_tick_ = clock64()
#else
#define GEN_TICK(kernel, i) \
  do {                      \
  } while (0)
#define GEN_TICK_INIT() \
  do {                  \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

struct GenFwdArgs {
  const void* xg;    // (B, xg_steps, HW, 4F) of type XT: K6's xg or K5's projection
  const void* wpk;   // (cl, nkb, nt, 32 lanes): W by rank, fragment order
  const void *c0, *h0;
  void *out_h, *out_c, *out_g;
  unsigned char* scratch;
  int Tn, H, W, F, xg_steps;
  GenGeo g;
};

// All T steps of sample blockIdx.x / cl: gates_t = G(G(conv3x3(h_{t-1}, W))
// + G(xg_t)), xg read at step 0 throughout when xg_steps is 1 (K6); K5
// passes its x projection G(x_t Wx + bx) as xg (gen_xproj_kernel), in the
// gate dtype XT = G.  MODE: kSave (hs, cs, gates), kHiddens (hs, c_T),
// kLast (h_T, c_T).
template <typename A, typename G, typename XT, int MODE>
__global__ void __launch_bounds__(GEN_THREADS, 1) gen_fwd_kernel(const GenFwdArgs P) {
  extern __shared__ __align__(128) unsigned char smem[];
  // f32 activations: products on the f64 tensor cores, summed in f64
  constexpr bool D = std::is_same<A, float>::value;
  using FA = std::conditional_t<D, D64, A>;
  constexpr int ES = sizeof(A), LB = gen_lane_bytes<FA>();
  constexpr bool F64 = !std::is_same<G, float>::value;  // bf16 gates: f64 sums
  using Sum = std::conditional_t<F64 || D, double, float>;
  const GenGeo& g = P.g;
  const GenPlan& pl = g.f;
  const int rank = (int)cluster_rank(), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x / g.cl;
  const int H = P.H, W = P.W, F = P.F, Tn = P.Tn, HW = H * W, W2 = W + 2, F4 = 4 * F;
  const int halo = (H + 2) * W2;
  const int c_lo = F * rank / g.cl, nc = F * (rank + 1) / g.cl - c_lo, ncm = g.nc;
  const int tile = gen_tile_bytes(ES), fkb = g.Fp / 16;
  const size_t slice = (b * g.cl + rank) * (size_t)HW * ncm;
  float* cst = g.state_res ? reinterpret_cast<float*>(smem + g.f_cst)
                           : reinterpret_cast<float*>(P.scratch + g.fs_cst) + slice;
  A* hst = g.state_res ? reinterpret_cast<A*>(smem + g.f_hst)
                       : reinterpret_cast<A*>(P.scratch + g.fs_hst) + slice;
  const size_t hcopy = (size_t)halo * g.Fs;
  A* hbase = g.hbuf ? reinterpret_cast<A*>(smem + g.f_h)
                    : reinterpret_cast<A*>(P.scratch + g.fs_h) + b * 2 * hcopy;
  const XT* xg = static_cast<const XT*>(P.xg);
  const unsigned char* wr = static_cast<const unsigned char*>(P.wpk) +
                            (size_t)rank * pl.nkb * pl.nt * tile;
  // the step's outputs leave in whole rows of the CTA's channels: hs from
  // the h staging, cs from the cell state, the gates from their staging
  // (kSave, where it fits; else each cell's thread stores them)
  A* gst = reinterpret_cast<A*>(smem + g.f_gst);  // [q][p][ncm]
  const bool stage_g = MODE == kSave && g.gst_res;
  A* oh = static_cast<A*>(P.out_h);
  A* oc = static_cast<A*>(P.out_c);
  A* og = static_cast<A*>(P.out_g);

  // h's copy: zero (halo and padding), then h_0 of every channel (each CTA
  // its own copy; with a global copy the cluster shares one, each CTA its
  // channels); c_0 of the CTA's channels.
  {
    const A* h0 = static_cast<const A*>(P.h0);
    const A* c0 = static_cast<const A*>(P.c0);
    if (g.hbuf) {
      for (size_t i = tid; i < g.hbuf * hcopy; i += GEN_THREADS) hbase[i] = from_f<A>(0.f);
      __syncthreads();
      for (int i = tid; i < HW * F; i += GEN_THREADS) {
        const int p = i / F, ch = i - p * F;
        hbase[(size_t)gen_halo(p, W) * g.Fs + ch] =
            from_f<A>(round_to<G>(to_f(h0[(b * HW + p) * F + ch])));
      }
    } else {
      for (size_t i = rank * GEN_THREADS + tid; i < 2 * hcopy; i += (size_t)g.cl * GEN_THREADS)
        hbase[i] = from_f<A>(0.f);
      __threadfence();
      cluster_sync();
      for (int i = tid; i < HW * nc; i += GEN_THREADS) {
        const int p = i / nc, ch = c_lo + i % nc;
        hbase[(size_t)gen_halo(p, W) * g.Fs + ch] =
            from_f<A>(round_to<G>(to_f(h0[(b * HW + p) * F + ch])));
      }
    }
    for (int i = tid; i < HW * nc; i += GEN_THREADS) {
      const int p = i / nc, lc = i - p * nc;
      cst[p * ncm + lc] = round_to<G>(to_f(c0[(b * HW + p) * F + c_lo + lc]));
    }
  }
  __threadfence();
  cluster_sync();  // every copy of h_0 whole before any CTA writes h_1 into it

  const int spp = gceil(pl.nkb, pl.pbk), sps = spp * pl.passes;
  const long total = (long)Tn * sps;
  auto issue = [&](long s) {
    if (s < total) {
      const int ls = (int)(s % sps), pass = ls / spp, kb0 = (ls - pass * spp) * pl.pbk;
      int tlo, thi;
      gen_pass_tiles(pass, pl.mb, pl.nt, &tlo, &thi);
      gen_issue_slab(smem + (s % GEN_STAGES) * pl.stage_bytes, wr, pl.nkb, pl.nt, kb0,
                     gmin(pl.pbk, pl.nkb - kb0), tlo, thi, tile);
    }
    cp_async_commit();
  };
  for (int s = 0; s < GEN_STAGES - 1; ++s) issue(s);

  long slab = 0;
  GEN_TICK_INIT();
  for (int t = 0; t < Tn; ++t) {
    const A* hcur = hbase + (g.hbuf == 1 ? 0 : (size_t)(t & 1) * hcopy);
    A* hnext = hbase + (g.hbuf == 1 ? 0 : (size_t)((t + 1) & 1) * hcopy);
    for (int pass = 0; pass < pl.passes; ++pass) {
      int tlo, thi;
      gen_pass_tiles(pass, pl.mb, pl.nt, &tlo, &thi);
      const int blk = pass * GEN_WARPS + warp;
      const bool active = blk < pl.mb * gceil(pl.nt, 4);
      const int mb0 = (blk % pl.mb) * 32, nt0 = (blk / pl.mb) * 4;
      // this lane's rows in h's haloed copy: for ldmatrix (row lane & 15 of
      // each m16 tile) and for the scalar loads (rows g, g + 8); rows past
      // HW read position 0
      int hl[2], hs[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = mb0 + 16 * i + (lane & 15);
        hl[i] = gen_halo(p < HW ? p : 0, W);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mb0 + 16 * i + gq + 8 * h;
          hs[i][h] = gen_halo(q < HW ? q : 0, W);
        }
      }
      // the tap and channel block of the next k-block to load; the position
      // in its tap of the next one to multiply
      int tap = 0, tk0 = 0, toff = -W2 - 1, cpos = 0;
      Sum acc[2][4][4];
      float part[2][4][4];
      gen_zero(acc);
      gen_zero(part);
      // xg_t rounded to G, loaded before the products so that its latency
      // hides behind them
      float xr[2][4][4];
      if (active) {
        const size_t row0 = (b * P.xg_steps + (P.xg_steps > 1 ? t : 0)) * HW;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = mb0 + 16 * i + gq + 8 * (e >> 1);
              const int n = (nt0 + j) * 8 + 2 * tq + (e & 1), lc = n >> 2;
              xr[i][j][e] = p < HW && lc < nc
                                ? round_to<G>(to_f(xg[(row0 + p) * F4 + (n & 3) * F + c_lo + lc]))
                                : 0.f;
            }
      }
      for (int ks = 0; ks < spp; ++ks, ++slab) {
        GEN_TICK(0, 0);
        cp_async_wait<GEN_STAGES - 2>();
        __syncthreads();
        GEN_TICK(0, 1);
        issue(slab + GEN_STAGES - 1);
        const unsigned char* st = smem + (slab % GEN_STAGES) * pl.stage_bytes;
        const int kb0 = ks * pl.pbk, kbn = gmin(pl.pbk, pl.nkb - kb0);
        if (!active) continue;
        // The A fragments of the next k-block's two m16 tiles (in k-block
        // order: the tap and its columns advance here).
        auto load_a = [&](AFrag<FA>(&fr)[2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (g.hbuf)
              lda_smem(fr[i], smem_u32(hcur + (size_t)(hl[i] + toff) * g.Fs + tk0) +
                                  (lane >> 4) * 16);
            else
              lda_global<true>(fr[i], hcur + (size_t)(hs[i][0] + toff) * g.Fs + tk0,
                               hcur + (size_t)(hs[i][1] + toff) * g.Fs + tk0, tq, 16);
          }
          tk0 += 16;
          if (tk0 == g.Fp) {
            tk0 = 0;
            ++tap;
            toff = (tap / 3 - 1) * W2 + tap % 3 - 1;
          }
        };
        // software-pipelined: the next k-block's A and this one's B load
        // before this one's products
        AFrag<FA> fr[2];
        load_a(fr);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < kbn) {
            BFrag<FA> bf[4];
            const unsigned char* bk =
                st + ((size_t)kk * (thi - tlo) + nt0 - tlo) * tile + lane * LB;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nt0 + j < pl.nt) ldb(bf[j], bk + (size_t)j * tile);
            AFrag<FA> nx[2];
            if (kk + 1 < kbn) load_a(nx);
            if constexpr (D) {
              const D64Vals a0 = d64_vals(fr[0]), a1 = d64_vals(fr[1]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (nt0 + j < pl.nt) {
                  mma_kblock(acc[0][j], a0, bf[j]);
                  mma_kblock(acc[1][j], a1, bf[j]);
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (nt0 + j < pl.nt) {
                  mma_kblock(part[0][j], fr[0], bf[j]);
                  mma_kblock(part[1][j], fr[1], bf[j]);
                }
              }
              // with bf16 gates the products join the f64 sum every
              // GEN_PROMOTE_KB k-blocks and at the end of a tap, with f32
              // gates at the end of a slab
              const bool tap_last = ++cpos == fkb;
              if (tap_last) cpos = 0;
              if (F64 ? tap_last || cpos % GEN_PROMOTE_KB == 0 : kk == kbn - 1)
                gen_promote(acc, part);
            }
            if (kk + 1 < kbn) {
              fr[0] = nx[0];
              fr[1] = nx[1];
            }
          }
        }
      }
      GEN_TICK(0, 2);
      // Epilogue: lanes 2k and 2k + 1 hold a channel's four gates at two
      // rows; after one exchange lane tq even runs the cell at row g, odd
      // at row g + 8.
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (nt0 + j >= pl.nt) continue;
            float pre[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pre[e] = round_to<G>(xr[i][j][e] + round_to<G>((float)acc[i][j][e]));
            const bool odd = tq & 1;
            const float s0 = odd ? pre[0] : pre[2], s1 = odd ? pre[1] : pre[3];
            const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            const float gi = odd ? r0 : pre[0], gf = odd ? r1 : pre[1];
            const float gg = odd ? pre[2] : r0, go = odd ? pre[3] : r1;
            const int p = mb0 + 16 * i + gq + 8 * odd;
            const int lc = ((nt0 + j) * 8 + 2 * (tq & 2)) >> 2;
            if (p >= HW || lc >= nc) continue;
            const int ch = c_lo + lc;
            float& c = cst[p * ncm + lc];
            const Cell r = lstm_cell_ieee<G>(gi, gf, gg, go, c);
            c = r.c;
            hst[p * ncm + lc] = from_f<A>(r.h);
            const size_t o = (b * Tn + t) * HW + p, last = b * HW + p;
            if (MODE == kSave) {
              const float gv[4] = {r.i, r.f, r.g, r.o};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (stage_g)
                  gst[((size_t)q * HW + p) * ncm + lc] = from_f<A>(gv[q]);
                else
                  og[o * F4 + q * F + ch] = from_f<A>(gv[q]);
              }
            }
            if (MODE != kSave && t == Tn - 1) {
              if (MODE == kLast) oh[last * F + ch] = from_f<A>(r.h);
              oc[last * F + ch] = from_f<A>(r.c);
            }
          }
      }
    }
    if (MODE != kLast) {
      // hs, cs (kSave) and the staged gates of step t in whole rows
      __syncthreads();
      const int unit = gen_unit(ES, c_lo * ES, nc * ES, ncm * ES, F * ES);
      const int per_row = nc * ES / unit, rows = (MODE == kSave ? (stage_g ? 6 : 2) : 1) * HW;
      for (int idx = tid; idx < rows * per_row; idx += GEN_THREADS) {
        const int row = idx / per_row, u = idx - row * per_row, kind = row / HW, p = row - kind * HW;
        const size_t o = (b * Tn + t) * HW + p;
        if (kind == 1) {  // cs: the cell state converted, a unit at a time
          alignas(16) A v[16 / ES];
          const float* c = cst + p * ncm + u * (unit / ES);
#pragma unroll
          for (int k = 0; k < 16 / ES; ++k) v[k] = from_f<A>(k < unit / ES ? c[k] : 0.f);
          gen_store_unit(reinterpret_cast<unsigned char*>(oc + o * F + c_lo) + u * unit, -1,
                         reinterpret_cast<const unsigned char*>(v), unit);
          continue;
        }
        const unsigned char* src =
            kind == 0 ? reinterpret_cast<const unsigned char*>(hst + (size_t)p * ncm)
                      : reinterpret_cast<const unsigned char*>(gst + ((size_t)(kind - 2) * HW + p) *
                                                                         ncm);
        unsigned char* dst =
            kind == 0 ? reinterpret_cast<unsigned char*>(oh + o * F + c_lo)
                      : reinterpret_cast<unsigned char*>(og + o * F4 + (kind - 2) * F + c_lo);
        gen_store_unit(dst + u * unit, -1, src + u * unit, unit);
      }
    }
    GEN_TICK(0, 3);
    if (t == Tn - 1) break;
    // h_t into every copy: with one copy, once every CTA has read h_{t-1}
    if (g.hbuf == 1)
      cluster_sync();
    else
      __syncthreads();
    const int unit = gen_unit(ES, c_lo * ES, nc * ES, ncm * ES, g.Fs * ES);
    const int per_row = nc * ES / unit, per = HW * per_row;
    const int targets = g.hbuf ? g.cl : 1;
    for (int idx = tid; idx < targets * per; idx += GEN_THREADS) {
      const int r = idx / per, e = idx - r * per, p = e / per_row, u = e - p * per_row;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(hst + (size_t)p * ncm) + u * unit;
      unsigned char* dst = reinterpret_cast<unsigned char*>(hnext + (size_t)gen_halo(p, W) * g.Fs +
                                                            c_lo) + u * unit;
      gen_store_unit(dst, g.hbuf ? r : -1, src, unit);
    }
    if (!g.hbuf) __threadfence();
    cluster_sync();
    GEN_TICK(0, 4);
  }
  cp_async_wait<0>();
  // no CTA leaves while a peer may still write into its shared memory
  cluster_sync();
}

// K5's x projection, the forward's xg: out[r][n] = G(x_r Wx[:, n] + bx[n])
// over the B T H W rows of x (R, C), Wx packed in fragment order (C / 16
// k-blocks, 4F / 8 n8 tiles, gen_tile_bytes), bx f32 (4F), out (R, 4F) in
// the gate dtype G.  A CTA: 128 rows of x, staged once in shared memory
// (cp.async where rows are whole 16-byte chunks; gen_xproj_smem bytes,
// else read from global memory), then all 4F columns in passes of 64, a
// warp 32 x 32, A through ldmatrix; the sums as the forward's: f64 (bf16
// gates: the tensor cores' f32 sums of GEN_PROMOTE_KB k-blocks at most;
// f32 activations: the f64 tensor cores) or f32.
__host__ __device__ inline int gen_xproj_smem(int C, int es) {
  const int bytes = 128 * gen_stride(gup(C, 16), es) * es;
  return bytes <= GEN_SMEM_LIMIT ? bytes : 0;
}

template <typename A, typename G>
__global__ void __launch_bounds__(GEN_THREADS) gen_xproj_kernel(
    const A* __restrict__ x, const unsigned char* __restrict__ wxp, const float* __restrict__ bx,
    G* __restrict__ out, int R, int C, int F4) {
  extern __shared__ __align__(128) unsigned char xp_smem[];
  constexpr bool D = std::is_same<A, float>::value;
  using FA = std::conditional_t<D, D64, A>;
  constexpr bool F64 = !std::is_same<G, float>::value;
  using Sum = std::conditional_t<F64 || D, double, float>;
  constexpr int ES = sizeof(A), LB = gen_lane_bytes<FA>();
  const int tile = gen_tile_bytes(ES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * 128, wm = (warp & 3) * 32;
  const int nkb = gceil(C, 16), nt = gceil(F4, 8), Cs = gen_stride(nkb * 16, ES);
  const bool staged = gen_xproj_smem(C, ES) > 0;
  A* xs = reinterpret_cast<A*>(xp_smem);
  if (staged) {  // rows r0.. of x, zero past R and past C
    if ((C * ES) % 16 == 0) {
      const int row = C * ES / 16;
      for (int c = tid; c < 128 * row; c += GEN_THREADS) {
        const int r = c / row, o = c - r * row;
        cp_async16(reinterpret_cast<unsigned char*>(xs + (size_t)r * Cs) + o * 16,
                   reinterpret_cast<const unsigned char*>(x + (size_t)gmin(r0 + r, R - 1) * C) +
                       o * 16,
                   r0 + r < R);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < 128 * C; i += GEN_THREADS) {
        const int r = i / C, k = i - r * C;
        xs[(size_t)r * Cs + k] = r0 + r < R ? x[(size_t)(r0 + r) * C + k] : from_f<A>(0.f);
      }
    }
    for (int i = tid; i < 128 * (Cs - C); i += GEN_THREADS)
      xs[(size_t)(i / (Cs - C)) * Cs + C + i % (Cs - C)] = from_f<A>(0.f);
    cp_async_wait<0>();
    __syncthreads();
  }
  int rows[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[i][h] = gmin(r0 + wm + 16 * i + gq + 8 * h, R - 1);
  for (int pass0 = 0; pass0 < nt; pass0 += 8) {
    const int nt0 = pass0 + (warp >> 2) * 4;
    Sum acc[2][4][4];
    float part[2][4][4];
    gen_zero(acc);
    gen_zero(part);
    // software-pipelined: k-block kb + 1's fragments load before kb's products
    auto load = [&](AFrag<FA>(&fr)[2], BFrag<FA>(&bf)[4], int kb) {
      const int k0 = kb * 16;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (staged)
          lda_smem(fr[i], smem_u32(xs + (size_t)(wm + 16 * i + (lane & 15)) * Cs + k0) +
                              (lane >> 4) * 16);
        else
          lda_global<false>(fr[i], x + (size_t)rows[i][0] * C + k0,
                            x + (size_t)rows[i][1] * C + k0, tq, C - k0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nt0 + j < nt) ldb(bf[j], wxp + ((size_t)kb * nt + nt0 + j) * tile + lane * LB);
    };
    AFrag<FA> fr[2], nfr[2];
    BFrag<FA> bf[4], nbf[4];
    load(fr, bf, 0);
    for (int kb = 0; kb < nkb; ++kb) {
      if (kb + 1 < nkb) load(nfr, nbf, kb + 1);
      if constexpr (D) {
        const D64Vals a0 = d64_vals(fr[0]), a1 = d64_vals(fr[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < nt) {
            mma_kblock(acc[0][j], a0, bf[j]);
            mma_kblock(acc[1][j], a1, bf[j]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nt0 + j < nt) {
            mma_kblock(part[0][j], fr[0], bf[j]);
            mma_kblock(part[1][j], fr[1], bf[j]);
          }
        if ((kb + 1) % GEN_PROMOTE_KB == 0 || kb == nkb - 1) gen_promote(acc, part);
      }
      if (kb + 1 < nkb) {
#pragma unroll
        for (int i = 0; i < 2; ++i) fr[i] = nfr[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j] = nbf[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + wm + 16 * i + gq + 8 * h, n = (nt0 + j) * 8 + 2 * tq;
          if (r < R && n < F4)
            store_pair(out + (size_t)r * F4, n, F4, round_to<G>((float)acc[i][j][2 * h] + bx[n]),
                       round_to<G>((float)acc[i][j][2 * h + 1] +
                                   (n + 1 < F4 ? bx[n + 1] : 0.f)));
        }
  }
}

// ---------------------------------------------------------------------------
// BPTT
// ---------------------------------------------------------------------------

struct GenBwdArgs {
  const void* wtpk;  // (cl, 9 Kt / 16, nt, 32 lanes): W^T by rank, fragment order
  const void *c0, *cs, *ga, *dhs, *dcl;
  void *dG, *dxg, *dc0, *dh0;
  float* dsum;
  unsigned char* scratch;
  int Tn, H, W, F, const_x, last_only;
  GenGeo g;
};

// Reverse time for sample blockIdx.x / cl.  K5 (PROJ) and K6 with dh_T once
// (`last_only`): dhs (B, HW, F) enters once; else dhs (B, T, HW, F) is
// added to the carried dh every step.  dG (B, T, HW, 4F): the dgates
// rounded to A.  dsum: K5's per-sample dbx partials (B, 4F); K6 with a
// time-constant xg (const_x) its f32 dgates sum (B, HW, 4F), written
// rounded to A into dxg (B, HW, 4F) at the last step.
template <typename A, bool PROJ>
__global__ void __launch_bounds__(GEN_THREADS, 1) gen_bwd_kernel(const GenBwdArgs P) {
  extern __shared__ __align__(128) unsigned char smem[];
  // f32 activations: the transposed taps on the f64 tensor cores, summed in f64
  constexpr bool D = std::is_same<A, float>::value;
  using FA = std::conditional_t<D, D64, A>;
  using Sum = std::conditional_t<D, double, float>;
  constexpr int ES = sizeof(A), LB = gen_lane_bytes<FA>();
  const GenGeo& g = P.g;
  const GenPlan& pl = g.b;
  const int rank = (int)cluster_rank(), tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t b = blockIdx.x / g.cl;
  const int H = P.H, W = P.W, F = P.F, Tn = P.Tn, HW = H * W, W2 = W + 2, F4 = 4 * F;
  const int halo = (H + 2) * W2;
  const int c_lo = F * rank / g.cl, nc = F * (rank + 1) / g.cl - c_lo, ncm = g.nc;
  const int tile = gen_tile_bytes(ES);
  const size_t slice = (b * g.cl + rank) * (size_t)HW * ncm;
  float* dhc = g.carry_res ? reinterpret_cast<float*>(smem + g.b_dh)
                           : reinterpret_cast<float*>(P.scratch + g.bs_dh) + slice;
  float* dcc = g.carry_res ? reinterpret_cast<float*>(smem + g.b_dc)
                           : reinterpret_cast<float*>(P.scratch + g.bs_dc) + slice;
  A* dgt = g.dg_res ? reinterpret_cast<A*>(smem + g.b_dg)
                    : reinterpret_cast<A*>(P.scratch + g.bs_dg) +
                          (b * g.cl + rank) * (size_t)halo * g.Ks;
  float* part_g = reinterpret_cast<float*>(P.scratch + g.bs_part) +
                  b * g.cl * (size_t)HW * g.Fq;  // the cluster's partials when global
  float* part = g.part_res ? reinterpret_cast<float*>(smem + g.b_part)
                           : part_g + (size_t)rank * HW * g.Fq;
  float* red = reinterpret_cast<float*>(smem + g.b_red);
  const unsigned char* wr = static_cast<const unsigned char*>(P.wtpk) +
                            (size_t)rank * pl.nkb * pl.nt * tile;
  const A* c0 = static_cast<const A*>(P.c0);
  const A* cs = static_cast<const A*>(P.cs);
  const A* ga = static_cast<const A*>(P.ga);
  const A* dhs = static_cast<const A*>(P.dhs);
  const A* dcl = static_cast<const A*>(P.dcl);
  A* dG = static_cast<A*>(P.dG);
  float* dsum = P.dsum;
  const bool once = PROJ || P.last_only;

  for (size_t i = tid; i < (size_t)halo * g.Ks; i += GEN_THREADS) dgt[i] = from_f<A>(0.f);
  for (int i = tid; i < HW * nc; i += GEN_THREADS) {
    const int p = i / nc, lc = i - p * nc;
    const size_t o = (b * HW + p) * F + c_lo + lc;
    dhc[p * ncm + lc] = once ? to_f(dhs[o]) : 0.f;
    dcc[p * ncm + lc] = to_f(dcl[o]);
  }
  if (PROJ)
    for (int i = tid; i < 4 * nc; i += GEN_THREADS)
      dsum[b * F4 + (i / nc) * F + c_lo + i % nc] = 0.f;
  if (!PROJ && P.const_x)
    for (int i = tid; i < HW * 4 * nc; i += GEN_THREADS) {
      const int p = i / (4 * nc), q = i / nc % 4;
      dsum[(b * HW + p) * F4 + q * F + c_lo + i % nc] = 0.f;
    }
  __syncthreads();

  const int spp = gceil(pl.nkb, pl.pbk), sps = spp * pl.passes;
  const long total = (long)Tn * sps;
  auto issue = [&](long s) {
    if (s < total) {
      const int ls = (int)(s % sps), pass = ls / spp, kb0 = (ls - pass * spp) * pl.pbk;
      int tlo, thi;
      gen_pass_tiles(pass, pl.mb, pl.nt, &tlo, &thi);
      gen_issue_slab(smem + (s % GEN_STAGES) * pl.stage_bytes, wr, pl.nkb, pl.nt, kb0,
                     gmin(pl.pbk, pl.nkb - kb0), tlo, thi, tile);
    }
    cp_async_commit();
  };
  for (int s = 0; s < GEN_STAGES - 1; ++s) issue(s);

  // The pointwise pass: thread u < S nc takes channel u % nc at positions
  // u / nc, + S, ...; K5 sums its dgates over them, then the S slices in order.
  const int S = nc >= GEN_THREADS ? 1 : GEN_THREADS / nc;
  long slab = 0;
  GEN_TICK_INIT();
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t st = (b * Tn + t) * HW;  // the row of (b, t, position 0)
    for (int u = tid; u < S * nc; u += GEN_THREADS) {
      const int s = u / nc, lc = u % nc, ch = c_lo + lc;
      float colsum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = s; p < HW; p += S) {
        float dh = dhc[p * ncm + lc];
        if (!once) dh += to_f(dhs[(st + p) * F + ch]);
        const float ct = to_f(cs[(st + p) * F + ch]);
        const float cp =
            t > 0 ? to_f(cs[(st - HW + p) * F + ch]) : to_f(c0[(b * HW + p) * F + ch]);
        const A* gp = ga + (st + p) * F4 + ch;
        float gv[4];
        const float dcn = lstm_cell_bwd_fast(dh, dcc[p * ncm + lc], ct, cp, to_f(gp[0]),
                                             to_f(gp[F]), to_f(gp[2 * F]), to_f(gp[3 * F]), gv);
        dcc[p * ncm + lc] = dcn;
        if (t == 0) static_cast<A*>(P.dc0)[(b * HW + p) * F + ch] = from_f<A>(dcn);
        A* d = dG + (st + p) * F4 + ch;
        A* dt = dgt + (size_t)gen_halo(p, W) * g.Ks + 4 * lc;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q * F] = from_f<A>(gv[q]);
          dt[q] = from_f<A>(gv[q]);
          colsum[q] += gv[q];
        }
        if (!PROJ && P.const_x) {
          float* ds = dsum + (b * HW + p) * F4 + ch;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ds[q * F] += gv[q];
            if (t == 0)
              static_cast<A*>(P.dxg)[(b * HW + p) * F4 + q * F + ch] = from_f<A>(ds[q * F]);
          }
        }
      }
      if (PROJ) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (S == 1)
            dsum[b * F4 + q * F + ch] += colsum[q];
          else
            red[u * 4 + q] = colsum[q];
        }
      }
    }
    __syncthreads();  // the dgates tile (and K5's slices) whole
    GEN_TICK(1, 0);
    if (PROJ && S > 1) {
      for (int lc = tid; lc < nc; lc += GEN_THREADS) {
        float tot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[q] += red[(s * nc + lc) * 4 + q];
#pragma unroll
        for (int q = 0; q < 4; ++q) dsum[b * F4 + q * F + c_lo + lc] += tot[q];
      }
    }
    // The CTA's partial dh_{t-1} over all F channels: the transposed taps
    // of its own dgate columns, dh[p] += dG_t[p + (1 - ty, 1 - tx)] W[tap]^T.
    for (int pass = 0; pass < pl.passes; ++pass) {
      int tlo, thi;
      gen_pass_tiles(pass, pl.mb, pl.nt, &tlo, &thi);
      const int blk = pass * GEN_WARPS + warp;
      const bool active = blk < pl.mb * gceil(pl.nt, 4);
      const int mb0 = (blk % pl.mb) * 32, nt0 = (blk / pl.mb) * 4;
      int hl[2], hs[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = mb0 + 16 * i + (lane & 15);
        hl[i] = gen_halo(p < HW ? p : 0, W);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = mb0 + 16 * i + gq + 8 * h;
          hs[i][h] = gen_halo(q < HW ? q : 0, W);
        }
      }
      int tap = 0, tk0 = 0, toff = W2 + 1;  // the next k-block's tap and columns
      Sum acc[2][4][4];
      float prt[2][4][4];
      gen_zero(acc);
      gen_zero(prt);
      for (int ks = 0; ks < spp; ++ks, ++slab) {
        cp_async_wait<GEN_STAGES - 2>();
        __syncthreads();
        issue(slab + GEN_STAGES - 1);
        const unsigned char* stg = smem + (slab % GEN_STAGES) * pl.stage_bytes;
        const int kb0 = ks * pl.pbk, kbn = gmin(pl.pbk, pl.nkb - kb0);
        if (!active) continue;
        auto load_a = [&](AFrag<FA>(&fr)[2]) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (g.dg_res)
              lda_smem(fr[i], smem_u32(dgt + (size_t)(hl[i] + toff) * g.Ks + tk0) +
                                  (lane >> 4) * 16);
            else
              lda_global<true>(fr[i], dgt + (size_t)(hs[i][0] + toff) * g.Ks + tk0,
                               dgt + (size_t)(hs[i][1] + toff) * g.Ks + tk0, tq, 16);
          }
          tk0 += 16;
          if (tk0 == g.Kt) {
            tk0 = 0;
            ++tap;
            toff = (1 - tap / 3) * W2 + 1 - tap % 3;
          }
        };
        AFrag<FA> fr[2];
        load_a(fr);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < kbn) {
            BFrag<FA> bf[4];
            const unsigned char* bk =
                stg + ((size_t)kk * (thi - tlo) + nt0 - tlo) * tile + lane * LB;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (nt0 + j < pl.nt) ldb(bf[j], bk + (size_t)j * tile);
            AFrag<FA> nx[2];
            if (kk + 1 < kbn) load_a(nx);
            if constexpr (D) {
              const D64Vals a0 = d64_vals(fr[0]), a1 = d64_vals(fr[1]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (nt0 + j < pl.nt) {
                  mma_kblock(acc[0][j], a0, bf[j]);
                  mma_kblock(acc[1][j], a1, bf[j]);
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (nt0 + j < pl.nt) {
                  mma_kblock(prt[0][j], fr[0], bf[j]);
                  mma_kblock(prt[1][j], fr[1], bf[j]);
                }
              }
            }
            if (kk + 1 < kbn) {
              fr[0] = nx[0];
              fr[1] = nx[1];
            }
          }
        }
        if constexpr (!D) gen_promote(acc, prt);
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = mb0 + 16 * i + gq + 8 * h, n = (nt0 + j) * 8 + 2 * tq;
              if (p < HW && n < F) {
                float* d = part + (size_t)p * g.Fq + n;
                if (n + 1 < F)
                  *reinterpret_cast<float2*>(d) =
                      make_float2((float)acc[i][j][2 * h], (float)acc[i][j][2 * h + 1]);
                else
                  d[0] = (float)acc[i][j][2 * h];
              }
            }
      }
    }
    GEN_TICK(1, 1);
    if (!g.part_res) __threadfence();
    cluster_sync();  // every CTA's partial whole
    // dh_{t-1} of the CTA's channels: the cluster's partials in rank order
    for (int i = tid; i < HW * nc; i += GEN_THREADS) {
      const int p = i / nc, lc = i - p * nc;
      const size_t off = (size_t)p * g.Fq + c_lo + lc;
      float s = 0.f;
      for (int r = 0; r < g.cl; ++r) {
        float v;
        if (g.part_res) {
          asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                       : "=f"(v)
                       : "r"(map_rank(part + off, (uint32_t)r)));
        } else {
          v = __ldcg(part_g + (size_t)r * HW * g.Fq + off);
        }
        s += v;
      }
      if (t > 0)
        dhc[p * ncm + lc] = s;
      else
        static_cast<A*>(P.dh0)[(b * HW + p) * F + c_lo + lc] = from_f<A>(s);
    }
    cluster_sync();  // every partial read before the next step writes them
    GEN_TICK(1, 2);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// After the BPTT: dx and the weight GEMM
// ---------------------------------------------------------------------------

// K5's dx = dG Wx^T: dG (R, 4F) in A, wxt packed (4F / 16 k-blocks, C / 8
// n8 tiles, 32 lanes) (Wx^T, fragment order), dx (R, C) in A.  128 x 64
// tiles, a warp 32 x 32, fragments of dG from global memory, slabs of four
// k-blocks summed in f32.
template <typename A>
__global__ void __launch_bounds__(GEN_THREADS) gen_dx_kernel(const A* __restrict__ dG,
                                                             const unsigned char* __restrict__ wxt,
                                                             A* __restrict__ dx, int R, int F4,
                                                             int C) {
  constexpr int LB = gen_lane_bytes<A>();
  const int tile = sizeof(A) == 2 ? 256 : 1024;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * 128 + (warp & 3) * 32, nt0 = blockIdx.y * 8 + (warp >> 2) * 4;
  const int nkb = gceil(F4, 16), nt = gceil(C, 8);
  int rows[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[i][h] = gmin(m0 + 16 * i + gq + 8 * h, R - 1);
  float acc[2][4][4], part[2][4][4];
  gen_zero(acc);
  gen_zero(part);
  // software-pipelined: k-block kb + 1's fragments load before kb's products
  auto load = [&](AFrag<A>(&fr)[2], BFrag<A>(&bf)[4], int kb) {
    const int k0 = kb * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lda_global<false>(fr[i], dG + (size_t)rows[i][0] * F4 + k0, dG + (size_t)rows[i][1] * F4 + k0,
                        tq, F4 - k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nt0 + j < nt) ldb(bf[j], wxt + ((size_t)kb * nt + nt0 + j) * tile + lane * LB);
  };
  AFrag<A> fr[2], nfr[2];
  BFrag<A> bf[4], nbf[4];
  load(fr, bf, 0);
  for (int kb = 0; kb < nkb; ++kb) {
    if (kb + 1 < nkb) load(nfr, nbf, kb + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nt0 + j < nt) {
        mma_kblock(part[0][j], fr[0], bf[j]);
        mma_kblock(part[1][j], fr[1], bf[j]);
      }
    if (kb % 4 == 3 || kb == nkb - 1) gen_promote(acc, part);
    if (kb + 1 < nkb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) fr[i] = nfr[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bf[j] = nbf[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 16 * i + gq + 8 * h, c = (nt0 + j) * 8 + 2 * tq;
        if (r < R && c < C)
          store_pair(dx + (size_t)r * C, c, C, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// dW and dWx as one product: part[split][m][n] = sum over the split's rows
// r (b, t, position) of X[r][m] dG[r][n], X[r] = [x_r, the 3x3 taps of
// h_{t-1} at r's position] ((tap, channel) order; h_{-1} = h0), m < M = C +
// 9F, n < 4F.  A CTA: 64 channels of one segment (x or a tap) x 128
// columns, rows in slabs of 32 staged by cp.async (element by element where
// rows are not whole 16-byte chunks).  bf16: each slab's products summed
// apart, then in runs of GEN_WGRAD_RUN rows that are added up; f32: on the
// f64 tensor cores, summed in f64.
template <typename A>
__global__ void __launch_bounds__(GEN_THREADS) gen_wgrad_kernel(
    const A* __restrict__ x, const A* __restrict__ hs, const A* __restrict__ h0,
    const A* __restrict__ dG, float* __restrict__ part, int Tn, int H, int W, int C, int F, int R,
    int chunk) {
  constexpr int ES = sizeof(A), E = 16 / ES, BM = GEN_WG_BM, BN = GEN_WG_BN, BK = GEN_WG_BK;
  constexpr int SX = BM + GEN_WG_PAD, SG = BN + GEN_WG_PAD;
  constexpr int STAGE = BK * (SX + SG);  // elements; GEN_STAGES of them (gen_wgrad_smem)
  extern __shared__ __align__(128) unsigned char wg_smem[];
  A* sm = reinterpret_cast<A*>(wg_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int HW = H * W, F4 = 4 * F, M = C + 9 * F;
  const int xt = gceil(C, BM), ft = gceil(F, BM);
  // the CTA's segment: x (seg -1) or a tap, and its channels [c0, c0 + BM)
  const int mt = blockIdx.x;
  const int seg = mt < xt ? -1 : (mt - xt) / ft;
  const int c0 = (mt < xt ? mt : (mt - xt) % ft) * BM, width = seg < 0 ? C : F;
  const int mrow0 = seg < 0 ? c0 : C + seg * F + c0;  // the first output row
  const int n0 = blockIdx.y * BN, split = blockIdx.z;
  const int r_lo = split * chunk, r_hi = gmin(R, r_lo + chunk);
  const bool vec_x = (width * ES) % 16 == 0, vec_g = (F4 * ES) % 16 == 0;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;

  auto load = [&](int r0, int stage) {
    A* xs = sm + stage * STAGE;
    A* gs = xs + BK * SX;
    // X rows: the segment's channels of row r (zero outside the image)
    for (int c = tid; c < BK * (BM / E); c += GEN_THREADS) {
      const int k = c / (BM / E), o = (c - k * (BM / E)) * E, r = r0 + k;
      const A* src = nullptr;
      if (r < r_hi && c0 + o < width) {
        if (seg < 0) {
          src = x + (size_t)r * C + c0 + o;
        } else {
          const int bt = r / HW, p = r - bt * HW;
          const int yy = p / W + seg / 3 - 1, xx = p % W + seg % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            const int q = yy * W + xx;
            src = (bt % Tn > 0 ? hs + ((size_t)(bt - 1) * HW + q) * F
                               : h0 + ((size_t)(bt / Tn) * HW + q) * F) + c0 + o;
          }
        }
      }
      A* dst = xs + k * SX + o;
      if (vec_x) {
        cp_async16(dst, src ? src : x, src != nullptr);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          dst[e] = src && c0 + o + e < width ? src[e] : from_f<A>(0.f);
      }
    }
    // dG rows
    for (int c = tid; c < BK * (BN / E); c += GEN_THREADS) {
      const int k = c / (BN / E), o = (c - k * (BN / E)) * E, r = r0 + k;
      const bool ok = r < r_hi && n0 + o < F4;
      const A* src = dG + (size_t)r * F4 + n0 + o;
      A* dst = gs + k * SG + o;
      if (vec_g) {
        cp_async16(dst, ok ? src : dG, ok);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = ok && n0 + o + e < F4 ? src[e] : from_f<A>(0.f);
      }
    }
    cp_async_commit();
  };

  // f32: products on the f64 tensor cores, summed in f64 over the split
  using Sum = std::conditional_t<ES == 4, double, float>;
  Sum acc[2][4][4];
  float run[2][4][4], prt[2][4][4];
  gen_zero(acc);
  gen_zero(run);
  gen_zero(prt);
  const int nslab = gceil(r_hi - r_lo, BK);
  for (int s = 0; s < GEN_STAGES - 1; ++s)
    if (s < nslab) load(r_lo + s * BK, s);
    else cp_async_commit();
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<GEN_STAGES - 2>();
    __syncthreads();
    if (s + GEN_STAGES - 1 < nslab) load(r_lo + (s + GEN_STAGES - 1) * BK, (s + GEN_STAGES - 1) % GEN_STAGES);
    else cp_async_commit();
    const A* xs = sm + (s % GEN_STAGES) * STAGE;
    const A* gs = xs + BK * SX;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 16) {
      if constexpr (ES == 2) {
        // A (m x k) from X[k][m]: ldmatrix.trans; B (k x n) from dG[k][n]
        uint32_t fa[2][4], fb[2][4];
        const int mi = lane >> 3, ri = lane & 7;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(fa[i], smem_u32(xs + (k0 + (mi >> 1) * 8 + ri) * SX + wm + 16 * i +
                                        (mi & 1) * 8));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldsm_x4_trans(fb[jj], smem_u32(gs + (k0 + (mi & 1) * 8 + ri) * SG + wn + 16 * jj +
                                         (mi >> 1) * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(prt[i][j], fa[i], fb[j >> 1][2 * (j & 1)], fb[j >> 1][2 * (j & 1) + 1]);
      } else {
        // the f64 tensor cores' m16n8k16 fragments: A (row g + 8 h, column
        // 4 st + tq) from X[k][m], B (4 st + tq, g) from dG[k][n]
        const float* xf = reinterpret_cast<const float*>(xs);
        const float* gf = reinterpret_cast<const float*>(gs);
        D64Vals a[2];
        BFrag<D64> bb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int st = 0; st < 4; ++st)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              a[i].a[st][h] = xf[(k0 + 4 * st + tq) * SX + wm + 16 * i + gq + 8 * h];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* col = gf + (k0 + tq) * SG + wn + 8 * j + gq;
          bb[j].v = make_float4(col[0], col[4 * SG], col[8 * SG], col[12 * SG]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (ES == 4) mma_kblock(acc[i][j], a[i], bb[j]);
          }
      }
    }
    if constexpr (ES == 2) {
      gen_promote(run, prt);
      if ((s + 1) * BK % GEN_WGRAD_RUN == 0 || s == nslab - 1) gen_promote(acc, run);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = wm + 16 * i + gq + 8 * (e >> 1), n = n0 + wn + 8 * j + 2 * tq + (e & 1);
        if (c0 + m < width && n < F4)
          part[((size_t)split * M + mrow0 + m) * F4 + n] = (float)acc[i][j][e];
      }
}

}  // namespace
}  // namespace mmvae
