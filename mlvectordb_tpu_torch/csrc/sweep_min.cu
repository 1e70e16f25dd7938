// Phase 1 of the certified sweep exact k-NN: rank + consecutive-row window-min, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel mlvectordb_tpu/ops/pallas_knn_t.py:_sweep_kernel (launched by
// _window_mins), in the variants the certified sweep path runs: the light program (one
// pass), the heavy program (two_pass: the query's bf16 residual against the same rows;
// use_resid: int8 codes of each row's residual, times a per-row scale), the cosine scale
// row, up to two folded certificate bound rows, the level-2 block mins at r1 = 32, and the
// per-tile top-m candidate pool (n_top, with or without the window-min matrix: skip_wm).
// One tensor-core body serves the mirror's three element types, picked by its template:
//   bf16 bits — the bf16 mirror of an f32 store (light, two_pass, two_pass + use_resid)
//               and a bf16 store's own rows (one pass);
//   int8      — the int8 primary mirror (sweep_dtype="int8"): codes z1 against bf16
//               queries, the scale row carrying s1 and use_resid's multiplier s2 / s1
//               (one pass, two_pass, two_pass + use_resid);
//   f32       — the f32 mirror (sweep_dtype="float32"): one pass of the f32 query, which
//               the JAX kernel multiplies at Precision.HIGHEST (pallas_knn_t.py:211-212),
//               a multi-pass bf16 product on the MXU; here six bf16 passes of a three-way
//               split (below).
// The bias row may be absent (rank = dots: the int8 probe's kernel kA).
// For rows m of the mirror [cap, Dp] and folded queries qh (and qres):
//
//   rank = (qh.m [+ qres.m] [+ (qh.resid) * rscale]) [* scale] + bias - sum_t qe_t * eb_t
//
// in the JAX package's order of terms, then the min over each window f of r1
// CONSECUTIVE rows [f*r1, (f+1)*r1), written tile-major [nt, B, g*128] (g = 32 / r1) at
// position t*g*128 + a*128 + j for window f = (t*128 + j)*g + a — the JAX package's map,
// so the outputs compare element by element.  Or, on request, in the JAX package's
// non-transposed form [B, nt*g*128] (pallas_knn_t.py:453-457): the same positions, each
// query's row of all tiles (window mins only).  The [cap, B] rank matrix never exists.
// Every min propagates NaN, as jnp.minimum does: a NaN rank makes its window's min NaN.
//
// Live columns.  The outputs are B queries wide, but a launch computes only the first Bc
// of them (the engine's live queries, rounded up to the product's n of 8); the caller
// fills the rest, which are its zero-padded queries, from one cached zero-query column.
// Every column is computed on its own (no value of one query enters another's), so a
// column's bits do not depend on how many columns a launch computes.
//
// The pool (pallas_knn_t.py:343-380): for each tile t and query b, the m smallest
// (value, position) pairs of the tile's g*128 window mins, in the order m rounds of
// min / first-argmin / mask give them, written [nt, SUB, B] (SUB = _topm_sub_rows(m)):
// rows 0..m-1 the values, rows m..m+m/2-1 the positions packed p0 + out_w*p1, the rest
// +inf.  Those rounds yield the entries below +inf in (value, position) order; once only
// +inf is left they repeat (+inf, position 0), and a tile holding a NaN min gives NaN
// values at position out_w.  A block owns a whole tile and walks its g sub-blocks of 128
// windows in turn, carrying a running top-m per query in shared memory.
//
// What bounds it.  At the engine's B = 128 live queries over 2^20 x 128 bf16 rows the
// product is 34 GFLOP (0.035 ms on the bf16 tensor cores) against 256 MB of mirror and
// 67 MB of window mins (0.10 ms at 3.35 TB/s): bytes.  Over an f32 mirror the six passes
// are 206 GFLOP (0.21 ms) against 537 MB of rows (0.16 ms): operations; the same product
// as f32 FMA on the CUDA cores would need 0.51 ms at 67 TFLOP/s.  The earliest body
// converted every operand to f32 and used FMA on the CUDA cores, because the certificate's
// slack was taken to need IEEE f32 sums in JAX's order; that ran at 29.5 TFLOP/s, 3% of
// the bound, and on 4x the live queries.  The JAX kernel's own products are dot_general
// on the matrix unit with f32 accumulation, and its slack (pallas_knn_t.py:1184-1186,
// Dp*2^-22*|qh|*maxd) budgets Dp*2^-24 of f32 accumulation per dot for phase 1 and the
// same for the rescan, with 4x headroom.
//
// The tensor-core error model (Fasi, Higham, Mikaitis and Pranesh, "Numerical behavior of
// NVIDIA tensor cores", PeerJ CS 2021, for A100): products of bf16 values are exact; the
// s products of one k-group and the running sum are aligned to the largest exponent among
// them and truncated to 24 significant bits, then added.  Each of the s + 1 terms then
// loses less than 2^-23 of the group's largest magnitude, which is at most |q||x| (every
// partial sum and every product is), so over Dp / s groups
//     |tc - exact| <= (Dp / s) * (s + 1) * 2^-23 * |q||x| = Dp * (1 + 1/s) * 2^-23 * |q||x|.
// int8 codes (|z| <= 127) are exact in bf16, so an int8 mirror's products are exact too.
// Phase 1's share of the slack is Dp*2^-22 - Dp*2^-24 = 1.5 * Dp*2^-23 relative, which the
// model bound keeps for any s >= 2; the measured maxima are held to Dp*2^-23
// (chip_smoke.py prints them, PERF.md records them).
//
// An f32 mirror.  Each element splits exactly into bf16 parts, x = xh + xm + xl with
// |xh| <= (1 + u)|x|, |xm| <= u(1 + u)|x|, |xl| <= u^2 |x| (u = 2^-8; mma_common.cuh's
// split3, in registers, for the rows and the f32 query alike).  Of
// the nine products the kernel drops mid.lo, lo.mid and lo.lo, at most
// (2u^3(1 + u) + u^4) Q <= (1 + 2^-8) 2^-23 Q + 2^-32 Q, with Q = sum_i |q_i||x_i| <= |q||x|.
// hi.hi goes into one accumulator and the five cross passes (hi.mid, mid.hi, hi.lo,
// lo.hi, mid.mid) into a second; the epilogue adds the two with one __fadd_rn before the
// per-row terms.  On the model above: the hi.hi accumulator's partial sums and products
// are at most (1 + u)^2 Q, so it loses under Dp (1 + 1/s) (1 + u)^2 2^-23 Q; the cross
// one's are at most C Q with C = 2u(1 + u)^2 + 2u^2(1 + u) + u^2(1 + u)^2 < 1.014 * 2^-7,
// and its 5 Dp / s groups lose under 5 Dp (1 + 1/s) C 2^-23 Q; the final add rounds once,
// under 0.51 * 2^-23 Q.  In all
//     |tc - exact| <= (Dp (1 + 1/s) ((1 + u)^2 + 5C) + 1.52) * 2^-23 * Q
//                   ~ (1.048 Dp (1 + 1/s) + 1.52) * 2^-23 * |q||x|,
// at Dp = 128: 1.32 Dp*2^-23 at s = 4, 1.19 at s = 8, 1.13 at s = 16, inside phase 1's
// 1.5 * Dp*2^-23 for any s >= 4 (Dp >= 16).  One accumulator for all six (kernel B4's
// choice, window_min.cu) would put the cross terms into sums of |q||x|'s size and give
// (6 Dp + 1) 2^-23 on paper.  The measured maxima, against float64 over gaussian and hard
// f32 rows, are held to Dp*2^-23 as the other mirrors' are (chip_smoke.py phase 14,
// PERF.md).  Non-finite values: an inf element's mid and lo parts are NaN (inf - inf), so
// a row or query holding inf gives NaN dots where f32 sums give +-inf, as a split product
// of inf does; NaN gives NaN as before.
//
// What the design does about it.  Tensor-core body (bf16 and int8 mirrors):
// mma.sync.m16n8k16 bf16 x bf16 -> f32, one accumulator per pass (qh.m, qres.m,
// qh.resid).  A block of 16 warps owns one tile (4096 rows) and a tile of 128 (light) or
// 64 (heavy) queries, or of 16 where the launch computes no more.  The warps work in
// pairs: a pair owns 16 whole windows of each 128-window sub-block and streams their rows
// 16 at a time (one m-tile) through a ring of cp.async copies, 128 dimensions a stage, so
// the next rows arrive during this step's products; each warp of the pair multiplies the
// stage by its half of the query tile.  The n-tile count is a template parameter, so the
// product loop has no branch.  int8 codes become bf16 in registers after the shared-memory
// load.  A thread reads 8 consecutive dimensions of a row and of a query with one load
// each: the k order inside an mma is permuted the same way on both operands, which changes
// no product.  The epilogue applies the per-row terms to each accumulator element in JAX's
// order (__fadd_rn / __fmul_rn / __fsub_rn, no contraction), takes the window min over
// rows in the thread and then across lanes with shuffles, and leaves it in shared memory,
// from which the block writes its window mins in coalesced rows and forms the block mins
// and the pool.  What sets the time on the card is latency, not the products or the
// bytes (probes/sweep_ablation.py: removing the mma instructions changes nothing): the
// pairs give each scheduler four warps where single warps gave it two.  An f32 mirror's
// stage holds 64 dimensions (256 bytes of a row, as kernel B4's f32 stage); a thread
// splits its 8 values of rows g and g + 8 into three parts in registers and multiplies
// them with the query tile's three parts (hi, mid, lo).  The kernel takes the f32 query as
// it is and splits it itself.  Its tile is 64 queries (two accumulators, as the heavy
// programs; 128 would not fit beside three parts), or 16 for a batch that needs no more.
//
// The query tile.  Where its parts fit beside a 3-stage ring (the wide tile at Dp = 128
// for the light, heavy and f32 programs, up to 256 or 512 for the others; the 16-query
// one up to 3840 for one bf16 pass, 1152 for the heavy program, 1920 for int8's two
// streams, 1280 for an f32 query) they sit in
// shared memory for the block's life, an f32 query split once at the fill.  A 16-query
// tile whose parts fit beside 2 stages only keeps them there too (a bf16 or int8 mirror:
// up to 4864, 1920 and 2432), which beat streaming them by ~10% for the heavy program at
// Dp = 1536 (probes/time_sweep.py --routes).  Past that the query streams, one stage's
// dimensions a step, in lockstep across the block: during step z its threads copy step
// z + 1's chunk of each part from L2 into the slot that step reads (two slots, one block
// barrier a step in place of the pair's; an f32 query's values are copied raw and, after
// the step's products, split by the threads that copied them).  The wide tile's parts and
// two slots leave room for 3 stages except for the bf16 mirror's light and heavy
// programs, which stream beside 2 (the 128-query light tile beside 2 stages beat a
// 64-query one beside 3 by 1.3-1.4x from Dp = 768).  So no Dp is refused, and more than 16
// live queries take the wide tile at every Dp: 128 live queries are one tile (light) or
// two, whose second read of a row tile comes mostly from L2, since a row tile's blocks
// stand next to each other in the grid.  Sixteen-query tiles in its place read every row
// once per 16 queries and lost by 2.1-2.8x at every Dp from 256 to 3072 (bf16 light and
// heavy, int8; an f32 query, which each tile would split again, by more).  A streamed
// tile's products are the resident tile's in the same order: its outputs are the same
// bits.  wgmma and TMA would not help while the product is not what sets the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int WLANE = 128;      // windows per output block of a tile
constexpr int TILE_ROWS = 4096; // rows per tile

// jnp.minimum's rule: a NaN operand makes the min NaN (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

// (v, p) before (bv, bp) in (value, position) order; a NaN value is never before anything
__device__ __forceinline__ bool lex_less(float v, int p, float bv, int bp) {
  return v < bv || (v == bv && p < bp);
}

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

constexpr int MMA_PAIRS = 8;       // warp pairs: a pair streams one run of rows
constexpr int MMA_WARPS = 2 * MMA_PAIRS;
constexpr int NSTAGE = 3;          // cp.async ring depth, per pair (2 where 3 do not fit)
constexpr int RES_LD = WLANE + 4;  // padded row of the staged window mins
constexpr int RUN_MAX = 16;        // running pool entries per query (m <= 16 where g > 1)
constexpr int NT_NARROW = 1;       // n-tiles a warp takes in the narrow tile (16 queries)
constexpr int SMEM_MAX = 232448;   // a block's dynamic shared memory on an H100

// two int8 codes (bits sh .. sh + 15 of u, the lower dimension in the low byte) -> one
// bf16x2 register, exact: a code has at most 7 significant bits, so its f32 value's low
// 16 bits are zero
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t u, int sh) {
  const float lo = (float)((int)(u << (24 - sh)) >> 24);
  const float hi = (float)((int)(u << (16 - sh)) >> 24);
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}

// The int8 stage loader beside the header's bf16 one (mma_common.cuh).
template <> struct MmaRows<int8_t> {  // int8 codes: 128 bytes a row, widened to bf16 here
  static constexpr int ROW_BYTES = KC;
  static constexpr int DIMS = KC;
  static __device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ ((row & 3) << 1); }
  static __device__ __forceinline__ uint4 load(const char* st, int row, int j, int t) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        st + row * ROW_BYTES + swz(row, 2 * j + (t >> 1)) * 16 + (t & 1) * 8);
    return make_uint4(i8x2_bf16x2(u.x, 0), i8x2_bf16x2(u.x, 16), i8x2_bf16x2(u.y, 0),
                      i8x2_bf16x2(u.y, 16));
  }
};

struct MmaArgs {
  const void* qh;             // bf16 [Bq, D]; an f32 mirror's: f32 [Bq, D]
  const uint16_t* qres;       // bf16 [Bq, D] or null
  const void* mirror;         // bf16 bits, int8 codes or f32 [cap, D]
  const int8_t* resid;        // int8 [cap, D] or null
  const float *rscale, *scale, *bias, *qe, *eb1, *eb2;
  float *out, *bm, *pool;
  int D, B, Bc, Bq, r1, n_eb, m;
  long long bp_width;
};

// an f32 mirror: its rows split into three bf16 parts in registers, six products
template <typename MT>
constexpr bool IS_F32 = sizeof(MT) == 4;

// the widest query tile of a program, in n-tiles of 8 queries a warp takes (the two
// warps of a pair take one half each): what the registers of 512 threads hold with two
// accumulators (the heavy programs, the f32 split) or one
template <typename MT, bool TWO_PASS, bool RESID>
constexpr int nt_max() { return (TWO_PASS || RESID || IS_F32<MT>) ? 4 : 8; }

// QS: the query tile streams, one stage's dimensions a step (a bf16 or int8 mirror's 128,
// an f32 mirror's 64): each part copied from L2 a step ahead into one of two slots
// [2 slots][PARTS_Q][BN][Q_DIMS] of bf16 (an f32 query: its f32 values [BN][64] copied,
// then split into the slot's hi, mid and lo parts); otherwise the whole tile sits in
// shared memory as bf16 parts for the block's life
template <typename MT, bool TWO_PASS, bool RESID, int NT, int NST, bool QS>
struct MmaShape {
  static constexpr int BN = 16 * NT;  // queries a block owns: NT n-tiles for each warp of a pair
  static constexpr int A_BYTES = 16 * MmaRows<MT>::ROW_BYTES;
  static constexpr int STAGE = A_BYTES + (RESID ? 16 * KC : 0);
  // the query tile's bf16 parts: qh (an f32 mirror: hi, mid, lo), qres
  static constexpr int PARTS_Q = IS_F32<MT> ? 3 : TWO_PASS ? 2 : 1;
  static constexpr int Q_DIMS = MmaRows<MT>::DIMS;  // a streamed slot's dimensions
  static constexpr int Q_RAW = IS_F32<MT> ? BN * Q_DIMS * 4 : 0;
  static constexpr int Q_SLOT = PARTS_Q * BN * Q_DIMS * 2;
  // stages, queries, staged mins, qe, running pool (values, positions, NaN flags)
  static constexpr int smem(int D) {
    return MMA_PAIRS * NST * STAGE + (QS ? Q_RAW + 2 * Q_SLOT : PARTS_Q * BN * D * 2) +
           BN * RES_LD * 4 + 2 * BN * 4 + BN * RUN_MAX * 8 + BN * 4;
  }
};

// the ring depth of a streamed tile: NSTAGE where it fits beside the slots, else 2 (the
// bf16 mirror's 128-query light tile and its heavy program's 64-query one)
template <typename MT, bool TWO_PASS, bool RESID, int NT>
constexpr int qs_stages() {
  return MmaShape<MT, TWO_PASS, RESID, NT, NSTAGE, true>::smem(0) <= SMEM_MAX ? NSTAGE : 2;
}

template <typename MT, bool TWO_PASS, bool RESID, int NT, int NST, bool QS>
__global__ void __launch_bounds__(MMA_WARPS * 32, 1) sweep_mma_kernel(const MmaArgs a) {
  using S = MmaShape<MT, TWO_PASS, RESID, NT, NST, QS>;
  using Rows = MmaRows<MT>;
  constexpr bool F32 = IS_F32<MT>;
  constexpr bool ACC2 = TWO_PASS || F32;  // a second accumulator: qres.m, or the cross passes
  constexpr int BN = S::BN;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp >> 1, half = warp & 1;  // the pair's rows, this warp's n-tiles
  const int n0 = half * NT;
  const int g = lane >> 2, t = lane & 3;  // the fragment's group and thread-in-group
  const int n_qt = (a.Bq + BN - 1) / BN;
  const long long tile = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BN;
  const int bn = min(BN, a.Bq - q0);       // the block's queries; the tile's rest is zeros
  const int r1 = a.r1, gsub = 32 / r1;
  const int kc = a.D / Rows::DIMS;
  // bytes of one query row of one part: the resident tile's D dimensions, or a slot's
  const int qrow = (QS ? S::Q_DIMS : a.D) * 2;
  const float INF = inf_f();

  char* my = smem + pair * NST * S::STAGE;
  char* qs = smem + MMA_PAIRS * NST * S::STAGE;  // [PARTS_Q][BN] rows, or [raw] + 2 slots
  float* res = reinterpret_cast<float*>(qs + (QS ? S::Q_RAW + 2 * S::Q_SLOT
                                                 : S::PARTS_Q * BN * qrow));  // [BN][RES_LD]
  float* qe_s = res + BN * RES_LD;                                        // [BN][2]
  float* run_v = qe_s + 2 * BN;                                           // [BN][RUN_MAX]
  int* run_p = reinterpret_cast<int*>(run_v + BN * RUN_MAX);              // [BN][RUN_MAX]
  unsigned* nanq = reinterpret_cast<unsigned*>(run_p + BN * RUN_MAX);     // [BN]

  // the resident query tile, once per block, zero past the block's queries (an f32
  // query split here into its hi, mid and lo parts): row r's 16-byte chunk c of 8
  // dimensions at c ^ ((r & 1) << 2)
  {
    const int cpr = a.D / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = threadIdx.x; idx < (QS ? 0 : BN * cpr); idx += blockDim.x) {
      const int r = idx / cpr, ch = idx % cpr;
      const int at = r * qrow + ((ch ^ ((r & 1) << 2)) * 16);
      const long long src = (long long)(q0 + r) * a.D + ch * 8;
      if constexpr (F32) {
        uint4 h = zero, m = zero, l = zero;
        if (r < bn) {
          const float4* x = reinterpret_cast<const float4*>(static_cast<const float*>(a.qh) + src);
          const float4 x0 = x[0], x1 = x[1];
          split3(x0.x, x0.y, h.x, m.x, l.x);
          split3(x0.z, x0.w, h.y, m.y, l.y);
          split3(x1.x, x1.y, h.z, m.z, l.z);
          split3(x1.z, x1.w, h.w, m.w, l.w);
        }
        *reinterpret_cast<uint4*>(qs + at) = h;
        *reinterpret_cast<uint4*>(qs + BN * qrow + at) = m;
        *reinterpret_cast<uint4*>(qs + 2 * BN * qrow + at) = l;
      } else {
#pragma unroll
        for (int p = 0; p < S::PARTS_Q; ++p) {
          const uint16_t* part = p ? a.qres : static_cast<const uint16_t*>(a.qh);
          *reinterpret_cast<uint4*>(qs + p * BN * qrow + at) =
              r < bn ? *reinterpret_cast<const uint4*>(part + src) : zero;
        }
      }
    }
    for (int i = threadIdx.x; i < 2 * BN; i += blockDim.x)
      qe_s[i] = i < 2 * bn ? a.qe[(long long)q0 * 2 + i] : 0.f;
  }
  __syncthreads();

  // the pair's m-tile u (0..31) of the tile: sub-block u / r1, its m-tile u % r1 of the
  // pair's 16 windows (16 * r1 rows)
  auto first_row = [&](int u) -> long long {
    return tile * TILE_ROWS + (long long)(u / r1) * WLANE * r1 + pair * 16 * r1 + (u % r1) * 16;
  };
  const int total = 32 * kc;  // stages per pair: 32 m-tiles of kc chunks
  auto issue = [&](int z) {
    const long long row0 = first_row(z / kc);
    const int c = z % kc;
    char* st = my + (z % NST) * S::STAGE;
    constexpr int CPR = Rows::ROW_BYTES / 16;
    const char* src = static_cast<const char*>(a.mirror) +
                      (row0 * a.D + (long long)c * Rows::DIMS) * (long long)sizeof(MT);
    // the pair's 64 threads share the copies
    for (int q = half * 32 + lane; q < 16 * CPR; q += 64) {
      const int r = q / CPR, ch = q % CPR;
      cp_async16(st + r * Rows::ROW_BYTES + Rows::swz(r, ch) * 16,
                 src + (long long)r * a.D * (long long)sizeof(MT) + ch * 16);
    }
    if constexpr (RESID) {
      const char* rsrc = reinterpret_cast<const char*>(a.resid) + row0 * a.D + (long long)c * KC;
      for (int q = half * 32 + lane; q < 16 * (KC / 16); q += 64) {
        const int r = q / (KC / 16), ch = q % (KC / 16);
        cp_async16(st + S::A_BYTES + r * KC + MmaRows<int8_t>::swz(r, ch) * 16,
                   rsrc + (long long)r * a.D + ch * 16);
      }
    }
  };
  // QS: the query chunk of step z (dimensions (z % kc) * Q_DIMS .. of the block's queries,
  // zero past them), 16 bytes a copy.  An f32 query: its values into the raw buffer, which
  // each thread later splits where it copied them itself, so a wait for its own copies is
  // all the split needs.  Else each part straight into slot z & 1, row r's 16-byte chunk k
  // of 8 dimensions at k ^ ((r & 1) << 2), as in the resident tile
  auto issue_q = [&](int z) {
    const long long col = (long long)(z % kc) * S::Q_DIMS;
    if constexpr (F32) {
      const float* src = static_cast<const float*>(a.qh) + (long long)q0 * a.D + col;
      for (int i = threadIdx.x; i < BN * 16; i += blockDim.x) {
        const int r = i >> 4, ch = i & 15;
        cp_async16_or_zero(qs + i * 16, src + (long long)min(r, bn - 1) * a.D + ch * 4, r < bn);
      }
    } else {
      char* slot = qs + (z & 1) * S::Q_SLOT;
      for (int i = threadIdx.x; i < S::PARTS_Q * BN * 16; i += blockDim.x) {
        const int p = i / (BN * 16), r = (i >> 4) % BN, ch = i & 15;
        const uint16_t* part = p ? a.qres : static_cast<const uint16_t*>(a.qh);
        cp_async16_or_zero(slot + (p * BN + r) * qrow + ((ch ^ ((r & 1) << 2)) * 16),
                           part + (q0 + min(r, bn - 1)) * (long long)a.D + col + ch * 8, r < bn);
      }
    }
  };
  // ... into slot z & 1 as hi, mid, lo: row r's 16-byte chunk k of 8 dimensions at
  // k ^ ((r & 1) << 2), as in the resident tile
  auto split_q = [&](int z) {
    char* slot = qs + S::Q_RAW + (z & 1) * S::Q_SLOT;
    for (int i = threadIdx.x; i < BN * 16; i += blockDim.x) {
      const int r = i >> 4, ch = i & 15;
      const float4 x = *reinterpret_cast<const float4*>(qs + i * 16);
      uint2 h, m, l;
      split3(x.x, x.y, h.x, m.x, l.x);
      split3(x.z, x.w, h.y, m.y, l.y);
      char* at = slot + r * 128 + (((ch >> 1) ^ ((r & 1) << 2)) * 16) + (ch & 1) * 8;
      *reinterpret_cast<uint2*>(at) = h;
      *reinterpret_cast<uint2*>(at + BN * 128) = m;
      *reinterpret_cast<uint2*>(at + 2 * BN * 128) = l;
    }
  };

  // acc1: qh.m (an f32 mirror: hi.hi); acc2: qres.m (f32: the five cross passes); acc3:
  // qh.resid
  float acc1[NT][4], acc2[ACC2 ? NT : 1][4], acc3[RESID ? NT : 1][4];
  float best[NT][2];                       // r1 = 32: the window's min over its first m-tile
  float rb[2], rsc[2], rrs[2], re1[2], re2[2];  // row terms of rows g and g + 8

  // commit groups: [QS: the query chunk of step 0], the rows of stages 0 .. NST - 2; then
  // at step z [the query chunk of z + 1 and] the rows of z + NST - 1, so that waiting for
  // all but the newest NST - 2 groups finds stage z's rows and query chunk in place, and
  // (an f32 query) after step z's products the raw chunk of z + 1
  if constexpr (QS) {
    issue_q(0);
    cp_async_commit();
  }
#pragma unroll
  for (int z = 0; z < NST - 1; ++z) {
    if (z < total) issue(z);
    cp_async_commit();
  }
  if constexpr (QS && F32) {
    cp_async_wait<NST - 1>();
    split_q(0);
  }
  for (int z = 0; z < total; ++z) {
    cp_async_wait<NST - 2>();
    // both warps' copies of step z are visible to both, and both have left step z - 1,
    // whose buffer is refilled here; a streamed query: the whole block, whose slot z & 1
    // was filled (an f32 query: split) at step z - 1 and whose slot (z + 1) & 1 is
    // refilled at this step
    if constexpr (QS) {
      __syncthreads();
      if (z + 1 < total) issue_q(z + 1);
      cp_async_commit();
    } else {
      asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1));
    }
    if (z + NST - 1 < total) issue(z + NST - 1);
    cp_async_commit();
    const int u = z / kc, c = z % kc, s = u / r1, mt = u % r1;
    const char* st = my + (z % NST) * S::STAGE;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc1[n][e] = 0.f;
          if constexpr (ACC2) acc2[n][e] = 0.f;
          if constexpr (RESID) acc3[n][e] = 0.f;
        }
      const long long row = first_row(u) + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long rw = row + 8 * h;
        rb[h] = a.bias ? a.bias[rw] : 0.f;
        rsc[h] = a.scale ? a.scale[rw] : 1.f;
        rrs[h] = RESID ? a.rscale[rw] : 0.f;
        re1[h] = a.n_eb > 0 ? a.eb1[rw] : 0.f;
        re2[h] = a.n_eb > 1 ? a.eb2[rw] : 0.f;
      }
    }
    // query row (n0 + n)*8 + g's 16-byte chunk of dimensions c*DIMS + 32j + 8t sits at
    // chunk c*DIMS/8 + 4*(j ^ (g & 1)) + t of the row (the fill's swizzle; rows g + 8n
    // share g's); in a streamed slot at chunk 4*(j ^ (g & 1)) + t
    const char* qb = QS ? qs + S::Q_RAW + (z & 1) * S::Q_SLOT : qs;
    const int q_at = (n0 * 8 + g) * qrow + ((QS ? 0 : c * (Rows::DIMS / 8)) + t) * 16;
    if constexpr (F32) {
      // the six products of the two splits: hi.hi into acc1, the cross passes (each term
      // at most 2^-8 of its element's |q_i x_i|) into acc2, the smaller first
#pragma unroll
      for (int j = 0; j < Rows::DIMS / 32; ++j) {
        uint4 lo[3], hi[3];
        float no_sq = 0.f;
        Rows::load(st, g, j, t, lo, no_sq, false);
        Rows::load(st, g + 8, j, t, hi, no_sq, false);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint4 b[3];  // the query's hi, mid and lo parts
          const char* at = qb + q_at + n * 8 * qrow + (j ^ (g & 1)) * 64;
#pragma unroll
          for (int p = 0; p < 3; ++p) b[p] = *reinterpret_cast<const uint4*>(at + p * BN * qrow);
          mma32(acc2[n], lo[0], hi[0], b[2]);
          mma32(acc2[n], lo[2], hi[2], b[0]);
          mma32(acc2[n], lo[1], hi[1], b[1]);
          mma32(acc2[n], lo[0], hi[0], b[1]);
          mma32(acc2[n], lo[1], hi[1], b[0]);
          mma32(acc1[n], lo[0], hi[0], b[0]);
        }
      }
      if constexpr (QS) {
        // the query chunk of step z + 1, split into the slot this step does not read
        cp_async_wait<1>();
        if (z + 1 < total) split_q(z + 1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KC / 32; ++j) {
        // rows g and g + 8, dimensions 32j + 8t .. +7: two k-steps of 16 (the k order
        // inside each is permuted the same way on both operands)
        const uint4 lo = Rows::load(st, g, j, t), hi = Rows::load(st, g + 8, j, t);
        uint4 zlo = lo, zhi = hi;
        if constexpr (RESID) {
          zlo = MmaRows<int8_t>::load(st + S::A_BYTES, g, j, t);
          zhi = MmaRows<int8_t>::load(st + S::A_BYTES, g + 8, j, t);
        }
        uint4 b[NT], p[TWO_PASS ? NT : 1];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int at = q_at + n * 8 * qrow + (j ^ (g & 1)) * 64;
          b[n] = *reinterpret_cast<const uint4*>(qb + at);
          if constexpr (TWO_PASS) p[n] = *reinterpret_cast<const uint4*>(qb + BN * qrow + at);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_bf16(acc1[n], lo.x, hi.x, lo.y, hi.y, b[n].x, b[n].y);
          mma_bf16(acc1[n], lo.z, hi.z, lo.w, hi.w, b[n].z, b[n].w);
          if constexpr (TWO_PASS) {
            mma_bf16(acc2[n], lo.x, hi.x, lo.y, hi.y, p[n].x, p[n].y);
            mma_bf16(acc2[n], lo.z, hi.z, lo.w, hi.w, p[n].z, p[n].w);
          }
          if constexpr (RESID) {
            mma_bf16(acc3[n], zlo.x, zhi.x, zlo.y, zhi.y, b[n].x, b[n].y);
            mma_bf16(acc3[n], zlo.z, zhi.z, zlo.w, zhi.w, b[n].z, b[n].w);
          }
        }
      }
    }
    if (c != kc - 1) continue;

    // epilogue of the m-tile: element e of n-tile n is row g + 8*(e >> 1), query column
    // n*8 + 2t + (e & 1); the per-row terms in JAX's order, unfused
    const bool w_first = (mt * 16) % r1 == 0, w_done = ((mt + 1) * 16) % r1 == 0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float rk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = (n0 + n) * 8 + 2 * t + (e & 1);
        float dots = acc1[n][e];
        if constexpr (ACC2) dots = __fadd_rn(dots, acc2[n][e]);
        if constexpr (RESID) dots = __fadd_rn(dots, __fmul_rn(acc3[n][e], rrs[h]));
        float rank = a.scale ? __fmul_rn(dots, rsc[h]) : dots;
        if (a.bias) rank = __fadd_rn(rank, rb[h]);
        if (a.n_eb > 0) rank = __fsub_rn(rank, __fmul_rn(qe_s[2 * col], re1[h]));
        if (a.n_eb > 1) rank = __fsub_rn(rank, __fmul_rn(qe_s[2 * col + 1], re2[h]));
        rk[e] = rank;
      }
      if (r1 >= 16) {
        // the m-tile's 16 rows lie in one window: rows g and g + 8 here, then the 8 groups
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float v = nan_min(rk[p], rk[2 + p]);
          best[n][p] = w_first ? v : nan_min(best[n][p], v);
          if (w_done) {
            v = best[n][p];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)
              v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
            if (g == 0) res[((n0 + n) * 8 + 2 * t + p) * RES_LD + pair * 16 + (mt * 16) / r1] = v;
          }
        }
      } else {
        // 16 / r1 windows in the m-tile: the r1 groups of one window reduce together
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = rk[e];
          for (int off = 4; off < 4 * r1; off <<= 1)
            v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
          if (g % r1 == 0)
            res[((n0 + n) * 8 + 2 * t + (e & 1)) * RES_LD + pair * 16 +
                (mt * 16 + g + 8 * (e >> 1)) / r1] = v;
        }
      }
    }
    if (mt != r1 - 1) continue;

    // sub-block s of the tile is complete: its 128 window mins per query are staged
    __syncthreads();
    const int gw = gsub * WLANE;
    if (a.out != nullptr) {
      // consecutive threads write consecutive positions: position a*128 + s*per + jj holds
      // local window jj*g + a of the sub-block
      const int per = WLANE / gsub;
      for (int idx = threadIdx.x; idx < bn * WLANE; idx += blockDim.x) {
        const int col = idx >> 7, r = idx & (WLANE - 1);
        const int aa = r / per, jj = r % per;
        const int b = q0 + col;
        if (b < a.Bc) {
          const long long pos = (long long)aa * WLANE + s * per + jj;
          const long long at = a.bp_width ? (long long)b * a.bp_width + tile * gw + pos
                                          : (tile * a.B + b) * gw + pos;
          a.out[at] = res[col * RES_LD + jj * gsub + aa];
        }
      }
    }
    if (a.bm != nullptr) {
      // level-2 block mins (r1 = 32: the sub-block is the whole tile)
      for (int col = warp; col < bn; col += MMA_WARPS) {
        float v = res[col * RES_LD + lane];
#pragma unroll
        for (int k = 1; k < 4; ++k) v = nan_min(v, res[col * RES_LD + lane + 32 * k]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == 0 && q0 + col < a.Bc) a.bm[tile * a.B + q0 + col] = v;
      }
    }
    if (a.pool != nullptr) {
      // a warp per query column: m rounds over the sub-block's 128 mins (4 a lane) and
      // the running top-m of the earlier sub-blocks (entry `lane` for lane < m)
      const bool first = s == 0, last = s == gsub - 1;
      const int m = a.m;
      const int sub_rows = (m + (m + 1) / 2 + 7) / 8 * 8;
      float* tile_pool = a.pool + tile * (long long)sub_rows * a.B;
      for (int col = warp; col < bn; col += MMA_WARPS) {
        float v[4];
        int p[4];
        bool nan_here = false;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int lf = s * WLANE + lane + 32 * k;
          v[k] = res[col * RES_LD + lane + 32 * k];
          p[k] = (lf % gsub) * WLANE + lf / gsub;
          nan_here |= v[k] != v[k];
        }
        float cv = INF;
        int cp = 0x7fffffff;
        if (!first && lane < m) {
          cv = run_v[col * RUN_MAX + lane];
          cp = run_p[col * RUN_MAX + lane];
        }
        const bool nan_q = __any_sync(0xffffffffu, nan_here) || (!first && nanq[col] != 0u);
        float keep_v = INF;
        int keep_p = 0x7fffffff, prev = 0;
        const int b = q0 + col;
        for (int k = 0; k < m; ++k) {
          float bv = cv;
          int bp = cp;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (lex_less(v[i], p[i], bv, bp)) {
              bv = v[i];
              bp = p[i];
            }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
            const int op = __shfl_xor_sync(0xffffffffu, bp, off);
            if (lex_less(ov, op, bv, bp)) {
              bv = ov;
              bp = op;
            }
          }
          // the lane holding the winner masks it (positions are unique within a tile)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (p[i] == bp) v[i] = INF;
          if (cp == bp) cv = INF;
          if (!last) {
            if (lane == k) {  // k < m <= 16 here
              keep_v = bv;
              keep_p = bp;
            }
          } else if (lane == 0 && b < a.Bc) {
            const int pp = nan_q ? gw : (bv == INF ? 0 : bp);
            tile_pool[(long long)k * a.B + b] = nan_q ? __int_as_float(0x7fc00000) : bv;
            if (k & 1)
              tile_pool[(long long)(m + k / 2) * a.B + b] = (float)(prev + gw * pp);
            else
              prev = pp;
          }
        }
        if (!last) {
          if (lane < m) {
            run_v[col * RUN_MAX + lane] = keep_v;
            run_p[col * RUN_MAX + lane] = keep_p;
          }
          if (lane == 0) nanq[col] = nan_q ? 1u : 0u;
        } else if (lane == 0 && b < a.Bc) {
          for (int row = m + m / 2; row < sub_rows; ++row)
            tile_pool[(long long)row * a.B + b] = INF;
        }
      }
    }
    // the next sub-block's mins go into `res` only after every thread has read these
    __syncthreads();
  }
}

// Everything one launch takes beside the mirror and the queries (see mlvdb_sweep_min)
struct Args {
  const void *qh, *qres;
  const int8_t* resid;
  const float *rscale, *scale, *bias, *qe, *eb1, *eb2;
  float *out, *bm, *pool;
  long long cap;
  int D, B, Bc, Bq, r1, n_eb, m;
  long long bp_width;  // 0: tile-major output; else [B, bp_width = cap / r1]
  cudaStream_t stream;
};

template <typename MT, bool TWO_PASS, bool RESID, int NT, int NST, bool QS = false>
int launch_mma_nt(const Args& a, const void* mirror) {
  using S = MmaShape<MT, TWO_PASS, RESID, NT, NST, QS>;
  static_assert(!QS || S::smem(0) <= SMEM_MAX, "a streamed tile fits at any D");
  const int smem = S::smem(a.D);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = a.cap / TILE_ROWS * ((a.Bq + S::BN - 1) / S::BN);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_mma_kernel<MT, TWO_PASS, RESID, NT, NST, QS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const MmaArgs m{a.qh, static_cast<const uint16_t*>(a.qres), mirror,
                  a.resid, a.rscale, a.scale, a.bias, a.qe, a.eb1, a.eb2, a.out, a.bm, a.pool,
                  a.D, a.B, a.Bc, a.Bq, a.r1, a.n_eb, a.m, a.bp_width};
  kernel<<<(unsigned)blocks, MMA_WARPS * 32, smem, a.stream>>>(m);
  return (int)cudaGetLastError();
}

// The query tile follows the live count: the widest tile the program's registers hold,
// or the narrow one (16 queries) for a batch that needs no more.  The wide tile keeps its
// queries in shared memory where they fit beside a 3-stage ring and streams them
// otherwise; 16-query tiles in its place, each reading every row, lost at every Dp timed
// (probes/time_sweep.py --routes: 2.1-2.8x slower at 128 live queries, Dp = 256 to 3072).
// The narrow tile keeps its queries resident beside 3 stages, or 2 where 3 leave no room
// (a bf16 or int8 mirror; the 2-stage resident tile beat the streamed one by ~10% for the
// heavy program at Dp = 1536), and streams them past that.  So no Dp is refused.
struct Route {
  int nt, nst;  // n-tiles a warp takes, ring depth
  bool qs;      // the query streamed
};

template <typename MT, bool TWO_PASS, bool RESID>
Route pick_route(int D, int Bq) {
  constexpr int WIDE = nt_max<MT, TWO_PASS, RESID>();
  if (Bq > 16 * NT_NARROW) {
    if (MmaShape<MT, TWO_PASS, RESID, WIDE, NSTAGE, false>::smem(D) <= SMEM_MAX)
      return {WIDE, NSTAGE, false};
    return {WIDE, qs_stages<MT, TWO_PASS, RESID, WIDE>(), true};
  }
  if (MmaShape<MT, TWO_PASS, RESID, NT_NARROW, NSTAGE, false>::smem(D) <= SMEM_MAX)
    return {NT_NARROW, NSTAGE, false};
  if (!IS_F32<MT> && MmaShape<MT, TWO_PASS, RESID, NT_NARROW, 2, false>::smem(D) <= SMEM_MAX)
    return {NT_NARROW, 2, false};
  return {NT_NARROW, qs_stages<MT, TWO_PASS, RESID, NT_NARROW>(), true};
}

template <typename MT, bool TWO_PASS, bool RESID>
int launch_mma(const Args& a, const void* mirror) {
  constexpr int WIDE = nt_max<MT, TWO_PASS, RESID>();
  constexpr int WIDE_QS = qs_stages<MT, TWO_PASS, RESID, WIDE>();
  constexpr int NARROW_QS = qs_stages<MT, TWO_PASS, RESID, NT_NARROW>();
  if (a.Bq % 8 || a.Bc > a.Bq || a.D % KC) return (int)cudaErrorInvalidValue;
  const Route r = pick_route<MT, TWO_PASS, RESID>(a.D, a.Bq);
  if (r.nt == WIDE)
    return r.qs ? launch_mma_nt<MT, TWO_PASS, RESID, WIDE, WIDE_QS, true>(a, mirror)
                : launch_mma_nt<MT, TWO_PASS, RESID, WIDE, NSTAGE>(a, mirror);
  if (r.qs) return launch_mma_nt<MT, TWO_PASS, RESID, NT_NARROW, NARROW_QS, true>(a, mirror);
  if constexpr (!IS_F32<MT>) {
    if (r.nst == 2) return launch_mma_nt<MT, TWO_PASS, RESID, NT_NARROW, 2>(a, mirror);
  }
  return launch_mma_nt<MT, TWO_PASS, RESID, NT_NARROW, NSTAGE>(a, mirror);
}

template <typename MT, bool TWO_PASS, bool RESID>
struct Program {
  using T = MT;
  static constexpr bool two_pass = TWO_PASS, resid = RESID;
};

// f(Program<...>{}) for the program of a mirror type and its passes (see
// mlvdb_sweep_min), or `none` where the kernel has no such program
template <typename F>
int with_program(int mirror_type, bool two_pass, bool use_resid, int none, F f) {
  switch (mirror_type) {
    case 0:
      if (two_pass && use_resid) return f(Program<uint16_t, true, true>{});
      if (two_pass) return f(Program<uint16_t, true, false>{});
      if (use_resid) return f(Program<uint16_t, false, true>{});
      return f(Program<uint16_t, false, false>{});
    case 1:
      if (two_pass && use_resid) return f(Program<int8_t, true, true>{});
      if (two_pass) return f(Program<int8_t, true, false>{});
      if (use_resid) break;
      return f(Program<int8_t, false, false>{});
    case 2:
      if (two_pass || use_resid) break;
      return f(Program<float, false, false>{});
  }
  return none;
}

}  // namespace

// Plain C entry point (bound with ctypes).  mirror [cap, D] of mirror_type 0 = bf16 bits,
// 1 = int8 codes, 2 = f32.  Queries, Bq a multiple of 8, zero past the live rows: for a bf16
// or int8 mirror qh / qres bf16 [Bq, D]; for an f32 mirror qh f32 [Bq, D] (the kernel
// splits it) and no qres.  resid: int8 [cap, D] or null; rscale /
// scale / eb1 / eb2 / bias: f32 [cap] or null; qe: f32 [Bq, 2].  The outputs are B queries
// wide and the launch writes columns 0..Bc-1 of them (Bc <= B, Bc <= Bq): out f32
// [cap / 4096, B, (32 / r1) * 128] or null (skip_wm: the pool is the only output); bm: f32
// [cap / 4096, B] or null (r1 = 32 only); pool: f32 [cap / 4096, SUB, B] or null, m its even
// depth, 8..32, with m * (32 / r1) <= 32 and never beside bm.  out_bp = 1: out is
// [B, cap / r1] instead (the non-transposed form, window mins only: bm and pool null).  The
// passes a mirror type takes: bf16 any of qres and resid; int8 none, qres, or both; f32
// neither.  D % 128 == 0.  Returns cudaGetLastError() after the launch; 0 means it was
// accepted.
extern "C" int mlvdb_sweep_min(const void* qh, const void* qres, const void* mirror,
                               const void* resid, const float* rscale, const float* scale,
                               const float* bias, const float* qe, const float* eb1,
                               const float* eb2, float* out, float* bm, float* pool,
                               long long cap, int D, int B, int Bc, int Bq, int r1, int n_eb,
                               int m, int mirror_type, int out_bp, void* stream) {
  if (cap <= 0 || D <= 0 || D % KC || B <= 0 || Bc <= 0 || Bc > B || r1 <= 0 || 32 % r1 ||
      cap % (long long)TILE_ROWS || n_eb < 0 || n_eb > 2 || (bm != nullptr && r1 != 32) ||
      (resid != nullptr) != (rscale != nullptr) || (out == nullptr && pool == nullptr) ||
      (pool != nullptr && (bm != nullptr || m < 8 || m > 32 || m % 2 || m * (32 / r1) > 32)) ||
      (out_bp && (out == nullptr || bm != nullptr || pool != nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{qh, qres, static_cast<const int8_t*>(resid), rscale, scale, bias, qe, eb1, eb2,
               out, bm, pool, cap, D, B, Bc, Bq, r1, n_eb, m, out_bp ? cap / r1 : 0,
               static_cast<cudaStream_t>(stream)};
  const bool two_pass = qres != nullptr, use_resid = resid != nullptr;
  return with_program(mirror_type, two_pass, use_resid, (int)cudaErrorInvalidValue, [&](auto p) {
    using P = decltype(p);
    return launch_mma<typename P::T, P::two_pass, P::resid>(a, mirror);
  });
}

// The route mlvdb_sweep_min takes for a program (mirror_type, two_pass = a qres operand,
// use_resid = a resid operand) at D dimensions and Bq query rows: 100 * (queries a block
// owns) + 10 * (ring depth) + (1 where the query tile streams), or -1 where the kernel has
// no such program.
extern "C" int mlvdb_sweep_route(int D, int Bq, int mirror_type, int two_pass, int use_resid) {
  if (D <= 0 || D % KC || Bq <= 0 || Bq % 8) return -1;
  return with_program(mirror_type, two_pass, use_resid, -1, [&](auto p) {
    using P = decltype(p);
    const Route r = pick_route<typename P::T, P::two_pass, P::resid>(D, Bq);
    return 100 * 16 * r.nt + 10 * r.nst + (r.qs ? 1 : 0);
  });
}
