// Phase 1 of the certified sweep exact k-NN: rank + consecutive-row window-min, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel mlvectordb_tpu/ops/pallas_knn_t.py:_sweep_kernel (launched by
// _window_mins), in the variants the certified sweep path runs: the light program (one
// pass), the heavy program (two_pass: the query's bf16 residual against the same rows;
// use_resid: int8 codes of each row's residual, times a per-row scale), the cosine scale
// row, up to two folded certificate bound rows, the level-2 block mins at r1 = 32, and the
// per-tile top-m candidate pool (n_top, with or without the window-min matrix: skip_wm).
// The mirror's element type picks the body:
//   bf16 bits — the bf16 mirror of an f32 store (light, two_pass, two_pass + use_resid)
//               and a bf16 store's own rows (one pass): the tensor-core body;
//   int8      — the int8 primary mirror (sweep_dtype="int8"): codes z1 against bf16
//               queries, the scale row carrying s1 and use_resid's multiplier s2 / s1
//               (one pass, two_pass, two_pass + use_resid): the tensor-core body;
//   f32       — the f32 mirror (sweep_dtype="float32"): f32 queries, one pass: the FMA body.
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
// 67 MB of window mins (0.10 ms at 3.35 TB/s): bytes.  The earlier body converted every
// operand to f32 and used FMA on the CUDA cores, because the certificate's slack was taken
// to need IEEE f32 sums in JAX's order; that ran at 29.5 TFLOP/s, 3% of the bound, and on
// 4x the live queries.  The JAX kernel's own products are dot_general on the matrix unit
// with f32 accumulation, and its slack (pallas_knn_t.py:1184-1186, Dp*2^-22*|qh|*maxd)
// budgets Dp*2^-24 of f32 accumulation per dot for phase 1 and the same for the rescan,
// with 4x headroom.
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
// What the design does about it.  Tensor-core body (bf16 and int8 mirrors):
// mma.sync.m16n8k16 bf16 x bf16 -> f32, one accumulator per pass (qh.m, qres.m,
// qh.resid).  A block of 16 warps owns one tile (4096 rows) and a tile of 128 (light) or
// 64 (heavy) queries, or of 16 where the launch computes no more; the queries sit in
// shared memory for the whole tile.  The warps work in pairs: a pair owns 16 whole
// windows of each 128-window sub-block and streams their rows 16 at a time (one m-tile)
// through a 3-stage ring of cp.async copies, 128 dimensions a stage, so the next rows
// arrive during this step's products; each warp of the pair multiplies the stage by its
// half of the query tile.  The n-tile count is a template parameter, so the product loop
// has no branch.  int8 codes become bf16 in registers after the shared-memory load.  A
// thread reads 8 consecutive dimensions of a row and of a query with one load each: the k
// order inside an mma is permuted the same way on both operands, which changes no
// product.  The epilogue applies the per-row terms to each accumulator element in JAX's
// order (__fadd_rn / __fmul_rn / __fsub_rn, no contraction), takes the window min over
// rows in the thread and then across lanes with shuffles, and leaves it in shared memory,
// from which the block writes its window mins in coalesced rows and forms the block mins
// and the pool.  What sets the time on the card is latency, not the products or the
// bytes (probes/sweep_ablation.py: removing the mma instructions changes nothing): the
// pairs give each scheduler four warps where single warps gave it two.  FMA body (f32
// mirror): a register-tiled f32 product, 128 windows x 128 queries a block, as before.
// wgmma and TMA would not help while the product is not what sets the time.

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

// ============================================================ the FMA body (f32 mirror)

constexpr int BM = 128;       // windows per block (= rows per r-step)
constexpr int BK = 8;         // depth of one shared-memory stage
constexpr int THREADS = 256;
constexpr int RUN_LANES = 16; // lanes sharing a query column: the running pool's width
constexpr int TN = 8;         // queries per thread
constexpr int FBN = 16 * TN;   // queries per block

__global__ void __launch_bounds__(THREADS, 1)
fma_kernel(const float* __restrict__ qh_t, const float* __restrict__ mirror,
           const float* __restrict__ scale, const float* __restrict__ bias,
           const float* __restrict__ qe, const float* __restrict__ eb1,
           const float* __restrict__ eb2, float* __restrict__ out, float* __restrict__ bm,
           float* __restrict__ pool, int D, int B, int Bc, int Bq, int r1, int n_eb,
           int n_qtiles, int m, int subs, long long bp_width) {
  constexpr int QF4 = BK * FBN / 4;      // float4 loads of one query stage
  __shared__ __align__(16) float As[2][BK][BM];   // mirror stage, transposed: [k][row]
  __shared__ __align__(16) float Qs[2][BK][FBN];   // qh stage: [k][query]
  __shared__ float row_bias[BM], row_scale[BM], row_eb1[BM], row_eb2[BM];
  __shared__ float q_e[2][FBN];
  // the running pool: entry tx of each of the thread's TN queries, private to the thread
  __shared__ float run_v[TN][THREADS];
  __shared__ int run_p[TN][THREADS];

  const int tid = threadIdx.x;
  const long long group = blockIdx.x / n_qtiles;  // subs consecutive 128-window blocks
  const int q0 = (blockIdx.x % n_qtiles) * FBN;

  // compute mapping: rows tx*4+{0..3}, 64+tx*4+{0..3}; queries ty*4+{0..3}, 64+ty*4+{0..3}
  const int tx = tid % 16, ty = tid / 16;
  // load mapping: mirror stage [128 rows x 8] (4 values a thread), query stage [8 x FBN]
  // (one float4 a thread)
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int q_row = tid / (FBN / 4), q_col = (tid % (FBN / 4)) * 4;
  const float* q_src = qh_t + (long long)q_row * Bq + q0 + q_col;

  if (tid < FBN) {
    q_e[0][tid] = qe[(long long)(q0 + tid) * 2];
    q_e[1][tid] = qe[(long long)(q0 + tid) * 2 + 1];
  }

  const float INF = inf_f();
  const int g = 32 / r1;
  const long long gw = (long long)g * WLANE;
  const int out_w = (int)gw;
  const int nk = D / BK;
  unsigned nan_bits = 0u;  // pool: bit j set when query j has a NaN window min in the tile

  for (int s = 0; s < subs; ++s) {
  const long long wblock = group * subs + s;
  const long long w0 = wblock * BM;              // first window of this sub-block
  float best[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) best[i][j] = INF;

  for (int r = 0; r < r1; ++r) {
    const long long a_grow = (w0 + a_row) * r1 + r;     // the row this thread loads
    const float* a_src = mirror + a_grow * D + a_col;

    float acc[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    float4 a_reg = *reinterpret_cast<const float4*>(a_src);
    float4 q_reg = tid < QF4 ? *reinterpret_cast<const float4*>(q_src) : make_float4(0, 0, 0, 0);
    int buf = 0;
    for (int kc = 0; kc < nk; ++kc) {
      As[buf][a_col + 0][a_row] = a_reg.x;
      As[buf][a_col + 1][a_row] = a_reg.y;
      As[buf][a_col + 2][a_row] = a_reg.z;
      As[buf][a_col + 3][a_row] = a_reg.w;
      if (tid < QF4) *reinterpret_cast<float4*>(&Qs[buf][q_row][q_col]) = q_reg;
      __syncthreads();
      if (kc + 1 < nk) {  // next stage's loads are in flight during this stage's FMAs
        a_reg = *reinterpret_cast<const float4*>(a_src + (kc + 1) * BK);
        if (tid < QF4)
          q_reg = *reinterpret_cast<const float4*>(q_src + (long long)(kc + 1) * BK * Bq);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][tx * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float4 b0 = *reinterpret_cast<const float4*>(&Qs[buf][k][ty * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Qs[buf][k][64 + ty * 4]);
        const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // Double buffering makes one barrier per stage enough: the next store goes to the
      // other buffer, whose readers all passed this stage's barrier.
      buf ^= 1;
    }

    // per-row terms of this step's 128 rows (row (w0 + i)*r1 + r)
    if (tid < BM) {
      const long long row = (w0 + tid) * r1 + r;
      row_bias[tid] = bias ? bias[row] : 0.f;
      row_scale[tid] = scale ? scale[row] : 1.f;
      row_eb1[tid] = n_eb > 0 ? eb1[row] : 0.f;
      row_eb2[tid] = n_eb > 1 ? eb2[row] : 0.f;
    }
    // Every thread is past its last stage and the row terms are visible.  The next
    // step's first store (buffer 0: nk is even) and its row-term writes come after this
    // barrier and after the next step's own barriers, so no second barrier is needed.
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lr = (i >> 2) * 64 + tx * 4 + (i & 3);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int lq = (j >> 2) * 64 + ty * 4 + (j & 3);
        // the JAX package's order of terms, unfused (no contraction into FMAs)
        float rank = scale ? __fmul_rn(acc[i][j], row_scale[lr]) : acc[i][j];
        if (bias) rank = __fadd_rn(rank, row_bias[lr]);
        if (n_eb > 0) rank = __fsub_rn(rank, __fmul_rn(q_e[0][lq], row_eb1[lr]));
        if (n_eb > 1) rank = __fsub_rn(rank, __fmul_rn(q_e[1][lq], row_eb2[lr]));
        best[i][j] = nan_min(best[i][j], rank);
      }
    }
  }

  // window f = w0 + lr of tile t = f / (128 g) sits at lane (lf % g)*128 + lf / g
  int pos[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long f = w0 + (i >> 2) * 64 + tx * 4 + (i & 3);
    const long long t = f / gw;
    const int lf = (int)(f - t * gw);
    pos[i] = (lf % g) * WLANE + lf / g;
    if (out != nullptr) {
      // tile-major [nt, B, gw], or [B, bp_width] with bp_width = nt * gw
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
        const long long at =
            bp_width ? b * bp_width + t * gw + pos[i] : (t * B + b) * gw + pos[i];
        if (b < Bc) out[at] = best[i][j];
      }
    }
  }

  if (bm != nullptr) {
    // level-2 block mins (g = 1: the block's 128 windows are one whole tile): min over
    // the thread's 8 windows, then over the 16 lanes that share its queries
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = best[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) v = nan_min(v, best[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
      const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
      if (tx == 0 && b < Bc) bm[wblock * B + b] = v;
    }
  }

  if (pool != nullptr) {
    // top-m pool of tile `group` (the block walks its g sub-blocks): m rounds over the
    // 8 windows of each lane and the lane's running entry from the earlier sub-blocks
    const bool last = s == subs - 1;
    float cv[TN], nv[TN];
    int cp[TN], np_[TN], prev[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (best[i][j] != best[i][j]) nan_bits |= 1u << j;
      cv[j] = s > 0 ? run_v[j][tid] : INF;
      cp[j] = s > 0 ? run_p[j][tid] : 0x7fffffff;
      nv[j] = INF;
      np_[j] = 0x7fffffff;
      prev[j] = 0;
    }
    if (last) {
#pragma unroll
      for (int off = 1; off < RUN_LANES; off <<= 1)
        nan_bits |= __shfl_xor_sync(0xffffffffu, nan_bits, off);
    }
    const int sub_rows = (m + (m + 1) / 2 + 7) / 8 * 8;
    float* tile_pool = pool + group * (long long)sub_rows * B;
    for (int k = 0; k < m; ++k) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float bv = cv[j];
        int bp = cp[j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (lex_less(best[i][j], pos[i], bv, bp)) {
            bv = best[i][j];
            bp = pos[i];
          }
#pragma unroll
        for (int off = 1; off < RUN_LANES; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int op = __shfl_xor_sync(0xffffffffu, bp, off);
          if (lex_less(ov, op, bv, bp)) {
            bv = ov;
            bp = op;
          }
        }
        // the lane holding the winner masks it (positions are unique within a query)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (pos[i] == bp) best[i][j] = INF;
        if (cp[j] == bp) cv[j] = INF;
        const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
        if (!last) {
          if (tx == k) {  // k < m <= 16 here
            nv[j] = bv;
            np_[j] = bp;
          }
        } else if (tx == 0 && b < Bc) {
          const bool nan_q = (nan_bits >> j) & 1u;
          const int p = nan_q ? out_w : (bv == INF ? 0 : bp);
          tile_pool[(long long)k * B + b] = nan_q ? __int_as_float(0x7fc00000) : bv;
          if (k & 1)
            tile_pool[(long long)(m + k / 2) * B + b] = (float)(prev[j] + out_w * p);
          else
            prev[j] = p;
        }
      }
    }
    if (!last) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        run_v[j][tid] = nv[j];
        run_p[j][tid] = np_[j];
      }
    } else if (tx == 0) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
        if (b < Bc)
          for (int row = m + m / 2; row < sub_rows; ++row) tile_pool[(long long)row * B + b] = INF;
      }
    }
  }
  }  // sub-blocks
}

// ==================================== the tensor-core body (bf16 and int8 mirrors)

constexpr int MMA_PAIRS = 8;       // warp pairs: a pair streams one run of rows
constexpr int MMA_WARPS = 2 * MMA_PAIRS;
constexpr int NSTAGE = 3;          // cp.async ring depth, per pair
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
  static __device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ ((row & 3) << 1); }
  static __device__ __forceinline__ uint4 load(const char* st, int row, int j, int t) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        st + row * ROW_BYTES + swz(row, 2 * j + (t >> 1)) * 16 + (t & 1) * 8);
    return make_uint4(i8x2_bf16x2(u.x, 0), i8x2_bf16x2(u.x, 16), i8x2_bf16x2(u.y, 0),
                      i8x2_bf16x2(u.y, 16));
  }
};

struct MmaArgs {
  const uint16_t *qh, *qres;  // bf16 [Bq, D]
  const void* mirror;         // bf16 bits or int8 codes [cap, D]
  const int8_t* resid;        // int8 [cap, D] or null
  const float *rscale, *scale, *bias, *qe, *eb1, *eb2;
  float *out, *bm, *pool;
  int D, B, Bc, Bq, r1, n_eb, m;
  long long bp_width;
};

// the widest query tile of a program, in n-tiles of 8 queries a warp takes (the two
// warps of a pair take one half each): what the registers of 512 threads hold
template <bool TWO_PASS, bool RESID>
constexpr int nt_max() { return (TWO_PASS || RESID) ? 4 : 8; }

template <typename MT, bool TWO_PASS, bool RESID, int NT>
struct MmaShape {
  static constexpr int BN = 16 * NT;  // queries a block owns: NT n-tiles for each warp of a pair
  static constexpr int A_BYTES = 16 * MmaRows<MT>::ROW_BYTES;
  static constexpr int STAGE = A_BYTES + (RESID ? 16 * KC : 0);
  static constexpr int PASSES_Q = TWO_PASS ? 2 : 1;
  // stages, queries, staged mins, qe, running pool (values, positions, NaN flags)
  static int smem(int D) {
    return MMA_PAIRS * NSTAGE * STAGE + PASSES_Q * BN * D * 2 + BN * RES_LD * 4 + 2 * BN * 4 +
           BN * RUN_MAX * 8 + BN * 4;
  }
};

template <typename MT, bool TWO_PASS, bool RESID, int NT>
__global__ void __launch_bounds__(MMA_WARPS * 32, 1) sweep_mma_kernel(const MmaArgs a) {
  using S = MmaShape<MT, TWO_PASS, RESID, NT>;
  using Rows = MmaRows<MT>;
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
  const int kc = a.D / KC;
  const int qrow = a.D * 2;                // bytes of one query row
  const float INF = inf_f();

  char* my = smem + pair * NSTAGE * S::STAGE;
  char* qs = smem + MMA_PAIRS * NSTAGE * S::STAGE;
  float* res = reinterpret_cast<float*>(qs + S::PASSES_Q * BN * qrow);   // [BN][RES_LD]
  float* qe_s = res + BN * RES_LD;                                        // [BN][2]
  float* run_v = qe_s + 2 * BN;                                           // [BN][RUN_MAX]
  int* run_p = reinterpret_cast<int*>(run_v + BN * RUN_MAX);              // [BN][RUN_MAX]
  unsigned* nanq = reinterpret_cast<unsigned*>(run_p + BN * RUN_MAX);     // [BN]

  // the query tile, once per block, zero past the block's queries: row r's 16-byte chunk
  // c at c ^ ((r & 1) << 2)
  {
    const int cpr = a.D / 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = threadIdx.x; idx < BN * cpr; idx += blockDim.x) {
      const int r = idx / cpr, ch = idx % cpr;
      const int at = r * qrow + ((ch ^ ((r & 1) << 2)) * 16);
      const long long src = (long long)(q0 + r) * a.D + ch * 8;
      *reinterpret_cast<uint4*>(qs + at) =
          r < bn ? *reinterpret_cast<const uint4*>(a.qh + src) : zero;
      if constexpr (TWO_PASS)
        *reinterpret_cast<uint4*>(qs + BN * qrow + at) =
            r < bn ? *reinterpret_cast<const uint4*>(a.qres + src) : zero;
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
    char* st = my + (z % NSTAGE) * S::STAGE;
    constexpr int CPR = Rows::ROW_BYTES / 16;
    const char* src = static_cast<const char*>(a.mirror) +
                      (row0 * a.D + (long long)c * KC) * (long long)sizeof(MT);
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

  float acc1[NT][4], acc2[TWO_PASS ? NT : 1][4], acc3[RESID ? NT : 1][4];
  float best[NT][2];                       // r1 = 32: the window's min over its first m-tile
  float rb[2], rsc[2], rrs[2], re1[2], re2[2];  // row terms of rows g and g + 8

#pragma unroll
  for (int z = 0; z < NSTAGE - 1; ++z) {
    if (z < total) issue(z);
    cp_async_commit();
  }
  for (int z = 0; z < total; ++z) {
    cp_async_wait<NSTAGE - 2>();
    // both warps' copies of step z are visible to both, and both have left step z - 1,
    // whose buffer is refilled here
    asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1));
    if (z + NSTAGE - 1 < total) issue(z + NSTAGE - 1);
    cp_async_commit();
    const int u = z / kc, c = z % kc, s = u / r1, mt = u % r1;
    const char* st = my + (z % NSTAGE) * S::STAGE;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc1[n][e] = 0.f;
          if constexpr (TWO_PASS) acc2[n][e] = 0.f;
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
    // query row (n0 + n)*8 + g's 16-byte chunk of dimensions c*128 + 32j + 8t sits at
    // chunk c*16 + 4*(j ^ (g & 1)) + t of the row (the fill's swizzle; rows g + 8n share
    // g's)
    const int q_at = (n0 * 8 + g) * qrow + (c * (KC / 8) + t) * 16;
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
        b[n] = *reinterpret_cast<const uint4*>(qs + at);
        if constexpr (TWO_PASS) p[n] = *reinterpret_cast<const uint4*>(qs + BN * qrow + at);
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
        if constexpr (TWO_PASS) dots = __fadd_rn(dots, acc2[n][e]);
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

int launch_fma(const Args& a, const void* mirror) {
  if (a.Bq % FBN || a.Bc > a.Bq) return (int)cudaErrorInvalidValue;
  const int n_qtiles = a.Bq / FBN;
  const int subs = a.pool != nullptr ? 32 / a.r1 : 1;  // with the pool a block owns a tile
  const long long blocks = a.cap / ((long long)a.r1 * BM * subs) * n_qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fma_kernel<<<(unsigned)blocks, THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.qh), static_cast<const float*>(mirror), a.scale, a.bias, a.qe,
      a.eb1, a.eb2, a.out, a.bm, a.pool, a.D, a.B, a.Bc, a.Bq, a.r1, a.n_eb, n_qtiles, a.m,
      subs, a.bp_width);
  return (int)cudaGetLastError();
}

template <typename MT, bool TWO_PASS, bool RESID, int NT>
int launch_mma_nt(const Args& a, const void* mirror) {
  using S = MmaShape<MT, TWO_PASS, RESID, NT>;
  const int smem = S::smem(a.D);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = a.cap / TILE_ROWS * ((a.Bq + S::BN - 1) / S::BN);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = sweep_mma_kernel<MT, TWO_PASS, RESID, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const MmaArgs m{static_cast<const uint16_t*>(a.qh), static_cast<const uint16_t*>(a.qres), mirror,
                  a.resid, a.rscale, a.scale, a.bias, a.qe, a.eb1, a.eb2, a.out, a.bm, a.pool,
                  a.D, a.B, a.Bc, a.Bq, a.r1, a.n_eb, a.m, a.bp_width};
  kernel<<<(unsigned)blocks, MMA_WARPS * 32, smem, a.stream>>>(m);
  return (int)cudaGetLastError();
}

// The query tile follows the live count: the widest tile the program's registers hold,
// or the narrow one (16 queries) for a batch that needs no more, or where the wide tile's
// queries do not fit in shared memory beside the stages (Dp > 128).
template <typename MT, bool TWO_PASS, bool RESID>
int launch_mma(const Args& a, const void* mirror) {
  constexpr int WIDE = nt_max<TWO_PASS, RESID>();
  if (a.Bq % 8 || a.Bc > a.Bq || a.D % KC) return (int)cudaErrorInvalidValue;
  if (a.Bq > 16 * NT_NARROW && MmaShape<MT, TWO_PASS, RESID, WIDE>::smem(a.D) <= SMEM_MAX)
    return launch_mma_nt<MT, TWO_PASS, RESID, WIDE>(a, mirror);
  return launch_mma_nt<MT, TWO_PASS, RESID, NT_NARROW>(a, mirror);
}

}  // namespace

// Plain C entry point (bound with ctypes).  mirror [cap, D] of mirror_type 0 = bf16 bits,
// 1 = int8 codes, 2 = f32.  Queries: for a bf16 or int8 mirror qh / qres bf16 [Bq, D]
// (rows, Bq a multiple of 8); for an f32 mirror qh f32 [D, Bq] (transposed, Bq a multiple
// of 128); both zero-padded past the live rows.  resid: int8 [cap, D] or null; rscale /
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
  switch (mirror_type) {
    case 0:
      if (two_pass && use_resid) return launch_mma<uint16_t, true, true>(a, mirror);
      if (two_pass) return launch_mma<uint16_t, true, false>(a, mirror);
      if (use_resid) return launch_mma<uint16_t, false, true>(a, mirror);
      return launch_mma<uint16_t, false, false>(a, mirror);
    case 1:
      if (two_pass && use_resid) return launch_mma<int8_t, true, true>(a, mirror);
      if (two_pass) return launch_mma<int8_t, true, false>(a, mirror);
      if (use_resid) break;
      return launch_mma<int8_t, false, false>(a, mirror);
    case 2:
      if (two_pass || use_resid) break;
      return launch_fma(a, mirror);
  }
  return (int)cudaErrorInvalidValue;
}
