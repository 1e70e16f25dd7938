// Phase 1 of the certified sweep exact k-NN: rank + consecutive-row window-min, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel mlvectordb_tpu/ops/pallas_knn_t.py:_sweep_kernel (launched by
// _window_mins), in the variants the certified sweep path runs: the light program (one
// pass), the heavy program (two_pass: the query's bf16 residual against the same rows;
// use_resid: int8 codes of each row's residual, times a per-row scale), the cosine scale
// row, up to two folded certificate bound rows, the level-2 block mins at r1 = 32, and the
// per-tile top-m candidate pool (n_top, with or without the window-min matrix: skip_wm).
// The mirror's element type is a template parameter (only the stage loader differs):
//   bf16 bits — the bf16 mirror of an f32 store (light, two_pass, two_pass + use_resid);
//   int8      — the int8 primary mirror (sweep_dtype="int8"): codes z1 against bf16
//               queries, the scale row carrying s1 and use_resid's multiplier s2 / s1
//               (one pass, two_pass, two_pass + use_resid);
//   f32       — the f32 mirror (sweep_dtype="float32"): f32 queries, one pass.
// The bias row may be absent (rank = dots: the int8 probe's convert-and-FMA kernel).
// For rows m of the mirror [cap, Dp] and folded queries qh (and qres):
//
//   rank = (qh.m [+ qres.m] [+ (qh.resid) * rscale]) [* scale] + bias - sum_t qe_t * eb_t
//
// in the JAX package's order of terms, then the min over each window f of r1
// CONSECUTIVE rows [f*r1, (f+1)*r1), written tile-major [nt, B, g*128] (g = 32 / r1) at
// position t*g*128 + a*128 + j for window f = (t*128 + j)*g + a — the JAX package's map,
// so the outputs compare element by element.  Or, on request, in the JAX package's
// non-transposed form [B, nt*g*128] (pallas_knn_t.py:453-457): the same positions, each
// query's row of all tiles (window mins only: no block mins, no pool beside it, as in
// the JAX package).  The [cap, B] rank matrix never exists.
// Every min propagates NaN, as jnp.minimum does: a NaN rank makes its window's min NaN.
//
// The pool (pallas_knn_t.py:343-380): for each tile t and query b, the m smallest
// (value, position) pairs of the tile's g*128 window mins, in the order m rounds of
// min / first-argmin / mask give them, written [nt, SUB, B] (SUB = _topm_sub_rows(m)):
// rows 0..m-1 the values, rows m..m+m/2-1 the positions packed p0 + out_w*p1, the rest
// +inf.  Those rounds yield the entries below +inf in (value, position) order; once only
// +inf is left they repeat (+inf, position 0), and a tile holding a NaN min gives NaN
// values at position out_w.  A tile spans g blocks of 128 windows, and blocks share
// nothing, so with the pool a block owns a whole tile: it walks the tile's g sub-blocks
// in turn and carries a running top-m per query (one entry per lane of the 16 that share
// a query column; m*g <= 32 keeps m <= 16 wherever g > 1), so the pool never leaves the
// SM.  Each round is a lexicographic min over a lane's 8 windows and its running entry,
// a 16-lane shuffle reduction, and the winner masking its entry.
//
// What bounds it: the certificate's slack (pallas_knn_t.py:1184-1186, Dp*2^-22*|qh|*maxd)
// assumes exact bf16 x bf16 and bf16 x int8 products summed in f32 with round-to-nearest.
// Tensor-core accumulation does not promise that, so this kernel converts the operands to
// f32 and uses f32 FMA on the CUDA cores: the products are exact (an int8 code has at
// most 7 significant bits, a bf16 value 8) and the sums are IEEE f32.  The f32 mirror's
// products round once in each FMA, which the slack covers.  At the engine's B = 512
// bucket and 2^20 x 128 rows that is 2*2^20*512*128 = 137 GFLOP (light, f32) and three
// times that (heavy) against 128-512 MB of mirror (+128 MB of codes): compute-bound on
// the f32 pipes (67 TFLOP/s peak on an H100 SXM at 700 W).
//
// What the design does about it: a register-tiled f32 product, as in window_min.cu.  A
// block of 256 threads owns 128 windows x BN queries and walks the r1 rows of its windows
// itself (step r computes rows (w0 + i)*r1 + r for its 128 windows i), forming the dot
// block over Dp in stages of 8 through double-buffered shared memory and folding each
// step's ranks into running window mins in registers.  Light: 8 rows x 8 queries per
// thread (BN = 128).  Heavy: three accumulators (qh.m, qres.m, qh.resid) of 8 x 4
// (BN = 64), so the registers hold.  Nothing carries between blocks.  Making it faster
// (wgmma over bf16 once its error is shown inside the slack, TMA) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // windows per block (= rows per r-step)
constexpr int BK = 8;         // depth of one shared-memory stage
constexpr int THREADS = 256;
constexpr int WLANE = 128;    // windows per output block of a tile
constexpr int RUN_LANES = 16; // lanes sharing a query column: the running pool's width

// jnp.minimum's rule: a NaN operand makes the min NaN (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }

// (v, p) before (bv, bp) in (value, position) order; a NaN value is never before anything
__device__ __forceinline__ bool lex_less(float v, int p, float bv, int bp) {
  return v < bv || (v == bv && p < bp);
}

__device__ __forceinline__ void bf16x4_to_f32(uint2 u, float* v) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void i8x4_to_f32(uint32_t u, float* v) {
  v[0] = (float)((int)(u << 24) >> 24);
  v[1] = (float)((int)(u << 16) >> 24);
  v[2] = (float)((int)(u << 8) >> 24);
  v[3] = (float)((int)u >> 24);
}

// The stage loader of each mirror type: 4 consecutive elements of one row, as f32
template <typename MT> struct Stage;
template <> struct Stage<uint16_t> {  // bf16 bits
  using Reg = uint2;
  static __device__ __forceinline__ void cvt(Reg u, float* v) { bf16x4_to_f32(u, v); }
};
template <> struct Stage<int8_t> {
  using Reg = uint32_t;
  static __device__ __forceinline__ void cvt(Reg u, float* v) { i8x4_to_f32(u, v); }
};
template <> struct Stage<float> {
  using Reg = float4;
  static __device__ __forceinline__ void cvt(Reg u, float* v) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};

template <typename MT, bool TWO_PASS, bool RESID>
__global__ void __launch_bounds__(THREADS, 1)
sweep_min_kernel(const float* __restrict__ qh_t, const float* __restrict__ qres_t,
                 const MT* __restrict__ mirror, const int8_t* __restrict__ resid,
                 const float* __restrict__ rscale, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ qe,
                 const float* __restrict__ eb1, const float* __restrict__ eb2,
                 float* __restrict__ out, float* __restrict__ bm, float* __restrict__ pool,
                 int D, int B, int Bp, int r1, int n_eb, int n_qtiles, int m, int subs,
                 long long bp_width) {
  constexpr bool HEAVY = TWO_PASS || RESID;
  constexpr int TN = HEAVY ? 4 : 8;     // queries per thread
  constexpr int BN = 16 * TN;           // queries per block
  constexpr int QF4 = BK * BN / 4;      // float4 loads of one query stage
  static_assert(!TWO_PASS || 2 * QF4 <= THREADS, "qh and qres stages need one load each");

  __shared__ __align__(16) float As[2][BK][BM];   // mirror stage, transposed: [k][row]
  __shared__ __align__(16) float Rs[RESID ? 2 : 1][BK][RESID ? BM : 4];
  __shared__ __align__(16) float Qs[2][BK][BN];   // qh stage: [k][query]
  __shared__ __align__(16) float Ps[TWO_PASS ? 2 : 1][BK][TWO_PASS ? BN : 4];
  __shared__ float row_bias[BM], row_scale[BM], row_rscale[BM], row_eb1[BM], row_eb2[BM];
  __shared__ float q_e[2][BN];
  // the running pool: entry tx of each of the thread's TN queries, private to the thread
  __shared__ float run_v[TN][THREADS];
  __shared__ int run_p[TN][THREADS];

  const int tid = threadIdx.x;
  const long long group = blockIdx.x / n_qtiles;  // subs consecutive 128-window blocks
  const int q0 = (blockIdx.x % n_qtiles) * BN;

  // compute mapping: rows tx*4+{0..3}, 64+tx*4+{0..3}; queries ty*4+{0..3} (+64 for TN 8)
  const int tx = tid % 16, ty = tid / 16;
  // load mapping: mirror and resid stages [128 rows x 8] (4 values a thread), query
  // stages [8 x BN] (one float4 a thread)
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const bool q_loader = tid < QF4 || (TWO_PASS && tid < 2 * QF4);
  const int q_idx = tid < QF4 ? tid : tid - QF4;
  const int q_row = q_idx / (BN / 4), q_col = (q_idx % (BN / 4)) * 4;
  const float* q_src = (tid < QF4 || !TWO_PASS ? qh_t : qres_t) + (long long)q_row * Bp + q0 + q_col;

  if (tid < BN) {
    q_e[0][tid] = qe[(long long)(q0 + tid) * 2];
    q_e[1][tid] = qe[(long long)(q0 + tid) * 2 + 1];
  }

  const float INF = __int_as_float(0x7f800000);
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
    using AReg = typename Stage<MT>::Reg;
    const long long a_grow = (w0 + a_row) * r1 + r;     // the row this thread loads
    const MT* a_src = mirror + a_grow * D + a_col;
    const int8_t* r_src = resid + a_grow * D + a_col;

    float acc1[8][TN], acc2[8][TN], acc3[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc1[i][j] = acc2[i][j] = acc3[i][j] = 0.f;

    AReg a_reg = *reinterpret_cast<const AReg*>(a_src);
    uint32_t r_reg = 0u;
    if constexpr (RESID) r_reg = *reinterpret_cast<const uint32_t*>(r_src);
    float4 q_reg = q_loader ? *reinterpret_cast<const float4*>(q_src) : make_float4(0, 0, 0, 0);
    int buf = 0;
    for (int kc = 0; kc < nk; ++kc) {
      float v[4];
      Stage<MT>::cvt(a_reg, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) As[buf][a_col + c][a_row] = v[c];
      if constexpr (RESID) {
        i8x4_to_f32(r_reg, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) Rs[buf][a_col + c][a_row] = v[c];
      }
      if (tid < QF4) {
        *reinterpret_cast<float4*>(&Qs[buf][q_row][q_col]) = q_reg;
      } else if constexpr (TWO_PASS) {
        if (tid < 2 * QF4) *reinterpret_cast<float4*>(&Ps[buf][q_row][q_col]) = q_reg;
      }
      __syncthreads();
      if (kc + 1 < nk) {  // next stage's loads are in flight during this stage's FMAs
        a_reg = *reinterpret_cast<const AReg*>(a_src + (kc + 1) * BK);
        if constexpr (RESID) r_reg = *reinterpret_cast<const uint32_t*>(r_src + (kc + 1) * BK);
        if (q_loader)
          q_reg = *reinterpret_cast<const float4*>(q_src + (long long)(kc + 1) * BK * Bp);
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][tx * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float b[TN], c[TN], z[8];
        {
          const float4 b0 = *reinterpret_cast<const float4*>(&Qs[buf][k][ty * 4]);
          b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
          if constexpr (TN == 8) {
            const float4 b1 = *reinterpret_cast<const float4*>(&Qs[buf][k][64 + ty * 4]);
            b[TN - 4] = b1.x; b[TN - 3] = b1.y; b[TN - 2] = b1.z; b[TN - 1] = b1.w;
          }
        }
        if constexpr (TWO_PASS) {
          const float4 c0 = *reinterpret_cast<const float4*>(&Ps[buf][k][ty * 4]);
          c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
        }
        if constexpr (RESID) {
          const float4 z0 = *reinterpret_cast<const float4*>(&Rs[buf][k][tx * 4]);
          const float4 z1 = *reinterpret_cast<const float4*>(&Rs[buf][k][64 + tx * 4]);
          z[0] = z0.x; z[1] = z0.y; z[2] = z0.z; z[3] = z0.w;
          z[4] = z1.x; z[5] = z1.y; z[6] = z1.z; z[7] = z1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc1[i][j] = fmaf(a[i], b[j], acc1[i][j]);
            if constexpr (TWO_PASS) acc2[i][j] = fmaf(a[i], c[j], acc2[i][j]);
            if constexpr (RESID) acc3[i][j] = fmaf(z[i], b[j], acc3[i][j]);
          }
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
      if constexpr (RESID) row_rscale[tid] = rscale[row];
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
        float dots = acc1[i][j];
        if constexpr (TWO_PASS) dots = __fadd_rn(dots, acc2[i][j]);
        if constexpr (RESID) dots = __fadd_rn(dots, __fmul_rn(acc3[i][j], row_rscale[lr]));
        float rank = scale ? __fmul_rn(dots, row_scale[lr]) : dots;
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
        if (b < B) out[at] = best[i][j];
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
      if (tx == 0 && b < B) bm[wblock * B + b] = v;
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
        } else if (tx == 0 && b < B) {
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
        if (b < B)
          for (int row = m + m / 2; row < sub_rows; ++row) tile_pool[(long long)row * B + b] = INF;
      }
    }
  }
  }  // sub-blocks
}

// Everything one launch takes beside the mirror (see mlvdb_sweep_min)
struct Args {
  const float *qh_t, *qres_t;
  const int8_t* resid;
  const float *rscale, *scale, *bias, *qe, *eb1, *eb2;
  float *out, *bm, *pool;
  long long cap;
  int D, B, Bp, r1, n_eb, m;
  long long bp_width;  // 0: tile-major output; else [B, bp_width = cap / r1]
  cudaStream_t stream;
};

template <typename MT, bool TWO_PASS, bool RESID>
int launch(const Args& a, const void* mirror) {
  constexpr int BN = (TWO_PASS || RESID) ? 64 : 128;
  if (a.Bp % BN || a.B > a.Bp) return (int)cudaErrorInvalidValue;
  const int n_qtiles = a.Bp / BN;
  const int subs = a.pool != nullptr ? 32 / a.r1 : 1;  // with the pool a block owns a tile
  const long long blocks = a.cap / ((long long)a.r1 * BM * subs) * n_qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_min_kernel<MT, TWO_PASS, RESID><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
      a.qh_t, a.qres_t, static_cast<const MT*>(mirror), a.resid, a.rscale, a.scale, a.bias,
      a.qe, a.eb1, a.eb2, a.out, a.bm, a.pool, a.D, a.B, a.Bp, a.r1, a.n_eb, n_qtiles, a.m,
      subs, a.bp_width);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  qh_t / qres_t: f32 [D, Bp] (queries
// transposed, zero-padded to Bp); mirror [cap, D] of mirror_type 0 = bf16 bits, 1 = int8
// codes, 2 = f32; resid: int8 [cap, D] or null; rscale / scale / eb1 / eb2 / bias: f32
// [cap] or null; qe: f32 [Bp, 2]; out: f32 [cap / 4096, B, (32 / r1) * 128] or null
// (skip_wm: the pool is the only output); bm: f32 [cap / 4096, B] or null (r1 = 32 only);
// pool: f32 [cap / 4096, SUB, B] or null, m its even depth, 8..32, with
// m * (32 / r1) <= 32 and never beside bm.  out_bp = 1: out is [B, cap / r1] instead
// (the non-transposed form, window mins only: bm and pool null).  The passes a mirror
// type takes: bf16 any of qres_t and resid; int8 none, qres_t, or both; f32 neither.
// Returns cudaGetLastError() after the launch; 0 means it was accepted.
extern "C" int mlvdb_sweep_min(const float* qh_t, const float* qres_t, const void* mirror,
                               const void* resid, const float* rscale, const float* scale,
                               const float* bias, const float* qe, const float* eb1,
                               const float* eb2, float* out, float* bm, float* pool,
                               long long cap, int D, int B, int Bp, int r1, int n_eb, int m,
                               int mirror_type, int out_bp, void* stream) {
  if (cap <= 0 || D <= 0 || D % (2 * BK) || B <= 0 || r1 <= 0 || 32 % r1 ||
      cap % (4096LL) || n_eb < 0 || n_eb > 2 || (bm != nullptr && r1 != 32) ||
      (resid != nullptr) != (rscale != nullptr) || (out == nullptr && pool == nullptr) ||
      (pool != nullptr && (bm != nullptr || m < 8 || m > 32 || m % 2 || m * (32 / r1) > 32)) ||
      (out_bp && (out == nullptr || bm != nullptr || pool != nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{qh_t, qres_t, static_cast<const int8_t*>(resid), rscale, scale, bias, qe, eb1,
               eb2, out, bm, pool, cap, D, B, Bp, r1, n_eb, m, out_bp ? cap / r1 : 0,
               static_cast<cudaStream_t>(stream)};
  const bool two_pass = qres_t != nullptr, use_resid = resid != nullptr;
  switch (mirror_type) {
    case 0:
      if (two_pass && use_resid) return launch<uint16_t, true, true>(a, mirror);
      if (two_pass) return launch<uint16_t, true, false>(a, mirror);
      if (use_resid) return launch<uint16_t, false, true>(a, mirror);
      return launch<uint16_t, false, false>(a, mirror);
    case 1:
      if (two_pass && use_resid) return launch<int8_t, true, true>(a, mirror);
      if (two_pass) return launch<int8_t, true, false>(a, mirror);
      if (use_resid) break;
      return launch<int8_t, false, false>(a, mirror);
    case 2:
      if (two_pass || use_resid) break;
      return launch<float, false, false>(a, mirror);
  }
  return (int)cudaErrorInvalidValue;
}
