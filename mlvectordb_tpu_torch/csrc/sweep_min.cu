// Phase 1 of the certified bf16-sweep exact k-NN: rank + consecutive-row window-min, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel mlvectordb_tpu/ops/pallas_knn_t.py:_sweep_kernel (launched by
// _window_mins), in the variants the certified sweep path runs: the light program (one
// pass), the heavy program (two_pass: the query's bf16 residual against the same rows;
// use_resid: int8 codes of each row's bf16 rounding residual, times a per-row scale),
// the cosine scale row, up to two folded certificate bound rows, and the level-2 block
// mins at r1 = 32.  For rows m of the bf16 mirror [cap, Dp] and folded queries qh
// (and qres):
//
//   rank = (qh.m [+ qres.m] [+ (qh.resid) * rscale]) [* scale] + bias - sum_t qe_t * eb_t
//
// in the JAX package's order of terms, then the min over each window f of r1
// CONSECUTIVE rows [f*r1, (f+1)*r1), written tile-major [nt, B, g*128] (g = 32 / r1) at
// position t*g*128 + a*128 + j for window f = (t*128 + j)*g + a — the JAX package's map,
// so the outputs compare element by element.  The [cap, B] rank matrix never exists.
//
// What bounds it: the certificate's slack (pallas_knn_t.py:1184-1186, Dp*2^-22*|qh|*maxd)
// assumes exact bf16 x bf16 and bf16 x int8 products summed in f32 with round-to-nearest.
// Tensor-core accumulation does not promise that, so this kernel converts the operands to
// f32 and uses f32 FMA on the CUDA cores: the products are exact and the sums are IEEE
// f32.  At the engine's B = 512 bucket and 2^20 x 128 rows that is 2*2^20*512*128 =
// 137 GFLOP (light) and three times that (heavy) against 256 MB of mirror (+128 MB of
// codes): compute-bound on the f32 pipes (67 TFLOP/s peak on an H100 SXM at 700 W).
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

template <bool TWO_PASS, bool RESID>
__global__ void __launch_bounds__(THREADS, 1)
sweep_min_kernel(const float* __restrict__ qh_t, const float* __restrict__ qres_t,
                 const uint16_t* __restrict__ mirror, const int8_t* __restrict__ resid,
                 const float* __restrict__ rscale, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ qe,
                 const float* __restrict__ eb1, const float* __restrict__ eb2,
                 float* __restrict__ out, float* __restrict__ bm, int D, int B, int Bp,
                 int r1, int n_eb, int n_qtiles) {
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

  const int tid = threadIdx.x;
  const long long wblock = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BN;
  const long long w0 = wblock * BM;              // first window of the block

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

  float best[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) best[i][j] = __int_as_float(0x7f800000);  // +inf

  const int nk = D / BK;
  for (int r = 0; r < r1; ++r) {
    const long long a_grow = (w0 + a_row) * r1 + r;     // the row this thread loads
    const uint16_t* a_src = mirror + a_grow * D + a_col;
    const int8_t* r_src = resid + a_grow * D + a_col;

    float acc1[8][TN], acc2[8][TN], acc3[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc1[i][j] = acc2[i][j] = acc3[i][j] = 0.f;

    uint2 a_reg = *reinterpret_cast<const uint2*>(a_src);
    uint32_t r_reg = 0u;
    if constexpr (RESID) r_reg = *reinterpret_cast<const uint32_t*>(r_src);
    float4 q_reg = q_loader ? *reinterpret_cast<const float4*>(q_src) : make_float4(0, 0, 0, 0);
    int buf = 0;
    for (int kc = 0; kc < nk; ++kc) {
      float v[4];
      bf16x4_to_f32(a_reg, v);
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
        a_reg = *reinterpret_cast<const uint2*>(a_src + (kc + 1) * BK);
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
      row_bias[tid] = bias[row];
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
        rank = __fadd_rn(rank, row_bias[lr]);
        if (n_eb > 0) rank = __fsub_rn(rank, __fmul_rn(q_e[0][lq], row_eb1[lr]));
        if (n_eb > 1) rank = __fsub_rn(rank, __fmul_rn(q_e[1][lq], row_eb2[lr]));
        best[i][j] = fminf(best[i][j], rank);
      }
    }
  }

  // window f = w0 + lr of tile t = f / (128 g) sits at lane (lf % g)*128 + lf / g
  const int g = 32 / r1;
  const long long gw = (long long)g * WLANE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long f = w0 + (i >> 2) * 64 + tx * 4 + (i & 3);
    const long long t = f / gw;
    const int lf = (int)(f - t * gw);
    const long long col = (long long)(lf % g) * WLANE + lf / g;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
      if (b < B) out[(t * B + b) * gw + col] = best[i][j];
    }
  }

  if (bm != nullptr) {
    // level-2 block mins (g = 1: the block's 128 windows are one whole tile): min over
    // the thread's 8 windows, then over the 16 lanes that share its queries
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float m = best[0][j];
#pragma unroll
      for (int i = 1; i < 8; ++i) m = fminf(m, best[i][j]);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const int b = q0 + (j >> 2) * 64 + ty * 4 + (j & 3);
      if (tx == 0 && b < B) bm[wblock * B + b] = m;
    }
  }
}

template <bool TWO_PASS, bool RESID>
int launch(const float* qh_t, const float* qres_t, const uint16_t* mirror, const int8_t* resid,
           const float* rscale, const float* scale, const float* bias, const float* qe,
           const float* eb1, const float* eb2, float* out, float* bm, long long cap, int D,
           int B, int Bp, int r1, int n_eb, cudaStream_t stream) {
  constexpr int BN = (TWO_PASS || RESID) ? 64 : 128;
  if (Bp % BN || B > Bp) return (int)cudaErrorInvalidValue;
  const int n_qtiles = Bp / BN;
  const long long blocks = cap / ((long long)r1 * BM) * n_qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sweep_min_kernel<TWO_PASS, RESID><<<(unsigned)blocks, THREADS, 0, stream>>>(
      qh_t, qres_t, mirror, resid, rscale, scale, bias, qe, eb1, eb2, out, bm, D, B, Bp, r1,
      n_eb, n_qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  qh_t / qres_t: f32 [D, Bp] (queries
// transposed, zero-padded to Bp); mirror: bf16 bits [cap, D]; resid: int8 [cap, D] or
// null; rscale / scale / eb1 / eb2: f32 [cap] or null; bias: f32 [cap]; qe: f32 [Bp, 2];
// out: f32 [cap / 4096, B, (32 / r1) * 128]; bm: f32 [cap / 4096, B] or null (r1 = 32
// only).  Returns cudaGetLastError() after the launch; 0 means it was accepted.
extern "C" int mlvdb_sweep_min(const float* qh_t, const float* qres_t, const void* mirror,
                               const void* resid, const float* rscale, const float* scale,
                               const float* bias, const float* qe, const float* eb1,
                               const float* eb2, float* out, float* bm, long long cap, int D,
                               int B, int Bp, int r1, int n_eb, void* stream) {
  if (cap <= 0 || D <= 0 || D % (2 * BK) || B <= 0 || r1 <= 0 || 32 % r1 ||
      cap % (4096LL) || n_eb < 0 || n_eb > 2 || (bm != nullptr && r1 != 32) ||
      (resid != nullptr) != (rscale != nullptr))
    return (int)cudaErrorInvalidValue;
  const uint16_t* m = static_cast<const uint16_t*>(mirror);
  const int8_t* z = static_cast<const int8_t*>(resid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two_pass = qres_t != nullptr, use_resid = resid != nullptr;
  if (two_pass && use_resid)
    return launch<true, true>(qh_t, qres_t, m, z, rscale, scale, bias, qe, eb1, eb2, out, bm,
                              cap, D, B, Bp, r1, n_eb, s);
  if (two_pass)
    return launch<true, false>(qh_t, qres_t, m, z, rscale, scale, bias, qe, eb1, eb2, out, bm,
                               cap, D, B, Bp, r1, n_eb, s);
  if (use_resid)
    return launch<false, true>(qh_t, qres_t, m, z, rscale, scale, bias, qe, eb1, eb2, out, bm,
                               cap, D, B, Bp, r1, n_eb, s);
  return launch<false, false>(qh_t, qres_t, m, z, rscale, scale, bias, qe, eb1, eb2, out, bm,
                              cap, D, B, Bp, r1, n_eb, s);
}
