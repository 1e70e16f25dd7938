// Phase 1 of the fused exact k-NN: distance + strided window-min, f32, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of mlvectordb_tpu/ops/pallas_knn.py:
//   _fast_kernel   (no tombstones: row norms from the resident tile, rows >= hw masked)
//   _masked_kernel (a per-row bias column carries the tombstone mask; l2 puts the row
//                   norms in it too, cosine recomputes them)
// Both compute, for data [N, D] and queries qt [D, B], the distances of every row to every
// query and write only the min over each window of r1 rows: out [N / r1, B].  Window w
// covers rows (w / W) * db_tile + w % W + r * W for r < r1, with W = db_tile / r1 (the JAX
// package's strided layout, so the two outputs compare element by element).  The [N, B]
// distance matrix never exists in device memory.
//
// The row type is a template parameter: f32 rows (the default store) or bf16 rows (a
// dtype="bfloat16" store, where the JAX kernels multiply at DEFAULT precision, bf16 x bf16
// with f32 accumulation, pallas_knn.py:93-99).  bf16 rows are converted to f32 on load,
// which is exact; the caller rounds the queries to bf16 and passes them as f32, so every
// product is exact and the sums are the f32 kernel's.  Row norms come from the loaded
// (bf16) rows, as the JAX kernels compute them; qn comes from the f32 query.
//
// What bounds it: the dots must be true f32.  The selection margin s = min(2k, k + 16)
// that phase 2 applies to these window mins is a sound bound only because the window
// ranking and the rescan are both f32 (pallas_knn.py:93-99), so this kernel uses f32 FMA
// on the CUDA cores: no TF32, no tensor cores, no library product.  At the main-path
// shapes (N = 2^20, D = 128, B = 512) that is 2 * 2^20 * 512 * 128 = 137 GFLOP against
// 512 MB of data (256 MB as bf16) read once per 128-query tile: compute-bound on the f32
// pipes (67 TFLOP/s peak on an H100 SXM at 700 W), for either row type.
//
// What the design does about it: a register-tiled f32 product.  A block of 256 threads
// owns 128 windows x 128 queries; each thread keeps an 8 x 8 tile of dot accumulators
// plus an 8 x 8 tile of running window mins.  The block walks the r1 rows of its windows
// (row r * W + j of the tile), forms the [128, 128] dot block over D in stages of 8
// through double-buffered shared memory (one barrier per stage, 16 floats read from
// shared memory for 64 FMAs), applies the metric and the mask in registers and folds the
// result into the window mins.  Row norms are summed from the same loads, so they cost no
// extra traffic.  Making it faster (split-f32 on the tensor cores, TMA, wgmma) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // windows per block (= rows per r-step)
constexpr int BN = 128;      // queries per block
constexpr int BK = 8;        // depth of one shared-memory stage
constexpr int THREADS = 256;
constexpr float MASKED = 3.0e38f;  // == ops/distances.MASKED

enum Metric { L2 = 0, IP = 1, COSINE = 2 };

// jnp.minimum's and jnp.maximum's rule: a NaN operand gives NaN (fminf / fmaxf would drop
// it), so a NaN query's window mins are NaN where the JAX kernels' are.  One instruction
// each (PTX min.NaN / max.NaN, sm_80 on): a compare-and-select form cost B4 1.4%.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 4 consecutive elements of one row, as f32: the only code that differs by row type
template <typename RT> struct Row;
template <> struct Row<float> {
  using Reg = float4;
  static __device__ __forceinline__ float4 cvt(Reg u) { return u; }
};
template <> struct Row<uint16_t> {  // bf16 bits: the high half of an f32
  using Reg = uint2;
  static __device__ __forceinline__ float4 cvt(Reg u) {
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
};

template <typename RT, int METRIC, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
window_min_kernel(const RT* __restrict__ data, const float* __restrict__ qt,
                  const float* __restrict__ qn, const float* __restrict__ bias, int hw,
                  float* __restrict__ out, int D, int B, int db_tile, int r1, int n_qtiles) {
  constexpr bool NEED_SQN = (METRIC == COSINE) || (METRIC == L2 && !BIAS);
  __shared__ __align__(16) float As[2][BK][BM];  // data stage, transposed: [k][row]
  __shared__ __align__(16) float Bs[2][BK][BN];  // query stage: [k][query]
  __shared__ float row_sqn[BM];
  __shared__ float row_bias[BM];

  const int tid = threadIdx.x;
  const int group = blockIdx.x / n_qtiles;           // 128 consecutive windows of one tile
  const int q0 = (blockIdx.x % n_qtiles) * BN;
  const int W = db_tile / r1;
  const int groups_per_tile = W / BM;
  // row of window (group * BM + i) at step r: row0 + r * W + i
  const long long row0 =
      (long long)(group / groups_per_tile) * db_tile + (long long)(group % groups_per_tile) * BM;

  // compute mapping: rows ty*4+{0..3}, 64+ty*4+{0..3}; queries tx*4+{0..3}, 64+tx*4+{0..3}
  const int ty = tid / 16, tx = tid % 16;
  // load mapping: data stage [128 rows x 8], query stage [8 x 128 queries], one float4 each
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  const bool b_ok = q0 + b_col < B;  // B % 4 == 0: a float4 is all in or all out

  float qn_r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = q0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    qn_r[j] = c < B ? qn[c] : 0.f;
  }

  float best[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) best[i][j] = __int_as_float(0x7f800000);  // +inf

  const int nk = D / BK;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < r1; ++r) {
    using AReg = typename Row<RT>::Reg;
    const long long step_row0 = row0 + (long long)r * W;
    const RT* a_src = data + (step_row0 + a_row) * D + a_col;
    const float* b_src = qt + (long long)b_row * B + q0 + b_col;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float sq = 0.f;

    AReg a_raw = *reinterpret_cast<const AReg*>(a_src);
    float4 b_reg = b_ok ? *reinterpret_cast<const float4*>(b_src) : zero4;
    int buf = 0;
    for (int kc = 0; kc < nk; ++kc) {
      const float4 a_reg = Row<RT>::cvt(a_raw);
      if (NEED_SQN) {
        sq = fmaf(a_reg.x, a_reg.x, sq);
        sq = fmaf(a_reg.y, a_reg.y, sq);
        sq = fmaf(a_reg.z, a_reg.z, sq);
        sq = fmaf(a_reg.w, a_reg.w, sq);
      }
      As[buf][a_col + 0][a_row] = a_reg.x;
      As[buf][a_col + 1][a_row] = a_reg.y;
      As[buf][a_col + 2][a_row] = a_reg.z;
      As[buf][a_col + 3][a_row] = a_reg.w;
      *reinterpret_cast<float4*>(&Bs[buf][b_row][b_col]) = b_reg;
      __syncthreads();
      if (kc + 1 < nk) {  // next stage's loads are in flight during this stage's FMAs
        a_raw = *reinterpret_cast<const AReg*>(a_src + (kc + 1) * BK);
        b_reg = b_ok ? *reinterpret_cast<const float4*>(b_src + (long long)(kc + 1) * BK * B)
                     : zero4;
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      // Double buffering makes one barrier per stage enough: the next store goes to the
      // other buffer, whose readers all passed this stage's barrier.
      buf ^= 1;
    }

    if (NEED_SQN) {
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);  // the two halves of row a_row
      if ((tid & 1) == 0) row_sqn[a_row] = sq;
    }
    if (BIAS && tid < BM) row_bias[tid] = bias[step_row0 + tid];
    // Every thread is past its last stage and the row terms are visible.  The next
    // step's first store (buffer 0) and its row-term writes come after this barrier and
    // after the next step's own barriers, so no second barrier is needed.
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int lr = i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
      const float s = NEED_SQN ? row_sqn[lr] : 0.f;
      const float bi = BIAS ? row_bias[lr] : 0.f;
      const bool live = BIAS || step_row0 + lr < hw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dot = acc[i][j];
        float d;
        if (METRIC == L2) {
          d = nan_max((BIAS ? bi : s) + qn_r[j] - 2.f * dot, 0.f);
        } else if (METRIC == IP) {
          d = 1.f - dot;
          if (BIAS) d += bi;
        } else {
          d = 1.f - dot * rsqrtf(nan_max(s * qn_r[j], 1e-30f));
          if (BIAS) d += bi;
        }
        if (!live) d = MASKED;  // a dead row is MASKED even when d is NaN (jnp.where)
        best[i][j] = nan_min(best[i][j], d);
      }
    }
  }

  const long long out_row0 = (long long)group * BM;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    float* o = out + (out_row0 + lr) * B + q0;
    if (q0 + tx * 4 < B)
      *reinterpret_cast<float4*>(o + tx * 4) =
          make_float4(best[i][0], best[i][1], best[i][2], best[i][3]);
    if (q0 + 64 + tx * 4 < B)
      *reinterpret_cast<float4*>(o + 64 + tx * 4) =
          make_float4(best[i][4], best[i][5], best[i][6], best[i][7]);
  }
}

template <typename RT, bool BIAS>
int launch(const void* data_v, const float* qt, const float* qn, const float* bias, int hw,
           float* out, long long n_rows, int D, int B, int db_tile, int r1, int metric,
           cudaStream_t stream) {
  if (n_rows <= 0 || D <= 0 || B <= 0 || r1 <= 0 || db_tile <= 0 || D % BK || B % 4 ||
      db_tile % r1 || (db_tile / r1) % BM || n_rows % db_tile || metric < 0 || metric > 2)
    return (int)cudaErrorInvalidValue;
  const RT* data = static_cast<const RT*>(data_v);
  const int n_qtiles = (B + BN - 1) / BN;
  const long long blocks = n_rows / ((long long)r1 * BM) * n_qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(THREADS);
  switch (metric) {
    case L2:
      window_min_kernel<RT, L2, BIAS><<<grid, block, 0, stream>>>(data, qt, qn, bias, hw, out, D,
                                                                 B, db_tile, r1, n_qtiles);
      break;
    case IP:
      window_min_kernel<RT, IP, BIAS><<<grid, block, 0, stream>>>(data, qt, qn, bias, hw, out, D,
                                                                 B, db_tile, r1, n_qtiles);
      break;
    default:
      window_min_kernel<RT, COSINE, BIAS><<<grid, block, 0, stream>>>(data, qt, qn, bias, hw, out,
                                                                     D, B, db_tile, r1, n_qtiles);
  }
  return (int)cudaGetLastError();
}

template <bool BIAS>
int launch_rows(int row_type, const void* data, const float* qt, const float* qn,
                const float* bias, int hw, float* out, long long n_rows, int D, int B,
                int db_tile, int r1, int metric, cudaStream_t stream) {
  switch (row_type) {
    case 0:
      return launch<float, BIAS>(data, qt, qn, bias, hw, out, n_rows, D, B, db_tile, r1, metric,
                                 stream);
    case 1:
      return launch<uint16_t, BIAS>(data, qt, qn, bias, hw, out, n_rows, D, B, db_tile, r1,
                                    metric, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns cudaGetLastError() after the
// launch; 0 means the launch was accepted.  data: [n_rows, D] of row_type 0 = f32, 1 = bf16
// bits; qt: f32 [D, B] (bf16-rounded values for bf16 rows); metric: 0 = l2, 1 = ip,
// 2 = cosine.
extern "C" int mlvdb_window_min_fast(const void* data, const float* qt, const float* qn, int hw,
                                     float* out, long long n_rows, int D, int B, int db_tile,
                                     int r1, int metric, int row_type, void* stream) {
  return launch_rows<false>(row_type, data, qt, qn, nullptr, hw, out, n_rows, D, B, db_tile, r1,
                            metric, static_cast<cudaStream_t>(stream));
}

extern "C" int mlvdb_window_min_masked(const void* data, const float* qt, const float* qn,
                                       const float* bias, float* out, long long n_rows, int D,
                                       int B, int db_tile, int r1, int metric, int row_type,
                                       void* stream) {
  return launch_rows<true>(row_type, data, qt, qn, bias, 0, out, n_rows, D, B, db_tile, r1,
                           metric, static_cast<cudaStream_t>(stream));
}
