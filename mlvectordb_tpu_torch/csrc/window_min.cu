// Phase 1 of the fused exact k-NN: distance + strided window-min on the tensor cores, for
// Hopper (sm_90a).
//
// Replaces the two Pallas kernels of mlvectordb_tpu/ops/pallas_knn.py:
//   _fast_kernel   (no tombstones: row norms from the resident tile, rows >= hw masked)
//   _masked_kernel (a per-row bias column carries the tombstone mask; l2 puts the row
//                   norms in it too, cosine recomputes them)
// Both compute, for data [N, D] and the first Bc queries, the distances of every row to
// every query and write only the min over each window of r1 rows: out [N / r1, Bc].
// Window w covers rows (w / W) * db_tile + w % W + r * W for r < r1, with W = db_tile / r1
// (the JAX package's strided layout, so the outputs compare element by element).  The
// [N, B] distance matrix never exists in device memory.  Every column is computed on its
// own (no value of one query enters another's), so a column's bits do not depend on how
// many columns a launch computes: the caller launches only its live queries.
//
// The products.  The JAX kernels multiply bf16 rows at DEFAULT precision (one bf16 pass,
// f32 sums) and f32 rows at HIGHEST (pallas_knn.py:93-99), which XLA computes on the MXU as
// a multi-pass bf16 product.  Here both run mma.sync.m16n8k16 bf16 x bf16 -> f32:
//   bf16 rows: one pass against the bf16-rounded query (the caller rounds it);
//   f32 rows:  each row element splits in the kernel into hi = bf16_rn(x),
//              mid = bf16_rn(x - hi), lo = bf16(x - hi - mid) (the remainders are exact
//              in f32, and hi + mid + lo == x for |x| from 2^-110 to bf16's largest
//              finite value), the query the same way once per launch (the caller's three
//              bf16 operands), and the six products hi.hi, hi.mid, mid.hi, hi.lo, lo.hi
//              and mid.mid are summed into one f32 accumulator (the split and the f32
//              stage loader are mma_common.cuh's, shared with kernel B3's f32 mirror).
//
// The error, against the exact dot q.x.  Model (Fasi, Higham, Mikaitis and Pranesh,
// "Numerical behavior of NVIDIA tensor cores", PeerJ CS 2021): bf16 products are exact;
// the s products of one k-group and the running sum are aligned to the largest exponent
// among them and truncated to 24 significant bits.  bf16 rows: each of Dp / s groups
// loses under s * 2^-23 of its largest magnitude, at most |q||x|, so
//     |tc - exact| <= Dp * 2^-23 * |q||x|                                  (one pass).
// f32 rows: the dropped terms mid.lo + lo.mid + lo.lo are at most (2 * 2^-24 + 2^-32) of
// sum_i |q_i||x_i| <= |q||x| (|mid| <= 2^-8 |x|, |lo| <= 2^-16 |x| element by element), and
// the six kept passes make 6 * Dp / s groups, each losing under s * 2^-23 of the running
// sum, so on paper
//     |tc - exact| <= (6 * Dp + 1) * 2^-23 * |q||x|.
// The five cross passes add terms at or under 2^-8 of the running sum, so the model's
// worst case (every term truncated by a whole unit of the sum's last place) is far from
// what the card does: the measured maxima against float64 (probes/tc_error.py over
// gaussian and hard f32 rows, chip_smoke.py phase 14, PERF.md) are held to the bar
// Dp * 2^-23 * |q||x|, the bf16 pass's own bound, and f32 rows run the split body only
// because they stay under it.  The phase-2 margin s = min(2k, k + 16) absorbs differences
// of that size between the window mins and the f32 rescan, as it absorbs the TPU's
// multi-pass HIGHEST product.  The epilogue adds JAX's formulas in JAX's order with
// __fadd_rn / __fmul_rn (no contraction), so each column's value is the same in every
// launch.
//
// What bounds it.  At the engine's shapes (N = 2^20, D = 128, B = 128 live in the 512
// bucket, r1 = 8) bf16 rows move 268 MB of rows and 67 MB of window mins (0.10 ms at
// 3.35 TB/s) against 34 GFLOP of bf16 products (0.035 ms): bytes.  f32 rows move 537 MB
// (0.18 ms) against 6 x 34 = 206 GFLOP of bf16 products (0.21 ms): operations; the f32
// FMA route would need 0.51 ms at 67 TFLOP/s.
//
// What the design does about it.  A block of 16 warps owns 128 consecutive windows of a
// tile and a tile of 128 queries (64 or 16 where the launch computes no more), at any Dp.
// The warps work in pairs: pair p owns windows 16p .. 16p + 15 and streams, for each of the
// r1 steps, rows r * W + 16p .. +15 (window j's r-th row) through a 3-stage ring of
// cp.async copies, 256 bytes of each row a stage (64 f32 or 128 bf16 dimensions); each
// warp of the pair multiplies the stage by its half of the query tile.  The query tile (all
// its bf16 parts) is held in shared memory by chunks of the same dimensions, in QSLOTS
// slots: where every chunk fits (Dp <= 128 for f32 rows, <= 512 for bf16 rows) chunk c
// stays in slot c for the whole block, copied once during the first step; past that, each
// stage's chunk is copied from L2 one stage ahead into slot z % QSLOTS and the block's
// warps advance together.  So the rows are read from device memory once per query tile at
// every Dp, and the queries once per block (resident) or once per step (streamed, from
// L2: 1.5x the rows' bytes for f32 rows, 1x for bf16 rows).  A thread reads 8 consecutive
// dimensions of a row and of a query with 16-byte loads: the k order inside an mma is
// permuted the same way on both operands, which changes no product.  The row's squares are
// summed in f32 from the same values (each thread a quarter of the dimensions, then two
// shuffles).  Element e of a C fragment is the same (window, query) pair at every step, so
// each thread keeps its running window min in registers across the r1 steps, with no
// exchange between threads, and writes it once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int PAIRS = 8;          // warp pairs: pair p owns windows 16p .. 16p + 15
constexpr int WARPS = 2 * PAIRS;
constexpr int BM = 16 * PAIRS;    // windows per block (= rows per r-step)
constexpr int NSTAGE = 3;         // cp.async ring depth, per pair
constexpr int ROW_BYTES = 256;    // bytes of each row a stage holds
constexpr int STAGE = 16 * ROW_BYTES;
constexpr int SMEM_MAX = 232448;  // a block's dynamic shared memory on an H100
constexpr float MASKED = 3.0e38f; // == ops/distances.MASKED

enum Metric { L2 = 0, IP = 1, COSINE = 2 };

// jnp.minimum's and jnp.maximum's rule: a NaN operand gives NaN (fminf / fmaxf would drop
// it), so a NaN query's window mins are NaN where the JAX kernels' are.  One instruction
// each (PTX min.NaN / max.NaN, sm_80 on).
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

__device__ __forceinline__ float sq4(uint32_t u, uint32_t v, float s) {
  s = fmaf(bf_lo(u), bf_lo(u), s);
  s = fmaf(bf_hi(u), bf_hi(u), s);
  s = fmaf(bf_lo(v), bf_lo(v), s);
  return fmaf(bf_hi(v), bf_hi(v), s);
}

// The row types.  load(): the 8 consecutive dimensions 32j + 8t .. +7 of rows g (lo) and
// g + 8 (hi) of a stage as P bf16 parts of four bf16x2 registers each; with `need_sq`
// their squares are added to sq[0] (row g) and sq[1] (row g + 8) in f32.  QSLOTS: the
// query tile's chunks of DIMS dimensions shared memory holds beside the ring.
template <typename RT> struct Rows;
template <> struct Rows<uint16_t> {  // bf16 rows: one part, the values themselves
  static constexpr int P = 1;
  static constexpr int DIMS = KC;    // dimensions of a row a stage holds
  static constexpr int QSLOTS = 4;
  static __device__ __forceinline__ int swz(int row, int chunk) {
    return MmaRows<uint16_t>::swz(row, chunk);
  }
  static __device__ __forceinline__ void load(const char* st, int g, int j, int t,
                                              uint4 (&lo)[1], uint4 (&hi)[1], float* sq,
                                              bool need_sq) {
    lo[0] = MmaRows<uint16_t>::load(st, g, j, t);
    hi[0] = MmaRows<uint16_t>::load(st, g + 8, j, t);
    if (need_sq) {
      sq[0] = sq4(lo[0].z, lo[0].w, sq4(lo[0].x, lo[0].y, sq[0]));
      sq[1] = sq4(hi[0].z, hi[0].w, sq4(hi[0].x, hi[0].y, sq[1]));
    }
  }
};
template <> struct Rows<float> {  // f32 rows: hi, mid, lo split here (mma_common.cuh)
  static constexpr int P = 3;
  static constexpr int DIMS = MmaRows<float>::DIMS;
  static constexpr int QSLOTS = 2;
  static __device__ __forceinline__ int swz(int row, int chunk) {
    return MmaRows<float>::swz(row, chunk);
  }
  static __device__ __forceinline__ void load(const char* st, int g, int j, int t,
                                              uint4 (&lo)[3], uint4 (&hi)[3], float* sq,
                                              bool need_sq) {
    MmaRows<float>::load(st, g, j, t, lo, sq[0], need_sq);
    MmaRows<float>::load(st, g + 8, j, t, hi, sq[1], need_sq);
  }
};

struct WArgs {
  const void* data;      // [n_rows, D] f32 or bf16 bits
  const uint16_t* q;     // P parts, each bf16 [Bq, D] (zero past the live queries)
  const float* qn;       // [Bq]: |q|^2 of the f32 query
  const float* bias;     // [n_rows] or null (the fast variant: rows >= hw masked)
  float* out;            // [n_rows / r1, Bc]
  long long hw;
  int D, Bc, Bq, db_tile, r1, metric;
};

// the row ring, QSLOTS slots of the query tile (every part of 16 * nt queries by DIMS
// dimensions) and the tile's |q|^2
template <typename RT>
constexpr int smem_bytes_of(int nt) {
  using R = Rows<RT>;
  return PAIRS * NSTAGE * STAGE + R::QSLOTS * R::P * 16 * nt * R::DIMS * 2 + 16 * nt * 4;
}
static_assert(smem_bytes_of<float>(8) <= SMEM_MAX && smem_bytes_of<uint16_t>(8) <= SMEM_MAX,
              "the 128-query tile does not fit");

template <typename RT, int NT>
__global__ void __launch_bounds__(WARPS * 32, 1) window_mma_kernel(const WArgs a) {
  using R = Rows<RT>;
  constexpr int P = R::P, BN = 16 * NT;  // queries a block owns: NT n-tiles for each warp
  // bytes of one query row of one part in a slot, of one slot, 16-byte chunks of a row
  constexpr int QROW = R::DIMS * 2, SLOT = P * BN * QROW, CPR = QROW / 16;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp >> 1, n0 = (warp & 1) * NT;  // the pair's rows, this warp's n-tiles
  const int g = lane >> 2, t = lane & 3;             // the fragment's group and thread
  const int n_qt = (a.Bq + BN - 1) / BN;
  const long long group = blockIdx.x / n_qt;         // 128 consecutive windows of one tile
  const int q0 = (blockIdx.x % n_qt) * BN;
  const int bn = min(BN, a.Bq - q0);
  const int W = a.db_tile / a.r1, gpt = W / BM;
  // the pair's first row at step r: row0 + r * W
  const long long row0 =
      (group / gpt) * a.db_tile + (group % gpt) * (long long)BM + pair * 16;
  const int kc = a.D / R::DIMS;  // stages per step
  const bool resident = kc <= R::QSLOTS;  // every chunk of the query tile fits
  const bool biased = a.bias != nullptr;
  const bool need_sq = a.metric == COSINE || (a.metric == L2 && !biased);

  char* ring = smem + pair * NSTAGE * STAGE;
  // slot s, part p, row r: qs + s * SLOT + (p * BN + r) * QROW
  char* qs = smem + PAIRS * NSTAGE * STAGE;
  float* qn_s = reinterpret_cast<float*>(qs + R::QSLOTS * SLOT);
  for (int i = threadIdx.x; i < BN; i += blockDim.x) qn_s[i] = i < bn ? a.qn[q0 + i] : 0.f;

  const int total = a.r1 * kc;  // stages of the pair: r1 steps of kc chunks
  // the query chunk of stage z, copied by the whole block (resident: during the first step
  // only, into slot c), zero past the block's queries: row r's 16-byte chunk ch at
  // ch ^ ((r & 1) << 2)
  auto issue_q = [&](int z) {
    if (z >= total || (resident && z >= kc)) return;
    const int c = z % kc;
    char* slot = qs + (resident ? c : z % R::QSLOTS) * SLOT;
    for (int i = threadIdx.x; i < P * BN * CPR; i += blockDim.x) {
      const int pr = i / CPR, ch = i % CPR, p = pr / BN, r = pr % BN;
      cp_async16_or_zero(slot + pr * QROW + (ch ^ ((r & 1) << 2)) * 16,
                         a.q + ((long long)p * a.Bq + q0 + min(r, bn - 1)) * a.D +
                             c * R::DIMS + ch * 8,
                         r < bn);
    }
  };
  auto issue = [&](int z) {
    const int r = z / kc, c = z % kc;
    const char* src = static_cast<const char*>(a.data) +
                      (row0 + (long long)r * W) * a.D * (long long)sizeof(RT) +
                      (long long)c * ROW_BYTES;
    char* st = ring + (z % NSTAGE) * STAGE;
    // the pair's 64 threads share the 16 rows' 16 chunks
    for (int i = (warp & 1) * 32 + lane; i < 16 * (ROW_BYTES / 16); i += 64) {
      const int rr = i / (ROW_BYTES / 16), ch = i % (ROW_BYTES / 16);
      cp_async16(st + rr * ROW_BYTES + R::swz(rr, ch) * 16,
                 src + (long long)rr * a.D * (long long)sizeof(RT) + ch * 16);
    }
  };

  float acc[NT][4], best[NT][4], sq[2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) best[n][e] = __int_as_float(0x7f800000);  // +inf

  // commit groups: rows of stage 0, the query chunk of stage 0, rows of stage 1; then at
  // stage z the query chunk of z + 1 and the rows of z + 2, so that waiting for all but
  // the newest group finds stage z's rows and query chunk in place
  static_assert(NSTAGE == 3, "the commit order below assumes a 3-stage ring");
  issue(0);
  cp_async_commit();
  issue_q(0);
  cp_async_commit();
  if (1 < total) issue(1);
  cp_async_commit();
  for (int z = 0; z < total; ++z) {
    cp_async_wait<1>();
    // every copy of stage z is visible, and the warps have left stage z - 1, whose row
    // buffer is refilled here: the pair's warps wait for each other, and the whole block
    // where stage z's query chunk was just copied (its slot is refilled at z + 1 when the
    // chunks stream)
    if (!resident || z < kc)
      __syncthreads();
    else
      asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1));
    issue_q(z + 1);
    cp_async_commit();
    if (z + 2 < total) issue(z + 2);
    cp_async_commit();
    const int r = z / kc, c = z % kc;
    const char* st = ring + (z % NSTAGE) * STAGE;
    const char* qslot = qs + (resident ? c : z % R::QSLOTS) * SLOT;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      sq[0] = sq[1] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < R::DIMS / 32; ++j) {
      uint4 lo[P], hi[P];
      R::load(st, g, j, t, lo, hi, sq, need_sq);
      // query row (n0 + n) * 8 + g, dimensions c * DIMS + 32j + 8t .. +7: the slot's
      // 16-byte chunk 4j + t, swizzled as the copy stored it (rows g + 8n share g's parity)
      const char* qb = qslot + (n0 * 8 + g) * QROW + ((4 * j + t) ^ ((g & 1) << 2)) * 16;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const char* qn_at = qb + n * 8 * QROW;
        if constexpr (P == 1) {
          mma32(acc[n], lo[0], hi[0], *reinterpret_cast<const uint4*>(qn_at));
        } else {
          // the smaller products first: hi.lo; mid.mid, hi.mid; lo.hi, mid.hi, hi.hi
          const uint4 bl = *reinterpret_cast<const uint4*>(qn_at + 2 * BN * QROW);
          mma32(acc[n], lo[0], hi[0], bl);
          const uint4 bm = *reinterpret_cast<const uint4*>(qn_at + BN * QROW);
          mma32(acc[n], lo[1], hi[1], bm);
          mma32(acc[n], lo[0], hi[0], bm);
          const uint4 bh = *reinterpret_cast<const uint4*>(qn_at);
          mma32(acc[n], lo[2], hi[2], bh);
          mma32(acc[n], lo[1], hi[1], bh);
          mma32(acc[n], lo[0], hi[0], bh);
        }
      }
    }
    if (c != kc - 1) continue;

    // the step's epilogue: element e of n-tile n is row g + 8 * (e >> 1) of the pair,
    // query column (n0 + n) * 8 + 2t + (e & 1); JAX's formulas in JAX's order, unfused
    const long long rg = row0 + (long long)r * W + g;
    float s[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (need_sq) {  // the four threads of a group hold a quarter of the dimensions each
        s[h] = sq[h] + __shfl_xor_sync(0xffffffffu, sq[h], 1);
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      }
      if (biased) bi[h] = a.bias[rg + 8 * h];
      live[h] = biased || rg + 8 * h < a.hw;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float qv = qn_s[(n0 + n) * 8 + 2 * t + (e & 1)];
        const float dot = acc[n][e];
        float d;
        if (a.metric == L2) {
          d = nan_max(__fsub_rn(__fadd_rn(biased ? bi[h] : s[h], qv), __fmul_rn(2.f, dot)), 0.f);
        } else if (a.metric == IP) {
          d = __fsub_rn(1.f, dot);
          if (biased) d = __fadd_rn(d, bi[h]);
        } else {
          d = __fsub_rn(1.f, __fmul_rn(dot, rsqrtf(nan_max(__fmul_rn(s[h], qv), 1e-30f))));
          if (biased) d = __fadd_rn(d, bi[h]);
        }
        if (!live[h]) d = MASKED;  // a dead row is MASKED even when d is NaN (jnp.where)
        best[n][e] = nan_min(best[n][e], d);
      }
  }

  // window group * 128 + 16 * pair + g (+ 8): columns 2t, 2t + 1 of each n-tile
  const long long out_row = group * BM + pair * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = q0 + (n0 + n) * 8 + 2 * t;
    if (col < a.Bc) {  // Bc is even, so col + 1 < Bc too
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(a.out + (out_row + 8 * h) * a.Bc + col) =
            make_float2(best[n][2 * h], best[n][2 * h + 1]);
    }
  }
}

template <typename RT, int NT>
int launch_nt(const WArgs& a, long long n_rows, cudaStream_t stream) {
  constexpr int smem = smem_bytes_of<RT>(NT);
  const long long blocks = n_rows / ((long long)a.r1 * BM) * ((a.Bq + 16 * NT - 1) / (16 * NT));
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = window_mma_kernel<RT, NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The query tile follows the live count: 16 queries for a batch that needs no more, 64
// for one of up to 64, else 128, at any Dp.
template <typename RT>
int launch(const WArgs& a, long long n_rows, cudaStream_t stream) {
  if (a.Bq > 64) return launch_nt<RT, 8>(a, n_rows, stream);
  if (a.Bq > 16) return launch_nt<RT, 4>(a, n_rows, stream);
  return launch_nt<RT, 1>(a, n_rows, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  data: [n_rows, D] of row_type 0 = f32, 1 = bf16
// bits; q: bf16 [P, Bq, D], P = 3 parts (hi, mid, lo) for f32 rows and 1 (the bf16-rounded
// query) for bf16 rows, Bq a multiple of 8, zero past the live queries; qn: f32 [Bq]; bias:
// f32 [n_rows] (the masked variant) or null (the fast one: rows >= hw masked); out: f32
// [n_rows / r1, Bc], Bc even and <= Bq.  metric: 0 = l2, 1 = ip, 2 = cosine.  D % 128 == 0,
// (db_tile / r1) % 128 == 0, n_rows % db_tile == 0.  Returns cudaGetLastError() after the
// launch; 0 means it was accepted.
extern "C" int mlvdb_window_min(const void* data, const void* q, const float* qn,
                                const float* bias, long long hw, float* out, long long n_rows,
                                int D, int Bc, int Bq, int db_tile, int r1, int metric,
                                int row_type, void* stream) {
  if (n_rows <= 0 || D <= 0 || D % KC || Bc <= 0 || Bc % 2 || Bq % 8 || Bc > Bq || r1 <= 0 ||
      db_tile <= 0 || db_tile % r1 || (db_tile / r1) % BM || n_rows % db_tile || metric < 0 ||
      metric > 2)
    return (int)cudaErrorInvalidValue;
  const WArgs a{data, static_cast<const uint16_t*>(q), qn, bias, out, hw, D, Bc, Bq,
                db_tile, r1, metric};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0:
      return launch<float>(a, n_rows, s);
    case 1:
      return launch<uint16_t>(a, n_rows, s);
  }
  return (int)cudaErrorInvalidValue;
}
