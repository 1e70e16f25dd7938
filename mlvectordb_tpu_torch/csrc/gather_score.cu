// Gather-and-score of candidate windows: the exact f32 rescan of the certified sweep, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel mlvectordb_tpu/ops/pallas_gather.py:_kernel (launched by
// gather_score), which the JAX package parked and whose product path is the XLA
// _rescan_windows._score (pallas_knn_t.py:805-830).  For queries q [B, D] f32, rows
// data [cap, D] and candidate windows f [B, s1] (window w = rows [w*r1, (w+1)*r1)):
//
//   dots[b, j*r1 + i] = q[b] . data[f[b, j]*r1 + i],   sqn[b, j*r1 + i] = ||that row||^2
//
// for the first B query rows (the caller's live queries and the first padded row); rows
// [B, n_out) of the outputs, the rest of the caller's zero padding, get row B - 1's outputs
// from the CTAs that compute it.  Window ids are clamped to
// [0, cap/r1), as XLA's gather clamps them.  The caller applies the metric formula and the
// mask (the l2 expansion qn + sqn - 2 dots that the certificate's check reasons about).
// True f32 FMA, no TF32: the certificate's slack assumes an f32 rescan.  The rows are f32
// (an f32 store) or bf16 (a dtype="bfloat16" store: the same-dtype sweep rescans the store
// itself, as the JAX package reads it, pallas_knn_t.py:1077); bf16 values widen to f32
// exactly, by a 16-bit shift.
//
// What bounds it on an H100: memory.  Each candidate row is read once and used for one
// query, so the product is a matrix-vector product at 1 flop per f32 byte (2 per bf16
// byte), far under the card's ridge point (~20 f32 FMA flops or ~295 bf16 tensor-core
// flops per HBM byte); tensor cores would not move the bound, and the certificate needs an
// f32 rescan.  At the engine's k = 10 operands (129 computed queries x 32 windows x 32
// rows, D = 128) the kernel must read 68 MB of f32 rows (0.020 ms at 3.35 TB/s) or 35 MB
// of bf16 rows (0.010 ms): some tens of KB in flight on every SM.
//
// What the design does about it: deep loads.  A half-warp owns 4 candidate rows at a time
// and reads 256 bytes of each per 16-byte ld.global.nc a lane, a piece of each of the 4
// rows issued before their FMAs (a warp keeps 2 KB in flight; two pieces a row, 4 KB,
// took more registers and measured slower).  A CTA scores 64 consecutive candidate rows
// of one query at a time; the grid (what fits on the card) strides over these groups and
// loads the next group's window ids while this group's rows are in flight.  Row B - 1's
// groups come first, one to a CTA that takes no other, so that their copies to the padded
// rows overlap the other groups' loads rather than trail them.  The query's
// matching 4 (f32) or 8 (bf16) dimensions come from the L1 cache into registers, and the
// dot and the norm use the same row registers.  One shuffle tree sums all of a
// half-warp's values at once (each step halves the values a lane holds): 8 shuffles for
// 4 f32 rows, 16 for 4 bf16 rows (their sums kept in the order below).
//
// The bulk-copy ring (probes/gather_bulk_ring.cu: whole windows streamed into shared
// memory by cp.async.bulk from a producer warp, guarded by mbarriers) computes the same
// and was slower at every operand timed; probes/gather_variants.py times the two.
//
// Every row's sum order depends only on D and the row type, never on which group, lane or
// CTA held it (float addition commutes), so a launch over fewer queries gives the same bits,
// and they are the earlier one-warp-a-row kernel's bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HALVES = THREADS / 16;   // half-warps: the compute unit
constexpr int PIECE = 256;             // bytes of a row one half-warp reads per load

__device__ __forceinline__ uint4 ldg_stream(const void* p) {   // read once: no L1 line
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The order of the sums.  Each row's dot and norm are summed as the earlier kernel of this
// file summed them (one warp a row, lane L taking 4-element chunks L, L + 32, ... of the
// row in turn, then an xor tree over lanes 16, 8, 4, 2, 1), so its results are those bits
// and the engine's answers do not move: an f32 rescan cannot separate two candidates whose
// distances lie within its rounding, and which one it keeps should not change with the
// kernel.  Here lane l of a half-warp reads 16 bytes of each 256-byte piece k of a row:
//  - f32 rows: chunk 16k + l, old lane l + 16 (k & 1): two accumulators, pieces of even
//    and of odd k, added first (the tree's step 16), then the tree over l (8, 4, 2, 1);
//  - bf16 rows: chunks 32k + 2l and 32k + 2l + 1, old lanes 2l and 2l + 1: two
//    accumulators, the first and the second 4 elements, each through the tree over l (the
//    old steps 16, 8, 4, 2), then added (the old step 1).
// acc holds a row's (dot, norm) x the two accumulators; feed<P>() adds 16 bytes of a piece
// of parity P.
template <typename RT> struct Row;
template <> struct Row<float> {
  static constexpr int ELEM = 4;
  template <int P>
  static __device__ __forceinline__ void feed(uint4 u, const float* __restrict__ q,
                                              float (&acc)[2][2]) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(q));
    const float x[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                        __uint_as_float(u.w)};
    const float yy[4] = {y.x, y.y, y.z, y.w};
    float& d = acc[0][P];
    float& s = acc[1][P];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d = fmaf(x[e], yy[e], d);
      s = fmaf(x[e], x[e], s);
    }
  }
};
template <> struct Row<uint16_t> {  // bf16 bits: the high half of an f32
  static constexpr int ELEM = 2;
  template <int P>
  static __device__ __forceinline__ void feed(uint4 u, const float* __restrict__ q,
                                              float (&acc)[2][2]) {
    const float4 y0 = __ldg(reinterpret_cast<const float4*>(q));
    const float4 y1 = __ldg(reinterpret_cast<const float4*>(q) + 1);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    const float yy[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // words 0-1: accumulator 0, words 2-3: accumulator 1
      const float lo = __uint_as_float(w[e] << 16), hi = __uint_as_float(w[e] & 0xffff0000u);
      float& d = acc[0][e >> 1];
      float& s = acc[1][e >> 1];
      d = fmaf(lo, yy[2 * e], d);
      s = fmaf(lo, lo, s);
      d = fmaf(hi, yy[2 * e + 1], d);
      s = fmaf(hi, hi, s);
    }
  }
};

// Sums each of NV values over a half-warp's 16 lanes by an xor tree over lane offsets O =
// 8, 4, 2, 1: at each step a lane keeps the half of its values that its offset bit selects
// and adds its partner's copy of that half (the same pairs as the plain tree, whose every
// lane ends with the same bits: addition commutes); once one value is left, the remaining
// steps add it plainly.  Afterwards lane l holds the sum of value l >> (4 - log2 NV).
template <int NV, int O = 8>
__device__ __forceinline__ float half_warp_sums(float* v, int l16) {
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (NV == 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return half_warp_sums<1, O / 2>(v, l16);
  } else {
    const bool up = l16 & O;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) {
      const float keep = up ? v[NV / 2 + i] : v[i], send = up ? v[i] : v[NV / 2 + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return half_warp_sums<NV / 2, O / 2>(v, l16);
  }
}

constexpr int RH = 4;                  // rows a half-warp owns at a time
constexpr int GROUP = HALVES * RH;     // consecutive candidate rows of one query a CTA scores

// A half-warp's RH rows' sums, in the order above: afterwards lanes 4m + 2t and 4m + 2t + 1
// hold row m's dot (t = 0) or norm (t = 1).
__device__ __forceinline__ float reduce_rows(float (&acc)[RH][2][2], int l16, float) {
  float v[8];   // f32: value 2m + t = the even and odd pieces' sums added
#pragma unroll
  for (int m = 0; m < RH; ++m)
#pragma unroll
    for (int t = 0; t < 2; ++t) v[2 * m + t] = acc[m][t][0] + acc[m][t][1];
  return half_warp_sums<8>(v, l16);
}
__device__ __forceinline__ float reduce_rows(float (&acc)[RH][2][2], int l16, uint16_t) {
  float v[16];   // bf16: value 4m + 2t + a = accumulator a through the tree, then added
#pragma unroll
  for (int m = 0; m < RH; ++m)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int a = 0; a < 2; ++a) v[4 * m + 2 * t + a] = acc[m][t][a];
  const float x = half_warp_sums<16>(v, l16);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <typename RT>
__global__ void __launch_bounds__(THREADS)
gather_score_kernel(const float* __restrict__ q, const char* __restrict__ data,
                    const int* __restrict__ f, float* __restrict__ dots,
                    float* __restrict__ sqn, int B, int n_out, int s1, int r1, int D,
                    int n_windows) {
  constexpr int E = Row<RT>::ELEM;
  const int per_q = s1 * r1, row_bytes = D * E, pieces = row_bytes / PIECE;
  const int groups = (per_q + GROUP - 1) / GROUP;
  const long long n_groups = (long long)B * groups;
  const int h = threadIdx.x >> 4, l16 = threadIdx.x & 15;

  // this half-warp's rows of group u: query b (row B - 1 first, then 0, 1, ...), candidate
  // rows c0 .. c0 + RH - 1 (those past the query's last read its last row and are never
  // written) and their windows
  auto rows_of = [&](long long u, int& b, int& c0, int* w) {
    const int bu = (int)(u / groups);
    b = bu == 0 ? B - 1 : bu - 1;
    c0 = (int)(u - (long long)bu * groups) * GROUP + h * RH;
#pragma unroll
    for (int m = 0; m < RH; ++m) {
      const int wi = __ldg(f + (long long)b * s1 + min(c0 + m, per_q - 1) / r1);
      w[m] = wi < 0 ? 0 : (wi >= n_windows ? n_windows - 1 : wi);  // as XLA's gather clamps
    }
  };

  // Where row B - 1 has copies to write and the grid has room, CTAs [0, groups) take one
  // group of it each and nothing else, and the rest stride over the other groups: a CTA
  // that writes n_out - B copies of its rows does not also take a share of the others.
  const long long lo = (n_out > B && gridDim.x > groups) ? groups : 0;
  const long long step = blockIdx.x < lo ? n_groups : gridDim.x - lo;
  long long u = blockIdx.x;
  int b = 0, c0 = 0, w[RH] = {};
  if (u < n_groups) rows_of(u, b, c0, w);
  for (; u < n_groups; u += step) {
    const char* rp[RH];
#pragma unroll
    for (int m = 0; m < RH; ++m)
      rp[m] = data + ((long long)w[m] * r1 + min(c0 + m, per_q - 1) % r1) * row_bytes +
              l16 * 16;
    const float* qb = q + (long long)b * D + l16 * (16 / E);
    float acc[RH][2][2] = {};
    int nb = 0, nc0 = 0, nw[RH] = {};
    for (int k = 0; k < pieces; k += 2) {   // a piece of even k, then one of odd k
      uint4 x[RH];
#pragma unroll
      for (int m = 0; m < RH; ++m) x[m] = ldg_stream(rp[m] + k * PIECE);
      if (k == 0 && u + step < n_groups) rows_of(u + step, nb, nc0, nw);
#pragma unroll
      for (int m = 0; m < RH; ++m)
        Row<RT>::template feed<0>(x[m], qb + k * (PIECE / E), acc[m]);
      if (k + 1 < pieces) {
#pragma unroll
        for (int m = 0; m < RH; ++m) x[m] = ldg_stream(rp[m] + (k + 1) * PIECE);
#pragma unroll
        for (int m = 0; m < RH; ++m)
          Row<RT>::template feed<1>(x[m], qb + (k + 1) * (PIECE / E), acc[m]);
      }
    }
    const float sum = reduce_rows(acc, l16, RT());
    const int c = c0 + (l16 >> 2);
    if ((l16 & 1) == 0 && c < per_q) {
      float* out = ((l16 & 2) ? sqn : dots) + c;
      out[(long long)b * per_q] = sum;
      if (b == B - 1)   // the padded rows past the first: its copies
#pragma unroll 1   // unrolled, the loop cost the f32 kernel 38 registers
        for (int r = B; r < n_out; ++r) out[(long long)r * per_q] = sum;
    }
    b = nb;
    c0 = nc0;
#pragma unroll
    for (int m = 0; m < RH; ++m) w[m] = nw[m];
  }
}

template <typename RT>
int launch(const float* q, const void* data, const int* f, float* dots, float* sqn, int B,
           int n_out, int s1, int r1, int D, int n_windows, cudaStream_t st) {
  auto kernel = gather_score_kernel<RT>;
  static int resident = 0;   // CTAs the card holds at once (SMs x CTAs per SM), once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_groups = (long long)B * ((s1 * r1 + GROUP - 1) / GROUP);
  const unsigned grid = (unsigned)(n_groups < resident ? n_groups : resident);
  kernel<<<grid, THREADS, 0, st>>>(q, static_cast<const char*>(data), f, dots, sqn, B, n_out,
                                   s1, r1, D, n_windows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q: f32 [>= B, D]; data: [n_windows * r1, D] of
// row_type 0 = f32, 1 = bf16 bits, a row a multiple of 256 bytes (D % 64 for f32, D % 128
// for bf16), q and data 16-byte aligned; f: int32 [>= B, s1]; dots, sqn: f32
// [>= n_out, s1 * r1] with n_out >= B: rows [0, B) are computed and rows [B, n_out) copy
// row B - 1.  Returns cudaGetLastError() after the launch; 0 means it was accepted.
extern "C" int mlvdb_gather_score(const float* q, const void* data, const int* f, float* dots,
                                  float* sqn, int B, int n_out, int s1, int r1, int D,
                                  int n_windows, int row_type, void* stream) {
  if (row_type != 0 && row_type != 1) return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)D * (row_type == 0 ? 4 : 2);
  if (B <= 0 || n_out < B || s1 <= 0 || r1 <= 0 || D <= 0 || n_windows <= 0 ||
      (long long)s1 * r1 > (1 << 30) || row_bytes % PIECE || row_bytes > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(data) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return row_type == 0
             ? launch<float>(q, data, f, dots, sqn, B, n_out, s1, r1, D, n_windows, st)
             : launch<uint16_t>(q, data, f, dots, sqn, B, n_out, s1, r1, D, n_windows, st);
}
