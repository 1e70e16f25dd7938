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
// The caller applies the metric formula and the mask (the l2 expansion qn + sqn - 2 dots
// that the certificate's check reasons about).  True f32 FMA, no TF32: the certificate's
// slack assumes an f32 rescan.  The rows are f32 (an f32 store) or bf16 (a
// dtype="bfloat16" store: the same-dtype sweep rescans the store itself, as the JAX
// package reads it, pallas_knn_t.py:1077); bf16 values convert to f32 exactly.
//
// What bounds it: memory.  It reads B*s1*r1*D*4 bytes of scattered f32 rows (268 MB at
// B = 512, s1 = 32, r1 = 32, D = 128; half that as bf16) and computes 4 flops per f32
// byte read.  What the design does about it: one warp per candidate row, 4 elements a
// lane (a 128-element row is one coalesced load of 512 or 256 bytes), the dot and the
// norm from the same registers, then a shuffle reduction; the caller sorts each query's
// windows, so neighbouring warps read neighbouring rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps, 8 candidate rows per block

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

template <typename RT>
__global__ void __launch_bounds__(THREADS)
gather_score_kernel(const float* __restrict__ q, const RT* __restrict__ data,
                    const int* __restrict__ f, float* __restrict__ dots,
                    float* __restrict__ sqn, int s1, int r1, int D, long long n_rows,
                    int n_windows) {
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_rows) return;
  const long long per_q = (long long)s1 * r1;
  const long long b = warp / per_q;
  const int j = (int)(warp - b * per_q);
  int w = f[b * s1 + j / r1];
  w = w < 0 ? 0 : (w >= n_windows ? n_windows - 1 : w);  // clamp, as XLA's gather does
  using Reg = typename Row<RT>::Reg;
  const Reg* rp = reinterpret_cast<const Reg*>(data + ((long long)w * r1 + j % r1) * D);
  const float4* qp = reinterpret_cast<const float4*>(q + b * D);
  float d = 0.f, s = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const float4 x = Row<RT>::cvt(rp[c]), y = qp[c];
    d = fmaf(x.x, y.x, d);
    d = fmaf(x.y, y.y, d);
    d = fmaf(x.z, y.z, d);
    d = fmaf(x.w, y.w, d);
    s = fmaf(x.x, x.x, s);
    s = fmaf(x.y, x.y, s);
    s = fmaf(x.z, x.z, s);
    s = fmaf(x.w, x.w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    dots[warp] = d;
    sqn[warp] = s;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q: f32 [B, D]; data: [n_windows * r1, D] of
// row_type 0 = f32, 1 = bf16 bits; f: int32 [B, s1]; dots, sqn: f32 [B, s1 * r1].  Returns
// cudaGetLastError() after the launch; 0 means it was accepted.
extern "C" int mlvdb_gather_score(const float* q, const void* data, const int* f, float* dots,
                                  float* sqn, int B, int s1, int r1, int D, int n_windows,
                                  int row_type, void* stream) {
  if (B <= 0 || s1 <= 0 || r1 <= 0 || D <= 0 || D % 4 || n_windows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rows = (long long)B * s1 * r1;
  const long long blocks = (n_rows * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (row_type) {
    case 0:
      gather_score_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
          q, static_cast<const float*>(data), f, dots, sqn, s1, r1, D, n_rows, n_windows);
      break;
    case 1:
      gather_score_kernel<uint16_t><<<(unsigned)blocks, THREADS, 0, st>>>(
          q, static_cast<const uint16_t*>(data), f, dots, sqn, s1, r1, D, n_rows, n_windows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
