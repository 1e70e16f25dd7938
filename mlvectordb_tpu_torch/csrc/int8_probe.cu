// Probe B7: is the int8 sweep bound by its convert or by its memory traffic?  For Hopper
// (sm_90a).
//
// Replaces two of the three Pallas kernels of benchmarks/probe_int8_mxu.py (kB :67, kC
// :76, launched through mk_call's pallas_call :42); the third, kA (convert the codes and
// take a bf16 x bf16 product with f32 sums), is kernel B3's int8 one-pass route in
// sweep_min.cu, called without scale or bias rows.  All three read the same int8 mirror
// codes [N, D] (row-major) and write, for B queries, one value per window of 32
// consecutive rows, tile-major [N / 4096, B, 128] (window j of tile t = rows
// (t*128 + j)*32 .. +32, lane j), as the sweep kernel does at r1 = 32:
//
//   mma_min     (kB): int8 codes x int8 queries -> int32 dots on the tensor cores
//                     (mma.sync m16n8k32 s8.s8.s32), the min over the window's 32 rows.
//                     A measurement, not a serving route: a query quantized to int8 is
//                     outside the certificate.
//   stream_sum  (kC): the sum of every code of the window (int32), the same for every
//                     query: the codes are streamed and reduced once, the memory floor.
//                     The TPU probe summed one lane of each window, because its DMA
//                     brought the whole block anyway; a GPU load of bytes nothing reads
//                     is never issued, so this floor reads them all.
//
// What bounds them: bytes.  At the probe's shape (N = 2^20, D = 128, B = 128) the codes
// are 134 MB and the output 17 MB, 0.045 ms at 3.35 TB/s; kB's 34 GOP take 0.017 ms at
// the int8 tensor cores' 1,979 TOP/s.
//
// What the design does about it: simple kernels that are right.  mma_min: a block of 8
// warps owns one tile (128 windows) and 64 queries; a warp takes a window at a time, loads
// its A fragments straight from device memory once per 32-deep slice, holds the 64
// queries' accumulators (8 n-tiles x 2 m-tiles) in registers, takes the window min over
// rows in registers and across lanes with shuffles, and leaves it in shared memory; the
// block then writes its [64, 128] result in coalesced rows.  stream_sum: a block owns a
// tile, each warp sums whole windows with 16-byte loads and __dp4a, and the block writes
// the tile's 128 sums to every query's row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;   // rows per tile
constexpr int WIN = 32;      // rows per window
constexpr int WLANE = TILE / WIN;
constexpr int WARPS = 8;
constexpr int QB = 64;       // queries per mma_min block (8 n-tiles of 8)

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(WARPS * 32)
mma_min_kernel(const int8_t* __restrict__ codes, const int8_t* __restrict__ q,
               int* __restrict__ out, int D, int B, int n_qtiles) {
  __shared__ int res[QB][WLANE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // the fragment's group and thread-in-group
  const long long tile = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * QB;

  for (int w = warp; w < WLANE; w += WARPS) {
    const int8_t* rows = codes + (tile * TILE + (long long)w * WIN) * D;
    int acc[8][2][4];  // [n-tile][m-tile][fragment]
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][mt][i] = 0;
    for (int k0 = 0; k0 < D; k0 += 32) {
      // A (16 x 32, row-major) of m-tile mt: registers {row g, row g+8} x {cols 4t, 16+4t}
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* r0 = rows + (long long)(mt * 16 + g) * D + k0 + 4 * t;
        const int8_t* r8 = r0 + 8LL * D;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // B (32 x 8, column-major = query rows): query g, depth {4t, 16+4t}
        const int8_t* qr = q + (long long)(q0 + n * 8 + g) * D + k0 + 4 * t;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(qr),
                               *reinterpret_cast<const uint32_t*>(qr + 16)};
        mma_s8(acc[n][0], a[0], b);
        mma_s8(acc[n][1], a[1], b);
      }
    }
    // fragment i of m-tile mt holds row mt*16 + g (+8 for i >= 2), query 2t + (i & 1)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int v = min(min(acc[n][0][c], acc[n][0][c + 2]), min(acc[n][1][c], acc[n][1][c + 2]));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (g == 0) res[n * 8 + 2 * t + c][w] = v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QB * WLANE; i += WARPS * 32) {
    const int b = i / WLANE, j = i % WLANE;
    out[(tile * B + q0 + b) * WLANE + j] = res[b][j];
  }
}

__global__ void __launch_bounds__(WARPS * 32)
stream_sum_kernel(const int8_t* __restrict__ codes, int* __restrict__ out, int D, int B) {
  __shared__ int sums[WLANE];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long tile = blockIdx.x;
  const int chunks = WIN * D / 16;  // 16-byte loads per window
  for (int w = warp; w < WLANE; w += WARPS) {
    const uint4* src = reinterpret_cast<const uint4*>(codes + (tile * TILE + (long long)w * WIN) * D);
    int s = 0;
    for (int i = lane; i < chunks; i += 32) {
      const uint4 u = src[i];
      s = __dp4a((int)u.x, 0x01010101, s);  // the sum of four signed bytes
      s = __dp4a((int)u.y, 0x01010101, s);
      s = __dp4a((int)u.z, 0x01010101, s);
      s = __dp4a((int)u.w, 0x01010101, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) sums[w] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * WLANE; i += WARPS * 32)
    out[(tile * B + i / WLANE) * WLANE + i % WLANE] = sums[i % WLANE];
}

}  // namespace

// Plain C entry points (bound with ctypes).  codes: int8 [N, D]; q: int8 [B, D]; out: int32
// [N / 4096, B, 128].  mma_min needs B % 64 == 0 and D % 32 == 0; stream_sum D % 16 == 0;
// both N % 4096 == 0.  Each returns cudaGetLastError() after the launch; 0 means it was
// accepted.
extern "C" int mlvdb_int8_mma_min(const int8_t* codes, const int8_t* q, int* out, long long n,
                                  int D, int B, void* stream) {
  if (n <= 0 || n % TILE || D <= 0 || D % 32 || B <= 0 || B % QB)
    return (int)cudaErrorInvalidValue;
  const long long blocks = n / TILE * (B / QB);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mma_min_kernel<<<(unsigned)blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, q, out, D, B, B / QB);
  return (int)cudaGetLastError();
}

extern "C" int mlvdb_int8_stream_sum(const int8_t* codes, int* out, long long n, int D, int B,
                                     void* stream) {
  if (n <= 0 || n % TILE || D <= 0 || D % 16 || B <= 0) return (int)cudaErrorInvalidValue;
  if (n / TILE > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stream_sum_kernel<<<(unsigned)(n / TILE), WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, out, D, B);
  return (int)cudaGetLastError();
}
