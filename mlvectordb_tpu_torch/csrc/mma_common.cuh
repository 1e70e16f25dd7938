// Building blocks shared by the tensor-core kernels (sweep_min.cu, window_min.cu): the
// bf16 mma.sync product, cp.async copies into shared memory, the loaders of a staged row
// fragment, and the three-way bf16 split of f32 values.
#pragma once

#include <stdint.h>

namespace {

constexpr int KC = 128;  // bf16 dimensions of one staged row (256 bytes)

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// one product of a 16-row fragment (lo: row g, hi: row g + 8) with an 8-query fragment b,
// over the 32 dimensions the three register pairs hold
__device__ __forceinline__ void mma32(float* c, const uint4& lo, const uint4& hi, const uint4& b) {
  mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mma_bf16(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// cp_async16, with zeros written instead where !valid (src-size 0: gmem is not read)
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the low and high bf16 of a bf16x2 register, as f32 (exact)
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// x0 and x1 rounded to nearest bf16, packed with x0 in the low half
__device__ __forceinline__ uint32_t pack_rn(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// (x0, x1) -> hi, mid, lo bf16x2 registers with hi + mid + lo == x element by element:
// hi = bf16_rn(x), mid = bf16_rn(x - hi), lo = bf16(x - hi - mid); the remainders are
// exact in f32, and the sum is x for |x| from 2^-110 to bf16's largest finite value
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  h = pack_rn(x0, x1);
  const float r0 = __fsub_rn(x0, bf_lo(h)), r1 = __fsub_rn(x1, bf_hi(h));  // exact
  m = pack_rn(r0, r1);
  l = pack_rn(__fsub_rn(r0, bf_lo(m)), __fsub_rn(r1, bf_hi(m)));
}

// A stage: 16 rows x DIMS dimensions (256 bytes of each row), 16-byte chunks XOR-swizzled
// by row so that one fragment load of a warp touches every bank once.  load(): the 8
// consecutive dimensions 32j + 8t .. +7 of row `row` as four bf16x2 registers (an f32 row:
// as its hi, mid and lo parts, four registers each).
template <typename MT> struct MmaRows;
template <> struct MmaRows<uint16_t> {  // bf16 bits: 256 bytes a row
  static constexpr int ROW_BYTES = KC * 2;
  static constexpr int DIMS = KC;
  static __device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ ((row & 1) << 2); }
  static __device__ __forceinline__ uint4 load(const char* st, int row, int j, int t) {
    return *reinterpret_cast<const uint4*>(st + row * ROW_BYTES + swz(row, 4 * j + t) * 16);
  }
};
template <> struct MmaRows<float> {  // f32: 64 dimensions, 256 bytes a row, split here
  static constexpr int ROW_BYTES = 256;
  static constexpr int DIMS = ROW_BYTES / 4;
  // 16-byte chunk c of row r at c ^ (r & 1): rows g and g + 1 of a load phase hit
  // different banks
  static __device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ (row & 1); }
  // p[0], p[1], p[2]: the hi, mid and lo parts; with `need_sq` the squares of the f32
  // values are added to sq
  static __device__ __forceinline__ void load(const char* st, int row, int j, int t, uint4* p,
                                              float& sq, bool need_sq) {
    const float4 a = *reinterpret_cast<const float4*>(st + row * ROW_BYTES +
                                                      swz(row, 8 * j + 2 * t) * 16);
    const float4 b = *reinterpret_cast<const float4*>(st + row * ROW_BYTES +
                                                      swz(row, 8 * j + 2 * t + 1) * 16);
    if (need_sq) {
      sq = fmaf(a.x, a.x, sq);
      sq = fmaf(a.y, a.y, sq);
      sq = fmaf(a.z, a.z, sq);
      sq = fmaf(a.w, a.w, sq);
      sq = fmaf(b.x, b.x, sq);
      sq = fmaf(b.y, b.y, sq);
      sq = fmaf(b.z, b.z, sq);
      sq = fmaf(b.w, b.w, sq);
    }
    split3(a.x, a.y, p[0].x, p[1].x, p[2].x);
    split3(a.z, a.w, p[0].y, p[1].y, p[2].y);
    split3(b.x, b.y, p[0].z, p[1].z, p[2].z);
    split3(b.z, b.w, p[0].w, p[1].w, p[2].w);
  }
};

}  // namespace
