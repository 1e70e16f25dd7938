// Building blocks shared by the tensor-core kernels (sweep_min.cu, window_min.cu): the
// bf16 mma.sync product, cp.async copies into shared memory, and the loader of a staged
// bf16 row fragment.
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A stage: 16 rows x KC dimensions, 16-byte chunks XOR-swizzled by row so that one
// fragment load of a warp touches every bank once.  load(): the 8 consecutive dimensions
// 32j + 8t .. +7 of row `row` as four bf16x2 registers.
template <typename MT> struct MmaRows;
template <> struct MmaRows<uint16_t> {  // bf16 bits: 256 bytes a row
  static constexpr int ROW_BYTES = KC * 2;
  static __device__ __forceinline__ int swz(int row, int chunk) { return chunk ^ ((row & 1) << 2); }
  static __device__ __forceinline__ uint4 load(const char* st, int row, int j, int t) {
    return *reinterpret_cast<const uint4*>(st + row * ROW_BYTES + swz(row, 4 * j + t) * 16);
  }
};

}  // namespace
