// A bulk-copy ring form of the rescan kernel B2 (csrc/gather_score.cu), for comparison
// only: probes/gather_variants.py builds it beside the kernel and times both on the same
// operands.  Same function and C entry (mlvdb_gather_score), for a launch with no padded
// rows (n_out == B).
//
// Each window is r1 consecutive rows, one contiguous run of r1 * D * elem bytes.  A ring
// slot ("stage", 8 KB) holds a run of whole rows of one query's candidates (at most 32),
// or, for a row wider than a slot, one slice of one row.  A producer warp fills the slots
// with Hopper's bulk asynchronous copy (cp.async.bulk, a 1-D TMA: no tensor map), one copy
// per window fragment, completing on the slot's "full" mbarrier; it holds the CTA's window
// ids in registers one chunk ahead and refills a slot once its "empty" mbarrier says the 8
// consumer warps are done with it.  A CTA keeps 4 slots in flight and walks a contiguous
// range of the launch's stages (the grid is what fits on the card).  The consumers read a
// slot with 16-byte shared loads, a half-warp 256 bytes of a row per load against the
// query's matching dimensions in registers; a half-warp owns one or two rows of a stage,
// or, for wide rows, a share of one row's 256-byte pieces that shared memory then sums.
// On the card it ran slower than the deep-load kernel at every operand timed (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HALVES = THREADS / 16;   // half-warps: the compute unit
constexpr int STAGE_BYTES = 8192;      // one ring slot
constexpr int NSTAGE = 4;              // ring depth
constexpr int PIECE = 256;             // bytes of a row one half-warp reads per load
#ifdef RING_NO_COPIES   // the ring's synchronisation alone: barriers complete with no bytes
constexpr bool COPIES = false;
#else
constexpr bool COPIES = true;
#endif

// 16 bytes of one row, as f32: the only code that differs by row type
template <typename RT> struct Row;
template <> struct Row<float> {
  static constexpr int ELEM = 4;
  template <typename F>
  static __device__ __forceinline__ void fma(uint4 u, const float* __restrict__ q, F&& acc) {
    const float4 y = __ldg(reinterpret_cast<const float4*>(q));
    acc(__uint_as_float(u.x), y.x);
    acc(__uint_as_float(u.y), y.y);
    acc(__uint_as_float(u.z), y.z);
    acc(__uint_as_float(u.w), y.w);
  }
};
template <> struct Row<uint16_t> {  // bf16 bits: the high half of an f32
  static constexpr int ELEM = 2;
  template <typename F>
  static __device__ __forceinline__ void fma(uint4 u, const float* __restrict__ q, F&& acc) {
    const float4 y0 = __ldg(reinterpret_cast<const float4*>(q));
    const float4 y1 = __ldg(reinterpret_cast<const float4*>(q) + 1);
    acc(__uint_as_float(u.x << 16), y0.x);
    acc(__uint_as_float(u.x & 0xffff0000u), y0.y);
    acc(__uint_as_float(u.y << 16), y0.z);
    acc(__uint_as_float(u.y & 0xffff0000u), y0.w);
    acc(__uint_as_float(u.z << 16), y1.x);
    acc(__uint_as_float(u.z & 0xffff0000u), y1.y);
    acc(__uint_as_float(u.w << 16), y1.z);
    acc(__uint_as_float(u.w & 0xffff0000u), y1.w);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global into shared
// memory, completing on the mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// How a launch cuts its work; the same for every row, so it fixes each row's order of sums.
struct Plan {
  int row_bytes;     // D * elem, a multiple of PIECE
  int slice_bytes;   // min(row_bytes, STAGE_BYTES): the part of a row one stage holds
  int n_slices;      // stages per row group (1 unless a row is wider than a slot)
  int rows;          // rows a stage holds: a power of two up to 2 a half-warp, 1 when sliced
  int groups;        // half-warps sharing one row (rows < HALVES), else 1
  int per_q;         // s1 * r1 candidate rows per query
  int q_groups;      // stages' row groups per query: ceil(per_q / rows)
};

// Where stage t of the launch reads: query b, candidate rows [c_lo, c_hi), slice si.
// A CTA decodes its first stage and steps to the next (no division in the loop).
struct Stage {
  int b, c_lo, c_hi, si;
  __device__ __forceinline__ Stage(long long t, const Plan& p) {
    const long long per_b = (long long)p.q_groups * p.n_slices;
    b = (int)(t / per_b);
    const int rem = (int)(t - b * per_b);
    const int gi = rem / p.n_slices;
    si = rem - gi * p.n_slices;
    c_lo = gi * p.rows;
    c_hi = min(c_lo + p.rows, p.per_q);
  }
  __device__ __forceinline__ void next(const Plan& p) {
    if (++si < p.n_slices) return;
    si = 0;
    c_lo += p.rows;
    if (c_lo >= p.per_q) {
      c_lo = 0;
      ++b;
    }
    c_hi = min(c_lo + p.rows, p.per_q);
  }
  __device__ __forceinline__ int slice_len(const Plan& p) const {
    return min(p.slice_bytes, p.row_bytes - si * p.slice_bytes);
  }
};

// The reduction of RH rows' (dot, norm) over a half-warp's 16 lanes.  Afterwards lane
// 8m + 4v (RH = 2) or 8v (RH = 1) holds row m's value v (0: dot, 1: norm).
template <int RH> struct Reduce;
template <> struct Reduce<1> {
  static __device__ __forceinline__ float run(const float* d, const float* s, int l16) {
    const bool hi = l16 & 8;
    float keep = hi ? s[0] : d[0];
    keep += __shfl_xor_sync(0xffffffffu, hi ? d[0] : s[0], 8);
    keep += __shfl_xor_sync(0xffffffffu, keep, 4);
    keep += __shfl_xor_sync(0xffffffffu, keep, 2);
    keep += __shfl_xor_sync(0xffffffffu, keep, 1);
    return keep;
  }
  static __device__ __forceinline__ bool owner(int l16) { return (l16 & 7) == 0; }
  static __device__ __forceinline__ int row(int) { return 0; }
  static __device__ __forceinline__ int value(int l16) { return l16 >> 3; }
};
template <> struct Reduce<2> {
  static __device__ __forceinline__ float run(const float* d, const float* s, int l16) {
    const bool b3 = l16 & 8, b2 = l16 & 4;
    float kd = b3 ? d[1] : d[0], ks = b3 ? s[1] : s[0];
    kd += __shfl_xor_sync(0xffffffffu, b3 ? d[0] : d[1], 8);
    ks += __shfl_xor_sync(0xffffffffu, b3 ? s[0] : s[1], 8);
    float keep = b2 ? ks : kd;
    keep += __shfl_xor_sync(0xffffffffu, b2 ? kd : ks, 4);
    keep += __shfl_xor_sync(0xffffffffu, keep, 2);
    keep += __shfl_xor_sync(0xffffffffu, keep, 1);
    return keep;
  }
  static __device__ __forceinline__ bool owner(int l16) { return (l16 & 3) == 0; }
  static __device__ __forceinline__ int row(int l16) { return l16 >> 3; }
  static __device__ __forceinline__ int value(int l16) { return (l16 >> 2) & 1; }
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the consumers' barrier (named barrier 1: the producer warp takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// RH: rows each half-warp owns in a stage (rows / HALVES when rows >= HALVES, else 1).
// Threads [0, THREADS) consume; the warp after them produces.
template <typename RT, int RH>
__global__ void __launch_bounds__(THREADS + 32)
gather_score_kernel(const float* __restrict__ q, const char* __restrict__ data,
                    const int* __restrict__ f, float* __restrict__ dots,
                    float* __restrict__ sqn, Plan p, int s1, int r1, int D, int n_windows,
                    long long n_units) {
  extern __shared__ __align__(128) char ring[];   // NSTAGE slots of STAGE_BYTES
  __shared__ __align__(8) uint64_t full[NSTAGE], empty[NSTAGE];
  __shared__ float red[2][HALVES][2];   // per-half partials of shared rows, double-buffered

  // this CTA's stages: whole row groups (a row's slices stay in one CTA)
  const long long t0 = n_units * blockIdx.x / gridDim.x * p.n_slices;
  const long long t1 = n_units * (blockIdx.x + 1) / gridDim.x * p.n_slices;
  const int tid = threadIdx.x;
  constexpr int E = Row<RT>::ELEM;

  if (tid == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrive, plus the bytes
      mbar_init(&empty[s], THREADS / 32);     // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= THREADS) {
    // the producer warp: for each stage, once its slot is free, each lane copies one
    // window fragment of the stage's rows (a stage holds at most 32 rows, so 32 windows).
    // The CTA's window ids are one contiguous run of f [B, s1]; the warp holds 64 of them
    // in registers (lane i: entries base + i and base + 32 + i), loaded one chunk ahead,
    // so no copy waits on a load of f.
    const int lane = tid - THREADS;
    const long long n_f = (long long)(t1 > t0 ? Stage(t1 - 1, p).b + 1 : 0) * s1;
    auto load_f = [&](long long i) { return i < n_f ? __ldg(f + i) : 0; };
    long long base = t0 < t1 ? (long long)Stage(t0, p).b * s1 + Stage(t0, p).c_lo / r1 : 0;
    int f_cur = load_f(base + lane), f_nxt = load_f(base + 32 + lane);
    Stage st(t0, p);
    for (int n = 0; t0 + n < t1; ++n, st.next(p)) {
      const int slot_i = n % NSTAGE;
      const int j_lo = st.c_lo / r1, j = j_lo + lane;
      const long long first = (long long)st.b * s1 + j_lo;   // the stage's first window id
      while (first - base >= 32) {             // (stages move forward through f)
        base += 32;
        f_cur = f_nxt;
        f_nxt = load_f(base + 32 + lane);
      }
      const int at = (int)(first - base) + lane;   // < 64: a stage spans <= 32 windows
      const int from_cur = __shfl_sync(0xffffffffu, f_cur, at & 31);
      const int from_nxt = __shfl_sync(0xffffffffu, f_nxt, at & 31);
      int w = at < 32 ? from_cur : from_nxt;
      w = w < 0 ? 0 : (w >= n_windows ? n_windows - 1 : w);  // clamp, as XLA's gather does
      if (n >= NSTAGE) mbar_wait(&empty[slot_i], (uint32_t)((n / NSTAGE - 1) & 1));
      const int len = st.slice_len(p);
      if (lane == 0)
        mbar_expect(&full[slot_i], COPIES ? (uint32_t)((st.c_hi - st.c_lo) * len) : 0u);
      __syncwarp();
      const int c = max(st.c_lo, j * r1), c_end = min(st.c_hi, (j + 1) * r1);
      if (COPIES && c < c_end) {              // rows [c, c_end) of window j
        const char* src = data + ((long long)w * r1 + (c - j * r1)) * p.row_bytes +
                          (long long)st.si * p.slice_bytes;
        bulk_copy(ring + slot_i * STAGE_BYTES + (c - st.c_lo) * p.slice_bytes, src,
                  (uint32_t)((c_end - c) * len), &full[slot_i]);
      }
    }
    return;
  }

  // this half-warp's rows of a stage: r = h*RH + m, or row h / groups, piece share h % groups
  const int h = tid >> 4, l16 = tid & 15;
  const int g = p.groups > 1 ? h % p.groups : 0;
  const int r0 = p.groups > 1 ? h / p.groups : h * RH;
  float d[RH] = {}, s[RH] = {};
  int shared_rows = 0;   // reductions through red so far: its buffer alternates with them
  Stage st(t0, p);
  for (int n = 0; t0 + n < t1; ++n, st.next(p)) {
    const int slot_i = n % NSTAGE;
    const char* slot = ring + slot_i * STAGE_BYTES;
    mbar_wait(&full[slot_i], (uint32_t)((n / NSTAGE) & 1));
    if (st.si == 0) {
#pragma unroll
      for (int m = 0; m < RH; ++m) d[m] = s[m] = 0.f;
    }
    const int len = st.slice_len(p);
    const float* qb = q + (long long)st.b * D + (st.si * p.slice_bytes) / E + l16 * (16 / E);
    for (int k = g; k * PIECE < len; k += p.groups) {
      const float* qk = qb + k * (PIECE / E);
#pragma unroll
      for (int m = 0; m < RH; ++m) {
        // rows past c_hi read stale slot bytes; their sums are never written
        const uint4 u = *reinterpret_cast<const uint4*>(slot + (r0 + m) * p.slice_bytes +
                                                        k * PIECE + l16 * 16);
        float dm = d[m], sm = s[m];
        Row<RT>::fma(u, qk, [&](float x, float y) {
          dm = fmaf(x, y, dm);
          sm = fmaf(x, x, sm);
        });
        d[m] = dm;
        s[m] = sm;
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[slot_i]);   // this warp is done with the slot
    if (st.si != p.n_slices - 1) continue;              // the row goes on in the next stage
    const float v = Reduce<RH>::run(d, s, l16);
    const int val = Reduce<RH>::value(l16);
    if (p.groups == 1) {
      const int c = st.c_lo + r0 + Reduce<RH>::row(l16);
      if (Reduce<RH>::owner(l16) && c < st.c_hi)
        (val ? sqn : dots)[(long long)st.b * p.per_q + c] = v;
      continue;
    }
    // two buffers: a thread writes a buffer again only past the barrier of the use in
    // between, which a summing thread reaches only after it read the buffer's last use
    const int buf = shared_rows++ & 1;
    if (Reduce<RH>::owner(l16)) red[buf][h][val] = v;
    consumers_sync();   // the partials of this stage's rows are written
    if (tid < 2 * p.rows) {
      const int r = tid >> 1, c = st.c_lo + r;
      float sum = 0.f;
      for (int gg = 0; gg < p.groups; ++gg) sum += red[buf][r * p.groups + gg][tid & 1];
      if (c < st.c_hi) ((tid & 1) ? sqn : dots)[(long long)st.b * p.per_q + c] = sum;
    }
  }
}

template <typename RT, int RH>
int launch(const float* q, const void* data, const int* f, float* dots, float* sqn, int B,
           int s1, int r1, int D, int n_windows, const Plan& p, cudaStream_t st) {
  auto kernel = gather_score_kernel<RT, RH>;
  constexpr int SMEM = NSTAGE * STAGE_BYTES;
  static int resident = 0;   // CTAs the card holds at once (SMs x CTAs per SM), once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS + 32, SMEM);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long n_units = (long long)B * p.q_groups;   // row groups, n_slices stages each
  // what fits on the card at once, at least two stages a CTA, at most one CTA a row group
  long long grid = resident;
  grid = grid < (n_units * p.n_slices + 1) / 2 ? grid : (n_units * p.n_slices + 1) / 2;
  grid = grid < n_units ? grid : n_units;
  kernel<<<(unsigned)grid, THREADS + 32, SMEM, st>>>(q, static_cast<const char*>(data), f, dots,
                                                sqn, p, s1, r1, D, n_windows, n_units);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q: f32 [>= B, D]; data: [n_windows * r1, D] of
// row_type 0 = f32, 1 = bf16 bits, a row a multiple of 256 bytes (D % 64 for f32, D % 128
// for bf16), q and data 16-byte aligned; f: int32 [>= B, s1]; dots, sqn: f32
// [>= B, s1 * r1], of which the first B rows are written; n_out must equal B (the ring
// does not copy a row to padded ones).  Returns cudaGetLastError() after the launch; 0
// means it was accepted.
extern "C" int mlvdb_gather_score(const float* q, const void* data, const int* f, float* dots,
                                  float* sqn, int B, int n_out, int s1, int r1, int D,
                                  int n_windows, int row_type, void* stream) {
  if (row_type != 0 && row_type != 1) return (int)cudaErrorInvalidValue;
  const int elem = row_type == 0 ? 4 : 2;
  if (B <= 0 || n_out != B || s1 <= 0 || r1 <= 0 || D <= 0 || n_windows <= 0 || (long long)s1 * r1 > (1 << 30) ||
      (long long)D * elem % PIECE || (long long)D * elem > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16 || reinterpret_cast<uintptr_t>(data) % 16)
    return (int)cudaErrorMisalignedAddress;
  Plan p;
  p.row_bytes = D * elem;
  p.slice_bytes = p.row_bytes < STAGE_BYTES ? p.row_bytes : STAGE_BYTES;
  p.n_slices = (p.row_bytes + p.slice_bytes - 1) / p.slice_bytes;
  p.rows = 1;
  while (p.rows * 2 * p.slice_bytes <= STAGE_BYTES && p.rows < 2 * HALVES) p.rows *= 2;
  p.groups = p.rows < HALVES ? HALVES / p.rows : 1;
  p.per_q = s1 * r1;
  p.q_groups = (p.per_q + p.rows - 1) / p.rows;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rh = p.rows > HALVES ? p.rows / HALVES : 1;
  if (row_type == 0)
    return rh == 2 ? launch<float, 2>(q, data, f, dots, sqn, B, s1, r1, D, n_windows, p, st)
                   : launch<float, 1>(q, data, f, dots, sqn, B, s1, r1, D, n_windows, p, st);
  return rh == 2 ? launch<uint16_t, 2>(q, data, f, dots, sqn, B, s1, r1, D, n_windows, p, st)
                 : launch<uint16_t, 1>(q, data, f, dots, sqn, B, s1, r1, D, n_windows, p, st);
}
