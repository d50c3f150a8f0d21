// Multi-strided gemver elementwise steps for Hopper (sm_90a): the double
// rank-1 update and the loop-blocked vector sum.
//
// Replaces the gemver_outer and gemver_sum instances of the JAX
// package's K1 template, _emit_streaming (src/repro/codegen/emit.py:410),
// whose bodies are gemver_outer_spec and gemver_sum_spec
// (src/repro/kernels/gemver/specs.py):
//   gemver_outer:  o[i, j] = (A[i, j] + u1[i] * v1[j]) + u2[i] * v2[j]
//   gemver_sum:    o = x + z, on the §5.1.1 tiling of the 1-D loop into
//                  [rows, 128 * P] tiles (the port's emit.block_1d)
// with every operation in the arrays' dtype, as the bodies compute it.
//
// What bounds them: bytes.  Each element of A (or x and z) is read once
// and each element of o written once, for at most four flops, far below
// the card's ~20 flops per byte of f32 arithmetic.
//
// What the design does about it.  gemver_outer walks on its own, turned
// around from the row sweep: a thread owns one 16-byte column vector of
// A (4 elements in f32, 8 in bf16 and f16) and keeps that vector's v1
// and v2 in registers for its whole run, so v is read once a block, not
// once a row.  A block of 128 threads is a column tile; the grid is
// column tiles x runs of row slots of the D segments of seg = rows / D
// (outer_geometry in kernels/gemver/kernel.py).  A step takes U row
// slots of each of K streams (rows s + k*seg, K * U = 4 16-byte loads
// of A; the D streams in groups of K), issued in the config's
// arrangement (grouped: stream by stream; interleaved: slot by slot)
// before any is used, and the next step's loads are in flight while the
// current one is computed and stored.  u1[r], u2[r] are one broadcast
// load a row.  The last column tile's vectors past the row are masked
// (the rows are whole 128-element sub-portions, so whole vectors), as
// are the slots past a segment.
//
// gemver_sum runs on common.cuh's flat walk, which it first had on its
// own (stream.cu's copy, triad and init and adamw.cu now share it): the
// tiles' D segments of seg = rows / D rows are contiguous runs of
// seg * 128 * P elements of the flat arrays, 16-byte vectors of x and z
// (4 elements in f32, 8 in bf16 and f16); a step takes P units of 128
// vectors at the same offset of each of the D segments, D consecutive
// blocks of 128 threads, P units a block, in the config's arrangement;
// a thread issues the loads of up to WALK_HELD = 4 units before it adds
// and stores any.  The last step of a segment may be short (a D that
// leaves short segments, or a ragged n, which the emitter pads to whole
// tiles): its vectors past the segment are masked.

// Each operation is rounded as the body rounds it, so the result equals
// the plain version's bit for bit in every dtype.  gemver_sum widens to
// f32, adds with __fadd_rn and rounds each sum once to T.  gemver_outer
// in f32 multiplies and adds with __fmul_rn and __fadd_rn (never a fused
// multiply-add); in bf16 and f16 it runs packed 16-bit arithmetic, two
// elements an instruction (mul.rn / add.rn on bf16x2 and f16x2, which
// nvcc never contracts).  One product or sum rounded once to a 16-bit
// type equals the f32 result rounded to it (the plain version's
// arithmetic): the f32 operation is exact for a product of two 16-bit
// values and, for a sum, f32's 24 bits are at least 2p + 2 for p = 8
// (bf16) and 11 (f16), so rounding twice gives the one rounding.  (A
// bf16 product under 2^-126, where f32 itself is subnormal, is the one
// place the two could part.)
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int OUTER_THREADS = 128;   // a block: its column tile's vectors
constexpr int OUTER_LOADS = 4;       // 16-byte loads of A a thread a step

// One 32-bit word of o = (a + u1 v1) + u2 v2: one f32 element, or two
// 16-bit elements in packed arithmetic (u1, u2 in both halves).
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t r;
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

template <typename T>
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t r;
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("add.rn.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

template <typename T>
__device__ __forceinline__ uint32_t outer_word(uint32_t a, uint32_t u1,
                                               uint32_t v1, uint32_t u2,
                                               uint32_t v2) {
  if constexpr (sizeof(T) == 4) {
    const float t1 = __fmul_rn(__uint_as_float(u1), __uint_as_float(v1));
    const float t2 = __fmul_rn(__uint_as_float(u2), __uint_as_float(v2));
    return __float_as_uint(__fadd_rn(__fadd_rn(__uint_as_float(a), t1), t2));
  } else {
    return add2<T>(add2<T>(a, mul2<T>(u1, v1)), mul2<T>(u2, v2));
  }
}

// u[r] as the word outer_word takes: the f32 bits, or a 16-bit value in
// both halves (one broadcast load: every thread of a block reads it)
template <typename T>
__device__ __forceinline__ uint32_t u_word(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(__ldg(reinterpret_cast<const float*>(p)));
  } else {
    const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(p));
    return h | (h << 16);
  }
}

// The steps of one thread: step i takes the U slots s0 + (i / groups) *
// U ... of the K streams (i % groups) * K ... (rows s + k * seg), the
// thread's 16-byte vector at column c of each row.
template <typename T, int K>
struct OuterSteps {
  static constexpr int U = OUTER_LOADS / K;
  struct Held {                  // a step's operands in registers
    uint4 a[K][U];
    uint32_t u1[K][U], u2[K][U];
  };
  const T* A;
  const T* u1;
  const T* u2;
  T* o;
  size_t cols;
  int c, d, seg, s0, s1, groups;
  bool interleaved;

  __device__ __forceinline__ bool row(int i, int k, int j, size_t& r) const {
    const int s = s0 + (i / groups) * U + j, kk = (i % groups) * K + k;
    r = static_cast<size_t>(s) + static_cast<size_t>(kk) * seg;
    return s < s1 && kk < d;
  }

  __device__ __forceinline__ void load1(int i, int k, int j, Held& h) const {
    size_t r;
    if (row(i, k, j, r)) {
      h.a[k][j] = __ldg(reinterpret_cast<const uint4*>(A + r * cols + c));
      h.u1[k][j] = u_word(u1 + r);
      h.u2[k][j] = u_word(u2 + r);
    }
  }

  // the loads of step i, in the arrangement
  __device__ __forceinline__ void load(int i, Held& h) const {
    if (interleaved) {
#pragma unroll
      for (int j = 0; j < U; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) load1(i, k, j, h);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < U; ++j) load1(i, k, j, h);
    }
  }

  // step i's outputs, each word computed alike whatever the arrangement
  __device__ __forceinline__ void store(int i, const Held& h,
                                        const uint4& w1,
                                        const uint4& w2) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < U; ++j) {
        size_t r;
        if (row(i, k, j, r)) {
          const uint4 a = h.a[k][j];
          const uint32_t p = h.u1[k][j], q = h.u2[k][j];
          *reinterpret_cast<uint4*>(o + r * cols + c) = make_uint4(
              outer_word<T>(a.x, p, w1.x, q, w2.x),
              outer_word<T>(a.y, p, w1.y, q, w2.y),
              outer_word<T>(a.z, p, w1.z, q, w2.z),
              outer_word<T>(a.w, p, w1.w, q, w2.w));
        }
      }
  }
};

// Block (x, y): column tile x (OUTER_THREADS vectors), the run of `run`
// row slots from y * run of every segment; a thread its vector.
template <typename T, int K>
__global__ void __launch_bounds__(OUTER_THREADS)
gemver_outer(const T* __restrict__ A, const T* __restrict__ u1,
             const T* __restrict__ v1, const T* __restrict__ u2,
             const T* __restrict__ v2, T* __restrict__ o, int cols, int d,
             int seg, int run, bool interleaved) {
  using S = OuterSteps<T, K>;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int c = (blockIdx.x * OUTER_THREADS + threadIdx.x) * VEC;
  if (c >= cols) return;                  // past the row: no vector
  const int s0 = blockIdx.y * run;
  const int groups = (d + K - 1) / K;
  const S st{A, u1, u2, o, static_cast<size_t>(cols), c, d, seg, s0,
             min(seg, s0 + run), groups, interleaved};
  const int steps = (st.s1 - s0 + S::U - 1) / S::U * groups;
  const uint4 w1 = __ldg(reinterpret_cast<const uint4*>(v1 + c));
  const uint4 w2 = __ldg(reinterpret_cast<const uint4*>(v2 + c));
  // two steps in registers: the next one's loads are in flight while
  // the current one is computed and stored
  typename S::Held a, b;
  if (steps > 0) st.load(0, a);
  for (int i = 0; i < steps; i += 2) {
    if (i + 1 < steps) st.load(i + 1, b);
    st.store(i, a, w1, w2);
    if (i + 1 >= steps) break;
    if (i + 2 < steps) st.load(i + 2, a);
    st.store(i + 1, b, w1, w2);
  }
}

// the instance and grid of the last gemver_outer launch: streams a
// group, column tiles, runs
int last_outer[3] = {0, 0, 0};

// streams a group: the smallest power of two up to d, at most
// OUTER_LOADS (the slots a step make up the rest)
template <typename T>
int outer_t(const void* A, const void* u1, const void* v1, const void* u2,
            const void* v2, void* o, int rows, int cols, int d, int bm,
            int run, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, 1) || run <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  const int runs = (seg + run - 1) / run;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int tiles = (cols / VEC + OUTER_THREADS - 1) / OUTER_THREADS;
  if (runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, runs);
  const T* a = static_cast<const T*>(A);
  const T *p1 = static_cast<const T*>(u1), *q1 = static_cast<const T*>(v1);
  const T *p2 = static_cast<const T*>(u2), *q2 = static_cast<const T*>(v2);
  T* out = static_cast<T*>(o);
  if (d > 2)
    gemver_outer<T, 4><<<grid, OUTER_THREADS, 0, stream>>>(
        a, p1, q1, p2, q2, out, cols, d, seg, run, interleaved != 0);
  else if (d > 1)
    gemver_outer<T, 2><<<grid, OUTER_THREADS, 0, stream>>>(
        a, p1, q1, p2, q2, out, cols, d, seg, run, interleaved != 0);
  else
    gemver_outer<T, 1><<<grid, OUTER_THREADS, 0, stream>>>(
        a, p1, q1, p2, q2, out, cols, d, seg, run, interleaved != 0);
  last_outer[0] = d > 2 ? 4 : d > 1 ? 2 : 1;
  last_outer[1] = tiles;
  last_outer[2] = runs;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int outer_occupancy_t(int d, int* blocks) {
  auto* kernel = &gemver_outer<T, 1>;
  if (d > 2) kernel = &gemver_outer<T, 4>;
  else if (d > 1) kernel = &gemver_outer<T, 2>;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, OUTER_THREADS, 0));
}

// a + b of the elements of one 32-bit word, each sum in f32 rounded once
// to T (two at once in a 16-bit type: a packed conversion, each half
// rounded to nearest even as __float2bfloat16_rn / __float2half_rn do)
template <typename T>
__device__ __forceinline__ uint32_t add_word(uint32_t a, uint32_t b) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  } else {
    const uint32_t wa[1] = {a}, wb[1] = {b};
    const float lo = __fadd_rn(Cvt<T>::get(wa, 0), Cvt<T>::get(wb, 0));
    const float hi = __fadd_rn(Cvt<T>::get(wa, 1), Cvt<T>::get(wb, 1));
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      return *reinterpret_cast<const uint32_t*>(&h);
    } else {
      const __half2 h = __floats2half2_rn(lo, hi);
      return *reinterpret_cast<const uint32_t*>(&h);
    }
  }
}

// gemver_sum's body on common.cuh's flat walk: x and z of a vector
// loaded (__ldg) when the walk issues it, added and stored after.
template <typename T>
struct SumBody {
  struct Held { uint4 a, e; };
  const uint4* __restrict__ x;
  const uint4* __restrict__ z;
  uint4* __restrict__ o;

  __device__ __forceinline__ bool load(long long at, Held& h) const {
    h.a = __ldg(x + at);
    h.e = __ldg(z + at);
    return true;
  }

  __device__ __forceinline__ void store(long long at, const Held& h) const {
    o[at] = make_uint4(add_word<T>(h.a.x, h.e.x), add_word<T>(h.a.y, h.e.y),
                       add_word<T>(h.a.z, h.e.z), add_word<T>(h.a.w, h.e.w));
  }
};

// x, z, o as 16-byte vectors; segv vectors a segment, d segments, steps
// of np units (common.cuh flat_walk).
template <typename T>
__global__ void __launch_bounds__(WALK_UNIT)
gemver_sum(const uint4* __restrict__ x, const uint4* __restrict__ z,
           uint4* __restrict__ o, long long segv, int d, int np,
           bool interleaved) {
  SumBody<T> body{x, z, o};
  flat_walk(segv, d, np, interleaved, body);
}

template <typename T>
int sum_t(const void* x, const void* z, void* o, long long segv, int d,
          int np, int interleaved, cudaStream_t stream) {
  dim3 grid;
  if (!walk_grid(segv, d, np, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  gemver_sum<T><<<grid, WALK_UNIT, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(z),
      static_cast<uint4*>(o), segv, d, np, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sum_occupancy_t(int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gemver_sum<T>, threads, 0));
}

}  // namespace

// A, o: [rows, cols] of `dtype`, row-major, 16-byte aligned; u1, u2:
// [rows]; v1, v2: [cols].  d streams of seg = rows / d rows (bm row
// slots per block in the plan, checked only to divide seg); blocks of
// `run` row slots of every segment (outer_geometry), loaded grouped
// (interleaved = 0) or interleaved (1).  cols a multiple of 128.
extern "C" int gemver_outer_launch(int dtype, const void* A, const void* u1,
                                   const void* v1, const void* u2,
                                   const void* v2, void* o, int rows,
                                   int cols, int d, int bm, int run,
                                   int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return outer_t<float>(A, u1, v1, u2, v2, o, rows, cols, d, bm, run, interleaved, st);
    case kBF16: return outer_t<__nv_bfloat16>(A, u1, v1, u2, v2, o, rows, cols, d, bm, run, interleaved, st);
    case kF16: return outer_t<__half>(A, u1, v1, u2, v2, o, rows, cols, d, bm, run, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The last gemver_outer launch's instance and grid (streams a group,
// column tiles, runs) into out[0..2].
extern "C" void gemver_outer_last_launch(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = last_outer[i];
}

// Blocks of gemver_outer (the instance for d streams) one SM keeps
// resident.
extern "C" int gemver_outer_occupancy(int dtype, int d, int* blocks) {
  switch (dtype) {
    case kF32: return outer_occupancy_t<float>(d, blocks);
    case kBF16: return outer_occupancy_t<__nv_bfloat16>(d, blocks);
    case kF16: return outer_occupancy_t<__half>(d, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, z, o: the [rows, cols] tiles of `dtype` (the 1-D vectors blocked
// and zero-padded, 16-byte aligned) as segv 16-byte vectors in each of
// d segments; steps of np units of 128 vectors of every segment, d
// blocks of 128 threads a step, its units ordered grouped
// (interleaved = 0) or interleaved (1).
extern "C" int gemver_sum_launch(int dtype, const void* x, const void* z,
                                 void* o, long long segv, int d, int np,
                                 int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return sum_t<float>(x, z, o, segv, d, np, interleaved, st);
    case kBF16: return sum_t<__nv_bfloat16>(x, z, o, segv, d, np, interleaved, st);
    case kF16: return sum_t<__half>(x, z, o, segv, d, np, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of gemver_sum of `threads` threads one SM keeps resident.
extern "C" int gemver_sum_occupancy(int dtype, int threads, int* blocks) {
  switch (dtype) {
    case kF32: return sum_occupancy_t<float>(threads, blocks);
    case kBF16: return sum_occupancy_t<__nv_bfloat16>(threads, blocks);
    case kF16: return sum_occupancy_t<__half>(threads, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
