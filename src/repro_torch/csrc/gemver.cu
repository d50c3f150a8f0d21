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
// What the design does about it.  gemver_outer keeps the paper's D
// concurrent streams on common.cuh's row_sweep, as reduction.cu does:
// the rows are split into D segments of seg = rows / D; block j owns the
// row slots j*bm ... j*bm + bm - 1 of every segment, one warp per slot.
// In each column step the warp starts the loads of the D rows r + k*seg
// over the step's P 128-element sub-portions (load_stream_step, in the
// config's arrangement) before computing any, then stores the D rows;
// its u vectors ride the same split (u[r + k*seg] beside row
// r + k*seg), its v vectors are read once per column step and stay in
// L2.
//
// gemver_sum walks on its own, in the shape of PyTorch's vectorised
// elementwise kernel: blocks of 128 threads over contiguous units,
// 16-byte vectors of x and z (4 elements in f32, 8 in bf16 and f16).
// The tiles' D segments of seg = rows / D rows are contiguous runs of
// seg * 128 * P elements of the flat arrays.  A step takes P units of
// 128 vectors at the same offset of each of the D segments; its D * P
// units are ordered as the config's arrangement orders a column step's
// loads (grouped: stream by stream; interleaved: the streams
// round-robin) and run by D consecutive blocks, P units a block, so the
// D streams of a step are issued together and stream concurrently
// across the card.  A thread takes its vector of each of its block's
// units, SUM_HELD at a time, and issues all their loads before it adds
// and stores any.  The last step of a segment may be short (a D that
// leaves short segments, or a ragged n, which the emitter pads to whole
// tiles): its vectors past the segment are masked.
//
// Each operation is rounded as the body rounds it (__fmul_rn and
// __fadd_rn, never a fused multiply-add, then round_to<T>; gemver_sum
// widens to f32, adds with __fadd_rn and rounds each sum once to T,
// never packed 16-bit arithmetic), so the result equals the plain
// version's bit for bit in every dtype.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int KMAX = SWEEP_KMAX, PMAX = SWEEP_PMAX;

template <typename T>
struct OuterBody {
  const T* A;
  const T* u1;
  const T* v1;
  const T* u2;
  const T* v2;
  int cols;
  float u1k[KMAX], u2k[KMAX], v1p[PMAX][4], v2p[PMAX][4];

  __device__ __forceinline__ void load(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane,
                                       float (&v)[KMAX][PMAX][4]) {
    load_stream_step<T, KMAX, PMAX>(A, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, v);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        u1k[k] = Cvt<T>::to(u1[rk + k * seg]);
        u2k[k] = Cvt<T>::to(u2[rk + k * seg]);
      }
    }
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      if (p < np) {
        load_f32<T, 4>(v1 + c0 + p * SUB + lane * 4, v1p[p]);
        load_f32<T, 4>(v2 + c0 + p * SUB + lane * 4, v2p[p]);
      }
    }
  }

  __device__ __forceinline__ float operator()(int k, int p, int e,
                                              float a) const {
    const float t1 = round_to<T>(__fmul_rn(u1k[k], v1p[p][e]));
    const float t2 = round_to<T>(__fmul_rn(u2k[k], v2p[p][e]));
    return round_to<T>(__fadd_rn(round_to<T>(__fadd_rn(a, t1)), t2));
  }
};

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
gemver_outer(const T* __restrict__ A, const T* __restrict__ u1,
             const T* __restrict__ v1, const T* __restrict__ u2,
             const T* __restrict__ v2, T* __restrict__ o, int cols, int d,
             int seg, int bm, int ns, bool interleaved) {
  Elementwise<T, OuterBody<T>> body{{A, u1, v1, u2, v2, cols}, o, cols};
  row_sweep(cols, d, seg, bm, ns, interleaved, body);
}

template <typename T>
int outer_t(const void* A, const void* u1, const void* v1, const void* u2,
            const void* v2, void* o, int rows, int cols, int d, int bm,
            int ns, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  gemver_outer<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(u1),
      static_cast<const T*>(v1), static_cast<const T*>(u2),
      static_cast<const T*>(v2), static_cast<T*>(o), cols, d, seg, bm, ns,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

constexpr int SUM_UNIT = 128;      // threads of a block, vectors of a unit
constexpr int SUM_HELD = 4;        // units a thread holds at once

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

// x, z, o as 16-byte vectors; segv vectors a segment, d segments, cut
// into steps of np units of SUM_UNIT vectors.  The d blocks of step c
// (the grid's x; c in y and z, so they are issued together) run its
// d * np units, np a block: in the config's arrangement the step's units
// are ordered grouped (stream by stream, each stream's np units back to
// back: block j runs stream j) or interleaved (unit by unit, the streams
// round-robin), and block j takes the j-th np of them.  A thread takes
// its vector of each of its block's units, SUM_HELD at a time: it loads
// x and z of all of them before it adds and stores any.
template <typename T>
__global__ void __launch_bounds__(SUM_UNIT)
gemver_sum(const uint4* __restrict__ x, const uint4* __restrict__ z,
           uint4* __restrict__ o, long long segv, int d, int np,
           bool interleaved) {
  const int j = blockIdx.x;                // the block of its step
  const long long c = blockIdx.y + static_cast<long long>(blockIdx.z) *
                                       gridDim.y;
  for (int s0 = 0; s0 < np; s0 += SUM_HELD) {
    long long at[SUM_HELD];
    uint4 a[SUM_HELD], e[SUM_HELD];
#pragma unroll
    for (int u = 0; u < SUM_HELD; ++u) {
      at[u] = -1;
      const int s = s0 + u;
      if (s < np) {
        const int item = j * np + s;
        const int k = interleaved ? item % d : j;
        const int p = interleaved ? item / d : s;
        const long long v = (c * np + p) * SUM_UNIT + threadIdx.x;
        if (v < segv) {
          at[u] = k * segv + v;
          a[u] = __ldg(x + at[u]);
          e[u] = __ldg(z + at[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SUM_HELD; ++u)
      if (at[u] >= 0)
        o[at[u]] = make_uint4(add_word<T>(a[u].x, e[u].x),
                              add_word<T>(a[u].y, e[u].y),
                              add_word<T>(a[u].z, e[u].z),
                              add_word<T>(a[u].w, e[u].w));
  }
}

template <typename T>
int sum_t(const void* x, const void* z, void* o, long long segv, int d,
          int np, int interleaved, cudaStream_t stream) {
  if (segv <= 0 || d <= 0 || np <= 0 || d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long steps =
      (segv + static_cast<long long>(np) * SUM_UNIT - 1) /
      (static_cast<long long>(np) * SUM_UNIT);
  // steps in grid rows (y) of at most 65535, the rest in z
  const long long rows = steps < 65535 ? steps : 65535;
  const long long planes = (steps + rows - 1) / rows;
  if (planes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  gemver_sum<T><<<dim3(d, static_cast<unsigned>(rows),
                       static_cast<unsigned>(planes)), SUM_UNIT, 0, stream>>>(
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

// A, o: [rows, cols] of `dtype`, row-major; u1, u2: [rows]; v1, v2:
// [cols].  d streams of seg = rows / d rows, bm row slots per block;
// column steps of ns 128-element sub-portions, loaded grouped
// (interleaved = 0) or interleaved (1).  cols a multiple of 128.
extern "C" int gemver_outer_launch(int dtype, const void* A, const void* u1,
                                   const void* v1, const void* u2,
                                   const void* v2, void* o, int rows,
                                   int cols, int d, int bm, int ns,
                                   int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return outer_t<float>(A, u1, v1, u2, v2, o, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return outer_t<__nv_bfloat16>(A, u1, v1, u2, v2, o, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return outer_t<__half>(A, u1, v1, u2, v2, o, rows, cols, d, bm, ns, interleaved, st);
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
