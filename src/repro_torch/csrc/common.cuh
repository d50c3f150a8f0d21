// Shared helpers of the hand-written Hopper kernels: element-type
// conversion (of one value, and of packed 16-bit / 32-bit words) to f32
// and back, vector loads, the flat walk of the K1 elementwise kernels
// (gemver.cu's gemver_sum, stream.cu's copy / triad / init, adamw.cu),
// the row-geometry check of the row kernels, and the error-string export
// every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// element-type codes shared with repro_torch/kernels/cuda.py (dtype_code)
enum ReproDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

template <typename T> struct Cvt;

template <> struct Cvt<float> {
  __device__ __forceinline__ static float from(float f) { return f; }
  __device__ __forceinline__ static float to(float f) { return f; }
  __device__ __forceinline__ static float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  __device__ __forceinline__ static void put(uint32_t* w, int e, float f) {
    w[e] = __float_as_uint(f);
  }
};

template <> struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from(float f) {
    return __float2bfloat16_rn(f);
  }
  __device__ __forceinline__ static float to(__nv_bfloat16 b) {
    return __bfloat162float(b);
  }
  // bf16 is the top half of an f32: widening is a shift, exact
  __device__ __forceinline__ static float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  // narrowing rounds to nearest even, as torch's .to(torch.bfloat16)
  __device__ __forceinline__ static void put(uint32_t* w, int e, float f) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(f));
    w[e >> 1] = (e & 1) ? ((w[e >> 1] & 0x0000ffffu) | (b << 16))
                        : ((w[e >> 1] & 0xffff0000u) | b);
  }
};

template <> struct Cvt<__half> {
  __device__ __forceinline__ static __half from(float f) {
    return __float2half_rn(f);
  }
  __device__ __forceinline__ static float to(__half h) { return __half2float(h); }
  __device__ __forceinline__ static float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __half2float(__ushort_as_half(
        static_cast<unsigned short>((e & 1) ? (x >> 16) : (x & 0xffffu))));
  }
  __device__ __forceinline__ static void put(uint32_t* w, int e, float f) {
    const uint32_t b = __half_as_ushort(__float2half_rn(f));
    w[e >> 1] = (e & 1) ? ((w[e >> 1] & 0x0000ffffu) | (b << 16))
                        : ((w[e >> 1] & 0xffff0000u) | b);
  }
};

// Load N consecutive elements of T (N * sizeof(T) in {2, 4, 8, 16} bytes,
// the address aligned to that size) with one read-only vector load and
// widen them to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* f) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  static_assert(BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES == 16,
                "vector load of 2, 4, 8 or 16 bytes");
  uint32_t w[BYTES >= 4 ? BYTES / 4 : 1];
  if constexpr (BYTES == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = Cvt<T>::get(w, e);
}

// f rounded to T and widened back: one rounding of an operation done in
// T's arithmetic (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  return Cvt<T>::to(Cvt<T>::from(f));
}

// The lane unit of the TPU kernels: a 128-element sub-portion of a row,
// which one warp covers with 4 elements a lane (a 16-byte load for f32,
// 8 bytes for bf16 and f16).
constexpr int SUB = 128;

// The geometry a D-stream row kernel refuses (gemver_outer, the K2
// row-dot): d streams must split the rows, bm slots a segment, and the
// columns be whole sub-portions.
inline bool bad_sweep_geometry(int rows, int cols, int d, int bm, int ns) {
  return rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || ns <= 0 ||
         rows % d != 0 || (rows / d) % bm != 0 || cols % SUB != 0;
}

// The flat walk of the K1 elementwise kernels, in the shape of PyTorch's
// vectorised elementwise kernel: blocks of WALK_UNIT threads over
// contiguous units of WALK_UNIT 16-byte vectors.  The flat range is cut
// into d segments of segv vectors each (the paper's D concurrent
// streams: the rows r + k * seg of a blocked [rows, cols] array, or for
// adamw.cu the leaves of a parameter list laid end to end).  A step takes
// np units (P) at the same offset of each of the d segments; its d * np
// units are ordered as the config's arrangement orders a column step's
// loads (grouped: stream by stream, each stream's np units back to back,
// so block j runs stream j; interleaved: unit by unit, the streams
// round-robin) and run by d consecutive blocks, np units a block, so the
// d streams of a step are issued together and stream concurrently
// across the card.  Grid: x the block of its step (d), the steps in y
// and z (walk_grid).  A thread takes its vector of each of its block's
// units, HELD at a time, and issues all their loads before it computes
// or stores any.  The last step of a segment may be short: its vectors
// past the segment are masked.  Body is what a kernel does there:
//   typename Body::Held      what one vector's loads leave in registers
//   bool load(at, held)      issue the loads of flat vector `at`; false
//                            masks it (nothing is stored)
//   void store(at, held)     compute and store vector `at`
constexpr int WALK_UNIT = 128;     // threads of a block, vectors of a unit
constexpr int WALK_HELD = 4;       // units a thread holds at once

template <typename Body, int HELD = WALK_HELD>
__device__ __forceinline__ void flat_walk(long long segv, int d, int np,
                                          bool interleaved, Body& body) {
  const int j = blockIdx.x;                // the block of its step
  const long long c = blockIdx.y + static_cast<long long>(blockIdx.z) *
                                       gridDim.y;
  for (int s0 = 0; s0 < np; s0 += HELD) {
    long long at[HELD];
    typename Body::Held h[HELD];
#pragma unroll
    for (int u = 0; u < HELD; ++u) {
      at[u] = -1;
      const int s = s0 + u;
      if (s < np) {
        const int item = j * np + s;
        const int k = interleaved ? item % d : j;
        const int p = interleaved ? item / d : s;
        const long long v = (c * np + p) * WALK_UNIT + threadIdx.x;
        if (v < segv && body.load(k * segv + v, h[u])) at[u] = k * segv + v;
      }
    }
#pragma unroll
    for (int u = 0; u < HELD; ++u)
      if (at[u] >= 0) body.store(at[u], h[u]);
  }
}

// The grid of a flat walk over d segments of segv vectors in steps of np
// units: (d, rows, planes), the steps in grid rows (y) of at most 65535
// and the rest in z.  False where the walk cannot be launched.
inline bool walk_grid(long long segv, int d, int np, dim3* grid) {
  if (segv <= 0 || d <= 0 || np <= 0 || d > 65535) return false;
  const long long per = static_cast<long long>(np) * WALK_UNIT;
  const long long steps = (segv + per - 1) / per;
  const long long rows = steps < 65535 ? steps : 65535;
  const long long planes = (steps + rows - 1) / rows;
  if (planes > 65535) return false;
  *grid = dim3(static_cast<unsigned>(d), static_cast<unsigned>(rows),
               static_cast<unsigned>(planes));
  return true;
}
