// Shared helpers of the hand-written Hopper kernels: element-type
// conversion (of one value, and of packed 16-bit / 32-bit words) to f32
// and back, vector loads and stores, the D-stream row sweep of the row
// templates, its column step and its elementwise body, and the
// error-string export every library carries.
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

// Narrow N f32 values to T and store them with one vector store (the
// address aligned to N * sizeof(T) bytes, 4, 8 or 16).
template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float* f) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16,
                "vector store of 4, 8 or 16 bytes");
  uint32_t w[BYTES / 4];
#pragma unroll
  for (int e = 0; e < N; ++e) Cvt<T>::put(w, e, f[e]);
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned int*>(p) = w[0];
  }
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

// One column step of the D-stream sweep of a warp (the multi-strided
// row templates, K1 and K2).  For the nk streams k (rows r0 + k * seg of
// a row-major [*, cols] array) and the np sub-portions p (columns
// c0 + p * SUB ...), lane `lane` loads its 4 elements of each, and every
// load starts before any is used: nk * np independent loads in flight.
// The load order is the config's arrangement: grouped (each stream's
// sub-portions back to back, §4.1) or interleaved (the streams
// round-robin at sub-portion granularity, §4.4).  The values land in the
// same registers either way, so the arithmetic after it does not depend
// on the arrangement.
template <typename T, int KMAX, int PMAX>
__device__ __forceinline__ void load_stream_step(
    const T* __restrict__ a, int cols, int r0, int seg, int nk, int c0,
    int np, bool interleaved, int lane, float (&v)[KMAX][PMAX][4]) {
  const T* p0 = a + c0 + lane * 4;
  if (interleaved) {
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < nk && p < np)
          load_f32<T, 4>(p0 + static_cast<size_t>(r0 + k * seg) * cols + p * SUB, v[k][p]);
  } else {
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int p = 0; p < PMAX; ++p)
        if (k < nk && p < np)
          load_f32<T, 4>(p0 + static_cast<size_t>(r0 + k * seg) * cols + p * SUB, v[k][p]);
  }
}

// The D-stream row sweep of the row templates (the K1 stream.cu and
// adamw.cu).  The rows of a row-major [rows, cols] array are split into
// d segments of seg = rows / d; block j owns the row slots j*bm ...
// j*bm + bm - 1 of every segment, one warp per slot (a block has
// sweep_warps(bm) warps; a warp takes every nwarps-th slot).  For each
// slot the warp walks the d streams in groups of at most KMAX rows
// rk + k*seg, and each group over the columns, one column step of ns
// 128-element sub-portions after another, at most SWEEP_PMAX of them in
// registers at a time.  Body is what a kernel does there:
//   body.begin(nk)           a group of nk streams starts
//   body.step(rk, seg, nk, c0, np, interleaved, lane)
//                            np sub-portions from column c0 of the
//                            group's rows (loaded with load_stream_step)
//   body.end(rk, seg, nk, lane)   the group's rows are done
// KMAX, the most streams of a group, defaults to SWEEP_KMAX; a body
// with more operands in registers (adamw.cu's four) takes fewer.
constexpr int SWEEP_KMAX = 8;       // streams in registers per pass
constexpr int SWEEP_PMAX = 2;       // sub-portions in registers per pass
constexpr int SWEEP_MAX_WARPS = 8;

template <typename Body, int KMAX = SWEEP_KMAX>
__device__ __forceinline__ void row_sweep(int cols, int d, int seg, int bm,
                                          int ns, bool interleaved,
                                          Body& body) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nsub = cols / SUB;
  for (int slot = warp; slot < bm; slot += nwarps) {
    const int r0 = blockIdx.x * bm + slot;
    for (int k0 = 0; k0 < d; k0 += KMAX) {
      const int nk = min(KMAX, d - k0);
      const int rk = r0 + k0 * seg;
      body.begin(nk);
      for (int q0 = 0; q0 < nsub; q0 += ns)            // one column step
        for (int p0 = 0; p0 < ns && q0 + p0 < nsub; p0 += SWEEP_PMAX)
          body.step(rk, seg, nk, (q0 + p0) * SUB,
                    min(SWEEP_PMAX, min(ns - p0, nsub - q0 - p0)),
                    interleaved, lane);
      body.end(rk, seg, nk, lane);
    }
  }
}

// The geometry a row sweep refuses: d streams must split the rows, bm
// slots a segment, and the columns be whole sub-portions.
inline bool bad_sweep_geometry(int rows, int cols, int d, int bm, int ns) {
  return rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || ns <= 0 ||
         rows % d != 0 || (rows / d) % bm != 0 || cols % SUB != 0;
}

// Warps of a row-sweep block: one per row slot, at most SWEEP_MAX_WARPS.
inline int sweep_warps(int bm) {
  return bm < SWEEP_MAX_WARPS ? bm : SWEEP_MAX_WARPS;
}

// The elementwise body of row_sweep (the K1 instances of stream.cu):
// Op loads a column step of its operands (the first into v; a
// writes-only Op loads nothing) and gives the output of stream k,
// sub-portion p, element e, which is stored to o, 16 bytes a lane in
// f32.
template <typename T, typename Op>
struct Elementwise {
  Op op;
  T* o;
  int cols;

  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void end(int, int, int, int) {}

  __device__ __forceinline__ void step(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane) {
    float v[SWEEP_KMAX][SWEEP_PMAX][4];
    op.load(rk, seg, nk, c0, np, interleaved, lane, v);
#pragma unroll
    for (int k = 0; k < SWEEP_KMAX; ++k) {
#pragma unroll
      for (int p = 0; p < SWEEP_PMAX; ++p) {
        if (k < nk && p < np) {
          float out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) out[e] = op(k, p, e, v[k][p][e]);
          store_f32<T, 4>(o + static_cast<size_t>(rk + k * seg) * cols +
                              c0 + p * SUB + lane * 4, out);
        }
      }
    }
  }
};
