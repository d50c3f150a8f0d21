// Shared helpers of the hand-written Hopper kernels: element-type
// conversion of packed 16-bit / 32-bit words to f32 and back, vector
// loads, and the error-string export every library carries.
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
  __device__ __forceinline__ static float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  __device__ __forceinline__ static void put(uint32_t* w, int e, float f) {
    w[e] = __float_as_uint(f);
  }
};

template <> struct Cvt<__nv_bfloat16> {
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
