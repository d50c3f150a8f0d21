// Multi-strided RMSNorm for Hopper (sm_90a).
//
// Replaces the rmsnorm instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// _rms_body in src/repro/kernels/rmsnorm/specs.py:
//   o = (f32(x) * inv) * f32(w),  r = inv = 1 / sqrt(mean(f32(x)^2) + eps)
// with o in x's dtype and r in f32.
//
// What bounds it: bytes.  Every element of x is read once and every
// element of o written once (2 * t * dm * itemsize + dm * itemsize for w
// + 4 * t for r) for a handful of flops each, far below the card's
// ~295 flops per byte.  A kernel that sustains device-memory bandwidth is
// as fast as this function can be.
//
// What the design does about it: it keeps the paper's D concurrent
// streams.  The rows are split into D segments of seg = rows / D; block
// j owns the row slots j*bm ... j*bm + bm - 1 of every segment and, for
// each slot r, issues the loads of the D rows r + k*seg (k = 0..D-1)
// back to back, as 16-byte vectors, before reducing any of them — D
// independent global-memory streams in flight per block, the GPU form
// of the TPU kernel's D HBM->VMEM pipelines.  (d, bm) come from the
// port's plan_blocks.  The rows are staged in shared memory, so x is
// read from device memory once; the row sum of squares is taken in f32
// by warp shuffles.  At most KMAX streams are held in registers at a
// time: a larger D is walked in groups of KMAX.
#include "common.cuh"

namespace {

constexpr int KMAX = 8;          // streams in registers per pass
constexpr int MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_ms(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, float* __restrict__ r,
           int dm, int d, int seg, int bm, float eps) {
  constexpr int N = 16 / sizeof(T);       // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int nvec = dm / N;
  const int kmax = d < KMAX ? d : KMAX;
  uint4* rows = reinterpret_cast<uint4*>(smem);                  // [kmax][nvec]
  float* red = reinterpret_cast<float*>(rows + static_cast<size_t>(kmax) * nvec);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(o);

  for (int slot = 0; slot < bm; ++slot) {
    const int r0 = blockIdx.x * bm + slot;
    for (int k0 = 0; k0 < d; k0 += KMAX) {
      const int nk = min(KMAX, d - k0);
      float ss[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) ss[k] = 0.f;
      for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        uint4 buf[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k)      // the D streams, back to back
          if (k < nk)
            buf[k] = __ldg(xv + static_cast<size_t>(r0 + (k0 + k) * seg) * nvec + v);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < nk) {
            rows[static_cast<size_t>(k) * nvec + v] = buf[k];
            const uint32_t wd[4] = {buf[k].x, buf[k].y, buf[k].z, buf[k].w};
#pragma unroll
            for (int e = 0; e < N; ++e) {
              const float f = Cvt<T>::get(wd, e);
              ss[k] += f * f;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < nk) {
          float s = ss[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) red[k * 32 + warp] = s;
        }
      }
      __syncthreads();
      float inv[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        inv[k] = 0.f;
        if (k < nk) {
          float s = 0.f;
          for (int i = 0; i < nwarps; ++i) s += red[k * 32 + i];
          inv[k] = 1.0f / sqrtf(s / static_cast<float>(dm) + eps);
        }
      }
      for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        const uint4 wq = __ldg(wv + v);
        const uint32_t ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < nk) {
            const uint4 xq = rows[static_cast<size_t>(k) * nvec + v];
            const uint32_t xw[4] = {xq.x, xq.y, xq.z, xq.w};
            uint32_t ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < N; ++e)
              Cvt<T>::put(ow, e, (Cvt<T>::get(xw, e) * inv[k]) * Cvt<T>::get(ww, e));
            ov[static_cast<size_t>(r0 + (k0 + k) * seg) * nvec + v] =
                make_uint4(ow[0], ow[1], ow[2], ow[3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < nk && threadIdx.x == k) r[r0 + (k0 + k) * seg] = inv[k];
      __syncthreads();   // rows and red are reused by the next pass
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* o, void* r, int rows, int dm,
           int d, int bm, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (rows <= 0 || dm <= 0 || d <= 0 || bm <= 0 || rows % d != 0 ||
      dm % N != 0 || (rows / d) % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d, nvec = dm / N;
  const int kmax = d < KMAX ? d : KMAX;
  const size_t smem = static_cast<size_t>(kmax) * nvec * 16 + KMAX * 32 * sizeof(float);
  int threads = (nvec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_ms<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rmsnorm_ms<T><<<seg / bm, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      static_cast<float*>(r), dm, d, seg, bm, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, o: [rows, dm] of the element type `dtype`; w: [dm]; r: [rows] f32.
// d streams of seg = rows / d rows; bm row slots per block.
extern "C" int rmsnorm_ms_launch(int dtype, const void* x, const void* w,
                                 void* o, void* r, int rows, int dm, int d,
                                 int bm, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, w, o, r, rows, dm, d, bm, eps, st);
    case kBF16: return launch<__nv_bfloat16>(x, w, o, r, rows, dm, d, bm, eps, st);
    case kF16: return launch<__half>(x, w, o, r, rows, dm, d, bm, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
