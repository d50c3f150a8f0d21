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
// What the design does about it: it keeps the paper's D concurrent
// streams, on common.cuh's row_sweep as reduction.cu does.  The rows (for gemver_sum, the tile
// rows) are split into D segments of seg = rows / D; block j owns the row
// slots j*bm ... j*bm + bm - 1 of every segment, one warp per slot.  In
// each column step the warp starts the loads of the D rows r + k*seg
// over the step's P 128-element sub-portions (load_stream_step, in the
// config's arrangement) before computing any, then stores the D rows;
// loads and stores are 16 bytes a lane in f32.  gemver_outer's u vectors
// ride the same split (u[r + k*seg] beside row r + k*seg), its v vectors
// are read once per column step and stay in L2.
//
// Each operation is rounded as the body rounds it (__fmul_rn and
// __fadd_rn, never a fused multiply-add, then round_to<T>), so the result
// equals the plain version's bit for bit in every dtype.
#include "common.cuh"

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
struct SumBody {
  const T* x;
  const T* z;
  int cols;
  float zv[KMAX][PMAX][4];

  __device__ __forceinline__ void load(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane,
                                       float (&v)[KMAX][PMAX][4]) {
    load_stream_step<T, KMAX, PMAX>(x, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, v);
    load_stream_step<T, KMAX, PMAX>(z, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, zv);
  }

  __device__ __forceinline__ float operator()(int k, int p, int e,
                                              float a) const {
    return round_to<T>(__fadd_rn(a, zv[k][p][e]));
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
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
gemver_sum(const T* __restrict__ x, const T* __restrict__ z,
           T* __restrict__ o, int cols, int d, int seg, int bm, int ns,
           bool interleaved) {
  Elementwise<T, SumBody<T>> body{{x, z, cols}, o, cols};
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

template <typename T>
int sum_t(const void* x, const void* z, void* o, int rows, int cols, int d,
          int bm, int ns, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  gemver_sum<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(z), static_cast<T*>(o),
      cols, d, seg, bm, ns, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
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

// x, z, o: [rows, cols] tiles of `dtype` (the 1-D vectors blocked and
// zero-padded); the same geometry as gemver_outer_launch.
extern "C" int gemver_sum_launch(int dtype, const void* x, const void* z,
                                 void* o, int rows, int cols, int d, int bm,
                                 int ns, int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return sum_t<float>(x, z, o, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return sum_t<__nv_bfloat16>(x, z, o, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return sum_t<__half>(x, z, o, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
