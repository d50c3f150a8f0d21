// Multi-strided row-dot (matrix-vector product) for Hopper (sm_90a).
//
// Replaces the mxv and bicg_q instances of the JAX package's K2 template,
// _emit_reduction (src/repro/codegen/emit.py:491), whose bodies are
// mxv_spec and bicg_q_spec (src/repro/kernels/{mxv,bicg}/specs.py):
//   y[i] = sum_j f32(A[i, j]) * f32(x[j]),  stored in A's dtype.
//
// What bounds it: bytes.  Every element of A is read once for one
// multiply-add (2 flops per 4 bytes in f32), far below the card's
// ~20 flops per byte of f32 arithmetic, so the kernel is as fast as it
// streams A.  x is read once per row block and stays in L2.
//
// What the design does about it: it keeps the paper's D concurrent
// streams, on common.cuh's row_sweep.  The rows are split into D
// segments of seg = rows / D; block j owns the row slots j*bm ... j*bm + bm - 1 of every segment, one warp
// per slot.  On the TPU one f32 (D, bm) accumulator was carried across
// the sequential column grid; on Hopper that grid becomes a loop inside
// the warp.  In each column step the warp starts the loads of the D rows
// r + k*seg (k = 0..D-1) over the step's P 128-element sub-portions
// (load_stream_step, in the config's arrangement) before any multiply-
// add: D * P independent loads in flight per lane.  Each lane keeps one
// f32 partial per stream; a warp shuffle tree sums them at the end and
// lane 0 stores the D results.  At most SWEEP_KMAX streams and
// SWEEP_PMAX sub-portions are held in registers at a time: a larger D is
// walked in groups of SWEEP_KMAX rows, a larger P in groups of
// SWEEP_PMAX sub-portions.
//
// The multiply-adds run in one fixed order (stream, sub-portion,
// element), whatever the arrangement, so the grouped and interleaved
// arrangements give the same bits.  Against the plain version (a
// vectorised sum in another order) the result agrees within f32
// reassociation error, n * 2^-24 * sum_j |A[i, j] * x[j]| per element.
#include "common.cuh"

namespace {

constexpr int KMAX = SWEEP_KMAX, PMAX = SWEEP_PMAX;

// The row-dot body of row_sweep: one f32 partial per stream and lane,
// summed over the warp at the end of the row.
template <typename T>
struct RowDot {
  const T* A;
  const T* x;
  T* y;
  int cols;
  float acc[KMAX];

  __device__ __forceinline__ void begin(int) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
  }

  __device__ __forceinline__ void step(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane) {
    float a[KMAX][PMAX][4];
    load_stream_step<T, KMAX, PMAX>(A, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, a);
    float xv[PMAX][4];
#pragma unroll
    for (int p = 0; p < PMAX; ++p)
      if (p < np) load_f32<T, 4>(x + c0 + p * SUB + lane * 4, xv[p]);
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p < np) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[k] = fmaf(a[k][p][e], xv[p][e], acc[k]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void end(int rk, int seg, int nk, int lane) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        float s = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) y[rk + k * seg] = Cvt<T>::from(s);
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
rowdot(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
       int cols, int d, int seg, int bm, int ns, bool interleaved) {
  RowDot<T> body{A, x, y, cols};
  row_sweep(cols, d, seg, bm, ns, interleaved, body);
}

template <typename T>
int launch(const void* A, const void* x, void* y, int rows, int cols, int d,
           int bm, int ns, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  rowdot<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(x), static_cast<T*>(y),
      cols, d, seg, bm, ns, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: [rows, cols] of the element type `dtype`, row-major; x: [cols];
// y: [rows] of `dtype`.  d streams of seg = rows / d rows, bm row slots
// per block; column steps of ns 128-element sub-portions, loaded grouped
// (interleaved = 0) or interleaved (1).  cols must be a multiple of 128.
extern "C" int rowdot_launch(int dtype, const void* A, const void* x,
                             void* y, int rows, int cols, int d, int bm,
                             int ns, int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(A, x, y, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return launch<__nv_bfloat16>(A, x, y, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return launch<__half>(A, x, y, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
