// Multi-strided row reductions for Hopper (sm_90a): the row-dot
// (matrix-vector product) and the row statistics (max and sum).
//
// Replaces these instances of the JAX package's K2 template,
// _emit_reduction (src/repro/codegen/emit.py:491):
//   * mxv, bicg_q and gemver_mxv2 (src/repro/kernels/{mxv,bicg,gemver}/
//     specs.py), the row-dot RowDot:
//       y[i] = s * sum_j f32(A[i, j]) * f32(x[j]),  stored in A's dtype,
//     with s = 1 for mxv and bicg_q and s = alpha for gemver_mxv2 (an f32
//     argument, or read from a 0-d f32 on the card: no host sync);
//   * rowstat (src/repro/kernels/gen/__init__.py:65), RowStat: the row
//     max and the row sum of x in one sweep, two f32 outputs with their
//     own combinators (reduce=("max", "sum")).
//
// What bounds them: bytes.  Every element of A (x) is read once for one
// multiply-add (a max and an add), far below the card's ~20 flops per
// byte of f32 arithmetic, so the kernels are as fast as they stream A.
// x (of the row-dot) is read once per row block and stays in L2.
//
// What the design does about it: it keeps the paper's D concurrent
// streams, on common.cuh's row_sweep.  The rows are split into D
// segments of seg = rows / D; block j owns the row slots j*bm ... j*bm + bm - 1 of every segment, one warp
// per slot.  On the TPU one f32 (D, bm) accumulator was carried across
// the sequential column grid; on Hopper that grid becomes a loop inside
// the warp.  In each column step the warp starts the loads of the D rows
// r + k*seg (k = 0..D-1) over the step's P 128-element sub-portions
// (load_stream_step, in the config's arrangement) before any arithmetic:
// D * P independent loads in flight per lane.  Each lane keeps one f32
// partial per stream (RowStat: a max and a sum); a warp shuffle tree
// merges them at the end and lane 0 stores the D results.  At most
// SWEEP_KMAX streams and SWEEP_PMAX sub-portions are held in registers at
// a time: a larger D is walked in groups of SWEEP_KMAX rows, a larger P
// in groups of SWEEP_PMAX sub-portions.
//
// The arithmetic runs in one fixed order (stream, sub-portion, element),
// whatever the arrangement, so the grouped and interleaved arrangements
// give the same bits.  The max is exact (it propagates a NaN, as torch's
// amax does).  Against the plain version (a vectorised f32 sum in
// another order) the row-dot agrees within f32 reassociation error,
// n * 2^-24 * sum_j |A[i, j] * x[j]| per element; the row sum, taken in
// f64 and rounded once, within the plain version's own f32 error.
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
  const float* scale_ptr;   // read at the end of a row, from the card
  float scale;              // used where scale_ptr is null
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
    const float sc = scale_ptr ? *scale_ptr : scale;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        float s = acc[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) y[rk + k * seg] = Cvt<T>::from(sc * s);
      }
    }
  }
};

// max that propagates a NaN (as torch.amax): once m is NaN it stays NaN
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// The row-statistics body of row_sweep: a running max and sum per
// stream and lane, merged over the warp at the end of the row.  The sum
// accumulates in f64 (the card's f64 adds cost nothing against the
// bytes) and rounds once to f32, so its only error is that rounding.
// STAT_KMAX streams a pass: the f64 sums take two registers each.
constexpr int STAT_KMAX = 4;

template <typename T>
struct RowStat {
  const T* x;
  float* mx;
  float* sm;
  int cols;
  float vmax[STAT_KMAX];
  double vsum[STAT_KMAX];

  __device__ __forceinline__ void begin(int) {
#pragma unroll
    for (int k = 0; k < STAT_KMAX; ++k) {
      vmax[k] = __uint_as_float(0xff800000u);   // -inf
      vsum[k] = 0.0;
    }
  }

  __device__ __forceinline__ void step(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane) {
    float a[STAT_KMAX][PMAX][4];
    load_stream_step<T, STAT_KMAX, PMAX>(x, cols, rk, seg, nk, c0, np,
                                         interleaved, lane, a);
#pragma unroll
    for (int k = 0; k < STAT_KMAX; ++k) {
      if (k < nk) {
#pragma unroll
        for (int p = 0; p < PMAX; ++p) {
          if (p < np) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              vmax[k] = nan_max(vmax[k], a[k][p][e]);
              vsum[k] += a[k][p][e];
            }
          }
        }
      }
    }
  }

  __device__ __forceinline__ void end(int rk, int seg, int nk, int lane) {
#pragma unroll
    for (int k = 0; k < STAT_KMAX; ++k) {
      if (k < nk) {
        float m = vmax[k];
        double s = vsum[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
          s += __shfl_xor_sync(0xffffffffu, s, off);
        }
        if (lane == 0) {
          mx[rk + k * seg] = m;
          sm[rk + k * seg] = static_cast<float>(s);
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
rowdot(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
       const float* __restrict__ scale_ptr, float scale, int cols, int d,
       int seg, int bm, int ns, bool interleaved) {
  RowDot<T> body{A, x, y, cols, scale_ptr, scale};
  row_sweep(cols, d, seg, bm, ns, interleaved, body);
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
rowstat(const T* __restrict__ x, float* __restrict__ mx,
        float* __restrict__ sm, int cols, int d, int seg, int bm, int ns,
        bool interleaved) {
  RowStat<T> body{x, mx, sm, cols};
  row_sweep<RowStat<T>, STAT_KMAX>(cols, d, seg, bm, ns, interleaved, body);
}

template <typename T>
int launch(const void* A, const void* x, void* y, const void* scale_ptr,
           float scale, int rows, int cols, int d, int bm, int ns,
           int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  rowdot<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(scale_ptr), scale, cols, d, seg, bm, ns,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stat(const void* x, void* mx, void* sm, int rows, int cols,
                int d, int bm, int ns, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  rowstat<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(mx),
      static_cast<float*>(sm), cols, d, seg, bm, ns, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: [rows, cols] of the element type `dtype`, row-major; x: [cols];
// y: [rows] of `dtype`, scaled by *scale_ptr (an f32 on the card) where
// scale_ptr is not null, else by scale.  d streams of seg = rows / d
// rows, bm row slots per block; column steps of ns 128-element
// sub-portions, loaded grouped (interleaved = 0) or interleaved (1).
// cols must be a multiple of 128.
extern "C" int rowdot_launch(int dtype, const void* A, const void* x,
                             void* y, const void* scale_ptr, float scale,
                             int rows, int cols, int d, int bm, int ns,
                             int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(A, x, y, scale_ptr, scale, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return launch<__nv_bfloat16>(A, x, y, scale_ptr, scale, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return launch<__half>(A, x, y, scale_ptr, scale, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: [rows, cols] of `dtype`, row-major; mx, sm: [rows] f32, the row max
// and the row sum.  The geometry as rowdot_launch's.
extern "C" int rowstat_launch(int dtype, const void* x, void* mx, void* sm,
                              int rows, int cols, int d, int bm, int ns,
                              int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_stat<float>(x, mx, sm, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return launch_stat<__nv_bfloat16>(x, mx, sm, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return launch_stat<__half>(x, mx, sm, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
