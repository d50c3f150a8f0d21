// Multi-strided 2-D stencils for Hopper (sm_90a): the Jacobi 5-point
// sweep and the 3x3 correlation (instances of K1).
//
// Replaces the jacobi2d and conv3x3 instances of the JAX package's K1
// template, _emit_streaming (src/repro/codegen/emit.py:410), whose bodies
// are src/repro/kernels/jacobi2d/specs.py and conv3x3/specs.py, over
// x [rows + 2, cols + 2] -> o [rows, cols]:
//   jacobi2d: o[i, j] = 0.2f * ((((c + l) + r) + u) + b), with c the
//             centre x[i+1, j+1], l, r its row neighbours x[i+1, j],
//             x[i+1, j+2], u, b its column neighbours x[i, j+1], x[i+2, j+1]
//   conv3x3:  o[i, j] = sum of w[r][c] * x[i + r, j + c] over (r, c) in
//             row-major order, starting from w[0][0]'s product
// in f32, each product and each sum rounded to f32 as the body rounds
// it (__fmul_rn and __fadd_rn, never a fused multiply-add), and rounded
// once to T at the store: both equal their plain versions bit for bit
// in every dtype.  The nine weights arrive as an f32 [9] array on the
// card, as the TPU kernel reads its scalars from (1, 1) memory blocks.
//
// What bounds them: bytes.  Each input element is read once and each
// output element written once; jacobi2d does 5 flops a point and
// conv3x3 17, about 0.6 and 2.1 flops per f32 byte moved, against the
// card's 20 flops per byte of f32 arithmetic.
//
// What the design does about it.  The TPU kernel lowers the row halo as
// one-row blocks: each of the D row streams loads its three tap rows
// i + k*seg + t, t = 0, 1, 2 (emit.py:186-215), and a column halo keeps
// whole rows, cols = w - 2 wide, in one block.  Here the rows are split
// into D segments of seg = rows / D; block (tile, run) owns TILE output
// columns and `run` rows of every segment, one thread per column.  A
// thread keeps, for each stream, the three taps (columns j, j+1, j+2) of
// the two previous input rows in registers, so each step loads one new
// input row per stream and issues the loads of all the streams of its
// group (at most GMAX) before it computes any output: D * 3 loads in
// flight a thread.  A run opens with a prologue of two tap rows per
// stream.  The loads are of one element (4 bytes in f32): a row of
// cols + 2 elements (130 f32: 520 B) is not 16-byte aligned, so there is
// no vector load, but the loads of a warp span one contiguous row piece,
// and the shifted taps of neighbouring threads hit L1.  Any cols is taken
// (126, 128, 2046, ...); the last tile masks its idle threads.
//
// At 16386 x 16384 f32, whose 64 KiB row pitch starts every row at the
// same alignment, it takes about twice its byte bound (1.26 ms against
// 0.641 at D = 4 on an H100 at 700 W, chip_smoke.py), and there more
// streams help (1.57 ms at D = 1, 1.11 at D = 8); chip_smoke.py's sweep
// measures the same shapes at a row pitch of 16386 elements beside it.
#include "common.cuh"

namespace {

constexpr int TILE = 256;      // output columns (threads) of a block
constexpr int GMAX = 8;        // streams a thread keeps in registers

struct JacobiBody {
  __device__ __forceinline__ void init(const float*) {}

  // a, b, c: the taps (columns j, j+1, j+2) of input rows i, i+1, i+2
  __device__ __forceinline__ float operator()(const float (&a)[3],
                                              const float (&b)[3],
                                              const float (&c)[3]) const {
    float s = __fadd_rn(b[1], b[0]);
    s = __fadd_rn(s, b[2]);
    s = __fadd_rn(s, a[1]);
    s = __fadd_rn(s, c[1]);
    return __fmul_rn(0.2f, s);
  }
};

struct ConvBody {
  float w[9];

  __device__ __forceinline__ void init(const float* __restrict__ w9) {
#pragma unroll
    for (int q = 0; q < 9; ++q) w[q] = __ldg(w9 + q);
  }

  __device__ __forceinline__ float operator()(const float (&a)[3],
                                              const float (&b)[3],
                                              const float (&c)[3]) const {
    float acc = __fmul_rn(w[0], a[0]);
    acc = __fadd_rn(acc, __fmul_rn(w[1], a[1]));
    acc = __fadd_rn(acc, __fmul_rn(w[2], a[2]));
    acc = __fadd_rn(acc, __fmul_rn(w[3], b[0]));
    acc = __fadd_rn(acc, __fmul_rn(w[4], b[1]));
    acc = __fadd_rn(acc, __fmul_rn(w[5], b[2]));
    acc = __fadd_rn(acc, __fmul_rn(w[6], c[0]));
    acc = __fadd_rn(acc, __fmul_rn(w[7], c[1]));
    acc = __fadd_rn(acc, __fmul_rn(w[8], c[2]));
    return acc;
  }
};

// the taps x[row, j], x[row, j+1], x[row, j+2], widened to f32
template <typename T>
__device__ __forceinline__ void load_taps(const T* p, float (&f)[3]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) load_f32<T, 1>(p + q, &f[q]);
}

template <typename T, int G, typename Body>
__global__ void __launch_bounds__(TILE)
stencil(const T* __restrict__ x, const float* __restrict__ w9,
        T* __restrict__ o, int cols, int d, int seg, int run) {
  const int j = blockIdx.x * TILE + threadIdx.x;
  if (j >= cols) return;
  Body body;
  body.init(w9);
  const size_t wx = static_cast<size_t>(cols) + 2;
  const int t0 = blockIdx.y * run, t1 = min(seg, t0 + run);
  const T* xj = x + j;
  for (int k0 = 0; k0 < d; k0 += G) {
    const int nk = min(G, d - k0);
    float a[G][3], b[G][3];
#pragma unroll
    for (int k = 0; k < G; ++k) {          // prologue: two tap rows
      if (k < nk) {
        const T* p = xj + static_cast<size_t>((k0 + k) * seg + t0) * wx;
        load_taps<T>(p, a[k]);
        load_taps<T>(p + wx, b[k]);
      }
    }
    for (int t = t0; t < t1; ++t) {
      float c[G][3];
#pragma unroll
      for (int k = 0; k < G; ++k)          // every stream's new tap row
        if (k < nk)
          load_taps<T>(xj + static_cast<size_t>((k0 + k) * seg + t + 2) * wx,
                       c[k]);
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (k < nk) {
          o[static_cast<size_t>((k0 + k) * seg + t) * cols + j] =
              Cvt<T>::from(body(a[k], b[k], c[k]));
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            a[k][q] = b[k][q];
            b[k][q] = c[k][q];
          }
        }
      }
    }
  }
}

template <typename T, typename Body>
int launch(const void* x, const void* w9, void* o, int rows, int cols,
           int d, int run, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || run <= 0 || rows % d != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  const int runs = (seg + run - 1) / run;
  if (runs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + TILE - 1) / TILE, runs);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w9);
  T* op = static_cast<T*>(o);
  // streams in groups of the least power of two >= min(d, GMAX)
  if (d >= 5) {
    stencil<T, GMAX, Body><<<grid, TILE, 0, stream>>>(xp, wp, op, cols, d, seg, run);
  } else if (d >= 3) {
    stencil<T, 4, Body><<<grid, TILE, 0, stream>>>(xp, wp, op, cols, d, seg, run);
  } else if (d == 2) {
    stencil<T, 2, Body><<<grid, TILE, 0, stream>>>(xp, wp, op, cols, d, seg, run);
  } else {
    stencil<T, 1, Body><<<grid, TILE, 0, stream>>>(xp, wp, op, cols, d, seg, run);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows + 2, cols + 2] of `dtype`, row-major; o: [rows, cols].  d
// streams of seg = rows / d output rows, each cut into runs of `run`
// rows (the last may be short); any cols, any alignment of a row.
extern "C" int jacobi2d_launch(int dtype, const void* x, void* o, int rows,
                               int cols, int d, int run, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float, JacobiBody>(x, nullptr, o, rows, cols, d, run, st);
    case kBF16: return launch<__nv_bfloat16, JacobiBody>(x, nullptr, o, rows, cols, d, run, st);
    case kF16: return launch<__half, JacobiBody>(x, nullptr, o, rows, cols, d, run, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry of jacobi2d_launch; w9: the nine weights, f32 [9] on the
// card, w[0][0] first.
extern "C" int conv3x3_launch(int dtype, const void* x, const void* w9,
                              void* o, int rows, int cols, int d, int run,
                              void* stream) {
  if (w9 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float, ConvBody>(x, w9, o, rows, cols, d, run, st);
    case kBF16: return launch<__nv_bfloat16, ConvBody>(x, w9, o, rows, cols, d, run, st);
    case kF16: return launch<__half, ConvBody>(x, w9, o, rows, cols, d, run, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
