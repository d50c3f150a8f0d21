// Multi-strided transpose for Hopper (sm_90a).
//
// Replaces the transpose instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// transpose_spec (src/repro/kernels/gen/__init__.py:84): y = x^T, x
// [rows, cols] -> y [cols, rows], the same element type.  On the TPU each
// of the D streams stored its block through the transposed
// (vector, stride) write map (_plan_writes, emit.py:310) into a
// [cols, d, seg] buffer that was merged after the call; here the kernel
// writes y [cols, rows] directly.
//
// What bounds it: bytes, one read and one write of every element and no
// arithmetic.  What costs is coalescing: the rows of x are x's fast axis
// and the rows of y are x's columns, so a thread cannot both read and
// write neighbouring addresses.
//
// What the design does about it: the paper's D concurrent streams, each
// a row segment (rows k*seg ... (k+1)*seg - 1, seg = rows / d).  Block
// (cb, rb) owns the 32 x 32 tile at columns cb*32 ... and segment rows
// rb*32 ... of EVERY segment.  For a group of up to GMAX segments, its
// 32 x 8 threads load the group's tiles row by row (a warp reads 32
// neighbouring elements of one row of x), all of the group's loads into
// registers before any is used, GMAX * 4 loads in flight a thread; then
// stage them in shared memory, one 32 x 33 tile per segment (the pad
// column puts a tile's column in 32 banks), and store each tile
// transposed, a warp writing 32 neighbouring elements of one row of y.
// It moves bits, so it equals the plain version bit for bit in every
// element type (it copies 4- or 2-byte words, never converting).
#include "common.cuh"

namespace {

constexpr int TILE = 32;          // a tile is TILE x TILE elements
constexpr int TROWS = 8;          // rows of threads: a block is 32 x 8
constexpr int GMAX = 4;           // segments (streams) a block holds at once

template <typename W>             // W: the element's bits (uint32_t, uint16_t)
__global__ void __launch_bounds__(TILE * TROWS)
transpose_k(const W* __restrict__ x, W* __restrict__ y, int rows, int cols,
            int d, int seg) {
  __shared__ W tile[GMAX][TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  for (int k0 = 0; k0 < d; k0 += GMAX) {
    const int nk = min(GMAX, d - k0);
    W v[GMAX][TILE / TROWS];
#pragma unroll
    for (int k = 0; k < GMAX; ++k) {          // every segment's loads first
#pragma unroll
      for (int i = 0; i < TILE / TROWS; ++i) {
        const int r = r0 + ty + i * TROWS, c = c0 + tx;
        if (k < nk && r < seg && c < cols)
          v[k][i] = x[static_cast<size_t>((k0 + k) * seg + r) * cols + c];
      }
    }
#pragma unroll
    for (int k = 0; k < GMAX; ++k)
#pragma unroll
      for (int i = 0; i < TILE / TROWS; ++i)
        if (k < nk) tile[k][ty + i * TROWS][tx] = v[k][i];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GMAX; ++k) {
#pragma unroll
      for (int i = 0; i < TILE / TROWS; ++i) {
        const int c = c0 + ty + i * TROWS, r = r0 + tx;
        if (k < nk && r < seg && c < cols)
          y[static_cast<size_t>(c) * rows + (k0 + k) * seg + r] =
              tile[k][tx][ty + i * TROWS];
      }
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const void* x, void* y, int rows, int cols, int d,
           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || rows % d != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  const dim3 grid((cols + TILE - 1) / TILE, (seg + TILE - 1) / TILE);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  transpose_k<W><<<grid, dim3(TILE, TROWS), 0, stream>>>(
      static_cast<const W*>(x), static_cast<W*>(y), rows, cols, d, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows, cols] of `dtype`, row-major; y: [cols, rows] of `dtype`.
// d streams of seg = rows / d rows (d must divide rows).
extern "C" int transpose_launch(int dtype, const void* x, void* y, int rows,
                                int cols, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<uint32_t>(x, y, rows, cols, d, st);
    case kBF16:
    case kF16: return launch<uint16_t>(x, y, rows, cols, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
