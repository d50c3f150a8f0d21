// Multi-strided column-dot (transposed matrix-vector product) for Hopper
// (sm_90a), in two passes.
//
// Replaces these instances of the JAX package's K3 template,
// _emit_stream_reduction (src/repro/codegen/emit.py:564):
//   * mxv_t and bicg_s (src/repro/kernels/{mxv,bicg}/specs.py) and
//     gemver_mxv1 (src/repro/kernels/gemver/specs.py:61), with the "sum"
//     combinator:
//       y[j] = s * sum_i f32(x[i]) * f32(A[i, j]),  stored in A's dtype,
//     with s = 1 for mxv_t and bicg_s and s = beta for gemver_mxv1 (an f32
//     argument, or read from a 0-d f32 on the card: no host sync);
//   * gemver_mxv1_sum (specs.py:91), whose SumWithTotal combinator (:76)
//     finalizes the same f32 row y AND its total sum_j y[j] from one
//     state: two f32 outputs, [cols] and [1].
// The reduction runs over the stride axis itself: the D streams (row
// segments) are what is summed.
//
// What bounds it: bytes.  Every element of A is read once for one
// multiply-add, far below the card's ~20 flops per byte of f32
// arithmetic, so the kernel is as fast as it streams A.
//
// What the design does about it.  On the TPU one f32 accumulator row was
// carried across a row grid that runs in order, and each grid step
// merged the D streams' partial rows into it.  Hopper blocks run in no
// order, so, as in decode_attn.cu, the D streams become independent
// blocks and the merge a second pass:
//   pass 1 (colsum_split), grid (column blocks, D, row chunks): block
//     (cb, k, c) owns ns * 128 columns of segment k (rows k*seg ...
//     (k+1)*seg - 1), and of that segment the bm-row tiles of chunk c.
//     A thread owns 4 adjacent columns (one 16-byte load a row in f32)
//     and, with R row groups a block, every R-th tile of the chunk; it
//     loads the bm rows of a tile back to back before any multiply-add,
//     bm loads in flight per thread.  The row groups' partials are summed
//     in group order through shared memory, scaled by s (the body's
//     scalar applies to each partial, as the TPU kernel applied it to
//     each block), and the block writes its f32 partial row to
//     part[k * chunks + c].  Row chunks only raise the number of blocks
//     (to about two per SM); their count depends on the shape and the
//     card, not on the data.
//   pass 2 (colsum_merge): y[j] = sum over the D * chunks partial rows,
//     in order k = 0 ... D-1 and, within k, chunk 0 ... chunks-1, then
//     cast to A's dtype.  For gemver_mxv1_sum (colsum_merge_total) y
//     stays f32 and a one-block tail sums it in a fixed order (a strided
//     pass per thread, then a tree over the block): no atomics, so the
//     total's bits repeat from run to run.
// The order of the sum thus differs from the TPU's and the plain
// version's; the result agrees within f32 reassociation error,
// n * 2^-24 * sum_i |x[i] * A[i, j]| per element.
#include "common.cuh"

namespace {

constexpr int RMAX = 8;           // rows of a tile in registers per pass
constexpr int THREADS = 256;      // a block: ns * 32 column threads x R row groups
constexpr int MAX_SUB = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_split(const T* __restrict__ A, const T* __restrict__ x,
             float* __restrict__ part, const float* __restrict__ scale_ptr,
             float scale, int cols, int seg, int bm, int ns, int tpc,
             int chunks) {
  extern __shared__ float red[];                 // [R][ns * 32][4]
  const int nct = ns * 32;                       // column threads
  const int R = blockDim.x / nct;                // row groups
  const int ct = threadIdx.x % nct, rg = threadIdx.x / nct;
  const int c = (blockIdx.x * nct + ct) * 4;     // this thread's columns
  const bool active = c < cols;
  const int k = blockIdx.y, chunk = blockIdx.z;
  const int tiles = seg / bm;
  const int t0 = chunk * tpc, t1 = min(tiles, t0 + tpc);
  const size_t row0 = static_cast<size_t>(k) * seg;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
    for (int t = t0 + rg; t < t1; t += R) {
      for (int i0 = 0; i0 < bm; i0 += RMAX) {
        const int nr = min(RMAX, bm - i0);
        const size_t r = row0 + static_cast<size_t>(t) * bm + i0;
        float a[RMAX][4], xs[RMAX];
#pragma unroll
        for (int i = 0; i < RMAX; ++i)             // the tile's rows, back to back
          if (i < nr) load_f32<T, 4>(A + (r + i) * cols + c, a[i]);
#pragma unroll
        for (int i = 0; i < RMAX; ++i)
          if (i < nr) xs[i] = Cvt<T>::to(x[r + i]);
#pragma unroll
        for (int i = 0; i < RMAX; ++i) {
          if (i < nr) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[e] = fmaf(xs[i], a[i][e], acc[e]);
          }
        }
      }
    }
  }
  float* mine = red + (static_cast<size_t>(rg) * nct + ct) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) mine[e] = acc[e];
  __syncthreads();
  if (rg == 0 && active) {
    for (int g = 1; g < R; ++g) {
      const float* o = red + (static_cast<size_t>(g) * nct + ct) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += o[e];
    }
    const float sc = scale_ptr ? *scale_ptr : scale;
    float* dst = part + (static_cast<size_t>(k) * chunks + chunk) * cols + c;
    *reinterpret_cast<float4*>(dst) =
        make_float4(sc * acc[0], sc * acc[1], sc * acc[2], sc * acc[3]);
  }
}

template <typename T>
__global__ void colsum_merge(const float* __restrict__ part, T* __restrict__ y,
                             int cols, int nparts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cols) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += part[static_cast<size_t>(p) * cols + j];
  y[j] = Cvt<T>::from(s);
}

// The total of an f32 row in one block of TOTAL_THREADS threads, in a
// fixed order: thread t sums y[t], y[t + TOTAL_THREADS], ... in order,
// then a tree over the block's partials, pairs at a halving distance.
constexpr int TOTAL_THREADS = 1024;

__global__ void __launch_bounds__(TOTAL_THREADS)
row_total(const float* __restrict__ y, float* __restrict__ total, int cols) {
  __shared__ float red[TOTAL_THREADS];
  float s = 0.f;
  for (int j = threadIdx.x; j < cols; j += TOTAL_THREADS) s += y[j];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int half = TOTAL_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = red[0];
}

template <typename T>
int split_t(const void* A, const void* x, void* part, const void* scale_ptr,
            float scale, int rows, int cols, int d, int bm, int ns, int tpc,
            int chunks, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || ns <= 0 || tpc <= 0 ||
      chunks <= 0 || rows % d != 0 || (rows / d) % bm != 0 ||
      cols % SUB != 0 || ns > MAX_SUB || chunks > 65535 ||
      d > 65535 || static_cast<long long>(chunks - 1) * tpc >= (rows / d) / bm ||
      static_cast<long long>(chunks) * tpc < (rows / d) / bm)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nct = ns * 32;
  const int R = THREADS / nct;
  const int threads = nct * R;
  const size_t smem = static_cast<size_t>(threads) * 4 * sizeof(float);
  const int ncb = (cols / SUB + ns - 1) / ns;
  colsum_split<T><<<dim3(ncb, d, chunks), threads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(x),
      static_cast<float*>(part), static_cast<const float*>(scale_ptr), scale,
      cols, rows / d, bm, ns, tpc, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int merge_t(const void* part, void* y, int cols, int nparts,
            cudaStream_t stream) {
  if (cols <= 0 || nparts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  colsum_merge<T><<<(cols + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(y), cols, nparts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1.  A: [rows, cols] of `dtype`, row-major; x: [rows]; part:
// [d * chunks, cols] f32, each partial row scaled by *scale_ptr (an f32
// on the card) where scale_ptr is not null, else by scale.  d streams of
// seg = rows / d rows in bm-row tiles, chunk c taking tiles c*tpc ...
// min((c+1)*tpc, seg/bm) - 1 (none empty); column blocks of ns * 128
// columns, ns <= 8.  cols a multiple of 128.
extern "C" int colsum_split_launch(int dtype, const void* A, const void* x,
                                   void* part, const void* scale_ptr,
                                   float scale, int rows, int cols, int d,
                                   int bm, int ns, int tpc, int chunks,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return split_t<float>(A, x, part, scale_ptr, scale, rows, cols, d, bm, ns, tpc, chunks, st);
    case kBF16: return split_t<__nv_bfloat16>(A, x, part, scale_ptr, scale, rows, cols, d, bm, ns, tpc, chunks, st);
    case kF16: return split_t<__half>(A, x, part, scale_ptr, scale, rows, cols, d, bm, ns, tpc, chunks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2.  part: [nparts, cols] f32; y: [cols] of `dtype`.
extern "C" int colsum_merge_launch(int dtype, const void* part, void* y,
                                   int cols, int nparts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return merge_t<float>(part, y, cols, nparts, st);
    case kBF16: return merge_t<__nv_bfloat16>(part, y, cols, nparts, st);
    case kF16: return merge_t<__half>(part, y, cols, nparts, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2 of gemver_mxv1_sum.  part: [nparts, cols] f32; y: [cols] f32;
// total: [1] f32, the sum of y, from y as stored.
extern "C" int colsum_merge_total_launch(const void* part, void* y,
                                         void* total, int cols, int nparts,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = merge_t<float>(part, y, cols, nparts, st);
  if (err) return err;
  row_total<<<1, TOTAL_THREADS, 0, st>>>(static_cast<const float*>(y),
                                         static_cast<float*>(total), cols);
  return static_cast<int>(cudaGetLastError());
}
