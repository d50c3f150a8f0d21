// Multi-strided column-dot (transposed matrix-vector product) for Hopper
// (sm_90a), in one launch.
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
// merged the D streams' partial rows into it.  Here:
//   * A column block is 128 columns; a thread owns 16 bytes of them (4
//     f32 or 8 bf16 / f16 columns), so a block of 128 threads is CT = 32
//     (f32) or 16 column threads by R = 4 or 8 row groups.
//   * The D streams are loads in flight inside a block.  The rows are D
//     segments of seg = rows / D; a step of a row group is U = 8 / K
//     consecutive slots (segment rows) of K streams (K the smallest
//     power of two up to D, at most 8; D > 8 walks groups of 8), the
//     K * U rows k * seg + slot, 8 loads of 16 bytes a thread.  Each
//     thread issues the next step's loads before it folds the current
//     one (two steps, 16 loads, in registers), and folds a step slot by
//     slot, stream k = 0 ... K-1 within a slot, into one f32 partial per
//     column: not one per stream.  Row group g takes the steps g, g + R,
//     ... of its rank's slots; the row groups' partials are added in
//     group order through shared memory and scaled by s (the body's
//     scalar applies to each partial, as the TPU kernel applied it to
//     each block).
//   * The merge without a second launch.  The cs blocks of a column
//     block (cs a power of two up to 8, picked by kernels/mxv/kernel.py
//     geometry so the grid is about two blocks an SM and its clusters
//     all resident at once, as the occupancy API counts them) form a
//     thread-block cluster; rank r takes slots r * spr ... of every
//     segment.  Its scaled partial row stays in its shared memory; after
//     one cluster barrier rank r folds its 128 / cs columns from every
//     rank, in rank order, through distributed shared memory, and stores
//     y; a second barrier keeps every rank's shared memory alive until
//     the others have read it.  The fold's order is fixed, so y's bits
//     repeat from run to run.
//   * gemver_mxv1_sum's total.  Rank 0 of each cluster also sums its
//     column block's 128 f32 entries (each refolded in rank order, so
//     the same bits as the y it adds) in a fixed order: lane l of warp 0
//     takes columns l, l + 32, l + 64, l + 96 in order, then a shuffle
//     tree (xor 16, 8, 4, 2, 1); it writes csum[cb], and takes a ticket
//     from a per-device, per-stream counter that the caller zeroed once.
//     The last cluster folds the ncb column sums in the same lane / tree
//     order into the total and resets the counter to 0 for the next call
//     (or graph replay).  Atomics touch the counter only, never a value.
// The order of the sum thus differs from the TPU's and the plain
// version's only by f32 reassociation within a rank: the plain version
// sums each rank's rows with the spec body and folds the cs partial rows
// in rank order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;      // a block
constexpr int COLS = 128;         // columns of a column block
constexpr int LOADS = 8;          // 16-byte loads a thread a step (K * U)
constexpr int MAX_CLUSTER = 8;    // portable cluster size

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One thread's loads of one step: K streams x U slots, row k * seg + slot.
template <typename T, int K>
struct Step {
  static constexpr int U = LOADS / K;
  uint4 a[K][U];
  T xv[K][U];
};

template <typename T, int K, bool TOTAL>
__global__ void __launch_bounds__(THREADS, 4)
coldot(const T* __restrict__ A, const T* __restrict__ x, void* __restrict__ y,
       float* __restrict__ csum, float* __restrict__ total,
       int* __restrict__ ticket, const float* __restrict__ scale_ptr,
       float scale, int cols, int d, int seg, int spr, int cs) {
  constexpr int EPL = 16 / static_cast<int>(sizeof(T));   // columns a thread
  constexpr int CT = COLS / EPL;                           // column threads
  constexpr int R = THREADS / CT;                          // row groups
  constexpr int U = LOADS / K;
  __shared__ __align__(16) float red[R][COLS];
  __shared__ float cpart[COLS];
  __shared__ int last;

  const int rank = blockIdx.x % cs, cb = blockIdx.x / cs;
  const int ct = threadIdx.x % CT, g = threadIdx.x / CT;
  const int c = cb * COLS + ct * EPL;                     // this thread's columns
  const int lo = rank * spr, hi = min(seg, lo + spr);
  const int groups = (d + K - 1) / K;
  // step s of row group g: slots lo + (g + (s / groups) * R) * U ..., streams
  // from (s % groups) * K
  auto base = [&](int s) { return lo + (g + (s / groups) * R) * U; };
  auto load = [&](int s, Step<T, K>& st) {
    const int sb = base(s), k0 = (s % groups) * K;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const bool ok = k0 + k < d && sb + j < hi;
        const size_t row = static_cast<size_t>(k0 + k) * seg + sb + j;
        st.a[k][j] = ok ? __ldg(reinterpret_cast<const uint4*>(A + row * cols + c))
                        : make_uint4(0u, 0u, 0u, 0u);
        st.xv[k][j] = ok ? x[row] : Cvt<T>::from(0.f);
      }
  };
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  auto fold = [&](const Step<T, K>& st) {
#pragma unroll
    for (int j = 0; j < U; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float xf = Cvt<T>::to(st.xv[k][j]);
        const uint32_t w[4] = {st.a[k][j].x, st.a[k][j].y, st.a[k][j].z,
                               st.a[k][j].w};
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[e] = fmaf(xf, Cvt<T>::get(w, e), acc[e]);
      }
  };

  // two steps in registers: the next one's loads are in flight while the
  // current one is folded
  Step<T, K> p, q;
  int s = 0;
  if (base(s) < hi) load(s, p);
  while (base(s) < hi) {
    if (base(s + 1) < hi) load(s + 1, q);
    fold(p);
    if (base(s + 1) >= hi) break;
    if (base(s + 2) < hi) load(s + 2, p);
    fold(q);
    s += 2;
  }

#pragma unroll
  for (int e = 0; e < EPL; ++e) red[g][ct * EPL + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < COLS) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) sum += red[i][threadIdx.x];
    cpart[threadIdx.x] = (scale_ptr ? *scale_ptr : scale) * sum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  // rank r's columns of y, each folded over the ranks in rank order
  auto entry = [&](int col) {
    float v = 0.f;
    for (int r = 0; r < cs; ++r)
      v += cs > 1 ? *cluster.map_shared_rank(&cpart[col], r) : cpart[col];
    return v;
  };
  const int per = COLS / cs;
  if (threadIdx.x < per) {
    const int col = rank * per + threadIdx.x;
    const float v = entry(col);
    if constexpr (TOTAL)
      static_cast<float*>(y)[cb * COLS + col] = v;
    else
      static_cast<T*>(y)[cb * COLS + col] = Cvt<T>::from(v);
  }
  if constexpr (TOTAL) {
    const int lane = threadIdx.x & 31;
    if (rank == 0 && threadIdx.x < 32) {
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < COLS / 32; ++i) v += entry(lane + 32 * i);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) {
        csum[cb] = v;
        __threadfence();
        last = atomicAdd(ticket, 1) == gridDim.x / cs - 1;
      }
      __syncwarp();
      if (last) {                       // every column sum is written
        __threadfence();
        const int ncb = gridDim.x / cs;
        float t = 0.f;
        for (int i = lane; i < ncb; i += 32) t += __ldcg(csum + i);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          t += __shfl_xor_sync(0xffffffffu, t, off);
        if (lane == 0) {
          *total = t;
          atomicExch(ticket, 0);
        }
      }
    }
  }
  if (cs > 1) {                         // no rank leaves while read
    cluster_arrive();
    cluster_wait();
  }
}

template <typename T, int K, bool TOTAL>
int launch_k(const void* A, const void* x, void* y, void* csum, void* total,
             void* ticket, const void* scale_ptr, float scale, int cols,
             int d, int seg, int spr, int cs, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cols / COLS) * cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, coldot<T, K, TOTAL>, static_cast<const T*>(A),
      static_cast<const T*>(x), y, static_cast<float*>(csum),
      static_cast<float*>(total), static_cast<int*>(ticket),
      static_cast<const float*>(scale_ptr), scale, cols, d, seg, spr, cs);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K: the smallest power of two up to d, at most 8 (kernel.py geometry)
template <typename T, bool TOTAL>
int launch_t(const void* A, const void* x, void* y, void* csum, void* total,
             void* ticket, const void* scale_ptr, float scale, int rows,
             int cols, int d, int spr, int cs, cudaStream_t st) {
  if (rows <= 0 || cols <= 0 || d <= 0 || rows % d != 0 ||
      cols % COLS != 0 || cs < 1 || cs > MAX_CLUSTER || (cs & (cs - 1)) ||
      spr <= 0 || static_cast<long long>(spr) * cs < rows / d ||
      (TOTAL && (!csum || !total || !ticket)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  if (d > 4) return launch_k<T, 8, TOTAL>(A, x, y, csum, total, ticket, scale_ptr, scale, cols, d, seg, spr, cs, st);
  if (d > 2) return launch_k<T, 4, TOTAL>(A, x, y, csum, total, ticket, scale_ptr, scale, cols, d, seg, spr, cs, st);
  if (d > 1) return launch_k<T, 2, TOTAL>(A, x, y, csum, total, ticket, scale_ptr, scale, cols, d, seg, spr, cs, st);
  return launch_k<T, 1, TOTAL>(A, x, y, csum, total, ticket, scale_ptr, scale, cols, d, seg, spr, cs, st);
}

template <typename T, int K>
int clusters_k(int cs, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * 1024);
  cfg.blockDim = dim3(THREADS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(n, coldot<T, K, false>, &cfg));
}

}  // namespace

// y[j] = s * sum_i x[i] A[i, j].  A: [rows, cols] of `dtype`, row-major,
// 16-byte aligned, cols a multiple of 128; x: [rows]; y: [cols] of
// `dtype`, or f32 where csum, total and ticket are given (gemver_mxv1_sum:
// csum [cols / 128] f32 scratch, total [1] f32, ticket an int that is 0
// and is left 0).  s = *scale_ptr (an f32 on the card) where scale_ptr is
// not null, else scale.  d streams of rows / d rows; clusters of cs
// blocks (1, 2, 4, 8), rank r taking slots r * spr ... of every segment.
extern "C" int coldot_launch(int dtype, const void* A, const void* x, void* y,
                             void* csum, void* total, void* ticket,
                             const void* scale_ptr, float scale, int rows,
                             int cols, int d, int spr, int cs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (csum) {
    if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (dtype) {
      case kF32: return launch_t<float, true>(A, x, y, csum, total, ticket, scale_ptr, scale, rows, cols, d, spr, cs, st);
      case kBF16: return launch_t<__nv_bfloat16, true>(A, x, y, csum, total, ticket, scale_ptr, scale, rows, cols, d, spr, cs, st);
      default: return launch_t<__half, true>(A, x, y, csum, total, ticket, scale_ptr, scale, rows, cols, d, spr, cs, st);
    }
  }
  switch (dtype) {
    case kF32: return launch_t<float, false>(A, x, y, nullptr, nullptr, nullptr, scale_ptr, scale, rows, cols, d, spr, cs, st);
    case kBF16: return launch_t<__nv_bfloat16, false>(A, x, y, nullptr, nullptr, nullptr, scale_ptr, scale, rows, cols, d, spr, cs, st);
    case kF16: return launch_t<__half, false>(A, x, y, nullptr, nullptr, nullptr, scale_ptr, scale, rows, cols, d, spr, cs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of cs blocks of the f32 / 16-bit instance for d streams that
// the card keeps resident at once (cudaOccupancyMaxActiveClusters), into
// *n.
extern "C" int coldot_clusters(int dtype, int d, int cs, int* n) {
  if (cs < 1 || cs > MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  if (d > 4) return f32 ? clusters_k<float, 8>(cs, n) : clusters_k<__nv_bfloat16, 8>(cs, n);
  if (d > 2) return f32 ? clusters_k<float, 4>(cs, n) : clusters_k<__nv_bfloat16, 4>(cs, n);
  if (d > 1) return f32 ? clusters_k<float, 2>(cs, n) : clusters_k<__nv_bfloat16, 2>(cs, n);
  return f32 ? clusters_k<float, 1>(cs, n) : clusters_k<__nv_bfloat16, 1>(cs, n);
}
