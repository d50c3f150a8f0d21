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
// ~295 flops per byte.  At the decode shape (4 rows of 4096) the 64 KB
// move in far less than a microsecond, so there the bound is latency:
// one DRAM round trip, one reduction and the stores.
//
// What the design does about it.  The paper's D concurrent streams stay:
// the rows are split into D segments of seg = rows / D, and a row slot s
// is the D rows s + k*seg (k = 0..D-1).  A block's unit of work, an
// item, is a slot's rows in a group of K streams, whose loads are issued
// back to back.  The grid is not the plan's seg / bm blocks
// (geometry in kernels/rmsnorm/kernel.py picks it):
//   * Rows in registers.  A thread holds V 16-byte vectors of each of
//     the K rows of an item (K * V = 8; V the fewest that let 128
//     threads cover a row); no row is staged in shared memory.  w is
//     loaded once, beside the first item's loads, into the thread's own
//     slots of shared memory (no other thread reads them, so no
//     barrier), and read back each item: held in registers across
//     items, its widened f32 values would crowd out the two items in
//     flight.
//   * Short runs of items.  A block takes `ipb` consecutive items: one
//     where the items fit in two blocks an SM (4 decode rows of 4096
//     are two items, two blocks on two SMs), else two, the second's
//     loads in flight while the first is reduced, normalised and stored
//     (the loop is unrolled by two).  Items in one block run in series,
//     a round trip to memory and a barrier each, so long runs lose to
//     many short blocks, which the SMs overlap (chip_smoke.py's
//     `rmsnorm sweep` lines time the alternatives).
//   * Long rows: a thread-block cluster.  A row of more vectors than a
//     block's registers hold (256 threads x 8, 32 KB) is cut into `cs`
//     column chunks (2-8), one per block of a cluster.  A block stores
//     its per-stream partial sums of squares into every rank's shared
//     memory (distributed shared memory, stores that are not waited
//     on); after one cluster barrier every block adds the ranks'
//     partials in rank order from its own copy, so every block computes
//     the same inv bit for bit; it normalises its chunk from registers,
//     and rank 0 writes r.  Splitting shorter rows over a cluster, to
//     spread few rows over more SMs, costs a cluster launch and barrier
//     that one block a group of rows does not pay (the sweep times it).
// The sums of squares are taken in f32: a thread's elements in order, a
// warp shuffle tree, the warps in order, the ranks in order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;             // at most, a block
constexpr int WARPS = THREADS / 32;
constexpr int HOLD = 8;                  // 16-byte vectors a thread holds an item
constexpr int MAX_CLUSTER = 8;           // blocks of a cluster (portable size)

// The split cluster barrier (every thread of every block of the
// cluster): arrive (release: this thread's earlier writes, local or
// remote, are visible to the threads that then pass the wait; relaxed:
// no such promise) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(THREADS, 2)
rmsnorm_ms(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, float* __restrict__ r, int nvec, int dm,
           int d, int seg, int ipb, int cs, int chunk, float eps) {
  constexpr int N = 16 / sizeof(T);      // elements a vector
  __shared__ float red[2][WARPS][K];     // warp partials, by item parity
  __shared__ float part[2][MAX_CLUSTER][K];   // every rank's (cs > 1)
  __shared__ uint4 wsm[V * THREADS];     // the thread's own vectors of w
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rank = blockIdx.x % cs;      // the cluster is (cs, 1, 1)
  const int groups = (d + K - 1) / K;
  const int i0 = (blockIdx.x / cs) * ipb;
  const int items = min(seg * groups, i0 + ipb) - i0;
  const int v0 = rank * chunk, v1 = min(nvec, v0 + chunk);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(o);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // item i0 + it: slot (i0 + it) / groups, streams from ((i0 + it) %
  // groups) * K; the row of its stream k (valid where that is below d)
  auto row_of = [&](int it, int k) {
    const int g = i0 + it;
    return g / groups + ((g % groups) * K + k) * seg;
  };
  auto first = [&](int it) { return ((i0 + it) % groups) * K; };
  auto load = [&](int it, uint4 (&b)[K][V]) {
    const int k0 = first(it);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = v0 + threadIdx.x + j * blockDim.x;
        b[k][j] = (k0 + k < d && v < v1)
                      ? __ldg(xv + static_cast<size_t>(row_of(it, k)) * nvec + v)
                      : zero;
      }
  };

  if (cs > 1) cluster_arrive_relaxed();   // waited on before the first push
  uint4 a[K][V], b[K][V];
  load(0, a);
#pragma unroll
  for (int j = 0; j < V; ++j) {          // w once, beside the first loads
    const int v = v0 + threadIdx.x + j * blockDim.x;
    wsm[j * blockDim.x + threadIdx.x] = v < v1 ? __ldg(wv + v) : zero;
  }

  auto process = [&](int it, const uint4 (&q)[K][V], int par) {
    const int nk = min(K, d - first(it));
    float ss[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ss[k] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t wd[4] = {q[k][j].x, q[k][j].y, q[k][j].z, q[k][j].w};
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = Cvt<T>::get(wd, e);
          ss[k] = fmaf(f, f, ss[k]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[par][warp][k] = ss[k];
    }
    __syncthreads();
    float inv[K];
    if (cs == 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float s = 0.f;
        for (int i = 0; i < nwarps; ++i) s += red[par][i][k];
        inv[k] = 1.0f / sqrtf(s / static_cast<float>(dm) + eps);
      }
    } else {
      // the block's partial of stream k goes to slot [rank][k] of every
      // rank's part (remote stores, not waited on), then one cluster
      // barrier makes them visible, and each block adds its own copy in
      // rank order.  Before the first push every block must be running:
      // the wait of the barrier all arrived at on entry.
      cg::cluster_group cluster = cg::this_cluster();
      if (it == 0) cluster_wait();
      if (threadIdx.x < nk) {
        float s = 0.f;
        for (int i = 0; i < nwarps; ++i) s += red[par][i][threadIdx.x];
        for (int c = 0; c < cs; ++c)
          *cluster.map_shared_rank(&part[par][rank][threadIdx.x], c) = s;
      }
      cluster_arrive();
      cluster_wait();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float s = 0.f;
        for (int c = 0; c < cs; ++c) s += part[par][c][k];
        inv[k] = 1.0f / sqrtf(s / static_cast<float>(dm) + eps);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {        // a vector of w, then its rows
      const int v = v0 + threadIdx.x + j * blockDim.x;
      if (v < v1) {
        const uint4 wq = wsm[j * blockDim.x + threadIdx.x];
        const uint32_t ww[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k < nk) {
            const uint32_t xw[4] = {q[k][j].x, q[k][j].y, q[k][j].z, q[k][j].w};
            uint32_t ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < N; ++e)
              Cvt<T>::put(ow, e, (Cvt<T>::get(xw, e) * inv[k]) * Cvt<T>::get(ww, e));
            ov[static_cast<size_t>(row_of(it, k)) * nvec + v] =
                make_uint4(ow[0], ow[1], ow[2], ow[3]);
          }
        }
      }
    }
    if (rank == 0 && threadIdx.x < nk) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (k == threadIdx.x) r[row_of(it, k)] = inv[k];
    }
  };

  // red and part alternate by item parity: item it + 2 rewrites them
  // only after item it + 1's barrier, which every thread (of every rank)
  // reaches after it has read item it's partials.  No rank touches
  // another's shared memory after the last barrier, so a block may
  // leave as soon as it is done.
  for (int it = 0; it < items; it += 2) {
    if (it + 1 < items) load(it + 1, b);
    process(it, a, 0);
    if (it + 1 >= items) break;
    if (it + 2 < items) load(it + 2, a);
    process(it + 1, b, 1);
  }
}

template <typename T, int K, int V>
int launch_kv(const void* x, const void* w, void* o, void* r, int nvec,
              int dm, int d, int seg, int ipb, int cs, int chunk, int grid,
              int threads, float eps, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
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
      &cfg, rmsnorm_ms<T, K, V>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(o), static_cast<float*>(r),
      nvec, dm, d, seg, ipb, cs, chunk, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, void* o, void* r, int rows, int dm,
           int d, int bm, int vecs, int cs, int chunk, int ipb, int grid,
           int threads, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (rows <= 0 || dm <= 0 || d <= 0 || bm <= 0 || rows % d != 0 ||
      dm % N != 0 || (rows / d) % bm != 0 || vecs <= 0 || vecs > HOLD)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d, nvec = dm / N;
  const long long items =
      static_cast<long long>(seg) * ((d + HOLD / vecs - 1) / (HOLD / vecs));
  // what kernel.py geometry gives: whole clusters, every vector of
  // a row in one rank's chunk, every item in one block's run, no run
  // empty (every block of a cluster passes the same barriers)
  if (cs < 1 || cs > MAX_CLUSTER || grid <= 0 || grid % cs != 0 ||
      chunk <= 0 || static_cast<long long>(chunk) * cs < nvec ||
      threads <= 0 || threads > THREADS || threads % 32 != 0 ||
      static_cast<long long>(threads) * vecs < chunk || ipb <= 0 ||
      static_cast<long long>(grid / cs) * ipb < items ||
      static_cast<long long>(grid / cs - 1) * ipb >= items)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vecs) {
    case 1: return launch_kv<T, 8, 1>(x, w, o, r, nvec, dm, d, seg, ipb, cs, chunk, grid, threads, eps, stream);
    case 2: return launch_kv<T, 4, 2>(x, w, o, r, nvec, dm, d, seg, ipb, cs, chunk, grid, threads, eps, stream);
    case 4: return launch_kv<T, 2, 4>(x, w, o, r, nvec, dm, d, seg, ipb, cs, chunk, grid, threads, eps, stream);
    case 8: return launch_kv<T, 1, 8>(x, w, o, r, nvec, dm, d, seg, ipb, cs, chunk, grid, threads, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int K, int V>
int occupancy_kv(int threads, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, rmsnorm_ms<T, K, V>, threads, 0));
}

template <typename T>
int occupancy(int vecs, int threads, int* blocks) {
  switch (vecs) {
    case 1: return occupancy_kv<T, 8, 1>(threads, blocks);
    case 2: return occupancy_kv<T, 4, 2>(threads, blocks);
    case 4: return occupancy_kv<T, 2, 4>(threads, blocks);
    case 8: return occupancy_kv<T, 1, 8>(threads, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, o: [rows, dm] of the element type `dtype`; w: [dm]; r: [rows] f32.
// d streams of seg = rows / d rows (bm row slots per block in the plan,
// checked only to divide seg).  The launch geometry (kernel.py geometry):
// vecs 16-byte vectors of a row a thread (1, 2, 4 or 8; it holds
// 8 / vecs rows at a time, an item), clusters of cs blocks that each
// take chunk vectors of a row, ipb items a cluster, grid blocks of
// threads.
extern "C" int rmsnorm_ms_launch(int dtype, const void* x, const void* w,
                                 void* o, void* r, int rows, int dm, int d,
                                 int bm, int vecs, int cs, int chunk,
                                 int ipb, int grid, int threads, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, w, o, r, rows, dm, d, bm, vecs, cs, chunk, ipb, grid, threads, eps, st);
    case kBF16: return launch<__nv_bfloat16>(x, w, o, r, rows, dm, d, bm, vecs, cs, chunk, ipb, grid, threads, eps, st);
    case kF16: return launch<__half>(x, w, o, r, rows, dm, d, bm, vecs, cs, chunk, ipb, grid, threads, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of `threads` threads of the instance holding `vecs` vectors a
// row that one SM keeps resident (the occupancy API), into *blocks.
extern "C" int rmsnorm_ms_occupancy(int dtype, int vecs, int threads,
                                    int* blocks) {
  switch (dtype) {
    case kF32: return occupancy<float>(vecs, threads, blocks);
    case kBF16: return occupancy<__nv_bfloat16>(vecs, threads, blocks);
    case kF16: return occupancy<__half>(vecs, threads, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
