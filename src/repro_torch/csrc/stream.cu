// Multi-strided stream micro-kernels for Hopper (sm_90a): copy, triad
// and init (instances of K1) and the per-stream read checksums (an
// instance of K2, in two passes).
//
// Replaces the stream instances of the JAX package's templates, whose
// bodies are src/repro/kernels/stream/specs.py:
//   K1 _emit_streaming (src/repro/codegen/emit.py:410):
//     stream_copy:   y = x
//     stream_triad:  a = b + alpha * c, each operation rounded to the
//                    arrays' dtype, as the body computes it
//     stream_init:   y = value, writes-only (the fill broadcast of
//                    emit.py:440-450: no read stream, D store positions)
//   K2 _emit_reduction (src/repro/codegen/emit.py:491):
//     stream_read:   y[k] = sum_j f32(x2[k, j]) over x2 = x viewed as
//                    [D, seg * cols], one row per concurrent stream
//
// What bounds them: bytes.  Each element is read once and written once
// (copy), read twice and written once (triad), written once (init) or
// read once (read), for at most two flops.
//
// What the design does about it.  K1: the paper's D concurrent streams
// on common.cuh's flat walk, which gemver.cu's gemver_sum walked first
// and adamw.cu shares.  The (padded) [rows, cols] arrays are flat runs
// of 16-byte vectors (4 elements in f32, 8 in bf16 and f16); the rows
// r + k * seg of stream k (seg = rows / D) are the contiguous segment k
// of seg * cols elements.  A step takes P units of 128 vectors at the
// same offset of each of the D segments, run by D consecutive blocks of
// 128 threads, P units a block, in the config's arrangement (grouped:
// block j runs stream j's P units; interleaved: the streams round-robin
// unit by unit); a thread issues the loads of up to four units before
// it stores any, and the short last step of a segment is masked.  copy
// moves uint4 words; triad widens each element, rounds each operation
// to the arrays' dtype and narrows it back; init loads nothing and
// stores the fill word.  The walk has no row slots: the plan's bm
// (block_rows, a divisor of each segment's rows in the BlockPlan, which
// stays the reference's) does nothing to the launch, as for gemver_sum;
// P units a block is the plan's bn / 128.  copy, triad and init equal
// their plain versions bit for bit.
//
// K2: the TPU kernel's block plan for the read is D rows of seg * cols
// columns (bm = 1), so a grid over row slots would put one block on the
// whole array.  Here the vector axis is split instead:
//   pass 1 (read_split), grid over column chunks, two blocks per SM in
//     one wave: block c owns the sub-portions c*spc ... of every stream
//     row.  A lane's unit is 16 bytes of a row: 4 elements of a
//     sub-portion in f32, 8 elements of a pair of adjacent sub-portions
//     in bf16 and f16 (a chunk's odd last sub-portion takes one 8-byte
//     load), widened only when added.  The read is bound by the bytes in
//     flight (Little's law: 3.35 TB/s x ~1 us of loaded DRAM latency is
//     about 25 KB an SM), so each warp keeps two steps in registers: it
//     issues the loads of its next step (K streams x 8/K units, 8 loads
//     of 16 bytes a lane) before it adds the current one, 4 KB a warp in
//     flight while it adds, 64 KB an SM.  Streams go K at a time (K of
//     1, 2, 4, 8: the smallest power of two up to D, at most 8), in the
//     config's arrangement (grouped: a stream's units back to back;
//     interleaved: the streams round-robin unit by unit).  Each lane
//     keeps one f32 partial per stream; the warp sums its lanes with a
//     shuffle tree, the block its warps in warp order, and writes
//     part[c, k].
//   pass 2 (read_merge): one warp a stream; lane l sums the partials of
//     chunks l, l + 32, ... in order, and a fixed shuffle tree (xor 16,
//     8, 4, 2, 1) folds the lanes.  read_merge_plain in
//     kernels/stream/kernel.py folds in the same order, so the two agree
//     bit for bit.
// The fold order is fixed whatever the arrangement.  Against the plain
// version of the read (one vectorised sum in another order) the result
// agrees within f32 reassociation error.
#include "common.cuh"

namespace {

constexpr int READ_THREADS = 256;
constexpr int READ_WARPS = READ_THREADS / 32;
constexpr int MERGE_WARPS = 8;

// a = b + alpha * c on one element, each operation rounded to T as the
// plain version rounds it
template <typename T>
__device__ __forceinline__ float triad_elem(float alpha, float b, float c) {
  return round_to<T>(__fadd_rn(b, round_to<T>(__fmul_rn(alpha, c))));
}

// The K1 bodies on common.cuh's flat walk, over 16-byte vectors of the
// flat arrays.  copy moves the words as they are (one instance serves
// every type); triad widens each element of a word, runs triad_elem and
// narrows it back; init loads nothing and stores the fill word.
struct CopyBody {
  struct Held { uint4 x; };
  const uint4* __restrict__ x;
  uint4* __restrict__ o;

  __device__ __forceinline__ bool load(long long at, Held& h) const {
    h.x = __ldg(x + at);
    return true;
  }
  __device__ __forceinline__ void store(long long at, const Held& h) const {
    o[at] = h.x;
  }
};

template <typename T>
struct TriadBody {
  struct Held { uint4 b, c; };
  const uint4* __restrict__ b;
  const uint4* __restrict__ c;
  uint4* __restrict__ o;
  float alpha;

  __device__ __forceinline__ bool load(long long at, Held& h) const {
    h.b = __ldg(b + at);
    h.c = __ldg(c + at);
    return true;
  }
  __device__ __forceinline__ void store(long long at, const Held& h) const {
    constexpr int EPV = 16 / static_cast<int>(sizeof(T));  // elements a vector
    const uint32_t wb[4] = {h.b.x, h.b.y, h.b.z, h.b.w};
    const uint32_t wc[4] = {h.c.x, h.c.y, h.c.z, h.c.w};
    uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      Cvt<T>::put(r, e, triad_elem<T>(alpha, Cvt<T>::get(wb, e),
                                      Cvt<T>::get(wc, e)));
    o[at] = make_uint4(r[0], r[1], r[2], r[3]);
  }
};

// writes-only: the fill value's bits in every element of the word
struct FillBody {
  struct Held {};
  uint4* __restrict__ o;
  uint32_t word;

  __device__ __forceinline__ bool load(long long, Held&) const {
    return true;
  }
  __device__ __forceinline__ void store(long long at, const Held&) const {
    o[at] = make_uint4(word, word, word, word);
  }
};

// x, o as 16-byte vectors: segv vectors a segment, d segments, steps of
// np units (common.cuh flat_walk); the same kernel in every type
__global__ void __launch_bounds__(WALK_UNIT)
stream_copy(const uint4* __restrict__ x, uint4* __restrict__ o,
            long long segv, int d, int np, bool interleaved) {
  CopyBody body{x, o};
  flat_walk(segv, d, np, interleaved, body);
}

template <typename T>
__global__ void __launch_bounds__(WALK_UNIT)
stream_triad(const uint4* __restrict__ b, const uint4* __restrict__ c,
             uint4* __restrict__ o, float alpha, long long segv, int d,
             int np, bool interleaved) {
  TriadBody<T> body{b, c, o, alpha};
  flat_walk(segv, d, np, interleaved, body);
}

template <typename T>
__global__ void __launch_bounds__(WALK_UNIT)
stream_init(uint4* __restrict__ o, float value, long long segv, int d,
            int np, bool interleaved) {
  uint32_t w[1] = {0u};
#pragma unroll
  for (int e = 0; e < 4 / static_cast<int>(sizeof(T)); ++e)
    Cvt<T>::put(w, e, value);
  FillBody body{o, w[0]};
  flat_walk(segv, d, np, interleaved, body);
}

// One warp's steps of read_split over streams k0 ... k0 + nk - 1 of a
// chunk: a step is U = 8 / K units of each stream, unit u the 16 bytes
// of lane `lane` at sub-portion q0 + u * PER (PER = 2 in 16-bit types:
// the unit spans a pair).
template <typename T, int K>
struct ReadSteps {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int PER = HALF ? 2 : 1;          // sub-portions a unit
  static constexpr int EPL = HALF ? 8 : 4;          // elements a lane a unit
  static constexpr int U = 8 / K;                   // units a stream a step
  const T* x;                                       // row k0, column q0 * SUB
  size_t w;                                         // a stream row's elements
  int nk, nfull, lane;
  bool interleaved;

  __device__ __forceinline__ void load1(int k, int j, int u,
                                        uint4 (&b)[K][U]) const {
    if (k < nk && u + j < nfull)
      b[k][j] = __ldg(reinterpret_cast<const uint4*>(
          x + k * w + static_cast<size_t>(u + j) * PER * SUB +
          lane * EPL));
  }

  // the loads of the step whose first unit is u, in the arrangement
  __device__ __forceinline__ void load(int u, uint4 (&b)[K][U]) const {
    if (interleaved) {
#pragma unroll
      for (int j = 0; j < U; ++j)
#pragma unroll
        for (int k = 0; k < K; ++k) load1(k, j, u, b);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < U; ++j) load1(k, j, u, b);
    }
  }

  // the step's elements into each stream's partial, in unit order
  __device__ __forceinline__ void add(int u, const uint4 (&b)[K][U],
                                      float (&acc)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (k < nk && u + j < nfull) {
          const uint32_t wd[4] = {b[k][j].x, b[k][j].y, b[k][j].z, b[k][j].w};
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[k] += Cvt<T>::get(wd, e);
        }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(READ_THREADS, 2)
read_split(const T* __restrict__ x, float* __restrict__ part, int w, int d,
           int spc, bool interleaved) {
  using S = ReadSteps<T, K>;
  __shared__ float red[READ_WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsub = w / SUB;
  const int q0 = blockIdx.x * spc, q1 = min(nsub, q0 + spc);
  const int nfull = (q1 - q0) / S::PER;             // whole units
  const bool tail = S::HALF && ((q1 - q0) & 1);     // a lone sub-portion
  constexpr int STRIDE = READ_WARPS * S::U;         // units between a warp's steps
  for (int k0 = 0; k0 < d; k0 += K) {
    const S st{x + static_cast<size_t>(k0) * w + static_cast<size_t>(q0) * SUB,
               static_cast<size_t>(w), min(K, d - k0), nfull, lane,
               interleaved};
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
    // two steps in registers: the next one's loads are in flight while
    // the current one is added
    uint4 a[K][S::U], b[K][S::U];
    int u = warp * S::U;
    if (u < nfull) st.load(u, a);
    for (; u < nfull; u += 2 * STRIDE) {
      if (u + STRIDE < nfull) st.load(u + STRIDE, b);
      st.add(u, a, acc);
      if (u + STRIDE >= nfull) break;
      if (u + 2 * STRIDE < nfull) st.load(u + 2 * STRIDE, a);
      st.add(u + STRIDE, b, acc);
    }
    if (tail && warp == 0) {            // 4 elements a lane, 8 bytes
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < st.nk) {
          float f[4];
          load_f32<T, 4>(st.x + k * st.w +
                             static_cast<size_t>(q1 - q0 - 1) * SUB + lane * 4,
                         f);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[k] += f[e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < st.nk) {
      float s = 0.f;
      for (int g = 0; g < READ_WARPS; ++g) s += red[g][threadIdx.x];
      part[static_cast<size_t>(blockIdx.x) * d + k0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// One warp a stream k: lane l sums part[c, k] over c = l, l + 32, ... in
// order, then the lanes fold by xor 16, 8, 4, 2, 1.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
read_merge(const float* __restrict__ part, float* __restrict__ y, int d,
           int chunks) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (k >= d) return;
  float s = 0.f;
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32)
    s += __ldg(part + static_cast<size_t>(c) * d + k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) y[k] = s;
}

template <typename T>
int triad_t(const void* b, const void* c, void* o, float alpha,
            long long segv, int d, int np, int interleaved,
            cudaStream_t stream) {
  dim3 grid;
  if (!walk_grid(segv, d, np, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  stream_triad<T><<<grid, WALK_UNIT, 0, stream>>>(
      static_cast<const uint4*>(b), static_cast<const uint4*>(c),
      static_cast<uint4*>(o), alpha, segv, d, np, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int init_t(void* o, float value, long long segv, int d, int np,
           int interleaved, cudaStream_t stream) {
  dim3 grid;
  if (!walk_grid(segv, d, np, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  stream_init<T><<<grid, WALK_UNIT, 0, stream>>>(
      static_cast<uint4*>(o), value, segv, d, np, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int split_k(const void* x, void* part, int w, int d, int spc, int chunks,
            int interleaved, cudaStream_t stream) {
  read_split<T, K><<<chunks, READ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), w, d, spc,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_t(const void* x, void* part, int w, int d, int spc, int chunks,
            int interleaved, cudaStream_t stream) {
  if (w <= 0 || d <= 0 || spc <= 0 || chunks <= 0 || w % SUB != 0 ||
      static_cast<long long>(chunks - 1) * spc >= w / SUB ||
      static_cast<long long>(chunks) * spc < w / SUB)
    return static_cast<int>(cudaErrorInvalidValue);
  // streams in registers: the smallest power of two up to d, at most 8
  if (d > 4) return split_k<T, 8>(x, part, w, d, spc, chunks, interleaved, stream);
  if (d > 2) return split_k<T, 4>(x, part, w, d, spc, chunks, interleaved, stream);
  if (d > 1) return split_k<T, 2>(x, part, w, d, spc, chunks, interleaved, stream);
  return split_k<T, 1>(x, part, w, d, spc, chunks, interleaved, stream);
}

}  // namespace

// x, o: the (padded) [rows, cols] arrays of `dtype`, row-major, 16-byte
// aligned, as d segments of segv 16-byte vectors (the rows r + k * seg
// of stream k); steps of np units of 128 vectors of every segment, d
// blocks of 128 threads a step, its units ordered grouped
// (interleaved = 0) or interleaved (1).
extern "C" int stream_copy_launch(int dtype, const void* x, void* o,
                                  long long segv, int d, int np,
                                  int interleaved, void* stream) {
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid;
  if (!walk_grid(segv, d, np, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  stream_copy<<<grid, WALK_UNIT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(o), segv, d, np,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

// a = b + alpha * c; the geometry of stream_copy_launch.
extern "C" int stream_triad_launch(int dtype, const void* b, const void* c,
                                   void* o, float alpha, long long segv,
                                   int d, int np, int interleaved,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return triad_t<float>(b, c, o, alpha, segv, d, np, interleaved, st);
    case kBF16: return triad_t<__nv_bfloat16>(b, c, o, alpha, segv, d, np, interleaved, st);
    case kF16: return triad_t<__half>(b, c, o, alpha, segv, d, np, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o = value (rounded to `dtype`); the geometry of stream_copy_launch.
extern "C" int stream_init_launch(int dtype, void* o, float value,
                                  long long segv, int d, int np,
                                  int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return init_t<float>(o, value, segv, d, np, interleaved, st);
    case kBF16: return init_t<__nv_bfloat16>(o, value, segv, d, np, interleaved, st);
    case kF16: return init_t<__half>(o, value, segv, d, np, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the K1 copy (kind 0), triad (1) or init (2) instance of
// `dtype` that one SM keeps resident at `threads` threads a block (the
// occupancy API), into *blocks.
template <typename T>
int k1_occupancy_t(int kind, int threads, int* blocks) {
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(stream_copy)
                   : kind == 1 ? reinterpret_cast<const void*>(stream_triad<T>)
                               : reinterpret_cast<const void*>(stream_init<T>);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, 0));
}

extern "C" int stream_k1_occupancy(int dtype, int kind, int threads,
                                   int* blocks) {
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return k1_occupancy_t<float>(kind, threads, blocks);
    case kBF16: return k1_occupancy_t<__nv_bfloat16>(kind, threads, blocks);
    case kF16: return k1_occupancy_t<__half>(kind, threads, blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 1 of the read.  x: [d, w] of `dtype`, row-major (w a multiple of
// 128); part: [chunks, d] f32.  Chunk c takes the sub-portions c*spc ...
// min((c+1)*spc, w/128) - 1 of every row (none empty), loaded grouped
// (interleaved = 0) or interleaved (1).
extern "C" int read_split_launch(int dtype, const void* x, void* part, int w,
                                 int d, int spc, int chunks, int interleaved,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return split_t<float>(x, part, w, d, spc, chunks, interleaved, st);
    case kBF16: return split_t<__nv_bfloat16>(x, part, w, d, spc, chunks, interleaved, st);
    case kF16: return split_t<__half>(x, part, w, d, spc, chunks, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2 of the read.  part: [chunks, d] f32; y: [d] f32.
extern "C" int read_merge_launch(const void* part, void* y, int d, int chunks,
                                 void* stream) {
  if (d <= 0 || chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  read_merge<<<(d + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(y), d, chunks);
  return static_cast<int>(cudaGetLastError());
}
