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
// on common.cuh's row_sweep, as gemver.cu: the rows are split into D
// segments of seg = rows / D; block j owns the row slots j*bm ...
// j*bm + bm - 1 of every segment, one warp per slot; in each column step
// the warp starts the loads of the D rows r + k*seg over the step's P
// 128-element sub-portions (in the config's arrangement) before it
// stores any, 16 bytes a lane in f32.  In bf16 and f16 a lane also
// loads and stores 16 bytes: its 8 consecutive elements of a pair of
// adjacent sub-portions (row_sweep hands a body at most two), kept as
// packed words until they are used (Lanes16), so a triad holds 8 + 8
// words a stream and two blocks share an SM; a step's odd last
// sub-portion takes one 8-byte load.  With one pair a piece, grouped
// and interleaved issue the same order, the D streams one after
// another.  Init loads nothing and stores the D rows of each step.
// copy, triad and init equal their plain versions bit for bit.
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

constexpr int KMAX = SWEEP_KMAX, PMAX = SWEEP_PMAX;
constexpr int READ_THREADS = 256;
constexpr int READ_WARPS = READ_THREADS / 32;
constexpr int MERGE_WARPS = 8;

template <typename T>
struct CopyBody {
  const T* x;
  int cols;

  __device__ __forceinline__ void load(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane,
                                       float (&v)[KMAX][PMAX][4]) {
    load_stream_step<T, KMAX, PMAX>(x, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, v);
  }

  __device__ __forceinline__ float operator()(int, int, int, float a) const {
    return a;
  }
};

// a = b + alpha * c on one element, each operation rounded to T as the
// plain version rounds it (the f32 lanes and the 16-bit lanes share it)
template <typename T>
__device__ __forceinline__ float triad_elem(float alpha, float b, float c) {
  return round_to<T>(__fadd_rn(b, round_to<T>(__fmul_rn(alpha, c))));
}

template <typename T>
struct TriadBody {
  const T* b;
  const T* c;
  float alpha;
  int cols;
  float cv[KMAX][PMAX][4];

  __device__ __forceinline__ void load(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane,
                                       float (&v)[KMAX][PMAX][4]) {
    load_stream_step<T, KMAX, PMAX>(b, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, v);
    load_stream_step<T, KMAX, PMAX>(c, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, cv);
  }

  __device__ __forceinline__ float operator()(int k, int p, int e,
                                              float bv) const {
    return triad_elem<T>(alpha, bv, cv[k][p][e]);
  }
};

// writes-only: nothing is loaded, every element is the fill value
struct FillBody {
  float value;

  __device__ __forceinline__ void load(int, int, int, int, int, bool, int,
                                       float (&v)[KMAX][PMAX][4]) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
#pragma unroll
      for (int p = 0; p < PMAX; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[k][p][e] = 0.f;   // unused
  }

  __device__ __forceinline__ float operator()(int, int, int, float) const {
    return value;
  }
};

// The 16-bit lanes (bf16, f16) of the K1 bodies on row_sweep.  A piece
// of np <= 2 sub-portions from column c0 is, for lane `lane`, the 8
// elements c0 + 8 lane ... of a pair (np = 2: one 16-byte load of each
// operand row) or the 4 elements c0 + 4 lane ... of an odd last
// sub-portion (np = 1: one 8-byte load).  Op names its NIN read
// operands (in) and maps their packed words of stream k to the output's
// (a pair's 8 elements; of an odd sub-portion only x, y are stored).
template <typename T, typename Op>
struct Lanes16 {
  Op op;
  T* o;
  int cols;

  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void end(int, int, int, int) {}

  __device__ __forceinline__ void step(int rk, int seg, int nk, int c0,
                                       int np, bool, int lane) {
    constexpr int NIN = Op::NIN;
    const bool pair = np == 2;
    const int col = c0 + (pair ? lane * 8 : lane * 4);
    uint4 w[NIN > 0 ? NIN : 1][KMAX];
#pragma unroll
    for (int i = 0; i < NIN; ++i) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < nk) {
          const T* src =
              op.in[i] + static_cast<size_t>(rk + k * seg) * cols + col;
          if (pair) {
            w[i][k] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            const uint2 h = __ldg(reinterpret_cast<const uint2*>(src));
            w[i][k] = make_uint4(h.x, h.y, 0u, 0u);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < nk) {
        const uint4 r = op(w, k);
        T* dst = o + static_cast<size_t>(rk + k * seg) * cols + col;
        if (pair)
          *reinterpret_cast<uint4*>(dst) = r;
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(r.x, r.y);
      }
    }
  }
};

template <typename T>
struct Copy16 {
  static constexpr int NIN = 1;
  const T* in[1];

  __device__ __forceinline__ uint4 operator()(const uint4 (&w)[1][KMAX],
                                              int k) const {
    return w[0][k];
  }
};

// a = b + alpha * c on 8 packed elements (triad_elem)
template <typename T>
struct Triad16 {
  static constexpr int NIN = 2;
  const T* in[2];
  float alpha;

  __device__ __forceinline__ uint4 operator()(const uint4 (&w)[2][KMAX],
                                              int k) const {
    const uint32_t b[4] = {w[0][k].x, w[0][k].y, w[0][k].z, w[0][k].w};
    const uint32_t c[4] = {w[1][k].x, w[1][k].y, w[1][k].z, w[1][k].w};
    uint32_t r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      Cvt<T>::put(r, e, triad_elem<T>(alpha, Cvt<T>::get(b, e),
                                      Cvt<T>::get(c, e)));
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
};

// writes-only: the fill value's bits twice in each word
template <typename T>
struct Fill16 {
  static constexpr int NIN = 0;
  const T* in[1];
  uint32_t word;

  __device__ __forceinline__ uint4 operator()(const uint4 (&)[1][KMAX],
                                              int) const {
    return make_uint4(word, word, word, word);
  }
};

// In bf16 and f16 two blocks share an SM (at most 128 registers a thread).
template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32, sizeof(T) == 2 ? 2 : 1)
stream_copy(const T* __restrict__ x, T* __restrict__ o, int cols, int d,
            int seg, int bm, int ns, bool interleaved) {
  if constexpr (sizeof(T) == 2) {
    Lanes16<T, Copy16<T>> body{{{x}}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  } else {
    Elementwise<T, CopyBody<T>> body{{x, cols}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  }
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32, sizeof(T) == 2 ? 2 : 1)
stream_triad(const T* __restrict__ b, const T* __restrict__ c,
             T* __restrict__ o, float alpha, int cols, int d, int seg,
             int bm, int ns, bool interleaved) {
  if constexpr (sizeof(T) == 2) {
    Lanes16<T, Triad16<T>> body{{{b, c}, alpha}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  } else {
    Elementwise<T, TriadBody<T>> body{{b, c, alpha, cols}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  }
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32, sizeof(T) == 2 ? 2 : 1)
stream_init(T* __restrict__ o, float value, int cols, int d, int seg,
            int bm, int ns, bool interleaved) {
  if constexpr (sizeof(T) == 2) {
    uint32_t word = 0u;
    Cvt<T>::put(&word, 0, value);
    Cvt<T>::put(&word, 1, value);
    Lanes16<T, Fill16<T>> body{{{nullptr}, word}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  } else {
    Elementwise<T, FillBody> body{{value}, o, cols};
    row_sweep(cols, d, seg, bm, ns, interleaved, body);
  }
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
int copy_t(const void* x, void* o, int rows, int cols, int d, int bm, int ns,
           int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  stream_copy<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(o), cols, d, seg, bm, ns,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int triad_t(const void* b, const void* c, void* o, float alpha, int rows,
            int cols, int d, int bm, int ns, int interleaved,
            cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  stream_triad<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(o),
      alpha, cols, d, seg, bm, ns, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int init_t(void* o, float value, int rows, int cols, int d, int bm, int ns,
           int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  stream_init<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<T*>(o), value, cols, d, seg, bm, ns, interleaved != 0);
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

// x, o: [rows, cols] of `dtype`, row-major.  d streams of seg = rows / d
// rows, bm row slots per block; column steps of ns 128-element
// sub-portions, loaded grouped (interleaved = 0) or interleaved (1).
// cols a multiple of 128.
extern "C" int stream_copy_launch(int dtype, const void* x, void* o, int rows,
                                  int cols, int d, int bm, int ns,
                                  int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return copy_t<float>(x, o, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return copy_t<__nv_bfloat16>(x, o, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return copy_t<__half>(x, o, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a = b + alpha * c over [rows, cols] arrays; the geometry of
// stream_copy_launch.
extern "C" int stream_triad_launch(int dtype, const void* b, const void* c,
                                   void* o, float alpha, int rows, int cols,
                                   int d, int bm, int ns, int interleaved,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return triad_t<float>(b, c, o, alpha, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return triad_t<__nv_bfloat16>(b, c, o, alpha, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return triad_t<__half>(b, c, o, alpha, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// o[:, :] = value (rounded to `dtype`); the geometry of stream_copy_launch.
extern "C" int stream_init_launch(int dtype, void* o, float value, int rows,
                                  int cols, int d, int bm, int ns,
                                  int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return init_t<float>(o, value, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return init_t<__nv_bfloat16>(o, value, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return init_t<__half>(o, value, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the K1 copy (kind 0), triad (1) or init (2) instance of
// `dtype` that one SM keeps resident at `threads` threads a block (the
// occupancy API), into *blocks.
template <typename T>
int k1_occupancy_t(int kind, int threads, int* blocks) {
  const void* fn = kind == 0 ? reinterpret_cast<const void*>(stream_copy<T>)
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
