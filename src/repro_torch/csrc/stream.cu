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
//   pass 1 (read_split), grid over column chunks, about two blocks per
//     SM: block c owns the sub-portions c*spc ... of every stream row;
//     its warps take column steps of ns sub-portions in turn, and in each
//     step a warp starts the loads of all D rows (in groups of at most
//     SWEEP_KMAX) before adding any.  Each lane keeps one f32 partial per
//     stream; the warp sums its lanes with a shuffle tree, the block its
//     warps in warp order, and writes part[c, k].
//   pass 2 (read_merge): y[k] = sum over c = 0 ... chunks-1 of part[c, k],
//     in chunk order.
// The fold order is fixed whatever the arrangement.  Against the plain
// version (one vectorised sum in another order) the result agrees
// within f32 reassociation error.
#include "common.cuh"

namespace {

constexpr int KMAX = SWEEP_KMAX, PMAX = SWEEP_PMAX;
constexpr int READ_THREADS = 256;
constexpr int READ_WARPS = READ_THREADS / 32;

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

template <typename T>
__global__ void __launch_bounds__(READ_THREADS)
read_split(const T* __restrict__ x, float* __restrict__ part, int w, int d,
           int ns, int spc, bool interleaved) {
  __shared__ float red[READ_WARPS][KMAX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nsub = w / SUB;
  const int q0 = blockIdx.x * spc, q1 = min(nsub, q0 + spc);
  for (int k0 = 0; k0 < d; k0 += KMAX) {
    const int nk = min(KMAX, d - k0);
    float acc[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[k] = 0.f;
    for (int qs = q0 + warp * ns; qs < q1; qs += nwarps * ns) {  // column steps
      for (int p0 = 0; p0 < ns && qs + p0 < q1; p0 += PMAX) {
        const int np = min(PMAX, min(ns - p0, q1 - qs - p0));
        float v[KMAX][PMAX][4];
        load_stream_step<T, KMAX, PMAX>(x, w, k0, 1, nk, (qs + p0) * SUB, np,
                                        interleaved, lane, v);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
#pragma unroll
          for (int p = 0; p < PMAX; ++p) {
            if (k < nk && p < np) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[k] += v[k][p][e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      float s = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[warp][k] = s;
    }
    __syncthreads();
    if (threadIdx.x < nk) {
      float s = 0.f;
      for (int g = 0; g < nwarps; ++g) s += red[g][threadIdx.x];
      part[static_cast<size_t>(blockIdx.x) * d + k0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

__global__ void read_merge(const float* __restrict__ part,
                           float* __restrict__ y, int d, int chunks) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= d) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[static_cast<size_t>(c) * d + k];
  y[k] = s;
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

template <typename T>
int split_t(const void* x, void* part, int w, int d, int ns, int spc,
            int chunks, int interleaved, cudaStream_t stream) {
  if (w <= 0 || d <= 0 || ns <= 0 || spc <= 0 || chunks <= 0 ||
      w % SUB != 0 || static_cast<long long>(chunks - 1) * spc >= w / SUB ||
      static_cast<long long>(chunks) * spc < w / SUB)
    return static_cast<int>(cudaErrorInvalidValue);
  read_split<T><<<chunks, READ_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(part), w, d, ns, spc,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
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

// Pass 1 of the read.  x: [d, w] of `dtype`, row-major (w a multiple of
// 128); part: [chunks, d] f32.  Chunk c takes the sub-portions c*spc ...
// min((c+1)*spc, w/128) - 1 of every row (none empty), in column steps
// of ns sub-portions.
extern "C" int read_split_launch(int dtype, const void* x, void* part, int w,
                                 int d, int ns, int spc, int chunks,
                                 int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return split_t<float>(x, part, w, d, ns, spc, chunks, interleaved, st);
    case kBF16: return split_t<__nv_bfloat16>(x, part, w, d, ns, spc, chunks, interleaved, st);
    case kF16: return split_t<__half>(x, part, w, d, ns, spc, chunks, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2 of the read.  part: [chunks, d] f32; y: [d] f32.
extern "C" int read_merge_launch(const void* part, void* y, int d, int chunks,
                                 void* stream) {
  if (d <= 0 || chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  read_merge<<<(d + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(y), d, chunks);
  return static_cast<int>(cudaGetLastError());
}
