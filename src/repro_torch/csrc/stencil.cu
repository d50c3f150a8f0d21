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
// it (__fmul_rn and __fadd_rn, never a fused multiply-add, never packed
// 16-bit arithmetic), and rounded once to T at the store: both equal
// their plain versions bit for bit in every dtype.  The nine weights
// arrive as a [9] array on the card in f32, bf16 or f16 (a contiguous
// [3, 3] weight's own storage, so no launch packs them), as the TPU
// kernel reads its scalars from (1, 1) memory blocks.
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
// into D segments of seg = rows / D; block (k, tile, run) owns stream k's
// THREADS * V output columns of the tile over `run` rows of its segment,
// and a thread computes V adjacent output columns, 16 bytes of output (4
// in f32, 8 in bf16 and f16).  The stream is the grid's fastest index,
// so the D blocks of one (tile, run) are issued together: the D streams
// run concurrently across the card, each block one stream (chip runs on
// an H100 found one stream a thread faster than 2 or 4 held by a thread:
// more threads fit an SM).
//
// Staging: registers.  A thread keeps its taps of a ring of AHEAD + 3
// input rows as raw words: the V elements of columns c ... c + V - 1 (one
// 16-byte load) and the two past them, which come from the next lane's
// first word by a shuffle (lane 31 loads them itself).  A run opens with
// AHEAD + 2 tap rows; each step then issues the load of the bottom tap
// row of output row t + AHEAD before it computes output row t, so AHEAD
// rows are in flight while it computes and stores.  The shuffle that
// completes a row waits for it just before the row is first used; the
// loop is unrolled over the ring so that every slot is a register.
//
// Alignment, per row: a thread's columns start 16 bytes apart, so within
// a row every thread's address has the same alignment, and a row is
// loaded (stored) in the widest of 16, 8, 4, 2-byte pieces that divides
// its first address (the rule of rmsnorm's rows, applied to each row).
// x [2050, 2048] has 16-byte input rows; its output rows of 2046 (4092 B
// in bf16) start at 16, 4, 8, 4 bytes of alignment in turn.  The thread
// whose V columns cross the row's end (cols not a multiple of V) loads
// and stores element by element; any cols down to 1 is taken.
//
// Runs re-read two tap rows (stencil.py stencil_runs).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // threads of a block (4 warps)
constexpr int AHEAD = 2;       // tap rows of a thread in flight

// A thread's vector: V elements of 16 bytes; a tap row is W words: the
// vector, then the X words of the two elements past it.
template <typename T>
struct Lanes {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int X = sizeof(T) == 4 ? 2 : 1;
  static constexpr int W = 4 + X;
};

struct JacobiBody {
  __device__ __forceinline__ void init(const void*) {}

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

// the nine weights of element type W, each widened exactly
template <typename W>
struct ConvBody {
  float w[9];

  __device__ __forceinline__ void init(const void* __restrict__ w9) {
#pragma unroll
    for (int q = 0; q < 9; ++q)
      w[q] = Cvt<W>::to(__ldg(static_cast<const W*>(w9) + q));
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

// the widest of 16, 8, 4, 2 bytes that divides p's address
__device__ __forceinline__ int piece_bytes(const void* p) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)) & 15u;
  return a == 0 ? 16 : static_cast<int>(a & (0u - a));
}

// NB bytes at p (NB a multiple of 4, p aligned to `bytes`) into NB / 4
// words, in pieces of `bytes`
template <int NB>
__device__ __forceinline__ void load_bytes(const char* p, int bytes,
                                           uint32_t* w) {
  if constexpr (NB >= 16) {
    if (bytes >= 16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      return;
    }
  }
  if constexpr (NB >= 8) {
    if (bytes >= 8) {
#pragma unroll
      for (int i = 0; i < NB / 8; ++i) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + 8 * i));
        w[2 * i] = u.x; w[2 * i + 1] = u.y;
      }
      return;
    }
  }
  if (bytes >= 4) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i)
      w[i] = __ldg(reinterpret_cast<const unsigned int*>(p + 4 * i));
  } else {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) {
      const uint32_t lo = __ldg(reinterpret_cast<const unsigned short*>(p + 4 * i));
      const uint32_t hi = __ldg(reinterpret_cast<const unsigned short*>(p + 4 * i + 2));
      w[i] = lo | (hi << 16);
    }
  }
}

// 16 bytes of w to p (aligned to `bytes`), in pieces of `bytes`
__device__ __forceinline__ void store_bytes(char* p, int bytes,
                                            const uint32_t* w) {
  if (bytes >= 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (bytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    *reinterpret_cast<uint2*>(p + 8) = make_uint2(w[2], w[3]);
  } else if (bytes == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      reinterpret_cast<unsigned short*>(p)[2 * i] =
          static_cast<unsigned short>(w[i] & 0xffffu);
      reinterpret_cast<unsigned short*>(p)[2 * i + 1] =
          static_cast<unsigned short>(w[i] >> 16);
    }
  }
}

// The N elements at p into raw words, element by element: those with
// e < n (the rest of the row), zeros past them.
template <typename T, int N>
__device__ __forceinline__ void load_elems(const T* p, int n, uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; ++e)
      w[e] = e < n ? __ldg(reinterpret_cast<const unsigned int*>(p + e)) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      const uint32_t lo = 2 * i < n ? __ldg(q + 2 * i) : 0u;
      const uint32_t hi = 2 * i + 1 < n ? __ldg(q + 2 * i + 1) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
}

// Start the loads of one tap row: the thread's V elements at p (the
// row's column c, `left` elements of the row from there on) and, in
// lane 31, the two past them.  `full`: the V elements and the two past
// them lie in the row.
template <typename T>
__device__ __forceinline__ void load_row(const T* p, int left, bool full,
                                         bool last_lane,
                                         uint32_t (&r)[Lanes<T>::W]) {
  constexpr int V = Lanes<T>::V, X = Lanes<T>::X;
  if (full) {
    const int bytes = piece_bytes(p);
    load_bytes<16>(reinterpret_cast<const char*>(p), bytes, r);
    if (last_lane)
      load_bytes<4 * X>(reinterpret_cast<const char*>(p + V), bytes, r + 4);
  } else {
    load_elems<T, V>(p, left, r);
    if (last_lane) load_elems<T, 2>(p + V, left - V, r + 4);
  }
}

// Complete a tap row once it has arrived: lanes 0-30 take the two
// elements past their vector from the next lane's first word(s).
template <typename T>
__device__ __forceinline__ void finish_row(uint32_t (&r)[Lanes<T>::W],
                                           bool last_lane) {
#pragma unroll
  for (int i = 0; i < Lanes<T>::X; ++i) {
    const uint32_t s = __shfl_down_sync(0xffffffffu, r[i], 1);
    if (!last_lane) r[4 + i] = s;
  }
}

template <typename T, typename Body>
__global__ void __launch_bounds__(THREADS)
stencil(const T* __restrict__ x, const void* __restrict__ w9,
        T* __restrict__ o, int cols, int seg, int run) {
  constexpr int V = Lanes<T>::V, W = Lanes<T>::W;
  constexpr int Q = AHEAD + 3;             // tap rows in registers: a ring
  const bool last_lane = (threadIdx.x & 31) == 31;
  const int k = blockIdx.x;                // the stream
  const int c = (blockIdx.y * THREADS + threadIdx.x) * V;
  const bool full = c + V <= cols;
  const int left = cols + 2 - c;          // input elements from column c
  const int t0 = blockIdx.z * run, t1 = min(seg, t0 + run);
  const size_t wx = static_cast<size_t>(cols) + 2;
  const T* xk = x + static_cast<size_t>(k * seg) * wx + c;
  T* ok = o + static_cast<size_t>(k * seg) * cols + c;
  Body body;
  body.init(w9);
  // input row t0 + j of the stream lives in r[j % Q]
  uint32_t r[Q][W];
#pragma unroll
  for (int i = 0; i < AHEAD + 2; ++i)      // prologue: AHEAD + 2 tap rows
    if (t0 + i <= t1 + 1)
      load_row<T>(xk + static_cast<size_t>(t0 + i) * wx, left, full,
                  last_lane, r[i]);
  finish_row<T>(r[0], last_lane);
  finish_row<T>(r[1], last_lane);
  for (int t = t0; t < t1; t += Q) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {          // ring slots known at compile time
      const int tt = t + u;
      if (tt < t1) {
        if (tt + AHEAD + 2 <= t1 + 1)      // the next tap row, in flight
          load_row<T>(xk + static_cast<size_t>(tt + AHEAD + 2) * wx, left,
                      full, last_lane, r[(u + AHEAD + 2) % Q]);
        finish_row<T>(r[(u + 2) % Q], last_lane);
        float out[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float ta[3], tb[3], tc[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            ta[q] = Cvt<T>::get(r[u], e + q);
            tb[q] = Cvt<T>::get(r[(u + 1) % Q], e + q);
            tc[q] = Cvt<T>::get(r[(u + 2) % Q], e + q);
          }
          out[e] = body(ta, tb, tc);
        }
        T* q = ok + static_cast<size_t>(tt) * cols;
        if (full) {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < V; ++e) Cvt<T>::put(w, e, out[e]);
          store_bytes(reinterpret_cast<char*>(q), piece_bytes(q), w);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c + e < cols) q[e] = Cvt<T>::from(out[e]);
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
  const int tile = THREADS * Lanes<T>::V;
  const int tiles = (cols + tile - 1) / tile;
  if (runs > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  stencil<T, Body><<<dim3(d, tiles, runs), THREADS, 0, stream>>>(
      static_cast<const T*>(x), w9,
      static_cast<T*>(o), cols, seg, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Body>
int occupancy_t(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stencil<T, Body>, THREADS, 0));
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

// The geometry of jacobi2d_launch; w9: the nine weights, [9] on the
// card, w[0][0] first, of element type wdtype (f32, bf16 or f16; each is
// widened to f32 exactly, as the body widens its scalars).
extern "C" int conv3x3_launch(int dtype, const void* x, const void* w9,
                              int wdtype, void* o, int rows, int cols, int d,
                              int run, void* stream) {
  if (w9 == nullptr || wdtype < kF32 || wdtype > kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 3 + wdtype) {
#define CONV_CASE(T_, W_, t_, w_)                                             \
    case t_ * 3 + w_:                                                         \
      return launch<T_, ConvBody<W_>>(x, w9, o, rows, cols, d, run, st);
    CONV_CASE(float, float, kF32, kF32)
    CONV_CASE(float, __nv_bfloat16, kF32, kBF16)
    CONV_CASE(float, __half, kF32, kF16)
    CONV_CASE(__nv_bfloat16, float, kBF16, kF32)
    CONV_CASE(__nv_bfloat16, __nv_bfloat16, kBF16, kBF16)
    CONV_CASE(__nv_bfloat16, __half, kBF16, kF16)
    CONV_CASE(__half, float, kF16, kF32)
    CONV_CASE(__half, __nv_bfloat16, kF16, kBF16)
    CONV_CASE(__half, __half, kF16, kF16)
#undef CONV_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the stencil instance (conv = 0: jacobi2d, 1: conv3x3 with
// weights of x's type) one SM keeps resident.
extern "C" int stencil_occupancy(int dtype, int conv, int* blocks) {
  switch (dtype * 2 + (conv != 0)) {
    case kF32 * 2: return occupancy_t<float, JacobiBody>(blocks);
    case kF32 * 2 + 1: return occupancy_t<float, ConvBody<float>>(blocks);
    case kBF16 * 2: return occupancy_t<__nv_bfloat16, JacobiBody>(blocks);
    case kBF16 * 2 + 1: return occupancy_t<__nv_bfloat16, ConvBody<__nv_bfloat16>>(blocks);
    case kF16 * 2: return occupancy_t<__half, JacobiBody>(blocks);
    case kF16 * 2 + 1: return occupancy_t<__half, ConvBody<__half>>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
