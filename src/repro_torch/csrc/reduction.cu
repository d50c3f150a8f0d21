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
//   * rowstat (src/repro/kernels/gen/__init__.py:65): the row max and
//     the row sum of x in one sweep, two f32 outputs with their own
//     combinators (reduce=("max", "sum")).
//
// What bounds them: bytes.  Every element of A (x) is read once for one
// multiply-add (a max and an add), far below the card's ~20 flops per
// byte of f32 arithmetic, so the kernels are as fast as they stream A.
// x (of the row-dot) is read once per row block and stays in L2.
//
// What the row-dot's design does about it: it keeps the paper's D
// concurrent streams, on common.cuh's row_sweep.  The rows are split
// into D segments of seg = rows / D; block j owns the row slots j*bm ...
// j*bm + bm - 1 of every segment, one warp per slot.  On the TPU one f32
// (D, bm) accumulator was carried across the sequential column grid; on
// Hopper that grid becomes a loop inside the warp.  In each column step
// the warp starts the loads of the D rows r + k*seg (k = 0..D-1) over
// the step's P 128-element sub-portions (load_stream_step, in the
// config's arrangement) before any arithmetic: D * P independent loads
// in flight per lane.  Each lane keeps one f32 partial per stream; a
// warp shuffle tree merges them at the end and lane 0 stores the D
// results.  At most SWEEP_KMAX streams and SWEEP_PMAX sub-portions are
// held in registers at a time: a larger D is walked in groups of
// SWEEP_KMAX rows, a larger P in groups of SWEEP_PMAX sub-portions.
//
// rowstat keeps the D streams on a sweep of its own.  The read is bound
// by the bytes in flight (Little's law: 3.35 TB/s x ~1 us of loaded
// DRAM latency, about 25 KB an SM), so:
//   * a lane loads 16 bytes a unit in every type (8 elements of a pair
//     of adjacent sub-portions in bf16 and f16), and keeps the next
//     step's 8 loads in flight while it folds the current one: 4 KB a
//     warp, 64 KB an SM at two blocks of 8 warps;
//   * the grid is one wave of at most two blocks an SM; a block walks a
//     run of row slots, and where the slots are too few to fill the
//     wave a slot's columns are cut into parts, a warp a part, merged in
//     part order (rowstat_geometry in kernels/gen/kernel.py);
//   * the row max is one max.NaN instruction a word (two elements in
//     16-bit types), and each stream keeps 8 / K independent f64 sums a
//     lane, so the adds are not one dependent chain.
// P (the plan's sub-portions a column step) does not shape rowstat's
// steps, as it does not the read's (stream.cu).
//
// The arithmetic runs in one fixed order whatever the arrangement, so
// the grouped and interleaved arrangements give the same bits.  The
// max is exact (it propagates a NaN, as torch's amax does).  Against
// the plain version (a vectorised f32 sum in another order) the row-dot
// agrees within f32 reassociation error, n * 2^-24 * sum_j |A[i, j] *
// x[j]| per element; the row sum, taken in f64 and rounded once, within
// the plain version's own f32 error.
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

// The running max of a lane on packed words, one max.NaN instruction a
// word: two elements a word in bf16 and f16, one in f32.  Selecting is
// exact, so the max equals the plain version's; fold gives the word's
// max as f32.
template <typename T> struct WordMax;

template <> struct WordMax<float> {
  static constexpr uint32_t kNegInf = 0xff800000u;
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t a) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;"
        : "=f"(r) : "f"(__uint_as_float(m)), "f"(__uint_as_float(a)));
    return __float_as_uint(r);
  }
  __device__ __forceinline__ static float fold(uint32_t m) {
    return __uint_as_float(m);
  }
};

template <> struct WordMax<__nv_bfloat16> {
  static constexpr uint32_t kNegInf = 0xff80ff80u;
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t a) {
    uint32_t r;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(m), "r"(a));
    return r;
  }
  __device__ __forceinline__ static float fold(uint32_t m) {
    return nan_max(Cvt<__nv_bfloat16>::get(&m, 0),
                   Cvt<__nv_bfloat16>::get(&m, 1));
  }
};

template <> struct WordMax<__half> {
  static constexpr uint32_t kNegInf = 0xfc00fc00u;
  __device__ __forceinline__ static uint32_t max(uint32_t m, uint32_t a) {
    uint32_t r;
    asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(r) : "r"(m), "r"(a));
    return r;
  }
  __device__ __forceinline__ static float fold(uint32_t m) {
    return nan_max(Cvt<__half>::get(&m, 0), Cvt<__half>::get(&m, 1));
  }
};

// The row statistics (rowstat_spec).  A block of STAT_WARPS warps walks
// a run of spb consecutive row slots (a slot: the d rows s + k*seg), in
// rounds of STAT_WARPS / parts slots; the columns of a slot are cut into
// `parts` parts, one warp each, and the parts merge in order through
// shared memory.  A lane's unit is 16 bytes of a row: 4 elements of a
// sub-portion in f32, 8 elements of a pair of adjacent sub-portions in
// bf16 and f16 (a row's odd last sub-portion, in the last part, takes
// one 8-byte load).  A step is U = 8 / K units of each of the K streams
// of a group (8 loads of 16 bytes a lane); the next step's loads are in
// flight while the current one is folded.  Each stream keeps C = 8 / K
// independent f64 sums a lane (element i of a step into sum i % C) and
// one running max word.  K is the smallest power of two up to D, at most
// 4: a larger D is walked in groups.
constexpr int STAT_THREADS = 256;
constexpr int STAT_WARPS = STAT_THREADS / 32;

template <typename T, int K>
struct StatSteps {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int PER = HALF ? 2 : 1;          // sub-portions a unit
  static constexpr int EPL = HALF ? 8 : 4;          // elements a lane a unit
  static constexpr int U = 8 / K;                   // units a stream a step
  static constexpr int C = 8 / K;                   // f64 sums a stream
  const T* x;                                       // stream 0, unit 0, lane
  size_t sw;                                        // elements between streams
  int nk, u1;
  bool interleaved;

  __device__ __forceinline__ void load1(int k, int j, int u,
                                        uint4 (&b)[K][U]) const {
    if (k < nk && u + j < u1)
      b[k][j] = __ldg(reinterpret_cast<const uint4*>(
          x + k * sw + static_cast<size_t>(u + j) * PER * SUB));
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

  // the step's elements into each stream's sums and max, in unit order
  __device__ __forceinline__ void add(int u, const uint4 (&b)[K][U],
                                      double (&acc)[K][C],
                                      uint32_t (&mw)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (k < nk && u + j < u1) {
          const uint32_t wd[4] = {b[k][j].x, b[k][j].y, b[k][j].z, b[k][j].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) mw[k] = WordMax<T>::max(mw[k], wd[i]);
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[k][(j * EPL + e) % C] += static_cast<double>(Cvt<T>::get(wd, e));
        }
  }
};

template <typename T, int K>
__global__ void __launch_bounds__(STAT_THREADS, 2)
rowstat(const T* __restrict__ x, float* __restrict__ mx,
        float* __restrict__ sm, int cols, int d, int seg, int parts, int spb,
        bool interleaved) {
  using S = StatSteps<T, K>;
  __shared__ double psum[2][STAT_WARPS][K];   // part partials, by parity
  __shared__ float pmax[2][STAT_WARPS][K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsub = cols / SUB;
  const int nu = nsub / S::PER;                     // whole units a row
  const bool tail = S::HALF && (nsub & 1);          // a lone sub-portion
  const int upp = (nu + parts - 1) / parts;         // units a part
  const int spr = STAT_WARPS / parts;               // slots a round
  const int q = warp % parts;
  const int u0 = min(nu, q * upp);
  const int s0 = blockIdx.x * spb, s1 = min(seg, s0 + spb);
  int par = 0;
  // rounds and groups are the same for every warp of the block, so the
  // barrier below is reached by all; the partials alternate by parity
  // (a round's are rewritten only after the next round's barrier)
  for (int base = s0; base < s1; base += spr) {
    const int slot = base + warp / parts;
    for (int k0 = 0; k0 < d; k0 += K, par ^= 1) {
      const int nk = min(K, d - k0);
      if (slot < s1) {
        const T* xr = x + (static_cast<size_t>(slot) +
                           static_cast<size_t>(k0) * seg) * cols;
        const S st{xr + lane * S::EPL, static_cast<size_t>(seg) * cols, nk,
                   min(nu, u0 + upp), interleaved};
        double acc[K][S::C];
        uint32_t mw[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          mw[k] = WordMax<T>::kNegInf;
#pragma unroll
          for (int c = 0; c < S::C; ++c) acc[k][c] = 0.0;
        }
        // two steps in registers: the next one's loads are in flight
        // while the current one is folded
        uint4 a[K][S::U], b[K][S::U];
        int u = u0;
        if (u < st.u1) st.load(u, a);
        for (; u < st.u1; u += 2 * S::U) {
          if (u + S::U < st.u1) st.load(u + S::U, b);
          st.add(u, a, acc, mw);
          if (u + S::U >= st.u1) break;
          if (u + 2 * S::U < st.u1) st.load(u + 2 * S::U, a);
          st.add(u + S::U, b, acc, mw);
        }
        if constexpr (S::HALF) {
          if (tail && q == parts - 1) {   // 4 elements a lane, 8 bytes
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if (k < nk) {
                const uint2 h = __ldg(reinterpret_cast<const uint2*>(
                    xr + k * st.sw + static_cast<size_t>(nsub - 1) * SUB +
                    lane * 4));
                const uint32_t wd[2] = {h.x, h.y};
                mw[k] = WordMax<T>::max(WordMax<T>::max(mw[k], h.x), h.y);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[k][e % S::C] += static_cast<double>(Cvt<T>::get(wd, e));
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          double s = acc[k][0];
#pragma unroll
          for (int c = 1; c < S::C; ++c) s += acc[k][c];
          float m = WordMax<T>::fold(mw[k]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
          }
          if (lane == 0) {
            psum[par][warp][k] = s;
            pmax[par][warp][k] = m;
          }
        }
      }
      __syncthreads();
      // thread t folds the parts of slot base + t / K, stream t % K, in
      // part order
      const int g = threadIdx.x / K, k = threadIdx.x % K;
      if (g < spr && base + g < s1 && k < nk) {
        double s = 0.0;
        float m = __uint_as_float(0xff800000u);    // -inf
        for (int i = 0; i < parts; ++i) {
          s += psum[par][g * parts + i][k];
          m = nan_max(m, pmax[par][g * parts + i][k]);
        }
        const size_t row = static_cast<size_t>(base + g) +
                           static_cast<size_t>(k0 + k) * seg;
        mx[row] = m;
        sm[row] = static_cast<float>(s);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
rowdot(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
       const float* __restrict__ scale_ptr, float scale, int cols, int d,
       int seg, int bm, int ns, bool interleaved) {
  RowDot<T> body{A, x, y, cols, scale_ptr, scale};
  row_sweep(cols, d, seg, bm, ns, interleaved, body);
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

template <typename T, int K>
int stat_k(const void* x, void* mx, void* sm, int cols, int d, int seg,
           int parts, int spb, int grid, int interleaved,
           cudaStream_t stream) {
  rowstat<T, K><<<grid, STAT_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(mx),
      static_cast<float*>(sm), cols, d, seg, parts, spb, interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stat(const void* x, void* mx, void* sm, int rows, int cols,
                int d, int bm, int parts, int spb, int grid, int interleaved,
                cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, 1) ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8) || spb <= 0 ||
      grid <= 0 || static_cast<long long>(grid) * spb < rows / d ||
      static_cast<long long>(grid - 1) * spb >= rows / d)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  // streams a group: the smallest power of two up to d, at most 4 (a
  // group of 8 spills: 8 row pointers beside two steps and 8 sums)
  if (d > 2) return stat_k<T, 4>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
  if (d > 1) return stat_k<T, 2>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
  return stat_k<T, 1>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
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

// x: [rows, cols] of `dtype`, row-major (cols a multiple of 128); mx,
// sm: [rows] f32, the row max and the row sum.  d streams of seg =
// rows / d rows (bm row slots per block in the plan, checked only to
// divide seg); the launch geometry (rowstat_geometry): grid blocks of
// spb consecutive row slots, each slot's columns in `parts` parts (1, 2,
// 4 or 8), loaded grouped (interleaved = 0) or interleaved (1).
extern "C" int rowstat_launch(int dtype, const void* x, void* mx, void* sm,
                              int rows, int cols, int d, int bm, int parts,
                              int spb, int grid, int interleaved,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_stat<float>(x, mx, sm, rows, cols, d, bm, parts, spb, grid, interleaved, st);
    case kBF16: return launch_stat<__nv_bfloat16>(x, mx, sm, rows, cols, d, bm, parts, spb, grid, interleaved, st);
    case kF16: return launch_stat<__half>(x, mx, sm, rows, cols, d, bm, parts, spb, grid, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
