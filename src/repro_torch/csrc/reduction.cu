// Multi-strided row reductions for Hopper (sm_90a): the row-dot
// (matrix-vector product) and the row statistics (max and sum).
//
// Replaces these instances of the JAX package's K2 template,
// _emit_reduction (src/repro/codegen/emit.py:491):
//   * mxv, bicg_q and gemver_mxv2 (src/repro/kernels/{mxv,bicg,gemver}/
//     specs.py), the row-dot rowdot:
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
//
// Both keep the paper's D concurrent streams on one sweep.  The read is
// bound by the bytes in flight (Little's law: 3.35 TB/s x ~1 us of
// loaded DRAM latency, about 25 KB an SM), so:
//   * a lane loads 16 bytes a unit in every type (8 elements of a pair
//     of adjacent sub-portions in bf16 and f16), and keeps the next
//     step's 8 loads in flight while it folds the current one: 4 KB a
//     warp, 64 KB an SM at two blocks of 8 warps;
//   * the grid is one wave of at most two blocks an SM; a block walks a
//     run of row slots (a slot: the D rows s + k*seg), and where the
//     slots are too few to fill the wave a slot's columns are cut into
//     parts, a warp a part, merged in part order (rowstat_geometry in
//     kernels/gen/kernel.py, rowdot_geometry in kernels/mxv/kernel.py);
//   * rowstat's row max is one max.NaN instruction a word (two elements
//     in 16-bit types), and each stream keeps 8 / K independent sums a
//     lane (f64 for rowstat, f32 products and sums for the row-dot), so
//     the adds are not one dependent chain;
//   * the row-dot's x is staged once a block in shared memory (cp.async,
//     issued before the first step's loads of A and waited for after
//     them) where it takes at most 64 KiB, and read through __ldg above
//     that: the loop's global loads are A's alone.  On the TPU one f32
//     (D, bm) accumulator was carried across the sequential column grid;
//     here that grid is the warp's loop, and the sums are folded in a
//     fixed order: a lane's sums in order, a warp shuffle tree, the parts
//     in part order, then scaled by s and rounded once to A's dtype.
// P (the plan's sub-portions a column step) does not shape the steps,
// as it does not the read's (stream.cu).
//
// The arithmetic runs in one fixed order whatever the arrangement, so
// the grouped and interleaved arrangements give the same bits.  The
// max is exact (it propagates a NaN, as torch's amax does).  Against
// the plain version (a vectorised f32 sum in another order) the row-dot
// agrees within f32 reassociation error, n * 2^-24 * sum_j |A[i, j] *
// x[j]| per element, plus the output's rounding; the row sum, taken in
// f64 and rounded once, within the plain version's own f32 error.
#include "common.cuh"

namespace {

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

// The row statistics (rowstat_spec), the sweep the row-dot shares.  A
// block of STAT_WARPS warps walks
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

// The 16-byte lane units of K streams of one warp (rowstat, the
// row-dot): x is the warp's first element of stream 0 (its lane's
// offset in), sw the elements between streams; a step is U units of
// each stream.
template <typename T, int K>
struct LaneSteps {
  static constexpr bool HALF = sizeof(T) == 2;
  static constexpr int PER = HALF ? 2 : 1;          // sub-portions a unit
  static constexpr int EPL = HALF ? 8 : 4;          // elements a lane a unit
  static constexpr int U = 8 / K;                   // units a stream a step
  static constexpr int C = 8 / K;                   // sums a stream
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
};

template <typename T, int K>
struct StatSteps : LaneSteps<T, K> {
  using L = LaneSteps<T, K>;
  using L::EPL;
  using L::U;
  using L::C;

  // the step's elements into each stream's sums and max, in unit order
  __device__ __forceinline__ void add(int u, const uint4 (&b)[K][U],
                                      double (&acc)[K][C],
                                      uint32_t (&mw)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < U; ++j)
        if (k < this->nk && u + j < this->u1) {
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
        const S st{{xr + lane * S::EPL, static_cast<size_t>(seg) * cols, nk,
                    min(nu, u0 + upp), interleaved}};
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

// The row-dot (mxv, bicg_q, gemver_mxv2) on rowstat's sweep: a block of
// STAT_WARPS warps walks a run of spb row slots, each slot's columns in
// `parts` parts, a warp a part, merged in part order; a step is U = 8 /
// K 16-byte units of each of K streams, the next step's in flight.
// Each stream keeps C = 8 / K independent f32 sums a lane (element i of
// a step into sum i % C, f32(A) * f32(x) by fmaf).  x comes from shared
// memory (XS: staged once a block by cp.async) or through __ldg.
constexpr int DOT_X_SHARED = 65536;      // most bytes of x a block stages

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T, int K, bool XS>
struct DotSteps : LaneSteps<T, K> {
  using L = LaneSteps<T, K>;
  using L::EPL;
  using L::U;
  using L::C;
  const uint4* xv;        // x in 16-byte vectors (shared or global
                          // memory) from the lane's: unit u at xv[u * 32]

  __device__ __forceinline__ uint4 xunit(int u) const {
    if constexpr (XS) return xv[u * 32];
    else return __ldg(xv + u * 32);
  }

  // the step's products into each stream's sums, in unit order
  __device__ __forceinline__ void add(int u, const uint4 (&b)[K][U],
                                      float (&acc)[K][C]) const {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (u + j < this->u1) {
        const uint4 xw = xunit(u + j);
        const uint32_t xd[4] = {xw.x, xw.y, xw.z, xw.w};
        float xf[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) xf[e] = Cvt<T>::get(xd, e);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k < this->nk) {
            const uint32_t wd[4] = {b[k][j].x, b[k][j].y, b[k][j].z,
                                    b[k][j].w};
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[k][(j * EPL + e) % C] =
                  fmaf(Cvt<T>::get(wd, e), xf[e], acc[k][(j * EPL + e) % C]);
          }
      }
    }
  }
};

template <typename T, int K, bool XS>
__global__ void __launch_bounds__(STAT_THREADS, 2)
rowdot(const T* __restrict__ A, const T* __restrict__ x, T* __restrict__ y,
       const float* __restrict__ scale_ptr, float scale, int cols, int d,
       int seg, int parts, int spb, bool interleaved) {
  using S = DotSteps<T, K, XS>;
  extern __shared__ uint4 xs[];               // x, where XS
  __shared__ float psum[2][STAT_WARPS][K];    // part partials, by parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsub = cols / SUB;
  const int nu = nsub / S::PER;                     // whole units a row
  const bool tail = S::HALF && (nsub & 1);          // a lone sub-portion
  const int upp = (nu + parts - 1) / parts;         // units a part
  const int spr = STAT_WARPS / parts;               // slots a round
  const int q = warp % parts;
  const int u0 = min(nu, q * upp);
  const int s0 = blockIdx.x * spb, s1 = min(seg, s0 + spb);
  const uint4* xg = reinterpret_cast<const uint4*>(x);
  if constexpr (XS) {
    const int nv = cols / S::EPL;                   // x's 16-byte vectors
    for (int i = threadIdx.x; i < nv; i += STAT_THREADS)
      cp_async16(xs + i, xg + i);
  }
  bool staging = XS;
  int par = 0;
  // rounds and groups are the same for every warp of the block, so the
  // barriers below are reached by all; the partials alternate by parity
  for (int base = s0; base < s1; base += spr) {
    const int slot = base + warp / parts;
    for (int k0 = 0; k0 < d; k0 += K, par ^= 1) {
      const int nk = min(K, d - k0);
      const bool on = slot < s1;
      const T* ar = A + (static_cast<size_t>(on ? slot : s0) +
                         static_cast<size_t>(k0) * seg) * cols;
      const S st{{ar + lane * S::EPL, static_cast<size_t>(seg) * cols, nk,
                  min(nu, u0 + upp), interleaved},
                 (XS ? xs : xg) + lane};
      float acc[K][S::C];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < S::C; ++c) acc[k][c] = 0.f;
      // two steps in registers: the next one's loads are in flight
      // while the current one is folded
      uint4 a[K][S::U], b[K][S::U];
      int u = u0;
      if (on && u < st.u1) st.load(u, a);
      if (staging) {                  // x has landed once, for the block
        cp_async_wait_all();
        __syncthreads();
        staging = false;
      }
      if (on) {
        for (; u < st.u1; u += 2 * S::U) {
          if (u + S::U < st.u1) st.load(u + S::U, b);
          st.add(u, a, acc);
          if (u + S::U >= st.u1) break;
          if (u + 2 * S::U < st.u1) st.load(u + 2 * S::U, a);
          st.add(u + S::U, b, acc);
        }
        if constexpr (S::HALF) {
          if (tail && q == parts - 1) {   // 4 elements a lane, 8 bytes
            const size_t off = static_cast<size_t>(nsub - 1) * SUB + lane * 4;
            const uint2 xh =
                XS ? reinterpret_cast<const uint2*>(xs)[(nsub - 1) * 32 + lane]
                   : __ldg(reinterpret_cast<const uint2*>(x + off));
            const uint32_t xd[2] = {xh.x, xh.y};
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if (k < nk) {
                const uint2 h = __ldg(reinterpret_cast<const uint2*>(
                    ar + k * st.sw + off));
                const uint32_t wd[2] = {h.x, h.y};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[k][e % S::C] = fmaf(Cvt<T>::get(wd, e),
                                          Cvt<T>::get(xd, e),
                                          acc[k][e % S::C]);
              }
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v = acc[k][0];
#pragma unroll
          for (int c = 1; c < S::C; ++c) v += acc[k][c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) psum[par][warp][k] = v;
        }
      }
      __syncthreads();
      // thread t folds the parts of slot base + t / K, stream t % K, in
      // part order, and stores its scaled sum in A's dtype
      const int g = threadIdx.x / K, k = threadIdx.x % K;
      if (g < spr && base + g < s1 && k < nk) {
        float v = 0.f;
        for (int i = 0; i < parts; ++i) v += psum[par][g * parts + i][k];
        const float sc = scale_ptr ? *scale_ptr : scale;
        y[static_cast<size_t>(base + g) + static_cast<size_t>(k0 + k) * seg] =
            Cvt<T>::from(sc * v);
      }
    }
  }
}

// the instance and grid of the last row-dot launch: streams a group,
// x in shared memory (1) or through __ldg (0), blocks
int last_dot[3] = {0, 0, 0};

template <typename T, int K, bool XS>
int dot_k(const void* A, const void* x, void* y, const void* scale_ptr,
          float scale, int cols, int d, int seg, int parts, int spb,
          int grid, int interleaved, cudaStream_t stream) {
  auto* kernel = rowdot<T, K, XS>;
  const int smem = XS ? cols * static_cast<int>(sizeof(T)) : 0;
  static bool opted = false;
  if (XS && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DOT_X_SHARED);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  kernel<<<grid, STAT_THREADS, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(scale_ptr), scale, cols, d, seg, parts, spb,
      interleaved != 0);
  last_dot[0] = K;
  last_dot[1] = XS;
  last_dot[2] = grid;
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool XS>
int dot_x(const void* A, const void* x, void* y, const void* scale_ptr,
          float scale, int cols, int d, int seg, int parts, int spb,
          int grid, int interleaved, cudaStream_t stream) {
  // streams a group: the smallest power of two up to d, at most 4
  if (d > 2) return dot_k<T, 4, XS>(A, x, y, scale_ptr, scale, cols, d, seg, parts, spb, grid, interleaved, stream);
  if (d > 1) return dot_k<T, 2, XS>(A, x, y, scale_ptr, scale, cols, d, seg, parts, spb, grid, interleaved, stream);
  return dot_k<T, 1, XS>(A, x, y, scale_ptr, scale, cols, d, seg, parts, spb, grid, interleaved, stream);
}

// the run and part geometry rowstat and the row-dot share
// (rowstat_geometry), checked
inline bool bad_lane_geometry(int rows, int cols, int d, int bm, int parts,
                              int spb, int grid) {
  return bad_sweep_geometry(rows, cols, d, bm, 1) ||
         (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
         spb <= 0 || grid <= 0 ||
         static_cast<long long>(grid) * spb < rows / d ||
         static_cast<long long>(grid - 1) * spb >= rows / d;
}

template <typename T>
int launch(const void* A, const void* x, void* y, const void* scale_ptr,
           float scale, int rows, int cols, int d, int bm, int parts,
           int spb, int grid, int xs, int interleaved, cudaStream_t stream) {
  if (bad_lane_geometry(rows, cols, d, bm, parts, spb, grid) ||
      (xs && static_cast<long long>(cols) * sizeof(T) > DOT_X_SHARED))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  if (xs)
    return dot_x<T, true>(A, x, y, scale_ptr, scale, cols, d, seg, parts, spb, grid, interleaved, stream);
  return dot_x<T, false>(A, x, y, scale_ptr, scale, cols, d, seg, parts, spb, grid, interleaved, stream);
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
  if (bad_lane_geometry(rows, cols, d, bm, parts, spb, grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  // streams a group: the smallest power of two up to d, at most 4 (a
  // group of 8 spills: 8 row pointers beside two steps and 8 sums)
  if (d > 2) return stat_k<T, 4>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
  if (d > 1) return stat_k<T, 2>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
  return stat_k<T, 1>(x, mx, sm, cols, d, seg, parts, spb, grid, interleaved, stream);
}

}  // namespace

// A: [rows, cols] of the element type `dtype`, row-major, 16-byte
// aligned (cols a multiple of 128); x: [cols]; y: [rows] of `dtype`,
// scaled by *scale_ptr (an f32 on the card) where scale_ptr is not null,
// else by scale.  d streams of seg = rows / d rows (bm row slots per
// block in the plan, checked only to divide seg); the launch geometry
// (rowdot_geometry): grid blocks of spb consecutive row slots, each
// slot's columns in `parts` parts (1, 2, 4 or 8), x staged in shared
// memory (xs = 1, at most 64 KiB of it) or read through __ldg (0),
// loaded grouped (interleaved = 0) or interleaved (1).
extern "C" int rowdot_launch(int dtype, const void* A, const void* x,
                             void* y, const void* scale_ptr, float scale,
                             int rows, int cols, int d, int bm, int parts,
                             int spb, int grid, int xs, int interleaved,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(A, x, y, scale_ptr, scale, rows, cols, d, bm, parts, spb, grid, xs, interleaved, st);
    case kBF16: return launch<__nv_bfloat16>(A, x, y, scale_ptr, scale, rows, cols, d, bm, parts, spb, grid, xs, interleaved, st);
    case kF16: return launch<__half>(A, x, y, scale_ptr, scale, rows, cols, d, bm, parts, spb, grid, xs, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The last row-dot launch's instance and grid (streams a group, x in
// shared memory or not, blocks) into out[0..2].
extern "C" void rowdot_last_launch(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = last_dot[i];
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
