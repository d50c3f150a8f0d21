// Multi-strided doitgen for Hopper (sm_90a): a batched contraction with a
// resident operand (an instance of K1 with a batch axis and a free axis).
//
// Replaces the doitgen instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// src/repro/kernels/doitgen/specs.py:
//   o[b, q, p] = sum over s of f32(A[b, q, s]) * f32(C4[s, p])
// over A [r, rows, s], C4 [s, p] -> o [r, rows, p], summed in f32 in the
// order s = 0, 1, ... with fused multiply-adds, no tensor cores (TF32
// would round the operands), and rounded once to T at the store.
// Against the plain version (an f32 product, summed in its own order)
// it agrees within the f32 dot-product limit of s terms.
//
// What bounds it: at the paper's sizes, operations.  Each output takes
// 2 s flops; A is read once, C4 (at most 256 KiB) stays in L2, and o is
// written once: at s = p = 256 f32 that is 64 flops per byte of A and
// o, three times the card's 20 f32 flops per byte.
//
// What the design does about it.  The TPU kernel's grid is (batch r,
// row block); each step loads the D stream blocks A[r, i + k*seg, :] at
// whole width (s is a free axis) and contracts them against the
// resident C4 inside the body.  Here block (b, run, p tile) owns batch
// element b, a run of rb rows of every stream (the d * rb rows
// k * seg + run * rb + t; rb a multiple of the plan's bm, chosen by
// kernels/doitgen/kernel.py block_rows so that a block has about 128
// rows and the grid still fills the card) and PT = 128 columns of p.
// Each block re-reads its [s, PT] tile of C4 from L2, so rows a block
// are what amortises it: at 8-32 rows a block the C4 re-reads, not the
// multiply-adds, set the time.  It walks s in chunks of SC: each thread
// loads its share of the chunk of every stream's rows and of C4's
// [SC, PT] tile into registers, widened to f32, and stores them to
// shared memory; the loads of the next chunk are issued before the
// multiply-adds of this one, so their latency hides behind them.  Each
// thread accumulates RPT rows x 8 columns of o (RPT = 8 at 128 rows),
// reading A by broadcast and C4 as two 16-byte loads per s (the columns
// tx*4 ... and 64 + tx*4 ..., so a warp's loads are contiguous).  A
// thread stages a fixed column of s, for rows whose offsets it computes
// once a pass, and keeps to 128 registers so that two blocks share an
// SM and one block's __syncthreads hide behind the other's work (RPT = 8
// spills 96-160 bytes).  The whole of C4 (256 KiB at s = p = 256 f32)
// does not fit a block's 227 KB of shared memory, so it is tiled in p
// and staged in chunks of s.  Any s and p are taken (p = 32 at the
// conformance size); the ragged chunk and tile are masked.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TY = 16;              // threads down the block's rows
constexpr int TX = THREADS / TY;    // threads across its p tile
constexpr int VEC = 8;              // p columns a thread
constexpr int PT = TX * VEC;        // p columns a block (128)
constexpr int HALF = PT / 2;
constexpr int SC = 32;              // s chunk staged per step

// RPT rows a thread: a pass covers TY * RPT of the block's d * rb rows
template <typename T, int RPT>
__global__ void __launch_bounds__(THREADS, 2)
doitgen(const T* __restrict__ A, const T* __restrict__ C4, T* __restrict__ o,
        int rows, int s, int p, int d, int rb, int runs) {
  constexpr int PR = TY * RPT;                   // rows of a pass
  constexpr int NA = PR * SC / THREADS;          // A elements a thread stages
  constexpr int NC = SC * PT / THREADS;          // C4 elements a thread stages
  constexpr int AROWS = THREADS / SC;            // rows one staging load covers
  constexpr int CROWS = THREADS / PT;            // C4 rows one covers
  static_assert(NA * THREADS == PR * SC && NC * THREADS == SC * PT,
                "whole staging shares");
  __shared__ float As[PR][SC + 1];
  __shared__ __align__(16) float Cs[SC][PT];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x / runs, run = blockIdx.x % runs;
  const int p0 = blockIdx.y * PT;
  const int seg = rows / d, nrows = d * rb;
  const T* Ab = A + static_cast<size_t>(b) * rows * s;
  T* ob = o + static_cast<size_t>(b) * rows * p;
  // g-th row of the block: stream g / rb, row g % rb of the run
  auto row_of = [&](int g) { return (g / rb) * seg + run * rb + g % rb; };
  // a thread stages one column of s (sa) of rows tid / SC + e * AROWS of
  // the pass, and one column of p (pc) of C4 rows tid / PT + e * CROWS
  const int sa = tid % SC, pc = tid % PT;
  const bool pin = p0 + pc < p;

  for (int g0 = 0; g0 < nrows; g0 += PR) {
    int aoff[NA];                // every stream's rows (-1: past the block)
#pragma unroll
    for (int e = 0; e < NA; ++e) {
      const int g = g0 + tid / SC + e * AROWS;
      aoff[e] = g < nrows ? row_of(g) * s : -1;
    }
    float av[NA], cv[NC];
    // the loads of one chunk: every stream's rows of the pass, then C4
    auto stage = [&](int s0) {
      const int sn = min(SC, s - s0);
#pragma unroll
      for (int e = 0; e < NA; ++e)
        av[e] = (aoff[e] >= 0 && sa < sn) ? Cvt<T>::to(Ab[aoff[e] + s0 + sa])
                                          : 0.f;
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int ss = tid / PT + e * CROWS;
        cv[e] = (ss < sn && pin)
                    ? Cvt<T>::to(C4[static_cast<size_t>(s0 + ss) * p + p0 + pc])
                    : 0.f;
      }
    };
    float acc[RPT][VEC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) acc[i][jj] = 0.f;
    stage(0);
    for (int s0 = 0; s0 < s; s0 += SC) {
      const int sn = min(SC, s - s0);
#pragma unroll
      for (int e = 0; e < NA; ++e) As[tid / SC + e * AROWS][sa] = av[e];
#pragma unroll
      for (int e = 0; e < NC; ++e) Cs[tid / PT + e * CROWS][pc] = cv[e];
      __syncthreads();
      if (s0 + SC < s) stage(s0 + SC);           // next chunk in flight
#pragma unroll 4
      for (int ss = 0; ss < sn; ++ss) {
        const float4 c0 = *reinterpret_cast<const float4*>(&Cs[ss][tx * 4]);
        const float4 c1 =
            *reinterpret_cast<const float4*>(&Cs[ss][HALF + tx * 4]);
        const float c[VEC] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float a = As[ty + i * TY][ss];
#pragma unroll
          for (int jj = 0; jj < VEC; ++jj) acc[i][jj] = fmaf(a, c[jj], acc[i][jj]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int g = g0 + ty + i * TY;
      if (g >= nrows) continue;
      T* orow = ob + static_cast<size_t>(row_of(g)) * p;
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) {
        const int col = p0 + (jj < 4 ? 0 : HALF - 4) + tx * 4 + jj;
        if (col < p) orow[col] = Cvt<T>::from(acc[i][jj]);
      }
    }
  }
}

template <typename T>
int launch(const void* A, const void* C4, void* o, int r, int rows, int s,
           int p, int d, int rb, cudaStream_t stream) {
  // a batch element's rows * s offsets are ints
  if (r <= 0 || rows <= 0 || s <= 0 || p <= 0 || d <= 0 || rb <= 0 ||
      rows % d != 0 || (rows / d) % rb != 0 ||
      static_cast<long long>(rows) * s > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int runs = rows / d / rb;
  const int tiles = (p + PT - 1) / PT;
  if (static_cast<long long>(r) * runs > 2147483647LL || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(r * runs, tiles);
  const T* a = static_cast<const T*>(A);
  const T* c = static_cast<const T*>(C4);
  T* out = static_cast<T*>(o);
  const int nrows = d * rb;
  if (nrows <= TY) {
    doitgen<T, 1><<<grid, THREADS, 0, stream>>>(a, c, out, rows, s, p, d, rb, runs);
  } else if (nrows <= 2 * TY) {
    doitgen<T, 2><<<grid, THREADS, 0, stream>>>(a, c, out, rows, s, p, d, rb, runs);
  } else if (nrows <= 4 * TY) {
    doitgen<T, 4><<<grid, THREADS, 0, stream>>>(a, c, out, rows, s, p, d, rb, runs);
  } else {
    doitgen<T, 8><<<grid, THREADS, 0, stream>>>(a, c, out, rows, s, p, d, rb, runs);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A: [r, rows, s] of `dtype`, C4: [s, p], o: [r, rows, p], all row-major.
// d streams of seg = rows / d rows, rb rows of each per block (rb divides
// seg); any s and p, any alignment.
extern "C" int doitgen_launch(int dtype, const void* A, const void* C4,
                              void* o, int r, int rows, int s, int p, int d,
                              int rb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(A, C4, o, r, rows, s, p, d, rb, st);
    case kBF16: return launch<__nv_bfloat16>(A, C4, o, r, rows, s, p, d, rb, st);
    case kF16: return launch<__half>(A, C4, o, r, rows, s, p, d, rb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
