// Multi-strided fused AdamW update for Hopper (sm_90a).
//
// Replaces the adamw_update instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// adamw_spec (src/repro/kernels/adamw/specs.py): on the [rows, cols]
// re-blocking of one flattened parameter tensor (kernels/adamw/ops.py
// _blocking),
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p
//   p' = p - lr * u
// in f32, with p and g of type T (f32, bf16 or f16) widened, m and v f32.
// p' is stored in T (one rounding from f32, what the op returns after
// the spec's f32 p'), m' and v' in f32.
//
// What bounds it: bytes.  Four reads and three writes an element (28
// bytes in f32) for about eight flops, one square root and two divisions,
// far below the card's ~20 flops per byte of f32 arithmetic.
//
// What the design does about it: it keeps the paper's D concurrent
// streams, on common.cuh's row_sweep as stream.cu's K1 kernels do.  The
// rows are split into D segments of seg = rows / D; block j owns the row
// slots j*bm ... j*bm + bm - 1 of every segment, one warp per slot.  In
// each column step the warp starts the 16-byte (f32) loads of all four
// operands for the rows r + k*seg of up to four streams over the step's
// P 128-element sub-portions (load_stream_step, in the config's
// arrangement) before any arithmetic, then runs the body and makes the
// three stores.  A group holds two streams (row_sweep's KMAX), not the
// eight of the one- and two-operand bodies: four operands of two streams
// and two sub-portions are 64 floats a lane in registers.  At the
// default D = 2 that is every stream; four streams a group took 184
// registers a thread, one 256-thread block an SM, and half the bytes in
// flight that two blocks an SM keep.
//
// The body and its seven scalars are adamw.cuh's AdamWBody, shared with
// the K4 ring's adamw body (manual_ring.cu): bit for bit the plain
// version's arithmetic.
#include "adamw.cuh"

namespace {

constexpr int AK = 2;                 // streams of a group (row_sweep KMAX)
constexpr int AP = SWEEP_PMAX;        // sub-portions in registers per pass

template <typename T>
struct AdamWStep {
  const T* p;
  const T* g;
  const float* m;
  const float* v;
  T* po;
  float* mo;
  float* vo;
  int cols;
  AdamWBody h;

  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void end(int, int, int, int) {}

  __device__ __forceinline__ void step(int rk, int seg, int nk, int c0,
                                       int np, bool interleaved, int lane) {
    float pv[AK][AP][4], gv[AK][AP][4], mv[AK][AP][4], vv[AK][AP][4];
    load_stream_step<T, AK, AP>(p, cols, rk, seg, nk, c0, np, interleaved,
                                lane, pv);
    load_stream_step<T, AK, AP>(g, cols, rk, seg, nk, c0, np, interleaved,
                                lane, gv);
    load_stream_step<float, AK, AP>(m, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, mv);
    load_stream_step<float, AK, AP>(v, cols, rk, seg, nk, c0, np,
                                    interleaved, lane, vv);
#pragma unroll
    for (int k = 0; k < AK; ++k) {
#pragma unroll
      for (int q = 0; q < AP; ++q) {
        if (k < nk && q < np) {
          float pn[4], mn[4], vn[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h.apply(pv[k][q][e], gv[k][q][e], mv[k][q][e], vv[k][q][e],
                    pn[e], mn[e], vn[e]);
          const size_t off = static_cast<size_t>(rk + k * seg) * cols + c0 +
                             q * SUB + lane * 4;
          store_f32<T, 4>(po + off, pn);
          store_f32<float, 4>(mo + off, mn);
          store_f32<float, 4>(vo + off, vn);
        }
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(SWEEP_MAX_WARPS * 32)
adamw_update(const T* __restrict__ p, const T* __restrict__ g,
             const float* __restrict__ m, const float* __restrict__ v,
             const float* __restrict__ s, T* __restrict__ po,
             float* __restrict__ mo, float* __restrict__ vo, int cols, int d,
             int seg, int bm, int ns, bool interleaved) {
  AdamWStep<T> body{p, g, m, v, po, mo, vo, cols, {}};
  body.h.load(s);
  row_sweep<AdamWStep<T>, AK>(cols, d, seg, bm, ns, interleaved, body);
}

template <typename T>
int adamw_t(const void* p, const void* g, const void* m, const void* v,
            const void* s, void* po, void* mo, void* vo, int rows, int cols,
            int d, int bm, int ns, int interleaved, cudaStream_t stream) {
  if (bad_sweep_geometry(rows, cols, d, bm, ns))
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = rows / d;
  adamw_update<T><<<seg / bm, sweep_warps(bm) * 32, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(s), static_cast<T*>(po),
      static_cast<float*>(mo), static_cast<float*>(vo), cols, d, seg, bm, ns,
      interleaved != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p, g, po: [rows, cols] of `dtype`; m, v, mo, vo: [rows, cols] f32; s:
// f32 [7] = (lr, b1, b2, eps, wd, bc1, bc2); all row-major, 16-byte
// aligned, on the card.  d streams of seg = rows / d rows, bm row slots
// per block; column steps of ns 128-element sub-portions, loaded grouped
// (interleaved = 0) or interleaved (1).  cols a multiple of 128.
extern "C" int adamw_launch(int dtype, const void* p, const void* g,
                            const void* m, const void* v, const void* s,
                            void* po, void* mo, void* vo, int rows, int cols,
                            int d, int bm, int ns, int interleaved,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return adamw_t<float>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, ns, interleaved, st);
    case kBF16: return adamw_t<__nv_bfloat16>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, ns, interleaved, st);
    case kF16: return adamw_t<__half>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, ns, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
