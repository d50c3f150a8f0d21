// The explicit lookahead ring (template K4) for Hopper (sm_90a): bulk
// copies into shared memory on mbarriers, the body fused between load
// and store, and bulk stores out of a 2-deep staging ring.
//
// Replaces the JAX package's K4 template, _emit_manual
// (src/repro/codegen/emit.py:708), which the JAX package selects at a
// lookahead other than 2 for specs with plain (stride, vector) reads
// and (stride, vector) or rank-1 (stride,) writes.  Its bodies here:
//   copy:        y = x             (stream_copy, stream_copy_manual)
//   triad:       a = b + alpha * c (stream_triad)
//   fill:        y = value         (stream_init: no loads)
//   gemver_sum:  o = x + z         (gemver_sum on its 1-D blocking)
//   adamw:       (p', m', v') from (p, g, m, v) and seven scalars
//                (adamw_update; adamw.cuh's AdamWBody): p, g and p' of
//                the ring's type T (f32, bf16, f16), m, v, m', v' f32
//   rowstat:     o = 2 x and the row statistic r = sum_j f32(x), o and
//                r f32, x f32 or bf16 (t_rowstat: the map-plus-row-
//                statistic spec of the JAX package's K4 test,
//                tests/test_codegen.py _rowstat_spec; it exists for that
//                spec, the one that reaches a rank-1 side write)
// each operation rounded to its output's type as the body rounds it, so
// every map output equals its plain version bit for bit; the row
// statistic is an f32 sum in another order than the plain version's.
//
// What the TPU kernel computes: for each operand a ring of `lookahead`
// stages, each stage the D stream copies of one step (rows
// k*seg + t*bm ... of every stream k), all D copies of a step signalling
// one semaphore per slot; the body runs on a stage once it has landed;
// the outputs drain through a 2-deep staging ring whose waits are
// deferred to the step that reuses the slot, and an epilogue drains the
// rest.  Each write has its own store geometry: a (stride,) side write
// stages one lane per row next to its full-row siblings (emit.py
// :732-734, :788-791), and each operand's ring has its own dtype (:819).
// lookahead=1 is prefetch off: the copies of step t+1 start only after
// the body of step t.
//
// What bounds it: bytes, as the stream kernels (at most two flops per
// element moved; adamw's body, about ten flops for 28 bytes, too).
//
// On Hopper:
//   * Dynamic shared memory holds lookahead x D stages per input and
//     2 x D staging stages per output, each in its operand's element
//     size (a body's operands are of the ring's type T or f32: a
//     compile-time mask each for inputs and outputs, Elem below), with
//     one mbarrier per (input, slot), armed with expect_tx for the D
//     copies' bytes; and for a rank-1 output 2 staging slots of D x bm
//     f32 lanes.
//   * Thread 0 issues the copies: cp.async.bulk global -> shared, one
//     per row piece of a stage, in the config's arrangement (grouped:
//     a stream's rows back to back; interleaved: the streams round-robin
//     row by row), and the stores: cp.async.bulk shared -> global, every
//     full-row output's in one bulk group per step, with
//     wait_group.read 1 before a staging slot is written again.
//   * A step is a (row block, column tile): the TPU ring streamed whole
//     rows, which at 4096 f32 columns and bm = 8 would be 128 KiB a
//     stream stage, beyond the 227 KB a block may use.  The tile is the
//     widest whole number of 128-element sub-portions dividing the row
//     that fits the ring under the opt-in limit (kernels/manual.py
//     ring_tile, which raises where even 128 columns do not fit).
//   * A spec with a rank-1 write steps by whole rows, as the TPU ring
//     did, so that a row statistic sees its whole row in one stage (a
//     column tile would split it across steps, and a run of steps could
//     end inside a row).  ring_tile raises ValueError naming the bytes
//     where a whole-row ring does not fit.  After the map, each warp
//     reduces rows of the stage (lanes stride the row, then a shuffle
//     tree, one fixed order) into the rank-1 staging slot, and after the
//     step's barrier the threads store it, one f32 a row: bm f32 lanes
//     are 16-byte bulk pieces only where bm % 4 == 0, so thread stores
//     serve every bm.
//   * The TPU ran the whole ring on one core in order.  Here the grid
//     splits each segment's steps into contiguous runs, about two blocks
//     per SM; each block runs its own prologue, ring and epilogue.
//   * Ordering: a __syncthreads between the last read of an input slot
//     and its refill; fence.proxy.async.shared::cta between the threads'
//     writes to a staging slot and the bulk store that reads it.
//     cp.async.bulk needs 16-byte aligned addresses and sizes: rows of
//     whole sub-portions and 16-byte aligned operands (the wrapper
//     checks) give that for every element size.
#include <type_traits>

#include "adamw.cuh"

namespace {

constexpr int RING_THREADS = 256;
constexpr int OUT_STAGES = 2;          // the staging ring's depth

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A phase that never completes (a lost copy) fails the launch with a
// trap after 2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// At most N bulk groups of this thread still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Bytes of the barrier header in front of the stages (kernels/manual.py
// ring_smem mirrors this).
__host__ __device__ inline size_t ring_header(int nin, int la) {
  return (static_cast<size_t>(8) * nin * la + 127) / 128 * 128;
}

// Bytes of one rank-1 staging slot: D x bm f32 lanes, padded to 16.
__host__ __device__ inline size_t row_slot_bytes(int d, int bm) {
  return (static_cast<size_t>(d) * bm * 4 + 15) / 16 * 16;
}

// The element type of operand R of a ring of type T: f32 where bit R of
// the mask is set (adamw's m and v, rowstat's outputs), else T.
template <typename T, unsigned MASK, int R>
using Elem = typename std::conditional<((MASK >> R) & 1u) != 0u, float,
                                       T>::type;

// The summed element sizes of operands 0 ... n-1.
template <typename T, unsigned MASK>
__host__ __device__ constexpr size_t elem_prefix(int n) {
  size_t s = 0;
  for (int i = 0; i < n; ++i)
    s += ((MASK >> i) & 1u) ? sizeof(float) : sizeof(T);
  return s;
}

// f(std::integral_constant<int, I>) for I = 0 ... N-1, unrolled: each
// operand's element type is a compile-time choice.
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// N elements of E from shared memory (N * sizeof(E) a multiple of 16,
// the address aligned to 16), widened to f32; and back, narrowed.
template <typename E, int N>
__device__ __forceinline__ void smem_get(const E* p, float* f) {
  constexpr int W = N * static_cast<int>(sizeof(E)) / 4;
  static_assert(W % 4 == 0, "whole 16-byte vectors");
  uint32_t w[W];
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z; w[4 * i + 3] = u.w;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = Cvt<E>::get(w, e);
}

template <typename E, int N>
__device__ __forceinline__ void smem_put(E* p, const float* f) {
  constexpr int W = N * static_cast<int>(sizeof(E)) / 4;
  static_assert(W % 4 == 0, "whole 16-byte vectors");
  uint32_t w[W] = {};
#pragma unroll
  for (int e = 0; e < N; ++e) Cvt<E>::put(w, e, f[e]);
#pragma unroll
  for (int i = 0; i < W / 4; ++i)
    reinterpret_cast<uint4*>(p)[i] =
        make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

struct Ring {
  int cols, seg, d, bm, tw, la, ntiles, steps, per;
  bool interleaved;
};

// A body: prepare() once a block, before the ring starts; then
// operator()(a, o) maps one element of each input (widened to f32) to
// one element of each full-row output; a body with rank-1 outputs also
// has row(a, t), the f32 term of each row statistic that element adds.
template <typename T>
struct CopyOp {
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    o[0] = a[0];
  }
};

template <typename T>
struct TriadOp {
  float alpha;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    o[0] = round_to<T>(__fadd_rn(a[0], round_to<T>(__fmul_rn(alpha, a[1]))));
  }
};

template <typename T>
struct FillOp {
  float value;
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(const float*, float* o) const {
    o[0] = value;
  }
};

template <typename T>
struct SumOp {
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    o[0] = round_to<T>(__fadd_rn(a[0], a[1]));
  }
};

// inputs (p, g, m, v), outputs (p', m', v'); p, g widened from T, p'
// rounded to T once; the seven scalars (f32 [7] on the card) are read
// when the block starts
struct AdamWOp {
  const float* s;
  AdamWBody b;
  __device__ __forceinline__ void prepare() { b.load(s); }
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    b.apply(a[0], a[1], a[2], a[3], o[0], o[1], o[2]);
  }
};

// x -> o = 2 x (exact in x's type, stored as f32) and r = sum_j f32(x)
template <typename T>
struct RowStatOp {
  __device__ __forceinline__ void prepare() {}
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    o[0] = round_to<T>(__fmul_rn(2.0f, a[0]));
  }
  __device__ __forceinline__ void row(const float* a, float* t) const {
    t[0] = a[0];
  }
};

// The operands of a ring: NIN inputs, NOUT full-row outputs and NROW
// rank-1 f32 outputs ([rows], one lane a row), each of its own type.
template <int NIN, int NOUT, int NROW>
struct Operands {
  const void* in[NIN > 0 ? NIN : 1];
  void* out[NOUT > 0 ? NOUT : 1];
  float* row[NROW > 0 ? NROW : 1];
};

// Issue the bulk copies between the D streams' [bm, tw] tiles of step s
// in a row-major [*, cols] global array and a slot of D contiguous
// stages in shared memory: global -> shared on `bar` (LOAD), or
// shared -> global in the current bulk group.
template <bool LOAD, typename E>
__device__ __forceinline__ void step_copies(E* slot, E* gbase, int s,
                                            const Ring& g, uint64_t* bar) {
  const int t = s / g.ntiles, j = s % g.ntiles;
  const uint32_t bytes = static_cast<uint32_t>(g.tw * sizeof(E));
  E* tile = gbase + static_cast<size_t>(t) * g.bm * g.cols +
            static_cast<size_t>(j) * g.tw;
  const int stage = g.bm * g.tw;
  const int outer = g.interleaved ? g.bm : g.d;
  const int inner = g.interleaved ? g.d : g.bm;
  for (int a = 0; a < outer; ++a) {
    for (int b = 0; b < inner; ++b) {
      const int k = g.interleaved ? b : a, q = g.interleaved ? a : b;
      E* gp = tile + (static_cast<size_t>(k) * g.seg + q) * g.cols;
      E* sp = slot + static_cast<size_t>(k) * stage + static_cast<size_t>(q) * g.tw;
      if constexpr (LOAD) bulk_load(sp, gp, bytes, bar);
      else bulk_store(gp, sp, bytes);
    }
  }
}

// T: the ring's type (of every operand whose bit in F32IN / F32OUT is
// clear); a vector is 16 bytes of T, EPV elements, in every operand.
template <typename T, int NIN, int NOUT, int NROW, unsigned F32IN,
          unsigned F32OUT, typename Op>
__global__ void __launch_bounds__(RING_THREADS)
manual_ring(Operands<NIN, NOUT, NROW> ops, Op op, Ring g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NI = NIN > 0 ? NIN : 1;
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));   // elements a vector
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);      // [NIN][la]
  // offsets in shared memory fit 32 bits: every index below is an int
  const int se = g.d * g.bm * g.tw;                        // a slot's elements
  unsigned char* ibase = smem + ring_header(NIN, g.la);   // [NIN][la][slot]
  unsigned char* obase =                                    // [NOUT][2][slot]
      ibase + se * g.la * static_cast<int>(elem_prefix<T, F32IN>(NIN));
  unsigned char* rbase =                                    // [NROW][2][d*bm]
      obase + se * OUT_STAGES * static_cast<int>(elem_prefix<T, F32OUT>(NOUT));
  const int rslot = static_cast<int>(row_slot_bytes(g.d, g.bm));
  const int tid = threadIdx.x;
  op.prepare();
  const int s0 = blockIdx.x * g.per;
  const int n = min(g.per, g.steps - s0);

  // slot `slot` of input R, and staging slot `os` of full-row output Q
  auto islot = [&](auto R, int slot) {
    constexpr int r = decltype(R)::value;
    using E = Elem<T, F32IN, r>;
    return reinterpret_cast<E*>(
        ibase + se * (g.la * static_cast<int>(elem_prefix<T, F32IN>(r)) +
                      slot * static_cast<int>(sizeof(E))));
  };
  auto oslot_of = [&](auto Q, int os) {
    constexpr int q = decltype(Q)::value;
    using E = Elem<T, F32OUT, q>;
    return reinterpret_cast<E*>(
        obase + se * (OUT_STAGES * static_cast<int>(elem_prefix<T, F32OUT>(q)) +
                      os * static_cast<int>(sizeof(E))));
  };
  auto rslot_of = [&](int rr, int os) {
    return reinterpret_cast<float*>(rbase + (rr * OUT_STAGES + os) * rslot);
  };
  auto load = [&](int i) {             // thread 0: step i of the run, every input
    const int slot = i % g.la;
    static_for<0, NIN>([&](auto R) {
      constexpr int r = decltype(R)::value;
      using E = Elem<T, F32IN, r>;
      uint64_t* bar = full + r * g.la + slot;
      mbar_expect_tx(bar, static_cast<uint32_t>(se * sizeof(E)));
      step_copies<true>(islot(R, slot),
                        const_cast<E*>(static_cast<const E*>(ops.in[r])),
                        s0 + i, g, bar);
    });
  };

  if (tid == 0) {
    for (int i = 0; i < NIN * g.la; ++i) mbar_init(full + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)                        // prologue: prime `lookahead` steps
    for (int i = 0; i < min(g.la, n); ++i) load(i);

  for (int i = 0; i < n; ++i) {
    const int slot = i % g.la;
    const int os = i % OUT_STAGES;     // each output's staging slot of step i
    // each operand's slot of step i, computed once a step
    const unsigned char* ip[NI];
    unsigned char* opp[NOUT > 0 ? NOUT : 1];
    static_for<0, NIN>([&](auto R) {
      ip[decltype(R)::value] =
          reinterpret_cast<const unsigned char*>(islot(R, slot));
    });
    static_for<0, NOUT>([&](auto Q) {
      opp[decltype(Q)::value] =
          reinterpret_cast<unsigned char*>(oslot_of(Q, os));
    });
    // the store of step i - 2 must have read this staging slot
    if (tid == 0 && i >= OUT_STAGES) bulk_wait_read<OUT_STAGES - 1>();
    __syncthreads();
    for (int r = 0; r < NIN; ++r)
      mbar_wait(full + r * g.la + slot, static_cast<uint32_t>((i / g.la) & 1));
    for (int v = tid * EPV; v < se; v += RING_THREADS * EPV) {
      float a[NI][EPV];
      static_for<0, NIN>([&](auto R) {
        constexpr int r = decltype(R)::value;
        using E = Elem<T, F32IN, r>;
        smem_get<E, EPV>(reinterpret_cast<const E*>(ip[r]) + v, a[r]);
      });
      float y[NOUT > 0 ? NOUT : 1][EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        float ae[NI] = {}, ye[NOUT > 0 ? NOUT : 1];
#pragma unroll
        for (int r = 0; r < NIN; ++r) ae[r] = a[r][e];
        op(ae, ye);
#pragma unroll
        for (int q = 0; q < NOUT; ++q) y[q][e] = ye[q];
      }
      static_for<0, NOUT>([&](auto Q) {
        constexpr int q = decltype(Q)::value;
        using E = Elem<T, F32OUT, q>;
        smem_put<E, EPV>(reinterpret_cast<E*>(opp[q]) + v, y[q]);
      });
    }
    if constexpr (NROW > 0) {          // whole rows: tw == cols
      const int lane = tid & 31, warp = tid >> 5;
      const int nrows = g.d * g.bm;    // stage rows k * bm + q
      for (int rr = warp; rr < nrows; rr += RING_THREADS / 32) {
        float acc[NROW] = {};
        for (int c = lane * EPV; c < g.tw; c += 32 * EPV) {
          const int v = rr * g.tw + c;
          float a[NI][EPV];
          static_for<0, NIN>([&](auto R) {
            constexpr int r = decltype(R)::value;
            using E = Elem<T, F32IN, r>;
            smem_get<E, EPV>(reinterpret_cast<const E*>(ip[r]) + v, a[r]);
          });
#pragma unroll
          for (int e = 0; e < EPV; ++e) {
            float ae[NI] = {}, t[NROW];
#pragma unroll
            for (int r = 0; r < NIN; ++r) ae[r] = a[r][e];
            op.row(ae, t);
#pragma unroll
            for (int q = 0; q < NROW; ++q) acc[q] = __fadd_rn(acc[q], t[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < NROW; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[q] = __fadd_rn(acc[q],
                               __shfl_xor_sync(0xffffffffu, acc[q], off));
          if (lane == 0) rslot_of(q, os)[rr] = acc[q];
        }
      }
    }
    fence_proxy_async();               // staging writes -> the bulk store
    __syncthreads();                   // staging written, input slot read
    if constexpr (NROW > 0) {          // rank-1 outputs: one f32 a row
      const int t = (s0 + i) / g.ntiles;
      for (int rr = tid; rr < g.d * g.bm; rr += RING_THREADS) {
        const int k = rr / g.bm, q = rr % g.bm;
        const size_t row = static_cast<size_t>(k) * g.seg +
                           static_cast<size_t>(t) * g.bm + q;
#pragma unroll
        for (int w = 0; w < NROW; ++w) ops.row[w][row] = rslot_of(w, os)[rr];
      }
    }
    if (tid == 0) {
      static_for<0, NOUT>([&](auto Q) {
        constexpr int q = decltype(Q)::value;
        using E = Elem<T, F32OUT, q>;
        step_copies<false>(reinterpret_cast<E*>(opp[q]),
                           static_cast<E*>(ops.out[q]), s0 + i, g, nullptr);
      });
      bulk_commit();
      if (i + g.la < n) load(i + g.la);   // refill the slot just read
    }
  }
  if (tid == 0) bulk_wait_all();       // epilogue: drain the stores
}

template <typename T, int NIN, int NOUT, int NROW, unsigned F32IN,
          unsigned F32OUT, typename Op>
int ring_t(Operands<NIN, NOUT, NROW> ops, Op op, int rows, int cols, int d,
           int bm, int tw, int la, int per, int interleaved,
           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || tw <= 0 || la <= 0 ||
      per <= 0 || rows % d != 0 || (rows / d) % bm != 0 || cols % tw != 0 ||
      tw % SUB != 0 || (NROW > 0 && tw != cols))
    return static_cast<int>(cudaErrorInvalidValue);
  Ring g;
  g.cols = cols;
  g.seg = rows / d;
  g.d = d;
  g.bm = bm;
  g.tw = tw;
  g.la = la;
  g.ntiles = cols / tw;
  g.interleaved = interleaved != 0;
  const long long steps = static_cast<long long>(g.seg / bm) * g.ntiles;
  const long long blocks = (steps + per - 1) / per;
  const size_t step_elems = static_cast<size_t>(d) * bm * tw;
  // one bulk copy's bytes and an mbarrier's tx count stay below 2^20
  if (steps > (1LL << 30) || blocks > (1LL << 30) ||
      step_elems * sizeof(float) >= (1u << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  g.steps = static_cast<int>(steps);
  g.per = per;
  const size_t smem =
      ring_header(NIN, la) +
      step_elems * (static_cast<size_t>(la) * elem_prefix<T, F32IN>(NIN) +
                    OUT_STAGES * elem_prefix<T, F32OUT>(NOUT)) +
      static_cast<size_t>(NROW) * OUT_STAGES * row_slot_bytes(d, bm);
  auto kernel = manual_ring<T, NIN, NOUT, NROW, F32IN, F32OUT, Op>;
  static size_t opted_in = 0;          // raised once per instance, not per launch
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  kernel<<<static_cast<int>(blocks), RING_THREADS, smem, stream>>>(ops, op,
                                                                   g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int copy_t(const void* x, void* o, int rows, int cols, int d, int bm, int tw,
           int la, int per, int interleaved, cudaStream_t stream) {
  return ring_t<T, 1, 1, 0, 0u, 0u>({{x}, {o}, {nullptr}}, CopyOp<T>{}, rows,
                                    cols, d, bm, tw, la, per, interleaved,
                                    stream);
}

template <typename T>
int triad_t(const void* b, const void* c, void* o, float alpha, int rows,
            int cols, int d, int bm, int tw, int la, int per, int interleaved,
            cudaStream_t stream) {
  return ring_t<T, 2, 1, 0, 0u, 0u>({{b, c}, {o}, {nullptr}},
                                    TriadOp<T>{alpha}, rows, cols, d, bm, tw,
                                    la, per, interleaved, stream);
}

template <typename T>
int fill_t(void* o, float value, int rows, int cols, int d, int bm, int tw,
           int la, int per, int interleaved, cudaStream_t stream) {
  return ring_t<T, 0, 1, 0, 0u, 0u>({{nullptr}, {o}, {nullptr}},
                                    FillOp<T>{value}, rows, cols, d, bm, tw,
                                    la, per, interleaved, stream);
}

template <typename T>
int sum_t(const void* x, const void* z, void* o, int rows, int cols, int d,
          int bm, int tw, int la, int per, int interleaved,
          cudaStream_t stream) {
  return ring_t<T, 2, 1, 0, 0u, 0u>({{x, z}, {o}, {nullptr}}, SumOp<T>{},
                                    rows, cols, d, bm, tw, la, per,
                                    interleaved, stream);
}

// p, g, p' of type T; m, v, m', v' f32 (inputs 2, 3 and outputs 1, 2)
template <typename T>
int adamw_t(const void* p, const void* g, const void* m, const void* v,
            const void* s, void* po, void* mo, void* vo, int rows, int cols,
            int d, int bm, int tw, int la, int per, int interleaved,
            cudaStream_t stream) {
  return ring_t<T, 4, 3, 0, 0b1100u, 0b110u>(
      {{p, g, m, v}, {po, mo, vo}, {nullptr}},
      AdamWOp{static_cast<const float*>(s), {}}, rows, cols, d, bm, tw, la,
      per, interleaved, stream);
}

// x of type T; o [rows, cols] and r [rows] f32
template <typename T>
int rowstat_t(const void* x, void* o, void* r, int rows, int cols, int d,
              int bm, int tw, int la, int per, int interleaved,
              cudaStream_t stream) {
  return ring_t<T, 1, 1, 1, 0u, 0b1u>(
      {{x}, {o}, {static_cast<float*>(r)}}, RowStatOp<T>{}, rows, cols, d,
      bm, tw, la, per, interleaved, stream);
}

}  // namespace

// Every launcher: [rows, cols] row-major arrays, 16-byte aligned; d
// streams of seg = rows / d rows; steps of bm rows by tw columns (tw a
// multiple of 128 dividing cols, cols itself for a body with a rank-1
// output), seg / bm * cols / tw of them per segment, `per` consecutive
// steps a block; a ring of `la` stages per input; copies issued grouped
// (interleaved = 0) or interleaved (1).  `dtype` is the ring's type T.

extern "C" int manual_copy_launch(int dtype, const void* x, void* o, int rows,
                                  int cols, int d, int bm, int tw, int la,
                                  int per, int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return copy_t<float>(x, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return copy_t<__nv_bfloat16>(x, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kF16: return copy_t<__half>(x, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_triad_launch(int dtype, const void* b, const void* c,
                                   void* o, float alpha, int rows, int cols,
                                   int d, int bm, int tw, int la, int per,
                                   int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return triad_t<float>(b, c, o, alpha, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return triad_t<__nv_bfloat16>(b, c, o, alpha, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kF16: return triad_t<__half>(b, c, o, alpha, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_fill_launch(int dtype, void* o, float value, int rows,
                                  int cols, int d, int bm, int tw, int la,
                                  int per, int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return fill_t<float>(o, value, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return fill_t<__nv_bfloat16>(o, value, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kF16: return fill_t<__half>(o, value, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_sum_launch(int dtype, const void* x, const void* z,
                                 void* o, int rows, int cols, int d, int bm,
                                 int tw, int la, int per, int interleaved,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return sum_t<float>(x, z, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return sum_t<__nv_bfloat16>(x, z, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kF16: return sum_t<__half>(x, z, o, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// p, g (inputs) and po (output) of `dtype` (f32, bf16 or f16); m, v
// (inputs) and mo, vo (outputs) f32; s: f32 [7] = (lr, b1, b2, eps, wd,
// bc1, bc2) on the card.
extern "C" int manual_adamw_launch(int dtype, const void* p, const void* g,
                                   const void* m, const void* v,
                                   const void* s, void* po, void* mo,
                                   void* vo, int rows, int cols, int d,
                                   int bm, int tw, int la, int per,
                                   int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return adamw_t<float>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return adamw_t<__nv_bfloat16>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kF16: return adamw_t<__half>(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (input) of `dtype` (f32 or bf16); o [rows, cols] and r [rows] f32;
// tw == cols (whole-row steps).
extern "C" int manual_rowstat_launch(int dtype, const void* x, void* o,
                                     void* r, int rows, int cols, int d,
                                     int bm, int tw, int la, int per,
                                     int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return rowstat_t<float>(x, o, r, rows, cols, d, bm, tw, la, per, interleaved, st);
    case kBF16: return rowstat_t<__nv_bfloat16>(x, o, r, rows, cols, d, bm, tw, la, per, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
