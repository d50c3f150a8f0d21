// The explicit lookahead ring (template K4) for Hopper (sm_90a): a
// producer warp keeps TMA tensor copies in flight into rings of shared-
// memory stages on full / empty mbarriers, consumer warps run the body
// between load and store, and one consumer thread stores the outputs
// with TMA out of a 2-deep staging ring.
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
// the body of step t has read its slot.
//
// What bounds it: bytes, as the stream kernels (at most two flops per
// element moved; adamw's body, about ten flops for 28 bytes, too).
//
// On Hopper:
//   * A step is a (row block, column tile): rows k*seg + t*bm ... of
//     every stream k, columns j*tw ... + tw-1 (the TPU ring streamed
//     whole rows, 128 KiB a stream stage at 4096 f32 columns and bm = 8,
//     beyond the 227 KB a block may use).  Each operand has a tensor map
//     in its own dtype over its [rows, cols] array seen as 3-D [rows,
//     cols/128, 128]; a stream's [bm, tw] stage is one box of (128,
//     tw/128, bh) elements (bh = bm; a box is at most 256 a side, so
//     where bm > 256, bm's largest divisor up to 256, bm/bh boxes),
//     landing row-major as [bm][tw].  A step is therefore D copies per
//     operand at any tw, as the TPU's in_copy / out_copy (emit.py
//     :747-756).  With one box a stream, the grouped and interleaved
//     arrangements would issue the same D copies in stream order: the
//     ring takes no arrangement, and the JAX K4 does not read it either.
//   * Warp roles.  The elected lane of warp NCW is the producer: for
//     each step of the block's run it waits on the slot's "empty"
//     barrier (one arrival per consumer warp after its last read of the
//     slot), arms each input's "full" barrier of the slot with the D
//     boxes' bytes and issues them.  The NCW consumer warps wait on
//     "full", run the body from the input stages into the outputs'
//     staging slot and arrive on "empty".  At lookahead 1 the one slot
//     is refilled only after the body has read it: prefetch off.
//   * Consumer groups.  Where more than one step can be in flight
//     (lookahead > 1, or a writes-only ring) the consumers are two groups
//     of four warps, group g taking steps g, g + 2, ...: its steps are
//     those of staging slot g, so it overlaps its barriers and stores
//     with the other group's body, as a second block an SM would
//     (measured on the H100: PERF.md).  A full barrier
//     is kept per (input, slot, group), so a group never waits on a use
//     of a barrier that the other group's step still has to complete.
//     At lookahead 1 with inputs one step is in flight, and all eight
//     warps take each step.
//   * Stores.  A bulk store group belongs to the thread that commits
//     it, so a consumer group's thread 0 issues a step's output boxes as
//     one group after fence.proxy.async.shared::cta and its group's named
//     barrier (barrier 1 + g, the producer warp not in it), and before a
//     staging slot is written again waits wait_group.read (the store of
//     two steps back has read it); the rest of its group waits for that
//     at the next named barrier.  No __syncthreads after the set-up.
//   * A spec with a rank-1 write steps by whole rows (tw = cols), as the
//     TPU ring did, so that a row statistic sees its whole row in one
//     stage.  After the map the group's warps take (row, quarter) units
//     of the stage (lanes stride the quarter, then a shuffle tree) into
//     the rank-1 staging slot; after the step's barrier the threads add
//     each row's four quarters in order and store it, one f32 a row (bm
//     f32 lanes are no TMA box for every bm): one fixed order.
//   * One wave.  kernels/manual.py chooses the tile (ring_tile: the
//     widest whose ring lets two blocks share an SM, else 128 columns; a
//     writes-only ring the widest that fits one block) and cuts the
//     segment's steps into one contiguous run per resident block
//     (ring_runs: blocks an SM from the ring's shared memory, at most
//     MAX_BLOCKS_PER_SM, times the SM count); each block runs one
//     prologue and one epilogue.  The launcher refuses a grid that the
//     occupancy API says is not resident at once.
//   * Every wait traps after 2^26 polls, so a lost copy fails the launch
//     instead of hanging the card.  TMA needs 16-byte aligned operands
//     and row pitches, and 128-byte aligned stages: rows of whole
//     sub-portions, 16-byte aligned operands (the wrapper checks) and
//     the layout below give that for every element size.
#include <type_traits>

#include "adamw.cuh"
#include "tma.cuh"

namespace {

constexpr int NCW = 8;                           // consumer warps
constexpr int RING_THREADS = NCW * 32 + 32;      // and the producer warp
constexpr int OUT_STAGES = 2;                    // the staging ring's depth
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int BOX_MAX = 256;                     // a TMA box's extent a side
constexpr int ROW_CHUNKS = 4;                    // warp chunks of a row statistic
constexpr size_t SMEM_SLACK = 128;               // to align the stages to 128

// Consumer groups of a ring of `la` stages and `nin` inputs: two (one
// per staging slot) where more than one step can be in flight, and in a
// writes-only ring (no input ring to hold back); at lookahead 1 with
// inputs (prefetch off: one step in flight) every warp takes each step.
__host__ __device__ inline int ring_groups(int nin, int la) {
  return la > 1 || nin == 0 ? 2 : 1;
}

// Bytes of the barrier header in front of the stages: full
// [NIN][la][groups] and empty [la], padded to 128 (kernels/manual.py
// ring_smem mirrors this).
__host__ __device__ inline size_t ring_header(int nin, int la) {
  return (static_cast<size_t>(8) * (nin * ring_groups(nin, la) + 1) * la +
          127) / 128 * 128;
}

// Barrier 1 + grp of a consumer group's `threads` threads.
__device__ __forceinline__ void group_sync(int grp, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + grp), "r"(threads)
               : "memory");
}

// Bytes of one rank-1 staging slot: D x bm x ROW_CHUNKS f32 partials,
// padded to 16.
__host__ __device__ inline size_t row_slot_bytes(int d, int bm) {
  return (static_cast<size_t>(d) * bm * ROW_CHUNKS * 4 + 15) / 16 * 16;
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

// The same on the host (the tensor maps of each operand's type).
template <int I, int N, typename F>
void host_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    host_for<I + 1, N>(f);
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
  int seg, d, bm, bh, tw, la, ntiles, steps, per;
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

// The tensor maps of a ring's NIN inputs and NOUT full-row outputs,
// each in its operand's dtype, and the NROW rank-1 f32 outputs ([rows],
// one lane a row).
template <int NIN, int NOUT, int NROW>
struct Operands {
  CUtensorMap in[NIN > 0 ? NIN : 1];
  CUtensorMap out[NOUT > 0 ? NOUT : 1];
  float* row[NROW > 0 ? NROW : 1];
};

// T: the ring's type (of every operand whose bit in F32IN / F32OUT is
// clear); a vector is 16 bytes of T, EPV elements, in every operand.
template <typename T, int NIN, int NOUT, int NROW, unsigned F32IN,
          unsigned F32OUT, typename Op>
__global__ void __launch_bounds__(RING_THREADS, MAX_BLOCKS_PER_SM)
manual_ring(const __grid_constant__ Operands<NIN, NOUT, NROW> ops, Op op,
            Ring g) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int NI = NIN > 0 ? NIN : 1;
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));   // elements a vector
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int groups = ring_groups(NIN, g.la);
  const int gw = NCW / groups, gt = gw * 32;               // a group's warps, threads
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);      // [NIN][la][groups]
  uint64_t* empty = full + NIN * g.la * groups;            // [la]
  // offsets in shared memory fit 32 bits: every index below is an int
  const int se = g.d * g.bm * g.tw;                        // a slot's elements
  unsigned char* ibase = smem + ring_header(NIN, g.la);   // [NIN][la][slot]
  unsigned char* obase =                                    // [NOUT][2][slot]
      ibase + se * g.la * static_cast<int>(elem_prefix<T, F32IN>(NIN));
  unsigned char* rbase =                                    // [NROW][2][d*bm]
      obase + se * OUT_STAGES * static_cast<int>(elem_prefix<T, F32OUT>(NOUT));
  const int rslot = static_cast<int>(row_slot_bytes(g.d, g.bm));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * g.per;
  const int n = min(g.per, g.steps - s0);
  const int ty = g.tw / SUB;                               // a tile's sub-portions
  const int nbox = g.bm / g.bh;                            // boxes a stream
  // the uses of a full barrier are the steps of one slot and one group:
  // every period-th step
  const int period = g.la % groups == 0 ? g.la : g.la * groups;

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

  if (tid == 0) {
    for (int i = 0; i < NIN * g.la * groups; ++i) mbar_init(full + i, 1);
    for (int i = 0; i < g.la; ++i) mbar_init(empty + i, gw);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: every input's D boxes of each step of the run
    if constexpr (NIN > 0) {
      if (lane == 0) {
        static_for<0, NIN>([&](auto R) { prefetch_map(&ops.in[decltype(R)::value]); });
        for (int i = 0; i < n; ++i) {
          const int slot = i % g.la;
          if (i >= g.la)           // the body of step i - la has read it
            mbar_wait(empty + slot, static_cast<uint32_t>(((i / g.la) - 1) & 1));
          const int t = (s0 + i) / g.ntiles, sub0 = (s0 + i) % g.ntiles * ty;
          static_for<0, NIN>([&](auto R) {
            constexpr int r = decltype(R)::value;
            using E = Elem<T, F32IN, r>;
            uint64_t* bar = full + (r * g.la + slot) * groups + i % groups;
            mbar_expect_tx(bar, static_cast<uint32_t>(se * sizeof(E)));
            E* st = islot(R, slot);
            for (int k = 0; k < g.d; ++k)
              for (int b = 0; b < nbox; ++b)
                tma_load_3d(st + (k * g.bm + b * g.bh) * g.tw, &ops.in[r], 0,
                            sub0, k * g.seg + t * g.bm + b * g.bh, bar);
          });
        }
      }
    }
    return;
  }

  // ---- consumers: group grp takes steps grp, grp + groups, ...
  const int grp = warp / gw, gtid = tid - grp * gt, gwarp = warp - grp * gw;
  op.prepare();
  if (gtid == 0)
    static_for<0, NOUT>([&](auto Q) { prefetch_map(&ops.out[decltype(Q)::value]); });
  for (int i = grp; i < n; i += groups) {
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
    // (a group's own store where the two staging slots are two groups')
    if (gtid == 0 && i >= OUT_STAGES) {
      if (groups == OUT_STAGES) bulk_wait_read<0>();
      else bulk_wait_read<OUT_STAGES - 1>();
    }
    for (int r = 0; r < NIN; ++r)
      mbar_wait(full + (r * g.la + slot) * groups + i % groups,
                static_cast<uint32_t>((i / period) & 1));
    group_sync(grp, gt);
    for (int v = gtid * EPV; v < se; v += gt * EPV) {
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
      // warp units (row rr, chunk ch) of the stage rows k * bm + q, each
      // chunk a quarter of the row
      const int nunits = g.d * g.bm * ROW_CHUNKS, cw = g.tw / ROW_CHUNKS;
      for (int u = gwarp; u < nunits; u += gw) {
        const int rr = u / ROW_CHUNKS, c0 = u % ROW_CHUNKS * cw;
        float acc[NROW] = {};
        for (int c = c0 + lane * EPV; c < c0 + cw; c += 32 * EPV) {
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
          if (lane == 0) rslot_of(q, os)[u] = acc[q];
        }
      }
    }
    if constexpr (NIN > 0) {           // this warp has read the input slot
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
    fence_proxy_async();               // staging writes -> the bulk store
    group_sync(grp, gt);               // the step's staging slot written
    const int t = (s0 + i) / g.ntiles, sub0 = (s0 + i) % g.ntiles * ty;
    if constexpr (NROW > 0) {          // rank-1 outputs: one f32 a row,
      for (int rr = gtid; rr < g.d * g.bm; rr += gt) {   // chunks in order
        const int k = rr / g.bm, q = rr % g.bm;
        const size_t row = static_cast<size_t>(k) * g.seg +
                           static_cast<size_t>(t) * g.bm + q;
#pragma unroll
        for (int w = 0; w < NROW; ++w) {
          const float* part = rslot_of(w, os) + rr * ROW_CHUNKS;
          float r = part[0];
#pragma unroll
          for (int ch = 1; ch < ROW_CHUNKS; ++ch) r = __fadd_rn(r, part[ch]);
          ops.row[w][row] = r;
        }
      }
    }
    if (gtid == 0) {
      static_for<0, NOUT>([&](auto Q) {
        constexpr int q = decltype(Q)::value;
        using E = Elem<T, F32OUT, q>;
        const E* st = reinterpret_cast<const E*>(opp[q]);
        for (int k = 0; k < g.d; ++k)
          for (int b = 0; b < nbox; ++b)
            tma_store_3d(&ops.out[q], 0, sub0, k * g.seg + t * g.bm + b * g.bh,
                         st + (k * g.bm + b * g.bh) * g.tw);
      });
      bulk_commit();
    }
  }
  if (gtid == 0) bulk_wait_all();      // epilogue: drain the stores
}

// The [rows, cols] array at `base` of E as a tensor map over its 3-D view
// [rows, cols / 128, 128], in boxes of (128, tw / 128, bh).
template <typename E>
bool ring_map(CUtensorMap* map, const void* base, int rows, int cols, int tw,
              int bh) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(SUB),
                              static_cast<cuuint64_t>(cols / SUB),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {SUB * sizeof(E),
                                 static_cast<cuuint64_t>(cols) * sizeof(E)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(SUB),
                             static_cast<cuuint32_t>(tw / SUB),
                             static_cast<cuuint32_t>(bh)};
  return make_map(map, base, tma_dtype<E>(), 3, dims, strides, box, 0);
}

template <typename T, int NIN, int NOUT, int NROW, unsigned F32IN,
          unsigned F32OUT, typename Op>
int ring_t(const void* const* in, void* const* out, float* const* row, Op op,
           int rows, int cols, int d, int bm, int bh, int tw, int la, int per,
           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || bh <= 0 || tw <= 0 ||
      la <= 0 || per <= 0 || rows % d != 0 || (rows / d) % bm != 0 ||
      bm % bh != 0 || bh > BOX_MAX || cols % tw != 0 || tw % SUB != 0 ||
      tw / SUB > BOX_MAX || (NROW > 0 && tw != cols))
    return static_cast<int>(cudaErrorInvalidValue);
  Ring g;
  g.seg = rows / d;
  g.d = d;
  g.bm = bm;
  g.bh = bh;
  g.tw = tw;
  g.la = la;
  g.ntiles = cols / tw;
  const long long steps = static_cast<long long>(g.seg / bm) * g.ntiles;
  const long long blocks = (steps + per - 1) / per;
  const size_t step_elems = static_cast<size_t>(d) * bm * tw;
  // an mbarrier's tx count stays below 2^20
  if (steps > (1LL << 30) || blocks > (1LL << 30) ||
      step_elems * sizeof(float) >= (1u << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  g.steps = static_cast<int>(steps);
  g.per = per;
  Operands<NIN, NOUT, NROW> ops;
  bool ok = true;
  host_for<0, NIN>([&](auto R) {
    constexpr int r = decltype(R)::value;
    ok = ok && ring_map<Elem<T, F32IN, r>>(&ops.in[r], in[r], rows, cols, tw,
                                           bh);
  });
  host_for<0, NOUT>([&](auto Q) {
    constexpr int q = decltype(Q)::value;
    ok = ok && ring_map<Elem<T, F32OUT, q>>(&ops.out[q], out[q], rows, cols,
                                            tw, bh);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  for (int w = 0; w < NROW; ++w) ops.row[w] = row[w];
  const size_t smem =
      SMEM_SLACK + ring_header(NIN, la) +
      step_elems * (static_cast<size_t>(la) * elem_prefix<T, F32IN>(NIN) +
                    OUT_STAGES * elem_prefix<T, F32OUT>(NOUT)) +
      static_cast<size_t>(NROW) * OUT_STAGES * row_slot_bytes(d, bm);
  auto kernel = manual_ring<T, NIN, NOUT, NROW, F32IN, F32OUT, Op>;
  // raised once per instance, and the blocks an SM at that size
  static size_t opted_in = 0, resident_at = 0;
  static int resident = 0, sms = 0;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  if (smem != resident_at) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, kernel, RING_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident_at = smem;
  }
  if (blocks > static_cast<long long>(resident) * sms)   // not one wave
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<int>(blocks), RING_THREADS, smem, stream>>>(ops, op, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int copy_t(const void* x, void* o, int rows, int cols, int d, int bm, int bh,
           int tw, int la, int per, cudaStream_t stream) {
  const void* in[] = {x};
  void* out[] = {o};
  return ring_t<T, 1, 1, 0, 0u, 0u>(in, out, nullptr, CopyOp<T>{}, rows, cols,
                                    d, bm, bh, tw, la, per, stream);
}

template <typename T>
int triad_t(const void* b, const void* c, void* o, float alpha, int rows,
            int cols, int d, int bm, int bh, int tw, int la, int per,
            cudaStream_t stream) {
  const void* in[] = {b, c};
  void* out[] = {o};
  return ring_t<T, 2, 1, 0, 0u, 0u>(in, out, nullptr, TriadOp<T>{alpha}, rows,
                                    cols, d, bm, bh, tw, la, per, stream);
}

template <typename T>
int fill_t(void* o, float value, int rows, int cols, int d, int bm, int bh,
           int tw, int la, int per, cudaStream_t stream) {
  void* out[] = {o};
  return ring_t<T, 0, 1, 0, 0u, 0u>(nullptr, out, nullptr, FillOp<T>{value},
                                    rows, cols, d, bm, bh, tw, la, per,
                                    stream);
}

template <typename T>
int sum_t(const void* x, const void* z, void* o, int rows, int cols, int d,
          int bm, int bh, int tw, int la, int per, cudaStream_t stream) {
  const void* in[] = {x, z};
  void* out[] = {o};
  return ring_t<T, 2, 1, 0, 0u, 0u>(in, out, nullptr, SumOp<T>{}, rows, cols,
                                    d, bm, bh, tw, la, per, stream);
}

// p, g, p' of type T; m, v, m', v' f32 (inputs 2, 3 and outputs 1, 2)
template <typename T>
int adamw_t(const void* p, const void* g, const void* m, const void* v,
            const void* s, void* po, void* mo, void* vo, int rows, int cols,
            int d, int bm, int bh, int tw, int la, int per,
            cudaStream_t stream) {
  const void* in[] = {p, g, m, v};
  void* out[] = {po, mo, vo};
  return ring_t<T, 4, 3, 0, 0b1100u, 0b110u>(
      in, out, nullptr, AdamWOp{static_cast<const float*>(s), {}}, rows, cols,
      d, bm, bh, tw, la, per, stream);
}

// x of type T; o [rows, cols] and r [rows] f32
template <typename T>
int rowstat_t(const void* x, void* o, void* r, int rows, int cols, int d,
              int bm, int bh, int tw, int la, int per, cudaStream_t stream) {
  const void* in[] = {x};
  void* out[] = {o};
  float* row[] = {static_cast<float*>(r)};
  return ring_t<T, 1, 1, 1, 0u, 0b1u>(in, out, row, RowStatOp<T>{}, rows,
                                      cols, d, bm, bh, tw, la, per, stream);
}

}  // namespace

// Every launcher: [rows, cols] row-major arrays, 16-byte aligned; d
// streams of seg = rows / d rows; steps of bm rows (boxes of bh rows, bh
// dividing bm, at most 256) by tw columns (tw a multiple of 128 dividing
// cols, at most 256 x 128; cols itself for a body with a rank-1 output),
// seg / bm * cols / tw of them per segment, `per` consecutive steps a
// block, in one wave; a ring of `la` stages per input.  `dtype` is the
// ring's type T.

#define REPRO_RING_GEOMETRY rows, cols, d, bm, bh, tw, la, per, st

extern "C" int manual_copy_launch(int dtype, const void* x, void* o, int rows,
                                  int cols, int d, int bm, int bh, int tw,
                                  int la, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return copy_t<float>(x, o, REPRO_RING_GEOMETRY);
    case kBF16: return copy_t<__nv_bfloat16>(x, o, REPRO_RING_GEOMETRY);
    case kF16: return copy_t<__half>(x, o, REPRO_RING_GEOMETRY);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_triad_launch(int dtype, const void* b, const void* c,
                                   void* o, float alpha, int rows, int cols,
                                   int d, int bm, int bh, int tw, int la,
                                   int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return triad_t<float>(b, c, o, alpha, REPRO_RING_GEOMETRY);
    case kBF16: return triad_t<__nv_bfloat16>(b, c, o, alpha, REPRO_RING_GEOMETRY);
    case kF16: return triad_t<__half>(b, c, o, alpha, REPRO_RING_GEOMETRY);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_fill_launch(int dtype, void* o, float value, int rows,
                                  int cols, int d, int bm, int bh, int tw,
                                  int la, int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return fill_t<float>(o, value, REPRO_RING_GEOMETRY);
    case kBF16: return fill_t<__nv_bfloat16>(o, value, REPRO_RING_GEOMETRY);
    case kF16: return fill_t<__half>(o, value, REPRO_RING_GEOMETRY);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int manual_sum_launch(int dtype, const void* x, const void* z,
                                 void* o, int rows, int cols, int d, int bm,
                                 int bh, int tw, int la, int per,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return sum_t<float>(x, z, o, REPRO_RING_GEOMETRY);
    case kBF16: return sum_t<__nv_bfloat16>(x, z, o, REPRO_RING_GEOMETRY);
    case kF16: return sum_t<__half>(x, z, o, REPRO_RING_GEOMETRY);
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
                                   int bm, int bh, int tw, int la, int per,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return adamw_t<float>(p, g, m, v, s, po, mo, vo, REPRO_RING_GEOMETRY);
    case kBF16: return adamw_t<__nv_bfloat16>(p, g, m, v, s, po, mo, vo, REPRO_RING_GEOMETRY);
    case kF16: return adamw_t<__half>(p, g, m, v, s, po, mo, vo, REPRO_RING_GEOMETRY);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (input) of `dtype` (f32 or bf16); o [rows, cols] and r [rows] f32;
// tw == cols (whole-row steps).
extern "C" int manual_rowstat_launch(int dtype, const void* x, void* o,
                                     void* r, int rows, int cols, int d,
                                     int bm, int bh, int tw, int la, int per,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return rowstat_t<float>(x, o, r, REPRO_RING_GEOMETRY);
    case kBF16: return rowstat_t<__nv_bfloat16>(x, o, r, REPRO_RING_GEOMETRY);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_RING_GEOMETRY
