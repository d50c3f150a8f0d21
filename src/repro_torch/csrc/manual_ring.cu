// The explicit lookahead ring (template K4) for Hopper (sm_90a): bulk
// copies into shared memory on mbarriers, the body fused between load
// and store, and bulk stores out of a 2-deep staging ring.
//
// Replaces the JAX package's K4 template, _emit_manual
// (src/repro/codegen/emit.py:708), which the JAX package selects at a
// lookahead other than 2 for specs with plain (stride, vector) reads
// and writes.  Its bodies here:
//   copy:        y = x             (stream_copy, stream_copy_manual)
//   triad:       a = b + alpha * c (stream_triad)
//   fill:        y = value         (stream_init: no loads)
//   gemver_sum:  o = x + z         (gemver_sum on its 1-D blocking)
//   adamw:       (p', m', v') from (p, g, m, v) and seven scalars
//                (adamw_update; adamw.cuh's AdamWBody; f32 only)
// each operation rounded to the arrays' dtype as the body rounds it, so
// every body equals its plain version bit for bit.
//
// What the TPU kernel computes: for each operand a ring of `lookahead`
// stages, each stage the D stream copies of one step (rows
// k*seg + t*bm ... of every stream k), all D copies of a step signalling
// one semaphore per slot; the body runs on a stage once it has landed;
// the outputs drain through a 2-deep staging ring whose waits are
// deferred to the step that reuses the slot, and an epilogue drains the
// rest.  lookahead=1 is prefetch off: the copies of step t+1 start only
// after the body of step t.
//
// What bounds it: bytes, as the stream kernels (at most two flops per
// element moved; adamw's body, about ten flops for 28 bytes, too).
//
// On Hopper:
//   * Dynamic shared memory holds lookahead x D stages per input and
//     2 x D staging stages per output (one output for copy, triad, fill
//     and gemver_sum, three for adamw), with one mbarrier per (input,
//     slot), armed with expect_tx for the D copies' bytes.  Every operand
//     has one element type: adamw's m and v are f32, so its ring takes
//     f32 parameters only.
//   * Thread 0 issues the copies: cp.async.bulk global -> shared, one
//     per row piece of a stage, in the config's arrangement (grouped:
//     a stream's rows back to back; interleaved: the streams round-robin
//     row by row), and the stores: cp.async.bulk shared -> global, every
//     output's in one bulk group per step, with wait_group.read 1 before
//     a staging slot is written again.
//   * A step is a (row block, column tile): the TPU ring streamed whole
//     rows, which at 4096 f32 columns and bm = 8 would be 128 KiB a
//     stream stage, beyond the 227 KB a block may use.  The tile is the
//     widest whole number of 128-element sub-portions dividing the row
//     that fits the ring under the opt-in limit (kernels/manual.py
//     ring_tile, which raises where even 128 columns do not fit).
//   * The TPU ran the whole ring on one core in order.  Here the grid
//     splits each segment's steps into contiguous runs, about two blocks
//     per SM; each block runs its own prologue, ring and epilogue.
//   * Ordering: a __syncthreads between the last read of an input slot
//     and its refill; fence.proxy.async.shared::cta between the threads'
//     writes to a staging slot and the bulk store that reads it.
//     cp.async.bulk needs 16-byte aligned addresses and sizes: rows of
//     whole sub-portions and 16-byte aligned operands (the wrapper
//     checks) give that.
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

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
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

struct Ring {
  int cols, seg, d, bm, tw, la, ntiles, steps, per;
  bool interleaved;
};

// A body: prepare() once a block, before the ring starts; then
// operator()(a, o) maps one element of each input (widened to f32) to
// one element of each output.
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

// inputs (p, g, m, v), outputs (p', m', v'), all f32; the seven scalars
// (f32 [7] on the card) are read when the block starts
struct AdamWOp {
  const float* s;
  AdamWBody b;
  __device__ __forceinline__ void prepare() { b.load(s); }
  __device__ __forceinline__ void operator()(const float* a, float* o) const {
    b.apply(a[0], a[1], a[2], a[3], o[0], o[1], o[2]);
  }
};

// The operands of a ring: NIN inputs and NOUT outputs of one type.
template <typename T, int NIN, int NOUT>
struct Operands {
  const T* in[NIN > 0 ? NIN : 1];
  T* out[NOUT];
};

// Issue the bulk copies between the D streams' [bm, tw] tiles of step s
// in a row-major [*, cols] global array and a slot of D contiguous
// stages in shared memory: global -> shared on `bar` (LOAD), or
// shared -> global in the current bulk group.
template <bool LOAD, typename T>
__device__ __forceinline__ void step_copies(T* slot, T* gbase, int s,
                                            const Ring& g, uint64_t* bar) {
  const int t = s / g.ntiles, j = s % g.ntiles;
  const uint32_t bytes = static_cast<uint32_t>(g.tw * sizeof(T));
  T* tile = gbase + static_cast<size_t>(t) * g.bm * g.cols +
            static_cast<size_t>(j) * g.tw;
  const int stage = g.bm * g.tw;
  const int outer = g.interleaved ? g.bm : g.d;
  const int inner = g.interleaved ? g.d : g.bm;
  for (int a = 0; a < outer; ++a) {
    for (int b = 0; b < inner; ++b) {
      const int k = g.interleaved ? b : a, q = g.interleaved ? a : b;
      T* gp = tile + (static_cast<size_t>(k) * g.seg + q) * g.cols;
      T* sp = slot + static_cast<size_t>(k) * stage + static_cast<size_t>(q) * g.tw;
      if constexpr (LOAD) bulk_load(sp, gp, bytes, bar);
      else bulk_store(gp, sp, bytes);
    }
  }
}

template <typename T, int NIN, int NOUT, typename Op>
__global__ void __launch_bounds__(RING_THREADS)
manual_ring(Operands<T, NIN, NOUT> ops, Op op, Ring g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NI = NIN > 0 ? NIN : 1;
  constexpr int EPV = 16 / static_cast<int>(sizeof(T));   // elements a vector
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);      // [NIN][la]
  const int step_elems = g.d * g.bm * g.tw;                // a slot: D stages
  T* ibuf = reinterpret_cast<T*>(smem + ring_header(NIN, g.la));  // [NIN][la][slot]
  T* obuf = ibuf + static_cast<size_t>(NIN) * g.la * step_elems;  // [NOUT][2][slot]
  const int tid = threadIdx.x;
  op.prepare();
  const int s0 = blockIdx.x * g.per;
  const int n = min(g.per, g.steps - s0);

  auto islot = [&](int r, int slot) {
    return ibuf + (static_cast<size_t>(r) * g.la + slot) * step_elems;
  };
  auto load = [&](int i) {             // thread 0: step i of the run, every input
    const int slot = i % g.la;
    for (int r = 0; r < NIN; ++r) {
      uint64_t* bar = full + r * g.la + slot;
      mbar_expect_tx(bar, static_cast<uint32_t>(step_elems * sizeof(T)));
      step_copies<true>(islot(r, slot), const_cast<T*>(ops.in[r]), s0 + i, g,
                        bar);
    }
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
    T* ob[NOUT];                       // each output's staging slot of step i
#pragma unroll
    for (int q = 0; q < NOUT; ++q)
      ob[q] = obuf + (static_cast<size_t>(q) * OUT_STAGES + i % OUT_STAGES) *
                         step_elems;
    // the store of step i - 2 must have read this staging slot
    if (tid == 0 && i >= OUT_STAGES) bulk_wait_read<OUT_STAGES - 1>();
    __syncthreads();
    for (int r = 0; r < NIN; ++r)
      mbar_wait(full + r * g.la + slot, static_cast<uint32_t>((i / g.la) & 1));
    for (int v = tid * EPV; v < step_elems; v += RING_THREADS * EPV) {
      uint32_t w[NI][4];
#pragma unroll
      for (int r = 0; r < NIN; ++r) {
        const uint4 u = *reinterpret_cast<const uint4*>(islot(r, slot) + v);
        w[r][0] = u.x; w[r][1] = u.y; w[r][2] = u.z; w[r][3] = u.w;
      }
      uint32_t o[NOUT][4] = {};
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        float a[NI] = {0.f};
        float y[NOUT];
#pragma unroll
        for (int r = 0; r < NIN; ++r) a[r] = Cvt<T>::get(w[r], e);
        op(a, y);
#pragma unroll
        for (int q = 0; q < NOUT; ++q) Cvt<T>::put(o[q], e, y[q]);
      }
#pragma unroll
      for (int q = 0; q < NOUT; ++q)
        *reinterpret_cast<uint4*>(ob[q] + v) =
            make_uint4(o[q][0], o[q][1], o[q][2], o[q][3]);
    }
    fence_proxy_async();               // staging writes -> the bulk store
    __syncthreads();                   // staging written, input slot read
    if (tid == 0) {
      for (int q = 0; q < NOUT; ++q)
        step_copies<false>(ob[q], ops.out[q], s0 + i, g, nullptr);
      bulk_commit();
      if (i + g.la < n) load(i + g.la);   // refill the slot just read
    }
  }
  if (tid == 0) bulk_wait_all();       // epilogue: drain the stores
}

template <typename T, int NIN, int NOUT, typename Op>
int ring_t(Operands<T, NIN, NOUT> ops, Op op, int rows, int cols, int d,
           int bm, int tw, int la, int per, int interleaved,
           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || d <= 0 || bm <= 0 || tw <= 0 || la <= 0 ||
      per <= 0 || rows % d != 0 || (rows / d) % bm != 0 || cols % tw != 0 ||
      tw % SUB != 0)
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
  const size_t slot_bytes = static_cast<size_t>(d) * bm * tw * sizeof(T);
  if (steps > (1LL << 30) || blocks > (1LL << 30) || slot_bytes >= (1u << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  g.steps = static_cast<int>(steps);
  g.per = per;
  const size_t smem =
      ring_header(NIN, la) +
      (static_cast<size_t>(NIN) * la + static_cast<size_t>(OUT_STAGES) * NOUT) *
          slot_bytes;
  auto kernel = manual_ring<T, NIN, NOUT, Op>;
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
  return ring_t<T, 1, 1>({{static_cast<const T*>(x)}, {static_cast<T*>(o)}},
                         CopyOp<T>{}, rows, cols, d, bm, tw, la, per,
                         interleaved, stream);
}

template <typename T>
int triad_t(const void* b, const void* c, void* o, float alpha, int rows,
            int cols, int d, int bm, int tw, int la, int per, int interleaved,
            cudaStream_t stream) {
  return ring_t<T, 2, 1>(
      {{static_cast<const T*>(b), static_cast<const T*>(c)},
       {static_cast<T*>(o)}},
      TriadOp<T>{alpha}, rows, cols, d, bm, tw, la, per, interleaved, stream);
}

template <typename T>
int fill_t(void* o, float value, int rows, int cols, int d, int bm, int tw,
           int la, int per, int interleaved, cudaStream_t stream) {
  return ring_t<T, 0, 1>({{nullptr}, {static_cast<T*>(o)}}, FillOp<T>{value},
                         rows, cols, d, bm, tw, la, per, interleaved, stream);
}

template <typename T>
int sum_t(const void* x, const void* z, void* o, int rows, int cols, int d,
          int bm, int tw, int la, int per, int interleaved,
          cudaStream_t stream) {
  return ring_t<T, 2, 1>(
      {{static_cast<const T*>(x), static_cast<const T*>(z)},
       {static_cast<T*>(o)}},
      SumOp<T>{}, rows, cols, d, bm, tw, la, per, interleaved, stream);
}

int adamw_f32(const void* p, const void* g, const void* m, const void* v,
              const void* s, void* po, void* mo, void* vo, int rows, int cols,
              int d, int bm, int tw, int la, int per, int interleaved,
              cudaStream_t stream) {
  using F = const float*;
  return ring_t<float, 4, 3>(
      {{static_cast<F>(p), static_cast<F>(g), static_cast<F>(m),
        static_cast<F>(v)},
       {static_cast<float*>(po), static_cast<float*>(mo),
        static_cast<float*>(vo)}},
      AdamWOp{static_cast<F>(s), {}}, rows, cols, d, bm, tw, la, per,
      interleaved, stream);
}

}  // namespace

// Every launcher: [rows, cols] row-major arrays of `dtype`, 16-byte
// aligned; d streams of seg = rows / d rows; steps of bm rows by tw
// columns (tw a multiple of 128 dividing cols), seg / bm * cols / tw of
// them per segment, `per` consecutive steps a block; a ring of `la`
// stages per input; copies issued grouped (interleaved = 0) or
// interleaved (1).

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

// p, g, m, v (inputs) and po, mo, vo (outputs): f32 only (the ring takes
// one element type, and m and v are f32); s: f32 [7] = (lr, b1, b2, eps,
// wd, bc1, bc2) on the card.
extern "C" int manual_adamw_launch(int dtype, const void* p, const void* g,
                                   const void* m, const void* v,
                                   const void* s, void* po, void* mo,
                                   void* vo, int rows, int cols, int d,
                                   int bm, int tw, int la, int per,
                                   int interleaved, void* stream) {
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return adamw_f32(p, g, m, v, s, po, mo, vo, rows, cols, d, bm, tw, la, per,
                   interleaved, static_cast<cudaStream_t>(stream));
}
