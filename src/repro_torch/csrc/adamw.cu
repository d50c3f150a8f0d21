// Multi-strided fused AdamW update for Hopper (sm_90a), over a list of
// parameter tensors in one launch.
//
// Replaces the adamw_update instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// adamw_spec (src/repro/kernels/adamw/specs.py): for every element of
// every leaf (p, g, m, v) of the list,
//   g  = g * gscale                     (when a clip scale is given)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + ((1 - b2) * g) * g
//   u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p
//   p' = p - lr * u
// in f32, with p of type T (f32, bf16 or f16) and g of type G (T or f32)
// widened, m and v f32; wd is the leaf's own (from the table) or the
// scalars'.  p' is stored in T (one rounding from f32), m' and v' in f32.
//
// What bounds it: bytes.  Four reads and three writes an element (28
// bytes in f32) for about eight flops, one square root and two divisions,
// far below the card's ~20 flops per byte of f32 arithmetic.  An
// optimizer step over a model's tree besides pays a launch, a config
// resolution and a clip pass (g * scale, 8 bytes an element) a leaf
// where each leaf runs on its own.
//
// What the design does about it.  One launch a step for all leaves of
// one dtype, the clip scale fused as the body's first operation, on
// common.cuh's flat walk (gemver_sum's and stream.cu's): the walk runs
// over the virtual concatenation of the leaves' 16-byte vectors of p
// (4 elements in f32, 8 in bf16 and f16; g, m and v take the same
// elements, 16 or 32 bytes each), every leaf starting on a whole unit of
// 128 vectors.  The D segments cut that whole range, so a step's D
// streams read from D places of the tree at once, usually D different
// leaves: the paper's pattern across the tree.  Each unit finds its leaf
// by a binary search of the leaves' first units in the table, which sits
// in the kernel's parameter space (__grid_constant__, up to TABLE_MAX
// leaves; the wrapper splits a longer list): one entry holds the leaf's
// p, g, m and v pointers, its element count and its weight decay.  A
// unit lies in one leaf, so its 128 threads read the same entries.  A
// leaf's ragged end (a vector past its last element) is loaded and
// stored element by element, with no padded copy.  A thread issues the
// loads of ADAMW_HELD = 2 units (64 to 112 bytes each) before it
// computes or stores any: holding 4 in f32 took 112 registers a thread,
// and was 1.5-3% slower over Yi-9B's leaf lists at P = 2 and 10-19% at
// P = 1 (tools/torch_kernel_ab.py AB_ONLY=adamw_dp, one H100).  p, m and
// v are written where they were read (in place, as torch._fused_adamw_
// does); a list of one leaf may instead go out of place to po, mo, vo
// (the per-tensor op).  The seven scalars stay an f32 [7] on the card
// and the clip scale a 0-d f32 there: no host sync.
//
// The body and its seven scalars are adamw.cuh's AdamWBody, shared with
// the K4 ring's adamw body (manual_ring.cu): bit for bit the plain
// version's arithmetic.  g * gscale is __fmul_rn, exactly the plain
// g.float() * scale.
#include "adamw.cuh"

namespace {

constexpr int TABLE_MAX = 512;        // leaves of one launch
constexpr int ADAMW_HELD = 2;         // units a thread holds at once

struct Leaf {
  void* p;
  const void* g;
  float* m;
  float* v;
  long long n;                        // elements
  float wd;
};

// first[i]: the leaf's first unit of the virtual range; first[nleaves]
// the range's end (units)
template <int CAP>
struct Table {
  int first[CAP + 1];
  Leaf leaf[CAP];
  int nleaves;
};

struct Out {
  void* p;
  float* m;
  float* v;
};

// 16-byte words of a vector whose elements take ES bytes each: a full
// vector in NW words, or the first cnt elements of it (the rest 0)
template <int ES, int NW>
__device__ __forceinline__ void load_vec(const void* base, long long idx,
                                         int cnt, uint4 (&w)[NW]) {
  constexpr int E = NW * 16 / ES;
  if (cnt == E) {
    const uint4* q = static_cast<const uint4*>(base) + idx * NW;
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = q[i];
    return;
  }
  uint32_t r[NW * 4];
#pragma unroll
  for (int i = 0; i < NW * 4; ++i) r[i] = 0u;
  const long long e0 = idx * E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < cnt) {
      if constexpr (ES == 4) {
        r[e] = static_cast<const uint32_t*>(base)[e0 + e];
      } else {
        const uint32_t h = static_cast<const unsigned short*>(base)[e0 + e];
        r[e >> 1] |= (e & 1) ? (h << 16) : h;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i)
    w[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}

template <int ES, int NW>
__device__ __forceinline__ void store_vec(void* base, long long idx, int cnt,
                                          const uint32_t (&r)[NW * 4]) {
  constexpr int E = NW * 16 / ES;
  if (cnt == E) {
    uint4* q = static_cast<uint4*>(base) + idx * NW;
#pragma unroll
    for (int i = 0; i < NW; ++i)
      q[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
    return;
  }
  const long long e0 = idx * E;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < cnt) {
      if constexpr (ES == 4)
        static_cast<uint32_t*>(base)[e0 + e] = r[e];
      else
        static_cast<unsigned short*>(base)[e0 + e] =
            static_cast<unsigned short>((e & 1) ? (r[e >> 1] >> 16)
                                                : (r[e >> 1] & 0xffffu));
    }
  }
}

template <typename T, typename G, int CAP>
struct LeavesBody {
  static constexpr int E = 16 / static_cast<int>(sizeof(T));  // a vector
  static constexpr int GW = E * static_cast<int>(sizeof(G)) / 16;
  static constexpr int MW = E * 4 / 16;
  struct Held {
    uint4 p[1], g[GW], m[MW], v[MW];
    long long idx;                    // the vector's index in its leaf
    int leaf, cnt;                    // its leaf, its elements there
  };
  const Table<CAP>* t;
  Out out;
  AdamWBody h;
  float gs;
  bool scaled, wd_table;

  __device__ __forceinline__ bool load(long long at, Held& x) const {
    const long long unit = at / WALK_UNIT;
    if (unit >= t->first[t->nleaves]) return false;
    int lo = 0, hi = t->nleaves - 1;  // the last leaf starting at or before
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t->first[mid] <= unit) lo = mid; else hi = mid - 1;
    }
    const Leaf& L = t->leaf[lo];
    const long long idx = at - static_cast<long long>(t->first[lo]) * WALK_UNIT;
    const long long rest = L.n - idx * E;
    if (rest <= 0) return false;
    x.idx = idx;
    x.leaf = lo;
    x.cnt = rest < E ? static_cast<int>(rest) : E;
    load_vec<sizeof(T), 1>(L.p, idx, x.cnt, x.p);
    load_vec<sizeof(G), GW>(L.g, idx, x.cnt, x.g);
    load_vec<4, MW>(L.m, idx, x.cnt, x.m);
    load_vec<4, MW>(L.v, idx, x.cnt, x.v);
    return true;
  }

  __device__ __forceinline__ void store(long long, const Held& x) const {
    const Leaf& L = t->leaf[x.leaf];
    AdamWBody b = h;
    if (wd_table) b.wd = L.wd;
    const uint32_t pw[4] = {x.p[0].x, x.p[0].y, x.p[0].z, x.p[0].w};
    uint32_t gw[4 * GW], mw[4 * MW], vw[4 * MW];
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      gw[4 * i] = x.g[i].x; gw[4 * i + 1] = x.g[i].y;
      gw[4 * i + 2] = x.g[i].z; gw[4 * i + 3] = x.g[i].w;
    }
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      mw[4 * i] = x.m[i].x; mw[4 * i + 1] = x.m[i].y;
      mw[4 * i + 2] = x.m[i].z; mw[4 * i + 3] = x.m[i].w;
      vw[4 * i] = x.v[i].x; vw[4 * i + 1] = x.v[i].y;
      vw[4 * i + 2] = x.v[i].z; vw[4 * i + 3] = x.v[i].w;
    }
    uint32_t po[4] = {0u, 0u, 0u, 0u}, mo[4 * MW], vo[4 * MW];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float g = Cvt<G>::get(gw, e);
      if (scaled) g = __fmul_rn(g, gs);
      float pn, mn, vn;
      b.apply(Cvt<T>::get(pw, e), g, __uint_as_float(mw[e]),
              __uint_as_float(vw[e]), pn, mn, vn);
      Cvt<T>::put(po, e, pn);
      mo[e] = __float_as_uint(mn);
      vo[e] = __float_as_uint(vn);
    }
    store_vec<sizeof(T), 1>(out.p ? out.p : L.p, x.idx, x.cnt, po);
    store_vec<4, MW>(out.p ? out.m : L.m, x.idx, x.cnt, mo);
    store_vec<4, MW>(out.p ? out.v : L.v, x.idx, x.cnt, vo);
  }
};

template <typename T, typename G, int CAP>
__global__ void __launch_bounds__(WALK_UNIT)
adamw_update(const __grid_constant__ Table<CAP> t,
             const float* __restrict__ s, const float* __restrict__ gscale,
             Out out, long long segv, int d, int np, bool interleaved,
             bool wd_table) {
  LeavesBody<T, G, CAP> body{&t, out, {}, 1.0f, gscale != nullptr,
                             wd_table};
  body.h.load(s);
  if (gscale) body.gs = __ldg(gscale);
  flat_walk<LeavesBody<T, G, CAP>, ADAMW_HELD>(segv, d, np, interleaved,
                                               body);
}

template <typename T, typename G, int CAP>
int launch_cap(int n, const long long* ptrs, const long long* ns,
               const float* wds, const int* first, const void* s,
               const void* gscale, Out out, long long segv, int d, int np,
               int interleaved, int wd_table, cudaStream_t stream) {
  dim3 grid;
  if (!walk_grid(segv, d, np, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  Table<CAP> t;
  for (int i = 0; i < n; ++i) {
    t.first[i] = first[i];
    t.leaf[i] = Leaf{reinterpret_cast<void*>(ptrs[4 * i]),
                     reinterpret_cast<const void*>(ptrs[4 * i + 1]),
                     reinterpret_cast<float*>(ptrs[4 * i + 2]),
                     reinterpret_cast<float*>(ptrs[4 * i + 3]), ns[i],
                     wds ? wds[i] : 0.0f};
  }
  t.first[n] = first[n];
  t.nleaves = n;
  adamw_update<T, G, CAP><<<grid, WALK_UNIT, 0, stream>>>(
      t, static_cast<const float*>(s), static_cast<const float*>(gscale),
      out, segv, d, np, interleaved != 0, wd_table != 0);
  return static_cast<int>(cudaGetLastError());
}

// What the table must be: 1 to TABLE_MAX leaves, each a non-empty,
// 16-byte aligned run starting on the unit first[i] with room for its
// vectors before first[i + 1]; a list of one leaf where out is given; a
// range the d segments of segv vectors cover.
template <typename T>
bool bad_table(int n, const long long* ptrs, const long long* ns,
               const int* first, Out out, long long segv, int d) {
  constexpr long long E = 16 / sizeof(T);
  if (n < 1 || n > TABLE_MAX || (out.p && n != 1) || first[0] != 0 ||
      d <= 0 || segv * d < static_cast<long long>(first[n]) * WALK_UNIT)
    return true;
  if (out.p && ((reinterpret_cast<uintptr_t>(out.p) |
                 reinterpret_cast<uintptr_t>(out.m) |
                 reinterpret_cast<uintptr_t>(out.v)) & 15))
    return true;
  for (int i = 0; i < n; ++i) {
    const long long units = ((ns[i] + E - 1) / E + WALK_UNIT - 1) / WALK_UNIT;
    if (ns[i] <= 0 || first[i + 1] - first[i] < units) return true;
    for (int k = 0; k < 4; ++k)
      if (ptrs[4 * i + k] & 15) return true;
  }
  return false;
}

template <typename T, typename G>
int adamw_t(int n, const long long* ptrs, const long long* ns,
            const float* wds, const int* first, const void* s,
            const void* gscale, Out out, long long segv, int d, int np,
            int interleaved, cudaStream_t stream) {
  if (bad_table<T>(n, ptrs, ns, first, out, segv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 1)
    return launch_cap<T, G, 1>(n, ptrs, ns, wds, first, s, gscale, out, segv,
                               d, np, interleaved, wds != nullptr, stream);
  return launch_cap<T, G, TABLE_MAX>(n, ptrs, ns, wds, first, s, gscale, out,
                                     segv, d, np, interleaved,
                                     wds != nullptr, stream);
}

}  // namespace

// One AdamW update of n leaves.  ptrs: [n, 4] (p, g, m, v) device
// pointers, 16-byte aligned and contiguous; ns: [n] elements; wds: [n]
// weight decays, or null to take the scalars' wd; first: [n + 1] each
// leaf's first unit of 128 vectors of `dtype` (16 bytes) in the virtual
// range (first[0] = 0), first[n] its end; s: f32 [7] = (lr, b1, b2, eps,
// wd, bc1, bc2) on the card; gscale: a 0-d f32 on the card multiplying g
// first, or null.  p of `dtype`, g of `gdtype` (dtype or f32), m and v
// f32.  In place, unless po (with mo, vo) is given for a list of one
// leaf.  d segments of segv vectors of the range, steps of np units, d
// blocks of 128 threads a step, its units ordered grouped
// (interleaved = 0) or interleaved (1) (common.cuh flat_walk).
extern "C" int adamw_launch(int dtype, int gdtype, int n,
                            const long long* ptrs, const long long* ns,
                            const float* wds, const int* first,
                            const void* s, const void* gscale, void* po,
                            void* mo, void* vo, long long segv, int d,
                            int np, int interleaved, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Out out{po, static_cast<float*>(mo), static_cast<float*>(vo)};
  const bool g32 = gdtype == kF32;
  if (!g32 && gdtype != dtype) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32:
      return adamw_t<float, float>(n, ptrs, ns, wds, first, s, gscale, out, segv, d, np, interleaved, st);
    case kBF16:
      return g32 ? adamw_t<__nv_bfloat16, float>(n, ptrs, ns, wds, first, s, gscale, out, segv, d, np, interleaved, st)
                 : adamw_t<__nv_bfloat16, __nv_bfloat16>(n, ptrs, ns, wds, first, s, gscale, out, segv, d, np, interleaved, st);
    case kF16:
      return g32 ? adamw_t<__half, float>(n, ptrs, ns, wds, first, s, gscale, out, segv, d, np, interleaved, st)
                 : adamw_t<__half, __half>(n, ptrs, ns, wds, first, s, gscale, out, segv, d, np, interleaved, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Leaves one launch's table holds.
extern "C" int adamw_table_max() { return TABLE_MAX; }
