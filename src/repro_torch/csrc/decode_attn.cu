// Multi-strided flash-decode for Hopper (sm_90a), redesigned for the
// card's shared memory, tensor cores and asynchronous copies.
//
// Replaces the decode_attn instance of the JAX package's K3 template,
// _emit_stream_reduction (src/repro/codegen/emit.py:564), whose body is
// the online-softmax spec of src/repro/kernels/decode_attn/specs.py:
// one query token per batch row against a [B, S, Hkv*dh] K/V cache,
// query heads grouped (hkv, g) so query head h*g + j reads KV head h,
// scores f32(q) . f32(k) / sqrt(dh), rows with M <= 0.5 masked, out =
// softmax(scores) V and lse = m + log(den).
//
// What bounds it: bytes.  Each K and V element (2 bytes in bf16) is used
// in 2 * g flops, far below the card's ~295 flops per byte, so the kernel
// is as fast as it streams the rows it must read: the valid ones.
//
// The design (two launches: the split, then the fold):
//   * Units and chunks.  The spec's D segments (seg = S / D rows, at k *
//     seg) are cut into 64-row tiles; unit u = t * D + k is tile t of
//     segment k, so consecutive units walk the D segments at once, the
//     paper's D streams.  Block (c, y, b) of the grid (C, Hkv * g / GC,
//     B) takes the units [c * upb, (c + 1) * upb) of batch row b, for GC
//     query heads of one KV head (GC the largest divisor of g up to 16,
//     padded to GP = 8 or 16).  C comes from the SM count
//     (kernels/decode_attn/kernel.py plan_chunks), so a serve step's
//     grid fills the card however few batch rows and KV heads it has.
//   * A producer warp reads each unit's 64 mask values first (4 bytes a
//     row against 2 * dh * 2 bytes of K and V a KV head in bf16), 32
//     units at a time, one unit a lane, and issues no load for a unit
//     whose rows are all masked.  For the others it fills a ring of
//     STAGES shared-memory stages with two TMA tensor copies (K and V,
//     64 rows x dh of the KV head, a strided 2-D box) on an mbarrier,
//     and hands the unit and its 64-bit row mask to the consumers.
//   * Four consumer warps, each with rows w * 16 ... + 15 of every tile
//     and an online-softmax state of its own, so no barrier of the block
//     falls between tiles.  bf16: the scores of the warp's 16-row K tile
//     (A) against the GP query heads (B, from registers) come from
//     mma.sync m16n8k16 with f32 accumulators (bf16 products are exact
//     in f32; only the order of the sum differs from the spec); K lands
//     swizzled by the TMA (row pieces of up to 128 bytes), so the A
//     fragments load without bank conflicts.  f32 K and V take a
//     CUDA-core dot per (row, head), no TF32.  Each head's tile max and
//     sum of p = exp(s - m) are shuffle trees over the lanes that hold
//     its rows (two trees of three or four steps a head a tile, none a
//     row); p goes through the warp's own shared-memory buffer once a
//     tile, and P V runs in f32 on CUDA cores, each lane holding 4 dims
//     of its heads (all GP at dh = 128).  At the end the four warps'
//     states merge in warp order into the block's.
//   * Skipping is exact: a fully masked tile's state (-1e30, sum V,
//     rows) merges with weight exp(-1e30 - m) == 0 into any state that
//     saw a valid row.  Only a batch row with no valid position at all
//     differs: the spec then returns the mean of V over all S rows,
//     with lse = -1e30 + log S.  So a block whose chunk is all masked
//     scans its batch row's mask for a valid position; if it finds one
//     its state is the identity (-1e30, 0, 0), else it sums V over its
//     chunk's rows (state (-1e30, sum V, rows)), as the spec's tiles do.
//   * The fold.  Every block writes its state to a [B, C, Hq] f32
//     scratch; decode_merge, a second launch, folds the C states in
//     order c = 0 ... C-1 from (-1e30, 0, 0) with the OnlineSoftmax
//     merge and finalizes out = num / max(den, eps) and lse = m +
//     log(max(den, eps)).  The fold's order is fixed, so the output's
//     bits repeat from run to run.  (A one-launch form, whose last block
//     of each (b, head chunk) folded after a ticket, was slower at every
//     shape measured: PERF.md.)
//
// NEG_INF is the finite -1e30 of the spec, never -inf.
#include <type_traits>

#include "tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TROWS = 64;            // rows a unit (a tile)
constexpr int NCW = 4;               // consumer warps, 16 rows each
constexpr int THREADS = (NCW + 1) * 32;
constexpr int MAX_STAGES = 4;

template <typename T, int DH, int NT>
struct Cfg {
  static constexpr int GP = 8 * NT;                 // padded heads a block
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROWB = DH * ES;              // bytes of a head row
  // K's TMA box width in bytes (bf16): the widest swizzle span of 128,
  // 64 or 32 bytes that divides the row (dh = 48, 80, 112 take 32-byte
  // boxes, dh = 96 64-byte ones), so a tile is NSUB boxes side by side
  static constexpr int RB =
      !MMA ? ROWB
           : (ROWB % 128 == 0 ? 128 : (ROWB % 64 == 0 ? 64 : 32));
  static constexpr int NSUB = ROWB / RB;            // K boxes a tile
  static constexpr int SWZ = MMA ? RB / 16 - 1 : 0; // TMA swizzle mask
  static constexpr int TILE_B = TROWS * ROWB;       // K or V tile bytes
  static constexpr int STAGES =
      98304 / (2 * TILE_B) < 2 ? 2
      : (98304 / (2 * TILE_B) > MAX_STAGES ? MAX_STAGES
                                           : 98304 / (2 * TILE_B));
  // a consumer warp's P V: DG lanes cover the head's dims, 4 each; HS
  // head sets a warp, JPL heads a lane; where DG does not divide 32 (dh
  // = 48, 80, 96, 112) the last 32 - HS * DG lanes take no part in P V
  static constexpr int DG = DH / 4;
  static constexpr int HS = 32 / DG;
  static constexpr int PV_LANES = HS * DG;
  static constexpr int JPL = GP / HS;
  static_assert(DH % 16 == 0 && DH <= 128, "dh a multiple of 16, at most 128");
  static_assert(ROWB % RB == 0 && (TROWS * RB) % 1024 == 0,
                "K boxes tile a row; each box's stage stays 1024-aligned");
  static constexpr int SPW = GP + 4;                // P row stride, 16-byte rows
  // dynamic shared memory: the K and V rings, each consumer warp's P
  // [16][SPW] and alpha [GP], the f32 query heads (CUDA-core path), and
  // 1024 bytes of alignment slack
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(STAGES) * 2 * TILE_B +
      NCW * (16 * SPW + GP) * 4 + (MMA ? 0 : GP * DH * 4);
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geo {
  int S, hkv, g, gc, nhc, hq, d, seg, nt, units, upb, chunks;
  float scale, eps;
  int masked;
};

// The rows of unit u: segment k = u % d, tile t = u / d.
__device__ __forceinline__ void unit_rows(const Geo& G, int u, int& row0,
                                          int& nrows) {
  const int t = u / G.d, k = u % G.d;
  row0 = k * G.seg + t * TROWS;
  nrows = min(TROWS, G.seg - t * TROWS);
}

// The 4 consecutive elements of T at p, widened to f32.
template <typename T>
__device__ __forceinline__ void get4(const T* p, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {u.x, u.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = Cvt<T>::get(w, e);
  }
}

// The heads a consumer lane holds scores of, and whether it holds row 0
// of its warp's 16: mma layout (lane = 4 g + q: rows g, g + 8, heads
// nt * 8 + 2 q + e) or the CUDA-core one (lane = 16 half + row: heads
// half * GP / 2 + i).
template <bool MMA, int GP>
__device__ __forceinline__ int lane_head(int lane, int i) {
  return MMA ? (i >> 1) * 8 + (lane & 3) * 2 + (i & 1)
             : (lane >> 4) * (GP / 2) + i;
}

template <bool MMA>
__device__ __forceinline__ bool lane_row0(int lane) {
  return MMA ? (lane >> 2) == 0 : (lane & 15) == 0;
}

// Fold the `chunks` states of query head `st0` (state index of chunk 0;
// chunk c at st0 + c * cstride) for dims d4 * 4 ... d4 * 4 + 3 in order
// c = 0 ... chunks-1 from (-1e30, 0, 0), and finalize.  Loads go 16
// chunks at a time, all issued before the merges that use them.
__device__ __forceinline__ void fold4(const float* pm, const float* pnum,
                                      const float* pden, size_t st0,
                                      size_t cstride, int chunks, int dh,
                                      int d4, float eps, float* out,
                                      float* lse) {
  constexpr int BATCH = 16;
  float m = NEG_INF, den = 0.f, n[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < chunks; c0 += BATCH) {
    float m2[BATCH], d2[BATCH];
    float4 n2[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      if (c0 + e < chunks) {
        const size_t st = st0 + static_cast<size_t>(c0 + e) * cstride;
        m2[e] = __ldcg(pm + st);
        d2[e] = __ldcg(pden + st);
        n2[e] = __ldcg(reinterpret_cast<const float4*>(pnum + st * dh) + d4);
      }
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      if (c0 + e < chunks) {
        const float mn = fmaxf(m, m2[e]);
        const float a1 = expf(m - mn), a2 = expf(m2[e] - mn);
        n[0] = n[0] * a1 + n2[e].x * a2;
        n[1] = n[1] * a1 + n2[e].y * a2;
        n[2] = n[2] * a1 + n2[e].z * a2;
        n[3] = n[3] * a1 + n2[e].w * a2;
        den = den * a1 + d2[e] * a2;
        m = mn;
      }
    }
  }
  den = fmaxf(den, eps);
  *reinterpret_cast<float4*>(out + d4 * 4) =
      make_float4(n[0] / den, n[1] / den, n[2] / den, n[3] / den);
  if (d4 == 0) *lse = m + logf(den);
}

// Two blocks an SM where their rings fit the 227 KB (bf16 at every dh):
// up to 204 registers a thread, no spill.
template <typename T, int DH, int NT>
__global__ void __launch_bounds__(THREADS, 2)
decode_kernel(const __grid_constant__ CUtensorMap tmK,
              const __grid_constant__ CUtensorMap tmV,
              const T* __restrict__ V, const T* __restrict__ q,
              const float* __restrict__ M, float* __restrict__ pm,
              float* __restrict__ pnum, float* __restrict__ pden, Geo G) {
  using C = Cfg<T, DH, NT>;
  static_assert(C::STAGES * C::TILE_B >= NCW * C::GP * DH * 4,
                "the K ring holds the consumer warps' num at the end");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ int info[C::STAGES][3];     // unit, row mask lo, hi
  __shared__ float wm[NCW][C::GP], wd[NCW][C::GP];   // warps' (m, den)
  __shared__ int s_nvalid;

  unsigned char* smem = smem_raw +
      ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kring = smem;                               // [STAGES][TILE_B]
  unsigned char* vring = smem + C::STAGES * C::TILE_B;       // [STAGES][TILE_B]
  float* pbuf = reinterpret_cast<float*>(vring + C::STAGES * C::TILE_B);
  float* qs = pbuf + NCW * (16 * C::SPW + C::GP);            // [GP][DH] f32

  const int c = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int h = y / G.nhc, head0 = h * G.g + (y % G.nhc) * G.gc;
  const int u0 = c * G.upb, u1 = min(G.units, u0 + G.upb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t brow = static_cast<size_t>(b) * G.S;

  if (tid == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NCW);
    }
    fence_barrier_init();
  }
  if constexpr (!C::MMA) {              // f32 query heads, padded with 0
    for (int p = tid; p < C::GP * DH; p += THREADS) {
      const int j = p / DH;
      qs[p] = j < G.gc ? Cvt<T>::to(q[(static_cast<size_t>(b) * G.hq +
                                       head0 + j) * DH + p % DH])
                       : 0.f;
    }
  }
  __syncthreads();

  // each consumer warp keeps the online-softmax state of its 16 rows of
  // every tile: (m, den) of the heads its lanes hold scores of, and num
  // of heads hs * JPL + i, dims dg * 4 ... + 3 of each lane
  constexpr int NH = C::MMA ? 2 * NT : C::GP / 2;   // heads a lane scores
  float m_w[NH], den_w[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) { m_w[i] = NEG_INF; den_w[i] = 0.f; }
  const int hs = lane / C::DG, dg = lane % C::DG;
  float num[C::JPL][4] = {};

  if (warp == NCW) {
    // ---- producer: mask scan, then the K / V ring
    int i = 0;
    for (int ub = u0; ub < u1; ub += 32) {
      const int u = ub + lane;
      unsigned long long mask = 0ull;
      if (u < u1) {
        int row0, nrows;
        unit_rows(G, u, row0, nrows);
        if (G.masked) {               // all 64 loads in flight at once
          const float* mp = M + brow + row0;
          float mv[TROWS];
#pragma unroll
          for (int r = 0; r < TROWS; ++r) mv[r] = r < nrows ? __ldg(mp + r) : 0.f;
#pragma unroll
          for (int r = 0; r < TROWS; ++r)
            if (mv[r] > 0.5f) mask |= 1ull << r;
        } else {
          mask = nrows >= 64 ? ~0ull : ((1ull << nrows) - 1ull);
        }
      }
      unsigned ballot = __ballot_sync(0xffffffffu, mask != 0ull);
      while (ballot) {
        const int src = __ffs(ballot) - 1;
        ballot &= ballot - 1;
        const unsigned lo = __shfl_sync(0xffffffffu,
                                        static_cast<unsigned>(mask), src);
        const unsigned hi = __shfl_sync(0xffffffffu,
                                        static_cast<unsigned>(mask >> 32), src);
        if (lane == 0) {
          const int slot = i % C::STAGES;
          if (i >= C::STAGES)
            mbar_wait(&empty[slot], static_cast<uint32_t>(((i / C::STAGES) - 1) & 1));
          int row0, nrows;
          unit_rows(G, ub + src, row0, nrows);
          info[slot][0] = ub + src;
          info[slot][1] = static_cast<int>(lo);
          info[slot][2] = static_cast<int>(hi);
          mbar_expect_tx(&full[slot], 2u * C::TILE_B);
          const int yrow = static_cast<int>(brow) + row0;
#pragma unroll
          for (int sb = 0; sb < C::NSUB; ++sb)
            tma_load(kring + slot * C::TILE_B + sb * (TROWS * C::RB), &tmK,
                     h * DH + sb * (C::RB / C::ES), yrow, &full[slot]);
          tma_load(vring + slot * C::TILE_B, &tmV, h * DH, yrow, &full[slot]);
        }
        ++i;
        __syncwarp();
      }
    }
    if (lane == 0) {                    // the end: a unit of -1
      const int slot = i % C::STAGES;
      if (i >= C::STAGES)
        mbar_wait(&empty[slot], static_cast<uint32_t>(((i / C::STAGES) - 1) & 1));
      info[slot][0] = -1;
      mbar_arrive(&full[slot]);
      s_nvalid = i;
    }
  } else {
    // ---- consumers: warp w takes rows w * 16 ... + 15 of every tile
    float* pw = pbuf + warp * (16 * C::SPW + C::GP);   // P [16][SPW]
    float* aw = pw + 16 * C::SPW;                       // alpha [GP]
    uint32_t qf[NT][DH / 16][2];        // B fragments (bf16 path)
    if constexpr (C::MMA) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + (lane >> 2);
        const T* qp = q + (static_cast<size_t>(b) * G.hq + head0 + j) * DH +
                      (lane & 3) * 2;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          qf[nt][kk][0] = j < G.gc ? *reinterpret_cast<const uint32_t*>(qp + kk * 16) : 0u;
          qf[nt][kk][1] = j < G.gc ? *reinterpret_cast<const uint32_t*>(qp + kk * 16 + 8) : 0u;
        }
      }
    }
    for (int i = 0;; ++i) {
      const int slot = i % C::STAGES;
      mbar_wait(&full[slot], static_cast<uint32_t>((i / C::STAGES) & 1));
      if (info[slot][0] < 0) break;
      const unsigned long long rmask =
          static_cast<unsigned long long>(static_cast<unsigned>(info[slot][1])) |
          (static_cast<unsigned long long>(static_cast<unsigned>(info[slot][2])) << 32);
      const unsigned char* kt = kring + slot * C::TILE_B;
      const T* vt = reinterpret_cast<const T*>(vring + slot * C::TILE_B) +
                    warp * 16 * DH;

      // 1. scores s of this warp's rows, scaled and masked; the tile's
      // online-softmax update of each head over them; p into pw
      float s[NH][2];                   // [head of the lane][row of the lane]
      int prow[2];                      // the rows of the lane's p values
      if constexpr (C::MMA) {
        const int g0 = lane >> 2, r0 = warp * 16 + g0, r1 = r0 + 8;
        float acc[NT][4] = {};
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int cb = (kk * 16 + half * 8 + (lane & 3) * 2) * 2;  // bytes
            const int sub = cb / C::RB, cw = cb % C::RB;
            const unsigned char* st = kt + sub * (TROWS * C::RB);
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int o = (rr ? r1 : r0) * C::RB + cw;
              const int os = o ^ (((o >> 7) & C::SWZ) << 4);
              a[half * 2 + rr] = *reinterpret_cast<const uint32_t*>(st + os);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, qf[nt][kk]);
        }
        const bool v0 = (rmask >> r0) & 1ull, v1 = (rmask >> r1) & 1ull;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt * 2 + e][0] = v0 ? acc[nt][e] * G.scale : NEG_INF;
            s[nt * 2 + e][1] = v1 ? acc[nt][2 + e] * G.scale : NEG_INF;
          }
        prow[0] = g0;
        prow[1] = g0 + 8;
      } else {
        const int rl = lane & 15, r = warp * 16 + rl;
        const int jb = (lane >> 4) * (C::GP / 2);
        const float* kr = reinterpret_cast<const float*>(kt) + r * DH;
        float sc[C::GP / 2] = {};
        for (int c4 = 0; c4 < DH / 4; ++c4) {
          const int cc = ((c4 + r) % (DH / 4)) * 4;      // rotated: no conflicts
          const float4 k4 = *reinterpret_cast<const float4*>(kr + cc);
#pragma unroll
          for (int jj = 0; jj < C::GP / 2; ++jj) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + (jb + jj) * DH + cc);
            sc[jj] = fmaf(q4.x, k4.x, sc[jj]);
            sc[jj] = fmaf(q4.y, k4.y, sc[jj]);
            sc[jj] = fmaf(q4.z, k4.z, sc[jj]);
            sc[jj] = fmaf(q4.w, k4.w, sc[jj]);
          }
        }
        const bool v = (rmask >> r) & 1ull;
#pragma unroll
        for (int jj = 0; jj < C::GP / 2; ++jj) {
          s[jj][0] = v ? sc[jj] * G.scale : NEG_INF;
          // one row a lane here: the second slot weighs exp(-1e30 - m),
          // 0 once the warp has seen a valid row (before that its state
          // is (-1e30, ...), which any valid state outweighs to 0)
          s[jj][1] = NEG_INF;
        }
        prow[0] = rl;
        prow[1] = -1;
      }
      // the rows of a head lie in the lanes that differ in g (mma: lane
      // bits 2-4) or in the row (CUDA cores: lane bits 0-3)
      constexpr int OFF0 = C::MMA ? 4 : 1, OFF1 = C::MMA ? 32 : 16;
      float al[NH];
#pragma unroll
      for (int i2 = 0; i2 < NH; ++i2) {
        float mt = fmaxf(s[i2][0], s[i2][1]);
#pragma unroll
        for (int off = OFF0; off < OFF1; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(m_w[i2], mt);
        al[i2] = expf(m_w[i2] - mn);
        s[i2][0] = expf(s[i2][0] - mn);
        s[i2][1] = expf(s[i2][1] - mn);
        float ps = s[i2][0] + s[i2][1];
#pragma unroll
        for (int off = OFF0; off < OFF1; off <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        den_w[i2] = den_w[i2] * al[i2] + ps;
        m_w[i2] = mn;
      }
      __syncwarp();                     // the last tile's P V has read pw
#pragma unroll
      for (int i2 = 0; i2 < NH; ++i2) {
        const int j = lane_head<C::MMA, C::GP>(lane, i2);
        pw[prow[0] * C::SPW + j] = s[i2][0];
        if (prow[1] >= 0) pw[prow[1] * C::SPW + j] = s[i2][1];
        if (prow[0] == 0) aw[j] = al[i2];
      }
      __syncwarp();

      // 2. P V over this warp's 16 rows: heads hs * JPL ..., dims dg * 4
      const T* vp = vt + dg * 4;
      const float* pp = pw + hs * C::JPL;
#pragma unroll
      for (int jj = 0; jj < C::JPL; ++jj) {
        const float a2 = lane < C::PV_LANES ? aw[hs * C::JPL + jj] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) num[jj][e] *= a2;
      }
#pragma unroll 4
      for (int r = 0; r < (lane < C::PV_LANES ? 16 : 0); ++r) {
        float vv[4], pr[C::JPL];
        get4<T>(vp + r * DH, vv);
        if constexpr (C::JPL % 4 == 0) {
#pragma unroll
          for (int jj = 0; jj < C::JPL; jj += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pp + r * C::SPW + jj);
            pr[jj] = p4.x; pr[jj + 1] = p4.y; pr[jj + 2] = p4.z; pr[jj + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < C::JPL; ++jj) pr[jj] = pp[r * C::SPW + jj];
        }
#pragma unroll
        for (int jj = 0; jj < C::JPL; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) num[jj][e] = fmaf(pr[jj], vv[e], num[jj][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
    // the warp's state into shared memory: the K ring, once every
    // consumer warp is past its last tile
    consumers_sync<NCW * 32>();
    float* wn = reinterpret_cast<float*>(kring);       // [NCW][GP][DH]
    if (lane_row0<C::MMA>(lane)) {
#pragma unroll
      for (int i2 = 0; i2 < NH; ++i2) {
        wm[warp][lane_head<C::MMA, C::GP>(lane, i2)] = m_w[i2];
        wd[warp][lane_head<C::MMA, C::GP>(lane, i2)] = den_w[i2];
      }
    }
    if (lane < C::PV_LANES) {
#pragma unroll
      for (int jj = 0; jj < C::JPL; ++jj)
        *reinterpret_cast<float4*>(wn + (warp * C::GP + hs * C::JPL + jj) * DH +
                                   dg * 4) =
            make_float4(num[jj][0], num[jj][1], num[jj][2], num[jj][3]);
    }
  }
  __syncthreads();

  // ---- the block's state: [b, c, head] of the scratch
  const size_t st0 = (static_cast<size_t>(b) * G.chunks + c) * G.hq + head0;
  bool empty_row = false;
  if (G.masked && s_nvalid == 0) {      // all of the chunk masked
    bool any = false;
    for (int base = 0; base < G.S && !any; base += THREADS * 4) {
      int local = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = base + e * THREADS + tid;
        if (idx < G.S && __ldg(M + brow + idx) > 0.5f) local = 1;
      }
      any = __syncthreads_or(local) != 0;
    }
    empty_row = !any;
  }
  if (empty_row) {
    // the spec's answer for a row with no valid position: this chunk's
    // tiles each give (-1e30, sum V, rows)
    int rows = 0;
    for (int u = u0; u < u1; ++u) {
      int row0, nrows;
      unit_rows(G, u, row0, nrows);
      rows += nrows;
    }
    for (int dd = tid; dd < DH; dd += THREADS) {
      float sum = 0.f;
      for (int u = u0; u < u1; ++u) {
        int row0, nrows;
        unit_rows(G, u, row0, nrows);
        float part = 0.f;
        for (int r = 0; r < nrows; ++r)
          part += Cvt<T>::to(V[(brow + row0 + r) * (G.hkv * DH) + h * DH + dd]);
        sum += part;
      }
      for (int j = 0; j < G.gc; ++j) pnum[(st0 + j) * DH + dd] = sum;
    }
    if (tid < G.gc) {
      pm[st0 + tid] = NEG_INF;
      pden[st0 + tid] = static_cast<float>(rows);
    }
  } else {
    // the warps' states merged in warp order, a thread per 4 dims of a head
    const float* wn = reinterpret_cast<const float*>(kring);
    for (int p = tid; p < G.gc * (DH / 4); p += THREADS) {
      const int j = p / (DH / 4), d4 = p % (DH / 4);
      float m = NEG_INF, den = 0.f, n[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NCW; ++w) {
        const float m2 = wm[w][j], mn = fmaxf(m, m2);
        const float a1 = expf(m - mn), a2 = expf(m2 - mn);
        const float4 n2 =
            *reinterpret_cast<const float4*>(wn + (w * C::GP + j) * DH + d4 * 4);
        n[0] = n[0] * a1 + n2.x * a2;
        n[1] = n[1] * a1 + n2.y * a2;
        n[2] = n[2] * a1 + n2.z * a2;
        n[3] = n[3] * a1 + n2.w * a2;
        den = den * a1 + wd[w][j] * a2;
        m = mn;
      }
      *reinterpret_cast<float4*>(pnum + (st0 + j) * DH + d4 * 4) =
          make_float4(n[0], n[1], n[2], n[3]);
      if (d4 == 0) {
        pm[st0 + j] = m;
        pden[st0 + j] = den;
      }
    }
  }
}

// The fold as its own launch: block (b, head), a thread per 4 dims.
__global__ void decode_merge(const float* __restrict__ pm,
                             const float* __restrict__ pnum,
                             const float* __restrict__ pden,
                             float* __restrict__ out, float* __restrict__ lse,
                             int hq, int dh, int chunks, float eps) {
  const int b = blockIdx.x, hh = blockIdx.y;
  const size_t o = static_cast<size_t>(b) * hq + hh;
  for (int d4 = threadIdx.x; d4 < dh / 4; d4 += blockDim.x)
    fold4(pm, pnum, pden, static_cast<size_t>(b) * chunks * hq + hh, hq,
          chunks, dh, d4, eps, out + o * dh, lse + o);
}

// The heads a block keeps: the largest divisor of g up to 16
// (kernels/decode_attn/kernel.py group_chunk mirrors this).
int group_chunk(int g) {
  for (int c = 16; c > 1; --c)
    if (g % c == 0) return c;
  return 1;
}

// The [B * S, Hkv * dh] view of a K or V cache, in boxes of 64 rows by
// `box` elements, swizzled in `swz` bytes (0: none).
bool kv_map(CUtensorMap* map, const void* base, bool bf16, int rows,
            int cols, int box, int swz) {
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), TROWS};
  return make_map(map, base, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  2, dims, strides, boxd, swz);
}

template <typename T, int DH, int NT>
int launch_t(const void* K, const void* V, const void* q, const void* M,
             void* pm, void* pnum, void* pden, int B, const Geo& G,
             cudaStream_t stream) {
  using C = Cfg<T, DH, NT>;
  constexpr bool bf16 = C::MMA;
  CUtensorMap tk, tv;
  if (!kv_map(&tk, K, bf16, B * G.S, G.hkv * DH, C::RB / C::ES,
                bf16 ? C::RB : 0) ||
      !kv_map(&tv, V, bf16, B * G.S, G.hkv * DH, DH, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_kernel<T, DH, NT>;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(G.chunks, G.hkv * G.nhc, B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      tk, tv, static_cast<const T*>(V), static_cast<const T*>(q),
      static_cast<const float*>(M), static_cast<float*>(pm),
      static_cast<float*>(pnum), static_cast<float*>(pden), G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dt(int nt, int dh, const void* K, const void* V, const void* q,
              const void* M, void* pm, void* pnum, void* pden, int B,
              const Geo& G, cudaStream_t st) {
#define REPRO_DECODE_CASE(NT_, DH_)                                        \
  if (nt == NT_ && dh == DH_)                                              \
    return launch_t<T, DH_, NT_>(K, V, q, M, pm, pnum, pden, B, G, st);
  REPRO_DECODE_CASE(1, 16) REPRO_DECODE_CASE(1, 32)
  REPRO_DECODE_CASE(1, 48) REPRO_DECODE_CASE(1, 64)
  REPRO_DECODE_CASE(1, 80) REPRO_DECODE_CASE(1, 96)
  REPRO_DECODE_CASE(1, 112) REPRO_DECODE_CASE(1, 128)
  REPRO_DECODE_CASE(2, 16) REPRO_DECODE_CASE(2, 32)
  REPRO_DECODE_CASE(2, 48) REPRO_DECODE_CASE(2, 64)
  REPRO_DECODE_CASE(2, 80) REPRO_DECODE_CASE(2, 96)
  REPRO_DECODE_CASE(2, 112) REPRO_DECODE_CASE(2, 128)
#undef REPRO_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K, V: [B, S, hkv * dh] of `dtype` (f32 or bf16), 16-byte aligned; q:
// [B, hkv * g * dh] of `dtype`, any g >= 1; M: [B, S] f32 validity (NULL
// = unmasked); d segments of S / d rows, in 64-row units u = t * d + k,
// `upb` units a chunk, `chunks` chunks.  pm, pden: [B, chunks, hkv * g]
// f32 and pnum: [B, chunks, hkv * g * dh] f32, each chunk's state.
extern "C" int decode_split_launch(int dtype, int g, int dh, const void* K,
                                   const void* V, const void* q,
                                   const void* M, void* pm, void* pnum,
                                   void* pden, int B, int S, int hkv, int d,
                                   int upb, int chunks, float scale,
                                   float eps, void* stream) {
  if (B <= 0 || S <= 0 || hkv <= 0 || g <= 0 || d <= 0 || upb <= 0 ||
      chunks <= 0 || S % d != 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo G;
  G.S = S;
  G.hkv = hkv;
  G.g = g;
  G.gc = group_chunk(g);
  G.nhc = g / G.gc;
  G.hq = hkv * g;
  G.d = d;
  G.seg = S / d;
  G.nt = (G.seg + TROWS - 1) / TROWS;
  G.units = d * G.nt;
  G.upb = upb;
  G.chunks = chunks;
  G.scale = scale;
  G.eps = eps;
  G.masked = M != nullptr;
  if (static_cast<long long>(chunks - 1) * upb >= G.units ||
      static_cast<long long>(chunks) * upb < G.units ||
      hkv * G.nhc > 65535 || static_cast<long long>(B) * S >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (G.gc + 7) / 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dt<float>(nt, dh, K, V, q, M, pm, pnum, pden, B, G, st);
    case kBF16:
      return launch_dt<__nv_bfloat16>(nt, dh, K, V, q, M, pm, pnum, pden, B,
                                      G, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2: the fold.  out: [B, hq * dh] f32; lse: [B, hq] f32.
extern "C" int decode_merge_launch(const void* pm, const void* pnum,
                                   const void* pden, void* out, void* lse,
                                   int B, int hq, int dh, int chunks,
                                   float eps, void* stream) {
  if (B <= 0 || hq <= 0 || dh <= 0 || chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32;
  decode_merge<<<dim3(B, hq), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pnum),
      static_cast<const float*>(pden), static_cast<float*>(out),
      static_cast<float*>(lse), hq, dh, chunks, eps);
  return static_cast<int>(cudaGetLastError());
}
