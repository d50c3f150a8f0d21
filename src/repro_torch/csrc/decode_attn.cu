// Multi-strided flash-decode for Hopper (sm_90a).
//
// Replaces the decode_attn instance of the JAX package's K3 template,
// _emit_stream_reduction (src/repro/codegen/emit.py:564), whose body is
// the online-softmax spec of src/repro/kernels/decode_attn/specs.py:
// one query token per batch row against a [B, S, Hkv*dh] K/V cache,
// query heads grouped (hkv, g) so query head h*g + j reads KV head h,
// scores f32(q) . f32(k) / sqrt(dh), rows with M <= 0.5 masked.
//
// What bounds it: bytes.  Each K and V element (2 bytes in bf16) is used
// in 2 * g flops, far below the card's ~295 flops per byte, so the kernel
// is as fast as it streams the cache.  K and V are each read once.
//
// What the design does about it.  On the TPU the kernel carried the
// state (m, num, den) in VMEM scratch across a row grid that runs in
// order.  Hopper blocks run in no order, so the paper's D streams become
// D independent blocks, a split-KV flash-decode in two passes:
//   pass 1 (decode_split), grid (B, Hkv, D): block (b, h, k) walks
//     segment k (rows k*seg ... (k+1)*seg - 1) in bm-row tiles, skipping
//     nothing, and keeps for its G query heads of group h the f32 state
//     (m[G], num[G][dh], den[G]); each tile's partial state — its max,
//     sum of exp(s - max) * V and sum of exp(s - max), exactly the spec
//     body — is folded in with the OnlineSoftmax merge.  The block's
//     state goes to a [B, D, ...] scratch.
//   pass 2 (decode_merge), grid (B, Hq): merges the D states in order
//     k = 0 ... D-1 from the identity (NEG_INF, 0, 0), then finalizes
//     out = num / max(den, eps) and lse = m + log(max(den, eps)).
// A group of g query heads that exceeds what one block keeps in
// registers is split into g / GC chunks of GC heads (GC the largest of
// 8, 4, 3, 2, 1 dividing g): the grid becomes (B, Hkv * g / GC, D), and
// the chunks of one KV head read the same K/V rows, which the blocks of
// neighbouring blockIdx.y run together and so mostly find in L2.
// g in {1, 2, 4, 8} runs as one chunk: one block per KV head.
// Inside a block each of the NW warps takes every NW-th tile (tiles
// longer than TILE rows fold as consecutive TILE-row sub-tiles), and a
// lane owns VPL = dh / 32 consecutive dims of the head (one dim on the
// first dh lanes when dh < 32, the other lanes idle), so a K or V row
// of the head is one coalesced warp load serving all g query heads.  The
// warps' states merge in warp order at the end of the block.  The fold
// order thus differs from the TPU's; the result agrees within f32
// reassociation error.
//
// NEG_INF is the finite -1e30 of the spec, never -inf: a fully masked
// tile has state (-1e30, sum V, rows) and merges away with weight
// exp(-1e30 - m) == 0, where -inf would give exp(-inf - -inf) = NaN.
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 4;      // warps per pass-1 block
constexpr int TILE = 4;    // rows folded per sub-tile (held in registers)

template <typename T, int G, int DH>
__global__ void __launch_bounds__(NW * 32)
decode_split(const T* __restrict__ K, const T* __restrict__ V,
             const T* __restrict__ q, const float* __restrict__ M,
             float* __restrict__ pm, float* __restrict__ pnum,
             float* __restrict__ pden, int S, int hkv, int g, int d,
             int seg, int bm, float scale) {
  constexpr int VPL = DH >= 32 ? DH / 32 : 1;   // dims per lane
  constexpr int LANES = DH / VPL;                // lanes that own dims
  static_assert(LANES * VPL == DH && LANES <= 32, "dh in {16, 32, 64, 128}");
  // G heads of chunk c of KV head h: query heads h*g + c*G ... + G-1
  const int nchunk = g / G;
  const int b = blockIdx.x, h = blockIdx.y / nchunk, k = blockIdx.z;
  const int head0 = h * g + (blockIdx.y % nchunk) * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool owner = lane < LANES;
  const int E = hkv * DH, hq = hkv * g;

  float qr[G][VPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (owner) {
      load_f32<T, VPL>(q + (static_cast<size_t>(b) * hq + head0 + j) * DH + lane * VPL, qr[j]);
    } else {
#pragma unroll
      for (int i = 0; i < VPL; ++i) qr[j][i] = 0.f;
    }
  }

  float m[G], den[G], num[G][VPL];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = NEG_INF;
    den[j] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) num[j][i] = 0.f;
  }

  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(k) * seg;
  const T* kp = K + row0 * E + h * DH + (owner ? lane : 0) * VPL;
  const T* vp = V + row0 * E + h * DH + (owner ? lane : 0) * VPL;
  const float* mp = M ? M + row0 : nullptr;
  const int ntiles = seg / bm;

  for (int t = warp; t < ntiles; t += NW) {
    for (int r0 = t * bm; r0 < (t + 1) * bm; r0 += TILE) {
      const int nr = min(TILE, (t + 1) * bm - r0);
      float kf[TILE][VPL], vf[TILE][VPL];
#pragma unroll
      for (int rr = 0; rr < TILE; ++rr) {
        if (rr < nr && owner) {
          load_f32<T, VPL>(kp + static_cast<size_t>(r0 + rr) * E, kf[rr]);
          load_f32<T, VPL>(vp + static_cast<size_t>(r0 + rr) * E, vf[rr]);
        } else {
#pragma unroll
          for (int i = 0; i < VPL; ++i) kf[rr][i] = vf[rr][i] = 0.f;
        }
      }
      float s[TILE][G];
#pragma unroll
      for (int rr = 0; rr < TILE; ++rr) {
        if (rr < nr) {
          const bool keep = !mp || __ldg(mp + r0 + rr) > 0.5f;
#pragma unroll
          for (int j = 0; j < G; ++j) {
            float p = 0.f;
#pragma unroll
            for (int i = 0; i < VPL; ++i) p += qr[j][i] * kf[rr][i];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              p += __shfl_xor_sync(0xffffffffu, p, off);
            s[rr][j] = keep ? p * scale : NEG_INF;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float mt = s[0][j];
#pragma unroll
        for (int rr = 1; rr < TILE; ++rr)
          if (rr < nr) mt = fmaxf(mt, s[rr][j]);
        float dt = 0.f, nt[VPL];
#pragma unroll
        for (int i = 0; i < VPL; ++i) nt[i] = 0.f;
#pragma unroll
        for (int rr = 0; rr < TILE; ++rr) {
          if (rr < nr) {
            const float wgt = expf(s[rr][j] - mt);
            dt += wgt;
#pragma unroll
            for (int i = 0; i < VPL; ++i) nt[i] += wgt * vf[rr][i];
          }
        }
        const float mn = fmaxf(m[j], mt);
        const float a1 = expf(m[j] - mn), a2 = expf(mt - mn);
#pragma unroll
        for (int i = 0; i < VPL; ++i) num[j][i] = num[j][i] * a1 + nt[i] * a2;
        den[j] = den[j] * a1 + dt * a2;
        m[j] = mn;
      }
    }
  }

  // merge the NW warps' states in warp order, write the block's state
  __shared__ float sm[NW][G], sden[NW][G], snum[NW][G][DH];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) {
      sm[warp][j] = m[j];
      sden[warp][j] = den[j];
    }
    if (owner) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) snum[warp][j][lane * VPL + i] = num[j][i];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < G * DH; p += NW * 32) {
    const int j = p / DH, c = p % DH;
    float mm = sm[0][j], dd = sden[0][j], nn = snum[0][j][c];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float mn = fmaxf(mm, sm[w][j]);
      const float a1 = expf(mm - mn), a2 = expf(sm[w][j] - mn);
      nn = nn * a1 + snum[w][j][c] * a2;
      dd = dd * a1 + sden[w][j] * a2;
      mm = mn;
    }
    const size_t st = (static_cast<size_t>(b) * d + k) * hq + head0 + j;
    pnum[st * DH + c] = nn;
    if (c == 0) {
      pm[st] = mm;
      pden[st] = dd;
    }
  }
}

__global__ void decode_merge(const float* __restrict__ pm,
                             const float* __restrict__ pnum,
                             const float* __restrict__ pden,
                             float* __restrict__ out, float* __restrict__ lse,
                             int hq, int dh, int d, float eps) {
  const int b = blockIdx.x, hh = blockIdx.y;
  for (int c = threadIdx.x; c < dh; c += blockDim.x) {
    float m = NEG_INF, n = 0.f, den = 0.f;
    for (int k = 0; k < d; ++k) {
      const size_t st = (static_cast<size_t>(b) * d + k) * hq + hh;
      const float m2 = pm[st];
      const float mn = fmaxf(m, m2);
      const float a1 = expf(m - mn), a2 = expf(m2 - mn);
      n = n * a1 + pnum[st * dh + c] * a2;
      den = den * a1 + pden[st] * a2;
      m = mn;
    }
    den = fmaxf(den, eps);
    out[(static_cast<size_t>(b) * hq + hh) * dh + c] = n / den;
    if (c == 0) lse[static_cast<size_t>(b) * hq + hh] = m + logf(den);
  }
}

template <typename T, int G, int DH>
int split_t(int g, const void* K, const void* V, const void* q,
            const void* M, void* pm, void* pnum, void* pden, int B, int S,
            int hkv, int d, int bm, float scale, cudaStream_t stream) {
  const dim3 grid(B, hkv * (g / G), d);
  decode_split<T, G, DH><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(K), static_cast<const T*>(V),
      static_cast<const T*>(q), static_cast<const float*>(M),
      static_cast<float*>(pm), static_cast<float*>(pnum),
      static_cast<float*>(pden), S, hkv, g, d, S / d, bm, scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_SPLIT_CASE(G_, DH_)                                         \
  case G_ * 1024 + DH_:                                                   \
    return split_t<T, G_, DH_>(g, K, V, q, M, pm, pnum, pden, B, S, hkv,  \
                               d, bm, scale, stream);
#define REPRO_SPLIT_DHS(G_)                                               \
  REPRO_SPLIT_CASE(G_, 16) REPRO_SPLIT_CASE(G_, 32)                       \
  REPRO_SPLIT_CASE(G_, 64) REPRO_SPLIT_CASE(G_, 128)

// The heads per block: the largest of 8, 4, 3, 2, 1 that divides g.
int group_chunk(int g) {
  const int chunks[] = {8, 4, 3, 2};
  for (const int c : chunks)
    if (g % c == 0) return c;
  return 1;
}

template <typename T>
int split_dt(int g, int dh, const void* K, const void* V, const void* q,
             const void* M, void* pm, void* pnum, void* pden, int B, int S,
             int hkv, int d, int bm, float scale, cudaStream_t stream) {
  switch (group_chunk(g) * 1024 + dh) {
    REPRO_SPLIT_DHS(1) REPRO_SPLIT_DHS(2) REPRO_SPLIT_DHS(3)
    REPRO_SPLIT_DHS(4) REPRO_SPLIT_DHS(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Pass 1.  K, V: [B, S, hkv * dh] of `dtype`; q: [B, hkv * g * dh], any
// g >= 1 (in chunks of group_chunk(g) heads per block);
// M: [B, S] f32 validity (NULL = unmasked); pm, pden: [B, d, hkv * g] f32;
// pnum: [B, d, hkv * g * dh] f32.  d streams of S / d rows, bm-row tiles.
extern "C" int decode_split_launch(int dtype, int g, int dh, const void* K,
                                   const void* V, const void* q,
                                   const void* M, void* pm, void* pnum,
                                   void* pden, int B, int S, int hkv, int d,
                                   int bm, float scale, void* stream) {
  if (B <= 0 || S <= 0 || hkv <= 0 || g <= 0 || d <= 0 || bm <= 0 ||
      S % d != 0 || (S / d) % bm != 0 || hkv * (g / group_chunk(g)) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return split_dt<float>(g, dh, K, V, q, M, pm, pnum, pden, B, S, hkv,
                             d, bm, scale, st);
    case kBF16:
      return split_dt<__nv_bfloat16>(g, dh, K, V, q, M, pm, pnum, pden, B,
                                     S, hkv, d, bm, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2.  out: [B, hq * dh] f32; lse: [B, hq] f32.
extern "C" int decode_merge_launch(const void* pm, const void* pnum,
                                   const void* pden, void* out, void* lse,
                                   int B, int hq, int dh, int d, float eps,
                                   void* stream) {
  if (B <= 0 || hq <= 0 || dh <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = dh < 256 ? (dh + 31) / 32 * 32 : 256;
  decode_merge<<<dim3(B, hq), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pnum),
      static_cast<const float*>(pden), static_cast<float*>(out),
      static_cast<float*>(lse), hq, dh, d, eps);
  return static_cast<int>(cudaGetLastError());
}
