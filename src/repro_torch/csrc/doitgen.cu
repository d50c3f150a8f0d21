// Multi-strided doitgen for Hopper (sm_90a): a batched contraction with a
// resident operand (an instance of K1 with a batch axis and a free axis).
//
// Replaces the doitgen instance of the JAX package's K1 template,
// _emit_streaming (src/repro/codegen/emit.py:410), whose body is
// src/repro/kernels/doitgen/specs.py:
//   o[b, q, p] = sum over s of f32(A[b, q, s]) * f32(C4[s, p])
// over A [r, rows, s], C4 [s, p] -> o [r, rows, p], summed in f32 and
// rounded once to T at the store.  Against the plain version (an f32
// product, summed in its own order) it agrees within the f32
// dot-product limit of s terms.
//
// What bounds it.  Each output takes 2 s operations; A is read once, C4
// (at most 256 KiB) stays in L2, o is written once.  In bf16 and f16 the
// tensor cores make it bytes-bound (at s = p = 256, 256 operations a
// byte of A and o against the card's 295).  In f32 it runs outside the
// tensor cores (TF32 would round the operands): 64 operations a byte
// against the card's 20, so operations bound it.
//
// What the design does about it.  The TPU kernel's grid is (batch r, row
// block); each step loads the D stream blocks A[r, i + k*seg, :] at whole
// width (s is a free axis) and contracts them on the MXU against the
// resident C4.  Here block (b, run, p tile), with the p tile fastest in
// the grid so the blocks that share an A tile run together, owns batch
// element b, the d * rb rows k * seg + run * rb + t of every stream
// (kernels/doitgen/kernel.py geometry picks rb and the tile: 64 or 128
// rows, the larger only where its grid still keeps 15/16 of the SMs
// busy) and a tile of p (as wide as the tile in f32, 64 columns in bf16
// and f16).  A table in shared memory holds the
// row of each of a pass's rows.  The block walks s in chunks through a
// ring of chunks in shared memory: each chunk's copies (every stream's
// rows of A, then C4's rows) are all issued by cp.async before the ring
// waits on the oldest, so the ring's other chunks are in flight while
// one is multiplied.  Elements past s, p or the block's rows are
// zero-filled.
//
//   bf16, f16: mma.sync m16n8k16 on the tensor cores, f32 accumulators
//     (a product of two 16-bit values is exact in f32), a 4-chunk ring
//     of 32 columns of s.  8 warps as 4 x 2, each a (tile/4) x 32 piece
//     of the output, at most 32 accumulators a thread (a 128 x 128 tile
//     needs 64 and spills at the 128 registers that keep two blocks an
//     SM); fragments by ldmatrix (A row-major
//     [rows][s], C4 row-major [s][p] by ldmatrix.trans), each shared row
//     padded by 16 bytes so the eight rows of a matrix fall in eight
//     distinct bank groups.  The output tile, rounded to T, goes back
//     through the ring's shared memory and leaves in 16-byte row pieces
//     (a fragment's direct stores would fill each sector by halves).
//   f32: fused multiply-adds in s order, a 3-chunk ring.  A is stored
//     transposed ([s][rows + 4], by 4-byte cp.async) so a thread reads
//     its rows as float4, as it reads C4's columns: 256 threads as
//     16 x 16, each (tile/16) x (tile/16) outputs (8 x 8 at tile 128,
//     chunks of 8 columns of s; 4 x 4 at tile 64, chunks of 16), 2 + 2
//     float4 reads for 64 fused multiply-adds.
//
// Two instances of each: VEC copies 16 bytes at a time (s and p whole
// 16-byte groups of elements, A, C4 and o 16-byte aligned) and keeps two
// blocks an SM; the staging instance copies element by element (4-byte
// cp.async in f32, loads and shared stores in 16-bit types), takes any
// s, p and alignment, and runs one block an SM (its copy addresses take
// the registers).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// The host's view of a launch: rows (of a batch element), s, p, d streams
// of seg = rows / d rows, rb rows of each a block, runs = seg / rb row
// runs, tiles = p tiles.
struct Geo {
  int rows, s, p, d, rb, runs, tiles;
};

// Where a block sits: batch element b, row run `run`, p columns p0 ...
struct Place {
  int b, run, p0, seg, rb, nrows;
  // g-th row of the block: stream g / rb, row g % rb of the run
  __device__ __forceinline__ int row_of(int g) const {
    return (g / rb) * seg + run * rb + g % rb;
  }
};

__device__ __forceinline__ Place place_of(const Geo& g, int bn) {
  const int tile = blockIdx.x % g.tiles, rest = blockIdx.x / g.tiles;
  Place pl;
  pl.b = rest / g.runs;
  pl.run = rest % g.runs;
  pl.p0 = tile * bn;
  pl.seg = g.rows / g.d;
  pl.rb = g.rb;
  pl.nrows = g.d * g.rb;
  return pl;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// cp.async of 16 or 4 bytes to a shared address (or a generic pointer
// into shared memory); n = 0 reads nothing and writes zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  cp16(smem_u32(dst), src, n);
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from shared address `addr` (each lane gives
// one row's address), as mma fragments; .trans transposes each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b for one m16n8k16 tile, f32 accumulators
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  // two f32 rounded to bf16, the first in the low half
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};
template <> struct Mma<__half> {
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
};

// ---------------------------------------------------------------- bf16, f16

constexpr int MMA_BK = 32;          // s chunk
constexpr int MMA_STAGES = 4;       // 38 KB at tile 64, 58 KB at tile 128
constexpr int MMA_BN = 64;          // p columns of a block

template <int BM>
constexpr int mma_smem_bytes() {
  return MMA_STAGES * (BM * (MMA_BK + 8) + MMA_BK * (MMA_BN + 8)) * 2;
}

template <typename T, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS, VEC ? 2 : 1)
doitgen_mma(const T* __restrict__ A, const T* __restrict__ C4,
            T* __restrict__ o, Geo geo) {
  constexpr int BN = MMA_BN, BK = MMA_BK, STAGES = MMA_STAGES;
  constexpr int AP = BK + 8, BP = BN + 8;        // padded pitches (elements)
  constexpr int STAGE = BM * AP + BK * BP;       // elements a stage
  constexpr int WC = 2, WR = 4;                  // warps across, down
  constexpr int WM = BM / WR, WN = BN / WC;      // a warp's piece
  constexpr int MT = WM / 16, NT = WN / 8;       // its m16 and n8 tiles
  constexpr int AV = BM * (BK / 8) / THREADS;    // 16-byte A copies a thread
  constexpr int BV = BK * (BN / 8) / THREADS;    // 16-byte C4 copies
  constexpr int AE = BM * BK / THREADS;          // elements (staging)
  constexpr int BE = BK * BN / THREADS;
  static_assert(AV >= 1 && BV >= 1 && NT % 2 == 0 && AE % 8 == 0 &&
                    BE % 8 == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sm = reinterpret_cast<uint16_t*>(smem_raw);
  const uint32_t sbase = smem_u32(smem_raw);     // 32-bit shared addresses
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WC, wc = warp % WC;
  const Place pl = place_of(geo, BN);
  const int s = geo.s, p = geo.p;
  const uint16_t* Ab = reinterpret_cast<const uint16_t*>(A) +
                       static_cast<size_t>(pl.b) * geo.rows * s;
  const uint16_t* Cu = reinterpret_cast<const uint16_t*>(C4);
  T* ob = o + static_cast<size_t>(pl.b) * geo.rows * p;
  const int nk = (s + BK - 1) / BK;

  // each row of the pass: its row and its A offset (-1: past the block)
  __shared__ int rowidx[BM], rowoff[BM];
  for (int g0 = 0; g0 < pl.nrows; g0 += BM) {
    for (int i = tid; i < BM; i += THREADS) {
      rowidx[i] = g0 + i < pl.nrows ? pl.row_of(g0 + i) : -1;
      rowoff[i] = rowidx[i] < 0 ? -1 : rowidx[i] * s;
    }
    __syncthreads();
    // one chunk's copies into stage st: every stream's rows, then C4's
    auto load = [&](int st, int s0) {
      if constexpr (VEC) {
        const uint32_t as = sbase + st * STAGE * 2, bs = as + BM * AP * 2;
#pragma unroll
        for (int i = 0; i < AV; ++i) {
          const int c = tid + i * THREADS, row = c / (BK / 8);
          const int kc = (c % (BK / 8)) * 8, off = rowoff[row];
          const bool ok = off >= 0 && s0 + kc < s;
          cp16(as + (row * AP + kc) * 2, ok ? Ab + off + s0 + kc : Ab,
               ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < BV; ++i) {
          const int c = tid + i * THREADS, k = c / (BN / 8);
          const int nc = (c % (BN / 8)) * 8;
          const bool ok = s0 + k < s && pl.p0 + nc < p;
          cp16(bs + (k * BP + nc) * 2,
               ok ? Cu + static_cast<size_t>(s0 + k) * p + pl.p0 + nc : Cu,
               ok ? 16 : 0);
        }
      } else {
        uint16_t* As = sm + st * STAGE;
        uint16_t* Bs = As + BM * AP;
        // element by element through registers, GROUP loads in flight
        constexpr int GROUP = 8;
        const int k = tid % BK;
#pragma unroll 1
        for (int i0 = 0; i0 < AE; i0 += GROUP) {
          uint16_t v[GROUP];
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const int off = rowoff[tid / BK + (i0 + i) * (THREADS / BK)];
            v[i] = (off >= 0 && s0 + k < s) ? __ldg(Ab + off + s0 + k)
                                            : uint16_t(0);
          }
#pragma unroll
          for (int i = 0; i < GROUP; ++i)
            As[(tid / BK + (i0 + i) * (THREADS / BK)) * AP + k] = v[i];
        }
#pragma unroll 1
        for (int i0 = 0; i0 < BE; i0 += GROUP) {
          uint16_t v[GROUP];
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const int e = tid + (i0 + i) * THREADS, kk = e / BN, n = e % BN;
            v[i] = (s0 + kk < s && pl.p0 + n < p)
                       ? __ldg(Cu + static_cast<size_t>(s0 + kk) * p + pl.p0 + n)
                       : uint16_t(0);
          }
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            const int e = tid + (i0 + i) * THREADS;
            Bs[(e / BN) * BP + e % BN] = v[i];
          }
        }
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st, st * BK);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();          // chunk kt has landed
      __syncthreads();                // ... for every thread; slot of kt-1 free
      const int nx = kt + STAGES - 1;
      if (nx < nk) load(nx % STAGES, nx * BK);
      cp_commit();
      // this lane's row addresses in the stage of chunk kt
      const uint32_t a_addr =
          sbase + ((kt % STAGES) * STAGE + (wr * WM + (lane & 15)) * AP +
                   (lane >> 4) * 8) * 2;
      const uint32_t b_addr =
          sbase + ((kt % STAGES) * STAGE + BM * AP +
                   ((lane & 7) + ((lane >> 3) & 1) * 8) * BP + wc * WN +
                   (lane >> 4) * 8) * 2;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(af[mt], a_addr + (mt * 16 * AP + kk) * 2);
        // C4 fragments two n8 tiles at a time, each used as it arrives
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t t4[4];
          ldsm_x4_trans(t4, b_addr + (kk * BP + np * 16) * 2);
          const uint32_t b0[2] = {t4[0], t4[1]}, b1[2] = {t4[2], t4[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            Mma<T>::run(acc[mt][2 * np], af[mt], b0);
            Mma<T>::run(acc[mt][2 * np + 1], af[mt], b1);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();                  // the ring is free

    // the output tile, rounded to T, through the ring's shared memory so
    // that it leaves in 16-byte row pieces: a warp's fragments cover 8
    // rows x 8 bytes each, whose direct stores would each fill a sector
    // by halves
    constexpr int OP = BN + 8;        // padded pitch: fragment writes
    uint16_t* Os = sm;                // fall in 32 distinct banks
    static_assert(BM * OP <= STAGES * STAGE, "output tile fits the ring");
    uint32_t* frag = reinterpret_cast<uint32_t*>(
        Os + (wr * WM + (lane >> 2)) * OP + wc * WN + (lane & 3) * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          frag[((mt * 16 + h * 8) * OP + nt * 8) / 2] =
              Mma<T>::pack(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    __syncthreads();
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < BM * BN / 8 / THREADS; ++i) {
        const int c = tid + i * THREADS, row = c / (BN / 8);
        const int col = (c % (BN / 8)) * 8, ri = rowidx[row];
        if (ri >= 0 && pl.p0 + col < p)
          *reinterpret_cast<uint4*>(ob + static_cast<size_t>(ri) * p +
                                    pl.p0 + col) =
              *reinterpret_cast<const uint4*>(Os + row * OP + col);
      }
    } else {
      const uint16_t* Ou = Os;
      uint16_t* obu = reinterpret_cast<uint16_t*>(ob);
#pragma unroll 4
      for (int i = 0; i < BM * BN / THREADS; ++i) {
        const int e = tid + i * THREADS, row = e / BN, col = e % BN;
        const int ri = rowidx[row];
        if (ri >= 0 && pl.p0 + col < p)
          obu[static_cast<size_t>(ri) * p + pl.p0 + col] = Ou[row * OP + col];
      }
    }
    __syncthreads();                  // the ring is free for the next pass
  }
}

// ---------------------------------------------------------------------- f32

// s chunk: 16 at 4 x 4 outputs a thread, 8 at 8 x 8 (fewer copy
// addresses live beside the 64 accumulators: no spill at 128 registers)
template <int TM>
__host__ __device__ constexpr int f32_bk() {
  return TM > 4 ? 8 : 16;
}
constexpr int F32_STAGES = 3;

template <int TM>
constexpr int f32_smem_bytes() {
  return F32_STAGES * f32_bk<TM>() * ((16 * TM + 4) + 16 * TM) * 4;
}

template <int TM, bool VEC>
__global__ void __launch_bounds__(THREADS, VEC ? 2 : 1)
doitgen_f32(const float* __restrict__ A, const float* __restrict__ C4,
            float* __restrict__ o, Geo geo) {
  constexpr int TN = TM, BM = 16 * TM, BN = 16 * TN;
  constexpr int BK = f32_bk<TM>(), STAGES = F32_STAGES;
  constexpr int AP = BM + 4;                     // As[BK][AP]: A transposed
  constexpr int STAGE = BK * AP + BK * BN;
  constexpr int AE = BM * BK / THREADS;          // 4-byte A copies a thread
  constexpr int BV = BK * (BN / 4) / THREADS;    // 16-byte C4 copies
  constexpr int BE = BK * BN / THREADS;          // 4-byte C4 copies (staging)
  constexpr int HM = TM > 4 ? BM / 2 : 0, HN = TN > 4 ? BN / 2 : 0;
  static_assert(TM == 4 || TM == 8, "4 x 4 or 8 x 8 outputs a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Place pl = place_of(geo, BN);
  const int s = geo.s, p = geo.p;
  const float* Ab = A + static_cast<size_t>(pl.b) * geo.rows * s;
  float* ob = o + static_cast<size_t>(pl.b) * geo.rows * p;
  const int nk = (s + BK - 1) / BK;

  __shared__ int rowidx[BM];          // row of each row of the pass (-1: none)
  for (int g0 = 0; g0 < pl.nrows; g0 += BM) {
    for (int i = tid; i < BM; i += THREADS)
      rowidx[i] = g0 + i < pl.nrows ? pl.row_of(g0 + i) : -1;
    __syncthreads();
    // a thread copies column tid % BK of s for rows tid / BK + i * (256 / BK)
    auto load = [&](int st, int s0) {
      float* As = sm + st * STAGE;
      float* Bs = As + BK * AP;
      const int k = tid % BK;
#pragma unroll
      for (int i = 0; i < AE; ++i) {
        const int row = tid / BK + i * (THREADS / BK), ri = rowidx[row];
        const bool ok = ri >= 0 && s0 + k < s;
        cp4(As + k * AP + row, ok ? Ab + ri * s + s0 + k : Ab, ok ? 4 : 0);
      }
      if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < BV; ++i) {
          const int c = tid + i * THREADS, kk = c / (BN / 4);
          const int nc = (c % (BN / 4)) * 4;
          const bool ok = s0 + kk < s && pl.p0 + nc < p;
          cp16(Bs + kk * BN + nc,
               ok ? C4 + static_cast<size_t>(s0 + kk) * p + pl.p0 + nc : C4,
               ok ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BE; ++i) {
          const int e = tid + i * THREADS, kk = e / BN, n = e % BN;
          const bool ok = s0 + kk < s && pl.p0 + n < p;
          cp4(Bs + kk * BN + n,
              ok ? C4 + static_cast<size_t>(s0 + kk) * p + pl.p0 + n : C4,
              ok ? 4 : 0);
        }
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk) load(st, st * BK);
      cp_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      const int nx = kt + STAGES - 1;
      if (nx < nk) load(nx % STAGES, nx * BK);
      cp_commit();
      const float* As = sm + (kt % STAGES) * STAGE;
      const float* Bs = As + BK * AP;
#pragma unroll
      for (int k = 0; k < BK; ++k) {     // zero-filled past s: adds 0
        float a[TM], b[TN];
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * AP + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BN + tx * 4);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        if constexpr (TM > 4) {
          const float4 a1 =
              *reinterpret_cast<const float4*>(As + k * AP + HM + ty * 4);
          const float4 b1 =
              *reinterpret_cast<const float4*>(Bs + k * BN + HN + tx * 4);
          a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
          b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    cp_wait<0>();
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ri = rowidx[(i < 4 ? 0 : HM) + ty * 4 + (i & 3)];
      if (ri < 0) continue;
      float* orow = ob + static_cast<size_t>(ri) * p;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int col = pl.p0 + h * HN + tx * 4;
        if constexpr (VEC) {
          if (col < p)
            *reinterpret_cast<float4*>(orow + col) =
                make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                            acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < p) orow[col + j] = acc[i][h * 4 + j];
        }
      }
    }
    __syncthreads();                  // rowidx is free for the next pass
  }
}

// ------------------------------------------------------------------ launch

// Each instance opts into its dynamic shared memory (above 48 KB at tile
// 128) once, at its first launch.
template <typename T, int BM, bool VEC>
int launch_mma(const void* A, const void* C4, void* o, int blocks,
               const Geo& geo, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = doitgen_mma<T, BM, VEC>;
  constexpr int smem = mma_smem_bytes<BM>();
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(static_cast<const T*>(A),
                                            static_cast<const T*>(C4),
                                            static_cast<T*>(o), geo);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, bool VEC>
int launch_f32(const void* A, const void* C4, void* o, int blocks,
               const Geo& geo, cudaStream_t stream) {
  static bool opted = false;
  auto* kernel = doitgen_f32<TM, VEC>;
  constexpr int smem = f32_smem_bytes<TM>();
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(static_cast<const float*>(A),
                                            static_cast<const float*>(C4),
                                            static_cast<float*>(o), geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, const void* C4, void* o, int r, int rows, int s,
           int p, int d, int rb, int tile, int vec, int blocks,
           cudaStream_t stream) {
  constexpr int per16 = 16 / static_cast<int>(sizeof(T));   // elements in 16 B
  if (r <= 0 || rows <= 0 || s <= 0 || p <= 0 || d <= 0 || rb <= 0 ||
      rows % d != 0 || (rows / d) % rb != 0 || (tile != 64 && tile != 128) ||
      static_cast<long long>(rows) * s > 2147483647LL ||
      static_cast<long long>(rows) * p > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  // p columns of a block: the tile in f32, 64 in bf16 and f16
  const int bn = sizeof(T) == 4 ? tile : MMA_BN;
  const int runs = rows / d / rb, tiles = (p + bn - 1) / bn;
  if (static_cast<long long>(r) * runs * tiles != blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (s % per16 != 0 || p % per16 != 0 ||
              reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(C4) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(o) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo geo{rows, s, p, d, rb, runs, tiles};
  if constexpr (sizeof(T) == 4) {
    if (tile == 128)
      return vec ? launch_f32<8, true>(A, C4, o, blocks, geo, stream)
                 : launch_f32<8, false>(A, C4, o, blocks, geo, stream);
    return vec ? launch_f32<4, true>(A, C4, o, blocks, geo, stream)
               : launch_f32<4, false>(A, C4, o, blocks, geo, stream);
  } else {
    if (tile == 128)
      return vec ? launch_mma<T, 128, true>(A, C4, o, blocks, geo, stream)
                 : launch_mma<T, 128, false>(A, C4, o, blocks, geo, stream);
    return vec ? launch_mma<T, 64, true>(A, C4, o, blocks, geo, stream)
               : launch_mma<T, 64, false>(A, C4, o, blocks, geo, stream);
  }
}

}  // namespace

// A: [r, rows, s] of `dtype`, C4: [s, p], o: [r, rows, p], all row-major.
// d streams of seg = rows / d rows, rb rows of each per block (rb divides
// seg); tile 64 or 128 (rows a pass and p columns of a block); vec 1 for
// the 16-byte instance (s, p whole 16-byte groups, A, C4, o 16-byte
// aligned), 0 for the element-wise one (any s, p, alignment); blocks =
// r * (seg / rb) * ceil(p / tile), the grid the caller computed.
extern "C" int doitgen_launch(int dtype, const void* A, const void* C4,
                              void* o, int r, int rows, int s, int p, int d,
                              int rb, int tile, int vec, int blocks,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(A, C4, o, r, rows, s, p, d, rb, tile, vec, blocks, st);
    case kBF16:
      return launch<__nv_bfloat16>(A, C4, o, r, rows, s, p, d, rb, tile, vec,
                                   blocks, st);
    case kF16:
      return launch<__half>(A, C4, o, r, rows, s, p, d, rb, tile, vec, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
