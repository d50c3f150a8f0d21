// The fused AdamW body (the adamw_update spec, src/repro/kernels/adamw/
// specs.py) for one element, shared by the K1 kernel (adamw.cu) and the
// K4 ring's adamw body (manual_ring.cu).
//
// The seven scalars (lr, b1, b2, eps, wd, bc1, bc2) come from an f32 [7]
// tensor on the card, which load() reads once at the start of a block: the optimizer computes lr and the bias corrections on the card
// every step, so no host copy is needed to launch.  1 - b1 and 1 - b2 are
// f32 subtractions, as the spec's f32 scalars give them.
//
// Each operation is rounded as the body rounds it (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn: no contraction into fused
// multiply-adds, no approximate division or square root), so the result
// equals the plain version's (eager PyTorch, one rounding per operation)
// bit for bit.
#pragma once

#include "common.cuh"

struct AdamWBody {
  float lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2;

  __device__ __forceinline__ void load(const float* __restrict__ s) {
    lr = __ldg(s); b1 = __ldg(s + 1); b2 = __ldg(s + 2); eps = __ldg(s + 3);
    wd = __ldg(s + 4); bc1 = __ldg(s + 5); bc2 = __ldg(s + 6);
    omb1 = __fsub_rn(1.0f, b1);
    omb2 = __fsub_rn(1.0f, b2);
  }

  // One element of the body, in its order; p and g already widened.
  __device__ __forceinline__ void apply(float p, float g, float m, float v,
                                        float& po, float& mo,
                                        float& vo) const {
    mo = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(omb1, g));
    vo = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, bc2)), eps);
    const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(mo, bc1), den),
                              __fmul_rn(wd, p));
    po = __fsub_rn(p, __fmul_rn(lr, u));
  }
};
