"""Target hardware constants: one NVIDIA H100 SXM (Hopper, ``sm_90a``).

The one home of the card's numbers: ``chip_smoke.py``'s bounds (bytes
over ``hbm_bw``, operations over ``peak_flops`` of the operands' type),
the planner's budget (``block_smem``), the K4 ring's shared-memory
plan (``kernels/manual.py``), attention's score budget (``hbm_bytes``)
and the roofline terms (``roofline/analysis.py``) read them from
here."""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["HwSpec", "H100_HW"]


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    hbm_bw: float                   # bytes/s of device memory
    peak_flops: Mapping[str, float]  # dense FLOP/s by operand dtype name
    hbm_bytes: int                  # device memory
    l2_bytes: int
    sms: int
    sm_smem: int                    # shared memory of one SM
    block_smem: int                 # the most one block may opt into


H100_HW = HwSpec(
    name="h100-sxm",
    hbm_bw=3.35e12,
    # f32 outside the tensor cores; bf16 and f16 on the tensor cores
    # (products exact in their f32 sums)
    peak_flops={"float32": 67e12, "bfloat16": 989e12, "float16": 989e12},
    hbm_bytes=80 * 10 ** 9,
    l2_bytes=50 * 2 ** 20,
    sms=132,
    sm_smem=233472,
    block_smem=232448,
)
