"""Target hardware constants: one NVIDIA H100 SXM (Hopper, ``sm_90a``).

The one home of the card's numbers: ``chip_smoke.py``'s bounds (bytes
over ``hbm_bw``, operations over ``peak_flops`` of the operands' type),
the planner's budget (``block_smem``), the K4 ring's shared-memory
plan (``kernels/manual.py``), attention's score budget (``hbm_bytes``)
and the roofline terms (``roofline/analysis.py``: ``link_bw`` for the
collective term) read them from here."""
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
    link_bw: float                  # bytes/s a rank: NCCL's bus bandwidth


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
    # NCCL all_gather_into_tensor (bf16) and reduce_scatter_tensor (f32)
    # of 256 MiB over four H100s of one host (NVLink), bus bandwidth
    # 295.24 and 294.80 GB/s; their mean (tools/torch_sharded_train.py,
    # four NVIDIA H100 80GB HBM3 at 700.00 W).
    link_bw=295.02e9,
)
