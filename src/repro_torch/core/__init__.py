"""Core multi-striding vocabulary: striding configs, the §5.1
critical-access transform, the traffic signature and the planner that
ranks configs for it with the card's stream model."""
from repro_torch.core.planner import (Plan, Traffic, plan, rank_configs,
                                      traffic_bytes)
from repro_torch.core.striding import (SINGLE_STRIDED, StridingConfig,
                                       choose_block, divisors,
                                       factorizations, pad_to_multiple,
                                       partition_rows, stream_offsets,
                                       stream_spacing_bytes,
                                       valid_stride_unrolls)
from repro_torch.core.transform import (ArrayAccess, LoopNest,
                                        TransformPlan, plan_transform)

__all__ = [
    "StridingConfig", "SINGLE_STRIDED", "choose_block", "divisors",
    "factorizations", "pad_to_multiple", "partition_rows",
    "stream_offsets", "stream_spacing_bytes", "valid_stride_unrolls",
    "Traffic", "Plan", "plan",
    "rank_configs", "traffic_bytes",
    "ArrayAccess", "LoopNest", "TransformPlan", "plan_transform",
]
