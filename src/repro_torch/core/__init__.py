"""Core multi-striding vocabulary: striding configs, the §5.1
critical-access transform, the traffic signature and the planner that
ranks configs for it with the card's stream model."""
from repro_torch.core.planner import (Plan, Traffic, plan, rank_configs,
                                      traffic_bytes)
from repro_torch.core.striding import (SINGLE_STRIDED, StridingConfig,
                                       choose_block, pad_to_multiple,
                                       stream_offsets)
from repro_torch.core.transform import (ArrayAccess, LoopNest,
                                        TransformPlan, plan_transform)

__all__ = [
    "StridingConfig", "SINGLE_STRIDED", "choose_block",
    "pad_to_multiple", "stream_offsets", "Traffic", "Plan", "plan",
    "rank_configs", "traffic_bytes",
    "ArrayAccess", "LoopNest", "TransformPlan", "plan_transform",
]
