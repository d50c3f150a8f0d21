"""Core multi-striding vocabulary: striding configs, the §5.1
critical-access transform, and the traffic signature."""
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import (SINGLE_STRIDED, StridingConfig,
                                       choose_block, pad_to_multiple,
                                       stream_offsets)
from repro_torch.core.transform import (ArrayAccess, LoopNest,
                                        TransformPlan, plan_transform)

__all__ = [
    "StridingConfig", "SINGLE_STRIDED", "choose_block",
    "pad_to_multiple", "stream_offsets", "Traffic",
    "ArrayAccess", "LoopNest", "TransformPlan", "plan_transform",
]
