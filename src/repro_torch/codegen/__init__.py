"""``repro_torch.codegen`` — loop-nest IR + multi-striding transform
pipeline, with hand-written CUDA kernels in place of Pallas lowerings.

  spec (``loopir.TraversalSpec``)   what to compute
    → blocks (``transforms``)       D streams × bm rows × bn lanes
    → kernel (``emit``)             the hand-written Hopper kernel
                                    registered for the spec, or the
                                    plain PyTorch version (``evaluate``)
"""
from repro_torch.codegen.combine import (MAX, NEG_INF, SUM, Combine,
                                         MaxCombine, OnlineSoftmax,
                                         SumCombine, resolve_combine)
from repro_torch.codegen.emit import (HAND_KERNELS, block_1d, emit_spec,
                                      make_kernel_op, run_spec, template_of)
from repro_torch.codegen.loopir import (Access, Axis, NestInfo,
                                        TraversalSpec, classify, evaluate,
                                        tap, traffic_of)
from repro_torch.codegen.transforms import (BlockPlan, LoopAxis, Schedule,
                                            default_schedule, interchange,
                                            iteration_domain, multi_stride,
                                            plan_blocks, preserves_domain,
                                            schedule, stride_split, unroll,
                                            vector_block)

__all__ = [
    "Axis", "Access", "TraversalSpec", "NestInfo", "tap",
    "classify", "traffic_of", "evaluate",
    "Combine", "SumCombine", "MaxCombine", "OnlineSoftmax", "SUM", "MAX",
    "NEG_INF", "resolve_combine",
    "LoopAxis", "Schedule", "BlockPlan", "schedule", "interchange",
    "unroll", "stride_split", "vector_block", "multi_stride",
    "plan_blocks", "default_schedule", "iteration_domain",
    "preserves_domain",
    "HAND_KERNELS", "template_of", "block_1d", "emit_spec", "run_spec",
    "make_kernel_op",
]
