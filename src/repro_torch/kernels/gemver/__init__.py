"""gemver kernels: four steps + the reassembled whole (paper §6.4):
specs, ops, oracles and the K1-instance CUDA kernels of the
elementwise steps."""
from repro_torch.kernels.gemver.ops import (gemver, gemver_mxv1,
                                            gemver_mxv2, gemver_outer,
                                            gemver_sum)

__all__ = ["gemver", "gemver_outer", "gemver_sum", "gemver_mxv1",
           "gemver_mxv2"]
