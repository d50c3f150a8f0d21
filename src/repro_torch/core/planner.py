"""Traffic signature of a kernel traversal (paper Table 1 columns).

Only the dataclass the spec IR (``codegen.loopir.traffic_of``) and the
decode wrapper describe their traversals with; config ranking arrives
with the planner.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Traffic"]


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Memory signature of a kernel traversal (paper Table 1 columns)."""

    rows: int                  # stride-unrollable extent
    cols: int                  # contiguous-axis extent (elements)
    dtype: object = torch.float32
    read_arrays: int = 1       # load streams per stride (Table 1 "L")
    write_arrays: int = 0      # store streams per stride (Table 1 "S")
    rw_arrays: int = 0         # load/store streams per stride ("L/S")
    resident_bytes: int = 0    # always-resident operands (vectors, weights)

    @property
    def arrays_per_stride(self) -> int:
        return self.read_arrays + self.write_arrays + 2 * self.rw_arrays
