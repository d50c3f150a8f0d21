"""Paper §5.1 preparatory transformation, symbolically.

Given a loop nest described as a set of array accesses (array name, rank,
index-variable tuple), pick the *critical memory access*, the contiguous
data axis, and the loop transformations (interchange / blocking) needed
before stride-unrolling — exactly the paper's recipe:

  "The critical memory access is found by selecting the datastructure with
   the highest dimensionality, for which holds that the last indexing
   variable used in this access appears exclusively as the last dimension
   in every array indexed with that variable."

``codegen.loopir.classify`` bridges every ``TraversalSpec`` to these
dataclasses; the transform output fixes the stride and vector axes the
kernels' D-stream geometry is built on.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ArrayAccess", "LoopNest", "TransformPlan", "plan_transform"]


@dataclasses.dataclass(frozen=True)
class ArrayAccess:
    array: str
    index: tuple[str, ...]  # index variables, outermost dim first

    @property
    def rank(self) -> int:
        return len(self.index)


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """loops: loop variables outermost-first. accesses: all array refs."""
    loops: tuple[str, ...]
    accesses: tuple[ArrayAccess, ...]
    writes: tuple[str, ...] = ()  # array names written


@dataclasses.dataclass(frozen=True)
class TransformPlan:
    critical: ArrayAccess          # the bandwidth-critical access
    contiguous_var: str            # loop var to vectorize along
    stride_var: str                # outer loop var to stride-unroll
    needs_interchange: bool        # contiguous var was not innermost
    needs_blocking: bool           # 1-D traversal → loop-block into D parts


def _vectorizable(var: str, accesses: tuple[ArrayAccess, ...]) -> bool:
    """var appears exclusively as the LAST dimension wherever it is used."""
    for acc in accesses:
        for pos, v in enumerate(acc.index):
            if v == var and pos != acc.rank - 1:
                return False
    return True


def plan_transform(nest: LoopNest) -> TransformPlan:
    """Apply the paper's §5.1 selection rule; raises if no access qualifies
    (e.g. transpose-like kernels needing gathers, out of the paper's scope).
    """
    # highest dimensionality first; among ties, prefer non-written arrays
    # (more read traffic) then declaration order.
    ranked = sorted(
        enumerate(nest.accesses),
        key=lambda e: (-e[1].rank, e[1].array in nest.writes, e[0]),
    )
    for _, acc in ranked:
        if acc.rank == 0:
            continue
        last_var = acc.index[-1]
        if _vectorizable(last_var, nest.accesses):
            contiguous_var = last_var
            needs_interchange = nest.loops[-1] != contiguous_var
            # stride-unroll axis: the outermost loop var that isn't the
            # contiguous var (paper: "loop unrolling over any other axis").
            outer = [v for v in nest.loops if v != contiguous_var]
            if outer:
                stride_var = outer[0]
                needs_blocking = False
            else:
                # 1-D traversal: block the single loop into D partitions
                # (paper §5.1.1 last paragraph; used by gemversum/init).
                stride_var = contiguous_var
                needs_blocking = True
            return TransformPlan(
                critical=acc,
                contiguous_var=contiguous_var,
                stride_var=stride_var,
                needs_interchange=needs_interchange,
                needs_blocking=needs_blocking,
            )
    raise ValueError(
        "no vectorizable critical access (gather required — outside the "
        "paper's scope, §5.1.1)")
