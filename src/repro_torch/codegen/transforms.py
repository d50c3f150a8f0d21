"""Schedule transforms: unroll, interchange, and the multi-striding split.

A :class:`Schedule` is a list of :class:`LoopAxis` entries (outermost
first), each contributing ``position * stride`` to the original index of
its source axis.  Transforms rewrite that list while preserving the
iteration domain — the exact algebra the paper describes (§5.1/§7):
multi-striding = loop splitting where the *outer* part becomes D
concurrent streams instead of a sequential loop.

  * :func:`unroll`       — axis(N) → grid(N/u, stride·u) × unroll(u)
  * :func:`interchange`  — permute the nest
  * :func:`stride_split` — axis(N) → stream(d, stride·N/d) × grid(N/d):
    d maximally-spaced concurrent segments (paper Fig 1 right)
  * :func:`vector_block` — like unroll but the inner part is the lane
    (vector) dimension of the emitted block
  * :func:`block`        — §5.1.1 cache blocking: axis(N) →
    grid(N/b, stride·b) × tile(b): contiguous tiles held on chip for
    re-use; composes with the other transforms under the same
    domain-preservation checker

Every transform is checked by :func:`preserves_domain` — a per-axis
mixed-radix interval proof (enumeration only as a small-domain fallback
for hand-built schedules).  :func:`default_schedule` runs the paper's
full §5.1 recipe
on a spec: critical-access selection (``core.transform.plan_transform``)
→ interchange (contiguous axis innermost) → stride split into D streams
× P lane portions per :class:`~repro_torch.core.striding.StridingConfig`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

from repro_torch.codegen import loopir
from repro_torch.core.striding import (SINGLE_STRIDED, StridingConfig,
                                 choose_block, pad_to_multiple)

__all__ = [
    "LoopAxis", "Schedule", "BlockPlan", "schedule", "interchange",
    "unroll", "stride_split", "vector_block", "block", "multi_stride",
    "plan_blocks", "default_schedule", "iteration_domain",
    "preserves_domain",
]

GRID = "grid"        # sequential grid dimension
STREAM = "stream"    # D concurrent streams (one load sequence each)
UNROLL = "unroll"    # unrolled into the kernel body (block rows)
VECTOR = "vector"    # lane dimension of the emitted block
BLOCK = "block"      # §5.1.1 cache tile materialized whole on chip

LANE = 128


@dataclasses.dataclass(frozen=True)
class LoopAxis:
    """One scheduled loop: contributes ``position * stride`` to the
    original index of source axis ``axis``."""

    axis: str
    extent: int
    stride: int
    kind: str = GRID


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A scheduled nest: the spec plus the transformed loop list."""

    spec: loopir.TraversalSpec
    loops: tuple[LoopAxis, ...]
    config: StridingConfig = SINGLE_STRIDED

    def find(self, axis: str, kind: str) -> Optional[LoopAxis]:
        for l in self.loops:
            if l.axis == axis and l.kind == kind:
                return l
        return None

    def grid_loops(self) -> list[LoopAxis]:
        return [l for l in self.loops if l.kind == GRID]


def schedule(spec: loopir.TraversalSpec,
             config: StridingConfig = SINGLE_STRIDED) -> Schedule:
    """Identity schedule: every axis one sequential grid loop."""
    return Schedule(
        spec=spec,
        loops=tuple(LoopAxis(ax.name, ax.extent, 1, GRID)
                    for ax in spec.axes),
        config=config,
    )


def _locate(sched: Schedule, axis: str, kind: str = GRID) -> int:
    for i, l in enumerate(sched.loops):
        if l.axis == axis and l.kind == kind:
            return i
    raise ValueError(f"no {kind} loop over axis {axis!r} in schedule")


def _split(sched: Schedule, axis: str, factor: int,
           outer_kind: str, inner_kind: str) -> Schedule:
    """axis(N, s) → outer(factor or N/factor) × inner, domain-preserving.

    For ``outer_kind=STREAM`` the outer part has extent ``factor`` and
    stride ``s*(N/factor)`` — ``factor`` maximally-spaced segments.  For
    sequential splits (unroll/vector) the *inner* part has extent
    ``factor`` and stride ``s`` — contiguous sub-blocks.
    """
    i = _locate(sched, axis)
    loop = sched.loops[i]
    if factor < 1 or loop.extent % factor != 0:
        raise ValueError(
            f"factor {factor} does not divide extent {loop.extent} of "
            f"axis {axis!r} (paper §5.1.2 divisibility)")
    if outer_kind == STREAM:
        outer = LoopAxis(axis, factor, loop.stride * (loop.extent // factor),
                         STREAM)
        inner = LoopAxis(axis, loop.extent // factor, loop.stride, inner_kind)
    else:
        outer = LoopAxis(axis, loop.extent // factor, loop.stride * factor,
                         outer_kind)
        inner = LoopAxis(axis, factor, loop.stride, inner_kind)
    loops = sched.loops[:i] + (outer, inner) + sched.loops[i + 1:]
    return dataclasses.replace(sched, loops=loops)


def unroll(sched: Schedule, axis: str, factor: int) -> Schedule:
    """Classic loop unroll: ``factor`` consecutive iterations move into
    the body (block rows, the paper's portion dimension ancestor)."""
    return _split(sched, axis, factor, GRID, UNROLL)


def vector_block(sched: Schedule, axis: str, width: int) -> Schedule:
    """Block the contiguous axis into lane-width vector portions."""
    return _split(sched, axis, width, GRID, VECTOR)


def stride_split(sched: Schedule, axis: str, d: int) -> Schedule:
    """THE multi-striding transform (paper §3): split ``axis`` into D
    concurrent streams of maximally-spaced segments.  The stream part is
    not a sequential loop — a kernel issues the D segments' loads back
    to back, i.e. D independent global-memory streams in flight."""
    return _split(sched, axis, d, STREAM, GRID)


def block(sched: Schedule, axis: str, size: int) -> Schedule:
    """§5.1.1 cache blocking: tile ``axis`` into contiguous ``size``-wide
    on-chip tiles — grid(N/size) sequential steps, each holding one
    whole tile for data re-use.  Multi-striding alone only fixes the
    traversal order; blocking is what makes the streamed data *reused*
    (the paper combines both for MXV/doitgen/PolyBench).  Composes with
    :func:`stride_split` / :func:`unroll` / :func:`interchange` and is
    checked by the same :func:`preserves_domain` algebra."""
    return _split(sched, axis, size, GRID, BLOCK)


def interchange(sched: Schedule, order: Sequence[int]) -> Schedule:
    """Permute the nest (paper §5.1: vectorizable axis → innermost)."""
    if sorted(order) != list(range(len(sched.loops))):
        raise ValueError(f"order {order!r} is not a permutation of "
                         f"{len(sched.loops)} loops")
    return dataclasses.replace(
        sched, loops=tuple(sched.loops[i] for i in order))


def multi_stride(sched: Schedule, config: StridingConfig, *,
                 block_rows: int, vector_width: int) -> Schedule:
    """The composite §5.1 pipeline step on an already-interchanged nest:
    stride-split the outer axis into D streams, unroll the per-stream
    remainder into ``block_rows``-row blocks, and block the contiguous
    axis into ``vector_width`` lanes (= 128·P)."""
    info = loopir.classify(sched.spec)
    s = stride_split(sched, info.stride_axis, config.stride_unroll)
    s = unroll(s, info.stride_axis, block_rows)
    s = vector_block(s, info.vector_axis, vector_width)
    return dataclasses.replace(s, config=config)


# ------------------------------------------------------------ blocking

@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Concrete blocking decisions shared by padding and the kernels'
    geometry (D streams, bm rows per stream step, bn lanes)."""

    info: loopir.NestInfo
    d: int             # concurrent streams
    bm: int            # block rows per stream per grid step
    bn: int            # block lanes (128 * portions, or full width w/ halo)
    rows: int          # padded stride-axis extent (d*bm | rows)
    cols: int          # padded vector-axis extent (bn | cols)


def plan_blocks(spec: loopir.TraversalSpec,
                config: StridingConfig,
                prefer_bm: int = 8,
                info: Optional[loopir.NestInfo] = None) -> BlockPlan:
    """Pick (bm, bn) and padded extents for a spec + config.

    Row-haloed (stencil) nests use single-row blocks so each stencil tap
    is its own stream operand; column-haloed and ``full_width`` nests
    keep the full width in one block (taps are static lane shifts; body
    row reductions see the whole row).  Everything else follows the
    hand-written kernels' conventions: bn = 128·P lanes, and the §5.1.1
    cache-block row count is ``config.block_rows`` when set (the planner/
    autotuner sweep dimension), else ≤ ``prefer_bm`` rows.  ``info`` is
    ``loopir.classify(spec)`` where the caller has it already.
    """
    if info is None:
        info = loopir.classify(spec)
    if info.blocked:
        raise ValueError(
            f"{spec.name}: 1-D nest — loop-block it into a 2-D tile grid "
            "first")
    d = config.stride_unroll
    rows = spec.axis(info.stride_axis).extent
    cols = spec.axis(info.vector_axis).extent
    rows_p = pad_to_multiple(rows, d)
    row_halo = info.row_halo != (0, 0)
    col_halo = info.col_halo != (0, 0)
    if config.block_rows:
        prefer_bm = config.block_rows
    bm = 1 if row_halo else choose_block(rows_p // d, prefer_bm)
    if col_halo or spec.full_width:
        bn, cols_p = cols, cols           # full-width blocks, no col grid
    else:
        cols_p = pad_to_multiple(cols, LANE)
        bn = choose_block(cols_p, LANE * config.portion_unroll)
    return BlockPlan(info=info, d=d, bm=bm, bn=bn, rows=rows_p, cols=cols_p)


def default_schedule(spec: loopir.TraversalSpec,
                     config: StridingConfig,
                     blocks: Optional[BlockPlan] = None) -> Schedule:
    """The paper's full §5.1 preparatory pipeline on a (padded) spec:
    batch axes stay leading grid loops, free axes become whole-extent
    on-chip tiles (:data:`BLOCK`), then interchange so the contiguous axis
    is innermost and ``multi_stride`` with the planned blocking."""
    bp = blocks if blocks is not None else plan_blocks(spec, config)
    if (spec.axis(bp.info.stride_axis).extent != bp.rows
            or spec.axis(bp.info.vector_axis).extent != bp.cols):
        raise ValueError(
            f"{spec.name}: spec extents must match the (padded) BlockPlan; "
            "pad inputs and rebuild the spec first (see emit.emit_spec)")
    s = schedule(spec, config)
    if bp.info.free_axes:
        s = dataclasses.replace(s, loops=tuple(
            dataclasses.replace(l, kind=BLOCK) if l.axis in bp.info.free_axes
            else l for l in s.loops))
    vec_pos = _locate(s, bp.info.vector_axis)
    if vec_pos != len(s.loops) - 1:
        order = [i for i in range(len(s.loops)) if i != vec_pos] + [vec_pos]
        s = interchange(s, order)
    return multi_stride(s, config, block_rows=bp.bm, vector_width=bp.bn)


# --------------------------------------------------- domain validation

def iteration_domain(sched: Schedule) -> set[tuple[int, ...]]:
    """Every original (axis₀, axis₁, …) index tuple the schedule covers.
    Exponential in loop count — for tests and small specs only."""
    axis_names = [ax.name for ax in sched.spec.axes]
    pts = set()
    for combo in itertools.product(*(range(l.extent) for l in sched.loops)):
        idx = dict.fromkeys(axis_names, 0)
        for loop, pos in zip(sched.loops, combo):
            idx[loop.axis] += pos * loop.stride
        pts.add(tuple(idx[a] for a in axis_names))
    return pts


_ENUM_CAP = 1 << 20   # per-axis enumeration fallback bound


def _axis_covers(loops: Sequence[LoopAxis], extent: int) -> bool:
    """True iff the loops over ONE source axis cover ``[0, extent)``
    exactly once.

    Interval proof first: sort by stride descending and require a
    telescoping mixed-radix decomposition — ``stride_i == extent_{i+1} ·
    stride_{i+1}`` with the innermost stride 1 and the extent product
    equal to the axis extent.  Then each point has a unique mixed-radix
    representation, so the map (positions → index) is a bijection onto
    ``[0, extent)`` — no enumeration, any extent.  Every ``_split``
    composition (stream/unroll/vector/block) preserves this certificate
    by construction: splitting ``(N, s)`` yields adjacent strides
    ``s·f, s`` (or ``s·(N/f), s``) whose telescoping product is exact.

    Decompositions the certificate cannot prove (hand-built schedules
    with gaps or overlaps) fall back to enumerating this axis alone,
    capped at ``_ENUM_CAP`` points — beyond that, unprovable means
    rejected."""
    if not loops:
        return extent == 1
    # tie-break equal strides by extent descending so extent-1 loops
    # (stride irrelevant) sort after the loop they duplicate
    ls = sorted(loops, key=lambda l: (-l.stride, -l.extent))
    total = 1
    for l in ls:
        total *= l.extent
    if total != extent:
        return False
    ok = ls[-1].stride == 1
    for outer, inner in zip(ls, ls[1:]):
        ok = ok and outer.stride == inner.extent * inner.stride
    if ok:
        return True
    if total > _ENUM_CAP:
        return False
    seen = set()
    for combo in itertools.product(*(range(l.extent) for l in ls)):
        seen.add(sum(p * l.stride for p, l in zip(combo, ls)))
    return seen == set(range(extent))


def preserves_domain(sched: Schedule) -> bool:
    """True iff the schedule covers the spec's iteration domain exactly
    once (bijection: same point count and same point set).

    Decides per source axis via :func:`_axis_covers` — an interval /
    mixed-radix proof, not a point-set enumeration — so it works for
    extents far too large to enumerate.  Axes factor
    independently: each loop contributes only to its own source axis,
    so the full domain is covered exactly once iff every axis is."""
    by_axis: dict[str, list[LoopAxis]] = {}
    for l in sched.loops:
        by_axis.setdefault(l.axis, []).append(l)
    for ax in sched.spec.axes:
        if not _axis_covers(by_axis.pop(ax.name, []), ax.extent):
            return False
    return not by_axis   # loops over axes the spec does not declare
