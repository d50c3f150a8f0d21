"""Loop-nest IR: the input language of the codegen pipeline (torch).

A kernel is described as a :class:`TraversalSpec` — an iteration domain
(ordered :class:`Axis` list, outermost first), per-array affine access
maps (:class:`Access`: one axis variable per array dimension, plus an
optional halo for stencil taps), and a body expressed as a torch callable
over the loaded blocks.  The spec is *schedule-free*: the multi-striding
transform pipeline (``repro_torch.codegen.transforms``) decides how the
nest is blocked and split into D concurrent streams, and the emitter
front end (``repro_torch.codegen.emit``) hands the planned geometry to the
hand-written CUDA kernel registered for the spec.  This is the paper's closing observation made concrete: multi-
striding "is a natural extension of the loop unroll and loop interchange
techniques, allowing this method to be incorporated into compiler
pipelines" (§7) — here the access pattern is a derived artifact of the
spec, not hand-written kernel code.

Body conventions (shape-polymorphic on purpose):

  * ``body(env)`` receives a dict mapping each read array name to its
    loaded block and each scalar name to a () value, and returns the
    output block.
  * For an access with a halo, the env value *includes* the halo border.
  * For a spec whose vector axis is a reduction, the body must itself
    reduce over that axis; the ref interpreter evaluates the body once
    over the full extent.

:func:`evaluate` is the plain PyTorch version of every kernel: the
CUDA kernels implement the same body per stream block, and the tests
and ``chip_smoke.py`` hold them against it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import torch

from repro_torch.codegen.combine import Combine, resolve_combine
from repro_torch.core.planner import Traffic
from repro_torch.core.transform import ArrayAccess, LoopNest, plan_transform

__all__ = [
    "Axis", "Access", "TraversalSpec", "tap", "to_loop_nest", "classify",
    "traffic_of", "evaluate",
]

PARALLEL = "parallel"
REDUCTION = "reduction"
BATCH = "batch"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One loop of the nest: ``for name in range(extent)``.

    ``kind="batch"`` marks an independent outer problem instance (e.g.
    the batch dimension of a KV cache, or doitgen's ``r``): a kernel
    maps every batch axis to a leading grid dimension, outside the
    multi-striding transform entirely — streams, blocking
    and vectorization all happen within one batch element.
    """

    name: str
    extent: int
    kind: str = PARALLEL  # "parallel" | "reduction" | "batch"

    def __post_init__(self):
        if self.extent < 1:
            raise ValueError(f"axis {self.name!r}: extent must be >= 1")
        if self.kind not in (PARALLEL, REDUCTION, BATCH):
            raise ValueError(f"axis {self.name!r}: unknown kind {self.kind!r}")


def _zero_halo(ndim: int) -> tuple[tuple[int, int], ...]:
    return tuple((0, 0) for _ in range(ndim))


@dataclasses.dataclass(frozen=True)
class Access:
    """Affine access map of one array: dim ``d`` is indexed by loop
    variable ``index[d]`` plus any constant offset within ``halo[d]`` =
    (lo, hi).  A non-zero halo widens the loaded block for stencil
    taps."""

    array: str
    index: tuple[str, ...]
    halo: Optional[tuple[tuple[int, int], ...]] = None

    def __post_init__(self):
        if self.halo is None:
            object.__setattr__(self, "halo", _zero_halo(len(self.index)))
        if len(self.halo) != len(self.index):
            raise ValueError(f"access {self.array!r}: halo rank mismatch")
        for lo, hi in self.halo:
            if lo < 0 or hi < 0:
                raise ValueError(f"access {self.array!r}: negative halo")

    @property
    def rank(self) -> int:
        return len(self.index)

    @property
    def has_halo(self) -> bool:
        return any(lo or hi for lo, hi in self.halo)

    def halo_of(self, var: str) -> tuple[int, int]:
        """Combined (lo, hi) halo over every dim indexed by ``var``."""
        lo = hi = 0
        for v, (l, h) in zip(self.index, self.halo):
            if v == var:
                lo, hi = max(lo, l), max(hi, h)
        return lo, hi


@dataclasses.dataclass(frozen=True)
class TraversalSpec:
    """A whole kernel: iteration domain + access maps + torch body.

    ``reduce`` is the combine op for nests whose *stride* axis is a
    reduction: per-stream partial results merge across streams and grid
    steps with that combinator (the mxv_t / flash-decode pattern).  It
    is either "sum" | "max" or any :class:`~repro_torch.codegen.combine.
    Combine` instance — a monoid over a tuple of f32 accumulators whose
    ``finalize`` produces the written block (e.g. ``OnlineSoftmax`` for
    single-pass decode attention).  ``full_width=True`` declares that
    the body needs the entire vector extent in one block (e.g. a
    per-row mean, or a reduction contracted inside the body) — a kernel
    then never splits the vector axis across blocks.

    Multiple ``writes`` declare native multi-output kernels: the body
    returns one block per write access (same order) and the kernel
    writes each to its own output tensor.  Each write carries its OWN
    access map: any
    subset/permutation of the nest's non-reduced axes is a valid write
    index (batch axes must all appear, leading), so a reduced-rank side
    output — a row statistic next to a matrix write, a log-sum-exp next
    to an attention output — gets its own block geometry instead of
    being forced through the widest write's tiling.  ``out_dtype`` may
    then be a tuple (one dtype per output).  A spec with no reads (e.g.
    a fill) must set ``out_dtype``; its body result is broadcast to the
    output block.
    """

    name: str
    axes: tuple[Axis, ...]
    reads: tuple[Access, ...]
    writes: tuple[Access, ...]
    body: Callable[[Mapping[str, Any]], Any]
    scalars: tuple[str, ...] = ()
    out_dtype: Any = None   # dtype (or per-write tuple); default: first read
    reduce: Any = "sum"     # stride-axis combine ("sum" | "max" | Combine)
    full_width: bool = False

    def __post_init__(self):
        names = [ax.name for ax in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate axis names {names}")
        if not self.writes:
            raise ValueError(f"{self.name}: at least one write access "
                             "required")
        wnames = [a.array for a in self.writes]
        if len(set(wnames)) != len(wnames):
            raise ValueError(f"{self.name}: duplicate write arrays {wnames}")
        if isinstance(self.reduce, tuple):
            # per-write combinators: one entry per write, applied to that
            # write's OWN f32 accumulator (a row-max next to a row-sum in
            # one sweep).  Stateful/finalizing combinators merge ONE
            # shared state across every write and cannot be distributed
            # per accumulator — they must stay a scalar ``reduce``.
            if len(self.reduce) != len(self.writes):
                raise ValueError(
                    f"{self.name}: reduce tuple has {len(self.reduce)} "
                    f"entries for {len(self.writes)} writes")
            for r in self.reduce:
                comb = resolve_combine(r)   # raises on unknown combine
                if comb.n_state > 1 or comb.finalizing:
                    raise ValueError(
                        f"{self.name}: per-write combine {comb.name!r} "
                        "must be single-state and non-finalizing; "
                        "stateful combinators share one state across "
                        "writes — use a scalar reduce")
        else:
            resolve_combine(self.reduce)   # raises on unknown combine
        if isinstance(self.out_dtype, tuple):
            if len(self.out_dtype) != len(self.writes):
                raise ValueError(
                    f"{self.name}: out_dtype tuple has {len(self.out_dtype)}"
                    f" entries for {len(self.writes)} writes")
        if not self.reads and self.out_dtype is None:
            raise ValueError(f"{self.name}: a spec with no reads must "
                             "declare out_dtype")
        n_batch = sum(ax.kind == BATCH for ax in self.axes)
        if any(ax.kind == BATCH for ax in self.axes[n_batch:]):
            raise ValueError(f"{self.name}: batch axes must be outermost")
        known = set(names)
        batch = {ax.name for ax in self.axes if ax.kind == BATCH}
        for acc in (*self.reads, *self.writes):
            for v in acc.index:
                if v not in known:
                    raise ValueError(
                        f"{self.name}: access {acc.array!r} indexes unknown "
                        f"axis {v!r}")
            n = sum(v in batch for v in acc.index)
            if any(v in batch for v in acc.index[n:]):
                raise ValueError(
                    f"{self.name}: access {acc.array!r}: batch axis vars "
                    "must form the leading index prefix")
        reduced = {ax.name for ax in self.axes if ax.kind == REDUCTION}
        for w in self.writes:
            if w.has_halo:
                raise ValueError(
                    f"{self.name}: write access {w.array!r} cannot have a "
                    "halo")
            # a write's index may be any subset/permutation of the nest's
            # NON-REDUCED axes: reduced axes are folded away (writing
            # along one is ill-defined), a repeated axis has no affine
            # store meaning, and a write missing a batch axis would be
            # overwritten once per batch element
            if len(set(w.index)) != len(w.index):
                raise ValueError(
                    f"{self.name}: [SPEC001] write {w.array!r} repeats "
                    f"an axis {w.index} — a repeated variable has no "
                    "affine store meaning")
            hit = [v for v in w.index if v in reduced]
            if hit:
                raise ValueError(
                    f"{self.name}: [SPEC002] write {w.array!r} indexes "
                    f"reduced axis {hit[0]!r} — reduced axes are folded "
                    "away, writing along one is ill-defined")
            missing = [b for b in batch if b not in w.index]
            if missing:
                raise ValueError(
                    f"{self.name}: [SPEC003] write {w.array!r} must "
                    f"index every batch axis (missing {missing[0]!r}) — "
                    "it would be overwritten once per batch element")

    def axis(self, name: str) -> Axis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(name)

    @property
    def combine(self) -> Combine:
        """The single stride-axis combinator.  A per-write ``reduce``
        tuple has no one combinator — use :meth:`combines`."""
        if isinstance(self.reduce, tuple):
            names = ", ".join(
                repr(getattr(r, "name", r)) for r in self.reduce)
            raise ValueError(
                f"{self.name}: [SPEC004] spec has per-write combinators "
                f"({names}); spec.combine is ambiguous — use "
                "spec.combines()")
        return resolve_combine(self.reduce)

    def combines(self) -> tuple[Combine, ...]:
        """One combinator per write: a ``reduce`` tuple maps entrywise,
        a scalar reduce broadcasts to every write."""
        if isinstance(self.reduce, tuple):
            return tuple(resolve_combine(r) for r in self.reduce)
        return (resolve_combine(self.reduce),) * len(self.writes)

    def out_shapes(self) -> tuple[tuple[int, ...], ...]:
        return tuple(tuple(self.axis(v).extent for v in w.index)
                     for w in self.writes)

    def out_dtypes(self, arrays: Sequence = ()) -> tuple:
        """Per-write output dtypes (``out_dtype`` broadcast / defaulted
        to the first read operand's dtype)."""
        dt = self.out_dtype
        if isinstance(dt, tuple):
            return dt
        if dt is None:
            dt = arrays[0].dtype
        return (dt,) * len(self.writes)


def tap(block: torch.Tensor, halo: Sequence[tuple[int, int]],
        *offsets: int) -> torch.Tensor:
    """Static stencil tap: the interior of a halo-widened block, shifted
    by ``offsets`` (one per dim, each within [-lo, +hi]).  A plain slice
    (a view), so a body built on it evaluates on the whole haloed array
    in :func:`evaluate`."""
    if len(offsets) != len(halo):
        raise ValueError("one offset per dim required")
    index = []
    for dim, ((lo, hi), off) in enumerate(zip(halo, offsets)):
        if not (-lo <= off <= hi):
            raise ValueError(f"tap offset {off} outside halo ({lo},{hi})")
        size = block.shape[dim] - lo - hi
        index.append(slice(lo + off, lo + off + size))
    return block[tuple(index)]


# ------------------------------------------------------- classification

@dataclasses.dataclass(frozen=True)
class NestInfo:
    """Scheduling-relevant facts derived from a spec (paper §5.1)."""

    stride_axis: str      # axis split into D concurrent streams
    vector_axis: str      # contiguous axis (lane dimension)
    reduction: bool       # vector axis is reduced over
    row_halo: tuple[int, int]   # max (lo, hi) halo along the stride axis
    col_halo: tuple[int, int]   # max (lo, hi) halo along the vector axis
    needs_interchange: bool
    batch_axes: tuple[str, ...] = ()   # leading kernel grid dimensions
    free_axes: tuple[str, ...] = ()    # whole-extent (resident) axes
    stride_reduction: bool = False     # stride axis is reduced over
    blocked: bool = False   # 1-D nest: loop-block into 2-D first (§5.1.1)


def to_loop_nest(spec: TraversalSpec) -> LoopNest:
    """Bridge to the symbolic §5.1 planner (``core.transform``): every
    loop of the nest and every access, reads then writes."""
    return LoopNest(
        loops=tuple(ax.name for ax in spec.axes),
        accesses=tuple(ArrayAccess(a.array, a.index)
                       for a in (*spec.reads, *spec.writes)),
        writes=tuple(a.array for a in spec.writes),
    )


def classify(spec: TraversalSpec) -> NestInfo:
    """Apply the paper's critical-access selection to pick the stride and
    vector axes, then collect the halo/batch/free facts the kernels'
    geometry needs.  Batch axes sit outside the §5.1 selection; a 1-D non-batch
    nest is flagged ``blocked`` (§5.1.1: the emitter loop-blocks it into
    a 2-D tile grid before striding)."""
    batch = tuple(ax.name for ax in spec.axes if ax.kind == BATCH)
    inner = [ax for ax in spec.axes if ax.kind != BATCH]
    if not inner:
        raise ValueError(f"{spec.name}: nest has only batch axes")

    def strip(idx: tuple[str, ...]) -> tuple[str, ...]:
        return tuple(v for v in idx if v not in batch)

    nest = LoopNest(
        loops=tuple(ax.name for ax in inner),
        accesses=tuple(ArrayAccess(a.array, strip(a.index))
                       for a in (*spec.reads, *spec.writes)
                       if strip(a.index)),
        writes=tuple(a.array for a in spec.writes),
    )
    try:
        plan = plan_transform(nest)
    except ValueError:
        # A transposed store (write index permuting the stride axis
        # after the vector axis) leaves NO axis that is last in every
        # access, so the §5.1 critical-access selection fails over the
        # full access set.  The reads still determine the traversal —
        # retry on them alone.
        read_accs = tuple(ArrayAccess(a.array, strip(a.index))
                          for a in spec.reads if strip(a.index))
        if not read_accs:
            raise
        plan = plan_transform(LoopNest(
            loops=tuple(ax.name for ax in inner),
            accesses=read_accs, writes=()))
    stride, vec = plan.stride_var, plan.contiguous_var
    blocked = plan.needs_blocking
    if blocked:
        ax = spec.axis(stride)
        if ax.kind != PARALLEL or batch:
            raise NotImplementedError(
                f"{spec.name}: 1-D loop-blocked nests must be a single "
                "parallel axis (no reduction, no batch)")
        if any(a.has_halo for a in spec.reads):
            raise NotImplementedError(
                f"{spec.name}: halos on a 1-D blocked nest")
    free = tuple(ax.name for ax in inner if ax.name not in (stride, vec))
    row_lo = row_hi = col_lo = col_hi = 0
    for acc in spec.reads:
        lo, hi = acc.halo_of(stride)
        row_lo, row_hi = max(row_lo, lo), max(row_hi, hi)
        lo, hi = acc.halo_of(vec)
        col_lo, col_hi = max(col_lo, lo), max(col_hi, hi)
    stride_red = (not blocked) and spec.axis(stride).kind == REDUCTION
    return NestInfo(
        stride_axis=stride, vector_axis=vec,
        reduction=(not blocked) and spec.axis(vec).kind == REDUCTION,
        row_halo=(row_lo, row_hi), col_halo=(col_lo, col_hi),
        needs_interchange=plan.needs_interchange,
        batch_axes=batch, free_axes=free,
        stride_reduction=stride_red, blocked=blocked,
    )


BLOCK_COLS = 1024   # nominal §5.1.1 tile width for 1-D blocked traffic


def traffic_of(spec: TraversalSpec, dtype=torch.float32,
               info: Optional[NestInfo] = None) -> Traffic:
    """Derive the planner's memory signature from the access maps: every
    read indexed by the stride axis contributes one DMA stream per stride
    (stencil row taps count once per tap, like the paper's Table 1 "n+2
    load strides"); arrays not indexed by the stride axis are resident
    (batch extents are excluded — only one batch element is live).  A
    1-D blocked nest reports the shape of its nominal 2-D tiling.
    """
    if info is None:
        info = classify(spec)
    itemsize = dtype.itemsize
    reads = writes = 0
    resident = 0
    for acc in spec.reads:
        if info.stride_axis in acc.index:
            lo, hi = acc.halo_of(info.stride_axis)
            reads += 1 + lo + hi
        else:
            n = 1
            for v, (lo, hi) in zip(acc.index, acc.halo):
                if v in info.batch_axes:
                    continue
                n *= spec.axis(v).extent + lo + hi
            resident += n * itemsize
    def _laned(acc):
        return (info.vector_axis in acc.index
                or any(v in info.free_axes for v in acc.index))

    # a reduced-rank side output (stride axis but no lane dimension,
    # e.g. rmsnorm's inv-rms row statistic) moves ~1 element per row vs
    # a full store stream's whole rows — don't count it as a store
    # stream next to a full-map sibling.  When NO write has a lane
    # dimension (a vecred's per-row outputs), each write IS the primary
    # store and counts, so the accounting matches the same kernels
    # split into single-output specs.
    any_laned = any(_laned(w) for w in spec.writes
                    if info.stride_axis in w.index)
    for acc in spec.writes:
        if info.stride_axis not in acc.index:
            continue                      # stride-reduction outputs
        if _laned(acc) or not any_laned:
            writes += 1
    if info.blocked:
        n = spec.axis(info.stride_axis).extent
        cols = min(n, BLOCK_COLS)
        return Traffic(rows=max(-(-n // cols), 4), cols=cols, dtype=dtype,
                       read_arrays=reads, write_arrays=writes,
                       resident_bytes=resident)
    return Traffic(
        rows=spec.axis(info.stride_axis).extent,
        cols=spec.axis(info.vector_axis).extent,
        dtype=dtype, read_arrays=reads, write_arrays=writes,
        resident_bytes=resident,
    )


# ----------------------------------------------------- ref interpreter

def evaluate(spec: TraversalSpec, inputs: Sequence[Any], device=None):
    """The plain PyTorch version of a spec (``mode="ref"``).

    The body is applied once over the full iteration domain — haloed
    accesses see the whole input array (interior + border), reductions
    reduce over the full vector extent.  A paired-state combinator's
    partial state (one block covering the whole domain) is finalized
    here; multi-write bodies return one block per write.  It runs on
    whatever device the inputs lie on; a writes-only spec, whose inputs
    are scalars, makes its output on ``device`` (default: the CPU).
    """
    if len(inputs) != len(spec.reads) + len(spec.scalars):
        raise ValueError(
            f"{spec.name}: expected {len(spec.reads)} arrays + "
            f"{len(spec.scalars)} scalars, got {len(inputs)} inputs")
    arrays = list(inputs[:len(spec.reads)])
    scalars = list(inputs[len(spec.reads):])
    env: dict[str, Any] = {a.array: x for a, x in zip(spec.reads, arrays)}
    env.update(zip(spec.scalars, scalars))
    out = spec.body(env)
    # a per-write reduce tuple is single-state / non-finalizing by
    # construction (__post_init__): the body already reduced the full
    # extent, so there is no state to finalize here
    if not isinstance(spec.reduce, tuple):
        comb = resolve_combine(spec.reduce)
        if comb.n_state > 1 or comb.finalizing:
            state = out if isinstance(out, tuple) else (out,)
            if len(state) != comb.n_state:   # mirror the emitter's check
                raise ValueError(
                    f"{spec.name}: body returned {len(state)} state "
                    f"components for combine {comb.name!r} "
                    f"(n_state={comb.n_state})")
            out = comb.finalize(tuple(torch.as_tensor(o).float()
                                      for o in state))
    outs = out if isinstance(out, tuple) else (out,)
    if len(outs) != len(spec.writes):
        raise ValueError(f"{spec.name}: body returned {len(outs)} blocks "
                         f"for {len(spec.writes)} writes")
    res = []
    for o, shape, dt in zip(outs, spec.out_shapes(),
                            spec.out_dtypes(arrays)):
        if not spec.reads and not isinstance(o, torch.Tensor):
            # a writes-only body's scalar, made on the device without a
            # host copy (so it can be captured in a CUDA graph), in the
            # type torch.as_tensor gives it
            o = torch.full(shape, o, dtype=torch.as_tensor(o).dtype,
                           device=device)
        o = torch.as_tensor(o)
        if tuple(o.shape) != shape and not spec.reads:
            o = o.broadcast_to(shape)   # writes-only / fill bodies
        res.append(o.to(dt))
    return res[0] if len(res) == 1 else tuple(res)
