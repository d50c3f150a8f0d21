"""The K4 template, ``_emit_manual`` (``src/repro/codegen/emit.py:708``),
as a CUDA kernel (``csrc/manual_ring.cu``): a producer warp keeps TMA
copies in flight into ``lookahead``-deep rings of shared-memory stages
on full / empty mbarriers, consumer warps run the body between load and
store, and TMA stores drain a 2-deep staging ring.

The JAX package selects K4 at a ``lookahead`` other than 2 for specs
with plain ``(stride, vector)`` reads and ``(stride, vector)`` or
``(stride,)`` writes (``codegen.emit.template_of``).  The port's ring
has the bodies in :data:`BODIES`; :data:`SIGNATURES` gives each body's
operands: every read and write is of the ring's type ``T`` or f32 (each
operand's ring in its own dtype, as JAX's ``:819``), and a write is a
full-row ``(stride, vector)`` output or a rank-1 ``(stride,)`` one, a
``[rows]`` buffer of one lane a row (JAX's ``:732-734``).  adamw's ring
takes p and g of any compiled ``T`` with f32 m and v, as the K1 kernel
does; ``t_rowstat`` is the map-plus-row-statistic spec of the JAX
package's K4 test (:func:`rowstat_spec`), the one spec that reaches a
rank-1 write.

A step of the ring is a (row block, column tile) of every stream: the
TPU ring streamed whole rows, which do not fit a block's shared memory
at the paper's widths.  Each operand's stage of a stream is one TMA box
of its ``[rows, cols]`` array seen as 3-D ``[rows, cols/128, 128]``, so
a step is D copies per operand whatever the tile (:func:`ring_boxes`).
:func:`ring_tile` therefore no longer takes the widest tile that fits:
it takes the widest whose ring lets two blocks share an SM, or 128
columns where none does, and raises ``ValueError`` naming the bytes
where even that does not fit one block; it never changes D or
``lookahead``.  A spec with a rank-1 write steps by whole rows, as the
TPU ring did (a row statistic needs its whole row in one stage), and
raises the same ``ValueError`` where a whole-row ring does not fit.
:func:`ring_runs` cuts the steps into one contiguous run per resident
block: the grid is one wave.

:func:`emit` runs the spec's plain version (``loopir.evaluate``) on CPU
tensors, for any spec, before it refuses anything; on CUDA tensors it
launches the kernel or raises ``NotImplementedError`` for a spec with no
body of its name and operands.  Every full-row output of a ported body
is elementwise, so the tile walk gives the plain version's bits; a row
statistic is an f32 sum in another order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.loopir import Access, Axis, TraversalSpec
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["BODIES", "SIGNATURES", "OUT_STAGES", "MAX_BLOCKS_PER_SM",
           "RingPlan", "ring_smem", "ring_layout", "ring_tile",
           "ring_blocks_per_sm", "ring_runs", "ring_boxes", "box_rows",
           "ring_plan", "ring_sizes", "rowstat_spec", "emit"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I] * 8     # rows, cols, d, bm, bh, tw, la, per

# one launcher per body: spec name → its kernel
BODIES = {
    # manual_copy_launch(dtype, x, o, <geometry>, stream)
    "stream_copy": cuda.CudaKernel("manual_ring_copy", "manual_ring",
                                   "manual_copy_launch", [_I, _P, _P, *_GEOM]),
    # manual_triad_launch(dtype, b, c, o, alpha, <geometry>, stream)
    "stream_triad": cuda.CudaKernel("manual_ring_triad", "manual_ring",
                                    "manual_triad_launch",
                                    [_I, _P, _P, _P, _F, *_GEOM]),
    # manual_fill_launch(dtype, o, value, <geometry>, stream)
    "stream_init": cuda.CudaKernel("manual_ring_fill", "manual_ring",
                                   "manual_fill_launch", [_I, _P, _F, *_GEOM]),
    # manual_sum_launch(dtype, x, z, o, <geometry>, stream)
    "gemver_sum": cuda.CudaKernel("manual_ring_gemver_sum", "manual_ring",
                                  "manual_sum_launch",
                                  [_I, _P, _P, _P, *_GEOM]),
    # manual_adamw_launch(dtype, p, g, m, v, s, po, mo, vo, <geometry>,
    #                     stream); s the f32 [7] scalars on the card
    "adamw_update": cuda.CudaKernel("manual_ring_adamw", "manual_ring",
                                    "manual_adamw_launch",
                                    [_I, *[_P] * 8, *_GEOM]),
    # manual_rowstat_launch(dtype, x, o, r, <geometry>, stream)
    "t_rowstat": cuda.CudaKernel("manual_ring_rowstat", "manual_ring",
                                 "manual_rowstat_launch",
                                 [_I, _P, _P, _P, *_GEOM]),
}

_ALL = cuda.DTYPES
# body → (each read's type, each write's type, each write's rank, the
# types T it is compiled for): "T" is the ring's type, "f32" f32
SIGNATURES = {
    "stream_copy": (("T",), ("T",), (2,), _ALL),
    "stream_triad": (("T", "T"), ("T",), (2,), _ALL),
    "stream_init": ((), ("T",), (2,), _ALL),
    "gemver_sum": (("T", "T"), ("T",), (2,), _ALL),
    "adamw_update": (("T", "T", "f32", "f32"), ("T", "f32", "f32"),
                     (2, 2, 2), _ALL),
    "t_rowstat": (("T",), ("f32", "f32"), (2, 1),
                  (torch.float32, torch.bfloat16)),
}

OUT_STAGES = 2            # the staging ring's depth, as the TPU kernel's
GROUPS = 2                # consumer warp groups (one where lookahead 1 loads)
ROW_CHUNKS = 4            # warp chunks of a row statistic
MAX_BLOCKS_PER_SM = 2     # the kernel's __launch_bounds__ minimum
BOX_MAX = 256             # a TMA box's extent on each side, elements
RESERVED = 1024           # shared memory the card keeps per resident block
SLACK = 128               # bytes to align the dynamic shared base to 128
# shared memory of an H100 SM, and the most one block may opt into
SM_SMEM, BLOCK_SMEM = 233472, 232448


def rowstat_spec(x: torch.Tensor) -> TraversalSpec:
    """The JAX package's K4 test spec (``tests/test_codegen.py``
    ``_rowstat_spec``): a full-row map ``o = 2·x`` next to the rank-1
    row statistic ``r = Σ_j f32(x)``, both f32, ``full_width``."""
    rows, cols = x.shape
    return TraversalSpec(
        name="t_rowstat",
        axes=(Axis("i", rows), Axis("j", cols)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("o", ("i", "j")), Access("r", ("i",))),
        body=lambda env: (env["x"] * 2.0, env["x"].float().sum(dim=-1)),
        out_dtype=(torch.float32, torch.float32),
        full_width=True,
    )


class RingLayout(NamedTuple):
    """Byte offsets of a ring's shared memory from its 128-aligned base
    (``csrc/manual_ring.cu`` ``manual_ring``)."""
    inputs: tuple      # [input][slot]: each stage of D boxes
    outputs: tuple     # [full-row output][staging slot]
    rows: tuple        # [rank-1 output][staging slot]
    end: int           # bytes used from the base


def ring_layout(in_sizes: tuple, out_sizes: tuple, d: int, bm: int, tw: int,
                la: int, n_row: int = 0) -> RingLayout:
    """Where a ring's stages lie (operands as in :func:`ring_smem`): the
    mbarrier header (8 bytes for each full barrier, one per input, slot
    and consumer group, and each of the ``la`` empty barriers, padded to
    128), then
    ``la`` slots per input, 2 staging slots per full-row output, each
    ``D·bm·tw`` elements of its operand's size, then 2 slots of
    ``D·bm·4`` f32 partials (a row's four chunks), padded to 16 bytes,
    per rank-1 output."""
    groups = GROUPS if la > 1 or not in_sizes else 1
    off = -(-8 * (len(in_sizes) * groups + 1) * la // 128) * 128
    step = d * bm * tw

    def slots(sizes, n):
        nonlocal off
        out = []
        for e in sizes:
            out.append(tuple(off + i * step * e for i in range(n)))
            off += n * step * e
        return tuple(out)
    inputs, outputs = slots(in_sizes, la), slots(out_sizes, OUT_STAGES)
    rslot = -(-d * bm * ROW_CHUNKS * 4 // 16) * 16
    rows = tuple(tuple(off + (w * OUT_STAGES + i) * rslot
                       for i in range(OUT_STAGES)) for w in range(n_row))
    return RingLayout(inputs, outputs, rows,
                      off + n_row * OUT_STAGES * rslot)


def ring_smem(in_sizes: tuple, out_sizes: tuple, d: int, bm: int, tw: int,
              la: int, n_row: int = 0) -> int:
    """Dynamic shared memory of a ring whose inputs and full-row outputs
    have the element sizes ``in_sizes`` and ``out_sizes``
    (:func:`ring_sizes`) and which has ``n_row`` rank-1 outputs: the
    :func:`ring_layout` and 128 bytes to align its base
    (``csrc/manual_ring.cu`` ``ring_t``)."""
    return SLACK + ring_layout(in_sizes, out_sizes, d, bm, tw, la,
                               n_row).end


def ring_blocks_per_sm(smem: int, sm_smem: int = SM_SMEM) -> int:
    """Blocks of a ring of ``smem`` bytes that share one SM: as many as
    its shared memory holds (each also takes the card's 1 KB reserve),
    at most :data:`MAX_BLOCKS_PER_SM` (288 threads, at most 112
    registers each at two blocks).  The launcher refuses a grid that
    the occupancy API says is not resident at once."""
    return min(MAX_BLOCKS_PER_SM, sm_smem // (smem + RESERVED))


def ring_tile(bp: BlockPlan, config: StridingConfig, limit: int,
              in_sizes: tuple, out_sizes: tuple, n_row: int = 0,
              sm_smem: int = SM_SMEM) -> int:
    """The column width of a ring step (operands as in :func:`ring_smem`).

    A step's copies do not depend on the tile (one box a stream), so the
    widest tile is no longer the aim: this is the widest multiple of 128
    dividing ``bp.cols`` (at most 256 sub-portions, one box) whose ring
    lets :data:`MAX_BLOCKS_PER_SM` blocks share an SM of ``sm_smem``
    bytes, or, where even 128 columns do not, 128 columns with one
    block an SM.  A writes-only ring (no inputs: no loads to keep in
    flight) takes the widest tile that fits one block: longer row
    pieces store faster (measured on the H100, ``PERF.md``).  A ring
    with a rank-1 output (``n_row > 0``) steps by the whole row.  Raises ``ValueError`` naming the bytes where the
    ring does not fit ``limit`` bytes, a block's opt-in maximum (as the
    JAX checker's manual-ring budget does); D and ``lookahead`` are
    never changed to make it fit."""
    la = config.lookahead

    def need(tw):
        return ring_smem(in_sizes, out_sizes, bp.d, bp.bm, tw, la, n_row)
    what = (f"lookahead {la} x D {bp.d} stages of {bp.bm} rows for each "
            f"input (element bytes {in_sizes}), 2 x D for each full-row "
            f"output ({out_sizes})")
    if n_row:
        if need(bp.cols) > limit:
            raise ValueError(
                f"K4 ring does not fit shared memory: {need(bp.cols)} bytes "
                f"for a whole-row step of {bp.cols} columns (a (stride,) "
                f"side write needs whole rows: {what} and {n_row} rank-1 "
                f"outputs, and the barriers) against a limit of {limit} "
                "bytes")
        if bp.cols > BOX_MAX * LANE:
            raise ValueError(
                f"K4 ring: a whole-row step of {bp.cols} columns is more "
                f"than one TMA box of {BOX_MAX} sub-portions")
        return bp.cols
    if need(LANE) > limit:
        raise ValueError(
            f"K4 ring does not fit shared memory: {need(LANE)} bytes for a "
            f"128-column step ({what}, and the barriers) against a limit "
            f"of {limit} bytes")
    nsub = bp.cols // LANE
    blocks = 1 if not in_sizes else MAX_BLOCKS_PER_SM
    fits = [u * LANE for u in range(1, min(nsub, BOX_MAX) + 1)
            if nsub % u == 0 and need(u * LANE) <= limit
            and ring_blocks_per_sm(need(u * LANE), sm_smem) >= blocks]
    return fits[-1] if fits else LANE


def ring_runs(steps: int, sms: int, per_sm: int) -> tuple[int, int]:
    """``(steps per block, blocks)``: the steps cut into contiguous runs,
    one for each of the ``per_sm · sms`` blocks that are resident at
    once (:func:`ring_blocks_per_sm`), none empty: one wave."""
    per = -(-steps // max(1, min(steps, per_sm * sms)))
    return per, -(-steps // per)


def box_rows(bm: int) -> int:
    """Rows of a stage's box: ``bm``, or where ``bm`` exceeds a box's
    256, its largest divisor up to 256."""
    return next(h for h in range(min(bm, BOX_MAX), 0, -1) if bm % h == 0)


def ring_boxes(bp: BlockPlan, tw: int, step: int) -> list[tuple]:
    """The TMA boxes of one step, as every operand's copies issue them
    in stream order: ``(row, col, rows, cols, offset)``, the box's first
    row and column in the ``[rows, cols]`` array, its extent (a 3-D box
    of ``(128, tw/128, rows)`` elements), and its first element's offset
    in the operand's slot (stream k's stage at ``k·bm·tw``, row-major
    ``[bm][tw]``)."""
    seg, bh = bp.rows // bp.d, box_rows(bp.bm)
    t, j = divmod(step, bp.cols // tw)
    return [(k * seg + t * bp.bm + b * bh, j * tw, bh, tw,
             (k * bp.bm + b * bh) * tw)
            for k in range(bp.d) for b in range(bp.bm // bh)]


class RingPlan(NamedTuple):
    """What the launcher does with a ring (:func:`ring_plan`)."""
    tw: int            # columns a step
    bh: int            # rows a box
    copies: int        # boxes a step per operand (D · bm / bh)
    box_bytes: tuple   # bytes of one box, per input then full-row output
    smem: int          # dynamic shared memory of a block
    per_sm: int        # blocks an SM
    steps: int
    per: int           # steps a block
    blocks: int        # the grid: at most per_sm · SMs, one wave


def ring_plan(name: str, dtype: torch.dtype, bp: BlockPlan,
              config: StridingConfig, sms: int, limit: int = BLOCK_SMEM,
              sm_smem: int = SM_SMEM, tile: Optional[int] = None
              ) -> RingPlan:
    """The launch of body ``name``'s ring of type ``dtype`` on ``bp``:
    its tile (``tile``, or :func:`ring_tile`'s), boxes, shared memory,
    blocks an SM and one-wave grid on a card of ``sms`` SMs."""
    in_sizes, out_sizes, n_row = ring_sizes(name, dtype)
    tw = tile or ring_tile(bp, config, limit, in_sizes, out_sizes, n_row,
                           sm_smem)
    smem = ring_smem(in_sizes, out_sizes, bp.d, bp.bm, tw,
                     config.lookahead, n_row)
    bh = box_rows(bp.bm)
    steps = bp.rows // bp.d // bp.bm * (bp.cols // tw)
    per_sm = ring_blocks_per_sm(smem, sm_smem)
    per, blocks = ring_runs(steps, sms, per_sm)
    return RingPlan(tw, bh, bp.d * bp.bm // bh,
                    tuple(bh * tw * e for e in (*in_sizes, *out_sizes)),
                    smem, per_sm, steps, per, blocks)


def ring_sizes(name: str, dtype: torch.dtype) -> tuple[tuple, tuple, int]:
    """``(in_sizes, out_sizes, n_row)`` of body ``name``'s ring of type
    ``dtype``: each operand's element size, full-row outputs only, and
    the number of rank-1 outputs."""
    ins, outs, ranks, _ = SIGNATURES[name]

    def size(t):
        return 4 if t == "f32" else dtype.itemsize
    return (tuple(size(t) for t in ins),
            tuple(size(t) for t, r in zip(outs, ranks) if r == 2),
            sum(r == 1 for r in ranks))


def _ranks(spec: loopir.TraversalSpec) -> tuple:
    return tuple(len(w.index) for w in spec.writes)


def _refuse(spec: loopir.TraversalSpec) -> Optional[str]:
    """Why the ring has no kernel for ``spec`` on the card, or None."""
    if spec.name not in BODIES:
        return (f"no body for {spec.name!r} in the ring yet (ported: "
                f"{', '.join(BODIES)})")
    ins, _, ranks, _ = SIGNATURES[spec.name]
    if len(spec.reads) != len(ins) or _ranks(spec) != ranks:
        return (f"the ring's {spec.name!r} body reads {len(ins)} and "
                f"writes rank {ranks}; this spec reads {len(spec.reads)} "
                f"and writes rank {_ranks(spec)}")
    return None


def _ring_dtypes(name: str, arrays, out_dtypes) -> tuple:
    """``(T, each read's dtype, each write's dtype)`` that body ``name``
    takes for these operands; raises ``TypeError`` for a pairing no
    compiled instance takes."""
    ins, outs, _, compiled = SIGNATURES[name]
    t_ins = [x.dtype for x, t in zip(arrays, ins) if t == "T"]
    dtype = t_ins[0] if t_ins else out_dtypes[0]
    if dtype not in compiled:
        raise TypeError(f"{name} ring: no instance for {dtype} (compiled: "
                        f"{', '.join(map(str, compiled))})")

    def of(t):
        return torch.float32 if t == "f32" else dtype
    want_in = tuple(of(t) for t in ins)
    got = tuple(x.dtype for x in arrays)
    if got != want_in:
        raise TypeError(f"{name} ring: reads must be {want_in} for a ring "
                        f"of {dtype}, got {got}")
    return dtype, want_in, tuple(of(t) for t in outs)


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig, device=None, tile: Optional[int] = None):
    """Run a (padded) K4 spec: its output (``[rows, cols]``, or
    ``[rows]`` for a rank-1 write), or a tuple of them for a spec with
    several writes.  ``tile`` overrides :func:`ring_tile`'s column width
    (a sweep's)."""
    dev = arrays[0].device if arrays else torch.device(device)
    if dev.type != "cuda":
        return loopir.evaluate(spec, [*arrays, *scalars], device=dev)
    why = _refuse(spec)
    if why is not None:
        raise NotImplementedError(
            f"{spec.name}: the K4 template _emit_manual "
            f"(src/repro/codegen/emit.py:708) on Hopper: {why}. Use "
            "mode='ref' for the plain version.")
    dtype, in_dtypes, out_dtypes = _ring_dtypes(
        spec.name, arrays, spec.out_dtypes(arrays))
    ranks = _ranks(spec)
    outs = [torch.empty((bp.rows, bp.cols) if r == 2 else (bp.rows,),
                        dtype=dt, device=dev)
            for r, dt in zip(ranks, out_dtypes)]
    full = [o for o, r in zip(outs, ranks) if r == 2]
    shape = (bp.rows, bp.cols)
    for dt in {*in_dtypes, *out_dtypes}:     # one check per dtype group
        group = [t for t in [*arrays, *full] if t.dtype == dt]
        if group:
            cuda.check_operands(spec.name, group, [shape] * len(group))
    for o in outs:
        if o.ndim == 1:
            cuda.check_arrays(spec.name, [o], [(bp.rows,)])
    props = torch.cuda.get_device_properties(dev)
    plan = ring_plan(spec.name, dtype, bp, config,
                     props.multi_processor_count,
                     props.shared_memory_per_block_optin,
                     props.shared_memory_per_multiprocessor, tile)
    geometry = (bp.rows, bp.cols, bp.d, bp.bm, plan.bh, plan.tw,
                config.lookahead, plan.per)
    ptrs = [t.data_ptr() for t in arrays]
    optrs = [o.data_ptr() for o in outs]
    kernel = BODIES[spec.name]
    code = cuda.dtype_code(dtype)
    if spec.name == "stream_triad":
        kernel(dev, code, *ptrs, *optrs, float(scalars[0]), *geometry)
    elif spec.name == "stream_init":
        kernel(dev, code, *optrs, float(scalars[0]), *geometry)
    elif spec.name == "adamw_update":
        s = cuda.f32_scalars(scalars, dev)        # [7] on the card
        kernel(dev, code, *ptrs, s.data_ptr(), *optrs, *geometry)
    else:
        kernel(dev, code, *ptrs, *optrs, *geometry)
    return outs[0] if len(outs) == 1 else tuple(outs)
