"""Layout rules: the stream unit, the pad rule and the paper's §4.5
collision model, with their constants taken from one machine description.

The paper finds that D concurrent streams spaced at an exact large power
of two collide (on its CPU, in the same cache sets: 2 GiB arrays
collapse, 1.9 GiB ones do not) and pads the rows to break the power of
two.  These functions keep the JAX package's rules
(``src/repro/core/layout.py``) as they are; what differs from machine to
machine is three constants, held by a :class:`Layout`:

  * the *unit*: what one stream moves in one step, ``unit_rows[itemsize]``
    rows of ``lane`` elements;
  * the *pad unit*: rows are padded to whole ``lane`` elements;
  * the *aliasing granularity*: streams collide when their spacing is an
    exact power of two of at least ``2**alias_bits`` bytes (``None``: no
    spacing collides).

:data:`H100_LAYOUT` is the card's.  Its unit is what a stream of the
port's hand kernels moves per step: one warp of 16-byte lanes, 512 bytes
in every type (``csrc/common.cuh``'s row sweep loads a 128-element
sub-portion a warp, 16 bytes a lane in f32; the 16-bit kernels load a
pair of sub-portions per 16-byte lane); the pad unit is the 128-element
sub-portion the row kernels take whole (``kernels/cuda.py``
``check_operands``).  Its aliasing granularity is fitted to the pitch
sweep of ``tools/torch_stream_fit.py`` (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

__all__ = ["Layout", "H100_LAYOUT", "itemsize", "unit_tile", "pad_to_lane",
           "aliasing_exponent", "collides", "conflict_free_cols",
           "stream_stagger", "buffer_bytes"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """The three layout constants of one machine (see the module doc)."""

    lane: int                          # pad unit, elements
    unit_rows: Mapping[int, int]       # itemsize → rows of one stream unit
    alias_bits: Optional[int]          # None: no spacing collides


# The pitch sweep of tools/torch_stream_fit.py on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §6): at row pitches of 2^k bytes (2 KiB to
# 128 KiB, four streams an exact power of two apart) the K1 copy took no
# longer a byte than at 2^k + 1024 B, and the stencil at most 2.8% longer
# (at 2 KiB, where the wider row's tiles differ; 0.4% from 32 KiB), so no
# spacing collides on this card.
H100_LAYOUT = Layout(lane=128, unit_rows={4: 1, 2: 2, 1: 4}, alias_bits=None)


def itemsize(dtype) -> int:
    """Bytes of one element of a torch dtype."""
    return torch.empty((), dtype=dtype).element_size()


def unit_tile(dtype, layout: Layout = H100_LAYOUT) -> tuple[int, int]:
    """One stream unit of ``dtype`` as (rows, lane elements)."""
    size = itemsize(dtype)
    if size not in layout.unit_rows:
        raise ValueError(f"unsupported itemsize {size} for dtype {dtype}")
    return (layout.unit_rows[size], layout.lane)


def pad_to_lane(n: int, layout: Layout = H100_LAYOUT) -> int:
    """Round n up to a multiple of the pad unit."""
    return -(-n // layout.lane) * layout.lane


def aliasing_exponent(spacing_bytes: int) -> int:
    """Largest e such that 2**e divides spacing_bytes (0 spacing → 63)."""
    if spacing_bytes == 0:
        return 63
    return int(spacing_bytes & -spacing_bytes).bit_length() - 1


def collides(spacing_bytes: int, layout: Layout = H100_LAYOUT) -> bool:
    """Paper §4.5: concurrent streams spaced at an *exact* power of two
    (at least the aliasing granularity) compete for the same sets or
    banks; a single odd factor (the paper's row padding) de-aliases."""
    if layout.alias_bits is None or spacing_bytes < (1 << layout.alias_bits):
        return False
    return (spacing_bytes & (spacing_bytes - 1)) == 0


def conflict_free_cols(rows: int, cols: int, d: int, dtype,
                       layout: Layout = H100_LAYOUT,
                       max_pad_tiles: int = 8) -> tuple[int, bool]:
    """Padded column count so d streams over a row-major [rows, cols]
    array do not alias, and a residual-alias flag.

    If the inter-stream spacing (rows // d) · row bytes collides, pad each
    row by whole pad units to break the power of two.  When no pad of up
    to ``max_pad_tiles`` units helps, return ``aliased=True`` and leave
    the kernel a per-stream column stagger (:func:`stream_stagger`).
    Returns (pad-unit-aligned cols >= cols, still_aliased)."""
    size = itemsize(dtype)
    cols = pad_to_lane(cols, layout)
    if d <= 1:
        return cols, False
    seg = rows // d
    for pad in range(max_pad_tiles + 1):
        c = cols + pad * layout.lane
        if not collides(seg * c * size, layout):
            return c, False
    return cols, True


def stream_stagger(d: int, spacing_bytes: int, block_bytes: int,
                   layout: Layout = H100_LAYOUT) -> int:
    """Per-stream column-block rotation (in blocks) breaking residual
    aliasing: 0 when none is needed, else the smallest stagger whose
    offset de-aliases the streams."""
    if d <= 1 or not collides(spacing_bytes, layout):
        return 0
    for s in range(1, 8):
        if not collides(spacing_bytes + s * block_bytes, layout):
            return s
    return 1  # best effort: any non-zero rotation spreads demand in time


def buffer_bytes(block_shape: tuple[int, ...], dtype,
                 n_buffers: int = 2) -> int:
    """Bytes of one stream's ring of ``n_buffers`` blocks."""
    return math.prod(block_shape) * itemsize(dtype) * n_buffers
