"""The two instances of the ``*_gen`` family's own specs as CUDA kernels.

  * ``rowstat`` — ``csrc/reduction.cu`` ``rowstat``, replacing
    ``_emit_reduction`` (``src/repro/codegen/emit.py:491``) with the
    ``rowstat_spec`` body: the row max and the row sum in one sweep of x,
    two f32 ``[rows]`` outputs (the sum accumulated in f64, rounded
    once).  One wave of blocks of 8 warps, each walking a run of row
    slots (a slot: the D rows ``s + k·seg``); where the slots are too
    few for the wave, a slot's columns are cut into parts, a warp a
    part, merged in part order (:func:`rowstat_geometry`).  A lane loads
    16 bytes a unit (:func:`rowstat_units`) and keeps the next step's
    loads in flight while it folds the current one.
  * ``transpose`` — ``csrc/transpose.cu``, replacing ``_emit_streaming``
    (``src/repro/codegen/emit.py:410``) with the ``transpose_spec`` body:
    y = xᵀ, written ``[cols, rows]`` directly; each block stages one
    32 × 33 shared-memory tile of each of the D row segments and stores
    it transposed.

:func:`emit` launches the kernel on CUDA tensors (or raises) and runs
the plain version, the spec through ``loopir.evaluate``, on CPU tensors.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ROWSTAT", "TRANSPOSE", "RowstatGeometry", "rowstat_geometry",
           "rowstat_units", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# rowstat_launch(dtype, x, mx, sm, rows, cols, d, bm, parts, spb, grid,
#                interleaved, stream)
ROWSTAT = cuda.CudaKernel("rowstat", "reduction", "rowstat_launch",
                          [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I])
# transpose_launch(dtype, x, y, rows, cols, d, stream)
TRANSPOSE = cuda.CudaKernel("transpose", "transpose", "transpose_launch",
                            [_I, _P, _P, _I, _I, _I])


ROWSTAT_WARPS = 8              # warps a block (reduction.cu STAT_WARPS)
ROWSTAT_BLOCKS_PER_SM = 2      # the kernel's __launch_bounds__ minimum
ROWSTAT_MAX_STREAMS = 4        # rows a group (reduction.cu launch_stat)


@dataclass(frozen=True)
class RowstatGeometry:
    """One launch of ``csrc/reduction.cu`` ``rowstat``: ``streams`` rows
    a group (K, the smallest power of two up to D, at most
    ``ROWSTAT_MAX_STREAMS``; a step is ``8 / K`` units of each),
    ``parts`` warps a row slot, each taking ``per_part`` of a row's
    ``units`` 16-byte lane units (the last part fewer, and a 16-bit
    row's odd last sub-portion); ``blocks`` blocks, each walking
    ``slots`` consecutive row slots in rounds of ``ROWSTAT_WARPS /
    parts``."""
    streams: int
    parts: int
    units: int
    per_part: int
    slots: int
    blocks: int


def rowstat_geometry(rows: int, cols: int, itemsize: int, d: int,
                     sms: int, parts: int | None = None) -> RowstatGeometry:
    """The launch geometry for x ``[rows, cols]`` of ``itemsize`` bytes
    in ``d`` streams on a card of ``sms`` SMs.  The warps of one wave
    (``ROWSTAT_BLOCKS_PER_SM`` blocks an SM) take the ``rows / d`` row
    slots; the parts a slot double while the slots times the parts fit
    in that wave and each part keeps at least two steps of units.  A
    block walks a run of slots in whole rounds, so the grid stays within
    the wave.  ``parts`` (1, 2, 4 or 8) replaces the rule's, for a
    sweep."""
    seg = rows // d
    k = 1
    while k < min(d, ROWSTAT_MAX_STREAMS):
        k *= 2
    step = 8 // k
    per = 2 if itemsize == 2 else 1
    units = cols // LANE // per
    wave = ROWSTAT_BLOCKS_PER_SM * sms
    if parts is None:
        parts = 1
        while (parts < ROWSTAT_WARPS
               and seg * 2 * parts <= wave * ROWSTAT_WARPS
               and 2 * parts * 2 * step <= units):
            parts *= 2
    spr = ROWSTAT_WARPS // parts
    need = -(-seg // spr)
    spb = -(-need // min(need, wave)) * spr
    return RowstatGeometry(k, parts, units, -(-units // parts), spb,
                           -(-seg // spb))


def rowstat_units(nsub: int, itemsize: int,
                  parts: int) -> list[list[tuple[int, int]]]:
    """A lane's loads of one row in each of ``parts`` parts, as ``(first
    sub-portion, bytes)``: 16 bytes a unit, a sub-portion's 4 elements
    in f32 and a pair's 8 in 16-bit types; a 16-bit row's odd last
    sub-portion takes one 8-byte load in the last part."""
    per = 2 if itemsize == 2 else 1
    units = nsub // per
    upp = -(-units // parts)
    out = []
    for q in range(parts):
        u0 = min(units, q * upp)
        loads = [(u * per, 16) for u in range(u0, min(units, u0 + upp))]
        if q == parts - 1 and nsub % per:
            loads.append((nsub - 1, 8))
        out.append(loads)
    return out


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run the (padded) rowstat or transpose spec: ``(max, sum)`` f32
    ``[rows]`` each, or ``xᵀ`` in x's dtype."""
    (x,) = arrays
    if not x.is_cuda:
        return loopir.evaluate(spec, [x, *scalars])
    if spec.name == "rowstat":
        cuda.check_operands(spec.name, [x], [(bp.rows, bp.cols)])
        mx, sm = (torch.empty(bp.rows, dtype=torch.float32, device=x.device)
                  for _ in range(2))
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        g = rowstat_geometry(bp.rows, bp.cols, x.element_size(), bp.d, sms)
        interleaved = (config is not None
                       and config.arrangement == "interleaved")
        ROWSTAT(x.device, cuda.dtype_code(x.dtype), x.data_ptr(),
                mx.data_ptr(), sm.data_ptr(), bp.rows, bp.cols, bp.d, bp.bm,
                g.parts, g.slots, g.blocks, int(interleaved))
        return mx, sm
    if spec.name == "transpose":
        cuda.check_arrays(spec.name, [x], [(bp.rows, bp.cols)])
        y = torch.empty(bp.cols, bp.rows, dtype=x.dtype, device=x.device)
        TRANSPOSE(x.device, cuda.dtype_code(x.dtype), x.data_ptr(),
                  y.data_ptr(), bp.rows, bp.cols, bp.d)
        return y
    raise NotImplementedError(f"{spec.name}: not a gen-family instance")
