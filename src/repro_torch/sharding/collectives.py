"""Every collective the sharded train step runs, counted.

Each function here issues one ``torch.distributed`` collective and, while
a :func:`recording` block is open, records its kind, the bytes of its
operand, its group's size, its ring-model wire bytes (the bytes one
rank sends, as the JAX package's ``roofline.analysis.analyze_hlo``
reckons them from the HLO), its dtype and the mesh axis its group lies
along (``data`` for ZeRO-3's gathers, ``model`` for the tensor-parallel
layout steps, ...).  For a group of g ranks:

  * all-gather of an N-byte result: N (g - 1) / g;
  * reduce-scatter of an N-byte input: N (g - 1) / g (the JAX parser
    takes the HLO's result, N / g, and divides by g once more);
  * all-reduce of N bytes: 2 N (g - 1) / g;
  * all-to-all of N bytes: N (g - 1) / g.

A group of one rank moves nothing and is not called.  NCCL runs them
across cards; gloo runs them on CPU tensors and on CUDA tensors alike
(``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` with gloo on CUDA tensors, int8 included, checked
on the card's torch 2.11), so nothing is staged through the host.
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` are the names
torch 2.11 has; later versions warn that they are deprecated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch

__all__ = ["Record", "recording", "all_gather", "reduce_scatter",
           "all_reduce", "all_to_all", "summarize"]


@dataclasses.dataclass(frozen=True)
class Record:
    kind: str                # "all-gather" | "reduce-scatter" | ...
    operand_bytes: int       # the bytes this rank hands the collective
    group_size: int
    wire_bytes: float        # ring model, bytes this rank sends
    dtype: str = ""          # the operand's, e.g. "int8"
    axis: str = ""           # the mesh axis of the group, "" for another


_OPEN: list[list[Record]] = []


@contextlib.contextmanager
def recording() -> Iterator[list[Record]]:
    """Collect a :class:`Record` of every collective issued inside the
    block (nested blocks each see them all)."""
    log: list[Record] = []
    _OPEN.append(log)
    try:
        yield log
    finally:
        _OPEN.remove(log)


def _note(kind: str, t: torch.Tensor, operand: int, g: int,
          wire: float, axis: str) -> None:
    rec = Record(kind, operand, g, wire, str(t.dtype).removeprefix("torch."),
                 axis)
    for log in _OPEN:
        log.append(rec)


def _size(group) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(out: torch.Tensor, inp: torch.Tensor, group,
               axis: str = "") -> torch.Tensor:
    """``out`` [g · n] ← every rank's ``inp`` [n], in rank order."""
    import torch.distributed as dist
    g = _size(group)
    dist.all_gather_into_tensor(out, inp, group=group)
    _note("all-gather", inp, _nbytes(inp), g, _nbytes(out) * (g - 1) / g,
          axis)
    return out


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                   axis: str = "") -> torch.Tensor:
    """``out`` [n] ← the sum over ranks of this rank's slice of ``inp``
    [g · n]."""
    import torch.distributed as dist
    g = _size(group)
    dist.reduce_scatter_tensor(out, inp, group=group)
    _note("reduce-scatter", inp, _nbytes(inp), g,
          _nbytes(inp) * (g - 1) / g, axis)
    return out


def all_reduce(t: torch.Tensor, group, op: str = "sum",
               axis: str = "") -> torch.Tensor:
    """``t`` ← its sum (or ``op="max"``: maximum) over the group, in
    place."""
    import torch.distributed as dist
    g = _size(group)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    _note("all-reduce", t, _nbytes(t), g, 2 * _nbytes(t) * (g - 1) / g,
          axis)
    return t


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group,
               axis: str = "") -> torch.Tensor:
    """``out`` [g · n]: chunk r of ``inp`` goes to rank r, and chunk r of
    ``out`` comes from rank r."""
    import torch.distributed as dist
    g = _size(group)
    dist.all_to_all_single(out, inp, group=group)
    _note("all-to-all", inp, _nbytes(inp), g, _nbytes(inp) * (g - 1) / g,
          axis)
    return out


def summarize(log: list[Record]) -> dict:
    """The collective keys of the JAX package's ``analyze_hlo``:
    operand and wire bytes by kind and their totals; and the wire bytes
    by mesh axis (``collective_wire_bytes_by_axis``)."""
    operand: dict[str, float] = {}
    wire: dict[str, float] = {}
    by_axis: dict[str, float] = {}
    for r in log:
        operand[r.kind] = operand.get(r.kind, 0.0) + r.operand_bytes
        wire[r.kind] = wire.get(r.kind, 0.0) + r.wire_bytes
        by_axis[r.axis] = by_axis.get(r.axis, 0.0) + r.wire_bytes
    return {"collective_operand_bytes": operand,
            "collective_wire_bytes": wire,
            "collective_wire_bytes_by_axis": by_axis,
            "total_wire_bytes": sum(wire.values()),
            "total_collective_operand_bytes": sum(operand.values())}
