"""Configuration planner: pick (stride_unroll, portion_unroll) per workload.

The paper explores the (D, P) space exhaustively per kernel (§6.3); the
planner encodes its empirical findings as a scoring model so that an op
given no config can pick one, as the JAX package's planner does
(``src/repro/core/planner.py``: the same candidate space, scoring and
tie-break):

  * D must divide the traversal extent (§5.1.2 divisibility), up to 16;
  * aliased (power-of-two) stream spacing is padded away (§4.5);
  * concurrent *write* streams are capped (write-buffer effect, §4.4);
  * the buffer budget bounds D·P: on the card, the shared memory one
    block may opt into (``roofline.hw.H100_HW.block_smem``), against
    which the always-resident operands count too.

Scores come from the card's stream model (``core.dma_model``).  Where a
``spec`` is given, every candidate is first gated as the JAX planner
gates it, through the static verifier (``repro_torch.analysis``: its
config-independent rules once per spec, then the per-config rules at
the traffic's dtype), and then through the port's own emitter
(``codegen.emit.check_config``): a config either one rejects is never
ranked, and each drop ticks the ``analysis.rejected_candidates``
counter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import layout
from repro_torch.core.dma_model import StreamModel, default_model
from repro_torch.core.striding import StridingConfig, valid_stride_unrolls
from repro_torch.roofline.hw import H100_HW

__all__ = ["Traffic", "Plan", "plan", "rank_configs", "traffic_bytes",
           "DEFAULT_BUDGET"]

# The per-block working budget (bytes): the shared memory one block of
# the hand kernels may opt into.
DEFAULT_BUDGET = H100_HW.block_smem


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


@dataclasses.dataclass(frozen=True)
class Plan:
    config: StridingConfig
    padded_cols: int           # collision-free pad-unit-aligned columns
    predicted_bw: float        # bytes/s from the stream model
    buffer_bytes: int          # the budget the config takes
    ranked: tuple = ()         # [(config, bw), ...] best-first (for sweeps)


def traffic_bytes(traffic: Traffic) -> int:
    """Total bytes one traversal moves (the denominator of effective
    bandwidth): every read/write stream touches rows × cols elements
    once, load/store streams twice, plus the resident operands."""
    body = traffic.rows * traffic.cols * layout.itemsize(traffic.dtype)
    return body * traffic.arrays_per_stride + traffic.resident_bytes


def _block_bytes(traffic: Traffic, portion: int, block_rows: int,
                 lay: layout.Layout) -> int:
    sub, lane = layout.unit_tile(traffic.dtype, lay)
    rows = block_rows or sub   # §5.1.1 cache block; default one unit
    return rows * lane * portion * layout.itemsize(traffic.dtype)


def _buffers(traffic: Traffic, cfg: StridingConfig,
             lay: layout.Layout) -> int:
    per_stream = _block_bytes(traffic, cfg.portion_unroll, cfg.block_rows,
                              lay) * cfg.lookahead
    return (cfg.stride_unroll * traffic.arrays_per_stride * per_stream
            + traffic.resident_bytes)


def _gate(spec, dtype):
    """``rejects(cfg)`` for a spec (or a tuple of them) at operands of
    ``dtype``: True where the static verifier finds an error (the
    config-independent rules checked once, here) or the port's emitter
    refuses the config, for any of them."""
    # imported here: the codegen and the analysis import the planner
    from repro_torch.analysis import checker
    from repro_torch.codegen import emit
    specs = spec if isinstance(spec, tuple) else (spec,)
    static_bad = any(f.severity == "error" for f in checker.check(specs))

    def rejects(cfg: StridingConfig) -> bool:
        if static_bad:
            return True
        if any(f.severity == "error"
               for f in checker.check(specs, cfg, dtype=dtype,
                                      static=False)):
            return True
        for s in specs:
            try:
                emit.check_config(s, cfg)
            except (ValueError, NotImplementedError, TypeError):
                return True
        return False
    return rejects


def rank_configs(traffic: Traffic,
                 model: Optional[StreamModel] = None,
                 budget: int = DEFAULT_BUDGET,
                 max_streams: int = 16,
                 max_unrolls: int = 32,
                 pad_layout: bool = True,
                 lookahead: int = 2,
                 block_rows_candidates: Sequence[int] = (0,),
                 spec=None,
                 ) -> list[tuple[StridingConfig, float, int]]:
    """All feasible configs scored best-first: [(config, bw, padded_cols)].

    ``block_rows_candidates`` adds the §5.1.1 cache-blocking dimension
    (0 = the emitter's default); a (block, D, P) point whose buffers
    exceed ``budget`` is pruned like a plain (D, P) point.  ``spec`` (a
    ``TraversalSpec`` or a tuple of them, at the traffic's shape) gates
    every candidate through the static verifier and the port's emitter.
    ``model=None`` scores with :func:`~repro_torch.core.dma_model.
    default_model`.  Raises ``ValueError`` when no config is feasible
    (every candidate over the budget or rejected by the gate)."""
    if model is None:
        model = default_model()
    lay = model.layout
    rejects = _gate(spec, traffic.dtype) if spec is not None else None
    size = layout.itemsize(traffic.dtype)
    out = []
    for d in valid_stride_unrolls(traffic.rows, max_d=max_streams):
        if pad_layout:
            cols, aliased = layout.conflict_free_cols(
                traffic.rows, traffic.cols, d, traffic.dtype, lay)
        else:
            cols = layout.pad_to_lane(traffic.cols, lay)
            aliased = False
        spacing = (traffic.rows // d) * cols * size
        if aliased:
            # the kernel would stagger its columns; spacing is de-aliased
            # by one block per stream (see layout.stream_stagger)
            spacing += lay.lane * size
        for p in (1, 2, 4, 8):
            if d * p > max_unrolls:
                continue
            for bm in block_rows_candidates:
                if bm and bm > max(traffic.rows // d, 1):
                    continue     # tile taller than a stream's segment
                cfg = StridingConfig(d, p, lookahead=lookahead,
                                     block_rows=bm)
                if _buffers(traffic, cfg, lay) > budget:
                    continue
                if rejects is not None and rejects(cfg):
                    obs.counter("analysis.rejected_candidates")
                    continue
                n_write = d * (traffic.write_arrays + traffic.rw_arrays)
                bw = model.throughput(cfg, _block_bytes(traffic, 1, bm, lay),
                                      spacing_bytes=spacing,
                                      n_write_streams=n_write)
                out.append((cfg, bw, cols))
    if not out:
        raise ValueError(f"no feasible striding config for {traffic}")
    # best bandwidth first; tie-break toward smaller D, P, then block
    out.sort(key=lambda t: (-t[1], t[0].stride_unroll, t[0].portion_unroll,
                            t[0].block_rows))
    return out


def plan(traffic: Traffic, **kw) -> Plan:
    ranked = rank_configs(traffic, **kw)
    cfg, bw, cols = ranked[0]
    model = kw.get("model") or default_model()
    return Plan(config=cfg, padded_cols=cols, predicted_bw=bw,
                buffer_bytes=_buffers(traffic, cfg, model.layout),
                ranked=tuple((c, b) for c, b, _ in ranked))
