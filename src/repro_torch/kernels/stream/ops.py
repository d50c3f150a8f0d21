"""Wrappers for the stream micro-kernels (paper §4).

Every wrapper lowers the family's ``TraversalSpec`` (``specs.py``)
through ``repro_torch.codegen.run_spec``: the hand-written kernels on
the card, the plain versions on the CPU or with ``mode="ref"``.  Config
resolution is explicit > tuned > planned > default on the array's
Traffic (the JAX wrappers' read and write arrays), with D clamped to
divide the rows.  A ``lookahead`` other than 2 selects the K4 ring for
copy, triad and init (``kernels/manual.py``), as in the JAX package; the
read is K2 at any lookahead.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.stream import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=2)


def _resolve(kernel: str, shape, dtype, config: Optional[StridingConfig],
             mode: Optional[str], device, read_arrays: int,
             write_arrays: int) -> StridingConfig:
    rows, cols = shape
    traffic = Traffic(rows=rows, cols=cols, dtype=dtype,
                      read_arrays=read_arrays, write_arrays=write_arrays)
    return common.resolve_config(
        kernel, shape, dtype, config, rows, _DEFAULT,
        traffic=None if config is not None else traffic,
        mode=common.kernel_mode(device, mode), device=device)


def stream_read(x: torch.Tensor, config: Optional[StridingConfig] = None,
                mode: Optional[str] = None) -> torch.Tensor:
    """Per-stream checksums of a [rows, cols] array (paper §4.3 reads):
    ``[D]`` f32, D from the resolved config."""
    cfg = _resolve("stream_read", x.shape, x.dtype, config, mode, x.device,
                   1, 0)
    d = cfg.stride_unroll
    rows, cols = x.shape
    x2 = x.reshape(d, (rows // d) * cols)   # one row per concurrent stream
    return run_spec(specs.read_spec, (x2,), cfg, mode)


def stream_copy(x: torch.Tensor, config: Optional[StridingConfig] = None,
                mode: Optional[str] = None) -> torch.Tensor:
    """y = x (paper §4.6 copy)."""
    cfg = _resolve("stream_copy", x.shape, x.dtype, config, mode, x.device,
                   1, 1)
    return run_spec(specs.copy_spec, (x,), cfg, mode)


def stream_init(shape: tuple[int, int], value=0.0, dtype=torch.float32,
                config: Optional[StridingConfig] = None,
                mode: Optional[str] = None, device=None) -> torch.Tensor:
    """Fill (paper 'init' kernel, Table 1): a writes-only spec — zero
    read streams, D strided store positions.  It makes its tensor on
    ``device``: the card unless ``device="cpu"``; with no card and no
    explicit CPU it raises."""
    dev = common.resolve_device(device)
    cfg = _resolve("stream_init", tuple(shape), dtype, config, mode, dev,
                   0, 1)
    build = functools.partial(specs.init_spec, tuple(shape), dtype)
    return run_spec(build, (value,), cfg, mode, device=dev)


def stream_copy_manual(x: torch.Tensor,
                       config: Optional[StridingConfig] = None,
                       mode: Optional[str] = None) -> torch.Tensor:
    """Copy through the explicit multi-buffered ring: a ``lookahead``
    other than 2 selects the K4 template (``csrc/manual_ring.cu``;
    lookahead=1 = the prefetch-off ablation); lookahead=2 is the K1
    copy, as in the JAX package."""
    cfg = _resolve("stream_copy_manual", x.shape, x.dtype, config, mode,
                   x.device, 1, 1)
    return run_spec(specs.copy_spec, (x,), cfg, mode)
