"""Shared kernel rules: device-driven dispatch, the device default of the
entry points, and config resolution.

Dispatch follows the tensor: a CUDA tensor runs the hand-written kernel
(or raises), a CPU tensor runs the kernel's plain PyTorch version.
``mode="ref"`` is the one explicit override, so tests and
``chip_smoke.py`` can run the plain version on the card for comparison;
no environment variable moves the main path off the kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.striding import StridingConfig

__all__ = ["kernel_mode", "resolve_device", "effective_config",
           "resolve_config", "example_input", "placeholder"]


def example_input(shape, key: int = 0, dtype=torch.float32,
                  device="cpu") -> torch.Tensor:
    """Deterministic example operand of the registry rows: standard
    normal f32 values drawn with ``numpy.random.default_rng(key)``, cast
    to ``dtype`` on ``device``.  (Not the JAX package's ``jax.random``
    draw: the port is held against that package on shared inputs, never
    against its recorded outputs.)"""
    x = np.random.default_rng(key).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def placeholder(shape, dtype=torch.float32) -> torch.Tensor:
    """An operand with a shape and a dtype and no data (``device="meta"``),
    for building a spec without inputs (a registry row's ``traversal``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def kernel_mode(x, mode: Optional[str] = None) -> str:
    """``"cuda"`` (hand kernel) for a CUDA tensor or device, ``"ref"``
    (plain version) for a CPU one or an explicit ``mode="ref"``."""
    if mode == "ref":
        return "ref"
    if mode is not None:
        raise ValueError(f"unknown kernel mode {mode!r}: pass None "
                         "(dispatch by device) or 'ref'")
    dev = x if isinstance(x, torch.device) else x.device
    if dev.type == "cuda":
        return "cuda"
    if dev.type == "cpu":
        return "ref"
    raise ValueError(f"no kernels for device {dev}")


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    With no card and no explicit ``device="cpu"`` this raises: nothing
    drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def effective_config(config: Optional[StridingConfig], rows: Optional[int],
                     default: StridingConfig) -> StridingConfig:
    """Clamp a config's stride_unroll to divide `rows` (``rows=None`` =
    no divisibility constraint — the kernel pads+crops instead)."""
    cfg = config or default
    if rows is None:
        return cfg
    d = cfg.stride_unroll
    while rows % d != 0:
        d -= 1
    if d != cfg.stride_unroll:
        cfg = cfg.replace(stride_unroll=max(d, 1))
    return cfg


def resolve_config(kernel: str, config: Optional[StridingConfig],
                   rows: Optional[int],
                   default: StridingConfig) -> StridingConfig:
    """Config resolution for an op wrapper: explicit config > static
    default, clamped so stride_unroll divides ``rows``.  (The tune
    cache and the planner of the JAX package are not ported yet.)"""
    cfg = effective_config(config, rows, default)
    if obs.enabled():
        obs.event("kernel.resolve", kernel=kernel,
                  source="explicit" if config is not None else "default",
                  d=cfg.stride_unroll, p=cfg.portion_unroll,
                  block_rows=cfg.block_rows, arrangement=cfg.arrangement)
    return cfg
