"""Shared kernel rules: device-driven dispatch, the device default of the
entry points, and config resolution (explicit > tuned > planned >
default).

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
from repro_torch.core.striding import SINGLE_STRIDED, StridingConfig
from repro_torch.registry import tunecache

__all__ = ["kernel_mode", "resolve_device", "effective_config",
           "resolve_config", "resolve_for", "reset_plan_memo",
           "example_input", "placeholder"]


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


# Planner results are pure in (kernel, shape, dtype, device type) and
# memoized, so a hot loop (adamw per tensor per step, ~150 op calls a
# decode step) does not rank again on every call.  A whole resolution
# with no config given is memoized too, against the tune cache's
# version, so a fresh tune or quarantine wins at the next call while a
# call that finds nothing changed costs a few dict lookups (resolving
# in full on every call cost a Yi-9B decode step about 60 ms of host
# time on the card's host: PERF.md §6).
_plan_memo: dict[tuple, Optional[StridingConfig]] = {}
_resolved: dict[tuple, tuple[int, StridingConfig, str]] = {}


def reset_plan_memo() -> None:
    """Drop memoized planner results and resolutions (pair with
    ``tunecache.reset_default_cache()``)."""
    _plan_memo.clear()
    _resolved.clear()


def _device_type(mode: Optional[str], device) -> str:
    if isinstance(device, torch.device):
        return device.type
    if device is not None:
        return torch.device(device).type
    return "cuda" if mode == "cuda" else "cpu"


def resolve_config(kernel: str, shape, dtype,
                   config: Optional[StridingConfig], rows: Optional[int],
                   default: StridingConfig, traffic=None,
                   mode: Optional[str] = None, device=None,
                   spec=None) -> StridingConfig:
    """Config resolution chain for an op wrapper (paper §6.3 policy), as
    the JAX package's (``src/repro/kernels/common.py:107``):

        explicit config  >  tune cache (measured best)  >  planner model
        >  static default

    ``mode`` is the kernel mode the call runs in (``"cuda"`` or
    ``"ref"``, :func:`kernel_mode`) and ``device`` its tensors' device:
    together they pick the tune cache's key.  The planner runs only where
    the wrapper passes a ``traffic`` signature (as its JAX counterpart
    does), once per (kernel, shape, dtype, device type); ``spec`` gates
    its candidates through the emitter.  The result is clamped so
    stride_unroll divides ``rows`` (``rows=None``: the kernel's pad and
    crop make any D valid).  A config quarantined under the call's key
    is never returned: the next planner-ranked one, the static default
    or single-strided takes its place.

    A resolution is memoized against the tune cache's version
    (:meth:`~repro_torch.registry.tunecache.TuneCache.version`): a store
    or quarantine through the cache shows at the next call, another
    process's within ``tunecache.RECHECK_S``.

    With telemetry on, every call emits one ``kernel.resolve`` event
    recording which source won and the resolved config, plus
    ``kernel.plan_memo.hit`` / ``.miss`` counters for the planner memo.
    """
    if config is None:
        cache = tunecache.default_cache()
        mkey = (kernel, tuple(shape), dtype, rows, default, mode, device)
        version = cache.version()
        hit = _resolved.get(mkey)
        if hit is not None and hit[0] == version:
            cfg, source = hit[1:]
        else:
            cfg, source = _resolve(cache, kernel, shape, dtype, rows,
                                   default, traffic, mode, device, spec)
            _resolved[mkey] = (version, cfg, source)
    else:
        cfg, source = effective_config(config, rows, default), "explicit"
    if obs.enabled():
        obs.event("kernel.resolve", kernel=kernel, source=source,
                  d=cfg.stride_unroll, p=cfg.portion_unroll,
                  block_rows=cfg.block_rows, arrangement=cfg.arrangement,
                  mode=mode)
    return cfg


def _resolve(cache, kernel: str, shape, dtype, rows: Optional[int],
             default: StridingConfig, traffic, mode: Optional[str], device,
             spec) -> tuple[StridingConfig, str]:
    """The chain below an explicit config: (config, source)."""
    source = "default"
    config = cache.config_for(kernel, shape, dtype, mode=mode,
                              device=device)
    if config is not None:
        source = "tuned"
    elif traffic is not None:
        key = (kernel, tuple(shape), dtype, _device_type(mode, device))
        if key in _plan_memo:
            config = _plan_memo[key]
            obs.counter("kernel.plan_memo.hit", kernel=kernel)
        else:
            from repro_torch.core.planner import plan
            try:
                config = plan(traffic, spec=spec).config
            except ValueError:
                config = None
            _plan_memo[key] = config
            obs.counter("kernel.plan_memo.miss", kernel=kernel)
        if config is not None:
            source = "planned"
    cfg = effective_config(config, rows, default)
    # a config recorded as failing is never resolved again: the tuned
    # source already skips quarantined entries; this guards the planned
    # and default sources (against the file config_for read)
    qkey = tunecache.cache_key(kernel, shape, dtype, device, mode)
    if cache.is_quarantined(qkey, cfg, reload=False):
        cfg = _next_unquarantined(cache, qkey, rows, default, traffic, spec)
        source = "quarantine_alt"
        obs.counter("kernel.quarantine_skip", kernel=kernel)
    return cfg, source


def resolve_for(kernel: str, lead: torch.Tensor,
                config: Optional[StridingConfig], rows: Optional[int],
                default: StridingConfig, traffic=None,
                mode: Optional[str] = None, spec=None) -> StridingConfig:
    """:func:`resolve_config` for an op whose lead operand is ``lead``:
    its shape, dtype and device key the tune cache, and ``mode`` (the
    op's argument: None or ``"ref"``) becomes the kernel mode the call
    runs in.  The Traffic goes to the planner only when no config is
    given, as in the JAX package's wrappers."""
    return resolve_config(kernel, lead.shape, lead.dtype, config, rows,
                          default,
                          traffic=None if config is not None else traffic,
                          mode=kernel_mode(lead, mode), device=lead.device,
                          spec=spec)


def _next_unquarantined(cache, qkey: str, rows: Optional[int],
                        default: StridingConfig, traffic,
                        spec=None) -> StridingConfig:
    """Best non-quarantined alternative: the next planner-ranked configs,
    then the static default, then single-strided (the most conservative
    point, kept as the floor even if it too is quarantined: resolution
    must return a config)."""
    cands = []
    if traffic is not None:
        from repro_torch.core.planner import rank_configs
        try:
            cands = [c for c, _bw, _cols in rank_configs(traffic, spec=spec)]
        except ValueError:
            cands = []
    cands += [default, SINGLE_STRIDED]
    for cand in cands:
        cand = effective_config(cand, rows, cand)
        if not cache.is_quarantined(qkey, cand):
            return cand
    return SINGLE_STRIDED
