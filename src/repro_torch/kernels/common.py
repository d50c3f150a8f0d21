"""Shared kernel rules: device-driven dispatch, the device default of the
entry points, config resolution (explicit > tuned > planned > default)
and guarded dispatch.

Dispatch follows the tensor: a CUDA tensor runs the hand-written kernel
(or raises), a CPU tensor runs the kernel's plain PyTorch version.
``mode="ref"`` is the one explicit override, so tests and
``chip_smoke.py`` can run the plain version on the card for comparison;
no environment variable moves the main path off the kernels.

:func:`guarded_run` is the JAX package's guard (``src/repro/kernels/
common.py:260``) with a chain of its own on the card: a config whose
launch fails is quarantined and the next-ranked configs (the same hand
kernel at another D, P, ``block_rows``) are tried, never the plain
version; see its docstring.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.striding import SINGLE_STRIDED, StridingConfig
from repro_torch.registry import tunecache

__all__ = ["kernel_mode", "resolve_device", "effective_config",
           "resolve_config", "resolve_for", "reset_plan_memo",
           "example_input", "placeholder", "classify_failure",
           "unrecoverable", "exact_config", "guarded_run"]


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


# ------------------------------------------------- guarded dispatch

# failure classes the guard distinguishes (recorded in the quarantine
# entry and the kernel.fallback event), as the JAX package's:
#   injected        — runtime.faults fired at an injection point
#   analysis        — the static verifier rejected the plan before any
#                     launch (analysis: race/bounds/shared-memory rules)
#   unsupported     — the emitter has no kernel for (spec, config)
#   resource        — the card's resources: registers or shared memory
#                     for a launch, device memory
#   invalid_config  — config rejected by validation (ValueError & kin)
#   backend         — any other CUDA or runtime failure
_RESOURCE_MARKERS = (
    "too many resources requested for launch",   # cudaErrorLaunchOutOf-
                                                  # Resources (701)
    "out of memory",                    # torch.OutOfMemoryError, CUDA 2
    "does not fit shared memory",       # the K4 ring's launcher refusing
                                        # an opt-in above block_smem
)

# what a CUDA error that poisons the context says (cudaGetErrorString
# of cuda.STICKY_ERRORS), wherever it surfaces — a launcher's return or
# PyTorch's check at a later call
_POISONED_MARKERS = (
    "an illegal memory access was encountered",
    "device-side assert triggered",
    "hardware stack error",
    "an illegal instruction was encountered",
    "misaligned address",
    "operation not supported on global/shared address space",
    "invalid program counter",
    "unspecified launch failure",
)


def classify_failure(exc: BaseException) -> str:
    """Map a kernel launch failure onto a degradation class."""
    from repro_torch.analysis.findings import AnalysisError
    from repro_torch.runtime.faults import InjectedFault
    if isinstance(exc, InjectedFault):
        return "injected"
    if isinstance(exc, AnalysisError):
        # checked before the marker scan: a RES001 finding's message
        # names shared memory
        return "analysis"
    if isinstance(exc, NotImplementedError):
        return "unsupported"
    msg = str(exc).lower()
    if any(m in msg for m in _RESOURCE_MARKERS):
        return "resource"
    if isinstance(exc, (ValueError, TypeError)):
        return "invalid_config"
    return "backend"


def unrecoverable(exc: BaseException) -> bool:
    """Whether no other config can fix ``exc``: a kernel source that does
    not build (``cuda.BuildError``), the card out of device memory
    (``torch.cuda.OutOfMemoryError``: the outputs a call allocates do not
    depend on D, P or ``block_rows``, and the shortage may pass), or a
    CUDA error that leaves the context unusable (``cuda.STICKY_ERRORS``:
    an illegal address, a launch failure, …), by code where a launcher
    returned it, else by its message.  :func:`guarded_run` re-raises
    these at once: a bad build would otherwise quarantine every config
    of its kernel, a passing shortage quarantine a config for good, and
    a poisoned context run every tier into the same error."""
    from repro_torch.kernels import cuda
    if isinstance(exc, (cuda.BuildError, torch.cuda.OutOfMemoryError)):
        return True
    if isinstance(exc, cuda.LaunchError):
        return exc.code in cuda.STICKY_ERRORS
    msg = str(exc).lower()
    return any(m in msg for m in _POISONED_MARKERS)


def _fallback_tiers(cache, qkey: str, failed: StridingConfig,
                    rows: Optional[int], traffic, spec=None) -> list:
    """Up to two next-ranked planner configs (the checker-gated ranking
    of ``traffic``) other than ``failed`` and not quarantined under
    ``qkey``: the configs the chain tries after ``failed``."""
    if traffic is None:
        return []
    from repro_torch.core.planner import rank_configs
    try:
        ranked = [c for c, _bw, _cols in rank_configs(traffic, spec=spec)]
    except ValueError:
        return []
    tiers = []
    seen = {(failed.stride_unroll, failed.portion_unroll, failed.block_rows)}
    for cand in ranked:
        cand = effective_config(cand, rows, cand)
        key = (cand.stride_unroll, cand.portion_unroll, cand.block_rows)
        if key in seen or cache.is_quarantined(qkey, cand):
            continue
        seen.add(key)
        tiers.append(cand)
        if len(tiers) == 2:
            break
    return tiers


_EXACT = contextvars.ContextVar("repro_torch_exact_config", default=False)


@contextlib.contextmanager
def exact_config() -> Iterator[None]:
    """Within the block :func:`guarded_run` runs the config it is given
    and nothing else: a failure re-raises untouched, with nothing
    quarantined and no tier tried.  For a caller that measures or
    checks one config by name (the autotuner's trials), to which a
    result served by another config would be a wrong answer."""
    token = _EXACT.set(True)
    try:
        yield
    finally:
        _EXACT.reset(token)


def guarded_run(kernel: str, run, cfg: StridingConfig, mode: str, *,
                shape, dtype, device=None, rows: Optional[int] = None,
                traffic=None, spec=None):
    """Execute ``run(cfg, mode)`` behind the fallback chain.

    ``mode`` is the kernel mode the call runs in (:func:`kernel_mode`).
    ``ref`` — asked for, or chosen because the tensors lie on the CPU —
    has no guard at all: ``run`` is called once and a failure re-raises
    untouched, as in the JAX package.

    On the card a failure is classified (:func:`classify_failure`), the
    failing config is quarantined in the tune cache under the key
    resolution uses (``tunecache.cache_key(kernel, shape, dtype, device,
    mode)``, so it is never resolved again), and up to two next-ranked
    configs that are not quarantined are tried: each the same hand
    kernel at another (D, P, ``block_rows``), ranked by the planner from
    ``traffic`` with ``spec`` gating the candidates through the static
    verifier.  The first that succeeds serves the result, with one
    ``kernel.fallback`` event (tier ``alt_config``) and a
    ``kernel.fallback.count`` tick; a tier that fails is quarantined
    too.  When no tier is left, the original exception is re-raised.

    The chain deliberately differs from the JAX package's (alt_config ×2
    → interpret → ref): the port has no interpret mode, and a kernel
    that quietly gave way to its plain version would hide its fault, so
    no tier ever runs the plain version.  Three kinds of failure are
    re-raised at once, with nothing quarantined and no tier tried: a
    source that does not build, the card out of memory and a CUDA error
    that poisons the context (:func:`unrecoverable`), and under
    :func:`exact_config` every failure is.  A config already quarantined
    under the key is not written again, so a caller that repeats a
    rejected config by name does not rewrite the tune cache.

    The ``lower`` fault site fires before every attempt on the card,
    so ``faults.inject("lower:<kernel>")`` forces the chain.  The tune
    cache is opened only on a failure: a call that succeeds costs a
    ``None`` check more than ``run`` itself."""
    if mode == "ref":
        return run(cfg, mode)
    from repro_torch.runtime import faults

    def attempt(c: StridingConfig):
        faults.fire_if("lower", kernel)
        return run(c, mode)

    if _EXACT.get():
        return attempt(cfg)
    try:
        return attempt(cfg)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as exc:       # noqa: BLE001 — classified below
        if unrecoverable(exc):
            raise
        failure = classify_failure(exc)
        cache = tunecache.default_cache()
        qkey = tunecache.cache_key(kernel, shape, dtype, device, mode)
        if not cache.is_quarantined(qkey, cfg):
            cache.quarantine(qkey, cfg, failure)
        obs.counter("kernel.fallback.count", kernel=kernel)
        for tcfg in _fallback_tiers(cache, qkey, cfg, rows, traffic, spec):
            try:
                out = attempt(tcfg)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc2:  # noqa: BLE001 — next tier
                if unrecoverable(exc2):
                    raise
                cache.quarantine(qkey, tcfg, classify_failure(exc2))
                continue
            obs.event("kernel.fallback", kernel=kernel, failure=failure,
                      tier="alt_config", from_mode=mode, to_mode=mode,
                      failed_d=cfg.stride_unroll,
                      failed_p=cfg.portion_unroll,
                      failed_block_rows=cfg.block_rows,
                      d=tcfg.stride_unroll, p=tcfg.portion_unroll)
            return out
        raise exc
