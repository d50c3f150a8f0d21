"""Kernel registry + empirical (D, P) autotuner.

  KernelSpec / register        — declare a kernel variant (one per op)
  get / names / families /
  all_specs / family_specs     — query the registry
  conformance_points           — the kernel × (D, P) matrix
  tune / tune_all              — measured sweeps over planner candidates
  TuneCache / cached_config    — the on-disk measured-config store
"""
from repro_torch.registry.autotune import TuneResult, tune, tune_all
from repro_torch.registry.base import (CONFORMANCE_CONFIGS, FAMILIES,
                                       KernelSpec, all_specs,
                                       conformance_points, families,
                                       family_specs, get, names, register,
                                       registered_ops)
from repro_torch.registry.tunecache import (TuneCache, cache_key,
                                            cached_config, default_cache,
                                            reset_default_cache)

__all__ = [
    "KernelSpec", "register", "get", "names", "families", "all_specs",
    "family_specs", "registered_ops", "conformance_points", "FAMILIES",
    "CONFORMANCE_CONFIGS",
    "tune", "tune_all", "TuneResult",
    "TuneCache", "cache_key", "cached_config", "default_cache",
    "reset_default_cache",
]
