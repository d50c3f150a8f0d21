"""Kernel registry: one :class:`KernelSpec` per public op, and the
kernel × (D, P) conformance matrix derived from it.

  KernelSpec / register        — declare a kernel variant (one per op)
  get / names / families /
  all_specs / family_specs     — query the registry
  conformance_points           — the kernel × (D, P) matrix

The JAX package's tune cache and autotuner are not ported yet.
"""
from repro_torch.registry.base import (CONFORMANCE_CONFIGS, FAMILIES,
                                       KernelSpec, all_specs,
                                       conformance_points, families,
                                       family_specs, get, names, register,
                                       registered_ops)

__all__ = [
    "KernelSpec", "register", "get", "names", "families", "all_specs",
    "family_specs", "registered_ops", "conformance_points", "FAMILIES",
    "CONFORMANCE_CONFIGS",
]
