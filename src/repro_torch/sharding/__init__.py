"""Sharding: the JAX package's rules on the port's names (``rules``),
the local shard of a leaf under a spec (``layout``) and the step's
counted collectives (``collectives``)."""
from repro_torch.sharding.rules import (MeshAxes, batch_specs, cache_specs,
                                        param_specs)

__all__ = ["param_specs", "batch_specs", "cache_specs", "MeshAxes"]
