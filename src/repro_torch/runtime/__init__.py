"""Runtime services: straggler detection, heartbeats, the restart policy,
deterministic fault injection and elastic re-meshing.

``plan_mesh`` and ``remesh_state`` are imported lazily (PEP 562), as the
JAX package's are: ``runtime.faults`` is consulted from low-level layers
whose import must not drag in the mesh and checkpoint stack."""
from repro_torch.runtime.fault_tolerance import (HeartbeatRegistry,
                                                 RestartPolicy, StepMonitor)

__all__ = ["HeartbeatRegistry", "RestartPolicy", "StepMonitor",
           "plan_mesh", "remesh_state"]


def __getattr__(name):
    import importlib
    if name in ("plan_mesh", "remesh_state"):
        return getattr(importlib.import_module("repro_torch.runtime.elastic"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
