"""Runtime services the serving engine uses: straggler detection,
heartbeats, the restart policy and deterministic fault injection."""
from repro_torch.runtime.fault_tolerance import (HeartbeatRegistry,
                                                 RestartPolicy, StepMonitor)

__all__ = ["HeartbeatRegistry", "RestartPolicy", "StepMonitor"]
