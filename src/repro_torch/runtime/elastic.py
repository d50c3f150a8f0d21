"""Elastic re-meshing: continue after losing ranks with a smaller mesh,
the JAX package's ``repro/runtime/elastic.py`` over ``torch.distributed``.

Checkpoints store unsharded leaves (``checkpoint.manager``), so
restoring onto another mesh only needs the shardings of the new mesh:
each rank reads its piece of every leaf.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import state_shardings

__all__ = ["plan_mesh", "remesh_state"]


def plan_mesh(n_devices: int, model_parallel: int = 16,
              pods: int = 1) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) shape fitting n_devices.

    Keeps the model axis fixed (param layout / TP degree stable so the
    sharding rules stay divisible) and shrinks the data axis — losing a
    host costs one data-parallel row, not a re-plan of TP.
    """
    while model_parallel > 1 and n_devices % model_parallel:
        model_parallel //= 2
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(f"{n_devices} devices cannot host "
                         f"model_parallel={model_parallel}")
    if pods > 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def remesh_state(manager, cfg, state_sds_fn: Callable[[], dict],
                 n_devices: int, model_parallel: int = 16, pods: int = 1,
                 step: Optional[int] = None, device=None):
    """Restore the latest checkpoint (or ``step``) onto a freshly planned
    mesh over the ``n_devices`` ranks of the default process group.

    manager: ``CheckpointManager``; state_sds_fn: () → the whole state on
    meta (``launch.steps.abstract_state``), for the sharding rules and
    the leaves' shapes.  Returns (step, this rank's pieces of the state
    tree on ``device``, mesh); ``trainstep.load_state_tree`` copies them
    into a state sharded on that mesh."""
    shape, axes = plan_mesh(n_devices, model_parallel, pods)
    mesh = make_mesh(shape, axes)
    shardings = state_shardings(state_sds_fn(), cfg, mesh)
    step, state = manager.restore(step=step, device=device,
                                  shardings=shardings)
    return step, state, mesh
