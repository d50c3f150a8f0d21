"""Device meshes over the default ``torch.distributed`` process group.
Functions, not module constants: importing this module touches no
device and no process group.

A mesh's device type follows the group's backend: ``cuda`` under NCCL
(one rank a card, as ``torchrun --nproc-per-node K`` starts them),
``cpu`` under gloo, whose collectives take CPU and CUDA tensors alike.
"""
from __future__ import annotations

import math

__all__ = ["make_mesh", "make_production_mesh"]


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over every
    rank of the initialised default group; raises where the shape's
    product is not the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production meshes: 16×16 (256 ranks) or 2×16×16
    (512 ranks, axis "pod" first)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
