"""The mesh of KV-sharded flash-decode serving.

The engine passes ``ServeConfig.shards`` into the model's
``decode_step``, and attention picks the strategy
(``kernels.decode_attn.sharded.dispatch``): the collective merge when a
mesh axis of exactly ``shards`` ranks is given, the static split of the
whole cache on one device otherwise, which serves the same numbers.
This module builds that mesh and ctx from the default process group,
and gives None (the one-device path) where there is none.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.common import MeshCtx

__all__ = ["resolve_serving_mesh", "serving_ctx"]


def resolve_serving_mesh(shards: int):
    """A 1-D ``("model",)`` ``DeviceMesh`` over the default process
    group, or None when ``shards <= 1`` or no group is initialised (the
    static split then serves on one device).  A group of another size
    than ``shards`` raises: it would serve another split."""
    import torch.distributed as dist
    if shards <= 1 or not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world != shards:
        raise ValueError(f"serving {shards} KV shards needs a process "
                         f"group of {shards} ranks, not {world}")
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((shards,), ("model",))


def serving_ctx(shards: int) -> Optional[MeshCtx]:
    """The engine's MeshCtx: the KV cache's sequence sharded over
    "model", no data parallelism (every rank sees every query row and
    contributes its slice of the cache); None where
    :func:`resolve_serving_mesh` gives no mesh."""
    mesh = resolve_serving_mesh(shards)
    if mesh is None:
        return None
    return MeshCtx(mesh=mesh, dp_axes=(), tp_axis="model")
