"""This rank's piece of a leaf under a spec, as GSPMD lays it out.

A dim sharded over axes of total size n is cut into n pieces of
``ceil(D / n)`` entries; piece r starts at ``r · ceil(D / n)``, and the
last pieces are padded with zeros where n does not divide D (GSPMD pads
the same way).  Several axes on one dim index it row-major, the first
axis outermost.  A leaf may be cut over two axes on two dims (training's
``wq`` is ``(data, model)``, ``wo`` ``(model, data)``): a rank's piece is
its ``data`` piece of its ``model`` block, :meth:`Shard.block` gathers it
over one axis (the block, as ZeRO-3 runs a layer on it) and
:meth:`Shard.gather` over every axis (the whole leaf).  A piece is a contiguous tensor of its own, whatever the
dim (an fsdp dim that is not dim 0, as ``wo``'s, would otherwise be a
strided slice), so the kernels take it as it is.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Optional

import torch

from repro_torch.sharding.rules import mesh_shape

__all__ = ["Shard", "mesh_coords", "shard_of", "shard_tree"]


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's index along each axis of a ``DeviceMesh``; 0 on every
    axis of a mesh without ranks (an object with ``axis_names`` and
    ``shape``)."""
    sizes = mesh_shape(mesh)
    if hasattr(mesh, "get_local_rank"):
        return {a: mesh.get_local_rank(a) for a in sizes}
    return {a: 0 for a in sizes}


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How one leaf of ``shape`` lies on the mesh under ``spec``, seen from
    the rank at ``coords``.  ``cuts`` holds, for each dim sharded over
    more than one rank, ``(dim, pieces, this rank's piece)``; ``mesh``
    (where it is a ``DeviceMesh``) lets :meth:`gather` assemble the
    leaf."""
    shape: tuple[int, ...]
    spec: tuple
    cuts: tuple[tuple[int, int, int], ...]
    axes: tuple[tuple[str, ...], ...]   # the mesh axes of each cut
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def of(cls, shape, spec, sizes: dict[str, int],
           coords: dict[str, int], mesh=None) -> "Shard":
        cuts, axes = [], []
        for dim, entry in enumerate(spec):
            names = tuple(a for a in _axes(entry) if sizes.get(a, 1) > 1)
            n = math.prod(sizes[a] for a in names)
            if n > 1:
                r = 0
                for a in names:
                    r = r * sizes[a] + coords[a]
                cuts.append((dim, n, r))
                axes.append(names)
        return cls(tuple(shape), tuple(spec), tuple(cuts), tuple(axes),
                   mesh)

    def on(self, shape) -> "Shard":
        """This shard, checked against a leaf of ``shape``."""
        if tuple(shape) != self.shape:
            raise ValueError(f"a leaf of shape {tuple(shape)} is not the "
                             f"sharded leaf's {self.shape}")
        return self

    @property
    def sharded(self) -> bool:
        return bool(self.cuts)

    @property
    def local_shape(self) -> tuple[int, ...]:
        shape = list(self.shape)
        for dim, n, _ in self.cuts:
            shape[dim] = -(-shape[dim] // n)
        return tuple(shape)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole ``t``: a new contiguous tensor
        (on meta, shapes only)."""
        if tuple(t.shape) != self.shape:
            raise ValueError(f"tensor of shape {tuple(t.shape)} is not the "
                             f"leaf's {self.shape}")
        if not self.cuts:
            return t
        out = torch.zeros(self.local_shape, dtype=t.dtype, device=t.device)
        if t.device.type == "meta":
            return out
        src, dst = t, out
        for dim, n, r in self.cuts:
            c = dst.shape[dim]
            lo = min(r * c, self.shape[dim])
            k = min(c, self.shape[dim] - lo)
            src = src.narrow(dim, lo, k)
            dst = dst.narrow(dim, 0, k)
        with torch.no_grad():
            dst.copy_(src)
        return out

    def _place(self, full: torch.Tensor, piece: torch.Tensor) -> None:
        """Write ``piece`` (this shard's local tensor, pad and all) into
        its place in ``full``."""
        src, dst = piece, full
        for dim, n, r in self.cuts:
            c = src.shape[dim]
            lo = min(r * c, self.shape[dim])
            k = min(c, self.shape[dim] - lo)
            src = src.narrow(dim, 0, k)
            dst = dst.narrow(dim, lo, k)
        dst.copy_(src)

    def block(self, local: torch.Tensor, axis: str, group) -> torch.Tensor:
        """This rank's piece made whole over the one mesh axis ``axis``
        (``group``: this rank's line along it): an all-gather of the
        pieces over the group, each placed at its rank's offset along
        the dim ``axis`` cuts, the pad dropped.  Its other cuts stay:
        ``wq`` (data, model) gathered over data is this rank's model
        block [D, H / tp].  A leaf not cut over ``axis`` is returned as
        it is."""
        from repro_torch.sharding import collectives
        cut = [(dim, n) for (dim, n, _), axes in zip(self.cuts, self.axes)
               if axes == (axis,)]
        if not cut:
            return local
        ((dim, n),) = cut
        local = local.contiguous()
        buf = local.new_empty((n,) + tuple(local.shape))
        collectives.all_gather(buf.view(-1), local.view(-1), group,
                               axis=axis)
        full = buf.movedim(0, dim)
        shape = list(local.shape)
        shape[dim] *= n
        return full.reshape(shape).narrow(dim, 0, self.shape[dim])

    def gather(self, local: torch.Tensor,
               dst: Optional[int] = None) -> Optional[torch.Tensor]:
        """The whole leaf from every rank's piece (a collective over the
        mesh's ranks, which must be every rank of the default group),
        each piece placed by its rank's coordinates, the pad dropped:
        on every rank (one all-gather), or with ``dst`` on rank ``dst``
        alone (None elsewhere).  Under gloo ``dst``'s gather runs on host
        copies of the pieces, so the leaf arrives on the host, where a
        checkpoint wants it; under NCCL on the device."""
        import torch.distributed as dist
        from repro_torch.sharding import collectives
        if not self.cuts:
            return local if dst is None or dist.get_rank() == dst else None
        mesh = self.mesh
        ranks = mesh.mesh
        world = ranks.numel()
        local = local.contiguous()
        if dst is None:
            buf = torch.empty((world,) + tuple(local.shape),
                              dtype=local.dtype, device=local.device)
            collectives.all_gather(buf.view(-1), local.view(-1), None)
        else:
            if dist.get_backend() != "nccl":
                local = local.cpu()
            pieces = ([torch.empty_like(local) for _ in range(world)]
                      if dist.get_rank() == dst else None)
            dist.gather(local, pieces, dst=dst)
            if pieces is None:
                return None
            buf = torch.stack(pieces)
        full = torch.empty(self.shape, dtype=local.dtype,
                           device=local.device)
        sizes = mesh_shape(mesh)
        names = list(sizes)
        with torch.no_grad():
            for idx in itertools.product(*map(range, ranks.shape)):
                rank = int(ranks[idx])
                where = Shard.of(self.shape, self.spec, sizes,
                                 dict(zip(names, idx)))
                where._place(full, buf[rank])
        return full


def shard_of(shape, spec, mesh, coords: Optional[dict] = None) -> Shard:
    """The :class:`Shard` of a leaf of ``shape`` under ``spec`` on
    ``mesh``, for the rank at ``coords`` (default: this rank's)."""
    return Shard.of(shape, spec, mesh_shape(mesh),
                    mesh_coords(mesh) if coords is None else coords, mesh)


def _map_specs(fn, tree, specs) -> Any:
    """``fn(leaf, spec)`` over a tree of dicts and lists and its spec tree
    of the same structure."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, coords: Optional[dict] = None) -> Any:
    """This rank's piece of every leaf of ``tree`` (dicts and lists of
    tensors, meta tensors included) by the spec tree ``specs``: the
    counterpart of the JAX package's ``_shard``.  ``coords`` picks
    another rank's pieces (``{axis: index}``)."""
    sizes = mesh_shape(mesh)
    where = mesh_coords(mesh) if coords is None else coords
    return _map_specs(
        lambda t, spec: Shard.of(tuple(t.shape), spec, sizes, where).local(t),
        tree, specs)
