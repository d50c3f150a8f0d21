"""Fault-tolerant checkpointing, on the JAX package's on-disk layout
(``src/repro/checkpoint/manager.py``), so either package restores the
other's checkpoints.

Layout (one directory per step):
    <dir>/step_000123.tmp/...      (write in progress)
    <dir>/step_000123/             (atomic rename on completion)
        MANIFEST.json              (leaf paths, shapes, dtypes, step)
        arrays/<leaf-id>.npy[.zst] (one npy per leaf; zstd where the
                                    zstandard module imports)

Guarantees:
  * crash-safe: a partially-written step never shadows a complete one
    (tmp-dir + atomic rename; restore only reads dirs with a MANIFEST);
  * keep-N retention;
  * async save: the device→host copy is synchronous (a consistent
    snapshot) but compression and IO run on a background thread, so the
    train loop resumes at once.

A tree is a nested dict of tensors (or numpy arrays, or numbers); keys
join with ``/`` into leaf paths.  Leaves go to the host as numpy arrays,
so a dtype numpy has not (bf16) is refused.  ``restore`` returns tensors
on the device it is given.

Sharded state (ZeRO-3, ``train.zero``) stays unsharded on disk, as the
JAX package keeps it: ``save(..., shardings=)`` gathers each leaf to
rank 0 from every rank's piece, one leaf at a time
(``sharding.layout.Shard.gather``, a collective), and rank 0 alone
writes; ``restore(..., shardings=)``
gives each rank its piece of each leaf, on whatever mesh the shardings
name, so a run restores onto another rank count (``runtime.elastic``).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

try:  # optional: fall back to uncompressed payloads when absent
    import zstandard
except ImportError:
    zstandard = None

_FLAT_SEP = "/"

__all__ = ["CheckpointManager"]


def _flatten(tree) -> dict[str, Any]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            flat[_FLAT_SEP.join(path)] = node

    walk(tree, ())
    return flat


def _unflatten(flat: dict[str, Any]):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(_FLAT_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host(x) -> np.ndarray:
    """A host copy of ``x``, never a view: the optimizer updates the
    state in place, so an asynchronous write must not read a CPU
    tensor's own storage."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._collective = False    # a sharded save is in flight
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, shardings: Any = None) -> None:
        """Snapshot ``tree`` (nested dict of tensors/arrays) at ``step``.

        With ``shardings`` (a tree of ``sharding.layout.Shard``, one for
        each leaf, as ``launch.steps.state_shardings`` gives it) the
        leaves are this rank's pieces: every rank calls ``save``, each
        leaf is gathered to rank 0 and copied to its host in turn, and
        rank 0 writes the step (``wait`` on every rank returns once it is on
        disk)."""
        flat = _flatten(tree)
        if shardings is None:
            # synchronous, consistent device→host snapshot
            host = {k: _host(v) for k, v in flat.items()}
        else:
            import torch.distributed as dist
            shards = _flatten(shardings)
            host = {}
            for k in sorted(flat):
                whole = shards[k].gather(flat[k], dst=0)
                if whole is not None:
                    host[k] = _host(whole)
        self.wait()
        if shardings is not None:
            self._collective = True
            if dist.get_rank() != 0:
                return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_recording, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        """Join the background write; raise what it raised.  After a
        sharded save, every rank waits for rank 0's write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._collective:
            import torch.distributed as dist
            self._collective = False
            dist.barrier()
        if err is not None:
            raise err

    def _write_recording(self, step: int, host: dict) -> None:
        try:
            self._write(step, host)
        except Exception as exc:        # handed to the caller by wait()
            self._error = exc

    def _write(self, step: int, host: dict[str, np.ndarray]) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        arrays = os.path.join(tmp, "arrays")
        os.makedirs(arrays, exist_ok=True)
        cctx = zstandard.ZstdCompressor(level=3) if zstandard else None
        manifest = {"step": step, "leaves": {},
                    "codec": "zstd" if cctx else "raw"}
        for i, (key, arr) in enumerate(sorted(host.items())):
            fn = f"{i:06d}.npy.zst" if cctx else f"{i:06d}.npy"
            buf = io.BytesIO()
            np.save(buf, arr)
            payload = cctx.compress(buf.getvalue()) if cctx else buf.getvalue()
            with open(os.path.join(arrays, fn), "wb") as f:
                f.write(payload)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d,
                                               "MANIFEST.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device=None,
                shardings: Any = None) -> tuple[int, Any]:
        """→ (step, tree): the tree of ``step`` (default: the latest) as
        tensors on ``device``, or as numpy arrays where ``device`` is
        None.  With ``shardings`` (a tree of ``sharding.layout.Shard`` of
        the new mesh, the tree's structure) each leaf is this rank's piece
        of it: restoring onto another mesh than the one that saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        root = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(root, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat_shardings = _flatten(shardings) if shardings is not None else {}
        flat = {}
        for key, meta in manifest["leaves"].items():
            # codec dispatch is per file (suffix): raw checkpoints restore
            # anywhere; zstd ones raise a clear error on hosts without the
            # module
            with open(os.path.join(root, "arrays", meta["file"]), "rb") as f:
                raw = f.read()
            if meta["file"].endswith(".zst"):
                if zstandard is None:
                    raise ImportError(
                        f"checkpoint {root} is zstd-compressed but the "
                        "zstandard module is not installed")
                raw = zstandard.ZstdDecompressor().decompress(raw)
            arr = np.load(io.BytesIO(raw))
            sh = flat_shardings.get(key)
            if sh is not None:
                arr = sh.on(arr.shape).local(torch.from_numpy(arr))
                arr = arr.numpy() if device is None else arr
            flat[key] = arr if device is None else torch.as_tensor(
                arr).to(device)
        return step, _unflatten(flat)
