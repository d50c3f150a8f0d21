"""Stream micro-kernels (paper §4): read / copy / init / manual copy —
specs, ops, oracles, the K1 and K2 instances of ``csrc/stream.cu``
(``kernel.py``); the K4 ring is ``kernels/manual.py``.

The JAX package registers these ops with the sizes below
(``src/repro/kernels/stream/__init__.py``); the port has no registry
yet, so it keeps its own copy of them."""
from repro_torch.kernels.stream.ops import (stream_copy, stream_copy_manual,
                                            stream_init, stream_read)

__all__ = ["stream_read", "stream_copy", "stream_init", "stream_copy_manual"]

_SIZES = {"rows": 32, "cols": 256}
# (32/4) rows * 128 cols * 4 B = 4 KiB inter-stream spacing: an exact
# power of two at the aliasing granularity (paper §4.5)
_ALIASED = {"rows": 32, "cols": 128}
_BENCH = {"rows": 8192, "cols": 4096}
