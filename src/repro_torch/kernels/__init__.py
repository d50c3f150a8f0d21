"""Multi-strided kernel families ported to Hopper.

Each family package holds ``specs.py`` (its ``TraversalSpec`` factory —
the kernel definition), ``ops.py`` (the public wrapper: config
resolution and device dispatch), ``ref.py`` (a plain PyTorch oracle) and
``kernel.py`` (the ctypes wrapper of its hand-written CUDA kernel in
``csrc/``, with a launch count).  ``cuda.py`` builds and loads the CUDA
sources; ``common.py`` holds the dispatch and config rules.

Ported so far: ``rmsnorm`` (K1 instance), ``decode_attn`` (K3
instance), ``mxv`` (``mxv``: K2, ``mxv_t``: K3), ``bicg`` (its sweeps run
the mxv kernels), ``gemver`` (``gemver_outer``, ``gemver_sum``: K1; its
mxv steps run the mxv kernels), ``stream`` (copy, triad, init: K1;
read: K2), and the paper's stencil and tensor kernels ``jacobi2d`` and
``conv3x3`` (K1 with row-halo taps, one kernel in ``stencil.py``) and
``doitgen`` (K1 with a batch axis and a free axis), and the fused
optimizer update ``adamw`` (``adamw_update``: K1).  ``manual.py`` is
the K4 template, the explicit lookahead ring, which every family's
K4-eligible spec reaches at a ``lookahead`` other than 2.  As in the JAX package, every public op is exported here
under its own name, which for ``rmsnorm``, ``decode_attn``, ``mxv``,
``bicg``, ``gemver``, ``jacobi2d``, ``conv3x3`` and ``doitgen`` is also
the name of its family's package:
``from repro_torch.kernels.mxv import ops`` still reaches the package.
"""
from repro_torch.kernels.adamw import adamw_update
from repro_torch.kernels.bicg import bicg
from repro_torch.kernels.conv3x3 import conv3x3
from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.doitgen import doitgen
from repro_torch.kernels.gemver import (gemver, gemver_mxv1, gemver_mxv2,
                                        gemver_outer, gemver_sum)
from repro_torch.kernels.jacobi2d import jacobi2d
from repro_torch.kernels.mxv import mxv, mxv_t
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.stream import (stream_copy, stream_copy_manual,
                                        stream_init, stream_read)

__all__ = ["rmsnorm", "decode_attn", "mxv", "mxv_t", "bicg", "gemver",
           "gemver_outer", "gemver_sum", "gemver_mxv1", "gemver_mxv2",
           "stream_read", "stream_copy", "stream_init",
           "stream_copy_manual", "jacobi2d", "conv3x3", "doitgen",
           "adamw_update"]
