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
``doitgen`` (K1 with a batch axis and a free axis), the fused
optimizer update ``adamw`` (``adamw_update``: K1), and ``gen``, the
``*_gen`` ops that lower the families' specs through
``codegen.make_kernel_op`` (with the ``rowstat`` K2 and ``transpose`` K1
instances of its own).  ``manual.py`` is
the K4 template, the explicit lookahead ring, which every family's
K4-eligible spec reaches at a ``lookahead`` other than 2.

Every family registers its ops with ``repro_torch.registry`` when it is
imported, and the export table below is derived from the registry, as
in the JAX package: every registered op is a module attribute under its
own name, which for ``rmsnorm``, ``decode_attn``, ``mxv``, ``bicg``,
``gemver``, ``jacobi2d``, ``conv3x3`` and ``doitgen`` is also the name
of its family's package (``from repro_torch.kernels.mxv import ops``
still reaches the package).
"""
from repro_torch.kernels import (adamw, bicg, conv3x3,  # noqa: F401
                                 decode_attn, doitgen, gemver, jacobi2d, mxv,
                                 rmsnorm, stream)
# last: the *_gen rows reuse the families' specs and oracles
from repro_torch.kernels import gen  # noqa: F401
from repro_torch.registry.base import registered_ops as _registered_ops

_OPS = _registered_ops()
globals().update(_OPS)
__all__ = sorted(_OPS)
del _OPS
