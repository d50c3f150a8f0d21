"""Multi-strided kernel families ported to Hopper.

Each family package holds ``specs.py`` (its ``TraversalSpec`` factory —
the kernel definition), ``ops.py`` (the public wrapper: config
resolution and device dispatch), ``ref.py`` (a plain PyTorch oracle) and
``kernel.py`` (the ctypes wrapper of its hand-written CUDA kernel in
``csrc/``, with a launch count).  ``cuda.py`` builds and loads the CUDA
sources; ``common.py`` holds the dispatch and config rules.

Ported so far: ``rmsnorm`` (K1 instance) and ``decode_attn`` (K3
instance).
"""
