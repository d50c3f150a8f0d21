"""PyTorch + CUDA port of the multi-strided access-pattern system.

Mirrors the subpackage layout of the JAX package ``repro`` so each module
has a counterpart of the same path.  Plain tensor code is PyTorch; every
kernel the JAX package lowers through Pallas becomes a CUDA C++ kernel
written by hand for Hopper (``csrc/``), built with ``nvcc`` at first use
and bound with ``ctypes`` (``kernels/cuda.py``).

Dispatch follows the tensor's device: a CUDA tensor launches the hand
kernel (or raises), a CPU tensor takes the kernel's plain PyTorch
version.  Entry points (model init, weight loading, the serve launcher)
run on the card unless the caller passes ``device="cpu"``.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
never anything of ``repro``.
"""
