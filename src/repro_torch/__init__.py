"""Tally on PyTorch and CUDA: the real-mode server and its kernels for an
NVIDIA H100 (Hopper, sm_90a).

This package is the port of ``repro`` (JAX/Pallas) and imports nothing of it.
Module names mirror the JAX package: ``core.descriptor``, ``core.transforms``,
``core.virtualization``, ``kernels.matmul``, ``kernels.flash_attention``, ...
Every Pallas kernel on the real-mode path is a hand-written CUDA C++ kernel
under ``kernels/csrc/``, built with ``nvcc`` at first use; each keeps a plain
PyTorch version of the same function that runs for tensors on the CPU.
"""
