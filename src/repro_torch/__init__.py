"""PyTorch/CUDA port of the SCE-NTT system for NVIDIA Hopper.

Same layout as the JAX reference package (``core/``, ``kernels/``,
``fhe/``, ``models/``, ``runtime/`` ...); imports torch, numpy and the
standard library only.
"""
