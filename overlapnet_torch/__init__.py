"""OverlapNet in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package beside it, which stays the reference. This package
imports nothing of that package and nothing of JAX.
"""
