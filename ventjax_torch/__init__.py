"""ventjax_torch: the ventjax analysis pipeline in PyTorch, for NVIDIA Hopper.

A port of ``ventjax`` (the JAX package beside it, which stays the reference).
Module names mirror ``ventjax`` so each function's counterpart is easy to
find; the batch dimension is written out (``[N, H, W, D]``) where ``ventjax``
vmaps.  The hand-written CUDA kernels live in ``csrc/`` and are compiled at
first use by ``ventjax_torch._build``; on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

This package imports ``torch`` and never ``jax``.  It shares the jax-free
parts of ``ventjax``: ``ventjax.config``, ``ventjax.io.phantom`` and
``ventjax.oracle``.
"""
from ventjax.config import DEFAULT_CONFIG, VentConfig

__all__ = ["DEFAULT_CONFIG", "VentConfig"]
