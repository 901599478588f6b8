"""ventjax_torch: the ventjax analysis pipeline in PyTorch, for NVIDIA Hopper.

A port of ``ventjax`` (the JAX package beside it, which stays the reference).
Module names mirror ``ventjax`` so each function's counterpart is easy to
find; the batch dimension is written out (``[N, H, W, D]``) where ``ventjax``
vmaps.  The hand-written CUDA kernels live in ``csrc/`` and are compiled at
first use by ``ventjax_torch._build``; on CPU tensors every kernel wrapper
runs its plain PyTorch version instead.

This package imports ``torch`` and never ``jax``, and nothing of ``ventjax``:
it keeps its own copies of what it needs from there (``config``, ``io``,
``report.export`` and the geometry tables in ``ops/geometry.py``), so it
runs where the JAX package is absent.

The reference application's class, ``Vent_Analysis`` (with
``extract_attributes``), is exported here as in ``ventjax.compat``; it runs
on the card unless ``device="cpu"`` is given.  Its command line is
``python -m ventjax_torch`` (``analyze``, ``export``, ``twix``,
``cohort``, ``serve``, ``doctor``, ``info``), on the card unless
``--device cpu`` is given.  Importing the package loads no PIL: the report
modules import it inside the functions that draw.
"""
from ventjax_torch.config import DEFAULT_CONFIG, VentConfig
from ventjax_torch.config import VERSION as __version__
from ventjax_torch.compat import Vent_Analysis, extract_attributes

__all__ = ["DEFAULT_CONFIG", "VentConfig", "Vent_Analysis",
           "extract_attributes", "__version__"]
