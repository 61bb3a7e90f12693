"""spectralelementmethod_torch — the PyTorch/CUDA port of
``spectralelementmethod_tpu``.

A second package beside the JAX one, which stays the reference.  It imports
``torch`` and ``numpy`` (never ``jax``, nor anything of the JAX package: the
numpy host layers are copied, not shared).  Device code runs on an NVIDIA
Hopper card through hand-written CUDA kernels (:mod:`.ops.kernels`, sources
in ``csrc/``); every kernel has a plain PyTorch version beside it, which
the wrappers use for tensors on the CPU.

Ported so far: the 2D Poisson ``solve_local`` main path on affine meshes
with Jacobi PCG, plain and fused-iteration (:mod:`.models.poisson`).
"""

import importlib

from . import config

__version__ = "0.1.0"

_SUBPACKAGES = ("basis", "mesh", "core", "ops", "solver", "models", "utils",
                "interop")

__all__ = ["config", "__version__", *_SUBPACKAGES]


def __getattr__(name):
    """Lazy subpackage access."""
    if name in _SUBPACKAGES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
