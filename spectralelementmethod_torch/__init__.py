"""spectralelementmethod_torch — the PyTorch/CUDA port of
``spectralelementmethod_tpu``.

A second package beside the JAX one, which stays the reference.  It imports
``torch`` and ``numpy`` (never ``jax``, nor anything of the JAX package: the
numpy host layers are copied, not shared).  Device code runs on an NVIDIA
Hopper card through hand-written CUDA kernels (:mod:`.ops.kernels`, sources
in ``csrc/``); every kernel has a plain PyTorch version beside it, which
the wrappers use for tensors on the CPU.

Ported so far (2D, Jacobi PCG): the Poisson ``solve_local`` and batched
``solve_local_batch`` on affine and curved (or variable-coefficient)
meshes, plain CG, the fused kernel pair with f32 or bf16 directions and
deferred x, and the single-kernel iteration ``cg_kernel="fused1"``
(:mod:`.models.poisson`); the variable-coefficient Helmholtz model's
global-vector ``solve`` and its L-vector ``solve_local`` and
``solve_local_batch`` in both layouts, with the element-local kernel on
the row-major one (:mod:`.models.helmholtz`).
"""

import importlib

from . import config

__version__ = "0.1.0"

_SUBPACKAGES = ("basis", "mesh", "core", "ops", "solver", "models", "utils",
                "plot2d", "native", "interop")

__all__ = ["config", "__version__", *_SUBPACKAGES]


def __getattr__(name):
    """Lazy subpackage access."""
    if name in _SUBPACKAGES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
