"""Device and precision defaults for the PyTorch port.

The JAX package's ``config`` switches x64 mode and a compilation cache; the
port needs neither (PyTorch runs float64 natively and compiles its CUDA
kernels once into ``_build/``, see :mod:`.ops.kernels`).  What it does fix
process-wide is precision: the ``highest`` tier of the reference means true
float32, so TF32 is switched off for matrix products and convolutions.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the reference's matmul precision tiers; every one computes true float32
#: here (ROADMAP Queue 3)
PRECISIONS = ("highest", "high", "default")


def check_precision(precision: str) -> str:
    """``precision`` if it names a tier, else ``ValueError`` (the
    reference's message).  The tiers exist for the TPU's bf16 MXU passes;
    the port computes every one in true float32, on the kernels and in
    PyTorch, so none is less accurate than it asks."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return precision


@contextmanager
def true_f32():
    """Keep TF32 off for the enclosed matmuls, whatever the process-wide
    setting (the reference's ``mm_precision="float32"``: its bf16 default
    made lambda_max(M A) 1.566 against 0.998 at f32, BASELINE.md
    round-5a)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card, and raises when there is none: the port
    never falls back to the CPU on its own.  Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return canonical_device(dev)


def canonical_device(device) -> torch.device:
    """``torch.device`` with the CUDA index filled in (``cuda`` ->
    ``cuda:0``), so devices compare equal to a tensor's ``.device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """numpy/torch dtype -> torch dtype (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32}[np.dtype(dtype)]
