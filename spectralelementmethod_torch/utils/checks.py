"""Invariant checking ("sanitizer" subsystem; a PyTorch port of the JAX
package's ``utils/checks.py``).

The reference's nearest analogue to sanitizers is dense host-side
``assert`` usage — detJ > 0 (``sem/mapping.py:117``), finite Schur
interiors (``sem/discrete.py:473-474``), index-consistency asserts in the
Gmsh reader (``sem/grid_importers.py:152,196``).  This module provides:

* :func:`nan_debug_mode` — a context in which every PyTorch operation's
  floating-point outputs are checked (expensive, for debugging only; the
  hand-written kernels' outputs are checked where PyTorch next reads
  them);
* :func:`checked` — wrap a function so non-finite tensor outputs raise
  instead of propagating;
* :func:`assert_finite` — an inline check;
* :func:`validate_discretization` — host-side structural diagnostics
  (the "self-test" analogue of the reference's scattered asserts).

Every check reads a flag back from the card, so it waits for the work
that produced the tensor (a host synchronization): keep them out of loops
that should run ahead of the host.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..config import resolve_device
from .timing import _leaves


def _check(x, name: str) -> None:
    for t in _leaves(x):
        if ((t.is_floating_point() or t.is_complex())
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(f"non-finite entries in {name}")


class _NanCheckMode(TorchFunctionMode):
    """Checks the outputs of every PyTorch function called under it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        _check(out, f"the output of {getattr(func, '__name__', func)}")
        return out


@contextlib.contextmanager
def nan_debug_mode():
    """Raise ``FloatingPointError`` at the first PyTorch operation that
    produces a NaN or an infinity (the counterpart of JAX's
    ``jax_debug_nans``; every operation synchronizes with the card)."""
    with _NanCheckMode():
        yield


def checked(fn):
    """Wrap ``fn`` so a non-finite floating-point tensor among its outputs
    (nested tuples, lists and dicts included) raises
    ``FloatingPointError`` on call.  Returns a function with the same
    signature."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        _check(out, f"the output of {getattr(fn, '__name__', fn)}")
        return out

    return wrapper


def assert_finite(x, name: str = "value"):
    """``x`` unchanged; ``FloatingPointError`` if it holds a NaN or an
    infinity.  On a card tensor this synchronizes with the card."""
    _check(x, name)
    return x


def validate_discretization(disc, atol: float = 1e-8, device=None) -> dict:
    """Structural self-test of a Discretization; returns a report dict.

    Checks (raising AssertionError on failure):

    * detJ positive everywhere (tangled/mis-oriented mappings);
    * partition of unity: DSS multiplicities >= 1, integer-valued;
    * quadrature measure: sum(detJxW), the mesh area;
    * weak-Laplacian symmetry on random vectors (adjoint consistency of
      the sum-factorized apply + scatter), and its constant null space,
      through :func:`..ops.sumfac.laplacian_apply` in float64 on
      ``device`` (:func:`..config.resolve_device`).
    """
    from ..ops import sumfac

    dev = resolve_device(device)
    report = {}
    report["detJ_min"] = float(disc.detJ.min())
    assert report["detJ_min"] > 0, "non-positive Jacobian determinant"

    mult = disc.node_multiplicity()
    assert np.all(mult >= 1)
    assert np.allclose(mult, np.round(mult))
    report["max_multiplicity"] = float(mult.max())

    report["area"] = float(np.sum(disc.detJxW))

    def on(a):
        return torch.as_tensor(np.array(a), device=dev)

    G = on(disc.laplacian_factors()).double()
    gix = on(disc.gather_nodes)
    D0 = on(disc.basis.subbases[0].D1).double()
    D1 = on(disc.basis.subbases[1].D1).double()
    rng = np.random.RandomState(0)
    u = on(rng.standard_normal(disc.n_nodes))
    v = on(rng.standard_normal(disc.n_nodes))
    Au = sumfac.laplacian_apply(u, gix, G, D0, D1, disc.n_nodes)
    Av = sumfac.laplacian_apply(v, gix, G, D0, D1, disc.n_nodes)
    lhs, rhs = float(torch.dot(v, Au)), float(torch.dot(u, Av))
    report["symmetry_rel_err"] = abs(lhs - rhs) / max(abs(lhs), 1e-30)
    assert report["symmetry_rel_err"] < atol, "operator not symmetric"

    # constant null space: A 1 = 0 (pure Neumann weak Laplacian)
    A1 = sumfac.laplacian_apply(
        torch.ones(disc.n_nodes, dtype=torch.float64, device=dev), gix, G,
        D0, D1, disc.n_nodes)
    report["null_space_err"] = float(A1.abs().max())
    scale = float(Au.abs().max())
    assert report["null_space_err"] < atol * max(scale, 1.0)
    return report
