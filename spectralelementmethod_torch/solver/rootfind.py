"""Root finding utilities (host-side): a copy of the JAX package's
``solver/rootfind.py``, which is numpy only.

Parity: reference ``sem/rootfind.py`` — vector Newton–Raphson with a
``SolverFailure`` escape — plus the scalar secant iteration the squirmer
app embeds inline (``examples/squirmer-axisymmetric.py:719-743``).
"""

from __future__ import annotations

import numpy as np


class SolverFailure(Exception):
    """Raised when a nonlinear solver fails to converge
    (parity: ``sem/rootfind.py:15``)."""


def newton(f, x0, jac, it_max: int = 50, tol: float = 1e-12):
    """Newton–Raphson for vector-valued f; returns the root.

    Solves ``J dx = -f`` each iteration and stops when ``||dx|| <= tol``
    (parity: ``sem/rootfind.py:22-53``).
    """
    x = np.array(x0, dtype=np.float64)
    for _ in range(it_max):
        fx = np.asarray(f(x), dtype=np.float64)
        jx = np.asarray(jac(x), dtype=np.float64)
        dx = np.linalg.solve(jx, -fx)
        x += dx
        if np.linalg.norm(dx) <= tol:
            return x
    raise SolverFailure(
        "Maximum number of iterations exceeded before tolerance could "
        "be met."
    )


def secant(f, x0: float, x1: float, it_max: int = 10, tol: float = 1e-5,
           verbose: bool = False):
    """Scalar secant iteration for ``f(x) = 0``.

    Returns ``(root, history)`` where history is the list of (x, f(x))
    pairs evaluated.  Parity with the squirmer's inline speed search
    (``examples/squirmer-axisymmetric.py:719-743``): stops when the step
    ``|x2 - x1| < tol``.
    """
    if x0 == x1:
        raise ValueError("Two distinct initial guesses must be supplied.")
    f0, f1 = f(x0), f(x1)
    history = [(x0, f0), (x1, f1)]
    for itn in range(1, it_max + 1):
        x2 = (x1 * f0 - x0 * f1) / (f0 - f1)
        if verbose:
            print(f"[secant {itn}] x0={x0:.8g} x1={x1:.8g} -> x2={x2:.8g} "
                  f"(f0={f0:.3e}, f1={f1:.3e})")
        f2 = f(x2)
        history.append((x2, f2))
        if abs(x2 - x1) < tol:
            return x2, history
        x0, x1, f0, f1 = x1, x2, f1, f2
    raise SolverFailure(
        f"Secant iteration did not converge within {it_max} iterations."
    )
