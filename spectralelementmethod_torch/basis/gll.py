"""Gauss–Legendre–Lobatto (GLL) nodes, barycentric weights, quadrature weights.

TPU-native replacement for the reference's two-part scheme:

* runtime float64 root-finding (reference ``sem/quadratures.py:148-193``:
  companion-matrix roots of P'_{n-1} + one Newton step + symmetrization), and
* the offline sympy/mpmath table generator capped at order 10 (reference
  ``sem/basis_data.py:19-129`` writing ``sem/data/basis-data.hdf5``, cap
  enforced at ``sem/basis_functions.py:366-369``).

Here a single generator produces all three arrays at any order with no table
file and no order cap.  Float64 results agree with the reference's
arbitrary-precision tables to machine epsilon (the same Newton iteration on
the same polynomials); an mpmath path is available for extended-precision
validation and for regenerating reference-compatible HDF5 tables.

Definitions (reference ``sem/basis_data.py:44-63``):

* nodes: x_0 = -1, x_{n-1} = 1, interior nodes are the roots of P'_{n-1}.
* barycentric weights: b_i = 1 / P_{n-1}(x_i)  (valid up to a common scale;
  for GLL nodes P_{n-1}(x_i) alternates in sign so this is the standard
  (-1)^i-signed weight set).
* quadrature weights: w_i = 2 / [n (n-1) P_{n-1}(x_i)^2], summing to 2;
  the rule is exact for polynomials of degree <= 2n-3
  (reference ``sem/quadratures.py:196-200``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
from numpy.polynomial.legendre import Legendre


class GLLRule(NamedTuple):
    """Nodes, barycentric weights and quadrature weights of an n-point rule."""

    nodes: np.ndarray      # (n,) ascending in [-1, 1]
    bary_wts: np.ndarray   # (n,) barycentric Lagrange weights
    quad_wts: np.ndarray   # (n,) quadrature weights, sum == 2

    @property
    def n(self) -> int:
        return self.nodes.size

    @property
    def order(self) -> int:
        """Polynomial order of the nodal Lagrange basis (n - 1)."""
        return self.nodes.size - 1

    @property
    def degree_of_exactness(self) -> int:
        """Highest polynomial degree integrated exactly: 2n - 3."""
        return 2 * self.nodes.size - 3


@functools.lru_cache(maxsize=None)
def gauss_legendre_lobatto(n: int) -> GLLRule:
    """Compute the n-point GLL rule in float64 (cached).

    Interior nodes are found as roots of P'_{n-1} via the companion matrix,
    refined with Newton iterations until converged (the reference applies
    exactly one step, ``sem/quadratures.py:177-179``; we iterate to machine
    precision), then symmetrized about 0.
    """
    n = int(n)
    if n < 2:
        raise ValueError("At least two GLL points are required")

    leg = Legendre.basis(n - 1)
    dleg = leg.deriv()
    d2leg = dleg.deriv()

    x = np.zeros(n)
    x[0], x[-1] = -1.0, 1.0
    if n > 2:
        x[1:-1] = np.sort(dleg.roots().real)
        # Newton-refine the interior roots to machine precision.
        for _ in range(3):
            x[1:-1] -= dleg(x[1:-1]) / d2leg(x[1:-1])
        # symmetrize about zero
        x[1:-1] = (x[1:-1] - x[-2:0:-1]) / 2.0

    p_at_x = leg(x)
    # endpoints: P_{n-1}(±1) = (±1)^{n-1} exactly
    p_at_x[0] = (-1.0) ** (n - 1)
    p_at_x[-1] = 1.0

    # Barycentric weights are defined up to a common scale; use the
    # reference's normalization b_i = 1/[n(n-1) P_{n-1}(x_i)] so generated
    # tables match sem/data/basis-data.hdf5 bit-for-bit in layout and scale
    # (sem/basis_data.py:56-58 scales the same way via its quad-weight
    # normalization).
    bary = 1.0 / (n * (n - 1) * p_at_x)
    quad = bary**2
    quad *= 2.0 / quad.sum()

    nodes = np.asarray(x)
    nodes.setflags(write=False)
    bary.setflags(write=False)
    quad.setflags(write=False)
    return GLLRule(nodes, bary, quad)


# ---------------------------------------------------------------------------
# Extended-precision path (validation / reference-table parity)
# ---------------------------------------------------------------------------


def gauss_legendre_lobatto_mp(n: int, dps: int = 40) -> GLLRule:
    """High-precision GLL rule via mpmath Newton iteration (float64 output).

    Mirrors the reference's offline generator (``sem/basis_data.py:19-109``)
    without the sympy dependency: Legendre values by three-term recurrence,
    Newton updates on P'_{n-1} using the Legendre ODE for P''.
    """
    from mpmath import mp

    n = int(n)
    if n < 2:
        raise ValueError("At least two GLL points are required")
    deg = n - 1

    with mp.workdps(dps):

        def legendre_and_derivs(x):
            # returns (P_deg, P'_deg, P''_deg) at x via recurrence + ODE
            p0, p1 = mp.mpf(1), x
            if deg == 0:
                return p0, mp.mpf(0), mp.mpf(0)
            for k in range(2, deg + 1):
                p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
            # P'_deg = deg (x P_deg - P_{deg-1}) / (x^2 - 1)
            dp = deg * (x * p1 - p0) / (x * x - 1)
            # ODE: (1-x^2) P'' - 2x P' + deg(deg+1) P = 0
            d2p = (2 * x * dp - deg * (deg + 1) * p1) / (1 - x * x)
            return p1, dp, d2p

        xs = [mp.mpf(-1)]
        for i in range(1, deg):
            # Chebyshev-extrema initial guess, as the reference does
            # (sem/basis_data.py:89)
            x = mp.cos(mp.pi * (deg - i) / deg)
            for _ in range(100):
                _, dp, d2p = legendre_and_derivs(x)
                dx = dp / d2p
                x -= dx
                if abs(dx) < mp.mpf(10) ** (-dps + 2):
                    break
            xs.append(x)
        xs.append(mp.mpf(1))

        p_vals = []
        for x in xs:
            if x == -1:
                p_vals.append(mp.mpf((-1) ** deg))
            elif x == 1:
                p_vals.append(mp.mpf(1))
            else:
                p_vals.append(legendre_and_derivs(x)[0])

        bary = [1 / (n * (n - 1) * p) for p in p_vals]
        quad = [b * b for b in bary]
        s = sum(quad)
        quad = [q * 2 / s for q in quad]

        nodes = np.array([float(x) for x in xs])
        bary_f = np.array([float(b) for b in bary])
        quad_f = np.array([float(q) for q in quad])

    for a in (nodes, bary_f, quad_f):
        a.setflags(write=False)
    return GLLRule(nodes, bary_f, quad_f)


def write_table(fpath: str, max_order: int = 10) -> None:
    """Write a reference-layout HDF5 basis table.

    Layout parity with ``sem/basis_data.py:112-129`` /
    ``sem/data/basis-data.hdf5``: group ``GaussLegendreLobatto`` with attr
    ``max_order``; per-order datasets of shape (3, ceil((order+1)/2)) holding
    [nodes, bary_wts, quad_wts] for the non-negative half-interval only.
    """
    import h5py

    with h5py.File(fpath, "w") as f:
        grp = f.require_group("GaussLegendreLobatto")
        grp.attrs["max_order"] = max_order
        for order in range(1, max_order + 1):
            rule = gauss_legendre_lobatto_mp(order + 1)
            m = rule.n // 2
            data = np.stack(
                [rule.nodes[m:], rule.bary_wts[m:], rule.quad_wts[m:]]
            )
            grp.create_dataset(str(order), data=data)


def load_table(fpath: str, order: int) -> GLLRule:
    """Load a rule from a reference-layout HDF5 table.

    Reconstructs the full interval by mirroring the non-negative half exactly
    as the reference does (``sem/basis_functions.py:376-388``): nodes and
    quadrature weights mirror symmetrically; barycentric weights mirror with
    sign flip when n is even.
    """
    import h5py

    with h5py.File(fpath, "r") as f:
        grp = f["GaussLegendreLobatto"]
        if order > grp.attrs["max_order"]:
            raise ValueError(
                f"table only holds orders up to {grp.attrs['max_order']}"
            )
        half = grp[str(order)][:]

    n = order + 1
    m = n // 2
    nodes = np.zeros(n)
    bary = np.zeros(n)
    quad = np.zeros(n)
    nodes[m:], bary[m:], quad[m:] = half
    if n % 2 == 1:
        nodes[:m] = -half[0, -1:0:-1]
        bary[:m] = half[1, -1:0:-1]
        quad[:m] = half[2, -1:0:-1]
    else:
        nodes[:m] = -half[0, ::-1]
        bary[:m] = -half[1, ::-1]
        quad[:m] = half[2, ::-1]
    for a in (nodes, bary, quad):
        a.setflags(write=False)
    return GLLRule(nodes, bary, quad)
