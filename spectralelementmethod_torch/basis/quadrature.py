"""Quadrature rules (1D and tensor-product).

API-parity layer over :mod:`.gll` mirroring the reference's
``sem/quadratures.py`` (``Quadrature1D`` :14, ``GaussLobatto`` :121,
``TensorQuadratureRule`` :203), with the same semantics:

* integration is always over [-1, 1]^d,
* ``integrate(values)`` reduces the leading axes against the weights,
* ``xweight(values)`` multiplies by the weight grid without summing
  (used to fold detJ x W products into operators).

These are host-side numpy objects; device code consumes the plain weight
arrays (``weights``, ``weight_grid()``) inside jitted einsums.
"""

from __future__ import annotations

import numpy as np

from . import gll


class Quadrature1D:
    """An n-point 1D quadrature rule on [-1, 1].

    Parity: reference ``sem/quadratures.py:14-118``.
    """

    def __init__(self, abscissa, weights):
        self._abscissa = np.asarray(abscissa, dtype=np.float64)
        self._weights = np.asarray(weights, dtype=np.float64)

    @property
    def ndim(self) -> int:
        return 1

    @property
    def n_points(self) -> int:
        return self._abscissa.size

    @property
    def abscissa(self) -> np.ndarray:
        return self._abscissa

    @property
    def weights(self) -> np.ndarray:
        return self._weights

    def get_abscissa(self) -> np.ndarray:
        return self._abscissa

    def get_weights(self) -> np.ndarray:
        return self._weights

    def __call__(self, f):
        """Integrate callable or array of point values over [-1, 1]."""
        if callable(f):
            return np.dot(self._weights, f(self._abscissa))
        return np.dot(self._weights, f)

    def integrate(self, values):
        """Integrate values given at the quadrature points.

        The *first* axis of ``values`` must match the number of points
        (reference ``sem/quadratures.py:98-109``).
        """
        values = np.asarray(values)
        assert values.shape[0] == self._weights.size
        return np.tensordot(self._weights, values, axes=(0, 0))

    def xweight(self, f_vals):
        """Multiply point values by the quadrature weights (no summation)."""
        return f_vals * self._weights

    def __repr__(self):
        return f"{type(self).__name__}(n={self.n_points})"


class GaussLobatto(Quadrature1D):
    """n-point Gauss–Legendre–Lobatto rule; exact to degree 2n - 3.

    Parity: reference ``sem/quadratures.py:121-200`` (same nodes/weights,
    computed by :func:`gll.gauss_legendre_lobatto` instead of a one-step
    Newton refinement).
    """

    def __init__(self, n: int):
        if int(n) != n or n < 2:
            raise ValueError("n must be an integer >= 2")
        rule = gll.gauss_legendre_lobatto(int(n))
        super().__init__(rule.nodes, rule.quad_wts)

    @property
    def deg(self) -> int:
        """Degree of polynomial integrated exactly by the rule."""
        return 2 * self.n_points - 3


class TensorQuadratureRule:
    """Tensor product of 1D quadrature rules.

    Parity: reference ``sem/quadratures.py:203-275``.
    """

    def __init__(self, *quad_rules: Quadrature1D):
        self._ndim = 0
        self._n_points = 1
        self._abscissa = []
        self._weights = []
        for rule in quad_rules:
            self._ndim += rule.ndim
            self._n_points *= rule.abscissa.size
            self._abscissa.append(rule.abscissa)
            self._weights.append(rule.weights)

    @property
    def ndim(self) -> int:
        return self._ndim

    @property
    def n_points(self) -> int:
        return self._n_points

    @property
    def shape(self):
        return tuple(a.size for a in self._abscissa)

    @property
    def abscissa(self):
        return list(self._abscissa)

    @property
    def weights(self):
        return list(self._weights)

    def get_abscissa(self, sparse: bool = False):
        return np.meshgrid(*self._abscissa, indexing="ij", sparse=sparse)

    def get_weights(self, sparse: bool = False):
        grid = np.meshgrid(*self._weights, indexing="ij", sparse=sparse)
        if sparse:
            return grid
        out = grid[0].astype(np.float64).copy()
        for g in grid[1:]:
            out *= g
        return out

    def weight_grid(self) -> np.ndarray:
        """Dense weight grid W[i0,...,id] = prod_d w_d[i_d] (device-friendly)."""
        return self.get_weights(sparse=False)

    def __call__(self, f):
        if callable(f):
            return self.integrate(f(self._abscissa))
        return self.integrate(f)

    def integrate(self, f_vals):
        """Contract trailing axes of ``f_vals`` against the per-dim weights.

        Matches the reference's successive ``np.inner`` reduction
        (``sem/quadratures.py:262-266``): the *last* ``ndim`` axes are the
        quadrature axes; leading axes are free.
        """
        result = np.asarray(f_vals)
        for wt in reversed(self._weights):
            result = np.inner(result, wt)
        return result

    def xweight(self, f_vals):
        """Multiply by the weight grid (broadcast over leading axes)."""
        out = np.array(f_vals, dtype=np.float64, copy=True)
        for wt1d in self.get_weights(sparse=True):
            out *= wt1d
        return out

    def __repr__(self):
        return f"{type(self).__name__}(shape={self.shape})"
