"""1D nodal Lagrange bases (barycentric form).

TPU-first re-design of the reference's ``sem/basis_functions.py``:

* Everything a device kernel needs is exposed as a small dense matrix
  (evaluation/Vandermonde, differentiation D1, equispaced resampling and its
  inverse) — on device, interpolation and differentiation are matmuls that
  batch over elements and feed the MXU.
* Host-side conveniences (`interpolate` with exact-node handling) mirror the
  reference semantics (``sem/basis_functions.py:185-341``) for point
  location, plotting and tests.

Output axis convention: coefficient "rank" axes lead, point axes trail —
``interpolate(coeffs[..., n], x[S]) -> values[..., S]`` (consistent with the
reference's ``_Basis.interpolate``/``deriv`` einsums at
``sem/basis_functions.py:29,122``).
"""

from __future__ import annotations

import numpy as np

from . import gll
from .quadrature import Quadrature1D


class BarycentricLagrange:
    """Nodal Lagrange basis in barycentric form.

    Parity: reference ``sem/basis_functions.py:185-341``.
    """

    def __init__(self, nodes, bary_wts):
        self._nodes = np.asarray(nodes, dtype=np.float64)
        self._bary_wts = np.asarray(bary_wts, dtype=np.float64)
        if self._nodes.shape != self._bary_wts.shape or self._nodes.ndim != 1:
            raise ValueError("nodes and bary_wts must be equal-length 1D")

        # Spectral differentiation matrix from barycentric weights
        # (reference sem/basis_functions.py:213-219):
        #   D[i, j] = (b_j / b_i) / (x_i - x_j),  D[i, i] = -sum_j D[i, j]
        with np.errstate(divide="ignore", invalid="ignore"):
            D1 = self._bary_wts[None, :] / self._bary_wts[:, None]
            D1 /= self._nodes[:, None] - self._nodes[None, :]
        np.fill_diagonal(D1, 0.0)
        np.fill_diagonal(D1, -D1.sum(axis=1))
        D1.setflags(write=False)
        self._D1 = D1

        # Resampling to/from the equispaced grid with n points (used for the
        # isoparametric mapping whose mesh nodes are equispaced in parametric
        # space; reference sem/basis_functions.py:221-224, 539-624).
        x_eq = np.linspace(-1.0, 1.0, self.n_nodes)
        self._interp_eq_mat = self(x_eq)
        self._interp_eq_mat_inv = np.linalg.inv(self._interp_eq_mat)
        self._interp_eq_mat.setflags(write=False)
        self._interp_eq_mat_inv.setflags(write=False)

    # -- structure ---------------------------------------------------------

    @property
    def ndim(self) -> int:
        return 1

    @property
    def nodes(self) -> np.ndarray:
        return self._nodes

    @property
    def n_nodes(self) -> int:
        return self._nodes.size

    @property
    def n_coeffs(self) -> int:
        return self._nodes.size

    @property
    def coeff_shape(self):
        return (self.n_coeffs,)

    @property
    def deg(self) -> int:
        """Polynomial degree of the basis functions."""
        return self._nodes.size - 1

    @property
    def bary_wts(self) -> np.ndarray:
        return self._bary_wts

    @property
    def D1(self) -> np.ndarray:
        """First-derivative (nodal differentiation) matrix."""
        return self._D1

    def get_D1_matrix(self, dim: int = 0) -> np.ndarray:
        return self._D1

    def get_D1_matrices(self):
        return [self._D1]

    @property
    def interp_eq_mat(self) -> np.ndarray:
        """Basis evaluated on the n-point equispaced grid."""
        return self._interp_eq_mat

    @property
    def interp_eq_mat_inv(self) -> np.ndarray:
        """Inverse map: equispaced samples -> nodal coefficients."""
        return self._interp_eq_mat_inv

    # -- evaluation --------------------------------------------------------

    def __call__(self, x) -> np.ndarray:
        """Evaluate every basis function at points ``x``.

        Returns ``B`` with ``B[..., j] = l_j(x[...])``; rows are exact
        one-hot when a point coincides with a node (the reference repairs
        NaNs instead, ``sem/basis_functions.py:248-254``).
        """
        x = np.asarray(x, dtype=np.float64)
        diff = x[..., None] - self._nodes
        exact = diff == 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            kern = self._bary_wts / diff
            result = kern / kern.sum(axis=-1, keepdims=True)
        hit = exact.any(axis=-1)
        if np.any(hit):
            result = np.where(hit[..., None], exact.astype(result.dtype), result)
        return result

    eval_matrix = __call__

    def interpolate(self, f, x, broadcast: bool = False) -> np.ndarray:
        """Evaluate the interpolant of nodal values ``f`` at points ``x``.

        ``f`` has shape ``rank + (n,)``; the result has shape
        ``rank + x.shape``.  With ``broadcast=True`` the leading axes of ``f``
        are matched elementwise against the axes of ``x`` (the reference's
        broadcasting variant, ``sem/basis_functions.py:260-341``), giving
        shape ``x.shape``-leading output.
        """
        f = np.asarray(f, dtype=np.float64)
        B = self(x)  # x.shape + (n,)
        if broadcast:
            # f: x.shape-compatible leading axes + free axes + (n,)
            # result: x.shape + free axes
            nx = B.ndim - 1
            n_free = f.ndim - 1 - nx
            f_bc = np.moveaxis(f, -1, nx)  # x-axes, n, free-axes
            out = np.einsum(
                B, list(range(nx)) + [nx],
                f_bc, list(range(nx + 1)) + [nx + 1 + k for k in range(n_free)],
                list(range(nx)) + [nx + 1 + k for k in range(n_free)],
            )
            return out
        # rank-leading output
        return np.einsum("...n,rn->r...", B, f.reshape(-1, f.shape[-1])).reshape(
            f.shape[:-1] + x_shape(x)
        )

    def deriv(self, coeffs) -> np.ndarray:
        """Nodal values of the derivative of the interpolant."""
        coeffs = np.asarray(coeffs)
        assert coeffs.shape[-1] == self.n_coeffs
        return np.einsum("mr,...r->...m", self._D1, coeffs)

    def gradient(self, coeffs) -> np.ndarray:
        return self.deriv(coeffs)

    def interpolate_on_grid_eq(self, coeffs) -> np.ndarray:
        """Resample nodal coefficients onto the equispaced n-point grid."""
        return np.einsum("mr,...r->...m", self._interp_eq_mat, coeffs)

    def compute_coeffs_grid_eq(self, values) -> np.ndarray:
        """Recover nodal coefficients from equispaced samples."""
        return np.einsum("mr,...r->...m", self._interp_eq_mat_inv, values)

    def __repr__(self):
        return f"{type(self).__name__}(deg={self.deg})"


def x_shape(x) -> tuple:
    return np.asarray(x).shape


class LagrangeGaussLobatto(BarycentricLagrange):
    """Lagrange basis through GLL nodes with the matching quadrature rule.

    Parity: reference ``sem/basis_functions.py:344-393`` — but with no
    order cap (the reference is limited to order 10 by its HDF5 table,
    ``sem/basis_functions.py:366-369``) and no table file dependency.
    """

    def __init__(self, order: int):
        if order < 1:
            raise ValueError("Must specify an order of 1 or greater.")
        rule = gll.gauss_legendre_lobatto(order + 1)
        super().__init__(rule.nodes, rule.bary_wts)
        self._quad_rule = Quadrature1D(rule.nodes, rule.quad_wts)

    @property
    def quad_rule(self) -> Quadrature1D:
        return self._quad_rule

    @property
    def quad_wts(self) -> np.ndarray:
        return self._quad_rule.weights

    def get_quadrature_rule(self) -> Quadrature1D:
        return self._quad_rule

    def integrate(self, coeffs):
        """Definite integral of the interpolant via the GLL rule."""
        return self._quad_rule.integrate(np.moveaxis(np.asarray(coeffs), -1, 0))


# Name used by the reference's stale tests/examples
# (tests/test_basis.py:54, examples/squirmer-axisymmetric.py:91).
LagrangeAtGaussLobatto = LagrangeGaussLobatto
