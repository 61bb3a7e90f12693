"""Tensor-product bases (N-D from 1D factors).

Parity target: reference ``sem/basis_functions.py:396-697`` (``TensorProduct``,
``NodalTensorProduct``, ``TensorProductQS``).  All grid operations are
sum-factorized per-axis matmuls — exactly the structure that becomes a batched
MXU contraction on device (the reference implements the same idea with
``np.rollaxis`` loops at ``sem/basis_functions.py:539-624``).

Axis convention: coefficient arrays are ``rank_shape + coeff_shape`` with one
trailing axis per dimension.
"""

from __future__ import annotations

import numpy as np

from .lagrange import BarycentricLagrange, LagrangeGaussLobatto
from .quadrature import Quadrature1D, TensorQuadratureRule


def apply_matrices(mats, arr, ndim: int) -> np.ndarray:
    """Apply matrix ``mats[d]`` along the d-th of the last ``ndim`` axes.

    ``mats[d]`` may be None (skip that axis).  This is the sum-factorization
    primitive: cost O(n^{d+1}) per axis instead of O(n^{2d}) for the full
    Vandermonde contraction.
    """
    arr = np.asarray(arr)
    for d, mat in enumerate(mats):
        if mat is None:
            continue
        ax = arr.ndim - ndim + d
        arr = np.moveaxis(np.tensordot(mat, arr, axes=(1, ax)), 0, ax)
    return arr


class TensorProduct:
    """A basis formed as the tensor product of 1D sub-bases.

    Parity: reference ``sem/basis_functions.py:396-659``.
    """

    def __init__(self, *subbases: BarycentricLagrange):
        if len(subbases) < 1:
            raise ValueError(
                "Tensor product basis must comprise at least one sub-basis."
            )
        self._subbases = tuple(subbases)
        self._ndim = sum(b.ndim for b in subbases)
        if self._ndim != len(subbases):
            raise NotImplementedError("only 1D sub-bases are supported")
        self._coeff_shape = tuple(b.n_coeffs for b in subbases)
        self._n_coeffs = int(np.prod(self._coeff_shape))
        self._D1_mats = [b.D1 for b in subbases]

    # -- structure ---------------------------------------------------------

    @property
    def ndim(self) -> int:
        return self._ndim

    @property
    def coeff_shape(self):
        return self._coeff_shape

    @property
    def n_coeffs(self) -> int:
        return self._n_coeffs

    @property
    def n_subbases(self) -> int:
        return len(self._subbases)

    @property
    def subbases(self):
        return self._subbases

    @property
    def D1(self):
        """Per-dimension differentiation matrices."""
        return list(self._D1_mats)

    def get_D1_matrix(self, dim: int) -> np.ndarray:
        return self._D1_mats[dim]

    def get_D1_matrices(self):
        return list(self._D1_mats)

    # reference spelling used by examples/poisson.py:169 ("diff_mat")
    get_diff_matrices = get_D1_matrices

    def get_subbasis(self, dim: int):
        """Sub-basis on the face normal to dimension ``dim``.

        The tangential factors are "rolled" into face order
        ``subbases[dim+1:] + subbases[:dim]`` (the convention of reference
        ``sem/basis_functions.py:450-472`` and ``sem/geometry.py:214-216``);
        in 2D this is the single 1D factor of the other direction.
        """
        rolled = self._subbases[dim + 1:] + self._subbases[:dim]
        if len(rolled) == 1:
            return rolled[0]
        return type(self)(*rolled)

    def iter_subbases(self, reverse: bool = False):
        pairs = list(enumerate(self._subbases))
        return reversed(pairs) if reverse else iter(pairs)

    # -- evaluation --------------------------------------------------------

    def __call__(self, x) -> np.ndarray:
        """Full Vandermonde: ``B[M..., i0, i1, ...] = prod_d l_{i_d}(x_d[M...])``.

        ``x`` is a length-ndim sequence of same-shape point arrays (sparse
        meshgrid output is accepted and broadcast).
        """
        if len(x) != self.ndim:
            raise ValueError(
                f"Cannot evaluate {self.ndim}-dimensional basis at a "
                f"{len(x)}-dimensional set of points"
            )
        xb = np.broadcast_arrays(*x)
        pts_shape = xb[0].shape
        out = None
        for d, basis in self.iter_subbases():
            Bd = basis(xb[d])  # pts + (n_d,)
            Bd = Bd.reshape(
                pts_shape + (1,) * d + (self._coeff_shape[d],)
                + (1,) * (self.ndim - d - 1)
            )
            out = Bd if out is None else out * Bd
        return out

    def vandermonde_matrix(self, x) -> np.ndarray:
        """Flattened Vandermonde: (n_points, n_coeffs)."""
        B = self(x)
        return B.reshape(-1, self.n_coeffs)

    def interpolate(self, coeffs, x) -> np.ndarray:
        """Interpolate to arbitrary points.

        ``x``: length-ndim sequence (or (ndim, ...) array) of same-shape
        point arrays.  Returns ``rank_shape + points_shape``.
        """
        coeffs = np.asarray(coeffs)
        assert coeffs.shape[-self.ndim:] == self._coeff_shape
        rank_shape = coeffs.shape[:-self.ndim]
        xb = np.broadcast_arrays(*[np.asarray(xd, float) for xd in x])
        pts_shape = xb[0].shape
        M = int(np.prod(pts_shape, dtype=int)) if pts_shape else 1

        # result[r, M] = sum_{i0..id} prod_d B_d[M, i_d] * c[r, i0..id]
        out = coeffs.reshape((-1,) + self._coeff_shape)
        for d in range(self.ndim - 1, -1, -1):
            Bd = self._subbases[d](xb[d]).reshape(M, -1)  # (M, n_d)
            if d == self.ndim - 1:
                # (..., n_d) x (M, n_d) -> (..., M)
                out = np.einsum("...n,mn->...m", out, Bd)
            else:
                # out: (rank, i0..i_d, M); contract i_d with B_d[M] pointwise
                out = np.einsum("...nm,mn->...m", out, Bd)
        return out.reshape(rank_shape + pts_shape)

    def interpolate_on_grid(self, coeffs, x) -> np.ndarray:
        """Interpolate to a tensor grid given per-dimension 1D point sets."""
        assert len(x) == self.ndim
        coeffs = np.asarray(coeffs)
        assert coeffs.shape[-self.ndim:] == self._coeff_shape
        mats = [self._subbases[d](np.asarray(x[d], float))
                for d in range(self.ndim)]
        return apply_matrices(mats, coeffs, self.ndim)

    def interpolate_on_grid_eq(self, coeffs) -> np.ndarray:
        """Resample onto the equispaced grid of the same shape.

        Parity: ``sem/basis_functions.py:539-569`` (used to produce plotting
        node values and mapping round-trips).
        """
        mats = [b.interp_eq_mat for b in self._subbases]
        return apply_matrices(mats, np.asarray(coeffs), self.ndim)

    def compute_coeffs_grid(self, values, x) -> np.ndarray:
        """Recover coefficients from samples on a tensor grid ``x``."""
        assert len(x) == self.ndim
        mats = [np.linalg.inv(self._subbases[d](np.asarray(x[d], float)))
                for d in range(self.ndim)]
        return apply_matrices(mats, np.asarray(values), self.ndim)

    def compute_coeffs_grid_eq(self, values) -> np.ndarray:
        """Recover coefficients from equispaced samples.

        Parity: ``sem/basis_functions.py:599-624`` (the isoparametric mapping
        construction: Gmsh cell nodes are equispaced in parametric space).
        """
        mats = [b.interp_eq_mat_inv for b in self._subbases]
        return apply_matrices(mats, np.asarray(values), self.ndim)

    def deriv(self, coeffs, dim: int) -> np.ndarray:
        """Differentiate with respect to parametric dimension ``dim``."""
        coeffs = np.asarray(coeffs)
        assert coeffs.shape[-self.ndim:] == self._coeff_shape
        mats = [self._D1_mats[d] if d == dim else None
                for d in range(self.ndim)]
        return apply_matrices(mats, coeffs, self.ndim)

    def gradient(self, coeffs) -> np.ndarray:
        """Stack of parametric derivatives, leading axis = dimension."""
        coeffs = np.asarray(coeffs)
        return np.stack([self.deriv(coeffs, d) for d in range(self.ndim)])

    def __repr__(self):
        args = ", ".join(repr(b) for b in self._subbases)
        return f"{type(self).__name__}({args})"


class NodalTensorProduct(TensorProduct):
    """Tensor product of nodal bases; exposes the node grid."""

    @property
    def nodes(self):
        return tuple(b.nodes for b in self._subbases)

    def nodegrid(self, sparse: bool = False):
        return np.meshgrid(*self.nodes, indexing="ij", sparse=sparse)


class TensorProductQS(NodalTensorProduct):
    """Nodal tensor-product basis with a quadrature rule on its nodes.

    Parity: reference ``sem/basis_functions.py:683-697``.
    """

    def __init__(self, *subbases):
        for b in subbases:
            if not hasattr(b, "quad_rule"):
                raise ValueError(
                    "All subbases must be supported by a quadrature rule."
                )
        super().__init__(*subbases)
        self._quad_rule = TensorQuadratureRule(
            *(b.quad_rule for b in subbases)
        )

    @property
    def quad_rule(self) -> TensorQuadratureRule:
        return self._quad_rule

    def get_quadrature_rule(self) -> TensorQuadratureRule:
        return self._quad_rule

    def weight_grid(self) -> np.ndarray:
        """Dense quadrature-weight grid over the nodes."""
        return self._quad_rule.weight_grid()

    def integrate(self, coeffs):
        """Integrate the interpolant (trailing coeff axes) over [-1,1]^d."""
        coeffs = np.asarray(coeffs)
        w = self.weight_grid()
        axes = tuple(range(coeffs.ndim - self.ndim, coeffs.ndim))
        return np.tensordot(coeffs, w, axes=(axes, tuple(range(self.ndim))))


def gll_basis_2d(order: int, order1: int | None = None) -> TensorProductQS:
    """Convenience: 2D GLL tensor basis of the given order(s)."""
    b0 = LagrangeGaussLobatto(order)
    b1 = b0 if order1 is None or order1 == order else LagrangeGaussLobatto(order1)
    return TensorProductQS(b0, b1)


def gll_basis_3d(order: int) -> TensorProductQS:
    """Convenience: 3D GLL tensor basis (capability extension — the
    reference is 2D-only)."""
    b0 = LagrangeGaussLobatto(order)
    return TensorProductQS(b0, b0, b0)


# Name used by the reference's stale tests/examples
# (tests/test_basis.py:110, examples/squirmer-axisymmetric.py:92).
TensorProductSupported = TensorProductQS
