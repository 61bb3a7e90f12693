"""Batched isoparametric mappings (element-batched geometry pipeline).

TPU-first replacement of the reference's per-cell ``Mapping``/``SubMapping``
objects (``sem/mapping.py:79-272``): all quantities carry a leading element
axis ``E`` and are computed once at setup by sum-factorized per-axis matmuls,
then live in device memory for the solver.

Pipeline (parity with the per-element math of the reference):

1. ``mapping_coeffs``: cell node coordinates (equispaced in parametric
   space, the Gmsh convention) -> nodal basis coefficients of the physical
   coordinate map (``sem/mapping.py:98-103`` via
   ``sem/basis_functions.py:599-624``).
2. ``jacobian``: J[i, a] = d x_i / d xi_a at the GLL nodes from the
   spectral differentiation matrices (``sem/mapping.py:105-119``).
3. ``det_inv_2x2``: closed-form batched determinant/inverse
   (``sem/linalg.py:105-115``).
4. ``face_geometry``: CCW-oriented face restriction, tangents, normal*dS
   (``sem/mapping.py:184-268``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..basis.tensor import TensorProduct, apply_matrices
from ..mesh.geometry import subface_index_array, subface_slice


def mapping_coeffs(basis: TensorProduct, cell_nodes: np.ndarray) -> np.ndarray:
    """Physical-coordinate basis coefficients from equispaced cell nodes.

    Parameters
    ----------
    basis : TensorProduct
        The (mapping) basis; coefficients are its nodal values.
    cell_nodes : (..., ndim_phys, *shape)
        Cell node coordinates on the equispaced parametric grid (leading
        axes are free, typically ``(E, ndim)``).
    """
    mats = [b.interp_eq_mat_inv for b in basis.subbases]
    return apply_matrices(mats, np.asarray(cell_nodes), basis.ndim)


def jacobian(basis: TensorProduct, x_coeffs: np.ndarray) -> np.ndarray:
    """Jacobian J[..., i, a, *shape] = d x_i / d xi_a at the basis nodes.

    ``x_coeffs``: (..., ndim_phys, *shape).
    """
    ndim = basis.ndim
    derivs = []
    for a in range(ndim):
        mats = [basis.subbases[d].D1 if d == a else None for d in range(ndim)]
        derivs.append(apply_matrices(mats, x_coeffs, ndim))
    # stack over parametric axis a, directly after the physical axis i
    return np.stack(derivs, axis=x_coeffs.ndim - ndim)


def _contract_axis0(M: np.ndarray, X: np.ndarray) -> np.ndarray:
    """Y[b, m, j] = M[m, i] X[b, i, j] via one large threaded GEMM."""
    B, p0, p1 = X.shape
    Xt = np.ascontiguousarray(X.transpose(0, 2, 1)).reshape(B * p1, p0)
    Yt = Xt @ M.T                                   # (B*p1, p0)
    return np.ascontiguousarray(
        Yt.reshape(B, p1, p0).transpose(0, 2, 1))


def _contract_axis1(X: np.ndarray, M: np.ndarray) -> np.ndarray:
    """Y[b, i, n] = X[b, i, j] M[n, j] via one large threaded GEMM."""
    B, p0, p1 = X.shape
    return (X.reshape(B * p0, p1) @ M.T).reshape(B, p0, p1)


def batched_geometry_2d(basis: TensorProduct, nodes: np.ndarray,
                        node_maps: np.ndarray):
    """Fused 2D geometry precompute: (x_coeffs, J, detJ, invJ).

    Equivalent to ``mapping_coeffs`` + ``jacobian`` + ``det_inv_2x2`` but
    restructured as a handful of large BLAS GEMMs and single-pass writes
    (the generic tensordot path costs ~20 array passes; this one is ~7x
    faster at 1M elements, where host setup otherwise dominates).

    ``nodes``: (2, N) mesh coordinates; ``node_maps``: (E, p0, p1).
    Returns x_coeffs (E, 2, p0, p1), J (E, 2, 2, p0, p1), detJ, invJ.
    """
    E, p0, p1 = node_maps.shape
    M0 = np.asarray(basis.subbases[0].interp_eq_mat_inv)
    M1 = np.asarray(basis.subbases[1].interp_eq_mat_inv)
    D0 = np.asarray(basis.subbases[0].D1)
    D1 = np.asarray(basis.subbases[1].D1)

    cn = nodes.T[node_maps]                       # (E, p0, p1, 2)
    cn = np.ascontiguousarray(np.moveaxis(cn, -1, 1))  # (E, 2, p0, p1)
    X = cn.reshape(E * 2, p0, p1)

    xc = _contract_axis1(_contract_axis0(M0, X), M1)   # coeffs
    x_coeffs = xc.reshape(E, 2, p0, p1)

    J = np.empty((E, 2, 2, p0, p1))
    Jv = J.reshape(E * 2, 2, p0, p1)
    Jv[:, 0] = _contract_axis0(D0, xc)
    Jv[:, 1] = _contract_axis1(xc, D1)
    detJ, invJ = det_inv_2x2(J)
    return x_coeffs, J, detJ, invJ


def batched_geometry_3d(basis: TensorProduct, nodes: np.ndarray,
                        node_maps: np.ndarray):
    """3D twin of :func:`batched_geometry_2d` (capability extension; the
    reference is 2D-only).

    ``nodes``: (3, N); ``node_maps``: (E, p0, p1, p2).  Returns x_coeffs
    (E, 3, *shape), J (E, 3, 3, *shape) with J[d, a] = d x_d / d u_a,
    detJ (E, *shape), invJ (E, 3, 3, *shape).
    """
    E, p0, p1, p2 = node_maps.shape
    Ms = [np.asarray(b.interp_eq_mat_inv) for b in basis.subbases]
    Ds = [np.asarray(b.D1) for b in basis.subbases]

    cn = nodes.T[node_maps]                          # (E, p0, p1, p2, 3)
    cn = np.ascontiguousarray(np.moveaxis(cn, -1, 1))
    X = cn.reshape(E * 3, p0, p1, p2)

    def contract(M, A, axis):
        """Y = M applied along grid axis ``axis`` of (B, p0, p1, p2)."""
        A = np.moveaxis(A, 1 + axis, -1)
        B = A.shape[:-1]
        Y = A.reshape(-1, A.shape[-1]) @ M.T
        return np.moveaxis(Y.reshape(*B, M.shape[0]), -1, 1 + axis)

    xc = contract(Ms[2], contract(Ms[1], contract(Ms[0], X, 0), 1), 2)
    x_coeffs = xc.reshape(E, 3, p0, p1, p2)

    J = np.empty((E, 3, 3, p0, p1, p2))
    Jv = J.reshape(E * 3, 3, p0, p1, p2)
    for a in range(3):
        Jv[:, a] = contract(Ds[a], xc, a)
    detJ, invJ = det_inv_3x3(J)
    return x_coeffs, J, detJ, invJ


def det_inv_3x3(mat: np.ndarray):
    """Batched closed-form determinant and inverse of 3x3 matrices.

    Layout ``mat[batch..., 3, 3, grid...]`` (matrix axes between batch and
    grid axes, matching :func:`det_inv_2x2`).
    """
    def g(i, j):
        # mat[..., i, j, :, :, :] — matrix axes between batch and grid
        return mat[(Ellipsis, i, j) + (slice(None),) * 3]

    c00 = g(1, 1) * g(2, 2) - g(1, 2) * g(2, 1)
    c01 = g(1, 2) * g(2, 0) - g(1, 0) * g(2, 2)
    c02 = g(1, 0) * g(2, 1) - g(1, 1) * g(2, 0)
    det = g(0, 0) * c00 + g(0, 1) * c01 + g(0, 2) * c02
    inv = np.empty_like(mat)

    def s(i, j, val):
        inv[(Ellipsis, i, j) + (slice(None),) * 3] = val

    s(0, 0, c00)
    s(1, 0, c01)
    s(2, 0, c02)
    s(0, 1, g(0, 2) * g(2, 1) - g(0, 1) * g(2, 2))
    s(1, 1, g(0, 0) * g(2, 2) - g(0, 2) * g(2, 0))
    s(2, 1, g(0, 1) * g(2, 0) - g(0, 0) * g(2, 1))
    s(0, 2, g(0, 1) * g(1, 2) - g(0, 2) * g(1, 1))
    s(1, 2, g(0, 2) * g(1, 0) - g(0, 0) * g(1, 2))
    s(2, 2, g(0, 0) * g(1, 1) - g(0, 1) * g(1, 0))
    inv /= det[(Ellipsis, None, None) + (slice(None),) * 3]
    return det, inv


def det_inv_2x2(mat: np.ndarray):
    """Batched closed-form determinant and inverse of 2x2 matrices.

    Layout ``mat[batch..., 2, 2, grid0, grid1]``: the matrix axes sit
    between any leading batch axes and the two trailing grid axes (parity
    with ``sem/linalg.py:105-115``, which puts them first with no batch).
    """
    a = mat[..., 0, 0, :, :]
    b = mat[..., 0, 1, :, :]
    c = mat[..., 1, 0, :, :]
    d = mat[..., 1, 1, :, :]
    det = a * d - b * c
    inv = np.empty_like(mat)
    inv[..., 0, 0, :, :] = d
    inv[..., 0, 1, :, :] = -b
    inv[..., 1, 0, :, :] = -c
    inv[..., 1, 1, :, :] = a
    inv /= det[..., None, None, :, :]
    return det, inv


class FaceGeometry(NamedTuple):
    """Batched geometry of a set of (cell, face) pairs, in face order
    (CCW for 1D faces of 2D cells, outward right-handed for 2D faces of
    3D cells — :data:`..mesh.geometry.FACE_AXES_3D`).

    Parity: the reference's ``SubMapping``/``SubFiniteElement`` quantities
    (``sem/mapping.py:196-268``, ``sem/discrete.py:733-750``); the 3D
    face quantities are a capability extension (reference is 2D-only).
    """

    cells: np.ndarray      # (k,) cell numbers
    faces: np.ndarray      # (k,) face ids
    local_ind: np.ndarray  # (k, m) flat local node index of face nodes
    x: np.ndarray          # (k, ndim_phys, m) physical coords of face nodes
    tangent: np.ndarray    # (k, ndim_phys, m) face tangent d x/d t0 (CCW in
    #                        2D; first in-plane axis in 3D; not normalized)
    n_dS: np.ndarray       # (k, ndim_phys, m) outward normal * surface measure
    dS: np.ndarray         # (k, m) surface measure |n_dS|
    weights: np.ndarray    # (m,) face quadrature weights (tensor-product
    #                        of the in-plane 1D rules, flattened)
    tangent2: np.ndarray | None = None  # (k, 3, m) second tangent d x/d t1
    #                        (3D faces only; None for 1D faces)

    @property
    def unit_normal(self) -> np.ndarray:
        return self.n_dS / self.dS[:, None, :]

    @property
    def n_dSxW(self) -> np.ndarray:
        """normal * dS * quadrature weight (Neumann contour integrals)."""
        return self.n_dS * self.weights

    @property
    def dSxW(self) -> np.ndarray:
        return self.dS * self.weights


# face -> (tangential parametric axis, sign) for the CCW tangent in 2D
# (derived from sem/mapping.py:233-256: faces 0 and 3 flip sign).
_FACE_TANGENT = {0: (1, -1.0), 1: (1, +1.0), 2: (0, +1.0), 3: (0, -1.0)}


def face_geometry(
    basis: TensorProduct,
    x_coeffs: np.ndarray,
    J: np.ndarray,
    cells: np.ndarray,
    faces: np.ndarray,
) -> FaceGeometry:
    """Compute batched face geometry for (cell, face) pairs.

    ``x_coeffs``: (E, ndim, *shape); ``J``: (E, ndim, ndim, *shape).
    2D parents (1D faces) follow the reference's CCW conventions
    (``sem/mapping.py:110-111``); 3D parents (quadrilateral faces of
    hexahedra) are a capability extension — see :func:`_face_geometry_3d`.
    """
    if basis.ndim == 3:
        return _face_geometry_3d(basis, x_coeffs, J, cells, faces)
    shape = x_coeffs.shape[-basis.ndim:]
    assert basis.ndim == 2
    cells = np.asarray(cells, dtype=np.int64)
    faces = np.asarray(faces, dtype=np.int64)
    k = cells.size

    # per-face-id flat local index arrays (face-oriented)
    face_local = {f: subface_index_array(f, shape) for f in range(4)}
    lengths = {f: face_local[f].size for f in range(4)}
    if k and len(set(lengths[int(f)] for f in faces)) > 1:
        raise NotImplementedError(
            "mixed-length faces in one FaceGeometry batch"
        )
    m = lengths[int(faces[0])] if k else shape[1]

    local_ind = np.zeros((k, m), dtype=np.int64)
    x = np.zeros((k, 2, m))
    tangent = np.zeros((k, 2, m))
    for i, (c, f) in enumerate(zip(cells, faces)):
        f = int(f)
        li = face_local[f]
        local_ind[i] = li
        x[i] = x_coeffs[c].reshape(2, -1)[:, li]
        ax_t, sign = _FACE_TANGENT[f]
        # restrict the tangential column of J to the face, face-oriented
        Jt = subface_slice(f, J[c, :, ax_t], 2)  # (2, m)
        tangent[i] = sign * Jt

    # outward normal in 2D: rotate CCW tangent by -90 deg -> (t_y, -t_x)
    # (sem/mapping.py:196-211: roll + sign flip)
    n_dS = np.stack([tangent[:, 1], -tangent[:, 0]], axis=1)
    dS = np.linalg.norm(n_dS, axis=1)

    # 1D weights along the face (tangential axis factor); GLL weights are
    # symmetric so face-orientation reversal leaves them unchanged.
    if k:
        ax_t = _FACE_TANGENT[int(faces[0])][0]
        sb = basis.subbases[ax_t]
    else:
        sb = basis.subbases[0]
    weights = sb.quad_rule.weights if hasattr(sb, "quad_rule") else None

    return FaceGeometry(cells, faces, local_ind, x, tangent, n_dS, dS, weights)


def _face_geometry_3d(
    basis: TensorProduct,
    x_coeffs: np.ndarray,
    J: np.ndarray,
    cells: np.ndarray,
    faces: np.ndarray,
) -> FaceGeometry:
    """3D branch of :func:`face_geometry`: quadrilateral faces of hexes.

    Faces are 2D grids over their in-plane parametric axes ``(t0, t1)``
    in :data:`..mesh.geometry.FACE_AXES_3D` order, chosen so the
    right-handed surface element ``n dS = (d x/d t0) x (d x/d t1)``
    points out of the cell; ``dS = |n dS|`` and the face quadrature
    weights are the tensor product of the two in-plane 1D rules
    (flattened in the same (t0, t1) order as ``local_ind``).  This
    generalizes ``sem/mapping.py:196-268`` (2D-only in the reference).
    """
    from ..mesh.geometry import FACE_AXES_3D

    shape = x_coeffs.shape[-3:]
    cells = np.asarray(cells, dtype=np.int64)
    faces = np.asarray(faces, dtype=np.int64)
    k = cells.size

    face_local = {f: subface_index_array(f, shape) for f in range(6)}
    lengths = {f: face_local[f].size for f in range(6)}
    if k and len(set(lengths[int(f)] for f in faces)) > 1:
        raise NotImplementedError(
            "mixed-length faces in one FaceGeometry batch"
        )
    m = lengths[int(faces[0])] if k else shape[1] * shape[2]

    local_ind = np.zeros((k, m), dtype=np.int64)
    x = np.zeros((k, 3, m))
    tau0 = np.zeros((k, 3, m))
    tau1 = np.zeros((k, 3, m))
    for i, (c, f) in enumerate(zip(cells, faces)):
        f = int(f)
        li = face_local[f].ravel()
        local_ind[i] = li
        x[i] = x_coeffs[c].reshape(3, -1)[:, li]
        t0, t1 = FACE_AXES_3D[f]
        # restrict the two in-plane Jacobian columns to the face,
        # face-oriented: (3, m0, m1) -> (3, m)
        tau0[i] = subface_slice(f, J[c, :, t0], 3).reshape(3, m)
        tau1[i] = subface_slice(f, J[c, :, t1], 3).reshape(3, m)

    # outward surface element: right-handed cross product of the tangents
    n_dS = np.cross(tau0, tau1, axis=1)
    dS = np.linalg.norm(n_dS, axis=1)

    # shared face-quadrature weight vector: outer(w_t0, w_t1) in the
    # face's (t0, t1) order.  The batch guard above only checks node
    # COUNT, so on anisotropic grids two faces can have equal-size but
    # axis-transposed in-plane rules — verify every face in the batch
    # produces the same weight vector rather than silently applying
    # faces[0]'s ordering to all (ADVICE round-3).
    def _face_weights(f):
        t0, t1 = FACE_AXES_3D[int(f)]
        sb0, sb1 = basis.subbases[t0], basis.subbases[t1]
        if hasattr(sb0, "quad_rule") and hasattr(sb1, "quad_rule"):
            return np.outer(sb0.quad_rule.weights,
                            sb1.quad_rule.weights).ravel()
        return None

    weights = _face_weights(faces[0]) if k else _face_weights(1)
    if k:
        for f in np.unique(faces[1:]):
            wf = _face_weights(f)
            same = (weights is None and wf is None) or (
                weights is not None and wf is not None
                and weights.shape == wf.shape
                and np.array_equal(weights, wf))
            if not same:
                raise NotImplementedError(
                    "faces with different in-plane quadrature rules in "
                    "one FaceGeometry batch"
                )

    return FaceGeometry(cells, faces, local_ind, x, tau0, n_dS, dS,
                        weights, tangent2=tau1)
