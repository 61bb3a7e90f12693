"""Batched static condensation (Schur complement) direct solver — PyTorch
port of the JAX package's ``solver/condensation.py``.

Everything is batched over the element axis, on the device of the
tensors it is given:

* per-element Schur complements via one batched ``torch.linalg.solve_ex`` on
  (E, n_int, n_int) blocks,
* global condensed system assembled DENSE over the exterior DOFs and
  solved with one LU (``torch.linalg.solve_ex``; cuSOLVER in float64 on the
  card) — at spectral orders the condensed system is small (exterior DOFs
  only),
* interior back-substitution as a second batched solve.

The indexing (:func:`build_condensed_indexing`) is host numpy, as in the
reference.  Local DOF ordering convention (parity with the original
library, ``sem/discrete.py:561-576``): hierarchical node order (exterior
nodes first), ``dofs_per_node`` interleaved: ``ldof = node_hier * dpn + c``.

Supports non-finite (inf/nan) entries in *constrained exterior* rows/cols:
constrained rows/cols are overwritten with identity and any entry left
non-finite is zeroed before the dense solve, so no inf or NaN reaches the
LU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.exchange import accumulate


class CondensedSystem(NamedTuple):
    """Static DOF-indexing data for a batched SC solve."""

    ext_dof_gidx: np.ndarray   # (E, n_ext_ldof) global condensed-dof index
    n_ext_dofs: int            # size of the condensed global system
    n_ext_ldof: int            # exterior local dofs per element
    n_int_ldof: int            # interior local dofs per element


#: Dense condensed-system memory budget (the reference's): the global Schur
#: system is assembled DENSE — O(n_ext_dofs^2) — and 2 GiB of float32
#: assembly is its limit (a float64 system of that size takes 4 GiB).
DENSE_BYTES_LIMIT = 2 << 30


def build_condensed_indexing(disc, dofs_per_node: int,
                             max_dense_bytes: int | None = None
                             ) -> CondensedSystem:
    """Exterior-DOF numbering for a Discretization.

    Exterior nodes (element-boundary nodes) are numbered consecutively by
    ascending global node id; interior nodes stay element-private.

    Raises ``ValueError`` when the dense condensed system would exceed
    ``max_dense_bytes`` (default :data:`DENSE_BYTES_LIMIT`) — at that
    scale use the matrix-free path instead (Jacobi/FDM-preconditioned CG,
    e.g. ``Poisson.solve_local``, or the squirmer's
    ``linear_solver="gmres-ir"`` which only *preconditions* with
    per-element condensation).
    """
    geometry = disc.geometry
    n_ext_nodes_loc = geometry.n_exterior_nodes
    hier = geometry.hierarchical_node_order
    gather_hier = disc.gather_nodes[:, hier]
    ext_global = np.unique(gather_hier[:, :n_ext_nodes_loc])
    node_to_ext = np.full(disc.n_nodes, -1, dtype=np.int64)
    node_to_ext[ext_global] = np.arange(ext_global.size)
    ext_node_gidx = node_to_ext[gather_hier[:, :n_ext_nodes_loc]]
    assert (ext_node_gidx >= 0).all()

    dpn = dofs_per_node
    E = disc.E
    n_ext_ldof = n_ext_nodes_loc * dpn
    ext_dof_gidx = (
        ext_node_gidx[:, :, None] * dpn + np.arange(dpn)[None, None, :]
    ).reshape(E, n_ext_ldof)

    n_ext_dofs = int(ext_global.size * dpn)
    budget = DENSE_BYTES_LIMIT if max_dense_bytes is None else max_dense_bytes
    dense_bytes = n_ext_dofs * n_ext_dofs * 4        # f32 assembly
    if dense_bytes > budget:
        raise ValueError(
            f"dense condensed system needs {dense_bytes / 2**30:.1f} GiB "
            f"({n_ext_dofs} exterior DOFs squared) > budget "
            f"{budget / 2**30:.1f} GiB. Static condensation assembles "
            "O(n_ext^2) dense; at this scale use the matrix-free solvers "
            "(Poisson.solve_local CG, or squirmer linear_solver='gmres-ir') "
            "or pass max_dense_bytes explicitly to override.")
    return CondensedSystem(
        ext_dof_gidx=ext_dof_gidx.astype(np.int32),
        n_ext_dofs=n_ext_dofs,
        n_ext_ldof=n_ext_ldof,
        n_int_ldof=(geometry.n_nodes - n_ext_nodes_loc) * dpn,
    )


def _index(gidx, device) -> torch.Tensor:
    """An index array (numpy or tensor) as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(gidx) if not isinstance(
        gidx, torch.Tensor) else gidx, device=device).to(torch.int64)


def _solve(A, B):
    """``torch.linalg.solve`` without its error check, as the reference's
    ``jnp.linalg.solve``: a singular or non-finite system gives a
    non-finite answer (which the Newton loop reports) instead of raising,
    and the card is not synchronized to read the check."""
    return torch.linalg.solve_ex(A, B).result


def _schur_blocks(lmat, n_ext: int):
    """(sc_tmp, sc_mat, Kie, Kii) of the per-element Schur complement:
    ``sc_tmp = Kei Kii^-1`` (solve ``Kii^T X^T = Kei^T``)."""
    Kee = lmat[:, :n_ext, :n_ext]
    Kei = lmat[:, :n_ext, n_ext:]
    Kie = lmat[:, n_ext:, :n_ext]
    Kii = lmat[:, n_ext:, n_ext:]
    sc_tmp = _solve(Kii.transpose(1, 2), Kei.transpose(1, 2)).transpose(1, 2)
    sc_mat = Kee - sc_tmp @ Kie
    return sc_tmp, sc_mat, Kie, Kii


def condense_local(lmat, lrhs, n_ext: int):
    """Batched per-element Schur complement.

    ``lmat`` (E, nd, nd), ``lrhs`` (E, nd) in hierarchical-interleaved
    order (exterior dofs first).  Returns (sc_mat (E, ne, ne),
    sc_rhs (E, ne), Kii, Kie) with Kii/Kie kept for back-substitution.
    """
    sc_tmp, sc_mat, Kie, Kii = _schur_blocks(lmat, n_ext)
    fe, fi = lrhs[:, :n_ext], lrhs[:, n_ext:]
    sc_rhs = fe - (sc_tmp @ fi[..., None])[..., 0]
    return sc_mat, sc_rhs, Kii, Kie


def assemble_dense(sc_mat, sc_rhs, ext_dof_gidx, n_ext_dofs: int,
                   rhs_extra=None):
    """Scatter condensed element blocks into the dense global system."""
    gi = _index(ext_dof_gidx, sc_mat.device)
    flat = gi[:, :, None] * n_ext_dofs + gi[:, None, :]
    A = accumulate(n_ext_dofs * n_ext_dofs, flat, sc_mat).reshape(
        n_ext_dofs, n_ext_dofs)
    b = accumulate(n_ext_dofs, gi, sc_rhs)
    if rhs_extra is not None:
        b = b + rhs_extra
    return A, b


def _pinned(A, free):
    """``A`` with constrained rows and columns replaced by identity and
    any entry left non-finite zeroed (nothing non-finite reaches an LU)."""
    A = torch.where(free[:, None] & free[None, :], A, 0.0)
    A = A + torch.diag(torch.where(free, 0.0, 1.0).to(A.dtype))
    return torch.where(torch.isfinite(A), A, 0.0)


def solve_condensed(A, b, free_mask):
    """Dense solve of the condensed system with constrained DOFs pinned.

    Constrained rows/cols are replaced by identity (their solution entries
    are forced to 0 — Newton increments vanish on essential BCs).  This
    also neutralizes inf/nan rows the axisymmetric operators put on
    Dirichlet-constrained axis DOFs.
    """
    free = _index(free_mask, A.device).to(torch.bool)
    A = _pinned(A, free)
    b = torch.where(free, b, 0.0)
    return _solve(A, b)


def back_substitute(Kii, Kie, fi, x_ext_local):
    """Batched interior solve: x_i = Kii^-1 (f_i - Kie x_e)."""
    rhs = fi - (Kie @ x_ext_local[..., None])[..., 0]
    return _solve(Kii, rhs[..., None])[..., 0]


def schur_solve(lmat, lrhs, csys: CondensedSystem, free_mask,
                rhs_extra=None):
    """Full batched static-condensation solve.

    Parameters
    ----------
    lmat : (E, nd, nd), lrhs : (E, nd)
        Local systems, hierarchical-interleaved DOF order.
    csys : CondensedSystem
    free_mask : (n_ext_dofs,) bool
        False on essential-BC condensed DOFs (solution forced to 0 there).
    rhs_extra : optional (n_ext_dofs,)
        Extra global RHS (e.g. Neumann contour integrals, the squirmer's
        ``cint``).

    Returns
    -------
    x_ext : (n_ext_dofs,) condensed solution
    x_loc : (E, nd) full local solution (exterior + interior parts)

    The reference composes :func:`schur_factor` and :func:`schur_apply`
    (explicit inverses); this is the same function by LU solves, the
    reference's own pipeline before that composition: condense, assemble,
    pin, one dense solve, back-substitute.  The Newton step of the direct
    solver calls it once per step.
    """
    ne = csys.n_ext_ldof
    sc_mat, sc_rhs, Kii, Kie = condense_local(lmat, lrhs, ne)
    A, b = assemble_dense(sc_mat, sc_rhs, csys.ext_dof_gidx, csys.n_ext_dofs,
                          rhs_extra)
    x_ext = solve_condensed(A, b, free_mask)
    x_ext_local = x_ext[_index(csys.ext_dof_gidx, x_ext.device)]
    x_int = back_substitute(Kii, Kie, lrhs[:, ne:], x_ext_local)
    return x_ext, torch.cat([x_ext_local, x_int], dim=1)


class SchurFactors(NamedTuple):
    """Reusable factorization of a batched static-condensation system.

    Holds EXPLICIT inverses, not LU factors, as the reference does: every
    apply (the GMRES-IR preconditioner, once per Krylov vector) is then
    plain matrix-vector products.
    """

    sc_tmp: torch.Tensor     # (E, n_ext, n_int) = Kei Kii^-1
    Kie: torch.Tensor        # (E, n_int, n_ext)
    Kii_inv: torch.Tensor    # (E, n_int, n_int) explicit inverse of Kii
    A_inv: torch.Tensor      # (n_ext_dofs,)^2 inverse of the pinned system
    free_mask: torch.Tensor  # (n_ext_dofs,) bool


def schur_factor(lmat, csys: CondensedSystem, free_mask) -> SchurFactors:
    """Factor the condensation pipeline once for many right-hand sides
    (the GMRES-IR preconditioner of the squirmer factors once per Newton
    step)."""
    sc_tmp, sc_mat, Kie, Kii = _schur_blocks(lmat, csys.n_ext_ldof)
    gi = _index(csys.ext_dof_gidx, lmat.device)
    nx = csys.n_ext_dofs
    flat = gi[:, :, None] * nx + gi[:, None, :]
    A = accumulate(nx * nx, flat, sc_mat).reshape(nx, nx)
    free = _index(free_mask, lmat.device).to(torch.bool)
    A_inv = torch.linalg.inv_ex(_pinned(A, free)).inverse
    Kii_inv = torch.linalg.inv_ex(Kii).inverse
    return SchurFactors(sc_tmp, Kie, Kii_inv, A_inv, free)


def schur_apply(f: SchurFactors, lrhs, csys: CondensedSystem,
                rhs_extra=None):
    """Solve with a prebuilt :class:`SchurFactors` (one RHS pass).

    Same result as :func:`schur_solve` on the factored matrix.
    """
    ne = csys.n_ext_ldof
    fe, fi = lrhs[:, :ne], lrhs[:, ne:]
    sc_rhs = fe - (f.sc_tmp @ fi[..., None])[..., 0]
    gi = _index(csys.ext_dof_gidx, lrhs.device)
    b = accumulate(csys.n_ext_dofs, gi, sc_rhs)
    if rhs_extra is not None:
        b = b + rhs_extra
    b = torch.where(f.free_mask, b, 0.0)
    x_ext = f.A_inv @ b
    x_ext_local = x_ext[gi]
    rhs_i = fi - (f.Kie @ x_ext_local[..., None])[..., 0]
    x_int = (f.Kii_inv @ rhs_i[..., None])[..., 0]
    return x_ext, torch.cat([x_ext_local, x_int], dim=1)
