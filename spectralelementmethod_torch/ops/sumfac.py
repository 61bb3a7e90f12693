"""Matrix-free Laplacian on transposed L-vectors (PyTorch port).

Port of the parts of the JAX package's ``ops/sumfac.py`` that the 2D affine
main path runs.  On an affine cell the local weak Laplacian collapses to
``A_e = a0(e) K0 + a1(e) K1 + a2(e) K2`` with three fixed (n, n) matrices
(:func:`make_affine_element_matrices`) and three scalars per element
(:func:`affine_factorization`); the operator on an (n, E) L-vector is then
``DSS(sum_c a_c K_c u)``, which one hand-written CUDA kernel computes
(:func:`.kernels.affine_apply_dss`, and :func:`.kernels.
affine_apply_dss_batched` for the (k, n, E) stacks of
:func:`make_multi_rhs_laplacian_T`).

The host helpers are numpy copies of the reference's.  Curved meshes (the
general, full-factor apply) are not ported yet: ROADMAP Queue 2 item 4.
The reference's multi-RHS apply chunks its batch in pairs to fit TPU VMEM;
here the whole stack is one launch.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import resolve_device, torch_dtype
from . import kernels
from .exchange import DSSPlan


def laplacian_diag_local_host(G, D0, D1):
    """Diagonal of the local weak Laplacian (numpy, for Jacobi).

    K[(p,q),(p,q)] = sum_m G00[m,q] D0[m,p]^2
                   + 2 G01[p,q] D0[p,p] D1[q,q]
                   + sum_n G11[p,n] D1[n,q]^2
    """
    G = np.asarray(G)
    D0 = np.asarray(D0)
    D1 = np.asarray(D1)
    d0 = np.einsum("emq,mp->epq", G[:, 0], D0**2)
    d1 = np.einsum("epn,nq->epq", G[:, 2], D1**2)
    cross = 2.0 * G[:, 1] * np.diag(D0)[:, None] * np.diag(D1)[None, :]
    return d0 + d1 + cross


def make_stacked_derivative(D0, D1):
    """Dhat (2n, n): both directional nodal derivatives as one matrix.

    Dhat = [D0 (x) I; I (x) D1] so that (Dhat @ u_flat) stacks [ur; us].
    """
    n0, n1 = D0.shape[0], D1.shape[0]
    Dr = np.kron(np.asarray(D0), np.eye(n1, dtype=np.asarray(D0).dtype))
    Ds = np.kron(np.eye(n0, dtype=np.asarray(D1).dtype), np.asarray(D1))
    return np.concatenate([Dr, Ds], axis=0)


def affine_factorization(Gf, W, rel_tol: float | None = None):
    """Rank-1 factorization ``G_i(e) = a_i(e) * W`` of geometric factors.

    For affine cells (parallelograms: constant Jacobian) each factor field
    is exactly the quadrature weight grid scaled per element.  Returns
    ``(a (E, 3), exact: bool)`` where ``exact`` is True when every element
    satisfies the factorization to ``rel_tol``.
    """
    Gf = np.asarray(Gf)
    if rel_tol is None:
        # floor at 1e-12: high-aspect fine meshes accumulate ~3x 100*eps
        # of f64 rounding through the geometry pipeline while genuinely
        # curved meshes sit at 1e-3+ relative
        rel_tol = max(100 * np.finfo(Gf.dtype).eps, 1e-12)
    W = np.asarray(W).reshape(-1)
    sumWW = float(W @ W)
    a = Gf @ W / sumWW                       # (E, 3) least-squares scales
    resid = Gf - a[..., None] * W
    scale = np.abs(Gf).max() + 1e-300
    exact = bool(np.abs(resid).max() <= rel_tol * scale)
    return a, exact


def make_affine_element_matrices(Dhat, W, order=None):
    """Assembled reference-element stiffness blocks for affine meshes.

    ``K0 = Dr^T diag(W) Dr``, ``K1 = Dr^T W Ds + Ds^T W Dr``,
    ``K2 = Ds^T diag(W) Ds``.  Returns ``Kcat`` of shape (n, 3n) =
    [K0 | K1 | K2] (symmetric blocks), rows/columns permuted by ``order``
    if given (L-vector node order).  Built in float64.
    """
    Dhat = np.asarray(Dhat, dtype=np.float64)
    W = np.asarray(W, dtype=np.float64).reshape(-1)
    n = Dhat.shape[1]
    Dr, Ds = Dhat[:n], Dhat[n:]
    WDr, WDs = W[:, None] * Dr, W[:, None] * Ds
    K0 = Dr.T @ WDr
    K1 = Dr.T @ WDs + Ds.T @ WDr
    K2 = Ds.T @ WDs
    if order is not None:
        ix = np.ix_(order, order)
        K0, K1, K2 = K0[ix], K1[ix], K2[ix]
    return np.concatenate([K0, K1, K2], axis=1)


class AffineLaplacianT(torch.nn.Module):
    """Weak Laplacian ``DSS(sum_c a_c K_c u)`` on (n, E) L-vectors.

    ``Kcat`` (n, 3n) = [K0 | K1 | K2] in the L-vector node order, ``a``
    (E, 3) affine scales, ``plan`` the exchange's :class:`.DSSPlan` on the
    operator's device.  ``free_local`` (optional (n, E) bool) applies the
    symmetric Dirichlet elimination: the output is zeroed on Dirichlet
    rows, and so is the input unless ``assume_masked_input`` (true by
    induction for CG iterates, which saves one pass per apply).

    The apply itself is :func:`.kernels.affine_apply_dss` — the CUDA
    kernel on a CUDA tensor, its plain PyTorch version on the CPU.
    :meth:`stacked` gives the same operator on (n_rhs, n, E) stacks, each
    RHS on its own, through :func:`.kernels.affine_apply_dss_batched`.
    """

    #: right-hand sides of a stacked operator (None: one (n, E) L-vector)
    n_rhs = None

    def __init__(self, Kcat, a, plan: DSSPlan, free_local=None,
                 assume_masked_input: bool = False, dtype=torch.float32):
        super().__init__()
        dev = plan.device
        Kcat = np.asarray(Kcat, dtype=np.float64)
        n = Kcat.shape[0]
        Kst = np.stack([Kcat[:, c * n:(c + 1) * n] for c in range(3)])
        self.register_buffer(
            "Kst", torch.as_tensor(Kst, device=dev).to(dtype).contiguous())
        aT = np.ascontiguousarray(np.asarray(a, dtype=np.float64).T)
        self.register_buffer("aT", torch.as_tensor(aT, device=dev).to(dtype))
        self.register_buffer(
            "free", None if free_local is None
            else torch.as_tensor(free_local, device=dev))
        self.plan = plan
        self.assume_masked_input = bool(assume_masked_input)

    def stacked(self, n_rhs: int) -> "AffineLaplacianT":
        """This operator on (n_rhs, n, E) stacks (the buffers are
        shared)."""
        op = copy.copy(self)
        op.n_rhs = int(n_rhs)
        return op

    def forward(self, uT: torch.Tensor) -> torch.Tensor:
        if self.free is not None and not self.assume_masked_input:
            uT = torch.where(self.free, uT, 0.0)
        if self.n_rhs is None:
            vT = kernels.affine_apply_dss(uT, self.Kst, self.aT, self.plan)
        else:
            n, E = self.Kst.shape[-1], self.aT.shape[-1]
            if tuple(uT.shape) != (self.n_rhs, n, E):
                raise ValueError(f"expected ({self.n_rhs}, {n}, {E}) batched "
                                 f"L-vectors, got {tuple(uT.shape)}")
            vT = kernels.affine_apply_dss_batched(
                uT.reshape(self.n_rhs * n, E), self.Kst, self.aT,
                self.plan).reshape(uT.shape)
        if self.free is not None:
            vT = torch.where(self.free, vT, 0.0)
        return vT


def make_local_laplacian_operator(exchange, Gf, Dhat, free_local=None,
                                  assume_masked_input: bool = False,
                                  device=None):
    """Weak Laplacian acting on transposed (n, E) hierarchical L-vectors
    (the reference's ``vector_layout="ne"``).

    ``Gf``: (E, 3, n) lex-flattened geometric factors; their dtype is the
    operator's.  ``Dhat``: (2n, n) from
    :func:`make_stacked_derivative`.  ``free_local``: optional (n, E) bool
    mask for symmetric Dirichlet elimination.  ``device``: the CUDA card
    unless given (see :func:`..config.resolve_device`).  Only affine
    meshes are ported; a curved mesh raises ``NotImplementedError``.
    """
    if not hasattr(exchange, "plan") or exchange.n_edge_tail or \
            exchange.n_vert_tail:
        raise NotImplementedError(
            "the affine apply needs a tail-free roll-class exchange "
            "(RollExchange); the generic-gather DSS has no kernel yet")
    Gf = np.asarray(Gf)
    if Gf.shape[0] != exchange.E:
        raise ValueError(f"factors have {Gf.shape[0]} rows, the exchange "
                         f"{exchange.E} elements")
    Wgrid = exchange.disc.basis.weight_grid().reshape(-1)
    a, exact = affine_factorization(Gf, Wgrid)
    if not exact:
        raise NotImplementedError(
            "curved (non-affine) meshes need the general apply, which is "
            "not ported yet (ROADMAP Queue 1 item 7; its kernels, Queue 2 "
            "items 4-5, make_fused_general_laplacian_T)")
    Kcat = make_affine_element_matrices(Dhat, Wgrid, order=exchange.hier)
    return AffineLaplacianT(Kcat, a, exchange.plan(resolve_device(device)),
                            free_local,
                            assume_masked_input=assume_masked_input,
                            dtype=torch_dtype(Gf.dtype))


def make_multi_rhs_laplacian_T(exchange, Gf, Dhat, n_rhs: int,
                               free_local=None,
                               assume_masked_input: bool = False,
                               device=None):
    """Batched-RHS transposed weak Laplacian: (k, n, E) -> (k, n, E).

    The ``n_rhs`` right-hand sides share one operator (``Kst``, the affine
    scales, the class tables), applied by one launch of
    :func:`.kernels.affine_apply_dss_batched` for the whole stack;
    ``free_local`` masks each RHS.  Arguments as in
    :func:`make_local_laplacian_operator`; a curved mesh raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 7).
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    return make_local_laplacian_operator(
        exchange, Gf, Dhat, free_local, assume_masked_input,
        device).stacked(n_rhs)
