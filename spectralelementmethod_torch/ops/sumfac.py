"""Matrix-free Laplacian on transposed L-vectors (PyTorch port).

Port of the parts of the JAX package's ``ops/sumfac.py`` that the 2D main
path runs, on the transposed (n, E) layout.  On an affine cell the local
weak Laplacian collapses to ``A_e = a0(e) K0 + a1(e) K1 + a2(e) K2`` with
three fixed (n, n) matrices (:func:`make_affine_element_matrices`) and
three scalars per element (:func:`affine_factorization`); the operator is
then ``DSS(sum_c a_c K_c u)`` (:class:`AffineLaplacianT`, one hand-written
CUDA kernel, :func:`.kernels.affine_apply_dss`).  A curved mesh or a
variable coefficient keeps the full (3, n, E) factor slabs
(:class:`GeneralLaplacianT`: ``DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us])``
with ``[ur; us] = Dhat u``, :func:`.kernels.general_apply_dss`).
:func:`make_local_laplacian_operator` picks one by the reference's
``structure`` rule; ``.stacked(k)`` gives either on (k, n, E) stacks
(:func:`make_multi_rhs_laplacian_T`).

The host helpers are numpy copies of the reference's, with one deliberate
divergence: :func:`affine_factorization` measures each element against its
own scale (ROADMAP Queue 3).  The reference's multi-RHS apply chunks its
batch in pairs to fit TPU VMEM, and pads its factors to its padded
exchange; here the whole stack is one launch and the exchange is unpadded.
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
    satisfies the factorization to ``rel_tol`` of its own largest factor.

    Deliberate divergence from the reference, which measures every
    element's residual against the mesh's global max |G|: there one
    stretched element (large factors) lets a slightly curved element
    elsewhere pass as affine, and its apply then drops the curvature.
    Zero (padding) elements stay exact.
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
    scale = np.abs(Gf).max(axis=(1, 2)) + 1e-300         # (E,) per element
    exact = bool((np.abs(resid).max(axis=(1, 2)) <= rel_tol * scale).all())
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


class LaplacianT(torch.nn.Module):
    """Weak Laplacian on (n, E) L-vectors, or on (n_rhs, n, E) stacks
    (:meth:`stacked`): the Dirichlet masking shared by the affine and the
    general operator around their apply kernels.

    ``free_local`` (optional (n, E) bool) applies the symmetric Dirichlet
    elimination: the output is zeroed on Dirichlet rows, and so is the
    input unless ``assume_masked_input`` (true by induction for CG
    iterates, which saves one pass per apply).  ``plan`` is the exchange's
    :class:`.DSSPlan` on the operator's device.
    """

    #: right-hand sides of a stacked operator (None: one (n, E) L-vector)
    n_rhs = None
    #: "affine" or "general" (the reference's ``_structure``)
    structure = None

    def __init__(self, plan: DSSPlan, n: int, free_local=None,
                 assume_masked_input: bool = False):
        super().__init__()
        self.register_buffer(
            "free", None if free_local is None
            else torch.as_tensor(free_local, device=plan.device))
        self.plan = plan
        self.n_loc = int(n)
        self.assume_masked_input = bool(assume_masked_input)

    def stacked(self, n_rhs: int) -> "LaplacianT":
        """This operator on (n_rhs, n, E) stacks (the buffers are
        shared)."""
        if n_rhs < 1:
            raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
        op = copy.copy(self)
        op.n_rhs = int(n_rhs)
        return op

    def masked(self, free_local, assume_masked_input: bool = False):
        """This operator with another Dirichlet mask (None: unmasked); the
        other buffers are shared."""
        op = copy.copy(self)
        op._buffers = dict(self._buffers)
        op.free = (None if free_local is None
                   else torch.as_tensor(free_local, device=self.plan.device))
        op.assume_masked_input = bool(assume_masked_input)
        return op

    def forward(self, uT: torch.Tensor) -> torch.Tensor:
        if self.free is not None and not self.assume_masked_input:
            uT = torch.where(self.free, uT, 0.0)
        if self.n_rhs is None:
            vT = self._apply(uT)
        else:
            n, E = self.n_loc, self.plan.E
            if tuple(uT.shape) != (self.n_rhs, n, E):
                raise ValueError(f"expected ({self.n_rhs}, {n}, {E}) batched "
                                 f"L-vectors, got {tuple(uT.shape)}")
            vT = self._apply_batched(
                uT.reshape(self.n_rhs * n, E)).reshape(uT.shape)
        if self.free is not None:
            vT = torch.where(self.free, vT, 0.0)
        return vT


class AffineLaplacianT(LaplacianT):
    """Weak Laplacian ``DSS(sum_c a_c K_c u)`` on an affine mesh.

    ``Kcat`` (n, 3n) = [K0 | K1 | K2] in the L-vector node order, ``a``
    (E, 3) affine scales; the rest as in :class:`LaplacianT`.  The apply
    is :func:`.kernels.affine_apply_dss` (``affine_apply_dss_batched`` on
    stacks) — the CUDA kernel on a CUDA tensor, its plain PyTorch version
    on the CPU.
    """

    structure = "affine"

    def __init__(self, Kcat, a, plan: DSSPlan, free_local=None,
                 assume_masked_input: bool = False, dtype=torch.float32):
        Kcat = np.asarray(Kcat, dtype=np.float64)
        n = Kcat.shape[0]
        super().__init__(plan, n, free_local, assume_masked_input)
        dev = plan.device
        Kst = np.stack([Kcat[:, c * n:(c + 1) * n] for c in range(3)])
        self.register_buffer(
            "Kst", torch.as_tensor(Kst, device=dev).to(dtype).contiguous())
        aT = np.ascontiguousarray(np.asarray(a, dtype=np.float64).T)
        self.register_buffer("aT", torch.as_tensor(aT, device=dev).to(dtype))

    def _apply(self, uT):
        return kernels.affine_apply_dss(uT, self.Kst, self.aT, self.plan)

    def _apply_batched(self, uT):
        return kernels.affine_apply_dss_batched(uT, self.Kst, self.aT,
                                                self.plan)

    def fused_cg_kernels(self, n_rhs=None, defer_x: bool = False):
        """``(kA, kB)`` of the fused CG on this operator: single-RHS
        (:func:`.kernels.make_fused_cg_kernels`) for ``n_rhs=None``, else
        batched for ``n_rhs`` right-hand sides."""
        if n_rhs is None:
            return kernels.make_fused_cg_kernels(self.Kst, self.aT, self.plan,
                                                 defer_x=defer_x)
        return kernels.make_fused_cg_kernels_batched(
            self.Kst, self.aT, self.plan, n_rhs, defer_x=defer_x)

    def fused_cg_kernel_single(self, defer_x: bool = False):
        """``kAB`` of the single-kernel CG iteration on this operator
        (:func:`.kernels.make_fused_cg_kernel_single`; ``cg_fused`` with
        ``kB=None``)."""
        return kernels.make_fused_cg_kernel_single(self.Kst, self.aT,
                                                   self.plan, defer_x=defer_x)


class GeneralLaplacianT(LaplacianT):
    """Weak Laplacian on a curved (non-affine) mesh, with full factor slabs:
    ``DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us])``, ``[ur; us] = Dhat u``.

    ``Gf`` (E, 3, n): the lex-ordered geometric factors (their slabs are
    kept as ``gT`` (3, n, E)); ``Dhat`` (2n, n): the stacked derivative of
    :func:`make_stacked_derivative` in lex order (kept as ``Dh``, its
    columns permuted into the L-vector order); ``hier`` (n,): the exchange's
    local node order (L-vector row -> lex node); the rest as in
    :class:`LaplacianT`.  The apply is :func:`.kernels.general_apply_dss`
    (``general_apply_dss_batched`` on stacks).
    """

    structure = "general"

    def __init__(self, Gf, Dhat, hier, plan: DSSPlan, free_local=None,
                 assume_masked_input: bool = False, dtype=torch.float32):
        Gf = np.asarray(Gf)
        E, three, n = Gf.shape
        if three != 3 or E != plan.E:
            raise ValueError(f"factors of shape {Gf.shape}; expected "
                             f"({plan.E}, 3, n)")
        super().__init__(plan, n, free_local, assume_masked_input)
        dev = plan.device
        gT = np.ascontiguousarray(Gf.transpose(1, 2, 0))
        self.register_buffer("gT", torch.as_tensor(gT, device=dev).to(dtype))
        hier = np.asarray(hier, dtype=np.int64)
        Dh = np.ascontiguousarray(np.asarray(Dhat, np.float64)[:, hier])
        self.register_buffer("Dh", torch.as_tensor(Dh, device=dev).to(dtype))
        self.register_buffer(
            "hier", torch.as_tensor(hier.astype(np.int32), device=dev))

    def _apply(self, uT):
        return kernels.general_apply_dss(uT, self.gT, self.Dh, self.hier,
                                         self.plan)

    def _apply_batched(self, uT):
        return kernels.general_apply_dss_batched(uT, self.gT, self.Dh,
                                                 self.hier, self.plan)

    def fused_cg_kernels(self, n_rhs=None, defer_x: bool = False):
        """``(kA, kB)`` of the fused CG on this operator
        (:func:`.kernels.make_fused_cg_kernels_general`): single-RHS for
        ``n_rhs=None``, else batched.  ``defer_x`` raises: the general
        kernels carry no deferred-x mode, as in the reference."""
        if defer_x:
            raise ValueError("defer_x is not offered on the general fused "
                             "CG (curved meshes): its kernels carry no "
                             "deferred-x mode")
        return kernels.make_fused_cg_kernels_general(
            self.gT, self.Dh, self.hier, self.plan, n_rhs)

    def fused_cg_kernel_single(self, defer_x: bool = False):
        """Raises: the single-kernel iteration exists for affine meshes
        only, as in the reference."""
        raise ValueError("cg_kernel='fused1' requires an affine mesh (the "
                         "general fused CG uses the kernel pair)")


STRUCTURES = ("auto", "general", "affine")


def make_local_laplacian_operator(exchange, Gf, Dhat, free_local=None,
                                  assume_masked_input: bool = False,
                                  device=None, structure: str = "auto"):
    """Weak Laplacian acting on transposed (n, E) hierarchical L-vectors
    (the reference's ``vector_layout="ne"``).

    ``Gf``: (E, 3, n) lex-flattened geometric factors; their dtype is the
    operator's.  ``Dhat``: (2n, n) from :func:`make_stacked_derivative`.
    ``free_local``: optional (n, E) bool mask for symmetric Dirichlet
    elimination.  ``device``: the CUDA card unless given (see
    :func:`..config.resolve_device`).  ``structure``: ``"auto"`` detects
    affine meshes (:func:`affine_factorization`) and takes the
    :class:`AffineLaplacianT`, else the :class:`GeneralLaplacianT`;
    ``"general"`` forces the full factor slabs; ``"affine"`` requires an
    affine mesh (``ValueError`` otherwise).
    """
    if structure not in STRUCTURES:
        raise ValueError(f"unknown structure {structure!r}")
    if not hasattr(exchange, "plan") or exchange.n_edge_tail or \
            exchange.n_vert_tail:
        raise NotImplementedError(
            "the apply kernels need a tail-free roll-class exchange "
            "(RollExchange); the generic-gather DSS has no kernel yet")
    Gf = np.asarray(Gf)
    if Gf.shape[0] != exchange.E:
        raise ValueError(f"factors have {Gf.shape[0]} rows, the exchange "
                         f"{exchange.E} elements")
    plan = exchange.plan(resolve_device(device))
    dtype = torch_dtype(Gf.dtype)
    if structure != "general":
        Wgrid = exchange.disc.basis.weight_grid().reshape(-1)
        a, exact = affine_factorization(Gf, Wgrid)
        if exact:
            Kcat = make_affine_element_matrices(Dhat, Wgrid,
                                                order=exchange.hier)
            return AffineLaplacianT(Kcat, a, plan, free_local,
                                    assume_masked_input=assume_masked_input,
                                    dtype=dtype)
        if structure == "affine":
            raise ValueError("mesh is not affine but structure='affine'")
    return GeneralLaplacianT(Gf, Dhat, exchange.hier, plan, free_local,
                             assume_masked_input=assume_masked_input,
                             dtype=dtype)


def make_multi_rhs_laplacian_T(exchange, Gf, Dhat, n_rhs: int,
                               free_local=None,
                               assume_masked_input: bool = False,
                               device=None, structure: str = "auto"):
    """Batched-RHS transposed weak Laplacian: (k, n, E) -> (k, n, E).

    The ``n_rhs`` right-hand sides share one operator (the affine blocks
    and scales, or the general factor slabs, and the class tables), applied
    by one launch of :func:`.kernels.affine_apply_dss_batched` or
    :func:`.kernels.general_apply_dss_batched` for the whole stack, which
    reads the slabs once per element tile for all k; ``free_local`` masks
    each RHS.  Arguments as in :func:`make_local_laplacian_operator`.
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    return make_local_laplacian_operator(
        exchange, Gf, Dhat, free_local, assume_masked_input, device,
        structure).stacked(n_rhs)
