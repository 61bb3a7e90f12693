"""Matrix-free Laplacian on L-vectors and global vectors (PyTorch port).

Port of the parts of the JAX package's ``ops/sumfac.py`` that the 2D and 3D
solves run.  The global-vector helpers (:func:`gather`, :func:`scatter_add`,
:func:`laplacian_apply_local`, :func:`laplacian_apply`,
:func:`make_poisson_operator`, :func:`laplacian_diag_local`,
:func:`mass_apply_local`, :func:`masked`) are plain ``torch.einsum`` and
fixed-order sums (:func:`.exchange.accumulate`), as the reference leaves
them to XLA.

On the transposed (n, E) layout (the main path's): on an affine cell the local
weak Laplacian collapses to ``A_e = a0(e) K0 + a1(e) K1 + a2(e) K2`` with
three fixed (n, n) matrices (:func:`make_affine_element_matrices`) and
three scalars per element (:func:`affine_factorization`); the operator is
then ``DSS(sum_c a_c K_c u)`` (:class:`AffineLaplacianT`, one hand-written
CUDA kernel, :func:`.kernels.affine_apply_dss`, which computes the product
in tensor-product form from :func:`affine_tensor_factors`).  A curved mesh
or a variable coefficient keeps the full (3, n, E) factor slabs
(:class:`GeneralLaplacianT`: ``DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us])``
with ``[ur; us] = Dhat u``, :func:`.kernels.general_apply_dss`).
:func:`make_local_laplacian_operator` picks one by the reference's
``structure`` rule; ``.stacked(k)`` gives either on (k, n, E) stacks
(:func:`make_multi_rhs_laplacian_T`).  Either takes the reference's
``max_halo``/``far_mode``: an integer ``max_halo`` splits the roll classes
at that |delta| (:meth:`.DSSPlan.split`), the apply gathers the near ones
and :func:`.kernels.far_update` adds the far ones; ``max_halo="auto"``
splits nothing in the port (a deliberate divergence: the reference's rule
weighs TPU VMEM windows that the CUDA gather pass does not have).  On
row-major (E, n) L-vectors (``vector_layout="en"``) the operator is
:class:`LaplacianEN`: the local product by ``torch.matmul``
(``backend="xla"``) or by the hand-written element-local kernel
(``backend="pallas"``, :func:`.kernels.laplacian_local`), then the
exchange's ``dss``.

On hexahedra (3D) the local products act along one axis of (E, p0, p1, p2)
fields at a time (:func:`apply_axis`: batched ``torch.matmul``/``bmm``, as
the reference's einsums are XLA): :func:`laplacian_apply_local_3d` (full
factors), :func:`laplacian_apply_local_3d_affine` (six scales per
element) and :func:`laplacian_apply_local_3d_separable` (axis-aligned
boxes: three assembled 1D stiffness products), the transposed forms the
reference's tests call, and :class:`Laplacian3D`, the operator on (E, n)
L-vectors built by :func:`make_laplacian_3d` with the reference's
structure rule (:func:`structure_3d`).

The host helpers are numpy copies of the reference's, with one deliberate
divergence: :func:`affine_factorization` measures each element against its
own scale (ROADMAP Queue 3).  The reference's multi-RHS apply chunks its
batch in pairs to fit TPU VMEM, and pads its factors to its padded
exchange; here the whole stack is one launch and the exchange is padded
only for a shard count (:mod:`..parallel`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..basis import gll_basis_2d
from ..config import (canonical_device, check_precision, resolve_device,
                      torch_dtype)
from ..mesh.geometry import Quadrilateral
from . import kernels
from .exchange import DSSPlan, accumulate, edges_first_order


def gather(u, gather_nodes, shape):
    """(n_nodes,) -> (E, *shape) element-local values."""
    return u[gather_nodes].reshape((-1,) + tuple(shape))


def scatter_add(vals, gather_nodes, n_nodes):
    """(E, *shape) -> (n_nodes,) direct stiffness summation."""
    return accumulate(n_nodes, gather_nodes, vals)


def grad_2d(ue, D0, D1):
    """Parametric gradient of (E, p0, p1) local fields: (ur, us)."""
    ur = torch.einsum("mj,ejn->emn", D0, ue)
    us = torch.einsum("nk,emk->emn", D1, ue)
    return ur, us


def grad_transpose_2d(fr, fs, D0, D1):
    """Adjoint of :func:`grad_2d`: v = D0^T fr + fs D1."""
    return (torch.einsum("mp,emq->epq", D0, fr)
            + torch.einsum("nq,epn->epq", D1, fs))


def laplacian_apply_local(ue, G, D0, D1):
    """Local weak Laplacian: v_e = B_e^T (G . B_e u_e).

    ``G``: (E, 3, p0, p1) packed [G00, G01, G11] geometric factors.
    """
    ur, us = grad_2d(ue, D0, D1)
    fr = G[:, 0] * ur + G[:, 1] * us
    fs = G[:, 1] * ur + G[:, 2] * us
    return grad_transpose_2d(fr, fs, D0, D1)


def laplacian_apply(u, gather_nodes, G, D0, D1, n_nodes):
    """Global matrix-free weak Laplacian: scatter(local(gather(u)))."""
    ue = gather(u, gather_nodes, G.shape[-2:])
    return scatter_add(laplacian_apply_local(ue, G, D0, D1), gather_nodes,
                       n_nodes)


def laplacian_diag_local(G, D0, D1):
    """Diagonal of the local weak Laplacian (for Jacobi preconditioning);
    the tensor twin of :func:`laplacian_diag_local_host`."""
    d0 = torch.einsum("emq,mp->epq", G[:, 0], D0**2)
    d1 = torch.einsum("epn,nq->epq", G[:, 2], D1**2)
    cross = (2.0 * G[:, 1] * torch.diagonal(D0)[:, None]
             * torch.diagonal(D1)[None, :])
    return d0 + d1 + cross


def mass_apply_local(ue, detJxW):
    """Local weak identity (mass) operator on the GLL-collocated rule:
    diagonal, M_e u_e = detJxW * u_e."""
    return detJxW * ue


def masked(u, free_mask):
    """Zero entries not in the free set (Dirichlet elimination helper)."""
    return torch.where(free_mask, u, 0.0)


def make_poisson_operator(gather_nodes, G, D0, D1, n_nodes, free_mask):
    """``A(u)``: the weak Laplacian on global vectors restricted to the free
    DOFs.  Dirichlet DOFs are eliminated symmetrically (input and output
    zeroed on them), so CG on ``A`` solves ``A_ff u_f = r_f``."""

    def apply(u):
        v = laplacian_apply(masked(u, free_mask), gather_nodes, G, D0, D1,
                            n_nodes)
        return masked(v, free_mask)

    return apply


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


def affine_tensor_factors(Kcat) -> kernels.AffineFactors:
    """The tensor-product factors of the assembled blocks ``Kcat``, the
    operand of the affine apply kernels.

    ``Kcat`` (n, 3n) = [K0 | K1 | K2] with n = M^2 must be
    :func:`make_affine_element_matrices` of the degree M - 1 GLL basis
    (this package's own weights and derivative, the derivative in float64
    or rounded to float32 as a float32 model builds it) in the exchanges'
    edges-first node order, to 1e-12 of its max, checked in float64.  Returns their
    :class:`.kernels.AffineFactors`; raises ``ValueError`` otherwise.
    """
    Kcat = np.asarray(Kcat, dtype=np.float64)
    n = Kcat.shape[0]
    m = int(round(n ** 0.5))
    if Kcat.shape != (n, 3 * n) or m * m != n:
        raise ValueError(f"Kcat of shape {Kcat.shape}: the affine kernels "
                         "take the (n, 3n) blocks of an M x M node grid")
    basis = gll_basis_2d(m - 1)
    D = np.asarray(basis.subbases[0].D1, np.float64)
    W = np.asarray(basis.weight_grid(), np.float64).reshape(-1)
    hier = edges_first_order(Quadrilateral(m, m).hierarchical_node_order,
                             4 * (m - 2))
    tol = 1e-12 * np.abs(Kcat).max()
    for D_ in (D, D.astype(np.float32)):
        Dhat = make_stacked_derivative(D_, D_)
        if np.abs(make_affine_element_matrices(Dhat, W, order=hier)
                  - Kcat).max() <= tol:
            Kst = np.stack([Kcat[:, c * n:(c + 1) * n] for c in range(3)])
            return kernels.AffineFactors(
                np.asarray(Dhat, np.float64)[:, hier], W, hier, Kst)
    raise ValueError(
        f"Kcat (n={n}) is not the stiffness blocks of the degree {m - 1} GLL "
        "basis in the edges-first node order (to 1e-12 of its max): the "
        "CUDA apply computes sum_c a_c K_c u in tensor-product form from "
        "that basis's derivative and weights, and takes no other Kcat")


def _kernel_factors(make, n: int, device):
    """``make()``, the tables an operator's kernels read, on ``device``.  On
    a CUDA device an operator without them (``make`` raises
    ``ValueError``) raises where a kernel is compiled for its n: the
    kernels take no other.  Otherwise it gets None: the plain version
    reads the operator's dense arrays alone, and the apply raises for an n
    without a kernel."""
    try:
        return make()
    except ValueError:
        if torch.device(device).type == "cuda" and n in kernels.APPLY_N:
            raise
        return None


def _operator_factors(Kcat, device) -> kernels.AffineFactors | None:
    """:func:`affine_tensor_factors` of an affine operator on ``device``
    (None or a raise as :func:`_kernel_factors` says)."""
    return _kernel_factors(lambda: affine_tensor_factors(Kcat),
                           np.shape(Kcat)[0], device)


def _general_factors(Dh, hier, device) -> kernels.GeneralFactors | None:
    """The :class:`.kernels.GeneralFactors` of a curved operator's ``Dh``
    (columns in the L-vector order ``hier``) on ``device`` (None or a
    raise as :func:`_kernel_factors` says)."""
    return _kernel_factors(lambda: kernels.GeneralFactors(Dh, hier),
                           np.shape(Dh)[-1], device)


def _rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in float32: products of
    such operands are exact in float32 and their sums accumulate there, the
    reference's ``preferred_element_type=float32`` dots."""
    return x.to(compute_dtype).to(torch.float32)


class LaplacianT(torch.nn.Module):
    """Weak Laplacian on (n, E) L-vectors, or on (n_rhs, n, E) stacks
    (:meth:`stacked`): the Dirichlet masking shared by the affine and the
    general operator around their apply kernels.

    ``plan`` given: the ``"fused"`` operator, whose apply is the
    hand-written apply+DSS kernel of the subclass (its plain version on the
    CPU).  ``plan=None`` with ``exchange`` and ``device``: the ``"xla"``
    operator, the element-local product as PyTorch tensor operations
    followed by ``exchange.dss_T`` (the reference's XLA path: any dtype,
    order or exchange, tails included; it launches no kernel).
    :attr:`_backend` names which, as the reference's operator does.

    ``free_local`` (optional (n, E) bool) applies the symmetric Dirichlet
    elimination: the output is zeroed on Dirichlet rows, and so is the
    input unless ``assume_masked_input`` (true by induction for CG
    iterates, which saves one pass per apply).  ``plan`` is the exchange's
    :class:`.DSSPlan` on the operator's device.

    ``compute_dtype`` (the ``"xla"`` operator only): the dtype the product
    rounds its inputs to (the vector, the scaled vector or the fluxes, and
    the element matrices), accumulating in float32 and returning the
    vector's dtype, as the reference's reduced-precision products do.
    ``precision``: the reference's tier (:data:`..config.PRECISIONS`);
    every tier computes true float32 here.

    ``max_halo`` (the reference's, on its single-RHS applies): an integer
    sends the classes with |delta| above it through the far update
    (``far_plan`` is then the far half of the plan); ``None`` or
    ``"auto"`` splits nothing.  ``far_mode``: ``"kernel"`` (and ``"auto"``)
    launches :func:`.kernels.far_update`, ``"xla"`` runs its plain version
    (the reference's explicit epilogue mode: the caller's choice, not a
    fallback).  A split operator refuses :meth:`stacked`, as the reference
    keeps its k-RHS applies whole.
    """

    #: right-hand sides of a stacked operator (None: one (n, E) L-vector)
    n_rhs = None
    #: "affine" or "general" (the reference's ``_structure``)
    structure = None

    def __init__(self, plan: DSSPlan | None, n: int, free_local=None,
                 assume_masked_input: bool = False, max_halo="auto",
                 far_mode: str = "auto", *, exchange=None, device=None,
                 compute_dtype=None, precision: str = "highest"):
        super().__init__()
        #: the precision tier asked for (every tier computes true float32)
        self.precision = check_precision(precision)
        #: the dtype the "xla" product rounds its inputs to, or None
        self.compute_dtype = torch_dtype(compute_dtype)
        if plan is not None and compute_dtype is not None:
            raise ValueError(
                f"compute_dtype={compute_dtype!r} is an 'xla' option: the "
                "apply kernels compute in float32 (use precision=)")
        if plan is None:
            if exchange is None:
                raise ValueError("the 'xla' operator (plan=None) takes the "
                                 "exchange whose dss_T it runs")
            self._backend = "xla"
            self._dss = exchange.dss_T
            self.E = int(exchange.E)
            self.device = canonical_device(resolve_device(device))
        else:
            self._backend = "fused"
            self.E, self.device = plan.E, plan.device
        self.register_buffer(
            "free", None if free_local is None
            else torch.as_tensor(free_local, device=self.device))
        self.plan = plan
        self.n_loc = int(n)
        self.assume_masked_input = bool(assume_masked_input)
        if far_mode not in FAR_MODES:
            raise ValueError(f"unknown far_mode {far_mode!r}")
        #: (near plan, far plan) of a split DSS, or None
        self._split = None
        if max_halo not in (None, "auto"):
            if plan is None:
                raise ValueError("max_halo splits the apply kernels' DSS; "
                                 "the 'xla' operator has no split")
            near, far = plan.split(int(max_halo))
            if far.n_entries:
                self._split = (near, far)
        self._far_update = (kernels.far_update_plain if far_mode == "xla"
                            else kernels.far_update)

    @property
    def far_plan(self) -> DSSPlan | None:
        """The far classes' plan when ``max_halo`` split the DSS."""
        return None if self._split is None else self._split[1]

    def _split_apply(self, apply, uT):
        """``apply(uT, plan, aux)`` with the whole plan, or with the near
        plan and the far update after it."""
        if self._split is None:
            return apply(uT, self.plan, False)
        near, far = self._split
        out, aux = apply(uT, near, True)
        return self._far_update(out, aux, far)

    def _refuse_split(self, what: str) -> None:
        if self._split is not None:
            raise ValueError(f"the far split (max_halo) {what} with "
                             "max_halo=None")

    def _refuse_xla(self) -> None:
        """The fused CG kernels take a ``"fused"`` operator only (the
        reference's ``fused_ok``)."""
        if self._backend != "fused":
            raise ValueError(
                "the fused CG kernels require the fused backend (float32 "
                "factors, a tail-free roll-class exchange and an order with "
                f"a kernel); this operator's backend is {self._backend!r}")

    def stacked(self, n_rhs: int) -> "LaplacianT":
        """This operator on (n_rhs, n, E) stacks (the buffers are
        shared)."""
        if n_rhs < 1:
            raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
        self._refuse_split("is single-RHS only: build the k-RHS operator")
        op = copy.copy(self)
        op.n_rhs = int(n_rhs)
        return op

    def masked(self, free_local, assume_masked_input: bool = False):
        """This operator with another Dirichlet mask (None: unmasked); the
        other buffers are shared."""
        op = copy.copy(self)
        op._buffers = dict(self._buffers)
        op.free = (None if free_local is None
                   else torch.as_tensor(free_local, device=self.device))
        op.assume_masked_input = bool(assume_masked_input)
        return op

    def forward(self, uT: torch.Tensor) -> torch.Tensor:
        if self.free is not None and not self.assume_masked_input:
            uT = torch.where(self.free, uT, 0.0)
        if self.n_rhs is not None:
            n, E = self.n_loc, self.E
            if tuple(uT.shape) != (self.n_rhs, n, E):
                raise ValueError(f"expected ({self.n_rhs}, {n}, {E}) batched "
                                 f"L-vectors, got {tuple(uT.shape)}")
        if self._backend == "xla":
            vT = self._dss(self._local(uT))
        elif self.n_rhs is None:
            vT = self._apply(uT)
        else:
            vT = self._apply_batched(
                uT.reshape(self.n_rhs * n, E)).reshape(uT.shape)
        if self.free is not None:
            vT = torch.where(self.free, vT, 0.0)
        return vT


#: why a split operator refuses the fused CG kernels
_FUSED_SPLIT = ("is not carried by the fused CG kernels yet (their "
                "cheap_far option, ROADMAP Queue 2's later options): build "
                "the operator")


class AffineLaplacianT(LaplacianT):
    """Weak Laplacian ``DSS(sum_c a_c K_c u)`` on an affine mesh.

    ``Kcat`` (n, 3n) = [K0 | K1 | K2] in the L-vector node order, ``a``
    (E, 3) affine scales; the rest as in :class:`LaplacianT`.  The apply
    is :func:`.kernels.affine_apply_dss` (``affine_apply_dss_batched`` on
    stacks) — the CUDA kernel on a CUDA tensor, computing the product in
    tensor-product form from :attr:`factors`
    (:func:`affine_tensor_factors` of ``Kcat``: on a CUDA device a
    ``Kcat`` without them raises), its plain PyTorch version on the CPU.
    """

    structure = "affine"

    def __init__(self, Kcat, a, plan: DSSPlan | None, free_local=None,
                 assume_masked_input: bool = False, dtype=torch.float32,
                 max_halo="auto", far_mode: str = "auto", *, exchange=None,
                 device=None, compute_dtype=None, precision: str = "highest"):
        Kcat = np.asarray(Kcat, dtype=np.float64)
        n = Kcat.shape[0]
        super().__init__(plan, n, free_local, assume_masked_input, max_halo,
                         far_mode, exchange=exchange, device=device,
                         compute_dtype=compute_dtype, precision=precision)
        dev = self.device
        Kst = np.stack([Kcat[:, c * n:(c + 1) * n] for c in range(3)])
        self.register_buffer(
            "Kst", torch.as_tensor(Kst, device=dev).to(dtype).contiguous())
        aT = np.ascontiguousarray(np.asarray(a, dtype=np.float64).T)
        self.register_buffer("aT", torch.as_tensor(aT, device=dev).to(dtype))
        #: the blocks' tensor-product factors (host arrays; None on the
        #: CPU for a Kcat that has none, and for the 'xla' operator)
        self.factors = (_operator_factors(Kcat, dev)
                        if self._backend == "fused" else None)

    def _local(self, uT):
        cd = self.compute_dtype
        if cd is None:
            return kernels._local_product(uT, self.Kst, self.aT)
        S = sum(torch.matmul(_rounded(self.Kst[c], cd),
                             _rounded(uT * self.aT[c], cd)) for c in range(3))
        return S.to(uT.dtype)

    def _apply(self, uT):
        return self._split_apply(
            lambda u, pl, aux: kernels.affine_apply_dss(
                u, self.Kst, self.aT, pl, aux=aux, factors=self.factors),
            uT)

    def _apply_batched(self, uT):
        return kernels.affine_apply_dss_batched(
            uT, self.Kst, self.aT, self.plan, factors=self.factors)

    def fused_cg_kernels(self, n_rhs=None, defer_x: bool = False):
        """``(kA, kB)`` of the fused CG on this operator: single-RHS
        (:func:`.kernels.make_fused_cg_kernels`) for ``n_rhs=None``, else
        batched for ``n_rhs`` right-hand sides.  A split or an ``"xla"``
        operator raises."""
        self._refuse_xla()
        self._refuse_split(_FUSED_SPLIT)
        if n_rhs is None:
            return kernels.make_fused_cg_kernels(
                self.Kst, self.aT, self.plan, defer_x=defer_x,
                factors=self.factors)
        return kernels.make_fused_cg_kernels_batched(
            self.Kst, self.aT, self.plan, n_rhs, defer_x=defer_x,
            factors=self.factors)

    def fused_cg_kernel_single(self, defer_x: bool = False):
        """``kAB`` of the single-kernel CG iteration on this operator
        (:func:`.kernels.make_fused_cg_kernel_single`; ``cg_fused`` with
        ``kB=None``).  A split or an ``"xla"`` operator raises."""
        self._refuse_xla()
        self._refuse_split(_FUSED_SPLIT)
        return kernels.make_fused_cg_kernel_single(
            self.Kst, self.aT, self.plan, defer_x=defer_x,
            factors=self.factors)


class GeneralLaplacianT(LaplacianT):
    """Weak Laplacian on a curved (non-affine) mesh, with full factor slabs:
    ``DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us])``, ``[ur; us] = Dhat u``.

    ``Gf`` (E, 3, n): the lex-ordered geometric factors (their slabs are
    kept as ``gT`` (3, n, E)); ``Dhat`` (2n, n): the stacked derivative of
    :func:`make_stacked_derivative` in lex order (kept as ``Dh``, its
    columns permuted into the L-vector order); ``hier`` (n,): the exchange's
    local node order (L-vector row -> lex node); the rest as in
    :class:`LaplacianT`.  The apply is :func:`.kernels.general_apply_dss`
    (``general_apply_dss_batched`` on stacks) — the CUDA kernel on a CUDA
    tensor, computing the product in tensor-product form from
    :attr:`factors` (the :class:`.kernels.GeneralFactors` of ``Dh`` as
    stored, built once here: on a CUDA device a ``Dhat`` without them
    raises), its plain PyTorch version on the CPU.
    """

    structure = "general"

    def __init__(self, Gf, Dhat, hier, plan: DSSPlan | None,
                 free_local=None, assume_masked_input: bool = False,
                 dtype=torch.float32, max_halo="auto",
                 far_mode: str = "auto", *, exchange=None, device=None,
                 compute_dtype=None, precision: str = "highest"):
        Gf = np.asarray(Gf)
        E, three, n = Gf.shape
        super().__init__(plan, n, free_local, assume_masked_input, max_halo,
                         far_mode, exchange=exchange, device=device,
                         compute_dtype=compute_dtype, precision=precision)
        if three != 3 or E != self.E:
            raise ValueError(f"factors of shape {Gf.shape}; expected "
                             f"({self.E}, 3, n)")
        dev = self.device
        gT = np.ascontiguousarray(Gf.transpose(1, 2, 0))
        self.register_buffer("gT", torch.as_tensor(gT, device=dev).to(dtype))
        hier = np.asarray(hier, dtype=np.int64)
        Dh = torch.as_tensor(np.ascontiguousarray(
            np.asarray(Dhat, np.float64)[:, hier])).to(dtype)
        #: the tensor-product tables of ``Dh`` as stored (host arrays;
        #: None on the CPU for a Dhat that has none, and for the 'xla'
        #: operator)
        self.factors = (_general_factors(Dh.double().numpy(), hier, dev)
                        if self._backend == "fused" else None)
        self.register_buffer("Dh", Dh.to(dev))
        self.register_buffer(
            "hier", torch.as_tensor(hier.astype(np.int32), device=dev))

    def _local(self, uT):
        cd = self.compute_dtype
        if cd is None:
            return kernels._general_local(uT, self.gT, self.Dh)
        n, g = self.n_loc, self.gT
        D = _rounded(self.Dh, cd)
        grads = torch.matmul(D, _rounded(uT, cd))
        ur, us = grads[..., :n, :], grads[..., n:, :]
        flux = torch.cat([_rounded(g[0] * ur + g[1] * us, cd),
                          _rounded(g[1] * ur + g[2] * us, cd)], dim=-2)
        return torch.matmul(D.T, flux).to(uT.dtype)

    def _apply(self, uT):
        return self._split_apply(
            lambda u, pl, aux: kernels.general_apply_dss(
                u, self.gT, self.Dh, self.hier, pl, aux=aux,
                factors=self.factors), uT)

    def _apply_batched(self, uT):
        return kernels.general_apply_dss_batched(
            uT, self.gT, self.Dh, self.hier, self.plan, factors=self.factors)

    def fused_cg_kernels(self, n_rhs=None, defer_x: bool = False):
        """``(kA, kB)`` of the fused CG on this operator
        (:func:`.kernels.make_fused_cg_kernels_general`): single-RHS for
        ``n_rhs=None``, else batched.  ``defer_x`` raises: the general
        kernels carry no deferred-x mode, as in the reference, and so
        does a split or an ``"xla"`` operator."""
        self._refuse_xla()
        self._refuse_split(_FUSED_SPLIT)
        if defer_x:
            raise ValueError("defer_x is not offered on the general fused "
                             "CG (curved meshes): its kernels carry no "
                             "deferred-x mode")
        return kernels.make_fused_cg_kernels_general(
            self.gT, self.Dh, self.hier, self.plan, n_rhs,
            factors=self.factors)

    def fused_cg_kernel_single(self, defer_x: bool = False):
        """Raises: the single-kernel iteration exists for affine meshes
        only, as in the reference."""
        raise ValueError("cg_kernel='fused1' requires an affine mesh (the "
                         "general fused CG uses the kernel pair)")


class LaplacianEN(torch.nn.Module):
    """Weak Laplacian on row-major (E, n) L-vectors, or on (k, E, n) stacks
    of them (the reference's ``vector_layout="en"``): mask, element-local
    product, ``dss``, mask.

    ``Gf`` (E, 3, n): the lex-ordered geometric factors; ``Dhat`` (2n, n):
    the stacked derivative of :func:`make_stacked_derivative` in lex order;
    ``hier`` (n,): the local node order (L-vector column -> lex node);
    ``dss``: the exchange's DSS of (..., E, n) tensors.  ``backend``:

    * ``"xla"`` — ``torch.matmul``: with ``affine=(a, Kcat)`` (the affine
      scales (E, 3) and ``[K0 | K1 | K2]`` (n, 3n) in the L-vector order)
      the assembled-K product ``sum_c a_c (u K_c)``, else the dense
      stacked-derivative product (:func:`.kernels.laplacian_local_plain`);
    * ``"pallas"`` — the hand-written element-local kernel,
      :func:`.kernels.laplacian_local` (:func:`.kernels.
      laplacian_local_batched` on a stack, one launch for all k), which on
      CPU tensors runs its plain version.  float32 only.  The kernel reads
      ``Dhat`` in tensor-product form from :attr:`factors`, the
      :class:`.kernels.GeneralFactors` built here once (None on the CPU
      when ``Dhat`` has no such form; on a CUDA device that raises).

    ``free_local`` (optional (E, n) bool) masks input and output, as in
    :class:`LaplacianT`; ``compute_dtype`` (``"xla"`` only) and
    ``precision`` as there.  ``_structure`` and ``_backend`` name the
    resolved choice, as the reference's operator does.
    """

    def __init__(self, Gf, Dhat, hier, dss, *, backend: str = "xla",
                 affine=None, free_local=None, dtype=torch.float32,
                 device="cpu", compute_dtype=None,
                 precision: str = "highest"):
        super().__init__()
        self.precision = check_precision(precision)
        self.compute_dtype = torch_dtype(compute_dtype)
        if backend == "pallas" and compute_dtype is not None:
            raise ValueError(
                f"compute_dtype={compute_dtype!r} is an 'xla' option: the "
                "element-local kernel computes in float32 (use precision=)")
        Gf = np.asarray(Gf)
        if Gf.ndim != 3 or Gf.shape[1] != 3:
            raise ValueError(f"factors of shape {Gf.shape}; expected "
                             "(E, 3, n)")
        self.dss = dss
        self._backend = backend
        self._structure = "general" if affine is None else "affine"
        hier = np.asarray(hier, dtype=np.int64)
        Dh = np.ascontiguousarray(np.asarray(Dhat, np.float64)[:, hier])
        self.register_buffer("Dh", torch.as_tensor(Dh, device=device)
                             .to(dtype))
        self.register_buffer(
            "hier", torch.as_tensor(hier.astype(np.int32), device=device))
        #: the element-local kernel's tables (backend "pallas")
        self.factors = (_general_factors(Dh, hier, device)
                        if backend == "pallas" else None)
        if backend == "pallas" or affine is None:
            g = np.ascontiguousarray(Gf.transpose(1, 0, 2))   # (3, E, n)
            self.register_buffer("g", torch.as_tensor(g, device=device)
                                 .to(dtype))
        else:
            a, Kcat = affine
            self.register_buffer("a", torch.as_tensor(
                np.asarray(a, np.float64), device=device).to(dtype))
            self.register_buffer("Kcat", torch.as_tensor(
                np.asarray(Kcat, np.float64), device=device).to(dtype))
        #: the factor slabs rounded to compute_dtype, built once
        self.register_buffer(
            "g_rounded", None if self.compute_dtype is None
            or affine is not None else _rounded(self.g, self.compute_dtype))
        self.register_buffer(
            "free", None if free_local is None
            else torch.as_tensor(free_local, device=device))

    def masked(self, free_local, assume_masked_input: bool = False):
        """This operator with another Dirichlet mask (None: unmasked); the
        other buffers are shared.  ``assume_masked_input`` is accepted and
        ignored: the (E, n) operator masks its input, as the reference's
        does."""
        op = copy.copy(self)
        op._buffers = dict(self._buffers)
        op.free = (None if free_local is None
                   else torch.as_tensor(free_local, device=self.Dh.device))
        return op

    def local(self, uL: torch.Tensor) -> torch.Tensor:
        """The element-local product, without the DSS."""
        if self._backend == "pallas":
            if uL.dim() == 2:
                return kernels.laplacian_local(uL, self.g, self.Dh, self.hier,
                                               factors=self.factors)
            return kernels.laplacian_local_batched(uL, self.g, self.Dh,
                                                   self.hier,
                                                   factors=self.factors)
        cd = self.compute_dtype
        if self._structure == "affine":
            n = self.Kcat.shape[0]
            V = (torch.matmul(uL, self.Kcat) if cd is None else torch.matmul(
                _rounded(uL, cd), _rounded(self.Kcat, cd)))   # (..., E, 3n)
            a = self.a
            return (a[:, 0:1] * V[..., :n] + a[:, 1:2] * V[..., n:2 * n]
                    + a[:, 2:3] * V[..., 2 * n:]).to(uL.dtype)
        if cd is None:
            return kernels.laplacian_local_plain(uL, self.g, self.Dh,
                                                 self.hier)
        n = self.Dh.shape[1]
        D, g = _rounded(self.Dh, cd), self.g_rounded
        grads = torch.matmul(_rounded(uL, cd), D.T)          # (..., E, 2n)
        ur, us = grads[..., :n], grads[..., n:]
        flux = torch.cat([_rounded(g[0] * ur + g[1] * us, cd),
                          _rounded(g[1] * ur + g[2] * us, cd)], dim=-1)
        return torch.matmul(flux, D).to(uL.dtype)

    def forward(self, uL: torch.Tensor) -> torch.Tensor:
        if self.free is not None:
            uL = torch.where(self.free, uL, 0.0)
        vL = self.dss(self.local(uL))
        if self.free is not None:
            vL = torch.where(self.free, vL, 0.0)
        return vL


class LocalHelmholtzOperator:
    """``A u = mask(lap(u) + dss(kM u))`` on L-vectors of one layout.

    ``lap``: the unmasked weak Laplacian (its own DSS included);
    ``dss``: the exchange's DSS of the layout; ``kM`` and ``free``: the
    mass-weighted reaction and the free mask in the layout.  ``_raw`` is the
    unmasked operator (residual seeds), as in the reference.
    """

    def __init__(self, lap, dss, kM: torch.Tensor, free: torch.Tensor):
        self.lap, self.dss, self.kM, self.free = lap, dss, kM, free

    def _raw(self, uL: torch.Tensor) -> torch.Tensor:
        return self.lap(uL) + self.dss(self.kM * uL)

    def __call__(self, uL: torch.Tensor) -> torch.Tensor:
        return torch.where(self.free, self._raw(uL), 0.0)

    def stacked(self, k: int) -> "LocalHelmholtzOperator":
        """This operator on (k, ...) stacks of L-vectors: the (n, E)
        Laplacian takes its stacked form (one launch for the stack); the
        (E, n) one takes stacks as it is."""
        if not isinstance(self.lap, LaplacianT):
            return self
        return LocalHelmholtzOperator(self.lap.stacked(k), self.dss, self.kM,
                                      self.free)


STRUCTURES = ("auto", "general", "affine")
LAYOUTS = ("ne", "en")
FAR_MODES = ("auto", "kernel", "xla")


def make_local_laplacian_operator(exchange, Gf, Dhat, free_local=None,
                                  assume_masked_input: bool = False,
                                  device=None, structure: str = "auto",
                                  vector_layout: str = "ne",
                                  backend: str = "auto",
                                  compute_dtype=None, max_halo="auto",
                                  far_mode: str = "auto",
                                  precision: str = "highest"):
    """Weak Laplacian acting on hierarchical L-vectors.

    ``Gf``: (E, 3, n) lex-flattened geometric factors; their dtype is the
    operator's.  ``Dhat``: (2n, n) from :func:`make_stacked_derivative`.
    ``device``: the CUDA card unless given (see
    :func:`..config.resolve_device`).  ``structure``: ``"auto"`` detects
    affine meshes (:func:`affine_factorization`), ``"general"`` forces the
    full factors, ``"affine"`` requires an affine mesh (``ValueError``
    otherwise).

    ``vector_layout``: ``"ne"`` (the port's default; the reference's is
    ``"en"``) acts on transposed (n, E) L-vectors: the
    :class:`AffineLaplacianT` or the :class:`GeneralLaplacianT`, with
    ``backend`` as in the reference (:data:`NE_BACKENDS`):

    * ``"fused"`` — the hand-written apply+DSS kernels (their plain
      versions on the CPU); requires float32 factors and a tail-free
      roll-class exchange (:class:`.RollExchange`), else ``ValueError``;
      on a CUDA device an order without an apply kernel
      (:data:`.kernels.APPLY_N`) raises ``NotImplementedError``;
    * ``"xla"`` — the element-local product as PyTorch tensor operations
      and the exchange's ``dss_T``, on any device and at any order:
      float64, exchanges with tails and the generic
      :class:`.LocalExchange`; no kernel is launched;
    * ``"auto"`` — the reference's ``fused_ok`` rule: ``"fused"`` for
      float32 factors on a tail-free roll-class exchange without a
      ``compute_dtype`` (raising as ``"fused"`` does for an order without a
      kernel), else ``"xla"``.

    The choice is made here, once, from the operator's static properties,
    and recorded as the operator's ``_backend``; nothing retries another
    path after an error.  ``"pallas"`` raises there, as in the reference.
    ``"en"`` acts on row-major (E, n)
    L-vectors: the :class:`LaplacianEN` with ``backend`` ``"xla"``,
    ``"pallas"`` (float32 factors only: the kernel computes in f32, and the
    reference's would return f64-typed output of f32 accuracy) or
    ``"auto"``, which is ``"xla"`` as in the reference.
    ``free_local``: optional bool mask in the operator's layout for
    symmetric Dirichlet elimination; ``assume_masked_input`` (the (n, E)
    operators only, as in the reference) skips its input pass.
    ``compute_dtype`` (e.g. ``torch.bfloat16``; the ``"xla"`` operators of
    both layouts): the product's inputs are rounded to it, the sums
    accumulate in float32 and the result has the vector's dtype, as in the
    reference; ``backend="fused"`` or ``"pallas"`` with one raises
    ``ValueError`` (the kernels compute in float32; the reference's rule).
    ``precision``: ``"highest"``, ``"high"`` or ``"default"`` (another
    raises ``ValueError``); every tier computes true float32, on the
    kernels and in PyTorch, where the TPU's lower tiers take bf16 passes
    (a deliberate divergence, ROADMAP Queue 3).  ``max_halo`` and
    ``far_mode`` (the fused (n, E) operators only) as in
    :class:`LaplacianT`.
    """
    check_precision(precision)
    if structure not in STRUCTURES:
        raise ValueError(f"unknown structure {structure!r}")
    if vector_layout not in LAYOUTS:
        raise ValueError(f"unknown vector_layout {vector_layout!r}")
    Gf = np.asarray(Gf)
    if Gf.shape[0] != exchange.E:
        raise ValueError(f"factors have {Gf.shape[0]} rows, the exchange "
                         f"{exchange.E} elements")
    dev = resolve_device(device)
    dtype = torch_dtype(Gf.dtype)
    affine = None
    if structure != "general":
        Wgrid = exchange.disc.basis.weight_grid().reshape(-1)
        a, exact = affine_factorization(Gf, Wgrid)
        if exact:
            affine = (a, make_affine_element_matrices(Dhat, Wgrid,
                                                      order=exchange.hier))
        elif structure == "affine":
            raise ValueError("mesh is not affine but structure='affine'")
    if vector_layout == "en":
        if backend == "auto":
            # the reference's rule: its TPU kernel lost to XLA once composed
            # with the exchange, so "auto" takes the matmul product
            backend = "xla"
        if backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {backend!r} for the 'en' "
                             "layout")
        if backend == "pallas" and dtype != torch.float32:
            raise ValueError(
                f"backend='pallas' requires float32 factors, got {Gf.dtype}: "
                "the kernel computes in f32")
        if max_halo not in (None, "auto"):
            raise ValueError("max_halo splits the (n, E) applies' DSS; the "
                             "'en' layout has no split")
        return LaplacianEN(Gf, Dhat, exchange.hier, exchange.dss,
                           backend=backend, affine=affine,
                           free_local=free_local, dtype=dtype, device=dev,
                           compute_dtype=compute_dtype, precision=precision)
    backend = ne_backend(exchange, dtype, Gf.shape[-1], dev, backend,
                         compute_dtype)
    if backend == "fused":
        where = dict(plan=exchange.plan(dev))
    else:
        where = dict(plan=None, exchange=exchange, device=dev)
    kw = dict(assume_masked_input=assume_masked_input, dtype=dtype,
              max_halo=max_halo, far_mode=far_mode,
              compute_dtype=compute_dtype, precision=precision)
    if affine is not None:
        return AffineLaplacianT(affine[1], affine[0],
                                free_local=free_local, **where, **kw)
    return GeneralLaplacianT(Gf, Dhat, exchange.hier, free_local=free_local,
                             **where, **kw)


#: the (n, E) operators' backends (the reference's, without its interpret
#: modes)
NE_BACKENDS = ("auto", "fused", "xla")


def ne_backend(exchange, dtype, n: int, device,
               backend: str = "auto", compute_dtype=None) -> str:
    """``backend`` of an (n, E) operator on ``device`` resolved to
    ``"fused"`` or ``"xla"`` by the reference's ``fused_ok`` rule: the apply
    kernels take float32 factors (``dtype``), a tail-free roll-class
    exchange and no ``compute_dtype``.  ``"auto"`` takes ``"fused"`` where
    all hold, else ``"xla"``; ``"fused"`` raises ``ValueError`` where one
    fails; ``"xla"`` stays.  A fused operator on a CUDA device also needs
    an apply kernel compiled for its n (:data:`.kernels.APPLY_N`): without
    one it raises ``NotImplementedError``, whichever of ``"auto"`` and
    ``"fused"`` chose it (the reference's rule has no such limit, so
    ``"auto"`` does not turn to ``"xla"`` for it).  For an exchange of p = 1 elements (4 nodes
    each) it builds the p = 1 kernels' class tables of the exchange's plan
    (:func:`.kernels.p1_classes`, one RHS and stacks) here, so a plan
    beyond their limits raises ``ValueError`` when the operator is built
    and not at its first apply."""
    if backend not in NE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r} for the 'ne' layout")
    if backend == "xla":
        return backend
    why = []
    if torch_dtype(dtype) != torch.float32:
        why.append(f"float32 factors, got {torch_dtype(dtype)}")
    if compute_dtype is not None:
        why.append(f"no compute_dtype override (got {compute_dtype}; the "
                   "kernels compute in float32: use precision=)")
    if not hasattr(exchange, "plan") or exchange.n_edge_tail or \
            exchange.n_vert_tail:
        why.append("a tail-free roll-class exchange (RollExchange), got "
                   f"{type(exchange).__name__} with "
                   f"{getattr(exchange, 'n_edge_tail', 0)} edge and "
                   f"{getattr(exchange, 'n_vert_tail', 0)} vertex tails")
    if why:
        if backend == "fused":
            raise ValueError("backend='fused' requires " + "; ".join(why)
                             + ": the apply kernels take no other (backend="
                             "'xla' runs the plain product)")
        return "xla"
    if torch.device(device).type == "cuda" and n not in kernels.APPLY_N:
        raise NotImplementedError(
            f"no apply kernel instantiation for n={n} nodes per element "
            f"(compiled: {kernels.APPLY_N}); backend='xla' runs the plain "
            "product")
    if torch.device(device).type == "cuda" and exchange.n_loc == 4:
        plan = exchange.plan("cpu")
        for tiles in (kernels.P1_TILES, kernels.P1_TILES_STACK):
            kernels.p1_classes(plan, tiles)
    return "fused"


def make_multi_rhs_laplacian_T(exchange, Gf, Dhat, n_rhs: int,
                               free_local=None,
                               assume_masked_input: bool = False,
                               device=None, structure: str = "auto",
                               backend: str = "auto", compute_dtype=None,
                               precision: str = "highest"):
    """Batched-RHS transposed weak Laplacian: (k, n, E) -> (k, n, E).

    The ``n_rhs`` right-hand sides share one operator (the affine blocks
    and scales, or the general factor slabs, and the class tables).  The
    ``"fused"`` operator applies them by one launch of
    :func:`.kernels.affine_apply_dss_batched` or
    :func:`.kernels.general_apply_dss_batched` for the whole stack, which
    reads the slabs once per element tile for all k; the ``"xla"`` one by
    batched tensor operations and ``dss_T``.  ``free_local`` masks each
    RHS.  Arguments, ``backend``, ``compute_dtype`` and ``precision`` among
    them, as in :func:`make_local_laplacian_operator`.
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    return make_local_laplacian_operator(
        exchange, Gf, Dhat, free_local, assume_masked_input, device,
        structure, backend=backend, compute_dtype=compute_dtype,
        precision=precision).stacked(n_rhs)


# ---------------------------------------------------------------------------
# 3D hexahedra: (E, p0, p1, p2) local fields, lexicographic (E, n) L-vectors
#
# The reference computes its 3D applies outside any Pallas kernel (batched
# einsums, then the exchange's DSS); so does the port.  Every product runs
# along one axis of the trailing three as one batched GEMM: along the last
# axis a (E p0 p1, p2) x (p2, p2) product, along the first two a strided
# batch against one (p, p) matrix (batch stride 0), so no operand is
# permuted or copied.  Leading stack dimensions (k, E, ...) pass through.


def apply_axis(B: torch.Tensor, u: torch.Tensor, axis: int) -> torch.Tensor:
    """``B`` (m, p) applied along trailing axis ``axis`` (0, 1 or 2) of
    (..., p0, p1, p2) fields: ``out[..., i, ...] = sum_j B[i, j] u[..., j,
    ...]`` on that axis."""
    *lead, p0, p1, p2 = u.shape
    B = B.to(u.dtype)
    m = B.shape[0]
    if axis == 2:
        return torch.matmul(u, B.T)
    if axis == 0:
        x = u.reshape(-1, p0, p1 * p2)
        out = torch.bmm(B.expand(x.shape[0], m, p0), x)
        return out.reshape(*lead, m, p1, p2)
    x = u.reshape(-1, p1, p2)
    out = torch.bmm(B.expand(x.shape[0], m, p1), x)
    return out.reshape(*lead, p0, m, p2)


def grad_3d(ue, D0, D1, D2):
    """Parametric gradient of (E, p0, p1, p2) local fields."""
    return apply_axis(D0, ue, 0), apply_axis(D1, ue, 1), apply_axis(D2, ue, 2)


def grad_transpose_3d(f0, f1, f2, D0, D1, D2):
    """Adjoint of :func:`grad_3d`."""
    return (apply_axis(D0.T, f0, 0) + apply_axis(D1.T, f1, 1)
            + apply_axis(D2.T, f2, 2))


def laplacian_apply_local_3d(ue, G, D0, D1, D2):
    """Local 3D weak Laplacian; ``G``: (E, 6, *shape) packed upper triangle
    [G00, G01, G02, G11, G12, G22] (``laplacian_factors``)."""
    u0, u1, u2 = grad_3d(ue, D0, D1, D2)
    g = [G[:, c] for c in range(6)]
    f0 = g[0] * u0 + g[1] * u1 + g[2] * u2
    f1 = g[1] * u0 + g[3] * u1 + g[4] * u2
    f2 = g[2] * u0 + g[4] * u1 + g[5] * u2
    return grad_transpose_3d(f0, f1, f2, D0, D1, D2)


def _scales_3d(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(E, 6) per-element scales as (6, E, 1, 1, 1) in ``like``'s dtype."""
    return a.to(like.dtype).T.reshape(6, -1, 1, 1, 1)


def laplacian_apply_local_3d_affine(ue, a, W3, D0, D1, D2):
    """Affine-mesh local 3D weak Laplacian: every factor field is the
    weight grid scaled per element (``G_i(e) = a_i(e) W3``), so the apply
    reads six scalars per element instead of six factor slabs.  ``a``: (E,
    6) scales; ``W3``: (p0, p1, p2) weight grid."""
    u0, u1, u2 = grad_3d(ue, D0, D1, D2)
    s = _scales_3d(a, ue)
    w = W3.to(ue.dtype)
    f0 = w * (s[0] * u0 + s[1] * u1 + s[2] * u2)
    f1 = w * (s[1] * u0 + s[3] * u1 + s[4] * u2)
    f2 = w * (s[2] * u0 + s[4] * u1 + s[5] * u2)
    return grad_transpose_3d(f0, f1, f2, D0, D1, D2)


def assembled_1d_stiffness(D, w):
    """1D assembled GLL stiffness ``K = D^T diag(w) D`` (float64 numpy)."""
    D = np.asarray(D, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    return D.T @ (w[:, None] * D)


def laplacian_apply_local_3d_separable(ue, a, K0, K1, K2, w0, w1, w2):
    """Separable affine local 3D weak Laplacian (diagonal-mass tensor form).

    For affine cells with zero cross factors (axis-aligned boxes: ``a1 =
    a2 = a4 = 0``) and the GLL-collocated quadrature the weak Laplacian
    factorizes exactly:

        A_e = a0 K0 (x) W1 (x) W2 + a3 W0 (x) K1 (x) W2 + a5 W0 (x) W1 (x) K2

    with the 1D assembled stiffness ``Kd`` (:func:`assembled_1d_stiffness`)
    and the diagonal 1D masses ``Wd = diag(wd)``: three (p1, p1) products
    and a combine.  ``a``: (E, 6) scales (only 0, 3 and 5 are read; the
    caller verifies the cross terms vanish); ``wd``: 1D weights.
    """
    dt = ue.dtype
    w0, w1, w2 = (torch.as_tensor(w, device=ue.device).to(dt)
                  for w in (w0, w1, w2))
    s = _scales_3d(a, ue)
    v = (s[0] * (w1[:, None] * w2[None, :])) * apply_axis(K0, ue, 0)
    v = v + (s[3] * (w0[:, None, None] * w2[None, None, :])) * apply_axis(
        K1, ue, 1)
    return v + (s[5] * (w0[:, None, None] * w1[None, :, None])) * apply_axis(
        K2, ue, 2)


def laplacian_apply_3d(u, gather_nodes, G, D0, D1, D2, n_nodes):
    """Global matrix-free 3D weak Laplacian: scatter(local(gather(u)))."""
    ue = gather(u, gather_nodes, G.shape[-3:])
    return scatter_add(laplacian_apply_local_3d(ue, G, D0, D1, D2),
                       gather_nodes, n_nodes)


def laplacian_diag_local_host_3d(G, D0, D1, D2):
    """Numpy host diagonal of the local 3D weak Laplacian."""
    G = np.asarray(G)
    D0, D1, D2 = (np.asarray(D) for D in (D0, D1, D2))
    d = np.einsum("emqr,mp->epqr", G[:, 0], D0**2)
    d += np.einsum("epnr,nq->epqr", G[:, 3], D1**2)
    d += np.einsum("epqk,kr->epqr", G[:, 5], D2**2)
    dd0 = np.diag(D0)[:, None, None]
    dd1 = np.diag(D1)[None, :, None]
    dd2 = np.diag(D2)[None, None, :]
    d += 2.0 * G[:, 1] * dd0 * dd1
    d += 2.0 * G[:, 2] * dd0 * dd2
    d += 2.0 * G[:, 4] * dd1 * dd2
    return d


# -- the transposed (p0, p1, p2, E) forms ------------------------------------
# The reference measured this layout slower on its TPU and only its tests
# call these; the port keeps them for parity.


def grad_3d_T(uT, D0, D1, D2):
    """Parametric gradient in the transposed (p0, p1, p2, E) layout."""
    u0 = torch.einsum("ma,abce->mbce", D0, uT)
    u1 = torch.einsum("nb,abce->ance", D1, uT)
    u2 = torch.einsum("kc,abce->abke", D2, uT)
    return u0, u1, u2


def grad_transpose_3d_T(f0, f1, f2, D0, D1, D2):
    """Adjoint of :func:`grad_3d_T`."""
    return (torch.einsum("mp,mqre->pqre", D0, f0)
            + torch.einsum("nq,pnre->pqre", D1, f1)
            + torch.einsum("kr,pqke->pqre", D2, f2))


def laplacian_apply_local_3d_affine_T(uT, aT, W3, D0, D1, D2):
    """Affine local 3D weak Laplacian on transposed (n_loc, E) storage.
    ``aT``: (6, E) scales; ``W3``: (p0, p1, p2) weight grid."""
    n_loc = uT.shape[0]
    u0, u1, u2 = grad_3d_T(uT.reshape(tuple(W3.shape) + (-1,)), D0, D1, D2)
    s = aT.to(uT.dtype)
    w = W3.to(uT.dtype)[..., None]
    f0 = w * (s[0] * u0 + s[1] * u1 + s[2] * u2)
    f1 = w * (s[1] * u0 + s[3] * u1 + s[4] * u2)
    f2 = w * (s[2] * u0 + s[4] * u1 + s[5] * u2)
    return grad_transpose_3d_T(f0, f1, f2, D0, D1, D2).reshape(n_loc, -1)


def laplacian_apply_local_3d_T(uT, G_T, D0, D1, D2):
    """General local 3D weak Laplacian on transposed (n_loc, E) storage.
    ``G_T``: (6,) + shape + (E,) packed upper-triangle factors."""
    n_loc = uT.shape[0]
    u0, u1, u2 = grad_3d_T(uT.reshape(tuple(G_T.shape[1:4]) + (-1,)),
                           D0, D1, D2)
    f0 = G_T[0] * u0 + G_T[1] * u1 + G_T[2] * u2
    f1 = G_T[1] * u0 + G_T[3] * u1 + G_T[4] * u2
    f2 = G_T[2] * u0 + G_T[4] * u1 + G_T[5] * u2
    return grad_transpose_3d_T(f0, f1, f2, D0, D1, D2).reshape(n_loc, -1)


def laplacian_apply_local_3d_separable_T(uT, aT, K0, K1, K2, w0, w1, w2):
    """Separable affine local 3D weak Laplacian on transposed (n_loc, E)
    storage.  ``aT``: (6, E) scales (rows 0, 3 and 5 are read)."""
    w0, w1, w2 = (torch.as_tensor(w, device=uT.device).to(uT.dtype)
                  for w in (w0, w1, w2))
    n_loc = uT.shape[0]
    u = uT.reshape((len(w0), len(w1), len(w2), -1))
    t0 = torch.einsum("ma,abce->mbce", K0, u) * (
        w1[:, None] * w2[None, :])[None, :, :, None]
    t1 = torch.einsum("nb,abce->ance", K1, u) * (
        w0[:, None] * w2[None, :])[:, None, :, None]
    t2 = torch.einsum("kc,abce->abke", K2, u) * (
        w0[:, None] * w1[None, :])[:, :, None, None]
    s = aT.to(uT.dtype)
    return (s[0] * t0.reshape(n_loc, -1) + s[3] * t1.reshape(n_loc, -1)
            + s[5] * t2.reshape(n_loc, -1))


# -- the 3D L-vector operator -------------------------------------------------

STRUCTURES_3D = ("separable", "affine", "general")


class Laplacian3D:
    """Weak Laplacian on lexicographic (E, n) L-vectors of a hexahedral mesh,
    or on (..., E, n) stacks of them: the local product, then the
    exchange's :meth:`dss`, then (when ``free`` is given) the Dirichlet
    mask on the output.  As the reference's 3D operator, the input is not
    masked: CG iterates satisfy the mask by induction, and the residual
    seeds pass the Dirichlet lift through the unmasked operator.

    ``structure`` (the reference's ``_structure``, chosen by
    :func:`structure_3d`): ``"separable"`` — axis-aligned affine boxes,
    :func:`laplacian_apply_local_3d_separable` from ``a``, ``K`` and
    ``wd``; ``"affine"`` — affine cells with cross terms,
    :func:`laplacian_apply_local_3d_affine` from ``a``, ``W3`` and ``D``;
    ``"general"`` — curved cells or a variable coefficient,
    :func:`laplacian_apply_local_3d` from the (E, 6, *shape) slabs ``G``.
    Element rows past the mesh's (padding) carry zero scales or slabs.
    ``dss`` replaces the exchange's DSS (the element-sharded one of
    :func:`..parallel.halo.make_halo_dss_3d`).
    """

    def __init__(self, exchange, structure: str, shape, *, a=None, K=None,
                 wd=None, W3=None, D=None, G=None, free=None, dss=None):
        if structure not in STRUCTURES_3D:
            raise ValueError(f"unknown 3D structure {structure!r}")
        self.structure = structure
        self.dss = exchange.dss if dss is None else dss
        self.shape = tuple(shape)
        self.a, self.K, self.wd, self.W3, self.D, self.G = a, K, wd, W3, D, G
        self.free = free

    def masked(self, free) -> "Laplacian3D":
        """This operator with the output mask ``free`` (None: unmasked);
        the other tensors are shared."""
        op = copy.copy(self)
        op.free = free
        return op

    def local(self, uL: torch.Tensor) -> torch.Tensor:
        """The element-local product of (..., E, n) L-vectors (no DSS)."""
        ue = uL.reshape(*uL.shape[:-1], *self.shape)
        if self.structure == "separable":
            ve = laplacian_apply_local_3d_separable(ue, self.a, *self.K,
                                                    *self.wd)
        elif self.structure == "affine":
            ve = laplacian_apply_local_3d_affine(ue, self.a, self.W3, *self.D)
        else:
            ve = laplacian_apply_local_3d(ue, self.G, *self.D)
        return ve.reshape(uL.shape)

    def __call__(self, uL: torch.Tensor) -> torch.Tensor:
        v = self.dss(self.local(uL))
        return v if self.free is None else torch.where(self.free, v, 0.0)


def structure_3d(G, W3) -> tuple[str, np.ndarray]:
    """The reference's 3D structure rule on (E, 6, ...) factors ``G``:
    ``("separable", a)`` for affine cells without cross terms, ``("affine",
    a)`` for affine cells with them, ``("general", a)`` otherwise; ``a`` the
    (E, 6) scales of :func:`affine_factorization`."""
    G = np.asarray(G)
    a, affine = affine_factorization(G.reshape(G.shape[0], 6, -1),
                                     np.asarray(W3).reshape(-1))
    no_cross = bool(np.abs(a[:, [1, 2, 4]]).max()
                    <= 1e-12 * (np.abs(a).max() + 1e-300))
    if not affine:
        return "general", a
    return ("separable" if no_cross else "affine"), a


def make_laplacian_3d(exchange, G, basis, *, dtype, device,
                      structure: str | None = None, free=None,
                      scales=None) -> Laplacian3D:
    """The 3D weak Laplacian of the (E_real, 6, *shape) factors ``G`` on
    ``exchange``'s (E, n) L-vectors, on ``device`` in ``dtype``.

    ``structure`` None takes the reference's rule (:func:`structure_3d`);
    ``"general"`` forces the full-factor apply.  ``scales``: the ``(found,
    a)`` of :func:`structure_3d` on ``G`` when the caller has it (one pass
    over the factors fewer; ``G`` may then be None unless the structure is
    general).  The scales, stiffness matrices and weights of the separable
    form are built in float64 and cast to ``dtype``, as the reference's;
    element rows past the mesh's (padding) get zero scales or slabs.
    """
    dt = torch_dtype(dtype)
    E, Er = exchange.E, exchange.E_real
    shape = tuple(basis.coeff_shape)
    W3 = np.array(basis.weight_grid())
    found, a_np = structure_3d(G, W3) if scales is None else scales
    structure = found if structure is None else structure
    if structure not in STRUCTURES_3D:
        raise ValueError(f"unknown 3D structure {structure!r}")
    if structure != "general" and found == "general":
        raise ValueError(f"mesh is not affine but structure={structure!r}")

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(dt)

    def padded(x):
        """``x``'s rows on the exchange's E (zero rows for padding)."""
        if E == Er:
            return x
        out = np.zeros((E,) + x.shape[1:], x.dtype)
        out[:Er] = x
        return out

    # the derivative matrices at the model's dtype, as the reference's
    # host copies (its separable stiffness is built from them in float64)
    npdt = np.float64 if dt == torch.float64 else np.float32
    Dh = [np.array(basis.subbases[d].D1, dtype=npdt) for d in range(3)]
    kw = dict(D=[on(D) for D in Dh])
    if structure == "general":
        kw["G"] = on(padded(np.asarray(G).reshape((Er, 6) + shape)))
    else:
        kw["a"] = on(padded(np.asarray(a_np, np.float64)[:Er]))
        kw["W3"] = on(W3)
        if structure == "separable":
            ws = [np.array(basis.subbases[d].quad_wts) for d in range(3)]
            kw["K"] = [on(assembled_1d_stiffness(Dh[d], ws[d]))
                       for d in range(3)]
            kw["wd"] = [on(w) for w in ws]
    return Laplacian3D(exchange, structure, shape, free=free, **kw)
