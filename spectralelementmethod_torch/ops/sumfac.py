"""Matrix-free Laplacian on L-vectors and global vectors (PyTorch port).

Port of the parts of the JAX package's ``ops/sumfac.py`` that the 2D solves
run.  The global-vector helpers (:func:`gather`, :func:`scatter_add`,
:func:`laplacian_apply_local`, :func:`laplacian_diag_local`,
:func:`mass_apply_local`, :func:`masked`) are plain ``torch.einsum`` /
``index_add_``, as the reference leaves them to XLA.

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
from ..config import canonical_device, resolve_device, torch_dtype
from ..mesh.geometry import Quadrilateral
from . import kernels
from .exchange import DSSPlan, edges_first_order


def gather(u, gather_nodes, shape):
    """(n_nodes,) -> (E, *shape) element-local values."""
    return u[gather_nodes].reshape((-1,) + tuple(shape))


def scatter_add(vals, gather_nodes, n_nodes):
    """(E, *shape) -> (n_nodes,) direct stiffness summation."""
    out = torch.zeros(n_nodes, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, gather_nodes.reshape(-1), vals.reshape(-1))


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
                 far_mode: str = "auto", *, exchange=None, device=None):
        super().__init__()
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
                 device=None):
        Kcat = np.asarray(Kcat, dtype=np.float64)
        n = Kcat.shape[0]
        super().__init__(plan, n, free_local, assume_masked_input, max_halo,
                         far_mode, exchange=exchange, device=device)
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
        return kernels._local_product(uT, self.Kst, self.aT)

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
                 far_mode: str = "auto", *, exchange=None, device=None):
        Gf = np.asarray(Gf)
        E, three, n = Gf.shape
        super().__init__(plan, n, free_local, assume_masked_input, max_halo,
                         far_mode, exchange=exchange, device=device)
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
        return kernels._general_local(uT, self.gT, self.Dh)

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
    :class:`LaplacianT`.  ``_structure`` and ``_backend`` name the resolved
    choice, as the reference's operator does.
    """

    def __init__(self, Gf, Dhat, hier, dss, *, backend: str = "xla",
                 affine=None, free_local=None, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
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
        self.register_buffer(
            "free", None if free_local is None
            else torch.as_tensor(free_local, device=device))

    def local(self, uL: torch.Tensor) -> torch.Tensor:
        """The element-local product, without the DSS."""
        if self._backend == "pallas":
            if uL.dim() == 2:
                return kernels.laplacian_local(uL, self.g, self.Dh, self.hier,
                                               factors=self.factors)
            return kernels.laplacian_local_batched(uL, self.g, self.Dh,
                                                   self.hier,
                                                   factors=self.factors)
        if self._structure == "affine":
            n = self.Kcat.shape[0]
            V = torch.matmul(uL, self.Kcat)                   # (..., E, 3n)
            a = self.a
            return (a[:, 0:1] * V[..., :n] + a[:, 1:2] * V[..., n:2 * n]
                    + a[:, 2:3] * V[..., 2 * n:])
        return kernels.laplacian_local_plain(uL, self.g, self.Dh, self.hier)

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
                                  far_mode: str = "auto"):
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
      float32 factors on a tail-free roll-class exchange (raising as
      ``"fused"`` does for an order without a kernel), else ``"xla"``.

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
    ``compute_dtype`` (reduced-precision
    products) is not ported: anything but None raises.  ``max_halo`` and
    ``far_mode`` (the fused (n, E) operators only) as in
    :class:`LaplacianT`.
    """
    if compute_dtype is not None:
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the precision tiers are not "
            "ported yet (ROADMAP, ground rules)")
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
                           free_local=free_local, dtype=dtype, device=dev)
    backend = ne_backend(exchange, dtype, Gf.shape[-1], dev, backend)
    if backend == "fused":
        where = dict(plan=exchange.plan(dev))
    else:
        where = dict(plan=None, exchange=exchange, device=dev)
    kw = dict(assume_masked_input=assume_masked_input, dtype=dtype,
              max_halo=max_halo, far_mode=far_mode)
    if affine is not None:
        return AffineLaplacianT(affine[1], affine[0],
                                free_local=free_local, **where, **kw)
    return GeneralLaplacianT(Gf, Dhat, exchange.hier, free_local=free_local,
                             **where, **kw)


#: the (n, E) operators' backends (the reference's, without its interpret
#: modes)
NE_BACKENDS = ("auto", "fused", "xla")


def ne_backend(exchange, dtype, n: int, device,
               backend: str = "auto") -> str:
    """``backend`` of an (n, E) operator on ``device`` resolved to
    ``"fused"`` or ``"xla"`` by the reference's ``fused_ok`` rule: the apply
    kernels take float32 factors (``dtype``) and a tail-free roll-class
    exchange.  ``"auto"`` takes ``"fused"`` where both hold, else
    ``"xla"``; ``"fused"`` raises ``ValueError`` where one fails; ``"xla"``
    stays.  A fused operator on a CUDA device also needs an apply kernel
    compiled for its n (:data:`.kernels.APPLY_N`): without one it raises
    ``NotImplementedError``, whichever of ``"auto"`` and ``"fused"`` chose
    it (the reference's rule has no such limit, so ``"auto"`` does not
    turn to ``"xla"`` for it).  For an exchange of p = 1 elements (4 nodes
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
                               backend: str = "auto"):
    """Batched-RHS transposed weak Laplacian: (k, n, E) -> (k, n, E).

    The ``n_rhs`` right-hand sides share one operator (the affine blocks
    and scales, or the general factor slabs, and the class tables).  The
    ``"fused"`` operator applies them by one launch of
    :func:`.kernels.affine_apply_dss_batched` or
    :func:`.kernels.general_apply_dss_batched` for the whole stack, which
    reads the slabs once per element tile for all k; the ``"xla"`` one by
    batched tensor operations and ``dss_T``.  ``free_local`` masks each
    RHS.  Arguments, ``backend`` among them, as in
    :func:`make_local_laplacian_operator`.
    """
    if n_rhs < 1:
        raise ValueError(f"n_rhs must be >= 1, got {n_rhs}")
    return make_local_laplacian_operator(
        exchange, Gf, Dhat, free_local, assume_masked_input, device,
        structure, backend=backend).stacked(n_rhs)
