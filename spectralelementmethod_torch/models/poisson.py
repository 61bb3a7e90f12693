"""Poisson solver (matrix-free, element-local L-vectors, PCG) — PyTorch port.

Port of the 2D main path of the JAX package's ``models/poisson.py``:

    -div(c grad u) = f   on Omega
    u = g_D              on named Dirichlet boundaries
    n . grad u = g_N     on named Neumann boundaries

The model and its boundary data are host numpy (as in the reference);
:meth:`Poisson.solve_local` (one forcing) and :meth:`Poisson.
solve_local_batch` (k forcings, one operator) run preconditioned CG on
L-vectors on a device: the CUDA card by default, or the CPU with
``device="cpu"``, where every kernel runs its plain PyTorch version.  The
2D solve surface is the reference's: affine and curved (or
variable-coefficient) meshes with ``structure`` in {``auto``, ``general``,
``affine``}; the Jacobi, the FDM additive-Schwarz (``precond="fdm"``,
:mod:`..solver.fdm`) and the two-level p-multigrid (``precond="pmg"`` or
``{"pmg": {...}}``, :mod:`..solver.pmg`) preconditioners; the transposed
(n, E) and the row-major (E, n) layouts (``vector_layout``); reduced-
precision products (``compute_dtype``); ``cg_kernel`` in {``auto``,
``plain``, ``fused``, ``fused1``}, ``p_dtype`` in {None,
``torch.bfloat16``}, ``defer_x`` (affine meshes); ``host_loop``; the
float64-certified solve (``certify=True``,
:func:`..solver.cg.cg_refined_static`); and the global-vector
:meth:`Poisson.apply_operator` and :meth:`Poisson.solve`.

On a hexahedral (3D) mesh the same entry points run the reference's 3D
path: lexicographic (E, n) L-vectors, the sum-factorized
:class:`..ops.sumfac.Laplacian3D` (separable, affine or general by the
reference's rule) with the exchange's DSS, the Jacobi, fdm
(:func:`..solver.fdm.make_fdm_preconditioner_3d`) and pmg
(:func:`..solver.pmg.make_pmg_preconditioner_3d`) preconditioners, the
whole-batch k-RHS solve and ``certify=True``; plain CG only, so the 2D
options it does not take (``cg_kernel`` fused, ``p_dtype``, ``defer_x``,
``structure``, ``vector_layout="ne"``, ``compute_dtype``) raise
``ValueError`` naming the option.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import resolve_device, torch_dtype
from ..core.discretization import Discretization
from ..ops import sumfac
from ..solver.cg import (CGResult, auto_defer_x, auto_defer_x_batched, cg,
                         cg_batched, cg_fused, cg_fused_batched, cg_host,
                         cg_refined_static, hbm_residency_regime,
                         jacobi_preconditioner)


class PoissonSolution(NamedTuple):
    u: np.ndarray          # (n_nodes,) nodal solution (GLL nodal values)
    cg: CGResult


def _as_callable(value) -> Callable:
    if callable(value):
        return value
    return lambda *xs: np.full_like(np.asarray(xs[0], float), float(value))


def fused_cg_operands(diagT, freeT, wT, p_dtype, device):
    """Masked inverse diagonal and dot weights of the fused CG kernels.

    ``diagT``, ``freeT``, ``wT``: (n, E) numpy local operator diagonal,
    free mask and inverse-multiplicity weights.  Both outputs are zeroed on
    Dirichlet rows; with ``p_dtype=torch.bfloat16`` they are rounded to
    bf16 (they only steer the preconditioner and weigh the convergence
    metric; x and r stay float32).
    """
    free = torch.as_tensor(np.ascontiguousarray(freeT), device=device)
    diag = torch.as_tensor(np.ascontiguousarray(diagT, dtype=np.float32),
                           device=device)
    one = torch.ones_like(diag)
    zero = torch.zeros_like(diag)
    inv = torch.where(free, one / torch.where(diag != 0, diag, one), zero)
    w = torch.as_tensor(np.ascontiguousarray(wT, dtype=np.float32),
                        device=device)
    w_free = torch.where(free, w, zero)
    if p_dtype is not None:
        inv = inv.to(p_dtype)
        w_free = w_free.to(p_dtype)
    return inv, w_free


def _check_options(precond="jacobi", vector_layout="auto") -> None:
    """Raise ``ValueError`` for an unknown ``precond`` or
    ``vector_layout`` of ``solve_local`` and ``solve_local_batch``."""
    if not _is_pmg(precond) and precond not in ("jacobi", "fdm"):
        raise ValueError(f"unknown precond {precond!r}")
    if vector_layout not in ("auto",) + sumfac.LAYOUTS:
        raise ValueError(f"unknown vector_layout {vector_layout!r}")


def _is_pmg(precond) -> bool:
    """``precond`` asks for the p-multigrid preconditioner: ``"pmg"`` or a
    ``{"pmg": {...options}}`` dict, as in the reference."""
    return isinstance(precond, dict) or precond == "pmg"


def _pmg_kwargs(precond) -> dict:
    """The options of a pmg ``precond`` (the dict's ``"pmg"`` entry)."""
    return dict(precond.get("pmg", {})) if isinstance(precond, dict) else {}


def _check_3d_options(cg_kernel="auto", p_dtype=None, defer_x=0,
                      structure="auto", vector_layout="auto",
                      compute_dtype=None) -> None:
    """Raise ``ValueError`` naming an option that the 3D path does not
    take.  The reference's 3D path ignores them silently; the port refuses
    them (a pinned divergence, ROADMAP Queue 3): it runs plain CG on
    lexicographic (E, n) L-vectors (``vector_layout`` ``"auto"`` or
    ``"en"``), with the structure the mesh gives, in the model's dtype."""
    for name, value, ok in (
            ("cg_kernel", cg_kernel, cg_kernel in ("auto", "plain")),
            ("p_dtype", p_dtype, p_dtype is None),
            ("defer_x", defer_x, defer_x == 0),
            ("structure", structure, structure == "auto"),
            ("vector_layout", vector_layout, vector_layout in ("auto", "en")),
            ("compute_dtype", compute_dtype, compute_dtype is None)):
        if not ok:
            raise ValueError(
                f"{name}={value!r} is not taken by the 3D path (plain CG "
                "on (E, n) L-vectors with the structure the mesh gives, in "
                "the model's dtype)")


def _check_p_dtype(p_dtype) -> None:
    if p_dtype is not None and p_dtype != torch.bfloat16:
        raise ValueError(f"p_dtype must be None or torch.bfloat16, "
                         f"got {p_dtype}")


class BoundaryConditionMixin:
    """Named-boundary Dirichlet/Neumann handling shared by scalar models.

    Requires ``self.disc``, ``self.x_nodes``, ``self._dirichlet_mask``,
    ``self._dirichlet_vals``, ``self._neumann``, ``self.dtype``; an optional
    ``self._bc_cache`` holds device vectors built from the boundary data,
    which every BC change empties.
    """

    def set_dirichlet(self, boundary_name: str, value) -> None:
        """Essential BC u = g(x, y) on a named boundary."""
        g = _as_callable(value)
        nodes = self.disc.boundary_node_set(boundary_name)
        x = self.x_nodes[:, nodes]
        self._dirichlet_mask[nodes] = True
        self._dirichlet_vals[nodes] = g(*x)
        # Dirichlet masks are baked into cached operators: changing BCs
        # after a solve must rebuild them
        cache = getattr(self, "_op_cache", None)
        if cache:
            cache.clear()
        getattr(self, "_bc_cache", {}).clear()

    def set_neumann(self, boundary_name: str, value) -> None:
        """Natural BC: adds the surface integral ∫ g v dS to the RHS."""
        getattr(self, "_bc_cache", {}).clear()
        g = _as_callable(value)
        disc = self.disc
        ndim = disc.mesh.ndim
        for fg in disc.face_geometry_groups(boundary_name):
            gvals = g(*(fg.x[:, d] for d in range(ndim)))  # (k, m)
            contrib = gvals * fg.dSxW
            gidx = disc._face_nodes_of(fg)
            np.add.at(self._neumann, gidx.ravel(), contrib.ravel())

    def _vec(self, u, device) -> torch.Tensor:
        """A global vector (numpy or tensor) on ``device`` at the model's
        dtype."""
        return torch.as_tensor(np.asarray(u) if not isinstance(
            u, torch.Tensor) else u, device=device).to(torch_dtype(self.dtype))

    def boundary_flux(self, u: np.ndarray, boundary_name: str) -> float:
        """Outward boundary flux ∮_Γ (c ∇u)·n dS of a nodal field (host
        numpy post-processing).

        The element gradient comes from the spectral differentiation
        matrices and the inverse Jacobians, restricted to the boundary faces
        and integrated with the face quadrature; a model's ``_coeff_vals``
        ((E, *shape) diffusivity at the GLL nodes, or None for c = 1)
        weights it.
        """
        disc = self.disc
        ndim = disc.mesh.ndim
        from ..basis.tensor import apply_matrices
        from ..mesh.geometry import subface_slice

        ue = np.asarray(disc.gather(np.asarray(u, dtype=np.float64)))
        # parametric derivatives du/dxi_a: (E, *shape) each
        Ds = [np.asarray(disc.basis.subbases[d].D1) for d in range(ndim)]
        dpar = [apply_matrices(
            [Ds[a] if d == a else None for d in range(ndim)], ue, ndim)
            for a in range(ndim)]
        # physical gradient: grad_i = sum_a invJ[a, i] * du/dxi_a
        grad = np.zeros((disc.E, ndim) + disc.shape)
        for i in range(ndim):
            for a in range(ndim):
                grad[:, i] += disc.invJ[:, a, i] * dpar[a]
        if getattr(self, "_coeff_vals", None) is not None:
            grad *= self._coeff_vals[:, None]

        total = 0.0
        for fg in disc.face_geometry_groups(boundary_name):
            m = fg.local_ind.shape[1]
            gf = np.zeros((fg.cells.size, ndim, m))
            for j, (c, f) in enumerate(zip(fg.cells, fg.faces)):
                gf[j] = subface_slice(
                    int(f), grad[c], ndim).reshape(ndim, m)
            total += float(np.sum(gf * fg.n_dSxW))
        return total


class Poisson(BoundaryConditionMixin):
    """Poisson problem on a discretized 2D or 3D mesh.

    Parameters
    ----------
    disc : Discretization
        Single-component discretization.
    forcing : callable(x, y) or scalar
        Right-hand side f (default 1).
    coefficient : callable(x, y) or None
        Variable diffusivity c(x, y) for -div(c grad u); None = 1.  A
        coefficient that varies inside an element makes the factors
        non-affine, and the solves take the general (full-factor) apply,
        as on a curved mesh.
    dtype : dtype of the device solve: float64 (CPU, reference-matching
        accuracy) or float32 (the CUDA kernels take float32 only).
    """

    def __init__(self, disc: Discretization, forcing=1.0, coefficient=None,
                 dtype=np.float64):
        if disc.dpn != 1:
            raise ValueError("Poisson requires dofs_per_node=1")
        self.disc = disc
        self.dtype = dtype

        from ..utils.stages import stage

        with stage("model/coords"):
            self.x_nodes = disc.global_gll_coords()  # (2, n_nodes)

        ndim = disc.mesh.ndim
        coords = [disc.x_coeffs[:, d] for d in range(ndim)]
        coeff = None
        #: the coefficient as a callable (pmg's coarse rediscretization)
        self._coeff_fn = None
        if coefficient is not None:
            self._coeff_fn = _as_callable(coefficient)
            coeff = self._coeff_fn(*coords)
        with stage("model/factors"):
            self._G_host = np.asarray(disc.laplacian_factors(coeff),
                                      dtype=dtype)
        self._D0_host = np.asarray(disc.basis.subbases[0].D1, dtype=dtype)
        self._D1_host = np.asarray(disc.basis.subbases[1].D1, dtype=dtype)
        if ndim == 3:
            self._D2_host = np.asarray(disc.basis.subbases[2].D1,
                                       dtype=dtype)

        f_gll = _as_callable(forcing)(*coords)
        # weak forcing: ∫ f phi = scatter(f * detJxW) at collocated GLL
        # quadrature
        with stage("model/forcing"):
            self._b = disc.scatter_add(
                np.asarray(f_gll * disc.detJxW)).astype(dtype)

        self._dirichlet_mask = np.zeros(disc.n_nodes, dtype=bool)
        self._dirichlet_vals = np.zeros(disc.n_nodes)
        self._neumann = np.zeros(disc.n_nodes)
        self._exchange = None
        self._op_cache = {}
        #: the certified solve's float64 seed and lift, per device
        self._bc_cache = {}
        #: the global-vector operator's arrays, per device
        self._dev_cache = {}

    # -- global-vector operator ----------------------------------------------

    def _on(self, device) -> dict:
        """The global-vector apply's arrays on ``device`` (cached)."""
        st = self._dev_cache.get(str(device))
        if st is None:
            st = self._dev_cache[str(device)] = dict(
                G=self._vec(np.array(self._G_host), device),
                D=[self._vec(np.array(D), device) for D in self._D_hosts()],
                gix=torch.as_tensor(self.disc.gather_nodes, device=device))
        return st

    def _D_hosts(self) -> list:
        """The host derivative matrices, one per axis."""
        return [self._D0_host, self._D1_host] + (
            [self._D2_host] if self.disc.mesh.ndim == 3 else [])

    def apply_operator(self, u, device=None) -> torch.Tensor:
        """Raw weak Laplacian ``A u`` of a global (n_nodes,) vector (no BC
        masking), on ``device``: gather, local product, scatter-add
        (:func:`..ops.sumfac.laplacian_apply`, or
        :func:`..ops.sumfac.laplacian_apply_3d` on a hexahedral mesh)."""
        dev = resolve_device(device)
        st = self._on(dev)
        apply = (sumfac.laplacian_apply_3d if self.disc.mesh.ndim == 3
                 else sumfac.laplacian_apply)
        return apply(self._vec(u, dev), st["gix"], st["G"], *st["D"],
                     self.disc.n_nodes)

    def operator_diagonal(self) -> np.ndarray:
        """Assembled operator diagonal (host numpy, cached)."""
        d = getattr(self, "_diag_host", None)
        if d is None:
            from ..utils.stages import stage

            with stage("model/diagonal"):
                diag_local = (sumfac.laplacian_diag_local_host_3d
                              if self.disc.mesh.ndim == 3
                              else sumfac.laplacian_diag_local_host)
                de = diag_local(self._G_host, *self._D_hosts())
                d = np.zeros(self.disc.n_nodes, dtype=de.dtype)
                np.add.at(d, self.disc.gather_nodes.ravel(), de.ravel())
                self._diag_host = d.astype(self.dtype)
        return self._diag_host

    # -- solve -----------------------------------------------------------------

    def solve(self, tol: float = 1e-12, max_iter: int | None = None,
              host_loop: bool = False, device=None) -> PoissonSolution:
        """Jacobi PCG on global (n_nodes,) vectors, on ``device``:
        :func:`..solver.cg.cg`, or :func:`..solver.cg.cg_host` with
        ``host_loop``, in 2D and 3D.  The Dirichlet DOFs are eliminated
        symmetrically (input and output masked around
        :meth:`apply_operator`, as :func:`..ops.sumfac.
        make_poisson_operator` does); the stopping rule is ``||r|| <= tol
        ||b||`` in the Euclidean norm, as in the reference."""
        dev = resolve_device(device)
        disc = self.disc
        free = torch.as_tensor(~self._dirichlet_mask, device=dev)
        u_d = self._vec(np.where(self._dirichlet_mask, self._dirichlet_vals,
                                 0.0), dev)

        def A(u):
            v = self.apply_operator(sumfac.masked(u, free), dev)
            return sumfac.masked(v, free)

        b = self._vec(self._b, dev) + self._vec(self._neumann, dev)
        # eliminate Dirichlet DOFs: r_f = (b - A u_d)|_free
        r = sumfac.masked(b - self.apply_operator(u_d, dev), free)
        M = jacobi_preconditioner(self._vec(self.operator_diagonal(), dev),
                                  free)
        if max_iter is None:
            max_iter = max(200, 20 * int(np.sqrt(disc.ndof)))
        solver = cg_host if host_loop else cg
        res = solver(A, r, M=M, tol=tol, max_iter=max_iter)
        return PoissonSolution((u_d + res.x).cpu().numpy(), res)

    def _structure(self, structure: str) -> str:
        """``structure`` resolved against the mesh: ``"auto"`` becomes
        ``"affine"`` or ``"general"`` by :func:`..ops.sumfac.
        affine_factorization` (cached); ``"affine"`` on a curved mesh
        raises, as in the reference."""
        if structure not in sumfac.STRUCTURES:
            raise ValueError(f"unknown structure {structure!r}")
        affine = getattr(self, "_affine", None)
        if affine is None:
            W = self.disc.basis.weight_grid().reshape(-1)
            _, affine = sumfac.affine_factorization(
                self._G_host.reshape(self.disc.E, 3, -1), W)
            self._affine = affine
        if structure == "auto":
            return "affine" if affine else "general"
        if structure == "affine" and not affine:
            raise ValueError("mesh is not affine but structure='affine'")
        return structure

    def _layout(self, vector_layout: str) -> str:
        """``vector_layout`` resolved as the reference does: ``"auto"`` is
        ``"ne"`` on a roll-class exchange (:class:`..ops.exchange.
        RollExchange`, tails or not), else ``"en"``."""
        from ..ops.exchange import RollExchange, make_exchange

        if self._exchange is None:
            self._exchange = make_exchange(self.disc)
        if vector_layout != "auto":
            return vector_layout
        return "ne" if isinstance(self._exchange, RollExchange) else "en"

    def _local_setup(self, device, structure: str = "auto",
                     compute_dtype=None, vector_layout: str = "ne"):
        """Operators and Jacobi preconditioner of the L-vector solve on
        ``device``, in the layout ``vector_layout`` (``"ne"``: (n, E);
        ``"en"``: (E, n); ``"auto"`` as :meth:`_layout`), cached in
        ``_op_cache`` (cleared by set_dirichlet) under the resolved
        structure, the ``compute_dtype`` and the layout: an affine and a
        general operator of one mesh never share an entry."""
        layout = self._layout(vector_layout)
        structure = self._structure(structure)
        key = ("ctx", structure, str(compute_dtype), layout, str(device))
        ctx = self._op_cache.get(key)
        if ctx is not None:
            return ctx
        disc, ex = self.disc, self._exchange
        dt = torch_dtype(self.dtype)
        transposed = layout == "ne"
        gih = torch.as_tensor(ex.gather_hier, device=device)

        def to_local(u_global):
            u = torch.as_tensor(np.asarray(u_global), device=device).to(dt)
            lv = u[gih]
            return lv.T.contiguous() if transposed else lv

        Gf = self._G_host.reshape(disc.E, 3, -1)
        Dhat = sumfac.make_stacked_derivative(self._D0_host, self._D1_host)
        free_np = (~self._dirichlet_mask)[ex.gather_hier]
        free_np = np.ascontiguousarray(free_np.T if transposed else free_np)
        free_local = torch.as_tensor(free_np, device=device)
        A_raw = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, None, device=device, structure=structure,
            vector_layout=layout, compute_dtype=compute_dtype)
        # CG iterates are masked by induction (M masks its output, x0 = 0):
        # skip the apply's input-mask pass (the factor slabs are shared)
        A = A_raw.masked(free_local, assume_masked_input=True)
        M = jacobi_preconditioner(to_local(self.operator_diagonal()),
                                  free_local)
        ctx = dict(ex=ex, to_local=to_local, A=A, A_raw=A_raw, M=M,
                   free_local=free_local, free_np=free_np, Dhat=Dhat,
                   vector_layout=layout, transposed=transposed)
        self._op_cache[key] = ctx
        return ctx

    def _precond(self, ctx, precond, device):
        """The preconditioner of ``precond`` for the solve context ``ctx``:
        its Jacobi ``M``, the FDM additive Schwarz in its layout (cached
        under the reference's ``("M", "fdm", layout)`` and the device) or
        the pmg V-cycle (the ``"ne"`` layout only: ``"en"`` raises
        ``ValueError``, as in the reference)."""
        if _is_pmg(precond):
            if not ctx["transposed"]:
                raise ValueError("precond='pmg' requires the 'ne' layout")
            return self._pmg(ctx, precond, device)
        if precond != "fdm":
            return ctx["M"]
        from ..solver.fdm import make_fdm_preconditioner

        layout = ctx["vector_layout"]
        key = ("M", "fdm", layout, str(device))
        M = self._op_cache.get(key)
        if M is None:
            M = self._op_cache[key] = make_fdm_preconditioner(
                ctx["ex"], self._G_host, self.disc.basis, ctx["free_local"],
                dtype=self.dtype, vector_layout=layout, device=device)
        return M

    def _pmg(self, ctx, precond, device):
        """The p-multigrid preconditioner of ``precond`` for the solve
        context ``ctx``, cached under the reference's key (``"M", "pmg",
        layout, sorted options``) and the device; ``coeff_fn`` defaults to
        the model's coefficient, as in the reference."""
        from ..solver.pmg import make_pmg_preconditioner

        pmg_kw = _pmg_kwargs(precond)
        key = ("M", "pmg", "ne", tuple(sorted(pmg_kw.items())), str(device))
        M = self._op_cache.get(key)
        if M is None:
            pmg_kw.setdefault("coeff_fn", self._coeff_fn)
            M = self._op_cache[key] = make_pmg_preconditioner(
                self.disc, ctx["ex"], self._G_host.reshape(self.disc.E, 3, -1),
                ctx["A"], ~self._dirichlet_mask,
                np.asarray(self.operator_diagonal()), dtype=self.dtype,
                device=device, **pmg_kw)
        return M

    def _back(self, ctx):
        """L-vector -> global (n_nodes,) numpy, in the context's layout."""
        ex = ctx["ex"]
        return (ex.global_from_local_T if ctx["transposed"]
                else ex.global_from_local)

    def solve_local(self, tol: float = 1e-12, max_iter: int | None = None,
                    host_loop: bool = False,
                    precond: str = "jacobi",
                    structure: str = "auto",
                    compute_dtype=None,
                    vector_layout: str = "auto",
                    cg_kernel: str = "auto",
                    p_dtype=None,
                    defer_x: int | str = 0,
                    certify: bool = False,
                    device=None) -> PoissonSolution:
        """Solve with PCG on element-local L-vectors.

        The parameters are the reference's, in its order, with ``device``
        last.  On a 3D mesh: :meth:`_solve_local_3d` (``precond``,
        ``host_loop``, ``certify`` and ``max_iter`` as below; the other
        options at their defaults, or ``vector_layout="en"``).
        ``certify=True`` (float32 models) returns a solution whose
        convergence is certified against the float64-evaluated true
        residual (:meth:`_certified_solve_2d`,
        :func:`..solver.cg.cg_refined_static`) with the preconditioner
        ``precond`` asks for, in either layout; it ignores ``max_iter``,
        ``cg_kernel``, ``p_dtype`` and ``defer_x``, raises ``ValueError``
        with ``host_loop=True``, and on a float64 model does nothing, as
        in the reference.  ``host_loop=True`` runs
        :func:`..solver.cg.cg_host` (one host read per iteration) with the
        exchange's weighted ``dot_T`` (``dot`` on ``"en"``); an explicit
        fused ``cg_kernel`` ignores it, and ``"auto"`` then never fuses.
        ``precond``: ``"jacobi"``; ``"fdm"`` — the element-local FDM
        additive Schwarz (:func:`..solver.fdm.make_fdm_preconditioner`,
        in the solve's layout), built once and cached; or ``"pmg"`` /
        ``{"pmg": {...}}`` — the two-level p-multigrid V-cycle
        (:func:`..solver.pmg.make_pmg_preconditioner`, with the dict's
        options; the ``"ne"`` layout only, ``"en"`` raises ``ValueError``
        as in the reference), built once per option set and cached.  fdm
        and pmg run plain ``cg`` (``cg_host`` under ``host_loop``): the
        fused kernels hard-code Jacobi, so ``cg_kernel`` ``"fused"`` or
        ``"fused1"`` with either raises ``ValueError`` and ``"auto"`` takes
        plain CG, as in the reference.
        ``vector_layout``: ``"ne"`` — transposed (n, E) L-vectors (the
        apply kernels); ``"en"`` — row-major (E, n) ones through
        :class:`..ops.sumfac.LaplacianEN` (its ``"xla"`` backend, as the
        reference's ``"auto"``; Jacobi or fdm, plain CG, the exchange's
        ``dss`` and (E, n) weights); ``"auto"`` — ``"ne"`` on a roll-class
        exchange, else ``"en"``, the reference's rule.
        ``compute_dtype`` (e.g. ``torch.bfloat16``): the operator's
        products round their inputs to it and accumulate in float32
        (:func:`..ops.sumfac.make_local_laplacian_operator`); the (n, E)
        operator is then ``"xla"``, as the reference's rule has it.
        ``device``: where the solve runs — ``None`` is the CUDA card (and
        raises when there is none), ``"cpu"`` runs the plain PyTorch
        versions of the kernels.
        ``structure``: the apply of plain CG, of the lift and of the
        true-residual checks — ``"auto"`` detects affine meshes (the
        affine apply, :func:`..ops.kernels.affine_apply_dss`) and
        takes the full-factor apply otherwise
        (:func:`..ops.kernels.general_apply_dss`), ``"general"`` forces
        the latter, ``"affine"`` requires an affine mesh.
        The (n, E) operator's backend follows the reference's rule
        (:func:`..ops.sumfac.ne_backend`): the apply kernels for a float32
        model on a tail-free roll-class exchange without a
        ``compute_dtype`` (on the card, ``NotImplementedError`` for an
        order without an apply kernel), else the ``"xla"`` operator
        (float64 models, exchanges with tails, ``compute_dtype``); the
        fused CG kernels take the former only, and ``cg_kernel="auto"``
        then runs plain CG.
        ``cg_kernel``: ``"plain"`` — one apply per iteration plus PyTorch
        vector ops; ``"fused"`` — each iteration is a kernel pair, kernel
        A (:func:`..ops.kernels.cg_kernel_a`, or on a curved mesh
        :func:`..ops.kernels.cg_kernel_a_general`) and kernel B
        (:func:`..ops.kernels.cg_kernel_b`), float32 models, Jacobi and
        ``"ne"`` only; as in the reference, the pair follows the mesh
        whatever ``structure`` and ``compute_dtype`` say.  ``"fused1"`` —
        one kernel per iteration (:func:`..ops.kernels.cg_kernel_single`:
        the residual update is deferred into the next iteration's kernel,
        which also computes every dot product), float32 models on affine
        meshes only (a curved mesh raises, as in the reference).
        ``"auto"`` — fused (the pair) when ``p_dtype`` asks for bf16
        direction storage on the card, as the reference engages its fused
        kernels only in that mode; it never picks ``"fused1"``.
        ``p_dtype``: ``torch.bfloat16`` stores the fused-CG search
        direction in bf16 (Ap is computed from the stored direction, so
        the r recurrence stays exact).
        ``defer_x``: m >= 2 (dividing 64) defers the fused-CG solution
        update — kernel A skips x and the loop applies
        ``x += sum alpha_j p_j`` once per m iterations
        (:func:`..solver.cg.cg_fused`); only meaningful with a fused
        ``cg_kernel`` on an affine mesh (the general kernels have no
        deferred mode: an explicit fused request raises, ``"auto"`` takes
        plain CG, as in the reference).  ``"auto"`` resolves as the
        reference does (:func:`..solver.cg.auto_defer_x`).
        Iterates are mathematically those of the reference's
        ``solve_local``; the stopping rule is ``||r|| <= tol ||b||`` in the
        multiplicity-weighted norm.
        """
        dev = resolve_device(device)
        disc = self.disc
        if disc.mesh.ndim == 3:
            _check_3d_options(cg_kernel, p_dtype, defer_x, structure,
                              vector_layout, compute_dtype)
            return self._solve_local_3d(tol, max_iter, host_loop, precond,
                                        certify, dev)
        _check_options(precond, vector_layout)
        layout = self._layout(vector_layout)
        if certify and np.dtype(self.dtype) == np.float32:
            # before the float32 right-hand side is staged: the certified
            # path builds its own float64 seed
            if host_loop:
                raise ValueError("certify=True is a device path "
                                 "(host_loop=False)")
            return self._certified_solve_2d(tol, precond, structure,
                                            compute_dtype, layout, dev)
        if cg_kernel not in ("auto", "plain", "fused", "fused1"):
            raise ValueError(f"unknown cg_kernel {cg_kernel!r}")
        _check_p_dtype(p_dtype)

        ctx = self._local_setup(dev, structure, compute_dtype, layout)
        ex, to_local = ctx["ex"], ctx["to_local"]
        A, A_raw = ctx["A"], ctx["A_raw"]
        free_local = ctx["free_local"]

        # rhs and Dirichlet lift in local form
        b = np.asarray(self._b) + self._neumann
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        bL = to_local(b)
        u_dL = to_local(u_d)
        r = torch.where(free_local, bL - A_raw(u_dL), torch.zeros_like(bL))

        if max_iter is None:
            max_iter = max(200, 20 * int(np.sqrt(disc.ndof)))

        if defer_x == "auto":
            defer_x = auto_defer_x(ex.E, disc.n_loc)
        f32 = np.dtype(self.dtype) == np.float32
        single = cg_kernel == "fused1"
        want_fused = cg_kernel in ("fused", "fused1") or (
            cg_kernel == "auto" and not host_loop and p_dtype is not None
            and dev.type == "cuda")
        jacobi_ne = precond == "jacobi" and layout == "ne"
        if cg_kernel in ("fused", "fused1") and not (jacobi_ne and f32):
            raise ValueError(f"cg_kernel={cg_kernel!r} requires "
                             "precond='jacobi', vector_layout='ne' and a "
                             "float32 model")
        # the fused pair follows the mesh, not ``structure`` (the
        # reference's _build_fused_cg)
        fop = self._local_setup(dev)["A"] if jacobi_ne else None
        if cg_kernel == "auto" and (not jacobi_ne or fop._backend != "fused"
                                    or (defer_x
                                        and fop.structure == "general")):
            want_fused = False
        if want_fused and f32:
            key = ("cg_fused1" if single else "cg_fused", str(p_dtype),
                   bool(defer_x), str(dev))
            fused = self._op_cache.get(key)
            if fused is None:
                kernels_ = ((fop.fused_cg_kernel_single(bool(defer_x)), None)
                            if single
                            else fop.fused_cg_kernels(defer_x=bool(defer_x)))
                fused = self._op_cache[key] = (
                    *kernels_,
                    *self._fused_cg_operands(ex, ctx["free_np"], p_dtype,
                                             dev))
            kA, kB, inv, w_free = fused
            # A enables the true-residual restart when the bf16-direction
            # recurrence floors just above stop (see cg_fused)
            res = cg_fused(kA, kB, r, inv=inv, w_free=w_free, tol=tol,
                           max_iter=max_iter, p_dtype=p_dtype,
                           defer_x=defer_x, A=A)
        else:
            M = self._precond(ctx, precond, dev)
            if host_loop:
                res = cg_host(A, r, M=M, tol=tol, max_iter=max_iter,
                              dot=ex.dot_T if ctx["transposed"] else ex.dot)
            else:
                w = ex._weights_as(self.dtype, dev,
                                   transposed=ctx["transposed"])
                res = cg(A, r, M=M, tol=tol, max_iter=max_iter, dot_weight=w)
        uL = u_dL + res.x.to(u_dL.dtype)
        return PoissonSolution(self._back(ctx)(uL.cpu().numpy()), res)

    def _certified_solve_2d(self, tol, precond, structure, compute_dtype,
                            layout, device) -> PoissonSolution:
        """The float64-certified mixed-precision solve (``certify=True``,
        float32 models).

        :func:`..solver.cg.cg_refined_static` on the solve's float32
        operator (the apply kernels on ``"ne"``, or the ``"xla"`` operator
        of the layout and ``compute_dtype``) and preconditioner (Jacobi,
        fdm or the cached pmg V-cycle), anchored on ``A_hi``: the
        ``"xla"`` operator of the layout with float64 factors of the same
        values (for an affine mesh rebuilt as the exact rank-1 field ``a (x)
        W``, so it stays affine; a raw float32 -> float64 upcast fails the
        affine test), cached in ``_op_cache`` under the layout.  The
        float64 seed ``r_hi = free ? b - A_hi(u_d) : 0`` and the lift at
        the model dtype are cached in ``_bc_cache[device][layout]``
        (emptied by ``set_dirichlet`` and ``set_neumann``), so a repeat
        solve is bit for bit the same.  The dot weights are the exchange's
        float32 weights on the device.

        ``sol.cg`` is the float64-certified result (its ``x`` float64);
        ``u`` is ``u_d + x`` at the model dtype.  Unlike the reference, no
        host-ladder fallback above :func:`..solver.cg.
        hbm_residency_regime`: that fallback works around TPU compile
        limits, so every size runs ``cg_refined_static`` on the solve's
        operator (ROADMAP Queue 3).
        """
        from ..utils.stages import stage

        disc = self.disc
        ctx = self._local_setup(device, structure, compute_dtype, layout)
        ex, A, free_local = ctx["ex"], ctx["A"], ctx["free_local"]
        transposed = ctx["transposed"]
        M = self._precond(ctx, precond, device)
        key = ("A_hi", layout, str(device))
        A_hi = self._op_cache.get(key)
        if A_hi is None:
            with stage("certify/A_hi"):
                Gf32 = self._G_host.reshape(disc.E, 3, -1)
                W = np.asarray(disc.basis.weight_grid(),
                               np.float64).reshape(-1)
                a, exact = sumfac.affine_factorization(Gf32, W)
                Gf64 = (np.asarray(a, np.float64)[:, :, None] * W
                        if exact else Gf32.astype(np.float64))
                A_hi = self._op_cache[key] = \
                    sumfac.make_local_laplacian_operator(
                        ex, Gf64, np.asarray(ctx["Dhat"], np.float64),
                        free_local, assume_masked_input=True, device=device,
                        vector_layout=layout, backend="xla")
        seeds = self._bc_cache.setdefault(str(device), {})
        seed = seeds.get(layout)
        if seed is None:
            with stage("certify/seed"):
                local = (ex.local_T_from_global if transposed
                         else ex.local_from_global)

                def to64(v):
                    return torch.as_tensor(np.ascontiguousarray(local(
                        np.asarray(v, np.float64))), device=device)

                b = np.asarray(self._b, np.float64) + self._neumann
                u_dL64 = to64(np.where(self._dirichlet_mask,
                                       self._dirichlet_vals, 0.0))
                r_hi = torch.where(free_local, to64(b) - A_hi(u_dL64), 0.0)
                seed = seeds[layout] = (u_dL64.to(torch_dtype(self.dtype)),
                                        r_hi)
        u_dL, r_hi = seed
        res = cg_refined_static(
            A, r_hi, A_hi=A_hi, M=M, tol=tol,
            dot_weight=ex._weights_as(torch.float32, device,
                                      transposed=transposed))
        uL = u_dL + res.x.to(u_dL.dtype)
        return PoissonSolution(self._back(ctx)(uL.cpu().numpy()), res)

    def solve_local_batch(self, forcings, tol: float = 1e-12,
                          max_iter: int | None = None,
                          precond: str = "jacobi",
                          structure: str = "auto",
                          compute_dtype=None,
                          vector_layout: str = "auto",
                          cg_kernel: str = "auto",
                          p_dtype=None,
                          defer_x: int | str = 0,
                          device=None) -> PoissonSolution:
        """Solve ``-div(c grad u_j) = f_j`` for a batch of k forcings.

        One operator, one preconditioner and one CG ladder for all k
        right-hand sides: each RHS converges on its own (per-RHS alpha,
        beta and freezing), and every host synchronisation and operator
        setup is shared.  The boundary conditions currently set are shared
        by every solve, with one Dirichlet lift (one raw apply).

        ``forcings``: a sequence of k forcing fields (callables ``f(x, y)``
        or scalars), or a (k, n_nodes) array of nodal forcing values (the
        weak RHS is formed here in either case).  The parameters are the
        reference's, in its order, with ``device`` last; ``device``,
        ``structure``, ``precond``, ``compute_dtype`` and
        ``vector_layout`` as in :meth:`solve_local`.  On ``"ne"`` the plain
        ladder runs :func:`..solver.cg.cg_batched` in whole-batch mode on
        the k-stack operator (one launch per apply for the stack), with the
        preconditioner on the whole stack: Jacobi, fdm (one batched product
        per transform) or the stacked V-cycle (the reference's
        ``jax.vmap(M)``: one batched launch per apply of each level).  On
        ``"en"`` it runs ``cg_batched`` in its per-RHS mode with the
        single-vector operator and preconditioner, as the reference vmaps
        them.
        ``cg_kernel``: ``"plain"`` — :func:`..solver.cg.cg_batched` over the
        k-stack apply (:func:`..ops.kernels.affine_apply_dss_batched` or
        :func:`..ops.kernels.general_apply_dss_batched`); ``"fused"`` —
        :func:`..solver.cg.cg_fused_batched` over the batched kernel pair
        of the mesh (float32 models, Jacobi, ``"ne"``;
        ``p_dtype=torch.bfloat16`` stores the k directions in bf16);
        ``"auto"`` — fused when ``p_dtype`` asks for bf16 on the card for a
        Jacobi ``"ne"`` solve and the mesh is curved, or k >= 2, or the
        iterate is past :func:`..solver.cg.hbm_residency_regime`, as the
        reference decides.  ``defer_x``: m >= 2 dividing 64 defers every
        RHS's solution update (fused, affine meshes: on a curved mesh an
        explicit m raises and ``"auto"`` drops it, as in the reference);
        ``"auto"`` resolves by :func:`..solver.cg.auto_defer_x_batched`.

        On a 3D mesh: :meth:`_solve_local_batch_3d` (``cg_kernel``
        ``"auto"`` or ``"plain"``; the other options as in
        :meth:`solve_local`'s 3D branch).

        Returns a :class:`PoissonSolution` whose ``u`` is (k, n_nodes) and
        whose ``cg`` fields are batched (k leading axis).
        """
        dev = resolve_device(device)
        disc = self.disc
        if disc.mesh.ndim == 3:
            if cg_kernel not in ("auto", "plain"):
                raise ValueError("3D batched solves support cg_kernel="
                                 "'plain' only (no fused 3D kernels)")
            _check_3d_options(cg_kernel, p_dtype, defer_x, structure,
                              vector_layout, compute_dtype)
            return self._solve_local_batch_3d(forcings, tol, max_iter,
                                              precond, dev)
        _check_options(precond, vector_layout)
        if cg_kernel not in ("auto", "plain", "fused"):
            raise ValueError(f"unknown cg_kernel {cg_kernel!r}")
        _check_p_dtype(p_dtype)
        ctx = self._local_setup(dev, structure, compute_dtype, vector_layout)
        ex, to_local = ctx["ex"], ctx["to_local"]
        free_local, transposed = ctx["free_local"], ctx["transposed"]

        # weak RHS rows: b_j = scatter(f_j detJxW) + the shared Neumann data
        coords = [disc.x_coeffs[:, d] for d in range(disc.mesh.ndim)]
        nodal = (not callable(forcings) and hasattr(forcings, "__len__")
                 and np.asarray(forcings[0]).ndim == 1)
        if nodal:
            forcings = np.asarray(forcings, dtype=np.float64)
        rows = []
        for f in forcings:
            f_gll = (disc.gather(np.asarray(f)) if nodal
                     else np.asarray(_as_callable(f)(*coords)))
            b = disc.scatter_add(
                np.asarray(f_gll * disc.detJxW)).astype(self.dtype)
            rows.append(b + self._neumann)
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        u_dL = to_local(u_d)
        Au_d = ctx["A_raw"](u_dL)       # the shared lift: one raw apply
        R = torch.stack([torch.where(free_local, to_local(b) - Au_d, 0.0)
                         for b in rows])
        k = int(R.shape[0])
        if max_iter is None:
            max_iter = max(200, 20 * int(np.sqrt(disc.ndof)))

        defer_auto = defer_x == "auto"
        if defer_auto:
            defer_x = auto_defer_x_batched(ex.E, disc.n_loc, k)
        f32 = np.dtype(self.dtype) == np.float32
        jacobi_ne = precond == "jacobi" and transposed
        # the fused pair follows the mesh, not ``structure`` (the
        # reference's routing)
        fop = self._local_setup(dev)["A"] if jacobi_ne else None
        curved = fop is not None and fop.structure == "general"
        if cg_kernel == "auto":
            cg_kernel = ("fused" if p_dtype is not None and f32 and jacobi_ne
                         and dev.type == "cuda" and fop._backend == "fused"
                         and (curved or k >= 2
                              or hbm_residency_regime(ex.E, disc.n_loc))
                         else "plain")
        if cg_kernel == "fused" and not (jacobi_ne and f32):
            raise ValueError("batched fused CG requires the 'ne' layout, "
                             "precond='jacobi' and float32")

        if cg_kernel == "fused":
            if curved and defer_x:
                if not defer_auto:
                    raise ValueError(
                        "defer_x requires an affine mesh (the general "
                        "batched CG kernels carry no deferred-x mode)")
                defer_x = 0
            fkey = ("cg_fused_batch", k, str(p_dtype), bool(defer_x),
                    str(dev))
            fused = self._op_cache.get(fkey)
            if fused is None:
                fused = self._op_cache[fkey] = (
                    *fop.fused_cg_kernels(k, defer_x=bool(defer_x)),
                    *self._fused_cg_operands(ex, ctx["free_np"], p_dtype,
                                             dev))
            kA, kB, inv, w_free = fused
            n = disc.n_loc
            # the masked operator on the k-stack (buffers shared with ctx)
            A_wb = ctx["A"].stacked(k)

            def A_flat(xf):
                # the masked operator on flat (k n, E) stacks, for the
                # true-residual verification of cg_fused_batched
                return A_wb(xf.view(k, n, -1)).view(k * n, -1)

            res = cg_fused_batched(kA, kB, R, inv=inv, w_free=w_free,
                                   tol=tol, max_iter=max_iter,
                                   p_dtype=p_dtype, defer_x=defer_x,
                                   A=A_flat)
        else:
            M = self._precond(ctx, precond, dev)
            w = ex._weights_as(self.dtype, dev, transposed=transposed)
            A = ctx["A"].stacked(k) if transposed else ctx["A"]
            res = cg_batched(A, R, M=M, tol=tol, max_iter=max_iter,
                             dot_weight=w, whole_batch=transposed)
        # one device-to-host copy for the whole batch
        X = (res.x.to(u_dL.dtype) + u_dL).cpu().numpy()
        back = self._back(ctx)
        u = np.stack([back(X[j]) for j in range(k)])
        return PoissonSolution(u, res)

    def _fused_cg_operands(self, ex, free_np, p_dtype, device):
        """(inv, w_free) of the fused CG kernels on ``device``."""
        diagT = np.asarray(self.operator_diagonal())[ex.gather_hier].T
        return fused_cg_operands(diagT, free_np, ex.weights.T, p_dtype,
                                 device)

    # -- 3D: hexahedral meshes, lexicographic (E, n) L-vectors ----------------

    def _scales_3d(self):
        """``(structure, a)`` of :func:`..ops.sumfac.structure_3d` on the
        model's factors, computed once (a pass over the (E, 6, n) slabs)."""
        sc = getattr(self, "_scales3d", None)
        if sc is None:
            sc = self._scales3d = sumfac.structure_3d(
                self._G_host, self.disc.basis.weight_grid())
        return sc

    def _local_setup_3d(self, precond, device) -> dict:
        """The 3D L-vector solve's operators and preconditioner on
        ``device`` (shared by :meth:`_solve_local_3d` and
        :meth:`_solve_local_batch_3d`).

        The exchange is :func:`..ops.exchange.make_exchange`'s (the
        plane-roll :class:`..ops.exchange.BoxRollExchange3D` on a
        lexicographic box, else :class:`..ops.exchange.
        PairScatterExchange`).  The operator is a :class:`..ops.sumfac.
        Laplacian3D` of the structure the reference's rule gives
        (``"separable"``, ``"affine"`` or ``"general"``), built once and
        cached in ``_op_cache`` under ``("A3d", device)`` as the pair
        ``(A_raw, A)`` (unmasked; output-masked).  ``precond``:
        ``"jacobi"`` (``("M", "jac3d", device)``), ``"fdm"``
        (:func:`..solver.fdm.make_fdm_preconditioner_3d`, ``("M", "fdm3d",
        device)``) or ``"pmg"`` / ``{"pmg": {...}}``
        (:func:`..solver.pmg.make_pmg_preconditioner_3d` with the dict's
        options, ``("M", "pmg3d", sorted options, device)``).
        """
        from ..ops.exchange import make_exchange

        disc, dv = self.disc, str(device)
        if self._exchange is None:
            self._exchange = make_exchange(disc)
        ex = self._exchange
        dt = torch_dtype(self.dtype)

        def to_local(u_global):
            lv = ex.local_from_global(np.asarray(u_global, self.dtype))
            return torch.as_tensor(np.ascontiguousarray(lv),
                                   device=device).to(dt)

        free = torch.as_tensor((~self._dirichlet_mask)[ex.gather_lex],
                               device=device)
        cached = self._op_cache.get(("A3d", dv))
        if cached is None:
            A_raw = sumfac.make_laplacian_3d(
                ex, self._G_host, disc.basis, dtype=self.dtype, device=device,
                scales=self._scales_3d())
            # no input mask: CG iterates satisfy the Dirichlet mask by
            # induction, as in the reference
            cached = self._op_cache[("A3d", dv)] = (A_raw, A_raw.masked(free))
        A_raw, A = cached

        if precond == "fdm":
            from ..solver.fdm import make_fdm_preconditioner_3d

            key = ("M", "fdm3d", dv)
            M = self._op_cache.get(key)
            if M is None:
                M = self._op_cache[key] = make_fdm_preconditioner_3d(
                    ex, self._G_host, disc.basis, free, dtype=self.dtype,
                    device=device)
        elif _is_pmg(precond):
            from ..solver.pmg import make_pmg_preconditioner_3d

            pmg_kw = _pmg_kwargs(precond)
            key = ("M", "pmg3d", tuple(sorted(pmg_kw.items())), dv)
            M = self._op_cache.get(key)
            if M is None:
                M = self._op_cache[key] = make_pmg_preconditioner_3d(
                    disc, ex, A, ~self._dirichlet_mask,
                    np.asarray(self.operator_diagonal()), dtype=self.dtype,
                    device=device, **pmg_kw)
        elif precond == "jacobi":
            key = ("M", "jac3d", dv)
            M = self._op_cache.get(key)
            if M is None:
                M = self._op_cache[key] = jacobi_preconditioner(
                    to_local(self.operator_diagonal()), free)
        else:
            raise ValueError(f"3D precond must be 'jacobi', 'fdm' or 'pmg', "
                             f"got {precond!r}")
        return dict(ex=ex, to_local=to_local, free=free, A_raw=A_raw, A=A,
                    M=M)

    def _solve_local_3d(self, tol, max_iter, host_loop, precond, certify,
                        device) -> PoissonSolution:
        """The 3D branch of :meth:`solve_local`: PCG on (E, n) L-vectors
        with the local sum-factorized apply and the exchange's DSS, no
        global gather or scatter inside the iteration.

        The residual seed ``free ? b - A_raw(u_d) : 0`` and the lift are
        cached per device in ``_bc_cache`` (emptied by ``set_dirichlet`` and
        ``set_neumann``; the reference keys its cache on the boundary
        data).  ``max_iter`` defaults to ``max(200, 20 sqrt(ndof))``;
        :func:`..solver.cg.cg` with the exchange's dot weights, or
        :func:`..solver.cg.cg_host` with its ``dot`` under ``host_loop``.
        ``certify`` on a float32 model runs :meth:`_certified_solve_3d`.
        """
        ctx = self._local_setup_3d(precond, device)
        ex, free = ctx["ex"], ctx["free"]
        A, M = ctx["A"], ctx["M"]
        if certify and np.dtype(self.dtype) == np.float32:
            if host_loop:
                raise ValueError("certify=True is a device path "
                                 "(host_loop=False)")
            return self._certified_solve_3d(ctx, tol, device)

        seeds = self._bc_cache.setdefault(str(device), {})
        seed = seeds.get("3d")
        if seed is None:
            to_local = ctx["to_local"]
            u_dL = to_local(np.where(self._dirichlet_mask,
                                     self._dirichlet_vals, 0.0))
            bL = to_local(np.asarray(self._b) + self._neumann)
            seed = seeds["3d"] = (u_dL, torch.where(
                free, bL - ctx["A_raw"](u_dL), 0.0))
        u_dL, r = seed

        if max_iter is None:
            max_iter = max(200, 20 * int(np.sqrt(self.disc.ndof)))
        if host_loop:
            res = cg_host(A, r, M=M, tol=tol, max_iter=max_iter, dot=ex.dot)
        else:
            res = cg(A, r, M=M, tol=tol, max_iter=max_iter,
                     dot_weight=ex._weights_as(self.dtype, device))
        uL = u_dL + res.x
        return PoissonSolution(ex.global_from_local(uL.cpu().numpy()), res)

    def _certified_solve_3d(self, ctx, tol, device) -> PoissonSolution:
        """The float64-certified mixed-precision 3D solve (``certify=True``,
        float32 models).

        :func:`..solver.cg.cg_refined_static` on the float32 operator and
        preconditioner of ``ctx``, anchored on ``A_hi``: the same system in
        float64, built once and cached in ``_op_cache`` under ``("A_hi3d",
        device)`` — separable from the float32 factors' scales (in float64;
        a raw float32 -> float64 upcast of the slabs fails the affine test)
        on an axis-aligned affine mesh, else general from the upcast slabs,
        as the reference's.  The float64 seed and the
        lift are cached per device in ``_bc_cache``; the dot weights are
        the exchange's float32 weights.  ``sol.cg`` is the certified result
        (its ``x`` float64); ``u`` is ``u_d + x`` at the model dtype.
        """
        from ..utils.stages import stage

        disc, ex, free = self.disc, ctx["ex"], ctx["free"]
        key = ("A_hi3d", str(device))
        A_hi = self._op_cache.get(key)
        if A_hi is None:
            with stage("certify/A_hi"):
                found, a = self._scales_3d()
                separable = found == "separable"
                A_hi = self._op_cache[key] = sumfac.make_laplacian_3d(
                    ex, None if separable else np.asarray(
                        self._G_host, np.float64), disc.basis,
                    dtype=np.float64, device=device,
                    structure="separable" if separable else "general",
                    free=free, scales=(found, a))
        seeds = self._bc_cache.setdefault(str(device), {})
        seed = seeds.get("3d_hi")
        if seed is None:
            with stage("certify/seed"):
                def to64(v):
                    return torch.as_tensor(np.ascontiguousarray(
                        ex.local_from_global(np.asarray(v, np.float64))),
                        device=device)

                b = np.asarray(self._b, np.float64) + self._neumann
                u_dL64 = to64(np.where(self._dirichlet_mask,
                                       self._dirichlet_vals, 0.0))
                r_hi = torch.where(free, to64(b) - A_hi(u_dL64), 0.0)
                seed = seeds["3d_hi"] = (
                    u_dL64.to(torch_dtype(self.dtype)), r_hi)
        u_dL, r_hi = seed
        res = cg_refined_static(
            ctx["A"], r_hi, A_hi=A_hi, M=ctx["M"], tol=tol,
            dot_weight=ex._weights_as(torch.float32, device))
        uL = u_dL + res.x.to(u_dL.dtype)
        return PoissonSolution(ex.global_from_local(uL.cpu().numpy()), res)

    def _solve_local_batch_3d(self, forcings, tol, max_iter, precond,
                              device) -> PoissonSolution:
        """The 3D branch of :meth:`solve_local_batch`: whole-batch
        :func:`..solver.cg.cg_batched` with the operator and the
        preconditioner of :meth:`_local_setup_3d` on the (k, E, n) stack
        (each takes a stack as it is: the reference's ``jax.vmap``)."""
        disc = self.disc
        ctx = self._local_setup_3d(precond, device)
        ex, to_local, free = ctx["ex"], ctx["to_local"], ctx["free"]

        coords = [disc.x_coeffs[:, d] for d in range(3)]
        nodal = (not callable(forcings) and hasattr(forcings, "__len__")
                 and np.asarray(forcings[0]).ndim == 1)
        if nodal:
            forcings = np.asarray(forcings, dtype=np.float64)
        rows = []
        for f in forcings:
            f_gll = (disc.gather(np.asarray(f)) if nodal
                     else np.broadcast_to(
                         np.asarray(_as_callable(f)(*coords)),
                         disc.detJxW.shape))
            b = disc.scatter_add(
                np.asarray(f_gll * disc.detJxW)).astype(self.dtype)
            rows.append(b + self._neumann)
        u_dL = to_local(np.where(self._dirichlet_mask, self._dirichlet_vals,
                                 0.0))
        Au_d = ctx["A_raw"](u_dL)       # the shared lift: one raw apply
        R = torch.stack([torch.where(free, to_local(b) - Au_d, 0.0)
                         for b in rows])
        if max_iter is None:
            max_iter = max(200, 20 * int(np.sqrt(disc.ndof)))
        res = cg_batched(ctx["A"], R, M=ctx["M"], tol=tol, max_iter=max_iter,
                         dot_weight=ex._weights_as(self.dtype, device),
                         whole_batch=True)
        X = (res.x + u_dL).cpu().numpy()
        u = np.stack([ex.global_from_local(X[j]) for j in range(len(X))])
        return PoissonSolution(u, res)

    # -- post-processing -------------------------------------------------------

    def l2_error(self, u: np.ndarray, exact: Callable) -> float:
        """Quadrature L2 error against an exact solution callable(x, y)."""
        disc = self.disc
        ue = disc.gather(u)
        ex = exact(*(disc.x_coeffs[:, d] for d in range(disc.mesh.ndim)))
        return float(np.sqrt(np.sum((ue - ex) ** 2 * disc.detJxW)))
