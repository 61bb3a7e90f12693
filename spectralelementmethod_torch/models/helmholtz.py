"""Variable-coefficient Helmholtz solver on curved isoparametric meshes
(PyTorch port).

Port of the JAX package's ``models/helmholtz.py``, BASELINE.json config 3:

    -div(c(x) grad u) + k(x) u = f

with Dirichlet and Neumann data on named boundaries.  The operator is the
matrix-free weak Laplacian with the diffusivity folded into its geometric
factors, plus the diagonal GLL-collocated mass weighted by the reaction,
``kM = k detJxW``.  CG is only guaranteed for k >= 0.

The model's setup is host numpy, as in the reference.  Its solves run on a
device, the CUDA card by default or the CPU with ``device="cpu"`` (where
every kernel runs its plain PyTorch version):

* :meth:`Helmholtz.solve` — Jacobi PCG on global vectors (the plain
  ``torch.einsum`` / ``index_add_`` operator of :mod:`..ops.sumfac`);
* :meth:`Helmholtz.solve_local` and :meth:`Helmholtz.solve_local_batch` —
  on element-local L-vectors, ``A u = DSS(lap_local(u)) + DSS(kM u)`` with
  the two exchanges of the reference, in either layout: transposed (n, E)
  (``vector_layout="ne"``, the Laplacian by the hand-written apply+DSS
  kernels) or row-major (E, n) (``"en"``, the local product by
  ``torch.matmul`` or, ``backend="pallas"``, by the hand-written
  element-local kernel :func:`..ops.kernels.laplacian_local`).

``solve_local`` takes the Jacobi or, on the ``"ne"`` layout, the two-level
p-multigrid preconditioner (:mod:`..solver.pmg`, with the reaction in its
coarse and fine operators).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import resolve_device, torch_dtype
from ..core.discretization import Discretization
from ..ops import sumfac
from ..ops.sumfac import LocalHelmholtzOperator
from ..solver.cg import (CGResult, cg, cg_batched, cg_host,
                         jacobi_preconditioner)
from .poisson import (BoundaryConditionMixin, _as_callable, _is_pmg,
                      _pmg_kwargs)


class HelmholtzSolution(NamedTuple):
    u: np.ndarray          # (n_nodes,) nodal solution, or (k, n_nodes)
    cg: CGResult


class Helmholtz(BoundaryConditionMixin):
    """-div(c grad u) + k u = f on a (possibly curved) 2D quad mesh.

    Parameters
    ----------
    disc : Discretization (dofs_per_node=1)
    forcing : callable(x, y) or scalar — right-hand side f.
    coefficient : callable(x, y) or scalar — diffusivity c (default 1).
    reaction : callable(x, y) or scalar — reaction/shift k (default 0:
        Poisson).
    dtype : dtype of the device solves: float64 (reference-matching
        accuracy) or float32 (what the CUDA kernels take).
    """

    def __init__(self, disc: Discretization, forcing=0.0, coefficient=1.0,
                 reaction=0.0, dtype=np.float64):
        if disc.dpn != 1:
            raise ValueError("Helmholtz requires dofs_per_node=1")
        self.disc = disc
        self.dtype = dtype

        self.x_nodes = disc.global_gll_coords()
        rho, zz = disc.x_coeffs[:, 0], disc.x_coeffs[:, 1]
        self._coeff_fn = _as_callable(coefficient)
        # None when the reaction is identically zero (the Poisson limit)
        self._reaction_fn = (
            None if (not callable(reaction) and float(reaction) == 0.0)
            else _as_callable(reaction))
        cvals = self._coeff_fn(rho, zz)
        kvals = _as_callable(reaction)(rho, zz)
        #: (E, *shape) diffusivity at the GLL nodes, or None when c == 1:
        #: boundary_flux weighs the gradient by it
        self._coeff_vals = (
            None if (not callable(coefficient) and float(coefficient) == 1.0)
            else np.broadcast_to(cvals, disc.detJxW.shape))
        G = disc.laplacian_factors(np.broadcast_to(cvals, disc.detJxW.shape))
        #: mass-weighted reaction k * detJxW at the GLL nodes
        self._kM_host = np.asarray(
            np.broadcast_to(kvals, disc.detJxW.shape) * disc.detJxW,
            dtype=dtype)
        self._G_host = np.asarray(G, dtype=dtype)
        self._D0_host = np.asarray(disc.basis.subbases[0].D1, dtype=dtype)
        self._D1_host = np.asarray(disc.basis.subbases[1].D1, dtype=dtype)

        f_gll = _as_callable(forcing)(rho, zz)
        self._b = disc.scatter_add(
            np.broadcast_to(f_gll, disc.detJxW.shape)
            * disc.detJxW).astype(dtype)

        self._dirichlet_mask = np.zeros(disc.n_nodes, dtype=bool)
        self._dirichlet_vals = np.zeros(disc.n_nodes)
        self._neumann = np.zeros(disc.n_nodes)
        self._exchange = None
        self._op_cache = {}
        self._dev_cache = {}

    # -- global-vector operator -----------------------------------------------

    def _on(self, device) -> dict:
        """The operator's arrays on ``device`` (cached)."""
        st = self._dev_cache.get(str(device))
        if st is None:
            dt = torch_dtype(self.dtype)

            def t(a):
                return torch.as_tensor(np.array(a), device=device).to(dt)

            st = self._dev_cache[str(device)] = dict(
                G=t(self._G_host), D0=t(self._D0_host), D1=t(self._D1_host),
                kM=t(self._kM_host),
                gix=torch.as_tensor(self.disc.gather_nodes, device=device))
        return st

    def apply_operator(self, u, device=None) -> torch.Tensor:
        """(A + k M) u on a global (n_nodes,) vector, matrix-free."""
        dev = resolve_device(device)
        st, disc = self._on(dev), self.disc
        ue = sumfac.gather(self._vec(u, dev), st["gix"], disc.shape)
        ve = sumfac.laplacian_apply_local(ue, st["G"], st["D0"], st["D1"])
        ve = ve + sumfac.mass_apply_local(ue, st["kM"])
        return sumfac.scatter_add(ve, st["gix"], disc.n_nodes)

    def operator_diagonal(self, device=None) -> torch.Tensor:
        """The assembled operator diagonal, (n_nodes,) on ``device``."""
        dev = resolve_device(device)
        st = self._on(dev)
        de = sumfac.laplacian_diag_local(st["G"], st["D0"], st["D1"])
        return sumfac.scatter_add(de + st["kM"], st["gix"],
                                  self.disc.n_nodes)

    def solve(self, tol: float = 1e-12, max_iter: int | None = None,
              host_loop: bool = False, device=None) -> HelmholtzSolution:
        """Jacobi PCG on global vectors: :func:`..solver.cg.cg`, or
        :func:`..solver.cg.cg_host` with ``host_loop``."""
        dev = resolve_device(device)
        disc = self.disc
        free = torch.as_tensor(~self._dirichlet_mask, device=dev)
        u_d = self._vec(np.where(self._dirichlet_mask, self._dirichlet_vals,
                                 0.0), dev)

        def A(u):
            u = sumfac.masked(u, free)
            return sumfac.masked(self.apply_operator(u, dev), free)

        b = self._vec(self._b + self._neumann, dev)
        r = sumfac.masked(b - self.apply_operator(u_d, dev), free)
        M = jacobi_preconditioner(self.operator_diagonal(dev), free)
        if max_iter is None:
            max_iter = max(200, 30 * int(np.sqrt(disc.ndof)))
        solver = cg_host if host_loop else cg
        res = solver(A, r, M=M, tol=tol, max_iter=max_iter)
        return HelmholtzSolution((u_d + res.x).cpu().numpy(), res)

    # -- L-vector solves -------------------------------------------------------

    def solve_local(self, tol: float = 1e-12, max_iter: int | None = None,
                    host_loop: bool = False, structure: str = "auto",
                    vector_layout: str = "auto", backend: str = "auto",
                    precond: str = "jacobi",
                    device=None) -> HelmholtzSolution:
        """Solve on element-local L-vectors (BASELINE config 3's device
        path): ``A u = DSS(lap_local(u)) + DSS(kM u)``, the same operator as
        :meth:`solve`'s, with Jacobi PCG weighted by the inverse
        multiplicities (:func:`..solver.cg.cg`, or with ``host_loop``
        :func:`..solver.cg.cg_host`).

        ``vector_layout``: ``"ne"`` — transposed (n, E) L-vectors, the
        Laplacian by the apply+DSS kernels (:class:`..ops.sumfac.
        AffineLaplacianT` or :class:`..ops.sumfac.GeneralLaplacianT`);
        ``"en"`` — row-major (E, n), :class:`..ops.sumfac.LaplacianEN`;
        ``"auto"`` — ``"ne"`` on a tail-free roll-class exchange (what the
        (n, E) kernels take; the reference asks a roll-class exchange
        only), else ``"en"``.  ``backend``: forwarded to
        :func:`..ops.sumfac.make_local_laplacian_operator` —
        on ``"en"``, ``"xla"`` (``torch.matmul``), ``"pallas"`` (the
        element-local kernel, float32 models only) or ``"auto"`` (xla).
        ``structure``: ``"auto"``, ``"general"`` or ``"affine"``, as there.
        ``precond``: ``"jacobi"``, or ``"pmg"`` / ``{"pmg": {...}}`` — the
        two-level p-multigrid V-cycle with ``coeff_fn`` = c and
        ``reaction_fn`` = k (:func:`..solver.pmg.make_pmg_preconditioner`),
        on the ``"ne"`` layout only (another raises ``ValueError``, as in
        the reference).
        ``device``: ``None`` is the CUDA card (raises without one),
        ``"cpu"`` runs the kernels' plain versions.
        """
        dev = resolve_device(device)
        ctx = self._local_ops(structure, vector_layout, backend, precond, dev)
        ex, transposed = ctx["ex"], ctx["transposed"]
        to_local, free, A, M = ctx["to_local"], ctx["free"], ctx["A"], ctx["M"]

        b = self._b + self._neumann
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        bL, u_dL = to_local(b), to_local(u_d)
        r = torch.where(free, bL - A._raw(u_dL), 0.0)

        if max_iter is None:
            max_iter = max(200, 30 * int(np.sqrt(self.disc.ndof)))
        if host_loop:
            dot = ex.dot_T if transposed else ex.dot
            res = cg_host(A, r, M=M, tol=tol, max_iter=max_iter, dot=dot)
        else:
            w = ex._weights_as(self.dtype, dev, transposed=transposed)
            res = cg(A, r, M=M, tol=tol, max_iter=max_iter, dot_weight=w)
        uL = (u_dL + res.x).cpu().numpy()
        back = ex.global_from_local_T if transposed else ex.global_from_local
        return HelmholtzSolution(back(uL), res)

    def _local_ops(self, structure, vector_layout, backend, precond,
                   device) -> dict:
        """The L-vector operator, preconditioner, free mask and transfer of
        :meth:`solve_local` and :meth:`solve_local_batch` on ``device``,
        cached in ``_op_cache`` (cleared by set_dirichlet)."""
        from ..ops.exchange import RollExchange, make_exchange

        pmg = _is_pmg(precond)
        if not pmg and precond != "jacobi":
            raise ValueError(f"precond must be 'jacobi' or 'pmg', got "
                             f"{precond!r}")
        disc = self.disc
        if self._exchange is None:
            self._exchange = make_exchange(disc)
        ex = self._exchange
        if vector_layout == "auto":
            tail_free = isinstance(ex, RollExchange) and not (
                ex.n_edge_tail or ex.n_vert_tail)
            vector_layout = "ne" if tail_free else "en"
        if vector_layout not in sumfac.LAYOUTS:
            raise ValueError(f"unknown vector_layout {vector_layout!r}")
        transposed = vector_layout == "ne"
        if pmg and not transposed:
            raise ValueError("precond='pmg' requires the 'ne' layout")
        dt = torch_dtype(self.dtype)
        gih = torch.as_tensor(ex.gather_hier, device=device)

        def to_local(u_global):
            lv = self._vec(u_global, device)[gih]
            return (lv.T if transposed else lv).contiguous()

        def layout(a):
            a = torch.as_tensor(np.ascontiguousarray(a), device=device)
            return a.T.contiguous() if transposed else a

        free = layout((~self._dirichlet_mask)[ex.gather_hier])
        key = ("A", structure, vector_layout, backend, str(device))
        A = self._op_cache.get(key)
        if A is None:
            Gf = self._G_host.reshape(disc.E, 3, -1)
            Dhat = sumfac.make_stacked_derivative(self._D0_host,
                                                  self._D1_host)
            kM = layout(self._kM_host.reshape(disc.E, -1)[:, ex.hier]).to(dt)
            lap = sumfac.make_local_laplacian_operator(
                ex, Gf, Dhat, None, device=device, structure=structure,
                vector_layout=vector_layout, backend=backend)
            A = self._op_cache[key] = LocalHelmholtzOperator(
                lap, ex.dss_T if transposed else ex.dss, kM, free)
        if pmg:
            from ..solver.pmg import make_pmg_preconditioner

            pmg_kw = _pmg_kwargs(precond)
            Mk = ("M", "pmg", vector_layout, tuple(sorted(pmg_kw.items())),
                  str(device))
            M = self._op_cache.get(Mk)
            if M is None:
                pmg_kw.setdefault("coeff_fn", self._coeff_fn)
                pmg_kw.setdefault("reaction_fn", self._reaction_fn)
                M = self._op_cache[Mk] = make_pmg_preconditioner(
                    disc, ex, self._G_host.reshape(disc.E, 3, -1), A,
                    ~self._dirichlet_mask,
                    self.operator_diagonal("cpu").numpy(),
                    dtype=self.dtype, device=device, **pmg_kw)
        else:
            Mk = ("M", vector_layout, str(device))
            M = self._op_cache.get(Mk)
            if M is None:
                M = self._op_cache[Mk] = jacobi_preconditioner(
                    to_local(self.operator_diagonal(device)), free)
        return {"ex": ex, "transposed": transposed,
                "vector_layout": vector_layout, "to_local": to_local,
                "free": free, "A": A, "M": M}

    def solve_local_batch(self, forcings, tol: float = 1e-12,
                          max_iter: int | None = None,
                          structure: str = "auto",
                          vector_layout: str = "auto",
                          backend: str = "auto",
                          device=None) -> HelmholtzSolution:
        """Solve ``(-div(c grad) + k) u_j = f_j`` for a batch of forcings
        through one operator and one CG ladder
        (:func:`..solver.cg.cg_batched`, whole-batch mode): the operator
        acts on the whole (k, ...) stack at once, one launch of the stacked
        kernel per apply.  ``forcings``: a sequence of callables or scalars,
        or a (k, n_nodes) nodal-value array.  ``backend`` as in
        :meth:`solve_local` (``"auto"`` and ``"fused"`` take ``"xla"``, as
        in the reference).  Returns batched ``u`` (k, n_nodes) and ``cg``
        fields.
        """
        dev = resolve_device(device)
        backend = "xla" if backend in ("auto", "fused") else backend
        disc = self.disc
        ctx = self._local_ops(structure, vector_layout, backend, "jacobi",
                              dev)
        ex, transposed = ctx["ex"], ctx["transposed"]
        to_local, free, A, M = ctx["to_local"], ctx["free"], ctx["A"], ctx["M"]

        rho, zz = disc.x_coeffs[:, 0], disc.x_coeffs[:, 1]
        nodal = (not callable(forcings) and hasattr(forcings, "__len__")
                 and np.asarray(forcings[0]).ndim == 1)
        if nodal:
            forcings = np.asarray(forcings, dtype=np.float64)
        rows = []
        for f in forcings:
            f_gll = (disc.gather(np.asarray(f)) if nodal
                     else np.broadcast_to(np.asarray(_as_callable(f)(rho, zz)),
                                          disc.detJxW.shape))
            b = disc.scatter_add(
                np.asarray(f_gll * disc.detJxW)).astype(self.dtype)
            rows.append(b + self._neumann)
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        u_dL = to_local(u_d)
        Au_d = A._raw(u_dL)
        R = torch.stack([torch.where(free, to_local(b) - Au_d, 0.0)
                         for b in rows])
        k = int(R.shape[0])

        if max_iter is None:
            max_iter = max(200, 30 * int(np.sqrt(disc.ndof)))
        w = ex._weights_as(self.dtype, dev, transposed=transposed)
        res = cg_batched(A.stacked(k), R, M=M, tol=tol, max_iter=max_iter,
                         dot_weight=w, whole_batch=True)
        X = (res.x + u_dL).cpu().numpy()
        back = ex.global_from_local_T if transposed else ex.global_from_local
        return HelmholtzSolution(np.stack([back(X[j]) for j in range(k)]),
                                 res)

    def l2_error(self, u: np.ndarray, exact: Callable) -> float:
        """Quadrature L2 error against an exact solution callable(x, y)."""
        disc = self.disc
        ue = disc.gather(u)
        ex = exact(disc.x_coeffs[:, 0], disc.x_coeffs[:, 1])
        return float(np.sqrt(np.sum((ue - ex) ** 2 * disc.detJxW)))
