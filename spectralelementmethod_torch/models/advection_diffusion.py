"""Steady advection-diffusion solver (matrix-free, GMRES) — PyTorch port
of the JAX package's ``models/advection_diffusion.py``.

    -div(eps grad u) + c . grad u = f        on Omega
    u = g_D on Dirichlet boundaries; natural BCs elsewhere.

The operator is the sum-factorized weak Laplacian plus a collocated
advection term ``(detJxW c . J^{-T} grad u)`` on row-major (E, n)
L-vectors, DSS-summed like every other operator.  The setup is host numpy,
as in the reference; the solves run on a device (the CUDA card unless
``device`` says otherwise), with Jacobi-preconditioned restarted GMRES
(:mod:`..solver.gmres`) in the model's dtype.

The Laplacian is the (E, n) operator of
:func:`..ops.sumfac.make_local_laplacian_operator` with
``vector_layout="en"`` passed explicitly (the port's default layout is the
transposed ``"ne"``; the reference's is ``"en"``), ``backend="auto"``
(``torch.matmul``), so the Laplacian and the advection term share one
layout.  No kernel runs: the model is float64 by default, and the
reference's operator is its ``"xla"`` one too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device, torch_dtype
from ..core.discretization import Discretization
from ..ops import sumfac
from ..solver.gmres import GMRESResult, gmres
from .poisson import BoundaryConditionMixin, _as_callable


class AdvectionDiffusionSolution(NamedTuple):
    u: np.ndarray
    gmres: GMRESResult


class AdvectionDiffusion(BoundaryConditionMixin):
    """Steady scalar transport on a discretized mesh.

    Parameters
    ----------
    disc : Discretization (dofs_per_node=1).
    velocity : callable(x, y) -> (cx, cy) or tuple of scalars.
    diffusivity : callable(x, y) or scalar (eps > 0).
    forcing : callable(x, y) or scalar.
    """

    def __init__(self, disc: Discretization, velocity=(1.0, 0.0),
                 diffusivity=1.0, forcing=0.0, dtype=np.float64):
        if disc.dpn != 1:
            raise ValueError("AdvectionDiffusion requires dofs_per_node=1")
        self.disc = disc
        self.dtype = dtype
        self.x_nodes = disc.global_gll_coords()

        xe = disc.x_coeffs[:, 0]
        ye = disc.x_coeffs[:, 1]
        if callable(velocity):
            cx, cy = velocity(xe, ye)
            cx = np.broadcast_to(np.asarray(cx, float), xe.shape)
            cy = np.broadcast_to(np.asarray(cy, float), xe.shape)
        else:
            cx = np.full_like(xe, float(velocity[0]))
            cy = np.full_like(xe, float(velocity[1]))

        eps = _as_callable(diffusivity)(xe, ye)
        G = disc.laplacian_factors(np.broadcast_to(np.asarray(eps, float),
                                                   xe.shape))
        self._G_host = np.asarray(G, dtype=dtype)

        # advection weights: detJxW * (c . invJ^T e_a) per parametric axis
        E = disc.E
        invJ = np.asarray(disc.invJ).reshape(E, 2, 2, -1)
        w2d = np.asarray(disc.detJxW).reshape(E, -1)
        cxf = cx.reshape(E, -1)
        cyf = cy.reshape(E, -1)
        self._gx_host = np.asarray(
            (cxf * invJ[:, 0, 0] + cyf * invJ[:, 0, 1]) * w2d, dtype=dtype)
        self._gy_host = np.asarray(
            (cxf * invJ[:, 1, 0] + cyf * invJ[:, 1, 1]) * w2d, dtype=dtype)

        ffun = _as_callable(forcing)
        f_gll = ffun(xe, ye)
        self._b = disc.scatter_add(
            np.broadcast_to(np.asarray(f_gll, float), xe.shape)
            * disc.detJxW).astype(dtype)
        self._dirichlet_mask = np.zeros(disc.n_nodes, dtype=bool)
        self._dirichlet_vals = np.zeros(disc.n_nodes)
        self._neumann = np.zeros(disc.n_nodes)
        self._exchange = None
        self._ops = {}          # per device: (apply_raw, diagL); BC-free
        self._op_cache = {}     # per device: (free, A, M); set_dirichlet
        #                         empties it

    # -- operator ----------------------------------------------------------

    def _ex(self):
        if self._exchange is None:
            from ..ops.exchange import make_exchange

            self._exchange = make_exchange(self.disc)
        return self._exchange

    def _build(self, device):
        """(ex, apply_raw, diagL) on ``device``: the unmasked operator on
        (E, n) L-vectors or (k, E, n) stacks, and the L-vector diagonal of
        the (BC-independent) symmetric part."""
        key = str(device)
        ops = self._ops.get(key)
        ex = self._ex()
        if ops is not None:
            return (ex,) + ops
        disc = self.disc
        dt = torch_dtype(self.dtype)
        Gf = self._G_host.reshape(disc.E, 3, -1)
        Dhat = sumfac.make_stacked_derivative(
            np.asarray(disc.basis.subbases[0].D1),
            np.asarray(disc.basis.subbases[1].D1))
        lap = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, None, device=device, vector_layout="en")
        Dhat_hT = torch.as_tensor(np.ascontiguousarray(Dhat[:, ex.hier].T),
                                  device=device).to(dt)
        hier = torch.as_tensor(np.asarray(ex.hier), device=device)
        n = disc.n_loc
        gx = torch.as_tensor(self._gx_host, device=device)
        gy = torch.as_tensor(self._gy_host, device=device)

        def apply_raw(uL):
            grads = torch.matmul(uL, Dhat_hT)            # (..., E, 2n)
            adv = gx * grads[..., :n] + gy * grads[..., n:]
            return lap(uL) + ex.dss(adv[..., hier])

        # Jacobi on the symmetric-part diagonal, as L-vectors
        de = sumfac.laplacian_diag_local(
            torch.as_tensor(self._G_host, device=device),
            torch.as_tensor(np.array(disc.basis.subbases[0].D1),
                            device=device).to(dt),
            torch.as_tensor(np.array(disc.basis.subbases[1].D1),
                            device=device).to(dt))
        diag = sumfac.scatter_add(
            de, torch.as_tensor(disc.gather_nodes, device=device),
            disc.n_nodes)
        diagL = diag[torch.as_tensor(ex.gather_hier, device=device)]
        self._ops[key] = (apply_raw, diagL)
        return ex, apply_raw, diagL

    def _solver_ops(self, device):
        """(ex, apply_raw, free, A, M) on ``device``: the masked operator
        and the Jacobi preconditioner of the GMRES paths, cached in
        ``_op_cache`` (emptied by ``set_dirichlet``)."""
        from ..solver.cg import jacobi_preconditioner

        ex, apply_raw, diagL = self._build(device)
        key = str(device)
        ops = self._op_cache.get(key)
        if ops is None:
            free = torch.as_tensor((~self._dirichlet_mask)[ex.gather_hier],
                                   device=device)

            def A(uL):
                uL = torch.where(free, uL, 0.0)
                return torch.where(free, apply_raw(uL), 0.0)

            M = jacobi_preconditioner(diagL, free)
            ops = self._op_cache[key] = (free, A, M)
        free, A, M = ops
        return ex, apply_raw, free, A, M

    def _local(self, ex, u, device) -> torch.Tensor:
        """A global host vector as an (E, n) L-vector on ``device``."""
        return torch.as_tensor(ex.local_from_global(u).astype(self.dtype),
                               device=device)

    def solve(self, tol: float = 1e-10, restart: int = 40,
              max_restarts: int = 100,
              device=None) -> AdvectionDiffusionSolution:
        """GMRES solve with symmetric Dirichlet elimination.  ``device``:
        the CUDA card unless given."""
        dev = resolve_device(device)
        ex, apply_raw, free, A, M = self._solver_ops(dev)

        b = np.asarray(self._b) + self._neumann
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        bL = self._local(ex, b, dev)
        u_dL = self._local(ex, u_d, dev)
        r = torch.where(free, bL - apply_raw(u_dL), 0.0)

        res = gmres(A, r, M=M, tol=tol, restart=restart,
                    max_restarts=max_restarts, dot=ex.dot)
        u = ex.global_from_local((u_dL + res.x).cpu().numpy())
        return AdvectionDiffusionSolution(u, res)

    def solve_batch(self, forcings, tol: float = 1e-10,
                    restart: int = 40, max_restarts: int = 100,
                    device=None) -> AdvectionDiffusionSolution:
        """Solve for a batch of forcings with ONE batched-GMRES ladder
        (the reference's ``gmres_batched``): shared operator and Jacobi
        preconditioner, per-RHS Arnoldi/convergence state.  The operator,
        the preconditioner and the weighted dot each take the whole
        (k, E, n) stack in one call (:func:`..solver.gmres._gmres_stacked`).
        ``forcings``: callables/scalars or a (k, n_nodes) nodal array.
        Returns batched ``u`` (k, n_nodes) / ``gmres`` fields.
        """
        from ..solver.gmres import _gmres_stacked

        disc = self.disc
        dev = resolve_device(device)
        ex, apply_raw, free, A, M = self._solver_ops(dev)

        coords = [disc.x_coeffs[:, d] for d in range(disc.mesh.ndim)]
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
        u_d = np.where(self._dirichlet_mask, self._dirichlet_vals, 0.0)
        u_dL = self._local(ex, u_d, dev)
        Au_d = apply_raw(u_dL)
        R = torch.stack([
            torch.where(free, self._local(ex, b, dev) - Au_d, 0.0)
            for b in rows])

        w = torch.as_tensor(ex.weights, device=dev).to(R.dtype)

        def dot(U, V):
            return torch.sum(U * V * w, dim=(-2, -1))

        res = _gmres_stacked(A, R, M=M, dot=dot, tol=tol, restart=restart,
                             max_restarts=max_restarts)
        X = (res.x + u_dL[None]).cpu().numpy()
        u = np.stack([ex.global_from_local(X[j])
                      for j in range(int(R.shape[0]))])
        return AdvectionDiffusionSolution(u, res)

    def l2_error(self, u: np.ndarray, exact) -> float:
        disc = self.disc
        ue = disc.gather(u)
        ex_v = exact(disc.x_coeffs[:, 0], disc.x_coeffs[:, 1])
        return float(np.sqrt(np.sum((ue - ex_v) ** 2 * disc.detJxW)))
