"""Axisymmetric steady Navier–Stokes "squirmer" solver — PyTorch port of
the JAX package's ``models/squirmer.py``.

Steady axisymmetric flow past a sphere in stream-function/vorticity form,
solved by Newton iteration with a static-condensation direct solve,
hydrodynamic force by surface-stress quadrature, swimming speed by secant
iteration on force = 0, and a Reynolds-number continuation sweep with
HDF5 checkpoint/resume (the original library's primary workload,
``examples/squirmer-axisymmetric.py``).

Unknowns per mesh node (parity ``squirmer:85-98``): component 0 = stream
function psi, component 1 = vorticity omega (interleaved global DOFs).
Cylindrical coordinates: x0 = rho, x1 = z.

Discrete equations (collocation row at each GLL node):

* vorticity transport (rows 0::2)::

      Re*JxW*(psi_rho*w_z - psi_z*w_rho) + Re*(JxW/rho)*psi_z*w
      + [stiff_rho(w) + (JxW/rho)*w]

* vorticity definition (rows 1::2)::

      [stiff_rho(psi) + 2*JxW*psi_rho] - rho^2*JxW*w

  where ``stiff_rho(u)`` is the rho-weighted weak Laplacian.

On the device (the CUDA card unless ``device`` says otherwise), in the
model's dtype (float64 by default):

* the element residual is a pure function of one element; its exact
  Jacobian is ``torch.func.jacfwd`` under ``torch.func.vmap`` over the
  elements (the reference's ``jax.jacfwd``);
* ``linear_solver="direct"`` solves the Newton correction by batched static
  condensation and one dense LU of the condensed exterior system
  (:func:`..solver.condensation.schur_solve`, ``torch.linalg`` in float64);
  ``"gmres-ir"`` by float64 GMRES preconditioned by the float32 Schur
  factors (:func:`..solver.condensation.schur_factor`).  ``"auto"`` is
  ``"direct"``: the reference takes GMRES-IR only on a TPU, which has no
  float64 batched LU, and the card has one;
* the iterate stays on the device across Newton steps; the host reads one
  scalar per step (the update's norm; with ``newton_loop="host"`` and
  GMRES-IR also whether the correction converged, for the log) and,
  inside GMRES-IR, one transfer per restart cycle
  (:mod:`..solver.gmres`).  The field downloads lazily through
  :attr:`soln`.

The 1/rho axis singularity is masked explicitly (``inv_rho`` = 0 on the
axis); the axis rows are Dirichlet-eliminated.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import gll_basis_2d
from ..config import resolve_device, torch_dtype
from ..core.discretization import Discretization
from ..solver import condensation as sc
from ..ops.exchange import accumulate
from ..parallel import comm
from ..solver.gmres import gmres
from ..solver.rootfind import SolverFailure, secant
from ..utils import checkpoint as ckpt
from ..utils.logging import get_logger

_log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Physics helpers (parity: squirmer:17-42)
# ---------------------------------------------------------------------------


def squirmer_vslip_profile(beta):
    """Tangential slip profile v_theta(r=1) = 3/2 sin(th) (1 + beta cos(th))."""

    def vslip(sin_th, cos_th):
        return 1.5 * sin_th * (1.0 + beta * cos_th)

    return vslip


def zero_slip_vel(sin_th, cos_th):
    return np.zeros_like(sin_th)


def sfn_potential(rho, z):
    """Stream function of potential flow past a unit sphere (unit speed)."""
    r = np.sqrt(rho**2 + z**2)
    sin_th = np.where(r > 0, rho / np.where(r > 0, r, 1.0), 0.0)
    return -(r**2 - 1.0 / np.where(r > 0, r, 1.0)) / 2.0 * sin_th**2


def sfn_free_stream(rho, z):
    """Free-stream stream function: (rho^2)/2 per unit speed."""
    return 0.5 * rho**2


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


class SphereWithSlipVel:
    """Axisymmetric flow past a sphere with a prescribed surface slip.

    Base class of :class:`FixedSphere` and :class:`Squirmer`
    (parity: ``squirmer:64-518``).

    Parameters
    ----------
    mesh : Mesh
        The "donut" sphere-in-shell mesh (boundaries "sphere", "symaxis",
        "shell"), e.g. :func:`...mesh.generators.annulus_mesh`.
    order : int
        GLL basis order (the original library uses 8).
    dtype : the dtype of the device state and solves (float64).
    linear_solver : ``"auto"`` (= ``"direct"``), ``"direct"`` or
        ``"gmres-ir"``.
    device : the device of the Newton solves: the CUDA card unless given
        (``"cpu"`` runs them on the CPU).
    """

    DPN = 2  # dofs per node: (psi, omega)

    def __init__(self, mesh, order: int = 8, dtype=np.float64,
                 linear_solver: str = "auto", device=None):
        self.dtype = dtype
        if linear_solver == "auto":
            linear_solver = "direct"
        if linear_solver not in ("direct", "gmres-ir"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        self.linear_solver = linear_solver
        self.device = dev = resolve_device(device)
        self._tdtype = tdt = torch_dtype(dtype)
        basis = gll_basis_2d(order)
        self.disc = disc = Discretization(mesh, basis, dofs_per_node=2)
        self.phys_params: dict = {}

        self.p1 = order + 1

        def t(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=dev).to(tdt)

        # ---- geometry fields (device) ----
        rho = disc.x_coeffs[:, 0]
        z = disc.x_coeffs[:, 1]
        scale = float(np.max(np.abs(rho)))
        inv_rho = np.where(rho > 1e-12 * scale, 1.0 / np.maximum(rho, 1e-300),
                           0.0)
        self._rho = t(rho)
        self._z = t(z)
        self._inv_rho = t(inv_rho)
        self._JxW = t(disc.detJxW)
        self._invJ = t(disc.invJ)
        #: rho-weighted Laplacian geometric factors (E, 3, p1, p1)
        self._Grho = t(disc.laplacian_factors(rho))
        self._D0 = t(disc.basis.subbases[0].D1)
        self._D1 = t(disc.basis.subbases[1].D1)

        # ---- static condensation indexing ----
        self.csys = sc.build_condensed_indexing(disc, self.DPN)
        geometry = disc.geometry
        self._hier = geometry.hierarchical_node_order
        self._n_ext_loc = geometry.n_exterior_nodes
        # local dof permutation lex-interleaved -> hier-interleaved
        perm = np.empty(disc.n_loc * 2, dtype=np.int64)
        perm[0::2] = 2 * self._hier
        perm[1::2] = 2 * self._hier + 1
        self._ldof_perm = torch.as_tensor(perm, device=dev)
        # exterior-node global numbering (for writing x_ext back)
        gather_hier = disc.gather_nodes[:, self._hier]
        self._gather_hier = gather_hier
        self._ext_global_nodes = np.unique(
            gather_hier[:, : self._n_ext_loc]
        )
        self._int_global_nodes = gather_hier[:, self._n_ext_loc:]

        # ---- solution state (global, numpy float64, or on the device) ----
        self._soln_host = np.zeros((disc.n_nodes, 2))
        self._soln_dev = None   # device-resident solution (lazy download)

        # ---- BC state ----
        #: True where the dof is FREE (unknown); (n_nodes, 2)
        self.dof_free = np.ones((disc.n_nodes, 2), dtype=bool)
        #: Neumann contour integrals on condensed dofs (n_ext_dofs,)
        self.cint = np.zeros(self.csys.n_ext_dofs)

        self._bnd_nodes = {
            name: disc.boundary_node_set(name)
            for name in mesh.boundary_names
        }

        self._step_fn = None  # the Newton step of the linear solver

    def shard_elements(self, device_mesh, axis: str = "elements") -> None:
        """Element-shard the Newton pipeline over ``device_mesh`` (a
        :func:`...parallel.sharding.device_mesh` on the model's device).

        The per-element operands (``_rho``, ``_z``, ``_inv_rho``, ``_JxW``,
        ``_invJ``, ``_Grho``) are padded to a multiple of the mesh's shards
        by repeating element 0 (valid geometry: no NaN), and the element
        residual and its ``jacfwd`` Jacobian run in one ``vmap`` over the
        padded stack (the shards' blocks side by side: on one device a
        loop over the blocks gives the same bits).  Their outputs are
        sliced back to the real E before the static condensation, which,
        with the condensed assembly and dense solve, runs over all the
        elements as before (the reference replicates that part too).  The
        Newton step is rebuilt at its next use.  ``axis`` names the mesh
        axis and is not read here.

        On a process-group mesh (one rank per card, the model built on the
        rank's device) each rank computes the residuals and Jacobians of
        its own block of the padded elements; the blocks are all-gathered
        in rank order, and the static condensation, the assembly and the
        float64 LU run whole on every rank (the reference replicates them
        too), so every rank takes the same Newton steps.
        """
        from ..config import canonical_device

        if canonical_device(device_mesh.device) != self.device:
            raise ValueError(
                f"the mesh's device ({device_mesh.device}) is not the "
                f"model's ({self.device})")
        self._shard_mesh = device_mesh
        n_sh = int(device_mesh.size)
        E = self.disc.E
        Ep = -(-E // n_sh) * n_sh
        for name in ("_rho", "_z", "_inv_rho", "_JxW", "_invJ", "_Grho"):
            arr = getattr(self, name)[:E]
            if Ep > E:
                arr = torch.cat([arr, arr[:1].expand(Ep - E,
                                                     *arr.shape[1:])])
            setattr(self, name, arr.contiguous())
        # the cached vmaps and Newton step captured the unpadded operands
        self._sys_cache = None
        self._step_fn = None

    # -- reference-parity views --------------------------------------------

    @property
    def soln(self) -> np.ndarray:
        """Global (n_nodes, 2) [psi, omega] solution.

        Newton solves leave the field ON DEVICE; this property downloads it
        on first host access and caches the host copy.
        """
        if self._soln_dev is not None:
            self._soln_host = self._soln_dev.detach().cpu().numpy().astype(
                np.float64)
            self._soln_dev = None
        return self._soln_host

    @soln.setter
    def soln(self, v) -> None:
        arr = np.asarray(v, dtype=np.float64)
        if not arr.flags.writeable:
            arr = arr.copy()
        self._soln_host = arr
        self._soln_dev = None

    def _set_bc_rows(self, nodes, col, values) -> None:
        """Dirichlet-row write into whichever solution copy is live (a new
        device tensor — no field download)."""
        if self._soln_dev is not None:
            d = self._soln_dev.clone()
            idx = torch.as_tensor(np.asarray(nodes), device=d.device)
            v = torch.as_tensor(np.asarray(values, dtype=np.float64),
                                device=d.device).to(d.dtype)
            if col is None:
                d[idx, :] = v
            else:
                d[idx, col] = v
            self._soln_dev = d
        elif col is None:
            self._soln_host[nodes, :] = values
        else:
            self._soln_host[nodes, col] = values

    @property
    def soln_vec(self) -> np.ndarray:
        """Interleaved global solution vector (parity ``squirmer:96-98``)."""
        return self.soln.reshape(-1)

    @soln_vec.setter
    def soln_vec(self, v):
        self.soln = np.asarray(v, dtype=np.float64).reshape(-1, 2).copy()

    @property
    def sfn(self) -> np.ndarray:
        return self.soln[:, 0]

    @property
    def vort(self) -> np.ndarray:
        return self.soln[:, 1]

    @property
    def mesh(self):
        return self.disc.mesh

    # -- setup --------------------------------------------------------------

    def set_initial_guess(self) -> None:
        """Potential-flow initial guess (parity ``squirmer:113-122``)."""
        xg = self.disc.global_gll_coords()
        self.soln[:, 0] = sfn_potential(xg[0], xg[1])
        self.soln[:, 1] = 0.0

    def pre_assembly(self, speed, slip_vel, n_rey) -> None:
        """Set BCs + Neumann contour integrals + physical parameters.

        Parity: ``squirmer:163-257`` (minus the operator tensors, which are
        matrix-free here and independent of speed/Re).
        """
        self.phys_params["speed"] = speed
        self.phys_params["slip_profile"] = slip_vel
        self.phys_params["N_Re"] = n_rey

        disc = self.disc
        xg = disc.global_gll_coords()
        self.dof_free[:] = True
        self.cint[:] = 0.0

        # sphere: psi = 0 (essential); slip velocity as natural BC on the
        # vorticity-definition equation
        sph = self._bnd_nodes["sphere"]
        self._set_bc_rows(sph, 0, 0.0)
        self.dof_free[sph, 0] = False
        self._apply_slip_cint(slip_vel)

        # symmetry axis: psi = 0, omega = 0
        axis = self._bnd_nodes["symaxis"]
        self._set_bc_rows(axis, None, 0.0)
        self.dof_free[axis, :] = False

        # outer shell: free stream at the swimming speed; omega = 0
        shell = self._bnd_nodes["shell"]
        self._set_bc_rows(
            shell, 0,
            -sfn_free_stream(xg[0, shell], xg[1, shell]) * speed)
        self.dof_free[shell, 0] = False
        self._set_bc_rows(shell, 1, 0.0)
        self.dof_free[shell, 1] = False

        self._sync_free_ext()

    def _sync_free_ext(self) -> None:
        """The condensed free mask on the device, from :attr:`dof_free`."""
        self._free_ext = torch.as_tensor(self._ext_free_mask(),
                                         device=self.device)

    def _ext_free_mask(self) -> np.ndarray:
        node_to_ext = np.full(self.disc.n_nodes, -1, dtype=np.int64)
        node_to_ext[self._ext_global_nodes] = np.arange(
            self._ext_global_nodes.size
        )
        mask = np.ones(self.csys.n_ext_dofs, dtype=bool)
        ext_of = node_to_ext[np.arange(self.disc.n_nodes)]
        on_ext = ext_of >= 0
        for c in range(2):
            rows = ext_of[on_ext] * 2 + c
            mask[rows] = self.dof_free[on_ext, c]
        return mask

    def _apply_slip_cint(self, slip_vel) -> None:
        """Neumann contour integral enforcing the surface slip velocity.

        Parity: ``squirmer:131-145`` — contribution
        ``-w * rho * n_grad_sfn`` with ``n_grad_sfn = rho (n_rho v_z -
        n_z v_rho)``; with the outward-from-fluid face normal the net sign
        is ``+`` (validated against the Stokes-limit oracle: swimming
        speed -> +1, fixed-sphere drag -> -6*pi).
        """
        disc = self.disc
        fg = disc.face_geometry("sphere")
        rho_f, z_f = fg.x[:, 0], fg.x[:, 1]
        r = np.sqrt(rho_f**2 + z_f**2)
        sin_th = rho_f / r
        cos_th = z_f / r
        v_th = slip_vel(sin_th, cos_th)
        v_rho = v_th * cos_th
        v_z = -v_th * sin_th
        n_rho, n_z = fg.n_dS[:, 0], fg.n_dS[:, 1]
        n_grad_sfn = rho_f * (n_rho * v_z - n_z * v_rho)
        contrib = fg.weights * rho_f * n_grad_sfn

        node_to_ext = np.full(disc.n_nodes, -1, dtype=np.int64)
        node_to_ext[self._ext_global_nodes] = np.arange(
            self._ext_global_nodes.size
        )
        gidx = disc.face_global_nodes("sphere")
        rows = node_to_ext[gidx] * 2 + 1  # vorticity-definition component
        assert (rows >= 0).all()
        np.add.at(self.cint, rows.ravel(), contrib.ravel())

    # -- residual / Jacobian --------------------------------------------------

    def _local_system_fns(self):
        """(local_residual, value_and_jac) for one element.

        ``local_residual`` is a pure function of one element (no in-place
        update, no value-dependent branch), so ``torch.func`` transforms
        it; ``value_and_jac`` returns (Jacobian, residual) from one
        forward-mode pass (``torch.func.jacfwd``).
        """
        p1 = self.p1
        nd = 2 * self.disc.n_loc
        D0, D1 = self._D0, self._D1

        def local_residual(x_flat, Grho_e, JxW_e, inv_rho_e, invJ_e,
                           rsJxW_e, n_rey):
            x_e = x_flat.reshape(p1, p1, 2)
            psi = x_e[..., 0]
            w = x_e[..., 1]

            def dxi(u):
                return D0 @ u, u @ D1.T

            def phys_grad(u):
                u0, u1 = dxi(u)
                return (invJ_e[0, 0] * u0 + invJ_e[1, 0] * u1,
                        invJ_e[0, 1] * u0 + invJ_e[1, 1] * u1)

            def stiff_rho(u):
                u0, u1 = dxi(u)
                fr = Grho_e[0] * u0 + Grho_e[1] * u1
                fs = Grho_e[1] * u0 + Grho_e[2] * u1
                return D0.T @ fr + fs @ D1

            psi_rho, psi_z = phys_grad(psi)
            w_rho, w_z = phys_grad(w)
            r_w = (
                n_rey * JxW_e * (psi_rho * w_z - psi_z * w_rho)
                + n_rey * JxW_e * inv_rho_e * psi_z * w
                + stiff_rho(w)
                + JxW_e * inv_rho_e * w
            )
            r_d = stiff_rho(psi) + 2.0 * JxW_e * psi_rho - rsJxW_e * w
            return torch.stack([r_w, r_d], dim=-1).reshape(nd)

        def with_value(*args):
            r = local_residual(*args)
            return r, r

        value_and_jac = torch.func.jacfwd(with_value, has_aux=True)
        return local_residual, value_and_jac

    def _elem_gather(self) -> torch.Tensor:
        """The gather map of the element vmaps, padded like the element
        operands (``shard_elements`` repeats element 0); the caller slices
        the vmap outputs back to the real count."""
        g = self.disc.gather_nodes
        Ep = int(self._Grho.shape[0])
        if Ep > g.shape[0]:
            g = np.concatenate([g, np.repeat(g[:1], Ep - g.shape[0],
                                             axis=0)])
        return torch.as_tensor(g, device=self.device)

    def _local_systems(self, soln_global, n_rey, free_ext):
        """Element residuals and Jacobians in the hier-interleaved order:
        ``(lrhs, lmat)`` = (-R_e, dR_e/dx_e), (E, nd) and (E, nd, nd).

        A non-finite entry in a constrained row or column (``free_ext``
        False) is zeroed, so nothing non-finite from the axis reaches an
        LU.  One on a free DOF stays: it makes the Newton update
        non-finite, and the loop raises :class:`SolverFailure`, as the
        reference's direct solver does.
        """
        cache = getattr(self, "_sys_cache", None)
        nd = 2 * self.disc.n_loc
        if cache is None:
            _res, value_and_jac = self._local_system_fns()
            batched = torch.func.vmap(value_and_jac,
                                      in_dims=(0, 0, 0, 0, 0, 0, None))
            gather = self._elem_gather()
            rs_jxw = self._rho * self._rho * self._JxW   # Me diagonal
            ext_gidx = torch.as_tensor(self.csys.ext_dof_gidx,
                                       device=self.device)
            interior = torch.ones((self.disc.E, nd - self.csys.n_ext_ldof),
                                  dtype=torch.bool, device=self.device)
            cache = self._sys_cache = (batched, gather, rs_jxw, ext_gidx,
                                       interior)
        batched, gather, rs_jxw, ext_gidx, interior = cache
        x_flat = soln_global[gather].reshape(-1, nd)
        mesh = getattr(self, "_shard_mesh", None)
        ops = (x_flat, self._Grho, self._JxW, self._inv_rho, self._invJ,
               rs_jxw)
        if comm.distributed(mesh):
            # this rank's elements only; the blocks all-gathered
            jac, res = batched(*(comm.block_of(mesh, t, 0) for t in ops),
                               n_rey)
            jac = comm.gather_blocks(mesh, jac, 0)
            res = comm.gather_blocks(mesh, res, 0)
        else:
            jac, res = batched(*ops, n_rey)
        E = self.disc.E
        jac, res = jac[:E], res[:E]          # drop the shards' padding
        perm = self._ldof_perm
        lrhs = -res[:, perm]
        lmat = jac[:, perm][:, :, perm]
        free = torch.cat([free_ext[ext_gidx], interior], dim=1)
        lmat = torch.where(torch.isfinite(lmat)
                           | (free[:, :, None] & free[:, None, :]), lmat, 0.0)
        lrhs = torch.where(torch.isfinite(lrhs) | free, lrhs, 0.0)
        return lrhs, lmat

    def _make_step(self):
        """The direct Newton step: residual + autodiff Jacobian + batched
        static-condensation solve, returning the (n_nodes, 2) update on
        the device.  ``log`` is there for the signature it shares with the
        GMRES-IR step; the direct step logs nothing."""
        dev = self.device
        ext_nodes = torch.as_tensor(self._ext_global_nodes, device=dev)
        int_nodes = torch.as_tensor(self._int_global_nodes.reshape(-1),
                                    device=dev)
        ne = self.csys.n_ext_ldof
        n_nodes = self.disc.n_nodes

        def step(soln_global, n_rey, cint, free_ext, log=True):
            lrhs, lmat = self._local_systems(soln_global, n_rey, free_ext)
            x_ext, x_loc = sc.schur_solve(lmat, lrhs, self.csys, free_ext,
                                          rhs_extra=cint)
            dsoln = torch.zeros((n_nodes, 2), dtype=x_ext.dtype, device=dev)
            dsoln[ext_nodes] = x_ext.reshape(-1, 2)
            dsoln[int_nodes] = x_loc[:, ne:].reshape(-1, 2)
            return dsoln

        return step

    def _make_step_mixed(self, gmres_tol: float = 1e-12, restart: int = 30,
                         max_restarts: int = 40):
        """Newton correction by f64 GMRES + f32 condensation preconditioner.

        The correction system J dx = -R is solved by :func:`gmres` in
        float64 (batched Jacobian matvecs + scatter assembly),
        preconditioned by one full float32 static-condensation solve per
        Krylov vector from the Schur factors of the step.  Returns the
        assembled global Newton update (n_nodes, 2), on the device.
        ``log`` reads whether GMRES converged and logs a stagnated or
        exhausted correction (one more read per Newton step).
        """
        disc = self.disc
        dev = self.device
        nd = 2 * disc.n_loc
        csys = self.csys
        n_dofs = disc.n_nodes * 2
        ne_ldof = csys.n_ext_ldof

        gdof_np = (self._gather_hier[:, :, None] * 2
                   + np.arange(2)[None, None, :]).reshape(disc.E, nd)
        gdof = torch.as_tensor(gdof_np, device=dev)
        mult = np.bincount(gdof_np.ravel(),
                           minlength=n_dofs).astype(np.float64)
        wdof = torch.as_tensor(1.0 / np.maximum(mult[gdof_np], 1.0),
                               device=dev).to(self._tdtype)
        ext_gdof = torch.as_tensor(
            (self._ext_global_nodes[:, None] * 2
             + np.arange(2)[None, :]).reshape(-1), device=dev)
        int_gdof = torch.as_tensor(
            (self._int_global_nodes[:, :, None] * 2
             + np.arange(2)[None, None, :]).reshape(-1), device=dev)

        def Jv(v, lmat, free_dof):
            vm = torch.where(free_dof, v, 0.0)
            Av = torch.einsum("eij,ej->ei", lmat, vm[gdof])
            return torch.where(free_dof, accumulate(n_dofs, gdof, Av), v)

        def Mpre(r, facs, free_dof):
            # local rhs whose DSS assembly equals r (1/multiplicity split);
            # the pipeline is factored ONCE per Newton step
            rl = (r[gdof] * wdof).to(torch.float32)
            x_ext, x_loc = sc.schur_apply(facs, rl, csys)
            dx = torch.zeros(r.shape, dtype=torch.float32, device=dev)
            dx[ext_gdof] = x_ext
            dx[int_gdof] = x_loc[:, ne_ldof:].reshape(-1)
            return torch.where(free_dof, dx.to(r.dtype), r)

        def step(soln_global, n_rey, cint, free_ext, log=True):
            lrhs, lmat = self._local_systems(soln_global, n_rey, free_ext)
            free_dof = torch.ones(n_dofs, dtype=torch.bool, device=dev)
            free_dof[ext_gdof] = free_ext
            bg = accumulate(n_dofs, gdof, lrhs)
            bg = bg.index_put_((ext_gdof,), cint, accumulate=True)
            bg = torch.where(free_dof, bg, 0.0)
            facs = sc.schur_factor(lmat.to(torch.float32), csys, free_ext)
            # stall_ratio=0.5: freeze restart cycles burnt below the
            # attainable-accuracy floor of the f32-preconditioned
            # correction (the reference's measured setting)
            res = gmres(lambda v: Jv(v, lmat, free_dof), bg,
                        M=lambda r: Mpre(r, facs, free_dof), tol=gmres_tol,
                        restart=restart, max_restarts=max_restarts,
                        stall_ratio=0.5)
            if log and not bool(res.converged):
                rn, its = float(res.residual_norm), int(res.iterations)
                if its < max_restarts * restart:
                    # the stagnation freeze: late Newton steps have
                    # ||b|| ~ eps, so gmres_tol*||Mb|| can sit below what
                    # f64-with-f32-preconditioner arithmetic can reach
                    _log.debug(
                        "GMRES-IR stagnated at |r|=%.3e after %d "
                        "iterations; correction at attainable accuracy",
                        rn, its)
                else:
                    _log.warning(
                        "GMRES-IR exhausted %d restarts at |r|=%.3e; "
                        "Newton will apply an unconverged correction",
                        max_restarts, rn)
            return res.x.reshape(disc.n_nodes, 2)

        return step

    # -- Newton solve --------------------------------------------------------

    def _newton_inputs(self):
        """(soln on the device, n_rey, cint, free_ext) of a Newton solve."""
        dev, tdt = self.device, self._tdtype
        soln = (self._soln_dev if self._soln_dev is not None
                else torch.as_tensor(self._soln_host, device=dev))
        return (soln.to(tdt),
                torch.as_tensor(float(self.phys_params["N_Re"]),
                                device=dev).to(tdt),
                torch.as_tensor(self.cint, device=dev).to(tdt),
                self._free_ext)

    def solve(self, it_max: int = 10, tol: float = 1e-6,
              max_n_diverge: int = 3, verbose: bool = True,
              newton_loop: str = "host") -> None:
        """Newton iteration on the condensed system.

        Parity: ``squirmer:389-457`` — divergence counting, convergence on
        ``||d vorticity||``.  The iterate stays on the device; the host
        reads ``||du||`` once per step, and the field downloads lazily
        through :attr:`soln`.

        ``newton_loop="host"`` prints each step and, with GMRES-IR, reads
        whether each correction converged for the log.  ``"device"`` runs
        the same loop without those: one read per step.  (The reference's
        device loop is one jitted ``while_loop``; the port's loop already
        keeps the iterate on the device, so the two give the same bits.)
        """
        if newton_loop not in ("host", "device"):
            raise ValueError(f"unknown newton_loop {newton_loop!r}")
        if self._step_fn is None:
            self._step_fn = (self._make_step_mixed()
                             if self.linear_solver == "gmres-ir"
                             else self._make_step())
        loud = newton_loop == "host"
        soln, n_rey, cint, free_ext = self._newton_inputs()

        n_diverge = 0
        du_norm_last = np.inf

        def finish():
            self._soln_dev, self._soln_host = soln, None

        for itn in range(it_max):
            dsoln = self._step_fn(soln, n_rey, cint, free_ext, log=loud)
            soln = soln + dsoln
            du_norm = float(torch.linalg.norm(dsoln[:, 1]))
            if not np.isfinite(du_norm):
                finish()
                raise SolverFailure("Newton update is not finite")
            if du_norm > du_norm_last:
                n_diverge += 1
                if n_diverge >= max_n_diverge:
                    finish()
                    raise SolverFailure(
                        f"Solution diverged {n_diverge} times "
                        f"(||du|| = {du_norm})"
                    )
            if np.isclose(du_norm, 0.0, atol=tol):
                finish()
                if verbose:
                    print(f" => Calculation converged in {itn} Newton "
                          f"iterations\n    ||du|| = {du_norm}")
                return
            du_norm_last = du_norm
            if verbose and loud:
                print(f"[Iteration {itn}]: ||du|| = {du_norm}")

        finish()
        raise SolverFailure(
            "Calculation failed to reach specified tolerance after "
            f"{it_max} Newton iterations.\n => Diff = {du_norm}"
        )

    # -- force ---------------------------------------------------------------

    def _make_calc_force_device(self, slip):
        """On-device surface-stress quadrature (same math as the numpy
        :meth:`calc_force`, vectorized over the sphere face cells).

        Cached per slip-profile identity; used when the solution is
        device-resident so a force evaluation reads one scalar instead of
        downloading the field.
        """
        cache = getattr(self, "_force_dev_cache", None)
        if cache is not None and cache[0] is slip:
            return cache[1]

        from ..mesh.geometry import subface_slice

        disc = self.disc
        dev, tdt = self.device, self._tdtype
        p1 = self.p1
        fg = disc.face_geometry("sphere")
        cells = np.asarray(fg.cells)
        faces = np.asarray(fg.faces)
        nc = cells.size
        idx2d = np.arange(p1 * p1).reshape(p1, p1)
        face_idx = np.stack([
            np.asarray(subface_slice(int(f), idx2d, 2)) for f in faces])
        invJ_np = np.asarray(disc.invJ)
        invJ_S = np.stack([
            np.stack([
                np.stack([
                    np.asarray(subface_slice(int(faces[i]),
                                             invJ_np[cells[i], a, b], 2))
                    for b in range(2)])
                for a in range(2)])
            for i in range(nc)])                       # (nc, 2, 2, m)

        def t(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=dev).to(tdt)

        gath = torch.as_tensor(disc.gather_nodes[cells], device=dev)
        fidx = torch.as_tensor(face_idx, device=dev)
        invJ_d = t(invJ_S)
        x_S = t(fg.x)                                  # (nc, 2, m)
        dS = t(fg.dS)                                  # (nc, m)
        wts = t(fg.weights)                            # (m,)
        D0 = t(disc.basis.subbases[0].D1)
        D1 = t(disc.basis.subbases[1].D1)
        # the slip profile depends only on the STATIC face coordinates —
        # evaluate it host-side with numpy operands
        sin_np = np.asarray(fg.x)[:, 0]
        cos_np = np.asarray(fg.x)[:, 1]
        vslip = t(np.broadcast_to(
            np.asarray(slip(sin_np, cos_np), dtype=np.float64),
            sin_np.shape))

        def force(soln, n_rey):
            w_all = soln[:, 1][gath]                       # (nc, n_loc)
            w_grid = w_all.reshape(nc, p1, p1)
            dw0 = torch.einsum("mj,ejn->emn", D0, w_grid)
            dw1 = torch.einsum("nk,emk->emn", D1, w_grid)
            dw0_f = torch.gather(dw0.reshape(nc, -1), 1, fidx)
            dw1_f = torch.gather(dw1.reshape(nc, -1), 1, fidx)
            dw_du = torch.stack([dw0_f, dw1_f], dim=1)     # (nc, 2, m)
            w_S = torch.gather(w_all, 1, fidx)             # (nc, m)
            dw_dr = torch.einsum("cam,caim,cim->cm", dw_du, invJ_d, x_S)
            sin_th, cos_th = x_S[:, 0], x_S[:, 1]
            sin2 = sin_th**2
            bernouli = np.pi * n_rey * vslip**2 * sin_th * cos_th
            w_asym = np.pi * (dw_dr + w_S) * sin2
            viscous = -2.0 * np.pi * w_S * sin2
            total = bernouli + w_asym + viscous
            return torch.sum(wts[None, :] * total * dS)

        self._force_dev_cache = (slip, force)
        return force

    def calc_force(self) -> float:
        """Total hydrodynamic force on the (unit) sphere.

        Surface-stress quadrature over the sphere faces
        (parity: ``squirmer:459-518``; unit radius assumed, as there).
        When the solution is device-resident (after a Newton solve), the
        quadrature runs on the device too — no field download.
        """
        if self._soln_dev is not None:
            force = self._make_calc_force_device(
                self.phys_params["slip_profile"])
            return float(force(self._soln_dev,
                               float(self.phys_params["N_Re"])))
        disc = self.disc
        fg = disc.face_geometry("sphere")
        n_rey = float(self.phys_params["N_Re"])
        slip = self.phys_params["slip_profile"]

        cells = fg.cells
        # vorticity on the face cells, lex layout
        w_cells = self.soln[:, 1][disc.gather_nodes[cells]].reshape(
            -1, self.p1, self.p1
        )
        # parametric gradient
        D0 = np.asarray(self.disc.basis.subbases[0].D1)
        D1 = np.asarray(self.disc.basis.subbases[1].D1)
        dw0 = np.einsum("mj,ejn->emn", D0, w_cells)
        dw1 = np.einsum("nk,emk->emn", D1, w_cells)

        from ..mesh.geometry import subface_slice

        total_force = 0.0
        for i, (c, f) in enumerate(zip(fg.cells, fg.faces)):
            f = int(f)
            # restrict to the face (CCW orientation, matching fg arrays)
            dw_du = np.stack([
                subface_slice(f, dw0[i], 2),
                subface_slice(f, dw1[i], 2),
            ])                                           # (2, m)
            invJ_S = np.stack([
                subface_slice(f, disc.invJ[c, a, b], 2)
                for a in range(2) for b in range(2)
            ]).reshape(2, 2, -1)                          # (a, i, m)
            x_S = fg.x[i]                                 # (2, m), r = 1
            w_S = subface_slice(
                f, self.soln[:, 1][disc.gather_nodes[c]].reshape(
                    self.p1, self.p1), 2)

            # dw/dr = (dw/dxi_a)(dxi_a/dx_i) x_i  (radial unit vector = x)
            dw_dr = np.einsum("am,aim,im->m", dw_du, invJ_S, x_S)

            sin_th = x_S[0]
            cos_th = x_S[1]
            sin2 = sin_th**2
            vslip = slip(sin_th, cos_th)

            bernouli = np.pi * n_rey * vslip**2 * sin_th * cos_th
            w_asym = np.pi * (dw_dr + w_S) * sin2
            pressure = bernouli + w_asym
            viscous = -2.0 * np.pi * w_S * sin2
            total = pressure + viscous

            d_arc = fg.dS[i]
            total_force += float(np.sum(fg.weights * total * d_arc))
        return total_force


class FixedSphere(SphereWithSlipVel):
    """Uniform flow past a fixed no-slip sphere (parity ``squirmer:521-540``)."""

    def pre_assembly(self, n_rey):
        super().pre_assembly(1.0, zero_slip_vel, n_rey)

    def run(self, n_rey, **flow_solver_opts):
        self.set_initial_guess()
        self.pre_assembly(n_rey)
        self.solve(**flow_solver_opts)


class Squirmer(SphereWithSlipVel):
    """Self-propelled squirmer (parity ``squirmer:543-743``)."""

    def set_boundary_conditions(self, speed=None, beta=None):
        if beta is None:
            slip_profile = self.phys_params["slip_profile"]
        elif (beta == self.phys_params.get("beta")
                and "slip_profile" in self.phys_params):
            # reuse the existing closure: its identity keys the device
            # force quadrature's cache
            slip_profile = self.phys_params["slip_profile"]
        else:
            slip_profile = squirmer_vslip_profile(beta)
            self.phys_params["beta"] = beta
        if speed is None:
            speed = self.phys_params["speed"]
        n_rey = self.phys_params.get("N_Re", 0.0)
        super().pre_assembly(speed, slip_profile, n_rey)

    def compute_operators(self, n_rey):
        self.phys_params["N_Re"] = n_rey

    def run(self, n_rey, beta=None, speed=None, **flow_solver_opts):
        if speed is None:
            speed = self.phys_params.get("speed", 1.0)
        self.phys_params["speed"] = speed
        self.compute_operators(n_rey)
        self.set_boundary_conditions(speed, beta)
        self.solve(**flow_solver_opts)

    # -- checkpointing (parity squirmer:595-627) ----------------------------

    def save_data(self, f) -> None:
        label = ckpt.param_label(
            Re=self.phys_params["N_Re"], beta=self.phys_params["beta"]
        )
        ckpt.save_solution(
            f, label, self.soln_vec,
            speed=self.phys_params["speed"],
            N_Re=self.phys_params["N_Re"],
            beta=self.phys_params["beta"],
        )

    def load_data(self, dset) -> None:
        self.soln_vec = dset[:]
        self.phys_params.update(dict(dset.attrs))

    def guess_from(self, other: "Squirmer") -> None:
        """Warm-start from another (possibly differently discretized)
        squirmer instance (parity ``squirmer:616-627``)."""
        from ..core import pointlocate as pl

        xg = self.disc.global_gll_coords()
        for c in range(2):
            self.soln[:, c] = pl.interpolate(
                other.disc, other.soln[:, c], xg.T
            )
        self.phys_params.update(other.phys_params)

    # -- swimming speed ------------------------------------------------------

    def calc_speed(self, speed_guess, n_rey=None, beta=None,
                   flow_solver_opts=None, speed_solver_opts=None,
                   verbose: bool = True) -> float:
        """Swimming speed at which the axial force vanishes (secant method).

        Parity: ``squirmer:629-743``, including the documented oracle::

            >>> mesh = annulus_mesh(order=8)     # donut.msh equivalent
            >>> sqrm = Squirmer(mesh)
            >>> sqrm.set_initial_guess()
            >>> sqrm.calc_speed([0.99, 1.01], n_rey=1, beta=1)
            0.92571156681483957                  # the golden value
        """
        if beta is None:
            beta = self.phys_params["beta"]
        try:
            if len(speed_guess) == 2:
                speed0, speed1 = (float(s) for s in speed_guess)
            else:
                speed0 = self.phys_params["speed"]
                speed1 = float(speed_guess[0])
        except TypeError:
            speed0 = self.phys_params["speed"]
            speed1 = float(speed_guess)

        flow_solver_opts = dict(flow_solver_opts or {})
        flow_solver_opts.setdefault("it_max", 10)
        flow_solver_opts.setdefault("tol", 1e-6)
        speed_solver_opts = dict(speed_solver_opts or {})
        it_max = speed_solver_opts.setdefault("it_max", 10)
        tol = speed_solver_opts.setdefault("tol", 1e-5)

        if n_rey is not None:
            self.compute_operators(n_rey)
        elif "N_Re" not in self.phys_params:
            raise ValueError(
                "Initial Reynolds number must be supplied to calculation."
            )

        def force_at(speed):
            if verbose:
                print(f"finding force at speed = {speed}")
            self.phys_params["speed"] = speed
            self.set_boundary_conditions(speed, beta)
            self.solve(verbose=verbose, **flow_solver_opts)
            return self.calc_force()

        speed, _ = secant(force_at, speed0, speed1, it_max=it_max, tol=tol,
                          verbose=verbose)
        self.phys_params["speed"] = speed
        return speed


def main(squirmer: Squirmer, n_rey_list, beta_list,
         speed_guess=(0.99, 1.01), filename=None,
         step_reduction_factor: float = 0.5, min_step: float = 0.0,
         flow_solver_opts=None, speed_solver_opts=None,
         verbose: bool = True):
    """Reynolds/beta continuation sweep with rollback and checkpoint/resume.

    Parity: ``squirmer:746-877`` — ascending Re sweep per beta, secant
    speed solve at each point, HDF5 resume of already-computed labels, and
    on ``SolverFailure``: step back in Re, halve the step
    (``step_reduction_factor``), restore the last converged solution, abort
    below ``min_step``.  A ``filename`` needs ``h5py``.
    """
    if not 0.0 < step_reduction_factor < 1.0:
        raise ValueError("reduction factor must be between 0 and 1")
    n_rey_list = sorted(float(r) for r in n_rey_list)

    results_file = ckpt.open_results(filename)

    def compute_point(n_rey, beta, speeds):
        label = ckpt.param_label(Re=n_rey, beta=beta)
        if ckpt.has_solution(results_file, label):
            if verbose:
                print(f'Data exists for {label} ... loading it')
            vec, attrs = ckpt.load_solution(results_file, label)
            squirmer.soln_vec = vec
            squirmer.phys_params.update(attrs)
            squirmer.phys_params["slip_profile"] = \
                squirmer_vslip_profile(beta)
            return float(attrs["speed"])
        speed = squirmer.calc_speed(list(speeds), n_rey, beta,
                                    flow_solver_opts, speed_solver_opts,
                                    verbose=verbose)
        if results_file is not None:
            squirmer.save_data(results_file)
        return speed

    all_speeds = {}
    try:
        for beta in beta_list:
            speeds = [float(speed_guess[0]), float(speed_guess[1]), 0.0]

            n_rey = n_rey_list[0]
            if verbose:
                print(f"\n### beta = {beta:.2g}, Re = {n_rey:.2g} ###")
            squirmer.set_initial_guess()
            speeds[2] = compute_point(n_rey, beta, speeds[:2])
            all_speeds[(n_rey, beta)] = speeds[2]
            last_converged = squirmer.soln_vec.copy()
            speeds[:2] = speeds[1:]

            if len(n_rey_list) == 1:
                continue
            delta = n_rey_list[1] - n_rey_list[0]
            i = 1
            while True:
                n_rey += delta
                if 0.99 * n_rey_list[i] < n_rey:
                    n_rey = n_rey_list[i]
                    on_grid = True
                else:
                    on_grid = False
                try:
                    if verbose:
                        tag = "" if on_grid else " (continuing)"
                        print(f"\n### beta = {beta}, Re = {n_rey}{tag} ###")
                    speeds[2] = compute_point(n_rey, beta, speeds[:2])
                    if on_grid:
                        all_speeds[(n_rey, beta)] = speeds[2]
                        i += 1
                        if i >= len(n_rey_list):
                            break
                        delta = n_rey_list[i] - n_rey_list[i - 1]
                    speeds[:2] = speeds[1:]
                    last_converged = squirmer.soln_vec.copy()
                except SolverFailure as exc:
                    if verbose:
                        print(f"NOTICE: Solver failed with message:\n{exc}\n"
                              "Attempting to continue...")
                    n_rey -= delta
                    delta *= step_reduction_factor
                    squirmer.soln_vec = last_converged
                    if delta < min_step:
                        raise SolverFailure(
                            "Continuation step reduced below minimum size."
                        )
    finally:
        if results_file is not None:
            results_file.close()
    return all_speeds
