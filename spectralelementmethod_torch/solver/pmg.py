"""Two-level p-multigrid preconditioner for the L-vector CG path (PyTorch
port).

Port of the JAX package's ``solver/pmg.py``: smooth the
high-order modes element-locally, correct the rest on a low-order (p_c = 1
by default) space sharing the same mesh (Lottes & Fischer 2005 lineage).

* **transfers** are one ``(n_c, n_f) @ (n_f, E)`` matmul each, the coarse
  basis evaluated at the fine GLL lattice, tensorized and permuted to the
  L-vector node order at setup;
* **smoothing** is fixed-degree Chebyshev acceleration of point Jacobi or
  of the FDM additive Schwarz (:func:`chebyshev_smoother`,
  ``smoother="fdm"``: :func:`.fdm.make_fdm_preconditioner`), a fixed
  polynomial in ``B A``, so the V-cycle stays linear and symmetric and
  plain CG applies;
* the **coarse level** reuses the fine affine scales with order-p_c
  reference matrices (or, on curved meshes and variable coefficients,
  rediscretizes on the coarse mesh); on uniform tensor-product meshes it is
  solved exactly by global fast diagonalization (:class:`GridFDM`, or
  :class:`GridFDM2DLattice` when a partitioner has renumbered the
  elements), else by a fixed-degree Chebyshev sweep.

The fine and coarse applies inside the V-cycle are the (n, E) operators of
:func:`..ops.sumfac.make_local_laplacian_operator` with
``backend=cycle_backend``: in float32 on a tail-free roll-class exchange
those are the hand-written apply kernels (the coarse level's at p = 1, n =
4), otherwise the ``"xla"`` operator.  The V-cycle's own matmuls (the
transfers and the grid solve) run in true float32: TF32 is kept off around
each application, whatever the process-wide setting.

Construction is host numpy (as in the reference); the returned
:class:`PMGPreconditioner` acts on (n_f, E) transposed L-vectors, or on a
(k, n_f, E) stack of them (the reference's ``jax.vmap(M)``: the operators'
``.stacked(k)``, one batched launch per apply, batched transfers and grid
solve, one ``lmax`` estimate).

The 3D factory (:func:`make_pmg_preconditioner_3d`, which
:func:`make_pmg_preconditioner` dispatches to on a 3D mesh) acts on
lexicographic (E, n) L-vectors: a p_c = 2 coarse level rediscretized on
the shared-node coarse mesh, Chebyshev-Jacobi smoothing on the outer
solve's operator in its dtype, and the exact :class:`GridFDM3D` lattice
solve on box meshes (else a Chebyshev sweep).  The 2D factory's
``coarse_pad_to`` pads the coarse level to the sharded callers' fine
element count (:func:`..parallel.sharding.sharded_local_poisson_problem`).
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ..config import resolve_device, torch_dtype
from ..config import true_f32 as _true_f32
from ..utils.stages import stage as _host_stage


def _staged_factory(fn):
    """Account a preconditioner factory's host wall-clock under the stage
    ``precond/pmg-build`` (:mod:`..utils.stages`)."""
    @functools.wraps(fn)
    def inner(*a, **kw):
        with _host_stage("precond/pmg-build"):
            return fn(*a, **kw)
    return inner


# ---------------------------------------------------------------------------
# Chebyshev acceleration of an SPD preconditioner


def chebyshev_smoother(A, B, lmax: float, lmin: float, degree: int):
    """Fixed-degree Chebyshev iteration for ``A z = r`` (zero start).

    ``A``/``B`` are the operator and an SPD preconditioner application;
    the iteration targets the interval ``[lmin, lmax]`` of ``B A``'s
    spectrum.  The result is a fixed polynomial ``z = p(B A) B r``, hence
    linear and symmetric whenever A and B are.  ``degree`` applies of A
    and B each.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def S(r):
        d = (1.0 / theta) * B(r)
        z = d
        rho = 1.0 / sigma
        res = r
        for _ in range(degree - 1):
            res = res - A(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * B(res)
            z = z + d
            rho = rho_new
        return z

    return S


def estimate_lmax(A, B, shape, dtype=np.float32, iters: int = 30,
                  safety: float = 1.05, device=None, mesh=None) -> float:
    """Power-iteration estimate of ``lmax(B A)`` (masked subspace).

    The reference's deterministic start vector (``RandomState(0)``, made on
    the host in ``dtype``), ``iters`` applications as a plain loop on
    ``device`` and one host read at the end.  ``safety`` pads the estimate
    (Chebyshev bounds must cover the top eigenvalue).  ``mesh``: on a
    process-group mesh (:mod:`..parallel.comm`) ``A`` and ``B`` act on the
    rank's column block of the (.., E) ``shape``: each rank takes its block
    of the same start vector and the norm is summed over the ranks, so
    every rank reads the same estimate.
    """
    from ..parallel import comm

    rng = np.random.RandomState(0)
    v0 = rng.standard_normal(shape).astype(dtype)
    if mesh is not None:
        v0 = np.ascontiguousarray(comm.block_of(mesh, v0))
    v = torch.as_tensor(v0, device=resolve_device(device))
    nrm = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = B(A(v)).to(v.dtype)
        s = torch.sum(w * w)
        nrm = torch.sqrt(s if mesh is None else comm.rank_sum(mesh, s))
        v = w / nrm
    return float(nrm) * safety


# ---------------------------------------------------------------------------
# Exact coarse solve on uniform tensor-product grids


def _index(cache: dict, name: str, arr, device) -> torch.Tensor:
    """Device copy of a host index array, cached per device."""
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(arr, np.int64),
                                     device=device)
    return cache[key]


def _eig_1d(basis_c, d: int, n_el: int, i0: int, i1: int):
    """Generalized eigenpairs of the assembled 1D GLL stiffness against the
    lumped mass along axis ``d`` (``n_el`` elements), on the free index
    interval ``[i0, i1)``: (lam, S) with ``S`` mass-orthonormal."""
    return _eig_assembled(basis_c.quad_rule.weights[d],
                          basis_c.get_subbasis(d).D1, n_el, i0, i1)


def _eig_assembled(w1, D1, n_el: int, i0: int, i1: int):
    """:func:`_eig_1d` from the 1D weights ``w1`` and derivative ``D1``."""
    w1 = np.asarray(w1, np.float64)
    D1 = np.asarray(D1, np.float64)
    khat = D1.T @ np.diag(w1) @ D1
    K, m = GridFDM._assemble_1d(0.5 * (khat + khat.T), w1, n_el)
    K, m = K[i0:i1, i0:i1], m[i0:i1]
    ms = 1.0 / np.sqrt(m)
    lam, Q = np.linalg.eigh(ms[:, None] * K * ms[None, :])
    return np.maximum(lam, 1e-300), ms[:, None] * Q


class GridFDM:
    """Global fast-diagonalization solve of the coarse operator.

    On a uniform tensor-product mesh the assembled affine coarse operator
    separates exactly: ``A_c = a0 K_x (x) M_y + a2 M_x (x) K_y`` with 1D
    assembled GLL stiffness/lumped-mass matrices along each element
    row/column.  One generalized symmetric eigendecomposition per axis
    (host, at setup) then inverts the free sub-block with two dense grid
    matmuls:

        u = S_x [ (S_x^T G S_y) / (a0 lam_x_i + a2 lam_y_j) ] S_y^T

    The eigen-transforms are stored in float32 (as the reference's), and
    cast to the vector's dtype per call.  Acts on (n_c, Ec) transposed
    L-vectors or (k, n_c, Ec) stacks.  Use :meth:`try_build`; it returns
    ``None`` unless every precondition verifiably holds (uniform affine
    factors, no mixed term, tensor element numbering, per-side-uniform
    Dirichlet data).
    """

    def __init__(self, P0, P1, nx, ny, Sx, Sy, lamx, lamy, a0, a2,
                 fx0, fx1, fy0, fy1, Er, Ec, lex_rows, hier_rows, device):
        self.p0, self.p1 = P0, P1
        self.nx, self.ny = nx, ny
        self.lam = a0 * np.asarray(lamx)[:, None] + \
            a2 * np.asarray(lamy)[None, :]
        self.fx0, self.fx1, self.fy0, self.fy1 = fx0, fx1, fy0, fy1
        self.Er, self.Ec = Er, Ec
        self._lex_rows = np.asarray(lex_rows)
        self._hier_rows = np.asarray(hier_rows)
        self._idx = {}
        self._inv_lam = torch.as_tensor(
            (1.0 / self.lam).astype(np.float32), device=device)
        self.Sx = torch.as_tensor(np.asarray(Sx, np.float32), device=device)
        self.Sy = torch.as_tensor(np.asarray(Sy, np.float32), device=device)

    # -- L-vector <-> grid ---------------------------------------------------

    def _to_grid(self, rc: torch.Tensor) -> torch.Tensor:
        """Consistent hier L-vector (..., n_c, Ec) -> grid (..., N0, N1)."""
        p0, p1, nx, ny = self.p0, self.p1, self.nx, self.ny
        lead = rc.shape[:-2]
        L = len(lead)
        rows = _index(self._idx, "lex", self._lex_rows, rc.device)
        lex = rc.index_select(-2, rows)[..., :self.Er].reshape(
            *lead, p0 + 1, p1 + 1, nx, ny)
        core = lex[..., :p0, :p1, :, :].permute(
            *range(L), L + 2, L, L + 3, L + 1).reshape(
            *lead, nx * p0, ny * p1)
        east = lex[..., p0, :p1, -1, :].transpose(-1, -2).reshape(
            *lead, 1, ny * p1)
        north = lex[..., :p0, p1, :, -1].transpose(-1, -2).reshape(
            *lead, nx * p0, 1)
        ne = lex[..., p0, p1, -1, -1].reshape(*lead, 1, 1)
        return torch.cat([torch.cat([core, north], dim=-1),
                          torch.cat([east, ne], dim=-1)], dim=-2)

    def _from_grid(self, G: torch.Tensor) -> torch.Tensor:
        """Grid (..., N0, N1) -> consistent hier L-vector (..., n_c, Ec)."""
        p0, p1, nx, ny = self.p0, self.p1, self.nx, self.ny
        lead = G.shape[:-2]
        rows = []
        for a in range(p0 + 1):
            cols = []
            for b in range(p1 + 1):
                cols.append(G[..., a:a + (nx - 1) * p0 + 1:p0,
                              b:b + (ny - 1) * p1 + 1:p1])
            rows.append(torch.stack(cols, dim=-3))
        lex = torch.stack(rows, dim=-4)          # (..., p0+1, p1+1, nx, ny)
        flat = lex.reshape(*lead, (p0 + 1) * (p1 + 1), self.Er)
        if self.Ec > self.Er:
            flat = torch.nn.functional.pad(flat, (0, self.Ec - self.Er))
        return flat.index_select(
            -2, _index(self._idx, "hier", self._hier_rows, G.device))

    def __call__(self, rc: torch.Tensor) -> torch.Tensor:
        dt = rc.dtype
        G = self._to_grid(rc)
        Gf = G[..., self.fx0:self.fx1, self.fy0:self.fy1]
        Sx, Sy = self.Sx.to(dt), self.Sy.to(dt)
        t = Sx.T @ Gf @ Sy
        t = t * self._inv_lam.to(dt)
        U = torch.zeros_like(G)
        U[..., self.fx0:self.fx1, self.fy0:self.fy1] = Sx @ t @ Sy.T
        return self._from_grid(U)

    # -- construction ----------------------------------------------------------

    @staticmethod
    def _assemble_1d(khat, what, n_el):
        """Global 1D assembled stiffness (dense) and lumped mass (diag)."""
        p = khat.shape[0] - 1
        N = n_el * p + 1
        K = np.zeros((N, N))
        m = np.zeros(N)
        for e in range(n_el):
            s = slice(e * p, e * p + p + 1)
            K[s, s] += khat
            m[e * p:e * p + p + 1] += what
        return K, m

    @staticmethod
    def _side_interval(fgrid):
        """Free index interval of an outer-product grid mask, or None."""
        fx = fgrid.any(axis=1)
        fy = fgrid.any(axis=0)
        if not np.array_equal(fgrid, fx[:, None] & fy[None, :]):
            return None
        ivs = []
        for f in (fx, fy):
            idx = np.nonzero(f)[0]
            if idx.size == 0 or not np.array_equal(
                    idx, np.arange(idx[0], idx[-1] + 1)):
                return None
            ivs.append((int(idx[0]), int(idx[-1] + 1)))
        return ivs

    @classmethod
    def try_build(cls, ex_c, basis_c, a, free_c_np, hier, device=None):
        """GridFDM for (ex_c, coarse basis, affine factors) or None."""
        Er = ex_c.E_real
        a = np.asarray(a)[:Er]
        scale = np.abs(a).max() + 1e-300
        if (np.abs(a - a[0]).max() > 1e-10 * scale
                or np.abs(a[0, 1]) > 1e-10 * scale):
            return None                      # non-uniform or sheared cells
        a0, a2 = float(a[0, 0]), float(a[0, 2])
        nm = np.asarray(ex_c.gather_hier[:Er])
        # back to lexicographic local order
        inv_hier = np.argsort(hier)
        nm = nm[:, inv_hier].reshape(Er, *basis_c.coeff_shape)
        p0, p1 = nm.shape[1] - 1, nm.shape[2] - 1
        # infer the tensor element numbering e = i * ny + j
        adj1 = (nm[:-1, 0, -1] == nm[1:, 0, 0])
        ny = int(np.argmin(adj1)) + 1 if not adj1.all() else Er
        if Er % ny:
            return None
        nx = Er // ny
        expect = np.ones(Er - 1, bool)
        expect[ny - 1::ny] = False
        if not np.array_equal(adj1, expect):
            return None
        if not np.array_equal(nm.reshape(nx, ny, p0 + 1, p1 + 1)
                              [:-1, :, -1, :],
                              nm.reshape(nx, ny, p0 + 1, p1 + 1)
                              [1:, :, 0, :]):
            return None
        # grid Dirichlet data must be per-side uniform (outer product)
        obj = cls.__new__(cls)
        obj.p0, obj.p1, obj.nx, obj.ny = p0, p1, nx, ny
        obj.Er, obj.Ec = Er, ex_c.E
        obj._lex_rows, obj._idx = inv_hier, {}
        fgrid = obj._to_grid(torch.as_tensor(np.ascontiguousarray(
            free_c_np.T.astype(np.float32)))).numpy() > 0.5
        ivs = cls._side_interval(fgrid)
        if ivs is None:
            return None
        (fx0, fx1), (fy0, fy1) = ivs
        # 1D eigenpairs on the free sub-blocks
        lamx, Sx = _eig_1d(basis_c, 0, nx, fx0, fx1)
        lamy, Sy = _eig_1d(basis_c, 1, ny, fy0, fy1)
        return cls(p0, p1, nx, ny, Sx, Sy, lamx, lamy, a0, a2,
                   fx0, fx1, fy0, fy1, Er, ex_c.E, inv_hier, hier,
                   resolve_device(device))


class GridFDM2DLattice:
    """Order-independent exact tensor-grid coarse solve (2D).

    :class:`GridFDM` infers the tensor element numbering ``e = i*ny + j``
    from adjacency, which any host partitioner (panel, Morton, RCM)
    destroys even though the mesh is still a perfect tensor grid.  This
    variant maps through the **global node lattice**: coordinates of the
    coarse nodes are sorted into per-axis value lists; if they fill a full
    lattice, each L-vector slot gets a grid position (``grid_of_slot``) and
    the solve is a scatter-set, two dense eigen-transform matmuls and a
    gather, with no element ordering assumed.  The transforms are float64
    masters cast to the vector's dtype per call.

    The scatter-set writes every copy of a shared node into one grid cell:
    copies of a consistent L-vector that are not bitwise equal leave which
    one wins unspecified (``index_put_``, as the reference's ``.at[].set``).
    """

    def __init__(self, grid_of_slot, dims, free_iv, Sx, Sy, lam, Er, E,
                 device):
        self.dims = dims
        (self.fx0, self.fx1), (self.fy0, self.fy1) = free_iv
        self.Er, self.E = Er, E
        dev = resolve_device(device)
        self._gos = torch.as_tensor(np.asarray(grid_of_slot, np.int64),
                                    device=dev)              # (Er, n_c)
        self.Sx = torch.as_tensor(np.asarray(Sx, np.float64), device=dev)
        self.Sy = torch.as_tensor(np.asarray(Sy, np.float64), device=dev)
        self._inv_lam = torch.as_tensor(1.0 / np.asarray(lam, np.float64),
                                        device=dev)

    def __call__(self, rc: torch.Tensor) -> torch.Tensor:
        N0, N1 = self.dims
        lead, dt = rc.shape[:-2], rc.dtype
        flat = torch.zeros(*lead, N0 * N1, dtype=dt, device=rc.device)
        flat[..., self._gos.reshape(-1)] = rc[..., :self.Er].transpose(
            -1, -2).reshape(*lead, -1)
        G = flat.reshape(*lead, N0, N1)
        Gf = G[..., self.fx0:self.fx1, self.fy0:self.fy1]
        Sx, Sy = self.Sx.to(dt), self.Sy.to(dt)
        t = (Sx.T @ Gf @ Sy) * self._inv_lam.to(dt)
        U = torch.zeros_like(G)
        U[..., self.fx0:self.fx1, self.fy0:self.fy1] = Sx @ t @ Sy.T
        out = U.reshape(*lead, -1)[..., self._gos].transpose(-1, -2)
        if self.E > self.Er:
            out = torch.nn.functional.pad(out, (0, self.E - self.Er))
        return out.contiguous()

    @classmethod
    def try_build(cls, ex_c, disc_c, basis_c, a, free_c_np, device=None):
        """Lattice coarse solve for (ex_c, coarse basis), or None.

        ``a``: (>=Er, 3) affine factors of the FINE level (coarse reuse);
        ``free_c_np``: (Ec, n_c) free mask in the coarse local order.
        """
        Er = ex_c.E_real
        a = np.asarray(a)[:Er]
        scale = np.abs(a).max() + 1e-300
        if (np.abs(a - a[0]).max() > 1e-10 * scale
                or np.abs(a[0, 1]) > 1e-10 * scale):
            return None                      # non-uniform or sheared
        a0, a2 = float(a[0, 0]), float(a[0, 2])
        p0 = basis_c.coeff_shape[0] - 1
        p1 = basis_c.coeff_shape[1] - 1

        gix = np.asarray(ex_c.gather_hier[:Er])          # (Er, n_c)
        used = np.unique(gix.reshape(-1))
        xy = np.asarray(disc_c.mesh.nodes)[:, used]      # (2, Nu)
        axes_vals, axis_idx = [], []
        span = np.abs(xy).max() + 1.0
        for d in range(2):
            v = np.round(xy[d] / span * 1e12)
            vals = np.unique(v)
            axes_vals.append(vals)
            axis_idx.append(np.searchsorted(vals, v))
        dims = tuple(len(v) for v in axes_vals)
        if int(np.prod(dims)) != used.size:
            return None                      # not a full lattice
        grid_flat_of_used = axis_idx[0] * dims[1] + axis_idx[1]
        if np.unique(grid_flat_of_used).size != used.size:
            return None
        lut = np.full(used.max() + 1, -1, dtype=np.int64)
        lut[used] = grid_flat_of_used
        grid_of_slot = lut[gix]
        if (grid_of_slot < 0).any():
            return None
        n_el = []
        for Nd, pc in zip(dims, (p0, p1)):
            if (Nd - 1) % pc:
                return None
            n_el.append((Nd - 1) // pc)

        # free mask must be an outer product of contiguous intervals
        fflat = np.zeros(int(np.prod(dims)), bool)
        fflat[grid_of_slot.reshape(-1)] = free_c_np[:Er].reshape(-1)
        fgrid = fflat.reshape(dims)
        ivs = GridFDM._side_interval(fgrid)
        if ivs is None:
            return None
        (lamx, Sx), (lamy, Sy) = (_eig_1d(basis_c, d, n_el[d], *ivs[d])
                                  for d in range(2))
        lam = a0 * lamx[:, None] + a2 * lamy[None, :]
        return cls(grid_of_slot, dims, ivs, Sx, Sy, lam, Er, ex_c.E, device)


class GridFDM3D:
    """Exact tensor-grid coarse solve for 3D box meshes.

    3D twin of :class:`GridFDM2DLattice`, mapped through the global node
    lattice: on a uniform box mesh the gather ids of the lexicographic (E,
    n_c) L-vectors form a coordinate lattice, so one host pass gives each
    slot its lattice position (``grid_of_slot``) and the device mapping is
    a scatter-set and a gather of size E n_c.  The separable solve is three
    per-axis eigen transforms each way over the free sub-box:

        u = (Sx (x) Sy (x) Sz) [ t / (a0 lx_i + a1 ly_j + a2 lz_k) ]

    each a (p, p)-batched product along one axis
    (:func:`..ops.sumfac.apply_axis`).  The transforms are float64 masters
    cast to the vector's dtype per call.  Acts on (Ec, n_c) L-vectors or
    (..., Ec, n_c) stacks.  Use :meth:`try_build` (None unless every
    precondition verifiably holds: uniform affine diagonal factors, zero
    cross factors, a full coordinate lattice, outer-product contiguous free
    intervals).  Copies of a shared node that are not bitwise equal leave
    which one the scatter-set keeps unspecified, as the reference's.
    """

    def __init__(self, grid_of_slot, dims, free_iv, S_axes, lam3, Er, E,
                 device):
        self.dims = dims
        (self.fx0, self.fx1), (self.fy0, self.fy1), (self.fz0, self.fz1) \
            = free_iv
        self.Er, self.E = Er, E
        dev = resolve_device(device)
        self._gos = torch.as_tensor(np.asarray(grid_of_slot, np.int64),
                                    device=dev)              # (Er, n_c)
        self.S = [torch.as_tensor(np.asarray(s, np.float64), device=dev)
                  for s in S_axes]
        self._inv_lam = torch.as_tensor(1.0 / np.asarray(lam3, np.float64),
                                        device=dev)

    def __call__(self, rc: torch.Tensor) -> torch.Tensor:
        from ..ops.sumfac import apply_axis

        lead, dt = rc.shape[:-2], rc.dtype
        flat = torch.zeros(*lead, int(np.prod(self.dims)), dtype=dt,
                           device=rc.device)
        flat[..., self._gos.reshape(-1)] = rc[..., :self.Er, :].reshape(
            *lead, -1)
        G = flat.reshape(*lead, *self.dims)
        box = (..., slice(self.fx0, self.fx1), slice(self.fy0, self.fy1),
               slice(self.fz0, self.fz1))
        S = [s.to(dt) for s in self.S]
        t = G[box]
        for axis in range(3):
            t = apply_axis(S[axis].T, t, axis)
        t = t * self._inv_lam.to(dt)
        for axis in range(3):
            t = apply_axis(S[axis], t, axis)
        U = torch.zeros_like(G)
        U[box] = t
        out = U.reshape(*lead, -1)[..., self._gos]         # (..., Er, n_c)
        if self.E > self.Er:
            out = torch.nn.functional.pad(out, (0, 0, 0, self.E - self.Er))
        return out

    @classmethod
    def try_build(cls, ex_c, disc_c, free_c_np, G_c=None, device=None):
        """GridFDM3D for the coarse level, or None if inadmissible.

        ``G_c``: optional precomputed ``disc_c.laplacian_factors(None)``;
        ``free_c_np``: (Ec, n_c) free mask in the coarse local order."""
        Er = ex_c.E_real
        basis_c = disc_c.basis
        W = np.asarray(basis_c.weight_grid()).reshape(-1)
        sumW = float(W.sum())
        if G_c is None:
            G_c = disc_c.laplacian_factors(None)
        Gf = np.asarray(G_c, np.float64).reshape(Er, 6, -1)
        scale = np.abs(Gf).max() + 1e-300
        a = np.empty(3)
        for k, c in enumerate((0, 3, 5)):
            ac = Gf[:, c, :].sum(axis=1) / sumW
            if (np.abs(Gf[:, c, :] - ac[:, None] * W[None, :]).max()
                    > 1e-10 * scale
                    or np.abs(ac - ac[0]).max() > 1e-10 * scale):
                return None                  # non-affine or non-uniform
            a[k] = ac[0]
        for c in (1, 2, 4):
            if np.abs(Gf[:, c, :]).max() > 1e-10 * scale:
                return None                  # sheared cells
        p1 = basis_c.coeff_shape[0]
        if any(s != p1 for s in basis_c.coeff_shape):
            return None
        pc = p1 - 1

        # coordinate lattice of the referenced coarse nodes
        gix = np.asarray(ex_c.gather_lex[:Er])              # (Er, n_c)
        used = np.unique(gix.reshape(-1))
        xyz = np.asarray(disc_c.mesh.nodes)[:, used]        # (3, Nu)
        axes_vals, axis_idx = [], []
        span = np.abs(xyz).max() + 1.0
        for d in range(3):
            v = np.round(xyz[d] / span * 1e12)
            vals = np.unique(v)
            axes_vals.append(vals)
            axis_idx.append(np.searchsorted(vals, v))
        dims = tuple(len(v) for v in axes_vals)
        if int(np.prod(dims)) != used.size:
            return None                      # not a full lattice
        grid_flat_of_used = (axis_idx[0] * dims[1] + axis_idx[1]) \
            * dims[2] + axis_idx[2]
        if np.unique(grid_flat_of_used).size != used.size:
            return None
        lut = np.full(used.max() + 1, -1, dtype=np.int64)
        lut[used] = grid_flat_of_used
        grid_of_slot = lut[gix]
        if (grid_of_slot < 0).any():
            return None
        # per-axis element counts must tile the lattice at order pc
        n_el = []
        for Nd in dims:
            if (Nd - 1) % pc:
                return None
            n_el.append((Nd - 1) // pc)

        # free mask must be an outer product of contiguous intervals
        fflat = np.zeros(int(np.prod(dims)), bool)
        fflat[grid_of_slot.reshape(-1)] = free_c_np[:Er].reshape(-1)
        fgrid = fflat.reshape(dims)
        fx = fgrid.any(axis=(1, 2))
        fy = fgrid.any(axis=(0, 2))
        fz = fgrid.any(axis=(0, 1))
        if not np.array_equal(
                fgrid, fx[:, None, None] & fy[None, :, None]
                & fz[None, None, :]):
            return None
        ivs = []
        for f in (fx, fy, fz):
            idx = np.nonzero(f)[0]
            if idx.size == 0 or not np.array_equal(
                    idx, np.arange(idx[0], idx[-1] + 1)):
                return None
            ivs.append((int(idx[0]), int(idx[-1] + 1)))

        # 1D eigenpairs on each free interval (axis 0's basis serves all
        # three: the coarse basis is isotropic, checked above)
        sub = basis_c.subbases[0]
        S_axes, lams = [], []
        for d in range(3):
            lam, S = _eig_assembled(sub.quad_wts, sub.D1, n_el[d], *ivs[d])
            lams.append(lam)
            S_axes.append(S)
        lam3 = (a[0] * lams[0][:, None, None]
                + a[1] * lams[1][None, :, None]
                + a[2] * lams[2][None, None, :])
        return cls(grid_of_slot, dims, ivs, S_axes, lam3, Er, ex_c.E,
                   device)


class PMGPreconditioner3D:
    """The symmetric two-level V-cycle ``M(r)`` of
    :func:`make_pmg_preconditioner_3d` on lexicographic (E, n_f)
    L-vectors or (..., E, n_f) stacks (the reference's ``jax.vmap(M)``:
    every operator, transfer and coarse solve takes the stack as it is).

    Introspection attributes, as the reference's closure carries them:
    ``_coarse_kind`` (``"fdm"``/``"chebyshev"``), ``_levels`` ((p_f,
    p_c)), ``_lmax_f``, ``_restrict``, ``_prolong``, ``_coarse``, ``_A_c``;
    and the port's ``_A_f``, ``_B_f`` and ``_S_f``.
    """

    def __init__(self, *, A_f, B_f, lmax_f, degree, alpha, C, coarse_kind,
                 restrict, prolong, A_c, levels):
        self._A_f, self._B_f, self._A_c = A_f, B_f, A_c
        self._lmax_f = lmax_f
        self._coarse, self._coarse_kind = C, coarse_kind
        self._restrict, self._prolong = restrict, prolong
        self._levels = levels
        self._S_f = chebyshev_smoother(A_f, B_f, lmax_f, lmax_f / alpha,
                                       degree)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        S_f, A_f = self._S_f, self._A_f
        with _true_f32():
            z = S_f(r)
            ec = self._coarse(self._restrict(r - A_f(z)))
            z = z + self._prolong(ec)
            return z + S_f(r - A_f(z))


@_staged_factory
def make_pmg_preconditioner_3d(disc, ex_f, A_f, free_global, diag_global,
                               *,
                               p_coarse: int = 2,
                               degree: int = 3,
                               alpha: float = 4.0,
                               coarse: str = "auto",
                               coarse_degree: int = 24,
                               coarse_interval: float = 100.0,
                               dtype=np.float64,
                               mm_precision: str | None = "float32",
                               lmax_iters: int = 30,
                               lmax_safety: float = 1.05,
                               device=None) -> PMGPreconditioner3D:
    """Two-level p-MG V-cycle on the 3D lexicographic (E, n) L-vectors.

    The reference's signature and defaults, with ``device`` last (the CUDA
    card unless given).  The coarse level is the shared-node
    order-``p_coarse`` mesh (:func:`..mesh.porder.mesh_with_order`)
    discretized directly (its own exact factors, the unit coefficient, as
    the reference's), with the general apply
    (:class:`..ops.sumfac.Laplacian3D`) on its own exchange; the transfers
    are one ``(E, n_f) @ (n_f, n_c)`` product each way; the smoother is
    Chebyshev-accelerated point Jacobi on ``A_f`` (the masked fine operator
    of the outer solve, in ``dtype``); the coarse solve is the exact
    :class:`GridFDM3D` on box meshes, else (or with
    ``coarse="chebyshev"``) a fixed-degree Chebyshev-Jacobi sweep.
    ``free_global``: the (n_nodes,) non-Dirichlet mask; ``diag_global``: the
    fine assembled operator diagonal.  The transfers and the grid solve run
    in true float32 (TF32 off) for ``mm_precision`` "float32" or None; any
    other tier raises (ROADMAP Queue 3).  An unknown ``coarse`` raises
    ``ValueError`` (the reference takes the Chebyshev sweep).
    """
    from ..basis import gll_basis_3d
    from ..core.discretization import Discretization
    from ..mesh.porder import mesh_with_order
    from ..ops import sumfac
    from ..ops.exchange import make_exchange
    from .cg import jacobi_preconditioner

    if disc.mesh.ndim != 3:
        raise ValueError("make_pmg_preconditioner_3d is 3D-only")
    if mm_precision not in ("float32", None):
        raise NotImplementedError(
            f"mm_precision={mm_precision!r}: the V-cycle's matmuls run in "
            "true float32 (TF32 off); a reduced tier is a pinned divergence "
            "(ROADMAP Queue 3)")
    if coarse not in ("auto", "fdm", "chebyshev"):
        raise ValueError(f"unknown coarse solve {coarse!r}")
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    basis_f = disc.basis
    mesh_c = mesh_with_order(disc.mesh, p_coarse)
    basis_c = gll_basis_3d(p_coarse)
    disc_c = Discretization(mesh_c, basis_c)
    ex_c = make_exchange(disc_c)
    Er, Ef, Ec = ex_f.E_real, ex_f.E, ex_c.E
    n_f, n_c = ex_f.n_loc, ex_c.n_loc

    G_c_np = disc_c.laplacian_factors(None)     # computed once, reused
    free_c_np = np.asarray(free_global, bool)[ex_c.gather_lex]
    free_c = torch.as_tensor(free_c_np, device=dev)
    lap_c = sumfac.make_laplacian_3d(ex_c, G_c_np, basis_c, dtype=dt,
                                     device=dev, structure="general")

    def A_c(uL):
        return torch.where(free_c, lap_c(torch.where(free_c, uL, 0.0)), 0.0)

    d_c = sumfac.laplacian_diag_local_host_3d(
        np.asarray(G_c_np),
        *[np.asarray(basis_c.subbases[d].D1) for d in range(3)])
    dg = np.zeros(disc.mesh.n_nodes)
    np.add.at(dg, np.asarray(ex_c.gather_lex[:Er]).ravel(),
              d_c.reshape(Er, -1).ravel())
    B_c = jacobi_preconditioner(on(dg[ex_c.gather_lex]), free_c)

    # transfers: the coarse basis at the fine GLL lattice, tensorized (lex)
    P = np.ones((1, 1))
    for d in range(3):
        P1 = np.asarray(basis_c.subbases[d](basis_f.subbases[d].nodes),
                        np.float64)
        P = np.kron(P, P1)                                # (n_f, n_c) lex
    P_d = on(P)
    P_t = P_d.T.contiguous()
    w_f = ex_f._weights_as(dt, dev)
    free_f = torch.as_tensor(
        np.asarray(free_global, bool)[ex_f.gather_lex], device=dev)

    def restrict(r):
        loc = (w_f * r)[..., :Er, :] @ P_d
        if Ec > Er:
            loc = torch.nn.functional.pad(loc, (0, 0, 0, Ec - Er))
        return torch.where(free_c, ex_c.dss(loc), 0.0)

    def prolong(ec):
        ef = ec[..., :Er, :] @ P_t
        if Ef > Er:
            ef = torch.nn.functional.pad(ef, (0, 0, 0, Ef - Er))
        return torch.where(free_f, ef, 0.0)

    B_f = jacobi_preconditioner(
        on(np.asarray(diag_global)[np.asarray(ex_f.gather_lex)]), free_f)
    with _true_f32():
        lmax_f = estimate_lmax(A_f, B_f, (Ef, n_f), dtype=np.dtype(dtype),
                               iters=lmax_iters, safety=lmax_safety,
                               device=dev)

    grid = None
    if coarse in ("auto", "fdm"):
        grid = GridFDM3D.try_build(ex_c, disc_c, free_c_np, G_c=G_c_np,
                                   device=dev)
        if grid is None and coarse == "fdm":
            raise ValueError(
                "coarse='fdm' needs a uniform box lattice with "
                "outer-product Dirichlet data")
    if grid is not None:
        C, coarse_kind = grid, "fdm"
    else:
        with _true_f32():
            lmax_c = estimate_lmax(A_c, B_c, (Ec, n_c),
                                   dtype=np.dtype(dtype), iters=lmax_iters,
                                   safety=lmax_safety, device=dev)
        C = chebyshev_smoother(A_c, B_c, lmax_c, lmax_c / coarse_interval,
                               coarse_degree)
        coarse_kind = "chebyshev"

    return PMGPreconditioner3D(
        A_f=A_f, B_f=B_f, lmax_f=lmax_f, degree=degree, alpha=alpha, C=C,
        coarse_kind=coarse_kind, restrict=restrict, prolong=prolong,
        A_c=A_c, levels=(int(basis_f.coeff_shape[0]) - 1, p_coarse))


# ---------------------------------------------------------------------------
# The preconditioner


class PMGPreconditioner:
    """The symmetric two-level V-cycle ``M(r)`` of
    :func:`make_pmg_preconditioner`, on (n_f, E) transposed L-vectors or
    (k, n_f, E) stacks.

    Introspection attributes, as the reference's closure carries them:
    ``_coarse_kind`` (``"fdm"``/``"chebyshev"``), ``_levels`` ((p_f,
    p_c)), ``_lmax_f``, ``_restrict``, ``_prolong``, ``_coarse``, ``_A_c``,
    ``_S_f`` (the single-RHS ones), ``_cycle_dtype``; and the port's
    ``_A_f`` (the V-cycle's own fine operator) and ``_ops``, the (n, E)
    operators of both levels (their ``_backend`` says which apply runs).
    """

    def __init__(self, *, A_f, A_c, B_f, B_c, lmax_f, degree, alpha, C,
                 coarse_kind, coarse_cheb, restrict, prolong, out_dtype,
                 cycle_dtype, levels, ops):
        self._A_f, self._A_c = A_f, A_c
        self._B_f, self._B_c = B_f, B_c
        self._lmax_f = lmax_f
        self._degree, self._alpha = degree, alpha
        self._coarse_kind = coarse_kind
        #: (lmax_c, coarse_interval, coarse_degree) of the Chebyshev coarse
        #: sweep, or None
        self._coarse_cheb = coarse_cheb
        self._coarse = C
        self._restrict, self._prolong = restrict, prolong
        self._out_dtype = torch_dtype(out_dtype)
        self._cycle_dtype = np.dtype(cycle_dtype)
        self._cyc = torch_dtype(cycle_dtype)
        self._levels = levels
        self._ops = ops
        self._S_f = chebyshev_smoother(A_f, B_f, lmax_f, lmax_f / alpha,
                                       degree)
        #: (fine smoother, fine operator, coarse solve) per stack size
        self._per_k = {None: (self._S_f, A_f, C)}

    def with_fine_operator(self, A_f) -> "PMGPreconditioner":
        """This V-cycle with ``A_f`` as its fine operator: the same masked
        fine operator in the cycle dtype, in another form (the sharded
        callers' per-shard applies).  The smoother is rebuilt on it with
        the same ``lmax`` estimate; the copy takes one RHS (``A_f`` has no
        ``.stacked`` form)."""
        M = copy.copy(self)
        M._A_f = A_f
        M._S_f = chebyshev_smoother(A_f, self._B_f, self._lmax_f,
                                    self._lmax_f / self._alpha, self._degree)
        M._per_k = {None: (M._S_f, A_f, self._coarse)}
        M._ops = dict(self._ops, fine=A_f)
        return M

    def _level(self, k):
        """The smoother, fine operator and coarse solve on k-stacks (one
        RHS for ``k=None``): the operators' ``.stacked(k)`` forms, built
        once per k."""
        lv = self._per_k.get(k)
        if lv is None:
            A_f = self._A_f.stacked(k)
            S_f = chebyshev_smoother(A_f, self._B_f, self._lmax_f,
                                     self._lmax_f / self._alpha,
                                     self._degree)
            C = self._coarse
            if self._coarse_cheb is not None:
                lmax_c, interval, deg = self._coarse_cheb
                C = chebyshev_smoother(self._A_c.stacked(k), self._B_c,
                                       lmax_c, lmax_c / interval, deg)
            lv = self._per_k[k] = (S_f, A_f, C)
        return lv

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.dim() not in (2, 3):
            raise ValueError(f"expected an (n, E) L-vector or a (k, n, E) "
                             f"stack, got shape {tuple(r.shape)}")
        S_f, A_f, C = self._level(None if r.dim() == 2 else int(r.shape[0]))
        with _true_f32():
            r = r.to(self._cyc)
            z = S_f(r)
            ec = C(self._restrict(r - A_f(z)))
            z = z + self._prolong(ec)
            z = z + S_f(r - A_f(z))
        return z.to(self._out_dtype)


def _ranked_coarse_operator(ex_c, Gc_np, Dhat_c, W_c, a, structure_c, tcyc,
                            cycle_backend, free_c, mesh):
    """The coarse level's masked operator on a process group's rank
    blocks: the sharded block kernel (:func:`..parallel.halo.
    make_sharded_fused_operator`; at n = 4 the p = 1 apply kernel per
    rank) for float32 affine levels unless ``cycle_backend="xla"``, else
    the halo operator in the cycle dtype (``"fused"`` then raises)."""
    from ..ops import sumfac
    from ..parallel import halo

    Ec = ex_c.E
    kernel = (structure_c == "affine" and tcyc == torch.float32
              and cycle_backend != "xla")
    if cycle_backend == "fused" and not kernel:
        raise ValueError("cycle_backend='fused' on a process-group mesh "
                         "needs a float32 affine coarse level")
    if kernel:
        Kcat_c = sumfac.make_affine_element_matrices(Dhat_c, W_c,
                                                     order=ex_c.hier)
        op = halo.make_sharded_fused_operator(
            ex_c, Kcat_c, _padded(np.asarray(a, np.float64), Ec), mesh,
            free_local=free_c, axis=mesh.axis)
        op._backend = "fused"
    else:
        op = halo.make_sharded_local_operator(
            ex_c, _padded(np.asarray(Gc_np), Ec), Dhat_c, mesh,
            free_local=free_c, axis=mesh.axis)
        op._backend = "xla"
    return op


def _padded(G: np.ndarray, E: int) -> np.ndarray:
    """Factor rows ``G`` with zero rows appended up to ``E`` (the inert
    pad elements of a padded exchange)."""
    if G.shape[0] >= E:
        return G
    return np.concatenate([G, np.zeros((E - G.shape[0],) + G.shape[1:],
                                       G.dtype)])


@_staged_factory
def make_pmg_preconditioner(disc, ex_f, Gf, A_f, free_global, diag_global,
                            *,
                            p_coarse: int | None = None,
                            smoother: str = "jacobi",
                            degree: int = 3,
                            alpha: float = 4.0,
                            coarse: str = "auto",
                            coarse_degree: int = 24,
                            coarse_interval: float = 100.0,
                            dtype=np.float32,
                            cycle_dtype=None,
                            coeff_fn=None,
                            reaction_fn=None,
                            coarse_pad_to=None,
                            cycle_backend: str = "auto",
                            mm_precision: str | None = "float32",
                            lmax_iters: int = 30,
                            lmax_safety: float = 1.05,
                            device=None) -> PMGPreconditioner:
    """Symmetric two-level p-MG V-cycle preconditioner on 'ne' L-vectors.

    The reference's signature and defaults, with ``device`` last (the CUDA
    card unless given).

    Parameters
    ----------
    disc : fine Discretization (2D, single geometry).
    ex_f : fine exchange (provides hier order, weights, dss_T).
    Gf : (E, 3, n_f) fine geometric factor fields.  Affine meshes get the
        fast coarse construction (per-element scales reused with order-p_c
        reference matrices) and the exact :class:`GridFDM` coarse solve
        where admissible; curved/variable-coefficient meshes get a
        rediscretized coarse level with the Chebyshev coarse sweep.
    A_f : the masked fine operator, kept for the reference's signature:
        the V-cycle builds its own fine apply in ``cycle_dtype``.
    free_global : (n_nodes,) bool, the global non-Dirichlet mask.
    diag_global : (n_nodes,) fine assembled operator diagonal.
    p_coarse : coarse polynomial order (must divide the fine order); None
        is 1 in 2D.
    smoother : "jacobi" (Chebyshev-accelerated point Jacobi) or "fdm"
        (Chebyshev-accelerated FDM additive Schwarz in the cycle dtype,
        :func:`.fdm.make_fdm_preconditioner` on the "ne" layout; the lmax
        estimate runs on its ``B_f A_f``).
    degree : Chebyshev smoothing degree (applies of A per half-sweep).
    alpha : smoothing targets ``[lmax/alpha, lmax]``.
    coarse : "fdm" forces the exact tensor-grid solve (ValueError if
        inadmissible), "chebyshev" the iterative sweep, "auto" tries fdm
        first (affine meshes without a reaction term only).
    coarse_degree / coarse_interval : Chebyshev coarse parameters (degree
        applies over ``[lmax_c/coarse_interval, lmax_c]``).
    dtype : dtype of the vectors ``M`` consumes/returns (the outer CG's).
    cycle_dtype : the V-cycle's arithmetic dtype (default float32, under
        a float64 outer solve too: ``M`` casts to it and back).
    coeff_fn : optional callable(x, y), the diffusivity of the
        rediscretized (curved) coarse operator; None = 1.  Ignored on the
        affine path (the affine scales carry it).
    reaction_fn : optional callable(x, y), the reaction k(x) of
        ``-div(c grad u) + k u``: adds the collocated coarse mass term to
        the coarse operator and its diagonal, and the fine term to the
        V-cycle's fine apply.
    coarse_pad_to : optional padded coarse element count.  Sharded
        callers pass the fine exchange's (shard-divisible) padded E: the
        coarse exchange is padded alike with inert elements (zero factors
        and dot weights, a pad-inert DSS), and the transfers act on the
        real elements and leave the pad columns zero.
    cycle_backend : the backend of the V-cycle's fine and coarse (n, E)
        operators (:func:`..ops.sumfac.make_local_laplacian_operator`):
        "auto" takes the apply kernels where the reference's rule admits
        them, "fused" requires them, "xla" takes the plain product.
    mm_precision : "float32" or None: the transfers and the grid solve run
        in true float32 (TF32 off); any other tier raises (ROADMAP Queue 3).
    lmax_iters / lmax_safety : power-iteration count and safety factor of
        :func:`estimate_lmax`.

    A rank's exchange (:class:`..parallel.sharding.RankExchange`) as
    ``ex_f``, on a process-group mesh, with ``coarse_pad_to`` the padded E
    (the port's addition): the V-cycle acts on the rank's (n_f, E / S)
    blocks on ``device``.  ``A_f`` is then its fine operator (masked, in
    the cycle dtype, on blocks); the transfers stay per element, the
    coarse DSS is the halo DSS (:func:`..parallel.halo.make_halo_dss_T`),
    the exact grid solve gathers the coarse vector, solves it whole on
    every rank and keeps the rank's block (the reference replicates it),
    and the Chebyshev coarse level runs the sharded block operator (at
    p_c = 1 the p = 1 apply kernel per rank; float64 or curved: the halo
    operator).  The FDM smoother and the reaction term are not sharded
    (``NotImplementedError``).
    """
    from ..basis import gll_basis_2d
    from ..core.discretization import Discretization
    from ..mesh.porder import mesh_with_order
    from ..ops import sumfac
    from ..ops.exchange import make_exchange
    from .cg import jacobi_preconditioner

    if disc.mesh.ndim == 3:
        # one entry for both dimensions, as the reference's: the 3D factory
        # rediscretizes the coarse level itself, so Gf and the 2D-only
        # options do not apply (the reference ignores the latter; the port
        # refuses them by name)
        if smoother != "jacobi":
            raise NotImplementedError("3D pmg smoother is jacobi-Chebyshev")
        if coeff_fn is not None or reaction_fn is not None:
            raise NotImplementedError(
                "3D pmg: coefficient/reaction coarse terms are not in the "
                "reference either")
        for name, value, default in (
                ("cycle_dtype", cycle_dtype, None),
                ("coarse_pad_to", coarse_pad_to, None),
                ("cycle_backend", cycle_backend, "auto")):
            if value != default:
                raise ValueError(f"3D pmg takes no {name} (the V-cycle runs "
                                 "in dtype on the PyTorch 3D operators)")
        return make_pmg_preconditioner_3d(
            disc, ex_f, A_f, free_global, diag_global,
            p_coarse=2 if p_coarse is None else p_coarse,
            degree=degree, alpha=alpha, coarse=coarse,
            coarse_degree=coarse_degree, coarse_interval=coarse_interval,
            dtype=dtype, mm_precision=mm_precision,
            lmax_iters=lmax_iters, lmax_safety=lmax_safety, device=device)
    if disc.mesh.ndim != 2:
        raise NotImplementedError("pmg supports 2D and 3D meshes")
    if smoother not in ("jacobi", "fdm"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if mm_precision not in ("float32", None):
        raise NotImplementedError(
            f"mm_precision={mm_precision!r}: the V-cycle's matmuls run in "
            "true float32 (TF32 off); a reduced tier is a pinned divergence "
            "(ROADMAP Queue 3)")
    if coarse not in ("auto", "fdm", "chebyshev"):
        raise ValueError(f"unknown coarse solve {coarse!r}")
    from ..parallel import comm, halo

    mesh = getattr(ex_f, "_mesh", None)
    ranked = comm.distributed(mesh)
    if ranked and (smoother != "jacobi" or reaction_fn is not None
                   or coarse_pad_to is None):
        raise NotImplementedError(
            "pmg on a process-group mesh: the Jacobi smoother, no reaction "
            "term, and coarse_pad_to (the sharded callers' padded E)")
    dev = resolve_device(device)
    if p_coarse is None:
        p_coarse = 1
    out_dtype = np.dtype(dtype)
    cyc = (np.dtype(cycle_dtype) if cycle_dtype is not None
           else np.dtype(np.float32))
    tcyc = torch_dtype(cyc)

    def on(a, dt=tcyc):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    def cols(a, dt=None):
        """A host (.., E) array's columns of this rank (all of them
        single-controller) on the device."""
        t = torch.as_tensor(np.ascontiguousarray(
            comm.block_of(mesh, a) if ranked else a), device=dev)
        return t if dt is None else t.to(dt)

    basis_f = disc.basis
    W_f = basis_f.weight_grid().reshape(-1)
    a, exact = sumfac.affine_factorization(np.asarray(Gf), W_f)

    # ---- coarse level ------------------------------------------------------
    mesh_c = mesh_with_order(disc.mesh, p_coarse)
    basis_c = gll_basis_2d(p_coarse)
    disc_c = Discretization(mesh_c, basis_c)
    ex_c = make_exchange(disc_c, pad_to=coarse_pad_to)
    if ex_c.E_real != ex_f.E_real:
        raise AssertionError("fine/coarse exchanges disagree on E_real")
    Er, Ef, Ec = ex_f.E_real, ex_f.E, ex_c.E
    n_f, n_c = ex_f.n_loc, ex_c.n_loc

    W_c = basis_c.weight_grid().reshape(-1)
    Dhat_c = sumfac.make_stacked_derivative(
        np.asarray(basis_c.get_D1_matrix(0)),
        np.asarray(basis_c.get_D1_matrix(1)))
    free_c_np = np.asarray(free_global, bool)[ex_c.gather_hier]
    free_c = cols(free_c_np.T)

    # coarse reaction mass (Helmholtz shift), collocated: k * detJxW_c
    kM_c_np = None
    if reaction_fn is not None:
        xc = [disc_c.x_coeffs[:, d] for d in range(2)]
        kM_c_np = np.zeros((Ec, n_c))
        kM_c_np[:Er] = (np.broadcast_to(
            np.asarray(reaction_fn(*xc)), disc_c.detJxW.shape)
            * disc_c.detJxW).reshape(Er, -1)[:, ex_c.hier]

    if exact:
        # affine: coarse factors are the per-element scales times the
        # order-p_c weight grid, no coarse geometry recompute
        Gc_np = (a[:Er, :, None] * W_c[None, None, :]).astype(cyc)
        structure_c = "affine"
        Kcat_c = sumfac.make_affine_element_matrices(Dhat_c, W_c,
                                                     order=ex_c.hier)
        dblk = np.stack([np.diag(Kcat_c[:, i * n_c:(i + 1) * n_c])
                         for i in range(3)])                   # (3, n_c)
        d_loc = a[:Er] @ dblk                                  # (Er, n_c)
    else:
        # curved / variable-coefficient: rediscretize on the coarse mesh
        xc = [disc_c.x_coeffs[:, d] for d in range(2)]
        coeff_c = None
        if coeff_fn is not None:
            coeff_c = np.broadcast_to(
                np.asarray(coeff_fn(*xc)), disc_c.detJxW.shape)
        Gc_np = np.asarray(
            disc_c.laplacian_factors(coeff_c), cyc).reshape(Er, 3, -1)
        structure_c = "general"
        d_loc = sumfac.laplacian_diag_local_host(
            Gc_np.reshape(Er, 3, *disc_c.shape),
            np.asarray(basis_c.get_D1_matrix(0)),
            np.asarray(basis_c.get_D1_matrix(1))
        ).reshape(Er, -1)[:, ex_c.hier]

    if ranked:
        lap_c = _ranked_coarse_operator(
            ex_c, Gc_np, Dhat_c, W_c, a, structure_c, tcyc, cycle_backend,
            free_c, mesh)
    else:
        lap_c = sumfac.make_local_laplacian_operator(
            ex_c, _padded(Gc_np, Ec), Dhat_c, free_c, structure=structure_c,
            backend=cycle_backend, vector_layout="ne",
            assume_masked_input=True, device=dev)
    A_c = (lap_c if kM_c_np is None else sumfac.LocalHelmholtzOperator(
        lap_c, ex_c.dss_T, on(kM_c_np.T), free_c))

    if reaction_fn is not None:
        d_loc = d_loc + np.asarray(kM_c_np[:Er])
    d_glob = np.zeros(disc.mesh.n_nodes)
    np.add.at(d_glob, np.asarray(ex_c.gather_hier[:Er]), d_loc)
    B_c = jacobi_preconditioner(cols(d_glob[ex_c.gather_hier].T, tcyc),
                                free_c)

    # ---- transfers -----------------------------------------------------------
    P = np.ones((1, 1))
    for d in range(2):
        P1 = np.asarray(basis_c.get_subbasis(d)(
            basis_f.get_subbasis(d).nodes), np.float64)
        P = np.kron(P, P1)                                    # lex x lex
    P = P[np.ix_(np.asarray(ex_f.hier), np.asarray(ex_c.hier))]
    P_d = on(P)                                               # (n_f, n_c)
    P_t = P_d.T.contiguous()
    free_f_np = np.asarray(free_global, bool)[ex_f.gather_hier]
    free_f = cols(free_f_np.T)
    if ranked:
        # the rank's block: the pad columns (the last ranks') zeroed where
        # the single-controller cycle cuts and pads them
        w_f = cols(np.asarray(ex_f.weights).T, tcyc)
        real = cols(np.arange(Ef) < Er)
        dss_c = halo.make_halo_dss_T(ex_c, mesh.axis, mesh)
        masks_c = cols(halo.stack_class_masks(ex_c))
        free_fr = free_f & real

        def restrict(r):
            loc = torch.where(real, P_t @ (w_f * r), 0.0)
            return torch.where(free_c, dss_c(loc, masks_c), 0.0)

        def prolong(ec):
            return torch.where(free_fr, P_d @ ec, 0.0)
    else:
        w_f = ex_f._weights_as(cyc, dev, transposed=True)

        def restrict(r):
            loc = P_t @ (w_f * r)[..., :Er]
            if Ec > Er:
                loc = torch.nn.functional.pad(loc, (0, Ec - Er))
            return torch.where(free_c, ex_c.dss_T(loc), 0.0)

        def prolong(ec):
            ef = P_d @ ec[..., :Er]
            if Ef > Er:
                ef = torch.nn.functional.pad(ef, (0, Ef - Er))
            return torch.where(free_f, ef, 0.0)

    # ---- internal fine apply (cycle dtype) -----------------------------------
    if ranked:
        lap_f_cyc = A_f
    else:
        lap_f_cyc = sumfac.make_local_laplacian_operator(
            ex_f, _padded(np.asarray(Gf, dtype=cyc), Ef),
            sumfac.make_stacked_derivative(
                np.asarray(basis_f.get_D1_matrix(0)),
                np.asarray(basis_f.get_D1_matrix(1))),
            free_f, structure="auto", backend=cycle_backend,
            vector_layout="ne", assume_masked_input=True, device=dev)
    if reaction_fn is None:
        A_f_cyc = lap_f_cyc
    else:
        xf = [disc.x_coeffs[:, d] for d in range(2)]
        kM_f_np = np.zeros((Ef, n_f))
        kM_f_np[:Er] = (np.broadcast_to(
            np.asarray(reaction_fn(*xf)), disc.detJxW.shape)
            * disc.detJxW).reshape(Er, -1)[:, ex_f.hier]
        A_f_cyc = sumfac.LocalHelmholtzOperator(
            lap_f_cyc, ex_f.dss_T, on(kM_f_np.T), free_f)

    # ---- smoother ------------------------------------------------------------
    if smoother == "fdm":
        from .fdm import make_fdm_preconditioner

        B_f = make_fdm_preconditioner(ex_f, np.asarray(Gf), basis_f, free_f,
                                      dtype=cyc, vector_layout="ne",
                                      device=dev)
    else:
        B_f = jacobi_preconditioner(
            cols(np.asarray(diag_global)[ex_f.gather_hier].T, tcyc), free_f)
    with _true_f32():
        lmax_f = estimate_lmax(A_f_cyc, B_f, (n_f, Ef), dtype=cyc,
                               iters=lmax_iters, safety=lmax_safety,
                               device=dev, mesh=mesh)

    # ---- coarse solve ----------------------------------------------------------
    grid = None
    if coarse in ("auto", "fdm") and exact and reaction_fn is None:
        grid = GridFDM.try_build(ex_c, basis_c, a, free_c_np, ex_c.hier,
                                 device=dev)
        if grid is None:
            # partitioned element orders (panel/Morton/RCM) break the
            # tensor-numbering inference but not the node lattice
            grid = GridFDM2DLattice.try_build(ex_c, disc_c, basis_c, a,
                                              free_c_np, device=dev)
    if grid is None and coarse == "fdm":
        raise ValueError(
            "coarse='fdm' needs a uniform affine tensor-product mesh "
            "with per-side-uniform Dirichlet data and no reaction term")
    coarse_cheb = None
    if grid is not None:
        C, coarse_kind = grid, "fdm"
        if ranked:
            def C(rc):
                # the reference replicates the coarse solve: every rank
                # solves the gathered vector and keeps its block
                return comm.block_of(mesh, grid(comm.gather_blocks(
                    mesh, rc))).contiguous()
    else:
        with _true_f32():
            lmax_c = estimate_lmax(A_c, B_c, (n_c, Ec), dtype=cyc,
                                   iters=lmax_iters, safety=lmax_safety,
                                   device=dev, mesh=mesh)
        C = chebyshev_smoother(A_c, B_c, lmax_c, lmax_c / coarse_interval,
                               coarse_degree)
        coarse_kind = "chebyshev"
        coarse_cheb = (lmax_c, coarse_interval, coarse_degree)

    return PMGPreconditioner(
        A_f=A_f_cyc, A_c=A_c, B_f=B_f, B_c=B_c, lmax_f=lmax_f,
        degree=degree, alpha=alpha, C=C, coarse_kind=coarse_kind,
        coarse_cheb=coarse_cheb, restrict=restrict, prolong=prolong,
        out_dtype=out_dtype, cycle_dtype=cyc,
        levels=(int(np.asarray(basis_f.coeff_shape)[0] - 1), p_coarse),
        ops={"fine": lap_f_cyc, "coarse": lap_c})
