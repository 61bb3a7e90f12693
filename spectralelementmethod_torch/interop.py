"""Build the port's operator state from arrays of another implementation.

:func:`operator_from_numpy` takes the operator state of an affine 2D
L-vector solve as plain numpy arrays — the assembled stiffness blocks, the
affine scales, the roll classes with their masks, the local-to-global map,
the dot weights, the operator diagonal and the free mask — and builds the
port's operator, exchange plan and CG operands from them;
:func:`general_operator_from_numpy` does the same for a curved mesh from
its full geometric-factor slabs, the stacked derivative and the local node
order; :func:`helmholtz_operator_from_numpy` builds the L-vector Helmholtz
operator (either layout, either exchange form) from the factors, the
mass-weighted reaction and the exchange tables;
:func:`sharded_fused_operator_from_numpy` builds the element-sharded fused
operator (and with it each shard's block inputs) from the stiffness
blocks, the affine scales, the stacked class masks and the class tables;
:func:`operator_3d_from_numpy` builds the 3D box operator (separable,
affine or general) and its plane-roll exchange from the packed factors or
the affine scales, the derivative matrices and 1D weights, the
lexicographic gather map and the plane-roll offsets and masks;
:func:`squirmer_state_from_numpy` copies a squirmer's Newton state —
solution, physical parameters, free mask, Neumann integrals — into the
port's model.
Fed the JAX package's arrays, both packages then compute the same
function on the same data, independently of the port's own (copied) host
setup; that is how the tests hold each kernel's plain version against its
TPU counterpart.  :meth:`InteropOperator.fused_kernels` builds the
deferred and batched kernels from that state, and ``A.stacked(k)`` is the
k-RHS apply.

Arrays padded with inert elements (zero factors or affine scales, false
masks, zero weights, as the reference pads for its TPU lane tiling) are
accepted as they are; general factors of the real elements only are
zero-padded to the tables' element count.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import resolve_device, torch_dtype
from .models.helmholtz import LocalHelmholtzOperator
from .models.poisson import fused_cg_operands
from .ops.exchange import BoxRollExchange3D, DSSPlan, gather_dss, roll_dss_T
from .ops.sumfac import (AffineLaplacianT, GeneralLaplacianT, Laplacian3D,
                         LaplacianEN, LaplacianT, assembled_1d_stiffness)
from .parallel.halo import make_sharded_fused_operator
from .solver.cg import jacobi_preconditioner


class InteropOperator(NamedTuple):
    plan: DSSPlan               # roll-class tables on the device
    A: LaplacianT               # masked operator (assumes masked input)
    A_raw: LaplacianT           # unmasked operator (residual seeds)
    M: Callable                 # Jacobi preconditioner
    w: torch.Tensor             # (n, E) dot weights
    free: torch.Tensor          # (n, E) bool free mask
    inv: torch.Tensor           # (n, E) fused-CG masked inverse diagonal
    w_free: torch.Tensor        # (n, E) fused-CG weights, 0 on Dirichlet
    kA: Callable                # fused CG kernel A bound to this operator
    kB: Callable                # fused CG kernel B
    to_local: Callable          # (n_nodes,) numpy -> (n, E) tensor
    E_real: int                 # elements before padding

    def dot_T(self, uT: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
        prod = uT * vT
        return torch.sum(prod * self.w.to(prod.dtype))

    def fused_kernels(self, n_rhs: int = 1, defer_x: bool = False):
        """``(kA, kB)`` bound to this operator: single-RHS for
        ``n_rhs == 1``, else for (n_rhs n, E) stacks; ``defer_x`` drops
        kernel A's x (affine operators only)."""
        return self.A.fused_cg_kernels(None if n_rhs == 1 else n_rhs,
                                       defer_x=defer_x)


def _interop(A_raw: LaplacianT, gather_hier, weights, diag, free,
             E_real: int, p_dtype, dt) -> InteropOperator:
    """The CG operands around the unmasked operator ``A_raw``."""
    plan, dev = A_raw.plan, A_raw.plan.device
    freeT = np.ascontiguousarray(np.asarray(free, bool)[gather_hier].T)
    free_t = torch.as_tensor(freeT, device=dev)
    A = A_raw.masked(free_t, assume_masked_input=True)
    gih = torch.as_tensor(gather_hier, device=dev)

    def to_local(u_global):
        u = torch.as_tensor(np.asarray(u_global), device=dev).to(dt)
        return u[gih].T.contiguous()

    diag = np.asarray(diag)
    M = jacobi_preconditioner(to_local(diag), free_t)
    wT = np.ascontiguousarray(np.asarray(weights).T)
    inv, w_free = fused_cg_operands(diag[gather_hier].T, freeT, wT, p_dtype,
                                    dev)
    kA, kB = A.fused_cg_kernels()
    return InteropOperator(plan, A, A_raw, M, torch.as_tensor(wT, device=dev)
                           .to(dt), free_t, inv, w_free, kA, kB, to_local,
                           int(E_real))


def operator_from_numpy(Kcat, a, edge_classes, vert_classes, gather_hier,
                        weights, diag, free, E_real: int, *,
                        device=None, dtype=np.float32, p_dtype=None,
                        edge_len=None) -> InteropOperator:
    """The port's operator state from numpy arrays (affine mesh).

    ``Kcat`` (n, 3n): [K0 | K1 | K2] in the L-vector node order; ``a``
    (E, 3): affine scales; ``edge_classes`` / ``vert_classes``: roll-class
    lists ``(dst_slot, src_slot, delta, flip, mask)`` /
    ``(dst_slot, src_slot, delta, mask)`` with (E,) bool masks;
    ``gather_hier`` (E, n): global node of each local node; ``weights``
    (E, n): inverse-multiplicity dot weights (0 on pad elements); ``diag``
    (n_nodes,): the assembled operator diagonal; ``free`` (n_nodes,): True
    off Dirichlet nodes; ``E_real``: elements before padding.  The slot
    geometry is the edges-first layout; ``edge_len`` gives the four edge
    slot lengths when the node grid is not square.  ``dtype`` is the
    operator's (float32 for the CUDA kernels); ``p_dtype`` the fused-CG
    direction storage (None or ``torch.bfloat16``).
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gather_hier = np.asarray(gather_hier)
    E, n = gather_hier.shape
    plan = DSSPlan.from_classes(n, E, edge_classes, vert_classes, dev,
                                edge_len=edge_len)
    return _interop(AffineLaplacianT(Kcat, a, plan, None, dtype=dt),
                    gather_hier, weights, diag, free, E_real, p_dtype, dt)


def general_operator_from_numpy(Gf, Dhat, hier, edge_classes, vert_classes,
                                gather_hier, weights, diag, free,
                                E_real: int, *, device=None,
                                dtype=np.float32, p_dtype=None,
                                edge_len=None) -> InteropOperator:
    """The port's operator state from numpy arrays (curved mesh).

    ``Gf`` (E, 3, n): the lex-ordered geometric factors (the JAX package's
    padded array as it is, or E_real rows, zero-padded here); ``Dhat``
    (2n, n): the stacked derivative in lex order; ``hier`` (n,): the local
    node order (L-vector row -> lex node); the rest as in
    :func:`operator_from_numpy`.
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gather_hier = np.asarray(gather_hier)
    E, n = gather_hier.shape
    Gf = np.asarray(Gf)
    if Gf.shape[0] < E:
        Gf = np.concatenate([Gf, np.zeros((E - Gf.shape[0],) + Gf.shape[1:],
                                          Gf.dtype)])
    plan = DSSPlan.from_classes(n, E, edge_classes, vert_classes, dev,
                                edge_len=edge_len)
    return _interop(GeneralLaplacianT(Gf, Dhat, hier, plan, None, dtype=dt),
                    gather_hier, weights, diag, free, E_real, p_dtype, dt)


class HelmholtzInterop(NamedTuple):
    A: LocalHelmholtzOperator   # masked operator; A._raw unmasked
    M: Callable                 # Jacobi preconditioner
    w: torch.Tensor             # dot weights in the layout
    free: torch.Tensor          # free mask in the layout
    dss: Callable               # the exchange's DSS in the layout
    to_local: Callable          # (n_nodes,) numpy -> L-vector tensor


def helmholtz_operator_from_numpy(Gf, Dhat, hier, kM, gather_hier, weights,
                                  diag, free, *, vector_layout: str = "en",
                                  backend: str = "xla", edge_classes=None,
                                  vert_classes=None, edge_recv_flat=None,
                                  edge_recv_mask=None, vert_gid=None,
                                  edge_len=None, device=None,
                                  dtype=np.float64) -> HelmholtzInterop:
    """The port's L-vector Helmholtz operator from numpy arrays:
    ``A u = mask(lap(u) + dss(kM u))`` with the general (full-factor)
    Laplacian.

    ``Gf`` (E_real or E, 3, n): lex-ordered geometric factors (with the
    diffusivity folded in; zero-padded to E here); ``Dhat`` (2n, n): the
    stacked derivative in lex order; ``hier`` (n,): the local node order;
    ``kM`` (E, n): the mass-weighted reaction in the L-vector order;
    ``gather_hier``, ``weights``, ``diag``, ``free`` as in
    :func:`operator_from_numpy`.  The exchange is either the roll classes
    (``edge_classes``, ``vert_classes``, with ``edge_len`` for a
    non-square grid) or the generic gather tables (``edge_recv_flat``
    (E * neb,), ``edge_recv_mask`` (E, neb) and ``vert_gid`` (E * 4,),
    the edges-first layout).  ``vector_layout``: ``"en"`` (row-major
    (E, n), :class:`.ops.sumfac.LaplacianEN` with ``backend`` ``"xla"`` or
    ``"pallas"``) or ``"ne"`` (transposed, the
    :class:`.ops.sumfac.GeneralLaplacianT`; roll classes only).
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gather_hier = np.asarray(gather_hier)
    E, n = gather_hier.shape
    Gf = np.asarray(Gf, dtype=dtype)
    if Gf.shape[0] < E:
        Gf = np.concatenate([Gf, np.zeros((E - Gf.shape[0],) + Gf.shape[1:],
                                          Gf.dtype)])
    transposed = vector_layout == "ne"
    if vector_layout not in ("en", "ne"):
        raise ValueError(f"unknown vector_layout {vector_layout!r}")
    if edge_classes is not None:
        plan = DSSPlan.from_classes(n, E, edge_classes, vert_classes, dev,
                                    edge_len=edge_len)

        def dss_en(vL):
            return roll_dss_T(vL.transpose(-1, -2), plan).transpose(-1, -2)
    else:
        plan = None
        tabs = [torch.as_tensor(np.array(a), device=dev)
                for a in (edge_recv_flat, edge_recv_mask, vert_gid)]
        neb = tabs[1].shape[1]
        n_vertices = int(tabs[2].max()) + 1

        def dss_en(vL):
            return gather_dss(vL, *tabs, n_vertices, 0, neb)

    def layout(a):
        a = torch.as_tensor(np.ascontiguousarray(a), device=dev)
        return a.T.contiguous() if transposed else a

    if transposed:
        if plan is None:
            raise NotImplementedError("the 'ne' operator takes roll classes")
        lap = GeneralLaplacianT(Gf, Dhat, hier, plan, None, dtype=dt)

        def dss(vT):
            return roll_dss_T(vT, plan)
    else:
        lap = LaplacianEN(Gf, Dhat, hier, dss_en, backend=backend, dtype=dt,
                          device=dev)
        dss = dss_en
    free_L = layout(np.asarray(free, bool)[gather_hier])
    A = LocalHelmholtzOperator(lap, dss, layout(np.asarray(kM)).to(dt),
                               free_L)
    gih = torch.as_tensor(gather_hier, device=dev)

    def to_local(u_global):
        u = torch.as_tensor(np.array(u_global), device=dev).to(dt)[gih]
        return (u.T if transposed else u).contiguous()

    M = jacobi_preconditioner(to_local(np.asarray(diag)), free_L)
    return HelmholtzInterop(A, M, layout(np.asarray(weights)).to(dt), free_L,
                            dss, to_local)


class _RollTables:
    """Exchange-shaped holder of roll-class tables (edges-first layout,
    no tails), as :mod:`.parallel.halo` reads an exchange."""

    n_edge_tail = n_vert_tail = 0
    off_edge = 0

    def __init__(self, n: int, E: int, edge_classes, vert_classes,
                 edge_len=None):
        m = int(round(np.sqrt(n)))
        self.n_loc, self.E = int(n), int(E)
        self.edge_len = tuple(int(v) for v in (
            (m - 2,) * 4 if edge_len is None else edge_len))
        self.edge_off = tuple(int(o) for o in np.concatenate(
            [[0], np.cumsum(self.edge_len[:-1])]))
        self.ne = self.edge_len[0] if len(set(self.edge_len)) == 1 else None
        self.n_edge_block = sum(self.edge_len)
        self.off_vert = self.n_edge_block
        self.off_int = self.off_vert + 4
        self.edge_classes, self.vert_classes = edge_classes, vert_classes
        self._plans = {}

    def plan(self, device) -> DSSPlan:
        key = str(device)
        if key not in self._plans:
            self._plans[key] = DSSPlan.from_classes(
                self.n_loc, self.E, self.edge_classes, self.vert_classes,
                device, edge_len=self.edge_len)
        return self._plans[key]


def sharded_fused_operator_from_numpy(Kcat, a, class_masks, edge_classes,
                                      vert_classes, mesh, *, edge_len=None,
                                      free_local=None):
    """The port's element-sharded fused operator
    (:func:`.parallel.halo.make_sharded_fused_operator`) from numpy arrays.

    ``Kcat`` (n, 3n): [K0 | K1 | K2] in the L-vector node order; ``a``
    (E, 3): affine scales of the (padded) elements; ``class_masks`` (C, E)
    bool: the class masks stacked edge classes first, then vertex classes
    (the reference's ``stack_class_masks``); ``edge_classes`` /
    ``vert_classes``: ``(dst_slot, src_slot, delta, flip)`` /
    ``(dst_slot, src_slot, delta)`` in the same order; ``mesh``: a
    :func:`.parallel.sharding.device_mesh`.  The operator's
    ``_block_operands`` are ``(Kst, aT stack (S, 3, E_ext), mask stack
    (S, C, E_ext), factors)`` (the :class:`.ops.kernels.AffineFactors` of
    ``Kst``, or None on the CPU), ``_extended(blocks, s)`` builds shard
    ``s``'s extended input and ``_block_plan`` is the block's class
    tables: each shard's block kernel can be called on its own.
    """
    masks = np.asarray(class_masks, dtype=bool)
    ne = len(edge_classes)
    ecl = [(int(d), int(s_), int(dl), bool(f), masks[i])
           for i, (d, s_, dl, f) in enumerate(edge_classes)]
    vcl = [(int(d), int(s_), int(dl), masks[ne + j])
           for j, (d, s_, dl) in enumerate(vert_classes)]
    tables = _RollTables(np.asarray(Kcat).shape[0], masks.shape[1], ecl, vcl,
                         edge_len)
    return make_sharded_fused_operator(tables, Kcat, a, mesh,
                                       free_local=free_local)


class Interop3D(NamedTuple):
    exchange: BoxRollExchange3D  # plane-roll DSS from the given tables
    A_raw: Laplacian3D           # unmasked 3D operator (residual seeds)
    A: Laplacian3D               # output-masked (unmasked if free is None)
    M: Callable | None           # Jacobi preconditioner (diag given)
    to_local: Callable           # (n_nodes,) numpy -> (E, n) tensor


def operator_3d_from_numpy(structure: str, D, w, gather_lex, deltas,
                           mask_lo, mask_hi, n_nodes: int, *, G=None,
                           a=None, diag=None, free=None, E_real=None,
                           device=None, dtype=np.float64) -> Interop3D:
    """The port's 3D operator and exchange from numpy arrays (a hexahedral
    box mesh in lexicographic (E, n) L-vector storage).

    ``structure``: ``"separable"`` (reads ``a``, ``D`` and ``w``: the 1D
    stiffness matrices are assembled here, :func:`.ops.sumfac.
    assembled_1d_stiffness`), ``"affine"`` (``a``, ``w`` and ``D``) or
    ``"general"`` (``G``, (E, 6, p0, p1, p2) packed factors, and ``D``);
    ``a`` (E, 6): the affine scales; ``D``: the three derivative matrices;
    ``w``: the three 1D weight vectors; ``gather_lex`` (E, n): the global
    node of each local node; ``deltas``, ``mask_lo``, ``mask_hi`` ((3, E)
    bool): the plane-roll offsets and neighbour masks; ``n_nodes``: the
    global node count; ``diag`` (n_nodes,): the assembled operator
    diagonal (for ``M``); ``free`` (n_nodes,): True off Dirichlet nodes;
    ``E_real``: elements before padding.  Factor or scale rows past the
    given ones (padding) are zero.
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gather_lex = np.asarray(gather_lex)
    E = gather_lex.shape[0]
    D = [np.asarray(Dd, np.float64) for Dd in D]
    w = [np.asarray(wd, np.float64).reshape(-1) for wd in w]
    shape = tuple(len(wd) for wd in w)
    ex = BoxRollExchange3D.from_tables(gather_lex, n_nodes, shape, deltas,
                                       mask_lo, mask_hi, E_real)

    def on(x):
        return torch.as_tensor(np.array(x), device=dev).to(dt)

    def padded(x):
        x = np.asarray(x)
        out = np.zeros((E,) + x.shape[1:], x.dtype)
        out[:x.shape[0]] = x
        return out

    kw = dict(D=[on(Dd) for Dd in D])
    if structure == "general":
        kw["G"] = on(padded(np.asarray(G).reshape((-1, 6) + shape)))
    else:
        kw["a"] = on(padded(a))
        kw["W3"] = on(w[0][:, None, None] * w[1][None, :, None]
                      * w[2][None, None, :])
        kw["K"] = [on(assembled_1d_stiffness(Dd, wd))
                   for Dd, wd in zip(D, w)]
        kw["wd"] = [on(wd) for wd in w]
    A_raw = Laplacian3D(ex, structure, shape, **kw)
    free_t = (None if free is None else torch.as_tensor(
        np.asarray(free, bool)[gather_lex], device=dev))
    gil = torch.as_tensor(gather_lex, device=dev)

    def to_local(u_global):
        return torch.as_tensor(np.asarray(u_global), device=dev).to(dt)[gil]

    M = (None if diag is None
         else jacobi_preconditioner(to_local(diag), free_t))
    return Interop3D(ex, A_raw, A_raw.masked(free_t), M, to_local)


def squirmer_state_from_numpy(port, soln_vec, phys_params, dof_free,
                              cint) -> None:
    """Copy a squirmer's Newton state into the port's ``Squirmer`` or
    ``FixedSphere`` ``port`` (built on the same mesh and order): the
    interleaved solution vector (n_nodes * 2,), the physical parameters
    (speed, N_Re, beta and the slip profile, a numpy function), the
    (n_nodes, 2) free-DOF mask and the condensed Neumann integrals
    (n_ext_dofs,).  Both packages then start a Newton solve from the same
    state.  Raises ``ValueError`` on a shape that does not fit ``port``.
    """
    soln_vec = np.asarray(soln_vec, dtype=np.float64).reshape(-1)
    dof_free = np.asarray(dof_free, dtype=bool)
    cint = np.asarray(cint, dtype=np.float64)
    for name, got, want in (("soln_vec", soln_vec.shape,
                             (port.soln_vec.size,)),
                            ("dof_free", dof_free.shape,
                             port.dof_free.shape),
                            ("cint", cint.shape, port.cint.shape)):
        if got != want:
            raise ValueError(f"{name} of shape {got}; the port's model "
                             f"has {want}")
    port.soln_vec = soln_vec
    port.phys_params = dict(phys_params)
    port.dof_free[:] = dof_free
    port.cint[:] = cint
    port._sync_free_ext()
