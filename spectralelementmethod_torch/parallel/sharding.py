"""Element-axis sharding of the L-vector Poisson solve (PyTorch port).

Port of the JAX package's ``parallel/sharding.py`` for the element-sharded
L-vector path, :func:`sharded_local_poisson_problem` (the reference's
production multi-chip path).  The reference shards over a
``jax.sharding.Mesh``; the port's :func:`device_mesh` is single-controller
on one device: ``size`` shards, each a contiguous column block of the
(n, E) L-vectors, and :mod:`.halo` moves the boundary strips between them
as explicit copies.  Shards on several cards (``torch.distributed``),
``hybrid_device_mesh`` (multi-slice TPU fleets) and the replicated-vector
``sharded_poisson_problem`` are not ported (ROADMAP Queue 1).  The 3D
:func:`sharded_local_poisson_problem_3d` shards the lexicographic (E, n)
L-vectors of a box mesh the same way, in element blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops import sumfac
from .halo import ELEM_AXIS


class DeviceMesh(NamedTuple):
    """A 1D mesh of ``size`` element shards on one ``device``."""

    size: int
    device: torch.device
    axis: str = ELEM_AXIS


def device_mesh(n_devices: int | None = None, axis: str = ELEM_AXIS,
                device=None) -> DeviceMesh:
    """1D mesh of ``n_devices`` element shards, all on ``device`` (the CUDA
    card unless given; ``"cpu"`` runs the plain versions of the kernels).

    ``None`` is one shard per visible card of the device's type (1 on the
    CPU).  The shards are simulated on the one device: the halo exchange is
    a copy of each shard's boundary strips.
    """
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if int(n_devices) < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return DeviceMesh(int(n_devices), dev, axis)


def pad_elements(E: int, n_shards: int) -> int:
    """Padded element count (multiple of n_shards)."""
    return ((E + n_shards - 1) // n_shards) * n_shards


def pad_element_arrays(gather_nodes: np.ndarray, *arrays, n_shards: int):
    """Pad element-axis arrays to a shard-divisible count with no-op elements.

    Padding elements gather node 0 but carry all-zero geometric factors, so
    their scatter contribution is exactly zero.
    """
    E = gather_nodes.shape[0]
    Ep = pad_elements(E, n_shards)
    if Ep == E:
        return (gather_nodes,) + arrays
    pad_g = np.zeros((Ep - E,) + gather_nodes.shape[1:], gather_nodes.dtype)
    out = [np.concatenate([gather_nodes, pad_g])]
    for a in arrays:
        pad_a = np.zeros((Ep - E,) + a.shape[1:], a.dtype)
        out.append(np.concatenate([a, pad_a]))
    return tuple(out)


COMMS = ("propagation", "shardmap", "shardmap-fused")


def sharded_local_poisson_problem(problem, mesh=None, axis: str = ELEM_AXIS,
                                  backend: str = "xla",
                                  comm: str = "propagation",
                                  precond="jacobi"):
    """Element-sharded **L-vector** CG setup of a 2D :class:`..models.
    poisson.Poisson` problem.

    The element count is padded to a multiple of the shard count with
    inert elements (zero geometric factors, zero dot weights, no class
    mask), :func:`..ops.exchange.make_exchange` ``(pad_to=Ep)``.

    ``comm``:

    * ``"propagation"`` — the (E, n) operator of
      :func:`..ops.sumfac.make_local_laplacian_operator` (``vector_layout=
      "en"``, ``backend`` as given) on the padded exchange: what the
      reference's sharding propagation computes, on one controller;
    * ``"shardmap"`` — transposed (n, E) vectors, the per-shard local
      product and the halo DSS (:func:`.halo.make_sharded_local_operator`;
      any dtype);
    * ``"shardmap-fused"`` — transposed vectors, the block kernel per shard
      (:func:`.halo.make_sharded_fused_operator`; float32 affine meshes).

    ``precond``: ``"jacobi"``; the sharded ``"pmg"`` (or a dict of its
    options) is not ported yet and raises (ROADMAP Queue 1 item 12: the
    reference composes the V-cycle with the sharded operator and a padded
    coarse level).

    Returns ``(A, r, M, u_dL, exchange, mesh)``; solve with
    ``cg(A, r, M=M, dot=exchange.dot)`` (``dot_T`` for the transposed
    comms) and recover the global solution with
    ``exchange.global_from_local(u_dL + x)`` (``global_from_local_T``).
    """
    from ..ops.exchange import make_exchange
    from ..solver.cg import jacobi_preconditioner
    from . import halo

    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}")
    if precond == "pmg" or isinstance(precond, dict):
        raise NotImplementedError(
            "the sharded precond='pmg' is not ported yet (ROADMAP Queue 1 "
            "item 12, sharding)")
    if precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")
    transposed = comm != "propagation"
    if mesh is None:
        mesh = device_mesh()
    dev = mesh.device
    disc = problem.disc
    if disc.mesh.ndim != 2:
        raise ValueError("sharded_local_poisson_problem takes a 2D "
                         "discretization (3D: sharded_local_poisson_"
                         "problem_3d)")
    E, n_loc = disc.E, disc.n_loc
    Ep = pad_elements(E, mesh.size)
    ex = getattr(problem, "_exchange", None)
    if ex is None or ex.E != Ep:
        # the model's own exchange serves when no padding is needed
        ex = make_exchange(disc, pad_to=Ep)

    dtype = problem.dtype
    Gf = np.zeros((Ep, 3, n_loc), dtype=dtype)
    Gf[:E] = np.asarray(problem._G_host, dtype=dtype).reshape(E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(problem._D0_host,
                                          problem._D1_host)

    free = np.zeros((Ep, n_loc), dtype=bool)
    free[:E] = (~problem._dirichlet_mask)[ex.gather_hier[:E]]

    b = np.asarray(problem._b) + problem._neumann
    u_d = np.where(problem._dirichlet_mask, problem._dirichlet_vals, 0.0)
    bL = ex.local_from_global(b).astype(dtype)
    u_dL = ex.local_from_global(u_d).astype(dtype)
    bL[E:] = 0.0
    u_dL[E:] = 0.0
    diagL = ex.local_from_global(
        np.asarray(problem.operator_diagonal())).astype(dtype)
    diagL[E:] = 1.0

    if transposed:
        free, bL, u_dL, diagL = (
            np.ascontiguousarray(a.T) for a in (free, bL, u_dL, diagL))
    free_d, bL_d, u_dL_d, diag_d = (torch.as_tensor(a, device=dev)
                                    for a in (free, bL, u_dL, diagL))

    if comm == "shardmap-fused":
        if np.dtype(dtype) != np.float32:
            raise ValueError("comm='shardmap-fused' runs the f32 block "
                             f"kernel; problem dtype is {np.dtype(dtype)}")
        W = disc.basis.weight_grid().reshape(-1)
        a_f, exact = sumfac.affine_factorization(Gf, W)
        if not exact:
            raise ValueError("comm='shardmap-fused' requires an affine "
                             "mesh (use comm='shardmap')")
        Kcat = sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
        A_raw = halo.make_sharded_fused_operator(ex, Kcat, a_f, mesh,
                                                 axis=axis)
    elif transposed:
        A_raw = halo.make_sharded_local_operator(ex, Gf, Dhat, mesh,
                                                 axis=axis)
    else:
        A_raw = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, None, device=dev, vector_layout="en",
            backend=backend)

    def A(u):
        # the Dirichlet mask around the one unmasked operator, which also
        # lifts the boundary values into r
        return torch.where(free_d, A_raw(torch.where(free_d, u, 0.0)), 0.0)

    r = torch.where(free_d, bL_d - A_raw(u_dL_d), 0.0)
    M = jacobi_preconditioner(diag_d, free_d)
    return A, r, M, u_dL_d, ex, mesh


def sharded_local_poisson_problem_3d(problem, mesh=None,
                                     axis: str = ELEM_AXIS):
    """Element-sharded 3D L-vector CG setup of a hexahedral
    :class:`..models.poisson.Poisson` problem.

    Every iteration-state tensor is an (E_pad, n_loc) lexicographic
    L-vector; the shards are ``mesh.size`` contiguous element blocks of the
    box order on one device (the reference shards the element axis over a
    device mesh).  The operator is the general local 3D apply
    (:func:`..ops.sumfac.laplacian_apply_local_3d`, the reference's) and
    the plane-roll DSS with its rolls crossing the shard edges as explicit
    copies (:func:`.halo.make_halo_dss_3d`); the element count is padded to
    a multiple of the shards with inert elements (zero factors and
    weights).  Requires a lexicographic box element order
    (:class:`..ops.exchange.BoxRollExchange3D` validates; no fallback).

    Returns ``(A, r, M, u_dL, exchange, mesh)``; solve with ``cg(A, r,
    M=M, dot=exchange.dot)`` and recover the solution with
    ``exchange.global_from_local(u_dL + x)``.
    """
    from ..ops.exchange import BoxRollExchange3D
    from ..solver.cg import jacobi_preconditioner
    from .halo import make_halo_dss_3d

    if mesh is None:
        mesh = device_mesh()
    dev = mesh.device
    disc = problem.disc
    if disc.mesh.ndim != 3:
        raise ValueError("sharded_local_poisson_problem_3d requires a "
                         "3D discretization")
    E, n_loc = disc.E, disc.n_loc
    shape = tuple(disc.shape)
    Ep = pad_elements(E, mesh.size)
    ex = BoxRollExchange3D(disc, pad_to=Ep)

    dtype = problem.dtype
    G = np.zeros((Ep, 6) + shape, dtype=dtype)
    G[:E] = np.asarray(problem._G_host, dtype=dtype).reshape((E, 6) + shape)
    free = np.zeros((Ep, n_loc), dtype=bool)
    free[:E] = (~problem._dirichlet_mask)[ex.gather_lex[:E]]

    b = np.asarray(problem._b) + problem._neumann
    u_d = np.where(problem._dirichlet_mask, problem._dirichlet_vals, 0.0)
    bL = np.zeros((Ep, n_loc), dtype=dtype)
    bL[:E] = ex.local_from_global(b)[:E]
    u_dL = np.zeros((Ep, n_loc), dtype=dtype)
    u_dL[:E] = ex.local_from_global(u_d)[:E]
    diagL = np.ones((Ep, n_loc), dtype=dtype)
    diagL[:E] = ex.local_from_global(
        np.asarray(problem.operator_diagonal()))[:E]
    free_d, bL_d, u_dL_d, diag_d, G_d = (
        torch.as_tensor(a, device=dev) for a in (free, bL, u_dL, diagL, G))

    A_raw = sumfac.Laplacian3D(
        ex, "general", shape, G=G_d,
        D=[torch.as_tensor(np.array(D, dtype=dtype), device=dev)
           for D in problem._D_hosts()],
        dss=make_halo_dss_3d(ex, axis, mesh.size))

    def A(uL):
        return torch.where(free_d, A_raw(torch.where(free_d, uL, 0.0)), 0.0)

    r = torch.where(free_d, bL_d - A_raw(u_dL_d), 0.0)
    M = jacobi_preconditioner(diag_d, free_d)
    return A, r, M, u_dL_d, ex, mesh
