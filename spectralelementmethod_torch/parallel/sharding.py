"""Element-axis sharding of the Poisson solve (PyTorch port).

Port of the JAX package's ``parallel/sharding.py``.  The reference shards
over a ``jax.sharding.Mesh``; the port's :class:`DeviceMesh` is one of two
kinds (:mod:`.comm`):

* **single-controller**: ``size`` shards simulated on one device, each a
  contiguous block of the element axis of one tensor, the reference's
  collectives explicit copies and sums between the blocks;
* **one rank per card**: under an initialised ``torch.distributed``
  process group (``python -m torch.distributed.run``), one shard per rank
  on ``cuda:LOCAL_RANK`` (NCCL; gloo for CPU tensors), every sharded
  function taking and returning the rank's own block, the halos messages
  and every sum the rank partials from ``all_gather`` added in rank order.

* :func:`device_mesh` / :func:`hybrid_device_mesh` — the 1D meshes (the
  hybrid one slice-major: a node per slice, or contiguous pseudo-slices,
  ``shard_slice_ids``);
* :func:`make_sharded_poisson_operator` / :func:`sharded_poisson_problem`
  — the replicated-vector scheme: each shard applies its elements into a
  full-length partial, and the partials are summed in shard order (the
  reference's ``psum``);
* :func:`sharded_local_poisson_problem` — the element-sharded L-vector
  path (the reference's production multi-chip path) with Jacobi or the
  sharded p-multigrid V-cycle (a padded coarse level);
* :func:`sharded_local_poisson_problem_3d` — the 3D box-mesh L-vectors,
  sharded the same way in element blocks;
* :func:`gather_blocks` — the whole array from the ranks' blocks (a
  divergence: the reference's results are global arrays, the port's are
  each rank's block).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..config import canonical_device, resolve_device, torch_dtype
from ..ops import sumfac
from . import comm as _comm
from .halo import ELEM_AXIS


class DeviceMesh(NamedTuple):
    """A 1D mesh of ``size`` element shards.  ``shard_slice_ids`` gives
    each shard's (pseudo-)slice on a :func:`hybrid_device_mesh` (None on a
    :func:`device_mesh`).  ``group`` None: the shards are simulated on
    ``device``.  Else ``group`` is the process group, ``rank`` this
    process's shard and ``device`` its own device."""

    size: int
    device: torch.device
    axis: str = ELEM_AXIS
    shard_slice_ids: tuple | None = None
    rank: int | None = None
    group: object | None = None


def _dist():
    """``torch.distributed`` when a process group is initialised, else
    None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank_device(dist, device) -> torch.device:
    """This rank's device under the group's backend: ``cuda:LOCAL_RANK``
    (made current) for NCCL, the CPU for gloo, or ``device`` where given
    and the backend moves its tensors.  No other pairing is accepted."""
    backend = str(dist.get_backend()).lower()
    if device is None:
        if backend == "nccl":
            local = int(os.environ.get(
                "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            return torch.device("cuda", local)
        device = "cpu"
    dev = canonical_device(resolve_device(device))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL group moves CUDA tensors; got {dev}")
    if backend == "gloo" and dev.type != "cpu":
        raise ValueError(f"the gloo group is for CPU tensors; {dev} needs "
                         "NCCL")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _group_mesh(dist, axis, device, slices=None) -> DeviceMesh:
    """One shard per rank of the default group.  The ranks agree on the
    layout (an ``all_gather`` of each one's ``LOCAL_WORLD_SIZE``, which also
    brings up the backend's communicator before the first halo);
    ``slices``: None for a :func:`device_mesh`, True for a node per slice,
    or a pseudo-slice count."""
    dev = _rank_device(dist, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    seen = [torch.tensor([local], dtype=torch.int64, device=dev)
            for _ in range(world)]
    dist.all_gather(seen, torch.tensor([local], dtype=torch.int64,
                                       device=dev))
    if any(int(t) != local for t in seen) or world % local:
        raise ValueError(f"ranks disagree on LOCAL_WORLD_SIZE ({local}) or "
                         f"it does not divide the world ({world})")
    ids = None
    if slices is True:
        ids = tuple(r // local for r in range(world))
    elif slices is not None:
        n = int(slices)
        if world % n:
            raise ValueError(f"{world} ranks do not split into {n} equal "
                             "pseudo-slices")
        per = world // n
        if local % per:
            raise ValueError(f"pseudo-slices of {per} ranks straddle the "
                             f"nodes of {local} ranks")
        ids = tuple(r // per for r in range(world))
    return DeviceMesh(world, dev, axis, ids, rank, dist.group.WORLD)


def _one_card(dev) -> int:
    """The one shard of a mesh given no shard count and no process group;
    several visible cards raise (no simulation of them on one card)."""
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise ValueError(
            f"{torch.cuda.device_count()} cards are visible and no process "
            "group is initialised: run one process per card (python -m "
            "torch.distributed.run --nproc-per-node <cards> ...) or give "
            "the shard count to simulate the shards on one device")
    return 1


def device_mesh(n_devices: int | None = None, axis: str = ELEM_AXIS,
                device=None) -> DeviceMesh:
    """1D mesh of element shards.

    Under an initialised process group, ``n_devices`` None (or the world
    size) is one shard per rank, on the rank's device (``cuda:LOCAL_RANK``
    for NCCL, the CPU for gloo; ``device`` must agree).  Otherwise the
    shards are simulated on ``device`` (the CUDA card unless given;
    ``"cpu"`` runs the plain versions of the kernels): the halo exchange
    is a copy of each shard's boundary strips.  ``None`` is then one shard
    (on the CPU, or on the one visible card); with several visible cards
    it raises: each card takes a process of its own, started by
    ``python -m torch.distributed.run``.
    """
    dist = _dist()
    if dist is not None and n_devices in (None, dist.get_world_size()):
        return _group_mesh(dist, axis, device)
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = _one_card(dev)
    if int(n_devices) < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return DeviceMesh(int(n_devices), dev, axis)


def hybrid_device_mesh(n_slices: int | None = None, axis: str = ELEM_AXIS,
                       devices=None, device=None) -> DeviceMesh:
    """1D element-axis mesh ordered slice-major (the reference's
    multi-slice ICI x DCN mesh, whose slices come from
    ``device.slice_index``).

    Under an initialised process group (``devices`` None or the world
    size) one shard per rank, the ranks node-major as the launcher numbers
    them: ``n_slices`` None makes each node a slice (the node of rank r is
    ``r // LOCAL_WORLD_SIZE``); a count splits the ranks into that many
    contiguous pseudo-slices, none straddling a node.

    Single-controller: ``devices`` is None (one shard), a shard count, or
    a sequence of devices (one shard each; every one must be ``device``:
    the shards are simulated on one device).  The shards split into
    ``n_slices`` equal runs (None is one slice).

    ``mesh.shard_slice_ids`` is the tuple of each shard's slice.  An
    uneven split raises the reference's ``ValueError``.  The element order
    is the caller's: the halo DSS crosses a slice boundary between two
    shards as it crosses any other, and keeps its wrap elision for a
    non-periodic order (:func:`.halo.make_halo_dss_T`).
    """
    dist = _dist()
    if dist is not None and (devices is None
                             or (isinstance(devices, (int, np.integer))
                                 and int(devices) == dist.get_world_size())):
        return _group_mesh(dist, axis, device,
                           True if n_slices is None else n_slices)
    dev = resolve_device(device)
    if devices is None:
        n = _one_card(dev)
    elif isinstance(devices, (int, np.integer)):
        n = int(devices)
    else:
        devices = list(devices)
        other = [d for d in devices
                 if resolve_device(d) != dev]
        if other:
            raise ValueError(
                f"the shards are simulated on one device ({dev}); got "
                f"{other}: run one process per card instead")
        n = len(devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if n_slices is None:
        n_slices = 1
    if n % int(n_slices):
        raise ValueError(f"{n} devices do not split into {n_slices} equal "
                         "pseudo-slices")
    per = n // int(n_slices)
    ids = tuple(int(i) for i in np.repeat(np.arange(int(n_slices)), per))
    return DeviceMesh(n, dev, axis, ids)


def pad_elements(E: int, n_shards: int) -> int:
    """Padded element count (multiple of n_shards): the pad elements are
    the last ones, so they fall on the last shards (ranks)."""
    return ((E + n_shards - 1) // n_shards) * n_shards


def pad_element_arrays(gather_nodes: np.ndarray, *arrays, n_shards: int):
    """Pad element-axis arrays to a shard-divisible count with no-op elements
    (appended: the last shards hold them).

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


def replicated(mesh, *arrays):
    """Arrays (numpy or tensors) as tensors on the mesh's device, whole
    (every shard, every rank, reads them whole)."""
    return tuple(torch.as_tensor(a if isinstance(a, torch.Tensor)
                                 else np.array(a), device=mesh.device)
                 for a in arrays)


def shard_element_arrays(mesh, *arrays, axis: str = ELEM_AXIS):
    """Element-axis arrays as tensors on the mesh's device, their leading
    axis split into ``mesh.size`` equal blocks (an axis that does not
    divide raises, as the reference's even sharding does): the whole
    arrays on a single-controller mesh, the rank's blocks under a process
    group.  ``axis`` names the mesh axis and is not read here."""
    for a in arrays:
        if np.shape(a)[0] % mesh.size:
            raise ValueError(
                f"leading axis {np.shape(a)[0]} does not split into "
                f"{mesh.size} shards; pad it (pad_element_arrays)")
    return replicated(mesh, *(_comm.block_of(mesh, a, 0) for a in arrays))


def gather_blocks(mesh, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole array from the ranks' blocks along ``dim`` (the element
    axis: -1 for (n, E) L-vectors, 0 for (E, n) ones), on every rank;
    ``x`` itself on a single-controller mesh.  The reference returns
    global arrays; the port's sharded results are each rank's block, so
    ``exchange.global_from_local_T(gather_blocks(mesh, x))`` stands for
    its ``global_from_local_T(x)``."""
    return _comm.gather_blocks(mesh, x, dim)


class RankExchange:
    """A rank's view of a global exchange on a process-group mesh: the dot
    products of the rank's blocks (its partial, summed over the ranks in
    rank order: :func:`.comm.rank_sum`) and its block of the dot weights
    (tagged with the mesh, :func:`.comm.tag`, so ``cg(..., dot_weight=
    exchange.weights_T(...))`` sums over the ranks);
    every other attribute is the global exchange's, so
    ``global_from_local(_T)`` takes the whole array
    (:func:`gather_blocks`)."""

    def __init__(self, exchange, mesh):
        self._ex = exchange
        self._mesh = mesh
        self._w = {}

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def _weights_as(self, dtype, device, transposed: bool = False):
        dt = torch_dtype(dtype)
        key = (dt, str(device), bool(transposed))
        if key not in self._w:
            w = np.asarray(self._ex.weights)
            w = _comm.block_of(self._mesh, w.T if transposed else w,
                              -1 if transposed else 0)
            self._w[key] = _comm.tag(torch.as_tensor(
                np.ascontiguousarray(w), device=device).to(dt), self._mesh)
        return self._w[key]

    def weights_T(self, dtype, device) -> torch.Tensor:
        return self._weights_as(dtype, device, transposed=True)

    def dot_T(self, uT, vT):
        prod = uT * vT
        return _comm.rank_sum(self._mesh, torch.sum(
            prod * self.weights_T(prod.dtype, prod.device)))

    def dot(self, uL, vL):
        prod = uL * vL
        return _comm.rank_sum(self._mesh, torch.sum(
            prod * self._weights_as(prod.dtype, prod.device)))

    def norm(self, uL):
        return torch.sqrt(self.dot(uL, uL))


def _rank_exchange(ex, mesh):
    return RankExchange(ex, mesh) if _comm.distributed(mesh) else ex


def make_sharded_poisson_operator(
    mesh, gather_nodes, G, D0, D1, n_nodes: int, free_mask,
    axis: str = ELEM_AXIS, D2=None,
):
    """Element-sharded matrix-free weak Laplacian on replicated global
    vectors: the psum-of-partials DSS.

    ``gather_nodes``/``G``: the whole padded element arrays
    (:func:`pad_element_arrays`; each shard takes its block,
    :func:`shard_element_arrays`); pad elements carry zero factors.
    ``free_mask`` and the vectors are replicated (n_nodes,).  Each shard
    masks the input, applies :func:`..ops.sumfac.laplacian_apply` (with
    ``D2``: :func:`..ops.sumfac.laplacian_apply_3d`, ``G`` the 6 packed 3D
    components) over its element block into a full-length partial, and
    the partials are summed in shard order (the reference's ``psum``; on a
    process group the ranks' partials from ``all_gather``, so every rank
    holds the same bits); the sum is masked.  Returns ``A(u)`` on
    (n_nodes,) tensors of ``G``'s dtype.
    """
    gix, G = shard_element_arrays(mesh, gather_nodes, G, axis=axis)
    free, *D = replicated(mesh, free_mask, D0, D1,
                          *(() if D2 is None else (D2,)))
    D = [d.to(G.dtype) for d in D]
    apply = (sumfac.laplacian_apply if D2 is None
             else sumfac.laplacian_apply_3d)
    blocks = list(zip(_comm.split(mesh, gix, 0), _comm.split(mesh, G, 0)))

    def A(u):
        u = sumfac.masked(u, free)
        total = None
        for g_b, G_b in blocks:
            partial = apply(u, g_b, G_b, *D, n_nodes)
            total = partial if total is None else total + partial
        return sumfac.masked(_comm.rank_sum(mesh, total), free)

    return A


def sharded_poisson_problem(problem, mesh=None, axis: str = ELEM_AXIS):
    """Shard a :class:`..models.poisson.Poisson` problem (2D or 3D) over
    the element axis with replicated global vectors.

    Returns ``(A, r, M, u_dirichlet, mesh)`` for ``cg(A, r, M=M)``: the
    operator of :func:`make_sharded_poisson_operator` on the padded
    element arrays, the eliminated right-hand side, point Jacobi and the
    Dirichlet lift; the solution is ``u_dirichlet + x``.  ``mesh``: a
    :func:`device_mesh` (None: :func:`device_mesh`'s default).  On a
    process group every rank holds the whole vectors, bit for bit the same.
    """
    from ..solver.cg import jacobi_preconditioner

    if mesh is None:
        mesh = device_mesh()
    dev = mesh.device
    dt = torch_dtype(problem.dtype)
    gix, G = pad_element_arrays(np.asarray(problem.disc.gather_nodes),
                                np.asarray(problem._G_host),
                                n_shards=mesh.size)
    free, u_d = replicated(mesh, ~problem._dirichlet_mask, np.where(
        problem._dirichlet_mask, problem._dirichlet_vals, 0.0))
    u_d = u_d.to(dt)
    A = make_sharded_poisson_operator(
        mesh, gix, G, *problem._D_hosts()[:2], problem.disc.n_nodes, free,
        axis=axis, D2=getattr(problem, "_D2_host", None))
    b = replicated(mesh, np.asarray(problem._b) + problem._neumann)[0].to(dt)
    r = _dirichlet_rhs(problem, A, b, u_d, free)
    M = jacobi_preconditioner(
        replicated(mesh, problem.operator_diagonal())[0].to(dt), free)
    return A, r, M, u_d, mesh


def _dirichlet_rhs(problem, A_masked, b, u_d, free):
    """r_f = (b - A u_d)|_free with the *unmasked-input* operator: the
    sharded operator masks its input, so the Dirichlet values go through
    the problem's raw apply (setup only)."""
    v = problem.apply_operator(u_d, device=u_d.device)
    return sumfac.masked(b - v, free)


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

    ``precond``: ``"jacobi"`` (point Jacobi), or ``"pmg"`` — the two-level
    p-multigrid V-cycle of :func:`..solver.pmg.make_pmg_preconditioner`
    composed with the sharded operator (the transposed comms only; a dict
    ``{"pmg": {...}}`` passes its options): ``p_coarse=1``, the cycle in
    the problem's dtype, and a coarse level padded to the fine one's
    element count (``coarse_pad_to=Ep``), so the transfers are per-element
    products that never cross a shard; its output is zeroed on the pad
    columns, and ``M._coarse_kind``, ``M._levels`` and ``M._pmg`` (the
    V-cycle) are set.  Under ``"shardmap-fused"`` the V-cycle's fine
    applies are the sharded operator's block kernels too (the cycle's
    float32 is the problem's dtype); under ``"shardmap"`` the V-cycle
    keeps its own fine operator, as the reference's does.

    Returns ``(A, r, M, u_dL, exchange, mesh)``; solve with
    ``cg(A, r, M=M, dot=exchange.dot)`` (``dot_T`` for the transposed
    comms) and recover the global solution with
    ``exchange.global_from_local(u_dL + x)`` (``global_from_local_T``).

    On a process-group mesh the vectors, ``A``, ``M`` and ``u_dL`` are the
    rank's blocks ((n, E / S), or (E / S, n) for ``"propagation"``, whose
    operator is then the halo operator through transposes: plain PyTorch,
    ``backend="xla"`` only), ``exchange`` is a :class:`RankExchange` (its
    ``dot``/``dot_T`` summed over the ranks, its ``weights_T(...)`` the
    rank's block for ``cg(..., dot_weight=)``), and the global
    solution is ``exchange.global_from_local_T(gather_blocks(mesh, u_dL +
    x))``.
    """
    from ..ops.exchange import make_exchange
    from ..solver.cg import jacobi_preconditioner
    from . import halo

    if comm not in COMMS:
        raise ValueError(f"unknown comm {comm!r}")
    pmg = precond == "pmg" or isinstance(precond, dict)
    if not pmg and precond != "jacobi":
        raise ValueError(f"unknown precond {precond!r}")
    transposed = comm != "propagation"
    if pmg and not transposed:
        raise ValueError("precond='pmg' requires a transposed comm "
                         "('shardmap'/'shardmap-fused')")
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
        free, bL, u_dL, diagL = (a.T for a in (free, bL, u_dL, diagL))
    free_d, bL_d, u_dL_d, diag_d = (
        torch.as_tensor(np.ascontiguousarray(_comm.block_of(
            mesh, a, -1 if transposed else 0)), device=dev)
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
    elif _comm.distributed(mesh):
        if backend != "xla":
            raise ValueError("comm='propagation' on a process group runs "
                             "the (E, n) blocks through the halo operator "
                             f"(backend='xla'); got backend={backend!r}")
        A_T = halo.make_sharded_local_operator(ex, Gf, Dhat, mesh, axis=axis)

        def A_raw(u):
            return A_T(u.T.contiguous()).T.contiguous()
    else:
        A_raw = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, None, device=dev, vector_layout="en",
            backend=backend)

    def A(u):
        # the Dirichlet mask around the one unmasked operator, which also
        # lifts the boundary values into r
        return torch.where(free_d, A_raw(torch.where(free_d, u, 0.0)), 0.0)

    r = torch.where(free_d, bL_d - A_raw(u_dL_d), 0.0)
    if pmg:
        M = _sharded_pmg(problem, ex, Gf, Dhat, A, free_d, precond, dtype,
                         mesh, comm == "shardmap-fused", axis)
    else:
        M = jacobi_preconditioner(diag_d, free_d)
    return A, r, M, u_dL_d, _rank_exchange(ex, mesh), mesh


def _sharded_pmg(problem, ex, Gf, Dhat, A, free_d, precond, dtype, mesh,
                 fused, axis):
    """The sharded p-multigrid ``M`` (:func:`sharded_local_poisson_
    problem`): the V-cycle on the padded exchange with a coarse level
    padded alike, and its output zeroed where ``free_d`` is False (the pad
    columns: the V-cycle's masks come from gathered global nodes, which
    alias node 0 there).  ``Gf``: the padded (Ep, 3, n) factors.

    Single-controller, the V-cycle keeps its own fine operator on whole
    vectors, or takes ``A`` (``fused``, and the cycle runs in ``dtype``).
    On a process group it runs on the rank's blocks: its fine operator is
    ``A`` where the cycle runs in ``dtype``, else the halo operator in the
    cycle dtype (:func:`..solver.pmg.make_pmg_preconditioner` given the
    :class:`RankExchange`)."""
    from ..solver.pmg import make_pmg_preconditioner
    from . import halo

    E = problem.disc.E
    kw = dict(precond.get("pmg", {})) if isinstance(precond, dict) else {}
    kw.setdefault("p_coarse", 1)
    kw.setdefault("cycle_dtype", np.dtype(dtype))
    kw.setdefault("device", mesh.device)
    same = np.dtype(kw["cycle_dtype"]) == np.dtype(dtype)
    A_f = A
    if _comm.distributed(mesh):
        if not same:
            A_f = halo.make_sharded_local_operator(
                ex, np.asarray(Gf, np.dtype(kw["cycle_dtype"])), Dhat, mesh,
                free_local=free_d, axis=axis)
    M_pmg = make_pmg_preconditioner(
        problem.disc, _rank_exchange(ex, mesh), Gf[:E], A_f,
        ~problem._dirichlet_mask, np.asarray(problem.operator_diagonal()),
        dtype=np.dtype(dtype),
        coarse_pad_to=ex.E, **kw)
    if fused and same and not _comm.distributed(mesh):
        M_pmg = M_pmg.with_fine_operator(A)

    def M(r):
        return torch.where(free_d, M_pmg(r), 0.0)

    M._coarse_kind = M_pmg._coarse_kind
    M._levels = M_pmg._levels
    M._pmg = M_pmg
    return M


def sharded_local_poisson_problem_3d(problem, mesh=None,
                                     axis: str = ELEM_AXIS):
    """Element-sharded 3D L-vector CG setup of a hexahedral
    :class:`..models.poisson.Poisson` problem.

    Every iteration-state tensor is an (E_pad, n_loc) lexicographic
    L-vector; the shards are ``mesh.size`` contiguous element blocks of the
    box order (the reference shards the element axis over a device
    mesh).  The operator is the general local 3D apply
    (:func:`..ops.sumfac.laplacian_apply_local_3d`, the reference's) and
    the plane-roll DSS with its rolls crossing the shard edges
    (:func:`.halo.make_halo_dss_3d`); the element count is padded to
    a multiple of the shards with inert elements (zero factors and
    weights).  Requires a lexicographic box element order
    (:class:`..ops.exchange.BoxRollExchange3D` validates; no fallback).

    Returns ``(A, r, M, u_dL, exchange, mesh)``; solve with ``cg(A, r,
    M=M, dot=exchange.dot)`` and recover the solution with
    ``exchange.global_from_local(u_dL + x)``.  On a process-group mesh the
    tensors are the rank's (E_pad / S, n_loc) blocks, the plane rolls
    messages from the source ranks, ``exchange`` a :class:`RankExchange`,
    and the solution ``exchange.global_from_local(gather_blocks(mesh, u_dL
    + x, 0))``.
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
        torch.as_tensor(np.ascontiguousarray(_comm.block_of(mesh, a, 0)),
                        device=dev) for a in (free, bL, u_dL, diagL, G))

    A_raw = sumfac.Laplacian3D(
        ex, "general", shape, G=G_d,
        D=[torch.as_tensor(np.array(D, dtype=dtype), device=dev)
           for D in problem._D_hosts()],
        dss=make_halo_dss_3d(ex, axis, mesh))

    def A(uL):
        return torch.where(free_d, A_raw(torch.where(free_d, uL, 0.0)), 0.0)

    r = torch.where(free_d, bL_d - A_raw(u_dL_d), 0.0)
    M = jacobi_preconditioner(diag_d, free_d)
    return A, r, M, u_dL_d, _rank_exchange(ex, mesh), mesh
