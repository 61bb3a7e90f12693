"""Matrix-free preconditioned conjugate gradients (PyTorch port).

Port of the main-path solvers of the JAX package's ``solver/cg.py``:

* :func:`cg` — PCG with a ``dot`` callable or the ``dot_weight`` fold, run
  as a block ladder (``block`` iterations first, 64 by default, doubling
  to 4096) with one host synchronisation per block.  Converged,
  budget-spent and diverged states freeze inside a block (alpha = 0), so
  results match an exactly-stopping loop;
* :func:`cg_fused` — PCG whose iteration is the two fused kernels of
  :mod:`..ops.kernels`, with x lagging one direction (or, ``defer_x=m``,
  caught up once per m iterations) and the true-residual restart; or one
  kernel per iteration (``kB=None``), the residual update deferred into
  the next kernel;
* :func:`cg_batched` and :func:`cg_fused_batched` — the same for a stack
  of k right-hand sides sharing one operator, with per-RHS scalars and
  freezing and one host ladder (``cg_batched``: a batched operator, or
  one that acts on one vector and is called per RHS);
* :func:`cg_host` — PCG with a plain host loop (one host read of the
  residual norm per iteration), for small and one-off solves;
* :func:`cg_refined` and :func:`cg_refined_static` — mixed-precision
  refinement: inner PCG solves (segments) re-anchored on the true residual,
  optionally evaluated in float64 by a second operator ``A_hi``;
* :func:`auto_defer_x`, :func:`auto_defer_x_batched` and
  :func:`hbm_residency_regime`, the reference's ``defer_x`` policies;
* :func:`jacobi_preconditioner`.

Each iteration is a Python loop over device tensors: the scalars (alpha,
beta, the stopping state) stay on the device and are read back once per
block.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

#: first ladder block and its cap: one host synchronisation per block
_BLOCK0, _BLOCK_MAX = 64, 4096
#: true-residual restarts of cg_fused and cg_fused_batched at most
_MAX_RESTARTS = 2


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor
    #: device iterations actually executed (ladder blocks issued),
    #: including post-convergence frozen ones — the honest denominator
    #: for time-per-iteration accounting
    issued: int = 0
    #: :func:`cg_refined` and :func:`cg_refined_static`: the true residual
    #: norm after each cycle or segment (a skipped segment repeats the last)
    cycle_resnorms: tuple = ()
    #: the solve ended on a stall: :func:`cg` with ``stall_cut`` (a block
    #: shrank ||r||^2 by less than the cut while above tolerance), a
    #: refinement cycle or segment that shrank the true ||r||^2 by less
    #: than 4x while above tolerance
    stalled: bool = False


class _State(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rn2: torch.Tensor
    k: torch.Tensor
    stop2: torch.Tensor
    max_it: torch.Tensor
    rn2_min: torch.Tensor


def _done(rn2, k, stop2, max_it, rn2_min):
    # the divergence guard freezes when the residual grows 1e6x past its
    # best; ~isfinite catches an operator breakdown (NaN compares False
    # against every bound)
    return ((rn2 <= stop2) | (k >= max_it) | (rn2 > 1e6 * rn2_min)
            | ~torch.isfinite(rn2))


def _safe(d):
    return torch.where(d != 0, d, torch.ones_like(d))


def _ladder_size(max_iter: int, issued: int, block: int) -> int:
    """Next block size: the remaining budget rounded up to a multiple of
    64 (the surplus runs frozen), capped at ``block``."""
    remaining = -(-(max_iter - issued) // 64) * 64
    return min(block, remaining)


def _ranks_of(w):
    """The process-group mesh whose rank's block the dot weights ``w`` are
    (a :class:`..parallel.sharding.RankExchange`'s ``weights_T`` and
    ``_weights_as`` carry it), else None."""
    from ..parallel import comm

    return None if w is None else comm.mesh_of(w)


def _rank_sum(mesh):
    """The sum over ``mesh``'s ranks of a rank's partial
    (:func:`..parallel.comm.rank_sum`: the same bits on every rank); the
    identity without a mesh."""
    from ..parallel import comm

    return _identity if mesh is None else (lambda t: comm.rank_sum(mesh, t))


def _pcg(A: Callable, M: Callable, dot: Callable | None,
         w: torch.Tensor | None, mesh=None):
    """``(wsum, step)`` of preconditioned CG: the inner product (``sum(w u
    v)`` with the diagonal weights ``w``, else ``dot``, else Euclidean) and
    one iteration on a :class:`_State`.  With ``w`` the step folds the
    weight into each vector pass once (``w*Ap``, ``w*z``).  With ``w`` a
    rank's block on the process-group ``mesh`` the weighted sums are the
    ranks' partials summed in rank order, the iteration's two closing sums
    in one ``all_gather`` (``dot`` is a global inner product already)."""
    red = None if w is None or mesh is None else _rank_sum(mesh)
    if w is not None:
        def wsum(u, v):
            s = torch.sum(u * v * w)
            return s if red is None else red(s)
    elif dot is not None:
        wsum = dot
    else:
        def wsum(u, v):
            return torch.sum(u * v)

    def closing(r, z):
        if red is None:
            return (wsum(r, z) if w is None else torch.sum(r * (w * z)),
                    wsum(r, r))
        from ..parallel import comm

        return comm.rank_sums(mesh, torch.sum(r * (w * z)),
                              torch.sum(r * r * w))

    def step(s: _State) -> _State:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        Ap = A(s.p)
        denom = wsum(s.p, Ap) if w is None else torch.sum(s.p * (w * Ap))
        if red is not None:
            denom = red(denom)
        alpha = torch.where(done, 0.0, s.rz / _safe(denom))
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = M(r)
        rz_n, rn2 = closing(r, z)
        beta = rz_n / _safe(s.rz)
        p = z + beta * s.p
        k = s.k + (~done).to(s.k.dtype)
        rn2_min = torch.where(done, s.rn2_min, torch.minimum(s.rn2_min, rn2))
        return _State(x, r, z, p, rz_n, rn2, k, s.stop2, s.max_it, rn2_min)

    return wsum, step


def _pcg_init(x0, r0, M, wsum, stop2, max_iter: int) -> _State:
    """The PCG state at the guess ``x0`` with residual ``r0``."""
    z0 = M(r0)
    rn0 = wsum(r0, r0)
    dev = r0.device
    return _State(x0, r0, z0, z0, wsum(r0, z0), rn0,
                  torch.zeros((), dtype=torch.int32, device=dev), stop2,
                  torch.tensor(max_iter, dtype=torch.int32, device=dev), rn0)


def cg(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    M: Callable | None = None,
    tol: float = 1e-12,
    atol: float = 0.0,
    max_iter: int = 1000,
    dot: Callable | None = None,
    dot_weight: torch.Tensor | None = None,
    block: int = 64,
    stall_cut: float | None = None,
) -> CGResult:
    """Solve ``A x = b`` with preconditioned CG (the reference's signature).

    ``A``: SPD operator; ``M``: preconditioner approximating ``A^-1``;
    ``x0``: the initial guess (zero when None).  ``dot``: the inner product
    (e.g. an exchange's multiplicity-weighted ``dot_T`` for L-vectors);
    Euclidean when None.  ``dot_weight``: diagonal weights of the inner
    product ``<u, v> = sum(w u v)``, in place of ``dot``; the body folds the
    weight into each vector pass once (``w*Ap``, ``w*z``).  Stops when
    ``||r|| <= max(tol ||b||, atol)`` in the dot-induced norm.  ``block``:
    the first ladder block (it doubles up to 4096); ``block >= max_iter``
    runs the whole budget with one host synchronisation.  ``stall_cut``
    stops the ladder when a whole block of at least 64 iterations shrinks
    ``||r||^2`` by less than that factor while above tolerance; the result
    then has ``stalled=True`` and the best block-boundary state.

    On a process-group mesh, where each rank holds its block of ``b``,
    ``dot`` is a global inner product (a :class:`..parallel.sharding.
    RankExchange`'s ``dot_T``) and ``dot_weight`` the rank's block of the
    weights (the exchange's ``weights_T``, which carries its mesh): the
    weighted sums are then the ranks' partials summed in rank order, so
    the scalars, the ladder's stops and its block ends are the same on
    every rank.
    """
    if M is None:
        M = _identity
    wsum, step = _pcg(A, M, dot, dot_weight, _ranks_of(dot_weight))
    x0 = torch.zeros_like(b) if x0 is None else x0
    stop2 = torch.clamp_min(tol * tol * wsum(b, b), atol * atol)
    state = _pcg_init(x0, b - A(x0), M, wsum, stop2, max_iter)

    issued = 0
    best_state, best_rn2 = state, float("inf")
    rn2_ckpt, stalled = float("inf"), False
    while issued < max_iter:
        n = _ladder_size(max_iter, issued, block)
        for _ in range(n):
            state = step(state)
        issued += n
        rn2_now, stop2_now, rn2_min_now = torch.stack(
            [state.rn2, state.stop2, state.rn2_min]).tolist()
        if rn2_now <= best_rn2:
            best_state, best_rn2 = state, rn2_now
        if (rn2_now <= stop2_now or rn2_now > 1e6 * rn2_min_now
                or not math.isfinite(rn2_now)):
            break
        if (stall_cut is not None and n >= 64 and math.isfinite(rn2_ckpt)
                and rn2_now > rn2_ckpt / stall_cut):
            stalled = True
            break
        rn2_ckpt = rn2_now
        block = min(block * 2, _BLOCK_MAX)

    # on breakdown/divergence, fall back to the best block-boundary state
    s = best_state
    return CGResult(s.x, s.k, torch.sqrt(s.rn2), s.rn2 <= s.stop2, issued,
                    stalled=stalled)


def cg_refined(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    tol: float = 1e-6,
    max_iter: int = 1000,
    dot: Callable | None = None,
    dot_weight: torch.Tensor | None = None,
    block: int = 64,
    cycles: int = 3,
    stall_cut: float | None = None,
    A_hi: Callable | None = None,
    b_hi: torch.Tensor | None = None,
    inner_tol_factor: float = 0.25,
) -> CGResult:
    """PCG with true-residual refinement (the reference's signature).

    Each cycle runs :func:`cg` on the current residual ``r`` from a zero
    guess, to ``atol = inner_tol_factor * tol * ||b||`` (past the outer
    target: an inner recurrence's claimed residual under-reports the true
    one by its rounding floor), then re-anchors on the true residual, ``r =
    b - A x``.  ``stall_cut`` goes to the inner :func:`cg`; a cycle that
    shrinks the true ``||r||^2`` by less than 4x while above tolerance ends
    the loop with ``stalled=True``.  Stops when ``||r|| <= tol ||b||`` in
    the ``dot_weight`` / ``dot`` / Euclidean norm, after at most ``cycles``
    cycles.

    ``A_hi`` (and optionally ``b_hi``): the anchors in float64 — ``x_h +=
    dx``, ``r_h = b_h - A_hi(x_h)``, the norm in float64 from the stored
    weights (cast inside the reduction; no float64 copy of the weights is
    kept), and ``x`` is ``x_h``.  With ``A_hi`` the norm must be
    ``dot_weight``'s or the Euclidean one (``dot`` alone raises).

    Returns a :class:`CGResult` of host scalars, as the reference's:
    ``iterations`` and ``issued`` summed over the cycles, the true residual
    after each cycle in ``cycle_resnorms``.

    One planned divergence from the reference: ``stall_cut`` defaults to
    None (there 4.0), so an honestly but slowly converging inner ladder
    (Jacobi on an ill-conditioned system) is not cut; the certified solve
    passes its own.  A rank's ``dot_weight`` (:func:`cg`) sums the
    float64 norms over the ranks too.
    """
    if A_hi is not None and dot is not None and dot_weight is None:
        raise ValueError("A_hi anchoring supports dot_weight or the "
                         "Euclidean dot (the float64 anchor norm must match "
                         "the inner stopping norm)")
    w = dot_weight
    red = _rank_sum(_ranks_of(w))

    def nrm2(v) -> float:
        if w is not None:
            return float(red(torch.sum(w * v * v)))
        if dot is not None:
            return float(dot(v, v))
        return float(red(torch.sum(v * v)))

    if A_hi is not None:
        b_h = (b if b_hi is None else b_hi).to(torch.float64)
        x_h = torch.zeros_like(b_h)
        rn2 = nrm2(b_h)
    else:
        rn2 = nrm2(b)
    stop2 = float(tol) ** 2 * rn2
    x = torch.zeros_like(b)
    r = b
    its = issued = 0
    history = []
    stalled = False
    for _ in range(max(int(cycles), 1)):
        if rn2 <= stop2:
            break
        res = cg(A, r, M=M, tol=0.0,
                 atol=inner_tol_factor * math.sqrt(stop2),
                 max_iter=max_iter, dot=dot, dot_weight=dot_weight,
                 block=block, stall_cut=stall_cut)
        its += int(res.iterations)
        issued += int(res.issued)
        rn2_prev = rn2
        if A_hi is not None:
            x_h = x_h + res.x.to(torch.float64)
            r_h = b_h - A_hi(x_h)
            rn2 = nrm2(r_h)
            r = r_h.to(b.dtype)             # the next cycle's right-hand side
        else:
            x = x + res.x
            r = b - A(x)
            rn2 = nrm2(r)
        history.append(math.sqrt(max(rn2, 0.0)))
        if rn2 > stop2 and rn2 > 0.25 * rn2_prev:
            # the recursion's floor is the limit, not the anchor point
            stalled = True
            break
    if A_hi is not None:
        x = x_h
    return CGResult(x, its, math.sqrt(max(rn2, 0.0)),
                    rn2 <= stop2 * (1 + 1e-12), issued,
                    cycle_resnorms=tuple(history), stalled=stalled)


def cg_refined_static(
    A: Callable,
    b_hi: torch.Tensor,
    *,
    A_hi: Callable,
    M: Callable | None = None,
    tol: float = 1e-6,
    schedule: tuple = (64, 32, 32, 64),
    dot_weight: torch.Tensor | None = None,
    inner_tol_factor: float = 0.25,
    dtype=torch.float32,
) -> CGResult:
    """Mixed-precision refined PCG on a fixed schedule (the reference's
    signature).

    ``b_hi``: the float64 right-hand side; ``A``, ``M``: the ``dtype``
    operator and preconditioner; ``A_hi``: the float64 operator of the same
    system.  Segment i runs exactly ``schedule[i]`` PCG iterations in
    ``dtype`` from a zero guess on the current residual ``r`` (no apply of
    the guess), frozen once its recurrence reaches ``inner_tol_factor**2 *
    tol**2 * ||b_hi||^2``, then re-anchors in float64: ``x_h += x``, ``r_h =
    b_hi - A_hi(x_h)``, ``rn2 = sum(w r_h^2)`` (``dot_weight`` cast inside
    the reduction, or Euclidean).  ``iterations`` counts the iterations
    that were not frozen, ``issued`` those of the segments run.

    A segment whose anchored residual is already at ``tol ||b_hi||`` is
    skipped: it repeats the last value in ``cycle_resnorms`` and adds
    nothing to ``issued``.  The reference decides that inside one compiled
    program; here the host decides, from one read after each segment (the
    anchored norm, the segment's iterations and, with the first, ``||b_hi||``;
    the first segment is launched before ``||b_hi||`` is known and dropped
    if there was nothing to solve), so a solve makes one host read per
    segment it runs.

    Returns a :class:`CGResult` of host scalars with the float64 ``x``.
    ``converged`` refers to the float64-evaluated residual.  ``stalled``
    (a planned divergence: the reference's flag cannot be true) is set when
    the solve is not converged and the last segment run shrank the anchored
    ``||r||^2`` by less than 4x, the rule of :func:`cg_refined`'s outer loop.
    A rank's ``dot_weight`` (:func:`cg`) sums the float64 norms over the
    ranks too.
    """
    if M is None:
        M = _identity
    schedule = tuple(int(n) for n in schedule)
    tol2 = float(tol) ** 2
    f2 = float(inner_tol_factor) ** 2
    b_h = b_hi.to(torch.float64)
    w32 = None if dot_weight is None else dot_weight.to(dtype)
    mesh = _ranks_of(dot_weight)
    wsum, step = _pcg(A, M, None, w32, mesh)
    red = _rank_sum(mesh)

    def wsum64(v):
        return red(torch.sum(v * v) if w32 is None
                   else torch.sum(w32 * v * v))

    rn2_0 = wsum64(b_h)
    atol2_i = (f2 * (tol2 * rn2_0)).to(dtype)
    x_h = torch.zeros_like(b_h)
    r32 = b_h.to(dtype)
    its = issued = 0
    seg_rns = []
    stop2 = rn2 = rn2_prev = None
    for i, n in enumerate(schedule):
        if i and rn2 <= stop2:
            seg_rns.append(seg_rns[-1])
            continue
        state = _pcg_init(torch.zeros_like(r32), r32, M, wsum, atol2_i, n)
        for _ in range(n):
            state = step(state)
        x_new = x_h + state.x.to(torch.float64)
        r_h = b_h - A_hi(x_new)
        rn2_new, k_seg, rn2_b = torch.stack(
            [wsum64(r_h), state.k.to(torch.float64), rn2_0]).tolist()
        if not i:
            stop2 = tol2 * rn2_b
            rn2 = rn2_b
            if rn2 <= stop2:                # nothing to solve: skip them all
                seg_rns = [math.sqrt(max(rn2, 0.0))] * len(schedule)
                break
        x_h, r32 = x_new, r_h.to(dtype)
        rn2_prev, rn2 = rn2, rn2_new
        its += int(k_seg)
        issued += n
        seg_rns.append(math.sqrt(max(rn2, 0.0)))
    converged = rn2 <= stop2 * (1 + 1e-12)
    stalled = (not converged and rn2_prev is not None
               and rn2 > 0.25 * rn2_prev)
    return CGResult(x_h, its, math.sqrt(max(rn2, 0.0)), converged, issued,
                    cycle_resnorms=tuple(seg_rns), stalled=stalled)


def _identity(r):
    return r


def cg_host(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    M: Callable | None = None,
    tol: float = 1e-12,
    atol: float = 0.0,
    max_iter: int = 1000,
    dot: Callable | None = None,
) -> CGResult:
    """PCG with a host-side Python loop: the same math as :func:`cg`, with
    the residual norm read back every iteration and no ladder or freezing.

    ``dot``: the inner product (the exchange's weighted ``dot`` for
    L-vectors); Euclidean by default.  Stops when ``||r|| <= max(tol
    ||b||, atol)`` in the ``dot``-induced norm.  ``issued`` is the
    iteration count.  On a process-group mesh's rank blocks ``dot`` is a
    :class:`..parallel.sharding.RankExchange`'s (summed over the ranks).
    """
    if M is None:
        M = _identity
    if dot is None:
        dot = lambda u, v: torch.sum(u * v)  # noqa: E731

    def norm(v):
        return float(torch.sqrt(dot(v, v)))

    x = torch.zeros_like(b) if x0 is None else x0
    stop = max(tol * norm(b), atol)
    r = b - A(x)
    z = M(r)
    p = z
    rz = dot(r, z)
    k = 0
    rnorm = norm(r)
    while rnorm > stop and k < max_iter:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rnorm = norm(r)
    dev = b.device
    return CGResult(x, torch.tensor(k, dtype=torch.int32, device=dev),
                    torch.tensor(rnorm, dtype=b.dtype, device=dev),
                    torch.tensor(rnorm <= stop, device=dev), k)


def _bc(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast (k,) per-RHS scalars against a (k, ...) stack."""
    return s.reshape(s.shape + (1,) * (x.dim() - 1))


def cg_batched(
    A: Callable,
    B: torch.Tensor,
    *,
    M: Callable | None = None,
    tol: float = 1e-12,
    max_iter: int = 1000,
    dot_weight: torch.Tensor | None = None,
    whole_batch: bool = False,
) -> CGResult:
    """Solve ``A x_j = b_j`` for a (k, ...) stack of right-hand sides from
    ``x0 = 0``.

    By default (the reference's vmapped mode) ``A`` and ``M`` act on ONE
    unbatched vector each, as in :func:`cg`, and each iteration calls them
    once per RHS (the reference's ``jax.vmap`` over the batch: the same
    numbers).  ``whole_batch=True`` passes the full stack to ``A`` and
    ``M`` each iteration instead (the multi-RHS operator of
    :func:`..ops.sumfac.make_multi_rhs_laplacian_T`, one launch for the
    stack).  ``dot_weight`` is unbatched and broadcasts over k.  Each RHS
    carries its own alpha, beta and stopping state and freezes
    independently (alpha = 0); one host read of the three (k,) vectors per
    ladder block serves all k solves, and the ladder runs until every RHS
    is converged, diverged or out of budget.  The best block-boundary state
    is kept per RHS.  The fields of the result are batched: ``x`` (k,
    ...), the rest (k,).
    """
    if not whole_batch:
        A = _per_rhs(A)
        M = None if M is None else _per_rhs(M)
    if M is None:
        M = _identity
    w = dot_weight
    dims = tuple(range(1, B.dim()))

    def wsum(U, V):
        prod = U * V if w is None else U * V * w
        return prod.sum(dims)

    def fold(V):
        return V if w is None else w * V

    dev, k = B.device, int(B.shape[0])
    X0 = torch.zeros_like(B)
    r0 = B - A(X0)
    z0 = M(r0)
    rn0 = wsum(r0, r0)
    state = _State(X0, r0, z0, z0, wsum(r0, z0), rn0,
                   torch.zeros(k, dtype=torch.int32, device=dev),
                   tol * tol * wsum(B, B),
                   torch.full((k,), max_iter, dtype=torch.int32, device=dev),
                   rn0)
    zero = torch.zeros((), dtype=B.dtype, device=dev)

    def step(s: _State) -> _State:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        Ap = A(s.p)
        denom = (s.p * fold(Ap)).sum(dims)
        alpha = torch.where(done, zero, s.rz / _safe(denom))
        x = s.x + _bc(alpha, s.p) * s.p
        r = s.r - _bc(alpha, Ap) * Ap
        z = M(r)
        rz_n = (r * fold(z)).sum(dims)
        rn2 = wsum(r, r)
        beta = rz_n / _safe(s.rz)
        p = z + _bc(beta, s.p) * s.p
        it = s.k + (~done).to(s.k.dtype)
        rn2_min = torch.where(done, s.rn2_min, torch.minimum(s.rn2_min, rn2))
        return _State(x, r, z, p, rz_n, rn2, it, s.stop2, s.max_it, rn2_min)

    issued, block = 0, _BLOCK0
    best_state, best_rn2 = state, np.full(k, np.inf)
    while issued < max_iter:
        n = _ladder_size(max_iter, issued, block)
        for _ in range(n):
            state = step(state)
        issued += n
        # one transfer for the three (k,) convergence vectors
        rn2, stop2, rn2m = torch.stack(
            [state.rn2, state.stop2, state.rn2_min]).cpu().numpy()
        best_state, best_rn2 = _keep_best(rn2, best_rn2, state, best_state,
                                          _select_best)
        if ((rn2 <= stop2) | (rn2 > 1e6 * rn2m) | ~np.isfinite(rn2)).all():
            break
        block = min(block * 2, _BLOCK_MAX)

    s = best_state
    return CGResult(s.x, s.k, torch.sqrt(s.rn2), s.rn2 <= s.stop2, issued)


def _per_rhs(f: Callable) -> Callable:
    """``f`` of one vector, applied to each vector of a (k, ...) stack."""
    def apply(X):
        return torch.stack([f(x) for x in X])

    return apply


def _keep_best(rn2, best_rn2, state, best_state, select):
    """Per-RHS best-state bookkeeping of a batched ladder block."""
    improved = rn2 <= best_rn2
    if improved.all():
        return state, rn2
    if improved.any():
        mask = torch.as_tensor(improved, device=state.r.device)
        return select(mask, state, best_state), np.where(improved, rn2,
                                                         best_rn2)
    return best_state, best_rn2


def _select_best(improved: torch.Tensor, new: _State, old: _State) -> _State:
    """Per-RHS merge of two :func:`cg_batched` states: every field is
    batched along its leading axis."""
    return type(new)(*(torch.where(_bc(improved, a), a, b)
                       for a, b in zip(new, old)))


class _FusedState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    rz_prev: torch.Tensor
    alpha_prev: torch.Tensor
    k: torch.Tensor
    rn2: torch.Tensor
    max_it: torch.Tensor
    stop2: torch.Tensor
    rn2_min: torch.Tensor


class _DeferredState(NamedTuple):
    """Deferred-x state: ``P`` holds the last m directions, slot j written
    at unroll position j of every super-iteration; x is caught up at each
    super-iteration's end (no pending term, no alpha_prev)."""
    x: torch.Tensor
    r: torch.Tensor
    P: tuple
    rz: torch.Tensor
    rz_prev: torch.Tensor
    k: torch.Tensor
    rn2: torch.Tensor
    max_it: torch.Tensor
    stop2: torch.Tensor
    rn2_min: torch.Tensor


def _fused_init(b, inv, w_free, tol, atol, max_iter, p_dtype, k=None, m=0):
    """Initial fused-CG state from the residual ``b`` (x0 = 0): one RHS
    (``k`` None, scalars 0-dim) or a (k n, E) stack (scalars (k,));
    ``m > 0`` the deferred-x state with m direction slots."""
    r0 = b.to(torch.float32)
    dev = r0.device
    x0 = torch.zeros_like(r0)
    r3 = r0 if k is None else r0.view(k, *inv.shape)
    wf = w_free.to(torch.float32)
    iv = inv.to(torch.float32)
    if k is None:
        rn0 = torch.sum(wf * r3 * r3)
        rz0 = torch.sum(wf * r3 * (iv * r3))
    else:
        rn0 = (wf * r3 * r3).sum((1, 2))
        rz0 = (wf * r3 * (iv * r3)).sum((1, 2))
    stop2 = torch.maximum(tol * tol * rn0, atol * atol)
    shape = () if k is None else (k,)
    it0 = torch.zeros(shape, dtype=torch.int32, device=dev)
    max_it = torch.full(shape, max_iter, dtype=torch.int32, device=dev)
    if m:
        # all slots zero: at k = 0 slot m - 1 is read with beta = 0
        P0 = tuple(torch.zeros_like(r0, dtype=p_dtype) for _ in range(m))
        return _DeferredState(x0, r0, P0, rz0, rz0, it0, rn0, max_it, stop2,
                              rn0)
    # beta = 0 at k = 0 makes p1 = z0
    p0 = torch.zeros_like(r0, dtype=p_dtype)
    return _FusedState(x0, r0, p0, rz0, rz0,
                       torch.zeros(shape, dtype=torch.float32, device=dev),
                       it0, rn0, max_it, stop2, rn0)


def _fused_step(kA, kB, inv, w_free, zero):
    """One fused iteration (see :func:`cg_fused`); the partials are summed
    over their leading axis, so scalars stay 0-dim or (k,)."""

    def step(s: _FusedState) -> _FusedState:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        beta = torch.where((s.k == 0) | done, zero, s.rz / _safe(s.rz_prev))
        p, Ap, x, dparts = kA(s.r, s.p, inv, s.x, beta, s.alpha_prev)
        alpha = torch.where(done, zero, s.rz / _safe(dparts.sum(0)))
        r, rzp, rn2p = kB(s.r, Ap, inv, w_free, alpha)
        rz_new = rzp.sum(0)
        rn2_new = rn2p.sum(0)
        k = s.k + (~done).to(s.k.dtype)
        rn2_min = torch.where(done, s.rn2_min,
                              torch.minimum(s.rn2_min, rn2_new))
        # frozen iterations recompute identical rz/rn2 from the unchanged
        # r (and alpha_prev = 0 pins x), so the carried state stays exact
        return _FusedState(x, r, p, rz_new, s.rz, alpha, k, rn2_new,
                           s.max_it, s.stop2, rn2_min)

    return step


def _deferred_step(kA, kB, inv, w_free, zero, m: int):
    """One deferred-x super-iteration: m fused iterations whose kernel A
    skips x, then ``x += sum_j alpha_j P_j`` (per RHS of a stack)."""

    def step(s: _DeferredState) -> _DeferredState:
        r, P, rz, rz_prev, it, rn2, rn2_min = (s.r, list(s.P), s.rz,
                                               s.rz_prev, s.k, s.rn2,
                                               s.rn2_min)
        alphas = []
        for j in range(m):
            done = _done(rn2, it, s.stop2, s.max_it, rn2_min)
            beta = torch.where((it == 0) | done, zero, rz / _safe(rz_prev))
            # the previous direction: written at the preceding unroll
            # position (slot m - 1 of the previous super-iteration for j = 0)
            p_new, Ap, dparts = kA(r, P[(j - 1) % m], inv, beta)
            alpha = torch.where(done, zero, rz / _safe(dparts.sum(0)))
            r, rzp, rn2p = kB(r, Ap, inv, w_free, alpha)
            rn2_new = rn2p.sum(0)
            it = it + (~done).to(it.dtype)
            rn2_min = torch.where(done, rn2_min,
                                  torch.minimum(rn2_min, rn2_new))
            rz_prev, rz, rn2 = rz, rzp.sum(0), rn2_new
            P[j] = p_new
            alphas.append(alpha)
        # frozen iterations ran with alpha = 0: their slots add exactly 0
        return _DeferredState(_catch_up(s.x, alphas, P), r, tuple(P), rz,
                              rz_prev, it, rn2, s.max_it, s.stop2, rn2_min)

    return step


def _catch_up(x: torch.Tensor, alphas, P) -> torch.Tensor:
    """``x + sum_j alphas[j] P[j]`` in float32, in slot order: one RHS
    (0-dim alphas) or per RHS of a (k n, E) stack ((k,) alphas).  The
    first term makes a new tensor, so a saved state's x is never written."""
    out = None
    for a, p in zip(alphas, P):
        if a.dim():
            p = p.view(a.shape[0], -1, p.shape[-1])
            a = _bc(a, p)
        if out is None:
            out = torch.addcmul(x.view(p.shape), a, p)
        else:
            out.addcmul_(a, p)
    return out.view(x.shape)


class _SingleState(NamedTuple):
    """State of the single-kernel iteration: r and x belong to the residual
    the last kernel formed (rn2 and rz_exact are its direct dots); its
    ``alpha_prev * Ap`` (and ``alpha_prev * p``) are applied by the next
    kernel.  ``p``: the direction, or under ``defer_x=m`` a tuple of the
    last m directions (slot j written at unroll position j)."""
    x: torch.Tensor
    r: torch.Tensor
    p: object
    Ap: torch.Tensor
    rz_pred: torch.Tensor
    rz_exact: torch.Tensor
    alpha_prev: torch.Tensor
    k: torch.Tensor
    rn2: torch.Tensor
    max_it: torch.Tensor
    stop2: torch.Tensor
    rn2_min: torch.Tensor


def _single_init(b, inv, w_free, tol, atol, max_iter, p_dtype, m=0):
    """Initial single-kernel state from the residual ``b`` (x0 = 0, Ap0 =
    0, alpha_prev = 0); ``m > 0``: m zero direction slots."""
    s = _fused_init(b, inv, w_free, tol, atol, max_iter, p_dtype)
    p0 = tuple(torch.zeros_like(s.p) for _ in range(m)) if m else s.p
    return _SingleState(s.x, s.r, p0, torch.zeros_like(s.r), s.rz, s.rz,
                        s.alpha_prev, s.k, s.rn2, s.max_it, s.stop2,
                        s.rn2_min)


def _single_scalars(s: _SingleState, done, parts, zero):
    """alpha, the next beta's ``rz_pred`` and the stopping fields from the
    kernel's partials ``[denom, c1, c2, e1, e2]`` (summed over their
    rows)."""
    d = parts.sum(0)
    alpha = torch.where(done, zero, d[3] / _safe(d[0]))
    # one-step prediction of the next <r, z>, used for the next beta only
    rz_pred = d[3] - 2.0 * alpha * d[1] + alpha * alpha * d[2]
    k = s.k + (~done).to(s.k.dtype)
    # frozen iterations: alpha_prev = 0 pins r, so the kernel's direct dots
    # recompute identical e1 / e2 and rn2 stays exact
    rn2_min = torch.where(done, s.rn2_min, torch.minimum(s.rn2_min, d[4]))
    return alpha, rz_pred, d[3], k, d[4], rn2_min


def _single_beta(s: _SingleState, done, zero):
    return torch.where((s.k == 0) | done, zero,
                       s.rz_pred / _safe(s.rz_exact))


def _single_step(kAB, inv, w_free, zero):
    """One single-kernel iteration (see :func:`cg_fused`)."""

    def step(s: _SingleState) -> _SingleState:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        r, p, Ap, x, parts = kAB(s.r, s.Ap, s.p, s.x, inv, w_free,
                                 s.alpha_prev, _single_beta(s, done, zero))
        alpha, rz_pred, rz, k, rn2, rn2_min = _single_scalars(s, done, parts,
                                                              zero)
        return _SingleState(x, r, p, Ap, rz_pred, rz, alpha, k, rn2,
                            s.max_it, s.stop2, rn2_min)

    return step


def _single_deferred_step(kAB, inv, w_free, zero, m: int):
    """One deferred-x single-kernel super-iteration: m kernels without x,
    then x catches up through slot m - 2.  Slot m - 1's alpha stays
    pending (carried as ``alpha_prev``, since the next kernel still owes
    its residual update) and joins the next super-iteration's catch-up,
    so the carried x always matches the carried r and rn2."""

    def step(s: _SingleState) -> _SingleState:
        P = list(s.p)
        pending = (s.alpha_prev, P[m - 1])
        alphas = []
        for j in range(m):
            done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
            r, p_new, Ap, parts = kAB(s.r, s.Ap, P[(j - 1) % m], inv, w_free,
                                      s.alpha_prev,
                                      _single_beta(s, done, zero))
            alpha, rz_pred, rz, k, rn2, rn2_min = _single_scalars(
                s, done, parts, zero)
            P[j] = p_new
            alphas.append(alpha)
            s = s._replace(r=r, Ap=Ap, rz_pred=rz_pred, rz_exact=rz,
                           alpha_prev=alpha, k=k, rn2=rn2, rn2_min=rn2_min)
        x = _catch_up(s.x, [pending[0], *alphas[:m - 1]],
                      [pending[1], *P[:m - 1]])
        return s._replace(x=x, p=tuple(P))

    return step


def _pending(s: _FusedState) -> torch.Tensor:
    """x with its lagged direction applied (0 when frozen), per RHS."""
    return _catch_up(s.x, [s.alpha_prev], [s.p])


def _defer_slots(kA, defer_x, solver: str, factory: str) -> int:
    """m from ``defer_x``, checked against how the kernels were built."""
    built = bool(getattr(kA, "defer_x", False))
    if defer_x:
        if not getattr(kA, "offers_defer_x", True):
            raise ValueError("defer_x is not offered on the general fused "
                             "CG: its kernels carry no deferred-x mode")
        if not built:
            raise ValueError(f"defer_x > 0 requires kernels built with "
                             f"{factory}(defer_x=True)")
        if defer_x < 2 or 64 % defer_x:
            raise ValueError(f"defer_x must divide 64, got {defer_x}")
        return int(defer_x)
    if built:
        raise ValueError(f"kernels built with defer_x=True need "
                         f"{solver}(..., defer_x=m)")
    return 0


def _check_p_dtype(p_dtype):
    p_dtype = torch.float32 if p_dtype is None else p_dtype
    if p_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"p_dtype must be None or bfloat16, got {p_dtype}")
    return p_dtype


def _issue(step, state, n: int, m: int):
    """Run ``n`` iterations: n steps, or n / m deferred super-steps."""
    for _ in range(n // m if m else n):
        state = step(state)
    return state


def cg_fused(
    kA: Callable,
    kB: Callable,
    b: torch.Tensor,
    *,
    inv: torch.Tensor,
    w_free: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 1000,
    p_dtype=None,
    defer_x: int = 0,
    A: Callable | None = None,
) -> CGResult:
    """PCG whose iteration is two fused kernels, or one (float32).

    ``kA(r, p, inv, x, beta, alpha_prev) -> (p', Ap', x', dparts)`` and
    ``kB(r, Ap, inv, w_free, alpha) -> (r', rz_parts, rn2_parts)`` come from
    :func:`..ops.kernels.make_fused_cg_kernels`.  ``b`` is the initial
    residual (the solve starts from x0 = 0), ``inv`` the masked inverse
    diagonal (Jacobi) and ``w_free`` the dot weights zeroed on Dirichlet
    rows.  Iteration k (state x, r, p, rz, rz_prev, alpha_prev)::

        beta  = rz / rz_prev                        (0 at k = 0)
        p, Ap, x, d = kA(r, p, inv, x, beta, alpha_prev)
        alpha = rz / sum(d)
        r, rzp, rn2p = kB(r, Ap, inv, w_free, alpha)
        rz_prev, rz, rn2, alpha_prev = rz, sum(rzp), sum(rn2p), alpha

    x lags one direction; the exit adds the pending ``alpha * p``.  Frozen
    iterations run with alpha = beta = 0, which pins x, r, rz and rn2.
    ``p_dtype=torch.bfloat16`` stores the search direction in bf16.

    ``defer_x=m`` (m >= 2, dividing 64) requires kernels built with
    ``defer_x=True`` (``kA(r, p, inv, beta) -> (p', Ap', dparts)``): the
    loop keeps the last m directions in m slots, slot j rewritten at
    unroll position j of each m-iteration super-iteration (kernel A reads
    slot j - 1), and catches x up once per super-iteration,
    ``x += sum_j alpha_j P_j``.  Ladder blocks are whole super-iterations,
    x is exact at every block boundary, and the r recurrence (hence the
    iteration count) is the same as with ``defer_x=0``.

    **Single-kernel mode**: ``kA`` from :func:`..ops.kernels.
    make_fused_cg_kernel_single` (``kA.single``) and ``kB=None``; one
    kernel per iteration, ``kAB(r, Ap, p, x, inv, w_free, alpha_prev,
    beta) -> (r', p', Ap', x', parts)``, with the residual update deferred
    into the next kernel (r lags one alpha, as x does).  From the summed
    partials ``[denom, c1, c2, e1, e2]``::

        alpha   = e1 / denom            (both direct dots)
        rz_pred = e1 - 2 alpha c1 + alpha^2 c2   (the next <r, z>,
                                                  for the next beta only)
        beta'   = rz_pred / e1

    and the stopping test reads e2, the direct ``||r'||_w^2`` of the
    residual just formed (one iteration later than the pair sees it).
    The carried x matches that residual; the pending ``alpha * p`` is
    dropped at exit.  ``defer_x=m`` drops x from the kernel: x catches up
    through slot m - 2 at each super-iteration's end and slot m - 1's
    alpha, still pending, at the start of the next one's catch-up.

    ``A`` (optional), the masked float32 operator, enables the
    true-residual restart: a ladder block that shrinks ``rn2`` by less
    than 4x while above ``stop`` re-residualizes ``r = b - A x`` from the
    best state and restarts on the correction equation (at most twice),
    keeping the original stop threshold.
    """
    p_dtype = _check_p_dtype(p_dtype)
    single = bool(getattr(kA, "single", False))
    if single and kB is not None:
        raise ValueError("single-kernel CG (make_fused_cg_kernel_single) "
                         "takes kB=None")
    m = _defer_slots(kA, defer_x, "cg_fused",
                     "make_fused_cg_kernel_single" if single
                     else "make_fused_cg_kernels")
    dev = b.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)

    def init(r, tol_t, atol_t, budget):
        if single:
            return _single_init(r, inv, w_free, tol_t, atol_t, budget,
                                p_dtype, m)
        return _fused_init(r, inv, w_free, tol_t, atol_t, budget, p_dtype,
                           None, m)

    if single:
        step = (_single_deferred_step(kA, inv, w_free, zero, m) if m
                else _single_step(kA, inv, w_free, zero))
    else:
        step = (_deferred_step(kA, kB, inv, w_free, zero, m) if m
                else _fused_step(kA, kB, inv, w_free, zero))
    # deferred and single modes: the carried x matches the carried rn2
    x_of = (lambda s: s.x) if m or single else _pending
    state = init(b, torch.tensor(tol, device=dev), zero, max_iter)
    stop2_v = state.stop2          # original target, fixed across restarts

    issued, block = 0, _BLOCK0
    iters_done = 0                  # device iterations from finished legs
    x_off = None                    # accumulated solution of finished legs
    best = (None, state, float("inf"), 0)   # (x_off, state, rn2, iters)
    rn2_ckpt = float(state.rn2)
    restarts = 0
    while issued < max_iter:
        n = _ladder_size(max_iter, issued, block)
        if m:
            n = -(-n // m) * m      # whole super-iterations
        state = _issue(step, state, n, m)
        issued += n
        rn2_now, stop2_now, rn2_min_now = torch.stack(
            [state.rn2, stop2_v, state.rn2_min]).tolist()
        if rn2_now <= best[2]:
            best = (x_off, state, rn2_now, iters_done)
        if (rn2_now <= stop2_now or rn2_now > 1e6 * rn2_min_now
                or not math.isfinite(rn2_now)):
            break
        if (A is not None and restarts < _MAX_RESTARTS and n >= 64
                and rn2_now > 0.25 * rn2_ckpt):
            # stalled leg: re-residualize from the best state so far and
            # restart on the correction equation with the original stop
            restarts += 1
            bx_off, bstate, _, bits = best
            x_leg = x_of(bstate)
            x_acc = x_leg if bx_off is None else bx_off + x_leg
            r_true = b.to(f32) - A(x_acc).to(f32)
            x_off, iters_done = x_acc, bits + int(bstate.k)
            state = init(r_true, zero, torch.sqrt(stop2_v), max_iter - issued)
            rn2_ckpt = float(state.rn2)
            if rn2_ckpt <= best[2]:
                best = (x_off, state, rn2_ckpt, iters_done)
            block = _BLOCK0
            continue
        rn2_ckpt = rn2_now
        block = min(block * 2, _BLOCK_MAX)

    bx_off, bstate, _, bits = best
    k_dev = bstate.k
    x = x_of(bstate)
    if bx_off is not None:
        x = bx_off + x
        k_dev = k_dev + bits
    return CGResult(x, k_dev, torch.sqrt(bstate.rn2),
                    bstate.rn2 <= stop2_v, issued)


def cg_fused_batched(
    kA: Callable,
    kB: Callable,
    B: torch.Tensor,
    *,
    inv: torch.Tensor,
    w_free: torch.Tensor,
    tol: float = 1e-6,
    max_iter: int = 1000,
    p_dtype=None,
    defer_x: int = 0,
    A: Callable | None = None,
) -> CGResult:
    """Batched-RHS twin of :func:`cg_fused`.

    ``kA``/``kB`` come from :func:`..ops.kernels.
    make_fused_cg_kernels_batched` built for k RHS; ``B`` stacks k initial
    residuals as (k, n, E) or (k n, E).  The kernels read ``inv``,
    ``w_free`` and the operator once per iteration for all k solves; each
    RHS carries its own alpha, beta and stopping state and freezes
    independently (alpha = 0).  One host ladder serves all k solves, with
    the best block-boundary state kept per RHS.

    ``defer_x=m`` as in :func:`cg_fused`, with a per-RHS catch-up.

    ``A`` (optional): the masked float32 operator on flat (k n, E) stacks.
    Unlike :func:`cg_fused`'s stall test, each finished leg's solution is
    *verified* against the true residual ``b - A x``: when any RHS misses
    the original stop, the solve restarts on the correction equation for
    the whole stack (at most twice), since with bf16
    directions the recurrence can claim a convergence that the solution
    has not reached.  ``residual_norm`` and ``converged`` then refer to the
    true residual of the last check.

    Returns a batched :class:`CGResult` with ``x`` shaped (k, n, E).
    """
    if getattr(kA, "single", False):
        raise ValueError("the single-kernel CG iteration has one RHS: use "
                         "cg_fused")
    k = int(getattr(kA, "n_rhs", 1))
    p_dtype = _check_p_dtype(p_dtype)
    n_loc = inv.shape[0]
    if B.dim() == 3:
        kk = B.shape[0]
        B2 = B.reshape(kk * B.shape[1], B.shape[2])
    else:
        B2, kk = B, B.shape[0] // n_loc
    if kk != k or B2.shape[0] != k * n_loc:
        raise ValueError(f"B batch size {kk} != kernel n_rhs {k}")
    m = _defer_slots(kA, defer_x, "cg_fused_batched",
                     "make_fused_cg_kernels_batched")
    f32 = torch.float32
    dev = B2.device
    zero = torch.zeros((), dtype=f32, device=dev)
    step = (_deferred_step(kA, kB, inv, w_free, zero, m) if m
            else _fused_step(kA, kB, inv, w_free, zero))

    def select(mask, new, old):
        return _select_best_fused(mask, new, old, n_loc)

    def run_leg(b_leg, tol_leg, atol_leg, budget):
        state = _fused_init(b_leg, inv, w_free, tol_leg, atol_leg, budget,
                            p_dtype, k, m)
        issued, blk = 0, _BLOCK0
        best_state, best_rn2 = state, np.full(k, np.inf)
        while issued < budget:
            n = _ladder_size(budget, issued, blk)
            if m:
                n = -(-n // m) * m  # whole super-iterations
            state = _issue(step, state, n, m)
            issued += n
            rn2, stop2, rn2m = torch.stack(
                [state.rn2, state.stop2, state.rn2_min]).cpu().numpy()
            best_state, best_rn2 = _keep_best(rn2, best_rn2, state,
                                              best_state, select)
            if ((rn2 <= stop2) | (rn2 > 1e6 * rn2m)
                    | ~np.isfinite(rn2)).all():
                break
            blk = min(blk * 2, _BLOCK_MAX)
        return best_state, issued

    B2f = B2.to(f32)
    wf = w_free.to(f32)
    x_tot, stop2_v = None, None
    issued_total = 0
    iters_total = torch.zeros(k, dtype=torch.int32, device=dev)
    b_leg = B2f
    tol_leg, atol_leg = torch.tensor(tol, dtype=f32, device=dev), zero
    for leg in range(_MAX_RESTARTS + 1):
        best_state, issued = run_leg(b_leg, tol_leg, atol_leg,
                                     max_iter - issued_total)
        issued_total += issued
        # deferred mode caught x up at the block boundary; otherwise x
        # lags one direction per RHS
        x = best_state.x if m else _pending(best_state)
        if stop2_v is None:
            stop2_v = best_state.stop2             # (k,) original target
        x_tot = x if x_tot is None else x_tot + x
        iters_total = iters_total + best_state.k
        rn2_final = best_state.rn2
        if A is None or leg == _MAX_RESTARTS or issued_total >= max_iter:
            break
        r_true = B2f - A(x_tot).to(f32)
        r3 = r_true.view(k, n_loc, -1)
        rn2_final = (wf * r3 * r3).sum((1, 2))
        if bool(torch.all(rn2_final <= stop2_v)):
            break
        # the recurrence claimed more progress than the solution has:
        # restart on the correction equation with the original stop
        b_leg, tol_leg, atol_leg = r_true, zero, torch.sqrt(stop2_v)
    return CGResult(x_tot.view(k, n_loc, -1), iters_total,
                    torch.sqrt(rn2_final), rn2_final <= stop2_v,
                    issued_total)


def _select_best_fused(improved: torch.Tensor, new, old, n_loc: int):
    """Per-RHS merge of two :func:`cg_fused_batched` states: the (k n, E)
    stacks by their RHS's rows, the (k,) vectors elementwise, the deferred
    direction slots each."""
    rows = improved.repeat_interleave(n_loc)[:, None]

    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(u, v) for u, v in zip(a, b))
        return torch.where(rows if a.dim() == 2 else improved, a, b)

    return type(new)(*(sel(a, b) for a, b in zip(new, old)))


def hbm_residency_regime(E: int, n_loc: int, itemsize: int = 4) -> bool:
    """True once an (n, E) iterate exceeds 100 MB: the reference's
    threshold behind its ``defer_x`` and batched auto policies, kept so
    that ``"auto"`` resolves as in the JAX package.  It was set for the
    TPU's on-chip memory; re-deriving it for the H100 is ROADMAP work."""
    return E * n_loc * itemsize > 100_000_000


def auto_defer_x(E: int, n_loc: int, itemsize: int = 4) -> int:
    """``defer_x="auto"`` of ``solve_local``: 8 above
    :func:`hbm_residency_regime`'s threshold, else 0."""
    return 8 if hbm_residency_regime(E, n_loc, itemsize) else 0


def auto_defer_x_batched(E: int, n_loc: int, k: int,
                         itemsize: int = 4) -> int:
    """``defer_x="auto"`` of ``solve_local_batch``: 8 for every batch of
    k >= 2 (or above the threshold), else 0 — the reference's policy."""
    if k >= 2 or hbm_residency_regime(E, n_loc, itemsize):
        return 8
    return 0


def jacobi_preconditioner(diag: torch.Tensor,
                          free_mask: torch.Tensor | None = None):
    """Inverse-diagonal preconditioner; safe where the diagonal is 0 or
    masked."""
    inv = 1.0 / _safe(diag)
    if free_mask is not None:
        inv = torch.where(free_mask, inv, torch.zeros_like(inv))

    def M(r):
        return inv * r

    return M
