"""Matrix-free restarted GMRES on PyTorch tensors (device Arnoldi, host
restart loop).

Port of the JAX package's ``solver/gmres.py``: the Krylov solver for the
nonsymmetric operators of the port — advection-diffusion
(:mod:`..models.advection_diffusion`) and the squirmer's GMRES-IR Newton
correction (:mod:`..models.squirmer`).

One restart cycle is m Arnoldi steps (modified Gram-Schmidt) on the
device, then the Givens rotations of the (m+1, m) Hessenberg least-squares
problem and the back-substitution on the host, in float64 and in the
reference's order, so float64 iteration counts match; the update is formed
on the device.  The host reads once per restart cycle (the residual norms,
the Hessenberg columns and the stops, in one transfer) and never inside
one.  The reference freezes a converged cycle with ``lax.cond``; here every
Arnoldi step of the cycle runs and the columns after convergence go
unused (the same numbers).  A batch of cycles stops at the first cycle
after which every right-hand side is done, where the reference's frozen
cycles would change nothing.  The reference's ladder of batches (2, 4, 8,
16, 16, ... cycles) is kept, because the stall test of ``stall_ratio``
starts afresh in each batch.  (On float32 vectors the host's rotations
are float64, where the reference's are float32.)

The reference's ``hoist_closure`` (a JAX trace-cache mechanism) has no
counterpart: ``A``, ``M`` and ``dot`` are called as they are.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch


def _identity_M(r):
    return r


def _euclidean_dot(u, v):
    return torch.sum(u * v)


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    converged: torch.Tensor


def _lift(f: Callable) -> Callable:
    """``f`` of one vector, applied to each vector of a (k, ...) stack."""

    def apply(X):
        if X.shape[0] == 1:
            return f(X[0]).unsqueeze(0)
        return torch.stack([f(x) for x in X])

    return apply


def _lift_dot(dot: Callable) -> Callable:
    """``dot`` of two vectors, per RHS of two (k, ...) stacks: (k,)."""

    def apply(U, V):
        if U.shape[0] == 1:
            return dot(U[0], V[0]).reshape(1)
        return torch.stack([dot(u, v) for u, v in zip(U, V)])

    return apply


def _bc(s: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Broadcast (k,) per-RHS values against a (k, ...) stack."""
    return s.reshape(s.shape + (1,) * (X.dim() - 1))


def _ftype(dtype: torch.dtype) -> torch.dtype:
    """The reference's ``result_type(dtype, float32)``."""
    return torch.promote_types(dtype, torch.float32)


def gmres(
    A: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    M: Callable | None = None,
    tol: float = 1e-10,
    atol: float = 0.0,
    restart: int = 30,
    max_restarts: int = 50,
    dot: Callable | None = None,
    stall_ratio: float | None = None,
) -> GMRESResult:
    """Solve ``A x = b`` (A nonsymmetric OK) with left-preconditioned
    restarted GMRES(restart).

    ``M`` approximates A^-1 (applied to residuals); ``dot`` defines the
    inner product (e.g. multiplicity-weighted for L-vectors).  Stops when
    the preconditioned residual norm <= max(tol * ||M b||, atol).

    ``stall_ratio`` (None = off) freezes a solve whose restart cycle
    fails to shrink the residual below ``stall_ratio * rn_prev`` while
    still above ``stop`` — the attainable-accuracy-floor cutoff the
    squirmer's GMRES-IR path uses (0.5 there).  Off by default: a
    slow-but-converging solve must keep its full restart budget.

    The fields of the result are device tensors; ``iterations`` counts the
    Arnoldi steps that ran before convergence, as in the reference.
    """
    if M is None:
        M = _identity_M
    if dot is None:
        dot = _euclidean_dot
    if x0 is None:
        x0 = torch.zeros_like(b)
    res = _gmres_stacked(_lift(A), b.unsqueeze(0), x0.unsqueeze(0),
                        M=_lift(M), dot=_lift_dot(dot), tol=tol, atol=atol,
                        restart=restart, max_restarts=max_restarts,
                        stall_ratio=stall_ratio)
    return GMRESResult(*(f[0] for f in res))


def gmres_batched(
    A: Callable,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    M: Callable | None = None,
    tol: float = 1e-10,
    atol: float = 0.0,
    restart: int = 30,
    max_restarts: int = 50,
    dot: Callable | None = None,
    stall_ratio: float | None = None,
) -> GMRESResult:
    """Solve ``A x_j = b_j`` for a batch of RHS with restarted GMRES.

    The batched twin of :func:`gmres`: ``B`` stacks k right-hand sides on
    a leading axis; ``A``, ``M`` and ``dot`` act on one vector each (the
    reference's ``vmap``), so each step calls them once per RHS (callers
    whose operators take the whole stack call :func:`_gmres_stacked`).
    Each RHS carries its own Arnoldi state and convergence/stagnation
    freeze, and ONE host ladder drives all k solves.  Returns a
    :class:`GMRESResult` with batched fields.
    """
    if M is None:
        M = _identity_M
    if dot is None:
        dot = _euclidean_dot
    return _gmres_stacked(_lift(A), B, X0, M=_lift(M), dot=_lift_dot(dot),
                         tol=tol, atol=atol, restart=restart,
                         max_restarts=max_restarts, stall_ratio=stall_ratio)


def _gmres_stacked(A: Callable, B: torch.Tensor,
                  X0: torch.Tensor | None = None, *, M: Callable,
                  dot: Callable, tol: float = 1e-10, atol: float = 0.0,
                  restart: int = 30, max_restarts: int = 50,
                  stall_ratio: float | None = None) -> GMRESResult:
    """:func:`gmres_batched` for operators that take the whole (k, ...)
    stack: ``A`` and ``M`` map a stack to a stack in one call, ``dot``
    returns the (k,) per-RHS inner products.  The ladder of restart-cycle
    batches (2, 4, 8, 16, 16, ...) of both entry points."""
    if X0 is None:
        X0 = torch.zeros_like(B)
    cycles = _gmres_cycles(A, M, dot, int(restart), stall_ratio)
    MB = M(B)
    bnorms = torch.sqrt(dot(MB, MB)).to(_ftype(B.dtype))
    stops = torch.clamp(tol * bnorms, min=atol)

    X = X0
    total_its = torch.zeros(B.shape[0], dtype=torch.int32, device=B.device)
    rnorm = None
    issued, batch = 0, 2
    while issued < max_restarts:
        k = min(batch, max_restarts - issued)
        X, rnorm, its, done_h = cycles(k, X, B, stops)
        total_its = total_its + its
        issued += k
        if done_h.all():
            break
        batch = min(batch * 2, 16)
    return GMRESResult(X, total_its, rnorm, rnorm <= stops)


def _givens(beta: float, cols, stop: float, m: int):
    """The reference's Givens rotations and back-substitution of one cycle
    of one RHS, on the host in float64 (Python floats: IEEE double, the
    reference's operations in its order).

    ``cols[j]``: the Arnoldi column j (``j + 2`` values: the MGS
    coefficients and the new norm).  Returns ``(y, its, rnorm)``: the
    update's coefficients (``its`` of them), the steps taken before the
    residual estimate reached ``stop``, and ``|g[its]|``.
    """
    g = [0.0] * (m + 1)
    g[0] = beta
    cs, sn, R = [], [], []
    done = beta <= stop
    its = 0
    for j in range(m):
        if done:
            break
        h = list(cols[j])
        for i in range(j):
            hi = cs[i] * h[i] + sn[i] * h[i + 1]
            hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i], h[i + 1] = hi, hi1
        denom = math.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
        if denom == 0:
            denom = 1.0
        c, s = h[j] / denom, h[j + 1] / denom
        h[j] = c * h[j] + s * h[j + 1]
        gj = g[j]
        g[j], g[j + 1] = c * gj, -s * gj
        cs.append(c)
        sn.append(s)
        R.append(h)
        its += 1
        done = abs(g[j + 1]) <= stop
    # back-substitute the its x its triangular system (R[l][i]: row i of
    # column l)
    y = [0.0] * its
    for i in range(its - 1, -1, -1):
        num = g[i] - sum(R[l][i] * y[l] for l in range(i + 1, its))
        hii = R[i][i] if R[i][i] != 0 else 1.0
        y[i] = num / hii
    return y, its, abs(g[min(its, m)])


def _arnoldi(A: Callable, M: Callable, dot: Callable, m: int, X, B):
    """m Arnoldi steps (modified Gram-Schmidt) from the preconditioned
    residual of each RHS of the (k, ...) stack ``X``, on the device:
    ``(V, beta, cols)``, the basis (m + 1, k, ...) (each basis stack one
    contiguous block), the residual norms (k,) and the Hessenberg columns,
    column j a (k, j + 2) tensor."""
    R = M(B - A(X))
    beta = torch.sqrt(dot(R, R))
    one = torch.ones((), dtype=beta.dtype, device=R.device)
    V = torch.empty((m + 1,) + R.shape, dtype=R.dtype, device=R.device)
    V[0] = R / _bc(torch.where(beta != 0, beta, one), R)
    cols = []
    for j in range(m):
        W = M(A(V[j]))
        hs = []
        for i in range(j + 1):
            hij = dot(V[i], W)
            W = W - _bc(hij, W) * V[i]
            hs.append(hij)
        hnext = torch.sqrt(dot(W, W))
        hs.append(hnext)
        V[j + 1] = W / _bc(torch.where(hnext != 0, hnext, one), W)
        cols.append(torch.stack(hs, dim=1))
    return V, beta, cols


def _gmres_cycles(A, M, dot, m: int, stall_ratio: float | None = None):
    """Up to k GMRES(m) restart cycles per call with a per-RHS
    convergence freeze.

    ``A``, ``M`` and ``dot`` act on (k, ...) stacks (``dot`` returns the
    (k,) per-RHS inner products).  Returns ``cycles(k, X, B, stops) ->
    (X, rnorm, its, done)``: ``stops`` the (k,) device tensor of stopping
    norms; ``rnorm`` and ``its`` (k,) device tensors (the last residual
    norm and the Arnoldi steps of this call), ``done`` the (k,) host bool
    vector (converged OR stagnated).  The call returns at the first cycle
    after which every RHS is done, and each call starts its stall test
    afresh (``rn_prev`` = inf), as the reference's dispatch does.

    A cycle runs its m Arnoldi steps on the device, reads the residual
    norms, the Hessenberg columns and the stops to the host in one
    transfer (the one read of the cycle), and applies the Givens rotations
    there (:func:`_givens`); the update is formed on the device from the
    basis vectors of the steps taken.  The reference skips the steps after
    convergence; here they run and their columns go unused, which gives
    the same numbers.

    With ``stall_ratio`` set, a cycle that fails to shrink the residual
    below ``stall_ratio * rn_prev`` while still above ``stop`` also
    freezes (stagnation at the attainable-accuracy floor: with a
    reduced-precision preconditioner, ``stop`` relative to a tiny rhs can
    sit below what the arithmetic can reach).  Callers distinguish the two
    exits by comparing the returned ``rnorm`` against ``stop``.
    """

    def cycles(k: int, X, B, stops):
        n_rhs = B.shape[0]
        dev = B.device
        rn = [math.inf] * n_rhs
        its = [0] * n_rhs
        done = np.zeros(n_rhs, dtype=bool)
        for _ in range(k):
            V, beta, cols = _arnoldi(A, M, dot, m, X, B)
            host = torch.cat([stops.to(beta.dtype), beta]
                             + [c.reshape(-1) for c in cols]).tolist()
            stop_h, beta_h = host[:n_rhs], host[n_rhs:2 * n_rhs]
            off = 2 * n_rhs
            col_h = []
            for j in range(m):       # column j: (k, j + 2), row-major
                w = j + 2
                col_h.append([host[off + r * w: off + (r + 1) * w]
                              for r in range(n_rhs)])
                off += n_rhs * w
            dX = torch.zeros_like(X)
            for r in range(n_rhs):
                if done[r]:
                    continue
                y, dk, rn2 = _givens(beta_h[r], [c[r] for c in col_h],
                                     stop_h[r], m)
                if dk:
                    yv = torch.tensor(y, dtype=V.dtype, device=dev)
                    dX[r] = torch.matmul(
                        yv, V[:dk, r].reshape(dk, -1)).reshape(X.shape[1:])
                d = rn2 <= stop_h[r]
                if stall_ratio is not None:
                    d = d or (rn2 > stall_ratio * rn[r] and rn2 > stop_h[r])
                rn[r], its[r], done[r] = rn2, its[r] + dk, d
            X = X + dX
            if done.all():
                break
        return (X, torch.tensor(rn, dtype=_ftype(B.dtype), device=dev),
                torch.tensor(its, dtype=torch.int32, device=dev), done)

    return cycles
