"""Matrix-free preconditioned conjugate gradients (PyTorch port).

Port of the main-path solvers of the JAX package's ``solver/cg.py``:

* :func:`cg` — PCG with the ``dot_weight`` fold, run as a block ladder
  (64 iterations first, doubling to 4096) with one host synchronisation
  per block.  Converged, budget-spent and diverged states freeze inside a
  block (alpha = 0), so results match an exactly-stopping loop;
* :func:`cg_fused` — PCG whose iteration is the two fused kernels of
  :mod:`..ops.kernels`, with x lagging one direction and the true-residual
  restart;
* :func:`jacobi_preconditioner`.

Each iteration is a Python loop over device tensors: the scalars (alpha,
beta, the stopping state) stay on the device and are read back once per
block.  ``defer_x``, the refined/certified solvers and the batched
solvers are not ported yet (ROADMAP Queue 1 items 1, 2 and 5).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

#: first ladder block and its cap: one host synchronisation per block
_BLOCK0, _BLOCK_MAX = 64, 4096
#: true-residual restarts of cg_fused at most
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


def cg(
    A: Callable,
    b: torch.Tensor,
    *,
    M: Callable | None = None,
    tol: float = 1e-12,
    max_iter: int = 1000,
    dot_weight: torch.Tensor | None = None,
) -> CGResult:
    """Solve ``A x = b`` with preconditioned CG from ``x0 = 0``.

    ``A``: SPD operator; ``M``: preconditioner approximating ``A^-1``.
    ``dot_weight``: diagonal weights of the inner product
    ``<u, v> = sum(w u v)`` (multiplicity weights for L-vectors; Euclidean
    when None); the body folds the weight into each vector pass once
    (``w*Ap``, ``w*z``).  Stops when ``||r|| <= tol ||b||`` in the
    dot-induced norm.
    """
    if M is None:
        M = _identity
    w = dot_weight

    def wsum(u, v):
        return torch.sum(u * v) if w is None else torch.sum(u * v * w)

    def fold(v):
        return v if w is None else w * v

    dev = b.device
    x0 = torch.zeros_like(b)
    r0 = b - A(x0)
    z0 = M(r0)
    rn0 = wsum(r0, r0)
    state = _State(x0, r0, z0, z0, wsum(r0, z0), rn0,
                   torch.zeros((), dtype=torch.int32, device=dev),
                   tol * tol * wsum(b, b),
                   torch.tensor(max_iter, dtype=torch.int32, device=dev),
                   rn0)
    zero = torch.zeros((), dtype=b.dtype, device=dev)

    def step(s: _State) -> _State:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        Ap = A(s.p)
        denom = torch.sum(s.p * fold(Ap))
        alpha = torch.where(done, zero, s.rz / _safe(denom))
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = M(r)
        rz_n = torch.sum(r * fold(z))
        rn2 = wsum(r, r)
        beta = rz_n / _safe(s.rz)
        p = z + beta * s.p
        k = s.k + (~done).to(s.k.dtype)
        rn2_min = torch.where(done, s.rn2_min, torch.minimum(s.rn2_min, rn2))
        return _State(x, r, z, p, rz_n, rn2, k, s.stop2, s.max_it, rn2_min)

    issued, block = 0, _BLOCK0
    best_state, best_rn2 = state, float("inf")
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
        block = min(block * 2, _BLOCK_MAX)

    # on breakdown/divergence, fall back to the best block-boundary state
    s = best_state
    return CGResult(s.x, s.k, torch.sqrt(s.rn2), s.rn2 <= s.stop2, issued)


def _identity(r):
    return r


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


def _fused_init(b, inv, w_free, tol, atol, max_iter, p_dtype):
    r0 = b.to(torch.float32)
    dev = r0.device
    x0 = torch.zeros_like(r0)
    # beta = 0 at k = 0 makes p1 = z0
    p0 = torch.zeros_like(r0, dtype=p_dtype)
    wf = w_free.to(torch.float32)
    rn0 = torch.sum(wf * r0 * r0)
    rz0 = torch.sum(wf * r0 * (inv.to(torch.float32) * r0))
    stop2 = torch.maximum(tol * tol * rn0, atol * atol)
    return _FusedState(x0, r0, p0, rz0, rz0,
                       torch.zeros((), dtype=torch.float32, device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev), rn0,
                       torch.tensor(max_iter, dtype=torch.int32, device=dev),
                       stop2, rn0)


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
    A: Callable | None = None,
) -> CGResult:
    """PCG whose iteration is two fused kernels (float32).

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

    ``A`` (optional), the masked float32 operator, enables the
    true-residual restart: a ladder block that shrinks ``rn2`` by less
    than 4x while above ``stop`` re-residualizes ``r = b - A x`` from the
    best state and restarts on the correction equation (at most twice),
    keeping the original stop threshold.
    """
    p_dtype = torch.float32 if p_dtype is None else p_dtype
    if p_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"p_dtype must be None or bfloat16, got {p_dtype}")
    dev = b.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    state = _fused_init(b, inv, w_free, torch.tensor(tol, device=dev),
                        zero, max_iter, p_dtype)
    stop2_v = state.stop2          # original target, fixed across restarts

    def step(s: _FusedState) -> _FusedState:
        done = _done(s.rn2, s.k, s.stop2, s.max_it, s.rn2_min)
        beta = torch.where((s.k == 0) | done, zero, s.rz / _safe(s.rz_prev))
        p, Ap, x, dparts = kA(s.r, s.p, inv, s.x, beta, s.alpha_prev)
        alpha = torch.where(done, zero, s.rz / _safe(torch.sum(dparts)))
        r, rzp, rn2p = kB(s.r, Ap, inv, w_free, alpha)
        rz_new = torch.sum(rzp)
        rn2_new = torch.sum(rn2p)
        k = s.k + (~done).to(s.k.dtype)
        rn2_min = torch.where(done, s.rn2_min,
                              torch.minimum(s.rn2_min, rn2_new))
        # frozen iterations recompute identical rz/rn2 from the unchanged
        # r (and alpha_prev = 0 pins x), so the carried state stays exact
        return _FusedState(x, r, p, rz_new, s.rz, alpha, k, rn2_new,
                           s.max_it, s.stop2, rn2_min)

    def x_of(s: _FusedState) -> torch.Tensor:
        # x lags one direction: apply the pending update (0 when frozen)
        return s.x + s.alpha_prev * s.p.to(s.x.dtype)

    issued, block = 0, _BLOCK0
    iters_done = 0                  # device iterations from finished legs
    x_off = None                    # accumulated solution of finished legs
    best = (None, state, float("inf"), 0)   # (x_off, state, rn2, iters)
    rn2_ckpt = float(state.rn2)
    restarts = 0
    while issued < max_iter:
        n = _ladder_size(max_iter, issued, block)
        for _ in range(n):
            state = step(state)
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
            state = _fused_init(r_true, inv, w_free, zero,
                                torch.sqrt(stop2_v), max_iter - issued,
                                p_dtype)
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
