"""Chain-differenced device timing (a PyTorch port of the JAX package's
``utils/timing.py``).

A single timed call measures launch and synchronization overhead along
with the work.  :func:`time_step` instead times salted chains of ``reps``
and ``2 * reps`` applications of a shape-preserving step and divides the
difference by ``reps``, which subtracts every fixed per-chain cost (the
first launch, the final synchronization, the salt).  On the card each
chain is timed by CUDA events recorded on the current stream around it;
on the CPU by the host clock.  The salt (the input scaled by a per-call
unique ``1 + s``) keeps the design of the reference, whose remote backend
could return a cached result for a repeated call.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _leaves(x) -> list:
    """The tensors of a nested tuple / list / dict of results."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _leaves(item)]
    return []


def sync(x) -> float:
    """Wait for the work that produced ``x``: synchronize the current CUDA
    stream when any tensor of ``x`` lies on the card.

    Returns the sum of the first element of each tensor (a cheap checksum,
    as the reference's scalar pull is), or 0.0 when ``x`` holds none.
    """
    leaves = [t for t in _leaves(x) if t.numel()]
    if any(t.is_cuda for t in leaves):
        torch.cuda.current_stream(leaves[0].device).synchronize()
    acc = 0.0
    for t in leaves:
        v = t.reshape(-1)[0]
        acc += float(v.real) if v.is_complex() else float(v)
    return acc


def _chain(step, x, n_reps: int, salt: float, consts):
    """``n_reps`` chained applications of ``step`` on a salted input."""
    v = x * (1.0 + salt)
    for _ in range(n_reps):
        v = step(v, *consts)
    return v


def time_step(step: Callable, x0, reps: int = 50, tries: int = 3,
              max_reps: int = 4096, consts=()) -> dict:
    """Per-application seconds of ``step`` (y = step(x, *consts), same
    shape as x).

    Dispatch-differenced: times salted chains of ``reps`` and
    ``2 * reps`` applications (best of ``tries``, each call's salt
    unique) and divides the difference.  Grows ``reps`` until the two
    differ by >5%; reports ``reliable=False`` if they never do, and
    refuses (t=nan) when the implied time is non-positive.  On a CUDA
    tensor each chain is timed by CUDA events, on the CPU by the host
    clock; one untimed chain of ``reps`` warms the step up first.
    """
    salt_ctr = iter(range(1, 1 << 30))
    consts = tuple(consts)
    on_card = x0.is_cuda

    def run(n):
        best = float("inf")
        for _ in range(tries):
            s = next(salt_ctr) * 1e-7
            if on_card:
                torch.cuda.synchronize(x0.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _chain(step, x0, n, s, consts)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                sync(_chain(step, x0, n, s, consts))
                dt = time.perf_counter() - t0
            best = min(best, dt)
        return best

    sync(_chain(step, x0, reps, 0.0, consts))                 # warm-up
    t_n, t_2n = run(reps), run(2 * reps)
    reliable = True
    while t_2n - t_n < 0.05 * t_n and reps < max_reps:
        reps *= 4
        t_n, t_2n = run(reps), run(2 * reps)
    if t_2n - t_n < 0.05 * t_n:
        reliable = False
    dt = t_2n - t_n
    t_apply = dt / reps if dt > 0 else float("nan")
    return {"t_apply": t_apply, "reliable": reliable and dt > 0,
            "reps": reps, "t_n": t_n, "t_2n": t_2n}
