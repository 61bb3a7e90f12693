#!/usr/bin/env python3
"""Compare the PyTorch port's kernels and curved-mesh solves between source
trees on one card.

    python3 scripts/torch_ab_general.py TREE_A TREE_B [--steady 512,1536]

Each TREE is the root of a checkout holding ``spectralelementmethod_torch``
and ``chip_smoke.py`` (for example the parent commit unpacked with
``git archive`` beside this one).  The trees run in the order A, B, B, A,
each in its own process, so that a drift of the card over the call shows
as a difference between the two runs of one tree.  Each run:

* runs the tree's own ``chip_smoke.py`` up to its phase 3: the build (the
  compiler's register, shared-memory and spill report of every n = 81
  kernel is kept) and phase 2, which holds every kernel against its plain
  version and times it (CUDA events, inputs rotated past the L2) at the
  main path's shapes, E = 99,856 and n = 81, f32, k = 4 when batched;
* solves on that script's polar half-annulus (plain, fused and
  bf16-direction fused CG, one RHS and k = 4), on its rectangle with the
  general apply forced (``structure="general"``) and the Helmholtz problem
  in its default ``ne`` layout, to 2e-3 (and curved plain and fused to
  1e-4), and records the iterations;
* measures those modes' steady state (tol 0, the two iteration counts of
  ``--steady``; Helmholtz 128 and 384: the difference of the host times
  over the difference of the issued iterations, per RHS; twice, the modes
  in mirrored order);
* profiles 512 iterations of curved plain CG and of the curved
  bf16-direction fused CG (device time per iteration by kernel, busy
  share).

Prints one JSON line per run (the phase-2 rows' ms, the solves, the
compiler report), then the card's name and power limit; the runs' full
logs go to ``chiprun_out/ab_general_*.log``.  Needs one CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import ab_common

K = 4                  # right-hand sides of the batched solves
PROFILE_ITERS = 512


def _tail(L: dict, steady: tuple[int, int]) -> dict:
    """The curved solves, their steady state and two profiles, from the
    locals of ``chip_smoke.main`` at the start of its phase 3."""
    import numpy as np
    import torch

    tol_all, tol_f32 = 2e-3, 1e-4
    aprob, prob, hprob = L["aprob"], L["prob"], L["hprob"]
    F = np.concatenate([np.ones((1, aprob.disc.n_nodes)),
                        np.random.RandomState(7).standard_normal(
                            (K - 1, aprob.disc.n_nodes))])
    bf16 = dict(p_dtype=torch.bfloat16)
    modes = {"curved-plain": (aprob, 1, dict(cg_kernel="plain")),
             "curved-fused": (aprob, 1, dict(cg_kernel="fused")),
             "curved-fused-bf16p": (aprob, 1, dict(cg_kernel="auto", **bf16)),
             "curved-batch-plain": (aprob, K, dict(cg_kernel="plain")),
             "curved-batch-fused": (aprob, K, dict(cg_kernel="fused")),
             "curved-batch-fused-bf16p": (aprob, K,
                                          dict(cg_kernel="fused", **bf16)),
             "general-plain": (prob, 1, dict(cg_kernel="plain",
                                             structure="general")),
             "helm-ne": (hprob, 1, {})}

    def solve(name, **opts):
        p_, k, kw = modes[name]
        if k > 1:
            return p_.solve_local_batch(F, **kw, **opts)
        return p_.solve_local(**kw, **opts)

    out = dict(rows_ms={r["name"]: r["ms"] for r in L["rows"]},
               ptxas=ab_common.ptxas_report(L["logs"],
                                            lambda ln: "Li81E" in ln),
               iterations={}, steady={}, profiles={})
    runs = [(m, tol_all) for m in modes] + [("curved-plain", tol_f32),
                                            ("curved-fused", tol_f32)]
    for name, tol in runs:
        sol = solve(name, tol=tol, max_iter=20000)
        out["iterations"][f"{name}@{tol:g}"] = np.atleast_1d(
            sol.cg.iterations.cpu().numpy()).tolist()
    for order in (list(modes), list(modes)[::-1]):
        for name in order:
            its = (128, 384) if name == "helm-ne" else steady
            ts = []
            for it in its:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = solve(name, tol=0.0, max_iter=it)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0, sol.cg.issued))
            out["steady"].setdefault(name, []).append(
                1e3 * (ts[1][0] - ts[0][0]) / (ts[1][1] - ts[0][1])
                / modes[name][1])
    for name in ("curved-plain", "curved-fused-bf16p"):
        out["profiles"][name] = ab_common.profile(
            lambda: solve(name, tol=0.0, max_iter=PROFILE_ITERS),
            PROFILE_ITERS)
    return out


def run_tree(root: Path, steady: tuple[int, int]) -> dict:
    """The tree's chip_smoke.py up to its phase 3, then :func:`_tail`."""
    return ab_common.through_phase2(root, lambda L: _tail(L, steady))


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, __doc__, "general", run_tree,
                            steady="512,1536"))
