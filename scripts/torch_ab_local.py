#!/usr/bin/env python3
"""Compare the PyTorch port's kernels, its Helmholtz ``en`` solves and its
far-split solve between source trees on one card.

    python3 scripts/torch_ab_local.py TREE_A TREE_B [--steady 512,1536]

Each TREE is the root of a checkout holding ``spectralelementmethod_torch``
and ``chip_smoke.py`` (for example the parent commit unpacked with
``git archive`` beside this one).  The trees run in the order A, B, B, A,
each in its own process, so that a drift of the card over the call shows
as a difference between the two runs of one tree.  Each run:

* runs the tree's own ``chip_smoke.py`` up to its phase 3: the build (the
  compiler's register, shared-memory and spill report of every n = 81
  kernel and of the far update is kept) and phase 2, which holds every
  kernel against its plain version and times it (CUDA events, inputs
  rotated past the L2) at the main path's shapes, E = 99,856 and n = 81,
  f32, k = 4 when batched;
* solves the Helmholtz problem of that script (BASELINE config 3 on its
  polar half-annulus) in the ``en`` layout with the element-local kernel,
  one RHS and k = 4, and plain CG on its rectangle with the far-split apply
  (``max_halo=128``), to 2e-3, and records the iterations;
* measures those modes' steady state (tol 0; Helmholtz 128 and 384
  iterations, the far split the two counts of ``--steady``: the difference
  of the host times over the difference of the issued iterations, per
  RHS; twice, the modes in mirrored order);
* profiles 128 iterations of each Helmholtz mode and 512 of the far-split
  solve (device time per iteration by kernel, busy share).

Prints one JSON line per run (the phase-2 rows' ms, the solves, the
compiler report), then the card's name and power limit; the runs' full
logs go to ``chiprun_out/ab_local_*.log``.  Needs one CUDA card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import ab_common

K = 4                  # right-hand sides of the batched Helmholtz solve
HELM_STEADY = (128, 384)
HELM_PROFILE = 128
FAR_PROFILE = 512


def _tail(L: dict, steady: tuple[int, int]) -> dict:
    """The Helmholtz ``en`` and far-split solves, their steady state and
    profiles, from the locals of ``chip_smoke.main`` at the start of its
    phase 3."""
    import numpy as np
    import torch

    tol = 2e-3
    hprob, prob, ctx, cg = L["hprob"], L["prob"], L["ctx"], L["cg"]
    d = hprob.disc
    HF = np.concatenate([np.ones((1, d.n_nodes)),
                         np.random.RandomState(7).standard_normal(
                             (K - 1, d.n_nodes))])
    en = dict(vector_layout="en", backend="pallas")
    # the far split: plain CG on the masked split apply, the rectangle's
    # forcing 1 and its Dirichlet lift
    dr = prob.disc
    b = ctx["to_local"](dr.scatter_add(dr.gather(np.ones(dr.n_nodes))
                                       * dr.detJxW).astype(np.float32)
                        + prob._neumann)
    u_dL = ctx["to_local"](np.where(prob._dirichlet_mask,
                                    prob._dirichlet_vals, 0.0))
    r = torch.where(ctx["free_local"], b - ctx["A_raw"](u_dL), 0.0)
    A_fs = L["A_split"].masked(ctx["free_local"], assume_masked_input=True)
    w = ctx["ex"].weights_T(torch.float32, r.device)

    class _Far:
        """The far-split CG result in the solves' shape."""

        def __init__(self, tol_, max_iter):
            self.cg = cg(A_fs, r, M=ctx["M"], tol=tol_, max_iter=max_iter,
                         dot_weight=w)

    modes = {"helm-en-pallas": (1, lambda **o: hprob.solve_local(**en, **o)),
             "helm-batch-en-pallas": (K, lambda **o: hprob.solve_local_batch(
                 HF, **en, **o)),
             "far-split": (1, lambda tol, max_iter: _Far(tol, max_iter))}
    out = dict(rows_ms={r_["name"]: r_["ms"] for r_ in L["rows"]},
               ptxas=ab_common.ptxas_report(
                   L["logs"], lambda ln: "Li81E" in ln or "far_update" in ln),
               iterations={}, steady={}, profiles={})
    for name, (k, run) in modes.items():
        sol = run(tol=tol, max_iter=20000)
        out["iterations"][f"{name}@{tol:g}"] = np.atleast_1d(
            sol.cg.iterations.cpu().numpy()).tolist()
    for order in (list(modes), list(modes)[::-1]):
        for name in order:
            k, run = modes[name]
            its = steady if name == "far-split" else HELM_STEADY
            ts = []
            for it in its:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = run(tol=0.0, max_iter=it)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0, sol.cg.issued))
            out["steady"].setdefault(name, []).append(
                1e3 * (ts[1][0] - ts[0][0]) / (ts[1][1] - ts[0][1]) / k)
    for name, (k, run) in modes.items():
        iters = FAR_PROFILE if name == "far-split" else HELM_PROFILE
        out["profiles"][name] = ab_common.profile(
            lambda: run(tol=0.0, max_iter=iters))
    return out


def run_tree(root: Path, steady: tuple[int, int]) -> dict:
    """The tree's chip_smoke.py up to its phase 3, then :func:`_tail`."""
    return ab_common.through_phase2(root, lambda L: _tail(L, steady))


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, __doc__, "local", run_tree,
                            steady="512,1536"))
