#!/usr/bin/env python3
"""Compare the PyTorch port's p = 1 apply kernels and the p-multigrid
solves that run them between source trees on one card.

    python3 scripts/torch_ab_p1.py TREE_A TREE_B
    python3 scripts/torch_ab_p1.py --one TREE

Each TREE is the root of a checkout holding ``spectralelementmethod_torch``
and ``chip_smoke.py`` (for example the parent commit unpacked with
``git archive`` beside this one); the shapes and the timing helper are
that script's.  With two trees they run in the order A, B, B, A, each in
its own process, so that a drift of the card over the call shows as a
difference between the two runs of one tree.  Each run:

* builds the two apply sources and reports their compiler lines for the
  n = 4 kernels (registers, shared memory, spills);
* holds the four p = 1 applies (affine and curved, one RHS and k = 4) at
  E = 99,856 against their plain versions, times them (CUDA events, inputs
  rotated past the L2) and counts the device kernels one call issues
  (the profiler over four calls);
* solves ``pmg-rect``, ``pmg-rect-cheb`` and ``pmg-annulus`` of
  ``chip_smoke.py`` to 1e-6 (iterations), times one V-cycle on the device
  clock, and profiles 64 pmg-CG iterations of each (device ms and
  launches per iteration, busy share, the top kernels).

Prints one JSON line per run, then the card's name and power limit; the
runs' full logs go to ``chiprun_out/ab_p1_*.log``.  Needs one CUDA card.
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

import ab_common

K = 4                  # right-hand sides of the stacked rows
PROFILE_ITERS = 64


def _device_kernels(fn, args_list):
    """Device kernels (copies and fills left out) of one call of ``fn`` per
    entry of ``args_list``, by name (after a warm-up pass)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in args_list:
            fn(*a)
        torch.cuda.synchronize()
    return {e.key[:70]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("Memcpy", "Memset"))}


def run_tree(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels

    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(0)
    logs = kernels.build([kernels._APPLY, kernels._GEN_APPLY])
    out = dict(tree=str(root), rows={}, pmg={},
               ptxas=ab_common.ptxas_report(
                   logs, lambda ln: "p1_apply" in ln or "Li4E" in ln))

    # the four p = 1 rows at the coarse level's full shapes
    p1 = {}
    for pk, mesh_ in (("rect", rectangle_mesh(cs.NX, cs.NY, 1)),
                      ("annulus", annulus_mesh(1, **cs.ANNULUS))):
        p1[pk] = Poisson(Discretization(mesh_, gll_basis_2d(1)),
                         dtype=np.float32)._local_setup(dev)["A"]
    for pk, name, k in (("rect", "affine_apply_dss", 1),
                        ("rect", "affine_apply_dss_batched", K),
                        ("annulus", "general_apply_dss", 1),
                        ("annulus", "general_apply_dss_batched", K)):
        A1 = p1[pk]
        ops1 = ((A1.Kst, A1.aT) if pk == "rect"
                else (A1.gT, A1.Dh, A1.hier))
        fn = functools.partial(getattr(kernels, name), factors=A1.factors)
        plain = getattr(kernels, name + "_plain")
        sets = [(torch.randn((k * 4, A1.E), generator=g, device=dev), *ops1,
                 A1.plan) for _ in range(24 // k)]
        err, rel = cs.rel_err(fn(*sets[0]), plain(*sets[0]))
        kern = _device_kernels(fn, sets[:4])
        out["rows"][f"{name}[p1]"] = dict(
            ms=cs.gpu_ms(fn, sets), max_abs_err=err, rel_err=rel,
            kernels_per_call=sum(kern.values()) / 4, kernels=kern)
    del p1

    # the pmg cells
    rect = Poisson(Discretization(rectangle_mesh(cs.NX, cs.NY, cs.ORDER),
                                  gll_basis_2d(cs.ORDER)), dtype=np.float32)
    rect.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    ann = Poisson(Discretization(annulus_mesh(cs.ORDER, **cs.ANNULUS),
                                 gll_basis_2d(cs.ORDER)), dtype=np.float32)
    ann.set_dirichlet("sphere", 1.0)
    ann.set_dirichlet("shell", 0.0)
    cheb = {"pmg": {"coarse": "chebyshev"}}
    for cell, prob, pre in (("pmg-rect", rect, "pmg"),
                            ("pmg-rect-cheb", rect, cheb),
                            ("pmg-annulus", ann, "pmg")):
        run = functools.partial(prob.solve_local, precond=pre)
        t0 = time.perf_counter()
        sol = run(tol=cs.TOL_PMG, max_iter=cs.MAX_ITER)
        dt = time.perf_counter() - t0
        ctx = prob._local_setup(dev)
        M = prob._pmg(ctx, pre, dev)
        n, E = ctx["A"].n_loc, ctx["A"].E
        rs = [(torch.where(ctx["free_local"], torch.randn(
            (n, E), generator=g, device=dev), 0.0),) for _ in range(4)]
        out["pmg"][cell] = dict(
            iterations=int(sol.cg.iterations), issued=sol.cg.issued,
            converged=bool(sol.cg.converged), seconds=dt,
            coarse=M._coarse_kind, vcycle_ms_device=cs.gpu_ms(M, rs),
            profile=ab_common.profile(
                functools.partial(run, tol=0.0, max_iter=PROFILE_ITERS)))
    return out


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, __doc__, "p1", run_tree, timeout=900))
