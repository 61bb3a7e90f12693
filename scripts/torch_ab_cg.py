#!/usr/bin/env python3
"""Compare the PyTorch port's affine kernel A and single-kernel iteration
between source trees on one card.

    python3 scripts/torch_ab_cg.py TREE_A TREE_B [--steady 512,1536]

Each TREE is the root of a checkout holding ``spectralelementmethod_torch``
and ``chip_smoke.py`` (for example the parent commit unpacked with
``git archive`` beside this one).  The trees run in the order A, B, B, A,
each in its own process, so that a drift of the card over the call shows
as a difference between the two runs of one tree.  Each run, on
``rectangle_mesh(316, 316, 8)`` in float32 (E = 99,856, n = 81):

* builds the kernels, prints the compiler's register, shared-memory and
  spill report of every kernel of ``cg_kernel_a.cu`` and
  ``cg_kernel_single.cu`` at n = 81;
* times (CUDA events, inputs rotated past the L2) the twelve rows of
  ``chip_smoke.py`` phase 2: kernel A f32 and bf16, one RHS and k = 4,
  with x and deferred, and the single kernel f32 and bf16, with x and
  deferred;
* measures the steady state of the fused, ``fused1`` and batched (k = 4)
  solves (tol 0, the two iteration counts of ``--steady``: the difference
  of the host times over the difference of the issued iterations, per
  RHS; twice);
* profiles 512 iterations of the fused f32 solve and of the batched bf16
  ``defer_x=8`` solve (device time per iteration by kernel, busy share).

Prints one JSON line per run, then the card's name and power limit.  A
tree whose kernel A wrappers take no ``factors`` keyword (before the
tensor-product kernel A) is driven without it.  Needs one CUDA card.
"""

from __future__ import annotations

import functools
import inspect
import sys
import time
from pathlib import Path

import ab_common

K = 4
DEFER = 8
PROFILE_ITERS = 512


def run_tree(root: Path, steady: tuple[int, int]) -> dict:
    import numpy as np
    import torch

    root = str(root)
    sys.path.insert(0, root)
    from chip_smoke import card_line, gpu_ms
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels
    from spectralelementmethod_torch.ops.exchange import roll_dss_T

    out = dict(tree=root, card=card_line())
    logs = kernels.build()
    out["ptxas"] = ab_common.ptxas_report(
        {src: logs.get(src, "") for src in ("cg_kernel_a.cu",
                                            "cg_kernel_single.cu")},
        lambda ln: "Li81E" in ln)
    disc = Discretization(rectangle_mesh(316, 316, 8), gll_basis_2d(8))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    dev = resolve_device()
    ctx = prob._local_setup(dev)
    A = ctx["A"]
    Kst, aT, plan = A.Kst, A.aT, A.plan
    n, E = disc.n_loc, disc.E
    inv = {}
    w = {}
    for tag, pdt in (("f32", None), ("bf16", torch.bfloat16)):
        inv[tag], w[tag] = prob._fused_cg_operands(ctx["ex"],
                                                   ctx["free_np"], pdt,
                                                   dev)
    g = torch.Generator(device=dev).manual_seed(0)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}

    def rnd(k=1, dtype=torch.float32):
        return torch.randn((k * n, E), generator=g, device=dev).to(dtype)

    def kw_of(fn):
        new = "factors" in inspect.signature(fn).parameters
        return dict(factors=A.factors) if new else {}

    scal = {1: (torch.tensor(0.7, device=dev),
                torch.tensor(0.4, device=dev)),
            K: (torch.tensor([0.7, 0.4, 1.1, 0.0], device=dev),
                torch.tensor([0.4, 0.0, 0.9, 0.3], device=dev))}
    rows = {}
    for base, k, with_x in (("cg_kernel_a", 1, True),
                            ("cg_kernel_a_deferred", 1, False),
                            ("cg_kernel_a_batched", K, True),
                            ("cg_kernel_a_batched_deferred", K, False)):
        fn = kernels.WRAPPERS[base]
        fn = functools.partial(fn, **kw_of(fn))
        for tag in ("f32", "bf16"):
            sets = []
            for _ in range(2):
                a_ = [rnd(k), rnd(k, dt[tag]), inv[tag]]
                a_ += [rnd(k), *scal[k]] if with_x else [scal[k][0]]
                sets.append((*a_, Kst, aT, plan))
            rows[f"{base}[{tag}]"] = gpu_ms(fn, sets)

    def consistent(dtype=torch.float32):
        return roll_dss_T(rnd(), plan).to(dtype)

    for base, with_x in (("cg_kernel_single", True),
                         ("cg_kernel_single_deferred", False)):
        fn = kernels.WRAPPERS[base]
        fn = functools.partial(fn, **kw_of(fn))
        for tag in ("f32", "bf16"):
            sets = [(consistent(), consistent(), consistent(dt[tag]),
                     *((rnd(),) if with_x else ()), inv[tag], w[tag],
                     *scal[1][::-1], Kst, aT, plan) for _ in range(2)]
            rows[f"{base}[{tag}]"] = gpu_ms(fn, sets)
    out["rows_ms"] = rows

    F = np.concatenate([np.ones((1, disc.n_nodes)),
                        np.random.RandomState(7).standard_normal(
                            (K - 1, disc.n_nodes))])
    bf16 = dict(p_dtype=torch.bfloat16)
    modes = {"fused": (1, dict(cg_kernel="fused")),
             "fused-bf16p": (1, dict(cg_kernel="fused", **bf16)),
             "fused1": (1, dict(cg_kernel="fused1")),
             "fused1-bf16p": (1, dict(cg_kernel="fused1", **bf16)),
             "batch-fused": (K, dict(cg_kernel="fused")),
             f"batch-fused-bf16p-m{DEFER}": (K, dict(
                 cg_kernel="fused", defer_x=DEFER, **bf16))}

    def solve(name, it):
        k, kw = modes[name]
        if k > 1:
            return prob.solve_local_batch(F, tol=0.0, max_iter=it, **kw)
        return prob.solve_local(tol=0.0, max_iter=it, **kw)

    per_it = {m: [] for m in modes}
    for m in modes:
        solve(m, 64)
    for order in (list(modes), list(modes)[::-1]):
        for m in order:
            ts = []
            for it in steady:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = solve(m, it)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0, sol.cg.issued))
            per_it[m].append(1e3 * (ts[1][0] - ts[0][0])
                             / (ts[1][1] - ts[0][1]) / modes[m][0])
    out["steady_ms_per_issued_per_rhs"] = per_it

    out["profiles"] = {
        m: ab_common.profile(lambda: solve(m, PROFILE_ITERS), PROFILE_ITERS)
        for m in ("fused", f"batch-fused-bf16p-m{DEFER}")}
    return out


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, __doc__, "cg", run_tree,
                            steady="512,1536", timeout=900))
