#!/usr/bin/env python3
"""Compare the PyTorch port's affine apply between source trees on one card.

    python3 scripts/torch_ab_apply.py TREE_A TREE_B [--steady 512,1536]

Each TREE is the root of a checkout holding ``spectralelementmethod_torch``
and ``chip_smoke.py`` (for example the parent commit unpacked with
``git archive`` beside this one).  The trees run in the order A, B, B, A,
each in its own process, so that a drift of the card over the call shows
as a difference between the two runs of one tree.  Each run, on
``rectangle_mesh(316, 316, 8)`` in float32 (E = 99,856, n = 81):

* builds the apply's source, prints the compiler's register, shared
  memory and spill report of its kernels;
* times (CUDA events, inputs rotated past the L2) ``affine_apply_dss``
  (one RHS), ``affine_apply_dss_batched`` (k = 4), one block launch of the
  4-shard operator (``affine_block_apply_dss``) and the whole sharded
  apply;
* measures plain CG's steady state (``solve_local(cg_kernel="plain")`` at
  tol 0 for the two iteration counts of ``--steady``, the difference of
  the two host times over the difference of the issued iterations; twice)
  and profiles 512 iterations (device time per iteration, by kernel).

Prints one JSON line per run, then the card's name and power limit.  A
tree whose wrappers take no ``factors`` keyword (before the
tensor-product apply) is driven without it.  Needs one CUDA card.
"""

from __future__ import annotations

import inspect
import sys
import time
from pathlib import Path

import ab_common


def run_tree(root: Path, steady: tuple[int, int]) -> dict:
    import numpy as np
    import torch

    root = str(root)
    sys.path.insert(0, root)
    from chip_smoke import card_line, gpu_ms
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels, sumfac
    from spectralelementmethod_torch.parallel import (
        device_mesh, make_sharded_fused_operator)

    out = dict(tree=root, card=card_line())
    log = kernels.build([kernels._APPLY]).get(kernels._APPLY, "")
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "Li81E" in ln or "registers" in ln
                    or "stack frame" in ln][:12]
    disc = Discretization(rectangle_mesh(316, 316, 8), gll_basis_2d(8))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    ctx = prob._local_setup("cuda")
    A = ctx["A"]
    n, E = disc.n_loc, disc.E
    new = "factors" in inspect.signature(
        kernels.affine_apply_dss).parameters
    kw = dict(factors=A.factors) if new else {}
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(k=1):
        return torch.randn((k * n, E), generator=g, device="cuda")

    def apply(*a):
        return kernels.affine_apply_dss(*a, **kw)

    def apply_k(*a):
        return kernels.affine_apply_dss_batched(*a, **kw)

    out["apply_ms"] = gpu_ms(apply, [(rnd(), A.Kst, A.aT, A.plan)
                                     for _ in range(3)])
    out["apply_k4_ms"] = gpu_ms(apply_k, [(rnd(4), A.Kst, A.aT, A.plan)
                                          for _ in range(2)])
    Gf = prob._G_host.reshape(E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, _ = sumfac.affine_factorization(Gf, W)
    Kcat = sumfac.make_affine_element_matrices(Dhat, W, order=ctx["ex"].hier)
    A_sh = make_sharded_fused_operator(ctx["ex"], Kcat, a, device_mesh(4))
    ops = A_sh._block_operands
    bkw = dict(factors=ops[3]) if new else {}

    def block(*a):
        return kernels.affine_block_apply_dss(*a, **bkw)

    Eb = E // 4
    out["block_ms"] = gpu_ms(block, [
        (A_sh._extended(rnd().split(Eb, dim=1), 0), ops[0], ops[1][0],
         ops[2][0], A_sh._block_plan) for _ in range(3)])
    out["sharded_apply_ms"] = gpu_ms(A_sh, [(rnd(),) for _ in range(3)])

    def plain(it):
        return prob.solve_local(tol=0.0, max_iter=it, cg_kernel="plain")

    plain(64)
    per_it = []
    for _ in range(2):
        ts = []
        for it in steady:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = plain(it)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0, sol.cg.issued))
        per_it.append(1e3 * (ts[1][0] - ts[0][0]) / (ts[1][1] - ts[0][1]))
    out["plain_cg_steady_ms"] = per_it

    out["plain_cg_profile"] = ab_common.profile(lambda: plain(512), 512)
    return out


if __name__ == "__main__":
    sys.exit(ab_common.main(__file__, __doc__, "apply", run_tree,
                            steady="512,1536", timeout=600))
