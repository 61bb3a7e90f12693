#!/usr/bin/env python3
"""The float64-certified 3D solve at ``bench.py --ndim 3``'s default size
on one CUDA card: setup seconds by stage, the solve and peak memory.

    python3 scripts/torch_poisson3d_46.py [--nx 46]

``box_mesh(nx, nx, nx, 8)`` (nx = 46, the bench's ``--elements 100000``:
E = 97,336, 50.2M nodes, 71M local DOFs, 284 MB per float32 L-vector),
float32, forcing 1, Dirichlet 0 on "ebc" (the bench's 3D problem),
``solve_local(tol=1e-6, precond="pmg", certify=True)`` twice (a warm call,
then a timed one).  Prints the host setup stages, the card's peak memory,
each call's convergence, iterations, segments' residuals and seconds, the
float64 iterate's true residual recomputed by a float64 general operator
built here apart from the solve's, then one JSON line of it all.  Exits 1
unless the solve converges, does not stall and the recomputed residual is
at most 1.05 tol.  Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_poisson3d_46: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import sumfac
    from spectralelementmethod_torch.utils import stages

    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=46)
    nx = ap.parse_args().nx
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    out = dict(card=card, nx=nx)
    setup = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
        print(f"  {name}: {setup[name]:.2f} s", flush=True)
        return val

    stages.snapshot(reset=True)
    mesh = timed("mesh", lambda: box_mesh(nx, nx, nx, 8))
    basis = gll_basis_3d(8)
    disc = timed("discretization", lambda: Discretization(mesh, basis))
    prob = timed("model", lambda: Poisson(disc, dtype=np.float32))
    prob.set_dirichlet("ebc", 0.0)
    ctx = timed("operators", lambda: prob._local_setup_3d("jacobi", dev))
    setup["stages"] = stages.snapshot(reset=True)
    ex = ctx["ex"]
    out.update(E=disc.E, n_nodes=disc.n_nodes, local_dofs=disc.E * disc.n_loc,
               exchange=type(ex).__name__,
               structure=ctx["A_raw"].structure)
    print(f"  E={disc.E}, {disc.n_nodes} nodes, {disc.E * disc.n_loc} local "
          f"DOFs, {type(ex).__name__}, {ctx['A_raw'].structure} apply",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    calls = []
    for label in ("warm", "timed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = prob.solve_local(tol=TOL, precond="pmg", certify=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = sol.cg
        calls.append(dict(call=label, seconds=dt, converged=res.converged,
                          stalled=res.stalled, iterations=res.iterations,
                          issued=res.issued,
                          cycle_resnorms=list(res.cycle_resnorms),
                          residual_norm=res.residual_norm))
        if label == "warm":
            setup["warm_call_stages"] = stages.snapshot(reset=True)
        print(f"  {label}: {dt:.3f} s, converged {res.converged}, stalled "
              f"{res.stalled}, its {res.iterations} / {res.issued} issued, "
              f"cycle_resnorms {[f'{v:.3e}' for v in res.cycle_resnorms]}",
              flush=True)
    out["peak_gib_solve"] = torch.cuda.max_memory_allocated() / 2**30

    # the float64 iterate's true residual, by a float64 general operator of
    # the same factor values (the rank-1 field a (x) W), built apart
    W3 = np.asarray(basis.weight_grid(), np.float64)
    _, a32 = prob._scales_3d()
    A64 = sumfac.make_laplacian_3d(
        ex, a32[:, :, None, None, None] * W3, basis, dtype=np.float64,
        device=dev, structure="general", free=ctx["free"])
    w = ex._weights_as(torch.float32, dev)
    b64 = torch.as_tensor(ex.local_from_global(
        np.asarray(prob._b, np.float64) + prob._neumann), device=dev)

    def nrm(v):
        return float(torch.sqrt(torch.sum(w * v * v)))

    bnorm = nrm(torch.where(ctx["free"], b64, 0.0))
    rel = nrm(torch.where(ctx["free"], b64 - A64(res.x), 0.0)) / bnorm
    out.update(setup_s=setup, calls=calls, true_rel_f64_of_x=rel,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  float64 true residual of the iterate {rel:.3e} (tol {TOL:g}); "
          f"peak device memory {out['peak_gib_solve']:.2f} GiB in the solves"
          f", {out['peak_gib']:.2f} GiB with the check operator", flush=True)
    print(json.dumps(out), flush=True)
    ok = res.converged and not res.stalled and rel <= 1.05 * TOL
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
