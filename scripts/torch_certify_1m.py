#!/usr/bin/env python3
"""The float64-certified solve of the reference's 1M-element cell on one
CUDA card: setup seconds by stage and the solve.

    python3 scripts/torch_certify_1m.py [--n 1024]

``rectangle_mesh(n, n, 8)`` (n = 1024: E = 1,048,576, 67M DOFs), float32,
forcing 1, Dirichlet ``0.2((x+1)+(y+1))`` on "ebc" (the reference bench's
problem), ``solve_local(tol=1e-6, precond="pmg", certify=True)`` twice (a
warm call, then a timed one).  Prints the host setup stages (mesh,
discretization, model, the (n, E) operators, pmg build, the float64
operator and seed), the card's peak memory, and each call's convergence,
iterations, segments' residuals, reported residual and seconds, then one
JSON line of it all.  Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_certify_1m: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.utils import stages

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    n = ap.parse_args().n
    out = dict(card=torch.cuda.get_device_name(0), E=n * n)
    setup = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
        print(f"  {name}: {setup[name]:.2f} s", flush=True)
        return val

    mesh = timed("mesh", lambda: rectangle_mesh(n, n, 8))
    disc = timed("discretization", lambda: Discretization(mesh,
                                                          gll_basis_2d(8)))
    prob = timed("model", lambda: Poisson(disc, dtype=np.float32))
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    timed("operators", lambda: prob._local_setup(resolve_device()))
    stages.snapshot(reset=True)
    torch.cuda.reset_peak_memory_stats()
    calls = []
    for label in ("warm", "timed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = prob.solve_local(tol=1e-6, precond="pmg", certify=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = sol.cg
        calls.append(dict(call=label, seconds=dt, converged=res.converged,
                          stalled=res.stalled, iterations=res.iterations,
                          issued=res.issued,
                          cycle_resnorms=list(res.cycle_resnorms),
                          residual_norm=res.residual_norm))
        if label == "warm":
            setup.update({k: v for k, v in stages.snapshot(reset=True)
                          .items()})
        print(f"  {label}: {dt:.3f} s, converged {res.converged}, stalled "
              f"{res.stalled}, its {res.iterations} / {res.issued} issued, "
              f"cycle_resnorms {[f'{v:.3e}' for v in res.cycle_resnorms]}",
              flush=True)
    out.update(setup_s=setup, calls=calls,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  peak device memory {out['peak_gib']:.2f} GiB")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
