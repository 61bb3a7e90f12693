#!/usr/bin/env python3
"""Find the largest rectangle of the ``advdiff-rect`` cell: the
manufactured advection-diffusion problem of the JAX package's
``tests/test_advection_diffusion.py`` (eps = 0.5, c = (1, 0.5), u = sin sin,
Dirichlet 0) on ``rectangle_mesh(n, n, 8)``, float64, solved by the port's
Jacobi-preconditioned GMRES(40) to 1e-10 within 100 restarts.

    python3 scripts/torch_advdiff_size.py [--device cpu] N [N ...]

Prints, for each n: iterations, converged, the residual norm, the L2
error and seconds, then one JSON line of it all.  GMRES's iteration count
depends on rounding, so the card and the CPU may differ by a few percent;
``chip_smoke.py`` (phase 3u, ``AD_N``) takes the largest n that converged
here on the CPU.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sizes", type=int, nargs="+")
    ap.add_argument("--device", default=None,
                    help="the device of the solves (default: the card)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.advection_diffusion import (
        AdvectionDiffusion)

    rows = []
    for n in args.sizes:
        t0 = time.perf_counter()
        ad = AdvectionDiffusion(
            Discretization(rectangle_mesh(n, n, 8), gll_basis_2d(8)),
            velocity=cs.AD_C, diffusivity=cs.AD_EPS, forcing=cs.ad_f)
        ad.set_dirichlet("ebc", 0.0)
        ad.set_dirichlet("nbc", 0.0)
        sol = ad.solve(tol=1e-10, restart=cs.AD_RESTART, max_restarts=100,
                       device=args.device)
        row = dict(n=n, iterations=int(sol.gmres.iterations),
                   converged=bool(sol.gmres.converged),
                   residual=float(sol.gmres.residual_norm),
                   l2_err=ad.l2_error(sol.u, cs.ad_u),
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(f"n = {n}: {row['iterations']} iterations, converged "
              f"{row['converged']}, residual {row['residual']:.3e}, l2 "
              f"error {row['l2_err']:.3e}, {row['seconds']:.1f} s",
              flush=True)
    print(json.dumps({"advdiff_size": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
