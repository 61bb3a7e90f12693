#!/usr/bin/env python3
"""The float32 3D box solves of the port and of the JAX package, side by
side on the CPU: iterations, and the float64 true residual of each
float32 solution.

    JAX_PLATFORMS=cpu python3 scripts/parity_poisson3d_cpu.py [--nx 6 8]

``box_mesh(nx, nx, nx, 8)``, float32, forcing 1, Dirichlet 0 on "ebc"
(``bench.py --ndim 3``'s problem at a size the CPU takes in seconds):
``solve_local`` with Jacobi and fdm to 1e-5, pmg to 1e-6 and the
certified pmg solve to 1e-6, in both packages; then ``||b - A u||_2 /
||b||_2`` on the free nodes, by the port's float64 global apply, of the
two Jacobi solutions, of a float64 solve to the same tolerance and of
that solution rounded to float32 (the float32 recurrence's drift against
the rounding floor).  A CPU check beside the tests, not a measurement of
the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", True)
    import torch

    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_tpu.basis import gll_basis_3d as jax_basis
    from spectralelementmethod_tpu.core.discretization import (
        Discretization as JaxDisc)
    from spectralelementmethod_tpu.mesh import box_mesh as jax_box
    from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson

    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, nargs="+", default=[6, 8])
    torch.set_num_threads(4)
    for nx in ap.parse_args().nx:
        models = {}
        for name, P, D, box, basis in (
                ("port", Poisson, Discretization, box_mesh, gll_basis_3d),
                ("reference", JaxPoisson, JaxDisc, jax_box, jax_basis)):
            m = P(D(box(nx, nx, nx, 8), basis(8)), dtype=np.float32)
            m.set_dirichlet("ebc", 0.0)
            models[name] = m
        kw = {"port": dict(device="cpu"), "reference": {}}
        sols = {}
        for label, opts in (("jacobi@1e-5", dict(tol=1e-5)),
                            ("fdm@1e-5", dict(tol=1e-5, precond="fdm")),
                            ("pmg@1e-6", dict(tol=1e-6, precond="pmg")),
                            ("certify@1e-6", dict(tol=1e-6, precond="pmg",
                                                  certify=True))):
            its = []
            for name, m in models.items():
                sol = m.solve_local(**opts, **kw[name])
                sols[name, label] = sol
                its.append(f"{name} {int(sol.cg.iterations)}")
            print(f"nx={nx} {label}: " + ", ".join(its), flush=True)
        m64 = Poisson(Discretization(box_mesh(nx, nx, nx, 8),
                                     gll_basis_3d(8)), dtype=np.float64)
        m64.set_dirichlet("ebc", 0.0)
        free = ~m64._dirichlet_mask
        b = np.where(free, m64._b, 0.0)

        def true_rel(u):
            Au = m64.apply_operator(np.asarray(u, np.float64),
                                    device="cpu").numpy()
            return np.linalg.norm(np.where(free, m64._b - Au, 0.0)) / \
                np.linalg.norm(b)

        u64 = m64.solve_local(tol=1e-5, device="cpu").u
        print(f"nx={nx} float64 true residual of the Jacobi@1e-5 solutions:"
              f" port f32 {true_rel(sols['port', 'jacobi@1e-5'].u):.3e}, "
              f"reference f32 "
              f"{true_rel(sols['reference', 'jacobi@1e-5'].u):.3e}, a "
              f"float64 solve {true_rel(u64):.3e}, it rounded to float32 "
              f"{true_rel(u64.astype(np.float32)):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
