#!/usr/bin/env python
"""hp-convergence sweep for the Poisson solver (BASELINE config 2), on the
PyTorch port.

Solves -lap u = f with manufactured u = sin(pi x) sin(pi y) across a grid
of polynomial orders p and mesh refinements h, reporting L2 errors and
observed convergence rates.  Spectral (exponential-in-p) convergence is the
signature correctness property of the method.  Runs on the CUDA card
unless ``--device cpu``.

Usage::

    python examples/torch_hp_convergence.py [--orders 2 4 6 8 12 16] \
        [--cells 2 4] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, nargs="*",
                    default=[2, 4, 6, 8, 12, 16])
    ap.add_argument("--cells", type=int, nargs="*", default=[2, 4])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson

    def exact(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    def f(x, y):
        return 2 * np.pi**2 * exact(x, y)

    errors = {}
    print(f"{'n':>4} {'p':>4} {'ndof':>9} {'L2 error':>13} {'rate':>8}")
    for n in args.cells:
        last = None
        for p in args.orders:
            mesh = rectangle_mesh(n, n, p, boundary_names={
                "west": "d", "east": "d", "south": "d", "north": "d"})
            disc = Discretization(mesh, gll_basis_2d(p))
            prob = Poisson(disc, forcing=f)
            prob.set_dirichlet("d", 0.0)
            sol = prob.solve(tol=1e-14, host_loop=True, device=args.device)
            err = prob.l2_error(sol.u, exact)
            if last is not None and err > 0:
                rate = np.log(last / err)
            else:
                rate = float("nan")
            print(f"{n:>4} {p:>4} {disc.ndof:>9} {err:>13.4e} "
                  f"{rate:>8.2f}")
            errors[(n, p)] = err
            last = err
        print()
    return errors


if __name__ == "__main__":
    main()
