#!/usr/bin/env python
r"""3D Poisson with mixed Dirichlet/Neumann BCs and boundary-flux
post-processing, on the PyTorch port.

Solves

.. math:: -\nabla^2 u = -12

on the unit cube with the manufactured solution
``u = x^2 + 2 y^2 + 3 z^2 + x y z``: Dirichlet data on the three
"minus" faces, inhomogeneous Neumann data ``g = n . grad u`` on the
three "plus" faces, then verifies the divergence theorem with
``Poisson.boundary_flux`` (the sum of outward fluxes must equal
``\int \Delta u = 12``).  Runs on the CUDA card unless ``--device cpu``.

Usage::

    python examples/torch_poisson3d_mixed_bc.py [--cells 2] [--order 3] \
        [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402


def u_exact(x, y, z):
    return x * x + 2 * y * y + 3 * z * z + x * y * z


def grad_u(x, y, z):
    return (2 * x + y * z, 4 * y + x * z, 6 * z + x * y)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=2)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson

    n, p = args.cells, args.order
    mesh = box_mesh(n, n, n, p, x0=(0, 0, 0), x1=(1, 1, 1),
                    boundary_names={
                        "west": "dir", "south": "dir", "bottom": "dir",
                        "east": "neu_e", "north": "neu_n",
                        "top": "neu_t"})
    disc = Discretization(mesh, gll_basis_3d(p))
    prob = Poisson(disc, forcing=-12.0)
    prob.set_dirichlet("dir", u_exact)
    prob.set_neumann("neu_e", lambda x, y, z: grad_u(x, y, z)[0])
    prob.set_neumann("neu_n", lambda x, y, z: grad_u(x, y, z)[1])
    prob.set_neumann("neu_t", lambda x, y, z: grad_u(x, y, z)[2])

    sol = prob.solve(tol=1e-13, device=args.device)
    x = disc.global_gll_coords()
    err = np.abs(sol.u - u_exact(*x)).max()
    print(f"E={disc.E} hexes, p={p}, {disc.n_nodes} nodes; "
          f"CG {int(sol.cg.iterations)} its, "
          f"|r|={float(sol.cg.residual_norm):.2e}")
    print(f"max |u - u_exact| = {err:.3e} (manufactured, should be ~1e-11)")

    fluxes = {b: prob.boundary_flux(sol.u, b)
              for b in ("dir", "neu_e", "neu_n", "neu_t")}
    total = sum(fluxes.values())
    for b, f in fluxes.items():
        print(f"  outward flux through {b!r}: {f:+.6f}")
    print(f"  divergence-theorem check: sum = {total:.6f} "
          f"(exact 12; error {abs(total - 12.0):.2e})")
    return {"err": err, "flux_total": total}


if __name__ == "__main__":
    main()
