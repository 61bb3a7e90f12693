#!/usr/bin/env python
r"""Poisson's equation on a square plate, on the PyTorch port.

.. math:: -\nabla^2 u = 1

on the unit square with Dirichlet u = 0.2((x+1)+(y+1)) on the "ebc"
boundary (west + south) and homogeneous Neumann on "nbc" (north + east);
the mesh is generated, or read from a Gmsh ``.msh`` file.  Runs on the
CUDA card unless ``--device cpu``.

Usage::

    python examples/torch_poisson.py [--mesh square.msh] [--order 4] \
        [--plot out.png] [--local] [--batch N] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402


def grid_in(mesh_file=None, nx=8, ny=8, order=4):
    """Load a Gmsh mesh or generate the square.geo-equivalent in memory."""
    if mesh_file:
        from spectralelementmethod_torch.mesh.gmsh import load_msh

        print("Importing mesh...")
        return load_msh(mesh_file, ndim=2)
    from spectralelementmethod_torch.mesh import rectangle_mesh

    return rectangle_mesh(nx, ny, order)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None,
                    help="Gmsh .msh file (2.2 or 4.1, binary or ASCII)")
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--plot", default=None, help="save a contour plot here "
                    "(needs matplotlib)")
    ap.add_argument("--local", action="store_true",
                    help="use the L-vector solve path (the card's kernels)")
    ap.add_argument("--batch", type=int, default=0,
                    help="additionally solve N extra forcings through one "
                         "batched CG (Poisson.solve_local_batch)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.models.poisson import Poisson

    mesh = grid_in(args.mesh, args.nx, args.nx, args.order)
    disc = Discretization(mesh, gll_basis_2d(args.order))
    print(f"mesh: {disc.E} elements, order {args.order}, "
          f"{disc.n_nodes} nodes")

    prob = Poisson(disc)  # unit forcing, as the reference example
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    # homogeneous Neumann on "nbc" is the natural (do-nothing) BC

    solve = prob.solve_local if args.local else prob.solve
    sol = solve(tol=1e-12, device=args.device)
    print(f"CG converged: {bool(sol.cg.converged)} in "
          f"{int(sol.cg.iterations)} iterations "
          f"(|r| = {float(sol.cg.residual_norm):.3e})")
    print(f"u range: [{sol.u.min():.6f}, {sol.u.max():.6f}]")
    print(f"integral of u: {disc.integrate(sol.u):.12f}")
    out = {"u": sol.u, "iterations": int(sol.cg.iterations)}

    if args.batch:
        fs = [1.0] + [
            (lambda m: lambda x, y: np.sin(m * np.pi * x)
             * np.sin(m * np.pi * y))(m + 1)
            for m in range(args.batch)
        ]
        bsol = prob.solve_local_batch(fs, tol=1e-12, device=args.device)
        its = bsol.cg.iterations.cpu().numpy()
        print(f"batched solve of {len(fs)} forcings: iterations {its}, "
              f"all converged: {bool(bsol.cg.converged.all())}")
        du = np.abs(bsol.u[0] - sol.u).max()
        print(f"batch[0] vs single solve: max|du| = {du:.3e}")
        out["batch_du"] = du

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from spectralelementmethod_torch import plot2d

        fig, ax = plt.subplots(figsize=(6, 5))
        cs = plot2d.tricontourf(disc, sol.u, ax=ax, levels=24, cmap="cool")
        fig.colorbar(cs)
        plot2d.draw_cells(mesh, ax=ax)
        fig.savefig(args.plot, dpi=130)
        plt.close(fig)
        print(f"saved {args.plot}")
    return out


if __name__ == "__main__":
    main()
