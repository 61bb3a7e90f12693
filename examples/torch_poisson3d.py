#!/usr/bin/env python
r"""3D Poisson on a hexahedral box, on the PyTorch port.

.. math:: -\nabla^2 u = 3\pi^2 \sin\pi x \sin\pi y \sin\pi z

on [-1, 1]^3 with homogeneous Dirichlet conditions; the exact solution is
the sin product, and the solver reports the max-norm error.  ``--msh``
writes the mesh as a Gmsh file and solves on the mesh read back from it.
Runs on the CUDA card unless ``--device cpu``.

Usage::

    python examples/torch_poisson3d.py [--cells 3] [--order 6] [--f32] \
        [--precond jacobi|fdm|pmg] [--msh box.msh] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=3, help="cells per axis")
    ap.add_argument("--order", type=int, default=6)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--precond", choices=["jacobi", "fdm", "pmg"],
                    default="jacobi",
                    help="fdm = sum-factorized fast diagonalization; "
                         "pmg = two-level p-multigrid with the exact "
                         "tensor-lattice coarse solve (GridFDM3D)")
    ap.add_argument("--msh", default=None,
                    help="round-trip the mesh through a Gmsh file "
                         "(written here, then imported back) before "
                         "solving — exercises 3D hex .msh I/O")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson

    dtype = np.float32 if args.f32 else np.float64

    def exact(x, y, z):
        return np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)

    t0 = time.perf_counter()
    n = args.cells
    mesh = box_mesh(n, n, n, args.order)
    if args.msh:
        from spectralelementmethod_torch.mesh.gmsh import load_msh, save_msh

        save_msh(mesh, args.msh)
        mesh = load_msh(args.msh, ndim=3)
        print(f"mesh round-tripped through {args.msh}")
    disc = Discretization(mesh, gll_basis_3d(args.order))
    prob = Poisson(
        disc, forcing=lambda x, y, z: 3 * np.pi**2 * exact(x, y, z),
        dtype=dtype)
    prob.set_dirichlet("ebc", 0.0)
    print(f"setup: {disc.E} cells, {disc.n_nodes} nodes, p={args.order} "
          f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    sol = prob.solve_local(tol=1e-6 if args.f32 else 1e-12,
                           precond=args.precond, device=args.device)
    x, y, z = np.asarray(prob.x_nodes)
    err = np.abs(sol.u - exact(x, y, z)).max()
    print(f"CG: {int(sol.cg.iterations)} iterations, "
          f"|r| = {float(sol.cg.residual_norm):.2e} "
          f"({time.perf_counter() - t0:.2f} s)")
    print(f"max |u - exact| = {err:.3e}")
    return {"u": sol.u, "iterations": int(sol.cg.iterations), "err": err}


if __name__ == "__main__":
    main()
