#!/usr/bin/env python
"""Axisymmetric squirmer: swimming-speed sweep over Reynolds number, on the
PyTorch port.

Steady flow around a spherical squirmer in stream-function/vorticity form,
Newton + batched static condensation, secant swimming-speed search, Re
continuation with rollback, HDF5 checkpoint/resume.  The mesh is the
donut.geo-equivalent generated annulus, or a Gmsh ``.msh`` file.

The documented oracle (reference ``squirmer:666-671``): at Re=1, beta=1 on
the donut mesh at p=8 the swimming speed is 0.92571156681483957.  Runs on
the CUDA card unless ``--device cpu``.

Usage::

    python examples/torch_squirmer_axisym.py                 # golden point
    python examples/torch_squirmer_axisym.py --sweep 0.5 1 2 4 --betas 0 1 \
        --results sweep.h5                             # continuation sweep
    python examples/torch_squirmer_axisym.py --mesh donut.msh  # Gmsh import
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None,
                    help="Gmsh .msh file (2.2 or 4.1, binary or ASCII)")
    ap.add_argument("--order", type=int, default=8)
    ap.add_argument("--n-theta", type=int, default=9,
                    help="cells along the sphere of the generated donut")
    ap.add_argument("--n-r", type=int, default=15,
                    help="cells across the generated donut")
    ap.add_argument("--re", type=float, default=1.0)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--sweep", type=float, nargs="*", default=None,
                    help="list of Reynolds numbers for a continuation sweep")
    ap.add_argument("--betas", type=float, nargs="*", default=None)
    ap.add_argument("--results", default=None, help="HDF5 results file "
                    "(enables checkpoint/resume)")
    ap.add_argument("--newton-loop", choices=["host", "device"],
                    default="host",
                    help="run each Newton solve's loop without its per-step "
                         "prints and host reads ('device')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from spectralelementmethod_torch.mesh import annulus_mesh
    from spectralelementmethod_torch.models.squirmer import Squirmer
    from spectralelementmethod_torch.models.squirmer import main as sweep

    if args.mesh:
        from spectralelementmethod_torch.mesh.gmsh import load_msh

        mesh = load_msh(args.mesh, ndim=2)
    else:
        # the donut.geo-equivalent transfinite sphere-in-shell mesh
        mesh = annulus_mesh(order=args.order, n_theta=args.n_theta,
                            n_r=args.n_r, r_outer=100.0, progression=1.35)

    sq = Squirmer(mesh, order=args.order, device=args.device)
    print(f"mesh: {sq.disc.E} elements, order {args.order}; "
          f"condensed system: {sq.csys.n_ext_dofs} dofs")

    if args.sweep:
        betas = args.betas if args.betas else [args.beta]
        speeds = sweep(sq, args.sweep, betas, filename=args.results)
        print("\n=== swimming speeds ===")
        for (re, beta), u in sorted(speeds.items()):
            print(f"Re = {re:8.4g}  beta = {beta:6.3g}  U = {u:.12f}")
        return speeds
    sq.set_initial_guess()
    speed = sq.calc_speed(
        [0.99, 1.01], n_rey=args.re, beta=args.beta,
        flow_solver_opts={"newton_loop": args.newton_loop})
    print(f"\nswimming speed at Re={args.re}, beta={args.beta}: "
          f"{speed:.17f}")
    if abs(args.re - 1.0) < 1e-12 and abs(args.beta - 1.0) < 1e-12:
        print("reference golden value:              "
              "0.92571156681483957")
    return speed


if __name__ == "__main__":
    main()
