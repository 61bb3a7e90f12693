#!/usr/bin/env python
r"""Multi-RHS Poisson solves through one operator and one CG, on the
PyTorch port.

The reference solves one system per ``spsolve`` call
(``sem/discrete.py:502-528``); here k right-hand sides share every
operator read, preconditioner and host synchronization
(``Poisson.solve_local_batch``).  With ``--f32`` the batch runs in float32
with bf16 search directions: on the card, the batched fused CG kernels.
Runs on the CUDA card unless ``--device cpu``.

Usage::

    python examples/torch_multi_rhs.py [--cells 24] [--order 4] [--k 4] \
        [--f32] [--device cpu]
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
    ap.add_argument("--cells", type=int, default=24)
    ap.add_argument("--order", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--f32", action="store_true",
                    help="float32 + bf16 directions (the fused kernels)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson

    dtype = np.float32 if args.f32 else np.float64
    n, p, k = args.cells, args.order, args.k
    mesh = rectangle_mesh(n, n, p, x0=(0, 0), x1=(1, 1))
    disc = Discretization(mesh, gll_basis_2d(p))
    prob = Poisson(disc, dtype=dtype)
    prob.set_dirichlet("ebc", 0.0)
    prob.set_dirichlet("nbc", 0.0)

    # k forcings: harmonics sin(j pi x) sin(pi y) with known solutions
    forcings = [
        (lambda x, y, j=j: ((j * j + 1) * np.pi**2
                            * np.sin(j * np.pi * x) * np.sin(np.pi * y)))
        for j in range(1, k + 1)
    ]

    kw = dict(p_dtype=torch.bfloat16) if args.f32 else {}
    t0 = time.perf_counter()
    sol = prob.solve_local_batch(forcings, tol=1e-6 if args.f32 else 1e-11,
                                 device=args.device, **kw)
    dt = time.perf_counter() - t0

    print(f"{disc.E} elements p={p}, {disc.n_nodes} nodes, k={k} RHS, "
          f"dtype={np.dtype(dtype).name}")
    its = np.atleast_1d(sol.cg.iterations.cpu().numpy())
    print(f"batched solve: {dt:.2f} s, per-RHS iterations {its.tolist()}")
    errs = []
    for j in range(k):
        def exact(x, y, j=j + 1):
            return np.sin(j * np.pi * x) * np.sin(np.pi * y)

        errs.append(prob.l2_error(sol.u[j], exact))
        print(f"  RHS {j + 1}: L2 error vs exact harmonic = {errs[-1]:.3e}")
    return {"iterations": its.tolist(), "errors": errs}


if __name__ == "__main__":
    main()
