#!/usr/bin/env python
"""Element-sharded Poisson: L-vector CG over a mesh of element shards, on
the PyTorch port.

The port's counterpart of ``examples/sharded_poisson.py``.  The element
axis splits into ``--devices`` shards; the shards are blocks of the
element axis on one device (the CUDA card unless ``--device cpu``), and
the halo exchange between them is explicit copies of their boundary
strips (``parallel.halo``).  Launched by ``torch.distributed.run``, each
rank is one shard on its own card (NCCL; ``--device cpu`` takes gloo), the
strips travel between the ranks, and rank 0 prints.  The manufactured
solution is ``sin(pi (x+1)/2) sin(pi (y+1)/2)``, float32.

Usage::

    python examples/torch_sharded_poisson.py --nx 32 --order 6 \
        [--tol 1e-5] [--devices 8] [--comm shardmap-fused] [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        examples/torch_sharded_poisson.py --comm shardmap-fused
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
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--order", type=int, default=6)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--devices", type=int, default=None,
                    help="element shards (default: one per visible card)")
    ap.add_argument("--comm", choices=["propagation", "shardmap",
                                       "shardmap-fused"],
                    default="propagation",
                    help="the (E, n) operator on the padded exchange, the "
                         "per-shard product with the halo DSS, or the "
                         "block kernel per shard")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import Discretization
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg

    group = "RANK" in os.environ
    if group:
        import datetime

        import torch.distributed as dist

        cpu = args.device is not None and args.device.startswith("cpu")
        if not cpu:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("gloo" if cpu else "nccl",
                                timeout=datetime.timedelta(seconds=600))
    dev_mesh = sh.device_mesh(None if group else args.devices,
                              device=args.device)
    say = print if dev_mesh.rank in (None, 0) else (lambda *a: None)
    say(f"devices: {dev_mesh.size} element shards on {dev_mesh.device}"
        + (" (one per rank)" if group else ""))

    mesh = rectangle_mesh(args.nx, args.nx, args.order)
    disc = Discretization(mesh, gll_basis_2d(args.order))
    say(f"elements: {disc.E}, DOFs: {disc.ndof}")

    def ue(x, y):
        return np.sin(np.pi * (x + 1) / 2) * np.sin(np.pi * (y + 1) / 2)

    prob = Poisson(disc, forcing=lambda x, y: np.pi**2 / 2 * ue(x, y),
                   dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    prob.set_dirichlet("nbc", 0.0)

    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
        prob, dev_mesh, comm=args.comm)
    say(f"element axis padded {disc.E} -> {ex.E} over {dev_mesh.size} "
        f"shards (comm={args.comm})")

    transposed = args.comm.startswith("shardmap")
    dot = ex.dot_T if transposed else ex.dot
    if r.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(A, r, M=M, tol=args.tol, max_iter=5000, dot=dot)
    if r.is_cuda:
        torch.cuda.synchronize()
    t = time.perf_counter() - t0
    uL = sh.gather_blocks(dev_mesh, u_dL + res.x,
                          -1 if transposed else 0).cpu().numpy()
    u = (ex.global_from_local_T(uL) if transposed
         else ex.global_from_local(uL))

    err = prob.l2_error(u, ue)
    say(f"CG: {int(res.iterations)} iterations, |r| = "
        f"{float(res.residual_norm):.3e}, wall {t:.2f}s")
    say(f"L2 error vs manufactured solution: {err:.3e}")
    if group:
        dist.destroy_process_group()
    return {"u": u, "iterations": int(res.iterations), "l2_error": err,
            "converged": bool(res.converged)}


if __name__ == "__main__":
    main()
