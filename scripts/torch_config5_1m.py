#!/usr/bin/env python3
"""BASELINE config 5 at its stated scale on the PyTorch port: a
1,048,576-element imported Gmsh mesh, partitioned, element-sharded and
solved by p-multigrid CG.

The port's counterpart of ``scripts/config5_1m.py`` (the same pipeline,
the same problems and arms):

    generate rectangle_mesh(1024, 1024, 2) -> save_msh (binary 2.2)
    -> load_msh (import timed) -> panel order (panel = nx / 16)
    -> hybrid mesh: 2 pseudo-slices, 8 shards (comm="shardmap": the halo
       strips copied between the shards' element blocks)
    -> sharded pmg CG (degree 7, alpha 30), float64, to 1e-10
    -> the degree-1 smoother arm, and the single-device ladder (the
       unsharded "xla" operator with the same M): agreement

The default problem is the oscillatory manufactured one (forcing
frequencies k1 = nx/8, k2 = nx/4, Dirichlet data 0.1 sin(3 pi (x + 0.7
y))); ``--trivial`` takes linear Dirichlet data.  The shards run on one
device (the CUDA card unless ``--device cpu``), or, launched by
``torch.distributed.run``, one per rank (NCCL, each rank on its card;
``--device cpu`` takes gloo): the hybrid mesh then makes each node a
slice (``--slices`` splits the ranks into that many pseudo-slices), and
rank 0 runs the single-device ladder on the whole problem.  Prints each
phase's seconds as it ends and one JSON line last (rank 0).  Run:

    python3 scripts/torch_config5_1m.py [--its 48] [--nx 1024] [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        scripts/torch_config5_1m.py --slices 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402


def run(nx: int = 1024, order: int = 2, its: int = 48, trivial: bool = False,
        msh: str | None = None, device=None, shards: int | None = 8,
        slices: int | None = 2, log=print, hook=None) -> dict:
    """The config-5 pipeline; returns its numbers (seconds per phase,
    iterations, residuals, agreement, setup stages).  ``hook``, if given,
    is called after the sharded solve as ``hook(A=, r=, M=, w=, its=)``
    (the sharded operator, right-hand side, preconditioner, dot weights and
    the solve's iterations) and its result is kept as ``out["hook"]``.

    Under an initialised process group the shards are the ranks
    (``shards`` is not read; ``slices`` None makes each node a slice): the
    tensors are each rank's blocks, every rank returns the same
    iterations, and ``agreement`` (the single-device ladder, on rank 0
    alone: the whole problem with its V-cycle simulated on as many blocks
    of rank 0's device) reaches every rank."""
    import torch

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.mesh.gmsh import load_msh, save_msh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import sumfac
    from spectralelementmethod_torch.parallel import partition as pt
    from spectralelementmethod_torch.parallel import comm
    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg
    from spectralelementmethod_torch.utils import stages

    ranked = torch.distributed.is_initialized()
    dev = (sh.device_mesh(device=device).device if ranked
           else resolve_device(device))
    out = {}
    t_all = time.perf_counter()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def phase(name, t0):
        sync()
        dt = time.perf_counter() - t0
        out[name] = dt
        log(f"[{time.perf_counter() - t_all:7.1f}s] {name}: {dt:.2f}s")

    stages.snapshot(reset=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = msh or os.path.join(tmp, "config5.msh")
        t0 = time.perf_counter()
        mesh0 = rectangle_mesh(nx, nx, order)
        phase("generate_s", t0)
        assert mesh0.n_cells == nx * nx
        t0 = time.perf_counter()
        save_msh(mesh0, path, binary=True)
        phase("save_msh_s", t0)
        del mesh0
        out["msh_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        mesh = load_msh(path, ndim=2)
        phase("import_s", t0)
    out["elements"] = mesh.n_cells

    t0 = time.perf_counter()
    # the cross-panel offset panel * nx - panel + 1 stays below the
    # per-shard block nx * nx / 8 with panel = nx / 16
    perm = pt.panel_order(n_fast=nx, n_slow=nx, panel=max(1, nx // 16))
    mesh = pt.reorder_elements(mesh, perm)
    phase("partition_s", t0)

    t0 = time.perf_counter()
    disc = Discretization(mesh, gll_basis_2d(order))
    if trivial:
        prob = Poisson(disc, dtype=np.float64)
        prob.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    else:
        # grid-scaled frequencies (~1/8 and ~1/4 of the mesh's Nyquist):
        # fine-scale content the coarse space cannot represent
        k1, k2 = max(4, nx // 8), max(8, nx // 4)
        prob = Poisson(
            disc,
            forcing=lambda x, y: (np.sin(k1 * np.pi * x)
                                  * np.cos((k1 - 1) * np.pi * y)
                                  + 0.3 * np.sin((k2 + 1) * np.pi * x)
                                  * np.sin(k2 * np.pi * y)),
            dtype=np.float64)
        prob.set_dirichlet(
            "ebc", lambda x, y: 0.1 * np.sin(3 * np.pi * (x + 0.7 * y)))
    phase("discretize_s", t0)
    out["n_nodes"] = disc.n_nodes
    out["problem"] = "trivial-linear" if trivial else "oscillatory"

    snap0 = stages.snapshot()
    t0 = time.perf_counter()
    hmesh = sh.hybrid_device_mesh(n_slices=slices,
                                  devices=None if ranked else shards,
                                  device=dev)
    out["shards"] = hmesh.size
    out["slice_ids"] = list(hmesh.shard_slice_ids)
    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
        prob, hmesh, comm="shardmap",
        precond={"pmg": {"degree": 7, "alpha": 30.0}})
    phase("shard_setup_s", t0)
    out["coarse_kind"] = M._coarse_kind
    snap1 = stages.snapshot()
    d_ex = snap1.get("exchange/build", 0.0) - snap0.get("exchange/build",
                                                        0.0)
    d_pmg = snap1.get("precond/pmg-build", 0.0) - snap0.get(
        "precond/pmg-build", 0.0)
    out["shard_setup_breakdown"] = {
        "exchange_build_s": d_ex, "pmg_build_s": d_pmg,
        "other_s": max(out["shard_setup_s"] - d_ex - d_pmg, 0.0)}

    w = ex._weights_as(np.float64, dev, transposed=True)
    t0 = time.perf_counter()
    res = cg(A, r, M=M, tol=1e-10, max_iter=its, dot_weight=w, block=its)
    phase("sharded_cg_s", t0)
    out["its"] = int(res.iterations)
    out["converged"] = bool(res.converged)
    out["resnorm"] = float(res.residual_norm)
    out["ms_per_iter"] = 1e3 * out["sharded_cg_s"] / max(out["its"], 1)
    if hook is not None:
        out["hook"] = hook(A=A, r=r, M=M, w=w, its=out["its"])

    # the weak-smoother arm: degree-1 Chebyshev, many more cycles of the
    # same sharded smoother, exact coarse solve and halo
    t0 = time.perf_counter()
    _, r3, M3, _, _, _ = sh.sharded_local_poisson_problem(
        prob, hmesh, comm="shardmap", precond={"pmg": {"degree": 1}})
    res3 = cg(A, r3, M=M3, tol=1e-10, max_iter=max(its, 64), dot_weight=w,
              block=max(its, 64))
    phase("weak_smoother_cg_s", t0)
    out["its_weak"] = int(res3.iterations)
    out["converged_weak"] = bool(res3.converged)
    out["resnorm_weak"] = float(res3.residual_norm)
    u_sh = ex.global_from_local_T(
        sh.gather_blocks(hmesh, u_dL + res.x).cpu().numpy())
    if ranked:
        # rank 0 runs the single-device ladder below on the whole problem
        # (its V-cycle simulated on as many blocks of its device); the
        # others wait for its numbers
        out["its_single"] = out["agreement"] = None
        if hmesh.rank == 0:
            smesh = sh.DeviceMesh(hmesh.size, dev)
            _, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
                prob, smesh, comm="shardmap",
                precond={"pmg": {"degree": 7, "alpha": 30.0}})
            w = ex._weights_as(np.float64, dev, transposed=True)
        else:
            phase("single_device_cg_s", time.perf_counter())
            return _shared(comm, hmesh, out, t_all, stages)

    # the same ladder on one device: the padded exchange's unsharded "xla"
    # operator, the same M
    t0 = time.perf_counter()
    Gf = np.zeros((ex.E, 3, disc.n_loc))
    Gf[:disc.E] = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    free = (~prob._dirichlet_mask)[ex.gather_hier]
    free[disc.E:] = False
    A1 = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, torch.as_tensor(np.ascontiguousarray(free.T),
                                      device=dev),
        device=dev, vector_layout="ne", backend="xla")
    res1 = cg(A1, r, M=M, tol=1e-10, max_iter=its, dot_weight=w, block=its)
    phase("single_device_cg_s", t0)
    out["its_single"] = int(res1.iterations)
    u_1 = ex.global_from_local_T((u_dL + res1.x).cpu().numpy())
    out["agreement"] = float(np.abs(u_sh - u_1).max() / np.abs(u_1).max())
    if ranked:
        return _shared(comm, hmesh, out, t_all, stages)
    out["setup_stages"] = stages.snapshot()
    out["total_s"] = time.perf_counter() - t_all
    return out


def _shared(comm, mesh, out, t_all, stages):
    """Rank 0's single-device numbers on every rank (one all-gather)."""
    import torch

    mine = torch.tensor([float("nan") if out["agreement"] is None
                         else out["agreement"],
                         -1.0 if out["its_single"] is None
                         else out["its_single"]], dtype=torch.float64,
                        device=mesh.device)
    first = comm.gather_blocks(mesh, mine[None], 0)[0].tolist()
    out["agreement"], out["its_single"] = first[0], int(first[1])
    out["setup_stages"] = stages.snapshot()
    out["total_s"] = time.perf_counter() - t_all
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--its", type=int, default=48,
                    help="CG iteration budget of the main solve")
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--msh", default=None,
                    help="mesh file path (default: a temporary file)")
    ap.add_argument("--trivial", action="store_true",
                    help="linear Dirichlet data, no forcing")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--slices", type=int, default=2,
                    help="pseudo-slices of the hybrid mesh (0: under a "
                         "process group, a node per slice)")
    args = ap.parse_args(argv)
    group = "RANK" in os.environ
    if group:
        _init_group(args.device)
    out = run(nx=args.nx, order=args.order, its=args.its,
              trivial=args.trivial, msh=args.msh, device=args.device,
              slices=args.slices or None)
    if not group or int(os.environ["RANK"]) == 0:
        print(json.dumps(out))
    if group:
        import torch.distributed as dist

        dist.destroy_process_group()
    ok = (out["agreement"] < 1e-10 and out["converged"]
          and out["converged_weak"] and out["coarse_kind"] == "fdm")
    return 0 if ok else 1


def _init_group(device, timeout_s: float = 900.0):
    """The process group of a ``torch.distributed.run`` launch: NCCL with
    each rank on its card, or gloo for ``--device cpu``."""
    import datetime

    import torch
    import torch.distributed as dist

    cpu = device is not None and str(device).startswith("cpu")
    if not cpu:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("gloo" if cpu else "nccl",
                            timeout=datetime.timedelta(seconds=timeout_s))


if __name__ == "__main__":
    sys.exit(main())
