#!/usr/bin/env python3
"""The port's element sharding with one rank per card: every sharded path
driven under a ``torch.distributed`` process group, each rank's results
written to a directory.

One process per card (NCCL, rank r on ``cuda:LOCAL_RANK``), started by the
launcher::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        scripts/torch_multicard.py --size full --out chiprun_out/multicard

or one CPU process per rank (gloo), each started by hand with its rank and
a shared file store::

    python3 scripts/torch_multicard.py --backend gloo --world-size 4 \\
        --rank R --init-method file:///path/to/store --size small --out DIR

Cases (``--cases`` picks some, comma-separated):

* ``roll`` — ``global_roll`` with and without wrap and ``block_roll`` by a
  shift wider than a block, on the ranks' blocks of a seeded array;
* ``shardmap64`` / ``pmg64`` — the float64 ``comm="shardmap"`` problem,
  Jacobi (to 1e-10 at the small size, to plain CG's 2e-3 at full size,
  where 1e-10 takes more than the 5,000-iteration budget) and p-multigrid
  CG to 1e-10 (``dot=exchange.dot_T``);
* ``fused32`` / ``cheb32`` — the float32 ``comm="shardmap-fused"`` pmg,
  the exact grid coarse solve and the padded Chebyshev coarse level (the
  block kernel at p_c = 1), ``dot_weight=exchange.weights_T(...)``;
* ``replicated`` — ``sharded_poisson_problem``: one apply of a seeded
  vector and Jacobi CG;
* ``propagation`` — the (E, n) blocks, float64 Jacobi as ``shardmap64``
  (the rank's block of the (E, n) dot weights);
* ``box3d`` — ``sharded_local_poisson_problem_3d``, Jacobi;
* ``squirmer`` — ``Squirmer.shard_elements``: one Newton step (small) or
  the swimming speed against the unsharded model's (full);
* ``config5`` — ``scripts/torch_config5_1m.py``'s pipeline (2
  pseudo-slices), the single-device ladder on rank 0.

``--size small`` is the CPU tests' size (16 x 16 at p = 3, a 3 x 3 x 3
box at p = 4, a 20-element squirmer, config 5 at nx = 16); ``full`` is the
card's (the 316 x 316 rectangle at p = 8 in float32, ``box_mesh(27, 27,
27, 8)``, the golden squirmer, config 5 at nx = 1024), and then the
worker holds each case to its bar, profiles the float32 pmg per rank and
exits non-zero when one fails.  Each rank writes ``rank{R}.json`` (its
numbers: iterations, residuals, seconds, peak memory per case, and at full
size per-rank profiles: device ms, the NCCL share of device time and
launches per iteration) and, at the small size, ``rank{R}.npz`` (its
arrays: the gathered global solutions, its own blocks).  Every collective
waits at most ``--timeout`` seconds.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np  # noqa: E402

CASES = ("roll", "shardmap64", "pmg64", "fused32", "cheb32", "replicated",
         "propagation", "box3d", "squirmer", "config5")

#: problem sizes: the rectangle (nx, ny, p), the box (n, p), the squirmer
#: mesh, config 5's nx
SIZES = {
    "small": dict(rect=(16, 16, 3), box=(3, 4), config5=16, jacobi_tol=1e-10,
                  squirmer=dict(order=4, n_theta=4, n_r=5, r_outer=10.0,
                                progression=1.2)),
    "full": dict(rect=(316, 316, 8), box=(27, 8), config5=1024,
                 jacobi_tol=2e-3,
                 squirmer=dict(order=8, n_theta=9, n_r=15, r_outer=100.0,
                               progression=1.35, node_placement="gmsh")),
}

# the full size's bars (the reference's, as chip_smoke.py holds the
# single-card paths to them)
TOL_PMG, PMG_ITS, PMG_BAR = 1e-6, 18, 2
TOL_ALL, PLAIN_ITS, PLAIN_BAR = 2e-3, 392, 2
TOL3, JAC3_ITS, JAC3_REL = 1e-5, 618, 0.05
C5_ITS, C5_BAR, C5_WEAK_ITS, C5_WEAK_BAR, C5_AGREE = 5, 1, 13, 2, 1e-10
SQ_AGREE = 1e-9
PROFILE_ITERS = 16


def _bc(x, y):
    return 0.2 * ((x + 1) + (y + 1))


def init_group(backend, init_method, rank, world, timeout):
    """The default process group (the launcher's environment when
    ``rank`` is None), each NCCL rank on its card."""
    import torch
    import torch.distributed as dist

    if rank is None:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return backend


class Run:
    """One rank's run: its mesh, size, records and arrays."""

    def __init__(self, size, out, log):
        import torch

        from spectralelementmethod_torch.parallel import sharding as sh

        self.mesh = sh.device_mesh()
        self.dev = self.mesh.device
        self.size = size
        self.spec = SIZES[size]
        self.out = out
        self.log = log
        self.rec = dict(rank=self.mesh.rank, world=self.mesh.size,
                        device=str(self.dev), size=size, cases={})
        self.arrays = {}
        self.problems = {}
        self.failed = []
        self.cuda = self.dev.type == "cuda"
        if self.cuda:
            self.rec["card"] = torch.cuda.get_device_name(self.dev)

    def sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def timed(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def check(self, ok, what):
        if not ok:
            self.failed.append(what)
        self.log(("ok  " if ok else "FAIL ") + what)

    def gathered(self, x, dim=-1):
        from spectralelementmethod_torch.parallel import sharding as sh

        return sh.gather_blocks(self.mesh, x, dim).cpu().numpy()

    def rect(self, dtype):
        from spectralelementmethod_torch.basis import gll_basis_2d
        from spectralelementmethod_torch.core.discretization import (
            Discretization)
        from spectralelementmethod_torch.mesh import rectangle_mesh
        from spectralelementmethod_torch.models.poisson import Poisson

        key = np.dtype(dtype).name
        if key not in self.problems:
            nx, ny, p = self.spec["rect"]
            prob = Poisson(Discretization(rectangle_mesh(nx, ny, p),
                                          gll_basis_2d(p)), dtype=dtype)
            prob.set_dirichlet("ebc", _bc)
            self.problems[key] = prob
        return self.problems[key]

    def launches(self):
        from spectralelementmethod_torch.ops import kernels

        return {k: {str(n): c for n, c in by_n.items() if c}
                for k, by_n in kernels.launch_counts_by_n().items()
                if any(by_n.values())}


def case_roll(run):
    """global_roll (+-3, with and without wrap) and block_roll (a shift
    wider than a block, both ways) on the rank's block of seeded arrays."""
    import torch

    from spectralelementmethod_torch.parallel import comm, halo

    mesh, S, Eb = run.mesh, run.mesh.size, 8
    x = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (2, S * Eb)), device=run.dev)
    blk = comm.block_of(mesh, x).contiguous()
    for delta in (3, -3):
        for wrap in (True, False):
            got = halo.global_roll(blk, delta, halo.ELEM_AXIS, mesh, wrap)
            run.arrays[f"roll_{delta}_{int(wrap)}"] = run.gathered(got)
    y = torch.as_tensor(np.random.RandomState(2).standard_normal(
        (S * Eb, 3)), device=run.dev)
    yb = comm.block_of(mesh, y, 0).contiguous()
    for shift in (Eb + 3, -(2 * Eb + 1)):
        got = halo.block_roll(yb, shift, mesh, 0)
        run.arrays[f"block_roll_{shift}"] = run.gathered(got, 0)
    run.arrays["roll_x"], run.arrays["roll_y"] = (x.cpu().numpy(),
                                                  y.cpu().numpy())
    return dict(Eb=Eb)


def _lvector_solve(run, name, dtype, comm_, precond, tol, weights=False):
    """A sharded L-vector solve: iterations, the gathered solution, the
    rank's reduced scalars as hex."""
    import torch

    from spectralelementmethod_torch.ops import kernels
    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg

    prob = run.rect(dtype)
    (A, r, M, u_dL, ex, _), t_setup = run.timed(
        lambda: sh.sharded_local_poisson_problem(prob, run.mesh, comm=comm_,
                                                 precond=precond))
    if weights:
        w = ex.weights_T(r.dtype, run.dev)
        kw = dict(dot_weight=w)
    else:
        kw = dict(dot=ex.dot_T)
    kernels.reset_launch_counts()
    res, dt = run.timed(lambda: cg(A, r, M=M, tol=tol, max_iter=5000, **kw))
    its = int(res.iterations)
    x = u_dL + res.x
    u = ex.global_from_local_T(run.gathered(x).astype(np.float64))
    run.arrays[f"{name}_u"] = u
    run.arrays[f"{name}_xblock"] = x.cpu().numpy()
    rr = ex.dot_T(r, r)
    rec = dict(iterations=its, issued=int(res.issued),
               converged=bool(res.converged), setup_s=t_setup, solve_s=dt,
               ms_per_issued=1e3 * dt / max(int(res.issued), 1),
               launches=run.launches(), block_E=int(r.shape[-1]),
               Ep=int(ex.E), residual_hex=float(res.residual_norm).hex(),
               rr_hex=float(rr).hex())
    if precond != "jacobi":
        cyc = M._pmg
        rec.update(coarse_kind=M._coarse_kind, levels=list(M._levels),
                   lmax_hex=float(cyc._lmax_f).hex(),
                   coarse_backend=getattr(cyc._A_c, "_backend", None))
    return rec, (A, r, M, kw)


def _plain_bar(run, name, rec):
    """At full size a Jacobi solve runs to TOL_ALL, plain CG's 392."""
    if run.size == "full":
        its = rec["iterations"]
        run.check(rec["converged"] and abs(its - PLAIN_ITS) <= PLAIN_BAR,
                  f"{name}: {its} iterations within {PLAIN_BAR} of "
                  f"{PLAIN_ITS}")
    return rec


def case_shardmap64(run):
    return _plain_bar(run, "shardmap64", _lvector_solve(
        run, "shardmap64", np.float64, "shardmap", "jacobi",
        run.spec["jacobi_tol"])[0])


def case_pmg64(run):
    return _lvector_solve(run, "pmg64", np.float64, "shardmap", "pmg",
                          1e-10)[0]


def _profile(run, name, solve):
    """Device ms, launches and the NCCL share of device time per
    iteration of ``PROFILE_ITERS`` iterations of ``solve`` (the profiler's
    device events; "not measured" where it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize(run.dev)
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in ev) / 1e3
    if not ev or total <= 0:
        return dict(device_ms_per_iter="not measured")
    nccl = sum(e.self_device_time_total for e in ev
               if "nccl" in e.key.lower()) / 1e3
    kern = sum(e.count for e in ev
               if not e.key.startswith(("Memcpy", "Memset")))
    rec = dict(device_ms_per_iter=total / PROFILE_ITERS,
               wall_ms_per_iter=1e3 * wall / PROFILE_ITERS,
               nccl_share=nccl / total,
               launches_per_iter=kern / PROFILE_ITERS,
               busy=total / 1e3 / wall,
               top=[(e.key[:60], e.self_device_time_total / 1e3
                     / PROFILE_ITERS, e.count / PROFILE_ITERS)
                    for e in sorted(ev, key=lambda e:
                                    -e.self_device_time_total)[:6]])
    run.log(f"  profile {name}: {rec['device_ms_per_iter']:.4f} device ms "
            f"per iteration, NCCL {rec['nccl_share']:.1%}, "
            f"{rec['launches_per_iter']:.1f} launches, busy {rec['busy']:.0%}")
    return rec


def _pmg32(run, name, precond):
    from spectralelementmethod_torch.solver.cg import cg

    tol = TOL_PMG if run.size == "full" else 1e-6
    rec, (A, r, M, kw) = _lvector_solve(run, name, np.float32,
                                        "shardmap-fused", precond, tol,
                                        weights=True)
    n = run.rect(np.float32).disc.n_loc
    blk = rec["launches"].get("affine_block_apply_dss", {})
    rec["block_launches"] = blk.get(str(n), 0)
    rec["p1_block_launches"] = blk.get("4", 0)
    if run.size == "full":
        rec["profile"] = _profile(run, name, lambda: cg(
            A, r, M=M, tol=0.0, max_iter=PROFILE_ITERS,
            block=PROFILE_ITERS, **kw))
    return rec


def case_fused32(run):
    rec = _pmg32(run, "fused32", "pmg")
    if run.size == "full":
        run.check(rec["converged"]
                  and abs(rec["iterations"] - PMG_ITS) <= PMG_BAR,
                  f"fused32: {rec['iterations']} iterations within "
                  f"{PMG_BAR} of {PMG_ITS}")
    if run.cuda:
        run.check(rec["block_launches"] > 0
                  and rec["block_launches"] >= rec["iterations"],
                  f"fused32: {rec['block_launches']} block-kernel launches "
                  "on this rank's card, at least one per fine apply")
    return rec


def case_cheb32(run):
    rec = _pmg32(run, "cheb32", {"pmg": {"coarse": "chebyshev"}})
    if run.cuda:
        run.check(rec["p1_block_launches"] > 0,
                  f"cheb32: the p = 1 block apply launched "
                  f"({rec['p1_block_launches']}) on this rank's card")
    return rec


def case_replicated(run):
    import torch

    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg

    full = run.size == "full"
    prob = run.rect(np.float32 if full else np.float64)
    (A, r, M, u_d, _), t_setup = run.timed(
        lambda: sh.sharded_poisson_problem(prob, run.mesh))
    u = torch.as_tensor(np.random.RandomState(5).standard_normal(
        prob.disc.n_nodes), device=run.dev).to(r.dtype)
    run.arrays["replicated_Au"] = A(u).cpu().numpy()
    tol = TOL_ALL if full else 1e-10
    res, dt = run.timed(lambda: cg(A, r, M=M, tol=tol, max_iter=5000))
    its = int(res.iterations)
    run.arrays["replicated_u"] = (u_d + res.x).cpu().numpy()
    rec = dict(iterations=its, issued=int(res.issued),
               converged=bool(res.converged), setup_s=t_setup, solve_s=dt,
               ms_per_issued=1e3 * dt / max(int(res.issued), 1))
    if full:
        run.check(bool(res.converged) and abs(its - PLAIN_ITS) <= PLAIN_BAR,
                  f"replicated: {its} iterations within {PLAIN_BAR} of "
                  f"{PLAIN_ITS}")
        rec["profile"] = _profile(run, "replicated", lambda: cg(
            A, r, M=M, tol=0.0, max_iter=PROFILE_ITERS,
            block=PROFILE_ITERS))
    return rec


def case_propagation(run):
    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg

    prob = run.rect(np.float64)
    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
        prob, run.mesh, comm="propagation")
    w = ex._weights_as(r.dtype, run.dev)
    res, dt = run.timed(lambda: cg(A, r, M=M, tol=run.spec["jacobi_tol"],
                                   max_iter=5000, dot_weight=w))
    run.arrays["propagation_u"] = ex.global_from_local(
        run.gathered(u_dL + res.x, 0))
    return _plain_bar(run, "propagation", dict(
        iterations=int(res.iterations), converged=bool(res.converged),
        solve_s=dt, block_shape=list(r.shape)))


def case_box3d(run):
    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.parallel import sharding as sh
    from spectralelementmethod_torch.solver.cg import cg

    full = run.size == "full"
    nb, p = run.spec["box"]
    prob = Poisson(Discretization(box_mesh(nb, nb, nb, p), gll_basis_3d(p)),
                   dtype=np.float32 if full else np.float64)
    prob.set_dirichlet("ebc", 0.0 if full
                       else (lambda x, y, z: 0.1 * (x + y - z)))
    (A, r, M, u_dL, ex, _), t_setup = run.timed(
        lambda: sh.sharded_local_poisson_problem_3d(prob, run.mesh))
    tol = TOL3 if full else 1e-10
    res, dt = run.timed(lambda: cg(A, r, M=M, tol=tol, max_iter=20000,
                                   dot=ex.dot))
    its = int(res.iterations)
    run.arrays["box3d_u"] = ex.global_from_local(
        run.gathered(u_dL + res.x, 0).astype(np.float64))
    rec = dict(iterations=its, issued=int(res.issued),
               converged=bool(res.converged), setup_s=t_setup, solve_s=dt,
               ms_per_issued=1e3 * dt / max(int(res.issued), 1),
               deltas=list(ex.deltas), block_E=int(r.shape[0]))
    if full:
        run.check(bool(res.converged)
                  and abs(its - JAC3_ITS) <= JAC3_REL * JAC3_ITS,
                  f"box3d: {its} iterations within {JAC3_REL:.0%} of "
                  f"{JAC3_ITS}")
        rec["profile"] = _profile(run, "box3d", lambda: cg(
            A, r, M=M, tol=0.0, max_iter=PROFILE_ITERS, dot=ex.dot,
            block=PROFILE_ITERS))
    return rec


def case_squirmer(run):
    import contextlib
    import io

    from spectralelementmethod_torch.mesh import annulus_mesh
    from spectralelementmethod_torch.models import squirmer as sqm

    spec = run.spec["squirmer"]

    def model(sharded):
        sq = sqm.Squirmer(annulus_mesh(**spec), order=spec["order"],
                          device=run.dev)
        if sharded:
            sq.shard_elements(run.mesh)
        sq.set_initial_guess()
        return sq

    if run.size == "small":
        sq = model(True)
        sq.compute_operators(1.0)
        sq.set_boundary_conditions(speed=1.0, beta=1.0)
        sq.solve(it_max=1, tol=1e30, verbose=False)
        run.arrays["squirmer_soln"] = sq.soln
        return dict(force_hex=float(sq.calc_force()).hex(),
                    Ep=int(sq._Grho.shape[0]))
    speeds = {}
    for sharded in (True, False):
        sq = model(sharded)
        with contextlib.redirect_stdout(io.StringIO()):
            speeds[sharded], dt = run.timed(lambda: sq.calc_speed(
                [0.99, 1.01], n_rey=1.0, beta=1.0))
        speeds[f"s{int(sharded)}"] = dt
    d = abs(speeds[True] - speeds[False])
    run.check(d < SQ_AGREE, f"squirmer: sharded speed {speeds[True]!r} "
              f"within {SQ_AGREE} of the unsharded {speeds[False]!r}")
    return dict(speed=speeds[True], unsharded=speeds[False], diff=d,
                sharded_s=speeds["s1"], unsharded_s=speeds["s0"])


def case_config5(run):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_config5_1m", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "torch_config5_1m.py"))
    c5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c5)
    from spectralelementmethod_torch.solver.cg import cg

    def hook(A, r, M, w, its):
        return _profile(run, "config5", lambda: cg(
            A, r, M=M, tol=0.0, max_iter=PROFILE_ITERS, dot_weight=w,
            block=PROFILE_ITERS))

    out = c5.run(nx=run.spec["config5"], device=run.dev,
                 slices=2 if run.mesh.size % 2 == 0 else None,
                 log=lambda m: run.log(f"  config5 {m}"),
                 hook=hook if run.size == "full" else None)
    rec = {k: v for k, v in out.items() if k != "setup_stages"}
    if run.size == "full":
        run.check(out["converged"] and abs(out["its"] - C5_ITS) <= C5_BAR,
                  f"config5: {out['its']} iterations within {C5_BAR} of "
                  f"{C5_ITS}")
        run.check(out["converged_weak"]
                  and abs(out["its_weak"] - C5_WEAK_ITS) <= C5_WEAK_BAR,
                  f"config5: degree-1 arm {out['its_weak']} within "
                  f"{C5_WEAK_BAR} of {C5_WEAK_ITS}")
        run.check(out["agreement"] <= C5_AGREE, f"config5: agreement "
                  f"{out['agreement']:.3e} with the single-device ladder")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", choices=tuple(SIZES), default="small")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--out", default="chiprun_out/multicard")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds any collective may wait")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1 if args.backend == "gloo" else
                          torch.get_num_threads())
    t_start = time.perf_counter()
    backend = init_group(args.backend, args.init_method, args.rank,
                         args.world_size, args.timeout)
    rank = dist.get_rank()
    os.makedirs(args.out, exist_ok=True)

    def log(msg):
        print(f"[rank {rank} {time.perf_counter() - t_start:7.1f}s] {msg}",
              flush=True)

    run = Run(args.size, args.out, log)
    run.rec["backend"] = backend
    log(f"{backend}, {run.mesh.size} ranks, {run.dev}")
    for name in [c for c in args.cases.split(",") if c]:
        if name not in CASES:
            raise SystemExit(f"unknown case {name!r}")
        t0 = time.perf_counter()
        if run.cuda:
            torch.cuda.reset_peak_memory_stats(run.dev)
        run.rec["cases"][name] = rec = globals()[f"case_{name}"](run)
        rec["seconds"] = time.perf_counter() - t0
        if run.cuda:
            rec["peak_gib"] = torch.cuda.max_memory_allocated(run.dev) / 2**30
        log(f"{name}: " + json.dumps({k: v for k, v in rec.items()
                                      if not isinstance(v, (dict, list))}))
    run.rec["jax_loaded"] = sorted(m for m in sys.modules
                                   if m == "jax" or m.startswith(
                                       ("jax.", "spectralelementmethod_tpu")))
    run.rec["failed"] = run.failed
    run.rec["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump(run.rec, f, indent=1)
    if args.size == "small":
        # the full size's solutions stay on the ranks (tens of MB each)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **run.arrays)
    # every rank's verdict, so that all exit alike
    bad = torch.tensor([float(len(run.failed))], device=run.dev)
    dist.all_reduce(bad)
    dist.destroy_process_group()
    log(f"done in {time.perf_counter() - t_start:.1f} s; "
        f"{int(bad.item())} failed checks over the ranks")
    return 1 if bad.item() else 0


if __name__ == "__main__":
    sys.exit(main())
