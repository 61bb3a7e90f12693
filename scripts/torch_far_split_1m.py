#!/usr/bin/env python3
"""The fused CG kernels' far split against the unsplit kernels on the
reference's 1M-element rectangle, on one CUDA card.

    python3 scripts/torch_far_split_1m.py [--n 1024] [--max-halo 128]

``rectangle_mesh(n, n, 8)`` (n = 1024: E = 1,048,576, 85M local DOFs),
float32, forcing 1, Dirichlet ``0.2((x+1)+(y+1))`` on "ebc" (the reference
bench's problem): the regime where the reference's ``max_halo="auto"``
splits its fused CG kernels (``pallas_kernels.py:550-563``: single 1M,
split 9.81 against 10.90 ms per iteration on its TPU, 6.66 against 7.16
with ``defer_x=8``).  Each mode (fused f32, f32 with ``defer_x=8``, bf16
directions) runs ``cg_fused`` to 2e-3 with the model's operator and
operands, on the operator split at ``max_halo`` (kernel A on the near
classes, kernel B's far mode) and unsplit, in the order unsplit, split,
split, unsplit: iterations, host seconds, the float64 true residual
relative to the lift's, the steady state (ms per issued iteration of two
fixed-length runs differenced) and a 64-iteration profile (device ms and
launches per iteration, busy share).  Prints a line per run and one JSON
line of it all; writes it to ``chiprun_out/far_split_1m.json`` too.  Needs
the card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-3
STEADY = (256, 768)
PROFILE_ITERS = 64


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_far_split_1m: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.config import resolve_device
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import rectangle_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels, sumfac
    from spectralelementmethod_torch.solver.cg import cg_fused

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--max-halo", type=int, default=128)
    args = ap.parse_args()
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels.build()
    t0 = time.perf_counter()
    disc = Discretization(rectangle_mesh(args.n, args.n, 8), gll_basis_2d(8))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    ctx = prob._local_setup(dev)
    ex, E = ctx["ex"], disc.E
    Gf = prob._G_host.reshape(E, 3, -1)
    Dh = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    whole = ctx["A"]
    split = sumfac.make_local_laplacian_operator(
        ex, Gf, Dh, ctx["free_local"], True, device=dev,
        max_halo=args.max_halo)
    A64 = sumfac.make_local_laplacian_operator(
        ex, Gf.astype(np.float64), Dh, None, device=dev)
    b = np.asarray(prob._b) + prob._neumann
    u_d = np.where(prob._dirichlet_mask, prob._dirichlet_vals, 0.0)
    bL, u_dL = ctx["to_local"](b), ctx["to_local"](u_d)
    free = ctx["free_local"]
    r0 = torch.where(free, bL - ctx["A_raw"](u_dL), 0.0)
    gih = torch.as_tensor(ex.gather_hier, device=dev)
    b64 = torch.as_tensor(b, device=dev)[gih].T
    w64 = ex.weights_T(torch.float64, dev)
    operands = {dt: prob._fused_cg_operands(ex, ctx["free_np"], dt, dev)
                for dt in (None, torch.bfloat16)}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    far = split.far_plan
    print(f"setup {setup_s:.1f} s: E = {E}, max_halo = {args.max_halo}, "
          f"{far.n_entries} far entries, {split._split[0].n_entries} near, "
          f"{whole.plan.n_entries} in the whole plan", flush=True)

    def true64(x):
        u = u_dL.double() + x.double()
        r_ = [torch.where(free, b64 - A64(v), 0.0) for v in (u,
                                                           u_dL.double())]
        return float(torch.sqrt(torch.sum(r_[0] ** 2 * w64))
                     / torch.sqrt(torch.sum(r_[1] ** 2 * w64)))

    def runner(op, pdt, m):
        kA, kB = op.fused_cg_kernels(defer_x=bool(m))
        inv, w = operands[pdt]
        return lambda tol, max_iter: cg_fused(
            kA, kB, r0, inv=inv, w_free=w, tol=tol, max_iter=max_iter,
            p_dtype=pdt, defer_x=m, A=op)

    def timed(run, tol, max_iter):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run(tol, max_iter)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def profiled(run):
        run(0.0, PROFILE_ITERS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = timed(run, 0.0, PROFILE_ITERS)
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e6
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:4]
        return dict(device_ms_per_iter=1e3 * busy / PROFILE_ITERS,
                    launches_per_iter=sum(e.count for e in ev)
                    / PROFILE_ITERS, busy=busy / wall,
                    top={e.key[:60]: e.self_device_time_total / 1e3
                         / PROFILE_ITERS for e in top})

    modes = {"fused": (None, 0), "fused-m8": (None, 8),
             "fused-bf16p": (torch.bfloat16, 0)}
    out = dict(card=card, E=E, max_halo=args.max_halo,
               far_entries=far.n_entries, setup_s=setup_s, runs=[])
    for mode, (pdt, m) in modes.items():
        for label in ("unsplit", "split", "split", "unsplit"):
            run = runner(split if label == "split" else whole, pdt, m)
            kernels.reset_launch_counts()
            res, dt = timed(run, TOL, 20000)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            ts = [timed(run, 0.0, it) for it in STEADY]
            steady = 1e3 * (ts[1][1] - ts[0][1]) / (ts[1][0].issued
                                                    - ts[0][0].issued)
            rec = dict(mode=mode, variant=label, iterations=int(
                res.iterations), issued=res.issued,
                converged=bool(res.converged), seconds=dt,
                ms_per_issued=1e3 * dt / res.issued, steady_ms=steady,
                true64_rel=true64(res.x), launches=counts,
                **profiled(run))
            out["runs"].append(rec)
            print(f"{mode} {label}: {rec['iterations']} its / {res.issued} "
                  f"issued, {dt:.3f} s ({rec['ms_per_issued']:.4f} ms per "
                  f"issued), steady {steady:.4f} ms, device "
                  f"{rec['device_ms_per_iter']:.4f} ms and "
                  f"{rec['launches_per_iter']:.1f} launches per iteration, "
                  f"busy {rec['busy']:.0%}, float64 true residual "
                  f"{rec['true64_rel']:.3e}, top {rec['top']}", flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    Path(ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "far_split_1m.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
