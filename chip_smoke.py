#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``spectralelementmethod_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the build seconds;
2. at the main path's full shapes — ``rectangle_mesh(316, 316, 8)``,
   E = 99,856 elements, n = 81 nodes each, float32 — hold each kernel
   against its plain PyTorch version on the same inputs on the card, and
   time both (CUDA events), beside the least time the card could take;
   then hold the product kernels against their plain versions at the
   other compiled orders (p = 2..7) on a small mesh;
3. run ``Poisson.solve_local`` on that mesh in the three main-path modes
   (plain CG; fused CG; fused CG with bf16 directions) to two tolerances,
   with the launch counts set to 0 just before each solve and read just
   after; require convergence (except the bf16 mode at the tight
   tolerance, whose stopping point is recorded) and agreement on
   iterations, print each solve's true residual, then profile each mode;
4. solve a manufactured problem (u = 0.1 (x + y), Dirichlet + Neumann)
   and require the reference's error bar;
5. print the card, one ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, ...}`` line.

Imports nothing of JAX.  Exits 2 without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"      # long logs (ptxas reports, solves)

# H100 SXM data-sheet peaks (dense): HBM bytes/s and f32 CUDA-core flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

NX = NY = 316          # E = 99,856: the reference bench's default 100k mesh
ORDER = 8
MAX_ITER = 20000
# TOL_ALL is the tolerance all three modes reach.  With bf16-stored
# directions Jacobi PCG at this size stops converging near 1e-3 relative,
# so only the f32 modes must reach TOL_F32; the bf16 mode's run to TOL_F32
# records where it stops (its best residual and iteration)
TOL_ALL, TOL_F32 = 2e-3, 1e-4
PROFILE_ITERS = 1024
# the fused modes may take up to this factor more (or fewer) iterations
# than plain CG: the fused solver's true-residual restarts (taken when a
# 64+-iteration block shrinks the residual by < 4x) discard the Krylov
# space, and bf16 directions perturb it.  On an H100 the spread was
# 392 / 392 / 471 (plain / fused / fused-bf16p) at TOL_ALL and 5474 /
# 6229 (plain / fused) at TOL_F32, at most 1.21x; the bar leaves room
# above that and no more
ITER_RATIO = 1.3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def gpu_ms(fn, args_list, reps: int = 20) -> float:
    """Median device time of one call, in ms.  A sleep kernel first lets
    the host queue every launch, so the events time the device alone;
    the inputs rotate over ``args_list`` (sized past the 50 MB L2)."""
    import torch

    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        torch.cuda._sleep(50_000_000)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        ev[0].record()
        for i in range(reps):
            fn(*args_list[i % len(args_list)])
            ev[i + 1].record()
        torch.cuda.synchronize()
        times += [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    tb, tf = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def rel_err(got, ref) -> tuple[float, float]:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


def bf16_ulp_ok(got, ref) -> bool:
    """|got - ref| <= one bf16 ulp of ref, elementwise."""
    import torch

    r = ref.float()
    e = torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
    return bool(((got.float() - r).abs() <= torch.exp2(e - 7)).all())


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np

        from spectralelementmethod_torch.basis import gll_basis_2d
        from spectralelementmethod_torch.config import resolve_device
        from spectralelementmethod_torch.core.discretization import (
            Discretization)
        from spectralelementmethod_torch.mesh import rectangle_mesh
        from spectralelementmethod_torch.models.poisson import Poisson
        from spectralelementmethod_torch.ops import kernels
        from spectralelementmethod_torch.ops.exchange import roll_dss_T
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    OUT.mkdir(exist_ok=True)
    dev = resolve_device()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = kernels.build()
    t_build = time.perf_counter() - t0
    log(f"[1] built {len(logs)} kernel libraries in {t_build:.1f} s")
    (OUT / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"===== {k}\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and "Li81E" in line:
                log(f"  {name}: {line.split('for ')[-1][:60]} "
                    f"{lines[i + 1].strip()} | {lines[i + 2].strip()}")

    # -- 2. each kernel against its plain version at full size ---------------
    t0 = time.perf_counter()
    disc = Discretization(rectangle_mesh(NX, NY, ORDER), gll_basis_2d(ORDER))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    ctx = prob._local_setup(dev)
    A = ctx["A"]
    Kst, aT, plan = A.Kst, A.aT, A.plan
    n, E = disc.n_loc, disc.E
    inv32, w32 = prob._fused_cg_operands(ctx["ex"], ctx["free_np"], None, dev)
    inv16, w16 = prob._fused_cg_operands(ctx["ex"], ctx["free_np"],
                                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    log(f"[2] setup of E={E}, n={n} in {time.perf_counter() - t0:.1f} s "
        f"({plan.n_entries} DSS entries in {plan.masks.shape[0]} classes, "
        f"nb={plan.nb})")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(dtype=torch.float32):
        return torch.randn((n, E), generator=g, device=dev).to(dtype)

    nE = n * E
    # the CG scalars as float32 device tensors, as the solver passes them:
    # a Python float would cost a blocking host-to-device copy per call
    beta, alpha_prev, alpha = (torch.tensor(v, device=dev)
                               for v in (0.7, 0.4, 0.3))
    mask_bytes = plan.masks.numel()
    small = aT.numel() * 4 + Kst.numel() * 4 + mask_bytes
    rows = []

    # kernel 1
    sets = [(randn(), Kst, aT, plan) for _ in range(3)]
    got = kernels.affine_apply_dss(*sets[0])
    ref = kernels.affine_apply_dss_plain(*sets[0])
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    log(f"  affine_apply_dss: max abs err {err:.3e}, rel {rel:.3e}")
    check(rel <= 1e-5, "affine_apply_dss matches its plain version (1e-5)")
    K2 = Kst.reshape(3 * n, n)
    ms = gpu_ms(kernels.affine_apply_dss, sets)
    plain_ms = gpu_ms(kernels.affine_apply_dss_plain, sets)
    lib_ms = gpu_ms(torch.matmul, [(K2, s[0]) for s in sets])
    b_ms, b_by = bound(8 * nE + small, 6 * n * n * E + 5 * nE
                       + plan.n_entries * E)
    rows.append(dict(name="affine_apply_dss", max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms))

    # kernel A, f32 and bf16 directions
    for tag, pdt, inv in (("f32", torch.float32, inv32),
                          ("bf16", torch.bfloat16, inv16)):
        sets = [(randn(), randn(pdt), inv, randn(), beta, alpha_prev, Kst,
                 aT, plan) for _ in range(2)]
        gp, gAp, gx, gd = kernels.cg_kernel_a(*sets[0])
        rp, rAp, rx, rd = kernels.cg_kernel_a_plain(*sets[0])
        torch.cuda.synchronize()
        _, rel_x = rel_err(gx, rx)
        check(rel_x <= 1e-5, f"cg_kernel_a[{tag}] x' (1e-5)")
        if pdt == torch.bfloat16:
            check(bf16_ulp_ok(gp, rp), f"cg_kernel_a[{tag}] p' within 1 "
                  "bf16 ulp")
            # Ap' and the partials from the kernel's own stored p'
            S = kernels._local_product(gp.float(), Kst, aT)
            rAp, rd = roll_dss_T(S, plan), (gp.float() * S).sum(0)
        else:
            _, rel_p = rel_err(gp, rp)
            check(rel_p <= 1e-5, f"cg_kernel_a[{tag}] p' (1e-5)")
        err, rel = rel_err(gAp, rAp)
        check(rel <= 1e-5, f"cg_kernel_a[{tag}] Ap' (1e-5 of max)")
        d_rel = abs(gd.sum().item() - rd.sum().item()) / abs(rd.sum().item())
        check(d_rel <= 1e-5, f"cg_kernel_a[{tag}] <p', Ap'> partials "
              f"({d_rel:.2e} <= 1e-5)")
        log(f"  cg_kernel_a[{tag}]: max abs err Ap' {err:.3e}, rel {rel:.3e}")
        ms = gpu_ms(kernels.cg_kernel_a, sets)
        plain_ms = gpu_ms(kernels.cg_kernel_a_plain, sets)
        # r, x in and x', Ap' out in f32; p, inv in and p' out in p's dtype
        s = 2 if pdt == torch.bfloat16 else 4
        b_ms, b_by = bound(4 * 4 * nE + 3 * s * nE + small,
                           6 * n * n * E + 12 * nE + plan.n_entries * E)
        rows.append(dict(name=f"cg_kernel_a[{tag}]", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None))

    # kernel B, f32 and bf16 operands
    for tag, inv, w in (("f32", inv32, w32), ("bf16", inv16, w16)):
        sets = [(randn(), randn(), inv, w, alpha) for _ in range(3)]
        gr, grz, grn = kernels.cg_kernel_b(*sets[0])
        rr, rrz, rrn = kernels.cg_kernel_b_plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(gr, rr)
        log(f"  cg_kernel_b[{tag}]: max abs err r' {err:.3e}, rel {rel:.3e}")
        check(rel <= 1e-6, f"cg_kernel_b[{tag}] r' (1e-6)")
        for what, a, b in (("<w r', z'>", grz, rrz), ("<w r', r'>", grn, rrn)):
            d = abs(a.sum().item() - b.sum().item()) / abs(b.sum().item())
            check(d <= 1e-5, f"cg_kernel_b[{tag}] {what} partials "
                  f"({d:.2e} <= 1e-5)")
        ms = gpu_ms(kernels.cg_kernel_b, sets)
        plain_ms = gpu_ms(kernels.cg_kernel_b_plain, sets)
        s = 2 if inv.dtype == torch.bfloat16 else 4
        b_ms, b_by = bound(3 * 4 * nE + 2 * s * nE, 7 * nE)
        rows.append(dict(name=f"cg_kernel_b[{tag}]", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}, library "
            f"{r['library_ms']})")

    # the other compiled orders (n = 9 .. 64) on a small mesh whose E is
    # no multiple of the block size: the product kernels against their
    # plain versions
    for p in range(2, ORDER):
        sdisc = Discretization(rectangle_mesh(24, 20, p), gll_basis_2d(p))
        sprob = Poisson(sdisc, dtype=np.float32)
        sA = sprob._local_setup(dev)["A"]
        sK, saT, splan = sA.Kst, sA.aT, sA.plan
        shp = (sdisc.n_loc, sdisc.E)
        u = torch.randn(shp, generator=g, device=dev)
        _, rel = rel_err(kernels.affine_apply_dss(u, sK, saT, splan),
                         kernels.affine_apply_dss_plain(u, sK, saT, splan))
        rels = [rel]
        for pdt in (torch.float32, torch.bfloat16):
            args = (u, torch.randn(shp, generator=g, device=dev).to(pdt),
                    torch.rand(shp, generator=g, device=dev).to(pdt),
                    torch.randn(shp, generator=g, device=dev), 0.7, 0.4, sK,
                    saT, splan)
            got, ref = (kernels.cg_kernel_a(*args),
                        kernels.cg_kernel_a_plain(*args))
            rels += [rel_err(a, b)[1] for a, b in zip(got[:3], ref[:3])]
            rels.append(abs(got[3].sum().item() - ref[3].sum().item())
                        / abs(ref[3].sum().item()))
        check(max(rels) <= 1e-5, f"p={p} (n={sdisc.n_loc}, E={sdisc.E}): "
              f"apply and kernel A match their plain versions "
              f"({max(rels):.1e} <= 1e-5)")

    # -- 3. the main path: solve_local in its three modes ---------------------
    log(f"[3] solve_local on rectangle_mesh({NX}, {NY}, {ORDER}), f32, "
        f"max_iter={MAX_ITER}")
    free, to_local = ctx["free_local"], ctx["to_local"]
    w = ctx["ex"].weights_T(torch.float32, dev)
    bL = to_local(np.asarray(prob._b) + prob._neumann)

    def true_residual(u):
        """||b - A u|| on the free rows, weighted: one f32 apply."""
        rt = torch.where(free, bL - ctx["A_raw"](to_local(u)), 0.0)
        return float(torch.sqrt(torch.sum(rt * rt * w)))

    r0 = true_residual(np.where(prob._dirichlet_mask, prob._dirichlet_vals,
                                0.0))
    modes = {"plain": dict(cg_kernel="plain"),
             "fused": dict(cg_kernel="fused"),
             "fused-bf16p": dict(cg_kernel="auto", p_dtype=torch.bfloat16)}
    runs = [(m, tol) for tol in (TOL_ALL, TOL_F32) for m in modes]
    solves, launches = {}, {m: dict.fromkeys(kernels.WRAPPERS, 0)
                            for m in modes}
    for name, tol in runs:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sol = prob.solve_local(tol=tol, max_iter=MAX_ITER, **modes[name])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for k, c in kernels.launch_counts().items():
            launches[name][k] += c
        its, issued = int(sol.cg.iterations), sol.cg.issued
        res = float(sol.cg.residual_norm)
        true_rel = true_residual(sol.u) / r0
        key = f"{name}@{tol:g}"
        solves[key] = dict(iterations=its, issued=issued, seconds=dt,
                           ms_per_issued=1e3 * dt / issued,
                           recurrence_rel=res / r0, true_rel=true_rel,
                           converged=bool(sol.cg.converged))
        log(f"  {key}: {its} its / {issued} issued, {dt:.3f} s, "
            f"{1e3 * dt / issued:.4f} ms/iteration issued, residual "
            f"{res / r0:.3e} relative (true {true_rel:.3e}), converged "
            f"{bool(sol.cg.converged)}")
        check(bool(np.isfinite(sol.u).all()) and sol.u.shape
              == (disc.n_nodes,), f"{key}: finite solution of the mesh's "
              "shape")
        if (name, tol) != ("fused-bf16p", TOL_F32):
            check(bool(sol.cg.converged), f"{key} converged")
    log(f"  launches on the main path: {launches}")
    for tol, names in ((TOL_ALL, ("fused", "fused-bf16p")),
                       (TOL_F32, ("fused",))):
        p_its = solves[f"plain@{tol:g}"]["iterations"]
        for name in names:
            its = solves[f"{name}@{tol:g}"]["iterations"]
            check(p_its / ITER_RATIO <= its <= ITER_RATIO * p_its,
                  f"{name}@{tol:g} iterations ({its}) within a factor "
                  f"{ITER_RATIO} of plain ({p_its})")
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # where one solve's time goes: PROFILE_ITERS iterations of each mode
    # under the profiler (device time by kernel, and the device's busy
    # share; the window includes the solve's staging and host copies)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, kw in modes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prob.solve_local(tol=0.0, max_iter=PROFILE_ITERS, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e6
        log(f"  profile {name}: {PROFILE_ITERS} iterations in {wall:.3f} s "
            f"wall (profiled), device busy {busy:.3f} s "
            f"({busy / wall:.0%})")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3 / PROFILE_ITERS:8.4f} "
                f"ms/iter  x{e.count / PROFILE_ITERS:5.2f}  {e.key[:70]}")

    # -- 4. manufactured solution ---------------------------------------------
    # 32x32 p=8: the f32 recurrence reaches tol=1e-7 there, and the error
    # bar is the reference's f32 bar (tests/test_cg_fused.py: 1e-4)
    mdisc = Discretization(rectangle_mesh(32, 32, ORDER), gll_basis_2d(ORDER))
    mprob = Poisson(mdisc, forcing=0.0, dtype=np.float32)
    mprob.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    mprob.set_neumann("nbc", 0.1)
    x, y = mprob.x_nodes
    for name, kw in modes.items():
        sol = mprob.solve_local(tol=1e-7, max_iter=MAX_ITER, **kw)
        err_max = float(np.abs(sol.u - 0.1 * (x + y)).max())
        err_l2 = mprob.l2_error(sol.u, lambda x, y: 0.1 * (x + y))
        log(f"[4] manufactured 32x32 p=8 {name}: {int(sol.cg.iterations)} "
            f"its, max err {err_max:.3e}, l2 err {err_l2:.3e}")
        check(bool(sol.cg.converged) and err_l2 < 1e-4,
              f"manufactured solution ({name}): l2 error below 1e-4")

    # -- 5. report --------------------------------------------------------------
    # launches per row: the apply over all runs (the fused modes call it
    # for their true-residual restarts), kernels A and B in the mode that
    # runs each variant
    total = {k: sum(c[k] for c in launches.values())
             for k in kernels.WRAPPERS}
    row_launches = {"affine_apply_dss": total["affine_apply_dss"]}
    for tag, mode in (("f32", "fused"), ("bf16", "fused-bf16p")):
        for k in ("cg_kernel_a", "cg_kernel_b"):
            row_launches[f"{k}[{tag}]"] = launches[mode][k]
    out = []
    for r in rows:
        base = r["name"].split("[")[0]
        src, replaces = kernels.KERNELS[base]
        out.append(dict(name=r["name"], route="cuda",
                        source=f"spectralelementmethod_torch/csrc/{src}",
                        replaces=replaces, launches=row_launches[r["name"]],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"], library_ms=r["library_ms"]))
    for name, count in row_launches.items():
        check(count > 0, f"{name} launched on the main path ({count})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
