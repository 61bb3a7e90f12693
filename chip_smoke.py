#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build the CUDA kernels from ``spectralelementmethod_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the build seconds;
2. at the main path's full shapes — ``rectangle_mesh(316, 316, 8)``,
   E = 99,856 elements, n = 81 nodes each, float32, and stacks of K = 4
   right-hand sides — hold each affine kernel (single-RHS, deferred-x and
   batched variants) against its plain PyTorch version on the same inputs
   on the card, and time both (CUDA events), beside the least time the
   card could take; the same for the curved-mesh kernels (the general
   apply and kernel A, one RHS and K) on the polar half-annulus of the
   same E; the single-kernel iteration (f32 and bf16, with x and
   deferred), bit for bit on r', p' and x'; the Ap' of every affine
   kernel A and single-kernel variant bit for bit against the affine
   apply of its own stored p', and of every general kernel A variant
   against the general apply of its own stored p'; time the deferred-x
   catch-up; the element-local Laplacian of the row-major (E, n) layout
   (one array, K packed components, a stack of K) on the annulus factors
   of the Helmholtz problem below; the element-sharded operator on S_SH =
   4 shards of the rectangle (each shard's block kernel against its plain
   version, the assembled centres against the global apply, the whole
   sharded apply and one block launch timed) and the far split at
   ``max_halo=FAR_HALO`` (the far update against its plain version, the
   split applies of the rectangle and the annulus against the unsplit);
   then hold every kernel against its plain version at the other compiled
   orders (p = 2..7) on a small rectangle (the block kernel on 2 shards,
   the far update at ``max_halo=1`` bit for bit, there and on the small
   annulus; the element-local kernel with 16-byte and 4-byte staging;
   kernel A's and the single kernel's Ap' against the apply of their own
   p' bit for bit) and a small annulus (the general kernel A's Ap' against
   the general apply of its own p' bit for bit); at p = 1 (n = 4, the
   p-multigrid coarse level, which only the apply kernels are compiled
   for, one launch each) the affine and the general apply, one RHS, three
   and with ``aux``, and the block apply on 2 shards there, and the four
   apply rows timed at the coarse level's full shapes (the rectangle and
   the annulus at p = 1), each p = 1 apply and the block apply issuing
   one device kernel per call (profiler count);
3. run ``Poisson.solve_local`` on the rectangle in the three main-path
   modes (plain CG; fused CG; fused CG with bf16 directions), with
   deferred x (``defer_x=8``), with the general apply forced
   (``structure="general"``) and with one kernel per iteration
   (``cg_kernel="fused1"``: f32 and bf16, with and without ``defer_x=8``),
   and ``Poisson.solve_local_batch`` on K = 4
   forcings in five modes (plain; fused; fused with bf16 directions; each
   fused mode with ``defer_x=8``); on the annulus the three modes, single
   and batched; to two tolerances, with the launch counts set to 0 just
   before each solve and read just after; require convergence (except
   the bf16 modes at the tight tolerance, whose stopping point is
   recorded) and agreement on iterations with plain CG of the same mesh,
   print each solve's (each RHS's) true residual, the gap between the
   L-vector solution and its global field, and ms per issued iteration
   per RHS; (3e, after those solves) on the rectangle with S_SH shards
   ``sharded_local_poisson_problem(comm="shardmap-fused")`` and
   ``comm="shardmap"`` solved by ``cg(..., dot=ex.dot_T)``, and plain CG on
   the far-split apply, each within 2 iterations of plain CG, with its
   true residual, CG ms per issued iteration and kernel launches; time
   every mode's steady state (two fixed-length runs); then
   profile each single-RHS mode, ``fused1`` with bf16 directions, the
   batched bf16 deferred mode and the curved bf16 mode (device time and
   launches per iteration, busy share); then the variable-coefficient
   Helmholtz problem (BASELINE config 3: c = 1 + 0.1 r, k = 2 + x^2) on the
   annulus: ``Helmholtz.solve_local`` in the row-major layout with the
   element-local kernel (``vector_layout="en", backend="pallas"``) and
   with ``torch.matmul`` (``"xla"``, the comparison), in the default
   transposed layout, and ``solve_local_batch`` on K forcings with the
   kernel; iterations, reported and true residuals, seconds, steady state,
   and one profile; (3f) the backend of every f32 operator of the main
   path is "fused"; a float64 model and a Morton-ordered mesh take the
   "xla" operator, launch no kernel, solve, and refuse
   ``backend="fused"``; a float32 operator at p = 9 (no apply kernel)
   raises ``NotImplementedError`` under "auto" and "fused", and its
   explicit "xla" operator agrees with the float64 one; (3p) ``precond="pmg"`` (the two-level p-multigrid
   V-cycle) to 1e-6: on the rectangle (GridFDM coarse solve; the
   iterations beside the reference's 18, ``_lmax_f`` within 3% of its
   2.4329, lambda_max(M A) beside its 0.998, the reported and the
   float64-evaluated true residual, ms per V-cycle and per iteration, one
   profile, the setup stages), with the Chebyshev coarse level, on the
   annulus (these two with ms per V-cycle, the p = 1 launches per
   iteration and one profile each), Helmholtz config 3, the k = 4
   batches of both meshes, every level of each V-cycle on the apply
   kernels; and a float64 model with
   the float32 cycle to 1e-10 against its manufactured solution through
   the "xla" outer apply; (3r) ``solve_local(tol=1e-6, precond="pmg",
   certify=True)`` (the float64-certified solve) twice on the rectangle
   and on the annulus: converged and not stalled, the float64 iterate's
   true residual recomputed by a float64 operator built here at most 1.05
   tol of ``||b_hi||_w``, the repeat call bit for bit, the rectangle's
   iterations within 27 +- 5 of at most 128 issued (the reference's arm),
   its warm and timed seconds, setup stages, one profile of the whole
   schedule and the float64 anchor's time; certify on a float64 model (the
   plain solve, no kernel); one certified call at 1,048,576 elements
   (``rectangle_mesh(1024, 1024, 8)``: converged, the recomputed
   residual, setup seconds); ``Poisson.solve`` with and without
   ``host_loop`` and ``solve_local(host_loop=True)`` on a float64
   manufactured problem; (3s) the FDM additive Schwarz
   (``precond="fdm"``) on the rectangle to both tolerances (fewer than 0.7x
   plain CG's iterations at 2e-3), on the annulus and on a k = 4 batch;
   the row-major layout (``vector_layout="en"``: Jacobi, fdm and a k = 4
   batch through ``cg_batched``'s per-RHS mode, each within 2 iterations
   (or 1%) of its "ne" counterpart, no kernel launched); the fdm M apply
   alone (device and host ms, launches, bound) and a profile of fdm-PCG;
   pmg with the fdm smoother to 1e-6; ``certify=True`` with fdm on an 8 x 8
   rectangle (converged, the recomputed float64 residual at most 1.05 tol)
   and on the 100k one (its flag agrees with the recomputed residual); a
   bf16-product (``compute_dtype``) solve and apply (within 0.03 of max of
   the float32 apply; ``backend="fused"`` refuses it); the precision tiers
   bit for bit on the apply kernels; (3t) the 3D hexahedral path on
   ``box_mesh(27, 27, 27, 8)`` (E = 19,683, 10.2M nodes, float32, the
   reference bench's 3D problem): Jacobi CG to 1e-5 within 5% of the
   reference's 618 iterations, fdm under 0.6x and pmg (to 1e-6, the exact
   ``GridFDM3D`` coarse solve) under 0.5x Jacobi's, the certified pmg
   solve (converged, its float64 iterate's residual recomputed by a
   float64 operator built here at most 1.05 tol), a k = 4 fdm batch (each
   RHS within 2 iterations of its single solve), the variable-coefficient
   (general) structure and a shuffled element order through
   ``PairScatterExchange`` (its DSS against the plane-roll DSS to float32
   rounding, its iterations within 2 of the box order's); every 3D solve
   launches none of the kernels above; each structure's apply, local
   product and DSS timed beside its bound, launches per apply, and one
   64-iteration profile of Jacobi CG; (3u) in float64, with no kernel of
   the table launched: the squirmer's swimming speed on the original
   library's donut at p = 8 (E = 135, Re = 1, beta = 1) within 3e-6 of
   the golden 0.92571156681, warm and timed, with its secant iterations
   and Newton steps and the device ms of the Jacobian, the Schur factors,
   the dense LU, the Schur apply and the direct step; one Newton solve by
   GMRES-IR within 1e-8 of the direct one; the device Newton loop against
   the host loop; the fixed sphere's drag within 6% of -6 pi; one Newton
   solve on the donut refined to E = 540 (16,970 condensed DOFs: steps,
   seconds, the LU's device ms, peak memory); the manufactured
   advection-diffusion problem by Jacobi-GMRES(40) to 1e-10 on
   ``rectangle_mesh(AD_N, AD_N, 8)`` (iterations, within 5% of the CPU's,
   L2 error; a short solve repeated bit for bit) and two
   restart cycles on the 100k mesh (ms per iteration, a profile: device
   ms, launches, busy share; then ``solve_batch`` with k = 4);
4. solve three manufactured problems (u = 0.1 (x + y) on a rectangle,
   Dirichlet + Neumann; u = ln r on the annulus, Dirichlet + natural; the
   reference's config-3 Helmholtz solution on a graded annulus through the
   element-local kernel) and require the reference's error bars;
5. print the total seconds, the card, one ``{"kernels": [...]}`` line and,
   last, the ``{"ok": true, ...}`` line.

Imports nothing of JAX.  Exits 2 without a CUDA device or without the
package beside it.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"      # long logs (ptxas reports, solves)

# H100 SXM data-sheet peaks (dense): HBM bytes/s and f32 CUDA-core flop/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

NX = NY = 316          # E = 99,856: the reference bench's default 100k mesh
NX_1M = 1024           # E = 1,048,576: the reference's 1M cell (phase 3r)
ORDER = 8
# the curved path: the reference's isoparametric half-annulus with every
# node polar-exact, 632 x 158 = 99,856 elements (cell aspect 1.3-1.6)
ANNULUS = dict(n_theta=632, n_r=158, r_inner=1.0, r_outer=2.0,
               progression=1.0, node_placement="polar")
SMALL_ANNULUS = dict(ANNULUS, n_theta=25, n_r=19)     # E = 475
MMS_ANNULUS = dict(ANNULUS, n_theta=32, n_r=8)        # the ln r check
MAX_ITER = 20000
# TOL_ALL is the tolerance all three modes reach.  With bf16-stored
# directions Jacobi PCG at this size stops converging near 1e-3 relative,
# so only the f32 modes must reach TOL_F32; the bf16 mode's run to TOL_F32
# records where it stops (its best residual and iteration)
TOL_ALL, TOL_F32 = 2e-3, 1e-4
PROFILE_ITERS = 512    # the profiler's post-processing grows with them
K = 4                  # right-hand sides of the batched solves (the bench's)
DEFER = 8              # defer_x of the deferred modes (the bench's)
S_SH = 4               # element shards of the sharded operator and solves
# max_halo of the far split: the rectangle's vertical classes (|delta| =
# NX - 1 .. NX + 1) and the annulus's radial ones go far
FAR_HALO = 128
STEADY = (512, 1536)   # iterations of the two steady-state timing runs
# the Helmholtz modes' steady state and profile: the (E, n) exchanges are
# plain PyTorch passes (~2 ms per iteration), so fewer iterations do
HELM_STEADY = (128, 384)
HELM_PROFILE_ITERS = 128
# the fused modes may take up to this factor more (or fewer) iterations
# than plain CG: the fused solver's true-residual restarts (taken when a
# 64+-iteration block shrinks the residual by < 4x) discard the Krylov
# space, and bf16 directions perturb it.  On an H100 the spread was
# 392 / 392 / 471 (plain / fused / fused-bf16p) at TOL_ALL and 5474 /
# 6229 (plain / fused) at TOL_F32 on the rectangle, 447 / 447 / 449 and
# 2548 / 2971 on the annulus, at most 1.21x (one kernel per iteration:
# 393 / 472 and 6222); the bar leaves room above that and no more
ITER_RATIO = 1.3
# plain CG's iterations to TOL_ALL on the rectangle on an H100, with every
# apply kernel since PR 1 (the assembled-K and the tensor-product ones);
# plain CG with either apply must stay within 2 of them
PLAIN_ITS = 392
# the pmg cells' tolerance, and the reference's hardware-free numbers of
# its converged arm on the rectangle with f32 V-cycle matmuls
# (BASELINE.md round-5a): 18 iterations to the claimed 1e-6, the
# 30-iteration lmax estimate 2.4329 (before the 1.05 safety factor), and
# lambda_max(M A) 0.998
TOL_PMG = 1e-6
PMG_ITS = 18
PMG_LMAX30 = 2.4329
PMG_LAM_MA = 0.998
# phase 3t, the 3D path: the reference's recorded 3D cell (BASELINE.md:177,
# :197; bench.py --ndim 3 at 19,683 elements): box_mesh(27, 27, 27, 8),
# Jacobi CG to 1e-5 in 618 iterations; the bar is 5%
NX3 = 27
JAC3_ITS = 618
TOL3 = 1e-5
PROFILE3_ITERS = 64
# the 3D local apply's flops per element (bench.py:233-236: six (p1, p1)
# products over p1^2 lines and ~15 pointwise per node)
def flops3(p1: int) -> int:
    return 12 * p1**4 + 15 * p1**3


# phase 3u, the squirmer and advection-diffusion: the original library's
# donut (examples/meshes/donut.geo: 9 x 15 transfinite, progression 1.35,
# R = 100) at p = 8, E = 135, and its refinement by 2 in each direction
# (E = 540); the golden speed at Re = 1, beta = 1 and its 3e-6 bar (the JAX
# package's tests/test_squirmer.py)
SQ_GOLDEN = dict(order=8, n_theta=9, n_r=15, r_outer=100.0,
                 progression=1.35, node_placement="gmsh")
SQ_540 = dict(SQ_GOLDEN, n_theta=18, n_r=30)
GOLDEN_SPEED = 0.92571156681483957
# advection-diffusion (tests/test_advection_diffusion.py's manufactured
# problem: eps = 0.5, c = (1, 0.5)): AD_N is the largest rectangle_mesh(n,
# n, 8) whose float64 Jacobi-GMRES(40) reaches 1e-10 within 100 restarts
# (scripts/torch_advdiff_size.py on the CPU: n = 24 converges in
# AD_CPU_ITERS = 3,453 iterations, 25-28 do not; the card's count, the same
# in every run since the DSS sums in a fixed order, is held to it within
# AD_ITERS_REL), AD_BIG_N the 100k mesh, run for AD_CYCLES restart cycles
AD_N = 24
AD_CPU_ITERS = 3453
AD_ITERS_REL = 0.05
AD_BIG_N = 316
AD_RESTART = 40
AD_CYCLES = 2
AD_EPS, AD_C = 0.5, (1.0, 0.5)


def ad_u(x, y):
    return np.sin(np.pi * (x + 1) / 2) * np.sin(np.pi * (y + 1) / 2)


def ad_f(x, y):
    """-eps lap u + c . grad u for u = ad_u."""
    X, Y = np.pi * (x + 1) / 2, np.pi * (y + 1) / 2
    lap = -2 * (np.pi / 2) ** 2 * np.sin(X) * np.sin(Y)
    gx = (np.pi / 2) * np.cos(X) * np.sin(Y)
    gy = (np.pi / 2) * np.sin(X) * np.cos(Y)
    return -AD_EPS * lap + AD_C[0] * gx + AD_C[1] * gy


# kernels that no solve of the system calls, so that no path launches them
# (their rows report the launches they got, 0)
OFF_PATH = {"vector_laplacian_local": (
    "k components packed as (E, k n): the reference's only caller is a "
    "test; the same kernel as laplacian_local with the component stride "
    "n, held against its plain version in phase 2")}


# BASELINE config 3 (the reference's tests/test_helmholtz.py): diffusivity
# c = 1 + 0.1 r, reaction k = 2 + x^2, and a manufactured solution
def helm_c(x, y):
    return 1.0 + 0.1 * np.sqrt(x * x + y * y)


def helm_k(x, y):
    return 2.0 + x * x


def helm_u(x, y):
    return np.exp(-((x - 1.5) ** 2 + y * y))


def helm_f(x, y):
    """-div(c grad u) + k u for u = helm_u."""
    r = np.sqrt(x * x + y * y)
    u = helm_u(x, y)
    ux, uy = -2 * (x - 1.5) * u, -2 * y * u
    uxx, uyy = (-2 + 4 * (x - 1.5) ** 2) * u, (-2 + 4 * y * y) * u
    return (-(0.1 * x / r * ux + 0.1 * y / r * uy
              + helm_c(x, y) * (uxx + uyy)) + helm_k(x, y) * u)


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


def device_events(fn, args_list) -> list:
    """The profiler's device events (by name: count, device time) of one
    call of ``fn`` per entry of ``args_list``, after one warm-up pass.  A
    trace that holds no device event at all (the profiler's device buffer
    can come back empty after many good traces) is taken again, up to
    twice; a trace with events is never retaken."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for a in args_list:
        fn(*a)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in args_list:
                fn(*a)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        if ev:
            break
        log("  (the profiler recorded no device event; tracing again)")
    return ev


def device_kernels(fn, args_list) -> dict[str, int]:
    """Device kernels (copies and fills left out) that one call of ``fn``
    per entry of ``args_list`` issues, by name."""
    return {e.key: e.count for e in device_events(fn, args_list)
            if not e.key.startswith(("Memcpy", "Memset"))}


def device_per_call(fn, args_list) -> tuple[float, float]:
    """Device ms and device launches per call of ``fn`` (the profiler's
    sum over the calls, so host gaps between the calls do not count)."""
    ev = device_events(fn, args_list)
    n = len(args_list)
    return (sum(e.self_device_time_total for e in ev) / 1e3 / n,
            sum(e.count for e in ev) / n)


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


def rhs_rel(a, b, k: int) -> float:
    """Largest relative difference between the per-RHS totals of two
    partial-sum arrays ((G, k), (E, k), or (G,) / (E,) for one RHS)."""
    ta = a.double().reshape(-1, k).sum(0)
    tb = b.double().reshape(-1, k).sum(0)
    return ((ta - tb).abs() / tb.abs()).max().item()


def bf16_ulp_ok(got, ref) -> bool:
    """|got - ref| <= one bf16 ulp of ref, elementwise."""
    import torch

    r = ref.float()
    e = torch.floor(torch.log2(r.abs().clamp_min(1e-30)))
    return bool(((got.float() - r).abs() <= torch.exp2(e - 7)).all())


def phase_3t(dev, at, drive, profile_solve, solves) -> None:
    """The 3D hexahedral path on ``box_mesh(NX3, NX3, NX3, ORDER)``
    (float32, the reference bench's problem: forcing 1, Dirichlet 0 on
    "ebc"): Jacobi, fdm and pmg solves, the certified solve, a k = K fdm
    batch, the variable-coefficient (general) structure and the shuffled
    element order (PairScatterExchange), each structure's apply and DSS
    timed beside its bound, launches and one profile of Jacobi CG."""
    import torch

    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.models.poisson import Poisson
    from spectralelementmethod_torch.ops import kernels, sumfac
    from spectralelementmethod_torch.ops.exchange import (
        BoxRollExchange3D, PairScatterExchange, make_exchange)
    from spectralelementmethod_torch.parallel import reorder_elements
    from spectralelementmethod_torch.solver.cg import cg
    from spectralelementmethod_torch.solver.pmg import GridFDM3D
    from spectralelementmethod_torch.utils import stages

    t_3t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()     # the phase's own peak
    out = solves.setdefault("phase_3t", {})
    log(f"[3t] the 3D path: box_mesh({NX3}, {NX3}, {NX3}, {ORDER}), "
        f"float32, Dirichlet 0 on 'ebc', forcing 1 {at()}")
    setup = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = fn()
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
        return val

    stages.snapshot(reset=True)
    mesh = timed("mesh", lambda: box_mesh(NX3, NX3, NX3, ORDER))
    basis = gll_basis_3d(ORDER)
    disc = timed("discretization", lambda: Discretization(mesh, basis))
    prob = timed("model", lambda: Poisson(disc, dtype=np.float32))
    prob.set_dirichlet("ebc", 0.0)
    ctx = timed("operators", lambda: prob._local_setup_3d("jacobi", dev))
    ex, A_raw = ctx["ex"], ctx["A_raw"]
    E, n, p1 = disc.E, disc.n_loc, ORDER + 1
    out["setup_s"] = dict(setup, stages=stages.snapshot(reset=True))
    log(f"  E={E}, n={n}, {disc.n_nodes} nodes, {E * n} local DOFs "
        f"({4 * E * n / 1e6:.1f} MB per float32 L-vector); setup "
        f"{ {k: round(v, 2) for k, v in setup.items()} } {at()}")
    check(type(ex) is BoxRollExchange3D and A_raw.structure == "separable",
          f"box27: the plane-roll exchange (deltas {ex.deltas}) and the "
          "separable apply")

    W3 = np.asarray(basis.weight_grid(), np.float64)

    def float64_check(prob_, ctx_):
        """(the true residual of a float64 L-vector over the lift's, the
        lift, global -> float64 L-vector) by a float64 general operator of
        the model's factor values (the rank-1 field a (x) W on an affine
        mesh), built here apart from the solve's operators."""
        ex_, free_ = ctx_["ex"], ctx_["free"]
        found, a_ = prob_._scales_3d()
        G64 = (a_[:, :, None, None, None] * W3 if found != "general"
               else np.asarray(prob_._G_host, np.float64))
        A64 = sumfac.make_laplacian_3d(ex_, G64, basis, dtype=np.float64,
                                       device=dev, structure="general",
                                       free=free_)
        w_ = ex_._weights_as(torch.float32, dev)

        def l64(v):
            return torch.as_tensor(ex_.local_from_global(
                np.asarray(v, np.float64)), device=dev)

        b_ = l64(np.asarray(prob_._b, np.float64) + prob_._neumann)

        def res(uL64):
            r_ = torch.where(free_, b_ - A64(uL64), 0.0)
            return float(torch.sqrt(torch.sum(w_ * r_ * r_)))

        u_dL = l64(np.where(prob_._dirichlet_mask, prob_._dirichlet_vals,
                            0.0))
        r0 = res(u_dL)
        return (lambda uL64: res(uL64) / r0), u_dL, l64

    chk = float64_check(prob, ctx)

    def solve3(name, prob_, ctx_, tol, chk_, **kw):
        sol, dt = drive(name, lambda: prob_.solve_local(
            tol=tol, max_iter=MAX_ITER, **kw))
        n_launch = sum(kernels.launch_counts().values())
        res = sol.cg
        its = int(res.iterations)
        rec = dict(iterations=its, issued=int(res.issued), seconds=dt,
                   converged=bool(res.converged),
                   true_rel=chk_[0](chk_[2](sol.u)),
                   kernel_launches=n_launch)
        out[name] = rec
        log(f"  {name}: {its} its / {res.issued} issued, converged "
            f"{bool(res.converged)}, {dt:.3f} s ({1e3 * dt / max(its, 1):.3f}"
            f" ms per iteration with setup), true residual "
            f"{rec['true_rel']:.3e} (float64, of the float32 solution), "
            f"{n_launch} kernel launches {at()}")
        check(bool(res.converged) and np.isfinite(sol.u).all()
              and sol.u.shape == (prob_.disc.n_nodes,) and n_launch == 0,
              f"{name}: converged, finite, of the mesh's shape, no kernel "
              "of the 2D table launched")
        return sol, its

    # -- the solves on the box ------------------------------------------------
    _, its_j = solve3(f"box27-jacobi@{TOL3:g}", prob, ctx, TOL3, chk)
    check(abs(its_j - JAC3_ITS) <= 0.05 * JAC3_ITS,
          f"box27-jacobi: {its_j} iterations within 5% of the reference's "
          f"{JAC3_ITS}")
    sol_f, its_f = solve3(f"box27-fdm@{TOL3:g}", prob, ctx, TOL3, chk,
                          precond="fdm")
    check(its_f < 0.6 * its_j, f"box27-fdm: {its_f} iterations < 0.6 x "
          f"Jacobi's {its_j}")
    _, its_p = solve3(f"box27-pmg@{TOL_PMG:g}", prob, ctx, TOL_PMG, chk,
                      precond="pmg")
    M_p = prob._op_cache[("M", "pmg3d", (), str(dev))]
    out["pmg"] = dict(coarse_kind=M_p._coarse_kind, lmax_f=M_p._lmax_f,
                      levels=list(M_p._levels))
    check(its_p < 0.5 * its_j and M_p._coarse_kind == "fdm"
          and isinstance(M_p._coarse, GridFDM3D),
          f"box27-pmg: {its_p} iterations < 0.5 x Jacobi's {its_j}, the "
          f"exact GridFDM3D coarse solve engaged (lmax_f "
          f"{M_p._lmax_f:.4f})")

    # -- the certified solve: twice (warm, timed), its float64 iterate's
    # true residual recomputed by the float64 check operator
    w32 = ex._weights_as(torch.float32, dev)
    stages.snapshot(reset=True)
    for call in ("warm", "timed"):
        sol, dt = drive(f"box27-cert-{call}", lambda: prob.solve_local(
            tol=TOL_PMG, precond="pmg", certify=True))
        if call == "warm":
            cert_stages = stages.snapshot(reset=True)
    res = sol.cg
    rel_x = chk[0](chk[1] + res.x)
    segs = int(np.searchsorted(np.cumsum((64, 32, 32, 64)), res.issued) + 1)
    out["box27-cert"] = dict(
        converged=res.converged, stalled=res.stalled,
        iterations=res.iterations, issued=res.issued, segments_run=segs,
        cycle_resnorms=list(res.cycle_resnorms), true_rel_f64_of_x=rel_x,
        seconds_timed=dt, warm_stages=cert_stages)
    log(f"  box27-cert@{TOL_PMG:g}: converged {res.converged}, stalled "
        f"{res.stalled}, its {res.iterations} / {res.issued} issued, {segs} "
        f"segments, cycle_resnorms "
        f"{[float(f'{v:.3e}') for v in res.cycle_resnorms]}, true float64 "
        f"{rel_x:.3e} of the iterate, timed {dt:.3f} s {at()}")
    check(res.converged and not res.stalled
          and rel_x <= 1.05 * TOL_PMG,
          f"box27-cert: converged, not stalled, the recomputed float64 "
          f"residual {rel_x:.3e} <= 1.05 x {TOL_PMG:g}")

    # -- the k = K fdm batch, each RHS against its single solve ---------------
    F = np.concatenate([np.ones((1, disc.n_nodes)),
                        np.random.RandomState(7).standard_normal(
                            (K - 1, disc.n_nodes))])
    solb, dtb = drive("box27-batch-fdm", lambda: prob.solve_local_batch(
        F, tol=TOL3, precond="fdm", max_iter=MAX_ITER))
    its_b = solb.cg.iterations.cpu().numpy().tolist()
    ctx_f = prob._local_setup_3d("fdm", dev)
    u_dL = torch.zeros((E, n), device=dev)
    singles = [its_f]
    for j in range(1, K):
        bj = disc.scatter_add(disc.gather(F[j]) * disc.detJxW).astype(
            np.float32) + prob._neumann
        r_j = torch.where(ctx_f["free"], ctx_f["to_local"](bj)
                          - ctx_f["A_raw"](u_dL), 0.0)
        singles.append(int(cg(ctx_f["A"], r_j, M=ctx_f["M"], tol=TOL3,
                              max_iter=MAX_ITER, dot_weight=w32).iterations))
    out["box27-batch-fdm"] = dict(iterations=its_b, single=singles,
                                  seconds=dtb, converged=solb.cg.converged
                                  .cpu().numpy().tolist())
    log(f"  box27-batch-fdm (k={K}): its {its_b}, single solves {singles}, "
        f"{dtb:.3f} s {at()}")
    check(bool(solb.cg.converged.all()) and all(
        abs(a - b) <= 2 for a, b in zip(its_b, singles)),
        "box27-batch-fdm: every RHS converged within 2 iterations of its "
        "single solve")

    # -- the general structure and the shuffled order -------------------------
    gprob = Poisson(disc, coefficient=lambda x, y, z: 1.0 + 0.25 * x * x,
                    dtype=np.float32)
    gprob.set_dirichlet("ebc", 0.0)
    gctx = gprob._local_setup_3d("jacobi", dev)
    check(gctx["A_raw"].structure == "general",
          "box27-general: c = 1 + x^2 / 4 takes the general apply")
    solve3(f"box27-general-jacobi@{TOL3:g}", gprob, gctx, TOL3,
           float64_check(gprob, gctx))

    perm = np.random.RandomState(3).permutation(E)
    t0 = time.perf_counter()
    sdisc = Discretization(reorder_elements(mesh, perm), basis)
    sprob = Poisson(sdisc, dtype=np.float32)
    sprob.set_dirichlet("ebc", 0.0)
    sctx = sprob._local_setup_3d("jacobi", dev)
    out["shuffled_setup_s"] = time.perf_counter() - t0
    sex = sctx["ex"]
    check(type(sex) is PairScatterExchange and type(make_exchange(
        sdisc)) is PairScatterExchange,
        "box27-shuffled: make_exchange falls back to PairScatterExchange")
    g = torch.Generator(device=dev).manual_seed(3)
    v = torch.randn((E, n), generator=g, device=dev)
    idx = torch.as_tensor(perm, device=dev)
    d_roll, d_pair = ex.dss(v), sex.dss(v[idx])
    err = float((d_pair - d_roll[idx]).abs().max())
    scale = float(d_roll.abs().max())
    out["shuffled_dss_max_abs_err"] = err
    log(f"  box27-shuffled: PairScatterExchange DSS against the plane-roll "
        f"DSS on the same vector: max abs err {err:.3e} (max {scale:.3e})")
    check(err <= 8 * np.finfo(np.float32).eps * scale,
          "box27-shuffled: the two DSS agree to float32 rounding")
    _, its_s = solve3(f"box27-shuffled-jacobi@{TOL3:g}", sprob, sctx, TOL3,
                      float64_check(sprob, sctx))
    check(abs(its_s - its_j) <= 2, f"box27-shuffled: {its_s} iterations "
          f"within 2 of the box order's {its_j}")

    # -- each structure: apply, local product and DSS timed beside bounds -----
    L = 4 * E * n
    for label, prob_, ctx_ in (("separable", prob, ctx),
                               ("general", gprob, gctx),
                               ("pair-scatter", sprob, sctx)):
        A_, ex_ = ctx_["A_raw"], ctx_["ex"]
        us = [torch.randn((E, n), generator=g, device=dev) for _ in range(4)]
        args = [(u_,) for u_ in us]
        ms_apply = gpu_ms(A_, args)
        ms_local = gpu_ms(A_.local, args)
        ms_dss = gpu_ms(ex_.dss, args)
        _, l_apply = device_per_call(A_, args)
        _, l_dss = device_per_call(ex_.dss, args)
        slabs = 6 * L if A_.structure == "general" else 0
        b_apply, by_apply = bound(2 * L + slabs, E * flops3(p1))
        b_dss, by_dss = bound(2 * L, 0)
        prof = profile_solve(f"box27-{label}-jacobi", prob_.solve_local,
                             PROFILE3_ITERS)
        out[f"apply_{label}"] = dict(
            ms=ms_apply, local_ms=ms_local, dss_ms=ms_dss,
            launches_per_apply=l_apply, launches_per_dss=l_dss,
            bound_ms=b_apply, bound_by=by_apply, dss_bound_ms=b_dss,
            profile_jacobi=prof)
        log(f"  {label}: apply {ms_apply:.4f} ms device (local product "
            f"{ms_local:.4f}, DSS {ms_dss:.4f}), bound {b_apply:.4f} ms "
            f"({by_apply}; DSS {b_dss:.4f}), {l_apply:.1f} launches per "
            f"apply, {l_dss:.1f} per DSS; Jacobi CG "
            f"{prof['device_ms_per_iter']:.4f} ms device and "
            f"{prof['launches_per_iter']:.1f} launches per iteration")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_3t
    log(f"  phase 3t took {out['seconds']:.1f} s, peak device memory "
        f"{out['peak_gib']:.2f} GiB {at()}")


def phase_3u(dev, at, solves) -> None:
    """The squirmer (Newton + static condensation + secant speed search)
    and advection-diffusion (GMRES) in float64: the golden speed on the
    E = 135 donut (direct solver; warm and timed; device ms of the
    Jacobian, the Schur factors, the dense LU and the Schur apply), one
    Newton solve by GMRES-IR against the direct one, the device Newton
    loop against the host loop, one Newton solve on the E = 540 donut,
    the fixed sphere's drag, the manufactured advection-diffusion problem
    on ``rectangle_mesh(AD_N, AD_N, 8)`` to 1e-10 and ``AD_CYCLES`` restart
    cycles on the 100k mesh (one RHS and K), profiled; none of the
    kernels of the table runs."""
    import contextlib
    import io
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spectralelementmethod_torch.basis import gll_basis_2d
    from spectralelementmethod_torch.core.discretization import (
        Discretization)
    from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
    from spectralelementmethod_torch.models import squirmer as sqm
    from spectralelementmethod_torch.models.advection_diffusion import (
        AdvectionDiffusion)
    from spectralelementmethod_torch.ops import kernels
    from spectralelementmethod_torch.solver import condensation as sc

    t_3u = time.perf_counter()
    out = solves.setdefault("phase_3u", {})
    kernels.reset_launch_counts()
    log(f"[3u] the squirmer and advection-diffusion, float64 {at()}")

    def quiet(fn):
        """(value, printout, seconds) of ``fn``, its printout captured."""
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            val = fn()
        torch.cuda.synchronize()
        return val, buf.getvalue(), time.perf_counter() - t0

    def steps_of(text):
        """Newton steps of each converged solve in a printout (both loops
        print the step count less one)."""
        return [int(m) + 1 for m in
                re.findall(r"converged in (\d+) Newton", text)]

    # -- squirmer-golden ------------------------------------------------------
    order = SQ_GOLDEN["order"]
    mesh = annulus_mesh(**SQ_GOLDEN)
    sq = sqm.Squirmer(mesh, order=order, device=dev)
    E, nx = sq.disc.E, sq.csys.n_ext_dofs
    log(f"  squirmer-golden: p={order}, E={E}, {sq.disc.n_nodes} nodes, "
        f"{2 * sq.disc.n_nodes} DOFs, {nx} condensed DOFs; Re = 1, "
        f"beta = 1, calc_speed([0.99, 1.01]), linear_solver="
        f"{sq.linear_solver!r}")

    def speed_run():
        sq.set_initial_guess()
        return sq.calc_speed([0.99, 1.01], n_rey=1.0, beta=1.0)

    runs = [quiet(speed_run) for _ in range(2)]
    (speed, text, t_warm), (speed2, _, t_timed) = runs
    steps = steps_of(text)
    evals = text.count("finding force at speed")
    err = abs(speed - GOLDEN_SPEED)
    log(f"  squirmer-golden: speed {speed!r}, |U - golden| {err:.3e}; "
        f"{evals} force evaluations ({evals - 2} secant iterations), Newton "
        f"steps {steps}; warm {t_warm:.2f} s, timed {t_timed:.2f} s "
        f"(repeat speed {speed2!r}) {at()}")
    check(err < 3e-6 and len(steps) == evals,
          f"squirmer-golden: speed within 3e-6 of {GOLDEN_SPEED} ({err:.2e})")
    check(abs(speed2 - speed) < 1e-12, "squirmer-golden: the repeat "
          f"calc_speed gives the same speed ({abs(speed2 - speed):.1e})")
    out["golden"] = dict(speed=speed, err=err, force_evals=evals,
                         secant_iterations=evals - 2, newton_steps=steps,
                         warm_s=t_warm, timed_s=t_timed)

    # the pieces of one Newton step at the converged state, device ms by
    # the profiler (float64 Jacobian and direct step; the float32 Schur
    # factors and apply of GMRES-IR's preconditioner)
    soln, n_rey, cint, free_ext = sq._newton_inputs()
    lrhs, lmat = sq._local_systems(soln, n_rey, free_ext)
    ne = sq.csys.n_ext_ldof
    sc_mat, sc_rhs, _, _ = sc.condense_local(lmat, lrhs, ne)
    Ad, bd = sc.assemble_dense(sc_mat, sc_rhs, sq.csys.ext_dof_gidx, nx,
                               cint)
    lmat32, lrhs32 = lmat.float(), lrhs.float()
    facs = sc.schur_factor(lmat32, sq.csys, free_ext)
    pieces = {
        "jacobian": lambda: sq._local_systems(soln, n_rey, free_ext),
        "schur_factor_f32": lambda: sc.schur_factor(lmat32, sq.csys,
                                                    free_ext),
        "dense_lu_f64": lambda: sc.solve_condensed(Ad, bd, free_ext),
        "schur_apply_f32": lambda: sc.schur_apply(facs, lrhs32, sq.csys),
        "direct_step": lambda: sq._step_fn(soln, n_rey, cint, free_ext),
    }
    out["pieces"] = {}
    for name, fn in pieces.items():
        ms, nl = device_per_call(fn, [()] * 2)
        # CUDA events around the same calls too: a profile late in a long
        # run can keep only some of a call's events
        ev_ms = gpu_ms(fn, [()], reps=5)
        out["pieces"][name] = dict(device_ms=ms, launches=nl, event_ms=ev_ms)
        log(f"    {name}: {ms:.3f} ms of device time, {nl:.0f} launches "
            f"per call (profiler); {ev_ms:.3f} ms per call (CUDA events)")
    gflop = 2 / 3 * nx**3 / 1e9
    log(f"    (the dense LU: {gflop:.1f} GFLOP of getrf, "
        f"{8 * nx * nx / 1e6:.0f} MB float64)")

    def newton(model, loop="host"):
        model.set_initial_guess()
        model.compute_operators(1.0)
        model.set_boundary_conditions(speed=speed, beta=1.0)
        _, txt, dt = quiet(lambda: model.solve(newton_loop=loop))
        return steps_of(txt), dt

    st_h, t_h = newton(sq)
    soln_d = sq.soln.copy()
    sq_m = sqm.Squirmer(mesh, order=order, linear_solver="gmres-ir",
                        device=dev)
    st_m, t_m = newton(sq_m)
    d_m = float(np.abs(sq_m.soln - soln_d).max())
    st_v, t_v = newton(sq, "device")
    d_v = float(np.abs(sq.soln - soln_d).max())
    log(f"  squirmer-golden Newton at U = {speed:.8f}: direct {st_h} steps "
        f"{t_h:.3f} s; gmres-ir {st_m} steps {t_m:.3f} s, max |diff| "
        f"{d_m:.2e}; device loop {st_v} steps {t_v:.3f} s, max |diff| "
        f"{d_v:.2e} (bit for bit: {d_v == 0.0}) {at()}")
    check(d_m < 1e-8, f"squirmer-golden: gmres-ir within 1e-8 of the "
          f"direct solve ({d_m:.2e})")
    check(d_v == 0.0 and st_v == st_h, "squirmer-golden: the device "
          f"Newton loop gives the host loop's solution ({d_v:.1e})")
    out["newton"] = dict(direct_steps=st_h, direct_s=t_h, gmres_ir_steps=st_m,
                         gmres_ir_s=t_m, gmres_ir_diff=d_m,
                         device_loop_s=t_v, device_loop_diff=d_v)

    # -- fixed-sphere ---------------------------------------------------------
    fs = sqm.FixedSphere(mesh, order=order, device=dev)
    _, txt, t_fs = quiet(lambda: fs.run(0.01))
    force = fs.calc_force()
    rel = abs(force + 6 * np.pi) / (6 * np.pi)
    log(f"  fixed-sphere: Re = 0.01, force {force:.6f} (-6 pi "
        f"{-6 * np.pi:.6f}, {rel:.2%} off), {steps_of(txt)} steps, "
        f"{t_fs:.2f} s {at()}")
    check(force < 0 and rel < 0.06, "fixed-sphere: the force within 6% of "
          "-6 pi")
    out["fixed_sphere"] = dict(force=force, rel=rel, seconds=t_fs)

    # -- squirmer-540 ---------------------------------------------------------
    t0 = time.perf_counter()
    sq5 = sqm.Squirmer(annulus_mesh(**SQ_540), order=order, device=dev)
    nx5 = sq5.csys.n_ext_dofs
    t_setup5 = time.perf_counter() - t0
    # the solve's own peak: above what the earlier phases left allocated
    base5 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sq5.set_initial_guess()
    sq5.compute_operators(1.0)
    sq5.set_boundary_conditions(speed=GOLDEN_SPEED, beta=1.0)
    _, txt, t5 = quiet(lambda: sq5.solve())
    peak5 = (torch.cuda.max_memory_allocated() - base5) / 2**30
    st5 = steps_of(txt)
    log(f"  squirmer-540: setup {t_setup5:.2f} s, Newton {st5} steps in "
        f"{t5:.2f} s {at()}")
    s5, r5, c5, f5 = sq5._newton_inputs()
    lr5, lm5 = sq5._local_systems(s5, r5, f5)
    m5, b5 = sc.condense_local(lm5, lr5, sq5.csys.n_ext_ldof)[:2]
    A5, bb5 = sc.assemble_dense(m5, b5, sq5.csys.ext_dof_gidx, nx5, c5)
    # CUDA events around two calls after a warm one (a profile of the
    # large LU costs seconds of post-processing)
    sc.solve_condensed(A5, bb5, f5)
    ev5 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev5[0].record()
    for e_ in ev5[1:]:
        sc.solve_condensed(A5, bb5, f5)
        e_.record()
    torch.cuda.synchronize()
    lu5 = statistics.median(a.elapsed_time(b) for a, b in zip(ev5, ev5[1:]))
    f_5 = sq5.calc_force()
    log(f"  squirmer-540: E={sq5.disc.E}, {nx5} condensed DOFs "
        f"({8 * nx5 * nx5 / 2**30:.2f} GiB float64, "
        f"{2 / 3 * nx5**3 / 1e12:.2f} TFLOP of getrf); Newton from the "
        f"potential-flow guess at Re = 1, beta = 1, U = {GOLDEN_SPEED}: "
        f"dense LU {lu5:.1f} ms of device time, "
        f"peak memory of the solve {peak5:.2f} GiB, force {f_5:.3e} {at()}")
    check(len(st5) == 1 and np.isfinite(f_5),
          "squirmer-540: the Newton solve converges")
    out["sq540"] = dict(E=sq5.disc.E, condensed=nx5, steps=st5, seconds=t5,
                        setup_s=t_setup5, lu_ms=lu5, peak_gib=peak5,
                        force=f_5)

    # -- advdiff-rect ---------------------------------------------------------
    def ad_model(n):
        ad = AdvectionDiffusion(
            Discretization(rectangle_mesh(n, n, 8), gll_basis_2d(8)),
            velocity=AD_C, diffusivity=AD_EPS, forcing=ad_f)
        ad.set_dirichlet("ebc", 0.0)
        ad.set_dirichlet("nbc", 0.0)
        return ad

    ad = ad_model(AD_N)
    sol, _, t_ad = quiet(lambda: ad.solve(tol=1e-10, restart=AD_RESTART,
                                          max_restarts=100, device=dev))
    its = int(sol.gmres.iterations)
    err_ad = ad.l2_error(sol.u, ad_u)
    log(f"  advdiff-rect: rectangle_mesh({AD_N}, {AD_N}, 8), GMRES("
        f"{AD_RESTART}) + Jacobi to 1e-10: {its} iterations, converged "
        f"{bool(sol.gmres.converged)}, l2 error {err_ad:.3e}, {t_ad:.2f} s "
        f"({1e3 * t_ad / its:.3f} ms per iteration) {at()}")
    check(bool(sol.gmres.converged) and err_ad < 1e-8,
          "advdiff-rect: converged, l2 error below 1e-8")
    rel = abs(its - AD_CPU_ITERS) / AD_CPU_ITERS
    check(rel <= AD_ITERS_REL, f"advdiff-rect: {its} iterations within "
          f"{AD_ITERS_REL:.0%} of the CPU's {AD_CPU_ITERS} ({rel:.2%})")
    # the same solve cut to 5 restart cycles, twice: the same bits
    short = [ad.solve(tol=1e-10, restart=AD_RESTART, max_restarts=5,
                      device=dev) for _ in range(2)]
    same = (np.array_equal(short[0].u, short[1].u)
            and int(short[0].gmres.iterations)
            == int(short[1].gmres.iterations))
    log(f"  advdiff-rect: {its} iterations, {rel:.2%} from the CPU's "
        f"{AD_CPU_ITERS}; 5 restart cycles twice bit for bit: {same}")
    check(same, "advdiff-rect: a repeated solve gives the same bits")
    out["advdiff_rect"] = dict(n=AD_N, iterations=its, l2_err=err_ad,
                               seconds=t_ad, cpu_iterations=AD_CPU_ITERS,
                               repeat_bit_for_bit=same)

    # -- advdiff-100k ---------------------------------------------------------
    t0 = time.perf_counter()
    big = ad_model(AD_BIG_N)
    kw = dict(tol=1e-10, restart=AD_RESTART, max_restarts=AD_CYCLES,
              device=dev)
    big.solve(**kw)                            # setup and warm-up
    t_setup = time.perf_counter() - t0
    sol, _, t_big = quiet(lambda: big.solve(**kw))
    its = int(sol.gmres.iterations)
    # the profile: one restart cycle (its post-processing grows with the
    # events, ~300 per iteration)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        its_p = int(big.solve(**dict(kw, max_restarts=1)).gmres.iterations)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    n_launch = sum(e.count for e in ev) / its_p
    log(f"  advdiff-100k: rectangle_mesh({AD_BIG_N}, {AD_BIG_N}, 8), E="
        f"{big.disc.E}, {AD_CYCLES} cycles of GMRES({AD_RESTART}): {its} "
        f"iterations in {t_big:.3f} s, {1e3 * t_big / its:.3f} ms per "
        f"iteration; profiled ({its_p} iterations): {1e3 * busy / its_p:.3f} "
        f"ms of device time and {n_launch:.0f} launches per iteration, busy "
        f"{busy / wall:.0%} "
        f"(setup + warm-up {t_setup:.1f} s) {at()}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / its_p:8.4f} ms/iter  "
            f"x{e.count / its_p:6.2f}  {e.key[:70]}")
    check(its == AD_RESTART * AD_CYCLES and np.isfinite(
        float(sol.gmres.residual_norm)), f"advdiff-100k: {AD_CYCLES} full "
        "restart cycles with a finite residual")
    fk = [ad_f, 1.0, lambda x, y: x * y, lambda x, y: np.cos(x + y)]
    solb, _, t_b = quiet(lambda: big.solve_batch(fk, **kw))
    its_b = solb.gmres.iterations.cpu().numpy()
    per_rhs = 1e3 * t_b / float(its_b.max()) / len(fk)
    log(f"  advdiff-100k solve_batch, k = {len(fk)}: iterations "
        f"{its_b.tolist()}, {t_b:.3f} s, {per_rhs:.3f} ms per iteration per "
        f"RHS {at()}")
    check(bool((its_b == AD_RESTART * AD_CYCLES).all()),
          "advdiff-100k: each RHS of the batch ran its cycles")
    out["advdiff_100k"] = dict(E=big.disc.E, iterations=its, seconds=t_big,
                               ms_per_iter=1e3 * t_big / its,
                               device_ms_per_iter=1e3 * busy / its_p,
                               launches_per_iter=n_launch,
                               busy=busy / wall, setup_s=t_setup,
                               batch_k=len(fk), batch_seconds=t_b,
                               batch_ms_per_iter_per_rhs=per_rhs)

    n_k = sum(kernels.launch_counts().values())
    check(n_k == 0, f"phase 3u launched none of the table's kernels ({n_k})")
    out["seconds"] = time.perf_counter() - t_3u
    log(f"  phase 3u took {out['seconds']:.1f} s {at()}")


def main() -> int:
    t_start = time.perf_counter()

    def at() -> str:
        """Seconds since the start, for the phase headers."""
        return f"(at {time.perf_counter() - t_start:.0f} s)"

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
        from spectralelementmethod_torch.basis import gll_basis_2d
        from spectralelementmethod_torch.config import resolve_device
        from spectralelementmethod_torch.core.discretization import (
            Discretization)
        from spectralelementmethod_torch.mesh import (annulus_mesh,
                                                      rectangle_mesh)
        from spectralelementmethod_torch.models.helmholtz import Helmholtz
        from spectralelementmethod_torch.models.poisson import Poisson
        from spectralelementmethod_torch.ops import kernels, sumfac
        from spectralelementmethod_torch.ops.exchange import roll_dss_T
        from spectralelementmethod_torch.parallel import (
            device_mesh, make_sharded_fused_operator, partition,
            sharded_local_poisson_problem)
        from spectralelementmethod_torch.utils import stages
        from spectralelementmethod_torch.solver.cg import _catch_up, cg
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
            if "Function properties" in line and (
                    "Li81E" in line or "far_update" in line
                    or "p1_apply" in line):
                log(f"  {name}: {line.split('for ')[-1][:60]} "
                    f"{lines[i + 1].strip()} | {lines[i + 2].strip()}")

    # -- 2. each kernel against its plain version at full size ---------------
    t0 = time.perf_counter()
    disc = Discretization(rectangle_mesh(NX, NY, ORDER), gll_basis_2d(ORDER))
    prob = Poisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    ctx = prob._local_setup(dev)
    A = ctx["A"]
    Kst, aT, plan, fac = A.Kst, A.aT, A.plan, A.factors
    n, E = disc.n_loc, disc.E
    m_ = int(round(n ** 0.5))
    # the element product's flops: the tensor-product form the affine and
    # the general kernels compute (8 n M + 6 n per element), and the
    # assembled-K form's 6 n^2, logged beside each affine bound
    tflops, aflops = (8 * n * m_ + 6 * n) * E, 6 * n * n * E
    inv32, w32 = prob._fused_cg_operands(ctx["ex"], ctx["free_np"], None, dev)
    inv16, w16 = prob._fused_cg_operands(ctx["ex"], ctx["free_np"],
                                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    log(f"[2] setup of E={E}, n={n} in {time.perf_counter() - t0:.1f} s "
        f"({plan.n_entries} DSS entries in {plan.masks.shape[0]} classes, "
        f"nb={plan.nb}) {at()}")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(k=1, dtype=torch.float32):
        """A random (k n, E) stack."""
        return torch.randn((k * n, E), generator=g, device=dev).to(dtype)

    nE = n * E
    # the CG scalars as float32 device tensors, as the solver passes them:
    # a Python float would cost a blocking host-to-device copy per call
    beta, alpha_prev, alpha = (torch.tensor(v, device=dev)
                               for v in (0.7, 0.4, 0.3))
    mask_bytes = plan.masks.numel()
    small = aT.numel() * 4 + Kst.numel() * 4 + mask_bytes
    rows = []
    # the apply kernels take the blocks' tensor-product factors
    affine_apply = functools.partial(kernels.affine_apply_dss, factors=fac)
    affine_apply_batched = functools.partial(
        kernels.affine_apply_dss_batched, factors=fac)

    def assembled_ms(bytes_moved, flops, k=1):
        """The bound of k products had the assembled-K form's flops been
        the least work (the bounds before the tensor-product kernel), for
        the log."""
        return bound(bytes_moved, flops + k * (aflops - tflops))[0]

    def kernel_a_row(name, fn, plain, k, with_x, pdt, inv, sc,
                     op=None):
        """Kernel A variant ``fn`` on a k-stack against its plain version:
        checks, times and the bound (k stacks of r, p, p', Ap' and, with
        x, x and x'; inv once).  ``op``: (operator arguments, element-local
        product, plan, flops per RHS of the product, operator bytes, the
        factors the kernels take, (the apply of one RHS, of a stack), the
        apply's name) — the affine operator of the rectangle by default.
        p' and x' must equal the plain version's bit for bit (p' within 1
        bf16 ulp) and Ap' the apply of the kernel's own stored p' bit for
        bit."""
        op_args, local, pl, flops_loc, op_bytes, facs, own_apply, what = \
            op or ((Kst, aT), lambda u: kernels._local_product(u, Kst, aT),
                   plan, tflops, small, fac,
                   (affine_apply, affine_apply_batched), "affine apply")
        fn = functools.partial(fn, factors=facs)
        ne = pl.E * n

        def rnd(k_, dtype=torch.float32):
            return torch.randn((k_ * n, pl.E), generator=g,
                               device=dev).to(dtype)

        def args():
            a_ = [rnd(k), rnd(k, pdt), inv]
            a_ += [rnd(k), *sc] if with_x else [sc[0]]
            return (*a_, *op_args, pl)

        sets = [args() for _ in range(2)]
        got, ref = fn(*sets[0]), plain(*sets[0])
        torch.cuda.synchronize()
        gp, gAp, gd = got[0], got[1], got[-1]
        rp, rAp, rd = ref[0], ref[1], ref[-1]
        if with_x:
            err_x, _ = rel_err(got[2], ref[2])
            check(err_x == 0, f"{name} x' bit for bit")
        if pdt == torch.bfloat16:
            check(bf16_ulp_ok(gp, rp), f"{name} p' within 1 bf16 ulp")
            # Ap' and the partials from the kernel's own stored p'
            p3 = gp.float().view(k, n, pl.E)
            S = local(p3)
            rAp, rd = roll_dss_T(S, pl).view(gAp.shape), (p3 * S).sum(1).T
        else:
            err_p, _ = rel_err(gp, rp)
            check(err_p == 0, f"{name} p' bit for bit")
        err, rel = rel_err(gAp, rAp)
        check(rel <= 1e-5, f"{name} Ap' (1e-5 of max)")
        d_rel = rhs_rel(gd, rd, k)
        check(d_rel <= 1e-5, f"{name} <p', Ap'> partials ({d_rel:.2e} <= "
              "1e-5)")
        own = own_apply[0 if k == 1 else 1](gp.float().contiguous(),
                                             *op_args, pl)
        d_own = (gAp - own).abs().max().item()
        check(d_own == 0, f"{name} Ap' equals the {what} of its own stored "
              f"p' bit for bit ({d_own:.1e})")
        log(f"  {name}: max abs err Ap' {err:.3e}, rel {rel:.3e}")
        ms = gpu_ms(fn, sets)
        plain_ms = gpu_ms(plain, sets)
        # per RHS: r in and Ap' out (f32), x in and x' out (f32, with x),
        # p in and p' out (p's dtype); inv once
        s_ = 2 if pdt == torch.bfloat16 else 4
        per_rhs = 8 + (8 if with_x else 0) + 2 * s_
        by_, fl_ = (k * per_rhs * ne + s_ * ne + op_bytes,
                    k * (flops_loc + (12 if with_x else 10) * ne
                         + pl.n_entries * pl.E))
        b_ms, b_by = bound(by_, fl_)
        return dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    assembled_bound_ms=(assembled_ms(by_, fl_, k)
                                        if op is None else None))

    # kernel 1, one RHS and a K-stack
    K2 = Kst.reshape(3 * n, n)
    for name, k, fn, plain in (
            ("affine_apply_dss", 1, affine_apply,
             kernels.affine_apply_dss_plain),
            ("affine_apply_dss_batched", K, affine_apply_batched,
             kernels.affine_apply_dss_batched_plain)):
        sets = [(randn(k), Kst, aT, plan) for _ in range(3 if k == 1 else 2)]
        got = fn(*sets[0])
        ref = plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e}")
        check(rel <= 1e-5, f"{name} matches its plain version (1e-5)")
        ms = gpu_ms(fn, sets)
        plain_ms = gpu_ms(plain, sets)
        lib_ms = gpu_ms(torch.matmul,
                        [(K2, s_[0].view(k, n, E) if k > 1 else s_[0])
                         for s_ in sets])
        by_, fl_ = 8 * k * nE + small, k * (tflops + plan.n_entries * E)
        b_ms, b_by = bound(by_, fl_)
        rows.append(dict(name=name, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms,
                         assembled_bound_ms=assembled_ms(by_, fl_, k)))

    # kernel A: f32 and bf16 directions; one RHS and a K-stack; with the
    # lagged x update and deferred (no x)
    scal = {1: (beta, alpha_prev),
            K: (torch.tensor([0.7, 0.4, 1.1, 0.0], device=dev),
                torch.tensor([0.4, 0.0, 0.9, 0.3], device=dev))}
    for base, k, with_x in (("cg_kernel_a", 1, True),
                            ("cg_kernel_a_deferred", 1, False),
                            ("cg_kernel_a_batched", K, True),
                            ("cg_kernel_a_batched_deferred", K, False)):
        fn, plain = kernels.WRAPPERS[base], getattr(kernels, base + "_plain")
        for tag, pdt, inv in (("f32", torch.float32, inv32),
                              ("bf16", torch.bfloat16, inv16)):
            rows.append(kernel_a_row(f"{base}[{tag}]", fn, plain, k, with_x,
                                     pdt, inv, scal[k]))

    # kernel B, f32 and bf16 operands, one RHS and a K-stack
    for base, k, fn, plain, a_ in (
            ("cg_kernel_b", 1, kernels.cg_kernel_b,
             kernels.cg_kernel_b_plain, alpha),
            ("cg_kernel_b_batched", K, kernels.cg_kernel_b_batched,
             kernels.cg_kernel_b_batched_plain, scal[K][1])):
        for tag, inv, w in (("f32", inv32, w32), ("bf16", inv16, w16)):
            name = f"{base}[{tag}]"
            sets = [(randn(k), randn(k), inv, w, a_) for _ in range(3)]
            gr, grz, grn = fn(*sets[0])
            rr, rrz, rrn = plain(*sets[0])
            torch.cuda.synchronize()
            err, rel = rel_err(gr, rr)
            log(f"  {name}: max abs err r' {err:.3e}, rel {rel:.3e}")
            check(rel <= 1e-6, f"{name} r' (1e-6)")
            for what, a, b in (("<w r', z'>", grz, rrz),
                               ("<w r', r'>", grn, rrn)):
                d = rhs_rel(a, b, k)
                check(d <= 1e-5, f"{name} {what} partials ({d:.2e} <= 1e-5)")
            ms = gpu_ms(fn, sets)
            plain_ms = gpu_ms(plain, sets)
            s_ = 2 if inv.dtype == torch.bfloat16 else 4
            b_ms, b_by = bound(3 * 4 * k * nE + 2 * s_ * nE, 7 * k * nE)
            rows.append(dict(name=name, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None))

    # the single-kernel iteration, f32 and bf16 p, inv and w, with x and
    # deferred; r, Ap and p consistent (the DSS of random data), as the CG
    # loop's are.  r', p' and x' must equal the plain version's bit for
    # bit; Ap' (the tensor-product form against the plain version's
    # torch.matmul of Kst) to 1e-5 of max and the partials (summed in
    # another order) to 1e-6; Ap' the affine apply of the kernel's own
    # stored p' bit for bit
    def consistent(dtype=torch.float32):
        return roll_dss_T(randn(), plan).to(dtype)

    for base, with_x in (("cg_kernel_single", True),
                         ("cg_kernel_single_deferred", False)):
        fn = functools.partial(kernels.WRAPPERS[base], factors=fac)
        plain = getattr(kernels, base + "_plain")
        for tag, pdt, inv, w in (("f32", torch.float32, inv32, w32),
                                 ("bf16", torch.bfloat16, inv16, w16)):
            name = f"{base}[{tag}]"
            sets = [(consistent(), consistent(), consistent(pdt),
                     *((randn(),) if with_x else ()), inv, w, alpha_prev,
                     beta, Kst, aT, plan) for _ in range(2)]
            got, ref = fn(*sets[0]), plain(*sets[0])
            torch.cuda.synchronize()
            errs = {what: (a.float() - b.float()).abs().max().item()
                    for what, a, b in zip(("r'", "p'", "Ap'", "x'"),
                                          got[:-1], ref[:-1])}
            ap_err, ap_rel = rel_err(got[2], ref[2])
            errs.pop("Ap'")
            d_rel = rhs_rel(got[-1], ref[-1], len(kernels.SINGLE_PARTS))
            own = affine_apply(got[1].float().contiguous(), Kst, aT, plan)
            d_own = (got[2] - own).abs().max().item()
            log(f"  {name}: max abs err {errs}, Ap' {ap_err:.3e} (rel "
                f"{ap_rel:.3e}), partials {d_rel:.2e}")
            check(max(errs.values()) == 0,
                  f"{name} {', '.join(errs)} bit for bit")
            check(ap_rel <= 1e-5, f"{name} Ap' (1e-5 of max)")
            check(d_rel <= 1e-6, f"{name} partials ({d_rel:.2e} <= 1e-6)")
            check(d_own == 0, f"{name} Ap' equals the affine apply of its "
                  f"own stored p' bit for bit ({d_own:.1e})")
            ms = gpu_ms(fn, sets)
            plain_ms = gpu_ms(plain, sets)
            s_ = 2 if pdt == torch.bfloat16 else 4
            # r and Ap in, r' and Ap' out (f32); x in and x' out (f32, with
            # x); p, inv and w in and p' out (p's type)
            by_ = (16 + (8 if with_x else 0) + 4 * s_) * nE + small
            fl_ = tflops + (22 if with_x else 20) * nE + plan.n_entries * E
            b_ms, b_by = bound(by_, fl_)
            rows.append(dict(name=name, max_abs_err=ap_err,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None,
                             assembled_bound_ms=assembled_ms(by_, fl_)))

    # the curved path at its full shapes: the polar half-annulus, same E
    t0 = time.perf_counter()
    adisc = Discretization(annulus_mesh(ORDER, **ANNULUS), gll_basis_2d(ORDER))
    # forcing 1, u = 1 on the sphere and 0 on the shell, natural on the
    # axis.  With u = 0 on both circles the residual b - A u_d is the
    # forcing alone, far smaller than A's action on the solution, and an
    # f32 solution's true residual cannot follow the recurrence's: at
    # 158 x 40 both packages stop at 1.7e-3 by the recurrence with a true
    # 3.8e-2, and at this size the true residual is ~1.7 (PERF.md)
    aprob = Poisson(adisc, dtype=np.float32)
    aprob.set_dirichlet("sphere", 1.0)
    aprob.set_dirichlet("shell", 0.0)
    actx = aprob._local_setup(dev)
    gA = actx["A"]
    check(gA.structure == "general" and adisc.E == E,
          f"the annulus (E={adisc.E}) takes the general apply")
    gop = (gA.gT, gA.Dh, gA.hier)
    gplan, gfac = gA.plan, gA.factors
    # the curved kernels take the derivative's tensor-product tables
    gen_apply = functools.partial(kernels.general_apply_dss, factors=gfac)
    gen_apply_batched = functools.partial(kernels.general_apply_dss_batched,
                                          factors=gfac)
    ginv32, _ = aprob._fused_cg_operands(actx["ex"], actx["free_np"], None,
                                         dev)
    ginv16, _ = aprob._fused_cg_operands(actx["ex"], actx["free_np"],
                                         torch.bfloat16, dev)
    torch.cuda.synchronize()
    gbytes = gA.gT.numel() * 4 + gplan.masks.numel() + gA.Dh.numel() * 4
    log(f"  annulus setup (E={adisc.E}) in {time.perf_counter() - t0:.1f} s "
        f"({gplan.n_entries} DSS entries in {gplan.masks.shape[0]} classes, "
        f"nb={gplan.nb}) {at()}")
    DhT = gA.Dh.T.contiguous()

    def two_matmuls(u, flux):
        """The local product's two derivative products as torch.matmul
        calls (the library yardstick of the general apply)."""
        return torch.matmul(gA.Dh, u), torch.matmul(DhT, flux)

    for name, k, fn, plain in (
            ("general_apply_dss", 1, gen_apply,
             kernels.general_apply_dss_plain),
            ("general_apply_dss_batched", K, gen_apply_batched,
             kernels.general_apply_dss_batched_plain)):
        sets = [(randn(k), *gop, gplan) for _ in range(3 if k == 1 else 2)]
        got = fn(*sets[0])
        ref = plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e}")
        check(rel <= 1e-5, f"{name} matches its plain version (1e-5)")
        ms = gpu_ms(fn, sets)
        plain_ms = gpu_ms(plain, sets)
        lib_ms = gpu_ms(two_matmuls, [
            (s_[0].view(k, n, E) if k > 1 else s_[0],
             torch.randn((k, 2 * n, E) if k > 1 else (2 * n, E),
                         generator=g, device=dev)) for s_ in sets])
        b_ms, b_by = bound(8 * k * nE + gbytes,
                           k * (tflops + gplan.n_entries * E))
        rows.append(dict(name=name, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
    gen_op = (gop, lambda u: kernels._general_local(u, *gop[:2]), gplan,
              tflops, gbytes, gfac, (gen_apply, gen_apply_batched),
              "general apply")
    for base, k in (("cg_kernel_a_general", 1),
                    ("cg_kernel_a_general_batched", K)):
        fn, plain = kernels.WRAPPERS[base], getattr(kernels, base + "_plain")
        for tag_, pdt, inv in (("f32", torch.float32, ginv32),
                               ("bf16", torch.bfloat16, ginv16)):
            rows.append(kernel_a_row(f"{base}[{tag_}]", fn, plain, k, True,
                                     pdt, inv, scal[k], gen_op))

    # the element-local Laplacian of the (E, n) layout on the annulus
    # factors of the Helmholtz problem (c folded in): one array, K packed
    # components (E, K n) and a stack of K (K, E, n)
    t0 = time.perf_counter()
    hprob = Helmholtz(adisc, forcing=1.0, coefficient=helm_c,
                      reaction=helm_k, dtype=np.float32)
    hprob.set_dirichlet("sphere", 1.0)
    hprob.set_dirichlet("shell", 0.0)
    hctx = hprob._local_ops("auto", "en", "pallas", "jacobi", dev)
    hlap = hctx["A"].lap
    lop = (hlap.g, hlap.Dh, hlap.hier)
    torch.cuda.synchronize()
    log(f"  Helmholtz setup (E={adisc.E}, layout en) in "
        f"{time.perf_counter() - t0:.1f} s {at()}")
    DhT_l = hlap.Dh.T.contiguous()

    def en_matmuls(u, flux):
        """The element-local product's two derivative products as
        torch.matmul calls in the (E, n) layout (the library yardstick)."""
        return torch.matmul(u, DhT_l), torch.matmul(flux, hlap.Dh)

    lbytes = hlap.g.numel() * 4 + hlap.Dh.numel() * 4
    for name, k, shape in (("laplacian_local", 1, (E, n)),
                           ("vector_laplacian_local", K, (E, K * n)),
                           ("laplacian_local_batched", K, (K, E, n))):
        fn, plain = kernels.WRAPPERS[name], getattr(kernels, name + "_plain")
        sets = [(torch.randn(shape, generator=g, device=dev), *lop)
                for _ in range(3 if k == 1 else 2)]
        got = fn(*sets[0])
        ref = plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e}")
        check(rel <= 1e-6, f"{name} matches its plain version (1e-6 of max)")
        ms = gpu_ms(fn, sets)
        plain_ms = gpu_ms(plain, sets)
        lib_ms = gpu_ms(en_matmuls, [
            (s_[0].view(-1, E, n) if k > 1 else s_[0],
             torch.randn((k, E, 2 * n) if k > 1 else (E, 2 * n),
                         generator=g, device=dev)) for s_ in sets])
        b_ms, b_by = bound(8 * k * nE + lbytes, k * tflops)
        rows.append(dict(name=name, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
    log("  the element-local kernel's dynamic shared memory (bytes) and "
        f"blocks per SM at n={n}, 16-byte / 4-byte staging: one array "
        f"{kernels.local_occupancy(n, True, 1)} / "
        f"{kernels.local_occupancy(n, False, 1)}, K components (a second u "
        f"buffer) {kernels.local_occupancy(n, True, K)} / "
        f"{kernels.local_occupancy(n, False, K)}")

    # -- the element-sharded operator: S_SH shards of the rectangle, each
    # an (n, Eb + 2H) halo-extended block through the block kernel
    t0 = time.perf_counter()
    smesh = device_mesh(S_SH)
    Gf_r = prob._G_host.reshape(E, 3, -1)
    Dhat_r = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W_r = disc.basis.weight_grid().reshape(-1)
    a_r, exact_r = sumfac.affine_factorization(Gf_r, W_r)
    check(exact_r, "the rectangle is affine")
    Kcat_r = sumfac.make_affine_element_matrices(Dhat_r, W_r,
                                                 order=ctx["ex"].hier)
    A_sh = make_sharded_fused_operator(ctx["ex"], Kcat_r, a_r, smesh)
    Kst_b, a_stack, m_stack, fac_b = A_sh._block_operands
    block_apply = functools.partial(kernels.affine_block_apply_dss,
                                    factors=fac_b)
    bplan, H_sh = A_sh._block_plan, A_sh._halo
    Eb, Eext = E // S_SH, bplan.E
    torch.cuda.synchronize()
    log(f"  sharded operator: {S_SH} shards of Eb={Eb}, halo H={H_sh}, "
        f"E_ext={Eext} ({time.perf_counter() - t0:.1f} s) {at()}")
    u_sh = randn()
    blocks_sh = u_sh.split(Eb, dim=1)
    errs_b = []
    for s in range(S_SH):
        args_b = (A_sh._extended(blocks_sh, s), Kst_b, a_stack[s],
                  m_stack[s], bplan)
        got = block_apply(*args_b)
        ref = kernels.affine_block_apply_dss_plain(*args_b)
        torch.cuda.synchronize()
        errs_b.append(rel_err(got, ref))
    err_b = max(e for e, _ in errs_b)
    rel_b = max(r for _, r in errs_b)
    log(f"  affine_block_apply_dss, {S_SH} shards: max abs err {err_b:.3e}, "
        f"rel {rel_b:.3e}")
    check(rel_b <= 1e-5, "affine_block_apply_dss matches its plain version "
          "on every shard (1e-5 of max)")
    v_sh, v_gl = A_sh(u_sh), affine_apply(u_sh, Kst, aT, plan)
    torch.cuda.synchronize()
    d_sh, rel_sh = rel_err(v_sh, v_gl)
    log(f"  the sharded apply's centres against the global affine_apply_dss: "
        f"max abs diff {d_sh:.3e} (rel {rel_sh:.3e}; "
        f"{'bit for bit' if d_sh == 0 else 'not bit for bit'})")
    check(rel_sh <= 1e-6, "the assembled centres equal the global apply "
          "(1e-6 of max)")
    sets_b = [(A_sh._extended(randn().split(Eb, dim=1), 0), Kst_b,
               a_stack[0], m_stack[0], bplan) for _ in range(3)]
    ms_b = gpu_ms(block_apply, sets_b)
    plain_b = gpu_ms(kernels.affine_block_apply_dss_plain, sets_b)
    lib_b = gpu_ms(torch.matmul, [(K2, s_[0]) for s_ in sets_b])
    by_b = (8 * n * Eext + 12 * Eext + m_stack.shape[1] * Eext
            + Kst.numel() * 4)
    bb_ms, bb_by = bound(by_b, (tflops // E + bplan.n_entries) * Eext)
    rows.append(dict(name="affine_block_apply_dss", max_abs_err=err_b,
                     ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms, bound_by=bb_by,
                     library_ms=lib_b, assembled_bound_ms=bound(
                         by_b, (aflops // E + bplan.n_entries) * Eext)[0]))
    sets_sh = [(randn(),) for _ in range(3)]
    sharded_ms = gpu_ms(A_sh, sets_sh)

    def sharded_plain(u):
        bl = u.split(Eb, dim=1)
        return torch.cat([kernels.affine_block_apply_dss_plain(
            A_sh._extended(bl, s), Kst_b, a_stack[s], m_stack[s],
            bplan)[:, H_sh:H_sh + Eb] for s in range(S_SH)], dim=1)

    sharded_plain_ms = gpu_ms(sharded_plain, sets_sh)
    glob = next(r_ for r_ in rows if r_["name"] == "affine_apply_dss")
    log(f"  one whole sharded apply (strips + {S_SH} block launches + "
        f"centres): {sharded_ms:.4f} ms (plain {sharded_plain_ms:.4f}); the "
        f"global apply {glob['ms']:.4f} ms, bound {glob['bound_ms']:.4f}, "
        f"torch.matmul of the local product {glob['library_ms']:.4f}; one "
        f"block launch {ms_b:.4f} ms (bound {bb_ms:.4f})")

    # -- the far split: max_halo=FAR_HALO sends the vertical classes
    # (|delta| ~ NX) far; the far update against its plain version, the
    # split apply against the unsplit one, on the rectangle and on the
    # annulus (general apply)
    A_split = sumfac.make_local_laplacian_operator(
        ctx["ex"], Gf_r, Dhat_r, None, device=dev, max_halo=FAR_HALO)
    near_r, far_r = A_split._split
    rows_dst = sorted({b_[0] + t for b_ in far_r.edge_blocks
                       for t in range(b_[2])}
                      | {v_[0] for v_ in far_r.vert_rows})
    rows_src = sorted({b_[1] + t for b_ in far_r.edge_blocks
                       for t in range(b_[2])}
                      | {v_[1] for v_ in far_r.vert_rows})
    n_masks = len({b_[5] for b_ in far_r.edge_blocks}
                  | {v_[3] for v_ in far_r.vert_rows})
    log(f"  far split at max_halo={FAR_HALO}: {far_r.n_entries} far entries "
        f"into {len(rows_dst)} rows from {len(rows_src)} rows, "
        f"{near_r.n_entries} near entries")
    far_sets = []
    for _ in range(3):
        out0, aux0 = affine_apply(randn(), Kst, aT, near_r, aux=True)
        far_sets.append((out0, aux0.clone(), far_r))
    got = kernels.far_update(far_sets[0][0].clone(), *far_sets[0][1:])
    ref = kernels.far_update_plain(far_sets[0][0].clone(), *far_sets[0][1:])
    torch.cuda.synchronize()
    err_f, rel_f = rel_err(got, ref)
    log(f"  far_update: max abs err {err_f:.3e}, rel {rel_f:.3e}")
    check(err_f == 0, "far_update matches its plain version bit for bit")
    for label, op, whole in (
            ("rectangle, affine", A_split, A.masked(None)),
            ("annulus, general", sumfac.make_local_laplacian_operator(
                actx["ex"], aprob._G_host.reshape(adisc.E, 3, -1),
                sumfac.make_stacked_derivative(aprob._D0_host,
                                               aprob._D1_host),
                None, device=dev, max_halo=FAR_HALO), gA.masked(None))):
        check(op.far_plan is not None, f"{label}: max_halo={FAR_HALO} "
              "splits the classes")
        u_f = randn() if label.startswith("rect") else torch.randn(
            (n, adisc.E), generator=g, device=dev)
        d_f, rel_fs = rel_err(op(u_f), whole(u_f))
        log(f"  split apply ({label}) against the unsplit: max abs diff "
            f"{d_f:.3e}, rel {rel_fs:.3e}")
        check(rel_fs <= 1e-6, f"split apply ({label}) equals the unsplit "
              "(1e-6 of max)")
    # the far update on the general apply's raw rows (the annulus's op)
    near_a, far_a = op._split
    o_a, x_a = kernels.general_apply_dss(u_f, op.gT, op.Dh, op.hier, near_a,
                                         aux=True, factors=op.factors)
    d_a = (kernels.far_update(o_a.clone(), x_a, far_a)
           - kernels.far_update_plain(o_a.clone(), x_a, far_a)).abs().max()
    check(d_a.item() == 0, f"far_update on the annulus's general apply "
          f"({far_a.n_entries} far entries) matches its plain version bit "
          "for bit")
    ms_f = gpu_ms(kernels.far_update, far_sets)
    plain_f = gpu_ms(kernels.far_update_plain, far_sets)
    # each destination row read and written, each source row and each far
    # class mask read once; one add per entry
    bf_ms, bf_by = bound(E * (8 * len(rows_dst) + 4 * len(rows_src)
                              + n_masks), far_r.n_entries * E)
    rows.append(dict(name="far_update", max_abs_err=err_f, ms=ms_f,
                     plain_ms=plain_f, bound_ms=bf_ms, bound_by=bf_by,
                     library_ms=None))
    split_ms = gpu_ms(A_split, [(randn(),) for _ in range(3)])
    log(f"  the split apply (near gather + far_update): {split_ms:.4f} ms, "
        f"the unsplit {glob['ms']:.4f} ms")

    # the p = 1 apply kernels (n = 4) at the shapes the main path's
    # p-multigrid coarse level gives them: the rectangle and the annulus at
    # p = 1, same E (the coarse operators' factors differ, their shapes do
    # not); one RHS and a K-stack, against their plain versions at the bar
    # of the p = 8 rows
    t0 = time.perf_counter()
    p1 = {}
    for pk, mesh_ in (("rect", rectangle_mesh(NX, NY, 1)),
                      ("annulus", annulus_mesh(1, **ANNULUS))):
        p1[pk] = Poisson(Discretization(mesh_, gll_basis_2d(1)),
                         dtype=np.float32)._local_setup(dev)["A"]
    check(p1["rect"].structure == "affine"
          and p1["annulus"].structure == "general"
          and all(A1._backend == "fused" and A1.n_loc == 4 and A1.E == E
                  for A1 in p1.values()),
          f"the p = 1 operators (n = 4, E = {E}) take the apply kernels "
          f"({time.perf_counter() - t0:.1f} s)")
    for pk, name, k in (("rect", "affine_apply_dss", 1),
                        ("rect", "affine_apply_dss_batched", K),
                        ("annulus", "general_apply_dss", 1),
                        ("annulus", "general_apply_dss_batched", K)):
        A1 = p1[pk]
        n1, pl1 = A1.n_loc, A1.plan
        ops1 = ((A1.Kst, A1.aT) if pk == "rect"
                else (A1.gT, A1.Dh, A1.hier))
        fn = functools.partial(kernels.WRAPPERS[name], factors=A1.factors)
        plain = getattr(kernels, name + "_plain")
        # (k n, E) f32 is 1.6 MB per RHS: enough sets to rotate past the L2
        sets = [(torch.randn((k * n1, E), generator=g, device=dev), *ops1,
                 pl1) for _ in range(24 // k)]
        got, ref = fn(*sets[0]), plain(*sets[0])
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        check(rel <= 1e-5, f"{name} at p = 1 (n = 4) matches its plain "
              f"version (1e-5; rel {rel:.1e})")
        ms = gpu_ms(fn, sets)
        plain_ms = gpu_ms(plain, sets)
        if pk == "rect":
            K1 = A1.Kst.reshape(3 * n1, n1)
            lib_ms = gpu_ms(torch.matmul, [
                (K1, s_[0].view(k, n1, E) if k > 1 else s_[0])
                for s_ in sets])
            op_bytes = A1.aT.numel() * 4 + A1.Kst.numel() * 4
        else:
            Dh1, Dh1T = A1.Dh, A1.Dh.T.contiguous()
            lib_ms = gpu_ms(lambda u, fl: (torch.matmul(Dh1, u),
                                           torch.matmul(Dh1T, fl)), [
                (s_[0].view(k, n1, E) if k > 1 else s_[0],
                 torch.randn((k, 2 * n1, E) if k > 1 else (2 * n1, E),
                             generator=g, device=dev)) for s_ in sets])
            op_bytes = A1.gT.numel() * 4 + A1.Dh.numel() * 4
        m1 = int(round(n1 ** 0.5))
        # the masks as the kernel reads them: one packed 32-bit word per
        # element
        mask1 = kernels.p1_mask_words(pl1).numel() * 4
        b_ms, b_by = bound(8 * k * n1 * E + op_bytes + mask1,
                           k * ((8 * n1 * m1 + 6 * n1) * E
                                + pl1.n_entries * E))
        rows.append(dict(name=f"{name}[p1]", max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms))
        # one device kernel per apply at n = 4 (product and DSS together),
        # counted by the profiler over a few applies
        kern = device_kernels(fn, sets[:4])
        check(sum(kern.values()) == 4
              and all("p1_apply_dss_kernel" in kk for kk in kern),
              f"{name} at p = 1 (k = {k}): 4 applies issue 4 device kernels "
              f"({kern})")

    for r in rows:
        asm = r.pop("assembled_bound_ms", None)
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"bound {r['bound_ms']:.4f} by {r['bound_by']}"
            + ("" if asm is None else
               f"; {asm:.4f} with the assembled-K flops") + ", library "
            f"{r['library_ms']})")

    # the deferred-x catch-up x += sum_j alpha_j P_j (plain PyTorch, once
    # per DEFER iterations), per super-iteration
    catch_up = {}
    for k in (1, K):
        for tag, pdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            al = [scal[K][0] if k > 1 else beta for _ in range(DEFER)]
            sets = [(randn(k), al, [randn(k, pdt) for _ in range(DEFER)])
                    for _ in range(2)]
            catch_up[f"k{k}-{tag}"] = gpu_ms(_catch_up, sets, reps=10)
    log(f"  deferred-x catch-up, ms per super-iteration of {DEFER}: "
        f"{catch_up} {at()}")

    # the other compiled orders (n = 9 .. 64) on a small mesh whose E is
    # no multiple of the block size: every kernel against its plain
    # version, one RHS and a stack of three
    for p in range(2, ORDER):
        sdisc = Discretization(rectangle_mesh(24, 20, p), gll_basis_2d(p))
        sprob = Poisson(sdisc, dtype=np.float32)
        sA = sprob._local_setup(dev)["A"]
        sK, saT, splan, sfac = sA.Kst, sA.aT, sA.plan, sA.factors
        # and the curved path on a small polar annulus (E = 475)
        cdisc = Discretization(annulus_mesh(p, **SMALL_ANNULUS),
                               gll_basis_2d(p))
        cA = Poisson(cdisc, dtype=np.float32)._local_setup(dev)["A"]
        cop, cfac = (cA.gT, cA.Dh, cA.hier, cA.plan), cA.factors
        # the (E, n) element-local kernel on the same factors (E = 475:
        # 4-byte staging) and on their first 472 elements (16-byte staging
        # for odd n), one array and a stack
        lop_s = (cA.gT.transpose(1, 2).contiguous(), cA.Dh, cA.hier)
        ne_ = (cdisc.E, sdisc.n_loc)
        g472 = lop_s[0][:, :472].contiguous()
        for shape in ((472, sdisc.n_loc), (3, 472, sdisc.n_loc)):
            u_l = torch.randn(shape, generator=g, device=dev)
            fn_l = (kernels.laplacian_local if len(shape) == 2
                    else kernels.laplacian_local_batched)
            rel_l = rel_err(fn_l(u_l, g472, *lop_s[1:]),
                            kernels.laplacian_local_plain(u_l, g472,
                                                          *lop_s[1:]))[1]
            check(rel_l <= 1e-6, f"p={p}: {fn_l.__name__} at E=472 matches "
                  f"its plain version ({rel_l:.1e} <= 1e-6 of max)")
        nl = (sdisc.n_loc, sdisc.E)
        # the single kernel: r', p', x' (pointwise) against the plain
        # version; its Ap' and kernel A's against the hand-written apply of
        # their own stored p', bit for bit
        rels, single_err, own_err = [], 0.0, 0.0
        for k, b_, sc in ((1, "", (beta, alpha_prev)),
                          (3, "_batched", (scal[K][0][:3], scal[K][1][:3]))):
            shp = (k * sdisc.n_loc, sdisc.E)
            cshp = (k * sdisc.n_loc, cdisc.E)

            def rnd(shape=shp, dtype=torch.float32):
                return torch.randn(shape, generator=g, device=dev).to(dtype)

            u, cu = rnd(), rnd(cshp)
            # (kernel, arguments, the kernel's keywords)
            cases = [("affine_apply_dss" + b_, (u, sK, saT, splan),
                      dict(factors=sfac)),
                     ("general_apply_dss" + b_, (cu, *cop),
                      dict(factors=cfac)),
                     ("laplacian_local" + b_,
                      (rnd((k, *ne_) if k > 1 else ne_), *lop_s), {})]
            if k > 1:
                cases.append(("vector_laplacian_local",
                              (rnd((ne_[0], k * ne_[1])), *lop_s), {}))
            for pdt in (torch.float32, torch.bfloat16):
                inv = torch.rand(nl, generator=g, device=dev).to(pdt)
                w_ = torch.rand(nl, generator=g, device=dev).to(pdt)
                cinv = torch.rand((sdisc.n_loc, cdisc.E), generator=g,
                                  device=dev).to(pdt)
                p_, x_ = rnd(dtype=pdt), rnd()
                cases += [
                    ("cg_kernel_a" + b_,
                     (u, p_, inv, x_, *sc, sK, saT, splan),
                     dict(factors=sfac)),
                    (f"cg_kernel_a{b_}_deferred",
                     (u, p_, inv, sc[0], sK, saT, splan),
                     dict(factors=sfac)),
                    ("cg_kernel_b" + b_, (u, x_, inv, w_, sc[1]), {}),
                    ("cg_kernel_a_general" + b_,
                     (cu, rnd(cshp, pdt), cinv, rnd(cshp), *sc, *cop),
                     dict(factors=cfac))]
                if k == 1:
                    single = (u, x_, p_, rnd(), inv, w_, *sc[::-1], sK, saT,
                              splan)
                    for name, args in (("cg_kernel_single", single),
                                       ("cg_kernel_single_deferred",
                                        single[:3] + single[4:])):
                        got = kernels.WRAPPERS[name](*args, factors=sfac)
                        ref = getattr(kernels, name + "_plain")(*args)
                        single_err = max(single_err, *(
                            (a.float() - b.float()).abs().max().item()
                            for i, (a, b) in enumerate(zip(got[:-1],
                                                           ref[:-1]))
                            if i != 2))
                        ap_k = kernels.affine_apply_dss(
                            got[1].float().contiguous(), sK, saT, splan,
                            factors=sfac)
                        own_err = max(own_err,
                                      (got[2] - ap_k).abs().max().item())
                        rels += [rel_err(got[2], ref[2])[1], rhs_rel(
                            got[-1], ref[-1], len(kernels.SINGLE_PARTS))]
            for name, args, kw in cases:
                got = kernels.WRAPPERS[name](*args, **kw)
                ref = getattr(kernels, name + "_plain")(*args)
                if isinstance(got, torch.Tensor):
                    got, ref = (got,), (ref,)
                elif name.startswith("cg_kernel_a"):
                    # Ap' against the apply of the kernel's own stored p'
                    own = (kernels.WRAPPERS["general_apply_dss" + b_](
                        got[0].float().contiguous(), *cop, factors=cfac)
                        if "general" in name else
                        kernels.WRAPPERS["affine_apply_dss" + b_](
                            got[0].float().contiguous(), sK, saT, splan,
                            factors=sfac))
                    own_err = max(own_err, (got[1] - own).abs().max().item())
                # outputs of the stack's shape elementwise; partials as
                # per-RHS totals
                rels += [rel_err(a, b)[1] if a.shape == b.shape
                         else rhs_rel(a, b, k) for a, b in zip(got, ref)]
        # the block kernel on the 2 shards of the small rectangle (and the
        # assembled centres against the global apply), and the far update
        # with max_halo=1 (every vertical class far)
        sex = sprob._local_setup(dev)["ex"]
        sGf = sprob._G_host.reshape(sdisc.E, 3, -1)
        sD = sumfac.make_stacked_derivative(sprob._D0_host, sprob._D1_host)
        sW = sdisc.basis.weight_grid().reshape(-1)
        s_a, _ = sumfac.affine_factorization(sGf, sW)
        sAsh = make_sharded_fused_operator(
            sex, sumfac.make_affine_element_matrices(sD, sW, order=sex.hier),
            s_a, device_mesh(2))
        sKb, sab, smb, sfb = sAsh._block_operands
        su = torch.randn(nl, generator=g, device=dev)
        sbl = su.split(sdisc.E // 2, dim=1)
        for s in range(2):
            args = (sAsh._extended(sbl, s), sKb, sab[s], smb[s],
                    sAsh._block_plan)
            rels.append(rel_err(kernels.affine_block_apply_dss(
                *args, factors=sfb), kernels.affine_block_apply_dss_plain(
                    *args))[1])
        rels.append(rel_err(sAsh(su), kernels.affine_apply_dss(
            su, sK, saT, splan, factors=sfac))[1])
        snear, sfar = splan.split(1)
        o_, x_ = kernels.affine_apply_dss(su, sK, saT, snear, aux=True,
                                          factors=sfac)
        d_far = rel_err(kernels.far_update(o_.clone(), x_, sfar),
                        kernels.far_update_plain(o_.clone(), x_, sfar))[0]
        # and on the small annulus's general apply (E = 475: 4-byte rows)
        cnear, cfar = cop[3].split(1)
        o_c, x_c = kernels.general_apply_dss(
            torch.randn(nl[:1] + (cdisc.E,), generator=g, device=dev),
            *cop[:3], cnear, aux=True, factors=cfac)
        d_far = max(d_far, rel_err(
            kernels.far_update(o_c.clone(), x_c, cfar),
            kernels.far_update_plain(o_c.clone(), x_c, cfar))[0])
        check(d_far == 0, f"p={p}: the far update at max_halo=1 matches "
              f"its plain version bit for bit ({sfar.n_entries} and "
              f"{cfar.n_entries} far entries, rectangle and annulus)")
        check(max(rels) <= 1e-5, f"p={p} (n={sdisc.n_loc}, E={sdisc.E}): "
              f"every kernel, one RHS and three, and the block kernel on 2 "
              f"shards match their plain versions "
              f"({max(rels):.1e} <= 1e-5)")
        check(single_err == 0 and own_err == 0,
              f"p={p}: the single kernel's r', p', x' bit for bit against "
              f"its plain version ({single_err}); its Ap' and every kernel "
              f"A's (affine and general) equal the apply of their own "
              f"stored p' bit for bit ({own_err})")

    # p = 1 (n = 4, the p-multigrid coarse level): the apply kernels, the
    # only ones with a p = 1 instantiation (kernels.APPLY_N), against their
    # plain versions at the bar above, one RHS and three, on the small
    # rectangle and annulus, and the block apply (the same product) on 2
    # shards with its centres against the global apply
    sdisc = Discretization(rectangle_mesh(24, 20, 1), gll_basis_2d(1))
    sprob = Poisson(sdisc, dtype=np.float32)
    sA = sprob._local_setup(dev)["A"]
    cA = Poisson(Discretization(annulus_mesh(1, **SMALL_ANNULUS),
                                gll_basis_2d(1)),
                 dtype=np.float32)._local_setup(dev)["A"]
    rels = []
    for k, b_ in ((1, ""), (3, "_batched")):
        for name, A_, ops_ in (("affine_apply_dss", sA, (sA.Kst, sA.aT)),
                               ("general_apply_dss", cA,
                                (cA.gT, cA.Dh, cA.hier))):
            args = (torch.randn((k * 4, A_.E), generator=g, device=dev),
                    *ops_, A_.plan)
            rels.append(rel_err(
                kernels.WRAPPERS[name + b_](*args, factors=A_.factors),
                getattr(kernels, name + b_ + "_plain")(*args))[1])
    sex = sprob._local_setup(dev)["ex"]
    sGf = sprob._G_host.reshape(sdisc.E, 3, -1)
    sD = sumfac.make_stacked_derivative(sprob._D0_host, sprob._D1_host)
    sW = sdisc.basis.weight_grid().reshape(-1)
    s_a, _ = sumfac.affine_factorization(sGf, sW)
    sAsh = make_sharded_fused_operator(
        sex, sumfac.make_affine_element_matrices(sD, sW, order=sex.hier),
        s_a, device_mesh(2))
    sKb, sab, smb, sfb = sAsh._block_operands
    su = torch.randn((4, sdisc.E), generator=g, device=dev)
    sbl = su.split(sdisc.E // 2, dim=1)
    for s in range(2):
        args = (sAsh._extended(sbl, s), sKb, sab[s], smb[s], sAsh._block_plan)
        rels.append(rel_err(kernels.affine_block_apply_dss(
            *args, factors=sfb), kernels.affine_block_apply_dss_plain(
                *args))[1])
    rels.append(rel_err(sAsh(su), kernels.affine_apply_dss(
        su, sA.Kst, sA.aT, sA.plan, factors=sA.factors))[1])
    # aux=True at n = 4: the same launch writes the raw rows
    for name, A_, ops_ in (("affine_apply_dss", sA, (sA.Kst, sA.aT)),
                           ("general_apply_dss", cA,
                            (cA.gT, cA.Dh, cA.hier))):
        args = (torch.randn((4, A_.E), generator=g, device=dev), *ops_,
                A_.plan)
        got = kernels.WRAPPERS[name](*args, aux=True, factors=A_.factors)
        ref = getattr(kernels, name + "_plain")(*args, aux=True)
        rels += [rel_err(got[0], ref[0])[1], rel_err(got[1], ref[1])[1]]
    bargs = (sAsh._extended(sbl, 0), sKb, sab[0], smb[0], sAsh._block_plan)
    kern = device_kernels(functools.partial(kernels.affine_block_apply_dss,
                                            factors=sfb), [bargs] * 4)
    check(sum(kern.values()) == 4
          and all("p1_apply_dss_kernel" in kk for kk in kern),
          f"affine_block_apply_dss at p = 1: 4 applies issue 4 device "
          f"kernels ({kern})")
    check(max(rels) <= 1e-5, f"p=1 (n=4; nb={sA.plan.nb}, "
          f"{sA.plan.n_entries} DSS entries): the affine and the general "
          f"apply, one RHS and three and with aux, and the block apply on 2 "
          f"shards match their plain versions ({max(rels):.1e} <= 1e-5)")

    # -- 3. the main path: solve_local and solve_local_batch -----------------
    log(f"[3] solve_local on rectangle_mesh({NX}, {NY}, {ORDER}) and the "
        f"polar annulus, f32, max_iter={MAX_ITER} {at()}")
    problems = {"rect": (prob, ctx), "annulus": (aprob, actx)}

    def forcings(pk):
        """K forcings sharing one operator: the single-RHS forcing 1.0 and
        K - 1 nodal fields from a seed."""
        d_ = problems[pk][0].disc
        return np.concatenate([np.ones((1, d_.n_nodes)),
                               np.random.RandomState(7).standard_normal(
                                   (K - 1, d_.n_nodes))])

    def residual_fns(pk):
        """(true_residual, copy_gap, the weak RHS of each forcing, the
        initial residual of each) of one problem."""
        prob_, ctx_ = problems[pk]
        free_, to_local_ = ctx_["free_local"], ctx_["to_local"]
        w_ = ctx_["ex"].weights_T(torch.float32, dev)
        d_ = prob_.disc
        u_d_ = np.where(prob_._dirichlet_mask, prob_._dirichlet_vals, 0.0)
        u_dL_ = to_local_(u_d_)

        def true_residual(u, b):
            """||b - A u|| on the free rows, weighted: one f32 apply."""
            rt = torch.where(free_, b - ctx_["A_raw"](to_local_(u)), 0.0)
            return float(torch.sqrt(torch.sum(rt * rt * w_)))

        def copy_gap(x, u):
            """Largest difference between the L-vector solution (the lift
            plus the solver's x) and its global field localized again (one
            copy of each shared node), relative to the solution's max."""
            xL = x.to(u_dL_.dtype) + u_dL_
            return float((to_local_(u) - xL).abs().max() / xL.abs().max())

        bLs = [to_local_(d_.scatter_add(d_.gather(f) * d_.detJxW)
                         .astype(np.float32) + prob_._neumann)
               for f in forcings(pk)]
        r0s = np.array([true_residual(u_d_, b) for b in bLs])
        return true_residual, copy_gap, bLs, r0s

    checks_of = {pk: residual_fns(pk) for pk in problems}
    F_of = {pk: forcings(pk) for pk in problems}
    # mode -> (problem, right-hand sides, solve options).  The three
    # main-path modes (also driven by the profiles and phase 4), deferred
    # x, the batched modes, the rectangle with the general apply forced,
    # and the curved modes; each mode's tag is the variant of kernels A and
    # B it runs
    modes = {"plain": dict(cg_kernel="plain"),
             "fused": dict(cg_kernel="fused"),
             "fused-bf16p": dict(cg_kernel="auto", p_dtype=torch.bfloat16)}
    all_modes = {m: ("rect", 1, kw) for m, kw in modes.items()}
    all_modes.update({
        f"fused-m{DEFER}": ("rect", 1, dict(cg_kernel="fused",
                                            defer_x=DEFER)),
        f"fused-bf16p-m{DEFER}": ("rect", 1, dict(
            cg_kernel="fused", p_dtype=torch.bfloat16, defer_x=DEFER)),
        "general-plain": ("rect", 1, dict(cg_kernel="plain",
                                          structure="general")),
        "fused1": ("rect", 1, dict(cg_kernel="fused1")),
        "fused1-bf16p": ("rect", 1, dict(cg_kernel="fused1",
                                         p_dtype=torch.bfloat16)),
        f"fused1-m{DEFER}": ("rect", 1, dict(cg_kernel="fused1",
                                             defer_x=DEFER)),
        f"fused1-bf16p-m{DEFER}": ("rect", 1, dict(
            cg_kernel="fused1", p_dtype=torch.bfloat16, defer_x=DEFER))})
    all_modes.update({f"batch-{m}": ("rect", K, kw) for m, kw in (
        ("plain", dict(cg_kernel="plain")),
        ("fused", dict(cg_kernel="fused")),
        ("fused-bf16p", dict(cg_kernel="fused", p_dtype=torch.bfloat16)),
        (f"fused-m{DEFER}", dict(cg_kernel="fused", defer_x=DEFER)),
        (f"fused-bf16p-m{DEFER}", dict(cg_kernel="auto",
                                       p_dtype=torch.bfloat16,
                                       defer_x=DEFER)))})
    all_modes.update({f"curved-{m}": ("annulus", 1, kw)
                      for m, kw in modes.items()})
    all_modes.update({f"curved-batch-{m}": ("annulus", K, kw)
                      for m, kw in modes.items()})

    def solve(name, **opts):
        pk, k_, kw = all_modes[name]
        p_ = problems[pk][0]
        if k_ > 1:
            return p_.solve_local_batch(F_of[pk], **kw, **opts)
        return p_.solve_local(**kw, **opts)

    def tag(kw):
        if kw["cg_kernel"] == "plain":
            return None
        return "bf16" if kw.get("p_dtype") is not None else "f32"

    single_rect = [m for m, (pk, k_, _) in all_modes.items()
                   if pk == "rect" and k_ == 1 and m != "general-plain"]
    # the bf16 modes at TOL_F32 record where they stop (the batched one
    # at the bench's configuration); they are not required to converge
    unconverged = {("fused-bf16p", TOL_F32), ("fused1-bf16p", TOL_F32),
                   (f"batch-fused-bf16p-m{DEFER}", TOL_F32)}
    # the deferred-x modes run at TOL_ALL only: deferring x leaves the r
    # recurrence, hence the iterations, as they are (fused-m8 took
    # fused's 6,229 to TOL_F32 on an H100)
    runs = ([(m, tol) for tol in (TOL_ALL, TOL_F32) for m in single_rect
             if tol == TOL_ALL or not m.endswith(f"-m{DEFER}")]
            + [("general-plain", TOL_ALL)]
            + [(f"curved-{m}", TOL_ALL) for m in modes]
            + [("curved-plain", TOL_F32), ("curved-fused", TOL_F32)]
            + [(m, TOL_ALL) for m in all_modes if "batch-" in m]
            + [(f"batch-fused-m{DEFER}", TOL_F32),
               (f"batch-fused-bf16p-m{DEFER}", TOL_F32)])
    # mode -> wrapper -> n -> launches
    solves, launches = {}, {}

    def totals(name):
        """wrapper -> launches of the runs of mode ``name``, over every n."""
        return {w: sum(launches.get(name, {}).get(w, {}).values())
                for w in kernels.WRAPPERS}

    def drive(name, fn):
        """Run one solve with the launch counts set to 0 just before it and
        read just after; returns (solution, seconds)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sol = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for k_, by_n in kernels.launch_counts_by_n().items():
            slot = launches.setdefault(name, {}).setdefault(k_, {})
            for n_, c in by_n.items():
                slot[n_] = slot.get(n_, 0) + c
        return sol, dt

    for name, tol in runs:
        if name == "batch-plain":
            log(f"[3b] solve_local_batch, K={K} right-hand sides {at()}")
        pk, k_, _ = all_modes[name]
        true_residual, copy_gap, bLs, r0s = checks_of[pk]
        n_nodes = problems[pk][0].disc.n_nodes
        sol, dt = drive(name, lambda: solve(name, tol=tol,
                                            max_iter=MAX_ITER))
        U = sol.u.reshape(k_, n_nodes)
        X = sol.cg.x.reshape(k_, *sol.cg.x.shape[-2:])
        its = np.atleast_1d(sol.cg.iterations.cpu().numpy()).tolist()
        conv = np.atleast_1d(sol.cg.converged.cpu().numpy()).tolist()
        res = np.atleast_1d(sol.cg.residual_norm.cpu().numpy()) / r0s[:k_]
        true_rel = np.array([true_residual(U[j], bLs[j])
                             for j in range(k_)]) / r0s[:k_]
        gap = max(copy_gap(X[j], U[j]) for j in range(k_))
        issued = sol.cg.issued
        key = f"{name}@{tol:g}"
        solves[key] = dict(iterations=its, issued=issued, seconds=dt,
                           ms_per_issued_per_rhs=1e3 * dt / issued / k_,
                           recurrence_rel=res.tolist(),
                           true_rel=true_rel.tolist(), copy_gap=gap,
                           converged=conv)
        log(f"  {key}: its {its} / {issued} issued, {dt:.3f} s, "
            f"{1e3 * dt / issued / k_:.4f} ms/iteration issued per RHS, "
            f"residual {np.array2string(res, precision=3)} relative (true "
            f"{np.array2string(true_rel, precision=3)}), copy gap "
            f"{gap:.1e}, converged {conv}")
        check(bool(np.isfinite(sol.u).all()) and sol.u.size == k_ * n_nodes,
              f"{key}: finite solutions of the mesh's shape")
        if (name, tol) not in unconverged:
            check(all(conv), f"{key}: every RHS converged")
        if name.startswith("fused1"):
            # one kernel per iteration: the single kernel of the mode's
            # variant and no kernel of the pair
            c_ = kernels.launch_counts()
            single_k = ("cg_kernel_single_deferred" if f"-m{DEFER}" in name
                        else "cg_kernel_single")
            pair = sum(v for k2, v in c_.items() if k2.startswith(
                ("cg_kernel_a", "cg_kernel_b")))
            check(c_[single_k] >= its[0] and pair == 0,
                  f"{key}: {c_[single_k]} launches of {single_k}, none of "
                  "kernels A and B")

    def its_of(name, tol):
        return solves[f"{name}@{tol:g}"]["iterations"][0]

    # the fused modes against plain CG of their mesh at the same tolerance
    # (a batch by its RHS 0, the single-RHS forcing), and the rectangle's
    # general apply against its affine one
    ratio_checks = [(m, tol, "curved-plain" if m.startswith("curved")
                     else "plain") for m, tol in runs
                    if m not in ("plain", "curved-plain")
                    and (m, tol) not in unconverged]
    for name, tol, ref in ratio_checks:
        p_its, its = its_of(ref, tol), its_of(name, tol)
        check(p_its / ITER_RATIO <= its <= ITER_RATIO * p_its,
              f"{name}@{tol:g} iterations ({its}) within a factor "
              f"{ITER_RATIO} of {ref} ({p_its})")
    for name in ("plain", "general-plain"):
        its = its_of(name, TOL_ALL)
        check(abs(its - PLAIN_ITS) <= 2, f"{name}@{TOL_ALL:g} iterations "
              f"({its}) within 2 of {PLAIN_ITS}")
    # -- 3e. the element-sharded solves and the far-split solve ---------------
    log(f"[3e] S={S_SH} element-sharded solves and a far-split plain CG on "
        f"the rectangle, tol {TOL_ALL:g} {at()}")
    true_residual, _, bLs, r0s = checks_of["rect"]
    p_its = its_of("plain", TOL_ALL)
    w_r = ctx["ex"].weights_T(torch.float32, dev)
    u_dL_r = ctx["to_local"](np.where(prob._dirichlet_mask,
                                      prob._dirichlet_vals, 0.0))
    r_r = torch.where(ctx["free_local"],
                      bLs[0] - ctx["A_raw"](u_dL_r), 0.0)
    A_fs = A_split.masked(ctx["free_local"], assume_masked_input=True)

    def timed_cg(*args, **kw):
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        res_ = cg(*args, **kw)
        torch.cuda.synchronize()
        return res_, time.perf_counter() - t0_

    def sharded_run(comm):
        def run():
            A_, r_, M_, u_dL_, ex_, _ = sharded_local_poisson_problem(
                prob, device_mesh(S_SH), comm=comm)
            res_, t_ = timed_cg(A_, r_, M=M_, tol=TOL_ALL, max_iter=MAX_ITER,
                                dot=ex_.dot_T)
            return res_, t_, ex_, u_dL_
        return run

    def far_split_run():
        res_, t_ = timed_cg(A_fs, r_r, M=ctx["M"], tol=TOL_ALL,
                            max_iter=MAX_ITER, dot_weight=w_r)
        return res_, t_, ctx["ex"], u_dL_r

    sharded_modes = {"sharded-fused": (sharded_run("shardmap-fused"),
                                       "affine_block_apply_dss", S_SH),
                     "sharded-shardmap": (sharded_run("shardmap"), None, 0),
                     "far-split": (far_split_run, "far_update", 1)}
    for name, (run, want, per_apply) in sharded_modes.items():
        (res, t_cg, ex_, u_dL_), dt = drive(name, run)
        u_ = ex_.global_from_local_T((u_dL_ + res.x).cpu().numpy())
        its, issued = int(res.iterations), res.issued
        true_rel = true_residual(u_, bLs[0]) / r0s[0]
        rec_rel = float(res.residual_norm) / r0s[0]
        c_ = {k_: v for k_, v in totals(name).items() if v}
        key = f"{name}@{TOL_ALL:g}"
        solves[key] = dict(iterations=[its], issued=issued, seconds=dt,
                           cg_seconds=t_cg,
                           ms_per_issued=1e3 * t_cg / issued,
                           recurrence_rel=[rec_rel], true_rel=[true_rel],
                           converged=[bool(res.converged)], launches=c_)
        log(f"  {key}: its {its} / {issued} issued, {dt:.3f} s with setup, "
            f"CG {t_cg:.3f} s = {1e3 * t_cg / issued:.4f} ms per issued "
            f"iteration, residual {rec_rel:.3e} relative (true "
            f"{true_rel:.3e}), launches {c_}")
        check(bool(res.converged) and bool(np.isfinite(u_).all())
              and u_.size == disc.n_nodes,
              f"{key}: converged, finite solution of the mesh's shape")
        check(abs(its - p_its) <= 2, f"{key}: iterations ({its}) within 2 "
              f"of plain solve_local ({p_its})")
        if want:
            got_l = totals(name)[want]
            check(got_l >= per_apply * issued and got_l % per_apply == 0,
                  f"{key}: {got_l} launches of {want} ({per_apply} per "
                  f"apply, {got_l / per_apply:.0f} applies for {issued} "
                  "issued iterations)")
        else:
            check(totals(name)["affine_block_apply_dss"] == 0,
                  f"{key}: the plain-PyTorch halo path launches no block "
                  "kernel")
    log("  launches on the main path: " + str(
        {m: {k_: c for k_, c in totals(m).items() if c} for m in launches}))

    # steady-state ms per issued iteration (per RHS): two runs of
    # STEADY[0] and STEADY[1] iterations at tol = 0, whose difference
    # cancels each solve's setup (the forcings, staging, host copies);
    # every mode twice, in the modes' order and then in reverse
    steady = {m: [] for m in all_modes}
    for order in (list(all_modes), list(all_modes)[::-1]):
        for name in order:
            ts = []
            for it in STEADY:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = solve(name, tol=0.0, max_iter=it)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0, sol.cg.issued))
            steady[name].append(1e3 * (ts[1][0] - ts[0][0])
                                / (ts[1][1] - ts[0][1]) / all_modes[name][1])
    log(f"[3c] steady-state ms per issued iteration per RHS ({STEADY[1]} - "
        f"{STEADY[0]} iterations at tol 0; forward, reverse) {at()}: "
        + ", ".join(f"{m} {v[0]:.4f} {v[1]:.4f}" for m, v in steady.items()))
    solves["steady_ms_per_issued_per_rhs"] = steady
    solves["catch_up_ms_per_super_iteration"] = catch_up
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # where one solve's time goes: PROFILE_ITERS iterations of each mode
    # under the profiler (device time by kernel, and the device's busy
    # share; the window includes the solve's staging and host copies)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_solve(name, run, iters):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(tol=0.0, max_iter=iters)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e6
        per_it = 1e3 * busy / iters
        n_launch = sum(e.count for e in ev) / iters
        log(f"  profile {name}: {iters} iterations in {wall:.3f} s "
            f"wall (profiled), device busy {busy:.3f} s "
            f"({busy / wall:.0%}); per iteration {per_it:.4f} ms of device "
            f"time, {n_launch:.1f} launches")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3 / iters:8.4f} "
                f"ms/iter  x{e.count / iters:5.2f}  {e.key[:70]}")
        return dict(device_ms_per_iter=per_it, launches_per_iter=n_launch,
                    busy=busy / wall)

    for name in (*modes, "fused1-bf16p", f"batch-fused-bf16p-m{DEFER}",
                 "curved-fused-bf16p"):
        profile_solve(name, functools.partial(solve, name), PROFILE_ITERS)

    # -- 3d. Helmholtz (BASELINE config 3) on the annulus ---------------------
    log(f"[3d] Helmholtz -div(c grad u) + k u = 1 on the annulus, f32, "
        f"max_iter={MAX_ITER} {at()}")
    helm_modes = {
        "helm-en-pallas": (1, dict(vector_layout="en", backend="pallas")),
        "helm-en-xla": (1, dict(vector_layout="en", backend="xla")),
        "helm-ne": (1, {}),
        "helm-batch-en-pallas": (K, dict(vector_layout="en",
                                         backend="pallas"))}
    HF = np.concatenate([np.ones((1, adisc.n_nodes)),
                         np.random.RandomState(7).standard_normal(
                             (K - 1, adisc.n_nodes))])

    def hsolve(name, **opts):
        k_, kw = helm_modes[name]
        if k_ > 1:
            return hprob.solve_local_batch(HF, **kw, **opts)
        return hprob.solve_local(**kw, **opts)

    # the true residual through the (n, E) operator (its own kernels), one
    # f32 apply, weighted on the free rows
    hne = hprob._local_ops("auto", "ne", "auto", "jacobi", dev)
    hw = hne["ex"].weights_T(torch.float32, dev)

    def h_true_residual(u, b):
        rt = torch.where(hne["free"], b - hne["A"]._raw(hne["to_local"](u)),
                         0.0)
        return float(torch.sqrt(torch.sum(rt * rt * hw)))

    hbLs = [hne["to_local"](adisc.scatter_add(adisc.gather(f) * adisc.detJxW)
                            .astype(np.float32) + hprob._neumann)
            for f in HF]
    h_ud = np.where(hprob._dirichlet_mask, hprob._dirichlet_vals, 0.0)
    h_r0s = np.array([h_true_residual(h_ud, b) for b in hbLs])
    hsols = {}
    for name, (k_, _) in helm_modes.items():
        sol, dt = drive(name, lambda: hsolve(name, tol=TOL_ALL,
                                             max_iter=MAX_ITER))
        U = sol.u.reshape(k_, adisc.n_nodes)
        its = np.atleast_1d(sol.cg.iterations.cpu().numpy()).tolist()
        conv = np.atleast_1d(sol.cg.converged.cpu().numpy()).tolist()
        res = np.atleast_1d(sol.cg.residual_norm.cpu().numpy()) / h_r0s[:k_]
        true_rel = np.array([h_true_residual(U[j], hbLs[j])
                             for j in range(k_)]) / h_r0s[:k_]
        issued = sol.cg.issued
        key = f"{name}@{TOL_ALL:g}"
        hsols[name] = U
        solves[key] = dict(iterations=its, issued=issued, seconds=dt,
                           ms_per_issued_per_rhs=1e3 * dt / issued / k_,
                           recurrence_rel=res.tolist(),
                           true_rel=true_rel.tolist(), converged=conv,
                           launches={k2: c for k2, c in
                                     totals(name).items() if c})
        log(f"  {key}: its {its} / {issued} issued, {dt:.3f} s, "
            f"{1e3 * dt / issued / k_:.4f} ms/iteration issued per RHS, "
            f"residual {np.array2string(res, precision=3)} relative (true "
            f"{np.array2string(true_rel, precision=3)}), converged {conv}, "
            f"launches {solves[key]['launches']}")
        check(bool(np.isfinite(sol.u).all())
              and sol.u.size == k_ * adisc.n_nodes,
              f"{key}: finite solutions of the mesh's shape")
        check(all(conv), f"{key}: every RHS converged")
        c_ = totals(name)
        want = {"helm-en-pallas": "laplacian_local",
                "helm-batch-en-pallas": "laplacian_local_batched",
                "helm-ne": "general_apply_dss"}.get(name)
        if want:
            check(c_[want] >= issued,
                  f"{key}: {want} launched on every apply ({c_[want]} "
                  f">= {issued} issued iterations)")
        if name == "helm-en-xla":
            check(c_["laplacian_local"] + c_["laplacian_local_batched"] == 0,
                  f"{key}: the torch.matmul path launches no element-local "
                  "kernel")
    its_p = solves[f"helm-en-pallas@{TOL_ALL:g}"]["iterations"][0]
    its_x = solves[f"helm-en-xla@{TOL_ALL:g}"]["iterations"][0]
    check(abs(its_p - its_x) <= 2, f"en/pallas iterations ({its_p}) within 2 "
          f"of en/xla ({its_x})")
    # agreement of two f32 solves stopped at TOL_ALL: they differ by the
    # f32 rounding of their Krylov iterates, the same amount whichever
    # product computes the apply; the ne solve against en/xla (two other
    # products) shows that spread.  Held in the relative L2 norm of the
    # model's l2_error; the max-norm difference is printed beside it
    def h_diff(a, b):
        d, r = adisc.gather(a - b), adisc.gather(b)
        l2 = float(np.sqrt(np.sum(d * d * adisc.detJxW)
                           / np.sum(r * r * adisc.detJxW)))
        return l2, float(np.abs(a - b).max() / np.abs(b).max())

    u_x = hsols["helm-en-xla"][0]
    d_px, d_ne = (h_diff(hsols[m][0], u_x) for m in ("helm-en-pallas",
                                                      "helm-ne"))
    d_b = h_diff(hsols["helm-batch-en-pallas"][0], hsols["helm-en-pallas"][0])
    log(f"  relative differences (L2, max): en/pallas - en/xla "
        f"{d_px[0]:.2e}, {d_px[1]:.2e}; ne - en/xla {d_ne[0]:.2e}, "
        f"{d_ne[1]:.2e}; the batch's RHS 0 - en/pallas {d_b[0]:.2e}, "
        f"{d_b[1]:.2e}")
    solves["helmholtz_relative_differences_l2_max"] = dict(
        pallas_xla=d_px, ne_xla=d_ne, batch0_pallas=d_b)
    check(d_px[0] <= 1e-4, f"en/pallas solution within 1e-4 (relative L2) of "
          f"en/xla ({d_px[0]:.2e})")

    hsteady = {m: [] for m in helm_modes}
    for order in (list(helm_modes), list(helm_modes)[::-1]):
        for name in order:
            ts = []
            for it in HELM_STEADY:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sol = hsolve(name, tol=0.0, max_iter=it)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0, sol.cg.issued))
            hsteady[name].append(1e3 * (ts[1][0] - ts[0][0])
                                 / (ts[1][1] - ts[0][1]) / helm_modes[name][0])
    log(f"  steady-state ms per issued iteration per RHS ({HELM_STEADY[1]} - "
        f"{HELM_STEADY[0]} iterations at tol 0; forward, reverse) {at()}: "
        + ", ".join(f"{m} {v[0]:.4f} {v[1]:.4f}" for m, v in hsteady.items()))
    solves["helmholtz_steady_ms_per_issued_per_rhs"] = hsteady
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))
    profile_solve("helm-en-pallas", functools.partial(hsolve, "helm-en-pallas"),
                  HELM_PROFILE_ITERS)

    # -- 3f. the (n, E) operators' backends -----------------------------------
    # every f32 operator of the main path takes the apply kernels; the
    # float64 model and the Morton order (exchange tails) take the "xla"
    # operator on the card, launch no kernel and solve, and backend="fused"
    # raises for each; a float32 operator at p = 9 is "fused" by the
    # reference's rule and has no apply kernel: it raises at build time
    # under "auto" and "fused", and backend="xla" builds it
    log(f"[3f] the (n, E) operators' backends {at()}")
    for what, A_ in (("rectangle A", ctx["A"]), ("rectangle A_raw",
                                                 ctx["A_raw"]),
                     ("annulus A", actx["A"]), ("annulus A_raw",
                                                actx["A_raw"]),
                     ("Helmholtz ne Laplacian", hne["A"].lap)):
        check(A_._backend == "fused", f"{what}: backend 'fused'")
    mort = rectangle_mesh(8, 8, 3)
    mort = partition.reorder_elements(mort, partition.morton_order(
        mort.centroids))
    xla_cases = {"xla-f64": (rectangle_mesh(16, 16, ORDER), ORDER,
                             np.float64, 1e-10),
                 "xla-morton": (mort, 3, np.float32, 1e-5)}
    for name, (mesh_, p_, dt_, tol_) in xla_cases.items():
        xp = Poisson(Discretization(mesh_, gll_basis_2d(p_)), dtype=dt_)
        xp.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
        xc = xp._local_setup(dev)
        sol, dt = drive(name, lambda: xp.solve_local(tol=tol_,
                                                     max_iter=MAX_ITER))
        n_l = sum(totals(name).values())
        log(f"  {name}: {xc['A'].structure}, backend {xc['A']._backend}, "
            f"tails {xc['ex'].n_edge_tail} + {xc['ex'].n_vert_tail}, "
            f"{int(sol.cg.iterations)} its to {tol_:g} in {dt:.2f} s, "
            f"{n_l} kernel launches")
        check(xc["A"]._backend == xc["A_raw"]._backend == "xla"
              and bool(sol.cg.converged) and n_l == 0
              and bool(np.isfinite(sol.u).all()),
              f"{name}: the 'xla' operator solves on the card and launches "
              "no kernel")
        try:
            sumfac.make_local_laplacian_operator(
                xc["ex"], xp._G_host.reshape(xp.disc.E, 3, -1), xc["Dhat"],
                device=dev, backend="fused")
        except ValueError as exc:
            check("requires" in str(exc), f"{name}: backend='fused' raises "
                  f"({str(exc)[:90]}...)")
        else:
            raise AssertionError(f"{name}: backend='fused' did not raise")
    xp = Poisson(Discretization(rectangle_mesh(8, 8, 9), gll_basis_2d(9)),
                 dtype=np.float64)
    xc = xp._local_setup(dev)
    G9 = xp._G_host.reshape(xp.disc.E, 3, -1)
    for be in ("auto", "fused"):
        try:
            sumfac.make_local_laplacian_operator(
                xc["ex"], G9.astype(np.float32), xc["Dhat"], device=dev,
                backend=be)
        except NotImplementedError as exc:
            check("n=100" in str(exc), f"p = 9, float32, backend={be!r}: "
                  f"raises at build time ({str(exc)[:70]}...)")
        else:
            raise AssertionError(f"p = 9, float32, backend={be!r}: no raise")
    A9 = sumfac.make_local_laplacian_operator(
        xc["ex"], G9.astype(np.float32), xc["Dhat"], device=dev,
        backend="xla")
    u9 = torch.randn((A9.n_loc, A9.E), dtype=torch.float64, device=dev)
    kernels.reset_launch_counts()
    y9 = A9(u9.float())
    n_l = sum(kernels.launch_counts().values())
    y64 = xc["A_raw"](u9)
    err9 = float((y9.double() - y64).abs().max() / y64.abs().max())
    log(f"  p = 9, float32, backend 'xla': {A9._backend}, relative max "
        f"difference from the float64 operator {err9:.2e}, {n_l} launches")
    check(A9._backend == "xla" and xc["A_raw"]._backend == "xla"
          and err9 <= 1e-5 and n_l == 0,
          "p = 9: the float32 'xla' operator agrees with the float64 one "
          "to 1e-5 and launches no kernel")

    # -- 3p. the two-level p-multigrid preconditioner --------------------------
    # the reference's converged arm without certify: pmg-CG to 1e-6 on the
    # rectangle (GridFDM coarse solve), the Chebyshev coarse level on the
    # rectangle (the affine p = 1 apply) and on the annulus (the curved one,
    # rediscretized), Helmholtz config 3, the k = 4 batches; then a float64
    # model with the float32 cycle to 1e-10
    log(f"[3p] precond='pmg' (two-level p-multigrid), f32, tol {TOL_PMG:g} "
        f"{at()}")
    CHEB = {"pmg": {"coarse": "chebyshev"}}
    pmg_modes = {"pmg-rect": ("rect", 1, "pmg"),
                 "pmg-rect-cheb": ("rect", 1, CHEB),
                 "pmg-batch": ("rect", K, "pmg"),
                 "pmg-batch-cheb": ("rect", K, CHEB),
                 "pmg-annulus": ("annulus", 1, "pmg"),
                 "pmg-annulus-batch": ("annulus", K, "pmg"),
                 "pmg-helm": ("helm", 1, "pmg")}

    def pmg_solve(name, **opts):
        pk, k_, pre = pmg_modes[name]
        if pk == "helm":
            return hprob.solve_local(precond=pre, **opts)
        p_ = problems[pk][0]
        if k_ > 1:
            return p_.solve_local_batch(F_of[pk], precond=pre, **opts)
        return p_.solve_local(precond=pre, **opts)

    pmg_info = {}
    for name, (pk, k_, pre) in pmg_modes.items():
        stages.snapshot(reset=True)
        sol, dt = drive(name, lambda: pmg_solve(name, tol=TOL_PMG,
                                                max_iter=MAX_ITER))
        setup = {st: round(v, 3) for st, v in stages.snapshot(reset=True)
                 .items() if v >= 0.005}
        if pk == "helm":
            tr_fn, bl, r0 = h_true_residual, hbLs, h_r0s
            M_ = hprob._op_cache[("M", "pmg", "ne", (), str(dev))]
            nn = adisc.n_nodes
        else:
            tr_fn, _, bl, r0 = checks_of[pk]
            prob_, ctx_ = problems[pk]
            M_ = prob_._pmg(ctx_, pre, dev)
            nn = prob_.disc.n_nodes
        U = sol.u.reshape(k_, nn)
        its = np.atleast_1d(sol.cg.iterations.cpu().numpy()).tolist()
        conv = np.atleast_1d(sol.cg.converged.cpu().numpy()).tolist()
        res = np.atleast_1d(sol.cg.residual_norm.cpu().numpy()) / r0[:k_]
        true_rel = np.array([tr_fn(U[j], bl[j]) for j in range(k_)]) \
            / r0[:k_]
        issued = sol.cg.issued
        by_n = {w: c for w, c in launches[name].items() if c}
        key = f"{name}@{TOL_PMG:g}"
        pmg_info[name] = M_
        solves[key] = dict(iterations=its, issued=issued, seconds=dt,
                           recurrence_rel=res.tolist(),
                           true_rel_f32=true_rel.tolist(), converged=conv,
                           coarse_kind=M_._coarse_kind,
                           lmax_f=M_._lmax_f, setup_stages_s=setup,
                           launches_by_n={w: {str(n_): c for n_, c in
                                              d.items()}
                                          for w, d in by_n.items()})
        log(f"  {key}: its {its} / {issued} issued, {dt:.3f} s (setup "
            f"stages {setup}), residual {np.array2string(res, precision=3)}"
            f" relative (true, f32-evaluated "
            f"{np.array2string(true_rel, precision=3)}), coarse "
            f"{M_._coarse_kind}, lmax_f {M_._lmax_f:.4f}, launches {by_n}")
        check(bool(np.isfinite(sol.u).all()) and sol.u.size == k_ * nn
              and all(conv), f"{key}: every RHS converged, finite solutions "
              "of the mesh's shape")
        check(all(op._backend == "fused" for op in M_._ops.values()),
              f"{key}: the V-cycle's f32 levels take the apply kernels "
              f"(n = {M_._ops['fine'].n_loc} and "
              f"{M_._ops['coarse'].n_loc})")

    # the headline cell against the reference's hardware-free numbers
    M = pmg_info["pmg-rect"]
    its = solves[f"pmg-rect@{TOL_PMG:g}"]["iterations"][0]
    lmax30 = M._lmax_f / 1.05          # the estimate before the safety
    check(M._coarse_kind == "fdm", "pmg-rect: the coarse solve is GridFDM")
    check(abs(lmax30 - PMG_LMAX30) <= 0.03 * PMG_LMAX30,
          f"pmg-rect: the 30-iteration lmax estimate {lmax30:.4f} (lmax_f "
          f"{M._lmax_f:.4f} / 1.05) within 3% of the reference's "
          f"{PMG_LMAX30}")
    check(abs(its - PMG_ITS) <= 2, f"pmg-rect: {its} iterations to the "
          f"claimed {TOL_PMG:g}, the reference's {PMG_ITS}")
    # lambda_max(M A) by 20 power iterations, as the Rayleigh quotient of
    # M A in the A-inner product (M A is A-self-adjoint)
    A_m, free_m = ctx["A"], ctx["free_local"]
    w_m = ctx["ex"].weights_T(torch.float32, dev)
    v = torch.where(free_m, torch.randn((n, E), generator=g, device=dev),
                    0.0)
    for _ in range(20):
        v = M(A_m(v))
        v = v / torch.sqrt(torch.sum(v * v * w_m))
    Av = A_m(v)
    lam_ma = float(torch.sum(M(Av) * Av * w_m) / torch.sum(Av * v * w_m))
    check(0.9 < lam_ma < 1.05, f"pmg-rect: lambda_max(M A) by 20 power "
          f"iterations {lam_ma:.4f} (the reference's {PMG_LAM_MA} with f32 "
          "V-cycle matmuls; 1.566 with bf16 ones)")
    # the true residual evaluated in float64, through the "xla" operator
    # of the float64 factors on the card (an f32-evaluated one floors near
    # 1e-5 relative at this size)
    A64 = sumfac.make_local_laplacian_operator(
        ctx["ex"], prob._G_host.astype(np.float64).reshape(E, 3, -1),
        ctx["Dhat"], None, device=dev)
    gih = torch.as_tensor(ctx["ex"].gather_hier, device=dev)

    def tl64(u):
        return torch.as_tensor(np.asarray(u, np.float64),
                               device=dev)[gih].T.contiguous()

    w64 = ctx["ex"].weights_T(torch.float64, dev)
    b64 = tl64(np.asarray(prob._b, np.float64) + prob._neumann)
    u_d64 = np.where(prob._dirichlet_mask, prob._dirichlet_vals, 0.0)

    def true64(u):
        rt = torch.where(free_m, b64 - A64(tl64(u)), 0.0)
        return float(torch.sqrt(torch.sum(rt * rt * w64)))

    sol = pmg_solve("pmg-rect", tol=TOL_PMG, max_iter=MAX_ITER)
    r0_64 = true64(u_d64)
    rep_rel = float(sol.cg.residual_norm) / r0_64
    true_rel64 = true64(sol.u) / r0_64
    u_pmg_rect = sol.u              # phase 3r evaluates it once more
    check(A64._backend == "xla", "the float64 residual operator is 'xla'")
    log(f"  pmg-rect: {its} iterations (reference {PMG_ITS}), reported "
        f"relative residual {rep_rel:.3e}, true (float64-evaluated) "
        f"{true_rel64:.3e}; lmax_f {M._lmax_f:.4f} = 1.05 x {lmax30:.4f} "
        f"(reference {PMG_LMAX30}); lambda_max(M A) {lam_ma:.4f} (reference "
        f"{PMG_LAM_MA})")
    # ms per V-cycle (device: CUDA events after a sleep kernel; host
    # clock) and per pmg iteration (one 64-iteration block of cg, called
    # directly: frozen iterations do the same work), launches per
    # iteration
    rs = [torch.where(free_m, torch.randn((n, E), generator=g, device=dev),
                      0.0) for _ in range(4)]
    vc_dev = gpu_ms(M, [(r_,) for r_ in rs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        M(rs[i % 4])
    torch.cuda.synchronize()
    vc_host = 1e3 * (time.perf_counter() - t0) / 20
    cg_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_ = cg(A_m, r_r, M=M, tol=0.0, max_iter=64, dot_weight=w_m)
        torch.cuda.synchronize()
        cg_ms.append(1e3 * (time.perf_counter() - t0) / res_.issued)
    per_it = launches["pmg-rect"]["affine_apply_dss"].get(n, 0) / \
        solves[f"pmg-rect@{TOL_PMG:g}"]["issued"]
    log(f"  pmg-rect: V-cycle {vc_dev:.4f} ms device, {vc_host:.4f} ms host "
        f"clock; pmg-CG {cg_ms[0]:.4f} / {cg_ms[1]:.4f} ms per issued "
        f"iteration (host clock, one 64-iteration block); "
        f"{per_it:.2f} affine_apply_dss launches per issued iteration of the "
        f"solve (7 per iteration, the lift and the two lmax estimates)")
    solves["pmg_rect_headline"] = dict(
        iterations=its, reference_iterations=PMG_ITS,
        reported_rel=rep_rel, true_rel_f64=true_rel64, lmax_f=M._lmax_f,
        lmax30=lmax30, reference_lmax30=PMG_LMAX30, lambda_max_MA=lam_ma,
        reference_lambda_max_MA=PMG_LAM_MA, vcycle_ms_device=vc_dev,
        vcycle_ms_host=vc_host, cg_ms_per_issued=cg_ms)
    solves["pmg_rect_headline"]["profile"] = profile_solve(
        "pmg-rect", functools.partial(pmg_solve, "pmg-rect"), 64)
    # the Chebyshev coarse level's cells beside it: a V-cycle's device
    # time and launches (the profiler's sum over 8 V-cycles, host gaps
    # left out), the p = 1 apply's launches per issued iteration of the
    # solve, and a profile (device ms and launches per pmg iteration)
    for name, p1_name in (("pmg-rect", None),
                          ("pmg-rect-cheb", "affine_apply_dss"),
                          ("pmg-annulus", "general_apply_dss")):
        M_, key = pmg_info[name], f"{name}@{TOL_PMG:g}"
        free_ = problems[pmg_modes[name][0]][1]["free_local"]
        vc_ms, vc_launch = device_per_call(M_, [(torch.where(
            free_, torch.randn((n, E), generator=g, device=dev), 0.0),)
            for _ in range(8)])
        p1_per_it = launches[name].get(p1_name, {}).get(4, 0) \
            / solves[key]["issued"]
        log(f"  {name}: V-cycle {vc_ms:.4f} ms of device time, "
            f"{vc_launch:.1f} launches" + (
                f"; {p1_per_it:.2f} {p1_name} launches at n = 4 per issued "
                "iteration of the solve" if p1_name else ""))
        solves[key].update(vcycle_device_ms=vc_ms,
                           vcycle_launches=vc_launch,
                           p1_launches_per_issued=p1_per_it)
        if name != "pmg-rect":
            solves[key]["profile"] = profile_solve(
                name, functools.partial(pmg_solve, name), 64)

    # a float64 model with the float32 V-cycle, to 1e-10 against its
    # manufactured solution (the reference's tests/test_pmg.py case at
    # p = 8): the outer apply is the "xla" operator on the card, the cycle
    # the apply kernels
    def u_mms(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    fp = Poisson(Discretization(rectangle_mesh(32, 32, ORDER, x0=(0, 0),
                                               x1=(1, 1)),
                                gll_basis_2d(ORDER)),
                 forcing=lambda x, y: 2 * np.pi ** 2 * u_mms(x, y),
                 dtype=np.float64)
    fp.set_dirichlet("ebc", 0.0)
    fp.set_dirichlet("nbc", 0.0)
    sol, dt = drive("pmg-f64", lambda: fp.solve_local(tol=1e-10,
                                                      precond="pmg"))
    fctx = fp._local_setup(dev)
    fM = fp._pmg(fctx, "pmg", dev)
    l2 = fp.l2_error(sol.u, u_mms)
    log(f"  pmg-f64@1e-10: {int(sol.cg.iterations)} its / {sol.cg.issued} "
        f"issued, {dt:.3f} s, outer apply {fctx['A']._backend}, cycle "
        f"{fM._cycle_dtype} ({fM._ops['fine']._backend}, "
        f"{fM._ops['coarse']._backend}), reported residual "
        f"{float(sol.cg.residual_norm):.3e}, l2 error {l2:.3e}, max "
        f"{np.abs(sol.u - u_mms(*fp.x_nodes)).max():.3e}")
    check(fctx["A"]._backend == "xla" and fM._cycle_dtype == np.float32
          and fM._ops["fine"]._backend == "fused"
          and bool(sol.cg.converged) and l2 < 1e-10,
          "pmg-f64: the float64 model reaches 1e-10 through the 'xla' outer "
          "apply with the float32 cycle on the kernels, l2 error below "
          "1e-10")
    solves["pmg-f64@1e-10"] = dict(iterations=int(sol.cg.iterations),
                                   issued=sol.cg.issued, seconds=dt,
                                   l2_error=l2)
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # -- 3r. the float64-certified solve ------------------------------------
    # the reference's converged arm (bench.py: solve_local(tol=1e-6,
    # precond="pmg", certify=True), a warm call and a timed one) on the
    # rectangle and the annulus; each solution's float64 true residual is
    # recomputed here by a float64 "xla" operator of the same factor values,
    # built apart from the solve's cached one; then certify on a float64
    # model (a no-op: no kernel), and the global-vector entry points
    log(f"[3r] solve_local(certify=True), precond='pmg', tol {TOL_PMG:g} "
        f"{at()}")

    def cert_check_fns(prob_, ctx_):
        """(true residual of a global u or an (n, E) float64 L-vector,
        ||b_hi||_w, the lift as a float64 L-vector, the operator's backend),
        float64, from an operator of the certified system's factor values
        (the rank-1 field a (x) W on an affine mesh, else the float32
        factors upcast)."""
        ex_, d_ = ctx_["ex"], prob_.disc
        G32 = prob_._G_host.reshape(d_.E, 3, -1)
        W = np.asarray(d_.basis.weight_grid(), np.float64).reshape(-1)
        a_, exact = sumfac.affine_factorization(G32, W)
        G64 = a_[:, :, None] * W if exact else G32.astype(np.float64)
        A_ = sumfac.make_local_laplacian_operator(
            ex_, G64, np.asarray(ctx_["Dhat"], np.float64), None, device=dev,
            backend="xla")
        w_ = ex_.weights_T(torch.float32, dev)
        free_ = ctx_["free_local"]

        def tl64(u):
            return torch.as_tensor(ex_.local_T_from_global(
                np.asarray(u, np.float64)), device=dev)

        b_ = tl64(np.asarray(prob_._b, np.float64) + prob_._neumann)

        def true_res(u):
            uL = u if isinstance(u, torch.Tensor) else tl64(u)
            rt = torch.where(free_, b_ - A_(uL), 0.0)
            return float(torch.sqrt(torch.sum(w_ * rt * rt)))

        u_dL = tl64(np.where(prob_._dirichlet_mask, prob_._dirichlet_vals,
                             0.0))
        return true_res, true_res(u_dL), u_dL, A_._backend

    def cert_cell(name, prob_, ctx_, calls=2, pmg_key=None):
        """``calls`` certified solves of one problem (a warm call, then a
        timed one, as bench.py), checked and logged; returns the last
        solution, its check functions and the segments it ran."""
        true_res, bnorm, u_dL64, be64 = cert_check_fns(prob_, ctx_)
        stages.snapshot(reset=True)
        runs_ = [drive(name, lambda: prob_.solve_local(
            tol=TOL_PMG, precond="pmg", certify=True)) for _ in range(calls)]
        setup = {st: round(v, 3) for st, v in stages.snapshot(reset=True)
                 .items() if v >= 0.001}
        (sol0, dt0), (sol, dt) = runs_[0], runs_[-1]
        res = sol.cg
        rel = true_res(sol.u) / bnorm
        # the solver's float64 L-vector iterate, before the model-dtype
        # rounding and the global field's one copy per node
        rel_x = true_res(u_dL64 + res.x) / bnorm
        same = (np.array_equal(sol0.u, sol.u)
                and bool(torch.equal(sol0.cg.x, res.x)))
        ran = int(np.searchsorted(np.cumsum((64, 32, 32, 64)), res.issued)
                  + 1)
        pmg_setup = solves[pmg_key]["setup_stages_s"] if pmg_key else {}
        by_n = {w: c for w, c in launches[name].items() if c}
        solves[f"{name}@{TOL_PMG:g}"] = dict(
            converged=res.converged, stalled=res.stalled,
            iterations=res.iterations, issued=res.issued, segments_run=ran,
            cycle_resnorms=list(res.cycle_resnorms),
            reported_rel=res.residual_norm / bnorm, true_rel_f64=rel,
            true_rel_f64_of_x=rel_x, bit_for_bit=same, seconds_warm=dt0,
            seconds=dt, setup_stages_s=setup, pmg_setup_stages_s=pmg_setup,
            launches_by_n={w: {str(n_): c for n_, c in d.items()}
                           for w, d in by_n.items()})
        log(f"  {name}: converged {res.converged}, stalled {res.stalled}, "
            f"its {res.iterations} / {res.issued} issued (the reference: 27 "
            f"/ 128), {ran} segments; cycle_resnorms "
            f"{[float(f'{v:.3e}') for v in res.cycle_resnorms]} (the "
            f"reference: 2.2e-3, 8.6e-5, 1.03e-5, 1.03e-5 on the rectangle); "
            f"reported {res.residual_norm / bnorm:.3e} relative, true "
            f"float64 {rel:.3e} of u ({rel_x:.3e} of the float64 iterate), "
            f"against tol {TOL_PMG:g} x ||b_hi||_w = {TOL_PMG * bnorm:.4e} "
            f"({be64} operator); {calls} calls: first {dt0:.3f} s, last "
            f"{dt:.3f} s; setup stages {setup}, pmg-build in 3p "
            f"{pmg_setup.get('precond/pmg-build')}; launches {by_n}")
        check(res.converged and not res.stalled,
              f"{name}: converged, not stalled")
        check(rel_x <= 1.05 * TOL_PMG,
              f"{name}: the float64 iterate's recomputed true residual "
              f"{rel_x:.3e} <= 1.05 x {TOL_PMG:g} of ||b_hi||_w")
        if calls > 1:
            check(same, f"{name}: the repeat call is bit for bit the first")
        check(bool(np.isfinite(sol.u).all()) and sol.u.dtype == np.float32
              and sol.u.size == prob_.disc.n_nodes,
              f"{name}: a finite float32 solution of the mesh's shape")
        return res, true_res, bnorm, ran

    res, true_res, bnorm, ran = cert_cell("cert-rect", prob, ctx,
                                          pmg_key=f"pmg-rect@{TOL_PMG:g}")
    check(res.issued <= 128 and abs(res.iterations - 27) <= 5,
          f"cert-rect: {res.iterations} iterations within 27 +- 5, "
          f"{res.issued} issued <= 128")
    r_cert = solves[f"cert-rect@{TOL_PMG:g}"]["true_rel_f64"]
    r_unc = true_res(u_pmg_rect) / bnorm
    solves[f"cert-rect@{TOL_PMG:g}"].update(
        uncertified_true_rel_f64=r_unc, uncertified_true_rel_f64_3p=true_rel64)
    log(f"  cert-rect: true float64 residual of u: certified {r_cert:.3e}, "
        f"uncertified pmg (3p) {r_unc:.3e} against this operator, "
        f"{true_rel64:.3e} against 3p's upcast one")
    # where the certified solve's time goes: all four segments (tol 0 runs
    # the whole schedule), and one float64 anchor timed
    A_hi = prob._op_cache[("A_hi", "ne", str(dev))]
    _, r_hi = prob._bc_cache[str(dev)]["ne"]
    xs = [(torch.where(ctx["free_local"], torch.randn(
        (n, E), generator=g, device=dev, dtype=torch.float64), 0.0),)
        for _ in range(3)]
    anchor_ms = gpu_ms(lambda x: torch.sum(w_m * (r_hi - A_hi(x)) ** 2), xs,
                       reps=10)
    prof = profile_solve("cert-rect", functools.partial(
        prob.solve_local, precond="pmg", certify=True), 192)
    solves[f"cert-rect@{TOL_PMG:g}"].update(
        profile_192=prof, anchor_ms=anchor_ms, anchors_per_solve=ran)
    log(f"  cert-rect: a float64 anchor (apply of A_hi and the weighted norm) "
        f"{anchor_ms:.4f} ms device, {ran} per solve ({ran * anchor_ms:.3f} "
        f"ms), 4 in the 192-iteration profile")
    del xs, A_hi, r_hi
    cert_cell("cert-annulus", aprob, actx, pmg_key=f"pmg-annulus@{TOL_PMG:g}")

    # the reference's unmet goal (VERDICT.md): a certified converged solve
    # at 1,048,576 elements; one call, and the setup seconds of the mesh,
    # the discretization, the model and its operators beside it
    t1m = {}
    t0 = time.perf_counter()
    m1m = rectangle_mesh(NX_1M, NX_1M, ORDER)
    t1m["mesh"] = time.perf_counter() - t0
    d1m = Discretization(m1m, gll_basis_2d(ORDER))
    t1m["discretization"] = time.perf_counter() - t0 - sum(t1m.values())
    p1m = Poisson(d1m, dtype=np.float32)
    p1m.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    t1m["model"] = time.perf_counter() - t0 - sum(t1m.values())
    c1m = p1m._local_setup(dev)
    torch.cuda.synchronize()
    t1m["operators"] = time.perf_counter() - t0 - sum(t1m.values())
    torch.cuda.reset_peak_memory_stats()
    cert_cell("cert-1m", p1m, c1m, calls=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    solves[f"cert-1m@{TOL_PMG:g}"].update(E=d1m.E, setup_s=t1m,
                                         peak_device_gib=peak)
    log(f"  cert-1m: E = {d1m.E}, setup before the call "
        f"{ {k_: round(v, 2) for k_, v in t1m.items()} } s, peak device "
        f"memory {peak:.2f} GiB {at()}")
    del m1m, d1m, p1m, c1m
    torch.cuda.empty_cache()

    # certify on a float64 model does nothing: the plain solve, bit for
    # bit, through the "xla" operator, no kernel launched
    xp = Poisson(Discretization(rectangle_mesh(16, 16, ORDER),
                                gll_basis_2d(ORDER)), dtype=np.float64)
    xp.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    sol_c, dt = drive("cert-f64", lambda: xp.solve_local(tol=1e-10,
                                                         certify=True))
    sol_p = xp.solve_local(tol=1e-10)
    n_l = sum(totals("cert-f64").values())
    log(f"  cert-f64: {int(sol_c.cg.iterations)} its, {dt:.3f} s, "
        f"cycle_resnorms {sol_c.cg.cycle_resnorms}, {n_l} kernel launches")
    check(np.array_equal(sol_c.u, sol_p.u) and sol_c.cg.cycle_resnorms == ()
          and n_l == 0 and bool(sol_c.cg.converged),
          "cert-f64: certify on a float64 model is the plain solve, bit for "
          "bit, with no kernel launched")

    # the global-vector entry points on a small float64 rectangle with the
    # manufactured u = 0.1 (x + y) (Dirichlet + Neumann), phase 4's bar
    gp = Poisson(Discretization(rectangle_mesh(16, 16, ORDER),
                                gll_basis_2d(ORDER)), forcing=0.0,
                 dtype=np.float64)
    gp.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    gp.set_neumann("nbc", 0.1)
    gx, gy = gp.x_nodes
    for name, fn in (("global-solve", lambda: gp.solve(tol=1e-10)),
                     ("global-solve-host", lambda: gp.solve(
                         tol=1e-10, host_loop=True)),
                     ("local-host", lambda: gp.solve_local(
                         tol=1e-10, host_loop=True))):
        sol_g, dt = drive(name, fn)
        err = gp.l2_error(sol_g.u, lambda x, y: 0.1 * (x + y))
        n_l = sum(totals(name).values())
        err_max = np.abs(sol_g.u - 0.1 * (gx + gy)).max()
        log(f"  {name}: {int(sol_g.cg.iterations)} its, {dt:.3f} s, l2 "
            f"error {err:.3e}, max {err_max:.3e}, {n_l} kernel launches")
        solves[f"{name}@1e-10"] = dict(iterations=int(sol_g.cg.iterations),
                                       seconds=dt, l2_error=err)
        check(bool(sol_g.cg.converged) and err < 1e-4,
              f"{name}: converged, l2 error below 1e-4")
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # -- 3s. fdm, the (E, n) layout, compute_dtype and the precision tiers --
    # the rest of Poisson's 2D solve surface on the 100k meshes: the FDM
    # additive Schwarz (on "ne", the curved annulus, a k = 4 batch, pmg's
    # second smoother, the certified solve), the row-major "en" layout
    # (Jacobi, fdm, a batch through cg_batched's per-RHS mode), the bf16
    # products and the precision tiers; each count against the same run's
    # phase 3 and 3p cells
    log(f"[3s] precond='fdm', vector_layout='en', compute_dtype, precision "
        f"tiers, f32 {at()}")
    t_3s = time.perf_counter()
    s_modes = {
        "fdm-rect": ("rect", 1, dict(precond="fdm")),
        "fdm-annulus": ("annulus", 1, dict(precond="fdm")),
        "fdm-batch": ("rect", K, dict(precond="fdm")),
        "en-rect": ("rect", 1, dict(vector_layout="en")),
        "en-fdm-rect": ("rect", 1, dict(vector_layout="en", precond="fdm")),
        "en-batch": ("rect", K, dict(vector_layout="en")),
        "bf16-compute": ("rect", 1, dict(compute_dtype=torch.bfloat16))}
    s_runs = [("fdm-rect", TOL_ALL), ("fdm-rect", TOL_F32),
              ("fdm-annulus", TOL_ALL), ("fdm-batch", TOL_ALL),
              ("en-rect", TOL_ALL), ("en-fdm-rect", TOL_ALL),
              ("en-batch", TOL_ALL), ("bf16-compute", TOL_ALL)]

    def s_solve(name, **opts):
        pk, k_, kw = s_modes[name]
        p_ = problems[pk][0]
        if k_ > 1:
            return p_.solve_local_batch(F_of[pk], **kw, **opts)
        return p_.solve_local(**kw, **opts)

    apply_of = {"rect": "affine_apply_dss", "annulus": "general_apply_dss"}
    for name, tol in s_runs:
        pk, k_, _ = s_modes[name]
        true_residual, _, bLs, r0s = checks_of[pk]
        n_nodes = problems[pk][0].disc.n_nodes
        # the bf16 products may floor above the tolerance: a bounded run
        sol, dt = drive(name, lambda: s_solve(
            name, tol=tol, max_iter=3000 if name == "bf16-compute"
            else MAX_ITER))
        U = sol.u.reshape(k_, n_nodes)
        its = np.atleast_1d(sol.cg.iterations.cpu().numpy()).tolist()
        conv = np.atleast_1d(sol.cg.converged.cpu().numpy()).tolist()
        res = np.atleast_1d(sol.cg.residual_norm.cpu().numpy()) / r0s[:k_]
        true_rel = np.array([true_residual(U[j], bLs[j])
                             for j in range(k_)]) / r0s[:k_]
        issued = sol.cg.issued
        n_apply = launches[name].get(apply_of[pk], {}).get(n, 0) + \
            launches[name].get(apply_of[pk] + "_batched", {}).get(n, 0)
        n_all = sum(totals(name).values())
        key = f"{name}@{tol:g}"
        solves[key] = dict(iterations=its, issued=issued, seconds=dt,
                           ms_per_issued_per_rhs=1e3 * dt / issued / k_,
                           recurrence_rel=res.tolist(),
                           true_rel=true_rel.tolist(), converged=conv,
                           apply_launches_per_issued=n_apply / issued,
                           kernel_launches=n_all)
        log(f"  {key}: its {its} / {issued} issued, {dt:.3f} s, "
            f"{1e3 * dt / issued / k_:.4f} ms/iteration issued per RHS "
            f"(host clock), residual {np.array2string(res, precision=3)} "
            f"relative (true, f32-evaluated "
            f"{np.array2string(true_rel, precision=3)}), converged {conv}; "
            f"{n_apply / issued:.2f} {apply_of[pk]} launches per issued "
            f"iteration, {n_all} kernel launches in all")
        check(bool(np.isfinite(sol.u).all()) and sol.u.size == k_ * n_nodes,
              f"{key}: finite solutions of the mesh's shape")
        if name != "bf16-compute":
            check(all(conv), f"{key}: every RHS converged")
        if name.startswith("en-") or name == "bf16-compute":
            check(n_all == 0, f"{key}: the 'xla' operator launches no "
                  f"kernel ({n_all})")
        else:
            check(n_apply >= max(its), f"{key}: {n_apply} launches of "
                  f"{apply_of[pk]}, at least one per iteration")

    def s_its(key):
        return solves[key]["iterations"]

    def close(a, b):
        return abs(a - b) <= max(2, 0.01 * b)

    f_its, p_its = s_its(f"fdm-rect@{TOL_ALL:g}")[0], s_its(
        f"plain@{TOL_ALL:g}")[0]
    check(f_its < 0.7 * p_its, f"fdm-rect@{TOL_ALL:g}: {f_its} iterations "
          f"< 0.7 x plain's {p_its}")
    log(f"  fdm-rect@{TOL_F32:g}: {s_its(f'fdm-rect@{TOL_F32:g}')[0]} "
        f"iterations against plain's {s_its(f'plain@{TOL_F32:g}')[0]}; "
        f"fdm-annulus@{TOL_ALL:g} "
        f"{s_its(f'fdm-annulus@{TOL_ALL:g}')[0]} against curved-plain's "
        f"{s_its(f'curved-plain@{TOL_ALL:g}')[0]}")
    for en_key, ne_key in (("en-rect", "plain"), ("en-fdm-rect", "fdm-rect"),
                           ("en-batch", "batch-plain")):
        a_, b_ = (s_its(f"{k_}@{TOL_ALL:g}") for k_ in (en_key, ne_key))
        check(all(close(x_, y_) for x_, y_ in zip(a_, b_)),
              f"{en_key}@{TOL_ALL:g}: iterations {a_} within 2 (or 1%) of "
              f"{ne_key}'s {b_}")
    fb = s_its(f"fdm-batch@{TOL_ALL:g}")
    check(fb[0] == f_its or close(fb[0], f_its), f"fdm-batch@{TOL_ALL:g}: "
          f"RHS 0 ({fb[0]}) as fdm-rect ({f_its})")

    # the fdm M apply alone: device and host-clock ms beside its bound (read
    # r, w and the inverse eigenvalues, write z; the two dense transforms'
    # flops), launches per apply; one profile of fdm-PCG
    M_f = prob._precond(ctx, "fdm", dev)
    rs = [torch.where(ctx["free_local"], torch.randn(
        (n, E), generator=g, device=dev), 0.0) for _ in range(4)]
    m_dev = gpu_ms(M_f, [(r_,) for r_ in rs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(20):
        M_f(rs[i % 4])
    torch.cuda.synchronize()
    m_host = 1e3 * (time.perf_counter() - t0) / 20
    _, m_launch = device_per_call(M_f, [(r_,) for r_ in rs])
    m_bound, m_by = bound(16 * n * E, 2 * 2 * n * n * E)
    prof_f = profile_solve("fdm-rect", functools.partial(s_solve,
                                                         "fdm-rect"), 64)
    solves["fdm_apply"] = dict(ms=m_dev, host_ms=m_host,
                               launches_per_apply=m_launch, bound_ms=m_bound,
                               bound_by=m_by, profile_fdm_rect_64=prof_f)
    log(f"  fdm M apply: {m_dev:.4f} ms device, {m_host:.4f} ms host clock, "
        f"{m_launch:.1f} launches; bound {m_bound:.4f} ms ({m_by}: read r, "
        f"w, invD, write z; 2 x 2 x n^2 x E flops)")

    # pmg with the fdm smoother (the fine level's B_f), to 1e-6
    pf = {"pmg": {"smoother": "fdm"}}
    sol, dt = drive("pmg-fdm-rect", lambda: prob.solve_local(
        tol=TOL_PMG, precond=pf, max_iter=MAX_ITER))
    M_pf = prob._pmg(ctx, pf, dev)
    vc_pf = gpu_ms(M_pf, [(r_,) for r_ in rs])
    its_pf = int(sol.cg.iterations)
    its_pj = s_its(f"pmg-rect@{TOL_PMG:g}")[0]
    true_pf = checks_of["rect"][0](sol.u, checks_of["rect"][2][0]) / \
        checks_of["rect"][3][0]
    solves[f"pmg-fdm-rect@{TOL_PMG:g}"] = dict(
        iterations=its_pf, issued=sol.cg.issued, seconds=dt,
        vcycle_ms_device=vc_pf, lmax_f=M_pf._lmax_f, true_rel=true_pf,
        pmg_jacobi_iterations=its_pj)
    log(f"  pmg-fdm-rect@{TOL_PMG:g}: {its_pf} its / {sol.cg.issued} "
        f"issued (pmg-rect {its_pj}), {dt:.3f} s, V-cycle {vc_pf:.4f} ms "
        f"device, lmax_f {M_pf._lmax_f:.4f}, true residual {true_pf:.3e}")
    check(bool(sol.cg.converged) and isinstance(
        M_pf._B_f, type(M_f)) and M_pf._ops["fine"]._backend == "fused",
        "pmg-fdm-rect: converged with the fdm smoother on the apply "
        "kernels")

    # certify with fdm: a small rectangle where the reference's fixed
    # schedule (192 iterations at most) converges, then the 100k one, where
    # it need not: the flag must agree with the recomputed residual
    cp = Poisson(Discretization(rectangle_mesh(8, 8, ORDER),
                                gll_basis_2d(ORDER)), dtype=np.float32)
    cp.set_dirichlet("ebc", lambda x, y: 0.2 * ((x + 1) + (y + 1)))
    for name, prob_ in (("cert-fdm-8x8", cp), ("cert-fdm-rect", prob)):
        ctx_ = prob_._local_setup(dev)
        true_res, bnorm, u_dL64, _ = cert_check_fns(prob_, ctx_)
        sol, dt = drive(name, lambda: prob_.solve_local(
            tol=TOL_PMG, precond="fdm", certify=True))
        res = sol.cg
        rel_x = true_res(u_dL64 + res.x) / bnorm
        segs = int(np.searchsorted(np.cumsum((64, 32, 32, 64)), res.issued)
                   + 1)
        solves[f"{name}@{TOL_PMG:g}"] = dict(
            converged=res.converged, stalled=res.stalled,
            iterations=res.iterations, issued=res.issued, segments_run=segs,
            cycle_resnorms=list(res.cycle_resnorms), true_rel_f64_of_x=rel_x,
            seconds=dt)
        log(f"  {name}: converged {res.converged}, stalled {res.stalled}, "
            f"its {res.iterations} / {res.issued} issued, {segs} segments, "
            f"cycle_resnorms "
            f"{[float(f'{v:.3e}') for v in res.cycle_resnorms]}, true "
            f"float64 {rel_x:.3e} of the iterate (tol {TOL_PMG:g}), "
            f"{dt:.3f} s")
        check(res.converged == (rel_x <= TOL_PMG * (1 + 1e-6)),
              f"{name}: the converged flag ({res.converged}) agrees with the "
              f"recomputed residual {rel_x:.3e}")
        if prob_ is cp:
            check(res.converged and rel_x <= 1.05 * TOL_PMG,
                  f"{name}: converged, the recomputed residual {rel_x:.3e} "
                  f"<= 1.05 x {TOL_PMG:g}")
    del cp

    # the bf16 products: the rectangle's "xla" apply within 0.03 of max of
    # its float32 apply (the reference's bar); backend="fused" refuses them
    Gf_r = prob._G_host.reshape(E, 3, -1)
    A16 = sumfac.make_local_laplacian_operator(
        ctx["ex"], Gf_r, ctx["Dhat"], None, device=dev,
        compute_dtype=torch.bfloat16)
    u_ = randn()
    e16 = rel_err(A16(u_), ctx["A_raw"](u_))[1]
    log(f"  bf16-compute: the 'xla' apply within {e16:.2e} of max of the "
        f"float32 apply; {A16._backend}")
    check(A16._backend == "xla" and e16 <= 0.03, "bf16-compute: the bf16 "
          f"apply within 0.03 of max of the float32 apply ({e16:.2e})")
    try:
        sumfac.make_local_laplacian_operator(
            ctx["ex"], Gf_r, ctx["Dhat"], None, device=dev, backend="fused",
            compute_dtype=torch.bfloat16)
        raised = False
    except ValueError as exc:
        raised = "compute_dtype" in str(exc)
    check(raised, "bf16-compute: backend='fused' with a compute_dtype "
          "raises ValueError")
    solves["bf16_apply_rel"] = e16

    # the precision tiers: the apply kernels (one RHS and a k-stack, both
    # meshes) give the same bits at every tier
    for pk in ("rect", "annulus"):
        prob_, ctx_ = problems[pk]
        Gf_ = prob_._G_host.reshape(E, 3, -1)
        U_ = randn(K).view(K, n, E)
        outs = {}
        for tier in ("highest", "high", "default"):
            op1 = sumfac.make_local_laplacian_operator(
                ctx_["ex"], Gf_, ctx_["Dhat"], None, device=dev,
                precision=tier)
            outs[tier] = (op1(U_[0]), op1.stacked(K)(U_))
        same = all(torch.equal(a_, b_) for t_ in ("high", "default")
                   for a_, b_ in zip(outs[t_], outs["highest"]))
        check(same and op1._backend == "fused", f"tiers ({pk}): the apply "
              "kernels at 'high' and 'default' are bit for bit 'highest'")
    solves["phase_3s_seconds"] = time.perf_counter() - t_3s
    log(f"  phase 3s took {solves['phase_3s_seconds']:.1f} s {at()}")
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # -- 3t. the 3D hexahedral path -------------------------------------------
    phase_3t(dev, at, drive, profile_solve, solves)
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # -- 3u. the squirmer and advection-diffusion -----------------------------
    phase_3u(dev, at, solves)
    (OUT / "chip_smoke_solves.json").write_text(json.dumps(solves, indent=1))

    # -- 4. manufactured solutions --------------------------------------------
    # 32x32 p=8: the f32 recurrence reaches tol=1e-7 there, and the error
    # bar is the reference's f32 bar (tests/test_cg_fused.py: 1e-4)
    mdisc = Discretization(rectangle_mesh(32, 32, ORDER), gll_basis_2d(ORDER))
    mprob = Poisson(mdisc, forcing=0.0, dtype=np.float32)
    mprob.set_dirichlet("ebc", lambda x, y: 0.1 * (x + y))
    mprob.set_neumann("nbc", 0.1)
    # and a curved one: u = ln r is harmonic in the plane; Dirichlet on the
    # two circles, natural on the symmetry axis (du/dn = 0 there)
    cdisc = Discretization(annulus_mesh(ORDER, **MMS_ANNULUS),
                           gll_basis_2d(ORDER))
    cprob = Poisson(cdisc, forcing=0.0, dtype=np.float32)
    for bnd in ("sphere", "shell"):
        cprob.set_dirichlet(bnd, lambda x, y: 0.5 * np.log(x * x + y * y))
    for label, mp, exact in (
            ("32x32 p=8, u = 0.1 (x + y)", mprob, lambda x, y: 0.1 * (x + y)),
            ("annulus 32x8 p=8, u = ln r", cprob,
             lambda x, y: 0.5 * np.log(x * x + y * y))):
        x, y = mp.x_nodes
        for name, kw in modes.items():
            sol = mp.solve_local(tol=1e-7, max_iter=MAX_ITER, **kw)
            err_max = float(np.abs(sol.u - exact(x, y)).max())
            err_l2 = mp.l2_error(sol.u, exact)
            log(f"[4] manufactured {label} {name}: "
                f"{int(sol.cg.iterations)} its, max err {err_max:.3e}, l2 "
                f"err {err_l2:.3e} {at()}")
            check(bool(sol.cg.converged) and err_l2 < 1e-4,
                  f"manufactured solution ({label}, {name}): l2 error "
                  "below 1e-4")

    # the reference's config-3 manufactured solution on its graded annulus
    # (tests/test_helmholtz.py), through the element-local kernel; the bar
    # is the reference's f32 bar for manufactured solutions (1e-4)
    hdisc = Discretization(annulus_mesh(ORDER, n_theta=32, n_r=8,
                                        r_outer=6.0, progression=1.2),
                           gll_basis_2d(ORDER))
    hm = Helmholtz(hdisc, forcing=helm_f, coefficient=helm_c,
                   reaction=helm_k, dtype=np.float32)
    hm.set_dirichlet("sphere", helm_u)
    hm.set_dirichlet("shell", helm_u)
    # the symmetry axis: outward normal (-1, 0), g = c n.grad u = -c u_x
    hm.set_neumann("symaxis",
                   lambda x, y: helm_c(x, y) * 2 * (x - 1.5) * helm_u(x, y))
    sol = hm.solve_local(tol=1e-6, max_iter=MAX_ITER, vector_layout="en",
                         backend="pallas")
    err_max = float(np.abs(sol.u - helm_u(*hm.x_nodes)).max())
    log(f"[4] manufactured Helmholtz, annulus 32x8 p=8 graded, en/pallas: "
        f"{int(sol.cg.iterations)} its, max err {err_max:.3e}, l2 err "
        f"{hm.l2_error(sol.u, helm_u):.3e} {at()}")
    check(bool(sol.cg.converged) and err_max < 1e-4,
          "manufactured Helmholtz solution: max nodal error below 1e-4")

    # -- 5. report ------------------------------------------------------------
    # launches per row: over the phase-3 solves that run the row's variant
    # (the applies: all solves; plain CG calls them every iteration, the
    # fused modes for their true-residual restarts and checks), at the
    # row's order: the p = 1 rows count the n = 4 launches (the pmg coarse
    # levels), the others the main n's
    row_launches = {}
    for r in rows:
        base, _, t = r["name"].partition("[")
        n_row = 4 if t == "p1]" else disc.n_loc
        row_launches[r["name"]] = sum(
            launches[m].get(base, {}).get(n_row, 0) for m in launches
            if t in ("", "p1]")
            or (m in all_modes and tag(all_modes[m][2]) == t[:-1]))
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
        if name in OFF_PATH:
            log(f"  {name}: {count} launches ({OFF_PATH[name]})")
            continue
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
