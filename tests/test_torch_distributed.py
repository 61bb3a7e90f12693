"""The port's element sharding with one rank per process, on the CPU: four
gloo ranks of ``scripts/torch_multicard.py`` against the JAX package's
sharded paths and the port's single-controller simulation.

One module fixture runs the worker once (4 processes, a ``file://`` store
in the test's directory, 120 s at most, a time-out fails) while the JAX
references are built here; every test reads its outputs.  The reference is
the float64 ``comm="shardmap"`` problem on ``device_mesh(4)``, 16 x 16 at
p = 3 (as ``test_torch_sharding.py`` builds it).  Bars: float64 Jacobi and
pmg the reference's iterations exactly and 1e-10 relative; float32
``shardmap-fused`` pmg (exact grid and padded Chebyshev coarse levels)
within 2 iterations and 1e-5 of the simulated path; the replicated-vector
operator 1e-12 of the simulated one and bit-identical across ranks; the
rolls exact; the 3D box the simulated path's iterations; one sharded
squirmer Newton step 1e-12 of the unsharded one.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

# the JAX package before torch: its import tunes glibc's malloc
# (utils/hostmem.py), which after torch's import slows every small torch op
import spectralelementmethod_tpu  # noqa: F401, I001
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.parallel import halo as jax_halo
from spectralelementmethod_tpu.parallel import sharding as jax_sh
from spectralelementmethod_tpu.solver.cg import cg as jax_cg

from spectralelementmethod_torch.basis import gll_basis_2d, gll_basis_3d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import (annulus_mesh, box_mesh,
                                              rectangle_mesh)
from spectralelementmethod_torch.models import squirmer as tsq
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.parallel import sharding as sh
from spectralelementmethod_torch.solver.cg import cg

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multicard.py")
RANKS = 4
TIMEOUT = 120
CPU = "cpu"


def _bc(x, y):
    return 0.2 * ((x + 1) + (y + 1))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _port(dtype):
    prob = Poisson(Discretization(rectangle_mesh(16, 16, 3),
                                  gll_basis_2d(3)), dtype=dtype)
    prob.set_dirichlet("ebc", _bc)
    return prob


@contextlib.contextmanager
def _jitted_reference_operator():
    """The reference's sharded operator under ``jax.jit`` (eagerly a
    ``shard_map`` compiles every primitive apart)."""
    orig = jax_halo.make_sharded_local_operator

    def jitted(*a, **kw):
        op = orig(*a, **kw)
        f = jax.jit(op)
        f._dss = op._dss
        return f

    jax_halo.make_sharded_local_operator = jitted
    try:
        yield
    finally:
        jax_halo.make_sharded_local_operator = orig


def _reference():
    """The reference's float64 comm="shardmap" solves on 4 shards: Jacobi
    and pmg CG to 1e-10 with ``dot=ex.dot_T``."""
    jprob = JaxPoisson(JaxDisc(jax_rect(16, 16, 3), jax_basis(3)),
                       dtype=np.float64)
    jprob.set_dirichlet("ebc", _bc)
    out = {}
    for name, pre in (("shardmap64", "jacobi"), ("pmg64", "pmg")):
        with _jitted_reference_operator():
            A, r, M, u_dL, ex, _ = jax_sh.sharded_local_poisson_problem(
                jprob, jax_sh.device_mesh(RANKS), comm="shardmap",
                precond=pre)
        res = jax_cg(A, r, M=M, tol=1e-10, max_iter=2000, dot=ex.dot_T)
        out[name] = (int(res.iterations), ex.global_from_local_T(
            np.asarray(u_dL + res.x)))
    return out


def _simulated(dtype, comm, precond, tol, weights=False):
    """The port's single-controller path on 4 simulated shards."""
    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
        _port(dtype), sh.device_mesh(RANKS, device=CPU), comm=comm,
        precond=precond)
    kw = (dict(dot_weight=ex._weights_as(r.dtype, CPU, transposed=True))
          if weights else dict(dot=ex.dot_T))
    res = cg(A, r, M=M, tol=tol, max_iter=5000, **kw)
    return int(res.iterations), ex.global_from_local_T(
        (u_dL + res.x).numpy().astype(np.float64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's four ranks (started first) and the references built
    while they run; the ranks' JSON records and arrays."""
    tmp = tmp_path_factory.mktemp("multicard")
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "--backend", "gloo", "--world-size",
         str(RANKS), "--rank", str(r), "--init-method",
         f"file://{tmp / 'store'}", "--size", "small", "--out", str(out),
         "--timeout", str(TIMEOUT)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(RANKS)]
    try:
        ref = _reference()
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(RANKS)]
    arrs = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    return dict(rec=recs, arr=arrs, ref=ref, logs=logs)


def _case(runs, name, key):
    """``key`` of case ``name`` on every rank, checked equal."""
    vals = [r["cases"][name][key] for r in runs["rec"]]
    assert all(v == vals[0] for v in vals), (name, key, vals)
    return vals[0]


def _array(runs, key):
    """Array ``key`` of every rank, checked bit-identical."""
    vals = [a[key] for a in runs["arr"]]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


def test_worker_ranks_ran_on_their_blocks_without_jax(runs):
    """Four gloo ranks on the CPU, one shard each, no failed check, and
    neither JAX nor the JAX package imported by the worker."""
    for r, rec in enumerate(runs["rec"]):
        assert (rec["rank"], rec["world"], rec["device"], rec["backend"]) \
            == (r, RANKS, CPU, "gloo")
        assert rec["failed"] == [] and rec["jax_loaded"] == []
    assert _case(runs, "shardmap64", "Ep") == 256
    assert _case(runs, "shardmap64", "block_E") == 64


@pytest.mark.parametrize("delta", [3, -3])
@pytest.mark.parametrize("wrap", [True, False])
def test_global_roll_across_ranks_is_exact(runs, delta, wrap):
    """Each rank's block shifted with its neighbours' strips: torch.roll
    over the whole, the wrapped lanes zero without wrap."""
    x = torch.as_tensor(runs["arr"][0]["roll_x"])
    want = torch.roll(x, -delta, dims=-1)
    if not wrap:
        if delta > 0:
            want[..., -delta:] = 0.0
        else:
            want[..., :-delta] = 0.0
    got = _array(runs, f"roll_{delta}_{int(wrap)}")
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("shift", [11, -17])
def test_block_roll_wider_than_a_block_is_exact(runs, shift):
    """A shift past the 8-element block: the pieces come from two ranks
    that are not both neighbours."""
    y = torch.as_tensor(runs["arr"][0]["roll_y"])
    got = _array(runs, f"block_roll_{shift}")
    np.testing.assert_array_equal(got, torch.roll(y, shift, dims=0).numpy())


@pytest.mark.parametrize("name", ["shardmap64", "pmg64"])
def test_float64_solves_match_the_reference(runs, name):
    """The reference's iterations exactly and its solution to 1e-10; the
    gathered solution and the reduced scalars bit-identical on every rank."""
    its_ref, u_ref = runs["ref"][name]
    assert _case(runs, name, "converged")
    assert _case(runs, name, "iterations") == its_ref
    assert _rel(_array(runs, f"{name}_u"), u_ref) < 1e-10
    _case(runs, name, "residual_hex")
    _case(runs, name, "rr_hex")


def test_sharded_pmg_levels_and_bit_identical_lmax(runs):
    """The V-cycle on the rank blocks: the exact lattice coarse solve (the
    gathered coarse vector, solved whole on every rank), levels (3, 1), and
    one lmax estimate on every rank, bit for bit."""
    assert _case(runs, "pmg64", "coarse_kind") == "fdm"
    assert _case(runs, "pmg64", "levels") == [3, 1]
    assert _case(runs, "pmg64", "coarse_backend") == "xla"
    _case(runs, "pmg64", "lmax_hex")
    assert _case(runs, "cheb32", "coarse_kind") == "chebyshev"
    assert _case(runs, "cheb32", "coarse_backend") == "fused"
    _case(runs, "cheb32", "lmax_hex")


@pytest.mark.parametrize("name,precond", [
    ("fused32", "pmg"), ("cheb32", {"pmg": {"coarse": "chebyshev"}})])
def test_float32_fused_pmg_matches_the_simulated_path(runs, name, precond):
    """The block kernel's plain version per rank (the fine level, and the
    p = 1 block apply of the padded Chebyshev coarse level): within 2
    iterations and 1e-5 of the single-controller path on 4 shards."""
    its_sim, u_sim = _simulated(np.float32, "shardmap-fused", precond, 1e-6,
                                weights=True)
    assert _case(runs, name, "converged")
    assert abs(_case(runs, name, "iterations") - its_sim) <= 2
    assert _rel(_array(runs, f"{name}_u"), u_sim) < 1e-5


def test_replicated_vector_operator_across_ranks(runs):
    """The ranks' full-length partials summed in rank order: A(u) the same
    bits on every rank and within 1e-12 of the simulated operator; Jacobi
    CG its iterations and solution (1e-12)."""
    prob = _port(np.float64)
    A, r, M, u_d, _ = sh.sharded_poisson_problem(
        prob, sh.device_mesh(RANKS, device=CPU))
    u = torch.as_tensor(np.random.RandomState(5).standard_normal(
        prob.disc.n_nodes))
    assert _rel(_array(runs, "replicated_Au"), A(u).numpy()) < 1e-12
    res = cg(A, r, M=M, tol=1e-10, max_iter=5000)
    assert _case(runs, "replicated", "iterations") == int(res.iterations)
    assert _rel(_array(runs, "replicated_u"), (u_d + res.x).numpy()) < 1e-12


def test_propagation_blocks_match_the_reference(runs):
    """``comm="propagation"``: the rank's (E / 4, n) rows through the halo
    operator, the reference's Jacobi iterations and solution (1e-10)."""
    its_ref, u_ref = runs["ref"]["shardmap64"]
    assert _case(runs, "propagation", "block_shape") == [64, 16]
    assert _case(runs, "propagation", "iterations") == its_ref
    assert _rel(_array(runs, "propagation_u"), u_ref) < 1e-10


def test_box3d_matches_the_simulated_path(runs):
    """A 3 x 3 x 3 box at p = 4 (E = 27 padded to 28, 7 per rank): the
    plane rolls by 9 elements reach past the neighbour; the simulated
    path's iterations and solution (1e-10)."""
    prob = Poisson(Discretization(box_mesh(3, 3, 3, 4), gll_basis_3d(4)),
                   dtype=np.float64)
    prob.set_dirichlet("ebc", lambda x, y, z: 0.1 * (x + y - z))
    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem_3d(
        prob, sh.device_mesh(RANKS, device=CPU))
    res = cg(A, r, M=M, tol=1e-10, max_iter=20000, dot=ex.dot)
    assert _case(runs, "box3d", "deltas") == [9, 3, 1]
    assert _case(runs, "box3d", "block_E") == 7
    assert _case(runs, "box3d", "iterations") == int(res.iterations)
    u = ex.global_from_local((u_dL + res.x).numpy())
    assert _rel(_array(runs, "box3d_u"), u) < 1e-10


def test_sharded_squirmer_step_matches_unsharded(runs):
    """E = 20 over 4 ranks, each computing its 5 elements' systems: one
    Newton step within 1e-12 of the unsharded model's, its force alike."""
    sq = tsq.Squirmer(annulus_mesh(order=4, n_theta=4, n_r=5, r_outer=10.0,
                                   progression=1.2), order=4, device=CPU)
    sq.set_initial_guess()
    sq.compute_operators(1.0)
    sq.set_boundary_conditions(speed=1.0, beta=1.0)
    sq.solve(it_max=1, tol=1e30, verbose=False)
    assert _case(runs, "squirmer", "Ep") == 20
    assert _rel(_array(runs, "squirmer_soln"), sq.soln) < 1e-12
    f = float.fromhex(_case(runs, "squirmer", "force_hex"))
    assert abs(f - sq.calc_force()) <= 1e-12 * abs(sq.calc_force())


def test_config5_pipeline_on_four_ranks(runs):
    """The config-5 pipeline at nx = 16 on 2 pseudo-slices of 2 ranks: the
    reference's 5 and 13 iterations, rank 0's single-device ladder agreeing
    to 1e-10 on every rank."""
    assert _case(runs, "config5", "slice_ids") == [0, 0, 1, 1]
    assert _case(runs, "config5", "coarse_kind") == "fdm"
    assert _case(runs, "config5", "its") == 5
    assert _case(runs, "config5", "its_weak") == 13
    assert _case(runs, "config5", "its_single") == 5
    assert _case(runs, "config5", "agreement") <= 1e-10


def test_device_mesh_without_a_group_refuses_several_cards(monkeypatch):
    """No process group and two visible cards: the meshes name the
    launcher instead of simulating both cards on one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for make in (sh.device_mesh, sh.hybrid_device_mesh):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            make()
    # a shard count still simulates the shards on the one device
    assert sh.device_mesh(4, device=CPU).size == 4
    assert sh.device_mesh(device=CPU).size == 1
