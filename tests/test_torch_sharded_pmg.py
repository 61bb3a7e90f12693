"""The rest of the port's element sharding against the JAX package's, on
the CPU: the hybrid mesh, the replicated-vector psum operator, the sharded
p-multigrid with its padded coarse level, the save / load / panel / hybrid
pipeline, ``Squirmer.shard_elements`` and the example.

The reference shards over its 8-device virtual CPU mesh (``conftest.py``);
its sharded operators run under ``jax.jit`` here (eagerly, a
``shard_map`` compiles every primitive apart: minutes).  One reference
problem per kind, cached at module scope.  Tolerances: operator applies,
right-hand sides and the padded V-cycle 1e-12 relative; float64 solves the
reference's iterations and 1e-10 relative; the sharded squirmer step
against the unsharded one 1e-12, against the reference's 1e-10.
"""

import contextlib
import functools
import os

import jax
import numpy as np
import pytest

# the JAX package before torch: its import tunes glibc's malloc
# (utils/hostmem.py), which after torch's import makes every small torch
# op here ~15x slower in a run of this file alone
import spectralelementmethod_tpu  # noqa: F401, I001
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.basis import gll_basis_3d as jax_basis_3d
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as jax_annulus
from spectralelementmethod_tpu.mesh import box_mesh as jax_box
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.mesh import gmsh as jax_gmsh
from spectralelementmethod_tpu.models import squirmer as jsq
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.parallel import halo as jax_halo
from spectralelementmethod_tpu.parallel import partition as jax_part
from spectralelementmethod_tpu.parallel import sharding as jax_sh
from spectralelementmethod_tpu.solver.cg import cg as jax_cg

from spectralelementmethod_torch.basis import gll_basis_2d, gll_basis_3d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import (annulus_mesh, box_mesh,
                                              rectangle_mesh)
from spectralelementmethod_torch.mesh import gmsh
from spectralelementmethod_torch.models import squirmer as tsq
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import sumfac
from spectralelementmethod_torch.parallel import halo, partition
from spectralelementmethod_torch.parallel import sharding as sh
from spectralelementmethod_torch.solver.cg import cg

torch.set_num_threads(2)
CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bc(x, y):
    return 0.2 * ((x + 1) + (y + 1))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _pair(nd, dtype=np.float64):
    """The same Dirichlet problem in both packages: a 12 x 10 rectangle at
    p = 4, or a 3 x 2 x 2 box at p = 3."""
    out = []
    for P, D, rect, box, b2, b3 in (
            (JaxPoisson, JaxDisc, jax_rect, jax_box, jax_basis,
             jax_basis_3d),
            (Poisson, Discretization, rectangle_mesh, box_mesh, gll_basis_2d,
             gll_basis_3d)):
        if nd == 2:
            prob = P(D(rect(12, 10, 4), b2(4)), dtype=dtype)
            prob.set_dirichlet("ebc", _bc)
        else:
            prob = P(D(box(3, 2, 2, 3), b3(3)), dtype=dtype)
            prob.set_dirichlet("ebc", lambda x, y, z: 0.1 * (x + y - z))
        out.append(prob)
    return tuple(out)


# -- the hybrid mesh -----------------------------------------------------------

def test_hybrid_device_mesh_matches_the_reference():
    """Two contiguous pseudo-slices of 8 shards, the reference's ids; an
    uneven split raises as the reference's does; ``devices`` names the
    shard count or the (one) device of each shard."""
    ref = jax_sh.hybrid_device_mesh(n_slices=2)
    port = sh.hybrid_device_mesh(n_slices=2, devices=8, device=CPU)
    assert port.shard_slice_ids == ref.shard_slice_ids == (0,) * 4 + (1,) * 4
    assert port.size == ref.devices.size == 8
    for make in (lambda: jax_sh.hybrid_device_mesh(n_slices=3),
                 lambda: sh.hybrid_device_mesh(n_slices=3, devices=8,
                                               device=CPU)):
        with pytest.raises(ValueError, match="pseudo-slices"):
            make()
    assert sh.hybrid_device_mesh(devices=[CPU] * 3, device=CPU) == \
        sh.DeviceMesh(3, torch.device(CPU), sh.ELEM_AXIS, (0, 0, 0))
    with pytest.raises(ValueError, match="one device"):
        sh.hybrid_device_mesh(devices=["meta", CPU], device=CPU)


# -- the replicated-vector operator --------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_replicated(nd, S):
    """The reference's sharded_poisson_problem on S of the 8 virtual
    devices: its operator jitted, A(u) of a seeded u, r, M(r), u_d."""
    jprob, _ = _pair(nd)
    A, r, M, u_d, _mesh = jax_sh.sharded_poisson_problem(
        jprob, jax_sh.device_mesh(S))
    u = np.random.RandomState(S).standard_normal(jprob.disc.n_nodes)
    Aj = jax.jit(A)
    return dict(A=Aj, Au=np.asarray(Aj(u)), u=u, r=np.asarray(r),
                Mr=np.asarray(M(r)), u_d=np.asarray(u_d), M=M)


@pytest.mark.parametrize("nd,S", [(2, 4), (2, 3), (3, 3), (3, 8)])
def test_replicated_vector_operator_matches_the_reference(nd, S):
    """``make_sharded_poisson_operator`` through ``sharded_poisson_problem``
    (2D, and 3D with ``D2``; S = 8 pads the box's 12 elements to 16): A(u),
    r, M(r) and the Dirichlet lift against the reference's, 1e-12."""
    ref = _ref_replicated(nd, S)
    _, port = _pair(nd)
    A, r, M, u_d, mesh = sh.sharded_poisson_problem(
        port, sh.device_mesh(S, device=CPU))
    assert mesh.size == S
    assert _rel(A(torch.as_tensor(ref["u"])).numpy(), ref["Au"]) < 1e-12
    assert _rel(r.numpy(), ref["r"]) < 1e-12
    assert _rel(M(r).numpy(), ref["Mr"]) < 1e-12
    np.testing.assert_array_equal(u_d.numpy(), ref["u_d"])


def test_replicated_vector_operator_arrays_and_refusals():
    """The operator on arrays padded and placed by hand (the reference's
    test's calls) equals the problem's; an unpadded element axis that does
    not split raises."""
    _, port = _pair(2)
    mesh = sh.device_mesh(8, device=CPU)
    gix, G = sh.pad_element_arrays(port.disc.gather_nodes, port._G_host,
                                   n_shards=8)
    gix, G = sh.shard_element_arrays(mesh, gix, G)
    (free,) = sh.replicated(mesh, ~port._dirichlet_mask)
    assert G.shape[0] == 120 and gix.device == torch.device(CPU)
    A = sh.make_sharded_poisson_operator(
        mesh, gix, G, port._D0_host, port._D1_host, port.disc.n_nodes, free)
    A1 = sh.sharded_poisson_problem(port, mesh)[0]
    u = torch.as_tensor(np.random.RandomState(2).standard_normal(
        port.disc.n_nodes))
    assert torch.equal(A(u), A1(u))
    with pytest.raises(ValueError, match="pad"):
        sh.shard_element_arrays(sh.device_mesh(7, device=CPU),
                                port.disc.gather_nodes)


@pytest.mark.parametrize("S", [4, 3])
def test_replicated_vector_jacobi_cg_matches_the_reference(S):
    """Jacobi CG on the replicated-vector operator: the reference's
    iterations (its S = 4 solve) and its solution to 1e-10."""
    its_ref, u_ref = _ref_replicated_solve()
    _, port = _pair(2)
    A, r, M, u_d, _ = sh.sharded_poisson_problem(
        port, sh.device_mesh(S, device=CPU))
    res = cg(A, r, M=M, tol=1e-10, max_iter=2000)
    assert bool(res.converged) and int(res.iterations) == its_ref
    assert _rel((u_d + res.x).numpy(), u_ref) < 1e-10


@functools.lru_cache(maxsize=None)
def _ref_replicated_solve():
    ref = _ref_replicated(2, 4)
    res = jax_cg(ref["A"], ref["r"], M=ref["M"], tol=1e-10, max_iter=2000)
    return int(res.iterations), ref["u_d"] + np.asarray(res.x)


# -- the sharded p-multigrid and the config-5 pipeline -------------------------

@contextlib.contextmanager
def _jitted_reference_operator():
    """The reference's sharded (n, E) operator under ``jax.jit`` while the
    block runs (its setup applies it once, eagerly a compile per
    primitive)."""
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


# TestShardedPmg's size (12 x 10, p = 4, float64, 8 shards) through the
# config-5 pipeline: save_msh -> load_msh -> panel order (panel = 1: the
# element order transposed, its offsets +-1 and +-12 within the 15-element
# shard blocks) -> 2 pseudo-slices of 4 shards -> sharded pmg (its default
# degree: the config-5 script's 7 compiles the reference's cycle for
# minutes here) -> CG to 1e-10, the config-5 script's oscillatory problem
# (k1 = 4, k2 = 8).  One reference problem serves every case below.
NX_P, NY_P, P_P, PANEL, PIPE_SHARDS = 12, 10, 4, 1, 8


def _pipeline(pkg, tmp):
    """The pipeline in package ``pkg``: its problem, mesh, permutation,
    sharded pmg and solve (the reference's operator and V-cycle jitted)."""
    if pkg == "jax":
        rect, io, part, D, B, P = (jax_rect, jax_gmsh, jax_part, JaxDisc,
                                   jax_basis, JaxPoisson)
    else:
        rect, io, part, D, B, P = (rectangle_mesh, gmsh, partition,
                                   Discretization, gll_basis_2d, Poisson)
    path = os.path.join(str(tmp), f"{pkg}.msh")
    mesh0 = rect(NX_P, NY_P, P_P)
    io.save_msh(mesh0, path, binary=True)
    loaded = io.load_msh(path)
    perm = part.panel_order(n_fast=NY_P, n_slow=NX_P, panel=PANEL)
    mesh = part.reorder_elements(loaded, perm)
    k1, k2 = 4, 8
    prob = P(D(mesh, B(P_P)), forcing=lambda x, y: (
        np.sin(k1 * np.pi * x) * np.cos((k1 - 1) * np.pi * y)
        + 0.3 * np.sin((k2 + 1) * np.pi * x) * np.sin(k2 * np.pi * y)),
        dtype=np.float64)
    prob.set_dirichlet("ebc",
                       lambda x, y: 0.1 * np.sin(3 * np.pi * (x + 0.7 * y)))
    kw = dict(comm="shardmap", precond="pmg")
    out = dict(prob=prob, mesh0=mesh0, loaded=loaded, perm=perm)
    if pkg == "jax":
        hyb = jax_sh.hybrid_device_mesh(
            n_slices=2, devices=jax.devices()[:PIPE_SHARDS])
        with _jitted_reference_operator():
            A, r, M, u_dL, ex, _ = jax_sh.sharded_local_poisson_problem(
                prob, hyb, **kw)
        w = ex._weights_as(np.float64, transposed=True)
        res = jax_cg(A, r, M=M, tol=1e-10, max_iter=100, dot_weight=w,
                     block=100)
        x = np.asarray(u_dL + res.x)
        v = _residual_like(np.asarray(r))
        out.update(v=v, Mv=np.asarray(jax.jit(M)(v)))
    else:
        hyb = sh.hybrid_device_mesh(n_slices=2, devices=PIPE_SHARDS,
                                    device=CPU)
        A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
            prob, hyb, **kw)
        w = ex._weights_as(np.float64, CPU, transposed=True)
        res = cg(A, r, M=M, tol=1e-10, max_iter=100, dot_weight=w,
                 block=100)
        x = (u_dL + res.x).numpy()
        out.update(A=A, r=r, res=res, w=w, u_dL=u_dL)
    out.update(hyb=hyb, M=M, ex=ex, its=int(res.iterations),
               conv=bool(res.converged), u=ex.global_from_local_T(x))
    return out


def _residual_like(r):
    """A seeded vector zero where ``r`` is masked (pads, Dirichlet)."""
    v = np.random.RandomState(11).standard_normal(r.shape)
    return np.where(r != 0.0, v, 0.0)


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return {pkg: _pipeline(pkg, tmp) for pkg in ("jax", "torch")}


def test_sharded_pmg_matches_the_reference(pipe):
    """The sharded pmg through both packages: the same iterations,
    solutions to 1e-10, the exact lattice coarse solve and the levels
    (4, 1); the pads, if any, stay zero."""
    ref, port = pipe["jax"], pipe["torch"]
    assert ref["conv"] and port["conv"] and port["its"] == ref["its"]
    assert _rel(port["u"], ref["u"]) < 1e-10
    M = port["M"]
    assert (M._coarse_kind, M._levels) == (ref["M"]._coarse_kind,
                                           ref["M"]._levels) == ("fdm", (4, 1))
    E = port["prob"].disc.E
    assert port["ex"].E == ref["ex"].E
    assert not bool(port["res"].x[:, E:].any())


def test_padded_vcycle_matches_the_reference(pipe):
    """The V-cycle of ``make_pmg_preconditioner(coarse_pad_to=Ep)`` (the
    sharded problem's M, its pads zeroed) on a seeded residual: the
    reference's to 1e-12, in float64 on the "xla" coarse operator."""
    ref, port = pipe["jax"], pipe["torch"]
    M = port["M"]
    z = M(torch.as_tensor(ref["v"]))
    assert _rel(z.numpy(), ref["Mv"]) < 1e-12
    cyc = M._pmg
    assert cyc._A_c._backend == "xla" and cyc._cycle_dtype == np.float64
    assert cyc._ops["coarse"] is cyc._A_c
    assert cyc._A_c.E == port["ex"].E


def test_config5_pipeline_matches_the_reference(pipe):
    """The pipeline's stages: the mesh read back equals the written one and
    the reference's read, the panel permutation and the pseudo-slice ids
    are the reference's, and the sharded solve agrees with the single-
    device ladder (the unsharded "xla" operator with the same M: the same
    iterations, 1e-10), as the config-5 script checks."""
    ref, port = pipe["jax"], pipe["torch"]
    for a, b in ((port["loaded"], port["mesh0"]),
                 (port["loaded"], ref["loaded"])):
        np.testing.assert_array_equal(a.nodes, b.nodes)
        for x, y in zip(a.cell_blocks(), b.cell_blocks(), strict=True):
            np.testing.assert_array_equal(x[1], y[1])
            np.testing.assert_array_equal(x[2], y[2])
        assert a.boundary_names == b.boundary_names
        for name in a.boundary_names:
            np.testing.assert_array_equal(a.boundary_faces(name),
                                          b.boundary_faces(name))
    np.testing.assert_array_equal(port["perm"], ref["perm"])
    assert port["hyb"].shard_slice_ids == ref["hyb"].shard_slice_ids == \
        (0,) * 4 + (1,) * 4
    prob, ex = port["prob"], port["ex"]
    disc = prob.disc
    free = (~prob._dirichlet_mask)[ex.gather_hier]
    A1 = sumfac.make_local_laplacian_operator(
        ex, prob._G_host.reshape(disc.E, 3, -1),
        sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host),
        torch.as_tensor(np.ascontiguousarray(free.T)), device=CPU,
        vector_layout="ne", backend="xla")
    res1 = cg(A1, port["r"], M=port["M"], tol=1e-10, max_iter=100,
              dot_weight=port["w"], block=100)
    u1 = ex.global_from_local_T((port["u_dL"] + res1.x).numpy())
    assert int(res1.iterations) == port["its"]
    assert _rel(port["u"], u1) < 1e-10


def test_hybrid_mesh_keeps_the_wrap_elision(pipe):
    """The panel-ordered mesh's classes never wrap: on the hybrid mesh every
    roll class of the halo DSS elides the ring's wrap pair, and the float64
    pmg solve equals the plain 8-shard mesh's bit for bit (the slices
    change no copy)."""
    port = pipe["torch"]
    tdss = halo.make_halo_dss_T(port["ex"], n_shards=port["hyb"].size)
    assert not any(tdss._edge_wrap) and not any(tdss._vert_wrap)
    A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
        port["prob"], sh.device_mesh(PIPE_SHARDS, device=CPU),
        comm="shardmap", precond="pmg")
    res = cg(A, r, M=M, tol=1e-10, max_iter=100, dot_weight=port["w"],
             block=100)
    assert int(res.iterations) == port["its"]
    assert torch.equal(res.x, port["res"].x)


def test_sharded_pmg_refusals():
    """``comm="propagation"`` raises the reference's "transposed" error
    (the reference raises it only after its whole setup, ~3 s here, so its
    own tests hold its side); an unknown precond raises."""
    prob = _pair(2)[1]
    mesh = sh.device_mesh(8, device=CPU)
    with pytest.raises(ValueError, match="requires a transposed comm"):
        sh.sharded_local_poisson_problem(prob, mesh, comm="propagation",
                                         precond="pmg")
    with pytest.raises(ValueError, match="precond"):
        sh.sharded_local_poisson_problem(prob, mesh, comm="shardmap",
                                         precond="amg")


def test_shardmap_fused_pmg_matches_shardmap():
    """``comm="shardmap-fused"`` in float32 (16 x 8, p = 3, 4 shards): the
    V-cycle's fine applies are the block kernels (their plain versions
    here); the solve takes the ``"shardmap"`` pmg's iterations and agrees
    to float32 accuracy."""
    prob = Poisson(Discretization(rectangle_mesh(16, 8, 3), gll_basis_2d(3)),
                   dtype=np.float32)
    prob.set_dirichlet("ebc", _bc)
    mesh = sh.device_mesh(4, device=CPU)
    out = {}
    for comm in ("shardmap", "shardmap-fused"):
        A, r, M, u_dL, ex, _ = sh.sharded_local_poisson_problem(
            prob, mesh, comm=comm, precond="pmg")
        w = ex._weights_as(np.float32, CPU, transposed=True)
        res = cg(A, r, M=M, tol=1e-6, max_iter=400, dot_weight=w)
        assert bool(res.converged)
        out[comm] = (int(res.iterations),
                     ex.global_from_local_T((u_dL + res.x).numpy()), M)
    assert out["shardmap"][0] == out["shardmap-fused"][0]
    # float32 solves to 1e-6: the two agree to 1e-4 of max
    assert _rel(out["shardmap-fused"][1], out["shardmap"][1]) < 1e-4
    cyc = out["shardmap-fused"][2]._pmg
    assert cyc._A_f is A and cyc._ops["fine"] is A
    assert cyc._A_c._backend == "fused"
    assert out["shardmap"][2]._pmg._ops["fine"]._backend == "fused"


# -- Squirmer.shard_elements ---------------------------------------------------

SQ_MESH = dict(order=4, n_theta=4, n_r=5, r_outer=10.0, progression=1.2)


def _squirmer(pkg, shards=None):
    ann, S = ((jax_annulus, jsq.Squirmer) if pkg == "jax"
              else (annulus_mesh, tsq.Squirmer))
    kw = {} if pkg == "jax" else dict(device=CPU)
    sq = S(ann(**SQ_MESH), order=4, **kw)
    if shards:
        sq.shard_elements(sh.device_mesh(shards, device=CPU))
    sq.set_initial_guess()
    sq.compute_operators(1.0)
    sq.set_boundary_conditions(speed=1.0, beta=1.0)
    # one Newton step (its update is below any tolerance this size)
    sq.solve(it_max=1, tol=1e30, verbose=False)
    return sq


def test_shard_elements_step_matches_unsharded_and_reference():
    """E = 20 over 3 shards (padded to 21 by repeating element 0): the
    element systems and one Newton step equal the unsharded port's to
    1e-12, and the reference's unsharded step to 1e-10; ``calc_force``
    alike."""
    sharded = _squirmer("torch", 3)
    plain = _squirmer("torch")
    ref = _squirmer("jax")
    assert sharded._Grho.shape[0] == 21
    inputs = sharded._newton_inputs()
    for a, b in zip(sharded._local_systems(inputs[0], inputs[1], inputs[3]),
                    plain._local_systems(inputs[0], inputs[1], inputs[3])):
        assert a.shape[0] == 20 and float((a - b).abs().max()) <= \
            1e-12 * float(b.abs().max())
    assert _rel(sharded.soln, plain.soln) < 1e-12
    assert _rel(sharded.soln, ref.soln) < 1e-10
    f_s, f_p, f_r = (m.calc_force() for m in (sharded, plain, ref))
    assert abs(f_s - f_p) <= 1e-12 * abs(f_p)
    assert abs(f_s - f_r) <= 1e-10 * abs(f_r)


# -- the example ---------------------------------------------------------------

def test_sharded_poisson_example_runs_on_the_cpu():
    import importlib.util

    path = os.path.join(REPO, "examples", "torch_sharded_poisson.py")
    spec = importlib.util.spec_from_file_location("torch_sharded_poisson",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for extra in ([], ["--comm", "shardmap-fused"]):
        out = mod.main(["--nx", "6", "--order", "3", "--tol", "1e-5",
                        "--devices", "3", "--device", "cpu", *extra])
        assert out["converged"] and out["l2_error"] < 1e-3
