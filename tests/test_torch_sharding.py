"""The PyTorch port's element-sharded L-vector Poisson path and far-class
split against the JAX package's, on the CPU.

The reference shards over its 8-device virtual CPU mesh (``conftest.py``);
the port runs its shards as column blocks of one tensor.  Small meshes:
``rectangle_mesh(16, 16, 3)`` (E = 256, widest class offset 17) and
32x16 at p = 2 (E = 512, the far-forcing setup of ``test_cg_fused.py``).

* the padded exchange's tables, weights and class-mask stack;
* ``make_halo_dss_T`` and ``make_sharded_local_operator`` in float64
  (1e-12), the block kernel's plain version against the reference's
  interpret-mode block kernel and the sharded fused operator (1e-5 of max,
  the bar of ``test_sharding.py``);
* solves: float64 ``comm="shardmap"`` (the reference's iterations exactly,
  1e-10), float32 ``"shardmap-fused"`` (2 iterations, 5e-4 of the
  single-device solution), ``"propagation"``;
* the far split of the affine and the general apply against the
  reference's ``far_mode="kernel"`` interpret-mode applies (1e-5 of max),
  and split against unsplit, the split operator's fused CG kernels too;
* the raises and the two deliberate divergences (8 shards of 16x16 p = 3
  run where the reference raises; ``max_halo="auto"`` does not split).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import exchange as jax_exchange
from spectralelementmethod_tpu.ops import pallas_kernels as pk
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.parallel import halo as jax_halo
from spectralelementmethod_tpu.parallel import sharding as jax_sh
from spectralelementmethod_tpu.solver.cg import cg as jax_cg
from spectralelementmethod_tpu.solver.cg import (
    jacobi_preconditioner as jax_jacobi)

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import (
    sharded_fused_operator_from_numpy)
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import exchange, kernels, sumfac
from spectralelementmethod_torch.parallel import halo
from spectralelementmethod_torch.parallel import sharding as sh
from spectralelementmethod_torch.solver.cg import cg

torch.set_num_threads(2)


def _bc(x, y):
    return 0.2 * ((x + 1) + (y + 1))


@functools.lru_cache(maxsize=None)
def _pair(dtype, nx=16, ny=16, p=3, coefficient=None):
    """The same Dirichlet problem in both packages (one per module and
    configuration)."""
    out = []
    for Pn, D, rect, basis in ((JaxPoisson, JaxDisc, jax_rect, jax_basis),
                               (Poisson, Discretization, rectangle_mesh,
                                gll_basis_2d)):
        prob = Pn(D(rect(nx, ny, p), basis(p)), coefficient=coefficient,
                  dtype=dtype)
        prob.set_dirichlet("ebc", _bc)
        out.append(prob)
    return tuple(out)


def _affine_tables(jprob, ex):
    """(Gf, Dhat, a, Kcat) of the reference problem on exchange ``ex``."""
    disc = jprob.disc
    Gf = np.asarray(jprob._G_host).reshape(disc.E, 3, -1)
    Gf = np.concatenate([Gf, np.zeros((ex.E - disc.E,) + Gf.shape[1:],
                                      Gf.dtype)])
    Dhat = jax_sumfac.make_stacked_derivative(
        np.asarray(jprob._D0), np.asarray(jprob._D1))
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = jax_sumfac.affine_factorization(Gf, W)
    Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    return Gf, Dhat, (a if exact else None), Kcat


def _classes(ex):
    """The reference exchange's class tables without their masks."""
    return ([(d, s, int(dl), bool(f)) for d, s, dl, f, _m
             in ex.edge_classes],
            [(d, s, int(dl)) for d, s, dl, _m in ex.vert_classes])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# -- exchange, halo DSS, local operator ---------------------------------------

def test_padded_exchange_matches_reference():
    jprob, tprob = _pair(np.float64)
    Ep = jprob.disc.E + 8
    ej = jax_exchange.make_exchange(jprob.disc, pad_to=Ep)
    et = exchange.make_exchange(tprob.disc, pad_to=Ep)
    assert type(ej).__name__ == type(et).__name__ == "RollExchange"
    assert (et.E, et.E_real) == (ej.E, ej.E_real) == (Ep, jprob.disc.E)
    np.testing.assert_array_equal(et.gather_hier, ej.gather_hier)
    np.testing.assert_allclose(et.weights, np.asarray(ej.weights),
                               atol=1e-12)
    assert not et.weights[jprob.disc.E:].any()
    assert _classes(et) == _classes(ej)
    mt, mj = halo.stack_class_masks(et), jax_halo.stack_class_masks(ej)
    np.testing.assert_array_equal(mt, mj)
    assert not mt[:, jprob.disc.E:].any()
    # DSS and dot of the same padded L-vector
    v = np.random.RandomState(0).standard_normal((Ep, et.n_loc))
    v[jprob.disc.E:] = 0.0
    np.testing.assert_allclose(
        et.dss_T(torch.as_tensor(v.T)).numpy().T,
        np.asarray(ej.dss_T(jnp.asarray(v.T))).T, atol=1e-12)
    np.testing.assert_allclose(et.dss(torch.as_tensor(v)).numpy(),
                               np.asarray(ej.dss(jnp.asarray(v))),
                               atol=1e-12)
    assert abs(float(et.dot_T(torch.as_tensor(v.T), torch.as_tensor(v.T)))
               - float(ej.dot_T(jnp.asarray(v.T), jnp.asarray(v.T)))) < 1e-10


def test_halo_dss_and_sharded_local_operator_match_reference():
    """4 shards against the reference's ppermute ring (float64, 1e-12),
    and 1, 2 and 4 shards against the port's unsharded DSS and apply."""
    jprob, tprob = _pair(np.float64)
    ej = jax_exchange.make_exchange(jprob.disc, pad_to=jprob.disc.E)
    et = exchange.make_exchange(tprob.disc)
    Gf, Dhat, _a, _K = _affine_tables(jprob, ej)
    free = (~jprob._dirichlet_mask)[ej.gather_hier].T
    uT = np.random.RandomState(4).standard_normal((et.n_loc, et.E))
    u_t = torch.as_tensor(uT)
    masks = torch.as_tensor(halo.stack_class_masks(et))

    jmesh = jax_sh.device_mesh(4)
    dss_j = jax_halo.make_halo_dss_T(ej, jax_sh.ELEM_AXIS, 4)
    f = jax.jit(jax.shard_map(dss_j, mesh=jmesh,
                              in_specs=(P(None, jax_sh.ELEM_AXIS),) * 2,
                              out_specs=P(None, jax_sh.ELEM_AXIS)))
    want_dss = np.asarray(f(jnp.asarray(uT),
                            jnp.asarray(jax_halo.stack_class_masks(ej))))
    Aj = jax_halo.make_sharded_local_operator(
        ej, Gf, Dhat, jmesh, free_local=jnp.asarray(free))
    want_A = np.asarray(jax.jit(Aj)(jnp.asarray(uT)))
    A_glob = sumfac.make_local_laplacian_operator(
        et, Gf, Dhat, free, device="cpu", structure="general")
    for S in (1, 2, 4):
        dss_t = halo.make_halo_dss_T(et, halo.ELEM_AXIS, S)
        got = dss_t(u_t, masks).numpy()
        np.testing.assert_allclose(got, want_dss, atol=1e-12)
        np.testing.assert_allclose(got, et.dss_T(u_t).numpy(), atol=1e-12)
        # a rectangle's element order never wraps: every wrap pair elided
        assert not any(dss_t._edge_wrap) and not any(dss_t._vert_wrap)
        At = halo.make_sharded_local_operator(
            et, Gf, Dhat, sh.device_mesh(S, device="cpu"), free_local=free)
        got_A = At(u_t).numpy()
        np.testing.assert_allclose(got_A, want_A, atol=1e-12)
        np.testing.assert_allclose(got_A, A_glob(u_t).numpy(), atol=1e-12)


@pytest.mark.parametrize("delta", [3, -3])
def test_global_roll_is_roll_over_the_ring(delta):
    """wrap=True reproduces torch.roll over the shards; wrap=False
    zero-fills exactly the wrapped lanes (the reference's test of its
    ppermute ring, ``test_sharding.py``)."""
    x = torch.arange(32, dtype=torch.float64)[None, :] + 1.0
    for wrap in (True, False):
        got = halo.global_roll(x, delta, halo.ELEM_AXIS, 8, wrap=wrap)
        want = torch.roll(x, -delta, dims=-1)
        if not wrap:
            if delta > 0:
                want[..., -delta:] = 0.0
            else:
                want[..., :-delta] = 0.0
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="per-shard block"):
        halo.global_roll(x, 4, halo.ELEM_AXIS, 8)
    m = np.zeros(16, bool)
    assert not halo._class_uses_wrap(m, 3)
    m[15] = True
    assert halo._class_uses_wrap(m, 3) and not halo._class_uses_wrap(m, -3)


# -- the block kernel and the sharded fused operator --------------------------

def test_block_kernel_plain_matches_reference_interpret():
    """The same halo-extended inputs (the reference's Hpad = 128 extension of
    shard 0 of 2) through the reference's interpret-mode block kernel and
    the port's plain version; compared where every class's source lies in
    the block (the reference clamps its border tiles, the port counts
    outside sources as zero), which covers the shard's centre."""
    jprob, _ = _pair(np.float32)
    ej = jax_exchange.RollExchange(jprob.disc)
    _Gf, _D, a, Kcat = _affine_tables(jprob, ej)
    S, E, n = 2, ej.E, ej.n_loc
    Eb, Hpad = E // S, 128
    H = max(abs(c[2]) for c in ej.edge_classes + ej.vert_classes)
    Eext = Eb + 2 * Hpad
    blk_j = pk.make_fused_affine_block_kernel(
        jax_halo._BlockExchangeView(ej, Eext), Kcat, interpret=True)
    idx = np.arange(-Hpad, Eb + Hpad) % E
    rng = np.random.RandomState(5)
    u_ext = rng.standard_normal((n, Eext)).astype(np.float32)
    a_ext = np.ascontiguousarray(a.T[:, idx]).astype(np.float32)
    M_ext = jax_halo.stack_class_masks(ej)[:, idx]
    want = np.asarray(blk_j(jnp.asarray(u_ext), jnp.asarray(a_ext),
                            jnp.asarray(M_ext.astype(np.float32))))
    ecl, vcl = _classes(ej)
    A = sharded_fused_operator_from_numpy(
        Kcat, a, jax_halo.stack_class_masks(ej), ecl, vcl,
        sh.device_mesh(S, device="cpu"))
    Kst = A._block_operands[0]
    plan = A._block_plan.block_view(Eext)
    got = kernels.affine_block_apply_dss(
        torch.as_tensor(u_ext), Kst, torch.as_tensor(a_ext),
        torch.as_tensor(M_ext), plan).numpy()
    assert H <= Hpad
    inner = slice(H, Eext - H)
    assert _rel(got[:, inner], want[:, inner]) < 1e-5


@pytest.mark.parametrize("S", [1, 2])
def test_sharded_fused_operator_matches_reference(S):
    jprob, tprob = _pair(np.float32)
    ej = jax_exchange.RollExchange(jprob.disc)
    _Gf, _D, a, Kcat = _affine_tables(jprob, ej)
    rng = np.random.RandomState(3)
    uT = rng.standard_normal((ej.n_loc, ej.E)).astype(np.float32)
    Aj = jax_halo.make_sharded_fused_operator(
        ej, Kcat, a, jax_sh.device_mesh(S), interpret=True)
    want = np.asarray(jax.jit(Aj)(jnp.asarray(uT)))
    ecl, vcl = _classes(ej)
    tmesh = sh.device_mesh(S, device="cpu")
    At = sharded_fused_operator_from_numpy(
        Kcat, a, jax_halo.stack_class_masks(ej), ecl, vcl, tmesh)
    got = At(torch.as_tensor(uT)).numpy()
    assert _rel(got, want) < 1e-5
    # the port's own tables: the assembled centres equal the global apply
    et = exchange.make_exchange(tprob.disc)
    Gf = tprob._G_host.reshape(tprob.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(tprob._D0_host, tprob._D1_host)
    W = tprob.disc.basis.weight_grid().reshape(-1)
    a_t, _ = sumfac.affine_factorization(Gf, W)
    A_own = halo.make_sharded_fused_operator(
        et, sumfac.make_affine_element_matrices(Dhat, W, order=et.hier), a_t,
        tmesh)
    A_glob = sumfac.make_local_laplacian_operator(et, Gf, Dhat, device="cpu")
    assert _rel(A_own(torch.as_tensor(uT)), A_glob(torch.as_tensor(uT))) \
        < 1e-6


# -- solves -------------------------------------------------------------------

def _jax_shardmap_solve(jprob, S, tol):
    """The reference's ``sharded_local_poisson_problem(comm="shardmap")``
    and ``cg(..., dot=ex.dot_T)``, its setup written out with the two
    operators under ``jax.jit``: called eagerly, its shard_map apply
    dispatches every primitive on its own (~30 s for the lift here)."""
    disc = jprob.disc
    ej = jax_exchange.make_exchange(disc, pad_to=jax_sh.pad_elements(
        disc.E, S))
    Gf, Dhat, _a, _K = _affine_tables(jprob, ej)
    free = np.zeros((ej.E, disc.n_loc), bool)
    free[:disc.E] = (~jprob._dirichlet_mask)[ej.gather_hier[:disc.E]]
    free = jnp.asarray(np.ascontiguousarray(free.T))
    b = np.asarray(jprob._b) + jprob._neumann
    u_d = np.where(jprob._dirichlet_mask, jprob._dirichlet_vals, 0.0)
    bT, u_dT, diagT = (jnp.asarray(np.ascontiguousarray(
        ej.local_from_global(np.asarray(v)).T))
        for v in (b, u_d, jprob.operator_diagonal()))
    mesh = jax_sh.device_mesh(S)
    A = jax.jit(jax_halo.make_sharded_local_operator(
        ej, Gf, Dhat, mesh, free_local=free))
    A_raw = jax.jit(jax_halo.make_sharded_local_operator(ej, Gf, Dhat, mesh))
    r = jnp.where(free, bT - A_raw(u_dT), 0.0)
    M = jax_jacobi(diagT, free)
    res = jax_cg(A, r, M=M, tol=tol, max_iter=2000, dot=ej.dot_T)
    return int(res.iterations), res.issued, ej.global_from_local_T(
        np.asarray(u_dT + res.x))


def _port_sharded_solve(tprob, S, comm, tol):
    A, r, M, u_dL, ex, mesh = sh.sharded_local_poisson_problem(
        tprob, sh.device_mesh(S, device="cpu"), comm=comm)
    assert mesh.size == S and ex.E % S == 0
    transposed = comm != "propagation"
    res = cg(A, r, M=M, tol=tol, max_iter=2000,
             dot=ex.dot_T if transposed else ex.dot)
    assert bool(res.converged)
    conv = ex.global_from_local_T if transposed else ex.global_from_local
    return int(res.iterations), res.issued, conv((u_dL + res.x).numpy())


def test_shardmap_solve_float64_matches_reference():
    """4 shards: the reference's iterations exactly and its solution to
    1e-10; 2 shards and the propagation comm give the port's same solve."""
    jprob, tprob = _pair(np.float64)
    its_j, issued_j, u_j = _jax_shardmap_solve(jprob, 4, 1e-10)
    its, issued, u = _port_sharded_solve(tprob, 4, "shardmap", 1e-10)
    assert (its, issued) == (its_j, issued_j)
    np.testing.assert_allclose(u, u_j, atol=1e-10)
    for S, comm in ((2, "shardmap"), (4, "propagation")):
        its2, _, u2 = _port_sharded_solve(tprob, S, comm, 1e-10)
        assert its2 == its_j, (S, comm)
        np.testing.assert_allclose(u2, u_j, atol=1e-10)


def test_propagation_operator_matches_reference():
    """comm="propagation": the reference's (E, n) operator on its padded
    exchange, the lift and the preconditioned residual, 1e-12."""
    jprob, tprob = _pair(np.float64, 5, 3, 4)      # E = 15: padded to 16
    A_j, r_j, M_j, u_j, ex_j, _ = jax_sh.sharded_local_poisson_problem(
        jprob, jax_sh.device_mesh(8))
    A_t, r_t, M_t, u_t, ex_t, _ = sh.sharded_local_poisson_problem(
        tprob, sh.device_mesh(8, device="cpu"))
    assert ex_t.E == ex_j.E == 16
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-12)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-12)
    np.testing.assert_allclose(A_t(r_t).numpy(),
                               np.asarray(jax.jit(A_j)(r_j)), atol=1e-12)
    np.testing.assert_allclose(M_t(r_t).numpy(), np.asarray(M_j(r_j)),
                               atol=1e-12)


def test_shardmap_fused_solve_float32_matches_single_device():
    """The reference's bar (``test_sharding.py``): the sharded fused solve
    against the single-device solution, 5e-4; iterations within 2."""
    _, tprob = _pair(np.float32)
    single = tprob.solve_local(tol=1e-6, cg_kernel="plain", device="cpu")
    its, _, u = _port_sharded_solve(tprob, 2, "shardmap-fused", 1e-6)
    assert abs(its - int(single.cg.iterations)) <= 2
    np.testing.assert_allclose(u, single.u, atol=5e-4)


# -- the far split ------------------------------------------------------------

def _far_pair(coefficient=None, nx=32, ny=16, p=2):
    jprob, _ = _pair(np.float32, nx, ny, p, coefficient)
    ej = jax_exchange.make_exchange(jprob.disc)
    Gf, Dhat, a, Kcat = _affine_tables(jprob, ej)
    plan = exchange.DSSPlan.from_classes(
        ej.n_loc, ej.E, ej.edge_classes, ej.vert_classes, "cpu")
    return ej, Gf, Dhat, a, Kcat, plan


def test_far_split_affine_matches_reference_far_kernel():
    """max_halo=1 sends the row-stride classes (delta +-32) far: the
    reference's far-update kernel (interpret mode) against the port's split
    apply, whose far update runs its plain version here."""
    ej, _Gf, _D, a, Kcat, plan = _far_pair()
    ref = pk.make_fused_affine_laplacian_T(ej, Kcat, a, max_halo=1,
                                           far_mode="kernel", interpret=True)
    assert ref._prep.has_far and ref._far_update is not None
    uT = np.random.RandomState(11).standard_normal(
        (ej.n_loc, ej.E)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(uT)))
    ops = {mode: sumfac.AffineLaplacianT(Kcat, a, plan, max_halo=1,
                                         far_mode=mode)
           for mode in ("kernel", "xla")}
    assert ops["kernel"].far_plan.n_entries > 0
    assert all(abs(b[3]) > 1 for b in ops["kernel"].far_plan.edge_blocks)
    got = {m: op(torch.as_tensor(uT)) for m, op in ops.items()}
    assert _rel(got["kernel"], want) < 1e-5
    assert torch.equal(got["kernel"], got["xla"])
    whole = sumfac.AffineLaplacianT(Kcat, a, plan)(torch.as_tensor(uT))
    assert _rel(got["kernel"], whole) < 1e-6
    # the far update alone, on the near apply's output and raw rows
    near, far = plan.split(1)
    Kst = ops["kernel"].Kst
    aT = ops["kernel"].aT
    out, aux = kernels.affine_apply_dss(torch.as_tensor(uT), Kst, aT, near,
                                        aux=True)
    assert aux.shape == (plan.nb, ej.E)
    assert torch.equal(kernels.far_update(out.clone(), aux, far),
                       got["kernel"])


def test_far_split_general_matches_reference_far_kernel():
    """The general (full-factor) apply of a variable coefficient with
    max_halo=8 below the row stride 16 (``test_fused_general.py``)."""
    jprob, _ = _pair(np.float32, 16, 16, 3, lambda x, y: 1 + x**2 * y**2)
    ej = jax_exchange.RollExchange(jprob.disc)
    Gf = np.asarray(jprob._G_host).reshape(ej.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(
        np.asarray(jprob._D0), np.asarray(jprob._D1))
    ref = pk.make_fused_general_laplacian_T(
        ej, Gf, Dhat, target_win=128, max_halo=8, far_mode="kernel",
        interpret=True)
    assert ref._prep.has_far and ref._far_update is not None
    plan = exchange.DSSPlan.from_classes(
        ej.n_loc, ej.E, ej.edge_classes, ej.vert_classes, "cpu")
    op = sumfac.GeneralLaplacianT(Gf, Dhat, ej.hier, plan, max_halo=8)
    assert op.far_plan is not None
    uT = np.random.RandomState(31).standard_normal(
        (ej.n_loc, ej.E)).astype(np.float32)
    got = op(torch.as_tensor(uT))
    assert _rel(got, np.asarray(ref(jnp.asarray(uT)))) < 1e-5
    whole = sumfac.GeneralLaplacianT(Gf, Dhat, ej.hier, plan)
    assert _rel(got, whole(torch.as_tensor(uT))) < 1e-6


def test_split_operator_refuses_the_fused_cg_kernels():
    """(Named for the refusal it pinned before the fused CG kernels carried
    the far split.)  A split operator's fused CG kernels, one RHS and
    ``n_rhs=2``, give the unsplit kernels' results: kernel A hands its
    near-class Ap over with the raw rows, kernel B adds the far classes
    (plain versions here); only the order of the far sums differs.  The
    single-kernel iteration keeps the whole plan on a split operator, bit
    for bit the unsplit one."""
    ej, Gf, Dhat, a, Kcat, plan = _far_pair()
    ops = {"affine": lambda mh: sumfac.AffineLaplacianT(Kcat, a, plan,
                                                        max_halo=mh),
           "general": lambda mh: sumfac.GeneralLaplacianT(
               Gf, Dhat, ej.hier, plan, max_halo=mh)}
    rng = np.random.RandomState(13)
    n, E = plan.n, plan.E

    def consistent(k=1):
        return exchange.roll_dss_T(torch.as_tensor(rng.standard_normal(
            (k, n, E)).astype(np.float32)), plan).reshape(k * n, E)

    inv = consistent().abs() + 0.5
    w = torch.tensor(np.asarray(ej.weights.T, np.float32))
    for label, make in ops.items():
        split, whole = make(1), make(None)
        assert split.far_plan is not None and whole.far_plan is None, label
        for k in (1, 2):
            n_rhs = None if k == 1 else k
            (kA, kB), (kA0, kB0) = (op.fused_cg_kernels(n_rhs=n_rhs)
                                    for op in (split, whole))
            assert kA.far_plan is split.far_plan and kA0.far_plan is None
            r, p_, x = consistent(k), consistent(k), consistent(k)
            sc = [torch.tensor([0.7, 1.2][:k]), torch.tensor([0.4, 0.9][:k]),
                  torch.tensor([0.3, -0.6][:k])]
            if k == 1:
                sc = [v[0] for v in sc]
            got = kA(r, p_, inv, x, sc[0], sc[1])
            want = kA0(r, p_, inv, x, sc[0], sc[1])
            assert torch.equal(got[0], want[0]) and torch.equal(got[2],
                                                                want[2])
            near, aux = got[1]
            Ap = kernels.far_update_plain(near.reshape(k, n, E).clone(),
                                          aux.reshape(k, -1, E),
                                          split.far_plan).reshape(near.shape)
            assert _rel(Ap, want[1]) < 1e-6, label
            assert _rel(near, want[1]) > 1e-3, label
            assert torch.equal(got[3], want[3]), label
            r_s, rz_s, rn_s = kB(r, got[1], inv, w, sc[2])
            r_w, rz_w, rn_w = kB0(r, want[1], inv, w, sc[2])
            assert _rel(r_s, r_w) < 1e-6, label
            for a_, b_ in ((rz_s, rz_w), (rn_s, rn_w)):
                np.testing.assert_allclose(
                    a_.reshape(-1, k).sum(0).numpy(),
                    b_.reshape(-1, k).sum(0).numpy(), rtol=1e-6)
    split, whole = ops["affine"](1), ops["affine"](None)
    args = (consistent(), consistent(), consistent(), consistent(), inv, w,
            0.4, 0.7)
    for got, want in zip(split.fused_cg_kernel_single()(*args),
                         whole.fused_cg_kernel_single()(*args)):
        assert torch.equal(got, want)


# -- raises and deliberate divergences ----------------------------------------

def test_unported_and_refused_options_raise():
    _, t64 = _pair(np.float64)
    _, t32 = _pair(np.float32)
    cpu = sh.device_mesh(2, device="cpu")
    # the sharded pmg (ported since): the reference's refusal of the
    # untransposed comm, and the V-cycle built on the transposed one
    # (tests/test_torch_sharded_pmg.py holds its solves against the
    # reference's)
    with pytest.raises(ValueError, match="transposed"):
        sh.sharded_local_poisson_problem(t64, cpu, comm="propagation",
                                         precond="pmg")
    M = sh.sharded_local_poisson_problem(t64, cpu, comm="shardmap",
                                         precond={"pmg": {}})[2]
    assert (M._coarse_kind, M._levels) == ("fdm", (3, 1))
    with pytest.raises(ValueError, match="precond"):
        sh.sharded_local_poisson_problem(t64, cpu, precond="ilu")
    with pytest.raises(ValueError, match="f32"):
        sh.sharded_local_poisson_problem(t64, cpu, comm="shardmap-fused")
    _, curved = _pair(np.float32, 16, 8, 3, lambda x, y: 1 + x**2 * y**2)
    with pytest.raises(ValueError, match="affine"):
        sh.sharded_local_poisson_problem(curved, cpu, comm="shardmap-fused")
    with pytest.raises(ValueError, match="comm"):
        sh.sharded_local_poisson_problem(t32, cpu, comm="psum")
    # a halo wider than the block: 16 shards of 16 elements, H_full = 17
    with pytest.raises(ValueError, match="halo 17 exceeds"):
        sh.sharded_local_poisson_problem(
            t32, sh.device_mesh(16, device="cpu"), comm="shardmap-fused")
    # a far split is single-RHS only
    _ej, _Gf, _D, a, Kcat, plan = _far_pair()
    split = sumfac.AffineLaplacianT(Kcat, a, plan, max_halo=1)
    with pytest.raises(ValueError, match="single-RHS"):
        split.stacked(2)
    with pytest.raises(ValueError, match="far_mode"):
        sumfac.AffineLaplacianT(Kcat, a, plan, max_halo=1, far_mode="dma")


def test_eight_shards_of_a_narrow_mesh_run_where_the_reference_raises():
    """Deliberate divergence: the reference rounds its halo up to 128 lanes
    and refuses 8 shards of 32 elements; the port's halo is the widest
    class offset (17), so the same split runs and matches the global
    apply."""
    jprob, tprob = _pair(np.float32)
    ej = jax_exchange.RollExchange(jprob.disc)
    _Gf, _D, a, Kcat = _affine_tables(jprob, ej)
    with pytest.raises(ValueError, match="halo|shards"):
        jax_halo.make_sharded_fused_operator(ej, Kcat, a,
                                             jax_sh.device_mesh(8),
                                             interpret=True)
    ecl, vcl = _classes(ej)
    A = sharded_fused_operator_from_numpy(
        Kcat, a, jax_halo.stack_class_masks(ej), ecl, vcl,
        sh.device_mesh(8, device="cpu"))
    assert A._halo == 17
    uT = np.random.RandomState(8).standard_normal(
        (ej.n_loc, ej.E)).astype(np.float32)
    want = jax_sumfac.make_local_laplacian_operator(
        ej, np.asarray(jprob._G_host).reshape(ej.E, 3, -1),
        jax_sumfac.make_stacked_derivative(np.asarray(jprob._D0),
                                           np.asarray(jprob._D1)),
        vector_layout="ne", backend="xla")(jnp.asarray(uT))
    assert _rel(A(torch.as_tensor(uT)), np.asarray(want)) < 1e-5


def test_max_halo_auto_does_not_split():
    """Deliberate divergence: the reference's ``max_halo="auto"`` weighs
    TPU VMEM windows; the port's resolves to no split."""
    _ej, Gf, Dhat, a, Kcat, plan = _far_pair()
    op = sumfac.AffineLaplacianT(Kcat, a, plan, max_halo="auto")
    assert op.far_plan is None and op._split is None
    assert sumfac.GeneralLaplacianT(Gf, Dhat, _ej.hier, plan,
                                    max_halo="auto").far_plan is None
    uT = torch.as_tensor(np.random.RandomState(2).standard_normal(
        (plan.n, plan.E)).astype(np.float32))
    assert torch.equal(op(uT), sumfac.AffineLaplacianT(Kcat, a, plan)(uT))


# -- cg's reference signature -------------------------------------------------

def test_cg_x0_atol_block_and_stall_cut_match_reference():
    """``x0``, ``atol``, ``dot`` and ``block`` as in the reference's cg, on
    one small SPD system: the same iterations and iterate; ``stall_cut``
    stops a no-progress ladder."""
    rng = np.random.RandomState(4)
    Q = rng.standard_normal((40, 40))
    Amat = Q @ Q.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    x0 = rng.standard_normal(40)
    w = rng.uniform(0.5, 1.5, 40)
    kw = dict(tol=1e-9, atol=1e-6, max_iter=300, block=16)
    rj = jax_cg(lambda v: jnp.asarray(Amat) @ v, jnp.asarray(b),
                jnp.asarray(x0), dot=lambda u, v: jnp.sum(u * v * w), **kw)
    At = torch.as_tensor(Amat)
    rt = cg(lambda v: At @ v, torch.as_tensor(b), torch.as_tensor(x0),
            dot=lambda u, v: torch.sum(u * v * torch.as_tensor(w)), **kw)
    assert int(rt.iterations) == int(rj.iterations) and rt.issued == rj.issued
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-10)
    # a ladder that cannot progress (A = I, M = 0 never moves x) stalls
    stuck = cg(lambda v: v, torch.as_tensor(b), M=lambda r: 0 * r, tol=1e-9,
               max_iter=1000, stall_cut=4.0)
    assert stuck.stalled and stuck.issued == 64 + 128
