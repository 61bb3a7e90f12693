"""The port's batched multi-RHS and deferred-x CG against the JAX package,
on the CPU (plain versions of the kernels).

The kernels' plain versions are held against the reference's Pallas
kernels in interpret mode (``make_fused_cg_kernels(defer_x=True)``,
``make_fused_cg_kernels_batched``) and its XLA multi-RHS apply, on the same
operator state (``interop.operator_from_numpy``) and numpy inputs, to the
reference's tolerances (``tests/test_fused_general.py``: Ap' rtol 2e-6
atol 1e-4, partial sums rtol 1e-5); the solves to the reference's bars
(1e-10 and the same iterations in float64; 1e-4 of max in float32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import sumfac
from spectralelementmethod_tpu.ops.exchange import RollExchange
from spectralelementmethod_tpu.ops.pallas_kernels import (
    make_fused_cg_kernels, make_fused_cg_kernels_batched)
from spectralelementmethod_tpu.solver.cg import (
    auto_defer_x as jax_auto_defer_x,
    auto_defer_x_batched as jax_auto_defer_x_batched,
    hbm_residency_regime as jax_hbm_residency_regime)

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import operator_from_numpy
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels
from spectralelementmethod_torch.solver import cg as port_cg

torch.set_num_threads(2)

K_RHS = 2


def _forcing(x, y):
    return np.sin(np.pi * x) * np.cos(np.pi * y)


def _jax_problem(nx=16, ny=8, p=3):
    disc = JaxDisc(jax_rect(nx, ny, p), jax_basis(p))
    prob = JaxPoisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    ex = RollExchange(disc)
    Gf = prob._G_host.reshape(disc.E, 3, -1).astype(np.float32)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = sumfac.affine_factorization(Gf, W)
    assert exact
    Kcat = sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    return prob, ex, Gf, Dhat, Kcat, a


def _port(prob, ex, Kcat, a, p_dtype=None):
    return operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", p_dtype=p_dtype)


def _consistent(ex, rng, k=None, lo=None, hi=None):
    """Random consistent float32 L-vectors: (n, E), or a (k n, E) stack."""
    def one():
        shp = (ex.n_loc, ex.E)
        v = (rng.standard_normal(shp) if lo is None
             else rng.uniform(lo, hi, shp))
        return np.asarray(ex.dss_T(jnp.asarray(v.astype(np.float32))))
    if k is None:
        return one()
    return np.concatenate([one() for _ in range(k)], axis=0)


def _dtypes(bf16):
    return ((jnp.bfloat16, torch.bfloat16) if bf16
            else (jnp.float32, torch.float32))


def _ref_kernels(ex, Kcat, a, bf16, n_rhs=None, defer_x=False):
    kw = dict(interpret=True, precision="high" if bf16 else "highest",
              p_dtype=jnp.bfloat16 if bf16 else None, defer_x=defer_x)
    if n_rhs is None:
        return make_fused_cg_kernels(ex, Kcat, a, target_win=3072, **kw)
    return make_fused_cg_kernels_batched(ex, Kcat, a, n_rhs=n_rhs, **kw)


def _check_direction(p_got, p_ref, bf16):
    if bf16:
        # both round the same f32 value to bf16: at most one bf16 ulp
        np.testing.assert_allclose(p_got, p_ref, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(p_got, p_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cg_kernel_a_deferred_plain_matches_pallas(bf16):
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    jdt, tdt = _dtypes(bf16)
    op = _port(prob, ex, Kcat, a, tdt if bf16 else None)
    kA, _, _ = _ref_kernels(ex, Kcat, a, bf16, defer_x=True)
    rng = np.random.RandomState(3)
    r, p = _consistent(ex, rng), _consistent(ex, rng)
    inv = _consistent(ex, rng, lo=0.5, hi=1.5)
    beta = 0.7
    p_ref, Ap_ref, d_ref = (np.asarray(v, np.float32) for v in kA(
        jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt), beta))

    kA_t, _ = op.fused_kernels(defer_x=True)
    p_new, Ap, dparts = kA_t(torch.tensor(r), torch.tensor(p).to(tdt),
                             torch.tensor(inv).to(tdt), beta)
    assert p_new.dtype == tdt and kA_t.defer_x
    _check_direction(p_new.float().numpy(), p_ref, bf16)
    np.testing.assert_allclose(Ap.numpy(), Ap_ref, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(float(dparts.sum()), float(d_ref.sum()),
                               rtol=1e-5)
    assert kernels.launch_counts()["cg_kernel_a_deferred"] == 0


@pytest.mark.parametrize("defer_x", [False, True], ids=["x", "deferred"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cg_kernel_a_batched_plain_matches_pallas(bf16, defer_x):
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    jdt, tdt = _dtypes(bf16)
    op = _port(prob, ex, Kcat, a, tdt if bf16 else None)
    kA, _, _ = _ref_kernels(ex, Kcat, a, bf16, K_RHS, defer_x)
    rng = np.random.RandomState(41)
    r, p = _consistent(ex, rng, K_RHS), _consistent(ex, rng, K_RHS)
    inv = _consistent(ex, rng, lo=0.5, hi=1.5)
    x = rng.standard_normal(r.shape).astype(np.float32)
    betas = np.array([0.4, 1.1], np.float32)
    alphas = np.array([0.0, 0.7], np.float32)
    args = (jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt))
    targs = (torch.tensor(r), torch.tensor(p).to(tdt),
             torch.tensor(inv).to(tdt))
    kA_t, _ = op.fused_kernels(K_RHS, defer_x=defer_x)
    assert kA_t.n_rhs == K_RHS and kA_t.defer_x == defer_x
    if defer_x:
        ref = kA(*args, jnp.asarray(betas))
        got = kA_t(*targs, torch.tensor(betas))
    else:
        ref = kA(*args, jnp.asarray(x), jnp.asarray(betas),
                 jnp.asarray(alphas))
        got = kA_t(*targs, torch.tensor(x), torch.tensor(betas),
                   torch.tensor(alphas))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                                   rtol=1e-5, atol=1e-5)
    p_ref, Ap_ref, d_ref = (np.asarray(ref[i], np.float32)
                            for i in (0, 1, -1))
    _check_direction(got[0].float().numpy(), p_ref, bf16)
    np.testing.assert_allclose(got[1].numpy(), Ap_ref, rtol=2e-6, atol=1e-4)
    # (G, k) partials: each RHS's total
    np.testing.assert_allclose(got[-1].sum(0).numpy(), d_ref.sum(0),
                               rtol=1e-5)
    assert kernels.launch_counts()["cg_kernel_a_batched"] == 0
    assert kernels.launch_counts()["cg_kernel_a_batched_deferred"] == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cg_kernel_b_batched_plain_matches_pallas(bf16):
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    jdt, tdt = _dtypes(bf16)
    _, kB, _ = _ref_kernels(ex, Kcat, a, bf16, K_RHS)
    rng = np.random.RandomState(5)
    shp = (K_RHS * ex.n_loc, ex.E)
    r, Ap = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    inv = rng.uniform(0.5, 1.5, (ex.n_loc, ex.E)).astype(np.float32)
    w = np.asarray(ex.weights.T, dtype=np.float32)
    alpha = np.array([0.3, -0.8], np.float32)
    rn_ref, rz_ref, rn2_ref = kB(jnp.asarray(r), jnp.asarray(Ap),
                                 jnp.asarray(inv, jdt), jnp.asarray(w, jdt),
                                 jnp.asarray(alpha))
    rn, rzp, rn2p = kernels.cg_kernel_b_batched(
        torch.tensor(r), torch.tensor(Ap), torch.tensor(inv).to(tdt),
        torch.tensor(w).to(tdt), torch.tensor(alpha))
    np.testing.assert_allclose(rn.numpy(), np.asarray(rn_ref), rtol=1e-6,
                               atol=1e-6)
    for got, ref in ((rzp, rz_ref), (rn2p, rn2_ref)):
        np.testing.assert_allclose(got.sum(0).numpy(),
                                   np.asarray(ref).sum(0), rtol=1e-5)
    assert kernels.launch_counts()["cg_kernel_b_batched"] == 0


def test_multi_rhs_apply_matches_xla():
    """The k-stack apply (masked per RHS) against the reference's
    make_multi_rhs_laplacian_T(backend="xla"), and each RHS against the
    single-RHS apply."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    op = _port(prob, ex, Kcat, a)
    k = 3
    free = jnp.asarray(op.free.numpy())
    ref_op = sumfac.make_multi_rhs_laplacian_T(
        ex, Gf, Dhat, k, free_local=free, backend="xla")
    U = np.random.RandomState(7).standard_normal(
        (k, ex.n_loc, ex.E)).astype(np.float32)
    U = np.where(op.free.numpy(), U, 0.0).astype(np.float32)
    ref = np.asarray(jax.jit(ref_op)(jnp.asarray(U)))
    got = op.A.stacked(k)(torch.tensor(U)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    for j in range(k):
        np.testing.assert_array_equal(got[j],
                                      op.A(torch.tensor(U[j])).numpy())
    assert kernels.launch_counts()["affine_apply_dss_batched"] == 0


@functools.lru_cache(maxsize=None)
def _pair(dtype, nx=16, ny=8, p=3):
    """The same Dirichlet problem in both packages; shared by the tests
    (a solve changes only a problem's caches), so the JAX side compiles
    once."""
    out = []
    for P, D, rect, basis in ((JaxPoisson, JaxDisc, jax_rect, jax_basis),
                              (Poisson, Discretization, rectangle_mesh,
                               gll_basis_2d)):
        prob = P(D(rect(nx, ny, p), basis(p)), forcing=_forcing, dtype=dtype)
        prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
        out.append(prob)
    return out


FORCINGS = [1.0, lambda x, y: x + y]


def test_solve_local_batch_float64_matches_jax():
    ref, port = _pair(np.float64)
    nodal = np.random.RandomState(7).standard_normal(
        (1, port.disc.n_nodes))
    for fs in (FORCINGS, np.concatenate([nodal, nodal * 0.5])):
        s_ref = ref.solve_local_batch(fs, tol=1e-8)
        s = port.solve_local_batch(fs, tol=1e-8, device="cpu")
        assert s.u.shape == (2, port.disc.n_nodes)
        assert bool(s.cg.converged.all())
        np.testing.assert_array_equal(s.cg.iterations.numpy(),
                                      np.asarray(s_ref.cg.iterations))
        assert s.cg.issued == s_ref.cg.issued
        assert np.abs(s.u - s_ref.u).max() < 1e-10
    assert all(n == 0 for n in kernels.launch_counts().values())


@pytest.mark.parametrize("defer_x", [0, 4])
def test_solve_local_batch_fused_matches_jax(defer_x):
    ref, port = _pair(np.float32, 8, 8, 2)
    s_ref = ref.solve_local_batch(FORCINGS, tol=1e-5, defer_x=defer_x,
                                  cg_kernel="fused-interpret")
    s = port.solve_local_batch(FORCINGS, tol=1e-5, defer_x=defer_x,
                               cg_kernel="fused", device="cpu")
    assert bool(s.cg.converged.all())
    its, its_ref = s.cg.iterations.numpy(), np.asarray(s_ref.cg.iterations)
    assert np.abs(its - its_ref).max() <= 2
    scale = np.abs(s_ref.u).max()
    assert np.abs(s.u - s_ref.u).max() / scale < 1e-4
    assert s.u.dtype == np.float32


def test_cg_fused_batched_iterations_do_not_depend_on_defer_x():
    """defer_x changes only the order in which x is summed: without the
    true-residual verification (A=None) every RHS takes the same
    iterations and issued count, and x agrees to float32 round-off."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    op = _port(prob, ex, Kcat, a)
    rng = np.random.RandomState(11)
    B = torch.where(op.free, torch.tensor(_consistent(ex, rng, K_RHS))
                    .view(K_RHS, ex.n_loc, ex.E), 0.0)
    res = {}
    for m in (0, 4, 8):
        kA, kB = op.fused_kernels(K_RHS, defer_x=bool(m))
        res[m] = port_cg.cg_fused_batched(kA, kB, B, inv=op.inv,
                                          w_free=op.w_free, tol=1e-5,
                                          max_iter=600, defer_x=m)
    for m in (4, 8):
        assert bool(res[m].converged.all())
        np.testing.assert_array_equal(res[m].iterations.numpy(),
                                      res[0].iterations.numpy())
        assert res[m].issued == res[0].issued
        x, x0 = res[m].x.numpy(), res[0].x.numpy()
        assert np.abs(x - x0).max() / np.abs(x0).max() < 1e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["f32-m4", "bf16-m8"])
def test_solve_local_defer_x_matches_plain(bf16):
    """``tests/test_cg_fused.py``'s deferred configurations: the port's
    fused solve with defer_x=4 (f32; bf16 directions: defer_x=8) against
    the reference's plain solve, at its bars, and the same iterations as
    the port's defer_x=0 solve."""
    ref, port = _pair(np.float32)
    tol, m, bar = (1e-5, 8, 1e-3) if bf16 else (1e-6, 4, 1e-4)
    kw = dict(cg_kernel="fused", p_dtype=torch.bfloat16 if bf16 else None,
              device="cpu")
    s_plain = ref.solve_local(tol=tol, vector_layout="ne",
                              cg_kernel="plain")
    s_d = port.solve_local(tol=tol, defer_x=m, **kw)
    s_0 = port.solve_local(tol=tol, **kw)
    assert bool(s_d.cg.converged)
    scale = np.abs(s_plain.u).max()
    assert np.abs(s_d.u - s_plain.u).max() / scale < bar
    its, its_plain = int(s_d.cg.iterations), int(s_plain.cg.iterations)
    if bf16:
        assert its <= its_plain + 15
    else:
        assert abs(its - its_plain) <= 3
    assert its == int(s_0.cg.iterations)
    assert s_d.cg.issued == s_0.cg.issued


# the reference's tables (tests/test_auto_policy.py), plus the edges of
# the batched policy
DEFER_TABLE = [(101_376, 81, 1), (1_050_624, 81, 1), (1_007_616, 81, 1),
               (300_000, 81, 1), (320_000, 81, 1), (101_376, 81, 2),
               (101_376, 81, 4), (101_376, 81, 8), (1_007_616, 81, 2),
               (99_856, 81, 4)]


@pytest.mark.parametrize("E,n_loc,k", DEFER_TABLE)
def test_auto_policies_match_jax(E, n_loc, k):
    assert (port_cg.auto_defer_x(E, n_loc)
            == jax_auto_defer_x(E, n_loc))
    assert (port_cg.hbm_residency_regime(E, n_loc)
            == jax_hbm_residency_regime(E, n_loc))
    assert (port_cg.auto_defer_x_batched(E, n_loc, k)
            == jax_auto_defer_x_batched(E, n_loc, k))


def test_defer_x_error_paths():
    """``tests/test_cg_fused.py`` and ``tests/test_fused_general.py``:
    kernels built with and without deferral must match defer_x, and m must
    divide 64."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem()
    op = _port(prob, ex, Kcat, a)
    r = torch.zeros((ex.n_loc, ex.E))
    one = torch.ones_like(r)
    kA_d, kB = op.fused_kernels(defer_x=True)
    kA_0, _ = op.fused_kernels()
    with pytest.raises(ValueError, match="defer_x"):
        port_cg.cg_fused(kA_d, kB, r, inv=one, w_free=one)   # missing m
    with pytest.raises(ValueError, match="defer_x"):
        port_cg.cg_fused(kA_0, kB, r, inv=one, w_free=one, defer_x=4)
    with pytest.raises(ValueError, match="divide"):
        port_cg.cg_fused(kA_d, kB, r, inv=one, w_free=one, defer_x=7)
    B = torch.zeros((K_RHS, ex.n_loc, ex.E))
    kA_bd, kB_b = op.fused_kernels(K_RHS, defer_x=True)
    kA_b0, _ = op.fused_kernels(K_RHS)
    with pytest.raises(ValueError, match="defer_x"):
        port_cg.cg_fused_batched(kA_bd, kB_b, B, inv=one, w_free=one,
                                 max_iter=64)
    with pytest.raises(ValueError, match="defer_x"):
        port_cg.cg_fused_batched(kA_b0, kB_b, B, inv=one, w_free=one,
                                 max_iter=64, defer_x=4)
    with pytest.raises(ValueError, match="n_rhs"):
        port_cg.cg_fused_batched(kA_b0, kB_b, B[:1], inv=one, w_free=one)


def test_unported_batch_options_raise():
    _, port = _pair(np.float32)
    # pmg is ported since (ROADMAP Queue 1 item 3): the batch solves
    sol = port.solve_local_batch(FORCINGS, tol=1e-5, precond="pmg",
                                 device="cpu")
    assert bool(sol.cg.converged.all())
    # the en batch and cg_batched's per-RHS mode are ported since (ROADMAP
    # Queue 1 item 5): the en batch takes the ne batch's iterations
    sol = port.solve_local_batch(FORCINGS, tol=1e-5, vector_layout="en",
                                 device="cpu")
    ne = port.solve_local_batch(FORCINGS, tol=1e-5, device="cpu")
    assert bool(sol.cg.converged.all())
    assert np.abs(sol.cg.iterations.numpy()
                  - ne.cg.iterations.numpy()).max() <= 2
    res = port_cg.cg_batched(lambda v: 2.0 * v, torch.ones((2, 3)))
    assert torch.equal(res.x, torch.full((2, 3), 0.5))
    assert res.iterations.tolist() == [1, 1]
    with pytest.raises(TypeError, match="device"):
        kernels._per_rhs(0.5, 2, "beta", torch.device("cpu"))
