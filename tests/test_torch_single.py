"""The port's single-kernel CG iteration (``cg_kernel="fused1"``) against the
JAX package, on the CPU (plain versions of the kernels).

One JAX problem, the reference's own (``tests/test_cg_fused.py``:
``rectangle_mesh(16, 8, 3)``, float32), built once per module.  The plain
version of the kernel is held against the reference's
``make_fused_cg_kernel_single`` in Pallas interpret mode on the same
operator state (``interop.operator_from_numpy``) and seeded numpy inputs;
20 iterations of the port's driver against the reference's
``_cg_fused_kernels_single``; the solves against the reference's plain CG.
The bars are the reference's (``tests/test_cg_fused.py``,
``TestSingleKernelCG``): r' and x' 1e-5, p' 1e-4 (one bf16 ulp when p is
stored in bf16: both round the same float32 value), Ap' 1e-4 of its max,
the summed partials 1e-3 relative; solutions 1e-4 of max and iterations
within 3 at tol 1e-6, 1e-3 and at most 15 more iterations with bf16
directions at tol 1e-5.
"""

import functools

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
    make_fused_cg_kernel_single)
from spectralelementmethod_tpu.solver.cg import _cg_fused_kernels_single

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import operator_from_numpy
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels
from spectralelementmethod_torch.solver import cg as port_cg

torch.set_num_threads(2)


def _forcing(x, y):
    return np.sin(np.pi * x) * np.cos(np.pi * y)


def _dirichlet(x, y):
    return 0.1 * x + 0.05 * y


@functools.lru_cache(maxsize=None)
def _jax_problem():
    """The reference's ``_setup()`` and its affine operator pieces."""
    disc = JaxDisc(jax_rect(16, 8, 3), jax_basis(3))
    prob = JaxPoisson(disc, forcing=_forcing, dtype=np.float32)
    prob.set_dirichlet("ebc", _dirichlet)
    ex = RollExchange(disc)
    Gf = prob._G_host.reshape(disc.E, 3, -1).astype(np.float32)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = sumfac.affine_factorization(Gf, W)
    assert exact
    Kcat = sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    return prob, ex, Kcat, a


@functools.lru_cache(maxsize=None)
def _port(bf16: bool = False):
    prob, ex, Kcat, a = _jax_problem()
    return operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", p_dtype=torch.bfloat16 if bf16 else None)


@functools.lru_cache(maxsize=None)
def _jax_kernel(bf16: bool, defer: bool):
    _, ex, Kcat, a = _jax_problem()
    kAB, G = make_fused_cg_kernel_single(
        ex, Kcat, a, interpret=True, target_win=3072,
        precision="high" if bf16 else "highest",
        p_dtype=jnp.bfloat16 if bf16 else None, defer_x=defer)
    return kAB, G


@functools.lru_cache(maxsize=None)
def _jax_plain_solve(tol: float):
    prob = _jax_problem()[0]
    sol = prob.solve_local(tol=tol, vector_layout="ne", cg_kernel="plain")
    return np.asarray(sol.u), int(sol.cg.iterations)


def _port_problem(dtype=np.float32, mesh=None, p=3):
    disc = Discretization(mesh or rectangle_mesh(16, 8, p), gll_basis_2d(p))
    prob = Poisson(disc, forcing=_forcing, dtype=dtype)
    prob.set_dirichlet("ebc" if mesh is None else "sphere", _dirichlet)
    return prob


def _consistent(ex, rng, lo=None):
    """A random consistent (n, E) float32 L-vector (DSS of random data)."""
    shp = (ex.n_loc, ex.E)
    v = (rng.standard_normal(shp) if lo is None
         else rng.uniform(lo, lo + 1.0, shp))
    return np.asarray(ex.dss_T(jnp.asarray(v.astype(np.float32))))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("defer", [False, True], ids=["x", "deferred"])
def test_cg_kernel_single_plain_matches_pallas(bf16, defer):
    _, ex, _, _ = _jax_problem()
    op = _port(bf16)
    kAB_ref, G = _jax_kernel(bf16, defer)
    kAB = op.A.fused_cg_kernel_single(defer)
    assert kAB.single and kAB.defer_x == defer
    rng = np.random.RandomState(3)
    r, Ap, p = (_consistent(ex, rng) for _ in range(3))
    inv = _consistent(ex, rng, lo=0.5)
    x = rng.standard_normal((ex.n_loc, ex.E)).astype(np.float32)
    w = np.asarray(ex.weights.T, dtype=np.float32)
    alpha_prev, beta = 0.4, 0.7
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32

    jx = () if defer else (jnp.asarray(x),)
    ref = kAB_ref(jnp.asarray(r), jnp.asarray(Ap), jnp.asarray(p, jdt),
                  *jx, jnp.asarray(inv, jdt), jnp.asarray(w, jdt),
                  alpha_prev, beta)
    tx = () if defer else (torch.tensor(x),)
    got = kAB(torch.tensor(r), torch.tensor(Ap), torch.tensor(p).to(tdt),
              *tx, torch.tensor(inv).to(tdt), torch.tensor(w).to(tdt),
              alpha_prev, beta)
    assert len(got) == len(ref) == (4 if defer else 5)
    r_ref, p_ref, Ap_ref = (np.asarray(v, np.float32) for v in ref[:3])
    r_got, p_got, Ap_got = (v.float().numpy() for v in got[:3])
    assert got[1].dtype == tdt
    np.testing.assert_allclose(r_got, r_ref, rtol=1e-5, atol=1e-5)
    if not defer:
        np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                                   rtol=1e-5, atol=1e-5)
    p_tol = 2.0 ** -7 if bf16 else 1e-4
    np.testing.assert_allclose(p_got, p_ref, rtol=p_tol, atol=1e-4)
    assert np.abs(Ap_got - Ap_ref).max() / np.abs(Ap_ref).max() < 1e-4
    parts_ref = np.asarray(ref[-1])
    assert parts_ref.shape == (G, 5)
    assert tuple(got[-1].shape) == (ex.E, 5)
    d_got = got[-1].double().sum(0).numpy()
    d_ref = parts_ref.astype(np.float64).sum(0)
    np.testing.assert_array_less(np.abs(d_got - d_ref),
                                 1e-3 * np.maximum(np.abs(d_ref), 1e-6))
    # the direct dots of what the kernel returned: e1, e2 of r'; the
    # pre-DSS identity denom = <p', A p'>_w
    w64, i64 = w.astype(np.float64), np.asarray(inv, np.float64)
    if bf16:
        w64 = np.asarray(jnp.asarray(w, jdt), np.float64)
        i64 = np.asarray(jnp.asarray(inv, jdt), np.float64)
    r64, Ap64 = r_got.astype(np.float64), Ap_got.astype(np.float64)
    direct = [np.sum(w64 * p_got * Ap64), np.sum(w64 * r64 * i64 * Ap64),
              np.sum(w64 * Ap64 * i64 * Ap64), np.sum(w64 * r64 * i64 * r64),
              np.sum(w64 * r64 * r64)]
    np.testing.assert_allclose(d_got, direct, rtol=1e-4)
    # on the CPU the wrapper runs the plain version: nothing launched
    assert kernels.launch_counts()["cg_kernel_single"] == 0
    assert kernels.launch_counts()["cg_kernel_single_deferred"] == 0


def test_cg_kernel_single_frozen_iteration_pins_state():
    """alpha_prev = beta = 0 leaves r and x as they are, so a frozen
    iteration recomputes the same e1 and e2."""
    _, ex, _, _ = _jax_problem()
    op = _port()
    kAB = op.A.fused_cg_kernel_single()
    rng = np.random.RandomState(5)
    r, Ap, p = (torch.tensor(_consistent(ex, rng)) for _ in range(3))
    x = torch.tensor(rng.standard_normal((ex.n_loc, ex.E)),
                     dtype=torch.float32)
    r1, p1, Ap1, x1, parts1 = kAB(r, Ap, p, x, op.inv, op.w_free, 0.0, 0.0)
    assert torch.equal(r1, r) and torch.equal(x1, x)
    r2, _, _, x2, parts2 = kAB(r1, Ap1, p1, x1, op.inv, op.w_free, 0.0, 0.0)
    assert torch.equal(r2, r) and torch.equal(x2, x)
    assert torch.equal(parts1[:, 3:], parts2[:, 3:])


def test_single_driver_state_matches_reference():
    """20 iterations of the single-kernel loop: the port's driver against
    the reference's ``_cg_fused_kernels_single`` from the same residual."""
    prob, ex, _, _ = _jax_problem()
    op = _port()
    kAB_ref, _ = _jax_kernel(False, False)
    inv, w_free = op.inv.numpy(), op.w_free.numpy()
    b = np.asarray(prob._b) + prob._neumann
    free = (~prob._dirichlet_mask)[ex.gather_hier].T
    r0 = np.where(free, b[ex.gather_hier].T, 0.0).astype(np.float32)

    init_k, block_k = _cg_fused_kernels_single(kAB_ref)
    zero = jnp.asarray(0.0, jnp.float32)
    ref = init_k(jnp.asarray(r0), jnp.asarray(inv), jnp.asarray(w_free),
                 zero, zero, jnp.asarray(50, jnp.int32))
    ref = block_k(20, ref, jnp.asarray(inv), jnp.asarray(w_free))

    tz = torch.zeros(())
    s = port_cg._single_init(torch.tensor(r0), op.inv, op.w_free, tz, tz,
                             50, torch.float32)
    step = port_cg._single_step(op.A.fused_cg_kernel_single(), op.inv,
                                op.w_free, tz)
    for _ in range(20):
        s = step(s)
    assert int(s.k) == int(ref[7]) == 20
    r_ref = np.asarray(ref[1])
    assert np.abs(s.r.numpy() - r_ref).max() / np.abs(r_ref).max() < 1e-4
    assert np.abs(s.x.numpy() - np.asarray(ref[0])).max() \
        / np.abs(np.asarray(ref[0])).max() < 1e-4
    for got, want in ((s.rn2, ref[8]), (s.rz_exact, ref[5]),
                      (s.rz_pred, ref[4]), (s.alpha_prev, ref[6])):
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
    # the carried rn2 / rz_exact are direct dots of the carried r
    rc, wf, iv = (t.double() for t in (s.r, op.w_free, op.inv))
    rn2 = float((wf * rc * rc).sum())
    rz = float((wf * rc * iv * rc).sum())
    assert abs(float(s.rn2) - rn2) <= 1e-5 * rn2
    assert abs(float(s.rz_exact) - rz) <= 1e-5 * rz


@pytest.mark.parametrize("kw,tol,u_bar,its", [
    (dict(), 1e-6, 1e-4, (-3, 3)),
    (dict(p_dtype=torch.bfloat16), 1e-5, 1e-3, (None, 15)),
    (dict(defer_x=4), 1e-6, 1e-4, (-3, 3)),
], ids=["f32", "bf16", "defer4"])
def test_solve_local_fused1_matches_reference_plain(kw, tol, u_bar, its):
    u_ref, its_ref = _jax_plain_solve(tol)
    prob = _port_problem()
    sol = prob.solve_local(tol=tol, cg_kernel="fused1", device="cpu", **kw)
    assert bool(sol.cg.converged)
    assert np.abs(sol.u - u_ref).max() / np.abs(u_ref).max() < u_bar
    lo, hi = its
    d_its = int(sol.cg.iterations) - its_ref
    assert (lo is None or d_its >= lo) and d_its <= hi
    key = ("cg_fused1", str(kw.get("p_dtype")), bool(kw.get("defer_x")),
           "cpu")
    assert key in prob._op_cache and prob._op_cache[key][1] is None


def test_fused1_refuses_curved_mesh():
    prob = _port_problem(mesh=annulus_mesh(3, n_theta=8, n_r=3,
                                           r_inner=1.0, r_outer=2.0,
                                           progression=1.0,
                                           node_placement="polar"))
    with pytest.raises(ValueError, match="affine mesh"):
        prob.solve_local(tol=1e-6, cg_kernel="fused1", device="cpu")


def test_fused1_refuses_float64():
    prob = _port_problem(dtype=np.float64, p=2)
    with pytest.raises(ValueError, match="float32"):
        prob.solve_local(tol=1e-6, cg_kernel="fused1", device="cpu")


def test_single_kernel_takes_no_kb():
    op = _port()
    kAB = op.A.fused_cg_kernel_single()
    r = torch.zeros_like(op.inv)
    with pytest.raises(ValueError, match="kB=None"):
        port_cg.cg_fused(kAB, kernels.cg_kernel_b, r, inv=op.inv,
                         w_free=op.w_free)
    with pytest.raises(ValueError, match="one RHS"):
        port_cg.cg_fused_batched(kAB, None, r, inv=op.inv, w_free=op.w_free)


@pytest.mark.parametrize("built,asked", [(False, 4), (True, 0)],
                         ids=["built-without", "built-with"])
def test_single_kernel_defer_x_mismatch(built, asked):
    op = _port()
    kAB = op.A.fused_cg_kernel_single(built)
    r = torch.zeros_like(op.inv)
    with pytest.raises(ValueError, match="defer_x"):
        port_cg.cg_fused(kAB, None, r, inv=op.inv, w_free=op.w_free,
                         defer_x=asked)
