"""The PyTorch port's kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode and its XLA apply.

Both packages see the same operator state: the JAX side's arrays go
through ``spectralelementmethod_torch.interop.operator_from_numpy``, and
the inputs are made with numpy from a seed.  Tolerances are the reference
kernel tests' (``tests/test_cg_fused.py``); the apply is held to 1e-5 of
its max in float32 because the two sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d
from spectralelementmethod_tpu.core.discretization import Discretization
from spectralelementmethod_tpu.mesh import rectangle_mesh
from spectralelementmethod_tpu.models.poisson import Poisson
from spectralelementmethod_tpu.ops import sumfac
from spectralelementmethod_tpu.ops.exchange import RollExchange
from spectralelementmethod_tpu.ops.pallas_kernels import (
    make_fused_affine_laplacian_T, make_fused_cg_kernels)

from spectralelementmethod_torch.interop import operator_from_numpy
from spectralelementmethod_torch.ops import kernels

torch.set_num_threads(2)


def _jax_problem(nx, ny, p, pad=0, dtype=np.float32):
    disc = Discretization(rectangle_mesh(nx, ny, p), gll_basis_2d(p))
    prob = Poisson(disc, dtype=dtype)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    ex = RollExchange(disc, pad_to=disc.E + pad if pad else None)
    Gf = sumfac._pad_factors_to_exchange(
        prob._G_host.reshape(disc.E, 3, -1), ex)
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


def _consistent(ex, rng, lo=None, hi=None):
    """A random consistent (n, E) float32 L-vector (DSS of random data)."""
    shp = (ex.n_loc, ex.E)
    v = (rng.standard_normal(shp) if lo is None else rng.uniform(lo, hi, shp))
    return np.asarray(ex.dss_T(jnp.asarray(v.astype(np.float32))))


@pytest.mark.parametrize("nx,ny,p,pad,pallas", [
    (16, 16, 8, 0, False),   # the main path's n = 81 (XLA reference only:
                             # the p = 8 interpret kernel costs ~7 s)
    (16, 8, 3, 128, True),   # padded arrays, as the reference pads them
])
def test_affine_apply_dss_plain_matches_pallas_and_xla(nx, ny, p, pad,
                                                       pallas):
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(nx, ny, p, pad)
    op = _port(prob, ex, Kcat, a)
    rng = np.random.RandomState(0)
    u = rng.standard_normal((ex.n_loc, ex.E)).astype(np.float32)
    u[:, ex.E_real:] = 0.0

    A_xla = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne")
    refs = [np.asarray(jax.jit(A_xla)(jnp.asarray(u)))]
    if pallas:
        kernel = make_fused_affine_laplacian_T(ex, Kcat, a, target_win=128,
                                               interpret=True)
        refs.append(np.asarray(kernel(jnp.asarray(u))))

    got = kernels.affine_apply_dss(torch.tensor(u), op.A.Kst, op.A.aT,
                                   op.plan).numpy()
    for ref in refs:
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    # the CPU path is the plain version: no kernel was launched
    assert kernels.launch_counts()["affine_apply_dss"] == 0


def test_affine_apply_dss_plain_float64_matches_xla():
    """In float64 the plain apply agrees with the XLA apply to round-off."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3, dtype=np.float64)
    op = operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", dtype=np.float64)
    u = np.random.RandomState(1).standard_normal((ex.n_loc, ex.E))
    A_xla = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne")
    ref = np.asarray(A_xla(jnp.asarray(u)))
    got = op.A_raw(torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("p_dtype", [None, "bfloat16"])
def test_cg_kernel_a_plain_matches_pallas(p_dtype):
    bf16 = p_dtype is not None
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3)
    op = _port(prob, ex, Kcat, a, torch.bfloat16 if bf16 else None)
    kA, kB, G = make_fused_cg_kernels(
        ex, Kcat, a, interpret=True, target_win=3072,
        precision="high" if bf16 else "highest",
        p_dtype=jnp.bfloat16 if bf16 else None)
    rng = np.random.RandomState(3)
    r = _consistent(ex, rng)
    p = _consistent(ex, rng)
    inv = _consistent(ex, rng, 0.5, 1.5)
    x = rng.standard_normal((ex.n_loc, ex.E)).astype(np.float32)
    beta, alpha_prev = 0.7, 0.4
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    ref = kA(jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt),
             jnp.asarray(x), beta, alpha_prev)
    p_ref, Ap_ref, x_ref, d_ref = (np.asarray(v, np.float32) for v in ref)

    pt = torch.tensor(p).to(tdt)
    it = torch.tensor(inv).to(tdt)
    p_new, Ap, x_new, dparts = op.kA(torch.tensor(r), pt, it,
                                     torch.tensor(x), beta, alpha_prev)
    assert p_new.dtype == tdt
    np.testing.assert_allclose(x_new.numpy(), x_ref, rtol=1e-5, atol=1e-5)
    p_got = p_new.float().numpy()
    if bf16:
        # both round the same f32 value to bf16: at most one bf16 ulp
        np.testing.assert_allclose(p_got, p_ref, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(p_got, p_ref, rtol=1e-5, atol=1e-5)
    scale = np.abs(Ap_ref).max()
    assert np.abs(Ap.numpy() - Ap_ref).max() / scale < 1e-4
    d_got, d_exp = float(dparts.sum()), float(d_ref.sum())
    assert abs(d_got - d_exp) / abs(d_exp) < 1e-4
    # the pre-DSS identity: the partials sum to the weighted <p', A p'>
    dot = float(op.dot_T(p_new.float(), Ap))
    assert abs(d_got - dot) / abs(dot) < 1e-4
    assert kernels.launch_counts()["cg_kernel_a"] == 0


@pytest.mark.parametrize("p_dtype", [None, "bfloat16"])
def test_cg_kernel_b_plain_matches_pallas(p_dtype):
    bf16 = p_dtype is not None
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3)
    kA, kB, G = make_fused_cg_kernels(
        ex, Kcat, a, interpret=True, target_win=3072,
        precision="high" if bf16 else "highest",
        p_dtype=jnp.bfloat16 if bf16 else None)
    rng = np.random.RandomState(5)
    shp = (ex.n_loc, ex.E)
    r, Ap = (rng.standard_normal(shp).astype(np.float32) for _ in range(2))
    inv = rng.uniform(0.5, 1.5, shp).astype(np.float32)
    w = np.asarray(ex.weights.T, dtype=np.float32)
    alpha = 0.3
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    rn_ref, rz_ref, rn2_ref = kB(jnp.asarray(r), jnp.asarray(Ap),
                                 jnp.asarray(inv, jdt), jnp.asarray(w, jdt),
                                 alpha)
    rn, rzp, rn2p = kernels.cg_kernel_b(
        torch.tensor(r), torch.tensor(Ap), torch.tensor(inv).to(tdt),
        torch.tensor(w).to(tdt), alpha)
    np.testing.assert_allclose(rn.numpy(), np.asarray(rn_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(rzp.sum()), float(jnp.sum(rz_ref)),
                               rtol=1e-4)
    np.testing.assert_allclose(float(rn2p.sum()), float(jnp.sum(rn2_ref)),
                               rtol=1e-4)
    assert kernels.launch_counts()["cg_kernel_b"] == 0


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on CUDA never reaches a plain
    version: the wrappers run the kernel or raise."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3)
    op = _port(prob, ex, Kcat, a)
    u = torch.zeros((ex.n_loc, ex.E), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.affine_apply_dss(u, op.A.Kst, op.A.aT, op.plan)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.cg_kernel_b(u, u, u, u, 0.5)


def _jax_seed(prob, ex, A_raw):
    """The reference's masked residual seed b - A u_d on (n, E)."""
    free = np.ascontiguousarray((~prob._dirichlet_mask)[ex.gather_hier].T)
    b = np.asarray(prob._b) + prob._neumann
    u_d = np.where(prob._dirichlet_mask, prob._dirichlet_vals, 0.0)
    bL, u_dL = (jnp.asarray(np.ascontiguousarray(
        v[ex.gather_hier].astype(prob.dtype).T)) for v in (b, u_d))
    return b, u_d, jnp.where(free, bL - A_raw(u_dL), 0.0)


def test_cg_fused_through_interop_matches_jax():
    """The port's cg_fused on the JAX side's operator state (interop)
    against the reference's cg_fused on its interpret-mode kernels."""
    from spectralelementmethod_tpu.solver.cg import cg_fused as jax_fused

    from spectralelementmethod_torch.solver.cg import cg_fused

    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3)
    op = _port(prob, ex, Kcat, a)
    kA, kB, _ = make_fused_cg_kernels(ex, Kcat, a, interpret=True,
                                      target_win=3072, precision="highest")
    A_xla = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne")
    b, u_d, r = _jax_seed(prob, ex, A_xla)
    ref = jax_fused(kA, kB, r, inv=jnp.asarray(op.inv.numpy()),
                    w_free=jnp.asarray(op.w_free.numpy()), tol=1e-6,
                    max_iter=400)

    r_t = torch.where(op.free, op.to_local(b) - op.A_raw(op.to_local(u_d)),
                      0.0)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r), rtol=1e-5,
                               atol=1e-5)
    res = cg_fused(op.kA, op.kB, r_t, inv=op.inv, w_free=op.w_free,
                   tol=1e-6, max_iter=400, A=op.A)
    assert bool(res.converged)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 2
    x_ref = np.asarray(ref.x)
    assert np.abs(res.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-5


def test_cg_float64_through_interop_matches_jax():
    """The port's plain cg with the interop operator, Jacobi M and dot
    weights against the reference's cg in float64: same iterations, same
    iterate to round-off."""
    from spectralelementmethod_tpu.solver.cg import cg as jax_cg
    from spectralelementmethod_tpu.solver.cg import jacobi_preconditioner

    from spectralelementmethod_torch.solver.cg import cg

    prob, ex, Gf, Dhat, Kcat, a = _jax_problem(16, 8, 3, dtype=np.float64)
    op = operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", dtype=np.float64)
    free = jnp.asarray(op.free.numpy())
    A_raw = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne")
    A = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, free, backend="xla", vector_layout="ne",
        assume_masked_input=True)
    b, u_d, r = _jax_seed(prob, ex, A_raw)
    diagL = jnp.asarray(np.ascontiguousarray(
        prob.operator_diagonal()[ex.gather_hier].T))
    ref = jax_cg(A, r, M=jacobi_preconditioner(diagL, free), tol=1e-8,
                 max_iter=1000, dot_weight=jnp.asarray(op.w.numpy()))

    res = cg(op.A, torch.tensor(np.asarray(r)), M=op.M, tol=1e-8,
             max_iter=1000, dot_weight=op.w)
    assert bool(res.converged)
    assert int(res.iterations) == int(ref.iterations)
    assert res.issued == ref.issued
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-10)
