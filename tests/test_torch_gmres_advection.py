"""The port's restarted GMRES and advection-diffusion model against the JAX
package's, on the CPU in float64.

* ``gmres`` and ``gmres_batched`` on the same seeded nonsymmetric operator
  (a Jacobi preconditioner, a restart boundary, ``atol``, ``stall_ratio``
  and a weighted dot): equal iteration counts, ``x`` to 1e-10;
* ``AdvectionDiffusion.solve`` and ``solve_batch`` on a 6 x 6 p = 4
  rectangle (the reference's manufactured problem) and on a curved
  half-annulus at p = 4: equal GMRES iterations, ``u`` to 1e-10;
* the velocity-zero model against the port's ``Poisson``; the layout of
  the Laplacian (row-major (E, n), as the reference's); the CUDA default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as jax_annulus
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.advection_diffusion import (
    AdvectionDiffusion as JaxAD)
from spectralelementmethod_tpu.solver.gmres import gmres as jax_gmres
from spectralelementmethod_tpu.solver.gmres import (
    gmres_batched as jax_gmres_batched)

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.advection_diffusion import (
    AdvectionDiffusion)
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import sumfac
from spectralelementmethod_torch.solver.gmres import gmres, gmres_batched

torch.set_num_threads(2)

TOL = 1e-10
EPS, CX, CY = 0.5, 1.0, 0.5


def _system(n=60, seed=0):
    rng = np.random.RandomState(seed)
    Amat = rng.standard_normal((n, n)) / np.sqrt(n) + 1.5 * np.eye(n)
    return Amat, rng.standard_normal(n), rng.standard_normal((3, n))


def _stagnating(n=60):
    """The cyclic shift with b = e_j: GMRES(m < n) makes no progress at
    all (the residual stays exactly 1), so the stall freeze stops the
    solve at its second cycle, far above the rounding floor."""
    eye = np.eye(n)
    return np.roll(eye, 1, axis=0), eye[0], eye[[0, 5, 17]]


# (restart, options, batched too): a restart boundary inside the solve,
# atol with tol = 0, the stall freeze (it stops a solve short of its tol),
# and a weighted inner product
GMRES_CASES = {
    "restart": (10, dict(tol=1e-11, max_restarts=40), True),
    "atol": (7, dict(tol=0.0, atol=1e-6, max_restarts=60), False),
    "stall": (4, dict(tol=1e-10, max_restarts=50, stall_ratio=0.5), True),
    "dot": (12, dict(tol=1e-11, max_restarts=30, weighted=True), False),
}


@pytest.mark.parametrize("case", sorted(GMRES_CASES))
def test_gmres_matches_reference(case):
    restart, kw, batched = GMRES_CASES[case]
    kw = dict(kw)
    Amat, b, B = _stagnating() if case == "stall" else _system()
    d = np.where(np.diag(Amat) != 0, np.diag(Amat), 1.0)
    w = np.linspace(0.5, 1.5, b.size)
    weighted = kw.pop("weighted", False)
    j_dot = (lambda u, v: jnp.sum(u * v * jnp.asarray(w))) if weighted \
        else None
    t_dot = (lambda u, v: torch.sum(u * v * torch.as_tensor(w))) \
        if weighted else None
    ref = jax_gmres(lambda x: jnp.asarray(Amat) @ x, jnp.asarray(b),
                    M=lambda r: r / jnp.asarray(d), restart=restart,
                    dot=j_dot, **kw)
    got = gmres(lambda x: torch.as_tensor(Amat) @ x, torch.as_tensor(b),
                M=lambda r: r / torch.as_tensor(d), restart=restart,
                dot=t_dot, **kw)
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(float(got.residual_norm),
                               float(ref.residual_norm), rtol=1e-6)
    if case == "stall":
        # frozen after two cycles of four steps, above its stop
        assert not bool(got.converged) and int(got.iterations) == 8
    if not batched:
        return

    refb = jax_gmres_batched(lambda x: jnp.asarray(Amat) @ x, jnp.asarray(B),
                             restart=restart, dot=j_dot, **kw)
    gotb = gmres_batched(lambda x: torch.as_tensor(Amat) @ x,
                         torch.as_tensor(B), restart=restart, dot=t_dot,
                         **kw)
    np.testing.assert_array_equal(gotb.iterations.numpy(),
                                  np.asarray(refb.iterations))
    np.testing.assert_array_equal(gotb.converged.numpy(),
                                  np.asarray(refb.converged))
    np.testing.assert_allclose(gotb.x.numpy(), np.asarray(refb.x), rtol=0,
                               atol=TOL)


def test_gmres_x0_and_solution():
    """A nonzero start and the dense solution."""
    Amat, b, _ = _system(40, seed=3)
    x0 = np.full(40, 0.25)
    ref = jax_gmres(lambda x: jnp.asarray(Amat) @ x, jnp.asarray(b),
                    jnp.asarray(x0), tol=1e-12, restart=15)
    got = gmres(lambda x: torch.as_tensor(Amat) @ x, torch.as_tensor(b),
                torch.as_tensor(x0), tol=1e-12, restart=15)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(Amat, b),
                               atol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=TOL)


def _ue(x, y):
    return np.sin(np.pi * (x + 1) / 2) * np.sin(np.pi * (y + 1) / 2)


def _f(x, y):
    X, Y = np.pi * (x + 1) / 2, np.pi * (y + 1) / 2
    lap = -2 * (np.pi / 2) ** 2 * np.sin(X) * np.sin(Y)
    gx = (np.pi / 2) * np.cos(X) * np.sin(Y)
    gy = (np.pi / 2) * np.sin(X) * np.cos(Y)
    return -EPS * lap + CX * gx + CY * gy


def _rect_pair():
    out = []
    for AD, D, rect, basis in ((JaxAD, JaxDisc, jax_rect, jax_basis),
                               (AdvectionDiffusion, Discretization,
                                rectangle_mesh, gll_basis_2d)):
        ad = AD(D(rect(6, 6, 4), basis(4)), velocity=(CX, CY),
                diffusivity=EPS, forcing=_f)
        ad.set_dirichlet("ebc", 0.0)
        ad.set_dirichlet("nbc", 0.0)
        out.append(ad)
    return out


@pytest.fixture(scope="module")
def rect_pair():
    return _rect_pair()


def test_solve_matches_reference_rectangle(rect_pair):
    ref_m, port = rect_pair
    ref = ref_m.solve(tol=1e-11)
    got = port.solve(tol=1e-11, device="cpu")
    assert bool(got.gmres.converged)
    assert int(got.gmres.iterations) == int(ref.gmres.iterations)
    np.testing.assert_allclose(got.u, ref.u, rtol=0, atol=TOL)
    assert port.l2_error(got.u, _ue) < 1e-4


def test_solve_batch_matches_reference_rectangle(rect_pair):
    ref_m, port = rect_pair
    forcings = [_f, 1.0]
    ref = ref_m.solve_batch(forcings, tol=1e-11)
    got = port.solve_batch(forcings, tol=1e-11, device="cpu")
    np.testing.assert_array_equal(got.gmres.iterations.numpy(),
                                  np.asarray(ref.gmres.iterations))
    assert got.gmres.converged.numpy().all()
    np.testing.assert_allclose(got.u, ref.u, rtol=0, atol=TOL)
    # each RHS of the batch is the single solve of that forcing
    one = port.solve(tol=1e-11, device="cpu")
    assert int(one.gmres.iterations) == int(got.gmres.iterations[0])
    np.testing.assert_allclose(got.u[0], one.u, rtol=0, atol=TOL)


def test_solve_matches_reference_curved_annulus():
    """u = x^2 + y^2 on a curved half-annulus (Dirichlet everywhere)."""
    cx, cy = 0.7, -0.4

    def ue(x, y):
        return x**2 + y**2

    def f(x, y):
        return -4.0 + 2 * (cx * x + cy * y)

    kw = dict(order=4, n_theta=6, n_r=5, r_outer=4.0, progression=1.2)
    sols = []
    for AD, D, ann, basis, dkw in (
            (JaxAD, JaxDisc, jax_annulus, jax_basis, {}),
            (AdvectionDiffusion, Discretization, annulus_mesh, gll_basis_2d,
             dict(device="cpu"))):
        ad = AD(D(ann(**kw), basis(4)), velocity=(cx, cy), diffusivity=1.0,
                forcing=f)
        for bnd in ("sphere", "shell", "symaxis"):
            ad.set_dirichlet(bnd, ue)
        sols.append(ad.solve(tol=1e-11, **dkw))
    ref, got = sols
    assert bool(got.gmres.converged)
    assert int(got.gmres.iterations) == int(ref.gmres.iterations)
    np.testing.assert_allclose(got.u, ref.u, rtol=0, atol=TOL)


def test_velocity_zero_is_poisson():
    """With c = 0 the model is the port's Poisson problem."""
    disc = Discretization(rectangle_mesh(4, 4, 5), gll_basis_2d(5))

    def f(x, y):
        return np.pi**2 / 2 * _ue(x, y)

    ad = AdvectionDiffusion(disc, velocity=(0.0, 0.0), forcing=f)
    po = Poisson(disc, forcing=f)
    for m in (ad, po):
        m.set_dirichlet("ebc", 0.0)
        m.set_dirichlet("nbc", 0.0)
    sol = ad.solve(tol=1e-11, device="cpu")
    assert bool(sol.gmres.converged)
    su = po.solve_local(tol=1e-12, device="cpu")
    np.testing.assert_allclose(sol.u, su.u, atol=1e-8)


def test_operator_is_row_major_and_needs_a_device(rect_pair):
    """The Laplacian is the (E, n) operator (the reference's layout), in
    float64 through torch.matmul; the solve defaults to the card."""
    _, port = rect_pair
    port.solve(tol=1e-6, max_restarts=1, device="cpu")
    ex = port._ex()
    uL = torch.randn(ex.E, ex.n_loc, dtype=torch.float64)
    _, apply_raw, _ = port._build(torch.device("cpu"))
    disc = port.disc
    lap = sumfac.make_local_laplacian_operator(
        ex, port._G_host.reshape(disc.E, 3, -1),
        sumfac.make_stacked_derivative(disc.basis.subbases[0].D1,
                                       disc.basis.subbases[1].D1),
        None, device="cpu", vector_layout="en")
    assert isinstance(lap, sumfac.LaplacianEN) and lap._backend == "xla"
    # the stack form: each RHS of a (k, E, n) stack is its own apply
    U = torch.stack([uL, 2 * uL])
    np.testing.assert_allclose(apply_raw(U)[1].numpy(),
                               apply_raw(2 * uL).numpy(), atol=1e-12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.solve(tol=1e-6)
