"""The port's axisymmetric squirmer against the JAX package's, on the CPU in
float64.

One reference ``Squirmer`` on the reference's coarse donut
(``annulus_mesh(order=6, n_theta=6, n_r=10, r_outer=100, progression=1.6)``,
E = 60) serves the module; its state reaches the port's model through
:func:`spectralelementmethod_torch.interop.squirmer_state_from_numpy`.
Covered:

* the element residual and the per-element Jacobian (``torch.func.jacfwd``
  under ``vmap``) against the reference's ``jax.jacfwd``, to 1e-10;
* one Newton solve at Re = 0.5 (the reference's direct solver): the same
  number of steps, the solution to 1e-10, ``calc_force`` to 1e-10 (the
  device quadrature and the numpy one);
* ``linear_solver="gmres-ir"`` against ``"direct"`` to 1e-8; the
  ``"device"`` Newton loop against ``"host"`` bit for bit (both solvers);
  ``SolverFailure`` where the reference raises it;
* the condensation pipeline: ``schur_solve`` against the reference's on
  one seeded system (1e-10), ``schur_factor`` + ``schur_apply`` against
  ``schur_solve``, the pinning of non-finite constrained rows;
* the Stokes limits (swimming speed within 5e-3 of 1, the fixed sphere's
  drag within 6% of -6 pi), ``guess_from`` (the port's point location) and
  an HDF5 save/load round trip and sweep resume under ``tmp_path``;
* the golden speed 0.92571156681483957 within 3e-6 on the p = 8 donut,
  held against the constant; it runs ~30 s of dense float64 LUs on the
  CPU, so it is marked ``slow`` (tier-1 leaves it out; the card runs the
  same cell in ``chip_smoke.py``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as jax_annulus
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models import squirmer as jsq
from spectralelementmethod_tpu.solver import condensation as jsc
from spectralelementmethod_tpu.solver.rootfind import (
    SolverFailure as JaxSolverFailure)

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core import pointlocate as pl
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import squirmer_state_from_numpy
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models import squirmer as tsq
from spectralelementmethod_torch.parallel import device_mesh
from spectralelementmethod_torch.solver import condensation as sc
from spectralelementmethod_torch.solver.rootfind import SolverFailure

torch.set_num_threads(2)

COARSE = dict(order=6, n_theta=6, n_r=10, r_outer=100.0, progression=1.6)
TOL = 1e-10
GOLDEN = 0.92571156681483957


def _port(**kw):
    return tsq.Squirmer(annulus_mesh(**COARSE), order=6, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference squirmer at Re = 0.5, beta = 0.5 with the potential
    flow guess, and that start state as numpy (later tests solve it)."""
    sq = jsq.Squirmer(jax_annulus(**COARSE), order=6)
    sq.set_initial_guess()
    sq.compute_operators(0.5)
    sq.set_boundary_conditions(speed=1.0, beta=0.5)
    start = dict(soln_vec=sq.soln_vec.copy(), phys_params=dict(sq.phys_params),
                 dof_free=sq.dof_free.copy(), cint=sq.cint.copy())
    return sq, start


def _steps(text: str) -> int:
    return int(re.search(r"converged in (\d+) Newton", text).group(1))


@pytest.fixture(scope="module")
def solved(ref):
    """(reference, port) after one Newton solve each from the same state,
    with their step counts."""
    import contextlib
    import io

    sq, start = ref
    port = _port()
    squirmer_state_from_numpy(port, **start)
    out = []
    for m in (sq, port):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            m.solve(it_max=8, tol=1e-10, verbose=True)
        out.append(_steps(buf.getvalue()))
    return sq, port, out


def test_state_copy(ref):
    sq, _ = ref
    port = _port()
    squirmer_state_from_numpy(port, sq.soln_vec, sq.phys_params,
                              sq.dof_free, sq.cint)
    np.testing.assert_array_equal(port.soln_vec, np.asarray(sq.soln_vec))
    np.testing.assert_array_equal(port.dof_free, sq.dof_free)
    np.testing.assert_array_equal(port.cint, sq.cint)
    np.testing.assert_array_equal(port._free_ext.numpy(),
                                  np.asarray(sq._free_ext))
    assert port.phys_params["N_Re"] == 0.5
    with pytest.raises(ValueError, match="cint"):
        squirmer_state_from_numpy(port, sq.soln_vec, sq.phys_params,
                                  sq.dof_free, sq.cint[:-1])


def test_residual_and_jacobian_match_reference(ref):
    """The element residual and its autodiff Jacobian, in the
    hier-interleaved order of the condensation, at the start state."""
    sq, start = ref
    port = _port()
    squirmer_state_from_numpy(port, **start)
    soln, n_rey, _, free_ext = port._newton_inputs()
    lrhs, lmat = port._local_systems(soln, n_rey, free_ext)

    local_residual, jac_fn = sq._local_system_fns()
    gather = jnp.asarray(sq.disc.gather_nodes)
    x_flat = jnp.asarray(sq.soln)[gather].reshape(sq.disc.E, -1)
    args = (sq._Grho, sq._JxW, sq._inv_rho, sq._invJ,
            sq._rho * sq._rho * sq._JxW, jnp.asarray(0.5))
    axes = (0, 0, 0, 0, 0, 0, None)
    # each compiled as one program (called eagerly, each of its
    # operations would compile on its own)
    res = jax.jit(jax.vmap(local_residual, in_axes=axes))(x_flat, *args)
    jac = jax.jit(jax.vmap(jac_fn, in_axes=axes))(x_flat, *args)
    perm = np.asarray(sq._ldof_perm)
    ref_rhs = -np.asarray(res)[:, perm]
    ref_mat = np.asarray(jac)[:, perm][:, :, perm]
    assert lmat.shape == (60, 98, 98)
    assert torch.isfinite(lmat).all() and torch.isfinite(lrhs).all()
    scale = np.abs(ref_mat).max()
    np.testing.assert_allclose(lmat.numpy(), ref_mat, rtol=0,
                               atol=TOL * scale)
    np.testing.assert_allclose(lrhs.numpy(), ref_rhs, rtol=0,
                               atol=TOL * np.abs(ref_rhs).max())


def test_newton_solve_matches_reference(solved):
    sq, port, (ref_steps, port_steps) = solved
    assert port_steps == ref_steps
    np.testing.assert_allclose(port.soln, sq.soln, rtol=0, atol=TOL)


def test_force_matches_reference(solved):
    sq, port, _ = solved
    f_ref = sq.calc_force()
    port.solve(it_max=8, tol=1e-10, verbose=False)      # device-resident
    assert port._soln_dev is not None
    f_dev = port.calc_force()
    assert port._soln_dev is not None                  # no download
    _ = port.soln
    f_np = port.calc_force()                           # numpy quadrature
    assert abs(f_dev - f_ref) < TOL and abs(f_np - f_ref) < TOL


def _run(linear_solver="direct", newton_loop="host"):
    sq = _port(linear_solver=linear_solver)
    sq.set_initial_guess()
    sq.compute_operators(0.5)
    sq.set_boundary_conditions(speed=0.95, beta=0.5)
    sq.solve(verbose=False, newton_loop=newton_loop)
    return sq


def test_gmres_ir_matches_direct():
    direct, mixed = _run("direct"), _run("gmres-ir")
    np.testing.assert_allclose(mixed.soln, direct.soln, rtol=0, atol=1e-8)
    assert abs(mixed.calc_force() - direct.calc_force()) < 1e-8


@pytest.mark.parametrize("linear_solver", ["direct", "gmres-ir"])
def test_device_newton_loop_is_host_loop(linear_solver):
    host = _run(linear_solver, "host")
    dev = _run(linear_solver, "device")
    assert dev._soln_dev is not None
    assert dev.calc_force() == host.calc_force()
    np.testing.assert_array_equal(dev.soln, host.soln)
    # a BC write on a live device copy (the next secant speed)
    dev.solve(verbose=False, newton_loop="device")
    dev.set_boundary_conditions(speed=0.96, beta=0.5)
    assert dev._soln_dev is not None
    host.solve(verbose=False)
    host.set_boundary_conditions(speed=0.96, beta=0.5)
    np.testing.assert_array_equal(dev.soln, host.soln)


def test_solver_failure_as_in_reference(ref):
    sq, start = ref
    # the element-sharded model (3 shards: E = 60 as it is) fails as the
    # reference's and the unsharded one do
    sharded = _port()
    sharded.shard_elements(device_mesh(3, device="cpu"))
    for model, exc, kw in ((jsq.Squirmer(jax_annulus(**COARSE), order=6),
                            JaxSolverFailure, {}),
                           (_port(), SolverFailure, {}),
                           (_port(), SolverFailure,
                            dict(newton_loop="device")),
                           (sharded, SolverFailure, {})):
        model.set_initial_guess()
        model.compute_operators(1.0)
        model.set_boundary_conditions(speed=1.0, beta=1.0)
        with pytest.raises(exc, match="failed to reach"):
            model.solve(it_max=1, tol=1e-14, verbose=False, **kw)
    with pytest.raises(ValueError, match="linear_solver"):
        _port(linear_solver="lu")
    # 7 shards pad E = 60 to 63 by repeating element 0
    padded = _port()
    padded.shard_elements(device_mesh(7, device="cpu"))
    assert padded._Grho.shape[0] == 63 and torch.equal(
        padded._Grho[60:], padded._Grho[:1].expand(3, -1, -1, -1))


@pytest.mark.parametrize("newton_loop", ["host", "device"])
@pytest.mark.parametrize("linear_solver", ["direct", "gmres-ir"])
def test_nonfinite_free_dof_fails_the_newton_solve(linear_solver,
                                                   newton_loop):
    """A NaN on a free DOF is not zeroed away: the update is non-finite
    and the solve raises, as the reference's does.  (GMRES never converges
    on a NaN, so the GMRES-IR step gets a budget of 2 restart cycles.)"""
    sq = _port(linear_solver=linear_solver)
    if linear_solver == "gmres-ir":
        sq._step_fn = sq._make_step_mixed(max_restarts=2)
    sq.set_initial_guess()
    sq.compute_operators(0.5)
    sq.set_boundary_conditions(speed=0.95, beta=0.5)
    node = int(sq._int_global_nodes[0, 0])
    assert sq.dof_free[node].all()
    soln = sq.soln.copy()
    soln[node, 1] = np.nan
    sq.soln = soln
    with pytest.raises(SolverFailure, match="not finite"):
        sq.solve(verbose=False, newton_loop=newton_loop)


def _spd_system(mk, basis, D, p, dpn, seed):
    disc = D(mk(3, 2, p), basis(p))
    csys = (jsc if mk is jax_rect else sc).build_condensed_indexing(
        disc, dofs_per_node=dpn)
    nd = dpn * disc.n_loc
    rng = np.random.RandomState(seed)
    B = rng.standard_normal((disc.E, nd, nd))
    lmat = B @ np.swapaxes(B, 1, 2) + 10 * nd * np.eye(nd)
    lrhs = rng.standard_normal((disc.E, nd))
    extra = rng.standard_normal(csys.n_ext_dofs)
    free = np.ones(csys.n_ext_dofs, bool)
    free[:5] = False
    return csys, lmat, lrhs, extra, free


def test_schur_solve_matches_reference():
    jcs, lmat, lrhs, extra, free = _spd_system(jax_rect, jax_basis, JaxDisc,
                                               3, 2, 0)
    tcs, *_ = _spd_system(rectangle_mesh, gll_basis_2d, Discretization,
                          3, 2, 0)
    np.testing.assert_array_equal(tcs.ext_dof_gidx, jcs.ext_dof_gidx)
    xe0, xl0 = jsc.schur_solve(jnp.asarray(lmat), jnp.asarray(lrhs), jcs,
                               jnp.asarray(free), rhs_extra=extra)
    t = torch.as_tensor
    xe1, xl1 = sc.schur_solve(t(lmat), t(lrhs), tcs, t(free),
                              rhs_extra=t(extra))
    np.testing.assert_allclose(xe1.numpy(), np.asarray(xe0), atol=TOL)
    np.testing.assert_allclose(xl1.numpy(), np.asarray(xl0), atol=TOL)
    # the explicit-inverse factors give the same solution
    facs = sc.schur_factor(t(lmat), tcs, t(free))
    xe2, xl2 = sc.schur_apply(facs, t(lrhs), tcs, rhs_extra=t(extra))
    np.testing.assert_allclose(xe2.numpy(), xe1.numpy(), atol=TOL)
    np.testing.assert_allclose(xl2.numpy(), xl1.numpy(), atol=TOL)
    assert xe1[:5].abs().max() == 0                  # pinned to zero


def test_nonfinite_constrained_rows_are_pinned():
    """inf/NaN in constrained condensed rows never reaches the LU."""
    _, lmat, lrhs, _, free = _spd_system(rectangle_mesh, gll_basis_2d,
                                         Discretization, 2, 1, 3)
    csys = sc.build_condensed_indexing(
        Discretization(rectangle_mesh(3, 2, 2), gll_basis_2d(2)), 1)
    t = torch.as_tensor
    sc_mat, sc_rhs, _, _ = sc.condense_local(t(lmat), t(lrhs),
                                             csys.n_ext_ldof)
    A, b = sc.assemble_dense(sc_mat, sc_rhs, csys.ext_dof_gidx,
                             csys.n_ext_dofs)
    x = sc.solve_condensed(A, b, t(free))
    A_bad = A.clone()
    A_bad[0, :] = float("inf")
    A_bad[:, 1] = float("nan")
    x_bad = sc.solve_condensed(A_bad, b, t(free))
    assert torch.isfinite(x_bad).all()
    np.testing.assert_allclose(x_bad.numpy(), x.numpy(), atol=TOL)


def test_stokes_limit_speed_and_drag():
    sq = _port()
    sq.set_initial_guess()
    speed = sq.calc_speed([0.99, 1.01], n_rey=0.01, beta=1.0, verbose=False)
    assert abs(speed - 1.0) < 5e-3
    fs = tsq.FixedSphere(annulus_mesh(**COARSE), order=6, device="cpu")
    fs.run(0.01, verbose=False)
    force = fs.calc_force()
    assert force < 0 and abs(force - (-6 * np.pi)) < 0.06 * 6 * np.pi


def test_guess_from_and_checkpoint(tmp_path):
    h5py = pytest.importorskip("h5py")
    sq = _port()
    sq.set_initial_guess()
    sq.calc_speed([0.99, 1.01], n_rey=0.01, beta=1.0, verbose=False)

    other = tsq.Squirmer(annulus_mesh(order=4, n_theta=5, n_r=8,
                                      r_outer=100.0, progression=1.8),
                         order=4, device="cpu")
    other.guess_from(sq)
    pts = np.array([[1.5, 0.3], [2.0, -1.0]])
    a = pl.interpolate(sq.disc, sq.soln[:, 0], pts)
    b = pl.interpolate(other.disc, other.soln[:, 0], pts)
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)
    assert other.phys_params["speed"] == sq.phys_params["speed"]

    path = str(tmp_path / "results.h5")
    with h5py.File(path, "w") as f:
        sq.save_data(f)
    before, speed = sq.soln_vec.copy(), sq.phys_params["speed"]
    sq.soln_vec = np.zeros_like(before)
    with h5py.File(path, "r") as f:
        label = list(f.keys())[0]
        assert label == "Re=1.00e-02,beta=1.00e+00"
        sq.load_data(f[label])
    np.testing.assert_array_equal(sq.soln_vec, before)
    assert sq.phys_params["speed"] == speed

    # a sweep over the stored point resumes from the file (no solve)
    speeds = tsq.main(sq, [0.01], [1.0], filename=path, verbose=False)
    assert speeds == {(0.01, 1.0): speed}


@pytest.mark.slow
def test_golden_speed():
    """The original library's documented oracle at its own resolution:
    the donut (9 x 15 transfinite, progression 1.35, R = 100), p = 8,
    Re = 1, beta = 1 -> 0.92571156681483957, within the 3e-6 that the
    JAX package's own test allows."""
    mesh = annulus_mesh(order=8, n_theta=9, n_r=15, r_outer=100.0,
                        progression=1.35, node_placement="gmsh")
    sq = tsq.Squirmer(mesh, order=8, device="cpu")
    sq.set_initial_guess()
    speed = sq.calc_speed([0.99, 1.01], n_rey=1.0, beta=1.0, verbose=False)
    assert abs(speed - GOLDEN) < 3e-6
