"""The port's refined and certified solves and Poisson's global-vector
entry points against the JAX package, on the CPU (plain versions of the
kernels).

* ``cg_refined`` on the reference's cases (``tests/test_cg_batched.py``
  ``TestCgRefined``, ``tests/test_solver_guards.py``
  ``TestCGRefinedDiagnostics``) and a float64 ``A_hi``-anchored case: in
  float64 the same cycles, iterations and solution to 1e-8; in float32
  the same number of cycles and each cycle's true residual within 2x;
* ``cg_refined_static`` with float64 inner segments on the reference's
  certified 8x7 p = 6 problem: the same iterations, issued iterations,
  skip pattern and solution to 1e-10;
* ``solve_local(certify=True)`` on the float32 model against the
  reference's: both converged, the same segments run, each segment's
  residual within 2x, and ``u`` within 1e-4 of the scale of an
  independent float64 solve (the reference's bar); the repeat solve bit
  for bit, the BC cache, ``host_loop`` refused, the float64 no-op, no
  host-ladder switch in the HBM regime;
* the planned divergences: ``cg_refined``'s ``stall_cut`` defaults to
  None, ``cg_refined_static`` reports ``stalled``;
* ``CGResult``'s fields in the reference's order, each in its named field;
* ``Poisson.apply_operator``, ``Poisson.solve`` (with and without
  ``host_loop``) and ``solve_local(host_loop=True)`` against the
  reference's ``tests/test_poisson.py`` cases, float64, to 1e-10.

One reference certified solve (seconds of JAX tracing and compiling), one
reference ``cg_refined_static`` program and host-loop reference solves.
"""

import functools
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import annulus_mesh as jax_annulus
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops.exchange import make_exchange as jax_mex

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models import poisson as poisson_mod
from spectralelementmethod_torch.models.poisson import Poisson

# the solver modules (their packages export the function ``cg`` by name)
jcg = importlib.import_module("spectralelementmethod_tpu.solver.cg")
tcg = importlib.import_module("spectralelementmethod_torch.solver.cg")

torch.set_num_threads(2)

CPU = torch.device("cpu")
SCHEDULE = (64, 32, 32, 64)


def _bc(x, y):
    return 0.2 * (x + y)


# -- cg_refined ---------------------------------------------------------------

def _spd(seed, n=40):
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n), rng.standard_normal(n)


def _kappa6():
    """The reference's kappa = 1e6 matrix and right-hand side."""
    rng = np.random.RandomState(1)
    n = 120
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, 6, n)) @ Q.T
    A = (0.5 * (A + A.T)).astype(np.float32)
    return A, A @ rng.standard_normal(n).astype(np.float32)


def _diag_floor():
    rng = np.random.RandomState(1)
    return (np.linspace(1.0, 1e5, 512).astype(np.float32),
            rng.standard_normal(512).astype(np.float32))


# name -> (operator (matrix or diagonal), b, float64 A_hi scale or None,
# options).  "anchored": the inner operator is 1.1 A_hi, so each cycle
# leaves 1/11 of the residual and only the float64 anchors converge
REFINED = {
    "healthy": (*_spd(0), None, dict(tol=1e-10, max_iter=200)),
    "floor-f32": (*_kappa6(), None, dict(tol=1e-6, max_iter=3000,
                                         cycles=4)),
    "diag-f32": (np.arange(1.0, 65.0, dtype=np.float32),
                 np.ones(64, np.float32), None,
                 dict(tol=1e-6, max_iter=400, block=64, cycles=3)),
    # the reference's default stall_cut, passed to the port by name
    "diag-floor-f32": (*_diag_floor(), None,
                       dict(tol=1e-12, max_iter=4096, block=64, cycles=3,
                            stall_cut=4.0)),
    "anchored": (*_spd(2), 1.1, dict(tol=1e-5, max_iter=200, cycles=8,
                                     dot_weight=np.random.RandomState(3)
                                     .uniform(0.5, 1.0, 40))),
}


def _op(M):
    return (lambda x: M @ x) if M.ndim == 2 else (lambda x: M * x)


@functools.lru_cache(maxsize=None)
def _refined(name):
    """(reference, port) results of one ``cg_refined`` case, each package
    with its own defaults."""
    Mat, b, hi, kw = REFINED[name]
    out = []
    for lib, arr in ((jcg, jnp.asarray), (tcg, torch.as_tensor)):
        k = {key: arr(v) if isinstance(v, np.ndarray) else v
             for key, v in kw.items()}
        A = _op(arr(Mat))
        if hi is not None:
            k.update(A_hi=A)
            A = _op(arr(hi * Mat))
        out.append(lib.cg_refined(A, arr(b), **k))
    return out


@pytest.mark.parametrize("name", sorted(REFINED))
def test_cg_refined_matches_reference(name):
    ref, res = _refined(name)
    f64 = REFINED[name][0].dtype == np.float64
    assert isinstance(res.cycle_resnorms, tuple)
    assert len(res.cycle_resnorms) == len(ref.cycle_resnorms)
    assert res.converged == bool(ref.converged)
    if f64:
        assert res.iterations == ref.iterations
        assert res.issued == ref.issued
        assert res.stalled == ref.stalled
        np.testing.assert_allclose(res.cycle_resnorms, ref.cycle_resnorms,
                                   rtol=1e-3)
        np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0,
                                   atol=1e-8)
    else:
        # float32 recursions round differently in the two packages: each
        # cycle's true residual within 2x
        ratio = np.asarray(res.cycle_resnorms) / np.asarray(ref.cycle_resnorms)
        assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    Mat, b, _, kw = REFINED[name]
    if name == "floor-f32":
        # the reference's bar: the refinement gets past the float32 floor
        rn = np.linalg.norm(b - _op(Mat)(res.x.numpy()))
        assert res.converged and rn <= 1.01e-6 * np.linalg.norm(b)
    if name == "diag-floor-f32":
        # the reference's bars: unconverged, the budget bounded by the
        # cut; the stall flag follows the port's own last cycle
        assert not res.converged and res.issued < 3 * 4096
        last = np.asarray(res.cycle_resnorms[-2:]) ** 2
        assert res.stalled == (len(last) == 2 and last[1] > 0.25 * last[0])
    if name == "anchored":
        assert res.x.dtype == torch.float64 and len(res.cycle_resnorms) > 2


def test_cg_refined_stall_cut_defaults_to_none():
    """Planned divergence (ADVICE): the reference's default stall_cut=4.0
    cuts an honestly but slowly converging ladder; the port's None does
    not.  Unpreconditioned CG on 400 eigenvalues over six decades."""
    ref_default = inspect.signature(jcg.cg_refined).parameters["stall_cut"]
    assert ref_default.default == 4.0
    assert inspect.signature(tcg.cg_refined).parameters[
        "stall_cut"].default is None
    d = torch.as_tensor(np.logspace(0, 6, 400))
    b = torch.ones(400, dtype=torch.float64)
    kw = dict(tol=1e-4, max_iter=4000, cycles=1)
    slow = tcg.cg_refined(_op(d), b, **kw)
    cut = tcg.cg_refined(_op(d), b, stall_cut=4.0, **kw)
    assert slow.converged and not slow.stalled
    assert cut.stalled and not cut.converged and cut.issued < slow.issued


# -- cg_refined_static --------------------------------------------------------

def _models(dtype):
    """(reference, port) Poisson models of the reference's certified 8x7
    p = 6 problem."""
    out = []
    for P, D, rect, basis in ((JaxPoisson, JaxDisc, jax_rect, jax_basis),
                              (Poisson, Discretization, rectangle_mesh,
                               gll_basis_2d)):
        prob = P(D(rect(8, 7, 6), basis(6)), dtype=dtype)
        prob.set_dirichlet("ebc", _bc)
        out.append(prob)
    return out


@functools.lru_cache(maxsize=None)
def _static_pair(tol):
    """Both packages' ``cg_refined_static`` with float64 inner segments on
    the float64 model's masked operator, Jacobi and the weighted norm."""
    jp, tp = _models(np.float64)
    jp._exchange = jax_mex(jp.disc, fused_pad=True)
    jp._op_cache = {}
    jc = jp._local_setup("jacobi", "auto", None, "ne")
    jex = jc["ex"]
    u_d = np.where(jp._dirichlet_mask, jp._dirichlet_vals, 0.0)
    r = jnp.where(jc["free_local"], jc["to_local"](np.asarray(jp._b))
                  - jc["A_raw"](jc["to_local"](u_d)), 0.0)
    ref = jcg.cg_refined_static(
        jc["A"], r, A_hi=jc["A"], M=jc["M"], tol=tol,
        dot_weight=jex._weights_as(np.float64, transposed=True),
        dtype=jnp.float64)
    tc = tp._local_setup(CPU)
    tex = tc["ex"]
    r = torch.where(tc["free_local"], tc["to_local"](tp._b)
                    - tc["A_raw"](tc["to_local"](u_d)), 0.0)
    res = tcg.cg_refined_static(tc["A"], r, A_hi=tc["A"], M=tc["M"], tol=tol,
                                dot_weight=tex.weights_T(torch.float64, CPU),
                                dtype=torch.float64)
    return (ref, jex), (res, tex)


def test_cg_refined_static_matches_reference_in_float64():
    (ref, jex), (res, tex) = _static_pair(1e-2)
    assert res.iterations == int(ref.iterations)
    assert res.issued == int(ref.issued)
    assert res.converged == bool(ref.converged)
    assert len(res.cycle_resnorms) == len(SCHEDULE)
    # the skip pattern: a skipped segment repeats the last value
    skips = [a == b for a, b in zip(res.cycle_resnorms[1:],
                                    res.cycle_resnorms)]
    assert skips == [a == b for a, b in zip(ref.cycle_resnorms[1:],
                                            ref.cycle_resnorms)]
    np.testing.assert_allclose(res.cycle_resnorms, ref.cycle_resnorms,
                               rtol=1e-6)
    x = tex.global_from_local_T(res.x.numpy())
    x_ref = jex.global_from_local_T(np.asarray(ref.x))
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-10)
    assert res.x.dtype == torch.float64
    # two segments run, two skipped
    assert res.issued == 96 and res.converged and skips == [False, True, True]


def test_cg_refined_static_reports_a_stall():
    """Planned divergence (ADVICE): the reference's ``stalled`` cannot be
    true.  A = 3 A_hi on a diagonal operator leaves two thirds of the
    residual after each segment (rn2 shrinks 2.25x, not 4x), so a tight
    tolerance is out of reach: the port reports the stall."""
    d = np.linspace(1.0, 10.0, 64)
    b = np.ones(64)
    out = []
    for lib, arr, dt in ((jcg, jnp.asarray, jnp.float64),
                         (tcg, torch.as_tensor, torch.float64)):
        dd = arr(d)
        out.append(lib.cg_refined_static(
            lambda x: 3.0 * dd * x, arr(b), A_hi=lambda x: dd * x,
            tol=1e-10, dtype=dt))
    ref, res = out
    assert not bool(ref.converged) and not ref.stalled
    assert not res.converged and res.stalled
    assert res.issued == int(ref.issued) == sum(SCHEDULE)
    np.testing.assert_allclose(res.cycle_resnorms, ref.cycle_resnorms,
                               rtol=1e-6)


# -- solve_local(certify=True) ------------------------------------------------

@functools.lru_cache(maxsize=None)
def _certified():
    """The reference's and the port's certified solves of the float32
    model (pmg), and an independent float64 solve."""
    jp, tp = _models(np.float32)
    ref = jp.solve_local(tol=1e-6, precond="pmg", certify=True)
    res = tp.solve_local(tol=1e-6, precond="pmg", certify=True, device="cpu")
    _, t64 = _models(np.float64)
    exact = t64.solve_local(tol=1e-11, device="cpu")
    return ref, res, exact, tp


def _segments_run(issued):
    return int(np.searchsorted(np.cumsum(SCHEDULE), issued) + 1)


def test_certified_solve_matches_reference():
    ref, res, exact, _ = _certified()
    assert bool(ref.cg.converged) and res.cg.converged
    assert not res.cg.stalled and not ref.cg.stalled
    assert _segments_run(res.cg.issued) == _segments_run(ref.cg.issued)
    ratio = np.asarray(res.cg.cycle_resnorms) / np.asarray(
        ref.cg.cycle_resnorms)
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    assert res.u.dtype == np.float32 and res.cg.x.dtype == torch.float64
    scale = np.abs(exact.u).max()
    for u in (res.u, ref.u):
        assert np.abs(np.asarray(u, np.float64) - exact.u).max() / scale \
            < 1e-4


def test_repeat_certified_solve_is_bit_for_bit():
    _, first, _, tp = _certified()
    again = tp.solve_local(tol=1e-6, precond="pmg", certify=True,
                           device="cpu")
    assert np.array_equal(again.u, first.u)
    assert torch.equal(again.cg.x, first.cg.x)
    assert again.cg.cycle_resnorms == first.cg.cycle_resnorms
    # the float64 operator and the seed are built once
    assert tp._op_cache[("A_hi", "ne", "cpu")]._backend == "xla"
    assert set(tp._bc_cache) == {"cpu"}


@pytest.mark.parametrize("change", ["dirichlet", "neumann"])
def test_bc_change_invalidates_the_certified_seed(change):
    def apply(p):
        if change == "dirichlet":
            p.set_dirichlet("ebc", lambda x, y: 1.0 - 0.3 * x)
        else:
            p.set_neumann("nbc", 0.5)

    tp = _models(np.float32)[1]
    before = tp.solve_local(tol=1e-6, certify=True, device="cpu")
    apply(tp)
    assert not tp._bc_cache
    after = tp.solve_local(tol=1e-6, certify=True, device="cpu")
    fresh = _models(np.float32)[1]
    apply(fresh)
    want = fresh.solve_local(tol=1e-6, certify=True, device="cpu")
    assert not np.array_equal(after.u, before.u)
    assert np.array_equal(after.u, want.u)


def test_certify_refuses_host_loop():
    jp, tp = _models(np.float32)
    for call in (lambda: jp.solve_local(tol=1e-6, host_loop=True,
                                        certify=True),
                 lambda: tp.solve_local(tol=1e-6, host_loop=True,
                                        certify=True, device="cpu")):
        with pytest.raises(ValueError, match="host_loop"):
            call()


def test_certify_on_a_float64_model_does_nothing():
    tp = _models(np.float64)[1]
    plain = tp.solve_local(tol=1e-10, device="cpu")
    cert = tp.solve_local(tol=1e-10, certify=True, device="cpu")
    assert np.array_equal(cert.u, plain.u)
    assert cert.cg.cycle_resnorms == () and cert.cg.issued == plain.cg.issued
    # host_loop is allowed there, as in the reference
    hl = tp.solve_local(tol=1e-10, certify=True, host_loop=True,
                        device="cpu")
    assert np.abs(hl.u - plain.u).max() < 1e-10


def test_certify_ignores_the_fused_options():
    _, first, _, tp = _certified()
    again = tp.solve_local(tol=1e-6, precond="pmg", certify=True,
                           cg_kernel="fused1", p_dtype=torch.bfloat16,
                           defer_x=8, max_iter=1, device="cpu")
    assert np.array_equal(again.u, first.u)


def test_no_host_ladder_in_the_hbm_regime(monkeypatch):
    """Deliberate divergence: the reference switches the certified solve
    to ``cg_refined`` on its XLA operator past ``hbm_residency_regime``
    (a TPU compile limit); the port runs ``cg_refined_static`` on the
    fused operator at every size."""
    _, first, _, _ = _certified()
    tp = _models(np.float32)[1]

    def refuse(*a, **k):
        raise AssertionError("cg_refined called")

    monkeypatch.setattr(tcg, "hbm_residency_regime", lambda *a, **k: True)
    monkeypatch.setattr(poisson_mod, "hbm_residency_regime",
                        lambda *a, **k: True)
    monkeypatch.setattr(tcg, "cg_refined", refuse)
    sol = tp.solve_local(tol=1e-6, precond="pmg", certify=True,
                         device="cpu")
    assert np.array_equal(sol.u, first.u)
    assert tp._local_setup(CPU)["A"]._backend == "fused"


# -- CGResult -----------------------------------------------------------------

def test_cgresult_fields_follow_the_reference():
    assert tcg.CGResult._fields == jcg.CGResult._fields


def _fused_result():
    tp = _models(np.float32)[1]
    ctx = tp._local_setup(CPU)
    kA, kB = ctx["A"].fused_cg_kernels()
    inv, w = tp._fused_cg_operands(ctx["ex"], ctx["free_np"], None, CPU)
    return tcg.cg_fused(kA, kB, ctx["free_local"].float(), inv=inv,
                        w_free=w, tol=1e-4, max_iter=128)


@pytest.mark.parametrize("solver", ["cg", "cg_fused", "cg_refined"])
def test_cgresult_named_fields(solver):
    if solver == "cg":
        # the slow ladder of test_cg_refined_stall_cut_defaults_to_none
        res = tcg.cg(_op(torch.as_tensor(np.logspace(0, 6, 400))),
                     torch.ones(400, dtype=torch.float64), tol=1e-4,
                     max_iter=4000, stall_cut=4.0)
        assert res.stalled is True and res.cycle_resnorms == ()
    elif solver == "cg_fused":
        res = _fused_result()
        assert res.stalled is False and res.cycle_resnorms == ()
    else:
        res = _refined("diag-floor-f32")[1]
        assert len(res.cycle_resnorms) == 3
        assert all(isinstance(v, float) for v in res.cycle_resnorms)
        assert isinstance(res.stalled, bool)


# -- Poisson's global-vector entry points -------------------------------------

def _case(pkg, name):
    """The reference's ``tests/test_poisson.py`` problems, float64."""
    rect, ann, D, B, P = ((jax_rect, jax_annulus, JaxDisc, jax_basis,
                           JaxPoisson) if pkg == "jax"
                          else (rectangle_mesh, annulus_mesh, Discretization,
                                gll_basis_2d, Poisson))
    if name == "neumann":
        prob = P(D(rect(3, 3, 4), B(4)), forcing=-4.0)
        prob.set_dirichlet("ebc", lambda x, y: x**2 + y**2)
        prob.set_neumann("nbc", 2.0)
    else:   # "annulus": Laplace, Dirichlet 0 and 1, natural on the axis
        prob = P(D(ann(order=8, n_theta=6, n_r=8, r_outer=10.0,
                       progression=1.3), B(8)), forcing=0.0)
        prob.set_dirichlet("sphere", 0.0)
        prob.set_dirichlet("shell", 1.0)
    return prob


CASES = ("neumann", "annulus")


@functools.lru_cache(maxsize=None)
def _global_pair(name):
    ref = _case("jax", name)
    return ref, ref.solve(tol=1e-14, host_loop=True), _case("torch", name)


@pytest.mark.parametrize("name", CASES)
def test_apply_operator_matches_reference(name):
    ref, _, port = _global_pair(name)
    u = np.random.RandomState(5).standard_normal(port.disc.n_nodes)
    got = port.apply_operator(u, device="cpu")
    want = np.asarray(ref.apply_operator(u))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["ladder", "host_loop", "local-host_loop"])
@pytest.mark.parametrize("name", CASES)
def test_global_solve_matches_reference(name, mode):
    _, s_ref, port = _global_pair(name)
    if mode == "local-host_loop":
        sol = port.solve_local(tol=1e-14, host_loop=True, device="cpu")
    else:
        sol = port.solve(tol=1e-14, host_loop=mode == "host_loop",
                         device="cpu")
        # the same iterations on the same global system (cg freezes at the
        # exact stopping iteration, cg_host stops there)
        assert int(sol.cg.iterations) == int(s_ref.cg.iterations)
    assert bool(sol.cg.converged)
    assert np.abs(sol.u - np.asarray(s_ref.u)).max() < 1e-10
