"""The port's curved-mesh (general-factor) path against the JAX package's,
on the CPU (plain versions of the kernels).

Two meshes with genuinely non-affine factors: the reference's own general
problem (``rectangle_mesh(16, 8, 3)`` with the coefficient ``1 + x^2 y^2``,
``tests/test_fused_general.py``) and a small polar half-annulus at p = 3.
Both packages see the same operator state
(``interop.general_operator_from_numpy``) and the same numpy inputs:

* the general apply (one RHS and a stack of three) against the reference's
  XLA general apply, to 1e-5 of its max;
* the general kernel A (f32 and bf16 directions, one RHS and three)
  against ``make_fused_cg_kernels_general(..., interpret=True)`` at the
  reference's bars (p' 1e-6, Ap' 1e-5 of max, partials rtol 1e-5; with
  bf16 directions the reference's kernel runs its bf16x3 "high" products,
  held in ``test_fused_general.py`` to 5e-4 of max);
* float64 ``solve_local`` and ``solve_local_batch``: the reference's
  iterations exactly and its solutions to 1e-10;
* the fused f32 and bf16-direction solves at the reference's bars (1e-4
  and 1e-3 of max against plain CG);
* structure routing, the error paths, and the per-element affine test.
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
from spectralelementmethod_tpu.mesh import annulus_mesh as jax_annulus
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.ops.exchange import RollExchange
from spectralelementmethod_tpu.ops.pallas_kernels import (
    make_fused_cg_kernels_general)

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import general_operator_from_numpy
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import exchange, kernels, sumfac

from jax_reference import jit_dss_T

torch.set_num_threads(2)

ANNULUS = dict(n_theta=12, n_r=6, r_inner=1.0, r_outer=2.0, progression=1.0,
               node_placement="polar")
MESHES = ("rect_coef", "annulus")
FORCINGS = [1.0, lambda x, y: x + y, lambda x, y: np.sin(x) * y]
# the float64 solves: the two packages' iterates agree to round-off at any
# tolerance once their iteration counts agree; 1e-6 keeps the reference's
# CG ladder at two jitted blocks (64 + 128 iterations issued)
TOL64 = 1e-6


def _coefficient(x, y):
    return 1 + x**2 * y**2


def _build(name, pkg, dtype):
    """One of the two curved problems in one package (``pkg`` "jax" or
    "torch"), with its Dirichlet data."""
    rect, ann, basis, D, P = (
        (jax_rect, jax_annulus, jax_basis, JaxDisc, JaxPoisson)
        if pkg == "jax" else
        (rectangle_mesh, annulus_mesh, gll_basis_2d, Discretization, Poisson))
    if name == "rect_coef":
        prob = P(D(rect(16, 8, 3), basis(3)), coefficient=_coefficient,
                 forcing=lambda x, y: np.sin(np.pi * x) * np.cos(np.pi * y),
                 dtype=dtype)
        prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    else:
        prob = P(D(ann(3, **ANNULUS), basis(3)), dtype=dtype)
        prob.set_dirichlet("sphere", 0.2)
        prob.set_dirichlet("shell", lambda x, y: 0.1 * x)
    return prob


@functools.lru_cache(maxsize=None)
def _pair(name, dtype):
    """The same problem in both packages, built once per module (a solve
    changes only a problem's caches)."""
    return _build(name, "jax", dtype), _build(name, "torch", dtype)


@functools.lru_cache(maxsize=None)
def _jax_state(name, pad=0):
    """The JAX side's f32 operator state: (problem, exchange, Gf, Dhat)."""
    prob = _pair(name, np.float32)[0]
    disc = prob.disc
    ex = RollExchange(disc, pad_to=disc.E + pad if pad else None)
    assert not (ex.n_edge_tail or ex.n_vert_tail)
    Gf = jax_sumfac._pad_factors_to_exchange(
        prob._G_host.reshape(disc.E, 3, -1).astype(np.float32), ex)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    return prob, ex, Gf, Dhat


def _port(name, p_dtype=None, pad=0, real_rows=False):
    """The port's operator from the JAX side's arrays (interop); with
    ``real_rows`` only the real elements' factors are handed over."""
    prob, ex, Gf, Dhat = _jax_state(name, pad)
    return general_operator_from_numpy(
        Gf[:ex.E_real] if real_rows else Gf, Dhat, ex.hier, ex.edge_classes,
        ex.vert_classes, ex.gather_hier, ex._weights_np,
        prob.operator_diagonal(), ~prob._dirichlet_mask, ex.E_real,
        device="cpu", p_dtype=p_dtype)


def _xla_apply(name, pad=0):
    _, ex, Gf, Dhat = _jax_state(name, pad)
    return jax_sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, vector_layout="ne", backend="xla", structure="general")


def _consistent(ex, rng, k=1, lo=None, hi=None):
    """Random consistent float32 L-vectors, a (k n, E) stack."""
    def one():
        shp = (ex.n_loc, ex.E)
        v = (rng.standard_normal(shp) if lo is None
             else rng.uniform(lo, hi, shp))
        return np.asarray(jit_dss_T(ex)(jnp.asarray(
            v.astype(np.float32))))
    return np.concatenate([one() for _ in range(k)], axis=0)


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("k", [1, 3])
def test_general_apply_plain_matches_xla(name, k):
    op = _port(name)
    A_xla = _xla_apply(name)
    n, E = op.A.n_loc, op.plan.E
    U = np.random.RandomState(7).standard_normal((k * n, E)).astype(
        np.float32)
    A_xla = jax.jit(A_xla)               # one program, not one per op
    ref = np.concatenate([np.asarray(A_xla(jnp.asarray(U[j * n:(j + 1) * n])))
                          for j in range(k)])
    if k == 1:
        got = kernels.general_apply_dss(torch.tensor(U), op.A.gT, op.A.Dh,
                                        op.A.hier, op.plan)
    else:
        got = op.A_raw.stacked(k)(torch.tensor(U).view(k, n, E))
    got = got.reshape(k * n, E).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
    assert kernels.launch_counts()["general_apply_dss"] == 0
    assert kernels.launch_counts()["general_apply_dss_batched"] == 0


def test_interop_takes_padded_arrays():
    """The JAX package's lane-padded factor slabs and tables, as they
    are or with only the real elements' factors, give the reference's
    apply on the padded exchange."""
    A_xla = _xla_apply("rect_coef", pad=128)
    ex = _jax_state("rect_coef", 128)[1]
    u = np.random.RandomState(2).standard_normal((ex.n_loc, ex.E)).astype(
        np.float32)
    u[:, ex.E_real:] = 0.0
    ref = np.asarray(A_xla(jnp.asarray(u)))
    for real_rows in (False, True):
        op = _port("rect_coef", pad=128, real_rows=real_rows)
        assert op.plan.E == ex.E == ex.E_real + 128
        got = op.A_raw(torch.tensor(u)).numpy()
        assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cg_kernel_a_general_plain_matches_pallas(bf16, k):
    prob, ex, Gf, Dhat = _jax_state("rect_coef")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    op = _port("rect_coef", tdt if bf16 else None)
    kA, _, _ = make_fused_cg_kernels_general(
        ex, Gf, Dhat, n_rhs=k, precision="high" if bf16 else "highest",
        p_dtype=jdt if bf16 else None, interpret=True)
    rng = np.random.RandomState(21)
    r, p, x = (_consistent(ex, rng, k) for _ in range(3))
    inv = _consistent(ex, rng, lo=0.5, hi=1.5)
    betas = np.array([0.7, 0.0, 1.2][:k], np.float32)
    alphas = np.array([0.4, 0.9, 0.0][:k], np.float32)
    sc = ((float(betas[0]), float(alphas[0])) if k == 1
          else (betas, alphas))
    ref = kA(jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt),
             jnp.asarray(x), *(jnp.asarray(s) for s in sc))
    p_ref, Ap_ref, x_ref, d_ref = (np.asarray(v, np.float32) for v in ref)
    kA_t, kB_t = op.fused_kernels(k)
    assert kA_t.n_rhs == k and not kA_t.defer_x
    assert kB_t is (kernels.cg_kernel_b if k == 1
                    else kernels.cg_kernel_b_batched)
    got = kA_t(torch.tensor(r), torch.tensor(p).to(tdt),
               torch.tensor(inv).to(tdt), torch.tensor(x),
               *(torch.tensor(s) for s in sc))
    p_got, Ap, x_got, dparts = got
    assert p_got.dtype == tdt
    np.testing.assert_allclose(x_got.numpy(), x_ref, rtol=1e-6, atol=1e-6)
    if bf16:
        # both round the same f32 value to bf16: at most one bf16 ulp
        np.testing.assert_allclose(p_got.float().numpy(), p_ref,
                                   rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(p_got.numpy(), p_ref, rtol=1e-6,
                                   atol=1e-6)
    # the reference's bf16 mode multiplies in bf16x3 ("high")
    bar = 5e-4 if bf16 else 1e-5
    assert np.abs(Ap.numpy() - Ap_ref).max() / np.abs(Ap_ref).max() < bar
    d_got = dparts.reshape(-1, k).sum(0).numpy()
    np.testing.assert_allclose(d_got, d_ref.reshape(-1, k).sum(0),
                               rtol=bar)
    # the pre-DSS identity: each RHS's partials sum to <p', A p'>
    for j in range(k):
        sl = slice(j * ex.n_loc, (j + 1) * ex.n_loc)
        dot = float(op.dot_T(p_got[sl].float(), Ap[sl]))
        assert abs(d_got[j] - dot) / abs(dot) < 1e-5
    assert kernels.launch_counts()["cg_kernel_a_general"] == 0
    assert kernels.launch_counts()["cg_kernel_a_general_batched"] == 0


@pytest.mark.parametrize("name", MESHES)
def test_solve_local_float64_matches_jax(name):
    ref, port = _pair(name, np.float64)
    s_ref = ref.solve_local(tol=TOL64)
    s = port.solve_local(tol=TOL64, device="cpu")
    assert bool(s.cg.converged)
    assert int(s.cg.iterations) == int(s_ref.cg.iterations)
    assert s.cg.issued == s_ref.cg.issued
    assert np.abs(s.u - s_ref.u).max() < 1e-10
    # the port solved through the general apply
    assert port._local_setup(torch.device("cpu"))["A"].structure == \
        "general"


@pytest.mark.parametrize("name", MESHES)
def test_solve_local_batch_float64_matches_jax(name):
    ref, port = _pair(name, np.float64)
    s_ref = ref.solve_local_batch(FORCINGS, tol=TOL64)
    s = port.solve_local_batch(FORCINGS, tol=TOL64, device="cpu")
    assert bool(s.cg.converged.all())
    np.testing.assert_array_equal(s.cg.iterations.numpy(),
                                  np.asarray(s_ref.cg.iterations))
    assert s.cg.issued == s_ref.cg.issued
    assert np.abs(s.u - s_ref.u).max() < 1e-10
    assert all(n == 0 for n in kernels.launch_counts().values())


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16p"])
def test_fused_solves_meet_reference_bars(name, bf16):
    """``tests/test_fused_general.py``: fused against plain CG at tol 1e-5,
    1e-4 of max (bf16 directions: 1e-3), one RHS and a batch."""
    port = _pair(name, np.float32)[1]
    kw = dict(tol=1e-5, device="cpu")
    fkw = dict(kw, cg_kernel="fused",
               p_dtype=torch.bfloat16 if bf16 else None)
    bar = 1e-3 if bf16 else 1e-4
    plain = port.solve_local(cg_kernel="plain", **kw)
    fused = port.solve_local(**fkw)
    assert bool(fused.cg.converged)
    assert np.abs(fused.u - plain.u).max() / np.abs(plain.u).max() < bar
    fs = FORCINGS[:2] if bf16 else FORCINGS
    plain_b = port.solve_local_batch(fs, cg_kernel="plain", **kw)
    fused_b = port.solve_local_batch(fs, **fkw)
    assert bool(fused_b.cg.converged.all())
    assert (np.abs(fused_b.u - plain_b.u).max()
            / np.abs(plain_b.u).max() < bar)
    # one forcing through the batched pair (k = 1)
    fused_1 = port.solve_local_batch(fs[:1], **fkw)
    assert bool(fused_1.cg.converged.all())
    assert (np.abs(fused_1.u[0] - plain_b.u[0]).max()
            / np.abs(plain_b.u[0]).max() < bar)
    # the general kernel pair ran, and no deferred slots
    kA = port._op_cache[("cg_fused", str(fkw["p_dtype"]), False, "cpu")][0]
    assert not kA.offers_defer_x and kA.n_rhs == 1


def test_structure_routing_matches_jax():
    """The same operator structure in both packages for every
    ``structure`` on an affine mesh and on the two curved ones, and the
    same fused route (the reference's ``_build_fused_cg`` tests the f32
    factors for affinity)."""
    cpu = torch.device("cpu")
    cases = [(name, _jax_state(name)) for name in MESHES]
    aff_disc = JaxDisc(jax_rect(16, 8, 3), jax_basis(3))
    aff = JaxPoisson(aff_disc, dtype=np.float32)
    aff_ex = RollExchange(aff_disc)
    cases.append(("rect", (aff, aff_ex, aff._G_host.reshape(aff_disc.E, 3, -1),
                           jax_sumfac.make_stacked_derivative(
                               aff._D0_host, aff._D1_host))))
    for name, (prob, ex, Gf, Dhat) in cases:
        port = (Poisson(Discretization(rectangle_mesh(16, 8, 3),
                                       gll_basis_2d(3)), dtype=np.float32)
                if name == "rect" else _pair(name, np.float32)[1])
        t_ex = exchange.make_exchange(port.disc)
        t_Gf = port._G_host.reshape(port.disc.E, 3, -1)
        t_Dhat = sumfac.make_stacked_derivative(port._D0_host,
                                                port._D1_host)
        W = ex.disc.basis.weight_grid().reshape(-1)
        affine = jax_sumfac.affine_factorization(Gf, W)[1]
        for structure in ("auto", "general", "affine"):
            if structure == "affine" and not affine:
                for build in (
                        lambda: jax_sumfac.make_local_laplacian_operator(
                            ex, Gf, Dhat, vector_layout="ne",
                            backend="xla", structure=structure),
                        lambda: sumfac.make_local_laplacian_operator(
                            t_ex, t_Gf, t_Dhat, device="cpu",
                            structure=structure),
                        lambda: sumfac.make_multi_rhs_laplacian_T(
                            t_ex, t_Gf, t_Dhat, 2, device="cpu",
                            structure=structure),
                        lambda: port.solve_local(structure=structure,
                                                 device="cpu")):
                    with pytest.raises(ValueError, match="not affine"):
                        build()
                continue
            A_j = jax_sumfac.make_local_laplacian_operator(
                ex, Gf, Dhat, vector_layout="ne", backend="xla",
                structure=structure)
            A_t = sumfac.make_local_laplacian_operator(
                t_ex, t_Gf, t_Dhat, device="cpu", structure=structure)
            assert A_t.structure == A_j._structure, (name, structure)
            B_t = sumfac.make_multi_rhs_laplacian_T(
                t_ex, t_Gf, t_Dhat, 2, device="cpu", structure=structure)
            assert (B_t.structure, B_t.n_rhs) == (A_j._structure, 2)
            ctx = port._local_setup(cpu, structure)
            assert ctx["A"].structure == ctx["A_raw"].structure \
                == A_j._structure
        # the fused route follows the mesh whatever structure says
        fop = port._local_setup(cpu)["A"]
        assert fop.structure == ("affine" if affine else "general")
        kA, _ = fop.fused_cg_kernels()
        assert getattr(kA, "offers_defer_x", True) == affine


def test_defer_x_and_structure_error_paths():
    """``tests/test_fused_general.py``: defer_x on a curved mesh raises for
    an explicit request (solve_local, solve_local_batch and cg_fused),
    an auto-resolved one is dropped; an unknown structure
    raises."""
    from spectralelementmethod_torch.solver.cg import cg_fused

    port = _pair("rect_coef", np.float32)[1]
    with pytest.raises(ValueError, match="defer_x"):
        port.solve_local(tol=1e-5, cg_kernel="fused", defer_x=8,
                         device="cpu")
    with pytest.raises(ValueError, match="defer_x"):
        port.solve_local_batch(FORCINGS[:2], tol=1e-5, cg_kernel="fused",
                               p_dtype=torch.bfloat16, defer_x=4,
                               device="cpu")
    sol = port.solve_local_batch(FORCINGS[:2], tol=1e-5, cg_kernel="fused",
                                 p_dtype=torch.bfloat16, defer_x="auto",
                                 device="cpu")
    assert bool(sol.cg.converged.all())
    op = _port("rect_coef")
    with pytest.raises(ValueError, match="defer_x"):
        op.fused_kernels(defer_x=True)
    r = torch.zeros((op.A.n_loc, op.plan.E))
    with pytest.raises(ValueError, match="defer_x"):
        cg_fused(op.kA, op.kB, r, inv=r, w_free=r, defer_x=4)
    with pytest.raises(ValueError, match="structure"):
        port.solve_local(structure="curved", device="cpu")


def test_affine_detection_uses_each_elements_own_scale():
    """A deliberate divergence from the reference: one stretched element
    (large factors) must not let a slightly curved one pass as affine.
    The reference's global scale accepts this factor field; the port
    routes it to the general apply."""
    disc = Discretization(rectangle_mesh(4, 2, 2), gll_basis_2d(2))
    ex = exchange.make_exchange(disc)
    W = disc.basis.weight_grid().reshape(-1)
    a = np.tile([1.0, 0.1, 2.0], (disc.E, 1))
    a[0] *= 1e6                                  # the stretched element
    Gf = a[:, :, None] * W
    Gf[3, 0] *= 1 + 1e-9 * np.arange(W.size)     # slightly curved
    assert jax_sumfac.affine_factorization(Gf, W)[1]
    assert not sumfac.affine_factorization(Gf, W)[1]
    assert sumfac.affine_factorization(np.delete(Gf, 3, axis=0), W)[1]
    Dhat = sumfac.make_stacked_derivative(disc.basis.subbases[0].D1,
                                          disc.basis.subbases[1].D1)
    A = sumfac.make_local_laplacian_operator(ex, Gf, Dhat, device="cpu")
    assert isinstance(A, sumfac.GeneralLaplacianT)
    # padding elements (all-zero factors) stay affine
    Gp = np.concatenate([np.delete(Gf, 3, axis=0), np.zeros_like(Gf[:2])])
    assert sumfac.affine_factorization(Gp, W)[1]
