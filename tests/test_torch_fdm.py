"""The port's FDM additive-Schwarz preconditioner (``solver/fdm.py``, 2D)
and the rest of Poisson's 2D solve surface against the JAX package, on the
CPU (plain versions of the kernels; the reference computes fdm with XLA
matmuls, so no interpret mode is needed).

* ``gll_fdm_eig`` at p = 2..8, to 1e-12;
* the fdm ``M`` on ``rectangle_mesh(8, 8, 6)`` in float64, both layouts,
  masked and unmasked, against the reference's ``M`` to 1e-12, and its
  symmetry in the weighted inner product (``tests/test_fdm.py``'s
  identity), on a stack too;
* float64 solves with the reference's iterations exactly and its solution
  to 1e-10: ``precond="fdm"`` on both layouts (fewer than 0.7x Jacobi's
  iterations), ``vector_layout="en"`` with Jacobi, the fdm batch on the
  curved annulus of ``tests/test_cg_batched.py`` (1e-8) and the ``en``
  batch through ``cg_batched``'s per-RHS mode;
* pmg with ``smoother="fdm"`` (the reference's ``p_coarse=2`` case of
  ``tests/test_pmg.py``): its iterations and at most a quarter of
  Jacobi's;
* ``compute_dtype=torch.bfloat16``: each ``"xla"`` operator against the
  reference's bf16 operator and within 0.03 of max of the float32 one;
  the precision tiers bit for bit on the apply kernels' plain versions;
* ``certify=True`` with fdm on a small float32 model: the reference's
  segments, iterations and ``converged``, and the float64 residual
  recomputed apart;
* the options that still raise: fused CG with fdm, ``en`` or a
  ``compute_dtype``, pmg on ``en``, an unknown tier; and the 3D factory
  (item 9, ported since) against the reference's M.

Nine reference solves in all, each seconds of JAX tracing and compiling.
"""

import functools
import inspect

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
from spectralelementmethod_tpu.ops.exchange import make_exchange as jax_mex
from spectralelementmethod_tpu.solver import fdm as jax_fdm

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels, sumfac
from spectralelementmethod_torch.parallel import device_mesh, halo
from spectralelementmethod_torch.solver import cg as port_cg
from spectralelementmethod_torch.solver import fdm

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL64 = 1e-10
PKGS = {"jax": (JaxPoisson, JaxDisc, jax_rect, jax_annulus, jax_basis),
        "torch": (Poisson, Discretization, rectangle_mesh, annulus_mesh,
                  gll_basis_2d)}
ANNULUS = dict(order=6, n_theta=4, n_r=4, r_outer=4.0)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _forcing(x, y):
    return 1.0 + x * y


def _model(pkg, kind="rect", dtype=np.float64):
    """One package's Poisson model: ``rect`` — ``rectangle_mesh(8, 8, 6)``
    with ``1 + x y`` and Dirichlet ``0.1 x + 0.05 y`` on "ebc"; ``annulus``
    — the curved annulus of the reference's batched fdm test; ``pmg`` —
    the reference's ``p_coarse=2`` pmg problem (16 x 16, p = 4)."""
    P, D, rect, ann, basis = PKGS[pkg]
    if kind == "annulus":
        prob = P(D(ann(**ANNULUS), basis(6)), dtype=dtype)
        prob.set_dirichlet("sphere", 0.0)
        prob.set_dirichlet("shell", 1.0)
        return prob
    if kind == "pmg":
        prob = P(D(rect(16, 16, 4), basis(4)), dtype=dtype,
                 forcing=lambda x, y: np.sin(np.pi * x) * np.cos(np.pi * y))
        prob.set_dirichlet("ebc", 0.0)
        prob.set_dirichlet("nbc", 0.0)
        return prob
    prob = P(D(rect(8, 8, 6), basis(6)), forcing=_forcing, dtype=dtype)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    return prob


def _pair(kind="rect", dtype=np.float64):
    """(reference, port) models of one problem, shared by the tests (a
    solve only fills a model's caches)."""
    return _pair_of(kind, np.dtype(dtype).name)


@functools.lru_cache(maxsize=None)
def _pair_of(kind, dtype):
    return _model("jax", kind, dtype), _model("torch", kind, dtype)


@functools.lru_cache(maxsize=None)
def _solved(name):
    """(reference solution, port solution) of one named float64 case."""
    kind, method, kw = {
        "fdm-ne": ("rect", "solve_local", dict(precond="fdm",
                                               vector_layout="ne")),
        "fdm-en": ("rect", "solve_local", dict(precond="fdm",
                                               vector_layout="en")),
        "jacobi-en": ("rect", "solve_local", dict(vector_layout="en")),
        "fdm-batch": ("annulus", "solve_local_batch", dict(precond="fdm")),
        "en-batch": ("rect", "solve_local_batch", dict(vector_layout="en")),
    }[name]
    jp, tp = _pair(kind)
    args = ([[1.0, lambda x, y: x * y]] if kind == "annulus"
            else [_batch_forcings(tp)]) if method == "solve_local_batch" \
        else []
    ref = getattr(jp, method)(*args, tol=1e-11, **kw)
    got = getattr(tp, method)(*args, tol=1e-11, device="cpu", **kw)
    return ref, got


def _batch_forcings(prob):
    """Two nodal forcings: ones and a field from a seed."""
    n = prob.disc.n_nodes
    return np.stack([np.ones(n), np.random.RandomState(5).standard_normal(n)])


# -- gll_fdm_eig and the M apply ----------------------------------------------

@pytest.mark.parametrize("p", range(2, 9))
def test_gll_fdm_eig_matches_reference(p):
    b = gll_basis_2d(p).subbases[0]
    lam, S = fdm.gll_fdm_eig(b.nodes, b.quad_wts, b.D1)
    lam_j, S_j = jax_fdm.gll_fdm_eig(b.nodes, b.quad_wts, b.D1)
    np.testing.assert_allclose(lam, lam_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(S, S_j, rtol=0, atol=1e-12)
    w = np.asarray(b.quad_wts)
    np.testing.assert_allclose(S.T @ np.diag(w) @ S, np.eye(p + 1),
                               atol=1e-12)


def _m_pair(layout, masked):
    """(reference M, port M, exchange pair, free mask) on the rectangle."""
    jp, tp = _pair()
    jex, ex = jax_mex(jp.disc), tp._local_setup(CPU, vector_layout=layout)[
        "ex"]
    assert np.array_equal(np.asarray(jex.hier), np.asarray(ex.hier))
    free = (~tp._dirichlet_mask)[ex.gather_hier]
    if layout == "ne":
        free = np.ascontiguousarray(free.T)
    free = free if masked else None
    Mj = jax_fdm.make_fdm_preconditioner(
        jex, jp._G_host, jp.disc.basis,
        None if free is None else jnp.asarray(free), dtype=np.float64,
        vector_layout=layout)
    Mt = fdm.make_fdm_preconditioner(ex, tp._G_host, tp.disc.basis, free,
                                     dtype=np.float64, vector_layout=layout,
                                     device="cpu")
    return Mj, Mt, ex, free


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layout", ["ne", "en"])
def test_fdm_apply_matches_reference(layout, masked):
    Mj, Mt, ex, free = _m_pair(layout, masked)
    rng = np.random.RandomState(11)
    shape = (ex.n_loc, ex.E) if layout == "ne" else (ex.E, ex.n_loc)
    dss = ex.dss_T if layout == "ne" else ex.dss
    Mj = jax.jit(Mj)                     # one program, not one per op
    for _ in range(2):
        r = dss(torch.as_tensor(rng.standard_normal(shape)))
        got = Mt(r)
        ref = np.asarray(Mj(jnp.asarray(r.numpy())))
        assert got.dtype == torch.float64 and _rel(got, ref) <= 1e-12
    # a (k, ...) stack in one call: each vector as on its own
    R = torch.stack([dss(torch.as_tensor(rng.standard_normal(shape)))
                     for _ in range(3)])
    got = Mt(R)
    for j in range(3):
        assert _rel(got[j], Mt(R[j])) <= 1e-14
    # symmetric in the weighted inner product of consistent L-vectors, and
    # positive on the free set (the reference's tests/test_fdm.py identity)
    w = ex._weights_as(torch.float64, CPU, transposed=layout == "ne")
    for _ in range(3):
        u, v = (dss(torch.as_tensor(rng.standard_normal(shape)))
                for _ in range(2))
        if free is not None:
            u, v = (torch.where(torch.as_tensor(free), t, 0.0)
                    for t in (u, v))
        lhs = float(torch.sum(Mt(u) * v * w))
        rhs = float(torch.sum(u * Mt(v) * w))
        assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
        assert float(torch.sum(Mt(u) * u * w)) > 0.0


# -- float64 solves -----------------------------------------------------------

@pytest.mark.parametrize("name", ["fdm-ne", "fdm-en", "jacobi-en"])
def test_solve_matches_reference(name):
    ref, got = _solved(name)
    assert bool(got.cg.converged) and bool(ref.cg.converged)
    assert int(got.cg.iterations) == int(ref.cg.iterations)
    assert _rel(got.u, ref.u) <= TOL64
    if name.startswith("fdm"):
        _, tp = _pair()
        jac = tp.solve_local(tol=1e-11, vector_layout=name[-2:],
                             device="cpu")
        assert int(got.cg.iterations) < 0.7 * int(jac.cg.iterations)
        assert _rel(got.u, jac.u) <= 1e-9


def test_fdm_and_en_contexts_are_cached_per_layout():
    _solved("fdm-ne"), _solved("fdm-en")
    _, tp = _pair()
    keys = {k for k in tp._op_cache if k[:2] == ("M", "fdm")}
    assert keys == {("M", "fdm", "ne", "cpu"), ("M", "fdm", "en", "cpu")}
    en = tp._local_setup(CPU, vector_layout="en")
    assert en["A"]._backend == "xla" and tuple(en["free_local"].shape) == (
        tp.disc.E, tp.disc.n_loc)
    # "auto" is "ne" on a roll-class exchange, as in the reference
    assert tp._layout("auto") == "ne"


@pytest.mark.parametrize("name", ["fdm-batch", "en-batch"])
def test_batch_matches_reference(name):
    ref, got = _solved(name)
    assert np.asarray(got.cg.converged).all()
    np.testing.assert_array_equal(got.cg.iterations.numpy(),
                                  np.asarray(ref.cg.iterations))
    assert _rel(got.u, ref.u) <= (1e-8 if name == "fdm-batch" else TOL64)


def test_cg_batched_per_rhs_mode_is_the_single_solves():
    """``whole_batch=False``: ``A`` and ``M`` act on one vector each, and
    every RHS takes the iterations and iterate of its own ``cg``."""
    _, tp = _pair()
    ctx = tp._local_setup(CPU, vector_layout="en")
    A, M, free = ctx["A"], ctx["M"], ctx["free_local"]
    w = ctx["ex"]._weights_as(torch.float64, CPU)
    rng = np.random.RandomState(9)
    B = torch.stack([torch.where(free, ctx["ex"].dss(torch.as_tensor(
        rng.standard_normal(tuple(free.shape)))), 0.0) for _ in range(3)])
    B[1] *= 1e-3                     # different scales, different counts
    res = port_cg.cg_batched(A, B, M=M, tol=1e-10, max_iter=500,
                             dot_weight=w)
    for j in range(3):
        one = port_cg.cg(A, B[j], M=M, tol=1e-10, max_iter=500,
                         dot_weight=w)
        assert int(res.iterations[j]) == int(one.iterations)
        assert _rel(res.x[j], one.x) <= 1e-12


def test_pmg_fdm_smoother_matches_reference():
    """The reference's ``p_coarse=2`` fdm-smoother case (float64 model
    and cycle): its iterations and solution, and at most a quarter of
    Jacobi's iterations."""
    jp, tp = _pair("pmg")
    opts = {"pmg": {"p_coarse": 2, "smoother": "fdm",
                    "cycle_dtype": np.float64}}
    ref = jp.solve_local(tol=1e-10, precond=opts, vector_layout="ne")
    got = tp.solve_local(tol=1e-10, precond=opts, device="cpu")
    jac = tp.solve_local(tol=1e-10, device="cpu")
    assert bool(got.cg.converged)
    assert int(got.cg.iterations) == int(ref.cg.iterations)
    assert _rel(got.u, ref.u) <= TOL64
    assert 4 * int(got.cg.iterations) <= int(jac.cg.iterations)
    M = tp._pmg(tp._local_setup(CPU), opts, CPU)
    assert isinstance(M._B_f, fdm.FDMPreconditioner)
    assert M._levels == (4, 2)


# -- compute_dtype and the precision tiers ------------------------------------

def _operators(kind, layout, structure, **kw):
    """(port operator, reference operator, its L-vector shape) of the
    float32 rectangle or annulus, from the same factors."""
    jp, tp = _pair(kind, np.float32)
    ex = tp._local_setup(CPU, vector_layout=layout)["ex"]
    jex = jax_mex(jp.disc)
    Gf = tp._G_host.reshape(tp.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(tp._D0_host, tp._D1_host)
    A = sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, device="cpu", vector_layout=layout,
        structure=structure, backend="xla", **kw)
    Aj = jax_sumfac.make_local_laplacian_operator(
        jex, jnp.asarray(Gf), jnp.asarray(Dhat), backend="xla",
        vector_layout=layout, structure=structure,
        compute_dtype=jnp.bfloat16 if "compute_dtype" in kw else None)
    shape = (ex.n_loc, ex.E) if layout == "ne" else (ex.E, ex.n_loc)
    return A, Aj, shape


@pytest.mark.parametrize("layout", ["ne", "en"])
@pytest.mark.parametrize("kind,structure", [("rect", "affine"),
                                            ("annulus", "general")])
def test_bf16_compute_matches_reference(kind, structure, layout):
    """Rounding to bf16 is exact on both sides; the float32 sums come out in
    another order, which can move a flux across a bf16 rounding boundary on
    the curved mesh: 2e-6 of max (affine), 2e-3 (general).  Within 0.03 of
    max of the float32 apply, the reference's bar."""
    A16, Aj16, shape = _operators(kind, layout, structure,
                                  compute_dtype=torch.bfloat16)
    A32, _, _ = _operators(kind, layout, structure)
    u = np.random.RandomState(2).standard_normal(shape).astype(np.float32)
    got = A16(torch.as_tensor(u))
    ref = np.asarray(jax.jit(Aj16)(jnp.asarray(u)))
    assert got.dtype == torch.float32 and A16._backend == "xla"
    assert _rel(got, ref) <= (2e-6 if structure == "affine" else 2e-3)
    f32 = A32(torch.as_tensor(u))
    assert _rel(got, f32) <= 0.03
    # a k-stack takes the same rounding per RHS
    if layout == "ne":
        U = torch.as_tensor(np.stack([u, 2 * u]))
        assert _rel(A16.stacked(2)(U)[1], A16(U[1])) <= 1e-6


def test_compute_dtype_solves_and_takes_the_xla_operator():
    """A bf16-product solve against the reference's: the bf16 lift
    ``b - A u_d`` loses the stiffness rows' cancellation (both packages'
    solutions sit 47% of max from the float32 one), and the float32 sums'
    order differs, so the iterations agree within 2 and the solutions to
    5e-3 of max (1.1e-3 measured)."""
    jp, tp = _pair("rect", np.float32)
    ref = jp.solve_local(tol=2e-3, compute_dtype=jnp.bfloat16)
    sol = tp.solve_local(tol=2e-3, compute_dtype=torch.bfloat16,
                         device="cpu")
    assert bool(sol.cg.converged) and bool(ref.cg.converged)
    assert abs(int(sol.cg.iterations) - int(ref.cg.iterations)) <= 2
    assert _rel(sol.u, ref.u) <= 5e-3
    ctx = tp._local_setup(CPU, compute_dtype=torch.bfloat16)
    assert ctx["A"]._backend == "xla"
    assert tp._local_setup(CPU)["A"]._backend == "fused"
    batch = tp.solve_local_batch(_batch_forcings(tp), tol=2e-3,
                                 compute_dtype=torch.bfloat16, device="cpu")
    assert np.asarray(batch.cg.converged).all()


@pytest.mark.parametrize("kind", ["rect", "annulus"])
def test_precision_tiers_are_bit_for_bit(kind):
    """Every tier computes true float32: the apply kernels' plain versions
    (one RHS and a stack), the fused CG factories and the sharded
    operators give the same bits at "high" and "default" as at
    "highest"."""
    _, tp = _pair(kind, np.float32)
    ex = tp._local_setup(CPU)["ex"]
    Gf = tp._G_host.reshape(tp.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(tp._D0_host, tp._D1_host)
    rng = np.random.RandomState(4)
    u = torch.as_tensor(rng.standard_normal((ex.n_loc, ex.E)),
                        dtype=torch.float32)
    U = torch.stack([u, -u, 2 * u])
    out = {}
    for tier in ("highest", "high", "default"):
        A = sumfac.make_local_laplacian_operator(ex, Gf, Dhat, device="cpu",
                                                 precision=tier)
        k3 = sumfac.make_multi_rhs_laplacian_T(ex, Gf, Dhat, 3,
                                               device="cpu", precision=tier)
        assert A._backend == "fused" and A.precision == tier
        kA, _ = A.fused_cg_kernels()
        out[tier] = (A(u), k3(U))
        assert kA.precision == "high"
    for tier in ("high", "default"):
        for a, b in zip(out[tier], out["highest"]):
            assert torch.equal(a, b)
    if kind == "rect":
        mesh = device_mesh(2, device="cpu")
        a, _ = sumfac.affine_factorization(
            Gf, tp.disc.basis.weight_grid().reshape(-1))
        Kcat = sumfac.make_affine_element_matrices(
            Dhat, tp.disc.basis.weight_grid().reshape(-1), order=ex.hier)
        got = [halo.make_sharded_fused_operator(ex, Kcat, a, mesh,
                                                precision=t)(u)
               for t in ("highest", "default")]
        assert torch.equal(*got)


def test_unknown_tier_raises():
    _, tp = _pair("rect", np.float32)
    ex = tp._local_setup(CPU)["ex"]
    Gf = tp._G_host.reshape(tp.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(tp._D0_host, tp._D1_host)
    A = sumfac.make_local_laplacian_operator(ex, Gf, Dhat, device="cpu")
    for call in (
            lambda: sumfac.make_local_laplacian_operator(
                ex, Gf, Dhat, device="cpu", precision="bf16"),
            lambda: sumfac.make_multi_rhs_laplacian_T(
                ex, Gf, Dhat, 2, device="cpu", precision="tf32"),
            lambda: kernels.make_fused_cg_kernels(
                A.Kst, A.aT, A.plan, precision="low"),
            lambda: halo.make_sharded_local_operator(
                ex, Gf, Dhat, device_mesh(2, device="cpu"),
                precision="fast")):
        with pytest.raises(ValueError, match="unknown precision"):
            call()


# -- the certified solve with fdm ---------------------------------------------

def test_certified_fdm_matches_reference():
    """float32 ``rectangle_mesh(8, 8, 6)``: the reference's segments,
    iterations and ``converged``; the float64 true residual of the float64
    iterate recomputed by an operator built here, at most 1.05 tol."""
    jp, tp = _pair("rect", np.float32)
    ref = jp.solve_local(tol=1e-6, precond="fdm", certify=True)
    got = tp.solve_local(tol=1e-6, precond="fdm", certify=True,
                         device="cpu")
    assert got.cg.converged and bool(ref.cg.converged)
    assert got.cg.issued == int(ref.cg.issued)
    assert abs(got.cg.iterations - int(ref.cg.iterations)) <= 2
    # the float32 system's factor values in float64: the exact rank-1
    # field a (x) W of its affine scales
    ex = tp._local_setup(CPU)["ex"]
    W = np.asarray(tp.disc.basis.weight_grid(), np.float64).reshape(-1)
    a, exact = sumfac.affine_factorization(
        tp._G_host.reshape(tp.disc.E, 3, -1), W)
    assert exact
    G64 = np.asarray(a, np.float64)[:, :, None] * W
    A64 = sumfac.make_local_laplacian_operator(
        ex, G64, sumfac.make_stacked_derivative(
            np.asarray(tp._D0_host, np.float64),
            np.asarray(tp._D1_host, np.float64)), device="cpu")
    free = torch.as_tensor(np.ascontiguousarray(
        (~tp._dirichlet_mask)[ex.gather_hier].T))
    w = ex.weights_T(torch.float64, CPU)

    def tl(v):
        return torch.as_tensor(ex.local_T_from_global(
            np.asarray(v, np.float64)))

    b = tl(np.asarray(tp._b, np.float64) + tp._neumann)
    u_d = tl(np.where(tp._dirichlet_mask, tp._dirichlet_vals, 0.0))

    def res(uL):
        r = torch.where(free, b - A64(uL), 0.0)
        return float(torch.sqrt(torch.sum(w * r * r)))

    assert res(u_d + got.cg.x) <= 1.05 * 1e-6 * res(u_d)


# -- what still raises --------------------------------------------------------

@pytest.mark.parametrize("case", ["fused-fdm", "fused1-en", "pmg-en",
                                  "batch-fused-fdm", "batch-pmg-en"])
def test_refused_combinations_raise(case):
    _, tp = _pair("rect", np.float32)
    kw = {"fused-fdm": dict(cg_kernel="fused", precond="fdm"),
          "fused1-en": dict(cg_kernel="fused1", vector_layout="en"),
          "pmg-en": dict(precond="pmg", vector_layout="en"),
          "batch-fused-fdm": dict(cg_kernel="fused", precond="fdm"),
          "batch-pmg-en": dict(precond="pmg", vector_layout="en")}[case]
    with pytest.raises(ValueError, match="'ne' layout|precond='jacobi'"):
        if case.startswith("batch"):
            tp.solve_local_batch(_batch_forcings(tp), device="cpu", **kw)
        else:
            tp.solve_local(device="cpu", **kw)


def test_fused_backend_with_compute_dtype_raises():
    _, tp = _pair("rect", np.float32)
    ex = tp._local_setup(CPU)["ex"]
    Gf = tp._G_host.reshape(tp.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(tp._D0_host, tp._D1_host)
    for layout, backend in (("ne", "fused"), ("en", "pallas")):
        with pytest.raises(ValueError, match="compute_dtype"):
            sumfac.make_local_laplacian_operator(
                ex, Gf, Dhat, device="cpu", vector_layout=layout,
                backend=backend, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype"):
        sumfac.make_multi_rhs_laplacian_T(ex, Gf, Dhat, 2, device="cpu",
                                          backend="fused",
                                          compute_dtype=torch.bfloat16)
    assert sumfac.ne_backend(ex, torch.float32, ex.n_loc, CPU, "auto",
                             torch.bfloat16) == "xla"


def test_fdm_3d_raises_citing_its_item():
    """The 3D factory is ported since (ROADMAP Queue 1 item 9): it builds
    on a box mesh and its M agrees with the reference's to 1e-12 (the 3D
    solves are held against the reference in tests/test_torch_poisson3d.py);
    its signature is the reference's with ``device`` last."""
    from spectralelementmethod_tpu.basis import gll_basis_3d as jax_basis3
    from spectralelementmethod_tpu.mesh import box_mesh as jax_box
    from spectralelementmethod_torch.basis import gll_basis_3d
    from spectralelementmethod_torch.mesh import box_mesh
    from spectralelementmethod_torch.ops.exchange import make_exchange

    jd = JaxDisc(jax_box(2, 2, 2, 3), jax_basis3(3))
    td = Discretization(box_mesh(2, 2, 2, 3), gll_basis_3d(3))
    jex, tex = jax_mex(jd), make_exchange(td)
    G = td.laplacian_factors(None)
    M = fdm.make_fdm_preconditioner_3d(tex, G, td.basis, device="cpu")
    M_ref = jax_fdm.make_fdm_preconditioner_3d(jex, jd.laplacian_factors(
        None), jd.basis)
    r = np.random.RandomState(0).standard_normal((tex.E, tex.n_loc))
    ref = np.asarray(M_ref(jnp.asarray(r)))
    got = M(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    ref = inspect.signature(jax_fdm.make_fdm_preconditioner_3d).parameters
    got = inspect.signature(fdm.make_fdm_preconditioner_3d).parameters
    assert list(got)[:-1] == list(ref) and list(got)[-1] == "device"
