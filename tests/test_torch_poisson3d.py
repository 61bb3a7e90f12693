"""The port's 3D hexahedral Poisson path against the JAX package, on the
CPU (the reference computes its 3D applies with XLA einsums outside any
Pallas kernel, so no interpret mode is needed).

* every 3D local apply (general, affine, separable and their transposed
  forms), the global apply and the host diagonal on seeded inputs, to
  1e-12 relative in float64;
* :class:`BoxRollExchange3D` (``dss``, ``dss_T``, stacks, padding) and
  :class:`PairScatterExchange` (``dss``, ``dot``, ``weights``, the round
  trip, the multiplicity split) against the reference's, and
  ``make_exchange`` picking the roll exchange on a box and falling back on
  a shuffled element order;
* float64 ``solve_local`` on ``box_mesh(3, 3, 3, 4)`` with Jacobi, fdm
  and pmg (the exact ``GridFDM3D`` coarse solve), and pmg's Chebyshev
  coarse fallback on ``box_mesh(2, 2, 2, 4)``: the reference's iterations
  exactly and its solution to 1e-10;
* the general structure through ``coefficient=`` on ``box_mesh(3, 2, 2,
  3)``, with ``solve``, ``apply_operator`` and ``operator_diagonal``;
* the k-RHS batch per RHS, ``certify=True`` on a float32 model (the
  reference's segments and issued iterations), the element-sharded
  ``sharded_local_poisson_problem_3d`` against the single-device solve,
  ``interop.operator_3d_from_numpy`` fed the reference's arrays, and the
  refusals.

Seven reference solves in all, each seconds of JAX tracing and compiling.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_3d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import box_mesh as jax_box
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import exchange as jax_exchange
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.parallel.partition import (
    reorder_elements as jax_reorder)
from spectralelementmethod_tpu.solver import fdm as jax_fdm

from spectralelementmethod_torch import interop
from spectralelementmethod_torch.basis import gll_basis_2d, gll_basis_3d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import box_mesh, rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import exchange, sumfac
from spectralelementmethod_torch.parallel import (
    device_mesh, reorder_elements, sharded_local_poisson_problem_3d)
from spectralelementmethod_torch.solver import fdm, pmg
from spectralelementmethod_torch.solver.cg import cg

torch.set_num_threads(2)

CPU = torch.device("cpu")


def exact(x, y, z):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)


def forcing(x, y, z):
    return 3 * np.pi**2 * exact(x, y, z)


def _discs(nx, ny, nz, p, perm=None):
    jm, tm = jax_box(nx, ny, nz, p), box_mesh(nx, ny, nz, p)
    if perm is not None:
        jm, tm = jax_reorder(jm, perm), reorder_elements(tm, perm)
    return JaxDisc(jm, jax_basis(p)), Discretization(tm, gll_basis_3d(p))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference, port) Poisson models of the named problem, shared by
    the tests (each reference solve compiles once)."""
    kw = dict(forcing=forcing, dtype=np.float64)
    bc = 0.0
    if name == "box":
        dims = (3, 3, 3, 4)
    elif name == "small":
        dims = (2, 2, 2, 4)
    elif name == "coef":
        # -div(c grad u) = f with c = 1 + x^2 / 4 and u = x (the
        # reference's variable-coefficient test)
        dims = (3, 2, 2, 3)
        kw = dict(forcing=lambda x, y, z: -0.5 * x,
                  coefficient=lambda x, y, z: 1.0 + 0.25 * x * x,
                  dtype=np.float64)
        bc = lambda x, y, z: x  # noqa: E731
    elif name == "f32":
        dims = (2, 2, 2, 4)
        kw = dict(dtype=np.float32)
        bc = lambda x, y, z: 0.2 * (x + y + z)  # noqa: E731
    jd, td = _discs(*dims)
    jp, tp = JaxPoisson(jd, **kw), Poisson(td, **kw)
    for prob in (jp, tp):
        prob.set_dirichlet("ebc", bc)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _solved(name, precond, pmg_opts=()):
    """The reference's and the port's float64 ``solve_local`` to 1e-10;
    ``pmg_opts`` (sorted option pairs) makes it ``{"pmg": {...}}``."""
    jp, tp = _pair(name)
    pre = {"pmg": dict(pmg_opts)} if pmg_opts else precond
    return (jp.solve_local(tol=1e-10, precond=pre),
            tp.solve_local(tol=1e-10, precond=pre, device="cpu"))


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


# -- the applies --------------------------------------------------------------

def _apply_inputs():
    jd, _ = _discs(3, 2, 2, 4)
    shape = tuple(jd.shape)
    G = jd.laplacian_factors(None).reshape((jd.E, 6) + shape)
    W3 = np.asarray(jd.basis.weight_grid())
    a, _ = jax_sumfac.affine_factorization(G.reshape(jd.E, 6, -1),
                                           W3.reshape(-1))
    D = [np.array(jd.basis.subbases[d].D1) for d in range(3)]
    w = [np.array(jd.basis.subbases[d].quad_wts) for d in range(3)]
    K = [jax_sumfac.assembled_1d_stiffness(D[d], w[d]) for d in range(3)]
    ue = np.random.RandomState(0).standard_normal((jd.E,) + shape)
    uT = np.ascontiguousarray(ue.reshape(jd.E, -1).T)
    GT = np.ascontiguousarray(np.moveaxis(G, 0, -1))
    return dict(ue=ue, uT=uT, G=G, GT=GT, a=a, aT=np.ascontiguousarray(a.T),
                W3=W3, D=D, w=w, K=K)


# name -> (function name, argument keys); lists expand into their entries
APPLIES = {
    "general": ("laplacian_apply_local_3d", ["ue", "G", "D"]),
    "affine": ("laplacian_apply_local_3d_affine", ["ue", "a", "W3", "D"]),
    "separable": ("laplacian_apply_local_3d_separable",
                  ["ue", "a", "K", "w"]),
    "general_T": ("laplacian_apply_local_3d_T", ["uT", "GT", "D"]),
    "affine_T": ("laplacian_apply_local_3d_affine_T",
                 ["uT", "aT", "W3", "D"]),
    "separable_T": ("laplacian_apply_local_3d_separable_T",
                    ["uT", "aT", "K", "w"]),
    "grad": ("grad_3d", ["ue", "D"]),
    "grad_T": ("grad_3d_T", ["uT3", "D"]),
}


@pytest.mark.parametrize("name", sorted(APPLIES))
def test_local_apply_matches_reference(name):
    inp = _apply_inputs()
    inp["uT3"] = inp["uT"].reshape(tuple(inp["W3"].shape) + (-1,))
    fname, keys = APPLIES[name]

    def args(lib):
        out = []
        for k in keys:
            vals = inp[k] if isinstance(inp[k], list) else [inp[k]]
            out += [lib(np.array(v)) for v in vals]
        return out

    ref = getattr(jax_sumfac, fname)(*args(jnp.asarray))
    got = getattr(sumfac, fname)(*args(torch.as_tensor))
    if name.startswith("grad"):
        for g, r in zip(got, ref):
            _close(g, r, 1e-12)
    else:
        _close(got, ref, 1e-12)


def test_gradient_adjoints_and_global_apply_match_reference():
    inp = _apply_inputs()
    rng = np.random.RandomState(1)
    f = [rng.standard_normal(inp["ue"].shape) for _ in range(3)]
    ref = jax_sumfac.grad_transpose_3d(*map(jnp.asarray, f + inp["D"]))
    _close(sumfac.grad_transpose_3d(*map(torch.as_tensor, f + inp["D"])),
           ref, 1e-12)
    fT = [np.moveaxis(x, 0, -1).copy() for x in f]
    ref = jax_sumfac.grad_transpose_3d_T(*map(jnp.asarray, fT + inp["D"]))
    _close(sumfac.grad_transpose_3d_T(*map(torch.as_tensor, fT + inp["D"])),
           ref, 1e-12)
    jd, _ = _discs(3, 2, 2, 4)
    u = rng.standard_normal(jd.n_nodes)
    gix = np.asarray(jd.gather_nodes)
    ref = jax_sumfac.laplacian_apply_3d(
        jnp.asarray(u), jnp.asarray(gix), jnp.asarray(inp["G"]),
        *map(jnp.asarray, inp["D"]), jd.n_nodes)
    got = sumfac.laplacian_apply_3d(
        torch.as_tensor(u), torch.as_tensor(gix), torch.as_tensor(inp["G"]),
        *map(torch.as_tensor, inp["D"]), jd.n_nodes)
    _close(got, ref, 1e-12)
    np.testing.assert_array_equal(
        sumfac.laplacian_diag_local_host_3d(inp["G"], *inp["D"]),
        jax_sumfac.laplacian_diag_local_host_3d(inp["G"], *inp["D"]))
    for d in range(3):
        np.testing.assert_array_equal(
            sumfac.assembled_1d_stiffness(inp["D"][d], inp["w"][d]),
            inp["K"][d])


def test_structure_rule():
    """The reference's rule: a box is separable, a sheared box affine, a
    variable coefficient general."""
    jd, td = _discs(3, 2, 2, 3)
    W3 = td.basis.weight_grid()
    G = td.laplacian_factors(None)
    assert sumfac.structure_3d(G, W3)[0] == "separable"
    sheared = G.copy()
    sheared[:, 1] = 0.1 * G[:, 0]
    assert sumfac.structure_3d(sheared, W3)[0] == "affine"
    coef = 1.0 + 0.25 * td.x_coeffs[:, 0] ** 2
    assert sumfac.structure_3d(td.laplacian_factors(coef), W3)[0] == \
        "general"


# -- the exchanges ------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 2, 2, 3), (3, 2, 4, 3), (2, 2, 2, 2)],
                         ids=["3x2x2p3", "3x2x4p3", "2x2x2p2"])
def test_box_roll_dss_matches_reference(dims):
    jd, td = _discs(*dims)
    jex, tex = jax_exchange.make_exchange(jd), exchange.make_exchange(td)
    assert type(tex) is exchange.BoxRollExchange3D
    assert tex.deltas == jex.deltas
    rng = np.random.RandomState(0)
    v = rng.standard_normal((td.E, td.n_loc))
    jdss = jax.jit(jex.dss)               # one program, not one per op
    ref = np.asarray(jdss(v))
    _close(tex.dss(torch.as_tensor(v)), ref, 1e-14)
    _close(tex.dss_T(torch.as_tensor(np.ascontiguousarray(v.T))).T, ref,
           1e-14)
    # a stack, each on its own; the reference stacks trailing components
    vk = rng.standard_normal((2, td.E, td.n_loc))
    ref_k = np.moveaxis(np.asarray(jdss(np.moveaxis(vk, 0, -1))), -1, 0)
    _close(tex.dss(torch.as_tensor(vk)), ref_k, 1e-14)
    np.testing.assert_array_equal(tex._mask_lo, np.asarray(jex._mask_lo))
    np.testing.assert_array_equal(tex._mask_hi, np.asarray(jex._mask_hi))


def test_box_roll_padded_matches_pair_scatter():
    jd, td = _discs(3, 2, 2, 3)
    roll = exchange.BoxRollExchange3D(td, pad_to=td.E + 5)
    ref = jax_exchange.BoxRollExchange3D(jd, pad_to=jd.E + 5)
    v = np.random.RandomState(1).standard_normal((roll.E, td.n_loc))
    v[td.E:] = 0.0
    got = roll.dss(torch.as_tensor(v))
    _close(got, np.asarray(ref.dss(v)), 1e-14)
    _close(got[:td.E], exchange.PairScatterExchange(td).dss(
        torch.as_tensor(v[:td.E])), 1e-14)
    assert torch.equal(got[td.E:], torch.zeros_like(got[td.E:]))


@functools.lru_cache(maxsize=None)
def _pair_scatter(padded=False):
    jd, td = _discs(3, 2, 2, 3)
    kw = dict(pad_to=td.E + 3) if padded else {}
    return (jax_exchange.PairScatterExchange(jd, **kw),
            exchange.PairScatterExchange(td, **kw), td)


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
def test_pair_scatter_dss_and_tables_match_reference(padded):
    jex, tex, td = _pair_scatter(padded)
    for name in ("_pair_idx", "_pair_partner", "_multi_idx", "_multi_seg"):
        np.testing.assert_array_equal(getattr(tex, name),
                                      np.asarray(getattr(jex, name)))
    np.testing.assert_array_equal(tex.weights, np.asarray(jex.weights))
    np.testing.assert_array_equal(tex.gather_lex, jex.gather_lex)
    v = np.random.RandomState(0).standard_normal((tex.E, td.n_loc))
    _close(tex.dss(torch.as_tensor(v)), np.asarray(jex.dss(v)), 1e-14)
    # the global oracle: scatter-assemble, gather back
    g = np.zeros(td.n_nodes)
    np.add.at(g, tex.gather_lex[:td.E].ravel(), v[:td.E].ravel())
    _close(tex.dss(torch.as_tensor(v))[:td.E], g[tex.gather_lex[:td.E]],
           1e-14)


def test_pair_scatter_dot_round_trip_and_multiplicity_split():
    jex, tex, td = _pair_scatter()
    rng = np.random.RandomState(1)
    u, v = rng.standard_normal((2, td.n_nodes))
    uL, vL = (torch.as_tensor(tex.local_from_global(x)) for x in (u, v))
    got = float(tex.dot(uL, vL))
    assert abs(got - float(u @ v)) < 1e-12 * abs(u @ v)
    assert abs(got - float(jex.dot(jex.local_from_global(u),
                                   jex.local_from_global(v)))) < 1e-12
    assert abs(float(tex.norm(uL)) - np.linalg.norm(u)) < 1e-12 * \
        np.linalg.norm(u)
    np.testing.assert_array_equal(
        tex.global_from_local(tex.local_from_global(u)), u)
    w = tex._weights_as(torch.float32, CPU)
    assert w.dtype == torch.float32 and w.shape == (tex.E, tex.n_loc)
    # every local copy is pair-exchanged, scatter-exchanged or private,
    # exactly once
    counted = np.zeros(tex.E * tex.n_loc, np.int64)
    counted[tex._pair_idx] += 1
    counted[tex._multi_idx] += 1
    assert counted.max() <= 1
    np.testing.assert_allclose(tex.weights.ravel()[counted == 0], 1.0)


def test_make_exchange_falls_back_on_a_shuffled_order():
    perm = np.random.RandomState(3).permutation(12)
    jd, td = _discs(3, 2, 2, 2, perm=perm)
    with pytest.raises(NotImplementedError):
        exchange.BoxRollExchange3D(td)
    tex, jex = exchange.make_exchange(td), jax_exchange.make_exchange(jd)
    assert type(tex) is exchange.PairScatterExchange
    assert type(jex).__name__ == "PairScatterExchange"
    v = np.random.RandomState(4).standard_normal((td.E, td.n_loc))
    _close(tex.dss(torch.as_tensor(v)), np.asarray(jex.dss(v)), 1e-14)


# -- the solves ---------------------------------------------------------------

@pytest.mark.parametrize("precond", ["jacobi", "fdm", "pmg"])
def test_solve_local_matches_reference(precond):
    js, ts = _solved("box", precond)
    assert bool(ts.cg.converged)
    assert int(ts.cg.iterations) == int(js.cg.iterations)
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-10)
    if precond != "jacobi":
        # the reference's bars (tests/test_poisson3d.py)
        bar = 0.6 if precond == "fdm" else 0.5
        assert int(ts.cg.iterations) < bar * int(
            _solved("box", "jacobi")[1].cg.iterations)


def test_pmg_exact_coarse_engages():
    _solved("box", "pmg")
    _, tp = _pair("box")
    M = tp._op_cache[("M", "pmg3d", (), "cpu")]
    assert isinstance(M, pmg.PMGPreconditioner3D)
    assert M._coarse_kind == "fdm" and isinstance(M._coarse, pmg.GridFDM3D)
    assert M._levels == (4, 2)
    A_raw, A = tp._op_cache[("A3d", "cpu")]
    assert A_raw.structure == A.structure == "separable"
    assert type(tp._exchange) is exchange.BoxRollExchange3D


def test_pmg_chebyshev_fallback_matches_reference():
    # a coarse degree of 4 keeps the reference's unrolled sweep cheap
    opts = (("coarse", "chebyshev"), ("coarse_degree", 4))
    js, ts = _solved("small", "pmg", opts)
    assert bool(ts.cg.converged)
    assert int(ts.cg.iterations) == int(js.cg.iterations)
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-10)
    _, tp = _pair("small")
    M = tp._op_cache[("M", "pmg3d", opts, "cpu")]
    assert M._coarse_kind == "chebyshev"


def test_pmg_entry_dispatches_on_ndim():
    _, tp = _pair("small")
    ctx = tp._local_setup_3d("jacobi", CPU)
    M = pmg.make_pmg_preconditioner(
        tp.disc, ctx["ex"], None, ctx["A"], ~tp._dirichlet_mask,
        tp.operator_diagonal(), dtype=np.float64, device="cpu")
    assert M._levels == (4, 2) and M._coarse_kind == "fdm"
    r = ctx["A"](torch.as_tensor(np.random.RandomState(0).standard_normal(
        (ctx["ex"].E, ctx["ex"].n_loc))))
    assert torch.isfinite(M(r)).all()
    # a stack, each on its own (the reference's jax.vmap(M))
    R = torch.stack([r, 2 * r])
    _close(M(R)[1], 2 * M(r), 1e-12)
    for kw, exc in ((dict(smoother="fdm"), NotImplementedError),
                    (dict(coeff_fn=lambda x, y, z: x), NotImplementedError),
                    (dict(cycle_dtype=np.float32), ValueError),
                    (dict(coarse_pad_to=16), ValueError),
                    (dict(mm_precision="bfloat16"), NotImplementedError),
                    (dict(coarse="lu"), ValueError)):
        with pytest.raises(exc):
            pmg.make_pmg_preconditioner(
                tp.disc, ctx["ex"], None, ctx["A"], ~tp._dirichlet_mask,
                tp.operator_diagonal(), device="cpu", **kw)


def test_fdm_3d_matches_reference_m():
    jp, tp = _pair("small")
    jex = jax_exchange.make_exchange(jp.disc)
    ctx = tp._local_setup_3d("jacobi", CPU)
    free = (~tp._dirichlet_mask)[ctx["ex"].gather_lex]
    M_ref = jax_fdm.make_fdm_preconditioner_3d(
        jex, jp._G_host, jp.disc.basis, jnp.asarray(free))
    M = fdm.make_fdm_preconditioner_3d(ctx["ex"], tp._G_host, tp.disc.basis,
                                       free, device="cpu")
    r = np.random.RandomState(2).standard_normal((ctx["ex"].E,
                                                  ctx["ex"].n_loc))
    _close(M(torch.as_tensor(r)), M_ref(jnp.asarray(r)), 1e-12)


def test_general_structure_through_coefficient():
    jp, tp = _pair("coef")
    js = jp.solve_local(tol=1e-10)
    ts = tp.solve_local(tol=1e-10, device="cpu")
    assert int(ts.cg.iterations) == int(js.cg.iterations)
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-10)
    A_raw, _ = tp._op_cache[("A3d", "cpu")]
    assert A_raw.structure == "general"
    # u = x solves it exactly (the reference's bar)
    assert np.abs(ts.u - tp.x_nodes[0]).max() < 1e-8


def test_global_vector_entry_points_match_reference():
    jp, tp = _pair("coef")
    np.testing.assert_allclose(tp.operator_diagonal(),
                               jp.operator_diagonal(), rtol=1e-13)
    u = np.random.RandomState(5).standard_normal(tp.disc.n_nodes)
    _close(tp.apply_operator(u, device="cpu"), jp.apply_operator(u), 1e-12)
    js = jp.solve(tol=1e-10, host_loop=True)
    for host_loop in (True, False):
        ts = tp.solve(tol=1e-10, host_loop=host_loop, device="cpu")
        assert int(ts.cg.iterations) == int(js.cg.iterations)
        np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-10)
    ts = tp.solve_local(tol=1e-10, host_loop=True, device="cpu")
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-9)


def test_batch_matches_reference_per_rhs():
    jp, tp = _pair("small")
    fs = [1.0, forcing]
    jb = jp.solve_local_batch(fs, tol=1e-10, precond="fdm")
    tb = tp.solve_local_batch(fs, tol=1e-10, precond="fdm", device="cpu")
    assert tb.u.shape == (2, tp.disc.n_nodes)
    assert bool(tb.cg.converged.all())
    np.testing.assert_array_equal(tb.cg.iterations.numpy(),
                                  np.asarray(jb.cg.iterations))
    np.testing.assert_allclose(tb.u, jb.u, rtol=0, atol=1e-10)
    # and each RHS against its own single solve
    single = tp.solve_local(tol=1e-10, precond="fdm", device="cpu")
    np.testing.assert_allclose(tb.u[1], single.u, rtol=0, atol=1e-9)


def test_certify_on_float32_matches_reference():
    jp, tp = _pair("f32")
    js = jp.solve_local(tol=1e-6, precond="pmg", certify=True)
    ts = tp.solve_local(tol=1e-6, precond="pmg", certify=True, device="cpu")
    res = ts.cg
    assert res.converged and not res.stalled
    assert bool(js.cg.converged)
    assert (res.iterations, res.issued) == (int(js.cg.iterations),
                                            int(js.cg.issued))
    assert res.x.dtype == torch.float64 and ts.u.dtype == np.float32
    assert ("A_hi3d", "cpu") in tp._op_cache
    assert tp._op_cache[("A_hi3d", "cpu")].structure == "separable"
    np.testing.assert_allclose(ts.u, js.u, rtol=0, atol=1e-5)
    # the certificate: the float64 residual of the iterate, recomputed
    A_hi = tp._op_cache[("A_hi3d", "cpu")]
    u_dL64, r_hi = tp._bc_cache["cpu"]["3d_hi"]
    w = tp._exchange._weights_as(torch.float64, CPU)
    rn = torch.sqrt(torch.sum(w * (r_hi - A_hi(res.x)) ** 2))
    assert float(rn) <= 1e-6 * float(torch.sqrt(torch.sum(w * r_hi ** 2)))
    # a repeat call is bit for bit the same
    again = tp.solve_local(tol=1e-6, precond="pmg", certify=True,
                           device="cpu")
    assert torch.equal(again.cg.x, res.x)


def test_sharded_3d_matches_single_device():
    _, tp = _pair("coef")
    single = tp.solve_local(tol=1e-12, device="cpu")
    A, r, M, u_dL, ex, mesh = sharded_local_poisson_problem_3d(
        tp, device_mesh(8, device="cpu"))
    assert ex.E == 16 and mesh.size == 8      # 12 elements pad to 16
    res = cg(A, r, M=M, tol=1e-12, max_iter=2000, dot=ex.dot)
    assert bool(res.converged)
    u = ex.global_from_local((u_dL + res.x).numpy())
    np.testing.assert_allclose(u, single.u, rtol=0, atol=1e-9)
    flat = Poisson(Discretization(rectangle_mesh(2, 2, 2), gll_basis_2d(2)))
    with pytest.raises(ValueError, match="3D"):
        sharded_local_poisson_problem_3d(flat, device_mesh(1, device="cpu"))


@pytest.mark.parametrize("name", ["box", "coef"])
def test_interop_operator_matches_reference_a_raw(name):
    jp, tp = _pair(name)
    ctx = jp._local_setup_3d("jacobi")
    jex = ctx["ex"]
    structure = ctx["A_raw"]._structure     # the reference's attribute
    W3 = np.asarray(jp.disc.basis.weight_grid())
    a, _ = jax_sumfac.affine_factorization(
        jp._G_host.reshape(jp.disc.E, 6, -1), W3.reshape(-1))
    op = interop.operator_3d_from_numpy(
        structure, [jp._D0_host, jp._D1_host, jp._D2_host],
        [jp.disc.basis.subbases[d].quad_wts for d in range(3)],
        jex.gather_lex, jex.deltas, np.asarray(jex._mask_lo),
        np.asarray(jex._mask_hi), jp.disc.n_nodes,
        G=jp._G_host if structure == "general" else None,
        a=a if structure != "general" else None,
        diag=jp.operator_diagonal(), free=~jp._dirichlet_mask, device="cpu")
    assert op.A_raw.structure == structure
    v = np.random.RandomState(6).standard_normal((jex.E, jex.n_loc))
    _close(op.A_raw(torch.as_tensor(v)), ctx["A_raw"](jnp.asarray(v)), 1e-12)
    _close(op.A(torch.as_tensor(v)), ctx["A"](jnp.asarray(v)), 1e-12)
    _close(op.M(torch.as_tensor(v)), ctx["M"](jnp.asarray(v)), 1e-12)


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(cg_kernel="fused"), dict(cg_kernel="fused1"),
    dict(p_dtype=torch.bfloat16), dict(defer_x=8),
    dict(structure="general"), dict(vector_layout="ne"),
    dict(compute_dtype=torch.bfloat16)],
    ids=lambda kw: f"{next(iter(kw))}={kw[next(iter(kw))]}")
def test_ignored_options_raise_naming_the_option(kw):
    """The reference's 3D path ignores these silently; the port refuses
    them (ROADMAP Queue 3)."""
    _, tp = _pair("small")
    name = next(iter(kw))
    with pytest.raises(ValueError, match=name):
        tp.solve_local(device="cpu", **kw)


def test_batch_refuses_fused_and_unknown_precond():
    _, tp = _pair("small")
    with pytest.raises(ValueError, match="plain"):
        tp.solve_local_batch([1.0], cg_kernel="fused", device="cpu")
    with pytest.raises(ValueError, match="defer_x"):
        tp.solve_local_batch([1.0], defer_x="auto", device="cpu")
    with pytest.raises(ValueError, match="precond"):
        tp.solve_local(precond="ilu", device="cpu")
    with pytest.raises(ValueError, match="host_loop"):
        _pair("f32")[1].solve_local(certify=True, host_loop=True,
                                    device="cpu")
