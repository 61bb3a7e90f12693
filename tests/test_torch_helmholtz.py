"""The port's variable-coefficient Helmholtz (BASELINE config 3) against the
JAX package's, on the CPU (plain versions of the kernels).

The problem is the reference's config-3 test problem cut to size: a polar
half-annulus at p = 3 with c = 1 + 0.1 r and k = 2 + x^2, Dirichlet data on
both circles and a Neumann flux on the symmetry axis.  Covered:

* the (E, n) exchange (``dss``, ``dot``; generic gather and roll classes)
  against the reference's in float64, to 1e-12;
* the element-local kernel's plain version against the reference's
  ``fused_laplacian_local`` / ``fused_vector_laplacian_local`` in interpret
  mode (E not a multiple of the reference's 8-element block), at the
  reference's float32 tolerance 2e-5 (``tests/test_pallas_kernels.py``);
* the ``"en"`` operator with ``backend="pallas"`` against the reference's
  ``"pallas-interpret"`` (float32), and with ``"xla"`` (general and affine
  meshes) in float64 to 1e-12;
* float64 ``solve``, ``solve_local`` in both layouts and
  ``solve_local_batch``: the reference's iterations exactly and its
  solution to 1e-10; the float32 ``en``/pallas solve within 2 iterations
  and 1e-4 of the reference's ``en``/``pallas-interpret`` solve;
* ``boundary_flux`` with a coefficient, the interop function, the errors.
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
from spectralelementmethod_tpu.models.helmholtz import Helmholtz as JaxHelm
from spectralelementmethod_tpu.ops import exchange as jax_exchange
from spectralelementmethod_tpu.ops import pallas_kernels
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import helmholtz_operator_from_numpy
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.helmholtz import Helmholtz
from spectralelementmethod_torch.ops import exchange, kernels, sumfac

torch.set_num_threads(2)

# E = 72 (float64 solves) and E = 32 (interpret-mode kernels, float32)
ANNULUS = dict(n_theta=12, n_r=6, r_inner=1.0, r_outer=2.0, progression=1.0,
               node_placement="polar")
SMALL = dict(ANNULUS, n_theta=8, n_r=4)
TOL64 = 1e-10


def _c(x, y):
    return 1.0 + 0.1 * np.sqrt(x**2 + y**2)


def _k(x, y):
    return 2.0 + x**2


def _build(pkg, mesh, dtype):
    D, B, ann, rect, H = (
        (JaxDisc, jax_basis, jax_annulus, jax_rect, JaxHelm) if pkg == "jax"
        else (Discretization, gll_basis_2d, annulus_mesh, rectangle_mesh,
              Helmholtz))
    if mesh == "rect":
        # affine cells and a constant coefficient: the assembled-K product
        prob = H(D(rect(4, 3, 3), B(3)), forcing=1.0, coefficient=2.0,
                 reaction=1.5, dtype=dtype)
        prob.set_dirichlet("ebc", 0.0)
        return prob
    prob = H(D(ann(3, **(ANNULUS if mesh == "annulus" else SMALL)), B(3)),
             forcing=lambda x, y: 1.0 + x * y, coefficient=_c, reaction=_k,
             dtype=dtype)
    prob.set_dirichlet("sphere", 0.3)
    prob.set_dirichlet("shell", lambda x, y: 0.1 * x)
    prob.set_neumann("symaxis", 0.2)
    return prob


@functools.lru_cache(maxsize=None)
def _pair(mesh="annulus", dtype=np.float64):
    """The same problem in both packages, built once per module."""
    return _build("jax", mesh, dtype), _build("torch", mesh, dtype)


def _ops_state(prob):
    """(Gf, Dhat) of a JAX problem, in its dtype."""
    disc = prob.disc
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    return Gf, Dhat.astype(Gf.dtype)


@pytest.mark.parametrize("kind", ["LocalExchange", "RollExchange"])
def test_dss_and_dot_match_reference(kind):
    jp, tp = _pair()
    ex_j = getattr(jax_exchange, kind)(jp.disc)
    ex_t = getattr(exchange, kind)(tp.disc)
    if kind == "RollExchange":
        assert ex_j.edge_classes and ex_t.edge_classes
    np.testing.assert_array_equal(ex_t.gather_hier, ex_j.gather_hier)
    rng = np.random.RandomState(3)
    V = rng.standard_normal((2, ex_t.E, ex_t.n_loc))
    got = ex_t.dss(torch.as_tensor(V)).numpy()
    for j in range(2):
        ref = np.asarray(ex_j.dss(jnp.asarray(V[j])))
        np.testing.assert_allclose(got[j], ref, rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            ex_t.dss_T(torch.as_tensor(V[j].T.copy())).numpy().T, ref,
            rtol=0, atol=1e-12)
    U = ex_t.dss(torch.as_tensor(V))
    d_t = float(ex_t.dot(U[0], U[1]))
    d_j = float(ex_j.dot(jnp.asarray(U[0].numpy()), jnp.asarray(U[1].numpy())))
    assert abs(d_t - d_j) <= 1e-12 * abs(d_j)
    assert abs(float(ex_t.norm(U[0])) ** 2
               - float(ex_j.dot(*(jnp.asarray(U[0].numpy()),) * 2))) <= \
        1e-12 * float(ex_t.dot(U[0], U[0]))


def test_laplacian_local_plain_matches_pallas_interpret():
    jp, tp = _pair("small", np.float32)
    ex = jax_exchange.LocalExchange(jp.disc)
    Gf, Dhat = _ops_state(jp)
    E = 30                       # no multiple of the 8-element block
    Gf = Gf[:E]
    Dh = Dhat[:, ex.hier]
    n = Dh.shape[1]
    rng = np.random.RandomState(4)
    u = rng.standard_normal((E, 2 * n)).astype(np.float32)
    g = np.ascontiguousarray(Gf.transpose(1, 0, 2))
    gj = [jnp.asarray(g[c]) for c in range(3)]
    hier = torch.as_tensor(ex.hier.astype(np.int32))
    args = (torch.as_tensor(g), torch.as_tensor(Dh), hier)
    ref = pallas_kernels.fused_laplacian_local(
        jnp.asarray(u[:, :n]), *gj, jnp.asarray(Dh), block_e=8,
        interpret=True)
    got = kernels.laplacian_local(torch.as_tensor(u[:, :n].copy()), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    ref_v = pallas_kernels.fused_vector_laplacian_local(
        jnp.asarray(u), *gj, jnp.asarray(Dh), block_e=8, interpret=True)
    got_v = kernels.vector_laplacian_local(torch.as_tensor(u), *args)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=2e-5,
                               atol=2e-5)
    # the stack form: each array of a (2, E, n) stack on its own
    U = torch.as_tensor(np.stack([u[:, :n], u[:, n:]]))
    np.testing.assert_array_equal(
        kernels.laplacian_local_batched(U, *args).numpy(),
        got_v.numpy().reshape(E, 2, n).transpose(1, 0, 2))


@pytest.mark.parametrize("case", [("small", np.float32, "pallas"),
                                  ("annulus", np.float64, "xla"),
                                  ("rect", np.float64, "xla")],
                         ids=["pallas-f32", "xla-general-f64",
                              "xla-affine-f64"])
def test_en_operator_matches_reference(case):
    mesh, dtype, backend = case
    jp, tp = _pair(mesh, dtype)
    Gf, Dhat = _ops_state(jp)
    ex_j = jax_exchange.RollExchange(jp.disc)
    ex_t = exchange.RollExchange(tp.disc)
    A_j = jax_sumfac.make_local_laplacian_operator(
        ex_j, Gf, Dhat, vector_layout="en",
        backend="pallas-interpret" if backend == "pallas" else "xla")
    A_t = sumfac.make_local_laplacian_operator(
        ex_t, Gf, Dhat, vector_layout="en", backend=backend, device="cpu")
    assert (A_t._backend, A_t._structure) == (
        backend, "affine" if mesh == "rect" else "general")
    assert A_j._structure == A_t._structure
    u = np.random.RandomState(5).standard_normal(
        (ex_t.E, ex_t.n_loc)).astype(dtype)
    got = A_t(torch.as_tensor(u)).numpy()
    ref = np.asarray(jax.jit(A_j)(jnp.asarray(u)))
    tol = 2e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["solve", "ne", "en", "batch"])
def test_float64_solves_match_reference(mode):
    """The reference's iterations to the iteration, its solution to 1e-10:
    ``solve`` by the host loop (cg_host), ``ne`` by the ladder CG,
    ``en`` by the host loop with the exchange's dot, the batch (k = 2,
    en) by the batched ladder."""
    jp, tp = _pair()
    forcings = [1.0, lambda x, y: x - y]
    if mode == "solve":
        sj, st = (p.solve(tol=TOL64, host_loop=True, **kw)
                  for p, kw in ((jp, {}), (tp, {"device": "cpu"})))
    elif mode == "batch":
        sj, st = (p.solve_local_batch(forcings, tol=TOL64,
                                      vector_layout="en", **kw)
                  for p, kw in ((jp, {}), (tp, {"device": "cpu"})))
    else:
        kw = dict(tol=TOL64, vector_layout=mode, host_loop=mode == "en")
        sj, st = jp.solve_local(**kw), tp.solve_local(device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(st.cg.iterations),
                                  np.asarray(sj.cg.iterations))
    assert np.asarray(st.cg.converged).all()
    np.testing.assert_allclose(st.u, np.asarray(sj.u), rtol=0, atol=1e-10)


def test_float32_en_pallas_matches_reference():
    jp, tp = _pair("small", np.float32)
    sj = jp.solve_local(tol=1e-5, vector_layout="en",
                        backend="pallas-interpret")
    st = tp.solve_local(tol=1e-5, vector_layout="en", backend="pallas",
                        device="cpu")
    assert bool(st.cg.converged)
    assert abs(int(st.cg.iterations) - int(sj.cg.iterations)) <= 2
    scale = np.abs(np.asarray(sj.u)).max()
    assert np.abs(st.u - np.asarray(sj.u)).max() <= 1e-4 * scale


def test_boundary_flux_with_coefficient():
    jp, tp = _pair()
    u = np.sin(tp.x_nodes[0]) * tp.x_nodes[1] + tp.x_nodes[0] ** 2
    for bnd in ("sphere", "shell", "symaxis"):
        ref = jp.boundary_flux(u, bnd)
        assert abs(tp.boundary_flux(u, bnd) - ref) <= 1e-10 * max(
            abs(ref), 1.0)


def test_interop_matches_reference():
    """The JAX problem's state in, the same raw apply out: the generic
    gather tables on (E, n) and the roll classes on (n, E)."""
    jp, _ = _pair()
    Gf, Dhat = _ops_state(jp)
    rng = np.random.RandomState(6)
    for kind, layout in (("LocalExchange", "en"), ("RollExchange", "ne")):
        ex = getattr(jax_exchange, kind)(jp.disc)
        kM = jp._kM_host.reshape(jp.disc.E, -1)[:, ex.hier]
        tables = (dict(edge_classes=ex.edge_classes,
                       vert_classes=ex.vert_classes) if layout == "ne" else
                  dict(edge_recv_flat=np.asarray(ex._edge_recv_flat),
                       edge_recv_mask=np.asarray(ex._edge_recv_mask),
                       vert_gid=np.asarray(ex.vert_gid)))
        op = helmholtz_operator_from_numpy(
            Gf, Dhat, ex.hier, kM, ex.gather_hier, ex._weights_np,
            np.asarray(jp.operator_diagonal()), ~jp._dirichlet_mask,
            vector_layout=layout, device="cpu", **tables)
        lap_j = jax_sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, vector_layout=layout, backend="xla",
            structure="general")
        dss_j = ex.dss_T if layout == "ne" else ex.dss
        kM_j = jnp.asarray(kM.T.copy() if layout == "ne" else kM)
        u = rng.standard_normal(tuple(op.free.shape))
        ref = np.asarray(lap_j(jnp.asarray(u)) + dss_j(kM_j * jnp.asarray(u)))
        got = op.A._raw(torch.as_tensor(u)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        b = np.asarray(jp._b)
        np.testing.assert_array_equal(op.to_local(b).numpy(),
                                      np.asarray(ex.local_from_global(b)).T
                                      if layout == "ne"
                                      else ex.local_from_global(b))


@pytest.mark.parametrize("what", ["pallas_f64", "pmg", "compute_dtype"])
def test_unported_and_refused_options_raise(what):
    """float64 factors with ``backend="pallas"`` raise (a deliberate
    divergence: the reference's kernel returns an f64-typed result of f32
    accuracy), as does ``precond="pmg"`` on the ``"en"`` layout (as in the
    reference; on ``"ne"`` it solves).  A ``compute_dtype`` is ported
    since (ROADMAP Queue 1 item 15): the (E, n) operator builds, its bf16
    products stay within 0.03 of max of the float64 ones, and the
    element-local kernel refuses it."""
    _, tp = _pair()
    if what == "pallas_f64":
        with pytest.raises(ValueError, match="float32"):
            tp.solve_local(vector_layout="en", backend="pallas", device="cpu")
    elif what == "pmg":
        with pytest.raises(ValueError, match="'ne' layout"):
            tp.solve_local(precond="pmg", vector_layout="en", device="cpu")
        assert bool(tp.solve_local(tol=1e-8, precond="pmg",
                                   device="cpu").cg.converged)
    else:
        ex = exchange.make_exchange(tp.disc)
        Gf = tp._G_host.reshape(tp.disc.E, 3, -1)
        Dhat = sumfac.make_stacked_derivative(tp._D0_host, tp._D1_host)
        A16 = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, device="cpu", vector_layout="en",
            compute_dtype=torch.bfloat16)
        A = sumfac.make_local_laplacian_operator(
            ex, Gf, Dhat, device="cpu", vector_layout="en")
        u = torch.as_tensor(np.random.RandomState(1).standard_normal(
            (ex.E, ex.n_loc)))
        got, ref = A16(u), A(u)
        assert got.dtype == torch.float64 and A16._backend == "xla"
        assert float((got - ref).abs().max()) <= 0.03 * float(
            ref.abs().max())
        with pytest.raises(ValueError, match="compute_dtype"):
            sumfac.make_local_laplacian_operator(
                ex, Gf.astype(np.float32), Dhat, device="cpu",
                vector_layout="en", backend="pallas",
                compute_dtype=torch.bfloat16)
