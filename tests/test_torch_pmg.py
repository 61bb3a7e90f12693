"""The port's two-level p-multigrid preconditioner (``solver/pmg.py``, 2D)
and the (n, E) operators' ``backend`` rule against the JAX package, on the
CPU (plain versions of the kernels; the reference's V-cycle takes XLA
there, so no interpret mode is needed).

Small meshes, one reference problem per module, shared by the tests:

* ``mesh_with_order`` against the reference's (node maps, boundary copy);
* ``estimate_lmax`` (``_lmax_f``) and ``chebyshev_smoother`` on the same
  operators, the transfers, the ``GridFDM``, lattice and Chebyshev coarse
  solves and one V-cycle ``M(r)`` (float64 cycle; and the float32 one)
  against the reference's on the same inputs;
* float64 pmg solves with a float64 cycle: the reference's iterations
  exactly and its solution to 1e-10 on the Morton-ordered rectangle (the
  lattice coarse solve) and on the curved annulus with config 3's c and k
  (Helmholtz: the rediscretized Chebyshev coarse level with the reaction
  in both levels); a batch of 3 on the rectangle, the ``GridFDM`` path,
  whose eigen-transforms are float32 in both packages, so its iterations
  may differ by 1 (the solution agrees to 1e-10).  Three reference solves
  in all: each costs the reference seconds of tracing and compiling, and
  the file is held to about 40 s on one worker;
* ``_coarse_kind``, ``_levels``, the signature and the defaults the
  reference pins (``tests/test_auto_policy.py::TestPmgDefaults``), and the
  options that raise with their ROADMAP item;
* the backend rule: ``_backend`` of each kind of operator, the
  Morton-ordered ``rectangle_mesh(8, 8, 3)`` (exchange tails: the "xla"
  operator) solved in float64 with the reference's iterations to 1e-10,
  each "xla" operator against the reference's "xla" operator,
  ``backend="fused"`` raising for tails and float64, and on the card for
  p = 9 (no apply kernel).
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
from spectralelementmethod_tpu.mesh import mesh_with_order as jax_mwo
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.helmholtz import Helmholtz as JaxHelm
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.ops.exchange import make_exchange as jax_mex
from spectralelementmethod_tpu.parallel import partition as jax_part
from spectralelementmethod_tpu.solver import pmg as jax_pmg

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import (annulus_mesh, mesh_with_order,
                                              rectangle_mesh)
from spectralelementmethod_torch.models.helmholtz import Helmholtz
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import sumfac
from spectralelementmethod_torch.parallel import partition
from spectralelementmethod_torch.solver import pmg

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL64 = 1e-10
# the float64 cycle: both packages' V-cycles then agree to rounding
PMG64 = {"pmg": {"cycle_dtype": np.float64}}
ANNULUS = dict(n_theta=6, n_r=10)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tdt(dt):
    return torch.float32 if dt == np.float32 else torch.float64


def _np(t) -> np.ndarray:
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _forcing(x, y):
    return 1.0 + x * y


def _c(x, y):
    return 1.0 + 0.1 * np.sqrt(x**2 + y**2)


def _k(x, y):
    return 2.0 + x**2


def _mesh(pkg, kind):
    rect, ann = ((jax_rect, jax_annulus) if pkg == "jax"
                 else (rectangle_mesh, annulus_mesh))
    if kind in ("rect", "grid"):
        return rect(10, 8, 4)
    if kind in ("annulus", "curved"):
        return ann(4, **ANNULUS)
    # "morton", "lattice": the Morton-ordered rectangle of the reference's
    # auto-policy test
    m = rect(8, 8, 3)
    part = jax_part if pkg == "jax" else partition
    return part.reorder_elements(m, part.morton_order(m.centroids))


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(reference, port) float64 models of one problem, shared by the
    tests (a solve changes only a problem's caches): Poisson, and on the
    "curved" annulus Helmholtz with config 3's c and k."""
    out = []
    for pkg, D, B, P, H in (("jax", JaxDisc, jax_basis, JaxPoisson, JaxHelm),
                            ("torch", Discretization, gll_basis_2d, Poisson,
                             Helmholtz)):
        p = 3 if kind in ("morton", "lattice") else 4
        disc = D(_mesh(pkg, kind), B(p))
        if kind == "curved":
            prob = H(disc, forcing=_forcing, coefficient=_c, reaction=_k,
                     dtype=np.float64)
        else:
            prob = P(disc, forcing=_forcing, dtype=np.float64)
        if kind in ("annulus", "curved"):
            prob.set_dirichlet("sphere", 0.3)
            prob.set_dirichlet("shell", lambda x, y: 0.1 * x)
        else:
            prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
        out.append(prob)
    return tuple(out)


# the options of the solves: a float64 cycle (both packages' V-cycles then
# agree to rounding); on the Chebyshev-coarse case a coarse degree of 4 in
# place of 24, which cuts the reference's traced loop (the default runs on
# the card, chip_smoke.py)
PRECOND = {"grid": PMG64, "lattice": PMG64,
           "curved": {"pmg": {"cycle_dtype": np.float64,
                              "coarse_degree": 4}}}


def _key(precond, device=None):
    """The pmg cache key of ``precond`` (the reference's; the port's adds
    the device)."""
    key = ("M", "pmg", "ne", tuple(sorted(precond["pmg"].items())))
    return key if device is None else key + (device,)


@functools.lru_cache(maxsize=None)
def _solved(kind):
    """The float64 pmg solve of one problem in both packages: (reference
    solution, port solution, reference M, port M, port context).  The
    reference runs its host loop (``cg_host``: the same iterations, without
    tracing the V-cycle into a compiled loop); the "grid" rectangle is a
    batch of 3 (``solve_local_batch``), whose reference keys its
    preconditioner by ``precond`` (a dict option is unhashable there), so
    its preconditioner is built with the same options and placed under the
    key of ``precond="pmg"``."""
    ref, port = _pair(kind)
    pre = PRECOND[kind]
    ctx = (port._local_ops("auto", "ne", "auto", "jacobi", CPU)
           if kind == "curved" else port._local_setup(CPU))
    if kind == "grid":
        ref._exchange, ref._op_cache = jax_mex(ref.disc, fused_pad=True), {}
        jctx = ref._local_setup("jacobi", "auto", None, "ne")
        Mj = ref._op_cache[("M", "pmg", "ne", ())] = \
            jax_pmg.make_pmg_preconditioner(
                ref.disc, jctx["ex"], jctx["Gf"], jctx["A"],
                ~ref._dirichlet_mask, np.asarray(ref.operator_diagonal()),
                dtype=np.float64, **pre["pmg"])
        F = np.random.RandomState(5).standard_normal((3, port.disc.n_nodes))
        s_ref = ref.solve_local_batch(F, tol=TOL64, precond="pmg")
        s = port.solve_local_batch(F, tol=TOL64, precond=pre, device="cpu")
    else:
        kw = dict(vector_layout="ne") if kind == "curved" else {}
        s_ref = ref.solve_local(tol=TOL64, precond=pre, host_loop=True, **kw)
        s = port.solve_local(tol=TOL64, precond=pre, device="cpu")
        Mj = ref._op_cache[_key(pre)]
    assert bool(np.all(s.cg.converged.numpy()))
    assert bool(np.all(np.asarray(s_ref.cg.converged)))
    return s_ref, s, Mj, port._op_cache[_key(pre, "cpu")], ctx


def _masked_random(ctx, seed, k=None):
    """A consistent (DSS of a random field), Dirichlet-masked (n, E)
    L-vector (or a (k, n, E) stack) as float64 numpy."""
    free = ctx["free_local"] if "free_local" in ctx else ctx["free"]
    shape = tuple(free.shape) if k is None else (k, *free.shape)
    v = torch.as_tensor(np.random.RandomState(seed).standard_normal(shape))
    return torch.where(free, ctx["ex"].dss_T(v), 0.0).numpy()


# -- the coarse mesh -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["rect", "annulus"])
def test_mesh_with_order_matches_reference(kind):
    for pc in (1, 2):
        mj = jax_mwo(_mesh("jax", kind), pc)
        mt = mesh_with_order(_mesh("torch", kind), pc)
        (gj, cj, nj), = mj.cell_blocks()
        (gt, ct, nt), = mt.cell_blocks()
        assert tuple(gt.shape) == tuple(gj.shape) == (pc + 1, pc + 1)
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(mt.nodes, mj.nodes)
        assert mt.boundary_names == mj.boundary_names
        for name in mt.boundary_names:
            np.testing.assert_array_equal(mt.boundary_faces(name),
                                          mj.boundary_faces(name))
    with pytest.raises(ValueError, match="divide"):
        mesh_with_order(_mesh("torch", kind), 3)


# -- the pieces against the reference's ---------------------------------------

def test_chebyshev_matches_reference():
    """The same SPD operator and Jacobi inverse in both packages: the
    Chebyshev polynomial of ``B A`` to rounding, and the port's
    ``estimate_lmax`` (RandomState(0) start, 30 iterations, safety 1.05)
    against numpy's top eigenvalue of ``B A`` (the reference's estimate on
    the models' operators is ``_lmax_f``, held in
    ``test_levels_match_reference``)."""
    rng = np.random.RandomState(3)
    Q, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    S = Q @ np.diag(np.linspace(0.5, 9.0, 24)) @ Q.T
    d = 1.0 / np.diag(S)
    Sj, dj, St, dt = jnp.asarray(S), jnp.asarray(d), torch.tensor(S), \
        torch.tensor(d)
    lam_t = pmg.estimate_lmax(lambda v: St @ v, lambda v: dt * v, (24,),
                              dtype=np.float64, device="cpu")
    top = np.linalg.eigvals(d[:, None] * S).real.max()
    assert 0.97 * 1.05 * top <= lam_t <= 1.05 * top * (1 + 1e-12)
    lam_j = lam_t
    r = rng.standard_normal(24)
    zj = jax.jit(jax_pmg.chebyshev_smoother(
        lambda v: Sj @ v, lambda v: dj * v, lam_j, lam_j / 4.0, 3))(
        jnp.asarray(r))
    zt = pmg.chebyshev_smoother(lambda v: St @ v, lambda v: dt * v, lam_t,
                                lam_t / 4.0, 3)(torch.tensor(r))
    assert _rel(zt, zj) <= 1e-13


@pytest.mark.parametrize("kind", ["grid", "lattice", "curved"])
def test_levels_match_reference(kind):
    """``_lmax_f`` (``estimate_lmax``), the transfers, the coarse solve
    (``GridFDM`` on the rectangle, the lattice solve on the Morton order,
    the Chebyshev sweep of the rediscretized level with the reaction on the
    annulus), the fine smoother and one float64 V-cycle, on the same
    inputs; ``_coarse_kind`` and ``_levels``."""
    _, _, Mj, Mt, ctx = _solved(kind)
    want = {"grid": (pmg.GridFDM, "fdm"),
            "lattice": (pmg.GridFDM2DLattice, "fdm"),
            "curved": (None, "chebyshev")}[kind]
    assert Mt._coarse_kind == Mj._coarse_kind == want[1]
    if want[0] is not None:
        assert type(Mt._coarse) is want[0]
        assert type(Mj._coarse).__name__ == want[0].__name__
    assert Mt._levels == Mj._levels == ((3 if kind == "lattice" else 4), 1)
    assert abs(Mt._lmax_f - Mj._lmax_f) <= 1e-12 * Mj._lmax_f
    r = _masked_random(ctx, 1)
    # the reference's pieces each compiled as one program (eagerly, each
    # of their operations would compile on its own)
    rc = _np(jax.jit(Mj._restrict)(jnp.asarray(r)))
    assert _rel(Mt._restrict(torch.tensor(r)), rc) <= 1e-13
    assert _rel(Mt._prolong(torch.tensor(rc)),
                jax.jit(Mj._prolong)(jnp.asarray(rc))) <= 1e-13
    # the lattice's scatter-set takes one of the copies of each shared
    # node; the restricted residual's copies agree to rounding only
    assert _rel(Mt._coarse(torch.tensor(rc)),
                jax.jit(Mj._coarse)(jnp.asarray(rc))) \
        <= (1e-12 if kind == "lattice" else 1e-13)
    assert _rel(Mt._S_f(torch.tensor(r)), jax.jit(Mj._S_f)(jnp.asarray(r))) \
        <= 1e-13
    assert _rel(Mt(torch.tensor(r)), jax.jit(Mj)(jnp.asarray(r))) <= 1e-12


def test_float32_cycle_matches_reference():
    """The default float32 V-cycle (the apply kernels' plain versions at
    n = 25 and n = 4) under a float64 outer vector: M casts to float32 and
    back, and agrees with the reference's V-cycle (its float64 one, the
    same function) to float32 rounding."""
    port = _pair("grid")[1]
    Mj, ctx = _solved("grid")[2], port._local_setup(CPU)
    Mt = pmg.make_pmg_preconditioner(
        port.disc, ctx["ex"], port._G_host.reshape(port.disc.E, 3, -1),
        ctx["A"], ~port._dirichlet_mask,
        np.asarray(port.operator_diagonal()), dtype=np.float64,
        device="cpu")
    assert Mt._cycle_dtype == np.float32
    assert Mt._ops["fine"]._backend == Mt._ops["coarse"]._backend == "fused"
    r = _masked_random(ctx, 2)
    zt = Mt(torch.tensor(r))
    assert zt.dtype == torch.float64
    assert _rel(zt, jax.jit(Mj)(jnp.asarray(r))) <= 1e-5


def test_stacked_cycle_is_the_cycle_of_each_rhs():
    """``M`` on a (k, n, E) stack (the operators' ``.stacked(k)``, batched
    transfers and grid solve) is ``M`` of each (n, E) array."""
    for kind in ("curved", "lattice"):
        Mt, ctx = _solved(kind)[3:]
        R = torch.tensor(_masked_random(ctx, 3, k=3))
        Z = Mt(R)
        for j in range(3):
            assert _rel(Z[j], Mt(R[j])) <= 1e-13


# -- solves --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["lattice", "curved"])
def test_pmg_solve_matches_reference(kind):
    """The lattice path (the Morton order, whose exchange tails also make
    the outer operator "xla") and the curved Chebyshev-coarse path
    (Helmholtz): the reference's iterations exactly, its solution to
    1e-10."""
    s_ref, s = _solved(kind)[:2]
    assert int(s.cg.iterations) == int(s_ref.cg.iterations)
    assert _rel(s.u, s_ref.u) <= TOL64


def test_batched_pmg_gridfdm_path():
    """``solve_local_batch`` with pmg on the rectangle (the GridFDM path):
    batched CG with the stacked V-cycle against the reference's vmapped
    one.  The GridFDM eigen-transforms are float32 in both packages, so
    the iterations may differ by 1; the solutions agree to 1e-10.  The
    preconditioner is cached under the reference's key (and the device);
    a fused CG request with pmg raises."""
    s_ref, s, _, Mt, _ = _solved("grid")
    d = s.cg.iterations.numpy() - np.asarray(s_ref.cg.iterations)
    assert np.abs(d).max() <= 1
    assert _rel(s.u, s_ref.u) <= TOL64
    assert (Mt._coarse_kind, Mt._levels) == ("fdm", (4, 1))
    port = _pair("grid")[1]
    with pytest.raises(ValueError, match="precond='jacobi'"):
        port.solve_local(precond="pmg", cg_kernel="fused", device="cpu")


# -- signature, defaults, raises ---------------------------------------------

def test_signature_and_defaults_match_reference():
    """The reference's parameters in its order with ``device`` last, and
    the defaults ``TestPmgDefaults`` pins (p_coarse None -> 1 in 2D,
    jacobi, degree 3, alpha 4)."""
    ref = inspect.signature(jax_pmg.make_pmg_preconditioner).parameters
    got = inspect.signature(pmg.make_pmg_preconditioner).parameters
    assert list(got)[:-1] == list(ref) and list(got)[-1] == "device"
    for name in ref:
        assert got[name].default == ref[name].default, name
        assert got[name].kind == ref[name].kind, name
    assert (got["p_coarse"].default, got["smoother"].default,
            got["degree"].default, got["alpha"].default) == \
        (None, "jacobi", 3, 4.0)
    assert _solved("grid")[3]._levels[1] == 1


@pytest.mark.parametrize("kw,exc,match", [
    # the fdm smoother is ported since (ROADMAP Queue 1 item 8): it builds
    # and the V-cycle applies (tests/test_torch_fdm.py holds its solve
    # against the reference's)
    pytest.param(dict(smoother="fdm"), None, None,
                 id="kw0-NotImplementedError-item 8"),
    # the padded coarse level is ported since (the sharded pmg): its
    # V-cycle equals the unpadded one (the pads are inert)
    pytest.param(dict(coarse_pad_to=128), None, None,
                 id="kw1-NotImplementedError-item 12"),
    # the other mm_precision tiers: a pinned divergence (ROADMAP Queue 3)
    pytest.param(dict(mm_precision="bfloat16"), NotImplementedError,
                 "ROADMAP Queue 3", id="kw2-NotImplementedError-item 15"),
    (dict(coarse="lu"), ValueError, "coarse"),
    (dict(p_coarse=3), ValueError, "divide")])
def test_unported_options_raise(kw, exc, match):
    _, port = _pair("grid")
    ctx = port._local_setup(CPU)

    def build(kw=kw):
        return pmg.make_pmg_preconditioner(
            port.disc, ctx["ex"], port._G_host.reshape(port.disc.E, 3, -1),
            ctx["A"], ~port._dirichlet_mask, port.operator_diagonal(),
            device="cpu", **kw)

    if exc is None:
        M = build()
        r = torch.where(ctx["free_local"], torch.ones_like(
            ctx["free_local"], dtype=torch.float64), 0.0)
        z = M(r)
        assert z.shape == r.shape and bool(torch.isfinite(z).all())
        assert float(torch.sum(z * r)) > 0
        if "coarse_pad_to" in kw:
            # the float32 cycle: the padded coarse level keeps the p = 1
            # apply kernel (its plain version here)
            assert M._A_c._backend == "fused" and M._coarse_kind == "fdm"
            z0 = build({})(r)
            torch.testing.assert_close(z, z0, rtol=0, atol=1e-12 * float(
                z0.abs().max()))
        return
    with pytest.raises(exc, match=match):
        build()


# -- the (n, E) operators' backend rule ----------------------------------------

def test_morton_order_solves_through_the_xla_operator():
    """The Morton order leaves exchange tails: the operator is "xla" (the
    reference solves this case through XLA), and the float64 pmg solve of
    ``test_pmg_solve_matches_reference[morton]`` runs through it with the
    reference's iterations to 1e-10."""
    s_ref, s, _, _, ctx = _solved("lattice")
    assert ctx["ex"].n_edge_tail or ctx["ex"].n_vert_tail
    assert ctx["A"]._backend == ctx["A_raw"]._backend == "xla"
    assert int(s.cg.iterations) == int(s_ref.cg.iterations)
    assert _rel(s.u, s_ref.u) <= TOL64


def _disc(pkg, kind, p=None):
    D, B, rect = ((JaxDisc, jax_basis, jax_rect) if pkg == "jax"
                  else (Discretization, gll_basis_2d, rectangle_mesh))
    return D(_mesh(pkg, kind) if p is None else rect(3, 2, p),
             B(p or (3 if kind == "morton" else 4)))


def _operator(kind, dtype, p=None, backend="auto", stacked=None):
    disc = _disc("torch", kind, p)
    prob = Poisson(disc, dtype=dtype)
    ex = prob._local_setup(CPU)["ex"]
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    if stacked:
        return sumfac.make_multi_rhs_laplacian_T(ex, Gf, Dhat, stacked,
                                                 device="cpu",
                                                 backend=backend)
    return sumfac.make_local_laplacian_operator(ex, Gf, Dhat, device="cpu",
                                                backend=backend)


def _reference_xla_operator(kind, dtype, p=None):
    """The reference's ``backend="xla"`` (n, E) operator of the same
    problem, built from the port's factors on the reference's exchange
    (whose L-vector order is the port's)."""
    port = Poisson(_disc("torch", kind, p), dtype=dtype)
    ex = port._local_setup(CPU)["ex"]
    jex = jax_mex(_disc("jax", kind, p))
    assert np.array_equal(np.asarray(jex.hier), _np(ex.hier))
    Gf = port._G_host.reshape(port.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(port._D0_host, port._D1_host)
    return jax_sumfac.make_local_laplacian_operator(
        jex, jnp.asarray(Gf), jnp.asarray(Dhat), backend="xla",
        vector_layout="ne")


@pytest.mark.parametrize("case,backend", [
    (("rect", np.float32), "fused"),
    (("annulus", np.float32), "fused"),
    (("rect", np.float64), "xla"),
    (("annulus", np.float64), "xla"),
    (("morton", np.float32), "xla"),
    (("rect", np.float32, 9), "fused")])
def test_backend_rule(case, backend):
    """``"auto"`` is the reference's ``fused_ok``: float32 and a tail-free
    roll-class exchange give "fused" (at p = 9 too: on the CPU the plain
    versions, on the card a raise, ``test_fused_order_without_kernel``),
    anything else "xla"; "xla" computes the reference's "xla" operator and
    launches no kernel; "fused" raises where the kernel does not apply; the
    fused CG factories refuse an "xla" operator."""
    A = _operator(*case)
    assert A._backend == backend
    assert A.structure == ("general" if case[0] == "annulus" else "affine")
    Ax = _operator(*case, backend="xla")
    assert Ax._backend == "xla" and Ax.factors is None
    u = torch.randn((A.n_loc, A.E), dtype=_tdt(case[1]))
    tol = 1e-5 if case[1] == np.float32 else 1e-13
    assert _rel(Ax(u), A(u)) <= tol
    if backend == "xla":
        Aj = _reference_xla_operator(*case)
        assert _rel(Ax(u), jax.jit(Aj)(jnp.asarray(u.numpy()))) <= tol
    k3 = _operator(*case, stacked=3)
    U = torch.randn((3, A.n_loc, A.E), dtype=_tdt(case[1]))
    assert k3._backend == backend
    assert _rel(k3(U)[1], A(U[1])) <= (1e-6 if case[1] == np.float32
                                        else 1e-13)
    if backend == "xla":
        with pytest.raises(ValueError, match="backend='fused' requires"):
            _operator(*case, backend="fused")
        with pytest.raises(ValueError, match="fused backend"):
            A.fused_cg_kernels()


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_fused_order_without_kernel_raises_on_the_card(backend):
    """On a CUDA device a float32 operator on a tail-free roll exchange is
    "fused" by the reference's rule; at an order without an apply kernel
    (p = 9) the choice raises ``NotImplementedError`` at build time and
    does not turn to "xla"; p = 1 and p = 8 have kernels.  The choice reads
    static properties only, so no card is needed to check it."""
    prob = Poisson(_disc("torch", "rect", 9), dtype=np.float32)
    ex = prob._local_setup(CPU)["ex"]
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="n=100"):
        sumfac.ne_backend(ex, torch.float32, 100, cuda, backend)
    for n in (4, 81):
        assert sumfac.ne_backend(ex, torch.float32, n, cuda, backend) \
            == "fused"
    assert sumfac.ne_backend(ex, torch.float32, 100, CPU, backend) == \
        "fused"
    assert sumfac.ne_backend(ex, torch.float32, 100, cuda, "xla") == "xla"
    assert sumfac.ne_backend(ex, torch.float64, 100, cuda, "auto") == "xla"


def test_fused_cg_auto_takes_plain_cg_on_the_xla_operator():
    """``cg_kernel="auto"`` with bf16 directions runs plain CG on an "xla"
    operator; an explicit fused request raises (the reference's
    ``fused_ok``)."""
    disc = Discretization(_mesh("torch", "morton"), gll_basis_2d(3))
    prob = Poisson(disc, forcing=_forcing, dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    with pytest.raises(ValueError, match="fused backend"):
        prob.solve_local(tol=1e-5, cg_kernel="fused", device="cpu")
    assert bool(prob.solve_local(tol=1e-5, device="cpu").cg.converged)
