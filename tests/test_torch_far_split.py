"""The fused CG kernels' far-class split against the JAX package's
``cheap_far`` kernels, on the CPU (plain versions of the port's kernels;
the reference's Pallas kernels in interpret mode, as its tests run them).

The meshes are the reference's far-forcing setups: ``rectangle_mesh(32,
16, 2)`` with ``max_halo=1`` (the row-stride classes, |delta| 32, go far;
``tests/test_cg_fused.py:133``, ``:163``, ``:524``), its variable
coefficient ``1 + x^2 y^2`` on the general kernels
(``tests/test_fused_general.py:379-494``, ``:628``) and a 16 x 16
panel-ordered mesh with ``max_halo=4`` (``tests/test_cg_fused.py:403``).
The port's operator is built from the reference's arrays
(``interop.operator_from_numpy(..., max_halo=)``).

* one kernel A + kernel B step from seeded numpy inputs: p', x', r' and
  the partial sums, and the reference's near Ap with its far rows added
  (``add_far``) against the port's near Ap with its far classes added
  (``far_update_plain``), within 1e-5 of the max in float32 and 2**-7
  (one bf16 ulp, the bar of ``test_torch_batched.py`` and
  ``test_torch_general.py``) with bf16 directions.  The two add the far
  classes in different orders (the reference one compact block per
  destination row, the port the far update's per-class sequence), which
  these bars cover;
* float64 split solves through the port's fused step (``cg_fused``'s
  iteration, the kernels' float64 plain versions), one RHS and stacks of
  two, with and without deferred x: the unsplit port's iterations
  exactly, and the reference's float64 ``cg`` to 1e-10 on the problem's
  right-hand side.
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
from spectralelementmethod_tpu.ops import pallas_kernels as pk
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.ops.exchange import (RollExchange,
                                                    make_exchange)
from spectralelementmethod_tpu.parallel.partition import (panel_order,
                                                          reorder_elements)
from spectralelementmethod_tpu.solver.cg import cg as jax_cg

from spectralelementmethod_torch.interop import (
    general_operator_from_numpy, operator_from_numpy)
from spectralelementmethod_torch.ops import kernels
from spectralelementmethod_torch.ops.exchange import roll_dss_T
from spectralelementmethod_torch.solver import cg as port_cg

from jax_reference import jit_dss_T

torch.set_num_threads(2)

K_RHS = 2
BF16_REL = 2.0 ** -7


def _coefficient(x, y):
    return 1 + x**2 * y**2


@functools.lru_cache(maxsize=None)
def _problem(name, dtype=np.float32):
    """(reference problem, its exchange, Gf, Dhat, Kcat, a) of one mesh:
    ``"affine"`` (32 x 16, p = 2), ``"general"`` (the same with the
    variable coefficient) or ``"panel"`` (16 x 16 in panels of 4)."""
    if name == "panel":
        mesh = reorder_elements(jax_rect(16, 16, 2), panel_order(16, 16, 4))
    else:
        mesh = jax_rect(32, 16, 2)
    disc = JaxDisc(mesh, jax_basis(2))
    prob = JaxPoisson(disc, forcing=lambda x, y: np.sin(np.pi * x),
                      coefficient=_coefficient if name == "general" else None,
                      dtype=dtype)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    ex = make_exchange(disc) if name == "panel" else RollExchange(disc)
    assert ex.n_edge_tail == 0 and ex.n_vert_tail == 0
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = jax_sumfac.affine_factorization(Gf, W)
    assert exact == (name != "general")
    Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    return prob, ex, Gf, Dhat, Kcat, a


def _halo(name):
    return 4 if name == "panel" else 1


@functools.lru_cache(maxsize=None)
def _port(name, max_halo, dtype=np.float32, p_dtype=None):
    """The port's operator state on the reference's arrays."""
    prob, ex, Gf, Dhat, Kcat, a = _problem(name, dtype)
    common = (ex.edge_classes, ex.vert_classes, ex.gather_hier,
              ex._weights_np, prob.operator_diagonal(),
              ~prob._dirichlet_mask, ex.E_real)
    kw = dict(device="cpu", dtype=dtype, p_dtype=p_dtype, max_halo=max_halo)
    if name == "general":
        return general_operator_from_numpy(Gf, Dhat, ex.hier, *common, **kw)
    return operator_from_numpy(Kcat, a, *common, **kw)


@functools.lru_cache(maxsize=None)
def _ref_kernels(name, bf16, n_rhs=None, defer_x=False):
    """The reference's ``cheap_far`` kernels at ``max_halo``."""
    prob, ex, Gf, Dhat, Kcat, a = _problem(name)
    kw = dict(interpret=True, precision="high" if bf16 else "highest",
              p_dtype=jnp.bfloat16 if bf16 else None, max_halo=_halo(name))
    if name == "general":
        kA, kB, _ = pk.make_fused_cg_kernels_general(
            ex, Gf.astype(np.float32), Dhat, n_rhs=n_rhs or 1, **kw)
    elif n_rhs is None:
        kA, kB, _ = pk.make_fused_cg_kernels(
            ex, Kcat, a, defer_x=defer_x,
            target_win=128 if name == "panel" else 3072, **kw)
    else:
        kA, kB, _ = pk.make_fused_cg_kernels_batched(
            ex, Kcat, a, n_rhs=n_rhs, defer_x=defer_x, **kw)
    assert kA._prep.has_far and kA._prep.n_far > 0
    return kA, kB


def _consistent(ex, rng, k=1, lo=None, hi=None):
    """Random consistent float32 L-vectors, a (k n, E) stack."""
    out = []
    for _ in range(k):
        shp = (ex.n_loc, ex.E)
        v = (rng.standard_normal(shp) if lo is None
             else rng.uniform(lo, hi, shp))
        out.append(np.asarray(jit_dss_T(ex)(jnp.asarray(
            v.astype(np.float32)))))
    return np.concatenate(out, axis=0)


def _ref_corrected(kA, Ap, k):
    """The reference's Ap: its near Ap with each RHS's far rows added."""
    prep = kA._prep
    near, far = (np.asarray(v, np.float32) for v in Ap)
    n, nf = prep.n, prep.n_far
    return np.concatenate([np.asarray(prep.add_far(
        jnp.asarray(near[j * n:(j + 1) * n]),
        jnp.asarray(far[j * nf:(j + 1) * nf]))) for j in range(k)])


def _port_corrected(Ap, far_plan, k, n):
    """The port's Ap: its near Ap with the far classes of its raw rows."""
    near, aux = Ap
    E = near.shape[-1]
    rows = aux.reshape(k, -1, E)
    return kernels.far_update_plain(near.reshape(k, n, E).clone(), rows,
                                    far_plan).reshape(near.shape)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


STEPS = {"affine-f32": ("affine", None, False, False),
         "affine-bf16": ("affine", None, False, True),
         "affine-deferred-f32": ("affine", None, True, False),
         "affine-deferred-bf16": ("affine", None, True, True),
         "affine-batched-f32": ("affine", K_RHS, False, False),
         "affine-batched-bf16": ("affine", K_RHS, False, True),
         "affine-batched-deferred-f32": ("affine", K_RHS, True, False),
         "general-f32": ("general", None, False, False),
         "general-bf16": ("general", None, False, True),
         "general-batched-f32": ("general", K_RHS, False, False),
         "panel-bf16": ("panel", None, False, True)}


@pytest.mark.parametrize("name,n_rhs,defer_x,bf16", list(STEPS.values()),
                         ids=list(STEPS))
def test_kernel_step_matches_reference(name, n_rhs, defer_x, bf16):
    prob, ex, *_ = _problem(name)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    op = _port(name, _halo(name), p_dtype=tdt if bf16 else None)
    far = op.A.far_plan
    assert far is not None and far.n_entries > 0
    kA, kB = _ref_kernels(name, bf16, n_rhs, defer_x)
    kA_t, kB_t = op.fused_kernels(n_rhs or 1, defer_x=defer_x)
    assert kA_t.far_plan is far and kB_t.far_plan is far
    k, n = n_rhs or 1, ex.n_loc
    rng = np.random.RandomState(23)
    r, p = _consistent(ex, rng, k), _consistent(ex, rng, k)
    inv = _consistent(ex, rng, lo=0.5, hi=1.5)
    x = rng.standard_normal(r.shape).astype(np.float32)
    w = np.asarray(ex.weights.T, np.float32)
    sc = [np.array([0.7, 1.1][:k], np.float32),
          np.array([0.4, 0.9][:k], np.float32),
          np.array([0.3, -0.8][:k], np.float32)]
    if n_rhs is None:
        sc = [v[0] for v in sc]
    beta, alpha_prev, alpha = sc
    args = (jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt))
    targs = (torch.tensor(r), torch.tensor(p).to(tdt),
             torch.tensor(inv).to(tdt))
    if defer_x:
        ref = kA(*args, jnp.asarray(beta))
        got = kA_t(*targs, torch.tensor(beta))
    else:
        ref = kA(*args, jnp.asarray(x), jnp.asarray(beta),
                 jnp.asarray(alpha_prev))
        got = kA_t(*targs, torch.tensor(x), torch.tensor(beta),
                   torch.tensor(alpha_prev))
        _close(got[2].numpy(), np.asarray(ref[2]), 1e-5)
    rel = BF16_REL if bf16 else 1e-5
    p_ref = np.asarray(ref[0], np.float32)
    np.testing.assert_allclose(got[0].float().numpy(), p_ref,
                               rtol=BF16_REL if bf16 else 1e-5,
                               atol=1e-6 if bf16 else 1e-5)
    Ap_ref = _ref_corrected(kA, ref[1], k)
    Ap = _port_corrected(got[1], far, k, n)
    _close(Ap.numpy(), Ap_ref, rel)
    # the near Ap alone misses the far classes (a guard against an empty
    # split)
    assert np.abs(got[1][0].numpy() - Ap_ref).max() > 1e-3 * np.abs(
        Ap_ref).max()
    np.testing.assert_allclose(got[-1].reshape(-1, k).sum(0).numpy(),
                               np.asarray(ref[-1]).reshape(-1, k).sum(0),
                               rtol=rel)
    wf, iv = jnp.asarray(w, jdt), jnp.asarray(inv, jdt)
    r_ref, rz_ref, rn_ref = kB(jnp.asarray(r), ref[1], iv, wf,
                               jnp.asarray(alpha))
    r_new, rzp, rnp = kB_t(torch.tensor(r), got[1], targs[2],
                           torch.tensor(w).to(tdt), torch.tensor(alpha))
    _close(r_new.numpy(), np.asarray(r_ref), rel)
    for a_, b_ in ((rzp, rz_ref), (rnp, rn_ref)):
        np.testing.assert_allclose(a_.reshape(-1, k).sum(0).numpy(),
                                   np.asarray(b_).reshape(-1, k).sum(0),
                                   rtol=rel)
    # kernel B's far mode is far_update then kernel B, bit for bit
    plain_b = (kernels.cg_kernel_b_plain if n_rhs is None
               else kernels.cg_kernel_b_batched_plain)
    want = plain_b(torch.tensor(r), Ap, targs[2], torch.tensor(w).to(tdt),
                   torch.tensor(alpha))
    assert torch.equal(r_new, want[0])
    assert all(c == 0 for c in kernels.launch_counts().values())


def _solve64(kA, kB, b, inv, w, tol, m, k):
    """The port's fused iteration (``cg_fused``'s ``_fused_step`` or
    ``_deferred_step``) in float64, from x0 = 0 until ``rn2 <= tol^2 rn0``
    per RHS: (x, iterations)."""
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64)
    shape = () if k is None else (k,)
    b3 = b if k is None else b.view(k, *inv.shape)
    dims = (0, 1) if k is None else (1, 2)
    rn0 = (w * b3 * b3).sum(dims)
    rz0 = (w * b3 * (inv * b3)).sum(dims)
    it0 = torch.zeros(shape, dtype=torch.int32)
    max_it = torch.full(shape, 5000, dtype=torch.int32)
    stop2 = tol * tol * rn0
    x0 = torch.zeros_like(b)
    if m:
        state = port_cg._DeferredState(
            x0, b, tuple(torch.zeros_like(b) for _ in range(m)), rz0, rz0,
            it0, rn0, max_it, stop2, rn0)
        step = port_cg._deferred_step(kA, kB, inv, w, zero, m)
    else:
        state = port_cg._FusedState(x0, b, torch.zeros_like(b), rz0, rz0,
                                    torch.zeros(shape, dtype=f64), it0, rn0,
                                    max_it, stop2, rn0)
        step = port_cg._fused_step(kA, kB, inv, w, zero)
    while not bool((state.rn2 <= state.stop2).all()):
        assert int(state.k.max()) < 5000
        state = step(state)
    x = state.x if m else port_cg._pending(state)
    return x, state.k


@functools.lru_cache(maxsize=None)
def _system64(name):
    """The float64 split and unsplit port operators, the Jacobi inverse
    diagonal, the dot weights on the free rows and two right-hand sides
    (the problem's and a random consistent one) of one mesh."""
    prob, ex, *_ = _problem(name, np.float64)
    split, whole = (_port(name, h, np.float64) for h in (1, None))
    free = split.free
    diag = torch.as_tensor(
        np.asarray(prob.operator_diagonal())[ex.gather_hier].T.copy())
    inv = torch.where(free, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)
    w = torch.where(free, split.w, 0.0)
    rand = torch.as_tensor(np.random.RandomState(5).standard_normal(
        (ex.n_loc, ex.E)))
    rhs = [torch.where(free, v, 0.0) for v in (
        split.to_local(np.asarray(prob._b) + prob._neumann),
        roll_dss_T(rand, split.plan))]
    return split, whole, inv, w, rhs


@functools.lru_cache(maxsize=None)
def _ref_solution64(name, tol):
    """The reference's float64 Jacobi CG of the problem's right-hand
    side."""
    prob, ex, Gf, Dhat, *_ = _problem(name, np.float64)
    split, _, inv, _, rhs = _system64(name)
    A_ref = jax_sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, jnp.asarray(split.free.numpy()), vector_layout="ne",
        backend="xla")
    inv_j = jnp.asarray(inv.numpy())
    res = jax_cg(A_ref, jnp.asarray(rhs[0].numpy()), M=lambda v: inv_j * v,
                 tol=tol, max_iter=5000,
                 dot_weight=jnp.asarray(split.w.numpy()))
    return np.asarray(res.x)


SOLVES = {"affine": ("affine", None, 0),
          "affine-deferred": ("affine", None, 4),
          "affine-batched": ("affine", K_RHS, 0),
          "affine-batched-deferred": ("affine", K_RHS, 2),
          "general": ("general", None, 0),
          "general-batched": ("general", K_RHS, 0)}


@pytest.mark.parametrize("name,n_rhs,m", list(SOLVES.values()),
                         ids=list(SOLVES))
def test_float64_split_solve_matches_reference(name, n_rhs, m):
    split, whole, inv, w, rhs = _system64(name)
    assert split.A.far_plan is not None and whole.A.far_plan is None
    rhs = rhs[:n_rhs or 1]
    b = torch.cat(rhs)
    tol = 1e-12
    sols = [_solve64(*op.fused_kernels(n_rhs or 1, defer_x=bool(m)), b, inv,
                     w, tol, m, n_rhs) for op in (split, whole)]
    (x_s, its_s), (x_w, its_w) = sols
    assert torch.equal(its_s, its_w)
    # the problem's right-hand side (a batch's first) against the
    # reference's float64 CG; a batch's second RHS by the iterations above
    xr = _ref_solution64(name, tol)
    xs = x_s[:inv.shape[0]].numpy()
    assert np.abs(xs - xr).max() <= 1e-10 * np.abs(xr).max()
    assert all(c == 0 for c in kernels.launch_counts().values())
