"""Kernel A and the single-kernel CG iteration of the port in tensor-product
form, on the CPU: their line mapping against the plain versions and the
JAX package's kernel A, and the factors the operators hand them.

The CUDA kernels (``csrc/cg_kernel_a.cu``, ``csrc/cg_kernel_single.cu``)
run the affine apply's tile (``csrc/sem_affine.cuh``): a block of 32
elements and M warps; warp w forms the vector update on its column line
(a, w) of each element and takes the product on its row line (w, c).  The
emulation below follows that mapping from the by-value ``AffineFactors``
tables (float32 D and W, the lex-to-row map):

* kernel A: p' and x' on the column lines, the product of the stored p',
  S written by the row lines, the denominator ``sum_c p'[w, c] S[w, c]``
  from the row-line p' of the product's hand-over; one RHS and a stack of
  two, with and without x, p = 2..8, against ``cg_kernel_a[_batched]_plain``
  on the blocks the same tables make, to 1e-12 of max in float64;
* the single kernel: r', p', x', e1 and e2 on the column lines, w inv r'
  and w inv staged in the product's hand-over slots (``sm.s[a M + w]`` and
  ``sm.r[w M + a]``) and read back by the row-line owner for c1 and c2 on
  the interior rows, the gather's c1 and c2 on the exchanged rows; against
  ``cg_kernel_single_plain`` the same way;
* one case (the 16 x 8, p = 3 rectangle that ``test_torch_kernels.py``
  compiles) against the JAX package's ``make_fused_cg_kernels`` in
  interpret mode, at that file's tolerances;
* the factories and ``AffineLaplacianT.fused_cg_kernels`` /
  ``fused_cg_kernel_single`` (and ``interop``'s ``kA``) carry the
  operator's factors, and a wrapper without them raises with its own name
  on tensors that are not on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectralelementmethod_tpu.basis import gll_basis_2d as jax_basis
from spectralelementmethod_tpu.core.discretization import (
    Discretization as JaxDisc)
from spectralelementmethod_tpu.mesh import rectangle_mesh as jax_rect
from spectralelementmethod_tpu.models.poisson import Poisson as JaxPoisson
from spectralelementmethod_tpu.ops import sumfac as jax_sumfac
from spectralelementmethod_tpu.ops.exchange import RollExchange
from spectralelementmethod_tpu.ops.pallas_kernels import make_fused_cg_kernels

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import operator_from_numpy
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels, sumfac
from spectralelementmethod_torch.ops.exchange import roll_dss_T

torch.set_num_threads(2)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _tables(f):
    """(M, D, W, row) from the kernels' by-value tables, in float64: D[a, m]
    the 1D derivative, W[a, b] the weights, row[a, b] the L-vector row of
    lex node (a, b)."""
    n = f.n
    m = int(round(n ** 0.5))
    D = f.tables["D"][:n].astype(np.float64).reshape(m, m)
    W = f.tables["W"][:n].astype(np.float64).reshape(m, m)
    row = f.tables["row"][:n].astype(np.int64).reshape(m, m)
    return m, D, W, row


def _table_blocks(f):
    """The blocks K_c (3, n, n) that the float32 tables make, in float64."""
    m, D, W, _ = _tables(f)
    n = m * m
    Kcat = sumfac.make_affine_element_matrices(
        sumfac.make_stacked_derivative(D, D), W.reshape(-1), order=f.hier)
    return torch.tensor(np.stack([Kcat[:, c * n:(c + 1) * n]
                                  for c in range(3)]))


def _aff_product(X, a, D, W, hook=None, order=None):
    """aff_product of one tile as the warps run it: ``X`` (M, M, E) the
    column lines' operand, lex (a, w) -> X[a, w]; returns (S, Y, sm.r,
    sm.s), S[w, c] on the row lines, Y[w, c] the row-line operand each
    read from the first hand-over, and the second hand-over's arrays after
    the hooks.  Between the second and the third barrier the warps run one
    after another in ``order`` (default 0..M-1), each calling
    ``hook(w, sm_r, sm_s)`` after its flux reads: a hook that wrote a slot
    another warp still reads would change that warp's flux."""
    m = D.shape[0]
    a0, a1, a2 = a
    sm_u = np.zeros((m * m,) + X.shape[2:])
    for w in range(m):
        for aa in range(m):
            sm_u[aa * m + w] = X[aa, w]
    ur, us, Y = (np.zeros_like(X) for _ in range(3))
    for w in range(m):
        Y[w] = [sm_u[w * m + c] for c in range(m)]
        for aa in range(m):
            ur[aa, w] = sum(D[aa, k] * X[k, w] for k in range(m))
            us[w, aa] = sum(D[aa, k] * Y[w, k] for k in range(m))
    sm_r, sm_s = np.zeros_like(sm_u), np.zeros_like(sm_u)
    for w in range(m):
        for aa in range(m):
            sm_r[aa * m + w] = ur[aa, w]
            sm_s[w * m + aa] = us[w, aa]
    S = np.zeros_like(X)
    for w in range(m) if order is None else order:
        fr = [W[aa, w] * (a0 * ur[aa, w] + a1 * sm_s[aa * m + w])
              for aa in range(m)]
        fs = [W[w, aa] * (a1 * sm_r[w * m + aa] + a2 * us[w, aa])
              for aa in range(m)]
        if hook is not None:
            hook(w, sm_r, sm_s)
        for k in range(m):
            sm_u[k * m + w] = sum(D[aa, k] * fr[aa] for aa in range(m))
            S[w, k] = sum(D[aa, k] * fs[aa] for aa in range(m))
    for w in range(m):
        for c in range(m):
            S[w, c] = S[w, c] + sm_u[w * m + c]
    return S, Y, sm_r, sm_s


def _kernel_a_lines(r, p, inv, x, beta, alpha_prev, f, aT, plan):
    """Kernel A of one RHS as its tile runs it, float64 numpy:
    (p', Ap', x' or None, the per-element partials of p' . S)."""
    m, D, W, row = _tables(f)
    p_out, x_out = np.empty_like(p), None if x is None else np.empty_like(x)
    X = np.empty((m, m, r.shape[1]))
    for w in range(m):                       # the column line (a, w)
        for aa in range(m):
            j = row[aa, w]
            if x is not None:
                x_out[j] = x[j] + alpha_prev * p[j]
            p_out[j] = inv[j] * r[j] + beta * p[j]
            X[aa, w] = p_out[j]
    S, Y, _, _ = _aff_product(X, aT, D, W)
    S_rows, d = np.empty_like(p), np.zeros(r.shape[1])
    for w in range(m):                       # the row line (w, c)
        for c in range(m):
            d += Y[w, c] * S[w, c]
            S_rows[row[w, c]] = S[w, c]
    Ap = roll_dss_T(torch.tensor(S_rows), plan).numpy()
    return p_out, Ap, x_out, d


def _single_lines(r, Ap, p, x, inv, wt, alpha_prev, beta, f, aT, plan,
                  order=None):
    """The single kernel as its tile and its gather run it, float64 numpy:
    (r', p', Ap', x' or None, per-element [denom, c1, c2, e1, e2]);
    ``order`` as in :func:`_aff_product`."""
    m, D, W, row = _tables(f)
    nb = plan.nb
    E = r.shape[1]
    r_out, p_out = np.empty_like(r), np.empty_like(p)
    x_out = None if x is None else np.empty_like(x)
    parts = np.zeros((E, 5))
    X, q1, q2 = (np.empty((m, m, E)) for _ in range(3))
    for w in range(m):                       # the column line (a, w)
        for aa in range(m):
            j = row[aa, w]
            rv = r[j] - alpha_prev * Ap[j]
            r_out[j] = rv
            if x is not None:
                x_out[j] = x[j] + alpha_prev * p[j]
            p_out[j] = inv[j] * rv + beta * p[j]
            X[aa, w] = p_out[j]
            parts[:, 3] += wt[j] * rv * inv[j] * rv
            parts[:, 4] += wt[j] * rv * rv
            q2[aa, w] = wt[j] * inv[j]
            q1[aa, w] = q2[aa, w] * rv

    def stage(w, sm_r, sm_s):
        for aa in range(m):
            sm_s[aa * m + w] = q1[aa, w]
            sm_r[w * m + aa] = q2[aa, w]

    S, Y, sm_r, sm_s = _aff_product(X, aT, D, W, stage, order)
    S_rows = np.empty_like(r)
    for w in range(m):                       # the row line (w, c)
        for c in range(m):
            parts[:, 0] += Y[w, c] * S[w, c]
            j = row[w, c]
            S_rows[j] = S[w, c]
            if j >= nb:
                parts[:, 1] += sm_s[w * m + c] * S[w, c]
                parts[:, 2] += sm_r[c * m + w] * S[w, c] * S[w, c]
    Ap_new = roll_dss_T(torch.tensor(S_rows), plan).numpy()
    for j in range(nb):                      # the gather's rows
        q = inv[j] * Ap_new[j]
        parts[:, 1] += wt[j] * r_out[j] * q
        parts[:, 2] += wt[j] * Ap_new[j] * q
    return r_out, p_out, Ap_new, x_out, parts


def _port_operator(nx, ny, p):
    """The masked affine operator of a float64 rectangle, built by the
    fused operator's class: the factory takes the "xla" operator for
    float64 factors (the reference's rule), and these cases read the
    kernels' tables and plain versions in float64."""
    prob = Poisson(Discretization(rectangle_mesh(nx, ny, p), gll_basis_2d(p)),
                   dtype=np.float64)
    prob.set_dirichlet("ebc", 0.0)
    ctx = prob._local_setup("cpu")
    A = ctx["A"]
    Kcat = np.concatenate(list(A.Kst.numpy()), axis=1)
    return sumfac.AffineLaplacianT(
        Kcat, A.aT.numpy().T, ctx["ex"].plan("cpu"),
        dtype=torch.float64).masked(ctx["free_local"], True)


def _inputs(rng, shape, k=1):
    """r, p, inv, x, w as float64 numpy, stacks of k for r, p and x."""
    n, E = shape
    return (rng.standard_normal((k * n, E)), rng.standard_normal((k * n, E)),
            rng.uniform(0.5, 1.5, (n, E)), rng.standard_normal((k * n, E)),
            rng.uniform(0.0, 1.0, (n, E)))


@pytest.mark.parametrize("p", range(2, 9))
def test_kernel_a_lines_match_the_plain_version(p):
    """Kernel A's line mapping from the tables, one RHS and a stack of
    two, with x and deferred: p', Ap', x' and the per-element partials of
    ``cg_kernel_a[_batched]_plain`` on the blocks the tables make, to
    1e-12 of max in float64."""
    A = _port_operator(4, 3, p)
    f, aT, plan = A.factors, A.aT.numpy(), A.plan
    Kst = _table_blocks(f)
    assert np.abs(Kst.numpy() - f.Kst).max() <= 1e-6 * np.abs(f.Kst).max()
    rng = np.random.RandomState(p)
    n, E = f.n, plan.E
    for k, with_x in ((1, True), (1, False), (2, True), (2, False)):
        r, pv, inv, x, _ = _inputs(rng, (n, E), k)
        beta, alpha = rng.uniform(0.2, 1.2, k), rng.uniform(0.2, 1.2, k)
        got = []
        for j in range(k):
            sl = slice(j * n, (j + 1) * n)
            got.append(_kernel_a_lines(
                r[sl], pv[sl], inv, x[sl] if with_x else None, beta[j],
                alpha[j], f, aT, plan))
        t = torch.tensor
        xt = t(x) if with_x else None
        if k == 1:
            ref = kernels.cg_kernel_a_plain(t(r), t(pv), t(inv), xt,
                                            float(beta[0]), float(alpha[0]),
                                            Kst, A.aT, plan)
            d_ref = ref[3].numpy()[:, None]
        else:
            ref = kernels.cg_kernel_a_batched_plain(
                t(r), t(pv), t(inv), xt, t(beta), t(alpha), Kst, A.aT, plan)
            d_ref = ref[3].numpy()
        for i in (0, 1) + ((2,) if with_x else ()):
            g = np.concatenate([o[i] for o in got])
            assert _rel(g, ref[i].numpy()) < 1e-12, (k, with_x, i)
        d = np.stack([o[3] for o in got], axis=1)
        assert _rel(d, d_ref) < 1e-12
        assert not with_x or ref[2] is not None


@pytest.mark.parametrize("p", range(2, 9))
def test_single_kernel_lines_match_the_plain_version(p):
    """The single kernel's line mapping from the tables, with x and
    deferred: r', p', Ap', x' and the per-element [denom, c1, c2, e1, e2]
    (c1 and c2 from the staged w inv r' and w inv on the interior rows and
    the gather's on the exchanged rows) of ``cg_kernel_single_plain``, to
    1e-12 of max in float64, with the warps staging in either order."""
    A = _port_operator(4, 3, p)
    f, aT, plan = A.factors, A.aT.numpy(), A.plan
    assert 0 < plan.nb < f.n
    Kst = _table_blocks(f)
    rng = np.random.RandomState(10 + p)
    n, E = f.n, plan.E
    m = int(round(n ** 0.5))
    # the warps run their flux and staging in both orders
    for with_x, order in ((True, range(m)), (False, range(m)[::-1])):
        r, pv, inv, x, wt = _inputs(rng, (n, E))
        Ap = rng.standard_normal((n, E))
        alpha, beta = 0.4, 0.7
        got = _single_lines(r, Ap, pv, x if with_x else None, inv, wt, alpha,
                            beta, f, aT, plan, order)
        t = torch.tensor
        ref = kernels.cg_kernel_single_plain(
            t(r), t(Ap), t(pv), t(x) if with_x else None, t(inv), t(wt),
            alpha, beta, Kst, A.aT, plan)
        for i in (0, 1, 2) + ((3,) if with_x else ()):
            assert _rel(got[i], ref[i].numpy()) < 1e-12, (with_x, i)
        for c in range(5):
            assert _rel(got[4][:, c], ref[4].numpy()[:, c]) < 1e-12, c


@pytest.mark.parametrize("p_dtype", [None, "bfloat16"])
def test_kernel_a_lines_match_pallas(p_dtype):
    """The line mapping on the JAX package's 16 x 8, p = 3 rectangle, in
    float64 from its float32 inputs, against ``make_fused_cg_kernels`` in
    interpret mode, at ``test_torch_kernels.py``'s tolerances (the bf16
    case emulates the f32 update and compares within one bf16 ulp)."""
    bf16 = p_dtype is not None
    disc = JaxDisc(jax_rect(16, 8, 3), jax_basis(3))
    prob = JaxPoisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", lambda x, y: 0.1 * x + 0.05 * y)
    ex = RollExchange(disc)
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = jax_sumfac.affine_factorization(Gf, W)
    assert exact
    Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    op = operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu")
    kA, _, _ = make_fused_cg_kernels(
        ex, Kcat, a, interpret=True, target_win=3072,
        precision="high" if bf16 else "highest",
        p_dtype=jnp.bfloat16 if bf16 else None)
    rng = np.random.RandomState(3)
    shp = (ex.n_loc, ex.E)

    def consistent(lo=None, hi=None):
        v = (rng.standard_normal(shp) if lo is None
             else rng.uniform(lo, hi, shp))
        return np.asarray(ex.dss_T(jnp.asarray(v.astype(np.float32))))

    r, p = consistent(), consistent()
    inv = consistent(0.5, 1.5)
    x = rng.standard_normal(shp).astype(np.float32)
    beta, alpha_prev = 0.7, 0.4
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        p = np.asarray(jnp.asarray(p, jdt), np.float32)
        inv = np.asarray(jnp.asarray(inv, jdt), np.float32)
    ref = kA(jnp.asarray(r), jnp.asarray(p, jdt), jnp.asarray(inv, jdt),
             jnp.asarray(x), beta, alpha_prev)
    p_ref, Ap_ref, x_ref, d_ref = (np.asarray(v, np.float64) for v in ref)
    f64 = np.float64
    p_new, Ap, x_new, d = _kernel_a_lines(
        r.astype(f64), p.astype(f64), inv.astype(f64), x.astype(f64), beta,
        alpha_prev, op.A.factors, op.A.aT.double().numpy(), op.plan)
    np.testing.assert_allclose(x_new, x_ref, rtol=1e-5, atol=1e-5)
    if bf16:
        # the emulation keeps the f32 value the kernel rounds to bf16
        np.testing.assert_allclose(p_new, p_ref, rtol=2.0 ** -7, atol=1e-6)
        # Ap' and the partials of the stored (rounded) direction: the
        # update with r = 0 and beta = 1 passes it through unchanged
        p_st = np.asarray(jnp.asarray(p_new.astype(np.float32), jdt), f64)
        _, Ap, _, d = _kernel_a_lines(
            np.zeros_like(p_st), p_st, np.zeros_like(p_st), None, 1.0, 0.0,
            op.A.factors, op.A.aT.double().numpy(), op.plan)
    else:
        np.testing.assert_allclose(p_new, p_ref, rtol=1e-5, atol=1e-5)
    assert np.abs(Ap - Ap_ref).max() / np.abs(Ap_ref).max() < 1e-4
    assert abs(d.sum() - d_ref.sum()) / abs(d_ref.sum()) < 1e-4


def _operator_kernels(which, defer_x):
    """The kernel callable of ``which`` on a CPU operator of the port, and
    that operator."""
    A = _port_operator(4, 3, 3)
    if which == "single":
        return A.fused_cg_kernel_single(defer_x=defer_x), A
    if which == "one-rhs":
        return A.fused_cg_kernels(defer_x=defer_x)[0], A
    return A.fused_cg_kernels(3, defer_x=defer_x)[0], A


@pytest.mark.parametrize("defer_x", [False, True])
@pytest.mark.parametrize("which", ["one-rhs", "batched", "single"])
def test_fused_kernels_carry_the_operator_factors(which, defer_x):
    """``AffineLaplacianT.fused_cg_kernels`` (one RHS and batched) and
    ``fused_cg_kernel_single`` bind the operator's factors, which the
    kernels read on a CUDA device; the CPU run is the plain version."""
    fn, A = _operator_kernels(which, defer_x)
    assert isinstance(A.factors, kernels.AffineFactors)
    assert fn.factors is A.factors
    assert fn.defer_x is defer_x


def test_interop_kernel_a_carries_the_factors():
    """``operator_from_numpy``'s kernel A is bound to its operator's
    factors."""
    disc = JaxDisc(jax_rect(4, 4, 3), jax_basis(3))
    prob = JaxPoisson(disc, dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    ex = RollExchange(disc)
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, _ = jax_sumfac.affine_factorization(Gf, W)
    Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    op = operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu")
    assert op.A.factors is not None
    assert op.kA.factors is op.A.factors


_WRAPPER_ARGS = {
    "cg_kernel_a": lambda t, s: (t, t, t, t, s, s),
    "cg_kernel_a_deferred": lambda t, s: (t, t, t, s),
    "cg_kernel_a_batched": lambda t, s: (t, t, t, t, s, s),
    "cg_kernel_a_batched_deferred": lambda t, s: (t, t, t, s),
    "cg_kernel_single": lambda t, s: (t, t, t, t, t, t, s, s),
    "cg_kernel_single_deferred": lambda t, s: (t, t, t, t, t, s, s),
}


@pytest.mark.parametrize("name", sorted(_WRAPPER_ARGS))
def test_wrapper_without_factors_raises_with_its_name(name):
    """Off the CPU (here: tensors on the meta device) each wrapper checks
    its factors first and, without them, raises naming itself: there is no
    fallback to the plain version."""
    A = _port_operator(4, 3, 3)
    n, E = A.factors.n, A.plan.E
    t = torch.empty((n, E), device="meta")
    s = torch.empty((1,), device="meta")
    Kst = A.Kst.to("meta")
    with pytest.raises(ValueError, match=f"^{name} on CUDA tensors.*factors="):
        kernels.WRAPPERS[name](*_WRAPPER_ARGS[name](t, s), Kst,
                               A.aT.to("meta"), A.plan)
