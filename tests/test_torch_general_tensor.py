"""The curved-mesh (general-factor) kernels of the port in tensor-product
form, on the CPU: their line mapping against the plain versions, the
by-value tables the operators hand them, and the ``Dh`` they refuse.

The CUDA kernels (``csrc/general_apply_dss.cu``,
``csrc/cg_kernel_a_general.cu``) run the curved product of
``csrc/sem_curved.cuh``: a block of 32 elements and M warps; warp w owns
the column line (a, w) and the row line (w, c) of each element.  The
emulation below follows that mapping from the by-value
``GeneralFactors`` tables (float32 D0 and D1, the lex-to-row map) and the
lex-order factor slabs:

* the product: u handed over through ``sm.u``; the column line stages g0
  and g1 of its nodes, the row line g2 of its own in the slot of its later
  hand-over (``sm.s``); ur on the column line from D0, us on the row line
  from D1; the column line hands over g1 ur (in the ``sm.r`` slot), the row
  line forms g2 us and hands over us in g2's slot; fr on the column line,
  fs on the row line; the column sums of S handed back through ``sm.u``
  (the sums read the transposed tables);
* the apply and kernel A (f32 and bf16 stored p', one RHS and a stack of
  two, p = 2..8) against ``general_apply_dss[_batched]_plain`` and
  ``cg_kernel_a_general[_batched]_plain`` on the derivative the same
  tables make, to 1e-12 of max in float64; the emulated kernel A's Ap'
  equals the emulated apply of its stored p';
* the tables of every ``GeneralLaplacianT`` the port builds (the Poisson
  curved and ``structure="general"`` operators, Helmholtz's ``ne``
  layout, ``interop``) against its ``Dh`` to 1e-12, and their carriers
  (``.stacked(k)``, the fused-kernel factory, ``interop``'s ``kA``);
* ``GeneralFactors`` raises on a ``Dh`` that is not ``[D0 (x) I; I (x)
  D1]`` with its columns permuted by ``hier``, and a wrapper without
  tables raises with its own name on tensors that are not on the CPU.
"""

import numpy as np
import pytest
import torch

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import general_operator_from_numpy
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.helmholtz import Helmholtz
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels, sumfac
from spectralelementmethod_torch.ops.exchange import roll_dss_T

torch.set_num_threads(2)

ANNULUS = dict(n_theta=4, n_r=3, r_inner=1.0, r_outer=2.0, progression=1.0,
               node_placement="polar")


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem(p, mesh="annulus"):
    """A float32 Poisson problem of the port on a small curved mesh."""
    m = (annulus_mesh(p, **ANNULUS) if mesh == "annulus"
         else rectangle_mesh(4, 3, p))
    prob = Poisson(Discretization(m, gll_basis_2d(p)), dtype=np.float32)
    if mesh == "annulus":
        prob.set_dirichlet("sphere", 0.0)
    else:
        prob.set_dirichlet("ebc", 0.0)
    return prob


def _operator(p, mesh="annulus", structure="auto"):
    return _problem(p, mesh)._local_setup("cpu", structure)["A"]


def _tables(f):
    """(M, D0, D1, row) from the kernels' by-value tables, in float64:
    D0[a, m] and D1[b, c] the 1D derivatives (their transposed copies,
    which the sums of S read, checked equal), row[a, b] the L-vector row
    of lex node (a, b)."""
    n = f.n
    m = int(round(n ** 0.5))
    D0, D1, D0t, D1t = (f.tables[k][:n].astype(np.float64).reshape(m, m)
                        for k in ("D0", "D1", "D0t", "D1t"))
    assert np.array_equal(D0t, D0.T) and np.array_equal(D1t, D1.T)
    row = f.tables["row"][:n].astype(np.int64).reshape(m, m)
    return m, D0, D1, row


def _table_Dh(f):
    """The stacked derivative (2n, n), columns in hier order, that the
    tables make."""
    m, D0, D1, row = _tables(f)
    eye = np.eye(m)
    Dh = np.concatenate([np.kron(D0, eye), np.kron(eye, D1)])
    return Dh[:, np.argsort(row.ravel())]


def _gen_product(X, gT, D0, D1):
    """gen_product of one tile as the warps run it: ``X`` (M, M, E) the
    column lines' operand, lex (a, w) -> X[a, w]; ``gT`` (3, n, E) the
    lex-order factor slabs.  Returns (S, Y): S[w, c] on the row lines and
    Y[w, c] the row-line operand each read from the first hand-over."""
    m = D0.shape[0]
    sm_u = np.zeros((m * m,) + X.shape[2:])
    sm_r, sm_s = np.zeros_like(sm_u), np.zeros_like(sm_u)
    # each warp's factor copies: g0 and g1 of its column line into sm.g,
    # g2 of its row line into its slots of sm.s
    g0, g1 = np.empty_like(X), np.empty_like(X)
    for w in range(m):
        for a in range(m):
            g0[a, w] = gT[0, a * m + w]
            g1[a, w] = gT[1, a * m + w]
            sm_s[w * m + a] = gT[2, w * m + a]
    for w in range(m):
        for a in range(m):
            sm_u[a * m + w] = X[a, w]
    ur, us, Y = (np.zeros_like(X) for _ in range(3))
    for w in range(m):
        Y[w] = [sm_u[w * m + c] for c in range(m)]
        for a in range(m):
            ur[a, w] = sum(D0[a, k] * X[k, w] for k in range(m))
            us[w, a] = sum(D1[a, k] * Y[w, k] for k in range(m))
    # the second hand-over: g1 ur from the column lines; the row lines form
    # g2 us from their staged g2 and hand over us in its slot
    g2us = np.empty_like(X)
    for w in range(m):
        for a in range(m):
            sm_r[a * m + w] = g1[a, w] * ur[a, w]
            g2us[w, a] = sm_s[w * m + a] * us[w, a]
            sm_s[w * m + a] = us[w, a]
    S = np.zeros_like(X)
    D0t, D1t = D0.T, D1.T
    for w in range(m):
        fr = [g0[a, w] * ur[a, w] + g1[a, w] * sm_s[a * m + w]
              for a in range(m)]
        fs = [g2us[w, a] + sm_r[w * m + a] for a in range(m)]
        for k in range(m):
            sm_u[k * m + w] = sum(D0t[k, a] * fr[a] for a in range(m))
            S[w, k] = sum(D1t[k, a] * fs[a] for a in range(m))
    for w in range(m):
        for c in range(m):
            S[w, c] = S[w, c] + sm_u[w * m + c]
    return S, Y


def _rows(S, row):
    """S[w, c] of the row lines into (n, E) L-vector rows."""
    m = row.shape[0]
    out = np.empty((m * m,) + S.shape[2:])
    for w in range(m):
        for c in range(m):
            out[row[w, c]] = S[w, c]
    return out


def _apply_lines(u, gT, f, plan):
    """The apply of one RHS as its tile runs it, float64 numpy: (Ap, the
    raw exchanged rows S[:nb])."""
    m, D0, D1, row = _tables(f)
    X = np.stack([np.stack([u[row[a, w]] for w in range(m)])
                  for a in range(m)])
    S, _ = _gen_product(X, gT, D0, D1)
    S_rows = _rows(S, row)
    return roll_dss_T(torch.tensor(S_rows), plan).numpy(), S_rows[:plan.nb]


def _store(v, bf16):
    """The stored direction: rounded to bfloat16 with bf16."""
    if not bf16:
        return v
    return torch.tensor(v).to(torch.bfloat16).double().numpy()


def _kernel_a_lines(r, p, inv, x, beta, alpha_prev, gT, f, plan, bf16):
    """Kernel A of one RHS as its tile runs it, float64 numpy:
    (p', Ap', x', the per-element partials of p' . S)."""
    m, D0, D1, row = _tables(f)
    p_out, x_out = np.empty_like(p), np.empty_like(x)
    X = np.empty((m, m, r.shape[1]))
    for w in range(m):                       # the column line (a, w)
        for a in range(m):
            j = row[a, w]
            x_out[j] = x[j] + alpha_prev * p[j]
            p_out[j] = _store(inv[j] * r[j] + beta * p[j], bf16)
            X[a, w] = p_out[j]
    S, Y = _gen_product(X, gT, D0, D1)
    d = np.zeros(r.shape[1])
    for w in range(m):                       # the row line (w, c)
        for c in range(m):
            d += Y[w, c] * S[w, c]
    Ap = roll_dss_T(torch.tensor(_rows(S, row)), plan).numpy()
    return p_out, Ap, x_out, d


def _plain_operands(A):
    """(gT, the tables' Dh, hier, plan) in float64 for the plain versions,
    after checking the tables' Dh against the operator's."""
    f = A.factors
    Dh = _table_Dh(f)
    assert np.abs(Dh - A.Dh.double().numpy()).max() <= \
        1e-12 * np.abs(Dh).max()
    return A.gT.double(), torch.tensor(Dh), A.hier, A.plan


@pytest.mark.parametrize("p", range(1, 9))
def test_apply_lines_match_the_plain_version(p):
    """The apply's line mapping from the tables, one RHS and a stack of
    two: Ap and the raw exchanged rows of
    ``general_apply_dss[_batched]_plain`` on the derivative the tables
    make, to 1e-12 of max in float64.  At p = 1 (the p-multigrid coarse
    level) every node is a vertex and every row is exchanged."""
    A = _operator(p)
    gT, Dh, hier, plan = _plain_operands(A)
    assert 0 < plan.nb < A.factors.n or (p == 1 and plan.nb == 4)
    rng = np.random.RandomState(p)
    n, E = A.factors.n, plan.E
    u = rng.standard_normal((2 * n, E))
    got = [_apply_lines(u[j * n:(j + 1) * n], gT.numpy(), A.factors, plan)
           for j in range(2)]
    ref, aux = kernels.general_apply_dss_plain(torch.tensor(u[:n]), gT, Dh,
                                               hier, plan, aux=True)
    assert _rel(got[0][0], ref.numpy()) < 1e-12
    assert _rel(got[0][1], aux.numpy()) < 1e-12
    ref2 = kernels.general_apply_dss_batched_plain(torch.tensor(u), gT, Dh,
                                                   hier, plan)
    assert _rel(np.concatenate([g[0] for g in got]), ref2.numpy()) < 1e-12


@pytest.mark.parametrize("p", range(2, 9))
def test_kernel_a_lines_match_the_plain_version(p):
    """Kernel A's line mapping from the tables, f32 and bf16 stored p', one
    RHS and a stack of two: p', Ap', x' and the per-element partials of
    ``cg_kernel_a_general[_batched]_plain``, to 1e-12 of max in float64;
    the emulated Ap' is the emulated apply of the stored p', exactly."""
    A = _operator(p)
    gT, Dh, hier, plan = _plain_operands(A)
    rng = np.random.RandomState(20 + p)
    n, E = A.factors.n, plan.E
    t = torch.tensor
    for k, bf16 in ((1, False), (1, True), (2, False), (2, True)):
        pdt = torch.bfloat16 if bf16 else torch.float64
        r = rng.standard_normal((k * n, E))
        x = rng.standard_normal((k * n, E))
        # p and inv as the kernel reads them: values of p's type
        pv = _store(rng.standard_normal((k * n, E)), bf16)
        inv = _store(rng.uniform(0.5, 1.5, (n, E)), bf16)
        beta, alpha = rng.uniform(0.2, 1.2, k), rng.uniform(0.2, 1.2, k)
        got = []
        for j in range(k):
            sl = slice(j * n, (j + 1) * n)
            got.append(_kernel_a_lines(r[sl], pv[sl], inv, x[sl], beta[j],
                                       alpha[j], gT.numpy(), A.factors, plan,
                                       bf16))
            own, _ = _apply_lines(got[-1][0], gT.numpy(), A.factors, plan)
            assert np.array_equal(got[-1][1], own), (k, bf16, j)
        args = (t(r), t(pv).to(pdt), t(inv).to(pdt), t(x))
        if k == 1:
            ref = kernels.cg_kernel_a_general_plain(
                *args, float(beta[0]), float(alpha[0]), gT, Dh, hier, plan)
            d_ref = ref[3].numpy()[:, None]
        else:
            ref = kernels.cg_kernel_a_general_batched_plain(
                *args, t(beta), t(alpha), gT, Dh, hier, plan)
            d_ref = ref[3].numpy()
        for i in range(3):
            g = np.concatenate([o[i] for o in got])
            assert _rel(g, ref[i].double().numpy()) < 1e-12, (k, bf16, i)
        d = np.stack([o[3] for o in got], axis=1)
        assert _rel(d, d_ref) < 1e-12, (k, bf16)


def _check_tables(A):
    """The operator's tables make its Dh to 1e-12 of max (in float64)."""
    f = A.factors
    assert isinstance(f, kernels.GeneralFactors)
    Dh = A.Dh.double().numpy()
    assert f.n == Dh.shape[1]
    assert np.array_equal(f.hier, A.hier.numpy())
    assert np.abs(_table_Dh(f) - Dh).max() <= 1e-12 * np.abs(Dh).max()


@pytest.mark.parametrize("p", range(2, 9))
def test_operator_tables_match_its_Dh(p):
    """The curved Poisson operator and the general apply forced on a
    rectangle, at every compiled order: tables against ``Dh``, and the
    stacked operator carries them."""
    for A in (_operator(p), _operator(p, "rect", "general")):
        assert A.structure == "general"
        _check_tables(A)
        assert A.stacked(2).factors is A.factors
        assert A.masked(None).factors is A.factors


def test_other_builders_tables_and_carriers():
    """Helmholtz's ``ne`` operator, ``make_multi_rhs_laplacian_T`` and
    ``interop.general_operator_from_numpy``: their tables against their
    ``Dh``, and the fused kernel A they bind carries them."""
    disc = Discretization(annulus_mesh(3, **ANNULUS), gll_basis_2d(3))
    hm = Helmholtz(disc, forcing=1.0, coefficient=lambda x, y: 1 + 0.1 * x,
                   reaction=2.0, dtype=np.float32)
    hm.set_dirichlet("sphere", 0.0)
    lap = hm._local_ops("auto", "ne", "auto", "jacobi", "cpu")["A"].lap
    assert isinstance(lap, sumfac.GeneralLaplacianT)
    _check_tables(lap)
    prob = _problem(3)
    ctx = prob._local_setup("cpu")
    ex = ctx["ex"]
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    multi = sumfac.make_multi_rhs_laplacian_T(ex, Gf, Dhat, 3, device="cpu")
    _check_tables(multi)
    assert multi.n_rhs == 3
    op = general_operator_from_numpy(
        Gf, Dhat, ex.hier, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu")
    _check_tables(op.A_raw)
    assert op.A.factors is op.A_raw.factors
    assert op.kA.factors is op.A.factors
    for n_rhs in (None, 2):
        kA, _ = ctx["A"].fused_cg_kernels(n_rhs)
        assert kA.factors is ctx["A"].factors


def _bad_Dh(case):
    """(Dh, hier) pairs that are not [D0 (x) I; I (x) D1] with columns
    permuted by hier."""
    A = _operator(3)
    Dh, hier = A.Dh.double().numpy(), A.hier.numpy()
    n = Dh.shape[1]
    if case == "dense":
        return np.random.RandomState(0).standard_normal((2 * n, n)), hier
    if case == "one-entry":
        bad = Dh.copy()
        bad[1, 2] += 1e-3
        return bad, hier
    if case == "other-order":
        return Dh, np.roll(hier, 1)
    if case == "no-permutation":
        return Dh, np.zeros_like(hier)
    if case == "shape":
        return Dh[:n], hier
    # p = 9: no compiled instantiation
    m = 10
    D = np.random.RandomState(1).standard_normal((m, m))
    return np.concatenate([np.kron(D, np.eye(m)), np.kron(np.eye(m), D)]), \
        np.arange(m * m)


@pytest.mark.parametrize("case", ["dense", "one-entry", "other-order",
                                  "no-permutation", "shape", "n100"])
def test_general_factors_refuse_other_Dh(case):
    """The repair: ``GeneralFactors`` raises on a ``Dh`` the kernels would
    read wrongly (they read only D0 and D1); an operator on a CUDA device
    raises with it, one on the CPU keeps its plain version (no tables)."""
    Dh, hier = _bad_Dh(case)
    with pytest.raises(ValueError, match="not .D0 .x. I; I .x. D1."):
        kernels.GeneralFactors(Dh, hier)
    if case != "n100":
        with pytest.raises(ValueError):
            sumfac._general_factors(Dh, hier, "cuda")
    assert sumfac._general_factors(Dh, hier, "cpu") is None


def test_wrapper_checks_the_tables_against_Dh():
    """The tables are checked against the plain version's ``Dh`` and
    ``hier`` before a launch: the tables of another derivative raise."""
    A = _operator(3)
    ptr = kernels._require_general_factors(A.factors, A.Dh, A.hier, "w")
    assert ptr == A.factors.tables.ctypes.data
    other = kernels.GeneralFactors(2 * A.Dh.double().numpy(), A.hier)
    with pytest.raises(ValueError, match="^w: Dh and hier"):
        kernels._require_general_factors(other, A.Dh, A.hier, "w")
    # an operator of another order is refused by its n
    with pytest.raises(ValueError, match="^w on CUDA tensors"):
        kernels._require_general_factors(_operator(2).factors, A.Dh, A.hier,
                                         "w")


_WRAPPER_ARGS = {
    "general_apply_dss": lambda t, s: (t,),
    "general_apply_dss_batched": lambda t, s: (t,),
    "cg_kernel_a_general": lambda t, s: (t, t, t, t, s, s),
    "cg_kernel_a_general_batched": lambda t, s: (t, t, t, t, s, s),
}


@pytest.mark.parametrize("name", sorted(_WRAPPER_ARGS))
def test_wrapper_without_tables_raises_with_its_name(name):
    """Off the CPU (here: tensors on the meta device) each curved wrapper
    checks its tables first and, without them, raises naming itself: there
    is no fallback to the plain version."""
    A = _operator(3)
    n, E = A.factors.n, A.plan.E
    t = torch.empty((n, E), device="meta")
    s = torch.empty((1,), device="meta")
    with pytest.raises(ValueError, match=f"^{name} on CUDA tensors.*factors="):
        kernels.WRAPPERS[name](*_WRAPPER_ARGS[name](t, s),
                               A.gT.to("meta"), A.Dh.to("meta"),
                               A.hier.to("meta"), A.plan)
