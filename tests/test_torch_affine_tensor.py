"""The tensor-product operand of the port's affine apply kernels, on the
CPU, against the JAX package's assembled blocks and affine apply.

The CUDA apply computes ``sum_c a_c K_c u`` as ``Dr^T fr + Ds^T fs`` from
the 1D GLL derivative, the weights and three scales per element
(``csrc/sem_affine.cuh``); the port derives those factors from the
assembled ``Kcat`` it is given (``sumfac.affine_tensor_factors``):

* for p = 2..8 the derived factors rebuild the JAX package's
  ``make_affine_element_matrices(Dhat, W, order=hier)`` to 1e-12 of its max
  (float64 and float32 derivatives), and the by-value tables, applied line
  by line as the kernel's warps do, reproduce the plain product;
* the tensor form, run through ``general_apply_dss_plain`` with slabs
  ``g_c = a_c W``, equals ``affine_apply_dss_plain`` and the JAX package's
  affine apply: 1e-12 in float64, 1e-6 of max in float32 (the two sum in
  different orders);
* a perturbed or reordered ``Kcat`` has no factors: the derivation raises,
  an operator on the CPU keeps None, one on a CUDA device raises, and so
  does the kernel wrappers' operand check without factors;
* the operators from ``Poisson``, ``interop.operator_from_numpy`` and
  ``make_sharded_fused_operator`` carry the factors.
"""

import jax
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

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import operator_from_numpy
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import exchange, kernels, sumfac
from spectralelementmethod_torch.parallel import (
    device_mesh, make_sharded_fused_operator)

torch.set_num_threads(2)


def _jax_tables(nx, ny, p, dtype=np.float64):
    """The JAX package's affine operator state of a rectangle: (problem,
    exchange, Gf, Dhat, Kcat, a), Dhat in the model's dtype."""
    disc = JaxDisc(jax_rect(nx, ny, p), jax_basis(p))
    prob = JaxPoisson(disc, dtype=dtype)
    prob.set_dirichlet("ebc", 0.0)
    ex = RollExchange(disc)
    Gf = prob._G_host.reshape(disc.E, 3, -1)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = disc.basis.weight_grid().reshape(-1)
    a, exact = jax_sumfac.affine_factorization(Gf, W)
    assert exact
    Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    return prob, ex, Gf, Dhat, Kcat, a


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("p", range(1, 9))
def test_factors_rebuild_the_reference_blocks(p):
    """The derived factors make the JAX package's blocks again, to 1e-12
    of their max in float64, from a float64 and a float32 derivative (a
    float32 model rounds its derivative before assembling)."""
    for dtype in (np.float64, np.float32):
        _, ex, _, _, Kcat, _ = _jax_tables(2, 2, p, dtype)
        f = sumfac.affine_tensor_factors(Kcat)
        np.testing.assert_array_equal(f.hier, ex.hier)
        n = (p + 1) ** 2
        Dhat = sumfac.make_stacked_derivative(f.D, f.D)
        K = sumfac.make_affine_element_matrices(Dhat, f.W, order=f.hier)
        assert np.abs(K - Kcat).max() <= 1e-12 * np.abs(Kcat).max()
        np.testing.assert_array_equal(
            f.Kst, np.stack([Kcat[:, c * n:(c + 1) * n] for c in range(3)]))


@pytest.mark.parametrize("p", range(1, 9))
def test_tables_applied_by_lines_match_the_plain_product(p):
    """The kernel's by-value tables (float32 D and W, the lex-to-row map),
    applied as its warps do (warp w on column line (., w) and row line
    (w, .)), reproduce ``_local_product`` on the blocks, to the float32
    rounding of the tables."""
    _, _, _, _, Kcat, _ = _jax_tables(2, 2, p)
    f = sumfac.affine_tensor_factors(Kcat)
    m, n, E = p + 1, (p + 1) ** 2, 33
    D = f.tables["D"][:n].astype(np.float64).reshape(m, m)
    W = f.tables["W"][:n].astype(np.float64).reshape(m, m)
    row = f.tables["row"][:n].astype(np.int64).reshape(m, m)
    rng = np.random.RandomState(p)
    u = rng.standard_normal((n, E))
    a0, a1, a2 = a = rng.standard_normal((3, E))
    U = u[row]                                       # (a, b, E), lex grid
    ur = np.einsum("am,mbe->abe", D, U)              # column lines
    us = np.einsum("bc,ace->abe", D, U)              # row lines
    fr = W[..., None] * (a0 * ur + a1 * us)
    fs = W[..., None] * (a1 * ur + a2 * us)
    S = np.einsum("am,ace->mce", D, fr) + np.einsum("bc,mbe->mce", D, fs)
    got = np.empty((n, E))
    got[row.ravel()] = S.reshape(n, E)
    ref = kernels._local_product(torch.tensor(u), torch.tensor(f.Kst),
                                 torch.tensor(a)).numpy()
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nx,ny,p", [(16, 8, 3), (16, 16, 8)])
def test_tensor_form_equals_the_affine_apply(nx, ny, p, dtype):
    """``general_apply_dss_plain`` with slabs ``a_c(e) W`` and the factors'
    derivative is the affine apply: against the port's
    ``affine_apply_dss_plain`` and the JAX package's XLA affine apply."""
    prob, ex, Gf, Dhat, Kcat, a = _jax_tables(nx, ny, p, dtype)
    op = operator_from_numpy(
        Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", dtype=dtype)
    f = op.A.factors
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    gT = torch.tensor(a.T[:, None, :] * f.W[None, :, None], dtype=tdt)
    Dh = torch.tensor(sumfac.make_stacked_derivative(f.D, f.D)[:, f.hier],
                      dtype=tdt)
    hier = torch.tensor(f.hier.astype(np.int32))
    u = np.random.RandomState(4).standard_normal((ex.n_loc, ex.E))
    u = u.astype(dtype)
    got = kernels.general_apply_dss_plain(torch.tensor(u), gT, Dh, hier,
                                          op.plan).numpy()
    plain = kernels.affine_apply_dss_plain(torch.tensor(u), op.A.Kst,
                                           op.A.aT, op.plan).numpy()
    A_xla = jax_sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne")
    ref = np.asarray(jax.jit(A_xla)(jnp.asarray(u)))
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert _rel(got, plain) < tol
    assert _rel(got, ref) < tol


def test_a_kcat_without_factors_raises_on_cuda_only():
    """A perturbed or reordered Kcat has no tensor-product factors: the
    derivation raises; an operator on the CPU keeps None and runs its plain
    version; on a CUDA device the operator raises, and without factors the
    kernel wrappers' operand check raises (no fallback)."""
    prob, ex, _, _, Kcat, a = _jax_tables(4, 4, 3)
    n = Kcat.shape[0]
    bumped = Kcat.copy()
    bumped[1, 2] += 1e-9 * np.abs(Kcat).max()
    reordered = Kcat[::-1].copy()
    for bad in (bumped, reordered):
        with pytest.raises(ValueError, match="GLL"):
            sumfac.affine_tensor_factors(bad)
        assert sumfac._operator_factors(bad, "cpu") is None
        with pytest.raises(ValueError, match="tensor-product"):
            sumfac._operator_factors(bad, torch.device("cuda"))
    good = sumfac.affine_tensor_factors(Kcat)
    Kst = torch.tensor(np.stack([Kcat[:, c * n:(c + 1) * n]
                                 for c in range(3)]), dtype=torch.float32)
    with pytest.raises(ValueError, match="factors="):
        kernels._require_factors(None, Kst, "affine_apply_dss")
    with pytest.raises(ValueError, match="not the blocks"):
        kernels._require_factors(good, 2 * Kst, "affine_apply_dss")
    # the CPU operator with no factors applies as before
    op = operator_from_numpy(
        bumped, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
        ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
        ex.E_real, device="cpu", dtype=np.float64)
    assert op.A.factors is None
    u = torch.tensor(np.random.RandomState(2).standard_normal(
        (n, ex.E)))
    ref = kernels.affine_apply_dss_plain(u, op.A.Kst, op.A.aT, op.plan)
    torch.testing.assert_close(op.A_raw(u), ref, rtol=0, atol=0)


def _port_problem():
    prob = Poisson(Discretization(rectangle_mesh(8, 4, 3), gll_basis_2d(3)),
                   dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    return prob


def _factors_of(source):
    """The factors an operator of ``source`` carries, and its Kcat."""
    prob = _port_problem()
    if source == "poisson":
        ctx = prob._local_setup("cpu")
        assert ctx["A"].factors is ctx["A_raw"].factors
        return ctx["A"].factors, ctx["A"].Kst
    ex = exchange.make_exchange(prob.disc)
    Gf = prob._G_host.reshape(prob.disc.E, 3, -1)
    Dhat = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = prob.disc.basis.weight_grid().reshape(-1)
    a, _ = sumfac.affine_factorization(Gf, W)
    Kcat = sumfac.make_affine_element_matrices(Dhat, W, order=ex.hier)
    if source == "interop":
        op = operator_from_numpy(
            Kcat, a, ex.edge_classes, ex.vert_classes, ex.gather_hier,
            ex._weights_np, prob.operator_diagonal(), ~prob._dirichlet_mask,
            ex.E_real, device="cpu")
        return op.A.factors, op.A.Kst
    A = make_sharded_fused_operator(ex, Kcat, a, device_mesh(2, device="cpu"))
    Kst, _, _, factors = A._block_operands
    return factors, Kst


@pytest.mark.parametrize("source", ["poisson", "interop", "sharded"])
def test_operators_carry_the_factors(source):
    """The affine operators keep the factors of their blocks: the
    exchange's node order, the basis's derivative and weights, the lex to
    row map in the tables, and the blocks they were checked against."""
    factors, Kst = _factors_of(source)
    assert isinstance(factors, kernels.AffineFactors)
    prob = _port_problem()
    np.testing.assert_array_equal(
        factors.hier, exchange.make_exchange(prob.disc).hier)
    # a float32 model assembles from its rounded derivative
    np.testing.assert_array_equal(
        factors.D, prob.disc.basis.subbases[0].D1.astype(np.float32))
    np.testing.assert_array_equal(factors.tables["row"][:16],
                                  np.argsort(factors.hier))
    np.testing.assert_allclose(factors.Kst, Kst.double().numpy(), rtol=0,
                               atol=1e-6 * float(Kst.abs().max()))
