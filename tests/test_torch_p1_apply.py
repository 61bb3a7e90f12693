"""The port's p = 1 apply kernels (n = 4, the p-multigrid coarse level) on
the CPU: their by-value class table and an emulation of their sums.

At n = 4 the affine and the curved apply (one RHS and k-stacks) and the
per-shard block apply are one launch each (``csrc/sem_p1.cuh``): a block
forms, in shared memory, the products of the elements its tile's sums
read (one window of elements per cluster of the plan's deltas), then
each thread adds its element's entries in the order of the class table
``kernels.p1_classes`` builds from the plan.

* The class table holds every entry of the plan's CSR form once, in that
  order, with its delta, source row, mask index and mask bit, and a slot
  that holds the product of element e + delta for every e of every tile
  (and the own rows' slot); deltas whose ranges do not meet open windows
  of their own, and the tile shrinks until the windows fit (the
  rectangle, the polar annulus, one shard's block view, built plans).
* The packed mask words hold each entry's class mask at its bit.
* A numpy emulation of the kernel's sums, in the kernel's order, reading
  the window slots the kernel reads, from the by-value tables (float32
  ``K_c`` or ``Dh``) and the class table, equals the plain versions
  (``affine_apply_dss_plain``, ``general_apply_dss_plain``,
  ``affine_block_apply_dss_plain`` with sources outside the block zero)
  and the JAX package's p = 1 apply: 1e-12 in float64, 1e-6 of max in
  float32, k = 1 and k = 3.

No JAX solve: ~11 s for the file on one worker (``-n 0``), ~7 s of it
test time.
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

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.interop import (general_operator_from_numpy,
                                                 operator_from_numpy)
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels, sumfac
from spectralelementmethod_torch.parallel import (
    device_mesh, make_sharded_fused_operator)

torch.set_num_threads(2)

ANNULUS = dict(n_theta=12, n_r=6, r_inner=1.0, r_outer=2.0, progression=1.0,
               node_placement="polar")
MESHES = ("rect", "annulus")


@functools.lru_cache(maxsize=None)
def _state(name, dtype):
    """The JAX side's p = 1 operator state and the port's operator built
    from the same arrays: (exchange, Gf, Dhat, port operator, JAX XLA
    apply)."""
    mesh = (jax_rect(16, 8, 1) if name == "rect"
            else jax_annulus(1, **ANNULUS))
    disc = JaxDisc(mesh, jax_basis(1))
    prob = JaxPoisson(disc, dtype=dtype)
    ex = RollExchange(disc)
    assert not (ex.n_edge_tail or ex.n_vert_tail)
    Gf = prob._G_host.reshape(disc.E, 3, -1).astype(dtype)
    Dhat = jax_sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    common = (ex.edge_classes, ex.vert_classes, ex.gather_hier,
              ex._weights_np, prob.operator_diagonal(),
              ~prob._dirichlet_mask, ex.E_real)
    if name == "rect":
        W = disc.basis.weight_grid().reshape(-1)
        a, exact = jax_sumfac.affine_factorization(Gf, W)
        assert exact
        Kcat = jax_sumfac.make_affine_element_matrices(Dhat, W,
                                                       order=ex.hier)
        op = operator_from_numpy(Kcat, a, *common, device="cpu",
                                 dtype=dtype)
        structure = "affine"
    else:
        op = general_operator_from_numpy(Gf, Dhat, ex.hier, *common,
                                         device="cpu", dtype=dtype)
        structure = "general"
    A_xla = jax_sumfac.make_local_laplacian_operator(
        ex, Gf, Dhat, backend="xla", vector_layout="ne", structure=structure)
    return ex, Gf, Dhat, op.A, A_xla


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _csr(plan):
    """The plan's entries (src, delta, mask, dst) in CSR order."""
    ent = plan.entries.numpy()[:plan.n_entries]
    ptr = plan.row_ptr.numpy()
    assert (np.diff(ptr) >= 0).all() and ptr[-1] == plan.n_entries
    for d in range(plan.nb):
        assert (ent[ptr[d]:ptr[d + 1], 3] == d).all()
    return ent


def _table(plan):
    """The class table's entries (src, delta, mask, dst) in its order."""
    t = kernels.p1_classes(plan)
    m = int(t["n_entries"])
    return np.stack([t["src"][:m], t["delta"][:m], t["mask"][:m],
                     t["dst"][:m]], axis=1).astype(np.int64)


def _slot_elements(cls, slot, E):
    """The element whose product slot ``slot + (e - b0)`` of e's tile holds,
    for every e (b0 the tile's first element), as the kernel reads it."""
    e = np.arange(E)
    tile = int(cls["tile"])
    base = cls["base"][:int(cls["n_windows"]) + 1].astype(np.int64)
    j = int(slot) + e % tile
    w = np.searchsorted(base, j, side="right") - 1
    return e - e % tile + cls["lo"][w] + j - base[w]


def _check_table(plan, tiles=kernels.P1_TILES):
    """Every CSR entry once, in the CSR order, with its delta, source row
    and mask index; each entry's slot (and the own rows' slot) holds the
    product of element e + delta for every e of every tile."""
    ent = _csr(plan).astype(np.int64)
    cls = kernels.p1_classes(plan, tiles)
    m = int(cls["n_entries"])
    tab = np.stack([cls["src"][:m], cls["delta"][:m], cls["mask"][:m],
                    cls["dst"][:m]], axis=1).astype(np.int64)
    np.testing.assert_array_equal(tab, ent)
    nw = int(cls["n_windows"])
    assert nw <= kernels.P1_MAX_WINDOWS
    assert cls["base"][nw] <= kernels.P1_SLOTS
    e = np.arange(plan.E)
    np.testing.assert_array_equal(_slot_elements(cls, cls["own_slot"],
                                                 plan.E), e)
    for i in range(m):
        np.testing.assert_array_equal(
            _slot_elements(cls, cls["slot"][i], plan.E), e + tab[i, 1])
    return tab


def _block_case():
    """The p = 1 rectangle's element-sharded operator on 2 shards (the
    port's own exchange, as the sharded path builds it)."""
    prob = Poisson(Discretization(rectangle_mesh(16, 8, 1), gll_basis_2d(1)),
                   dtype=np.float64)
    ex = prob._local_setup("cpu")["ex"]
    D = sumfac.make_stacked_derivative(prob._D0_host, prob._D1_host)
    W = prob.disc.basis.weight_grid().reshape(-1)
    a, _ = sumfac.affine_factorization(prob._G_host.reshape(ex.E, 3, -1), W)
    Kcat = sumfac.make_affine_element_matrices(D, W, order=ex.hier)
    return make_sharded_fused_operator(ex, Kcat, a,
                                       device_mesh(2, device="cpu"))


@pytest.mark.parametrize("name", MESHES)
def test_class_table_holds_every_plan_entry_once(name):
    """The rectangle's and the annulus's p = 1 plans: 12 vertex entries,
    3 per row, 8 deltas, 16 mask rows; the table holds each once in the
    plan's order, and windows that hold every delta."""
    A = _state(name, np.float64)[3]
    plan = A.plan
    assert (plan.n, plan.nb, plan.n_entries, plan.n_classes) == (4, 4, 12,
                                                                 16)
    assert all(b[2] == 0 for b in plan.edge_blocks)
    tab = _check_table(plan)
    assert len(set(tab[:, 1].tolist())) == 8
    for tile in (256, 512, 1024):
        _check_table(plan, (tile,))
    # deltas -9..9: one window of 19 + tile products
    t = kernels.p1_classes(plan)
    assert t["tile"] == kernels.P1_TILES[0] and t["n_windows"] == 1
    assert kernels.p1_classes(plan) is kernels.p1_classes(plan)


def test_class_table_of_a_block_view():
    """One shard's block view keeps the global plan's entries and masks
    by index: its table is the global table."""
    Ash = _block_case()
    bp = Ash._block_plan
    assert bp.masks is None
    np.testing.assert_array_equal(
        _check_table(bp), _table(_state("rect", np.float64)[3].plan))


@pytest.mark.parametrize("name", MESHES)
def test_packed_mask_words_hold_the_entries_masks(name):
    """The plan's packed mask words: bit ``bit[i]`` of element e's word is
    entry i's class mask at e, for every entry, and no other bit is set."""
    plan = _state(name, np.float32)[3].plan
    cls = kernels.p1_classes(plan)
    words = kernels.p1_mask_words(plan).numpy().view(np.uint32)
    assert words.shape == (plan.E,)
    masks = plan.masks.numpy()
    used = 0
    for i in range(int(cls["n_entries"])):
        b = int(cls["bit"][i])
        np.testing.assert_array_equal((words >> b) & 1 == 1,
                                      masks[cls["mask"][i]])
        used |= 1 << b
    assert not (words & ~np.uint32(used)).any()
    assert kernels.p1_mask_words(plan) is kernels.p1_mask_words(plan)


def test_class_table_windows_and_refusals():
    """Deltas whose element ranges do not touch open windows of their own,
    the tile shrinks until the windows fit, and plans at another n, with
    more entries, or with no tile that fits, raise."""
    plan = _state("rect", np.float64)[3].plan
    E = 5000
    spread = kernels.DSSPlan(4, E, [], [(0, 1, -1500, 0), (1, 0, 3, 1),
                                        (2, 3, -1490, 2), (3, 2, 1200, 3)],
                             None, "cpu")
    t = kernels.p1_classes(spread, (1024, 512, 256))
    assert t["tile"] == 512 and t["n_windows"] == 3
    np.testing.assert_array_equal(t["lo"][:3], [-1500, 0, 1200])
    np.testing.assert_array_equal(t["base"][:4],
                                  [0, 522, 522 + 515, 522 + 515 + 512])
    _check_table(spread, (512,))
    with pytest.raises(ValueError, match="limit"):
        kernels.p1_classes(spread, (1024,))       # 3,085 products
    other = kernels.DSSPlan(9, plan.E, [], plan.vert_rows, None, "cpu")
    with pytest.raises(ValueError, match="n = 4"):
        kernels.p1_classes(other)
    far = kernels.DSSPlan(4, 10 ** 5, [], [
        (i % 4, (i + 1) % 4, 3000 * (i + 1), i) for i in range(12)], None,
        "cpu")
    with pytest.raises(ValueError, match="limit"):
        kernels.p1_classes(far, kernels.P1_TILES_STACK)
    many = kernels.DSSPlan(4, plan.E, [], plan.vert_rows * 3, None, "cpu")
    with pytest.raises(ValueError, match="at most"):
        kernels.p1_classes(many)


def test_fused_p1_operator_checks_the_limits_at_build_time():
    """On a CUDA device a fused n = 4 operator builds the class tables of
    its exchange's plan when it is built, so a plan beyond the p = 1
    kernels' limits raises then and not at its first apply; on the CPU the
    fused operator runs the plain versions, which have no such limit.  The
    choice reads the plan's structure only, so no card is needed."""
    far = kernels.DSSPlan(4, 10 ** 5, [], [
        (i % 4, (i + 1) % 4, 3000 * (i + 1), i) for i in range(12)], None,
        "cpu")

    class Exchange:
        n_loc, n_edge_tail, n_vert_tail = 4, 0, 0

        def __init__(self, plan):
            self._plan = plan

        def plan(self, device):
            return self._plan

    cuda = torch.device("cuda")
    for backend in ("auto", "fused"):
        with pytest.raises(ValueError, match="limit"):
            sumfac.ne_backend(Exchange(far), torch.float32, 4, cuda, backend)
        assert sumfac.ne_backend(Exchange(far), torch.float32, 4,
                                 torch.device("cpu"), backend) == "fused"
        plan = _state("rect", np.float32)[3].plan
        assert sumfac.ne_backend(Exchange(plan), torch.float32, 4, cuda,
                                 backend) == "fused"


def _emulate(u, coef, tables, cls, mask_of, structure):
    """The kernel's sums on a (k, 4, E) stack: each element's own rows from
    its slot, then per table entry, in order, the source row of the
    product in the entry's slot (the element the kernel's tile formed
    there), where entry i's mask ``mask_of(i)`` (E,) is set at e and
    e + delta lies inside [0, E)."""
    E = u.shape[-1]
    dt = u.dtype

    def product(x, c):
        if structure == "affine":
            K = tables.astype(dt)                           # (3, 4, 4)
            V = [np.zeros_like(x) for _ in range(3)]
            for kc in range(3):
                for j in range(4):
                    V[kc] = V[kc] + K[kc][:, j, None] * x[:, j:j + 1]
            return c[0] * V[0] + c[1] * V[1] + c[2] * V[2]
        Dh = tables.astype(dt)                              # (8, 4)
        gr = np.zeros(x.shape[:1] + (8, E), dt)
        for j in range(4):
            gr = gr + Dh[:, j, None] * x[:, j:j + 1]
        g0, g1, g2 = c
        f = np.concatenate([g0 * gr[:, :4] + g1 * gr[:, 4:],
                            g1 * gr[:, :4] + g2 * gr[:, 4:]], axis=1)
        S = np.zeros_like(x)
        for q in range(8):
            S = S + Dh[q][:, None] * f[:, q:q + 1]
        return S

    def slot(j):
        """The product in slot j + (e - b0) of each e's tile."""
        src = np.clip(_slot_elements(cls, j, E), 0, E - 1)
        return product(u[..., src], coef[..., src])

    acc = slot(cls["own_slot"]).copy()
    e = np.arange(E)
    for i in range(int(cls["n_entries"])):
        s = e + int(cls["delta"][i])
        ok = (s >= 0) & (s < E) & mask_of(i)
        nb = slot(cls["slot"][i])
        acc[:, cls["dst"][i]] += np.where(ok, nb[:, cls["src"][i]], 0)
    return acc


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", MESHES)
def test_emulated_sums_match_plain_and_reference(name, k, dtype):
    """The emulated kernel against the port's plain apply (one RHS and the
    k-stack) and the JAX package's XLA apply of each RHS."""
    ex, _, _, A, A_xla = _state(name, dtype)
    plan = A.plan
    rng = np.random.RandomState(11 + k)
    u = rng.standard_normal((k, 4, ex.E)).astype(dtype)
    if name == "rect":
        tables, coef = A.factors.p1_tables, A.aT.numpy()
        plain = kernels.affine_apply_dss_batched_plain
        ops = (A.Kst, A.aT)
    else:
        tables = A.factors.p1_tables
        coef = A.gT.numpy()
        plain = kernels.general_apply_dss_batched_plain
        ops = (A.gT, A.Dh, A.hier)
    cls = kernels.p1_classes(plan, (256,))
    words = kernels.p1_mask_words(plan).numpy().view(np.uint32)
    got = _emulate(u, coef, tables, cls,
                   lambda i: (words >> cls["bit"][i]) & 1 == 1, A.structure)
    ref = plain(torch.as_tensor(u.reshape(k * 4, ex.E)), *ops, plan)
    ref = ref.numpy().reshape(k, 4, ex.E)
    A_xla = jax.jit(A_xla)               # one program, not one per op
    want = np.stack([np.asarray(A_xla(jnp.asarray(u[j]))) for j in range(k)])
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert _rel(got, ref) < tol
    assert _rel(got, want) < tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_emulated_block_sums_match_the_block_plain(dtype):
    """The block apply at n = 4 on each of 2 shards: the emulation with
    the shard's runtime masks (sources outside the block zero) against
    ``affine_block_apply_dss_plain``."""
    Ash = _block_case()
    Kst, a_st, m_st, f = Ash._block_operands
    bp = Ash._block_plan
    E = _state("rect", np.float64)[0].E
    u = torch.as_tensor(np.random.RandomState(3).standard_normal((4, E)))
    blocks = u.split(E // 2, dim=1)
    cls = kernels.p1_classes(bp)
    tol = 1e-12 if dtype == np.float64 else 1e-6
    for s in range(2):
        u_ext = Ash._extended(blocks, s)
        assert u_ext.shape[-1] == bp.E
        ref = kernels.affine_block_apply_dss_plain(
            u_ext, Kst.double(), a_st[s].double(), m_st[s], bp).numpy()
        got = _emulate(u_ext.numpy()[None].astype(dtype),
                       a_st[s].double().numpy().astype(dtype),
                       f.p1_tables, cls,
                       lambda i: m_st[s].numpy()[cls["mask"][i]],
                       "affine")[0]
        assert _rel(got, ref) < tol
