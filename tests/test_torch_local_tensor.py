"""The element-local Laplacian kernel and the far update of the port, on the
CPU: their mappings emulated from the host tables against the plain
versions.

The element-local kernel (``csrc/laplacian_local.cu``) runs the curved
product of ``csrc/sem_curved.cuh`` on row-major (E, n) L-vectors: a block
of 32 elements and M warps, warp w owning the column line (a, w) and the row
line (w, c) of each element, D0, D1, their transposes and the lex-to-row map
by value (``GeneralFactors``).  It stages a tile's u and its three factor
arrays linearly in shared memory, element ``lane`` at ``lane * P`` (16-byte
copies of one contiguous run when :func:`kernels.local_vec` holds, else
4-byte copies element by element at the pitch :func:`kernels.local_pitch`),
and the lines read node j of their element at ``lane * P + j``.  The
emulation below follows those offsets, the two hand-overs, the column sums
through u's slot and the output staged in L-vector order, one tile per
block looping over the k components, and holds the result against
``laplacian_local[_batched]_plain`` and ``vector_laplacian_local_plain``
in float64 at p = 2..8.

The far update (``csrc/far_update.cu``) takes the far plan's entries by
value (:func:`kernels.far_tables`) and sums each destination row from
``out`` in class order, each entry as ``select(mask && in range, aux, 0)``
at a clamped source index: emulated in float32, it equals
``far_update_plain`` bit for bit.
"""

import numpy as np
import pytest
import torch

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import annulus_mesh, rectangle_mesh
from spectralelementmethod_torch.models.helmholtz import Helmholtz
from spectralelementmethod_torch.models.poisson import Poisson
from spectralelementmethod_torch.ops import kernels, sumfac
from spectralelementmethod_torch.ops.exchange import DSSPlan

torch.set_num_threads(2)

ANNULUS = dict(n_theta=4, n_r=3, r_inner=1.0, r_outer=2.0, progression=1.0,
               node_placement="polar")
TILE = 32


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _curved(p):
    """A float32 curved Poisson operator of the port (its Dh, hier and
    tables)."""
    prob = Poisson(Discretization(annulus_mesh(p, **ANNULUS),
                                  gll_basis_2d(p)), dtype=np.float32)
    prob.set_dirichlet("sphere", 0.0)
    return prob._local_setup("cpu")["A"]


def _tables(f):
    """(M, D0, D1, D0t, D1t, row) from the by-value tables in float64; row
    is the lex-to-L-vector map."""
    n = f.n
    m = int(round(n ** 0.5))
    D0, D1, D0t, D1t = (f.tables[k][:n].astype(np.float64).reshape(m, m)
                        for k in ("D0", "D1", "D0t", "D1t"))
    return m, D0, D1, D0t, D1t, f.tables["row"][:n].astype(np.int64)


def _table_Dh(f):
    """The stacked derivative (2n, n), columns in hier order, that the
    tables make."""
    m, D0, D1, _, _, row = _tables(f)
    eye = np.eye(m)
    return np.concatenate([np.kron(D0, eye), np.kron(eye, D1)])[
        :, np.argsort(row)]


def _product(su, sg, f, P):
    """One component's product of a tile as the warps run it, from the
    linear staging: ``su`` u (T floats, element ``lane`` at ``lane * P``),
    ``sg`` the staged g0, g1, g2.  Returns the tile's output staging, S in
    L-vector order at the same offsets."""
    m, D0, D1, D0t, D1t, row = _tables(f)
    lanes = np.arange(TILE) * P
    su = su.copy()
    hr, hs = np.zeros_like(su), np.zeros_like(su)
    # the gradients, straight from the staged u (both lines)
    ur, us = {}, {}
    for w in range(m):
        x = [su[lanes + row[a * m + w]] for a in range(m)]
        y = [su[lanes + row[w * m + a]] for a in range(m)]
        for a in range(m):
            ur[a, w] = sum(D0[a, k] * x[k] for k in range(m))
            us[w, a] = sum(D1[a, k] * y[k] for k in range(m))
    # the hand-overs: g1 ur from the column lines, us from the row lines
    g2us = {}
    for w in range(m):
        for a in range(m):
            hr[lanes + a * m + w] = sg[1][lanes + a * m + w] * ur[a, w]
            g2us[w, a] = sg[2][lanes + w * m + a] * us[w, a]
            hs[lanes + w * m + a] = us[w, a]
    # the flux; the column sums into u's slot, the row sums kept
    S = {}
    for w in range(m):
        fr = [sg[0][lanes + a * m + w] * ur[a, w]
              + sg[1][lanes + a * m + w] * hs[lanes + a * m + w]
              for a in range(m)]
        fs = [g2us[w, a] + hr[lanes + w * m + a] for a in range(m)]
        for k in range(m):
            su[lanes + k * m + w] = sum(D0t[k, a] * fr[a] for a in range(m))
            S[w, k] = sum(D1t[k, a] * fs[a] for a in range(m))
    # S of the row lines, in L-vector order, into the dead g1 ur slot
    for w in range(m):
        for c in range(m):
            hr[lanes + row[w * m + c]] = S[w, c] + su[lanes + w * m + c]
    return hr


def _kernel_lines(ubuf, g, f, E, k, es, cs):
    """The kernel's blocks over a flat float64 buffer of k components
    (component c of element e at ``e * es + c * cs``), the factors ``g``
    (3, E, n): the output buffer, and whether the 16-byte staging ran."""
    n = f.n
    P = kernels.local_pitch(n)
    T = TILE * P
    # the wrapper's decision, for aligned allocations
    vec = kernels.local_vec(n, E, es, cs, (0, 0, 0))
    out = np.full_like(ubuf, np.nan)
    gflat = g.reshape(-1)
    for tile in range(-(-E // TILE)):
        e0 = tile * TILE
        ne = min(TILE, E - e0)

        def stage(src, base, stride):
            dst = np.zeros(T)
            if vec:                  # one run of ne n floats, zeros after
                assert stride == n and P == n
                dst[:ne * n] = src[base:base + ne * n]
            else:
                for el in range(ne):
                    s0 = base + el * stride
                    dst[el * P:el * P + n] = src[s0:s0 + n]
            return dst

        sg = [stage(gflat, c * E * n + e0 * n, n) for c in range(3)]
        for c in range(k):
            base = e0 * es + c * cs
            so = _product(stage(ubuf, base, es), sg, f, P)
            if vec:
                out[base:base + ne * n] = so[:ne * n]
            else:
                for el in range(ne):
                    s0 = base + el * es
                    out[s0:s0 + n] = so[el * P:el * P + n]
    return out, vec


@pytest.mark.parametrize("p", range(2, 9))
def test_local_lines_match_the_plain_version(p):
    """The line mapping from the tables and the linear staging offsets, at
    E = 44 (16-byte staging for odd n) and E = 45 (4-byte), each with a
    partial last tile: one array, a stack of three and three packed
    components, against the plain versions to 1e-12 of max in
    float64 on the derivative the tables make."""
    A = _curved(p)
    f = A.factors
    n = f.n
    Dh = torch.tensor(_table_Dh(f))
    assert np.abs(Dh.numpy() - A.Dh.double().numpy()).max() <= \
        1e-12 * np.abs(Dh.numpy()).max()
    rng = np.random.RandomState(p)
    for E in (44, 45):
        g = rng.uniform(0.5, 1.5, (3, E, n))
        gt = torch.tensor(g)
        k = 3
        u = rng.standard_normal((k, E, n))
        # one array
        got, vec = _kernel_lines(u[0].ravel(), g, f, E, 1, n, 0)
        assert vec == (n % 2 == 1 and E == 44)
        ref = kernels.laplacian_local_plain(torch.tensor(u[0]), gt, Dh,
                                            A.hier)
        assert _rel(got.reshape(E, n), ref.numpy()) < 1e-12, (E, "k=1")
        # the (k, E, n) stack: component stride E n
        ref = kernels.laplacian_local_batched_plain(torch.tensor(u), gt, Dh,
                                                    A.hier).numpy()
        got, vec = _kernel_lines(u.ravel(), g, f, E, k, n, E * n)
        assert _rel(got.reshape(k, E, n), ref) < 1e-12, (E, "stack")
        # k packed components (E, k n): element stride k n, the 4-byte path
        up = np.ascontiguousarray(u.transpose(1, 0, 2)).reshape(E, k * n)
        got, vec = _kernel_lines(up.ravel(), g, f, E, k, k * n, n)
        assert not vec
        ref = kernels.vector_laplacian_local_plain(torch.tensor(up), gt, Dh,
                                                   A.hier)
        assert _rel(got.reshape(E, k * n), ref.numpy()) < 1e-12, (E, "packed")


def test_local_staging_decisions():
    """16-byte staging only for contiguous runs at 16-byte boundaries: n
    odd, E n, the component stride and every pointer multiples of 16
    bytes; the pitch is odd."""
    assert kernels.local_vec(81, 99856, 81, 0, (0, 256, 512))
    assert kernels.local_vec(81, 99856, 81, 99856 * 81, (0, 0, 0))
    assert not kernels.local_vec(81, 99856, 4 * 81, 81, (0, 0, 0))
    assert not kernels.local_vec(81, 475, 81, 0, (0, 0, 0))
    assert not kernels.local_vec(64, 99856, 64, 0, (0, 0, 0))
    assert not kernels.local_vec(81, 99856, 81, 0, (0, 4, 0))
    assert [kernels.local_pitch(n) for n in kernels.SUPPORTED_N] == \
        [9, 17, 25, 37, 49, 65, 81]


def test_en_operator_tables_match_its_Dh():
    """``LaplacianEN`` with the kernel builds its tables once, from its
    ``Dh`` and ``hier``; the wrapper's own tables of a ``Dh`` are built
    once per ``Dh`` state; other forms of ``Dh`` are refused."""
    disc = Discretization(annulus_mesh(3, **ANNULUS), gll_basis_2d(3))
    hm = Helmholtz(disc, forcing=1.0, coefficient=lambda x, y: 1 + 0.1 * x,
                   reaction=2.0, dtype=np.float32)
    hm.set_dirichlet("sphere", 0.0)
    lap = hm._local_ops("auto", "en", "pallas", "jacobi", "cpu")["A"].lap
    assert isinstance(lap, sumfac.LaplacianEN)
    f = lap.factors
    assert isinstance(f, kernels.GeneralFactors)
    Dh = lap.Dh.double().numpy()
    assert np.array_equal(f.hier, lap.hier.numpy())
    assert np.abs(_table_Dh(f) - Dh).max() <= 1e-12 * np.abs(Dh).max()
    assert hm._local_ops("auto", "en", "xla", "jacobi",
                         "cpu")["A"].lap.factors is None
    own = kernels._local_factors(lap.Dh, lap.hier)
    assert kernels._local_factors(lap.Dh, lap.hier) is own
    assert np.array_equal(own.tables, f.tables)
    lap.Dh.mul_(2.0)                 # a new Dh state: new tables
    assert kernels._local_factors(lap.Dh, lap.hier) is not own
    lap.Dh.div_(2.0)
    bad = lap.Dh.clone()
    bad[1, 2] += 1e-3
    with pytest.raises(ValueError, match="not .D0 .x. I; I .x. D1."):
        kernels._local_factors(bad, lap.hier)
    with pytest.raises(ValueError, match="not .D0 .x. I; I .x. D1."):
        kernels._local_factors(lap.Dh, torch.roll(lap.hier, 1))
    # a Dhat without the form: no tables on the CPU (the plain version runs)
    Dhat = sumfac.make_stacked_derivative(hm._D0_host, hm._D1_host)
    Dhat = Dhat + 1e-3 * np.random.RandomState(0).standard_normal(Dhat.shape)
    op = sumfac.LaplacianEN(hm._G_host.reshape(disc.E, 3, -1), Dhat,
                            lap.hier.numpy(), lap.dss, backend="pallas")
    assert op.factors is None


@pytest.mark.parametrize("name", ["laplacian_local",
                                  "laplacian_local_batched",
                                  "vector_laplacian_local"])
def test_local_wrapper_checks_its_tables(name):
    """Off the CPU (tensors on the meta device) each wrapper checks the
    tables it is given before anything else, and raises naming itself for
    tables that are not ``GeneralFactors`` of its n: no fallback."""
    A = _curved(3)
    n, E = A.factors.n, 40
    shape = {"laplacian_local": (E, n), "laplacian_local_batched": (2, E, n),
             "vector_laplacian_local": (E, 2 * n)}[name]
    meta = dict(device="meta")
    with pytest.raises(ValueError, match=f"^{name} on CUDA tensors"):
        kernels.WRAPPERS[name](
            torch.empty(shape, **meta), torch.empty((3, E, n), **meta),
            A.Dh.to("meta"), A.hier.to("meta"),
            factors=_curved(2).factors)


def _split_plan(nx, ny, p, max_halo):
    prob = Poisson(Discretization(rectangle_mesh(nx, ny, p),
                                  gll_basis_2d(p)), dtype=np.float32)
    prob.set_dirichlet("ebc", 0.0)
    plan = prob._local_setup("cpu")["A"].plan
    return plan, *plan.split(max_halo)


@pytest.mark.parametrize("mesh", [(16, 16, 3, 4), (15, 13, 2, 1)],
                         ids=["16x16-p3-h4", "15x13-p2-h1"])
def test_far_tables_match_the_plan(mesh):
    """The by-value table of a split plan's far half: its rows with
    entries, in order, each row's entries (source row, offset, class mask)
    in the plan's class order, and every far class of the plan in it."""
    plan, near, far = _split_plan(*mesh)
    h = mesh[3]
    assert far.n_entries > 0 and near.n_entries > 0
    t = kernels.far_tables(far)
    assert kernels.far_tables(far) is t                # built once
    assert t.itemsize == kernels._FAR_TABLES.itemsize == 1032
    ent = far.entries.numpy()[:far.n_entries]
    rows = sorted(set(ent[:, 3]))
    nr = int(t["n_rows"])
    assert nr == len(rows) and list(t["dst"][:nr]) == rows
    first = t["first"][:nr + 1]
    assert first[0] == 0 and first[-1] == far.n_entries
    want = []                    # (dst, src, delta, mask) in class order
    for d0, s0, L, delta, flip, k in far.edge_blocks:
        assert abs(delta) > h
        want += [(d0 + i, s0 + (L - 1 - i if flip else i), delta, k)
                 for i in range(L)]
    want += [(d, s, delta, k) for d, s, delta, k in far.vert_rows]
    for r, d in enumerate(rows):
        q = slice(first[r], first[r + 1])
        got = list(zip(t["src"][q], t["delta"][q], t["mask"][q]))
        assert got == [(s, dl, k) for dd, s, dl, k in want if dd == d], d
    # the near half is the rest of the plan
    assert near.n_entries + far.n_entries == plan.n_entries


def test_far_tables_refuse_large_plans():
    """More than FAR_MAX_ENTRIES entries (or a row past 255) raise."""
    E = 40
    masks = np.ones((1, E), bool)
    big = DSSPlan(81, E, [], [(i % 60, (i + 1) % 60, 5, 0)
                             for i in range(kernels.FAR_MAX_ENTRIES + 1)],
                  masks, "cpu")
    with pytest.raises(ValueError, match="at most 128"):
        kernels.far_tables(big)
    ok = DSSPlan(81, E, [], [(3, 4, 5, 0)], masks, "cpu")
    assert int(kernels.far_tables(ok)["n_rows"]) == 1


def _far_lines(out, aux, far):
    """The far kernel's rows as its threads run them, float32 numpy: per
    destination row, its entries in table order, each a select at a
    clamped source index, then an add."""
    t = kernels.far_tables(far)
    masks = far.masks.numpy()
    E = out.shape[1]
    e = np.arange(E)
    out = out.copy()
    for r in range(int(t["n_rows"])):
        d = t["dst"][r]
        acc = out[d].copy()
        for q in range(t["first"][r], t["first"][r + 1]):
            s = e + t["delta"][q]
            v = aux[t["src"][q]][np.clip(s, 0, E - 1)]
            on = masks[t["mask"][q]] & (s >= 0) & (s < E)
            acc = acc + np.where(on, v, np.float32(0))
            assert acc.dtype == np.float32
        out[d] = acc
    return out


@pytest.mark.parametrize("mesh", [(16, 16, 3, 4), (15, 13, 2, 1)],
                         ids=["16x16-p3-h4", "15x13-p2-h1"])
def test_far_lines_match_the_plain_version_bit_for_bit(mesh):
    """The row-parallel select-and-add order against ``far_update_plain``,
    bit for bit (signed zeros included), on random rows; E = 256 (16-byte
    rows on the card) and E = 195 (4-byte)."""
    plan, near, far = _split_plan(*mesh)
    n, E = plan.n, plan.E
    rng = np.random.RandomState(sum(mesh))
    out = rng.standard_normal((n, E)).astype(np.float32)
    out[:, ::7] = -0.0
    aux = rng.standard_normal((plan.nb, E)).astype(np.float32)
    ref = kernels.far_update_plain(torch.tensor(out), torch.tensor(aux),
                                   far).numpy()
    got = _far_lines(out, aux, far)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert not np.array_equal(ref, out)
