"""The exchanges' fixed-order sums against the ``index_add_`` they replace,
on the CPU.

``RollExchange``'s tails (the pairs outside every roll class),
``PairScatterExchange``'s scatter of the nodes shared by three or more
copies and ``gather_dss``'s vertex sums add through
``ops/exchange.accumulate``: ``index_add_`` on the CPU, the sort-based
``index_put_(accumulate=True)`` (``_sorted_sum``) on CUDA, where
``index_add_`` adds by atomics in no fixed order.  Both forms are held
here, bit for bit, against the ``index_add_`` expressions the exchanges
used before, on stacks of two L-vectors: the CUDA form by running it on
the CPU in ``accumulate``'s place.
"""

import numpy as np
import pytest
import torch

from spectralelementmethod_torch.basis import gll_basis_2d, gll_basis_3d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import box_mesh, rectangle_mesh
from spectralelementmethod_torch.ops import exchange
from spectralelementmethod_torch.parallel.partition import reorder_elements

torch.set_num_threads(2)


def _sorted_everywhere(n, idx, vals, dim=None):
    """``accumulate`` through its CUDA form on any device."""
    if dim is None:
        idx, vals, dim = idx.reshape(-1), vals.reshape(-1), 0
    return exchange._sorted_sum(n, idx, vals, dim)


@pytest.fixture(params=["cpu-form", "cuda-form"])
def form(request, monkeypatch):
    if request.param == "cuda-form":
        monkeypatch.setattr(exchange, "accumulate", _sorted_everywhere)
    return request.param


def _shuffled(mesh, seed):
    return reorder_elements(mesh, np.random.RandomState(seed).permutation(
        len(mesh.centroids)))


def _stack(E, n, seed):
    return torch.as_tensor(np.random.RandomState(seed).standard_normal(
        (2, E, n)))


def test_roll_exchange_tails_are_the_index_add_sums(form):
    """A random element order leaves every pair of an 8 x 8 p = 3 mesh
    outside the roll classes: edge and vertex tails only."""
    ex = exchange.RollExchange(Discretization(
        _shuffled(rectangle_mesh(8, 8, 3), 0), gll_basis_2d(3)))
    assert ex.n_edge_tail and ex.n_vert_tail
    vL = _stack(ex.E, ex.n_loc, 1)
    E, oe, ov, neb, ne = ex.E, ex.off_edge, ex.off_vert, ex.n_edge_block, \
        ex.ne
    want = torch.zeros_like(vL)
    Ff = vL[..., oe:oe + neb].reshape(2, E * 4, ne)
    tr = Ff[..., torch.as_tensor(ex.edge_tail_src), :]
    tr = torch.where(torch.as_tensor(ex.edge_tail_flip), tr.flip(-1), tr)
    want[..., oe:oe + neb] = torch.zeros_like(Ff).index_add_(
        -2, torch.as_tensor(ex.edge_tail_dst), tr).reshape(2, E, neb)
    Vf = vL[..., ov:ov + 4].reshape(2, E * 4)
    want[..., ov:ov + 4] = torch.zeros_like(Vf).index_add_(
        -1, torch.as_tensor(ex.vert_tail_dst),
        Vf[..., torch.as_tensor(ex.vert_tail_src)]).reshape(2, E, 4)
    assert torch.equal(ex._tails(vL), want)
    assert torch.equal(ex.dss(vL)[1], ex.dss(vL[1]))


def test_pair_scatter_sums_are_the_index_add_sums(form):
    """The 3D shuffled order: nodes of multiplicity 4 and 8 in the compact
    scatter, pairs by the partner gather."""
    ex = exchange.PairScatterExchange(Discretization(
        _shuffled(box_mesh(3, 3, 3, 2), 3), gll_basis_3d(2)))
    assert ex._n_multi
    vL = _stack(ex.E, ex.n_loc, 2)
    flat = vL.reshape(2, -1)
    pi, mi, ms = (torch.as_tensor(getattr(ex, a))
                  for a in ("_pair_idx", "_multi_idx", "_multi_seg"))
    want = flat.clone()
    want[..., pi] = flat[..., pi] + flat[
        ..., torch.as_tensor(ex._pair_partner)]
    seg = torch.zeros((2, ex._n_multi), dtype=vL.dtype).index_add_(
        -1, ms, flat[..., mi])
    want[..., mi] = seg[..., ms]
    assert torch.equal(ex.dss(vL), want.reshape(vL.shape))


def test_gather_dss_vertex_sums_are_the_index_add_sums(form):
    """The generic gather DSS of a stack: its vertex sums, once by one
    flattened ``index_add_`` with per-slice offsets."""
    lex = exchange.LocalExchange(Discretization(
        _shuffled(rectangle_mesh(6, 5, 3), 4), gll_basis_2d(3)))
    E, n = lex.E, lex.n_loc
    vL = _stack(E, n, 5)
    gid, nv = torch.as_tensor(lex.vert_gid), lex.n_vertices
    got = lex.dss(vL)
    verts = vL[..., lex.off_vert:lex.off_vert + 4].reshape(2, E * 4)
    idx = gid + nv * torch.arange(2)[:, None]
    summed = torch.zeros(2 * nv, dtype=vL.dtype).index_add_(
        0, idx.reshape(-1), verts.reshape(-1)).reshape(2, nv)
    assert torch.equal(got[..., lex.off_vert:lex.off_vert + 4],
                       summed[..., gid].reshape(2, E, 4))
    assert torch.equal(got[0], lex.dss(vL[0]))
