"""The PyTorch port's DSS exchange against the JAX package's, in float64.

Same mesh, same random L-vector (numpy, seeded) through both packages'
``dss_T`` and ``dot_T``; the host tables of the copied exchange classes
must match the reference's exactly.
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
from spectralelementmethod_tpu.mesh.mesh import Mesh as JaxMesh
from spectralelementmethod_tpu.ops import exchange as jax_exchange

from spectralelementmethod_torch.basis import gll_basis_2d
from spectralelementmethod_torch.core.discretization import Discretization
from spectralelementmethod_torch.mesh import rectangle_mesh
from spectralelementmethod_torch.mesh.mesh import Mesh
from spectralelementmethod_torch.ops import exchange
from spectralelementmethod_torch.ops.exchange import DSSPlan, roll_dss_T

torch.set_num_threads(2)

MESHES = [
    ("rect_p3", (16, 8, 3)),
    ("rect_p8", (16, 16, 8)),
    ("rect_p1", (3, 3, 1)),             # no edge interiors
    ("anisotropic", (4, 3, (4, 6))),
]


def _pair(nx, ny, p):
    pp = p if isinstance(p, tuple) else (p,)
    jd = JaxDisc(jax_rect(nx, ny, p), jax_basis(*pp))
    td = Discretization(rectangle_mesh(nx, ny, p), gll_basis_2d(*pp))
    return jd, td


def _permuted(mesh_cls, base, seed):
    """The same mesh with its cells shuffled: roll classes cannot cover
    it, so the exchange carries tails."""
    (geometry, nums, node_maps), = base.cell_blocks()
    perm = np.random.RandomState(seed).permutation(len(nums))
    mesh = mesh_cls(2)
    mesh.set_nodes(base.nodes)
    gid = mesh.add_geometry(geometry)
    rid = mesh.new_region("interior")
    mesh.add_cells(node_maps[perm], gid, rid)
    mesh.find_neighbors()
    return mesh


def _check(ex_j, ex_t, seed):
    assert type(ex_j).__name__ == type(ex_t).__name__
    np.testing.assert_array_equal(ex_j.gather_hier, ex_t.gather_hier)
    np.testing.assert_array_equal(ex_j._weights_np, ex_t._weights_np)
    rng = np.random.RandomState(seed)
    v = rng.standard_normal((ex_j.n_loc, ex_j.E))
    u = rng.standard_normal((ex_j.n_loc, ex_j.E))
    # the reference's DSS and dot each compiled as one program
    ref = np.asarray(jax.jit(ex_j.dss_T)(jnp.asarray(v)))
    got = ex_t.dss_T(torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    d_ref = float(jax.jit(ex_j.dot_T)(jnp.asarray(u), jnp.asarray(v)))
    d_got = float(ex_t.dot_T(torch.tensor(u), torch.tensor(v)))
    assert abs(d_got - d_ref) <= 1e-12 * np.abs(u * v).sum()


@pytest.mark.parametrize("name,shape", MESHES)
def test_dss_T_and_dot_T_match_jax(name, shape):
    jd, td = _pair(*shape)
    _check(jax_exchange.make_exchange(jd), exchange.make_exchange(td), 0)


def test_dss_T_with_tails_matches_jax():
    base_j, base_t = jax_rect(4, 4, 3), rectangle_mesh(4, 4, 3)
    jd = JaxDisc(_permuted(JaxMesh, base_j, 7), jax_basis(3))
    td = Discretization(_permuted(Mesh, base_t, 7), gll_basis_2d(3))
    ex_j, ex_t = jax_exchange.RollExchange(jd), exchange.RollExchange(td)
    assert ex_t.n_edge_tail > 0 or ex_t.n_vert_tail > 0
    _check(ex_j, ex_t, 1)
    # and the generic-gather exchange on the same mesh
    _check(jax_exchange.LocalExchange(jd), exchange.LocalExchange(td), 2)


def test_plan_from_jax_classes_matches_own():
    """A plan built from the JAX exchange's class lists (the interop path)
    equals the one the port builds from its own exchange, and its
    per-row entries reproduce the roll DSS."""
    jd, td = _pair(16, 8, 3)
    ex_j, ex_t = jax_exchange.make_exchange(jd), exchange.make_exchange(td)
    plan_j = DSSPlan.from_classes(ex_j.n_loc, ex_j.E, ex_j.edge_classes,
                                  ex_j.vert_classes, "cpu")
    plan_t = ex_t.plan("cpu")
    assert plan_j.nb == plan_t.nb == ex_t.off_int
    assert torch.equal(plan_j.entries, plan_t.entries)
    assert torch.equal(plan_j.row_ptr, plan_t.row_ptr)
    assert torch.equal(plan_j.masks, plan_t.masks)

    v = torch.tensor(np.random.RandomState(3).standard_normal(
        (ex_t.n_loc, ex_t.E)))
    # the CUDA gather pass, written out in PyTorch from the entries
    out = v.clone()
    ent = plan_t.entries.tolist()
    rp = plan_t.row_ptr.tolist()
    E = ex_t.E
    for d in range(plan_t.nb):
        for src, delta, k, dst in ent[rp[d]:rp[d + 1]]:
            assert dst == d
            e = torch.arange(E)
            ok = plan_t.masks[k] & (e + delta >= 0) & (e + delta < E)
            out[d, ok] += v[src, (e + delta)[ok]]
    np.testing.assert_allclose(out.numpy(), roll_dss_T(v, plan_t).numpy(),
                               atol=1e-12)
