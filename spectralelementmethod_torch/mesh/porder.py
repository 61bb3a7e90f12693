"""Polynomial-order change for single-geometry NCube meshes.

``mesh_with_order(mesh, p)`` builds a mesh of the same topology whose
cells have geometric order ``p``, by selecting a per-axis stride of each
cell's lexicographic node lattice.  Because mesh nodes sit at equispaced
parametric positions (the gmsh convention, see
``core/mapping.batched_geometry_2d``), the selected sublattice *is* the
exact equispaced order-``p`` lattice of the same geometry — for affine
cells the coarse geometry is exact, for curved cells it is the standard
order-``p`` geometric interpolant.

The coarse mesh **shares the fine node array**: selected nodes keep
their fine global ids (so e.g. a fine Dirichlet node mask can be reused
directly on coarse global vectors), and fine-only nodes simply go
unreferenced.  Shared faces stay shared automatically because the
per-axis selection is the same stride on both sides of every face —
no coordinate-based deduplication anywhere.

This has no counterpart in the reference (its meshes come from gmsh at
fixed order); it exists to build p-multigrid coarse levels
(:mod:`..solver.pmg`).  A numpy copy of the JAX package's
``mesh/porder.py`` (the port imports nothing of that package).
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def mesh_with_order(mesh: Mesh, order) -> Mesh:
    """Same-topology mesh with cells of geometric order ``order``.

    ``order``: int or per-axis tuple; every fine axis order must be a
    multiple of the requested coarse axis order.  Regions, boundary
    names and boundary-face markers are copied (cell numbers are
    preserved).
    """
    blocks = mesh.cell_blocks()
    if len(blocks) != 1:
        raise NotImplementedError(
            "mesh_with_order requires a single-geometry mesh "
            f"(got {len(blocks)} blocks)")
    geometry, cell_nums, node_maps = blocks[0]
    E = len(cell_nums)
    if not np.array_equal(cell_nums, np.arange(E)):
        raise NotImplementedError(
            "mesh_with_order requires contiguous cell numbering")
    shape = tuple(geometry.shape)
    orders = ((order,) * mesh.ndim if np.isscalar(order) else tuple(order))
    if len(orders) != mesh.ndim:
        raise ValueError(f"order {order!r} does not match ndim {mesh.ndim}")
    sel = [slice(None)]
    new_shape = []
    for s, pc in zip(shape, orders):
        p = s - 1
        pc = int(pc)
        if pc < 1 or p % pc:
            raise ValueError(
                f"coarse order {pc} must divide the fine axis order {p}")
        sel.append(slice(None, None, p // pc))
        new_shape.append(pc + 1)
    node_maps = node_maps.reshape((E,) + shape)[tuple(sel)]

    out = Mesh(mesh.ndim)
    out.set_nodes(mesh.nodes)
    gid = out.add_geometry(type(geometry)(*new_shape))
    for name in mesh.region_names:
        out.new_region(name)
    # per-cell region ids, in cell-number order (single chunk block)
    rids = np.concatenate([c.region_ids for c in mesh._chunks])
    out.add_cells(node_maps, gid, rids)
    for name in mesh.boundary_names:
        out.new_boundary(name)
    out._bnd_cell = list(mesh._bnd_cell)
    out._bnd_id = list(mesh._bnd_id)
    out._bnd_ndim = list(mesh._bnd_ndim)
    out._bnd_face = list(mesh._bnd_face)
    return out
