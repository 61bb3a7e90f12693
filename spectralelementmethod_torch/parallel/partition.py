"""Host-side element ordering and partitioning for shard locality.

A copy of the JAX package's ``parallel/partition.py`` (pure numpy; the
port keeps its own copy because importing the JAX package's module pulls in
JAX through the package).  The element order decides how many faces cross
shard boundaries when the element axis is split into blocks: contiguous
blocks of a locality-preserving order give each shard a compact subdomain,
so the DSS halo exchange moves only the cut faces.

Orders provided:

* :func:`morton_order` — Z-curve sort of element centroids (fast, meshless);
* :func:`panel_order` — panels of a lexicographic structured order;
* :func:`rcm_order` — reverse Cuthill–McKee on the element face-adjacency
  graph (scipy.sparse.csgraph);
* :func:`reorder_elements` — rebuild a (single-geometry) mesh with a new
  element order, preserving regions and named boundaries;
* :func:`cut_faces` — number of faces crossing shard boundaries for a
  given order and shard count (the quality metric).
"""

from __future__ import annotations

import numpy as np

from ..mesh.mesh import Mesh


def morton_order(centroids: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a Morton (Z-order) curve.

    ``centroids``: (E, 2).  Returns ``perm`` with ``new[i] = old[perm[i]]``.
    """
    c = np.asarray(centroids, dtype=np.float64)
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-300)
    q = np.clip(((c - lo) / span * (2**bits - 1)).astype(np.uint64),
                0, 2**bits - 1)

    def spread(x):
        # interleave zeros between bits (16 -> 32 bit spread)
        x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
        x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
    return np.argsort(code, kind="stable")


def panel_order(n_fast: int, n_slow: int, panel: int) -> np.ndarray:
    """Panel permutation of a lexicographic structured element order.

    For elements ordered ``index = slow * n_fast + fast`` (fast-axis
    neighbors at offset 1, slow-axis neighbors at offset ``n_fast``),
    regroup the fast axis into panels of ``panel`` columns traversed
    slow-axis-major: ``key = (fast // panel, slow, fast % panel)``.
    Face-neighbor offsets become

    * fast-axis, within a panel: ±1 (unchanged);
    * slow-axis: ±``panel`` (was ±``n_fast`` — the row stride);
    * fast-axis, across a panel boundary: ±(``panel * n_slow - panel + 1``)
      — a single *uniform* large offset touching only the boundary
      columns (1/``panel`` of elements): one far class of the applies'
      split (``max_halo``).

    The reference uses it to shrink the TPU kernels' halo window at large
    E.  Returns ``perm`` with
    ``new[i] = old[perm[i]]``; use :func:`reorder_elements` to apply it
    to a mesh.  ``panel`` must divide ``n_fast`` — a ragged last panel
    would make the cross-boundary offset slow-dependent (non-uniform →
    exchange tails, which the kernels refuse).
    """
    if panel <= 0:
        raise ValueError(f"panel must be positive, got {panel}")
    if n_fast % panel:
        raise ValueError(f"panel ({panel}) must divide n_fast ({n_fast})")
    fast, slow = np.meshgrid(np.arange(n_fast), np.arange(n_slow),
                             indexing="ij")
    fast, slow = fast.ravel(), slow.ravel()      # index = slow*n_fast+fast
    old_index = slow * n_fast + fast
    key = ((fast // panel) * (n_slow * panel)
           + slow * panel + fast % panel)
    perm = np.empty(n_fast * n_slow, dtype=np.int64)
    perm[key] = old_index
    return perm


def rcm_order(mesh: Mesh) -> np.ndarray:
    """Reverse Cuthill–McKee permutation of the element adjacency graph."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    pairs = mesh.face_pairs()
    E = mesh.n_cells
    if pairs.size == 0:
        return np.arange(E)
    i, _, j, _ = pairs.T
    data = np.ones(2 * len(i), dtype=np.int8)
    graph = coo_matrix(
        (data, (np.concatenate([i, j]), np.concatenate([j, i]))),
        shape=(E, E),
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(graph, symmetric_mode=True))


def reorder_elements(mesh: Mesh, perm: np.ndarray) -> Mesh:
    """New mesh with cells in the order ``perm`` (single-geometry bulk).

    Node coordinates and numbering are unchanged (DOF values transfer
    as-is); named boundaries and regions are remapped to the new cell
    numbers.
    """
    blocks = mesh.cell_blocks()
    if len(blocks) != 1:
        raise NotImplementedError(
            "reorder_elements requires a single cell geometry"
        )
    geometry, nums, node_maps = blocks[0]
    perm = np.asarray(perm)
    assert perm.shape == (mesh.n_cells,)

    out = Mesh(mesh.ndim)
    out.set_nodes(mesh.nodes)
    gid = out.add_geometry(geometry)
    for name in mesh.region_names:
        out.new_region(name)
    region_ids = np.concatenate(
        [chunk.region_ids for chunk in mesh._chunks]
    )
    out.add_cells(node_maps[perm], gid, region_ids[perm])
    out.find_neighbors()

    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    for name in mesh.boundary_names:
        bid = out.new_boundary(name)
        bf = mesh.boundary_faces(name)
        if bf.size:
            out.add_boundary_cells(inv[bf[:, 0]], bid, mesh.ndim - 1,
                                   bf[:, 1])
    return out


def cut_faces(mesh: Mesh, n_shards: int) -> int:
    """Faces whose two elements land on different shards under a
    contiguous block split of the current element order."""
    pairs = mesh.face_pairs()
    if pairs.size == 0:
        return 0
    E = mesh.n_cells
    block = -(-E // n_shards)
    si = pairs[:, 0] // block
    sj = pairs[:, 2] // block
    return int(np.sum(si != sj))
