"""Finite element mesh container (host side).

Parity target: reference ``sem/discrete.py:777-1127`` (``Mesh``, ``CellBase``,
``Cell``, ``SubCell``) with three deliberate departures for the TPU design:

* **No node permutation mutation.**  The reference's ``_permute_nodes``
  (``sem/discrete.py:1115-1127``) mutates the mesh per-DOFManager, which its
  own FIXME (``sem/discrete.py:119-122``) flags as corrupting; here DOF
  numbering is a pure function of the immutable mesh (see
  ``core/discretization.py``).
* **Struct-of-arrays storage.**  Cells are stored in stacked array chunks
  (one array per ``add_cells`` call), not per-cell Python objects, so a
  1M-element mesh is a handful of numpy arrays; ``cell_blocks()`` exposes
  them directly to the device discretization.  Per-cell ``Cell`` views are
  materialized on demand only.
* **Vectorized adjacency.**  Neighbors are discovered by sorting encoded
  face-vertex keys — O(E log E) numpy instead of the reference's O(E²)
  centroid-distance scan
  (``sem/grid_importers.py:221-270``).
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

from .geometry import NCube, subface_slice

_Chunk = namedtuple("_Chunk", ["geometry_id", "node_maps", "region_ids"])


class Mesh:
    """A mesh of N-cube cells with named regions and boundaries."""

    BoundaryData = namedtuple("BoundaryData", ["ndim", "index"])

    def __init__(self, ndim: int):
        self._ndim = ndim
        self.nodes = np.zeros((ndim, 0))
        self._geometries: list[NCube] = []

        self._chunks: list[_Chunk] = []
        self._chunk_starts: list[int] = []   # first cell number of each chunk
        self._n_cells = 0

        # adjacency (filled by find_neighbors): (E, max_faces) neighbor cell
        # number / partner face, -1 = boundary/none
        self._adj_cell: np.ndarray | None = None
        self._adj_face: np.ndarray | None = None

        self._region_names: list[str] = []
        self._region_id_lookup: dict[str, int] = {}
        self._boundary_names: list[str] = []
        self._boundary_id_lookup: dict[str, int] = {}
        # boundary incidences as parallel arrays (vectorized storage)
        self._bnd_cell: list[int] = []
        self._bnd_id: list[int] = []
        self._bnd_ndim: list[int] = []
        self._bnd_face: list[int] = []
        self._centroids = None

    # -- counts ------------------------------------------------------------

    @property
    def ndim(self) -> int:
        return self._ndim

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[1]

    @property
    def n_cells(self) -> int:
        return self._n_cells

    @property
    def region_names(self):
        return list(self._region_names)

    @property
    def boundary_names(self):
        return list(self._boundary_names)

    # -- construction --------------------------------------------------------

    def add_geometry(self, geometry: NCube) -> int:
        if geometry.ndim > self.ndim:
            raise ValueError("Cell geometry has more dimensions than the mesh.")
        self._geometries.append(geometry)
        return len(self._geometries) - 1

    def new_region(self, name: str) -> int:
        region_id = len(self._region_names)
        self._region_names.append(name)
        self._region_id_lookup[name] = region_id
        return region_id

    def new_boundary(self, name: str) -> int:
        boundary_id = len(self._boundary_names)
        self._boundary_names.append(name)
        self._boundary_id_lookup[name] = boundary_id
        return boundary_id

    def set_nodes(self, nodes) -> None:
        """Set node coordinates, shape (ndim, N)."""
        nodes = np.asarray(nodes, dtype=np.float64)
        if nodes.shape[0] != self.ndim:
            raise ValueError("Points have the wrong number of dimensions.")
        self.nodes = nodes
        self._centroids = None

    def add_cell(self, node_ind, geometry_id: int, region_id: int) -> int:
        """Add one cell; ``node_ind`` is the lexicographic node-index grid."""
        geometry = self._geometries[geometry_id]
        node_ind = np.asarray(node_ind, dtype=np.int64).reshape(geometry.shape)
        self.add_cells(node_ind[None], geometry_id, region_id)
        return self._n_cells - 1

    def add_cells(self, node_maps, geometry_id: int, region_ids) -> np.ndarray:
        """Add a batch of cells sharing one geometry (struct-of-arrays path).

        ``node_maps``: (k, *geometry.shape) lexicographic node-index grids.
        ``region_ids``: scalar or (k,) region id(s).
        Returns the assigned cell numbers.
        """
        geometry = self._geometries[geometry_id]
        node_maps = np.ascontiguousarray(node_maps, dtype=np.int64)
        k = node_maps.shape[0]
        if node_maps.shape[1:] != tuple(geometry.shape):
            raise ValueError(
                f"node_maps shape {node_maps.shape[1:]} != geometry shape "
                f"{tuple(geometry.shape)}"
            )
        region_ids = np.broadcast_to(
            np.asarray(region_ids, dtype=np.int64), (k,)
        ).copy()
        self._chunks.append(_Chunk(geometry_id, node_maps, region_ids))
        self._chunk_starts.append(self._n_cells)
        nums = np.arange(self._n_cells, self._n_cells + k, dtype=np.int64)
        self._n_cells += k
        self._adj_cell = self._adj_face = None
        self._centroids = None
        return nums

    def add_boundary_cell(self, cell_number: int, bnd_id: int, ndim: int,
                          face: int) -> None:
        """Mark ``face`` of cell ``cell_number`` as lying on boundary ``bnd_id``."""
        self._bnd_cell.append(int(cell_number))
        self._bnd_id.append(int(bnd_id))
        self._bnd_ndim.append(int(ndim))
        self._bnd_face.append(int(face))

    def add_boundary_cells(self, cell_numbers, bnd_id: int, ndim: int,
                           faces) -> None:
        """Batched :meth:`add_boundary_cell`."""
        cell_numbers = np.asarray(cell_numbers, dtype=np.int64).ravel()
        faces = np.broadcast_to(
            np.asarray(faces, dtype=np.int64), cell_numbers.shape
        )
        self._bnd_cell.extend(int(c) for c in cell_numbers)
        self._bnd_id.extend([int(bnd_id)] * cell_numbers.size)
        self._bnd_ndim.extend([int(ndim)] * cell_numbers.size)
        self._bnd_face.extend(int(f) for f in faces)

    # -- cell lookup ---------------------------------------------------------

    def _locate(self, i: int):
        """cell number -> (chunk, row)."""
        if not 0 <= i < self._n_cells:
            raise IndexError(f"cell {i} out of range [0, {self._n_cells})")
        c = int(np.searchsorted(self._chunk_starts, i, side="right")) - 1
        return self._chunks[c], i - self._chunk_starts[c]

    def get_geometries(self):
        return list(self._geometries)

    def get_geometry(self, geometry_id: int) -> NCube:
        return self._geometries[geometry_id]

    def get_cell(self, i: int) -> "Cell":
        chunk, row = self._locate(i)
        bnd: dict[int, list] = {}
        for j in np.nonzero(np.asarray(self._bnd_cell) == i)[0] \
                if self._bnd_cell else []:
            bd = Mesh.BoundaryData(self._bnd_ndim[j], self._bnd_face[j])
            bnd.setdefault(self._bnd_id[j], []).append(bd)
        return Cell(
            self,
            self._geometries[chunk.geometry_id],
            chunk.node_maps[row],
            int(chunk.region_ids[row]),
            i,
            bnd,
        )

    @property
    def cells(self):
        for i in range(self.n_cells):
            yield self.get_cell(i)

    def region_id(self, name: str) -> int:
        return self._region_id_lookup[name]

    def boundary_id(self, name: str) -> int:
        return self._boundary_id_lookup[name]

    def cells_on_boundary(self, name: str):
        bnd_id = self._boundary_id_lookup[name]
        sel = np.asarray(self._bnd_id) == bnd_id
        for cell_num in sorted(set(np.asarray(self._bnd_cell)[sel])):
            yield self.get_cell(int(cell_num))

    def boundary_faces(self, name: str) -> np.ndarray:
        """(k, 2) int array of (cell_number, face) pairs on boundary ``name``.

        Device-friendly replacement for the reference's per-cell boundary
        iteration (``sem/discrete.py:211-219``).
        """
        bnd_id = self._boundary_id_lookup[name]
        if not self._bnd_cell:
            return np.zeros((0, 2), dtype=np.int64)
        bid = np.asarray(self._bnd_id)
        cells = np.asarray(self._bnd_cell)[bid == bnd_id]
        faces = np.asarray(self._bnd_face)[bid == bnd_id]
        order = np.lexsort((faces, cells))
        return np.stack([cells[order], faces[order]], axis=1)

    def cells_are_neighbors(self, cell1: "Cell", cell2: "Cell") -> int:
        """Return the face of ``cell1`` shared with ``cell2``, or -1.

        Parity: ``sem/discrete.py:1095-1106`` (vertex-mask matching against
        ``corner_verts``).
        """
        common = np.isin(
            cell1.vertex_node_ind, cell2.vertex_node_ind, assume_unique=True
        )
        for side, vertex_mask in enumerate(cell1.geometry.corner_verts):
            if np.array_equal(common, vertex_mask):
                return side
        return -1

    @property
    def centroids(self) -> np.ndarray:
        """(n_cells, ndim) approximate cell centers (vertex means)."""
        if self._centroids is None:
            c = np.empty((self.n_cells, self.ndim))
            for chunk, start in zip(self._chunks, self._chunk_starts):
                geometry = self._geometries[chunk.geometry_id]
                k = chunk.node_maps.shape[0]
                verts = chunk.node_maps.reshape(k, -1)[
                    :, geometry.vertex_node_ind
                ]
                c[start:start + k] = self.nodes[:, verts].mean(axis=2).T
            self._centroids = c
        return self._centroids

    # -- adjacency -----------------------------------------------------------

    def _face_keys(self):
        """Encoded sorted-vertex keys for every (cell, face).

        Returns (keys, cell (F,), face (F,)) with F = sum of faces of all
        cells.  1D/2D faces (1-2 vertices) encode into one int64 column:
        ``v0 * (n_nodes + 1) + v1 + 1``; 3D faces (4 vertices) need two
        columns (a single int64 would overflow past ~55k nodes), so
        ``keys`` is (F,) or (F, 2) — ``find_neighbors`` matches both.
        """
        N = max(self.n_nodes, 1)
        keys, cells, faces = [], [], []
        ncols = 1
        for chunk, start in zip(self._chunks, self._chunk_starts):
            geometry = self._geometries[chunk.geometry_id]
            k = chunk.node_maps.shape[0]
            flat = chunk.node_maps.reshape(k, -1)
            for face in range(geometry.n_faces):
                verts = flat[:, geometry.face_vertex_local_ind(face)]
                if verts.shape[1] == 1:
                    key = verts[:, 0] * np.int64(N + 1)
                elif verts.shape[1] == 2:
                    v = np.sort(verts, axis=1)
                    key = v[:, 0] * np.int64(N + 1) + v[:, 1] + 1
                elif verts.shape[1] == 4:
                    v = np.sort(verts, axis=1).astype(np.int64)
                    key = np.stack(
                        [v[:, 0] * np.int64(N + 1) + v[:, 1] + 1,
                         v[:, 2] * np.int64(N + 1) + v[:, 3] + 1], axis=1)
                    ncols = 2
                else:
                    raise NotImplementedError(
                        f"{verts.shape[1]}-vertex face keys")
                keys.append(key)
                cells.append(
                    np.arange(start, start + k, dtype=np.int64))
                faces.append(np.full(k, face, dtype=np.int64))
        if not keys:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        if ncols == 2:
            keys = [k if k.ndim == 2 else np.stack(
                [k, np.zeros_like(k)], axis=1) for k in keys]
        return (np.concatenate(keys), np.concatenate(cells),
                np.concatenate(faces))

    def _max_faces(self) -> int:
        return max(
            (self._geometries[c.geometry_id].n_faces for c in self._chunks),
            default=0,
        )

    def find_neighbors(self) -> None:
        """Populate cell-to-cell adjacency (vectorized).

        Sorts encoded face-vertex keys and matches equal adjacent entries —
        O(E log E) with no Python per-cell loop (the reference's version is
        an O(E²) centroid scan, ``sem/grid_importers.py:221-270``).
        """
        keys, cells, faces = self._face_keys()
        E, maxf = self.n_cells, self._max_faces()
        self._adj_cell = np.full((E, maxf), -1, dtype=np.int64)
        self._adj_face = np.full((E, maxf), -1, dtype=np.int64)
        if keys.size == 0:
            return

        if keys.ndim == 2:
            order = np.lexsort((keys[:, 1], keys[:, 0]))
            ks = keys[order]
            eq = np.all(ks[:-1] == ks[1:], axis=1)
        else:
            order = np.argsort(keys, kind="stable")
            ks = keys[order]
            eq = ks[:-1] == ks[1:]
        if np.any(eq[:-1] & eq[1:]):
            raise ValueError("a face is shared by more than 2 cells")
        first = np.nonzero(eq)[0]
        i, fi = cells[order[first]], faces[order[first]]
        j, fj = cells[order[first + 1]], faces[order[first + 1]]
        self._adj_cell[i, fi] = j
        self._adj_face[i, fi] = fj
        self._adj_cell[j, fj] = i
        self._adj_face[j, fj] = fi

    def neighbor_of(self, cell_num: int, face: int):
        """Neighbor cell number across ``face`` or None."""
        if self._adj_cell is None:
            return None
        j = self._adj_cell[cell_num, face]
        return None if j < 0 else int(j)

    def face_pairs(self) -> np.ndarray:
        """(n_pairs, 4) int array of interior face matches (i, fi, j, fj).

        Each conforming interior face appears once (with i < j or
        (i == j and fi < fj)).
        """
        if self._adj_cell is None:
            self.find_neighbors()
        i, fi = np.nonzero(self._adj_cell >= 0)
        j = self._adj_cell[i, fi]
        fj = self._adj_face[i, fi]
        keep = (i < j) | ((i == j) & (fi < fj))
        pairs = np.stack([i[keep], fi[keep], j[keep], fj[keep]], axis=1)
        return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]

    def attach_boundary_mesh(self, bnd_mesh: "Mesh") -> None:
        """Match each boundary-mesh cell to a face of a bulk cell.

        The boundary mesh's *regions* become this mesh's boundaries (the
        Gmsh import convention, ``sem/grid_importers.py:104-133``): boundary
        ``bnd_mesh.region k`` must already exist here with the same name.
        Vectorized key match (sorted search).
        """
        keys, cells, faces = self._face_keys()
        if keys.ndim == 2:
            # 3D quad-face keys are 2 int64 columns; view as structured
            # scalars so sort/searchsorted compare lexicographically
            kdt = np.dtype([("a", "<i8"), ("b", "<i8")])
            keys = np.ascontiguousarray(keys).view(kdt).ravel()
        order = np.argsort(keys, kind="stable")
        ks, cs, fs = keys[order], cells[order], faces[order]

        N = max(self.n_nodes, 1)
        for chunk in bnd_mesh._chunks:
            geometry = bnd_mesh._geometries[chunk.geometry_id]
            if geometry.ndim != self.ndim - 1:
                # only codimension-1 entities are solver boundaries; a
                # 3D gmsh file may also carry physical curves/points
                # (feature edges) — they match no bulk face
                continue
            k = chunk.node_maps.shape[0]
            flat = chunk.node_maps.reshape(k, -1)
            verts = flat[:, geometry.hierarchical_node_order[
                : 2 ** geometry.ndim]]
            if verts.shape[1] == 1:
                bkey = verts[:, 0] * np.int64(N + 1)
            elif verts.shape[1] == 2:
                v = np.sort(verts, axis=1)
                bkey = v[:, 0] * np.int64(N + 1) + v[:, 1] + 1
            elif verts.shape[1] == 4:
                v = np.sort(verts, axis=1).astype(np.int64)
                b2 = np.stack(
                    [v[:, 0] * np.int64(N + 1) + v[:, 1] + 1,
                     v[:, 2] * np.int64(N + 1) + v[:, 3] + 1], axis=1)
                kdt = np.dtype([("a", "<i8"), ("b", "<i8")])
                bkey = np.ascontiguousarray(b2).view(kdt).ravel()
            else:
                raise NotImplementedError(
                    f"{verts.shape[1]}-vertex boundary keys")
            pos = np.searchsorted(ks, bkey)
            ok = (pos < ks.size) & (ks[np.minimum(pos, ks.size - 1)] == bkey)
            if not np.all(ok):
                bad = verts[~ok][:5]
                raise ValueError(
                    f"boundary cell(s) with vertices {bad.tolist()} match "
                    f"no bulk face"
                )
            for rid in np.unique(chunk.region_ids):
                bnd_name = bnd_mesh._region_names[rid]
                bnd_id = self._boundary_id_lookup[bnd_name]
                sel = chunk.region_ids == rid
                # one boundary record per matched bulk face
                bcells, bfaces = cs[pos[sel]], fs[pos[sel]]
                o = np.lexsort((bfaces, bcells))
                for c, f in zip(bcells[o], bfaces[o]):
                    self.add_boundary_cell(
                        int(c), bnd_id, geometry.ndim, int(f))

    # -- batched accessors ---------------------------------------------------

    def cell_blocks(self):
        """Group cells by geometry into struct-of-arrays blocks.

        Returns a list of ``(geometry, cell_numbers (E,), node_maps
        (E, *shape))`` — the element-batched representation consumed by the
        device discretization (SURVEY.md §2, "Element-batched data
        parallelism").
        """
        groups: dict[int, list[int]] = {}
        for ci, chunk in enumerate(self._chunks):
            groups.setdefault(chunk.geometry_id, []).append(ci)
        blocks = []
        for gid, chunk_ixs in sorted(groups.items()):
            geometry = self._geometries[gid]
            node_maps = np.concatenate(
                [self._chunks[ci].node_maps for ci in chunk_ixs]
            )
            nums = np.concatenate([
                np.arange(
                    self._chunk_starts[ci],
                    self._chunk_starts[ci]
                    + self._chunks[ci].node_maps.shape[0],
                    dtype=np.int64,
                )
                for ci in chunk_ixs
            ])
            blocks.append((geometry, nums, node_maps))
        return blocks


class CellBase:
    """View of one cell's nodes/topology.  Parity: ``sem/discrete.py:777-854``."""

    def __init__(self, mesh: Mesh, geometry: NCube, node_map: np.ndarray):
        self._mesh = mesh
        self._geometry = geometry
        self._node_map = node_map

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def geometry(self) -> NCube:
        return self._geometry

    @property
    def ndim(self) -> int:
        return self._geometry.ndim

    @property
    def n_nodes(self) -> int:
        return self._geometry.n_nodes

    @property
    def n_exterior_nodes(self) -> int:
        return self._geometry.n_exterior_nodes

    @property
    def n_interior_nodes(self) -> int:
        return self._geometry.n_interior_nodes

    @property
    def node_ind_lexicographic(self) -> np.ndarray:
        return self._node_map

    @property
    def nodes_lexicographic(self) -> np.ndarray:
        """(mesh.ndim, *shape) coordinates of the cell's nodes."""
        return self._mesh.nodes[:, self._node_map]

    @property
    def node_ind_hierarchical(self) -> np.ndarray:
        return self._node_map.flat[self._geometry.hierarchical_node_order]

    @property
    def nodes_hierarchical(self) -> np.ndarray:
        return self._mesh.nodes[:, self.node_ind_hierarchical]

    @property
    def vertex_node_ind(self) -> np.ndarray:
        return self._node_map.flat[self._geometry.vertex_node_ind]

    @property
    def vertex_nodes(self) -> np.ndarray:
        return self._mesh.nodes[:, self.vertex_node_ind]

    @property
    def exterior_node_ind(self) -> np.ndarray:
        return self._node_map.flat[self._geometry.exterior_node_ind]

    @property
    def interior_node_ind(self) -> np.ndarray:
        return self._node_map.flat[self._geometry.interior_node_ind]

    def sub_cell(self, face: int) -> "SubCell":
        return SubCell(self, face)


class Cell(CellBase):
    """A bulk cell with region/adjacency/boundary context."""

    def __init__(self, mesh, geometry, node_map, region_id, index,
                 boundary_data):
        super().__init__(mesh, geometry, node_map)
        self._region_id = region_id
        self._index = index
        self._boundary_data = boundary_data

    @property
    def index(self):
        return self._index

    @property
    def region_id(self) -> int:
        return self._region_id

    @property
    def region_name(self) -> str:
        return self._mesh._region_names[self._region_id]

    def neighbor(self, face: int):
        j = self._mesh.neighbor_of(self._index, face)
        return None if j is None else self._mesh.get_cell(j)

    def boundary_faces(self, name: str):
        """Faces of this cell lying on the named boundary."""
        bnd_id = self._mesh._boundary_id_lookup[name]
        return [bd.index for bd in self._boundary_data.get(bnd_id, [])]

    def boundary_cells(self, name: str):
        for face in self.boundary_faces(name):
            yield self.sub_cell(face)


class SubCell(CellBase):
    """A cell on a face of another cell.  Parity: ``sem/discrete.py:885-917``."""

    def __init__(self, parent_cell: CellBase, face: int):
        axis = face // 2
        geometry = parent_cell.geometry.sub_geometry(axis)
        node_map = subface_slice(
            face, parent_cell._node_map, parent_cell.ndim
        )
        super().__init__(parent_cell.mesh, geometry, node_map)
        self._parent_cell = parent_cell
        self._face = face

    @property
    def parent_cell(self) -> CellBase:
        return self._parent_cell

    @property
    def face(self) -> int:
        return self._face
