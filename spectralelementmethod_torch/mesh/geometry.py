"""Reference-element topology: N-cube geometries and face restriction.

Parity target: reference ``sem/geometry.py`` (``NCube`` :32, ``Line`` :219,
``Quadrilateral`` :239) and the face-orientation helper
``sem/mapping.py:19-76`` (``_subface_slice``).

All of this is host-side, tiny, and computed once per geometry; the outputs
that matter on device are plain index arrays (hierarchical orderings, face
slices) consumed by batched gathers.

Conventions (identical to the reference):

* nodes of a cell form a lexicographic grid over ``shape``;
* faces are numbered ``face = 2*axis + (0 for the -1 side, 1 for the +1
  side)``; in 2D: 0=west (u0=0), 1=east, 2=south (u1=0), 3=north;
* 1D faces of 2D cells are oriented **counter-clockwise** around the cell
  (``sem/mapping.py:49-76``);
* hierarchical node order: vertices, then edge interiors, then (in 3D faces,
  then) interior — exterior nodes first, interior last
  (``sem/geometry.py:197-212``).
"""

from __future__ import annotations

import itertools
from math import comb

import numpy as np


# 3D face -> ordered in-plane parametric axes (t0, t1) such that the
# right-handed cross product e_t0 x e_t1 points OUT of the reference cube
# (the 3D analogue of the 2D CCW convention: outward normal = tau0 x tau1,
# extending sem/mapping.py:49-76 to hexahedral faces).
FACE_AXES_3D = {
    0: (2, 1),  # u0 = -1:  e2 x e1 = -e0
    1: (1, 2),  # u0 = +1:  e1 x e2 = +e0
    2: (0, 2),  # u1 = -1:  e0 x e2 = -e1
    3: (2, 0),  # u1 = +1:  e2 x e0 = +e1
    4: (1, 0),  # u2 = -1:  e1 x e0 = -e2
    5: (0, 1),  # u2 = +1:  e0 x e1 = +e2
}


def subface_slice(face: int, arr: np.ndarray, ndim: int):
    """Restrict the trailing ``ndim`` axes of ``arr`` to a face.

    Returns a view of ``arr`` on the given face with the face's own
    orientation — counter-clockwise in 2D, outward-normal right-handed in
    3D.  Parity: ``sem/mapping.py:19-76`` (2D); the 3D convention is a
    capability extension (the reference is 2D-only,
    ``sem/mapping.py:110-111``).

    In 2D the conventions reduce to::

        face 0 (west,  u0=0):   arr[..., 0, ::-1]
        face 1 (east,  u0=-1):  arr[..., -1, :]
        face 2 (south, u1=0):   arr[..., :, 0]
        face 3 (north, u1=-1):  arr[..., ::-1, -1]

    so that traversing faces in the order south, east, north, west walks the
    cell boundary counter-clockwise without jumps.

    In 3D the face is returned as a 2D grid over its in-plane parametric
    axes ``(t0, t1)`` in the :data:`FACE_AXES_3D` order, so that
    ``d x/d t0  x  d x/d t1`` points out of the cell.
    """
    assert ndim > 1
    assert 0 <= face < 2 * ndim
    rank = arr.ndim - ndim
    ax = face // 2
    ax_pos = bool(face % 2)

    if ndim == 3:
        t0, t1 = FACE_AXES_3D[face]
        idx = [slice(None)] * arr.ndim
        idx[rank + ax] = -1 if ax_pos else 0
        sub = arr[tuple(idx)]
        # remaining trailing axes are the in-plane axes in ascending order
        rem = [d for d in range(3) if d != ax]
        perm = list(range(rank)) + [rank + rem.index(t0),
                                    rank + rem.index(t1)]
        return sub.transpose(perm)
    if ndim != 2:
        raise NotImplementedError(
            "only 2D and 3D parent elements are supported")

    # roll the face-normal axis to the front of the trailing block
    axr = ax + rank
    order = (
        list(range(rank)) + list(range(axr, arr.ndim)) + list(range(rank, axr))
    )
    arrT = arr.transpose(order)

    if ax_pos:
        if face == 3:
            slc = (slice(None),) * rank + (-1, slice(None, None, -1))
        else:  # face == 1
            slc = (slice(None),) * rank + (-1, slice(None))
    else:
        if face == 0:
            slc = (slice(None),) * rank + (0, slice(None, None, -1))
        else:  # face == 2
            slc = (slice(None),) * rank + (0, slice(None))
    return arrT[slc]


def subface_index_array(face: int, shape) -> np.ndarray:
    """Flat (lexicographic) node indices of a face, in face orientation.

    Device-friendly companion to :func:`subface_slice`: gathering with this
    index array equals slicing with ``subface_slice``.
    """
    idx = np.arange(int(np.prod(shape))).reshape(shape)
    return np.ascontiguousarray(subface_slice(face, idx, len(shape)))


class Geometry:
    """Base class for element support geometries."""


class Simplex(Geometry):
    """Triangles/tets — explicitly future work, as in the reference
    (``sem/geometry.py:20-29``)."""

    def __init__(self):
        raise NotImplementedError()


class NCube(Geometry):
    """Orthotope-shaped reference element with per-axis node counts.

    Parity: reference ``sem/geometry.py:32-216``.
    """

    #: per-side boolean masks over the corner vertices (set in subclasses)
    corner_verts: list = []

    def __init__(self, *shape: int):
        assert all(isinstance(s, (int, np.integer)) and s > 0 for s in shape)
        self._shape = tuple(int(s) for s in shape)
        self._n_nodes = int(np.prod(self._shape))
        self._n_interior_nodes = int(
            np.prod([max(s - 2, 0) for s in self._shape])
        )
        self._n_exterior_nodes = self._n_nodes - self._n_interior_nodes
        self._node_locations = np.meshgrid(
            *(np.linspace(-1.0, 1.0, s) for s in self._shape),
            indexing="ij",
            sparse=True,
        )
        self._hier_node_order = self._compute_hierarchical_node_ordering()
        self._hier_node_order.setflags(write=False)
        self._sub_geo_class = NCube

    # -- counts ------------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def shape(self):
        return self._shape

    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def n_exterior_nodes(self) -> int:
        return self._n_exterior_nodes

    @property
    def n_interior_nodes(self) -> int:
        return self._n_interior_nodes

    @property
    def nodes(self):
        """Sparse meshgrid of reference-cube node locations in [-1, 1]^d."""
        return self._node_locations

    def n_sub_geometries(self, dim: int = -1) -> int:
        """Number of dim-dimensional sub-geometries: 2^(n-dim) C(n, dim)."""
        if dim < 0:
            dim = self.ndim + dim
        if not 0 <= dim <= self.ndim:
            raise ValueError(f"no {dim}D sub-geometry of a {self.ndim}D cell")
        n = self.ndim
        return 2 ** (n - dim) * comb(n, dim)

    @property
    def n_faces(self) -> int:
        return 2 * self.ndim

    # -- node orderings ------------------------------------------------------

    @property
    def hierarchical_node_order(self) -> np.ndarray:
        """Flat node indices ordered vertices → edges → ... → interior."""
        return self._hier_node_order

    @property
    def vertex_node_ind(self) -> np.ndarray:
        return self._hier_node_order[: 2**self.ndim]

    @property
    def exterior_node_ind(self) -> np.ndarray:
        return self._hier_node_order[: self._n_exterior_nodes]

    @property
    def interior_node_ind(self) -> np.ndarray:
        return self._hier_node_order[self._n_exterior_nodes:]

    def sub_geometry_ix_exps(self, dim=None, inclusive=True):
        """Index expressions selecting each dim-D sub-geometry's nodes.

        Returns a list of ``(shape, index_tuple)`` pairs, one per
        sub-geometry, each sub-geometry lexicographically ordered.  With
        ``inclusive=False`` only the sub-geometry's *interior* nodes are
        selected.  Parity: ``sem/geometry.py:151-195``.
        """
        if dim is None:
            dim = self.ndim - 1
        if not 0 <= dim <= self.ndim:
            raise ValueError(f"no {dim}D sub-geometry of a {self.ndim}D cell")

        n_fixed = self.ndim - dim
        out = []
        for fixed_axes in itertools.combinations(range(self.ndim), n_fixed):
            ends = [(0, self._shape[ax] - 1) for ax in fixed_axes]
            for const_ind in itertools.product(*ends):
                indices = []
                shape = []
                k = 0
                for d in range(self.ndim):
                    if k < n_fixed and d == fixed_axes[k]:
                        indices.append(const_ind[k])
                        k += 1
                    elif inclusive:
                        indices.append(slice(0, self._shape[d]))
                        shape.append(self._shape[d])
                    else:
                        indices.append(slice(1, self._shape[d] - 1))
                        shape.append(self._shape[d] - 2)
                out.append((tuple(shape), tuple(indices)))
        return out

    def _compute_hierarchical_node_ordering(self) -> np.ndarray:
        order = np.zeros(self._n_nodes, dtype=np.int64)
        lin = np.arange(self._n_nodes).reshape(self._shape)
        i1 = 0
        for d in range(self.ndim + 1):
            for _, ix in self.sub_geometry_ix_exps(d, inclusive=False):
                ind = np.asarray(lin[ix]).ravel()
                i0, i1 = i1, i1 + ind.size
                order[i0:i1] = ind
        assert i1 == self._n_nodes
        return order

    def sub_geometry(self, axis: int):
        """Geometry of the face normal to ``axis`` (tangential shape rolled
        as in ``sem/geometry.py:214-216``)."""
        geo_shape = self._shape[axis + 1:] + self._shape[:axis]
        return self._sub_geo_class(*geo_shape)

    def face_vertex_local_ind(self, face: int) -> np.ndarray:
        """Flat local indices of the corner vertices lying on ``face``."""
        verts = self.vertex_node_ind
        mask = self.corner_verts[face]
        return verts[mask]

    def __eq__(self, other):
        return type(self) is type(other) and self._shape == other.shape

    def __hash__(self):
        return hash((type(self).__name__, self._shape))

    def __repr__(self):
        return f"{type(self).__name__}{self._shape}"


class Line(NCube):
    """1D cell.  Vertex enumeration::

        +-->u0  (0)--*--(1)

    Parity: ``sem/geometry.py:219-235``.
    """

    corner_verts = [
        np.array([True, False]),
        np.array([False, True]),
    ]

    def __init__(self, shape_u: int):
        super().__init__(shape_u)
        self._sub_geo_class = None

    def sub_geometry(self, axis=None):
        raise NotImplementedError("sub-geometry of a line is a point")


class Quadrilateral(NCube):
    """2D cell.  Vertex/edge enumeration (parity ``sem/geometry.py:245-255``)::

               1--(3)--3
               |       |
        u1    (0)  *  (1)
        |      |       |
        +--u0  0--(2)--2
    """

    corner_verts = [
        np.array([1, 1, 0, 0], dtype=bool),  # west:  vertices 0, 1
        np.array([0, 0, 1, 1], dtype=bool),  # east:  vertices 2, 3
        np.array([1, 0, 1, 0], dtype=bool),  # south: vertices 0, 2
        np.array([0, 1, 0, 1], dtype=bool),  # north: vertices 1, 3
    ]

    def __init__(self, shape_u: int, shape_v: int):
        super().__init__(shape_u, shape_v)
        self._sub_geo_class = Line


class Hexahedron(NCube):
    """3D cell (capability extension: the reference is 2D-only,
    ``sem/geometry.py:25-29`` lists simplices/3D as future work).

    Vertex v's binary index is (axis0, axis1, axis2) = (bit2, bit1, bit0)
    — the hierarchical ordering's vertex enumeration.  Faces follow
    ``sub_geometry_ix_exps(2)`` order: (u0=0, u0=1, u1=0, u1=1, u2=0,
    u2=1).
    """

    corner_verts = [
        np.array([((b >> 2) & 1) == 0 for b in range(8)], dtype=bool),
        np.array([((b >> 2) & 1) == 1 for b in range(8)], dtype=bool),
        np.array([((b >> 1) & 1) == 0 for b in range(8)], dtype=bool),
        np.array([((b >> 1) & 1) == 1 for b in range(8)], dtype=bool),
        np.array([(b & 1) == 0 for b in range(8)], dtype=bool),
        np.array([(b & 1) == 1 for b in range(8)], dtype=bool),
    ]

    def __init__(self, shape_u: int, shape_v: int, shape_w: int):
        super().__init__(shape_u, shape_v, shape_w)
        self._sub_geo_class = Quadrilateral
