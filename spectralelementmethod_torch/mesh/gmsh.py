"""Binary Gmsh mesh import (2.2 and 4.1) / export (2.2 and 4.1).

A numpy copy of the JAX package's ``mesh/gmsh.py`` (the port imports
nothing of that package); it builds the port's :class:`.mesh.Mesh` and
geometries, so a loaded mesh discretizes and solves like a generated one.

Parity target: reference ``sem/grid_importers.py`` (binary-only reader with
PhysicalNames -> regions/boundaries, structured-dtype node/element blocks,
1-based -> 0-based conversion, Gmsh spiral/recursive node order ->
lexicographic conversion).  Additions over the reference:

* a **writer** (the reference has none, and its shipped ``.msh`` binaries
  are git-lfs absent) so meshes can round-trip and test fixtures don't need
  an external ``gmsh`` binary;
* O(E) hash-based neighbor finding (via ``Mesh.find_neighbors`` /
  ``attach_boundary_mesh``) replacing the O(E^2) centroid-distance scan
  (``sem/grid_importers.py:221-270``);
* vectorized spiral<->lexicographic permutation applied per element-block
  instead of per element (hot loop ``sem/grid_importers.py:273-333``);
* hexahedra (Gmsh types 5, 12, 92-98) in both directions: the 3D
  capability extension of the JAX package.
"""

from __future__ import annotations

import functools
import itertools as _it

import numpy as np

from . import geometry as geo
from .mesh import Mesh


class FileFormatError(Exception):
    """Raised when a mesh file cannot be parsed."""


# Gmsh element-type id -> geometry constructor
# (parity: sem/grid_importers.py:19-42; hexes are a 3D capability
# extension — the reference is 2D-only)
GMSH_LINE_TYPES = {1: 2, 8: 3, 26: 4, 27: 5, 28: 6,
                   62: 7, 63: 8, 64: 9, 65: 10, 66: 11}
GMSH_QUAD_TYPES = {3: 2, 10: 3, 36: 4, 37: 5, 38: 6,
                   47: 7, 48: 8, 49: 9, 50: 10, 51: 11}
GMSH_HEX_TYPES = {5: 2, 12: 3, 92: 4, 93: 5, 94: 6,
                  95: 7, 96: 8, 97: 9, 98: 10}

construct_geometry = {}
for _t, _n in GMSH_LINE_TYPES.items():
    construct_geometry[_t] = (lambda n: (lambda: geo.Line(n)))(_n)
for _t, _n in GMSH_QUAD_TYPES.items():
    construct_geometry[_t] = (lambda n: (lambda: geo.Quadrilateral(n, n)))(_n)
for _t, _n in GMSH_HEX_TYPES.items():
    construct_geometry[_t] = (
        lambda n: (lambda: geo.Hexahedron(n, n, n)))(_n)

# inverse: nodes-per-side -> gmsh type id
LINE_TYPE_OF_N = {n: t for t, n in GMSH_LINE_TYPES.items()}
QUAD_TYPE_OF_N = {n: t for t, n in GMSH_QUAD_TYPES.items()}
HEX_TYPE_OF_N = {n: t for t, n in GMSH_HEX_TYPES.items()}

# gmsh hex canonical topology (reference-manual node ordering): corner
# lattice positions at (u, v, w) in {0, L}^3, edge list (each traversed
# low->high vertex), face list (each a quad (q0, q1, q2, q3) whose
# interior uses the recursive 2D scheme with u: q0->q1, v: q0->q3)
_HEX_CORNERS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
_HEX_EDGES = [(0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (2, 3),
              (2, 6), (3, 7), (4, 5), (4, 7), (5, 6), (6, 7)]
_HEX_FACES = [(0, 3, 2, 1), (0, 1, 5, 4), (0, 4, 7, 3),
              (1, 2, 6, 5), (2, 3, 7, 6), (4, 5, 6, 7)]


def _hex_recursive_order(M: int):
    """(M, M, M) lattice positions in gmsh recursive hex node order.

    Per the published gmsh high-order numbering: 8 corners, 12 edges
    (low->high vertex), 6 face interiors (recursive 2D quad scheme in
    each face's induced (u, v) frame), then the volume interior by
    recursion.  Validated against the documented hex27 numbering in
    tests; intra-face orientation at order >= 3 follows the spec
    directly (no public reference bytes exist to cross-check).
    """
    if M < 1:
        return []
    if M == 1:
        return [(0, 0, 0)]
    L = M - 1
    c = np.asarray(_HEX_CORNERS) * L
    out = [tuple(p) for p in c]
    for a, b in _HEX_EDGES:
        d = (c[b] - c[a]) // L
        out.extend(tuple(c[a] + d * t) for t in range(1, L))
    if M > 2:
        m = M - 2
        # interior positions of a face in its own 2D recursive order
        order2d = _quad_recursive_order(m, m)
        for q in _HEX_FACES:
            du = (c[q[1]] - c[q[0]]) // L
            dv = (c[q[3]] - c[q[0]]) // L
            out.extend(tuple(c[q[0]] + du * (a + 1) + dv * (b + 1))
                       for a, b in order2d)
        out.extend((i + 1, j + 1, k + 1)
                   for i, j, k in _hex_recursive_order(m))
    return out


# gmsh quad canonical topology, one dimension down from the hex tables:
# corner lattice positions at (u, v) in {0, L}^2 in CCW order, edge list
# (each traversed from its first corner to its second)
_QUAD_CORNERS = [(0, 0), (1, 0), (1, 1), (0, 1)]
_QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]


def _quad_recursive_order(M: int, N: int):
    """(M, N) lattice positions in gmsh recursive quad node order.

    Same construction as :func:`_hex_recursive_order` one dimension
    down: 4 corners, 4 edge interiors traversed corner->corner CCW,
    then the interior by recursion.  Degenerate slabs left by the
    recursion (a single row or column — odd orders) come out in gmsh
    line order: endpoints first, then the interior ascending.
    """
    if M < 1 or N < 1:
        return []
    if M == 1 and N == 1:
        return [(0, 0)]
    if M == 1:
        return [(0, 0), (0, N - 1)] + [(0, t) for t in range(1, N - 1)]
    if N == 1:
        return [(0, 0), (M - 1, 0)] + [(t, 0) for t in range(1, M - 1)]
    c = np.asarray(_QUAD_CORNERS) * np.asarray((M - 1, N - 1))
    out = [tuple(p) for p in c]
    for a, b in _QUAD_EDGES:
        span = int(np.abs(c[b] - c[a]).max())
        d = (c[b] - c[a]) // span
        out.extend(tuple(c[a] + d * t) for t in range(1, span))
    return out + [(i + 1, j + 1)
                  for i, j in _quad_recursive_order(M - 2, N - 2)]


def spiral_to_lex_permutation(shape) -> np.ndarray:
    """idxmap with ``lex_grid = spiral_list[idxmap]``.

    Gmsh orders a cell's nodes vertices-first, then edges counter-clockwise,
    recursing into the interior; this builds the permutation mapping that
    ordering to the lexicographic grid, by inverting the recursive
    position lists of :func:`_quad_recursive_order` /
    :func:`_hex_recursive_order`.  Output parity (the ordering is pinned
    by the gmsh format): ``sem/grid_importers.py:273-333``.
    """
    if len(shape) == 0:
        return np.zeros((), dtype=np.int64)
    if len(shape) == 3:
        if not (shape[0] == shape[1] == shape[2]):
            raise NotImplementedError(
                "anisotropic hex gmsh node ordering")
        order = _hex_recursive_order(shape[0])
        idxmap3 = np.empty(shape, dtype=np.int64)
        for t, (i, j, k) in enumerate(order):
            idxmap3[i, j, k] = t
        return idxmap3
    if len(shape) == 1:
        M, N = shape[0], 1
    elif len(shape) == 2:
        M, N = shape
    else:
        raise NotImplementedError("only 1D/2D/3D cells supported")

    idxmap = np.empty((M, N), dtype=np.int64)
    for t, (i, j) in enumerate(_quad_recursive_order(M, N)):
        idxmap[i, j] = t
    return idxmap.reshape(shape)


def lex_to_spiral_permutation(shape) -> np.ndarray:
    """perm with ``spiral_list = lex_flat[perm]`` (writer direction)."""
    idxmap = spiral_to_lex_permutation(shape).ravel()
    inv = np.empty_like(idxmap)
    inv[idxmap] = np.arange(idxmap.size)
    return inv


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def _load_msh_impl(file_path: str, ndim: int = 2) -> Mesh:
    """Load a Gmsh ``.msh`` file — format 2.2 or 4.1, binary or ASCII.

    Physical names of dimension ``ndim`` become mesh regions; lower-dim
    physical names become named boundaries whose cells are matched to bulk
    cell faces (parity: ``sem/grid_importers.py:45-68``; the reference
    reads binary 2.2 only and rejects ASCII at ``:64-67`` — ASCII is
    gmsh's *default* output format, so both text encodings are accepted
    here.  Binary remains the fast path for large meshes).
    """
    with open(file_path, "rb") as f:
        is_binary, version = _parse_format(f)
        mesh = Mesh(ndim)
        bnd_mesh = Mesh(ndim)
        if version == "2.2":
            region_map, boundary_map = _parse_physical_names(
                f, mesh, bnd_mesh)
            if is_binary:
                _parse_nodes_bin(f, mesh, bnd_mesh)
                _parse_elements_bin(f, mesh, bnd_mesh, region_map,
                                    boundary_map)
            else:
                _parse_nodes_ascii(f, mesh, bnd_mesh)
                _parse_elements_ascii(f, mesh, bnd_mesh, region_map,
                                      boundary_map)
        else:
            _load_msh41(f, mesh, bnd_mesh, is_binary)

    mesh.find_neighbors()
    mesh.attach_boundary_mesh(bnd_mesh)
    return mesh


def _parse_format(f) -> tuple[bool, str]:
    if not f.readline().startswith(b"$MeshFormat"):
        raise FileFormatError("Expected 'MeshFormat' data")
    version, is_binary, data_size = f.readline().split()
    if version not in (b"2.2", b"4.1"):
        raise FileFormatError(
            f"Expected Gmsh file format 2.2 or 4.1, got {version.decode()}"
        )
    if is_binary not in (b"0", b"1"):
        raise FileFormatError("Unable to recognize file format")
    if data_size != b"8":
        raise FileFormatError(
            f"Expected data size 8, got {data_size.decode()}"
        )
    is_binary = bool(int(is_binary))
    if is_binary:
        one = np.frombuffer(f.read(4), dtype="<i4")[0]
        if one != 1:
            raise FileFormatError(
                "big-endian .msh files are not supported"
            )
        f.readline()  # trailing newline
    if not f.readline().startswith(b"$EndMeshFormat"):
        raise FileFormatError("Malformed mesh format specification")
    return is_binary, version.decode()


def _parse_physical_names(f, mesh: Mesh, bnd_mesh: Mesh):
    if not f.readline().startswith(b"$PhysicalNames"):
        raise FileFormatError("Expected 'PhysicalNames' data")
    n = int(f.readline().rstrip())
    region_map, boundary_map = {}, {}
    for _ in range(n):
        # `dim id "name"` — the quoted name may itself contain spaces
        # (gmsh permits e.g. `Physical Surface("fluid domain")`), so only
        # split off the two leading integer fields
        parts = f.readline().split(None, 2)
        dim = int(parts[0])
        phys_id = int(parts[1])
        name = parts[2].strip().strip(b'"').decode("utf-8")
        if dim == mesh.ndim:
            region_map[phys_id] = mesh.new_region(name)
        elif dim < mesh.ndim:
            boundary_map[phys_id] = bnd_mesh.new_region(name)
            mesh.new_boundary(name)
    if not f.readline().startswith(b"$EndPhysicalNames"):
        raise FileFormatError("Wrong number of physical names specified")
    return region_map, boundary_map


def _parse_nodes_bin(f, mesh: Mesh, bnd_mesh: Mesh):
    if not f.readline().startswith(b"$Nodes"):
        raise FileFormatError("Expected 'Nodes' data")
    n_nodes = int(f.readline().rstrip())
    dt = np.dtype([("index", "<i4"), ("coord", "<3f8")])
    raw = np.frombuffer(f.read(dt.itemsize * n_nodes), dtype=dt)
    f.readline()
    if not f.readline().startswith(b"$EndNodes"):
        raise FileFormatError("Expected end of 'Nodes' data")
    if not np.array_equal(raw["index"], np.arange(1, n_nodes + 1)):
        raise FileFormatError("nodes must be consecutively indexed")
    nodes = np.ascontiguousarray(raw["coord"][:, : mesh.ndim].T)
    mesh.set_nodes(nodes)
    bnd_mesh.set_nodes(nodes)


def _parse_elements_bin(f, mesh: Mesh, bnd_mesh: Mesh, region_map,
                        boundary_map):
    if not f.readline().startswith(b"$Elements"):
        raise FileFormatError("Expected 'Elements' data")
    n_elems = int(f.readline().rstrip())
    n_read = 0
    geo_ids: dict[int, tuple] = {}  # gmsh type -> (geometry, geometry_id, bulk?)

    while n_read < n_elems:
        header = np.frombuffer(f.read(12), dtype="<i4")
        elem_type, n_follow, n_tags = (int(x) for x in header)

        geometry, geometry_id, is_bulk = _register_geometry(
            geo_ids, elem_type, mesh, bnd_mesh)
        n_nodes = geometry.n_nodes

        dt = np.dtype([("index", "<u4"), ("tags", "<u4", (n_tags,)),
                       ("node_ix", "<u4", (n_nodes,))])
        block = np.frombuffer(f.read(dt.itemsize * n_follow), dtype=dt)
        if not np.array_equal(
            block["index"], np.arange(n_read + 1, n_read + n_follow + 1)
        ):
            raise FileFormatError("elements must be consecutively indexed")

        # 1-based -> 0-based; spiral -> lexicographic, whole block at once
        node_ix = block["node_ix"].astype(np.int64) - 1
        idxmap = spiral_to_lex_permutation(geometry.shape).ravel()
        node_ix_lex = node_ix[:, idxmap]

        if n_tags:
            phys = block["tags"][:, 0].astype(np.int64)
        else:
            phys = np.ones(n_follow, dtype=np.int64)
        id_map = region_map if is_bulk else boundary_map
        target = mesh if is_bulk else bnd_mesh
        uniq, inv = np.unique(phys, return_inverse=True)
        rids = np.asarray(
            [id_map[int(u)] for u in uniq], dtype=np.int64
        )[inv]
        target.add_cells(
            node_ix_lex.reshape((n_follow,) + tuple(geometry.shape)),
            geometry_id, rids,
        )
        n_read += n_follow

    f.readline()
    if not f.readline().startswith(b"$EndElements"):
        raise FileFormatError("Expected 'Elements' data")


def _register_geometry(geo_ids, elem_type, mesh, bnd_mesh):
    """geometry registry shared by the element parsers:
    gmsh type -> (geometry, geometry_id, is_bulk)."""
    if elem_type not in geo_ids:
        if elem_type not in construct_geometry:
            raise FileFormatError(f"unsupported element type {elem_type}")
        geometry = construct_geometry[elem_type]()
        if geometry.ndim == mesh.ndim:
            geo_ids[elem_type] = (geometry, mesh.add_geometry(geometry),
                                  True)
        elif geometry.ndim < mesh.ndim:
            geo_ids[elem_type] = (geometry, bnd_mesh.add_geometry(geometry),
                                  False)
        else:
            raise FileFormatError(
                f"element dim {geometry.ndim} exceeds mesh dim")
    return geo_ids[elem_type]


def _add_cells_lex(target, geometry, geometry_id, node_ix, rids):
    """0-based spiral node indices -> lexicographic cells on the mesh."""
    idxmap = spiral_to_lex_permutation(geometry.shape).ravel()
    node_ix_lex = node_ix[:, idxmap]
    target.add_cells(
        node_ix_lex.reshape((len(node_ix),) + tuple(geometry.shape)),
        geometry_id, np.asarray(rids, dtype=np.int64),
    )


def _parse_nodes_ascii(f, mesh: Mesh, bnd_mesh: Mesh):
    """ASCII 2.2 $Nodes: one ``index x y z`` line per node."""
    if not f.readline().startswith(b"$Nodes"):
        raise FileFormatError("Expected 'Nodes' data")
    n_nodes = int(f.readline().rstrip())
    blob = b" ".join(f.readline() for _ in range(n_nodes))
    raw = np.array(blob.split(), dtype=np.float64).reshape(n_nodes, 4)
    if not f.readline().startswith(b"$EndNodes"):
        raise FileFormatError("Expected end of 'Nodes' data")
    if not np.array_equal(raw[:, 0], np.arange(1, n_nodes + 1)):
        raise FileFormatError("nodes must be consecutively indexed")
    nodes = np.ascontiguousarray(raw[:, 1:1 + mesh.ndim].T)
    mesh.set_nodes(nodes)
    bnd_mesh.set_nodes(nodes)


def _parse_elements_ascii(f, mesh: Mesh, bnd_mesh: Mesh, region_map,
                          boundary_map):
    """ASCII 2.2 $Elements: ``index type ntags tags... nodes...`` lines.

    Rows are ragged (per-element tag counts), so elements are bucketed by
    type and added in vectorized blocks like the binary reader.
    """
    if not f.readline().startswith(b"$Elements"):
        raise FileFormatError("Expected 'Elements' data")
    n_elems = int(f.readline().rstrip())
    geo_ids: dict[int, tuple] = {}
    buckets: dict[int, tuple[list, list]] = {}   # type -> (node rows, phys)

    for i in range(n_elems):
        vals = f.readline().split()
        if int(vals[0]) != i + 1:
            raise FileFormatError("elements must be consecutively indexed")
        elem_type, n_tags = int(vals[1]), int(vals[2])
        geometry, _gid, _bulk = _register_geometry(
            geo_ids, elem_type, mesh, bnd_mesh)
        tags = vals[3:3 + n_tags]
        node_row = vals[3 + n_tags:]
        if len(node_row) != geometry.n_nodes:
            raise FileFormatError(
                f"element {i + 1}: expected {geometry.n_nodes} nodes, "
                f"got {len(node_row)}")
        rows, phys = buckets.setdefault(elem_type, ([], []))
        rows.append(node_row)
        phys.append(int(tags[0]) if n_tags else 1)
    if not f.readline().startswith(b"$EndElements"):
        raise FileFormatError("Expected 'Elements' data")

    for elem_type, (rows, phys) in buckets.items():
        geometry, geometry_id, is_bulk = geo_ids[elem_type]
        node_ix = np.array(rows, dtype=np.int64) - 1
        id_map = region_map if is_bulk else boundary_map
        rids = np.asarray([id_map[p] for p in phys], dtype=np.int64)
        _add_cells_lex(mesh if is_bulk else bnd_mesh, geometry,
                       geometry_id, node_ix, rids)


# ---------------------------------------------------------------------------
# MSH 4.1 reader
# ---------------------------------------------------------------------------
#
# Format reference: the published Gmsh 4.1 file-format spec.  Differences
# from 2.2 that matter here: size_t (8-byte) counts and tags; physical
# groups attached to *model entities* ($Entities) rather than per-element
# tag arrays; nodes and elements grouped into per-entity blocks; node tags
# allowed to be non-consecutive.  Element node ORDER is unchanged, so the
# spiral->lexicographic conversion is shared.  The reference reads 2.2
# only (``sem/grid_importers.py:71-101``) — 4.1 is a capability extension.


def _read(f, dtype, count):
    dt = np.dtype(dtype)
    buf = f.read(dt.itemsize * int(count))
    if len(buf) != dt.itemsize * int(count):
        raise FileFormatError("truncated binary section")
    return np.frombuffer(buf, dtype=dt)


def _expect_line(f, token: bytes):
    line = f.readline()
    while line in (b"\n", b"\r\n"):
        line = f.readline()
    if not line.startswith(token):
        raise FileFormatError(
            f"Expected {token.decode()!r}, got {line[:40]!r}")
    return line


def _load_msh41(f, mesh: Mesh, bnd_mesh: Mesh, is_binary: bool = True):
    # $PhysicalNames is optional in 4.1 output
    pos = f.tell()
    line = f.readline()
    f.seek(pos)
    region_map, boundary_map = {}, {}
    if line.startswith(b"$PhysicalNames"):
        region_map, boundary_map = _parse_physical_names(f, mesh, bnd_mesh)
    if is_binary:
        ent_phys = _parse_entities_bin41(f)
        tag2idx = _parse_nodes_bin41(f, mesh, bnd_mesh)
        _parse_elements_bin41(f, mesh, bnd_mesh, region_map, boundary_map,
                              ent_phys, tag2idx)
    else:
        ent_phys = _parse_entities_ascii41(f)
        tag2idx = _parse_nodes_ascii41(f, mesh, bnd_mesh)
        _parse_elements_ascii41(f, mesh, bnd_mesh, region_map,
                                boundary_map, ent_phys, tag2idx)


def _parse_entities_bin41(f) -> dict:
    """{(entity_dim, entity_tag): first physical tag or None}."""
    _expect_line(f, b"$Entities")
    n_pts, n_crv, n_srf, n_vol = (int(x) for x in _read(f, "<u8", 4))
    ent_phys: dict[tuple, int | None] = {}

    def read_phys():
        n = int(_read(f, "<u8", 1)[0])
        tags = _read(f, "<i4", n)
        return int(tags[0]) if n else None

    for _ in range(n_pts):
        tag = int(_read(f, "<i4", 1)[0])
        _read(f, "<f8", 3)                       # x y z
        ent_phys[(0, tag)] = read_phys()
    for dim, count in ((1, n_crv), (2, n_srf), (3, n_vol)):
        for _ in range(count):
            tag = int(_read(f, "<i4", 1)[0])
            _read(f, "<f8", 6)                   # bounding box
            ent_phys[(dim, tag)] = read_phys()
            n_bnd = int(_read(f, "<u8", 1)[0])
            _read(f, "<i4", n_bnd)               # bounding entity tags
    f.readline()
    _expect_line(f, b"$EndEntities")
    return ent_phys


def _parse_nodes_bin41(f, mesh: Mesh, bnd_mesh: Mesh) -> np.ndarray:
    """Read all node blocks; returns tag -> 0-based index lookup."""
    _expect_line(f, b"$Nodes")
    n_blocks, n_nodes, _min_tag, max_tag = (
        int(x) for x in _read(f, "<u8", 4))
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    at = 0
    for _ in range(n_blocks):
        _dim, _etag, parametric = (int(x) for x in _read(f, "<i4", 3))
        nb = int(_read(f, "<u8", 1)[0])
        if parametric:
            raise FileFormatError("parametric node blocks not supported")
        tags[at:at + nb] = _read(f, "<u8", nb).astype(np.int64)
        coords[at:at + nb] = _read(f, "<f8", 3 * nb).reshape(nb, 3)
        at += nb
    if at != n_nodes:
        raise FileFormatError("node blocks disagree with numNodes")
    f.readline()
    _expect_line(f, b"$EndNodes")

    nodes = np.ascontiguousarray(coords[:, : mesh.ndim].T)
    mesh.set_nodes(nodes)
    bnd_mesh.set_nodes(nodes)
    tag2idx = np.full(max_tag + 1, -1, dtype=np.int64)
    tag2idx[tags] = np.arange(n_nodes)
    return tag2idx


def _parse_elements_bin41(f, mesh: Mesh, bnd_mesh: Mesh, region_map,
                          boundary_map, ent_phys, tag2idx):
    _expect_line(f, b"$Elements")
    n_blocks, _n_elems, _min, _max = (int(x) for x in _read(f, "<u8", 4))
    geo_ids: dict[int, tuple] = {}

    for _ in range(n_blocks):
        dim, etag, elem_type = (int(x) for x in _read(f, "<i4", 3))
        nb = int(_read(f, "<u8", 1)[0])
        geometry, geometry_id, is_bulk = _register_geometry(
            geo_ids, elem_type, mesh, bnd_mesh)
        n_nodes = geometry.n_nodes

        dt = np.dtype([("tag", "<u8"), ("node_ix", "<u8", (n_nodes,))])
        block = np.frombuffer(f.read(dt.itemsize * nb), dtype=dt)
        phys = ent_phys.get((dim, etag))
        if phys is None:
            # entity outside any physical group (gmsh SaveAll=1 output):
            # not part of the model the solver sees
            continue
        node_ix = tag2idx[block["node_ix"].astype(np.int64)]
        if np.any(node_ix < 0):
            raise FileFormatError("element references an unknown node tag")
        idxmap = spiral_to_lex_permutation(geometry.shape).ravel()
        node_ix_lex = node_ix[:, idxmap]

        id_map = region_map if is_bulk else boundary_map
        if phys not in id_map:
            raise FileFormatError(
                f"physical tag {phys} (dim {dim}) has no $PhysicalNames "
                f"entry")
        target = mesh if is_bulk else bnd_mesh
        rids = np.full(nb, id_map[phys], dtype=np.int64)
        target.add_cells(
            node_ix_lex.reshape((nb,) + tuple(geometry.shape)),
            geometry_id, rids,
        )
    f.readline()
    _expect_line(f, b"$EndElements")


def _ascii_tokens(f, section_end: bytes):
    """Whitespace tokens of an ASCII section up to (not incl.) its end
    marker; the marker line itself is consumed and validated."""
    toks: list[bytes] = []
    while True:
        line = f.readline()
        if not line:
            raise FileFormatError(
                f"unexpected EOF before {section_end.decode()!r}")
        if line.startswith(section_end):
            return toks
        toks.extend(line.split())


def _parse_entities_ascii41(f) -> dict:
    """ASCII twin of :func:`_parse_entities_bin41` (token-structured:
    line breaks inside $Entities are not significant)."""
    _expect_line(f, b"$Entities")
    toks = _ascii_tokens(f, b"$EndEntities")
    it = iter(toks)

    def nxt(k=1):
        out = list(_it.islice(it, k))
        if len(out) != k:
            raise FileFormatError("truncated $Entities section")
        return out

    n_pts, n_crv, n_srf, n_vol = (int(x) for x in nxt(4))
    ent_phys: dict[tuple, int | None] = {}
    for _ in range(n_pts):
        tag = int(nxt()[0])
        nxt(3)                                   # x y z
        n_phys = int(nxt()[0])
        phys = [int(x) for x in nxt(n_phys)]
        ent_phys[(0, tag)] = phys[0] if phys else None
    for dim, count in ((1, n_crv), (2, n_srf), (3, n_vol)):
        for _ in range(count):
            tag = int(nxt()[0])
            nxt(6)                               # bounding box
            n_phys = int(nxt()[0])
            phys = [int(x) for x in nxt(n_phys)]
            ent_phys[(dim, tag)] = phys[0] if phys else None
            n_bnd = int(nxt()[0])
            nxt(n_bnd)                           # bounding entity tags
    if next(it, None) is not None:
        raise FileFormatError("trailing tokens in $Entities")
    return ent_phys


def _parse_nodes_ascii41(f, mesh: Mesh, bnd_mesh: Mesh) -> np.ndarray:
    """ASCII 4.1 $Nodes: per block, node tags then ``x y z`` lines."""
    _expect_line(f, b"$Nodes")
    n_blocks, n_nodes, _min_tag, max_tag = (
        int(x) for x in f.readline().split())
    tags = np.empty(n_nodes, dtype=np.int64)
    coords = np.empty((n_nodes, 3))
    at = 0
    for _ in range(n_blocks):
        _dim, _etag, parametric, nb = (int(x) for x in f.readline().split())
        if parametric:
            raise FileFormatError("parametric node blocks not supported")
        tags[at:at + nb] = [int(f.readline()) for _ in range(nb)]
        blob = b" ".join(f.readline() for _ in range(nb))
        coords[at:at + nb] = np.array(
            blob.split(), dtype=np.float64).reshape(nb, 3)
        at += nb
    if at != n_nodes:
        raise FileFormatError("node blocks disagree with numNodes")
    _expect_line(f, b"$EndNodes")

    nodes = np.ascontiguousarray(coords[:, : mesh.ndim].T)
    mesh.set_nodes(nodes)
    bnd_mesh.set_nodes(nodes)
    tag2idx = np.full(max_tag + 1, -1, dtype=np.int64)
    tag2idx[tags] = np.arange(n_nodes)
    return tag2idx


def _parse_elements_ascii41(f, mesh: Mesh, bnd_mesh: Mesh, region_map,
                            boundary_map, ent_phys, tag2idx):
    """ASCII 4.1 $Elements: per block, ``tag node...`` lines."""
    _expect_line(f, b"$Elements")
    n_blocks, _n_elems, _min, _max = (int(x) for x in f.readline().split())
    geo_ids: dict[int, tuple] = {}
    for _ in range(n_blocks):
        dim, etag, elem_type, nb = (int(x) for x in f.readline().split())
        geometry, geometry_id, is_bulk = _register_geometry(
            geo_ids, elem_type, mesh, bnd_mesh)
        blob = b" ".join(f.readline() for _ in range(nb))
        rows = np.array(blob.split(), dtype=np.int64).reshape(
            nb, 1 + geometry.n_nodes)
        phys = ent_phys.get((dim, etag))
        if phys is None:
            continue                             # SaveAll entity: skip
        node_ix = tag2idx[rows[:, 1:]]
        if np.any(node_ix < 0):
            raise FileFormatError("element references an unknown node tag")
        id_map = region_map if is_bulk else boundary_map
        if phys not in id_map:
            raise FileFormatError(
                f"physical tag {phys} (dim {dim}) has no $PhysicalNames "
                f"entry")
        _add_cells_lex(mesh if is_bulk else bnd_mesh, geometry,
                       geometry_id, node_ix,
                       np.full(nb, id_map[phys], dtype=np.int64))
    _expect_line(f, b"$EndElements")


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lex_to_spiral(shape: tuple) -> np.ndarray:
    """:func:`lex_to_spiral_permutation`, built once per shape."""
    perm = lex_to_spiral_permutation(shape)
    perm.flags.writeable = False
    return perm


def _face_index(ndim: int, shape: tuple, face: int) -> np.ndarray:
    """Flat lexicographic indices of one face's nodes, as the face's own
    lexicographic grid: the 2D sub-cell's orientation
    (:func:`.geometry.subface_index_array`), or the (axis, side) slice of
    a hexahedron (the reader matches boundary cells by vertices, so any
    consistent face order works)."""
    if ndim == 3:
        axis, side = divmod(face, 2)
        idx = [slice(None)] * 3
        idx[axis] = 0 if side == 0 else -1
        return np.arange(int(np.prod(shape))).reshape(shape)[tuple(idx)]
    return geo.subface_index_array(face, shape)


def _boundary_blocks(mesh: Mesh) -> list:
    """``[(name, face shape, spiral node indices (k, n_face))]``, one entry
    per (boundary, face shape), boundaries in the mesh's order and shapes
    sorted; rows in :meth:`.Mesh.boundary_faces` order."""
    out = []
    for name in mesh.boundary_names:
        bf = mesh.boundary_faces(name)
        # cell number -> (chunk, row in the chunk)
        starts = np.asarray(mesh._chunk_starts, dtype=np.int64)
        ci = np.searchsorted(starts, bf[:, 0], side="right") - 1
        rows = bf[:, 0] - starts[ci]
        by_shape: dict[tuple, list] = {}
        for c in np.unique(ci):
            chunk = mesh._chunks[c]
            shape = tuple(mesh.get_geometry(chunk.geometry_id).shape)
            flat = chunk.node_maps.reshape(chunk.node_maps.shape[0], -1)
            for face in np.unique(bf[ci == c, 1]):
                sel = np.nonzero((ci == c) & (bf[:, 1] == face))[0]
                fidx = _face_index(mesh.ndim, shape, int(face))
                fshape = tuple(fidx.shape)
                lex = flat[rows[sel]][:, fidx.ravel()]
                by_shape.setdefault(fshape, []).append(
                    (sel, lex[:, _lex_to_spiral(fshape)]))
        for fshape, parts in sorted(by_shape.items()):
            sel = np.concatenate([a for a, _ in parts])
            nodes = np.concatenate([b for _, b in parts])
            out.append((name, fshape, nodes[np.argsort(sel, kind="stable")]))
    return out


def _bulk_blocks(mesh: Mesh) -> list:
    """``[(region ids (k,), cell shape, spiral node indices (k, n))]``, one
    entry per cell chunk, in cell order."""
    out = []
    for chunk in mesh._chunks:
        shape = tuple(mesh.get_geometry(chunk.geometry_id).shape)
        flat = chunk.node_maps.reshape(chunk.node_maps.shape[0], -1)
        out.append((chunk.region_ids, shape,
                    flat[:, _lex_to_spiral(shape)]))
    return out


def _grouped(blocks, key) -> list:
    """Concatenate the (k, n) arrays that end the tuples of ``blocks`` by
    ``key(block)``, in sorted key order; rows keep their order."""
    groups: dict = {}
    for b in blocks:
        groups.setdefault(key(b), []).append(b[-1])
    return [(k, np.concatenate(v)) for k, v in sorted(groups.items())]


def _with_pids(pids, nodes) -> np.ndarray:
    """[physical id | node indices] rows, so blocks group as one array."""
    return np.concatenate(
        [np.broadcast_to(np.asarray(pids, np.int64), (len(nodes),))[:, None],
         nodes], axis=1)


def _physical_ids(mesh: Mesh):
    """(physical names as (dim, id, name), boundary name -> id, region
    name -> id): boundaries first (dim ndim-1), then regions; 1-based."""
    phys, bnd_phys, reg_phys = [], {}, {}
    for name in mesh.boundary_names:
        bnd_phys[name] = len(phys) + 1
        phys.append((mesh.ndim - 1, len(phys) + 1, name))
    for name in mesh.region_names:
        reg_phys[name] = len(phys) + 1
        phys.append((mesh.ndim, len(phys) + 1, name))
    return phys, bnd_phys, reg_phys


_TYPE_OF = {1: LINE_TYPE_OF_N, 2: QUAD_TYPE_OF_N, 3: HEX_TYPE_OF_N}


def save_msh(mesh: Mesh, file_path: str, binary: bool = True) -> None:
    """Write a mesh (with its named regions/boundaries) as Gmsh 2.2.

    Boundary faces are emitted as lower-dimensional elements tagged with
    their boundary's physical id, exactly the structure ``load_msh``
    consumes, so load(save(m)) reproduces m.  ``binary=False`` writes the
    ASCII encoding (gmsh's default text format — interchange with tools
    that don't read binary; binary stays the fast path).  The bytes are
    the JAX package's writer's; the element blocks are gathered a whole
    cell chunk at a time, not cell by cell.
    """
    phys, bnd_phys, reg_phys = _physical_ids(mesh)
    pid_of_region = np.asarray(
        [reg_phys[name] for name in mesh.region_names], dtype=np.int64)

    with open(file_path, "wb") as f:
        if binary:
            f.write(b"$MeshFormat\n2.2 1 8\n")
            f.write(np.array([1], dtype="<i4").tobytes())
            f.write(b"\n$EndMeshFormat\n")
        else:
            f.write(b"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")

        f.write(b"$PhysicalNames\n")
        f.write(f"{len(phys)}\n".encode())
        for dim, pid, name in phys:
            f.write(f'{dim} {pid} "{name}"\n'.encode())
        f.write(b"$EndPhysicalNames\n")

        n_nodes = mesh.n_nodes
        f.write(b"$Nodes\n")
        f.write(f"{n_nodes}\n".encode())
        coord = np.zeros((n_nodes, 3))
        coord[:, : mesh.ndim] = mesh.nodes.T
        if binary:
            dt = np.dtype([("index", "<i4"), ("coord", "<3f8")])
            raw = np.zeros(n_nodes, dtype=dt)
            raw["index"] = np.arange(1, n_nodes + 1)
            raw["coord"] = coord
            f.write(raw.tobytes())
            f.write(b"\n$EndNodes\n")
        else:
            for i in range(n_nodes):
                f.write(f"{i + 1} {coord[i, 0]:.16g} {coord[i, 1]:.16g} "
                        f"{coord[i, 2]:.16g}\n".encode())
            f.write(b"$EndNodes\n")

        # boundary elements (one per (cell, face) on any boundary) grouped
        # by face shape, then bulk cells by cell shape; the gmsh type table
        # is picked by the face/cell dimension (3D: quad faces, hex bulk)
        blocks = _grouped([(s, _with_pids(bnd_phys[nm], v))
                           for nm, s, v in _boundary_blocks(mesh)],
                          lambda b: b[0])
        blocks += _grouped([(s, _with_pids(pid_of_region[rids], v))
                            for rids, s, v in _bulk_blocks(mesh)],
                           lambda b: b[0])
        blocks = [(shape, rows[:, 0], rows[:, 1:]) for shape, rows in blocks]

        f.write(b"$Elements\n")
        f.write(f"{sum(len(b[1]) for b in blocks)}\n".encode())
        index = 1
        for shape, pids, nodes in blocks:
            elem_type = _TYPE_OF[len(shape)][shape[0]]
            k = len(pids)
            if not binary:
                for i in range(k):
                    nodes_s = " ".join(str(ix + 1) for ix in nodes[i])
                    f.write(f"{index + i} {elem_type} 2 {pids[i]} "
                            f"{pids[i]} {nodes_s}\n".encode())
                index += k
                continue
            header = np.array([elem_type, k, 2], dtype="<i4")
            f.write(header.tobytes())
            dt = np.dtype([("index", "<u4"), ("tags", "<u4", (2,)),
                           ("node_ix", "<u4", (nodes.shape[1],))])
            raw = np.zeros(k, dtype=dt)
            raw["index"] = np.arange(index, index + k)
            raw["tags"] = pids[:, None]
            raw["node_ix"] = nodes + 1
            index += k
            f.write(raw.tobytes())

        f.write(b"\n$EndElements\n" if binary else b"$EndElements\n")


def save_msh41(mesh: Mesh, file_path: str) -> None:
    """Write a mesh as binary Gmsh 4.1 (``load_msh`` reads it back).

    Capability extension — the reference has no writer at all
    (``sem/grid_importers.py`` is read-only, 2.2-only).  Model structure:
    one (ndim-1)-entity per named boundary and one ndim-entity per
    region (2D: curves+surfaces; 3D: surfaces+volumes), each carrying
    exactly its physical tag; all nodes in a single block on the first
    region entity; one element block per (physical group, element
    shape).  The bytes are the JAX package's writer's.
    """
    boundaries = mesh.boundary_names
    regions = mesh.region_names
    phys, bnd_phys, reg_phys = _physical_ids(mesh)
    # entity tags are per-dimension in gmsh; reuse the physical id as the
    # entity tag so element blocks can name their entity directly
    bnd_ent = dict(bnd_phys)
    reg_ent = dict(reg_phys)

    lo = mesh.nodes.min(axis=1)
    hi = mesh.nodes.max(axis=1)
    bbox = np.zeros(6)
    bbox[: mesh.ndim] = lo
    bbox[3: 3 + mesh.ndim] = hi

    def w_u8(f, *vals):
        f.write(np.asarray(vals, dtype="<u8").tobytes())

    def w_i4(f, *vals):
        f.write(np.asarray(vals, dtype="<i4").tobytes())

    with open(file_path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(np.array([1], dtype="<i4").tobytes())
        f.write(b"\n$EndMeshFormat\n")

        f.write(b"$PhysicalNames\n")
        f.write(f"{len(phys)}\n".encode())
        for dim, pid, name in phys:
            f.write(f'{dim} {pid} "{name}"\n'.encode())
        f.write(b"$EndPhysicalNames\n")

        f.write(b"$Entities\n")
        # entity counts by dimension: boundaries are (ndim-1)-entities,
        # regions ndim-entities (2D: curves+surfaces; 3D: surfaces+volumes)
        counts = [0, 0, 0, 0]
        counts[mesh.ndim - 1] = len(boundaries)
        counts[mesh.ndim] = len(regions)
        w_u8(f, *counts)
        for name in boundaries:
            w_i4(f, bnd_ent[name])
            f.write(bbox.astype("<f8").tobytes())
            w_u8(f, 1)
            w_i4(f, bnd_phys[name])
            w_u8(f, 0)                       # no bounding points
        for name in regions:
            w_i4(f, reg_ent[name])
            f.write(bbox.astype("<f8").tobytes())
            w_u8(f, 1)
            w_i4(f, reg_phys[name])
            w_u8(f, 0)                       # no bounding curves
        f.write(b"\n$EndEntities\n")

        n_nodes = mesh.n_nodes
        f.write(b"$Nodes\n")
        w_u8(f, 1, n_nodes, 1, n_nodes)
        w_i4(f, mesh.ndim, reg_ent[regions[0]], 0)
        w_u8(f, n_nodes)
        f.write(np.arange(1, n_nodes + 1, dtype="<u8").tobytes())
        coords = np.zeros((n_nodes, 3))
        coords[:, : mesh.ndim] = mesh.nodes.T
        f.write(coords.astype("<f8").tobytes())
        f.write(b"\n$EndNodes\n")

        # element blocks: one per (physical group, element shape), the
        # boundaries' then the regions', each in sorted (name, shape) order
        bnd_blocks = _grouped(_boundary_blocks(mesh),
                              lambda b: (b[0], b[1]))
        bulk_blocks = _grouped(
            [(regions[rid], s, v[rids == rid])
             for rids, s, v in _bulk_blocks(mesh) for rid in np.unique(rids)],
            lambda b: (b[0], b[1]))

        n_elems = sum(len(v) for _, v in bnd_blocks + bulk_blocks)
        f.write(b"$Elements\n")
        w_u8(f, len(bnd_blocks) + len(bulk_blocks), n_elems, 1, n_elems)
        tag = 1
        for dim, ent, blocks in ((mesh.ndim - 1, bnd_ent, bnd_blocks),
                                 (mesh.ndim, reg_ent, bulk_blocks)):
            for (name, shape), elems in blocks:
                w_i4(f, dim, ent[name], _TYPE_OF[len(shape)][shape[0]])
                w_u8(f, len(elems))
                dt = np.dtype([("tag", "<u8"),
                               ("node_ix", "<u8", (elems.shape[1],))])
                raw = np.zeros(len(elems), dtype=dt)
                raw["tag"] = np.arange(tag, tag + len(elems))
                raw["node_ix"] = elems + 1
                tag += len(elems)
                f.write(raw.tobytes())
        f.write(b"\n$EndElements\n")


def load_msh(file_path: str, ndim: int = 2) -> Mesh:
    """Stage-accounted Gmsh import (see :func:`_load_msh_impl`; mesh
    import is a tracked setup-time sink, utils.stages "mesh/import")."""
    from ..utils.stages import stage

    with stage("mesh/import"):
        return _load_msh_impl(file_path, ndim)
