"""In-memory structured mesh generators.

The reference ships only Gmsh ``.geo`` sources (``examples/meshes/*.geo``,
``tests/mesh/square.geo``) and requires an external ``gmsh`` binary to
produce ``.msh`` files (which are git-lfs absent upstream).  These generators
build the same meshes directly:

* :func:`rectangle_mesh` — the unit-square mesh of ``tests/mesh/square.geo``
  / ``examples/meshes/square.geo`` (regions "interior"; boundaries "ebc" =
  west+south, "nbc" = north+east).
* :func:`annulus_mesh` — the transfinite sphere-in-shell "donut" mesh of
  ``examples/meshes/donut.geo`` (boundaries "sphere"/"shell"/"symaxis",
  angular equispacing, radial geometric grading).
* :func:`mapped_mesh` — general single-patch structured mesh through a
  user coordinate map.

All generators place each cell's high-order nodes *equispaced in the patch
parameter* within the cell, matching Gmsh's high-order node convention that
the isoparametric mapping construction assumes (equispaced parametric nodes,
``sem/basis_functions.py:599-624`` via ``sem/mapping.py:98-103``).
"""

from __future__ import annotations

import numpy as np

from .geometry import Quadrilateral
from .mesh import Mesh


import functools

from ..utils.stages import stage as _stage


def _staged(name):
    """Account a mesh generator's host wall-clock under utils.stages."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with _stage(name):
                return fn(*a, **kw)
        return inner
    return wrap


def _patch_param_1d(corner_values: np.ndarray, order: int) -> np.ndarray:
    """Global 1D parameter line: cells between consecutive corner values,
    ``order+1`` equispaced nodes per cell, shared endpoints."""
    n_cells = corner_values.size - 1
    n_glob = n_cells * order + 1
    u = np.empty(n_glob)
    for c in range(n_cells):
        u[c * order:(c + 1) * order + 1] = np.linspace(
            corner_values[c], corner_values[c + 1], order + 1
        )
    return u


@_staged("mesh/generate")
def structured_patch_mesh(
    u_corners,
    v_corners,
    order: int,
    coord_map,
    region: str = "interior",
    boundary_names: dict | None = None,
) -> Mesh:
    """Build a single-patch structured quad mesh.

    Parameters
    ----------
    u_corners, v_corners : array
        Cell-corner values of the two patch parameters (lengths nx+1, ny+1).
    order : int | (int, int)
        Geometric polynomial order of each cell per axis (cells have
        ``(p0+1)*(p1+1)`` nodes).
    coord_map : callable
        ``coord_map(U, V) -> (x, y)`` mapping patch parameters to physical
        coordinates (vectorized).
    boundary_names : dict
        Maps sides ``"west"/"east"/"south"/"north"`` (faces of the *patch*)
        to boundary names; sides mapping to the same name share a boundary;
        sides absent get no boundary.
    """
    u_corners = np.asarray(u_corners, dtype=np.float64)
    v_corners = np.asarray(v_corners, dtype=np.float64)
    nx, ny = u_corners.size - 1, v_corners.size - 1
    # per-axis geometric orders (anisotropic cells: (p0, p1) tuple —
    # reference tensor bases are anisotropic throughout,
    # sem/basis_functions.py:683-697)
    p0, p1 = (order, order) if np.isscalar(order) else order

    u = _patch_param_1d(u_corners, p0)
    v = _patch_param_1d(v_corners, p1)
    U, V = np.meshgrid(u, v, indexing="ij")
    x, y = coord_map(U, V)

    mesh = Mesh(2)
    mesh.set_nodes(np.stack([x.ravel(), y.ravel()]))
    geometry = Quadrilateral(p0 + 1, p1 + 1)
    gid = mesh.add_geometry(geometry)
    rid = mesh.new_region(region)

    # all element node maps at once: cell (i, j) covers global grid rows
    # i*p0..i*p0+p0 and columns j*p1..j*p1+p1 (cell numbering: i * ny + j)
    glob = np.arange(u.size * v.size).reshape(u.size, v.size)
    i0 = (np.arange(nx) * p0)[:, None, None, None]
    j0 = (np.arange(ny) * p1)[None, :, None, None]
    ii = i0 + np.arange(p0 + 1)[None, None, :, None]
    jj = j0 + np.arange(p1 + 1)[None, None, None, :]
    node_maps = glob[ii, jj].reshape(nx * ny, p0 + 1, p1 + 1)
    mesh.add_cells(node_maps, gid, rid)

    mesh.find_neighbors()

    if boundary_names:
        ids = {}
        for side, name in boundary_names.items():
            if name not in ids:
                ids[name] = mesh.new_boundary(name)
        # patch side -> (cell numbers, face number):  faces are
        # 0=west(u0=0) 1=east 2=south(u1=0) 3=north of each cell
        side_cells = {
            "west": (np.arange(ny), 0),
            "east": ((nx - 1) * ny + np.arange(ny), 1),
            "south": (np.arange(nx) * ny, 2),
            "north": (np.arange(nx) * ny + ny - 1, 3),
        }
        for side, name in boundary_names.items():
            cells, face = side_cells[side]
            mesh.add_boundary_cells(cells, ids[name], 1, face)
    return mesh


# general-purpose alias
mapped_mesh = structured_patch_mesh


def rectangle_mesh(
    nx: int,
    ny: int,
    order: int,
    x0=(-1.0, -1.0),
    x1=(1.0, 1.0),
    region: str = "interior",
    boundary_names: dict | None = None,
) -> Mesh:
    """Uniform rectangle mesh.

    Defaults reproduce ``tests/mesh/square.geo``: domain [-1,1]², region
    "interior", boundary "ebc" on west+south and "nbc" on north+east.
    """
    if boundary_names is None:
        boundary_names = {
            "west": "ebc",
            "south": "ebc",
            "north": "nbc",
            "east": "nbc",
        }

    def cmap(U, V):
        return U, V

    return structured_patch_mesh(
        np.linspace(x0[0], x1[0], nx + 1),
        np.linspace(x0[1], x1[1], ny + 1),
        order,
        cmap,
        region=region,
        boundary_names=boundary_names,
    )


def geometric_progression(a: float, b: float, n: int, ratio: float) -> np.ndarray:
    """n+1 points from a to b with interval lengths in geometric progression.

    Matches Gmsh's ``Transfinite Line ... Using Progression r`` semantics
    (first interval shortest at ``a`` for ratio > 1).
    """
    if abs(ratio - 1.0) < 1e-14:
        return np.linspace(a, b, n + 1)
    lengths = ratio ** np.arange(n)
    t = np.concatenate([[0.0], np.cumsum(lengths)])
    t /= t[-1]
    return a + (b - a) * t


def annulus_mesh(
    order: int,
    n_theta: int = 9,
    n_r: int = 15,
    r_inner: float = 1.0,
    r_outer: float = 100.0,
    progression: float = 1.35,
    region: str = "interior",
    node_placement: str = "gmsh",
) -> Mesh:
    """Half-annulus "donut" mesh for axisymmetric flow past a sphere.

    Reproduces ``examples/meshes/donut.geo``: half-disc shell in the
    meridional (rho, z) plane (rho >= 0), inner circle of radius
    ``r_inner`` ("sphere"), outer circle ``r_outer`` ("shell"), the two
    segments of the rho=0 axis ("symaxis").  Angular spacing is uniform
    (Transfinite Line {1,2} = 10 → 9 cells); radial spacing is a geometric
    progression refined toward the sphere (Transfinite 16 Using Progression
    1.35 → 15 cells).

    ``node_placement`` selects how high-order nodes are placed:

    * ``"gmsh"`` (default) — reproduce what Gmsh produces for
      ``Transfinite Surface`` + ``SetOrder`` on a plane surface
      (``donut.geo:19-22``): cell *vertices* polar-exact (Gmsh's
      arc-length-blended transfinite interpolation reduces to the polar
      map for this geometry); high-order edge nodes snapped to the
      geometry only on the sphere/shell circles (equispaced in angle);
      every *interior* element edge a straight chord with equispaced
      nodes; element-interior nodes by per-element transfinite blending
      of the (possibly curved) south/north edges.  This is the mesh the
      reference's golden squirmer value was computed on.
    * ``"polar"`` — every node polar-exact: u = polar angle, v = radius.
      A *better* sphere-fitted mesh than gmsh's (fully isoparametric
      circles on every ring), but not byte-compatible with donut.msh.
    """
    theta_corners = np.linspace(0.0, np.pi, n_theta + 1)
    r_corners = geometric_progression(r_inner, r_outer, n_r, progression)

    if node_placement == "polar":
        def cmap(TH, R):
            # (rho, z): rho = r sin(theta) >= 0, z = r cos(theta).
            # det J = r * d(theta)/du * d(r)/dv > 0 with both increasing.
            return R * np.sin(TH), R * np.cos(TH)

    elif node_placement == "gmsh":
        cmap = _gmsh_transfinite_annulus_cmap(theta_corners, r_corners)
    else:
        raise ValueError(f"unknown node_placement {node_placement!r}")
    u_corners, v_corners = theta_corners, r_corners

    return structured_patch_mesh(
        u_corners,
        v_corners,
        order,
        cmap,
        region=region,
        boundary_names={
            "south": "sphere",   # v = r_inner
            "north": "shell",    # v = r_outer
            "west": "symaxis",   # theta = 0  (positive z axis)
            "east": "symaxis",   # theta = pi (negative z axis)
        },
    )


def _gmsh_transfinite_annulus_cmap(theta_corners, r_corners):
    """Gmsh-equivalent node placement for the transfinite half-annulus.

    Within cell (i, j) with local fractions (s, t), the element geometry
    is the linear blend ``(1-t) S(s) + t N(s)`` of its radial-extreme
    edges, where an edge lying on the inner/outer circle is the exact arc
    (equispaced in angle — gmsh snaps high-order nodes classified on a
    curve to the geometry) and every other circumferential edge is the
    straight chord between its end vertices (gmsh places nodes classified
    on a *plane* surface or straight line linearly).  Radial edges are
    straight either way (collinear with the origin).  The blend equals
    the per-element Coons patch given those straight radial edges.
    """
    th_c = np.asarray(theta_corners, dtype=np.float64)
    r_c = np.asarray(r_corners, dtype=np.float64)
    n_th, n_r = th_c.size - 1, r_c.size - 1

    def polar(th, r):
        return r * np.sin(th), r * np.cos(th)

    def edge(s, th0, th1, r, on_circle):
        """Point at fraction s along a circumferential edge at radius r."""
        th = th0 + (th1 - th0) * s
        if on_circle:
            return np.stack(polar(th, r))
        x0 = np.stack(polar(th0, np.broadcast_to(r, th0.shape)))
        x1 = np.stack(polar(th1, np.broadcast_to(r, th1.shape)))
        return (1 - s) * x0 + s * x1

    def cmap(TH, R):
        i = np.clip(np.searchsorted(th_c, TH, side="right") - 1, 0,
                    n_th - 1)
        j = np.clip(np.searchsorted(r_c, R, side="right") - 1, 0, n_r - 1)
        th0, th1 = th_c[i], th_c[i + 1]
        r0, r1 = r_c[j], r_c[j + 1]
        s = (TH - th0) / (th1 - th0)
        t = (R - r0) / (r1 - r0)
        # inner edge is an arc only on the sphere ring; outer only on the
        # shell ring (use where-blend so the whole grid stays vectorized)
        S_arc = edge(s, th0, th1, r0, True)
        S_str = edge(s, th0, th1, r0, False)
        N_arc = edge(s, th0, th1, r1, True)
        N_str = edge(s, th0, th1, r1, False)
        S = np.where(j == 0, S_arc, S_str)
        N = np.where(j == n_r - 1, N_arc, N_str)
        xy = (1 - t) * S + t * N
        return xy[0], xy[1]

    return cmap


def single_cell_mesh(order: int, corners=None) -> Mesh:
    """One-quadrilateral in-memory mesh (the reference's test fixture,
    ``tests/test_discrete.py:22-38``).

    ``corners``: optional (4, 2) array of vertex positions in the order
    (u0=0,u1=0), (0,1), (1,0), (1,1); default is the bi-unit square.
    """
    if corners is None:
        def cmap(U, V):
            return U, V
    else:
        c = np.asarray(corners, dtype=np.float64)

        def cmap(U, V):
            s, t = (U + 1) / 2, (V + 1) / 2
            x = ((1 - s) * (1 - t) * c[0, 0] + (1 - s) * t * c[1, 0]
                 + s * (1 - t) * c[2, 0] + s * t * c[3, 0])
            y = ((1 - s) * (1 - t) * c[0, 1] + (1 - s) * t * c[1, 1]
                 + s * (1 - t) * c[2, 1] + s * t * c[3, 1])
            return x, y

    return structured_patch_mesh(
        np.array([-1.0, 1.0]),
        np.array([-1.0, 1.0]),
        order,
        cmap,
        boundary_names={"west": "w", "east": "e", "south": "s", "north": "n"},
    )


# ---------------------------------------------------------------------------
# Multi-patch structured meshes (Gmsh "Transfinite Surface" parity)
# ---------------------------------------------------------------------------


def coons_patch(south, north, west, east):
    """Transfinite (Coons) interpolation map from four boundary curves.

    ``south(u)``/``north(u)`` map u in [0,1] to (x, y) along v=0 / v=1;
    ``west(v)``/``east(v)`` along u=0 / u=1.  Curves must agree at corners.
    Returns ``cmap(U, V) -> (x, y)`` over the unit square, vectorized —
    the same construction Gmsh uses for ``Transfinite Surface``.
    """
    def cmap(U, V):
        Su = np.stack(south(U))
        Nu = np.stack(north(U))
        Wv = np.stack(west(V))
        Ev = np.stack(east(V))
        c00 = np.stack(south(np.zeros_like(U)))
        c10 = np.stack(south(np.ones_like(U)))
        c01 = np.stack(north(np.zeros_like(U)))
        c11 = np.stack(north(np.ones_like(U)))
        xy = ((1 - V) * Su + V * Nu + (1 - U) * Wv + U * Ev
              - ((1 - U) * (1 - V) * c00 + U * (1 - V) * c10
                 + (1 - U) * V * c01 + U * V * c11))
        return xy[0], xy[1]

    return cmap


def line_curve(p0, p1):
    """Straight segment p0 -> p1 as a unit-parameter curve."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)

    def c(t):
        return (p0[0] + (p1[0] - p0[0]) * t, p0[1] + (p1[1] - p0[1]) * t)

    return c


def arc_curve(radius, th0, th1, center=(0.0, 0.0)):
    """Circular arc (rho, z) = center + R (sin th, cos th), th0 -> th1.

    Polar angle measured from the +z axis (the axisymmetric convention of
    :func:`annulus_mesh`).
    """
    def c(t):
        th = th0 + (th1 - th0) * t
        return (center[0] + radius * np.sin(th),
                center[1] + radius * np.cos(th))

    return c


def polyline_curve(points, fractions=None):
    """Piecewise-linear curve through ``points``; ``fractions`` places the
    interior corners at given parameter values (so corners can coincide
    with mesh lines)."""
    pts = np.asarray(points, dtype=np.float64)
    k = len(pts) - 1
    if fractions is None:
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
        fr = np.concatenate([[0.0], np.cumsum(seg) / seg.sum()])
    else:
        fr = np.asarray(fractions, dtype=np.float64)
        assert fr[0] == 0.0 and fr[-1] == 1.0 and fr.size == k + 1

    def c(t):
        t = np.asarray(t, dtype=np.float64)
        i = np.clip(np.searchsorted(fr, t, side="right") - 1, 0, k - 1)
        local = (t - fr[i]) / (fr[i + 1] - fr[i])
        p0, p1 = pts[i], pts[i + 1]
        return (p0[..., 0] + (p1[..., 0] - p0[..., 0]) * local,
                p0[..., 1] + (p1[..., 1] - p0[..., 1]) * local)

    return c


@_staged("mesh/generate")
def multi_patch_mesh(patches, order: int, region: str = "interior",
                     tol: float = 1e-9) -> Mesh:
    """Stitch structured patches into one conforming mesh.

    ``patches``: list of dicts with keys ``u_corners``, ``v_corners``,
    ``cmap`` (as :func:`structured_patch_mesh`) and optional ``boundaries``
    = {"west"/"east"/"south"/"north": name} for sides on the *outer*
    boundary.  Patch interfaces must match node-for-node (same corner
    splits and physical positions); shared nodes are merged by rounded
    coordinates (tolerance ``tol``).
    """
    all_nodes = []
    patch_data = []  # (node_maps local, boundaries, nx, ny)
    offset = 0
    for pa in patches:
        u_corners = np.asarray(pa["u_corners"], dtype=np.float64)
        v_corners = np.asarray(pa["v_corners"], dtype=np.float64)
        p = order
        nx, ny = u_corners.size - 1, v_corners.size - 1
        u = _patch_param_1d(u_corners, p)
        v = _patch_param_1d(v_corners, p)
        U, V = np.meshgrid(u, v, indexing="ij")
        x, y = pa["cmap"](U, V)
        nodes = np.stack([np.asarray(x).ravel(), np.asarray(y).ravel()])
        all_nodes.append(nodes)

        glob = offset + np.arange(u.size * v.size).reshape(u.size, v.size)
        i0 = (np.arange(nx) * p)[:, None, None, None]
        j0 = (np.arange(ny) * p)[None, :, None, None]
        ii = i0 + np.arange(p + 1)[None, None, :, None]
        jj = j0 + np.arange(p + 1)[None, None, None, :]
        node_maps = glob[ii, jj].reshape(nx * ny, p + 1, p + 1)
        patch_data.append((node_maps, pa.get("boundaries", {}), nx, ny))
        offset += nodes.shape[1]

    nodes = np.concatenate(all_nodes, axis=1)
    # merge duplicate nodes (patch interfaces) by rounded coordinates
    key = np.round(nodes.T / tol).astype(np.int64)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    order_first = np.argsort(first)          # stable: keep first occurrence
    rank = np.empty_like(order_first)
    rank[order_first] = np.arange(order_first.size)
    remap = rank[inv]
    merged_nodes = nodes[:, first[order_first]]

    mesh = Mesh(2)
    mesh.set_nodes(merged_nodes)
    geometry = Quadrilateral(order + 1, order + 1)
    gid = mesh.add_geometry(geometry)
    rid = mesh.new_region(region)

    bnd_ids = {}
    cell0 = []
    for node_maps, bnames, nx, ny in patch_data:
        nums = mesh.add_cells(remap[node_maps], gid, rid)
        cell0.append(nums[0])
        for name in bnames.values():
            if name not in bnd_ids:
                bnd_ids[name] = mesh.new_boundary(name)

    mesh.find_neighbors()

    for (node_maps, bnames, nx, ny), start in zip(patch_data, cell0):
        side_cells = {
            "west": (start + np.arange(ny), 0),
            "east": (start + (nx - 1) * ny + np.arange(ny), 1),
            "south": (start + np.arange(nx) * ny, 2),
            "north": (start + np.arange(nx) * ny + ny - 1, 3),
        }
        for side, name in bnames.items():
            cells, face = side_cells[side]
            mesh.add_boundary_cells(cells, bnd_ids[name], 1, face)
    return mesh


def tube_mesh(order: int, blt: float = 0.75, r_head: float = 32.0,
              tail: float = 64.0, r_wake: float = 2.5,
              n_theta: int = 18, n_r: int = 6, n_wake: int = 4,
              n_outer: int = 6, progression: float = 1.35) -> Mesh:
    """All-quad "tube" domain: sphere + boundary layer + wake + far field.

    Multi-patch transfinite rendering of the reference's
    ``examples/meshes/tube.geo`` domain (sphere of radius 1 at the origin
    in the meridional (rho, z) half-plane; boundary layer of thickness
    ``blt`` with radial progression; wake ring to ``r_wake``; far field =
    quarter-disc head of radius ``r_head`` (z > 0) plus a rectangular tail
    box down to z = -``tail``).  Boundaries: "sphere", "symaxis", "shell"
    (head arc + tail wall + tail end), matching the reference's physical
    lines.  The reference's unstructured bulk surfaces become structured
    Coons patches (this framework is all-quad/transfinite by design).
    """
    th = np.linspace(0.0, np.pi, n_theta + 1)
    R0 = 1.0 + blt

    # patch 1: boundary layer ring  (theta, r in [1, R0], progression)
    bl = {
        "u_corners": th,
        "v_corners": geometric_progression(1.0, R0, n_r, progression),
        "cmap": lambda TH, R: (R * np.sin(TH), R * np.cos(TH)),
        "boundaries": {"south": "sphere", "west": "symaxis",
                       "east": "symaxis"},
    }
    # patch 2: wake ring (theta, r in [R0, r_wake])
    wake = {
        "u_corners": th,
        "v_corners": geometric_progression(R0, r_wake, n_wake, progression),
        "cmap": lambda TH, R: (R * np.sin(TH), R * np.cos(TH)),
        "boundaries": {"west": "symaxis", "east": "symaxis"},
    }

    # patch 3: head quarter-annulus (theta in [0, pi/2], r in [r_wake,
    # r_head]), geometric grading outward
    th_head = th[th <= np.pi / 2 + 1e-12]
    n_th_head = th_head.size - 1
    head = {
        "u_corners": th_head,
        "v_corners": geometric_progression(r_wake, r_head, n_outer,
                                           progression),
        "cmap": lambda TH, R: (R * np.sin(TH), R * np.cos(TH)),
        "boundaries": {"west": "symaxis", "north": "shell"},
    }

    # patch 4: tail region — Coons patch between the lower wake arc
    # (theta in [pi/2, pi]) and the tail outline (wall + bottom)
    th_tail = th[th >= np.pi / 2 - 1e-12]
    n_th_tail = th_tail.size - 1
    inner = arc_curve(r_wake, th_tail[0], th_tail[-1])
    # outer curve from (r_head, 0) around to (0, -tail); corner at the
    # (r_head, -tail) bottom-right; fractions put it on a mesh line
    corner_frac = np.round(0.5 * n_th_tail) / n_th_tail
    outer = polyline_curve(
        [(r_head, 0.0), (r_head, -tail), (0.0, -tail)],
        fractions=[0.0, corner_frac, 1.0],
    )
    west4 = line_curve(inner(0.0), outer(0.0))     # radial at theta=pi/2
    east4 = line_curve(inner(1.0), outer(1.0))     # along the -z axis
    vfrac = geometric_progression(0.0, 1.0, n_outer, progression)
    tailp = {
        "u_corners": np.linspace(0.0, 1.0, n_th_tail + 1),
        "v_corners": vfrac,
        "cmap": coons_patch(inner, outer, west4, east4),
        "boundaries": {"north": "shell", "east": "symaxis"},
    }

    mesh = multi_patch_mesh([bl, wake, head, tailp], order, region="bulk")
    return mesh


@_staged("mesh/generate")
def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    order: int,
    x0=(-1.0, -1.0, -1.0),
    x1=(1.0, 1.0, 1.0),
    region: str = "interior",
    boundary_name: str = "ebc",
    boundary_names: dict | None = None,
) -> Mesh:
    """Uniform structured hexahedral box mesh (3D capability extension;
    the reference is 2D-only, ``sem/geometry.py:25-29``).

    By default all six sides join one named boundary (``boundary_name``)
    — the common all-Dirichlet setup.  ``boundary_names`` instead maps
    sides ``"west"/"east"/"south"/"north"/"bottom"/"top"`` (x-, x+, y-,
    y+, z-, z+) to boundary names for mixed-BC problems (mirrors
    :func:`structured_patch_mesh`); sides sharing a name share a
    boundary, absent sides get none.  Cell numbering:
    ``(i * ny + j) * nz + k`` lexicographic over (x, y, z) cell indices.
    """
    from .geometry import Hexahedron

    p = int(order)
    axes = [np.linspace(x0[d], x1[d], n * p + 1)
            for d, n in enumerate((nx, ny, nz))]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")

    mesh = Mesh(3)
    mesh.set_nodes(np.stack([X.ravel(), Y.ravel(), Z.ravel()]))
    geometry = Hexahedron(p + 1, p + 1, p + 1)
    gid = mesh.add_geometry(geometry)
    rid = mesh.new_region(region)

    g0, g1, g2 = (len(a) for a in axes)
    glob = np.arange(g0 * g1 * g2).reshape(g0, g1, g2)
    i0 = (np.arange(nx) * p)[:, None, None, None, None, None]
    j0 = (np.arange(ny) * p)[None, :, None, None, None, None]
    k0 = (np.arange(nz) * p)[None, None, :, None, None, None]
    ii = i0 + np.arange(p + 1)[None, None, None, :, None, None]
    jj = j0 + np.arange(p + 1)[None, None, None, None, :, None]
    kk = k0 + np.arange(p + 1)[None, None, None, None, None, :]
    node_maps = np.broadcast_arrays(ii, jj, kk)
    node_maps = glob[node_maps[0], node_maps[1], node_maps[2]].reshape(
        nx * ny * nz, p + 1, p + 1, p + 1)
    mesh.add_cells(node_maps, gid, rid)
    mesh.find_neighbors()

    cell_idx = np.arange(nx * ny * nz).reshape(nx, ny, nz)
    side_cells = {
        "west": (cell_idx[0].ravel(), 0),
        "east": (cell_idx[-1].ravel(), 1),
        "south": (cell_idx[:, 0].ravel(), 2),
        "north": (cell_idx[:, -1].ravel(), 3),
        "bottom": (cell_idx[:, :, 0].ravel(), 4),
        "top": (cell_idx[:, :, -1].ravel(), 5),
    }
    if boundary_names:
        ids = {}
        for side, name in boundary_names.items():
            if name not in ids:
                ids[name] = mesh.new_boundary(name)
            cells, face = side_cells[side]
            mesh.add_boundary_cells(cells, ids[name], 2, face)
    elif boundary_name:
        bid = mesh.new_boundary(boundary_name)
        for cells, face in side_cells.values():
            mesh.add_boundary_cells(cells, bid, 2, face)
    return mesh
