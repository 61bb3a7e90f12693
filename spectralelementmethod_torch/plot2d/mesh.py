"""2D mesh visualization (matplotlib, host-side; a copy of the JAX
package's ``plot2d/mesh.py`` on the port's mesh).

Parity: reference ``sem/plot2d/mesh.py`` — triangulation of high-order quad
meshes (2 triangles per (p x p) sub-quad), node/cell drawing with index
labels and parametric-axis arrows.
"""

from __future__ import annotations

import itertools

import numpy as np


class PlottingError(Exception):
    pass


def _require_mpl():
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    return mpl, plt


def triangulate(mesh):
    """matplotlib Triangulation of a high-order quad mesh.

    Each cell contributes 2*(s0-1)*(s1-1) CCW triangles over its node grid
    (parity: ``sem/plot2d/mesh.py:17-63``).
    """
    mpl, _ = _require_mpl()

    def local_triangles(geo):
        s0, s1 = geo.shape
        n_loc_tri = 2 * (s0 - 1) * (s1 - 1)
        loc_tri = np.zeros((n_loc_tri, 3), dtype=np.int64)
        n = 0
        for i, j in itertools.product(range(s0 - 1), range(s1 - 1)):
            loc_tri[n] = np.ravel_multi_index(
                [[i, i + 1, i], [j, j + 1, j + 1]], geo.shape)
            n += 1
            loc_tri[n] = np.ravel_multi_index(
                [[i, i + 1, i + 1], [j, j, j + 1]], geo.shape)
            n += 1
        return loc_tri

    local_tris = {geo: local_triangles(geo) for geo in mesh.get_geometries()
                  if geo.ndim == 2}
    tris = []
    for cell in mesh.cells:
        node_ind = cell.node_ind_lexicographic.ravel()
        tris.append(node_ind[local_tris[cell.geometry]])
    tri = np.concatenate(tris) if tris else np.zeros((0, 3), np.int64)

    x, y = mesh.nodes
    return mpl.tri.Triangulation(x, y, tri)


def draw_nodes(mesh, marker=".", show_indices=False, ax=None):
    """Plot the nodes of a 2D mesh (``sem/plot2d/mesh.py:66-84``)."""
    _, plt = _require_mpl()
    if mesh.ndim != 2:
        raise PlottingError("A 2D mesh is required")
    if ax is None:
        ax = plt.figure().gca()
    x, y = mesh.nodes
    ax.plot(x, y, marker)
    if show_indices:
        for i in range(mesh.n_nodes):
            ax.text(x[i], y[i], str(i))
    ax.axis("scaled")
    return ax


def draw_cell(cell, draw_param_axes=False, ax=None):
    """Outline one cell's exterior (``sem/plot2d/mesh.py:87-156``)."""
    _, plt = _require_mpl()
    if ax is None:
        ax = plt.figure().gca()

    from ..mesh.geometry import subface_slice

    # walk the boundary CCW: faces south, east, north, west
    pts = []
    coords = cell.nodes_lexicographic  # (2, s0, s1)
    for face in (2, 1, 3, 0):
        seg = subface_slice(face, coords, 2)  # (2, m) CCW
        pts.append(seg[:, :-1].T)
    poly = np.concatenate(pts)
    ax.add_patch(plt.Polygon(poly, fill=False))

    if draw_param_axes:
        vtx = cell.vertex_nodes  # columns: v0 v1 v2 v3
        dxi = vtx[:, 2] - vtx[:, 0]
        deta = vtx[:, 1] - vtx[:, 0]
        off = (dxi + deta) * 0.1
        axlen = 0.2
        x0, y0 = vtx[:, 0] + off
        ax.arrow(x0, y0, dxi[0] * axlen, dxi[1] * axlen, fc="b", ec="b")
        ax.arrow(x0, y0, deta[0] * axlen, deta[1] * axlen, fc="g", ec="g")
    return ax


def draw_cell_nodes(cell, global_indices=False, local_indices=False,
                    hierarchical_order=False, ax=None):
    """Scatter a cell's nodes, optionally annotated with local and/or
    global indices (role: ``sem/plot2d/mesh.py:159-183``)."""
    _, plt = _require_mpl()
    if ax is None:
        ax = plt.figure().gca()

    order = "hierarchical" if hierarchical_order else "lexicographic"
    xy = getattr(cell, f"nodes_{order}").reshape(2, -1)
    gids = getattr(cell, f"node_ind_{order}").ravel()
    ax.plot(xy[0], xy[1], ".")

    if local_indices and global_indices:
        labels = [f"{k}|{g}" for k, g in enumerate(gids)]
    elif local_indices:
        labels = [str(k) for k in range(gids.size)]
    elif global_indices:
        labels = [str(g) for g in gids]
    else:
        labels = []
    for (px, py), text in zip(xy.T, labels):
        ax.annotate(text, (px, py))
    return ax


def draw_cells(mesh, draw_nums=False, draw_param_axes=False, ax=None):
    """Outline every cell of a 2D mesh, optionally numbering each at its
    vertex centroid (role: ``sem/plot2d/mesh.py:186-203``)."""
    _, plt = _require_mpl()
    if mesh.ndim != 2:
        raise PlottingError("A 2D mesh is required")
    if ax is None:
        ax = plt.figure().gca()

    cells = list(mesh.cells)
    for cell in cells:
        draw_cell(cell, draw_param_axes=draw_param_axes, ax=ax)
    if draw_nums:
        centers = np.stack([c.vertex_nodes.mean(axis=1) for c in cells])
        for num, (cx, cy) in enumerate(centers):
            ax.annotate(str(num), (cx, cy), ha="center", va="center")
    ax.axis("scaled")
    return ax


def add_arrow_to_line(line, position=None, reverse=False, size=15,
                      color=None):
    """Overlay a direction arrow on a matplotlib line near ``position``
    (an x-coordinate; defaults to the line's mean x).  Role:
    ``sem/plot2d/mesh.py:206-228``."""
    x = np.asarray(line.get_xdata(), dtype=float)
    y = np.asarray(line.get_ydata(), dtype=float)
    target = float(x.mean()) if position is None else float(position)
    anchor = int(np.abs(x - target).argmin())
    # arrow points opposite the data direction unless reversed; clamp so
    # an anchor at either end cannot index-wrap to the far end of the line
    tip = int(np.clip(anchor + (1 if reverse else -1), 0, x.size - 1))
    line.axes.annotate(
        "", xy=(x[tip], y[tip]), xytext=(x[anchor], y[anchor]), size=size,
        arrowprops={"arrowstyle": "->",
                    "color": line.get_color() if color is None else color},
    )
