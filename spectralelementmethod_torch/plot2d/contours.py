"""Solution contour/surface plots (matplotlib, host-side; a copy of the
JAX package's ``plot2d/contours.py``, taking numpy arrays or tensors).

Parity: reference ``sem/plot2d/contours.py`` — triangulate the mesh,
resample GLL coefficients to the equispaced mesh nodes, then
tricontour/tricontourf/trisurf.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as meshplt2d


def _plt():
    import matplotlib.pyplot as plt

    return plt


def new_mpl_fig():
    return _plt().figure().gca()


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def triangulate_data(disc, coeffs):
    """(Triangulation, equispaced nodal values) for a solution field."""
    tri = meshplt2d.triangulate(disc.mesh)
    values = disc.values_at_nodes(_numpy(coeffs))
    return tri, values


def tricontour(disc, soln_vec, ax=None, **kwargs):
    if ax is None:
        ax = new_mpl_fig()
    tri, u_eq = triangulate_data(disc, soln_vec)
    return ax.tricontour(tri, u_eq, **kwargs)


def tricontourf(disc, soln_vec, ax=None, **kwargs):
    if ax is None:
        ax = new_mpl_fig()
    tri, u_eq = triangulate_data(disc, soln_vec)
    return ax.tricontourf(tri, u_eq, **kwargs)


def surface(disc, soln_vec, ax=None, **kwargs):
    if ax is None:
        fig = _plt().figure()
        ax = fig.add_subplot(111, projection="3d")
    tri, u_eq = triangulate_data(disc, soln_vec)
    return ax.plot_trisurf(tri, u_eq, **kwargs)
