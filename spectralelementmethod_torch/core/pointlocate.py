"""Point location and interpolation at arbitrary physical points (host).

Parity: reference ``Mapping.inv`` (Newton inverse map,
``sem/mapping.py:146-178``), ``DOFManager.find_elem_containing_point``
(centroid-sorted candidate scan, ``sem/discrete.py:263-280``) and
``DOFManager.interpolate`` (``sem/discrete.py:221-233``).

Data-dependent trial loops stay on the host (SURVEY.md §7 "hard parts" #6);
the per-element interpolation itself reuses the basis tensor kernels.

A numpy copy of the JAX package's ``core/pointlocate.py``, with its
``native`` fast path (the C++ bin-grid locator of :mod:`..native`).
"""

from __future__ import annotations

import numpy as np

from ..solver.rootfind import SolverFailure, newton


class OutsideDomain(Exception):
    """A physical point lies outside an element / the mesh
    (parity: ``sem/mapping.py:12``, ``sem/discrete.py:19``)."""


def forward_map(disc, e: int, x_param) -> np.ndarray:
    """Physical coordinates of parametric point(s) in element ``e``."""
    return disc.map_basis.interpolate(disc.x_coeffs[e], np.asarray(x_param))


def inverse_map(disc, e: int, x_phys, x_param_guess=None, it_max: int = 8,
                tol: float = 1e-8, bound_tol: float = 1e-7) -> np.ndarray:
    # bound_tol must absorb the O(h^p) gap between a curved boundary and
    # its isoparametric interpolant: boundary points of one discretization
    # can sit slightly "outside" another's polynomial faces.
    """Parametric coordinates of a physical point in element ``e``.

    Newton iteration on the isoparametric map, Jacobian interpolated at the
    current iterate; raises :class:`OutsideDomain` if the converged point
    leaves [-1, 1]^d (parity: ``sem/mapping.py:146-178``, it_max=8,
    tol=1e-8).
    """
    x_phys = np.asarray(x_phys, dtype=np.float64).reshape(disc.ndim)
    if x_param_guess is None:
        x_param_guess = np.zeros(disc.ndim)

    basis = disc.map_basis
    xc = disc.x_coeffs[e]
    Jc = disc.J[e]

    def delta(x_param):
        return basis.interpolate(xc, x_param) - x_phys

    def jac(x_param):
        return basis.interpolate(Jc, x_param)

    try:
        x_param = newton(delta, x_param_guess, jac, it_max=it_max, tol=tol)
    except (SolverFailure, np.linalg.LinAlgError) as exc:
        raise OutsideDomain(str(exc)) from exc

    if np.all(x_param >= -1 - bound_tol) and np.all(x_param <= 1 + bound_tol):
        return np.clip(x_param, -1.0, 1.0)
    raise OutsideDomain(
        "Given physical point is not in the parametric domain of the "
        "finite element.", x_param,
    )


def find_element_containing_point(disc, point, max_candidates=None,
                                  extrapolate_tol: float = 0.0):
    """(element, x_param) for the element containing ``point``.

    Candidates are scanned in order of centroid distance
    (parity: ``sem/discrete.py:263-280``).  With ``extrapolate_tol > 0``,
    a point that no element strictly contains (e.g. a curved-boundary
    point of a *different* discretization sitting O(h^p) outside this
    one's isoparametric boundary) is assigned to the element whose
    converged parametric coordinate exceeds [-1, 1] the least, provided
    that excess is below the tolerance.
    """
    point = np.asarray(point, dtype=np.float64)
    centroids = disc.mesh.centroids
    dist = np.linalg.norm(centroids - point, axis=1)
    order = np.argsort(dist)
    if max_candidates is not None:
        order = order[:max_candidates]
    best = None  # (excess, element, x_param)
    for e in order:
        try:
            x_param = inverse_map(disc, int(e), point)
            return int(e), x_param
        except OutsideDomain as exc:
            if extrapolate_tol > 0.0 and len(exc.args) > 1:
                x_param = np.asarray(exc.args[1])
                excess = float(np.max(np.maximum(np.abs(x_param) - 1.0, 0)))
                if best is None or excess < best[0]:
                    best = (excess, int(e), x_param)
    if best is not None and best[0] <= extrapolate_tol:
        return best[1], np.clip(best[2], -1.0, 1.0)
    raise OutsideDomain(
        f"Point {point} appears outside the domain of the mesh."
    )


def locate_points(disc, points, extrapolate_tol: float = 0.0,
                  max_candidates: int = 16):
    """Batched point location: (elem (Q,), xi (Q, ndim)).

    Uses the native C++ locator (bin-grid candidate search + Newton inverse
    map, ``..native.meshkit``, at most ``max_candidates`` elements per
    point) when the toolchain is available — the framework's counterpart
    of the reference's C interpolation prototype (``sem/bary_interp.c``) —
    and falls back to the per-point Python scan (every element in centroid
    order).  ``elem`` is -1 for points outside the mesh.
    """
    from .. import native

    points = np.asarray(points, dtype=np.float64).reshape(-1, disc.ndim)
    if disc.ndim == 2 and native.available():
        b0 = disc.map_basis.subbases[0]
        b1 = disc.map_basis.subbases[1]
        return native.locate_points(
            disc.mesh.centroids, disc.x_coeffs, disc.J,
            b0.nodes, b0.bary_wts, b1.nodes, b1.bary_wts,
            points, extrapolate_tol=extrapolate_tol,
            max_candidates=max_candidates,
        )
    elem = np.full(points.shape[0], -1, dtype=np.int64)
    xi = np.zeros((points.shape[0], disc.ndim))
    for q, pt in enumerate(points):
        try:
            e, x_param = find_element_containing_point(
                disc, pt, extrapolate_tol=extrapolate_tol
            )
            elem[q], xi[q] = e, x_param
        except OutsideDomain:
            pass
    return elem, xi


def interpolate(disc, coeffs, points, extrapolate_tol: float = 1e-3
                ) -> np.ndarray:
    """Evaluate a global nodal field at arbitrary physical points.

    ``coeffs``: (..., n_nodes); ``points``: (ndim,) or (M, ndim).
    Returns (..., ) or (..., M).  Parity: ``sem/discrete.py:221-233``.
    Points marginally outside curved boundaries are clipped into the
    nearest element (see :func:`find_element_containing_point`).
    """
    coeffs = np.asarray(coeffs)
    points = np.asarray(points, dtype=np.float64)
    single = points.ndim == 1
    pts = points.reshape(-1, disc.ndim)
    out = np.zeros(coeffs.shape[:-1] + (pts.shape[0],))
    elems, xis = locate_points(disc, pts, extrapolate_tol=extrapolate_tol)
    for k, (e, x_param) in enumerate(zip(elems, xis)):
        if e < 0:
            raise OutsideDomain(
                f"Point {pts[k]} appears outside the domain of the mesh."
            )
        local = coeffs[..., disc.gather_nodes[e]].reshape(
            coeffs.shape[:-1] + disc.shape
        )
        out[..., k] = disc.basis.interpolate(local, x_param)
    return out[..., 0] if single else out
