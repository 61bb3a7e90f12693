"""Discretization core: batched DOF/geometry precompute, mappings, point
location.

Numpy copies of the JAX package's ``core`` modules (point location without
its native fast path).
"""

from .discretization import Discretization
from .mapping import FaceGeometry, det_inv_2x2, jacobian, mapping_coeffs
from .pointlocate import (
    OutsideDomain,
    find_element_containing_point,
    forward_map,
    interpolate,
    inverse_map,
    locate_points,
)

__all__ = [
    "Discretization",
    "FaceGeometry",
    "det_inv_2x2",
    "jacobian",
    "mapping_coeffs",
    "OutsideDomain",
    "find_element_containing_point",
    "forward_map",
    "interpolate",
    "inverse_map",
    "locate_points",
]
