"""Discretization core: batched DOF/geometry precompute and mappings.

Numpy copies of the JAX package's ``core`` modules; point location is not
ported yet.
"""

from .discretization import Discretization
from .mapping import FaceGeometry, det_inv_2x2, jacobian, mapping_coeffs

__all__ = [
    "Discretization",
    "FaceGeometry",
    "det_inv_2x2",
    "jacobian",
    "mapping_coeffs",
]
