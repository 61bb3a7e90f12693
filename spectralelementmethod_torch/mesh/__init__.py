"""Mesh layer: reference-element topology, mesh container, generators.

Numpy copies of the JAX package's mesh modules (the port imports nothing
of that package), p-order remapping (:func:`.porder.mesh_with_order`, the
p-multigrid coarse level) among them; Gmsh 2.2 / 4.1 import and export in
:mod:`.gmsh` (``from spectralelementmethod_torch.mesh.gmsh import
load_msh``), as in the JAX package.

Covers reference layers L2/L4 and the mesh half of L3 (SURVEY.md §1):
``sem/geometry.py``, ``sem/discrete.py:777-1127``, ``sem/grid_importers.py``.
"""

from .generators import (
    annulus_mesh,
    box_mesh,
    geometric_progression,
    mapped_mesh,
    rectangle_mesh,
    single_cell_mesh,
    structured_patch_mesh,
)
from .geometry import (
    Geometry,
    Line,
    NCube,
    Quadrilateral,
    Simplex,
    subface_index_array,
    subface_slice,
)
from .mesh import Cell, CellBase, Mesh, SubCell
from .porder import mesh_with_order

__all__ = [
    "Geometry",
    "Simplex",
    "NCube",
    "Line",
    "Quadrilateral",
    "subface_slice",
    "subface_index_array",
    "Mesh",
    "CellBase",
    "Cell",
    "SubCell",
    "rectangle_mesh",
    "annulus_mesh",
    "box_mesh",
    "single_cell_mesh",
    "structured_patch_mesh",
    "mapped_mesh",
    "geometric_progression",
    "mesh_with_order",
]
