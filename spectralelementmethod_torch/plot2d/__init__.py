"""2D visualization (matplotlib, host-side).

A copy of the JAX package's ``plot2d/`` on the port's ``Discretization``:
solution vectors may be tensors (on any device; they are taken to numpy).
matplotlib is imported only inside the draw functions, so this package
imports where matplotlib is not installed.

Parity: reference ``sem/plot2d/`` (L5 in SURVEY.md §1).
"""

from .contours import surface, triangulate_data, tricontour, tricontourf
from .mesh import (
    PlottingError,
    add_arrow_to_line,
    draw_cell,
    draw_cell_nodes,
    draw_cells,
    draw_nodes,
    triangulate,
)

__all__ = [
    "PlottingError",
    "triangulate",
    "draw_nodes",
    "draw_cell",
    "draw_cell_nodes",
    "draw_cells",
    "add_arrow_to_line",
    "triangulate_data",
    "tricontour",
    "tricontourf",
    "surface",
]
