"""Models (PDE problems) on top of the discretization and solvers."""
