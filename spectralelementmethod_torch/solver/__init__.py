"""Solvers on PyTorch tensors: preconditioned CG (:mod:`.cg`), restarted
GMRES, static condensation, FDM Schwarz (:mod:`.fdm`), p-multigrid
(:mod:`.pmg`), Newton and secant root finding.

Exports the names of this slice as the JAX package's ``solver`` does.  Its
CG names are not re-exported here: ``from ...solver import cg`` gives the
:mod:`.cg` module, as the port's callers use it.
"""

from .gmres import GMRESResult, gmres, gmres_batched
from .condensation import CondensedSystem, schur_solve
from .rootfind import SolverFailure, newton

__all__ = [
    "GMRESResult",
    "gmres",
    "gmres_batched",
    "CondensedSystem",
    "schur_solve",
    "SolverFailure",
    "newton",
]
