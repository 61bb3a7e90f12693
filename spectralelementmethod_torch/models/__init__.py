"""Application models: Poisson, Helmholtz, advection-diffusion and the
axisymmetric squirmer (the JAX package's ``models`` exports)."""

from .advection_diffusion import AdvectionDiffusion
from .helmholtz import Helmholtz
from .poisson import Poisson, PoissonSolution
from .squirmer import FixedSphere, Squirmer, SphereWithSlipVel

__all__ = [
    "AdvectionDiffusion",
    "Helmholtz",
    "Poisson",
    "PoissonSolution",
    "FixedSphere",
    "Squirmer",
    "SphereWithSlipVel",
]
