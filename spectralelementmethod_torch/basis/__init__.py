"""Basis layer: GLL rules, 1D Lagrange bases, tensor products.

Covers reference layers L0/L1 (SURVEY.md §1): ``sem/quadratures.py``,
``sem/basis_data.py``, ``sem/basis_functions.py``.
"""

from .gll import (
    GLLRule,
    gauss_legendre_lobatto,
    gauss_legendre_lobatto_mp,
    load_table,
    write_table,
)
from .lagrange import (
    BarycentricLagrange,
    LagrangeAtGaussLobatto,
    LagrangeGaussLobatto,
)
from .quadrature import GaussLobatto, Quadrature1D, TensorQuadratureRule
from .tensor import (
    NodalTensorProduct,
    TensorProduct,
    TensorProductQS,
    TensorProductSupported,
    apply_matrices,
    gll_basis_2d,
    gll_basis_3d,
)

__all__ = [
    "GLLRule",
    "gauss_legendre_lobatto",
    "gauss_legendre_lobatto_mp",
    "load_table",
    "write_table",
    "BarycentricLagrange",
    "LagrangeGaussLobatto",
    "LagrangeAtGaussLobatto",
    "GaussLobatto",
    "Quadrature1D",
    "TensorQuadratureRule",
    "TensorProduct",
    "NodalTensorProduct",
    "TensorProductQS",
    "TensorProductSupported",
    "apply_matrices",
    "gll_basis_2d",
    "gll_basis_3d",
]
