"""Device operators: DSS exchange, the affine Laplacian, CUDA kernels."""
from .sp_array import KroneckerArray

__all__ = ["KroneckerArray"]
