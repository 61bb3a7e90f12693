"""Device operators: DSS exchange, the affine Laplacian, CUDA kernels."""
