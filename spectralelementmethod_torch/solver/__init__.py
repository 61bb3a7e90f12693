"""Krylov solvers on PyTorch tensors."""
