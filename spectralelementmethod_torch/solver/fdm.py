"""Fast-diagonalization (FDM) additive-Schwarz preconditioner (PyTorch
port).

Port of the JAX package's ``solver/fdm.py``.  Per element
the weak Laplacian is approximated by the separable surrogate
``A_e ~ a0_e (K (x) M) + a1_e (M (x) K)`` with the 1D GLL stiffness ``K =
D^T diag(w) D``, the lumped mass ``M = diag(w)`` and the per-element
strengths ``a0 = sum(G00) / sum(W)``, ``a1 = sum(G11) / sum(W)``.  One
host-side generalized eigendecomposition ``K S = M S diag(lam)``
diagonalizes every element's surrogate, so an element solve is two dense
(n, n) transforms and a scale:
``A_e^-1 r = (S (x) S) [(S^T (x) S^T) r / (a0 lam_i + a1 lam_j)]``.

On L-vectors the preconditioner is the weighted additive Schwarz sum
``M = sum_e R_e^T W A_e^-1 W R_e``: the multiplicity weights ``W``, the two
transforms (the hierarchical <-> lexicographic node permutation folded into
them, so no gather appears), the scale by the inverse eigenvalues and the
exchange's DSS.  The transforms are ``torch.matmul`` products, as the
reference leaves them to XLA outside any Pallas kernel; they run in true
float32 (TF32 off) on the card.  Construction is host numpy, as in the
reference.

The 3D factory (:func:`make_fdm_preconditioner_3d`) builds the same
surrogate with a third axis and applies its eigen transforms
sum-factorized: three (p1, p1) axis products each way on lexicographic
(E, n) L-vectors, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, torch_dtype, true_f32
from ..ops.sumfac import apply_axis


def gll_fdm_eig(nodes: np.ndarray, weights: np.ndarray, D1: np.ndarray):
    """B-orthonormal eigenpairs of the 1D GLL stiffness/mass pencil.

    Returns ``(lam (p1,), S (p1, p1))`` with ``K S = diag(w) S diag(lam)``
    and ``S^T diag(w) S = I``.
    """
    import scipy.linalg as sla

    w = np.asarray(weights, dtype=np.float64)
    D = np.asarray(D1, dtype=np.float64)
    K = D.T @ np.diag(w) @ D
    K = 0.5 * (K + K.T)
    lam, S = sla.eigh(K, np.diag(w))
    return lam, S


LAYOUTS = ("en", "ne")


class FDMPreconditioner:
    """``M(r)`` of :func:`make_fdm_preconditioner`: on (E, n) L-vectors
    (``"en"``) or transposed (n, E) ones (``"ne"``), or on a (k, ...)
    stack of either, one batched product per transform for the whole
    stack.

    ``fwd`` and ``bwd`` are the dense transforms in the layout's operand
    order (``"ne"``: left factors, eigen x L-vector node and back;
    ``"en"``: their transposes, right factors), ``invD`` the inverse
    eigenvalues and ``w`` the multiplicity weights in the layout, ``free``
    the optional Dirichlet mask, ``dss`` the exchange's DSS of the
    layout."""

    def __init__(self, fwd, bwd, invD, w, free, dss, layout: str):
        self.fwd, self.bwd, self.invD, self.w = fwd, bwd, invD, w
        self.free, self.dss, self.vector_layout = free, dss, layout

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.dim() not in (2, 3) or r.shape[-2:] != self.w.shape:
            raise ValueError(
                f"expected a {tuple(self.w.shape)} L-vector or a (k, "
                f"{', '.join(map(str, self.w.shape))}) stack, got shape "
                f"{tuple(r.shape)}")
        if self.free is not None:
            r = torch.where(self.free, r, 0.0)
        with true_f32():
            if self.vector_layout == "ne":
                t = torch.matmul(self.fwd, r * self.w) * self.invD
                z = torch.matmul(self.bwd, t) * self.w
            else:
                t = torch.matmul(r * self.w, self.fwd) * self.invD
                z = torch.matmul(t, self.bwd) * self.w
        z = self.dss(z)
        if self.free is not None:
            z = torch.where(self.free, z, 0.0)
        return z


def make_fdm_preconditioner(exchange, G, basis, free_local=None,
                            dtype=np.float32, shift_rel: float = 1e-8,
                            vector_layout: str = "en",
                            device=None) -> FDMPreconditioner:
    """Weighted additive-Schwarz FDM preconditioner on L-vectors.

    The reference's signature and defaults, with ``device`` last (the CUDA
    card unless given).

    Parameters
    ----------
    exchange : LocalExchange / RollExchange
        Provides the hierarchical node order, multiplicity weights and the
        DSS of each layout.
    G : (E, 3, p1, p1) or (E, 3, n) geometric factors [G00, G01, G11];
        rows past ``G``'s (padding elements) get unit strengths.
    basis : TensorProductQS (square shape).
    free_local : optional Dirichlet mask (bool, numpy or tensor) in the
        layout of the vectors.
    dtype : the dtype of the vectors and of the transforms.
    shift_rel : an element's eigenvalues at or below ``shift_rel`` times
        its largest (its constant mode) take its smallest positive one.
    vector_layout : ``"en"`` for (E, n) L-vectors (the exchange's ``dss``),
        ``"ne"`` for transposed (n, E) ones (``dss_T``).

    Returns an :class:`FDMPreconditioner` mapping a consistent hierarchical
    L-vector residual to the preconditioned one (symmetric positive
    definite).
    """
    if vector_layout not in LAYOUTS:
        raise ValueError(f"unknown vector_layout {vector_layout!r}")
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    b0 = basis.subbases[0]
    n = b0.n_nodes * b0.n_nodes
    E = exchange.E

    lam, S = gll_fdm_eig(b0.nodes, b0.quad_wts, b0.D1)

    # per-element separable strengths (pad rows -> 1: inert, invertible)
    Gf = np.asarray(G, dtype=np.float64)
    Gf = Gf.reshape(Gf.shape[0], 3, -1)
    sumW = float(np.sum(np.asarray(basis.weight_grid())))
    a0 = np.ones(E)
    a1 = np.ones(E)
    a0[:Gf.shape[0]] = Gf[:, 0, :].sum(axis=1) / sumW
    a1[:Gf.shape[0]] = Gf[:, 2, :].sum(axis=1) / sumW

    # each element's singular constant mode (lam = 0 twice) takes the
    # smallest positive eigenvalue: a tiny clamp (a huge inverse) destroys
    # the preconditioner, as the reference measured
    flat = (a0[:, None, None] * lam[:, None]
            + a1[:, None, None] * lam[None, :]).reshape(E, n)
    keep = flat > shift_rel * flat.max(axis=1, keepdims=True)
    pos_min = np.where(keep, flat, np.inf).min(axis=1, keepdims=True)
    invD = np.where(keep, 1.0 / np.maximum(flat, 1e-300), 1.0 / pos_min)

    # dense transforms with the hierarchical <-> lex permutation folded in:
    # fwd[:, h] takes a hier L-vector to eigen coefficients, bwd[h, :] back
    hier = np.asarray(exchange.hier)
    fwd = np.kron(S.T, S.T)[:, hier]
    bwd = np.kron(S, S)[hier, :]
    w = np.asarray(exchange.weights)                       # (E, n)
    transposed = vector_layout == "ne"

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dt)

    if transposed:
        ops = on(fwd), on(bwd), on(invD.T), on(w.T)
        dss = exchange.dss_T
    else:
        ops = on(fwd.T), on(bwd.T), on(invD), on(w)
        dss = exchange.dss
    free = (None if free_local is None
            else torch.as_tensor(free_local, device=dev))
    return FDMPreconditioner(*ops, free, dss, vector_layout)


class FDMPreconditioner3D:
    """``M(r)`` of :func:`make_fdm_preconditioner_3d` on lexicographic (E,
    n) L-vectors, or on a (..., E, n) stack of them: the weights, three
    (p1, p1) axis products with ``S^T``, the scale by the inverse
    eigenvalues, three with ``S``, the weights and the exchange's DSS."""

    def __init__(self, St, S, invD, w, free, dss, shape):
        self.St, self.S, self.invD, self.w = St, S, invD, w
        self.free, self.dss, self.shape = free, dss, tuple(shape)

    def _axes(self, t: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
        """``B`` applied on each of the three node axes."""
        for axis in range(3):
            t = apply_axis(B, t, axis)
        return t

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if r.shape[-2:] != self.w.shape:
            raise ValueError(
                f"expected a {tuple(self.w.shape)} L-vector or a stack of "
                f"them, got shape {tuple(r.shape)}")
        if self.free is not None:
            r = torch.where(self.free, r, 0.0)
        t = (r * self.w).reshape(*r.shape[:-1], *self.shape)
        with true_f32():
            t = self._axes(t, self.St) * self.invD
            z = self._axes(t, self.S).reshape(r.shape) * self.w
        z = self.dss(z)
        if self.free is not None:
            z = torch.where(self.free, z, 0.0)
        return z


def make_fdm_preconditioner_3d(exchange, G, basis, free_local=None,
                               dtype=np.float64, shift_rel: float = 1e-8,
                               device=None) -> FDMPreconditioner3D:
    """3D FDM additive Schwarz on lexicographic (E, n) L-vectors.

    The reference's signature and defaults, with ``device`` last (the CUDA
    card unless given).  Separable surrogate ``A_e ~ a0 (K (x) M (x) M) +
    a1 (M (x) K (x) M) + a2 (M (x) M (x) K)`` with per-element strengths
    from the diagonal factor slabs (``G``: (E, 6, *shape) packed upper
    triangle, components 0, 3 and 5; rows past ``G``'s get unit
    strengths).  The eigen transforms are applied sum-factorized, three
    (p1, p1) axis products each way (:func:`..ops.sumfac.apply_axis`), not
    as the dense (p1^3)^2 Kronecker matrix; the vectors are in
    lexicographic order, so no permutation is folded in.  ``free_local``:
    an optional (E, n) Dirichlet mask.
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    b0 = basis.subbases[0]
    p1 = b0.n_nodes
    shape = (p1, p1, p1)
    E = exchange.E

    lam, S = gll_fdm_eig(b0.nodes, b0.quad_wts, b0.D1)

    Gf = np.asarray(G, dtype=np.float64)
    Gf = Gf.reshape(Gf.shape[0], 6, -1)
    sumW = float(np.sum(np.asarray(basis.weight_grid())))
    a = np.ones((3, E))
    for c, gi in enumerate((0, 3, 5)):
        a[c, :Gf.shape[0]] = Gf[:, gi, :].sum(axis=1) / sumW

    flat = (a[0][:, None, None, None] * lam[:, None, None]
            + a[1][:, None, None, None] * lam[None, :, None]
            + a[2][:, None, None, None] * lam[None, None, :]).reshape(E, -1)
    keep = flat > shift_rel * flat.max(axis=1, keepdims=True)
    pos_min = np.where(keep, flat, np.inf).min(axis=1, keepdims=True)
    invD = np.where(keep, 1.0 / np.maximum(flat, 1e-300),
                    1.0 / pos_min).reshape((E,) + shape)

    def on(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)

    free = (None if free_local is None
            else torch.as_tensor(free_local, device=dev))
    return FDMPreconditioner3D(on(S.T), on(S), on(invD),
                               on(np.asarray(exchange.weights)), free,
                               exchange.dss, shape)
