"""Build the port's operator state from arrays of another implementation.

:func:`operator_from_numpy` takes the operator state of an affine 2D
L-vector solve as plain numpy arrays — the assembled stiffness blocks, the
affine scales, the roll classes with their masks, the local-to-global map,
the dot weights, the operator diagonal and the free mask — and builds the
port's operator, exchange plan and CG operands from them.  Fed the JAX
package's arrays, both packages then compute the same function on the same
data, independently of the port's own (copied) host setup; that is how the
tests hold each kernel's plain version against its TPU counterpart.
:meth:`InteropOperator.fused_kernels` builds the deferred and batched
kernels from that state, and ``A.stacked(k)`` is the k-RHS apply.

Arrays padded with inert elements (zero affine scales, false masks, zero
weights, as the reference pads for its TPU lane tiling) are accepted as
they are.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import resolve_device, torch_dtype
from .models.poisson import fused_cg_operands
from .ops import kernels
from .ops.exchange import DSSPlan
from .ops.sumfac import AffineLaplacianT
from .solver.cg import jacobi_preconditioner


class InteropOperator(NamedTuple):
    plan: DSSPlan               # roll-class tables on the device
    A: AffineLaplacianT         # masked operator (assumes masked input)
    A_raw: AffineLaplacianT     # unmasked operator (residual seeds)
    M: Callable                 # Jacobi preconditioner
    w: torch.Tensor             # (n, E) dot weights
    free: torch.Tensor          # (n, E) bool free mask
    inv: torch.Tensor           # (n, E) fused-CG masked inverse diagonal
    w_free: torch.Tensor        # (n, E) fused-CG weights, 0 on Dirichlet
    kA: Callable                # fused CG kernel A bound to this operator
    kB: Callable                # fused CG kernel B
    to_local: Callable          # (n_nodes,) numpy -> (n, E) tensor
    E_real: int                 # elements before padding

    def dot_T(self, uT: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
        prod = uT * vT
        return torch.sum(prod * self.w.to(prod.dtype))

    def fused_kernels(self, n_rhs: int = 1, defer_x: bool = False):
        """``(kA, kB)`` bound to this operator: single-RHS
        (:func:`.ops.kernels.make_fused_cg_kernels`) for ``n_rhs == 1``,
        else for (n_rhs n, E) stacks; ``defer_x`` drops kernel A's x."""
        if n_rhs == 1:
            return kernels.make_fused_cg_kernels(
                self.A.Kst, self.A.aT, self.plan, defer_x=defer_x)
        return kernels.make_fused_cg_kernels_batched(
            self.A.Kst, self.A.aT, self.plan, n_rhs, defer_x=defer_x)


def operator_from_numpy(Kcat, a, edge_classes, vert_classes, gather_hier,
                        weights, diag, free, E_real: int, *,
                        device=None, dtype=np.float32, p_dtype=None,
                        edge_len=None) -> InteropOperator:
    """The port's operator state from numpy arrays.

    ``Kcat`` (n, 3n): [K0 | K1 | K2] in the L-vector node order; ``a``
    (E, 3): affine scales; ``edge_classes`` / ``vert_classes``: roll-class
    lists ``(dst_slot, src_slot, delta, flip, mask)`` /
    ``(dst_slot, src_slot, delta, mask)`` with (E,) bool masks;
    ``gather_hier`` (E, n): global node of each local node; ``weights``
    (E, n): inverse-multiplicity dot weights (0 on pad elements); ``diag``
    (n_nodes,): the assembled operator diagonal; ``free`` (n_nodes,): True
    off Dirichlet nodes; ``E_real``: elements before padding.  The slot
    geometry is the edges-first layout; ``edge_len`` gives the four edge
    slot lengths when the node grid is not square.  ``dtype`` is the
    operator's (float32 for the CUDA kernels); ``p_dtype`` the fused-CG
    direction storage (None or ``torch.bfloat16``).
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    gather_hier = np.asarray(gather_hier)
    E, n = gather_hier.shape
    plan = DSSPlan.from_classes(n, E, edge_classes, vert_classes, dev,
                                edge_len=edge_len)
    freeT = np.ascontiguousarray(np.asarray(free, bool)[gather_hier].T)
    free_t = torch.as_tensor(freeT, device=dev)
    A = AffineLaplacianT(Kcat, a, plan, free_t, assume_masked_input=True,
                         dtype=dt)
    A_raw = AffineLaplacianT(Kcat, a, plan, None, dtype=dt)
    gih = torch.as_tensor(gather_hier, device=dev)

    def to_local(u_global):
        u = torch.as_tensor(np.asarray(u_global), device=dev).to(dt)
        return u[gih].T.contiguous()

    diag = np.asarray(diag)
    M = jacobi_preconditioner(to_local(diag), free_t)
    wT = np.ascontiguousarray(np.asarray(weights).T)
    inv, w_free = fused_cg_operands(diag[gather_hier].T, freeT, wT, p_dtype,
                                    dev)
    kA, kB = kernels.make_fused_cg_kernels(A.Kst, A.aT, plan)
    return InteropOperator(plan, A, A_raw, M, torch.as_tensor(wT, device=dev)
                           .to(dt), free_t, inv, w_free, kA, kB, to_local,
                           int(E_real))
