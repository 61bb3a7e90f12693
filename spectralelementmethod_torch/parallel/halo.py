"""Element-sharded operators with an explicit halo exchange (PyTorch port).

Port of the JAX package's ``parallel/halo.py``.  There the operator runs
inside ``jax.shard_map`` over a device mesh and ``jax.lax.ppermute`` moves
each shard's boundary strip to its ring neighbour.  Here each function is
written once against a mesh (:mod:`.comm`): on a simulated mesh (a shard
count or a single-controller :class:`.sharding.DeviceMesh`) the program
holds whole (n, E) tensors whose S contiguous column blocks are the
shards, and every strip a shard receives is a copy of its neighbour's
boundary columns; on a mesh over a ``torch.distributed`` process group each
rank holds its own (n, E / S) block on its own card and the strips travel
as messages, one packed buffer per neighbour and direction per DSS or
apply.

* :func:`global_roll` — ``torch.roll`` along the sharded element axis, as
  per-block shifts plus the ring's strips (the wrap-around pair elided
  where the class masks discard it, :func:`_class_uses_wrap`);
* :func:`make_halo_dss_T` — the roll-class DSS on each block extended by
  its neighbours' strips;
* :func:`block_roll` and :func:`make_halo_dss_3d` — any-offset block
  rolls (from the at most two source shards) and the 3D plane-roll DSS
  built on them;
* :func:`make_sharded_local_operator` — the per-shard local product
  (plain PyTorch, any dtype) and the halo DSS;
* :func:`make_sharded_fused_operator` — per shard, the strips, the block
  kernel (:func:`..ops.kernels.affine_block_apply_dss`) on the
  halo-extended block and its centre columns (float32, affine meshes).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..config import check_precision
from ..ops import kernels, sumfac
from . import comm

ELEM_AXIS = "elements"


def global_roll(x, delta: int, axis_name: str, n_shards,
                wrap: bool = True):
    """``torch.roll(x, -delta, dims=-1)`` over a last axis split into
    element shards.

    ``n_shards``: a shard count or a simulated mesh (``x`` is the whole
    (..., E) tensor), or a mesh over a process group (``x`` is the rank's
    (..., E / S) block, as the reference's is inside ``shard_map``).
    ``axis_name`` names the mesh axis there and is not read here.  Each
    block shifts by ``delta`` within itself and takes the ``|delta|``-wide
    boundary strip of its ring neighbour.  ``wrap=False`` drops the global
    wrap-around pair of the ring: the shard that would receive it gets
    zeros, which is exact whenever the class mask discards every wrapped
    lane (any non-periodic element order).
    """
    if delta == 0:
        return x
    mesh = comm.as_mesh(n_shards)
    if not comm.distributed(mesh) and mesh.size == 1:
        return torch.roll(x, -delta, dims=-1)
    blocks = comm.split(mesh, x)
    Eb, S = blocks[0].shape[-1], int(mesh.size)
    if abs(delta) >= Eb:
        raise ValueError(
            f"roll offset {delta} exceeds the per-shard block ({Eb}); "
            f"use fewer shards or a locality-preserving element order")

    def need(i):
        if delta > 0:
            return [(i, delta, Eb),
                    ((i + 1) % S, 0, delta) if wrap or i != S - 1
                    else (None, 0, delta)]
        d = -delta
        return [((i - 1) % S, Eb - d, Eb) if wrap or i != 0
                else (None, 0, d), (i, 0, Eb - d)]

    return comm.join(mesh, comm.fetch(mesh, blocks, need))


def block_roll(x: torch.Tensor, shift: int, n_shards,
               dim: int = 0) -> torch.Tensor:
    """``torch.roll(x, shift, dims=dim)`` over an axis split into equal
    element shards, for any ``shift``: each block of the result is the
    concatenation of the (at most two) source blocks' pieces that hold its
    elements — the 3D plane rolls, whose offsets (``ny nz`` along the first
    axis) may exceed a shard's block.  ``n_shards`` as in
    :func:`global_roll` (on a process group ``x`` is the rank's block and
    the pieces come from the source ranks)."""
    mesh = comm.as_mesh(n_shards)
    if not comm.distributed(mesh) and mesh.size == 1:
        return torch.roll(x, shift, dims=dim)
    blocks = comm.split(mesh, x, dim)
    S = int(mesh.size)
    Eb = blocks[0].shape[dim]
    E = S * Eb

    def need(i):
        q, r = divmod((i * Eb - shift) % E, Eb)
        parts = [(q, r, Eb)]
        if r:
            parts.append(((q + 1) % S, 0, r))
        return parts

    return comm.join(mesh, comm.fetch(mesh, blocks, need, dim), dim)


def make_halo_dss_3d(exchange, axis_name: str = ELEM_AXIS,
                     n_shards=1):
    """Plane-roll DSS of lexicographic (E, n) 3D L-vectors (or stacks) over
    element shards: :meth:`..ops.exchange.BoxRollExchange3D.dss` with
    every element-axis roll of a face plane made by :func:`block_roll`
    (the reference's collective-permutes).  ``n_shards`` as in
    :func:`global_roll`: on a process group the DSS takes the rank's
    (E / S, n) block and reads its block of the neighbour masks.
    ``axis_name`` names the mesh axis and is not read here."""
    from ..ops.exchange import BoxRollExchange3D

    ex = exchange
    if not isinstance(ex, BoxRollExchange3D):
        raise ValueError("the 3D halo DSS requires a BoxRollExchange3D "
                         "(a lexicographic box element order)")
    mesh = comm.as_mesh(n_shards)
    comm.block_size(mesh, ex.E)
    if comm.distributed(mesh):
        # the rank's view: its block of the neighbour masks, its own cache
        # of device copies
        ex = copy.copy(ex)
        ex._dev_cache = {}
        ex._mask_lo = comm.block_of(mesh, ex._mask_lo)
        ex._mask_hi = comm.block_of(mesh, ex._mask_hi)

    def roll(x, shift, dims):
        return block_roll(x, shift, mesh, dims)

    def dss(vL: torch.Tensor) -> torch.Tensor:
        L = vL.dim() - 2
        u = vL.reshape(*vL.shape[:-1], *ex.shape).clone()
        return ex._planes(u, L + 1, L, (-1, 1, 1), roll).reshape(vL.shape)

    return dss


def _class_uses_wrap(mask, delta: int) -> bool:
    """True iff rolling by ``delta`` feeds any unmasked destination lane
    from a wrapped (modulo-E) source — i.e. the element order is
    periodic for this roll class.

    ``roll(v, -delta)`` wraps destinations ``[E-delta, E)`` (for
    ``delta > 0``; ``[0, -delta)`` otherwise); the contribution survives
    the class mask only if the mask is set there.
    """
    m = np.asarray(mask, bool)
    return bool(m[-delta:].any() if delta > 0 else m[:-delta].any())


def _check_exchange(exchange):
    ex = exchange
    if not hasattr(ex, "edge_classes"):
        raise ValueError("halo exchange requires a roll-class exchange "
                         "(RollExchange)")
    if ex.n_edge_tail or ex.n_vert_tail:
        raise ValueError(
            "halo exchange requires zero roll-class tails (structured "
            "meshes); generic pairs would need arbitrary cross-shard "
            "gathers")
    if getattr(ex, "layout", "edges-first") != "edges-first":
        raise ValueError("halo exchange requires edges-first layout")
    return ex


def _ring_widths(edge_classes, vert_classes):
    """``(left, right, wrap_left, wrap_right)`` of a class list (tuples
    with the delta third and the wrap flag last): the strip each block
    needs from its left neighbour (the largest -delta) and its right one
    (the largest delta), and whether any class reading that side keeps the
    ring's wrap-around pair."""
    cls = [(int(c[2]), bool(c[-1])) for c in list(edge_classes)
           + list(vert_classes)]
    left = max([-d for d, _w in cls if d < 0] + [0])
    right = max([d for d, _w in cls if d > 0] + [0])
    return (left, right, any(w for d, w in cls if d < 0),
            any(w for d, w in cls if d > 0))


def make_halo_dss_T(exchange, axis_name: str = ELEM_AXIS,
                    n_shards=1):
    """Roll-class DSS of transposed L-vectors over element shards.

    Returns ``dss(vT, masks) -> vT``: ``vT`` the (n_loc, E) tensor (on a
    process group the rank's (n_loc, E / S) block), ``masks`` the (C, E)
    bool stack of the class masks (edge classes first, then vertex classes
    — :func:`stack_class_masks`; on a process group the rank's block of
    it).  ``n_shards`` as in :func:`global_roll`.  The boundary rows of
    each block (the edge and vertex slots) are extended by the strips of
    its two ring neighbours, as wide as the widest class offset on that
    side (one packed message per neighbour on a process group), and every
    class roll is a slice of the extended block: the reference's
    ``RollExchange._dss_T_2d`` with :func:`global_roll` in place of the
    roll, its sums in the same order.  ``dss._edge_wrap`` /
    ``dss._vert_wrap`` record which classes keep the ring's wrap-around
    pair; a side whose classes all discard it (any non-periodic element
    order) does not exchange it, on both ends of the pair alike.
    """
    ex = _check_exchange(exchange)
    mesh = comm.as_mesh(n_shards)
    neb = ex.n_edge_block
    eo, el = ex.edge_off, ex.edge_len
    ov, rows = ex.off_vert, ex.off_int
    # per-class wrap elision: a class whose mask discards every wrapped
    # lane (any non-periodic element order) skips the wrap-around pair
    edge_classes = [(d, s, int(dl), bool(f), _class_uses_wrap(m, int(dl)))
                    for d, s, dl, f, m in ex.edge_classes]
    vert_classes = [(d, s, int(dl), _class_uses_wrap(m, int(dl)))
                    for d, s, dl, m in ex.vert_classes]
    n_e = len(edge_classes)
    left, right, wrap_l, wrap_r = _ring_widths(edge_classes, vert_classes)

    def dss(vT, masks):
        ext = comm.ring_extend(mesh, comm.split(mesh, vT[:rows]), left,
                               right, wrap_l, wrap_r)
        X = torch.stack(ext) if len(ext) > 1 else ext[0][None]
        Mk = comm.split(mesh, masks)
        Mk = torch.stack(Mk) if len(Mk) > 1 else Mk[0][None]
        Eb = Mk.shape[-1]

        def rolled(lo, hi, delta):
            return X[:, lo:hi, left + delta:left + delta + Eb]

        V = rolled(0, rows, 0)
        parts = []
        if neb > 0:
            F = V[:, :neb]
            recv = torch.zeros_like(F)
            for ci, (d_f, s_f, delta, flip, _w) in enumerate(edge_classes):
                src = rolled(eo[s_f], eo[s_f] + el[s_f], delta)
                if flip:
                    src = src.flip(1)
                src = torch.where(Mk[:, ci:ci + 1], src, 0.0)
                recv[:, eo[d_f]:eo[d_f] + el[d_f]] += src
            parts.append(F + recv)
        vsum = V[:, ov:ov + 4].clone()
        for cj, (d_s, s_s, delta, _w) in enumerate(vert_classes):
            src = rolled(ov + s_s, ov + s_s + 1, delta)[:, 0]
            vsum[:, d_s] += torch.where(Mk[:, n_e + cj], src, 0.0)
        parts.append(vsum)
        out = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        out = (out[0] if out.shape[0] == 1
               else out.permute(1, 0, 2).reshape(rows, -1))
        return torch.cat([out, vT[rows:]], dim=0)

    dss._edge_wrap = [c[4] for c in edge_classes]
    dss._vert_wrap = [c[3] for c in vert_classes]
    return dss


def stack_class_masks(exchange) -> np.ndarray:
    """(C, E) bool stack of the exchange's class masks (edges, verts)."""
    ex = _check_exchange(exchange)
    masks = [np.asarray(m, bool) for *_c, m in ex.edge_classes]
    masks += [np.asarray(m, bool) for *_c, m in ex.vert_classes]
    if not masks:
        return np.zeros((0, ex.E), dtype=bool)
    return np.stack(masks, axis=0)


class _BlockExchangeView:
    """Exchange-shaped view of one halo-extended element block.

    The roll-class structure of a global exchange (slots, offsets, deltas)
    with the element count replaced by the extended block size; no masks
    are baked: :meth:`plan` gives the class tables with the masks a runtime
    operand (:meth:`..ops.exchange.DSSPlan.block_view`), which each shard
    passes as its slice of the global masks.
    """

    layout = "edges-first"
    n_edge_tail = 0
    n_vert_tail = 0

    def __init__(self, ex, E_ext: int):
        self._ex = ex
        self.n_loc, self.ne = ex.n_loc, ex.ne
        self.edge_len, self.edge_off = ex.edge_len, ex.edge_off
        self.off_edge, self.off_vert = ex.off_edge, ex.off_vert
        self.off_int = ex.off_int
        self.E = self.E_real = int(E_ext)
        self.edge_classes = [(d, s, int(dl), bool(f), None)
                             for d, s, dl, f, _m in ex.edge_classes]
        self.vert_classes = [(d, s, int(dl), None)
                             for d, s, dl, _m in ex.vert_classes]

    def plan(self, device):
        return self._ex.plan(device).block_view(self.E)


def _halo_width(ex) -> int:
    """H_full: the largest |delta| of any class (at least 1)."""
    return max([abs(int(c[2])) for c in ex.edge_classes]
               + [abs(int(c[2])) for c in ex.vert_classes] + [1])


def make_sharded_fused_operator(exchange, Kcat, a, mesh,
                                free_local=None,
                                axis: str = ELEM_AXIS,
                                precision: str = "highest",
                                interpret: bool = False):
    """Element-sharded affine apply+DSS: per shard, the strips, the block
    kernel, the centre.

    Each shard takes the ``H``-wide boundary strips of its two ring
    neighbours (``H`` = the largest |delta| of any class; the wrap-around
    pair only where a class keeps it, :func:`_ring_widths`) around its
    (n_loc, Eb) block, runs :func:`..ops.kernels.affine_block_apply_dss` on
    the (n_loc, Eb + 2H) extended block with its slices of the global
    affine scales and class masks, and keeps the centre columns.  One
    block launch per shard and apply: on a process group, one per rank on
    its own card, the strips one packed message per neighbour.

    ``Kcat``: (n, 3n) assembled element stiffness
    (:func:`..ops.sumfac.make_affine_element_matrices`; the block kernel
    computes it in tensor-product form from
    :func:`..ops.sumfac.affine_tensor_factors`, so on a CUDA device a
    ``Kcat`` without them raises); ``a``: (E, 3)
    affine scales of the exchange's (padded) elements; ``mesh``: a
    :func:`.sharding.device_mesh` (its ``size`` shards, its ``device``);
    ``free_local``: optional (n, E) bool Dirichlet mask (on a process
    group, the whole mask or the rank's (n, Eb) block).  Returns ``A(uT)``
    on (n_loc, E) float32 tensors, or on the rank's (n_loc, Eb) blocks.
    ``precision``: ``"highest"``, ``"high"`` or ``"default"`` (another
    raises ``ValueError``); the kernel computes true float32 at every tier
    (ROADMAP Queue 3).  ``interpret=True`` raises (a Pallas mode; CPU
    tensors run the kernel's plain version).

    Unlike the reference, the halo is not rounded up to 128 lanes and needs
    no tiling search, so a shard block only has to be as wide as ``H``.
    Redundant compute: each shard re-applies the operator on its 2H halo
    columns, a 2 H S / E fraction.  ``A._block_operands`` holds the held
    shards' slices (index them by position in ``comm.owned(mesh)``) and
    ``A._extended(blocks, s)`` makes shard ``s``'s extended input from the
    whole list of blocks (a simulated mesh's, or ``[x]`` at one rank).
    """
    check_precision(precision)
    if interpret:
        raise ValueError("interpret=True is a Pallas mode; CPU tensors run "
                         "the block kernel's plain version")
    ex = _check_exchange(exchange)
    n, E = ex.n_loc, ex.E
    S = int(mesh.size)
    if E % S:
        raise ValueError(f"E={E} not divisible by {S} shards; pad the "
                         f"exchange (pad_to)")
    Eb = E // S
    H = _halo_width(ex)
    if H > Eb:
        raise ValueError(
            f"halo {H} exceeds the per-shard block ({Eb}); use fewer "
            f"shards or a locality-preserving element order")
    Eext = Eb + 2 * H
    dev = mesh.device
    view = _BlockExchangeView(ex, Eext)
    block_plan = view.plan(dev)
    if dev.type == "cuda" and n == 4:
        # a plan beyond the p = 1 kernel's limits raises here, not at the
        # first apply
        kernels.p1_classes(block_plan)

    Kcat = np.asarray(Kcat, dtype=np.float64)
    Kst = torch.as_tensor(np.stack([Kcat[:, c * n:(c + 1) * n]
                                    for c in range(3)]),
                          device=dev).to(torch.float32).contiguous()
    factors = sumfac._operator_factors(Kcat, dev)
    aT_g = np.ascontiguousarray(np.asarray(a, np.float64).T)      # (3, E)
    M_g = stack_class_masks(ex)                                  # (C, E)
    wraps = ([(d, s, int(dl), _class_uses_wrap(m, int(dl)))
              for d, s, dl, _f, m in ex.edge_classes]
             + [(d, s, int(dl), _class_uses_wrap(m, int(dl)))
                for d, s, dl, m in ex.vert_classes])
    _l, _r, wrap_l, wrap_r = _ring_widths(wraps, [])
    if M_g.shape[0] == 0:
        M_g = np.zeros((1, E), dtype=bool)
    held = comm.owned(mesh)
    idx = (np.arange(-H, Eb + H)[None, :]
           + (np.asarray(held) * Eb)[:, None]) % E           # (S_own, Eext)
    a_stack = torch.as_tensor(
        np.ascontiguousarray(aT_g[:, idx].transpose(1, 0, 2)),
        device=dev).to(torch.float32)                    # (S_own, 3, Eext)
    m_stack = torch.as_tensor(
        np.ascontiguousarray(M_g[:, idx].transpose(1, 0, 2)),
        device=dev)                                      # (S_own, C, Eext)
    free = None
    if free_local is not None:
        free = torch.as_tensor(free_local, device=dev)
        if comm.distributed(mesh) and free.shape[-1] == E:
            free = comm.block_of(mesh, free).contiguous()

    def extended(blocks, s):
        """Shard ``s``'s block with its neighbours' strips: the left one
        from shard s - 1's end, the right one from shard s + 1's start."""
        k = len(blocks)
        left = blocks[(s - 1) % k][:, Eb - H:]
        right = blocks[(s + 1) % k][:, :H]
        return torch.cat([left, blocks[s], right], dim=1)

    def A(uT):
        if free is not None:
            uT = torch.where(free, uT, 0.0)
        ext = comm.ring_extend(mesh, comm.split(mesh, uT), H, H, wrap_l,
                               wrap_r)
        outs = []
        for k in range(len(held)):
            blk = kernels.affine_block_apply_dss(
                ext[k].contiguous(), Kst, a_stack[k], m_stack[k],
                block_plan, factors=factors)
            outs.append(blk[:, H:H + Eb])
        out = comm.join(mesh, outs, dim=1)
        if free is not None:
            out = torch.where(free, out, 0.0)
        return out

    A._halo = H
    A._block_plan = block_plan
    A._block_operands = (Kst, a_stack, m_stack, factors)
    A._extended = extended
    return A


def make_sharded_local_operator(exchange, Gf, Dhat, mesh,
                                free_local=None,
                                axis: str = ELEM_AXIS,
                                precision: str = "highest"):
    """Element-sharded transposed weak Laplacian with the halo DSS.

    ``Gf``: (E, 3, n) geometric factors, zero-padded here to the exchange's
    element count (``E`` must divide by the mesh size); ``Dhat``: (2n, n)
    stacked derivative in lex order; ``free_local``: optional (n, E)
    Dirichlet mask (on a process group, the whole mask or the rank's
    block).  Returns ``A(uT)`` on (n_loc, E) tensors of the factors' dtype
    (float64 works: no kernel is involved), or on the rank's (n_loc, E /
    S) blocks under a process group.  The local product runs per shard
    block in plain PyTorch; only the DSS strips cross blocks.
    ``precision`` as in :func:`make_sharded_fused_operator`: every tier
    computes in the factors' dtype.
    """
    check_precision(precision)
    ex = _check_exchange(exchange)
    n, E = ex.n_loc, ex.E
    S = int(mesh.size)
    if E % S:
        raise ValueError(f"E={E} not divisible by {S} shards; pad the "
                         f"exchange (pad_to)")
    dev = mesh.device
    Gf = np.asarray(Gf)
    if Gf.shape[0] < E:
        Gf = np.concatenate([Gf, np.zeros((E - Gf.shape[0],) + Gf.shape[1:],
                                          Gf.dtype)])
    dt = torch.float64 if Gf.dtype == np.float64 else torch.float32
    Dhat_h = torch.as_tensor(np.asarray(Dhat, np.float64)[:, ex.hier],
                             device=dev).to(dt)
    gT = torch.as_tensor(np.ascontiguousarray(comm.block_of(
        mesh, Gf.transpose(1, 2, 0))), device=dev).to(dt)   # (3, n, E[b])
    masks = torch.as_tensor(np.ascontiguousarray(comm.block_of(
        mesh, stack_class_masks(ex))), device=dev)
    dss = make_halo_dss_T(ex, axis, mesh)
    free = None
    if free_local is not None:
        free = torch.as_tensor(free_local, device=dev)
        if comm.distributed(mesh) and free.shape[-1] == E:
            free = comm.block_of(mesh, free).contiguous()

    def local(u_blk, g_blk):
        grads = torch.matmul(Dhat_h, u_blk)                      # (2n, Eb)
        ur, us = grads[:n], grads[n:]
        flux = torch.cat([g_blk[0] * ur + g_blk[1] * us,
                          g_blk[1] * ur + g_blk[2] * us], dim=0)
        return torch.matmul(Dhat_h.T, flux)                      # (n, Eb)

    def A(uT):
        if free is not None:
            uT = torch.where(free, uT, 0.0)
        S_loc = comm.join(mesh, [local(u_b, g_b) for u_b, g_b in
                                 zip(comm.split(mesh, uT),
                                     comm.split(mesh, gT))])
        vT = dss(S_loc, masks)
        if free is not None:
            vT = torch.where(free, vT, 0.0)
        return vT

    A._dss = dss
    return A
