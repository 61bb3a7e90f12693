"""Element-sharded operators with an explicit halo exchange (PyTorch port).

Port of the JAX package's ``parallel/halo.py``.  There the operator runs
inside ``jax.shard_map`` over a device mesh and ``jax.lax.ppermute`` moves
each shard's boundary strip to its ring neighbour.  Here the program is
single-controller as well, on one device: vectors stay whole (n, E)
tensors, the shards are their S contiguous column blocks of E / S
elements, and every strip a shard receives is an explicit copy of its
neighbour's boundary columns — the ppermute, made visible.  On the CPU this
has the reference's semantics on its virtual mesh; on a card it runs S
simulated shards (shards on several cards are ROADMAP work).

* :func:`global_roll` — ``torch.roll`` along the sharded element axis, as
  per-block shifts plus the ring's strip copies (the wrap-around pair
  elided where the class masks discard it, :func:`_class_uses_wrap`);
* :func:`make_halo_dss_T` — the roll-class DSS built on it;
* :func:`make_sharded_local_operator` — the per-shard local product
  (plain PyTorch, any dtype) and the halo DSS;
* :func:`make_sharded_fused_operator` — per shard, the strips, the block
  kernel (:func:`..ops.kernels.affine_block_apply_dss`) on the
  halo-extended block and its centre columns (float32, affine meshes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, sumfac

ELEM_AXIS = "elements"


def _blocks(x: torch.Tensor, n_shards: int):
    """The shards' column blocks (views) of the last axis."""
    E = x.shape[-1]
    if E % n_shards:
        raise ValueError(f"E={E} not divisible by {n_shards} shards; pad the "
                         "exchange (pad_to)")
    return x.split(E // n_shards, dim=-1)


def global_roll(x, delta: int, axis_name: str, n_shards: int,
                wrap: bool = True):
    """``torch.roll(x, -delta, dims=-1)`` over a last axis split into
    ``n_shards`` blocks.

    ``x`` is the whole (..., E) tensor (the reference takes one shard's
    block inside ``shard_map``; ``axis_name`` names the mesh axis there and
    is not read here).  Each block shifts by ``delta`` within itself and
    takes the ``|delta|``-wide boundary strip of its ring neighbour, a copy.
    ``wrap=False`` drops the global wrap-around pair of the ring: the shard
    that would receive it gets zeros, which is exact whenever the class
    mask discards every wrapped lane (any non-periodic element order).
    """
    if delta == 0:
        return x
    if n_shards == 1:
        return torch.roll(x, -delta, dims=-1)
    blocks = _blocks(x, n_shards)
    Eb, S = blocks[0].shape[-1], n_shards
    if abs(delta) >= Eb:
        raise ValueError(
            f"roll offset {delta} exceeds the per-shard block ({Eb}); "
            f"use fewer shards or a locality-preserving element order")
    out = []
    for i, blk in enumerate(blocks):
        if delta > 0:
            recv = (blocks[(i + 1) % S][..., :delta] if wrap or i != S - 1
                    else torch.zeros_like(blk[..., :delta]))
            out.append(torch.cat([blk[..., delta:], recv], dim=-1))
        else:
            d = -delta
            recv = (blocks[(i - 1) % S][..., Eb - d:] if wrap or i != 0
                    else torch.zeros_like(blk[..., :d]))
            out.append(torch.cat([recv, blk[..., :Eb - d]], dim=-1))
    return torch.cat(out, dim=-1)


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


def make_halo_dss_T(exchange, axis_name: str = ELEM_AXIS,
                    n_shards: int = 1):
    """Roll-class DSS of transposed L-vectors over ``n_shards`` element
    blocks.

    Returns ``dss(vT, masks) -> vT``: ``vT`` the (n_loc, E) tensor, ``masks``
    the (C, E) bool stack of the class masks (edge classes first, then
    vertex classes — :func:`stack_class_masks`).  Mirrors the reference's
    (``RollExchange._dss_T_2d`` with :func:`global_roll` in place of the
    roll); ``dss._edge_wrap`` / ``dss._vert_wrap`` record which classes keep
    the ring's wrap-around pair.
    """
    ex = _check_exchange(exchange)
    neb = ex.n_edge_block
    eo, el = ex.edge_off, ex.edge_len
    oe, ov = ex.off_edge, ex.off_vert
    # per-class wrap elision: a class whose mask discards every wrapped
    # lane (any non-periodic element order) skips the wrap-around pair
    edge_classes = [(d, s, int(dl), bool(f), _class_uses_wrap(m, int(dl)))
                    for d, s, dl, f, m in ex.edge_classes]
    vert_classes = [(d, s, int(dl), _class_uses_wrap(m, int(dl)))
                    for d, s, dl, m in ex.vert_classes]
    n_e = len(edge_classes)

    def dss(vT, masks):
        if neb > 0:
            F = vT[oe:oe + neb]
            recv = torch.zeros_like(F)
            for ci, (d_f, s_f, delta, flip, wrp) in enumerate(edge_classes):
                src = global_roll(vT[oe + eo[s_f]: oe + eo[s_f] + el[s_f]],
                                  delta, axis_name, n_shards, wrap=wrp)
                if flip:
                    src = src.flip(0)
                src = torch.where(masks[ci:ci + 1], src, 0.0)
                recv[eo[d_f]:eo[d_f] + el[d_f]] += src
            edges = F + recv
        else:
            edges = None

        vsum = vT[ov:ov + 4].clone()
        for cj, (d_s, s_s, delta, wrp) in enumerate(vert_classes):
            src = global_roll(vT[ov + s_s], delta, axis_name, n_shards,
                              wrap=wrp)
            vsum[d_s] += torch.where(masks[n_e + cj], src, 0.0)

        if edges is not None:
            return torch.cat([edges, vsum, vT[ex.off_int:]], dim=0)
        out = vT.clone()
        out[ov:ov + 4] = vsum
        return out

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

    Each shard copies the ``H``-wide boundary strips of its two ring
    neighbours (``H`` = the largest |delta| of any class, the wrap-around
    pair included) onto its (n_loc, Eb) block, runs
    :func:`..ops.kernels.affine_block_apply_dss` on the (n_loc, Eb + 2H)
    extended block with its slices of the global affine scales and class
    masks, and keeps the centre columns.  One block launch per shard and
    apply.

    ``Kcat``: (n, 3n) assembled element stiffness
    (:func:`..ops.sumfac.make_affine_element_matrices`; the block kernel
    computes it in tensor-product form from
    :func:`..ops.sumfac.affine_tensor_factors`, so on a CUDA device a
    ``Kcat`` without them raises); ``a``: (E, 3)
    affine scales of the exchange's (padded) elements; ``mesh``: a
    :func:`.sharding.device_mesh` (its ``size`` shards, its ``device``);
    ``free_local``: optional (n, E) bool Dirichlet mask.  Returns ``A(uT)``
    on (n_loc, E) float32 tensors.  ``precision`` other than ``"highest"``
    raises (the kernel is true f32; the precision tiers are ROADMAP Queue 1
    item 15), and so does ``interpret=True`` (a Pallas mode; CPU tensors run
    the kernel's plain version).

    Unlike the reference, the halo is not rounded up to 128 lanes and needs
    no tiling search, so a shard block only has to be as wide as ``H``.
    Redundant compute: each shard re-applies the operator on its 2H halo
    columns, a 2 H S / E fraction.
    """
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r}: the precision tiers are not ported "
            "yet (ROADMAP Queue 1 item 15)")
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
    if M_g.shape[0] == 0:
        M_g = np.zeros((1, E), dtype=bool)
    idx = (np.arange(-H, Eb + H)[None, :]
           + (np.arange(S) * Eb)[:, None]) % E                   # (S, Eext)
    a_stack = torch.as_tensor(
        np.ascontiguousarray(aT_g[:, idx].transpose(1, 0, 2)),
        device=dev).to(torch.float32)                        # (S, 3, Eext)
    m_stack = torch.as_tensor(
        np.ascontiguousarray(M_g[:, idx].transpose(1, 0, 2)),
        device=dev)                                          # (S, C, Eext)
    free = (None if free_local is None
            else torch.as_tensor(free_local, device=dev))

    def extended(blocks, s):
        """Shard ``s``'s block with its neighbours' strips: the left one
        from shard s - 1's end, the right one from shard s + 1's start."""
        left = blocks[(s - 1) % S][:, Eb - H:]
        right = blocks[(s + 1) % S][:, :H]
        return torch.cat([left, blocks[s], right], dim=1)

    def A(uT):
        if free is not None:
            uT = torch.where(free, uT, 0.0)
        blocks = _blocks(uT, S)
        out = torch.empty_like(uT)
        for s in range(S):
            blk = kernels.affine_block_apply_dss(
                extended(blocks, s), Kst, a_stack[s], m_stack[s], block_plan,
                factors=factors)
            out[:, s * Eb:(s + 1) * Eb] = blk[:, H:H + Eb]
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
    Dirichlet mask.  Returns ``A(uT)`` on (n_loc, E) tensors of the factors'
    dtype (float64 works: no kernel is involved).  The local product runs
    per shard block in plain PyTorch; only the DSS strips cross blocks.
    ``precision`` other than ``"highest"`` raises (ROADMAP Queue 1 item
    15).
    """
    if precision != "highest":
        raise NotImplementedError(
            f"precision={precision!r}: the precision tiers are not ported "
            "yet (ROADMAP Queue 1 item 15)")
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
    gT = torch.as_tensor(np.ascontiguousarray(Gf.transpose(1, 2, 0)),
                         device=dev).to(dt)                       # (3, n, E)
    masks = torch.as_tensor(stack_class_masks(ex), device=dev)
    dss = make_halo_dss_T(ex, axis, S)
    free = (None if free_local is None
            else torch.as_tensor(free_local, device=dev))

    def local(u_blk, g_blk):
        grads = torch.matmul(Dhat_h, u_blk)                      # (2n, Eb)
        ur, us = grads[:n], grads[n:]
        flux = torch.cat([g_blk[0] * ur + g_blk[1] * us,
                          g_blk[1] * ur + g_blk[2] * us], dim=0)
        return torch.matmul(Dhat_h.T, flux)                      # (n, Eb)

    def A(uT):
        if free is not None:
            uT = torch.where(free, uT, 0.0)
        S_loc = torch.cat([local(u_b, g_b) for u_b, g_b in
                           zip(_blocks(uT, S), _blocks(gT, S))], dim=-1)
        vT = dss(S_loc, masks)
        if free is not None:
            vT = torch.where(free, vT, 0.0)
        return vT

    A._dss = dss
    return A
