"""Local-vector (L-vector) storage and structured DSS exchange (PyTorch).

Port of the JAX package's ``ops/exchange.py``.  Fields live element-local
with duplicated shared DOFs ("L-vectors") in hierarchical node order, and
direct stiffness summation (DSS) is a structured neighbour exchange instead
of a global scatter.  The port keeps only the transposed ``(n_loc, E)``
storage on the device in both of the reference's layouts: transposed
``(n_loc, E)`` (the main path's) and row-major ``(E, n_loc)``.

The host tables (edge pairing, vertex numbering, roll classes, multiplicity
weights) are numpy copies of the reference's.  The device half is:

* :meth:`LocalExchange.dss` / :meth:`RollExchange.dss` on ``(..., E, n_loc)``
  tensors and :meth:`LocalExchange.dss_T` / :meth:`RollExchange.dss_T` on
  ``(..., n_loc, E)`` — the plain PyTorch DSS (generic gather,
  :func:`gather_dss`, or ``torch.roll`` + masks per class along the element
  axis, :func:`roll_dss_T`);
* :meth:`LocalExchange.dot` / :meth:`LocalExchange.dot_T` and
  :meth:`LocalExchange._weights_as` — the multiplicity-weighted inner
  product and its weights;
* :class:`DSSPlan` — the class tables on one device, as the hand-written
  CUDA kernels of :mod:`.kernels` and their plain versions read them.

Hexahedral (3D) meshes keep lexicographic ``(E, n_loc)`` L-vectors:
:class:`BoxRollExchange3D` sums the shared DOFs by six element-axis plane
rolls on a lexicographic box, and :class:`PairScatterExchange` (any
conforming mesh, the fallback :func:`make_exchange` takes when the box
check fails) by a partner gather for copies of multiplicity 2 and a
compact fixed-order sum (:func:`accumulate`) for the rest.  Both are
plain PyTorch, as the reference's are XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import canonical_device, torch_dtype


def edges_first_order(hier0, n_edge_block: int) -> np.ndarray:
    """The exchanges' local node order, "edges-first": [edge interiors |
    vertices | cell interior], from a cell's hierarchical order ``hier0``
    (vertices, edges, interior; ``Geometry.hierarchical_node_order``) with
    ``n_edge_block`` edge-interior nodes.  Entry j is the lex node of
    L-vector row j."""
    hier0 = np.asarray(hier0)
    neb = int(n_edge_block)
    return np.concatenate([hier0[4:4 + neb], hier0[:4], hier0[4 + neb:]])


class LocalExchange:
    """Precomputed DSS-exchange structure for a Discretization.

    Requires a conforming single-geometry quad mesh.  Anisotropic node
    grids (``shape[0] != shape[1]``, the reference's tensor bases are
    anisotropic throughout — ``sem/basis_functions.py:683-697``) are
    supported: the four hierarchical edge slots then have per-slot
    lengths ``[m1-2, m1-2, m0-2, m0-2]`` and face pairs must connect
    equal-length slots (guaranteed on a conforming mesh of one geometry).
    The structured :class:`RollExchange` fast path and the hand-written
    CUDA kernels handle anisotropic grids too (per-slot edge lengths;
    classes only pair equal-length slots); ``make_exchange`` falls back
    here for anisotropic meshes whose roll classes would carry edge tails.
    """

    def __init__(self, disc, pad_to: int | None = None):
        geometry = disc.geometry
        m0, m1 = disc.shape
        self.disc = disc
        E = disc.E
        #: padded element count (>= disc.E): pad elements are inert — their
        #: gather rows alias node 0, their dot weights are 0 and no class
        #: mask is set on them — so the element axis divides a shard count
        Ep = E if pad_to is None else int(pad_to)
        if Ep < E:
            raise ValueError(f"pad_to={Ep} < E={E}")
        self.E, self.m = Ep, m0
        self.E_real = E
        self.n_loc = disc.n_loc
        self.is_square = m0 == m1
        #: edge-interior nodes per face slot, hierarchical edge order
        #: (faces normal to axis 0 first — they run along axis 1)
        self.edge_len = (m1 - 2, m1 - 2, m0 - 2, m0 - 2)
        #: per-slot offsets within the edge block
        self.edge_off = tuple(
            int(o) for o in np.concatenate(
                [[0], np.cumsum(self.edge_len[:-1])]))
        #: square-grid convenience (slot-uniform length); None when
        #: anisotropic — square-only consumers must check is_square
        self.ne = m0 - 2 if self.is_square else None
        self.n_edge_block = int(sum(self.edge_len))

        # local node order, "edges-first": [edge interiors | vertices |
        # cell interior] (the reference's hierarchical order,
        # sem/geometry.py:197-212, with the vertex block moved behind the
        # edges), so the exchanged rows are the leading block [0, neb + 4)
        neb = self.n_edge_block
        order = edges_first_order(geometry.hierarchical_node_order, neb)
        self.off_edge, self.off_vert = 0, neb
        self.off_int = neb + 4
        #: the local node order (lex index -> L-vector column)
        self.hier = order
        #: (Ep, n_loc) global node ids in the local order (pad rows alias
        #: node 0; their values never enter any reduction)
        self.gather_hier = np.zeros((Ep, self.n_loc), dtype=np.int64)
        self.gather_hier[:E] = disc.gather_nodes[:, order]

        # ---- edge pairing -------------------------------------------------
        nb_lin = np.arange(Ep * 4, dtype=np.int32)  # default: self
        has_nb = np.zeros((Ep, 4), dtype=bool)
        flip = np.zeros((Ep, 4), dtype=bool)

        def slot_nodes(e_idx, f_idx):
            """Global node ids of the edge-interior nodes of slots (e, f)
            sharing one slot id f (so one static length)."""
            o = self.off_edge + self.edge_off[f_idx]
            return self.gather_hier[e_idx, o:o + self.edge_len[f_idx]]

        pairs = disc.mesh.face_pairs()
        if pairs.size:
            i, fi, j, fj = pairs.T
            bad_len = np.asarray(self.edge_len)[fi] != np.asarray(
                self.edge_len)[fj]
            if np.any(bad_len):
                b = int(np.nonzero(bad_len)[0][0])
                raise ValueError(
                    f"faces ({i[b]},{fi[b]})<->({j[b]},{fj[b]}) have "
                    f"different node counts (non-conforming orders)")
            # conformity + orientation per (fi, fj) slot combination
            # (slots fix the static slice length)
            for f_a in range(4):
                for f_b in range(4):
                    sel = (fi == f_a) & (fj == f_b)
                    if not np.any(sel) or self.edge_len[f_a] == 0:
                        continue
                    mine = slot_nodes(i[sel], f_a)
                    theirs = slot_nodes(j[sel], f_b)
                    same = np.all(mine == theirs, axis=1)
                    rev = np.all(mine == theirs[:, ::-1], axis=1)
                    bad = ~(same | rev)
                    if np.any(bad):
                        b = int(np.nonzero(bad)[0][0])
                        raise ValueError(
                            f"faces ({i[sel][b]},{f_a})<->"
                            f"({j[sel][b]},{f_b}) are not conforming")
                    fl = rev & ~same
                    flip[i[sel], f_a] = fl
                    flip[j[sel], f_b] = fl
            nb_lin[i * 4 + fi] = j * 4 + fj
            nb_lin[j * 4 + fj] = i * 4 + fi
            has_nb[i, fi] = True
            has_nb[j, fj] = True

        self._pairs_np = pairs
        self._nb_lin_np = nb_lin
        self._has_nb_np = has_nb
        self._flip_np = flip

        # ---- node-level edge-exchange gather ------------------------------
        # recv index: for edge-interior column c of element e, the flat
        # (element, column) position of the partner copy (self when no
        # neighbor); orientation flips are folded into the index.  One
        # flat gather then serves any (an)isotropic slot layout.
        cols = np.arange(self.n_loc, dtype=np.int64)
        recv_col = np.tile(cols, (Ep, 1))
        erow = np.arange(Ep, dtype=np.int64)[:, None]
        recv_row = np.tile(erow, (1, self.n_loc))
        for f in range(4):
            l_f = self.edge_len[f]
            if l_f == 0:
                continue
            o = self.off_edge + self.edge_off[f]
            nb = nb_lin[np.arange(Ep) * 4 + f]
            j_e, j_f = nb // 4, nb % 4
            # partner slot offset per element (same length by conformity)
            o_j = (self.off_edge
                   + np.asarray(self.edge_off, dtype=np.int64)[j_f])
            t = np.arange(l_f, dtype=np.int64)[None, :]
            t_j = np.where(flip[:, f][:, None], l_f - 1 - t, t)
            recv_row[:, o:o + l_f] = j_e[:, None]
            recv_col[:, o:o + l_f] = o_j[:, None] + t_j
        oe, neb = self.off_edge, self.n_edge_block
        self._edge_recv_flat = np.asarray(
            (recv_row * self.n_loc + recv_col)[:, oe:oe + neb].reshape(-1))
        edge_mask = np.zeros((Ep, neb), dtype=bool)
        for f in range(4):
            o = self.edge_off[f]
            edge_mask[:, o:o + self.edge_len[f]] = has_nb[:, f][:, None]
        self._edge_recv_mask = np.asarray(edge_mask)

        # ---- vertex numbering --------------------------------------------
        # pad-row vertex copies get fresh singleton ids, so they never join
        # a real vertex's reduction or multiplicity
        vert_g = self.gather_hier[:E, self.off_vert:self.off_vert + 4]
        uniq, inv_real = np.unique(vert_g.ravel(), return_inverse=True)
        self.n_vertices = uniq.size + 4 * (Ep - E)
        inv = np.concatenate([
            inv_real.reshape(-1),
            uniq.size + np.arange(4 * (Ep - E), dtype=np.int64)])
        self._vert_gid_np = inv.astype(np.int64)
        self.vert_gid = inv.astype(np.int64)             # (Ep*4,)

        # ---- multiplicity weights (host-side) ----------------------------
        mult = np.ones((Ep, self.n_loc))
        if self.n_edge_block > 0:
            # edge-interior nodes of faces with a neighbor appear twice
            mult[:, self.off_edge:self.off_edge + self.n_edge_block] += (
                np.repeat(has_nb, self.edge_len, axis=1)
            )
        vert_counts = np.bincount(inv, minlength=self.n_vertices)
        mult[:, self.off_vert:self.off_vert + 4] = (
            vert_counts[inv].reshape(Ep, 4)
        )
        self.multiplicity = mult
        weights = 1.0 / mult
        weights[E:] = 0.0     # pad rows never contribute to inner products
        # kept host-side; device copies materialize lazily per dtype and
        # device in weights_T
        self._weights_np = weights

    # -- conversions (host) ------------------------------------------------

    def local_from_global(self, u_global) -> np.ndarray:
        """(n_nodes[, k]) -> (E, n_loc[, k]) consistent L-vector."""
        return np.asarray(u_global)[self.gather_hier]

    def global_from_local(self, uL) -> np.ndarray:
        """Consistent (E, n_loc[, k]) L-vector -> global (n_nodes[, k])
        (pad rows are dropped)."""
        uL = np.asarray(uL)[:self.E_real]
        out_shape = (self.disc.n_nodes,) + uL.shape[2:]
        out = np.zeros(out_shape, dtype=uL.dtype)
        out[self.gather_hier[:self.E_real].ravel()] = uL.reshape(
            (-1,) + uL.shape[2:]
        )
        return out

    def local_T_from_global(self, u_global) -> np.ndarray:
        """(n_nodes,) -> (n_loc, E) consistent transposed L-vector."""
        return np.ascontiguousarray(self.local_from_global(u_global).T)

    def global_from_local_T(self, uT) -> np.ndarray:
        """Consistent (n_loc, E) transposed L-vector -> global (n_nodes,)."""
        return self.global_from_local(np.asarray(uT).T)

    # -- the exchange on transposed (n_loc, E) tensors ---------------------

    def _on(self, name: str, device) -> torch.Tensor:
        """Device copy of a host index/mask array, cached per device."""
        cache = self.__dict__.setdefault("_dev_cache", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name), device=device)
        return cache[key]

    def dss(self, vL: torch.Tensor) -> torch.Tensor:
        """Direct stiffness summation on (E, n_loc) L-vectors, or on a
        (..., E, n_loc) stack of them, each on its own: every copy of a
        shared DOF gets the sum of the copies.

        Generic form (:func:`gather_dss`): a node-level partner gather for
        the edge interiors and a scatter-add over the vertex copies.
        :class:`RollExchange` overrides it.
        """
        dev = vL.device
        return gather_dss(vL, self._on("_edge_recv_flat", dev),
                          self._on("_edge_recv_mask", dev),
                          self._on("vert_gid", dev), self.n_vertices,
                          self.off_edge, self.off_vert)

    def dss_T(self, vT: torch.Tensor) -> torch.Tensor:
        """DSS on a transposed (n_loc, E) L-vector (or a stack): the
        row-major :meth:`dss` of its transpose, as in the reference.
        :class:`RollExchange` overrides it with a native transposed
        exchange."""
        return self.dss(vT.transpose(-1, -2)).transpose(-1, -2).contiguous()

    def dot(self, uL: torch.Tensor, vL: torch.Tensor) -> torch.Tensor:
        """Global inner product from consistent (E, n_loc) L-vectors
        (1/multiplicity weights); a stack sums over all of it."""
        prod = uL * vL
        return torch.sum(prod * self._weights_as(prod.dtype, prod.device))

    def norm(self, uL: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(uL, uL))

    def dot_T(self, uT: torch.Tensor, vT: torch.Tensor) -> torch.Tensor:
        """Global inner product from consistent transposed L-vectors."""
        prod = uT * vT
        return torch.sum(prod * self.weights_T(prod.dtype, prod.device))

    @property
    def weights(self) -> np.ndarray:
        """(E, n_loc) inverse-multiplicity dot weights (float64, host)."""
        return self._weights_np

    def _weights_as(self, dtype, device,
                    transposed: bool = False) -> torch.Tensor:
        """The dot weights on ``device`` as (E, n_loc), or (n_loc, E) when
        ``transposed``, cached per dtype, device and layout: a fresh cast
        per dot would cost a full pass inside every CG iteration."""
        dt = torch_dtype(dtype)
        cache = self.__dict__.setdefault("_w_cache", {})
        key = (dt, str(device), bool(transposed))
        if key not in cache:
            w = self._weights_np.T if transposed else self._weights_np
            cache[key] = torch.as_tensor(np.ascontiguousarray(w),
                                         device=device).to(dt)
        return cache[key]

    def weights_T(self, dtype, device) -> torch.Tensor:
        """(n_loc, E) dot weights on ``device`` (cached)."""
        return self._weights_as(dtype, device, transposed=True)


class RollExchange(LocalExchange):
    """DSS via constant-element-offset roll classes (structured fast path).

    Arbitrary-index gather/scatter is the slow way to sum shared DOFs;
    ``torch.roll`` along the element axis (or, in the CUDA kernels, a
    constant element offset) is cheap.  On meshes built from structured
    patches (all the reference's meshes: square, donut, tube are
    transfinite) every
    face pair and vertex partnership falls into a handful of *classes*
    ``(dst_slot, src_slot, element_offset, flip)``; each class's exchange is
    one roll + mask + add.  Pairs/partners outside any large-enough class go
    through a small residual gather+scatter ("tail"), so the result equals
    :meth:`LocalExchange.dss` on any conforming mesh (up to fp summation
    order).
    """

    #: keep a (dst_slot, src_slot, delta, flip) class when it covers at
    #: least this fraction of faces/vertex-copies (else it joins the tail)
    MIN_CLASS_FRACTION = 0.02

    def __init__(self, disc, pad_to: int | None = None,
                 min_class_fraction: float | None = None):
        """``pad_to`` pads the element axis with inert elements, as in
        :class:`LocalExchange`; ``min_class_fraction`` overrides
        :data:`MIN_CLASS_FRACTION`.

        The default keeps only large classes (each class costs an O(E)
        roll pass in the plain dss, so tiny ones are cheaper as tail
        gathers).  Panel-ordered meshes pass ``0.0``: their
        cross-panel-boundary pairs form small but *uniform* classes (one
        per boundary direction) that must stay classes — the CUDA kernels
        require zero tails.
        """
        super().__init__(disc, pad_to=pad_to)
        E, ne = self.E, self.ne
        if min_class_fraction is None:
            min_count = max(8, int(self.MIN_CLASS_FRACTION * E))
        else:
            min_count = max(1, int(float(min_class_fraction) * E))

        # ---- edge classes ------------------------------------------------
        pairs = self._pairs_np
        if pairs.size:
            i, fi, j, fj = pairs.T
            fl = self._flip_np[i, fi]
            # both directions of each pair
            dst = np.concatenate([i * 4 + fi, j * 4 + fj])
            src = np.concatenate([j * 4 + fj, i * 4 + fi])
            flips = np.concatenate([fl, fl])
        else:
            dst = src = np.zeros(0, dtype=np.int64)
            flips = np.zeros(0, dtype=bool)

        self.edge_classes = []   # (dst_slot, src_slot, delta, flip, mask)
        tail = np.ones(dst.size, dtype=bool)
        if dst.size:
            d_e, d_f = dst // 4, dst % 4
            s_e, s_f = src // 4, src % 4
            delta = s_e - d_e
            keys = ((d_f * 4 + s_f) * (4 * E + 1) + (delta + 2 * E)
                    ) * 2 + flips
            uniq, counts = np.unique(keys, return_counts=True)
            for key, cnt in zip(uniq[counts >= min_count],
                                counts[counts >= min_count]):
                sel = keys == key
                mask = np.zeros(E, dtype=bool)
                mask[d_e[sel]] = True
                # mask stays host numpy; DSSPlan uploads it per device
                self.edge_classes.append((
                    int(d_f[sel][0]), int(s_f[sel][0]),
                    int(delta[sel][0]), bool(flips[sel][0]),
                    mask,
                ))
                tail[sel] = False
        self.edge_tail_dst = np.asarray(dst[tail])
        self.edge_tail_src = np.asarray(src[tail])
        self.edge_tail_flip = np.asarray(flips[tail][:, None])
        self.n_edge_tail = int(tail.sum())

        # ---- vertex classes ----------------------------------------------
        # partner table: for each vertex copy, the other copies of its
        # global vertex (vectorized construction via group sorting)
        gid = self._vert_gid_np
        order = np.argsort(gid, kind="stable")
        counts = np.bincount(gid, minlength=self.n_vertices)
        Vmax = int(counts.max()) if counts.size else 1
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        # members matrix (n_vertices, Vmax), sentinel = -1
        members = np.full((self.n_vertices, Vmax), -1, dtype=np.int64)
        pos_in_group = np.arange(gid.size) - starts[gid[order]]
        members[gid[order], pos_in_group] = order
        # partners of each copy: all group members except itself
        my_pos = np.empty(gid.size, dtype=np.int64)
        my_pos[order] = pos_in_group
        partners = np.full((gid.size, max(Vmax - 1, 1)), -1, dtype=np.int64)
        col = np.zeros(gid.size, dtype=np.int64)
        for t in range(Vmax):
            m = members[gid, t]                   # (copies,)
            valid = (m >= 0) & (m != np.arange(gid.size))
            partners[valid, col[valid]] = m[valid]
            col[valid] += 1

        cp = np.repeat(np.arange(gid.size), partners.shape[1])
        pr = partners.ravel()
        valid = pr >= 0
        cp, pr = cp[valid], pr[valid]
        d_e, d_s = cp // 4, cp % 4
        s_e, s_s = pr // 4, pr % 4
        delta = s_e - d_e

        self.vert_classes = []   # (dst_slot, src_slot, delta, mask)
        vtail = np.ones(cp.size, dtype=bool)
        if cp.size:
            keys = (d_s * 4 + s_s) * (4 * E + 1) + (delta + 2 * E)
            uniq, counts2 = np.unique(keys, return_counts=True)
            for key in uniq[counts2 >= min_count]:
                sel = keys == key
                mask = np.zeros(E, dtype=bool)
                mask[d_e[sel]] = True
                self.vert_classes.append((
                    int(d_s[sel][0]), int(s_s[sel][0]),
                    int(delta[sel][0]), mask,
                ))
                vtail[sel] = False
        self.vert_tail_dst = np.asarray(cp[vtail])
        self.vert_tail_src = np.asarray(pr[vtail])
        self.n_vert_tail = int(vtail.sum())
        if not self.is_square and self.n_edge_tail:
            # the tail path reshapes the edge block as (E*4, ne) —
            # slot-uniform only; anisotropic meshes must be fully
            # class-covered (make_exchange falls back to LocalExchange)
            raise NotImplementedError(
                "anisotropic RollExchange requires zero edge tails "
                f"(got {self.n_edge_tail}); use LocalExchange")

    @property
    def tail_fraction(self) -> float:
        """Fraction of exchange work not covered by roll classes."""
        total = 2 * len(self._pairs_np) + 4 * self.E
        if total == 0:
            return 0.0
        return (self.n_edge_tail + self.n_vert_tail) / total

    def plan(self, device) -> "DSSPlan":
        """The roll-class tables on ``device`` (cached)."""
        cache = self.__dict__.setdefault("_plan_cache", {})
        key = str(canonical_device(device))
        if key not in cache:
            cache[key] = DSSPlan.from_exchange(self, device)
        return cache[key]

    def dss(self, vL: torch.Tensor) -> torch.Tensor:
        """Roll-class DSS on (E, n_loc) L-vectors (or a (..., E, n_loc)
        stack): one ``torch.roll`` along the element axis + mask + add per
        class (:func:`roll_dss_T` on the transposed view), plus the
        residual gather of pairs outside every class (the "tail")."""
        out = roll_dss_T(vL.transpose(-1, -2), self.plan(vL.device))
        out = out.transpose(-1, -2)
        if self.n_edge_tail or self.n_vert_tail:
            out = out + self._tails(vL)
        return out.contiguous()

    def dss_T(self, vT: torch.Tensor) -> torch.Tensor:
        """Roll-class DSS on a transposed (n_loc, E) L-vector (or a
        (..., n_loc, E) stack): :func:`roll_dss_T`, plus the tails."""
        out = roll_dss_T(vT, self.plan(vT.device))
        if self.n_edge_tail or self.n_vert_tail:
            out += self._tails(vT.transpose(-1, -2)).transpose(-1, -2)
        return out

    def _tails(self, vL: torch.Tensor) -> torch.Tensor:
        """What the pairs outside every class add to (..., E, n_loc)
        L-vectors (zero elsewhere)."""
        E, dev = self.E, vL.device
        oe, ov, neb = self.off_edge, self.off_vert, self.n_edge_block
        lead = vL.shape[:-2]
        add = torch.zeros_like(vL)
        if self.n_edge_tail:
            # residual pairs through the (E*4, ne) row form
            ne = self.ne
            Ff = vL[..., oe:oe + neb].reshape(*lead, E * 4, ne)
            tr = Ff[..., self._on("edge_tail_src", dev), :]
            tr = torch.where(self._on("edge_tail_flip", dev), tr.flip(-1), tr)
            add[..., oe:oe + neb] = accumulate(
                E * 4, self._on("edge_tail_dst", dev), tr, dim=-2).reshape(
                *lead, E, neb)
        if self.n_vert_tail:
            Vf = vL[..., ov:ov + 4].reshape(*lead, E * 4)
            add[..., ov:ov + 4] = accumulate(
                E * 4, self._on("vert_tail_dst", dev),
                Vf[..., self._on("vert_tail_src", dev)], dim=-1).reshape(
                *lead, E, 4)
        return add


class DSSPlan:
    """Roll-class DSS tables on one device, in row terms.

    Every class of the exchange becomes a list of *entries*
    ``(dst_row, src_row, delta, mask_index)``: row ``dst_row`` of element
    ``e`` receives row ``src_row`` of element ``e + delta`` wherever mask
    ``mask_index`` is set at ``e`` (edge classes contribute one entry per
    edge node, with the orientation flip folded into ``src_row``; vertex
    classes one entry each).  The entries are sorted by ``dst_row`` with
    CSR offsets ``row_ptr``, the form the CUDA gather pass reads; the
    edge/vertex block lists keep the class form for :func:`roll_dss_T`.

    ``nb`` is one past the largest row any entry touches: the exchanged
    rows of the edges-first layout are rows ``[0, nb)`` and every row from
    ``nb`` on is element-interior.  A mask is False wherever ``e + delta``
    falls outside ``[0, E)``.

    ``masks=None`` makes a plan whose (C, E) class masks are a runtime
    operand (:meth:`block_view`: one shard's halo-extended block, whose
    masks are its slice of the global ones).  ``nb`` may be given to keep
    the row count of a larger plan (:meth:`split`).
    """

    def __init__(self, n: int, E: int, edge_blocks, vert_rows, masks,
                 device, has_tail: bool = False, nb: int | None = None):
        self.n, self.E = int(n), int(E)
        self.device = canonical_device(device)
        #: (dst_row0, src_row0, length, delta, flip, mask_index)
        self.edge_blocks = [tuple(b) for b in edge_blocks]
        #: (dst_row, src_row, delta, mask_index)
        self.vert_rows = [tuple(v) for v in vert_rows]
        #: pairs outside every class exist (the CUDA kernels refuse them)
        self.has_tail = bool(has_tail)
        if masks is None:
            self.masks = None
        else:
            masks = np.asarray(masks, dtype=bool).reshape(-1, self.E)
            if masks.shape[0] == 0:
                masks = np.zeros((1, self.E), dtype=bool)
            self.masks = torch.as_tensor(masks, device=self.device)

        entries = []
        for d0, s0, L, delta, flip, k in self.edge_blocks:
            for t in range(L):
                entries.append((d0 + t, s0 + (L - 1 - t if flip else t),
                                delta, k))
        entries += [(d, s, delta, k) for d, s, delta, k in self.vert_rows]
        rows = [r for ent in entries for r in ent[:2]]
        self.nb = max(rows) + 1 if rows else 0
        if nb is not None:
            if int(nb) < self.nb:
                raise ValueError(f"nb={nb} < the {self.nb} rows the entries "
                                 "touch")
            self.nb = int(nb)
        entries.sort(key=lambda ent: ent[0])           # stable: class order
        self.n_entries = len(entries)
        tab = np.zeros((max(len(entries), 1), 4), dtype=np.int32)
        for t, (d, s, delta, k) in enumerate(entries):
            tab[t] = (s, delta, k, d)
        row_ptr = np.zeros(self.nb + 1, dtype=np.int32)
        np.add.at(row_ptr, np.asarray([ent[0] for ent in entries],
                                      dtype=np.int64) + 1, 1)
        #: (T, 4) int32 entries (src_row, delta, mask_index, dst_row)
        self.entries = torch.as_tensor(tab, device=self.device)
        #: (nb + 1,) int32 CSR offsets of the entries by dst_row
        self.row_ptr = torch.as_tensor(np.cumsum(row_ptr, dtype=np.int32),
                                       device=self.device)

    @classmethod
    def from_classes(cls, n, E, edge_classes, vert_classes, device, *,
                     edge_len=None, edge_off=None, off_edge=0,
                     off_vert=None, has_tail=False):
        """Plan from exchange class lists ``(dst_slot, src_slot, delta,
        flip, mask)`` / ``(dst_slot, src_slot, delta, mask)``.

        The slot geometry defaults to the square edges-first layout
        (``ne = sqrt(n) - 2`` nodes per edge slot, vertices after the four
        edge blocks)."""
        if edge_len is None:
            m = int(round(np.sqrt(n)))
            if m * m != n:
                raise ValueError(f"n={n} is not square; pass edge_len")
            edge_len = (m - 2,) * 4
        edge_len = tuple(int(v) for v in edge_len)
        if edge_off is None:
            edge_off = tuple(int(v) for v in np.concatenate(
                [[0], np.cumsum(edge_len[:-1])]))
        if off_vert is None:
            off_vert = off_edge + sum(edge_len)
        masks, blocks, verts = [], [], []
        for d_f, s_f, delta, flip, mask in edge_classes:
            if edge_len[d_f] != edge_len[s_f]:
                raise ValueError("edge class pairs slots of unequal length")
            blocks.append((off_edge + edge_off[d_f], off_edge + edge_off[s_f],
                           edge_len[d_f], int(delta), bool(flip), len(masks)))
            masks.append(np.asarray(mask, bool))
        for d_s, s_s, delta, mask in vert_classes:
            verts.append((off_vert + d_s, off_vert + s_s, int(delta),
                          len(masks)))
            masks.append(np.asarray(mask, bool))
        masks = (np.stack(masks) if masks
                 else np.zeros((0, E), dtype=bool))
        return cls(n, E, blocks, verts, masks, device, has_tail=has_tail)

    @classmethod
    def from_exchange(cls, ex, device):
        return cls.from_classes(
            ex.n_loc, ex.E, ex.edge_classes, ex.vert_classes, device,
            edge_len=ex.edge_len, edge_off=ex.edge_off,
            off_edge=ex.off_edge, off_vert=ex.off_vert,
            has_tail=bool(ex.n_edge_tail or ex.n_vert_tail))

    def _with(self, E, edge_blocks, vert_rows, masks, nb=None):
        plan = DSSPlan(self.n, E, edge_blocks, vert_rows, None, self.device,
                       has_tail=self.has_tail, nb=nb)
        plan.masks = masks
        return plan

    def split(self, max_halo: int) -> tuple["DSSPlan", "DSSPlan"]:
        """``(near, far)``: the classes with ``|delta| <= max_halo`` and
        those beyond it (the reference's far classes, ``_AffineFusedPrep``).
        Both keep this plan's masks (by the same indices) and its ``nb``, so
        an apply that gathers the near plan leaves every exchanged row of
        the product in its scratch for the far update to read."""
        h = int(max_halo)
        near = self._with(
            self.E, [b for b in self.edge_blocks if abs(b[3]) <= h],
            [v for v in self.vert_rows if abs(v[2]) <= h], self.masks,
            self.nb)
        far = self._with(
            self.E, [b for b in self.edge_blocks if abs(b[3]) > h],
            [v for v in self.vert_rows if abs(v[2]) > h], self.masks,
            self.nb)
        return near, far

    def block_view(self, E_ext: int) -> "DSSPlan":
        """This plan's classes on a block of ``E_ext`` elements, with the
        class masks a runtime (C, E_ext) operand (``masks`` is None): the
        counterpart of the reference's ``_BlockExchangeView``."""
        return self._with(int(E_ext), self.edge_blocks, self.vert_rows, None,
                          self.nb)

    @property
    def n_classes(self) -> int:
        """Rows of the class-mask stack (at least 1)."""
        return max(1, max([b[5] for b in self.edge_blocks]
                          + [v[3] for v in self.vert_rows] + [-1]) + 1)


def shift(x: torch.Tensor, delta: int) -> torch.Tensor:
    """``out[..., e] = x[..., e + delta]``, zero where ``e + delta`` leaves
    the last axis (``torch.roll(x, -delta, -1)`` without the wrap)."""
    E = x.shape[-1]
    out = torch.zeros_like(x)
    if abs(delta) < E:
        if delta >= 0:
            out[..., :E - delta] = x[..., delta:]
        else:
            out[..., -delta:] = x[..., :E + delta]
    return out


def roll_dss_T(vT: torch.Tensor, plan: DSSPlan, masks=None,
               out=None) -> torch.Tensor:
    """Plain roll-class DSS of an (n, E) array, or of a (k, n, E) stack of
    them, each on its own (no tails): for every class
    ``out[dst rows] += where(mask, roll(v[src rows], -delta), 0)``.

    ``torch.roll`` wraps around the element axis; the masks are False on
    every wrapped lane of an exchange's plan, so wrapped values never enter
    the sum.  ``masks`` (C, E) bool replaces the plan's own (a runtime-mask
    plan, :meth:`DSSPlan.block_view`, needs them); such masks may be set
    where ``e + delta`` leaves the block, and those sources count as zero
    (:func:`shift`), as in the kernels.  ``out`` given: the class sums are
    added into it in place (the exchanged rows of ``vT`` are then not
    copied in first) and it is returned."""
    runtime = masks is not None
    masks = plan.masks if masks is None else masks
    if masks is None:
        raise ValueError("the plan's class masks are a runtime operand; "
                         "pass masks=")
    move = shift if runtime else (lambda x, d: torch.roll(x, -d, dims=-1))
    if out is None:
        out = vT.clone()
    for d0, s0, L, delta, flip, k in plan.edge_blocks:
        src = move(vT[..., s0:s0 + L, :], delta)
        if flip:
            src = src.flip(-2)
        out[..., d0:d0 + L, :] += torch.where(masks[k], src, 0.0)
    for d, s, delta, k in plan.vert_rows:
        out[..., d, :] += torch.where(masks[k], move(vT[..., s, :], delta),
                                      0.0)
    return out


def accumulate(n: int, idx: torch.Tensor, vals: torch.Tensor,
               dim: int | None = None) -> torch.Tensor:
    """Zeros with ``vals`` summed in at ``idx``, in the order of ``idx`` on
    every device, so a repeat gives the same bits.

    ``dim=None``: ``idx`` and ``vals`` are flattened and the result is
    (n,).  ``dim`` an axis of ``vals``: ``idx`` (1D) indexes that axis, the
    leading stack dims and the trailing ones are kept, and the result has
    ``vals``'s shape with that axis n long.  On the CPU the sum is
    ``index_add_`` (a serial loop); on CUDA, where ``index_add_`` adds by
    atomics in no fixed order, the sort-based ``index_put_(accumulate=True)``
    (:func:`_sorted_sum`)."""
    if dim is None:
        idx, vals, dim = idx.reshape(-1), vals.reshape(-1), 0
    if vals.is_cuda:
        return _sorted_sum(n, idx, vals, dim)
    shape = list(vals.shape)
    shape[dim] = n
    return torch.zeros(shape, dtype=vals.dtype,
                       device=vals.device).index_add_(dim, idx, vals)


def _sorted_sum(n: int, idx: torch.Tensor, vals: torch.Tensor,
                dim: int) -> torch.Tensor:
    """:func:`accumulate`'s CUDA form on any device: the axis moved to the
    front and summed by ``index_put_(accumulate=True)``, which adds each
    index's values in the order of ``idx``."""
    v = vals.movedim(dim, 0)
    out = torch.zeros((n, *v.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_put_((idx,), v, accumulate=True).movedim(0, dim)


def gather_dss(vL: torch.Tensor, recv_flat: torch.Tensor,
               recv_mask: torch.Tensor, vert_gid: torch.Tensor,
               n_vertices: int, off_edge: int, off_vert: int) -> torch.Tensor:
    """Generic DSS of (E, n) L-vectors, or of a (..., E, n) stack, each on
    its own (the reference's ``LocalExchange._dss_2d``).

    ``recv_flat`` ((E * neb,) int64): for each edge-interior entry, the
    flat (element, column) position of its partner copy, orientation flips
    folded in; ``recv_mask`` ((E, neb) bool): the entry has a partner;
    ``vert_gid`` ((E * 4,) int64): the global vertex of each vertex copy;
    the edge block starts at column ``off_edge``, the four vertices at
    ``off_vert``.
    """
    E, n = vL.shape[-2:]
    neb = recv_mask.shape[-1]
    lead = vL.shape[:-2]
    out = vL.clone()
    if neb > 0:
        recv = vL.reshape(*lead, E * n)[..., recv_flat].reshape(*lead, E, neb)
        out[..., off_edge:off_edge + neb] += torch.where(recv_mask, recv, 0.0)
    verts = vL[..., off_vert:off_vert + 4].reshape(*lead, E * 4)
    summed = accumulate(n_vertices, vert_gid, verts, dim=-1)
    out[..., off_vert:off_vert + 4] = summed[..., vert_gid].reshape(
        *lead, E, 4)
    return out


class PairScatterExchange:
    """Dimension-generic L-vector DSS in **lexicographic** local order.

    Covers any conforming single-geometry NCube mesh, in particular 3D
    hexahedra, whose shared DOFs come in three kinds: face interiors (always
    2 copies), edge interiors and vertices (variable valence).  The split is
    by multiplicity, not topology:

    * copies of multiplicity 2 exchange through one flat partner gather
      (3D face interiors dominate the shared-DOF count);
    * copies of multiplicity >= 3 scatter-add into a compacted array (one
      slot per distinct shared node, :func:`accumulate`) and gather back;
    * multiplicity-1 copies (element interiors, domain boundary) are
      untouched.

    Partners are matched per global node, so the 8 ways a hex face can glue
    to its neighbour need no bookkeeping.  The host tables are numpy copies
    of the reference's; the device copies are made per device on first
    use.  The exchange acts on (E, n_loc) L-vectors or (..., E, n_loc)
    stacks of them, each on its own.
    """

    def __init__(self, disc, pad_to: int | None = None):
        self.disc = disc
        self._tables(disc.gather_nodes, disc.n_nodes, disc.shape, pad_to)

    def _tables(self, gather_nodes, n_nodes: int, shape,
                pad_to: int | None) -> None:
        """The host tables from the (E, n_loc) lexicographic gather map."""
        gather_nodes = np.asarray(gather_nodes)
        E, n = gather_nodes.shape
        Ep = E if pad_to is None else int(pad_to)
        if Ep < E:
            raise ValueError(f"pad_to={Ep} < E={E}")
        self.E, self.E_real = Ep, E
        self.n_loc = n
        self.n_nodes = int(n_nodes)
        self.shape = tuple(shape)

        gather = np.zeros((Ep, n), dtype=np.int64)
        gather[:E] = gather_nodes
        #: (Ep, n_loc) global node ids, lexicographic local order (pad rows
        #: alias node 0; their values never enter reductions)
        self.gather_lex = gather

        gids = gather.reshape(-1).copy()
        if Ep > E:
            # fresh singleton ids for pad copies: they must never join a
            # real node's reduction or multiplicity
            gids[E * n:] = n_nodes + np.arange((Ep - E) * n)
        mult = np.bincount(gids)
        m_copy = mult[gids]

        two = np.nonzero(m_copy == 2)[0]
        order = np.argsort(gids[two], kind="stable")
        st = two[order].reshape(-1, 2)
        self._pair_idx = np.concatenate([st[:, 0], st[:, 1]])
        self._pair_partner = np.concatenate([st[:, 1], st[:, 0]])

        hi = np.nonzero(m_copy >= 3)[0]
        uniq, seg = np.unique(gids[hi], return_inverse=True)
        self._multi_idx = hi
        self._multi_seg = seg.astype(np.int64).reshape(-1)
        self._n_multi = int(uniq.size)

        w = (1.0 / m_copy).reshape(Ep, n)
        w[E:] = 0.0
        self._weights_np = w

    # -- conversions (host) ------------------------------------------------

    def local_from_global(self, u_global) -> np.ndarray:
        """(n_nodes[, k]) -> (E, n_loc[, k]) consistent L-vector."""
        return np.asarray(u_global)[self.gather_lex]

    def global_from_local(self, uL) -> np.ndarray:
        """Consistent (E, n_loc[, k]) L-vector -> global (n_nodes[, k])
        (pad rows are dropped)."""
        uL = np.asarray(uL)[:self.E_real]
        out = np.zeros((self.n_nodes,) + uL.shape[2:], dtype=uL.dtype)
        out[self.gather_lex[:self.E_real].reshape(-1)] = uL.reshape(
            (-1,) + uL.shape[2:])
        return out

    # -- the exchange --------------------------------------------------------

    _on = LocalExchange._on

    def dss(self, vL: torch.Tensor) -> torch.Tensor:
        """Direct stiffness summation on an (E, n_loc) L-vector or an
        (..., E, n_loc) stack: the partner gather for the pairs, the
        compact scatter-add for the rest."""
        dev = vL.device
        lead = vL.shape[:-2]
        flat = vL.reshape(*lead, self.E * self.n_loc)
        pi = self._on("_pair_idx", dev)
        mi, ms = self._on("_multi_idx", dev), self._on("_multi_seg", dev)
        out = flat.clone()
        out[..., pi] = flat[..., pi] + flat[..., self._on("_pair_partner",
                                                          dev)]
        seg = accumulate(self._n_multi, ms, flat[..., mi], dim=-1)
        out[..., mi] = seg[..., ms]
        return out.reshape(vL.shape)

    def dot(self, uL: torch.Tensor, vL: torch.Tensor) -> torch.Tensor:
        """Global inner product from consistent (E, n_loc) L-vectors (a
        stack sums over all of it)."""
        prod = uL * vL
        return torch.sum(prod * self._weights_as(prod.dtype, prod.device))

    def norm(self, uL: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(uL, uL))

    @property
    def weights(self) -> np.ndarray:
        """(E, n_loc) inverse-multiplicity dot weights (float64, host)."""
        return self._weights_np

    _weights_as = LocalExchange._weights_as


class BoxRollExchange3D(PairScatterExchange):
    """Tensor-product plane-roll DSS for structured box hex meshes.

    On a structured grid DSS factorizes axis by axis: exchanging the two
    full (m x m) face planes of axis a with the a-neighbours (one
    element-axis roll each way), then repeating for the other two axes,
    accumulates every shared-DOF sum (edge DOFs through two stages, vertex
    DOFs through three).  Six plane rolls replace the node-level gathers of
    :class:`PairScatterExchange`.

    Requires (validated in ``__init__`` from the mesh, raising
    ``NotImplementedError`` so :func:`make_exchange` falls back):

    * every face pair connects face ``2a+1`` (axis-a high) of element ``e``
      to face ``2a`` of element ``e + delta_a`` with one uniform positive
      ``delta_a`` per axis (lexicographic box element order);
    * identity node orientation across every pair.
    """

    def __init__(self, disc, pad_to: int | None = None):
        super().__init__(disc, pad_to=pad_to)
        mesh = disc.mesh
        if mesh.ndim != 3 or len(self.shape) != 3:
            raise NotImplementedError("BoxRollExchange3D is 3D-only")
        E = self.E_real
        pairs = np.asarray(mesh.face_pairs())
        g = self.gather_lex[:E].reshape((E,) + self.shape)

        self.deltas: list[int] = []
        mask_lo = np.zeros((3, self.E), bool)   # has a -a neighbour
        mask_hi = np.zeros((3, self.E), bool)   # has a +a neighbour
        covered = 0
        for a in range(3):
            lo_f, hi_f = 2 * a, 2 * a + 1
            sel = ((np.minimum(pairs[:, 1], pairs[:, 3]) == lo_f)
                   & (np.maximum(pairs[:, 1], pairs[:, 3]) == hi_f))
            sub = pairs[sel]
            covered += int(sel.sum())
            if sub.size == 0:
                raise NotImplementedError(f"axis {a} has no face pairs")
            hi_first = sub[:, 1] == hi_f
            e_hi = np.where(hi_first, sub[:, 0], sub[:, 2])
            e_lo = np.where(hi_first, sub[:, 2], sub[:, 0])
            deltas = e_lo - e_hi
            d = int(deltas[0])
            if d <= 0 or not np.all(deltas == d):
                raise NotImplementedError(
                    f"axis {a} face-pair offsets are not one uniform "
                    f"positive delta (use a lexicographic box order)")
            plane_hi = np.take(g[e_hi], -1, axis=1 + a)
            plane_lo = np.take(g[e_lo], 0, axis=1 + a)
            if not np.array_equal(plane_hi, plane_lo):
                raise NotImplementedError(
                    f"axis {a} face gluing is not identity-oriented")
            self.deltas.append(d)
            mask_hi[a, e_hi] = True
            mask_lo[a, e_lo] = True
        if covered != len(pairs):
            raise NotImplementedError(
                "mesh has face pairs outside the axis-aligned box pattern")
        self._mask_lo = mask_lo
        self._mask_hi = mask_hi

    @classmethod
    def from_tables(cls, gather_lex, n_nodes: int, shape, deltas, mask_lo,
                    mask_hi, E_real: int | None = None
                    ) -> "BoxRollExchange3D":
        """The exchange from its tables alone (another implementation's):
        the (E, n_loc) lexicographic gather map (pad rows past ``E_real``),
        the global node count, the (p0, p1, p2) node grid, the three
        plane-roll offsets and the (3, E) neighbour masks.  Nothing is
        validated against a mesh."""
        gather_lex = np.asarray(gather_lex)
        E = gather_lex.shape[0]
        Er = E if E_real is None else int(E_real)
        ex = cls.__new__(cls)
        ex.disc = None
        ex._tables(gather_lex[:Er], n_nodes, shape, E)
        ex.deltas = [int(d) for d in deltas]
        ex._mask_lo = np.array(mask_lo, bool).reshape(3, E)
        ex._mask_hi = np.array(mask_hi, bool).reshape(3, E)
        return ex

    def _planes(self, u: torch.Tensor, first: int, elem: int, mask_shape,
                roll=torch.roll) -> torch.Tensor:
        """The six plane exchanges on ``u`` in place: the three node axes
        start at dimension ``first``, the element axis of a plane is
        ``elem``; the (E,) masks are viewed as ``mask_shape``; ``roll(x,
        shift, dims)`` rolls a plane along its element axis (the sharded
        exchange passes its block roll)."""
        dev = u.device
        for a in range(3):
            d = self.deltas[a]
            ml = self._on("_mask_lo", dev)[a].reshape(mask_shape)
            mh = self._on("_mask_hi", dev)[a].reshape(mask_shape)
            lo = u.select(first + a, 0)
            hi = u.select(first + a, self.shape[a] - 1)
            recv_lo = torch.where(ml, roll(hi, d, dims=elem), 0.0)
            recv_hi = torch.where(mh, roll(lo, -d, dims=elem), 0.0)
            lo += recv_lo
            hi += recv_hi
        return u

    def dss(self, vL: torch.Tensor) -> torch.Tensor:
        """Plane-roll DSS on an (E, n_loc) L-vector or an (..., E, n_loc)
        stack."""
        L = vL.dim() - 2
        u = vL.reshape(*vL.shape[:-1], *self.shape).clone()
        return self._planes(u, L + 1, L, (-1, 1, 1)).reshape(vL.shape)

    def dss_T(self, vT: torch.Tensor) -> torch.Tensor:
        """Plane-roll DSS on a transposed (n_loc, E) L-vector (or a stack):
        the same six plane exchanges with the elements last."""
        L = vT.dim() - 2
        u = vT.reshape(*vT.shape[:-2], *self.shape, vT.shape[-1]).clone()
        return self._planes(u, L, -1, (-1,)).reshape(vT.shape)


def _make_exchange_impl(disc, threshold: float = 0.25,
                        pad_to: int | None = None,
                        min_class_fraction: float | None = None):
    """Best exchange structure for ``disc``: roll classes when they cover
    enough of the mesh, generic gather otherwise.  ``pad_to`` pads the
    element axis with inert elements (a shard-divisible count, for
    :mod:`..parallel`).

    The JAX factory's ``fused_pad`` (padding for the TPU kernels' lane
    tiling) is not ported: the CUDA kernels take any element count.
    """
    if len(disc.shape) != 2:
        # 3D (and any non-quad NCube): the plane-roll DSS on structured box
        # meshes, the multiplicity-split pair/scatter exchange otherwise
        # (the reference's selection rule on the mesh)
        try:
            return BoxRollExchange3D(disc, pad_to=pad_to)
        except NotImplementedError:
            return PairScatterExchange(disc, pad_to=pad_to)
    try:
        ex = RollExchange(disc, pad_to=pad_to,
                          min_class_fraction=min_class_fraction)
    except NotImplementedError:
        # anisotropic node grid with edge tails: the roll fast path
        # needs full class coverage there — generic exchange instead
        return LocalExchange(disc, pad_to=pad_to)
    if (min_class_fraction is None
            and (ex.n_edge_tail or ex.n_vert_tail)):
        # tails may be small *uniform* classes below the default size
        # threshold (panel-ordered meshes: one cross-panel-boundary class
        # per direction); zero tails unlock the CUDA kernels — worth a
        # bounded number of extra roll classes
        ex2 = RollExchange(disc, pad_to=pad_to, min_class_fraction=0.0)
        if (not (ex2.n_edge_tail or ex2.n_vert_tail)
                and len(ex2.edge_classes) + len(ex2.vert_classes) <= 64):
            ex = ex2
    if ex.tail_fraction > threshold:
        return LocalExchange(disc, pad_to=pad_to)
    return ex


def make_exchange(disc, **kw):
    """Stage-accounted wrapper of the exchange factory (see
    :func:`_make_exchange_impl` for the selection rules)."""
    from ..utils.stages import stage

    with stage("exchange/build"):
        return _make_exchange_impl(disc, **kw)
