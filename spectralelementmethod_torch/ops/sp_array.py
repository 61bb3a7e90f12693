"""Kronecker-structured sparse tensors (einsum-subscript formulation).

A numpy copy of the JAX package's ``ops/sp_array.py`` (host-side; no
device code).

Role parity: the reference's ``sem/sp_array.py`` ``KroneckerArray`` — N-D
sparse tensors that are sums of dense factors with Kronecker deltas tying
groups of axes together, used there to hold the squirmer's rank-6
advection operator without materializing it
(``examples/squirmer-axisymmetric.py:230-250``).

In both packages this structure is *not* on any hot path — the
squirmer's advection is matrix-free (``models/squirmer.py``).  It exists
for API completeness and for users porting reference code.

Formulation here: every term is a dense factor together with one *label*
per tensor axis; axes sharing a label are tied by a Kronecker delta and
read the same factor axis.  Operations are phrased as einsum subscript
strings built from those labels (contraction) and as a strided flat
scatter (densification) — no per-axis index bookkeeping.
"""

from __future__ import annotations

import string

import numpy as np

_LETTERS = string.ascii_lowercase


class KroneckerArray:
    """Sparse N-D tensor: a sum of delta-tied dense factors.

    ``KroneckerArray(shape, factor0, labels0, factor1, labels1, ...)``

    ``labels`` assigns each tensor axis the factor axis it reads (an int
    index into the factor's axes); assigning the same factor axis to
    several tensor axes encodes a Kronecker delta between them.
    """

    def __init__(self, shape, *terms, dtype=np.float64):
        self.dtype = dtype
        self.shape = tuple(int(s) for s in shape)
        self._terms: list[tuple[np.ndarray, tuple[int, ...]]] = []
        it = iter(terms)
        for factor, labels in zip(it, it):
            self.add_diag(factor, labels)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # kept under the reference's method names for porting convenience
    def add_diag(self, factor, labels) -> None:
        """Append a term: dense ``factor`` + per-axis factor-axis labels."""
        factor = np.asarray(factor, dtype=self.dtype)
        labels = tuple(int(l) for l in labels)
        assert len(labels) == self.ndim, (
            f"need one label per tensor axis ({self.ndim}), got {len(labels)}")
        assert set(labels) == set(range(factor.ndim)), (
            "labels must cover every factor axis exactly")
        mismatched = [ax for ax, l in enumerate(labels)
                      if self.shape[ax] != factor.shape[l]]
        assert not mismatched, (
            f"tensor axes {mismatched} disagree with factor extents")
        self._terms.append((factor, labels))

    def dot_dense(self, dense, axes) -> "KroneckerArray":
        """Contract ``dense`` against the given tensor axes.

        Term-by-term einsum: the factor keeps its letters, ``dense`` gets
        the letters of the contracted axes, and the output keeps the
        surviving letters (deltas between two contracted axes reduce to a
        plain elementwise product inside the einsum; deltas between a kept
        and a contracted axis survive as a kept label).  Result is a new
        ``KroneckerArray`` over the remaining axes.
        """
        dense = np.asarray(dense)
        axes = [int(a) for a in axes]
        assert dense.ndim == len(axes)
        kept = [ax for ax in range(self.ndim) if ax not in axes]
        out = KroneckerArray([self.shape[ax] for ax in kept],
                             dtype=self.dtype)

        for factor, labels in self._terms:
            f_sub = _LETTERS[:factor.ndim]
            d_sub = "".join(f_sub[labels[ax]] for ax in axes)
            # surviving letters, numbered by first appearance along the
            # kept tensor axes → the new factor's axis order
            kept_letters = []
            for ax in kept:
                c = f_sub[labels[ax]]
                if c not in kept_letters:
                    kept_letters.append(c)
            o_sub = "".join(kept_letters)
            new_factor = np.einsum(f"{f_sub},{d_sub}->{o_sub}",
                                   factor, dense)
            new_labels = [kept_letters.index(f_sub[labels[ax]])
                          for ax in kept]
            out.add_diag(new_factor, new_labels)
        return out

    def to_array(self) -> np.ndarray:
        """Densify by flat scatter-add.

        Each factor entry lands at the output position whose per-axis
        index is the factor index of that axis's label; the destination is
        computed as a single strided flat offset and accumulated with
        ``np.add.at`` (duplicate offsets never occur — every factor axis
        appears in at least one tensor axis, so the map is injective).
        """
        out = np.zeros(self.shape, dtype=self.dtype)
        strides = np.cumprod((1,) + self.shape[:0:-1])[::-1]  # row-major
        flat = out.reshape(-1)
        for factor, labels in self._terms:
            grids = np.indices(factor.shape)
            offset = sum(int(strides[ax]) * grids[l]
                         for ax, l in enumerate(labels))
            np.add.at(flat, offset.reshape(-1), factor.reshape(-1))
        return out
