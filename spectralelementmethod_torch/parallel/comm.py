"""The communication behind an element-shard mesh (PyTorch port).

A mesh of ``size`` element shards is one of two kinds, and every sharded
function of :mod:`.halo` and :mod:`.sharding` is written once, against the
helpers here:

* **simulated** (``mesh.group`` is None): one process holds all the shards
  as the contiguous blocks of one tensor on one device, and a transfer
  between shards is a copy of a view;
* **distributed** (``mesh.group`` a ``torch.distributed`` process group):
  one shard per rank, on the rank's own device; a sharded function takes
  and returns the rank's own block, a transfer is a message
  (``batch_isend_irecv``, one packed buffer per peer and direction), and a
  reduction is the rank partials from ``all_gather`` summed in rank order,
  so every rank holds the same bits.

The reference's counterparts are ``jax.lax.ppermute`` and ``psum`` inside
``jax.shard_map``.  NCCL moves CUDA tensors and gloo CPU tensors; there is
no switch from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Shards(NamedTuple):
    """A simulated mesh given by its shard count alone (the halo functions
    also take a plain ``int``)."""

    size: int
    rank: int | None = None
    group: object | None = None


def as_mesh(mesh_or_size):
    """A mesh from a mesh or a shard count (a simulated :class:`Shards`)."""
    if hasattr(mesh_or_size, "size") and hasattr(mesh_or_size, "group"):
        return mesh_or_size
    return Shards(int(mesh_or_size))


def distributed(mesh) -> bool:
    """True when the mesh's shards are the ranks of a process group."""
    return getattr(mesh, "group", None) is not None


def owned(mesh) -> list[int]:
    """The shards this process holds: all of them on a simulated mesh,
    its rank on a distributed one."""
    return [int(mesh.rank)] if distributed(mesh) else list(range(mesh.size))


def block_size(mesh, E: int) -> int:
    """The per-shard block of a global axis of ``E`` (which must divide)."""
    S = int(mesh.size)
    if E % S:
        raise ValueError(f"E={E} not divisible by {S} shards; pad the "
                         "exchange (pad_to)")
    return E // S


def split(mesh, x: torch.Tensor, dim: int = -1) -> list[torch.Tensor]:
    """The blocks of ``x`` this process holds, as views: the ``size``
    blocks of the whole tensor (simulated), or ``[x]``, the rank's own
    block (distributed)."""
    if distributed(mesh):
        return [x]
    return list(x.split(block_size(mesh, x.shape[dim]), dim))


def join(mesh, blocks, dim: int = -1) -> torch.Tensor:
    """The inverse of :func:`split`."""
    if distributed(mesh) or len(blocks) == 1:
        return blocks[0]
    return torch.cat(list(blocks), dim)


def block_of(mesh, x, dim: int = -1):
    """The rank's block of a whole array or tensor along ``dim`` (the
    whole of it on a simulated mesh)."""
    if not distributed(mesh):
        return x
    Eb = block_size(mesh, x.shape[dim])
    r = int(mesh.rank)
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, r * Eb, Eb)
    index = [slice(None)] * x.ndim
    index[dim] = slice(r * Eb, (r + 1) * Eb)
    return x[tuple(index)]


def _p2p(mesh, sends: dict, recvs: dict, dtype, device) -> dict:
    """One packed message to each peer of ``sends`` (a list of tensors
    each) and one from each peer of ``recvs`` (a list of shapes each), all
    in one ``batch_isend_irecv``; returns each receiving peer's tensors in
    the order of its shapes."""
    import torch.distributed as dist

    ops, inbox = [], {}
    for peer in sorted(sends):
        buf = torch.cat([t.reshape(-1) for t in sends[peer]])
        ops.append(dist.P2POp(dist.isend, buf, peer, mesh.group))
    for peer in sorted(recvs):
        shapes = recvs[peer]
        sizes = [int(torch.Size(s).numel()) for s in shapes]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
        inbox[peer] = (buf, sizes, shapes)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = {}
    for peer, (buf, sizes, shapes) in inbox.items():
        out[peer] = [p.reshape(s) for p, s
                     in zip(buf.split(sizes), shapes)]
    return out


def fetch(mesh, blocks, need, dim: int = -1) -> list[torch.Tensor]:
    """For each block this process holds (shard ``i``), the concatenation
    along ``dim`` of the pieces ``need(i)`` lists: ``(j, a, b)`` is the
    range ``[a, b)`` of shard ``j``'s block, ``(None, a, b)`` is ``b - a``
    zeros.  Every shard's block has the same shape.

    Simulated, a piece is a view of ``blocks[j]``.  Distributed, each rank
    works out from ``need`` what every other rank wants of its block, and
    the pieces travel packed, one message per peer and direction."""
    mine = owned(mesh)
    ref = blocks[0]
    d = dim % ref.dim()

    def zeros(w):
        shape = list(ref.shape)
        shape[d] = w
        return torch.zeros(shape, dtype=ref.dtype, device=ref.device)

    def cat(parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts, d)

    if not distributed(mesh):
        return [cat([zeros(b - a) if j is None
                     else blocks[j].narrow(d, a, b - a)
                     for j, a, b in need(i)]) for i in mine]
    r = mine[0]
    x = ref
    sends: dict[int, list] = {}
    for i in range(mesh.size):
        if i != r:
            for j, a, b in need(i):
                if j == r:
                    sends.setdefault(i, []).append(x.narrow(d, a, b - a))
    recvs: dict[int, list] = {}
    for j, a, b in need(r):
        if j is not None and j != r:
            shape = list(x.shape)
            shape[d] = b - a
            recvs.setdefault(j, []).append(shape)
    got = _p2p(mesh, sends, recvs, x.dtype, x.device)
    parts = []
    for j, a, b in need(r):
        if j is None:
            parts.append(zeros(b - a))
        elif j == r:
            parts.append(x.narrow(d, a, b - a))
        else:
            parts.append(got[j].pop(0))
    return [cat(parts)]


def ring_extend(mesh, blocks, left: int, right: int, wrap_left: bool = True,
                wrap_right: bool = True, dim: int = -1) -> list[torch.Tensor]:
    """Each held block with its ring neighbours' strips: the last ``left``
    of shard i - 1 before it, the first ``right`` of shard i + 1 after it
    (one packed message per neighbour).  ``wrap_left=False`` gives shard 0
    zeros in place of shard S - 1's strip, ``wrap_right=False`` shard S - 1
    zeros in place of shard 0's: the ring's wrap-around pair is not sent."""
    S = int(mesh.size)
    Eb = blocks[0].shape[dim]
    if max(left, right) > Eb:
        raise ValueError(f"halo {max(left, right)} exceeds the per-shard "
                         f"block ({Eb}); use fewer shards or a "
                         "locality-preserving element order")

    def need(i):
        parts = []
        if left:
            parts.append(((i - 1) % S, Eb - left, Eb)
                         if i > 0 or wrap_left else (None, 0, left))
        parts.append((i, 0, Eb))
        if right:
            parts.append(((i + 1) % S, 0, right)
                         if i < S - 1 or wrap_right else (None, 0, right))
        return parts

    return fetch(mesh, blocks, need, dim)


def rank_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t``: the partials from ``all_gather``,
    added in rank order, so every rank holds the same bits.  ``t`` itself
    on a simulated mesh (whose callers sum their shards' partials)."""
    if not distributed(mesh):
        return t
    import torch.distributed as dist

    flat = t.reshape(-1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(parts, flat, group=mesh.group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total.reshape(t.shape)


def rank_sums(mesh, *ts: torch.Tensor) -> tuple:
    """:func:`rank_sum` of several same-dtype scalars in one ``all_gather``."""
    if not distributed(mesh):
        return ts
    out = rank_sum(mesh, torch.stack([t.reshape(()) for t in ts]))
    return tuple(out.unbind(0))


def tag(t: torch.Tensor, mesh) -> torch.Tensor:
    """Mark ``t`` as a rank's block of a sharded array on ``mesh`` (the dot
    weights a :class:`.sharding.RankExchange` hands out): a solver given
    it sums its weighted partials over the ranks."""
    t._rank_mesh = mesh
    return t


def mesh_of(t):
    """The process-group mesh ``t`` was tagged with (:func:`tag`), or
    None."""
    mesh = getattr(t, "_rank_mesh", None)
    return mesh if distributed(mesh) else None


def gather_blocks(mesh, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` in rank order (the
    whole array, on every rank); ``x`` itself on a simulated mesh."""
    if not distributed(mesh):
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)
