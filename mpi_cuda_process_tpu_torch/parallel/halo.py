"""Width-k halo exchange between the blocks of a decomposed grid.

The counterpart of the TPU package's ``parallel/halo.py``.  A decomposed
field is the list of its local blocks in mesh row-major order (see
``stepper.ShardedField``); an exchange is a collective over that list.  The
ring shift at its core — ``lax.ppermute`` there — is
:meth:`InProcessTransport.shift_pair`: each shard's border slab is handed to
its ring neighbour on the neighbour's device (a view when both share a
device, so the only copy is the one into the padded block).  Shards at a
non-periodic global wall receive the stencil's guard-cell constant instead;
periodic rings wrap.

Corner and edge halos (the 27-point footprint) come from the two-pass
axis-wise scheme: axis ``d`` is exchanged after axes ``< d`` are padded, so
its border slabs carry the corner cells the earlier exchanges brought in,
and diagonal neighbours need no transfer of their own.

The padded block is built with ONE allocation per block and slice copies
into it (core, then each axis's two halo slabs), not a concatenation per
axis: the values are the same, and the block is written once.

The TPU package's ``exchange_pad_axis`` (one axis at a time, one
concatenation each) is ``exchange_and_pad(..., axes=(d,))`` here; the
sharded fused step pads z and y in one call, one allocation.

Not ported yet: the 2-axis slab set with corner pieces
(``exchange_slabs_2axis``, ROADMAP B4 row 9), the ``*_from_borders``
variants of the pipelined stepper (A5) and the remote-DMA transport (B7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import Mesh


def _take(x: torch.Tensor, axis: int, start: int, size: int) -> torch.Tensor:
    return x.narrow(axis, start, size)


def _axis_count(mesh: Mesh, axis: int) -> int:
    return mesh.shape[axis] if axis < len(mesh.shape) else 1


def _shifted(c: Tuple[int, ...], axis: int, shift: int, n: int):
    if axis >= len(c):
        return c
    c = list(c)
    c[axis] = (c[axis] + shift) % n
    return tuple(c)


def _at(c: Tuple[int, ...], axis: int) -> int:
    return c[axis] if axis < len(c) else 0


class InProcessTransport:
    """Ring shifts between blocks that one process holds.

    The stand-in for ``lax.ppermute`` when every shard's block lives in this
    process (one card or several cards of one node).  A multi-process
    transport over NCCL is ROADMAP A4.
    """

    def shift_pair(self, hi_slabs: Sequence[torch.Tensor],
                   lo_slabs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
                   periodic: bool):
        """Ring shift of a slab pair along grid ``axis``.

        Returns ``(from_left, from_right)``: for each shard, the previous
        shard's ``hi`` slab and the next shard's ``lo`` slab, on this
        shard's device.  With ``periodic`` False the ring is cut at the
        walls and the wall shards get None (the caller substitutes the
        guard-cell constant).
        """
        n = _axis_count(mesh, axis)
        from_left: List[Optional[torch.Tensor]] = []
        from_right: List[Optional[torch.Tensor]] = []
        for c in mesh.coords():
            dev = mesh.device(c)
            i = _at(c, axis)
            if periodic or i > 0:
                src = hi_slabs[mesh.index(_shifted(c, axis, -1, n))]
                from_left.append(src.to(dev, non_blocking=True))
            else:
                from_left.append(None)
            if periodic or i < n - 1:
                src = lo_slabs[mesh.index(_shifted(c, axis, 1, n))]
                from_right.append(src.to(dev, non_blocking=True))
            else:
                from_right.append(None)
        return from_left, from_right


_TRANSPORT = InProcessTransport()


def exchange_slabs_axis(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    axis: int,
    halo: int,
    bc_value,
    periodic: bool = False,
):
    """The two halo slabs of every shard along ``axis``, unconcatenated:
    ``(lefts, rights)``, one entry per shard in row-major order.

    ``lefts[i]`` belongs just before shard i's rows (the lower neighbour's
    last ``halo`` rows), ``rights[i]`` just after.  Interior faces receive
    the neighbour's border slab; global walls receive ``bc_value`` (or the
    wrap when ``periodic``).  The pad-free sharded kernel takes these slabs
    as operands, so no padded copy of the block is ever made.
    """
    L = blocks[0].shape[axis]
    hi = [_take(x, axis, L - halo, halo) for x in blocks]
    lo = [_take(x, axis, 0, halo) for x in blocks]
    lefts, rights = _TRANSPORT.shift_pair(hi, lo, mesh, axis, periodic)
    for i, x in enumerate(blocks):
        if lefts[i] is None or rights[i] is None:
            shape = list(x.shape)
            shape[axis] = halo
            wall = torch.full(shape, bc_value, dtype=x.dtype, device=x.device)
            lefts[i] = wall if lefts[i] is None else lefts[i]
            rights[i] = wall if rights[i] is None else rights[i]
    return lefts, rights


def exchange_and_pad(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    axes: Optional[Sequence[int]] = None,
) -> List[torch.Tensor]:
    """Halo-pad every block along ``axes`` (default: all), two-pass.

    Each padded block is one allocation: the core is copied in, then for
    each axis in order the two halo slabs, read from the neighbours' padded
    blocks over the extent already padded along earlier axes (so corners
    arrive by face exchanges alone).  A mesh axis of one shard degrades to
    a local wrap (periodic) or guard-cell fill.  ``halo == 0`` (a field
    whose neighbours are never read, wave's ``u_prev``) returns the blocks
    unchanged.
    """
    if halo == 0:
        return list(blocks)
    ndim = blocks[0].dim()
    axes = tuple(range(ndim)) if axes is None else tuple(sorted(axes))
    L = tuple(blocks[0].shape)
    core = tuple(slice(halo, halo + L[e]) if e in axes else slice(None)
                 for e in range(ndim))
    pshape = [L[e] + 2 * halo if e in axes else L[e] for e in range(ndim)]
    padded = []
    for x in blocks:
        p = torch.empty(pshape, dtype=x.dtype, device=x.device)
        p[core].copy_(x)
        padded.append(p)
    for d in axes:
        # axes padded before d span their full padded extent: the two-pass
        # scheme that carries corner cells
        idx = [slice(None) if e < d else core[e] for e in range(ndim)]
        views = [p[tuple(idx)] for p in padded]
        hi = [_take(v, d, L[d] - halo, halo) for v in views]
        lo = [_take(v, d, 0, halo) for v in views]
        lefts, rights = _TRANSPORT.shift_pair(hi, lo, mesh, d, periodic)
        for p, left, right in zip(padded, lefts, rights):
            for src, sl in ((left, slice(0, halo)),
                            (right, slice(halo + L[d], None))):
                idx[d] = sl
                dst = p[tuple(idx)]
                if src is None:
                    dst.fill_(bc_value)
                else:
                    dst.copy_(src)
    return padded


def pad_local(block: torch.Tensor, halo: int, bc_value,
              periodic: bool = False,
              axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One block padded along ``axes`` (default: all) as if it were the
    whole grid (local wrap or guard-cell fill, no exchange): what a
    one-shard mesh would give."""
    return exchange_and_pad([block], Mesh((), [block.device]), halo,
                            bc_value, periodic, axes=axes)[0]
