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

The pad-free kinds take slabs instead of padded blocks:
``exchange_slabs_axis`` (one axis) and ``exchange_slabs_2axis`` (z and y
plus the four corner pieces, by the same two-pass composition).  Slabs are
packed (contiguous) buffers, as the kernels take them.
``pad_from_slabs`` rebuilds any band of the padded block from a slab set,
which is how the overlapped steps make their boundary-shell strips.

Every exchange runs over the shards this process holds
(``Mesh.local_coords``) through the mesh's own transport
(:func:`default_transport`): :class:`InProcessTransport` for a mesh of one
process, :class:`DistributedTransport` for a mesh that spans processes, in
which a neighbour in this process is handed over as in process and one in
another process goes through ``torch.distributed`` point to point, one
``batch_isend_irecv`` per shift.  The slab exchanges also take
:class:`RdmaTransport`, the ring-exchange kernels (``ops/cuda/remote.py``,
the counterpart of the TPU package's in-kernel remote DMA): one launch for
every ring of shards that shares a device, or across processes a send and
a drain through receive slots the peers map.  An axis of one shard keeps
its local fill or wrap and runs no ring; the wall shards' received slabs
are overwritten with the guard constant after a full-ring shift, so every
transport gives the same slabs bit for bit; corners keep the two-pass
composition, across processes too (the second pass reads the first pass's
received slabs).

A shift is posted, then awaited (``post(...).wait()``), and an exchange is
its rounds of shifts: :func:`post_and_pad`, :func:`post_slabs_axis` and
:func:`post_slabs_2axis` post the first round and return an
:class:`Exchange` whose ``wait()`` runs the rest.  The overlapped steps
launch their interior between the two, so a process that waits for its
peers in a blocking receive does so while the card computes the interior
— the reference's pattern (kernel.cu: the middle kernel launched, then
``MPI_Send``/``MPI_Recv``, then the boundary).

The pipelined stepper posts each exchange from border rows it already
holds (:func:`post_slabs_from_borders`,
:func:`post_slabs_2axis_from_borders`): the same shifts, the sender's
rows given directly.

Across processes :class:`RdmaTransport` runs the ring's peer form
(``ring_send`` / ``ring_drain`` into CUDA IPC-mapped receive slots) on one
node; a ring between nodes, or across the cards of one process, is not
ported (B7).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import launchcheck
from .mesh import Mesh, dist_timeout_s


def _take(x: torch.Tensor, axis: int, start: int, size: int) -> torch.Tensor:
    return x.narrow(axis, start, size)


def _axis_count(mesh: Mesh, axis: int) -> int:
    return mesh.shape[axis] if axis < len(mesh.shape) else 1


def _shifted(mesh: Mesh, c: Tuple[int, ...], axis: int, shift: int):
    """Shard ``c``'s neighbour ``shift`` along grid ``axis``, in its own
    ensemble group (the group's coordinate leads, ``Mesh.group_axes``)."""
    if axis >= len(mesh.shape):
        return tuple(c)
    a = axis + mesh.group_axes
    c = list(c)
    c[a] = (c[a] + shift) % mesh.shape[axis]
    return tuple(c)


def _at(mesh: Mesh, c: Tuple[int, ...], axis: int) -> int:
    return c[axis + mesh.group_axes] if axis < len(mesh.shape) else 0


def _flat3(t: torch.Tensor) -> torch.Tensor:
    """A batched slab ``(N, h, Y, X)`` as the 3D ``(N h, Y, X)`` view the
    ring kernel takes (a 3D slab unchanged)."""
    return t if t.dim() <= 3 else t.reshape(-1, *t.shape[-2:])


def _slab_bytes(*slab_lists) -> int:
    return sum(t.numel() * t.element_size() for slabs in slab_lists
               for t in slabs)


class _Done:
    """A shift whose slabs are in hand at once (an in-process one).
    ``posted`` is its post's launch record (``utils/launchcheck.py``), or
    None outside a recording."""

    def __init__(self, pair, posted=None):
        self._pair = pair
        self._posted = posted

    def wait(self):
        if self._posted is not None:
            launchcheck.note_wait(self._posted, self._pair)
        return self._pair


class InProcessTransport:
    """Ring shifts between blocks that one process holds.

    The stand-in for ``lax.ppermute`` when every shard's block lives in this
    process (one card or several cards of one node).
    """

    backend = "in-process"

    def __init__(self):
        # posted shifts (one per axis and exchange round, whatever the
        # slabs' member count) and the slab bytes they hand between shards:
        # every local shard's hi and lo slab (a ppermute pair's operands,
        # walls included) along an axis of more than one shard; an axis of
        # one shard is a local fill or wrap and hands over none
        self.stats = {"shifts": 0, "bytes": 0}

    def post(self, hi_slabs: Sequence[torch.Tensor],
             lo_slabs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
             periodic: bool):
        n = _axis_count(mesh, axis)
        self.stats["shifts"] += 1
        if n > 1:
            self.stats["bytes"] += _slab_bytes(hi_slabs, lo_slabs)
        posted = launchcheck.note_post("in-process", hi_slabs, lo_slabs,
                                       mesh, axis, n)
        return _Done(self.shift_pair(hi_slabs, lo_slabs, mesh, axis,
                                     periodic), posted)

    def shift_pair(self, hi_slabs: Sequence[torch.Tensor],
                   lo_slabs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
                   periodic: bool):
        """Ring shift of a slab pair along grid ``axis``.

        ``hi_slabs``/``lo_slabs`` hold one slab per local shard, in
        ``mesh.local_coords()`` order, and every neighbour is local (one
        process, or an axis of one shard).  Returns ``(from_left,
        from_right)``: for each shard, the previous shard's ``hi`` slab
        and the next shard's ``lo`` slab, on this shard's device.  With
        ``periodic`` False the ring is cut at the walls and the wall shards
        get None (the caller substitutes the guard-cell constant).
        """
        n = _axis_count(mesh, axis)
        from_left: List[Optional[torch.Tensor]] = []
        from_right: List[Optional[torch.Tensor]] = []
        for c in mesh.local_coords():
            dev = mesh.device(c)
            i = _at(mesh, c, axis)
            if periodic or i > 0:
                src = hi_slabs[mesh.local_index(_shifted(mesh, c, axis, -1))]
                from_left.append(src.to(dev, non_blocking=True))
            else:
                from_left.append(None)
            if periodic or i < n - 1:
                src = lo_slabs[mesh.local_index(_shifted(mesh, c, axis, 1))]
                from_right.append(src.to(dev, non_blocking=True))
            else:
                from_right.append(None)
        return from_left, from_right

    def permute_groups(self, slabs: Sequence[torch.Tensor], mesh: Mesh,
                       perm: Sequence[Tuple[int, int]], attrs=None):
        """One move between the ensemble groups of ``mesh`` (the member
        repack's round, ``parallel/reshard.py``): for each pair ``(i, j)``
        of ``perm``, the slab of every shard of group i goes to the shard
        of group j at the same spatial coordinate, on that shard's device.
        ``slabs`` holds one slab per local shard in ``mesh.local_coords()``
        order; returns the received slab of each (None where no group
        sends to it).  Every shard's block is held in this process."""
        src_of = {j: i for i, j in perm}
        coords = mesh.local_coords()
        got: List[Optional[torch.Tensor]] = []
        for c in coords:
            i = src_of.get(mesh.group(c))
            if i is None:
                got.append(None)
                continue
            src = slabs[mesh.local_index((i,) + mesh.spatial(c))]
            got.append(src.to(mesh.device(c), non_blocking=True))
        self.stats["shifts"] += 1
        self.stats["bytes"] += sum(
            s.numel() * s.element_size() for c, s in zip(coords, slabs)
            if mesh.group(c) in {i for i, j in perm if i != j})
        launchcheck.note("member_post", reads=list(slabs),
                         writes=[g for g in got if g is not None],
                         shards=mesh.ensemble, transport=self.backend,
                         mesh=id(mesh), mesh_shape=tuple(mesh.full_shape),
                         attrs=dict(attrs or {}))
        return got


_TRANSPORT = InProcessTransport()


class DistributedTransport:
    """Ring shifts over a mesh that spans processes (``torch.distributed``
    point to point), the multi-process counterpart of ``lax.ppermute``.

    A shift's transfers are listed in one global order, the same in every
    process (global row-major shards; for each, its ``hi`` slab to the
    next shard, then its ``lo`` slab to the previous one).  A transfer
    between two shards of this process is handed over as in process; the
    others are posted in that order as one ``dist.batch_isend_irecv``, each
    tagged with its place (NCCL matches by order, gloo by tag: the order
    makes both agree, also where both neighbours are one peer, as on a
    periodic axis of two processes).  ``backend`` (``Mesh.backend``):

    * ``nccl``: device tensors sent and received as they are;
    * ``gloo``: CPU tensors;
    * ``gloo-host``: processes that share a card; the slabs go through
      pinned host buffers — copied off the card and waited for before the
      sends are posted, copied back onto the card (on the current stream,
      so the kernel that reads a slab follows the copy) once the receives
      complete.

    :meth:`post` returns a pending shift whose ``wait()`` gives ``(from_left,
    from_right)`` as :meth:`InProcessTransport.shift_pair` does.  ``stats``
    counts posted shifts, the bytes sent and the host seconds spent moving
    them (for ``gloo``/``gloo-host``: posting, waiting and the staging
    copies, not the wait for earlier device work; for ``nccl`` the host
    time of posting only, the transfer runs on the card).
    """

    def __init__(self, backend: str):
        self.backend = backend
        self._posts = 0
        self.stats = {"shifts": 0, "bytes": 0, "seconds": 0.0}

    def reset_stats(self) -> None:
        self.stats = {"shifts": 0, "bytes": 0, "seconds": 0.0}

    def post(self, hi_slabs: Sequence[torch.Tensor],
             lo_slabs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
             periodic: bool):
        """Post the shift: local hand-overs done, remote sends and
        receives in flight."""
        import torch.distributed as dist

        n = _axis_count(mesh, axis)
        posted = launchcheck.note_post("distributed", hi_slabs, lo_slabs,
                                       mesh, axis, n)
        local = mesh.local_coords()
        from_left: List[Optional[torch.Tensor]] = [None] * len(local)
        from_right: List[Optional[torch.Tensor]] = [None] * len(local)
        sends, recvs = [], []  # (tag, peer, slab) / (tag, peer, shard, side)
        # tags of successive shifts differ, so two shifts in flight at
        # once (the first round of a 2-axis exchange) never cross
        base = (self._posts % 4096) << 12
        self._posts += 1
        tag = base
        for c in mesh.coords():
            i = _at(mesh, c, axis)
            for slabs, shift, exists in ((hi_slabs, 1, periodic or i < n - 1),
                                         (lo_slabs, -1, periodic or i > 0)):
                if exists:
                    dst = _shifted(mesh, c, axis, shift)
                    side = from_left if shift == 1 else from_right
                    if mesh.is_local(c) and mesh.is_local(dst):
                        j = mesh.local_index(dst)
                        side[j] = slabs[mesh.local_index(c)].to(
                            mesh.device(dst), non_blocking=True)
                    elif mesh.is_local(c):
                        sends.append((tag, mesh.rank_of(dst),
                                      slabs[mesh.local_index(c)]))
                    elif mesh.is_local(dst):
                        recvs.append((tag, mesh.rank_of(c),
                                      mesh.local_index(dst), side))
                tag += 1
        if not sends and not recvs:
            return _Done((from_left, from_right), posted)
        like = hi_slabs[0]
        dev = mesh.devices[0]
        host = self.backend == "gloo-host"
        if host:
            # the slabs' producers finish first, outside the clock
            torch.cuda.current_stream(dev).synchronize()
        t0 = time.perf_counter()
        if host:
            out = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
                   .copy_(s, non_blocking=True) for _, _, s in sends]
            torch.cuda.current_stream(dev).synchronize()
        else:
            out = [s.contiguous() for _, _, s in sends]
        bufs = [torch.empty(like.shape, dtype=like.dtype,
                            device="cpu" if host else like.device,
                            pin_memory=host)
                for _ in recvs]
        ops = [dist.P2POp(dist.isend, t, peer, tag=tg)
               for (tg, peer, _), t in zip(sends, out)]
        ops += [dist.P2POp(dist.irecv, b, peer, tag=tg)
                for (tg, peer, _, _), b in zip(recvs, bufs)]
        works = dist.batch_isend_irecv(ops)
        self.stats["shifts"] += 1
        self.stats["bytes"] += sum(t.numel() * t.element_size() for t in out)
        self.stats["seconds"] += time.perf_counter() - t0
        return _Posted(self, works, out, bufs, recvs, from_left, from_right,
                       mesh, posted)


class _Posted:
    """A shift in flight over :class:`DistributedTransport`."""

    def __init__(self, transport, works, out, bufs, recvs, from_left,
                 from_right, mesh, posted=None):
        # ``out``: the sent tensors, held until the sends complete
        self._t, self._works, self._out = transport, works, out
        self._bufs, self._recvs = bufs, recvs
        self._pair, self._mesh = (from_left, from_right), mesh
        self._posted = posted

    def wait(self):
        t0 = time.perf_counter()
        for w in self._works:
            w.wait()
        host = self._t.backend == "gloo-host"
        for buf, (_, _, j, side) in zip(self._bufs, self._recvs):
            dev = self._mesh.devices[j]
            side[j] = buf.to(dev, non_blocking=True) if host else buf
        if host:
            # the pinned buffers are the caching host allocator's: the
            # copies complete before the shift counts as done
            torch.cuda.current_stream(self._mesh.devices[0]).synchronize()
        self._t.stats["seconds"] += time.perf_counter() - t0
        self._works = self._out = self._bufs = ()
        if self._posted is not None:
            launchcheck.note_wait(self._posted, self._pair)
        return self._pair


def default_transport(mesh: Mesh):
    """The transport of ``mesh``'s shifts: in process for one process,
    else the process's :class:`DistributedTransport` of the mesh's
    backend (one per backend, so its ``stats`` cover every exchange)."""
    if not mesh.multiprocess:
        return _TRANSPORT
    if mesh.backend not in _DISTRIBUTED:
        _DISTRIBUTED[mesh.backend] = DistributedTransport(mesh.backend)
    return _DISTRIBUTED[mesh.backend]


_DISTRIBUTED: Dict[str, DistributedTransport] = {}

RDMA_ITEM = "ROADMAP B7 (peer writes across cards)"
# What B7 still leaves out: CUDA IPC and shared memory are per node.
RDMA_NODES_ITEM = "ROADMAP B7's inter-node part (a ring between nodes)"


class RdmaTransport:
    """Ring shifts through the ring-exchange kernels (``exchange="rdma"``).

    The counterpart of the TPU package's ``RdmaTransport``.  On a mesh of
    one process every shift of a slab pair along a mesh axis is one
    ``ops/cuda/remote.py`` ``ring_exchange`` launch per device, covering
    every ring of that axis on the device: each chunk lands in place in
    the neighbour's received slab.  Each exchange site (axis, slab shape,
    dtype, device, shard count) keeps its ready counters.

    On a mesh that spans processes (one node) every shift is a
    :class:`~..ops.cuda.remote.PeerSite`'s post and drain: :meth:`post`
    launches ``ring_send`` (one launch for the process's shards, whichever
    of their neighbours live here or in a peer), the pending shift's
    ``wait()`` launches ``ring_drain`` on the then-current stream, so an
    overlapped step's interior runs between the two.  Sites are built
    collectively (:meth:`prepare`, at the step's construction, in the
    same order in every process; a site first met in a post is built
    there, by every process alike).  ``stats`` counts posted shifts, the
    bytes sent to other processes and the host seconds inside the
    transport, as :class:`DistributedTransport`'s do; :meth:`check`
    raises a recorded timeout and :meth:`check_drained` (collective) holds
    every site's flags at its last epoch.

    ``sites`` holds the meta of every site built, in build order.
    ``nslots`` (the TPU ring's depth: the chunk ladder, and across
    processes the receive slots) and ``prefer_nc`` (a preferred chunk
    count) are the kernels' variant knobs; 0 takes their defaults.

    ``backend`` says what carries the exchange: ``"cuda-ring"`` /
    ``"cuda-peer-ring"`` when the mesh lives on cards (the kernels run),
    ``"plain-ring"`` / ``"plain-peer-ring"`` on the CPU (their plain
    versions): a CPU run never reads as a measured ring.  A ring whose
    shards span several devices of one process raises (ROADMAP B7).
    """

    def __init__(self, mesh: Mesh, nslots: int = 0, prefer_nc: int = 0):
        cuda = all(d.type == "cuda" for d in mesh.devices)
        self.multiprocess = mesh.multiprocess
        kind = "peer-ring" if mesh.multiprocess else "ring"
        self.backend = ("cuda-" if cuda else "plain-") + kind
        self.nslots = int(nslots)
        self.prefer_nc = int(prefer_nc)
        self.sites: List[dict] = []
        self._calls: Dict[tuple, object] = {}
        self._peers: Dict[tuple, object] = {}
        self.stats = {"shifts": 0, "bytes": 0, "seconds": 0.0}
        if mesh.multiprocess:
            _PEER_TRANSPORTS.append(self)

    def _call(self, axis: int, slab: torch.Tensor, n_shards: int):
        from ..ops.cuda.remote import build_ring_exchange_call

        key = (axis, tuple(slab.shape), slab.dtype, slab.device, n_shards)
        if key not in self._calls:
            call, meta = build_ring_exchange_call(
                slab.shape, slab.dtype, nslots=self.nslots,
                prefer_nc=self.prefer_nc, device=slab.device)
            self.sites.append(dict(meta, axis=axis, shards=n_shards,
                                   device=str(slab.device)))
            self._calls[key] = call
        return self._calls[key]

    def prepare(self, mesh: Mesh, sites, dtype) -> None:
        """Build the peer sites ``sites`` (``(axis, slab shape)`` pairs)
        for ``dtype`` slabs now, collectively, before the time loop (a
        mesh of one process builds nothing here)."""
        if mesh.multiprocess:
            for axis, shape in sites:
                self._peer(mesh, axis, tuple(shape), dtype)

    def _peer(self, mesh: Mesh, axis: int, shape, dtype):
        from ..ops.cuda.remote import PeerSite, build_ring_exchange_call

        key = (axis, tuple(shape), dtype)
        if key not in self._peers:
            per = mesh.per_process

            def where(c):
                g = mesh.index(c)
                return g // per, g % per

            coords = mesh.local_coords()
            to = [(where(_shifted(mesh, c, axis, 1)),
                   where(_shifted(mesh, c, axis, -1))) for c in coords]
            frm = [(where(_shifted(mesh, c, axis, -1)),
                    where(_shifted(mesh, c, axis, 1))) for c in coords]
            dev = mesh.devices[0]
            _, meta = build_ring_exchange_call(
                shape, dtype, nslots=self.nslots, prefer_nc=self.prefer_nc,
                device=dev)
            site = PeerSite(meta, mesh, to, frm, dev,
                            name=f"axis {axis} slab "
                                 + "x".join(map(str, shape)),
                            timeout_s=dist_timeout_s())
            self._peers[key] = site
            self.sites.append(dict(meta, axis=axis, shards=len(coords),
                                   device=str(dev),
                                   processes=mesh.processes,
                                   region_bytes=site.region_bytes))
        return self._peers[key]

    def post(self, hi_slabs, lo_slabs, mesh: Mesh, axis: int,
             periodic: bool):
        """Post one shift; a batched slab ``(N, h, Y, X)`` travels as its
        contiguous ``(N h, Y, X)`` view (one site, one launch, whatever
        N) and comes back in its own shape."""
        posted = launchcheck.note_post("rdma", hi_slabs, lo_slabs, mesh,
                                       axis, _axis_count(mesh, axis))
        if not mesh.multiprocess:
            self.stats["shifts"] += 1
            return _Done(self.shift_pair(hi_slabs, lo_slabs, mesh, axis,
                                         periodic), posted)
        shape = tuple(hi_slabs[0].shape)
        hi_slabs = [_flat3(t) for t in hi_slabs]
        lo_slabs = [_flat3(t) for t in lo_slabs]
        site = self._peer(mesh, axis, hi_slabs[0].shape, hi_slabs[0].dtype)
        t0 = time.perf_counter()
        epoch = site.post(hi_slabs, lo_slabs)
        launchcheck.note("ring", reads=(hi_slabs, lo_slabs), axis=axis,
                         mesh=id(mesh), mesh_shape=tuple(mesh.shape),
                         shards=_axis_count(mesh, axis), transport="rdma")
        self.stats["shifts"] += 1
        self.stats["bytes"] += site.meta["slab_bytes"] * sum(
            1 for pair in site.to for r, _ in pair if r != site.rank)
        self.stats["seconds"] += time.perf_counter() - t0
        return _PeerPosted(self, site, epoch, shape, posted)

    def peer_sites(self) -> list:
        return list(self._peers.values())

    def check(self) -> None:
        """Raise a timed-out wait any peer-ring kernel of this process
        recorded (no synchronization: call it after one)."""
        for site in self._peers.values():
            site.check()

    def check_drained(self) -> None:
        """Collective: every peer site's flags and credits at its last
        epoch, in build order on every process."""
        for site in self._peers.values():
            site.check_drained()

    def shift_pair(self, hi_slabs: Sequence[torch.Tensor],
                   lo_slabs: Sequence[torch.Tensor], mesh: Mesh, axis: int,
                   periodic: bool):
        """Full-ring shift of a slab pair along grid ``axis`` on a mesh of
        one process: ``(from_left, from_right)``, the previous shard's
        ``hi`` and the next shard's ``lo`` slab for each shard, wrapping at
        the ring's ends whatever ``periodic`` says (the caller substitutes
        the guard constant at non-periodic walls)."""
        coords = list(mesh.coords())
        nxt = [mesh.index(_shifted(mesh, c, axis, 1)) for c in coords]
        prv = [mesh.index(_shifted(mesh, c, axis, -1)) for c in coords]
        shape = tuple(hi_slabs[0].shape)
        hi_slabs = [_flat3(t) for t in hi_slabs]
        lo_slabs = [_flat3(t) for t in lo_slabs]
        groups: Dict[torch.device, List[int]] = {}
        for i, c in enumerate(coords):
            groups.setdefault(mesh.device(c), []).append(i)
        for dev, idx in groups.items():
            if any(mesh.devices[j] != dev for i in idx
                   for j in (nxt[i], prv[i])):
                raise NotImplementedError(
                    f"exchange='rdma': a ring along mesh axis {axis} spans "
                    f"several devices: {RDMA_ITEM}")
        from_left: List[Optional[torch.Tensor]] = [None] * len(coords)
        from_right: List[Optional[torch.Tensor]] = [None] * len(coords)
        for dev, idx in groups.items():
            pos = {g: j for j, g in enumerate(idx)}
            call = self._call(axis, hi_slabs[idx[0]], len(idx))
            ctx = torch.cuda.device(dev) if dev.type == "cuda" else \
                contextlib.nullcontext()
            with ctx:
                fl, fr = call([hi_slabs[i] for i in idx],
                              [lo_slabs[i] for i in idx],
                              [pos[nxt[i]] for i in idx],
                              [pos[prv[i]] for i in idx])
            launchcheck.note("ring", reads=(hi_slabs, lo_slabs),
                             writes=(fl, fr), axis=axis, mesh=id(mesh),
                             mesh_shape=tuple(mesh.shape),
                             shards=_axis_count(mesh, axis),
                             transport="rdma")
            for j, i in enumerate(idx):
                from_left[i] = fl[j].reshape(shape)
                from_right[i] = fr[j].reshape(shape)
        return from_left, from_right



class _PeerPosted:
    """A shift posted on a peer site: ``wait()`` drains it."""

    def __init__(self, transport: RdmaTransport, site, epoch: int, shape,
                 posted=None):
        self._t, self._site, self._epoch = transport, site, epoch
        self._shape = shape
        self._posted = posted

    def wait(self):
        t0 = time.perf_counter()
        lefts, rights = self._site.drain(self._epoch)
        self._t.stats["seconds"] += time.perf_counter() - t0
        pair = ([None if t is None else t.reshape(self._shape)
                 for t in lefts],
                [None if t is None else t.reshape(self._shape)
                 for t in rights])
        if self._posted is not None:
            launchcheck.note_wait(self._posted, pair)
        return pair


# Every RdmaTransport of a mesh that spans processes, in build order (a
# harness reads their stats).
_PEER_TRANSPORTS: List[RdmaTransport] = []


class Exchange:
    """A halo exchange in flight: its first round of shifts is posted when
    the exchange is made; :meth:`wait` runs the remaining rounds (each
    shift of a round posted before the round is awaited) and returns what
    the blocking form of the exchange returns."""

    def __init__(self, rounds):
        self._rounds = rounds
        self._done = False
        self._value = None
        self._advance()

    def _advance(self) -> None:
        try:
            next(self._rounds)
        except StopIteration as stop:
            self._done, self._value = True, stop.value

    def wait(self):
        while not self._done:
            self._advance()
        return self._value


def _pick(mesh: Mesh, axis: int, transport):
    """The transport of one axis's shift: an axis of one shard is a local
    fill or wrap (in process), else ``transport`` or the mesh's own."""
    if _axis_count(mesh, axis) == 1:
        return _TRANSPORT
    return default_transport(mesh) if transport is None else transport


def _slabs_axis_rounds(blocks, mesh, axis, halo, bc_value, periodic,
                       transport, lead=0):
    t = axis + lead
    L = blocks[0].shape[t]
    lo = [_take(x, t, 0, halo) for x in blocks]
    hi = [_take(x, t, L - halo, halo) for x in blocks]
    return (yield from _border_rounds(lo, hi, mesh, axis, bc_value, periodic,
                                      transport))


def _border_rounds(lo, hi, mesh, axis, bc_value, periodic, transport):
    n = _axis_count(mesh, axis)
    if n > 1 or periodic:
        # packed: a slab across axis 0 is a view already, one across axis 1
        # (or any slab of a batched block) is copied out of its strided
        # rows (an axis of one shard at a wall reads no row: both its
        # slabs are the guard constant)
        lo = [x.contiguous() for x in lo]
        hi = [x.contiguous() for x in hi]
    pending = _pick(mesh, axis, transport).post(hi, lo, mesh, axis,
                                                periodic)
    yield
    lefts, rights = pending.wait()
    if transport is not None and n > 1 and not periodic:
        # a full-ring transport wraps at the walls: cut the ring there
        for i, c in enumerate(mesh.local_coords()):
            if _at(mesh, c, axis) == 0:
                lefts[i] = None
            if _at(mesh, c, axis) == n - 1:
                rights[i] = None
    for i, x in enumerate(lo):
        if lefts[i] is None or rights[i] is None:
            wall = torch.full(x.shape, bc_value, dtype=x.dtype,
                              device=x.device)
            lefts[i] = wall if lefts[i] is None else lefts[i]
            rights[i] = wall if rights[i] is None else rights[i]
    return lefts, rights


def post_slabs_axis(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    axis: int,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
) -> Exchange:
    """:func:`exchange_slabs_axis` posted: its ``wait()`` gives the
    slabs."""
    return Exchange(_slabs_axis_rounds(blocks, mesh, axis, halo, bc_value,
                                       periodic, transport, lead))


def exchange_slabs_axis(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    axis: int,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
):
    """The two halo slabs of every local shard along ``axis``,
    unconcatenated: ``(lefts, rights)``, one entry per shard of
    ``mesh.local_coords()``.

    ``lefts[i]`` belongs just before shard i's rows (the lower neighbour's
    last ``halo`` rows), ``rights[i]`` just after.  Interior faces receive
    the neighbour's border slab; global walls receive ``bc_value`` (or the
    wrap when ``periodic``).  The pad-free sharded kernel takes these slabs
    as operands, so no padded copy of the block is ever made.

    ``transport`` carries the ring shift (default: the mesh's own,
    :func:`default_transport`); an :class:`RdmaTransport` runs the full
    ring, and the wall shards' received slabs are then replaced by the
    guard constant, as the in-process shift gives them.  An axis of one
    shard runs no ring.

    ``lead`` is the number of tensor axes before the grid's (1 for the
    member axis of a batched run, whose ``(N, ...)`` blocks give ``(N,
    halo, ...)`` slabs: every member's in one shift).  Every exchange
    function here takes it.
    """
    return post_slabs_axis(blocks, mesh, axis, halo, bc_value, periodic,
                           transport, lead).wait()


def post_slabs_from_borders(
    lo_rows: Sequence[torch.Tensor],
    hi_rows: Sequence[torch.Tensor],
    mesh: Mesh,
    axis: int,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
) -> Exchange:
    """:func:`post_slabs_axis` with the sender-side border slabs given
    directly instead of sliced from the blocks.

    ``lo_rows[i]`` / ``hi_rows[i]`` are local shard i's first / last
    ``halo`` rows along ``axis`` (any views: they are packed before they
    are sent).  The pipelined stepper posts pass i+1's exchange from pass
    i's boundary-shell outputs, which no interior launch writes, so the
    transfer feeding the next pass waits on no interior work.  ``wait()``
    gives what :func:`exchange_slabs_axis` returns: ``(lefts, rights)``,
    the guard constant at non-periodic walls; an axis of one shard reads
    no row of a non-periodic field (both slabs are the guard constant).
    """
    for x in (*lo_rows, *hi_rows):
        if x.shape[axis + lead] != halo:
            raise ValueError(f"border rows {tuple(x.shape)} are not {halo} "
                             f"deep along axis {axis}")
    return Exchange(_border_rounds(lo_rows, hi_rows, mesh, axis, bc_value,
                                   periodic, transport))


def _slabs_2axis_rounds(blocks, mesh, halo, bc_value, periodic, transport,
                        lead=0):
    z = post_slabs_axis(blocks, mesh, 0, halo, bc_value, periodic, transport,
                        lead)
    y = post_slabs_axis(blocks, mesh, 1, halo, bc_value, periodic, transport,
                        lead)
    return (yield from _corner_rounds(z, y, mesh, halo, bc_value, periodic,
                                      transport, lead))


def _corner_rounds(z, y, mesh, halo, bc_value, periodic, transport,
                   lead=0):
    """The rest of a 2-axis exchange once its z and y shifts are posted."""
    yield
    (zlo, zhi), (ylo, yhi) = z.wait(), y.wait()
    # second pass: the y shift of the received z slabs carries the corners
    cl = post_slabs_axis(zlo, mesh, 1, halo, bc_value, periodic, transport,
                         lead)
    ch = post_slabs_axis(zhi, mesh, 1, halo, bc_value, periodic, transport,
                         lead)
    (c_ll, c_lh), (c_hl, c_hh) = cl.wait(), ch.wait()
    return [((zlo[i], zhi[i]), (ylo[i], yhi[i]),
             (c_ll[i], c_lh[i], c_hl[i], c_hh[i]))
            for i in range(len(zlo))]


def post_slabs_2axis(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
) -> Exchange:
    """:func:`exchange_slabs_2axis` posted: the z and y shifts are in
    flight; ``wait()`` runs the corners' shifts and gives the slab sets."""
    return Exchange(_slabs_2axis_rounds(blocks, mesh, halo, bc_value,
                                        periodic, transport, lead))


def exchange_slabs_2axis(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
):
    """The slab set of every local shard of a 3D field for both wall axes:
    per shard ``((zlo, zhi), (ylo, yhi), (c_ll, c_lh, c_hl, c_hh))``.

    ``zlo``/``zhi`` are the (halo, Ly, X) z slabs, ``ylo``/``yhi`` the
    (Lz, halo, X) y slabs, and the corners the (halo, halo, X) pieces in
    (z side, y side) order: ll = (z lo, y lo), lh = (z lo, y hi), hl, hh.
    Corners come by two-pass composition, the y exchange of the z slabs,
    so shard (z, y)'s ``c_ll`` is shard (z-1, y-1)'s trailing corner,
    carried by face exchanges alone.  An unsharded axis gets the local
    bc-fill or wrap slabs, so one operand set serves (z, y), y-only and
    z-only meshes.  Every piece is a packed buffer.  ``transport`` carries
    every ring shift (:func:`exchange_slabs_axis`).
    """
    return post_slabs_2axis(blocks, mesh, halo, bc_value, periodic,
                            transport, lead).wait()


def post_slabs_2axis_from_borders(
    z_lo: Sequence[torch.Tensor],
    z_hi: Sequence[torch.Tensor],
    y_lo: Sequence[torch.Tensor],
    y_hi: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    transport=None,
    lead: int = 0,
) -> Exchange:
    """:func:`post_slabs_2axis` from border rows given per local shard:
    ``z_lo``/``z_hi`` its first/last ``halo`` rows along z (the whole y
    extent), ``y_lo``/``y_hi`` along y (the whole z extent).  In the
    pipelined stepper they come from the boundary-shell outputs (z shells
    span y, y shells span z), never from the interior.  The z and y shifts
    are posted; ``wait()`` runs the corners' shifts, which keep the
    two-pass composition (the y shift of the received z slabs, whose own y
    borders are the corner blocks a diagonal hop would send), and gives
    what :func:`exchange_slabs_2axis` returns."""
    z = post_slabs_from_borders(z_lo, z_hi, mesh, 0, halo, bc_value,
                                periodic, transport, lead)
    y = post_slabs_from_borders(y_lo, y_hi, mesh, 1, halo, bc_value,
                                periodic, transport, lead)
    return Exchange(_corner_rounds(z, y, mesh, halo, bc_value, periodic,
                                   transport, lead))


def local_mesh(block: torch.Tensor) -> Mesh:
    """A mesh of one shard on ``block``'s device: an exchange over it is a
    local wrap or guard-cell fill, what a one-shard mesh would give."""
    return Mesh((), [block.device])


def pad_from_slabs(core: torch.Tensor, slabs, halo: int, axis: int = 0,
                   start: int = 0, stop: Optional[int] = None,
                   lead: int = 0) -> torch.Tensor:
    """Cells ``[start, stop)`` along ``axis`` (0 or 1) of ``core``'s z/y
    padded block — what ``exchange_and_pad(..., axes=(0, 1))`` gives —
    rebuilt from the core and its slab set from
    :func:`exchange_slabs_2axis`, in one allocation.

    The padded block is a 3 x 3 tiling in (z, y) of the corners, slabs and
    core; each piece that meets the band is copied in once.  The overlapped
    steps cut their boundary-shell strips this way, so no padded copy of
    the whole block is made.
    """
    (zlo, zhi), (ylo, yhi), (c_ll, c_lh, c_hl, c_hh) = slabs
    pieces = ((c_ll, zlo, c_lh), (ylo, core, yhi), (c_hl, zhi, c_hh))
    Lz, Ly, X = core.shape[lead:]
    edges = ((0, halo, halo + Lz, Lz + 2 * halo),
             (0, halo, halo + Ly, Ly + 2 * halo))
    stop = edges[axis][3] if stop is None else stop
    shape = [Lz + 2 * halo, Ly + 2 * halo, X]
    shape[axis] = stop - start
    out = torch.empty(tuple(core.shape[:lead]) + tuple(shape),
                      dtype=core.dtype, device=core.device)
    for a in range(3):
        for b in range(3):
            lo = [edges[0][a], edges[1][b]]
            hi = [edges[0][a + 1], edges[1][b + 1]]
            s, e = max(lo[axis], start), min(hi[axis], stop)
            if s >= e:
                continue
            src = pieces[a][b].narrow(axis + lead, s - lo[axis], e - s)
            lo[axis], hi[axis] = s - start, e - start
            out[(slice(None),) * lead + (slice(lo[0], hi[0]),
                                         slice(lo[1], hi[1]))].copy_(src)
    return out


def _pad_rounds(blocks, mesh, halo, bc_value, periodic, axes, lead=0):
    if halo == 0:
        return list(blocks)
    ndim = blocks[0].dim()
    # tensor axes: the grid's, after ``lead`` member axes (never padded)
    axes = tuple(range(lead, ndim)) if axes is None else \
        tuple(sorted(a + lead for a in axes))
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
        pending = _pick(mesh, d - lead, None).post(hi, lo, mesh, d - lead,
                                                   periodic)
        yield
        lefts, rights = pending.wait()
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


def post_and_pad(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    axes: Optional[Sequence[int]] = None,
    lead: int = 0,
) -> Exchange:
    """:func:`exchange_and_pad` posted: the first axis's shift is in
    flight; ``wait()`` runs the rest and gives the padded blocks."""
    return Exchange(_pad_rounds(blocks, mesh, halo, bc_value, periodic,
                                axes, lead))


def exchange_and_pad(
    blocks: Sequence[torch.Tensor],
    mesh: Mesh,
    halo: int,
    bc_value,
    periodic: bool = False,
    axes: Optional[Sequence[int]] = None,
    lead: int = 0,
) -> List[torch.Tensor]:
    """Halo-pad every local block along grid ``axes`` (default: all; the
    ``lead`` member axes before them never), two-pass.

    Each padded block is one allocation: the core is copied in, then for
    each axis in order the two halo slabs, read from the neighbours' padded
    blocks over the extent already padded along earlier axes (so corners
    arrive by face exchanges alone; across processes too, since an axis is
    shifted only once the earlier axes' slabs have arrived).  A mesh axis
    of one shard degrades to a local wrap (periodic) or guard-cell fill.
    ``halo == 0`` (a field whose neighbours are never read, wave's
    ``u_prev``) returns the blocks unchanged and exchanges nothing.
    """
    return post_and_pad(blocks, mesh, halo, bc_value, periodic, axes,
                        lead).wait()


def pad_local(block: torch.Tensor, halo: int, bc_value,
              periodic: bool = False,
              axes: Optional[Sequence[int]] = None,
              lead: int = 0) -> torch.Tensor:
    """One block padded along ``axes`` (default: all) as if it were the
    whole grid (local wrap or guard-cell fill, no exchange): what a
    one-shard mesh would give."""
    return exchange_and_pad([block], local_mesh(block), halo, bc_value,
                            periodic, axes=axes, lead=lead)[0]
