"""The ring-exchange kernel (TPU table row 19): ``ring_exchange``.

``ring_exchange`` (``csrc/remote.cu::ring_exchange``) moves both ring
directions of one mesh axis for one slab pair — every shard's ``hi`` slab to
the next shard (its ``from_left``), every ``lo`` slab to the previous one
(its ``from_right``) — chunk by chunk, each chunk written in place into the
destination's output slab and counted on that chunk's ready counter, for
every ring of shards that lives on one device, in one ordinary launch.  The
ring is always full, as in the TPU package: the wall shards send and
receive too, and the caller (``parallel/halo.py``) overwrites the walls'
received slabs with the guard constant.

Replaces the TPU package's ``ops/pallas/remote.py``:
``build_ring_exchange_call`` (``_ring_kernel``), with ``_NSLOTS``,
``_nc_ladder``, ``pick_chunks`` and ``ring_exchange_stats`` kept under their
names and with their results: the chunk geometry is the kernel's public
meta.  The TPU kernel stages chunks through VMEM send and receive rings
under credit semaphores; on one card a chunk's destination is device memory
already, so the port lands it there and keeps only the ready counts as the
protocol's record (``nslots`` still sets the chunk ladder and the meta).
The TPU's loopback mode has no counterpart: the ring runs for real between
the shards that share a card.  A ring whose shards span processes (on one
card, or a card a process: peer writes over NVLink) is :class:`PeerSite`
below; one process's ring across several cards is still refused by name
(ROADMAP B7).  The kernel copies units and never reads them as numbers:
16 bytes where every run, stride and pointer aligns to them, else one
element (4 bytes in float32, 2 in bfloat16).  Bound on an H100:
device-memory bytes, each slab read once and each received slab written
once.

Plain PyTorch version: :func:`plain_ring_exchange`, the same protocol
(per chunk: land it, count it) walked in order, its drained invariant
asserted.  A wrapper takes it only for tensors on the CPU.

Across processes (ROADMAP B7, on one node): :class:`PeerSite`, the ring's
cross-process form, ``ring_send`` and ``ring_drain``
(``csrc/remote.cu``): the TPU protocol's receive slots, ready flags and
credits again, in one region of device memory a process and site that
every peer maps (CUDA IPC), with epochs in place of the memset.  Its plain
version walks the same protocol on the host, the regions in shared memory
files.  A ring whose shards share one process keeps
:func:`ring_exchange`.
"""

from __future__ import annotations

import ctypes
import math
import os
import tempfile
import time
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import _build
from .fused import _sublane

# Launches, keyed "ring_exchange[4x512x1024]" by slab shape (bfloat16:
# "ring_exchange[4x512x1024,bfloat16]"; across processes "ring_send[...]"
# and "ring_drain[...]"): one added where a kernel launches, nowhere else.
# ``launches.clear()`` resets.
launches: Counter = Counter()

# The TPU ring's slots per direction (its default, 2): within one process
# the port stages nothing, and the depth sets the chunk ladder
# (_nc_ladder) and the meta; across processes it is the receive ring's
# depth again (PeerSite).
_NSLOTS = 2
# Shards one launch takes (the kernel's parameter block).
MAX_SHARDS = 32

_c_int, _c_long, _c_ptr = ctypes.c_int, ctypes.c_long, ctypes.c_void_p


def _nc_ladder(nslots: int) -> Tuple[int, int]:
    """Chunk-count ladder, largest first: at least as many chunks as slots,
    so a deeper ring wants more chunks."""
    return (2 * nslots, nslots)


def pick_chunks(shape: Tuple[int, ...], itemsize: int,
                nslots: int = _NSLOTS,
                prefer_nc: int = 0) -> Tuple[int, int]:
    """``(chunk_axis, nchunks)`` for a slab of ``shape``: the first count of
    the ladder (``prefer_nc`` first, if given) that divides axis 1, then
    axis 0; ``(0, 1)`` when none does.  Axis 2 is never chunked.

    The alignment gate on axis 1 (its chunk extent a multiple of 8 rows for
    float32, 16 for bfloat16) is a TPU rule (sublane-aligned DMA offsets);
    the port keeps it so both packages cut a slab into the same chunks.
    """
    sub = _sublane(itemsize)
    ladder = ((int(prefer_nc),) if prefer_nc else ()) \
        + _nc_ladder(int(nslots))
    for nc in ladder:
        for axis in (1, 0):
            ext = int(shape[axis])
            if ext % nc:
                continue
            if axis == 1 and (ext // nc) % sub:
                continue
            return axis, nc
    return 0, 1


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _meta(shape, dtype, nslots, axis, nc) -> dict:
    """The TPU package's meta keys; ``remote_dma_per_call`` counts chunk
    transfers (both directions) and ``ici_bytes_per_call`` the bytes one
    call moves between shards."""
    slab_bytes = shape[0] * shape[1] * shape[2] * _itemsize(dtype)
    return {"shape": shape, "dtype": str(dtype).replace("torch.", ""),
            "chunk_axis": axis, "nchunks": nc, "nslots": nslots,
            "slab_bytes": slab_bytes, "chunk_bytes": slab_bytes // nc,
            "remote_dma_per_call": 2 * nc,
            "ici_bytes_per_call": 2 * slab_bytes}


def ring_exchange_stats(shape: Tuple[int, ...], dtype,
                        nslots: Optional[int] = None,
                        prefer_nc: int = 0) -> dict:
    """Chunk geometry and per-call counts without building anything: the
    TPU package's dict, from the same :func:`pick_chunks`."""
    shape = tuple(int(s) for s in shape)
    nslots = int(nslots) if nslots else _NSLOTS
    axis, nc = pick_chunks(shape, _itemsize(dtype), nslots=nslots,
                           prefer_nc=prefer_nc)
    meta = _meta(shape, dtype, nslots, axis, nc)
    return {"shape": list(shape), "chunk_axis": axis, "nchunks": nc,
            "nslots": nslots, "chunk_bytes": meta["chunk_bytes"],
            "remote_dma_per_call": 2 * nc,
            "ici_bytes_per_call": 2 * meta["slab_bytes"]}


def _geometry(meta) -> Tuple[int, int, int, int]:
    """``(runs, run_len, run_stride, chunk_stride)`` in elements: chunk c of
    a slab is ``runs`` runs of ``run_len`` elements ``run_stride`` apart,
    from ``c * chunk_stride`` (one run when the chunk axis is z)."""
    Z, Y, X = meta["shape"]
    csize = meta["shape"][meta["chunk_axis"]] // meta["nchunks"]
    if meta["chunk_axis"] == 0:
        return 1, csize * Y * X, Y * X, csize * Y * X
    return Z, csize * X, Y * X, csize * X


def drained_counts(meta, blocks: int) -> List[int]:
    """What the ready counter of every chunk of one (shard, direction)
    holds after a launch whose blocks wrote ``blocks`` shares of each
    chunk (1 for the plain version): one count per block that landed a
    share."""
    return [int(blocks)] * meta["nchunks"]


class RingState:
    """The counters of one exchange site on one device: ``counters`` (S, 2,
    nchunks) int32 — shard, direction, chunk — the ready counts of the
    chunks that landed in each shard's received slabs, and ``blocks``, the
    blocks that wrote each chunk in the last launch (1 for the plain
    version).  It also keeps what every launch of the site reuses: the
    chunk geometry and each ring order's checked C arrays."""

    def __init__(self, meta, n_shards: int, device):
        self.counters = torch.zeros((n_shards, 2, meta["nchunks"]),
                                    dtype=torch.int32, device=device)
        self.blocks = 1
        self.geometry = _geometry(meta)
        self._rings = {}  # (nxt, prv) -> their C arrays
        self._blocks = {}  # unit bytes -> blocks a chunk

    def check_drained(self, meta) -> None:
        """Raise unless every chunk's ready counter equals the blocks that
        wrote into it (reads the counters: a synchronizing copy on a
        card)."""
        want = drained_counts(meta, self.blocks)
        for s, per in enumerate(self.counters.cpu().tolist()):
            for d in (0, 1):
                if per[d] != want:
                    raise AssertionError(
                        f"ring_exchange: shard {s} direction {d} ready "
                        f"counters {per[d]}, drained is {want}")

    def ring(self, nxt: Sequence[int], prv: Sequence[int]):
        """The C arrays of a ring order, checked once: ``nxt`` and ``prv``
        must be inverse permutations of the shards."""
        key = (tuple(nxt), tuple(prv))
        if key not in self._rings:
            S = len(nxt)
            if sorted(nxt) != list(range(S)) or len(prv) != S or \
                    any(prv[nxt[i]] != i for i in range(S)):
                raise ValueError("ring_exchange: nxt and prv must be "
                                 "inverse permutations of the shards")
            self._rings[key] = ((_c_int * S)(*nxt), (_c_int * S)(*prv))
        return self._rings[key]


def _chunk(t: torch.Tensor, axis: int, c: int, csize: int) -> torch.Tensor:
    return t.narrow(axis, c * csize, csize)


def plain_ring_exchange(hi: Sequence[torch.Tensor],
                        lo: Sequence[torch.Tensor], nxt: Sequence[int],
                        prv: Sequence[int], meta, state: RingState):
    """The plain version of :func:`ring_exchange`: the protocol walked in
    order, one writer per chunk — per chunk and (shard, direction), the
    chunk copied into the destination's output slab at its own offset,
    then its ready counter counted — and the drained invariant asserted.
    Returns ``(from_left, from_right)``: ``from_left[i] == hi[prv[i]]``,
    ``from_right[i] == lo[nxt[i]]``."""
    S = len(hi)
    axis, nc = meta["chunk_axis"], meta["nchunks"]
    csize = meta["shape"][axis] // nc
    state.blocks = 1
    # [shard][direction][chunk]
    ready = [[[0] * nc for _ in (0, 1)] for _ in range(S)]
    srcs, dests = (hi, lo), (nxt, prv)
    outs = ([torch.empty_like(h) for h in hi],
            [torch.empty_like(x) for x in lo])
    for c in range(nc):
        for s in range(S):
            for d in (0, 1):
                to = dests[d][s]
                assert ready[to][d][c] == 0, "a chunk landed twice"
                _chunk(outs[d][to], axis, c, csize).copy_(
                    _chunk(srcs[d][s], axis, c, csize))
                ready[to][d][c] += 1
    state.counters.copy_(torch.tensor(ready, dtype=torch.int32))
    state.check_drained(meta)
    return outs


def _lib():
    lib = _build.load("remote")
    if lib.ring_peer_launch.argtypes is None:
        pp = ctypes.POINTER(_c_ptr)
        lib.ring_peer_launch.argtypes = (
            [_c_int, _c_int, _c_int, pp, pp, pp, pp,
             ctypes.POINTER(_c_int)] + [_c_int] * 4 + [_c_long] * 4
            + [_c_int, ctypes.c_double, _c_ptr, _c_ptr])
        lib.peer_handle_bytes.restype = _c_long
        lib.peer_region_alloc.argtypes = [_c_int, _c_long,
                                          ctypes.POINTER(_c_ptr), _c_ptr]
        lib.peer_region_open.argtypes = [_c_int, _c_ptr,
                                         ctypes.POINTER(_c_ptr)]
        lib.peer_region_close.argtypes = [_c_int, _c_ptr]
        lib.peer_region_free.argtypes = [_c_int, _c_ptr]
        lib.peer_region_read.argtypes = [_c_int, _c_ptr, _c_ptr, _c_long]
        lib.peer_record_alloc.argtypes = [_c_int, ctypes.POINTER(_c_ptr)]
        lib.peer_record_reset.argtypes = [_c_int, _c_ptr]
    if lib.ring_exchange_launch.argtypes is None:
        ip = ctypes.POINTER(_c_int)
        lib.ring_exchange_launch.argtypes = (
            [_c_int, ctypes.POINTER(_c_ptr), _c_ptr, _c_long, _c_ptr, ip, ip,
             _c_int] + [_c_long] * 4 + [_c_int, _c_ptr])
        lib.ring_exchange_blocks.argtypes = [_c_long, _c_long]
        lib.ring_exchange_blocks.restype = _c_long
    return lib


def ring_exchange(hi: Sequence[torch.Tensor], lo: Sequence[torch.Tensor],
                  nxt: Sequence[int], prv: Sequence[int], meta,
                  state: RingState):
    """One launch: the ring shift of S shards' slab pairs on one device.

    ``hi[i]``/``lo[i]`` are shard i's last and first slabs (``meta``'s
    shape, packed), ``nxt[i]``/``prv[i]`` the positions in these lists of
    its next and previous ring neighbours.  Returns ``(from_left,
    from_right)`` per shard.  The counters in ``state`` hold the launch's
    drained counts when it ends (:meth:`RingState.check_drained`)."""
    S = len(hi)
    if not hi[0].is_cuda:
        return plain_ring_exchange(hi, lo, nxt, prv, meta, state)
    shape = tuple(meta["shape"])
    _build.check_operands("ring_exchange", *hi, *lo, shape=shape,
                          dtype=_build.FLOAT_DTYPES)
    if not 1 <= S <= MAX_SHARDS or len(lo) != S:
        raise ValueError(f"ring_exchange: 1 to {MAX_SHARDS} shards a launch, "
                         f"got {S} hi and {len(lo)} lo slabs")
    c_nxt, c_prv = state.ring(nxt, prv)
    # one allocation for every received slab: from_left, then from_right
    out = torch.empty((2 * S,) + shape, dtype=hi[0].dtype,
                      device=hi[0].device)
    ptrs = [t.data_ptr() for t in hi] + [t.data_ptr() for t in lo]
    runs, run_len, run_stride, chunk_stride = state.geometry
    esize = out.element_size()
    # 16-byte units where every run, stride and pointer aligns to them,
    # else one element each
    per16 = 16 // esize
    aligned = (run_len % per16 == 0 and run_stride % per16 == 0
               and chunk_stride % per16 == 0 and out.data_ptr() % 16 == 0
               and all(p % 16 == 0 for p in ptrs))
    unit_bytes = 16 if aligned else esize
    unit = unit_bytes // esize  # elements per unit
    lib = _lib()
    if unit_bytes not in state._blocks:
        state._blocks[unit_bytes] = lib.ring_exchange_blocks(
            runs, run_len // unit)
    state.blocks = state._blocks[unit_bytes]
    rc = lib.ring_exchange_launch(
        S, (_c_ptr * (2 * S))(*ptrs), out.data_ptr(),
        math.prod(shape) * esize, state.counters.data_ptr(), c_nxt, c_prv,
        meta["nchunks"], runs, run_len // unit, run_stride // unit,
        chunk_stride // unit, unit_bytes, _build.stream_of(hi[0]))
    _build.check(lib, rc, "ring_exchange")
    launches[_build.launch_key("ring_exchange", "x".join(map(str, shape)),
                               hi[0])] += 1
    slabs = out.unbind(0)
    return list(slabs[:S]), list(slabs[S:])


def build_ring_exchange_call(
    shape: Tuple[int, ...],
    dtype,
    *,
    nslots: Optional[int] = None,
    prefer_nc: int = 0,
    chunks: Optional[Tuple[int, int]] = None,
    device=None,
) -> Tuple[Callable, dict]:
    """One exchange site for slabs of ``shape``/``dtype``: ``(call,
    meta)``.

    ``call(hi, lo, nxt, prv) -> (from_left, from_right)`` runs
    :func:`ring_exchange` on S shards' slabs (one device), with the ready
    counters kept per (device, S) and reused by every call;
    ``call.state`` is the last call's :class:`RingState`.  ``meta`` holds
    the TPU package's keys (shape, dtype, chunk_axis, nchunks, nslots,
    slab_bytes, chunk_bytes, remote_dma_per_call, ici_bytes_per_call).
    ``nslots`` (the TPU ring's depth, default 2: it sets the chunk ladder
    and the meta) and ``prefer_nc`` (a preferred chunk count, still gated
    by :func:`pick_chunks`) are the TPU package's variant knobs;
    ``chunks`` forces ``(axis, nchunks)``.  With a CUDA ``device`` the
    kernel is built here, before the time loop.
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3:
        raise ValueError(f"ring_exchange: 3D slabs only, got {shape}")
    nslots = int(nslots) if nslots else _NSLOTS
    if chunks is None:
        chunks = pick_chunks(shape, _itemsize(dtype), nslots=nslots,
                             prefer_nc=prefer_nc)
    axis, nc = (int(c) for c in chunks)
    if axis not in (0, 1) or nc < 1 or shape[axis] % nc:
        raise ValueError(f"ring_exchange: chunks {chunks} do not cut "
                         f"{shape} along z or y")
    meta = _meta(shape, dtype, nslots, axis, nc)
    if device is not None and torch.device(device).type == "cuda":
        _lib()
    states = {}

    def call(hi, lo, nxt, prv):
        key = (hi[0].device, len(hi))
        if key not in states:
            states[key] = RingState(meta, len(hi), hi[0].device)
        call.state = states[key]
        return ring_exchange(hi, lo, nxt, prv, meta, call.state)

    call.state = None
    return call, meta


# ---- the ring across processes (ROADMAP B7): ring_send, ring_drain --------

# Units one block of ring_send / ring_drain (and ring_exchange) moves of a
# run: remote.cu's THREADS * ILP.
_SPAN = 1024
# Region pieces start on this many bytes.
_ALIGN = 256
# Every site built in this process, in build order (the id a kernel
# records in the error record); :func:`close_peer_regions` and
# :func:`free_peer_regions` tear them down.
_SITES: List["PeerSite"] = []
# device index -> this process's mapped error record (8 ints)
_RECORDS = {}


class PeerTimeout(RuntimeError):
    """A peer ring's wait passed its deadline: the peer died or stalled."""


def _align(n: int) -> int:
    return -(-int(n) // _ALIGN) * _ALIGN


def _unit_bytes(meta) -> int:
    """The copy unit of a site's launches, from its geometry alone (the
    same in every process): 16 bytes where every run and stride is a
    multiple of them, else one element."""
    esize = _itemsize(getattr(torch, meta["dtype"]))
    _, run_len, run_stride, chunk_stride = _geometry(meta)
    per16 = 16 // esize
    if run_len % per16 == 0 and run_stride % per16 == 0 and \
            chunk_stride % per16 == 0:
        return 16
    return esize


def peer_blocks(meta) -> int:
    """The blocks of one chunk of a ring_send / ring_drain launch (runs
    times the parts of a run), each with a ready flag and a credit."""
    runs, run_len, _, _ = _geometry(meta)
    unit = _unit_bytes(meta) // _itemsize(getattr(torch, meta["dtype"]))
    return runs * (-(-(run_len // unit) // _SPAN))


def peer_layout(meta, shards: int, blocks: int) -> dict:
    """Byte offsets of one process's region of a site: ``slots`` (nslots x
    2 directions x ``shards`` received slabs, slot-major), ``ready`` and
    ``credit`` (2 x ``shards`` arrays of ``flags`` int32 each: one a block
    of every chunk), and ``bytes``, the region's size."""
    flags = meta["nchunks"] * int(blocks)
    slots = meta["nslots"] * 2 * shards * meta["slab_bytes"]
    ready = _align(slots)
    credit = ready + _align(2 * shards * flags * 4)
    return {"slots": 0, "ready": ready, "credit": credit, "flags": flags,
            "bytes": credit + _align(2 * shards * flags * 4)}


def peer_site_bytes(shape, dtype) -> int:
    """Device bytes of one shard's region of a site on the card (its
    receive slots, ready flags and credits, at the default depth): what
    ``--mem-check`` prices."""
    shape = tuple(int(v) for v in shape)
    axis, nc = pick_chunks(shape, _itemsize(dtype))
    meta = _meta(shape, dtype, _NSLOTS, axis, nc)
    return peer_layout(meta, 1, peer_blocks(meta))["bytes"]


def _record(device: torch.device) -> int:
    """This process's mapped error record on ``device`` (made once)."""
    if device.index not in _RECORDS:
        host = _c_ptr()
        _build.check(_lib(), _lib().peer_record_alloc(device.index,
                                                      ctypes.byref(host)),
                     "peer ring: cudaHostAlloc of the error record")
        _RECORDS[device.index] = host.value
    return _RECORDS[device.index]


def reset_peer_record(device) -> None:
    """Clear this process's error word and record on ``device`` (after a
    deliberate timeout: every later wait would return at once)."""
    device = _indexed_device(device)
    _build.check(_lib(), _lib().peer_record_reset(device.index,
                                                  _record(device)),
                 "peer ring: reset of the error record")


class PeerSite:
    """One exchange site (one slab shape and dtype along one mesh axis) of
    a ring whose shards span processes: ``ring_send`` and ``ring_drain``.

    ``group`` is the mesh (``process``, ``processes``,
    ``all_gather_object``, ``barrier``); ``to[s] = ((rank, t), (rank,
    t))`` is where local shard s's hi slab (direction 0: the next shard's
    from_left) and lo slab (direction 1: the previous shard's from_right)
    go, ``frm[t]`` who sends local shard t's from_left and from_right.
    Built collectively, in the same order in every process: each process
    allocates its region (:func:`peer_layout`), the regions are exchanged
    in rank order (CUDA IPC handles, or shared-memory file names for the
    plain version on the CPU) and every peer's is mapped.

    :meth:`post` (``epoch`` = the posts so far + 1) lands both directions'
    slabs of every local shard in their destinations' slot ``epoch %
    nslots`` and publishes the ready flags; :meth:`drain` takes the
    epoch's slabs out of this process's slots into fresh output slabs and
    releases the senders' credits.  A post that would reuse a slot whose
    epoch is not drained yet raises (more exchanges in flight than slots:
    a deadlock by construction).  A wait that outlasts ``timeout_s`` raises
    :class:`PeerTimeout` naming the site, the epoch, the chunk and the peer
    (on the card: the kernel records it and the next call, or
    :meth:`check`, raises).  :meth:`check_drained` (collective) holds every
    flag and credit of this process's region at the last epoch.

    On a CUDA ``device`` the kernels run; on the CPU the plain version
    walks the same protocol (per chunk: await the credit, copy, publish;
    await the flag, copy, credit), with one flag a chunk.  ``regions``
    (plain only) gives the region tensors instead of shared files (one
    process: a world of one on any device).
    """

    def __init__(self, meta, group, to, frm, device, *, name: str = "",
                 timeout_s: float = 300.0, regions=None):
        self.meta = meta
        self.group = group
        self.rank, self.world = int(group.process), int(group.processes)
        self.to, self.frm = [tuple(x) for x in to], [tuple(x) for x in frm]
        self.S = len(self.to)
        self.device = _indexed_device(device)
        self.cuda = self.device.type == "cuda" and regions is None
        self.dtype = getattr(torch, meta["dtype"])
        self.nslots = int(meta["nslots"])
        self.geometry = _geometry(meta)
        self.unit = _unit_bytes(meta) if self.cuda else _itemsize(self.dtype)
        self.blocks = peer_blocks(meta) if self.cuda else 1
        self.layout = peer_layout(meta, self.S, self.blocks)
        self.timeout_s = float(timeout_s)
        self.name = name or "x".join(map(str, meta["shape"]))
        self.sent = self.drained = 0
        self.closed = False
        self._opened: List[int] = []
        if not 1 <= self.S <= MAX_SHARDS:
            raise ValueError(f"peer ring: 1 to {MAX_SHARDS} local shards, "
                             f"got {self.S}")
        self.id = len(_SITES)
        if self.cuda:
            self._map_cuda()
        else:
            self._map_plain(regions)
        _SITES.append(self)

    def __repr__(self) -> str:
        return (f"peer ring site {self.id} ({self.name}, process "
                f"{self.rank} of {self.world})")

    @property
    def region_bytes(self) -> int:
        return self.layout["bytes"]

    def _key(self, wrapper: str, like: torch.Tensor) -> str:
        return _build.launch_key(wrapper, "x".join(map(str, self.meta[
            "shape"])), like)

    # -- the regions -----------------------------------------------------

    def _map_cuda(self) -> None:
        lib = _lib()
        dev = self.device.index
        ptr = _c_ptr()
        handle = ctypes.create_string_buffer(lib.peer_handle_bytes())
        _build.check(lib, lib.peer_region_alloc(
            dev, self.region_bytes, ctypes.byref(ptr), handle),
            f"{self}: cudaMalloc / cudaIpcGetMemHandle of its "
            f"{self.region_bytes}-byte region")
        self._own = ptr.value
        handles = self.group.all_gather_object(handle.raw)
        self.base = [0] * self.world
        for r, h in enumerate(handles):
            if r == self.rank:
                self.base[r] = self._own  # a process cannot open its own
                continue
            p = _c_ptr()
            buf = ctypes.create_string_buffer(h, len(h))
            _build.check(lib, lib.peer_region_open(dev, buf,
                                                   ctypes.byref(p)),
                         f"{self}: cudaIpcOpenMemHandle of process {r}'s "
                         "region (no fallback: the ring needs every peer "
                         "mapped)")
            self.base[r] = p.value
            self._opened.append(p.value)
        self._record = _record(self.device)
        self._send = [self._send_arrays(slot) for slot in range(self.nslots)]
        self._drain = [self._drain_arrays(slot)
                       for slot in range(self.nslots)]

    def _map_plain(self, regions) -> None:
        nbytes = self.region_bytes
        if regions is not None:
            self.regions = list(regions)
            return
        if self.world == 1:
            self.regions = [torch.zeros(nbytes, dtype=torch.uint8,
                                        device=self.device)]
            return
        # a file of zeros a process, mapped shared by every peer; each
        # process unlinks its own once all have mapped it
        fd, path = tempfile.mkstemp(prefix="mpi_cuda_process_torch_ring_")
        try:
            os.ftruncate(fd, nbytes)
        finally:
            os.close(fd)
        try:
            paths = self.group.all_gather_object(path)
            self.regions = [torch.from_file(p, shared=True, size=nbytes,
                                            dtype=torch.uint8)
                            for p in paths]
            self.group.barrier()
        finally:
            os.unlink(path)

    def _slot_off(self, slot: int, d: int, t: int) -> int:
        return self.layout["slots"] + ((slot * 2 + d) * self.S + t) \
            * self.meta["slab_bytes"]

    def _flag_off(self, which: str, t: int, d: int) -> int:
        return self.layout[which] + (t * 2 + d) * self.layout["flags"] * 4

    def _send_arrays(self, slot: int):
        """The C arrays of a send into slot ``slot`` (all but the
        sources): destination slots, their flags, own credits, peers."""
        dst, ready, credit, peer = [], [], [], []
        for s in range(self.S):
            for d in (0, 1):
                r, t = self.to[s][d]
                dst.append(self.base[r] + self._slot_off(slot, d, t))
                ready.append(self.base[r] + self._flag_off("ready", t, d))
                credit.append(self._own + self._flag_off("credit", s, d))
                peer.append(r)
        n = 2 * self.S
        return ((_c_ptr * n)(*dst), (_c_ptr * n)(*ready),
                (_c_ptr * n)(*credit), (_c_int * n)(*peer))

    def _drain_arrays(self, slot: int):
        """The C arrays of a drain of slot ``slot`` (all but the outputs):
        own slots, own flags, the senders' credits, peers."""
        src, ready, credit, peer = [], [], [], []
        for t in range(self.S):
            for d in (0, 1):
                r, s = self.frm[t][d]
                src.append(self._own + self._slot_off(slot, d, t))
                ready.append(self._own + self._flag_off("ready", t, d))
                credit.append(self.base[r] + self._flag_off("credit", s, d))
                peer.append(r)
        n = 2 * self.S
        return ((_c_ptr * n)(*src), (_c_ptr * n)(*ready),
                (_c_ptr * n)(*credit), (_c_int * n)(*peer))

    # -- the protocol ------------------------------------------------------

    def post(self, hi: Sequence[torch.Tensor],
             lo: Sequence[torch.Tensor]) -> int:
        """Send every local shard's hi and lo slab for the next epoch;
        returns the epoch."""
        self._usable()
        e = self.sent + 1
        if e - self.nslots > self.drained:
            raise RuntimeError(
                f"{self}: epoch {e} would reuse the slot of epoch "
                f"{e - self.nslots}, not drained yet: more exchanges in "
                f"flight than its {self.nslots} slots")
        if len(hi) != self.S or len(lo) != self.S:
            raise ValueError(f"{self}: {self.S} local shards, got "
                             f"{len(hi)} hi and {len(lo)} lo slabs")
        if self.cuda:
            self._launch(0, e, [t for pair in zip(hi, lo) for t in pair],
                         None)
            launches[self._key("ring_send", hi[0])] += 1
        else:
            self._plain_send(hi, lo, e)
        self.sent = e
        return e

    def drain(self, epoch: int):
        """Take epoch ``epoch``'s slabs out of this process's slots:
        ``(from_left, from_right)``, one fresh slab per local shard each."""
        self._usable()
        if epoch != self.drained + 1 or epoch > self.sent:
            raise RuntimeError(f"{self}: drain of epoch {epoch} out of "
                               f"order (drained {self.drained}, sent "
                               f"{self.sent})")
        shape = tuple(self.meta["shape"])
        if self.cuda:
            out = torch.empty((self.S, 2) + shape, dtype=self.dtype,
                              device=self.device)
            self._launch(1, epoch, None, out)
            launches[self._key("ring_drain", out)] += 1
        else:
            out = self._plain_drain(epoch)
        self.drained = epoch
        return [out[t, 0] for t in range(self.S)], \
            [out[t, 1] for t in range(self.S)]

    def _usable(self) -> None:
        if self.closed:
            raise RuntimeError(f"{self}: its regions are closed")
        self.check()

    def _launch(self, drain: int, epoch: int, srcs, out) -> None:
        lib = _lib()
        slot = epoch % self.nslots
        n = 2 * self.S
        esize = _itemsize(self.dtype)
        if drain:
            src, ready, credit, peer = self._drain[slot]
            dst = (_c_ptr * n)(*[out[t, d].data_ptr()
                                 for t in range(self.S) for d in (0, 1)])
        else:
            dst, ready, credit, peer = self._send[slot]
            shape = tuple(self.meta["shape"])
            _build.check_operands("ring_send", *srcs, shape=shape,
                                  dtype=_build.FLOAT_DTYPES)
            if srcs[0].dtype != self.dtype:
                raise TypeError(f"{self}: {self.dtype} slabs, got "
                                f"{srcs[0].dtype}")
            # the unit is the site's, the same in every process: a slab
            # that does not start on it is copied to one that does
            srcs = [t if t.data_ptr() % self.unit == 0 else t.clone()
                    for t in srcs]
            src = (_c_ptr * n)(*[t.data_ptr() for t in srcs])
        runs, run_len, run_stride, chunk_stride = self.geometry
        u = self.unit // esize
        rc = lib.ring_peer_launch(
            drain, self.device.index, self.S, src, dst, ready, credit, peer,
            self.meta["nchunks"], epoch, self.nslots, self.id, runs,
            run_len // u, run_stride // u, chunk_stride // u, self.unit,
            self.timeout_s, self._record,
            _c_ptr(torch.cuda.current_stream(self.device).cuda_stream))
        _build.check(lib, rc, f"{'ring_drain' if drain else 'ring_send'} "
                     f"({self})")

    def _slot(self, r: int, slot: int, d: int, t: int) -> torch.Tensor:
        off = self._slot_off(slot, d, t)
        return self.regions[r][off:off + self.meta["slab_bytes"]].view(
            self.dtype).view(tuple(self.meta["shape"]))

    def _flags(self, r: int, which: str, t: int, d: int) -> torch.Tensor:
        off = self._flag_off(which, t, d)
        return self.regions[r][off:off + 4 * self.layout["flags"]].view(
            torch.int32)

    def _await(self, flags, c: int, want: int, what: str, epoch: int, t: int,
               d: int, peer: int) -> None:
        """Poll ``flags[c]`` until it reaches ``want``, or raise at the
        deadline."""
        if int(flags[c]) >= want:
            return
        deadline = time.monotonic() + self.timeout_s
        nap = 1e-4
        while int(flags[c]) < want:
            if time.monotonic() > deadline:
                raise PeerTimeout(self._timeout_message(
                    what, epoch, t, d, c, peer, want))
            time.sleep(nap)
            nap = min(2 * nap, 1e-2)

    def _timeout_message(self, what, epoch, t, d, c, peer, want) -> str:
        side = ("its ready flag (the slab of epoch {e} from process {p})"
                if what == "ring_drain" else
                "its credit (process {p} to drain epoch {w})").format(
                    e=epoch, p=peer, w=want)
        return (f"{what}: {self} waited {self.timeout_s:g} s for chunk {c} "
                f"of epoch {epoch}, local shard {t}, direction {d}: "
                f"{side}; process {peer} is gone or stalled (the bound is "
                "MPI_CUDA_PROCESS_TORCH_DIST_TIMEOUT)")

    def _plain_send(self, hi, lo, e: int) -> None:
        axis, nc = self.meta["chunk_axis"], self.meta["nchunks"]
        csize = self.meta["shape"][axis] // nc
        slot = e % self.nslots
        for s in range(self.S):
            for d, src in ((0, hi[s]), (1, lo[s])):
                r, t = self.to[s][d]
                dst = self._slot(r, slot, d, t)
                credit = self._flags(self.rank, "credit", s, d)
                ready = self._flags(r, "ready", t, d)
                for c in range(nc):
                    self._await(credit, c, e - self.nslots, "ring_send", e,
                                s, d, r)
                    _chunk(dst, axis, c, csize).copy_(
                        _chunk(src, axis, c, csize))
                    ready[c] = e

    def _plain_drain(self, e: int) -> torch.Tensor:
        axis, nc = self.meta["chunk_axis"], self.meta["nchunks"]
        csize = self.meta["shape"][axis] // nc
        slot = e % self.nslots
        out = torch.empty((self.S, 2) + tuple(self.meta["shape"]),
                          dtype=self.dtype, device=self.device)
        for t in range(self.S):
            for d in (0, 1):
                r, s = self.frm[t][d]
                src = self._slot(self.rank, slot, d, t)
                ready = self._flags(self.rank, "ready", t, d)
                credit = self._flags(r, "credit", s, d)
                for c in range(nc):
                    self._await(ready, c, e, "ring_drain", e, t, d, r)
                    _chunk(out[t, d], axis, c, csize).copy_(
                        _chunk(src, axis, c, csize))
                    credit[c] = e
        return out

    # -- checks and teardown ----------------------------------------------

    def check(self) -> None:
        """Raise :class:`PeerTimeout` if a kernel of this process recorded
        a timed-out wait (reads mapped host memory: no synchronization)."""
        if not self.cuda:
            return
        rec = [ctypes.c_int.from_address(self._record + 4 * i).value
               for i in range(8)]
        if rec[0]:
            site = _SITES[rec[1]] if rec[1] < len(_SITES) else rec[1]
            what = "ring_drain" if rec[0] == 1 else "ring_send"
            msg = (site._timeout_message(what, rec[2], rec[3], rec[4],
                                         rec[5], rec[6], rec[7])
                   if isinstance(site, PeerSite) else f"site {site}")
            raise PeerTimeout(msg)

    def _region_ints(self, which: str) -> List[int]:
        """Every int of this process's ``which`` flags (a synchronizing
        read on the card)."""
        n = 2 * self.S * self.layout["flags"]
        if not self.cuda:
            off = self.layout[which]
            return self.regions[self.rank][off:off + 4 * n].view(
                torch.int32).tolist()
        host = (ctypes.c_int * n)()
        _build.check(_lib(), _lib().peer_region_read(
            self.device.index, host, self._own + self.layout[which], 4 * n),
            f"{self}: read of its {which} flags")
        return list(host)

    def check_drained(self) -> None:
        """Collective: once every process has drained (each synchronizes,
        then a barrier), every ready flag and every credit of this
        process's region holds the last epoch: every block of every chunk
        landed once and was drained once."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.group.barrier()
        self.check()
        for which in ("ready", "credit"):
            got = self._region_ints(which)
            bad = [i for i, v in enumerate(got) if v != self.drained]
            if bad or self.sent != self.drained:
                i = bad[0] if bad else 0
                per = self.layout["flags"]
                raise AssertionError(
                    f"{self}: {len(bad)} {which} entries not at the last "
                    f"epoch {self.drained} (sent {self.sent}); first: local "
                    f"shard {i // (2 * per)}, direction {i // per % 2}, "
                    f"chunk {i % per // self.blocks} reads "
                    f"{got[i] if bad else self.drained}")

    def close_peers(self) -> None:
        """Unmap every peer's region (before any peer frees its own)."""
        if self.cuda:
            for p in self._opened:
                _build.check(_lib(), _lib().peer_region_close(
                    self.device.index, p), f"{self}: cudaIpcCloseMemHandle")
        self._opened = []
        if not self.cuda:
            self.regions = [r if i == self.rank else None
                            for i, r in enumerate(self.regions)]
        self.closed = True

    def free(self) -> None:
        """Free this process's region (once every peer has closed it)."""
        self.close_peers()
        if self.cuda and self._own:
            _build.check(_lib(), _lib().peer_region_free(self.device.index,
                                                         self._own),
                         f"{self}: cudaFree of its region")
            self._own = 0
        if not self.cuda:
            self.regions = []


def _indexed_device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def close_peer_regions() -> None:
    """Unmap every peer region this process opened (the first half of the
    teardown: ``mesh.shutdown_distributed`` then waits for every process
    before any frees its own)."""
    for site in _SITES:
        if not site.closed:
            site.close_peers()


def free_peer_regions() -> None:
    """Free every region this process allocated (after every peer closed
    it) and forget the sites."""
    for site in _SITES:
        site.free()
    _SITES.clear()


def plain_peer_shift(hi, lo, frm):
    """The function of a post and its drain, taken directly: for every
    local shard t of a ring of one process, ``(from_left, from_right)`` —
    the hi slab of the shard that sends t's direction 0 and the lo slab of
    the one that sends direction 1 (``frm[t]``), as copies."""
    return ([hi[frm[t][0][1]].clone() for t in range(len(frm))],
            [lo[frm[t][1][1]].clone() for t in range(len(frm))])
