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
the shards that share a card.  A ring across cards (peer writes over
NVLink, system-scope flags) is ROADMAP B7; the transport refuses it by
name.  The kernel copies units and never reads them as numbers: 16 bytes
where every run, stride and pointer aligns to them, else one element (4
bytes in float32, 2 in bfloat16).  Bound on an H100: device-memory bytes,
each slab read once and each received slab written once.

Plain PyTorch version: :func:`plain_ring_exchange`, the same protocol
(per chunk: land it, count it) walked in order, its drained invariant
asserted.  A wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import _build
from .fused import _sublane

# Launches, keyed "ring_exchange[4x512x1024]" by slab shape (bfloat16:
# "ring_exchange[4x512x1024,bfloat16]"): one added where the kernel
# launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

# The TPU ring's slots per direction (its default, 2): the port stages
# nothing, but the depth sets the chunk ladder (_nc_ladder) and the meta.
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
