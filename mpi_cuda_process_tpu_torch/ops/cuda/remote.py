"""The ring-exchange kernel (TPU table row 19): ``ring_exchange``.

``ring_exchange`` (``csrc/remote.cu::ring_exchange``) moves both ring
directions of one mesh axis for one slab pair — every shard's ``hi`` slab to
the next shard (its ``from_left``), every ``lo`` slab to the previous one
(its ``from_right``) — chunk by chunk through an ``nslots``-deep receive
ring with ready and credit counters, for every ring of shards that lives on
one device, in one cooperative launch.  The ring is always full, as in the
TPU package: the wall shards send and receive too, and the caller
(``parallel/halo.py``) overwrites the walls' received slabs with the guard
constant.

Replaces the TPU package's ``ops/pallas/remote.py``:
``build_ring_exchange_call`` (``_ring_kernel``), with ``_NSLOTS``,
``_nc_ladder``, ``pick_chunks`` and ``ring_exchange_stats`` kept under their
names and with their results: the chunk geometry is the kernel's public
meta.  The TPU's loopback mode has no counterpart: the ring runs for real
between the shards that share a card.  A ring across cards (peer writes
over NVLink) is ROADMAP B7; the transport refuses it by name.  The kernel
copies units and never reads them as numbers: 16 bytes where every run,
stride and pointer aligns to them, else one element (4 bytes in float32, 2
in bfloat16).  Bound on an H100: device-memory bytes, each slab read once
and each received slab written once.

Plain PyTorch version: :func:`plain_ring_exchange`, the same protocol (chunk
loop, slots, counters) walked in order, its drained invariant asserted.  A
wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from . import _build
from .fused import _sublane

# Launches, keyed "ring_exchange[4x512x1024]" by slab shape (bfloat16:
# "ring_exchange[4x512x1024,bfloat16]"): one added where the kernel
# launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

# Ring slots per direction: 2 lets chunk i+1's send overlap chunk i's drain
# (capacity-2 credit flow control), the TPU package's default.
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
    """What every ready and credit counter of slot q holds after a launch
    whose (direction, shard) pairs ran ``blocks`` blocks each: ``blocks``
    times the uses of the slot."""
    nc, nslots = meta["nchunks"], meta["nslots"]
    return [blocks * ((nc - q + nslots - 1) // nslots) for q in range(nslots)]


class RingState:
    """The receive rings and counters of one exchange site on one device:
    ``recv`` (S, 2, nslots, chunk elements), ``counters`` (S, 2, 2, nslots)
    int32 — shard, ready/credit, direction, slot — and ``blocks``, the
    blocks of each (direction, shard) pair in the last launch (1 for the
    plain version)."""

    def __init__(self, meta, n_shards: int, device, dtype):
        runs, run_len, _, _ = _geometry(meta)
        self.recv = torch.empty(
            (n_shards, 2, meta["nslots"], runs * run_len), dtype=dtype,
            device=device)
        self.counters = torch.zeros((n_shards, 2, 2, meta["nslots"]),
                                    dtype=torch.int32, device=device)
        self.blocks = 1
        self._grid = {}  # unit bytes -> blocks of a launch

    def check_drained(self, meta) -> None:
        """Raise unless every counter equals ``blocks`` times its slot's
        uses (reads the counters: a synchronizing copy on a card)."""
        want = drained_counts(meta, self.blocks)
        got = self.counters.cpu().tolist()
        for s, per in enumerate(got):
            for which, name in ((0, "ready"), (1, "credit")):
                for d in (0, 1):
                    if per[which][d] != want:
                        raise AssertionError(
                            f"ring_exchange: shard {s} direction {d} {name} "
                            f"counters {per[which][d]}, drained is {want}")


def _chunk(t: torch.Tensor, axis: int, c: int, csize: int) -> torch.Tensor:
    return t.narrow(axis, c * csize, csize)


def plain_ring_exchange(hi: Sequence[torch.Tensor],
                        lo: Sequence[torch.Tensor], nxt: Sequence[int],
                        prv: Sequence[int], meta, state: RingState):
    """The plain version of :func:`ring_exchange`: the protocol walked in
    order, one block per (direction, shard) — per chunk every send (credit
    check, copy into the neighbour's slot, ready signal), then every drain
    (ready check, copy out, credit) — and the drained invariant asserted.
    Returns ``(from_left, from_right)``: ``from_left[i] == hi[prv[i]]``,
    ``from_right[i] == lo[nxt[i]]``."""
    S = len(hi)
    axis, nc, nslots = meta["chunk_axis"], meta["nchunks"], meta["nslots"]
    csize = meta["shape"][axis] // nc
    G = state.blocks = 1
    # [shard][0 ready / 1 credit][direction][slot]
    cnt = [[[[0] * nslots for _ in (0, 1)] for _ in (0, 1)]
           for _ in range(S)]
    srcs, dests = (hi, lo), (nxt, prv)
    outs = ([torch.empty_like(h) for h in hi],
            [torch.empty_like(x) for x in lo])
    for c in range(nc):
        q, u = c % nslots, c // nslots
        for s in range(S):
            for d in (0, 1):
                to = dests[d][s]
                assert cnt[to][1][d][q] >= G * u, "send before credit"
                state.recv[to, d, q].copy_(
                    _chunk(srcs[d][s], axis, c, csize).reshape(-1))
                cnt[to][0][d][q] += G
        for s in range(S):
            for d in (0, 1):
                assert cnt[s][0][d][q] >= G * (u + 1), "drain before ready"
                dst = _chunk(outs[d][s], axis, c, csize)
                dst.copy_(state.recv[s, d, q].view(dst.shape))
                cnt[s][1][d][q] += G
    state.counters.copy_(torch.tensor(cnt, dtype=torch.int32))
    state.check_drained(meta)
    return outs


def _lib():
    lib = _build.load("remote")
    if lib.ring_exchange_launch.argtypes is None:
        pp = ctypes.POINTER(_c_ptr)
        lib.ring_exchange_launch.argtypes = (
            [_c_int] + [pp] * 7 + [ctypes.POINTER(_c_int)] * 2
            + [_c_int] * 2 + [_c_long] * 4 + [_c_int] * 2 + [_c_ptr])
        lib.ring_exchange_blocks.argtypes = [
            _c_int, _c_long, _c_int, ctypes.POINTER(_c_int)]
    return lib


def _ptrs(values) -> ctypes.Array:
    return (_c_ptr * len(values))(*values)


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
    if sorted(nxt) != list(range(S)) or \
            any(prv[nxt[i]] != i for i in range(S)):
        raise ValueError("ring_exchange: nxt and prv must be inverse "
                         "permutations of the shards")
    out = torch.empty((2, S) + shape, dtype=hi[0].dtype, device=hi[0].device)
    runs, run_len, run_stride, chunk_stride = _geometry(meta)
    slabs = [t.data_ptr() for t in (*hi, *lo)] + [out.data_ptr(),
                                                  state.recv.data_ptr()]
    esize = out.element_size()
    # 16-byte units where every run, stride and pointer aligns to them,
    # else one element each
    per16 = 16 // esize
    aligned = (all(v % per16 == 0 for v in (run_len, run_stride,
                                            chunk_stride))
               and all(p % 16 == 0 for p in slabs))
    unit_bytes = 16 if aligned else esize
    unit = unit_bytes // esize  # elements per unit
    lib = _lib()
    if unit_bytes not in state._grid:
        g = _c_int(0)
        _build.check(lib, lib.ring_exchange_blocks(
            S, runs * run_len // unit, unit_bytes, ctypes.byref(g)),
            "ring_exchange_blocks")
        state._grid[unit_bytes] = g.value
    state.blocks = G = state._grid[unit_bytes]
    ring = meta["nslots"] * runs * run_len * 2 * esize  # one shard's rings
    slab = out[0, 0].numel() * esize
    cbase, cstep = state.counters.data_ptr(), 4 * meta["nslots"] * 4
    state.counters.zero_()
    rc = lib.ring_exchange_launch(
        S, _ptrs([t.data_ptr() for t in hi]),
        _ptrs([t.data_ptr() for t in lo]),
        _ptrs([out.data_ptr() + i * slab for i in range(S)]),
        _ptrs([out.data_ptr() + (S + i) * slab for i in range(S)]),
        _ptrs([state.recv.data_ptr() + i * ring for i in range(S)]),
        _ptrs([cbase + i * cstep for i in range(S)]),
        _ptrs([cbase + i * cstep + 2 * meta["nslots"] * 4
               for i in range(S)]),
        (_c_int * S)(*nxt), (_c_int * S)(*prv), meta["nchunks"],
        meta["nslots"], runs, run_len // unit, run_stride // unit,
        chunk_stride // unit, unit_bytes, G, _build.stream_of(hi[0]))
    _build.check(lib, rc, "ring_exchange")
    launches[_build.launch_key("ring_exchange", "x".join(map(str, shape)),
                               hi[0])] += 1
    return list(out[0]), list(out[1])


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
    :func:`ring_exchange` on S shards' slabs (one device), with receive
    rings and counters kept per (device, S) and reused by every call;
    ``call.state`` is the last call's :class:`RingState`.  ``meta`` holds
    the TPU package's keys (shape, dtype, chunk_axis, nchunks, nslots,
    slab_bytes, chunk_bytes, remote_dma_per_call, ici_bytes_per_call).
    ``nslots`` (ring depth, default 2) and ``prefer_nc`` (a preferred
    chunk count, still gated by :func:`pick_chunks`) are the TPU package's
    variant knobs; ``chunks`` forces ``(axis, nchunks)``.  With a CUDA
    ``device`` the kernel is built here, before the time loop.
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
            states[key] = RingState(meta, len(hi), hi[0].device,
                                    hi[0].dtype)
        call.state = states[key]
        return ring_exchange(hi, lo, nxt, prv, meta, call.state)

    call.state = None
    return call, meta
