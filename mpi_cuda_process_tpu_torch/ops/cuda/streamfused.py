"""The streaming k-step kernel, K10 (TPU table rows 16-18).

``stream_step`` (``csrc/streamfused.cu``, the kernel in ``csrc/ring.cuh``,
``SRC = RAW``) advances heat3d, heat3d27, heat3d4th, wave3d, advect3d,
grayscott3d (a ring for each field at every level) or sor3d (2k
one-colour half-sweeps) by k guard-frame steps in one launch over the
whole grid: every K3 family.  Each block marches a (TY, TX) column of the
grid down z as a wavefront in time, so every plane of its window is read
from device memory once per pass (K3 re-reads the z margin of every
window).  ``stream_zslab`` (``ZSLAB``) does the same for a z-only shard
from its core and its two exchanged z slabs; ``stream_yzslab``
(``YZSLAB``) for a shard of a mesh that shards y, from the core, the z and
y slabs and the four corner pieces of ``halo.exchange_slabs_2axis`` at
their natural widths.

The wavefront is skewed (level s computes plane p + 1 - s(h + 1) in
iteration p), so all its levels update between one barrier and the next;
``ring_slots`` gives the planes each level's ring must hold for that, and
every launch passes them to the kernel, so the CPU test of the schedule
(``tests/test_torch_stream.py``) holds the counts the card runs.
``TILES`` picks the column and threads per (stencil, dtype, k); ``PATHS``
the block-uniform fast paths (16-byte row copies, no y/x frame test).

Replaces the TPU package's ``ops/pallas/streamfused.py``:
``make_stream_fused_step`` (``_stream_kernel``),
``build_stream_sharded_call`` (``_stream_sharded_kernel``) and
``build_stream_2axis_call`` (``_stream_2axis_kernel``), all three
``_stream_body``.  The builders keep the JAX names and the gates that are
not TPU rules: guard-frame only (``periodic`` gives None), the 3D fused
families, local z (and y) extents at least the margin m (``k_step_margin``:
k * halo, 2k for sor3d).  The
TPU's strip rules are dropped: the sublane-rounded margin ``wm_a`` and the
y-operand padding (``_align``), ``_pick_strip``, ``_BZ_LADDER``,
``_XSHELL``, ``_strip_live_bytes`` and ``Lz // bz >= 3``; the kernel masks
ragged columns and runs any k whose rings fit shared memory.  The policy
knobs ``tiles``, ``margin`` and ``order`` raise (ROADMAP A8).  Bound on an
H100: device-memory bytes, as for K3.

Every wrapper takes batched operands (an ensemble run's leading member
axis, ``make_stream_fused_step(batch=N)`` and the sharded steppers'
``ensemble=N``): the launch grid's z takes one column march per member
(the TPU kernel's leading batch grid dimension), each priming its own
rings as a new chunk does, so N members run in one launch.

Each wrapper takes float32 or bfloat16 fields (``_build.FLOAT_DTYPES``:
an ``_f32`` and a ``_bf16`` entry point of one source).  A bfloat16 launch
keeps its rings in bfloat16 too: the plain step rounds every level to
bfloat16, so the rings hold the same values in half the shared memory
(``smem_bytes`` counts the stencil's itemsize), and the kernel stays
bit-equal to the plain version.

Plain PyTorch versions: those of K3, K6 and K9 (``fused.py``), the same
function — k plain steps of the window.  A wrapper takes its plain version
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..stencil import Fields, Stencil, dtype_name, k_step_margin
from . import _build
from .fused import (_FUSED, SMEM_LIMIT, _pointers, plain_steps, plain_yzslab,
                    plain_zslab)
from .rawstep import coefficients

# Launches per wrapper and stencil, keyed "stream_step[heat3d]",
# "stream_zslab[heat3d]" or "stream_yzslab[heat3d]" (bfloat16:
# "stream_step[heat3d,bfloat16]", ``_build.launch_key``): one added where
# the kernel launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

# Level-0 planes a launch keeps in flight (csrc/ring.cuh IN_FLIGHT): the
# ring of loaded planes holds them beside the 2h + 1 that level 1 reads.
IN_FLIGHT = 2
# Level 0's x margin is rounded up to this many cells (csrc/ring.cuh
# X_ALIGN: 16 bytes of either type), so its rows copy in 16-byte units.
X_ALIGN = 8
# The column every (stencil, k) is admitted at (``fits``): the smallest
# (TY, TX) the launches take, so a deep k still fits; and the threads of a
# launch that has no TILES entry.
FIT_TILE = (8, 32)
THREADS = 512
# The launch tile per (stencil, dtype, k): the core column (TY, TX), the
# block's threads and the blocks an SM its build is for (1 or 2: a block of
# 512 threads at 128 registers a thread, or two at 64; csrc/ring.cuh), the
# fastest of scripts/torch_stream_tiles.py's candidates on an H100 at 512^3
# (for heat3d and wave3d also weighed on a 1024^3 2x2 shard and a --mesh 4
# shard).  A pair not listed, or a tile whose rings overflow shared memory
# or whose levels outnumber its warps, takes FIT_TILE with THREADS (or one
# warp a level).
_T512, _T1024 = (32, 64, 512, 1), (32, 64, 1024, 1)
_T2 = (32, 32, 512, 2)
TILES = {
    ("heat3d", "float32", 4): _T512, ("heat3d", "bfloat16", 4): _T2,
    ("heat3d", "bfloat16", 8): _T1024,
    ("heat3d27", "float32", 4): _T512, ("heat3d27", "bfloat16", 4): _T1024,
    ("heat3d4th", "float32", 2): _T512,
    ("heat3d4th", "bfloat16", 2): _T1024,
    ("heat3d4th", "bfloat16", 4): _T1024,
    ("wave3d", "float32", 4): (32, 32, 512, 1), ("wave3d", "bfloat16", 4): _T2,
    ("wave3d", "bfloat16", 8): (32, 32, 1024, 1),
    ("advect3d", "float32", 4): _T512, ("advect3d", "bfloat16", 4): _T1024,
    ("grayscott3d", "float32", 4): (16, 64, 512, 1),
    ("grayscott3d", "bfloat16", 4): _T1024,
    ("sor3d", "float32", 4): (32, 32, 512, 1),
    ("sor3d", "bfloat16", 2): _T1024, ("sor3d", "bfloat16", 4): _T1024,
}
# The kernel's fast paths (csrc/ring.cuh ``paths``): 16-byte row copies,
# where every operand's address is 16-byte aligned; no y/x frame test
# where no updated cell is frame.  PATHS is what every launch allows (0
# runs the per-cell path alone: the CUDA tests, scripts/torch_stream_tiles).
VEC_LOAD, FRAME_FREE = 1, 2
PATHS = VEC_LOAD | FRAME_FREE


def level_warps_fit(levels: int, threads: int) -> bool:
    """Whether a block of ``threads`` has a warp for each of ``levels``
    levels."""
    return levels <= threads // 32


# The K3 families the streaming kernel has a kind for: all of them.
_STREAM = ("heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
           "grayscott3d", "sor3d")

_POLICY_ITEM = "ROADMAP A8 (policy)"

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def stream_supported(stencil: Stencil) -> bool:
    """Whether the streaming kernel has a kind for ``stencil`` (every 3D
    family of K3)."""
    return stencil.name in _STREAM and stencil.ndim == 3


def levels(stencil: Stencil, k: int) -> int:
    """The wavefront's levels: one per step, one per half-sweep for SOR
    (``k_step_margin // halo``)."""
    return k_step_margin(stencil, k) // stencil.halo


def ring_slots(stencil: Stencil, k: int) -> Tuple[int, int]:
    """``(S0, S1)``: the planes of level 0's rings and of each ring of
    levels 1..K-1 under the skewed schedule of csrc/ring.cuh, where level s
    computes plane ``p + 1 - s(h + 1)`` in iteration p.  Level s+1 reads
    planes z - 2h - 1 .. z - 1 of level s while level s writes z: 2h + 2.
    Level 1 reads loaded planes p - 2h .. p while IN_FLIGHT more are in
    flight: 2h + 1 + IN_FLIGHT.  Wave's level s reads level s-2's u at its
    own plane as u_prev, one plane further back: one more slot for levels
    that have such a reader (level 0 once K >= 2, levels >= 1 once K >= 3).
    Every launch passes these counts to the kernel, and the CPU tests of the
    schedule (tests/test_torch_stream.py, tests/test_torch_2d.py: K8's
    streaming kind, whose planes are rows) run on exactly them."""
    h = stencil.halo
    K = levels(stencil, k)
    wave = stencil.name in ("wave3d", "wave2d")
    return (2 * h + 1 + IN_FLIGHT + (wave and K >= 2),
            2 * h + 2 + (wave and K >= 3))


def ring_cells(stencil: Stencil, k: int, tile: Sequence[int]) -> int:
    """Cells of the block's rings at column ``tile``, as csrc/ring.cuh's
    ``Geom`` lays them out.  3D: ``tile`` = (TY, TX, ...), level s's region
    (TY + 2(K-s)h, TX + 2(K-s)h); 2D (K8's streaming kind): ``tile`` =
    (TX, ...), one row of TX + 2(K-s)h.  Level 0's ring of loaded planes
    spans TY + 2m rows (2D: one) and TX + 2mu columns, mu = m rounded up
    to X_ALIGN (wave's u_prev and Gray-Scott's v have a second), then each
    level s = 1..K-1's ring (Gray-Scott: one for u, one for v)."""
    if stencil.ndim == 2:
        ty, tx, rows = 1, int(tile[0]), 0
    else:
        ty, tx, rows = int(tile[0]), int(tile[1]), 1
    h = stencil.halo
    K = levels(stencil, k)
    m = K * h
    mu = -(-m // X_ALIGN) * X_ALIGN
    s0, s1 = ring_slots(stencil, k)
    mid = sum(s1 * (ty + 2 * rows * (K - s) * h) * (tx + 2 * (K - s) * h)
              for s in range(1, K))
    nf = stencil.num_fields
    gs = nf == 2 and all(stencil.field_halos)
    return (nf * s0 * (ty + 2 * rows * m) * (tx + 2 * mu)
            + (2 if gs else 1) * mid)


def smem_bytes(stencil: Stencil, k: int, tile=FIT_TILE) -> int:
    """Shared memory of one block's rings at column ``tile``, in the
    stencil's dtype (4 bytes a cell, 2 in bfloat16)."""
    return stencil.dtype.itemsize * ring_cells(stencil, k, tile)


def fits(stencil: Stencil, k: int) -> bool:
    """Whether (stencil, k) has a kernel: its rings fit one block at
    FIT_TILE and a block of 1024 threads has a warp a level."""
    return (stream_supported(stencil) and k >= 1
            and level_warps_fit(levels(stencil, k), 1024)
            and smem_bytes(stencil, k) <= SMEM_LIMIT)


def tile_of(stencil: Stencil, k: int) -> Tuple[int, int, int, int]:
    """The launch tile ``(TY, TX, threads, blocks)``: the TILES entry where its
    rings fit and it has a warp for every level, else FIT_TILE."""
    tile = TILES.get((stencil.name, dtype_name(stencil.dtype), int(k)))
    return _fit(stencil, k, tile, FIT_TILE)


def _fit(stencil: Stencil, k: int, tile,
         fallback) -> Tuple[int, int, int, int]:
    """``tile`` where its rings fit and it has a warp a level, else
    ``fallback`` (its column) with THREADS or the fewest warps that give
    every level one, two blocks an SM where a block holds 512 threads or
    fewer."""
    K = levels(stencil, k)
    if tile is None or not level_warps_fit(K, tile[2]) \
            or smem_bytes(stencil, k, tile) > SMEM_LIMIT:
        threads = THREADS
        while not level_warps_fit(K, threads):
            threads += 32
        return tuple(fallback[:2]) + (threads, 2 if threads <= 512 else 1)
    return tuple(tile)


def launch_paths(operands) -> int:
    """The fast paths a launch on ``operands`` may take: PATHS, without the
    16-byte row copies where an operand's address is off 16 bytes."""
    if any(t.data_ptr() % 16 for t in operands):
        return PATHS & ~VEC_LOAD
    return PATHS


def _tail(stencil: Stencil, k: int, operands, members: int = 0):
    """The exports' trailing arguments: coefficients, the tile, the ring
    slots and the fast paths, the members of a batched launch (1
    unbatched), then the stream."""
    return (*coefficients(stencil), *tile_of(stencil, k),
            *ring_slots(stencil, k), launch_paths(operands),
            max(1, members), _build.stream_of(operands[0]))


def _lib():
    lib = _build.load("streamfused")
    if lib.stream_step_f32.argtypes is None:
        tail = [_c_float] * 5 + [_c_int] * 8 + [_c_ptr]
        for sfx in _build.SUFFIXES.values():
            getattr(lib, f"stream_step_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 4 + tail)
            getattr(lib, f"stream_zslab_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 8 + [_c_int] * 6 + tail)
            getattr(lib, f"stream_yzslab_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 20 + [_c_int] * 9 + tail)
    return lib


def _gate(what: str, stencil: Stencil, k: int) -> int:
    """The kernel kind of ``stencil``; raises where no kernel fits."""
    if not fits(stencil, k):
        raise ValueError(f"{what}: {stencil.name} k={k} has no streaming "
                         f"kernel within {SMEM_LIMIT} bytes of shared memory")
    return _FUSED[stencil.name][0]


def stream_step(fields: Fields, stencil: Stencil, k: int) -> Fields:
    """``k`` guard-frame steps of ``stencil`` on the whole grid in one
    launch (every member of batched ``(N, Z, Y, X)`` fields in it)."""
    if not fields[0].is_cuda:
        return plain_steps(fields, stencil, k)
    kind = _gate("stream_step", stencil, k)
    n, (Z, Y, X) = _build.batch_of(fields[0])
    _build.check_operands("stream_step", *fields, shape=(Z, Y, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty_like(f) for f in fields)
    two = len(fields) == 2
    lib = _lib()
    rc = _build.entry(lib, "stream_step", fields[0])(
        kind, *_pointers(fields, two), *_pointers(outs, two), Z, Y, X, k,
        *_tail(stencil, k, fields, n))
    _build.check(lib, rc, "stream_step")
    launches[_build.launch_key("stream_step", stencil.name, fields[0],
                               n)] += 1
    return outs


def stream_zslab(core: Fields, zlo: Fields, zhi: Fields, stencil: Stencil,
                 k: int, global_z: int, origin_z: int) -> Fields:
    """``k`` guard-frame steps of one z-only shard from its (Lz, Y, X)
    core and the exchanged (m, Y, X) z slabs below (``zlo``) and above
    (``zhi``) it, per field; ``origin_z`` is the core's first global z
    plane of ``global_z``.  Returns the core fields, k steps on (batched
    ``(N, ...)`` operands: every member's, in one launch)."""
    m = k_step_margin(stencil, k)
    n, (Lz, Y, X) = _build.batch_of(core[0])
    if not core[0].is_cuda:
        return plain_zslab(core, zlo, zhi, stencil, k, global_z, origin_z)
    kind = _gate("stream_zslab", stencil, k)
    _build.check_operands("stream_zslab", *core, shape=(Lz, Y, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    _build.check_operands("stream_zslab", core[0], *zlo, *zhi,
                          dtype=_build.FLOAT_DTYPES, members=n)
    _build.check_operands("stream_zslab", *zlo, *zhi, shape=(m, Y, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty_like(c) for c in core)
    two = len(core) == 2
    lib = _lib()
    rc = _build.entry(lib, "stream_zslab", core[0])(
        kind, *_pointers(core, two), *_pointers(zlo, two),
        *_pointers(zhi, two), *_pointers(outs, two), Lz, Y, X,
        int(global_z), int(origin_z), k,
        *_tail(stencil, k, (*core, *zlo, *zhi), n))
    _build.check(lib, rc, "stream_zslab")
    launches[_build.launch_key("stream_zslab", stencil.name, core[0],
                               n)] += 1
    return outs


def stream_yzslab(core: Fields, zlo: Fields, zhi: Fields, ylo: Fields,
                  yhi: Fields, corners: Sequence[Fields], stencil: Stencil,
                  k: int, global_shape: Sequence[int],
                  origins: Sequence[int]) -> Fields:
    """``k`` guard-frame steps of one shard of a mesh that shards y, from
    the operands of ``fused.fused_yzslab`` (the core, two z slabs, two y
    slabs and the corners ll, lh, hl, hh, per field).  Returns the
    (Lz, Ly, X) core of every field, k steps on (batched ``(N, ...)``
    operands: every member's, in one launch)."""
    m = k_step_margin(stencil, k)
    n, (Lz, Ly, X) = _build.batch_of(core[0])
    if not core[0].is_cuda:
        return plain_yzslab(core, zlo, zhi, ylo, yhi, corners, stencil, k,
                            global_shape, origins)
    kind = _gate("stream_yzslab", stencil, k)
    _build.check_operands("stream_yzslab", *core, shape=(Lz, Ly, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    for pieces, shape in ((zlo, (m, Ly, X)), (zhi, (m, Ly, X)),
                          (ylo, (Lz, m, X)), (yhi, (Lz, m, X)),
                          *((c, (m, m, X)) for c in corners)):
        _build.check_operands("stream_yzslab", core[0], *pieces, shape=None,
                              dtype=_build.FLOAT_DTYPES, members=n)
        _build.check_operands("stream_yzslab", *pieces, shape=shape,
                              dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty_like(c) for c in core)
    two = len(core) == 2
    lib = _lib()
    GZ, GY, GX = (int(g) for g in global_shape)
    oz, oy = (int(o) for o in origins)
    rc = _build.entry(lib, "stream_yzslab", core[0])(
        kind, *_pointers(core, two), *_pointers(zlo, two),
        *_pointers(zhi, two), *_pointers(ylo, two), *_pointers(yhi, two),
        *(p for c in corners for p in _pointers(c, two)),
        *_pointers(outs, two), Lz, Ly, X, GZ, GY, GX, oz, oy, k,
        *_tail(stencil, k, (*core, *zlo, *zhi, *ylo, *yhi,
                            *(p for c in corners for p in c)), n))
    _build.check(lib, rc, "stream_yzslab")
    launches[_build.launch_key("stream_yzslab", stencil.name, core[0],
                               n)] += 1
    return outs


def _refuse_policy(tiles, margin, order) -> None:
    if tiles is not None or margin or order:
        raise NotImplementedError(
            "streaming-kernel tiles/margin/order are not ported: "
            f"{_POLICY_ITEM}")


def _prepare(device) -> None:
    """Build the kernels before the time loop when the run is on a card."""
    if device is not None and torch.device(device).type == "cuda":
        _lib()


def make_stream_fused_step(
    stencil: Stencil,
    global_shape: Sequence[int],
    k: int,
    tiles=None,
    batch: int = 0,
    margin: int = 0,
    order: str = "",
    device=None,
) -> Optional[Callable[[Fields], Fields]]:
    """``fields -> fields`` advancing ``k`` guard-frame steps in one
    streaming pass (row 16), or None: not a 3D fused family, or rings too
    large for shared memory (at FIT_TILE, in float32: heat3d, heat3d27 and
    advect3d k >= 13, wave3d k >= 11, grayscott3d k >= 9, heat3d4th
    k >= 8, sor3d k >= 7; in bfloat16 heat3d, heat3d27 and advect3d
    k >= 19, wave3d k >= 16, grayscott3d k >= 13, heat3d4th k >= 11,
    sor3d k >= 10).  Semantically
    ``k`` applications of ``driver.make_step``; any k >= 1 and any grid
    extent.

    ``batch=N`` (an ensemble run): the step takes and returns fields with
    a leading member axis of N, all advanced in one launch (a column
    march a member in the launch grid, its rings primed again at each
    member); other shapes raise with the TPU package's message."""
    _refuse_policy(tiles, margin, order)
    if len(global_shape) != 3 or not fits(stencil, k):
        return None
    _prepare(device)
    Z, Y, X = (int(s) for s in global_shape)

    def step_k(fields: Fields) -> Fields:
        return stream_step(fields, stencil, k)

    if not batch:
        return step_k

    def step_k_batched(fields: Fields) -> Fields:
        if tuple(fields[0].shape) != (batch, Z, Y, X):
            raise ValueError(
                f"batched streaming step wants fields "
                f"({batch}, {Z}, {Y}, {X}), got {tuple(fields[0].shape)}")
        return stream_step(fields, stencil, k)

    return step_k_batched


def build_stream_sharded_call(
    stencil: Stencil,
    local_shape: Tuple[int, int, int],
    global_shape: Tuple[int, int, int],
    k: int,
    tiles=None,
    periodic: bool = False,
    margin: int = 0,
    order: str = "",
    device=None,
):
    """The streaming kernel over a z-only shard (row 17):
    ``(call, margin, nfields)`` or None.

    The call takes the shard's global z origin, then per field the
    (Lz, Y, X) core, the lower and the upper (m, Y, X) slab (K6's
    operands), and returns the core fields advanced k steps.  None for
    ``periodic`` (guard-frame only), a stencil or k without a kernel, or a
    local z extent below m (a width-m slab must come from one neighbour).
    """
    _refuse_policy(tiles, margin, order)
    if not stream_supported(stencil) or periodic or not fits(stencil, k):
        return None
    m = k_step_margin(stencil, k)
    if int(local_shape[0]) < m:
        return None
    gz = int(global_shape[0])
    nf = stencil.num_fields
    _prepare(device)

    def call(origin_z, *args):
        if len(args) != 3 * nf:
            raise ValueError(f"stream_zslab call: {3 * nf} operands (3 per "
                             f"field), got {len(args)}")
        return stream_zslab(args[0::3], args[1::3], args[2::3], stencil, k,
                            gz, origin_z)

    return call, m, nf


def build_stream_2axis_call(
    stencil: Stencil,
    local_shape: Tuple[int, int, int],
    global_shape: Tuple[int, int, int],
    k: int,
    tiles=None,
    periodic: bool = False,
    margin: int = 0,
    order: str = "",
    device=None,
):
    """The streaming kernel over a shard of a mesh that shards y (row 18):
    ``(call, margin, nfields)`` or None.

    The call takes the shard's global ``(oz, oy)`` origin, then per field
    the operand set of ``halo.exchange_slabs_2axis`` at its natural widths
    (as ``fused.build_yzslab_padfree_call``'s): the (Lz, Ly, X) core, two
    (m, Ly, X) z slabs, two (Lz, m, X) y slabs and the four (m, m, X)
    corners ll, lh, hl, hh; no padding of the y operands.  None as for
    :func:`build_stream_sharded_call`, with a local z or y extent below m.
    """
    _refuse_policy(tiles, margin, order)
    if not stream_supported(stencil) or periodic or not fits(stencil, k):
        return None
    m = k_step_margin(stencil, k)
    if min(int(local_shape[0]), int(local_shape[1])) < m:
        return None
    gshape = tuple(int(g) for g in global_shape)
    nf = stencil.num_fields
    _prepare(device)

    def call(origins, *args):
        if len(args) != 9 * nf:
            raise ValueError(f"stream_yzslab call: {9 * nf} operands (9 per "
                             f"field), got {len(args)}")
        per = [args[i::9] for i in range(9)]
        return stream_yzslab(*per[:5], per[5:], stencil, k, gshape, origins)

    return call, m, nf
