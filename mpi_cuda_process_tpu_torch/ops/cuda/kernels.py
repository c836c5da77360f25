"""The ``compute_fn`` kernels: K4, K5 and K7.

``zchunk_heat`` (K4, ``csrc/zchunk.cu::zchunk_heat<KIND>``) maps a
halo-padded heat3d, heat3d27 or heat3d4th block to its updated interior;
``zchunk_wave`` (K5, ``csrc/zchunk.cu::zchunk_wave``) does the same for
wave3d from the padded ``u`` and the unpadded ``u_prev``; ``whole2d`` (K7,
``csrc/whole2d.cu::whole2d<HEAT5|LIFE>``) for a padded 2D heat2d/mdf
(float) or life (int32) block.  None knows about the guard frame: the
step that calls them re-pins it.  The float kinds take float32 or bfloat16
(``_build.FLOAT_DTYPES``: one source, a float32 and a bfloat16 entry
point; bfloat16 launches are counted as ``zchunk_heat[heat3d,bfloat16]``)
and stay bit-equal to the plain version in either; Life takes int32.  They are what ``--compute pallas`` plugs
into ``driver.make_step`` (2D grids, and ``--periodic``) and
``parallel.stepper.make_sharded_step`` (``--mesh``).

Replaces the TPU package's ``ops/pallas/kernels.py::make_pallas_compute``
(``_heat3d_compute`` → ``_zchunk_kernel``, ``_wave3d_compute`` →
``_zchunk_wave_kernel``, ``_whole2d_compute`` → ``_heat2d_kernel`` and
``_life_kernel``).  The TPU 2D kernel takes the plain update above a VMEM
cap; K7 is tiled and runs at any size.  Bound on an H100: device-memory
bytes; the kernel sources say what their designs do about that.

K4 and K7 are ``csrc/march.cuh``'s tiled kernel: a block marches a tile
down the block's first axis through a ring of padded planes (2D: rows) in
shared memory, filled with 16-byte copies of the aligned words that cover
each row; bfloat16 cells go in pairs through the bf16x2 ops.  ``TILES``
names each kind's launch tile (its build, cells, rows and run), the
fastest of ``candidates`` on an H100 (``scripts/torch_compute_tiles.py``).
``march_geometry``, ``ring_slots`` and ``row_copy_plan`` are the kernel's
geometry, ring and copy plan, computed here, passed to every launch with
the run fitted to the card (``_build.fit_runs``) and held by the CPU tests
(``tests/compute_schedule.py`` replays the ring).

Beside each kernel sits its plain PyTorch version, the stencil's own
``update``; a wrapper takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..stencil import Fields, Stencil, dtype_name
from . import _build
from .rawstep import coefficients

# Launches per wrapper and stencil, keyed "zchunk_heat[heat3d]" (bfloat16:
# "zchunk_heat[heat3d,bfloat16]", ``_build.launch_key``): one added where a
# kernel launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

_HEAT_KIND = {"heat3d": 0, "heat3d27": 1, "heat3d4th": 2}
# The kinds whose taps off the plane are the cell's own column, which the
# z queue serves (march.cuh ``queues``).
_QUEUED = ("heat3d", "heat3d4th")
# 2D kinds of csrc/stencil2d.cuh with the field types each kernel takes.
_WHOLE2D_KIND = {"heat2d": (4, _build.FLOAT_DTYPES),
                 "life": (6, (torch.int32,))}
# The names the TPU package has a compute_fn kernel for (kernels.py:301).
_TPU_NAMES = ("heat3d", "heat3d27", "heat3d4th", "wave3d", "heat2d", "life")

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


class Tile(NamedTuple):
    """A launch tile of the tiled K4 / K7 kernel (csrc/march.cuh) and the
    build it runs: ``threads`` a block and ``blocks`` an SM (the register
    cap is ``65536 // (threads * blocks)``), ``tx`` cells and ``ty`` rows
    of a tile (2D: 1 row), ``zrun`` planes (2D: rows) a work item marches
    at most (fewer where that fills the card: ``_build.fit_runs``),
    ``rowwarps``: the warps a 3D tile row (2D: 1, the block is on the row),
    and ``zqueue``: z taps from a register queue (heat3d, heat3d4th; a tile
    of one row for each group of ``rowwarps`` warps).  A unit of ``tx`` is
    a cell, or in bfloat16 a pair of cells."""
    threads: int
    blocks: int
    tx: int
    ty: int
    zrun: int
    rowwarps: int = 1
    zqueue: bool = False

    @property
    def registers(self) -> int:
        """The build's register cap a thread."""
        return min(255, 65536 // (self.threads * self.blocks)) // 8 * 8


# The builds march.cuh instantiates (MARCH_BUILDS, in this order): threads
# a block, blocks an SM and warps a 3D tile row (2D kernels take the builds
# of one: the block is on the row); each in the unrolls UNROLLS, units a
# thread updates in each of its rows (a tile's tx is that many units of
# each thread of a row's group).  The builds TILES names: of the ones
# timed, four blocks an SM and four warps a row won for no kind.
BUILDS = ((256, 2, 1), (512, 2, 1), (256, 2, 2))
UNROLLS = (4, 8)
# Planes a block keeps in flight, and the pad bytes before and after each
# row buffer (march.cuh IN_FLIGHT, ROW_PAD).
IN_FLIGHT = 2
ROW_PAD = 16

# The launch tile of each kind, (stencil, dtype) -> Tile: the fastest of
# ``candidates`` by scripts/torch_compute_tiles.py on an NVIDIA H100 80GB
# HBM3 at 700 W, at the main path's shapes (each faster than the kernels'
# first form, timed beside it with ``--parent``): K4 on one 2x2 shard
# (heat3d of 1024^3, heat3d27 and heat3d4th of 512^3), K7 at 16384^2.
# Wide rows win (1-2 KB a tile row: DRAM pages and 16-byte copies), two
# blocks of 256 or 512 threads an SM, and the z queue for heat3d and
# heat3d4th in bfloat16 (and heat3d4th in float32).  Every kind the
# wrappers take is listed.
TILES = {
    ("heat3d", "float32"): Tile(256, 2, 256, 16, 256, 2),
    ("heat3d", "bfloat16"): Tile(512, 2, 512, 16, 128, 1, True),
    ("heat3d27", "float32"): Tile(256, 2, 256, 16, 32),
    ("heat3d27", "bfloat16"): Tile(512, 2, 512, 16, 32),
    ("heat3d4th", "float32"): Tile(256, 2, 256, 8, 64, 1, True),
    ("heat3d4th", "bfloat16"): Tile(256, 2, 512, 8, 256, 1, True),
    ("heat2d", "float32"): Tile(256, 2, 2048, 1, 1024),
    ("heat2d", "bfloat16"): Tile(256, 2, 4096, 1, 1024),
    ("life", "int32"): Tile(512, 2, 4096, 1, 512),
}


def _ndim(stencil: Stencil) -> int:
    return 2 if stencil.name in _WHOLE2D_KIND else 3


def candidates(stencil: Stencil) -> List[Tile]:
    """The tiles scripts/torch_compute_tiles.py times for ``stencil`` in its
    dtype (every TILES entry is one of them): each build, and the cells,
    rows and runs below, those whose ring fits (``tile_fits``)."""
    out = []
    for threads, blocks, rowwarps in BUILDS:
        if _ndim(stencil) == 2 and rowwarps != 1:
            continue
        unit = _unit(stencil, threads, rowwarps)
        if _ndim(stencil) == 3:
            shapes = [(nu * unit, ty, zr) for nu in UNROLLS
                      for ty in (4, 8, 16, 32) for zr in (32, 64, 128, 256)]
        else:
            shapes = [(nu * unit, 1, zr) for nu in UNROLLS
                      for zr in (256, 512, 1024)]
        out += [t for t in (Tile(threads, blocks, *sh, rowwarps)
                            for sh in shapes) if tile_fits(stencil, t)]
        if stencil.name in _QUEUED:
            groups = threads // (32 * rowwarps)
            out += [t for t in (
                Tile(threads, blocks, nu * unit, groups, zr, rowwarps, True)
                for nu in UNROLLS for zr in (32, 64, 128, 256))
                if tile_fits(stencil, t)]
    return out


def _unit(stencil: Stencil, threads: int, rowwarps: int) -> int:
    """Cells of a tile row one unroll step covers: a cell (bfloat16: a
    pair) for each thread of the row's group (3D: ``rowwarps`` warps; 2D:
    the block)."""
    return (2 if stencil.dtype == torch.bfloat16 else 1) * (
        32 * rowwarps if _ndim(stencil) == 3 else threads)


class Geometry(NamedTuple):
    """A tiled launch's ring: ``slots`` planes of ``rows`` row buffers of
    ``row_bytes`` bytes, and a table of each row's first cell (4 bytes a
    row); ``smem`` bytes in all."""
    halo: int
    rows: int
    row_bytes: int
    slots: int
    smem: int


def ring_slots(halo: int) -> int:
    """Ring slots of a tiled launch: iteration q reads planes q - 2h .. q
    and issues plane q + IN_FLIGHT into the slot of plane q + IN_FLIGHT -
    S, which must have been read for the last time before iteration q:
    S >= IN_FLIGHT + 2h + 1.  Every launch passes this count to the
    kernel, and the CPU replay (tests/compute_schedule.py) runs on it."""
    return IN_FLIGHT + 2 * halo + 1


def march_geometry(stencil: Stencil, tile: Tile) -> Geometry:
    """The ring of ``tile`` for ``stencil`` in its dtype, as march.cuh lays
    it out: a row buffer holds the aligned 16-byte words covering a
    segment of tx + 2h cells (at most one word more than the segment's
    bytes need, for its offset mod 16) between ROW_PAD bytes on each
    side; a plane tile has ty + 2h rows (2D: one)."""
    h = stencil.halo
    es = stencil.dtype.itemsize
    seg = (tile.tx + 2 * h) * es
    row_bytes = 2 * ROW_PAD + -(-(seg + 15) // 16) * 16
    rows = 1 if _ndim(stencil) == 2 else tile.ty + 2 * h
    slots = ring_slots(h)
    return Geometry(h, rows, row_bytes, slots, slots * rows * (row_bytes + 4))


def tile_fits(stencil: Stencil, tile: Tile) -> bool:
    """Whether the kernel takes ``tile`` for ``stencil``: a build it has,
    a tile row of one of its unrolls, a ring that fits one block's shared
    memory, blocks an SM whose rings fit the SM together (1 KB each kept
    by the card), and a 2D tile of one row."""
    if (tile.threads, tile.blocks, tile.rowwarps) not in BUILDS:
        return False
    if _ndim(stencil) == 2 and tile.rowwarps != 1:
        return False
    if tile.zqueue and (stencil.name not in _QUEUED or tile.ty != (
            tile.threads // (32 * tile.rowwarps))):
        return False
    unit = _unit(stencil, tile.threads, tile.rowwarps)
    if tile.tx not in [nu * unit for nu in UNROLLS] or tile.zrun < 1:
        return False
    if tile.ty < 1 or (_ndim(stencil) == 2 and tile.ty != 1):
        return False
    smem = march_geometry(stencil, tile).smem
    return smem <= _build.SMEM_LIMIT and \
        tile.blocks * (smem + 1024) <= _build.SMEM_PER_SM


def tile_of(stencil: Stencil) -> Tile:
    """The launch tile of ``stencil`` in its dtype, its TILES entry.
    Raises on a tile the kernel does not take (no fallback)."""
    key = (stencil.name, dtype_name(stencil.dtype))
    tile = TILES[key]
    if not tile_fits(stencil, tile):
        raise ValueError(f"kernels.TILES{key}: {tile} does not fit "
                         f"{stencil.name} in {dtype_name(stencil.dtype)}")
    return tile


def row_copy_plan(addr: int, ncells: int, itemsize: int, lo: int,
                  hi: int) -> Tuple[int, List[Tuple[int, Optional[Tuple]]]]:
    """March.cuh's copy of one row segment (``ncells`` cells of
    ``itemsize`` bytes from byte address ``addr``) out of a tensor that
    spans bytes [lo, hi): the 16-byte aligned words that cover it, word k
    landing 16 k bytes into the row buffer.  Returns (shift, words): the
    segment's first cell sits ``shift`` cells into the buffer; each word is
    (its address, None) for a 16-byte copy, or (its address, the
    addresses of the segment's cells in it) where the word reaches outside
    the tensor and its cells are copied one by one."""
    a1 = addr + ncells * itemsize
    w0 = addr & ~15
    nw = (((a1 + 15) & ~15) - w0) >> 4
    words = []
    for k in range(nw):
        wa = w0 + 16 * k
        if wa >= lo and wa + 16 <= hi:
            words.append((wa, None))
        else:
            words.append((wa, tuple(c for c in range(wa, wa + 16, itemsize)
                                    if addr <= c < a1)))
    return (addr - w0) // itemsize, words


def _lib():
    lib = _build.load("zchunk")
    if lib.zchunk_heat_f32.argtypes is None:
        for sfx in _build.SUFFIXES.values():
            getattr(lib, f"zchunk_heat_{sfx}").argtypes = (
                [_c_int, _c_ptr, _c_ptr] + [_c_int] * 3 + [_c_float] * 5
                + [_c_int] * 7 + [_c_ptr])
            getattr(lib, f"zchunk_wave_{sfx}").argtypes = (
                [_c_ptr] * 3 + [_c_int] * 3 + [_c_float, _c_ptr])
    return lib


def _lib2d():
    lib = _build.load("whole2d")
    if lib.whole2d_step.argtypes is None:
        for fn in (lib.whole2d_step, lib.whole2d_step_bf16):
            fn.argtypes = ([_c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_float]
                           + [_c_int] * 5 + [_c_ptr])
    return lib


# Waves of blocks a tiled launch's runs are fitted to fill at least
# (``_build.fit_runs``): a grid with few tiles a plane takes shorter runs.
FILL_WAVES = 2


def _tile_args(stencil: Stencil, tile: Tile, shape, device):
    """The tiled exports' tile arguments for an interior of ``shape``:
    build, (3D: z queue,) cells (, rows), run (fitted to the card: each
    run re-reads 2h planes), row bytes and ring slots."""
    geo = march_geometry(stencil, tile)
    if _ndim(stencil) == 2:
        head, rows, tiles = (), (), -(-shape[1] // tile.tx)
    else:
        head, rows = (int(tile.zqueue),), (tile.ty,)
        tiles = -(-shape[2] // tile.tx) * -(-shape[1] // tile.ty)
    run = _build.fit_runs(shape[0], tile.zrun, tiles, 2 * stencil.halo,
                          tile.blocks * _build.sm_count(device), FILL_WAVES)
    return (BUILDS.index((tile.threads, tile.blocks, tile.rowwarps)),
            *head, tile.tx, *rows, run, geo.row_bytes, geo.slots)


def _interior_shape(p: torch.Tensor, halo: int, what: str):
    shape = tuple(int(s) - 2 * halo for s in p.shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"{what}: expected a 3D block padded by {halo}, "
                         f"got {tuple(p.shape)}")
    return shape


def zchunk_heat(p: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Updated interior (Z, Y, X) of the padded heat block ``p``."""
    if not p.is_cuda:
        return stencil.update((p,))[0]
    kind = _HEAT_KIND[stencil.name]
    _build.check_operands("zchunk_heat", p, dtype=_build.FLOAT_DTYPES)
    Z, Y, X = _interior_shape(p, stencil.halo, "zchunk_heat")
    out = torch.empty((Z, Y, X), dtype=p.dtype, device=p.device)
    lib = _lib()
    rc = _build.entry(lib, "zchunk_heat", p)(
        kind, p.data_ptr(), out.data_ptr(), Z, Y, X, *coefficients(stencil),
        *_tile_args(stencil, tile_of(stencil), (Z, Y, X), p.device),
        _build.stream_of(p))
    _build.check(lib, rc, "zchunk_heat")
    launches[_build.launch_key("zchunk_heat", stencil.name, p)] += 1
    return out


def zchunk_wave(p: torch.Tensor, uprev: torch.Tensor,
                stencil: Stencil) -> torch.Tensor:
    """New ``u`` (Z, Y, X) from the padded ``u`` and unpadded ``u_prev``."""
    if not p.is_cuda:
        return stencil.update((p, uprev))[0]
    shape = _interior_shape(p, 1, "zchunk_wave")
    _build.check_operands("zchunk_wave", p, dtype=_build.FLOAT_DTYPES)
    _build.check_operands("zchunk_wave", uprev, shape=shape, dtype=p.dtype)
    if uprev.device != p.device:
        raise ValueError("zchunk_wave: u and u_prev on different devices")
    out = torch.empty(shape, dtype=p.dtype, device=p.device)
    lib = _lib()
    rc = _build.entry(lib, "zchunk_wave", p)(
        p.data_ptr(), uprev.data_ptr(), out.data_ptr(), *shape,
        coefficients(stencil)[0], _build.stream_of(p))
    _build.check(lib, rc, "zchunk_wave")
    launches[_build.launch_key("zchunk_wave", stencil.name, p)] += 1
    return out


def whole2d(p: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Updated interior (H, W) of the padded 2D block ``p`` (H+2, W+2):
    heat2d/mdf (float32 or bfloat16) or life (int32)."""
    if not p.is_cuda:
        return stencil.update((p,))[0]
    kind, dtypes = _WHOLE2D_KIND[stencil.name]
    _build.check_operands("whole2d", p, dtype=dtypes, ndim=2)
    H, W = (int(s) - 2 for s in p.shape)
    if min(H, W) < 1:
        raise ValueError(f"whole2d: expected a 2D block padded by 1, got "
                         f"{tuple(p.shape)}")
    out = torch.empty((H, W), dtype=p.dtype, device=p.device)
    alpha = float(stencil.params.get("alpha", 0.0))
    lib = _lib2d()
    rc = _build.twin_entry(lib, "whole2d_step", p)(
        kind, p.data_ptr(), out.data_ptr(), H, W, alpha,
        *_tile_args(stencil, tile_of(stencil), (H, W), p.device),
        _build.stream_of(p))
    _build.check(lib, rc, "whole2d")
    launches[_build.launch_key("whole2d", stencil.name, p)] += 1
    return out


def has_pallas_kernel(name: str) -> bool:
    """Whether the TPU package has a compute_fn kernel for ``name``."""
    return name in _TPU_NAMES


def make_pallas_compute(stencil: Stencil,
                        device=None) -> Callable[[Fields], Fields]:
    """Drop-in kernel replacement for ``stencil.update`` (padded fields ->
    interior fields), the ``compute_fn`` of ``driver.make_step`` and
    ``make_sharded_step``.  With a CUDA ``device`` the kernels are built
    here, before the time loop."""
    name = stencil.name
    if name not in _TPU_NAMES:
        raise KeyError(f"no pallas kernel for {name!r}; available: "
                       f"{sorted(_TPU_NAMES)}")
    if device is not None and torch.device(device).type == "cuda":
        _lib2d() if name in _WHOLE2D_KIND else _lib()

    if name in _WHOLE2D_KIND:
        def compute(padded: Fields) -> Fields:
            return (whole2d(padded[0], stencil),)

        return compute

    if name == "wave3d":
        def compute(padded: Fields) -> Fields:
            p, uprev = padded
            # slot 1 is dead (carry_map=(None, 0)): u_prev has its shape
            return (zchunk_wave(p, uprev, stencil), uprev)

        return compute

    def compute(padded: Fields) -> Fields:
        return (zchunk_heat(padded[0], stencil),)

    return compute
