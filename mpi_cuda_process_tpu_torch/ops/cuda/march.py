"""The launch geometry of ``csrc/march.cuh``, the tiled one-step kernel.

Six kernels run it: K4 ``zchunk_heat``, K5 ``zchunk_wave`` and K7
``whole2d`` (``kernels.py``: one update of a halo-padded block) and K1
``raw_step_heat``, K2 ``raw_step_wave`` and ``raw_step_grayscott``
(``rawstep.py``: one guard-frame step of the raw grid, its frame pinned in
the kernel).  A block marches a tile of the output planes down the first
axis through a ring of input planes in shared memory (Gray-Scott: a ring
for each of its two fields, :func:`fields`), filled with 16-byte copies of
the aligned words that cover each row; bfloat16 cells go in pairs through
the bf16x2 ops.  Each kernel's
table (``kernels.TILES``, ``rawstep.TILES``) names a :class:`Tile` per
(stencil, dtype), the fastest of :func:`candidates` on an H100
(``scripts/torch_compute_tiles.py``).  :func:`march_geometry`,
:func:`ring_slots` and :func:`row_copy_plan` are the kernel's geometry,
ring and copy plan, computed here, passed to every
launch by :func:`tile_args` with the run fitted to the card
(``_build.fit_runs``) and held by the CPU tests
(``tests/compute_schedule.py`` replays the ring).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..stencil import Stencil, dtype_name
from . import _build


class Tile(NamedTuple):
    """A launch tile of the tiled kernel and the build it runs:
    ``threads`` a block and ``blocks`` an SM (the register cap is
    ``65536 // (threads * blocks)``), ``tx`` cells and ``ty`` rows of a
    tile (2D: 1 row), ``zrun`` planes (2D: rows) a work item marches at
    most (fewer where that fills the card: ``_build.fit_runs``),
    ``rowwarps``: the warps a 3D tile row (2D: 1, the block is on the
    row), and ``zqueue``: z taps from a register queue (heat3d,
    heat3d4th, and wave3d, which takes it always: a tile of one row for
    each group of ``rowwarps`` warps, whose threads load the u_prev of
    their cells into registers).  A unit of ``tx`` is a cell, or in
    bfloat16 a pair of cells."""
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
# each thread of a row's group).  Of the ones timed, four blocks an SM and
# four warps a row won for no kind.
BUILDS = ((256, 2, 1), (512, 2, 1), (256, 2, 2))
UNROLLS = (4, 8)
# Planes a block keeps in flight, and the pad bytes before and after each
# row buffer (march.cuh IN_FLIGHT, ROW_PAD).
IN_FLIGHT = 2
ROW_PAD = 16
# The kinds whose taps off the plane are the cell's own column, which the
# z queue serves (march.cuh ``queues``).
QUEUED = ("heat3d", "heat3d4th", "wave3d")
# Waves of blocks a launch's runs are fitted to fill at least
# (``_build.fit_runs``): a grid with few tiles a plane takes shorter runs.
FILL_WAVES = 2


def has_uprev(stencil: Stencil) -> bool:
    """Whether the kernel reads a dense u_prev operand (K5, K2: wave3d)."""
    return stencil.name == "wave3d"


def fields(stencil: Stencil) -> int:
    """The fields the kernel marches through rings of their own (march.cuh
    ``fields_of``): 2 for grayscott3d, whose u and v are both read with
    their neighbours; 1 for every other kind."""
    return 2 if stencil.name == "grayscott3d" else 1


def candidates(stencil: Stencil) -> List[Tile]:
    """The tiles scripts/torch_compute_tiles.py times for ``stencil`` in its
    dtype (every table entry is one of them): each build, and the cells,
    rows and runs below, those whose ring fits (``tile_fits``)."""
    out = []
    for threads, blocks, rowwarps in BUILDS:
        if stencil.ndim == 2 and rowwarps != 1:
            continue
        unit = _unit(stencil, threads, rowwarps)
        if stencil.ndim == 3:
            shapes = [(nu * unit, ty, zr) for nu in UNROLLS
                      for ty in (4, 8, 16, 32) for zr in (32, 64, 128, 256)]
        else:
            shapes = [(nu * unit, 1, zr) for nu in UNROLLS
                      for zr in (256, 512, 1024)]
        if not has_uprev(stencil):
            out += [t for t in (Tile(threads, blocks, *sh, rowwarps)
                                for sh in shapes) if tile_fits(stencil, t)]
        if stencil.name in QUEUED:
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
        32 * rowwarps if stencil.ndim == 3 else threads)


class Geometry(NamedTuple):
    """A launch's ring: ``slots`` planes of ``rows`` row buffers of
    ``row_bytes`` bytes, and a table of each row's first cell (4 bytes a
    row), for each of the kind's :func:`fields`; ``smem`` bytes in all."""
    halo: int
    rows: int
    row_bytes: int
    slots: int
    smem: int


def ring_slots(halo: int) -> int:
    """Ring slots of a launch: iteration q reads planes q - 2h .. q and
    issues plane q + IN_FLIGHT into the slot of plane q + IN_FLIGHT - S,
    which must have been read for the last time before iteration q:
    S >= IN_FLIGHT + 2h + 1.  Every launch passes this count to the
    kernel, and the CPU replay (tests/compute_schedule.py) runs on it."""
    return IN_FLIGHT + 2 * halo + 1


def _row_bytes(cells: int, itemsize: int) -> int:
    """A row buffer: the aligned 16-byte words covering ``cells`` cells (at
    most one word more than their bytes need, for their offset mod 16)
    between ROW_PAD bytes on each side."""
    return 2 * ROW_PAD + -(-(cells * itemsize + 15) // 16) * 16


def march_geometry(stencil: Stencil, tile: Tile) -> Geometry:
    """The rings of ``tile`` for ``stencil`` in its dtype, as march.cuh
    lays them out: a row buffer holds a segment of tx + 2h cells; a plane
    tile has ty + 2h rows (2D: one); one ring and table for each field."""
    h = stencil.halo
    row_bytes = _row_bytes(tile.tx + 2 * h, stencil.dtype.itemsize)
    rows = 1 if stencil.ndim == 2 else tile.ty + 2 * h
    slots = ring_slots(h)
    return Geometry(h, rows, row_bytes, slots,
                    fields(stencil) * slots * rows * (row_bytes + 4))


def tile_fits(stencil: Stencil, tile: Tile) -> bool:
    """Whether the kernel takes ``tile`` for ``stencil``: a build it has,
    a tile row of one of its unrolls, rings (every field's) that fit one
    block's shared memory, blocks an SM whose rings fit the SM together
    (1 KB each kept by the card), a 2D tile of one row, the z queue on a
    queued kind (on every wave3d tile)."""
    if (tile.threads, tile.blocks, tile.rowwarps) not in BUILDS:
        return False
    if stencil.ndim == 2 and tile.rowwarps != 1:
        return False
    if tile.zqueue and (stencil.name not in QUEUED or tile.ty != (
            tile.threads // (32 * tile.rowwarps))):
        return False
    if has_uprev(stencil) and not tile.zqueue:
        return False
    unit = _unit(stencil, tile.threads, tile.rowwarps)
    if tile.tx not in [nu * unit for nu in UNROLLS] or tile.zrun < 1:
        return False
    if tile.ty < 1 or (stencil.ndim == 2 and tile.ty != 1):
        return False
    smem = march_geometry(stencil, tile).smem
    return smem <= _build.SMEM_LIMIT and \
        tile.blocks * (smem + 1024) <= _build.SMEM_PER_SM


def table_tile(table: dict, stencil: Stencil, what: str) -> Tile:
    """The launch tile of ``stencil`` in its dtype, its entry of ``table``
    (named ``what``).  Raises on a tile the kernel does not take (no
    fallback)."""
    key = (stencil.name, dtype_name(stencil.dtype))
    tile = table[key]
    if not tile_fits(stencil, tile):
        raise ValueError(f"{what}{key}: {tile} does not fit "
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


def tile_args(stencil: Stencil, tile: Tile, shape, device, members=1):
    """The tiled exports' tile arguments for an output of ``shape``:
    build, (3D: z queue,) cells (, rows), run (fitted to the card: each
    run re-reads 2h planes; a batched launch's ``members`` put that many
    times the tiles side by side), row bytes and ring slots."""
    geo = march_geometry(stencil, tile)
    if stencil.ndim == 2:
        head, rows, tiles = (), (), -(-shape[1] // tile.tx)
    else:
        head, rows = (int(tile.zqueue),), (tile.ty,)
        tiles = -(-shape[2] // tile.tx) * -(-shape[1] // tile.ty)
    tiles *= max(1, int(members))
    run = _build.fit_runs(shape[0], tile.zrun, tiles, 2 * stencil.halo,
                          tile.blocks * _build.sm_count(device), FILL_WAVES)
    return (BUILDS.index((tile.threads, tile.blocks, tile.rowwarps)),
            *head, tile.tx, *rows, run, geo.row_bytes, geo.slots)
