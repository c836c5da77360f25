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

K4, K5 and K7 are ``csrc/march.cuh``'s tiled kernel (``march.py``, which
K1 shares): a block marches a tile down the block's first axis through a
ring of padded planes (2D: rows) in shared memory, filled with 16-byte
copies of the aligned words that cover each row; bfloat16 cells go in
pairs through the bf16x2 ops; K5's u_prev goes into the registers of the
thread that updates the cell.  ``TILES`` names each kind's launch tile (its build, cells,
rows, run and, for K5, how u_prev arrives), the fastest of
``march.candidates`` on an H100 (``scripts/torch_compute_tiles.py``).

Beside each kernel sits its plain PyTorch version, the stencil's own
``update``; a wrapper takes it only for a tensor on the CPU.

Each wrapper also takes a batched block ``(N, *padded)`` (an ensemble
run's member axis, ``u_prev`` ``(N, Z, Y, X)``) and updates every member in
one launch: the members are items of the kernel's persistent grid beside
the tiles (``csrc/march.cuh``, a member stride for the input and the
output), so a batched step launches as often as an unbatched one.  The
plain version takes the member axis as it is.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable

import torch

from ..stencil import Fields, Stencil
from . import _build
from .march import (  # noqa: F401  (the tiled kernel's API, used by tests)
    FILL_WAVES, IN_FLIGHT, ROW_PAD, Tile, candidates, march_geometry,
    ring_slots, row_copy_plan, table_tile, tile_args as _tile_args,
    tile_fits)
from .rawstep import coefficients

# Launches per wrapper and stencil, keyed "zchunk_heat[heat3d]" (bfloat16:
# "zchunk_heat[heat3d,bfloat16]", ``_build.launch_key``): one added where a
# kernel launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

_HEAT_KIND = {"heat3d": 0, "heat3d27": 1, "heat3d4th": 2}
# 2D kinds of csrc/stencil2d.cuh with the field types each kernel takes.
_WHOLE2D_KIND = {"heat2d": (4, _build.FLOAT_DTYPES),
                 "life": (6, (torch.int32,))}
# The names the TPU package has a compute_fn kernel for (kernels.py:301).
_TPU_NAMES = ("heat3d", "heat3d27", "heat3d4th", "wave3d", "heat2d", "life")

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


# The launch tile of each kind, (stencil, dtype) -> Tile: the fastest of
# ``candidates`` by scripts/torch_compute_tiles.py on an NVIDIA H100 80GB
# HBM3 at 700 W, at the main path's shapes (each timed beside the parent
# tree's launch with ``--parent``): K4 and K5 on one 2x2 shard (heat3d and
# wave3d of 1024^3, heat3d27 and heat3d4th of 512^3), K7 at 16384^2.  Wide
# rows win (1-2 KB a tile row: DRAM pages and 16-byte copies), two blocks
# of 256 or 512 threads an SM, and the z queue for most kinds that have
# it (wave3d always: its u_prev goes into registers).  Every kind the
# wrappers take is listed.
TILES = {
    ("heat3d", "float32"): Tile(512, 2, 128, 16, 256, 1, True),
    ("heat3d", "bfloat16"): Tile(256, 2, 512, 16, 128),
    ("heat3d27", "float32"): Tile(256, 2, 512, 8, 64, 2),
    ("heat3d27", "bfloat16"): Tile(512, 2, 512, 16, 32),
    ("heat3d4th", "float32"): Tile(256, 2, 256, 8, 64, 1, True),
    ("heat3d4th", "bfloat16"): Tile(256, 2, 512, 8, 256, 1, True),
    ("wave3d", "float32"): Tile(512, 2, 256, 16, 128, 1, True),
    ("wave3d", "bfloat16"): Tile(256, 2, 512, 8, 256, 1, True),
    ("heat2d", "float32"): Tile(256, 2, 2048, 1, 1024),
    ("heat2d", "bfloat16"): Tile(256, 2, 4096, 1, 1024),
    ("life", "int32"): Tile(512, 2, 4096, 1, 512),
}


def tile_of(stencil: Stencil) -> Tile:
    """The launch tile of ``stencil`` in its dtype, its TILES entry.
    Raises on a tile the kernel does not take (no fallback)."""
    return table_tile(TILES, stencil, "kernels.TILES")


def _lib():
    lib = _build.load("zchunk")
    if lib.zchunk_heat_f32.argtypes is None:
        for sfx in _build.SUFFIXES.values():
            getattr(lib, f"zchunk_heat_{sfx}").argtypes = (
                [_c_int, _c_ptr, _c_ptr] + [_c_int] * 3 + [_c_float] * 5
                + [_c_int] * 8 + [_c_ptr])
            getattr(lib, f"zchunk_wave_{sfx}").argtypes = (
                [_c_ptr] * 3 + [_c_int] * 3 + [_c_float] + [_c_int] * 8
                + [_c_ptr])
    return lib


def _lib2d():
    lib = _build.load("whole2d")
    if lib.whole2d_step.argtypes is None:
        for fn in (lib.whole2d_step, lib.whole2d_step_bf16):
            fn.argtypes = ([_c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_float]
                           + [_c_int] * 6 + [_c_ptr])
    return lib


def _interior_shape(p: torch.Tensor, halo: int, what: str, ndim: int = 3):
    """``(members, interior)`` of a padded block, or of a batched one
    ``(N, *padded)`` (members 0 when unbatched)."""
    n, padded = _build.batch_of(p, ndim)
    shape = tuple(s - 2 * halo for s in padded)
    if p.dim() not in (ndim, ndim + 1) or min(shape) < 1 or \
            (p.dim() == ndim + 1 and n < 1):
        raise ValueError(f"{what}: expected a {ndim}D block padded by "
                         f"{halo} (or a batch of them), got "
                         f"{tuple(p.shape)}")
    return n, shape


def zchunk_heat(p: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Updated interior (Z, Y, X) of the padded heat block ``p`` (of
    every member of a batched ``(N, Z+2h, Y+2h, X+2h)`` one, in one
    launch)."""
    if not p.is_cuda:
        return stencil.update((p,))[0]
    kind = _HEAT_KIND[stencil.name]
    n, (Z, Y, X) = _interior_shape(p, stencil.halo, "zchunk_heat")
    _build.check_operands("zchunk_heat", p, dtype=_build.FLOAT_DTYPES,
                          members=n)
    out = torch.empty((n,) * bool(n) + (Z, Y, X), dtype=p.dtype,
                      device=p.device)
    lib = _lib()
    rc = _build.entry(lib, "zchunk_heat", p)(
        kind, p.data_ptr(), out.data_ptr(), Z, Y, X, *coefficients(stencil),
        *_tile_args(stencil, tile_of(stencil), (Z, Y, X), p.device,
                    max(1, n)),
        max(1, n), _build.stream_of(p))
    _build.check(lib, rc, "zchunk_heat")
    launches[_build.launch_key("zchunk_heat", stencil.name, p, n)] += 1
    return out


def zchunk_wave(p: torch.Tensor, uprev: torch.Tensor,
                stencil: Stencil) -> torch.Tensor:
    """New ``u`` (Z, Y, X) from the padded ``u`` and unpadded ``u_prev``
    (of every member of batched ones, in one launch)."""
    if not p.is_cuda:
        return stencil.update((p, uprev))[0]
    n, shape = _interior_shape(p, 1, "zchunk_wave")
    _build.check_operands("zchunk_wave", p, dtype=_build.FLOAT_DTYPES,
                          members=n)
    _build.check_operands("zchunk_wave", uprev, shape=shape, dtype=p.dtype,
                          members=n)
    if uprev.device != p.device:
        raise ValueError("zchunk_wave: u and u_prev on different devices")
    out = torch.empty((n,) * bool(n) + shape, dtype=p.dtype,
                      device=p.device)
    lib = _lib()
    rc = _build.entry(lib, "zchunk_wave", p)(
        p.data_ptr(), uprev.data_ptr(), out.data_ptr(), *shape,
        coefficients(stencil)[0],
        *_tile_args(stencil, tile_of(stencil), shape, p.device, max(1, n)),
        max(1, n), _build.stream_of(p))
    _build.check(lib, rc, "zchunk_wave")
    launches[_build.launch_key("zchunk_wave", stencil.name, p, n)] += 1
    return out


def whole2d(p: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Updated interior (H, W) of the padded 2D block ``p`` (H+2, W+2):
    heat2d/mdf (float32 or bfloat16) or life (int32); of every member of
    a batched ``(N, H+2, W+2)`` block in one launch."""
    if not p.is_cuda:
        return stencil.update((p,))[0]
    kind, dtypes = _WHOLE2D_KIND[stencil.name]
    n, (H, W) = _interior_shape(p, 1, "whole2d", ndim=2)
    _build.check_operands("whole2d", p, dtype=dtypes, ndim=2, members=n)
    out = torch.empty((n,) * bool(n) + (H, W), dtype=p.dtype,
                      device=p.device)
    alpha = float(stencil.params.get("alpha", 0.0))
    lib = _lib2d()
    rc = _build.twin_entry(lib, "whole2d_step", p)(
        kind, p.data_ptr(), out.data_ptr(), H, W, alpha,
        *_tile_args(stencil, tile_of(stencil), (H, W), p.device, max(1, n)),
        max(1, n), _build.stream_of(p))
    _build.check(lib, rc, "whole2d")
    launches[_build.launch_key("whole2d", stencil.name, p, n)] += 1
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
