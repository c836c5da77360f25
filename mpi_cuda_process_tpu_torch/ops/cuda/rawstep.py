"""Whole-step kernels on the raw (unpadded) 3D grid: K1, K2 and Gray-Scott's.

``raw_step_heat`` (K1, ``csrc/rawstep.cu::raw_step_heat_*``) advances
heat3d, heat3d27, heat3d4th or advect3d one guard-frame step;
``raw_step_wave`` (K2, ``csrc/rawstep.cu::raw_step_wave_*``) advances
wave3d; ``raw_step_grayscott`` (``csrc/rawstep.cu::raw_step_grayscott_*``)
advances grayscott3d, both of its fields.  The state is its own halo: frame cells are
the guard cells, so no padded copy is ever made.  Each takes float32 or
bfloat16 grids (``_build.FLOAT_DTYPES``: an ``_f32`` and a ``_bf16``
entry point of one source); in bfloat16 every op rounds as the plain
version's does, so the kernels stay bit-equal to it.

Replaces the TPU package's ``ops/pallas/rawstep.py::make_raw_step``
(``_heat_kernel`` with ``_taps7``/``_taps27``/``_taps13``/``_taps_advect``,
``_wave_kernel`` and ``_grayscott_kernel``).  Bound on an H100:
device-memory bytes (one read of each input field and one write of each
output per step); the kernel source says what its design does about
that.  All three are ``csrc/march.cuh``'s tiled kernel on the raw grid
(``march.py``, which the compute_fn kernels share), the frame pinned in
the kernel: K2 loads u_prev into the registers of each cell's thread,
Gray-Scott marches v through a second ring beside u.  ``TILES`` names
each kind's launch tile, the fastest of ``march.candidates`` on an H100
(``scripts/torch_compute_tiles.py``).

Beside each kernel sits its plain PyTorch version, the port's
``driver.make_step``; a wrapper takes it only for a tensor on the CPU.  On a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Optional, Sequence

import torch

from ...driver import make_step
from .. import reaction, sor
from ..heat import W27_CENTER, W27_CORNER, W27_EDGE, W27_FACE, W4TH, w4th_center
from ..stencil import Fields, Stencil
from . import _build
from .march import Tile, table_tile, tile_args

# Launches per wrapper and stencil, keyed "raw_step_heat[heat3d]" (bfloat16:
# "raw_step_heat[heat3d,bfloat16]", ``_build.launch_key``): one added where
# a kernel launches, nowhere else.  ``launches.clear()`` resets.
launches: Counter = Counter()

# one-field kinds of K1 (csrc/stencil_taps.cuh)
_HEAT_KIND = {"heat3d": 0, "heat3d27": 1, "heat3d4th": 2, "advect3d": 7}

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p

# The launch tile of each raw kind (K1, K2, Gray-Scott), (stencil, dtype)
# -> Tile (march.py): the fastest of ``march.candidates`` by
# scripts/torch_compute_tiles.py on an NVIDIA H100 80GB HBM3 at 700 W, on
# the unsharded main path's 512^3 grid (heat3d and wave3d: the fastest over
# 512^3 and 1024^3 together).  Every kind the wrappers take is listed.
TILES = {
    ("heat3d", "float32"): Tile(256, 2, 256, 8, 256, 1, True),
    ("heat3d", "bfloat16"): Tile(256, 2, 512, 16, 256),
    ("heat3d27", "float32"): Tile(256, 2, 512, 8, 128, 2),
    ("heat3d27", "bfloat16"): Tile(512, 2, 512, 16, 64),
    ("heat3d4th", "float32"): Tile(256, 2, 256, 8, 256, 1, True),
    ("heat3d4th", "bfloat16"): Tile(256, 2, 512, 8, 256, 1, True),
    ("advect3d", "float32"): Tile(256, 2, 512, 8, 256, 2),
    ("advect3d", "bfloat16"): Tile(512, 2, 512, 16, 64),
    ("wave3d", "float32"): Tile(256, 2, 256, 8, 64, 1, True),
    ("wave3d", "bfloat16"): Tile(256, 2, 512, 8, 256, 1, True),
    ("grayscott3d", "float32"): Tile(256, 2, 256, 4, 32),
    ("grayscott3d", "bfloat16"): Tile(256, 2, 512, 8, 256),
}


def coefficients(stencil: Stencil):
    """``(a, c0, c1, c2, c3)`` for the C entry points of the 3D kernels
    (``Coef`` in stencil_taps.cuh); sor3d's ``a`` is omega / 6, heat3d's
    alpha for its half-sweeps (the k-step kernels only: it has no raw
    step)."""
    p = stencil.params
    if stencil.name == "heat3d":
        return (p["alpha"], 0.0, 0.0, 0.0, 0.0)
    if stencil.name == "heat3d27":
        return (p["alpha"], W27_CENTER, W27_FACE, W27_EDGE, W27_CORNER)
    if stencil.name == "heat3d4th":
        return (p["alpha"], w4th_center(3), W4TH[1], W4TH[2], 0.0)
    if stencil.name == "wave3d":
        return (p["c2dt2"], 0.0, 0.0, 0.0, 0.0)
    if stencil.name == "advect3d":
        return tuple(p["courant"]) + (0.0, 0.0)  # (cz, cy, cx)
    if stencil.name == "grayscott3d":
        return reaction.coefficients(stencil) + (0.0,)
    if stencil.name == "sor3d":  # a half-sweep's heat coefficient
        return (sor.alpha(stencil), 0.0, 0.0, 0.0, 0.0)
    raise ValueError(f"no CUDA kernel for {stencil.name!r}")


def _lib():
    lib = _build.load("rawstep")
    if lib.raw_step_heat_f32.argtypes is None:
        for sfx in _build.SUFFIXES.values():
            getattr(lib, f"raw_step_heat_{sfx}").argtypes = (
                [_c_int, _c_ptr, _c_ptr] + [_c_int] * 3 + [_c_float] * 5
                + [_c_int] * 7 + [_c_ptr])
            getattr(lib, f"raw_step_wave_{sfx}").argtypes = (
                [_c_ptr] * 3 + [_c_int] * 3 + [_c_float] + [_c_int] * 7
                + [_c_ptr])
            getattr(lib, f"raw_step_grayscott_{sfx}").argtypes = (
                [_c_ptr] * 4 + [_c_int] * 3 + [_c_float] * 4 + [_c_int] * 7
                + [_c_ptr])
    return lib


def raw_step_heat(u: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """One guard-frame step of a one-field stencil (heat3d, heat3d27,
    heat3d4th, advect3d): the new (Z, Y, X) grid."""
    if not u.is_cuda:
        return make_step(stencil, u.shape)((u,))[0]
    kind = _HEAT_KIND[stencil.name]
    _build.check_operands("raw_step_heat", u, dtype=_build.FLOAT_DTYPES)
    out = torch.empty_like(u)
    lib = _lib()
    Z, Y, X = u.shape
    rc = _build.entry(lib, "raw_step_heat", u)(
        kind, u.data_ptr(), out.data_ptr(), Z, Y, X, *coefficients(stencil),
        *tile_args(stencil, tile_of(stencil), (Z, Y, X), u.device),
        _build.stream_of(u))
    _build.check(lib, rc, "raw_step_heat")
    launches[_build.launch_key("raw_step_heat", stencil.name, u)] += 1
    return out


def tile_of(stencil: Stencil) -> Tile:
    """The launch tile of raw kind ``stencil`` in its dtype, its TILES
    entry.  Raises on a tile the kernel does not take (no fallback)."""
    return table_tile(TILES, stencil, "rawstep.TILES")


def raw_step_wave(u: torch.Tensor, uprev: torch.Tensor,
                  stencil: Stencil) -> torch.Tensor:
    """One leapfrog step of wave3d: the new ``u`` (the new ``u_prev`` is
    the old ``u`` itself — the caller keeps it, ``carry_map`` rule)."""
    if not u.is_cuda:
        return make_step(stencil, u.shape)((u, uprev))[0]
    _build.check_operands("raw_step_wave", u, uprev, shape=tuple(u.shape),
                          dtype=_build.FLOAT_DTYPES)
    out = torch.empty_like(u)
    lib = _lib()
    Z, Y, X = u.shape
    rc = _build.entry(lib, "raw_step_wave", u)(
        u.data_ptr(), uprev.data_ptr(), out.data_ptr(), Z, Y, X,
        coefficients(stencil)[0],
        *tile_args(stencil, tile_of(stencil), (Z, Y, X), u.device),
        _build.stream_of(u))
    _build.check(lib, rc, "raw_step_wave")
    launches[_build.launch_key("raw_step_wave", stencil.name, u)] += 1
    return out


def raw_step_grayscott(u: torch.Tensor, v: torch.Tensor,
                       stencil: Stencil) -> Fields:
    """One guard-frame step of grayscott3d: the new ``(u, v)``."""
    if not u.is_cuda:
        return make_step(stencil, u.shape)((u, v))
    _build.check_operands("raw_step_grayscott", u, v, shape=tuple(u.shape),
                          dtype=_build.FLOAT_DTYPES)
    ou, ov = torch.empty_like(u), torch.empty_like(v)
    lib = _lib()
    Z, Y, X = u.shape
    rc = _build.entry(lib, "raw_step_grayscott", u)(
        u.data_ptr(), v.data_ptr(), ou.data_ptr(), ov.data_ptr(), Z, Y, X,
        *coefficients(stencil)[:4],
        *tile_args(stencil, tile_of(stencil), (Z, Y, X), u.device),
        _build.stream_of(u))
    _build.check(lib, rc, "raw_step_grayscott")
    launches[_build.launch_key("raw_step_grayscott", stencil.name,
                                u)] += 1
    return ou, ov


def raw_step_supported(stencil: Stencil) -> bool:
    return stencil.name in _HEAT_KIND or stencil.name in ("wave3d",
                                                          "grayscott3d")


def make_raw_step(
    stencil: Stencil,
    global_shape: Sequence[int],
    device=None,
) -> Optional[Callable[[Fields], Fields]]:
    """Whole-step ``fields -> fields`` function (guard-frame mode), or None.

    A drop-in replacement for ``driver.make_step(stencil, global_shape)``.
    Returns None for stencils without a raw kernel, 2D grids, and grids with
    no interior.  With a CUDA ``device`` the kernels are built here, before
    the time loop, so a first build never lands inside a timed step.
    """
    if len(global_shape) != 3 or not raw_step_supported(stencil):
        return None
    if min(int(s) for s in global_shape) <= 2 * stencil.halo:
        return None
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    if stencil.name == "wave3d":
        def step(fields: Fields) -> Fields:
            u, uprev = fields
            return (raw_step_wave(u, uprev, stencil), u)  # new u_prev = old u

        return step

    if stencil.name == "grayscott3d":
        def step(fields: Fields) -> Fields:
            return raw_step_grayscott(*fields, stencil)

        return step

    def step(fields: Fields) -> Fields:
        (u,) = fields
        return (raw_step_heat(u, stencil),)

    return step
