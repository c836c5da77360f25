"""Temporal blocking, k steps per device-memory pass: K3, K6 and K9.

``fused_step`` (``csrc/fused.cu::fused_step<KIND, RAW>``) advances heat3d,
heat3d27, heat3d4th, wave3d, sor3d, advect3d or grayscott3d by k
guard-frame (or periodic) steps in one kernel launch, by overlapped tiling
in shared memory (sor3d: 2k one-colour half-sweeps, margin ``2k``).
Its sharded mode, ``fused_step_padded`` (``fused_step<KIND, PADDED>``), does
the same for one shard from its z/y-padded block and the shard's global
origin: the ``sharded_global`` mode of the TPU builder.  ``fused_zslab``
(K6, ``fused_step<KIND, ZSLAB>``) takes a z-only shard's core and its two
exchanged z slabs as separate operands instead, so no padded block exists;
``fused_yzslab`` (K9, ``fused_step<KIND, YZSLAB>``) does the same for a
shard of a mesh that shards y: the core, two z slabs, two y slabs and the
four corner pieces.  ``build_overlap_shell_calls`` builds the overlapped
step's boundary shells: K3's sharded mode over a ``2m``-deep core, counted
apart as ``fused_shell``.  Every wrapper takes every family.

Each wrapper takes float32 or bfloat16 fields (``_build.FLOAT_DTYPES``: an
``_f32`` and a ``_bf16`` entry point of one source) and raises for any
other type.  A bfloat16 launch keeps its windows in bfloat16: the plain
step rounds every level to bfloat16, so the windows hold the same values
in half the shared memory (``smem_bytes`` and ``fits`` count the
stencil's itemsize), and the kernel stays bit-equal to the plain version.
The TPU package's alignment rule (``margin_of``: ``2m`` a multiple of 8
rows in float32, 16 in bfloat16) then gives bfloat16 k = 8 for the halo-1
families and k = 4 for heat3d4th and sor3d.

Replaces the TPU package's ``ops/pallas/fused.py::build_fused_call``
(``_fused_kernel``, ``_fused_raw_kernel`` with the ``_micro_heat``/
``_micro_heat3d27``/``_micro_heat3d4th``/``_micro_wave``/``_micro_sor``/
``_micro_advect``/``_micro_grayscott`` micro-steps),
``build_zslab_padfree_call`` (``_fused_zslab_kernel``),
``build_yzslab_padfree_call`` (``_fused_yzslab_kernel``) and
``build_overlap_shell_calls``.  Bound on an
H100: device-memory bytes, one read and one write of each field per k steps;
in practice instructions, which the kernel's design (redesigned for Hopper:
threads walk window columns down z with no division, 16-byte row copies
and no frame test on the blocks that need neither; the kernel source says
more) spends as few of as it can.  The launch tile comes from ``TILES``,
timed per (stencil, dtype, k); ``CORE``/``SOR_CORE`` still decide which
(stencil, k, dtype) the kernels take.

Plain PyTorch versions: k applications of the port's ``driver.make_step``
for ``fused_step``; for the sharded wrappers, k plain steps of the window
they are given or assemble (``plain_step_padded``, ``plain_yzslab``), which
equals k plain sharded steps on the shard's core.  A wrapper takes its
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Optional, Sequence, Tuple

import torch

from ...driver import frame_mask, make_step
from ..stencil import Fields, Stencil, dtype_name, k_step_margin
from . import _build
from .rawstep import coefficients

# Launches per wrapper and stencil, keyed "fused_step[heat3d]",
# "fused_step_padded[heat3d]", "fused_shell[heat3d]" (K3's sharded mode as
# an overlap shell), "fused_zslab[heat3d]" or "fused_yzslab[heat3d]"
# (bfloat16: "fused_step[heat3d,bfloat16]", ``_build.launch_key``): one
# added where the kernel launches, nowhere else.  ``launches.clear()``
# resets.
launches: Counter = Counter()

# name -> (kernel kind in stencil_taps.cuh, halo)
_FUSED = {"heat3d": (0, 1), "heat3d27": (1, 1), "heat3d4th": (2, 2),
          "wave3d": (3, 1), "advect3d": (7, 1), "grayscott3d": (8, 1),
          "sor3d": (11, 1)}

# Dynamic shared memory one block may use on Hopper.
SMEM_LIMIT = _build.SMEM_LIMIT
# Core tile (TZ, TY, TX) each block writes.  32 x-cells keep a warp's loads
# and stores on consecutive addresses.  Every (stencil, k) the alignment rule
# accepts either fits at this core (halo-1 k <= 8, heat3d4th k <= 4: at most
# 221 KB; Gray-Scott's four buffers k = 4 only in float32, 160 KB, and k = 8
# in bfloat16, 221,184 B) or at no core at all (the margin alone overflows),
# so one core serves.
CORE = (8, 8, 32)
# sor3d relaxes in place in one buffer (csrc/fused.cu), and its margin is 2k:
# a larger core spends fewer of the window's cells on the margin (k = 4:
# 6x the core's cells against 13.5x at CORE; 192 KB).
SOR_CORE = (16, 16, 32)
# CORE and SOR_CORE decide which (stencil, k, dtype) the kernels take
# (``fits``, ``margin_of``: the TPU builders' set).  A launch may use
# another tile: TILES maps (stencil, dtype, k) to the core (TZ, TY, TX) and
# the block's threads, the fastest of scripts/torch_fused_tiles.py's
# candidates on an H100 at 512^3 (and, for heat3d and wave3d, on a 1024^3
# 2x2 shard: the same winners).  A deeper tile recomputes fewer margin
# cells (1.59 updates a useful cell-step at (16, 16, 32), k = 4, against
# 2.21 at CORE), and 1024 threads hide the shared-memory latency of its one
# block an SM; Gray-Scott's four buffers leave it CORE.  Pairs not listed,
# and grids smaller than the tile (the shells), take ``core_of(stencil)``
# with THREADS (512 beat 256 at CORE for all but two pairs).
THREADS = 512
_WIDE = (16, 16, 32, 1024)
TILES = {
    ("heat3d", "float32", 4): _WIDE, ("heat3d", "bfloat16", 8): _WIDE,
    ("heat3d27", "float32", 4): (16, 8, 64, 1024),
    ("heat3d27", "bfloat16", 8): _WIDE,
    ("heat3d4th", "float32", 2): _WIDE, ("heat3d4th", "bfloat16", 4): _WIDE,
    ("wave3d", "float32", 4): _WIDE, ("wave3d", "bfloat16", 8): _WIDE,
    ("advect3d", "float32", 4): _WIDE, ("advect3d", "bfloat16", 8): _WIDE,
    ("grayscott3d", "float32", 4): (8, 8, 32, 512),
    ("grayscott3d", "bfloat16", 8): (8, 8, 32, 512),
    ("sor3d", "float32", 4): _WIDE,
    ("sor3d", "bfloat16", 4): (32, 16, 32, 1024),
}
# The kernel's fast paths (csrc/fused.cu ``paths``): 16-byte row copies,
# where every operand's address is 16-byte aligned; no frame test where no
# update is frame; cells read from row pointers where the rows need no
# wrap or clamp.  PATHS is what every launch allows (0 times the per-cell
# path alone: scripts/torch_fused_tiles.py).
VEC_LOAD, FRAME_FREE, ROW_LOAD = 1, 2, 4
PATHS = VEC_LOAD | FRAME_FREE | ROW_LOAD

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def fused_supported(stencil: Stencil) -> bool:
    return stencil.name in _FUSED


def buffers(stencil: Stencil) -> int:
    """Window buffers the kernel keeps: a current and a next level per field
    whose neighbours it reads (Gray-Scott: both fields, so 4); wave's
    u_prev, read at its own cell only, shares the pair of u; sor3d relaxes
    in place in one (a half-sweep reads only the colour it leaves)."""
    if stencil.name == "sor3d":
        return 1
    return 2 * sum(1 for h in stencil.field_halos if h)


def core_of(stencil: Stencil) -> Tuple[int, int, int]:
    """The core tile of ``stencil``'s blocks: ``SOR_CORE`` for sor3d,
    ``CORE`` for the rest."""
    return SOR_CORE if stencil.name == "sor3d" else CORE


def tile_of(stencil: Stencil, k: int,
            shape: Sequence[int]) -> Tuple[int, int, int, int]:
    """The launch tile ``(TZ, TY, TX, threads)`` of ``stencil`` at k on a
    grid (or shard) of ``shape``: its TILES entry where the grid holds it
    and its window fits shared memory, else ``core_of`` with THREADS."""
    tile = TILES.get((stencil.name, dtype_name(stencil.dtype), int(k)))
    if tile is None or any(int(n) < t for n, t in zip(shape, tile[:3])) \
            or smem_bytes(tile[:3], k_step_margin(stencil, k),
                          buffers(stencil), stencil.dtype.itemsize) \
            > SMEM_LIMIT:
        return core_of(stencil) + (THREADS,)
    return tuple(tile)


def launch_paths(operands) -> int:
    """The fast paths a launch on ``operands`` may take: PATHS, without the
    16-byte row copies where an operand's address is off 16 bytes."""
    if any(t.data_ptr() % 16 for t in operands):
        return PATHS & ~VEC_LOAD
    return PATHS


def _tail(stencil: Stencil, k: int, shape: Sequence[int], operands,
          members: int = 0):
    """The exports' trailing arguments: coefficients, the launch tile and
    the fast paths, the members of a batched launch (1 unbatched), then
    the stream."""
    return (*coefficients(stencil), *tile_of(stencil, k, shape),
            launch_paths(operands), max(1, members),
            _build.stream_of(operands[0]))


def smem_bytes(core: Tuple[int, int, int], margin: int, nbuf: int = 2,
               itemsize: int = 4) -> int:
    """``nbuf`` window buffers of ``core + 2 * margin`` cells of
    ``itemsize`` bytes (4 for float32, 2 for bfloat16)."""
    tz, ty, tx = core
    return nbuf * itemsize * (tz + 2 * margin) * (ty + 2 * margin) * (
        tx + 2 * margin)


def fits(stencil: Stencil, k: int) -> bool:
    """Whether the window buffers of the stencil's core at the k-step margin
    fit one block's shared memory, in the stencil's dtype."""
    return smem_bytes(core_of(stencil), k_step_margin(stencil, k),
                      buffers(stencil), stencil.dtype.itemsize) <= SMEM_LIMIT


def parity_consistent(stencil: Stencil, shape: Sequence[int],
                      periodic: bool) -> bool:
    """False where a periodic wrap over an odd extent of ``shape`` would
    give neighbouring cells one colour (red-black SOR), which the TPU
    builders refuse; True for every other stencil and case."""
    return not (stencil.parity_sensitive and periodic
                and any(int(s) % 2 for s in shape))


def _sublane(itemsize: int) -> int:
    """The TPU package's window alignment unit: 8 rows for float32, 16 for
    bfloat16.  Kept so both packages accept the same (stencil, k) pairs."""
    return 8 * max(1, 4 // itemsize)


def margin_of(stencil: Stencil, k: int) -> Optional[int]:
    """The k-step margin ``m = k * halo * max(1, phases)``, or None for a
    (stencil, k) the kernel does not take: no fused kernel, ``2 * m`` off
    the alignment unit of the stencil's dtype (float32: sor3d takes k = 2
    and 4, not 1; bfloat16: halo-1 k = 8, heat3d4th and sor3d k = 4, as the
    TPU builders), or a window too large for shared memory."""
    if not fused_supported(stencil) or k < 1:
        return None
    m = k_step_margin(stencil, k)
    if (2 * m) % _sublane(stencil.dtype.itemsize):
        return None
    if not fits(stencil, k):
        return None
    return m


def _lib():
    lib = _build.load("fused")
    if lib.fused_step_f32.argtypes is None:
        tail = [_c_float] * 5 + [_c_int] * 6 + [_c_ptr]
        for sfx in _build.SUFFIXES.values():
            getattr(lib, f"fused_step_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 5 + tail)
            getattr(lib, f"fused_step_padded_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 10 + tail)
            getattr(lib, f"fused_zslab_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 8 + [_c_int] * 7 + tail)
            getattr(lib, f"fused_yzslab_{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 20 + [_c_int] * 10 + tail)
            # tail: coefficients, tile, threads, paths, members, stream
    return lib


def _pointers(tensors, two):
    return (tensors[0].data_ptr(), tensors[1].data_ptr() if two else None)


def plain_steps(fields: Fields, stencil: Stencil, k: int,
                periodic: bool = False) -> Fields:
    """The plain version of K3: k applications of ``driver.make_step``
    (on batched fields, every member's)."""
    step = make_step(stencil, fields[0].shape[-stencil.ndim:],
                     periodic=periodic)
    for _ in range(k):
        fields = step(fields)
    return fields


def fused_step(fields: Fields, stencil: Stencil, k: int,
               periodic: bool = False) -> Fields:
    """``k`` steps of ``stencil`` on ``fields`` in one launch (every member
    of batched ``(N, Z, Y, X)`` fields in the same launch)."""
    if not fields[0].is_cuda:
        return plain_steps(fields, stencil, k, periodic)
    kind, _halo = _FUSED[stencil.name]
    if not fits(stencil, k):
        raise ValueError(f"fused_step: {stencil.name} k={k} window exceeds "
                         f"{SMEM_LIMIT} bytes of shared memory")
    n, (Z, Y, X) = _build.batch_of(fields[0])
    _build.check_operands("fused_step", *fields, shape=(Z, Y, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty_like(f) for f in fields)
    two = len(fields) == 2
    lib = _lib()
    rc = _build.entry(lib, "fused_step", fields[0])(
        kind, *_pointers(fields, two), *_pointers(outs, two),
        Z, Y, X, k, int(periodic), *_tail(stencil, k, (Z, Y, X), fields, n))
    _build.check(lib, rc, "fused_step")
    launches[_build.launch_key("fused_step", stencil.name, fields[0],
                               n)] += 1
    return outs


def _pad_window_axis(f: torch.Tensor, d: int, h: int, wrap: bool):
    """``f`` extended by ``h`` cells at both ends of axis ``d``: wrapped, or
    the edge cell repeated (a value that only feeds pinned or cropped
    cells)."""
    n = f.shape[d]
    if wrap:
        lo, hi = f.narrow(d, n - h, h), f.narrow(d, 0, h)
    else:
        shape = list(f.shape)
        shape[d] = h
        lo = f.narrow(d, 0, 1).expand(shape)
        hi = f.narrow(d, n - 1, 1).expand(shape)
    return torch.cat([lo, f, hi], dim=d)


def _plain_window_steps(window: Fields, stencil: Stencil, k: int,
                        origin: Sequence[int], global_shape: Sequence[int],
                        periodic: bool, wrap_axes: Sequence[int]) -> Fields:
    """k plain steps of ``stencil`` on a window whose first cell sits at
    global index ``origin``: the plain version of the sharded kernels.

    Axes in ``wrap_axes`` span the whole grid and wrap when ``periodic``;
    the others are cut from a larger domain, and their outer k-step margin
    (``k_step_margin``) comes out stale — the caller crops it.  The frame
    is pinned on global coordinates, as in the kernels.  A multi-phase
    stencil (red-black SOR) runs its phases in turn, each padded and
    pinned; its half-sweeps colour cells by block-local parity, so on a
    window whose origin has an odd coordinate sum they run in swapped
    order, which relaxes the global red cells first, as the kernels do.
    """
    h = stencil.halo
    ndim = stencil.ndim
    lead = window[0].dim() - ndim  # a batched window's member axis
    mask = None
    if not periodic:
        mask = frame_mask(window[0].shape[lead:], global_shape, origin, h,
                          device=window[0].device)
    updates = stencil.phases or (stencil.update,)
    if stencil.parity_sensitive and sum(int(o) for o in origin) % 2:
        updates = updates[::-1]
    fields = window
    for _ in range(k):
        for update in updates:
            padded = []
            for f, fh in zip(fields, stencil.field_halos):
                for d in range(ndim):
                    if fh:
                        f = _pad_window_axis(f, d + lead, fh,
                                             periodic and d in wrap_axes)
                padded.append(f)
            new = update(tuple(padded))
            out = []
            for i, nf in enumerate(new):
                j = stencil.carry_map[i]
                if j is not None:
                    out.append(fields[j])
                elif mask is None or not stencil.mask_fields[i]:
                    out.append(nf)
                else:
                    out.append(torch.where(mask, fields[i], nf))
            fields = tuple(out)
    return fields


def plain_step_padded(padded: Fields, stencil: Stencil, k: int,
                      global_shape: Sequence[int], origins: Sequence[int],
                      periodic: bool = False) -> Fields:
    """The plain version of K3's sharded mode: k plain steps of the padded
    window, cropped to its core (arguments as :func:`fused_step_padded`)."""
    m = k_step_margin(stencil, k)
    Zp, Yp, _ = (int(s) for s in padded[0].shape[-3:])
    oz, oy = (int(o) for o in origins)
    out = _plain_window_steps(padded, stencil, k, (oz - m, oy - m, 0),
                              global_shape, periodic, wrap_axes=(2,))
    return tuple(f[..., m:Zp - m, m:Yp - m, :].contiguous() for f in out)


def fused_step_padded(padded: Fields, stencil: Stencil, k: int,
                      global_shape: Sequence[int], origins: Sequence[int],
                      periodic: bool = False,
                      label: str = "fused_step_padded") -> Fields:
    """K3's sharded mode: ``k`` steps of one shard.

    ``padded`` are the shard's fields padded by the k-step margin ``m`` on
    z and y (the width-m halo exchange); ``origins`` the global (z, y) index
    of the shard's first core cell in a ``global_shape`` grid.  Returns the
    (Z, Y, X) core of every field, k steps on.  ``label`` names the launch
    counter (``fused_shell`` for the overlap shells).  Batched ``(N, Zp,
    Yp, X)`` blocks give ``(N, Z, Y, X)`` cores, in one launch.
    """
    m = k_step_margin(stencil, k)
    n, (Zp, Yp, X) = _build.batch_of(padded[0])
    Z, Y = Zp - 2 * m, Yp - 2 * m
    oz, oy = (int(o) for o in origins)
    if not padded[0].is_cuda:
        return plain_step_padded(padded, stencil, k, global_shape, origins,
                                 periodic)
    kind, _halo = _FUSED[stencil.name]
    if not fits(stencil, k) or min(Z, Y) < 1:
        raise ValueError(f"{label}: {stencil.name} k={k} on "
                         f"{(Zp, Yp, X)} not supported")
    _build.check_operands(label, *padded, shape=(Zp, Yp, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty((n,) * bool(n) + (Z, Y, X), dtype=p.dtype,
                             device=p.device)
                 for p in padded)
    two = len(padded) == 2
    lib = _lib()
    GZ, GY, GX = (int(g) for g in global_shape)
    rc = _build.entry(lib, "fused_step_padded", padded[0])(
        kind, *_pointers(padded, two), *_pointers(outs, two), Z, Y, X,
        GZ, GY, GX, oz, oy, k, int(periodic),
        *_tail(stencil, k, (Z, Y, X), padded, n))
    _build.check(lib, rc, label)
    launches[_build.launch_key(label, stencil.name, padded[0], n)] += 1
    return outs


def plain_zslab(core: Fields, zlo: Fields, zhi: Fields, stencil: Stencil,
                k: int, global_z: int, origin_z: int,
                periodic: bool = False) -> Fields:
    """The plain version of K6: k plain steps of each field's (Lz+2m, Y, X)
    window, the core between its two slabs, cropped to the core
    (arguments as :func:`fused_zslab`)."""
    m = k_step_margin(stencil, k)
    Lz, Y, X = (int(s) for s in core[0].shape[-3:])
    window = tuple(torch.cat([lo, c, hi], dim=-3)
                   for c, lo, hi in zip(core, zlo, zhi))
    out = _plain_window_steps(window, stencil, k, (origin_z - m, 0, 0),
                              (global_z, Y, X), periodic, wrap_axes=(1, 2))
    return tuple(f[..., m:m + Lz, :, :].contiguous() for f in out)


def fused_zslab(core: Fields, zlo: Fields, zhi: Fields, stencil: Stencil,
                k: int, global_z: int, origin_z: int,
                periodic: bool = False) -> Fields:
    """K6: ``k`` steps of one z-only shard from its (Lz, Y, X) core and the
    exchanged (m, Y, X) z slabs below (``zlo``) and above (``zhi``) it, per
    field; ``origin_z`` is the core's first global z plane of ``global_z``.
    Returns the (Lz, Y, X) core of every field, k steps on; batched
    ``(N, ...)`` operands, every member's in one launch."""
    m = k_step_margin(stencil, k)
    n, (Lz, Y, X) = _build.batch_of(core[0])
    if not core[0].is_cuda:
        return plain_zslab(core, zlo, zhi, stencil, k, global_z, origin_z,
                           periodic)
    kind, _halo = _FUSED[stencil.name]
    if not fits(stencil, k):
        raise ValueError(f"fused_zslab: {stencil.name} k={k} window exceeds "
                         f"{SMEM_LIMIT} bytes of shared memory")
    _build.check_operands("fused_zslab", *core, shape=(Lz, Y, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    _build.check_operands("fused_zslab", core[0], *zlo, *zhi, shape=None,
                          dtype=_build.FLOAT_DTYPES, members=n)
    for s in (*zlo, *zhi):
        if tuple(s.shape) != (n,) * bool(n) + (m, Y, X):
            raise ValueError(f"fused_zslab: slabs must be {(m, Y, X)}, got "
                             f"{tuple(s.shape)}")
    outs = tuple(torch.empty_like(c) for c in core)
    two = len(core) == 2
    lib = _lib()
    rc = _build.entry(lib, "fused_zslab", core[0])(
        kind, *_pointers(core, two), *_pointers(zlo, two),
        *_pointers(zhi, two), *_pointers(outs, two), Lz, Y, X,
        int(global_z), int(origin_z), k, int(periodic),
        *_tail(stencil, k, (Lz, Y, X), (*core, *zlo, *zhi), n))
    _build.check(lib, rc, "fused_zslab")
    launches[_build.launch_key("fused_zslab", stencil.name, core[0],
                               n)] += 1
    return outs


def plain_yzslab(core: Fields, zlo: Fields, zhi: Fields, ylo: Fields,
                 yhi: Fields, corners: Sequence[Fields], stencil: Stencil,
                 k: int, global_shape: Sequence[int],
                 origins: Sequence[int], periodic: bool = False) -> Fields:
    """The plain version of K9: each field's (Lz+2m, Ly+2m, X) window
    assembled from the core and its eight pieces, through
    :func:`plain_step_padded` (arguments as :func:`fused_yzslab`)."""
    window = []
    for j, (c, zl, zh, yl, yh) in enumerate(zip(core, zlo, zhi, ylo, yhi)):
        c_ll, c_lh, c_hl, c_hh = (cs[j] for cs in corners)
        window.append(torch.cat([torch.cat([c_ll, zl, c_lh], dim=-2),
                                 torch.cat([yl, c, yh], dim=-2),
                                 torch.cat([c_hl, zh, c_hh], dim=-2)],
                                dim=-3))
    return plain_step_padded(tuple(window), stencil, k, global_shape,
                             origins, periodic)


def fused_yzslab(core: Fields, zlo: Fields, zhi: Fields, ylo: Fields,
                 yhi: Fields, corners: Sequence[Fields], stencil: Stencil,
                 k: int, global_shape: Sequence[int],
                 origins: Sequence[int], periodic: bool = False) -> Fields:
    """K9: ``k`` steps of one shard of a mesh that shards y.

    Per field: the (Lz, Ly, X) ``core``, the exchanged (m, Ly, X) z slabs
    below (``zlo``) and above (``zhi``) it, the (Lz, m, X) y slabs before
    (``ylo``) and after (``yhi``) it, and ``corners``, four tuples of
    (m, m, X) pieces in (z side, y side) order ll, lh, hl, hh
    (``halo.exchange_slabs_2axis``).  ``origins`` is the global (z, y)
    index of the core's first cell in a ``global_shape`` grid.  Returns
    the (Lz, Ly, X) core of every field, k steps on; batched ``(N, ...)``
    operands, every member's in one launch.
    """
    m = k_step_margin(stencil, k)
    n, (Lz, Ly, X) = _build.batch_of(core[0])
    if not core[0].is_cuda:
        return plain_yzslab(core, zlo, zhi, ylo, yhi, corners, stencil, k,
                            global_shape, origins, periodic)
    kind, _halo = _FUSED[stencil.name]
    if not fits(stencil, k):
        raise ValueError(f"fused_yzslab: {stencil.name} k={k} window exceeds "
                         f"{SMEM_LIMIT} bytes of shared memory")
    _build.check_operands("fused_yzslab", *core, shape=(Lz, Ly, X),
                          dtype=_build.FLOAT_DTYPES, members=n)
    for pieces, shape in ((zlo, (m, Ly, X)), (zhi, (m, Ly, X)),
                          (ylo, (Lz, m, X)), (yhi, (Lz, m, X)),
                          *((c, (m, m, X)) for c in corners)):
        _build.check_operands("fused_yzslab", *pieces, shape=shape,
                              dtype=_build.FLOAT_DTYPES, members=n)
        _build.check_operands("fused_yzslab", core[0], pieces[0],
                              dtype=_build.FLOAT_DTYPES, members=n)
    outs = tuple(torch.empty_like(c) for c in core)
    two = len(core) == 2
    lib = _lib()
    GZ, GY, GX = (int(g) for g in global_shape)
    oz, oy = (int(o) for o in origins)
    rc = _build.entry(lib, "fused_yzslab", core[0])(
        kind, *_pointers(core, two), *_pointers(zlo, two),
        *_pointers(zhi, two), *_pointers(ylo, two), *_pointers(yhi, two),
        *(p for c in corners for p in _pointers(c, two)),
        *_pointers(outs, two), Lz, Ly, X, GZ, GY, GX, oz, oy, k,
        int(periodic), *_tail(stencil, k, (Lz, Ly, X),
                              (*core, *zlo, *zhi, *ylo, *yhi,
                               *(f for c in corners for f in c)), n))
    _build.check(lib, rc, "fused_yzslab")
    launches[_build.launch_key("fused_yzslab", stencil.name, core[0],
                               n)] += 1
    return outs


def build_fused_call(
    stencil: Stencil,
    core_shape: Tuple[int, int, int],
    k: int,
    sharded_global: Optional[Tuple[int, int, int]] = None,
    periodic: bool = False,
    device=None,
    label: str = "fused_step_padded",
):
    """K3's sharded mode over one shard's (core) block of ``core_shape``.

    Returns ``(call, margin, nfields)`` or None.  The call takes the fields
    padded by ``margin`` on z and y — with ``sharded_global`` (the global
    grid shape, guard-frame runs) first an ``(oz, oy)`` pair, the shard's
    global origin, from which the kernel derives the frame — and returns
    the ``core_shape`` fields advanced k steps.  None where the TPU builder
    declines for a structural reason: no fused kernel, ``2 * m`` off
    the alignment unit, a periodic wrap over an odd extent for a
    parity-sensitive stencil, or a local z/y extent below the margin (a width-m
    slab must come from one neighbour); also for a window too large for
    shared memory.  The TPU VMEM tiling rule (``_pick_tiles``) does not
    apply: the kernel masks ragged blocks.  ``label`` names the launch
    counter.
    """
    margin = margin_of(stencil, k)
    if margin is None or not parity_consistent(stencil, core_shape,
                                               periodic):
        return None
    Z, Y, X = (int(s) for s in core_shape)
    if min(Z, Y) < margin:
        return None
    gshape = (Z, Y, X) if sharded_global is None else tuple(sharded_global)
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    if sharded_global is None:
        def call(*padded):
            return fused_step_padded(padded, stencil, k, gshape, (0, 0),
                                     periodic=periodic, label=label)
    else:
        def call(origins, *padded):
            return fused_step_padded(padded, stencil, k, gshape, origins,
                                     periodic=periodic, label=label)

    return call, margin, stencil.num_fields


def build_zslab_padfree_call(
    stencil: Stencil,
    local_shape: Tuple[int, int, int],
    global_shape: Tuple[int, int, int],
    k: int,
    periodic: bool = False,
    device=None,
):
    """K6 over a z-only shard: ``(call, margin, nfields)`` or None.

    The call takes the shard's global z origin, then per field the
    (Lz, Y, X) core, the lower and the upper (m, Y, X) slab, and returns
    the core fields advanced k steps.  None as for :func:`build_fused_call`
    (a local z extent below the margin included).
    """
    margin = margin_of(stencil, k)
    if margin is None or not parity_consistent(stencil, global_shape,
                                               periodic):
        return None
    Lz = int(local_shape[0])
    if Lz < margin:
        return None
    gz = int(global_shape[0])
    nf = stencil.num_fields
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    def call(origin_z, *args):
        core, zlo, zhi = args[0::3], args[1::3], args[2::3]
        assert len(core) == nf
        return fused_zslab(core, zlo, zhi, stencil, k, gz, origin_z,
                           periodic=periodic)

    return call, margin, nf


def build_yzslab_padfree_call(
    stencil: Stencil,
    local_shape: Tuple[int, int, int],
    global_shape: Tuple[int, int, int],
    k: int,
    periodic: bool = False,
    device=None,
):
    """K9 over a shard of a mesh that shards y: ``(call, margin, nfields)``
    or None.

    The call takes the shard's global ``(oz, oy)`` origin, then per field
    the (Lz, Ly, X) core, the two (m, Ly, X) z slabs, the two (Lz, m, X) y
    slabs and the four (m, m, X) corner pieces (ll, lh, hl, hh), and
    returns the core fields advanced k steps.  None where the TPU builder
    declines for a structural reason: no fused kernel, ``2 * m``
    off the alignment unit, a periodic wrap over an odd global extent for a
    parity-sensitive stencil, or a local z or y extent below the margin;
    also for a window too large for shared memory.  The TPU tiling rule
    and its 2m duplication of the y operands (sublane alignment) do not
    apply: the kernel masks ragged blocks and reads m-wide pieces.
    """
    margin = margin_of(stencil, k)
    if margin is None or not parity_consistent(stencil, global_shape,
                                               periodic):
        return None
    Lz, Ly = int(local_shape[0]), int(local_shape[1])
    if min(Lz, Ly) < margin:
        return None
    gshape = tuple(int(g) for g in global_shape)
    nf = stencil.num_fields
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    def call(origins, *args):
        if len(args) != 9 * nf:
            raise ValueError(f"fused_yzslab call: {9 * nf} operands (9 per "
                             f"field), got {len(args)}")
        per = [args[i::9] for i in range(9)]
        core, zlo, zhi, ylo, yhi = per[:5]
        return fused_yzslab(core, zlo, zhi, ylo, yhi, per[5:], stencil, k,
                            gshape, origins, periodic=periodic)

    return call, margin, nf


def build_overlap_shell_calls(
    stencil: Stencil,
    local_shape: Tuple[int, int, int],
    global_shape: Tuple[int, int, int],
    k: int,
    axes: Sequence[int],
    periodic: bool = False,
    device=None,
):
    """The overlapped fused step's boundary shells: ``{axis: call}`` or
    None.

    For each sharded grid axis ``d`` in ``axes`` (0 or 1: x is never
    sharded), K3's sharded mode over a reduced core whose axis-``d``
    extent is ``2m`` (m the k-step margin): the shell at one face of the local
    block.  A call takes what :func:`build_fused_call`'s takes — with a
    guard frame first the shell core's global ``(oz, oy)`` origin, which
    the caller offsets by the shell's position — and fields padded by m
    whose axis-``d`` extent is 4m: the exchanged slab plus a 3m-deep local
    strip.  Its launches count as ``fused_shell[<stencil>]``.  None when
    the geometry cannot host the split (a local extent below 3m on an
    axis in ``axes``) or the kernel does not take (stencil, k): callers
    run the non-split step.
    """
    margin = margin_of(stencil, k)
    if margin is None:
        return None
    shells = {}
    for d in axes:
        if d not in (0, 1) or int(local_shape[d]) < 3 * margin:
            return None
        core = [int(s) for s in local_shape]
        core[d] = 2 * margin
        built = build_fused_call(
            stencil, tuple(core), k,
            sharded_global=None if periodic else tuple(global_shape),
            periodic=periodic, device=device, label="fused_shell")
        if built is None:
            return None
        shells[d] = built[0]
    return shells


def make_fused_step(
    stencil: Stencil,
    global_shape: Sequence[int],
    k: int,
    periodic: bool = False,
    device=None,
) -> Optional[Callable[[Fields], Fields]]:
    """``fields -> fields`` advancing ``k`` steps in one kernel pass, or None.

    Semantically ``k`` applications of ``driver.make_step``.  Returns None
    for the (stencil, k) pairs the TPU package's ``make_fused_step`` rejects
    by its alignment rule — ``2 * m`` (m = ``k_step_margin``) a multiple of
    8 for float32 (16 for bfloat16): halo-1 stencils need k in {4, 8, ...},
    heat3d4th and sor3d k in {2, 4, ...} — or its parity rule (sor3d
    periodic over an odd extent), and for windows too large for shared
    memory (halo-1 k >= 12 in float32 and k >= 16 in bfloat16, heat3d4th
    and sor3d k >= 6 in float32 and k >= 8 in bfloat16, grayscott3d k >= 8
    in float32).  Any other grid extent is accepted: the kernel masks the
    ragged edge.  With a CUDA ``device`` the kernels are built here, before
    the time loop.
    """
    if len(global_shape) != 3 or margin_of(stencil, k) is None or \
            not parity_consistent(stencil, global_shape, periodic):
        return None
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    def step_k(fields: Fields) -> Fields:
        return fused_step(fields, stencil, k, periodic=periodic)

    return step_k
