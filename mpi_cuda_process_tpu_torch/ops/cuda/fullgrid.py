"""2D temporal blocking, k steps per device-memory pass: K8.

``fullgrid_step`` (``csrc/fullgrid.cu``) advances heat2d / mdf, wave2d,
life, advect2d, grayscott2d or sor2d (2k one-colour half-sweeps) by k
guard-frame (or periodic) steps on the whole grid; ``fullgrid_padded`` does
the same for one row shard from its padded block (the width-m row
exchange) and the shard's global first row.  A guard-frame launch runs the
streaming kind (``csrc/ring.cuh``, K10's kernel with the 2D kinds: a
TX-wide strip of a chunk of rows marched down the rows as a wavefront of
k levels, one barrier a row, no y margin recomputed; ``RING_TILES`` picks
the strip, the chunk and the threads, ``PATHS`` the block-uniform fast
paths, ``streamfused.ring_slots`` the rings); a periodic launch, one
over fewer rows than ``RING_MIN_LEADS`` lead-ins (an overlap shell), or
one whose levels outnumber a block's warps, the tiled kind
(``fullgrid_step<KIND, RAW|PADDED>``: overlapped windows of ``CORE``).
Both are bit-exact with k plain steps.  The float families take float32
or bfloat16 (``_build.FLOAT_DTYPES``: the 4-byte export and its ``_bf16``
twin; a bfloat16 launch is counted as ``fullgrid_step[heat2d,bfloat16]``),
with windows in the field's type, so a bfloat16 window takes half the
shared memory; Life takes int32.

Replaces the TPU package's ``ops/pallas/fullgrid.py`` — ``_build_call`` with
``_micro_life`` and the ``_MICRO2D`` micro-steps of heat2d, mdf, wave2d,
advect2d, grayscott2d and sor2d — behind the same two builders,
:func:`make_fullgrid_step` and :func:`build_fullgrid_masked_call`.  The TPU
kernel keeps the whole grid in VMEM; an SM's shared memory holds a small
fraction of it, so K8 tiles the grid into overlapped windows (the kernel
source says how).  The TPU rules that follow from VMEM and the (8, 128)
tiling — ``W % 128``, ``m`` and the local rows a multiple of the sublane,
the live-copy VMEM budget — do not apply; added is the shared-memory fit of
one window, and for sor2d the parity rules those alignment rules implied
(even extents under a periodic wrap, even local rows under a row split).
Bound on an H100: device-memory bytes, one read and one write of each field
per k steps.

Plain PyTorch versions: k applications of ``driver.make_step`` for the
whole grid; for a shard, k plain steps of its padded block
(``fused._plain_window_steps``), which equal k plain sharded steps on the
shard's rows.  A wrapper takes its plain version only for tensors on the
CPU.

Both wrappers take batched fields (an ensemble run's leading member axis,
``(N, H, W)``) and advance every member in one launch a ``K_PER_LAUNCH``
micro-steps: the tiled kind's launch grid has the member in z, the
streaming kind folds the members into its z of row chunks (chunks x N at
most 65535), and ``chunk_rows`` fits the chunks to the card for all N
members' columns.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Optional, Sequence, Tuple

import torch

from ...driver import make_step
from .. import reaction, sor
from ..stencil import Fields, Stencil, dtype_name, k_step_margin
from . import _build
from .fused import (SMEM_LIMIT, _plain_window_steps, buffers,
                    parity_consistent)
from .streamfused import (FRAME_FREE, VEC_LOAD, _fit, level_warps_fit,
                          levels, ring_slots)
from .streamfused import smem_bytes as ring_smem_bytes

# Launches per wrapper and stencil, keyed "fullgrid_step[life]" or
# "fullgrid_padded[heat2d]" (bfloat16: "fullgrid_padded[heat2d,bfloat16]",
# ``_build.launch_key``): one added where a kernel launches, nowhere else.
# ``launches.clear()`` resets.
launches: Counter = Counter()

# name -> kernel kind of csrc/stencil2d.cuh.  mdf is heat2d under another
# registry name (its stencil's name is "heat2d").
_FULLGRID = {"heat2d": 4, "wave2d": 5, "life": 6, "advect2d": 9,
             "grayscott2d": 10, "sor2d": 12}


def _dtypes(stencil: Stencil):
    """The field types K8 takes for ``stencil``: int32 for Life, float32
    or bfloat16 for the rest."""
    return (torch.int32,) if stencil.name == "life" else _build.FLOAT_DTYPES

# Core tile (TY, TX) each block writes; threads stride over it as (8, 32).
CORE = (32, 64)
# Margin of one launch of the whole-grid kernel (its micro-steps: sor2d's
# half-sweeps): a larger k runs as several launches (the window margin, and
# so the redundant work, grows with the micro-steps of one launch).
K_PER_LAUNCH = 16
# The streaming kind's launch tile per (stencil, dtype, k): the strip width
# TX, the rows of a chunk CZ, the block's threads and the blocks an SM its
# build is for (csrc/ring.cuh), the fastest of
# scripts/torch_fullgrid_tiles.py's candidates at 16384^2 on an H100 (a
# strip whose level rows fit one strip of registers per thread).  A pair
# not listed, or a tile whose rings overflow shared memory or whose levels
# outnumber its warps, takes RING_FIT (with a warp a level).
RING_FIT = (256, 512)
_R, _R352 = (480, 512, 512, 2), (352, 1024, 512, 2)
RING_TILES = {
    ("heat2d", "float32", 8): _R, ("heat2d", "bfloat16", 16): _R,
    ("life", "int32", 8): _R, ("wave2d", "float32", 8): (224, 1024, 512, 2),
    ("wave2d", "bfloat16", 16): _R,
    ("advect2d", "float32", 8): _R, ("advect2d", "bfloat16", 16): _R,
    ("grayscott2d", "float32", 8): _R352,
    ("grayscott2d", "bfloat16", 16): _R352,
    ("sor2d", "float32", 8): _R352, ("sor2d", "bfloat16", 8): _R,
}
# The fewest lead-ins of core rows a launch needs to take the streaming
# kind (``ring_ok``): below it, the lead-in outweighs the rows.
RING_MIN_LEADS = 2
# The streaming kind's fast paths (csrc/ring.cuh ``paths``): 16-byte row
# copies where every operand's address is 16-byte aligned, no x frame test
# where no updated cell is frame.  0 runs its per-cell path alone (the
# CUDA tests, scripts/torch_fullgrid_tiles.py).
PATHS = VEC_LOAD | FRAME_FREE

_c_float, _c_int, _c_ptr = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def fullgrid_supported(stencil: Stencil) -> bool:
    """Whether K8 has the stencil's micro-step (every 2D family of the TPU
    kernel)."""
    return stencil.ndim == 2 and stencil.name in _FULLGRID


def smem_bytes(m: int, itemsize: int = 4, nbuf: int = 2) -> int:
    """``nbuf`` window buffers of ``CORE + 2m`` cells at margin ``m``
    (``fused.buffers``: two, or four for Gray-Scott, whose two fields are
    both read with their neighbours)."""
    ty, tx = CORE
    return nbuf * itemsize * (ty + 2 * m) * (tx + 2 * m)


def fits(stencil: Stencil, k: int) -> bool:
    """Whether one launch of k steps of ``stencil`` (margin
    ``k_step_margin``) fits a block's shared memory, in the stencil's
    dtype."""
    return smem_bytes(k_step_margin(stencil, k), stencil.dtype.itemsize,
                      buffers(stencil)) <= SMEM_LIMIT


def ring_tile(stencil: Stencil, k: int) -> Tuple[int, int, int, int]:
    """The streaming kind's launch tile ``(TX, CZ, threads, blocks)`` for k
    steps:
    the RING_TILES entry where its rings fit and it has a warp a level,
    else RING_FIT."""
    tile = RING_TILES.get((stencil.name, dtype_name(stencil.dtype), int(k)))
    return _fit(stencil, k, tile, RING_FIT)


def _lead(stencil: Stencil, k: int) -> int:
    """Rows a chunk of the streaming kind spends before its first output
    row: its 2m lead-in rows and a wavefront filled over K (h + 1)."""
    return 2 * k_step_margin(stencil, k) + levels(stencil, k) * (
        stencil.halo + 1)


def ring_ok(stencil: Stencil, k: int, periodic: bool, rows: int) -> bool:
    """Whether a launch of k steps over ``rows`` core rows runs the
    streaming kind: guard-frame, at least RING_MIN_LEADS lead-ins of rows
    (an overlap shell's 2m rows cost the streaming kind more in lead-in
    than they compute: the tiled kind takes them), a warp a level, and its
    rings fit at RING_FIT."""
    return (not periodic and rows >= RING_MIN_LEADS * _lead(stencil, k)
            and level_warps_fit(levels(stencil, k), 1024)
            and ring_smem_bytes(stencil, k, RING_FIT) <= SMEM_LIMIT)


def chunk_rows(stencil: Stencil, k: int, rows: int, width: int,
               tile: Sequence[int], slots: int, members: int = 1) -> int:
    """The rows of a block's chunk: the tile's CZ, or fewer where more
    chunks fill the card's last wave of blocks (``slots``: the blocks the
    card holds at once) for less than they add in lead-in rows (each chunk
    re-reads 2m rows and fills its wavefront over K (h + 1) more).
    Minimises waves x (rows a chunk + lead-in) over up to 4 times the
    tile's chunks (``_build.fit_runs``), with the strips of all
    ``members`` of a batched launch side by side; never so few rows that
    the chunks of all members outgrow the launch grid's z (65535)."""
    tx, cz = int(tile[0]), int(tile[1])
    members = max(1, int(members))
    fit = _build.fit_runs(rows, cz, -(-width // tx) * members,
                          _lead(stencil, k), slots)
    return max(fit, -(-rows // max(1, 65535 // members)))


def _ring_tail(stencil: Stencil, k: int, rows: int, operands,
               members: int = 0):
    """The streaming exports' trailing arguments: coefficients, the tile
    (its chunk fitted to the card for every member: ``chunk_rows``), the
    ring slots and the fast paths, the members (1 unbatched), then the
    stream."""
    paths = PATHS & ~VEC_LOAD if any(t.data_ptr() % 16 for t in operands) \
        else PATHS
    tx, cz, threads, blocks = ring_tile(stencil, k)
    cz = chunk_rows(stencil, k, rows, int(operands[0].shape[-1]),
                    (tx, cz), _build.sm_count(operands[0].device) * blocks,
                    members)
    return (*_coefficients(stencil), tx, cz, threads, blocks,
            *ring_slots(stencil, k), paths, max(1, members),
            _build.stream_of(operands[0]))


def _steps_per_launch(stencil: Stencil) -> int:
    """Steps of one launch: ``K_PER_LAUNCH`` micro-steps (sor2d: half-
    sweeps, two a step)."""
    return K_PER_LAUNCH * stencil.halo // k_step_margin(stencil, 1)


def _coefficients(stencil: Stencil):
    """``(a, c0, c1, c2, c3)`` of the kernel's ``Coef``: alpha (heat2d),
    c2dt2 (wave2d), omega / 4 (sor2d, its half-sweeps' alpha), the Courant
    numbers (cy, cx) (advect2d) or (Du, Dv, F, F + kappa) (grayscott2d)."""
    p = stencil.params
    if stencil.name == "sor2d":
        return (sor.alpha(stencil), 0.0, 0.0, 0.0, 0.0)
    if stencil.name == "advect2d":
        return tuple(p["courant"]) + (0.0, 0.0, 0.0)
    if stencil.name == "grayscott2d":
        return reaction.coefficients(stencil) + (0.0,)
    return (float(p.get("alpha", p.get("c2dt2", 0.0))), 0.0, 0.0, 0.0, 0.0)


def _lib():
    lib = _build.load("fullgrid")
    if lib.fullgrid_raw.argtypes is None:
        for sfx in ("", "_bf16"):
            getattr(lib, f"fullgrid_raw{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 4 + [_c_float] * 5
                + [_c_int] * 3 + [_c_ptr])
            getattr(lib, f"fullgrid_padded{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 6 + [_c_float] * 5
                + [_c_int] * 3 + [_c_ptr])
            getattr(lib, f"fullgrid_ring_raw{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 3 + [_c_float] * 5
                + [_c_int] * 8 + [_c_ptr])
            getattr(lib, f"fullgrid_ring_padded{sfx}").argtypes = (
                [_c_int] + [_c_ptr] * 4 + [_c_int] * 5 + [_c_float] * 5
                + [_c_int] * 8 + [_c_ptr])
    return lib


def _pointers(tensors):
    return (tensors[0].data_ptr(),
            tensors[1].data_ptr() if len(tensors) == 2 else None)


def fullgrid_step(fields: Fields, stencil: Stencil, k: int,
                  periodic: bool = False) -> Fields:
    """``k`` steps of ``stencil`` on the whole 2D grid: one launch per
    ``K_PER_LAUNCH`` micro-steps (sor2d: half of them), every member of
    batched ``(N, H, W)`` fields in it."""
    if not fields[0].is_cuda:
        step = make_step(stencil, fields[0].shape[-2:], periodic=periodic)
        for _ in range(k):
            fields = step(fields)
        return fields
    kind = _FULLGRID[stencil.name]
    n, (H, W) = _build.batch_of(fields[0], 2)
    _build.check_operands("fullgrid_step", *fields, shape=(H, W),
                          dtype=_dtypes(stencil), ndim=2, members=n)
    lib = _lib()
    coef = _coefficients(stencil)
    key = _build.launch_key("fullgrid_step", stencil.name, fields[0], n)
    left = k
    while left > 0:
        kk = min(left, _steps_per_launch(stencil))
        outs = tuple(torch.empty_like(f) for f in fields)
        if ring_ok(stencil, kk, periodic, H):
            rc = _build.twin_entry(lib, "fullgrid_ring_raw", fields[0])(
                kind, *_pointers(fields), *_pointers(outs), H, W, kk,
                *_ring_tail(stencil, kk, H, (*fields, *outs), n))
        else:
            rc = _build.twin_entry(lib, "fullgrid_raw", fields[0])(
                kind, *_pointers(fields), *_pointers(outs), H, W, kk,
                int(periodic), *coef, *CORE, max(1, n),
                _build.stream_of(fields[0]))
        _build.check(lib, rc, "fullgrid_step")
        launches[key] += 1
        fields, left = outs, left - kk
    return fields


def fullgrid_padded(padded: Fields, stencil: Stencil, k: int,
                    global_rows: int, origin_y: int,
                    periodic: bool = False) -> Fields:
    """K8's sharded mode: ``k`` steps of one row shard.

    ``padded`` are the shard's fields with ``m = k_step_margin`` rows (k;
    2k for sor2d) from the row exchange on each side, ``(Ly + 2m, W)``;
    ``origin_y`` is the global row of the shard's first core row in a
    ``global_rows``-row grid.  Returns
    the ``(Ly, W)`` core of every field, k steps on; batched ``(N, Ly +
    2m, W)`` blocks give every member's core from one launch.
    """
    m = k_step_margin(stencil, k)
    n, (Hp, W) = _build.batch_of(padded[0], 2)
    Ly = Hp - 2 * m
    if not padded[0].is_cuda:
        out = _plain_window_steps(padded, stencil, k, (origin_y - m, 0),
                                  (global_rows, W), periodic, wrap_axes=(1,))
        return tuple(f[..., m:m + Ly, :].contiguous() for f in out)
    kind = _FULLGRID[stencil.name]
    if not fits(stencil, k) or Ly < 1:
        raise ValueError(f"fullgrid_padded: {stencil.name} k={k} on "
                         f"{(Hp, W)} not supported")
    _build.check_operands("fullgrid_padded", *padded, shape=(Hp, W),
                          dtype=_dtypes(stencil), ndim=2, members=n)
    outs = tuple(torch.empty((n,) * bool(n) + (Ly, W), dtype=p.dtype,
                             device=p.device)
                 for p in padded)
    lib = _lib()
    if ring_ok(stencil, k, periodic, Ly):
        rc = _build.twin_entry(lib, "fullgrid_ring_padded", padded[0])(
            kind, *_pointers(padded), *_pointers(outs), Ly, W,
            int(global_rows), int(origin_y), k,
            *_ring_tail(stencil, k, Ly, (*padded, *outs), n))
    else:
        rc = _build.twin_entry(lib, "fullgrid_padded", padded[0])(
            kind, *_pointers(padded), *_pointers(outs), Ly, W,
            int(global_rows), int(origin_y), k, int(periodic),
            *_coefficients(stencil), *CORE, max(1, n),
            _build.stream_of(padded[0]))
    _build.check(lib, rc, "fullgrid_padded")
    launches[_build.launch_key("fullgrid_padded", stencil.name,
                               padded[0], n)] += 1
    return outs


def make_fullgrid_step(
    stencil: Stencil,
    global_shape: Sequence[int],
    k: int,
    periodic: bool = False,
    device=None,
) -> Optional[Callable[[Fields], Fields]]:
    """``fields -> fields`` advancing ``k`` steps of a 2D stencil, or None
    (not a 2D family of the kernel, k < 1, or sor2d periodic over an odd
    extent).  Any other extent and any k run: the kernel masks the ragged
    edge, and k above ``K_PER_LAUNCH`` micro-steps takes several launches.
    With a CUDA ``device`` the kernel is built here, before the time
    loop."""
    if len(global_shape) != 2 or k < 1 or not fullgrid_supported(stencil) \
            or not parity_consistent(stencil, global_shape, periodic):
        return None
    if device is not None and torch.device(device).type == "cuda":
        _lib()

    def step_k(fields: Fields) -> Fields:
        return fullgrid_step(fields, stencil, k, periodic=periodic)

    return step_k


def build_fullgrid_masked_call(
    stencil: Stencil,
    padded_shape: Tuple[int, int],
    m: int,
    k: int,
    periodic: bool = False,
    global_shape=None,
    device=None,
):
    """K8 over one row shard's padded block: ``(call, nfields)`` or None.

    The caller exchanges width-``m`` rows (``m = k_step_margin``: k, 2k
    for sor2d), so the blocks are ``(Ly + 2m, W)``.  In guard-frame mode the
    call takes the shard's global first row first, then the padded fields;
    periodic calls take the fields alone.  It returns the ``(Ly, W)`` cores
    advanced k steps.  None for a family without a kernel, ``m`` other than
    the k-step margin, local rows below ``m`` (a width-m slab must come from
    one neighbour), a guard-frame call without ``global_shape``, or a window
    too large for shared memory.
    """
    if m < 1 or k < 1 or not fullgrid_supported(stencil):
        return None
    if not periodic and global_shape is None:
        return None
    Hp, _W = (int(s) for s in padded_shape)
    if m != k_step_margin(stencil, k) or Hp - 2 * m < m or \
            not fits(stencil, k):
        return None
    rows = None if global_shape is None else int(global_shape[0])
    if device is not None and torch.device(device).type == "cuda":
        _lib()
    nf = stencil.num_fields

    if periodic:
        def call(*padded):
            return fullgrid_padded(padded, stencil, k, Hp - 2 * m, 0,
                                   periodic=True)
    else:
        def call(origin_y, *padded):
            return fullgrid_padded(padded, stencil, k, rows, origin_y)

    return call, nf
