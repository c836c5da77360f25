"""The streaming kernel's schedule (csrc/ring.cuh), run on the CPU.

The kernel marches each block's column (2D: a strip of one row) down the
march axis as a wavefront of K levels, level s computing plane
``p + 1 - s (h + 1)`` in iteration p, all levels between one barrier and
the next.  Each level keeps its planes in a ring of ``ring_slots`` planes,
slot ``(z - zb) % S``.  :func:`run` replays that order with plain PyTorch
updates (the stencil's own ``update``, so the rounding is the plain one)
on rings of exactly those slot counts, and makes every race the card could
see visible: a slot whose plane is in flight (a load issued, not waited
for), or is being written in the current iteration, holds NaN (Life: -1)
for the whole iteration, and a plane evicted by a newer one is gone.  Each
slot also records which plane it holds, and a read of a slot that does not
hold the plane the schedule expects there raises :class:`Race` — on the
card, a silent race.  The committed counts give k plain steps bit for
bit.
"""

from __future__ import annotations

import math

import torch

from mpi_cuda_process_tpu_torch.driver import frame_mask
from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin


class Race(AssertionError):
    """A level read a ring slot that did not hold the plane it needed."""


def _edge_pad(t, widths):
    """``t`` extended at the end of each axis d by ``widths[d]`` copies of
    its last cell (the cells a ragged block reads past the window: they
    feed only cells the output mask drops)."""
    for d, w in enumerate(widths):
        if w > 0:
            shape = list(t.shape)
            shape[d] = w
            t = torch.cat([t, t.narrow(d, t.shape[d] - 1, 1).expand(shape)],
                          dim=d)
    return t


def run(stencil, k, window, core_shape, origin, global_shape, tile, slots,
        in_flight, chunk=None):
    """k guard-frame steps of the core, by the kernel's schedule.

    ``window``: per field, the cells the kernel's window source gives for
    local coordinates [-m, n_d + m) of every axis (m = k_step_margin), as
    ``window.cuh::cell_ptr`` reads them.  ``origin``: the global index of
    core cell 0; ``global_shape``: the frame.  ``tile``: the block's core
    extent on each in-plane axis (axes 1..); ``chunk``: planes of the march
    axis a block outputs (None: all).  ``slots``: (S0, S1) of the rings.
    Returns the core of every field, k steps on."""
    ndim = stencil.ndim
    h = stencil.halo
    m = k_step_margin(stencil, k)
    K = m // h
    S0, S1 = slots
    Z = core_shape[0]
    CZ = Z if chunk is None else chunk
    nf = stencil.num_fields
    # fields whose neighbours a level reads: wave's u only
    ringed = [f for f in range(nf) if stencil.field_halos[f]]
    inplane = list(range(1, ndim))
    nblocks = [math.ceil(core_shape[d] / tile[d - 1]) for d in inplane]
    # pad the window so every block's level-0 region lies in it
    win = [_edge_pad(w, [0] + [nb * tile[d - 1] - core_shape[d]
                               for d, nb in zip(inplane, nblocks)])
           for w in window]
    out = [torch.empty(tuple(core_shape), dtype=window[0].dtype)
           for _ in range(nf)]
    poison = float("nan") if window[0].is_floating_point() else -1
    phases = stencil.phases or None

    def block(zc0, t0):
        zc1 = min(zc0 + CZ, Z)
        zb = zc0 - m

        def e(lvl):
            return m if lvl == 0 else (K - lvl) * h

        def region(lvl):
            # window-index slices of the level's in-plane region
            return tuple(slice(t + m - e(lvl), t + tile[i] + m + e(lvl))
                         for i, t in enumerate(t0))

        def shape(lvl):
            return tuple(tile[i] + 2 * e(lvl) for i in range(len(t0)))

        rings = {0: [torch.full((S0,) + shape(0), poison,
                                dtype=window[0].dtype) for _ in range(nf)]}
        for lvl in range(1, K):
            rings[lvl] = {f: torch.full((S1,) + shape(lvl), poison,
                                        dtype=window[0].dtype)
                          for f in ringed}
        # the plane each slot holds (None: in flight or being written)
        held = {lvl: [None] * (S0 if lvl == 0 else S1) for lvl in rings}

        def slot(lvl, z):
            return (z - zb) % len(held[lvl])

        def put(lvl, z, values):
            """Slot of plane z of level lvl := values (None: poison)."""
            q = slot(lvl, z)
            held[lvl][q] = None if values is None else z
            for f, v in values.items() if values else (
                    (f, None) for f in (range(nf) if lvl == 0 else ringed)):
                rings[lvl][f][q] = poison if v is None else v

        def get(lvl, f, z):
            q = slot(lvl, z)
            if held[lvl][q] != z:
                raise Race(f"level {lvl + 1} read plane {z} of level {lvl} "
                           f"from slot {q}, which holds {held[lvl][q]}")
            return rings[lvl][f][q]

        def crop(t, c):
            return t[(slice(None),) + (slice(c, -c if c else None),)
                     * len(t0)]

        for p in range(zb, zc1 - 1 + K * (h + 1)):
            if p < zc1 + m:  # plane p has landed
                put(0, p, {f: win[f][(p + m,) + region(0)]
                           for f in range(nf)})
            q = p + in_flight  # issued now, in flight until iteration q
            if q < zc1 + m:
                put(0, q, None)
            active = [(s, p + 1 - s * (h + 1)) for s in range(1, K + 1)]
            active = [(s, z) for s, z in active
                      if zc0 - e(s) <= z < zc1 + e(s)]
            for s, z in active:  # written in this iteration
                if s < K:
                    put(s, z, None)
            results = []
            for s, z in active:
                padded, centre = [], {}
                for f in range(nf):
                    if f in ringed:
                        blk = torch.stack([get(s - 1, f, z - h + j)
                                           for j in range(2 * h + 1)])
                        padded.append(blk)
                        centre[f] = crop(blk[h:h + 1], h)
                    elif s == 1:  # wave: the loaded u_prev
                        padded.append(crop(get(0, f, z)[None], h))
                    else:  # wave: level s-2's u at plane z
                        padded.append(crop(get(s - 2, 0, z)[None], 2 * h))
                gorig = (origin[0] + z,) + tuple(
                    origin[d] + t0[d - 1] - e(s) for d in inplane)
                update = stencil.update
                if phases:
                    update = phases[(s - 1 + sum(gorig)) % 2]
                new = update(tuple(padded))
                mask = frame_mask((1,) + shape(s), global_shape, gorig, h,
                                  device=torch.device("cpu"))
                res = []
                for i, nv in enumerate(new):
                    j = stencil.carry_map[i]
                    if j is not None:
                        res.append(centre[j])
                    elif stencil.mask_fields[i]:
                        res.append(torch.where(mask, centre[i], nv))
                    else:
                        res.append(nv)
                results.append((s, z, res))
            for s, z, res in results:
                if s < K:
                    put(s, z, {f: res[f][0] for f in ringed})
                else:
                    dst = (z,) + tuple(
                        slice(t, min(t + tile[i], core_shape[i + 1]))
                        for i, t in enumerate(t0))
                    src_sl = (0,) + tuple(
                        slice(0, min(tile[i], core_shape[i + 1] - t))
                        for i, t in enumerate(t0))
                    for f in range(nf):
                        out[f][dst] = res[f][src_sl]

    for zc0 in range(0, Z, CZ):
        for idx in torch.cartesian_prod(
                *[torch.arange(nb) for nb in nblocks]).reshape(
                    -1, len(nblocks)).tolist():
            block(zc0, [i * tile[n] for n, i in enumerate(idx)])
    return tuple(out)


def window_raw(core, m):
    """RAW: the whole grid, every axis clamped (cell_ptr without wrap)."""
    return tuple(_pad_both(f, [m] * f.dim()) for f in core)


def window_zslab(core, zlo, zhi, m):
    """ZSLAB: the core between its z slabs, y and x clamped."""
    return tuple(_pad_both(torch.cat([lo, c, hi]), [0, m, m])
                 for c, lo, hi in zip(core, zlo, zhi))


def window_yzslab(core, zlo, zhi, ylo, yhi, corners, m):
    """YZSLAB: the core, its z and y slabs and corners, x clamped."""
    out = []
    for j, (c, zl, zh, yl, yh) in enumerate(zip(core, zlo, zhi, ylo, yhi)):
        ll, lh, hl, hh = (cs[j] for cs in corners)
        w = torch.cat([torch.cat([ll, zl, lh], dim=1),
                       torch.cat([yl, c, yh], dim=1),
                       torch.cat([hl, zh, hh], dim=1)], dim=0)
        out.append(_pad_both(w, [0, 0, m]))
    return tuple(out)


def window_rows(padded, m):
    """2D PADDED: a row shard's (Ly + 2m, W) block, columns clamped."""
    return tuple(_pad_both(f, [0, m]) for f in padded)


def _pad_both(t, widths):
    for d, w in enumerate(widths):
        if w > 0:
            shape = list(t.shape)
            shape[d] = w
            t = torch.cat([t.narrow(d, 0, 1).expand(shape), t,
                           t.narrow(d, t.shape[d] - 1, 1).expand(shape)],
                          dim=d)
    return t
