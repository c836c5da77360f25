"""The tiled one-step kernels' schedule (csrc/march.cuh), run on the CPU.

A block takes work items (a tile of the output planes and a run of planes
along the march axis: z in 3D, the rows in 2D, whose "planes" are rows).
For each it issues IN_FLIGHT input planes into a ring of S slots; then
iteration q waits for the run's input plane q, passes a barrier, issues
plane ``q + IN_FLIGHT`` into slot ``(q + IN_FLIGHT) % S`` and updates the
output plane whose planes are all in (z - h .. z + h).  The input is a
padded block (K4, K5, K7) or, with ``raw``, the raw grid itself (K1): a
run then starts at plane max(z0 - h, 0), planes past the grid are not
issued, rows and cells outside the grid are not copied (poison here), and
frame cells keep their value (a frame plane reads only its own plane).
Wave3d's u_prev (K5) is read from device memory into registers by the
thread that updates the cell, with no ring.  :func:`run` replays that order with the stencil's plain update (so the
rounding is the plain one) on rings of exactly the given slots, and makes
every race the card could see visible: a slot whose copy is in flight
holds NaN (Life: -1) from the iteration that issues it to the wait that
lands it, only plane q counts as landed at iteration q's wait, and each
slot records the (item, plane) it holds.  A read of a slot that does not
hold the plane the schedule expects there raises :class:`Race` — on the
card, a silent race.  On the committed count (``march.ring_slots``) it
gives the plain update bit for bit.

:func:`special_bf16` makes the bfloat16 blocks on which the card's checks
hold the kernels' paired bfloat16 ops to the plain version
(``tests/test_torch_cuda.py``, ``chip_smoke.py``,
``scripts/torch_compute_tiles.py``).
"""

from __future__ import annotations

import torch

from mpi_cuda_process_tpu_torch.ops.cuda.kernels import IN_FLIGHT


def special_bf16(shape, gen, device):
    """bfloat16 values in [0, 1) drawn from ``gen`` on ``device``, with
    subnormals of both signs, +0 and -0, ones and 2^-8 (half an ulp of 1:
    their sums fall on bfloat16 ties) in bands of the cells."""
    bf16 = torch.bfloat16
    x = torch.rand(shape, generator=gen, device=device).to(bf16)
    pick = torch.rand(shape, generator=gen, device=device)
    sub = (torch.randint(1, 128, shape, generator=gen, device=device,
                         dtype=torch.int32) << 16).view(torch.float32).to(bf16)
    for lo, hi, v in ((0.0, 0.1, sub), (0.1, 0.15, -sub),
                      (0.15, 0.2, torch.zeros_like(x)),
                      (0.2, 0.25, -torch.zeros_like(x)),
                      (0.25, 0.35, torch.ones_like(x)),
                      (0.35, 0.45, torch.full_like(x, 2.0 ** -8))):
        x = torch.where((pick >= lo) & (pick < hi), v, x)
    return x


class Race(AssertionError):
    """An update read a ring slot that did not hold the plane it needed."""


def run(stencil, block, tile, slots, uprev=None, raw=False):
    """The tiled kernel's output for ``block`` under ``tile``
    (``march.Tile``), on a ring of ``slots`` slots: a padded block (3D:
    (Z+2h, Y+2h, X+2h); 2D: (H+2, W+2)) and, for wave3d, the unpadded
    ``uprev``; or with ``raw`` the raw (Z, Y, X) grid, its frame kept."""
    in_flight = IN_FLIGHT
    h = stencil.halo
    d2 = block.dim() == 2
    p3 = block[:, None, :] if d2 else block
    pad, co = (0, 0) if raw else (2 * h, h)
    PM, PY, PX = p3.shape
    M = PM - pad
    Y, X = (1, PX - pad) if d2 else (PY - pad, PX - pad)
    TX, ZR = tile.tx, tile.zrun
    TY = 1 if d2 else tile.ty
    PR = 1 if d2 else TY + 2 * h
    out = torch.empty((M, Y, X), dtype=block.dtype)
    poison = float("nan") if block.is_floating_point() else -1
    items = [(z0, y0, x0) for z0 in range(0, M, ZR)
             for y0 in range(0, Y, TY) for x0 in range(0, X, TX)]
    for item, (z0, y0, x0) in enumerate(items):
        nz = min(ZR, M - z0)
        ny, nx = min(TY, Y - y0), min(TX, X - x0)
        plo = max(z0 + co - h, 0)
        nin = z0 + nz + co + h - plo
        # a plane tile: rows and cells of the tile's output widened by h,
        # those outside the input never copied
        r0 = 0 if d2 else y0 + co - h
        c0 = x0 + co - h
        ra, rb = max(r0, 0), min(r0 + PR, PY)
        ca, cb = max(c0, 0), min(c0 + TX + 2 * h, PX)
        ring, held = [None] * slots, [None] * slots
        flying = {}

        def issue(q):
            pz = plo + q
            if pz < PM:
                s = q % slots
                data = torch.full((PR, TX + 2 * h), poison,
                                  dtype=block.dtype)
                data[ra - r0:rb - r0, ca - c0:cb - c0] = p3[pz, ra:rb, ca:cb]
                ring[s], held[s] = torch.full_like(data, poison), None
                flying[q] = (s, data)

        def land(q):
            if q in flying:
                s, data = flying.pop(q)
                ring[s], held[s] = data, (item, q)

        def read(q):
            s = q % slots
            if held[s] != (item, q):
                raise Race(f"item {item}: plane {q} read from slot {s}, "
                           f"which holds {held[s]}")
            return ring[s]

        def uread(z):  # the cells' u_prev, into registers
            data = torch.full((1, TY, TX), poison, dtype=block.dtype)
            data[0, :ny, :nx] = uprev[z, y0:y0 + ny, x0:x0 + nx]
            return data

        for q in range(min(in_flight, nin)):
            issue(q)
        for q in range(nin):
            land(q)  # wait_group: plane q has landed
            # barrier
            if q + in_flight < nin:
                issue(q + in_flight)
            z = plo + q - co - h
            if z < z0:
                continue
            if raw and (z < h or z >= M - h):  # a frame plane
                new = read(q - h)[h:h + TY, h:h + TX]
            else:
                window = torch.stack([read(q - 2 * h + j)
                                      for j in range(2 * h + 1)])
                if d2:
                    new = stencil.update((window[:, 0],))[0]
                elif uprev is not None:
                    new = stencil.update((window, uread(z)))[0][0]
                else:
                    new = stencil.update((window,))[0][0]
                if raw:  # frame rows and cells keep the centre
                    ys = torch.arange(y0, y0 + TY)[:, None]
                    xs = torch.arange(x0, x0 + TX)[None, :]
                    frame = (ys < h) | (ys >= Y - h) | (xs < h) | \
                        (xs >= X - h)
                    new = torch.where(frame, window[h, h:h + TY, h:h + TX],
                                      new)
            out[z, y0:y0 + ny, x0:x0 + nx] = new[:ny, :nx]
        if flying:
            raise Race(f"item {item}: planes {sorted(flying)} never landed")
    return out[:, 0] if d2 else out
