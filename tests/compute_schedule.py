"""The tiled one-step kernels' schedule (csrc/march.cuh), run on the CPU.

A block takes work items (a tile of the output planes and a run of planes
along the march axis: z in 3D, the rows in 2D, whose "planes" are rows).
For each it issues IN_FLIGHT input planes into a ring of S slots; then
iteration q waits for the run's input plane q, passes a barrier, issues
plane ``q + IN_FLIGHT`` into slot ``(q + IN_FLIGHT) % S`` and updates the
output plane whose planes are all in (z - h .. z + h).  The input is a
padded block (K4, K5, K7) or, with ``raw``, the raw grid itself (K1, K2,
Gray-Scott): a run then starts at plane max(z0 - h, 0), planes past the
grid are not issued, rows and cells outside the grid are not copied
(poison here), and frame cells keep their value (a frame plane reads only
its own plane).  Wave3d's u_prev (K5, K2) is read from device memory into
registers by the thread that updates the cell, with no ring.  Gray-Scott's
v marches through a ring of its own beside u's, its plane tiles issued and
landed with u's, and its frame cells keep v's value.  :func:`run` replays that order with the stencil's plain update (so the
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


def run(stencil, block, tile, slots, uprev=None, raw=False, second=None):
    """The tiled kernel's output for ``block`` under ``tile``
    (``march.Tile``), on a ring of ``slots`` slots: a padded block (3D:
    (Z+2h, Y+2h, X+2h); 2D: (H+2, W+2)) and, for wave3d, the unpadded
    ``uprev``; or with ``raw`` the raw (Z, Y, X) grid, its frame kept.
    ``second``: Gray-Scott's v, shaped as ``block``, on a ring of its own
    of ``slots`` slots; then the result is the pair (u', v')."""
    in_flight = IN_FLIGHT
    h = stencil.halo
    d2 = block.dim() == 2
    ins = [block] if second is None else [block, second]
    nf = len(ins)
    ps = [b[:, None, :] if d2 else b for b in ins]
    p3 = ps[0]
    pad, co = (0, 0) if raw else (2 * h, h)
    PM, PY, PX = p3.shape
    M = PM - pad
    Y, X = (1, PX - pad) if d2 else (PY - pad, PX - pad)
    TX, ZR = tile.tx, tile.zrun
    TY = 1 if d2 else tile.ty
    PR = 1 if d2 else TY + 2 * h
    outs = [torch.empty((M, Y, X), dtype=block.dtype) for _ in range(nf)]
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
        # a ring of slots for each field, each slot's (item, plane)
        ring = [[None] * slots for _ in range(nf)]
        held = [[None] * slots for _ in range(nf)]
        flying = {}

        def issue(q):  # every field's plane tile, in one commit group
            pz = plo + q
            if pz < PM:
                s = q % slots
                group = []
                for f, pf in enumerate(ps):
                    data = torch.full((PR, TX + 2 * h), poison,
                                      dtype=block.dtype)
                    data[ra - r0:rb - r0, ca - c0:cb - c0] = \
                        pf[pz, ra:rb, ca:cb]
                    ring[f][s] = torch.full_like(data, poison)
                    held[f][s] = None
                    group.append(data)
                flying[q] = (s, group)

        def land(q):
            if q in flying:
                s, group = flying.pop(q)
                for f, data in enumerate(group):
                    ring[f][s], held[f][s] = data, (item, q)

        def read(q, f=0):
            s = q % slots
            if held[f][s] != (item, q):
                raise Race(f"item {item}: plane {q} of field {f} read from "
                           f"slot {s}, which holds {held[f][s]}")
            return ring[f][s]

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
                new = [read(q - h, f)[h:h + TY, h:h + TX]
                       for f in range(nf)]
            else:
                windows = [torch.stack([read(q - 2 * h + j, f)
                                        for j in range(2 * h + 1)])
                           for f in range(nf)]
                if d2:
                    new = [stencil.update((windows[0][:, 0],))[0]]
                elif uprev is not None:
                    new = [stencil.update((windows[0], uread(z)))[0][0]]
                else:
                    new = [n[0] for n in
                           stencil.update(tuple(windows))[:nf]]
                if raw:  # frame rows and cells keep each field's centre
                    ys = torch.arange(y0, y0 + TY)[:, None]
                    xs = torch.arange(x0, x0 + TX)[None, :]
                    frame = (ys < h) | (ys >= Y - h) | (xs < h) | \
                        (xs >= X - h)
                    new = [torch.where(frame, w[h, h:h + TY, h:h + TX], n)
                           for w, n in zip(windows, new)]
            for o, n in zip(outs, new):
                o[z, y0:y0 + ny, x0:x0 + nx] = n[:ny, :nx]
        if flying:
            raise Race(f"item {item}: planes {sorted(flying)} never landed")
    outs = [o[:, 0] if d2 else o for o in outs]
    return outs[0] if second is None else tuple(outs)
