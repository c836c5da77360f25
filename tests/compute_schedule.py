"""The tiled compute_fn kernels' schedule (csrc/march.cuh), run on the CPU.

A block takes work items (a tile of the output planes and a run of planes
along the march axis: z in 3D, the rows in 2D, whose "planes" are rows).
For each it issues IN_FLIGHT padded planes into a ring of S slots; then
iteration q waits for plane q, passes a barrier, issues plane
``q + IN_FLIGHT`` into slot ``(q + IN_FLIGHT) % S`` and updates output
plane ``q - 2h`` from planes ``q - 2h .. q``.  :func:`run` replays that
order with the stencil's plain update (so the rounding is the plain one)
on a ring of exactly ``slots`` slots, and makes every race the card could
see visible: a slot whose copy is in flight holds NaN (Life: -1) from the
iteration that issues it to the wait that lands it, only plane q counts as
landed at iteration q's wait, and each slot records the (item, plane) it
holds.  A read of a slot that does not hold the plane the schedule expects
there raises :class:`Race` — on the card, a silent race.  On the committed
count (``kernels.ring_slots``) it gives the plain update bit for bit.

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


def run(stencil, padded, tile, slots):
    """The tiled kernel's output for the padded block ``padded`` (3D: (Z+2h,
    Y+2h, X+2h); 2D: (H+2, W+2)) under ``tile`` (``kernels.Tile``), on a
    ring of ``slots`` slots."""
    in_flight = IN_FLIGHT
    h = stencil.halo
    d2 = padded.dim() == 2
    p3 = padded[:, None, :] if d2 else padded
    M = p3.shape[0] - 2 * h
    PY, PX = p3.shape[1], p3.shape[2]
    Y, X = (1, PX - 2 * h) if d2 else (PY - 2 * h, PX - 2 * h)
    TX, ZR = tile.tx, tile.zrun
    TY = 1 if d2 else tile.ty
    PR = 1 if d2 else TY + 2 * h
    out = torch.empty((M, Y, X), dtype=padded.dtype)
    poison = float("nan") if padded.is_floating_point() else -1
    items = [(z0, y0, x0) for z0 in range(0, M, ZR)
             for y0 in range(0, Y, TY) for x0 in range(0, X, TX)]
    for item, (z0, y0, x0) in enumerate(items):
        nin = min(ZR, M - z0) + 2 * h
        # the plane tile a copy brings in (cropped to the tensor)
        rows = slice(y0, min(y0 + PR, PY))
        cols = slice(x0, min(x0 + TX + 2 * h, PX))
        ring = [None] * slots
        held = [None] * slots
        flying = {}

        def issue(q):
            s = q % slots
            data = p3[z0 + q, rows, cols].clone()
            ring[s] = torch.full_like(data, poison)
            held[s] = None
            flying[q] = (s, data)

        def land(q):
            s, data = flying.pop(q)
            ring[s], held[s] = data, (item, q)

        def read(q):
            s = q % slots
            if held[s] != (item, q):
                raise Race(f"item {item}: plane {q} read from slot {s}, "
                           f"which holds {held[s]}")
            return ring[s]

        for q in range(min(in_flight, nin)):
            issue(q)
        for q in range(nin):
            land(q)  # wait_group: plane q has landed
            # barrier
            if q + in_flight < nin:
                issue(q + in_flight)
            if q >= 2 * h:
                window = torch.stack([read(q - 2 * h + j)
                                      for j in range(2 * h + 1)])
                if d2:
                    new = stencil.update((window[:, 0],))[0]
                    out[z0 + q - 2 * h, 0, x0:x0 + new.shape[-1]] = new[0]
                else:
                    new = stencil.update((window,))[0][0]
                    ny = min(TY, Y - y0)
                    out[z0 + q - 2 * h, y0:y0 + ny,
                        x0:x0 + new.shape[-1]] = new[:ny]
        if flying:
            raise Race(f"item {item}: planes {sorted(flying)} never landed")
    return out[:, 0] if d2 else out
