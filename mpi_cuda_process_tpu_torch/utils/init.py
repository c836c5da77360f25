"""State initialization: the deterministic kinds.

``zero`` (zero interior inside the guard-frame walls — the heat family's
Dirichlet init), ``pulse`` (a centred Gaussian bump; the wave model's
``u_prev = u`` is zero initial velocity) and ``auto`` (pick by stencil
family) need no random numbers, so they reproduce the TPU package's fields
up to float32 rounding of ``exp``.  The random kinds (``random``, ``patch``)
draw from the TPU package's threefry stream, which is not ported yet.

:func:`init_state_sharded` computes each block of a decomposed run on its
own device from global coordinates, so no device ever holds the global
grid; gathered, its blocks equal :func:`init_state` bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..driver import frame_mask
from ..ops.stencil import Fields, Stencil

# ROADMAP item that ports the random init kinds.
_RANDOM_INIT_ITEM = ("ROADMAP A2 (random/patch init: threefry2x32 in "
                     "partitionable mode, or fields fed in from numpy)")


def _gaussian_bump(grid_shape, sigma: float = 0.05, device="cpu",
                   offsets=None, local_shape=None):
    """Centred Gaussian bump in [0, 1], normalized coordinates per axis —
    or the block of it at ``offsets`` of extent ``local_shape``."""
    offsets = offsets or (0,) * len(grid_shape)
    local_shape = local_shape or grid_shape
    r2 = 0.0
    for d, (n, o, ls) in enumerate(zip(grid_shape, offsets, local_shape)):
        c = (torch.arange(o, o + ls, dtype=torch.float32, device=device)
             - (n - 1) / 2.0) / max(n, 2)
        shape = [1] * len(grid_shape)
        shape[d] = ls
        r2 = r2 + c.reshape(shape) ** 2
    return torch.exp(-r2 / (2 * sigma**2))


def _pin_frame(x: torch.Tensor, value, width: int, global_shape=None,
               offsets=None) -> torch.Tensor:
    mask = frame_mask(x.shape, global_shape or x.shape,
                      offsets or (0,) * x.ndim, width, x.device)
    return torch.where(mask, torch.full((), value, dtype=x.dtype,
                                        device=x.device), x)


def resolve_kind(stencil: Stencil, kind: str) -> str:
    """The init kind ``auto`` stands for, by stencil family."""
    if kind != "auto":
        return kind
    if stencil.name == "life":
        return "random"
    if stencil.name.startswith("grayscott"):
        return "patch"
    if stencil.name.startswith("advect") or stencil.num_fields == 2:
        return "pulse"
    return "zero"


def init_state(
    stencil: Stencil,
    grid_shape: Sequence[int],
    seed: int = 0,
    density: float = 0.15,
    kind: str = "auto",
    periodic: bool = False,
    device="cuda",
) -> Fields:
    """Build the initial fields for ``stencil`` on ``grid_shape``.

    kinds:
      - ``"zero"``: zero interior with guard-frame walls.
      - ``"pulse"``: centred Gaussian bump.
      - ``"auto"``: pick by stencil family.
      - ``"random"`` / ``"patch"``: not ported yet (raise).

    ``seed`` and ``density`` only feed the random kinds; they are accepted
    so one call signature serves every kind.
    """
    del seed, density  # the deterministic kinds ignore them
    grid_shape = tuple(int(g) for g in grid_shape)
    return _init_block(stencil, grid_shape, kind, periodic, device,
                       (0,) * len(grid_shape), grid_shape)


def _init_block(stencil, grid_shape, kind, periodic, device, offsets,
                local_shape) -> Fields:
    """The block of the initial fields at ``offsets`` (``local_shape``)."""
    if len(grid_shape) != stencil.ndim:
        raise ValueError(
            f"{stencil.name} is {stencil.ndim}D, got grid {grid_shape}"
        )
    kind = resolve_kind(stencil, kind)
    dtype = stencil.dtype
    if kind in ("random", "patch"):
        raise NotImplementedError(
            f"init kind {kind!r} is not ported yet: {_RANDOM_INIT_ITEM}")
    if kind == "zero":
        fields = tuple(
            torch.zeros(local_shape, dtype=dtype, device=device)
            for _ in range(stencil.num_fields)
        )
    elif kind == "pulse":
        u = _gaussian_bump(grid_shape, device=device, offsets=offsets,
                           local_shape=local_shape).to(dtype)
        # zero initial velocity: u_prev = u
        fields = (u,) + tuple(u for _ in range(stencil.num_fields - 1))
    else:
        raise ValueError(f"unknown init kind {kind!r}")

    if periodic:
        # No guard frame exists in periodic mode — every cell is ordinary.
        return fields
    return tuple(
        _pin_frame(f, v, stencil.halo, grid_shape, offsets)
        for f, v in zip(fields, stencil.bc_value)
    )


def init_state_sharded(
    stencil: Stencil,
    grid_shape: Sequence[int],
    mesh,
    seed: int = 0,
    density: float = 0.15,
    kind: str = "auto",
    periodic: bool = False,
) -> Fields:
    """The initial fields decomposed over ``mesh`` (``ShardedField`` s):
    each block computed on its own device from global coordinates."""
    from ..parallel.stepper import ShardedField, shard_offsets

    del seed, density  # the deterministic kinds ignore them
    grid_shape = tuple(int(g) for g in grid_shape)
    counts = mesh.counts(len(grid_shape))
    if any(g % c for g, c in zip(grid_shape, counts)):
        raise ValueError(f"grid {grid_shape} not divisible by mesh "
                         f"{mesh.shape}")
    local = tuple(g // c for g, c in zip(grid_shape, counts))
    per_field = [[] for _ in range(stencil.num_fields)]
    for c in mesh.coords():
        block = _init_block(stencil, grid_shape, kind, periodic,
                            mesh.device(c), shard_offsets(c, local), local)
        for f, b in zip(per_field, block):
            f.append(b)
    return tuple(ShardedField(b, mesh, grid_shape) for b in per_field)
