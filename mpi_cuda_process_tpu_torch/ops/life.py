"""Conway's Game of Life as a stencil op.

B3/S23 on an int32 grid: a cell is alive next generation when it has three
live neighbours, or two and is alive now.  Halo 1, dead (0) guard frame.
The eight-neighbour count is a sum of shifted views of the halo-padded
block, as in the TPU package's ``ops/life.py``; the CUDA kernels
(``ops/cuda/csrc/whole2d.cu``, ``fullgrid.cu``) compute the same rule.
"""

from __future__ import annotations

import itertools

import torch

from .stencil import (HealthInvariant, Stencil, as_torch_dtype, interior,
                      register, shifted)


def _population(fields):
    # float32 accumulation: the health transport is float either way
    return torch.sum(fields[0].to(torch.float32))


# Track-only (rtol=None): the population wanders by nature, so a monitor
# records it and never fails a run on it; an int state holds no NaN/Inf.
_LIFE_INVARIANT = HealthInvariant("population", _population, rtol=None)


def life_update(padded):
    (p,) = padded
    n = None
    for off in itertools.product((-1, 0, 1), repeat=2):
        if off == (0, 0):
            continue
        s = shifted(p, off, 1)
        n = s if n is None else n + s
    alive = interior(p, 1, 2)
    born_or_survives = (n == 3) | ((n == 2) & (alive == 1))
    return (born_or_survives.to(p.dtype),)


@register("life")
def life(dtype=torch.int32) -> Stencil:
    """B3/S23 Game of Life, 2D, halo 1, dead (0) boundary."""
    return Stencil(
        name="life",
        ndim=2,
        halo=1,
        num_fields=1,
        dtype=as_torch_dtype(dtype),
        bc_value=(0,),
        update=life_update,
        params={},
        invariant=_LIFE_INVARIANT,
    )
