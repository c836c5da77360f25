"""First-order upwind advection with a constant velocity field.

The transport member of the stencil family: upwinding reads only the
upstream neighbour on each axis, so the footprint is asymmetric and depends
on the sign of each Courant number.  Per axis d, with the signed Courant
number c_d = v_d * dt / dx_d:

    u' = u - sum_d [ max(c_d, 0) (u - u_{d-1}) + min(c_d, 0) (u_{d+1} - u) ]

stable for sum_d |c_d| <= 1; the guard frame is the inflow value.  The
axes are taken in grid order (z, y, x) and a zero component is skipped, not
added as 0 * (...), as in the TPU package's ``ops/advection.py``; the CUDA
kernels (``ops/cuda/csrc/stencil_taps.cuh``) add the same terms in the same
order.
"""

from __future__ import annotations

import torch

from .stencil import Stencil, as_torch_dtype, interior, register, shifted


def _make_upwind_update(ndim, courant):
    def update(padded):
        (p,) = padded
        u = interior(p, 1, ndim)
        acc = u
        for d, c in enumerate(courant):
            if c == 0.0:
                continue
            off = [0] * ndim
            if c > 0:
                off[d] = -1
                acc = acc - c * (u - shifted(p, tuple(off), 1))
            else:
                off[d] = 1
                acc = acc - c * (shifted(p, tuple(off), 1) - u)
        return (acc,)

    return update


def _make_advection(name, ndim, courant, bc, dtype):
    courant = tuple(float(c) for c in courant)
    if len(courant) != ndim:
        raise ValueError(f"{name}: need {ndim} courant numbers, got {courant}")
    if sum(abs(c) for c in courant) > 1.0:
        raise ValueError(f"{name}: unstable courant {courant} (sum |c| > 1)")
    return Stencil(
        name=name,
        ndim=ndim,
        halo=1,
        num_fields=1,
        dtype=as_torch_dtype(dtype),
        bc_value=(bc,),
        update=_make_upwind_update(ndim, courant),
        params={"courant": courant, "bc": bc},
    )


@register("advect2d")
def advect2d(cx=0.4, cy=0.4, bc=0.0, dtype=torch.float32) -> Stencil:
    # grid axes are (y, x)
    return _make_advection("advect2d", 2, (cy, cx), bc, dtype)


@register("advect3d")
def advect3d(cx=0.3, cy=0.3, cz=0.3, bc=0.0, dtype=torch.float32) -> Stencil:
    # grid axes are (z, y, x)
    return _make_advection("advect3d", 3, (cz, cy, cx), bc, dtype)
