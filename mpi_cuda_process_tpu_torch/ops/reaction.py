"""Gray-Scott reaction-diffusion: two coupled diffusing fields.

The multi-field member whose fields BOTH carry a stencil footprint (the
wave model's second field is read at its own cell only), so every field of
the state is halo-exchanged:

    u' = u + Du Lap(u) - u v^2 + F (1 - u)
    v' = v + Dv Lap(v) + u v^2 - (F + kappa) v

The guard frame pins u = 1, v = 0 (the trivial steady state).  Sums are
associated as written, left to right, with ``u v^2 = (u v) v`` and
``F + kappa`` one constant rounded once, as in the TPU package's
``ops/reaction.py``; the CUDA kernels (``ops/cuda/csrc/stencil_taps.cuh``)
take ``(Du, Dv, F, F + kappa)`` from :func:`coefficients` and round in the
same order.
"""

from __future__ import annotations

import torch

from .stencil import Stencil, as_torch_dtype, axis_laplacian, register


def coefficients(stencil: Stencil):
    """``(Du, Dv, F, F + kappa)``: the update's constants, the last one the
    sum the plain update forms before it multiplies."""
    p = stencil.params
    return (p["du"], p["dv"], p["f"], p["f"] + p["kappa"])


def _make_gray_scott_update(ndim, du, dv, f, kappa):
    def update(padded):
        pu, pv = padded
        u, lap_u = axis_laplacian(pu, ndim)
        v, lap_v = axis_laplacian(pv, ndim)
        uvv = u * v * v
        new_u = u + du * lap_u - uvv + f * (1.0 - u)
        new_v = v + dv * lap_v + uvv - (f + kappa) * v
        return (new_u, new_v)

    return update


def _make_gray_scott(name, ndim, du, dv, f, kappa, dtype):
    return Stencil(
        name=name,
        ndim=ndim,
        halo=1,
        num_fields=2,
        dtype=as_torch_dtype(dtype),
        bc_value=(1.0, 0.0),
        update=_make_gray_scott_update(ndim, du, dv, f, kappa),
        params={"du": du, "dv": dv, "f": f, "kappa": kappa},
    )


@register("grayscott2d")
def grayscott2d(du=0.16, dv=0.08, f=0.035, kappa=0.06,
                dtype=torch.float32) -> Stencil:
    return _make_gray_scott("grayscott2d", 2, du, dv, f, kappa, dtype)


@register("grayscott3d")
def grayscott3d(du=0.1, dv=0.05, f=0.035, kappa=0.06,
                dtype=torch.float32) -> Stencil:
    return _make_gray_scott("grayscott3d", 3, du, dv, f, kappa, dtype)
