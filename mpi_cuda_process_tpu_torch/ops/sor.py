"""Red-black Gauss-Seidel / SOR relaxation for the Laplace problem.

One time step is a "red" half-sweep (cells whose coordinate sum is even)
followed by a "black" half-sweep that reads the fresh red values: the
classic parallel Gauss-Seidel.  With over-relaxation (omega in (1, 2)) it
converges far faster than Jacobi on the same Dirichlet problem.

The model exercises the multi-phase step machinery (``Stencil.phases``):
each half-sweep gets its own padding and, under a mesh, its own halo
exchange, so black cells at shard faces see the neighbour shard's red
values of the same step and sharded equals unsharded exactly.

Sharded-parity caveat: the colour mask is computed from block-local
coordinate parity, which equals global parity iff every shard's block size
is even along the sharded axes; the steppers refuse odd per-shard extents.
A half-sweep is heat's update ``u + alpha * lap`` with ``alpha = omega /
(2 ndim)`` kept on one colour, so the kernels run heat's taps
(``ops/cuda/csrc/stencil_taps.cuh``, ``stencil2d.cuh``) under a colour
select.  Field for field the TPU package's ``ops/sor.py``.
"""

from __future__ import annotations

import torch

from .stencil import (HealthInvariant, Stencil, as_torch_dtype,
                      axis_laplacian, register)


def _parity_mask(shape, device) -> torch.Tensor:
    """Boolean (coordinate sum) % 2 of a block of ``shape``, built from one
    small parity vector per axis, so no integer grid is materialized."""
    ndim = len(shape)
    acc = None
    for d in range(ndim):
        view = [1] * ndim
        view[d] = int(shape[d])
        p = (torch.arange(int(shape[d]), device=device) % 2).to(
            torch.bool).reshape(view)
        acc = p if acc is None else acc ^ p
    return acc.expand(tuple(int(s) for s in shape))


def _make_half_sweep(ndim, omega, color):
    alpha = omega / (2 * ndim)
    masks = {}  # (shape, device) -> cells of this colour

    def update(padded):
        (p,) = padded
        u, lap = axis_laplacian(p, ndim)
        # (1-w)u + w/(2n) * sum(neighbors)  ==  u + w/(2n) * lap
        relaxed = u + alpha * lap
        # the colour of the spatial coordinates (the trailing ndim axes;
        # a batched block's members share it)
        key = (tuple(u.shape[-ndim:]), u.device)
        if key not in masks:
            masks[key] = _parity_mask(key[0], u.device) == bool(color)
        return (torch.where(masks[key], relaxed, u),)

    return update


def _sor_invariant(ndim) -> HealthInvariant:
    """RMS Laplace residual over the interior: the solver's progress.

    SOR relaxes toward the Dirichlet-Laplace fixed point, so the residual
    must (noisily) decrease: the drift check is one-sided
    (``mode="decrease"``).
    """

    def residual_norm(fields):
        u = fields[0].to(torch.float32)
        core = u[(slice(1, -1),) * ndim]
        acc = -2.0 * ndim * core
        for d in range(ndim):
            for s in (0, 2):
                idx = [slice(1, -1)] * ndim
                idx[d] = slice(s, s - 2 if s - 2 != 0 else None)
                acc = acc + u[tuple(idx)]
        return torch.sqrt(torch.mean(acc ** 2))

    return HealthInvariant("residual_norm", residual_norm, rtol=0.5,
                           mode="decrease")


def _make_sor(name, ndim, omega, bc, dtype):
    omega = float(omega)
    if not 0.0 < omega < 2.0:
        raise ValueError(f"{name}: omega {omega} outside (0, 2) diverges")
    phases = (_make_half_sweep(ndim, omega, 0),
              _make_half_sweep(ndim, omega, 1))

    def update(_padded):
        raise NotImplementedError(
            f"{name} is multi-phase; drive it through make_step / "
            f"make_sharded_step (Stencil.phases), not .update")

    return Stencil(
        name=name,
        ndim=ndim,
        halo=1,
        num_fields=1,
        dtype=as_torch_dtype(dtype),
        bc_value=(bc,),
        update=update,
        params={"omega": omega, "bc": bc},
        phases=phases,
        parity_sensitive=True,
        invariant=_sor_invariant(ndim),
    )


def alpha(stencil: Stencil) -> float:
    """The half-sweep's heat coefficient ``omega / (2 ndim)``, as the plain
    update forms it (one double; the kernels round it to float once)."""
    return stencil.params["omega"] / (2 * stencil.ndim)


@register("sor2d")
def sor2d(omega=1.8, bc=100.0, dtype=torch.float32) -> Stencil:
    return _make_sor("sor2d", 2, omega, bc, dtype)


@register("sor3d")
def sor3d(omega=1.7, bc=100.0, dtype=torch.float32) -> Stencil:
    return _make_sor("sor3d", 3, omega, bc, dtype)
