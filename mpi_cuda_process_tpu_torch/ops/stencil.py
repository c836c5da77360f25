"""Stencil op protocol — the single shared abstraction of the port.

A :class:`Stencil` bundles everything that differs between two physics
models — dtype, footprint/halo width, per-field guard-cell (boundary)
values and the update rule — and everything else (time stepping, I/O,
kernels) is shared machinery that consumes a ``Stencil``.  Field-for-field
the same protocol as the TPU package's ``ops/stencil.py``, on
``torch.Tensor`` instead of device arrays.

Update functions are written tensor-level over *halo-padded* blocks
(shifted slices, which are views: no copy per tap), so per-thread index
arithmetic and its out-of-bounds hazards stay out of the op layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Fields = Tuple[torch.Tensor, ...]
# An update fn maps halo-padded fields -> new interior-shaped fields.
UpdateFn = Callable[[Fields], Fields]

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` from a dtype name, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"available: {sorted(_DTYPES)}")
    return _DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    """Inverse of :func:`as_torch_dtype` (``torch.float32`` -> "float32")."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class HealthInvariant:
    """A per-op scalar a numerics monitor can track.

    Each op registers its own conservation (or monotone) invariant here,
    so an observer never hardcodes physics.  ``fn`` maps unpadded fields
    to one 0-d tensor (float32 accumulation, so reduced-precision states
    do not alias roundoff into drift).

    Attributes:
      name: what the scalar is (``"total_heat"``, ``"discrete_energy"``).
      fn: fields -> scalar tensor.
      rtol: relative-drift tolerance vs the first observation; ``None``
        means track-only.
      mode: ``"conserve"`` (two-sided drift bound) or ``"decrease"``
        (one-sided: only an increase past the tolerance diverges).
      scale: optional absolute floor for the drift denominator (Dirichlet
        heat drifts toward the wall temperature, its physical scale).
    """

    name: str
    fn: Callable[[Fields], torch.Tensor]
    rtol: Optional[float] = None
    mode: str = "conserve"
    scale: Optional[float] = None

    def __post_init__(self):
        if self.mode not in ("conserve", "decrease"):
            raise ValueError(
                f"invariant {self.name!r}: mode must be 'conserve' or "
                f"'decrease' (got {self.mode!r})")


@dataclasses.dataclass(frozen=True)
class Stencil:
    """A stencil model.

    Attributes:
      name: registry key (e.g. ``"heat2d"``).
      ndim: spatial rank of the grid (2 or 3).
      halo: footprint radius = halo width = guard-frame width.
      num_fields: fields in the state (1 for heat, 2 for FDTD wave).
      dtype: ``torch.dtype`` of every field.
      bc_value: per-field guard-cell constant.
      update: pure function, halo-padded fields -> new interior fields.
      params: free parameters of the model (e.g. diffusion number
        ``alpha``), recorded for config serialization.
      field_halos: per-field halo widths; 0 marks a field whose
        neighbours are never read (the wave model's ``u_prev``), which
        then arrives unpadded.
      mask_fields: ``False`` skips the guard-frame re-pin for a field
        whose frame is correct by induction.
      carry_map: ``carry_map[i] = j`` means new field ``i`` is exactly old
        field ``j`` (wave: ``(None, 0)`` — new ``u_prev`` is old ``u``);
        the stepper takes the old tensor and never materializes the
        update's ``i``-th output.
      phases: multi-phase steps — one time step is this sequence of
        update fns, each preceded by its own padding.
      parity_sensitive: the update depends on coordinate parity
        (red-black colouring); periodic wraps over odd extents are refused.
      invariant: the op's registered :class:`HealthInvariant`.
    """

    name: str
    ndim: int
    halo: int
    num_fields: int
    dtype: torch.dtype
    bc_value: Tuple[float, ...]
    update: UpdateFn
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    field_halos: Tuple[int, ...] = None  # type: ignore[assignment]
    mask_fields: Tuple[bool, ...] = None  # type: ignore[assignment]
    carry_map: Tuple[Optional[int], ...] = None  # type: ignore[assignment]
    phases: Optional[Tuple[UpdateFn, ...]] = None
    parity_sensitive: bool = False
    invariant: Optional[HealthInvariant] = None

    def __post_init__(self):
        if self.field_halos is None:
            object.__setattr__(
                self, "field_halos", (self.halo,) * self.num_fields)
        if self.mask_fields is None:
            object.__setattr__(
                self, "mask_fields", (True,) * self.num_fields)
        if self.carry_map is None:
            object.__setattr__(
                self, "carry_map", (None,) * self.num_fields)
        if len(self.carry_map) != self.num_fields:
            raise ValueError("carry_map length != num_fields")
        if len(self.field_halos) != self.num_fields:
            raise ValueError("field_halos length != num_fields")
        if len(self.mask_fields) != self.num_fields:
            raise ValueError("mask_fields length != num_fields")


def k_step_margin(stencil: Stencil, k: int) -> int:
    """The margin ``m = k * halo * max(1, phases)`` of k steps: the window
    pad and slab depth of every temporal-blocking kernel and exchange.  Each
    phase consumes a halo (red-black SOR: 2 * halo a step, since its black
    half-sweep reads the red values of the same step)."""
    return k * stencil.halo * max(1, len(stencil.phases or ()))


def axis_offsets(ndim: int):
    """Unit offsets along each axis: the 2*ndim face neighbours."""
    for d in range(ndim):
        for s in (-1, 1):
            off = [0] * ndim
            off[d] = s
            yield tuple(off)


def axis_laplacian(padded: torch.Tensor, ndim: int, halo: int = 1):
    """Return ``(u, lap)``: interior view and the 2*ndim-point Laplacian.

    Left-associated face sum in :func:`axis_offsets` order, centre term
    last — the association order every kernel of the port reproduces.
    """
    u = interior(padded, halo, ndim)
    acc = None
    for off in axis_offsets(ndim):
        s = shifted(padded, off, halo)
        acc = s if acc is None else acc + s
    return u, acc - 2 * ndim * u


def shifted(padded: torch.Tensor, offsets: Tuple[int, ...],
            halo: int) -> torch.Tensor:
    """Interior-shaped view of ``padded`` shifted by ``offsets``.

    ``offsets[d]`` in ``[-halo, halo]``; static slices that cannot go out
    of bounds.  The slices take the trailing ``len(offsets)`` axes, so a
    batched block (a leading member axis, an ensemble run) is shifted
    member by member in one view.
    """
    idx = []
    for o in offsets:
        start = halo + o
        stop = o - halo
        idx.append(slice(start, stop if stop != 0 else None))
    return padded[(Ellipsis, *idx)]


def interior(padded: torch.Tensor, halo: int, ndim: int) -> torch.Tensor:
    return shifted(padded, (0,) * ndim, halo)


# ----------------------------------------------------------------------------
# Registry: name -> factory(**params) -> Stencil
# ----------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Stencil]] = {}


def register(name: str):
    def deco(factory: Callable[..., Stencil]):
        _REGISTRY[name] = factory
        return factory

    return deco


def make_stencil(name: str, **params) -> Stencil:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown stencil {name!r}; available: {sorted(_REGISTRY)}"
        )
    if "dtype" in params:
        params["dtype"] = as_torch_dtype(params["dtype"])
    return _REGISTRY[name](**params)


def available_stencils():
    return sorted(_REGISTRY)
