"""Device groups running heterogeneous physics, coupled at interface faces.

The port of the TPU package's ``parallel/groups.py``.  A ``--groups`` run
partitions the devices into N contiguous groups along the leading grid
axis, each with its own op, refinement ratio (a power of two), dtype, mesh
and execution mode, coupled only at the faces between neighbouring groups:

* each group's interior step is the port's unmodified sharded stepper
  (``stepper.make_sharded_step``, or ``make_sharded_temporal_step`` under
  a ``fuseK``/``stream``/``padfree``/``pipeline`` mode token) over a mesh
  of the group's own devices, so the ported kernels (K3 and its shells,
  K6, K9, K10's shard kinds, K8 in 2D) run per group unchanged;
* each group's grid carries, on each interior-facing side, a ghost band of
  ``m = k * halo * max(1, phases)`` rows past its owned rows.  Once a
  round every band is overwritten with the neighbour's owned boundary
  rows, resampled across the ratio pair (iterated pairwise averaging one
  way, a repeat the other) and cast to the receiver's dtype.  The
  stepper's own frame re-pin freezes the band's outer rows, staleness
  moves inward ``halo`` rows a micro-step, so after a round exactly the
  band is stale and every owned row equals the monolithic run's: a
  same-physics split is bit-equal to the monolithic run.

A group's fields are ``stepper.ShardedField`` s over its mesh; a band
lives in the blocks of the group's edge z-shards, split over its y (and x)
shards.  Two transports refresh it, bit-identical (the TPU package's
contract):

* ``device_put`` (default): for every receiver block column the sender's
  rows that feed it are gathered (views where one block holds them),
  resampled and cast, then written into the receiver's band rows.  The
  sides of an interface may have different y-shard counts: the receiver's
  column sets the cut (:func:`_axis_source`);
* ``collective``: each sender edge shard stages its raw rows next to the
  interface, one shift per interface and direction carries them edge
  shard to edge shard (``halo.InProcessTransport`` over a two-row wire
  mesh), and the receiver resamples and casts them in the sender's dtype
  with the same operations in the same order.  It needs equal y-shard
  counts across an interface (refused by name, as the TPU package does).

Every send of a round is staged before any band is written: a band write
touches band rows only and a send reads owned rows only, so the staged
views stay valid.

Groups on one card (``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES``) run in
turn on one stream, where the TPU package overlaps them on disjoint chips;
over several cards the launches are asynchronous as everywhere else.  A
run across processes is refused (ROADMAP A7, groups across processes).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import groups_signature
from ..driver import make_runner, synchronize
from ..ops.stencil import Fields, Stencil, dtype_name, make_stencil
from ..utils import launchcheck
from ..utils.init import init_state_sharded
from . import halo as halo_lib
from . import mesh as mesh_lib
from . import stepper as stepper_lib

# The default cross-group transport and the two the runner takes.
TRANSPORT_BACKEND = "device_put"
TRANSPORTS = ("device_put", "collective")

# Per-group mode tokens (the trailing +-joined clause qualifier) and the
# combinations auto-policy may propose for an unset group (the TPU
# package's; the policy layer is ROADMAP A8).
MODE_WORDS = ("plain", "stream", "padfree", "overlap", "pipeline")
MODE_CANDIDATES = ((), ("stream",), ("stream", "overlap"))

# What a run across processes is refused by.
PROCESSES_ITEM = "ROADMAP A7 (groups across processes)"

_DTYPE_ALIASES = {
    "f32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "float16": "float16",
    "f64": "float64", "float64": "float64",
}
_DTYPE_SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
                "float64": "f64"}

_MODE_ORDER = ("fuse", "stream", "padfree", "overlap", "pipeline", "plain")


def _canon_modes(modes: Tuple[str, ...]) -> Tuple[str, ...]:
    """Mode tokens in the one canonical order (``fuseK`` first)."""
    def rank(t: str) -> int:
        return _MODE_ORDER.index("fuse" if t.startswith("fuse") else t)
    return tuple(sorted(modes, key=rank))


def _parse_modes(tok: str, clause: str) -> Tuple[str, ...]:
    """Parse one ``+``-joined mode token; every rejection is named."""
    words = tok.split("+")
    modes: List[str] = []
    for w in words:
        if w.startswith("fuse") and w != "fuse":
            try:
                k = int(w[4:])
            except ValueError:
                raise ValueError(
                    f"--groups clause {clause!r}: bad fuse token {w!r} "
                    "(expected fuse<K> with integer K >= 2)") from None
            if k < 2:
                raise ValueError(
                    f"--groups clause {clause!r}: fuse{k} needs K >= 2 "
                    "(fuse1 is the plain stepper — drop the token)")
        elif w not in MODE_WORDS:
            raise ValueError(
                f"--groups clause {clause!r}: unknown mode word {w!r} "
                f"(expected fuse<K> or one of {list(MODE_WORDS)})")
        if w in modes or (w.startswith("fuse")
                          and any(m.startswith("fuse") for m in modes)):
            raise ValueError(
                f"--groups clause {clause!r}: duplicate mode word {w!r}")
        modes.append(w)
    if "stream" in modes and "padfree" in modes:
        raise ValueError(
            f"--groups clause {clause!r}: stream and padfree are "
            "mutually exclusive kernel kinds")
    if "plain" in modes and len(modes) > 1:
        raise ValueError(
            f"--groups clause {clause!r}: 'plain' locks the default "
            "stepper and cannot combine with other mode words")
    out = _canon_modes(tuple(modes))
    if "pipeline" in out:
        if not any(m.startswith("fuse") for m in out) \
                or not ({"stream", "padfree"} & set(out)):
            raise ValueError(
                f"--groups clause {clause!r}: pipeline needs fuse<K> "
                "and a slab-operand kind (stream or padfree) — the "
                "same contract as the monolithic --pipeline")
    return out


_GROUP_RE = re.compile(
    r"^(?P<head>[^@]+)@(?P<d0>\d+)(?:-(?P<d1>\d+))?(?P<tail>(?::[^:,]+)*)$")


# ---------------------------------------------------------------------------
# Spec parsing: the --groups grammar
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One group's requested config, straight from the ``--groups`` string.

    Grammar (comma-separated, one clause per group)::

        <op>[:fine[R]|:coarse][:<dtype>]@<d0>[-<d1>][:z<num>/<den>]
            [:mesh<m0>x<m1>...][:<mode>+<mode>...]

    e.g. ``"wave3d:fine@0-3:z1/4,heat3d:coarse@4-7"``: a 2x-refined wave3d
    hot region over the first quarter of the z axis on devices 0-3, and a
    base-resolution heat3d far-field on devices 4-7.  The trailing mode
    token (``fuseK``, ``stream``/``padfree``, ``overlap``, ``pipeline``,
    joined with ``+``) selects the group's stepper; ``plain`` locks the
    default one, and a clause without a token is unset.
    """

    op: str
    ratio: int = 1             # refinement vs the base grid; power of two
    dtype: str = ""            # "" -> the run's default dtype
    dev_lo: int = 0
    dev_hi: int = 0            # inclusive
    z_num: int = 0             # 0/0 -> even share of the unclaimed rows
    z_den: int = 0
    mesh: Tuple[int, ...] = ()  # per-group mesh shape; () -> (n_devices,)
    modes: Tuple[str, ...] = ()  # canonical mode tokens; () -> unset

    @property
    def n_devices(self) -> int:
        return self.dev_hi - self.dev_lo + 1

    @property
    def fuse_k(self) -> int:
        """Micro-steps per coupled round (the ``fuseK`` token; 1 = plain)."""
        for t in self.modes:
            if t.startswith("fuse"):
                return int(t[4:])
        return 1

    @property
    def kind(self) -> str:
        """Forced fused-kernel kind: ``"stream"``, ``"padfree"``, or ``""``."""
        for t in ("stream", "padfree"):
            if t in self.modes:
                return t
        return ""

    @property
    def overlap_mode(self) -> bool:
        return "overlap" in self.modes

    @property
    def pipeline_mode(self) -> bool:
        return "pipeline" in self.modes

    def with_modes(self, modes: Sequence[str]) -> "GroupSpec":
        """This spec with its mode tokens replaced (canonical order)."""
        return dataclasses.replace(self, modes=_canon_modes(tuple(modes)))

    def canonical(self) -> str:
        """The canonical clause text, reconstructable from any spelling of
        the same group (``config.groups_signature`` of one clause)."""
        head = [self.op]
        if self.ratio > 1:
            head.append("fine" if self.ratio == 2 else f"fine{self.ratio}")
        if self.dtype:
            head.append(_DTYPE_SHORT.get(self.dtype, self.dtype))
        dev = (f"@{self.dev_lo}-{self.dev_hi}" if self.dev_hi != self.dev_lo
               else f"@{self.dev_lo}")
        tail = []
        if self.z_den:
            tail.append(f"z{self.z_num}/{self.z_den}")
        if self.mesh:
            tail.append("mesh" + "x".join(str(m) for m in self.mesh))
        if self.modes:
            tail.append("+".join(self.modes))
        return ":".join(head) + dev + ("".join(":" + t for t in tail))


def parse_groups(spec: str, n_devices: Optional[int] = None
                 ) -> Tuple[GroupSpec, ...]:
    """Parse a ``--groups`` string into validated :class:`GroupSpec` s;
    every rejection is named."""
    clauses = [c.strip() for c in (spec or "").split(",") if c.strip()]
    if len(clauses) < 2:
        raise ValueError(
            f"--groups needs at least 2 comma-separated groups, got "
            f"{len(clauses)} in {spec!r}")
    out: List[GroupSpec] = []
    for clause in clauses:
        m = _GROUP_RE.match(clause)
        if m is None:
            raise ValueError(
                f"--groups clause {clause!r} does not match "
                "<op>[:fine[R]|:coarse][:<dtype>]@<d0>-<d1>"
                "[:z<num>/<den>][:mesh<m0>x<m1>...]")
        head = m.group("head").split(":")
        op, ratio, dtype = head[0], 1, ""
        for tok in head[1:]:
            if tok == "coarse":
                ratio = 1
            elif tok.startswith("fine"):
                ratio = int(tok[4:]) if tok[4:] else 2
                if ratio < 2 or ratio & (ratio - 1):
                    raise ValueError(
                        f"--groups clause {clause!r}: refinement ratio "
                        f"{ratio} must be a power of two >= 2 (bitwise "
                        "restriction/interpolation round-trips need it)")
            elif tok in _DTYPE_ALIASES:
                dtype = _DTYPE_ALIASES[tok]
            else:
                raise ValueError(
                    f"--groups clause {clause!r}: unknown qualifier "
                    f"{tok!r} (expected fine[R], coarse, or a dtype in "
                    f"{sorted(set(_DTYPE_ALIASES))})")
        d0 = int(m.group("d0"))
        d1 = int(m.group("d1")) if m.group("d1") is not None else d0
        if d1 < d0:
            raise ValueError(
                f"--groups clause {clause!r}: device range {d0}-{d1} "
                "is descending")
        z_num = z_den = 0
        gmesh: Tuple[int, ...] = ()
        modes: Tuple[str, ...] = ()
        for tok in [t for t in m.group("tail").split(":") if t]:
            if tok.startswith("mesh"):
                try:
                    gmesh = tuple(int(x) for x in tok[4:].split("x"))
                except ValueError:
                    raise ValueError(
                        f"--groups clause {clause!r}: bad mesh spec "
                        f"{tok!r} (expected mesh<m0>x<m1>...)") from None
            elif tok.startswith("z"):
                fm = re.match(r"^z(\d+)/(\d+)$", tok)
                if fm is None:
                    raise ValueError(
                        f"--groups clause {clause!r}: bad z-fraction "
                        f"{tok!r} (expected z<num>/<den>)")
                z_num, z_den = int(fm.group(1)), int(fm.group(2))
                if z_den == 0 or not 0 < z_num < z_den:
                    raise ValueError(
                        f"--groups clause {clause!r}: z-fraction "
                        f"{z_num}/{z_den} must lie strictly in (0, 1)")
            elif tok.startswith("fuse") or tok.split("+")[0] in MODE_WORDS:
                if modes:
                    raise ValueError(
                        f"--groups clause {clause!r}: more than one mode "
                        f"token (join mode words with '+', e.g. "
                        "stream+overlap)")
                modes = _parse_modes(tok, clause)
            else:
                raise ValueError(
                    f"--groups clause {clause!r}: unknown suffix {tok!r} "
                    "(expected :z<num>/<den>, :mesh<m0>x<m1>..., or a "
                    "'+'-joined mode token of fuse<K>/"
                    + "/".join(MODE_WORDS) + ")")
        if gmesh and int(np.prod(gmesh)) != (d1 - d0 + 1):
            raise ValueError(
                f"--groups clause {clause!r}: mesh {gmesh} needs "
                f"{int(np.prod(gmesh))} devices but the range {d0}-{d1} "
                f"holds {d1 - d0 + 1}")
        out.append(GroupSpec(op=op, ratio=ratio, dtype=dtype, dev_lo=d0,
                             dev_hi=d1, z_num=z_num, z_den=z_den,
                             mesh=gmesh, modes=modes))
    out.sort(key=lambda s: s.dev_lo)
    if out[0].dev_lo != 0:
        raise ValueError(
            f"--groups device ranges must start at device 0 "
            f"(first group starts at {out[0].dev_lo})")
    for a, b in zip(out, out[1:]):
        if b.dev_lo != a.dev_hi + 1:
            raise ValueError(
                f"--groups device ranges must be contiguous and "
                f"disjoint: group at {a.dev_lo}-{a.dev_hi} is followed "
                f"by {b.dev_lo}-{b.dev_hi}")
    if n_devices is not None and out[-1].dev_hi + 1 > n_devices:
        raise ValueError(
            f"--groups needs devices 0-{out[-1].dev_hi} but only "
            f"{n_devices} device(s) are available")
    return tuple(out)


# ---------------------------------------------------------------------------
# Geometry planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One group's resolved geometry: grids, bands, devices, mesh."""

    index: int
    spec: GroupSpec
    stencil: Stencil
    base_z0: int          # owned range on the BASE-resolution z axis
    base_z1: int
    band_lo: int          # ghost-band rows (own units); 0 at a true wall
    band_hi: int
    grid: Tuple[int, ...]        # local grid incl. bands, own units
    mesh_shape: Tuple[int, ...]

    @property
    def name(self) -> str:
        return f"g{self.index}:{self.spec.op}"

    @property
    def ratio(self) -> int:
        return self.spec.ratio

    @property
    def owned_z(self) -> Tuple[int, int]:
        """Owned z range in LOCAL (own-resolution) row indices."""
        n_owned = (self.base_z1 - self.base_z0) * self.spec.ratio
        return (self.band_lo, self.band_lo + n_owned)

    @property
    def cells(self) -> int:
        """Cells the group's step actually computes (incl. bands)."""
        return int(np.prod(self.grid))

    @property
    def owned_cells(self) -> int:
        z0, z1 = self.owned_z
        return int((z1 - z0) * np.prod(self.grid[1:]))

    def devices(self, kind: str = "cuda") -> List[torch.device]:
        """The group's devices: its range of ``mesh.local_devices(kind)``
        (one card seen N times under the virtual-devices variable)."""
        return list(mesh_lib.local_devices(kind)[
            self.spec.dev_lo:self.spec.dev_hi + 1])

    def describe(self) -> Dict[str, Any]:
        """The manifest-facing description of this group."""
        return {
            "group": self.name,
            "op": self.spec.op,
            "ratio": self.spec.ratio,
            "dtype": dtype_name(self.stencil.dtype),
            "devices": [self.spec.dev_lo, self.spec.dev_hi],
            "mesh": list(self.mesh_shape),
            "grid": list(self.grid),
            "base_z": [self.base_z0, self.base_z1],
            "band": [self.band_lo, self.band_hi],
            "modes": list(self.spec.modes),
            "clause": self.spec.canonical(),
        }


def _band_width(st: Stencil, k: int = 1) -> int:
    """Ghost-band rows per interior-facing side, in the group's units:
    ``k * halo * phases`` absorbs one round of ``k`` micro-steps of
    staleness, so every owned row stays exact."""
    return int(k) * st.halo * max(1, len(st.phases or ()))


def plan_groups(specs: Sequence[GroupSpec], base_grid: Sequence[int],
                default_dtype: Optional[str] = None,
                ) -> Tuple[GroupPlan, ...]:
    """Resolve specs against the BASE grid into per-group geometry: group
    g's grid scales every axis by its ratio and adds its ghost bands along
    axis 0."""
    base_grid = tuple(int(g) for g in base_grid)
    Z = base_grid[0]
    ks = sorted({s.fuse_k for s in specs})
    if len(ks) > 1:
        raise ValueError(
            f"--groups: fuse factors {ks} differ between groups — every "
            "group advances together per coupled round, so all clauses "
            "must carry the same fuse<K> (or none)")
    k = ks[0] if ks else 1
    extents: List[Optional[int]] = []
    claimed = 0
    for s in specs:
        if s.z_den:
            rows = Z * s.z_num
            if rows % s.z_den:
                raise ValueError(
                    f"--groups: z-fraction {s.z_num}/{s.z_den} of the "
                    f"{Z}-row base axis is not an integer row count")
            extents.append(rows // s.z_den)
            claimed += rows // s.z_den
        else:
            extents.append(None)
    free = [i for i, e in enumerate(extents) if e is None]
    rest = Z - claimed
    if free:
        if rest <= 0 or rest % len(free):
            raise ValueError(
                f"--groups: {rest} unclaimed base rows do not split "
                f"evenly among {len(free)} group(s) without an explicit "
                "z-fraction")
        for i in free:
            extents[i] = rest // len(free)
    elif rest != 0:
        raise ValueError(
            f"--groups: z-fractions cover {claimed} of {Z} base rows "
            "(must sum to exactly 1)")
    plans: List[GroupPlan] = []
    z0 = 0
    ndim = None
    for i, (s, ext) in enumerate(zip(specs, extents)):
        kwargs: Dict[str, Any] = {}
        if s.dtype or default_dtype:
            kwargs["dtype"] = s.dtype or default_dtype
        st = make_stencil(s.op, **kwargs)
        if ndim is None:
            ndim = st.ndim
        elif st.ndim != ndim:
            raise ValueError(
                f"--groups mixes {ndim}D and {st.ndim}D ops "
                f"({specs[0].op} vs {s.op}) — all groups must share the "
                "grid rank")
        if len(base_grid) != st.ndim:
            raise ValueError(
                f"--groups: {s.op} is {st.ndim}D but the base grid "
                f"{base_grid} has rank {len(base_grid)}")
        m = _band_width(st, k)
        band_lo = m if i > 0 else 0
        band_hi = m if i < len(specs) - 1 else 0
        if ext * s.ratio <= band_lo + band_hi:
            raise ValueError(
                f"--groups: group {i} ({s.op}) owns only {ext} base "
                f"row(s) — fewer than its own ghost bands "
                f"({band_lo}+{band_hi} rows); give it a larger "
                ":z fraction")
        grid = ((ext * s.ratio + band_lo + band_hi,)
                + tuple(g * s.ratio for g in base_grid[1:]))
        mesh_shape = s.mesh or (s.n_devices,)
        if len(mesh_shape) > st.ndim:
            raise ValueError(
                f"--groups: group {i} mesh {mesh_shape} has more axes "
                f"than the {st.ndim}D grid")
        plans.append(GroupPlan(
            index=i, spec=s, stencil=st, base_z0=z0, base_z1=z0 + ext,
            band_lo=band_lo, band_hi=band_hi, grid=grid,
            mesh_shape=tuple(mesh_shape)))
        z0 += ext
    # the receiver's band must be servable from the sender's OWNED rows,
    # resampled across the ratio pair
    for a, b in zip(plans, plans[1:]):
        ra, rb = a.spec.ratio, b.spec.ratio
        if (ra % rb) and (rb % ra):
            raise ValueError(
                f"--groups: neighbor ratios {ra} and {rb} "
                f"({a.name} | {b.name}) must divide one another for "
                "face resampling")
        for recv, send in ((a, b), (b, a)):
            m = recv.band_hi if recv is a else recv.band_lo
            need = -(-m * send.spec.ratio // recv.spec.ratio)  # ceil
            oz0, oz1 = send.owned_z
            if need > oz1 - oz0:
                raise ValueError(
                    f"--groups: {recv.name}'s {m}-row band needs {need} "
                    f"owned row(s) from {send.name}, which owns only "
                    f"{oz1 - oz0}")
    return tuple(plans)


# ---------------------------------------------------------------------------
# Face resampling: exact where exactness is claimed
# ---------------------------------------------------------------------------


def interpolate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Coarse -> fine: piecewise-constant repeat along every axis."""
    if factor == 1:
        return x
    for ax in range(x.dim()):
        x = torch.repeat_interleave(x, factor, dim=ax)
    return x


def restrict(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Fine -> coarse: block mean by iterated pairwise averaging, axis by
    axis, in the field's dtype.

    Power-of-two factors only: ``(a + b) * 0.5`` of equal values is exact
    in every IEEE dtype, so ``restrict(interpolate(x)) == x`` bitwise (the
    interface conservation pin)."""
    if factor == 1:
        return x
    if factor & (factor - 1):
        raise ValueError(
            f"restriction factor {factor} must be a power of two")
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    while factor > 1:
        for ax in range(x.dim()):
            lead = (slice(None),) * ax
            x = (x[lead + (slice(0, None, 2),)]
                 + x[lead + (slice(1, None, 2),)]) * half
        factor //= 2
    return x


# ---------------------------------------------------------------------------
# Interface geometry, shared by both transports
# ---------------------------------------------------------------------------


def _iface_geom(send: GroupPlan, recv: GroupPlan, up: bool
                ) -> Tuple[int, int]:
    """(band rows m on the receiver, raw source rows n_src on the sender):
    both transports read the same ``n_src`` sender rows next to the
    interface."""
    m = recv.band_lo if up else recv.band_hi
    rs, rr = send.spec.ratio, recv.spec.ratio
    if rs >= rr:
        n_src = m * (rs // rr)
    else:
        n_src = -(-m // (rr // rs))  # ceil: interpolation may overshoot
    return m, n_src


def _src_rows(send: GroupPlan, n_src: int, up: bool) -> Tuple[int, int]:
    """The sender's owned rows next to the interface (group-local z)."""
    oz0, oz1 = send.owned_z
    return (oz1 - n_src, oz1) if up else (oz0, oz0 + n_src)


def _axis_source(r0: int, r1: int, rs: int, rr: int
                 ) -> Tuple[int, int, int]:
    """The cut along a y or x axis: the sender cells ``[s0, s1)`` that
    feed receiver cells ``[r0, r1)``, and the offset of ``r0`` in their
    resampled run (nonzero only where an interpolation starts inside a
    coarse cell).  Restriction pairs stay whole: ``r0 * f`` is even."""
    if rs >= rr:
        f = rs // rr
        return r0 * f, r1 * f, 0
    f = rr // rs
    s0, s1 = r0 // f, -(-r1 // f)
    return s0, s1, r0 - s0 * f


def _resample(x: torch.Tensor, rs: int, rr: int, m: int, up: bool,
              crop: Sequence[Tuple[int, int]], dtype) -> torch.Tensor:
    """The sender rows ``x`` (sender units, sender dtype) as the
    receiver's band column: restricted or interpolated, the ``m`` rows
    next to the interface kept, cut to ``crop`` ((offset, length) along
    each axis past z), cast to ``dtype`` last."""
    if rs > rr:
        x = restrict(x, rs // rr)
    elif rr > rs:
        x = interpolate(x, rr // rs)
        n = x.shape[0]
        x = x.narrow(0, n - m, m) if up else x.narrow(0, 0, m)
    for ax, (off, ln) in enumerate(crop, start=1):
        if off or ln != x.shape[ax]:
            x = x.narrow(ax, off, ln)
    return x.to(dtype)


def _exchange_idx(send: GroupPlan, recv: GroupPlan) -> List[int]:
    """Field indices carried across this interface: paired by index up
    to the smaller field count, only those the receiver reads across
    cells (wave's ``u_prev`` keeps its own pinned rows)."""
    n = min(send.stencil.num_fields, recv.stencil.num_fields)
    return [i for i in range(n) if recv.stencil.field_halos[i] > 0]


def _block_box(field: stepper_lib.ShardedField, c) -> List[Tuple[int, int]]:
    """Shard ``c``'s block as [(start, stop)] along every grid axis."""
    return [(o, o + n) for o, n in zip(field.offsets(c), field[0].shape)]


def _gather_box(field: stepper_lib.ShardedField, box, device
                ) -> torch.Tensor:
    """The cells ``box`` ([(start, stop)] a grid axis) of a sharded field
    on ``device``: where one block holds them all, that block's view (no
    copy on its own device), else assembled from every block they touch.
    Only copies onto a card are asynchronous: a host copy is complete on
    return."""
    nb = torch.device(device).type == "cuda"
    mesh = field.mesh
    hits = []
    for c, b in zip(mesh.local_coords(), field):
        bb = _block_box(field, c)
        lo = [max(a[0], o[0]) for a, o in zip(box, bb)]
        hi = [min(a[1], o[1]) for a, o in zip(box, bb)]
        if all(h > l for l, h in zip(lo, hi)):
            hits.append((bb, b, lo, hi))
    if len(hits) == 1 and all(l == a[0] and h == a[1] for l, h, a in zip(
            hits[0][2], hits[0][3], box)):
        bb, b, _, _ = hits[0]
        view = b[tuple(slice(a[0] - o[0], a[1] - o[0])
                       for a, o in zip(box, bb))]
        return view.to(device, non_blocking=nb)
    out = torch.empty([a[1] - a[0] for a in box], dtype=field.dtype,
                      device=device)
    for bb, b, lo, hi in hits:
        out[tuple(slice(l - a[0], h - a[0]) for l, h, a in zip(
            lo, hi, box))].copy_(b[tuple(slice(l - o[0], h - o[0])
                                         for l, h, o in zip(lo, hi, bb))],
                                 non_blocking=nb)
    return out


@dataclasses.dataclass
class _Column:
    """One receiver block column of an interface direction: the band rows
    of the receiver blocks at one (y, x) position, fed by one sender box.

    ``box``: the sender cells (sender units) that feed the column; ``crop``:
    (offset, length) past z after resampling; ``writes``: (block index,
    row in the block, row in the band column, rows) of every receiver
    block the band touches."""

    box: List[Tuple[int, int]]
    crop: List[Tuple[int, int]]
    device: torch.device
    writes: List[Tuple[int, int, int, int]]


def _columns(send: GroupPlan, recv: GroupPlan, recv_mesh, up: bool
             ) -> List[_Column]:
    """The receiver's band split by its block columns (the receiver's
    y/x shards set the cut), with the sender box of each."""
    m, n_src = _iface_geom(send, recv, up)
    rs, rr = send.spec.ratio, recv.spec.ratio
    nz = recv.grid[0]
    band0 = 0 if up else nz - m
    counts = recv_mesh.counts(len(recv.grid))
    local = [g // c for g, c in zip(recv.grid, counts)]
    z0, z1 = _src_rows(send, n_src, up)
    cols: Dict[Tuple[int, ...], _Column] = {}
    for j, c in enumerate(recv_mesh.local_coords()):
        sp = recv_mesh.spatial(c)
        sp = tuple(sp) + (0,) * (len(local) - len(sp))
        bz0 = sp[0] * local[0]
        r0, r1 = max(band0, bz0), min(band0 + m, bz0 + local[0])
        if r1 <= r0:
            continue
        key = sp[1:]
        if key not in cols:
            box, crop = [(z0, z1)], []
            for ax in range(1, len(local)):
                a0 = sp[ax] * local[ax]
                s0, s1, off = _axis_source(a0, a0 + local[ax], rs, rr)
                box.append((s0, s1))
                crop.append((off, local[ax]))
            cols[key] = _Column(box, crop, recv_mesh.device(c), [])
        cols[key].writes.append((j, r0 - bz0, r0 - band0, r1 - r0))
    return list(cols.values())


def _write_band(field: stepper_lib.ShardedField, writes,
                band: torch.Tensor) -> None:
    """Write a band column into the receiver blocks, in place."""
    for j, row, brow, n in writes:
        field[j].narrow(0, row, n).copy_(band.narrow(0, brow, n))


# ---------------------------------------------------------------------------
# The coupled runner
# ---------------------------------------------------------------------------


class CoupledRunner:
    """N groups, each on its own mesh, coupled at interface faces.

    A round is :meth:`exchange` (every band refreshed from its neighbour's
    owned rows) then one step of every group's runner.  ``transport``
    selects the band refresh (``device_put`` or ``collective``, bit-
    identical); a group whose clause carries mode tokens runs the matching
    fused/overlap/pipeline stepper, and a forced kind the builder declines
    raises by name.  ``device``: the device kind the groups' meshes take
    (``cuda`` by default; the CPU for tests).

    ``stats``: ``shifts`` (the collective transport's wire shifts, 2 an
    interface a round) and ``device_puts`` (the device_put transport's
    band columns moved).
    """

    def __init__(self, plans: Sequence[GroupPlan], seed: int = 0,
                 density: float = 0.15, init_kind: str = "auto",
                 transport: str = TRANSPORT_BACKEND, device="cuda"):
        if transport not in TRANSPORTS:
            raise ValueError(
                f"--group-transport {transport!r} is not one of "
                f"{list(TRANSPORTS)}")
        if mesh_lib.process_count() > 1:
            raise NotImplementedError(
                f"--groups across processes is not ported: {PROCESSES_ITEM}")
        self.plans = tuple(plans)
        self.n_groups = len(self.plans)
        self.transport = transport
        self.device = torch.device(device)
        self.round = 0
        self.meshes = []
        self.fields: List[Fields] = []
        self._step_fns = []
        self._runners = []
        self._puts = 0
        for p in self.plans:
            msh = mesh_lib.make_mesh(p.mesh_shape,
                                     devices=p.devices(self.device.type))
            self.meshes.append(msh)
            step = self._make_group_step(p, msh)
            self._step_fns.append(step)
            self._runners.append(make_runner(step, 1))
            self.fields.append(self._init_group(p, msh, seed, density,
                                                init_kind))
        self._wire = halo_lib.InProcessTransport()
        if transport == "collective":
            self._wires = self._build_collective()
        self._cols = self._build_columns()

    def _make_group_step(self, p: GroupPlan, msh):
        """The group's interior stepper, per its clause mode tokens:
        ``fuseK``/``stream``/``padfree``/``pipeline`` through
        ``make_sharded_temporal_step`` (k micro-steps a round), ``overlap``
        alone through the plain sharded stepper's split.  A forced kind the
        builder declines raises; overlap keeps the monolithic soft
        fallback (``step._overlap_active``)."""
        s = p.spec
        if s.kind or s.fuse_k > 1 or s.pipeline_mode:
            step = stepper_lib.make_sharded_temporal_step(
                p.stencil, msh, p.grid, s.fuse_k,
                kind=s.kind or None, overlap=s.overlap_mode,
                pipeline=s.pipeline_mode, device=self.device)
            if step is None:
                raise ValueError(
                    f"--groups: group {p.name} forces mode "
                    f"{'+'.join(s.modes)!r} but the fused builder "
                    f"declines grid {p.grid} on mesh {p.mesh_shape} — "
                    "forced modes never fall back silently")
            return step
        return stepper_lib.make_sharded_step(p.stencil, msh, p.grid,
                                             overlap=s.overlap_mode)

    # -- construction ---------------------------------------------------

    def _init_group(self, p: GroupPlan, msh, seed, density, kind) -> Fields:
        """The group's rows of the op's global init at the group's own
        resolution, each block built at its global offsets (no device
        holds the global grid): equal to slicing the global init."""
        r = p.spec.ratio
        global_grid = (self._base_z_total() * r,) + tuple(p.grid[1:])
        z0 = p.base_z0 * r - p.band_lo
        origin = (z0,) + (0,) * (len(p.grid) - 1)
        return init_state_sharded(p.stencil, global_grid, msh, seed=seed,
                                  density=density, kind=kind,
                                  window=(origin, p.grid))

    def _base_z_total(self) -> int:
        return self.plans[-1].base_z1

    def _build_columns(self):
        """Per interface direction: (send group, recv group, up, field
        indices, columns) of the band refresh."""
        out = []
        for lo, hi in zip(self.plans, self.plans[1:]):
            for up in (True, False):
                send, recv = (lo, hi) if up else (hi, lo)
                out.append((send.index, recv.index, up,
                            _exchange_idx(send, recv),
                            _columns(send, recv, self.meshes[recv.index],
                                     up)))
        return out

    # -- the collective transport ---------------------------------------

    def _mesh_zy(self, p: GroupPlan) -> Tuple[int, int]:
        """(z-shards, y-shards) of a group mesh; axes past y must be 1."""
        ms = p.mesh_shape
        nz = ms[0] if len(ms) >= 1 else 1
        ny = ms[1] if len(ms) >= 2 else 1
        if any(c > 1 for c in ms[2:]):
            raise ValueError(
                f"--group-transport collective: group {p.name} mesh "
                f"{ms} shards a grid axis past (z, y) — edge-shard "
                "pairing is defined on z/y meshes only; drop the axis "
                "or use --group-transport device_put")
        return nz, ny

    def _build_collective(self):
        """Per interface direction, the wire: the sender's and receiver's
        edge shards as the two rows of a (2, ny) mesh (the lower group's
        first), so one shift along its z axis carries every y position's
        rows; and the sender rows each edge shard stages."""
        wires = []
        for lo, hi in zip(self.plans, self.plans[1:]):
            for up in (True, False):
                send, recv = (lo, hi) if up else (hi, lo)
                wires.append(self._make_wire(send, recv, up))
        return wires

    def _make_wire(self, send: GroupPlan, recv: GroupPlan, up: bool):
        m, n_src = _iface_geom(send, recv, up)
        nz_s, ny_s = self._mesh_zy(send)
        nz_r, ny_r = self._mesh_zy(recv)
        if ny_s != ny_r:
            raise ValueError(
                f"--group-transport collective: interface "
                f"{send.name}|{recv.name} pairs edge shards y-position "
                f"by y-position, so both groups need the SAME y-shard "
                f"count (got {ny_s} vs {ny_r}); match the :mesh clauses "
                "or use --group-transport device_put")
        ny = ny_s
        zloc_s = send.grid[0] // nz_s
        guard = send.band_hi if up else send.band_lo
        if n_src + guard > zloc_s:
            raise ValueError(
                f"--group-transport collective: {recv.name}'s band "
                f"needs {n_src} owned row(s) plus {guard} band row(s) "
                f"resident on {send.name}'s edge z-shard, but each of "
                f"its {nz_s} shard(s) holds only {zloc_s} rows — use "
                f"fewer z-shards in {send.name}'s mesh")
        zloc_r = recv.grid[0] // nz_r
        if m > zloc_r:
            raise ValueError(
                f"--group-transport collective: {recv.name}'s {m}-row "
                f"band exceeds its own edge shard's {zloc_r} local rows "
                f"— use fewer z-shards in {recv.name}'s mesh")
        smesh, rmesh = self.meshes[send.index], self.meshes[recv.index]
        ez_s = nz_s - 1 if up else 0
        ez_r = 0 if up else nz_r - 1
        s_edge = [smesh.local_index(self._coord(smesh, ez_s, y))
                  for y in range(ny)]
        r_edge = [rmesh.local_index(self._coord(rmesh, ez_r, y))
                  for y in range(ny)]
        lo_edge, hi_edge = (s_edge, r_edge) if up else (r_edge, s_edge)
        lo_mesh, hi_mesh = (smesh, rmesh) if up else (rmesh, smesh)
        wire = mesh_lib.Mesh(
            (2, ny), [lo_mesh.devices[i] for i in lo_edge]
            + [hi_mesh.devices[i] for i in hi_edge])
        a = zloc_s - guard - n_src if up else guard
        return {"send_g": send.index, "up": up, "rows": (a, n_src),
                "s_edge": s_edge, "mesh": wire,
                "empty": [torch.empty(0, device=d) for d in wire.devices]}

    @staticmethod
    def _coord(msh, z: int, y: int):
        return tuple(([z, y] + [0] * len(msh.shape))[:len(msh.shape)])

    def _shift_collective(self, wire, idx) -> List[torch.Tensor]:
        """One wire shift: every sender edge shard's staged rows, stacked
        over the exchanged fields, to the receiver edge shard at its y
        position; returns the landed chunks in y order."""
        a, n = wire["rows"]
        fs = self.fields[wire["send_g"]]
        staged = [torch.stack([fs[i][j].narrow(0, a, n) for i in idx])
                  for j in wire["s_edge"]]
        ny = len(staged)
        empty = wire["empty"]
        if wire["up"]:  # the lower group's row sends its hi slabs
            hi, lo = staged + empty[ny:], empty
        else:
            hi, lo = empty, empty[:ny] + staged
        left, right = self._wire.post(hi, lo, wire["mesh"], 0,
                                      False).wait()
        return left[ny:] if wire["up"] else right[:ny]

    # -- the round loop -------------------------------------------------

    def exchange(self) -> None:
        """Refresh every interface band from its neighbour's owned rows.

        Every band column of the round is computed before any is written:
        a write touches band rows only and a send reads owned rows only,
        so the staged columns (views where a block holds them) stay
        valid."""
        staged = []
        for d, (send_g, recv_g, up, idx, cols) in enumerate(self._cols):
            send, recv = self.plans[send_g], self.plans[recv_g]
            m, _ = _iface_geom(send, recv, up)
            rs, rr = send.spec.ratio, recv.spec.ratio
            dtype = recv.stencil.dtype
            if self.transport == "collective":
                # the receiver's columns are its edge shards, in y order
                chunks = self._shift_collective(self._wires[d], idx)
                srcs = [list(ch.unbind(0)) for ch in chunks]
            else:
                srcs = [[_gather_box(self.fields[send_g][i], col.box,
                                     col.device) for i in idx]
                        for col in cols]
                self._puts += len(cols)
                launchcheck.note("put", reads=self.fields[send_g],
                                 writes=srcs)
            bands = [[_resample(x, rs, rr, m, up, col.crop, dtype)
                      for x in src] for col, src in zip(cols, srcs)]
            staged.append((recv_g, idx, cols, bands))
        for recv_g, idx, cols, bands in staged:
            fs = self.fields[recv_g]
            for col, band in zip(cols, bands):
                for i, b in zip(idx, band):
                    _write_band(fs[i], col.writes, b)
            launchcheck.note("band", reads=bands, writes=fs)

    def step_round(self) -> None:
        """One coupled round: exchange, then every group steps once (in
        turn; the launches are asynchronous)."""
        with launchcheck.tag(phase="interface"):
            self.exchange()
        for g, runner in enumerate(self._runners):
            with launchcheck.tag(group=g):
                self.fields[g] = runner(self.fields[g])
        self.round += 1

    def run(self, rounds: int, on_round=None) -> None:
        for _ in range(int(rounds)):
            self.step_round()
            if on_round is not None:
                on_round(self)

    def block_until_ready(self) -> None:
        for fs in self.fields:
            synchronize(fs)

    @property
    def stats(self) -> Dict[str, int]:
        return {"shifts": self._wire.stats["shifts"],
                "device_puts": self._puts}

    def sharded_group_indices(self) -> List[int]:
        """Groups whose mesh actually shards an axis (> 1 shard)."""
        return [i for i, p in enumerate(self.plans)
                if any(c > 1 for c in p.mesh_shape)]

    def step_kinds(self) -> List[str]:
        """Each group's stepper, as the fused builders tag it (the pad-
        free kinds' ``_padfree_kind``), else "padded" or "plain"."""
        out = []
        for p, step in zip(self.plans, self._step_fns):
            kind = getattr(step, "_padfree_kind", None)
            if kind is None:
                kind = "padded" if p.spec.fuse_k > 1 else "plain"
            out.append(kind)
        return out

    # -- accounting ------------------------------------------------------

    def cell_updates_per_round(self) -> int:
        """Cells actually computed per round, summed over groups (one
        micro-step's, as the TPU package counts them)."""
        return sum(p.cells for p in self.plans)

    # -- assembly ---------------------------------------------------------

    def assemble(self) -> Tuple[torch.Tensor, ...]:
        """Base-resolution global fields on the host: fine groups
        restricted, owned rows concatenated; the field indices every group
        has."""
        n = min(p.stencil.num_fields for p in self.plans)
        out = []
        for i in range(n):
            parts = []
            for p, fs in zip(self.plans, self.fields):
                z0, z1 = p.owned_z
                box = [(z0, z1)] + [(0, g) for g in p.grid[1:]]
                owned = _gather_box(fs[i], box, torch.device("cpu"))
                parts.append(restrict(owned, p.spec.ratio))
            out.append(torch.cat(parts, dim=0))
        return tuple(out)

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """One ``npy`` checkpoint a group under ``path/group{i}``, each at
        this round (the TPU package's layout)."""
        from ..utils import checkpointing

        for p, fs in zip(self.plans, self.fields):
            checkpointing.save_checkpoint(
                os.path.join(path, f"group{p.index}"), fs, self.round,
                config={"group": p.describe()})

    def load_checkpoint(self, path: str) -> int:
        """Every group's fields from ``path/group{i}`` (written by either
        package), each block reading its own slices; the groups must agree
        on the round."""
        from ..utils import checkpointing

        steps = set()
        for g, p in enumerate(self.plans):
            msh = self.meshes[g]
            counts = msh.counts(len(p.grid))
            local = tuple(s // c for s, c in zip(p.grid, counts))
            targets = tuple(
                stepper_lib.ShardedField(
                    [torch.empty(local, dtype=p.stencil.dtype,
                                 device=msh.device(c))
                     for c in msh.local_coords()], msh, p.grid)
                for _ in range(p.stencil.num_fields))
            d = os.path.join(path, f"group{p.index}")
            try:
                fields, step, _ = checkpointing.load_any(
                    d, target_fields=targets)
            except ValueError as e:
                raise ValueError(
                    f"coupled checkpoint group {p.name}: {e} (planned "
                    f"grid {p.grid})") from None
            self.fields[g] = fields
            steps.add(int(step))
        if len(steps) != 1:
            raise ValueError(
                f"coupled checkpoint groups disagree on step: {sorted(steps)}")
        self.round = steps.pop()
        return self.round


# ---------------------------------------------------------------------------
# Interface traffic accounting (the budget's feed)
# ---------------------------------------------------------------------------


def interface_traffic(plans: Sequence[GroupPlan]) -> List[Dict[str, Any]]:
    """Per-interface transfer accounting: bytes per round, per direction
    (the receiver's band and the sender's staged rows)."""
    out = []
    for lo, hi in zip(plans, plans[1:]):
        entry: Dict[str, Any] = {
            "interface": f"{lo.name}|{hi.name}",
            "ratio": [lo.spec.ratio, hi.spec.ratio],
            "dtypes": [dtype_name(lo.stencil.dtype),
                       dtype_name(hi.stencil.dtype)],
        }
        for direction, send, recv in (("up", lo, hi), ("down", hi, lo)):
            m = recv.band_lo if direction == "up" else recv.band_hi
            n_fields = len(_exchange_idx(send, recv))
            band_cells = m * int(np.prod(recv.grid[1:]))
            recv_bytes = band_cells * recv.stencil.dtype.itemsize * n_fields
            f = max(send.spec.ratio // recv.spec.ratio, 1)
            n_src = (m * f if send.spec.ratio >= recv.spec.ratio
                     else -(-m * send.spec.ratio // recv.spec.ratio))
            send_bytes = (n_src * int(np.prod(send.grid[1:]))
                          * send.stencil.dtype.itemsize * n_fields)
            entry[direction] = {"fields": n_fields,
                                "recv_bytes": int(recv_bytes),
                                "send_bytes": int(send_bytes)}
        out.append(entry)
    return out


def plans_from_config(groups: str, base_grid: Sequence[int],
                      default_dtype: Optional[str] = None,
                      n_devices: Optional[int] = None
                      ) -> Tuple[GroupPlan, ...]:
    """The one-call config -> plans path every entry point shares."""
    specs = parse_groups(groups, n_devices=n_devices)
    return plan_groups(specs, base_grid, default_dtype=default_dtype)


__all__ = [
    "GroupSpec", "GroupPlan", "CoupledRunner", "parse_groups",
    "plan_groups", "plans_from_config", "interpolate", "restrict",
    "interface_traffic", "groups_signature", "TRANSPORT_BACKEND",
    "TRANSPORTS", "MODE_WORDS", "MODE_CANDIDATES", "PROCESSES_ITEM",
]
