"""Numerics sentinel: on-device simulation-health observability.

The port's counterpart of the TPU package's ``obs/health.py``: the same
records, verdict rules and fault payload, with the reductions rebuilt for
fields that live as blocks.

* :func:`make_health_fn` — the health reduction: per-field global
  min/max/mean + NaN/Inf counts, plus the op's REGISTERED conservation
  invariant (:class:`~..ops.stencil.HealthInvariant`: heat's total heat,
  wave's exactly-conserved leapfrog energy, SOR's decreasing residual
  norm, Life's population).  The reference reduces over the global array
  and lets XLA insert the combines; here each block of a
  ``ShardedField`` (or the one tensor of an unsharded field) is reduced
  on its device in z-slabs of at most :data:`CHUNK_ELEMS` cells (so the
  float32 and ``isfinite`` transients stay a bounded slice of a block
  however large the block), each block's partials land in one float64
  vector, the vectors of a mesh that spans processes are gathered with
  one ``all_gather`` on the run's process group, and every process
  combines every block's partials in the global row-major order on the
  host: the same values on every process, and the same as one process
  driving the same mesh.  No field state is ever gathered.  The wave
  energy and the SOR residual take neighbour differences; their terms
  that cross a block edge read the neighbour's edge row, which a width-1
  slab exchange through the run's own transport brings into a transient
  (``parallel/halo.py``), so the combined value equals the unsharded
  one.  With ``ensemble`` the values are per member.

* :class:`HealthMonitor` — the trend detector (the reference's, line for
  line): relative drift vs the first check's baseline with the op's
  registered tolerance turns the stats into ``health`` events and a
  ``DIVERGED`` verdict (:class:`SimulationDiverged`).

* :func:`apply_nan_poison` — the ``numerics`` fault site's payload.

* :class:`HaloAuditor` (``--halo-audit K``) — re-exchanges every site's
  ghost slabs through the run's transport (the in-process copies, the
  ``torch.distributed`` transport, or the ring kernel for
  ``exchange="rdma"``) and compares them bit for bit with the neighbour's
  border rows, read straight from the neighbour's block in one process,
  or across processes from one ``all_gather`` of every shard's border
  rows: the expected side shares no code with the exchange.

Cost rule: the reductions and the audit run only at chunk boundaries,
outside the step: the step's aten ops and kernel launches are identical
with them on and off.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.stencil import Stencil

log = logging.getLogger("mpi_cuda_process_tpu_torch.obs.health")

VERDICT_HEALTHY = "HEALTHY"
VERDICT_DIVERGED = "DIVERGED"

_EPS = 1e-12

# Cells of one reduction slab: bounds the health check's transients (a
# float32 copy of a bfloat16 slab, the isfinite mask, the padded slab of
# the neighbour invariants) whatever the block's size.
CHUNK_ELEMS = 1 << 24

# The registered invariants (ops/), each computed here from partials that
# combine across blocks; an op that registers another must add its form.
_BLOCK_INVARIANTS = ("total_heat", "population", "discrete_energy",
                     "residual_norm")


class SimulationDiverged(RuntimeError):
    """The run's state failed a health check; carries the record."""

    def __init__(self, message: str, record: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.record = record


# ----------------------------------------------------------- the blocks

def _blocks(f) -> List[Tuple[Optional[tuple], torch.Tensor]]:
    """``(shard coordinate, block)`` of each block of a field this process
    holds: the one tensor of an unsharded field (coordinate None)."""
    mesh = getattr(f, "mesh", None)
    if mesh is None:
        return [(None, f)]
    return list(zip(mesh.local_coords(), f))


def _gshape(f) -> Tuple[int, ...]:
    """A field's global shape (a ``ShardedField``'s, or the tensor's)."""
    g = getattr(f, "global_shape", None)
    return tuple(f.shape if g is None else g)


def _allgather(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` (one row per local block, stacked) from every process in the
    global row-major order: one ``all_gather`` of its bytes (gloo through
    the CPU), ``t`` itself on a mesh of one process."""
    if mesh is None or not mesh.multiprocess:
        return t
    import torch.distributed as dist

    via = t.device if mesh.backend == "nccl" else torch.device("cpu")
    flat = t.contiguous().reshape(-1).view(torch.uint8).to(via)
    got = [torch.empty_like(flat) for _ in range(mesh.processes)]
    dist.all_gather(got, flat)
    return torch.cat(got).view(t.dtype).reshape(
        (-1,) + tuple(t.shape[1:])).to(t.device)


def _rows(n_rows: int, per_row: int) -> int:
    """Rows of one reduction slab."""
    return max(1, min(n_rows, CHUNK_ELEMS // max(1, per_row)))


def _slab_stats(x: torch.Tensor, lead: int, floating: bool) -> torch.Tensor:
    """``(M, 4)`` float64 [min, max, sum, nonfinite] of one slab, per
    member (M = 1 unbatched)."""
    y = x if lead else x.unsqueeze(0)
    dims = tuple(range(1, y.dim()))
    mn = torch.amin(y, dim=dims).to(torch.float64)
    mx = torch.amax(y, dim=dims).to(torch.float64)
    s = torch.sum(y, dim=dims, dtype=torch.float64)
    if floating:
        cells = math.prod(y.shape[1:])
        nf = cells - torch.isfinite(y).sum(dim=dims).to(torch.float64)
    else:
        nf = torch.zeros_like(s)
    return torch.stack([mn, mx, s, nf], dim=1)


def _block_stats(b: torch.Tensor, lead: int, floating: bool) -> torch.Tensor:
    """``(M, 4)`` [min, max, sum, nonfinite] of one block, slab by slab
    along its first grid axis."""
    n = b.shape[lead]
    step = _rows(n, math.prod(b.shape) // max(1, n))
    parts = [_slab_stats(b.narrow(lead, z, min(step, n - z)), lead,
                         floating)
             for z in range(0, n, step)]
    st = torch.stack(parts)  # (slabs, M, 4)
    return torch.stack([st[:, :, 0].amin(0), st[:, :, 1].amax(0),
                        st[:, :, 2].sum(0), st[:, :, 3].sum(0)], dim=1)


# ------------------------------------------- invariants across blocks

def _edge_rows(fields_sel, lead: int, ndim: int):
    """Per sharded axis d: ``(lefts, rights)`` width-1 slabs of each
    selected field's local blocks (the neighbours' edge rows), through
    the run's own transport; {} for unsharded fields."""
    from ..parallel import halo

    f0 = fields_sel[0]
    mesh = getattr(f0, "mesh", None)
    if mesh is None:
        return {}
    out = {}
    for d, c in enumerate(mesh.counts(ndim)):
        if c > 1:
            out[d] = [halo.exchange_slabs_axis(list(f), mesh, d, 1, 0.0,
                                               False, lead=lead)
                      for f in fields_sel]
    return out


def _padded_slab(b: torch.Tensor, j: int, z0: int, z1: int, lead: int,
                 ndim: int, edges, k: int) -> torch.Tensor:
    """Rows ``[z0, z1)`` of block ``b`` (field ``k`` of the selection,
    local block ``j``) in float32, padded by one cell on every grid axis
    with the neighbour cells: the block's own rows, else the exchanged
    edge rows of a sharded axis, else zeros (outside the grid: never
    read by a term)."""
    L = b.shape[lead:]
    shape = tuple(b.shape[:lead]) + (z1 - z0 + 2,) + tuple(
        s + 2 for s in L[1:])
    p = torch.zeros(shape, dtype=torch.float32, device=b.device)
    pre = (slice(None),) * lead
    inner = tuple(slice(1, 1 + s) for s in L[1:])
    p[pre + (slice(1, 1 + z1 - z0),) + inner] = b.narrow(lead, z0, z1 - z0)
    if z0 > 0:
        p[pre + (slice(0, 1),) + inner] = b.narrow(lead, z0 - 1, 1)
    elif 0 in edges:
        p[pre + (slice(0, 1),) + inner] = edges[0][k][0][j]
    if z1 < L[0]:
        p[pre + (slice(-1, None),) + inner] = b.narrow(lead, z1, 1)
    elif 0 in edges:
        p[pre + (slice(-1, None),) + inner] = edges[0][k][1][j]
    for d in range(1, ndim):
        if d not in edges:
            continue
        lefts, rights = edges[d][k]
        for side, src in ((0, lefts[j]), (L[d] + 1, rights[j])):
            idx = [slice(1, 1 + s) for s in L[1:]]
            idx[d - 1] = slice(side, side + 1)
            p[pre + (slice(1, 1 + z1 - z0),) + tuple(idx)] = \
                src.narrow(lead, z0, z1 - z0)
    return p


def _core(p: torch.Tensor, lead: int, ndim: int, d: int = -1,
          start: int = 1, size: Optional[int] = None, ranges=None):
    """A view of the padded slab: the core cells (``ranges[e]``: a
    ``(start, stop)`` of core positions per axis, default all), shifted
    by one cell along axis ``d`` when ``start`` differs from 1."""
    idx = []
    for e in range(ndim):
        lo, hi = ranges[e] if ranges is not None else (
            0, p.shape[lead + e] - 2)
        off = (start - 1) if e == d else 0
        idx.append(slice(1 + lo + off, 1 + hi + off))
    return p[(slice(None),) * lead + tuple(idx)]


def _sum_members(x: torch.Tensor, lead: int) -> torch.Tensor:
    """Sum over every axis but the member axis: (M,) float64."""
    y = x if lead else x.unsqueeze(0)
    return torch.sum(y, dim=tuple(range(1, y.dim())), dtype=torch.float64)


def _block_invariant(name: str, sel, j: int, c, lead: int, ndim: int,
                     gshape, edges, lam: float = 0.0) -> torch.Tensor:
    """``(M, 2)`` float64 partials of a neighbour invariant over local
    block ``j`` (shard ``c``): the discrete energy's sum (and 0; ``lam``
    its c2dt2), or the residual's sum of squares and its cell count."""
    b0 = sel[0][j] if getattr(sel[0], "mesh", None) is not None else sel[0]
    L = b0.shape[lead:]
    M = b0.shape[0] if lead else 1
    mesh = getattr(sel[0], "mesh", None)
    off = [0] * ndim
    if mesh is not None:
        sp = mesh.spatial(c)
        off = [(sp[d] if d < len(sp) else 0) * L[d] for d in range(ndim)]
    blocks = [f[j] if mesh is not None else f for f in sel]
    step = _rows(L[0], math.prod(b0.shape) // max(1, L[0]))
    acc = torch.zeros((M, 2), dtype=torch.float64, device=b0.device)
    for z0 in range(0, L[0], step):
        z1 = min(L[0], z0 + step)
        ps = [_padded_slab(b, j, z0, z1, lead, ndim, edges, k)
              for k, b in enumerate(blocks)]
        n = [z1 - z0] + list(L[1:])
        g0 = [z0 + off[0]] + off[1:]
        if name == "discrete_energy":
            u, up = ps
            du = _core(u, lead, ndim) - _core(up, lead, ndim)
            e = _sum_members(du * du, lead)
            for d in range(ndim):
                # pairs (i, i + 1) inside the grid: i < G_d - 1
                k_valid = min(n[d], gshape[d] - 1 - g0[d])
                if k_valid <= 0:
                    continue
                rng = [(0, m) for m in n]
                rng[d] = (0, k_valid)
                a = _core(u, lead, ndim, ranges=rng)
                a1 = _core(u, lead, ndim, d=d, start=2, ranges=rng)
                bb = _core(up, lead, ndim, ranges=rng)
                b1 = _core(up, lead, ndim, d=d, start=2, ranges=rng)
                e = e + lam * _sum_members((a1 - a) * (b1 - bb), lead)
            acc[:, 0] += e
        else:  # residual_norm: the global interior, 1 <= g <= G - 2
            rng = []
            for d in range(ndim):
                lo = max(0, 1 - g0[d])
                hi = min(n[d], gshape[d] - 1 - g0[d])
                rng.append((lo, max(lo, hi)))
            cells = math.prod(hi - lo for lo, hi in rng)
            if cells == 0:
                continue
            (u,) = ps
            r = -2.0 * ndim * _core(u, lead, ndim, ranges=rng)
            for d in range(ndim):
                r = r + _core(u, lead, ndim, d=d, start=2, ranges=rng) \
                    + _core(u, lead, ndim, d=d, start=0, ranges=rng)
            acc[:, 0] += _sum_members(r * r, lead)
            acc[:, 1] += float(cells)
    return acc


def make_health_fn(stencil: Stencil, ensemble: int = 0):
    """The health reduction: fields -> dict of host values.

    ``fields`` are whole tensors or ``ShardedField`` s; the dict holds
    ``field{i}_min``/``_max``/``_mean`` (and ``_nonfinite`` for float
    fields) and ``invariant``, as float64 numpy scalars, or with
    ``ensemble`` N as per-member vectors of N.  One host fetch a call; on
    a mesh that spans processes, collective (every process calls it)."""
    inv = stencil.invariant
    if inv is not None and inv.name not in _BLOCK_INVARIANTS:
        raise NotImplementedError(
            f"health invariant {inv.name!r} of {stencil.name} has no "
            "block decomposition in obs/health.py")
    ens = int(ensemble) > 0
    lead = 1 if ens else 0
    ndim = stencil.ndim
    lam = float(stencil.params.get("c2dt2", 0.0))

    def staged(fields) -> Dict[str, Any]:
        fields = tuple(fields)
        f0 = fields[0]
        mesh = getattr(f0, "mesh", None)
        gshape = _gshape(f0)[lead:]
        N = _gshape(f0)[0] if ens else 1
        cells = math.prod(gshape)
        coords = [c for c, _ in _blocks(f0)]
        per_block: List[List[torch.Tensor]] = [[] for _ in coords]
        floating = [f.dtype.is_floating_point for f in fields]
        for i, f in enumerate(fields):
            for j, (_, b) in enumerate(_blocks(f)):
                per_block[j].append(
                    _block_stats(b, lead, floating[i]).reshape(-1))
        nbr = inv is not None and inv.name in ("discrete_energy",
                                               "residual_norm")
        if nbr:
            sel = fields[:2] if inv.name == "discrete_energy" else fields[:1]
            edges = _edge_rows(sel, lead, ndim)
            for j, c in enumerate(coords):
                per_block[j].append(_block_invariant(
                    inv.name, sel, j, c, lead, ndim, gshape,
                    edges, lam).reshape(-1))
        rows = torch.stack([torch.cat([t.to(per_block[0][0].device)
                                       for t in parts])
                            for parts in per_block])
        allv = _allgather(mesh, rows).cpu().numpy()  # (blocks, K)
        M = N // (mesh.ensemble if mesh is not None and ens else 1) \
            if ens else 1
        nf = len(fields)
        stats = np.zeros((nf, N, 4))
        stats[:, :, 0] = np.inf
        stats[:, :, 1] = -np.inf
        inv_acc = np.zeros((N, 2))
        gcoords = list(mesh.coords()) if mesh is not None else [None]
        for g, c in enumerate(gcoords):
            m0 = mesh.group(c) * M if (mesh is not None and ens) else 0
            v = allv[g]
            for i in range(nf):
                blk = v[i * M * 4:(i + 1) * M * 4].reshape(M, 4)
                s = stats[i, m0:m0 + M]
                # np.minimum / np.maximum propagate NaN, as the
                # reference's reductions do
                s[:, 0] = np.minimum(s[:, 0], blk[:, 0])
                s[:, 1] = np.maximum(s[:, 1], blk[:, 1])
                s[:, 2] += blk[:, 2]
                s[:, 3] += blk[:, 3]
            if nbr:
                inv_acc[m0:m0 + M] += v[nf * M * 4:].reshape(M, 2)
        out: Dict[str, Any] = {}

        def val(a):
            return a if ens else a[0]

        for i in range(nf):
            out[f"field{i}_min"] = val(stats[i, :, 0])
            out[f"field{i}_max"] = val(stats[i, :, 1])
            out[f"field{i}_mean"] = val(stats[i, :, 2] / cells)
            if floating[i]:
                out[f"field{i}_nonfinite"] = val(stats[i, :, 3])
        if inv is None:
            return out
        if inv.name == "total_heat":
            out["invariant"] = val(stats[0, :, 2] / cells)
        elif inv.name == "population":
            out["invariant"] = val(stats[0, :, 2])
        elif inv.name == "discrete_energy":
            out["invariant"] = val(inv_acc[:, 0])
        else:  # residual_norm
            out["invariant"] = val(np.sqrt(inv_acc[:, 0]
                                           / np.maximum(inv_acc[:, 1], 1)))
        return out

    return staged


def _tolist(v) -> List[float]:
    a = np.asarray(v)
    return [float(x) for x in a.reshape(-1)]


def _round(x: float, nd: int = 8) -> float:
    try:
        return round(float(x), nd)
    except (TypeError, ValueError, OverflowError):
        return float(x)


def drift(value: float, baseline: float, scale: Optional[float],
          mode: str) -> float:
    """Relative drift of ``value`` vs ``baseline``.

    ``conserve``: two-sided |v - v0| / denom.  ``decrease``: one-sided —
    only an increase counts.  ``denom = max(|v0|, scale, eps)``.  NaN
    values return inf (non-finite is always maximal drift).
    """
    if not math.isfinite(value):
        return float("inf")
    denom = max(abs(baseline), scale or 0.0, _EPS)
    d = (value - baseline) / denom
    return abs(d) if mode == "conserve" else max(0.0, d)


class HealthMonitor:
    """Chunk-cadence trend detector over the health reduction.

    ``check(step, fields)`` runs the reduction, compares against the
    first check's values, writes one ``health`` event into the trace
    (when given one), stamps the verdict onto the session's root span and
    returns the record.  Divergence rules, in order of hardness:

    1. any NaN/Inf count > 0 in any float field — the hard trigger;
    2. a non-finite invariant value;
    3. invariant drift beyond the op's registered tolerance (per member
       for ensembles: one diverged member diverges the run).

    ``open_system=True`` demotes rule 3 to informational (a coupled
    device group exchanges its invariant quantity through the interface
    bands by construction).  On a mesh that spans processes ``check`` is
    collective and every process gets the same record.
    """

    def __init__(self, stencil: Stencil, trace=None, ensemble: int = 0,
                 spans=None, open_system: bool = False):
        self.stencil = stencil
        self.trace = trace
        self.spans = spans
        self.open_system = bool(open_system)
        self.ensemble = int(ensemble)
        self._fn = make_health_fn(stencil, ensemble=ensemble)
        self.baseline: Optional[Dict[str, Any]] = None
        self.last: Optional[Dict[str, Any]] = None
        self.verdict = VERDICT_HEALTHY
        self.checks = 0

    # -- core -----------------------------------------------------------

    def check(self, step: int, fields,
              chunk: Optional[int] = None) -> Dict[str, Any]:
        vals = self._fn(tuple(fields))
        rec = self._evaluate(step, chunk, vals)
        self.checks += 1
        self.last = rec
        self.verdict = rec["verdict"]
        self._emit(rec)
        return rec

    def check_or_raise(self, step: int, fields,
                       chunk: Optional[int] = None) -> Dict[str, Any]:
        rec = self.check(step, fields, chunk=chunk)
        if rec["verdict"] == VERDICT_DIVERGED:
            raise SimulationDiverged(
                f"simulation DIVERGED at step {step}: {rec['reason']}",
                record=rec)
        return rec

    # -- evaluation -----------------------------------------------------

    def _evaluate(self, step, chunk, vals) -> Dict[str, Any]:
        inv = self.stencil.invariant
        ens = self.ensemble > 0
        reasons: List[str] = []

        field_stats: List[Dict[str, Any]] = []
        nonfinite_total = 0
        for i in range(self.stencil.num_fields):
            entry: Dict[str, Any] = {}
            for stat in ("min", "max", "mean"):
                v = vals[f"field{i}_{stat}"]
                entry[stat] = ([_round(x) for x in _tolist(v)] if ens
                               else _round(v))
            key = f"field{i}_nonfinite"
            if key in vals:
                nf = int(np.sum(np.asarray(vals[key])))
                entry["nonfinite"] = ([int(x) for x in _tolist(vals[key])]
                                      if ens else nf)
                nonfinite_total += nf
                if nf:
                    reasons.append(
                        f"field {i} holds {nf} non-finite value(s) "
                        "(NaN/Inf blow-up or poisoned cell)")
            field_stats.append(entry)

        inv_block: Optional[Dict[str, Any]] = None
        worst_drift: Optional[float] = None
        if inv is not None:
            values = _tolist(vals["invariant"])
            base = (self.baseline or {}).get("_invariant", values)
            drifts = [drift(v, b, inv.scale, inv.mode)
                      for v, b in zip(values, base)]
            worst_drift = max(drifts) if drifts else None
            inv_block = {
                "name": inv.name,
                "mode": inv.mode,
                "rtol": inv.rtol,
                "value": ([_round(v) for v in values] if ens
                          else _round(values[0])),
                "baseline": ([_round(b) for b in base] if ens
                             else _round(base[0])),
                "drift": ([_round(d, 6) for d in drifts] if ens
                          else _round(drifts[0], 6)),
            }
            if self.open_system:
                inv_block["open_system"] = True
            bad = [j for j, v in enumerate(values) if not math.isfinite(v)]
            if bad:
                reasons.append(
                    f"invariant '{inv.name}' non-finite"
                    + (f" for member(s) {bad}" if ens else ""))
            elif inv.rtol is not None and not self.open_system:
                over = [j for j, d in enumerate(drifts) if d > inv.rtol]
                if over:
                    reasons.append(
                        f"invariant '{inv.name}' drifted "
                        f"{max(drifts):.3g}x vs the chunk-0 baseline "
                        f"(tolerance {inv.rtol:g}, mode {inv.mode})"
                        + (f" for member(s) {over}" if ens else ""))

        # informational per-field drift (never a trigger)
        worst_field = None
        if self.baseline is not None:
            base_means = self.baseline["_means"]
            for i in range(self.stencil.num_fields):
                cur = _tolist(vals[f"field{i}_mean"])
                ds = [drift(v, b, None, "conserve")
                      for v, b in zip(cur, base_means[i])]
                d = max(ds) if ds else 0.0
                if worst_field is None or d > worst_field["drift"]:
                    worst_field = {"field": i, "drift": _round(d, 6)}

        verdict = VERDICT_DIVERGED if reasons else VERDICT_HEALTHY
        rec: Dict[str, Any] = {
            "step": int(step),
            "verdict": verdict,
            "reason": "; ".join(reasons) or None,
            "nonfinite_total": nonfinite_total,
            "fields": field_stats,
            "invariant": inv_block,
        }
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if worst_drift is not None:
            rec["worst_drift"] = _round(worst_drift, 6)
        if worst_field is not None:
            rec["worst_field"] = worst_field
        if ens:
            rec["ensemble"] = self._member_spread(vals)

        if self.baseline is None:
            self.baseline = {
                "_invariant": _tolist(vals["invariant"])
                if inv is not None else None,
                "_means": [_tolist(vals[f"field{i}_mean"])
                           for i in range(self.stencil.num_fields)],
                "step": int(step),
            }
            rec["baseline_step"] = int(step)
        return rec

    def _member_spread(self, vals) -> Dict[str, Any]:
        """Cross-member divergence stats for a batched run."""
        out: Dict[str, Any] = {"members": self.ensemble}
        src = vals.get("invariant", vals.get("field0_mean"))
        a = np.asarray(_tolist(src), dtype=np.float64)
        finite = a[np.isfinite(a)]
        if finite.size:
            out["spread"] = _round(float(finite.max() - finite.min()))
            out["std"] = _round(float(finite.std()))
        out["nonfinite_members"] = int(a.size - finite.size)
        return out

    # -- emission -------------------------------------------------------

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self.spans is not None:
            try:
                self.spans.root_attrs["health"] = rec["verdict"]
            except Exception:  # noqa: BLE001 — never load-bearing
                pass
        if self.trace is None:
            return
        try:
            self.trace.event("health", **rec)
        except Exception:  # noqa: BLE001 — observer, never load-bearing
            log.debug("health event write failed", exc_info=True)


# ------------------------------------------------------------ poisoning

def apply_nan_poison(fields):
    """The ``numerics`` fault site's payload: one NaN, deterministically.

    Poisons the CENTER cell (``s // 2`` on every axis of the global
    shape, the member axis included) of the first float field, in place:
    on a sharded field in the block that holds it (the process that holds
    that block writes it).  Returns the fields, which the driver's
    callback-replacement hook carries on.  Raises on an all-integer
    state."""
    for i, f in enumerate(fields):
        if not f.dtype.is_floating_point:
            continue
        gshape = _gshape(f)
        idx = tuple(s // 2 for s in gshape)
        mesh = getattr(f, "mesh", None)
        if mesh is None:
            f[idx] = float("nan")
        else:
            for c, b in zip(mesh.local_coords(), f):
                off = f.offsets(c)
                loc = tuple(x - o for x, o in zip(idx, off))
                if all(0 <= x < n for x, n in zip(loc, b.shape)):
                    b[loc] = float("nan")
        log.warning("[faults] numerics poison: field %d cell %s <- NaN",
                    i, idx)
        return tuple(fields)
    raise ValueError(
        "FAULT_INJECT numerics:nan needs an inexact field to poison; "
        "this stencil's state is all-integer")


# ------------------------------------------------------------ halo audit

_BIT_VIEWS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
              torch.float16: torch.int16, torch.float64: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """Bit-pattern view for exact comparison (NaN payloads included)."""
    return x.view(_BIT_VIEWS[x.dtype]) if x.dtype in _BIT_VIEWS else x


class HaloAuditor:
    """Bit-exact ghost-slab audit across the run's exchange transport.

    Construction enumerates the run's exchange SITES — every
    (halo-bearing field, sharded grid axis) pair.  :meth:`audit`
    (a) re-exchanges each site's border slabs through the configured
    transport (``parallel/halo.exchange_slabs_axis``: the mesh's own
    transport, or a ring-kernel :class:`~..parallel.halo.RdmaTransport`
    for ``exchange="rdma"``), and (b) compares them bit for bit against
    the neighbour's border rows, read straight from the neighbour's block
    (one process) or from one ``all_gather`` of every shard's border rows
    (a mesh that spans processes), with the guard constant at a
    non-periodic wall.  A mismatch implicates the transport, localised to
    the exact (field, axis, direction, ring-shard); the counts of a mesh
    that spans processes are summed over the processes, so every process
    reports the same record.

    ``_corrupt`` is the deterministic test seam: a hook applied to a copy
    of each received slab (``_corrupt(field, axis, direction, slab,
    shard) -> slab``, ``shard`` the block's position along the ring: the
    counterpart of the reference's ``axis_index``).
    """

    DIRECTIONS = ("left", "right")

    def __init__(self, stencil: Stencil, mesh, global_shape: Sequence[int],
                 *, exchange: str = "ppermute", periodic: bool = False,
                 trace=None, _corrupt: Optional[Callable] = None):
        from ..parallel import halo

        self.stencil = stencil
        self.mesh = mesh
        self.global_shape = tuple(int(g) for g in global_shape)
        self.periodic = bool(periodic)
        self.trace = trace
        self._corrupt = _corrupt
        ndim = stencil.ndim
        self._counts = list(mesh.counts(ndim))
        self.sites: List[Tuple[int, int, int]] = []  # (field, axis, halo)
        for i, fh in enumerate(stencil.field_halos):
            if fh == 0:
                continue
            for d in range(ndim):
                if self._counts[d] > 1:
                    self.sites.append((i, d, int(fh)))
        if not self.sites:
            raise ValueError(
                "halo audit: no sharded exchange sites (needs a "
                "spatially sharded mesh axis and a halo-bearing field)")
        self.transport = None
        self.backend = "ppermute"
        if exchange == "rdma":
            if ndim != 3:
                raise ValueError("halo audit with exchange='rdma' is "
                                 "3D-only (the ring carries rank-3 slabs)")
            self.transport = halo.RdmaTransport(mesh)
            self.backend = self.transport.backend

    def _expected(self, f, d: int, fh: int, bc, lead: int):
        """What each local block's received (left, right) slabs MUST
        equal: the neighbour's last (first) ``fh`` rows along ``d``, the
        guard constant at a non-periodic wall."""
        mesh = self.mesh
        a = d + lead
        blocks = list(f)
        L = blocks[0].shape[a]
        lo = [b.narrow(a, 0, fh) for b in blocks]
        hi = [b.narrow(a, L - fh, fh) for b in blocks]
        if mesh.multiprocess:
            glo = _allgather(mesh, torch.stack(lo))
            ghi = _allgather(mesh, torch.stack(hi))
            src_lo = lambda g: glo[g]  # noqa: E731
            src_hi = lambda g: ghi[g]  # noqa: E731
        else:
            src_lo = lambda g: lo[mesh.local_index(  # noqa: E731
                list(mesh.coords())[g])]
            src_hi = lambda g: hi[mesh.local_index(  # noqa: E731
                list(mesh.coords())[g])]
        cnt = self._counts[d]
        ga = d + mesh.group_axes
        out = []
        for c, b in zip(mesh.local_coords(), blocks):
            r = c[ga]
            left_c, right_c = list(c), list(c)
            left_c[ga] = (r - 1) % cnt
            right_c[ga] = (r + 1) % cnt
            if r == 0 and not self.periodic:
                left = torch.full(lo[0].shape, bc, dtype=b.dtype,
                                  device=b.device)
            else:
                left = src_hi(mesh.index(left_c))
            if r == cnt - 1 and not self.periodic:
                right = torch.full(lo[0].shape, bc, dtype=b.dtype,
                                   device=b.device)
            else:
                right = src_lo(mesh.index(right_c))
            out.append((r, left, right))
        return out

    def audit(self, fields, step: int,
              chunk: Optional[int] = None) -> Dict[str, Any]:
        """Run one audit pass; returns (and logs) the site table.
        Collective on a mesh that spans processes."""
        from ..parallel import halo

        mesh = self.mesh
        counts = []
        for (i, d, fh) in self.sites:
            f = fields[i]
            lead = getattr(f, "lead", 0)
            bc = self.stencil.bc_value[i]
            lefts, rights = halo.exchange_slabs_axis(
                list(f), mesh, d, fh, bc, self.periodic,
                transport=self.transport, lead=lead)
            cnt = self._counts[d]
            bad = {w: [torch.zeros((), dtype=torch.float64,
                                   device=f[0].device)
                       for _ in range(cnt)] for w in self.DIRECTIONS}
            for j, (r, e_left, e_right) in enumerate(
                    self._expected(f, d, fh, bc, lead)):
                for w, got, want in (("left", lefts[j], e_left),
                                     ("right", rights[j], e_right)):
                    if self._corrupt is not None:
                        got = self._corrupt(i, d, w, got.clone(), r)
                    n = (_bits(got) != _bits(want)).sum()
                    bad[w][r] = bad[w][r] + n.to(torch.float64)
            for w in self.DIRECTIONS:
                counts.append(torch.stack(bad[w]))
        vec = torch.cat([t.to(counts[0].device) for t in counts])
        if mesh.multiprocess:
            vec = _allgather(mesh, vec[None]).sum(0)
        vals = [int(x) for x in vec.cpu().tolist()]
        site_rows: List[Dict[str, Any]] = []
        mismatches = 0
        pos = 0
        for (i, d, fh) in self.sites:
            cnt = self._counts[d]
            for direction in self.DIRECTIONS:
                per = vals[pos:pos + cnt]
                pos += cnt
                total = sum(per)
                row = {"field": i, "axis": d, "direction": direction,
                       "halo": fh, "mismatch_count": total}
                if total:
                    row["mismatch_shards"] = [
                        j for j, c in enumerate(per) if c]
                    mismatches += total
                site_rows.append(row)
        rec: Dict[str, Any] = {
            "step": int(step),
            "ok": mismatches == 0,
            "backend": self.backend,
            "sites_checked": len(site_rows),
            "mismatch_total": mismatches,
            "sites": site_rows,
        }
        if chunk is not None:
            rec["chunk"] = int(chunk)
        if self.trace is not None:
            try:
                self.trace.event("halo_audit", **rec)
            except Exception:  # noqa: BLE001 — never load-bearing
                pass
        return rec

    def audit_or_raise(self, fields, step: int,
                       chunk: Optional[int] = None) -> Dict[str, Any]:
        rec = self.audit(fields, step, chunk=chunk)
        if not rec["ok"]:
            where = ", ".join(
                f"field {s['field']} axis {s['axis']} {s['direction']} "
                f"shard(s) {s.get('mismatch_shards')}"
                for s in rec["sites"] if s.get("mismatch_count"))
            raise SimulationDiverged(
                f"halo audit FAILED at step {step}: received ghost "
                f"slabs differ bitwise from neighbor interiors at "
                f"{where} (transport {self.backend})", record=rec)
        return rec
