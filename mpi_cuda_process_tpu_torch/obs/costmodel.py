"""Static per-step cost counters: flops, HBM bytes, exchange rounds and bytes,
and a roofline priced for the card.

The port's counterpart of the TPU package's ``obs/costmodel.py``: the same
functions, arguments and output keys, so a ``costmodel`` event reads the
same in both packages' logs and the count keys are held equal to that
package's by ``tests/test_torch_costmodel.py``.  Every telemetry run carries
the prediction beside its measurement (``cli._emit_static_cost``), and the
console turns the pair into ``obs_roofline_gap_ratio`` (``obs/metrics.py``).

Two kinds of counter, as in the TPU package:

* **counted off the program**: :func:`step_flops` runs the port's plain
  step (``driver.make_step``) once on ``meta`` tensors under a
  ``TorchDispatchMode`` (no device work) and counts the TPU package's
  primitive set, mapped onto aten ops (:data:`_FLOP_OPS`).  Where the TPU
  package counts exchange equations off a traced jaxpr, the port records
  them: one pass of a built step under ``utils/launchcheck.py``'s recorder
  gives its shifts, bytes and ring launches (the tests on the CPU,
  ``chip_smoke.py`` on the card).
* **analytic**: :func:`comm_stats` and :func:`hbm_bytes_per_step`, closed
  forms for any mesh, cross-checked against the recorded counts and against
  ``utils/budget.py``'s slab accounting (:func:`budget_crosscheck`).

**Pricing.**  The TPU package prices a v5e (819 GB/s HBM, 45 GB/s a link)
and gives every shard a chip.  The port prices the card in
:data:`CARD_RATES`, keyed by ``torch.cuda.get_device_name``, and a card
may hold several shards (``--mesh`` shards of one process share its card,
and gloo-host processes share one): the roofline is priced **per card**,
the bytes of every shard the card holds, while the count keys stay per
shard (``*_per_device``), as the TPU package defines them.  An exchange
is priced on the link its transport uses (:data:`LINKS`): within one card
as HBM copies (each byte read and written), through host memory over PCIe
for gloo-host (down and back up), over NVLink for NCCL and for cards of one
process.  ``roofline.basis`` names the card, the shards per card and the
link.  Nothing here executes device work.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.stencil import dtype_name, k_step_margin

# Per-card peaks from NVIDIA's data sheets (H100 Tensor Core GPU data
# sheet; H200 data sheet), dense, at the part's full power limit:
# ``hbm`` HBM bytes/s, ``f32`` float32 flop/s outside the tensor cores,
# ``nvlink`` NVLink bytes/s in one direction (half the quoted
# bidirectional total), ``pcie`` PCIe Gen5 x16 bytes/s in one direction.
# Matched by substring of the card's name, first match wins; the last
# entry (H100 SXM) prices a name that matches none, and a CPU run.
CARD_RATES: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("H200", {"card": "H200 SXM", "hbm": 4.8e12, "f32": 67e12,
              "nvlink": 450e9, "pcie": 64e9}),
    ("H100 NVL", {"card": "H100 NVL", "hbm": 3.9e12, "f32": 60e12,
                  "nvlink": 300e9, "pcie": 64e9}),
    ("PCIe", {"card": "H100 PCIe", "hbm": 2.0e12, "f32": 51e12,
              "nvlink": 300e9, "pcie": 64e9}),
    ("H100", {"card": "H100 SXM", "hbm": 3.35e12, "f32": 67e12,
              "nvlink": 450e9, "pcie": 64e9}),
)
RATES_SOURCE = ("NVIDIA H100 / H200 Tensor Core GPU data sheets: peak HBM "
                "bandwidth, float32 (non-tensor) flop/s, NVLink and PCIe "
                "Gen5 x16 per direction")

# The link an exchange crosses, by transport: (rate key, crossings of each
# exchanged byte).  In-card copies read and write every byte; gloo-host
# stages each slab down to host memory and back up.
LINKS: Dict[str, Tuple[str, int]] = {
    "hbm": ("hbm", 2),
    "nvlink": ("nvlink", 1),
    "pcie": ("pcie", 2),
}


def card_rates(name: Optional[str] = None) -> Dict[str, Any]:
    """The :data:`CARD_RATES` entry for a card named ``name`` (an
    ``nvidia-smi`` line or ``torch.cuda.get_device_name``; None: the
    H100 SXM)."""
    name = name or ""
    for key, rates in CARD_RATES:
        if key in name:
            return dict(rates)
    return dict(CARD_RATES[-1][1])


def link_of(backend: Optional[str], cards: int = 1) -> str:
    """The :data:`LINKS` key of an exchange: ``backend`` is the mesh's
    multi-process backend (None for one process), ``cards`` the distinct
    cards the process's shards (or the peer ring's processes) span."""
    if backend in ("gloo-host", "gloo"):
        return "pcie"
    if backend == "nccl" or cards > 1:
        return "nvlink"
    return "hbm"


# Elementwise ops counted at their output's element count: the TPU
# package's ``_FLOP_PRIMS`` (add, add_any, sub, mul, div, rem, pow,
# integer_pow, max, min, neg, abs, exp, log, tanh, sqrt, rsqrt, sign,
# floor, ceil, round, erf, logistic, sin, cos) mapped onto the aten ops
# the port's plain step dispatches; in-place forms count as their op.
# Comparisons, selects, copies, pads and layout ops are free, as there.
_FLOP_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "pow",
    "maximum", "minimum", "neg", "abs", "exp", "log", "tanh", "sqrt",
    "rsqrt", "sign", "floor", "ceil", "round", "erf", "sigmoid", "sin",
    "cos",
})


def _op_flops(func, args, kwargs, out) -> int:
    """Flops of one dispatched aten op: its output's elements times the
    primitives it stands for (``add``/``sub`` with ``alpha`` != 1 are a mul
    and an add; ``clamp`` is a max and a min where both bounds are
    given)."""
    name = func._overloadpacket.__name__.rstrip("_")
    if not isinstance(out, torch.Tensor):
        return 0
    n = out.numel()
    if name in ("add", "sub", "rsub"):
        alpha = kwargs.get("alpha", 1) if kwargs else 1
        return n * (1 if alpha == 1 else 2)
    if name == "clamp":
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        return n * ((lo is not None) + (hi is not None))
    return n if name in _FLOP_OPS else 0


class _FlopCounter(TorchDispatchMode):
    """Sums :func:`_op_flops` over every aten op dispatched inside."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.flops += _op_flops(func, args, kwargs or {}, out)
        return out


def _mask_flops(stencil, cells: int, periodic: bool) -> int:
    """The coordinate masks of one step as the TPU package's counter prices
    them.  Its plain step traces them on every pass as whole-block integer
    arithmetic: the guard frame's ``iota + offset`` on each axis (``ndim``
    adds a cell, on every pass that re-pins a field), and the red-black
    colour's ``sum(iota) % 2`` of a parity-sensitive stencil (``ndim - 1``
    adds, then ``jnp.remainder``'s rem and its sign-fix add: ``ndim + 1`` a
    cell and pass).  The port builds both once per block shape from per-axis
    vectors and caches them, so :func:`step_flops` counts its own step
    with the caches warm and adds them at the TPU package's price, keeping
    one pinned number for both packages."""
    nd = stencil.ndim
    passes = len(stencil.phases) if stencil.phases else 1
    repins = not periodic and any(
        m and c is None
        for m, c in zip(stencil.mask_fields, stencil.carry_map))
    per_pass = (nd if repins else 0) + \
        (nd + 1 if stencil.parity_sensitive else 0)
    return passes * per_pass * cells


def step_flops(stencil, shape: Sequence[int], periodic: bool = False) -> int:
    """Flops of ONE plain step on a block of ``shape``, counted with no
    device work: the counter of record for every execution strategy (the
    kernels compute the same update, plus margin redundancy the model
    ignores), so one number compares across paths."""
    from ..driver import make_step

    shape = tuple(int(s) for s in shape)
    step = make_step(stencil, shape, periodic=periodic)
    fields = tuple(torch.empty(shape, dtype=stencil.dtype, device="meta")
                   for _ in range(stencil.num_fields))
    step(fields)  # builds the cached masks, priced by _mask_flops
    counter = _FlopCounter()
    with counter:
        step(fields)
    return counter.flops + _mask_flops(stencil, math.prod(shape), periodic)


def _local_shape(grid: Sequence[int],
                 mesh: Sequence[int]) -> Tuple[int, ...]:
    counts = tuple(mesh) + (1,) * (len(grid) - len(mesh)) if mesh else \
        (1,) * len(grid)
    return tuple(int(g) // int(c) for g, c in zip(grid, counts))


def hbm_bytes_per_step(stencil, local_shape: Sequence[int],
                       fuse: int = 0, batch: int = 1) -> int:
    """Minimum per-shard HBM traffic per real step: one read and one write
    of every field, over the temporal-blocking depth."""
    cells = max(1, int(batch)) * math.prod(int(s) for s in local_shape)
    item = stencil.dtype.itemsize
    return (2 * stencil.num_fields * cells * item) // max(1, int(fuse))


def _rdma_sites(stencil, local: Sequence[int], m: int,
                counts: Sequence[int], nslots: int = 0,
                prefer_nc: int = 0) -> List[Dict[str, Any]]:
    """The per-field ring-exchange sites of one slab-kind pass under
    ``exchange="rdma"``, with their chunk geometry from the same
    ``remote.pick_chunks`` the ring kernel's builder uses: one call per
    z-slab pair, one per y-slab pair, two per corner set."""
    from ..ops.cuda.remote import ring_exchange_stats

    lz, ly, lx = local
    kw = {"nslots": nslots or None, "prefer_nc": prefer_nc}
    sites = []
    if counts[0] > 1:
        sites.append(ring_exchange_stats((m, ly, lx), stencil.dtype, **kw))
    if counts[1] > 1:
        sites.append(ring_exchange_stats((lz, m, lx), stencil.dtype, **kw))
        corner = ring_exchange_stats((m, m, lx), stencil.dtype, **kw)
        sites += [corner, dict(corner)]
    return sites


def comm_stats(
    stencil,
    grid: Sequence[int],
    mesh: Sequence[int] = (),
    fuse: int = 0,
    fuse_kind: str = "auto",
    periodic: bool = False,
    exchange: str = "ppermute",
    batch: int = 1,
    variant=None,
) -> Optional[Dict[str, Any]]:
    """Analytic exchange rounds and bytes per shard and pass, or None
    (unsharded): the TPU package's model, key for key.

    * slab-operand kinds (``padfree``/``stream``, 3D): width-``m`` face
      slabs per field: z-only meshes 2 rounds a field of ``(m, ly, lx)``;
      meshes that shard y add 2 y-rounds of ``(lz, m, lx)`` and 4 two-pass
      corner rounds of ``(m, m, lx)``.  ``slab_operand_bytes`` prices the
      operand storage as ``utils/budget.py``'s slab part does.
    * padded kind and plain step: the two-pass exchange-and-pad, axis d's
      slabs spanning the axes before it already padded; the plain step
      exchanges the fields with a nonzero halo at their own width, the
      fused kinds every field at width ``m``.

    A round is one ``ppermute`` of the TPU package: one in-process or
    distributed shift of the port moves two (a slab pair).  ``batch=N``
    leaves the round count alone and scales every byte by N.
    ``exchange="rdma"`` (stream kind): no ppermute rounds;
    ``rdma_exchange_calls_per_pass`` ring launches (one per site and
    field) and ``rdma_dma_per_pass`` chunk transfers from the ring's chunk
    table; the same ICI bytes; ``slab_operand_bytes`` None.
    """
    ndim = stencil.ndim
    counts = (tuple(int(c) for c in mesh) + (1,) * ndim)[:ndim]
    if math.prod(counts) <= 1:
        return None
    local = _local_shape(grid, mesh)
    item = stencil.dtype.itemsize
    nf = stencil.num_fields
    batch = max(1, int(batch))

    if fuse:
        m = k_step_margin(stencil, int(fuse))
        widths = (m,) * nf
        per_pass_steps = int(fuse)
    else:
        widths = tuple(stencil.field_halos)
        per_pass_steps = 1

    kind = fuse_kind if (fuse and ndim == 3
                         and fuse_kind in ("padfree", "stream")) \
        else ("padded" if fuse else "plain")

    rdma = exchange == "rdma" and kind == "stream"
    rounds = 0
    ici = 0
    operand: Optional[int] = None
    rdma_sites: Optional[List[Dict[str, Any]]] = None
    if kind in ("padfree", "stream"):
        lz, ly, lx = local
        m = widths[0]
        two_axis = counts[1] > 1
        z_bytes = m * ly * lx * item
        if rdma:
            family = getattr(variant, "family", "") == "rdma"
            rdma_sites = _rdma_sites(
                stencil, local, m, counts,
                nslots=int(getattr(variant, "nslots", 0) or 0)
                if family else 0,
                prefer_nc=int(getattr(variant, "prefer_nc", 0) or 0)
                if family else 0)
        if counts[0] > 1:
            rounds += nf * 2
            ici += nf * 2 * z_bytes
        if two_axis:
            y_bytes = lz * m * lx * item
            c_bytes = m * m * lx * item
            rounds += nf * (2 + 4)
            ici += nf * (2 * y_bytes + 4 * c_bytes)
            from ..ops.cuda.fused import _sublane

            if kind == "stream":
                m_a = -(-m // _sublane(item)) * _sublane(item)
                dup = m + m_a
            else:
                dup = 2 * m
            operand = nf * item * (2 * m * ly * lx
                                   + 2 * dup * lz * lx
                                   + 4 * m * dup * lx)
        else:
            operand = nf * 2 * z_bytes
    else:
        for i in range(nf):
            w = widths[i]
            if not w:
                continue
            for d in range(ndim):
                if counts[d] <= 1:
                    continue
                slab_cells = w
                for j in range(ndim):
                    if j == d:
                        continue
                    slab_cells *= local[j] + (2 * w if j < d else 0)
                rounds += 2
                ici += 2 * slab_cells * item

    out: Dict[str, Any] = {
        "kind": kind,
        "exchange": "rdma" if rdma else "ppermute",
        "per_pass_steps": per_pass_steps,
        "width_m": max(widths),
        "sharded_counts": list(counts),
        "members_per_device": batch,
        "ppermute_rounds_per_pass": 0 if rdma else rounds,
        "ici_bytes_per_pass": batch * ici,
        "ici_bytes_per_step": batch * ici / per_pass_steps,
        "slab_operand_bytes": None if rdma else (
            None if operand is None else batch * operand),
    }
    if rdma:
        out["rdma_exchange_calls_per_pass"] = nf * len(rdma_sites)
        out["rdma_dma_per_pass"] = nf * sum(
            s["remote_dma_per_call"] for s in rdma_sites)
        out["rdma_chunks"] = rdma_sites
    return out


def rdma_crosscheck(
    stencil,
    grid: Sequence[int],
    mesh: Sequence[int],
    fuse: int,
    periodic: bool = False,
    variant=None,
) -> Optional[Dict[str, Any]]:
    """The analytic chunk model against the ring kernel as it is built on
    the card: every site's ring-exchange call built for the card
    (``remote.build_ring_exchange_call``: the chunk table its launches
    run), its chunk transfers summed.  None without a card, as the TPU
    package gives None where the box cannot host the mesh; the recorded
    ring launches of a pass are checked against ``comm_stats`` by the
    tests on the CPU and by ``chip_smoke.py`` on the card."""
    cs = comm_stats(stencil, grid, mesh, fuse=fuse, fuse_kind="stream",
                    periodic=periodic, exchange="rdma", variant=variant)
    if cs is None or "rdma_dma_per_pass" not in cs or \
            not torch.cuda.is_available():
        return None
    from ..ops.cuda.remote import build_ring_exchange_call

    built = 0
    dev = torch.device("cuda", torch.cuda.current_device())
    for site in cs["rdma_chunks"]:
        _, meta = build_ring_exchange_call(
            site["shape"], stencil.dtype, nslots=site["nslots"],
            device=dev)
        built += meta["remote_dma_per_call"]
    built *= stencil.num_fields
    return {"analytic_remote_dma": cs["rdma_dma_per_pass"],
            "built_remote_dma": built,
            "match": built == cs["rdma_dma_per_pass"]}


def budget_crosscheck(
    stencil,
    grid: Sequence[int],
    mesh: Sequence[int],
    fuse: int,
    fuse_kind: str,
    periodic: bool = False,
    ensemble: int = 0,
    ensemble_mesh: int = 0,
) -> Optional[Dict[str, Any]]:
    """This module's slab operands against ``utils/budget.py``'s slab part:
    ``{"slab_operand_bytes", "port_operand_bytes", "budget_bytes",
    "match"}``, or None where the budget has no slab part to compare.

    ``slab_operand_bytes`` is :func:`comm_stats`'s (the TPU package's
    operand layout); ``port_operand_bytes`` the same set as the port's
    kernels read it: on a mesh that shards y, without the TPU package's
    widening of the y-facing operands (the 2m-duplicated pad-free y slabs
    and corners, the sublane-aligned streaming ones), which the port's
    budget drops too.  ``match`` holds the port's operand bytes equal to
    the budget's, so the exchange model and the memory guard cannot drift
    apart."""
    members = (max(1, int(ensemble)) // max(1, int(ensemble_mesh))
               if ensemble else 1)
    cs = comm_stats(stencil, grid, mesh, fuse=fuse, fuse_kind=fuse_kind,
                    periodic=periodic, batch=members)
    if cs is None or cs.get("slab_operand_bytes") is None:
        return None
    from ..utils import budget

    _, parts = budget.estimate_run_bytes(
        stencil, grid, mesh=mesh, fuse=fuse, fuse_kind=fuse_kind,
        periodic=periodic, ensemble=ensemble, ensemble_mesh=ensemble_mesh)
    slab = [b for label, b in parts
            if "operands only" in label and b > 0]
    if not slab:
        return None
    port = cs["slab_operand_bytes"]
    if cs["sharded_counts"][1] > 1:
        m = cs["width_m"]
        lz, ly, lx = _local_shape(grid, mesh)
        port = members * stencil.num_fields * stencil.dtype.itemsize * (
            2 * m * ly * lx + 2 * m * lz * lx + 4 * m * m * lx)
    return {
        "slab_operand_bytes": cs["slab_operand_bytes"],
        "port_operand_bytes": port,
        "budget_bytes": slab[0],
        "match": port == slab[0],
    }


def _roofline(rates, hbm_b: int, ici_per_step: float, shards: int,
              link: str, cells: int) -> Dict[str, Any]:
    """The per-card roofline: ``shards`` shards' HBM bytes at the card's
    HBM rate, their exchange bytes on ``link``."""
    rate_key, crossings = LINKS[link]
    t_hbm_ms = shards * hbm_b / rates["hbm"] * 1e3
    t_ex_ms = shards * ici_per_step * crossings / rates[rate_key] * 1e3

    def mcells(t_ms: float) -> float:
        return cells / (t_ms * 1e-3) / 1e6 if t_ms > 0 else float("inf")

    return {
        "hbm_gbs": rates["hbm"] / 1e9,
        "ici_gbs": rates[rate_key] / 1e9,
        "predicted_ms_per_step_hbm": round(t_hbm_ms, 6),
        "predicted_ms_per_step_exchange": round(t_ex_ms, 6),
        "predicted_mcells_per_s_overlapped": round(mcells(t_hbm_ms), 1),
        "predicted_mcells_per_s_serial": round(mcells(t_hbm_ms + t_ex_ms),
                                               1),
        "basis": {
            "card": rates["card"],
            "shards_per_card": int(shards),
            "link": link,
            "link_crossings": crossings,
            "rates": RATES_SOURCE,
            "note": "minimum HBM traffic of every shard the card holds at "
                    "peak bandwidth; 'overlapped' assumes the exchange "
                    "fully hidden, 'serial' adds it to the critical path",
        },
    }


def static_cost(
    stencil,
    grid: Sequence[int],
    mesh: Sequence[int] = (),
    fuse: int = 0,
    fuse_kind: str = "auto",
    periodic: bool = False,
    ensemble: int = 0,
    exchange: str = "ppermute",
    ensemble_mesh: int = 0,
    variant=None,
    card: Optional[str] = None,
    shards_per_card: Optional[int] = None,
    link: str = "hbm",
) -> Dict[str, Any]:
    """The ``costmodel`` event's block: the TPU package's counters and its
    roofline keys, priced for ``card`` (a name for :func:`card_rates`).

    ``shards_per_card`` (default: every shard of the mesh on one card, the
    one-process run) and ``link`` (:func:`link_of`) price the roofline per
    card; the count keys stay per shard."""
    grid = tuple(int(g) for g in grid)
    local = _local_shape(grid, mesh)
    total_members = max(1, int(ensemble))
    members = (total_members // max(1, int(ensemble_mesh))
               if ensemble else 1)
    comm = comm_stats(stencil, grid, mesh, fuse=fuse, fuse_kind=fuse_kind,
                      periodic=periodic, exchange=exchange, batch=members,
                      variant=variant)
    flops = members * step_flops(stencil, local, periodic=periodic)
    hbm_b = hbm_bytes_per_step(stencil, local, fuse=fuse, batch=members)
    if shards_per_card is None:
        shards_per_card = max(1, int(ensemble_mesh)) * (
            math.prod(int(c) for c in mesh) if mesh else 1)
    out: Dict[str, Any] = {
        "grid": list(grid),
        "mesh": list(mesh),
        "local_shape": list(local),
        "batch": total_members,
        "ensemble": int(ensemble),
        "ensemble_mesh": int(ensemble_mesh),
        "members_per_device": members,
        "fuse": int(fuse),
        "fuse_kind": comm["kind"] if comm else (fuse_kind if fuse else None),
        "dtype": dtype_name(stencil.dtype),
        "flops_per_step_per_device": int(flops),
        "hbm_bytes_per_step_per_device": int(hbm_b),
        "comm": comm,
        "roofline": _roofline(
            card_rates(card), hbm_b,
            comm["ici_bytes_per_step"] if comm else 0.0,
            shards_per_card, link, total_members * math.prod(grid)),
    }
    if comm and comm.get("slab_operand_bytes") is not None:
        try:
            out["budget_crosscheck"] = budget_crosscheck(
                stencil, grid, mesh, fuse, fuse_kind, periodic=periodic,
                ensemble=ensemble, ensemble_mesh=ensemble_mesh)
        except Exception:  # noqa: BLE001 — never block a manifest write
            out["budget_crosscheck"] = None
    if comm and comm.get("exchange") == "rdma":
        try:
            out["rdma_crosscheck"] = rdma_crosscheck(
                stencil, grid, mesh, fuse, periodic=periodic,
                variant=variant)
        except Exception:  # noqa: BLE001 — never block a manifest write
            out["rdma_crosscheck"] = None
    return out


def coupled_cost(plans, card: Optional[str] = None, transport: str = "",
                 link: str = "hbm") -> Dict[str, Any]:
    """The coupled (``--groups``) run's block: per-group
    :func:`static_cost` (each group's step is the monolithic stepper on
    its own sub-mesh, its clause modes in ``fuse``/``fuse_kind``) and the
    interface sub-block.  ``transport`` prices the two band paths apart:
    ``device_put`` moves the receiver's resampled band (the sum of recv
    parts), ``collective`` the sender's raw rows (the sum of send parts);
    ``bytes_per_round`` equals the sum of ``utils/budget.py``'s matching
    interface parts.  The round's band bytes are priced on ``link`` (the
    groups of one process on one card: HBM copies)."""
    from ..parallel import groups as groups_lib

    transport = transport or groups_lib.TRANSPORT_BACKEND
    rates = card_rates(card)
    group_costs = []
    for p in plans:
        s = p.spec
        c = static_cost(p.stencil, p.grid, mesh=p.mesh_shape,
                        fuse=s.fuse_k if s.fuse_k > 1 else 0,
                        fuse_kind=s.kind or "auto", card=card, link=link)
        c["group"] = p.name
        c["ratio"] = p.ratio
        c["devices"] = [p.spec.dev_lo, p.spec.dev_hi]
        c["cells_per_round"] = p.cells
        c["owned_cells"] = p.owned_cells
        c["modes"] = list(s.modes)
        group_costs.append(c)
    traffic = groups_lib.interface_traffic(plans)
    recv_bytes = sum(t[d]["recv_bytes"] for t in traffic
                     for d in ("up", "down"))
    send_bytes = sum(t[d]["send_bytes"] for t in traffic
                     for d in ("up", "down"))
    wire_bytes = send_bytes if transport == "collective" else recv_bytes
    rate_key, crossings = LINKS[link]
    return {
        "coupled": True,
        "n_groups": len(plans),
        "cell_updates_per_round": int(sum(p.cells for p in plans)),
        "groups": group_costs,
        "interface": {
            "n_interfaces": len(traffic),
            "rounds_per_step": 1,
            "transport": transport,
            "bytes_per_round": int(wire_bytes),
            "staged_bytes_per_round": int(send_bytes),
            "predicted_ms_per_round": round(
                wire_bytes * crossings / rates[rate_key] * 1e3, 6),
            "link": link,
            "interfaces": traffic,
        },
    }
