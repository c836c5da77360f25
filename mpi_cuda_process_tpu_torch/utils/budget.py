"""Per-device memory budget: refuse with the arithmetic, before allocating.

The port's copy of the TPU package's ``utils/budget.py``: the same model of
the dominant device buffers of a run (state, the step's output, pad and
exchange transients, slab operands) plus a fractional overhead, for the
paths the port runs, priced in the stencil's dtype.  ``--mem-check``
(``cli.build``) calls :func:`check_budget` before any field is allocated, so
a config that cannot fit fails at once with the numbers in hand, not with an
out-of-memory error in the middle of a step.

Where the port's buffers differ from the TPU package's, the estimate follows
the port and says so in its labels:

* dropped, TPU-only terms: the sublane-aligned (``wm_a``) copies of the
  y-facing operands of the 2-axis streaming call and the 2m-duplicated y
  slabs and corners of the 2-axis pad-free call (the port's kernels read
  m-wide pieces); the padded transient of the unsharded fused kind and of
  the unsharded 2D k-step kernel (the port's K3 and K8 read the raw grid);
  the VMEM strip probes that label a shape ``UNBUILDABLE`` (replaced by the
  port's own gates: ``streamfused.fits``, ``fused.margin_of`` and the
  builders' shape rules); and ``ring_vmem_bytes`` (the TPU ring's VMEM
  staging: within one process the port's ring lands every chunk in place
  and stages nothing; across processes its receive slots are priced
  below);
* added, port-only terms: the k-step kernels write every field anew (wave's
  new ``u_prev`` is level k-1's u; the TPU model counts one output field),
  Gray-Scott's steps write both fields, the one-step path (plain or a
  compute_fn kernel, guard-frame) keeps the update's output beside its
  re-pinned copy (``torch.where`` writes it anew; XLA fuses the two) and
  a bool frame mask of the block, one byte a cell, for the run (with the
  padded blocks, all alive at once: heat3d 1024^3 ``--mesh 2,2 --compute
  pallas`` peaked at 9.02 GiB in bfloat16 on an H100, 6.62 GiB without
  these terms, 9.93 GiB with them), the ring exchange keeps its
  received slabs in device memory (the TPU package deletes them from its
  model: its kernel stages chunks in VMEM), across processes the peer
  ring's receive slots (``nslots`` x 2 directions x the slab a site, the z,
  y and corner sites of the stream kind, plus a ready flag and a credit a
  block of every chunk: ``remote.peer_site_bytes``, a region of its own
  outside PyTorch's allocator), and several shards that share
  one card are counted together (:func:`shards_on_card`: virtual devices,
  and the processes of a multi-process run whose card is this process's).

``pipeline=True`` adds the carried slab set (the TPU package's
``budget.py:145-155``): while a pass runs, its own slabs and the next
pass's, in flight, are alive together.  The TPU package deletes the term
under rdma (its carry feeds VMEM rings); the port keeps it, since its ring
lands the slabs in device buffers that the carry holds.  With ``overlap``
the carry is the 2-axis slab set the shells read (z and y slabs and
corners, a local fill on an unsharded axis) plus the shell outputs it
holds until the next pass joins the side streams.

A sharded checkpoint (``--checkpoint-backend orbax``) costs no device
memory: its writer copies one block at a time to the host
(:func:`checkpoint_host_bytes`).

A coupled ``--groups`` run (:func:`estimate_coupled_bytes`) prices each
group as its own run plus the interface transients of its transport, the
TPU package's arithmetic; where groups share a card (virtual devices) the
card holds all of them at once, so the guard sums every group with shards
on the card, each priced for the shards it has there, as
:func:`shards_on_card` does for one mesh.
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.stencil import Stencil, k_step_margin

# Fractional slack for the caching allocator's rounding, plain-path
# temporaries and kernel scratch.
_OVERHEAD_FRAC = 0.10

Parts = List[Tuple[str, int]]


def device_hbm_bytes(device=None) -> int:
    """Device memory of a CUDA card (``total_memory``; the current card
    when ``device`` is None)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    return int(torch.cuda.get_device_properties(dev).total_memory)


def shards_on_card(mesh) -> int:
    """The shards whose blocks share this process's card: the most any of
    its devices holds, times the processes of a multi-process run that
    share its card (``LOCAL_RANK % device_count`` alike), each with as
    many shards as this one."""
    from ..parallel.mesh import ranks_on_device

    if mesh is None:
        return 1
    mine = max(sum(1 for d in mesh.devices if d == u)
               for u in mesh.unique_devices())
    return mine * (ranks_on_device() if mesh.multiprocess else 1)


def _local_shape(grid: Sequence[int], mesh: Sequence[int]) -> Tuple[int, ...]:
    counts = tuple(mesh) + (1,) * (len(grid) - len(mesh)) if mesh else \
        (1,) * len(grid)
    return tuple(int(g) // int(c) for g, c in zip(grid, counts))


def _written_fields(stencil: Stencil, kstep: bool) -> int:
    """Fields a step writes anew: every field for a k-step kernel, the
    fields not carried verbatim (``carry_map``) for one step."""
    if kstep:
        return stencil.num_fields
    return sum(1 for j in stencil.carry_map if j is None)


def _stream_ok(stencil, local, grid, fuse, periodic, sharded, z_only):
    from ..ops.cuda import streamfused

    if sharded:
        build = (streamfused.build_stream_sharded_call if z_only
                 else streamfused.build_stream_2axis_call)
        return build(stencil, local, grid, fuse, periodic=periodic) \
            is not None
    return not periodic and streamfused.make_stream_fused_step(
        stencil, grid, fuse) is not None


def _padfree_ok(stencil, local, grid, fuse, periodic, z_only) -> bool:
    from ..ops.cuda import fused

    build = (fused.build_zslab_padfree_call if z_only
             else fused.build_yzslab_padfree_call)
    return build(stencil, local, grid, fuse, periodic=periodic) is not None


def estimate_run_bytes(
    stencil: Stencil,
    grid: Sequence[int],
    mesh: Sequence[int] = (),
    fuse: int = 0,
    ensemble: int = 0,
    periodic: bool = False,
    compute: str = "auto",
    fuse_kind: str = "auto",
    overlap: bool = False,
    pipeline: bool = False,
    exchange: str = "ppermute",
    ensemble_mesh: int = 0,
    shards_per_device: int = 1,
    processes: int = 1,
) -> Tuple[int, Parts]:
    """Peak live device bytes of one card for a run, with a labelled
    breakdown: ``(total, [(label, bytes), ...])``.

    The TPU package's arguments and strategy selection, for the port's
    paths: the plain pad -> update path (``compute="auto"``/``"jnp"``), the
    raw whole-step kernels (``compute="raw"``: the state is its own halo),
    and ``fuse`` on the unsharded kernels (no pad transient), the padded,
    pad-free and streaming sharded kinds (exchange-padded blocks or slab
    operands), ``overlap`` (twice the exchanged operands), ``exchange=
    "rdma"`` (the ring's received slabs, the slab term; on a mesh over
    ``processes`` > 1 also the peer ring's receive slots).  Every term is
    one shard's; ``shards_per_device`` shards on one card (virtual devices,
    or the processes that share it) multiply them.  A shape the run would
    refuse is labelled ``UNBUILDABLE`` at 0 bytes, as in the TPU package.

    ``ensemble=N`` prices the batched run, as the TPU package does: every
    kind that builds unbatched builds batched, so each per-shard term
    scales by the members a shard holds, N over ``ensemble_mesh`` M groups
    (the frame mask, one per block and shared by its members, excepted);
    ``shards_per_device`` then counts the ensemble groups' shards too.
    """
    groups = max(1, int(ensemble_mesh))
    if ensemble and int(ensemble) % groups:
        raise ValueError(
            f"ensemble={ensemble} not divisible by "
            f"ensemble_mesh={ensemble_mesh} (the run refuses before "
            "allocating)")
    batch = int(ensemble) // groups if ensemble else 1
    itemsize = stencil.dtype.itemsize
    nfields = stencil.num_fields
    local = _local_shape(grid, mesh)
    field_b = math.prod(local) * itemsize
    halo = stencil.halo
    sharded = bool(mesh) and math.prod(mesh) > 1
    kstep = bool(fuse)
    dtype = str(stencil.dtype).replace("torch.", "")

    parts: Parts = [
        (f"state: {nfields} field(s) x {field_b / 2**30:.2f} GiB "
         f"({'x'.join(str(s) for s in local)} local, {dtype})",
         nfields * field_b),
        ("step output transient (double buffer)", field_b),
    ]
    extra_out = _written_fields(stencil, kstep) - 1
    if extra_out > 0:
        parts.append((f"step output: {extra_out} more field(s) written anew "
                      "(port: the kernel writes every field)",
                      extra_out * field_b))

    if exchange == "rdma" and not (sharded and fuse and len(local) == 3
                                   and fuse_kind == "stream"):
        parts.append(("rdma exchange: UNSUPPORTED off the sharded "
                      "streaming kind (the run refuses before "
                      "allocating)", 0))
    if fuse and len(local) == 3:
        m = k_step_margin(stencil, fuse)
        lz, ly, lx = local
        mesh3 = tuple(mesh) + (1,) * (3 - len(mesh))
        z_only = sharded and all(int(c) == 1 for c in mesh3[1:])
        lane_whole = int(mesh3[2]) == 1
        grid_t = tuple(int(g) for g in grid)
        if sharded and fuse_kind in ("stream", "padfree"):
            stream = fuse_kind == "stream"
            ok = lane_whole and (
                _stream_ok(stencil, local, grid_t, fuse, periodic, True,
                           z_only) if stream else
                _padfree_ok(stencil, local, grid_t, fuse, periodic, z_only))
            name = "sharded streaming" if stream else "sharded pad-free"
            if z_only:
                slab_cells = 2 * m * ly * lx
                what = f"slab operands only (2x{m} rows"
            else:
                # z slabs, y slabs and corners at their natural width m
                slab_cells = 2 * m * ly * lx + 2 * m * lz * lx \
                    + 4 * m * m * lx
                what = f"slab+corner operands only (2-axis, width {m}"
            base_b = slab_cells * itemsize * nfields
            slab_b = 2 * base_b if overlap else base_b
            if not ok:
                parts.append((f"{name}: UNBUILDABLE for this mesh/shape "
                              "(the run refuses before allocating)", 0))
            else:
                parts.append((f"{name}: {what}"
                              f"{', x2 overlap split' if overlap else ''})",
                              slab_b))
                if pipeline:
                    parts.append(_pipeline_part(
                        stencil, local, m, mesh3, overlap, base_b,
                        exchange == "rdma"))
                if exchange == "rdma" and stream and processes > 1:
                    parts.append(_peer_slots_part(stencil, local, m, mesh3))
        elif sharded:
            n_padded = 2 * nfields if overlap else nfields
            padded_b = (lz + 2 * m) * (ly + 2 * m) * lx * itemsize
            parts.append(
                (f"sharded fused: {n_padded} "
                 f"{'exchange+local' if overlap else 'exchange'}-padded "
                 f"block(s) (+{2 * m} z/y)", n_padded * padded_b))
        elif fuse_kind == "stream":
            ok = _stream_ok(stencil, local, grid_t, fuse, periodic, False,
                            False)
            parts.append(("streaming fused: no pad transient" if ok else
                          "streaming fused: UNBUILDABLE"
                          + (" — stream is guard-frame only" if periodic
                             else " for this shape")
                          + " (the run refuses before allocating)", 0))
        else:
            parts.append(("fused: no pad transient (the kernel reads the "
                          "raw grid)", 0))
    elif fuse and len(local) == 2:
        if sharded:
            m = k_step_margin(stencil, fuse)
            ly, lx = local
            parts.append((f"2D fullgrid pad transient (+{2 * m} rows)",
                          nfields * (ly + 2 * m) * lx * itemsize))
        else:
            parts.append(("2D fullgrid: no pad transient (the kernel reads "
                          "the raw grid)", 0))
    elif compute == "raw":
        parts.append(("raw whole-step kernel: no pad transient", 0))
    else:
        pad = 2 * halo
        parts.append(
            (f"pad transient (+{pad} per axis) x {nfields}",
             nfields * math.prod(s + pad for s in local) * itemsize))
        repinned = 0 if periodic else sum(
            1 for src, masked in zip(stencil.carry_map, stencil.mask_fields)
            if src is None and masked)
        if repinned:
            parts.append((f"re-pin: the update's output beside its re-pinned "
                          f"copy x {repinned} (port: torch.where writes the "
                          "pinned field anew)", repinned * field_b))
            parts.append(("frame mask, 1 B a cell (port: a bool tensor a "
                          "block, kept for the run)", math.prod(local)))

    if batch > 1:
        parts = [(label, b if label.startswith("frame mask") else b * batch)
                 for label, b in parts]
        parts.append((f"{batch} members batched a shard ({ensemble} over "
                      f"{groups} ensemble group(s)): the terms above scaled "
                      "by them, the frame mask shared", 0))
    per_shard = sum(b for _, b in parts)
    if shards_per_device > 1:
        parts.append((f"{shards_per_device - 1} more shard(s) on this "
                      "device (virtual devices)",
                      (shards_per_device - 1) * per_shard))
    if processes > 1:
        parts += _log_line_part(stencil, local, mesh, processes,
                                shards_per_device,
                                per_shard - parts[0][1], batch, groups)
    subtotal = sum(b for _, b in parts)
    overhead = int(subtotal * _OVERHEAD_FRAC)
    parts.append((f"workspace overhead ({int(_OVERHEAD_FRAC * 100)}%)",
                  overhead))
    return subtotal + overhead, parts


def _log_line_part(stencil, local, mesh, processes, shards_per_device,
                   transients, batch=1, groups=1) -> Parts:
    """[(label, bytes)] of what a multi-process run's log lines hold beside
    the state, beyond the step's own transients (``transients`` a shard,
    all but the state), for every process on the card: the processes log
    at the same step, each its own block's temporaries (the mean's float32
    copy of a bfloat16 block; the velocity's difference and square of two
    fields), where one process alone holds them one shard at a time."""
    cells = math.prod(local) * batch
    itemsize = stencil.dtype.itemsize
    mean_copy = 0 if stencil.dtype == torch.float32 else 4 * cells
    velocity = 2 * itemsize * cells if stencil.num_fields > 1 else 0
    local_shards = max(1, math.prod(mesh) * groups // processes)
    extra = max(mean_copy, velocity) - local_shards * transients
    if extra <= 0:
        return []
    on_card = max(1, shards_per_device // local_shards)
    return [(f"log-line temporaries beyond the step's, x {on_card} "
             "process(es) on the card (each at the same step)",
             on_card * extra)]


def _peer_slots_part(stencil, local, m, mesh3):
    """(label, bytes) of one shard's share of the peer ring's regions: the
    receive slots, ready flags and credits of every site the stream kind
    posts (a sharded z: the z slabs; a sharded y: the y slabs and the
    corners)."""
    from ..ops.cuda.remote import _NSLOTS, peer_site_bytes

    lz, ly, lx = local
    shapes = ([(m, ly, lx)] if int(mesh3[0]) > 1 else []) + (
        [(lz, m, lx), (m, m, lx)] if int(mesh3[1]) > 1 else [])
    total = sum(peer_site_bytes(sh, stencil.dtype) for sh in shapes)
    return (f"peer ring receive slots ({_NSLOTS} slots x 2 directions x "
            f"{len(shapes)} site(s), flags and credits; across processes)",
            total)


def _pipeline_part(stencil, local, m, mesh3, overlap, base_b, rdma):
    """(label, bytes) of the slab-carry pipeline's carried set."""
    itemsize = stencil.dtype.itemsize
    nfields = stencil.num_fields
    lz, ly, lx = local
    label = ("pipelined carried slabs (the next pass's exchange lives "
             "beside this pass's operands"
             + ("; kept under rdma: the ring's received slabs are device "
                "buffers here" if rdma else ""))
    if not overlap:
        return label + ")", base_b
    two_axis = 2 * m * ly * lx + 2 * m * lz * lx + 4 * m * m * lx
    shells = sum(2 * 2 * m * (lx * (ly if d == 0 else lz))
                 for d in (0, 1) if int(mesh3[d]) > 1)
    return (label + "; overlap: the 2-axis set and the shell outputs held "
            "to the next join)", (two_axis + shells) * itemsize * nfields)


def checkpoint_host_bytes(stencil: Stencil, grid: Sequence[int],
                          mesh: Sequence[int] = ()) -> int:
    """Host memory a process stages a sharded checkpoint through: one
    block of one field at a time (the writer's copy-ahead is bounded by a
    few MB), on save and on load (a load reads a saved block whole, then
    copies its overlap; its blocks are this run's size when the mesh is
    the writer's)."""
    return math.prod(_local_shape(grid, mesh)) * stencil.dtype.itemsize


def _coupled_group_bytes(p, traffic, g: int, collective: bool,
                         shards: int) -> Tuple[int, Parts]:
    """One group of a coupled run on one card: its own run's estimate for
    ``shards`` of its shards there, plus the interface transients the
    coupling adds on its devices (the TPU package's terms, charged
    unsharded: an upper bound)."""
    s = p.spec
    total, parts = estimate_run_bytes(
        p.stencil, p.grid, mesh=p.mesh_shape,
        fuse=s.fuse_k if s.fuse_k > 1 else 0,
        fuse_kind=s.kind or "auto",
        overlap=bool(s.overlap_mode), pipeline=bool(s.pipeline_mode),
        shards_per_device=shards)
    extra: Parts = []

    def iface(t, send_dir, recv_dir):
        send_b = t[send_dir]["send_bytes"]
        recv_b = t[recv_dir]["recv_bytes"]
        if collective:
            extra.append((f"interface {t['interface']}: raw staged "
                          f"rows ({send_dir})", send_b))
            extra.append((f"interface {t['interface']}: collective "
                          f"wire chunk ({send_dir})", send_b))
            extra.append((f"interface {t['interface']}: band recv "
                          f"({recv_dir})", recv_b))
        else:
            extra.append((f"interface {t['interface']}: staged send "
                          f"({send_dir})", send_b))
            extra.append((f"interface {t['interface']}: band recv "
                          f"({recv_dir})", recv_b))

    if g < len(traffic):  # this group is the low side of interface g
        iface(traffic[g], "up", "down")
    if g > 0:  # ... and the high side of interface g-1
        iface(traffic[g - 1], "down", "up")
    return total + sum(b for _, b in extra), list(parts) + extra


def estimate_coupled_bytes(plans, transport: str = "",
                           devices=None) -> Tuple[int, list]:
    """Peak device bytes of a coupled ``--groups`` run: ``(worst,
    [(group name, total, parts), ...])``.

    Each group is priced as its own run (:func:`estimate_run_bytes` of its
    stencil, grid, mesh and clause modes) plus its interface transients:
    ``device_put`` a staged send and a band receive a direction,
    ``collective`` the raw staged rows, the wire chunk and the band
    receive (the TPU package's terms).  ``devices`` (one device list a
    group, ``GroupPlan.devices``) says which groups share a card: each
    group is priced for the most shards it has on one card, and ``worst``
    is the largest card's sum over the groups it holds, each for its
    shards there.  Without ``devices`` every group has cards of its own
    (one shard a card) and ``worst`` is the worst group's, as in the TPU
    package."""
    from ..parallel import groups as groups_lib

    transport = transport or groups_lib.TRANSPORT_BACKEND
    collective = transport == "collective"
    traffic = groups_lib.interface_traffic(plans)
    details = []
    on_card: dict = {}
    for g, p in enumerate(plans):
        devs = list(devices[g]) if devices is not None else \
            [(g, j) for j in range(p.spec.n_devices)]
        counts = collections.Counter(devs)
        priced = {n: _coupled_group_bytes(p, traffic, g, collective, n)
                  for n in set(counts.values())}
        details.append((p.name, *priced[max(counts.values())]))
        for d, n in counts.items():
            on_card[d] = on_card.get(d, 0) + priced[n][0]
    return max(on_card.values()), details


def check_coupled_budget(plans, hbm_bytes: Optional[int] = None,
                         transport: str = "",
                         devices=None) -> Tuple[int, list]:
    """The ``check_budget`` of a coupled run: raise ValueError with the
    arithmetic when a card cannot hold its groups."""
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes()
    worst, details = estimate_coupled_bytes(plans, transport=transport,
                                            devices=devices)
    if worst > hbm:
        body = "\n".join(
            f"  group {name}:\n" + format_budget(total, parts, hbm)
            for name, total, parts in details)
        raise ValueError(
            f"--groups: the groups on one card need ~{worst / 2**30:.2f} "
            f"GiB but device memory is {hbm / 2**30:.2f} GiB; refusing "
            "before allocating. Breakdown:\n" + body
            + "\nLevers: a bf16 group dtype halves its state bytes; "
            "spreading the groups over more cards shrinks each card's "
            "share; a smaller :z fraction shrinks the hot region; "
            "--mem-check warn overrides this guard.")
    return worst, details


def format_budget(total: int, parts: Parts, hbm: int) -> str:
    lines = [f"  {b / 2**30:7.2f} GiB  {label}" for label, b in parts]
    lines.append(f"  {total / 2**30:7.2f} GiB  TOTAL per device "
                 f"(device memory {hbm / 2**30:.2f} GiB)")
    return "\n".join(lines)


def check_budget(
    stencil: Stencil,
    grid: Sequence[int],
    mesh: Sequence[int] = (),
    fuse: int = 0,
    ensemble: int = 0,
    periodic: bool = False,
    compute: str = "auto",
    fuse_kind: str = "auto",
    hbm_bytes: Optional[int] = None,
    overlap: bool = False,
    pipeline: bool = False,
    exchange: str = "ppermute",
    ensemble_mesh: int = 0,
    shards_per_device: int = 1,
    processes: int = 1,
) -> Tuple[int, Parts]:
    """Raise ValueError with the arithmetic when the run cannot fit its
    card (``hbm_bytes``, default :func:`device_hbm_bytes`); return the
    estimate when it fits."""
    hbm = hbm_bytes if hbm_bytes is not None else device_hbm_bytes()
    total, parts = estimate_run_bytes(
        stencil, grid, mesh=mesh, fuse=fuse, ensemble=ensemble,
        periodic=periodic, compute=compute, fuse_kind=fuse_kind,
        overlap=overlap, pipeline=pipeline, exchange=exchange,
        ensemble_mesh=ensemble_mesh, shards_per_device=shards_per_device,
        processes=processes)
    if total > hbm:
        raise ValueError(
            f"config needs ~{total / 2**30:.2f} GiB per device but device "
            f"memory is {hbm / 2**30:.2f} GiB; refusing before allocating. "
            "Breakdown:\n" + format_budget(total, parts, hbm)
            + "\nLevers: --dtype bfloat16 halves state bytes; a larger "
            "--mesh over more cards shrinks the per-device block; --fuse "
            f"on a {'sharded' if mesh else 'pad-free'} grid avoids pad "
            "transients; --mem-check warn overrides this guard.")
    return total, parts
