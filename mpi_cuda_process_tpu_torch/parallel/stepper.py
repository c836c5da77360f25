"""Sharded time step: domain decomposition over a mesh + halo exchange.

The counterpart of the TPU package's ``parallel/stepper.py``.  A decomposed
field is a :class:`ShardedField`: the list of the blocks this process holds
(``Mesh.local_coords``, every shard for one process) in mesh row-major
order, each on its mesh device, with the mesh and the global shape
attached.  A step is the halo exchange, a collective over the block lists
(``halo.py``: in process, or across processes through the mesh's
transport), then the same per-shard code for every local shard, written
once for "the shard at mesh coordinate ``c``" (``c`` takes the place of
``lax.axis_index``).  No step has per-process code: every process runs the
same step over the shards it holds, as every shard of the TPU package's
runs the same program.

``make_sharded_step`` is one step: two-pass halo exchange, local update
(``stencil.update`` or a ``compute_fn`` kernel, K4/K5), re-pin of the global
guard frame from each shard's global offset.  ``overlap=True`` splits the
update into a bulk part from locally padded blocks and the width-halo rings
at each sharded face from the exchanged blocks; on CUDA the exchange copies
run on a side stream while the bulk update runs on the current one, and
the shifts that cross processes are posted before the bulk update is
launched and awaited after it.

``make_sharded_fused_step`` is k steps per exchange with the temporal-
blocking kernels: the padded kind (width-m exchange on z and y, then K3 in
its sharded mode) and the slab-operand kinds, on z-only meshes the z slabs
into K6 (pad-free) or the streaming kernel K10, on meshes that shard y the
2-axis slab set into K9 or K10; with ``overlap=True`` each kind runs its
interior beside the exchange and then the boundary shells (K3's sharded
mode over 2m-deep cores).  ``exchange="rdma"`` carries the stream kind's
slab exchanges through the ring-exchange kernel (``halo.RdmaTransport``).
``make_sharded_fullgrid_step`` is its 2D counterpart: a row split, a
width-m row exchange, then K8 in its sharded mode, with an overlapped
variant; ``make_sharded_temporal_step`` picks between the two.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..driver import frame_mask
from ..ops.stencil import Fields, Stencil, k_step_margin
from ..utils import launchcheck
from .halo import (RdmaTransport, default_transport, exchange_and_pad,
                   local_mesh, pad_from_slabs, pad_local, post_and_pad,
                   post_slabs_2axis, post_slabs_2axis_from_borders,
                   post_slabs_axis)
from .mesh import Mesh


class ShardedField(list):
    """One field decomposed over ``mesh``: the blocks of the shards this
    process holds, in ``mesh.local_coords()`` order, each on its mesh
    device, with the global shape.

    A batched field (``lead`` = 1, an ensemble run) has a leading member
    axis in its global shape ``(N, *grid)`` and in every block ``(N_local,
    *local)``: the members of the shard's ensemble group (all N without an
    ensemble mesh axis)."""

    def __init__(self, blocks, mesh: Mesh, global_shape: Sequence[int],
                 lead: int = 0):
        super().__init__(blocks)
        self.mesh = mesh
        self.global_shape = tuple(int(g) for g in global_shape)
        self.lead = int(lead)

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def with_blocks(self, blocks) -> "ShardedField":
        return ShardedField(blocks, self.mesh, self.global_shape, self.lead)

    def offsets(self, c, local=None) -> Tuple[int, ...]:
        """Global index of shard ``c``'s block's first cell along every
        axis of the field (the member axis first when batched), for blocks
        of shape ``local`` (default: this field's)."""
        local = tuple(self[0].shape if local is None else local)
        members = (self.mesh.group(c) * int(local[0]),) if self.lead else ()
        return members + shard_offsets(self.mesh.spatial(c),
                                       local[self.lead:])


def is_sharded(fields) -> bool:
    return bool(fields) and isinstance(fields[0], ShardedField)


def _resolve_mesh_axes(ndim: int, mesh: Mesh):
    """(axis_names, counts) for grid axes 0..ndim-1 over ``mesh``:
    ``axis_names[d]`` is the mesh axis decomposing grid axis d (or None),
    ``counts[d]`` its shard count."""
    counts = mesh.counts(ndim)
    axis_names = mesh.axis_names + (None,) * (ndim - len(mesh.axis_names))
    return axis_names, counts


def _local_shape(global_shape, counts) -> Tuple[int, ...]:
    return tuple(int(g) // c for g, c in zip(global_shape, counts))


def block_slices(c, local_shape):
    return tuple(slice(ci * ls, (ci + 1) * ls)
                 for ci, ls in zip(tuple(c) + (0,) * len(local_shape),
                                   local_shape))


def shard_offsets(c, local_shape) -> Tuple[int, ...]:
    """Global index of shard ``c``'s first cell along each grid axis."""
    c = tuple(c) + (0,) * (len(local_shape) - len(c))
    return tuple(ci * ls for ci, ls in zip(c, local_shape))


def ensemble_members_local(mesh: Mesh, ensemble: int) -> int:
    """Members each shard holds: ``ensemble`` over the ensemble mesh
    axis's groups (the TPU package's check and messages): the member count
    must divide over the groups, and an ensemble mesh axis needs a batched
    run.  0 for an unbatched run."""
    groups = mesh.ensemble
    if not ensemble:
        if groups > 1:
            raise ValueError(
                f"mesh carries a {groups}-way ensemble axis but the "
                "run is unbatched (ensemble=0) — drop the axis or pass "
                "ensemble=N")
        return 0
    if int(ensemble) % groups:
        raise ValueError(
            f"ensemble={ensemble} not divisible by the ensemble mesh "
            f"axis ({groups} shards)")
    return int(ensemble) // groups


def shard_fields(fields: Fields, mesh: Mesh, ndim: int,
                 ensemble: bool = False) -> Fields:
    """Cut each global field into the blocks this process holds, each
    copied to its device.  ``ensemble=True``: the fields carry a leading
    member axis, cut over the mesh's ensemble groups
    (:func:`ensemble_members_local`)."""
    lead = 1 if ensemble else 0
    out = []
    for f in fields:
        counts = mesh.counts(ndim)
        for d, c in enumerate(counts):
            if f.shape[d + lead] % c:
                raise ValueError(f"grid axis {d} ({f.shape[d + lead]}) not "
                                 f"divisible by mesh axis ({c})")
        n_local = ensemble_members_local(mesh, f.shape[0] if lead else 0)
        local = (n_local,) * lead + _local_shape(f.shape[lead:], counts)
        field = ShardedField([], mesh, f.shape, lead)
        for c in mesh.local_coords():
            b = torch.empty(local, dtype=f.dtype, device=mesh.device(c))
            b.copy_(f[_slices(field.offsets(c, local), local)])
            field.append(b)
        out.append(field)
    return tuple(out)


def _slices(offsets, shape):
    return tuple(slice(o, o + n) for o, n in zip(offsets, shape))


GLOBAL_GRID_REASON = (
    "no process of a multi-process run holds the global grid: each holds "
    "only its own shards' blocks")


def gather_fields(fields: Fields, device=None) -> Fields:
    """Sharded fields back to whole tensors (on the first block's device
    unless ``device`` is given); one process only (a multi-process mesh
    raises, :data:`GLOBAL_GRID_REASON`)."""
    out = []
    for f in fields:
        if f.mesh.multiprocess:
            raise ValueError(f"gather_fields: {GLOBAL_GRID_REASON}")
        dev = f[0].device if device is None else torch.device(device)
        g = torch.empty(f.global_shape, dtype=f.dtype, device=dev)
        for c, b in zip(f.mesh.coords(), f):
            g[_slices(f.offsets(c), b.shape)].copy_(b)
        out.append(g)
    return tuple(out)


def _on_device(dev: torch.device):
    """Make ``dev`` current for the launches of one shard (CUDA only)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class _SideStreams:
    """One side stream per CUDA device of a mesh, for the exchange copies
    of an overlapped step; on the CPU every method does nothing and the
    work runs in order.

    Ordering runs both ways, and that is what keeps memory safe without
    ``record_stream``: the side stream waits for the current one before its
    copies (so it reads finished blocks, and reuses its own freed padded
    blocks only after the current stream's last read of them), and the
    current stream waits for the side copies before the ring updates (so
    blocks the current stream frees were last touched before that wait).
    ``record_stream`` would be redundant here and costly: the host runs
    steps ahead of the card, so the events it records are still pending
    when the next step allocates, and the caching allocator then takes
    fresh memory instead of reusing the freed blocks.
    """

    def __init__(self, mesh: Mesh):
        self.devices = [d for d in mesh.unique_devices() if d.type == "cuda"]
        self.streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.events: Dict[torch.device, torch.cuda.Event] = {}

    def begin(self) -> contextlib.ExitStack:
        """Order the side streams after the current ones and make them
        current: the copies issued inside run there."""
        stack = contextlib.ExitStack()
        stack.enter_context(launchcheck.side_scope())
        for d in self.devices:
            if d not in self.streams:
                self.streams[d] = torch.cuda.Stream(device=d)
            s = self.streams[d]
            s.wait_stream(torch.cuda.current_stream(d))
            stack.enter_context(torch.cuda.stream(s))
        return stack

    def resume(self) -> contextlib.ExitStack:
        """Make the side streams current again, with no new wait: the
        rest of an exchange :meth:`begin` posted runs there, still ordered
        only after the work that came before :meth:`begin`."""
        stack = contextlib.ExitStack()
        stack.enter_context(launchcheck.side_scope())
        for d in self.devices:
            stack.enter_context(torch.cuda.stream(self.streams[d]))
        return stack

    def record(self) -> None:
        for d in self.devices:
            self.events[d] = self.streams[d].record_event()

    def join(self) -> None:
        """The current streams wait for the side copies."""
        for d in self.devices:
            torch.cuda.current_stream(d).wait_event(self.events[d])


class SlabCarry:
    """What a pipelined pass hands to the next: one posted exchange per
    field (its ``wait()`` gives the next pass's slab operands per shard),
    and the tensors the side streams may still be reading, held until the
    next pass has joined them.

    :meth:`wait` awaits every field's exchange in field order (on the side
    streams of an overlapped step, then joined), as every process does at
    the same point of the same pass; a carry no pass consumes is awaited
    all the same (``driver.pipeline_hooks``), since a transfer left posted
    would leave a peer blocked at its next collective."""

    def __init__(self, pending, side: Optional[_SideStreams] = None,
                 keep=()):
        self.pending = list(pending)
        self.side = side
        self.keep = keep

    def wait(self) -> list:
        if self.side is None:
            out = [p.wait() for p in self.pending]
        else:
            with self.side.resume():
                out = [p.wait() for p in self.pending]
                self.side.record()
            self.side.join()
        self.keep = ()
        return out


class _Mapped:
    """A posted exchange whose value is ``fn`` of the exchange's."""

    def __init__(self, pending, fn):
        self._pending, self._fn = pending, fn

    def wait(self):
        return self._fn(self._pending.wait())


def _per_shard(pair):
    """``(lefts, rights)`` -> one ``(lo, hi)`` pair per shard."""
    return list(zip(*pair))


def _axis_slice(x, d, sl):
    idx = [slice(None)] * x.dim()
    idx[d] = sl
    return x[tuple(idx)]


def make_sharded_step(
    stencil: Stencil,
    mesh: Mesh,
    global_shape: Sequence[int],
    periodic: bool = False,
    compute_fn: Optional[Callable[[Fields], Fields]] = None,
    overlap: bool = False,
    ensemble: int = 0,
):
    """The step function for ``stencil`` decomposed over ``mesh``:
    sharded fields -> sharded fields.

    ``compute_fn`` overrides the local block update (padded fields ->
    interior fields); defaults to ``stencil.update``.  This is how the
    compute_fn kernels (K4/K5) replace the tensor ops without touching the
    decomposition.

    ``overlap=True`` selects the explicit interior/boundary split — the
    reference's two-stream trick (middle kernel on one stream, concurrent
    with the halo exchange): the bulk update reads a LOCALLY padded block
    with no dependence on the exchange, and only the width-``halo`` ring at
    each sharded face is computed from exchanged data and spliced over it.
    On CUDA the exchange copies run on a side stream while the bulk update
    runs on the current stream; an event orders the ring updates after the
    copies (``_SideStreams`` says why no ``record_stream`` is needed).  The
    values equal ``overlap=False`` bit for bit.  Across processes the
    first axis's shifts are posted before the bulk update is launched and
    the rest of the exchange runs after it (``halo.post_and_pad``), so a
    blocking receive waits while the card computes the bulk.

    The step is tagged ``_transport_backend``: ``in-process`` or the
    multi-process mesh's backend (``nccl``, ``gloo``, ``gloo-host``).

    ``ensemble=N``: the step takes and returns batched fields (a leading
    member axis, ``shard_fields(..., ensemble=True)``), cut over the
    mesh's ensemble groups when it has them; every exchange carries all
    the shard's members in one shift (``(N_local, halo, ...)`` slabs) and
    every update (the plain one or the compute_fn kernel) takes the member
    axis in one call.
    """
    ndim = stencil.ndim
    halo = stencil.halo
    ensemble_members_local(mesh, ensemble)
    lead = 1 if ensemble else 0
    axis_names, counts = _resolve_mesh_axes(ndim, mesh)
    global_shape = tuple(int(g) for g in global_shape)
    for d, c in enumerate(counts):
        if global_shape[d] % c:
            raise ValueError(
                f"grid axis {d} ({global_shape[d]}) not divisible by "
                f"mesh axis {axis_names[d]} ({c})")
    local_shape = _local_shape(global_shape, counts)
    if any(ls < halo for ls in local_shape):
        raise ValueError(
            f"local block {local_shape} smaller than halo {halo}")
    if stencil.phases:
        if compute_fn is not None:
            raise ValueError(
                f"{stencil.name} is multi-phase; compute_fn unsupported")
        if overlap:
            raise ValueError(
                f"{stencil.name} is multi-phase; overlap split unsupported")
    if stencil.parity_sensitive:
        bad = [d for d, c in enumerate(counts)
               if c > 1 and local_shape[d] % 2]
        if bad:
            raise ValueError(
                f"{stencil.name} is parity-sensitive (red-black coloring): "
                f"sharded axes {bad} have odd per-shard extents "
                f"{[local_shape[d] for d in bad]}, which would flip colors "
                f"across shards — use even per-axis block sizes")
        if periodic and any(g % 2 for g in global_shape):
            raise ValueError(
                f"{stencil.name} is parity-sensitive: periodic wrap over "
                f"odd extents {global_shape} makes the coloring "
                f"inconsistent")
    update_fns = stencil.phases or (compute_fn or stencil.update,)
    sharded_axes = [d for d, c in enumerate(counts) if c > 1]
    coords = mesh.local_coords()
    masks: Dict[int, torch.Tensor] = {}  # local shard index -> frame mask
    side = _SideStreams(mesh)

    def exchange(fields: Fields) -> List[List[torch.Tensor]]:
        return [exchange_and_pad(f, mesh, fh, bc, periodic, lead=lead)
                for f, bc, fh in zip(fields, stencil.bc_value,
                                     stencil.field_halos)]

    def post(fields: Fields):
        return [post_and_pad(f, mesh, fh, bc, periodic, lead=lead)
                for f, bc, fh in zip(fields, stencil.bc_value,
                                     stencil.field_halos)]

    def ring_update(update, padded_c, fields_c, d, lo):
        """Update of the width-halo boundary ring at face (d, lo/hi) of
        one shard, from its exchanged padded blocks."""
        t = d + lead
        slabs = []
        for pf, f, fh in zip(padded_c, fields_c, stencil.field_halos):
            if fh == 0:
                n = f.shape[t]
                sl = slice(0, halo) if lo else slice(n - halo, None)
                slabs.append(_axis_slice(f, t, sl).contiguous())
            else:
                n = pf.shape[t]
                sl = slice(0, 3 * fh) if lo else slice(n - 3 * fh, None)
                slabs.append(_axis_slice(pf, t, sl).contiguous())
        return update(tuple(slabs))

    def repin(i: int, c, new_c, fields_c):
        """The shard's new fields with the global guard frame restored."""
        out = []
        for j, nf in enumerate(new_c):
            src = stencil.carry_map[j]
            if src is not None:
                out.append(fields_c[src])  # verbatim carry: no copy
            elif periodic or not stencil.mask_fields[j]:
                out.append(nf)
            else:
                if i not in masks:
                    # one mask a shard, broadcast over its members
                    masks[i] = frame_mask(
                        local_shape, global_shape,
                        shard_offsets(mesh.spatial(c), local_shape), halo,
                        device=fields_c[0].device)
                out.append(torch.where(masks[i], fields_c[j], nf))
        return out

    def one_pass(fields: Fields, update) -> Fields:
        shards = [tuple(f[i] for f in fields) for i in range(len(coords))]
        if overlap and sharded_axes:
            with side.begin():
                posted = post(fields)
            new = []
            for i, c in enumerate(coords):
                with _on_device(mesh.device(c)):
                    local = tuple(
                        pad_local(b, fh, bc, periodic, lead=lead) if fh
                        else b
                        for b, bc, fh in zip(shards[i], stencil.bc_value,
                                             stencil.field_halos))
                    new.append(list(update(local)))
                launchcheck.note("interior", reads=(shards[i], local),
                                 writes=new[i])
            with side.resume():
                padded = [p.wait() for p in posted]
                side.record()
            side.join()
            for i, c in enumerate(coords):
                padded_c = tuple(pf[i] for pf in padded)
                with _on_device(mesh.device(c)):
                    for d in sharded_axes:
                        for lo in (True, False):
                            ring = ring_update(update, padded_c, shards[i],
                                               d, lo)
                            launchcheck.note("shell", reads=padded_c,
                                             writes=ring)
                            for j, nb in enumerate(new[i]):
                                if stencil.carry_map[j] is not None:
                                    continue
                                n = nb.shape[d + lead]
                                sl = slice(0, halo) if lo else \
                                    slice(n - halo, None)
                                _axis_slice(nb, d + lead, sl).copy_(ring[j])
                            launchcheck.note("splice", reads=ring,
                                             writes=new[i])
        else:
            padded = exchange(fields)
            new = []
            for i, c in enumerate(coords):
                with _on_device(mesh.device(c)):
                    ins = tuple(pf[i] for pf in padded)
                    new.append(update(ins))
                launchcheck.note("kernel", reads=ins, writes=new[i])
        out = [[] for _ in fields]
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                for j, b in enumerate(repin(i, c, new[i], shards[i])):
                    out[j].append(b)
        return tuple(f.with_blocks(o) for f, o in zip(fields, out))

    def step(fields: Fields) -> Fields:
        # one time step = every phase in order, each with its own exchange
        for upd in update_fns:
            fields = one_pass(fields, upd)
        return fields

    return _tag_transport(step, mesh)


def _tag_transport(step, mesh: Mesh):
    """Tag a sharded step with the transport of its exchanges:
    ``_transport_backend`` is ``in-process`` for one process, else the
    multi-process mesh's backend (``nccl``, ``gloo``, ``gloo-host``)."""
    step._transport_backend = default_transport(mesh).backend
    return step


def make_sharded_fused_step(
    stencil: Stencil,
    mesh: Mesh,
    global_shape: Sequence[int],
    k: int,
    periodic: bool = False,
    kind: Optional[str] = None,
    overlap: bool = False,
    pipeline: bool = False,
    exchange: Optional[str] = None,
    ensemble: int = 0,
    device=None,
):
    """Temporal blocking under decomposition: k steps per exchange.

    One call is a width ``m`` halo exchange (``m = k * halo * max(1,
    phases)``, ``ops.stencil.k_step_margin``: 2k for red-black SOR, whose
    black half-sweep reads the red values of the same step), then one
    kernel launch per shard.  The kinds:

    * padded (``kind=None``, the TPU package's ``auto`` below its HBM
      threshold): the exchange pads z and y of every shard's block by m
      (x is whole: the kernel wraps or clamps it), and K3 in its sharded
      mode advances the core, pinning the frame on global coordinates from
      the shard's origin;
    * ``kind="padfree"`` on a z-only mesh: the two width-m z slabs are
      exchanged unconcatenated and handed to K6 with the core, so no padded
      copy of the block exists;
    * ``kind="padfree"`` on a mesh that shards y: the z and y slabs and the
      four corner pieces (``halo.exchange_slabs_2axis``) go to K9 with the
      core (:func:`_make_yzslab_padfree_step`);
    * ``kind="stream"``: the same operands into the streaming kernel K10
      instead (``streamfused.build_stream_sharded_call`` on a z-only mesh,
      ``build_stream_2axis_call`` on a mesh that shards y), guard-frame
      only, as the TPU package routes it (``stepper.py:585-605``).

    Every field is exchanged at width m (temporal blocking consumes margin
    for all fields, wave's ``u_prev`` included).  Returns None where the
    TPU builder declines for a structural reason: no fused kernel, the lane
    axis x sharded, a grid not divisible by the mesh, ``2 * m`` off
    the alignment unit (not for ``stream``), a local z/y extent below m,
    ``periodic`` with ``stream``, or for a parity-sensitive stencil an odd
    local extent on a sharded axis or a periodic wrap over an odd extent
    (the TPU tiling rules imply both).  A forced ``kind`` that its kernel
    declines gives None, never the padded kind.  The TPU package's
    ``auto`` switch to pad-free above a v5e HBM threshold does not carry
    over: ``kind=None`` always takes the padded kind.

    ``overlap=True`` splits every kind as the TPU package does
    (:func:`_fused_step_driver`); with a local extent below 3m on a sharded
    axis, or a margin the shells' K3 instance declines, the step is the
    non-split one (``step._overlap_active`` says which).

    Every field is exchanged, so Gray-Scott's two fields both reach the
    padded kind with their m-wide pads.

    ``exchange="rdma"`` sends every slab exchange of the stream kind
    through the ring-exchange kernel (``halo.RdmaTransport``, one launch
    per exchange site and device) in place of the in-process copies, on
    z-only and (z, y) meshes, composed with ``overlap``; the values equal
    ``exchange="ppermute"`` bit for bit.  On a mesh that spans processes
    the transport's peer sites (``ring_send`` / ``ring_drain``) are built
    here, collectively, before the time loop.  As in the TPU package a forced
    mode never falls back: an unknown mode, ``periodic`` and a kind other
    than ``"stream"`` raise with the reason.  The step carries
    ``_exchange`` and, for rdma, ``_rdma_backend`` and ``_rdma_transport``.

    Every kind takes float32 and bfloat16 fields, with and without
    ``overlap``, as every kernel it launches does.  The bfloat16 alignment
    unit (``2 * m`` a multiple of 16) is the builders' too: where the
    shells' K3 instance declines it (config 5's stream kind at k = 4 gives
    m = 4), the overlapped step falls back to the non-split one, as the TPU
    package's does.

    ``pipeline=True`` is the cross-pass slab-carry exchange (the TPU
    package's ``stepper.py:483-505``): each pass's exchange is posted from
    the previous pass's output border rows, one pass ahead of its
    consumer, and the carried slabs (:class:`SlabCarry`) hold exactly the
    bytes the per-pass exchange would fetch, so the values equal
    ``pipeline=False`` bit for bit.  With ``overlap`` the next exchange is
    posted from the boundary-shell outputs, which no interior launch
    writes, so the transfer feeding pass i+1 runs on the side streams
    under pass i's splice and pass i+1's interior.  Only the slab-operand
    kinds host it: ``kind=None`` (the padded kind) and ``periodic`` raise
    with the TPU package's reasons, a shape no slab-operand kernel tiles
    gives None, and an overlap the geometry declines keeps the pipeline on
    the non-split body.  The step carries ``_pipeline_active``,
    ``_pipeline_prologue`` and ``_pipeline_body`` (``driver.
    pipeline_hooks``); called plainly it runs the prologue and one body
    pass, which posts no further exchange.

    ``ensemble=N``: batched fields (a leading member axis, cut over the
    mesh's ensemble groups), every kind's exchange one shift a site for
    all the shard's members and every kernel one launch a shard over
    them (the member in its launch grid).
    """
    from ..ops.cuda import fused, streamfused

    if kind not in (None, "stream", "padfree"):
        raise ValueError(f"unknown sharded fused kind {kind!r} "
                         "(None=auto, 'stream', 'padfree')")
    exchange = exchange or "ppermute"
    if exchange not in ("ppermute", "rdma"):
        raise ValueError(f"unknown exchange mode {exchange!r} "
                         "('ppermute' or 'rdma')")
    if exchange == "rdma":
        if periodic:
            raise ValueError(
                "exchange='rdma' is guard-frame only (the streaming "
                "kernels that host it have no periodic wrap path) — "
                "drop --periodic or use --exchange ppermute")
        if kind != "stream":
            raise ValueError(
                "exchange='rdma' rides the streaming kernel family "
                "(the ring-buffer kernels the ring exchange feeds): force "
                "--fuse-kind stream, or use --exchange ppermute for "
                f"kind={kind!r}")
    if pipeline and periodic:
        # a requested pipeline never falls back: under periodic wrap the
        # slabs of an unsharded wall axis are border rows of the spliced
        # output, an interior dependency
        raise ValueError(
            "pipeline=True is guard-frame only: under periodic wrap the "
            "unsharded-axis slabs derive from the spliced step output "
            "(an interior dependency), which breaks the one-pass-ahead "
            "exchange the slab-carry scan promises — drop --pipeline "
            "for periodic meshes")
    n_local = ensemble_members_local(mesh, ensemble)
    ndim = stencil.ndim
    if ndim != 3 or not fused.fused_supported(stencil):
        return None
    _, counts = _resolve_mesh_axes(ndim, mesh)
    if counts[2] > 1:
        return None  # the lane axis stays whole
    global_shape = tuple(int(g) for g in global_shape)
    if any(g % c for g, c in zip(global_shape, counts)):
        return None
    local_shape = _local_shape(global_shape, counts)
    if not _parity_consistent(stencil, global_shape, local_shape, counts,
                              periodic):
        return None
    if pipeline and kind is None:
        raise ValueError(
            "pipeline=True rides the slab-operand kinds: the exchanged "
            "slabs must be separate kernel operands to travel the scan "
            "carry, and the exchange-padded kernel has none — force "
            "--fuse-kind padfree or stream (or use a pad-free-eligible "
            "local block)")
    transport = RdmaTransport(mesh) if exchange == "rdma" else None
    args = (stencil, mesh, global_shape, local_shape, counts, k, periodic,
            overlap, device, n_local)
    if kind is None:
        step = _make_padded_step(*args)
    elif kind == "stream":
        if counts[1] > 1:
            step = _make_yzslab_padfree_step(
                *args, streamfused.build_stream_2axis_call, "stream_yz",
                transport, pipeline)
        else:
            step = _make_zslab_padfree_step(
                *args, streamfused.build_stream_sharded_call, "stream_z",
                transport, pipeline)
    elif counts[1] > 1:
        step = _make_yzslab_padfree_step(
            *args, fused.build_yzslab_padfree_call, "yzslab", None,
            pipeline)
    else:
        step = _make_zslab_padfree_step(
            *args, fused.build_zslab_padfree_call, "zslab", None, pipeline)
    if step is None:
        return None
    return _attach_exchange(step, exchange, transport)


def _attach_exchange(step, exchange: str, transport):
    """Tag a sharded fused step with its transport, as the TPU package
    does: ``_exchange`` ('ppermute' or 'rdma') and, for rdma,
    ``_rdma_backend`` ('cuda-ring' or 'plain-ring'; 'cuda-peer-ring' or
    'plain-peer-ring' on a mesh that spans processes) and
    ``_rdma_transport``
    (its ``sites`` hold the chunk geometry of every exchange site)."""
    step._exchange = exchange
    if transport is not None:
        step._rdma_backend = transport.backend
        step._rdma_transport = transport
    return step


def _parity_consistent(stencil, global_shape, local_shape, counts,
                       periodic) -> bool:
    """False where red-black colours would disagree across shards (an odd
    local extent on a sharded axis) or across a periodic wrap (an odd
    extent); True for every stencil that is not parity-sensitive."""
    from ..ops.cuda.fused import parity_consistent

    if stencil.parity_sensitive and any(
            c > 1 and ls % 2 for ls, c in zip(local_shape, counts)):
        return False
    return parity_consistent(stencil, global_shape, periodic)


def _make_padded_step(stencil, mesh, global_shape, local_shape, counts, k,
                      periodic, overlap, device, n_local=0):
    """The padded kind: exchange-padded blocks into K3's sharded mode."""
    from ..ops.cuda.fused import build_fused_call

    built = build_fused_call(
        stencil, local_shape, k,
        sharded_global=None if periodic else global_shape,
        periodic=periodic, device=device)
    if built is None:
        return None
    call, m, _ = built
    lead = 1 if n_local else 0

    def post(fields, on):
        return [post_and_pad(f, on, m, bc, periodic, axes=(0, 1), lead=lead)
                for f, bc in zip(fields, stencil.bc_value)]

    def launch(origins, blocks, ops):
        return call(*ops) if periodic else call(origins, *ops)

    return _fused_step_driver(stencil, mesh, global_shape, local_shape,
                              counts, k, m, periodic, overlap, device,
                              post, launch, lead=lead)


def _make_zslab_padfree_step(stencil, mesh, global_shape, local_shape,
                             counts, k, periodic, overlap, device, n_local,
                             build, kind_name, transport=None,
                             pipeline=False):
    """The z-slab kinds (z-only meshes): core and z slabs into the kernel
    that ``build`` makes (K6 or K10), labelled ``kind_name``; ``transport``
    carries the slab exchanges (``halo.exchange_slabs_axis``)."""
    built = build(stencil, local_shape, global_shape, k, periodic=periodic,
                  device=device)
    if built is None:
        return None
    call, m, _ = built
    lead = 1 if n_local else 0
    if transport is not None and counts[0] > 1:
        # a batched slab travels as its (N_local m, Y, X) view
        transport.prepare(
            mesh, [(0, (max(1, n_local) * m,) + tuple(local_shape[1:]))],
            stencil.dtype)

    def post(fields, on):
        return [_Mapped(post_slabs_axis(f, on, 0, m, bc, periodic,
                                        transport, lead), _per_shard)
                for f, bc in zip(fields, stencil.bc_value)]

    def launch(origins, blocks, ops):
        args = []
        for b, (lo, hi) in zip(blocks, ops):
            args += [b, lo, hi]
        return call(origins[0], *args)

    step = _fused_step_driver(stencil, mesh, global_shape, local_shape,
                              counts, k, m, periodic, overlap, device,
                              post, launch, transport, pipeline, lead)
    step._padfree_kind = kind_name
    return step


def _make_yzslab_padfree_step(stencil, mesh, global_shape, local_shape,
                              counts, k, periodic, overlap, device, n_local,
                              build, kind_name, transport=None,
                              pipeline=False):
    """The 2-axis slab-operand kinds (meshes that shard y): the core, z and
    y slabs and the four two-pass corner pieces into the kernel that
    ``build`` makes (K9 or K10), labelled ``kind_name``, so no padded copy
    of a block exists on a (z, y) mesh either.  An unsharded z gets the
    local bc-fill or wrap slabs from the same exchange.  The TPU package's
    widening of the y operands (``_dup_y``, ``_align``: sublane alignment)
    does not apply: the kernels read m-wide pieces.  ``transport`` carries
    the slab exchanges."""
    built = build(stencil, local_shape, global_shape, k, periodic=periodic,
                  device=device)
    if built is None:
        return None
    call, m, _ = built
    lead = 1 if n_local else 0
    if transport is not None:
        # the z slabs' site (a sharded z), the y slabs' and the corners'
        # (the y shift of the z slabs), in the order the steps post them;
        # a batched slab travels as its (N_local * rows, ...) view
        lz, ly, lx = local_shape
        nb = max(1, n_local)
        transport.prepare(
            mesh, ([(0, (nb * m, ly, lx))] if counts[0] > 1 else [])
            + [(1, (nb * lz, m, lx)), (1, (nb * m, m, lx))], stencil.dtype)

    def post(fields, on):
        return [post_slabs_2axis(f, on, m, bc, periodic, transport, lead)
                for f, bc in zip(fields, stencil.bc_value)]

    def launch(origins, blocks, ops):
        args = []
        for b, ((zlo, zhi), (ylo, yhi), corners) in zip(blocks, ops):
            args += [b, zlo, zhi, ylo, yhi, *corners]
        return call(origins, *args)

    step = _fused_step_driver(stencil, mesh, global_shape, local_shape,
                              counts, k, m, periodic, overlap, device,
                              post, launch, transport, pipeline, lead)
    step._padfree_kind = kind_name
    return step


def _fused_step_driver(stencil, mesh, global_shape, local_shape, counts, k,
                       m, periodic, overlap, device, post, launch,
                       transport=None, pipeline=False, lead=0):
    """The sharded fused step around one kind's kernel.

    ``post(fields, on)`` posts the kind's exchange over mesh ``on``, one
    pending exchange per field, whose ``wait()`` gives per shard the
    kind's operand (a padded block, a z-slab pair or a 2-axis slab set);
    ``launch(origins, blocks, ops)`` runs the kind's kernel on one shard's
    core blocks and operands, given the shard's global (z, y) origin.
    ``transport`` (None: in process) carries the overlapped step's slab
    exchange too.

    ``overlap=True``, on a mesh that shards z or y with every sharded local
    extent at least 3m, is the TPU package's split (``stepper.py:681-782``,
    ``:853-1040``, ``:1141-1340``), the temporal-blocked form of the
    reference's two-stream pattern:

    1. the 2-axis slab set's exchange is posted first
       (``halo.post_slabs_2axis``: the z and y shifts), on a side CUDA
       stream (``_SideStreams``);
    2. meanwhile the interior runs: the same kernel on each shard's own
       operands (a local pad or local bc-fill/wrap slabs, no exchanged
       data), valid at least m from every sharded face;
    3. the exchange is awaited (the corners' shifts run then) and the
       current stream joins the side one;
    4. the boundary shells run: per sharded axis, a lo and a hi instance
       of K3's sharded mode over a 2m-deep core, fed by a strip rebuilt
       from the slab set (the exchanged slab plus a 3m-deep local strip,
       the other axis's slabs and corners as its padding,
       ``halo.pad_from_slabs``);
    5. each shell is spliced over the interior output with ``copy_``.

    The values equal the non-split step's bit for bit (every cell is the
    same arithmetic on the same inputs).  On one card nothing is hidden:
    the split costs the shells' extra cells and the strip copies.

    Every step, split or not, is one prologue (post the exchange) and one
    pass body (:func:`_pipelined`); ``pipeline=True`` (the slab kinds)
    only exposes them, so a loop moves step 1 of pass i+1 into pass i (the
    TPU package's ``stepper.py:899-990``, ``:1234-1320``): without the
    split, a pass runs the kernel on the carried slabs and posts the next
    exchange from its output's border rows (``post``); with it, the
    carried 2-axis set feeds the shells and the next set is posted from
    the shells' outputs (``halo.post_slabs_2axis_from_borders``) before
    the splice, on the side streams, so it runs under the splice and the
    next interior.  Such a pass holds every shard's shell outputs until
    the post, and the carry keeps them until the next pass joins the side
    streams (a freed block reused by the current stream before the side
    stream's read would be overwritten); a pass that posts nothing splices
    each shell as soon as it is computed.

    ``lead`` = 1: batched blocks, a member axis before the grid's; every
    slab, strip and shell carries it.
    """
    from ..ops.cuda.fused import build_overlap_shell_calls

    coords = mesh.local_coords()
    origins = [shard_offsets(mesh.spatial(c), local_shape)[:2]
               for c in coords]
    sharded_axes = [d for d in (0, 1) if counts[d] > 1]
    bcs = stencil.bc_value

    def run(fields, i, ops_i, op="kernel"):
        out = launch(origins[i], [f[i] for f in fields], ops_i)
        launchcheck.note(op, reads=([f[i] for f in fields], ops_i),
                         writes=out)
        return out

    def assemble(fields, new):
        """Per-shard output blocks ``new[i][j]`` -> the step's fields."""
        return tuple(f.with_blocks([b[j] for b in new])
                     for j, f in enumerate(fields))

    shells = None
    if overlap and sharded_axes:
        shells = build_overlap_shell_calls(
            stencil, local_shape, global_shape, k, sharded_axes,
            periodic=periodic, device=device)
    if shells is None:
        def prologue(fields):
            return SlabCarry(post(fields, mesh))

        def body(fields, carry, post_next=True):
            ops = carry.wait()
            new = []
            for i, c in enumerate(coords):
                with _on_device(mesh.device(c)):
                    new.append(run(fields, i, [o[i] for o in ops]))
            out = assemble(fields, new)
            return out, SlabCarry(post(out, mesh)) if post_next else None

        step = _pipelined(prologue, body, pipeline)
        step._overlap_active = False
        return _tag_transport(step, mesh)

    w = 2 * m
    side = _SideStreams(mesh)

    def prologue(fields):
        with side.begin():
            return SlabCarry([post_slabs_2axis(f, mesh, m, bc, periodic,
                                               transport, lead)
                              for f, bc in zip(fields, bcs)], side)

    def interior(fields):
        new = []
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                # the shard's own operands only: nothing here waits for the
                # exchange
                own = [p.wait() for p in post([[f[i]] for f in fields],
                                              local_mesh(fields[0][i]))]
                new.append(run(fields, i, [o[0] for o in own], "interior"))
        return new

    def splice(new, i, d, o, res):
        for nb, rb in zip(new[i], res):
            _axis_slice(nb, d + lead, slice(o, o + w)).copy_(rb)
        launchcheck.note("splice", reads=res, writes=new[i])

    def boundary(fields, slabs, new, held=None):
        """Run every shard's shells and splice each over ``new`` as soon
        as it is computed; given a dict ``held``, keep them there instead,
        keyed ``(i, d, o)``, unspliced (the caller posts from them)."""
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                for d in sharded_axes:
                    for o in (0, local_shape[d] - w):
                        # padded rows [o, o + 4m) = global rows from m
                        # before the shell core to 3m after its start
                        strips = [pad_from_slabs(f[i], s[i], m, d, o,
                                                 o + 2 * w, lead)
                                  for f, s in zip(fields, slabs)]
                        org = list(origins[i])
                        org[d] += o
                        res = (shells[d](*strips) if periodic
                               else shells[d](tuple(org), *strips))
                        launchcheck.note("shell", reads=strips, writes=res)
                        if held is None:
                            splice(new, i, d, o, res)
                        else:
                            held[(i, d, o)] = res

    def borders(fields, held, j, d):
        """Field j's first and last m output rows along axis d of every
        shard, read from the shell outputs; an unsharded axis reads no
        row (its slabs are the guard constant), so any m rows do."""
        t = d + lead
        if d not in sharded_axes:
            rows = [f.narrow(t, 0, m) for f in fields[j]]
            return rows, rows
        hi = local_shape[d] - w
        return ([held[(i, d, 0)][j].narrow(t, 0, m)
                 for i in range(len(coords))],
                [held[(i, d, hi)][j].narrow(t, w - m, m)
                 for i in range(len(coords))])

    def body(fields, carry, post_next=True):
        new = interior(fields)
        slabs = carry.wait()
        if not post_next:
            boundary(fields, slabs, new)
            return assemble(fields, new), None
        held = {}
        boundary(fields, slabs, new, held)
        with side.begin():
            pending = [post_slabs_2axis_from_borders(
                *borders(fields, held, j, 0), *borders(fields, held, j, 1),
                mesh, m, bc, periodic, transport, lead)
                for j, bc in enumerate(bcs)]
        for (i, d, o), res in held.items():
            with _on_device(mesh.device(coords[i])):
                splice(new, i, d, o, res)
        return assemble(fields, new), SlabCarry(pending, side, keep=held)

    step = _pipelined(prologue, body, pipeline)
    step._overlap_active = True
    return _tag_transport(step, mesh)


def _pipelined(prologue, body, expose: bool):
    """The step ``body(fields, prologue(fields), post_next=False)[0]``:
    ``prologue(fields) -> carry`` posts a pass's exchange and
    ``body(fields, carry, post_next) -> (fields, carry)`` is one pass that
    consumes it and, unless ``post_next`` is False (a loop's last pass,
    or a plain call), posts the next pass's exchange from its output (a
    :class:`SlabCarry`; None otherwise), so a loop of n passes exchanges
    n times (the TPU package's scan drops one exchange more).  With
    ``expose`` (``pipeline=True``) the step is marked as the TPU package
    marks a slab-carry pipelined one, ``_pipeline_active``,
    ``_pipeline_prologue`` and ``_pipeline_body``, and
    ``driver.pipeline_hooks`` threads the carry."""
    def step(fields: Fields) -> Fields:
        return body(fields, prologue(fields), post_next=False)[0]

    if expose:
        step._pipeline_active = True
        step._pipeline_prologue = prologue
        step._pipeline_body = body
    return step


def make_sharded_fullgrid_step(
    stencil: Stencil,
    mesh: Mesh,
    global_shape: Sequence[int],
    k: int,
    periodic: bool = False,
    overlap: bool = False,
    ensemble: int = 0,
    device=None,
):
    """2D temporal blocking under a row split: k steps per exchange.

    The reference's own decomposition (a 1-D row split) with k generations
    per exchange: the y axis is sharded, width ``m`` row slabs (the k-step
    margin: k, 2k for sor2d) are exchanged (``halo.exchange_and_pad`` along
    axis 0), and K8 in its sharded mode advances each shard's padded block,
    pinning the frame from the shard's global first row.  Returns None
    where the TPU builder declines for a structural reason: not a 2D family
    of the kernel, the x axis sharded, a grid not divisible by the mesh,
    local rows below m, for sor2d odd local rows or a periodic wrap over an
    odd extent; also for a window too large for shared memory.  The TPU
    alignment and VMEM rules (``W % 128``, ``m`` and the local rows a
    multiple of the sublane, the live-copy budget) do not apply.

    ``overlap=True`` (with more than one row shard and local rows >= 3m):
    the width-m slabs are exchanged on a side CUDA stream (posted before,
    awaited after the interior's launch) while the interior instance of K8
    runs on a locally padded block; then two
    width-2m shell instances, fed by the exchanged slabs, overwrite the
    first and last 2m rows.  Bit-equal to ``overlap=False``.  With fewer
    local rows the step is the plain exchange-then-compute one, as in the
    TPU package (``step._overlap_active`` says which).

    ``ensemble=N``: batched fields, as :func:`make_sharded_step`; one
    exchange a shift and one K8 launch a shard for all its members.
    """
    from ..ops.cuda.fullgrid import build_fullgrid_masked_call

    if stencil.ndim != 2:
        return None
    lead = 1 if ensemble_members_local(mesh, ensemble) else 0
    _, counts = _resolve_mesh_axes(2, mesh)
    if counts[1] > 1:
        return None  # x stays whole: the kernel wraps or clamps it
    global_shape = tuple(int(g) for g in global_shape)
    if any(g % c for g, c in zip(global_shape, counts)):
        return None
    local_shape = _local_shape(global_shape, counts)
    if not _parity_consistent(stencil, global_shape, local_shape, counts,
                              periodic):
        return None
    Ly, W = local_shape
    m = k_step_margin(stencil, k)
    built = build_fullgrid_masked_call(
        stencil, (Ly + 2 * m, W), m, k, periodic=periodic,
        global_shape=global_shape, device=device)
    if built is None:
        return None
    call, nf = built
    shell = None
    if overlap and counts[0] > 1 and Ly >= 3 * m:
        # width-2m shell instances of the same kernel: padded extent 4m =
        # the exchanged slab (m) + a 3m-deep local strip
        shell_built = build_fullgrid_masked_call(
            stencil, (4 * m, W), m, k, periodic=periodic,
            global_shape=global_shape, device=device)
        if shell_built is not None:
            shell = shell_built[0]
    coords = mesh.local_coords()
    row0 = [shard_offsets(mesh.spatial(c), local_shape)[0] for c in coords]
    bcs = stencil.bc_value

    def run(fn, padded_c, y0):
        return fn(*padded_c) if periodic else fn(y0, *padded_c)

    def step(fields: Fields) -> Fields:
        padded = [exchange_and_pad(f, mesh, m, bc, periodic, axes=(0,),
                                   lead=lead)
                  for f, bc in zip(fields, bcs)]
        out = [[] for _ in fields]
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                ins = tuple(p[i] for p in padded)
                res = run(call, ins, row0[i])
            launchcheck.note("kernel", reads=ins, writes=res)
            for j, b in enumerate(res):
                out[j].append(b)
        return tuple(f.with_blocks(o) for f, o in zip(fields, out))

    if shell is None:
        step._overlap_active = False
        return _tag_transport(step, mesh)

    w = 2 * m
    side = _SideStreams(mesh)
    rows = (slice(None),) * lead  # the member axis, whole

    def step_overlap(fields: Fields) -> Fields:
        with side.begin():
            posted = [post_slabs_axis(f, mesh, 0, m, bc, periodic,
                                      lead=lead)
                      for f, bc in zip(fields, bcs)]
        new = []
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                # local pad only: nothing here waits for the exchange
                local = tuple(pad_local(f[i], m, bc, periodic, axes=(0,),
                                        lead=lead)
                              for f, bc in zip(fields, bcs))
                new.append(run(call, local, row0[i]))
            launchcheck.note("interior", reads=([f[i] for f in fields],
                                                local), writes=new[i])
        with side.resume():
            slabs = [p.wait() for p in posted]
            side.record()
        side.join()
        out = [[] for _ in fields]
        for i, c in enumerate(coords):
            with _on_device(mesh.device(c)):
                lo_in = tuple(torch.cat([lo[i], f[i][rows + (
                    slice(None, 3 * m),)]], dim=lead)
                              for f, (lo, _) in zip(fields, slabs))
                hi_in = tuple(torch.cat([f[i][rows + (
                    slice(Ly - 3 * m, None),)], hi[i]], dim=lead)
                              for f, (_, hi) in zip(fields, slabs))
                lo_out = run(shell, lo_in, row0[i])
                hi_out = run(shell, hi_in, row0[i] + Ly - w)
                launchcheck.note("shell", reads=lo_in, writes=lo_out)
                launchcheck.note("shell", reads=hi_in, writes=hi_out)
                for j in range(nf):
                    new[i][j][rows + (slice(None, w),)].copy_(lo_out[j])
                    new[i][j][rows + (slice(Ly - w, None),)].copy_(
                        hi_out[j])
                    out[j].append(new[i][j])
                launchcheck.note("splice", reads=(lo_out, hi_out),
                                 writes=new[i])
        return tuple(f.with_blocks(o) for f, o in zip(fields, out))

    step_overlap._overlap_active = True
    return _tag_transport(step_overlap, mesh)


def make_sharded_temporal_step(
    stencil: Stencil,
    mesh: Mesh,
    global_shape: Sequence[int],
    k: int,
    periodic: bool = False,
    kind: Optional[str] = None,
    overlap: bool = False,
    pipeline: bool = False,
    exchange: Optional[str] = None,
    ensemble: int = 0,
    variant=None,
    device=None,
):
    """Temporal blocking under decomposition, any dimensionality: the one
    entry point for ``--fuse K --mesh``.  2D goes to
    :func:`make_sharded_fullgrid_step` (a forced ``kind`` gives None there:
    the kinds are 3D kernel variants), 3D to
    :func:`make_sharded_fused_step`.  Kernel variants, ``pipeline`` and
    ``exchange="rdma"`` are 3D-only and raise for 2D grids, as in the TPU
    package."""
    if stencil.ndim == 2:
        if variant is not None:
            raise ValueError(
                "kernel variants are 3D-only: the 2D whole-local-block "
                "stepper has no streaming kind whose constants a variant "
                "could sweep — drop --kernel-variant for 2D grids")
        if pipeline:
            raise ValueError(
                "pipeline=True is 3D-only: the 2D whole-local-block stepper "
                "has no slab-operand kind to carry the scan — drop "
                "--pipeline for 2D grids")
        if exchange and exchange != "ppermute":
            raise ValueError(
                "exchange='rdma' is 3D-only: the 2D whole-local-block "
                "stepper has no slab-operand streaming kind for the "
                "remote-DMA ring to feed — drop --exchange rdma for 2D "
                "grids")
        return None if kind else make_sharded_fullgrid_step(
            stencil, mesh, global_shape, k, periodic=periodic,
            overlap=overlap, ensemble=ensemble, device=device)
    if variant is not None:
        raise NotImplementedError(
            "kernel variants are not ported: ROADMAP A8 (policy)")
    return make_sharded_fused_step(
        stencil, mesh, global_shape, k, periodic=periodic, kind=kind,
        overlap=overlap, pipeline=pipeline, exchange=exchange,
        ensemble=ensemble, device=device)
