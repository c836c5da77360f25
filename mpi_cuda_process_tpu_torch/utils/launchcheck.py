"""Launch-sequence structure checks for the overlapped and pipelined steps.

The port's counterpart of the TPU package's ``utils/jaxprcheck.py``.  The
overlap and pipeline steppers make promises about dependency structure,
not values: the interior kernel must run while the halo exchange is in
flight.  Values regress loudly (the equivalence tests); structure regresses
silently: a refactor that made the interior wait on the exchange would keep
every field bit-equal and put the exchange back on the critical path.

The TPU package reads the structure off a traced jaxpr.  The port has no
traced program, so it checks the same promises on a **recorded sequence**:
inside :func:`record`, the transports' ``post`` and ``wait``
(``parallel/halo.py``), the ring-exchange launches, and the steppers' calls
to a kernel, an interior, a boundary shell or a splice
(``parallel/stepper.py``, ``parallel/groups.py``) and the member repack's
moves (``parallel/reshard.py``) each append a :class:`Record`: the op, the
axis and the mesh it names, the stream it was issued on, and the tensors it
reads and writes.  The hooks sit at the dispatch boundary, not in the
kernels' ctypes wrappers, so the CPU (where the plain versions run) records
the same sequence as the card.  A recorder takes the ops of the thread that
opened it, so a serving engine's class threads (``serving/scheduler.py``)
each record their own.  Outside :func:`record` every hook is one global
check: no launch, no synchronize, nothing else added to a step.

An exchange is a ``post`` / ``wait`` along an axis of more than one shard;
a shift along an axis of one shard (a local fill or wrap, and the
overlapped step's own one-shard operands) is recorded as ``shards == 1``
and is not an exchange, so the interior's local operands never read as
"interior depends on exchange".  One in-process shift moves a slab pair:
the two ``ppermute`` rounds of the TPU package's count.

The checks keep the TPU package's names where the promise is the same:
:func:`count_exchange_rounds`, :func:`interior_exchange_independence`,
:func:`assert_pipeline_body_structure`, :func:`assert_rdma_step_structure`,
:func:`assert_ensemble_exchange_invariance` /
:func:`check_ensemble_structure`, :func:`assert_coupled_structure` /
:func:`check_coupled_structure`, :func:`assert_group_transport_structure` /
:func:`check_group_transport_structure` and
:func:`check_pipeline_structure`, and
:func:`assert_member_repack_structure` (the serving ladder's member
repack, ``parallel/reshard.py``).  ``assert_reshard_structure`` comes with
the rest of ``parallel/reshard.py`` (ROADMAP A8, policy).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

# thread id -> the recorder that thread opened; empty when none records:
# every hook's one global check
_ACTIVE: Dict[int, "Recorder"] = {}


@dataclasses.dataclass
class Record:
    """One recorded op.  ``shards`` is the shard count along ``axis`` of
    the mesh a ``post``/``wait``/``ring`` names (> 1: an exchange);
    ``bytes`` a post's payload for one shard (its hi and lo slab);
    ``reads``/``writes`` the ids of the tensors, ``read_storage`` /
    ``write_storage`` the data pointers of their storages, ``max_elems``
    the elements of the largest of them."""

    index: int
    op: str
    stream: str = "main"
    stream_id: int = 0
    axis: Optional[int] = None
    mesh: Optional[int] = None
    mesh_shape: Tuple[int, ...] = ()
    shards: int = 0
    transport: str = ""
    bytes: int = 0
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    read_storage: frozenset = frozenset()
    write_storage: frozenset = frozenset()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    max_elems: int = 0


class Recorder:
    """The records of one :func:`record` block, in issue order."""

    def __init__(self):
        self.records: List[Record] = []
        self._stream = ["main"]
        self._tags: List[Dict[str, Any]] = []
        self._keep: List[Any] = []  # recorded tensors, alive until the end

    def add(self, op: str, reads=(), writes=(), **kw) -> Record:
        rt, wt = _tensors(reads), _tensors(writes)
        self._keep += rt + wt
        attrs = {}
        for t in self._tags:
            attrs.update(t)
        attrs.update(kw.pop("attrs", {}))
        sid = 0
        for t in rt + wt:
            if t.is_cuda:
                sid = torch.cuda.current_stream(t.device).cuda_stream
                break
        rec = Record(index=len(self.records), op=op, stream=self._stream[-1],
                     stream_id=sid, reads=tuple(id(t) for t in rt),
                     writes=tuple(id(t) for t in wt),
                     read_storage=frozenset(_storage(t) for t in rt),
                     write_storage=frozenset(_storage(t) for t in wt),
                     attrs=attrs,
                     max_elems=max((t.numel() for t in rt + wt), default=0),
                     **kw)
        self.records.append(rec)
        return rec


def _tensors(obj) -> list:
    out: list = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
    return out


def _storage(t: torch.Tensor) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except Exception:  # noqa: BLE001 — a storage-less tensor aliases nothing
        return id(t)


@contextlib.contextmanager
def record() -> Iterator[Recorder]:
    """Record every hooked op this thread issues inside the block (one
    recorder a thread at a time: a nested block raises)."""
    me = threading.get_ident()
    if me in _ACTIVE:
        raise RuntimeError("launchcheck.record() does not nest")
    rec = Recorder()
    _ACTIVE[me] = rec
    try:
        yield rec
    finally:
        del _ACTIVE[me]


def _current() -> Optional[Recorder]:
    """This thread's recorder, or None."""
    return _ACTIVE.get(threading.get_ident()) if _ACTIVE else None


def active() -> bool:
    return _current() is not None


def note(op: str, reads=(), writes=(), **kw) -> None:
    """Append one op (a stepper's kernel, interior, shell, splice, band or
    put; a member repack's move) when recording; nothing else
    otherwise."""
    rec = _current()
    if rec is not None:
        rec.add(op, reads, writes, **kw)


def note_post(transport: str, hi, lo, mesh, axis: int,
              shards: int) -> Optional[Record]:
    """A transport's ``post``: the record its pending shift's ``wait``
    refers back to (None when not recording)."""
    rec = _current()
    if rec is None:
        return None
    payload = 0
    if hi and lo:
        payload = hi[0].numel() * hi[0].element_size() \
            + lo[0].numel() * lo[0].element_size()
    return rec.add("post", reads=(hi, lo), axis=axis, mesh=id(mesh),
                       mesh_shape=tuple(mesh.shape), shards=int(shards),
                       transport=transport, bytes=payload)


def note_wait(posted: Optional[Record], pair) -> None:
    """A pending shift's ``wait``: its received slabs are what it writes."""
    rec = _current()
    if rec is None or posted is None:
        return
    rec.add("wait", writes=pair, axis=posted.axis, mesh=posted.mesh,
                mesh_shape=posted.mesh_shape, shards=posted.shards,
                transport=posted.transport,
                attrs={"post": posted.index})


def side_scope():
    """Mark the ops issued inside as the side stream's (the overlapped
    steps' exchange copies); a null context when not recording."""
    rec = _current()
    if rec is None:
        return contextlib.nullcontext()
    return _scoped(rec._stream, "side")


def tag(**attrs):
    """Attach ``attrs`` (a coupled run's ``group`` or ``phase``) to every
    record made inside; a null context when not recording."""
    rec = _current()
    if rec is None:
        return contextlib.nullcontext()
    return _scoped(rec._tags, attrs)


@contextlib.contextmanager
def _scoped(stack: list, value):
    stack.append(value)
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------- counts


def exchange_posts(records: Sequence[Record],
                   transport: Optional[str] = None) -> List[Record]:
    return [r for r in records if r.op == "post" and r.shards > 1
            and (transport is None or r.transport == transport)]


def count_exchange_rounds(records: Sequence[Record],
                          exchange: str = "ppermute") -> int:
    """Exchange rounds of a recorded sequence, counted as the TPU package
    counts them: two ``ppermute`` rounds an exchange post (the slab pair),
    or for ``exchange="rdma"`` the ring-exchange launches."""
    if exchange == "rdma":
        return sum(1 for r in records if r.op == "ring")
    return 2 * len(exchange_posts(records))


def exchange_counts(records: Sequence[Record]) -> Dict[str, int]:
    """What a recorded pass exchanged, in ``costmodel.comm_stats``'s units:
    ``ppermute_rounds`` (two a non-ring exchange post), ``ici_bytes`` (one
    shard's payload over every exchange post, ring posts included) and
    ``ring_calls`` (ring-exchange launches)."""
    posts = exchange_posts(records)
    return {
        "ppermute_rounds": 2 * sum(1 for r in posts if r.transport != "rdma"),
        "ici_bytes": sum(r.bytes for r in posts),
        "ring_calls": sum(1 for r in records if r.op == "ring"),
        "posts": len(posts),
    }


# ---------------------------------------------------------------- checks


def interior_exchange_independence(
    records: Sequence[Record], exchange: str = "ppermute"
) -> Dict[str, object]:
    """Two-sided independence report between the interior launches and
    the exchange of a recorded pass.

    ``interior_depends_on_exchange``: an exchange ``wait`` comes before an
    interior, or an interior reads a tensor a ``wait`` gave.
    ``exchange_depends_on_interior``: an exchange ``post`` after an
    interior reads storage that interior wrote.  ``posts_before_interior``
    counts the exchange posts issued before the first interior, and
    ``interior_between_side_post_and_wait`` says whether the interior ran
    on the main stream after a side-stream post and before a side-stream
    wait (on the card, also on another CUDA stream than the posts).
    ``n_ppermute`` keeps the TPU package's key: the exchange rounds.
    Raises ``AssertionError`` when no exchange or no interior was recorded
    (a structural check against the wrong sequence means nothing)."""
    posts = [r for r in records if r.op == "post" and r.shards > 1]
    waits = [r for r in records if r.op == "wait" and r.shards > 1]
    interiors = [r for r in records if r.op == "interior"]
    assert posts or waits, ("no exchange anywhere: the recorded pass did "
                            "not exchange at all")
    assert interiors, "no interior launch in the recorded pass"
    first = min(r.index for r in interiors)
    last = max(r.index for r in interiors)
    waited = set()
    for w in waits:
        waited.update(w.writes)
    read_by_interior = set()
    written_by_interior = set()
    for r in interiors:
        read_by_interior.update(r.reads)
        written_by_interior.update(r.write_storage)
    depends = any(w.index < last for w in waits) \
        or bool(read_by_interior & waited)
    feeds = any(p.index > first and p.read_storage & written_by_interior
                for p in posts)
    before = [p for p in posts if p.index < first]
    after = [w for w in waits if w.index > last]
    between = (any(p.stream == "side" for p in before)
               and all(i.stream == "main" for i in interiors)
               and any(w.stream == "side" for w in after))
    if between and any(p.stream_id for p in before):
        between = all(i.stream_id not in {p.stream_id for p in before}
                      for i in interiors)
    return {
        "n_ppermute": count_exchange_rounds(records, exchange),
        "interior_depends_on_exchange": depends,
        "exchange_depends_on_interior": feeds,
        "posts_before_interior": len(before),
        "interior_between_side_post_and_wait": between,
    }


def assert_interior_overlaps_exchange(records: Sequence[Record],
                                      exchange: str = "ppermute"
                                      ) -> Dict[str, object]:
    """The overlapped step's promise on one recorded pass: the interior is
    launched after the pass's exchange post and before its wait, on the
    main stream while the side stream carries the exchange, and reads
    nothing a wait gave."""
    rep = interior_exchange_independence(records, exchange)
    assert rep["posts_before_interior"] > 0, (
        "the interior was launched before the pass posted its exchange")
    assert not rep["interior_depends_on_exchange"], (
        "the interior waits on (or reads) the exchange: it must run on its "
        "own operands while the exchange is in flight")
    assert not rep["exchange_depends_on_interior"], (
        "an exchange post reads the interior's output")
    assert rep["interior_between_side_post_and_wait"], (
        "the interior did not run on the main stream between the side "
        "stream's post and its wait")
    return rep


def _record_call(fn, *args, **kw):
    with record() as rec:
        out = fn(*args, **kw)
    return out, rec.records


def assert_pipeline_body_structure(
    pipelined_step,
    plain_step,
    fields,
    overlap: bool,
    exchange: str = "ppermute",
) -> Dict[str, object]:
    """The pipelined body's contract on one recorded body pass.

    ``pipelined_step`` carries ``_pipeline_prologue`` / ``_pipeline_body``;
    ``plain_step`` is the same configuration without the pipeline, whose
    one recorded call defines "one exchange round".  The body (the carry
    posted outside the record) must issue exactly as many exchange rounds;
    for ``exchange="rdma"`` both are also free of non-ring exchange posts.
    With ``overlap`` the body's interior neither waits on nor reads the
    exchange, and the exchange it posts for the next pass reads no storage
    the interior wrote (it is posted from the shells' outputs)."""
    carry = pipelined_step._pipeline_prologue(fields)
    (out, carry_next), body = _record_call(
        pipelined_step._pipeline_body, fields, carry)
    if carry_next is not None:
        carry_next.wait()
    del out
    _, plain = _record_call(plain_step, fields)
    n_body = count_exchange_rounds(body, exchange)
    n_plain = count_exchange_rounds(plain, exchange)
    assert n_body == n_plain > 0, (
        f"pipelined body issues {n_body} exchange round(s) per pass, the "
        f"non-pipelined step {n_plain}: the slab carry must move the "
        "exchange, not duplicate or drop transfers")
    if exchange == "rdma":
        for recs in (body, plain):
            n = len([r for r in exchange_posts(recs)
                     if r.transport != "rdma"])
            assert n == 0, (
                f"rdma pipelined structure check found {n} in-process or "
                "distributed shift(s): the ring exchange must carry them "
                "all")
    report: Dict[str, object] = {"n_ppermute": n_body}
    if overlap:
        rep = interior_exchange_independence(body, exchange)
        assert not rep["interior_depends_on_exchange"], (
            "interior(i) consumes an exchange output: the carried slabs "
            "must be the only exchanged data a pass reads")
        assert not rep["exchange_depends_on_interior"], (
            "the exchange feeding pass i+1 reads interior(i): the next "
            "slabs must come from the shell outputs, not the spliced "
            "blocks")
        report.update(rep)
    return report


def assert_rdma_step_structure(records: Sequence[Record],
                               expected_calls: Optional[int] = None
                               ) -> Dict[str, int]:
    """The rdma pass's gate: no in-process or distributed exchange shift
    at all, and one ring-exchange launch for every ring shift (per site
    and field; ``expected_calls``, e.g. ``comm_stats``'s
    ``rdma_exchange_calls_per_pass``, pins the total).  A pass with no
    ring launch fails: it did not exchange."""
    other = [r for r in exchange_posts(records) if r.transport != "rdma"]
    rings = [r for r in records if r.op == "ring"]
    ring_posts = exchange_posts(records, "rdma")
    assert not other, (
        f"rdma pass contains {len(other)} {other[0].transport} shift(s): "
        "the ring exchange must replace every in-process or distributed "
        "shift")
    assert rings, "rdma pass launched no ring exchange: it did not exchange"
    assert len(rings) == len(ring_posts), (
        f"{len(rings)} ring launch(es) for {len(ring_posts)} ring "
        "shift(s): one launch a site and field")
    if expected_calls is not None:
        assert len(rings) == expected_calls, (
            f"{len(rings)} ring launch(es), the cost model prices "
            f"{expected_calls}")
    return {"n_ppermute": 0, "n_ring": len(rings),
            "n_ring_posts": len(ring_posts)}


def assert_ensemble_exchange_invariance(
    batched: Sequence[Record],
    single: Sequence[Record],
    exchange: str = "ppermute",
) -> Dict[str, int]:
    """The batched step issues exactly as many exchange rounds as the
    unbatched one, whatever N: the member axis rides inside each shift's
    slabs, never unrolled into one shift a member."""
    n_batched = count_exchange_rounds(batched, exchange)
    n_single = count_exchange_rounds(single, exchange)
    assert n_single > 0, (
        "the unbatched step contains no exchange: an invariance check "
        "against an exchange-free sequence is meaningless")
    assert n_batched == n_single, (
        f"batched step issues {n_batched} exchange round(s), the unbatched "
        f"step {n_single}: the member axis must ride inside each shift")
    if exchange == "rdma":
        n = len([r for r in exchange_posts(batched)
                 if r.transport != "rdma"])
        assert n == 0, ("batched rdma step contains an in-process shift: "
                        "the ring must carry every shift at any N")
    return {"n_exchange_batched": n_batched, "n_exchange_single": n_single}


def assert_coupled_structure(records: Sequence[Record],
                             sharded_groups: Sequence[int],
                             group_meshes: Sequence[int] = (),
                             transport: str = "device_put"
                             ) -> Dict[str, object]:
    """The coupling gate on one recorded coupled round: interface bands
    are the only traffic between groups.

    1. A sharded group's step exchanges its own halos (at least one
       exchange post) and a single-shard group's step exchanges nothing.
    2. Every exchange of a group's step names that group's own mesh
       (``group_meshes``: the meshes' ids), so none reaches another group.
    3. Under ``device_put`` the interface refresh shifts nothing: it moves
       bands by device copies; under ``collective`` its shifts are the
       wire's (:func:`assert_group_transport_structure`)."""
    sharded = set(int(i) for i in sharded_groups)
    groups = sorted({r.attrs["group"] for r in records
                     if "group" in r.attrs})
    group_pp = []
    for g in groups:
        posts = exchange_posts([r for r in records
                                if r.attrs.get("group") == g])
        if g in sharded:
            assert posts, (
                f"coupled group {g} is sharded but its step posted no "
                "exchange: the group did not exchange its own halos")
        else:
            assert not posts, (
                f"coupled group {g} is single-shard but its step posted "
                f"{len(posts)} exchange(s)")
        if group_meshes:
            alien = [p for p in posts if p.mesh != group_meshes[g]]
            assert not alien, (
                f"coupled group {g} exchanged over another mesh than its "
                "own: an exchange crossed groups")
        group_pp.append(2 * len(posts))
    iface = [r for r in records if r.attrs.get("phase") == "interface"]
    n_iface_posts = len(exchange_posts(iface))
    if transport != "collective":
        assert n_iface_posts == 0, (
            f"the device_put interface refresh posted {n_iface_posts} "
            "shift(s): bands move by device copies only")
    return {"group_ppermute": group_pp, "n_groups": len(groups),
            "interface_posts": n_iface_posts,
            "interface_puts": sum(1 for r in iface if r.op == "put")}


def assert_group_transport_structure(records: Sequence[Record],
                                     n_interfaces: int) -> Dict[str, object]:
    """The collective interface transport's gate on one recorded round:
    no host-mediated band copy, and exactly ``2 * n_interfaces`` wire
    shifts (one an interface and direction)."""
    iface = [r for r in records if r.attrs.get("phase") == "interface"]
    puts = [r for r in iface if r.op == "put"]
    assert not puts, (
        f"collective group transport made {len(puts)} host-mediated band "
        "copies: the coupled exchange must never take a host hop")
    posts = exchange_posts(iface)
    assert len(posts) == 2 * n_interfaces, (
        f"collective transport posted {len(posts)} shift(s), expected "
        f"exactly {2 * n_interfaces} (one an interface and direction "
        f"across {n_interfaces} interface(s))")
    return {"n_ppermute": len(posts), "n_device_put": len(puts),
            "n_interfaces": n_interfaces}


# ---------------------------------------------------------- entry points


def _devices(n: int, device) -> list:
    return [torch.device(device)] * n


def check_pipeline_structure(
    stencil_name: str = "heat3d",
    grid: Tuple[int, int, int] = (32, 16, 128),
    mesh_shape: Tuple[int, ...] = (2, 1, 1),
    k: int = 4,
    kind: Optional[str] = "padfree",
    exchange: str = "ppermute",
    device="cpu",
) -> Dict[str, object]:
    """Build a pipelined + overlapped step and its plain twin, then run the
    whole assertion set on recorded passes (``exchange="rdma"`` forces the
    stream kind and adds the rdma gate on the plain step's pass)."""
    import math

    from .. import make_stencil
    from ..parallel.mesh import make_mesh
    from ..parallel.stepper import make_sharded_fused_step, shard_fields
    from .init import init_state

    if exchange == "rdma":
        kind = "stream"
    st = make_stencil(stencil_name)
    mesh = make_mesh(mesh_shape, _devices(math.prod(mesh_shape), device))

    def mk(pipe):
        return make_sharded_fused_step(
            st, mesh, grid, k, kind=kind, overlap=True, pipeline=pipe,
            exchange=exchange, device=device)

    pipelined, plain = mk(True), mk(False)
    assert pipelined is not None and plain is not None, (
        stencil_name, grid, mesh_shape)
    assert getattr(pipelined, "_pipeline_active", False)
    assert getattr(pipelined, "_overlap_active", False), \
        "overlap geometry declined: pick a shape hosting the split"
    fields = shard_fields(init_state(st, grid, seed=3, kind="pulse",
                                     device=device), mesh, 3)
    report = assert_pipeline_body_structure(
        pipelined, plain, fields, overlap=True, exchange=exchange)
    _, recs = _record_call(plain, fields)
    report["plain"] = assert_interior_overlaps_exchange(recs, exchange)
    if exchange == "rdma":
        report["rdma"] = assert_rdma_step_structure(recs)
    return report


def check_ensemble_structure(
    stencil_name: str = "heat3d",
    grid: Tuple[int, int, int] = (32, 16, 128),
    mesh_shape: Tuple[int, ...] = (2, 1, 1),
    k: int = 4,
    ensemble: int = 4,
    kind: Optional[str] = "padfree",
    exchange: str = "ppermute",
    device="cpu",
) -> Dict[str, object]:
    """Build the batched and unbatched sharded fused steps and hold their
    recorded exchange rounds equal."""
    import math

    from .. import make_stencil
    from ..parallel.mesh import make_mesh
    from ..parallel.stepper import make_sharded_fused_step, shard_fields
    from .init import init_state

    if exchange == "rdma":
        kind = "stream"
    st = make_stencil(stencil_name)
    mesh = make_mesh(mesh_shape, _devices(math.prod(mesh_shape), device))

    def mk(ens):
        return make_sharded_fused_step(st, mesh, grid, k, kind=kind,
                                       exchange=exchange, ensemble=ens,
                                       device=device)

    batched, single = mk(ensemble), mk(0)
    assert batched is not None and single is not None, (
        stencil_name, grid, mesh_shape)
    one = init_state(st, grid, seed=3, kind="pulse", device=device)
    many = init_state(st, grid, seed=3, kind="pulse", device=device,
                      ensemble=ensemble)
    _, rb = _record_call(batched, shard_fields(many, mesh, 3, ensemble=True))
    _, rs = _record_call(single, shard_fields(one, mesh, 3))
    report = assert_ensemble_exchange_invariance(rb, rs, exchange)
    report["ensemble"] = ensemble
    return report


def record_coupled_round(runner) -> List[Record]:
    """One coupled round of ``runner`` (``CoupledRunner``), recorded."""
    with record() as rec:
        runner.step_round()
    return rec.records


def check_coupled_structure(
    groups: str = "heat3d@0-3,heat3d@4-7",
    grid: Tuple[int, ...] = (30, 16, 16),
    transport: str = "device_put",
    device="cpu",
    n_devices: int = 8,
) -> Dict[str, object]:
    """Build a coupled runner, record one round and run the coupling gate
    (with ``transport="collective"`` the transport gate too)."""
    from ..parallel import groups as groups_lib

    plans = groups_lib.plans_from_config(groups, grid, n_devices=n_devices)
    runner = groups_lib.CoupledRunner(plans, transport=transport,
                                      device=device)
    recs = record_coupled_round(runner)
    report = assert_coupled_structure(
        recs, runner.sharded_group_indices(),
        [id(m) for m in runner.meshes], transport)
    if transport == "collective":
        report.update(assert_group_transport_structure(
            recs, len(plans) - 1))
    report["groups"] = [p.name for p in plans]
    report["transport"] = transport
    return report


def check_group_transport_structure(
    groups: str = "heat3d@0-3,heat3d@4-7",
    grid: Tuple[int, ...] = (30, 16, 16),
    device="cpu",
    n_devices: int = 8,
) -> Dict[str, object]:
    """:func:`check_coupled_structure` under the collective transport."""
    return check_coupled_structure(groups, grid, "collective", device,
                                   n_devices)


# the ops of a member repack (``parallel/reshard.py``): the local form's
# gather of the surviving slots into the zeroed destination block, and the
# collective form's rounds, each a transport move between member-shard
# blocks or, for an identity round, a copy inside each block
REPACK_OPS = ("repack_move", "member_post", "repack_stay")
# ops that hold a whole field on one device: a host gather of a sharded
# field (``stepper.gather_fields``) or an all-gather
GATHER_OPS = ("gather", "all_gather")


def assert_member_repack_structure(records: Sequence[Record], plan,
                                   n_fields: int,
                                   grid_shape: Tuple[int, ...] = ()
                                   ) -> Dict[str, int]:
    """The serving defrag gate, the counterpart of the TPU package's
    ``jaxprcheck.assert_member_repack_structure``: re-packing occupied
    member slots (``parallel/reshard.repack_members``) moves state device
    to device only.

    1. **No gather** — the recorded sequence holds no ``gather`` /
       ``all_gather``: defrag never collects the member axis (or the grid)
       in one place.
    2. **Exact round count**: ``plan.n_comm_rounds`` transport rounds
       (``member_post``) a field.  A plan whose member axis is not split
       over member shards schedules none: the local form is pinned too.
    3. **No full-member-axis block**: when the plan runs on a mesh of
       more than one shard, every tensor a record touches holds fewer
       elements than the larger of the two global fields (members x
       grid).

    The sequence must hold the repack's moves (one record at least a
    field when the plan moves a slot)."""
    gathers = [r for r in records if r.op in GATHER_OPS]
    assert not gathers, (
        f"member-repack sequence holds {len(gathers)} gather op(s) "
        f"({gathers[0].op!r} at record {gathers[0].index}) — defrag must "
        "never collect state in one place")
    n_rounds = sum(1 for r in records if r.op == "member_post")
    expected = plan.n_comm_rounds * n_fields
    assert n_rounds == expected, (
        f"member-repack sequence holds {n_rounds} transport round(s), the "
        f"plan schedules {expected} ({plan.n_comm_rounds} non-identity "
        f"round(s) x {n_fields} field(s))")
    moves = [r for r in records if r.op in REPACK_OPS]
    if plan.slot_map:
        fields = {r.attrs.get("field") for r in moves}
        assert len(fields) >= n_fields, (
            f"member-repack sequence moves {len(fields)} field(s), not "
            f"{n_fields}: the repack was not recorded")
    cells = 1
    for s in grid_shape:
        cells *= int(s)
    max_global = max(plan.n_src, plan.n_dst) * cells
    max_local = 0
    if plan.mesh is not None and plan.mesh.size > 1:
        for r in records:
            max_local = max(max_local, r.max_elems)
            assert r.max_elems < max_global, (
                f"member-repack record {r.index} ({r.op!r}) touches a "
                f"tensor of {r.max_elems} elements >= the global field "
                f"({max_global}): a device held the whole member axis")
    return {"n_rounds": n_rounds, "n_gathers": len(gathers),
            "max_local_elems": max_local, "global_size": max_global}
