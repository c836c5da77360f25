"""Live state migration without a host gather: the member-axis repack.

The port of the TPU package's ``parallel/reshard.py``, its member repack
only: the serving layer's defragmentation primitive
(``serving/scheduler.py``).  A resident size class re-packs its OCCUPIED
member slots into a (possibly smaller or larger) member axis at a chunk
boundary — tenants move, ballast is dropped, the capacity ladder grows or
shrinks — without a checkpoint round-trip and without a host gather.
``ReshardPlan`` and ``reshard_fields`` (a relayout between two spatial
meshes) wait for ``--policy-recheck`` (ROADMAP A8, policy).

How the plan works (host side, pure numpy/python), as in the TPU package:

* When the member axis is not split over member shards (``Mesh.ensemble``
  of 1, or no mesh: every serving class, whose ``ensemble_mesh`` is per
  job and resets to 0), the plan is the **local form**: in each block, one
  gather of the surviving slots into a zeroed ``(n_dst, *block)`` buffer.
* When it is split over E member shards (the ensemble groups of a
  ``--ensemble-mesh`` layout), slot moves are an arbitrary partial
  injection between groups.  The move multigraph over groups is padded to
  Δ-regularity with dummy, diagonal-preferring edges and decomposed into Δ
  perfect matchings (augmenting paths); each matching is one **round** in
  which every group sends one slot and receives one.  A non-identity round
  is one in-process transport move between the member-shard blocks of each
  spatial coordinate (``halo.InProcessTransport.permute_groups``); an
  identity round copies inside each block.  Dummy receives are masked by
  the round's ``real`` table, so no occupied slot is clobbered.

Every move is device to device: nothing is read to the host, and no block
ever holds the whole member axis (``utils/launchcheck.
assert_member_repack_structure`` checks a recorded repack).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import launchcheck
from .halo import InProcessTransport
from .mesh import Mesh
from .stepper import ShardedField


class _Round:
    """One matching: the transport pairs + per-group slot tables."""

    __slots__ = ("perm", "send", "recv", "identity")

    def __init__(self, perm, send, recv):
        self.perm = tuple(perm)
        self.send = np.asarray(send, np.int32)
        self.recv = np.asarray(recv, np.int32)
        self.identity = all(i == j for i, j in self.perm)


def _perfect_matching(count: np.ndarray) -> List[int]:
    """One perfect matching of the remaining move multigraph (Kuhn's
    augmenting paths; regularity guarantees existence).  ``count[i, j]``
    = slots still to move from group i to group j.  Prefers the diagonal
    so stay-local moves batch into identity (transport-free) rounds.
    Returns ``match[i] = j``."""
    D = count.shape[0]
    owner = [-1] * D  # target j -> source i

    def order(i):
        return [i] + [j for j in range(D) if j != i]

    def augment(i, seen):
        for j in order(i):
            if count[i, j] > 0 and j not in seen:
                seen.add(j)
                if owner[j] < 0 or augment(owner[j], seen):
                    owner[j] = i
                    return True
        return False

    for i in range(D):
        if not augment(i, set()):
            raise RuntimeError(
                "no perfect matching — the move graph lost regularity "
                "(planner invariant violated)")
    match = [-1] * D
    for j, i in enumerate(owner):
        match[i] = j
    return match


class _MemberRound(_Round):
    """A matching over member-shard groups; ``real[g]`` masks dummy
    (padding) receives so they never overwrite occupied slots."""

    __slots__ = ("real",)

    def __init__(self, perm, send, recv, real):
        super().__init__(perm, send, recv)
        self.real = np.asarray(real, np.int32)


class MemberRepackPlan:
    """Host-side plan moving member slot ``s`` -> ``slot_map[s]`` from a
    ``(n_src, *grid)`` field into a ``(n_dst, *grid)`` field.  Slots not
    in ``slot_map`` are dropped; destination slots not hit stay zero
    (scrubbed ballast — exactly what the scheduler writes on retire).

    ``rounds`` are the collective form's matchings (none in the local
    form); ``n_comm_rounds`` counts the non-identity ones, the transport
    moves a field."""

    def __init__(self, n_src: int, n_dst: int, slot_map: Dict[int, int],
                 mesh: Optional[Mesh] = None, grid_ndim: int = 0):
        self.n_src, self.n_dst = int(n_src), int(n_dst)
        self.mesh, self.grid_ndim = mesh, int(grid_ndim)
        items = sorted((int(k), int(v)) for k, v in slot_map.items())
        if len({v for _, v in items}) != len(items):
            raise ValueError("slot_map destinations must be unique")
        for s, d in items:
            if not 0 <= s < self.n_src:
                raise ValueError(f"source slot {s} outside [0, {n_src})")
            if not 0 <= d < self.n_dst:
                raise ValueError(f"dest slot {d} outside [0, {n_dst})")
        self.slot_map = dict(items)

        shards = mesh.ensemble if mesh is not None else 1
        self.member_shards = shards
        if shards > 1 and (self.n_src % shards or self.n_dst % shards):
            raise ValueError(
                f"member axis ({self.n_src}->{self.n_dst}) must divide "
                f"the {shards} member shards on both sides")
        self.src_local = self.n_src // shards
        self.dst_local = self.n_dst // shards
        self.collective = shards > 1
        self.rounds = self._decompose() if self.collective else []
        self.n_comm_rounds = sum(1 for r in self.rounds if not r.identity)

    def _decompose(self) -> List[_MemberRound]:
        E, Ls, Ld = self.member_shards, self.src_local, self.dst_local
        piles: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        count = np.zeros((E, E), np.int64)
        for s_old, s_new in self.slot_map.items():
            gi, sl = divmod(s_old, Ls)
            gj, rl = divmod(s_new, Ld)
            piles.setdefault((gi, gj), []).append((sl, rl))
            count[gi, gj] += 1
        delta = int(max(count.sum(1).max(initial=0),
                        count.sum(0).max(initial=0)))
        if delta == 0:
            return []
        # Pad the multigraph to Δ-regularity.  Dummy edges prefer the
        # diagonal (i == i) so padding lands in identity rounds and
        # costs no transport; any deficit pair keeps Hall's condition.
        for i in range(E):
            while count[i].sum() < delta and delta - count[:, i].sum() > 0:
                count[i, i] += 1
        for i in range(E):
            while count[i].sum() < delta:
                j = int(np.argmax(delta - count.sum(0)))
                count[i, j] += 1
        rounds: List[_MemberRound] = []
        for _ in range(delta):
            match = _perfect_matching(count)
            perm, send, recv, real = [], [0] * E, [0] * E, [0] * E
            for i in range(E):
                j = match[i]
                pile = piles.get((i, j))
                if pile:
                    sl, rl = pile.pop()
                    real[j] = 1
                else:
                    sl, rl = 0, 0  # dummy: masked off at the receiver
                count[i, j] -= 1
                send[i], recv[j] = sl, rl
                perm.append((i, j))
            rounds.append(_MemberRound(perm, send, recv, real))
        assert not count.any()
        assert not any(piles.values())
        return rounds


def plan_member_repack(n_src: int, n_dst: int, slot_map: Dict[int, int],
                       mesh: Optional[Mesh] = None,
                       grid_ndim: int = 0) -> MemberRepackPlan:
    """Build the member-axis defrag plan (see :class:`MemberRepackPlan`)."""
    return MemberRepackPlan(n_src, n_dst, slot_map, mesh, grid_ndim)


def _local_block(x: torch.Tensor, plan: MemberRepackPlan, k: int,
                 src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The local form on one block: one gather of the surviving slots into
    a zeroed ``(dst_local, *block)`` buffer."""
    buf = x.new_zeros((plan.dst_local,) + tuple(x.shape[1:]))
    if len(src):
        buf.index_copy_(0, dst.to(x.device), x.index_select(
            0, src.to(x.device)))
    launchcheck.note("repack_move", reads=x, writes=buf,
                     attrs={"field": k, "form": "local"})
    return buf


def _collective_field(f: ShardedField, plan: MemberRepackPlan, k: int,
                      transport: InProcessTransport) -> List[torch.Tensor]:
    """The collective form on one field's blocks: each round a transport
    move between the member-shard blocks of every spatial coordinate (or,
    for an identity round, a copy inside each block), masked by ``real``."""
    mesh = f.mesh
    coords = mesh.local_coords()
    groups = [mesh.group(c) for c in coords]
    bufs = [b.new_zeros((plan.dst_local,) + tuple(b.shape[1:])) for b in f]
    for r, rnd in enumerate(plan.rounds):
        slabs = [b[int(rnd.send[g])] for b, g in zip(f, groups)]
        if rnd.identity:
            got = slabs
            launchcheck.note("repack_stay", reads=slabs, writes=bufs,
                             attrs={"field": k, "round": r})
        else:
            got = transport.permute_groups(slabs, mesh, rnd.perm,
                                           attrs={"field": k, "round": r})
        for buf, g, s in zip(bufs, groups, got):
            if rnd.real[g]:
                buf[int(rnd.recv[g])].copy_(s)
    return bufs


def make_member_repack(plan: MemberRepackPlan, n_fields: int):
    """The defrag executor: ``fn(fields) -> fields`` with the member axis
    re-packed to ``n_dst`` slots.  Pure data movement per surviving slot
    (bit-exact, any dtype); dropped slots vanish, untouched destination
    slots are zeros.  Takes whole ``(n_src, *grid)`` tensors, or batched
    sharded fields (``ShardedField`` with ``lead`` 1) block by block."""
    moves = sorted(plan.slot_map.items())
    src = torch.tensor([s for s, _ in moves], dtype=torch.int64)
    dst = torch.tensor([d for _, d in moves], dtype=torch.int64)
    transport = InProcessTransport()

    def one(f, k):
        if not isinstance(f, ShardedField):
            return _local_block(f, plan, k, src, dst)
        if f.mesh.multiprocess:
            raise NotImplementedError(
                "the member repack runs over the blocks of one process "
                "(the serving engine runs in one process)")
        if plan.collective:
            blocks = _collective_field(f, plan, k, transport)
        else:
            blocks = [_local_block(b, plan, k, src, dst) for b in f]
        return ShardedField(blocks, f.mesh,
                            (plan.n_dst,) + f.global_shape[1:], lead=1)

    def fn(fields):
        fields = tuple(fields)
        if len(fields) != n_fields:
            raise ValueError(f"expected {n_fields} field(s), got "
                             f"{len(fields)}")
        return tuple(one(f, k) for k, f in enumerate(fields))

    return fn


def repack_members(fields, slot_map: Dict[int, int], n_dst: int,
                   mesh: Optional[Mesh] = None,
                   grid_ndim: Optional[int] = None):
    """Re-pack the leading member axis of ``fields`` to ``n_dst`` slots,
    moving slot ``s`` -> ``slot_map[s]`` and dropping the rest.  ``mesh``
    defaults to the fields' own (None for whole tensors).  The serving
    layer calls this at most once a ladder move, never a chunk."""
    fields = tuple(fields)
    f0 = fields[0]
    if mesh is None:
        mesh = getattr(f0, "mesh", None)
    shape = tuple(getattr(f0, "global_shape", None) or f0.shape)
    if grid_ndim is None:
        grid_ndim = len(shape) - 1
    plan = plan_member_repack(shape[0], n_dst, slot_map, mesh, grid_ndim)
    return make_member_repack(plan, len(fields))(fields)
