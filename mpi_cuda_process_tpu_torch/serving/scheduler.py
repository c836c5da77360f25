"""Continuous-batching scheduler: many tenants, one resident card.

The port of the TPU package's ``serving/scheduler.py``.
``engine.SimulationEngine`` runs one config at a time: every submit builds
its own step and the card idles between requests.  This module keeps ONE
batched step per *size class* resident and treats its MEMBER axis as the
slot pool: an arriving job joins a free member slot at the next chunk
boundary, leaves at the boundary where it completes, and the step never
stops while work remains — the continuous-batching discipline of LLM
serving, applied to stencil simulation.

Why this is sound: every kernel of a batched step takes a block's members
in one launch, each member bit-equal to its own solo run (the
``--ensemble`` kernels), so a slot seeded with a job's own solo initial state computes
exactly the job's solo trajectory — isolation is a property of the step,
not a scheduler promise.  The spatial grid is never padded (that would
change the physics); only the member count is, from a small fixed
capacity ladder (default 1/2/4/8), each rung built once and kept resident
(the class's steps and runners are cached by capacity), so occupancy
changes build nothing at a rung already reached.

Mechanics, per class thread, at every chunk boundary (the only place
state is complete on the host's side of a synchronize):

* retire jobs whose remaining steps hit zero (copy the member's solo
  fields out — the next chunk's launches write new buffers, and a later
  tenant's init writes this slot — write the job's ``summary``, resolve
  its handle);
* honor cooperative cancels (``RunHandle.cancel``: the job ends with a
  ``cancelled`` event, never an ``error``);
* evict diverged members: one non-finite count over every slot (one
  reduction a field and block, one host read) turns the DIVERGED verdict
  into the eviction signal — the poisoned slot is recycled, the other
  tenants never see it;
* admit waiters into free slots (weighted FIFO: highest priority wins,
  FIFO among equals, and any waiter older than ``starvation_rounds``
  boundaries is served strictly FIFO ahead of priority — the starvation
  bound);
* preempt: when no slot is free and the class cannot grow, a starved or
  higher-priority waiter checkpoints the lowest-priority runner out (the
  ``npy`` checkpoint); the victim re-queues and resumes from its
  checkpoint, losing no completed chunk;
* grow: build at the next ladder rung (budget-priced first) and migrate
  occupied members — one build a rung, kept for every later job;
* shrink: after ``shrink_after_rounds`` consecutive boundaries whose
  occupancy fits the rung below (and nobody waits), the class releases
  the rung — occupied members defragment to the lowest slots through the
  member-axis repack (``parallel/reshard.repack_members``): device-to-
  device moves only, bit-exact per tenant, never a checkpoint round-trip,
  never a host gather (each repack is recorded and held to
  ``utils/launchcheck.assert_member_repack_structure``).  Grow rides the
  same path.

Chunk sizes are powers of two <= min(remaining over occupied slots,
cadence), so each class needs at most log2(cadence)+1 distinct chunk
lengths a capacity — each a resident runner (``driver.make_runner``)
built once.  Admission is priced by ``utils/budget.py`` BEFORE a job is
accepted, a new class or a grow against what the resident classes hold
(reject with the arithmetic, never run out of memory), and every
scheduling decision is emitted as a ``scheduler`` telemetry event that
``obs/metrics.py`` folds into ``/status.json`` for the live console.

One card: device work (builds, chunks, repacks, slot writes) is
serialized by the engine's step lock — classes interleave chunks, they
never overlap them — so the kernels' launch counters and the runtime
observer see one class at a time; a router's replicas share one step lock
for the same reason.  A class whose kernel fails to build or launch is
dead: its jobs fail, and nothing re-runs them on another path.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import cancellation
from ..config import RunConfig
from ..engine import RunHandle
from .admission import AdmissionController, AdmissionError
from .sizeclass import (class_config, class_signature, ladder_rung,
                        next_rung, prev_rung)

__all__ = ["ServeHandle", "ServingEngine", "serve_engine_main"]

# config fields a slot-resident job cannot honor: launcher modes own a
# process lifecycle, per-job checkpoint/dump/profile/render paths hook
# the solo driver loop, and the --tol runner has no chunk boundaries to
# batch at.  Predicate is truthiness of the field value.
_UNSUPPORTED_FIELDS = (
    "supervise", "serve_port", "serve_engine", "resume",
    "checkpoint_every", "dump_every", "profile", "profile_dir",
    "debug_checks", "halo_audit", "render", "tol",
    "ensemble", "ensemble_mesh", "ensemble_perturb",
)


def _short_sig(sig: str) -> str:
    return hashlib.sha1(sig.encode()).hexdigest()[:8]


class ServeHandle(RunHandle):
    """One tenant job riding a member slot of a resident size class.

    Same face as :class:`~..engine.RunHandle` (``status``/``events``/
    ``result``/``cancel``), plus the queue-resident phases: ``queued``
    -> ``running`` (-> ``preempted`` -> ``running``) -> ``done`` |
    ``cancelled`` | ``evicted`` | ``failed``.  ``result()`` gives the
    job's final fields where its solo ``cli.run`` would leave them (on
    the card, or as sharded fields over the class's mesh) and its
    Mcells/s while resident.
    """

    def __init__(self, run_id: str, config: RunConfig,
                 telemetry_path: str, tenant: str, priority: int,
                 sig: str, seq: int, engine: "ServingEngine"):
        super().__init__(run_id, config, telemetry_path)
        self.tenant = tenant
        self.priority = int(priority)
        self.size_class = sig
        self.class_label = _short_sig(sig)
        self.seq = seq
        self.unit = max(1, config.fuse)
        self.cells = 1
        for g in config.grid:
            self.cells *= int(g)
        self.remaining = int(config.iters)       # real steps left
        self.steps_done = 0
        self.active_wall_s = 0.0                 # wall while resident
        self.slot: Optional[int] = None
        self.enqueued_round: Optional[int] = None
        self.preempt_ckpt: Optional[str] = None
        self.preempt_count = 0
        self.phase_live = "queued"
        self.session = None                      # obs.Session, engine-owned
        self._engine = engine

    def cancel(self) -> bool:
        """Cooperative cancel at the job's next boundary (a queued job
        cancels before ever touching a slot).  Idempotent."""
        if self._done.is_set():
            return False
        self._cancel.set()
        eng = self._engine
        if eng is not None:
            with eng._cv:
                eng._cv.notify_all()
        return True

    def _phase(self) -> str:
        if self.cancelled():
            return "cancelled"
        if self._error is not None:
            from ..obs.health import SimulationDiverged

            return "evicted" if isinstance(self._error,
                                           SimulationDiverged) else "failed"
        if self._done.is_set():
            return "done"
        return self.phase_live


class ResidentClass:
    """One size class: a resident batched step + its member slots.

    Owns one daemon thread running the boundary loop; all shared state
    is mutated under the engine's condition lock, device work under the
    engine's step lock (one card — classes interleave chunks, they never
    overlap them).  ``fields`` is the state the last chunk returned (the
    runner takes the fields it is given): every slot write goes into it.
    """

    def __init__(self, engine: "ServingEngine", sig: str,
                 template: RunConfig, capacity: int):
        self.engine = engine
        self.sig = sig
        self.label = _short_sig(sig)
        # class fields only matter; per-job fields of the template are
        # reset by class_config before any build
        self.template = template
        self.capacity = int(capacity)
        self.unit = max(1, template.fuse)
        self.cadence_units = max(1, engine.cadence // self.unit)
        self.st = None
        self.device = None
        self.fields = None
        self._mesh = None        # the class's device mesh (None: unsharded)
        self._steps: Dict[int, Tuple[Any, Any]] = {}  # capacity -> (step, mesh)
        self.runners: Dict[Tuple[int, int], Any] = {}
        self._warm: set = set()  # (capacity, chunk) already run once
        self.slots: List[Optional[ServeHandle]] = []
        self.rounds = 0          # boundary counter: the starvation clock
        self.low_rounds = 0      # consecutive low-occupancy boundaries
        self.global_step = 0     # real steps advanced since first build
        self.builds = 0          # steps built (ladder rungs reached)
        self.compiles = 0        # runners built (capacity, chunk length)
        # the last chunks (capacity, occupancy, steps, host and device
        # time) and every repack (ms, the plan, its recorded sequence)
        self.chunk_log: "collections.deque" = collections.deque(maxlen=256)
        self.repacks: List[Dict[str, Any]] = []
        self.dead: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serve-class-{self.label}")

    # -- build / grow ---------------------------------------------------

    def _step_for(self, capacity: int):
        """The class's batched step at ``capacity`` members (built on
        first use under the step lock, then kept) and its mesh."""
        from .. import cli

        got = self._steps.get(capacity)
        if got is None:
            st, step_fn, mesh, device = cli.build_step(
                class_config(self.template, capacity))
            self.st, self.device = st, device
            got = self._steps[capacity] = (step_fn, mesh)
            self.builds += 1
        return got

    def _ballast(self, capacity: int, mesh):
        """Zero state at ``capacity`` members: every occupied slot is
        overwritten with its job's own solo state before it computes
        anything a tenant sees."""
        from ..parallel import stepper as stepper_lib

        grid = tuple(self.template.grid)
        st = self.st
        if mesh is None:
            return tuple(torch.zeros((capacity,) + grid, dtype=st.dtype,
                                     device=self.device)
                         for _ in range(st.num_fields))
        n_local = stepper_lib.ensemble_members_local(mesh, capacity)
        local = (n_local,) + tuple(
            g // c for g, c in zip(grid, mesh.counts(len(grid))))
        return tuple(
            stepper_lib.ShardedField(
                [torch.zeros(local, dtype=st.dtype, device=mesh.device(c))
                 for c in mesh.local_coords()], mesh, (capacity,) + grid,
                lead=1)
            for _ in range(st.num_fields))

    def _build(self, capacity: int) -> None:
        """Build the class step at ``capacity`` members with ballast
        state."""
        with self.engine._step_lock:
            _, mesh = self._step_for(capacity)
            fields = self._ballast(capacity, mesh)
        with self.engine._cv:
            self._mesh = mesh
            self.fields = fields
            self.slots = [None] * capacity
            self.capacity = capacity
            self.engine._event("class_build", extra={
                "size_class": self.label, "capacity": capacity})

    def _runner(self, chunk_units: int):
        """The resident runner for this chunk length at the current
        capacity (built on first use, reused for the class's life)."""
        from .. import driver

        key = (self.capacity, chunk_units)
        r = self.runners.get(key)
        if r is None:
            r = driver.make_runner(self._steps[self.capacity][0],
                                   chunk_units)
            self.runners[key] = r
            self.compiles += 1
        return r

    def _migrate(self, capacity: int, op: str) -> None:
        """Move to ``capacity`` and DEFRAGMENT: occupied members re-pack
        to the lowest slots through the member-axis repack plan
        (``parallel/reshard.repack_members``) — device-to-device moves
        only, bit-exact per tenant, never a checkpoint round-trip, never a
        host gather; the repack is recorded and held to
        ``launchcheck.assert_member_repack_structure``.

        ``op`` is ``"grow"`` (which builds the rung's step the first time
        the class reaches it, priced by admission before it is
        attempted) or ``"shrink"`` (release the rung; freed capacity
        re-prices future admissions)."""
        from .. import driver
        from ..parallel import reshard as reshard_lib
        from ..parallel import stepper as stepper_lib
        from ..utils import launchcheck

        eng = self.engine
        # only this class's thread writes its slots, so they hold still
        # without the condition lock (taken after the step lock nowhere:
        # the lock order is the condition lock, then the step lock)
        occupied = [(i, j) for i, j in enumerate(self.slots)
                    if j is not None]
        slot_map = {i: rank for rank, (i, _) in enumerate(occupied)}
        with eng._step_lock:
            _, mesh = self._step_for(capacity)
            grid = tuple(self.template.grid)
            plan = reshard_lib.plan_member_repack(
                self.capacity, capacity, slot_map, mesh=self._mesh,
                grid_ndim=len(grid))
            n_fields = len(self.fields)
            driver.synchronize(self.fields)
            t0 = time.perf_counter()
            with launchcheck.record() as rec:
                fields = reshard_lib.make_member_repack(plan, n_fields)(
                    self.fields)
            driver.synchronize(fields)
            ms = (time.perf_counter() - t0) * 1e3
            if mesh is not None:
                # the rung's step runs on its own mesh object (the same
                # devices and shape): re-tag the blocks onto it
                fields = tuple(stepper_lib.ShardedField(
                    list(f), mesh, f.global_shape, lead=1) for f in fields)
            self.fields = fields
        with eng._cv:
            old = self.capacity
            self.repacks.append({
                "op": op, "size_class": self.label, "from": old,
                "to": capacity, "occupied": len(occupied),
                "ms": round(ms, 6), "plan": plan, "n_fields": n_fields,
                "grid": grid, "records": rec.records})
            self._mesh = mesh
            self.slots = [None] * capacity
            for rank, (_, j) in enumerate(occupied):
                self.slots[rank] = j
                j.slot = rank
            self.capacity = capacity
            self.low_rounds = 0
            if op == "shrink":
                eng.admission.hold(self.sig,
                                   class_config(self.template, capacity))
            eng._event(op, extra={
                "size_class": self.label, "capacity": capacity,
                "occupied": len(occupied), "from_capacity": old,
                "repack_ms": round(ms, 6),
                "comm_rounds": plan.n_comm_rounds})
            eng._cv.notify_all()

    # -- scheduling (all *_locked under engine._cv) ---------------------

    def _waiters_locked(self) -> List[ServeHandle]:
        return [j for j in self.engine._waiting if j.size_class == self.sig]

    def _occupied_locked(self) -> List[ServeHandle]:
        return [j for j in self.slots if j is not None]

    def _starved_locked(self, waiters: List[ServeHandle]):
        return [j for j in waiters
                if j.enqueued_round is not None
                and self.rounds - j.enqueued_round
                >= self.engine.starvation_rounds]

    def _pick_locked(self, waiters: List[ServeHandle]) -> ServeHandle:
        """Weighted FIFO with a starvation bound: any waiter older than
        ``starvation_rounds`` boundaries is served strictly FIFO ahead
        of priority; otherwise highest priority, FIFO among equals."""
        starved = self._starved_locked(waiters)
        if starved:
            return min(starved, key=lambda j: j.seq)
        return max(waiters, key=lambda j: (j.priority, -j.seq))

    def _can_grow_locked(self) -> Optional[int]:
        nxt = next_rung(self.engine.ladder, self.capacity)
        if nxt == self.capacity:
            return None
        try:   # admitted, the class holds the rung's bytes from now on
            self.engine.admission.admit_or_raise(
                class_config(self.template, nxt), holder=self.sig)
        except Exception:  # noqa: BLE001 — unpriceable or over => stay
            return None
        return nxt

    def _shrink_decision_locked(
            self, active: List[ServeHandle]) -> Optional[int]:
        """The ladder-shrink policy: ``shrink_after_rounds`` CONSECUTIVE
        admission rounds whose occupancy fits the rung below — with
        nobody waiting — release the rung.  Any waiter, any boundary
        above the low-water mark, or a bottom-rung class resets the
        clock (a transient dip never thrashes the ladder)."""
        eng = self.engine
        if eng.shrink_after_rounds <= 0 or eng._closing:
            return None
        low = prev_rung(eng.ladder, self.capacity)
        if low >= self.capacity or len(active) > low \
                or self._waiters_locked():
            self.low_rounds = 0
            return None
        self.low_rounds += 1
        if self.low_rounds < eng.shrink_after_rounds:
            return None
        return low

    def _maybe_preempt_locked(self, waiters: List[ServeHandle]) -> None:
        """Checkpoint the lowest-priority runner out for a strictly
        stronger waiter (a starved waiter is strictly stronger than
        anyone — the bound guarantees it a slot, and hence at least one
        chunk of progress, every ~starvation_rounds boundaries)."""
        if self._starved_locked(waiters):
            challenger_pri = float("inf")
        else:
            challenger_pri = max(j.priority for j in waiters)
        victims = [j for j in self.slots
                   if j is not None and j.steps_done > 0]
        if not victims:
            return
        victim = min(victims, key=lambda j: (j.priority, -j.seq))
        if challenger_pri <= victim.priority:
            return
        self._preempt_locked(victim)

    def _slot_views(self, i: int):
        """Member slot ``i`` of every field, as the fields of one solo
        run: views into the class's state (whole tensors, or sharded
        fields of the slot's block views), written in place."""
        from ..parallel import stepper as stepper_lib

        out = []
        for f in self.fields:
            if isinstance(f, stepper_lib.ShardedField):
                out.append(stepper_lib.ShardedField(
                    [b[i] for b in f], f.mesh, f.global_shape[1:]))
            else:
                out.append(f[i])
        return tuple(out)

    def _extract_locked(self, i: int) -> Tuple:
        """Copy slot ``i`` out (the next chunk's launches write new
        buffers, and the slot is scrubbed or reused at this boundary)."""
        from ..parallel import stepper as stepper_lib

        out = []
        for v in self._slot_views(i):
            if isinstance(v, stepper_lib.ShardedField):
                out.append(v.with_blocks([b.clone() for b in v]))
            else:
                out.append(v.clone())
        return tuple(out)

    def _preempt_locked(self, j: ServeHandle) -> None:
        from ..utils import checkpointing

        i = j.slot
        with self.engine._step_lock:
            solo = self._extract_locked(i)
            self._scrub_locked(i)
        os.makedirs(self.engine._spool, exist_ok=True)
        path = os.path.join(self.engine._spool,
                            f"{j.id}-{j.preempt_count}")
        checkpointing.save_checkpoint(path, solo, j.steps_done,
                                      dataclasses.asdict(j.config))
        del solo
        j.preempt_ckpt = path
        j.preempt_count += 1
        self.slots[i] = None
        j.slot = None
        j.phase_live = "preempted"
        j.enqueued_round = None      # ages afresh from re-queue
        self.engine._waiting.append(j)
        self.engine._event("preempt", job=j,
                           extra={"checkpoint": path,
                                  "at_step": j.steps_done})

    def _place_locked(self, j: ServeHandle, i: int) -> None:
        """Seed slot ``i`` with the job's own solo state: its solo init
        (bit-identical to a fresh solo run's, the same ``init_state`` /
        ``init_state_sharded`` call) or its preemption checkpoint (resume
        where it left off), written into the fields the runner returned
        last (every shard's block)."""
        from ..utils import checkpointing
        from ..utils.init import init_state, init_state_sharded

        cfg = j.config
        views = self._slot_views(i)
        with self.engine._step_lock:
            if j.preempt_ckpt is not None:
                checkpointing.load_any(j.preempt_ckpt, target_fields=views)
                shutil.rmtree(j.preempt_ckpt, ignore_errors=True)
                j.preempt_ckpt = None
            elif self._mesh is not None:
                solo = init_state_sharded(
                    self.st, cfg.grid, self._mesh, cfg.seed, cfg.density,
                    kind=cfg.init, periodic=cfg.periodic)
                for v, s in zip(views, solo):
                    for b, sb in zip(v, s):
                        b.copy_(sb)
            else:
                solo = init_state(self.st, cfg.grid, cfg.seed, cfg.density,
                                  kind=cfg.init, periodic=cfg.periodic,
                                  device=self.device)
                for v, s in zip(views, solo):
                    v.copy_(s)
        self.slots[i] = j
        j.slot = i
        j.phase_live = "running"
        if j.started_at is None:
            j.started_at = time.time()
        self.engine._event("join", job=j,
                           extra={"slot": i,
                                  "resumed_at_step":
                                      j.steps_done or None})

    def _admit_locked(self) -> None:
        self.rounds += 1
        waiters = self._waiters_locked()
        for j in waiters:
            if j.enqueued_round is None:
                j.enqueued_round = self.rounds
        if not waiters:
            return
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free and self._can_grow_locked() is None:
            self._maybe_preempt_locked(waiters)
            free = [i for i, s in enumerate(self.slots) if s is None]
        while free and waiters:
            j = self._pick_locked(waiters)
            waiters.remove(j)
            self.engine._waiting.remove(j)
            self._place_locked(j, free.pop(0))

    def _pick_chunk_locked(self, active: List[ServeHandle]) -> int:
        """Largest power of two <= min(remaining over occupied, cadence),
        in call units — so retire lands exactly on a boundary and the
        class needs <= log2(cadence)+1 distinct chunk lengths."""
        rem = min(max(1, j.remaining // self.unit) for j in active)
        c = min(self.cadence_units, rem)
        return 1 << (c.bit_length() - 1)

    # -- boundary outcomes ----------------------------------------------

    def _scrub_locked(self, i: int) -> None:
        """Overwrite a vacated slot with finite ballast so the
        non-finite sweep never re-flags a retired/evicted member."""
        from ..parallel import stepper as stepper_lib

        for v in self._slot_views(i):
            for b in (v if isinstance(v, stepper_lib.ShardedField)
                      else (v,)):
                b.zero_()

    def _finalize_locked(self, j: ServeHandle) -> None:
        j.finished_at = time.time()
        j.timings["latency_s"] = round(j.finished_at - j.submitted_at, 6)
        j._done.set()

    def _retire_locked(self, j: ServeHandle) -> None:
        i = j.slot
        with self.engine._step_lock:
            solo = self._extract_locked(i)
            self._scrub_locked(i)
        self.slots[i] = None
        j.slot = None
        mcells = (j.cells * j.steps_done / j.active_wall_s / 1e6
                  if j.active_wall_s > 0 else 0.0)
        j._result = (solo, mcells)
        try:
            j.session.finish(steps=j.steps_done,
                             mcells_per_s=round(mcells, 3))
            j.session.close()
        except Exception:  # noqa: BLE001 — telemetry never load-bearing
            pass
        self._finalize_locked(j)
        eng = self.engine
        eng._jobs_done += 1
        ttfc = j.timings.get("time_to_first_chunk_s")
        if ttfc is not None:
            eng._ttfc.append(ttfc)
        with eng.metrics.lock:
            eng.metrics.counter("serve_jobs_done_total",
                                "jobs retired complete").inc()
            eng.metrics.histogram(
                "serve_request_latency_s",
                "submit -> retire end-to-end").observe(
                j.timings["latency_s"])
            if ttfc is not None:
                eng.metrics.histogram(
                    "serve_time_to_first_chunk_s",
                    "submit -> first completed chunk (the serving "
                    "SLO)").observe(ttfc)
        eng._event("retire", job=j, extra={"steps": j.steps_done})

    def _evict_locked(self, j: ServeHandle, nonfinite: int) -> None:
        """The DIVERGED verdict as the eviction signal: the job's log
        gets a real ``health`` record (so ``health_verdict()`` and
        ``/status.json`` read DIVERGED), the slot is scrubbed and
        recycled, the other tenants never see the poison.

        Eviction stays DIVERGED-only by design: a DEGRADED job (run-doctor
        anomaly findings) is slow, not poisoned — it keeps its slot,
        keeps making progress, and carries its findings in its own
        status for the caller to act on."""
        from ..obs.health import SimulationDiverged

        i = j.slot
        self.slots[i] = None
        j.slot = None
        with self.engine._step_lock:
            self._scrub_locked(i)
        reason = (f"{nonfinite} non-finite values in member slot {i} "
                  f"at step {j.steps_done}")
        err = SimulationDiverged(f"job {j.id} diverged: {reason}")
        j._error = err
        try:
            j.session.event("health", step=j.steps_done,
                            verdict="DIVERGED", nonfinite_total=nonfinite,
                            reason=reason, checked="slot_sweep")
            j.session.error(err)
            j.session.close()
        except Exception:  # noqa: BLE001
            pass
        self._finalize_locked(j)
        self.engine._jobs_evicted += 1
        self.engine.metrics.counter("serve_jobs_evicted_total",
                                    "jobs evicted DIVERGED").inc()
        self.engine._event("evict", job=j,
                           extra={"reason": reason, "slot": i})

    def _cancel_job_locked(self, j: ServeHandle) -> None:
        if j.slot is not None:
            i = j.slot
            self.slots[i] = None
            j.slot = None
            with self.engine._step_lock:
                self._scrub_locked(i)
        j._error = cancellation.RunCancelled(j.steps_done)
        try:
            j.session.event("cancelled", step=j.steps_done)
            j.session.close()
        except Exception:  # noqa: BLE001
            pass
        self._finalize_locked(j)
        self.engine._jobs_cancelled += 1
        self.engine.metrics.counter("serve_jobs_cancelled_total",
                                    "jobs cancelled").inc()
        self.engine._event("cancel", job=j,
                           extra={"at_step": j.steps_done})

    def _reap_cancelled_waiters_locked(self) -> None:
        for j in self._waiters_locked():
            if j._cancel.is_set():
                self.engine._waiting.remove(j)
                if j.preempt_ckpt is not None:
                    shutil.rmtree(j.preempt_ckpt, ignore_errors=True)
                self._cancel_job_locked(j)

    def _fail_job_locked(self, j: ServeHandle, e: BaseException) -> None:
        j._error = e
        try:
            j.session.error(e)
            j.session.close()
        except Exception:  # noqa: BLE001
            pass
        self._finalize_locked(j)
        self.engine._event("fail", job=j,
                           extra={"error": f"{type(e).__name__}: "
                                           f"{e}"[:300]})

    def _die_locked(self, e: BaseException) -> None:
        """The class's build or a chunk failed: the class is dead, and
        every job in its slots or waiting for it fails with the error
        (no other path re-runs them)."""
        self.dead = e
        self.engine.admission.release(self.sig)
        for j in list(self.slots):
            if j is not None:
                j.slot = None
                self._fail_job_locked(j, e)
        self.slots = [None] * len(self.slots)
        for j in self._waiters_locked():
            self.engine._waiting.remove(j)
            self._fail_job_locked(j, e)
        self.fields = None
        self.engine._cv.notify_all()

    def _slot_nonfinite(self) -> Optional[List[int]]:
        """Per-member non-finite counts over the float fields (None when
        the class has none — integer stencils cannot diverge): one count
        a field and block, summed on the device, one host read."""
        from ..parallel import stepper as stepper_lib

        total = None
        for f in self.fields:
            if not f.dtype.is_floating_point:
                continue
            if isinstance(f, stepper_lib.ShardedField):
                parts = []
                for c, b in zip(f.mesh.local_coords(), f):
                    n = b.shape[0]
                    cnt = (~torch.isfinite(b)).reshape(n, -1).sum(1)
                    first = f.offsets(c)[0]
                    parts.append(torch.nn.functional.pad(
                        cnt, (first, self.capacity - first - n)).to(
                            f[0].device))
                cnt = torch.stack(parts).sum(0)
            else:
                cnt = (~torch.isfinite(f)).reshape(f.shape[0], -1).sum(1)
            total = cnt if total is None else total + cnt
        return None if total is None else total.tolist()

    def _after_chunk_locked(self, active: List[ServeHandle],
                            chunk_units: int, dt: float,
                            warm: bool) -> None:
        from ..obs import health as health_lib
        from ..resilience import faults

        real = chunk_units * self.unit
        self.global_step += real
        eng = self.engine
        cell_steps = float(sum(j.cells for j in active)) * real
        eng.total_cell_steps += cell_steps
        eng.busy_wall_s += dt
        if warm:
            # steady-state aggregate: a runner's first call pays its
            # first launches (tile and kernel set-up) and must not read
            # as throughput
            eng.steady_cell_steps += cell_steps
            eng.steady_wall_s += dt
        now = time.time()
        for j in active:
            j.remaining -= real
            j.steps_done += real
            j.active_wall_s += dt
            try:
                j.session.recorder.record_chunk(chunk_units, dt)
            except Exception:  # noqa: BLE001
                pass
            if j.timings.get("time_to_first_chunk_s") is None:
                # recorded here, but folded into the engine's p50/p99
                # list only at retire — a job later cancelled or
                # evicted (e.g. a router rebalance) must not skew the
                # serving SLO percentiles
                j.timings["time_to_first_chunk_s"] = \
                    round(now - j.submitted_at, 6)
        with eng._step_lock:
            # fault point (resilience/faults.py numerics site): poison
            # ONE member slot, exactly like a real mid-run bit flip — the
            # sweep below must catch it and evict only that tenant
            if faults.injected_numeric_poison(self.global_step) is not None:
                occ = [i for i, s in enumerate(self.slots) if s is not None]
                if occ:
                    health_lib.apply_nan_poison(self._slot_views(occ[0]))
            counts = self._slot_nonfinite()
        if counts is not None:
            for i, j in enumerate(list(self.slots)):
                if j is not None and int(counts[i]) > 0:
                    self._evict_locked(j, int(counts[i]))
        for j in list(self.slots):
            if j is not None and j._cancel.is_set():
                self._cancel_job_locked(j)
        for j in list(self.slots):
            if j is not None and j.remaining <= 0:
                self._retire_locked(j)

    # -- the loop -------------------------------------------------------

    def _run_chunk(self, chunk_units: int, active: List[ServeHandle]):
        """One chunk under the step lock: the runner takes the fields
        (``driver.Donated``), the clock stops at a synchronize, CUDA
        events time the card's share.  Returns (seconds, device ms or
        None)."""
        from .. import driver

        runner = self._runner(chunk_units)
        with self.engine._step_lock:
            for j in active:
                try:
                    j.session.recorder.begin_chunk()
                except Exception:  # noqa: BLE001
                    pass
            events = None
            if self.device is not None and self.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            driver.synchronize(self.fields)
            t0 = time.perf_counter()
            if events:
                events[0].record()
            donated = driver.Donated(self.fields)
            self.fields = None
            fields = runner(donated)
            if events:
                events[1].record()
            driver.synchronize(fields)
            dt = time.perf_counter() - t0
            self.fields = fields
        return dt, (events[0].elapsed_time(events[1]) if events else None)

    def _loop(self) -> None:
        eng = self.engine
        try:
            self._build(self.capacity)
        except BaseException as e:  # noqa: BLE001 — fail queued jobs
            with eng._cv:
                self._die_locked(e)
            return
        while True:
            with eng._cv:
                self._reap_cancelled_waiters_locked()
                try:
                    self._admit_locked()
                except BaseException as e:  # noqa: BLE001 — a slot write
                    self._die_locked(e)     # failed on the card
                    return
                active = self._occupied_locked()
                grow_to = None
                if self._waiters_locked() and not any(
                        s is None for s in self.slots):
                    grow_to = self._can_grow_locked()
                shrink_to = None
                if grow_to is None:
                    shrink_to = self._shrink_decision_locked(active)
                if not active and grow_to is None and shrink_to is None:
                    if eng._closing and not self._waiters_locked():
                        return
                    eng._cv.wait(0.25)
                    continue
                if grow_to is None and shrink_to is None:
                    chunk_units = self._pick_chunk_locked(active)
            if grow_to is not None or shrink_to is not None:
                try:
                    self._migrate(grow_to or shrink_to,
                                  "grow" if grow_to is not None
                                  else "shrink")
                except BaseException as e:  # noqa: BLE001 — a build or
                    with eng._cv:           # a move failed on the card
                        self._die_locked(e)
                    return
                continue
            try:
                warm = (self.capacity, chunk_units) in self._warm
                dt, device_ms = self._run_chunk(chunk_units, active)
                self._warm.add((self.capacity, chunk_units))
            except BaseException as e:  # noqa: BLE001 — the kernels
                with eng._cv:           # failed: the class is dead
                    self._die_locked(e)
                return
            self.chunk_log.append({
                "capacity": self.capacity, "occupied": len(active),
                "steps": chunk_units * self.unit, "warm": warm,
                "wall_s": round(dt, 6),
                "device_ms": round(device_ms, 6)
                if device_ms is not None else None})
            with eng._cv:
                try:
                    self._after_chunk_locked(active, chunk_units, dt, warm)
                except BaseException as e:  # noqa: BLE001 — a sweep or
                    self._die_locked(e)     # slot copy failed on the card
                    return
                eng._cv.notify_all()


class ServingEngine:
    """The serving front-end: ``submit(cfg, tenant=, priority=)``.

    One engine owns one card: per-class boundary loops interleave chunks
    under a shared step lock (device work is serialized; the *slots* are
    what run concurrently).  All telemetry rides the obs/ vocabulary: the
    engine's own log streams ``scheduler`` events (``serve(port)`` puts
    ``/status.json`` on it), and every job gets a standard per-run log an
    ``/events`` long-poll can watch like any solo run.  ``step_lock``
    lets engines that share a card (a router's replicas) share one.
    """

    _ids = itertools.count()

    def __init__(self, telemetry_dir: Optional[str] = None,
                 ladder: Tuple[int, ...] = (1, 2, 4, 8),
                 cadence: int = 32, starvation_rounds: int = 4,
                 compile_cache: Optional[str] = None,
                 hbm_bytes: Optional[int] = None,
                 shrink_after_rounds: int = 64,
                 name: Optional[str] = None,
                 step_lock: Optional[threading.Lock] = None,
                 hbm_share: int = 1):
        from .. import obs
        from ..obs import trace as trace_lib
        from ..obs.metrics import MetricsRegistry

        ladder = tuple(sorted({int(c) for c in ladder}))
        if not ladder or ladder[0] < 1:
            raise ValueError(f"ladder must be positive capacities, "
                             f"got {ladder!r}")
        self.ladder = ladder
        self.cadence = int(cadence)
        self.starvation_rounds = int(starvation_rounds)
        self.shrink_after_rounds = int(shrink_after_rounds)
        self.name = name
        self.admission = AdmissionController(hbm_bytes=hbm_bytes,
                                             share=hbm_share)
        self.compile_cache = compile_cache
        if compile_cache:
            from .. import cli

            cli.enable_compile_cache(compile_cache)
        self.telemetry_dir = telemetry_dir or \
            trace_lib.default_telemetry_dir()
        os.makedirs(self.telemetry_dir, exist_ok=True)
        self._spool = os.path.join(self.telemetry_dir,
                                   f"serve-spool-{os.getpid()}")
        self._cv = threading.Condition(threading.RLock())
        self._step_lock = step_lock or threading.RLock()
        self._waiting: List[ServeHandle] = []
        self._classes: Dict[str, ResidentClass] = {}
        self._handles: List[ServeHandle] = []
        self._closing = False
        self._seq = itertools.count()
        self.metrics = MetricsRegistry()
        self.total_cell_steps = 0.0
        self.busy_wall_s = 0.0
        self.steady_cell_steps = 0.0
        self.steady_wall_s = 0.0
        self._ttfc: List[float] = []
        self._jobs_done = 0
        self._jobs_cancelled = 0
        self._jobs_evicted = 0
        self._rejects = 0
        self._ops: Dict[str, int] = {}
        self._server = None
        # engines of one process (a router's replicas) share a directory:
        # the engine's number keeps their job logs apart
        self._eid = next(self._ids)
        self.telemetry_path = os.path.join(
            self.telemetry_dir,
            f"serving-{os.getpid()}-{int(time.time() * 1e3)}-"
            f"{self._eid}.jsonl")
        # ``replica`` rides the manifest TOP level (schema-tolerant
        # extra key) so obs/aggregate.HostAggregator can split N
        # in-process replicas of one host|process into distinct rows
        extra = {"replica": name} if name else {}
        self._session = obs.open_session(
            self.telemetry_path, tool="serving",
            run={"ladder": list(self.ladder), "cadence": self.cadence,
                 "starvation_rounds": self.starvation_rounds,
                 "shrink_after_rounds": self.shrink_after_rounds,
                 "compile_cache": compile_cache},
            with_heartbeat=False, **extra)

    # -- telemetry ------------------------------------------------------

    def _gauges_locked(self) -> Dict[str, int]:
        return {
            "queue_depth": len(self._waiting),
            "slots_total": sum(len(c.slots)
                               for c in self._classes.values()),
            "slots_busy": sum(1 for c in self._classes.values()
                              for s in c.slots if s is not None),
            "classes": len(self._classes),
        }

    def _event(self, op: str, job: Optional[ServeHandle] = None,
               extra: Optional[Dict[str, Any]] = None) -> None:
        """One scheduling decision -> one ``scheduler`` record (the
        stream ``obs/metrics.RunMetrics._on_scheduler`` folds into
        ``/status.json``)."""
        with self._cv:
            self._ops[op] = self._ops.get(op, 0) + 1
            payload: Dict[str, Any] = {"op": op}
            payload.update(self._gauges_locked())
            if job is not None:
                payload.update(tenant=job.tenant, job=job.id,
                               size_class=job.class_label,
                               priority=job.priority)
            if extra:
                payload.update(extra)
            try:
                self._session.event("scheduler", **payload)
            except Exception:  # noqa: BLE001 — never load-bearing
                pass

    # -- submission -----------------------------------------------------

    def _validate(self, cfg: RunConfig) -> None:
        from .. import cli

        # the policy flags raise by their item (ROADMAP A8, policy)
        cli._refuse_unported(cfg)
        for name in _UNSUPPORTED_FIELDS:
            if getattr(cfg, name):
                raise AdmissionError(
                    "unsupported",
                    f"--{name.replace('_', '-')} cannot ride a shared "
                    f"resident step (got {getattr(cfg, name)!r}); run "
                    f"it solo via cli/engine",
                    detail={"field": name, "value": getattr(cfg, name)})
        unit = max(1, cfg.fuse)
        if cfg.iters <= 0 or cfg.iters % unit:
            raise AdmissionError(
                "unsupported",
                f"iters must be a positive multiple of the call unit "
                f"{unit} (got {cfg.iters}) — jobs join and leave at "
                f"chunk boundaries",
                detail={"field": "iters", "value": cfg.iters,
                        "unit": unit})

    def submit(self, cfg: RunConfig, tenant: str = "default",
               priority: int = 1) -> ServeHandle:
        """Admit a job into its size class (or reject with the reason).

        Pricing happens BEFORE acceptance, against the class at the
        capacity the job would actually join — an accepted job can
        always be placed; an impossible one is refused here with the
        budget arithmetic, never discovered by an out-of-memory error
        mid-flight.  A new class is admitted against what the resident
        classes leave free and holds its bytes from then on; a job of a
        resident class joins what its class already holds.
        """
        from .. import obs
        from ..obs import spans as spans_lib

        with self._cv:
            if self._closing:
                raise RuntimeError("ServingEngine is closed")
            sig = class_signature(cfg)
            rc = self._classes.get(sig)
            try:
                self._validate(cfg)
                if rc is not None and rc.dead is not None:
                    raise AdmissionError(
                        "unsupported",
                        f"size class {_short_sig(sig)} failed: {rc.dead}",
                        detail={"size_class": _short_sig(sig)})
                if rc is None:
                    est = self.admission.admit_or_raise(
                        class_config(cfg, ladder_rung(self.ladder, 1)),
                        holder=sig)
                else:
                    est = self.admission.price(
                        class_config(cfg, rc.capacity))
            except AdmissionError as e:
                self._rejects += 1
                self.metrics.counter("serve_rejects_total",
                                     "jobs refused at admission").inc()
                self._event("reject", extra={
                    "tenant": tenant, "reason": e.reason,
                    "size_class": _short_sig(sig),
                    "message": str(e)})
                raise
            seq = next(self._seq)
            path = cfg.telemetry or os.path.join(
                self.telemetry_dir,
                f"serve-{os.getpid()}-e{self._eid}-{seq}.jsonl")
            j = ServeHandle(f"job-{os.getpid()}-{seq}", cfg, path,
                            tenant, priority, sig, seq, self)
            j.trace_id = spans_lib.new_id()
            j.session = obs.open_session(
                path, tool="serving", run=dataclasses.asdict(cfg),
                step_unit=j.unit, with_heartbeat=False,
                serving={"job": j.id, "tenant": tenant,
                         "priority": j.priority,
                         "size_class": j.class_label,
                         "priced_bytes": est["total_bytes"],
                         "hbm_bytes": est["hbm_bytes"]})
            if cfg.anomaly:
                # run doctor per job (obs/anomaly.py): the class
                # round loop already calls record_chunk on this
                # recorder, so attaching the monitor is the whole
                # wiring — findings land in the job's own log and
                # its status() reads DEGRADED.  A degraded job is
                # NEVER evicted (eviction stays DIVERGED-only:
                # slow is not poisoned).
                try:
                    from ..obs import anomaly as anomaly_lib

                    j.session.recorder.anomaly = \
                        anomaly_lib.AnomalyMonitor(
                            trace=j.session.trace,
                            spans=j.session.spans,
                            ident=j.id, cells=j.cells)
                except Exception:  # noqa: BLE001 — never load-bearing
                    pass
            self._handles.append(j)
            self._waiting.append(j)
            if rc is None:
                rc = ResidentClass(self, sig, cfg,
                                   ladder_rung(self.ladder, 1))
                self._classes[sig] = rc
                rc._thread.start()
            self._event("submit", job=j)
            self._cv.notify_all()
            return j

    # -- introspection --------------------------------------------------

    def handles(self) -> List[ServeHandle]:
        return list(self._handles)

    def classes(self) -> List[ResidentClass]:
        with self._cv:
            return list(self._classes.values())

    def compile_counts(self) -> Dict[str, int]:
        """Steps built and runners built over this engine's classes (the
        process-wide counts, nvcc runs among them, are
        ``obs.runtime.compiles_seen``)."""
        with self._cv:
            return {"builds": sum(c.builds for c in self._classes.values()),
                    "runners": sum(c.compiles
                                   for c in self._classes.values())}

    def request_stats(self) -> Dict[str, Any]:
        """The serving SLOs: TTFC percentiles, aggregate throughput,
        outcome counts — the numbers ``close`` writes into the scheduler
        log's summary."""
        from ..obs.metrics import quantile

        with self._cv:
            ttfc = sorted(self._ttfc)
            # steady-state aggregate (cold first calls excluded) when
            # any warm chunk ran; the all-in number otherwise
            if self.steady_wall_s > 0:
                agg = self.steady_cell_steps / self.steady_wall_s / 1e9
            elif self.busy_wall_s > 0:
                agg = self.total_cell_steps / self.busy_wall_s / 1e9
            else:
                agg = None
            out: Dict[str, Any] = {
                "jobs_submitted": len(self._handles),
                "jobs_done": self._jobs_done,
                "jobs_cancelled": self._jobs_cancelled,
                "jobs_evicted": self._jobs_evicted,
                "rejects": self._rejects,
                "preemptions": self._ops.get("preempt", 0),
                "grows": self._ops.get("grow", 0),
                "shrinks": self._ops.get("shrink", 0),
                "ttfc_p50_s": round(quantile(ttfc, 0.5), 6)
                if ttfc else None,
                "ttfc_p99_s": round(quantile(ttfc, 0.99), 6)
                if ttfc else None,
                "aggregate_gcells_per_s": round(agg, 6)
                if agg is not None else None,
                "busy_wall_s": round(self.busy_wall_s, 6),
                "steady_wall_s": round(self.steady_wall_s, 6),
            }
            out.update(self._gauges_locked())
            out["class_table"] = [
                {"size_class": c.label, "capacity": c.capacity,
                 "occupied": len(c._occupied_locked()),
                 "rounds": c.rounds, "builds": c.builds,
                 "compiles": c.compiles, "steps": c.global_step,
                 "dead": None if c.dead is None
                 else f"{type(c.dead).__name__}: {c.dead}"[:300]}
                for c in self._classes.values()]
            return out

    def status(self) -> Dict[str, Any]:
        """Engine-level summary: the stats block plus one row per job
        (the campaign-console shape)."""
        out = self.request_stats()
        with self._cv:
            out["jobs"] = [
                {"id": j.id, "tenant": j.tenant, "priority": j.priority,
                 "phase": j._phase(), "size_class": j.class_label,
                 "steps_done": j.steps_done, "remaining": j.remaining,
                 "slot": j.slot, "telemetry": j.telemetry_path}
                for j in self._handles]
        return out

    def serve(self, port: int = 0):
        """Live HTTP console on the scheduler's own event stream
        (``/status.json`` carries the scheduler block via
        ``RunMetrics._on_scheduler``)."""
        from ..obs import serve as serve_lib

        self._server = serve_lib.serve_run(self.telemetry_path,
                                           port=port)
        return self._server

    # -- shutdown -------------------------------------------------------

    def close(self, drain: bool = True,
              timeout: Optional[float] = 120.0) -> Dict[str, Any]:
        """Stop accepting, run down the queue (or cancel it), write the
        serving summary, return the final stats."""
        with self._cv:
            self._closing = True
            if not drain:
                for j in self._handles:
                    if not j.done():
                        j._cancel.set()
            self._cv.notify_all()
        for rc in list(self._classes.values()):
            rc._thread.join(timeout)
        stats = self.request_stats()
        with self._cv:
            for sig, rc in self._classes.items():
                if not rc._thread.is_alive():
                    # the class is gone: its card memory and its hold
                    # go with it
                    rc.fields = None
                    rc._steps.clear()
                    rc.runners.clear()
                    self.admission.release(sig)
        try:
            self._session.finish(**{
                k: v for k, v in stats.items() if k != "class_table"})
            self._session.close()
        except Exception:  # noqa: BLE001
            pass
        if self._server is not None:
            try:
                self._server.close()
            except Exception:  # noqa: BLE001
                pass
        shutil.rmtree(self._spool, ignore_errors=True)
        return stats

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def serve_engine_main(cfg: RunConfig) -> int:
    """The ``--serve-engine PORT`` entry point: start a resident engine
    with the live console attached, run the command-line config as its
    first tenant, report, drain, exit.  (Long-lived multi-tenant use is
    the programmatic API: ``ServingEngine.submit`` from any thread.)"""
    eng = ServingEngine(compile_cache=cfg.compile_cache,
                        shrink_after_rounds=cfg.shrink_after,
                        telemetry_dir=(os.path.dirname(cfg.telemetry)
                                       if cfg.telemetry else None))
    srv = eng.serve(cfg.serve_engine)
    print(f"[serve-engine] scheduler console on {srv.url} "
          f"(/status.json, /metrics, /events)", flush=True)
    job_cfg = dataclasses.replace(cfg, serve_engine=None, compile_cache=None)
    code = 0
    try:
        h = eng.submit(job_cfg)
        _, mcells = h.result()
        print(f"[serve-engine] {h.id} done: {mcells:.1f} Mcells/s "
              f"(per member)", flush=True)
    except Exception as e:  # noqa: BLE001 — CLI boundary: report, exit 1
        print(f"[serve-engine] job failed: {type(e).__name__}: {e}",
              flush=True)
        code = 1
    stats = eng.close()
    print(f"[serve-engine] served {stats['jobs_done']} job(s), "
          f"ttfc_p50={stats['ttfc_p50_s']}s "
          f"aggregate={stats['aggregate_gcells_per_s']} Gcells/s",
          flush=True)
    return code
