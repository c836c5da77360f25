"""Fleet front door: N supervised engine replicas, one submit surface.

The port of the TPU package's ``serving/router.py``.  One
:class:`~.scheduler.ServingEngine` is a single budget and a single point
of failure.  This module runs N engine replicas (each a full scheduler
with its own resident classes, telemetry log, and budget slice: the
card's budget split in N equal slices) behind one router.  In the port the replicas are in-process engines on the
process's card: they share one step lock (device work on one card is
serialized, so the kernels' launch counters stay exact), and a replica's
"death" is :meth:`ServingRouter.kill_replica` abandoning it.  The router:

* **admits by aggregate budget** — a job is accepted iff SOME replica
  can host its size class within what its resident classes leave of
  its slice; the router walks replicas (affinity first, then
  least-loaded) and only rejects when every live replica's admission
  controller refuses, so the effective budget is the sum of the slices,
  the card's.  (The TPU package gives every replica the whole budget.)
  A dead replica's slice comes back to its restart only once its engine
  has been reaped and its memory freed;
* **routes by size-class affinity** — the first job of a class pins
  the class to its replica; every later job of the class lands there,
  where the resident batched step (and the shared ``--compile-cache``
  directory) is already warm, so the second job of a class builds
  nothing, exactly as on a single engine;
* **drains and rebalances on replica death** — the router's
  zero-lost-jobs contract never relies on a dying engine's
  cooperation: every unresolved job bound to a dead replica is
  re-dispatched to survivors from its original config (the simulation
  is deterministic, so a rerun is bit-exact), the dead engine is
  reaped in the background, and a supervised restart (exponential
  backoff from ``resilience/supervisor.backoff_s``, ``max_restarts``
  cap) brings the replica back as a new generation that re-binds to the
  SAME fleet row;
* **merges replica consoles** — ``serve()`` puts the
  :class:`~..obs.aggregate.HostAggregator` roll-up of the router log
  plus every replica's scheduler log on one ``/status.json``: replica
  manifests carry a top-level ``replica`` tag, so N in-process engines
  of one host/process slot read as N fleet rows (class table, queue
  depth, verdict).

Cancelled inner handles from a rebalance never skew latency SLOs: the
engines exclude CANCELLED requests from their ttfc/latency histograms
(they ride their own counter), and the router's own p50/p99 fold only
resolved jobs, timed from the ORIGINAL submit.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .. import cancellation
from ..config import RunConfig
from .admission import AdmissionError
from .scheduler import ServeHandle, ServingEngine
from .sizeclass import class_signature

__all__ = ["RouterHandle", "ServingRouter", "serve_router_main"]


class RouterHandle:
    """The stable face of one routed job: survives rebalance.

    The inner :class:`~.scheduler.ServeHandle` may be replaced when a
    replica dies; ``result``/``done``/``cancel`` always answer for the
    job, not for any particular attempt.
    """

    def __init__(self, run_id: str, config: RunConfig, tenant: str,
                 priority: int, seq: int):
        self.id = run_id
        self.config = config
        self.tenant = tenant
        self.priority = int(priority)
        self.seq = seq
        self.submitted_at = time.time()
        self.timings: Dict[str, Any] = {}
        self.replica: Optional[str] = None
        self.generation = -1
        self.resubmits = 0
        self._inner: Optional[ServeHandle] = None
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def cancel(self) -> bool:
        """Cooperative cancel, forwarded to the current attempt."""
        if self._done.is_set():
            return False
        self._cancel.set()
        inner = self._inner
        if inner is not None:
            inner.cancel()
        return True

    def result(self, timeout: Optional[float] = None):
        """Block for the job's terminal outcome: ``(fields, mcells)``
        or the raised error (exactly :meth:`~..engine.RunHandle.result`
        semantics)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"{self.id} still pending")
        if self._error is not None:
            raise self._error
        return self._result


class _Replica:
    """One supervised engine slot: the name is stable, the engine (and
    its telemetry log) is per-generation."""

    def __init__(self, name: str, engine: ServingEngine):
        self.name = name
        self.engine = engine
        self.generation = 0
        self.alive = True
        self.inflight = 0    # router jobs currently bound here


class ServingRouter:
    """N supervised :class:`~.scheduler.ServingEngine` replicas behind
    one ``submit`` surface (see module doc)."""

    _ids = itertools.count()

    def __init__(self, replicas: int = 3,
                 telemetry_dir: Optional[str] = None,
                 ladder: Tuple[int, ...] = (1, 2, 4, 8),
                 cadence: int = 32, starvation_rounds: int = 4,
                 compile_cache: Optional[str] = None,
                 hbm_bytes: Optional[int] = None,
                 shrink_after_rounds: int = 64,
                 max_restarts: int = 2,
                 restart_backoff: float = 0.05):
        from .. import obs
        from ..obs import trace as trace_lib

        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.max_restarts = int(max_restarts)
        self.restart_backoff = float(restart_backoff)
        # one card: every replica's device work under one step lock, and
        # a slice each of its budget (``hbm_bytes``, None: the card's)
        self._engine_kw = dict(
            ladder=ladder, cadence=cadence,
            starvation_rounds=starvation_rounds,
            compile_cache=compile_cache, hbm_bytes=hbm_bytes,
            hbm_share=int(replicas),
            shrink_after_rounds=shrink_after_rounds,
            step_lock=threading.RLock())
        self.telemetry_dir = telemetry_dir or \
            trace_lib.default_telemetry_dir()
        os.makedirs(self.telemetry_dir, exist_ok=True)
        self._cv = threading.Condition()
        self._seq = itertools.count()
        self._replicas: Dict[str, _Replica] = {}
        self._all_engines: List[ServingEngine] = []
        self._affine: Dict[str, str] = {}    # class sig -> replica name
        self._handles: List[RouterHandle] = []
        self._inflight: set = set()
        self._ttfc: List[float] = []
        self._jobs_done = 0
        self._jobs_cancelled = 0
        self._jobs_failed = 0
        self._rejects = 0
        self._rebalanced = 0
        self._restarts = 0
        self._ops: Dict[str, int] = {}
        self._draining = False
        self._server = None
        self.telemetry_path = os.path.join(
            self.telemetry_dir,
            f"router-{os.getpid()}-{int(time.time() * 1e3)}-"
            f"{next(self._ids)}.jsonl")
        self._session = obs.open_session(
            self.telemetry_path, tool="router",
            run={"replicas": int(replicas), "ladder": list(ladder),
                 "max_restarts": self.max_restarts,
                 "compile_cache": compile_cache},
            with_heartbeat=False)
        for i in range(int(replicas)):
            name = f"r{i}"
            rep = _Replica(name, self._spawn_engine(name))
            self._replicas[name] = rep
            self._event("replica_up", replica=name, generation=0)
        self._stop = threading.Event()
        self._pump = threading.Thread(target=self._pump_loop,
                                      daemon=True, name="router-pump")
        self._pump.start()

    # -- replicas -------------------------------------------------------

    def _spawn_engine(self, name: str) -> ServingEngine:
        eng = ServingEngine(telemetry_dir=self.telemetry_dir,
                            name=name, **self._engine_kw)
        self._all_engines.append(eng)
        return eng

    @staticmethod
    def _reap_engine(eng: ServingEngine) -> None:
        """Background teardown of an abandoned engine: cancel whatever
        still runs so the devices come back.  Correctness never depends
        on this — the orphans were already re-dispatched."""
        try:
            eng.close(drain=False, timeout=30.0)
        except Exception:  # noqa: BLE001
            pass

    def kill_replica(self, name: str) -> bool:
        """A replica's death: mark it dead NOW, rebalance its
        unresolved jobs to survivors from their original configs, reap
        the carcass in the background, and schedule the supervised
        restart.  Returns False when already dead/unknown."""
        with self._cv:
            rep = self._replicas.get(name)
            if rep is None or not rep.alive:
                return False
            rep.alive = False
            dead_eng = rep.engine
            generation = rep.generation
            orphans = [h for h in self._inflight
                       if h.replica == name and not h._done.is_set()]
            # un-pin the dead replica's classes so survivors warm up
            self._affine = {s: n for s, n in self._affine.items()
                            if n != name}
            self._event("replica_dead", replica=name,
                        generation=generation, orphans=len(orphans))
            for h in orphans:
                self._try_redispatch_locked(h)
            self._cv.notify_all()
        reaper = threading.Thread(target=self._reap_engine,
                                  args=(dead_eng,), daemon=True)
        reaper.start()
        self._restart_later(name, generation, reaper)
        return True

    def _restart_later(self, name: str, generation: int,
                       reaper: threading.Thread) -> None:
        from ..resilience.supervisor import backoff_s

        if generation + 1 > self.max_restarts:
            with self._cv:
                self._event("give_up", replica=name,
                            generation=generation,
                            reason=f"max_restarts={self.max_restarts} "
                                   f"exhausted")
            return

        def run() -> None:
            time.sleep(backoff_s(generation, self.restart_backoff, 5.0))
            reaper.join()   # the slice is free once the engine is reaped
            with self._cv:
                if self._draining:
                    return
                rep = self._replicas.get(name)
                if rep is None or rep.alive:
                    return
            eng = self._spawn_engine(name)
            with self._cv:
                rep.engine = eng
                rep.generation = generation + 1
                rep.alive = True
                rep.inflight = 0
                self._restarts += 1
                self._event("replica_up", replica=name,
                            generation=rep.generation)
                self._cv.notify_all()
            if self._server is not None:
                try:
                    self._server.console.watch(eng.telemetry_path)
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=run, daemon=True,
                         name=f"router-restart-{name}").start()

    # -- telemetry ------------------------------------------------------

    def _event(self, op: str, **extra: Any) -> None:
        """One routing decision -> one ``router`` record (folded by
        ``obs/metrics.RunMetrics._on_router`` into ``/status.json``).
        Caller holds ``_cv``."""
        self._ops[op] = self._ops.get(op, 0) + 1
        payload: Dict[str, Any] = {
            "op": op,
            "replicas_total": len(self._replicas),
            "replicas_alive": sum(1 for r in self._replicas.values()
                                  if r.alive),
            "jobs_inflight": len(self._inflight),
        }
        payload.update(extra)
        try:
            self._session.event("router", **payload)
        except Exception:  # noqa: BLE001 — never load-bearing
            pass

    # -- routing --------------------------------------------------------

    def _order_locked(self, sig: str) -> List[_Replica]:
        """Candidate replicas: the class's affine home first (its
        resident step is warm), then the rest by ascending load."""
        alive = [r for r in self._replicas.values() if r.alive]
        alive.sort(key=lambda r: (r.inflight, r.name))
        aff = self._affine.get(sig)
        if aff is not None:
            alive.sort(key=lambda r: 0 if r.name == aff else 1)
        return alive

    def _route_locked(self, h: RouterHandle, op: str) -> None:
        """Bind ``h`` to the first replica whose admission accepts it.

        ``over_budget`` refusals fall through to the next replica —
        admission by AGGREGATE budget; ``unsupported`` refusals are
        categorical and re-raise immediately (no replica would ever
        accept)."""
        sig = class_signature(h.config)
        order = self._order_locked(sig)
        if not order:
            raise AdmissionError(
                "over_budget",
                "no live replica to route to (all dead, restarts "
                "exhausted or pending)",
                detail={"replicas": len(self._replicas)})
        last: Optional[AdmissionError] = None
        for rep in order:
            try:
                inner = rep.engine.submit(h.config, tenant=h.tenant,
                                          priority=h.priority)
            except AdmissionError as e:
                if e.reason != "over_budget":
                    raise
                last = e
                continue
            h._inner = inner
            h.replica = rep.name
            h.generation = rep.generation
            rep.inflight += 1
            self._affine.setdefault(sig, rep.name)
            self._event(op, job=h.id, replica=rep.name,
                        tenant=h.tenant, size_class=inner.class_label,
                        resubmits=h.resubmits)
            return
        raise AdmissionError(
            "over_budget",
            f"aggregate budget exhausted: every live replica refused "
            f"({len(order)} tried); last: {last}",
            detail={"replicas_tried": len(order)})

    def _try_redispatch_locked(self, h: RouterHandle) -> None:
        """Re-run an orphan on a survivor (deterministic => bit-exact).
        An orphan nobody can host resolves as the admission error — it
        is REPORTED lost-capacity, never silently lost."""
        old = h.replica
        rep = self._replicas.get(old) if old else None
        if rep is not None and h._inner is not None:
            rep.inflight = max(0, rep.inflight - 1)
        h._inner = None
        h.resubmits += 1
        self._rebalanced += 1
        if h._cancel.is_set():
            self._resolve_locked(
                h, None, cancellation.RunCancelled(0), None)
            return
        try:
            self._route_locked(h, "rebalance")
        except AdmissionError as e:
            self._resolve_locked(h, None, e, None)

    # -- resolution -----------------------------------------------------

    def _resolve_locked(self, h: RouterHandle, result: Any,
                        err: Optional[BaseException],
                        inner: Optional[ServeHandle]) -> None:
        rep = self._replicas.get(h.replica) if h.replica else None
        if rep is not None and h._inner is not None:
            rep.inflight = max(0, rep.inflight - 1)
        now = time.time()
        h.timings["latency_s"] = round(now - h.submitted_at, 6)
        if inner is not None:
            itt = inner.timings.get("time_to_first_chunk_s")
            if itt is not None:
                # timed from the ORIGINAL submit: a rebalanced job's
                # ttfc includes the death + re-dispatch it lived through
                ttfc = (inner.submitted_at - h.submitted_at) + itt
                h.timings["time_to_first_chunk_s"] = round(ttfc, 6)
                if err is None:
                    self._ttfc.append(ttfc)
        h._result = result
        h._error = err
        if err is None:
            self._jobs_done += 1
        elif isinstance(err, cancellation.RunCancelled):
            self._jobs_cancelled += 1
        else:
            self._jobs_failed += 1
        h._done.set()
        self._inflight.discard(h)

    def _pump_once(self) -> None:
        with self._cv:
            for h in list(self._inflight):
                if h._done.is_set():
                    self._inflight.discard(h)
                    continue
                inner = h._inner
                if inner is None:
                    if h._cancel.is_set():
                        self._resolve_locked(
                            h, None, cancellation.RunCancelled(0), None)
                    continue
                if not inner.done():
                    continue
                rep = self._replicas.get(h.replica)
                stale = (rep is None or not rep.alive
                         or rep.generation != h.generation)
                err = inner._error
                if err is None:
                    self._resolve_locked(h, inner._result, None, inner)
                elif h._cancel.is_set():
                    self._resolve_locked(h, None, err, inner)
                elif stale:
                    # death fallout (the reaper's cancel, a torn chunk)
                    # is not the JOB's outcome — rerun it
                    self._try_redispatch_locked(h)
                else:
                    self._resolve_locked(h, None, err, inner)
            self._cv.notify_all()

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            self._pump_once()
            self._stop.wait(0.02)

    # -- submission -----------------------------------------------------

    def submit(self, cfg: RunConfig, tenant: str = "default",
               priority: int = 1) -> RouterHandle:
        """Admit into the fleet (or reject with the aggregate budget
        arithmetic) and return the routed handle."""
        with self._cv:
            if self._draining:
                raise RuntimeError("ServingRouter is closed")
            seq = next(self._seq)
            h = RouterHandle(f"rjob-{os.getpid()}-{seq}", cfg, tenant,
                             priority, seq)
            try:
                self._route_locked(h, "route")
            except AdmissionError as e:
                self._rejects += 1
                self._event("reject", tenant=tenant, reason=e.reason,
                            message=str(e)[:300])
                raise
            self._handles.append(h)
            self._inflight.add(h)
            self._cv.notify_all()
            return h

    # -- introspection --------------------------------------------------

    def handles(self) -> List[RouterHandle]:
        return list(self._handles)

    def replicas(self) -> Dict[str, Dict[str, Any]]:
        with self._cv:
            return {r.name: {"alive": r.alive,
                             "generation": r.generation,
                             "inflight": r.inflight,
                             "telemetry": r.engine.telemetry_path}
                    for r in self._replicas.values()}

    def request_stats(self) -> Dict[str, Any]:
        """The fleet SLOs: router-level ttfc percentiles (timed from
        the original submit, rebalances included), aggregate steady
        throughput summed over every engine generation, outcome and
        rebalance counts — what the load test pins and ``close``
        writes into the router log's summary."""
        from ..obs.metrics import quantile

        with self._cv:
            ttfc = sorted(self._ttfc)
            engines = list(self._all_engines)
            cells = sum(e.steady_cell_steps for e in engines)
            wall = max((e.steady_wall_s for e in engines), default=0.0)
            if wall <= 0:
                cells = sum(e.total_cell_steps for e in engines)
                wall = max((e.busy_wall_s for e in engines), default=0.0)
            out: Dict[str, Any] = {
                "replicas": len(self._replicas),
                "replicas_alive": sum(1 for r in self._replicas.values()
                                      if r.alive),
                "restarts": self._restarts,
                "jobs_submitted": len(self._handles),
                "jobs_done": self._jobs_done,
                "jobs_cancelled": self._jobs_cancelled,
                "jobs_failed": self._jobs_failed,
                "jobs_inflight": len(self._inflight),
                "lost_jobs": sum(1 for h in self._handles
                                 if not h._done.is_set()),
                "rejects": self._rejects,
                "rebalanced": self._rebalanced,
                "ttfc_p50_s": round(quantile(ttfc, 0.5), 6)
                if ttfc else None,
                "ttfc_p99_s": round(quantile(ttfc, 0.99), 6)
                if ttfc else None,
                # conservative concurrent aggregate: total steady work
                # over the LONGEST single engine's steady wall
                "aggregate_gcells_per_s": round(cells / wall / 1e9, 6)
                if wall > 0 else None,
            }
            out["per_replica"] = [
                {"replica": r.name, "alive": r.alive,
                 "generation": r.generation,
                 "inflight": r.inflight,
                 **{k: v for k, v in r.engine.request_stats().items()
                    if k in ("jobs_done", "jobs_cancelled", "grows",
                             "shrinks", "aggregate_gcells_per_s",
                             "class_table")}}
                for r in self._replicas.values()]
            return out

    def serve(self, port: int = 0):
        """One ``/status.json`` for the whole fleet: the aggregate
        console (``obs/serve.serve_aggregate``) over the router log + every
        replica's
        scheduler log (replica-tagged manifests -> per-replica rows)."""
        from ..obs import serve as serve_lib

        paths = [self.telemetry_path] + [
            r.engine.telemetry_path for r in self._replicas.values()]
        self._server = serve_lib.serve_aggregate(paths, port=port)
        return self._server

    # -- shutdown -------------------------------------------------------

    def close(self, drain: bool = True,
              timeout: Optional[float] = 600.0) -> Dict[str, Any]:
        """Stop accepting, run down (or cancel) the in-flight jobs,
        close every live replica, write the router summary, return the
        final stats."""
        with self._cv:
            self._draining = True
            pending = list(self._inflight)
        if not drain:
            for h in pending:
                h.cancel()
        deadline = time.time() + (timeout or 0.0)
        for h in pending:
            left = max(0.05, deadline - time.time()) if timeout else None
            h._done.wait(left)
        self._stop.set()
        self._pump.join(10.0)
        self._pump_once()   # final sweep after the pump stopped
        with self._cv:
            live = [r.engine for r in self._replicas.values() if r.alive]
        for eng in live:
            try:
                eng.close(drain=drain, timeout=timeout)
            except Exception:  # noqa: BLE001
                pass
        stats = self.request_stats()
        with self._cv:
            self._event("drain", lost_jobs=stats["lost_jobs"])
        try:
            self._session.finish(**{
                k: v for k, v in stats.items() if k != "per_replica"})
            self._session.close()
        except Exception:  # noqa: BLE001
            pass
        if self._server is not None:
            try:
                self._server.close()
            except Exception:  # noqa: BLE001
                pass
        return stats

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def serve_router_main(cfg: RunConfig) -> int:
    """The ``--serve-router PORT`` entry point: start the replica
    fleet with the aggregate console attached, run the command-line
    config as its first tenant, report, drain, exit.  (Long-lived
    multi-tenant use is the programmatic API: ``ServingRouter.submit``
    from any thread.)"""
    router = ServingRouter(
        replicas=cfg.router_replicas,
        compile_cache=cfg.compile_cache,
        shrink_after_rounds=cfg.shrink_after,
        telemetry_dir=(os.path.dirname(cfg.telemetry)
                       if cfg.telemetry else None))
    srv = router.serve(cfg.serve_router)
    print(f"[serve-router] fleet console on {srv.url} "
          f"(/status.json: hosts + aggregate)", flush=True)
    job_cfg = dataclasses.replace(cfg, serve_router=None,
                                  router_replicas=0, compile_cache=None)
    code = 0
    try:
        h = router.submit(job_cfg)
        _, mcells = h.result()
        print(f"[serve-router] {h.id} done on {h.replica}: "
              f"{mcells:.1f} Mcells/s (per member)", flush=True)
    except Exception as e:  # noqa: BLE001 — CLI boundary: report, exit 1
        print(f"[serve-router] job failed: {type(e).__name__}: {e}",
              flush=True)
        code = 1
    stats = router.close()
    print(f"[serve-router] {stats['replicas']} replica(s) served "
          f"{stats['jobs_done']} job(s), lost={stats['lost_jobs']}, "
          f"ttfc_p50={stats['ttfc_p50_s']}s "
          f"aggregate={stats['aggregate_gcells_per_s']} Gcells/s",
          flush=True)
    return code
