"""Request-lifecycle layer: an async submit/handle API over the core.

The port of the TPU package's ``engine.py``.  The simulation core —
``cli.build`` constructing a step from SIMULATION fields,
``driver.run_simulation`` advancing state — knows nothing about requests;
this module owns everything request-shaped: identity, queuing, background
execution, telemetry wiring, and live status.  The boundary is
``config.SIM_FIELDS`` / ``config.LIFECYCLE_FIELDS`` (the two sets
partition ``RunConfig``).

Usage — submit a config, get a handle, stream chunk telemetry::

    eng = SimulationEngine()
    h = eng.submit(RunConfig(stencil="heat3d", grid=(64, 64, 128),
                             iters=100, ensemble=8, log_every=10))
    h.status()            # live: manifest, latest chunk, per-member
                          # throughput, heartbeat verdict — the same
                          # payload /status.json serves
    for ev in h.events(after=0): ...   # raw obs records, seq-ordered
    fields, mcells = h.result()        # blocks; re-raises run errors

Every handle runs the ONE ordinary CLI path (``cli.run``) on a daemon
thread with telemetry forced on (a derived path when the request did not
name one), so the chunk stream a handle exposes is the exact obs/
vocabulary every other tool reads, and a handle's run can be watched
remotely by pointing ``obs/serve.py`` (or ``--serve``) at its log.
Batched requests (``ensemble=N``) stream per-member throughput: the chunk
records carry the member count, and :meth:`RunHandle.status` reports
aggregate AND per-member Gcells/s (``obs/metrics.RunMetrics``).

Thread-safety: device work is serialized per engine by a run lock —
submissions queue FIFO behind it (one device set, one run's kernels at a
time, so the launch counters and the runtime observer see one run at a
time); ``submit`` itself never blocks.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .config import RunConfig, SIM_FIELDS, sim_signature

__all__ = ["RunHandle", "SimulationEngine"]


class RunHandle:
    """One submitted simulation request: identity + lifecycle + results.

    The request-lifecycle face of a run — everything here reads the
    telemetry log or the thread state; nothing touches the simulation
    core (the same zero-ops discipline as the rest of obs/).
    """

    def __init__(self, run_id: str, config: RunConfig,
                 telemetry_path: str):
        self.id = run_id
        self.config = config
        self.sim_signature = sim_signature(config)
        self.telemetry_path = telemetry_path
        self.submitted_at = time.time()
        # request-span identity (obs/spans.py): the engine opens a
        # "request" span per submission; the run's own session inherits
        # this context (thread-local propagation), so every span the run
        # emits — compile, checkpoint — parents under the request on ONE
        # trace
        self.trace_id: Optional[str] = None
        self.request_span_id: Optional[str] = None
        self.started_at: Optional[float] = None   # run lock acquired
        self.finished_at: Optional[float] = None
        # queue_wait_s / time_to_first_chunk_s / latency_s, filled by
        # the engine's post-run accounting
        self.timings: Dict[str, Optional[float]] = {}
        self._done = threading.Event()
        self._result: Optional[Tuple] = None
        self._error: Optional[BaseException] = None
        # cooperative cancel token (cancellation.py): set by cancel(),
        # polled by the CLI's chunk-boundary callback on the run thread
        self._cancel = threading.Event()

    # -- lifecycle ------------------------------------------------------

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Request cooperative cancellation at the next chunk boundary.

        Idempotent and race-free: a run that already finished ignores
        it (returns False); a queued run cancels at its first boundary.
        The cancelled run ends with a ``cancelled`` telemetry event,
        phase ``"cancelled"``, and ``result()`` re-raising
        :class:`cancellation.RunCancelled` — never an ``error`` row.
        """
        if self._done.is_set():
            return False
        self._cancel.set()
        return True

    def cancelled(self) -> bool:
        from .cancellation import RunCancelled

        return isinstance(self._error, RunCancelled)

    def _phase(self) -> str:
        if self.cancelled():
            return "cancelled"
        if self._error is not None:
            return "failed"
        return "done" if self._done.is_set() else "running"

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Tuple:
        """Block for ``(final_fields, mcells_per_s)``; re-raises the
        run's exception (the submit/handle analogue of a CLI exit)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"run {self.id} still executing after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    # -- telemetry ------------------------------------------------------

    def events(self, after: int = 0,
               limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Raw obs records past sequence number ``after`` (1-based,
        ``_seq``-annotated — the same cursor contract as the live
        console's ``/events?after=``).  Complete lines only: a record
        mid-write is picked up by the next call, never truncated."""
        out: List[Dict[str, Any]] = []
        try:
            with open(self.telemetry_path) as fh:
                for seq, line in enumerate(fh, start=1):
                    if seq <= after or not line.endswith("\n"):
                        continue
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    rec["_seq"] = seq
                    out.append(rec)
                    if limit is not None and len(out) >= limit:
                        break
        except OSError:
            pass
        return out

    def status(self) -> Dict[str, Any]:
        """The live status payload — identical vocabulary to
        ``/status.json`` (``obs/metrics.RunMetrics.status``), plus the
        handle's request identity and phase.

        The ``health`` key is ALWAYS present (None before the first
        sentinel check; the latest ``health`` record of a ``--health``
        run after), and a DIVERGED verdict dominates ``verdict`` — the
        contract a scheduler reads to evict diverged members without
        parsing logs; :meth:`health_verdict` is the one-call form."""
        from .obs.metrics import RunMetrics

        rm = RunMetrics()
        for rec in self.events():
            rec = dict(rec)
            rec.pop("_seq", None)
            rm.ingest(rec)
        out = rm.status()
        req: Dict[str, Any] = {
            "id": self.id,
            "submitted_at": self.submitted_at,
            "telemetry": self.telemetry_path,
            "sim_signature": self.sim_signature,
            "phase": self._phase(),
        }
        if self.trace_id is not None:
            req["trace_id"] = self.trace_id
        if self.started_at is not None:
            # live queue accounting: how long this request waited for
            # the device before its run began
            req["queue_wait_s"] = round(
                self.started_at - self.submitted_at, 6)
        req.update({k: v for k, v in self.timings.items()
                    if v is not None})
        out["request"] = req
        return out

    def health_verdict(self) -> Optional[str]:
        """The latest numerics-sentinel verdict for this run (None when
        no health check has landed yet, ``"HEALTHY"``/``"DIVERGED"``
        after) — the eviction signal, without the full status walk."""
        return (self.status().get("health") or {}).get("verdict")

    def anomalies(self) -> List[Dict[str, Any]]:
        """Run-doctor findings for this run (obs/anomaly.py ``anomaly``
        records from the telemetry stream, oldest first; empty when the
        run is clean or ``--anomaly`` was off).  A non-empty list means
        :meth:`status`'s verdict reads DEGRADED unless something worse
        (WEDGED/DIVERGED) dominates — degraded runs are NOT evicted;
        the findings are the attribution a caller acts on."""
        out = []
        for rec in self.events():
            if rec.get("kind") == "anomaly":
                rec = dict(rec)
                rec.pop("_seq", None)
                out.append(rec)
        return out


class SimulationEngine:
    """Async request front-end: ``submit(cfg) -> RunHandle``.

    One engine serializes execution over the process's device set (the
    run lock); handles queue FIFO.  The engine neither copies nor
    re-validates simulation semantics — ``cli.run`` stays the single
    execution path, so submit/handle runs behave like the equivalent
    command line (auto dispatch, budget guard, epilogue included).
    """

    _ids = itertools.count()

    def __init__(self, telemetry_dir: Optional[str] = None):
        from .obs import trace as trace_lib
        from .obs.metrics import MetricsRegistry

        self.telemetry_dir = telemetry_dir or \
            trace_lib.default_telemetry_dir()
        self._run_lock = threading.Lock()
        self._handles: List[RunHandle] = []
        # engine-level request metrics: per-request latency histograms
        # (queue wait, time-to-first-chunk, end-to-end), rendered by
        # ``self.metrics.to_prometheus()``
        self.metrics = MetricsRegistry()

    # -- submission -----------------------------------------------------

    def _prepare(self, cfg: RunConfig) -> RunConfig:
        """Lifecycle-field normalization: telemetry forced on (derived
        path when unset) so every handle has a chunk stream; a logging
        cadence derived for runs that set none (no chunk boundaries ->
        no stream to hand back, no cancellation point).  SIMULATION
        fields are never touched — asserted, not assumed."""
        before = {k: v for k, v in dataclasses.asdict(cfg).items()
                  if k in SIM_FIELDS}
        if not cfg.telemetry:
            os.makedirs(self.telemetry_dir, exist_ok=True)
            cfg = dataclasses.replace(cfg, telemetry=os.path.join(
                self.telemetry_dir,
                f"engine-{os.getpid()}-{int(time.time() * 1e3)}-"
                f"{next(self._ids)}.jsonl"))
        if not cfg.log_every and not cfg.tol:
            step_unit = max(1, cfg.fuse)
            chunk = max(step_unit, (cfg.iters // 8) // step_unit
                        * step_unit)
            cfg = dataclasses.replace(cfg, log_every=chunk)
        after = {k: v for k, v in dataclasses.asdict(cfg).items()
                 if k in SIM_FIELDS}
        if after != before:
            raise AssertionError("engine touched a simulation field")
        return cfg

    def submit(self, cfg: RunConfig) -> RunHandle:
        """Queue a request; returns immediately with its handle.

        Launcher-mode lifecycle fields are rejected here — a supervised
        or served run owns its own process lifecycle, which is exactly
        what the engine is (use ``--supervise``/``--serve`` via the CLI
        for those modes).
        """
        if cfg.supervise:
            raise ValueError(
                "engine.submit runs in-process; --supervise forks its "
                "own supervision tree — launch supervised runs through "
                "the CLI")
        cfg = self._prepare(cfg)
        from .obs import spans as spans_lib

        handle = RunHandle(f"run-{os.getpid()}-{next(self._ids)}", cfg,
                           cfg.telemetry)
        # the request span opens at submit: the engine owns the trace
        # root of this request unless it was itself called under one
        # (a traced caller's context chains through)
        inherited = spans_lib.resolve_context()
        handle.trace_id = inherited.trace_id if inherited \
            else spans_lib.new_id()
        handle.request_span_id = spans_lib.new_id()
        self._handles.append(handle)
        t = threading.Thread(target=self._execute, args=(handle,),
                             name=f"sim-engine-{handle.id}", daemon=True)
        handle._thread = t
        t.start()
        return handle

    def _execute(self, handle: RunHandle) -> None:
        from . import cancellation, cli
        from .obs import spans as spans_lib

        with self._run_lock:
            handle.started_at = time.time()
            # in-process trace propagation: the run's session (opened
            # inside cli.run on THIS thread) adopts the request context
            spans_lib.push_thread_context(spans_lib.SpanContext(
                handle.trace_id, handle.request_span_id))
            try:
                # the handle's cancel token rides the run thread; the
                # CLI's chunk callback polls it (cancellation.check)
                with cancellation.scope(handle._cancel):
                    handle._result = cli.run(handle.config)
            except BaseException as e:  # noqa: BLE001 — delivered via
                handle._error = e       # handle.result(), never lost
            finally:
                spans_lib.pop_thread_context()
                handle.finished_at = time.time()
                try:
                    self._account(handle)
                except Exception:  # noqa: BLE001 — accounting is
                    pass           # telemetry, never load-bearing
                handle._done.set()

    def _account(self, handle: RunHandle) -> None:
        """Post-run request accounting: latency histograms + the
        request span tree appended to the (now closed) telemetry log —
        queue-wait -> build/chunks (the run's own spans/events) ->
        result, all under one trace_id."""
        from .obs import spans as spans_lib

        sub, start = handle.submitted_at, handle.started_at
        end = handle.finished_at or time.time()
        queue_wait = (start - sub) if start is not None else None
        latency = end - sub
        chunks = [r for r in handle.events()
                  if r.get("kind") == "chunk"
                  and isinstance(r.get("t"), (int, float))]
        first_chunk_t = chunks[0]["t"] if chunks else None
        last_chunk_t = chunks[-1]["t"] if chunks else None
        ttfc = (first_chunk_t - sub) if first_chunk_t is not None else None
        handle.timings = {
            "queue_wait_s": round(queue_wait, 6)
            if queue_wait is not None else None,
            "time_to_first_chunk_s": round(ttfc, 6)
            if ttfc is not None else None,
            "latency_s": round(latency, 6),
        }
        with self.metrics.lock:
            self.metrics.counter(
                "engine_requests_total", "submitted runs completed").inc()
            if handle.cancelled():
                # counted, never sampled: a cancelled request's wall
                # time measures the CALLER (e.g. a router rebalancing
                # off a dead replica), not the engine — folding it into
                # the latency/ttfc histograms would skew every p99
                self.metrics.counter("engine_requests_cancelled_total",
                                     "submitted runs cancelled").inc()
            else:
                if handle._error is not None:
                    self.metrics.counter(
                        "engine_requests_failed_total",
                        "submitted runs that raised").inc()
                if queue_wait is not None:
                    self.metrics.histogram(
                        "engine_queue_wait_s",
                        "submit -> run-lock acquired").observe(queue_wait)
                if ttfc is not None:
                    self.metrics.histogram(
                        "engine_time_to_first_chunk_s",
                        "submit -> first completed chunk (the serving "
                        "SLO)").observe(ttfc)
                self.metrics.histogram(
                    "engine_request_latency_s",
                    "submit -> result end-to-end").observe(latency)
        # the request span tree, appended to the closed log so the
        # per-request timeline lives next to the run's own spans
        tid, rid = handle.trace_id, handle.request_span_id
        if not tid or not rid:
            return
        recs = []
        if queue_wait is not None:
            recs.append(spans_lib.make_span_record(
                "queue_wait", tid, spans_lib.new_id(), rid,
                sub, queue_wait))
        if last_chunk_t is not None and end >= last_chunk_t:
            recs.append(spans_lib.make_span_record(
                "result", tid, spans_lib.new_id(), rid,
                last_chunk_t, end - last_chunk_t))
        recs.append(spans_lib.make_span_record(
            "request", tid, rid, None, sub, latency,
            attrs={"id": handle.id,
                   "ok": handle._error is None,
                   "queue_wait_s": handle.timings["queue_wait_s"],
                   "time_to_first_chunk_s":
                       handle.timings["time_to_first_chunk_s"]}))
        spans_lib.append_span_records(handle.telemetry_path, recs)

    # -- introspection --------------------------------------------------

    def handles(self) -> List[RunHandle]:
        return list(self._handles)

    def status(self) -> Dict[str, Any]:
        """Engine-level summary: one row per handle (id, phase, sim
        signature, telemetry path) — the campaign-console shape."""
        rows = []
        for h in self._handles:
            rows.append({
                "id": h.id,
                "phase": h._phase(),
                "ensemble": h.config.ensemble or None,
                "telemetry": h.telemetry_path,
                "submitted_at": h.submitted_at,
            })
        return {"handles": rows, "pending": sum(
            1 for h in self._handles if not h.done()),
            "metrics": self.metrics.snapshot()}
