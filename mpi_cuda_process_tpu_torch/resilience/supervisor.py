"""Run supervisor: heartbeat-driven checkpoint, restart and resume.

The port's counterpart of the TPU package's ``resilience/supervisor.py``:
the same restart loop, verdict sets, events and spans.  It connects three
working parts: the heartbeat writes WEDGED/STALLED verdicts
(``obs/heartbeat.py``), checkpoints resume bit-exactly
(``utils/checkpointing.py``), and the supervisor acts on the verdicts:

1. the run goes in a **child process** (its own process group) with
   ``--checkpoint-every`` and ``--telemetry`` forced on;
2. the parent **tails the child's telemetry** and kills the child on a
   WEDGED/STALLED heartbeat verdict, on its death (a nonzero exit), or on
   a wall-clock stall with no event at all (a hung kernel build, where the
   child's own heartbeat may hang too);
3. after a bounded **exponential backoff** it relaunches with
   ``--resume`` from the newest surviving checkpoint, exporting
   ``FAULT_ATTEMPT`` so the fault harness (:mod:`.faults`) proves every
   path deterministically;
4. after ``max_restarts`` relaunches it **gives up loudly**: exit 1, a
   ``give_up`` event and a flight-recorder bundle whose ``tunnel`` field
   holds the card probe's verdict (``obs/flightrec.py``).

The child is the ordinary ``python -m mpi_cuda_process_tpu_torch`` CLI
(``config.to_argv``), so it inherits ``--device``; the supervisor adds no
second execution path to keep bit-exact.  A killed child releases its CUDA
context only when it exits, so every kill waits for the exit before the
relaunch.  A child's first use of the kernels builds them with ``nvcc``
and writes no event meanwhile: ``--supervise-stall-s`` must cover that
build (or the kernels are built before the supervised run).

Every decision lands in the supervisor's own log (tool ``"supervisor"``):
``launch`` events carry the attempt and ``resumed_from_step``, ``restart``
events the reason and backoff, ``give_up`` / ``summary`` how it ended.
:func:`retry_subprocess` is the non-resumable sibling for work units with
nothing to resume: a wedge costs the attempt, never the unit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import faults

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG = "mpi_cuda_process_tpu_torch"

# Heartbeat verdicts that kill the child (STALLED included: a run that
# stalls past the heartbeat's threshold and then past the supervisor's
# window was not coming back).
KILL_VERDICTS = ("WEDGED", "STALLED")

# Health verdicts that end the run WITHOUT a restart: a DIVERGED state is
# deterministic, so resuming from a checkpoint at or before the blow-up
# would reproduce it and burn every restart.
FATAL_VERDICTS = ("DIVERGED",)


@dataclasses.dataclass
class SuperviseResult:
    ok: bool
    attempts: int
    restarts: List[Dict[str, Any]]
    gave_up: bool
    final_rc: Optional[int]
    resumed_from_step: Optional[int]  # the last launch's resume point
    checkpoint_dir: Optional[str]
    telemetry: Optional[str]  # the supervisor's own event log


def sibling_path(base: str, tag: str) -> str:
    """``run.jsonl`` + ``attempt0`` -> ``run.attempt0.jsonl``."""
    if base.endswith(".jsonl"):
        return f"{base[:-len('.jsonl')]}.{tag}.jsonl"
    return f"{base}.{tag}.jsonl"


def backoff_s(attempt: int, base_s: float, max_s: float) -> float:
    """Exponential backoff before relaunch ``attempt + 1``: base * 2^n,
    bounded."""
    return min(float(base_s) * (2.0 ** attempt), float(max_s))


def latest_checkpoint_step(path: Optional[str]) -> Optional[int]:
    """Newest checkpoint step under ``path``, ``npy`` or sharded
    (``torch.distributed.checkpoint``) layout, or None.  File-system only:
    the pointer is readable while the card is wedged."""
    if not path:
        return None
    from ..utils import checkpointing

    try:
        return checkpointing.latest_step(path)
    except Exception:  # noqa: BLE001 — a corrupt dir means "no resume"
        return None


def find_latest_checkpoint(
    search: Optional[Sequence[str]] = None,
) -> Optional[Tuple[str, int]]:
    """``(checkpoint_dir, step)`` to resume from: the telemetry manifests
    under ``search`` (default ``trace.default_telemetry_dir()``), newest
    first by ``created_at``, whose ``run.checkpoint_dir`` still holds a
    checkpoint."""
    from ..obs import trace as trace_lib

    dirs = list(search) if search else [trace_lib.default_telemetry_dir()]
    manifests: List[Tuple[float, Dict[str, Any]]] = []
    for d in dirs:
        try:
            names = os.listdir(d)
        except OSError:
            continue
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            try:
                with open(os.path.join(d, name)) as fh:
                    m = trace_lib.validate_manifest(
                        json.loads(fh.readline()))
            except Exception:  # noqa: BLE001 — skip foreign/corrupt logs
                continue
            manifests.append((m.get("created_at", 0.0), m))
    for _, m in sorted(manifests, key=lambda t: t[0], reverse=True):
        ckd = (m.get("run") or {}).get("checkpoint_dir")
        step = latest_checkpoint_step(ckd)
        if step is not None:
            return str(ckd), int(step)
    return None


# --------------------------------------------------------------- child


class ProcHandle:
    """A supervised child in its own process group: the kill takes the
    whole group (the child's probe subprocesses too)."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            try:
                self.proc.kill()
            except OSError:
                pass

    def wait(self, timeout_s: float = 30.0) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None


def spawn_child(cmd: Sequence[str], *, attempt: int,
                cwd: Optional[str] = None,
                env_extra: Optional[Dict[str, str]] = None) -> ProcHandle:
    """Launch one attempt in a new session (a killable group), with
    ``FAULT_ATTEMPT`` exported: an injected fault fires on attempt 0 and
    the relaunch runs clean."""
    env = dict(os.environ)
    env[faults.ATTEMPT_VAR] = str(attempt)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)
    proc = subprocess.Popen(
        list(cmd), cwd=cwd or _REPO, env=env, start_new_session=True)
    return ProcHandle(proc)


# --------------------------------------------------------------- watch


def _classify_event(e, kill_verdicts, fatal_verdicts,
                    degraded_action: str = "warn"):
    """One tailed record -> ("verdict"|"fatal", value, detail) or None."""
    if e.get("kind") == "heartbeat" and e.get("verdict") in kill_verdicts:
        return ("verdict", e.get("verdict"), str(e.get("detail", ""))[:300])
    if e.get("kind") == "health" and e.get("verdict") in fatal_verdicts:
        return ("fatal", e.get("verdict"), str(e.get("reason", ""))[:300])
    if e.get("kind") == "anomaly":
        # a run-doctor finding: the child is slow, not dead; warn by
        # default, restart or abort on request
        suspect = e.get("suspect") or {}
        detail = (f"{e.get('anomaly')} "
                  f"(suspect {suspect.get('kind')}:{suspect.get('name')})"
                  )[:300]
        if degraded_action == "restart":
            return ("verdict", "DEGRADED", detail)
        if degraded_action == "abort":
            return ("fatal", "DEGRADED", detail)
        return None
    if e.get("kind") == "cancelled":
        # a deliberately stopped child is not a crash
        return ("fatal", "CANCELLED", f"cancelled at step {e.get('step')}")
    return None


def watch_child(handle, tails, *, stall_timeout_s: float,
                poll_s: float = 0.5,
                kill_verdicts: Sequence[str] = KILL_VERDICTS,
                fatal_verdicts: Sequence[str] = FATAL_VERDICTS,
                degraded_action: str = "warn",
                clock: Callable[[], float] = time.monotonic,
                sleep: Callable[[float], None] = time.sleep,
                ) -> Tuple[str, Optional[Any], Optional[str]]:
    """Watch one attempt until it ends or must be killed:
    ``("exit", rc, None)``, ``("verdict", verdict, detail)`` (a kill-listed
    heartbeat verdict), ``("fatal", verdict, detail)`` (a non-restartable
    health verdict) or ``("stall", None, detail)`` (no event for
    ``stall_timeout_s``).  It never kills anything itself."""
    last_event = clock()
    while True:
        events = [e for t in tails for e in t.poll()]
        if events:
            last_event = clock()
            for e in events:
                hit = _classify_event(e, kill_verdicts, fatal_verdicts,
                                      degraded_action)
                if hit is not None:
                    return hit
        rc = handle.poll()
        if rc is not None:
            # a final drain: a verdict written just before the death is
            # the richer reason
            for e in (e for t in tails for e in t.poll()):
                hit = _classify_event(e, kill_verdicts, fatal_verdicts,
                                      degraded_action)
                if hit is not None:
                    return hit
            return ("exit", int(rc), None)
        if clock() - last_event > stall_timeout_s:
            return ("stall", None,
                    f"no telemetry events for {stall_timeout_s:.1f}s "
                    "(wall-clock stall — hung compile or dead event "
                    "writer)")
        sleep(poll_s)


# ----------------------------------------------------------- supervise


def supervise(launcher, checkpoint_dir: Optional[str], *,
              max_restarts: int = 2, backoff_base_s: float = 5.0,
              backoff_max_s: float = 300.0, stall_timeout_s: float = 600.0,
              poll_s: float = 0.5,
              kill_verdicts: Sequence[str] = KILL_VERDICTS,
              fatal_verdicts: Sequence[str] = FATAL_VERDICTS,
              degraded_action: str = "warn",
              session=None,
              probe_card: bool = False,
              sleep: Callable[[float], None] = time.sleep,
              clock: Callable[[], float] = time.monotonic,
              ) -> SuperviseResult:
    """The restart loop: launch, watch, kill, back off, resume, bound.

    ``launcher(attempt, resume)`` returns ``(handle, tails)``: a child
    handle (``poll``/``kill``/``wait``) and the telemetry tails to watch
    (``obs.trace.LogTail``-shaped).  ``session`` (optional) receives the
    ``launch`` / ``restart`` / ``give_up`` / ``summary`` events and the
    ``attempt`` / ``kill`` / ``restart`` / ``backoff`` spans.  A fatal
    health verdict gives up at once, with no restart.  ``probe_card``
    runs the card probe for the give-up bundle's ``tunnel`` field."""
    def _event(kind: str, **payload: Any) -> None:
        if session is not None:
            try:
                session.event(kind, **payload)
            except Exception:  # noqa: BLE001 — telemetry never load-bearing
                pass

    last_tails: List[Any] = []

    def _give_up_bundle(reason: str, verdict: Optional[str]) -> None:
        """The give-up post-mortem: the supervisor's ring plus the tail of
        the final attempt's child log (the child was just killed: its log
        is all the evidence there is).  Best-effort."""
        if session is None:
            return
        try:
            from ..obs import aggregate as aggregate_lib
            from ..obs import flightrec as flightrec_lib

            extra: Dict[str, List[Dict[str, Any]]] = {}
            for t in last_tails:
                p = getattr(t, "path", None)
                if not p:
                    continue
                recs = list(aggregate_lib.iter_records(p))[-80:]
                extra[os.path.basename(p)] = [
                    r for r in recs if r.get("kind") != "manifest"]
            path = flightrec_lib.bundle_from_session(
                session, reason, verdict=verdict, run_probe=probe_card,
                extra_events=extra or None)
            if path:
                _event("bundle", path=path, reason=reason)
        except Exception:  # noqa: BLE001 — post-mortems never load-bearing
            pass

    spans = getattr(session, "spans", None)

    def _span(name: str, **attrs: Any):
        if spans is not None:
            return spans.span(name, **attrs)
        return contextlib.nullcontext()

    restarts: List[Dict[str, Any]] = []
    resumed_from: Optional[int] = None
    for attempt in range(max_restarts + 1):
        step = latest_checkpoint_step(checkpoint_dir)
        resume = attempt > 0 and step is not None
        resumed_from = step if resume else None
        _event("launch", attempt=attempt, resume=resume,
               resumed_from_step=resumed_from)
        with _span("attempt", attempt=attempt, resume=resume,
                   resumed_from_step=resumed_from):
            handle, tails = launcher(attempt, resume)
            last_tails[:] = list(tails)
            outcome, value, detail = watch_child(
                handle, tails, stall_timeout_s=stall_timeout_s,
                poll_s=poll_s, kill_verdicts=kill_verdicts,
                fatal_verdicts=fatal_verdicts,
                degraded_action=degraded_action, clock=clock,
                sleep=sleep)
            if outcome != "exit":
                # the child is alive but lost: kill its group and reap it,
                # so the relaunch never races it for the checkpoint dir
                # or the card
                with _span("kill", attempt=attempt, reason=outcome,
                           verdict=value
                           if outcome in ("verdict", "fatal") else None):
                    handle.kill()
                    handle.wait()
        if outcome == "fatal":
            reason = f"health verdict {value} (non-restartable)"
            if value == "DEGRADED":
                reason = "degraded (anomaly findings, " \
                         "--degraded-action abort)"
            _event("give_up", attempts=attempt + 1, reason=reason,
                   detail=detail, verdict=value, restarts=len(restarts))
            _give_up_bundle(reason, value)
            _event("summary", ok=False, attempts=attempt + 1,
                   restarts=len(restarts), gave_up=True, verdict=value)
            return SuperviseResult(
                ok=False, attempts=attempt + 1, restarts=restarts,
                gave_up=True, final_rc=None,
                resumed_from_step=resumed_from,
                checkpoint_dir=checkpoint_dir,
                telemetry=getattr(session, "path", None))
        if outcome == "exit" and value == 0:
            _event("summary", ok=True, attempts=attempt + 1,
                   restarts=len(restarts), resumed_from_step=resumed_from)
            return SuperviseResult(
                ok=True, attempts=attempt + 1, restarts=restarts,
                gave_up=False, final_rc=0, resumed_from_step=resumed_from,
                checkpoint_dir=checkpoint_dir,
                telemetry=getattr(session, "path", None))
        reason = {"exit": f"child exited rc={value}",
                  "verdict": ("degraded child (anomaly findings, "
                              "--degraded-action restart)"
                              if value == "DEGRADED"
                              else f"heartbeat verdict {value}"),
                  "stall": "wall-clock stall"}[outcome]
        if attempt >= max_restarts:
            _event("give_up", attempts=attempt + 1, reason=reason,
                   detail=detail, restarts=len(restarts))
            _give_up_bundle(reason, value if outcome == "verdict" else None)
            _event("summary", ok=False, attempts=attempt + 1,
                   restarts=len(restarts), gave_up=True)
            return SuperviseResult(
                ok=False, attempts=attempt + 1, restarts=restarts,
                gave_up=True, final_rc=value if outcome == "exit" else None,
                resumed_from_step=resumed_from,
                checkpoint_dir=checkpoint_dir,
                telemetry=getattr(session, "path", None))
        wait = backoff_s(attempt, backoff_base_s, backoff_max_s)
        rec = {"attempt": attempt, "reason": reason, "detail": detail,
               "backoff_s": wait,
               "checkpoint_step": latest_checkpoint_step(checkpoint_dir)}
        restarts.append(rec)
        _event("restart", **rec)
        with _span("restart", attempt=attempt, reason=reason,
                   backoff_s=wait,
                   resumed_from_step=rec["checkpoint_step"]):
            with _span("backoff", backoff_s=wait):
                sleep(wait)
    raise AssertionError("unreachable: the loop returns on every path")


# ----------------------------------------------------------- CLI entry


def _default_checkpoint_every(cfg) -> int:
    """About 10 checkpoints a run, rounded to the fused step unit."""
    every = max(1, cfg.iters // 10)
    if cfg.fuse:
        every = max(cfg.fuse, (every // cfg.fuse) * cfg.fuse)
    return every


def run_supervised(cfg) -> int:
    """``cli --supervise``: supervise a RunConfig end to end; returns the
    exit code.

    Checkpointing and telemetry are forced on (defaults under
    ``trace.default_telemetry_dir()`` when the config has none).  The
    flags the port does not run are refused here, before any child is
    launched.  ``--serve`` is the parent's: one console follows the
    supervisor's log and every attempt's child log
    (``obs/aggregate.py``'s ``make_console``, ``obs/serve.py``'s
    ``watch``)."""
    import logging

    from ..cli import _refuse_unported
    from ..config import to_argv
    from ..obs import spans as spans_lib
    from ..obs import trace as trace_lib

    log = logging.getLogger(f"{_PKG}.supervisor")
    _refuse_unported(cfg)

    tag = f"{os.getpid()}-{int(time.time())}"
    checkpoint_dir = cfg.checkpoint_dir or os.path.join(
        trace_lib.default_telemetry_dir(), f"supervise-{tag}", "ckpt")
    checkpoint_every = cfg.checkpoint_every or _default_checkpoint_every(cfg)
    telemetry_base = cfg.telemetry or os.path.join(
        trace_lib.default_telemetry_dir(), f"supervise-{tag}.jsonl")
    child_cfg = dataclasses.replace(
        cfg, supervise=False, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, serve_port=None)

    session = None
    try:
        from .. import obs

        session = obs.open_session(
            sibling_path(telemetry_base, "supervisor"), tool="supervisor",
            run=dataclasses.asdict(child_cfg), with_heartbeat=False,
            supervisor={"max_restarts": cfg.max_restarts,
                        "restart_backoff_s": cfg.restart_backoff,
                        "stall_timeout_s": cfg.supervise_stall_s})
    except Exception as e:  # noqa: BLE001 — supervise even when blind
        log.warning("supervisor telemetry disabled (%s: %s)",
                    type(e).__name__, e)

    server = None
    if cfg.serve_port is not None:
        try:
            from ..obs import aggregate as aggregate_lib
            from ..obs import serve as serve_lib

            console = aggregate_lib.make_console(
                [sibling_path(telemetry_base, "supervisor")])
            server = serve_lib.ObsServer(console, port=cfg.serve_port)
            log.info("supervisor obs console serving at %s", server.url)
            if session is not None:
                session.event("serve", url=server.url, port=server.port,
                              endpoints=["/metrics", "/status.json",
                                         "/events"])
        except Exception as e:  # noqa: BLE001 — never load-bearing
            log.warning("supervisor --serve disabled (%s: %s)",
                        type(e).__name__, e)
            server = None

    def launcher(attempt: int, resume: bool):
        tel = sibling_path(telemetry_base, f"attempt{attempt}")
        argv = to_argv(dataclasses.replace(
            child_cfg, telemetry=tel,
            resume=resume or (attempt == 0 and cfg.resume)))
        log.info("supervisor: launching attempt %d%s", attempt,
                 f" (resume from step "
                 f"{latest_checkpoint_step(checkpoint_dir)})"
                 if resume else "")
        if server is not None:
            # the console follows the child across restarts
            server.console.watch(tel)
        # inside supervise()'s "attempt" span: the child's spans join
        # this trace under it
        handle = spawn_child([sys.executable, "-m", _PKG, *argv],
                             attempt=attempt,
                             env_extra=spans_lib.env_extra(session))
        return handle, [trace_lib.LogTail(tel)]

    try:
        res = supervise(
            launcher, checkpoint_dir,
            max_restarts=cfg.max_restarts,
            backoff_base_s=cfg.restart_backoff,
            stall_timeout_s=cfg.supervise_stall_s,
            degraded_action=getattr(cfg, "degraded_action", "warn"),
            session=session, probe_card=cfg.device == "cuda")
    finally:
        if session is not None:
            session.close()
        if server is not None:
            server.close()
    if res.ok:
        log.info("supervisor: run completed after %d attempt(s)%s",
                 res.attempts,
                 f" (last resumed from step {res.resumed_from_step})"
                 if res.resumed_from_step is not None else "")
        return 0
    log.error("supervisor: giving up after %d attempt(s); latest "
              "checkpoint %r step %s — rerun with --resume to continue "
              "by hand", res.attempts, checkpoint_dir,
              latest_checkpoint_step(checkpoint_dir))
    return 1


# ----------------------------------------------- non-resumable retries


def retry_subprocess(cmd: Sequence[str], *, timeout_s: float,
                     max_restarts: int = 1, backoff_base_s: float = 2.0,
                     backoff_max_s: float = 60.0,
                     healthy: Optional[Callable[[], bool]] = None,
                     cwd: Optional[str] = None,
                     env_extra: Optional[Dict[str, str]] = None,
                     sleep: Callable[[float], None] = time.sleep,
                     ) -> Dict[str, Any]:
    """Bounded retries of a work unit with nothing to resume: on a timeout
    the child's group is killed and reaped and the unit retried after an
    exponential backoff; ``healthy()`` False after a kill stops the
    retries (the wedge is environmental).  Returns ``{"rc", "attempts",
    "timed_out", "healthy_after", "history"}``."""
    history: List[Dict[str, Any]] = []
    healthy_after = True
    rc: Optional[int] = None
    timed_out = False
    attempts = 0
    for attempt in range(max_restarts + 1):
        attempts = attempt + 1
        t0 = time.monotonic()
        handle = spawn_child(cmd, attempt=attempt, cwd=cwd,
                             env_extra=env_extra)
        try:
            rc = handle.proc.wait(timeout=timeout_s)
            timed_out = False
        except subprocess.TimeoutExpired:
            handle.kill()
            handle.wait()
            rc, timed_out = None, True
        history.append({"attempt": attempt,
                        "outcome": "timeout" if timed_out else f"rc={rc}",
                        "wall_s": round(time.monotonic() - t0, 1)})
        if not timed_out:
            return {"rc": rc, "attempts": attempts, "timed_out": False,
                    "healthy_after": True, "history": history}
        if healthy is not None:
            healthy_after = bool(healthy())
            if not healthy_after:
                break  # environmental: stop burning attempts
        if attempt < max_restarts:
            sleep(backoff_s(attempt, backoff_base_s, backoff_max_s))
    return {"rc": rc, "attempts": attempts, "timed_out": timed_out,
            "healthy_after": healthy_after, "history": history}
