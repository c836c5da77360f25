"""Run observability: manifests, chunk stats, heartbeat, health, profiles.

The port's counterpart of the TPU package's ``obs/`` layer, with the same
versioned manifest schema and event vocabulary, so every record the port
writes passes that package's event validator and one reader folds both
packages' logs:

* ``manifest``   — provenance-stamped run record (first line, always;
  the port's provenance names PyTorch, CUDA and the card with its power
  limit: ``trace.py``)
* ``chunk``      — per-chunk wall time, recompile flag (a kernel library
  loaded mid-run), device-memory figures (``runtime.py``)
* ``heartbeat``  — STALLED/WEDGED/RECOVERED verdicts from the watcher
  (``heartbeat.py``: a bounded CUDA-synchronize probe in a subprocess)
* ``profile``    — device-trace attribution of one profiled chunk
  (``profile.py``: ``torch.profiler``; device-busy, interior, exchange
  and exposed time, overlap efficiency and the chunk's idle share — or
  an explicit ``attribution: unavailable``, never fabricated zeros)
* ``span``       — one finished span of the causal timeline (``spans.py``)
* ``health``     — one numerics-sentinel check (``health.py``: per-field
  min/max/mean + NaN/Inf counts and the op's registered invariant,
  reduced block by block on the device and combined across processes,
  with the HEALTHY/DIVERGED verdict)
* ``halo_audit`` — one bit-exact ghost-slab audit pass (``health.py``
  ``--halo-audit``)
* ``group_chunk``— one device group's share of a coupled chunk
  (``--groups``)
* ``anomaly``    — one run-doctor finding (``anomaly.py``)
* ``costmodel``  — the static counters and the roofline priced for the
  card (``costmodel.py``; one a run, after the build)
* ``launch`` / ``restart`` / ``give_up`` / ``bundle`` — the supervisor's
  trail (``resilience/supervisor.py``, tool ``supervisor``)
* ``exchange`` / ``resume`` / ``error`` / ``summary`` — the run's path
  and how it ended

``metrics.py`` folds the event stream into the run's verdict;
``flightrec.py`` keeps the post-mortem ring and writes the
bundle.  The reference's ``policy``, ``migrate``, ``scheduler`` and
``router`` records come with their modules (ROADMAP A8).

:func:`open_session` is the one-call wiring: trace writer + manifest +
runtime recorder + heartbeat, bundled in a :class:`Session`.  Telemetry
is an observer, never load-bearing: records are written only at chunk
boundaries (the step's aten ops and kernel launches are unchanged), and
callers guard session set-up so a telemetry failure cannot kill the run
it watches.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from . import flightrec as flightrec_lib
from . import heartbeat as heartbeat_lib
from . import runtime as runtime_lib
from . import spans as spans_lib
from . import trace as trace_lib


class Session:
    """A live telemetry session: trace + recorder + optional heartbeat.

    ``recorder`` is the driver-facing observer; ``event``/``finish``/
    ``error`` write to the trace.  ``spans`` is the session's
    :class:`~.spans.SpanEmitter`; ``flight`` the post-mortem ring.
    ``finish`` and ``close`` are idempotent, and ``close`` stops the
    heartbeat first so no verdict thread outlives its run, then emits
    the root span before the trace writer closes.
    """

    def __init__(self, trace: trace_lib.TraceWriter,
                 recorder: runtime_lib.RuntimeRecorder,
                 heartbeat: Optional[heartbeat_lib.Heartbeat],
                 spans: Optional[spans_lib.SpanEmitter] = None,
                 flight: Optional[flightrec_lib.FlightRecorder] = None):
        self.trace = trace
        self.recorder = recorder
        self.heartbeat = heartbeat
        self.spans = spans
        self.flight = flight
        self._finished = False

    @property
    def path(self) -> str:
        return self.trace.path

    def event(self, kind: str, **payload: Any) -> None:
        self.trace.event(kind, **payload)
        self.recorder.mark()

    def progress(self) -> None:
        """Liveness tick without an event."""
        self.recorder.mark()

    def finish(self, **payload: Any) -> None:
        """Write the summary event (once): runtime stats + caller extras."""
        if self._finished:
            return
        self._finished = True
        hb = (self.heartbeat.last_verdict if self.heartbeat is not None
              else None)
        self.trace.event("summary", runtime=self.recorder.summary(),
                         heartbeat=hb, **payload)

    def error(self, exc: BaseException) -> None:
        try:
            self.trace.event(
                "error", error=f"{type(exc).__name__}: {exc}"[:1200],
                runtime=self.recorder.summary())
        except Exception:  # noqa: BLE001 — already failing; don't mask
            pass

    def close(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.spans is not None:
            self.spans.close()  # root span: before the writer closes
        self.trace.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.error(exc)
        else:
            self.finish()
        self.close()


def open_session(
    path: str,
    tool: str,
    run: Dict[str, Any],
    step_unit: int = 1,
    stall_after_s: float = 600.0,
    with_heartbeat: bool = True,
    ensemble: int = 0,
    **manifest_extra: Any,
) -> Session:
    """Open a trace at ``path``, write the manifest, start the heartbeat.

    The session's span emitter adopts an inherited ``OBS_TRACE_CONTEXT``;
    the manifest carries the ``trace`` identity block either way.
    ``run["device"]`` (``"cuda"`` or
    ``"cpu"``) says whether the recorder reads the card's memory.
    """
    trace = trace_lib.TraceWriter(path)
    flight = flightrec_lib.FlightRecorder()
    trace.mirrors.append(flight.note)
    spans = spans_lib.SpanEmitter(trace, context=spans_lib.from_env(),
                                  root_name=tool)
    manifest_extra.setdefault("trace", spans.manifest_block())
    trace.write_manifest(trace_lib.build_manifest(
        tool, run, **manifest_extra))
    recorder = runtime_lib.RuntimeRecorder(
        trace=trace, step_unit=step_unit, ensemble=ensemble, spans=spans,
        cuda=str(run.get("device", "")).startswith("cuda"))
    hb = None
    if with_heartbeat:
        hb = heartbeat_lib.Heartbeat(recorder, trace=trace,
                                     stall_after_s=stall_after_s)
        hb.start()
    return Session(trace, recorder, hb, spans=spans, flight=flight)


__all__ = ["Session", "open_session"]
