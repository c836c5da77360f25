"""Distributed span tracing: one causal timeline across processes.

The port's copy of the TPU package's ``obs/spans.py``: the same record
shape, the same ``OBS_TRACE_CONTEXT`` encoding (``trace_id:span_id``), so a
context exported by either package's parent is adopted by the other's
child.  A **span** (trace_id / span_id / parent_id, wall start,
monotonic-measured duration, attributes) is an ordinary schema-compatible
event in the telemetry stream; a parent exports ``OBS_TRACE_CONTEXT`` into
a child's environment and the child's session adopts that trace_id and
parents its spans under the exporter's span, so every process of a
multi-process run shares one trace_id.

The spans the port emits:

=============  =====================================================
name           emitted by
=============  =====================================================
``run``/tool   the session root span (``Session.close``; named after
               the emitting tool, ``cli``)
``compile``    ``RuntimeRecorder`` around chunk 0: the port compiles no
               step program, so this is chunk 0's kernel build, library
               load and warm-up (the first launch of each tile)
``checkpoint`` the CLI around every checkpoint save
``resume``     the CLI around a resuming build (attrs carry
               ``resumed_from_step``)
``attempt``    the supervisor (``resilience/supervisor.py``): one per
               launched child; the child's whole tree hangs under it
``kill`` /     the supervisor: killing a lost child, then the restart
``restart`` /  decision and its backoff wait, between two attempts
``backoff``
=============  =====================================================

A launcher passes :func:`env_extra` into a child's environment from inside
the span that brackets the child (the supervisor's ``attempt``), so the
child's session joins that trace under it.  The reference's engine spans
(``request``) and its in-thread context come with the engine (ROADMAP A8).

Design constraints, inherited from the obs layer:

* **Zero ops in the jitted step** — spans are host-side wall clocks at
  the same boundaries events already fire; the step's ops are
  identical with spans on vs off (pinned by test).
* **Never load-bearing** — emission failures are swallowed; a closed
  trace drops late spans silently.
* **Pure stdlib** — importable by the supervisor parent on a wedged
  box without initialising CUDA.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

ENV_VAR = "OBS_TRACE_CONTEXT"
SPAN_KIND = "span"

def new_id() -> str:
    """A 16-hex-char random id (span ids; trace ids use the same)."""
    return uuid.uuid4().hex[:16]


class SpanContext:
    """Where in the one causal timeline we are: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def decode(cls, s: str) -> Optional["SpanContext"]:
        parts = str(s).split(":")
        if len(parts) != 2 or not parts[0] or not parts[1]:
            return None
        return cls(parts[0], parts[1])

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"SpanContext({self.encode()})"


# ------------------------------------------------------- propagation

def from_env() -> Optional[SpanContext]:
    """The context a parent process exported, or None."""
    raw = os.environ.get(ENV_VAR)
    return SpanContext.decode(raw) if raw else None


def env_extra(session: Any) -> Dict[str, str]:
    """The env block a launcher passes to a child so the child's spans
    join this session's trace under the current span (call it inside the
    span that brackets the child's life: the supervisor's ``attempt``).
    Empty when the session has no span emitter."""
    emitter = getattr(session, "spans", None)
    if emitter is None or emitter.trace is None:
        return {}
    return {ENV_VAR: emitter.current().encode()}


# ------------------------------------------------------------ records

def make_span_record(name: str, trace_id: str, span_id: str,
                     parent_id: Optional[str], start: float, dur_s: float,
                     attrs: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """One span as an obs event record (the single schema definition)."""
    from . import trace as trace_lib

    rec: Dict[str, Any] = {
        "schema": trace_lib.SCHEMA_VERSION,
        "kind": SPAN_KIND,
        "t": float(start) + float(dur_s),
        "name": str(name),
        "trace_id": str(trace_id),
        "span_id": str(span_id),
        "parent_id": str(parent_id) if parent_id else None,
        "start": float(start),
        "dur_s": float(dur_s),
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    return rec


# ------------------------------------------------------------ emitter

class SpanEmitter:
    """Per-session span factory bound to one TraceWriter.

    The emitter owns the session's trace identity: a fresh ``trace_id``
    when no context was inherited (this session is a trace root), the
    parent's ``trace_id`` otherwise.  A long-lived **root span** (named
    after the tool) brackets the whole session; it is emitted by
    :meth:`close` — exporters see it last in the log but its ``start``
    is the session open.  :meth:`span` is the context manager for
    everything else; nesting is tracked per thread (a span opened on
    the heartbeat thread parents to the root, not to whatever the main
    thread happens to be inside).
    """

    def __init__(self, trace: Any, context: Optional[SpanContext] = None,
                 root_name: str = "run",
                 root_attrs: Optional[Dict[str, Any]] = None):
        self.trace = trace
        self.inherited = context
        self.trace_id = context.trace_id if context else new_id()
        self.root_id = new_id()
        self.root_name = str(root_name)
        self.root_attrs = dict(root_attrs) if root_attrs else {}
        self._root_start = time.time()
        self._root_t0 = time.monotonic()
        self._root_emitted = False
        self._stacks = threading.local()

    # -- context ------------------------------------------------------

    def _stack(self) -> List[SpanContext]:
        stack = getattr(self._stacks, "stack", None)
        if stack is None:
            stack = self._stacks.stack = []
        return stack

    def current(self) -> SpanContext:
        """This thread's innermost open span (the root when none is)."""
        stack = self._stack()
        return stack[-1] if stack else SpanContext(self.trace_id,
                                                   self.root_id)

    def manifest_block(self) -> Dict[str, Any]:
        """The ``trace`` block stamped into the session manifest: how a
        reader joins this log to its parents without parsing spans."""
        return {
            "trace_id": self.trace_id,
            "root_span_id": self.root_id,
            "parent_span_id": (self.inherited.span_id
                               if self.inherited else None),
        }

    # -- emission -----------------------------------------------------

    def _write(self, rec: Dict[str, Any]) -> None:
        # TraceWriter.event() rebuilds schema/t; write through it so the
        # manifest-first rule and thread-safe locking apply unchanged.
        try:
            payload = {k: v for k, v in rec.items()
                       if k not in ("schema", "kind", "t")}
            self.trace.event(SPAN_KIND, **payload)
        except Exception:  # noqa: BLE001 — never load-bearing
            pass

    def emit(self, name: str, start: float, dur_s: float,
             parent_id: Optional[str] = None, span_id: Optional[str] = None,
             **attrs: Any) -> Optional[str]:
        """Record an already-measured span (no context manager — the
        caller timed it; e.g. the recorder's compile span, the CLI's
        resume span).  Parents to this thread's current span unless an
        explicit ``parent_id`` is given.  Returns the span id."""
        if self.trace is None:
            return None
        sid = span_id or new_id()
        rec = make_span_record(
            name, self.trace_id, sid,
            parent_id if parent_id is not None else self.current().span_id,
            start, dur_s, attrs or None)
        self._write(rec)
        return sid

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Optional[SpanContext]]:
        """Open a span around a code block; emitted at exit with the
        measured duration.  Yields the span's context (what a launcher
        encodes into a child's ``OBS_TRACE_CONTEXT``)."""
        if self.trace is None:
            yield None
            return
        parent = self.current().span_id
        ctx = SpanContext(self.trace_id, new_id())
        stack = self._stack()
        stack.append(ctx)
        start = time.time()
        t0 = time.monotonic()
        try:
            yield ctx
        finally:
            if stack and stack[-1] is ctx:
                stack.pop()
            rec = make_span_record(name, self.trace_id, ctx.span_id,
                                   parent, start, time.monotonic() - t0,
                                   attrs or None)
            self._write(rec)

    def close(self, **attrs: Any) -> None:
        """Emit the root span (idempotent).  Call BEFORE the trace
        writer closes — a post-close emission is dropped silently."""
        if self._root_emitted or self.trace is None:
            return
        self._root_emitted = True
        merged = dict(self.root_attrs)
        merged.update(attrs)
        rec = make_span_record(
            self.root_name, self.trace_id, self.root_id,
            self.inherited.span_id if self.inherited else None,
            self._root_start, time.monotonic() - self._root_t0,
            merged or None)
        self._write(rec)


def maybe_span(emitter: Optional[SpanEmitter], name: str, **attrs: Any):
    """``emitter.span(...)`` or a null context when there is no emitter
    — the one-liner call sites (cli, supervisor) use."""
    if emitter is not None:
        return emitter.span(name, **attrs)
    return contextlib.nullcontext()
