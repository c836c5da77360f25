"""Cooperative run cancellation.

The engine's ``RunHandle.cancel()`` (and the serving scheduler's job
cancel) need a way to stop a run that is *already executing* without
killing the process and without corrupting state.  The mechanism is
deliberately cooperative and chunk-grained: a cancel token is attached
to the executing thread (``scope``), and the CLI's chunk-boundary
callback polls it (``check``) — the one place the driver synchronizes
the state anyway, so cancellation adds no launch to the step and never
interrupts a chunk mid-flight.

A cancelled run raises :class:`RunCancelled`, which every layer treats
as a *third* terminal outcome — neither success nor error:

* ``cli._run_once`` writes a ``cancelled`` telemetry event (NOT an
  ``error`` event) before closing the session;
* ``engine.RunHandle`` reports phase ``"cancelled"`` and re-raises
  :class:`RunCancelled` from ``result()``;
* ``obs/ledger.py`` quarantines the row with reason ``"cancelled"``,
  never ``"errored: ..."``;
* ``resilience/supervisor.py`` classifies a ``cancelled`` event as
  fatal-no-restart — a deliberately stopped child is not a crash to
  resume from.

This module lives outside both ``engine`` and ``cli`` so either can
import it without a cycle (cli must never depend on the request layer).
The port's copy of the TPU package's module.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

__all__ = ["RunCancelled", "scope", "requested", "check"]


class RunCancelled(BaseException):
    """Raised at a chunk boundary when the run's cancel token is set.

    Derives from ``BaseException`` (like ``KeyboardInterrupt``) so the
    broad ``except Exception`` recovery paths — accounting guards,
    telemetry that is never load-bearing — can never swallow a
    cancellation and keep running.
    """

    def __init__(self, step: int):
        super().__init__(f"run cancelled at step {step}")
        self.step = step


_tls = threading.local()


@contextlib.contextmanager
def scope(token: threading.Event) -> Iterator[None]:
    """Attach ``token`` as the executing thread's cancel token.

    The engine wraps ``cli.run`` in this; nesting restores the outer
    token on exit so an engine-in-engine composition stays correct.
    """
    prev = getattr(_tls, "token", None)
    _tls.token = token
    try:
        yield
    finally:
        _tls.token = prev


def _token() -> Optional[threading.Event]:
    return getattr(_tls, "token", None)


def requested() -> bool:
    """Has this thread's run been asked to stop? (False outside a scope.)"""
    tok = _token()
    return tok is not None and tok.is_set()


def check(step: int) -> None:
    """Raise :class:`RunCancelled` if this thread's token is set.

    Called from the CLI's chunk-boundary callback — the cancellation
    point contract: state at the boundary is complete and consistent, so
    the run ends as cleanly as if ``iters`` had been reached.
    """
    if requested():
        raise RunCancelled(step)
