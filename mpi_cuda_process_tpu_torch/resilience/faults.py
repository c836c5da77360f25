"""Deterministic fault injection: every recovery path gets a reproducible
trigger.

The port's copy of the TPU package's ``resilience/faults.py`` (pure
stdlib there too; the port keeps its own copy, since it imports nothing of
that package): the same grammar, sites, actions and environment
variables, so one ``FAULT_INJECT`` means the same fault in both packages,
and a child process inherits its faults with no plumbing.

``FAULT_INJECT`` — comma-separated specs, each ``site[:qual]*:action``::

    FAULT_INJECT=exchange:step=40:sigkill
    FAULT_INJECT=checkpoint:during_write:step=20:sigkill
    FAULT_INJECT=compile:hang

The sites the port calls :func:`maybe_fire` from:

* ``exchange``   — the CLI's chunk boundary (``cli.run``'s callback and
  ``cli._run_until_converged``'s residual checks): fires at the first
  boundary whose absolute step is >= ``step=N``, BEFORE that boundary's
  checkpoint save (so a kill at step 40 leaves the step-30 checkpoint as
  the newest survivor).  Host-side: the recovery contract (die or hang
  mid-run between checkpoints) needs step-granular determinism at the
  boundary, not a fault inside an exchange.  On a mesh that spans
  processes every process runs the same boundaries, so one spec set on
  every process kills them all at the same step.
* ``checkpoint`` — inside both checkpoint writers
  (``utils/checkpointing.py``); ``before_write`` (at entry) or
  ``during_write`` (payload fully written to the temporary directory,
  atomic rename NOT yet performed — the window the rename guarantee
  protects).  ``step=N`` gates on the step being saved.
* ``compile``    — in ``driver.make_runner`` as a runner is built: the
  stand-in for "the build hung".
* ``heartbeat``  — the heartbeat's stall probe (``obs/heartbeat.py``):
  action ``wedge`` replaces the subprocess probe with a deterministic
  WEDGED verdict (:func:`injected_heartbeat_verdict`).
* ``numerics``   — deterministic state corruption: action ``nan`` puts one
  NaN in the centre cell of the first float field at the first chunk
  boundary at/past ``step=N`` (``FAULT_INJECT=numerics:step=40:nan``);
  the CLI consults :func:`injected_numeric_poison` there and applies
  ``obs.health.apply_nan_poison``, so ``--health`` reports DIVERGED at
  that boundary, before its checkpoint.

The TPU package's ``label`` site (measurement campaigns) lives in a module
the port does not have yet (ROADMAP A9); its specs parse here as there.

Qualifiers: ``step=N``, ``name=STR``, ``before_write``/``during_write``,
``attempt=N``, ``always``.  A spec is active only on the restart attempt
it names — ``FAULT_ATTEMPT`` (default 0) must equal ``attempt=N``
(default 0) unless the spec says ``always``: the fault fires on attempt
0, the relaunch runs clean, and the final state must bit-match an
uninterrupted run.

Actions: ``sigkill`` (SIGKILL self — a real crash: no atexit, no
flush), ``hang`` (stop making progress; capped at ``FAULT_HANG_S``,
default 3600 s, then SIGKILL), ``raise`` (raise :class:`FaultInjected`),
``wedge`` (heartbeat site only), ``nan`` (numerics site only),
``sleep:MS`` (stall the boundary for MS milliseconds then return; the
exchange, checkpoint and label sites).  Every spec fires at most once per
process.  A malformed spec raises at the first fault-point hit: injection
is explicit opt-in, and silence would hide a typo.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import Dict, List, Optional, Tuple

ENV_VAR = "FAULT_INJECT"
ATTEMPT_VAR = "FAULT_ATTEMPT"
HANG_CAP_VAR = "FAULT_HANG_S"

_SITES = ("exchange", "checkpoint", "compile", "label", "heartbeat",
          "numerics")
_ACTIONS = ("sigkill", "hang", "raise", "wedge", "nan", "sleep")
_PHASES = ("before_write", "during_write")
# sleep is a SLOWDOWN, not a death: it only makes sense at sites the
# run returns from
_SLEEP_SITES = ("exchange", "checkpoint", "label")


class FaultInjected(RuntimeError):
    """The ``raise`` action: an injected, clearly-labeled failure."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    action: str
    step: Optional[int] = None
    phase: Optional[str] = None
    name: Optional[str] = None
    attempt: int = 0
    always: bool = False
    sleep_ms: Optional[int] = None
    raw: str = ""


def parse_specs(text: str) -> List[FaultSpec]:
    """Parse a ``FAULT_INJECT`` value; raises ValueError on any bad spec."""
    specs: List[FaultSpec] = []
    for raw in filter(None, (p.strip() for p in (text or "").split(","))):
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"fault spec {raw!r}: want site[:qualifier]*:action")
        site, action = parts[0], parts[-1]
        quals = parts[1:-1]
        # sleep carries its duration as a trailing field: ``…:sleep:MS``
        # (the one action with an operand, so the grammar stays
        # site[:qual]*:action for everything else)
        sleep_ms: Optional[int] = None
        if len(parts) >= 3 and parts[-2] == "sleep" and \
                parts[-1].isdigit():
            action, sleep_ms = "sleep", int(parts[-1])
            quals = parts[1:-2]
        if site not in _SITES:
            raise ValueError(f"fault spec {raw!r}: unknown site {site!r} "
                             f"(one of {_SITES})")
        if action not in _ACTIONS:
            raise ValueError(f"fault spec {raw!r}: unknown action "
                             f"{action!r} (one of {_ACTIONS})")
        if (action == "wedge") != (site == "heartbeat"):
            raise ValueError(f"fault spec {raw!r}: 'wedge' is the "
                             "heartbeat site's action (and its only one)")
        if (action == "nan") != (site == "numerics"):
            raise ValueError(f"fault spec {raw!r}: 'nan' is the "
                             "numerics site's action (and its only one)")
        if action == "sleep":
            if sleep_ms is None or sleep_ms <= 0:
                raise ValueError(
                    f"fault spec {raw!r}: 'sleep' wants a positive "
                    "duration — site[:qual]*:sleep:MS")
            if site not in _SLEEP_SITES:
                raise ValueError(
                    f"fault spec {raw!r}: 'sleep' fires only at "
                    f"{_SLEEP_SITES} (a slowdown needs a site the run "
                    "returns from)")
        kw: Dict[str, object] = {}
        for q in quals:
            if q == "always":
                kw["always"] = True
            elif q in _PHASES:
                kw["phase"] = q
            elif q.startswith("step="):
                kw["step"] = int(q[len("step="):])
            elif q.startswith("attempt="):
                kw["attempt"] = int(q[len("attempt="):])
            elif q.startswith("name="):
                kw["name"] = q[len("name="):]
            else:
                raise ValueError(
                    f"fault spec {raw!r}: unknown qualifier {q!r} (want "
                    "step=N, name=STR, attempt=N, always, "
                    f"{' or '.join(_PHASES)})")
        specs.append(FaultSpec(site=site, action=action, raw=raw,
                               sleep_ms=sleep_ms, **kw))
    return specs


# Parse cache keyed on the raw env value: maybe_fire sits on chunk
# boundaries, so re-parsing an unchanged env var every chunk is waste,
# but a harness that mutates the env mid-process must still be honored.
_cache: Tuple[Optional[str], List[FaultSpec]] = (None, [])
_fired: set = set()


def active_specs() -> List[FaultSpec]:
    global _cache
    text = os.environ.get(ENV_VAR)
    if not text:
        return []
    if _cache[0] != text:
        _cache = (text, parse_specs(text))
    return _cache[1]


def current_attempt() -> int:
    """The supervisor's restart counter (0 on an unsupervised run)."""
    try:
        return int(os.environ.get(ATTEMPT_VAR, "0") or 0)
    except ValueError:
        return 0


def _applies(spec: FaultSpec, site: str, step: Optional[int],
             phase: Optional[str], name: Optional[str]) -> bool:
    if spec.site != site or spec.raw in _fired:
        return False
    if not spec.always and spec.attempt != current_attempt():
        return False
    if spec.step is not None and (step is None or step < spec.step):
        return False
    if spec.phase is not None and phase != spec.phase:
        return False
    if spec.name is not None and name != spec.name:
        return False
    return True


def _trigger(spec: FaultSpec) -> None:
    print(f"[faults] firing {spec.raw!r} (pid {os.getpid()}, "
          f"attempt {current_attempt()})", file=sys.stderr, flush=True)
    if spec.action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
        # unreachable on POSIX; belt-and-braces for exotic platforms
        os._exit(137)
    if spec.action == "hang":
        try:
            cap = float(os.environ.get(HANG_CAP_VAR, "3600") or 3600)
        except ValueError:
            cap = 3600.0
        deadline = time.monotonic() + cap
        while time.monotonic() < deadline:
            time.sleep(0.25)
        # cap expired with no supervisor kill: die loudly, never return
        # into the run as if nothing happened (a hang that "recovers"
        # would fake a RECOVERED verdict)
        os.kill(os.getpid(), signal.SIGKILL)
        os._exit(137)
    if spec.action == "sleep":
        # a slowdown, not a death: stall the boundary then RETURN —
        # the deterministic stand-in for a straggler host
        time.sleep((spec.sleep_ms or 0) / 1000.0)
        return
    if spec.action == "raise":
        raise FaultInjected(f"injected fault: {spec.raw}")


def maybe_fire(site: str, step: Optional[int] = None,
               phase: Optional[str] = None,
               name: Optional[str] = None) -> None:
    """Fire the first matching active fault spec for ``site`` (if any).

    The framework's fault points call this; with ``FAULT_INJECT`` unset
    it is a dict lookup and a return.  Each spec fires at most once per
    process (so ``step=40`` means "the first boundary at/past 40", not
    every one after it).
    """
    for spec in active_specs():
        if _applies(spec, site, step, phase, name):
            _fired.add(spec.raw)
            _trigger(spec)


def injected_numeric_poison(step: Optional[int] = None) -> Optional[FaultSpec]:
    """The ``numerics`` site: one-shot, step-gated state poisoning.

    Returns the first matching active spec (marking it fired — the
    poison lands ONCE, like a real bit flip) or None.  The caller owns
    the actual corruption (``obs.health.apply_nan_poison``).
    """
    for spec in active_specs():
        if spec.site == "numerics" and spec.action == "nan" and \
                _applies(spec, "numerics", step, None, None):
            _fired.add(spec.raw)
            print(f"[faults] firing {spec.raw!r} (pid {os.getpid()}, "
                  f"attempt {current_attempt()})", file=sys.stderr,
                  flush=True)
            return spec
    return None


def injected_heartbeat_verdict() -> Optional[Dict[str, str]]:
    """The ``heartbeat:wedge`` site: a deterministic WEDGED probe verdict.

    Consulted by ``obs.heartbeat.Heartbeat`` before running its real
    probe; returns None when no wedge fault is
    active for this attempt.  Not consumed — the injected backend
    stays wedged for every stall episode of the process, like a real
    wedge would.
    """
    for spec in active_specs():
        if spec.site == "heartbeat" and spec.action == "wedge" and \
                (spec.always or spec.attempt == current_attempt()):
            return {"verdict": "WEDGED",
                    "detail": f"injected fault ({spec.raw}) — "
                              "deterministic stand-in for a wedged "
                              "backend probe"}
    return None


def reset() -> None:
    """Forget fired specs (test isolation across in-process runs)."""
    _fired.clear()
