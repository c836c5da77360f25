"""Stall-detecting heartbeat: a daemon thread that watches a run's progress.

The port's counterpart of the TPU package's ``obs/heartbeat.py``.  A
daemon thread watches a progress signal (a
:class:`~.runtime.RuntimeRecorder`'s ``last_progress`` or any
monotonic-time callable) and, when no progress lands for
``stall_after_s``, writes a STALLED verdict event to the trace; it then
runs a BOUNDED subprocess probe of the card to escalate:

* the probe's CUDA synchronize returns → the stall is in-process (a slow
  kernel build, a host hang, a peer that stopped answering): the verdict
  stays **STALLED** with the card's state in the detail;
* the probe hangs past its timeout → **WEDGED** (even a trivial
  synchronize on the card does not return);
* the probe's environment is broken → ENVIRONMENT; no CUDA device
  visible → NO_CUDA (nothing to wedge, the stall is in-process).

One verdict per stall episode (no event spam); progress landing again
emits RECOVERED and re-arms.  Every probe is a fresh subprocess with a
hard timeout, so the heartbeat itself can never hang the run it watches.
The probe opens a second CUDA context on the card, which holds device
memory of its own while it lives: ``probe_verdict`` reports it
(``context_bytes``: the card's free memory before the probe, read in this
process where CUDA is already up, less the free memory the probe reads
after its synchronize).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Union

from ..resilience import faults

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Progress source: an object exposing ``last_progress`` (monotonic
# seconds, RuntimeRecorder) or a zero-arg callable returning the same.
ProgressSource = Union[Callable[[], float], Any]

_CPU_PROBE = ("import torch; "
              "print('OK', int(torch.add(torch.ones(1), 1).item()))")
_CUDA_PROBE = (
    "import torch\n"
    "if not torch.cuda.is_available():\n"
    "    print('OK nocuda')\n"
    "else:\n"
    "    x = torch.ones(1, device='cuda') + 1\n"
    "    torch.cuda.synchronize()\n"
    "    free, total = torch.cuda.mem_get_info()\n"
    "    print('OK cuda', int(x.item()), free, total)\n")


def _last_progress(source: ProgressSource) -> float:
    if callable(source):
        return float(source())
    return float(source.last_progress)


def _run_code(code: str, timeout_s: float) -> Dict[str, Any]:
    """Run a python snippet in a fresh subprocess with a hard timeout."""
    t0 = time.monotonic()
    try:
        p = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=timeout_s, cwd=_REPO)
        return {"ok": p.returncode == 0 and "OK" in p.stdout,
                "hang": False, "rc": p.returncode,
                "stdout": p.stdout.strip()[-200:],
                "wall_s": round(time.monotonic() - t0, 2)}
    except subprocess.TimeoutExpired:
        return {"ok": False, "hang": True,
                "wall_s": round(time.monotonic() - t0, 2)}
    except Exception as e:  # noqa: BLE001 — a probe must not crash
        return {"ok": False, "hang": False,
                "error": f"{type(e).__name__}: {e}",
                "wall_s": round(time.monotonic() - t0, 2)}


def _free_here() -> Optional[int]:
    """The card's free bytes read in this process, where CUDA is already
    initialised (a probe must not initialise CUDA in the watched run)."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return int(torch.cuda.mem_get_info()[0])
    except Exception:  # noqa: BLE001
        pass
    return None


def probe_verdict(timeout_s: float = 60.0) -> Dict[str, Any]:
    """Quick two-probe verdict on the card (bounded by ~2x ``timeout_s``).

    ENVIRONMENT (this machine's python environment is broken), NO_CUDA
    (no CUDA device is visible: nothing to wedge), WEDGED (a trivial
    CUDA synchronize hung past the budget), CARD_HEALTHY (the card
    answered within budget), INCONCLUSIVE.  Never raises."""
    cpu = _run_code(_CPU_PROBE, timeout_s)
    if not cpu.get("ok"):
        return {"verdict": "ENVIRONMENT",
                "detail": "the CPU control probe failed — this "
                          "machine/python env is broken independent of "
                          "any card", "probes": [cpu]}
    before = _free_here()
    dev = _run_code(_CUDA_PROBE, timeout_s)
    if dev.get("hang"):
        return {"verdict": "WEDGED",
                "detail": "a trivial CUDA synchronize hung past the probe "
                          "budget — the card (or its driver) is wedged",
                "probes": [cpu, dev]}
    out = dev.get("stdout", "").split()
    if dev.get("ok") and "nocuda" in out:
        return {"verdict": "NO_CUDA",
                "detail": "no CUDA device is visible — nothing to wedge; "
                          "the stall is in-process",
                "probes": [cpu, dev]}
    if dev.get("ok"):
        rec = {"verdict": "CARD_HEALTHY",
               "detail": "the card answered a synchronize within budget "
                         "— the stall is in-process (slow kernel build, "
                         "host hang or a silent peer)",
               "probes": [cpu, dev]}
        try:
            free_probe = int(out[out.index("cuda") + 2])
            if before is not None:
                rec["context_bytes"] = before - free_probe
        except (ValueError, IndexError):
            pass
        return rec
    return {"verdict": "INCONCLUSIVE",
            "detail": "device probe failed without hanging — read the "
                      "probe records", "probes": [cpu, dev]}


class Heartbeat(threading.Thread):
    """Watch a progress source; write STALLED/WEDGED verdicts to a trace.

    ``probe`` (a zero-arg callable returning a ``probe_verdict``-shaped
    dict) runs ONCE per stall episode to escalate; tests inject a stub,
    production uses :func:`probe_verdict`.  ``trace`` receives
    ``heartbeat`` events; ``last_verdict`` always holds the newest one.
    The ``heartbeat`` fault site (``FAULT_INJECT=heartbeat:wedge``)
    replaces the probe with a deterministic WEDGED verdict.
    """

    def __init__(self, source: ProgressSource, trace=None,
                 stall_after_s: float = 300.0,
                 poll_s: Optional[float] = None,
                 probe: Optional[Callable[[], Dict[str, Any]]] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(daemon=True, name="obs-heartbeat")
        self.source = source
        self.trace = trace
        self.stall_after_s = float(stall_after_s)
        self.poll_s = poll_s if poll_s is not None else \
            min(30.0, max(0.05, self.stall_after_s / 4.0))
        self.probe = probe_verdict if probe is None else probe
        self.clock = clock
        self.last_verdict: Dict[str, Any] = {"verdict": "ALIVE",
                                             "detail": "no stall observed"}
        self._stop_evt = threading.Event()
        self._stalled_episode = False

    def _emit(self, verdict: str, detail: str, **payload: Any) -> None:
        self.last_verdict = {"verdict": verdict, "detail": detail, **payload}
        if self.trace is not None:
            try:
                self.trace.event("heartbeat", verdict=verdict,
                                 detail=detail, **payload)
            except Exception:  # noqa: BLE001 — observer, never load-bearing
                pass

    def run(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            idle = self.clock() - _last_progress(self.source)
            if idle < self.stall_after_s:
                if self._stalled_episode:
                    self._stalled_episode = False
                    self._emit("RECOVERED",
                               "progress resumed after a stall",
                               idle_s=round(idle, 2))
                continue
            if self._stalled_episode:
                continue  # one verdict per episode, no event spam
            self._stalled_episode = True
            self._emit("STALLED",
                       f"no progress for {idle:.1f}s "
                       f"(threshold {self.stall_after_s:.1f}s); probing "
                       "the card", idle_s=round(idle, 2))
            try:
                probe = faults.injected_heartbeat_verdict() or self.probe()
            except Exception as e:  # noqa: BLE001
                probe = {"verdict": "INCONCLUSIVE",
                         "detail": f"probe raised {type(e).__name__}: {e}"}
            if probe.get("verdict") == "WEDGED":
                self._emit("WEDGED", probe.get("detail", ""),
                           idle_s=round(self.clock()
                                        - _last_progress(self.source), 2),
                           probe=probe)
            else:
                self._emit("STALLED",
                           "card probe: "
                           f"{probe.get('verdict')} — "
                           f"{probe.get('detail', '')}",
                           probe=probe)

    def stop(self, join_timeout_s: float = 5.0,
             final_verdict: str = "SUPERVISOR_KILL") -> None:
        """Stop the watcher; never raises.  An open stall episode is
        closed with a final ``final_verdict`` event rather than left
        dangling (a trace ending mid-episode reads like a writer that
        died)."""
        try:
            if self._stalled_episode:
                self._stalled_episode = False
                self._emit(final_verdict,
                           "watcher stopped while a stall episode was "
                           "open (teardown path)")
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass
        try:
            self._stop_evt.set()
            if self.is_alive():
                self.join(join_timeout_s)
        except Exception:  # noqa: BLE001
            pass
