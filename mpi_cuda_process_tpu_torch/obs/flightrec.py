"""Post-mortem flight recorder: a bounded event ring + one-file bundle.

The port's counterpart of the TPU package's ``obs/flightrec.py``: the
same bundle schema and kind.  Every session keeps a bounded in-memory
ring of its most recent records (a :class:`~.trace.TraceWriter` mirror —
no extra I/O, nothing in the step), and on a terminal verdict (an error,
DIVERGED, or a clean exit with anomaly findings: DEGRADED) one
**self-validating, self-contained JSON bundle** is written next to the
log:

* manifest (provenance, config, trace identity block)
* the last-N events verbatim + how many the ring dropped
* open spans at bundle time (root + the emitting thread's stack)
* anomaly findings (obs/anomaly.py) and the final verdict
* ``best_known``: the campaign ledger's row for this label x backend
  (``obs/ledger.py``), or null where there is none
* ``tunnel``: the card probe's verdict (:func:`card_verdict`, the
  counterpart of the TPU package's ``tunnel_verdict``): opt-in, run by the
  supervisor's give-up bundle; a run's own bundle records NOT_RUN, so a
  failing run's teardown stays bounded
* ``sibling_events``: the tails of other logs (the supervisor's give-up
  bundle carries the final attempt's child log), when given
* a whitelisted env snapshot (fault injection, obs, device selection)

A bundle is readable with the original telemetry dir deleted.  Bundle
writes are best-effort everywhere they are triggered: the recorder must
never turn a failing run into a failing-harder run.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from . import trace as trace_lib

BUNDLE_SCHEMA = 1
BUNDLE_KIND = "flight_bundle"
DEFAULT_CAPACITY = 256
DEFAULT_LAST_N = 120

# env vars worth carrying into a post-mortem: fault harness, obs, device
# and process-group selection — never the whole environment (secrets)
_ENV_WHITELIST_PREFIXES = ("FAULT_", "OBS_", "MPI_CUDA_PROCESS_TORCH_",
                           "CUDA_", "NCCL_", "TORCH_")


class FlightRecorder:
    """Bounded ring of a session's most recent records.

    Registered as a :class:`~.trace.TraceWriter` mirror: every record
    the writer persists (manifest first, then events) also lands here,
    so the ring is exactly the tail of the on-disk log — no second
    vocabulary, no sampling bias beyond recency.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.manifest: Optional[Dict[str, Any]] = None
        self.events_seen = 0

    def note(self, rec: Dict[str, Any]) -> None:
        if not isinstance(rec, dict):
            return
        if rec.get("kind") == "manifest":
            self.manifest = rec
            return
        self.events_seen += 1
        self.ring.append(rec)

    def events(self, last_n: int = DEFAULT_LAST_N) -> List[Dict[str, Any]]:
        return list(self.ring)[-last_n:]


# ------------------------------------------------------------- capture

def open_spans(session) -> List[Dict[str, Any]]:
    """Best-effort snapshot of spans still open at bundle time.

    The emitter's stacks are per-thread; what a post-mortem can honestly
    capture is the root span (open for the whole run) plus the calling
    thread's stack.  Each entry carries the ids a reader needs to join
    against the exported timeline.
    """
    em = getattr(session, "spans", None)
    if em is None:
        return []
    out: List[Dict[str, Any]] = []
    try:
        blk = em.manifest_block()
        out.append({"name": getattr(em, "root_name", None), "role": "root",
                    **blk})
        for ctx in list(getattr(em, "_stack", lambda: [])()):
            out.append({"name": getattr(ctx, "name", None),
                        "role": "open",
                        "trace_id": getattr(ctx, "trace_id", None),
                        "span_id": getattr(ctx, "span_id", None)})
    except Exception:  # noqa: BLE001 — best-effort by contract
        pass
    return out


def env_snapshot() -> Dict[str, str]:
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(_ENV_WHITELIST_PREFIXES)}


# the card probe: the card's name and power limit, then one one-element
# CUDA op, in a subprocess with a timeout (a wedged card hangs the probe,
# never the caller)
_PROBE_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
_PROBE_OP = ("import torch; x = torch.ones(1, device='cuda') + 1; "
             "torch.cuda.synchronize(); print(torch.cuda.get_device_name(0),"
             " float(x.item()))")


def card_verdict(run: bool = False,
                 timeout_s: float = 60.0) -> Dict[str, Any]:
    """The card probe's verdict for a bundle's ``tunnel`` field:
    NOT_RUN unless ``run``.  Run, it reads ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` and launches one one-element CUDA op in a
    fresh interpreter, each a subprocess under ``timeout_s``: ``OK`` when
    both answer (the op's result 2.0), else ``FAIL`` with what went wrong.
    Never raises."""
    if not run:
        return {"verdict": "NOT_RUN",
                "detail": "no card probe in a run's own bundle"}
    out: Dict[str, Any] = {}
    try:
        smi = subprocess.run(_PROBE_SMI, capture_output=True, text=True,
                             timeout=timeout_s)
        out["nvidia_smi"] = (smi.stdout.strip() if smi.returncode == 0
                             else f"rc={smi.returncode}: "
                                  f"{smi.stderr.strip()[:200]}")
        op = subprocess.run([sys.executable, "-c", _PROBE_OP],
                            capture_output=True, text=True,
                            timeout=timeout_s)
        line = op.stdout.strip().splitlines()[-1:] or [""]
        ok = (smi.returncode == 0 and op.returncode == 0
              and line[0].endswith(" 2.0"))
        out["cuda_op"] = (line[0] if op.returncode == 0
                          else f"rc={op.returncode}: "
                               f"{op.stderr.strip()[-300:]}")
        return {"verdict": "OK" if ok else "FAIL",
                "detail": "card answered" if ok else "probe failed",
                **out}
    except Exception as e:  # noqa: BLE001 — never block the bundle
        return {"verdict": "FAIL", "detail": f"{type(e).__name__}: {e}"[:300],
                **out}


def _best_known_for(manifest: Optional[Dict[str, Any]]) -> Optional[Dict]:
    """The ledger's best_known row for this run's label, best-effort."""
    try:
        from . import ledger as ledger_lib

        if not manifest or manifest.get("tool") != "cli":
            return None
        prov = manifest.get("provenance") or {}
        return ledger_lib.lookup_best(manifest.get("run") or {},
                                      prov.get("backend", "cpu"),
                                      source="flightrec-probe")
    except Exception:  # noqa: BLE001 — the ledger may not exist yet
        return None


# -------------------------------------------------------------- bundle

def build_bundle(manifest: Optional[Dict[str, Any]],
                 events: List[Dict[str, Any]],
                 reason: str,
                 verdict: Optional[str] = None,
                 events_seen: Optional[int] = None,
                 open_span_list: Optional[List[Dict[str, Any]]] = None,
                 extra_events: Optional[Dict[str, List[Dict]]] = None,
                 run_probe: bool = False,
                 last_n: int = DEFAULT_LAST_N) -> Dict[str, Any]:
    """Assemble a self-contained post-mortem; validates before returning.

    ``extra_events`` attaches sibling tails under their own keys;
    ``run_probe`` runs the card probe (:func:`card_verdict`).
    ``verdict=None`` is replayed from the events through
    :class:`~.metrics.RunMetrics` — one verdict definition, not two.
    """
    events = [e for e in events if isinstance(e, dict)][-last_n:]
    anomalies = [e for e in events if e.get("kind") == "anomaly"]
    if verdict is None:
        try:
            from . import metrics as metrics_lib

            rm = metrics_lib.RunMetrics()
            if manifest:
                rm.ingest(manifest)
            for e in events:
                rm.ingest(e)
            verdict = rm.status().get("verdict")
        except Exception:  # noqa: BLE001
            verdict = "UNKNOWN"
    bundle: Dict[str, Any] = {
        "schema": BUNDLE_SCHEMA,
        "kind": BUNDLE_KIND,
        "created_at": time.time(),
        "reason": str(reason),
        "verdict": verdict,
        "manifest": manifest,
        "trace": (manifest or {}).get("trace"),
        "events": events,
        "events_seen": int(events_seen if events_seen is not None
                           else len(events)),
        "open_spans": open_span_list or [],
        "anomalies": anomalies,
        "best_known": _best_known_for(manifest),
        "tunnel": card_verdict(run=run_probe),
        "env": env_snapshot(),
    }
    if extra_events:
        bundle["sibling_events"] = {
            k: [e for e in v if isinstance(e, dict)][-last_n:]
            for k, v in extra_events.items()}
    validate_bundle(bundle)
    return bundle


def validate_bundle(b: Any) -> Dict[str, Any]:
    """Raise ValueError listing EVERY problem; return ``b`` when valid."""
    if not isinstance(b, dict):
        raise ValueError(f"bundle must be a dict, got {type(b).__name__}")
    problems: List[str] = []
    if b.get("schema") != BUNDLE_SCHEMA:
        problems.append(f"schema must be {BUNDLE_SCHEMA} "
                        f"(got {b.get('schema')!r})")
    if b.get("kind") != BUNDLE_KIND:
        problems.append(f"kind must be {BUNDLE_KIND!r} (got {b.get('kind')!r})")
    if not isinstance(b.get("created_at"), (int, float)) \
            or b.get("created_at", 0) <= 0:
        problems.append("created_at must be a positive unix time")
    if not isinstance(b.get("reason"), str) or not b.get("reason"):
        problems.append("reason must be a nonempty str")
    m = b.get("manifest")
    if m is not None:
        try:
            trace_lib.validate_manifest(m)
        except ValueError as e:
            problems.append(f"manifest: {e}")
    evs = b.get("events")
    if not isinstance(evs, list):
        problems.append("events must be a list")
    else:
        for i, e in enumerate(evs):
            try:
                trace_lib.validate_event(e)
            except ValueError as err:
                problems.append(f"event {i}: {err}")
                break  # one bad event names the class; don't flood
    if not isinstance(b.get("events_seen"), int) or b["events_seen"] < 0:
        problems.append("events_seen must be a nonnegative int")
    for key in ("open_spans", "anomalies"):
        if not isinstance(b.get(key), list):
            problems.append(f"{key} must be a list")
    tun = b.get("tunnel")
    if not isinstance(tun, dict) or not isinstance(tun.get("verdict"), str):
        problems.append("tunnel must be a dict with a str verdict")
    if not isinstance(b.get("env"), dict):
        problems.append("env must be a dict")
    if problems:
        raise ValueError("invalid flight bundle: " + "; ".join(problems))
    return b


def default_bundle_path(log_path: str) -> str:
    """``x.jsonl`` -> ``x.bundle.json``, beside the log."""
    path = os.path.abspath(log_path)
    if path.endswith(".jsonl"):
        path = path[:-len(".jsonl")]
    return path + ".bundle.json"


def write_bundle(bundle: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(bundle, fh, default=str, indent=1)
        fh.write("\n")
    return path


def read_bundle(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return validate_bundle(json.load(fh))


def is_bundle_file(path: str) -> bool:
    """Cheap sniff: a JSON object whose kind is ``flight_bundle``."""
    try:
        with open(path) as fh:
            head = fh.read(512).lstrip()
        if not head.startswith("{"):
            return False
        if f'"{BUNDLE_KIND}"' in head:
            return True
        with open(path) as fh:
            obj = json.load(fh)
        return isinstance(obj, dict) and obj.get("kind") == BUNDLE_KIND
    except Exception:  # noqa: BLE001
        return False


def bundle_from_session(session, reason: str,
                        verdict: Optional[str] = None,
                        run_probe: bool = False,
                        extra_events: Optional[Dict[str, List[Dict]]] = None,
                        ) -> Optional[str]:
    """Emit a bundle from a live session's ring; returns the path or None.

    Best-effort by contract: every failure is swallowed — this runs in
    teardown paths where the run is already dying.
    """
    try:
        flight = getattr(session, "flight", None)
        if flight is None:
            return None
        bundle = build_bundle(
            flight.manifest, flight.events(), reason, verdict=verdict,
            events_seen=flight.events_seen,
            open_span_list=open_spans(session),
            extra_events=extra_events, run_probe=run_probe)
        return write_bundle(bundle, default_bundle_path(session.path))
    except Exception:  # noqa: BLE001 — never fail the failing run harder
        return None


def bundle_from_log(log_path: str, reason: str = "on-demand",
                    out_path: Optional[str] = None) -> str:
    """On-demand bundle from a finished (or abandoned) telemetry log."""
    manifest, events = trace_lib.read_log(log_path)
    if manifest.get("kind") != "manifest":
        raise ValueError(f"{log_path}: first record is not a manifest")
    bundle = build_bundle(manifest, events, reason,
                          events_seen=len(events))
    return write_bundle(bundle, out_path or default_bundle_path(log_path))
