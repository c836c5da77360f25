"""A run's verdict, folded from its telemetry stream.

The port's counterpart of the verdict half of the TPU package's
``obs/metrics.py``: :class:`RunMetrics` ingests the records a run writes
(manifest, chunks, heartbeat verdicts, health checks, halo audits, anomaly
findings, errors, the summary) and :meth:`RunMetrics.status` gives the
same verdict the reference gives on the same records — the flight
recorder replays a log through it (``flightrec.build_bundle``).  The
reference's Prometheus registry and the ``/status.json`` panels it feeds
(throughput, scheduler, router, policy, campaign) come with
``obs/serve.py`` (ROADMAP A8).

Pure stdlib: importable from anywhere (a parent process watching a
wedged child) without initialising CUDA.
"""

from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Optional


class RunMetrics:
    """The obs-event vocabulary, folded into one verdict.

    The first manifest seen is the run's identity.  Verdicts, from the
    hardest down: a DIVERGED health check (of the run or of any group of
    a coupled run) dominates everything; else the latest heartbeat
    verdict; else DEGRADED once any anomaly was found; else DONE after a
    summary and ALIVE before one.
    """

    def __init__(self, max_errors: int = 20):
        self.manifest: Optional[Dict[str, Any]] = None
        self.events_seen = 0
        self.latest_chunk: Optional[Dict[str, Any]] = None
        self.heartbeat: Optional[Dict[str, Any]] = None
        self.health: Optional[Dict[str, Any]] = None
        self.halo_audit: Optional[Dict[str, Any]] = None
        # per-group health verdicts of a coupled run, by group name
        self.group_verdicts: Dict[str, Any] = {}
        self.anomalies_total = 0
        self.summary: Optional[Dict[str, Any]] = None
        self.errors: Deque[Dict[str, Any]] = \
            collections.deque(maxlen=max_errors)

    def ingest(self, rec: Dict[str, Any]) -> None:
        """Fold one obs record (manifest or event) into the aggregate.

        Unknown kinds are counted but otherwise ignored; a malformed
        record is skipped — an observer never raises."""
        if not isinstance(rec, dict):
            return
        self.events_seen += 1
        kind = rec.get("kind")
        try:
            if kind == "manifest":
                if self.manifest is None:
                    self.manifest = rec
            elif kind == "chunk":
                self.latest_chunk = rec
            elif kind == "heartbeat":
                self.heartbeat = rec
            elif kind == "health":
                self.health = rec
                group = rec.get("group")
                if isinstance(group, str) and group:
                    self.group_verdicts[group] = rec.get("verdict")
            elif kind == "halo_audit":
                self.halo_audit = rec
            elif kind == "anomaly":
                self.anomalies_total += 1
            elif kind in ("error", "abort"):
                self.errors.append(rec)
            elif kind == "summary":
                self.summary = rec
        except Exception:  # noqa: BLE001 — an observer never raises
            pass

    def verdict(self) -> str:
        if (self.health or {}).get("verdict") == "DIVERGED" or \
                "DIVERGED" in self.group_verdicts.values():
            # correctness dominates liveness: a run that diverged is
            # lost whatever the heartbeat says
            return "DIVERGED"
        hb = (self.heartbeat or {}).get("verdict")
        if hb is not None:
            return hb
        if self.anomalies_total:
            # a run that finished slow finished DEGRADED
            return "DEGRADED"
        return "DONE" if self.summary else "ALIVE"

    def status(self) -> Dict[str, Any]:
        """The verdict with the records it was read from."""
        return {
            "verdict": self.verdict(),
            "manifest": self.manifest,
            "events_seen": self.events_seen,
            "latest_chunk": self.latest_chunk,
            "heartbeat": self.heartbeat,
            "health": self.health,
            "halo_audit": self.halo_audit,
            "groups": dict(self.group_verdicts),
            "anomalies": self.anomalies_total,
            "summary": self.summary,
            "errors": list(self.errors),
        }
