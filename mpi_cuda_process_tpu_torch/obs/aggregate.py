"""Multi-process telemetry aggregation: N per-process logs, one status.

The port's counterpart of the TPU package's ``obs/aggregate.py``.  Every
process of a launch writes its own log (``trace.process_log_path``) whose
schema-2 manifest stamps ``process_index`` / ``process_count`` /
``hostname``, so every record's origin is knowable from the file it
arrived in.  A :class:`HostAggregator` routes each record to a
per-(hostname, process_index) :class:`~.metrics.RunMetrics` and
summarizes them into a **per-process table** (``hosts``: one row a
process, keyed ``host|p<index>``) plus launch-level aggregates (summed
throughput, the worst verdict, distinct trace ids, the straggler).

:func:`make_console` builds the live face: a :class:`~.serve.RunConsole`
whose per-path ingest hook feeds the aggregator too, so ``/status.json``
carries the ``hosts`` table next to the merged single-stream payload —
under ``torchrun`` process 0 serves every process's log through one
address (``cli._open_serve``).  :func:`aggregate_logs` is the offline
sibling for finished logs.

Pure stdlib (RunMetrics is); importable on a wedged box.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Dict, Iterable, Optional

from . import metrics as metrics_lib

_UNKNOWN = "?|p?"


def iter_records(path: str) -> Iterable[Dict[str, Any]]:
    """Tolerant JSONL reader: complete, well-formed dict lines only (a
    mid-write tail or a torn line is skipped, the contract of
    ``trace.LogTail``)."""
    try:
        fh = open(path, "rb")
    except OSError:
        return
    with fh:
        for line in fh:
            if not line.endswith(b"\n"):
                break  # incomplete tail: not yet written out
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8", errors="replace"))
            except ValueError:
                continue
            if isinstance(rec, dict):
                yield rec


class HostAggregator:
    """Route records (by source file) into per-process RunMetrics.

    A source file's identity is its manifest's provenance: the first
    manifest seen on a path binds the path to a ``hostname|pN`` group.
    Thread-safe: group creation and the summary snapshot share a lock;
    per-record ingestion relies on each RunMetrics' own registry lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._group_of: Dict[str, str] = {}  # source path -> group key
        self._groups: "collections.OrderedDict[str, metrics_lib.RunMetrics]" \
            = collections.OrderedDict()
        self._meta: Dict[str, Dict[str, Any]] = {}  # group -> provenance

    @staticmethod
    def group_key(manifest: Dict[str, Any]) -> str:
        prov = manifest.get("provenance") or {}
        host = prov.get("hostname") or "?"
        pidx = prov.get("process_index")
        pidx = pidx if isinstance(pidx, int) else "?"
        return f"{host}|p{pidx}"

    def _group(self, key: str,
               manifest: Optional[Dict[str, Any]] = None) \
            -> metrics_lib.RunMetrics:
        with self._lock:
            rm = self._groups.get(key)
            if rm is None:
                rm = self._groups[key] = metrics_lib.RunMetrics()
            if manifest is not None and key not in self._meta:
                prov = manifest.get("provenance") or {}
                self._meta[key] = {
                    "hostname": prov.get("hostname"),
                    "process_index": prov.get("process_index"),
                    "process_count": prov.get("process_count"),
                    "backend": prov.get("backend"),
                    "device_count": prov.get("device_count"),
                }
            return rm

    def ingest(self, source: str, rec: Dict[str, Any]) -> None:
        if not isinstance(rec, dict):
            return
        if rec.get("kind") == "manifest":
            key = self.group_key(rec)
            with self._lock:
                self._group_of[source] = key
            self._group(key, manifest=rec).ingest(rec)
            return
        with self._lock:
            key = self._group_of.get(source, _UNKNOWN)
        self._group(key).ingest(rec)

    def ingest_log(self, path: str) -> int:
        n = 0
        for rec in iter_records(path):
            self.ingest(path, rec)
            n += 1
        return n

    # -- summary -------------------------------------------------------

    @staticmethod
    def _row(key: str, rm: metrics_lib.RunMetrics,
             meta: Dict[str, Any]) -> Dict[str, Any]:
        st = rm.status()
        chunk = st.get("latest_chunk") or {}
        row: Dict[str, Any] = {
            "key": key,
            "hostname": meta.get("hostname"),
            "process_index": meta.get("process_index"),
            "process_count": meta.get("process_count"),
            "backend": meta.get("backend"),
            "verdict": st.get("verdict"),
            "events_seen": st.get("events_seen"),
            "manifests_seen": st.get("manifests_seen"),
            "latest_chunk": {k: chunk.get(k) for k in
                             ("chunk", "steps", "ms_per_step", "t")
                             if k in chunk} or None,
            "throughput": st.get("throughput") or {},
            # the supervisor's trail (0 and False until it is ported:
            # ROADMAP A8), kept so a row reads as the reference's
            "restarts": len(st.get("restarts") or ()),
            "resumed_from_step": st.get("resumed_from_step"),
            "give_up": bool(st.get("give_up")),
        }
        for opt in ("trace_id", "time_to_first_chunk_s", "anomalies"):
            if st.get(opt) is not None:
                row[opt] = st[opt]
        return row

    def status(self) -> Dict[str, Any]:
        """The roll-up payload: ``hosts`` (one row per host/process
        slot) + ``aggregate`` (launch sums and the worst verdict)."""
        with self._lock:
            items = [(key, rm, dict(self._meta.get(key) or {}))
                     for key, rm in self._groups.items()]
        rows = [self._row(key, rm, meta) for key, rm, meta in items]
        verdicts = [r.get("verdict") for r in rows]
        worst = "ALIVE"
        if any(r.get("give_up") for r in rows):
            worst = "GAVE_UP"
        # DIVERGED outranks liveness trouble: a process provably
        # computing garbage is worse than one merely stuck — and anything
        # stuck outranks DEGRADED, which is still making progress
        for v in ("DIVERGED", "WEDGED", "STALLED", "DEGRADED"):
            if v in verdicts:
                worst = v
                break
        else:
            if worst == "ALIVE" and rows and \
                    all(v == "DONE" for v in verdicts):
                worst = "DONE"
        agg: Dict[str, Any] = {
            "processes": len(rows),
            "hosts": len({r.get("hostname") for r in rows}),
            "verdict": worst,
            "events_seen": sum(r.get("events_seen") or 0 for r in rows),
            "restarts": sum(r.get("restarts") or 0 for r in rows),
            "gcells_per_s": round(sum(
                (r.get("throughput") or {}).get("gcells_per_s") or 0.0
                for r in rows), 4),
            "steps_per_s": round(sum(
                (r.get("throughput") or {}).get("steps_per_s") or 0.0
                for r in rows), 3),
            "trace_ids": sorted({r["trace_id"] for r in rows
                                 if r.get("trace_id")}),
        }
        anomalies = sum((r.get("anomalies") or {}).get("count") or 0
                        for r in rows)
        if anomalies:
            agg["anomalies"] = anomalies
        # straggler attribution: per-process ms/step from the latest
        # chunk is the homogeneous slowness signal (every process runs the
        # same program), so the peer-median comparison of obs/anomaly.py
        # applies directly
        suspect = self._straggler(rows)
        if suspect is not None:
            agg["straggler"] = suspect
        return {"hosts": rows, "aggregate": agg}

    @staticmethod
    def _straggler(rows) -> Optional[Dict[str, Any]]:
        from . import anomaly as anomaly_lib
        entries = []
        for r in rows:
            chunk = r.get("latest_chunk") or {}
            ms = chunk.get("ms_per_step")
            if isinstance(ms, (int, float)) and ms > 0:
                entries.append({"name": r["key"], "slowness": float(ms)})
        try:
            return anomaly_lib.attribute_straggler(entries, kind="host")
        except Exception:  # noqa: BLE001 — diagnosis is best-effort
            return None


def aggregate_logs(paths: Iterable[str]) -> Dict[str, Any]:
    """Offline roll-up of finished (or in-flight) telemetry logs: the
    same ``hosts``/``aggregate`` payload the live console serves."""
    agg = HostAggregator()
    for p in paths:
        agg.ingest_log(p)
    return agg.status()


def make_console(paths: Iterable[str] = (), max_events: int = 4096):
    """Build the live aggregate console (a RunConsole subclass whose
    per-path ingest feeds a :class:`HostAggregator` and whose
    ``status()`` merges the ``hosts`` table into the payload)."""
    from . import serve as serve_lib

    class _AggregateConsole(serve_lib.RunConsole):
        def __init__(self):
            super().__init__(max_events=max_events)
            self.aggregator = HostAggregator()

        def _ingest(self, path: str, rec: Dict[str, Any]) -> None:
            super()._ingest(path, rec)
            self.aggregator.ingest(path, rec)

        def status(self) -> Dict[str, Any]:
            out = super().status()
            roll = self.aggregator.status()
            out["hosts"] = roll["hosts"]
            out["aggregate"] = roll["aggregate"]
            return out

    console = _AggregateConsole()
    for p in paths:
        console.watch(p)
    return console
