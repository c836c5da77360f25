"""In-process metrics registry: the live face of the telemetry stream.

The port's counterpart of the TPU package's ``obs/metrics.py``: the same
registry, metric names, Prometheus text and ``/status.json`` payload, so
one reader (a scrape, a dashboard) takes both packages' runs.  Everything
here is populated **purely from the records a run already writes** at
chunk boundaries — nothing touches the step, so a served run launches
exactly what an unserved one does (``tests/test_torch_serve.py``,
chip_smoke.py phase 5k).

Two layers:

* :class:`MetricsRegistry` — a generic, pure-stdlib metric store.
  Every mutation and every read happens under ONE registry lock, so a
  :meth:`~MetricsRegistry.snapshot` (and the ``/metrics`` scrape built on
  it) is **snapshot-consistent**: a reader never sees half of a
  multi-metric update.  Histograms keep a bounded reservoir of the newest
  observations (count / sum / min / max stay exact over the full stream)
  and report nearest-rank p50/p90/p99.

* :class:`RunMetrics` — the obs-vocabulary ingester: feed it the records
  the port writes (manifest, chunk, group_chunk, heartbeat, health,
  halo_audit, anomaly, exchange, resume, span, error, summary) and it
  keeps both the Prometheus-facing registry (steps/s, Gcells/s, the
  compile vs steady split, recompiles, device-memory peak, exchange mode,
  heartbeat and health verdicts) and the structured :meth:`status`
  payload that ``obs/serve.py`` exposes as ``/status.json``; the flight
  recorder replays a log through it for its verdict.  ``costmodel``
  (``obs/costmodel.py``) sets the roofline gauges and the supervisor's
  ``launch`` / ``restart`` / ``give_up`` (``resilience/supervisor.py``)
  its restart trail; ``cancelled`` (a cooperative cancel,
  ``cancellation.py``) the CANCELLED verdict, and the serving layer's
  ``scheduler`` and ``router`` records (``serving/``) the scheduler and
  fleet blocks of ``/status.json``.  The reference's handlers for records
  only unported modules write come with those modules: ``policy`` /
  ``migrate`` (the policy layer) and ``label`` (the measurement harness,
  A9).

Pure stdlib: importable from anywhere (a parent process watching a
wedged child) without initialising CUDA.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

_QUANTILES = (0.5, 0.9, 0.99)


def quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile of an already-sorted list (NaN when empty)."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


def _prom_label_value(v: Any) -> str:
    s = str(v)
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_prom_name(str(k))}="{_prom_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_value(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """Monotone counter.  Mutate only through the owning registry's lock
    (the registry's ``inc`` helper, or inside ``with registry.lock``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def render(self) -> List[str]:
        return [f"{_prom_name(self.name)} {_prom_value(self.value)}"]

    def snap(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-value (or peak, via :meth:`set_max`) gauge."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        v = float(v)
        if self.value is None or v > self.value:
            self.value = v

    def render(self) -> List[str]:
        if self.value is None:
            return []
        return [f"{_prom_name(self.name)} {_prom_value(self.value)}"]

    def snap(self) -> Dict[str, Any]:
        return {"kind": self.kind, "value": self.value}


class Info:
    """Constant-1 gauge whose payload is its labels (the Prometheus
    ``_info`` idiom): run identity, exchange mode, heartbeat verdict."""

    kind = "info"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.labels: Dict[str, Any] = {}

    def set(self, **labels: Any) -> None:
        self.labels = {k: v for k, v in labels.items() if v is not None}

    def render(self) -> List[str]:
        if not self.labels:
            return []
        return [f"{_prom_name(self.name)}{_prom_labels(self.labels)} 1"]

    def snap(self) -> Dict[str, Any]:
        return {"kind": self.kind, "labels": dict(self.labels)}


class GaugeFamily:
    """Labeled gauge family: one value per label set, rendered as one
    Prometheus line each (``name{label="..",backend=".."} v``) — the
    shape the ledger's ``best_known`` table exports as (label x backend
    baselines on ``/metrics``, so the live console and the ledger stop
    being separate surfaces)."""

    kind = "gauge_family"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.values: "collections.OrderedDict[Tuple, Tuple[Dict[str, Any], float]]" = \
            collections.OrderedDict()

    def set(self, value: float, **labels: Any) -> None:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        self.values[key] = (dict(labels), float(value))

    def render(self) -> List[str]:
        name = _prom_name(self.name)
        return [f"{name}{_prom_labels(labels)} {_prom_value(v)}"
                for labels, v in self.values.values()]

    def snap(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "values": [{"labels": dict(labels), "value": v}
                           for labels, v in self.values.values()]}


class Histogram:
    """Bounded-reservoir histogram: newest ``bound`` observations.

    ``count``/``sum``/``min``/``max`` stay exact over the whole stream;
    the quantiles (nearest-rank p50/p90/p99) are computed over the
    reservoir — for the chunk-cadence streams this serves (hundreds of
    observations per run) the reservoir usually IS the stream, and for
    multi-day runs the sliding window is the more useful statistic
    anyway (a throughput regression three hours ago should not hide in
    a lifetime median).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "", bound: int = 512):
        self.name = name
        self.help = help
        self.bound = max(1, int(bound))
        self.reservoir: Deque[float] = collections.deque(maxlen=self.bound)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.reservoir.append(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantiles(self) -> Dict[float, float]:
        vals = sorted(self.reservoir)
        return {q: quantile(vals, q) for q in _QUANTILES}

    def render(self) -> List[str]:
        name = _prom_name(self.name)
        out = []
        for q, v in self.quantiles().items():
            out.append(f'{name}{{quantile="{q}"}} {_prom_value(v)}')
        out.append(f"{name}_count {_prom_value(self.count)}")
        out.append(f"{name}_sum {_prom_value(self.sum)}")
        return out

    def snap(self) -> Dict[str, Any]:
        return {"kind": self.kind, "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "quantiles": {str(q): v
                              for q, v in self.quantiles().items()}}


# Prometheus TYPE vocabulary for each metric class (Info renders as a
# gauge; the bounded-reservoir histogram renders as a summary — it
# exposes quantiles, not cumulative buckets).
_PROM_TYPE = {"counter": "counter", "gauge": "gauge", "info": "gauge",
              "gauge_family": "gauge", "histogram": "summary"}


class MetricsRegistry:
    """Ordered, lock-consistent metric store.

    All get-or-create accessors take the lock themselves; bulk updates
    that must be atomic as a GROUP (one ingested event touching several
    metrics) wrap themselves in ``with registry.lock`` — the accessors
    use an RLock so both patterns compose.
    """

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()

    def _get(self, cls, name: str, help: str, **kw: Any):
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def info(self, name: str, help: str = "") -> Info:
        return self._get(Info, name, help)

    def gauge_family(self, name: str, help: str = "") -> GaugeFamily:
        return self._get(GaugeFamily, name, help)

    def histogram(self, name: str, help: str = "",
                  bound: int = 512) -> Histogram:
        return self._get(Histogram, name, help, bound=bound)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """A consistent point-in-time view of every metric."""
        with self.lock:
            return {name: m.snap() for name, m in self._metrics.items()}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the registry."""
        with self.lock:
            lines: List[str] = []
            for name, m in self._metrics.items():
                body = m.render()
                if not body:
                    continue
                if m.help:
                    lines.append(f"# HELP {_prom_name(name)} {m.help}")
                lines.append(f"# TYPE {_prom_name(name)} "
                             f"{_PROM_TYPE[m.kind]}")
                lines.extend(body)
            return "\n".join(lines) + ("\n" if lines else "")



# --------------------------------------------------------- obs ingester

def _grid_cells(run: Dict[str, Any]) -> Optional[int]:
    grid = run.get("grid")
    if isinstance(grid, (list, tuple)) and grid and \
            all(isinstance(g, int) for g in grid):
        cells = 1
        for g in grid:
            cells *= g
        ens = run.get("ensemble")
        if isinstance(ens, int) and ens > 0:
            cells *= ens
        return cells
    return None



class RunMetrics:
    """The obs-event vocabulary, folded into a registry + status payload.

    One instance aggregates an arbitrary MERGED stream of obs records — a
    single CLI run, or the per-process logs of a multi-process launch.
    The first manifest seen is the run's identity; later manifests are
    counted.  Every :meth:`ingest` holds the registry lock for the whole
    record, so a concurrent snapshot sees each event's metrics either
    fully applied or not at all.  The verdict, from the hardest down: a
    DIVERGED health check (of the run or of any group of a coupled run);
    else the latest heartbeat verdict; else DEGRADED once any anomaly was
    found; else DONE after a summary and ALIVE before one.
    """

    def __init__(self, max_chunks: int = 240, max_errors: int = 20):
        self.registry = MetricsRegistry()
        self.manifest: Optional[Dict[str, Any]] = None
        self.manifests_seen = 0
        self.events_seen = 0
        self.latest_chunk: Optional[Dict[str, Any]] = None
        self.chunks_recent: Deque[Dict[str, Any]] = \
            collections.deque(maxlen=max_chunks)
        self.exchange: Optional[Dict[str, Any]] = None
        self.heartbeat: Optional[Dict[str, Any]] = None
        # numerics sentinel: latest health check + audit — a DIVERGED
        # health verdict dominates the status verdict (a fast, alive,
        # WRONG run must never read as healthy)
        self.health: Optional[Dict[str, Any]] = None
        self.halo_audit: Optional[Dict[str, Any]] = None
        # run doctor (obs/anomaly.py): recent performance findings — any
        # finding turns the status verdict DEGRADED (dominated by every
        # harder verdict: a slow run is not a dead run)
        self.anomalies: Deque[Dict[str, Any]] = collections.deque(maxlen=32)
        self.anomalies_total = 0
        self.anomaly_kinds: Dict[str, int] = {}
        self.summary: Optional[Dict[str, Any]] = None
        self.resumed_from_step: Optional[int] = None
        # the static cost block (obs/costmodel.py) and the supervisor's
        # restart trail (resilience/supervisor.py)
        self.costmodel: Optional[Dict[str, Any]] = None
        self.launches: List[Dict[str, Any]] = []
        self.restarts: List[Dict[str, Any]] = []
        self.give_up: Optional[Dict[str, Any]] = None
        # coupled-run group table (parallel/groups.py): one row per
        # device group, seeded from the manifest's ``groups`` block and
        # refreshed by group_chunk / per-group health events
        self.groups: "collections.OrderedDict[str, Dict[str, Any]]" = \
            collections.OrderedDict()
        self.errors: Deque[Dict[str, Any]] = \
            collections.deque(maxlen=max_errors)
        self._cells: Optional[int] = None
        self._members: int = 0  # ensemble size (0 = unbatched run)
        # span tracing: the trace identity this stream belongs to
        self.trace_id: Optional[str] = None
        self.spans_seen = 0
        self.time_to_first_chunk_s: Optional[float] = None
        # cooperative cancel (cancellation.py): a third terminal state,
        # neither DONE nor an error
        self.cancelled: Optional[Dict[str, Any]] = None
        # serving-scheduler aggregate (serving/scheduler.py events):
        # queue depth, slot occupancy, per-op and per-tenant counters —
        # rendered under status()["scheduler"]
        self.scheduler: Optional[Dict[str, Any]] = None
        # fleet-router aggregate (serving/router.py events): replica
        # liveness, routing/rebalance counters — status()["router"]
        self.router: Optional[Dict[str, Any]] = None

    # -- ingestion ------------------------------------------------------

    def ingest(self, rec: Dict[str, Any]) -> None:
        """Fold one obs record (manifest or event) into the aggregate.

        Unknown kinds are counted but otherwise ignored — the registry
        must survive anything a future schema rev appends.  Never
        raises on a well-formed-but-unexpected record; a malformed one
        (non-dict fields where dicts are expected) is skipped.
        """
        if not isinstance(rec, dict):
            return
        with self.registry.lock:
            try:
                self._ingest_locked(rec)
            except Exception:  # noqa: BLE001 — an observer never raises
                self.registry.counter(
                    "obs_ingest_errors_total",
                    "records the ingester could not fold").inc()

    def _ingest_locked(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("kind")
        self.events_seen += 1
        self.registry.counter(
            "obs_events_total", "obs records ingested").inc()
        handler = getattr(self, f"_on_{kind}", None)
        if handler is not None:
            handler(rec)

    def _set_trace_id(self, trace_id: Any) -> None:
        if self.trace_id is None and isinstance(trace_id, str) and trace_id:
            self.trace_id = trace_id
            self.registry.info(
                "obs_trace_info",
                "causal trace identity this stream belongs to").set(
                trace_id=trace_id)

    def _on_manifest(self, rec: Dict[str, Any]) -> None:
        self.manifests_seen += 1
        self.registry.counter(
            "obs_manifests_total",
            "manifests seen (supervised runs: 1 + one per attempt)").inc()
        self._set_trace_id((rec.get("trace") or {}).get("trace_id"))
        if self.manifest is not None:
            return
        self.manifest = rec
        run = rec.get("run") or {}
        prov = rec.get("provenance") or {}
        self._cells = _grid_cells(run)
        ens = run.get("ensemble")
        if isinstance(ens, int) and ens > 0:
            # a batched run must be distinguishable from a fast single
            # run at a glance: the size is a gauge AND an identity label
            self._members = ens
            self.registry.gauge(
                "obs_ensemble_size",
                "simultaneous simulations in the batched step").set(ens)
        for g in rec.get("groups") or ():
            # seed the group table from the manifest's plan describe():
            # the panel shows every group's identity before the first
            # group_chunk lands
            if isinstance(g, dict) and isinstance(g.get("group"), str):
                # mode tokens + interface transport ride the
                # manifest block, so the panel names each group's
                # execution path, not just its physics
                self.groups.setdefault(g["group"], {}).update(
                    {k: g.get(k) for k in ("op", "ratio", "dtype",
                                           "devices", "grid", "modes",
                                           "transport")
                     if g.get(k) is not None})
        self.registry.info(
            "obs_run_info", "identity of the (primary) run").set(
            tool=rec.get("tool"), stencil=run.get("stencil"),
            grid=",".join(map(str, run.get("grid") or [])) or None,
            mesh=",".join(map(str, run.get("mesh") or [])) or None,
            ensemble=ens if ens else None,
            backend=prov.get("backend"),
            device_kind=prov.get("device_kind"),
            hostname=prov.get("hostname"),
            process_index=prov.get("process_index"),
            git_sha=str(prov.get("git_sha", ""))[:12] or None)

    def _on_chunk(self, rec: Dict[str, Any]) -> None:
        steps = int(rec.get("steps") or 0)
        wall = float(rec.get("wall_s") or 0.0)
        ms = rec.get("ms_per_step")
        self.latest_chunk = rec
        self.chunks_recent.append(
            {"chunk": rec.get("chunk"), "steps": steps, "wall_s": wall,
             "ms_per_step": ms, "recompiled": bool(rec.get("recompiled")),
             "t": rec.get("t")})
        self.registry.counter("obs_chunks_total", "chunks completed").inc()
        self.registry.counter("obs_steps_total",
                              "real steps completed").inc(steps)
        if rec.get("recompiled"):
            self.registry.counter(
                "obs_recompiles_total",
                "chunks that recompiled mid-run (shape drift)").inc()
        first = rec.get("chunk") == 0
        if first and ms is not None:
            self.registry.gauge(
                "obs_first_chunk_ms_per_step",
                "compile+warmup chunk ms/step").set(ms)
        if first and self.time_to_first_chunk_s is None \
                and self.manifest is not None:
            # time to first results: wall seconds from the stream's
            # FIRST manifest (the run open) to the first completed chunk
            created = (self.manifest or {}).get("created_at")
            t_end = rec.get("t")
            if isinstance(created, (int, float)) and \
                    isinstance(t_end, (int, float)) and t_end >= created:
                self.time_to_first_chunk_s = round(t_end - created, 6)
                self.registry.gauge(
                    "obs_time_to_first_chunk_s",
                    "seconds from run open to the first completed "
                    "chunk (compile + warmup + first results)").set(
                    self.time_to_first_chunk_s)
        if not first and ms is not None and not rec.get("recompiled"):
            self.registry.histogram(
                "obs_chunk_ms_per_step",
                "steady-state ms/step (compile chunk excluded)").observe(ms)
        if wall > 0 and steps > 0:
            rate = steps / wall
            self.registry.gauge("obs_steps_per_s",
                                "latest chunk steps/s").set(rate)
            if self._cells:
                agg = self._cells * rate / 1e9
                self.registry.gauge(
                    "obs_gcells_per_s",
                    "latest chunk AGGREGATE throughput, Gcells/s "
                    "(all ensemble members)").set(agg)
                if self._members:
                    self.registry.gauge(
                        "obs_member_gcells_per_s",
                        "latest chunk per-member throughput, "
                        "Gcells/s").set(agg / self._members)
        mem = rec.get("memory") or {}
        peak = mem.get("peak_bytes_in_use")
        if peak is not None:
            self.registry.gauge(
                "obs_device_memory_peak_bytes",
                "max device memory peak over all chunks").set_max(peak)
        self._update_roofline_gap()

    def _on_group_chunk(self, rec: Dict[str, Any]) -> None:
        """Fold one per-group chunk of a coupled run (cli._run_coupled):
        each device group's own op/resolution/dtype identity and its
        throughput, keyed by the group name (``g0:wave3d``)."""
        name = rec.get("group")
        if not isinstance(name, str) or not name:
            return
        self.registry.counter("obs_group_chunks_total",
                              "coupled-run group chunks ingested").inc()
        entry = self.groups.setdefault(name, {})
        for k in ("op", "ratio", "dtype"):
            if rec.get(k) is not None:
                entry[k] = rec[k]
        entry["last_step"] = rec.get("step")
        entry["steps_total"] = (entry.get("steps_total") or 0) + \
            int(rec.get("steps") or 0)
        mc = rec.get("mcells_per_s")
        if isinstance(mc, (int, float)):
            entry["mcells_per_s"] = mc
            self.registry.gauge_family(
                "obs_group_mcells_per_s",
                "latest per-group throughput of the coupled run, "
                "Mcells/s").set(mc, group=name,
                                op=str(rec.get("op") or ""))

    def _on_costmodel(self, rec: Dict[str, Any]) -> None:
        self.costmodel = rec
        roof = rec.get("roofline") or {}
        t_hbm = roof.get("predicted_ms_per_step_hbm")
        t_ici = roof.get("predicted_ms_per_step_exchange") or 0.0
        if t_hbm is not None:
            self.registry.gauge(
                "obs_predicted_ms_per_step_overlapped",
                "roofline ms/step, exchange fully hidden").set(
                max(t_hbm, t_ici))
            self.registry.gauge(
                "obs_predicted_ms_per_step_serial",
                "roofline ms/step, exchange on the critical path").set(
                t_hbm + t_ici)
        self._update_roofline_gap()

    def _update_roofline_gap(self) -> None:
        """measured p50 / predicted-overlapped: the attribution gap."""
        roof = (self.costmodel or {}).get("roofline") or {}
        t_hbm = roof.get("predicted_ms_per_step_hbm")
        if t_hbm is None:
            return
        t_ici = roof.get("predicted_ms_per_step_exchange") or 0.0
        pred = max(t_hbm, t_ici)
        steady = sorted(c["ms_per_step"] for c in self.chunks_recent
                        if c.get("chunk") != 0
                        and not c.get("recompiled")
                        and c.get("ms_per_step") is not None)
        if not steady or pred <= 0:
            return
        self.registry.gauge(
            "obs_roofline_gap_ratio",
            "measured steady p50 ms/step over the overlapped roofline "
            "prediction (1.0 = at the roofline)").set(
            quantile(steady, 0.5) / pred)

    def _on_heartbeat(self, rec: Dict[str, Any]) -> None:
        self.heartbeat = rec
        verdict = rec.get("verdict")
        self.registry.counter("obs_heartbeat_events_total",
                              "heartbeat verdict events").inc()
        self.registry.info("obs_heartbeat_verdict",
                           "latest heartbeat verdict").set(verdict=verdict)
        self.registry.gauge(
            "obs_stalled",
            "1 while the latest heartbeat verdict is STALLED/WEDGED").set(
            1.0 if verdict in ("STALLED", "WEDGED") else 0.0)

    def _on_health(self, rec: Dict[str, Any]) -> None:
        """Fold one numerics-sentinel check (obs/health.py)."""
        self.health = rec
        verdict = rec.get("verdict")
        group = rec.get("group")
        if isinstance(group, str) and group:
            # coupled runs health-check per group: the named group's
            # row carries its own verdict (a DIVERGED group still
            # dominates the run verdict through self.health below)
            self.groups.setdefault(group, {})["verdict"] = verdict
        self.registry.counter("obs_health_checks_total",
                              "health sentinel checks ingested").inc()
        self.registry.info(
            "obs_health_verdict",
            "latest simulation-health verdict").set(
            verdict=verdict,
            invariant=(rec.get("invariant") or {}).get("name"),
            reason=(str(rec.get("reason"))[:120]
                    if rec.get("reason") else None))
        self.registry.gauge(
            "obs_health_diverged",
            "1 while the latest health verdict is DIVERGED").set(
            1.0 if verdict == "DIVERGED" else 0.0)
        nf = rec.get("nonfinite_total")
        if isinstance(nf, (int, float)):
            self.registry.gauge(
                "obs_health_nonfinite_values",
                "NaN/Inf count across all fields, latest check").set(nf)
        inv = rec.get("invariant") or {}
        d = inv.get("drift")
        if isinstance(d, list):
            d = max((x for x in d if isinstance(x, (int, float))),
                    default=None)
        if isinstance(d, (int, float)) and math.isfinite(d):
            self.registry.gauge(
                "obs_health_invariant_drift",
                "registered-invariant drift vs the chunk-0 baseline "
                "(worst member)").set(d)
        wf = rec.get("worst_field") or {}
        if isinstance(wf.get("drift"), (int, float)):
            self.registry.gauge(
                "obs_health_worst_field_drift",
                "worst per-field mean drift vs the chunk-0 baseline "
                "(informational)").set(wf["drift"])

    def _on_anomaly(self, rec: Dict[str, Any]) -> None:
        """Fold one run-doctor finding (obs/anomaly.py): counted per
        kind, the suspect kept whole — /status.json must NAME the slow
        (host | group | member), not just count findings."""
        self.anomalies.append(rec)
        self.anomalies_total += 1
        kind = str(rec.get("anomaly") or "unknown")
        self.anomaly_kinds[kind] = self.anomaly_kinds.get(kind, 0) + 1
        self.registry.counter("obs_anomalies_total",
                              "run-doctor findings ingested").inc()
        self.registry.counter(
            f"obs_anomaly_{_prom_name(kind)}_total",
            f"'{kind}' anomaly findings").inc()
        self.registry.gauge(
            "obs_degraded",
            "1 once any performance anomaly was flagged").set(1.0)
        suspect = rec.get("suspect") or {}
        if isinstance(suspect, dict) and suspect.get("name"):
            self.registry.info(
                "obs_anomaly_suspect",
                "latest straggler/collapse attribution").set(
                kind=suspect.get("kind"), name=suspect.get("name"),
                lag_ratio=suspect.get("lag_ratio"), anomaly=kind)
        ratio = (rec.get("evidence") or {}).get("ratio")
        if isinstance(ratio, (int, float)):
            self.registry.gauge(
                "obs_anomaly_collapse_ratio",
                "latest ms/step over the run's own steady baseline").set(
                ratio)

    def _on_halo_audit(self, rec: Dict[str, Any]) -> None:
        self.halo_audit = rec
        self.registry.counter("obs_halo_audits_total",
                              "halo-exchange audit passes").inc()
        mm = rec.get("mismatch_total")
        if isinstance(mm, (int, float)) and mm:
            self.registry.counter(
                "obs_halo_audit_mismatches_total",
                "bit-mismatched received-slab words found by the "
                "halo audit").inc(mm)
        self.registry.gauge(
            "obs_halo_audit_ok",
            "1 while the latest halo audit bit-matched everywhere").set(
            1.0 if rec.get("ok") else 0.0)

    def _on_launch(self, rec: Dict[str, Any]) -> None:
        self.launches.append(rec)
        self.registry.gauge("obs_supervisor_attempts",
                            "supervised launches so far").set(
            len(self.launches))
        step = rec.get("resumed_from_step")
        if step is not None:
            self.resumed_from_step = int(step)
            self.registry.gauge(
                "obs_resumed_from_step",
                "checkpoint step the latest attempt resumed from").set(step)

    def _on_restart(self, rec: Dict[str, Any]) -> None:
        self.restarts.append(rec)
        self.registry.counter(
            "obs_supervisor_restarts_total",
            "supervisor kill+relaunch decisions").inc()

    def _on_give_up(self, rec: Dict[str, Any]) -> None:
        self.give_up = rec
        self.registry.gauge(
            "obs_supervisor_gave_up",
            "1 once the supervisor stopped restarting").set(1.0)

    def _on_resume(self, rec: Dict[str, Any]) -> None:
        step = rec.get("resumed_from_step")
        if step is not None:
            self.resumed_from_step = int(step)
            self.registry.gauge(
                "obs_resumed_from_step",
                "checkpoint step the latest attempt resumed from").set(step)

    def _on_exchange(self, rec: Dict[str, Any]) -> None:
        self.exchange = rec
        self.registry.info(
            "obs_exchange_mode",
            "halo-exchange transport and its honest backend tag").set(
            mode=rec.get("mode"), backend=rec.get("backend"))

    def _on_span(self, rec: Dict[str, Any]) -> None:
        """Fold one finished span: a duration histogram per span name on
        ``/metrics``, and the trace identity."""
        self.spans_seen += 1
        self.registry.counter("obs_spans_total",
                              "finished spans ingested").inc()
        self._set_trace_id(rec.get("trace_id"))
        name = rec.get("name")
        dur = rec.get("dur_s")
        if isinstance(name, str) and name and \
                isinstance(dur, (int, float)):
            safe = _prom_name(name)[:48]
            self.registry.histogram(
                f"obs_span_{safe}_seconds",
                f"duration of '{name}' spans").observe(dur)

    def _on_error(self, rec: Dict[str, Any]) -> None:
        self.errors.append(rec)
        self.registry.counter("obs_errors_total", "error events").inc()

    def _on_summary(self, rec: Dict[str, Any]) -> None:
        self.summary = rec
        self.registry.gauge("obs_run_complete",
                            "1 once a summary event landed").set(1.0)
        mc = rec.get("mcells_per_s")
        if isinstance(mc, (int, float)):
            self.registry.gauge("obs_summary_mcells_per_s",
                                "run-level throughput at exit").set(mc)

    def _on_cancelled(self, rec: Dict[str, Any]) -> None:
        self.cancelled = rec
        self.registry.counter("obs_run_cancelled_total",
                              "cooperative run cancellations").inc()
        self.registry.gauge(
            "obs_run_cancelled",
            "1 once the run was cancelled (not errored)").set(1.0)

    # gauges a scheduler event may carry; each becomes an obs_sched_*
    # gauge and a key of status()["scheduler"]
    _SCHED_GAUGES = (
        ("queue_depth", "jobs waiting for a member slot"),
        ("slots_total", "member slots across resident size classes"),
        ("slots_busy", "member slots currently running a job"),
        ("classes", "resident size classes (batched steps kept built)"),
    )

    def _on_scheduler(self, rec: Dict[str, Any]) -> None:
        """Fold one serving-scheduler event (serving/scheduler.py).

        Every event carries an ``op`` (submit/reject/join/retire/evict/
        preempt/cancel/class_build/grow/shrink/fail) plus the
        scheduler's current occupancy gauges; per-tenant ops are counted
        under the tenant's name so starvation is visible from
        ``/status.json`` alone.
        """
        op = str(rec.get("op") or "event")
        sched = self.scheduler
        if sched is None:
            sched = self.scheduler = {"counts": {}, "tenants": {}}
        sched["counts"][op] = sched["counts"].get(op, 0) + 1
        self.registry.counter(
            f"obs_sched_{_prom_name(op)}_total",
            f"scheduler '{op}' decisions").inc()
        for g, help_text in self._SCHED_GAUGES:
            v = rec.get(g)
            if isinstance(v, (int, float)):
                sched[g] = v
                self.registry.gauge(f"obs_sched_{g}", help_text).set(v)
        tenant = rec.get("tenant")
        if isinstance(tenant, str) and tenant:
            t = sched["tenants"].setdefault(tenant, {})
            t[op] = t.get(op, 0) + 1
            self.registry.gauge_family(
                "obs_sched_tenant_ops",
                "per-tenant scheduler decision counts").set(
                t[op], tenant=tenant, op=op)
        sc = rec.get("size_class")
        if isinstance(sc, str) and sc:
            # the per-class table: op counts plus the last-known
            # capacity/occupancy carried by class_build/grow/shrink events
            entry = sched.setdefault("size_classes", {}).setdefault(
                sc, {"ops": {}})
            entry["ops"][op] = entry["ops"].get(op, 0) + 1
            for k in ("capacity", "occupied"):
                v = rec.get(k)
                if isinstance(v, int):
                    entry[k] = v
        if op == "reject":
            # structured admission refusal: the reason is the payload
            sched["last_reject"] = {
                "tenant": tenant, "reason": rec.get("reason"),
                "size_class": rec.get("size_class"), "t": rec.get("t")}
        sched["last_event"] = {
            "op": op, "tenant": tenant, "job": rec.get("job"),
            "size_class": rec.get("size_class"), "t": rec.get("t")}

    # gauges a router event may carry; each becomes an obs_router_*
    # gauge and a key of status()["router"]
    _ROUTER_GAUGES = (
        ("replicas_alive", "engine replicas currently routable"),
        ("replicas_total", "engine replicas configured"),
        ("jobs_inflight", "router jobs not yet resolved"),
    )

    def _on_router(self, rec: Dict[str, Any]) -> None:
        """Fold one fleet-router event (serving/router.py).

        Every event carries an ``op`` (route/reject/rebalance/
        replica_up/replica_dead/give_up/drain) plus the router's liveness
        gauges; the last event and last death are kept whole so the
        fleet panel can say WHICH replica died without reading logs.
        """
        op = str(rec.get("op") or "event")
        rt = self.router
        if rt is None:
            rt = self.router = {"counts": {}}
        rt["counts"][op] = rt["counts"].get(op, 0) + 1
        self.registry.counter(
            f"obs_router_{_prom_name(op)}_total",
            f"router '{op}' decisions").inc()
        for g, help_text in self._ROUTER_GAUGES:
            v = rec.get(g)
            if isinstance(v, (int, float)):
                rt[g] = v
                self.registry.gauge(f"obs_router_{g}", help_text).set(v)
        if op == "replica_dead":
            rt["last_death"] = {
                "replica": rec.get("replica"), "t": rec.get("t"),
                "orphans": rec.get("orphans")}
        rt["last_event"] = {
            "op": op, "replica": rec.get("replica"),
            "job": rec.get("job"), "t": rec.get("t")}

    # -- status ---------------------------------------------------------

    def _throughput(self) -> Dict[str, Any]:
        steady = sorted(c["ms_per_step"] for c in self.chunks_recent
                        if c.get("chunk") != 0 and not c.get("recompiled")
                        and c.get("ms_per_step") is not None)
        out: Dict[str, Any] = {}
        if self._members:
            out["ensemble"] = self._members
        last = self.chunks_recent[-1] if self.chunks_recent else None
        if last and last.get("wall_s") and last.get("steps"):
            rate = last["steps"] / last["wall_s"]
            out["steps_per_s"] = round(rate, 3)
            if self._cells:
                agg = self._cells * rate / 1e9
                out["gcells_per_s"] = round(agg, 4)
                if self._members:
                    # aggregate AND per-member: the batched-vs-fast
                    # ambiguity resolved in one read
                    out["gcells_per_s_per_member"] = round(
                        agg / self._members, 4)
        if steady:
            out["steady_ms_per_step_p50"] = quantile(steady, 0.5)
            out["steady_ms_per_step_p90"] = quantile(steady, 0.9)
        return out

    def status(self) -> Dict[str, Any]:
        """The ``/status.json`` payload: one consistent dict.

        Everything a remote "is it wedged?" needs without reading any
        log file: provenance, the latest chunk, throughput, the heartbeat
        and health verdicts, the supervisor's restart trail (launches carry
        ``resumed_from_step``), the resume point, the roofline prediction
        and the errors; a cancelled run's ``cancelled`` record, and the
        serving layer's ``scheduler`` and ``router`` blocks.  The
        reference's policy and campaign panels come with their modules.
        """
        with self.registry.lock:
            hb = self.heartbeat
            verdict = hb.get("verdict") if hb else None
            if self.cancelled is not None and verdict is None:
                # a deliberate stop, distinct from DONE and from any
                # failure verdict (which all dominate it below)
                verdict = "CANCELLED"
            if (self.health or {}).get("verdict") == "DIVERGED" or any(
                    g.get("verdict") == "DIVERGED"
                    for g in self.groups.values()):
                # correctness dominates liveness: a run that diverged
                # is lost no matter what the heartbeat says (coupled
                # runs: ANY group's divergence is the run's)
                verdict = "DIVERGED"
            if verdict is None and self.anomalies:
                # performance findings degrade the verdict only when
                # nothing harder (heartbeat/diverge) claimed it — and
                # they outrank DONE: a run that finished slow finished
                # DEGRADED
                verdict = "DEGRADED"
            out: Dict[str, Any] = {
                "generated_at": time.time(),
                "manifest": self.manifest,
                "manifests_seen": self.manifests_seen,
                "events_seen": self.events_seen,
                "verdict": verdict or ("DONE" if self.summary else "ALIVE"),
                "latest_chunk": self.latest_chunk,
                "chunks_recent": list(self.chunks_recent),
                "throughput": self._throughput(),
                "heartbeat": hb,
                # always present (None before any check)
                "health": self.health,
                "launches": list(self.launches),
                "restarts": list(self.restarts),
                "give_up": self.give_up,
                "resumed_from_step": self.resumed_from_step,
                "exchange": self.exchange,
                "summary": self.summary,
                "errors": list(self.errors),
            }
            if self.groups:
                rank = {"DIVERGED": 0, "HEALTHY": 1}
                rows = [{"group": name, **entry}
                        for name, entry in self.groups.items()]
                rows.sort(key=lambda r: rank.get(r.get("verdict"), 3))
                worst = min(
                    (r.get("verdict") for r in rows
                     if r.get("verdict") is not None),
                    key=lambda v: rank.get(v, 3), default=None)
                out["groups"] = {"n_groups": len(rows), "rows": rows,
                                 "worst_verdict": worst}
            if self.anomalies:
                last = self.anomalies[-1]
                out["anomalies"] = {
                    "count": self.anomalies_total,
                    "kinds": dict(self.anomaly_kinds),
                    "last": last,
                    "suspect": last.get("suspect"),
                }
            if self.halo_audit is not None:
                out["halo_audit"] = self.halo_audit
            if self.trace_id is not None:
                out["trace_id"] = self.trace_id
            if self.time_to_first_chunk_s is not None:
                out["time_to_first_chunk_s"] = self.time_to_first_chunk_s
            if self.spans_seen:
                out["spans_seen"] = self.spans_seen
            roof = (self.costmodel or {}).get("roofline")
            if roof:
                out["roofline"] = roof
            if self.cancelled is not None:
                out["cancelled"] = self.cancelled
            if self.scheduler is not None:
                out["scheduler"] = self.scheduler
            if self.router is not None:
                out["router"] = self.router
            return out
