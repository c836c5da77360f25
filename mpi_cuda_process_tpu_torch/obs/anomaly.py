"""Run doctor: continuous performance-anomaly detection at chunk cadence.

``--health`` (obs/health.py) watches the *numerics*; nothing watched the
*performance*: a run that silently dropped to 0.3x its own steady-state
throughput — a straggler host, a recompile storm, memory creep, a
co-tenant squeeze — ran to completion and only the next ``perf_gate``
replay noticed.  :class:`AnomalyMonitor` is the live half: it consumes
the chunk records :class:`~.runtime.RuntimeRecorder` already builds
(``recorder.anomaly = monitor`` — one hook covers the measured CLI
path, coupled groups, and every serving job) and never touches the
jitted step.  Same zero-ops discipline as ``--health``: the detector is
host Python at chunk boundaries only; the step's aten ops and kernel
launches are identical with the detector on vs off (pinned by
tests/test_torch_anomaly.py and chip_smoke.py phase 5j).

Findings, each a structured ``anomaly`` event in the existing telemetry
schema (``anomaly`` = kind, ``severity``, ``evidence``, ``suspect``):

* ``throughput_collapse`` — ms/step above ``collapse_ratio`` x the
  run's OWN rolling steady-state baseline (chunk 0 and recompiled
  chunks never baseline; flagged chunks don't poison the baseline
  either, so one slow chunk can't normalize the next).  When the
  ledger's ``best_known`` row for this label is available the evidence
  carries the roofline-gap ratio too — but the trigger is always the
  run's own baseline, so a stale ledger can't fabricate findings.
* ``roofline_gap`` — sustained throughput below ``roofline_band`` x
  the ledger's ``best_known`` for this exact label|backend key, for two
  consecutive steady chunks (one-shot per episode).
* ``recompile`` — a backend compile landed inside a chunk AFTER chunk
  0 (shape drift / cache invalidation in the hot loop).
* ``memory_creep`` — ``bytes_in_use`` strictly increasing across
  ``creep_chunks`` consecutive chunks by more than ``creep_frac``
  total (a leaked buffer, a growing donation miss).
* ``variance_growth`` — the recent window's coefficient of variation
  exceeds both an absolute floor and 3x the run's early steady CV
  (co-tenant squeeze, thermal throttling: jitter without a single
  collapse).
* ``boundary_stall`` — the wall-clock between consecutive chunk
  records minus the newer chunk's own ``wall_s``: host-side time the
  chunk timer never sees (a stalled exchange teardown, a slow
  checkpoint, an injected ``sleep`` fault — ``resilience/faults.py``
  fires OUTSIDE the timed window, exactly like real boundary trouble).
  Flagged when the stall exceeds both ``min_stall_s`` and the chunk's
  own device time; the first ``baseline_chunks`` boundaries are warmup
  (compile and allocator setup legitimately land there).
* ``straggler`` — from per-member timings (coupled groups via
  :meth:`observe_members`, per-host rows via
  :func:`attribute_straggler`): the slowest (host | group | member)
  named with its lag ratio.  Group lag is measured against each
  member's OWN baseline — heterogeneous groups legitimately differ in
  absolute speed, so "slower than your peers" would false-positive by
  design; "slower than you used to be, while your peers are not" is
  the straggler signal.

Every threshold is deliberately conservative: the contract (pinned by
test) is ZERO findings on a clean constant-throughput log.  A finding
makes the run's verdict DEGRADED (obs/metrics.py) — which warns by
default and never kills anything (``--degraded-action``): a slow run
is not a dead run.

Pure host-side stdlib + the trace writer: the port's copy of the TPU
package's module.  The CLI seeds ``best_known`` from the port's campaign
ledger (``obs/ledger.py``, ``cli._attach_anomaly``); without a ledger
row ``roofline_gap`` stays silent, as the reference's does.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Dict, List, Optional

VERDICT_DEGRADED = "DEGRADED"

# severity vocabulary (evidence-bearing, not load-bearing: nothing
# kills a run on severity alone — the supervisor policy decides)
SEV_WARN = "warn"
SEV_CRITICAL = "critical"


def _median(vals: List[float]) -> float:
    return float(statistics.median(vals))


class AnomalyMonitor:
    """Rolling steady-state baseline + conservative anomaly flags.

    ``trace``/``spans`` mirror :class:`~.health.HealthMonitor`: findings
    are emitted as ``anomaly`` trace events and the root span carries an
    ``anomalies`` count; both writes are swallowed — the doctor must
    never kill the patient.  ``ident`` names this process (e.g.
    ``"hostA|p0"``) as the default suspect for single-process findings.
    ``cells`` (grid cell count) + ``best_known`` (a ledger row or plain
    Mcells/s float) enable the roofline-gap band; absent, only the
    own-baseline detectors run.
    """

    def __init__(self, trace=None, spans=None, ident: Optional[str] = None,
                 cells: Optional[int] = None, best_known=None,
                 collapse_ratio: float = 3.0, min_excess_s: float = 0.05,
                 baseline_chunks: int = 3, roofline_band: float = 0.25,
                 creep_chunks: int = 4, creep_frac: float = 0.20,
                 variance_window: int = 8, variance_floor: float = 0.35,
                 straggler_ratio: float = 1.5, min_stall_s: float = 0.3,
                 max_findings: int = 64,
                 clock=time.perf_counter):
        self.trace = trace
        self.spans = spans
        self.ident = ident or "local|p0"
        self.cells = int(cells) if cells else None
        if isinstance(best_known, dict):
            self.best_value = float(best_known.get("value") or 0) or None
            self.best_source = best_known.get("source")
        else:
            self.best_value = float(best_known) if best_known else None
            self.best_source = None
        self.collapse_ratio = float(collapse_ratio)
        self.min_excess_s = float(min_excess_s)
        self.baseline_chunks = max(1, int(baseline_chunks))
        self.roofline_band = float(roofline_band)
        self.creep_chunks = max(2, int(creep_chunks))
        self.creep_frac = float(creep_frac)
        self.variance_window = max(4, int(variance_window))
        self.variance_floor = float(variance_floor)
        self.straggler_ratio = float(straggler_ratio)
        self.min_stall_s = float(min_stall_s)
        self.max_findings = int(max_findings)
        self._clock = clock

        self.findings: List[Dict[str, Any]] = []
        self.counts: Dict[str, int] = {}
        self._steady: List[float] = []     # ms/step, baseline-eligible
        self._mem: List[int] = []          # bytes_in_use per chunk
        self._steps_done = 0
        self._below_band = 0
        self._creep_emitted = False
        self._variance_emitted = False
        self._member_base: Dict[str, List[float]] = {}
        self._straggler_named: set = set()
        self._last_boundary: Optional[float] = None
        self._records_seen = 0

    # ------------------------------------------------------------ core

    @property
    def count(self) -> int:
        return sum(self.counts.values())

    def baseline_ms(self) -> Optional[float]:
        """Current rolling steady-state baseline (median ms/step)."""
        if len(self._steady) < self.baseline_chunks:
            return None
        return _median(self._steady[-32:])

    def observe_chunk(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """One finished chunk record (RuntimeRecorder's exact shape).

        Called host-side at chunk boundaries only — the recorder hooks
        it right after appending the record.  Returns the new findings
        (already emitted); swallows nothing itself because its inputs
        are plain dicts, but the trace/span writes are guarded.
        """
        chunk = rec.get("chunk")
        ms = rec.get("ms_per_step")
        if not isinstance(chunk, int) or not isinstance(ms, (int, float)):
            return []
        wall = float(rec.get("wall_s") or 0.0)
        steps = int(rec.get("steps") or 0)
        self._steps_done += steps
        found: List[Dict[str, Any]] = []

        # boundary stall: host time BETWEEN chunk records that the
        # chunk timer never measured (the run loops fence only the
        # device work; checkpoint saves, injected faults, a wedged
        # exchange teardown all land in this gap).  Both thresholds
        # must clear — the stall dwarfs the chunk's own device time AND
        # a real absolute floor — so clean-run boundary overhead
        # (logging, health reductions: milliseconds) never flags.  The
        # first ``baseline_chunks`` boundaries are warmup, same as the
        # throughput baseline: early boundaries legitimately carry
        # compile and allocator setup the steady loop never repeats.
        now = self._clock()
        prev, self._last_boundary = self._last_boundary, now
        self._records_seen += 1
        if prev is not None and self._records_seen > self.baseline_chunks + 1:
            stall = (now - prev) - wall
            if stall > self.min_stall_s and stall > wall:
                found.append(self._finding(
                    "boundary_stall", SEV_WARN, chunk,
                    {"chunk": chunk, "stall_s": round(stall, 4),
                     "wall_s": round(wall, 4),
                     "detail": "host-side stall between chunk records "
                               "(outside the fenced device window)"}))

        recompiled = bool(rec.get("recompiled"))
        if recompiled and chunk > 0:
            found.append(self._finding(
                "recompile", SEV_WARN, chunk,
                {"chunk": chunk, "ms_per_step": ms,
                 "detail": "backend compile inside a post-warmup chunk "
                           "(shape drift or cache invalidation)"}))

        mem = rec.get("memory") or {}
        if isinstance(mem.get("bytes_in_use"), int):
            self._mem.append(mem["bytes_in_use"])
            creep = self._check_creep(chunk)
            if creep is not None:
                found.append(creep)

        if chunk > 0:
            baseline = self.baseline_ms()
            collapsed = False
            if baseline is not None and ms > self.collapse_ratio * baseline \
                    and (ms - baseline) * steps / 1e3 > self.min_excess_s:
                collapsed = True
                ev: Dict[str, Any] = {
                    "chunk": chunk, "ms_per_step": ms,
                    "baseline_ms_per_step": round(baseline, 6),
                    "ratio": round(ms / baseline, 2),
                }
                tp = self._mcells(rec, wall, steps)
                if tp is not None and self.best_value:
                    ev["mcells_per_s"] = round(tp, 3)
                    ev["vs_best_known"] = round(tp / self.best_value, 4)
                found.append(self._finding(
                    "throughput_collapse", SEV_CRITICAL, chunk, ev))
            gap = None if collapsed else self._check_roofline(
                rec, chunk, wall, steps)
            if gap is not None:
                found.append(gap)
            if not recompiled and not collapsed:
                self._steady.append(float(ms))
                var = self._check_variance(chunk)
                if var is not None:
                    found.append(var)

        for f in found:
            self._emit(f)
        return found

    def observe_members(self, step: Optional[int],
                        entries: List[Dict[str, Any]],
                        kind: str = "group") -> Optional[Dict[str, Any]]:
        """Per-member timings at one boundary: name the straggler.

        ``entries`` = ``[{"name": ..., "ms_per_step": ...}, ...]`` (one
        per coupled group / ensemble member / host).  Lag is each
        member's current time over its OWN early baseline (first
        ``baseline_chunks`` samples), so heterogeneous members at
        different absolute speeds never read as stragglers; a member
        must be slower than it used to be while its peers are not
        (worst lag >= ``straggler_ratio`` AND >= 2x the peers' median
        lag).  Named at most once per member per run.
        """
        lags: List[Any] = []
        for e in entries:
            name = str(e.get("name"))
            ms = e.get("ms_per_step")
            if not isinstance(ms, (int, float)) or ms <= 0:
                continue
            base = self._member_base.setdefault(name, [])
            if len(base) < self.baseline_chunks:
                base.append(float(ms))
                continue
            lags.append((name, float(ms) / _median(base), float(ms)))
        if len(lags) < 2:
            return None
        lags.sort(key=lambda x: x[1])
        name, lag, ms = lags[-1]
        peers = [x[1] for x in lags[:-1]]
        if lag < self.straggler_ratio or lag < 2.0 * _median(peers):
            return None
        if name in self._straggler_named:
            return None
        self._straggler_named.add(name)
        f = self._finding(
            "straggler", SEV_WARN, None,
            {"step": step, "lag_ratio": round(lag, 2),
             "ms_per_step": round(ms, 6),
             "peers_median_lag": round(_median(peers), 2)},
            suspect={"kind": kind, "name": name,
                     "lag_ratio": round(lag, 2)})
        if step is not None:
            f["step"] = int(step)
        self._emit(f)
        return f

    # ------------------------------------------------------- detectors

    def _mcells(self, rec, wall: float, steps: int) -> Optional[float]:
        if not self.cells or wall <= 0 or steps <= 0:
            return None
        members = max(1, int(rec.get("members") or 0) or 1)
        return self.cells * steps * members / (wall * 1e6)

    def _check_roofline(self, rec, chunk: int, wall: float,
                        steps: int) -> Optional[Dict[str, Any]]:
        tp = self._mcells(rec, wall, steps)
        if tp is None or not self.best_value:
            return None
        if tp < self.roofline_band * self.best_value:
            self._below_band += 1
        else:
            self._below_band = 0
            return None
        if self._below_band != 2:  # one-shot per below-band episode
            return None
        return self._finding(
            "roofline_gap", SEV_WARN, chunk,
            {"chunk": chunk, "mcells_per_s": round(tp, 3),
             "best_known_mcells_per_s": self.best_value,
             "vs_best_known": round(tp / self.best_value, 4),
             "band": self.roofline_band,
             "best_known_source": self.best_source})

    def _check_creep(self, chunk: int) -> Optional[Dict[str, Any]]:
        if self._creep_emitted:
            return None
        win = self._mem[-(self.creep_chunks + 1):]
        if len(win) < self.creep_chunks + 1 or win[0] <= 0:
            return None
        if any(later <= earlier for earlier, later in zip(win, win[1:])):
            return None  # not strictly increasing throughout
        growth = (win[-1] - win[0]) / win[0]
        if growth <= self.creep_frac:
            return None
        self._creep_emitted = True
        return self._finding(
            "memory_creep", SEV_WARN, chunk,
            {"chunk": chunk, "chunks": len(win) - 1,
             "bytes_first": win[0], "bytes_last": win[-1],
             "growth": round(growth, 4)})

    def _check_variance(self, chunk: int) -> Optional[Dict[str, Any]]:
        if self._variance_emitted:
            return None
        w = self.variance_window
        if len(self._steady) < 2 * w:
            return None

        def _cv(vals: List[float]) -> float:
            m = statistics.fmean(vals)
            return statistics.pstdev(vals) / m if m > 0 else 0.0

        early = _cv(self._steady[:w])
        recent = _cv(self._steady[-w:])
        if recent <= max(self.variance_floor, 3.0 * early):
            return None
        self._variance_emitted = True
        return self._finding(
            "variance_growth", SEV_WARN, chunk,
            {"chunk": chunk, "cv_recent": round(recent, 4),
             "cv_early": round(early, 4), "window": w})

    # ------------------------------------------------------- emission

    def _finding(self, kind: str, severity: str, chunk: Optional[int],
                 evidence: Dict[str, Any],
                 suspect: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        f: Dict[str, Any] = {
            "anomaly": kind, "severity": severity,
            "evidence": {k: v for k, v in evidence.items() if v is not None},
            "suspect": suspect or {"kind": "host", "name": self.ident},
        }
        if chunk is not None:
            f["chunk"] = chunk
            f["step"] = self._steps_done
        return f

    def _emit(self, finding: Dict[str, Any]) -> None:
        if len(self.findings) < self.max_findings:
            self.findings.append(finding)
        k = finding["anomaly"]
        self.counts[k] = self.counts.get(k, 0) + 1
        if self.spans is not None:
            try:
                self.spans.root_attrs["anomalies"] = self.count
            except Exception:  # noqa: BLE001 — never load-bearing
                pass
        if self.trace is not None:
            try:
                self.trace.event("anomaly", **finding)
            except Exception:  # noqa: BLE001 — never load-bearing
                pass


def attribute_straggler(entries: List[Dict[str, Any]],
                        ratio: float = 1.5,
                        kind: str = "host") -> Optional[Dict[str, Any]]:
    """Peer-relative straggler among HOMOGENEOUS members (SPMD hosts).

    ``entries`` = ``[{"name": ..., "slowness": ...}, ...]`` where
    slowness is any higher-is-slower figure (ms/step, or 1/throughput).
    Valid only when every member runs the same program — the aggregate
    view across per-host rows, where peer comparison IS the baseline.
    Returns ``{"kind", "name", "lag_ratio"}`` or None.
    """
    vals = [(str(e.get("name")), float(e["slowness"])) for e in entries
            if isinstance(e.get("slowness"), (int, float))
            and e["slowness"] > 0]
    if len(vals) < 2:
        return None
    vals.sort(key=lambda x: x[1])
    peers_median = _median([v for _, v in vals[:-1]])
    name, worst = vals[-1]
    if peers_median <= 0 or worst / peers_median < ratio:
        return None
    return {"kind": kind, "name": name,
            "lag_ratio": round(worst / peers_median, 2)}
