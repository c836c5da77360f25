"""The run doctor and the flight recorder: the port's ``obs/anomaly.py``
and ``obs/flightrec.py`` against the JAX package's.

* the two ``AnomalyMonitor`` s, fed identical chunk records and member
  timings (one frozen or scripted clock), give identical findings for
  every detector: a clean run (none), throughput collapse, a post-warm-up
  recompile (the port's kernel library load), memory creep, variance
  growth, a boundary stall, a straggler group, and no roofline gap
  without a ledger row;
* a flight-recorder bundle of a port session round-trips and replays the
  verdict, and the port's bundle has the reference's shape;
* a clean CLI run has zero findings and writes no bundle; a run with an
  injected boundary stall finishes DEGRADED with a bundle.
"""

import json
import os

import pytest

from mpi_cuda_process_tpu.obs import anomaly as janomaly

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import obs as tobs
from mpi_cuda_process_tpu_torch.obs import anomaly as tanomaly
from mpi_cuda_process_tpu_torch.obs import flightrec as tflight
from mpi_cuda_process_tpu_torch.obs import metrics as tmetrics
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults


def _chunk(n, ms, steps=20, recompiled=False, mem=None):
    rec = {"chunk": n, "steps": steps, "ms_per_step": float(ms),
           "wall_s": round(float(ms) * steps / 1e3, 6),
           "recompiled": recompiled}
    if mem is not None:
        rec["memory"] = {"bytes_in_use": int(mem)}
    return rec


def _strip(findings):
    return [{k: v for k, v in f.items() if k != "t"} for f in findings]


class _Trace:
    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append(dict(kind=kind, **payload))


def _pair(**kw):
    kw.setdefault("clock", lambda: 0.0)
    jt, tt = _Trace(), _Trace()
    return (janomaly.AnomalyMonitor(trace=jt, **kw), jt,
            tanomaly.AnomalyMonitor(trace=tt, **kw), tt)


SCRIPTS = {
    "clean": [_chunk(n, 10.0, recompiled=(n == 0), mem=10**9)
              for n in range(40)],
    "collapse": [_chunk(n, 10.0) for n in range(5)]
    + [_chunk(5, 45.0), _chunk(6, 45.0)],
    "recompile": [_chunk(0, 10.0, recompiled=True),
                  _chunk(1, 10.0, recompiled=True)],
    "creep": [_chunk(n, 10.0, mem=10**9 + n * 10**8) for n in range(6)],
    "variance": [_chunk(n, 10.0) for n in range(1, 9)]
    + [_chunk(9 + i, ms) for i, ms in enumerate([6.0, 22.0] * 4)],
    "no_ledger": [_chunk(n, 1000.0) for n in range(10)],
    "bounded": [_chunk(n, 10.0) for n in range(5)]
    + [_chunk(n, 60.0) for n in range(5, 15)],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_findings_match_the_reference(script):
    kw = {"max_findings": 3} if script == "bounded" else {}
    if script == "clean":
        kw = {"cells": 10**6}
    jm, jt, tm, tt = _pair(**kw)
    for rec in SCRIPTS[script]:
        assert _strip(tm.observe_chunk(dict(rec))) == \
            _strip(jm.observe_chunk(dict(rec)))
    assert _strip(tm.findings) == _strip(jm.findings)
    assert tm.counts == jm.counts and tm.count == jm.count
    assert _strip(tt.events) == _strip(jt.events)
    if script == "clean":
        assert tm.count == 0
    if script == "no_ledger":
        assert "roofline_gap" not in tm.counts


def test_boundary_stall_and_straggler_match_the_reference():
    t = [0.0]
    jm = janomaly.AnomalyMonitor(clock=lambda: t[0])
    tm = tanomaly.AnomalyMonitor(clock=lambda: t[0])
    for n in range(4):
        t[0] += 0.21
        assert tm.observe_chunk(_chunk(n, 10.0)) == \
            jm.observe_chunk(_chunk(n, 10.0))
    t[0] += 0.7
    got = _strip(tm.observe_chunk(_chunk(4, 10.0)))
    assert got == _strip(jm.observe_chunk(_chunk(4, 10.0)))
    assert [f["anomaly"] for f in got] == ["boundary_stall"]
    rows = [[{"name": "g0", "ms_per_step": 10.0},
             {"name": "g1", "ms_per_step": 50.0}]] * 4 + [
        [{"name": "g0", "ms_per_step": 32.0},
         {"name": "g1", "ms_per_step": 50.0}]]
    for step, members in enumerate(rows):
        a = tm.observe_members(step, members, kind="group")
        b = jm.observe_members(step, members, kind="group")
        assert (a and {k: v for k, v in a.items() if k != "t"}) == \
            (b and {k: v for k, v in b.items() if k != "t"})
    assert a["suspect"]["name"] == "g0"


def test_bundle_round_trips_and_replays_the_verdict(tmp_path):
    path = str(tmp_path / "run.jsonl")
    s = tobs.open_session(path, tool="cli",
                          run={"stencil": "heat3d", "device": "cpu"},
                          with_heartbeat=False)
    s.recorder.begin_chunk()
    s.recorder.record_chunk(4, 0.01)
    s.event("anomaly", anomaly="throughput_collapse", severity="critical",
            chunk=1, evidence={}, suspect={"kind": "host", "name": "x"})
    out = tflight.bundle_from_session(s, "degraded")
    s.close()
    assert out == str(tmp_path / "run.bundle.json")
    b = tflight.read_bundle(out)
    assert b["verdict"] == "DEGRADED" and b["reason"] == "degraded"
    assert b["best_known"] is None  # no ledger in the port yet
    assert b["tunnel"]["verdict"] == "NOT_RUN"
    assert len(b["anomalies"]) == 1
    ttrace.validate_manifest(b["manifest"])
    assert tflight.is_bundle_file(out)
    # the same bundle from the finished log, with the log then deleted
    again = tflight.bundle_from_log(path, out_path=str(tmp_path / "b2.json"))
    os.remove(path)
    b2 = tflight.read_bundle(again)
    assert b2["manifest"] == b["manifest"]
    rm = tmetrics.RunMetrics()
    rm.ingest(b2["manifest"])
    for e in b2["events"]:
        rm.ingest(e)
    assert rm.status()["verdict"] == "DEGRADED"
    bad = dict(b2, events=[{"kind": "x"}])
    with pytest.raises(ValueError, match="event 0"):
        tflight.validate_bundle(bad)


def test_clean_cli_run_has_no_findings_and_no_bundle(tmp_path):
    path = str(tmp_path / "clean.jsonl")
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "16",
         "--anomaly", "--health", "--telemetry", path, "--device",
         "cpu"]))
    _, events = ttrace.validate_log(path)
    assert not [e for e in events if e["kind"] == "anomaly"]
    assert len([e for e in events if e["kind"] == "chunk"]) == 8
    assert not os.path.exists(str(tmp_path / "clean.bundle.json"))


def test_injected_stall_finishes_degraded_with_a_bundle(tmp_path,
                                                        monkeypatch):
    """A boundary ``sleep`` fault: a slow boundary, not a dead run."""
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=12:sleep:700")
    tfaults.reset()
    path = str(tmp_path / "slow.jsonl")
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "16",
         "--log-every", "2", "--anomaly", "--telemetry", path,
         "--device", "cpu"]))
    tfaults.reset()
    _, events = ttrace.validate_log(path)
    found = [e["anomaly"] for e in events if e["kind"] == "anomaly"]
    assert found == ["boundary_stall"]
    b = tflight.read_bundle(str(tmp_path / "slow.bundle.json"))
    assert b["verdict"] == "DEGRADED"
    assert json.loads(json.dumps(b))["anomalies"][0]["anomaly"] == \
        "boundary_stall"
