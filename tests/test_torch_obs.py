"""The port's telemetry core: ``obs/trace.py``, ``spans.py``,
``runtime.py``, ``metrics.py``, ``heartbeat.py`` and the session, against
the JAX package's.

* the port's manifest fails the JAX ``validate_manifest`` on
  ``provenance.jax_version`` alone, and every event the port writes (a
  CLI run with every observability flag) passes the JAX
  ``validate_event``;
* ``RuntimeRecorder.summary`` equals the JAX recorder's on the same chunk
  timings, and ``RunMetrics`` gives the same verdict on the two CLIs'
  logs of the same command, each package reading either log;
* span contexts round-trip across the packages, and a port session adopts
  an ``OBS_TRACE_CONTEXT`` a JAX emitter exported;
* the heartbeat reaches STALLED, WEDGED and RECOVERED on a fake probe,
  the ``heartbeat:wedge`` fault site drives it, and the real probe
  answers NO_CUDA here;
* zero ops: the step's aten op sequence (a ``TorchDispatchMode``
  recording of every step call) is identical with each of the six flags
  on and off.
"""

import functools
import json
import os
import threading
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.obs import metrics as jmetrics
from mpi_cuda_process_tpu.obs import runtime as jruntime
from mpi_cuda_process_tpu.obs import spans as jspans
from mpi_cuda_process_tpu.obs import trace as jtrace

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import obs as tobs
from mpi_cuda_process_tpu_torch.obs import heartbeat as theartbeat
from mpi_cuda_process_tpu_torch.obs import metrics as tmetrics
from mpi_cuda_process_tpu_torch.obs import runtime as truntime
from mpi_cuda_process_tpu_torch.obs import spans as tspans
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults

torch.set_num_threads(1)


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_port_manifest_fails_the_reference_on_jax_version_alone():
    m = ttrace.build_manifest("cli", {"stencil": "heat3d", "device": "cpu"})
    ttrace.validate_manifest(m)
    prov = m["provenance"]
    assert prov["backend"] == "cpu" and prov["torch_version"]
    assert prov["cuda_version"] == str(torch.version.cuda or "none")
    assert prov["nvidia_smi"] is None  # no card here
    with pytest.raises(ValueError) as e:
        jtrace.validate_manifest(m)
    msg = str(e.value)
    assert msg.count(";") == 0 and "provenance.jax_version" in msg
    # and the port's validator names its own keys
    bad = json.loads(json.dumps(m))
    del bad["provenance"]["torch_version"]
    bad["provenance"]["nvidia_smi"] = 3
    with pytest.raises(ValueError, match="torch_version.*nvidia_smi"):
        ttrace.validate_manifest(bad)


def test_every_port_event_passes_the_reference_validator(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    path = str(tmp_path / "all.jsonl")
    tcli.run(tcli.config_from_args(
        ["--stencil", "wave3d", "--grid", "16,16,32", "--iters", "8",
         "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
         "--exchange", "rdma", "--health", "--halo-audit", "1",
         "--anomaly", "--profile", str(tmp_path / "prof"),
         "--telemetry", path, "--checkpoint-every", "4",
         "--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu"]))
    manifest, events = ttrace.validate_log(path)
    kinds = {e["kind"] for e in events}
    assert {"chunk", "health", "halo_audit", "profile", "exchange",
            "span", "summary"} <= kinds
    for e in events:
        jtrace.validate_event(e)
    names = {e["name"] for e in events if e["kind"] == "span"}
    assert {"compile", "checkpoint", "cli"} <= names
    audits = [e for e in events if e["kind"] == "halo_audit"]
    assert audits and all(a["ok"] and a["backend"] == "plain-ring"
                          for a in audits)
    assert manifest["trace"]["root_span_id"]


def test_recorder_summary_matches_the_reference(monkeypatch):
    timings = [(2, 1.0), (2, 0.08), (2, 0.10), (2, 0.12), (2, 0.10),
               (1, 0.05)]
    jr = jruntime.RuntimeRecorder(step_unit=4)
    tr = truntime.RuntimeRecorder(step_unit=4)
    for steps, secs in timings:
        for r in (jr, tr):
            r.begin_chunk()
            r.record_chunk(steps, secs)
    assert tr.summary() == jr.summary()
    assert [c for c in tr.chunks] == [c for c in jr.chunks]
    # a kernel library loaded inside a post-warm-up chunk: flagged and
    # excluded from the percentiles, as a mid-run compile is there
    loads = [0]
    monkeypatch.setattr(truntime, "compile_events_seen", lambda: loads[0])
    tr.begin_chunk()
    loads[0] += 3
    jr.begin_chunk()
    jruntime._compile_events[0] += 3
    assert tr.record_chunk(2, 5.0) == jr.record_chunk(2, 5.0)
    assert tr.summary() == jr.summary()
    assert tr.summary()["recompiles"] == 3


@pytest.mark.parametrize("argv", [
    ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8",
     "--health", "--anomaly"],
    ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8",
     "--mesh", "2,1,1", "--checkpoint-every", "2", "--halo-audit", "2"],
], ids=["health", "audit"])
def test_run_metrics_verdicts_match_on_both_logs(argv, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setattr(jcli, "_emit_static_cost", lambda *a: None)
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jcli.run(jcli.config_from_args(argv + ["--telemetry", jp]))
    tcli.run(tcli.config_from_args(argv + ["--telemetry", tp,
                                           "--device", "cpu"]))
    status = {}
    for pkg, mod in (("j", jmetrics), ("t", tmetrics)):
        for log in (jp, tp):
            rm = mod.RunMetrics()
            for rec in _records(log):
                rm.ingest(rec)
            status[pkg, log] = rm.status()["verdict"]
    assert len(set(status.values())) == 1, status
    assert status["t", tp] == "DONE"


_MANIFEST = {"kind": "manifest", "run": {"stencil": "heat3d",
                                         "grid": [8, 8, 16]}}
_CHUNK = {"kind": "chunk", "chunk": 1, "steps": 4, "wall_s": 0.5,
          "ms_per_step": 125.0}


@pytest.mark.parametrize("events", [
    [],
    [_CHUNK],
    [_CHUNK, {"kind": "summary", "mcells_per_s": 1.0}],
    [_CHUNK, {"kind": "anomaly", "anomaly": "throughput_collapse"},
     {"kind": "summary"}],
    [_CHUNK, {"kind": "heartbeat", "verdict": "STALLED"}],
    [{"kind": "heartbeat", "verdict": "STALLED"},
     {"kind": "heartbeat", "verdict": "RECOVERED"}, {"kind": "summary"}],
    [{"kind": "heartbeat", "verdict": "WEDGED"},
     {"kind": "anomaly", "anomaly": "recompile"}],
    [{"kind": "health", "verdict": "DIVERGED"},
     {"kind": "heartbeat", "verdict": "RECOVERED"}],
    [{"kind": "health", "verdict": "HEALTHY"}, {"kind": "summary"}],
    [{"kind": "health", "verdict": "DIVERGED", "group": "g1:heat3d"},
     {"kind": "health", "verdict": "HEALTHY", "group": "g0:heat3d"},
     {"kind": "summary"}],
    [{"kind": "error", "error": "boom"}, {"kind": "halo_audit", "ok": True},
     "not a record", {"kind": "unknown_kind"}],
], ids=["empty", "alive", "done", "degraded", "stalled", "recovered",
        "wedged_over_anomaly", "diverged_over_heartbeat", "healthy",
        "group_diverged", "error_and_foreign"])
def test_run_metrics_verdict_matches_the_reference(events):
    """The port's verdict fold against the JAX ``RunMetrics`` on the same
    record stream, through every branch of the verdict's order."""
    got = []
    for mod in (jmetrics, tmetrics):
        rm = mod.RunMetrics()
        for rec in [_MANIFEST] + events:
            rm.ingest(rec)
        got.append(rm.status()["verdict"])
    assert got[0] == got[1], got


def test_span_context_round_trips_across_packages(tmp_path, monkeypatch):
    ctx = tspans.SpanContext("abc", "def")
    back = jspans.SpanContext.decode(ctx.encode())
    assert (back.trace_id, back.span_id) == ("abc", "def")
    jctx = jspans.SpanContext("t9", "s9")
    got = tspans.SpanContext.decode(jctx.encode())
    assert (got.trace_id, got.span_id) == ("t9", "s9")
    assert tspans.SpanContext.decode("garbage") is None
    # a JAX emitter exports its current span; a port session adopts it
    w = jtrace.TraceWriter(str(tmp_path / "parent.jsonl"))
    em = jspans.SpanEmitter(w, root_name="supervisor")
    with em.span("attempt"):
        env = jspans.env_extra(type("S", (), {"spans": em})())
    monkeypatch.setenv(tspans.ENV_VAR, env[jspans.ENV_VAR])
    s = tobs.open_session(str(tmp_path / "child.jsonl"), tool="cli",
                          run={"device": "cpu"}, with_heartbeat=False)
    s.finish()
    s.close()
    manifest, events = ttrace.validate_log(str(tmp_path / "child.jsonl"))
    assert manifest["trace"]["trace_id"] == em.trace_id
    root = [e for e in events if e["kind"] == "span"][-1]
    assert root["trace_id"] == em.trace_id
    assert root["parent_id"] == env[jspans.ENV_VAR].split(":")[1]
    w.close()


class _ListTrace:
    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append(dict(kind=kind, **payload))


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_heartbeat_stalled_then_recovered_with_a_fake_probe():
    progress = [time.monotonic()]
    tr = _ListTrace()
    probed = threading.Event()

    def probe():
        probed.set()
        return {"verdict": "CARD_HEALTHY", "detail": "fake card"}

    hb = theartbeat.Heartbeat(lambda: progress[0], trace=tr,
                              stall_after_s=0.15, poll_s=0.03, probe=probe)
    hb.start()
    try:
        assert _wait_for(lambda: probed.is_set() and len(tr.events) >= 2)
        verdicts = [e["verdict"] for e in tr.events]
        assert verdicts[:2] == ["STALLED", "STALLED"]
        assert "CARD_HEALTHY" in tr.events[1]["detail"]
        n = len(tr.events)
        time.sleep(0.2)  # same episode: no new events
        assert len(tr.events) == n
        progress[0] = time.monotonic()
        assert _wait_for(lambda: tr.events[-1]["verdict"] == "RECOVERED")
    finally:
        hb.stop()


def test_heartbeat_wedge_fault_site(monkeypatch):
    monkeypatch.setenv("FAULT_INJECT", "heartbeat:wedge")
    tr = _ListTrace()
    hb = theartbeat.Heartbeat(lambda: time.monotonic() - 100.0, trace=tr,
                              stall_after_s=0.1, poll_s=0.03,
                              probe=lambda: pytest.fail("probe ran"))
    hb.start()
    try:
        assert _wait_for(lambda: any(e["verdict"] == "WEDGED"
                                     for e in tr.events))
        assert "heartbeat:wedge" in hb.last_verdict["detail"]
    finally:
        hb.stop()
    # the stop closed the open episode
    assert tr.events[-1]["verdict"] == "SUPERVISOR_KILL"
    tfaults.reset()


def test_probe_verdict_answers_no_cuda_here():
    v = theartbeat.probe_verdict(timeout_s=60.0)
    expect = "CARD_HEALTHY" if torch.cuda.is_available() else "NO_CUDA"
    assert v["verdict"] == expect, v


def test_session_error_event_and_finish_idempotent(tmp_path):
    s = tobs.open_session(str(tmp_path / "e.jsonl"), tool="cli",
                          run={"device": "cpu"}, with_heartbeat=False)
    s.error(RuntimeError("boom"))
    s.finish(steps=1)
    s.finish(steps=2)
    s.close()
    _, events = ttrace.validate_log(str(tmp_path / "e.jsonl"))
    kinds = [e["kind"] for e in events]
    assert kinds.count("summary") == 1 and "error" in kinds
    assert [e for e in events if e["kind"] == "summary"][0]["steps"] == 1


# ------------------------------------------------------------ zero ops

class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _step_ops(monkeypatch, argv):
    """The aten ops of every step call of a CLI run, call by call."""
    calls = []
    build = tcli.build

    def recorded_build(cfg):
        st, step_fn, fields, start = build(cfg)

        @functools.wraps(step_fn)
        def step(fs):
            with _OpLog() as m:
                out = step_fn(fs)
            calls.append(tuple(m.ops))
            return out

        return st, step, fields, start

    monkeypatch.setattr(tcli, "build", recorded_build)
    tcli.run(tcli.config_from_args(argv))
    monkeypatch.setattr(tcli, "build", build)
    return calls


_BASE = ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
         "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
         "--device", "cpu"]


@pytest.mark.parametrize("flag", ["telemetry", "health", "halo-audit",
                                  "anomaly", "profile", "profile-dir"])
def test_the_step_runs_the_same_ops_with_each_flag(flag, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    extra = {"telemetry": ["--telemetry", str(tmp_path / "t.jsonl")],
             "health": ["--health"], "halo-audit": ["--halo-audit", "1"],
             "anomaly": ["--anomaly", "--telemetry",
                         str(tmp_path / "a.jsonl")],
             "profile": ["--profile", str(tmp_path / "p")],
             "profile-dir": ["--profile-dir", str(tmp_path / "pd")]}[flag]
    off = _step_ops(monkeypatch, _BASE)
    on = _step_ops(monkeypatch, _BASE + extra)
    assert len(off) == 2 and off[0]
    assert on == off
