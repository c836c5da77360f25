"""The run supervisor (``resilience/supervisor.py``), mirroring the JAX
package's tests/test_supervisor.py, and held against that package's.

* **unit**: the restart loop against fake children with injected clocks
  and sleeps: backoff sequencing and resume, give-up after
  ``max_restarts``, kill on a WEDGED verdict and on a wall-clock stall,
  the final drain's verdict over the exit code, a fatal verdict without
  a restart; ``retry_subprocess`` with real children (each under a
  timeout);
* **parity**: the JAX package's ``supervise`` and the port's driven by
  the same scripted child and tails give the same event trail (kind,
  order, payload), and both packages' ``RunMetrics`` read it alike;
* ``config.to_argv``: a round trip through the port's parser, every
  RunConfig field covered, ``--device cpu`` carried to the child;
* **end to end on the CPU**: a real ``--device cpu`` child with
  ``FAULT_INJECT=exchange:step=40:hang`` is detected (its heartbeat's
  STALLED verdict), killed, resumed from the step-30 checkpoint and
  finished, bit-equal to an uninterrupted port run; the child's spans
  join the supervisor's trace;
* the give-up bundle's card probe (``obs/flightrec.card_verdict``) and the
  refusals (``--supervise`` under a multi-process launch, unported flags).

Exactly the JAX package's two slow cases are marked slow (the child-death
and the permanent-wedge end-to-end runs).  Subprocess waits poll with
deadlines; every subprocess has a timeout or a wall-clock stall kill;
stall windows are seconds.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mpi_cuda_process_tpu.config import RunConfig as JRunConfig
from mpi_cuda_process_tpu.obs import metrics as jmetrics
from mpi_cuda_process_tpu.resilience import supervisor as jsup

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import obs as tobs
from mpi_cuda_process_tpu_torch.config import (LIFECYCLE_FIELDS, SIM_FIELDS,
                                               RunConfig, _ARGV_SKIP,
                                               to_argv)
from mpi_cuda_process_tpu_torch.obs import flightrec as tflightrec
from mpi_cuda_process_tpu_torch.obs import metrics as tmetrics
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.resilience import faults
from mpi_cuda_process_tpu_torch.resilience import supervisor as sup
from mpi_cuda_process_tpu_torch.utils import checkpointing


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    faults.reset()
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))
    yield
    faults.reset()


# ------------------------------------------------------------- to_argv


def test_to_argv_roundtrips_through_the_port_parser():
    cfgs = [
        RunConfig(),
        RunConfig(stencil="life", grid=(64, 64), iters=100, seed=7,
                  checkpoint_every=10, checkpoint_dir="/tmp/ck",
                  telemetry="/tmp/t.jsonl", resume=True, device="cpu"),
        RunConfig(stencil="heat3d", grid=(32, 32, 128), iters=8,
                  mesh=(2, 1, 1), fuse=4, fuse_kind="stream",
                  exchange="rdma", overlap=True, pipeline=True,
                  dtype="bfloat16", mem_check="warn", periodic=True,
                  health=True, halo_audit=2, anomaly=True,
                  ensemble=4, ensemble_mesh=2, ensemble_perturb=0.01,
                  groups="heat3d@0-3,heat3d@4-7",
                  group_transport="collective",
                  params={"alpha": 0.25, "n": 3}),
    ]
    for cfg in cfgs:
        assert tcli.config_from_args(to_argv(cfg)) == cfg, cfg
    # launcher-only fields never reach the child
    sup_cfg = RunConfig(supervise=True, max_restarts=9,
                        restart_backoff=0.1, supervise_stall_s=1.0,
                        degraded_action="restart", serve_port=0)
    argv = to_argv(sup_cfg)
    assert "--supervise" not in argv and "--max-restarts" not in argv
    assert tcli.config_from_args(argv) == RunConfig()
    # a --device cpu parent starts a --device cpu child
    assert to_argv(RunConfig(device="cpu")) == ["--device", "cpu"]


def test_to_argv_covers_every_runconfig_field():
    """A field either maps to a real flag of the port's parser, is a
    launcher-only field, or is one the port refuses by name (its run is
    refused before any child is launched)."""
    known = {a.dest for a in tcli.build_parser()._actions}
    unported = {f for f, _, _ in tcli._UNPORTED}
    for f in dataclasses.fields(RunConfig):
        if f.name == "params":  # repeated --param k=v
            continue
        assert f.name in known or f.name in _ARGV_SKIP \
            or f.name in unported, \
            f"RunConfig.{f.name} has no CLI flag (to_argv would drop it)"
    for flag in ("supervise", "max_restarts", "restart_backoff",
                 "supervise_stall_s", "degraded_action"):
        assert flag in known


def test_sim_and_lifecycle_fields_partition_runconfig():
    names = {f.name for f in dataclasses.fields(RunConfig)}
    assert SIM_FIELDS | LIFECYCLE_FIELDS == names
    assert not SIM_FIELDS & LIFECYCLE_FIELDS
    assert "device" in SIM_FIELDS and "supervise" in LIFECYCLE_FIELDS
    # the reference's split, field for field, plus the port's own device
    jnames = {f.name for f in dataclasses.fields(JRunConfig)}
    from mpi_cuda_process_tpu import config as jconfig

    assert LIFECYCLE_FIELDS == jconfig.LIFECYCLE_FIELDS
    assert SIM_FIELDS == (jconfig.SIM_FIELDS & names) | {"device"}
    assert names - jnames == {"device"}


# ------------------------------------------------- supervise (unit)


class _FakeHandle:
    """Scripted child: a list of poll() results; records kills."""

    def __init__(self, polls):
        self._polls = list(polls)
        self.killed = False
        self.waited = False

    def poll(self):
        return self._polls.pop(0) if self._polls else 0

    def kill(self):
        self.killed = True

    def wait(self, timeout_s=30.0):
        self.waited = True
        return None


class _FakeTail:
    def __init__(self, batches=()):
        self._batches = list(batches)

    def poll(self):
        return self._batches.pop(0) if self._batches else []


class _Session:
    path = "fake.supervisor.jsonl"

    def __init__(self):
        self.events = []

    def event(self, kind, **payload):
        self.events.append({"kind": kind, **payload})


def _npy_checkpoint(tmp_path, step):
    ck = tmp_path / "ck"
    ck.mkdir(exist_ok=True)
    (ck / "meta.json").write_text(json.dumps(
        {"step": step, "num_fields": 0, "config": {}}))
    return str(ck)


def test_supervise_backoff_sequencing_and_resume(tmp_path):
    ck = _npy_checkpoint(tmp_path, 30)
    session = _Session()
    sleeps, launches = [], []

    def launcher(attempt, resume):
        launches.append((attempt, resume))
        return _FakeHandle([1 if attempt < 2 else 0]), [_FakeTail()]

    res = sup.supervise(
        launcher, ck, max_restarts=3, backoff_base_s=0.5,
        backoff_max_s=100.0, stall_timeout_s=60.0, poll_s=0.0,
        session=session, sleep=sleeps.append, clock=lambda: 0.0)
    assert res.ok and res.attempts == 3 and not res.gave_up
    assert sleeps == [0.5, 1.0]
    assert launches == [(0, False), (1, True), (2, True)]
    assert res.resumed_from_step == 30
    assert [e.get("resumed_from_step") for e in session.events
            if e["kind"] == "launch" and e.get("resume")] == [30, 30]
    assert [e["kind"] for e in session.events] == [
        "launch", "restart", "launch", "restart", "launch", "summary"]
    assert session.events[-1]["ok"] is True


def test_supervise_gives_up_after_max_restarts(tmp_path):
    ck = _npy_checkpoint(tmp_path, 10)
    session = _Session()
    sleeps = []
    res = sup.supervise(
        lambda attempt, resume: (_FakeHandle([3]), [_FakeTail()]),
        ck, max_restarts=2, backoff_base_s=0.25, stall_timeout_s=60.0,
        poll_s=0.0, session=session, sleep=sleeps.append,
        clock=lambda: 0.0)
    assert not res.ok and res.gave_up and res.attempts == 3
    assert res.final_rc == 3
    assert sleeps == [0.25, 0.5]
    assert [e["kind"] for e in session.events].count("give_up") == 1
    assert session.events[-1]["kind"] == "summary"
    assert session.events[-1]["ok"] is False


def test_supervise_kills_and_reaps_on_a_wedged_verdict(tmp_path):
    ck = _npy_checkpoint(tmp_path, 20)
    session = _Session()
    handles = []

    def launcher(attempt, resume):
        if attempt == 0:
            h = _FakeHandle([None, None])
            tails = [_FakeTail([[], [{"kind": "heartbeat",
                                      "verdict": "WEDGED",
                                      "detail": "injected"}]])]
        else:
            h, tails = _FakeHandle([0]), [_FakeTail()]
        handles.append(h)
        return h, tails

    res = sup.supervise(launcher, ck, max_restarts=1, backoff_base_s=0.0,
                        stall_timeout_s=60.0, poll_s=0.0, session=session,
                        sleep=lambda s: None, clock=lambda: 0.0)
    assert res.ok and res.attempts == 2
    # killed, then waited for: a killed child frees its card at its exit
    assert handles[0].killed and handles[0].waited
    assert not handles[1].killed
    restart = [e for e in session.events if e["kind"] == "restart"][0]
    assert "WEDGED" in restart["reason"]


def test_supervise_kills_on_a_wall_clock_stall(tmp_path):
    ck = _npy_checkpoint(tmp_path, 20)
    t = [0.0]

    def clock():
        t[0] += 2.0
        return t[0]

    handles = []

    def launcher(attempt, resume):
        h = _FakeHandle([None] * 50 if attempt == 0 else [0])
        handles.append(h)
        return h, [_FakeTail()]

    res = sup.supervise(launcher, ck, max_restarts=1, backoff_base_s=0.0,
                        stall_timeout_s=5.0, poll_s=0.0,
                        sleep=lambda s: None, clock=clock)
    assert res.ok and res.attempts == 2
    assert handles[0].killed
    assert res.restarts[0]["reason"] == "wall-clock stall"


def test_watch_child_reports_the_verdict_over_the_exit_on_the_final_drain():
    h = _FakeHandle([1])
    tail = _FakeTail([[{"kind": "heartbeat", "verdict": "WEDGED",
                        "detail": "d"}]])
    outcome, value, _ = sup.watch_child(
        h, [tail], stall_timeout_s=60.0, poll_s=0.0,
        clock=lambda: 0.0, sleep=lambda s: None)
    assert (outcome, value) == ("verdict", "WEDGED")


def test_a_diverged_child_gives_up_without_a_restart(tmp_path):
    ck = _npy_checkpoint(tmp_path, 20)
    session = _Session()
    res = sup.supervise(
        lambda a, r: (_FakeHandle([None]), [_FakeTail(
            [[{"kind": "health", "verdict": "DIVERGED",
               "reason": "nan"}]])]),
        ck, max_restarts=3, stall_timeout_s=60.0, poll_s=0.0,
        session=session, sleep=lambda s: None, clock=lambda: 0.0)
    assert res.gave_up and res.attempts == 1 and not res.restarts
    gu = [e for e in session.events if e["kind"] == "give_up"][0]
    assert gu["verdict"] == "DIVERGED"


def test_backoff_and_sibling_paths_match_the_reference():
    for args in ((0, 5.0, 300.0), (3, 5.0, 300.0), (10, 5.0, 300.0),
                 (2, 0.25, 1.0)):
        assert sup.backoff_s(*args) == jsup.backoff_s(*args)
    for base, tag in (("run.jsonl", "attempt0"), ("run", "supervisor")):
        assert sup.sibling_path(base, tag) == jsup.sibling_path(base, tag)
    assert sup.KILL_VERDICTS == jsup.KILL_VERDICTS
    assert sup.FATAL_VERDICTS == jsup.FATAL_VERDICTS


def test_latest_checkpoint_reads_both_port_layouts(tmp_path):
    import torch

    ck = str(tmp_path / "npy")
    checkpointing.save_checkpoint(ck, (torch.zeros(4, 4),), 20, {})
    assert sup.latest_checkpoint_step(ck) == 20
    dcp = str(tmp_path / "dcp")
    checkpointing.orbax_save_checkpoint(dcp, (torch.zeros(4, 4),), 30, {})
    assert sup.latest_checkpoint_step(dcp) == 30
    assert sup.latest_checkpoint_step(str(tmp_path / "none")) is None
    assert sup.latest_checkpoint_step(None) is None
    # the newest manifest whose checkpoint_dir holds a checkpoint
    tel = tmp_path / "tel"
    tel.mkdir(exist_ok=True)
    for name, d in (("a.jsonl", str(tmp_path / "none")), ("b.jsonl", ck)):
        with ttrace.TraceWriter(str(tel / name)) as w:
            w.write_manifest(ttrace.build_manifest(
                "cli", {"checkpoint_dir": d}))
    assert sup.find_latest_checkpoint([str(tel)]) == (ck, 20)


# ------------------------------------------------- parity with the JAX


def _scenario(name):
    """(launcher, max_restarts, clock) of one scripted child history, made
    fresh for each package's run."""
    t = [0.0]

    def ticking():
        t[0] += 2.0
        return t[0]

    def launcher(attempt, resume):
        if name == "recover":
            return _FakeHandle([1 if attempt < 2 else 0]), [_FakeTail()]
        if name == "give_up":
            return _FakeHandle([3]), [_FakeTail()]
        if name == "wedge":
            if attempt == 0:
                return _FakeHandle([None, None]), [_FakeTail(
                    [[], [{"kind": "heartbeat", "verdict": "WEDGED",
                           "detail": "injected"}]])]
            return _FakeHandle([0]), [_FakeTail()]
        if name == "stall":
            return _FakeHandle([None] * 50 if attempt == 0 else [0]), \
                [_FakeTail()]
        # diverged
        return _FakeHandle([None]), [_FakeTail(
            [[{"kind": "health", "verdict": "DIVERGED", "reason": "nan"}]])]

    clock = ticking if name == "stall" else (lambda: 0.0)
    return launcher, (2 if name == "give_up" else 3), clock


@pytest.mark.parametrize("name", ["recover", "give_up", "wedge", "stall",
                                  "diverged"])
def test_event_trail_matches_the_reference(name, tmp_path):
    """The same scripted child through both packages' ``supervise``: the
    launch / restart / give_up / summary trail equal in kind, order and
    payload (no times or paths in these payloads), and both packages'
    RunMetrics read it alike."""
    ck = _npy_checkpoint(tmp_path, 30)
    trails, results = [], []
    for mod in (jsup, sup):
        launcher, restarts, clock = _scenario(name)
        session = _Session()
        sleeps = []
        res = mod.supervise(launcher, ck, max_restarts=restarts,
                            backoff_base_s=0.5, backoff_max_s=100.0,
                            stall_timeout_s=5.0, poll_s=0.0,
                            session=session, sleep=sleeps.append,
                            clock=clock)
        trails.append(session.events)
        results.append((res.ok, res.attempts, res.gave_up, res.final_rc,
                        res.resumed_from_step, res.restarts, sleeps))
    assert trails[1] == trails[0]
    assert results[1] == results[0]
    for mod_metrics in (jmetrics, tmetrics):
        rm = mod_metrics.RunMetrics()
        for e in trails[1]:
            rm.ingest(dict(e, t=0.0))
        st = rm.status()
        assert len(st["launches"]) == sum(
            e["kind"] == "launch" for e in trails[0])
        assert (st["give_up"] is not None) == (name in ("give_up",
                                                        "diverged"))
    jt, tt = (m.RunMetrics() for m in (jmetrics, tmetrics))
    for e in trails[1]:
        jt.ingest(dict(e, t=0.0))
        tt.ingest(dict(e, t=0.0))
    assert tt.registry.to_prometheus() == jt.registry.to_prometheus()


# ---------------------------------------------------------- the probe


def test_card_probe_verdicts(monkeypatch):
    assert tflightrec.card_verdict()["verdict"] == "NOT_RUN"

    def fake_run(cmd, **kw):
        out = ("NVIDIA H100 80GB HBM3, 700.00 W" if cmd[0] == "nvidia-smi"
               else "NVIDIA H100 80GB HBM3 2.0")
        assert kw["timeout"] > 0
        return subprocess.CompletedProcess(cmd, 0, out + "\n", "")

    monkeypatch.setattr(tflightrec.subprocess, "run", fake_run)
    ok = tflightrec.card_verdict(run=True)
    assert ok["verdict"] == "OK"
    assert ok["nvidia_smi"] == "NVIDIA H100 80GB HBM3, 700.00 W"

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(tflightrec.subprocess, "run", missing)
    assert tflightrec.card_verdict(run=True)["verdict"] == "FAIL"


def test_give_up_bundle_carries_the_probe_and_the_child_tail(
        tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(tflightrec, "card_verdict",
                        lambda run=False: calls.append(run) or
                        {"verdict": "OK" if run else "NOT_RUN"})
    child = str(tmp_path / "run.attempt0.jsonl")
    with ttrace.TraceWriter(child) as w:
        w.write_manifest(ttrace.build_manifest("cli", {"x": 1}))
        w.event("heartbeat", verdict="WEDGED", detail="injected")
    session = tobs.open_session(str(tmp_path / "run.supervisor.jsonl"),
                                tool="supervisor", run={},
                                with_heartbeat=False)
    try:
        res = sup.supervise(
            lambda a, r: (_FakeHandle([None, None]),
                          [ttrace.LogTail(child)]),
            None, max_restarts=0, stall_timeout_s=60.0, poll_s=0.0,
            session=session, probe_card=True, sleep=lambda s: None,
            clock=lambda: 0.0)
    finally:
        session.close()
    assert res.gave_up and calls == [True]
    _, events = ttrace.validate_log(session.path)
    bundle = [e for e in events if e["kind"] == "bundle"][0]
    b = tflightrec.read_bundle(bundle["path"])
    assert b["tunnel"]["verdict"] == "OK"
    tail = b["sibling_events"]["run.attempt0.jsonl"]
    assert tail[-1]["verdict"] == "WEDGED"


# -------------------------------------------------------- retry_subprocess


def test_retry_subprocess_retries_past_a_first_attempt_hang():
    code = ("import os, time, sys; "
            "time.sleep(60) if os.environ.get('FAULT_ATTEMPT') == '0' "
            "else sys.exit(0)")
    res = sup.retry_subprocess([sys.executable, "-c", code], timeout_s=2.0,
                               max_restarts=1, backoff_base_s=0.05,
                               sleep=lambda s: None)
    assert res["rc"] == 0 and not res["timed_out"]
    assert res["attempts"] == 2
    assert res["history"][0]["outcome"] == "timeout"


def test_retry_subprocess_stops_when_unhealthy():
    res = sup.retry_subprocess(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        timeout_s=1.0, max_restarts=3, backoff_base_s=0.05,
        healthy=lambda: False, sleep=lambda s: None)
    assert res["timed_out"] and not res["healthy_after"]
    assert res["attempts"] == 1


# ---------------------------------------------------------- refusals


def test_supervise_is_refused_under_a_multi_process_launch(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tcli.main(["--supervise", "--device", "cpu"])


def test_supervise_refuses_unported_flags_before_any_child():
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        sup.run_supervised(RunConfig(supervise=True, autotune=True,
                                     device="cpu"))


# ------------------------------------------------- supervise (e2e)

BASE = dict(stencil="life", grid=(64, 64), iters=100, seed=7, device="cpu")


def _read_events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _final_equals_uninterrupted(ck):
    full, _ = tcli.run(RunConfig(**BASE))
    fields, step, _ = checkpointing.load_any(ck)
    assert step == 100
    for a, b in zip(fields, full):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_supervisor_restarts_an_injected_hang_and_bitmatches(
        tmp_path, monkeypatch):
    """The acceptance pin: a real ``--device cpu`` child hangs at step 40,
    its heartbeat (``OBS_STALL_AFTER_S``, counted from its session's open,
    so a slow interpreter start under load cannot trip it) writes STALLED,
    the child is killed, relaunched with --resume from the step-30
    checkpoint, and the final fields equal an uninterrupted run bit for
    bit; the child's spans join the supervisor's trace under its attempt
    span."""
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=40:hang")
    monkeypatch.setenv("FAULT_HANG_S", "120")
    monkeypatch.setenv("OBS_STALL_AFTER_S", "8")
    ck = str(tmp_path / "ck")
    tel = str(tmp_path / "run.jsonl")
    rc = sup.run_supervised(RunConfig(
        **BASE, checkpoint_every=10, checkpoint_dir=ck, telemetry=tel,
        supervise=True, max_restarts=2, restart_backoff=0.2,
        supervise_stall_s=60.0))
    assert rc == 0
    events = _read_events(str(tmp_path / "run.supervisor.jsonl"))
    kinds = [e.get("kind") for e in events]
    assert "restart" in kinds and "give_up" not in kinds
    restart = [e for e in events if e.get("kind") == "restart"][0]
    assert restart["reason"] == "heartbeat verdict STALLED"
    resumed = [e["resumed_from_step"] for e in events
               if e.get("kind") == "launch" and e.get("resume")]
    assert resumed == [30]
    summary = [e for e in events if e.get("kind") == "summary"][-1]
    assert summary["ok"] is True and summary["restarts"] == 1
    child1 = _read_events(str(tmp_path / "run.attempt1.jsonl"))
    assert any(e.get("kind") == "resume"
               and e.get("resumed_from_step") == 30 for e in child1)
    assert any(e.get("kind") == "costmodel" for e in child1)
    attempts = {e["span_id"]: e for e in events
                if e.get("kind") == "span" and e["name"] == "attempt"}
    trace = child1[0]["trace"]
    assert trace["trace_id"] == events[0]["trace"]["trace_id"]
    assert attempts[trace["parent_span_id"]]["attrs"]["attempt"] == 1
    monkeypatch.delenv("FAULT_INJECT")
    faults.reset()
    _final_equals_uninterrupted(ck)


@pytest.mark.slow
def test_supervisor_restarts_on_child_death(tmp_path, monkeypatch):
    """A SIGKILLed child (the exit path: no verdict, no stall wait) is
    relaunched and resumes."""
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=40:sigkill")
    ck = str(tmp_path / "ck")
    rc = sup.run_supervised(RunConfig(
        **BASE, checkpoint_every=10, checkpoint_dir=ck,
        telemetry=str(tmp_path / "run.jsonl"), supervise=True,
        max_restarts=2, restart_backoff=0.2, supervise_stall_s=60.0))
    assert rc == 0
    events = _read_events(str(tmp_path / "run.supervisor.jsonl"))
    restart = [e for e in events if e.get("kind") == "restart"][0]
    assert "exited" in restart["reason"]
    assert checkpointing.latest_step(ck) == 100


@pytest.mark.slow
def test_supervisor_gives_up_against_a_permanent_wedge(tmp_path,
                                                       monkeypatch):
    """always-hang: every attempt wedges; the supervisor gives up loudly
    (exit 1, a give_up event) after max_restarts, never spins."""
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=20:always:hang")
    monkeypatch.setenv("FAULT_HANG_S", "120")
    monkeypatch.setenv("OBS_STALL_AFTER_S", "8")
    rc = sup.run_supervised(RunConfig(
        **BASE, checkpoint_every=10, checkpoint_dir=str(tmp_path / "ck"),
        telemetry=str(tmp_path / "run.jsonl"), supervise=True,
        max_restarts=1, restart_backoff=0.1, supervise_stall_s=60.0))
    assert rc == 1
    events = _read_events(str(tmp_path / "run.supervisor.jsonl"))
    assert any(e.get("kind") == "give_up" for e in events)
    assert os.path.exists(str(tmp_path / "run.supervisor.bundle.json"))


def test_one_served_console_follows_every_attempt(tmp_path, monkeypatch):
    """``--supervise --serve 0``: the parent's one console watches the
    supervisor's log and each attempt's child log as it is launched; its
    status shows the restart and the resume point, the supervisor log one
    ``serve`` event, and no ``obs-serve`` thread outlives the run."""
    import threading

    from mpi_cuda_process_tpu_torch.obs import serve as tserve

    servers = []
    real = tserve.ObsServer

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(tserve, "ObsServer", Kept)
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=40:sigkill")
    tel = str(tmp_path / "run.jsonl")
    rc = sup.run_supervised(RunConfig(
        **BASE, checkpoint_every=10, checkpoint_dir=str(tmp_path / "ck"),
        telemetry=tel, supervise=True, max_restarts=2,
        restart_backoff=0.2, supervise_stall_s=60.0, serve_port=0))
    assert rc == 0 and len(servers) == 1
    console = servers[0].console
    assert console.watched() == [
        sup.sibling_path(tel, tag)
        for tag in ("supervisor", "attempt0", "attempt1")]
    st = console.status()
    assert len(st["restarts"]) == 1 and st["resumed_from_step"] == 30
    assert st["summary"] is not None
    events = _read_events(sup.sibling_path(tel, "supervisor"))
    assert [e.get("kind") for e in events].count("serve") == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("obs-serve") and t.is_alive()]
