"""The port's metrics registry and ``RunMetrics`` (``obs/metrics.py``),
``trace.LogTail`` and ``trace.default_telemetry_dir``, against the JAX
package's.

* the same sequence of registry operations gives identical
  ``to_prometheus()`` text and ``snapshot()`` (every metric class, label
  escaping, NaN/Inf, the bounded reservoir, a kind clash);
* the port CLI's own log of a run (sharded stream with the ring, health,
  halo audits and anomaly doctor; an ensemble; device groups; a resumed
  run; a DIVERGED run), fed to both ``RunMetrics``, gives equal
  Prometheus text and equal ``status()`` — apart from ``generated_at``
  (the wall clock);
* ``LogTail`` consumes the same records as the reference's through
  partial lines, malformed lines and a truncation.
"""

import json
import math
import os
import threading

import pytest

from mpi_cuda_process_tpu.obs import metrics as jmetrics
from mpi_cuda_process_tpu.obs import trace as jtrace

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.obs import metrics as tmetrics
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults

@pytest.fixture(autouse=True)
def _own_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _ops_basic(reg):
    reg.counter("a_total", "a help").inc()
    reg.counter("a_total").inc(2.5)
    reg.gauge("g", "a gauge").set(3)
    reg.gauge("g").set_max(2)
    reg.gauge("peak").set_max(7)
    reg.gauge("peak").set_max(9.25)
    reg.gauge("unset", "never set")
    reg.info("run_info", "identity").set(stencil="heat3d", grid="8,8",
                                          none=None)


def _ops_escapes(reg):
    reg.info("weird-name.info", 'with "quotes"').set(
        path='a\\b"c\nd', n=1)
    reg.gauge_family("fam", "a family").set(1.5, label="x", backend="cuda")
    reg.gauge_family("fam").set(2, backend="cpu", label="x")
    reg.gauge_family("fam").set(3, label="x", backend="cuda")
    reg.gauge("nan").set(float("nan"))
    reg.gauge("inf").set(float("inf"))
    reg.gauge("ninf").set(-math.inf)
    reg.gauge("big").set(1e16)


def _ops_histogram(reg):
    h = reg.histogram("h_ms", "a histogram", bound=4)
    for v in (5, 1, 9, 3, 7, 2, 8):
        h.observe(v)
    reg.histogram("empty", "nothing observed")
    with pytest.raises(ValueError):
        reg.gauge("h_ms")


@pytest.mark.parametrize("ops", [_ops_basic, _ops_escapes, _ops_histogram],
                         ids=["basic", "escapes", "histogram"])
def test_registry_text_and_snapshot_match_the_reference(ops):
    t, j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    ops(t)
    ops(j)
    assert t.to_prometheus() == j.to_prometheus()
    assert json.dumps(t.snapshot(), default=str) == \
        json.dumps(j.snapshot(), default=str)


@pytest.mark.parametrize("vals", [[], [3.0], [1, 2, 3, 4], [5, 1, 4, 2, 3]])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_quantile_matches_the_reference(vals, q):
    a = tmetrics.quantile(sorted(vals), q)
    b = jmetrics.quantile(sorted(vals), q)
    assert (math.isnan(a) and math.isnan(b)) or a == b


def test_registry_snapshot_is_consistent_under_concurrent_ingest():
    rm = tmetrics.RunMetrics()
    rm.ingest({"kind": "manifest", "run": {"grid": [8, 8]}})
    stop = threading.Event()

    def writer():
        n = 0
        while not stop.is_set():
            n += 1
            rm.ingest({"kind": "chunk", "chunk": n, "steps": 2,
                       "wall_s": 0.01, "ms_per_step": 5.0})

    th = threading.Thread(target=writer)
    th.start()
    try:
        for _ in range(200):
            snap = rm.registry.snapshot()
            if "obs_chunks_total" in snap:
                # one chunk = one obs_chunks_total and two steps, always
                assert snap["obs_steps_total"]["value"] == \
                    2 * snap["obs_chunks_total"]["value"]
    finally:
        stop.set()
        th.join(5.0)


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _held(path):
    """Both packages' RunMetrics over the port CLI's log ``path``."""
    out = []
    for mod in (jmetrics, tmetrics):
        rm = mod.RunMetrics()
        for rec in _records(path):
            rm.ingest(rec)
        out.append(rm)
    j, t = out
    assert t.registry.to_prometheus() == j.registry.to_prometheus()
    js, ts = j.status(), t.status()
    js.pop("generated_at"), ts.pop("generated_at")
    assert json.dumps(ts, sort_keys=True, default=str) == \
        json.dumps(js, sort_keys=True, default=str)
    return ts, t.registry.to_prometheus()


@pytest.mark.parametrize("argv", [
    ["--stencil", "wave3d", "--grid", "16,16,32", "--iters", "8",
     "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
     "--exchange", "rdma", "--health", "--halo-audit", "1", "--anomaly",
     "--log-every", "4"],
    ["--stencil", "heat2d", "--grid", "32,32", "--iters", "8",
     "--ensemble", "3", "--log-every", "2", "--health"],
    ["--stencil", "heat3d", "--grid", "30,16,16", "--iters", "4",
     "--groups", "heat3d@0-3,heat3d@4-7", "--log-every", "2", "--health"],
], ids=["stream-rdma", "ensemble", "groups"])
def test_run_metrics_on_a_port_log_match_the_reference(argv, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    log = str(tmp_path / "t.jsonl")
    tcli.run(tcli.config_from_args(argv + ["--device", "cpu",
                                           "--telemetry", log]))
    status, text = _held(log)
    assert status["verdict"] == "DONE"
    assert status["throughput"]["steps_per_s"] > 0
    assert "obs_run_complete 1" in text
    if "--ensemble" in argv:
        assert status["throughput"]["ensemble"] == 3
        assert "obs_member_gcells_per_s" in text
    if "--groups" in argv:
        assert status["groups"]["n_groups"] == 2
        assert status["groups"]["worst_verdict"] == "HEALTHY"
        assert "obs_group_mcells_per_s{group=" in text
    if "--exchange" in argv:
        assert status["exchange"]["backend"] == "plain-ring"
        assert status["halo_audit"]["ok"]
        assert 'obs_exchange_mode{backend="plain-ring",mode="rdma"} 1' \
            in text


def test_run_metrics_on_resumed_and_diverged_logs(tmp_path, monkeypatch):
    argv = ["--stencil", "heat3d", "--grid", "8,8,16", "--log-every", "2",
            "--checkpoint-every", "2", "--health", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck")]
    tcli.run(tcli.config_from_args(argv + ["--iters", "4"]))
    log = str(tmp_path / "r.jsonl")
    tcli.run(tcli.config_from_args(argv + ["--iters", "8", "--resume",
                                           "--telemetry", log]))
    status, text = _held(log)
    assert status["resumed_from_step"] == 4
    assert "obs_resumed_from_step 4" in text
    monkeypatch.setenv("FAULT_INJECT", "numerics:step=6:nan")
    tfaults.reset()
    log = str(tmp_path / "d.jsonl")
    with pytest.raises(Exception):
        tcli.run(tcli.config_from_args(argv[:6] + [
            "--health", "--device", "cpu", "--iters", "8",
            "--telemetry", log]))
    tfaults.reset()
    status, text = _held(log)
    assert status["verdict"] == "DIVERGED" and status["errors"]
    assert "obs_health_diverged 1" in text and "obs_errors_total 1" in text


@pytest.mark.parametrize("steps", [
    ["a", "b", "partial", "complete", "garbage", "truncate", "c"],
    ["partial", "complete", "truncate", "partial", "complete"],
    ["missing", "a", "scalar", "b"],
], ids=["mixed", "rewrite", "missing"])
def test_log_tail_matches_the_reference(steps, tmp_path):
    path = str(tmp_path / "x.jsonl")
    tails = [ttrace.LogTail(path), jtrace.LogTail(path)]
    got = [[], []]
    n = 0
    for step in steps:
        if step == "missing":
            pass
        elif step == "partial":
            with open(path, "a") as fh:
                fh.write('{"kind": "half", "n": ')
        elif step == "complete":
            with open(path, "a") as fh:
                fh.write('1}\n')
        elif step == "garbage":
            with open(path, "a") as fh:
                fh.write("not json\n\n")
        elif step == "scalar":
            with open(path, "a") as fh:
                fh.write("[1, 2]\n")
        elif step == "truncate":
            with open(path, "w") as fh:
                fh.write('{"kind": "fresh"}\n')
        else:
            n += 1
            with open(path, "a") as fh:
                fh.write(json.dumps({"kind": step, "n": n}) + "\n")
        for i, tail in enumerate(tails):
            got[i].append(tail.poll())
    assert got[0] == got[1]
    assert (tails[0].malformed, tails[0].truncations) == \
        (tails[1].malformed, tails[1].truncations)
    assert any(got[0])


def test_default_telemetry_dir(tmp_path, monkeypatch):
    assert ttrace.default_telemetry_dir() == str(tmp_path / "tel")
    monkeypatch.delenv("OBS_TELEMETRY_DIR")
    assert ttrace.default_telemetry_dir() == jtrace.default_telemetry_dir()
    assert os.path.basename(ttrace.default_telemetry_dir()) == ".telemetry"
