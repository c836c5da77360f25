"""The port's live console (``obs/serve.py``, ``obs/aggregate.py``) and the
CLI's ``--serve PORT``.

* a port CLI run with ``--serve 0`` is scraped from a thread while it
  runs: ``obs_events_total`` and the step rise between scrapes,
  ``/events?after=`` returns only newer ``_seq``, a long-poll is bounded,
  the log holds exactly one ``serve`` event, and no ``obs-serve*`` thread
  outlives the run; ``close()`` is idempotent and never raises;
* ``--serve`` without ``--telemetry`` derives a log under
  ``OBS_TELEMETRY_DIR``; ``--serve`` is no longer refused, the other
  unported flags still are;
* the step's aten ops are identical served and unserved;
* the console serves the ledger's ``best_known`` as
  ``obs_ledger_best_known{...}``;
* 2 processes under gloo with ``--serve 0``: process 0 serves one
  ``hosts`` row a process and process 1 binds nothing; their logs give
  the JAX ``aggregate_logs`` output.

Every wait is bounded and every server is closed in ``finally``.
"""

import functools
import glob
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi_cuda_process_tpu.obs import aggregate as jaggregate

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.obs import aggregate as taggregate
from mpi_cuda_process_tpu_torch.obs import ledger as tledger
from mpi_cuda_process_tpu_torch.obs import serve as tserve
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, each subprocess
# boundary stalls (the ``exchange`` site's sleep action, outside the
# timed window) that keep a small run going across several console polls
_STALLS = ",".join(f"exchange:step={s}:sleep:400" for s in (2, 4, 6))

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _own_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode("utf-8")


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return None


def _serve_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("obs-serve") and t.is_alive()]


def _wait_for(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.02)
    return None


def _serve_url(log):
    for rec in (json.loads(line) for line in open(log) if line.strip()):
        if rec.get("kind") == "serve":
            return rec["url"]
    return None


def _url_of(log):
    try:
        return _serve_url(log)
    except (OSError, ValueError):
        return None


# ------------------------------------------------------- a served run

def test_a_served_run_is_scraped_while_it_runs(tmp_path, monkeypatch):
    log = str(tmp_path / "run.jsonl")
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    monkeypatch.setenv("FAULT_INJECT", _STALLS)
    tfaults.reset()
    servers = []
    serve_run = tserve.serve_run

    def kept(*a, **kw):
        servers.append(serve_run(*a, **kw))
        return servers[-1]

    monkeypatch.setattr(tserve, "serve_run", kept)
    scrapes, events, waits, errors = [], [], [], []
    stop = threading.Event()

    def scraper():
        try:
            url = _wait_for(lambda: _url_of(log), 60.0)
            assert url, "no serve event"
            while not stop.is_set():
                try:
                    _, text = _get(url + "/metrics")
                    _, body = _get(url + "/status.json")
                except OSError:
                    break  # the run ended and closed its console
                st = json.loads(body)
                if st["summary"] is None:
                    scrapes.append((_metric(text, "obs_events_total"),
                                    _metric(text, "obs_steps_total") or 0))
                if len(scrapes) == 3 and not events:
                    _, nd = _get(url + "/events?after=0")
                    first = [json.loads(x) for x in nd.splitlines()]
                    after = first[-1]["_seq"] - 1
                    _, nd = _get(url + f"/events?after={after}")
                    events.append((first, after, [
                        json.loads(x) for x in nd.splitlines()]))
                    t0 = time.monotonic()
                    _, nd = _get(url + "/events?after=100000&wait=0.3")
                    waits.append((time.monotonic() - t0, nd))
                time.sleep(0.05)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=scraper, name="scraper")
    th.start()
    try:
        tcli.run(tcli.config_from_args(
            ["--stencil", "heat3d", "--grid", "48,32,128", "--iters", "8",
             "--mesh", "2,2", "--fuse", "2", "--fuse-kind", "stream",
             "--log-every", "2", "--serve", "0", "--telemetry", log,
             "--device", "cpu"]))
    finally:
        stop.set()
        th.join(30.0)
        tfaults.reset()
        for s in servers:
            s.close()
    assert not errors, errors
    assert len(servers) == 1 and not _serve_threads()
    # mid-run scrapes: the event count and the step rise
    assert len({e for e, _ in scrapes}) >= 2, scrapes
    assert scrapes[-1][1] > scrapes[0][1], scrapes
    first, after, newer = events[0]
    assert [e["_seq"] for e in first] == list(range(1, len(first) + 1))
    assert newer and all(e["_seq"] > after for e in newer)
    assert first[0]["kind"] == "manifest"
    took, body = waits[0]
    assert body == "" and 0.25 <= took < 5.0
    recs = [json.loads(line) for line in open(log)]
    serve_events = [r for r in recs if r["kind"] == "serve"]
    assert len(serve_events) == 1
    assert serve_events[0]["endpoints"] == ["/metrics", "/status.json",
                                            "/events"]
    # after the run: the final drain saw the summary; close again is a
    # no-op that never raises
    st = servers[0].console.status()
    assert st["verdict"] == "DONE" and st["events_seen"] == len(recs)
    servers[0].close()
    servers[0].close()
    with pytest.raises(urllib.error.URLError):
        _get(servers[0].url + "/metrics", timeout=2.0)


def test_serve_without_telemetry_derives_a_log(tmp_path):
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat2d", "--grid", "32,32", "--iters", "4",
         "--serve", "0", "--device", "cpu"]))
    logs = glob.glob(str(tmp_path / "tel" / "serve-*.jsonl"))
    assert len(logs) == 1
    _, events = ttrace.validate_log(logs[0])
    assert [e["kind"] for e in events].count("serve") == 1
    assert not _serve_threads()


def test_serve_is_no_longer_refused_and_the_rest_still_are():
    assert tcli.config_from_args(["--serve", "0"]).serve_port == 0
    assert "serve_port" not in {f for f, _, _ in tcli._UNPORTED}
    # --supervise runs too (tests/test_torch_supervisor.py)
    assert "supervise" not in {f for f, _, _ in tcli._UNPORTED}
    assert len(tcli._UNPORTED) == 4
    for field, _, _ in tcli._UNPORTED:
        cfg = RunConfig(stencil="heat3d", grid=(8, 8, 8), iters=2,
                        device="cpu", **{field: 1})
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            tcli.build(cfg)


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


def test_the_step_runs_the_same_ops_served(tmp_path, monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
            "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
            "--device", "cpu", "--log-every", "4"]
    off = _step_ops(monkeypatch, base + ["--telemetry",
                                         str(tmp_path / "a.jsonl")])
    on = _step_ops(monkeypatch, base + ["--telemetry",
                                        str(tmp_path / "b.jsonl"),
                                        "--serve", "0"])
    assert len(off) == 2 and off[0]
    assert on == off


# ------------------------------------------------------------ console

def test_console_serves_the_ledger_and_bounded_events(tmp_path):
    rows = [tledger.make_row("cli_heat3d_1024x1024x1024", 6000.0,
                             source="card", expected_backend="cuda"),
            tledger.make_row("cli_heat3d_1024x1024x1024", 90000.0,
                             source="wedged", heartbeat="WEDGED",
                             expected_backend="cuda"),
            tledger.make_row("cli_heat2d_32x32", 3.0, source="cpu",
                             expected_backend="cpu")]
    tledger.append_rows(rows)
    log = str(tmp_path / "x.jsonl")
    server = tserve.serve_run(log, port=0, poll_s=0.05)
    try:
        assert {t for t in _serve_threads()} == {"obs-serve-http",
                                                  "obs-serve-poll"}
        code, text = _get(server.url + "/metrics")
        assert code == 200
        assert ('obs_ledger_best_known{backend="cuda",label='
                '"cli_heat3d_1024x1024x1024",unit="Mcells/s"} 6000') in text
        assert 'obs_ledger_best_known{backend="cpu",' in text
        code, body = _get(server.url + "/")
        assert code == 200 and "/events?after=SEQ" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url + "/nope")
        assert e.value.code == 404
        # nothing logged yet: an empty reply, after the bounded wait
        t0 = time.monotonic()
        _, nd = _get(server.url + "/events?after=0&wait=0.2")
        assert nd == "" and time.monotonic() - t0 >= 0.15
        with open(log, "w") as fh:
            for i in range(3):
                fh.write(json.dumps({"kind": "chunk", "chunk": i}) + "\n")
            fh.write('{"kind": "half"')
        got = _wait_for(lambda: _get(server.url + "/events?after=1")[1],
                        10.0)
        seqs = [json.loads(x)["_seq"] for x in got.splitlines()]
        assert seqs == [2, 3]
        # a parked long-poll wakes when a record lands
        done = []
        waiter = threading.Thread(target=lambda: done.append(
            _get(server.url + "/events?after=3&wait=20")[1]))
        waiter.start()
        time.sleep(0.2)
        with open(log, "a") as fh:
            fh.write('}\n')
        waiter.join(10.0)
        assert json.loads(done[0])["kind"] == "half"
    finally:
        server.close()
    assert not _serve_threads()
    server.close()


# ------------------------------------------------------ two processes

def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """2 gloo processes with ``--serve 0`` and no ``--telemetry``: the
    console of process 0 polled until it shows both processes."""
    d = tmp_path_factory.mktemp("mp_serve")
    tel = str(d / "tel")
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", tmesh.VIRTUAL_DEVICES_ENV):
        env.pop(k, None)
    env.update({tmesh.DIST_TIMEOUT_ENV: "60", "PYTHONPATH": _REPO,
                "OBS_TELEMETRY_DIR": tel,
                "OBS_LEDGER_PATH": str(d / "ledger.jsonl"),
                "FAULT_INJECT": _STALLS, "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
                "LOCAL_WORLD_SIZE": "2"})
    argv = ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
            "--mesh", "2", "--log-every", "2", "--health", "--serve", "0",
            "--device", "cpu"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=_REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(2)]
    best = {}
    try:
        def log0():
            logs = [p for p in glob.glob(os.path.join(tel, "serve-*.jsonl"))
                    if ".p1." not in p]
            return logs[0] if logs else None

        deadline = time.monotonic() + TIMEOUT
        url = None
        while time.monotonic() < deadline and procs[0].poll() is None:
            path = log0()
            url = url or (path and _url_of(path))
            if url:
                try:
                    st = json.loads(_get(url + "/status.json", 5.0)[1])
                except (OSError, ValueError):
                    st = {}
                if len(st.get("hosts") or ()) >= len(best.get("hosts")
                                                     or ()):
                    best = st
                if len(best.get("hosts") or ()) == 2 and \
                        all(h["latest_chunk"] for h in best["hosts"]):
                    break
            time.sleep(0.05)
        errs = []
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            errs.append(err)
            assert p.returncode == 0, err[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return {"status": best, "errs": errs, "logs": sorted(glob.glob(
        os.path.join(tel, "serve-*.jsonl")), key=len)}


def test_process_zero_serves_a_row_a_process(two_process_run):
    st = two_process_run["status"]
    hosts = st.get("hosts") or []
    assert [h["process_index"] for h in hosts] == [0, 1], st
    assert all(h["key"].endswith(f"|p{h['process_index']}")
               and h["process_count"] == 2 for h in hosts)
    assert st["aggregate"]["processes"] == 2
    logs = two_process_run["logs"]
    assert len(logs) == 2 and logs[1].endswith(".p1.jsonl")
    kinds = [[e["kind"] for e in ttrace.validate_log(p)[1]] for p in logs]
    assert kinds[0].count("serve") == 1 and "serve" not in kinds[1]
    errs = two_process_run["errs"]
    assert "obs live console serving at" in errs[0]
    assert "serving at" not in errs[1] and "--serve disabled" not in errs[1]


def test_aggregate_logs_match_the_reference(two_process_run):
    logs = two_process_run["logs"]
    got = taggregate.aggregate_logs(logs)
    want = jaggregate.aggregate_logs(logs)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    assert got["aggregate"]["verdict"] == "DONE"
    assert [r["verdict"] for r in got["hosts"]] == ["DONE", "DONE"]
