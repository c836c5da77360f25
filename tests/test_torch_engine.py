"""The request layer (``engine.py``, ``cancellation.py``): the port
against the JAX package.

The same requests (seeds from numpy) go to the JAX ``SimulationEngine``
and the port's (``device="cpu"``): each ends the same way in both (done,
cancelled, failed), and a finished run's fields agree at
``tests/test_torch_cli.py``'s tolerance (plain step ``32 eps max(|ref|,
1)`` a step).  A cancel is the third terminal outcome everywhere: phase
``cancelled``, a ``cancelled`` event and never an ``error``, verdict
CANCELLED, a ledger row quarantined ``cancelled``, ``RunCancelled`` from
``result()``; the CLI's chunk boundary (normal and ``--groups`` runs) is
the cancellation point.  The request span parents the run's session.
"""

import json
import threading
import time

import numpy as np
import pytest

from mpi_cuda_process_tpu.cancellation import RunCancelled as JCancelled
from mpi_cuda_process_tpu.config import RunConfig as JConfig
from mpi_cuda_process_tpu.engine import SimulationEngine as JEngine

from mpi_cuda_process_tpu_torch import cancellation, cli
from mpi_cuda_process_tpu_torch.cancellation import RunCancelled
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.engine import SimulationEngine
from mpi_cuda_process_tpu_torch.obs import ledger as ledger_lib
from mpi_cuda_process_tpu_torch.obs import spans as spans_lib

EPS32 = float(np.finfo(np.float32).eps)
SEEDS = np.random.default_rng(27).integers(0, 2**16, size=3).tolist()


@pytest.fixture(autouse=True)
def _isolated_obs(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _wait_chunk(h, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline and not any(
            e.get("kind") == "chunk" for e in h.events()):
        time.sleep(0.02)


def test_engine_runs_match_jax_engine(tmp_path):
    """Three requests through both engines: done in both, the port's
    fields at the CLI tolerance of JAX's, the status vocabulary the
    same (verdict DONE, phase done, ensemble throughput)."""
    jobs = [dict(stencil="heat2d", grid=(16, 16), iters=8, seed=SEEDS[0],
                 init="random"),
            dict(stencil="heat3d", grid=(16, 16, 32), iters=8,
                 seed=SEEDS[1], ensemble=2, log_every=2),
            dict(stencil="life", grid=(16, 32), iters=12, seed=SEEDS[2])]
    jeng = JEngine(telemetry_dir=str(tmp_path / "jax"))
    teng = SimulationEngine(telemetry_dir=str(tmp_path / "pt"))
    jh = [jeng.submit(JConfig(**kw)) for kw in jobs]
    th = [teng.submit(RunConfig(device="cpu", **kw)) for kw in jobs]
    for kw, a, b in zip(jobs, jh, th):
        jf, _ = a.result(timeout=300)
        tf, _ = b.result(timeout=300)
        assert a._phase() == b._phase() == "done"
        for j, t in zip(jf, tf):
            j, t = np.asarray(j), t.numpy()
            assert j.shape == t.shape and j.dtype == t.dtype
            atol = 0 if kw["stencil"] == "life" else \
                32 * EPS32 * max(float(np.abs(j).max()), 1.0) * kw["iters"]
            np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        js, ts = a.status(), b.status()
        assert js["verdict"] == ts["verdict"] == "DONE"
        assert js["request"]["phase"] == ts["request"]["phase"] == "done"
        if kw.get("ensemble"):
            assert ts["throughput"]["ensemble"] == 2
            assert "gcells_per_s_per_member" in ts["throughput"]
    # the derived cadence: ~8 chunks, so both logs carry chunk records
    assert th[0].config.log_every == 1 and jh[0].config.log_every == 1
    evs = th[2].events(after=0)
    assert [e["_seq"] for e in evs] == list(range(1, len(evs) + 1))
    assert {"manifest", "chunk", "summary"} <= {e["kind"] for e in evs}


def test_cancel_is_the_third_outcome_in_both_engines(tmp_path):
    """A long run cancelled after its first chunk: phase cancelled, a
    ``cancelled`` event and no ``error`` or ``summary``, verdict
    CANCELLED, ``RunCancelled`` from result(), a quarantined ledger row
    and the engine's cancelled counter — in both packages."""
    cfg = dict(stencil="heat2d", grid=(64, 64), iters=262144, log_every=64)
    out = {}
    for name, eng, make, exc in (
            ("jax", JEngine(telemetry_dir=str(tmp_path / "jax")), JConfig,
             JCancelled),
            ("pt", SimulationEngine(telemetry_dir=str(tmp_path / "pt")),
             lambda **kw: RunConfig(device="cpu", **kw), RunCancelled)):
        h = eng.submit(make(**cfg))
        _wait_chunk(h)
        assert h.cancel()
        assert h.wait(120)
        with pytest.raises(exc):
            h.result(timeout=1)
        kinds = [e.get("kind") for e in h.events()]
        st = h.status()
        out[name] = (h._phase(), "cancelled" in kinds, "error" in kinds,
                     "summary" in kinds, st["verdict"],
                     st["cancelled"]["step"] > 0,
                     eng.metrics.snapshot()[
                         "engine_requests_cancelled_total"]["value"])
        assert h.cancel() is False
    assert out["pt"] == out["jax"] == (
        "cancelled", True, False, False, "CANCELLED", True, 1)
    rows = ledger_lib.rows_from_log(h.telemetry_path)
    assert len(rows) == 1
    assert rows[0]["status"] == "quarantined"
    assert rows[0]["quarantine"] == "cancelled"


def test_run_errors_and_refusals_match_jax(tmp_path):
    for eng, make in ((JEngine(telemetry_dir=str(tmp_path / "jax")),
                       JConfig),
                      (SimulationEngine(telemetry_dir=str(tmp_path / "pt")),
                       lambda **kw: RunConfig(device="cpu", **kw))):
        with pytest.raises(ValueError, match="supervise"):
            eng.submit(make(stencil="life", grid=(16, 16), iters=2,
                            supervise=True))
        h = eng.submit(make(stencil="heat3d", grid=(96, 32, 128), iters=8,
                            fuse=4, fuse_kind="stream", periodic=True))
        with pytest.raises(ValueError, match="guard-frame"):
            h.result(timeout=300)
        assert h.status()["request"]["phase"] == "failed"
        done = eng.submit(make(stencil="heat2d", grid=(16, 16), iters=4))
        done.result(timeout=300)
        assert done.cancel() is False and done._phase() == "done"


def test_request_span_parents_the_run_session(tmp_path):
    """The engine's request context rides the run's thread: the run's
    session joins the request's trace under its span, and the request,
    queue_wait and result spans land after the run."""
    eng = SimulationEngine(telemetry_dir=str(tmp_path))
    h = eng.submit(RunConfig(stencil="heat2d", grid=(16, 16), iters=8,
                             device="cpu"))
    h.result(timeout=120)
    evs = _events(h.telemetry_path)
    man = evs[0]
    assert man["trace"]["trace_id"] == h.trace_id
    assert man["trace"]["parent_span_id"] == h.request_span_id
    spans = {e["name"]: e for e in evs if e.get("kind") == "span"}
    assert spans["request"]["span_id"] == h.request_span_id
    assert spans["request"]["parent_id"] is None
    assert spans["queue_wait"]["parent_id"] == h.request_span_id
    assert spans["cli"]["parent_id"] == h.request_span_id
    assert set(h.timings) == {"queue_wait_s", "time_to_first_chunk_s",
                              "latency_s"}


def test_thread_context_is_per_thread():
    ctx = spans_lib.SpanContext("t" * 16, "s" * 16)
    assert spans_lib.thread_context() is None
    spans_lib.push_thread_context(ctx)
    try:
        assert spans_lib.resolve_context() is ctx
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            spans_lib.thread_context()))
        t.start()
        t.join(10)
        assert not t.is_alive() and seen == [None]
    finally:
        spans_lib.pop_thread_context()
    assert spans_lib.thread_context() is None


@pytest.mark.parametrize("extra", [
    dict(stencil="heat2d", grid=(16, 16), log_every=2),
    dict(groups="heat3d@0-1,heat3d@2-3", grid=(30, 16, 16), log_every=2),
], ids=["run", "groups"])
def test_cli_boundary_is_the_cancellation_point(tmp_path, monkeypatch,
                                                 extra):
    """With the thread's token already set, ``cli.run`` stops at its
    first chunk boundary (the coupled loop too): a ``cancelled`` event at
    that step, no ``error``, and ``RunCancelled`` out."""
    monkeypatch.setenv("MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES", "4")
    path = str(tmp_path / "run.jsonl")
    cfg = RunConfig(iters=8, device="cpu", telemetry=path, **extra)
    token = threading.Event()
    token.set()
    with cancellation.scope(token):
        assert cancellation.requested()
        with pytest.raises(RunCancelled) as ei:
            cli.run(cfg)
    assert not cancellation.requested()
    assert ei.value.step == 2
    kinds = [e.get("kind") for e in _events(path)]
    assert "cancelled" in kinds and "error" not in kinds
    assert [e for e in _events(path)
            if e.get("kind") == "cancelled"][0]["step"] == 2
