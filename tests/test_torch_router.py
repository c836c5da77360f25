"""The fleet front door (``serving/router.py``): the port's
``ServingRouter`` against the JAX package's.

The same routed jobs go to both routers on the CPU and end alike: the
second job of a class lands on its affine replica and builds nothing; a
replica killed mid-job loses nothing (its jobs rebalance to a survivor
and rerun from their configs, the port's rerun bit-equal to its solo
run) and comes back as generation 1; a job is refused only when every
replica refuses (``unsupported`` at once); the router log and the
replica logs roll up into one fleet row a replica; cancelled requests
stay out of the latency histograms; a burst-grown class shrinks back
down the ladder with its survivor bit-exact, and ``shrink_after_rounds=0``
disables that.  The port's replicas share one step lock (one card).
"""

import json
import time

import numpy as np
import pytest

from mpi_cuda_process_tpu.config import RunConfig as JConfig
from mpi_cuda_process_tpu.serving import ServingRouter as JRouter

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import serving
from mpi_cuda_process_tpu_torch.cancellation import RunCancelled
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.engine import SimulationEngine
from mpi_cuda_process_tpu_torch.obs import aggregate as agg_lib
from mpi_cuda_process_tpu_torch.obs import metrics as metrics_lib
from mpi_cuda_process_tpu_torch.obs import runtime as runtime_lib
from mpi_cuda_process_tpu_torch.obs import trace as trace_lib
from mpi_cuda_process_tpu_torch.serving import AdmissionError, ServingRouter

SEEDS = np.random.default_rng(17).integers(0, 2**16, size=6).tolist()


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _kw(seed=0, grid=(16, 16), iters=16, **kw):
    return dict(stencil="heat2d", grid=grid, iters=iters, seed=seed, **kw)


def _t(**kw):
    return RunConfig(device="cpu", **kw)


def _solo_equal(fields, kw):
    want, _ = tcli.run(_t(**kw))
    for a, b in zip(fields, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _wait_first_chunk(h, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not h.done():
        inner = h._inner
        if inner is not None and \
                inner.timings.get("time_to_first_chunk_s") is not None:
            return True
        time.sleep(0.01)
    return False


def test_affinity_second_job_builds_nothing(tmp_path):
    for Router, make in ((JRouter, JConfig), (ServingRouter, _t)):
        r = Router(replicas=2, ladder=(2,), cadence=8,
                   telemetry_dir=str(tmp_path / Router.__module__))
        try:
            ha = r.submit(make(**_kw(seed=SEEDS[0])), tenant="a")
            ha.result(300)
            seen = runtime_lib.compiles_seen()
            hb = r.submit(make(**_kw(seed=SEEDS[1])), tenant="b")
            hb.result(300)
            assert hb.replica == ha.replica
            if Router is ServingRouter:
                assert runtime_lib.compiles_seen() == seen, \
                    "a class's second job must build nothing anywhere"
        finally:
            stats = r.close()
        assert stats["jobs_done"] == 2 and stats["lost_jobs"] == 0


def test_kill_rebalances_and_restarts_zero_lost_in_both(tmp_path):
    out = []
    for Router, make in ((JRouter, JConfig), (ServingRouter, _t)):
        r = Router(replicas=3, ladder=(1, 2), cadence=8,
                   restart_backoff=0.05,
                   telemetry_dir=str(tmp_path / Router.__module__))
        try:
            r.submit(make(**_kw(seed=3))).result(300)
            victim_kw = _kw(seed=4, iters=24000)
            h = r.submit(make(**victim_kw))
            target = h.replica
            assert _wait_first_chunk(h), "victim never started computing"
            assert not h.done()
            assert r.kill_replica(target)
            fields, _ = h.result(600)
            assert h.resubmits >= 1 and h.replica != target
            deadline = time.time() + 15
            while time.time() < deadline and \
                    not r.replicas()[target]["alive"]:
                time.sleep(0.05)
            rep = r.replicas()[target]
            after = r.submit(make(**_kw(seed=5)))
            after.result(300)
        finally:
            stats = r.close()
        out.append((rep["alive"], rep["generation"], stats["lost_jobs"],
                    stats["jobs_done"], stats["rebalanced"] >= 1,
                    stats["restarts"]))
        if Router is ServingRouter:
            _solo_equal(fields, victim_kw)
    assert out[0] == out[1] == (True, 1, 0, 3, True, 1)


def test_kill_dead_or_unknown_replica_is_false(tmp_path):
    r = ServingRouter(replicas=1, max_restarts=0,
                      telemetry_dir=str(tmp_path))
    try:
        assert not r.kill_replica("nope")
        assert r.kill_replica("r0")
        assert not r.kill_replica("r0"), "already dead"
    finally:
        r.close(drain=False, timeout=10)


def test_admission_is_aggregate_and_unsupported_never_falls_through(
        tmp_path):
    reasons = []
    for Router, make in ((JRouter, JConfig), (ServingRouter, _t)):
        r = Router(replicas=2, ladder=(2,), hbm_bytes=1,
                   telemetry_dir=str(tmp_path / Router.__module__))
        try:
            with pytest.raises(Exception) as ei:
                r.submit(make(**_kw(seed=1)))
            over = (ei.value.reason, "aggregate" in str(ei.value))
            with pytest.raises(Exception) as ei:
                r.submit(make(**_kw(seed=1, resume=True)))
            reasons.append((over, ei.value.reason))
        finally:
            stats = r.close()
        assert stats["rejects"] == 2 and stats["jobs_done"] == 0
    assert reasons[0] == reasons[1] == ((("over_budget", True)),
                                        "unsupported")
    assert issubclass(AdmissionError, ValueError)


def test_replicas_split_the_card_budget(tmp_path):
    """ROADMAP C: the port's replicas share one card, so each admits
    within an equal slice of the budget; two classes that each fit the
    budget but not together are not both admitted.  The TPU package gives
    every replica the whole budget and admits both."""
    from mpi_cuda_process_tpu.serving import AdmissionController as JAdm
    from mpi_cuda_process_tpu.serving import class_config as jclass_config

    from mpi_cuda_process_tpu_torch.serving import (AdmissionController,
                                                    class_config)

    small, large = _kw(seed=1), _kw(seed=2, grid=(32, 32))
    port = [AdmissionController().price(class_config(_t(**k), 1))[
        "total_bytes"] for k in (small, large)]
    jax = [JAdm().price(jclass_config(JConfig(**k), 1))["total_bytes"]
           for k in (small, large)]
    budget = max(sum(port) - 1, jax[0], jax[1])
    assert port[0] <= budget // 2 < port[1] <= budget < sum(port)
    admitted = []
    for Router, make in ((JRouter, JConfig), (ServingRouter, _t)):
        r = Router(replicas=2, ladder=(1,), cadence=8, hbm_bytes=budget,
                   max_restarts=0,
                   telemetry_dir=str(tmp_path / Router.__module__))
        try:
            got = [r.submit(make(**small))]
            try:
                got.append(r.submit(make(**large)))
            except AdmissionError as e:
                assert e.reason == "over_budget" and "aggregate" in str(e)
            for h in got:
                h.result(timeout=300)
            admitted.append(len(got))
        finally:
            r.close()
    assert admitted == [2, 1]

def test_fleet_status_has_a_row_a_replica(tmp_path):
    r = ServingRouter(replicas=3, ladder=(2,), cadence=8,
                      telemetry_dir=str(tmp_path))
    try:
        hs = [r.submit(_t(**_kw(seed=s, grid=(16, 16 + 16 * (s % 2)))))
              for s in range(4)]
        for h in hs:
            h.result(300)
        paths = [r.telemetry_path] + [
            rep["telemetry"] for rep in r.replicas().values()]
    finally:
        r.close()
    for p in paths[1:]:
        with open(p) as fh:
            manifest = json.loads(fh.readline())
        trace_lib.validate_manifest(manifest)
        assert manifest["replica"] in ("r0", "r1", "r2")
    status = agg_lib.aggregate_logs(paths)
    rows = [row for row in status["hosts"] if row.get("replica")]
    assert len(rows) == 3
    busy = [row for row in rows if row.get("scheduler")]
    assert busy and busy[0]["scheduler"].get("size_classes")


def test_router_events_fold_into_status(tmp_path):
    r = ServingRouter(replicas=2, ladder=(1, 2), cadence=8,
                      restart_backoff=0.05, max_restarts=0,
                      telemetry_dir=str(tmp_path))
    try:
        h = r.submit(_t(**_kw(seed=7, iters=12000)))
        assert _wait_first_chunk(h)
        r.kill_replica(h.replica)
        h.result(600)
    finally:
        r.close()
    rm = metrics_lib.RunMetrics()
    for rec in agg_lib.iter_records(r.telemetry_path):
        rm.ingest(rec)
    rt = rm.status()["router"]
    assert rt["counts"]["route"] >= 1 and rt["counts"]["rebalance"] >= 1
    assert rt["counts"]["replica_dead"] == 1
    assert rt["last_death"]["replica"] in ("r0", "r1")
    assert rt["replicas_total"] == 2
    assert "obs_router_route_total" in rm.registry.to_prometheus()


def test_cancelled_requests_stay_out_of_latency_histograms(tmp_path):
    eng = SimulationEngine(telemetry_dir=str(tmp_path))
    eng.submit(_t(**_kw(seed=1, iters=4))).result(timeout=300)
    with eng.metrics.lock:
        base_lat = eng.metrics.histogram(
            "engine_request_latency_s", "").count
        base_ttfc = eng.metrics.histogram(
            "engine_time_to_first_chunk_s", "").count
    victim = eng.submit(_t(**_kw(seed=2, iters=200000, log_every=8)))
    while victim.started_at is None and not victim.done():
        time.sleep(0.01)
    victim.cancel()
    with pytest.raises(RunCancelled):
        victim.result(timeout=300)
    with eng.metrics.lock:
        assert eng.metrics.counter(
            "engine_requests_cancelled_total", "").value == 1
        assert eng.metrics.histogram(
            "engine_request_latency_s", "").count == base_lat
        assert eng.metrics.histogram(
            "engine_time_to_first_chunk_s", "").count == base_ttfc


@pytest.mark.parametrize("shrink_after", [3, 0], ids=["shrinks", "off"])
def test_ladder_shrink_in_both(tmp_path, shrink_after):
    """A class grown for a burst repacks down the ladder once occupancy
    falls (``shrink`` events, the class back below its peak); the
    long-lived survivor stays bit-exact; 0 disables shrinking."""
    out = []
    for Engine, make in (
            (__import__("mpi_cuda_process_tpu.serving",
                        fromlist=["ServingEngine"]).ServingEngine, JConfig),
            (serving.ServingEngine, _t)):
        eng = Engine(telemetry_dir=str(tmp_path / Engine.__module__),
                     ladder=(1, 2, 4), cadence=4,
                     shrink_after_rounds=shrink_after)
        burst = [eng.submit(make(**_kw(seed=s, iters=24)), tenant=f"b{s}")
                 for s in (1, 2, 3)]
        survivor_kw = _kw(seed=9, iters=4000)
        survivor = eng.submit(make(**survivor_kw), tenant="long")
        for h in burst:
            h.result(timeout=300)
        fields, _ = survivor.result(timeout=600)
        stats = eng.close()
        [cls] = stats["class_table"]
        out.append((stats["shrinks"] >= 1, cls["capacity"] < 4,
                    cls["occupied"], stats["jobs_done"]))
        if Engine is serving.ServingEngine:
            _solo_equal(fields, survivor_kw)
            if shrink_after:
                [rc] = eng.classes()
                from mpi_cuda_process_tpu_torch.utils import launchcheck

                assert any(r["op"] == "shrink" for r in rc.repacks)
                for r in rc.repacks:
                    launchcheck.assert_member_repack_structure(
                        r["records"], r["plan"], r["n_fields"], r["grid"])
    want = (True, True, 0, 4) if shrink_after else (False, False, 0, 4)
    assert out[0] == out[1] == want
