"""The serving layer (``serving/``): the port's ``ServingEngine`` against
the JAX package's.

The same jobs (seeds from numpy) go to both engines on the CPU: each ends
the same way (done, cancelled, evicted DIVERGED, rejected with the same
reason), and a finished job's fields agree with JAX's at
``tests/test_torch_cli.py``'s tolerance (plain step ``32 eps max(|ref|,
1)`` a step, ``--fuse`` ``1e-4``, Life exact).  In the port every served
job is bit-equal to its own solo ``cli.run`` — through a grow, a shrink,
a preemption, an eviction beside it, and on a sharded class — and the
second job of a resident class builds nothing (no step, no runner, no
nvcc).  Admission prices with the port's own budget: where it and JAX's
fall on opposite sides of a threshold is pinned here (ROADMAP C).  The
CLI's ``--serve-engine`` / ``--serve-router`` run end to end and
``--compile-cache`` resolves the kernels' build directory.
"""

import glob
import json
import os
import time

import numpy as np
import pytest

from mpi_cuda_process_tpu import serving as jserving
from mpi_cuda_process_tpu.cancellation import RunCancelled as JCancelled
from mpi_cuda_process_tpu.config import RunConfig as JConfig
from mpi_cuda_process_tpu.obs.health import SimulationDiverged as JDiverged
from mpi_cuda_process_tpu.resilience import faults as jfaults
from mpi_cuda_process_tpu.serving import AdmissionController as JAdmission
from mpi_cuda_process_tpu.serving import class_config as jclass_config
from mpi_cuda_process_tpu.serving import class_signature as jclass_sig

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import serving
from mpi_cuda_process_tpu_torch.cancellation import RunCancelled
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.obs import metrics as metrics_lib
from mpi_cuda_process_tpu_torch.obs import runtime as runtime_lib
from mpi_cuda_process_tpu_torch.obs.health import SimulationDiverged
from mpi_cuda_process_tpu_torch.ops.cuda import _build
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.resilience import faults
from mpi_cuda_process_tpu_torch.serving import (AdmissionController,
                                                AdmissionError, class_config,
                                                class_signature)
from mpi_cuda_process_tpu_torch.utils import launchcheck

EPS32 = float(np.finfo(np.float32).eps)
SEEDS = np.random.default_rng(2027).integers(0, 2**16, size=8).tolist()


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _events(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _host(fields):
    if tstepper.is_sharded(fields):
        fields = tstepper.gather_fields(fields, device="cpu")
    return tuple(f.cpu().numpy() for f in fields)


def _assert_solo_bit_equal(got, cfg):
    want, _ = tcli.run(cfg)
    for a, b in zip(_host(got), _host(want)):
        np.testing.assert_array_equal(a, b)


def _assert_near_jax(got, jgot, kw):
    for t, j in zip(_host(got), (np.asarray(f) for f in jgot)):
        assert t.shape == j.shape
        if kw.get("stencil") == "life":
            np.testing.assert_array_equal(t, j)
            continue
        atol = 1e-4 if kw.get("fuse") else \
            32 * EPS32 * max(float(np.abs(j).max()), 1.0) * kw["iters"]
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)


def _engines(tmp_path, **kw):
    return (jserving.ServingEngine(telemetry_dir=str(tmp_path / "jax"),
                                   **kw),
            serving.ServingEngine(telemetry_dir=str(tmp_path / "pt"), **kw))


def _wait(cond, timeout=120):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


# ------------------------------------------------------------ classes

def test_class_identity_matches_jax():
    """Per-job fields never split a class, class fields always do, in
    both packages; the port's class fields are JAX's plus ``device``."""
    assert serving.CLASS_FIELDS == jserving.CLASS_FIELDS | {"device"}
    assert serving.PER_JOB_SIM_FIELDS == jserving.PER_JOB_SIM_FIELDS
    a = dict(stencil="heat2d", grid=(16, 16), iters=8, seed=0)
    b = dict(stencil="heat2d", grid=(16, 16), iters=640, seed=9,
             density=0.5, init="pulse", telemetry="/tmp/x.jsonl")
    for sig, make in ((class_signature, RunConfig), (jclass_sig, JConfig)):
        assert sig(make(**a)) == sig(make(**b))
        for variant in (dict(grid=(16, 32)), dict(stencil="life"),
                        dict(dtype="bfloat16"), dict(periodic=True),
                        dict(fuse=2)):
            assert sig(make(**{**a, **variant})) != sig(make(**a))
    assert class_signature(RunConfig(**a)) != class_signature(
        RunConfig(device="cpu", **a))
    j = dict(stencil="heat2d", grid=(16, 16), iters=640, seed=9,
             density=0.5, supervise=True, telemetry="/tmp/x.jsonl")
    tc, jc = class_config(RunConfig(**j), 4), jclass_config(JConfig(**j), 4)
    for f in ("ensemble", "grid", "stencil", "seed", "density", "iters",
              "supervise", "telemetry"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.ensemble == 4 and not tc.supervise and tc.telemetry is None


# ---------------------------------------------------------- admission

ADMIT = [
    # (config, capacity, hbm_bytes): both packages decide alike
    (dict(stencil="heat2d", grid=(256, 256)), 8, 10_000),
    (dict(stencil="heat2d", grid=(256, 256)), 8, 2 * 10**7),
    (dict(stencil="heat3d", grid=(256, 256, 256), fuse=4,
          fuse_kind="stream"), 8, 10**9),
    (dict(stencil="heat3d", grid=(256, 256, 256), fuse=4,
          fuse_kind="stream"), 8, 2 * 10**9),
    (dict(stencil="heat3d", grid=(4096, 2048, 2048), fuse=4,
          fuse_kind="stream"), 1, 85 * 10**9),
]


@pytest.mark.parametrize("kw,cap,hbm", ADMIT, ids=[
    "heat2d-tiny-budget", "heat2d-fits", "k10-over", "k10-fits",
    "over-budget-class"])
def test_admission_decides_like_jax(kw, cap, hbm):
    decisions = []
    for ctl, cfg in ((JAdmission(hbm_bytes=hbm),
                      jclass_config(JConfig(**kw), cap)),
                     (AdmissionController(hbm_bytes=hbm),
                      class_config(RunConfig(device="cpu", **kw), cap))):
        try:
            est = ctl.admit_or_raise(cfg)
            decisions.append(("admit", est["total_bytes"] <= hbm))
        except Exception as e:  # noqa: BLE001 — compared below
            decisions.append((e.reason, "GiB" in str(e),
                              e.detail["total_bytes"] > e.detail[
                                  "hbm_bytes"] == hbm, "parts" in e.detail))
    assert decisions[0] == decisions[1]


def test_admission_difference_by_design():
    """ROADMAP C: the port's budget prices its own paths.  heat3d 1024^3 on
    the plain path at capacity 1: JAX 14,201,128,585 bytes, the port
    20,106,708,617 (its pad, update and re-pin transients); against a
    16 GiB budget JAX admits and the port refuses.  Without an explicit
    budget a CPU class is priced as the H100 (80 GB), JAX's CPU backend
    as 16 GiB."""
    kw = dict(stencil="heat3d", grid=(1024, 1024, 1024))
    j = JAdmission().price(jclass_config(JConfig(**kw), 1))
    t = AdmissionController().price(class_config(
        RunConfig(device="cpu", **kw), 1))
    assert (j["total_bytes"], t["total_bytes"]) == (14201128585,
                                                    20106708617)
    assert (j["hbm_bytes"], t["hbm_bytes"]) == (16 * 2**30, 80 * 10**9)
    JAdmission(hbm_bytes=16 * 2**30).admit_or_raise(
        jclass_config(JConfig(**kw), 1))
    with pytest.raises(AdmissionError):
        AdmissionController(hbm_bytes=16 * 2**30).admit_or_raise(
            class_config(RunConfig(device="cpu", **kw), 1))


def _price(grid, cap=1):
    return AdmissionController().price(class_config(RunConfig(
        device="cpu", stencil="heat2d", grid=grid, iters=8), cap))[
            "total_bytes"]


def test_admission_holds_resident_classes():
    """A class admitted under a holder key holds its bytes: a second class
    that fits alone but not beside it is refused with the bytes held; the
    holder's own re-pricing excludes its own bytes; a release frees them;
    ``share`` splits the budget."""
    big, small = _price((64, 64)), _price((32, 32))
    ctl = AdmissionController(hbm_bytes=big + small - 1)
    cfg = lambda g, cap=1: class_config(RunConfig(  # noqa: E731
        device="cpu", stencil="heat2d", grid=g, iters=8), cap)
    assert ctl.admit_or_raise(cfg((64, 64)), holder="x")["held_bytes"] == 0
    with pytest.raises(AdmissionError) as ei:
        ctl.admit_or_raise(cfg((32, 32)), holder="y")
    assert ei.value.reason == "over_budget"
    assert ei.value.detail["held_bytes"] == big
    assert "resident classes hold" in str(ei.value)
    assert ctl.admit_or_raise(cfg((64, 64)), holder="x")["held_bytes"] == 0
    ctl.release("x")
    assert ctl.admit_or_raise(cfg((32, 32)), holder="y")["held_bytes"] == 0
    ctl.hold("y", cfg((16, 16)))
    assert ctl.admit_or_raise(cfg((64, 64)))["held_bytes"] == _price(
        (16, 16))
    half = AdmissionController(hbm_bytes=2 * big, share=2)
    assert half.price(cfg((64, 64)))["hbm_bytes"] == big
    assert AdmissionController(share=4).price(cfg((16, 16)))[
        "hbm_bytes"] == serving.admission.CPU_PRICED_HBM_BYTES // 4


def test_resident_classes_are_priced_together(tmp_path):
    """One engine: a new class is refused when it fits the budget alone
    but not beside the class already resident, and a class does not grow
    into the bytes another resident class holds (its jobs run one after
    the other at capacity 1, each bit-equal to its solo run)."""
    big, small, tiny = _price((64, 64)), _price((32, 32)), _price((16, 16))
    eng = serving.ServingEngine(telemetry_dir=str(tmp_path / "a"),
                                ladder=(1,), cadence=8,
                                hbm_bytes=big + small - 1)
    base = dict(stencil="heat2d", iters=8, device="cpu")
    eng.submit(RunConfig(grid=(64, 64), seed=1, **base)).result(timeout=300)
    with pytest.raises(AdmissionError) as ei:
        eng.submit(RunConfig(grid=(32, 32), seed=2, **base))
    assert ei.value.reason == "over_budget"
    assert ei.value.detail["held_bytes"] == big
    eng.submit(RunConfig(grid=(16, 16), seed=3, **base)).result(timeout=300)
    stats = eng.close()
    assert (stats["jobs_done"], stats["rejects"]) == (2, 1)

    grown = _price((32, 32), 2)
    eng = serving.ServingEngine(telemetry_dir=str(tmp_path / "b"),
                                ladder=(1, 2), cadence=8,
                                hbm_bytes=grown + tiny - 1)
    eng.submit(RunConfig(grid=(16, 16), seed=4, **base)).result(timeout=300)
    kws = [dict(grid=(32, 32), seed=s, **base) for s in (5, 6)]
    hs = [eng.submit(RunConfig(**kw)) for kw in kws]
    for h, kw in zip(hs, kws):
        got, _ = h.result(timeout=300)
        _assert_solo_bit_equal(got, RunConfig(**kw))
    rc = next(c for c in eng.classes() if tuple(c.template.grid) == (32, 32))
    assert (rc.capacity, rc.builds, rc.repacks) == (1, 1, [])
    stats = eng.close()
    assert stats["jobs_done"] == 3

def test_rejects_match_jax(tmp_path):
    """Over-budget and unsupported jobs are refused with the same reason
    and the same ``reject`` event; a policy flag raises by its item."""
    jeng, teng = _engines(tmp_path, hbm_bytes=10_000)
    bad = [dict(grid=(256, 256), iters=8), dict(supervise=True),
           dict(tol=1e-6), dict(ensemble=4), dict(resume=True),
           dict(profile="/tmp/p"), dict(iters=0), dict(fuse=2, iters=9)]
    for kw in bad:
        kw = {**dict(stencil="heat2d", grid=(16, 16), iters=8), **kw}
        reasons = []
        for eng, make in ((jeng, JConfig),
                          (teng, lambda **k: RunConfig(device="cpu", **k))):
            with pytest.raises(Exception) as ei:
                eng.submit(make(**kw), tenant="t")
            reasons.append(ei.value.reason)
        assert reasons[0] == reasons[1], kw
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        teng.submit(RunConfig(stencil="heat2d", grid=(16, 16), iters=8,
                              device="cpu", auto_policy=True))
    for eng in (jeng, teng):
        stats = eng.close()
        assert stats["rejects"] == len(bad) and stats["jobs_submitted"] == 0
        rejects = [e for e in _events(eng.telemetry_path)
                   if e.get("op") == "reject"]
        assert len(rejects) == len(bad)
        assert rejects[0]["reason"] == "over_budget"


# ------------------------------------------------ results / isolation

def test_jobs_match_jax_and_their_solo_runs(tmp_path):
    """Batched together, each job equals its solo run (port, bit for bit)
    and JAX's served job (CLI tolerance), plain, ``--fuse`` and Life."""
    jobs = [dict(stencil="heat2d", grid=(16, 16), iters=16, seed=s)
            for s in SEEDS[:3]]
    jobs += [dict(stencil="heat2d", grid=(32, 128), iters=16, fuse=8,
                  seed=SEEDS[3]),
             dict(stencil="life", grid=(16, 32), iters=16, seed=SEEDS[4])]
    jeng, teng = _engines(tmp_path, ladder=(4,), cadence=8)
    jh = [jeng.submit(JConfig(**kw), tenant=f"t{i}")
          for i, kw in enumerate(jobs)]
    th = [teng.submit(RunConfig(device="cpu", **kw), tenant=f"t{i}")
          for i, kw in enumerate(jobs)]
    for kw, a, b in zip(jobs, jh, th):
        jf, _ = a.result(timeout=300)
        tf, _ = b.result(timeout=300)
        assert a._phase() == b._phase() == "done"
        _assert_near_jax(tf, jf, kw)
        _assert_solo_bit_equal(tf, RunConfig(device="cpu", **kw))
    for eng in (jeng, teng):
        stats = eng.close()
        assert stats["jobs_done"] == 5 and len(stats["class_table"]) == 3


def test_diverged_slot_evicted_in_both(tmp_path, monkeypatch):
    """The numerics fault poisons one member slot: that job ends DIVERGED
    with a real health record, its co-tenant finishes (bit-equal to its
    solo run), in both packages."""
    monkeypatch.setenv("FAULT_INJECT", "numerics:step=4:nan")
    base = dict(stencil="heat2d", grid=(16, 16), iters=16)
    jeng, teng = _engines(tmp_path, ladder=(2,), cadence=8)
    out = []
    for eng, make, div in ((jeng, JConfig, JDiverged),
                           (teng, lambda **k: RunConfig(device="cpu", **k),
                            SimulationDiverged)):
        victim = eng.submit(make(seed=1, **base), tenant="victim")
        survivor = eng.submit(make(seed=2, **base), tenant="survivor")
        got, _ = survivor.result(timeout=300)
        with pytest.raises(div):
            victim.result(timeout=300)
        stats = eng.close()
        evs = [e for e in _events(eng.telemetry_path)
               if e.get("op") == "evict"]
        out.append((victim._phase(), victim.health_verdict(),
                    victim.status()["verdict"], stats["jobs_evicted"],
                    stats["jobs_done"], [e["tenant"] for e in evs]))
    assert out[0] == out[1] == ("evicted", "DIVERGED", "DIVERGED", 1, 1,
                                ["victim"])
    faults.reset()
    monkeypatch.delenv("FAULT_INJECT")
    _assert_solo_bit_equal(got, RunConfig(device="cpu", seed=2, **base))


def test_preemption_resumes_bit_exact_in_both(tmp_path):
    """A higher-priority arrival preempts the running low-priority job
    through an ``npy`` checkpoint; the victim resumes and still equals
    its solo run."""
    low_kw = dict(stencil="heat2d", grid=(64, 64), iters=2048,
                  seed=SEEDS[5])
    high_kw = dict(stencil="heat2d", grid=(64, 64), iters=8, seed=SEEDS[6])
    jeng, teng = _engines(tmp_path, ladder=(1,), cadence=8)
    res = []
    for eng, make in ((jeng, JConfig),
                      (teng, lambda **k: RunConfig(device="cpu", **k))):
        low = eng.submit(make(**low_kw), tenant="low", priority=0)
        assert _wait(lambda: low.steps_done > 0)
        high = eng.submit(make(**high_kw), tenant="high", priority=5)
        high.result(timeout=300)
        got, _ = low.result(timeout=600)
        stats = eng.close()
        assert stats["preemptions"] >= 1 and low.preempt_count >= 1
        assert high.finished_at < low.finished_at
        res.append(got)
    _assert_near_jax(res[1], res[0], low_kw)
    _assert_solo_bit_equal(res[1], RunConfig(device="cpu", **low_kw))


def test_starvation_bound_serves_the_low_priority_job(tmp_path):
    base = dict(stencil="heat2d", grid=(16, 16), iters=8)
    teng = serving.ServingEngine(telemetry_dir=str(tmp_path), ladder=(1,),
                                 cadence=8, starvation_rounds=3)
    low = teng.submit(RunConfig(seed=0, device="cpu", **base), tenant="low",
                      priority=0)
    highs = [teng.submit(RunConfig(seed=10 + i, device="cpu", **base),
                         tenant="high", priority=5) for i in range(6)]
    low.result(timeout=300)
    for h in highs:
        h.result(timeout=300)
    assert teng.close()["jobs_done"] == 7
    assert low.finished_at < max(h.finished_at for h in highs)


def test_cancel_queued_and_running_in_both(tmp_path):
    jeng, teng = _engines(tmp_path, ladder=(1,), cadence=8,
                          starvation_rounds=10**9)
    out = []
    for eng, make, exc in ((jeng, JConfig, JCancelled),
                           (teng, lambda **k: RunConfig(device="cpu", **k),
                            RunCancelled)):
        running = eng.submit(make(stencil="heat2d", grid=(64, 64),
                                  iters=65536), tenant="a")
        queued = eng.submit(make(stencil="heat2d", grid=(64, 64), iters=8,
                                 seed=2), tenant="b", priority=0)
        assert _wait(lambda: running.steps_done > 0)
        assert queued.cancel() and running.cancel()
        for h in (queued, running):
            h.wait(120)
            with pytest.raises(exc):
                h.result(timeout=1)
            kinds = [e.get("kind") for e in _events(h.telemetry_path)]
            assert "cancelled" in kinds and "error" not in kinds
        stats = eng.close()
        out.append((queued._phase(), running._phase(),
                    queued._error.step, running._error.step > 0,
                    stats["jobs_cancelled"], stats["jobs_done"]))
    assert out[0] == out[1] == ("cancelled", "cancelled", 0, True, 2, 0)


# ---------------------------------------------- residency / no builds

def test_second_job_of_a_resident_class_builds_nothing(tmp_path):
    """The first job of a class builds its step and runners; the next job
    of the class rides them: no step, no runner, no nvcc."""
    eng = serving.ServingEngine(telemetry_dir=str(tmp_path), ladder=(2,),
                                cadence=8)
    base = dict(stencil="heat2d", grid=(16, 48), iters=8, device="cpu")
    before = runtime_lib.compiles_seen()
    eng.submit(RunConfig(seed=1, **base), tenant="a").result(timeout=300)
    after = runtime_lib.compiles_seen()
    assert after["build"] > before["build"]
    assert after["runner"] > before["runner"]
    counts = eng.compile_counts()
    eng.submit(RunConfig(seed=2, density=0.4, **base),
               tenant="b").result(timeout=300)
    assert runtime_lib.compiles_seen() == after
    assert eng.compile_counts() == counts == {"builds": 1, "runners": 1}
    stats = eng.close()
    assert stats["jobs_done"] == 2 and len(stats["class_table"]) == 1


def test_grow_and_shrink_on_a_sharded_class(tmp_path, monkeypatch):
    """A class on a 2x2 mesh of virtual shards (the K10 stream kind's
    plain version): the ladder grows 1 -> 2 and shrinks back, each repack
    recorded and held to the structure check, every job bit-equal to its
    solo run on the same mesh."""
    monkeypatch.setenv("MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES", "4")
    base = dict(stencil="heat3d", grid=(48, 32, 128), mesh=(2, 2), fuse=4,
                fuse_kind="stream", init="pulse", device="cpu")
    eng = serving.ServingEngine(telemetry_dir=str(tmp_path), ladder=(1, 2),
                                cadence=8, shrink_after_rounds=2)
    long_cfg = RunConfig(iters=96, **base)
    short_cfg = RunConfig(iters=16, **base)
    long_job = eng.submit(long_cfg, tenant="long")
    assert _wait(lambda: long_job.steps_done > 0)
    short = eng.submit(short_cfg, tenant="short")
    got_short, _ = short.result(timeout=300)
    got_long, _ = long_job.result(timeout=300)
    stats = eng.close()
    assert stats["grows"] == 1 and stats["shrinks"] >= 1
    [rc] = eng.classes()
    assert [r["op"] for r in rc.repacks][:2] == ["grow", "shrink"]
    for r in rc.repacks:
        launchcheck.assert_member_repack_structure(
            r["records"], r["plan"], r["n_fields"], r["grid"])
    assert tstepper.is_sharded(got_long)
    _assert_solo_bit_equal(got_short, short_cfg)
    _assert_solo_bit_equal(got_long, long_cfg)


def test_scheduler_events_fold_into_status(tmp_path):
    eng = serving.ServingEngine(telemetry_dir=str(tmp_path), ladder=(1, 2),
                                cadence=8)
    eng.submit(RunConfig(stencil="heat2d", grid=(16, 16), iters=8,
                         device="cpu"), tenant="t0").result(timeout=300)
    eng.close()
    rm = metrics_lib.RunMetrics()
    for rec in _events(eng.telemetry_path):
        rm.ingest(rec)
    sched = rm.status()["scheduler"]
    assert sched["counts"]["submit"] == 1 and sched["counts"]["retire"] == 1
    assert sched["tenants"]["t0"]["join"] == 1
    assert sched["queue_depth"] == 0
    prom = rm.registry.to_prometheus()
    assert "obs_sched_submit_total" in prom
    assert "obs_sched_tenant_ops" in prom
    summary = [e for e in _events(eng.telemetry_path)
               if e.get("kind") == "summary"][-1]
    assert summary["jobs_done"] == 1 and summary["ttfc_p50_s"] is not None


# ----------------------------------------------------------------- CLI

@pytest.mark.parametrize("flag", ["--serve-engine", "--serve-router"])
def test_cli_serves_a_job_end_to_end(tmp_path, monkeypatch, capsys, flag):
    """``--serve-engine 0`` / ``--serve-router 0`` run the command line as
    a served job on the CPU, console up and down again; ``--compile-cache
    DIR`` points the kernels' build directory at DIR."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cache = tmp_path / "kernels"
    argv = ["--stencil", "heat2d", "--grid", "16,16", "--iters", "8",
            "--device", "cpu", "--telemetry", str(tmp_path / "t" / "run.jsonl"),
            flag, "0", "--compile-cache", str(cache)]
    if flag == "--serve-router":
        argv += ["--router-replicas", "2"]
    cfg = tcli.config_from_args(argv)
    assert cfg.compile_cache == str(cache)
    assert tcli.main(argv) == 0
    assert _build.BUILD_DIR == cache.resolve()
    out = capsys.readouterr().out
    tag = flag.lstrip("-")
    assert f"[{tag}]" in out and "http://127.0.0.1:" in out
    assert "served 1 job(s)" in out
    logs = glob.glob(str(tmp_path / "t" / "serv*.jsonl"))
    assert logs
    kinds = [e.get("op") for p in logs for e in _events(p)
             if e.get("kind") == "scheduler"]
    assert "retire" in kinds


def test_compile_cache_second_process_runs_no_nvcc(tmp_path, monkeypatch):
    """Pointing the cache at DIR copies the libraries built so far; a
    second process pointed at DIR finds every source built: its
    ``build_all`` needs no nvcc (none is on this machine's PATH, so a
    stale source would raise) and counts no nvcc run."""
    import subprocess
    import sys

    old = tmp_path / "old"
    old.mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", old.resolve())
    for n in _build.SOURCES:
        _build._lib_path(n).write_bytes(b"built")
    cache = tmp_path / "cache"
    assert tcli.enable_compile_cache(str(cache))
    assert _build.BUILD_DIR == cache.resolve()
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        p.name for p in old.iterdir())
    # the second process's default cache is empty: nothing can be copied
    # into DIR, so it finds there only what the first process put there
    got = subprocess.run(
        [sys.executable, "-c",
         "import sys; from pathlib import Path; "
         "from mpi_cuda_process_tpu_torch.ops.cuda import _build; "
         "_build.BUILD_DIR = Path(sys.argv[2]); "
         "_build.set_build_dir(sys.argv[1]); _build.build_all(); "
         "print(_build.compiles['nvcc'])", str(cache),
         str(tmp_path / "empty")],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert got.returncode == 0, got.stderr
    assert got.stdout.split()[-1] == "0"


def test_compile_counts_survive_concurrent_classes(monkeypatch):
    """Class threads build concurrently: the compile counter's
    read-modify-write is locked, so no increment is lost under a short
    switch interval and more threads than cores."""
    import sys
    import threading

    monkeypatch.setattr(_build, "compiles", _build.compiles.copy())
    before = _build.compiles["runner"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.note_compile("runner")
                            for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.compiles["runner"] - before == 2000 * len(threads)


def test_serving_flags_are_refused_under_torchrun(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    for flag in ("--serve-engine", "--serve-router"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A8 \\(serving\\)"):
            tcli.main([flag, "0", "--device", "cpu"])
    assert os.environ["WORLD_SIZE"] == "2"
