"""``--groups`` through the port's CLI (ROADMAP A7) against the JAX
package's, on 8 virtual CPU devices.

* the conflicts: every ``_GROUP_CONFLICTS`` flag the port runs raises the
  JAX CLI's message (the observability flags ``--profile``,
  ``--profile-dir`` and ``--halo-audit`` among them); the A8 flags still
  in ``cli._UNPORTED`` (``--policy-recheck``, ``--kernel-variant``,
  ``--auto-policy``) stay refused by name whether or not ``--groups`` is
  given, and ``--telemetry`` / ``--health`` run on the groups (a
  ``group_chunk`` event and a HEALTHY record a group a chunk);
  ``--group-transport collective`` without ``--groups`` raises the
  JAX message; under a multi-process launcher ``--groups`` is refused by
  name (ROADMAP A7, groups across processes);
* the run loop: the heterogeneous demo end to end (the assembled base grid,
  Mcells/s from ``cell_updates_per_round``, the round log lines), and held
  to the JAX CLI's assembled fields (float32 ``atol = 1e-4``: the two
  packages' plain float32 steps differ in the last place);
  ``--check-finite`` names the group; the ``exchange`` fault site fires at
  the chunk boundary;
* coupled checkpoints (one ``group{i}`` directory a group, one agreed
  round): a resumed run equals the uninterrupted one bit for bit under
  both transports, and a checkpoint the JAX CLI wrote resumes in the port
  to the JAX CLI's own continuation;
* the memory guard prices the groups on one card before any field, and
  refuses with the arithmetic (``--mem-check warn`` logs and goes on).
"""

import logging
import os
import re

import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.config import RunConfig as JRunConfig

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.parallel import groups as tgroups
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.resilience import faults
from mpi_cuda_process_tpu_torch.utils import budget as tbudget

torch.set_num_threads(1)

HET_GROUPS = "wave3d:fine@0-3:z1/4:mesh1x4,heat3d:coarse@4-7:mesh1x4"
HET_GRID = (24, 16, 16)
SPLIT = dict(stencil="heat3d", grid=(30, 16, 16),
             groups="heat3d@0-3,heat3d@4-7")


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")


def _port(**kw):
    return RunConfig(**{"iters": 4, "device": "cpu", **SPLIT, **kw})


def _jax(**kw):
    return JRunConfig(**{"iters": 4, **SPLIT, **kw})


def _np(fields):
    return [f.float().numpy() if isinstance(f, torch.Tensor)
            else np.asarray(f, np.float32) for f in fields]


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("kw", [
    {"mesh": (2,)}, {"ensemble": 2}, {"ensemble_mesh": 2},
    {"ensemble_perturb": 0.1}, {"fuse": 4}, {"fuse_kind": "stream"},
    {"overlap": True}, {"pipeline": True}, {"exchange": "rdma"},
    {"periodic": True}, {"tol": 1e-3}, {"debug_checks": True},
    {"compute": "pallas"}, {"dump_every": 2},
], ids=lambda kw: next(iter(kw)))
def test_group_conflicts_raise_the_jax_message(kw):
    with pytest.raises(ValueError) as je:
        jcli.run(_jax(**kw))
    with pytest.raises(ValueError) as te:
        tcli.run(_port(**kw))
    assert str(te.value) == str(je.value)
    assert "does not compose with --groups" in str(te.value)


@pytest.mark.parametrize("kw", [
    {"profile": "trace"}, {"profile_dir": "d"}, {"halo_audit": 2},
    {"policy_recheck": 2}, {"kernel_variant": "v1"},
    {"telemetry": "t.jsonl"}, {"health": True}, {"auto_policy": True},
], ids=lambda kw: next(iter(kw)))
def test_a8_flags_stay_refused_with_groups(kw, tmp_path):
    field = next(iter(kw))
    if field in ("policy_recheck", "kernel_variant", "auto_policy"):
        for cfg in (_port(**kw), _port(groups="", **kw)):
            with pytest.raises(NotImplementedError, match="ROADMAP A8"):
                tcli.run(cfg)
        return
    if field in ("profile", "profile_dir", "halo_audit"):
        # chunk-scoped observers of one monolithic run: the JAX message
        with pytest.raises(ValueError) as je:
            jcli.run(_jax(**kw))
        with pytest.raises(ValueError) as te:
            tcli.run(_port(**kw))
        assert str(te.value) == str(je.value)
        return
    log = str(tmp_path / "g.jsonl")
    tcli.run(_port(**dict(kw, telemetry=log)))
    from mpi_cuda_process_tpu_torch.obs import trace as ttrace

    _, events = ttrace.validate_log(log)
    names = {p.name for p in tgroups.plans_from_config(
        SPLIT["groups"], SPLIT["grid"], n_devices=8)}
    assert {e["group"] for e in events if e["kind"] == "group_chunk"} \
        == names
    health = [e for e in events if e["kind"] == "health"]
    if field == "health":
        assert {e["group"] for e in health} == names
        assert all(e["verdict"] == "HEALTHY" for e in health)


def test_group_transport_without_groups_and_across_processes(monkeypatch):
    with pytest.raises(ValueError) as je:
        jcli.run(_jax(groups="", group_transport="collective"))
    with pytest.raises(ValueError) as te:
        tcli.run(_port(groups="", group_transport="collective"))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="built by build_coupled"):
        tcli.build(_port())
    # a multi-process launch: refused by name, never run on one process's
    # narrowed device set
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError,
                       match=r"groups across processes\)"):
        tcli.run(_port())
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(tmesh, "process_count", lambda: 2)
    item = re.escape(tgroups.PROCESSES_ITEM)
    with pytest.raises(NotImplementedError, match=item):
        tcli.run(_port())
    with pytest.raises(NotImplementedError, match=item):
        tgroups.CoupledRunner(tgroups.plans_from_config(
            SPLIT["groups"], SPLIT["grid"], n_devices=8), device="cpu")


# ------------------------------------------------------------ the loop

def test_hetero_demo_cli_end_to_end_matches_jax(caplog):
    caplog.set_level(logging.INFO, logger="mpi_cuda_process_tpu_torch")
    argv = ["--stencil", "wave3d", "--grid", "24,16,16", "--iters", "8",
            "--groups", HET_GROUPS, "--log-every", "2", "--device", "cpu"]
    fields, mcells = tcli.run(tcli.config_from_args(argv))
    assert tuple(fields[0].shape) == HET_GRID and mcells > 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("round 8  g0:wave3d:") and "g1:heat3d:" in m
               for m in msgs)
    assert any("8 coupled rounds x 2 groups" in m for m in msgs)
    assert any(m.startswith("group g0:wave3d: grid 13x32x32 on mesh 1x4")
               for m in msgs)
    ref, _ = jcli.run(JRunConfig(stencil="wave3d", grid=HET_GRID, iters=8,
                                 groups=HET_GROUPS))
    for g, r in zip(_np(fields), _np(ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    plans = tgroups.plans_from_config(HET_GROUPS, HET_GRID, n_devices=8)
    assert 8 * int(np.prod(HET_GRID)) >= 2 * sum(p.cells for p in plans)


def test_check_finite_names_the_group(monkeypatch):
    run = tgroups.CoupledRunner.run

    def poisoned(self, rounds, on_round=None):
        run(self, rounds, on_round)
        if self.round >= 4:
            self.fields[1][0][2][1, 1, 1] = float("nan")

    monkeypatch.setattr(tgroups.CoupledRunner, "run", poisoned)
    with pytest.raises(RuntimeError,
                       match=r"^group g1:heat3d field 0 became non-finite "
                             r"by step 4"):
        tcli.run(_port(iters=8, check_finite=2))
    monkeypatch.setattr(tgroups.CoupledRunner, "run", run)
    healthy, _ = tcli.run(_port(iters=8, check_finite=2))
    plain, _ = tcli.run(_port(iters=8))
    assert all(torch.equal(a, b) for a, b in zip(healthy, plain))


def test_exchange_fault_fires_at_the_chunk_boundary(monkeypatch):
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=4:raise")
    monkeypatch.setenv("FAULT_ATTEMPT", "0")
    faults.reset()
    try:
        with pytest.raises(faults.FaultInjected, match="exchange"):
            tcli.run(_port(iters=8, log_every=2))
    finally:
        monkeypatch.delenv("FAULT_INJECT")
        faults.reset()


# --------------------------------------------------------- checkpoints

@pytest.mark.parametrize("transport", ["device_put", "collective"])
def test_coupled_checkpoint_resume_bitmatch(tmp_path, transport):
    ck = str(tmp_path / "ckpt")
    base = dict(iters=8, group_transport=transport)
    full, _ = tcli.run(_port(**base))
    tcli.run(_port(**{**base, "iters": 4}, checkpoint_every=4,
                   checkpoint_dir=ck))
    assert sorted(os.listdir(ck)) == ["group0", "group1"]
    resumed, _ = tcli.run(_port(**base, checkpoint_dir=ck, resume=True))
    assert all(torch.equal(a, b) for a, b in zip(full, resumed))
    # at or past iters: the checkpoint's state, no round run
    again, mcells = tcli.run(_port(**{**base, "iters": 4},
                                   checkpoint_dir=ck, resume=True))
    assert mcells == 0.0


def test_jax_coupled_checkpoint_resumes_in_the_port(tmp_path):
    """Through both CLIs (float32: the JAX CLI cannot resume its own
    bfloat16 npy fields, which load as ``|V2``), and a mixed-precision
    checkpoint of the JAX runner into the port's runner, each held to the
    JAX package's continuation."""
    from mpi_cuda_process_tpu.parallel import groups as jgroups

    from mpi_cuda_process_tpu_torch import interop

    mixed = "heat3d:bf16@0-3:mesh2x2,heat3d@4-7:mesh1x4"
    jr = jgroups.CoupledRunner(jgroups.plans_from_config(
        mixed, SPLIT["grid"], n_devices=8))
    jr.run(3)
    jr.save_checkpoint(str(tmp_path / "mixed"))
    tr = tgroups.CoupledRunner(tgroups.plans_from_config(
        mixed, SPLIT["grid"], n_devices=8), device="cpu")
    assert tr.load_checkpoint(str(tmp_path / "mixed")) == 3
    for fs, jfs in zip(tr.fields, jr.fields):
        for a, b in zip(interop.gather_to_numpy(fs), jfs):
            assert a.tobytes() == np.asarray(b).tobytes()
    jr.run(3)
    tr.run(3)
    for g, r in zip(_np(tr.assemble()), _np(jr.assemble())):
        tol = 32 * 2.0 ** -7 * max(float(np.abs(r).max()), 1.0)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)
    spec = "heat3d@0-3:mesh2x2,heat3d@4-7:mesh1x4"
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.run(_jax(groups=spec, checkpoint_every=4, checkpoint_dir=jck))
    os.makedirs(tck)
    for g in ("group0", "group1"):
        os.symlink(os.path.join(jck, g), os.path.join(tck, g))
    got, _ = tcli.run(_port(groups=spec, iters=8, checkpoint_dir=tck,
                            resume=True))
    ref, _ = jcli.run(_jax(groups=spec, iters=8, checkpoint_dir=jck,
                           resume=True))
    for g, r in zip(_np(got), _np(ref)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


# --------------------------------------------------------- memory guard

def test_mem_guard_sums_the_groups_on_one_card(monkeypatch, caplog):
    plans = tgroups.plans_from_config(HET_GROUPS, HET_GRID, n_devices=8)
    card = torch.device("cuda", 0)
    seen = []
    real = tbudget.check_coupled_budget

    def spy(plans, hbm_bytes=None, transport="", devices=None):
        seen.append(devices)
        return real(plans, hbm_bytes=hbm, transport=transport,
                    devices=devices)

    monkeypatch.setattr(tbudget, "check_coupled_budget", spy)
    monkeypatch.setattr(tgroups.GroupPlan, "devices",
                        lambda self, kind="cuda": [card] *
                        self.spec.n_devices)
    total, _ = tbudget.estimate_coupled_bytes(
        plans, devices=[[card] * p.spec.n_devices for p in plans])
    hbm = total
    cfg = RunConfig(stencil="wave3d", grid=HET_GRID, groups=HET_GROUPS)
    tcli._check_coupled_mem_budget(cfg, plans, card)
    assert seen[-1] == [[card] * 4, [card] * 4]
    hbm = total - 1
    with pytest.raises(ValueError, match="the groups on one card need"):
        tcli._check_coupled_mem_budget(cfg, plans, card)
    caplog.set_level(logging.WARNING, logger="mpi_cuda_process_tpu_torch")
    tcli._check_coupled_mem_budget(
        RunConfig(groups=HET_GROUPS, mem_check="warn"), plans, card)
    assert any("--mem-check warn" in r.getMessage() for r in caplog.records)
    # skipped on the CPU and with --mem-check off
    n = len(seen)
    tcli._check_coupled_mem_budget(cfg, plans, torch.device("cpu"))
    tcli._check_coupled_mem_budget(
        RunConfig(groups=HET_GROUPS, mem_check="off"), plans, card)
    assert len(seen) == n
