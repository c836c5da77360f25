"""``--ensemble``, ``--ensemble-mesh`` and ``--ensemble-perturb`` through
the CLI: the port's batched runs against its own single runs and the JAX
CLI, on the CPU.

Every run of tests/test_ensemble_engine.py:308-369 goes through the port's
``cli.run`` (``device="cpu"``, its meshes on virtual shards) with each
member held bit for bit to the port's single run from seed + i, and the
whole batch to the JAX CLI's batched run at the port's usual tolerances
(Life exact, float32 kernel paths ``atol = 1e-4``, the plain step ``32 eps
max(|ref|, 1)`` a step); the refusals of :268-305 are refused alike.  Two
processes under gloo run ``--ensemble 4 --ensemble-mesh 2`` and
``--ensemble 2 --mesh 2``, each bit-equal to its one-process run (their
final sharded checkpoints, read back); a batched checkpoint resumes onto
another mesh and process count, and the JAX CLI's ``npy`` checkpoint of an
ensemble run resumes in the port.  ``--tol``, ``--debug-checks``,
``--check-finite`` and ``--dump-every`` run with ``--ensemble`` or are
refused as the JAX CLI runs or refuses them, and the log line is the JAX
CLI's.
"""

import dataclasses
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax.experimental import checkify

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.config import RunConfig as JRunConfig
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
TIMEOUT = 120  # seconds, each subprocess


def _whole(fields):
    if tstepper.is_sharded(fields):
        fields = tstepper.gather_fields(fields, device="cpu")
    return [f.detach().cpu() for f in fields]


def _run_port(monkeypatch, **kw):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    fields, mcells = tcli.run(RunConfig(device="cpu", **kw))
    return _whole(fields)


def _run_jax(**kw):
    fields, _ = jcli.run(JRunConfig(**kw))
    return [np.asarray(f) for f in fields]


def _atol(kw, ref):
    """The port's tolerance against the JAX CLI for run ``kw``."""
    if kw["stencil"] == "life":
        return 0.0
    if kw.get("fuse"):
        return 1e-4
    return 32 * EPS32 * max(float(np.abs(ref).max()), 1.0) * kw["iters"]


CLI_RUNS = [
    ("life_mesh", dict(stencil="life", grid=(16, 16), iters=5, seed=4),
     dict(ensemble=3, mesh=(2, 1))),
    ("heat3d_third_axis", dict(stencil="heat3d", grid=(32, 16, 128),
                               iters=4, seed=1),
     dict(ensemble=4, ensemble_mesh=2, mesh=(2, 2, 1))),
    ("life_data_parallel", dict(stencil="life", grid=(16, 16), iters=5,
                                seed=4),
     dict(ensemble=4, ensemble_mesh=2)),
    ("heat3d_stream", dict(stencil="heat3d", grid=(96, 32, 128), iters=8,
                           seed=2, fuse=4, fuse_kind="stream"),
     dict(ensemble=2)),
    ("heat3d_padfree_overlap_pipeline",
     dict(stencil="heat3d", grid=(32, 16, 128), iters=8, seed=3, fuse=4,
          fuse_kind="padfree", mesh=(2, 1, 1), overlap=True,
          pipeline=True), dict(ensemble=2)),
]


@pytest.mark.parametrize("label,base,ens", CLI_RUNS,
                         ids=[c[0] for c in CLI_RUNS])
def test_cli_ensemble_run_is_its_members(monkeypatch, label, base, ens):
    """Each member of the batched run equals the single run of seed + i
    bit for bit, and the batch the JAX CLI's batched run."""
    got = _run_port(monkeypatch, **base, **ens)
    n = ens["ensemble"]
    assert got[0].shape == (n,) + base["grid"]
    for i in range(n):
        solo = _run_port(monkeypatch, **dict(base, seed=base["seed"] + i))
        for g, s in zip(got, solo):
            assert torch.equal(g[i], s)
    ref = _run_jax(**base, **ens)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=0,
                                   atol=_atol(base, r))


@pytest.mark.parametrize("extra", [
    dict(compute="pallas", mesh=(2, 2)), dict(compute="pallas"),
    dict(fuse=4), dict(fuse=4, mesh=(2, 2), fuse_kind="stream",
                       exchange="rdma", overlap=True)],
    ids=["k4_mesh", "plain_unsharded", "k3", "k10_rdma_overlap"])
def test_cli_ensemble_3d_paths(monkeypatch, extra):
    """The batched 3D paths of phase 5h at small size, with
    ``--ensemble-perturb``: K4 under ``--mesh``, K4 unsharded (under
    ``--ensemble`` ``--compute pallas`` takes the compute_fn kernel, not
    the raw one, in both packages), K3, and K10 with the ring (on a grid
    the JAX CLI's stream chunking takes)."""
    rdma = extra.get("exchange") == "rdma"
    base = dict(stencil="heat3d", grid=(48, 64, 128) if rdma else
                (32, 32, 64), iters=4 if rdma else 8, seed=5, init="pulse",
                **extra)
    got = _run_port(monkeypatch, **base, ensemble=2, ensemble_perturb=0.01)
    plain = _run_port(monkeypatch, **base, ensemble=2)
    assert not torch.equal(got[0], plain[0])
    ref = _run_jax(**base, ensemble=2, ensemble_perturb=0.01)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=_atol(base, r))


def test_cli_wave_k5_and_k7_life_k8_heat2d(monkeypatch):
    """K5 (wave3d ``--mesh 2,2 --compute pallas``), K7 (Life ``--compute
    pallas``) and K8 (heat2d ``--fuse 8``) batched, against the JAX CLI."""
    for base in (dict(stencil="wave3d", grid=(16, 16, 32), iters=4,
                      init="pulse", compute="pallas", mesh=(2, 2)),
                 dict(stencil="life", grid=(32, 128), iters=8, seed=3,
                      compute="pallas"),
                 dict(stencil="heat2d", grid=(32, 128), iters=16, fuse=8)):
        got = _run_port(monkeypatch, **base, ensemble=3)
        ref = _run_jax(**base, ensemble=3)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(r, np.float32), rtol=0,
                                       atol=_atol(base, r))


# ---- refusals ----------------------------------------------------------------

REFUSALS = [
    ("periodic_stream", dict(fuse=4, fuse_kind="stream", periodic=True,
                             ensemble=2), "guard-frame", False),
    ("mesh_without_ensemble", dict(ensemble_mesh=2), "needs --ensemble",
     True),
    ("not_divisible", dict(ensemble=3, ensemble_mesh=2), "divisible", True),
    ("perturb_without_ensemble", dict(ensemble_perturb=0.1), "perturb",
     True),
]


@pytest.mark.parametrize("label,kw,match,same", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_refused_alike(monkeypatch, label, kw, match, same):
    """tests/test_ensemble_engine.py:268-292 through both CLIs' build:
    the same reason (the ensemble checks: the same message)."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    base = dict(stencil="heat3d", grid=(96, 32, 128), iters=8)
    with pytest.raises(ValueError, match=match) as te:
        tcli.build(RunConfig(**base, **kw, device="cpu"))
    with pytest.raises(ValueError, match=match) as je:
        jcli.build(JRunConfig(**base, **kw))
    if same:
        assert str(te.value) == str(je.value)


def test_flags_parse_as_the_jax_cli():
    argv = ["--stencil", "heat3d", "--grid", "16,16,32", "--ensemble", "4",
            "--ensemble-mesh", "2", "--ensemble-perturb", "0.01"]
    t = tcli.config_from_args(argv)
    j = jcli.config_from_args(argv)
    assert (t.ensemble, t.ensemble_mesh, t.ensemble_perturb) == \
        (j.ensemble, j.ensemble_mesh, j.ensemble_perturb) == (4, 2, 0.01)
    helps = {a.dest: a.help for a in tcli.build_parser()._actions}
    jhelps = {a.dest: a.help for a in jcli.build_parser()._actions}
    for dest in ("ensemble", "ensemble_mesh", "ensemble_perturb"):
        assert helps[dest] == jhelps[dest]


def test_uses_mesh_and_auto_refuse_as_the_jax_cli():
    """``--ensemble-mesh`` decomposes (a pure data-parallel ensemble);
    ``--compute auto`` takes no temporal blocking and no raw kernel under
    ``--ensemble`` (the TPU package's ``maybe_auto_fuse``/``_raw_eligible``
    guards)."""
    cfg = RunConfig(stencil="heat3d", grid=(64,) * 3, ensemble=2,
                    ensemble_mesh=2, device="cuda")
    assert tcli._uses_mesh(cfg) and jcli._uses_mesh(JRunConfig(
        stencil="heat3d", grid=(64,) * 3, ensemble=2, ensemble_mesh=2))
    st = tcli._make_cfg_stencil(cfg)
    single = RunConfig(stencil="heat3d", grid=(64,) * 3, device="cuda")
    assert tcli._raw_eligible(single, st)
    assert not tcli._raw_eligible(
        RunConfig(stencil="heat3d", grid=(64,) * 3, ensemble=2,
                  device="cuda"), st)
    sor = RunConfig(stencil="sor3d", grid=(64,) * 3, iters=8, device="cuda")
    assert tcli.maybe_auto_fuse(sor).fuse == 2
    assert tcli.maybe_auto_fuse(RunConfig(
        stencil="sor3d", grid=(64,) * 3, iters=8, ensemble=2,
        device="cuda")).fuse == 0


# ---- the sanitizers, --tol, dumps and the log line ---------------------------


def _message(fn):
    """The error a run raises; JAX's checkify appends its own suffix."""
    with pytest.raises((RuntimeError, checkify.JaxRuntimeError)) as ei:
        fn()
    return str(ei.value).removesuffix(" (`check` failed)")


@pytest.mark.parametrize("flag", ["check_finite", "debug_checks"])
def test_sanitizers_name_the_same_step(monkeypatch, flag):
    """A batched blow-up raises the same message in both CLIs (the first
    failing step over every member)."""
    on = {"check_finite": 3, "log_every": 1} if flag == "check_finite" \
        else {"debug_checks": True}
    kw = dict(stencil="heat2d", grid=(16, 16), iters=10, ensemble=2,
              params={"alpha": 1e9}, **on)
    want = _message(lambda: _run_jax(**kw))
    assert "non-finite" in want
    assert _message(lambda: _run_port(monkeypatch, **kw)) == want


def test_tol_with_ensemble_converges_alike(monkeypatch):
    kw = dict(stencil="sor3d", grid=(16, 16, 32), iters=400, tol=1e-2,
              tol_check_every=8, ensemble=2)
    got = _run_port(monkeypatch, **kw)
    ref = _run_jax(**kw)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=2e-4)


def test_dumps_with_ensemble(monkeypatch, tmp_path):
    """``--dump-every`` writes the batched field 0 under the JAX CLI's
    names; Life's bytes equal, CLI to CLI."""
    kw = dict(stencil="life", grid=(16, 16), iters=4, seed=2, ensemble=3,
              dump_every=2)
    _run_port(monkeypatch, **kw, dump_dir=str(tmp_path / "pt"))
    _run_jax(**kw, dump_dir=str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "pt")) and names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "pt" / name),
                                      np.load(tmp_path / "jax" / name))
        assert np.load(tmp_path / "pt" / name).shape == (3, 16, 16)


def test_log_line_is_the_jax_clis(monkeypatch, caplog):
    """The log line of a batched run: over every member, as the JAX CLI's
    reductions run over the batched field (Life's population exactly; the
    float metrics to the printed digits)."""
    for stencil, extra in (("life", dict(seed=3)),
                           ("heat3d", dict(init="pulse"))):
        kw = dict(stencil=stencil, grid=(16, 16) if stencil == "life"
                  else (16, 16, 32), iters=4, log_every=2, ensemble=3,
                  **extra)
        lines = {}
        for who, run in (("pt", lambda: _run_port(monkeypatch, **kw)),
                         ("jax", lambda: _run_jax(**kw))):
            caplog.clear()
            with caplog.at_level(logging.INFO):
                run()
            lines[who] = [r.getMessage() for r in caplog.records
                          if r.getMessage().startswith("step ")]
        assert len(lines["pt"]) == len(lines["jax"]) == 2
        for a, b in zip(lines["pt"], lines["jax"]):
            if stencil == "life":
                assert a == b
            else:
                va = dict(x.split("=") for x in a.split()[2:])
                vb = dict(x.split("=") for x in b.split()[2:])
                assert va.keys() == vb.keys()
                for key in va:
                    # XLA's float32 mean on the CPU wanders by a few
                    # 1e-5 (its batched and unbatched means differ so)
                    np.testing.assert_allclose(float(va[key]),
                                               float(vb[key]), rtol=1e-4,
                                               atol=1e-6)


# ---- checkpoints ---------------------------------------------------------------


def test_jax_npy_checkpoint_of_an_ensemble_resumes_in_the_port(monkeypatch,
                                                               tmp_path):
    """The JAX CLI writes an ensemble's ``npy`` checkpoint at step 4; the
    port resumes it to step 8, onto ``--mesh 2``, and equals the JAX
    CLI's uninterrupted run."""
    ck = str(tmp_path / "ck")
    base = dict(stencil="heat3d", grid=(16, 16, 32), init="pulse",
                ensemble=2, ensemble_perturb=0.02)
    _run_jax(**base, iters=4, checkpoint_every=4, checkpoint_dir=ck)
    fields, step, _ = jckpt.load_checkpoint(ck)
    assert step == 4 and fields[0].shape == (2, 16, 16, 32)
    got = _run_port(monkeypatch, **base, iters=8, checkpoint_dir=ck,
                    resume=True, mesh=(2,))
    ref = _run_jax(**base, iters=8)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0,
                               atol=32 * EPS32 * 8)


def test_batched_npy_checkpoint_round_trip(monkeypatch, tmp_path):
    """A batched run checkpointed and resumed equals the uninterrupted run
    bit for bit (tests/test_ensemble_engine.py:635), resumed on another
    mesh too."""
    ck = str(tmp_path / "ck")
    base = dict(stencil="heat3d", grid=(32, 16, 128), seed=6, ensemble=2,
                init="pulse")
    full = _run_port(monkeypatch, **base, iters=6, mesh=(2, 1, 1))
    _run_port(monkeypatch, **base, iters=3, mesh=(2, 1, 1),
              checkpoint_every=3, checkpoint_dir=ck)
    assert tckpt.load_checkpoint(ck)[0][0].shape == (2, 32, 16, 128)
    for mesh, emesh in (((2, 1, 1), 0), ((), 2), ((4,), 2)):
        resumed = _run_port(monkeypatch, **base, iters=6, mesh=mesh,
                            ensemble_mesh=emesh, resume=True,
                            checkpoint_dir=ck)
        for f, r in zip(full, resumed):
            assert torch.equal(f, r)


# ---- two processes under gloo ------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", tmesh.VIRTUAL_DEVICES_ENV):
        env.pop(k, None)
    env[tmesh.DIST_TIMEOUT_ENV] = "60"
    env["PYTHONPATH"] = _REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


_BASE = ("--stencil", "heat3d", "--grid", "16,16,32", "--init", "pulse",
         "--device", "cpu", "--checkpoint-backend", "orbax")
MP_RUNS = {
    "emesh": ("--ensemble", "4", "--ensemble-mesh", "2",
              "--ensemble-perturb", "0.02"),
    "mesh2": ("--ensemble", "2", "--mesh", "2", "--fuse", "4",
              "--fuse-kind", "padfree", "--overlap"),
}


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Each multi-process case as 2 processes under gloo (all launched at
    once): {label: checkpoint directory}.  Each writes its blocks at step 4
    of 8 (the ``emesh`` case then resumes there in the cases below)."""
    root = tmp_path_factory.mktemp("mp")
    procs, dirs = [], {}
    for label, flags in MP_RUNS.items():
        ck = str(root / label)
        dirs[label] = ck
        port = _free_port()
        for r in range(2):
            procs.append((label, subprocess.Popen(
                [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *_BASE,
                 "--iters", "4", "--checkpoint-every", "4",
                 "--checkpoint-dir", ck, *flags],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=_REPO, env=_env(MASTER_ADDR="localhost",
                                    MASTER_PORT=port, RANK=r, WORLD_SIZE=2,
                                    LOCAL_RANK=r, LOCAL_WORLD_SIZE=2))))
    errs = {}
    try:
        for label, p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            errs.setdefault(label, []).append(err)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dirs, errs


def _argv_config(flags, **kw):
    cfg = tcli.config_from_args([*_BASE, *flags])
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("label", list(MP_RUNS))
def test_two_processes_equal_one(monkeypatch, two_processes, label):
    """Each 2-process batched run (its checkpoint, read back whole) equals
    the same run in one process bit for bit; the mesh line names the
    ensemble axis."""
    dirs, errs = two_processes
    fields, step, _ = tckpt.load_any(dirs[label])
    assert step == 4
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    one, _ = tcli.run(_argv_config(MP_RUNS[label], iters=4))
    for f, o in zip(fields, _whole(one)):
        assert torch.equal(torch.as_tensor(f), o)
    if label == "emesh":
        assert all("ensemble 2 x spatial 1" in e for e in errs[label])


def test_batched_sharded_checkpoint_resumes_elsewhere(monkeypatch,
                                                      two_processes):
    """The 2-process ``--ensemble-mesh 2`` checkpoint (each process its
    group's blocks) resumes in one process on ``--mesh 2`` (no ensemble
    axis) and unsharded, bit-equal to the uninterrupted run."""
    dirs, _ = two_processes
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    flags = MP_RUNS["emesh"]
    full, _ = tcli.run(_argv_config(flags, iters=8))
    full = _whole(full)
    for kw in (dict(mesh=(2,), ensemble_mesh=0), dict(ensemble_mesh=0)):
        got, _ = tcli.run(_argv_config(
            flags, iters=8, resume=True, checkpoint_dir=dirs["emesh"],
            checkpoint_every=0, **kw))
        for f, g in zip(full, _whole(got)):
            assert torch.equal(f, g)


def test_mcells_counts_every_member(monkeypatch):
    """``run`` counts ``prod(grid) * N`` cells a step for Mcells/s, as the
    JAX CLI does (its cli.py:1750)."""
    monkeypatch.setattr(tcli, "_slowest", lambda fields, dt: 2.0)
    for n in (0, 3):
        _, mcells = tcli.run(RunConfig(stencil="heat2d", grid=(16, 32),
                                       iters=10, ensemble=n, device="cpu"))
        assert mcells == 16 * 32 * max(1, n) * 10 / 2.0 / 1e6


def test_dtype_refusals_hold_for_batched_runs(monkeypatch):
    """A kernel path refuses float16 by its item, batched or not."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    for extra, item in ((dict(fuse=4), "B3"),
                        (dict(fuse=4, fuse_kind="stream"), "B5"),
                        (dict(compute="pallas", mesh=(2,)), "B2")):
        for n in (0, 2):
            with pytest.raises(NotImplementedError, match=item):
                tcli.build(RunConfig(stencil="heat3d", grid=(16, 16, 32),
                                     dtype="float16", ensemble=n,
                                     device="cpu", **extra))
