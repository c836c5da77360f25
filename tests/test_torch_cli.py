"""The slice as a whole: the port's CLI against the JAX package's CLI.

The same command line goes through ``mpi_cuda_process_tpu.cli.main`` and
``mpi_cuda_process_tpu_torch.cli.main([..., "--device", "cpu"])``; the two
runs are compared through the ``npy`` checkpoints they write, which share
one format.  Tolerances: ``32 * eps * max(|ref|, 1)`` per step path (the
raw-step tolerance of tests/test_rawstep.py, grown with the step count) and
``atol = 1e-4`` for ``--fuse`` (tests/test_fused.py); guard-frame cells
match exactly.
"""

import logging

import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
ITERS = 8
GRIDS = {2: "16,20", 3: "16,16,128"}


def _run_both(tmp_path, args, label):
    jdir, tdir = str(tmp_path / f"{label}_jax"), str(tmp_path / f"{label}_pt")
    assert jcli.main(args + ["--checkpoint-dir", jdir]) == 0
    assert tcli.main(args + ["--checkpoint-dir", tdir,
                             "--device", "cpu"]) == 0
    jf, jstep, _ = jckpt.load_checkpoint(jdir)
    tf, tstep, tcfg = tckpt.load_checkpoint(tdir)
    return jf, jstep, tf, tstep, tcfg


def _assert_match(tf, jf, halo, atol):
    assert len(tf) == len(jf)
    for t, j in zip(tf, jf):
        assert t.shape == j.shape and t.dtype == j.dtype
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        if halo:
            for d in range(j.ndim):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * j.ndim
                    idx[d] = sl
                    np.testing.assert_array_equal(t[tuple(idx)],
                                                  j[tuple(idx)])


CASES = [
    ("heat2d", 2, 1, "jnp"), ("mdf", 2, 1, "jnp"), ("wave2d", 2, 1, "jnp"),
    ("heat3d", 3, 1, "jnp"), ("heat3d27", 3, 1, "jnp"),
    ("heat3d4th", 3, 2, "jnp"), ("wave3d", 3, 1, "jnp"),
    ("heat3d", 3, 1, "pallas"), ("heat3d27", 3, 1, "pallas"),
    ("heat3d4th", 3, 2, "pallas"), ("wave3d", 3, 1, "pallas"),
    ("heat3d", 3, 1, "4"), ("heat3d27", 3, 1, "4"),
    ("heat3d4th", 3, 2, "2"), ("wave3d", 3, 1, "4"),
    ("heat2d", 2, 1, "pallas"), ("life", 2, 1, "jnp"),
    ("life", 2, 1, "pallas"),
]


# --compute pallas runs the compute_fn kernels with or without --periodic:
# K4/K5 on 3D grids, K7 on 2D grids (the 2D --fuse cases, which need grids
# the TPU kernel accepts, are in tests/test_torch_2d_cli.py).
RUNS = [c + (p,) for c in CASES for p in (False, True)]


@pytest.mark.parametrize("name,ndim,halo,mode,periodic", RUNS,
                         ids=[f"{n}-{m}-{'periodic' if p else 'frame'}"
                              for n, _, _, m, p in RUNS])
def test_cli_run_matches_jax_cli(tmp_path, name, ndim, halo, mode,
                                 periodic):
    flags = (["--compute", mode] if mode in ("jnp", "pallas")
             else ["--fuse", mode])
    args = ["--stencil", name, "--grid", GRIDS[ndim], "--iters",
            str(ITERS), "--checkpoint-every", str(ITERS), *flags]
    if periodic:
        args.append("--periodic")
    trawstep.launches.clear()
    tfused.launches.clear()
    if periodic and name.startswith("wave"):
        # The JAX CLI cannot run this line: its pulse init hands the same
        # array in as u and u_prev, and its runner donates both.  The
        # reference is the JAX step it would run, from the same init.
        tdir = str(tmp_path / "run_pt")
        assert tcli.main(args + ["--checkpoint-dir", tdir,
                                 "--device", "cpu"]) == 0
        tf, tstep, tcfg = tckpt.load_checkpoint(tdir)
        jst = jmake_stencil(name)
        grid = tuple(int(g) for g in GRIDS[ndim].split(","))
        step = jdriver.make_step(jst, grid, periodic=True)
        jf = jinit_state(jst, grid, 0, 0.15, "auto", periodic=True)
        for _ in range(ITERS):
            jf = step(jf)
        jf, jstep = tuple(np.asarray(f) for f in jf), ITERS
    else:
        jf, jstep, tf, tstep, tcfg = _run_both(tmp_path, args, "run")
    assert jstep == tstep == ITERS
    assert tcfg["stencil"] == name and tcfg["device"] == "cpu"
    scale = max(float(np.max(np.abs(jf[0]))), 1.0)
    atol = 1e-4 if mode.isdigit() else 32 * EPS32 * scale * ITERS
    _assert_match(tf, jf, None if periodic else halo, atol)
    # on the CPU every wrapper takes its plain version: no launches
    assert not trawstep.launches and not tfused.launches


@pytest.mark.parametrize("name,flags", [
    ("heat3d", ["--compute", "pallas"]),
    ("wave3d", ["--fuse", "4"]),
    ("heat2d", []),
])
def test_port_resumes_a_jax_checkpoint(tmp_path, name, flags):
    """A JAX run checkpoints at step 4; the port resumes it to step 8 and
    matches JAX's uninterrupted 8-step run."""
    grid = GRIDS[3 if name.endswith("3d") else 2]
    base = ["--stencil", name, "--grid", grid, "--checkpoint-every", "4"]
    d = str(tmp_path / "shared")
    assert jcli.main(base + ["--iters", "4", "--checkpoint-dir", d]) == 0
    assert jckpt.latest_step(d) == 4
    assert tcli.main(base + ["--iters", "8", "--checkpoint-dir", d,
                             "--resume", "--device", "cpu", *flags]) == 0
    ref = str(tmp_path / "ref")
    assert jcli.main(base + ["--iters", "8", "--checkpoint-dir", ref]) == 0
    tf, tstep, _ = tckpt.load_checkpoint(d)
    jf, jstep, _ = jckpt.load_checkpoint(ref)
    assert tstep == jstep == 8
    halo = 1
    atol = 1e-4 if "--fuse" in flags else \
        32 * EPS32 * max(float(np.max(np.abs(jf[0]))), 1.0) * 8
    _assert_match(tf, jf, halo, atol)


def test_port_checkpoint_resume_bitmatch(tmp_path):
    """Port-only: 4 steps + checkpoint, resume to 8 == 8 uninterrupted."""
    base = ["--stencil", "heat3d", "--grid", GRIDS[3], "--device", "cpu",
            "--checkpoint-every", "4", "--compute", "pallas"]
    d, ref = str(tmp_path / "a"), str(tmp_path / "b")
    assert tcli.main(base + ["--iters", "4", "--checkpoint-dir", d]) == 0
    assert tcli.main(base + ["--iters", "8", "--checkpoint-dir", d,
                             "--resume"]) == 0
    assert tcli.main(base + ["--iters", "8", "--checkpoint-dir", ref]) == 0
    a, sa, _ = tckpt.load_checkpoint(d)
    b, sb, _ = tckpt.load_checkpoint(ref)
    assert sa == sb == 8
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_log_lines_match_jax(caplog):
    """``--log-every`` logs the same diagnostics keys, and the run ends in
    the ``INFO ... Mcells/s`` line, on both sides."""
    args = ["--stencil", "heat3d", "--grid", GRIDS[3], "--iters", "8",
            "--log-every", "4"]
    with caplog.at_level(logging.INFO):
        jcli.main(args)
        jlines = [r.getMessage() for r in caplog.records
                  if r.name == "mpi_cuda_process_tpu"]
        caplog.clear()
        tcli.main(args + ["--device", "cpu"])
        tlines = [r.getMessage() for r in caplog.records
                  if r.name == "mpi_cuda_process_tpu_torch"]

    def keys(lines):
        return [[kv.split("=")[0] for kv in ln.split()[2:]]
                for ln in lines if ln.startswith("step ")]

    assert keys(tlines) == keys(jlines) and len(keys(tlines)) == 2
    assert "Mcells/s" in tlines[-1] and "8 steps on 16x16x128" in tlines[-1]


def test_device_cuda_without_a_card_raises(monkeypatch):
    """The default device is cuda; with no card the run raises and never
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.config_from_args(["--stencil", "heat3d"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--stencil", "heat3d", "--grid", "8,8,8", "--iters",
                   "2"])
    from mpi_cuda_process_tpu_torch.utils.init import init_state
    from mpi_cuda_process_tpu_torch import make_stencil

    with pytest.raises((RuntimeError, AssertionError)):
        init_state(make_stencil("heat3d"), (8, 8, 8), device="cuda")


# The JAX CLI's refusal of a --fuse k off the dtype's alignment unit
# (cli.py:964-969 there).
SUBLANE = ("2\\*k\\*halo a multiple of the dtype's sublane tile — 8 for f32, "
           "16 for bf16")


def _plain_twin(argv):
    """``argv`` on the plain path: without its kernel and mesh flags."""
    out, skip = [], 0
    for a in argv:
        if skip:
            skip -= 1
        elif a in ("--compute", "--fuse", "--fuse-kind", "--mesh",
                   "--exchange"):
            skip = 1
        elif a != "--overlap":
            out.append(a)
    return out


def _equals_plain_run(argv):
    """The run of ``argv`` equals its plain twin's bit for bit, in the
    twin's dtype."""
    got, _ = tcli.run(tcli.config_from_args(argv))
    ref, _ = tcli.run(tcli.config_from_args(_plain_twin(argv)))
    if tstepper.is_sharded(got):
        got = tstepper.gather_fields(got)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("extra,exc,match", [
    # The ids extra0-extra2 keep their names from the refusals they pinned
    # before K7 and K8 took bfloat16 (ROADMAP B2, B6): each run now equals
    # the plain bfloat16 run bit for bit (``exc`` None).
    pytest.param(["--grid", "16,20", "--compute", "pallas", "--dtype",
                  "bfloat16"], None, None,
                 id="extra0-NotImplementedError-B2"),
    pytest.param(["--grid", "16,20", "--compute", "pallas", "--periodic",
                  "--dtype", "bfloat16"], None, None,
                 id="extra1-NotImplementedError-B2"),
    pytest.param(["--grid", "16,20", "--fuse", "4", "--dtype", "bfloat16"],
                 None, None, id="extra2-NotImplementedError-B6"),
    # These ids keep their names from the refusals they pinned before
    # --fuse-kind stream ran and before bfloat16 ran on the stream,
    # raw-step and fused kernels (tests/test_torch_stream.py,
    # test_torch_bf16.py, test_torch_fused_bf16.py).  bfloat16 --fuse 4
    # now meets the JAX CLI's own refusal: 2*k*halo off bfloat16's
    # alignment unit (k = 8 runs); the compute_fn kernel K4 takes bfloat16
    # too (B2), so extra5 equals the plain bfloat16 run bit for bit.
    pytest.param(["--fuse", "4", "--fuse-kind", "padfree", "--dtype",
                  "bfloat16"], ValueError, SUBLANE,
                 id="extra3-NotImplementedError-B5"),
    pytest.param(["--fuse", "4", "--dtype", "bfloat16"], ValueError, SUBLANE,
                 id="extra4-NotImplementedError-B1/B3"),
    pytest.param(["--compute", "pallas", "--periodic", "--dtype",
                  "bfloat16"], None, None,
                 id="extra5-NotImplementedError-B1/B3"),
    # This id keeps its name from the refusal it pinned before the sharded
    # checkpoint backend ran (ROADMAP A2, tests/test_torch_checkpoint.py):
    # the run now equals the plain run bit for bit.
    pytest.param(["--checkpoint-backend", "orbax"], None, None,
                 id="extra6-NotImplementedError-ROADMAP"),
    # This id keeps its name from the refusal it pinned before the patch
    # init ran (ROADMAP A2, tests/test_torch_reaction_advection.py); patch
    # on the one-field heat3d now raises the JAX package's own ValueError.
    pytest.param(["--init", "patch"], ValueError,
                 "seeds an activator/inhibitor pair",
                 id="extra7-NotImplementedError-ROADMAP A2"),
    (["--fuse", "3"], ValueError, "--fuse 3 unsupported"),
    (["--fuse-kind", "tiled"], ValueError, "requires an explicit --fuse"),
    (["--fuse", "4", "--compute", "pallas"], ValueError, "excludes"),
])
def test_unported_combinations_raise_naming_roadmap(extra, exc, match):
    args = ["--stencil", "heat3d", "--grid", "16,16,128", "--iters", "4",
            "--device", "cpu"]
    if extra[:2] == ["--grid", "16,20"]:
        args = ["--stencil", "heat2d", "--iters", "4", "--device", "cpu"]
    if exc is None:
        _equals_plain_run(args + extra)
        return
    with pytest.raises(exc, match=match):
        tcli.main(args + extra)


def test_unported_flags_are_not_registered_and_config_fields_refused():
    with pytest.raises(SystemExit):
        tcli.config_from_args(["--autotune"])
    # --supervise runs (ROADMAP A8, tests/test_torch_supervisor.py)
    assert tcli.config_from_args(["--supervise"]).supervise
    assert tcli.config_from_args(["--ensemble", "2"]).ensemble == 2
    # --groups runs (ROADMAP A7, tests/test_torch_groups_cli.py)
    assert tcli.config_from_args(
        ["--groups", "heat3d@0-1", "--group-transport", "collective"]
    ).group_transport == "collective"
    # --serve runs (ROADMAP A8, tests/test_torch_serve.py)
    assert tcli.config_from_args(["--serve", "0"]).serve_port == 0
    for field, value in (("serve_engine", 8080),
                         ("auto_policy", True),
                         ("compile_cache", "cache")):
        cfg = RunConfig(stencil="heat3d", grid=(8, 8, 8), iters=2,
                        device="cpu", **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcli.build(cfg)


def test_dispatch_tables_start_empty():
    """The tables began empty and hold only what the H100 timings entered
    (PERF.md section 5, "Dispatch"): the six raw families, sor3d's k, no
    stream kind.  ``--compute auto`` on the CPU still runs the
    plain path; on a card it takes the raw kernel, and ``--compute
    pallas`` takes it everywhere."""
    assert tcli._RAW_WINS == {"heat3d", "heat3d27", "heat3d4th", "wave3d",
                              "advect3d", "grayscott3d"}
    assert not tcli._AUTO_FUSE_KIND
    assert tcli._AUTO_FUSE_K == {"sor3d": 2}
    assert tcli._AUTO_FUSE_K_BF16 == {"sor3d": 4}
    cfg = RunConfig(stencil="heat3d", grid=(16, 16, 128), iters=8,
                    device="cpu")
    assert tcli.maybe_auto_fuse(cfg) is cfg
    assert tcli.resolve_raw_step(cfg, tcli._make_cfg_stencil(cfg)) is None
    card = RunConfig(stencil="heat3d", grid=(16, 16, 128), iters=8,
                     device="cuda")
    assert tcli.maybe_auto_fuse(card) is card
    assert tcli._raw_eligible(card, tcli._make_cfg_stencil(card))
    pallas = RunConfig(stencil="heat3d", grid=(16, 16, 128), iters=8,
                       device="cpu", compute="pallas")
    assert tcli.resolve_raw_step(pallas,
                                 tcli._make_cfg_stencil(pallas)) is not None


def test_config_is_a_copy_of_the_jax_runconfig():
    import dataclasses

    from mpi_cuda_process_tpu.config import RunConfig as JRunConfig

    j = {f.name: f.default for f in dataclasses.fields(JRunConfig)
         if f.name != "params"}
    t = {f.name: f.default for f in dataclasses.fields(RunConfig)
         if f.name != "params"}
    assert {k: v for k, v in t.items() if k != "device"} == j
    assert t["device"] == "cuda"
    cfg = RunConfig(stencil="wave3d", grid=(8, 8, 8), params={"c2dt2": 0.1})
    assert RunConfig.from_dict(dataclasses.asdict(cfg)) == cfg


MESH_RUNS = [
    ("heat3d", ["--mesh", "2,2"]),
    ("heat3d", ["--mesh", "2,2", "--compute", "pallas"]),
    ("heat3d", ["--mesh", "2,2", "--compute", "pallas", "--overlap",
                "--periodic"]),
    ("heat3d", ["--mesh", "2,2", "--fuse", "4"]),
    ("heat3d", ["--mesh", "2", "--fuse", "4", "--fuse-kind", "padfree"]),
    ("heat3d27", ["--mesh", "2,2", "--compute", "pallas"]),
    ("wave3d", ["--mesh", "2,2", "--compute", "pallas", "--overlap"]),
    ("heat2d", ["--mesh", "2,2", "--overlap"]),
]


@pytest.mark.parametrize("name,flags", MESH_RUNS,
                         ids=[f"{n}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, fl in MESH_RUNS])
def test_cli_mesh_run_matches_jax_cli(tmp_path, monkeypatch, name, flags):
    """The same --mesh command line through both CLIs: the port's shards
    run on the CPU (4 virtual shards), the JAX package's on its virtual
    devices; the final fields match at the path's tolerance, frame cells
    exactly."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    ndim = 2 if name.endswith("2d") else 3
    args = ["--stencil", name, "--grid", GRIDS[ndim], "--iters",
            str(ITERS), "--checkpoint-every", str(ITERS), "--init", "pulse",
            *flags]
    tkernels.launches.clear()
    tfused.launches.clear()
    jf, jstep, tf, tstep, tcfg = _run_both(tmp_path, args, "mesh")
    assert jstep == tstep == ITERS
    assert tuple(tcfg["mesh"]) == tuple(int(x) for x in flags[1].split(","))
    atol = 1e-4 if "--fuse" in flags else 1e-5 * ITERS
    _assert_match(tf, jf, None if "--periodic" in flags else
                  jmake_stencil(name).halo, atol)
    assert not tkernels.launches and not tfused.launches


@pytest.mark.parametrize("extra,exc,match", [
    (["--overlap"], ValueError, "needs --mesh"),
    # The ids extra1, extra2 and extra4 keep their names from the refusals
    # they pinned before --fuse --overlap (B4 row 7), --fuse-kind padfree
    # on a y-sharded mesh (row 9) and --fuse-kind stream (B5) ran; those
    # run in tests/test_torch_twoaxis.py and tests/test_torch_stream.py
    # now.  Since every fused kind takes bfloat16, extra1 runs: the stream
    # kind's K3 shells would have m = 4, off bfloat16's alignment unit, so
    # the step falls back to the non-split one, as in the JAX package, and
    # equals the plain run bit for bit; extra2 (K9 at k = 4) meets that
    # alignment rule and is refused as unsupported.
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--overlap",
                  "--fuse-kind", "stream", "--dtype", "bfloat16"],
                 None, None, id="extra1-NotImplementedError-B4"),
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
                  "--dtype", "bfloat16"], ValueError, "sublane tile",
                 id="extra2-NotImplementedError-row 9"),
    (["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "tiled"], ValueError,
     "--fuse-kind"),
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
                  "--periodic"], ValueError, "unsupported",
                 id="extra4-NotImplementedError-B5"),
    (["--mesh", "2,2", "--fuse", "3"], ValueError, "unsupported"),
    (["--mesh", "1,1,2", "--fuse", "4"], ValueError, "unsupported"),
    (["--mesh", "3"], ValueError, "not divisible"),
    (["--mesh", "4,2"], ValueError, "needs 8 devices"),
    # The ids extra9 and extra10 keep their names from the refusals they
    # pinned before K8 and K7 took bfloat16 (ROADMAP B6, B2): the K8 run
    # meets the refusal its float32 twin meets (a 2D mesh that shards x,
    # as in the JAX package), the K7 run equals the plain bfloat16 run.
    pytest.param(["--grid", "16,20", "--mesh", "2,2", "--fuse", "4",
                  "--dtype", "bfloat16"], ValueError, "unsupported",
                 id="extra9-NotImplementedError-B6"),
    pytest.param(["--grid", "16,20", "--mesh", "2,2", "--compute", "pallas",
                  "--dtype", "bfloat16"], None, None,
                 id="extra10-NotImplementedError-B2"),
])
def test_mesh_refusals_name_their_reason(monkeypatch, caplog, extra, exc,
                                        match):
    """Each case raises naming its reason, or (``exc`` None) runs, logs
    the overlap fallback where it asks for --overlap, and equals the plain
    run of its dtype bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "heat3d", "--grid", "16,16,128", "--iters", "4",
            "--device", "cpu"]
    if extra[:2] == ["--grid", "16,20"]:
        args = ["--stencil", "heat2d", "--iters", "4", "--device", "cpu"]
    if exc is None:
        with caplog.at_level(logging.WARNING):
            _equals_plain_run(args + extra)
        assert ("cannot host the interior/boundary split" in caplog.text) \
            == ("--overlap" in extra)
        return
    with pytest.raises(exc, match=match):
        tcli.main(args + extra)


def test_mesh_run_logs_shards_per_device(monkeypatch, caplog):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    with caplog.at_level(logging.INFO):
        tcli.main(["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "2",
                   "--mesh", "2,2", "--device", "cpu", "--log-every", "1"])
    lines = [r.getMessage() for r in caplog.records
             if r.name == "mpi_cuda_process_tpu_torch"]
    assert "mesh 2x2: 4 shards on 1 device(s)" in lines
    assert sum(ln.startswith("step ") for ln in lines) == 2
