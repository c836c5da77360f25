"""The 2D slice as a whole: the port's CLI against the JAX package's CLI.

Life, heat2d and mdf through ``--compute jnp``, ``--compute pallas`` (K7)
and ``--fuse 8`` (K8), unsharded and on a row-split ``--mesh 2``/``4``
(the port's shards on the CPU, ``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES``;
the JAX package's on its virtual devices), with and without ``--overlap``.
The two runs are compared through the ``npy`` checkpoints they write.
Life (int32, ``--init random`` from the same threefry bits) must match bit
for bit in every mode; heat2d/mdf within ``atol = 1e-4`` for ``--fuse``
(tests/test_fullgrid.py) and ``32 eps max(|ref|, 1) iters`` or
``1e-5 iters`` for the one-step paths (tests/test_torch_cli.py); frame
cells exactly.  Grids are ones the JAX package's whole-grid kernel accepts
(W a multiple of 128, rows a multiple of 8 per shard).
"""

import logging

import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
ITERS = 16
GRID = "32,128"


def _run_both(tmp_path, args, label):
    jdir, tdir = str(tmp_path / f"{label}_jax"), str(tmp_path / f"{label}_pt")
    assert jcli.main(args + ["--checkpoint-dir", jdir]) == 0
    assert tcli.main(args + ["--checkpoint-dir", tdir,
                             "--device", "cpu"]) == 0
    jf, jstep, _ = jckpt.load_checkpoint(jdir)
    tf, tstep, _ = tckpt.load_checkpoint(tdir)
    return jf, jstep, tf, tstep


def _assert_match(tf, jf, atol, frame=True):
    assert len(tf) == len(jf)
    for t, j in zip(tf, jf):
        assert t.shape == j.shape and t.dtype == j.dtype
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j)
            continue
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)
        if frame:
            for sl in ((0, slice(None)), (-1, slice(None)),
                       (slice(None), 0), (slice(None), -1)):
                np.testing.assert_array_equal(t[sl], j[sl])


RUNS = [(name, flags) for name in ("life", "heat2d", "mdf")
        for flags in (["--compute", "jnp"], ["--compute", "pallas"],
                      ["--fuse", "8"],
                      ["--mesh", "2", "--compute", "jnp"],
                      ["--mesh", "2", "--compute", "pallas"],
                      ["--mesh", "2", "--fuse", "8"])]
RUNS += [
    ("life", ["--mesh", "4", "--compute", "pallas"]),
    ("life", ["--mesh", "4", "--fuse", "8"]),
    ("heat2d", ["--mesh", "4", "--fuse", "8"]),
    ("life", ["--mesh", "2", "--compute", "pallas", "--overlap"]),
    ("heat2d", ["--mesh", "4", "--compute", "pallas", "--overlap"]),
    ("life", ["--compute", "pallas", "--periodic"]),
    ("life", ["--fuse", "8", "--periodic"]),
    ("heat2d", ["--mesh", "2", "--fuse", "8", "--periodic"]),
    ("life", ["--density", "0.4", "--mesh", "4", "--fuse", "8"]),
]


@pytest.mark.parametrize("name,flags", RUNS,
                         ids=[f"{n}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, fl in RUNS])
def test_2d_cli_run_matches_jax_cli(tmp_path, monkeypatch, name, flags):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", GRID, "--iters", str(ITERS),
            "--checkpoint-every", str(ITERS), *flags]
    tkernels.launches.clear()
    tfullgrid.launches.clear()
    jf, jstep, tf, tstep = _run_both(tmp_path, args, "run")
    assert jstep == tstep == ITERS
    if "--fuse" in flags:
        atol = 1e-4
    elif "--mesh" in flags:
        atol = 1e-5 * ITERS
    else:
        atol = 32 * EPS32 * max(float(np.max(np.abs(jf[0]))), 1.0) * ITERS
    _assert_match(tf, jf, atol, frame="--periodic" not in flags)
    # on the CPU every wrapper takes its plain version: no launches
    assert not tkernels.launches and not tfullgrid.launches


@pytest.mark.parametrize("name,grid,flags", [
    ("life", "64,128", ["--mesh", "2"]),      # 32 local rows >= 3m: split
    ("heat2d", GRID, ["--mesh", "4"]),         # 8 local rows: plain step
])
def test_2d_fuse_overlap_matches_jax_cli(tmp_path, monkeypatch, caplog,
                                         name, grid, flags):
    """``--fuse 8 --overlap``: the split where local rows >= 3m, else the
    non-split step with the TPU package's warning; values as JAX's."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", grid, "--iters", str(ITERS),
            "--checkpoint-every", str(ITERS), *flags, "--fuse", "8",
            "--overlap"]
    with caplog.at_level(logging.WARNING):
        jf, _, tf, _ = _run_both(tmp_path, args, "ov")
    warned = [r for r in caplog.records
              if r.name == "mpi_cuda_process_tpu_torch"
              and "cannot host the interior" in r.getMessage()]
    assert bool(warned) == (name == "heat2d")
    _assert_match(tf, jf, 1e-4)


@pytest.mark.parametrize("flags", [["--compute", "pallas"],
                                   ["--mesh", "2", "--fuse", "8"]])
def test_port_resumes_a_jax_life_checkpoint_bit_exact(tmp_path, monkeypatch,
                                                      flags):
    """A JAX Life run checkpoints at step 8; the port resumes it to 16 and
    equals JAX's uninterrupted 16-step run bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "life", "--grid", GRID, "--checkpoint-every", "8"]
    d = str(tmp_path / "shared")
    assert jcli.main(base + ["--iters", "8", "--checkpoint-dir", d]) == 0
    assert tcli.main(base + ["--iters", "16", "--checkpoint-dir", d,
                             "--resume", "--device", "cpu", *flags]) == 0
    ref = str(tmp_path / "ref")
    assert jcli.main(base + ["--iters", "16", "--checkpoint-dir", ref]) == 0
    tf, tstep, _ = tckpt.load_checkpoint(d)
    jf, jstep, _ = jckpt.load_checkpoint(ref)
    assert tstep == jstep == 16 and tf[0].dtype == np.int32
    np.testing.assert_array_equal(tf[0], jf[0])


def test_life_render_matches_jax(capsys):
    args = ["--stencil", "life", "--grid", "24,48", "--iters", "20",
            "--render", "--seed", "2"]
    jcli.main(args)
    jout = capsys.readouterr().out
    tcli.main(args + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert "0" in tout and tout.strip() == jout.strip()


@pytest.mark.parametrize("name,extra,exc,match", [
    ("wave2d", ["--compute", "pallas"], ValueError, "no pallas kernel"),
    ("heat2d", ["--fuse", "8", "--fuse-kind", "padfree"], ValueError,
     "--fuse-kind"),
    ("heat2d", ["--mesh", "2", "--fuse", "8", "--fuse-kind", "stream"],
     ValueError, "--fuse-kind"),
    ("heat2d", ["--mesh", "1,2", "--fuse", "8"], ValueError, "unsupported"),
    ("heat2d", ["--mesh", "4", "--fuse", "16"], ValueError, "unsupported"),
    # These two ids keep their names from the refusals they pinned before
    # K7 and K8 took bfloat16 (ROADMAP B2, B6): a float Life on K7 now
    # raises by its own item (B10, Life runs its kernels in int32 only),
    # and heat2d --fuse 8 in bfloat16 runs, equal to the plain bfloat16
    # run bit for bit (``exc`` None).
    pytest.param("life", ["--compute", "pallas", "--dtype", "float32"],
                 NotImplementedError, "ROADMAP B10",
                 id="life-extra5-NotImplementedError-B2"),
    pytest.param("heat2d", ["--fuse", "8", "--dtype", "bfloat16"], None,
                 None, id="heat2d-extra6-NotImplementedError-B6"),
])
def test_2d_refusals_name_their_reason(monkeypatch, name, extra, exc, match):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", GRID, "--iters", "16", "--device",
            "cpu", *extra]
    if exc is None:
        got, _ = tcli.run(tcli.config_from_args(args))
        ref, _ = tcli.run(tcli.config_from_args(
            args[:8] + ["--dtype", "bfloat16"]))
        assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], ref[0])
        return
    with pytest.raises(exc, match=match):
        tcli.main(args)
