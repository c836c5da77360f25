"""Checkpoints of the port: the sharded backend (``--checkpoint-backend
orbax``, written through ``torch.distributed.checkpoint``), its resume
across a change of mesh, its retention and atomic writes, the formats it
tells apart, and the fault-injection sites that prove every recovery path
(``resilience/faults.py``), against the JAX package.

A sharded checkpoint holds every block with its global offsets; a load
reads, for each block of the target, the saved blocks that overlap it.  So
a checkpoint written on ``--mesh 2,2`` resumes on ``--mesh 4`` and
unsharded (and back) bit for bit, in every dtype a field takes (float32,
bfloat16, Life's int32).  The fault tests mirror the JAX package's
tests/test_fault_injection.py:99-190: a child CLI process inherits
``FAULT_INJECT`` and dies by SIGKILL at a declared point (a chunk boundary
before its save, or a checkpoint write between its payload and its
rename), then the run resumes from what survived and must bit-match an
uninterrupted run.  Every child has its own timeout.  The multi-process
forms (gloo, 2 and 4 processes) are in tests/test_torch_multiprocess.py.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.resilience import faults as jfaults
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT = 120  # seconds, each child process
_SIGKILL = -signal.SIGKILL


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8) if shape else None


def _fields(dtype, grid=(16, 16, 32), n=2, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return tuple(torch.from_numpy(rng.integers(0, 2, grid, np.int32))
                     for _ in range(n))
    return tuple(torch.from_numpy(rng.random(grid, dtype=np.float32))
                 .to(dtype) for _ in range(n))


def _on(fields, shape):
    return fields if not shape else tstepper.shard_fields(
        fields, _mesh(shape), len(fields[0].shape))


def _targets(like, shape):
    grid = tuple(like[0].shape)
    if not shape:
        return tuple(torch.empty(grid, dtype=f.dtype) for f in like)
    mesh = _mesh(shape)
    local = tuple(g // c for g, c in zip(grid, mesh.counts(len(grid))))
    return tuple(tstepper.ShardedField(
        [torch.empty(local, dtype=f.dtype) for _ in mesh.local_coords()],
        mesh, grid) for f in like)


def _whole(fields):
    return tstepper.gather_fields(fields) if tstepper.is_sharded(fields) \
        else fields


def _bits_equal(a, b):
    for x, y in zip(_whole(a), _whole(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y)


# ---- the sharded backend: save on one mesh, load on another ---------------

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
           "int32": torch.int32}
_MESH_PAIRS = [((2, 2), (4,)), ((2, 2), ()), ((4,), (2, 2)), ((), (2, 2)),
               ((2, 2), (2, 2)), ((2, 2, 1), (1, 2))]


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("saved,loaded", _MESH_PAIRS,
                         ids=["x".join(map(str, a)) or "whole"
                              for a, _ in _MESH_PAIRS])
def test_sharded_checkpoint_reshards_bit_for_bit(tmp_path, dtype, saved,
                                                 loaded):
    """Every block written with its global offsets, read back onto another
    mesh (or unsharded) exactly, dtype kept; one process writes one file
    of blocks plus the metadata and meta.json."""
    fields = _fields(_DTYPES[dtype])
    path = str(tmp_path / "ck")
    written = _on(fields, saved)
    tckpt.orbax_save_checkpoint(path, written, 12, {"k": 1})
    assert tckpt.checkpoint_format(path) == "dcp"
    assert tckpt.latest_step(path) == 12
    names = sorted(os.listdir(os.path.join(path, "step_000000000012")))
    assert names == [".metadata", "__0_0.distcp", "meta.json"]
    out, step, cfg = tckpt.load_any(path,
                                    target_fields=_targets(fields, loaded))
    assert step == 12 and cfg == {"k": 1}
    _bits_equal(out, fields)
    nbytes = sum(f.numel() * f.element_size() for f in fields)
    assert tckpt.local_nbytes(written) == tckpt.local_nbytes(out) == nbytes
    whole, _, _ = tckpt.load_any(path)
    _bits_equal(whole, fields)


def test_sharded_load_checks_grid_and_dtype(tmp_path):
    path = str(tmp_path / "ck")
    fields = _fields(torch.float32)
    tckpt.orbax_save_checkpoint(path, fields, 4)
    with pytest.raises(ValueError, match=r"holds a \(16, 16, 32\) grid"):
        tckpt.load_any(path, target_fields=_targets(
            _fields(torch.float32, grid=(16, 16, 16)), ()))
    with pytest.raises(ValueError, match="this run's are torch.bfloat16"):
        tckpt.load_any(path, target_fields=_targets(
            _fields(torch.bfloat16), ()))
    with pytest.raises(ValueError, match="holds 2 field"):
        tckpt.load_any(path, target_fields=_targets(fields[:1], ()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_npy_checkpoint_loads_into_shards(tmp_path, dtype):
    """An npy checkpoint (the JAX package's format) loads into this run's
    blocks, each reading its own slices of the memory-mapped fields."""
    fields = _fields(_DTYPES[dtype])
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, fields, 8)
    out, step, _ = tckpt.load_any(path, target_fields=_targets(fields,
                                                               (2, 2)))
    assert step == 8
    _bits_equal(out, fields)


# ---- retention, atomic writes, formats ------------------------------------

def test_sharded_retention_keeps_one_step(tmp_path):
    """One step directory is kept: the previous one goes once the new one
    has landed, and a stale co-located npy checkpoint once the sharded
    stream is ahead; a newer step directory survives an npy save, and a
    killed write's temporary directory is never read as a checkpoint."""
    path = str(tmp_path / "ck")
    f = _on(_fields(torch.float32), (2, 2))
    tckpt.orbax_save_checkpoint(path, f, 4)
    tckpt.orbax_save_checkpoint(path, f, 8)
    assert sorted(os.listdir(path)) == ["step_000000000008"]
    tckpt.save_checkpoint(path, _whole(f), 6)
    assert tckpt.checkpoint_format(path) == "dcp"
    assert "step_000000000008" in os.listdir(path)
    tckpt.orbax_save_checkpoint(path, f, 12)
    assert sorted(os.listdir(path)) == ["step_000000000012"]
    # a write killed before its rename leaves its temporary directory
    os.makedirs(os.path.join(path, ".tmp_step_000000000016"))
    assert tckpt.latest_step(path) == 12
    tckpt.orbax_save_checkpoint(path, f, 12)  # the same step again
    assert sorted(os.listdir(path)) == [".tmp_step_000000000016",
                                        "step_000000000012"]
    _bits_equal(tckpt.load_any(path)[0], f)


@pytest.mark.parametrize("npy,dcp,want", [(12, 8, "npy"), (8, 12, "dcp"),
                                          (8, 8, "npy")],
                         ids=["npy_newer", "dcp_newer", "tie"])
def test_newest_format_wins(tmp_path, npy, dcp, want):
    """Both formats in one directory: the newest step is resumed (npy on a
    tie), as in the JAX package (checkpointing.py:132-145)."""
    path = str(tmp_path / "ck")
    a, b = _fields(torch.float32, seed=1), _fields(torch.float32, seed=2)
    tckpt.orbax_save_checkpoint(path, b, dcp)
    tckpt.save_checkpoint(path, a, npy)  # an older step dir is dropped
    if dcp > npy:
        assert "step_%012d" % dcp in os.listdir(path)
    else:
        tckpt.orbax_save_checkpoint(str(tmp_path / "x"), b, dcp)
        os.replace(str(tmp_path / "x" / ("step_%012d" % dcp)),
                   os.path.join(path, "step_%012d" % dcp))
    assert tckpt.checkpoint_format(path) == want
    assert tckpt.latest_step(path) == max(npy, dcp)
    out, step, _ = tckpt.load_any(path, target_fields=_targets(a, (2,)))
    assert step == (npy if want == "npy" else dcp)
    _bits_equal(out, a if want == "npy" else b)


def test_jax_orbax_directory_refused_by_name(tmp_path):
    """A checkpoint the JAX package's orbax backend wrote is told apart
    from the port's and refused naming its item (reading it needs
    tensorstore); the CLI's resume refuses it too."""
    path = str(tmp_path / "ck")
    jckpt.orbax_save_checkpoint(
        path, (jnp.zeros((16, 16, 32), jnp.float32),), 4)
    assert jckpt.checkpoint_format(path) == "orbax"
    assert tckpt.checkpoint_format(path) == "orbax"
    assert tckpt.latest_step(path) == 4
    for call in (lambda: tckpt.load_any(path),
                 lambda: tckpt.orbax_load_checkpoint(path),
                 lambda: tcli.main(["--stencil", "heat3d", "--grid",
                                    "16,16,32", "--iters", "8", "--resume",
                                    "--checkpoint-dir", path, "--device",
                                    "cpu"])):
        with pytest.raises(NotImplementedError, match="ROADMAP A2"):
            call()


def test_jax_npy_checkpoint_resumes_into_the_sharded_port(tmp_path,
                                                         monkeypatch):
    """The JAX CLI writes an npy checkpoint at step 4; the port resumes it
    on --mesh 2,2, checkpointing through the sharded backend, to step 8:
    bit-equal to the port resuming the same checkpoint unsharded, and
    within atol 1e-4 of the JAX CLI's uninterrupted run."""
    import shutil

    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--grid", "16,16,32", "--init", "pulse"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    twin = str(tmp_path / "twin")
    assert jcli.main(base + ["--iters", "4", "--checkpoint-every", "4",
                             "--checkpoint-dir", jdir]) == 0
    shutil.copytree(jdir, twin)
    got, _ = tcli.run(tcli.config_from_args(
        base + ["--iters", "8", "--mesh", "2,2", "--resume",
                "--checkpoint-dir", jdir, "--checkpoint-every", "4",
                "--checkpoint-backend", "orbax", "--device", "cpu"]))
    assert tckpt.checkpoint_format(jdir) == "dcp"
    assert tckpt.latest_step(jdir) == 8
    ref, _ = tcli.run(tcli.config_from_args(
        base + ["--iters", "8", "--resume", "--checkpoint-dir", twin,
                "--device", "cpu"]))
    _bits_equal(got, ref)
    assert jcli.main(base + ["--iters", "8", "--checkpoint-every", "8",
                             "--checkpoint-dir", tdir]) == 0
    jf, _, _ = jckpt.load_checkpoint(tdir)
    np.testing.assert_allclose(_whole(got)[0].numpy(), jf[0], rtol=0,
                               atol=1e-4)


# ---- the CLI: resume across a change of mesh --------------------------------

_RUNS = {
    "heat3d_fuse": (["--stencil", "heat3d", "--grid", "32,32,64", "--init",
                     "pulse", "--fuse", "4", "--fuse-kind", "padfree"],
                    ("2,2", "4", "")),
    "wave3d_bf16": (["--stencil", "wave3d", "--grid", "16,16,64", "--init",
                     "pulse", "--dtype", "bfloat16", "--compute", "pallas"],
                    ("2,2", "4", "")),
    "life": (["--stencil", "life", "--grid", "32,64", "--init", "random",
              "--seed", "7"], ("4", "2", "")),
}


@pytest.mark.parametrize("name", list(_RUNS))
def test_cli_resume_across_meshes_bit_equal(tmp_path, monkeypatch, name):
    """Checkpointed on the first mesh to step 8, resumed on the second to
    step 16 and unsharded to step 24 (each with the sharded backend):
    bit-equal to the uninterrupted unsharded run of 24 steps."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base, meshes = _RUNS[name]
    ck = str(tmp_path / "ck")
    ckpt = ["--checkpoint-every", "8", "--checkpoint-dir", ck,
            "--checkpoint-backend", "orbax", "--device", "cpu"]
    for iters, mesh in zip((8, 16, 24), meshes):
        argv = base + (["--mesh", mesh] if mesh else []) + ckpt + [
            "--iters", str(iters)] + (["--resume"] if iters > 8 else [])
        got, _ = tcli.run(tcli.config_from_args(argv))
        assert tckpt.latest_step(ck) == iters
    ref, _ = tcli.run(tcli.config_from_args(
        base + ["--iters", "24", "--device", "cpu"]))
    _bits_equal(got, ref)
    out, step, cfg = tckpt.load_any(ck)
    assert step == 24 and cfg["checkpoint_backend"] == "orbax"
    _bits_equal(out, ref)


def test_cli_logs_checkpoint_io_and_staging(tmp_path, caplog):
    import logging

    ck = str(tmp_path / "ck")
    with caplog.at_level(logging.INFO, "mpi_cuda_process_tpu_torch"):
        tcli.main(["--stencil", "heat3d", "--grid", "16,16,32", "--iters",
                   "4", "--checkpoint-every", "2", "--checkpoint-dir", ck,
                   "--checkpoint-backend", "orbax", "--device", "cpu"])
        tcli.main(["--stencil", "heat3d", "--grid", "16,16,32", "--iters",
                   "6", "--resume", "--checkpoint-dir", ck, "--device",
                   "cpu"])
    assert "checkpoint step 2: 32768 bytes of this process's blocks " \
        "written in" in caplog.text
    assert "checkpoint read: 32768 bytes" in caplog.text
    st = port.make_stencil("heat3d")
    assert tbudget.checkpoint_host_bytes(st, (16, 16, 32), (2, 2)) == 8192


# ---- fault injection: kill, resume, bit-match ------------------------------

_LIFE = ["--stencil", "life", "--grid", "64,64", "--iters", "2000",
         "--seed", "11", "--init", "random", "--checkpoint-every", "10",
         "--device", "cpu"]


def _child(argv, fault):
    env = dict(os.environ, FAULT_INJECT=fault, FAULT_ATTEMPT="0",
               PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


_FAULTS = {
    "exchange_npy": ("exchange:step=40:sigkill", []),
    "exchange_orbax": ("exchange:step=40:sigkill",
                       ["--checkpoint-backend", "orbax"]),
    "during_write_npy": ("checkpoint:during_write:step=20:sigkill", []),
    "during_write_orbax": ("checkpoint:during_write:step=20:sigkill",
                           ["--checkpoint-backend", "orbax"]),
    "before_write_orbax": ("checkpoint:before_write:step=30:sigkill",
                           ["--checkpoint-backend", "orbax"]),
    "first_write_orbax": ("checkpoint:during_write:sigkill",
                          ["--checkpoint-backend", "orbax"]),
}


@pytest.fixture(scope="module")
def killed(tmp_path_factory):
    """Every fault case's child, all launched at once; each dies by
    SIGKILL at its declared point."""
    out = tmp_path_factory.mktemp("faults")
    procs = {}
    for name, (fault, flags) in _FAULTS.items():
        ck = str(out / name)
        procs[name] = (ck, _child(_LIFE + flags + ["--checkpoint-dir", ck],
                                  fault))
    res = {}
    try:
        for name, (ck, p) in procs.items():
            _, err = p.communicate(timeout=TIMEOUT)
            res[name] = (ck, p.returncode, err)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


def _resume_bitmatch(ck, iters, backend):
    base = dict(stencil="life", grid=(64, 64), seed=11, init="random",
                device="cpu")
    resumed, _ = tcli.run(RunConfig(**base, iters=iters, resume=True,
                                    checkpoint_dir=ck, checkpoint_every=10,
                                    checkpoint_backend=backend))
    full, _ = tcli.run(RunConfig(**base, iters=iters))
    _bits_equal(resumed, full)


@pytest.mark.parametrize("backend", ["npy", "orbax"])
def test_fault_sigkill_at_step_resume_bitmatch(killed, backend):
    """exchange:step=40 fires at the step-40 boundary BEFORE its save: the
    newest survivor is exactly step 30, and the resumed run bit-matches
    an uninterrupted one."""
    ck, rc, err = killed[f"exchange_{backend}"]
    assert rc == _SIGKILL, err
    assert "[faults] firing 'exchange:step=40:sigkill'" in err
    assert tckpt.latest_step(ck) == 30
    assert tckpt.checkpoint_format(ck) == ("dcp" if backend == "orbax"
                                           else "npy")
    _resume_bitmatch(ck, 60, backend)


@pytest.mark.parametrize("backend", ["npy", "orbax"])
def test_fault_sigkill_during_checkpoint_write_atomic(killed, backend):
    """SIGKILL between the step-20 payload and its rename: the step-10
    checkpoint stays the newest loadable state."""
    ck, rc, err = killed[f"during_write_{backend}"]
    assert rc == _SIGKILL, err
    assert tckpt.latest_step(ck) == 10
    fields, step, _ = tckpt.load_any(ck)
    assert step == 10
    if backend == "orbax":
        assert ".tmp_step_000000000020" in os.listdir(ck)
    _resume_bitmatch(ck, 40, backend)


def test_fault_sigkill_before_write(killed):
    """before_write at step 30: the step-20 checkpoint survives whole."""
    ck, rc, err = killed["before_write_orbax"]
    assert rc == _SIGKILL, err
    assert tckpt.latest_step(ck) == 20
    _resume_bitmatch(ck, 40, "orbax")


def test_fault_sigkill_before_first_checkpoint_write(killed):
    """Death in the first save's write: nothing loadable exists."""
    ck, rc, err = killed["first_write_orbax"]
    assert rc == _SIGKILL, err
    assert tckpt.checkpoint_format(ck) is None
    assert tckpt.latest_step(ck) is None
    with pytest.raises(FileNotFoundError):
        tckpt.load_any(ck)


def test_exchange_fault_fires_in_the_tol_loop(monkeypatch):
    """--tol's residual checks are chunk boundaries too."""
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=8:raise")
    tfaults.reset()
    with pytest.raises(tfaults.FaultInjected, match="exchange:step=8"):
        tcli.main(["--stencil", "sor3d", "--grid", "16,16,32", "--iters",
                   "64", "--tol", "1e-9", "--tol-check-every", "4",
                   "--device", "cpu"])
    tfaults.reset()


def test_compile_fault_fires_where_a_runner_is_built(monkeypatch):
    monkeypatch.setenv("FAULT_INJECT", "compile:raise")
    tfaults.reset()
    with pytest.raises(tfaults.FaultInjected, match="compile:raise"):
        tdriver.make_runner(lambda f: f, 1)
    tdriver.make_runner(lambda f: f, 1)  # a spec fires once a process
    tfaults.reset()


def test_numerics_fault_refused_naming_a8(monkeypatch):
    """The numerics fault poisons the state through the health sentinel,
    which the port now has (ROADMAP A8's observability part): the spec
    is no longer refused; it poisons one cell at the first boundary at
    or past its step, and ``--health`` stops the run there naming it."""
    from mpi_cuda_process_tpu_torch.obs import health as thealth

    monkeypatch.setenv("FAULT_INJECT", "numerics:step=4:nan")
    tfaults.reset()
    with pytest.raises(thealth.SimulationDiverged, match="at step 4"):
        tcli.main(["--stencil", "heat3d", "--grid", "16,16,32", "--iters",
                   "8", "--log-every", "2", "--health", "--device",
                   "cpu"])
    tfaults.reset()


# ---- the fault grammar is the JAX package's --------------------------------

_SPECS = [
    "exchange:step=40:sigkill",
    "checkpoint:during_write:step=20:sigkill",
    "checkpoint:before_write:raise",
    "compile:hang",
    "heartbeat:wedge",
    "label:name=heat2d_512_f32:hang",
    "numerics:step=40:nan",
    "exchange:step=3:sleep:250",
    "exchange:attempt=1:sigkill,compile:always:raise",
]
_BAD = [
    "exchange", "nowhere:raise", "exchange:explode", "exchange:wedge",
    "numerics:raise", "compile:sleep:10", "exchange:sleep:0",
    "exchange:when=3:raise",
]


@pytest.mark.parametrize("text", _SPECS)
def test_fault_specs_parse_as_in_jax(text):
    got = [dataclasses.asdict(s) for s in tfaults.parse_specs(text)]
    want = [dataclasses.asdict(s) for s in jfaults.parse_specs(text)]
    assert got == want and got


@pytest.mark.parametrize("text", _BAD)
def test_bad_fault_specs_raise_as_in_jax(text):
    with pytest.raises(ValueError) as got:
        tfaults.parse_specs(text)
    with pytest.raises(ValueError) as want:
        jfaults.parse_specs(text)
    assert str(got.value) == str(want.value)


def test_fault_fires_once_on_its_attempt_only(monkeypatch):
    monkeypatch.setenv("FAULT_INJECT", "exchange:step=4:attempt=1:raise")
    tfaults.reset()
    tfaults.maybe_fire("exchange", step=8)  # attempt 0: inactive
    monkeypatch.setenv("FAULT_ATTEMPT", "1")
    tfaults.maybe_fire("exchange", step=2)  # before its step
    with pytest.raises(tfaults.FaultInjected):
        tfaults.maybe_fire("exchange", step=4)
    tfaults.maybe_fire("exchange", step=8)  # fired already
    tfaults.reset()


def test_the_port_imports_no_jax_for_its_faults():
    """The port's fault module is its own copy (pure stdlib)."""
    src = open(tfaults.__file__).read()
    assert "import jax" not in src and "mpi_cuda_process_tpu." not in src
    assert json.loads(json.dumps(tfaults._SITES)) == list(jfaults._SITES)
