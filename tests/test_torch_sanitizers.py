"""The debug sanitizers and the field dumps: the port's ``--check-finite``,
``--debug-checks`` (``driver.make_checked_runner``) and ``--dump-every`` /
``--dump-dir`` (``utils/native.py``) against the JAX package's.

The same ``RunConfig`` goes through ``mpi_cuda_process_tpu.cli.run`` and
``mpi_cuda_process_tpu_torch.cli.run(..., device="cpu")``:

* a healthy run under either sanitizer equals the same run without it, bit
  for bit, in each package, and the two packages agree to the plain step's
  tolerance (``32 * eps * max(|ref|, 1)`` a step, tests/test_torch_cli.py);
* a blow-up (heat2d with an unstable ``alpha``, as tests/test_debug_checks.py)
  raises in both with the same message naming the same step: unsharded, on
  ``--mesh 2,2``, chunked by ``--log-every 2``, and as 2 processes under
  gloo (the port; against the JAX package's one-process message);
* ``--debug-checks --fuse 4``, and ``--tol`` with any of the three flags,
  are refused alike;
* the dump files carry the JAX CLI's names and bytes: Life (int32) and
  heat2d in bfloat16 byte for byte, CLI to CLI; heat3d float32 byte for byte
  through the writer on the same state (the two plain float32 steps differ
  in the last place, within tolerance), and each port dump equals the
  port's state at its step.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax.experimental import checkify

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.config import RunConfig as JRunConfig

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import native as tnative

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
TIMEOUT = 120  # seconds, each subprocess

# (id, RunConfig fields): the placements of the sanitizers
PLACES = [
    ("unsharded", {}),
    ("mesh22", {"mesh": (2, 2)}),
    ("chunked", {"log_every": 2}),
]
# heat2d alpha: 1e38 overflows on the first update (step 0); 1e9 grows
# the hot walls' neighbours by ~4e9 a step and overflows later
BLOWUPS = [1e38, 1e9]


def _bits(a):
    """The raw words of a field (bfloat16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _port(fields):
    """The port's final fields as whole host arrays."""
    from mpi_cuda_process_tpu_torch.parallel import stepper

    if stepper.is_sharded(fields):
        fields = stepper.gather_fields(fields, device="cpu")
    return [_bits(f) for f in fields]


def _run_port(monkeypatch, **kw):
    if kw.get("mesh"):
        monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    fields, _ = tcli.run(RunConfig(device="cpu", **kw))
    return _port(fields)


def _run_jax(**kw):
    fields, _ = jcli.run(JRunConfig(**kw))
    return [_bits(f) for f in fields]


_HEALTHY = dict(stencil="heat3d", grid=(8, 8, 16), iters=6, seed=2,
                init="pulse")


@pytest.mark.parametrize("flag", ["check_finite", "debug_checks"])
@pytest.mark.parametrize("place,extra", PLACES, ids=[p for p, _ in PLACES])
def test_healthy_run_equals_plain_run(monkeypatch, flag, place, extra):
    """A sanitizer observes and changes nothing: its run equals the same
    run without it, bit for bit, in each package; the packages agree."""
    on = {flag: 2 if flag == "check_finite" else True}
    plain_t = _run_port(monkeypatch, **_HEALTHY, **extra)
    checked_t = _run_port(monkeypatch, **_HEALTHY, **extra, **on)
    plain_j = _run_jax(**_HEALTHY, **extra)
    checked_j = _run_jax(**_HEALTHY, **extra, **on)
    for a, b in zip(plain_t, checked_t):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plain_j, checked_j):
        np.testing.assert_array_equal(a, b)
    for t, j in zip(checked_t, checked_j):
        scale = max(float(np.abs(j).max()), 1.0)
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=32 * EPS32 * scale * 6)


def _message(fn):
    """The error a run raises; JAX's checkify appends its own suffix."""
    with pytest.raises((RuntimeError, checkify.JaxRuntimeError)) as ei:
        fn()
    return str(ei.value).removesuffix(" (`check` failed)")


@pytest.mark.parametrize("alpha", BLOWUPS)
@pytest.mark.parametrize("flag", ["check_finite", "debug_checks"])
@pytest.mark.parametrize("place,extra", PLACES, ids=[p for p, _ in PLACES])
def test_blowup_names_the_same_step(monkeypatch, flag, place, extra, alpha):
    on = {flag: 3 if flag == "check_finite" else True}
    cfg = dict(stencil="heat2d", grid=(16, 16), iters=10,
               params={"alpha": alpha}, **extra, **on)
    got = _message(lambda: _run_port(monkeypatch, **cfg))
    want = _message(lambda: _run_jax(**cfg))
    assert got == want
    assert ("non-finite after step" in got) == (flag == "debug_checks")
    if alpha == 1e38:
        assert ("after step 0 " in got) or ("between steps 0 and 3" in got)


def test_checked_runner_names_first_failing_step():
    """The JAX package's unit cases: 1e10^k overflows float32 at step 3,
    the step index is absolute, and a healthy state passes."""
    def step(fields):
        return (fields[0] * 1e10,)

    runner = tdriver.make_checked_runner(step, 8)
    with pytest.raises(RuntimeError, match="non-finite after step 3 "):
        runner((torch.full((4, 4), 1.0),))
    with pytest.raises(RuntimeError, match="non-finite after step 103 "):
        runner((torch.full((2, 2), 1.0),), start=100)
    jrun = jdriver.make_checked_runner(step, 8)
    import jax.numpy as jnp

    with pytest.raises(checkify.JaxRuntimeError,
                       match="non-finite after step 103 "):
        jrun((jnp.full((2, 2), 1.0, jnp.float32),), start=100)
    half = tdriver.make_checked_runner(lambda f: (f[0] * 0.5,), 4)
    out = half((torch.full((4, 4), 16.0),))
    assert torch.equal(out[0], torch.full((4, 4), 1.0))


def test_checked_runner_threads_a_pipelined_step():
    """A slab-carry pipelined step goes through ``pipeline_hooks``: seeded
    once a call, its carry threaded, the last pass posting nothing."""
    calls = []

    class Carry:
        def wait(self):
            calls.append("drop")

    def step(fields):
        raise AssertionError("a pipelined step runs through its hooks")

    def prologue(fields):
        calls.append("seed")
        return Carry()

    def body(fields, carry, post_next):
        calls.append(post_next)
        return (fields[0] + 1.0,), Carry() if post_next else None

    step._pipeline_active = True
    step._pipeline_prologue = prologue
    step._pipeline_body = body
    out = tdriver.make_checked_runner(step, 3)((torch.zeros(2, 2),), 0)
    assert torch.equal(out[0], torch.full((2, 2), 3.0))
    assert calls == ["seed", True, True, False]


def test_checked_runner_keeps_int_fields_unchecked():
    runner = tdriver.make_checked_runner(lambda f: (f[0] + 1,), 3)
    out = runner((torch.zeros(4, 4, dtype=torch.int32),))
    assert out[0].dtype == torch.int32 and int(out[0][0, 0]) == 3


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


_MP = ("--stencil", "heat2d", "--grid", "16,16", "--iters", "10",
       "--mesh", "2", "--param", "alpha=1e9", "--device", "cpu")


@pytest.fixture(scope="module")
def two_processes():
    """Each sanitizer's blow-up as 2 processes under gloo, both launches
    at once: {flag: [(return code, stderr), ...]}."""
    flags = {"debug_checks": ("--debug-checks",),
             "check_finite": ("--check-finite", "3", "--log-every", "2")}
    procs = {}
    for name, extra in flags.items():
        port = _free_port()
        procs[name] = [subprocess.Popen(
            [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *_MP,
             *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=_REPO,
            env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=r,
                     WORLD_SIZE=2, LOCAL_RANK=r, LOCAL_WORLD_SIZE=2))
            for r in range(2)]
    out = {}
    try:
        for name, ps in procs.items():
            out[name] = []
            for p in ps:
                _, err = p.communicate(timeout=TIMEOUT)
                out[name].append((p.returncode, err))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return out


@pytest.mark.parametrize("flag", ["check_finite", "debug_checks"])
def test_two_processes_raise_the_same_step(two_processes, flag):
    """Across processes the first failing step is agreed over the gloo
    group: both processes raise the one-process JAX run's message."""
    on = {"check_finite": 3, "log_every": 2} if flag == "check_finite" \
        else {"debug_checks": True}
    want = _message(lambda: _run_jax(
        stencil="heat2d", grid=(16, 16), iters=10, mesh=(2,),
        params={"alpha": 1e9}, **on))
    for rc, err in two_processes[flag]:
        assert rc != 0
        assert f"RuntimeError: {want}" in err, err[-2000:]


def test_debug_checks_excludes_fuse_and_tol_alike():
    for run, cfg in ((jcli.run, JRunConfig), (tcli.run, RunConfig)):
        kw = {"device": "cpu"} if cfg is RunConfig else {}
        with pytest.raises(ValueError, match="--debug-checks excludes "
                                             "--fuse"):
            run(cfg(stencil="heat2d", grid=(32, 32), iters=8, fuse=4,
                    debug_checks=True, **kw))
        for extra in ({"debug_checks": True}, {"check_finite": 2},
                      {"dump_every": 2, "dump_dir": "unused"}):
            with pytest.raises(ValueError, match="--tol runs inside"):
                run(cfg(stencil="heat2d", grid=(16, 16), iters=8, tol=1e-3,
                        **extra, **kw))


# ---- --dump-every -----------------------------------------------------------

_DUMPS = [
    ("heat3d_f32", dict(stencil="heat3d", grid=(8, 8, 16), init="pulse")),
    ("life_i32", dict(stencil="life", grid=(16, 16), init="random",
                      density=0.3, seed=7)),
    ("heat2d_bf16", dict(stencil="heat2d", grid=(16, 16),
                         dtype="bfloat16")),
]


@pytest.mark.parametrize("name,cfg", _DUMPS, ids=[n for n, _ in _DUMPS])
def test_dumps_match_the_jax_cli(tmp_path, name, cfg):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(iters=6, dump_every=2, **cfg)
    jcli.run(JRunConfig(dump_dir=jdir, **kw))
    fields, _ = tcli.run(RunConfig(dump_dir=tdir, device="cpu", **kw))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == [
        f"step_{s:08d}.npy" for s in (2, 4, 6)]
    for n in names:
        with open(os.path.join(jdir, n), "rb") as fh:
            jbytes = fh.read()
        with open(os.path.join(tdir, n), "rb") as fh:
            tbytes = fh.read()
        if name != "heat3d_f32":
            assert tbytes == jbytes
            continue
        # the packages' float32 plain steps differ in the last place: the
        # same header and size, values within tolerance, and the port's
        # writer given the JAX state writes the JAX file
        j, t = np.load(os.path.join(jdir, n)), np.load(os.path.join(tdir, n))
        assert len(tbytes) == len(jbytes)
        assert tbytes[:128] == jbytes[:128]
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=32 * EPS32 * 100.0 * 6)
        again = str(tmp_path / f"again_{n}")
        tnative.async_write_npy(again, torch.from_numpy(j))
        tnative.wait_all()
        with open(again, "rb") as fh:
            assert fh.read() == jbytes
    # the last dump is the port's final state, bit for bit
    with open(os.path.join(tdir, names[-1]), "rb") as fh:
        last = fh.read()
    arr, descr = tnative.host_array(fields[0])
    assert last.endswith(arr.tobytes()) and f"'{descr}'" in last[:128].decode(
        "latin-1")


def test_sharded_dumps_equal_unsharded(tmp_path, monkeypatch):
    kw = dict(stencil="heat3d", grid=(8, 8, 16), init="pulse", iters=4,
              dump_every=2, device="cpu")
    tcli.run(RunConfig(dump_dir=str(tmp_path / "one"), **kw))
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    tcli.run(RunConfig(dump_dir=str(tmp_path / "four"), mesh=(2, 2), **kw))
    for n in ("step_00000002.npy", "step_00000004.npy"):
        a = (tmp_path / "one" / n).read_bytes()
        assert a == (tmp_path / "four" / n).read_bytes()


def test_dump_cadence_joins_the_chunking_and_fuse_rule():
    """The dump cadence joins the callback's interval (gcd), and under
    --fuse it must be a multiple of k, as in the JAX CLI."""
    for run, cfg in ((jcli.run, JRunConfig), (tcli.run, RunConfig)):
        kw = {"device": "cpu"} if cfg is RunConfig else {}
        with pytest.raises(ValueError, match="intervals must be multiples"):
            run(cfg(stencil="heat3d", grid=(16, 16, 128), iters=8, fuse=4,
                    dump_every=2, dump_dir="unused", **kw))


def test_dump_refused_across_processes():
    m = tmesh.Mesh((2,), [torch.device("cpu")], process=0, processes=2,
                   backend="gloo")
    cfg = RunConfig(stencil="heat2d", grid=(16, 16), mesh=(2,),
                    dump_every=2, dump_dir="d", device="cpu")
    with pytest.raises(ValueError, match="--dump-every writes field 0"):
        tcli._refuse_multiprocess(cfg, m)


def test_native_writer_builds_and_matches_numpy(tmp_path):
    assert tnative.available()
    lib = tnative._so_path()
    assert os.path.dirname(lib) == os.path.join(_REPO, "native", "build")
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    tnative.async_write_npy(str(tmp_path / "a.npy"), a)
    tnative.wait_all()
    np.save(tmp_path / "b.npy", a)
    assert (tmp_path / "a.npy").read_bytes() == \
        (tmp_path / "b.npy").read_bytes()
    b16 = torch.tensor([[1.0, -2.5], [3.0, 0.0]], dtype=torch.bfloat16)
    words, descr = tnative.host_array(b16)
    assert descr == "<V2" and words.dtype == np.uint16
    np.testing.assert_array_equal(words, b16.view(torch.int16).numpy()
                                  .view(np.uint16))


def test_checked_runner_leaves_its_input_and_takes_a_donated_one():
    """The checked runner writes no field it is given, and takes Donated
    fields as make_runner does, with the same result."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    before = x.clone()
    runner = tdriver.make_checked_runner(lambda f: (f[0] * 0.5 + 1,), 4)
    out = runner((x,), 0)
    assert torch.equal(x, before)
    gift = tdriver.Donated((x.clone(),))
    assert torch.equal(runner(gift, 0)[0], out[0])
    with pytest.raises(RuntimeError, match="already taken"):
        gift.take()
    plain = tdriver.make_runner(lambda f: (f[0] * 0.5 + 1,), 4)((x,))
    assert torch.equal(plain[0], out[0])
