"""The PyTorch port's op layer, driver and utilities against the JAX package.

The same inputs (numpy, from a seed) go through the JAX function and its
counterpart in ``mpi_cuda_process_tpu_torch`` on the CPU.  Float results are
held to ``32 * eps * max(|ref|, 1)`` (the raw-step tolerance of
tests/test_rawstep.py: the two frameworks may round a sum differently);
guard-frame cells must match exactly.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.utils import checkpointing as jckpt
from mpi_cuda_process_tpu.utils import diagnostics as jdiag
from mpi_cuda_process_tpu.utils import render as jrender
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import fields_from_numpy, fields_to_numpy
from mpi_cuda_process_tpu_torch.ops import stencil as tstencil
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt
from mpi_cuda_process_tpu_torch.utils import diagnostics as tdiag
from mpi_cuda_process_tpu_torch.utils import render as trender
from mpi_cuda_process_tpu_torch.utils.init import init_state as tinit_state

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
STENCILS = ["heat2d", "mdf", "heat3d", "heat3d4th", "heat3d27", "wave2d",
            "wave3d", "advect2d", "advect3d", "grayscott2d", "grayscott3d"]
GRIDS = {2: (16, 20), 3: (10, 12, 14)}


def _fields(st, grid, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def assert_close(got, ref, halo=None, atol=None):
    """``got`` (tensors) vs ``ref`` (arrays): tolerance + exact frame."""
    for g, r in zip(got, ref):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        r = np.asarray(r, dtype=np.float32)
        tol = atol if atol is not None else \
            32 * EPS32 * max(float(np.max(np.abs(r))), 1.0)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)
        if halo:
            for d in range(r.ndim):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * r.ndim
                    idx[d] = sl
                    np.testing.assert_array_equal(g[tuple(idx)],
                                                  r[tuple(idx)])


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name", STENCILS)
def test_make_step_matches_jax(name, periodic, steps):
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    grid = GRIDS[tst.ndim]
    arrays = _fields(tst, grid, seed=len(name) + steps)
    jstep = jdriver.make_step(jst, grid, periodic=periodic)
    tstep = tdriver.make_step(tst, grid, periodic=periodic)
    a = tuple(jnp.asarray(x) for x in arrays)
    b = fields_from_numpy(arrays, device="cpu")
    for _ in range(steps):
        a, b = jstep(a), tstep(b)
    assert_close(b, a, halo=None if periodic else tst.halo)


def test_wave_carry_is_the_old_tensor():
    st = port.make_stencil("wave3d")
    f = fields_from_numpy(_fields(st, (8, 8, 8), 0), device="cpu")
    new = tdriver.make_step(st, (8, 8, 8))(f)
    assert new[1] is f[0]  # carry_map: the new u_prev is the old u, no copy


def test_registry_and_stencil_fields_match_jax():
    # life (int32) is held field by field in tests/test_torch_2d.py
    # sor2d and sor3d (multi-phase) are held field by field in
    # tests/test_torch_sor.py
    assert port.available_stencils() == sorted(
        STENCILS + ["life", "sor2d", "sor3d"]) and set(STENCILS) <= set(
        __import__("mpi_cuda_process_tpu").available_stencils())
    for name in STENCILS:
        j, t = jmake_stencil(name), port.make_stencil(name)
        for f in ("ndim", "halo", "num_fields", "bc_value", "params",
                  "field_halos", "mask_fields", "carry_map",
                  "parity_sensitive"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.dtype == torch.float32 and t.phases is None
        # advection and Gray-Scott register no invariant on either side
        assert (t.invariant is None) == (j.invariant is None), name
        if j.invariant is None:
            continue
        assert t.invariant.name == j.invariant.name
        assert (t.invariant.rtol, t.invariant.mode, t.invariant.scale) == (
            j.invariant.rtol, j.invariant.mode, j.invariant.scale)
    with pytest.raises(KeyError) as te:
        port.make_stencil("nope")
    assert "unknown stencil 'nope'" in str(te.value)
    st = port.make_stencil("heat3d", dtype="bfloat16", alpha=0.1)
    assert st.dtype == torch.bfloat16 and st.params["alpha"] == 0.1


@pytest.mark.parametrize("name", ["heat3d", "wave2d"])
def test_invariants_match_jax(name):
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    arrays = _fields(tst, GRIDS[tst.ndim], 7)
    jv = float(jst.invariant.fn(tuple(jnp.asarray(x) for x in arrays)))
    tv = float(tst.invariant.fn(fields_from_numpy(arrays, device="cpu")))
    assert tv == pytest.approx(jv, rel=1e-5)


def test_shifted_interior_laplacian_match_jax():
    from mpi_cuda_process_tpu.ops import stencil as jstencil

    x = np.random.default_rng(1).random((9, 10, 11), dtype=np.float32)
    t = torch.from_numpy(x)
    for off in ((1, -1, 0), (0, 0, 1), (-1, -1, -1)):
        np.testing.assert_array_equal(
            tstencil.shifted(t, off, 1).numpy(),
            np.asarray(jstencil.shifted(jnp.asarray(x), off, 1)))
    ju, jl = jstencil.axis_laplacian(jnp.asarray(x), 3)
    tu, tl = tstencil.axis_laplacian(t, 3)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=32 * EPS32 * 8)


@pytest.mark.parametrize("grid,offsets,width", [
    ((6, 7), (0, 0), 1), ((5, 6, 7), (0, 0, 0), 2),
    ((4, 6, 5), (3, 0, 2), 1)])
def test_frame_mask_matches_jax(grid, offsets, width):
    gshape = tuple(g + 4 for g in grid)
    j = np.asarray(jdriver.frame_mask(grid, gshape, offsets, width))
    t = tdriver.frame_mask(grid, gshape, offsets, width, "cpu").numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kind", ["zero", "pulse", "auto"])
@pytest.mark.parametrize("name", ["heat2d", "heat3d4th", "wave3d"])
@pytest.mark.parametrize("periodic", [False, True])
def test_init_state_matches_jax(name, kind, periodic):
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    grid = GRIDS[tst.ndim]
    a = jinit_state(jst, grid, 0, 0.15, kind, periodic=periodic)
    b = tinit_state(tst, grid, 0, kind=kind, periodic=periodic,
                    device="cpu")
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(y.shape) == grid and y.dtype == torch.float32
    assert_close(b, a, halo=None if periodic else tst.halo)


@pytest.mark.parametrize("kind", ["random", "patch"])
def test_random_init_kinds_raise_with_roadmap_item(kind):
    """Both random kinds are ported (the name is kept from when they raised
    naming ROADMAP A2) and give the JAX package's bits; ``patch`` on a
    one-field stencil raises the JAX package's own ValueError."""
    st = port.make_stencil("heat2d")
    if kind == "patch":
        with pytest.raises(ValueError) as je:
            jinit_state(jmake_stencil("heat2d"), (8, 8), 3, 0.15, kind)
        with pytest.raises(ValueError) as te:
            tinit_state(st, (8, 8), kind=kind, device="cpu")
        assert str(te.value) == str(je.value)
        got = tinit_state(port.make_stencil("grayscott2d"), (8, 8), 3,
                          kind=kind, device="cpu")
        ref = jinit_state(jmake_stencil("grayscott2d"), (8, 8), 3, 0.15,
                          kind)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        return
    got = tinit_state(st, (8, 8), 3, kind=kind, device="cpu")
    ref = jinit_state(jmake_stencil("heat2d"), (8, 8), 3, 0.15, kind)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_runner_and_run_until_match_jax():
    name, grid = "heat2d", (12, 12)
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    b = tinit_state(tst, grid, kind="zero", device="cpu")
    # the JAX runners donate their input: a fresh state for each call
    ja = jdriver.make_runner(jdriver.make_step(jst, grid), 7)(
        jinit_state(jst, grid, 0, 0.15, "zero"))
    tb = tdriver.make_runner(tdriver.make_step(tst, grid), 7)(b)
    assert_close(tb, ja, halo=1)
    a = jinit_state(jst, grid, 0, 0.15, "zero")
    jf, jn, jres = jdriver.run_until(jdriver.make_step(jst, grid), a, 1.0,
                                     500, check_every=5)
    tf, tn, tres = tdriver.run_until(tdriver.make_step(tst, grid), b, 1.0,
                                     500, check_every=5)
    assert tn == jn and tres == pytest.approx(jres, rel=1e-4, abs=1e-5)
    assert_close(tf, jf, halo=1, atol=1e-3)
    with pytest.raises(ValueError):
        tdriver.run_until(tdriver.make_step(tst, grid), b, 1.0, 5,
                          check_every=0)


def test_run_simulation_callback_contract_matches_jax():
    """Chunk boundaries align to absolute multiples of log_every, resumed
    runs keep the cadence, and a returned replacement is carried forward."""
    name, grid = "heat2d", (10, 10)
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    seen = {"jax": [], "torch": []}

    def cb(key):
        def callback(done, fs):
            seen[key].append(done)
            return None
        return callback

    a = jinit_state(jst, grid, 0, 0.15, "zero")
    b = tinit_state(tst, grid, kind="zero", device="cpu")
    ja = jdriver.run_simulation(jst, a, 11, log_every=4, callback=cb("jax"),
                                start_step=3)
    tb = tdriver.run_simulation(tst, b, 11, log_every=4,
                                callback=cb("torch"), start_step=3)
    assert seen["torch"] == seen["jax"] == [1, 5, 9, 11]
    assert_close(tb, ja, halo=1)

    class Obs:
        def __init__(self):
            self.chunks = []

        def begin_chunk(self):
            pass

        def record_chunk(self, n, secs):
            self.chunks.append(n)

    obs = Obs()
    zeroed = tdriver.run_simulation(
        tst, b, 6, log_every=3, observer=obs,
        callback=lambda done, fs: tuple(torch.zeros_like(f) for f in fs)
        if done == 6 else None)
    assert obs.chunks == [3, 3] and float(zeroed[0].abs().max()) == 0.0


def test_interop_roundtrip_and_bfloat16():
    arrays = _fields(port.make_stencil("wave2d"), (5, 6), 3)
    t = fields_from_numpy(arrays, device="cpu")
    back = fields_to_numpy(t)
    for x, y in zip(arrays, back):
        np.testing.assert_array_equal(x, y)
    # a read-only array (as a JAX array hands over) becomes a tensor that
    # owns a copy: writing to it leaves the caller's array alone
    ro = np.array(arrays[0])
    ro.flags.writeable = False
    own = fields_from_numpy([ro], device="cpu")[0]
    own += 1.0
    np.testing.assert_array_equal(ro, arrays[0])
    ml = pytest.importorskip("ml_dtypes")
    bf = np.asarray(jnp.asarray(arrays[0], jnp.bfloat16))
    tb = fields_from_numpy([bf], device="cpu")[0]
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), bf.astype(np.float32))
    again = fields_to_numpy((tb,))[0]
    assert again.dtype == ml.bfloat16
    np.testing.assert_array_equal(again.view(np.uint16), bf.view(np.uint16))
    cast = fields_from_numpy(arrays, device="cpu", dtype="float64")
    assert cast[0].dtype == torch.float64


def test_checkpoints_cross_between_packages(tmp_path):
    arrays = _fields(port.make_stencil("wave2d"), (6, 7), 4)
    p_t, p_j = str(tmp_path / "t"), str(tmp_path / "j")
    tckpt.save_checkpoint(p_t, fields_from_numpy(arrays, device="cpu"), 12,
                          {"stencil": "wave2d"})
    jf, jstep, jcfg = jckpt.load_checkpoint(p_t)
    assert jstep == 12 and jcfg == {"stencil": "wave2d"}
    for x, y in zip(jf, arrays):
        np.testing.assert_array_equal(x, y)
    jckpt.save_checkpoint(p_j, tuple(jnp.asarray(x) for x in arrays), 5)
    assert tckpt.checkpoint_format(p_j) == "npy"
    assert tckpt.latest_step(p_j) == 5
    tf, tstep, _ = tckpt.load_any(p_j)
    assert tstep == 5
    for x, y in zip(tf, arrays):
        np.testing.assert_array_equal(x, y)
    # overwrite in place keeps exactly one good checkpoint
    tckpt.save_checkpoint(p_j, fields_from_numpy(arrays, device="cpu"), 9)
    assert tckpt.latest_step(p_j) == 9
    assert sorted(os.listdir(tmp_path)) == ["j", "t"]
    with pytest.raises(FileNotFoundError):
        tckpt.load_any(str(tmp_path / "missing"))
    os.makedirs(tmp_path / "orb" / "step_000000000004")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tckpt.load_any(str(tmp_path / "orb"))


@pytest.mark.parametrize("name,with_step", [("heat3d", True),
                                            ("wave2d", False)])
def test_diagnostics_match_jax(name, with_step):
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    grid = GRIDS[tst.ndim]
    arrays = _fields(tst, grid, 9)
    jd = jdiag.field_diagnostics(
        jst, tuple(jnp.asarray(x) for x in arrays),
        step_fn=jdriver.make_step(jst, grid) if with_step else None)
    td = tdiag.field_diagnostics(
        tst, fields_from_numpy(arrays, device="cpu"),
        step_fn=tdriver.make_step(tst, grid) if with_step else None)
    assert list(td) == list(jd)
    for k in jd:
        assert td[k] == pytest.approx(jd[k], rel=1e-5, abs=1e-6), k
    assert tdiag.format_diagnostics(td) == jdiag.format_diagnostics(
        {k: td[k] for k in jd})


def test_render_is_a_copy():
    x = np.random.default_rng(2).random((7, 9, 11)).astype(np.float32)
    assert trender.ascii_render(x) == jrender.ascii_render(x)
    life = (x[0] > 0.5).astype(np.int32)
    assert trender.ascii_render(life) == jrender.ascii_render(life)


PORT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mpi_cuda_process_tpu_torch")


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ["mpi_cuda_process_tpu_torch"] + sorted(
        "mpi_cuda_process_tpu_torch." + os.path.relpath(
            os.path.join(d, f), PORT_DIR)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for d, _, fs in os.walk(PORT_DIR) for f in fs
        if f.endswith(".py") and f != "__main__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'mpi_cuda_process_tpu' or "
              "m.startswith('mpi_cuda_process_tpu.')]\n"
              "assert not bad, bad\nprint(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(PORT_DIR),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(r"\bjax\b|\bmpi_cuda_process_tpu\b")
    hits = []
    for d, _, fs in os.walk(PORT_DIR):
        for f in fs:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(d, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits
