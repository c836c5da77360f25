"""The streaming k-step kernel (K10, TPU table rows 16-18) and the port's
repairs C1 (bfloat16 checkpoints) and C3 (the step's carry), against the
JAX package.

The JAX package's streaming kernels run as its own tests run them, with
``interpret=True`` (tests/test_streamfused.py, tests/test_twoaxis_stream.py),
its sharded steps on the 8 virtual CPU devices of tests/conftest.py; the
port's wrappers take their plain versions for CPU tensors
(tests/test_torch_cuda.py holds the kernel to them on the card).  Inputs are
numpy arrays from a seed, handed to both.  Tolerance: ``atol = 1e-4,
rtol = 0``, frame cells exact (tests/test_streamfused.py:21: the kernels
reorder taps); ``--overlap`` equals the non-split step bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import streamfused as jstream
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                fields_to_numpy,
                                                gather_to_numpy,
                                                shard_from_numpy)
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

from test_torch_cli import _assert_match, _run_both

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID = (24, 32, 128)      # tests/test_streamfused.py's grid
MESH_GRID = (48, 32, 128)  # tests/test_twoaxis_stream.py's grid
FAMILIES = [("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2), ("wave3d", 4)]


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _seeded(n, shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(shape, dtype=np.float32) for _ in range(n))


def _close(got, ref, halo=None):
    """atol 1e-4, rtol 0; frame cells (``halo`` wide) exactly equal."""
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        if halo:
            frame = tdriver.frame_mask(r.shape, r.shape, (0,) * r.ndim, halo,
                                       device=CPU).numpy()
            np.testing.assert_array_equal(g[frame], r[frame])


def _port(arrays):
    return fields_from_numpy(arrays, device=CPU)


def _numpy(fields):
    return tuple(f.numpy() for f in fields)


# ---- row 16: the whole grid ------------------------------------------------

@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("name,k", FAMILIES)
def test_stream_fused_step_matches_jax(name, k, passes):
    """The port's make_stream_fused_step == the JAX package's (interpret),
    one and two passes."""
    st = port.make_stencil(name)
    arrays = _seeded(st.num_fields, GRID, 40 + k)
    jstep = jstream.make_stream_fused_step(jmake_stencil(name), GRID, k,
                                           interpret=True)
    assert jstep is not None
    tstep = tstream.make_stream_fused_step(st, GRID, k)
    jf, tf = tuple(jnp.asarray(a) for a in arrays), _port(arrays)
    tstream.launches.clear()
    for _ in range(passes):
        jf, tf = jstep(jf), tstep(tf)
    assert not tstream.launches  # CPU tensors never launch
    _close(_numpy(tf), [np.asarray(x) for x in jf], st.halo)


def test_stream_builders_gate_like_jax_and_drop_tpu_rules():
    """None for what the JAX builders decline structurally (periodic, a
    local extent below m, a 2D stencil); the TPU strip rules are dropped,
    so shapes JAX declines run, and the policy knobs raise by name."""
    st = port.make_stencil("heat3d")
    assert tstream.stream_supported(st)
    assert not tstream.stream_supported(port.make_stencil("heat2d"))
    assert tstream.build_stream_sharded_call(st, (8, 16, 128), (16, 16, 128),
                                             4, periodic=True) is None
    assert tstream.build_stream_2axis_call(st, (8, 16, 128), (16, 32, 128),
                                           4, periodic=True) is None
    assert tstream.build_stream_sharded_call(st, (3, 16, 128), (6, 16, 128),
                                             4) is None
    assert tstream.build_stream_2axis_call(st, (8, 3, 128), (16, 6, 128),
                                           4) is None
    assert tstream.make_stream_fused_step(st, (16, 16), 4) is None
    assert tstream.make_stream_fused_step(st, GRID, 13) is None  # smem
    # fewer than 3 z chunks, or no y strip that divides Y = 20: JAX
    # declines, the port runs
    jst = jmake_stencil("heat3d")
    for grid, k in (((16, 32, 128), 4), ((24, 20, 130), 3)):
        assert jstream.make_stream_fused_step(jst, grid, k,
                                              interpret=True) is None
        arrays = _seeded(1, grid, 5)
        got = tstream.make_stream_fused_step(st, grid, k)(_port(arrays))
        step = tdriver.make_step(st, grid)
        ref = _port(arrays)
        for _ in range(k):
            ref = step(ref)
        _close(_numpy(got), _numpy(ref), st.halo)
    for kw, item in (({"tiles": (8, 16)}, "A8"), ({"margin": 8}, "A8"),
                     ({"order": "rev"}, "A8")):
        with pytest.raises(NotImplementedError, match=item):
            tstream.make_stream_fused_step(st, GRID, 4, **kw)
    # batch (an ensemble, ROADMAP A7) runs: the step takes N members, each
    # advanced as the unbatched step advances it
    batch = _port(_seeded(1, (2,) + GRID, 5))
    got = tstream.make_stream_fused_step(st, GRID, 4, batch=2)(batch)
    single = tstream.make_stream_fused_step(st, GRID, 4)
    assert tuple(got[0].shape) == (2,) + GRID
    for i in range(2):
        assert torch.equal(got[0][i], single((batch[0][i],))[0])


# ---- rows 17 and 18: the sharded calls ---------------------------------------

ORIGINS = [0, 1, 2]  # low wall, interior and high wall shard of three


@pytest.mark.parametrize("shard", ORIGINS, ids=["low", "interior", "high"])
@pytest.mark.parametrize("name,k", FAMILIES)
def test_stream_sharded_call_matches_jax(name, k, shard):
    """Row 17: the port's build_stream_sharded_call == the JAX package's on
    the same core and z slabs, at a wall and an interior z origin of a
    3-shard z column."""
    st = port.make_stencil(name)
    m = k * st.halo
    local = (24, 32, 128)
    gshape = (3 * local[0],) + local[1:]
    nf = st.num_fields
    rng = np.random.default_rng(60 + k)
    shapes = (local, (m,) + local[1:], (m,) + local[1:])
    arrays = [rng.random(s, dtype=np.float32) for _ in range(nf)
              for s in shapes]
    oz = shard * local[0]
    jbuilt = jstream.build_stream_sharded_call(jmake_stencil(name), local,
                                               gshape, k, interpret=True)
    assert jbuilt is not None and jbuilt[1:] == (m, nf)
    ref = jbuilt[0](jnp.array([oz, 0], dtype=jnp.int32),
                    *(jnp.asarray(a) for a in arrays))
    call, tm, tnf = tstream.build_stream_sharded_call(st, local, gshape, k)
    assert (tm, tnf) == (m, nf)
    got = call(oz, *_port(arrays))
    _close(_numpy(got), [np.asarray(r) for r in ref])


@pytest.mark.parametrize("shard", ORIGINS, ids=["low", "interior", "high"])
@pytest.mark.parametrize("name,k", FAMILIES)
def test_stream_2axis_call_matches_jax(name, k, shard):
    """Row 18: the port's build_stream_2axis_call == the JAX package's on
    the same natural-width core, slabs and corners (the TPU call pads the y
    pieces itself), at the low-wall, interior and high-wall shard of a 3x3
    (z, y) grid of shards."""
    st = port.make_stencil(name)
    m = k * st.halo
    Lz, Ly, X = local = (24, 16, 128)
    gshape = (3 * Lz, 3 * Ly, X)
    shapes = (local, (m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X),
              (m, m, X), (m, m, X), (m, m, X), (m, m, X))
    rng = np.random.default_rng(70 + k)
    arrays = [rng.random(s, dtype=np.float32)
              for _ in range(st.num_fields) for s in shapes]
    origins = (shard * Lz, shard * Ly)
    jbuilt = jstream.build_stream_2axis_call(jmake_stencil(name), local,
                                             gshape, k, interpret=True)
    assert jbuilt is not None and jbuilt[1] == m
    ref = jbuilt[0](jnp.array(origins, dtype=jnp.int32),
                    *(jnp.asarray(a) for a in arrays))
    call, tm, _ = tstream.build_stream_2axis_call(st, local, gshape, k)
    assert tm == m
    got = call(origins, *_port(arrays))
    _close(_numpy(got), [np.asarray(r) for r in ref])


# ---- the sharded step: kind="stream" ----------------------------------------

def _jax_sharded(name, mesh_shape, k, arrays, calls=2):
    jm = jmesh.make_mesh(mesh_shape)
    step = jstepper.make_sharded_fused_step(
        jmake_stencil(name), jm, MESH_GRID, k, interpret=True, kind="stream")
    assert step is not None
    f = jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays), jm, 3)
    jf = jax.jit(step)
    for _ in range(calls):
        f = jf(f)
    return step, tuple(np.asarray(x) for x in f)


STEP_CASES = [("heat3d", 4, (2, 1, 1)), ("heat3d", 4, (2, 2, 1)),
              ("heat3d", 4, (1, 2, 1)), ("wave3d", 4, (2, 2, 1)),
              ("heat3d4th", 2, (2, 1, 1))]


@pytest.mark.parametrize(
    "name,k,mesh_shape", STEP_CASES,
    ids=[f"{n}-k{k}-{'x'.join(map(str, m))}" for n, k, m in STEP_CASES])
def test_sharded_stream_step_matches_jax_and_unsharded(name, k, mesh_shape):
    """make_sharded_temporal_step(kind="stream") on z-only, (z, y) and
    y-only meshes == the JAX package's make_sharded_fused_step(kind=
    "stream") and the port's unsharded stream step, two calls; with
    overlap=True bit-equal to overlap=False."""
    st = port.make_stencil(name)
    arrays = _seeded(st.num_fields, MESH_GRID, 80 + len(mesh_shape) + k)
    _, ref = _jax_sharded(name, mesh_shape, k, arrays)
    mesh = _mesh(mesh_shape)
    two_axis = mesh.counts(3)[1] > 1
    outs = []
    for overlap in (False, True):
        step = tstepper.make_sharded_temporal_step(
            st, mesh, MESH_GRID, k, kind="stream", overlap=overlap)
        assert step._padfree_kind == ("stream_yz" if two_axis else
                                      "stream_z")
        assert step._overlap_active is overlap
        f = shard_from_numpy(arrays, mesh)
        for _ in range(2):
            f = step(f)
        outs.append(gather_to_numpy(f))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    _close(outs[0], ref, st.halo)
    whole = tstream.make_stream_fused_step(st, MESH_GRID, k)
    tf = _port(arrays)
    for _ in range(2):
        tf = whole(tf)
    _close(outs[0], _numpy(tf), st.halo)


def test_sharded_stream_refusals():
    """Guard-frame only (None for periodic, as in JAX); the pipeline runs
    beside stream (tests/test_torch_pipeline.py) and refuses periodic with
    the TPU package's reason; the rdma exchange rides the stream kind
    (tests/test_torch_rdma.py) and raises the TPU package's error off it."""
    st = port.make_stencil("heat3d")
    for shape in ((2,), (2, 2)):
        assert tstepper.make_sharded_fused_step(
            st, _mesh(shape), MESH_GRID, 4, kind="stream",
            periodic=True) is None
        jm = jmesh.make_mesh(shape + (1,) * (3 - len(shape)))
        assert jstepper.make_sharded_fused_step(
            jmake_stencil("heat3d"), jm, MESH_GRID, 4, interpret=True,
            kind="stream", periodic=True) is None
    step = tstepper.make_sharded_fused_step(st, _mesh((2, 2)), MESH_GRID, 4,
                                            kind="stream", pipeline=True)
    assert step._pipeline_active and step._padfree_kind == "stream_yz"
    with pytest.raises(ValueError, match="guard-frame only"):
        tstepper.make_sharded_fused_step(st, _mesh((2, 2)), MESH_GRID, 4,
                                         kind="stream", pipeline=True,
                                         periodic=True)
    step = tstepper.make_sharded_fused_step(st, _mesh((2, 2)), MESH_GRID, 4,
                                            kind="stream", exchange="rdma")
    assert step._exchange == "rdma" and step._rdma_backend == "plain-ring"
    with pytest.raises(ValueError, match="streaming kernel family"):
        tstepper.make_sharded_fused_step(st, _mesh((2, 2)), MESH_GRID, 4,
                                         exchange="rdma")


# ---- both CLIs ---------------------------------------------------------------

CLI_RUNS = [("heat3d", []), ("wave3d", []), ("heat3d", ["--mesh", "2,2"]),
            ("heat3d", ["--mesh", "2,2", "--overlap"]),
            ("wave3d", ["--mesh", "2,2", "--overlap"])]


@pytest.mark.parametrize("name,flags", CLI_RUNS,
                         ids=[f"{n}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, fl in CLI_RUNS])
def test_cli_stream_matches_jax_cli(tmp_path, monkeypatch, name, flags):
    """--fuse 4 --fuse-kind stream through both CLIs, unsharded and on a
    2x2 mesh (4 virtual shards on each side): final fields at atol 1e-4,
    frame cells exact."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", ",".join(map(str, MESH_GRID)),
            "--iters", "8", "--checkpoint-every", "8", "--fuse", "4",
            "--fuse-kind", "stream", *flags]
    jf, jstep, tf, tstep, _ = _run_both(tmp_path, args, "stream")
    assert jstep == tstep == 8
    _assert_match(tf, jf, jmake_stencil(name).halo, 1e-4)


@pytest.mark.parametrize("flags", [[], ["--overlap"]])
def test_cli_stream_mesh4_matches_jax_unsharded(tmp_path, monkeypatch,
                                                flags):
    """--mesh 4 (z-only, local z = 12): the JAX CLI declines it (its strip
    rule wants 3 z chunks of >= 2m planes), the port runs it; its fields
    match the JAX CLI's unsharded stream run."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--grid", ",".join(map(str, MESH_GRID)),
            "--iters", "8", "--checkpoint-every", "8", "--fuse", "4",
            "--fuse-kind", "stream"]
    with pytest.raises(ValueError, match="unsupported"):
        jcli.main(base + ["--mesh", "4"])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "pt")
    assert jcli.main(base + ["--checkpoint-dir", jdir]) == 0
    assert tcli.main(base + ["--mesh", "4", *flags, "--checkpoint-dir", tdir,
                             "--device", "cpu"]) == 0
    jf, _, _ = jckpt.load_checkpoint(jdir)
    tf, _, tcfg = tckpt.load_checkpoint(tdir)
    assert tuple(tcfg["mesh"]) == (4,)
    _assert_match(tf, jf, 1, 1e-4)


@pytest.mark.parametrize("flags", [[], ["--mesh", "2,2"]])
def test_cli_stream_periodic_refused_in_both(monkeypatch, flags):
    """--periodic with --fuse-kind stream raises ValueError in both CLIs:
    guard-frame only unsharded, unsupported under --mesh."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "heat3d", "--grid", ",".join(map(str, MESH_GRID)),
            "--iters", "4", "--fuse", "4", "--fuse-kind", "stream",
            "--periodic", *flags]
    match = "unsupported" if flags else "guard-frame only"
    with pytest.raises(ValueError, match=match):
        jcli.main(args)
    with pytest.raises(ValueError, match=match):
        tcli.main(args + ["--device", "cpu"])


@pytest.mark.parametrize("flags", [[], ["--mesh", "2,2"]])
def test_cli_stream_bf16_refused_by_name(monkeypatch, flags):
    """bfloat16 on the stream kind runs (K10 takes it) and equals the
    port's plain bfloat16 run.  Under --mesh its --overlap runs too: the
    K3 shells would have m = 4, off bfloat16's alignment unit, so the step
    falls back to the non-split one, as in the JAX package, and equals the
    run without --overlap bit for bit.  Unsharded, --fuse 4 without the
    stream kind (K3) meets the JAX CLI's own refusal of that alignment.
    (The name is kept from when the stream kind itself refused bfloat16.)"""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--grid", "48,32,128", "--iters", "4",
            "--dtype", "bfloat16", "--device", "cpu", "--init", "random"]
    got, _ = tcli.run(tcli.config_from_args(
        base + ["--fuse", "4", "--fuse-kind", "stream", *flags]))
    if tstepper.is_sharded(got):
        got = tstepper.gather_fields(got)
    ref, _ = tcli.run(tcli.config_from_args(base))
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got[0].float().numpy(),
                               ref[0].float().numpy(), rtol=0, atol=1e-3)
    if flags:
        over, _ = tcli.run(tcli.config_from_args(
            base + ["--fuse", "4", "--fuse-kind", "stream", "--overlap",
                    *flags]))
        for a, b in zip(tstepper.gather_fields(over), got):
            assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="sublane tile — 8 for f32, "
                                             "16 for bf16"):
            tcli.main(base + ["--fuse", "4"])


# ---- C3: the step's carry ----------------------------------------------------

def test_dtype_changing_step_refused_in_both_clis():
    """heat2d on int32 fields: the update promotes them to float32; the
    JAX CLI's scan refuses the carry, and so does the port's time loop."""
    args = ["--stencil", "heat2d", "--grid", "32,32", "--iters", "4",
            "--dtype", "int32"]
    match = "carry input and carry output must have equal types"
    with pytest.raises(TypeError, match=match):
        jcli.main(args)
    with pytest.raises(TypeError, match=match):
        tcli.main(args + ["--device", "cpu"])


def test_runner_checks_the_carry_of_plain_and_sharded_steps():
    f = (torch.zeros(4, 4),)
    for bad in (lambda fs: (fs[0].double(),), lambda fs: (fs[0][:2],),
                lambda fs: fs + fs):
        with pytest.raises(TypeError, match="equal types"):
            tdriver.make_runner(bad, 2)(f)
    st = port.make_stencil("heat3d")
    mesh = _mesh((2, 2))
    sharded = shard_from_numpy(_seeded(1, (8, 8, 8), 1), mesh)
    step = tstepper.make_sharded_step(st, mesh, (8, 8, 8))
    out = tdriver.make_runner(step, 2)(sharded)
    assert tstepper.is_sharded(out) and out[0].global_shape == (8, 8, 8)


# ---- C1: bfloat16 npy checkpoints -------------------------------------------

BF16 = ["--stencil", "heat3d", "--grid", "16,16,32", "--dtype", "bfloat16",
        "--init", "pulse", "--checkpoint-every", "2"]


def _bits(arrays):
    """The raw 16-bit patterns of bfloat16 fields (ml_dtypes or |V2)."""
    return [np.asarray(a).view(np.uint16) for a in arrays]


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2"]], ids=["whole",
                                                             "mesh2"])
def test_port_resumes_its_own_bf16_checkpoint(tmp_path, monkeypatch, mesh):
    """2 steps + a bfloat16 checkpoint, resumed to 4, == 4 uninterrupted
    steps, bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    d, ref = str(tmp_path / "a"), str(tmp_path / "b")
    args = BF16 + mesh + ["--device", "cpu"]
    assert tcli.main(args + ["--iters", "2", "--checkpoint-dir", d]) == 0
    saved, _, _ = tckpt.load_checkpoint(d)
    assert saved[0].dtype == np.dtype("V2")  # what np.load gives back
    assert tcli.main(args + ["--iters", "4", "--checkpoint-dir", d,
                             "--resume"]) == 0
    assert tcli.main(args + ["--iters", "4", "--checkpoint-dir", ref]) == 0
    a, sa, _ = tckpt.load_checkpoint(d)
    b, sb, _ = tckpt.load_checkpoint(ref)
    assert sa == sb == 4
    for x, y in zip(_bits(a), _bits(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mesh", [[], ["--mesh", "2"]], ids=["whole",
                                                             "mesh2"])
def test_port_resumes_a_jax_bf16_checkpoint(tmp_path, monkeypatch, mesh):
    """The JAX CLI's bfloat16 checkpoint at step 2, resumed by the port to
    step 4, == the port's uninterrupted steps from the same state, bit for
    bit, and the JAX CLI's own 4-step run within the bf16 tolerance of
    tests/test_rawstep.py (32 eps max(|ref|, 1), eps = 2**-7)."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    d, ref = str(tmp_path / "shared"), str(tmp_path / "ref")
    assert jcli.main(BF16 + ["--iters", "2", "--checkpoint-dir", d]) == 0
    saved, _, meta = jckpt.load_checkpoint(d)
    assert meta["dtype"] == "bfloat16"
    start = fields_from_numpy(saved, device=CPU, dtype="bfloat16")
    assert start[0].dtype == torch.bfloat16
    st = port.make_stencil("heat3d", dtype="bfloat16")
    want = tdriver.make_runner(tdriver.make_step(st, (16, 16, 32)), 2)(start)
    assert tcli.main(BF16 + mesh + ["--iters", "4", "--checkpoint-dir", d,
                                    "--resume", "--device", "cpu"]) == 0
    got, step, _ = tckpt.load_checkpoint(d)
    assert step == 4
    for x, y in zip(_bits(got), _bits(fields_to_numpy(want))):
        np.testing.assert_array_equal(x, y)
    assert jcli.main(BF16 + ["--iters", "4", "--checkpoint-dir", ref]) == 0
    jref, _, _ = jckpt.load_checkpoint(ref)
    g = fields_from_numpy(got, device=CPU, dtype="bfloat16")[0].float()
    r = fields_from_numpy(jref, device=CPU, dtype="bfloat16")[0].float()
    tol = 32 * 2.0 ** -7 * max(float(r.abs().max()), 1.0)
    assert float((g - r).abs().max()) <= tol


# ---- the kernel's skewed schedule and its ring slots (csrc/ring.cuh) ---------

from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused  # noqa: E402

import ring_schedule  # noqa: E402

# every family, k = 1..4 (heat3d4th 1..2), and the kwargs of its stencil
SCHEDULE_FAMILIES = [("heat3d", {}), ("heat3d27", {}), ("heat3d4th", {}),
                     ("wave3d", {}), ("sor3d", {}),
                     ("advect3d", {"cx": -0.3, "cy": 0.2, "cz": 0.25}),
                     ("grayscott3d", {})]
SCHEDULE_CASES = [(name, kw, k) for name, kw in SCHEDULE_FAMILIES
                  for k in ((1, 2) if name == "heat3d4th" else (1, 2, 3, 4))]
SCHED_CORE = (9, 10, 12)  # ragged against the emulated (6, 8) column
SCHED_TILE = (6, 8)


def _sched_operands(st, k, dtype, seed):
    """A random core and every slab and corner of a (9, 10, 12) shard."""
    m = tfused.k_step_margin(st, k)
    Z, Y, X = SCHED_CORE
    rng = np.random.default_rng(seed)

    def per_field(shape):
        return tuple(torch.from_numpy(rng.random(shape, dtype=np.float32))
                     .to(dtype) for _ in range(st.num_fields))

    return (per_field((Z, Y, X)), per_field((m, Y, X)), per_field((m, Y, X)),
            per_field((Z, m, X)), per_field((Z, m, X)),
            [per_field((m, m, X)) for _ in range(4)])


def _schedule(st, k, mode, ops, slots):
    """Run the kernel's schedule in source mode ``mode`` on ``ops`` with
    ring slots ``slots``; return it beside the wrapper's plain version."""
    m = tfused.k_step_margin(st, k)
    core, zlo, zhi, ylo, yhi, corners = ops
    Z, Y, X = SCHED_CORE
    if mode == "raw":
        window = ring_schedule.window_raw(core, m)
        origin, gshape = (0, 0, 0), SCHED_CORE
        ref = tfused.plain_steps(core, st, k)
    elif mode == "zslab":
        window = ring_schedule.window_zslab(core, zlo, zhi, m)
        origin, gshape = (Z, 0, 0), (3 * Z, Y, X)
        ref = tfused.plain_zslab(core, zlo, zhi, st, k, 3 * Z, Z)
    else:
        window = ring_schedule.window_yzslab(core, zlo, zhi, ylo, yhi,
                                             corners, m)
        origin, gshape = (Z, Y, 0), (3 * Z, 3 * Y, X)
        ref = tfused.plain_yzslab(core, zlo, zhi, ylo, yhi, corners, st, k,
                                  gshape, (Z, Y))
    got = ring_schedule.run(st, k, window, SCHED_CORE, origin, gshape,
                            SCHED_TILE, slots, tstream.IN_FLIGHT)
    return got, ref


@pytest.mark.parametrize("mode", ["raw", "zslab", "yzslab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,kw,k", SCHEDULE_CASES)
def test_stream_schedule_on_its_ring_slots_is_k_plain_steps(name, kw, k,
                                                            dtype, mode):
    """The skewed wavefront of csrc/ring.cuh (all levels between one
    barrier and the next, IN_FLIGHT loads outstanding), run with rings of
    exactly ``streamfused.ring_slots`` planes — the counts every launch
    passes to the kernel — reads only planes its rings still hold (an
    in-flight, evicted or being-written slot raises) and equals
    plain_steps / plain_zslab / plain_yzslab bit for bit, for every family,
    source mode and dtype, on a shard ragged against its column."""
    st = port.make_stencil(name, dtype=dtype, **kw)
    ops = _sched_operands(st, k, dtype, 1401 + k)
    got, ref = _schedule(st, k, mode, ops, tstream.ring_slots(st, k))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == dtype
        assert torch.equal(g, r), (name, k, mode)


@pytest.mark.parametrize("name,kw", SCHEDULE_FAMILIES)
def test_stream_schedule_races_on_a_ring_one_slot_short(name, kw):
    """The schedule test bites: a level-0 ring or a level ring one slot
    shorter than ``ring_slots`` gives (k = 3; heat3d4th 2) makes some level
    read a slot that no longer, or not yet, holds its plane."""
    st = port.make_stencil(name, **kw)
    k = 2 if name == "heat3d4th" else 3
    ops = _sched_operands(st, k, torch.float32, 7)
    s0, s1 = tstream.ring_slots(st, k)
    for slots in ((s0 - 1, s1), (s0, s1 - 1)):
        with pytest.raises(ring_schedule.Race):
            _schedule(st, k, "yzslab", ops, slots)


def test_stream_ring_slots_and_layout():
    """The counts the schedule needs (csrc/ring.cuh): 2h + 2 a level,
    2h + 1 + IN_FLIGHT at level 0, one more for wave's u_prev reader; the
    launch tile's rings fit, and every (family, k) admitted before the
    redesign still fits."""
    assert tstream.IN_FLIGHT == 2
    st = port.make_stencil("heat3d")
    assert tstream.ring_slots(st, 4) == (5, 4)
    assert tstream.ring_slots(port.make_stencil("heat3d4th"), 2) == (7, 6)
    wave = port.make_stencil("wave3d")
    assert [tstream.ring_slots(wave, k) for k in (1, 2, 3)] == \
        [(5, 4), (6, 4), (6, 5)]
    assert tstream.ring_slots(port.make_stencil("sor3d"), 2) == (5, 4)
    # the earlier design's limits (k of the last fitting kernel)
    before = {"heat3d": (9, 14), "heat3d27": (9, 14), "advect3d": (9, 14),
              "wave3d": (8, 13), "heat3d4th": (5, 7),
              "grayscott3d": (5, 9), "sor3d": (4, 7)}
    for name, (k32, k16) in before.items():
        for dtype, k in ((torch.float32, k32), (torch.bfloat16, k16)):
            s = port.make_stencil(name, dtype=dtype)
            assert all(tstream.fits(s, j) for j in range(1, k + 1)), name
            tile = tstream.tile_of(s, k)
            assert tstream.smem_bytes(s, k, tile) <= tfused.SMEM_LIMIT
            assert tstream.level_warps_fit(tstream.levels(s, k), tile[2])
            assert tile[2] <= 1024
