"""The port's sharded path against the JAX package, on the CPU.

The port's meshes run on ``devices=[cpu] * n`` (several shards in one
process, the in-process transport); the JAX package runs on its 8 virtual
CPU devices (tests/conftest.py).  Inputs are numpy arrays from a seed, or
the deterministic inits, handed to both.  Tolerances are the JAX package's
own: ``rtol = atol = 1e-5`` for a sharded step against the unsharded one
(tests/test_sharded.py), ``1e-6`` for the compute_fn kernels
(tests/test_pallas.py), ``atol = 1e-4, rtol = 0`` for k fused steps
(tests/test_fused.py); guard-frame cells match exactly.  On CPU tensors
every kernel wrapper takes its plain version; the CUDA kernels are held to
those plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import make_pallas_compute as jpallas
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import checkpointing as jckpt
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                gather_to_numpy,
                                                shard_from_numpy)
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt
from mpi_cuda_process_tpu_torch.utils.init import (init_state,
                                                   init_state_sharded)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _seeded(st, grid, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def _assert_batched_steps_members(batched, single, mesh, st, grid, seed):
    """``batched`` on two stacked members equals ``single`` on each member,
    bit for bit."""
    members = [tuple(torch.from_numpy(a) for a in _seeded(st, grid, seed + i))
               for i in range(2)]
    whole = tuple(torch.stack(f) for f in zip(*members))
    got = tstepper.gather_fields(batched(tstepper.shard_fields(
        whole, mesh, len(grid), ensemble=True)))
    assert tuple(got[0].shape) == (2,) + tuple(grid)
    for i, member in enumerate(members):
        ref = tstepper.gather_fields(single(tstepper.shard_fields(
            member, mesh, len(grid))))
        for g, r in zip(got, ref):
            assert torch.equal(g[i], r)


def _jax_steps(name, grid, arrays, n, periodic=False):
    step = jax.jit(jdriver.make_step(jmake_stencil(name), grid,
                                     periodic=periodic))
    f = tuple(jnp.asarray(a) for a in arrays)
    for _ in range(n):
        f = step(f)
    return tuple(np.asarray(x) for x in f)


def _assert_frame_exact(got, ref, halo):
    for g, r in zip(got, ref):
        for d in range(r.ndim):
            for sl in (slice(0, halo), slice(-halo, None)):
                idx = [slice(None)] * r.ndim
                idx[d] = sl
                np.testing.assert_array_equal(g[tuple(idx)], r[tuple(idx)])


STEP_CASES = [
    ("heat3d", (8, 12, 16), (2,)), ("heat3d", (8, 12, 16), (2, 2)),
    ("heat3d", (8, 12, 16), (2, 2, 2)),
    ("wave3d", (8, 12, 16), (2,)), ("wave3d", (8, 12, 16), (2, 2)),
    ("wave3d", (8, 12, 16), (2, 2, 2)),
    ("heat3d27", (8, 12, 16), (2, 2)),   # corners: the two-pass exchange
    ("heat3d4th", (8, 12, 16), (2, 2)),  # halo 2
    ("heat2d", (16, 20), (2, 2)),
]


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,grid,mesh_shape", STEP_CASES,
                         ids=[f"{n}-{'x'.join(map(str, m))}"
                              for n, _, m in STEP_CASES])
def test_sharded_step_matches_jax_step(name, grid, mesh_shape, periodic):
    """make_sharded_step over a mesh == the JAX package's unsharded
    make_step, 5 steps; overlap on and off are bit-equal."""
    st = port.make_stencil(name)
    arrays = _seeded(st, grid, len(name) + len(mesh_shape))
    ref = _jax_steps(name, grid, arrays, 5, periodic)
    mesh = _mesh(mesh_shape)
    outs = []
    for overlap in (False, True):
        step = tstepper.make_sharded_step(st, mesh, grid, periodic=periodic,
                                          overlap=overlap)
        f = shard_from_numpy(arrays, mesh)
        for _ in range(5):
            f = step(f)
        assert all(len(x) == mesh.size for x in f)
        outs.append(gather_to_numpy(f))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    for g, r in zip(outs[0], ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
    if not periodic:
        _assert_frame_exact(outs[0], ref, st.halo)


@pytest.mark.parametrize("name,grid", [
    ("heat3d", (8, 8, 8)), ("heat3d27", (8, 6, 10)),
    ("heat3d4th", (8, 8, 12)), ("wave3d", (8, 10, 8))])
def test_compute_fn_plain_matches_jax_pallas_kernel(name, grid):
    """K4/K5's plain versions == ops/pallas/kernels.py (interpret) on the
    same padded block, 1e-6; K5 hands u_prev back as its second output."""
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    h = tst.halo
    rng = np.random.default_rng(11)
    p = rng.random(tuple(g + 2 * h for g in grid), dtype=np.float32)
    ins = (p,) + ((rng.random(grid, dtype=np.float32),)
                  if tst.num_fields == 2 else ())
    a = jpallas(jst, interpret=True)(tuple(jnp.asarray(x) for x in ins))
    tins = fields_from_numpy(ins, device="cpu")
    tkernels.launches.clear()
    b = tkernels.make_pallas_compute(tst)(tins)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=1e-6,
                               atol=1e-6)
    if name == "wave3d":
        assert b[1] is tins[1]
    assert not tkernels.launches  # CPU tensors never launch


def test_compute_fn_2d_and_unknown_names_raise():
    """heat2d and life build their compute_fn (K7, held against the JAX
    kernel in tests/test_torch_2d.py); names without one raise."""
    for name in ("heat2d", "life"):
        assert callable(tkernels.make_pallas_compute(
            port.make_stencil(name)))
    with pytest.raises(KeyError, match="no pallas kernel"):
        tkernels.make_pallas_compute(port.make_stencil("wave2d"))
    assert tkernels.has_pallas_kernel("heat2d")
    assert not tkernels.has_pallas_kernel("wave2d")


def test_sharded_step_with_compute_fn_matches_jax_sharded_pallas():
    """The compute_fn plugs into the sharded step unchanged, as in
    tests/test_pallas.py::test_pallas_in_sharded_step."""
    grid = (16, 8, 8)
    jst, tst = jmake_stencil("heat3d"), port.make_stencil("heat3d")
    arrays = _seeded(tst, grid, 5)
    jm = jmesh.make_mesh((1, 2, 2))
    jstep = jstepper.make_sharded_step(jst, jm, grid,
                                       compute_fn=jpallas(jst, interpret=True))
    ref = jstep(jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays),
                                      jm, 3))
    mesh = _mesh((1, 2, 2))
    step = tstepper.make_sharded_step(
        tst, mesh, grid, compute_fn=tkernels.make_pallas_compute(tst))
    got = gather_to_numpy(step(shard_from_numpy(arrays, mesh)))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-6)


FUSED_CASES = [
    ("heat3d", 4, (2, 2), None), ("heat3d27", 4, (2, 1), None),
    ("heat3d4th", 2, (2, 2), None), ("wave3d", 4, (2, 2), None),
    ("heat3d", 4, (2,), "padfree"), ("heat3d27", 4, (4,), "padfree"),
    ("heat3d4th", 2, (2,), "padfree"), ("wave3d", 4, (2,), "padfree"),
]


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,k,mesh_shape,kind", FUSED_CASES,
                         ids=[f"{n}-k{k}-{'x'.join(map(str, m))}-"
                              f"{kind or 'padded'}"
                              for n, k, m, kind in FUSED_CASES])
def test_sharded_fused_matches_jax_steps(name, k, mesh_shape, kind,
                                         periodic):
    """K3's sharded mode / K6 (plain versions) == k JAX steps, 1e-4."""
    grid = (16, 16, 24)
    st = port.make_stencil(name)
    arrays = _seeded(st, grid, k + len(name))
    ref = _jax_steps(name, grid, arrays, k, periodic)
    mesh = _mesh(mesh_shape)
    step = tstepper.make_sharded_temporal_step(st, mesh, grid, k,
                                               periodic=periodic, kind=kind)
    assert step is not None
    tfused.launches.clear()
    got = gather_to_numpy(step(shard_from_numpy(arrays, mesh)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    if not periodic:
        _assert_frame_exact(got, ref, st.halo)
    assert not tfused.launches


@pytest.mark.parametrize("mesh_shape,kind", [((2, 2, 1), None),
                                             ((2, 1, 1), "padfree")])
def test_sharded_fused_matches_jax_sharded_fused(mesh_shape, kind):
    """Against the JAX package's make_sharded_fused_step (interpret), as
    tests/test_fused.py::test_sharded_fused_matches_unsharded runs it."""
    name, grid, k = "heat3d", (16, 16, 128), 4
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    fields = jinit_state(jst, grid, seed=9, kind="pulse")
    arrays = tuple(np.asarray(f) for f in fields)
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(jst, jm, grid, k,
                                             interpret=True, kind=kind)
    assert jstep is not None
    ref = jax.jit(jstep)(jstepper.shard_fields(fields, jm, 3))
    mesh = _mesh(mesh_shape)
    step = tstepper.make_sharded_fused_step(tst, mesh, grid, k, kind=kind)
    got = gather_to_numpy(step(shard_from_numpy(arrays, mesh)))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
def test_k6_is_the_function_of_jax_zslab_xwin(periodic):
    """The TPU package's wide-X z-slab kernel (build_zslab_xwin_call, table
    row 10: X windowed for VMEM) computes the same k steps as its whole-row
    z-slab kernel, which K6 replaces: the port's K6 path (plain version)
    matches it on a z-only mesh."""
    import functools

    from mpi_cuda_process_tpu.ops.pallas.fused import build_zslab_xwin_call

    name, grid, k = "heat3d", (16, 16, 256), 4
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    arrays = _seeded(tst, grid, 21)
    jm = jmesh.make_mesh((2, 1, 1))
    axis_names, counts = jstepper._resolve_mesh_axes(3, jm)
    jstep = jstepper._make_zslab_padfree_step(
        jst, jm, grid, (8, 16, 256), axis_names, counts, k,
        functools.partial(build_zslab_xwin_call, tiles=(8, 8, 128)),
        (27, 9), True, periodic)
    assert jstep._padfree_kind == "zslab_xwin"
    ref = jax.jit(jstep)(jstepper.shard_fields(
        tuple(jnp.asarray(a) for a in arrays), jm, 3))
    mesh = _mesh((2,))
    step = tstepper.make_sharded_fused_step(tst, mesh, grid, k,
                                            periodic=periodic, kind="padfree")
    got = gather_to_numpy(step(shard_from_numpy(arrays, mesh)))
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=0,
                               atol=1e-4)


def test_sharded_fused_unsupported_configs():
    """None for the two cases the JAX package's
    tests/test_fused.py::test_sharded_fused_unsupported_configs pins, and
    the not-yet-ported kinds raise naming their ROADMAP item."""
    st = port.make_stencil("heat3d")
    assert tstepper.make_sharded_fused_step(
        st, _mesh((1, 1, 2)), (16, 16, 256), 4) is None  # lane axis sharded
    assert tstepper.make_sharded_fused_step(
        st, _mesh((4, 1, 1)), (16, 16, 128), 8) is None  # block < margin
    assert tstepper.make_sharded_fused_step(
        st, _mesh((2, 2)), (16, 16, 128), 3) is None  # 2*k*halo % 8
    assert tstepper.make_sharded_fused_step(
        st, _mesh((3,)), (16, 16, 128), 4) is None  # not divisible
    # --overlap, the 2-axis padfree kind, the stream kind and its rdma
    # exchange run now (tests/test_torch_twoaxis.py, test_torch_stream.py,
    # test_torch_rdma.py), and so does pipeline=True on the slab kinds
    # (tests/test_torch_pipeline.py; with overlap on this 8-deep block the
    # pipeline stays on the non-split body); the padded kind refuses the
    # pipeline with the TPU package's reason, the ensemble axis runs (a
    # batched step, each member its unbatched step's), and rdma off the
    # stream kind raises the TPU package's error
    for kw in ({"kind": "stream", "pipeline": True},
               {"kind": "stream", "overlap": True, "pipeline": True}):
        step = tstepper.make_sharded_fused_step(st, _mesh((2, 2)),
                                                (16, 16, 128), 4, **kw)
        assert step._pipeline_active and not step._overlap_active
    with pytest.raises(ValueError, match="rides the slab-operand kinds"):
        tstepper.make_sharded_fused_step(st, _mesh((2, 2)), (16, 16, 128),
                                         4, pipeline=True)
    batched = tstepper.make_sharded_fused_step(st, _mesh((2, 2)),
                                               (16, 16, 128), 4, ensemble=2)
    _assert_batched_steps_members(
        batched, tstepper.make_sharded_fused_step(st, _mesh((2, 2)),
                                                  (16, 16, 128), 4),
        _mesh((2, 2)), st, (16, 16, 128), 31)
    with pytest.raises(ValueError, match="streaming kernel family"):
        tstepper.make_sharded_fused_step(st, _mesh((2, 2)), (16, 16, 128), 4,
                                         exchange="rdma")
    step = tstepper.make_sharded_fused_step(st, _mesh((2, 2)), (16, 16, 128),
                                            4, kind="padfree", pipeline=True)
    assert step._pipeline_active and step._padfree_kind == "yzslab"
    # 2D grids go to the row-split whole-block stepper (K8), where the
    # 3D-only options raise by name, as in the TPU package
    for kw, what in (({"pipeline": True}, "pipeline=True is 3D-only"),
                     ({"variant": object()}, "kernel variants are 3D-only"),
                     ({"exchange": "rdma"}, "exchange='rdma' is 3D-only")):
        with pytest.raises(ValueError, match=what):
            tstepper.make_sharded_temporal_step(
                port.make_stencil("heat2d"), _mesh((2,)), (16, 16), 4, **kw)


@pytest.mark.parametrize("name,kind,periodic", [
    ("heat3d", "zero", False), ("heat3d", "pulse", False),
    ("wave3d", "auto", False), ("heat3d4th", "pulse", True)])
@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2), (2, 1, 2)])
def test_init_state_sharded_gathers_to_init_state(name, kind, periodic,
                                                  mesh_shape):
    st = port.make_stencil(name)
    grid = (8, 12, 16)
    mesh = _mesh(mesh_shape)
    sharded = init_state_sharded(st, grid, mesh, kind=kind,
                                 periodic=periodic)
    whole = init_state(st, grid, kind=kind, periodic=periodic, device="cpu")
    assert all(b.shape == (8 // mesh.counts(3)[0], 12 // mesh.counts(3)[1],
                           16 // mesh.counts(3)[2])
               for f in sharded for b in f)
    for a, b in zip(tstepper.gather_fields(sharded), whole):
        assert torch.equal(a, b)
    jwhole = jinit_state(jmake_stencil(name), grid, 0, 0.15, kind,
                         periodic=periodic)
    for a, b in zip(gather_to_numpy(sharded), jwhole):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_mesh_needs_enough_devices_and_refuses_unported_modes(monkeypatch):
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        tmesh.make_mesh((2, 2), [CPU] * 2)
    # the ensemble axis (ROADMAP A7) runs: a mesh axis of member groups
    # needs its shards too, and the sharded step takes the member axis
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        tmesh.make_mesh((2,), [CPU] * 2, ensemble=2)
    assert tmesh.make_mesh((2,), [CPU] * 4, ensemble=2).size == 4
    st = port.make_stencil("heat3d")
    _assert_batched_steps_members(
        tstepper.make_sharded_step(st, _mesh((2,)), (8, 8, 8), ensemble=2),
        tstepper.make_sharded_step(st, _mesh((2,)), (8, 8, 8)), _mesh((2,)),
        st, (8, 8, 8), 41)
    assert tmesh.factor_mesh(8, 3) == jmesh.factor_mesh(8, 3) == (2, 2, 2)
    assert tmesh.factor_mesh(6, 2) == jmesh.factor_mesh(6, 2)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tmesh.bootstrap_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    # a configured cluster is bootstrapped since A4 (tests/
    # test_torch_multiprocess.py); one without its port fails fast, naming
    # it, before any process group is opened
    with pytest.raises(ValueError, match="MASTER_PORT"):
        tmesh.bootstrap_distributed(device="cpu")
    assert tmesh.process_count() == 1
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    assert tmesh.local_devices("cpu") == (CPU,) * 4


def test_sharded_step_validates_like_jax():
    st = port.make_stencil("heat3d")
    with pytest.raises(ValueError, match="not divisible"):
        tstepper.make_sharded_step(st, _mesh((3,)), (8, 8, 8))
    with pytest.raises(ValueError, match="smaller than halo"):
        tstepper.make_sharded_step(port.make_stencil("heat3d4th"),
                                   _mesh((8,)), (8, 8, 8))


def test_halo_exchange_two_pass_corners():
    """exchange_and_pad on a 2x2 mesh == the global array padded once and
    cut into padded blocks: corners included (guard fill and wrap)."""
    g = np.arange(8 * 12 * 6, dtype=np.float32).reshape(8, 12, 6)
    mesh = _mesh((2, 2))
    blocks = shard_from_numpy((g,), mesh)[0]
    for periodic in (False, True):
        padded = thalo.exchange_and_pad(blocks, mesh, 1, -1.0, periodic)
        full = (np.pad(g, 1, mode="wrap") if periodic
                else np.pad(g, 1, constant_values=-1.0))
        for c, p in zip(mesh.coords(), padded):
            z, y = c[0] * 4, c[1] * 6
            np.testing.assert_array_equal(p.numpy(),
                                          full[z:z + 6, y:y + 8, :])
    lo, hi = thalo.exchange_slabs_axis(blocks, mesh, 0, 2, -1.0)
    np.testing.assert_array_equal(lo[0].numpy(), np.full((2, 6, 6), -1.0))
    np.testing.assert_array_equal(lo[2].numpy(), g[2:4, 0:6])
    np.testing.assert_array_equal(hi[1].numpy(), g[4:6, 6:12])


def test_sharded_checkpoint_resumes_unsharded_in_jax(tmp_path, monkeypatch):
    """A port --mesh 2,2 run checkpoints the gathered global fields in the
    npy format; the JAX package resumes it unsharded and matches its own
    uninterrupted run."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--grid", "8,12,16", "--init", "pulse",
            "--checkpoint-every", "4"]
    d = str(tmp_path / "ckpt")
    assert tcli.main(base + ["--iters", "4", "--checkpoint-dir", d,
                             "--mesh", "2,2", "--device", "cpu"]) == 0
    arrays, step, _ = tckpt.load_checkpoint(d)
    assert step == 4 and arrays[0].shape == (8, 12, 16)
    assert jcli.main(base + ["--iters", "8", "--checkpoint-dir", d,
                             "--resume"]) == 0
    ref = str(tmp_path / "ref")
    assert jcli.main(base + ["--iters", "8", "--checkpoint-dir", ref]) == 0
    a, sa, _ = jckpt.load_checkpoint(d)
    b, sb, _ = jckpt.load_checkpoint(ref)
    assert sa == sb == 8
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)


def test_jax_checkpoint_resumes_in_port_under_mesh(tmp_path, monkeypatch):
    """A JAX checkpoint at step 4 resumes in the port under --mesh 2,2
    --compute pallas and matches the port's own unsharded 8-step run."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "wave3d", "--grid", "8,12,16",
            "--checkpoint-every", "4"]
    d = str(tmp_path / "shared")
    assert jcli.main(base + ["--iters", "4", "--checkpoint-dir", d]) == 0
    assert tcli.main(base + ["--iters", "8", "--checkpoint-dir", d,
                             "--resume", "--mesh", "2,2", "--compute",
                             "pallas", "--device", "cpu"]) == 0
    ref = str(tmp_path / "ref")
    assert tcli.main(base + ["--iters", "8", "--checkpoint-dir", ref,
                             "--device", "cpu"]) == 0
    a, sa, _ = tckpt.load_checkpoint(d)
    b, sb, _ = tckpt.load_checkpoint(ref)
    assert sa == sb == 8
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
    _assert_frame_exact(a, b, 1)


def test_sharded_diagnostics_match_unsharded():
    st = port.make_stencil("wave3d")
    grid = (8, 12, 16)
    arrays = _seeded(st, grid, 2)
    from mpi_cuda_process_tpu_torch.utils import diagnostics

    whole = diagnostics.field_diagnostics(
        st, fields_from_numpy(arrays, device="cpu"))
    mesh = _mesh((2, 2))
    sharded = diagnostics.field_diagnostics(st, shard_from_numpy(arrays,
                                                                 mesh))
    assert sharded.keys() == whole.keys()
    for k in whole:
        assert sharded[k] == pytest.approx(whole[k], rel=1e-5)
    heat = port.make_stencil("heat3d")
    f = shard_from_numpy(_seeded(heat, grid, 3), mesh)
    d = diagnostics.field_diagnostics(
        heat, f, step_fn=tstepper.make_sharded_step(heat, mesh, grid))
    w = diagnostics.field_diagnostics(
        heat, fields_from_numpy(_seeded(heat, grid, 3), device="cpu"),
        step_fn=tdriver.make_step(heat, grid))
    assert d["residual"] == pytest.approx(w["residual"], rel=1e-5)
