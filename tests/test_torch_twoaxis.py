"""The 2-axis pad-free fused step (K9, TPU table rows 9 and 11) and the
overlapped fused step's boundary shells (row 7) against the JAX package.

The port's meshes run on ``devices=[cpu] * n`` (every wrapper takes its
plain version for CPU tensors; tests/test_torch_cuda.py holds the kernels
to those plain versions on the card); the JAX package runs as its own tests
run it, ``make_sharded_fused_step(..., interpret=True, padfree=True[,
overlap=True])`` on the 8 virtual CPU devices of tests/conftest.py
(tests/test_twoaxis_padfree.py, tests/test_overlap_fused.py).  Inputs are
numpy arrays from a seed, handed to both.  Every fused case runs two
calls, so the second call's slabs and corners come from the first call's
outputs.  Tolerance: ``atol = 1e-4, rtol = 0`` against the JAX fused
kernels (tests/test_fused.py, which notes that they reorder taps); the
slab exchange and the guard frame match exactly; ``--overlap`` equals the
non-split step bit for bit.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.parallel import halo as jhalo
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.interop import gather_to_numpy, shard_from_numpy
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper

from test_torch_cli import _assert_match, _run_both

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID = (32, 32, 128)
CALLS = 2


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _seeded(st, grid, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def _jax_fused(name, grid, mesh_shape, k, arrays, periodic=False, **kw):
    """CALLS passes of the JAX package's sharded fused step (interpret)."""
    jm = jmesh.make_mesh(mesh_shape)
    step = jstepper.make_sharded_fused_step(
        jmake_stencil(name), jm, grid, k, interpret=True, periodic=periodic,
        **kw)
    assert step is not None
    f = jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays), jm, 3)
    jf = jax.jit(step)
    for _ in range(CALLS):
        f = jf(f)
    return step, tuple(np.asarray(x) for x in f)


def _port_fused(name, grid, mesh_shape, k, arrays, periodic=False, **kw):
    st = port.make_stencil(name)
    step = tstepper.make_sharded_fused_step(
        st, _mesh(mesh_shape), grid, k, periodic=periodic, **kw)
    assert step is not None
    f = shard_from_numpy(arrays, _mesh(mesh_shape))
    tfused.launches.clear()
    for _ in range(CALLS):
        f = step(f)
    assert not tfused.launches  # CPU tensors never launch
    return step, gather_to_numpy(f)


def _jax_steps(name, grid, arrays, n, periodic=False):
    step = jax.jit(jdriver.make_step(jmake_stencil(name), grid,
                                     periodic=periodic))
    f = tuple(jnp.asarray(a) for a in arrays)
    for _ in range(n):
        f = step(f)
    return tuple(np.asarray(x) for x in f)


def _assert_close(got, ref, halo):
    """atol 1e-4, frame cells exact (``halo`` None: periodic); returns the
    largest |d|."""
    worst = 0.0
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        worst = max(worst, float(np.abs(g - r).max()))
        if halo:
            for d in range(r.ndim):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * r.ndim
                    idx[d] = sl
                    np.testing.assert_array_equal(g[tuple(idx)],
                                                  r[tuple(idx)])
    print(f"max|d| {worst:.3e}")
    return worst


YZ_CASES = [
    ("heat3d", 4, (2, 2, 1), False), ("heat3d27", 4, (2, 2, 1), False),
    ("heat3d4th", 2, (2, 2, 1), False), ("wave3d", 4, (2, 2, 1), False),
    ("heat3d", 4, (1, 2, 1), False),  # y-only: z gets bc-fill slabs
    ("heat3d", 4, (2, 2, 1), True),   # wrap slabs and wrap corners
]


@pytest.mark.parametrize(
    "name,k,mesh_shape,periodic", YZ_CASES,
    ids=[f"{n}-k{k}-{'x'.join(map(str, m))}-{'periodic' if p else 'frame'}"
         for n, k, m, p in YZ_CASES])
def test_yzslab_padfree_matches_jax(name, k, mesh_shape, periodic):
    """--fuse-kind padfree on a mesh that shards y: the port's K9 step ==
    the JAX package's 2-axis pad-free step, two calls."""
    st = port.make_stencil(name)
    arrays = _seeded(st, GRID, 30 + k + len(name))
    jstep, ref = _jax_fused(name, GRID, mesh_shape, k, arrays,
                            periodic=periodic, padfree=True)
    assert jstep._padfree_kind == "yzslab"
    tstep, got = _port_fused(name, GRID, mesh_shape, k, arrays,
                             periodic=periodic, kind="padfree")
    assert tstep._padfree_kind == "yzslab"
    assert tstep._overlap_active is False
    _assert_close(got, ref, None if periodic else st.halo)


OVERLAP_CASES = [("padded", (2, 2, 1), None), ("zslab", (2, 1, 1), "padfree"),
                 ("yzslab", (2, 2, 1), "padfree")]


@pytest.mark.parametrize("label,mesh_shape,kind", OVERLAP_CASES,
                         ids=[c[0] for c in OVERLAP_CASES])
def test_overlap_fused_matches_jax(label, mesh_shape, kind):
    """--fuse --overlap for each kind == the JAX package's overlapped
    step, and bit-equal to the port's non-split step."""
    name, k = "heat3d", 4
    st = port.make_stencil(name)
    arrays = _seeded(st, GRID, 40 + len(label))
    jstep, ref = _jax_fused(name, GRID, mesh_shape, k, arrays, overlap=True,
                            padfree=True if kind else None)
    assert jstep._overlap_active
    tstep, got = _port_fused(name, GRID, mesh_shape, k, arrays, kind=kind,
                             overlap=True)
    assert tstep._overlap_active
    assert getattr(tstep, "_padfree_kind", "padded") == label
    _assert_close(got, ref, st.halo)
    _, plain = _port_fused(name, GRID, mesh_shape, k, arrays, kind=kind)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,k", [("heat3d", 4), ("heat3d27", 4),
                                    ("heat3d4th", 2), ("wave3d", 4)])
@pytest.mark.parametrize("mesh_shape,kind", [
    ((2, 2), None), ((2, 2), "padfree"), ((1, 2), "padfree"),
    ((4,), "padfree"), ((2, 1, 1), None)])
def test_overlap_is_bit_equal_to_the_non_split_step(mesh_shape, kind, name,
                                                    k, periodic):
    """Every kind, stencil and boundary: the overlapped step (interior on
    the shard's own operands, shells spliced over it) equals the non-split
    step bit for bit, and both equal 2k plain steps of the JAX package."""
    grid = (48, 48, 24)  # local extents >= 3m on every sharded axis
    st = port.make_stencil(name)
    arrays = _seeded(st, grid, 50 + k)
    over, a = _port_fused(name, grid, mesh_shape, k, arrays,
                          periodic=periodic, kind=kind, overlap=True)
    assert over._overlap_active
    _, b = _port_fused(name, grid, mesh_shape, k, arrays, periodic=periodic,
                       kind=kind)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ref = _jax_steps(name, grid, arrays, CALLS * k, periodic)
    _assert_close(a, ref, None if periodic else st.halo)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
def test_k9_is_the_function_of_jax_yzslab_xwin(monkeypatch, periodic):
    """Row 11: the TPU package's wide-X 2-axis kernel
    (build_yzslab_xwin_call: X windowed for VMEM) computes the same k
    steps as its whole-row kernel, which K9 replaces: the port's K9 path
    (plain version) matches it, forced as tests/test_twoaxis_padfree.py's
    ``_xwin_step`` forces it, at (32, 32, 256) with two x tiles."""
    from mpi_cuda_process_tpu.ops.pallas import fused as F

    name, grid, k = "heat3d", (32, 32, 256), 4
    orig_x = F.build_yzslab_xwin_call
    monkeypatch.setattr(F, "build_yzslab_padfree_call", lambda *a, **kw: None)
    monkeypatch.setattr(F, "build_yzslab_xwin_call",
                        lambda *a, **kw: orig_x(*a, tiles=(8, 8, 128), **kw))
    st = port.make_stencil(name)
    arrays = _seeded(st, grid, 21)
    jstep, ref = _jax_fused(name, grid, (2, 2, 1), k, arrays,
                            periodic=periodic, padfree=True)
    assert jstep._padfree_kind == "yzslab_xwin"
    _, got = _port_fused(name, grid, (2, 2, 1), k, arrays, periodic=periodic,
                         kind="padfree")
    _assert_close(got, ref, None if periodic else st.halo)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (1, 2, 1), (2, 1, 1)])
def test_exchange_slabs_2axis_matches_jax(mesh_shape, periodic):
    """halo.exchange_slabs_2axis == the JAX package's, slab by slab and
    corner by corner, exactly; every piece a packed buffer; and
    pad_from_slabs rebuilds exchange_and_pad's padded block."""
    grid, h, bc = (8, 12, 6), 2, -1.0
    g = np.arange(np.prod(grid), dtype=np.float32).reshape(grid)
    jm = jmesh.make_mesh(mesh_shape)
    names, counts = jstepper._resolve_mesh_axes(3, jm)
    spec = jstepper.grid_partition_spec(3, jm)

    def local(x):
        (zlo, zhi), (ylo, yhi), cs = jhalo.exchange_slabs_2axis(
            x, names, counts, h, bc, periodic=periodic)
        return (zlo, zhi, ylo, yhi) + tuple(cs)

    fn = jstepper.shard_map(local, mesh=jm, in_specs=(spec,),
                            out_specs=(spec,) * 8, check_vma=False)
    jout = [np.asarray(a) for a in jax.jit(fn)(
        jstepper.shard_fields((jnp.asarray(g),), jm, 3)[0])]
    mesh = _mesh(mesh_shape)
    blocks = shard_from_numpy((g,), mesh)[0]
    slabs = thalo.exchange_slabs_2axis(blocks, mesh, h, bc, periodic)
    padded = thalo.exchange_and_pad(blocks, mesh, h, bc, periodic,
                                    axes=(0, 1))
    for c, b, s, p in zip(mesh.coords(), blocks, slabs, padded):
        (zlo, zhi), (ylo, yhi), cs = s
        for piece, ref in zip((zlo, zhi, ylo, yhi) + tuple(cs), jout):
            assert piece.is_contiguous()
            shape = piece.shape
            idx = tuple(slice(ci * n, (ci + 1) * n)
                        for ci, n in zip(tuple(c) + (0,) * 3, shape))
            np.testing.assert_array_equal(piece.numpy(), ref[idx])
        assert torch.equal(thalo.pad_from_slabs(b, s, h), p)
        for d in (0, 1):
            n = p.shape[d]
            for start, stop in ((0, 4), (1, n - 1), (n - 5, n)):
                assert torch.equal(
                    thalo.pad_from_slabs(b, s, h, d, start, stop),
                    tstepper._axis_slice(p, d, slice(start, stop)))


RAGGED = [((20, 28, 24), (2, 2, 1), "padfree", False),
          ((26, 30, 24), (2, 2, 1), "padfree", True),
          ((26, 30, 24), (2, 2, 1), None, True),
          ((20, 28, 24), (1, 2, 1), "padfree", False)]


@pytest.mark.parametrize("grid,mesh_shape,kind,overlap", RAGGED)
def test_ragged_local_extents_match_jax_steps(grid, mesh_shape, kind,
                                              overlap):
    """Local extents that the TPU tiling rule declines (not multiples of
    2m: the JAX builder returns None) run in the port, which masks ragged
    blocks: == 2k steps of the JAX package's unsharded make_step."""
    name, k = "heat3d", 4
    jst = jmake_stencil(name)
    if kind:
        assert jstepper.make_sharded_fused_step(
            jst, jmesh.make_mesh(mesh_shape), grid, k, interpret=True,
            kind="padfree") is None
    st = port.make_stencil(name)
    arrays = _seeded(st, grid, 60)
    step, got = _port_fused(name, grid, mesh_shape, k, arrays, kind=kind,
                            overlap=overlap)
    assert step._overlap_active == overlap
    _assert_close(got, _jax_steps(name, grid, arrays, CALLS * k), st.halo)


def test_overlap_falls_back_below_3m_like_jax(monkeypatch, caplog):
    """A sharded local extent below 3m cannot host the shells: the step is
    the non-split one, as in the JAX package
    (tests/test_overlap_fused.py::test_overlap_falls_back_when_block_too_small),
    and the CLI warns; a y-sharded padfree kind its kernel declines gives
    None (the forced-kind contract) and the CLI raises."""
    grid, k = (16, 16, 128), 4  # local 8 < 3m = 12
    st = port.make_stencil("heat3d")
    arrays = _seeded(st, grid, 70)
    for mesh_shape, kind in (((2, 1, 1), None), ((2, 2, 1), "padfree")):
        over, a = _port_fused("heat3d", grid, mesh_shape, k, arrays,
                              kind=kind, overlap=True)
        assert not over._overlap_active
        jover = jstepper.make_sharded_fused_step(
            jmake_stencil("heat3d"), jmesh.make_mesh(mesh_shape), grid, k,
            interpret=True, overlap=True)
        assert not getattr(jover, "_overlap_active", False)
        _, b = _port_fused("heat3d", grid, mesh_shape, k, arrays, kind=kind)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert tstepper.make_sharded_fused_step(
        st, _mesh((2, 2)), (4, 16, 128), 4, kind="padfree") is None
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat3d", "--iters", "4", "--device", "cpu",
            "--mesh", "2,2", "--fuse", "4"]
    with caplog.at_level(logging.WARNING):
        assert tcli.main(base + ["--grid", "16,16,128", "--overlap"]) == 0
    assert any("cannot host the interior/boundary split" in r.getMessage()
               for r in caplog.records)
    with pytest.raises(ValueError, match="--fuse-kind padfree unsupported"):
        tcli.main(base + ["--grid", "4,16,128", "--fuse-kind", "padfree"])


def test_shell_calls_are_k3_instances_counted_apart():
    """build_overlap_shell_calls: one call per sharded axis, a 2m-deep
    instance of K3's sharded mode (its plain version here: the shell
    output equals plain_step_padded on the same strip), None below 3m
    or off the alignment unit."""
    st = port.make_stencil("heat3d")
    local, grid, k = (16, 20, 24), (32, 40, 24), 4
    m = 4
    shells = tfused.build_overlap_shell_calls(st, local, grid, k, (0, 1))
    assert set(shells) == {0, 1}
    rng = np.random.default_rng(80)
    strip = torch.from_numpy(rng.random((4 * m, 20 + 2 * m, 24),
                                        dtype=np.float32))
    got = shells[0]((16 - 2 * m, 8), strip)
    ref = tfused.plain_step_padded((strip,), st, k, grid, (8, 8))
    assert got[0].shape == (2 * m, 20, 24)
    assert torch.equal(got[0], ref[0])
    assert tfused.build_overlap_shell_calls(st, (11, 20, 24), grid, k,
                                            (0,)) is None
    assert tfused.build_overlap_shell_calls(st, local, grid, 3, (0,)) is None
    assert tfused.build_overlap_shell_calls(st, local, grid, k, (2,)) is None


CLI_RUNS = [["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree"],
            ["--mesh", "2,2", "--fuse", "4", "--overlap"],
            ["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
             "--overlap", "--periodic"]]


@pytest.mark.parametrize("flags", CLI_RUNS,
                         ids=["_".join(f.strip("-") for f in fl)
                              for fl in CLI_RUNS])
def test_cli_runs_the_lifted_paths_like_jax_cli(tmp_path, monkeypatch,
                                                flags):
    """The two command lines the port refused before (--fuse-kind padfree
    on a y-sharded mesh, --fuse --overlap) through both CLIs at 32x32x128,
    8 iterations: the final fields match at 1e-4, frame cells exactly."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "heat3d", "--grid", "32,32,128", "--iters", "8",
            "--checkpoint-every", "8", "--init", "pulse", *flags]
    jf, jstep, tf, tstep, _ = _run_both(tmp_path, args, "twoaxis")
    assert jstep == tstep == 8
    _assert_match(tf, jf, None if "--periodic" in flags else 1, 1e-4)
