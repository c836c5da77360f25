"""Advection and Gray-Scott in the port against the JAX package, on the CPU.

advect2d/advect3d (``ops/advection.py``) and grayscott2d/grayscott3d
(``ops/reaction.py``) at every layer: the op layer's ``make_step``; the
raw-step kernels' plain versions (K1 ``raw_step_heat[advect3d]``,
``raw_step_grayscott``) against ``ops/pallas/rawstep.py`` in interpret
mode; K3 and its sharded mode (with the overlap shells) against
``ops/pallas/fused.py``; K8 whole-grid and row-split against
``ops/pallas/fullgrid.py``; the ``patch`` init bit for bit; and the slice
as a whole, both CLIs on the same command lines with their ``npy``
checkpoints compared.  Inputs are numpy arrays from a seed or the
deterministic inits.

Tolerances: ``32 * eps * max(|ref|, 1)`` per plain or raw step
(tests/test_rawstep.py), grown with the step count through a CLI run;
``atol = 1e-4, rtol = 0`` for k fused steps (tests/test_fused.py); guard-
frame cells exactly.  On CPU tensors every wrapper takes its plain
version; tests/test_torch_cuda.py holds the kernels to those on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fused as jfused
from mpi_cuda_process_tpu.ops.pallas import fullgrid as jfullgrid
from mpi_cuda_process_tpu.ops.pallas import rawstep as jrawstep
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.utils import checkpointing as jckpt
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state
from mpi_cuda_process_tpu.utils.init import \
    init_state_sharded as jinit_state_sharded

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                gather_to_numpy)
from mpi_cuda_process_tpu_torch.ops import reaction as treaction
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt
from mpi_cuda_process_tpu_torch.utils.init import (init_state,
                                                   init_state_sharded)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
CPU = torch.device("cpu")
GRIDS = {2: (16, 20), 3: (10, 12, 14)}
# (name, stencil parameters): the defaults, Courant numbers of both signs
# on every axis, and zero components (skipped, not added as 0 * (...))
OP_CASES = [
    ("advect3d", {}),
    ("advect3d", {"cx": 0.3, "cy": -0.2, "cz": 0.25}),
    ("advect3d", {"cx": -0.3, "cy": 0.2, "cz": -0.1}),
    ("advect3d", {"cx": 0.0, "cy": -0.5, "cz": 0.0}),
    ("advect2d", {}),
    ("advect2d", {"cx": -0.4, "cy": 0.2}),
    ("advect2d", {"cx": 0.0, "cy": -0.5}),
    ("grayscott3d", {}),
    ("grayscott3d", {"du": 0.12, "f": 0.04, "kappa": 0.062}),
    ("grayscott2d", {}),
]


def _ids(cases):
    return [n + "".join(f"-{k}{v}" for k, v in kw.items()) for n, kw in cases]


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _seeded(num_fields, grid, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(num_fields))


def _assert_fields(got, ref, halo, atol):
    """``got`` (tensors or arrays) vs ``ref``: tolerance, frame exact."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        if halo:
            for d in range(r.ndim):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * r.ndim
                    idx[d] = sl
                    np.testing.assert_array_equal(g[tuple(idx)],
                                                  r[tuple(idx)])


def _raw_tol(ref):
    return 32 * EPS32 * max(float(np.max(np.abs(np.asarray(ref[0])))), 1.0)


# ---------------------------------------------------------------------------
# the op layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", OP_CASES, ids=_ids(OP_CASES))
def test_stencil_fields_match_jax(name, kw):
    j, t = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    for f in ("ndim", "halo", "num_fields", "bc_value", "params",
              "field_halos", "mask_fields", "carry_map", "parity_sensitive"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert t.dtype == torch.float32 and t.phases is None
    assert t.invariant is None and j.invariant is None
    # the update itself, on one random padded block
    padded = _seeded(t.num_fields, tuple(g + 2 for g in GRIDS[t.ndim]), 4)
    ju = j.update(tuple(jnp.asarray(p) for p in padded))
    tu = t.update(fields_from_numpy(padded, device="cpu"))
    _assert_fields(tu, ju, None, _raw_tol(ju))


@pytest.mark.parametrize("steps", [1, 2, 8])
@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,kw", OP_CASES, ids=_ids(OP_CASES))
def test_make_step_matches_jax_for_k_steps(name, kw, periodic, steps):
    jst, tst = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    grid = GRIDS[tst.ndim]
    arrays = _seeded(tst.num_fields, grid, steps + len(kw))
    jstep = jdriver.make_step(jst, grid, periodic=periodic)
    tstep = tdriver.make_step(tst, grid, periodic=periodic)
    a = tuple(jnp.asarray(x) for x in arrays)
    b = fields_from_numpy(arrays, device="cpu")
    for _ in range(steps):
        a, b = jstep(a), tstep(b)
    _assert_fields(b, a, None if periodic else 1, _raw_tol(a))


@pytest.mark.parametrize("name,kw,match", [
    ("advect3d", {"cx": 0.5, "cy": 0.4, "cz": 0.3}, "unstable courant"),
    ("advect2d", {"cx": -0.7, "cy": 0.4}, "unstable courant"),
])
def test_unstable_courant_raises_as_jax(name, kw, match):
    with pytest.raises(ValueError, match=match) as je:
        jmake_stencil(name, **kw)
    with pytest.raises(ValueError, match=match) as te:
        port.make_stencil(name, **kw)
    assert str(te.value) == str(je.value)


def test_coefficients_come_from_the_op_layer():
    """The kernels' constants: the Courant numbers in grid-axis order and
    Gray-Scott's ``F + kappa`` as the one double the plain update forms."""
    adv = port.make_stencil("advect3d", cx=0.1, cy=-0.2, cz=0.3)
    assert trawstep.coefficients(adv) == (0.3, -0.2, 0.1, 0.0, 0.0)
    gs = port.make_stencil("grayscott3d", f=0.035, kappa=0.06)
    assert trawstep.coefficients(gs) == (0.1, 0.05, 0.035, 0.035 + 0.06, 0.0)
    assert treaction.coefficients(gs)[3] == gs.params["f"] + \
        gs.params["kappa"]
    assert tfullgrid._coefficients(port.make_stencil(
        "advect2d", cx=-0.4, cy=0.2))[:2] == (0.2, -0.4)
    assert tfullgrid._coefficients(port.make_stencil("grayscott2d"))[:4] \
        == treaction.coefficients(port.make_stencil("grayscott2d"))


# ---------------------------------------------------------------------------
# rows 3 and 4: the raw-step kernels' plain versions
# ---------------------------------------------------------------------------

RAW_CASES = [
    ("advect3d", (16, 10, 12), {"cx": 0.3, "cy": -0.2, "cz": 0.25}),
    ("advect3d", (16, 10, 12), {"cx": -0.4, "cy": 0.0, "cz": -0.3}),
    ("grayscott3d", (16, 12, 130), {}),
]


@pytest.mark.parametrize("init", ["auto", "seeded"])
@pytest.mark.parametrize("name,grid,kw", RAW_CASES,
                         ids=_ids([(n, kw) for n, _, kw in RAW_CASES]))
def test_raw_step_plain_matches_jax_raw_kernel(name, grid, kw, init):
    """K1 ``raw_step_heat[advect3d]`` and ``raw_step_grayscott``'s plain
    versions == ops/pallas/rawstep.py (interpret), 4 steps."""
    jst, tst = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    jraw = jrawstep.make_raw_step(jst, grid, interpret=True)
    traw = trawstep.make_raw_step(tst, grid, device="cpu")
    assert jraw is not None and traw is not None
    if init == "auto":
        arrays = tuple(np.asarray(f) for f in
                       jinit_state(jst, grid, 3, 0.2, "auto"))
    else:
        arrays = _seeded(tst.num_fields, grid, len(name))
    a = tuple(jnp.asarray(x) for x in arrays)
    b = fields_from_numpy(arrays, device="cpu")
    trawstep.launches.clear()
    for _ in range(4):
        a, b = jraw(a), traw(b)
    _assert_fields(b, a, 1, _raw_tol(a))
    assert not trawstep.launches  # CPU tensors never launch the kernel


def test_raw_step_support_matches_jax():
    for name in ("advect3d", "grayscott3d", "advect2d", "grayscott2d"):
        assert trawstep.raw_step_supported(port.make_stencil(name)) == \
            jrawstep.raw_step_supported(jmake_stencil(name)), name
    assert trawstep.make_raw_step(port.make_stencil("grayscott2d"),
                                  (16, 16)) is None
    assert trawstep.make_raw_step(port.make_stencil("advect3d"),
                                  (2, 16, 16)) is None


# ---------------------------------------------------------------------------
# row 6: K3, unsharded and in its sharded mode with the overlap shells
# ---------------------------------------------------------------------------

FUSED_CASES = [
    ("grayscott3d", {}),
    ("advect3d", {}),
    ("advect3d", {"cx": -0.3, "cy": 0.2, "cz": -0.1}),
]
_JAX_FUSED = {}


def _jax_fused(name, kw, grid, k, arrays, periodic=False):
    """k steps of ``make_fused_step`` (interpret) from ``arrays``, cached
    per case and input: the sharded cases share their unsharded
    reference."""
    key = (name, tuple(sorted(kw.items())), grid, k, periodic,
           hash(tuple(a.tobytes() for a in arrays)))
    if key not in _JAX_FUSED:
        fused = jfused.make_fused_step(jmake_stencil(name, **kw), grid, k,
                                       interpret=True, periodic=periodic)
        assert fused is not None
        out = fused(tuple(jnp.asarray(a) for a in arrays))
        _JAX_FUSED[key] = tuple(np.asarray(x) for x in out)
    return _JAX_FUSED[key]


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,kw", FUSED_CASES, ids=_ids(FUSED_CASES))
def test_fused_step_plain_matches_jax_fused_kernel(name, kw, periodic):
    grid, k = (16, 16, 128), 4
    st = port.make_stencil(name, **kw)
    arrays = tuple(np.asarray(f) for f in jinit_state(
        jmake_stencil(name, **kw), grid, 5, 0.15, "pulse", periodic=periodic))
    ref = _jax_fused(name, kw, grid, k, arrays, periodic)
    step = tfused.make_fused_step(st, grid, k, periodic=periodic,
                                  device="cpu")
    assert step is not None
    tfused.launches.clear()
    got = step(fields_from_numpy(arrays, device="cpu"))
    _assert_fields(got, ref, None if periodic else 1, 1e-4)
    assert not tfused.launches


@pytest.mark.parametrize("mesh_shape,grid,overlap", [
    ((2, 1, 1), (16, 16, 128), False),
    ((2, 2), (16, 16, 128), False),
    ((2,), (32, 16, 128), True),
    ((2, 2), (32, 32, 128), True),
], ids=["2x1x1", "2x2", "2-overlap", "2x2-overlap"])
@pytest.mark.parametrize("name,kw", FUSED_CASES, ids=_ids(FUSED_CASES))
def test_sharded_fused_matches_jax_fused_kernel(name, kw, mesh_shape, grid,
                                                overlap):
    """K3's sharded mode (and, with ``overlap``, the row-7 shells beside
    the interior) over virtual shards == the JAX package's fused kernel on
    the whole grid; the overlapped step equals the non-split one bit for
    bit."""
    k = 4
    st = port.make_stencil(name, **kw)
    arrays = _seeded(st.num_fields, grid, 9)
    ref = _jax_fused(name, kw, grid, k, arrays)
    mesh = _mesh(mesh_shape)
    step = tstepper.make_sharded_fused_step(st, mesh, grid, k,
                                            overlap=overlap)
    assert step is not None and step._overlap_active == overlap
    fields = tstepper.shard_fields(fields_from_numpy(arrays, device="cpu"),
                                   mesh, 3)
    tfused.launches.clear()
    got = step(fields)
    _assert_fields(gather_to_numpy(got), ref, 1, 1e-4)
    if overlap:
        plain = tstepper.make_sharded_fused_step(st, mesh, grid, k)(fields)
        for a, b in zip(got, plain):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not tfused.launches


def test_window_buffers_fit_shared_memory():
    """Gray-Scott keeps four window buffers (both fields read with their
    neighbours): 160 KB at k = 4, so k = 8 does not fit and is refused."""
    gs = port.make_stencil("grayscott3d")
    adv = port.make_stencil("advect3d")
    assert tfused.buffers(gs) == 4 and tfused.buffers(adv) == 2
    assert tfused.buffers(port.make_stencil("wave3d")) == 2
    assert tfused.smem_bytes(tfused.CORE, 4, 4) == 4 * 4 * 16 * 16 * 40
    assert tfused.fits(gs, 4) and not tfused.fits(gs, 8)
    assert tfused.fits(adv, 8)
    assert tfused.make_fused_step(gs, (32, 32, 128), 8, device="cpu") is None
    assert tfused.margin_of(gs, 4) == 4
    # K8: four buffers of (32 + 2k, 64 + 2k) at k = 16 take 96 KB
    g2 = port.make_stencil("grayscott2d")
    assert tfullgrid.smem_bytes(16, nbuf=4) == 4 * 4 * 64 * 96
    assert tfullgrid.fits(g2, 16)


# ---------------------------------------------------------------------------
# row 15: K8 for advect2d and grayscott2d
# ---------------------------------------------------------------------------

FULL_CASES = [("advect2d", {"cx": -0.4, "cy": 0.2}), ("advect2d", {}),
              ("grayscott2d", {})]


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,kw", FULL_CASES, ids=_ids(FULL_CASES))
def test_fullgrid_plain_matches_jax_fullgrid_kernel(name, kw, periodic):
    grid, k = (16, 128), 4
    jst, tst = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    arrays = tuple(np.asarray(f) for f in jinit_state(
        jst, grid, 7, 0.15, "auto", periodic=periodic))
    jstep = jfullgrid.make_fullgrid_step(jst, grid, k, interpret=True,
                                         periodic=periodic)
    ref = jstep(tuple(jnp.asarray(a) for a in arrays))
    tstep = tfullgrid.make_fullgrid_step(tst, grid, k, periodic=periodic,
                                         device="cpu")
    assert tfullgrid.fullgrid_supported(tst) and tstep is not None
    tfullgrid.launches.clear()
    got = tstep(fields_from_numpy(arrays, device="cpu"))
    _assert_fields(got, ref, None if periodic else 1, 1e-4)
    assert not tfullgrid.launches


@pytest.mark.parametrize("n,overlap", [(2, False), (2, True), (4, False)])
@pytest.mark.parametrize("name,kw", FULL_CASES, ids=_ids(FULL_CASES))
def test_sharded_fullgrid_matches_jax_fullgrid_kernel(name, kw, n, overlap):
    """K8's sharded mode on a row split (``--mesh n``), with the overlap
    shells where local rows >= 3m, == the JAX whole-grid kernel."""
    grid, k = (64, 128), 8
    jst, tst = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    arrays = _seeded(tst.num_fields, grid, 11)
    ref = jfullgrid.make_fullgrid_step(jst, grid, k, interpret=True)(
        tuple(jnp.asarray(a) for a in arrays))
    mesh = _mesh((n,))
    step = tstepper.make_sharded_temporal_step(tst, mesh, grid, k,
                                               overlap=overlap)
    assert step is not None and step._overlap_active == overlap
    got = step(tstepper.shard_fields(fields_from_numpy(arrays, device="cpu"),
                                     mesh, 2))
    _assert_fields(gather_to_numpy(got), ref, 1, 1e-4)


# ---------------------------------------------------------------------------
# the patch init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
@pytest.mark.parametrize("name,grid,mesh_shape,seed", [
    ("grayscott3d", (16, 12, 130), (2, 2), 3),
    ("grayscott3d", (32, 32, 64), (2,), 0),
    ("grayscott2d", (64, 96), (4,), 5),
    ("grayscott2d", (16, 24), (2, 2), 1),
], ids=["3d-2x2", "3d-2", "2d-4", "2d-2x2"])
def test_patch_init_is_bit_equal_to_jax(name, grid, mesh_shape, seed,
                                        periodic):
    """``patch`` from the same threefry bits, rounded as the JAX package's
    ``init_state`` rounds it: bit-equal unsharded and gathered from a mesh
    whose blocks are each computed at their own offsets; ``auto`` is
    ``patch`` for Gray-Scott."""
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    ref = tuple(np.asarray(f) for f in jinit_state(
        jst, grid, seed, 0.15, "patch", periodic=periodic))
    whole = init_state(tst, grid, seed, kind="patch", periodic=periodic,
                       device="cpu")
    for g, r in zip(whole, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    sharded = init_state_sharded(tst, grid, _mesh(mesh_shape), seed,
                                 kind="auto", periodic=periodic)
    counts = _mesh(mesh_shape).counts(len(grid))
    assert all(tuple(b.shape) == tuple(g // c for g, c in zip(grid, counts))
               for b in sharded[0])
    for g, r in zip(gather_to_numpy(sharded), ref):
        np.testing.assert_array_equal(g, r)
    # the JAX package's jitted sharded init lets XLA fuse 0.02 * noise +
    # (1 - 0.5 patch) into one multiply-add: u may sit 1 ulp from its own
    # unsharded init there (v is exact)
    jsh = jinit_state_sharded(jst, grid, jmesh.make_mesh(mesh_shape), seed,
                              0.15, "patch", periodic=periodic)
    np.testing.assert_array_max_ulp(np.asarray(jsh[0]), ref[0], maxulp=1)
    np.testing.assert_array_equal(np.asarray(jsh[1]), ref[1])


def test_patch_on_one_field_stencils_raises_as_jax():
    for name, grid in (("advect3d", (8, 8, 8)), ("heat2d", (8, 8))):
        with pytest.raises(ValueError) as je:
            jinit_state(jmake_stencil(name), grid, 0, 0.15, "patch")
        with pytest.raises(ValueError) as te:
            init_state(port.make_stencil(name), grid, kind="patch",
                       device="cpu")
        assert str(te.value) == str(je.value)
        assert "activator/inhibitor pair" in str(te.value)


# ---------------------------------------------------------------------------
# the slice as a whole: both CLIs on the same command lines
# ---------------------------------------------------------------------------

ITERS = 8
# (stencil, grid, flags): the port's run; the JAX CLI runs the same line,
# but for --compute pallas, whose kernel the JAX CLI runs on a TPU only:
# there its plain run is the reference (the raw kernel is held to that
# same plain step, tests/test_rawstep.py)
CLI_RUNS = [
    ("grayscott3d", "16,16,128", ["--compute", "jnp"]),
    ("grayscott3d", "16,16,128", ["--compute", "pallas"]),
    ("grayscott3d", "16,16,128", ["--fuse", "4"]),
    ("grayscott3d", "16,16,128", ["--fuse", "4", "--fuse-kind", "padfree"]),
    ("grayscott3d", "16,16,128", ["--fuse", "4", "--periodic"]),
    ("grayscott3d", "16,16,128", ["--compute", "jnp", "--periodic"]),
    ("grayscott3d", "32,16,128", ["--mesh", "2", "--fuse", "4"]),
    ("grayscott3d", "32,16,128", ["--mesh", "2", "--fuse", "4",
                                  "--overlap"]),
    ("grayscott3d", "16,16,128", ["--mesh", "2,2", "--compute", "jnp"]),
    ("grayscott3d", "32,32,128", ["--mesh", "2,2", "--fuse", "4",
                                  "--overlap"]),
    ("advect3d", "16,16,128", ["--param", "cz=-0.25", "--compute", "jnp"]),
    ("advect3d", "16,16,128", ["--param", "cz=-0.25", "--compute",
                               "pallas"]),
    ("advect3d", "16,16,128", ["--param", "cz=-0.25", "--fuse", "4"]),
    ("advect3d", "16,16,128", ["--param", "cx=-0.3", "--fuse", "4",
                               "--periodic"]),
    ("advect3d", "32,32,128", ["--param", "cz=-0.25", "--mesh", "2,2",
                               "--fuse", "4", "--overlap"]),
    ("advect2d", "32,128", ["--param", "cx=-0.4", "--fuse", "8"]),
    ("advect2d", "32,128", ["--mesh", "2", "--fuse", "8"]),
    ("grayscott2d", "32,128", ["--compute", "jnp"]),
    ("grayscott2d", "32,128", ["--fuse", "8"]),
    ("grayscott2d", "32,128", ["--mesh", "2", "--fuse", "8"]),
    ("grayscott2d", "64,128", ["--mesh", "2", "--fuse", "8", "--overlap"]),
    ("grayscott2d", "32,128", ["--mesh", "2", "--compute", "jnp"]),
]


def _run_both(tmp_path, port_args, jax_args):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "pt")
    assert jcli.main(jax_args + ["--checkpoint-dir", jdir]) == 0
    assert tcli.main(port_args + ["--checkpoint-dir", tdir,
                                  "--device", "cpu"]) == 0
    jf, jstep, _ = jckpt.load_checkpoint(jdir)
    tf, tstep, tcfg = tckpt.load_checkpoint(tdir)
    assert jstep == tstep
    return jf, tf, tcfg


@pytest.mark.parametrize("name,grid,flags", CLI_RUNS,
                         ids=[f"{n}-{g}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, g, fl in CLI_RUNS])
def test_cli_run_matches_jax_cli(tmp_path, monkeypatch, name, grid, flags):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", name, "--grid", grid, "--iters", str(ITERS),
            "--checkpoint-every", str(ITERS)]
    jflags = [("jnp" if f == "pallas" else f) for f in flags]
    for c in (trawstep.launches, tfused.launches, tfullgrid.launches):
        c.clear()
    jf, tf, tcfg = _run_both(tmp_path, base + flags, base + jflags)
    assert tcfg["stencil"] == name
    if "--overlap" in flags:
        assert tcfg["overlap"]
    if "--fuse" in flags:
        atol = 1e-4
    elif "--mesh" in flags:
        atol = 1e-5 * ITERS
    else:
        atol = _raw_tol(jf) * ITERS
    _assert_fields(tf, jf, None if "--periodic" in flags else 1, atol)
    # on the CPU every wrapper takes its plain version: no launches
    assert not (trawstep.launches or tfused.launches or tfullgrid.launches)


@pytest.mark.parametrize("name,grid,flags", [
    ("grayscott3d", "16,16,128", ["--fuse", "4"]),
    ("advect3d", "16,16,128", ["--compute", "pallas"]),
    ("grayscott2d", "32,128", ["--mesh", "2", "--fuse", "8"]),
])
def test_port_resumes_a_jax_checkpoint(tmp_path, monkeypatch, name, grid,
                                       flags):
    """A JAX run checkpoints at step 4 (both Gray-Scott fields through
    interop's field-by-field converters); the port resumes it to step 8 and
    matches JAX's uninterrupted 8-step run."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    k = 8 if "8" in flags else 4
    base = ["--stencil", name, "--grid", grid, "--checkpoint-every", str(k)]
    d = str(tmp_path / "shared")
    assert jcli.main(base + ["--iters", str(k), "--checkpoint-dir", d]) == 0
    assert tcli.main(base + ["--iters", str(2 * k), "--checkpoint-dir", d,
                             "--resume", "--device", "cpu", *flags]) == 0
    ref = str(tmp_path / "ref")
    assert jcli.main(base + ["--iters", str(2 * k), "--checkpoint-dir",
                             ref]) == 0
    tf, tstep, _ = tckpt.load_checkpoint(d)
    jf, jstep, _ = jckpt.load_checkpoint(ref)
    assert tstep == jstep == 2 * k and len(tf) == len(jf)
    atol = 1e-4 if "--fuse" in flags else _raw_tol(jf) * 2 * k
    _assert_fields(tf, jf, 1, atol)


# ---------------------------------------------------------------------------
# refusals by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra,exc,match", [
    # The three B5 ids keep their names from the refusals they pinned
    # before the streaming kernel took the two families (ROADMAP B5): the
    # stream kind now runs, unsharded and on a (z, y) mesh, and with
    # --periodic it declines as it does for every family.
    pytest.param(["--fuse", "4", "--fuse-kind", "stream"], None, None,
                 id="extra0-NotImplementedError-B5"),
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream"],
                 None, None, id="extra1-NotImplementedError-B5"),
    pytest.param(["--mesh", "4", "--fuse", "4", "--fuse-kind", "stream",
                  "--periodic"], ValueError, "unsupported",
                 id="extra2-NotImplementedError-B5"),
    # These two ids keep their names from the refusals they pinned before
    # K6 and K9 took the two families (ROADMAP B4): the pad-free kinds now
    # run (K9 on 2x2; K6 on --mesh 4, whose 8-plane shards cannot host the
    # shells, so --overlap falls back to the non-split step).
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree"],
                 None, None, id="extra3-NotImplementedError-B4"),
    pytest.param(["--mesh", "4", "--fuse", "4", "--fuse-kind", "padfree",
                  "--overlap"], None, None,
                 id="extra4-NotImplementedError-B4"),
    # This id keeps its name from the combined bfloat16 item it pinned
    # before the raw-step, stream and fused kernels took bfloat16: --fuse 4
    # in bfloat16 now meets the JAX CLI's own refusal (2*k*halo off the
    # bfloat16 alignment unit; k = 8 runs).
    pytest.param(["--fuse", "4", "--dtype", "bfloat16"], ValueError,
                 "sublane tile — 8 for f32, 16 for bf16",
                 id="extra5-NotImplementedError-B1/B3"),
])
@pytest.mark.parametrize("name", ["advect3d", "grayscott3d"])
def test_unported_kinds_raise_naming_roadmap(monkeypatch, name, extra, exc,
                                             match):
    """The stream kind (B5) and the pad-free kinds (B4) of the two
    families run and match the plain run at atol 1e-4, frame exact;
    bfloat16 --fuse 4 raises the JAX CLI's alignment refusal."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    tfused.launches.clear()
    args = ["--stencil", name, "--grid", "32,32,128", "--iters", "4",
            "--device", "cpu"]
    if exc is None:
        got, _ = tcli.run(tcli.config_from_args(args + extra))
        if tstepper.is_sharded(got):
            got = tstepper.gather_fields(got)
        ref, _ = tcli.run(tcli.config_from_args(args + ["--compute",
                                                        "jnp"]))
        _assert_fields([g.numpy() for g in got], [r.numpy() for r in ref],
                       1, 1e-4)
    else:
        with pytest.raises(exc, match=match):
            tcli.main(args + extra)
    assert not tfused.launches


@pytest.mark.parametrize("name,grid,extra", [
    ("grayscott3d", "16,16,128", ["--compute", "pallas", "--periodic"]),
    ("advect3d", "16,16,128", ["--compute", "pallas", "--periodic"]),
    ("grayscott3d", "16,16,128", ["--mesh", "2,2", "--compute", "pallas"]),
    ("advect2d", "32,128", ["--compute", "pallas"]),
    ("grayscott2d", "32,128", ["--mesh", "2", "--compute", "pallas"]),
])
def test_compute_pallas_without_a_kernel_raises_as_jax(monkeypatch, name,
                                                       grid, extra):
    """Where the raw kernel declines (--periodic, --mesh, 2D) no compute_fn
    kernel exists for these families: both CLIs raise the same error."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", grid, "--iters", "4", *extra]
    with pytest.raises(ValueError, match="no pallas kernel") as je:
        jcli.main(args)
    with pytest.raises(ValueError, match="no pallas kernel") as te:
        tcli.main(args + ["--device", "cpu"])
    assert str(te.value) == str(je.value)


def test_fuse_8_grayscott3d_exceeds_shared_memory():
    """Four window buffers at k = 8 do not fit one block: the CLI refuses,
    as for every window the port's shared-memory fit rule declines."""
    with pytest.raises(ValueError, match="fits shared memory"):
        tcli.main(["--stencil", "grayscott3d", "--grid", "32,32,128",
                   "--iters", "8", "--fuse", "8", "--device", "cpu"])
    # two buffers: advection's k = 8 window fits
    assert tcli.main(["--stencil", "advect3d", "--grid", "16,16,128",
                      "--iters", "8", "--fuse", "8", "--device", "cpu"]) == 0


def test_slab_and_stream_builders_refuse_the_new_families():
    """K6 and K9 take the two families (B4; the name is kept from when they
    refused them): their builders build, and their wrappers on a core cut
    from a (16, 16, 128) grid with its slabs (and corners) equal k plain
    steps of the whole grid there, bit for bit.  The streaming kernel
    takes them too (B5): build_stream_* build, decline ``periodic`` as
    for every family, and its wrapper equals k plain steps on the CPU."""
    gs, adv = port.make_stencil("grayscott3d"), port.make_stencil("advect3d")
    mixed = port.make_stencil("advect3d", cx=0.3, cy=-0.2, cz=-0.25)
    for st in (gs, adv, mixed):
        assert tfused.build_zslab_padfree_call(
            st, (8, 16, 128), (32, 16, 128), 4) is not None
        assert tfused.build_yzslab_padfree_call(
            st, (16, 16, 128), (32, 32, 128), 4) is not None
        full = tuple(torch.rand(16, 16, 128) for _ in range(st.num_fields))
        ref = tfused.plain_steps(full, st, 4)
        got = tfused.fused_zslab(tuple(f[4:12] for f in full),
                                 tuple(f[:4] for f in full),
                                 tuple(f[12:] for f in full), st, 4, 16, 4)
        for a, b in zip(got, ref):
            assert torch.equal(a, b[4:12])
        cut = ((slice(0, 4), slice(4, 12)), (slice(12, 16), slice(4, 12)),
               (slice(4, 12), slice(0, 4)), (slice(4, 12), slice(12, 16)),
               (slice(0, 4), slice(0, 4)), (slice(0, 4), slice(12, 16)),
               (slice(12, 16), slice(0, 4)), (slice(12, 16), slice(12, 16)))
        zlo, zhi, ylo, yhi, *corners = (tuple(f[z, y] for f in full)
                                        for z, y in cut)
        got = tfused.fused_yzslab(tuple(f[4:12, 4:12] for f in full), zlo,
                                  zhi, ylo, yhi, corners, st, 4,
                                  (16, 16, 128), (4, 4))
        for a, b in zip(got, ref):
            assert torch.equal(a, b[4:12, 4:12])
    for st in (gs, adv):
        assert tstream.stream_supported(st) and tstream.fits(st, 4)
        assert tstream.make_stream_fused_step(st, (16, 16, 128), 4)
        assert tstream.build_stream_sharded_call(
            st, (8, 16, 128), (32, 16, 128), 4, periodic=True) is None
        assert tstream.build_stream_sharded_call(
            st, (8, 16, 128), (32, 16, 128), 4) is not None
        core = tuple(torch.rand(8, 16, 128) for _ in range(st.num_fields))
        for a, b in zip(tstream.stream_step(core, st, 4),
                        tfused.plain_steps(core, st, 4)):
            assert torch.equal(a, b)
    # Gray-Scott's rings for u and v at every level: 72,448 bytes at k = 4
    # at the column every k is admitted at
    assert tstream.smem_bytes(gs, 4) == 2 * tstream.smem_bytes(adv, 4) \
        == 72448
    # the families the streaming kernel has stay admitted; 2D are not 3D
    assert tstream.stream_supported(port.make_stencil("wave3d"))
    assert not tstream.stream_supported(port.make_stencil("heat2d"))
    # every 2D family of the TPU kernel has its K8 kind (sor2d's since the
    # SOR slice)
    assert tfullgrid.fullgrid_supported(port.make_stencil("sor2d"))
