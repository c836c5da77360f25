"""The port's 2D path against the JAX package, on the CPU: Life, the random
init, and the plain versions of K7 (whole-grid compute_fn) and K8 (2D
k-step, whole grid and row shards).

The same inputs — numpy arrays from a seed, or the random init, which both
packages draw from the same threefry stream — go through the JAX function
and its counterpart in the port.  The JAX Pallas kernels run in interpret
mode, as the JAX package's own tests run them on the CPU.  Tolerances are
the JAX package's: Life (int32) bit-exact everywhere; K7 heat2d
``rtol = atol = 1e-6`` (tests/test_pallas.py); k fused steps and the
sharded steps ``atol = 1e-4, rtol = 0`` (tests/test_fullgrid.py); frame
cells equal.  On CPU tensors every wrapper takes its plain version, and no
kernel launches; tests/test_torch_cuda.py holds the kernels to those plain
versions on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import make_pallas_compute as jpallas
from mpi_cuda_process_tpu.ops.pallas.fullgrid import \
    make_fullgrid_step as jfullgrid
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state
from mpi_cuda_process_tpu.utils.init import \
    init_state_sharded as jinit_state_sharded

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                fields_to_numpy,
                                                gather_to_numpy,
                                                shard_from_numpy)
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils.init import (init_state,
                                                   init_state_sharded)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(n):
    return tmesh.make_mesh((n,), [CPU] * n)


def _inputs(name, grid, seed):
    """Seeded fields: 0/1 occupancy for Life, uniform floats else."""
    st = port.make_stencil(name)
    rng = np.random.default_rng(seed)
    if name == "life":
        return ((rng.random(grid) < 0.35).astype(np.int32),)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_same(got, ref, atol, halo=None):
    """Life and every frame cell exact; floats within ``atol``."""
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        if np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r)
            continue
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        if halo:
            for d in range(r.ndim):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * r.ndim
                    idx[d] = sl
                    np.testing.assert_array_equal(g[tuple(idx)],
                                                  r[tuple(idx)])


# ---------------------------------------------------------------------------
# the life stencil
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True], ids=["frame", "periodic"])
@pytest.mark.parametrize("steps", [1, 2, 5])
def test_life_matches_jax_make_step(steps, periodic):
    grid = (16, 20)
    arrays = _inputs("life", grid, steps)
    jstep = jax.jit(jdriver.make_step(jmake_stencil("life"), grid,
                                      periodic=periodic))
    tstep = tdriver.make_step(port.make_stencil("life"), grid,
                              periodic=periodic)
    a, b = _jax(arrays), fields_from_numpy(arrays, device="cpu")
    for _ in range(steps):
        a, b = jstep(a), tstep(b)
    assert b[0].dtype == torch.int32
    _assert_same(fields_to_numpy(b), a, 0)


def test_life_stencil_fields_match_jax():
    j, t = jmake_stencil("life"), port.make_stencil("life")
    for f in ("name", "ndim", "halo", "num_fields", "bc_value", "params",
              "field_halos", "mask_fields", "carry_map", "parity_sensitive"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.int32 and t.invariant.name == "population"
    assert t.invariant.rtol is None  # track-only
    x = _inputs("life", (9, 11), 3)
    assert float(t.invariant.fn(fields_from_numpy(x, device="cpu"))) == \
        float(j.invariant.fn(_jax(x)))


# ---------------------------------------------------------------------------
# the random init: the TPU package's threefry bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(16, 128), (33, 70)])
@pytest.mark.parametrize("density", [0.15, 0.5])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_init_is_bit_identical_to_jax(seed, density, grid):
    for name in ("life", "heat2d"):
        ref = jinit_state(jmake_stencil(name), grid, seed, density,
                          "random")
        got = init_state(port.make_stencil(name), grid, seed, density,
                         kind="random", device="cpu")
        _assert_same(fields_to_numpy(got), ref, 0, halo=1)
    # "auto" is "random" for Life
    auto = init_state(port.make_stencil("life"), grid, seed, density,
                      device="cpu")
    _assert_same(fields_to_numpy(auto), ref if name == "life" else
                 jinit_state(jmake_stencil("life"), grid, seed, density,
                             "random"), 0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("grid,seed,density",
                         [((16, 128), 0, 0.15), ((36, 70), 7, 0.5)])
def test_random_init_sharded_is_bit_identical_to_jax(grid, seed, density, n):
    """Each shard draws its own rows from the global flat index; gathered,
    the blocks equal the JAX package's sharded init and the unsharded one."""
    st = port.make_stencil("life")
    sharded = init_state_sharded(st, grid, _mesh(n), seed, density)
    assert all(tuple(b.shape) == (grid[0] // n, grid[1]) for b in sharded[0])
    ref = jinit_state_sharded(jmake_stencil("life"), grid,
                              jmesh.make_mesh((n,)), seed, density)
    _assert_same(gather_to_numpy(sharded), ref, 0)
    whole = init_state(st, grid, seed, density, device="cpu")
    assert torch.equal(tstepper.gather_fields(sharded)[0], whole[0])


def test_patch_init_still_raises_naming_a2():
    """The patch init is ported (the name is kept from when it raised
    naming ROADMAP A2): on the one-field heat2d it raises the JAX package's
    ValueError, on grayscott2d it gives the JAX package's bits."""
    with pytest.raises(ValueError, match="activator/inhibitor pair"):
        init_state(port.make_stencil("heat2d"), (8, 8), kind="patch",
                   device="cpu")
    got = init_state(port.make_stencil("grayscott2d"), (16, 24), 5,
                     kind="patch", device="cpu")
    ref = jinit_state(jmake_stencil("grayscott2d"), (16, 24), 5, 0.15,
                      "patch")
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# K7: the whole-grid compute_fn (plain version on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(16, 20), (33, 70)])
@pytest.mark.parametrize("name", ["life", "heat2d", "mdf"])
def test_k7_plain_matches_jax_pallas_kernel(name, grid):
    """K7's plain version == ops/pallas/kernels.py's _whole2d_compute
    (interpret) on the same padded block: life exact, heat2d 1e-6."""
    padded = _inputs(name, tuple(g + 2 for g in grid), 5)
    ref = jpallas(jmake_stencil(name), interpret=True)(_jax(padded))
    tkernels.launches.clear()
    got = tkernels.make_pallas_compute(port.make_stencil(name))(
        fields_from_numpy(padded, device="cpu"))
    assert not tkernels.launches  # CPU tensors never launch
    if name == "life":
        _assert_same(fields_to_numpy(got), ref, 0)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-6)


def test_k7_names_match_jax():
    """heat2d (and mdf, whose stencil is heat2d) and life have a compute_fn
    kernel; wave2d has none, in both packages."""
    from mpi_cuda_process_tpu.ops.pallas import has_pallas_kernel

    for name in ("heat2d", "mdf", "life", "wave2d"):
        st = port.make_stencil(name)
        assert tkernels.has_pallas_kernel(st.name) == \
            has_pallas_kernel(jmake_stencil(name).name)
    with pytest.raises(KeyError, match="no pallas kernel"):
        tkernels.make_pallas_compute(port.make_stencil("wave2d"))


# ---------------------------------------------------------------------------
# K8: 2D k-step, whole grid and row shards (plain versions on the CPU)
# ---------------------------------------------------------------------------

FULLGRID = [(name, grid, k) for name in ("life", "heat2d", "mdf", "wave2d")
            for grid, k in (((16, 128), 1), ((16, 128), 4), ((64, 256), 8))]


@pytest.mark.parametrize("periodic", [False, True], ids=["frame", "periodic"])
@pytest.mark.parametrize("name,grid,k", FULLGRID,
                         ids=[f"{n}-{g[0]}x{g[1]}-k{k}"
                              for n, g, k in FULLGRID])
def test_k8_plain_matches_jax_fullgrid(name, grid, k, periodic):
    arrays = _inputs(name, grid, k + len(name))
    jstep = jfullgrid(jmake_stencil(name), grid, k, interpret=True,
                      periodic=periodic)
    ref = jax.jit(jstep)(_jax(arrays))
    tfullgrid.launches.clear()
    step = tfullgrid.make_fullgrid_step(port.make_stencil(name), grid, k,
                                        periodic=periodic)
    got = step(fields_from_numpy(arrays, device="cpu"))
    assert not tfullgrid.launches
    _assert_same(fields_to_numpy(got), ref, 1e-4,
                 halo=None if periodic else 1)


SHARDED = [("life", 2, False), ("life", 4, False), ("life", 2, True),
           ("heat2d", 2, False), ("heat2d", 4, True), ("wave2d", 2, False)]


@pytest.mark.parametrize("name,n,periodic", SHARDED,
                         ids=[f"{n}-{m}shards-{'periodic' if p else 'frame'}"
                              for n, m, p in SHARDED])
def test_k8_sharded_matches_jax_sharded_fullgrid(name, n, periodic):
    """The port's row-split fused step (K8's sharded mode, plain on the
    CPU) == the JAX package's make_sharded_fullgrid_step (interpret), k=8
    on (64, 256); overlap on and off are bit-equal."""
    grid, k = (64, 256), 8
    arrays = _inputs(name, grid, n + len(name))
    jst = jmake_stencil(name)
    jm = jmesh.make_mesh((n,))
    jstep = jstepper.make_sharded_fullgrid_step(jst, jm, grid, k,
                                                interpret=True,
                                                periodic=periodic)
    ref = jstep(jstepper.shard_fields(_jax(arrays), jm, 2))
    st, mesh = port.make_stencil(name), _mesh(n)
    outs = []
    for overlap in (False, True):
        step = tstepper.make_sharded_temporal_step(
            st, mesh, grid, k, periodic=periodic, overlap=overlap)
        assert step._overlap_active == (overlap and grid[0] // n >= 3 * k)
        outs.append(gather_to_numpy(step(shard_from_numpy(arrays, mesh))))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    _assert_same(outs[0], ref, 1e-4, halo=None if periodic else 1)


def test_k8_sharded_origin_and_overlap_shells_exact():
    """Two fused passes of Life on a 3-shard row split, overlap on: the
    shells' origins and the interior splice give the unsharded plain
    steps exactly, frame included (a ragged 48-row grid, W not a multiple
    of 128: shapes the TPU kernel refuses)."""
    grid, k = (72, 50), 4
    arrays = _inputs("life", grid, 9)
    st = port.make_stencil("life")
    ref = fields_from_numpy(arrays, device="cpu")
    step = tdriver.make_step(st, grid)
    for _ in range(2 * k):
        ref = step(ref)
    fstep = tstepper.make_sharded_fullgrid_step(st, _mesh(3), grid, k,
                                                overlap=True)
    assert fstep._overlap_active
    f = shard_from_numpy(arrays, _mesh(3))
    f = fstep(fstep(f))
    np.testing.assert_array_equal(gather_to_numpy(f)[0], ref[0].numpy())


def test_k8_builders_decline_and_refuse_as_jax():
    st = port.make_stencil("heat2d")
    # x sharded, local rows below the margin, not divisible, 3D: None
    assert tstepper.make_sharded_fullgrid_step(
        st, tmesh.make_mesh((1, 2), [CPU] * 2), (64, 256), 8) is None
    assert tstepper.make_sharded_fullgrid_step(st, _mesh(4), (16, 128),
                                               8) is None
    assert tstepper.make_sharded_fullgrid_step(st, _mesh(3), (16, 128),
                                               4) is None
    assert tstepper.make_sharded_fullgrid_step(
        port.make_stencil("heat3d"), _mesh(2), (16, 16, 128), 4) is None
    assert tfullgrid.make_fullgrid_step(port.make_stencil("heat3d"),
                                        (16, 16, 128), 4) is None
    assert tfullgrid.make_fullgrid_step(st, (16, 128), 0) is None
    # the shapes the TPU alignment rules refuse run here
    assert tfullgrid.make_fullgrid_step(st, (15, 100), 3) is not None
    assert tstepper.make_sharded_fullgrid_step(st, _mesh(2), (26, 70),
                                               5) is not None
    # a forced 3D kind gives None for 2D; 3D-only options raise
    assert tstepper.make_sharded_temporal_step(st, _mesh(2), (64, 128), 8,
                                               kind="padfree") is None
    # every 2D family of the TPU kernel builds: sor2d too (margin 2k)
    sor2d = port.make_stencil("sor2d")
    assert tfullgrid.make_fullgrid_step(sor2d, (16, 128), 4) is not None
    assert tstepper.make_sharded_fullgrid_step(sor2d, _mesh(2), (64, 128),
                                               8) is not None


def test_interop_carries_int32_fields_unchanged():
    arrays = _inputs("life", (12, 10), 4)
    t = fields_from_numpy(arrays, device="cpu")
    assert t[0].dtype == torch.int32
    back = fields_to_numpy(t)
    assert back[0].dtype == np.int32
    np.testing.assert_array_equal(back[0], arrays[0])
    s = shard_from_numpy(arrays, _mesh(2))
    np.testing.assert_array_equal(gather_to_numpy(s)[0], arrays[0])


def test_auto_full_k_table_starts_empty_and_upgrades_when_filled(
        monkeypatch):
    """The H100 timings filled ``_AUTO_FULL_K`` (k = 8 for every 2D family,
    PERF.md section 5): an eligible 2D ``--compute auto`` run on a card
    becomes ``--fuse 8``; one whose cadence k does not divide, or one on
    the CPU, stays as it is; a family the table lacks is not upgraded."""
    assert tcli._AUTO_FULL_K == {name: 8 for name in (
        "heat2d", "life", "wave2d", "advect2d", "grayscott2d", "sor2d")}
    cfg = RunConfig(stencil="life", grid=(64, 128), iters=16, device="cuda")
    assert tcli.maybe_auto_fuse(cfg).fuse == 8
    odd = dataclasses.replace(cfg, iters=12)
    assert tcli.maybe_auto_fuse(odd) is odd  # cadence not a multiple of k
    cpu = dataclasses.replace(cfg, device="cpu")
    assert tcli.maybe_auto_fuse(cpu) is cpu
    monkeypatch.setattr(tcli, "_AUTO_FULL_K", {})
    assert tcli.maybe_auto_fuse(cfg) is cfg


# ---- K8's streaming kind: the kernel's row schedule (csrc/ring.cuh) ----------

from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream  # noqa
from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin  # noqa

import ring_schedule  # noqa: E402

# every 2D family of K8 and the kwargs of its stencil
SCHEDULE_2D = [("heat2d", {}), ("wave2d", {}), ("life", {}),
               ("advect2d", {"cx": -0.4, "cy": 0.3}), ("grayscott2d", {}),
               ("sor2d", {})]
SCHED2D_CASES = [(name, kw, k, dtype) for name, kw in SCHEDULE_2D
                 for k in (1, 2, 3, 4)
                 for dtype in ((torch.int32,) if name == "life"
                               else (torch.float32, torch.bfloat16))]
SCHED2D_TX, SCHED2D_CZ = 8, 5  # ragged strips and chunks of (14, 21)


def _sched2d(st, k, mode, dtype, slots, seed):
    """K8's streaming schedule on a (14, 21) grid (raw) or a (14, 21) row
    shard's padded block at global rows 14..27 of 42 (padded), beside the
    wrapper's plain version (CPU tensors)."""
    m = k_step_margin(st, k)
    Ly, W = 14, 21
    rows = Ly if mode == "raw" else Ly + 2 * m
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        ins = tuple(torch.from_numpy((rng.random((rows, W)) < 0.4)
                                     .astype(np.int32))
                    for _ in range(st.num_fields))
    else:
        ins = tuple(torch.from_numpy(rng.random((rows, W), dtype=np.float32))
                    .to(dtype) for _ in range(st.num_fields))
    if mode == "raw":
        window = ring_schedule.window_raw(ins, m)
        origin, gshape = (0, 0), (Ly, W)
        ref = tfullgrid.fullgrid_step(ins, st, k)
    else:
        window = ring_schedule.window_rows(ins, m)
        origin, gshape = (Ly, 0), (3 * Ly, W)
        ref = tfullgrid.fullgrid_padded(ins, st, k, 3 * Ly, Ly)
    got = ring_schedule.run(st, k, window, (Ly, W), origin, gshape,
                            (SCHED2D_TX,), slots, tstream.IN_FLIGHT,
                            chunk=SCHED2D_CZ)
    return got, ref


@pytest.mark.parametrize("mode", ["raw", "padded"])
@pytest.mark.parametrize("name,kw,k,dtype", SCHED2D_CASES)
def test_k8_stream_schedule_on_its_ring_slots_is_k_plain_steps(
        name, kw, k, dtype, mode):
    """K8's streaming kind (csrc/ring.cuh with the 2D kinds: strips
    marched down chunks of rows, one ring of rows a level, each chunk led
    in by its 2m rows) on rings of exactly ``streamfused.ring_slots``
    rows, the counts every launch passes, reads only rows its rings hold
    and equals k plain steps (the whole grid, a row shard's padded block)
    bit for bit: every family, float32 and bfloat16, Life in int32."""
    st = port.make_stencil(name, dtype=dtype, **kw)
    got, ref = _sched2d(st, k, mode, dtype, tstream.ring_slots(st, k), 3 + k)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == dtype
        assert torch.equal(g, r), (name, k, mode)


@pytest.mark.parametrize("name,kw", SCHEDULE_2D)
def test_k8_stream_schedule_races_on_a_ring_one_slot_short(name, kw):
    """A level-0 ring or a level ring one row shorter than ``ring_slots``
    gives (k = 3) makes some level read a row its ring no longer, or not
    yet, holds."""
    st = port.make_stencil(name, **kw)
    s0, s1 = tstream.ring_slots(st, 3)
    for slots in ((s0 - 1, s1), (s0, s1 - 1)):
        with pytest.raises(ring_schedule.Race):
            _sched2d(st, 3, "padded", st.dtype, slots, 5)


def test_k8_stream_kind_takes_every_guard_frame_launch():
    """Every guard-frame launch of the main path (k = 8; bfloat16 k = 16,
    sor2d 8; a 16384^2 grid or a 4096-row shard) runs the streaming kind
    at its RING_TILES tile, whose rings fit; periodic launches, an overlap
    shell's few rows and levels beyond a block's warps keep the tiled kind;
    K8's admission (``fits``) is unchanged."""
    for name, kw in SCHEDULE_2D:
        for dtype in ((torch.int32,) if name == "life"
                      else (torch.float32, torch.bfloat16)):
            st = port.make_stencil(name, dtype=dtype, **kw)
            k = tfullgrid._steps_per_launch(st)
            for kk in (1, 8, k):
                assert tfullgrid.ring_ok(st, kk, False, 4096)
                assert not tfullgrid.ring_ok(st, kk, True, 4096)
                m = tfullgrid.k_step_margin(st, kk)
                assert not tfullgrid.ring_ok(st, kk, False, 2 * m)
                tile = tfullgrid.ring_tile(st, kk)
                assert tstream.smem_bytes(st, kk, tile) <= \
                    tfullgrid.SMEM_LIMIT
                assert tstream.level_warps_fit(tstream.levels(st, kk),
                                               tile[2])
                assert tile[2] <= 1024 and tile[3] in (1, 2)
            kmain = 16 if dtype == torch.bfloat16 and name != "sor2d" else 8
            assert (name, str(dtype)[6:], kmain) in tfullgrid.RING_TILES
    st = port.make_stencil("heat2d")
    assert not tfullgrid.ring_ok(st, 33, False, 16384)  # 33 levels > 32
    assert tfullgrid.fits(st, 33)  # the tiled kind takes it
