"""Red-black SOR (sor2d, sor3d) in the port against the JAX package, on the
CPU.

Every layer of the slice: the op layer (``ops/sor.py``: registry fields,
the half-sweeps, the residual invariant) and ``make_step`` against JAX
``make_step``; a numpy red-black golden written here; the refusals both
packages make; sharded against unsharded over virtual CPU devices, bit for
bit; the plain versions of the SOR kernels (K3 and its sharded mode with
the overlap shells, K6, K9, K10 unsharded and sharded, K8 whole-grid and
row-split) against the JAX kernels in interpret mode at the JAX tests'
sizes; and both CLIs on the same command lines, ``--tol`` runs included,
their ``npy`` checkpoints compared.  Inputs are numpy arrays from a seed or
the deterministic inits.

Tolerances: float32 ``atol = 1e-4, rtol = 0`` against JAX (the JAX
package's own rule for its fused kernels, tests/test_fused.py, whose
micro-steps add the Laplacian's taps in another order), guard-frame cells
exactly; the port's paths against each other bit-equal.  On CPU tensors
every wrapper takes its plain version; tests/test_torch_cuda.py holds the
kernels to those on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fullgrid as jfullgrid
from mpi_cuda_process_tpu.ops.pallas import fused as jfused
from mpi_cuda_process_tpu.ops.pallas import streamfused as jstream
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import checkpointing as jckpt
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                gather_to_numpy)
from mpi_cuda_process_tpu_torch.ops import stencil as tstencil
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-4
COUNTERS = (trawstep.launches, tfused.launches, tfullgrid.launches,
            tstream.launches)


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _seeded(grid, seed, scale=100.0):
    rng = np.random.default_rng(seed)
    return (rng.random(grid, dtype=np.float32) * np.float32(scale),)


def _pulse(name, grid, seed=5, periodic=False):
    return tuple(np.asarray(f) for f in jinit_state(
        jmake_stencil(name), grid, seed, 0.15, "pulse", periodic=periodic))


def _numpy(fields):
    return [f.detach().cpu().numpy() if isinstance(f, torch.Tensor)
            else np.asarray(f) for f in fields]


def _assert_fields(got, ref, halo, atol):
    """``got`` vs ``ref`` (tensors or arrays): tolerance, frame exact."""
    got, ref = _numpy(got), _numpy(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
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


def _equal(a, b):
    """Bit-equal fields (tensors, sharded fields gathered)."""
    if tstepper.is_sharded(a):
        a = tstepper.gather_fields(a)
    if tstepper.is_sharded(b):
        b = tstepper.gather_fields(b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _plain(name, grid, arrays, k, periodic=False):
    """k plain steps of the port from ``arrays``."""
    step = tdriver.make_step(port.make_stencil(name), grid, periodic=periodic)
    fields = fields_from_numpy(arrays, device="cpu")
    for _ in range(k):
        fields = step(fields)
    return fields


# ---------------------------------------------------------------------------
# the op layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("sor2d", {}), ("sor3d", {}),
                                     ("sor3d", {"omega": 1.2, "bc": 0.0})])
def test_stencil_fields_and_half_sweeps_match_jax(name, kw):
    j, t = jmake_stencil(name, **kw), port.make_stencil(name, **kw)
    for f in ("ndim", "halo", "num_fields", "bc_value", "params",
              "field_halos", "mask_fields", "carry_map", "parity_sensitive"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert t.dtype == torch.float32 and len(t.phases) == len(j.phases) == 2
    for f in ("name", "rtol", "mode", "scale"):
        assert getattr(t.invariant, f) == getattr(j.invariant, f)
    jhalo = (jfused._halo_per_micro if t.ndim == 3
             else jfullgrid._halo_per_micro_2d)
    assert tstencil.k_step_margin(t, 1) == jhalo(j) == 2
    # each half-sweep on one random padded block
    padded = _seeded(tuple(g + 2 for g in (10, 12, 14)[:t.ndim]), 3)
    for jp, tp in zip(j.phases, t.phases):
        ju = jp(tuple(jnp.asarray(p) for p in padded))
        tu = tp(fields_from_numpy(padded, device="cpu"))
        _assert_fields(tu, ju, None, 0.0)


def test_registry_lists_the_fourteen_stencils_of_jax():
    assert port.available_stencils() == sorted(
        __import__("mpi_cuda_process_tpu").available_stencils())
    assert len(port.available_stencils()) == 14


@pytest.mark.parametrize("name,grid", [("sor2d", (12, 10)),
                                       ("sor3d", (8, 10, 12))])
def test_residual_invariant_matches_jax(name, grid):
    j, t = jmake_stencil(name), port.make_stencil(name)
    arrays = _seeded(grid, 6)
    a = _plain(name, grid, arrays, 3)
    jv = float(j.invariant.fn(tuple(jnp.asarray(x) for x in _numpy(a))))
    tv = float(t.invariant.fn(a))
    assert tv == pytest.approx(jv, rel=1e-6)
    # the residual falls as the solver relaxes
    assert float(t.invariant.fn(_plain(name, grid, arrays, 20))) < tv


# (stencil, grid, periodic): the guard frame everywhere, periodic at even
# extents (odd ones are refused, test_parity_refusals_match_jax)
SOR_GRIDS = [("sor2d", (16, 128), False), ("sor2d", (16, 128), True),
             ("sor2d", (33, 40), False), ("sor3d", (10, 12, 14), False),
             ("sor3d", (10, 12, 14), True)]


@pytest.mark.parametrize("steps", [1, 2, 8])
@pytest.mark.parametrize("name,grid,periodic", SOR_GRIDS,
                         ids=[f"{n}-{'x'.join(map(str, g))}-"
                              f"{'periodic' if p else 'frame'}"
                              for n, g, p in SOR_GRIDS])
def test_make_step_matches_jax_for_k_steps(name, grid, periodic, steps):
    jst = jmake_stencil(name)
    arrays = _seeded(grid, steps)
    jstep = jdriver.make_step(jst, grid, periodic=periodic)
    a = tuple(jnp.asarray(x) for x in arrays)
    for _ in range(steps):
        a = jstep(a)
    b = _plain(name, grid, arrays, steps, periodic)
    _assert_fields(b, a, None if periodic else 1, ATOL)


def _np_redblack_sor(u, omega, steps):
    """Independent numpy red-black SOR (frame fixed, sequential
    semantics)."""
    u = u.copy()
    h, w = u.shape
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(steps):
        for color in (0, 1):
            nsum = (np.roll(u, 1, 0) + np.roll(u, -1, 0)
                    + np.roll(u, 1, 1) + np.roll(u, -1, 1))
            relaxed = (1 - omega) * u + omega / 4.0 * nsum
            mask = ((yy + xx) % 2 == color)
            mask &= (yy > 0) & (yy < h - 1) & (xx > 0) & (xx < w - 1)
            u = np.where(mask, relaxed, u)
    return u


def test_sor2d_matches_numpy_golden():
    st = port.make_stencil("sor2d", omega=1.5)
    u0 = np.random.RandomState(1).rand(10, 12).astype(np.float32) * 50
    step = tdriver.make_step(st, u0.shape)
    got = step(step(fields_from_numpy((u0,), device="cpu")))
    want = _np_redblack_sor(u0, 1.5, 2)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-5, atol=1e-4)
    # K8's plain version (two steps in one call) is the same function
    two = tfullgrid.make_fullgrid_step(st, u0.shape, 2, device="cpu")(
        fields_from_numpy((u0,), device="cpu"))
    assert torch.equal(two[0], got[0])


def test_sor_black_sees_fresh_red():
    """Gauss-Seidel: the black half-sweep reads this step's red values."""
    st = port.make_stencil("sor2d", omega=1.0, bc=0.0)
    u0 = torch.zeros((6, 6))
    u0[2, 2] = 16.0  # (2 + 2) even: red
    out = tdriver.make_step(st, (6, 6))((u0,))[0]
    # the red cell relaxes to the mean of zeros; its black neighbours read
    # that fresh 0, not the old 16 (Jacobi would give 4 at (2, 3))
    assert float(out[2, 2]) == 0.0 and float(out[2, 3]) == 0.0


# ---------------------------------------------------------------------------
# refusals, as the JAX package makes them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("omega", [0.0, 2.0, -0.5])
def test_bad_omega_raises_as_jax(omega):
    with pytest.raises(ValueError, match="diverges") as je:
        jmake_stencil("sor3d", omega=omega)
    with pytest.raises(ValueError, match="diverges") as te:
        port.make_stencil("sor3d", omega=omega)
    assert str(te.value) == str(je.value)


def test_update_and_compute_fn_raise_as_jax():
    j, t = jmake_stencil("sor2d"), port.make_stencil("sor2d")
    with pytest.raises(NotImplementedError) as je:
        j.update((jnp.zeros((4, 4)),))
    with pytest.raises(NotImplementedError) as te:
        t.update((torch.zeros(4, 4),))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="multi-phase"):
        tdriver.make_step(t, (4, 4), compute_fn=lambda p: p)


def test_parity_refusals_match_jax():
    """Periodic wraps over odd extents and odd per-shard extents flip the
    colouring: both packages refuse them; the k-step builders decline."""
    for name, grid in (("sor2d", (33, 40)), ("sor3d", (10, 12, 15))):
        with pytest.raises(ValueError, match="parity-sensitive") as je:
            jdriver.make_step(jmake_stencil(name), grid, periodic=True)
        with pytest.raises(ValueError, match="parity-sensitive") as te:
            tdriver.make_step(port.make_stencil(name), grid, periodic=True)
        assert str(te.value) == str(je.value)
    st, jst = port.make_stencil("sor3d"), jmake_stencil("sor3d")
    for grid, mesh in (((18, 16, 16), (2,)), ((16, 18, 16), (2, 2))):
        with pytest.raises(ValueError, match="odd per-shard") as je:
            jstepper.make_sharded_step(jst, jmesh.make_mesh(mesh), grid)
        with pytest.raises(ValueError, match="odd per-shard") as te:
            tstepper.make_sharded_step(st, _mesh(mesh), grid)
        assert str(te.value) == str(je.value)
    # the k-step kernels: odd shard extents, odd periodic wraps
    assert tstepper.make_sharded_fused_step(st, _mesh((2,)), (34, 16, 128),
                                            2) is None
    assert tstepper.make_sharded_fused_step(st, _mesh((2,)), (34, 16, 128),
                                            2, kind="stream") is None
    assert tstepper.make_sharded_fused_step(
        st, _mesh((2,)), (32, 16, 129), 2, periodic=True) is None
    assert tfused.make_fused_step(st, (16, 16, 129), 4, periodic=True) \
        is None
    assert tfused.make_fused_step(st, (16, 16, 129), 4) is not None
    s2 = port.make_stencil("sor2d")
    assert tfullgrid.make_fullgrid_step(s2, (33, 40), 4, periodic=True) \
        is None
    assert tstepper.make_sharded_fullgrid_step(s2, _mesh((2,)), (66, 128),
                                               4) is None
    assert tstepper.make_sharded_fullgrid_step(s2, _mesh((2,)), (64, 128),
                                               4) is not None


def test_k_step_margin_is_two_per_step():
    """m = k * halo * phases: sor3d takes k = 2 and 4 and declines k = 1
    (2m off the alignment unit) and k = 8 (shared memory), as the JAX
    alignment rule and the port's fit rule say; K3 relaxes it in place in
    one buffer of its own core; the stream kernel's level rings fit up to
    k = 6 (twelve half-sweeps), not at k = 7."""
    st, jst = port.make_stencil("sor3d"), jmake_stencil("sor3d")
    assert [tfused.margin_of(st, k) for k in (1, 2, 3, 4, 8)] == \
        [None, 4, None, 8, None]
    for k in (1, 2, 4):
        assert (tfused.make_fused_step(st, (16, 16, 128), k) is None) == \
            (jfused.make_fused_step(jst, (16, 16, 128), k, interpret=True)
             is None), k
    # one buffer (in place) of its larger core: 192 KB at k = 4
    assert tfused.buffers(st) == 1 and tfused.core_of(st) == tfused.SOR_CORE
    assert tfused.smem_bytes(tfused.SOR_CORE, 8, 1) == 196608 <= \
        tfused.SMEM_LIMIT
    assert tstream.smem_bytes(st, 4) == 96512 and tstream.fits(st, 6)
    assert not tstream.fits(st, 7)
    s2 = port.make_stencil("sor2d")
    assert tstencil.k_step_margin(s2, 8) == 16
    assert tfullgrid._steps_per_launch(s2) == 8
    assert tfullgrid.build_fullgrid_masked_call(s2, (64 + 32, 128), 8, 8,
                                                periodic=True) is None
    assert tfullgrid.build_fullgrid_masked_call(s2, (64 + 32, 128), 16, 8,
                                                periodic=True) is not None


# ---------------------------------------------------------------------------
# sharded against unsharded, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_shape", [(2,), (2, 2), (4,)])
@pytest.mark.parametrize("name,grid", [("sor2d", (16, 16)),
                                       ("sor3d", (16, 16, 8))])
def test_sharded_matches_unsharded_bit_for_bit(name, grid, mesh_shape):
    st = port.make_stencil(name)
    arrays = _seeded(grid, 7)
    ref = _plain(name, grid, arrays, 6)
    mesh = _mesh(mesh_shape)
    step = tstepper.make_sharded_step(st, mesh, grid)
    got = tstepper.shard_fields(fields_from_numpy(arrays, device="cpu"),
                                mesh, st.ndim)
    for _ in range(6):
        got = step(got)
    assert _equal(got, ref)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _jax_sharded(grid, mesh_shape, k, arrays, **kw):
    step = jstepper.make_sharded_fused_step(
        jmake_stencil("sor3d"), jmesh.make_mesh(mesh_shape), grid, k,
        interpret=True, **kw)
    assert step is not None
    mesh = jmesh.make_mesh(mesh_shape)
    from mpi_cuda_process_tpu import shard_fields as jshard
    return step(jshard(tuple(jnp.asarray(a) for a in arrays), mesh, 3))


def _port_sharded(grid, mesh_shape, k, arrays, **kw):
    st = port.make_stencil("sor3d")
    mesh = _mesh(mesh_shape)
    step = tstepper.make_sharded_fused_step(st, mesh, grid, k, **kw)
    assert step is not None
    return step, step(tstepper.shard_fields(
        fields_from_numpy(arrays, device="cpu"), mesh, 3))


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
def test_fused_step_plain_matches_jax_fused_kernel(periodic):
    """Row 6's rest: K3's SOR kind (``_micro_sor``) at (16, 16, 128), k = 4
    (margin 8)."""
    grid, k = (16, 16, 128), 4
    arrays = _pulse("sor3d", grid, periodic=periodic)
    ref = jfused.make_fused_step(jmake_stencil("sor3d"), grid, k,
                                 interpret=True, periodic=periodic)(
        tuple(jnp.asarray(a) for a in arrays))
    step = tfused.make_fused_step(port.make_stencil("sor3d"), grid, k,
                                  periodic=periodic, device="cpu")
    for c in COUNTERS:
        c.clear()
    got = step(fields_from_numpy(arrays, device="cpu"))
    _assert_fields(got, ref, None if periodic else 1, ATOL)
    assert _equal(got, _plain("sor3d", grid, arrays, k, periodic))
    assert not any(COUNTERS)  # CPU tensors never launch


@pytest.mark.parametrize("case", ["padded", "shells", "zslab", "yzslab"])
def test_sharded_fused_plain_matches_jax_kernels(case):
    """K3's sharded mode at (32, 16, 128) on (2, 1, 1); the overlap shells
    at (64, 16, 128) on (2, 1, 1); K6 at (32, 16, 128) on (2, 1, 1); K9 at
    (32, 32, 128) on (2, 2, 1): each against the JAX kernel of the same
    mode, and bit-equal to the port's unsharded plain steps (the overlapped
    step to the non-split one)."""
    k = 4
    grid, mesh_shape, kw, jkw = {
        "padded": ((32, 16, 128), (2, 1, 1), {}, {}),
        "shells": ((64, 16, 128), (2, 1, 1), {"overlap": True},
                   {"overlap": True}),
        "zslab": ((32, 16, 128), (2, 1, 1), {"kind": "padfree"},
                  {"padfree": True}),
        "yzslab": ((32, 32, 128), (2, 2, 1), {"kind": "padfree"},
                   {"padfree": True}),
    }[case]
    arrays = _pulse("sor3d", grid, seed=9)
    ref = _jax_sharded(grid, mesh_shape, k, arrays, **jkw)
    for c in COUNTERS:
        c.clear()
    step, got = _port_sharded(grid, mesh_shape, k, arrays, **kw)
    assert step._overlap_active == (case == "shells")
    if case in ("zslab", "yzslab"):
        assert step._padfree_kind == case
    _assert_fields(gather_to_numpy(got), ref, 1, ATOL)
    assert _equal(got, _plain("sor3d", grid, arrays, k))
    if case == "shells":
        _, plain = _port_sharded(grid, mesh_shape, k, arrays)
        assert _equal(got, plain)
    assert not any(COUNTERS)


@pytest.mark.parametrize("grid,mesh_shape", [((48, 32, 128), None),
                                             ((96, 32, 128), (2, 1, 1))])
def test_stream_plain_matches_jax_stream_kernels(grid, mesh_shape):
    """K10's SOR kind (rows 16 and 17) against the JAX streaming kernels at
    test_streamfused.py's SOR sizes, k = 4."""
    k = 4
    arrays = _pulse("sor3d", grid, seed=9)
    for c in COUNTERS:
        c.clear()
    if mesh_shape is None:
        ref = jstream.make_stream_fused_step(
            jmake_stencil("sor3d"), grid, k, interpret=True)(
            tuple(jnp.asarray(a) for a in arrays))
        got = tstream.make_stream_fused_step(
            port.make_stencil("sor3d"), grid, k, device="cpu")(
            fields_from_numpy(arrays, device="cpu"))
    else:
        ref = _jax_sharded(grid, mesh_shape, k, arrays, kind="stream")
        step, got = _port_sharded(grid, mesh_shape, k, arrays,
                                  kind="stream")
        assert step._padfree_kind == "stream_z"
        got = gather_to_numpy(got)
    _assert_fields(got, ref, 1, ATOL)
    if mesh_shape is None:
        assert _equal(got, _plain("sor3d", grid, arrays, k))
    assert not any(COUNTERS)


def test_stream_yz_plain_equals_unsharded_plain():
    """K10 on a mesh that shards y (row 18) and K9 are the same function as
    k plain steps, with and without the overlap shells."""
    grid, k = (48, 48, 128), 2
    arrays = _pulse("sor3d", grid, seed=4)
    ref = _plain("sor3d", grid, arrays, k)
    for kw in ({"kind": "stream"}, {"kind": "stream", "overlap": True}):
        step, got = _port_sharded(grid, (2, 2), k, arrays, **kw)
        assert step._padfree_kind == "stream_yz"
        assert step._overlap_active == kw.get("overlap", False)
        assert _equal(got, ref)


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["frame", "periodic"])
def test_fullgrid_plain_matches_jax_fullgrid_kernel(periodic):
    """Row 15's rest: K8's sor2d kind at (16, 128), k = 4."""
    grid, k = (16, 128), 4
    arrays = _pulse("sor2d", grid, seed=7, periodic=periodic)
    ref = jfullgrid.make_fullgrid_step(jmake_stencil("sor2d"), grid, k,
                                       interpret=True, periodic=periodic)(
        tuple(jnp.asarray(a) for a in arrays))
    st = port.make_stencil("sor2d")
    assert tfullgrid.fullgrid_supported(st)
    for c in COUNTERS:
        c.clear()
    got = tfullgrid.make_fullgrid_step(st, grid, k, periodic=periodic,
                                       device="cpu")(
        fields_from_numpy(arrays, device="cpu"))
    _assert_fields(got, ref, None if periodic else 1, ATOL)
    assert _equal(got, _plain("sor2d", grid, arrays, k, periodic))
    assert not any(COUNTERS)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_fullgrid_plain_matches_jax(overlap):
    """K8's sharded mode for sor2d (margin 2k) at (64, 128) on ``--mesh 2``,
    k = 8, against the JAX row-split kernel; with the overlap shells at
    (128, 128), where local rows reach 3m."""
    k = 8
    grid = (128, 128) if overlap else (64, 128)
    arrays = _seeded(grid, 11)
    jstep = jstepper.make_sharded_fullgrid_step(
        jmake_stencil("sor2d"), jmesh.make_mesh((2,)), grid, k,
        interpret=True, overlap=overlap)
    from mpi_cuda_process_tpu import shard_fields as jshard
    ref = jstep(jshard(tuple(jnp.asarray(a) for a in arrays),
                       jmesh.make_mesh((2,)), 2))
    st = port.make_stencil("sor2d")
    mesh = _mesh((2,))
    step = tstepper.make_sharded_temporal_step(st, mesh, grid, k,
                                               overlap=overlap)
    assert step._overlap_active == overlap
    got = step(tstepper.shard_fields(fields_from_numpy(arrays, device="cpu"),
                                     mesh, 2))
    _assert_fields(gather_to_numpy(got), ref, 1, ATOL)
    assert _equal(got, _plain("sor2d", grid, arrays, k))


# ---------------------------------------------------------------------------
# the slice as a whole: both CLIs on the same command lines
# ---------------------------------------------------------------------------

ITERS = 8
CLI_RUNS = [
    ("sor3d", "16,16,128", ["--compute", "jnp"]),
    ("sor3d", "16,16,128", ["--fuse", "4"]),
    ("sor3d", "16,16,128", ["--fuse", "4", "--periodic"]),
    ("sor3d", "48,32,128", ["--fuse", "4", "--fuse-kind", "stream"]),
    ("sor3d", "32,16,128", ["--mesh", "2", "--fuse", "4", "--fuse-kind",
                            "padfree"]),
    ("sor3d", "64,16,128", ["--mesh", "2", "--fuse", "4", "--overlap"]),
    ("sor3d", "32,32,128", ["--mesh", "2,2", "--fuse", "4", "--fuse-kind",
                            "padfree"]),
    ("sor3d", "16,16,128", ["--mesh", "2,2", "--compute", "jnp"]),
    ("sor2d", "32,128", ["--fuse", "8"]),
    ("sor2d", "64,128", ["--mesh", "2", "--fuse", "8"]),
]


def _run_both(tmp_path, args):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "pt")
    assert jcli.main(args + ["--checkpoint-dir", jdir]) == 0
    assert tcli.main(args + ["--checkpoint-dir", tdir, "--device", "cpu"]) \
        == 0
    jf, jstep, _ = jckpt.load_checkpoint(jdir)
    tf, tstep, tcfg = tckpt.load_checkpoint(tdir)
    return jf, jstep, tf, tstep, tcfg


@pytest.mark.parametrize("name,grid,flags", CLI_RUNS,
                         ids=[f"{n}-{g}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, g, fl in CLI_RUNS])
def test_cli_run_matches_jax_cli(tmp_path, monkeypatch, name, grid, flags):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    for c in COUNTERS:
        c.clear()
    jf, jstep, tf, tstep, tcfg = _run_both(
        tmp_path, ["--stencil", name, "--grid", grid, "--iters", str(ITERS),
                   "--checkpoint-every", str(ITERS), *flags])
    assert jstep == tstep == ITERS and tcfg["stencil"] == name
    _assert_fields(tf, jf, None if "--periodic" in flags else 1, ATOL)
    assert not any(COUNTERS)


@pytest.mark.parametrize("name,grid,flags", [
    ("sor3d", "16,16,128", []),
    ("sor3d", "16,16,128", ["--fuse", "4"]),
    ("sor2d", "32,128", ["--fuse", "8"]),
    ("sor3d", "32,16,128", ["--mesh", "2", "--fuse", "4"]),
])
def test_tol_run_converges_at_the_step_jax_does(tmp_path, monkeypatch, name,
                                                grid, flags):
    """``--tol 1e-3 --tol-check-every 8``: the same converged step count
    and the same final fields (checkpointed at that step) as the JAX CLI.

    The default problem (walls at 100) runs for the step count and, bit for
    bit, against the JAX package's eager ``make_step`` applied that many
    times: over such a run (64 steps at 16x16x128) the JAX CLI's own
    compiled loop drifts 1.3e-4 from that eager step (XLA's fusion), more
    than the tolerance, so the fields are held to the JAX CLI on the same
    problem at unit scale (``--param bc=1``), where that drift is far
    below it."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", name, "--grid", grid, "--iters", "400", "--tol",
            "1e-3", "--tol-check-every", "8", *flags]
    _, jstep, tf, tstep, _ = _run_both(tmp_path / "bc100", base)
    assert 0 < tstep == jstep < 400
    shape = tuple(int(g) for g in grid.split(","))
    init = tuple(np.asarray(f) for f in jinit_state(
        jmake_stencil(name), shape, 0, 0.15, "auto"))
    ref = tuple(jnp.asarray(a) for a in init)
    step = jdriver.make_step(jmake_stencil(name), shape)
    for _ in range(jstep):
        ref = step(ref)
    _assert_fields(tf, ref, 1, 0.0)
    jf, jstep, tf, tstep, _ = _run_both(tmp_path / "bc1",
                                        base + ["--param", "bc=1.0"])
    assert 0 < tstep == jstep < 400
    _assert_fields(tf, jf, 1, ATOL)


@pytest.mark.parametrize("extra,exc,match", [
    (["--mesh", "2,2", "--overlap"], ValueError,
     "multi-phase; overlap split unsupported"),
    (["--compute", "pallas"], ValueError, "no pallas kernel for 'sor3d'"),
    (["--mesh", "2", "--compute", "pallas"], ValueError,
     "no pallas kernel for 'sor3d'"),
    (["--tol", "1e-3", "--checkpoint-every", "8"], ValueError,
     "excludes"),
    (["--tol", "1e-3", "--fuse", "4", "--tol-check-every", "10"],
     ValueError, "multiple of 4"),
    (["--tol", "1e-3", "--fuse", "4", "--iters", "10"], ValueError,
     "multiple of 4"),
])
def test_cli_refusals_match_jax(monkeypatch, extra, exc, match):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "sor3d", "--grid", "16,16,128", "--iters", "8",
            *extra]
    with pytest.raises(exc, match=match) as je:
        jcli.main(args)
    with pytest.raises(exc, match=match) as te:
        tcli.main(args + ["--device", "cpu"])
    assert str(te.value) == str(je.value)
