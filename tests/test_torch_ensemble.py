"""The ensemble axis (ROADMAP A7): the port's batched steps, mesh, init,
exchange and budget against the JAX package, on the CPU.

The JAX package batches with ``vmap`` (``driver.make_ensemble_step``, the
``ensemble=N`` steppers and ``make_stream_fused_step(batch=N)``, its Pallas
kernels in interpret mode, as tests/test_ensemble_engine.py runs them); the
port carries the member axis explicitly, the leading axis of every field
and every shard block, each kernel taking all the members a block holds
in one launch (on the CPU each wrapper takes its plain version, which
takes the member axis too; tests/test_torch_cuda.py holds the kernels'
batched launches to them on the card).  The same seeded numpy members go
through both packages.  Tolerances are the port's usual ones: Life exact;
the plain float32 step ``32 eps max(|ref|, 1)`` a step
(tests/test_torch_cli.py: XLA's and PyTorch's float32 steps differ in the
last place); the float32 kernel paths ``atol = 1e-4`` (tests/test_fused.py:
70); bfloat16 ``32 eps_bf16 max(|ref|, 1)``; the guard frame exact.  Inside
the port every batched step is held bit for bit to the unbatched step's run
of each member.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fullgrid as jfullgrid
from mpi_cuda_process_tpu.ops.pallas import fused as jfused
from mpi_cuda_process_tpu.ops.pallas import make_pallas_compute as jpallas
from mpi_cuda_process_tpu.ops.pallas import streamfused as jstream
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import budget as jbudget
from mpi_cuda_process_tpu.utils import init as jinit

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import gather_to_numpy
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import init as tinit

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS32 = float(np.finfo(np.float32).eps)
EPS_BF16 = 2.0 ** -7


def _mesh(shape, ensemble=1):
    return tmesh.make_mesh(shape, [CPU] * 8, ensemble=ensemble)


def _members(st, grid, n, seed, bf16=False):
    """n seeded members of every field: float32 numpy arrays (the bfloat16
    cases round them to bfloat16 in both packages)."""
    rng = np.random.default_rng(seed)
    out = tuple(rng.random((n,) + tuple(grid), dtype=np.float32)
                for _ in range(st.num_fields))
    if bf16:
        out = tuple(np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in out)
    return out


def _port_fields(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                 for a in arrays)


def _np(fields):
    """Whole float32 host arrays of port or JAX fields."""
    if tstepper.is_sharded(fields):
        fields = tstepper.gather_fields(fields, device="cpu")
    return [np.asarray(f.float() if isinstance(f, torch.Tensor)
                       else jnp.asarray(f, jnp.float32)) for f in fields]


def _close(got, ref, atol=0.0, bf16=False):
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        tol = 32 * EPS_BF16 * max(float(np.abs(r).max()), 1.0) if bf16 \
            else atol
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)


def _same(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


def _member_runs(single, fields, calls, shard=None):
    """Each member through the unbatched step ``calls`` times (sharded
    over ``shard`` when given), stacked back on the member axis."""
    outs = []
    for i in range(fields[0].shape[0]):
        f = tuple(x[i].contiguous() for x in fields)
        if shard is not None:
            f = tstepper.shard_fields(f, shard, len(f[0].shape))
        for _ in range(calls):
            f = single(f)
        if shard is not None:
            f = tstepper.gather_fields(f, device="cpu")
        outs.append(f)
    return tuple(torch.stack([o[j] for o in outs])
                 for j in range(len(outs[0])))


def _batched_run(step, fields, calls, mesh=None):
    if mesh is not None:
        fields = tstepper.shard_fields(fields, mesh, fields[0].dim() - 1,
                                       ensemble=True)
    for _ in range(calls):
        fields = step(fields)
    if mesh is not None:
        fields = tstepper.gather_fields(fields, device="cpu")
    return fields


def _jax_batched(step, arrays, calls, mesh=None, ndim=3):
    f = tuple(jnp.asarray(a) for a in arrays)
    if mesh is not None:
        f = jstepper.shard_fields(f, mesh, ndim, ensemble=True)
    step = jax.jit(step)
    for _ in range(calls):
        f = step(f)
    return _np(f)


# ---- the mesh's ensemble axis --------------------------------------------


def test_ensemble_mesh_axis_layout():
    """``make_mesh(shape, ensemble=M)``: a leading axis of M groups before
    the spatial ones (the TPU package's ENSEMBLE_AXIS), neighbours within
    a group."""
    m = _mesh((2, 2, 1), ensemble=2)
    jm = jmesh.make_mesh((2, 2, 1), ensemble=2)
    assert m.full_shape == (2, 2, 2, 1) == tuple(jm.devices.shape)
    assert jmesh.ENSEMBLE_AXIS in jm.shape and m.ensemble == 2
    assert m.size == 8 and m.shape == (2, 2, 1) and m.counts(3) == (2, 2, 1)
    coords = m.local_coords()
    assert coords[:4] == [(0, 0, 0, 0), (0, 0, 1, 0), (0, 1, 0, 0),
                          (0, 1, 1, 0)]
    assert [m.group(c) for c in coords] == [0] * 4 + [1] * 4
    assert m.spatial(coords[5]) == (0, 1, 0)
    for c in coords:
        for axis in (0, 1):
            for shift in (1, -1):
                n = thalo._shifted(m, c, axis, shift)
                assert m.group(n) == m.group(c)
    plain = _mesh((2, 1, 1))
    assert plain.full_shape == (2, 1, 1) and plain.group_axes == 0


def test_ensemble_members_local_validation():
    """The TPU package's checks and messages."""
    for members, jm, tm in ((jstepper.ensemble_members_local,
                             jmesh.make_mesh((2, 1, 1), ensemble=2),
                             _mesh((2, 1, 1), ensemble=2)),):
        assert members(jm, 4) == tstepper.ensemble_members_local(tm, 4) == 2
        for n, match in ((3, "not divisible"), (0, "unbatched")):
            with pytest.raises(ValueError, match=match) as je:
                members(jm, n)
            with pytest.raises(ValueError, match=match) as te:
                tstepper.ensemble_members_local(tm, n)
            assert str(je.value) == str(te.value)
    assert tstepper.ensemble_members_local(_mesh((2, 1, 1)), 0) == 0


def test_mesh_needs_enough_devices_for_ensemble_axis():
    with pytest.raises(ValueError, match="ensemble"):
        tmesh.make_mesh((2, 2, 1), [CPU] * 8, ensemble=4)  # 16 > 8
    with pytest.raises(ValueError, match="ensemble"):
        jmesh.make_mesh((2, 2, 1), ensemble=4)


def test_unbatched_stepper_refuses_an_ensemble_mesh():
    st = port.make_stencil("heat3d")
    with pytest.raises(ValueError, match="unbatched"):
        tstepper.make_sharded_step(st, _mesh((2, 1, 1), ensemble=2),
                                   (32, 16, 128))
    with pytest.raises(ValueError, match="unbatched"):
        tstepper.make_sharded_fused_step(st, _mesh((2, 1, 1), ensemble=2),
                                         (32, 16, 128), 4)


# ---- the op layer: every update indexes the trailing ndim axes -------------


OPS = ["heat2d", "wave2d", "life", "advect2d", "grayscott2d", "sor2d",
       "heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
       "grayscott3d", "sor3d"]


@pytest.mark.parametrize("name", OPS)
def test_plain_step_takes_the_member_axis(name):
    """``driver.make_step`` on (N, *grid) fields: each member equals its
    own unbatched step bit for bit, and the JAX package's vmapped step to
    the plain step's tolerance (Life exactly); SOR's colours follow the
    spatial coordinates only."""
    st = port.make_stencil(name)
    grid = (12, 16) if st.ndim == 2 else (8, 10, 12)
    arrays = _members(st, grid, 3, 11)
    if name == "life":
        arrays = tuple((a < 0.3).astype(np.int32) for a in arrays)
        fields = tuple(torch.from_numpy(a) for a in arrays)
    else:
        fields = _port_fields(arrays)
    step = tdriver.make_ensemble_step(tdriver.make_step(st, grid))
    got = _batched_run(step, fields, 2)
    _same(got, _member_runs(tdriver.make_step(st, grid), fields, 2))
    jstep = jdriver.make_ensemble_step(jdriver.make_step(jmake_stencil(name),
                                                         grid))
    ref = _jax_batched(jstep, arrays, 2)
    if name == "life":
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)
    else:
        _close(_np(got), ref, atol=2 * 32 * EPS32 * max(
            max(float(np.abs(r).max()), 1.0) for r in ref))


def test_unbatched_step_is_unchanged_bit_for_bit():
    """``shifted``/``interior`` slice the trailing axes: on an unbatched
    block the update is the same views as before (the member axis adds an
    Ellipsis, nothing else)."""
    from mpi_cuda_process_tpu_torch.ops.stencil import interior, shifted

    p = torch.arange(5 * 6 * 7, dtype=torch.float32).reshape(5, 6, 7)
    assert torch.equal(shifted(p, (1, -1, 0), 1), p[2:, :-2, 1:-1])
    assert torch.equal(interior(p, 1, 3), p[1:-1, 1:-1, 1:-1])
    b = torch.stack([p, p + 1])
    assert torch.equal(shifted(b, (1, -1, 0), 1), b[:, 2:, :-2, 1:-1])


def test_pad_and_frame_mask_spare_the_member_axis():
    f = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    g = tdriver.pad(f, 1, False, 7.0, ndim=2)
    assert g.shape == (2, 5, 6) and float(g[1, 0, 0]) == 7.0
    w = tdriver.pad(f, 1, True, ndim=2)
    assert torch.equal(w[:, 1:-1, 0], f[:, :, -1])
    assert torch.equal(tdriver.pad(f[0], 1, True), w[0])


# ---- the batched sharded steps ---------------------------------------------


@pytest.mark.parametrize("mesh_shape,ens_mesh,n", [
    ((2, 1, 1), 1, 3), ((2, 2, 1), 2, 4)])
def test_batched_plain_sharded_step(mesh_shape, ens_mesh, n):
    """The plain sharded step on (2,1,1) and on an ensemble axis of 2 x
    (2,2,1): each member equal to its unsharded run bit for bit, and to
    the JAX package's batched step."""
    st = port.make_stencil("heat3d")
    grid = (16, 16, 32)
    mesh = _mesh(mesh_shape, ens_mesh)
    arrays = _members(st, grid, n, 4)
    fields = _port_fields(arrays)
    step = tstepper.make_sharded_step(st, mesh, grid, ensemble=n)
    got = _batched_run(step, fields, 2, mesh)
    _same(got, _member_runs(tdriver.make_step(st, grid), fields, 2))
    jm = jmesh.make_mesh(mesh_shape, ensemble=ens_mesh)
    ref = _jax_batched(jstepper.make_sharded_step(
        jmake_stencil("heat3d"), jm, grid, ensemble=n), arrays, 2, jm)
    _close(_np(got), ref, atol=2 * 32 * EPS32)


FUSED_KINDS = [
    # (id, stencil, grid, mesh, kind, dtype)
    ("padded_z", "heat3d", (32, 16, 128), (2, 1, 1), None, None),
    ("padded_yz", "heat3d", (32, 32, 128), (2, 2, 1), None, None),
    ("padfree_z", "heat3d", (32, 16, 128), (2, 1, 1), "padfree", None),
    ("padfree_yz", "heat3d", (32, 32, 128), (2, 2, 1), "padfree", None),
    ("padfree_z_wave", "wave3d", (32, 16, 128), (2, 1, 1), "padfree", None),
    ("stream_z", "heat3d", (96, 32, 128), (2, 1, 1), "stream", None),
    ("stream_yz", "heat3d", (48, 64, 128), (2, 2, 1), "stream", None),
    ("padfree_z_bf16", "heat3d", (64, 32, 128), (2, 1, 1), "padfree",
     "bfloat16"),
]


@pytest.mark.parametrize("label,name,grid,mesh_shape,kind,dtype",
                         FUSED_KINDS, ids=[c[0] for c in FUSED_KINDS])
def test_batched_fused_kinds(label, name, grid, mesh_shape, kind, dtype):
    """Each sharded fused kind with ``ensemble=2`` (the cases of
    tests/test_ensemble_engine.py:152-181): each member bit-equal to the
    port's unbatched step, and close to the JAX package's batched step
    (its kernels in interpret mode)."""
    bf16 = dtype == "bfloat16"
    st = port.make_stencil(name, **({"dtype": dtype} if dtype else {}))
    k, n, calls = (8 if bf16 else 4), 2, 2
    mesh = _mesh(mesh_shape)
    batched = tstepper.make_sharded_fused_step(st, mesh, grid, k, kind=kind,
                                               ensemble=n)
    single = tstepper.make_sharded_fused_step(st, mesh, grid, k, kind=kind)
    assert getattr(batched, "_padfree_kind", None) == \
        getattr(single, "_padfree_kind", None)
    arrays = _members(st, grid, n, 7, bf16)
    fields = _port_fields(arrays, st.dtype)
    got = _batched_run(batched, fields, calls, mesh)
    _same(got, _member_runs(single, fields, calls, mesh))
    jst = jmake_stencil(name, **({"dtype": jnp.bfloat16} if bf16 else {}))
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(
        jst, jm, grid, k, interpret=True, kind=kind, ensemble=n)
    ref = _jax_batched(jstep, arrays if not bf16 else tuple(
        jnp.asarray(a, jnp.bfloat16) for a in arrays), calls, jm)
    _close(_np(got), ref, atol=1e-4, bf16=bf16)


@pytest.mark.parametrize("overlap,pipeline", [
    (True, False), (True, True), (False, True)])
def test_batched_overlap_and_pipeline(overlap, pipeline):
    """``--overlap`` and ``--pipeline`` on the pad-free kind, batched: the
    split and the slab carry hold every member's slabs."""
    st = port.make_stencil("heat3d")
    grid, n, calls = (48, 16, 128), 2, 3
    mesh = _mesh((2, 1, 1))

    def mk(ens):
        return tstepper.make_sharded_fused_step(
            st, mesh, grid, 4, kind="padfree", overlap=overlap,
            pipeline=pipeline, ensemble=ens)

    batched, single = mk(n), mk(0)
    assert batched._overlap_active == overlap
    assert getattr(batched, "_pipeline_active", False) == pipeline
    arrays = _members(st, grid, n, 5)
    fields = tstepper.shard_fields(_port_fields(arrays), mesh, 3,
                                   ensemble=True)
    got = tstepper.gather_fields(tdriver.make_runner(batched, calls)(fields),
                                 device="cpu")
    ref = []
    for i in range(n):
        f = tstepper.shard_fields(tuple(torch.from_numpy(a[i].copy())
                                        for a in arrays), mesh, 3)
        ref.append(tstepper.gather_fields(
            tdriver.make_runner(single, calls)(f), device="cpu"))
    _same(got, tuple(torch.stack([r[j] for r in ref])
                     for j in range(st.num_fields)))
    jm = jmesh.make_mesh((2, 1, 1))
    jstep = jstepper.make_sharded_fused_step(
        jmake_stencil("heat3d"), jm, grid, 4, interpret=True, padfree=True,
        overlap=overlap, pipeline=pipeline, ensemble=n)
    jf = jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays), jm, 3,
                               ensemble=True)
    _close(_np(got), _np(jdriver.make_runner(jstep, calls)(jf)), atol=1e-4)


@pytest.mark.parametrize("mesh_shape,grid", [
    ((2, 1, 1), (96, 32, 128)), ((2, 2, 1), (48, 64, 128))])
def test_batched_rdma_stream(mesh_shape, grid):
    """The stream kind with ``--exchange rdma`` batched: every member's
    slab rides one ring exchange, as its ``(N h, Y, X)`` view."""
    st = port.make_stencil("heat3d")
    n = 2
    mesh = _mesh(mesh_shape)
    batched = tstepper.make_sharded_fused_step(
        st, mesh, grid, 4, kind="stream", exchange="rdma", ensemble=n)
    single = tstepper.make_sharded_fused_step(
        st, mesh, grid, 4, kind="stream", exchange="rdma")
    assert batched._exchange == "rdma"
    arrays = _members(st, grid, n, 2)
    fields = _port_fields(arrays)
    got = _batched_run(batched, fields, 2, mesh)
    _same(got, _member_runs(single, fields, 2, mesh))
    shapes = {tuple(s["shape"]) for s in batched._rdma_transport.sites}
    assert all(sh[0] % n == 0 for sh in shapes)
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(
        jmake_stencil("heat3d"), jm, grid, 4, interpret=True, kind="stream",
        exchange="rdma", ensemble=n)
    _close(_np(got), _jax_batched(jstep, arrays, 2, jm), atol=1e-4)


def test_batched_fullgrid_sharded_step():
    """K8's row-split step, batched, ± ``--overlap``."""
    st = port.make_stencil("heat2d")
    grid, n, k = (96, 128), 2, 8
    mesh = _mesh((4,))
    arrays = _members(st, grid, n, 9)
    fields = _port_fields(arrays)
    ref = _member_runs(tdriver.make_step(st, grid), fields, k)
    jm = jmesh.make_mesh((4,))
    jstep = jstepper.make_sharded_fullgrid_step(
        jmake_stencil("heat2d"), jm, grid, k, interpret=True, ensemble=n)
    jref = _jax_batched(jstep, arrays, 1, jm, ndim=2)
    for overlap in (False, True):
        step = tstepper.make_sharded_fullgrid_step(st, mesh, grid, k,
                                                   overlap=overlap,
                                                   ensemble=n)
        assert step._overlap_active == overlap
        got = _batched_run(step, fields, 1, mesh)
        _close(_np(got), _np(ref), atol=1e-5)
        _close(_np(got), jref, atol=1e-4)


# ---- the exchange: one shift a site, whatever N ------------------------


@pytest.mark.parametrize("mesh_shape,grid,exchange", [
    ((2, 1, 1), (32, 16, 128), "ppermute"),
    ((2, 2, 1), (32, 32, 128), "ppermute"),
    ((2, 1, 1), (96, 32, 128), "rdma")])
def test_exchange_shifts_independent_of_members(mesh_shape, grid, exchange):
    """The port's form of the TPU package's ``check_ensemble_structure``:
    the shifts a step posts (the transports' ``stats``) and the ring
    exchanges it launches are the same for N = 2 and N = 4."""
    st = port.make_stencil("heat3d")
    mesh = _mesh(mesh_shape)
    shifts = {}
    for n in (2, 4):
        kind = "stream" if exchange == "rdma" else None
        step = tstepper.make_sharded_fused_step(
            st, mesh, grid, 4, kind=kind, exchange=exchange, ensemble=n)
        fields = tstepper.shard_fields(
            _port_fields(_members(st, grid, n, 1)), mesh, 3, ensemble=True)
        transport = getattr(step, "_rdma_transport", None) or \
            thalo.default_transport(mesh)
        before = transport.stats["shifts"]
        step(fields)
        shifts[n] = transport.stats["shifts"] - before
    assert shifts[2] == shifts[4] > 0


# ---- the unbatched kernels with a member axis ------------------------------


def test_fused_k3_batched_matches_jax_vmap():
    st = port.make_stencil("heat3d")
    grid, n = (16, 16, 128), 2
    arrays = _members(st, grid, n, 3)
    fields = _port_fields(arrays)
    step = tdriver.make_ensemble_step(tfused.make_fused_step(st, grid, 4))
    got = _batched_run(step, fields, 1)
    _same(got, _member_runs(tfused.make_fused_step(st, grid, 4), fields, 1))
    jstep = jdriver.make_ensemble_step(jfused.make_fused_step(
        jmake_stencil("heat3d"), grid, 4, interpret=True))
    _close(_np(got), _jax_batched(jstep, arrays, 1), atol=1e-4)


@pytest.mark.parametrize("name", ["heat2d", "life"])
def test_fullgrid_k8_batched_matches_jax_vmap(name):
    st = port.make_stencil(name)
    grid, n, k = (32, 128), 3, 8
    arrays = _members(st, grid, n, 6)
    if name == "life":
        arrays = tuple((a < 0.3).astype(np.int32) for a in arrays)
        fields = tuple(torch.from_numpy(a) for a in arrays)
    else:
        fields = _port_fields(arrays)
    got = _batched_run(tfullgrid.make_fullgrid_step(st, grid, k), fields, 1)
    _same(got, _member_runs(tfullgrid.make_fullgrid_step(st, grid, k),
                            fields, 1))
    jstep = jdriver.make_ensemble_step(jfullgrid.make_fullgrid_step(
        jmake_stencil(name), grid, k, interpret=True))
    ref = _jax_batched(jstep, arrays, 1, ndim=2)
    if name == "life":
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
    else:
        _close(_np(got), ref, atol=1e-4)


def test_stream_k10_batch_matches_jax():
    """``make_stream_fused_step(batch=N)``: all members in one step, and the wrong member count refused with the TPU package's
    message."""
    st = port.make_stencil("heat3d")
    grid, n = (96, 32, 128), 3
    step = tstream.make_stream_fused_step(st, grid, 4, batch=n)
    arrays = _members(st, grid, n, 3)
    fields = _port_fields(arrays)
    got = step(fields)
    _same(got, _member_runs(tstream.make_stream_fused_step(st, grid, 4),
                            fields, 1))
    jstep = jstream.make_stream_fused_step(jmake_stencil("heat3d"), grid, 4,
                                           interpret=True, batch=n)
    _close(_np(got), _np(jstep(tuple(jnp.asarray(a) for a in arrays))),
           atol=1e-4)
    bad = _port_fields(_members(st, grid, 2, 3))
    with pytest.raises(ValueError, match="batched streaming step") as te:
        step(bad)
    with pytest.raises(ValueError, match="batched streaming step") as je:
        jstep(tuple(jnp.asarray(a) for a in _members(st, grid, 2, 3)))
    assert str(te.value).split("got")[0] == str(je.value).split("got")[0]


@pytest.mark.parametrize("name,periodic", [
    ("heat3d", False), ("heat3d", True), ("wave3d", True), ("heat2d", False),
    ("life", False)])
def test_compute_fn_k4_k5_k7_batched_match_jax(name, periodic):
    """K4/K5/K7 (``--compute pallas`` under ``--periodic`` or in 2D) on
    a batch: the port's step over the member axis against the JAX
    package's vmapped step with its Pallas compute_fn in interpret mode."""
    st = port.make_stencil(name)
    grid = (16, 32) if st.ndim == 2 else (8, 8, 16)
    n = 2
    arrays = _members(st, grid, n, 8)
    if name == "life":
        arrays = tuple((a < 0.3).astype(np.int32) for a in arrays)
        fields = tuple(torch.from_numpy(a) for a in arrays)
    else:
        fields = _port_fields(arrays)
    comp = tkernels.make_pallas_compute(st)
    step = tdriver.make_ensemble_step(
        tdriver.make_step(st, grid, periodic=periodic, compute_fn=comp))
    got = _batched_run(step, fields, 2)
    _same(got, _member_runs(tdriver.make_step(
        st, grid, periodic=periodic, compute_fn=comp), fields, 2))
    jst = jmake_stencil(name)
    jstep = jdriver.make_ensemble_step(jdriver.make_step(
        jst, grid, periodic=periodic,
        compute_fn=jpallas(jst, interpret=True)))
    ref = _jax_batched(jstep, arrays, 2, ndim=st.ndim)
    if name == "life":
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
    else:
        _close(_np(got), ref, atol=1e-5)


# ---- the init: members from seed + i, the perturbation ---------------------


@pytest.mark.parametrize("name,kind", [
    ("life", "auto"), ("heat3d", "zero"), ("wave3d", "pulse"),
    ("grayscott3d", "auto")])
def test_ensemble_init_stacks_seed_plus_i(name, kind):
    st = port.make_stencil(name)
    grid = (16, 16) if st.ndim == 2 else (8, 8, 16)
    ens = tinit.init_state(st, grid, seed=3, kind=kind, device="cpu",
                           ensemble=3)
    for i in range(3):
        solo = tinit.init_state(st, grid, seed=3 + i, kind=kind,
                                device="cpu")
        for e, s in zip(ens, solo):
            assert torch.equal(e[i], s)
    jens = jinit.init_state(jmake_stencil(name), grid, 3, 0.15, kind,
                            ensemble=3)
    for e, j in zip(ens, jens):
        np.testing.assert_allclose(e.float().numpy(),
                                   np.asarray(j, np.float32),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,kind,periodic", [
    ("wave3d", "pulse", False), ("heat3d", "pulse", True),
    ("grayscott3d", "auto", False), ("life", "auto", False)])
def test_ensemble_perturb_deterministic_distinct_frame_exact(name, kind,
                                                             periodic):
    """``--ensemble-perturb``: the same members twice, each differing from
    its unperturbed self in the interior (Life's int fields untouched),
    the frame exact; each scale ``1 + eps u_i`` is the JAX package's (the
    same threefry bits), so the members agree with its init."""
    st = port.make_stencil(name)
    grid = (16, 16) if st.ndim == 2 else (16, 16, 32)
    kw = dict(seed=9, kind=kind, device="cpu", ensemble=3, periodic=periodic)
    a = tinit.init_state(st, grid, perturb=0.1, **kw)
    b = tinit.init_state(st, grid, perturb=0.1, **kw)
    plain = tinit.init_state(st, grid, **kw)
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)
    if name == "life":
        assert torch.equal(a[0], plain[0])
    else:
        assert not torch.equal(a[0], plain[0])
        assert not torch.equal(a[0][0] / plain[0][0].clamp(min=1e-3),
                               a[0][1] / plain[0][1].clamp(min=1e-3))
    if not periodic:
        h = st.halo
        np.testing.assert_array_equal(a[0][:, :h].numpy(),
                                      plain[0][:, :h].numpy())
        np.testing.assert_array_equal(a[0][..., -h:].numpy(),
                                      plain[0][..., -h:].numpy())
    jst = jmake_stencil(name)
    ja = jinit.init_state(jst, grid, 9, 0.15, kind, periodic=periodic,
                          ensemble=3, perturb=0.1)
    for t, j in zip(a, ja):
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=1e-6,
                                   atol=1e-7)


def test_member_uniform_is_the_jax_draw():
    for seed in (0, 9, -4, 2 ** 31 - 1):
        for i in (0, 1, 5, 1000):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            u = jax.random.uniform(key, (), jnp.float32, -1.0, 1.0)
            assert float(tinit.member_uniform(seed, i)) == float(u)


@pytest.mark.parametrize("mesh_shape,ens_mesh", [((2, 2), 1), ((2,), 2),
                                                 ((), 2)])
def test_sharded_ensemble_init_gathers_to_init_state(mesh_shape, ens_mesh):
    """Each block holds its group's members, from global coordinates; no
    process builds the whole batch."""
    st = port.make_stencil("wave3d")
    grid = (8, 12, 16)
    mesh = _mesh(mesh_shape, ens_mesh)
    sharded = tinit.init_state_sharded(st, grid, mesh, seed=2, kind="pulse",
                                       ensemble=4, perturb=0.05)
    n_local = 4 // ens_mesh
    assert all(b.shape[0] == n_local for f in sharded for b in f)
    whole = tinit.init_state(st, grid, seed=2, kind="pulse", device="cpu",
                             ensemble=4, perturb=0.05)
    for g, w in zip(tstepper.gather_fields(sharded), whole):
        assert torch.equal(g, w)
    assert [a.shape for a in gather_to_numpy(sharded)] == [(4,) + grid] * 2


# ---- the budget ------------------------------------------------------------


def test_budget_prices_members_a_shard():
    """``estimate_run_bytes(ensemble=, ensemble_mesh=)``: the per-shard
    terms scale by the members a shard holds, N / M, as the TPU
    package's; the member count must divide over the groups."""
    st = port.make_stencil("heat3d")
    one, _ = tbudget.estimate_run_bytes(st, (64,) * 3)
    eight, parts = tbudget.estimate_run_bytes(st, (64,) * 3, ensemble=8)
    split, _ = tbudget.estimate_run_bytes(st, (64,) * 3, ensemble=8,
                                          ensemble_mesh=4)
    assert any("members batched" in label for label, _ in parts)
    assert eight > 7.5 * one and split > 1.9 * one and eight > 3.9 * split
    with pytest.raises(ValueError, match="divisible") as te:
        tbudget.estimate_run_bytes(st, (64,) * 3, ensemble=3,
                                   ensemble_mesh=2)
    with pytest.raises(ValueError, match="divisible") as je:
        jbudget.estimate_run_bytes(jmake_stencil("heat3d"), (64,) * 3,
                                   ensemble=3, ensemble_mesh=2)
    assert str(te.value) == str(je.value)
    t, _ = tbudget.estimate_run_bytes(st, (256,) * 3, fuse=4,
                                      fuse_kind="stream", ensemble=2)
    t1, _ = tbudget.estimate_run_bytes(st, (256,) * 3, fuse=4,
                                       fuse_kind="stream")
    assert t > 1.9 * t1
    # the state term is the TPU package's, member for member
    jt, jparts = jbudget.estimate_run_bytes(jmake_stencil("heat3d"),
                                            (64,) * 3, ensemble=8,
                                            ensemble_mesh=4)
    state = st.num_fields * 64 ** 3 * st.dtype.itemsize
    assert parts[0][1] == 8 * state and jparts[0][1] == 2 * state
