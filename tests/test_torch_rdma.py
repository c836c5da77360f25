"""The ring exchange (TPU table row 19, ``--exchange rdma``) and K10's
advection and Gray-Scott kinds (ROADMAP B5), against the JAX package.

The JAX package's rdma steps and streaming kernels run as its own tests run
them (tests/test_rdma_exchange.py, tests/test_streamfused.py): with
``interpret=True`` (its rdma path is then the loopback ring plus an
``all_gather`` shift), its sharded steps on the 8 virtual CPU devices of
tests/conftest.py.  The port's wrappers take their plain versions for CPU
tensors: ``plain_ring_exchange`` walks the ring protocol (every chunk
landed in place in its destination's slab, then counted on its ready
counter) and asserts its drained invariant
(tests/test_torch_cuda.py holds the kernels to them on the card).  Inputs
are numpy arrays from a seed, handed to both packages.  Tolerance:
``atol = 1e-4, rtol = 0`` against JAX, frame cells exact (the kernels
reorder taps); the port's rdma step equals its in-process (ppermute) step
bit for bit, with and without ``overlap``.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import remote as jremote
from mpi_cuda_process_tpu.ops.pallas import streamfused as jstream
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.interop import (fields_from_numpy,
                                                gather_to_numpy,
                                                shard_from_numpy)
from mpi_cuda_process_tpu_torch.ops.cuda import remote as tremote
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper

from test_torch_cli import _assert_match, _run_both

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID = (48, 32, 128)  # tests/test_rdma_exchange.py's grid


def _mesh(shape, devices=None):
    return tmesh.make_mesh(shape, devices or [CPU] * 8)


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


def _numpy(fields):
    return tuple(f.numpy() for f in fields)


# ---- chunk geometry ----------------------------------------------------------

# tests/test_rdma_exchange.py::test_pick_chunks_alignment_rules, and more
CHUNK_CASES = [((4, 32, 128), 4), ((24, 4, 128), 4), ((4, 64, 128), 2),
               ((4, 32, 128), 2), ((3, 5, 128), 4), ((4, 512, 1024), 4),
               ((512, 4, 1024), 4), ((4, 4, 1024), 4), ((16, 48, 128), 4)]


@pytest.mark.parametrize("prefer_nc", [0, 3, 8])
@pytest.mark.parametrize("nslots", [2, 3, 4])
@pytest.mark.parametrize("shape,itemsize", CHUNK_CASES)
def test_pick_chunks_and_stats_equal_jax(shape, itemsize, nslots, prefer_nc):
    """The port's chunk geometry is the TPU package's: pick_chunks,
    ring_exchange_stats and build_ring_exchange_call's meta, for every
    ring depth and chunk preference."""
    got = tremote.pick_chunks(shape, itemsize, nslots, prefer_nc)
    assert got == jremote.pick_chunks(shape, itemsize, nslots, prefer_nc)
    tdt = torch.float32 if itemsize == 4 else torch.bfloat16
    jdt = jnp.float32 if itemsize == 4 else jnp.bfloat16
    assert tremote.ring_exchange_stats(shape, tdt, nslots, prefer_nc) == \
        jremote.ring_exchange_stats(shape, jdt, nslots, prefer_nc)
    assert tremote._nc_ladder(nslots) == jremote._nc_ladder(nslots)
    _, meta = tremote.build_ring_exchange_call(shape, tdt, nslots=nslots,
                                               prefer_nc=prefer_nc)
    _, jmeta = jremote.build_ring_exchange_call(
        shape, jdt, remote=False, interpret=True, nslots=nslots,
        prefer_nc=prefer_nc)
    assert meta == jmeta


def test_pick_chunks_pins():
    """The five pins of tests/test_rdma_exchange.py, and the defaults."""
    assert tremote._NSLOTS == jremote._NSLOTS == 2
    assert tremote.pick_chunks((4, 32, 128), 4) == (1, 4)
    assert tremote.pick_chunks((24, 4, 128), 4) == (0, 4)
    assert tremote.pick_chunks((4, 64, 128), 2) == (1, 4)
    assert tremote.pick_chunks((4, 32, 128), 2) == (0, 4)
    assert tremote.pick_chunks((3, 5, 128), 4) == (0, 1)


# ---- the plain ring against the in-process shift -----------------------------

def _ring(mesh, axis):
    n = mesh.counts(3)[axis]
    coords = list(mesh.coords())

    def shifted(c, s):
        c = list(c) + [0] * (3 - len(c))
        c[axis] = (c[axis] + s) % n
        return mesh.index(c[:len(mesh.shape)])

    return [shifted(c, 1) for c in coords], [shifted(c, -1) for c in coords]


RING_MESHES = [((4,), 0), ((1, 4), 1), ((2, 2), 0), ((2, 2), 1), ((2,), 0)]


@pytest.mark.parametrize("nslots,prefer_nc", [(2, 0), (3, 0), (4, 0), (2, 8)])
@pytest.mark.parametrize("shape", [(4, 64, 128), (24, 4, 128), (3, 5, 130)])
@pytest.mark.parametrize("mesh_shape,axis", RING_MESHES)
def test_plain_ring_equals_in_process_shift(mesh_shape, axis, shape, nslots,
                                            prefer_nc):
    """plain_ring_exchange == InProcessTransport.shift_pair on the full
    (periodic) ring, bit for bit, on z, y and (2, 2) meshes, for every
    chunk ladder the ring depth gives; every chunk's ready counter ends at
    one landing (the plain version's one writer)."""
    mesh = _mesh(mesh_shape)
    rng = np.random.default_rng(11)
    hi = [torch.from_numpy(rng.random(shape, dtype=np.float32))
          for _ in range(mesh.size)]
    lo = [torch.from_numpy(rng.random(shape, dtype=np.float32))
          for _ in range(mesh.size)]
    nxt, prv = _ring(mesh, axis)
    call, meta = tremote.build_ring_exchange_call(
        shape, torch.float32, nslots=nslots, prefer_nc=prefer_nc)
    tremote.launches.clear()
    for _ in range(3):  # the counters are reused call to call
        fl, fr = call(hi, lo, nxt, prv)
        want = tremote.drained_counts(meta, 1)
        assert want == [1] * meta["nchunks"]
        assert call.state.counters.tolist() == [[want, want]] * mesh.size
    assert not tremote.launches  # CPU tensors never launch
    rl, rr = thalo.InProcessTransport().shift_pair(hi, lo, mesh, axis, True)
    for a, b in zip(fl + fr, rl + rr):
        assert torch.equal(a, b)


def test_drained_invariant_is_checked():
    """A chunk counted twice, or never, fails the check by name; a launch
    of G blocks a chunk drains at G."""
    call, meta = tremote.build_ring_exchange_call((4, 16, 32),
                                                  torch.float32)
    slabs = [torch.rand(4, 16, 32) for _ in range(2)]
    call(slabs, slabs, [1, 0], [1, 0])
    call.state.check_drained(meta)
    call.state.counters[1, 1, 0] += 1
    with pytest.raises(AssertionError, match="direction 1 ready counters"):
        call.state.check_drained(meta)
    call.state.counters[1, 1, 0] -= 2
    with pytest.raises(AssertionError, match="ready counters"):
        call.state.check_drained(meta)
    call.state.counters.fill_(3)
    call.state.blocks = 3
    call.state.check_drained(meta)
    assert tremote.drained_counts(meta, 3) == [3] * meta["nchunks"]


@pytest.mark.parametrize("shape,chunks", [((4, 64, 128), (1, 4)),
                                          ((24, 4, 128), (0, 4)),
                                          ((3, 5, 130), (0, 1)),
                                          ((8, 32, 64), (1, 2))])
def test_plain_ring_lands_each_chunk_in_place(shape, chunks):
    """Every chunk lands at its own offset of the destination's slab: with
    the sources cut into chunks of distinct values, each received chunk
    holds exactly its sender's chunk, and a ring of two shards (each the
    other's next and previous) swaps the slabs whole."""
    call, meta = tremote.build_ring_exchange_call(shape, torch.float32,
                                                  chunks=chunks)
    axis, nc = chunks
    assert (meta["chunk_axis"], meta["nchunks"]) == chunks
    n = int(np.prod(shape))
    hi = [torch.arange(n, dtype=torch.float32).reshape(shape) + 1e6 * s
          for s in range(2)]
    lo = [-h for h in hi]
    fl, fr = call(hi, lo, [1, 0], [1, 0])
    csize = shape[axis] // nc
    for s in range(2):
        for c in range(nc):
            got = fl[s].narrow(axis, c * csize, csize)
            assert torch.equal(got, hi[1 - s].narrow(axis, c * csize, csize))
            got = fr[s].narrow(axis, c * csize, csize)
            assert torch.equal(got, lo[1 - s].narrow(axis, c * csize, csize))
    assert call.state.counters.tolist() == [[[1] * nc] * 2] * 2


def test_ring_state_has_no_receive_ring():
    """The in-place protocol keeps no receive ring and no credits: a site's
    state is one ready counter per (shard, direction, chunk)."""
    call, meta = tremote.build_ring_exchange_call((4, 96, 128),
                                                  torch.float32, nslots=3)
    slabs = [torch.rand(4, 96, 128) for _ in range(4)]
    call(slabs, slabs, [1, 2, 3, 0], [3, 0, 1, 2])
    assert tuple(call.state.counters.shape) == (4, 2, meta["nchunks"])
    assert not hasattr(call.state, "recv")
    assert meta["nslots"] == 3 and meta["nchunks"] == 6


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mesh_shape", [(4,), (1, 4), (2, 2)])
def test_rdma_slab_exchanges_equal_in_process(mesh_shape, periodic):
    """exchange_slabs_axis / exchange_slabs_2axis through RdmaTransport ==
    the in-process exchange, bit for bit: walls get the guard constant
    after the full ring, an axis of one shard runs no ring, corners keep
    the two-pass composition (three exchange sites on a 2x2 mesh)."""
    mesh = _mesh(mesh_shape)
    rng = np.random.default_rng(5)
    blocks = [torch.from_numpy(rng.random((8, 16, 64), dtype=np.float32))
              for _ in range(mesh.size)]
    t = thalo.RdmaTransport(mesh)
    assert t.backend == "plain-ring"
    got = thalo.exchange_slabs_2axis(blocks, mesh, 4, 0.5, periodic, t)
    ref = thalo.exchange_slabs_2axis(blocks, mesh, 4, 0.5, periodic)
    for g, r in zip(got, ref):
        for gs, rs in zip(g, r):
            for a, b in zip(gs, rs):
                assert torch.equal(a, b)
    sharded = sum(c > 1 for c in mesh.counts(3)[:2])
    # z slabs, y slabs, corners: a site per sharded axis and slab shape
    assert len(t.sites) == {1: 1 if mesh.counts(3)[0] > 1 else 2,
                            2: 3}[sharded]
    assert all(s["nslots"] == 2 for s in t.sites)


def test_ring_across_devices_raises_naming_b7():
    """A ring whose shards sit on different devices is the peer-write form
    (ROADMAP B7): it raises, it never copies instead."""
    mesh = _mesh((2, 2), [CPU, CPU, torch.device("meta"),
                          torch.device("meta")])
    blocks = [torch.rand(8, 16, 64) for _ in range(4)]
    t = thalo.RdmaTransport(mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP B7"):
        thalo.exchange_slabs_axis(blocks, mesh, 0, 4, 0.0, False, t)
    # the y rings (one per z row) each lie on one device
    thalo.exchange_slabs_axis(blocks[:2] * 2, _mesh((2, 2)), 1, 4, 0.0,
                              False, thalo.RdmaTransport(_mesh((2, 2))))


# ---- the sharded rdma step against JAX's -------------------------------------

RDMA_CASES = [("heat3d", (2, 1, 1)), ("heat3d", (1, 2, 1)),
              ("heat3d", (2, 2, 1)), ("wave3d", (2, 1, 1)),
              ("wave3d", (1, 2, 1)), ("wave3d", (2, 2, 1))]


@pytest.mark.parametrize(
    "name,mesh_shape", RDMA_CASES,
    ids=[f"{n}-{'x'.join(map(str, m))}" for n, m in RDMA_CASES])
def test_rdma_step_matches_jax_and_ppermute(name, mesh_shape):
    """make_sharded_fused_step(kind="stream", exchange="rdma") == the JAX
    package's (interpret: the loopback ring) at 0, 1 and 2 calls, and ==
    the port's ppermute step bit for bit, with and without overlap."""
    k = 4
    st = port.make_stencil(name)
    arrays = _seeded(st.num_fields, GRID, 90 + len(name) + sum(mesh_shape))
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(
        jmake_stencil(name), jm, GRID, k, interpret=True, kind="stream",
        exchange="rdma")
    assert jstep._exchange == "rdma"
    jf = jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays), jm, 3)
    jrun = jax.jit(jstep)
    mesh = _mesh(mesh_shape[:2])
    tf = {(ex, ov): shard_from_numpy(arrays, mesh)
          for ex in ("ppermute", "rdma") for ov in (False, True)}
    steps = {}
    for ex, ov in tf:
        steps[ex, ov] = tstepper.make_sharded_fused_step(
            st, mesh, GRID, k, kind="stream", exchange=ex, overlap=ov)
        assert steps[ex, ov]._overlap_active is ov
        assert steps[ex, ov]._exchange == ex
    rd = steps["rdma", False]
    assert rd._rdma_backend == "plain-ring"
    assert rd._rdma_transport.backend == "plain-ring"
    for n in range(3):
        if n:
            jf = jrun(jf)
            tf = {key: steps[key](f) for key, f in tf.items()}
        got = gather_to_numpy(tf["rdma", False])
        _close(got, [np.asarray(x) for x in jf], st.halo)
        for key in (("ppermute", False), ("rdma", True),
                    ("ppermute", True)):
            for a, b in zip(got, gather_to_numpy(tf[key])):
                np.testing.assert_array_equal(a, b)
    sharded = [d for d in (0, 1) if mesh_shape[d] > 1]
    # z slab, y slab and corner sites: one per sharded axis, plus corners
    # on a 2-axis mesh
    assert len(rd._rdma_transport.sites) == (3 if len(sharded) == 2 else
                                             1 if sharded == [0] else 2)


# ---- refusals, with the JAX package's messages -------------------------------

def test_rdma_refusals_match_jax():
    """tests/test_rdma_exchange.py:271-316 through both packages: a kind
    other than stream, no kind, periodic, an unknown mode; 2D grids; the
    pipelined exchange composes with rdma in both."""
    st, jst = port.make_stencil("heat3d"), jmake_stencil("heat3d")
    mesh, jm = _mesh((2,)), jmesh.make_mesh((2, 1, 1))
    for kw, exc, match in (
            ({"kind": "padfree", "exchange": "rdma"}, ValueError,
             "streaming kernel family"),
            ({"exchange": "rdma"}, ValueError, "streaming kernel family"),
            ({"kind": "stream", "periodic": True, "exchange": "rdma"},
             ValueError, "guard-frame"),
            ({"kind": "stream", "exchange": "nvlink"}, ValueError,
             "unknown exchange")):
        with pytest.raises(exc, match=match):
            jstepper.make_sharded_fused_step(jst, jm, GRID, 4,
                                             interpret=True, **kw)
        with pytest.raises(exc, match=match):
            tstepper.make_sharded_fused_step(st, mesh, GRID, 4, **kw)
    with pytest.raises(ValueError, match="3D-only"):
        jstepper.make_sharded_temporal_step(
            jmake_stencil("heat2d"), jmesh.make_mesh((2,)), (64, 128), 8,
            interpret=True, exchange="rdma")
    with pytest.raises(ValueError, match="3D-only"):
        tstepper.make_sharded_temporal_step(
            port.make_stencil("heat2d"), _mesh((2,)), (64, 128), 8,
            exchange="rdma")
    # rdma composes with the pipeline, as in the TPU package
    # (tests/test_torch_pipeline.py holds the values)
    step = tstepper.make_sharded_fused_step(st, mesh, GRID, 4, kind="stream",
                                            exchange="rdma", pipeline=True)
    jstep = jstepper.make_sharded_fused_step(jst, jm, GRID, 4,
                                             interpret=True, kind="stream",
                                             exchange="rdma", pipeline=True)
    assert step._pipeline_active and jstep._pipeline_active
    assert step._exchange == jstep._exchange == "rdma"


def test_cli_rdma_validation_matches_jax():
    """cli.build: every unsupported --exchange rdma combination raises with
    the reason, before any build work, in both packages."""
    from mpi_cuda_process_tpu.config import RunConfig as JRunConfig

    base = dict(stencil="heat3d", grid=GRID, iters=8, exchange="rdma")
    for extra, match in (({}, "--fuse"),
                         ({"fuse": 4, "fuse_kind": "stream"}, "--mesh"),
                         ({"fuse": 4, "mesh": (2, 1, 1)}, "stream"),
                         ({"fuse": 4, "fuse_kind": "stream",
                           "mesh": (2, 1, 1), "periodic": True},
                          "guard-frame")):
        with pytest.raises(ValueError, match=match):
            jcli.build(JRunConfig(**base, **extra))
        with pytest.raises(ValueError, match=match):
            tcli.build(RunConfig(**base, **extra, device="cpu"))


def test_cli_rdma_builds_tags_and_logs_the_step(monkeypatch, caplog):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    with caplog.at_level(logging.INFO, logger="mpi_cuda_process_tpu_torch"):
        _, step, _, _ = tcli.build(RunConfig(
            stencil="heat3d", grid=GRID, iters=8, fuse=4,
            fuse_kind="stream", mesh=(2, 2), exchange="rdma", device="cpu"))
    assert step._exchange == "rdma" and step._rdma_backend == "plain-ring"
    assert "exchange: mode=rdma backend=plain-ring" in caplog.text


CLI_RDMA = [("heat3d", ["--mesh", "2,2"]), ("wave3d", ["--mesh", "2"]),
            ("heat3d", ["--mesh", "2,2", "--overlap"])]


@pytest.mark.parametrize("name,flags", CLI_RDMA,
                         ids=[f"{n}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, fl in CLI_RDMA])
def test_cli_rdma_matches_jax_cli(tmp_path, monkeypatch, name, flags):
    """--fuse 4 --fuse-kind stream --exchange rdma through both CLIs (4
    virtual shards each): final fields at atol 1e-4, frame exact."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", ",".join(map(str, GRID)),
            "--iters", "8", "--checkpoint-every", "8", "--fuse", "4",
            "--fuse-kind", "stream", "--exchange", "rdma", "--init",
            "pulse", *flags]
    jf, jstep, tf, tstep, tcfg = _run_both(tmp_path, args, "rdma")
    assert jstep == tstep == 8 and tcfg["exchange"] == "rdma"
    _assert_match(tf, jf, 1, 1e-4)


# ---- B5: K10's advect3d and grayscott3d kinds --------------------------------

def _family(label):
    """(port stencil, JAX stencil): advect3d with Courant numbers of both
    signs, or Gray-Scott."""
    if label == "advect3d-mixed":
        kw = {"cz": -0.25, "cy": 0.2, "cx": -0.3}
        return port.make_stencil("advect3d", **kw), \
            jmake_stencil("advect3d", **kw)
    return port.make_stencil(label), jmake_stencil(label)


NEW = ["advect3d", "advect3d-mixed", "grayscott3d"]


@pytest.mark.parametrize("label", NEW)
def test_stream_step_new_families_matches_jax(label):
    """Row 16: make_stream_fused_step for advection and Gray-Scott == the
    JAX package's (interpret), two passes of k = 4."""
    st, jst = _family(label)
    grid = (24, 32, 128)
    arrays = _seeded(st.num_fields, grid, 120 + len(label))
    jstep = jstream.make_stream_fused_step(jst, grid, 4, interpret=True)
    assert jstep is not None
    tstep = tstream.make_stream_fused_step(st, grid, 4)
    assert tstep is not None and tstream.fits(st, 4)
    jf = tuple(jnp.asarray(a) for a in arrays)
    tf = fields_from_numpy(arrays, device=CPU)
    for _ in range(2):
        jf, tf = jstep(jf), tstep(tf)
    _close(_numpy(tf), [np.asarray(x) for x in jf], st.halo)


@pytest.mark.parametrize("label", NEW)
def test_stream_sharded_calls_new_families_match_jax(label):
    """Rows 17 and 18 for advection and Gray-Scott: the port's z-slab and
    2-axis calls == the JAX package's on the same core, slabs and corners,
    at an interior shard."""
    st, jst = _family(label)
    k, m, nf = 4, 4, st.num_fields
    rng = np.random.default_rng(130)
    # tests/test_torch_stream.py's shard shapes: (24, 32, 128) of a z column
    # of three, (24, 16, 128) of a 3x3 (z, y) grid
    zlocal = (24, 32, 128)
    zshapes = (zlocal, (m,) + zlocal[1:], (m,) + zlocal[1:])
    zgshape = (3 * zlocal[0],) + zlocal[1:]
    arrays = [rng.random(s, dtype=np.float32) for _ in range(nf)
              for s in zshapes]
    jbuilt = jstream.build_stream_sharded_call(jst, zlocal, zgshape, k,
                                               interpret=True)
    ref = jbuilt[0](jnp.array([zlocal[0], 0], dtype=jnp.int32),
                    *(jnp.asarray(a) for a in arrays))
    call, tm, tnf = tstream.build_stream_sharded_call(st, zlocal, zgshape, k)
    assert (tm, tnf) == jbuilt[1:] == (m, nf)
    got = call(zlocal[0], *fields_from_numpy(arrays, device=CPU))
    _close(_numpy(got), [np.asarray(r) for r in ref])
    Lz, Ly, X = local = (24, 16, 128)
    shapes = (local, (m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X),
              (m, m, X), (m, m, X), (m, m, X), (m, m, X))
    gshape = (3 * Lz, 3 * Ly, X)
    arrays = [rng.random(s, dtype=np.float32) for _ in range(nf)
              for s in shapes]
    jbuilt = jstream.build_stream_2axis_call(jst, local, gshape, k,
                                             interpret=True)
    ref = jbuilt[0](jnp.array([Lz, Ly], dtype=jnp.int32),
                    *(jnp.asarray(a) for a in arrays))
    call, tm, _ = tstream.build_stream_2axis_call(st, local, gshape, k)
    got = call((Lz, Ly), *fields_from_numpy(arrays, device=CPU))
    _close(_numpy(got), [np.asarray(r) for r in ref])


@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (2, 2, 1)])
@pytest.mark.parametrize("name", ["advect3d", "grayscott3d"])
def test_sharded_stream_step_new_families_matches_jax(name, mesh_shape):
    """kind="stream" for advection and Gray-Scott on z-only and (z, y)
    meshes == the JAX package's, two calls; rdma and overlap bit-equal to
    the in-process non-split step."""
    st = port.make_stencil(name)
    arrays = _seeded(st.num_fields, GRID, 140 + len(mesh_shape))
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(
        jmake_stencil(name), jm, GRID, 4, interpret=True, kind="stream")
    assert jstep is not None
    jf = jstepper.shard_fields(tuple(jnp.asarray(a) for a in arrays), jm, 3)
    jrun = jax.jit(jstep)
    mesh = _mesh(mesh_shape[:2])
    outs = []
    for ex, ov in (("ppermute", False), ("rdma", False), ("rdma", True)):
        step = tstepper.make_sharded_fused_step(st, mesh, GRID, 4,
                                                kind="stream", exchange=ex,
                                                overlap=ov)
        assert step._overlap_active is ov
        f = shard_from_numpy(arrays, mesh)
        for _ in range(2):
            f = step(f)
        outs.append(gather_to_numpy(f))
    for _ in range(2):
        jf = jrun(jf)
    _close(outs[0], [np.asarray(x) for x in jf], st.halo)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


CLI_NEW = [("advect3d", []), ("grayscott3d", []),
           ("advect3d", ["--mesh", "2,2", "--exchange", "rdma"]),
           ("grayscott3d", ["--mesh", "2,2"]),
           ("grayscott3d", ["--mesh", "2", "--exchange", "rdma",
                            "--overlap"])]


@pytest.mark.parametrize("name,flags", CLI_NEW,
                         ids=[f"{n}-{'_'.join(f.strip('-') for f in fl)}"
                              for n, fl in CLI_NEW])
def test_cli_stream_new_families_match_jax_cli(tmp_path, monkeypatch, name,
                                               flags):
    """--fuse 4 --fuse-kind stream for advection (both upwind directions)
    and Gray-Scott (its patch init) through both CLIs, unsharded and on
    meshes: final fields at atol 1e-4, frame exact."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", ",".join(map(str, GRID)),
            "--iters", "8", "--checkpoint-every", "8", "--fuse", "4",
            "--fuse-kind", "stream", *flags]
    if name == "advect3d":
        args += ["--param", "cz=-0.25"]
    jf, jstep, tf, tstep, _ = _run_both(tmp_path, args, "b5")
    assert jstep == tstep == 8
    _assert_match(tf, jf, 1, 1e-4)
