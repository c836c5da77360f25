"""The launch-sequence structure checks (``utils/launchcheck.py``), the
port's counterpart of the JAX package's ``utils/jaxprcheck.py``.

Each check passes on the port's real steps at small shapes on the CPU
(where the recorded sequence is the card's: the hooks sit at the dispatch
boundary) and fails on a deliberately broken twin built here:

* overlap with and without the pipeline, for the pad-free, stream and
  padded kinds, the plain sharded step and the 2D row split: the interior
  runs on the main stream between the side stream's post and its wait,
  reads nothing a wait gave, and no later post reads what it wrote;
  broken: an interior that waits on the exchange first;
* the pipelined body issues the plain step's exchange rounds; broken: a
  pass that posts twice;
* rdma: no in-process shift, one ring launch a site and field; broken: an
  rdma pass with an in-process shift;
* ensembles: the rounds do not depend on N; broken: one shift a member;
* device groups under ``device_put`` and ``collective``: a group's
  exchange stays on its own mesh, the collective wire posts 2 x
  interfaces shifts and no host copy; broken: a device_put round read as
  collective.

The JAX package's checks read its traced jaxprs (tests/test_pipeline_*.py,
tests/test_overlap_fused.py, tests/test_ensemble_engine.py,
tests/test_groups.py); the recorded counts are held against them where the
two count the same thing: exact.
"""

import math

import pytest
import torch

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import launchcheck as lc
from mpi_cuda_process_tpu_torch.utils.init import init_state

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * math.prod(shape))


def _fields(st, grid, mesh, ensemble=0):
    return tstepper.shard_fields(
        init_state(st, grid, seed=3, kind="pulse", device=CPU,
                   ensemble=ensemble), mesh, st.ndim,
        ensemble=bool(ensemble))


def _recorded(step, fields):
    with lc.record() as rec:
        step(fields)
    return rec.records


# ---- overlap and pipeline ------------------------------------------------

PIPELINES = [
    ("heat3d", (32, 16, 128), (2, 1, 1), "padfree", "ppermute"),
    ("heat3d", (48, 48, 128), (2, 2, 1), "padfree", "ppermute"),
    ("wave3d", (48, 48, 128), (2, 2, 1), "stream", "ppermute"),
    ("heat3d", (96, 32, 128), (2, 1, 1), "stream", "rdma"),
    ("heat3d", (48, 48, 128), (2, 2, 1), "stream", "rdma"),
]


@pytest.mark.parametrize("case", PIPELINES, ids=[
    f"{c[0]}-{c[3]}-{c[4]}-{'x'.join(map(str, c[2][:2]))}"
    for c in PIPELINES])
def test_pipeline_structure_holds_on_the_real_steps(case):
    name, grid, mesh, kind, exchange = case
    rep = lc.check_pipeline_structure(name, grid, mesh, 4, kind, exchange)
    assert not rep["interior_depends_on_exchange"]
    assert not rep["exchange_depends_on_interior"]
    assert rep["plain"]["interior_between_side_post_and_wait"]
    # one round a sharded axis's slab pair: z 2, y 2, corners 4, a field
    st = port.make_stencil(name)
    per_field = (2 if mesh[0] > 1 else 0) + (6 if mesh[1] > 1 else 0)
    if exchange == "rdma":
        per_field = (1 if mesh[0] > 1 else 0) + (3 if mesh[1] > 1 else 0)
        assert rep["rdma"]["n_ring"] == st.num_fields * per_field
    assert rep["n_ppermute"] == st.num_fields * per_field


OVERLAPS = [
    ("padded", "heat3d", (48, 48, 128), (2, 2, 1)),
    ("padfree", "heat3d", (48, 48, 128), (2, 2, 1)),
    ("stream", "heat3d", (48, 16, 128), (2, 1, 1)),
    ("plain", "wave3d", (16, 16, 128), (2, 2, 1)),
    ("fullgrid", "heat2d", (64, 128), (2, 1)),
]


def _overlapped(kind, name, grid, mesh_shape, exchange="ppermute"):
    st = port.make_stencil(name)
    mesh = _mesh(mesh_shape)
    if kind == "plain":
        step = tstepper.make_sharded_step(st, mesh, grid, overlap=True)
    else:
        step = tstepper.make_sharded_temporal_step(
            st, mesh, grid, 8 if kind == "fullgrid" else 4,
            kind=None if kind in ("padded", "fullgrid") else kind,
            overlap=True, exchange=exchange, device=CPU)
    assert step is not None
    if kind != "plain":
        assert step._overlap_active
    return st, mesh, step


@pytest.mark.parametrize("case", OVERLAPS, ids=[c[0] for c in OVERLAPS])
def test_interior_overlaps_the_exchange_on_the_real_steps(case):
    st, mesh, step = _overlapped(*case)
    recs = _recorded(step, _fields(st, case[2], mesh))
    rep = lc.assert_interior_overlaps_exchange(recs)
    assert rep["posts_before_interior"] > 0
    # the interiors' own one-shard operands are posted, never as an
    # exchange (the likely trouble: every step would read as dependent)
    local = [r for r in recs if r.op == "post" and r.shards == 1]
    if case[0] in ("padded", "padfree", "stream"):
        assert local
    interiors = [r for r in recs if r.op == "interior"]
    assert len(interiors) == mesh.size
    assert all(r.stream == "main" for r in interiors)


def test_a_broken_interior_that_waits_on_the_exchange_first_fails():
    """The interior launched after the exchange is awaited, reading its
    slabs: the values could be right, the structure is serial."""
    st, mesh, step = _overlapped(*OVERLAPS[1])
    fields = _fields(st, OVERLAPS[1][2], mesh)
    m = 4 * st.halo

    with lc.record() as rec:
        with lc.side_scope():
            posted = [thalo.post_slabs_2axis(f, mesh, m, bc)
                      for f, bc in zip(fields, st.bc_value)]
        slabs = [p.wait() for p in posted]
        for i in range(mesh.size):
            lc.note("interior", reads=([f[i] for f in fields],
                                       [s[i] for s in slabs]),
                    writes=[f[i].clone() for f in fields])
    with pytest.raises(AssertionError, match="waits on"):
        lc.assert_interior_overlaps_exchange(rec.records)
    rep = lc.interior_exchange_independence(rec.records)
    assert rep["interior_depends_on_exchange"]
    assert not rep["interior_between_side_post_and_wait"]


def test_a_broken_exchange_that_reads_the_interior_fails():
    """A post after the interior reading the interior's output blocks
    (the next slabs taken from the spliced array, not the shells)."""
    st, mesh, step = _overlapped(*OVERLAPS[1])
    fields = _fields(st, OVERLAPS[1][2], mesh)
    with lc.record() as rec:
        out = [f[0].clone() for f in fields]
        lc.note("interior", reads=[f[0] for f in fields], writes=out)
        thalo.InProcessTransport().post(
            [o.narrow(0, 0, 4) for o in out] * mesh.size,
            [o.narrow(0, 0, 4) for o in out] * mesh.size, mesh, 0, False)
    rep = lc.interior_exchange_independence(rec.records)
    assert rep["exchange_depends_on_interior"]


def test_a_broken_pass_that_posts_twice_fails():
    """A pipelined body that posts an extra exchange round: the carry must
    move the exchange, not duplicate it."""
    st = port.make_stencil("heat3d")
    mesh = _mesh((2, 2, 1))
    grid = (48, 48, 128)

    def mk(pipe):
        return tstepper.make_sharded_fused_step(
            st, mesh, grid, 4, kind="padfree", overlap=True, pipeline=pipe,
            device=CPU)

    pipelined, plain = mk(True), mk(False)
    real_body = pipelined._pipeline_body

    class Twice:
        _pipeline_prologue = staticmethod(pipelined._pipeline_prologue)

        @staticmethod
        def _pipeline_body(fields, carry, post_next=True):
            out = real_body(fields, carry, post_next)
            thalo.exchange_slabs_2axis(fields[0], mesh, 4, st.bc_value[0])
            return out

    fields = _fields(st, grid, mesh)
    lc.assert_pipeline_body_structure(pipelined, plain, fields, True)
    with pytest.raises(AssertionError, match="duplicate or drop"):
        lc.assert_pipeline_body_structure(Twice, plain, fields, True)


# ---- rdma ------------------------------------------------------------------


@pytest.mark.parametrize("mesh,grid", [((2, 1, 1), (96, 32, 128)),
                                       ((2, 2, 1), (48, 48, 128))],
                         ids=["z", "2x2"])
@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_rdma_structure_holds_and_an_in_process_shift_fails(mesh, grid,
                                                            overlap):
    from mpi_cuda_process_tpu_torch.obs import costmodel

    st = port.make_stencil("heat3d")
    m = _mesh(mesh)
    step = tstepper.make_sharded_fused_step(
        st, m, grid, 4, kind="stream", exchange="rdma", overlap=overlap,
        device=CPU)
    fields = _fields(st, grid, m)
    want = costmodel.comm_stats(st, grid, mesh, fuse=4, fuse_kind="stream",
                                exchange="rdma")
    recs = _recorded(step, fields)
    rep = lc.assert_rdma_step_structure(
        recs, want["rdma_exchange_calls_per_pass"])
    assert rep["n_ring"] == want["rdma_exchange_calls_per_pass"]
    if overlap:
        lc.assert_interior_overlaps_exchange(recs, "rdma")
    with lc.record() as rec:
        step(fields)
        # the broken twin: one field's z slabs shifted in process
        thalo.exchange_slabs_axis(fields[0], m, 0, 4, st.bc_value[0])
    with pytest.raises(AssertionError, match="in-process"):
        lc.assert_rdma_step_structure(rec.records)


# ---- ensembles -------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(), dict(grid=(48, 48, 128), mesh_shape=(2, 2, 1), kind="stream"),
    dict(grid=(96, 32, 128), exchange="rdma")],
    ids=["padfree-z", "stream-2x2", "rdma"])
def test_ensemble_exchange_is_invariant_in_members(case):
    rep = lc.check_ensemble_structure(ensemble=4, **case)
    assert rep["n_exchange_batched"] == rep["n_exchange_single"] > 0


def test_a_broken_ensemble_step_that_shifts_each_member_fails():
    st = port.make_stencil("heat3d")
    mesh = _mesh((2, 1, 1))
    grid = (32, 16, 128)
    single = tstepper.make_sharded_fused_step(st, mesh, grid, 4,
                                              kind="padfree", device=CPU)
    one = _fields(st, grid, mesh)
    rs = _recorded(single, one)
    with lc.record() as rec:
        for _ in range(3):  # one exchange a member of N = 3
            single(one)
    with pytest.raises(AssertionError, match="inside each shift"):
        lc.assert_ensemble_exchange_invariance(rec.records, rs)


# ---- device groups ---------------------------------------------------------

GROUPS = [
    ("heat3d@0-3,heat3d@4-7", (30, 16, 16)),
    ("wave3d:fine@0-3:z1/4:mesh1x4:fuse4,heat3d:coarse@4-7:mesh1x4:fuse4",
     (32, 32, 64)),
]


@pytest.mark.parametrize("transport", ["device_put", "collective"])
@pytest.mark.parametrize("spec,grid", GROUPS, ids=["plain", "fused"])
def test_coupled_structure_holds_on_the_real_runner(spec, grid, transport,
                                                    monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    rep = lc.check_coupled_structure(spec, grid, transport)
    assert rep["n_groups"] == 2 and all(rep["group_ppermute"])
    if transport == "collective":
        assert rep["n_ppermute"] == 2 and rep["n_device_put"] == 0
    else:
        assert rep["interface_posts"] == 0 and rep["interface_puts"] > 0


def test_a_device_put_round_fails_the_collective_gate(monkeypatch):
    """The broken twin: a round whose bands take the host-mediated copy
    where the collective wire was asked for."""
    from mpi_cuda_process_tpu_torch.parallel import groups as tgroups

    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    plans = tgroups.plans_from_config(*GROUPS[0], n_devices=8)
    runner = tgroups.CoupledRunner(plans, transport="device_put",
                                   device=CPU)
    recs = lc.record_coupled_round(runner)
    lc.assert_coupled_structure(recs, runner.sharded_group_indices(),
                                [id(m) for m in runner.meshes])
    with pytest.raises(AssertionError, match="host-mediated"):
        lc.assert_group_transport_structure(recs, 1)
    # a group whose step exchanged over another group's mesh
    with pytest.raises(AssertionError, match="crossed groups"):
        lc.assert_coupled_structure(recs, runner.sharded_group_indices(),
                                    [id(m) for m in reversed(runner.meshes)])


def test_the_recorder_is_off_outside_a_record_block():
    """Outside ``record()`` every hook is a global check: a step records
    nothing and the recorder does not nest."""
    st = port.make_stencil("heat3d")
    mesh = _mesh((2, 1, 1))
    step = tstepper.make_sharded_fused_step(st, mesh, (32, 16, 128), 4,
                                            kind="padfree", overlap=True,
                                            device=CPU)
    step(_fields(st, (32, 16, 128), mesh))
    assert not lc.active()
    with lc.record():
        with pytest.raises(RuntimeError, match="nest"):
            with lc.record():
                pass
    assert not lc.active()
