"""The member repack of ``parallel/reshard.py``: the port against the JAX
package.

The same member fields (every element distinct across the batch, made
from ``np.arange``) go through the JAX package's ``repack_members`` (on
the conftest's 8 virtual CPU devices) and the port's (on 8 virtual CPU
shards): the same moved values and zero ballast bit for bit (pure data
movement), and the same plan — every round's pairs, send, receive and
``real`` tables, and ``n_comm_rounds`` — in the local form (no member
sharding, unsharded or on a spatial mesh) and the collective form (the
member axis over 4 ensemble groups).  A recorded port repack passes
``launchcheck.assert_member_repack_structure``; hand-made sequences that
gather, miscount the rounds or hold the whole member axis fail it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mpi_cuda_process_tpu.parallel import make_mesh as jmake_mesh
from mpi_cuda_process_tpu.parallel import plan_member_repack as jplan
from mpi_cuda_process_tpu.parallel import repack_members as jrepack
from mpi_cuda_process_tpu.parallel import shard_fields as jshard

from mpi_cuda_process_tpu_torch import driver, make_stencil
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import reshard as treshard
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import launchcheck
from mpi_cuda_process_tpu_torch.utils.init import init_state

CPU = torch.device("cpu")


def _members(n, grid=(8, 8)):
    size = int(np.prod(grid))
    return tuple(np.arange(f * n * size, (f + 1) * n * size,
                           dtype=np.float32).reshape((n,) + grid)
                 for f in range(2))


def _tmesh(shape, ensemble=1):
    n = ensemble * int(np.prod(shape))
    return tmesh.make_mesh(shape, [CPU] * n, ensemble=ensemble)


def _host(out):
    if tstepper.is_sharded(out):
        out = tstepper.gather_fields(out, device="cpu")
    return tuple(np.asarray(f) for f in out)


def _rounds(plan):
    return [(tuple(r.perm), r.send.tolist(), r.recv.tolist(),
             r.real.tolist()) for r in plan.rounds]


CASES = [
    # (n_src, n_dst, slot_map, spatial mesh, ensemble groups)
    (8, 4, {1: 0, 3: 1, 6: 2}, None, 1),            # local defrag
    (4, 8, {0: 5, 2: 1}, None, 1),                  # local grow
    (8, 4, {0: 0, 5: 1, 7: 2}, (2, 4), 1),          # spatial mesh, local
    (8, 4, {4: 0, 5: 1, 6: 2, 7: 3}, (2, 1), 4),    # all moves cross groups
    (8, 4, {1: 0, 2: 1, 5: 2, 7: 3}, (2, 1), 4),    # mixed local + cross
    (4, 8, {0: 7, 1: 2, 2: 5}, (2, 1), 4),          # grow, scattered targets
    (8, 8, {0: 3, 3: 0, 6: 1}, (1, 2), 4),          # permute in place
]


@pytest.mark.parametrize("n_src,n_dst,slot_map,mesh,groups", CASES,
                         ids=["local-defrag", "local-grow", "spatial",
                              "cross", "mixed", "grow", "permute"])
def test_repack_matches_jax(n_src, n_dst, slot_map, mesh, groups):
    grid = (16, 16) if mesh == (2, 4) else (8, 8)
    host = _members(n_src, grid)
    if mesh is None:
        jout = jrepack(tuple(jnp.asarray(h) for h in host), slot_map, n_dst)
        tin = tuple(torch.from_numpy(h.copy()) for h in host)
        tm = jm = None
    else:
        jm = jmake_mesh(mesh, ensemble=groups) if groups > 1 \
            else jmake_mesh(mesh)
        jout = jrepack(jshard(tuple(jnp.asarray(h) for h in host), jm, 2,
                              ensemble=True), slot_map, n_dst, mesh=jm)
        tm = _tmesh(mesh, groups)
        tin = tstepper.shard_fields(
            tuple(torch.from_numpy(h.copy()) for h in host), tm, 2,
            ensemble=True)
    with launchcheck.record() as rec:
        tout = treshard.repack_members(tin, slot_map, n_dst)
    got, want = _host(tout), tuple(np.asarray(f) for f in jout)
    for g, w, h in zip(got, want, host):
        assert g.shape == (n_dst,) + grid
        np.testing.assert_array_equal(g, w)
        for s, d in slot_map.items():
            np.testing.assert_array_equal(g[d], h[s])
    tplan = treshard.plan_member_repack(n_src, n_dst, slot_map, mesh=tm,
                                        grid_ndim=2)
    jp = jplan(n_src, n_dst, slot_map, mesh=jm, grid_ndim=2)
    assert tplan.collective == jp.collective == (groups > 1)
    assert tplan.n_comm_rounds == jp.n_comm_rounds
    assert _rounds(tplan) == _rounds(jp)
    info = launchcheck.assert_member_repack_structure(
        rec.records, tplan, 2, grid_shape=grid)
    assert info["n_rounds"] == 2 * jp.n_comm_rounds
    assert info["n_gathers"] == 0


def test_repack_there_and_back_is_bit_exact():
    """Shrink then grow with the inverse map restores every survivor to
    its slot, in both forms."""
    for mesh, groups in ((None, 1), ((2, 1), 4)):
        host = _members(8)
        fields = tuple(torch.from_numpy(h.copy()) for h in host)
        if mesh is not None:
            fields = tstepper.shard_fields(fields, _tmesh(mesh, groups), 2,
                                           ensemble=True)
        down = {1: 0, 4: 1, 6: 2, 7: 3}
        up = {d: s for s, d in down.items()}
        back = _host(treshard.repack_members(
            treshard.repack_members(fields, down, 4), up, 8))
        for h, b in zip(host, back):
            for s in range(8):
                if s in down:
                    np.testing.assert_array_equal(b[s], h[s])
                else:
                    assert not b[s].any()


def test_repack_mid_flight_keeps_survivors_bit_exact():
    """Step a partially occupied batch, repack the survivors down, step
    on: each survivor equals its uninterrupted solo run (the serving
    scheduler's shrink contract)."""
    st = make_stencil("life")
    grid = (16, 16)
    occupied = {0: 11, 2: 23, 5: 37}          # slot -> seed
    step = driver.make_step(st, grid)
    inits = {s: init_state(st, grid, seed=seed, device="cpu")
             for s, seed in occupied.items()}
    batch = tuple(torch.stack([
        inits[s][f] if s in inits else torch.zeros(grid, dtype=torch.int32)
        for s in range(6)]) for f in range(st.num_fields))
    for _ in range(3):
        batch = step(batch)
    slot_map = {s: i for i, s in enumerate(sorted(occupied))}
    batch = treshard.repack_members(batch, slot_map, 4)
    for _ in range(3):
        batch = step(batch)
    for s in occupied:
        ref = inits[s]
        for _ in range(6):
            ref = step(ref)
        for f in range(st.num_fields):
            assert torch.equal(batch[f][slot_map[s]], ref[f])


def test_repack_validation_matches_jax():
    for args, match in (((4, 2, {0: 0, 1: 0}), "unique"),
                        ((4, 2, {5: 0}), "outside"),
                        ((4, 2, {0: 3}), "outside")):
        for plan in (jplan, treshard.plan_member_repack):
            with pytest.raises(ValueError, match=match):
                plan(*args)
    with pytest.raises(ValueError, match="divide"):
        treshard.plan_member_repack(6, 4, {0: 0}, mesh=_tmesh((1, 1), 4))
    with pytest.raises(ValueError, match="divide"):
        jplan(6, 4, {0: 0}, mesh=jmake_mesh((1, 1), ensemble=4))


def _rec(op, index, elems=8, **attrs):
    return launchcheck.Record(index=index, op=op, max_elems=elems,
                              attrs=attrs)


def test_structure_check_fails_on_a_gather_a_miscount_or_a_whole_axis():
    mesh = _tmesh((2, 1), 4)
    plan = treshard.plan_member_repack(8, 4, {4: 0, 5: 1, 6: 2, 7: 3},
                                       mesh=mesh, grid_ndim=2)
    assert plan.n_comm_rounds == 2
    good = [_rec("member_post", i, field=f)
            for i, f in enumerate((0, 0, 1, 1))]
    info = launchcheck.assert_member_repack_structure(good, plan, 2,
                                                      (8, 8))
    assert info == {"n_rounds": 4, "n_gathers": 0, "max_local_elems": 8,
                    "global_size": 512}
    with pytest.raises(AssertionError, match="gather"):
        launchcheck.assert_member_repack_structure(
            good + [_rec("gather", 4, elems=512)], plan, 2, (8, 8))
    with pytest.raises(AssertionError, match="transport round"):
        launchcheck.assert_member_repack_structure(good[:3], plan, 2,
                                                   (8, 8))
    with pytest.raises(AssertionError, match="whole member axis"):
        launchcheck.assert_member_repack_structure(
            good + [_rec("repack_stay", 4, elems=512, field=0)], plan, 2,
            (8, 8))
    # a repack that was not recorded at all
    local = treshard.plan_member_repack(8, 4, {1: 0})
    with pytest.raises(AssertionError, match="not recorded"):
        launchcheck.assert_member_repack_structure([], local, 2)


def test_a_recorder_takes_only_its_own_threads_ops():
    """Two threads record at once (a serving engine's class threads): each
    recorder holds its own thread's repack and none of the other's."""
    import threading

    host = tuple(torch.from_numpy(h.copy()) for h in _members(8))
    got = {}

    def run(name, slot_map):
        with launchcheck.record() as rec:
            treshard.repack_members(host, slot_map, 4)
        got[name] = rec.records

    threads = [threading.Thread(target=run, args=(n, m)) for n, m in
               (("a", {0: 0}), ("b", {1: 0, 2: 1}))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert [r.op for r in got["a"]] == ["repack_move"] * 2
    assert [r.op for r in got["b"]] == ["repack_move"] * 2
    assert not launchcheck.active()


def test_a_host_gather_inside_a_repack_recording_fails_the_check():
    """``stepper.gather_fields`` (the host gather) is a recorded op: a
    repack that went through it fails the gate."""
    mesh = _tmesh((2, 1), 4)
    fields = tstepper.shard_fields(
        tuple(torch.from_numpy(h.copy()) for h in _members(8)), mesh, 2,
        ensemble=True)
    plan = treshard.plan_member_repack(8, 8, {0: 1}, mesh=mesh,
                                       grid_ndim=2)
    with launchcheck.record() as rec:
        treshard.make_member_repack(plan, 2)(fields)
        tstepper.gather_fields(fields)
    with pytest.raises(AssertionError, match="gather"):
        launchcheck.assert_member_repack_structure(rec.records, plan, 2,
                                                   (8, 8))
