"""The ring exchange across processes (ROADMAP B7): the peer ring's plain
protocol (``ops/cuda/remote.py::PeerSite``), its region layout, its
refusals and its ``--mem-check`` term.

``PeerSite`` is the cross-process form of TPU table row 19: each process
owns one region a site (receive slots, a ready flag and a credit a chunk
here; a block on the card), a post lands each local shard's slabs in the
destination's slot ``epoch % nslots`` and publishes the ready flags, a
drain copies the slot out and releases the sender's credits.  On the CPU
its plain version walks that protocol on the host, the regions in shared
files.  Here it is held:

* in one process, two sites standing for two processes over one pair of
  region tensors, so the order of every post and drain is the test's:
  slot reuse over more epochs than ``nslots``, two posts in flight, one
  too many refused, a silent peer's drain raising at its deadline;
* on rings of one process (every neighbour local) against the in-process
  shift, bit for bit, for several ring depths and chunk ladders;
* across two real processes (gloo, shared files): slot reuse over nine
  epochs, every flag and credit drained at the end, and a peer that never
  sends making the drain raise within a short
  ``MPI_CUDA_PROCESS_TORCH_DIST_TIMEOUT``, naming the site, the peer, the
  chunk and the epoch; and the CLI with one rank killed by
  ``FAULT_INJECT=exchange:step=4:sigkill``, whose peer raises the peer
  ring's timeout instead of hanging.

Every subprocess has its own timeout and is killed on expiry.  The
multi-process ``--exchange rdma`` CLI cases (bit-equal to one process, to
gloo and to the JAX package) are in tests/test_torch_multiprocess.py.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu_torch import make_stencil
from mpi_cuda_process_tpu_torch.ops.cuda import remote as tremote
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import budget as tbudget

from test_torch_multiprocess import _env, _free_port

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT = 120  # seconds, each subprocess


def _meta(shape, nslots=2, dtype=torch.float32, chunks=None):
    return tremote.build_ring_exchange_call(shape, dtype, nslots=nslots,
                                            chunks=chunks)[1]


class _Pair:
    """The group of one of two processes whose regions this test holds."""

    def __init__(self, rank):
        self.process, self.processes = rank, 2

    def barrier(self):
        pass

    def all_gather_object(self, obj):
        raise AssertionError("the regions are given")


def _pair_sites(meta, timeout_s=5.0):
    """Two sites standing for processes 0 and 1 of a ring of two shards,
    one each (each is the other's next and previous), over one pair of
    region tensors."""
    nbytes = tremote.peer_layout(meta, 1, 1)["bytes"]
    regions = [torch.zeros(nbytes, dtype=torch.uint8) for _ in range(2)]
    return [tremote.PeerSite(meta, _Pair(r), [((1 - r, 0), (1 - r, 0))],
                             [((1 - r, 0), (1 - r, 0))], CPU,
                             timeout_s=timeout_s, regions=regions)
            for r in range(2)]


def _slabs(shape, seed):
    """One shard's (hi, lo) slab pair, from a seed."""
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.random(shape, dtype=np.float32))]
            for _ in range(2)]


# ---- the region -------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((4, 512, 1024), torch.float32),
                                         ((512, 4, 1024), torch.float32),
                                         ((4, 4, 1024), torch.float32),
                                         ((4, 4096, 4096), torch.bfloat16),
                                         ((3, 5, 130), torch.float32)])
def test_peer_region_layout(shape, dtype):
    """A process's region of a site on the card: nslots x 2 directions x
    local shards received slabs, then a ready flag and a credit (int32)
    for every block of every chunk of each (shard, direction), each piece
    on 256 bytes; the blocks of a chunk are its runs times the 1024-unit
    parts of a run (16-byte units where the geometry aligns, else one
    element)."""
    meta = _meta(shape, dtype=dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    Z, Y, X = shape
    nc = meta["nchunks"]
    if meta["chunk_axis"] == 0:
        runs, run_len, stride = 1, Z // nc * Y * X, Z // nc * Y * X
    else:
        runs, run_len, stride = Z, Y // nc * X, Y // nc * X
    per16 = 16 // esize
    unit = per16 if run_len % per16 == 0 and stride % per16 == 0 and \
        (Y * X) % per16 == 0 else 1
    blocks = runs * -(-(run_len // unit) // 1024)
    assert tremote.peer_blocks(meta) == blocks
    for shards in (1, 2, 4):
        lay = tremote.peer_layout(meta, shards, blocks)
        slots = 2 * 2 * shards * meta["slab_bytes"]
        flags = 2 * shards * nc * blocks * 4
        assert lay["slots"] == 0 and lay["flags"] == nc * blocks
        assert lay["ready"] == -(-slots // 256) * 256
        assert lay["credit"] == lay["ready"] + -(-flags // 256) * 256
        assert lay["bytes"] == lay["credit"] + -(-flags // 256) * 256
    assert tremote.peer_site_bytes(shape, dtype) == \
        tremote.peer_layout(meta, 1, blocks)["bytes"]


# ---- the protocol, two processes' sites in one ------------------------------

@pytest.mark.parametrize("nslots", [2, 3])
@pytest.mark.parametrize("shape,chunks", [((4, 64, 128), None),
                                          ((24, 4, 128), None),
                                          ((3, 5, 130), None),
                                          ((8, 32, 64), (1, 2))])
def test_slot_reuse_over_more_epochs_than_slots(shape, chunks, nslots):
    """3 * nslots + 1 epochs, each posted by both processes and drained by
    both, the slots reused in turn: every drain holds the peer's slabs of
    its epoch bit for bit, and every flag and credit reads the last epoch
    at the end."""
    meta = _meta(shape, nslots=nslots, chunks=chunks)
    a, b = _pair_sites(meta)
    for e in range(1, 3 * nslots + 2):
        slabs = {r: _slabs(shape, 100 * e + r) for r in range(2)}
        assert a.post(*slabs[0]) == e and b.post(*slabs[1]) == e
        for site, peer in ((a, 1), (b, 0)):
            fl, fr = site.drain(e)
            assert torch.equal(fl[0], slabs[peer][0][0])  # its hi
            assert torch.equal(fr[0], slabs[peer][1][0])  # its lo
    for site in (a, b):
        site.check_drained()
        assert site.sent == site.drained == 3 * nslots + 1


def test_posts_in_flight_up_to_the_slots():
    """Two epochs posted before either is drained fit two slots (a
    Gray-Scott step posts both fields' slabs first); a third post would
    overwrite an undrained slot and raises; a drain out of order raises."""
    meta = _meta((4, 16, 32))
    a, b = _pair_sites(meta)
    for e in (1, 2):
        a.post(*_slabs((4, 16, 32), e))
        b.post(*_slabs((4, 16, 32), 10 + e))
    with pytest.raises(RuntimeError, match="more exchanges in flight"):
        a.post(*_slabs((4, 16, 32), 3))
    with pytest.raises(RuntimeError, match="out of order"):
        a.drain(2)
    for e in (1, 2):
        assert torch.equal(a.drain(e)[0][0],
                           _slabs((4, 16, 32), 10 + e)[0][0])
        b.drain(e)
    a.check_drained()


def test_silent_peer_drain_raises_within_the_timeout():
    """A drain whose peer never posted raises PeerTimeout at its deadline,
    naming the site, the epoch, the chunk and the peer; so does a send
    whose slot the peer never drained."""
    meta = _meta((4, 16, 32))
    a, b = _pair_sites(meta, timeout_s=0.3)
    a.post(*_slabs((4, 16, 32), 1))
    t0 = time.monotonic()
    with pytest.raises(tremote.PeerTimeout) as err:
        a.drain(1)
    assert 0.3 <= time.monotonic() - t0 < 5
    msg = str(err.value)
    for words in ("ring_drain", "peer ring site", "4x16x32", "chunk 0",
                  "epoch 1", "process 1"):
        assert words in msg, msg
    # b never drains: a's third post waits for epoch 1's credit
    c, d = _pair_sites(meta, timeout_s=0.3)
    for e in (1, 2):
        c.post(*_slabs((4, 16, 32), e))
        d.post(*_slabs((4, 16, 32), e))
        c.drain(e)
    with pytest.raises(tremote.PeerTimeout, match="its credit .process 1 to "
                       "drain epoch 1"):
        c.post(*_slabs((4, 16, 32), 3))


def test_drained_check_names_a_stray_flag():
    meta = _meta((4, 16, 32))
    a, b = _pair_sites(meta)
    a.post(*_slabs((4, 16, 32), 1))
    b.post(*_slabs((4, 16, 32), 2))
    a.drain(1)
    b.drain(1)
    a.check_drained()
    a._flags(0, "ready", 0, 1)[0] = 7
    with pytest.raises(AssertionError, match="1 ready entries not at the "
                       "last epoch 1.*direction 1, chunk 0 reads 7"):
        a.check_drained()


@pytest.mark.parametrize("nslots", [2, 4])
@pytest.mark.parametrize("mesh_shape,axis", [((4,), 0), ((1, 4), 1),
                                             ((2, 2), 0), ((2, 2), 1)])
def test_one_process_peer_ring_equals_in_process_shift(mesh_shape, axis,
                                                       nslots):
    """A site whose neighbours all live in this process (a world of one):
    over 2 * nslots + 1 epochs each drain equals the in-process full-ring
    shift bit for bit and equals plain_peer_shift."""
    mesh = tmesh.make_mesh(mesh_shape, [CPU] * 4)
    shape = (4, 64, 128) if axis == 0 else (64, 4, 128)
    t = thalo.RdmaTransport(mesh, nslots=nslots)
    site = t._peer(mesh, axis, shape, torch.float32)
    assert site.S == 4 and site.world == 1
    for e in range(1, 2 * nslots + 2):
        rng = np.random.default_rng(e)
        hi = [torch.from_numpy(rng.random(shape, dtype=np.float32))
              for _ in range(4)]
        lo = [torch.from_numpy(rng.random(shape, dtype=np.float32))
              for _ in range(4)]
        fl, fr = site.drain(site.post(hi, lo))
        rl, rr = thalo.InProcessTransport().shift_pair(hi, lo, mesh, axis,
                                                       True)
        pl, pr = tremote.plain_peer_shift(hi, lo, site.frm)
        for x, y, z in zip(fl + fr, rl + rr, pl + pr):
            assert torch.equal(x, y) and torch.equal(x, z)
    site.check_drained()
    assert not tremote.launches  # CPU tensors never launch
    tremote.free_peer_regions()


def test_backend_names_the_peer_ring():
    """On a mesh over processes the transport is the peer ring
    (plain-peer-ring on the CPU); on one process the in-card ring."""
    two = tmesh.Mesh((2, 2), [CPU] * 2, process=1, processes=2,
                     backend="gloo")
    assert thalo.RdmaTransport(two).backend == "plain-peer-ring"
    assert thalo.RdmaTransport(two).multiprocess
    one = tmesh.make_mesh((2, 2), [CPU] * 4)
    assert thalo.RdmaTransport(one).backend == "plain-ring"


# ---- --mem-check ------------------------------------------------------------

@pytest.mark.parametrize("mesh,dtype", [((2, 2), torch.float32),
                                        ((2,), torch.float32),
                                        ((1, 2), torch.float32),
                                        ((4, 1, 1), torch.bfloat16)])
def test_budget_prices_the_receive_slots(mesh, dtype):
    """Across processes an rdma stream run carries its sites' regions (a
    sharded z: the z slabs' site; a sharded y: the y slabs' and the
    corners'), one region a shard, times the shards on the card; in one
    process, or without rdma, no such term."""
    st = make_stencil("heat3d", **({"dtype": "bfloat16"}
                                   if dtype == torch.bfloat16 else {}))
    assert st.dtype == dtype
    grid = (256, 64, 128)
    kw = dict(mesh=mesh, fuse=4, fuse_kind="stream", exchange="rdma")
    local = [g // c for g, c in zip(grid, tuple(mesh) + (1,) * 3)]
    m = 4
    shapes = ([(m, local[1], local[2])] if mesh[0] > 1 else []) + (
        [(local[0], m, local[2]), (m, m, local[2])]
        if len(mesh) > 1 and mesh[1] > 1 else [])
    want = sum(tremote.peer_site_bytes(s, dtype) for s in shapes)
    for shards in (1, 2):
        one, _ = tbudget.estimate_run_bytes(st, grid, shards_per_device=shards,
                                            **kw)
        many, parts = tbudget.estimate_run_bytes(
            st, grid, shards_per_device=shards, processes=2, **kw)
        slot = [b for lb, b in parts if lb.startswith("peer ring receive")]
        assert slot == [want] and want > 0
        # one region a shard, with the workspace overhead on top
        assert abs(many - one - shards * want * 1.1) <= 2
    ppermute = dict(kw, exchange="ppermute")
    _, parts = tbudget.estimate_run_bytes(st, grid, processes=2, **ppermute)
    assert not any(lb.startswith("peer ring") for lb, _ in parts)
    with pytest.raises(ValueError, match="peer ring receive slots"):
        tbudget.check_budget(st, grid, processes=2, hbm_bytes=1, **kw)


@pytest.mark.parametrize("name,dtype,processes,shards", [
    ("heat3d", "bfloat16", 4, 4), ("heat3d", "bfloat16", 4, 1),
    ("heat3d", "bfloat16", 2, 4), ("heat3d", "float32", 4, 4),
    ("wave3d", "bfloat16", 4, 4), ("wave3d", "float32", 4, 4)])
def test_budget_prices_each_process_log_line(name, dtype, processes, shards):
    """Processes that share a card log at the same step, each holding its
    block's log-line temporaries at once (a bfloat16 block's float32 copy
    for the mean: 4 B a cell; two fields' difference and square: two
    blocks): priced, for each process on the card, where they exceed the
    step's own transients of the process's shards, and never for one
    process."""
    st = make_stencil(name, **({"dtype": dtype} if dtype != "float32"
                               else {}))
    grid, mesh = (256, 64, 128), (2, 2)
    kw = dict(mesh=mesh, fuse=4, fuse_kind="stream", exchange="rdma",
              shards_per_device=shards)
    _, one = tbudget.estimate_run_bytes(st, grid, **kw)
    _, parts = tbudget.estimate_run_bytes(st, grid, processes=processes,
                                          **kw)
    cells = 128 * 32 * 128
    item = st.dtype.itemsize
    need = max(4 * cells if st.dtype == torch.bfloat16 else 0,
               2 * item * cells if st.num_fields > 1 else 0)
    per_shard = [b for lb, b in parts
                 if not lb.startswith(("state", "workspace", "log-line"))
                 and "more shard" not in lb]
    local = 4 // processes
    extra = need - local * sum(per_shard)
    got = [b for lb, b in parts if lb.startswith("log-line")]
    assert got == ([max(1, shards // local) * extra] if extra > 0 else [])
    # one bfloat16 shard a process: the float32 copy (4 B a cell) exceeds
    # the output block (2 B a cell) and the slabs
    assert (name, dtype, local) != ("heat3d", "bfloat16", 1) or got
    assert not any(lb.startswith("log-line") for lb, _ in one)


# ---- across two processes ---------------------------------------------------

_WORKER = r"""
import json, os, sys, time, traceback
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from mpi_cuda_process_tpu_torch.ops.cuda import remote
from mpi_cuda_process_tpu_torch.parallel import halo, mesh as mesh_lib

out = sys.argv[1]
mesh_lib.bootstrap_distributed(device="cpu")
rank = mesh_lib.process_index()
mesh = mesh_lib.make_mesh((2,), [torch.device("cpu")])
res = {{}}
shape = (4, 16, 32)
try:
    # slot reuse: nine epochs on rings of depth 2 and 3
    for nslots in (2, 3):
        t = halo.RdmaTransport(mesh, nslots=nslots)
        site = t._peer(mesh, 0, shape, torch.float32)
        for e in range(1, 10):
            rng = np.random.default_rng(100 * e + rank)
            hi, lo = (torch.from_numpy(rng.random(shape, dtype=np.float32))
                      for _ in range(2))
            fl, fr = t.post([hi], [lo], mesh, 0, False).wait()
            rng = np.random.default_rng(100 * e + 1 - rank)
            phi, plo = (torch.from_numpy(rng.random(shape,
                                                    dtype=np.float32))
                        for _ in range(2))
            assert torch.equal(fl[0], phi) and torch.equal(fr[0], plo), e
        t.check_drained()
        res[f"reuse_{{nslots}}"] = [site.sent, site.drained, t.stats]
    # a silent peer: process 1 posts nothing
    t = halo.RdmaTransport(mesh)
    site = t._peer(mesh, 0, (4, 8, 32), torch.float32)
    site.timeout_s = 1.5
    if rank == 0:
        pend = t.post([torch.ones(4, 8, 32)], [torch.ones(4, 8, 32)], mesh,
                      0, False)
        t0 = time.monotonic()
        try:
            pend.wait()
            res["silent"] = ["returned", 0.0]
        except remote.PeerTimeout as e:
            res["silent"] = [str(e), time.monotonic() - t0]
    mesh.barrier()
except Exception:
    res["error"] = traceback.format_exc()
with open(os.path.join(out, f"r{{rank}}.json"), "w") as fh:
    json.dump(res, fh)
mesh_lib.shutdown_distributed()
"""


def _ended(procs):
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """The protocol worker as 2 processes, and the CLI with rank 1 killed
    at its step-4 boundary, launched together."""
    out = tmp_path_factory.mktemp("peer_ring")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.format(repo=_REPO), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=r,
                 WORLD_SIZE=2, LOCAL_RANK=r, LOCAL_WORLD_SIZE=2))
        for r in range(2)]
    cli_port = _free_port()
    argv = ["--stencil", "heat3d", "--grid", "32,16,32", "--iters", "12",
            "--mesh", "2", "--fuse", "4", "--fuse-kind", "stream",
            "--exchange", "rdma", "--log-every", "8", "--checkpoint-every",
            "4", "--device", "cpu"]
    t0 = time.monotonic()
    killed = [subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=_REPO,
        env=_env(PYTHONPATH=_REPO, MASTER_ADDR="localhost",
                 MASTER_PORT=cli_port, RANK=r, WORLD_SIZE=2, LOCAL_RANK=r,
                 LOCAL_WORLD_SIZE=2, **{tmesh.DIST_TIMEOUT_ENV: 4},
                 **({"FAULT_INJECT": "exchange:step=4:sigkill"} if r == 1
                    else {})))
        for r in range(2)]
    ends = _ended(procs + killed)
    seconds = time.monotonic() - t0
    res = []
    for r in range(2):
        assert ends[r][0] == 0, ends[r][1]
        with open(out / f"r{r}.json") as fh:
            res.append(json.load(fh))
        assert "error" not in res[r], res[r]["error"]
    return {"res": res, "killed": ends[2:], "seconds": seconds}


@pytest.mark.parametrize("nslots", [2, 3])
def test_two_processes_reuse_slots_and_drain(two_processes, nslots):
    """Nine epochs between two processes through shared files: each
    drain holds the peer's slabs of its epoch, every flag and credit ends
    at epoch 9 on both processes, and the transport counts each shift's
    bytes to the other process."""
    for r in range(2):
        sent, drained, stats = two_processes["res"][r][f"reuse_{nslots}"]
        assert sent == drained == 9
        assert stats["shifts"] == 9
        assert stats["bytes"] == 9 * 2 * 4 * 16 * 32 * 4


def test_two_processes_silent_peer_raises(two_processes):
    """Process 1 never posts: process 0's drain raises within its 1.5 s
    deadline (not the group's), naming the site, the chunk, the epoch and
    process 1."""
    msg, seconds = two_processes["res"][0]["silent"]
    assert 1.5 <= seconds < 10, seconds
    for words in ("ring_drain", "axis 0 slab 4x8x32", "chunk 0",
                  "epoch 1", "process 1 is gone or stalled"):
        assert words in msg, msg


def test_killed_rank_leaves_its_peer_raising(two_processes):
    """``FAULT_INJECT=exchange:step=4:sigkill`` on rank 1 only: it dies by
    SIGKILL at its step-4 boundary; rank 0 goes on to the second pass,
    whose drain raises the peer ring's timeout (4 s) naming process 1 and
    epoch 2, and exits non-zero, well inside the subprocess timeout."""
    (rc0, err0), (rc1, err1) = two_processes["killed"]
    assert rc1 == -signal.SIGKILL, err1
    assert "firing 'exchange:step=4:sigkill'" in err1
    assert rc0 not in (0, None), err0
    assert "PeerTimeout: ring_drain" in err0, err0
    assert "epoch 2" in err0 and "process 1 is gone or stalled" in err0
    assert two_processes["seconds"] < TIMEOUT
