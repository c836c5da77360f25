"""The pipelined slab-carry exchange (``pipeline=True``) against the
per-pass exchange and against the JAX package.

``make_sharded_fused_step(pipeline=True)`` changes WHEN each pass's
width-m exchange is posted — from the previous pass's output border rows
(with ``--overlap``, its boundary-shell outputs), one pass ahead of its
consumer — and never a value: the carried slabs hold the bytes the
per-pass exchange would fetch, so every case is held BIT-EQUAL to
``pipeline=False`` through ``driver.make_runner`` (three passes, so the
third pass reads slabs posted from the second pass's shells), as the JAX
package's tests/test_pipeline_fused.py holds its pipeline.  The first pass
of each case is also held to the JAX package's plain step (k plain steps
from the same numpy inputs): float32 ``atol = 1e-4`` (tests/test_fused.py),
bfloat16 ``32 eps max(|ref|, 1)`` (tests/test_torch_bf16.py).

The port's meshes run on ``devices=[cpu] * n``; every kernel wrapper takes
its plain version for CPU tensors.  Also here: the carry at the loop's
edges (0, 1, 2 passes; a chunked run reseeds it, ``run_until`` threads it,
the last pass's exchange is awaited), the refusals with the JAX package's
reasons (periodic, the padded kind, 2D, an untileable shape), the
sender-side border exchanges (``halo.*_from_borders``), the CLI's
``--pipeline`` and the budget's carried-slab term.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import budget as jbudget

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import budget as tbudget

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPS_BF16 = 2.0 ** -7
PASSES = 3

# (id, stencil, grid, mesh, k, kind, overlap, exchange, dtype): every
# sharded local extent is at least 3m, so each overlapped case splits.
CASES = [
    ("zslab", "heat3d", (32, 16, 64), (2,), 4, "padfree", False, None,
     None),
    ("zslab_overlap", "heat3d", (32, 16, 64), (2,), 4, "padfree", True,
     None, None),
    ("yzslab", "heat3d", (32, 32, 64), (2, 2), 4, "padfree", False, None,
     None),
    ("yzslab_overlap", "heat3d", (32, 32, 64), (2, 2), 4, "padfree", True,
     None, None),
    ("yslab_only_overlap", "heat3d", (16, 32, 64), (1, 2), 4, "padfree",
     True, None, None),
    ("stream_z", "heat3d", (32, 16, 64), (2,), 4, "stream", False, None,
     None),
    ("stream_z_overlap", "heat3d", (32, 16, 64), (2,), 4, "stream", True,
     None, None),
    ("stream_yz", "heat3d", (32, 32, 64), (2, 2), 4, "stream", False, None,
     None),
    ("stream_yz_overlap", "heat3d", (32, 32, 64), (2, 2), 4, "stream", True,
     None, None),
    ("stream_z_rdma", "heat3d", (32, 16, 64), (2,), 4, "stream", False,
     "rdma", None),
    ("stream_z_rdma_overlap", "heat3d", (32, 16, 64), (2,), 4, "stream",
     True, "rdma", None),
    ("stream_yz_rdma", "heat3d", (32, 32, 64), (2, 2), 4, "stream", False,
     "rdma", None),
    ("stream_yz_rdma_overlap", "heat3d", (32, 32, 64), (2, 2), 4, "stream",
     True, "rdma", None),
    ("wave3d_yzslab_overlap", "wave3d", (32, 32, 64), (2, 2), 4, "padfree",
     True, None, None),
    ("wave3d_zslab", "wave3d", (32, 16, 64), (2,), 4, "padfree", False, None,
     None),
    ("heat3d27_stream_yz_overlap", "heat3d27", (32, 32, 64), (2, 2), 4,
     "stream", True, None, None),
    ("bf16_yzslab", "heat3d", (48, 48, 64), (2, 2), 8, "padfree", False,
     None, "bfloat16"),
    ("bf16_yzslab_overlap", "heat3d", (48, 48, 64), (2, 2), 8, "padfree",
     True, None, "bfloat16"),
    ("bf16_stream_z_overlap", "heat3d", (48, 16, 64), (2,), 8, "stream",
     True, None, "bfloat16"),
    ("sor7_zslab", "sor3d", (32, 16, 64), (2,), 2, "padfree", False, None,
     None),
    ("sor7_yzslab_overlap", "sor3d", (32, 32, 64), (2, 2), 2, "padfree",
     True, None, None),
    ("sor7_stream_yz_overlap", "sor3d", (32, 32, 64), (2, 2), 2, "stream",
     True, None, None),
]
IDS = [c[0] for c in CASES]


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _stencil(name, dtype):
    return port.make_stencil(name, **({"dtype": dtype} if dtype else {}))


def _arrays(st, grid, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def _sharded(st, arrays, mesh):
    return tstepper.shard_fields(
        tuple(torch.from_numpy(a).to(st.dtype) for a in arrays), mesh, 3)


def _pair(name, grid, mesh_shape, k, kind, overlap=False, exchange=None,
          dtype=None):
    st = _stencil(name, dtype)
    mesh = _mesh(mesh_shape)

    def make(pipe):
        return tstepper.make_sharded_fused_step(
            st, mesh, grid, k, kind=kind, overlap=overlap, pipeline=pipe,
            exchange=exchange)

    plain, pipe = make(False), make(True)
    assert plain is not None and pipe is not None
    assert pipe._pipeline_active
    assert not getattr(plain, "_pipeline_active", False)
    assert pipe._overlap_active is plain._overlap_active is overlap
    assert pipe._padfree_kind == plain._padfree_kind
    return st, mesh, plain, pipe


def _equal(a, b):
    for x, y in zip(tstepper.gather_fields(a), tstepper.gather_fields(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def _run(step, st, arrays, mesh, n):
    return tdriver.make_runner(step, n)(_sharded(st, arrays, mesh))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_pipeline_bit_equal_to_per_pass_exchange(case):
    """Three passes through the runner (the carry threaded), and the
    pipelined step called plainly, equal the per-pass exchange bit for
    bit."""
    _, name, grid, mesh_shape, k, kind, overlap, exchange, dtype = case
    st, mesh, plain, pipe = _pair(name, grid, mesh_shape, k, kind, overlap,
                                  exchange, dtype)
    arrays = _arrays(st, grid)
    _equal(_run(pipe, st, arrays, mesh, PASSES),
           _run(plain, st, arrays, mesh, PASSES))
    _equal(pipe(_sharded(st, arrays, mesh)),
           plain(_sharded(st, arrays, mesh)))
    if exchange == "rdma":
        assert pipe._exchange == "rdma"
        assert pipe._rdma_backend == "plain-ring"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_first_pass_matches_jax_plain_steps(case):
    """The first pipelined pass equals k of the JAX package's plain steps
    from the same inputs: float32 atol 1e-4, bfloat16 32 eps max(|ref|,
    1); the guard frame exactly."""
    _, name, grid, mesh_shape, k, kind, overlap, exchange, dtype = case
    st, mesh, _, pipe = _pair(name, grid, mesh_shape, k, kind, overlap,
                              exchange, dtype)
    arrays = _arrays(st, grid)
    got = tstepper.gather_fields(_run(pipe, st, arrays, mesh, 1))
    jst = jmake_stencil(name, **({"dtype": dtype} if dtype else {}))
    jstep = jdriver.make_step(jst, grid)
    jf = tuple(jnp.asarray(a).astype(jst.dtype) for a in arrays)
    for _ in range(k):
        jf = jstep(jf)
    h = st.halo
    for g, r in zip(got, jf):
        r = np.asarray(r.astype(jnp.float32))
        g = g.float().numpy()
        atol = 32 * EPS_BF16 * max(float(np.abs(r).max()), 1.0) \
            if dtype else 1e-4
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        frame = np.ones(grid, bool)
        frame[h:-h, h:-h, h:-h] = False
        np.testing.assert_array_equal(g[frame], r[frame])


# ---- the carry at the loop's edges -----------------------------------------

@pytest.mark.parametrize("n_steps", [0, 1, 2])
def test_pipeline_loop_boundaries(n_steps):
    """0 passes return the fields untouched (no exchange posted), 1 is the
    prologue and its epilogue, 2 one carry handoff."""
    st, mesh, plain, pipe = _pair("heat3d", (32, 16, 64), (2,), 4,
                                  "padfree", overlap=True)
    arrays = _arrays(st, (32, 16, 64))
    _equal(_run(pipe, st, arrays, mesh, n_steps),
           _run(plain, st, arrays, mesh, n_steps))


def _counting(step):
    """Count the prologues and keep the carries a pipelined step makes."""
    seen = {"prologues": 0, "carries": []}
    prologue, body = step._pipeline_prologue, step._pipeline_body

    def counted_prologue(fields):
        seen["prologues"] += 1
        carry = prologue(fields)
        seen["carries"].append(carry)
        return carry

    def kept_body(fields, carry, post_next=True):
        out, nxt = body(fields, carry, post_next=post_next)
        if nxt is not None:
            seen["carries"].append(nxt)
        return out, nxt

    step._pipeline_prologue = counted_prologue
    step._pipeline_body = kept_body
    return seen


def test_pipeline_chunked_run_reseeds_carry():
    """run_simulation's log-cadence chunks build one runner a chunk: each
    chunk reseeds the carry (three prologues for 2+2+1 passes), a chunk's
    last pass posts no exchange (5 exchanges for 5 passes), and the values
    equal one unchunked run; every carry posted was awaited."""
    st, mesh, plain, pipe = _pair("heat3d", (32, 16, 64), (2,), 4,
                                  "padfree", overlap=True)
    arrays = _arrays(st, (32, 16, 64))
    seen = _counting(pipe)
    calls = []
    chunked = tdriver.run_simulation(
        st, _sharded(st, arrays, mesh), 5, step_fn=pipe, log_every=2,
        callback=lambda done, fs: calls.append(done))
    assert calls == [2, 4, 5] and seen["prologues"] == 3
    assert len(seen["carries"]) == 5
    assert all(c.keep == () and all(p._done for p in c.pending)
               for c in seen["carries"])
    unchunked = tdriver.run_simulation(st, _sharded(st, arrays, mesh), 5,
                                       step_fn=plain)
    _equal(chunked, unchunked)


def test_pipeline_run_until_threads_carry():
    """--tol's loop seeds the carry once a run and threads it through
    every residual check; the converged state, steps and residual equal
    the per-pass stepper's."""
    st, mesh, plain, pipe = _pair("heat3d", (32, 16, 64), (2,), 4,
                                  "padfree", overlap=True)
    arrays = _arrays(st, (32, 16, 64))
    seen = _counting(pipe)
    checks = []
    out_p, n_p, res_p = tdriver.run_until(
        pipe, _sharded(st, arrays, mesh), tol=0.0, max_steps=3,
        check_every=2, boundary=checks.append)
    out_r, n_r, res_r = tdriver.run_until(
        plain, _sharded(st, arrays, mesh), tol=0.0, max_steps=3,
        check_every=2)
    # one prologue, a posted exchange from every pass, the last dropped
    assert seen["prologues"] == 1 and checks == [2, 3]
    assert len(seen["carries"]) == 4
    assert n_p == n_r == 3 and res_p == res_r
    assert all(c.keep == () for c in seen["carries"])
    _equal(out_p, out_r)


def test_overlap_fallback_keeps_the_pipeline():
    """A local extent below 3m declines the split; the pipeline stays
    active on the non-split body, bit-equal to the per-pass step."""
    st, mesh, plain, pipe = _pair("heat3d", (16, 16, 128), (2, 2), 4,
                                  "padfree", overlap=False)
    over = tstepper.make_sharded_fused_step(st, mesh, (16, 16, 128), 4,
                                            kind="padfree", overlap=True,
                                            pipeline=True)
    assert over._pipeline_active and not over._overlap_active
    arrays = _arrays(st, (16, 16, 128))
    _equal(_run(over, st, arrays, mesh, PASSES),
           _run(plain, st, arrays, mesh, PASSES))


# ---- refusals, with the JAX package's reasons ------------------------------

def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kind", ["padfree", "stream"])
def test_pipeline_periodic_refused_like_jax(kind):
    """Guard-frame only: the wrap slabs of an unsharded axis come from the
    spliced output, an interior dependency."""
    st, jst = port.make_stencil("heat3d"), jmake_stencil("heat3d")
    got = _message(lambda: tstepper.make_sharded_fused_step(
        st, _mesh((2,)), (32, 16, 64), 4, kind=kind, periodic=True,
        pipeline=True))
    want = _message(lambda: jstepper.make_sharded_fused_step(
        jst, jmesh.make_mesh((2, 1, 1)), (32, 16, 64), 4, interpret=True,
        kind=kind, periodic=True, pipeline=True))
    assert got == want and "guard-frame only" in got


def test_pipeline_padded_kind_refused_like_jax():
    """The exchange-padded kernel has no slab operands for the carry."""
    got = _message(lambda: tstepper.make_sharded_fused_step(
        port.make_stencil("heat3d"), _mesh((2, 2)), (32, 32, 64), 4,
        pipeline=True))
    want = _message(lambda: jstepper.make_sharded_fused_step(
        jmake_stencil("heat3d"), jmesh.make_mesh((2, 2, 1)), (32, 32, 64),
        4, interpret=True, padfree=False, pipeline=True))
    assert got == want and "rides the slab-operand kinds" in got


def test_pipeline_2d_refused_like_jax():
    got = _message(lambda: tstepper.make_sharded_temporal_step(
        port.make_stencil("heat2d"), _mesh((2,)), (64, 128), 8,
        pipeline=True))
    want = _message(lambda: jstepper.make_sharded_temporal_step(
        jmake_stencil("heat2d"), jmesh.make_mesh((2, 1)), (64, 128), 8,
        interpret=True, pipeline=True))
    assert got == want and "3D-only" in got


@pytest.mark.parametrize("kind", ["padfree", "stream"])
def test_pipeline_untileable_shape_gives_none(kind):
    """A local block below the k-step margin: no slab-operand kernel tiles
    it, the builder returns None (the CLI then raises naming --pipeline),
    and nothing falls back to the plain step."""
    assert tstepper.make_sharded_fused_step(
        port.make_stencil("heat3d"), _mesh((4,)), (16, 16, 128), 8,
        kind=kind, pipeline=True) is None
    assert jstepper.make_sharded_fused_step(
        jmake_stencil("heat3d"), jmesh.make_mesh((4, 1, 1)), (16, 16, 128),
        8, interpret=True, kind=kind, pipeline=True) is None


# ---- the sender-side border exchanges --------------------------------------

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_slabs_from_borders_equal_the_block_exchange(axis, periodic):
    """Given each shard's first and last m rows, the exchange returns what
    the exchange of the blocks returns, bit for bit."""
    mesh, m = _mesh((2, 2)), 3
    blocks = [torch.randn(8, 8, 16, generator=torch.Generator().manual_seed(
        i)) for i in range(4)]
    lo = [b.narrow(axis, 0, m) for b in blocks]
    hi = [b.narrow(axis, b.shape[axis] - m, m) for b in blocks]
    got = thalo.post_slabs_from_borders(lo, hi, mesh, axis, m, 0.5,
                                        periodic).wait()
    want = thalo.exchange_slabs_axis(blocks, mesh, axis, m, 0.5, periodic)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 2), (2,)])
def test_slabs_2axis_from_borders_equal_the_block_exchange(mesh_shape):
    """The 2-axis set (z and y slabs, corners by the two-pass composition)
    from border rows equals the exchange of the blocks."""
    mesh, m = _mesh(mesh_shape), 2
    blocks = [torch.randn(8, 8, 16, generator=torch.Generator().manual_seed(
        i)) for i in range(mesh.size)]
    rows = [([b[:m] for b in blocks], [b[-m:] for b in blocks]),
            ([b[:, :m] for b in blocks], [b[:, -m:] for b in blocks])]
    got = thalo.post_slabs_2axis_from_borders(
        *rows[0], *rows[1], mesh, m, 0.0).wait()
    want = thalo.exchange_slabs_2axis(blocks, mesh, m, 0.0)
    assert len(got) == len(want) == mesh.size
    for g, w in zip(got, want):
        pieces = [*g[0], *g[1], *g[2]], [*w[0], *w[1], *w[2]]
        assert len(pieces[0]) == 8
        for x, y in zip(*pieces):
            assert torch.equal(x, y)


def test_border_rows_of_the_wrong_depth_raise():
    mesh = _mesh((2,))
    blocks = [torch.zeros(8, 4, 4)] * 2
    with pytest.raises(ValueError, match="not 2 deep"):
        thalo.post_slabs_from_borders([b[:3] for b in blocks],
                                      [b[-2:] for b in blocks], mesh, 0, 2,
                                      0.0)


# ---- the CLI ----------------------------------------------------------------

_CLI = ["--stencil", "heat3d", "--grid", "32,32,64", "--iters", "12",
        "--init", "pulse", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree"],
    ["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree", "--overlap"],
    ["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
     "--exchange", "rdma"],
    ["--mesh", "2", "--fuse", "4", "--fuse-kind", "stream"],
], ids=["padfree", "padfree_overlap", "stream_overlap_rdma", "stream_z"])
def test_cli_pipeline_equals_per_pass_run(monkeypatch, flags):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    got, _ = tcli.run(tcli.config_from_args(_CLI + flags + ["--pipeline",
                                                            "--log-every",
                                                            "4"]))
    ref, _ = tcli.run(tcli.config_from_args(_CLI + flags))
    _equal(got, ref)


@pytest.mark.parametrize("flags,words", [
    ([], "requires an explicit --fuse K"),
    (["--fuse", "4"], "--pipeline needs --mesh"),
    (["--fuse", "4", "--mesh", "2,2"], "rides the slab-operand kinds"),
    (["--fuse", "4", "--mesh", "2,2", "--fuse-kind", "padfree",
      "--periodic"], "guard-frame only"),
], ids=["no_fuse", "no_mesh", "padded_kind", "periodic"])
def test_cli_pipeline_refusals_match_jax(monkeypatch, flags, words):
    """Every combination the JAX CLI refuses, refused in the port with its
    words, before any field is built."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    argv = ["--stencil", "heat3d", "--grid", "32,32,64", "--iters", "4",
            "--pipeline", *flags]
    with pytest.raises(ValueError, match=words):
        tcli.main(argv + ["--device", "cpu"])
    with pytest.raises(ValueError, match=words):
        jcli.main(argv)


def test_cli_untileable_pipeline_names_it(monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    with pytest.raises(ValueError, match="--fuse-kind padfree --pipeline "
                                         "unsupported"):
        tcli.main(["--stencil", "heat3d", "--grid", "16,16,128", "--iters",
                   "8", "--mesh", "4", "--fuse", "8", "--fuse-kind",
                   "padfree", "--pipeline", "--device", "cpu"])


def test_cli_overlap_fallback_warns_the_pipeline_stays(monkeypatch, caplog):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    with caplog.at_level(logging.WARNING, "mpi_cuda_process_tpu_torch"):
        tcli.run(tcli.config_from_args(
            ["--stencil", "heat3d", "--grid", "16,16,128", "--iters", "4",
             "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
             "--overlap", "--pipeline", "--device", "cpu"]))
    assert "the slab-carry pipeline stays active on the non-split body" \
        in caplog.text


# ---- the budget -------------------------------------------------------------

def test_budget_prices_the_carried_slabs():
    """pipeline adds one carried slab set (the JAX package's term, same
    bytes on a z-only mesh); the port keeps it under rdma (its ring's
    received slabs are device buffers); with overlap the carry is the
    2-axis set plus the held shell outputs."""
    st = port.make_stencil("heat3d")
    grid, m = (64, 64, 128), 4

    def carry(**kw):
        _, parts = tbudget.estimate_run_bytes(st, grid, fuse=4,
                                              pipeline=True, **kw)
        got = [b for label, b in parts if label.startswith("pipelined")]
        assert len(got) == 1
        return got[0]

    lz, ly, lx = 16, 64, 128
    zset = 2 * m * ly * lx * 4
    assert carry(mesh=(4,), fuse_kind="padfree") == zset
    _, jparts = jbudget.estimate_run_bytes(
        jmake_stencil("heat3d"), grid, mesh=(4,), fuse=4,
        fuse_kind="padfree", pipeline=True)
    assert [b for label, b in jparts if label.startswith("pipelined")] == \
        [zset]
    assert carry(mesh=(4,), fuse_kind="stream", exchange="rdma") == zset
    two_axis = 2 * m * ly * lx + 2 * m * lz * lx + 4 * m * m * lx
    shells = 2 * 2 * m * ly * lx
    assert carry(mesh=(4,), fuse_kind="padfree", overlap=True) == \
        (two_axis + shells) * 4
