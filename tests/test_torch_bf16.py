"""bfloat16 through the port: the plain step, the raw-step and streaming
kernels' plain versions, BASELINE config 5's command, the ring exchange,
checkpoints and the device-memory budget (``--mem-check``), against the
JAX package.

Inputs are uniform [0, 1) float32 arrays made with numpy from a seed and
cast to bfloat16 in both packages.  The JAX kernels run as its own tests
run them (``interpret=True``; its sharded steps on the 8 virtual CPU
devices of tests/conftest.py); the port's wrappers take their plain
versions for CPU tensors (tests/test_torch_cuda.py holds the kernels to
them on the card, bit for bit).

Tolerance against JAX: the reference's own bfloat16 tolerance,
``32 eps max(|ref|, 1)`` with eps = 2**-7 (tests/test_rawstep.py:43-48):
the two frameworks round the tap sums in a different order.  Frame cells
are equal.  Within the port, sharded equals unsharded bit for bit, and
config 5's command is held to the port's plain run at ``atol = 1e-3`` as
tests/test_cli.py:413-431 holds the JAX one.
"""

import logging
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import rawstep as jrawstep
from mpi_cuda_process_tpu.ops.pallas import streamfused as jstream
from mpi_cuda_process_tpu.utils import budget as jbudget
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

EPS = 2.0 ** -7  # bfloat16
BF16 = "bfloat16"


def _seeded(n, shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(shape, dtype=np.float32) for _ in range(n))


def _jax(arrays):
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays)


def _port(arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


def _f32(fields):
    return [np.asarray(f, dtype=np.float32) if not isinstance(f, torch.Tensor)
            else f.float().numpy() for f in fields]


def _close(got, ref, halo=None):
    """32 eps max(|ref|, 1) (the reference's bf16 tolerance); frame cells
    (``halo`` wide) equal."""
    got, ref = _f32(got), _f32(ref)
    scale = max(float(np.abs(ref[0]).max()), 1.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=32 * EPS * scale)
        if halo:
            frame = tdriver.frame_mask(r.shape, r.shape, (0,) * r.ndim, halo,
                                       device="cpu").numpy()
            np.testing.assert_array_equal(g[frame], r[frame])


def _bits(arrays):
    return [np.asarray(a).view(np.uint16) for a in arrays]


# ---- C2: the plain bfloat16 step against JAX ---------------------------------

FAMILIES_3D = ["heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
               "grayscott3d", "sor3d"]
FAMILIES_2D = ["heat2d", "mdf", "wave2d", "advect2d", "grayscott2d", "sor2d"]


@pytest.mark.parametrize("name", FAMILIES_3D + FAMILIES_2D)
def test_plain_bf16_step_matches_jax(name):
    """ROADMAP C2: the port's driver.make_step == the JAX package's, eight
    bfloat16 steps from uniform fields, at 32 eps max(|ref|, 1), frame
    cells equal."""
    grid = (16, 20) if name in FAMILIES_2D else (10, 12, 14)
    jst = jmake_stencil(name, dtype=jnp.bfloat16)
    st = port.make_stencil(name, dtype=BF16)
    arrays = _seeded(st.num_fields, grid, 11)
    jf, tf = _jax(arrays), _port(arrays)
    jstep, tstep = jdriver.make_step(jst, grid), tdriver.make_step(st, grid)
    for _ in range(8):
        jf, tf = jstep(jf), tstep(tf)
    assert all(f.dtype == torch.bfloat16 for f in tf)
    _close(tf, jf, st.halo)


# ---- rows 1-4: the raw step's plain version against JAX make_raw_step --------

RAW_CASES = [("heat3d", (8, 10, 12), {}), ("heat3d27", (16, 12, 14), {}),
             ("heat3d4th", (16, 14, 130), {}), ("wave3d", (16, 18, 12), {}),
             ("advect3d", (16, 10, 12), {"cx": 0.3, "cy": -0.2, "cz": 0.25}),
             ("grayscott3d", (16, 12, 130), {})]


@pytest.mark.parametrize("name,grid,kw", RAW_CASES,
                         ids=[n for n, _, _ in RAW_CASES])
def test_raw_step_bf16_matches_jax(name, grid, kw):
    """make_raw_step in bfloat16 (its plain version on CPU tensors) == the
    JAX package's make_raw_step(interpret=True), four steps, at the
    reference's 32 eps scale, frame cells equal (tests/test_rawstep.py)."""
    jraw = jrawstep.make_raw_step(jmake_stencil(name, dtype=jnp.bfloat16,
                                                **kw), grid, interpret=True)
    st = port.make_stencil(name, dtype=BF16, **kw)
    traw = trawstep.make_raw_step(st, grid)
    assert jraw is not None and traw is not None
    arrays = _seeded(st.num_fields, grid, 21)
    jf, tf = _jax(arrays), _port(arrays)
    trawstep.launches.clear()
    for _ in range(4):
        jf, tf = jraw(jf), traw(tf)
    assert not trawstep.launches  # CPU tensors never launch
    _close(tf, jf, st.halo)


# ---- rows 16-18: K10's plain versions against the JAX streaming builders -----

STREAM_FAMILIES = [("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                   ("wave3d", 4), ("advect3d", 4), ("grayscott3d", 4),
                   ("sor3d", 2)]


@pytest.mark.parametrize("name,k", STREAM_FAMILIES)
def test_stream_step_bf16_matches_jax(name, k):
    """Row 16 in bfloat16: make_stream_fused_step == the JAX package's
    (interpret), one pass."""
    grid = (24, 48, 128)  # bf16 strips: y in multiples of 16
    st = port.make_stencil(name, dtype=BF16)
    jstep = jstream.make_stream_fused_step(
        jmake_stencil(name, dtype=jnp.bfloat16), grid, k, interpret=True)
    assert jstep is not None
    arrays = _seeded(st.num_fields, grid, 31)
    tf = tstream.make_stream_fused_step(st, grid, k)(_port(arrays))
    _close(tf, jstep(_jax(arrays)), st.halo)


@pytest.mark.parametrize("name,k", [("heat3d", 4), ("wave3d", 4),
                                    ("grayscott3d", 4), ("sor3d", 2)])
def test_stream_sharded_calls_bf16_match_jax(name, k):
    """Rows 17 and 18 in bfloat16: build_stream_sharded_call (the interior
    shard of a z column of three) and build_stream_2axis_call (the
    interior shard of a 3x3 grid of shards) == the JAX package's on the
    same pieces."""
    st = port.make_stencil(name, dtype=BF16)
    jst = jmake_stencil(name, dtype=jnp.bfloat16)
    m = k_step_margin(st, k)
    nf = st.num_fields
    local = (24, 48, 128)
    gshape = (3 * local[0],) + local[1:]
    shapes = (local, (m,) + local[1:], (m,) + local[1:])
    rng = np.random.default_rng(41)
    arrays = [rng.random(s, dtype=np.float32) for _ in range(nf)
              for s in shapes]
    jcall = jstream.build_stream_sharded_call(jst, local, gshape, k,
                                              interpret=True)[0]
    ref = jcall(jnp.array([local[0], 0], dtype=jnp.int32), *_jax(arrays))
    call, _, _ = tstream.build_stream_sharded_call(st, local, gshape, k)
    _close(call(local[0], *_port(arrays)), ref)
    Lz, Ly, X = local = (24, 16, 128)
    gshape = (3 * Lz, 3 * Ly, X)
    shapes = (local, (m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X),
              (m, m, X), (m, m, X), (m, m, X), (m, m, X))
    rng = np.random.default_rng(43)
    arrays = [rng.random(s, dtype=np.float32) for _ in range(nf)
              for s in shapes]
    jcall = jstream.build_stream_2axis_call(jst, local, gshape, k,
                                            interpret=True)[0]
    ref = jcall(jnp.array([Lz, Ly], dtype=jnp.int32), *_jax(arrays))
    call, _, _ = tstream.build_stream_2axis_call(st, local, gshape, k)
    _close(call((Lz, Ly), *_port(arrays)), ref)


# ---- BASELINE config 5's command ---------------------------------------------

CONFIG5 = ["--stencil", "wave3d", "--grid", "192,64,128", "--iters", "8",
           "--mesh", "8,1,1", "--fuse", "4", "--fuse-kind", "stream",
           "--dtype", "bfloat16", "--mem-check", "error"]


def test_config5_command_on_8_shards(tmp_path, monkeypatch):
    """tests/test_cli.py:413-431's rehearsal line through the port's CLI on
    8 virtual shards: K10's z-slab kind (the plain version here), equal to
    the port's plain unsharded bfloat16 run at atol 1e-3 (the JAX test's
    pin) and to the JAX CLI's own line at the bf16 tolerance; the sharded
    and unsharded stream runs equal bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    cfg = tcli.config_from_args(CONFIG5 + ["--device", "cpu"])
    assert cfg.mem_check == "error" and cfg.dtype == BF16
    st, step_fn, _, _ = tcli.build(cfg)
    assert step_fn._padfree_kind == "stream_z"
    tstream.launches.clear()
    got, mcells = tcli.run(cfg)
    assert mcells > 0 and not tstream.launches
    got = tstepper.gather_fields(got)
    assert got[0].dtype == torch.bfloat16
    plain, _ = tcli.run(tcli.config_from_args(
        ["--stencil", "wave3d", "--grid", "192,64,128", "--iters", "8",
         "--dtype", "bfloat16", "--device", "cpu"]))
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.float().numpy(), p.float().numpy(),
                                   rtol=0, atol=1e-3)
    whole, _ = tcli.run(tcli.config_from_args(
        ["--stencil", "wave3d", "--grid", "192,64,128", "--iters", "8",
         "--fuse", "4", "--fuse-kind", "stream", "--dtype", "bfloat16",
         "--device", "cpu"]))
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    jdir = str(tmp_path / "jax")
    assert jcli.main(CONFIG5 + ["--checkpoint-dir", jdir,
                                "--checkpoint-every", "8"]) == 0
    jf, jstep, _ = jckpt.load_checkpoint(jdir)
    assert jstep == 8
    jf = [np.asarray(a).view(jnp.bfloat16) for a in jf]
    _close(got, jf, 1)


# ---- the ring exchange and checkpoints in bfloat16 ---------------------------

RDMA_BASE = ["--grid", "48,32,128", "--iters", "8", "--fuse", "4",
             "--fuse-kind", "stream", "--dtype", "bfloat16", "--device",
             "cpu"]


@pytest.mark.parametrize("mesh", ["2,2", "4"])
@pytest.mark.parametrize("name", ["wave3d", "grayscott3d"])
def test_rdma_bf16_equals_ppermute(monkeypatch, caplog, name, mesh):
    """--exchange rdma on bfloat16 fields (the ring's plain version walks
    its protocol on the bfloat16 slabs) == --exchange ppermute, bit for
    bit, on --mesh 2,2 and --mesh 4."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--mesh", mesh, *RDMA_BASE]
    outs = []
    for exchange in ("ppermute", "rdma"):
        with caplog.at_level(logging.INFO):
            got, _ = tcli.run(tcli.config_from_args(
                args + ["--exchange", exchange]))
        outs.append(tstepper.gather_fields(got))
    assert "exchange: mode=rdma backend=plain-ring" in caplog.text
    for a, b in zip(*outs):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("mesh", [[], ["--mesh", "4"]], ids=["whole",
                                                             "mesh4"])
def test_bf16_stream_checkpoint_resumes_mid_run(tmp_path, monkeypatch, mesh):
    """4 stream steps + a bfloat16 checkpoint, resumed to 8, == 8
    uninterrupted stream steps, bit for bit, unsharded and on --mesh 4."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    d, ref = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--stencil", "wave3d", "--grid", "48,32,128", "--fuse", "4",
            "--fuse-kind", "stream", "--dtype", "bfloat16", "--init",
            "random", "--checkpoint-every", "4", "--device", "cpu", *mesh]
    assert tcli.main(args + ["--iters", "4", "--checkpoint-dir", d]) == 0
    assert tcli.main(args + ["--iters", "8", "--checkpoint-dir", d,
                             "--resume"]) == 0
    assert tcli.main(args + ["--iters", "8", "--checkpoint-dir", ref]) == 0
    a, sa, ca = tckpt.load_checkpoint(d)
    b, sb, _ = tckpt.load_checkpoint(ref)
    assert sa == sb == 8 and ca["dtype"] == BF16
    for x, y in zip(_bits(a), _bits(b)):
        np.testing.assert_array_equal(x, y)


# ---- utils/budget.py against the JAX package's -------------------------------

GiB = 2 ** 30
# TPU-only terms of the JAX budget that the port's estimate drops (its
# module docstring lists them): each case below names the one it meets.
TPU_ONLY = {
    "wm_a": "the sublane-aligned (wm_a) copies of the 2-axis streaming "
            "call's y-facing operands",
    "dup_y": "the 2m-duplicated y slabs and corners of the 2-axis pad-free "
             "call",
    "fullgrid_pad": "the padded transient of the unsharded 2D k-step kernel",
    "rdma_vmem": "the rdma slab deletion: the TPU ring stages its chunks in "
                 "VMEM (ring_vmem_bytes)",
    "vmem_probes": "the VMEM strip probes that label a shape UNBUILDABLE",
    "fused_pad": "the padded transient of the unsharded fused kind below "
                 "the TPU's pad-free threshold",
}


def _item(dt):
    return 2 if dt == BF16 else 4


def _case(name, dt, grid, mesh=(), fuse=0, kind="auto", compute="auto",
          exchange="ppermute", periodic=False, dropped=None, added=0):
    return (name, dt, tuple(grid), tuple(mesh), fuse, kind, compute,
            exchange, periodic, dropped, added)


def _wave5(dt, mesh):
    """(field bytes, m, local) of config 5's wave3d shard on ``mesh``."""
    local = tuple(4096 // c for c in mesh)
    return np.prod(local) * _item(dt), 4, local


def _config5_cases():
    cases = []
    for dt in (BF16, "float32"):
        fb, m, (lz, ly, lx) = _wave5(dt, (64, 1, 1))
        for kind in ("stream", "padfree"):
            # port: the k-step kernels write u_prev anew too (+1 field)
            cases.append(_case("wave3d", dt, (4096,) * 3, (64, 1, 1), 4,
                               kind, added=fb))
        fb, m, (lz, ly, lx) = _wave5(dt, (8, 8, 1))
        m_a = -(-m // (16 if dt == BF16 else 8)) * (16 if dt == BF16 else 8)
        cases.append(_case(
            "wave3d", dt, (4096,) * 3, (8, 8, 1), 4, "stream", added=fb,
            dropped=("wm_a", (2 * m_a * lz * lx + 4 * m * m_a * lx)
                     * _item(dt) * 2)))
    fb, m, (lz, ly, lx) = _wave5("float32", (8, 8, 1))
    cases.append(_case("wave3d", "float32", (4096,) * 3, (8, 8, 1), 4,
                       "padfree", added=fb,
                       dropped=("dup_y", (2 * m * lz * lx + 4 * m * m * lx)
                                * 4 * 2)))
    # config 5's one-card share: four shards of it (--grid 256,4096,4096
    # --mesh 4,1,1), each priced as one
    fb, m, _ = _wave5(BF16, (64, 1, 1))
    cases.append(_case("wave3d", BF16, (256, 4096, 4096), (4, 1, 1), 4,
                       "stream", added=fb))
    return cases


BUDGET_CASES = _config5_cases() + [
    _case("heat3d", BF16, (4096,) * 3, (64, 1, 1), 4, "stream"),
    _case("heat3d", "float32", (1024,) * 3, fuse=4),  # test_budget.py:86
    _case("heat3d27", "float32", (1152,) * 3, compute="raw"),  # :120
    # the one-step path: the port keeps the update's output beside its
    # re-pinned copy and a bool frame mask (1 B a cell)
    _case("heat3d", "float32", (1024,) * 3, added=1024 ** 3 * (4 + 1)),
    _case("heat3d", "float32", (512,) * 3, (2, 2, 2),
          added=256 ** 3 * (4 + 1)),
    _case("heat3d", "float32", (256,) * 3, (2, 2, 1), 4),
    _case("heat3d", BF16, (256, 256, 512), (), 4, "stream"),
    _case("heat3d", "float32", (64, 64, 128), (), 4, "stream",
          periodic=True),
    _case("heat3d", BF16, (4096,) * 3, (64, 1, 1), 4, "stream",
          exchange="rdma", dropped=("rdma_vmem", 0),
          # the received z slabs (the ring lands chunks in place: no
          # receive rings)
          added=2 * 4 * 4096 * 4096 * 2),
    _case("heat2d", "float32", (4096, 4096), (), 8,
          dropped=("fullgrid_pad", (4096 + 16) * 4096 * 4)),
    _case("grayscott3d", "float32", (512,) * 3, compute="raw",
          added=512 ** 3 * 4),  # both fields written
    # the bfloat16 padded and pad-free kinds of K3, K6 and K9 (k = 8)
    _case("heat3d", BF16, (1024,) * 3, (2, 2, 1), 8),
    _case("heat3d", BF16, (1024,) * 3, (4, 1, 1), 8, "padfree"),
    _case("wave3d", BF16, (1024,) * 3, (2, 2, 1), 8, added=512 ** 2 * 1024 * 2),
    _case("grayscott3d", BF16, (512,) * 3, (4, 1, 1), 8, "padfree",
          added=128 * 512 * 512 * 2),
]


def _subtotal(parts):
    return sum(b for label, b in parts if not label.startswith("workspace"))


@pytest.mark.parametrize("case", BUDGET_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'x'.join(map(str, c[2]))}-"
                              f"{'x'.join(map(str, c[3])) or 'whole'}-"
                              f"f{c[4]}-{c[5]}-{c[6]}-{c[7]}"
                              f"{'-periodic' if c[8] else ''}"
                              for c in BUDGET_CASES])
def test_budget_totals_match_jax(case):
    """The port's estimate_run_bytes == the JAX package's on the same
    config, term for term, but for the named TPU-only terms the port drops
    and the port-only terms it adds (labelled "port:"); with neither, the
    totals are equal."""
    (name, dt, grid, mesh, fuse, kind, compute, exchange, periodic,
     dropped, added) = case
    kw = dict(mesh=mesh, fuse=fuse, fuse_kind=kind, compute=compute,
              exchange=exchange, periodic=periodic)
    jt, jp = jbudget.estimate_run_bytes(jmake_stencil(name, dtype=dt), grid,
                                        **kw)
    tt, tp = tbudget.estimate_run_bytes(port.make_stencil(name, dtype=dt),
                                        grid, **kw)
    assert tt == sum(b for _, b in tp) and jt == sum(b for _, b in jp)
    dropped_b = 0
    if dropped:
        assert dropped[0] in TPU_ONLY
        dropped_b = dropped[1]
    port_only = sum(b for label, b in tp if "port:" in label)
    if exchange != "rdma":
        assert port_only == added
    assert _subtotal(tp) - _subtotal(jp) == added - dropped_b
    if not dropped and not added:
        assert tt == jt
    # the same verdict on what builds
    assert any("UNBUILDABLE" in lb for lb, _ in jp) == \
        any("UNBUILDABLE" in lb for lb, _ in tp)


@pytest.mark.parametrize("dt", [BF16, "float32"])
@pytest.mark.parametrize("grid,mesh", [((256, 4096, 4096), (4, 1, 1)),
                                       ((1024,) * 3, (2, 2, 1))])
def test_budget_rdma_prices_received_slabs_not_rings(dt, grid, mesh):
    """--exchange rdma costs what ppermute costs: the received slabs (the
    slab term, z slabs, y slabs and corners at width m) and no receive
    ring, since the ring lands every chunk in place."""
    st = port.make_stencil("heat3d", dtype=dt)
    kw = dict(mesh=mesh, fuse=4, fuse_kind="stream", shards_per_device=4)
    rt, rp = tbudget.estimate_run_bytes(st, grid, exchange="rdma", **kw)
    pt, pp = tbudget.estimate_run_bytes(st, grid, exchange="ppermute", **kw)
    assert rt == pt and rp == pp
    assert not any("ring" in label for label, _ in rp)
    local = [g // c for g, c in zip(grid, mesh)]
    lz, ly, lx = local
    m = 4
    slab = 2 * m * ly * lx if mesh[1] == 1 else \
        2 * m * ly * lx + 2 * m * lz * lx + 4 * m * m * lx
    slab_terms = [b for label, b in rp if label.startswith("sharded stream")]
    assert slab_terms == [slab * _item(dt)]


def test_budget_drops_the_tpu_only_functions_and_refuses_unported():
    """ring_vmem_bytes (VMEM) is not in the port; the coupled-run budget
    (device groups, A7) is (tests/test_torch_groups.py); ensemble (A7) is
    priced by the members a shard holds; pipeline adds the carried slab
    set (the JAX package's term: one slab set)."""
    assert hasattr(jbudget, "ring_vmem_bytes")
    assert not hasattr(tbudget, "ring_vmem_bytes")
    for fn in ("estimate_coupled_bytes", "check_coupled_budget"):
        assert hasattr(jbudget, fn) and hasattr(tbudget, fn)
    assert tbudget._OVERHEAD_FRAC == jbudget._OVERHEAD_FRAC == 0.10
    st = port.make_stencil("heat3d")
    one, _ = tbudget.estimate_run_bytes(st, (64,) * 3)
    two, _ = tbudget.estimate_run_bytes(st, (64,) * 3, ensemble=2)
    assert 1.9 * one < two < 2 * one
    # a z-only mesh: the z slabs are the same set in both packages (the
    # 2-axis set differs by the TPU-only y duplication, dropped above)
    kw = dict(mesh=(4,), fuse=4, fuse_kind="padfree")
    grid = (64, 64, 128)
    plain, _ = tbudget.estimate_run_bytes(st, grid, **kw)
    piped, parts = tbudget.estimate_run_bytes(st, grid, pipeline=True, **kw)
    _, jparts = jbudget.estimate_run_bytes(jmake_stencil("heat3d"), grid,
                                           pipeline=True, **kw)
    carry = [b for label, b in parts if label.startswith("pipelined")]
    jcarry = [b for label, b in jparts if label.startswith("pipelined")]
    assert carry == jcarry and len(carry) == 1 and carry[0] > 0
    assert piped == plain + carry[0] + int(carry[0] * tbudget._OVERHEAD_FRAC)


def test_budget_counts_every_shard_on_the_card():
    """shards_per_device: four virtual shards on one card cost four
    shards' bytes (config 5's one-card share: ~37 GiB in bfloat16)."""
    st = port.make_stencil("wave3d", dtype=BF16)
    one, _ = tbudget.estimate_run_bytes(st, (256, 4096, 4096), (4, 1, 1), 4,
                                        fuse_kind="stream")
    four, parts = tbudget.estimate_run_bytes(
        st, (256, 4096, 4096), (4, 1, 1), 4, fuse_kind="stream",
        shards_per_device=4)
    assert any("3 more shard(s)" in label for label, _ in parts)
    assert abs(four - 4 * one) <= 4  # the overhead's rounding
    assert 36 * GiB < four < 38 * GiB


def test_mem_check_error_refuses_with_the_arithmetic():
    """check_budget raises ValueError with the itemised arithmetic when the
    run cannot fit the card's memory."""
    st = port.make_stencil("wave3d")
    with pytest.raises(ValueError) as e:
        tbudget.check_budget(st, (4096,) * 3, mesh=(8, 8, 1),
                             hbm_bytes=16 * GiB)
    msg = str(e.value)
    assert "GiB per device" in msg and "state: 2 field(s)" in msg
    assert "bfloat16" in msg and "--mem-check warn" in msg
    total, _ = tbudget.check_budget(st, (64,) * 3, hbm_bytes=16 * GiB)
    assert total < GiB


def test_cli_mem_check_parses_is_skipped_on_cpu_and_refuses_on_a_card(
        monkeypatch, caplog):
    """--mem-check registers with the JAX CLI's choices and default; on the
    CPU the guard is skipped (a CPU run never asks for a card's memory);
    on a card it refuses in build() before any field is allocated (error)
    or logs and goes on (warn)."""
    assert tcli.config_from_args([]).mem_check == "error"
    with pytest.raises(SystemExit):
        tcli.config_from_args(["--mem-check", "maybe"])

    def no_card(device=None):
        raise AssertionError("the CPU run asked for a card's memory")

    monkeypatch.setattr(tbudget, "device_hbm_bytes", no_card)
    cfg = tcli.config_from_args(["--stencil", "wave3d", "--grid",
                                 "4096,4096,4096", "--device", "cpu"])
    tcli._check_mem_budget(cfg, port.make_stencil("wave3d"), None)

    # a "card" of 1 MiB: the check runs where the device is cuda
    monkeypatch.setattr(tbudget, "device_hbm_bytes", lambda device=None: 2**20)
    monkeypatch.setattr(tcli, "_device", lambda cfg: torch.device("cpu"))

    def no_init(*a, **k):
        raise AssertionError("a field was allocated before the check")

    monkeypatch.setattr(tcli, "init_state", no_init)
    args = ["--stencil", "heat3d", "--grid", "64,64,64", "--iters", "2"]
    with pytest.raises(ValueError, match="raw whole-step kernel"):
        tcli.build(tcli.config_from_args(args + ["--compute", "pallas"]))
    # the default --compute auto takes heat3d's raw kernel on a card (the
    # dispatch tables) and is priced for it; the plain path has the pad
    with pytest.raises(ValueError, match="raw whole-step kernel"):
        tcli.build(tcli.config_from_args(args))
    plain = args + ["--compute", "jnp"]
    with pytest.raises(ValueError, match=r"pad transient \(\+2 per axis"):
        tcli.build(tcli.config_from_args(plain))
    with caplog.at_level(logging.WARNING):
        with pytest.raises(AssertionError, match="allocated"):
            tcli.build(tcli.config_from_args(plain + ["--mem-check",
                                                      "warn"]))
    assert "--mem-check warn" in caplog.text
    with pytest.raises(AssertionError, match="allocated"):
        tcli.build(tcli.config_from_args(plain + ["--mem-check", "off"]))


# ---- the kernel paths that still refuse bfloat16, each by its own item --------

# The JAX CLI's refusal of a --fuse k off the dtype's alignment unit
# (cli.py:964-969 there), and the port's sharded one.
SUBLANE = "sublane tile — 8 for f32, 16 for bf16"
SHARDED_SUBLANE = r"sublane tile \(8 for f32, 16 for bf16\)"
# The flags (each with its value) that pick a kernel or a mesh.
KERNEL_FLAGS = ("--mesh", "--fuse", "--fuse-kind", "--compute")


@pytest.mark.parametrize("extra,exc,match", [
    # The first five ids keep their names from the refusals they pinned
    # before K3, its shells, K6 and K9 took bfloat16 (ROADMAP B3, B4):
    # --fuse 4 is now off bfloat16's alignment unit (2*k*halo a multiple
    # of 16: k = 8 runs), so the unsharded kinds meet the JAX CLI's own
    # refusal and the sharded ones the port's; the stream kind's --overlap
    # runs, falling back to the non-split step (its K3 shells would have
    # m = 4), equal to the plain run bit for bit.
    pytest.param(["--fuse", "4"], ValueError, SUBLANE,
                 id="extra0-ROADMAP B3"),
    pytest.param(["--fuse", "4", "--fuse-kind", "tiled"], ValueError,
                 SUBLANE, id="extra1-ROADMAP B3"),
    pytest.param(["--mesh", "2,2", "--fuse", "4"], ValueError,
                 SHARDED_SUBLANE, id="extra2-ROADMAP B3"),
    pytest.param(["--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
                  "--overlap"], None, None, id="extra3-ROADMAP B3"),
    pytest.param(["--mesh", "4", "--fuse", "4", "--fuse-kind", "padfree"],
                 ValueError, SHARDED_SUBLANE, id="extra4-ROADMAP B4"),
    # The last three ids keep their names from the refusals they pinned
    # before K4, K7 and K8 took bfloat16 (ROADMAP B2, B6): each run equals
    # the plain bfloat16 run bit for bit.
    pytest.param(["--mesh", "2,2", "--compute", "pallas"], None, None,
                 id="extra5-NotImplementedError-ROADMAP B2"),
    pytest.param(["--grid", "32,32", "--compute", "pallas"], None, None,
                 id="extra6-NotImplementedError-ROADMAP B2"),
    pytest.param(["--grid", "32,32", "--fuse", "8", "--iters", "8"], None,
                 None, id="extra7-NotImplementedError-ROADMAP B6"),
])
def test_bf16_refusals_name_their_item(monkeypatch, caplog, extra, exc,
                                       match):
    """--fuse 4 meets the alignment rule; a run that now takes bfloat16
    (``exc`` None: the stream kind's fallback, the compute_fn kernels K4
    and K7, the 2D k-step kernel K8) equals the plain bfloat16 run bit for
    bit, logging the overlap fallback where it asks for --overlap."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    stencil = "heat2d" if "32,32" in extra else "heat3d"
    args = ["--stencil", stencil, "--grid", "48,32,128", "--iters", "4",
            "--dtype", "bfloat16", "--device", "cpu", *extra]
    if exc is None:
        with caplog.at_level(logging.WARNING):
            got, _ = tcli.run(tcli.config_from_args(args))
        assert ("cannot host the interior/boundary split" in caplog.text) \
            == ("--overlap" in extra)
        # the plain twin: the same run without its kernel and mesh flags
        plain = [a for prev, a in zip([""] + args, args)
                 if a not in KERNEL_FLAGS + ("--overlap",)
                 and prev not in KERNEL_FLAGS]
        ref, _ = tcli.run(tcli.config_from_args(plain))
        if tstepper.is_sharded(got):
            got = tstepper.gather_fields(got)
        for g, r in zip(got, ref):
            assert g.dtype == torch.bfloat16 and torch.equal(g, r)
        return
    with pytest.raises(exc, match=match):
        tcli.main(args)


@pytest.mark.parametrize("extra,match", [
    (["--compute", "pallas"], "ROADMAP B1"),
    (["--fuse", "4", "--fuse-kind", "stream"], "ROADMAP B5"),
])
def test_other_dtypes_refused_by_the_bf16_kernels(extra, match):
    """The kernels that take bfloat16 take float32 and bfloat16 only:
    float16 on them raises by their own item."""
    with pytest.raises(NotImplementedError, match=match):
        tcli.main(["--stencil", "heat3d", "--grid", "16,16,32", "--iters",
                   "4", "--dtype", "float16", "--device", "cpu", *extra])


@pytest.mark.parametrize("log_every", [0, 2])
def test_donated_fields_are_freed_after_the_first_step(log_every):
    """run_simulation on Donated fields (as cli.run hands them over) holds
    no reference to the initial state once the first step has made new
    fields, chunked or not: a run keeps two copies of the state, not
    three; fields handed over plainly stay alive, as the caller holds
    them."""
    st = port.make_stencil("heat3d", dtype=BF16)
    grid = (8, 8, 16)
    step = tdriver.make_step(st, grid)
    for donate in (True, False):
        fields = _port(_seeded(1, grid, 5))
        initial = weakref.ref(fields[0])
        alive = []

        def spy(fs):
            alive.append(initial() is not None)
            return step(fs)

        arg = tdriver.Donated(fields) if donate else fields
        del fields
        out = tdriver.run_simulation(st, arg, 4, step_fn=spy,
                                     log_every=log_every,
                                     callback=lambda n, fs: None)
        assert alive == ([True, False, False, False] if donate
                         else [True] * 4)
        assert out[0].dtype == torch.bfloat16
        del arg
    with pytest.raises(RuntimeError, match="already taken"):
        d = tdriver.Donated(out)
        d.take()
        d.take()


def test_stepper_refuses_bf16_off_the_stream_kind():
    """make_sharded_fused_step takes bfloat16 on every kind (the name is
    kept from when only the stream kind did): at k = 8 the padded kind,
    the pad-free kind and the stream kind, each with and without the
    overlap shells, equal 8 plain sharded steps bit for bit; at k = 4
    (2m = 8, off bfloat16's alignment unit) the padded and pad-free kinds
    give None, as the JAX builders do, and the stream kind's shells fall
    back to the non-split step."""
    st = port.make_stencil("heat3d", dtype=BF16)
    mesh = tmesh.make_mesh((2, 2), [torch.device("cpu")] * 4)
    grid = (48, 48, 128)
    fields = tstepper.shard_fields(_port(_seeded(1, grid, 13)), mesh, 3)
    plain = tstepper.make_sharded_step(st, mesh, grid)
    ref = fields
    for _ in range(8):
        ref = plain(ref)
    ref = tstepper.gather_fields(ref)
    for kind in (None, "padfree", "stream"):
        for overlap in (False, True):
            step = tstepper.make_sharded_fused_step(
                st, mesh, grid, 8, kind=kind, overlap=overlap)
            assert step._overlap_active == overlap
            got = tstepper.gather_fields(step(fields))
            assert got[0].dtype == torch.bfloat16
            assert torch.equal(got[0], ref[0]), (kind, overlap)
        assert (tstepper.make_sharded_fused_step(st, mesh, grid, 4,
                                                 kind=kind) is None) == \
            (kind != "stream")
    step = tstepper.make_sharded_fused_step(st, mesh, grid, 4, kind="stream",
                                            overlap=True)
    assert not step._overlap_active


def test_stream_shared_memory_counts_the_itemsize():
    """K10's rings in bfloat16 take half the bytes (Gray-Scott at k = 4,
    at the column every k is admitted at: 72 KB in float32, 36 KB in
    bfloat16), so deeper k fit."""
    for name, k in (("grayscott3d", 4), ("wave3d", 4), ("sor3d", 4)):
        f32 = tstream.smem_bytes(port.make_stencil(name), k)
        bf = tstream.smem_bytes(port.make_stencil(name, dtype=BF16), k)
        assert bf * 2 == f32
    assert tstream.smem_bytes(port.make_stencil("grayscott3d"), 4) == 72448
    assert not tstream.fits(port.make_stencil("sor3d"), 7)
    assert tstream.fits(port.make_stencil("sor3d", dtype=BF16), 7)
