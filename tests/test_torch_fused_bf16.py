"""bfloat16 through K3, its overlap shells, K6 and K9 (TPU table rows 5-11),
and advect3d / grayscott3d on the pad-free kinds (K6, K9), against the JAX
package.

Inputs are uniform [0, 1) float32 arrays made with numpy from a seed and
cast to bfloat16 in both packages.  The JAX kernels run as its own tests
run them (``interpret=True``; its sharded steps on the 8 virtual CPU
devices of tests/conftest.py); the port's wrappers take their plain
versions for CPU tensors (chip_smoke.py holds the kernels to them on the
card, bit for bit).

Tolerance against JAX: in bfloat16 the reference's own bfloat16 tolerance,
``32 eps max(|ref|, 1)`` with eps = 2**-7 (tests/test_rawstep.py:43-48,
tests/test_torch_bf16.py), frame cells equal where a whole grid is
compared; in float32 ``atol = 1e-4, rtol = 0`` (tests/test_fused.py:70).
Within the port, ``--overlap`` equals its non-split twin and a sharded
bfloat16 run its unsharded twin bit for bit.

In bfloat16 the window alignment of both packages (``2m`` a multiple of 16)
gives k = 8 for the halo-1 families and k = 4 for heat3d4th and sor3d.
"""

import functools
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fused as jfused
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.interop import gather_to_numpy, shard_from_numpy
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

EPS = 2.0 ** -7  # bfloat16
BF16 = "bfloat16"
F32 = "float32"
CPU = torch.device("cpu")
# The bfloat16 k of each family (2m a multiple of 16) and its parameters:
# advection with Courant numbers of both signs, so both upwind sides of a
# slab are read.
FAMILIES = [("heat3d", 8, {}), ("heat3d27", 8, {}), ("heat3d4th", 4, {}),
            ("wave3d", 8, {}),
            ("advect3d", 8, {"cx": 0.3, "cy": -0.2, "cz": -0.25}),
            ("grayscott3d", 8, {}), ("sor3d", 4, {})]
IDS = [n for n, _, _ in FAMILIES]
# advect3d and grayscott3d on the pad-free kinds in float32 (k = 4)
NEW_PADFREE = [("advect3d", 4, {"cx": 0.3, "cy": -0.2, "cz": -0.25}),
               ("grayscott3d", 4, {})]


def _stencils(name, dtype, kw):
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return (jmake_stencil(name, dtype=jdt, **kw),
            port.make_stencil(name, dtype=dtype, **kw))


def _arrays(shapes, nf, seed):
    """Per field, one array of each shape (field-major), from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.random(s, dtype=np.float32) for _ in range(nf) for s in shapes]


def _jax(arrays, dtype):
    return [jnp.asarray(a, jnp.bfloat16 if dtype == BF16 else jnp.float32)
            for a in arrays]


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _f32(fields):
    return [f.float().numpy() if isinstance(f, torch.Tensor)
            else np.asarray(f, dtype=np.float32) for f in fields]


def _close(got, ref, dtype, halo=None):
    """bfloat16: 32 eps max(|ref|, 1); float32: 1e-4; frame cells (``halo``
    wide, of a whole grid) equal."""
    got, ref = _f32(got), _f32(ref)
    assert len(got) == len(ref)
    scale = max(float(np.abs(ref[0]).max()), 1.0)
    atol = 32 * EPS * scale if dtype == BF16 else 1e-4
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        if halo:
            frame = tdriver.frame_mask(r.shape, r.shape, (0,) * r.ndim, halo,
                                       device="cpu").numpy()
            np.testing.assert_array_equal(g[frame], r[frame])


def _origins(o):
    return jnp.array(o, dtype=jnp.int32)


# ---- row 5: K3 unsharded, one pass -----------------------------------------

@pytest.mark.parametrize("name,k,kw", FAMILIES, ids=IDS)
def test_fused_step_bf16_matches_jax(name, k, kw):
    """Row 5 in bfloat16: make_fused_step (fused_step's plain version) ==
    the JAX package's make_fused_step over build_fused_call (interpret),
    one pass at (48, 48, 128), frame cells equal."""
    grid = (48, 48, 128)
    jst, st = _stencils(name, BF16, kw)
    jstep = jfused.make_fused_step(jst, grid, k, interpret=True)
    tstep = tfused.make_fused_step(st, grid, k, device="cpu")
    assert jstep is not None and tstep is not None
    arrays = _arrays([grid], st.num_fields, 51)
    tfused.launches.clear()
    got = tstep(tuple(_port(arrays, BF16)))
    assert not tfused.launches  # CPU tensors never launch
    assert all(f.dtype == torch.bfloat16 for f in got)
    _close(got, jstep(tuple(_jax(arrays, BF16))), BF16, st.halo)


@pytest.mark.parametrize("name,k,kw", FAMILIES, ids=IDS)
def test_margin_of_accepts_the_bf16_pairs_jax_accepts(name, k, kw):
    """build_fused_call in bfloat16 builds for exactly the k (1..16) that
    the JAX package's builds for at (48, 48, 128): halo-1 k = 8, heat3d4th
    and sor3d k = 4; margin_of names the same k."""
    jst, st = _stencils(name, BF16, kw)
    shape = (48, 48, 128)
    jk = [kk for kk in range(1, 17)
          if jfused.build_fused_call(jst, shape, kk, interpret=True)]
    tk = [kk for kk in range(1, 17)
          if tfused.build_fused_call(st, shape, kk)]
    assert tk == jk == [k]
    assert [kk for kk in range(1, 17)
            if tfused.margin_of(st, kk) is not None] == [k]


def test_fused_shared_memory_counts_the_itemsize():
    """K3's windows in bfloat16 take half the bytes: Gray-Scott's four
    buffers at k = 8 fit in 221,184 B (442,368 in float32 do not)."""
    for name in ("heat3d", "wave3d", "grayscott3d", "sor3d"):
        f32, bf = (tfused.smem_bytes(
            tfused.core_of(st), k_step_margin(st, 8), tfused.buffers(st),
            st.dtype.itemsize) for st in (port.make_stencil(name),
                                          port.make_stencil(name,
                                                            dtype=BF16)))
        assert bf * 2 == f32
    gs16 = port.make_stencil("grayscott3d", dtype=BF16)
    assert tfused.smem_bytes(tfused.CORE, 8, 4, 2) == 221184 <= \
        tfused.SMEM_LIMIT
    assert tfused.fits(gs16, 8) and tfused.margin_of(gs16, 8) == 8
    assert not tfused.fits(port.make_stencil("grayscott3d"), 8)


# ---- rows 5 (sharded_global) and 7: one shard and its shells ----------------

@pytest.mark.parametrize("name,k,kw", FAMILIES, ids=IDS)
def test_sharded_call_and_shells_bf16_match_jax(name, k, kw):
    """Row 5's sharded_global mode on one shard's padded block (shard
    (1, 0) of a 3x3 grid of (16, 16, 128) shards) and row 7's shells (the
    hi z and y shells of shard (1, 0) of a 2x2 grid of (32, 32, 128)
    shards, on random strips) == the JAX package's build_fused_call and
    build_overlap_shell_calls (interpret)."""
    jst, st = _stencils(name, BF16, kw)
    m, nf = k_step_margin(st, k), st.num_fields
    local, gshape, org = (16, 16, 128), (48, 48, 128), (16, 0)
    pshape = (local[0] + 2 * m, local[1] + 2 * m, local[2])
    arrays = _arrays([pshape], nf, 61)
    jcall, jm, _ = jfused.build_fused_call(jst, local, k, interpret=True,
                                           sharded_global=gshape)
    call, tm, _ = tfused.build_fused_call(st, local, k,
                                          sharded_global=gshape)
    assert jm == tm == m
    ref = jcall(_origins(org), *[a for a in _jax(arrays, BF16)
                                 for _ in range(4)])
    _close(call(org, *_port(arrays, BF16)), ref, BF16)
    local, gshape = (32, 32, 128), (64, 64, 128)
    jshells = jfused.build_overlap_shell_calls(jst, local, gshape, k, (0, 1),
                                               interpret=True)
    shells = tfused.build_overlap_shell_calls(st, local, gshape, k, (0, 1))
    assert set(jshells) == set(shells) == {0, 1}
    for d in (0, 1):
        sshape = [local[0] + 2 * m, local[1] + 2 * m, local[2]]
        sshape[d] = 4 * m
        org = [local[0], 0]
        org[d] += local[d] - 2 * m
        arrays = _arrays([tuple(sshape)], nf, 62 + d)
        ref = jshells[d](_origins(org), *[a for a in _jax(arrays, BF16)
                                          for _ in range(4)])
        _close(shells[d](tuple(org), *_port(arrays, BF16)), ref, BF16)


# ---- rows 8 and 9: K6 and K9 on one interior shard --------------------------

def _jax_zslab(jst, k, local, gshape, oz, arrays):
    call, _, nf = jfused.build_zslab_padfree_call(jst, local, gshape, k,
                                                  interpret=True)
    args = []
    for j in range(nf):
        core, lo, hi = arrays[3 * j:3 * j + 3]
        args += [core] * 9 + [lo] * 3 + [hi] * 3
    return call(_origins((oz, 0)), *args)


def _jax_yzslab(jst, k, local, gshape, org, arrays):
    call, _, nf = jfused.build_yzslab_padfree_call(jst, local, gshape, k,
                                                   interpret=True)

    def dup(a):  # the JAX call's 2m-wide y operands (stepper._dup_y)
        return jnp.concatenate([a, a], axis=1)

    args = []
    for j in range(nf):
        core, zlo, zhi, ylo, yhi, *corners = arrays[9 * j:9 * j + 9]
        args += ([core] * 9 + [zlo] * 3 + [zhi] * 3 + [dup(ylo)] * 3
                 + [dup(yhi)] * 3 + [dup(c) for c in corners])
    return call(_origins(org), *args)


@pytest.mark.parametrize(
    "name,k,kw,dtype", [(n, k, kw, BF16) for n, k, kw in FAMILIES]
    + [(n, k, kw, F32) for n, k, kw in NEW_PADFREE],
    ids=[f"{n}-{BF16}" for n in IDS] + [f"{n}-{F32}" for n, _, _ in
                                       NEW_PADFREE])
def test_slab_calls_match_jax(name, k, kw, dtype):
    """Rows 8 and 9: build_zslab_padfree_call (K6, the interior shard of a
    z column of three) and build_yzslab_padfree_call (K9, the interior
    shard of a 3x3 grid of shards) == the JAX package's builders
    (interpret) on the same random core, slabs and corners: every family
    in bfloat16, and advect3d and grayscott3d in float32."""
    jst, st = _stencils(name, dtype, kw)
    m, nf = k_step_margin(st, k), st.num_fields
    Lz, Y, X = local = (16, 48, 128)
    gshape = (3 * Lz, Y, X)
    arrays = _arrays([local, (m, Y, X), (m, Y, X)], nf, 71)
    ref = _jax_zslab(jst, k, local, gshape, Lz, _jax(arrays, dtype))
    call, tm, _ = tfused.build_zslab_padfree_call(st, local, gshape, k)
    assert tm == m
    _close(call(Lz, *_port(arrays, dtype)), ref, dtype)
    Lz, Ly, X = local = (16, 16, 128)
    gshape = (3 * Lz, 3 * Ly, X)
    arrays = _arrays([local, (m, Ly, X), (m, Ly, X), (Lz, m, X), (Lz, m, X),
                      (m, m, X), (m, m, X), (m, m, X), (m, m, X)], nf, 73)
    ref = _jax_yzslab(jst, k, local, gshape, (Lz, Ly), _jax(arrays, dtype))
    call, _, _ = tfused.build_yzslab_padfree_call(st, local, gshape, k)
    _close(call((Lz, Ly), *_port(arrays, dtype)), ref, dtype)


# ---- the sharded steppers ---------------------------------------------------

def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * 8)


def _port_steps(st, mesh_shape, grid, k, arrays, passes, **kw):
    step = tstepper.make_sharded_fused_step(st, _mesh(mesh_shape), grid, k,
                                            **kw)
    assert step is not None
    f = shard_from_numpy(arrays, _mesh(mesh_shape), dtype=st.dtype)
    tfused.launches.clear()
    for _ in range(passes):
        f = step(f)
    assert not tfused.launches
    return step, f


STEPPER_CASES = [
    ("heat3d", (2, 2, 1), None, False), ("heat3d", (2, 2, 1), None, True),
    ("wave3d", (2, 2, 1), "padfree", False),
    ("wave3d", (2, 2, 1), "padfree", True),
    ("heat3d", (4, 1, 1), "padfree", True),
    ("grayscott3d", (2, 2, 1), None, True),
]


@pytest.mark.parametrize("name,mesh_shape,kind,overlap", STEPPER_CASES,
                         ids=[f"{n}-{'x'.join(map(str, m))}-"
                              f"{kind or 'padded'}{'-overlap' if o else ''}"
                              for n, m, kind, o in STEPPER_CASES])
def test_sharded_fused_bf16_matches_jax(name, mesh_shape, kind, overlap):
    """bfloat16 K3 sharded mode, K6 and K9, with and without the overlap
    shells, on 4 virtual shards: == the JAX package's
    make_sharded_fused_step (interpret) after two passes, and the overlap
    split taken where the shards host it."""
    # shards of at least 3m = 24 planes on every sharded axis, in tiles of
    # 2m = 16 (the JAX builders' tiling)
    grid = (128, 32, 128) if mesh_shape == (4, 1, 1) else (64, 64, 128)
    k = 8
    jst, st = _stencils(name, BF16, {})
    arrays = _arrays([grid], st.num_fields, 81)
    jm = jmesh.make_mesh(mesh_shape)
    jstep = jstepper.make_sharded_fused_step(
        jst, jm, grid, k, interpret=True, kind=kind, overlap=overlap,
        padfree=kind == "padfree" or None)
    assert jstep is not None
    jf = jstepper.shard_fields(tuple(_jax(arrays, BF16)), jm, 3)
    jrun = jax.jit(jstep)
    for _ in range(2):
        jf = jrun(jf)
    step, tf = _port_steps(st, mesh_shape[:2], grid, k, arrays, 2,
                           kind=kind, overlap=overlap)
    assert step._overlap_active == overlap
    _close(gather_to_numpy(tf), jf, BF16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("mesh_shape", [(4,), (2, 2)], ids=["z", "zy"])
@pytest.mark.parametrize("name,kw", [("advect3d", {"cx": 0.3, "cy": -0.2,
                                                   "cz": -0.25}),
                                     ("grayscott3d", {})],
                         ids=["advect3d", "grayscott3d"])
def test_padfree_new_families_match_plain_and_unsharded(name, kw,
                                                        mesh_shape, dtype):
    """advect3d and grayscott3d on the pad-free kinds (K6 on a z mesh, K9
    on a (z, y) mesh), float32 k = 4 and bfloat16 k = 8, with and without
    the shells: == k plain sharded steps (float32 at 1e-4, bfloat16 bit
    for bit) and the unsharded K3 pass bit for bit; the shells' run equals
    the non-split one bit for bit."""
    k = 8 if dtype == BF16 else 4
    grid = (96, 48, 128) if mesh_shape == (4,) else (64, 64, 128)
    st = port.make_stencil(name, dtype=dtype, **kw)
    arrays = _arrays([grid], st.num_fields, 91)
    mesh = _mesh(mesh_shape)
    fields = shard_from_numpy(arrays, mesh, dtype=dtype)
    plain = tstepper.make_sharded_step(st, mesh, grid)
    ref = fields
    for _ in range(k):
        ref = plain(ref)
    ref = tstepper.gather_fields(ref)
    whole = tfused.make_fused_step(st, grid, k, device="cpu")(
        tuple(_port(arrays, dtype)))
    outs = []
    for overlap in (False, True):
        step = tstepper.make_sharded_fused_step(st, mesh, grid, k,
                                                kind="padfree",
                                                overlap=overlap)
        assert step._padfree_kind == ("zslab" if len(mesh_shape) == 1
                                      else "yzslab")
        assert step._overlap_active == overlap
        outs.append(tstepper.gather_fields(step(fields)))
    for a, b, w, r in zip(*outs, whole, ref):
        assert torch.equal(a, b) and torch.equal(a, w)
        if dtype == BF16:
            assert torch.equal(a, r)
        else:
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0,
                                       atol=1e-4)


# ---- rows 10 and 11: the X-windowed TPU kernels in bfloat16 -----------------

def test_k6_is_the_function_of_jax_zslab_xwin_bf16():
    """Row 10 in bfloat16: the TPU package's wide-X z-slab kernel
    (build_zslab_xwin_call, X windowed for VMEM) and the port's K6 path
    (plain version) compute the same k = 8 steps on a z-only mesh."""
    name, grid, k = "heat3d", (32, 16, 256), 8
    jst, st = _stencils(name, BF16, {})
    arrays = _arrays([grid], 1, 21)
    jm = jmesh.make_mesh((2, 1, 1))
    axis_names, counts = jstepper._resolve_mesh_axes(3, jm)
    jstep = jstepper._make_zslab_padfree_step(
        jst, jm, grid, (16, 16, 256), axis_names, counts, k,
        functools.partial(jfused.build_zslab_xwin_call, tiles=(16, 16, 128)),
        (27, 9), True, False)
    assert jstep._padfree_kind == "zslab_xwin"
    ref = jax.jit(jstep)(jstepper.shard_fields(tuple(_jax(arrays, BF16)),
                                               jm, 3))
    _, got = _port_steps(st, (2,), grid, k, arrays, 1, kind="padfree")
    _close(tstepper.gather_fields(got), ref, BF16)


def test_k9_is_the_function_of_jax_yzslab_xwin_bf16(monkeypatch):
    """Row 11 in bfloat16: the TPU package's wide-X 2-axis kernel
    (build_yzslab_xwin_call), forced as tests/test_twoaxis_padfree.py's
    ``_xwin_step`` forces it, and the port's K9 path (plain version)
    compute the same k = 8 steps at (32, 32, 256) with two x tiles."""
    name, grid, k = "heat3d", (32, 32, 256), 8
    orig_x = jfused.build_yzslab_xwin_call
    monkeypatch.setattr(jfused, "build_yzslab_padfree_call",
                        lambda *a, **kw: None)
    monkeypatch.setattr(jfused, "build_yzslab_xwin_call",
                        lambda *a, **kw: orig_x(*a, tiles=(16, 16, 128),
                                                **kw))
    jst, st = _stencils(name, BF16, {})
    arrays = _arrays([grid], 1, 23)
    jm = jmesh.make_mesh((2, 2, 1))
    jstep = jstepper.make_sharded_fused_step(jst, jm, grid, k,
                                             interpret=True, padfree=True)
    assert jstep._padfree_kind == "yzslab_xwin"
    ref = jax.jit(jstep)(jstepper.shard_fields(tuple(_jax(arrays, BF16)),
                                               jm, 3))
    _, got = _port_steps(st, (2, 2), grid, k, arrays, 1, kind="padfree")
    _close(tstepper.gather_fields(got), ref, BF16)


# ---- the CLI ------------------------------------------------------------------

def _log(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name]


def _ckpt_bf16(load, d):
    """A bfloat16 npy checkpoint's fields (np.load gives raw 2-byte
    records) as bfloat16 arrays, and its step."""
    fields, step, _ = load(d)
    return [np.asarray(a).view(np.uint16).view(jnp.bfloat16)
            for a in fields], step


def test_cli_bf16_fuse8_mesh22_overlap_matches_jax_cli(tmp_path, monkeypatch,
                                                       caplog):
    """heat3d bfloat16 --fuse 8 --mesh 2,2 --overlap through both CLIs:
    the same fields (at the bf16 tolerance) and the same log-line keys;
    the port's overlapped run equals its non-split twin bit for bit and
    logs no fallback."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "heat3d", "--grid", "64,64,128", "--iters", "16",
            "--fuse", "8", "--mesh", "2,2", "--dtype", BF16, "--log-every",
            "8", "--checkpoint-every", "16"]
    jdir, tdir, twin = (str(tmp_path / n) for n in ("j", "t", "twin"))
    with caplog.at_level(logging.INFO):
        assert jcli.main(args + ["--overlap", "--checkpoint-dir",
                                 jdir]) == 0
        jlines = _log(caplog, "mpi_cuda_process_tpu")
        caplog.clear()
        assert tcli.main(args + ["--overlap", "--device", "cpu",
                                 "--checkpoint-dir", tdir]) == 0
        tlines = _log(caplog, "mpi_cuda_process_tpu_torch")
    assert not any("cannot host" in ln for ln in tlines + jlines)

    def keys(lines):
        return [[kv.split("=")[0] for kv in ln.split()[2:]]
                for ln in lines if ln.startswith("step ")]

    assert keys(tlines) == keys(jlines) and len(keys(tlines)) == 2
    assert tcli.main(args + ["--device", "cpu", "--checkpoint-dir",
                             twin]) == 0
    (jf, js), (a, sa), (b, sb) = (
        _ckpt_bf16(load, d) for load, d in ((jckpt.load_checkpoint, jdir),
                                            (tckpt.load_checkpoint, tdir),
                                            (tckpt.load_checkpoint, twin)))
    assert js == sa == sb == 16
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16))
    _close(a, jf, BF16, 1)


CONFIG5 = ["--stencil", "wave3d", "--grid", "192,64,128", "--iters", "8",
           "--mesh", "8,1,1", "--fuse", "4", "--fuse-kind", "stream",
           "--dtype", BF16, "--mem-check", "error", "--log-every", "4",
           "--checkpoint-every", "8"]


def test_config5_overlap_falls_back_like_jax_cli(tmp_path, monkeypatch,
                                                 caplog):
    """Config 5's rehearsal line with --overlap: the K3 shells would have
    m = 4, off the bfloat16 alignment, so both CLIs log the fallback and
    run the non-split stream step; the port's fields equal its run without
    --overlap bit for bit and JAX's at the bf16 tolerance, with the same
    log-line keys."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    jdir, tdir, twin = (str(tmp_path / n) for n in ("j", "t", "twin"))
    with caplog.at_level(logging.INFO):
        assert jcli.main(CONFIG5 + ["--overlap", "--checkpoint-dir",
                                    jdir]) == 0
        jlines = _log(caplog, "mpi_cuda_process_tpu")
        caplog.clear()
        assert tcli.main(CONFIG5 + ["--overlap", "--device", "cpu",
                                    "--checkpoint-dir", tdir]) == 0
        tlines = _log(caplog, "mpi_cuda_process_tpu_torch")
    for lines in (jlines, tlines):
        assert any("--overlap: block geometry cannot host the interior/"
                   "boundary split" in ln for ln in lines)
    assert [ln.split("=")[0] for ln in tlines if ln.startswith("step ")] \
        == [ln.split("=")[0] for ln in jlines if ln.startswith("step ")]
    assert tcli.main(CONFIG5 + ["--device", "cpu", "--checkpoint-dir",
                                twin]) == 0
    (jf, js), (a, sa), (b, sb) = (
        _ckpt_bf16(load, d) for load, d in ((jckpt.load_checkpoint, jdir),
                                            (tckpt.load_checkpoint, tdir),
                                            (tckpt.load_checkpoint, twin)))
    assert js == sa == sb == 8
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16))
    _close(a, jf, BF16, 1)
