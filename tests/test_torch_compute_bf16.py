"""bfloat16 through the compute_fn kernels K4, K5 and K7 and the 2D k-step
kernel K8 (TPU table rows 12-15), against the JAX package.

Inputs are uniform [0, 1) float32 arrays made with numpy from a seed and
cast to bfloat16 in both packages.  The JAX kernels run as its own tests
run them (``interpret=True``; its sharded steps on the 8 virtual CPU
devices of tests/conftest.py), and every JAX comparison counts the JAX
package's ``pallas_call`` builds, so a JAX kernel that quietly took its
plain fallback (``_pick_bz``'s z-chunk rule, the 2D VMEM cap, K8's
``W % 128`` and sublane rules) fails the test.  The port's wrappers take
their plain versions for CPU tensors (tests/test_torch_cuda.py and
chip_smoke.py hold the kernels to them on the card, bit for bit).

Tolerance against JAX: the reference's own bfloat16 tolerance,
``32 eps max(|ref|, 1)`` with eps = 2**-7 (tests/test_torch_bf16.py), frame
cells equal where a whole grid is compared.  Within the port, every kernel
path's CLI run equals the plain bfloat16 run bit for bit, and ``--overlap``
its non-split twin.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as jpl

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fullgrid as jfullgrid
from mpi_cuda_process_tpu.ops.pallas import kernels as jkernels
from mpi_cuda_process_tpu.utils import budget as jbudget
from mpi_cuda_process_tpu.utils import checkpointing as jckpt

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt

torch.set_num_threads(1)

EPS = 2.0 ** -7  # bfloat16
BF16 = "bfloat16"
# The float 2D families of K8, with advection's Courant numbers of both
# signs, and each one's bfloat16 k at JAX's alignment (m a multiple of 16:
# k = 16, sor2d's margin 2k: k = 8).
FAMILIES_2D = [("heat2d", 16, {}), ("mdf", 16, {}), ("wave2d", 16, {}),
               ("advect2d", 16, {"cx": -0.4, "cy": 0.2}),
               ("grayscott2d", 16, {}), ("sor2d", 8, {})]
IDS_2D = [n for n, _, _ in FAMILIES_2D]


def _stencils(name, **kw):
    return (jmake_stencil(name, dtype=jnp.bfloat16, **kw),
            port.make_stencil(name, dtype=BF16, **kw))


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(s, dtype=np.float32) for s in shapes]


def _jax(arrays):
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in arrays)


def _port(arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


def _f32(fields):
    return [f.float().numpy() if isinstance(f, torch.Tensor)
            else np.asarray(f, dtype=np.float32) for f in fields]


def _close(got, ref, halo=None):
    """32 eps max(|ref|, 1); frame cells (``halo`` wide, of a whole grid)
    equal."""
    got, ref = _f32(got), _f32(ref)
    assert len(got) == len(ref)
    scale = max(float(np.abs(ref[0]).max()), 1.0)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0, atol=32 * EPS * scale)
        if halo:
            frame = tdriver.frame_mask(r.shape, r.shape, (0,) * r.ndim, halo,
                                       device="cpu").numpy()
            np.testing.assert_array_equal(g[frame], r[frame])


@pytest.fixture
def jax_kernels(monkeypatch):
    """Counts the JAX package's ``pallas_call`` builds: a comparison whose
    JAX side took its plain fallback builds none."""
    built = []
    real = jpl.pallas_call

    def counting(*a, **kw):
        built.append(kw.get("interpret"))
        return real(*a, **kw)

    monkeypatch.setattr(jpl, "pallas_call", counting)
    return built


# ---- rows 12-14: K4, K5 and K7's plain versions -------------------------------

COMPUTE_3D = [("heat3d", (16, 12, 20)), ("heat3d27", (16, 10, 14)),
              ("heat3d4th", (16, 12, 18)), ("wave3d", (8, 12, 20))]


@pytest.mark.parametrize("name,shape", COMPUTE_3D,
                         ids=[n for n, _ in COMPUTE_3D])
def test_k4_k5_plain_bf16_matches_jax_pallas_compute(jax_kernels, name,
                                                     shape):
    """Rows 12-13 in bfloat16: the port's make_pallas_compute (zchunk_heat
    for the three tap sets, zchunk_wave; plain versions on the CPU) == the
    JAX package's (interpret), on one padded block; bfloat16 out, no
    launch."""
    jst, st = _stencils(name)
    h = st.halo
    shapes = [tuple(s + 2 * h for s in shape)] + \
        ([shape] if st.num_fields == 2 else [])
    arrays = _arrays(shapes, len(name))
    ref = jkernels.make_pallas_compute(jst, interpret=True)(_jax(arrays))
    assert jax_kernels == [True]
    tkernels.launches.clear()
    got = tkernels.make_pallas_compute(st)(_port(arrays))
    assert not tkernels.launches
    assert got[0].dtype == torch.bfloat16 and got[0].shape == shape
    _close(got[:1], ref[:1])


@pytest.mark.parametrize("name", ["heat2d", "mdf"])
@pytest.mark.parametrize("grid", [(16, 20), (33, 70)])
def test_k7_plain_bf16_matches_jax_whole2d(jax_kernels, name, grid):
    """Row 14 in bfloat16: whole2d's plain version == JAX's
    _whole2d_compute (interpret) on the same padded block."""
    jst, st = _stencils(name)
    arrays = _arrays([tuple(g + 2 for g in grid)], 3)
    ref = jkernels.make_pallas_compute(jst, interpret=True)(_jax(arrays))
    assert jax_kernels == [True]
    got = tkernels.make_pallas_compute(st)(_port(arrays))
    assert got[0].dtype == torch.bfloat16
    _close(got, ref)


# ---- row 15: K8, the whole grid (RAW) and a row shard (PADDED) ----------------

@pytest.mark.parametrize("periodic", [False, True], ids=["frame", "periodic"])
@pytest.mark.parametrize("name,k,kw", FAMILIES_2D, ids=IDS_2D)
def test_k8_raw_bf16_matches_jax_fullgrid(jax_kernels, name, k, kw,
                                          periodic):
    """K8 RAW in bfloat16: fullgrid_step's plain version == the JAX
    package's make_fullgrid_step (interpret) at (32, 128) (W a multiple of
    128, H of bfloat16's 16-row sublane, so the JAX kernel builds), one
    launch of k steps; frame cells equal."""
    grid = (32, 128)
    jst, st = _stencils(name, **kw)
    arrays = _arrays([grid] * st.num_fields, k + len(name))
    jstep = jfullgrid.make_fullgrid_step(jst, grid, k, interpret=True,
                                         periodic=periodic)
    assert jstep is not None
    ref = jax.jit(jstep)(_jax(arrays))
    assert jax_kernels == [True]
    tfullgrid.launches.clear()
    got = tfullgrid.make_fullgrid_step(st, grid, k, periodic=periodic)(
        _port(arrays))
    assert not tfullgrid.launches
    assert all(f.dtype == torch.bfloat16 for f in got)
    _close(got, ref, None if periodic else 1)


@pytest.mark.parametrize("periodic", [False, True], ids=["frame", "periodic"])
@pytest.mark.parametrize("name,k,kw", FAMILIES_2D, ids=IDS_2D)
def test_k8_padded_bf16_matches_jax_masked_call(jax_kernels, name, k, kw,
                                                periodic):
    """K8 PADDED in bfloat16: fullgrid_padded's plain version == JAX's
    build_fullgrid_masked_call (interpret) on the second row shard of a
    (64, 128) grid split in four, its padded block (16 + 2m, 128) with
    m = 16 at k = 16 (sor2d: 2k at k = 8)."""
    gshape, Ly, oy = (64, 128), 16, 16
    jst, st = _stencils(name, **kw)
    m = k_step_margin(st, k)
    assert m == 16
    pshape = (Ly + 2 * m, gshape[1])
    built = jfullgrid.build_fullgrid_masked_call(
        jst, pshape, m, k, interpret=True, periodic=periodic,
        global_shape=None if periodic else gshape)
    assert built is not None
    call, nf = built
    arrays = _arrays([pshape] * nf, 7 + k)
    jin = _jax(arrays)
    ref = call(*jin) if periodic else call(jnp.array([oy], jnp.int32), *jin)
    assert jax_kernels == [True]
    tfullgrid.launches.clear()
    got = tfullgrid.fullgrid_padded(_port(arrays), st, k,
                                    Ly if periodic else gshape[0],
                                    0 if periodic else oy, periodic=periodic)
    assert not tfullgrid.launches
    assert all(f.dtype == torch.bfloat16 and f.shape == (Ly, gshape[1])
               for f in got)
    _close(got, ref)


def test_k8_bf16_windows_take_half_the_shared_memory():
    """fits() counts the field's itemsize: a bfloat16 window takes half the
    bytes, so every (family, k) that fits in float32 fits in bfloat16
    (Gray-Scott's four buffers at k = 16: 96 KB, 48 KB), and a k that
    overflows in float32 may fit in bfloat16."""
    for name, k, kw in FAMILIES_2D:
        f32 = port.make_stencil(name, **kw)
        bf = port.make_stencil(name, dtype=BF16, **kw)
        m = k_step_margin(bf, k)
        nbuf = 4 if name == "grayscott2d" else 2
        assert tfullgrid.smem_bytes(m, 2, nbuf) * 2 == \
            tfullgrid.smem_bytes(m, 4, nbuf)
        assert tfullgrid.fits(f32, k) and tfullgrid.fits(bf, k)
    assert tfullgrid.smem_bytes(16, 4, 4) == 4 * 4 * 64 * 96
    gs32 = port.make_stencil("grayscott2d")
    gs16 = port.make_stencil("grayscott2d", dtype=BF16)
    big = next(k for k in range(16, 200) if not tfullgrid.fits(gs32, k))
    assert tfullgrid.fits(gs16, big)


# ---- the CLI ------------------------------------------------------------------

def _log(caplog, name):
    return [r.getMessage() for r in caplog.records if r.name == name]


def _ckpt_bf16(load, d):
    """A bfloat16 npy checkpoint's fields as bfloat16 arrays, and its
    step."""
    fields, step, _ = load(d)
    return [np.asarray(a).view(np.uint16).view(jnp.bfloat16)
            for a in fields], step


def _run_both(tmp_path, caplog, args, jax_args=None):
    """One run through each CLI with a final checkpoint, and the port's
    plain bfloat16 twin (``--compute jnp``, no --fuse, --mesh or
    --overlap): ((JAX fields, step), port fields, port plain fields),
    the port's log lines."""
    jdir, tdir, twin = (str(tmp_path / n) for n in ("j", "t", "twin"))
    ck = ["--checkpoint-every", args[args.index("--iters") + 1]]
    jf = None
    if jax_args is not False:
        assert jcli.main((jax_args or args) + ck + ["--checkpoint-dir",
                                                    jdir]) == 0
        jf = _ckpt_bf16(jckpt.load_checkpoint, jdir)
    with caplog.at_level(logging.INFO):
        caplog.clear()
        assert tcli.main(args + ck + ["--device", "cpu", "--checkpoint-dir",
                                      tdir]) == 0
        lines = _log(caplog, "mpi_cuda_process_tpu_torch")
    plain = []
    skip = {"--mesh": 2, "--fuse": 2, "--compute": 2, "--overlap": 1}
    i = 0
    while i < len(args):
        if args[i] in skip:
            i += skip[args[i]]
            continue
        plain.append(args[i])
        i += 1
    assert tcli.main(plain + ck + ["--compute", "jnp", "--device", "cpu",
                                   "--checkpoint-dir", twin]) == 0
    (tf, ts), (pf, ps) = (_ckpt_bf16(tckpt.load_checkpoint, d)
                          for d in (tdir, twin))
    assert ts == ps
    return jf, tf, pf, lines


def _bit_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint16), y.view(np.uint16))


CLI_3D = [("heat3d", ["--mesh", "2,2"]),
          ("heat3d", ["--mesh", "2,2", "--overlap"]),
          ("heat3d27", ["--mesh", "2,2"]),
          ("heat3d4th", ["--mesh", "2,2", "--overlap"]),
          ("wave3d", ["--mesh", "2,2", "--overlap"]),
          ("heat3d", ["--periodic"]), ("heat3d27", ["--periodic"]),
          ("heat3d", ["--periodic", "--mesh", "2,2"])]


@pytest.mark.parametrize("name,extra", CLI_3D,
                         ids=[f"{n}{''.join(e)}" for n, e in CLI_3D])
def test_cli_bf16_compute_fn_3d_matches_jax_cli(tmp_path, monkeypatch,
                                                caplog, jax_kernels, name,
                                                extra):
    """BASELINE config 3's decomposition in bfloat16: --compute pallas
    under --mesh 2,2 (± --overlap) and --periodic through both CLIs (K4 /
    K5 here, the JAX z-chunk kernels in interpret mode there), at the bf16
    tolerance, frame equal; the port's run equals its plain bfloat16 run
    bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", name, "--grid", "16,16,32", "--iters", "6",
            "--init", "pulse", "--dtype", BF16, "--compute", "pallas",
            *extra]
    (jf, js), tf, pf, lines = _run_both(tmp_path, caplog, args)
    assert jax_kernels and js == 6
    assert any("compute_fn CUDA kernel" in ln for ln in lines)
    _bit_equal(tf, pf)
    _close(tf, jf, None if "--periodic" in extra else
           port.make_stencil(name).halo)


def test_cli_bf16_wave3d_periodic_matches_jax_step(monkeypatch, jax_kernels):
    """wave3d --periodic --compute pallas in bfloat16: the JAX CLI cannot
    run wave3d periodic (its pulse init hands one array to both fields and
    donation refuses it), so the port's run is held to the JAX step with
    JAX's compute_fn kernel (interpret), from the port's own init, and to
    the port's plain bfloat16 run bit for bit."""
    grid, iters = (16, 16, 32), 6
    args = ["--stencil", "wave3d", "--grid", "16,16,32", "--iters",
            str(iters), "--dtype", BF16, "--periodic", "--init", "pulse",
            "--device", "cpu"]
    got, _ = tcli.run(tcli.config_from_args(args + ["--compute", "pallas"]))
    ref, _ = tcli.run(tcli.config_from_args(args))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    st = port.make_stencil("wave3d", dtype=BF16)
    init = tcli.init_state(st, grid, 0, 0.15, kind="pulse", periodic=True,
                           device="cpu")
    jst = jmake_stencil("wave3d", dtype=jnp.bfloat16)
    jstep = jax.jit(jdriver.make_step(
        jst, grid, periodic=True,
        compute_fn=jkernels.make_pallas_compute(jst, interpret=True)))
    jf = tuple(jnp.asarray(f.float().numpy(), jnp.bfloat16) for f in init)
    for _ in range(iters):
        jf = jstep(jf)
    assert jax_kernels
    _close(got, jf)


CLI_2D = [("heat2d", ["--compute", "pallas"]),
          ("mdf", ["--compute", "pallas", "--mesh", "4"]),
          ("heat2d", ["--compute", "pallas", "--mesh", "4", "--overlap"]),
          ("heat2d", ["--compute", "pallas", "--periodic"]),
          ("heat2d", ["--fuse", "16"]),
          ("heat2d", ["--fuse", "16", "--periodic"]),
          ("wave2d", ["--fuse", "16"]),
          ("advect2d", ["--fuse", "16", "--param", "cx=-0.4"]),
          ("grayscott2d", ["--fuse", "16"]),
          ("sor2d", ["--fuse", "8"]),
          ("heat2d", ["--fuse", "16", "--mesh", "4"]),
          ("heat2d", ["--fuse", "16", "--mesh", "4", "--overlap"]),
          ("wave2d", ["--fuse", "16", "--mesh", "4", "--overlap"]),
          ("advect2d", ["--fuse", "16", "--mesh", "4", "--overlap",
                        "--param", "cx=-0.4"]),
          ("grayscott2d", ["--fuse", "16", "--mesh", "4", "--overlap"]),
          ("sor2d", ["--fuse", "8", "--mesh", "4", "--overlap"])]


@pytest.mark.parametrize("name,extra", CLI_2D,
                         ids=[f"{n}{''.join(e)}" for n, e in CLI_2D])
def test_cli_bf16_2d_kernels_match_jax_cli(tmp_path, monkeypatch, caplog,
                                           jax_kernels, name, extra):
    """BASELINE config 1's family in bfloat16: 2D --compute pallas (K7)
    and --fuse (K8) ± --mesh 4 ± --overlap through both CLIs at (192, 128)
    (row shards of 48: the overlap shells run, 3m <= 48), the JAX kernels
    in interpret mode, at the bf16 tolerance, frame equal; the port's run
    equals its plain bfloat16 run bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    k = int(extra[extra.index("--fuse") + 1]) if "--fuse" in extra else 1
    args = ["--stencil", name, "--grid", "192,128", "--iters", str(2 * k),
            "--dtype", BF16, *extra]
    (jf, js), tf, pf, lines = _run_both(tmp_path, caplog, args)
    assert jax_kernels and js == 2 * k
    assert not any("cannot host" in ln for ln in lines)
    _bit_equal(tf, pf)
    _close(tf, jf, None if "--periodic" in extra else 1)


def test_cli_bf16_fuse8_sharded_runs_where_jax_cli_refuses(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    """heat2d bfloat16 --fuse 8 --mesh 4: m = 8 is off bfloat16's 16-row
    sublane, so the JAX CLI refuses it (a VMEM tiling rule the port drops,
    ROADMAP C, "Not faults"); the port runs it, equal to its plain run bit
    for bit and to 8 JAX steps at the bf16 tolerance."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "heat2d", "--grid", "64,128", "--iters", "8",
            "--dtype", BF16, "--fuse", "8", "--mesh", "4"]
    with pytest.raises(ValueError, match="unsupported"):
        jcli.main(args)
    _, tf, pf, _ = _run_both(tmp_path, caplog, args, jax_args=False)
    _bit_equal(tf, pf)
    jst = jmake_stencil("heat2d", dtype=jnp.bfloat16)
    st = port.make_stencil("heat2d", dtype=BF16)
    init = tcli.init_state(st, (64, 128), 0, 0.15, device="cpu")
    jf = tuple(jnp.asarray(f.float().numpy(), jnp.bfloat16) for f in init)
    jstep = jdriver.make_step(jst, (64, 128))
    for _ in range(8):
        jf = jstep(jf)
    _close(tf, jf, 1)


def test_bf16_2d_checkpoint_resumes_across_a_mesh_change(tmp_path,
                                                         monkeypatch):
    """A bfloat16 heat2d checkpoint written by the JAX CLI (--fuse 16
    --mesh 4) at step 16 resumes in the port on --mesh 2 --compute pallas
    to step 32, within the bf16 tolerance of JAX's uninterrupted run; the
    port's own checkpoint (--mesh 4 --fuse 16) resumed unsharded with
    --fuse 16 equals its uninterrupted plain run bit for bit."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    base = ["--stencil", "heat2d", "--grid", "64,128", "--dtype", BF16]
    jdir, full, tdir, tfull = (str(tmp_path / n)
                               for n in ("j", "full", "t", "tfull"))
    assert jcli.main(base + ["--iters", "16", "--fuse", "16", "--mesh", "4",
                             "--checkpoint-every", "16", "--checkpoint-dir",
                             jdir]) == 0
    assert jcli.main(base + ["--iters", "32", "--checkpoint-every", "32",
                             "--checkpoint-dir", full]) == 0
    assert tcli.main(base + ["--iters", "32", "--mesh", "2", "--compute",
                             "pallas", "--resume", "--checkpoint-every",
                             "16", "--checkpoint-dir", jdir,
                             "--device", "cpu"]) == 0
    (got, s1), (ref, s2) = (_ckpt_bf16(tckpt.load_checkpoint, d)
                            for d in (jdir, full))
    assert s1 == s2 == 32
    _close(got, ref, 1)
    assert tcli.main(base + ["--iters", "16", "--fuse", "16", "--mesh", "4",
                             "--checkpoint-every", "16", "--checkpoint-dir",
                             tdir, "--device", "cpu"]) == 0
    assert tcli.main(base + ["--iters", "32", "--fuse", "16", "--resume",
                             "--checkpoint-every", "16", "--checkpoint-dir",
                             tdir, "--device", "cpu"]) == 0
    assert tcli.main(base + ["--iters", "32", "--checkpoint-every", "32",
                             "--checkpoint-dir", tfull, "--device",
                             "cpu"]) == 0
    (a, sa), (b, sb) = (_ckpt_bf16(tckpt.load_checkpoint, d)
                        for d in (tdir, tfull))
    assert sa == sb == 32
    _bit_equal(a, b)


# ---- the refusals that remain ---------------------------------------------

@pytest.mark.parametrize("name,extra,match", [
    ("heat3d", ["--compute", "pallas", "--mesh", "2,2"], "ROADMAP B2"),
    ("heat3d", ["--compute", "pallas", "--periodic"], "ROADMAP B2"),
    ("heat2d", ["--compute", "pallas"], "ROADMAP B2"),
    ("heat2d", ["--fuse", "8"], "ROADMAP B6"),
    ("heat2d", ["--fuse", "8", "--mesh", "4"], "ROADMAP B6"),
])
def test_float16_refused_by_the_compute_fn_and_2d_kernels(monkeypatch, name,
                                                          extra, match):
    """K4, K5, K7 and K8 take float32 and bfloat16: float16 on their paths
    raises by their items (B2, B6), naming the types they take."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    grid = "16,16,32" if name == "heat3d" else "64,128"
    with pytest.raises(NotImplementedError,
                       match=match + ".*take.? float32 and bfloat16"):
        tcli.main(["--stencil", name, "--grid", grid, "--iters", "8",
                   "--dtype", "float16", "--device", "cpu", *extra])


@pytest.mark.parametrize("dtype", ["float32", BF16])
@pytest.mark.parametrize("extra", [["--compute", "pallas"], ["--fuse", "8"],
                                   ["--fuse", "8", "--mesh", "2"]])
def test_life_in_a_float_dtype_refused_on_k7_and_k8(monkeypatch, dtype,
                                                    extra):
    """Life runs on K7 and K8 in int32 only: a float Life on their paths
    raises by its own item (B10); its plain path runs."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    args = ["--stencil", "life", "--grid", "32,32", "--iters", "8",
            "--dtype", dtype, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP B10"):
        tcli.main(args + extra)
    assert tcli.main(args) == 0


# ---- --mem-check on the newly admitted bfloat16 paths ----------------------------

BUDGET = [("heat3d", (1024,) * 3, (2, 2, 1), 0),
          ("wave3d", (1024,) * 3, (2, 2, 1), 0),
          ("heat3d", (512,) * 3, (), 0),
          ("heat2d", (16384, 16384), (), 0),
          ("heat2d", (16384, 16384), (4,), 0),
          ("heat2d", (16384, 16384), (4,), 16),
          ("grayscott2d", (16384, 16384), (4,), 16),
          ("sor2d", (16384, 16384), (4,), 8)]


@pytest.mark.parametrize("name,grid,mesh,fuse", BUDGET,
                         ids=[f"{n}-{g[0]}-{'x'.join(map(str, m)) or 'whole'}"
                              f"-f{f}" for n, g, m, f in BUDGET])
def test_budget_bf16_matches_jax(name, grid, mesh, fuse):
    """--mem-check prices the bfloat16 compute_fn and 2D k-step paths: the
    port's estimate equals the JAX package's term for term but for the
    port-only terms (labelled "port:": the one-step path's re-pinned copy
    and bool frame mask), which it adds; every term priced in the field's
    type is half its float32 twin's (the mask is one byte a cell in
    both)."""
    kw = dict(mesh=mesh, fuse=fuse, compute="pallas" if not fuse else "auto")
    jt, jp = jbudget.estimate_run_bytes(
        jmake_stencil(name, dtype=jnp.bfloat16), grid, **kw)
    tt, tp = tbudget.estimate_run_bytes(port.make_stencil(name, dtype=BF16),
                                        grid, **kw)
    _, t32 = tbudget.estimate_run_bytes(port.make_stencil(name), grid, **kw)

    def subtotal(parts):
        return sum(b for label, b in parts if not label.startswith("work"))

    added = [(label, b) for label, b in tp if "port:" in label]
    assert subtotal(tp) - subtotal(jp) == sum(b for _, b in added)
    assert len(tp) - len(added) == len(jp)
    if not fuse and name != "wave3d":
        assert len(added) == 2  # one re-pinned field and its mask
    for (label, b), (_, b32) in zip(tp, t32):
        if "frame mask" in label:
            assert b == b32 == np.prod(grid) // np.prod(mesh or (1,))
        elif not label.startswith("work"):
            assert 2 * b == b32, label


def test_budget_covers_the_sharded_compute_fn_peak():
    """heat3d 1024^3 --mesh 2,2 --compute pallas on four shards of one
    card: the estimate stays above the peak an H100 measured
    (scripts/torch_compute_bf16.py: 9,685,747,200 B in bfloat16,
    18,295,687,168 B in float32), which the state, output and pad terms
    alone (7,109,836,870 and 14,219,673,740 B with the overhead) fell
    short of."""
    for dtype, peak in ((BF16, 9685747200), ("float32", 18295687168)):
        total, parts = tbudget.estimate_run_bytes(
            port.make_stencil("heat3d", dtype=dtype), (1024,) * 3,
            mesh=(2, 2), compute="pallas", shards_per_device=4)
        assert total >= peak
        assert any("re-pin" in label for label, _ in parts)
