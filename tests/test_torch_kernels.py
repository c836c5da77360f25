"""The port's kernel modules (K1-K3) on the CPU, against the JAX package.

On a CPU tensor each wrapper in ``mpi_cuda_process_tpu_torch/ops/cuda`` takes
its kernel's plain PyTorch version; these tests hold that plain version
against the TPU package's Pallas builders run in interpret mode, as
tests/test_rawstep.py and tests/test_fused.py run them.  Tolerances are
theirs: ``32 * eps * max(|ref|, 1)`` for the raw step, ``atol = 1e-4,
rtol = 0`` for k fused steps; guard-frame cells match exactly.  The CUDA
kernels themselves are compared with these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import fused as jfused
from mpi_cuda_process_tpu.ops.pallas import rawstep as jrawstep
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch.interop import fields_from_numpy
from mpi_cuda_process_tpu_torch.ops.cuda import _build
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _seeded(st, grid, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.random(grid, dtype=np.float32)
                 for _ in range(st.num_fields))


def _assert_fields(got, ref, halo, atol):
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        if halo:
            for d in range(3):
                for sl in (slice(0, halo), slice(-halo, None)):
                    idx = [slice(None)] * 3
                    idx[d] = sl
                    np.testing.assert_array_equal(g[tuple(idx)],
                                                  r[tuple(idx)])


RAW_CASES = [
    ("heat3d", (16, 18, 130)),
    ("heat3d27", (16, 12, 14)),
    ("heat3d4th", (16, 14, 130)),
    ("wave3d", (16, 18, 12)),
]


@pytest.mark.parametrize("init", ["auto", "seeded"])
@pytest.mark.parametrize("name,grid", RAW_CASES,
                         ids=[n for n, _ in RAW_CASES])
def test_raw_step_plain_matches_jax_raw_kernel(name, grid, init):
    """K1/K2's plain version == ops/pallas/rawstep.py (interpret), 4 steps."""
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    jraw = jrawstep.make_raw_step(jst, grid, interpret=True)
    traw = trawstep.make_raw_step(tst, grid, device="cpu")
    assert jraw is not None and traw is not None
    if init == "auto":
        arrays = tuple(np.asarray(f) for f in
                       jinit_state(jst, grid, 3, 0.2, "auto"))
    else:
        arrays = _seeded(tst, grid, len(name))
    a = tuple(jnp.asarray(x) for x in arrays)
    b = fields_from_numpy(arrays, device="cpu")
    trawstep.launches.clear()
    for _ in range(4):
        a, b = jraw(a), traw(b)
    scale = max(float(jnp.max(jnp.abs(a[0]))), 1.0)
    _assert_fields(b, a, tst.halo, 32 * EPS32 * scale)
    assert not trawstep.launches  # CPU tensors never launch the kernel


def test_raw_step_wave_carries_the_old_u():
    st = port.make_stencil("wave3d")
    f = fields_from_numpy(_seeded(st, (6, 7, 8), 1), device="cpu")
    new = trawstep.make_raw_step(st, (6, 7, 8), device="cpu")(f)
    assert new[1] is f[0]


def test_raw_step_unsupported_returns_none():
    assert trawstep.make_raw_step(port.make_stencil("heat2d"),
                                  (16, 16)) is None
    assert trawstep.make_raw_step(port.make_stencil("heat3d4th"),
                                  (4, 16, 16)) is None
    assert not trawstep.raw_step_supported(port.make_stencil("wave2d"))


FUSED_CASES = [
    ("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2), ("wave3d", 4)]


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("name,k", FUSED_CASES,
                         ids=[f"{n}-k{k}" for n, k in FUSED_CASES])
def test_fused_step_plain_matches_jax_fused_kernel(name, k, periodic):
    """K3's plain version == ops/pallas/fused.py (interpret), k steps."""
    grid = (16, 16, 128)
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    jstep = jfused.make_fused_step(jst, grid, k, interpret=True,
                                   periodic=periodic)
    tstep = tfused.make_fused_step(tst, grid, k, periodic=periodic,
                                   device="cpu")
    assert jstep is not None and tstep is not None
    arrays = _seeded(tst, grid, k + len(name))
    tfused.launches.clear()
    a = jstep(tuple(jnp.asarray(x) for x in arrays))
    b = tstep(fields_from_numpy(arrays, device="cpu"))
    assert len(a) == len(b) == tst.num_fields
    _assert_fields(b, a, None if periodic else tst.halo, 1e-4)
    assert not tfused.launches


@pytest.mark.parametrize("name", ["heat3d", "heat3d27", "heat3d4th",
                                  "wave3d"])
def test_fused_step_accepts_the_same_k_as_jax(name):
    """``make_fused_step`` is None for exactly the (stencil, k) pairs the
    TPU package's alignment rule rejects, so one CLI line fails on both."""
    grid = (32, 32, 128)
    jst, tst = jmake_stencil(name), port.make_stencil(name)
    for k in (1, 2, 3, 4):
        j = jfused.make_fused_step(jst, grid, k, interpret=True)
        t = tfused.make_fused_step(tst, grid, k, device="cpu")
        assert (j is None) == (t is None), (name, k)


def test_fused_windows_fit_shared_memory():
    """The largest accepted (stencil, k) pairs fit one block's shared memory
    at the (8, 8, 32) core (80 KB at k = 4, halo 1); the next accepted k
    does not fit at any core and is refused."""
    assert tfused.CORE == (8, 8, 32)
    assert tfused.smem_bytes((8, 8, 32), 4) == 2 * 4 * 16 * 16 * 40
    for name, k in (("heat3d", 8), ("wave3d", 8), ("heat3d4th", 4)):
        st = port.make_stencil(name)
        assert tfused.fits(st, k)
        assert tfused.smem_bytes(tfused.CORE, k * st.halo) <= tfused.SMEM_LIMIT
    for name, k in (("heat3d", 12), ("heat3d4th", 6)):
        st = port.make_stencil(name)
        assert tfused.smem_bytes((1, 1, 32), k * st.halo) > tfused.SMEM_LIMIT
        assert tfused.make_fused_step(st, (32, 32, 128), k,
                                      device="cpu") is None


@pytest.mark.parametrize("key", sorted(tfused.TILES) or [None])
def test_fused_tiles_fit_and_stay_within_the_accepted_set(key):
    """Every launch tile of the table is for a (stencil, dtype, k) the
    kernels accept, fits one block's shared memory, keeps 16-byte rows
    (TX a multiple of 16 bytes) and takes whole warps, at most 1024
    threads; tile_of gives it on a grid that holds it."""
    if key is None:
        pytest.skip("the tile table is empty")
    name, dtype, k = key
    st = port.make_stencil(name, dtype=dtype)
    tz, ty, tx, threads = tfused.TILES[key]
    m = tfused.margin_of(st, k)
    assert m is not None
    assert tfused.smem_bytes((tz, ty, tx), m, tfused.buffers(st),
                             st.dtype.itemsize) <= tfused.SMEM_LIMIT
    assert (tx * st.dtype.itemsize) % 16 == 0
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert tfused.tile_of(st, k, (512, 512, 512)) == (tz, ty, tx, threads)


@pytest.mark.parametrize("name,dtype,k", [("heat3d", "float32", 4),
                                          ("wave3d", "bfloat16", 8),
                                          ("sor3d", "float32", 4),
                                          ("grayscott3d", "float32", 4)])
def test_fused_tile_falls_back_to_the_core(monkeypatch, name, dtype, k):
    """A grid smaller than the table's tile, a tile whose window overflows
    shared memory and a pair the table lacks all launch at core_of with
    THREADS."""
    st = port.make_stencil(name, dtype=dtype)
    default = tfused.core_of(st) + (tfused.THREADS,)
    key = (name, dtype, k)
    monkeypatch.setitem(tfused.TILES, key, (16, 16, 32, 512))
    fits = tfused.smem_bytes((16, 16, 32), tfused.margin_of(st, k),
                             tfused.buffers(st), st.dtype.itemsize) \
        <= tfused.SMEM_LIMIT
    assert tfused.tile_of(st, k, (512, 512, 512)) == (
        (16, 16, 32, 512) if fits else default)
    assert tfused.tile_of(st, k, (8, 512, 512)) == default  # a shell
    monkeypatch.setitem(tfused.TILES, key, (64, 64, 64, 512))
    assert tfused.tile_of(st, k, (512, 512, 512)) == default
    monkeypatch.delitem(tfused.TILES, key)
    assert tfused.tile_of(st, k, (512, 512, 512)) == default


def test_fused_launch_paths_drop_16_byte_copies_off_alignment():
    """The 16-byte row copies need every operand's address on 16 bytes:
    a view one element in drops them and keeps the other fast paths."""
    t = torch.zeros(64)
    assert tfused.launch_paths((t,)) == tfused.PATHS
    off = tfused.launch_paths((t, t[1:]))
    assert off == tfused.PATHS & ~tfused.VEC_LOAD
    assert off & tfused.FRAME_FREE and off & tfused.ROW_LOAD


def test_coefficients_come_from_the_op_layer():
    from mpi_cuda_process_tpu_torch.ops import heat

    a, c0, c1, c2, c3 = trawstep.coefficients(port.make_stencil("heat3d27"))
    assert (a, c0, c1, c2, c3) == (0.15, heat.W27_CENTER, heat.W27_FACE,
                                   heat.W27_EDGE, heat.W27_CORNER)
    a, c0, c1, c2, _ = trawstep.coefficients(port.make_stencil("heat3d4th"))
    assert (c0, c1, c2) == (heat.w4th_center(3), heat.W4TH[1], heat.W4TH[2])
    with pytest.raises(ValueError):
        trawstep.coefficients(port.make_stencil("heat2d"))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The operand gate raises before any build: CPU, mixed devices,
    bfloat16, wrong rank, non-contiguous."""
    x = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_operands("k", x)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_operands("k", x.to(torch.bfloat16))


def test_build_paths_and_flags():
    """Sources are compiled for sm_90a into build/torch_kernels/, one
    library per source, named by a hash of its sources and flags."""
    assert _build.SOURCES == ("rawstep", "fused", "zchunk", "whole2d",
                              "fullgrid", "streamfused", "remote")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        p = _build._lib_path(name)
        assert p.parent == _build.BUILD_DIR
        assert p.parent.parts[-2:] == ("build", "torch_kernels")
        assert p.name.startswith(f"lib{name}-") and p.suffix == ".so"
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags and "-O3" in flags
