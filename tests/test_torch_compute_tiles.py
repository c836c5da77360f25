"""The tiled one-step kernels K1, K2, Gray-Scott's raw step, K4, K5 and K7
(csrc/march.cuh) on the CPU.

No card here: these hold what the kernel's launches are made of — the tile
tables (``kernels.TILES``, ``rawstep.TILES``), the ring geometry, the
aligned-word copy of each row segment (``march.row_copy_plan``, on padded
blocks and the raw grid's pitch) and the ring's schedule (replayed by
``tests/compute_schedule.py`` with the plain update: K4/K7, K5 with its
u_prev, K1, K2 and Gray-Scott (two rings) on the raw grid with its frame
and clipped runs; each held to the JAX package's own function too) — and
the
claim the packed bfloat16 path rests on: one rounding of an op's exact
result to bfloat16 gives what the plain version's float-then-bfloat16
gives.  The kernels themselves are held to their plain versions bit for
bit on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as jpl

from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.ops.pallas import kernels as jkernels
from mpi_cuda_process_tpu.ops.pallas import rawstep as jrawstep

from mpi_cuda_process_tpu_torch import driver, make_stencil
from mpi_cuda_process_tpu_torch.ops import available_stencils
from mpi_cuda_process_tpu_torch.ops.cuda import _build, kernels, march, rawstep

import compute_schedule  # noqa: E402  (tests/, on pytest's path)

_JAX_TYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

KINDS = [("heat3d", torch.float32), ("heat3d", torch.bfloat16),
         ("heat3d27", torch.float32), ("heat3d27", torch.bfloat16),
         ("heat3d4th", torch.float32), ("heat3d4th", torch.bfloat16),
         ("heat2d", torch.float32), ("heat2d", torch.bfloat16),
         ("life", torch.int32)]
# every table of the tiled kernel: K4/K5/K7's and K1/K2/Gray-Scott's
TABLES = [("kernels", n, d) for n, d in KINDS + [
    ("wave3d", torch.float32), ("wave3d", torch.bfloat16)]] + [
    ("rawstep", n, d) for n in ("heat3d", "heat3d27", "heat3d4th",
                                "advect3d", "wave3d", "grayscott3d")
    for d in (torch.float32, torch.bfloat16)]


def _stencil(name, dtype):
    return make_stencil(name) if dtype == torch.int32 else \
        make_stencil(name, dtype=dtype)


def _ids(cases):
    return [f"{n}-{str(d).replace('torch.', '')}" for n, d in cases]


@pytest.mark.parametrize(
    "table,name,dtype", TABLES,
    ids=[f"{n}-{str(d)[6:]}" if t == "kernels" else f"{t}-{n}-{str(d)[6:]}"
         for t, n, d in TABLES])
def test_every_table_tile_fits_and_was_a_timed_candidate(table, name,
                                                         dtype):
    st = _stencil(name, dtype)
    mod = {"kernels": kernels, "rawstep": rawstep}[table]
    key = (name, str(dtype).replace("torch.", ""))
    assert key in mod.TILES
    tile = mod.TILES[key]
    assert kernels.tile_fits(st, tile)
    assert tile in kernels.candidates(st)
    geo = kernels.march_geometry(st, tile)
    assert geo.smem <= _build.SMEM_LIMIT
    assert tile.blocks * geo.smem <= _build.SMEM_PER_SM
    assert mod.tile_of(st) == tile


def test_every_kernel_kind_has_a_table_entry():
    """Each kind a tiled wrapper takes has its tile: K4/K5/K7's every
    compute_fn name in each of its types, and every raw kind (K1's
    one-field kinds, K2's wave3d, Gray-Scott's grayscott3d) in each."""
    for name in ("heat3d", "heat3d27", "heat3d4th", "wave3d", "heat2d"):
        for dt in ("float32", "bfloat16"):
            assert (name, dt) in kernels.TILES
    raw = [n for n in available_stencils()
           if rawstep.raw_step_supported(make_stencil(n))]
    assert set(raw) == set(rawstep._HEAT_KIND) | {"wave3d", "grayscott3d"}
    for name in raw:
        for dt in ("float32", "bfloat16"):
            assert (name, dt) in rawstep.TILES
    assert len(rawstep.TILES) == 2 * len(raw)


def test_tiles_the_kernel_does_not_take_are_refused():
    f32 = make_stencil("heat3d")
    bf = make_stencil("heat3d", dtype=torch.bfloat16)
    assert kernels.tile_fits(f32, kernels.Tile(256, 2, 128, 16, 64))
    # bfloat16 takes its cells in pairs: a tile row of single cells is
    # not one of its unrolls
    assert not kernels.tile_fits(bf, kernels.Tile(256, 2, 128, 16, 64))
    assert kernels.tile_fits(bf, kernels.Tile(256, 2, 256, 16, 64))
    assert not kernels.tile_fits(f32, kernels.Tile(128, 8, 128, 16, 64))
    assert not kernels.tile_fits(f32, kernels.Tile(256, 2, 48, 16, 64))
    assert not kernels.tile_fits(bf, kernels.Tile(256, 2, 32, 8, 64))
    assert not kernels.tile_fits(f32, kernels.Tile(256, 2, 128, 256, 64))
    assert not kernels.tile_fits(make_stencil("heat2d"),
                                 kernels.Tile(256, 2, 1024, 2, 64))
    # the z queue: heat3d and heat3d4th only, a tile of one row a group
    assert kernels.tile_fits(f32, kernels.Tile(256, 2, 128, 8, 64, 1, True))
    assert not kernels.tile_fits(f32, kernels.Tile(256, 2, 128, 16, 64, 1,
                                                   True))
    assert not kernels.tile_fits(make_stencil("heat3d27"), kernels.Tile(
        256, 2, 128, 8, 64, 1, True))
    saved = dict(kernels.TILES)
    try:
        kernels.TILES[("heat3d", "float32")] = kernels.Tile(256, 2, 48, 16,
                                                            64)
        with pytest.raises(ValueError, match="does not fit"):
            kernels.tile_of(f32)
    finally:
        kernels.TILES.clear()
        kernels.TILES.update(saved)


@pytest.mark.parametrize("halo", [1, 2])
def test_ring_slots_and_geometry(halo):
    assert kernels.ring_slots(halo) == kernels.IN_FLIGHT + 2 * halo + 1
    st = make_stencil("heat3d" if halo == 1 else "heat3d4th")
    tile = kernels.Tile(256, 2, 128, 16, 64)
    geo = kernels.march_geometry(st, tile)
    assert geo.rows == 16 + 2 * halo
    assert geo.slots == kernels.ring_slots(halo)
    words = -(-((128 + 2 * halo) * 4 + 15) // 16)
    assert geo.row_bytes == 2 * kernels.ROW_PAD + 16 * words
    assert geo.smem == geo.slots * geo.rows * (geo.row_bytes + 4)
    assert kernels.march_geometry(make_stencil("heat2d"),
                                  kernels.Tile(256, 2, 1024, 1, 64)).rows == 1


@pytest.mark.parametrize("extent,tiles,halo", [
    (512, 128, 1), (256, 32, 1), (256, 64, 2), (1, 7, 1), (16384, 4, 1),
    (16384, 16, 1), (37, 3, 2)])
def test_fitted_run_fills_the_card_within_the_tile_run(extent, tiles, halo):
    """The run a launch marches: at most the tile's, at least one plane,
    and no costlier (waves x planes with lead-in) than the tile's own run;
    a grid with few tiles takes shorter runs so its items fill the card."""
    tile = kernels.Tile(256, 2, 256, 16, 256)
    slots = 264

    def cost(zr):
        runs = -(-extent // zr)
        return -(-tiles * runs // slots) * (zr + 2 * halo)

    zr = _build.fit_runs(extent, tile.zrun, tiles, 2 * halo, slots,
                         kernels.FILL_WAVES)
    assert 1 <= zr <= min(tile.zrun, extent)
    assert cost(zr) <= cost(min(tile.zrun, extent))
    if 2 * tiles * -(-extent // tile.zrun) <= slots and extent >= 64:
        assert tiles * -(-extent // zr) > tiles * -(-extent // tile.zrun)



@pytest.mark.parametrize("rows,width", [(16384, 16384), (4096, 16384),
                                        (1024, 512), (144, 1600)])
def test_k8_chunks_stay_within_four_times_the_tile_chunks(rows, width):
    """K8's chunk (``fullgrid.chunk_rows``) fits through the same
    ``_build.fit_runs`` with no waves to fill: the least cost over the
    tile's chunk count up to 4 times it, as K8 was tuned."""
    from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid
    st = make_stencil("heat2d")
    tx, cz, _, blocks = fullgrid.ring_tile(st, 8)
    slots = 132 * blocks
    strips, lead = -(-width // tx), fullgrid._lead(st, 8)
    first = -(-rows // cz)
    costs = {-(-rows // n): -(-strips * n // slots) * (-(-rows // n) + lead)
             for n in range(first, 4 * first + 1)}
    got = fullgrid.chunk_rows(st, 8, rows, width, (tx, cz), slots)
    assert got in costs and costs[got] == min(costs.values())
    assert got == _build.fit_runs(rows, cz, strips, lead, slots, 0)


# --- the aligned-word copy plan ------------------------------------------

def _check_plan(mem, lo, addr, ncells, es, row_bytes):
    """Copy one segment by its plan into a row buffer and check it: every
    16-byte copy inside the tensor, cell copies the segment's own, every
    cell of the segment at ``shift + i`` in the buffer, the words within
    the buffer."""
    hi = lo + len(mem)
    shift, words = kernels.row_copy_plan(addr, ncells, es, lo, hi)
    assert 0 <= shift < 16 // es
    cap = row_bytes - 2 * kernels.ROW_PAD
    assert 16 * len(words) <= cap
    buf = bytearray(cap)
    for k, (wa, cells) in enumerate(words):
        assert wa % 16 == 0 and wa == (addr & ~15) + 16 * k
        if cells is None:
            assert lo <= wa and wa + 16 <= hi
            buf[16 * k:16 * k + 16] = mem[wa - lo:wa - lo + 16]
        else:
            assert not (lo <= wa and wa + 16 <= hi)
            for c in cells:
                assert addr <= c < addr + ncells * es and lo <= c < hi
                off = c - wa
                buf[16 * k + off:16 * k + off + es] = mem[c - lo:c - lo + es]
    for i in range(ncells):
        got = buf[(shift + i) * es:(shift + i + 1) * es]
        want = mem[addr - lo + i * es:addr - lo + (i + 1) * es]
        assert got == want, f"cell {i} of the segment at {addr:#x}"


def _segments(shape_in, h, es, tile, d2, raw=False):
    """Every (byte offset, cells) row segment a launch copies from its
    input of ``shape_in``: a padded block, or with ``raw`` the raw grid
    (rows and cells clipped to it, a run from plane max(z0 - h, 0))."""
    PZ, PY, PX = shape_in
    pad, co = (0, 0) if raw else (2 * h, h)
    M, Y, X = PZ - pad, (1 if d2 else PY - pad), PX - pad
    TY = 1 if d2 else tile.ty
    PR = 1 if d2 else TY + 2 * h
    for z0 in range(0, M, tile.zrun):
        nz = min(tile.zrun, M - z0)
        plo = max(z0 + co - h, 0)
        for y0 in range(0, Y, TY):
            for x0 in range(0, X, tile.tx):
                # the tile's cells widened by h, clipped to the row
                first = max(x0 + co - h, 0)
                n = min(x0 + co + tile.tx + h, PX) - first
                for pz in range(plo, min(z0 + nz + co + h, PZ)):
                    for r in range(PR):
                        py = 0 if d2 else y0 + co - h + r
                        if 0 <= py < PY:
                            yield (((pz * PY + py) * PX + first) * es, n)


PLAN_CASES = [(name, dt, res) for name, dt in (
    ("heat3d", torch.float32), ("heat3d", torch.bfloat16),
    ("heat3d4th", torch.float32), ("heat3d4th", torch.bfloat16),
    ("heat2d", torch.float32), ("heat2d", torch.bfloat16),
    ("life", torch.int32)) for res in range(8)]


@pytest.mark.parametrize("name,dtype,res", PLAN_CASES,
                         ids=[f"{n}-{str(d)[6:]}-w{r}" for n, d, r in
                              PLAN_CASES])
def test_row_copy_plan_covers_every_cell_and_reads_only_the_tensor(
        name, dtype, res):
    """Widths in each residue mod 8 (1-cell and ragged tiles among them),
    an aligned base and bases off 16 bytes (a view into a larger
    allocation), one run that divides the march extent and one that does
    not."""
    st = _stencil(name, dtype)
    h, es = st.halo, st.dtype.itemsize
    d2 = name in ("heat2d", "life")
    rng = np.random.default_rng(res)
    paired = dtype == torch.bfloat16
    for X in (res or 8, 8 + res, 40 + res):
        for tx, ty, zrun in ((32, 2, 2), (64, 3, 5)):
            tile = kernels.Tile(256, 2, tx * (2 if paired else 1),
                                1 if d2 else ty, zrun)
            row_bytes = kernels.march_geometry(st, tile).row_bytes
            shape = (3 + 2 * h, 1, X + 2 * h) if d2 else \
                (3 + 2 * h, 2 + 2 * h, X + 2 * h)
            nbytes = int(np.prod(shape)) * es
            mem = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
            for lo in (1 << 20, (1 << 20) + es, (1 << 20) + 8):
                for off, n in _segments(shape, h, es, tile, d2):
                    _check_plan(mem, lo, lo + off, n, es, row_bytes)


RAW_PLAN_CASES = [(name, dt, res) for name in ("heat3d", "heat3d4th")
                  for dt in (torch.float32, torch.bfloat16)
                  for res in range(8)]


@pytest.mark.parametrize("name,dtype,res", RAW_PLAN_CASES,
                         ids=[f"raw-{n}-{str(d)[6:]}-w{r}"
                              for n, d, r in RAW_PLAN_CASES])
def test_row_copy_plan_on_the_raw_pitch(name, dtype, res):
    """The copy plan on the raw grid's pitch X (K1: segments clipped at the
    walls, the grid's own first and last words): widths in each residue
    mod 8, bases on and off 16 bytes, every cell copied and nothing
    outside the tensor read."""
    st = _stencil(name, dtype)
    h, es = st.halo, st.dtype.itemsize
    rng = np.random.default_rng(100 + res)
    unit = 2 if dtype == torch.bfloat16 else 1
    for X in (res or 8, 8 + res, 40 + res, 2 * h + 1 + res):
        for tx, ty, zrun in ((32, 2, 2), (64, 3, 5)):
            tile = kernels.Tile(256, 2, tx * unit, ty, zrun)
            row_bytes = kernels.march_geometry(st, tile).row_bytes
            shape = (2 * h + 3, 2 * h + 2, X)
            nbytes = int(np.prod(shape)) * es
            mem = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()
            for lo in (1 << 20, (1 << 20) + es, (1 << 20) + 8):
                for off, n in _segments(shape, h, es, tile, False, raw=True):
                    _check_plan(mem, lo, lo + off, n, es, row_bytes)


def test_row_copy_plan_of_a_one_cell_tensor():
    for es in (2, 4):
        for lo in (4096, 4096 + es, 4096 + 14 // es * es):
            shift, words = kernels.row_copy_plan(lo, 1, es, lo, lo + es)
            assert words == [(lo & ~15, (lo,))]
            assert shift == (lo - (lo & ~15)) // es


# --- the ring's schedule ---------------------------------------------------

SCHEDULE = [("heat3d", (7, 9, 37), (32, 4, 3)),
            ("heat3d", (6, 4, 64), (32, 2, 6)),      # runs divide Z
            ("heat3d27", (5, 7, 33), (32, 3, 3)),
            ("heat3d4th", (7, 6, 35), (32, 4, 3)),
            ("heat3d4th", (1, 1, 1), (32, 8, 4)),    # one plane, row, cell
            ("heat2d", (13, 70), (32, 1, 4)),
            ("heat2d", (1, 1), (64, 1, 3)),
            ("life", (12, 45), (16, 1, 3))]           # runs divide H


def _block(st, shape, seed):
    g = torch.Generator().manual_seed(seed)
    padded = tuple(s + 2 * st.halo for s in shape)
    if st.name == "life":
        return (torch.rand(padded, generator=g) < 0.4).to(torch.int32)
    return torch.rand(padded, generator=g).to(st.dtype)


SCHEDULE_TYPES = [case + (dt,) for case in SCHEDULE
                  for dt in ((torch.int32,) if case[0] == "life"
                             else (torch.float32, torch.bfloat16))]


@pytest.mark.parametrize("name,shape,tile,dtype", SCHEDULE_TYPES,
                         ids=[f"{n}-{'x'.join(map(str, s))}-{str(d)[6:]}"
                              for n, s, _, d in SCHEDULE_TYPES])
def test_ring_schedule_on_its_slots_is_the_plain_update(name, shape, tile,
                                                        dtype):
    st = _stencil(name, dtype)
    p = _block(st, shape, 7)
    tile = kernels.Tile(256, 2, *tile)
    got = compute_schedule.run(st, p, tile, kernels.ring_slots(st.halo))
    ref = st.update((p,))[0]
    assert got.dtype == ref.dtype and torch.equal(got, ref)


# a ring one slot short races once a run issues a plane into a slot whose
# plane is still read: runs of more output planes than planes in flight
SHORT = [c for c in SCHEDULE if min(c[1][0], c[2][2]) > kernels.IN_FLIGHT]


@pytest.mark.parametrize("name,shape,tile", SHORT,
                         ids=[f"{n}-{'x'.join(map(str, s))}"
                              for n, s, _ in SHORT])
def test_ring_schedule_races_on_a_ring_one_slot_short(name, shape, tile):
    st = _stencil(name, torch.int32 if name == "life" else torch.float32)
    p = _block(st, shape, 8)
    with pytest.raises(compute_schedule.Race):
        compute_schedule.run(st, p, kernels.Tile(256, 2, *tile),
                             kernels.ring_slots(st.halo) - 1)


# --- packed bfloat16: one rounding against two ----------------------------

def _bf16_round(x: np.ndarray) -> np.ndarray:
    """Exact float64 values rounded once to bfloat16 (nearest, ties to
    even), subnormals included (quantum 2^-133 below 2^-126)."""
    m, e = np.frexp(x)
    q = np.ldexp(1.0, np.maximum(e, -125) - 8)
    return np.rint(x / q) * q


def _special_bf16(n, seed):
    """bfloat16 operands with subnormals, both zeros, and pairs whose sums
    fall on bfloat16 ties."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    bits = bits[((bits >> 7) & 0xFF) != 0xFF]  # finite
    sub = rng.integers(1, 128, 64, dtype=np.uint32) | \
        (rng.integers(0, 2, 64, dtype=np.uint32) << 15)
    ones = np.array([0x3F80, 0x3F81, 0x3F83, 0xBF81, 0x0000, 0x8000,
                     0x3B80, 0x3B00, 0x0080, 0x8080, 0x0001, 0x8001],
                    dtype=np.uint32)
    bits = np.concatenate([bits, sub, ones])
    return (bits << 16).view(np.float32).astype(np.float64)


@pytest.mark.parametrize("op", ["add", "sub", "mul6", "mul4", "mulpair",
                                "rsub1"])
def test_packed_bf16_ops_round_like_float_then_bfloat16(op):
    """``add.rn`` / ``sub.rn`` / ``mul.rn .bf16x2`` round the exact result
    of two bfloat16 values once; the plain version rounds it to float and
    then to bfloat16 (stencil_taps.cuh fadd<bf16>).  Float's 24 bits are at
    least 2 * 8 + 2, so the two agree: checked on random finite operands,
    subnormals, signed zeros and sums that fall on bfloat16 ties (the
    products by 6 and 4 are the ones the packed path takes: exact
    bfloat16 coefficients; Gray-Scott's u v and (u v) v are products of
    two pairs, its 1 - u a difference from a splatted 1)."""
    a = _special_bf16(4000, 1)
    b = np.random.default_rng(2).permutation(_special_bf16(4000, 3))[:len(a)]
    a = a[:len(b)]
    # ties: b = a * 2^-8 (half an ulp of a's binade, an exact tie)
    a = np.concatenate([a, np.array([1.0, 1.0 + 2 ** -7, -3.0, 2 ** -120])])
    b = np.concatenate([b, np.array([2 ** -8, 2 ** -8, -(2 ** -7) * 1.5,
                                     2 ** -128])])
    # exact in float64 at these ranges (1 - b: rounded to float64's 53
    # bits first, which is again at least 2 * 8 + 2)
    exact = {"add": a + b, "sub": a - b, "mul6": 6.0 * b,
             "mul4": 4.0 * b, "mulpair": a * b, "rsub1": 1.0 - b}[op]
    ok = np.abs(exact) < 3.0e38
    one = _bf16_round(exact[ok])
    ta = torch.from_numpy(a[ok].astype(np.float32))
    tb = torch.from_numpy(b[ok].astype(np.float32))
    two = {"add": ta + tb, "sub": ta - tb, "mul6": 6.0 * tb,
           "mul4": 4.0 * tb, "mulpair": ta * tb, "rsub1": 1.0 - tb}[op].to(
        torch.bfloat16).float().double().numpy()
    same = (one == two) & (np.signbit(one) == np.signbit(two))
    assert same.all(), (a[ok][~same][:4], b[ok][~same][:4])


def test_packed_product_takes_only_bfloat16_coefficients():
    """stencil_taps.cuh's packed fmul multiplies in bf16x2 only where the
    coefficient is a bfloat16 value (its float's low 16 bits are zero)."""
    for c in (6.0, 4.0, 0.25, 2.0, -1.0, 1.0 / 6.0, 0.1, 0.15, 14 / 30,
              -1 / 12, 16 / 12):
        f = np.float32(c)
        low_zero = (f.view(np.uint32) & 0xFFFF) == 0
        exact = float(torch.tensor(c, dtype=torch.float32)
                      .to(torch.bfloat16)) == float(f)
        assert low_zero == exact


def test_special_bf16_blocks_hold_every_band():
    """The bfloat16 blocks of the card's bit-equality checks hold
    subnormals of both signs, +0 and -0, ones, 2^-8 (sums on ties) and
    ordinary values in [0, 1), the same for the same seed."""
    g = torch.Generator().manual_seed(5)
    x = compute_schedule.special_bf16((64, 65), g, "cpu")
    assert x.dtype == torch.bfloat16 and x.shape == (64, 65)
    f = x.float()
    tiny = torch.finfo(torch.bfloat16).tiny
    assert ((f > 0) & (f < tiny)).any() and ((f < 0) & (f > -tiny)).any()
    assert ((f == 0) & ~torch.signbit(f)).any()
    assert ((f == 0) & torch.signbit(f)).any()
    assert (f == 1.0).any() and (f == 2.0 ** -8).any()
    assert ((f > tiny) & (f < 1.0) & (f != 2.0 ** -8)).any()
    again = compute_schedule.special_bf16(
        (64, 65), torch.Generator().manual_seed(5), "cpu")
    assert torch.equal(x.view(torch.int16), again.view(torch.int16))


# --- K5 and K1 on march.cuh: u_prev and the raw grid ----------------------

WAVE_SCHEDULE = [((5, 4, 32 + r), (32, 3, 2)) for r in range(8)] + [
    ((6, 9, 37), (32, 4, 3)),     # runs that do not divide Z
    ((1, 1, 1), (32, 8, 4)),      # one plane, one row, one cell
    ((1, 9, 70), (64, 4, 3)),     # one plane
    ((7, 1, 33), (32, 4, 3)),     # one row
    ((8, 6, 64), (32, 2, 4))]     # runs that divide Z
WAVE_TYPES = [c + (dt,) for c in WAVE_SCHEDULE
              for dt in (torch.float32, torch.bfloat16)]


def _wave_block(st, shape, seed):
    g = torch.Generator().manual_seed(seed)
    padded = tuple(s + 2 for s in shape)
    return (torch.rand(padded, generator=g).to(st.dtype),
            torch.rand(shape, generator=g).to(st.dtype))


@pytest.mark.parametrize("shape,tile,dtype", WAVE_TYPES,
                         ids=[f"{'x'.join(map(str, s))}-{str(d)[6:]}"
                              for s, _, d in WAVE_TYPES])
def test_k5_schedule_with_uprev_is_the_plain_update(shape, tile, dtype):
    """K5's ring of padded planes on the committed slot count, with u_prev
    read by each cell's thread, == the plain wave update bit for bit, at
    every x residue mod 8, one plane, row and cell, and runs that do or do
    not divide Z."""
    st = make_stencil("wave3d", dtype=dtype)
    p, up = _wave_block(st, shape, 9)
    got = compute_schedule.run(st, p, kernels.Tile(256, 2, *tile),
                               kernels.ring_slots(1), up)
    ref = st.update((p, up))[0]
    assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_k5_schedule_races_on_a_ring_one_slot_short():
    st = make_stencil("wave3d")
    p, up = _wave_block(st, (7, 5, 37), 10)
    with pytest.raises(compute_schedule.Race):
        compute_schedule.run(st, p, kernels.Tile(256, 2, 32, 4, 3),
                             kernels.ring_slots(1) - 1, up)


def test_k5_tiles_take_the_z_queue():
    """Every K5 tile is a z-queue tile (one row a group: the thread that
    updates a cell loads its u_prev into registers) with K4's ring and no
    more shared memory."""
    wave = make_stencil("wave3d")
    heat = make_stencil("heat3d")
    tile = kernels.Tile(256, 2, 256, 8, 64, 1, True)
    assert kernels.tile_fits(wave, tile)
    assert kernels.march_geometry(wave, tile) == \
        kernels.march_geometry(heat, tile)
    assert not kernels.tile_fits(wave, kernels.Tile(256, 2, 256, 8, 64))
    assert kernels.tile_fits(heat, kernels.Tile(256, 2, 256, 8, 64))
    cands = kernels.candidates(wave)
    assert cands and all(t.zqueue for t in cands)


# K1: the raw grid, its frame pinned in the kernel.  Grids whose every
# tile touches a wall beside grids with interior tiles, every x residue
# mod 8, the smallest grid the step takes (one interior plane, row and
# cell) and runs that do or do not divide Z.
RAW_KINDS = [("heat3d", {}), ("heat3d27", {}), ("heat3d4th", {}),
             ("advect3d", {"cx": -0.3, "cy": 0.2, "cz": -0.25})]


def _raw_shapes(h):
    small = 2 * h + 1
    return [((2 * h + 3, 2 * h + 4, 24 + r), (16, 4, 3)) for r in range(8)] \
        + [((small, small, small), (32, 4, 2)),
           ((17, 13, 70), (16, 3, 5)),       # interior tiles and runs
           ((12, 11, 40), (32, 8, 4))]       # runs that divide Z


RAW_SCHEDULE = [(n, kw, shape, tile, dt) for n, kw in RAW_KINDS
                for shape, tile in _raw_shapes(2 if n == "heat3d4th" else 1)
                for dt in (torch.float32, torch.bfloat16)]


def _raw_grid(st, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(st.dtype)


@pytest.mark.parametrize("name,kw,shape,tile,dtype", RAW_SCHEDULE,
                         ids=[f"{n}-{'x'.join(map(str, s))}-{str(d)[6:]}"
                              for n, _, s, _, d in RAW_SCHEDULE])
def test_k1_raw_schedule_is_the_plain_step(name, kw, shape, tile, dtype):
    """K1 on the raw grid (clipped runs at z = 0 and z = Z, rows and cells
    clipped at the walls, frame cells keeping their value) on the
    committed slot count == the port's plain guard-frame step bit for
    bit."""
    st = make_stencil(name, dtype=dtype, **kw)
    u = _raw_grid(st, shape, 11)
    got = compute_schedule.run(st, u, kernels.Tile(256, 2, *tile),
                               kernels.ring_slots(st.halo), raw=True)
    ref = driver.make_step(st, shape)((u,))[0]
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("name,kw", RAW_KINDS, ids=[n for n, _ in RAW_KINDS])
def test_k1_raw_schedule_races_on_a_ring_one_slot_short(name, kw):
    st = make_stencil(name, **kw)
    h = st.halo
    u = _raw_grid(st, (4 * h + 9, 9, 37), 12)
    with pytest.raises(compute_schedule.Race):
        compute_schedule.run(st, u, kernels.Tile(256, 2, 32, 4, 6),
                             kernels.ring_slots(h) - 1, raw=True)


def _tol(ref, dtype):
    eps = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    return 32 * eps * max(float(np.abs(ref).max()), 1.0)


RAW_JAX = [(n, kw, dt) for n, kw in RAW_KINDS
           for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("name,kw,dtype", RAW_JAX,
                         ids=[f"{n}-{str(d)[6:]}" for n, _, d in RAW_JAX])
def test_k1_raw_schedule_matches_jax_make_raw_step(name, kw, dtype):
    """The replayed K1 step == the JAX package's make_raw_step (interpret)
    on the same seeded numpy grid, within the raw step's 32 eps max(|ref|,
    1), frame cells equal; a grid with interior tiles and ragged x."""
    shape = (16, 13, 45)
    jst = jmake_stencil(name, dtype=_JAX_TYPES[dtype], **kw)
    st = make_stencil(name, dtype=dtype, **kw)
    jstep = jrawstep.make_raw_step(jst, shape, interpret=True)
    assert jstep is not None
    a = np.random.default_rng(13).random(shape, dtype=np.float32)
    ref = np.asarray(jstep((jnp.asarray(a, _JAX_TYPES[dtype]),))[0],
                     dtype=np.float32)
    got = compute_schedule.run(st, torch.from_numpy(a).to(dtype),
                               kernels.Tile(256, 2, 16, 4, 5),
                               kernels.ring_slots(st.halo),
                               raw=True).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, dtype))
    frame = driver.frame_mask(shape, shape, (0, 0, 0), st.halo,
                              device="cpu").numpy()
    np.testing.assert_array_equal(got[frame], ref[frame])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_k5_schedule_matches_jax_wave3d_compute(monkeypatch, dtype):
    """The replayed K5 update == the JAX package's
    _wave3d_compute (interpret: one pallas_call built, no plain fallback)
    on the same seeded numpy block, within the compute_fn tolerance
    (float32 1e-6; bfloat16 32 eps max(|ref|, 1))."""
    built = []
    real = jpl.pallas_call

    def counting(*a, **kw):
        built.append(kw.get("interpret"))
        return real(*a, **kw)

    monkeypatch.setattr(jpl, "pallas_call", counting)
    shape = (8, 11, 37)
    jst = jmake_stencil("wave3d", dtype=_JAX_TYPES[dtype])
    st = make_stencil("wave3d", dtype=dtype)
    rng = np.random.default_rng(14)
    p = rng.random(tuple(s + 2 for s in shape), dtype=np.float32)
    up = rng.random(shape, dtype=np.float32)
    jt = _JAX_TYPES[dtype]
    ref = np.asarray(jkernels._wave3d_compute(jst, True)(
        (jnp.asarray(p, jt), jnp.asarray(up, jt)))[0], dtype=np.float32)
    assert built == [True]
    got = compute_schedule.run(
        st, torch.from_numpy(p).to(dtype), kernels.Tile(256, 2, 32, 4, 3),
        kernels.ring_slots(1), torch.from_numpy(up).to(dtype)
    ).float().numpy()
    atol = 1e-6 if dtype == torch.float32 else _tol(ref, dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# --- K2 and Gray-Scott on march.cuh: u_prev and two rings on the raw grid --

RAW_TWO = [(n, shape, tile, dt) for n in ("wave3d", "grayscott3d")
           for shape, tile in _raw_shapes(1)
           for dt in (torch.float32, torch.bfloat16)]


def _raw_fields(st, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(shape, generator=g).to(st.dtype)
                 for _ in range(st.num_fields))


def _replay_raw(st, fields, tile, slots):
    """The replayed K2 step (u_prev into registers; the new u_prev is the
    old u, kept by the caller) or Gray-Scott step (v on its own ring)."""
    if st.name == "wave3d":
        u, up = fields
        return (compute_schedule.run(st, u, tile, slots, up, raw=True), u)
    u, v = fields
    return compute_schedule.run(st, u, tile, slots, raw=True, second=v)


@pytest.mark.parametrize("name,shape,tile,dtype", RAW_TWO,
                         ids=[f"{n}-{'x'.join(map(str, s))}-{str(d)[6:]}"
                              for n, s, _, d in RAW_TWO])
def test_k2_and_grayscott_raw_schedules_are_the_plain_step(name, shape, tile,
                                                           dtype):
    """K2 (u_prev in registers) and Gray-Scott (a second ring for v, both
    fields' frame cells kept) on the raw grid, on the committed slot
    count == the port's plain guard-frame step bit for bit, both fields,
    at every x residue mod 8, the smallest grid and interior tiles."""
    st = make_stencil(name, dtype=dtype)
    fields = _raw_fields(st, shape, 21)
    got = _replay_raw(st, fields, kernels.Tile(256, 2, *tile),
                      kernels.ring_slots(1))
    ref = driver.make_step(st, shape)(fields)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("name", ["wave3d", "grayscott3d"])
def test_k2_and_grayscott_raw_schedules_race_on_a_ring_one_slot_short(name):
    st = make_stencil(name)
    fields = _raw_fields(st, (13, 9, 37), 22)
    with pytest.raises(compute_schedule.Race):
        _replay_raw(st, fields, kernels.Tile(256, 2, 32, 4, 6),
                    kernels.ring_slots(1) - 1)


RAW_TWO_JAX = [(n, dt) for n in ("wave3d", "grayscott3d")
               for dt in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("name,dtype", RAW_TWO_JAX,
                         ids=[f"{n}-{str(d)[6:]}" for n, d in RAW_TWO_JAX])
def test_k2_and_grayscott_raw_schedules_match_jax_make_raw_step(name,
                                                                dtype):
    """The replayed K2 and Gray-Scott steps == the JAX package's
    make_raw_step (interpret) on the same seeded numpy fields, within the
    raw step's 32 eps max(|ref|, 1), frame cells equal, both fields; a
    grid with interior tiles and ragged x."""
    shape = (16, 13, 45)
    jt = _JAX_TYPES[dtype]
    jst = jmake_stencil(name, dtype=jt)
    st = make_stencil(name, dtype=dtype)
    jstep = jrawstep.make_raw_step(jst, shape, interpret=True)
    assert jstep is not None
    rng = np.random.default_rng(24)
    arrays = [rng.random(shape, dtype=np.float32) for _ in range(2)]
    refs = [np.asarray(r, dtype=np.float32)
            for r in jstep(tuple(jnp.asarray(a, jt) for a in arrays))]
    gots = [g.float().numpy() for g in _replay_raw(
        st, tuple(torch.from_numpy(a).to(dtype) for a in arrays),
        kernels.Tile(256, 2, 16, 4, 5), kernels.ring_slots(1))]
    frame = driver.frame_mask(shape, shape, (0, 0, 0), 1,
                              device="cpu").numpy()
    for got, ref in zip(gots, refs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(ref, dtype))
        np.testing.assert_array_equal(got[frame], ref[frame])


def test_grayscott_tiles_size_both_rings():
    """Gray-Scott's rings take twice a one-field kind's shared memory (a
    ring and a row table for each field), and a tile whose two rings
    exceed one block's shared memory, or two blocks' share of an SM, is
    refused where the one-field kind's one ring fits."""
    gs = make_stencil("grayscott3d")
    heat = make_stencil("heat3d")
    assert march.fields(gs) == 2 and march.fields(heat) == 1
    assert march.fields(make_stencil("wave3d")) == 1
    fits = kernels.Tile(256, 2, 256, 16, 64)
    assert kernels.march_geometry(gs, fits).smem == \
        2 * kernels.march_geometry(heat, fits).smem
    assert kernels.tile_fits(heat, fits)
    assert kernels.march_geometry(gs, fits).smem <= _build.SMEM_LIMIT
    assert not kernels.tile_fits(gs, fits)      # two blocks an SM do not
    big = kernels.Tile(256, 2, 512, 16, 64)
    assert kernels.march_geometry(heat, big).smem <= _build.SMEM_LIMIT < \
        kernels.march_geometry(gs, big).smem
    assert not kernels.tile_fits(gs, big)       # one block does not
    # both fields' taps come from shared memory: no z queue
    assert not kernels.tile_fits(gs, kernels.Tile(256, 2, 256, 8, 64, 1,
                                                  True))
    cands = kernels.candidates(gs)
    assert cands and not any(t.zqueue for t in cands)
    assert all(kernels.march_geometry(gs, t).smem <= _build.SMEM_LIMIT
               for t in cands)
