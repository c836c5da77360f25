"""Device groups (ROADMAP A7): the port's ``parallel/groups.py`` against the
JAX package's, on 8 virtual CPU devices.

The same ``--groups`` strings go through both packages:

* the grammar and the plans: every named rejection of tests/test_groups.py
  raises the same message in the port, and ``describe()``, the mode views
  and ``groups_signature`` agree;
* the face resampling: ``restrict`` / ``interpolate`` are bit-equal to the
  JAX package's on seeded inputs in float32, bfloat16 and float16, and
  ``restrict(interpolate(x)) == x`` bitwise;
* same-physics splits assemble bit for bit to the port's monolithic plain
  run (on the CPU every kernel wrapper takes its plain version), under both
  transports, and the two transports give the same bits group by group;
  against the JAX package's ``CoupledRunner`` (plain and ``:overlap``
  splits) and its iterated plain ``make_step`` (the fused splits: JAX marks
  its own fused coupled runs slow) they agree to the port's usual
  tolerances: float32 ``atol = 1e-4`` (the two packages' plain float32
  steps differ in the last place, tests/test_torch_cli.py), bfloat16
  ``32 eps max(|ref|, 1)``;
* the heterogeneous demo (README's, ``HET_GROUPS`` on ``HET_GRID``): the
  port's runner from the JAX package's initial fields
  (``interop.coupled_from_numpy``) and from its own init, against JAX's
  per-group fields and ``assemble()`` after 4 rounds; the port's group init
  equals its own whole-grid init sliced bit for bit, and JAX's
  ``_init_group`` (the zero kind bit for bit, the Gaussian pulse within
  the init tolerance of tests/test_torch_sharded.py: the two exps differ in
  the last place);
* the collective transport's wire: exactly 2 shifts an interface a round,
  no device_put column (the port's form of the JAX package's
  ``assert_group_transport_structure``); a mismatched y-shard interface is
  refused with the JAX message;
* the coupled budget: each group's interface terms equal the JAX
  package's, its run term is the port's ``estimate_run_bytes``, and groups
  on one card are summed.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_cuda_process_tpu import init_state as jinit_state
from mpi_cuda_process_tpu import make_runner as jmake_runner
from mpi_cuda_process_tpu import make_step as jmake_step
from mpi_cuda_process_tpu import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.config import groups_signature as jsignature
from mpi_cuda_process_tpu.parallel import groups as jgroups
from mpi_cuda_process_tpu.utils import budget as jbudget

from mpi_cuda_process_tpu_torch import driver as tdriver
from mpi_cuda_process_tpu_torch import interop
from mpi_cuda_process_tpu_torch import make_stencil as tmake_stencil
from mpi_cuda_process_tpu_torch.config import groups_signature as tsignature
from mpi_cuda_process_tpu_torch.parallel import groups as tgroups
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import init as tinit

torch.set_num_threads(1)

HET_GROUPS = "wave3d:fine@0-3:z1/4:mesh1x4,heat3d:coarse@4-7:mesh1x4"
HET_GRID = (24, 16, 16)
EPS_BF16 = 2.0 ** -7


@pytest.fixture(autouse=True)
def _eight_devices(monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, bf16=False):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = _np32(g), _np32(r)
        assert g.shape == r.shape
        tol = 32 * EPS_BF16 * max(float(np.abs(r).max()), 1.0) if bf16 \
            else 1e-4
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _port_runner(spec, grid, dtype=None, transport="device_put"):
    plans = tgroups.plans_from_config(spec, grid, default_dtype=dtype,
                                      n_devices=8)
    return tgroups.CoupledRunner(plans, transport=transport, device="cpu")


def _jax_runner(spec, grid, dtype=None, transport="device_put"):
    plans = jgroups.plans_from_config(spec, grid, default_dtype=dtype,
                                      n_devices=8)
    return jgroups.CoupledRunner(plans, transport=transport)


def _raises_alike(fn_jax, fn_port, exc=ValueError):
    with pytest.raises(exc) as je:
        fn_jax()
    with pytest.raises(exc) as te:
        fn_port()
    assert str(te.value) == str(je.value)
    return str(te.value)


# ------------------------------------------------------------ the grammar

@pytest.mark.parametrize("spec,n_devices,match", [
    ("heat3d@0-7", None, "at least 2"),
    ("heat3d,wave3d@4-7", None, "does not match"),
    ("heat3d:fast@0-3,heat3d@4-7", None, "unknown qualifier"),
    ("heat3d:fine3@0-3,heat3d@4-7", None, "power of two"),
    ("heat3d@3-0,heat3d@4-7", None, "descending"),
    ("heat3d@0-2,heat3d@4-7", None, "contiguous"),
    ("heat3d@1-3,heat3d@4-7", None, "start at device 0"),
    ("heat3d@0-3:z3/2,heat3d@4-7", None, "z-fraction"),
    ("heat3d@0-3:mesh2x4,heat3d@4-7", None, "mesh .* needs"),
    ("heat3d@0-3,heat3d@4-11", 8, "only 8 device"),
    ("heat3d@0-3:stream+warp,heat3d@4-7", None, "unknown mode word"),
    ("heat3d@0-3:fuse1,heat3d@4-7", None, "fuse1 is the plain stepper"),
    ("heat3d@0-3:fusex,heat3d@4-7", None, "bad fuse token"),
    ("heat3d@0-3:stream+padfree,heat3d@4-7", None, "mutually exclusive"),
    ("heat3d@0-3:plain+overlap,heat3d@4-7", None, "cannot combine"),
    ("heat3d@0-3:pipeline,heat3d@4-7", None, "pipeline needs fuse"),
    ("heat3d@0-3:overlap+overlap,heat3d@4-7", None, "duplicate mode word"),
    ("heat3d@0-3:stream:overlap,heat3d@4-7", None, "more than one mode"),
    ("heat3d@0-3:meshx,heat3d@4-7", None, "bad mesh spec"),
    ("heat3d@0-3:zz,heat3d@4-7", None, "bad z-fraction"),
    ("heat3d@0-3:q1,heat3d@4-7", None, "unknown suffix"),
])
def test_parse_groups_named_rejections_match_jax(spec, n_devices, match):
    msg = _raises_alike(
        lambda: jgroups.parse_groups(spec, n_devices=n_devices),
        lambda: tgroups.parse_groups(spec, n_devices=n_devices))
    assert re.search(match, msg)


@pytest.mark.parametrize("spec,grid,match", [
    ("heat3d@0-3:z1/16,heat3d:fine8@4-7", (16, 16, 16),
     "fewer than its own ghost"),
    ("heat3d@0-3:fuse4,heat3d@4-7:fuse2", (56, 16, 16),
     "fuse factors .* differ"),
    ("heat3d@0-3:z1/3,heat3d@4-7:z1/3", (30, 16, 16), "must sum"),
    ("heat3d@0-3:z1/7,heat3d@4-7", (30, 16, 16), "not an integer"),
    ("heat3d@0-3,heat2d@4-7", (30, 16, 16), "mixes 3D and 2D"),
    ("heat3d@0-3:mesh1x1x2x2,heat3d@4-7", (30, 16, 16), "more axes"),
])
def test_plan_rejections_match_jax(spec, grid, match):
    msg = _raises_alike(
        lambda: jgroups.plans_from_config(spec, grid, n_devices=8),
        lambda: tgroups.plans_from_config(spec, grid, n_devices=8))
    assert re.search(match, msg)


@pytest.mark.parametrize("spec,grid,dtype", [
    (HET_GROUPS, HET_GRID, None),
    ("heat3d@0-3:overlap,heat3d@4-7", (30, 16, 16), None),
    ("heat3d@0-3:overlap+stream+fuse4,heat3d@4-7:fuse4", (56, 16, 16),
     None),
    ("heat3d@0-1:mesh1x2,heat3d@2-5:mesh2x2,heat3d@6-7:mesh1x2",
     (30, 16, 16), None),
    ("wave3d:fine:bf16@0-3:z1/4:mesh1x4,heat3d:coarse@4-7:mesh1x4",
     HET_GRID, None),
    ("heat2d@0-1,heat2d:fine4@2-3:z1/2", (32, 16), "float32"),
])
def test_plans_describe_and_signature_match_jax(spec, grid, dtype):
    jp = jgroups.plans_from_config(spec, grid, default_dtype=dtype,
                                   n_devices=8)
    tp = tgroups.plans_from_config(spec, grid, default_dtype=dtype,
                                   n_devices=8)
    assert [p.describe() for p in tp] == [p.describe() for p in jp]
    for a, b in zip(tp, jp):
        assert (a.owned_z, a.cells, a.owned_cells, a.name) == \
            (b.owned_z, b.cells, b.owned_cells, b.name)
        assert (a.spec.fuse_k, a.spec.kind, a.spec.overlap_mode,
                a.spec.pipeline_mode) == (b.spec.fuse_k, b.spec.kind,
                                          b.spec.overlap_mode,
                                          b.spec.pipeline_mode)
    assert tgroups.interface_traffic(tp) == jgroups.interface_traffic(jp)
    assert tsignature(spec) == jsignature(spec)
    assert tsignature(" " + spec.replace(",", " , ")) == tsignature(spec)


def test_mode_tokens_canonical_and_views():
    pg = tgroups.parse_groups
    s = pg("heat3d@0-3:overlap+stream+fuse4,heat3d@4-7")[0]
    assert s.modes == ("fuse4", "stream", "overlap")
    assert s.fuse_k == 4 and s.kind == "stream" and s.overlap_mode
    assert not s.pipeline_mode
    assert s.canonical() == "heat3d@0-3:fuse4+stream+overlap"
    assert pg(s.canonical() + ",heat3d@4-7")[0] == s
    t = pg("heat3d@0-3,heat3d@4-7")[0].with_modes(("overlap", "stream"))
    assert t.modes == ("stream", "overlap")
    assert tsignature("heat3d@0-3:overlap,heat3d@4-7") != \
        tsignature("heat3d@0-3,heat3d@4-7")
    assert tgroups.MODE_WORDS == jgroups.MODE_WORDS
    assert tgroups.MODE_CANDIDATES == jgroups.MODE_CANDIDATES
    assert tgroups.TRANSPORTS == jgroups.TRANSPORTS
    assert tgroups.TRANSPORT_BACKEND == jgroups.TRANSPORT_BACKEND


# ------------------------------------------------------- face resampling

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("factor", [2, 4])
def test_restrict_interpolate_bit_equal_jax(dtype, factor):
    rng = np.random.default_rng(7 + factor)
    base = jnp.asarray(rng.standard_normal((8, 8, 16)), dtype)
    host = np.asarray(base)
    x = interop.fields_from_numpy([host], device="cpu", dtype=dtype)[0]
    for jfn, tfn in ((jgroups.restrict, tgroups.restrict),
                     (jgroups.interpolate, tgroups.interpolate)):
        ref = np.asarray(jfn(base, factor))
        got = interop.fields_to_numpy((tfn(x, factor),))[0]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert got.tobytes() == ref.tobytes()
    # the conservation pin
    back = tgroups.restrict(tgroups.interpolate(x, factor), factor)
    assert torch.equal(back, x)
    with pytest.raises(ValueError, match="power of two"):
        tgroups.restrict(torch.zeros((6, 6)), 3)


# --------------------------------------------------- same-physics splits

SPLITS = [
    # (op, spec, grid, rounds, dtype, k, against JAX's CoupledRunner)
    ("heat3d", "heat3d@0-3,heat3d@4-7", (30, 16, 16), 6, None, 1, True),
    ("wave3d", "wave3d@0-3,wave3d@4-7", (30, 16, 16), 6, None, 1, True),
    ("heat3d", "heat3d:bf16@0-3,heat3d:bf16@4-7", (30, 16, 16), 6,
     "bfloat16", 1, True),
    ("heat3d", "heat3d@0-3:mesh2x2,heat3d@4-7:mesh2x2", (30, 16, 16), 6,
     None, 1, True),
    ("heat3d", "heat3d@0-1:mesh1x2,heat3d@2-5:mesh2x2,heat3d@6-7:mesh1x2",
     (30, 16, 16), 4, None, 1, True),
    ("heat3d", "heat3d@0-3:overlap,heat3d@4-7", (30, 16, 16), 6, None, 1,
     True),
    ("heat3d", "heat3d@0-3:z1/2:fuse4:mesh1x4,heat3d@4-7:fuse4:mesh1x4",
     (56, 32, 16), 2, None, 4, False),
    ("heat3d",
     "heat3d@0-3:fuse4+stream:mesh2x2,heat3d@4-7:fuse4+stream:mesh2x2",
     (88, 32, 128), 2, None, 4, False),
    ("heat3d", "heat3d@0-3:fuse4+padfree:mesh4,heat3d@4-7:fuse4+padfree",
     (56, 16, 16), 2, None, 4, False),
    ("heat3d",
     "heat3d@0-3:fuse4+stream+overlap:mesh2x2,"
     "heat3d@4-7:fuse4+padfree+pipeline:mesh2x2", (88, 32, 128), 2,
     None, 4, False),
    ("heat2d", "heat2d@0-3:fuse4,heat2d@4-7:fuse4", (64, 32), 2, None, 4,
     False),
]


def _port_monolithic(op, grid, steps, dtype):
    st = tmake_stencil(op, **({"dtype": dtype} if dtype else {}))
    fields = tinit.init_state(st, grid, device="cpu")
    step = tdriver.make_step(st, grid)
    for _ in range(steps):
        fields = step(fields)
    return fields


def _jax_monolithic(op, grid, steps, dtype):
    st = jmake_stencil(op, **({"dtype": dtype} if dtype else {}))
    ref = tuple(jnp.copy(f) for f in jinit_state(st, grid, kind="auto"))
    step1 = jmake_runner(jmake_step(st, grid), 1)
    for _ in range(steps):
        ref = step1(ref)
    return ref


@pytest.mark.parametrize(
    "op,spec,grid,rounds,dtype,k,jax_coupled", SPLITS,
    ids=[s[1] for s in SPLITS])
def test_same_physics_split_bit_equal_and_matches_jax(
        op, spec, grid, rounds, dtype, k, jax_coupled):
    runners = {}
    for transport in tgroups.TRANSPORTS:
        r = _port_runner(spec, grid, dtype, transport)
        r.run(rounds)
        runners[transport] = r
    dput, coll = runners["device_put"], runners["collective"]
    # the two transports: the same bits, group by group
    for a, b in zip(dput.fields, coll.fields):
        _same(tdriver_gather(a), tdriver_gather(b))
    n_iface = dput.n_groups - 1
    assert coll.stats == {"shifts": 2 * n_iface * rounds, "device_puts": 0}
    assert dput.stats["shifts"] == 0 and dput.stats["device_puts"] > 0
    got = dput.assemble()
    _same(got, _port_monolithic(op, grid, rounds * k, dtype))
    bf16 = dtype == "bfloat16"
    if jax_coupled:
        jr = _jax_runner(spec, grid, dtype)
        jr.run(rounds)
        _close(got, jr.assemble(), bf16)
    else:
        _close(got, _jax_monolithic(op, grid, rounds * k, dtype), bf16)


def tdriver_gather(fields):
    from mpi_cuda_process_tpu_torch.parallel import stepper

    return stepper.gather_fields(fields, device="cpu")


def test_wave_fused_split_is_the_reference_coupling_not_monolithic():
    """wave3d under ``fuseK``: the band's ``u_prev`` rows are not carried
    (``field_halos`` 0: one step never reads them across cells), yet the
    k micro-steps of a round read them at the band's inner rows, so the
    rows next to the interface leave the monolithic run's values in both
    packages alike.  The port computes what the JAX package computes:
    held to its ``CoupledRunner`` (K3's padded kind there in interpret
    mode, the plain versions here), both off the monolithic run by the
    same rows (ROADMAP C, reference-side)."""
    spec, grid = "wave3d@0-3:fuse4:mesh4,wave3d@4-7:fuse4", (56, 16, 16)
    r = _port_runner(spec, grid)
    r.run(2)
    jr = _jax_runner(spec, grid)
    jr.run(2)
    got = r.assemble()
    _close(got, jr.assemble())
    mono = _port_monolithic("wave3d", grid, 8, None)
    off = (got[0] - mono[0]).abs().amax(dim=(1, 2)).nonzero().flatten()
    assert off.tolist() and all(24 <= z < 32 for z in off.tolist())
    jmono = _jax_monolithic("wave3d", grid, 8, None)
    joff = np.nonzero(np.abs(np.asarray(jr.assemble()[0])
                             - np.asarray(jmono[0])).max(axis=(1, 2))
                      > 1e-4)[0]
    assert set(joff.tolist()) <= set(off.tolist()) and len(joff)


def test_step_kinds_name_the_kernels_each_group_takes():
    """Which ported kernel each mode routes a group to: the padded kind
    (K3 sharded), the slab kinds (K6 zslab, K9 yzslab, K10 stream_z /
    stream_yz), the plain step; a one-device group takes the sharded
    kinds on a mesh of one (never the unsharded streaming kernel)."""
    r = _port_runner(
        "heat3d@0:fuse4,heat3d@1-2:fuse4+padfree,heat3d@3-4:fuse4+padfree"
        ":mesh1x2,heat3d@5:fuse4+stream,heat3d@6-7:fuse4+stream:mesh1x2",
        (80, 16, 16))
    assert r.step_kinds() == ["padded", "zslab", "yzslab", "stream_z",
                              "stream_yz"]
    assert r.sharded_group_indices() == [1, 2, 4]
    assert _port_runner("heat3d@0-3,heat3d@4-7",
                        (30, 16, 16)).step_kinds() == ["plain", "plain"]


# ------------------------------------------------ the heterogeneous demo

@pytest.mark.parametrize("spec,bf16", [
    (HET_GROUPS, False),
    ("wave3d:fine:bf16@0-3:z1/4:mesh1x4,heat3d:coarse@4-7:mesh1x4", True),
])
def test_hetero_demo_matches_jax(spec, bf16):
    jr = _jax_runner(spec, HET_GRID)
    init = [[np.asarray(jax.device_get(f)) for f in fs] for fs in jr.fields]
    own = _port_runner(spec, HET_GRID)
    # the group init: the port's whole-grid init sliced, bit for bit, and
    # JAX's _init_group (zero kind bit for bit, the pulse to the init
    # tolerance)
    for p, fs, ref in zip(own.plans, own.fields, init):
        r = p.spec.ratio
        whole = tinit.init_state(
            p.stencil, (HET_GRID[0] * r,) + tuple(p.grid[1:]),
            device="cpu")
        z0 = p.base_z0 * r - p.band_lo
        mine = tdriver_gather(fs)
        _same(mine, tuple(w[z0:z0 + p.grid[0]] for w in whole))
        for a, b in zip(interop.fields_to_numpy(mine), ref):
            if tinit.resolve_kind(p.stencil, "auto") == "zero":
                assert a.tobytes() == b.tobytes()
            else:
                np.testing.assert_allclose(
                    np.asarray(a, np.float32), np.asarray(b, np.float32),
                    rtol=1e-6, atol=1e-7)
    fed = _port_runner(spec, HET_GRID)
    interop.coupled_from_numpy(fed, init)
    for r in (own, fed):
        r.run(4)
    jr.run(4)
    for r in (own, fed):
        _close(r.assemble(), jr.assemble(), bf16)
        for fs, jfs in zip(r.fields, jr.fields):
            # an f32 group fed by a bf16 one takes the bf16 tolerance too
            _close(tdriver_gather(fs), jfs, bf16)
    # the transports: the same bits on a ratio'd mixed-physics interface
    coll = _port_runner(spec, HET_GRID, transport="collective")
    interop.coupled_from_numpy(coll, init)
    coll.run(4)
    for a, b in zip(fed.fields, coll.fields):
        _same(tdriver_gather(a), tdriver_gather(b))
    assert coll.stats["shifts"] == 2 * 4
    # cell-updates: at least 2x fewer than refining everywhere
    assert 8 * int(np.prod(HET_GRID)) >= 2 * own.cell_updates_per_round()


# ------------------------------------------------------ refusals by name

def test_collective_refusals_and_unknown_transport_match_jax():
    spec, grid = "heat3d@0-3:mesh1x4,heat3d@4-7:mesh2x2", (30, 16, 16)
    msg = _raises_alike(
        lambda: _jax_runner(spec, grid, transport="collective"),
        lambda: _port_runner(spec, grid, transport="collective"))
    assert "SAME y-shard count" in msg
    # the device_put transport cuts the band again along y instead
    r = _port_runner(spec, grid)
    r.run(3)
    _same(r.assemble(), _port_monolithic("heat3d", grid, 3, None))
    _raises_alike(
        lambda: _jax_runner("heat3d@0-3,heat3d@4-7", grid, transport="bogus"),
        lambda: _port_runner("heat3d@0-3,heat3d@4-7", grid,
                             transport="bogus"))
    # edge z-shards too thin for the band's rows
    spec = "heat3d@0-3:mesh4,heat3d@4-7:mesh4"
    msg = _raises_alike(
        lambda: _jax_runner(spec, (6, 16, 16), transport="collective"),
        lambda: _port_runner(spec, (6, 16, 16), transport="collective"))
    assert "fewer z-shards" in msg


def test_declined_forced_mode_raises_and_tpu_only_declines_run():
    """A forced mode the port's builder declines raises the JAX message
    (a local z extent below the k-step margin: both packages decline).
    The JAX package's own example declines for its streaming kernel's
    3-chunk floor (a TPU tiling rule, local z 12); the port's K10 takes
    that shape and runs it bit-equal to the monolithic run (ROADMAP C:
    the port runs what the JAX package refuses for TPU reasons)."""
    spec = "heat3d@0-3:fuse4+stream:mesh4x1,heat3d@4-7:fuse4+stream:mesh4x1"
    msg = _raises_alike(lambda: _jax_runner(spec, (16, 16, 128)),
                        lambda: _port_runner(spec, (16, 16, 128)))
    assert "forced modes never fall back silently" in msg
    spec = "heat3d@0-3:fuse4+stream:mesh2x2,heat3d@4-7:fuse4+stream:mesh2x2"
    with pytest.raises(ValueError, match="forced modes never fall back"):
        _jax_runner(spec, (40, 32, 128))
    r = _port_runner(spec, (40, 32, 128))
    r.run(1)
    _same(r.assemble(), _port_monolithic("heat3d", (40, 32, 128), 4, None))


# ------------------------------------------------------- the budget

@pytest.mark.parametrize("transport", ["device_put", "collective"])
@pytest.mark.parametrize("spec,grid", [
    (HET_GROUPS, HET_GRID),
    ("heat3d@0-1:z127/256:fuse4+stream:mesh1x2,"
     "heat3d@2-3:fuse4+stream:mesh1x2", (256, 64, 64)),
    ("heat3d@0-1:mesh1x2,heat3d@2-5:mesh2x2,heat3d@6-7:mesh1x2",
     (30, 16, 16)),
])
def test_coupled_budget_matches_jax_terms_and_sums_a_card(spec, grid,
                                                          transport):
    tp = tgroups.plans_from_config(spec, grid, n_devices=8)
    jp = jgroups.plans_from_config(spec, grid, n_devices=8)
    _, jdetails = jbudget.estimate_coupled_bytes(jp, transport=transport)
    worst, details = tbudget.estimate_coupled_bytes(tp, transport=transport)
    assert [d[0] for d in details] == [d[0] for d in jdetails]
    for p, (_, total, parts), (_, _, jparts) in zip(tp, details, jdetails):
        iface = [x for x in parts if x[0].startswith("interface")]
        jiface = [x for x in jparts if x[0].startswith("interface")]
        assert iface == jiface and iface
        s = p.spec
        run, _ = tbudget.estimate_run_bytes(
            p.stencil, p.grid, mesh=p.mesh_shape,
            fuse=s.fuse_k if s.fuse_k > 1 else 0, fuse_kind=s.kind or "auto",
            overlap=s.overlap_mode, pipeline=s.pipeline_mode)
        assert total == run + sum(b for _, b in iface)
    # every group on its own cards: the worst group, as in the JAX package
    assert worst == max(d[1] for d in details)
    # every group's devices the one card: the card holds all of them
    card = [[torch.device("cpu")] * p.spec.n_devices for p in tp]
    summed, by_group = tbudget.estimate_coupled_bytes(
        tp, transport=transport, devices=card)
    assert summed == sum(d[1] for d in by_group)
    assert summed > worst
    with pytest.raises(ValueError, match="groups on one card need"):
        tbudget.check_coupled_budget(tp, hbm_bytes=summed - 1,
                                     transport=transport, devices=card)
    assert tbudget.check_coupled_budget(
        tp, hbm_bytes=summed, transport=transport, devices=card)[0] == summed
