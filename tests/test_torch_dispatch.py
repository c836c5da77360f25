"""``--compute auto``: the port's dispatch tables and the rules that apply
them (``cli.maybe_auto_fuse``, ``cli.resolve_raw_step``,
``cli.resolve_compute_fn``), held on the CPU.

The tables name paths measured fastest on an H100
(``scripts/torch_dispatch_times.py``, PERF.md section 5), so auto applies
only to a run on a card: the decisions are taken here on ``device="cuda"``
configs and never build a kernel (the kernel modules' ``_lib`` loaders are
stubbed where a decision constructs a step).  Held here:

* every entry names a family whose kernel takes it, at every measured size
  and in every dtype the entry covers;
* on a card, auto takes each entry's path, and the memory guard prices it;
* auto stays on the plain path, and never raises for a kernel, where the
  kernel or the run refuses: float16, a cadence k does not divide,
  ``--debug-checks``, ``--check-finite`` off the multiple, ``--periodic``,
  ``--resume``, ``--tol``, a mesh, a forced kind, Life in a float dtype;
* a ``"stream"`` kind probes the streaming kernel (K10) and falls back to
  the window kernel's probe when its rings do not fit;
* each decision, run on the CPU (the kernels' plain versions), computes
  what the JAX package's plain step computes from the same seeded fields.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.config import RunConfig as JRunConfig
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.utils.init import init_state as jinit_state

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.config import RunConfig
from mpi_cuda_process_tpu_torch.ops.cuda import fullgrid as tfullgrid
from mpi_cuda_process_tpu_torch.ops.cuda import fused as tfused
from mpi_cuda_process_tpu_torch.ops.cuda import kernels as tkernels
from mpi_cuda_process_tpu_torch.ops.cuda import rawstep as trawstep
from mpi_cuda_process_tpu_torch.ops.cuda import streamfused as tstream
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import budget as tbudget

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
# the sizes the tables were measured at
SIZES_3D = ((256,) * 3, (512,) * 3, (1024,) * 3)
SIZES_2D = ((512, 512), (16384, 16384))
CONFIG1_ITERS = 1000


def _st(name, dtype=None):
    cfg = RunConfig(stencil=name, dtype=dtype)
    return tcli._make_cfg_stencil(cfg)


def _card(name, grid, **kw):
    kw.setdefault("iters", 96)
    return RunConfig(stencil=name, grid=tuple(grid), device="cuda", **kw)


def _dtypes(name):
    return (None,) if _st(name).dtype == torch.int32 else ("float32",
                                                          "bfloat16")


@pytest.fixture
def no_build(monkeypatch):
    """Builders that would compile a kernel for a card run do nothing."""
    for mod in (trawstep, tkernels, tfused, tstream, tfullgrid):
        monkeypatch.setattr(mod, "_lib", lambda: None)
    monkeypatch.setattr(tkernels, "_lib2d", lambda: None)


# ---- the filled tables ------------------------------------------------------

TABLES = ["_RAW_WINS", "_AUTO_FUSE_K",
          "_AUTO_FUSE_K_BF16", "_AUTO_FULL_K", "_COMPUTE_FN_WINS"]


@pytest.mark.parametrize("table", TABLES)
def test_every_entry_names_a_family_its_kernel_accepts(table):
    entries = getattr(tcli, table)
    for name in entries:
        if table == "_RAW_WINS":
            for dt in ("float32", "bfloat16"):
                st = _st(name, dt)
                assert trawstep.raw_step_supported(st)
                for g in SIZES_3D:
                    assert trawstep.make_raw_step(st, g) is not None
        elif table in ("_AUTO_FUSE_K", "_AUTO_FUSE_K_BF16"):
            st = _st(name, "float32" if table == "_AUTO_FUSE_K"
                     else "bfloat16")
            k = entries[name]
            stream = tcli._AUTO_FUSE_KIND.get(name) == "stream"
            for g in SIZES_3D:
                make = (tstream.make_stream_fused_step if stream
                        else tfused.make_fused_step)
                assert make(st, g, k) is not None, (name, g, k)
        elif table == "_AUTO_FULL_K":
            k = entries[name]
            assert CONFIG1_ITERS % k == 0
            for dt in _dtypes(name):
                st = _st(name, dt)
                for g in SIZES_2D:
                    assert tfullgrid.make_fullgrid_step(st, g, k) is not None
        else:
            assert tkernels.has_pallas_kernel(name)
            assert entries[name] and entries[name] <= {"mesh", "single"}
            for dt in _dtypes(name):
                pallas = RunConfig(stencil=name, dtype=dt, compute="pallas")
                assert tcli._dtype_refusal(pallas, _st(name, dt), True) \
                    is None
    assert set(tcli._AUTO_FUSE_KIND) <= set(tcli._AUTO_FUSE_K) | set(
        tcli._AUTO_FUSE_K_BF16)
    assert set(tcli._AUTO_FUSE_KIND.values()) <= {"stream"}


def _entries():
    """(table, stencil, dtype) of every entry, for the per-entry tests."""
    out = []
    for name in sorted(tcli._RAW_WINS):
        out += [("raw", name, dt) for dt in ("float32", "bfloat16")]
    out += [("fuse", n, "float32") for n in sorted(tcli._AUTO_FUSE_K)]
    out += [("fuse", n, "bfloat16") for n in sorted(tcli._AUTO_FUSE_K_BF16)]
    for name in sorted(tcli._AUTO_FULL_K):
        out += [("full", name, dt) for dt in _dtypes(name)]
    for name in sorted(tcli._COMPUTE_FN_WINS):
        out += [(f"compute_fn_{place}", name, dt) for dt in _dtypes(name)
                for place in sorted(tcli._COMPUTE_FN_WINS[name])]
    return out


ENTRIES = _entries()


def _grid(kind, name):
    return (512, 512) if kind == "full" or _st(name).ndim == 2 \
        else (512, 512, 512)


@pytest.mark.parametrize("kind,name,dtype", ENTRIES,
                         ids=[f"{k}-{n}-{d}" for k, n, d in ENTRIES])
def test_auto_takes_each_entry_on_a_card(no_build, kind, name, dtype):
    cfg = _card(name, _grid(kind, name), dtype=dtype,
                iters=CONFIG1_ITERS if kind == "full" else 96)
    st = tcli._make_cfg_stencil(cfg)
    up = tcli.maybe_auto_fuse(cfg)
    if kind == "fuse":
        table = (tcli._AUTO_FUSE_K if st.dtype == torch.float32
                 else tcli._AUTO_FUSE_K_BF16)
        assert up.fuse == table[name]
        assert up.fuse_kind == tcli._AUTO_FUSE_KIND.get(name, "auto")
    elif kind == "full":
        assert up.fuse == tcli._AUTO_FULL_K[name]
    elif kind == "raw":
        assert up is cfg or up.fuse  # a fuse entry of the dtype wins first
        if up is cfg:
            assert tcli.resolve_raw_step(cfg, st) is not None
    elif kind == "compute_fn_mesh":
        mesh = dataclasses.replace(
            cfg, mesh=(2, 2) if st.ndim == 3 else (4,))
        assert tcli.maybe_auto_fuse(mesh) is mesh
        assert tcli.resolve_compute_fn(mesh, st) is not None
    else:
        # unsharded: 3D under --periodic, 2D where K8's k does not divide
        # the cadence
        one = dataclasses.replace(cfg, periodic=st.ndim == 3, iters=97)
        assert tcli.maybe_auto_fuse(one) is one
        assert tcli.resolve_raw_step(one, st) is None
        assert tcli.resolve_compute_fn(one, st) is not None


@pytest.mark.parametrize("kind,name,dtype", ENTRIES,
                         ids=[f"{k}-{n}-{d}" for k, n, d in ENTRIES])
def test_mem_check_prices_the_auto_path(monkeypatch, kind, name, dtype):
    seen = {}

    def check_budget(st, grid, **kw):
        seen.update(kw)
        return 0, []

    monkeypatch.setattr(tbudget, "check_budget", check_budget)
    cfg = tcli.maybe_auto_fuse(_card(
        name, _grid(kind, name), dtype=dtype,
        iters=CONFIG1_ITERS if kind == "full" else 96))
    tcli._check_mem_budget(cfg, tcli._make_cfg_stencil(cfg), None)
    assert seen["fuse"] == cfg.fuse
    if kind == "raw" and not cfg.fuse:
        assert seen["compute"] == "raw"


# ---- where auto stays plain -------------------------------------------------

@pytest.fixture
def tables(monkeypatch):
    """One entry of every table (independent of the measured data)."""
    monkeypatch.setattr(tcli, "_AUTO_FUSE_K", {"heat3d": 4, "sor3d": 4})
    monkeypatch.setattr(tcli, "_AUTO_FUSE_K_BF16", {"heat3d": 8})
    monkeypatch.setattr(tcli, "_AUTO_FUSE_KIND", {})
    monkeypatch.setattr(tcli, "_AUTO_FULL_K", {"life": 8, "heat2d": 8})
    monkeypatch.setattr(tcli, "_RAW_WINS", frozenset({"heat3d"}))
    monkeypatch.setattr(tcli, "_COMPUTE_FN_WINS",
                        {"heat3d": frozenset({"mesh", "single"}),
                         "life": frozenset({"mesh"})})


STAYS = [
    ("float16", "heat3d", dict(dtype="float16")),
    ("iters", "heat3d", dict(iters=98)),
    ("log_every", "heat3d", dict(log_every=6)),
    ("checkpoint_every", "heat3d", dict(checkpoint_every=6,
                                        checkpoint_dir="d")),
    ("check_finite", "heat3d", dict(check_finite=6)),
    ("dump_every", "heat3d", dict(dump_every=6, dump_dir="d")),
    ("debug_checks", "heat3d", dict(debug_checks=True)),
    ("periodic", "heat3d", dict(periodic=True)),
    ("resume", "heat3d", dict(resume=True, checkpoint_dir="d")),
    ("tol", "sor3d", dict(tol=1e-3)),
    ("mesh", "heat3d", dict(mesh=(2, 2))),
    ("mesh_of_one", "heat3d", dict(mesh=(1,))),
    ("forced_kind", "heat3d", dict(fuse_kind="stream")),
    ("compute_jnp", "heat3d", dict(compute="jnp")),
    ("compute_pallas", "heat3d", dict(compute="pallas")),
    ("cpu", "heat3d", dict(device="cpu")),
    ("life_float32", "life", dict(dtype="float32")),
    ("life_iters", "life", dict(iters=1001)),
    ("heat2d_float16", "heat2d", dict(dtype="float16")),
]


@pytest.mark.parametrize("why,name,kw", STAYS, ids=[s[0] for s in STAYS])
def test_auto_never_upgrades_a_refused_run(tables, why, name, kw):
    grid = (512, 512) if name in ("life", "heat2d") else (256, 256, 256)
    cfg = dataclasses.replace(_card(name, grid, iters=96), **kw)
    assert tcli.maybe_auto_fuse(cfg) is cfg


@pytest.mark.parametrize("dtype", ["float16", None])
def test_raw_and_compute_fn_auto_take_only_their_dtypes(tables, dtype):
    """float16 stays plain under auto (B1/B2 refuse it only when forced);
    a family the raw table lacks stays plain."""
    st = _st("heat3d", dtype)
    cfg = _card("heat3d", (256, 256, 256), dtype=dtype)
    assert tcli._raw_eligible(cfg, st) == (dtype is None)
    mesh = dataclasses.replace(cfg, mesh=(2, 2))
    assert tcli._compute_fn_auto(mesh, st) == (dtype is None)
    assert not tcli._compute_fn_auto(cfg, st)  # unsharded, guard-frame
    assert not tcli._raw_eligible(dataclasses.replace(cfg, device="cpu"), st)
    assert not tcli._raw_eligible(_card("wave3d", (512, 512, 512),
                                        dtype=dtype), _st("wave3d", dtype))
    life = _card("life", (512, 512), dtype="float32", mesh=(4,))
    assert not tcli._compute_fn_auto(life, _st("life", "float32"))
    assert tcli._compute_fn_auto(dataclasses.replace(life, dtype=None),
                                 _st("life"))
    # a placement the table does not name stays plain
    assert not tcli._compute_fn_auto(_card("life", (512, 512)), _st("life"))
    assert tcli._compute_fn_auto(
        dataclasses.replace(cfg, periodic=True), st) == (dtype is None)


def test_stream_entry_probes_k10(tables, monkeypatch):
    monkeypatch.setattr(tcli, "_AUTO_FUSE_KIND", {"heat3d": "stream"})
    probed = []
    real = tstream.make_stream_fused_step

    def spy(st, grid, k, **kw):
        probed.append((st.name, tuple(grid), k))
        return real(st, grid, k, **kw)

    monkeypatch.setattr(tstream, "make_stream_fused_step", spy)
    cfg = _card("heat3d", (256, 256, 256))
    up = tcli.maybe_auto_fuse(cfg)
    assert probed == [("heat3d", (256, 256, 256), 4)]
    assert (up.fuse, up.fuse_kind) == (4, "stream")
    # rings that do not fit: the window kernel's probe, its kind
    monkeypatch.setattr(tstream, "make_stream_fused_step",
                        lambda *a, **kw: None)
    up = tcli.maybe_auto_fuse(cfg)
    assert (up.fuse, up.fuse_kind) == (4, "auto")


def test_bf16_run_reads_the_bf16_table(tables):
    up = tcli.maybe_auto_fuse(_card("heat3d", (256, 256, 256),
                                    dtype="bfloat16"))
    assert up.fuse == 8
    # no bf16 entry: the float32 table is not read for bfloat16
    cfg = _card("sor3d", (256, 256, 256), dtype="bfloat16")
    assert tcli.maybe_auto_fuse(cfg) is cfg


def test_full_k_upgrades_on_the_cadence(tables):
    cfg = _card("life", (512, 512), iters=CONFIG1_ITERS)
    assert tcli.maybe_auto_fuse(cfg).fuse == 8
    mdf = _card("mdf", (512, 512), iters=CONFIG1_ITERS)
    assert tcli.maybe_auto_fuse(mdf).fuse == 8  # mdf runs heat2d's


# ---- the decisions compute the plain step -----------------------------------

def _small(name):
    return (24, 32) if _st(name).ndim == 2 else (16, 16, 32)


@pytest.mark.parametrize("kind,name,dtype", ENTRIES,
                         ids=[f"{k}-{n}-{d}" for k, n, d in ENTRIES])
def test_decision_matches_the_jax_plain_step(monkeypatch, no_build, kind,
                                             name, dtype):
    """Each decision, taken on a card config and run on the CPU, holds to
    the JAX package's plain run of the same seeded command."""
    from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh

    grid = _small(name)
    iters = 16
    mesh, periodic = (), False
    if kind == "compute_fn_mesh":
        mesh = (2, 2) if len(grid) == 3 else (4,)
        monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    elif kind == "compute_fn_single":
        periodic, iters = len(grid) == 3, 15
    cfg = tcli.maybe_auto_fuse(_card(name, grid, iters=iters, dtype=dtype,
                                     mesh=mesh, periodic=periodic, seed=3))
    st = tcli._make_cfg_stencil(cfg)
    if kind.startswith("compute_fn"):
        assert tcli._compute_fn_auto(cfg, st)
    elif kind == "raw" and not cfg.fuse:
        assert tcli._raw_eligible(cfg, st)
    else:
        assert cfg.fuse
    flags = dict(stencil=name, grid=grid, iters=iters, dtype=dtype,
                 mesh=mesh, periodic=periodic, seed=3)
    explicit = dataclasses.replace(
        cfg, device="cpu", compute="auto" if cfg.fuse else "pallas")
    got, _ = tcli.run(explicit)
    if tstepper.is_sharded(got):
        got = tstepper.gather_fields(got, device="cpu")
    if periodic and st.name == "wave3d":
        # the JAX CLI cannot run it (its pulse init hands one array in as
        # u and u_prev, and its runner donates both): the JAX step it
        # would run, from the same init (tests/test_torch_cli.py)
        jst = jmake_stencil(name, **({"dtype": jnp.dtype(dtype)}
                                     if dtype else {}))
        step = jdriver.make_step(jst, grid, periodic=True)
        want = jinit_state(jst, grid, 3, 0.15, "auto", periodic=True)
        for _ in range(iters):
            want = step(want)
    else:
        want, _ = jcli.run(JRunConfig(compute="jnp", **flags))
    for g, w in zip(got, want):
        g = g.float().numpy() if g.is_floating_point() else g.numpy()
        w = np.asarray(w).astype(g.dtype)
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
            continue
        scale = max(float(np.abs(w).max()), 1.0)
        if dtype == "bfloat16":
            # the reference's bf16 rule for a whole run (test_torch_bf16)
            atol = 32 * 2.0 ** -7 * scale
        elif cfg.fuse:
            atol = max(1e-4, 32 * EPS32 * scale)
        else:
            atol = 32 * EPS32 * scale * iters
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
