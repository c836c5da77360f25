"""The cost model (``obs/costmodel.py``) against the JAX package's, and the
recorded exchange of the port's built steps against the analytic model.

* ``comm_stats`` dict for dict, every key, over the plain, padded,
  pad-free, stream and rdma kinds, z-only and 2 x 2 meshes, batch 1 and
  3, float32 and bfloat16, and wave3d's halo-0 ``u_prev``;
* ``hbm_bytes_per_step`` and every count key of ``static_cost`` (all but
  ``roofline``, which the port prices for the card, and the two
  cross-checks, which hold each package's own budget and kernel);
* ``step_flops`` for every stencil of the registry at two shapes, plain
  and periodic, with the pinned 98,304 / 393,216 / 18,432;
* ``budget_crosscheck`` ``match`` for config 5 on both mesh families, and
  ``coupled_cost``'s interface bytes against the port's budget parts;
* one recorded pass of every built sharded step kind on the CPU
  (``utils/launchcheck.py``) against ``comm_stats``: the shifts (two
  ppermute rounds each), the bytes and the ring launches; the in-process
  transport's byte count too; an ensemble's rounds independent of N;
* a CLI run's ``costmodel`` event and the three roofline gauges.

Tolerance: exact for every count, byte and flop.  The JAX package's
``step_flops`` and ``static_cost`` walk nested jaxprs through
``jax.core.ClosedJaxpr``, which this JAX release keeps under
``jax.extend.core``; the ``_jax_core_names`` fixture points the old names
there for the test's duration (the JAX package is not edited).
"""

import json
import math

import pytest
import torch

import jax
import jax.extend.core as jax_extend_core

from mpi_cuda_process_tpu import make_stencil as jmake_stencil
from mpi_cuda_process_tpu.obs import costmodel as jcost
from mpi_cuda_process_tpu.obs import metrics as jmetrics
from mpi_cuda_process_tpu.ops.stencil import (
    available_stencils as javailable)
from mpi_cuda_process_tpu.parallel import groups as jgroups

import mpi_cuda_process_tpu_torch as port
from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.obs import costmodel as tcost
from mpi_cuda_process_tpu_torch.obs import metrics as tmetrics
from mpi_cuda_process_tpu_torch.parallel import groups as tgroups
from mpi_cuda_process_tpu_torch.parallel import halo as thalo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.utils import budget as tbudget
from mpi_cuda_process_tpu_torch.utils import launchcheck
from mpi_cuda_process_tpu_torch.utils.init import init_state

torch.set_num_threads(1)

CPU = torch.device("cpu")
GRID = (32, 32, 128)


@pytest.fixture
def _jax_core_names(monkeypatch):
    for name in ("ClosedJaxpr", "Jaxpr", "Literal"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name,
                                getattr(jax_extend_core, name),
                                raising=False)


@pytest.fixture(autouse=True)
def _own_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _both(name, dtype="float32"):
    return jmake_stencil(name, dtype=dtype), port.make_stencil(name,
                                                               dtype=dtype)


# (fuse, fuse_kind, exchange) of every kind comm_stats prices
KINDS = {
    "plain": (0, "auto", "ppermute"),
    "padded": (4, "auto", "ppermute"),
    "padfree": (4, "padfree", "ppermute"),
    "stream": (4, "stream", "ppermute"),
    "rdma": (4, "stream", "rdma"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1)],
                         ids=["z", "2x2"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("name", ["heat3d", "wave3d"])
def test_comm_stats_equals_the_reference(name, kind, mesh, batch, dtype):
    """Every key, exact; wave3d's plain kind prices u_prev (halo 0) at
    nothing."""
    js, ts = _both(name, dtype)
    fuse, fuse_kind, exchange = KINDS[kind]
    want = jcost.comm_stats(js, GRID, mesh, fuse=fuse, fuse_kind=fuse_kind,
                            exchange=exchange, batch=batch)
    got = tcost.comm_stats(ts, GRID, mesh, fuse=fuse, fuse_kind=fuse_kind,
                           exchange=exchange, batch=batch)
    assert got == want
    assert got["kind"] == ("stream" if kind == "rdma" else kind)


@pytest.mark.parametrize("case", [
    ("heat3d", (16, 16, 128), 0, 1), ("heat3d", (16, 16, 128), 4, 1),
    ("wave3d", (8, 16, 128), 4, 3), ("grayscott3d", (8, 8, 128), 2, 2),
    ("heat2d", (32, 128), 0, 1), ("life", (32, 128), 8, 4)])
def test_hbm_bytes_per_step_equals_the_reference(case):
    name, local, fuse, batch = case
    js, ts = _both(name, "int32" if name == "life" else "float32")
    assert tcost.hbm_bytes_per_step(ts, local, fuse, batch) == \
        jcost.hbm_bytes_per_step(js, local, fuse, batch)


# static_cost keys left out of the parity: the roofline (the port prices
# the card, per card) and the cross-checks (each package's own budget and
# kernel: ROADMAP C)
_PRICED = ("roofline", "budget_crosscheck", "rdma_crosscheck")


@pytest.mark.parametrize("case", [
    dict(name="heat3d", mesh=(2, 1, 1)),
    dict(name="heat3d", mesh=(2, 2, 1), fuse=4, fuse_kind="stream"),
    dict(name="wave3d", mesh=(2, 2, 1), fuse=4, fuse_kind="padfree"),
    dict(name="heat3d", mesh=(2, 1, 1), fuse=4, fuse_kind="stream",
         exchange="rdma"),
    dict(name="heat3d", mesh=(2, 1, 1), fuse=4, ensemble=4,
         ensemble_mesh=2),
    dict(name="sor3d", mesh=(), fuse=2, periodic=True),
    dict(name="heat2d", grid=(64, 128), mesh=(2, 1)),
], ids=["plain", "stream-2x2", "padfree-wave", "rdma", "ensemble",
        "sor-periodic", "2d"])
def test_static_cost_counts_equal_the_reference(case, _jax_core_names):
    case = dict(case)
    name, grid = case.pop("name"), case.pop("grid", GRID)
    js, ts = _both(name)
    want = jcost.static_cost(js, grid, **case)
    got = tcost.static_cost(ts, grid, **case)
    assert set(got) == set(want)
    for key in want:
        if key not in _PRICED:
            assert got[key] == want[key], key
    roof = got["roofline"]
    assert set(roof) == set(want["roofline"])
    shards = max(1, case.get("ensemble_mesh", 0)) * math.prod(
        case.get("mesh") or (1,))
    assert roof["basis"]["shards_per_card"] == shards
    assert roof["basis"]["card"] == "H100 SXM"
    assert roof["predicted_ms_per_step_hbm"] == round(
        shards * got["hbm_bytes_per_step_per_device"] / 3.35e12 * 1e3, 6)


@pytest.mark.parametrize("periodic", [False, True], ids=["frame",
                                                          "periodic"])
@pytest.mark.parametrize("big", [False, True], ids=["small", "large"])
@pytest.mark.parametrize("name", sorted(port.available_stencils()))
def test_step_flops_equals_the_reference(name, big, periodic,
                                         _jax_core_names):
    """Every stencil of the registry, two shapes, exact."""
    assert sorted(port.available_stencils()) == sorted(javailable())
    js, ts = jmake_stencil(name), port.make_stencil(name)
    if ts.ndim == 3:
        shape = (16, 16, 128) if big else (8, 8, 128)
    else:
        shape = (32, 256) if big else (16, 128)
    assert tcost.step_flops(ts, shape, periodic=periodic) == \
        jcost.step_flops(js, shape, periodic=periodic)


def test_step_flops_pinned():
    """The reference's pinned values (tests/test_obs.py)."""
    h3 = port.make_stencil("heat3d")
    assert tcost.step_flops(h3, (8, 8, 128)) == 98_304
    assert tcost.step_flops(h3, (16, 16, 128)) == 393_216
    assert tcost.step_flops(port.make_stencil("life"), (16, 128)) == 18_432
    sc = tcost.static_cost(h3, (16, 16, 128), mesh=(2, 1, 1))
    assert sc["flops_per_step_per_device"] == \
        tcost.step_flops(h3, (8, 16, 128))
    assert sc["hbm_bytes_per_step_per_device"] == 2 * 8 * 16 * 128 * 4
    assert sc["comm"]["ppermute_rounds_per_pass"] == 2


@pytest.mark.parametrize("kind", ["stream", "padfree"])
@pytest.mark.parametrize("mesh", [(64, 1, 1), (8, 8, 1)],
                         ids=["z-ring", "balanced"])
def test_config5_budget_crosscheck_matches(mesh, kind):
    """Config 5 (wave3d 4096^3, k = 4): the port's operand bytes equal its
    budget's slab part on both mesh families, as the reference's do; on
    the balanced mesh the port's kernels read m-wide y operands (the
    reference widens them), so the two packages' budgets differ there."""
    js, ts = _both("wave3d")
    grid = (4096,) * 3
    got = tcost.budget_crosscheck(ts, grid, mesh, 4, kind)
    want = jcost.budget_crosscheck(js, grid, mesh, 4, kind)
    assert got["match"] is True and want["match"] is True
    assert got["slab_operand_bytes"] == want["slab_operand_bytes"]
    ici = tcost.comm_stats(ts, grid, mesh, fuse=4,
                           fuse_kind=kind)["ici_bytes_per_pass"]
    assert got["port_operand_bytes"] == got["budget_bytes"] == ici


@pytest.mark.parametrize("transport", ["device_put", "collective"])
def test_coupled_cost_interface_bytes_equal_the_budget_parts(
        transport, _jax_core_names):
    """tests/test_groups.py's cross-check on the port: bytes_per_round is
    the sum of the budget's band recv parts (device_put) or of its wire
    chunk parts (collective), and equals the reference's."""
    spec, grid = "wave3d:fine@0-3:z1/4:mesh1x4,heat3d:coarse@4-7:mesh1x4", \
        (24, 16, 16)
    plans = tgroups.plans_from_config(spec, grid, n_devices=8)
    cost = tcost.coupled_cost(plans, transport=transport)
    _, details = tbudget.estimate_coupled_bytes(plans, transport=transport)
    label = "band recv" if transport == "device_put" else "wire chunk"
    parts = sum(b for _, _, ps in details for lab, b in ps if label in lab)
    assert cost["interface"]["bytes_per_round"] == parts > 0
    want = jcost.coupled_cost(
        jgroups.plans_from_config(spec, grid, n_devices=8),
        transport=transport)
    for key in ("n_interfaces", "rounds_per_step", "transport",
                "bytes_per_round", "staged_bytes_per_round", "interfaces"):
        assert cost["interface"][key] == want["interface"][key], key
    assert [g["flops_per_step_per_device"] for g in cost["groups"]] == \
        [g["flops_per_step_per_device"] for g in want["groups"]]


# ---- the recorded exchange of one pass against comm_stats ---------------


def _mesh(shape):
    return tmesh.make_mesh(shape, [CPU] * math.prod(shape))


def _step(st, mesh, grid, fuse, kind, exchange, overlap, ensemble):
    if not fuse:
        return tstepper.make_sharded_step(st, mesh, grid, overlap=overlap,
                                          ensemble=ensemble)
    return tstepper.make_sharded_temporal_step(
        st, mesh, grid, fuse, kind=None if kind == "auto" else kind,
        overlap=overlap, exchange=exchange, ensemble=ensemble, device=CPU)


RECORDED = [
    # (stencil, grid, mesh, fuse, fuse_kind, exchange, overlap)
    ("heat3d", (16, 16, 128), (2, 2, 1), 0, "auto", "ppermute", False),
    ("wave3d", (16, 16, 128), (2, 2, 1), 0, "auto", "ppermute", False),
    ("heat3d", (16, 16, 128), (2, 1, 1), 0, "auto", "ppermute", True),
    ("heat3d", (32, 32, 128), (2, 2, 1), 4, "auto", "ppermute", False),
    ("heat3d", (32, 16, 128), (2, 1, 1), 4, "padfree", "ppermute", False),
    ("wave3d", (32, 32, 128), (2, 2, 1), 4, "padfree", "ppermute", False),
    ("heat3d", (48, 32, 128), (2, 2, 1), 4, "stream", "ppermute", False),
    ("heat3d", (48, 48, 128), (2, 2, 1), 4, "padfree", "ppermute", True),
    ("heat3d", (48, 48, 128), (2, 2, 1), 4, "stream", "ppermute", True),
    ("heat3d", (96, 32, 128), (2, 1, 1), 4, "stream", "rdma", False),
    ("heat3d", (48, 48, 128), (2, 2, 1), 4, "stream", "rdma", False),
    ("heat3d", (48, 48, 128), (2, 2, 1), 4, "stream", "rdma", True),
]


def _recorded_pass(case, ensemble=0):
    name, grid, mesh_shape, fuse, kind, exchange, overlap = case
    st = port.make_stencil(name)
    mesh = _mesh(mesh_shape)
    step = _step(st, mesh, grid, fuse, kind, exchange, overlap, ensemble)
    assert step is not None
    fields = tstepper.shard_fields(
        init_state(st, grid, seed=1, kind="pulse", device=CPU,
                   ensemble=ensemble), mesh, 3, ensemble=bool(ensemble))
    transport = thalo.default_transport(mesh)
    before = dict(transport.stats)
    with launchcheck.record() as rec:
        step(fields)
    moved = transport.stats["bytes"] - before["bytes"]
    return st, rec.records, moved, mesh.size


@pytest.mark.parametrize("case", RECORDED, ids=[
    f"{c[0]}-{c[4]}{'-rdma' if c[5] == 'rdma' else ''}"
    f"{'-overlap' if c[6] else ''}-{'x'.join(map(str, c[2][:2]))}"
    f"-k{c[3]}" for c in RECORDED])
def test_one_recorded_pass_has_the_modelled_exchange(case):
    """The counterpart of tests/test_obs.py:508-531 and
    tests/test_rdma_exchange.py:332: shifts x 2 = ppermute rounds, bytes
    = ici bytes (recorded per shard; the in-process transport's count
    over every shard), ring launches = rdma_exchange_calls_per_pass."""
    name, grid, mesh, fuse, kind, exchange, overlap = case
    st, records, moved, shards = _recorded_pass(case)
    want = tcost.comm_stats(st, grid, mesh, fuse=fuse, fuse_kind=kind,
                            exchange=exchange)
    got = launchcheck.exchange_counts(records)
    assert got["ppermute_rounds"] == want["ppermute_rounds_per_pass"]
    assert got["ici_bytes"] == want["ici_bytes_per_pass"]
    if exchange == "rdma":
        assert got["ring_calls"] == want["rdma_exchange_calls_per_pass"]
        assert moved == 0
    else:
        assert got["ring_calls"] == 0
        assert moved == shards * want["ici_bytes_per_pass"]


@pytest.mark.parametrize("case", [RECORDED[6], RECORDED[9]],
                         ids=["stream", "rdma"])
def test_ensemble_rounds_independent_of_members_bytes_scale(case):
    """tests/test_ensemble_engine.py:454's pin, recorded: N = 3 posts the
    same rounds as one member, each carrying 3 members' bytes."""
    _, grid, mesh, fuse, kind, exchange, _ = case
    st, one, _, _ = _recorded_pass(case)
    _, three, _, _ = _recorded_pass(case, ensemble=3)
    c1, c3 = (launchcheck.exchange_counts(r) for r in (one, three))
    assert c3["posts"] == c1["posts"] > 0
    assert c3["ring_calls"] == c1["ring_calls"]
    assert c3["ici_bytes"] == 3 * c1["ici_bytes"]
    want = tcost.comm_stats(st, grid, mesh, fuse=fuse, fuse_kind=kind,
                            exchange=exchange, batch=3)
    assert c3["ici_bytes"] == want["ici_bytes_per_pass"]


def test_2d_fullgrid_recorded_pass_matches_the_model():
    """The 2D row split (K8's sharded mode): one width-m row shift a
    field, as the padded kind's model prices it."""
    st = port.make_stencil("heat2d")
    mesh = _mesh((2, 1))
    step = tstepper.make_sharded_temporal_step(st, mesh, (64, 128), 8,
                                               device=CPU)
    fields = tstepper.shard_fields(
        init_state(st, (64, 128), seed=1, device=CPU), mesh, 2)
    with launchcheck.record() as rec:
        step(fields)
    got = launchcheck.exchange_counts(rec.records)
    want = tcost.comm_stats(st, (64, 128), (2, 1), fuse=8)
    assert got["ppermute_rounds"] == want["ppermute_rounds_per_pass"] == 2
    assert got["ici_bytes"] == want["ici_bytes_per_pass"]


# ---- the CLI's costmodel event and the console's roofline gauges ---------


def test_cli_run_writes_one_costmodel_event_and_sets_the_gauges(
        tmp_path, monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    log = str(tmp_path / "run.jsonl")
    tcli.run(tcli.config_from_args([
        "--stencil", "heat3d", "--grid", "32,32,64", "--iters", "16",
        "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
        "--log-every", "4", "--telemetry", log, "--device", "cpu"]))
    recs = [json.loads(line) for line in open(log) if line.strip()]
    cost = [r for r in recs if r["kind"] == "costmodel"]
    assert len(cost) == 1
    roof = cost[0]["roofline"]
    assert roof["basis"]["shards_per_card"] == 4
    assert roof["basis"]["link"] == "hbm"
    assert roof["hbm_gbs"] == 3350.0
    st = port.make_stencil("heat3d")
    assert cost[0]["comm"] == tcost.comm_stats(st, (32, 32, 64), (2, 2),
                                               fuse=4, fuse_kind="stream")
    for mod in (tmetrics, jmetrics):
        rm = mod.RunMetrics()
        for r in recs:
            rm.ingest(r)
        text = rm.registry.to_prometheus()
        for gauge in ("obs_predicted_ms_per_step_overlapped",
                      "obs_predicted_ms_per_step_serial",
                      "obs_roofline_gap_ratio"):
            assert any(line.startswith(gauge + " ")
                       for line in text.splitlines()), (mod, gauge)
        assert rm.status()["roofline"] == roof


@pytest.mark.parametrize("name,grid,mesh", [
    ("heat3d", (48, 16, 128), (2, 1, 1)),
    ("heat3d", (48, 48, 128), (2, 2, 1)),
    ("wave3d", (48, 48, 128), (2, 2, 1))], ids=["z", "2x2", "wave-2x2"])
def test_overlapped_padded_kind_exchanges_the_slab_set(name, grid, mesh):
    """The port's overlapped padded kind feeds its shells from the 2-axis
    slab set (``halo.post_slabs_2axis``), where the reference's
    re-exchanges the padded blocks: the same bytes as the model, and on a
    mesh that shards y two corner shifts a field more than its two-pass
    rounds (ROADMAP C)."""
    case = (name, grid, mesh, 4, "auto", "ppermute", True)
    st, records, _, _ = _recorded_pass(case)
    want = tcost.comm_stats(st, grid, mesh, fuse=4)
    got = launchcheck.exchange_counts(records)
    assert got["ici_bytes"] == want["ici_bytes_per_pass"]
    corners = 4 * st.num_fields if mesh[1] > 1 else 0
    assert got["ppermute_rounds"] == want["ppermute_rounds_per_pass"] \
        + corners
