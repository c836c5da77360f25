"""The port's campaign ledger (``obs/ledger.py``) against the JAX package's.

* ``classify``, ``make_row``, ``validate_row``, ``baseline_key`` and
  ``best_known`` give the reference's results dict for dict (only
  ``ingested_at`` differs), over every quarantine reason, every
  baseline-key tail and shuffled row orders;
* ``rows_from_log`` on the port CLI's log of a command gives the rows the
  reference gives on its own CLI's log of the same command (a sharded
  stream run, an ensemble, device groups with their per-group rows, a
  resumed run, a ``numerics`` fault that ends DIVERGED): label, baseline
  key, flags, grid, mesh, kind, dtype, unit, status, quarantine reason
  and detail equal; ``builder_rev`` (None in the port: no measurement
  harness) and the measured value differ by design;
* the port's default ledger is its own file, never the reference's
  committed ``benchmarks/ledger.jsonl``; ``ingest`` and ``best`` run as
  ``python -m mpi_cuda_process_tpu_torch.obs.ledger``;
* seeding: from the same ledger rows the port's ``--anomaly`` monitor
  picks the row the JAX ``_make_anomaly_monitor`` picks, and the flight
  bundle records it.
"""

import contextlib
import dataclasses
import io
import json
import os
import random
import types

import pytest

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.obs import flightrec as jflightrec
from mpi_cuda_process_tpu.obs import ledger as jledger
from mpi_cuda_process_tpu.resilience import faults as jfaults

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.obs import flightrec as tflightrec
from mpi_cuda_process_tpu_torch.obs import ledger as tledger
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _own_dirs(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_LEDGER_PATH", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("OBS_TELEMETRY_DIR", str(tmp_path / "tel"))


def _strip(row):
    return {k: v for k, v in row.items() if k != "ingested_at"}


# ------------------------------------------------------------ functions

@pytest.mark.parametrize("kw", [
    dict(value=12.5),
    dict(value=12.5, cancelled=True, error="boom"),
    dict(value=12.5, error="RuntimeError: " + "x" * 300),
    dict(value=12.5, stale=True),
    dict(value=12.5, suspect=True),
    dict(value=12.5, backend="cpu", expected_backend="cuda"),
    dict(value=12.5, backend="cuda", expected_backend="cuda"),
    dict(value=12.5, health="DIVERGED", heartbeat="WEDGED"),
    dict(value=12.5, health="HEALTHY"),
    dict(value=12.5, heartbeat="WEDGED"),
    dict(value=12.5, heartbeat="STALLED"),
    dict(value=12.5, heartbeat="RECOVERED"),
    dict(value=0.0),
    dict(value=None),
    dict(value="fast"),
    dict(value=-1),
], ids=["ok", "cancelled", "errored", "stale", "suspect", "mismatch",
        "match", "diverged", "healthy", "wedged", "stalled", "recovered",
        "zero", "missing", "string", "negative"])
def test_classify_and_make_row_match_the_reference(kw):
    value = kw.pop("value")
    assert tledger.classify(value, **kw) == jledger.classify(value, **kw)
    key_kw = dict(grid=(16, 16, 32), mesh=(2, 2), kind="stream",
                  dtype="float32", flags={"fuse": 4}, builder_rev=None)
    a = tledger.make_row("cli_x", value, source="s", ms_per_step=1.5,
                         measured_at=1e9, detail={"d": 1}, **kw, **key_kw)
    b = jledger.make_row("cli_x", value, source="s", ms_per_step=1.5,
                         measured_at=1e9, detail={"d": 1}, **kw, **key_kw)
    assert _strip(a) == _strip(b)
    assert a["key_id"] == b["key_id"]


_GOOD = jledger.make_row("cli_x", 3.0, source="s", expected_backend="cpu")


@pytest.mark.parametrize("bad", [
    "not a row",
    {**_GOOD, "schema": 2},
    {**_GOOD, "kind": "row", "label": ""},
    {**_GOOD, "key": [], "status": "maybe"},
    {**_GOOD, "value": 0},
    {**_GOOD, "status": "quarantined", "quarantine": None},
    {**_GOOD, "source": "", "ingested_at": 0},
], ids=["type", "schema", "kind_label", "key_status", "ok_zero",
        "no_reason", "source_time"])
def test_validate_row_gives_the_reference_problems(bad):
    with pytest.raises(ValueError) as je:
        jledger.validate_row(bad)
    with pytest.raises(ValueError) as te:
        tledger.validate_row(bad)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("flags", [
    None,
    {"fuse": 4, "fuse_kind": "stream"},
    {"exchange": "rdma"},
    {"ensemble": 8, "ensemble_mesh": 2},
    {"kernel_variant": "v3"},
    {"groups_sig": "abc123"},
    {"groups_sig": "abc123", "group_transport": "collective"},
    {"exchange": "rdma", "ensemble": 2, "kernel_variant": "v1",
     "groups_sig": "g", "group_transport": "collective"},
], ids=["plain", "fuse", "exchange", "ens", "var", "grp", "gtx", "all"])
@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_baseline_key_tails_match_the_reference(flags, backend):
    kw = dict(source="s", expected_backend=backend, flags=flags)
    t = tledger.make_row("cli_heat3d", 2.0, **kw)
    j = jledger.make_row("cli_heat3d", 2.0, **kw)
    assert tledger.baseline_key(t) == jledger.baseline_key(j)
    assert tledger.baseline_key(t).startswith(f"cli_heat3d|{backend}")


def _row_set():
    rows = []
    for i, (label, backend, value, t) in enumerate([
            ("a", "cuda", 10.0, 5.0), ("a", "cuda", 10.0, 5.0),
            ("a", "cuda", 10.0, 7.0), ("a", "cuda", 9.0, 9.0),
            ("a", "cpu", 1.0, 1.0), ("a", "cpu", 0.0, 2.0),
            ("b", "cuda", 4.0, 3.0), ("b", "cuda", 4.0, 3.0)]):
        rows.append(jledger.make_row(
            label, value, source=f"src{i % 3}", measured_at=t,
            expected_backend=backend, grid=(8, 8, 8 + i % 2)))
    rows.append(jledger.make_row("b", 50.0, source="q", heartbeat="WEDGED",
                                 expected_backend="cuda"))
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_best_known_tie_break_is_the_reference_order(seed):
    rows = _row_set()
    random.Random(seed).shuffle(rows)
    t, j = tledger.best_known(rows), jledger.best_known(rows)
    assert {k: _strip(v) for k, v in t.items()} == \
        {k: _strip(v) for k, v in j.items()}
    # a function of the row set, not of its order; quarantine never wins
    assert {k: v["key_id"] + v["source"] for k, v in t.items()} == \
        {k: v["key_id"] + v["source"]
         for k, v in tledger.best_known(_row_set()).items()}
    assert t["b|cuda"]["value"] == 4.0 and t["a|cpu"]["value"] == 1.0


@pytest.mark.parametrize("run", [
    dict(stencil="heat3d", grid=(1024, 1024, 1024), mesh=(2, 2), fuse=4,
         fuse_kind="stream", exchange="rdma", overlap=True, pipeline=True,
         dtype="bfloat16"),
    dict(stencil="wave3d", grid=(32, 32, 64), ensemble=8, ensemble_mesh=2,
         exchange="ppermute", fuse_kind="auto"),
    dict(stencil="heat3d", grid=(30, 16, 16),
         groups="heat3d@0-3, heat3d@4-7", group_transport="collective"),
    dict(stencil="life", grid=(64, 128)),
], ids=["stream", "ensemble", "groups", "plain"])
def test_label_and_flags_match_the_reference(run):
    assert tledger._cli_label(run) == jledger._cli_label(run)
    assert tledger._flags(run) == jledger._flags(run)
    assert tledger.group_flags("heat3d@0-3", "collective") == \
        jledger.group_flags("heat3d@0-3", "collective")


def test_append_is_idempotent_and_a_corrupt_line_is_loud(tmp_path):
    path = str(tmp_path / "l.jsonl")
    rows = _row_set()
    n = tledger.append_rows(rows, path)
    assert n == len({jledger._row_uid(r) for r in rows})
    assert tledger.append_rows(rows, path) == 0
    assert [r["key_id"] for r in tledger.read_rows(path)] == \
        [r["key_id"] for r in jledger.read_rows(path)]
    with open(path, "a") as fh:
        fh.write('{"schema": 1}\n')
    with pytest.raises(ValueError, match=rf"l.jsonl:{n + 1}: invalid"):
        tledger.read_rows(path)


def test_default_path_is_the_port_own(tmp_path, monkeypatch):
    assert tledger.default_ledger_path() == str(tmp_path / "ledger.jsonl")
    monkeypatch.delenv("OBS_LEDGER_PATH")
    assert tledger.default_ledger_path() == str(
        tmp_path / "tel" / "ledger_torch.jsonl")
    monkeypatch.delenv("OBS_TELEMETRY_DIR")
    path = tledger.default_ledger_path()
    assert path == os.path.join(_REPO, ".telemetry", "ledger_torch.jsonl")
    assert path != os.path.join(_REPO, "benchmarks", "ledger.jsonl")
    assert ttrace.default_telemetry_dir() == os.path.join(_REPO,
                                                          ".telemetry")


# ------------------------------------------------------- rows_from_log

_KEY = ("label", "backend", "grid", "mesh", "kind", "dtype", "flags")


def _comparable(row, ledger):
    return {"baseline_key": ledger.baseline_key(row),
            **{k: row["key"][k] for k in _KEY},
            **{k: row.get(k) for k in ("unit", "status", "quarantine",
                                       "detail", "heartbeat", "health")}}


def _both_logs(tmp_path, monkeypatch, argv, name="run"):
    """The JAX CLI's and the port CLI's logs of ``argv`` (each package's
    SimulationDiverged re-raised as itself)."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    # the reference's costmodel event has no port counterpart yet
    monkeypatch.setattr(jcli, "_emit_static_cost", lambda *a: None)
    paths = []
    for pkg, cli, extra in (("j", jcli, []), ("t", tcli, ["--device",
                                                         "cpu"])):
        path = str(tmp_path / f"{name}_{pkg}.jsonl")
        ck = ["--checkpoint-dir", str(tmp_path / f"ck_{pkg}")]
        cli.run(cli.config_from_args(argv + extra + ck
                                     + ["--telemetry", path]))
        paths.append(path)
    return paths


def _held(jp, tp):
    jrows, trows = jledger.rows_from_log(jp), tledger.rows_from_log(tp)
    assert [_comparable(r, jledger) for r in jrows] == \
        [_comparable(r, tledger) for r in trows]
    for r in trows:
        assert r["key"]["builder_rev"] is None
        assert r["provenance"]["backend"] == "cpu"
        assert {"torch_version", "cuda_version", "nvidia_smi",
                "device_kind"} <= set(r["provenance"])
    return trows


@pytest.mark.parametrize("argv", [
    ["--stencil", "heat3d", "--grid", "48,32,128", "--iters", "8",
     "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
     "--log-every", "4", "--anomaly"],
    ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
     "--ensemble", "2", "--log-every", "4", "--health"],
    ["--stencil", "heat3d", "--grid", "30,16,16", "--iters", "4",
     "--groups", "heat3d@0-3,heat3d@4-7", "--log-every", "2"],
], ids=["stream", "ensemble", "groups"])
def test_rows_from_log_match_the_reference(argv, tmp_path, monkeypatch):
    jp, tp = _both_logs(tmp_path, monkeypatch, argv)
    rows = _held(jp, tp)
    assert rows[-1]["status"] == "ok" and rows[-1]["value"] > 0
    if "--groups" in argv:
        assert [r["label"] for r in rows] == ["cli_grp_heat3d"] * 2 + \
            ["cli_heat3d_30x16x16_grp2"]
        assert rows[0]["detail"]["clause"] == "heat3d@0-3"


def test_resumed_rows_match_the_reference(tmp_path, monkeypatch):
    argv = ["--stencil", "heat3d", "--grid", "8,8,16", "--log-every", "2",
            "--checkpoint-every", "2"]
    _both_logs(tmp_path, monkeypatch, argv + ["--iters", "4"], "first")
    jp, tp = _both_logs(tmp_path, monkeypatch,
                        argv + ["--iters", "8", "--resume"], "resumed")
    rows = _held(jp, tp)
    assert rows[0]["detail"] == {"resumed_from_step": 4}


def test_diverged_rows_match_the_reference(tmp_path, monkeypatch):
    argv = ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8",
            "--log-every", "2", "--health"]
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    monkeypatch.setattr(jcli, "_emit_static_cost", lambda *a: None)
    monkeypatch.setenv("FAULT_INJECT", "numerics:step=3:nan")
    paths = []
    for name, cli, faults, extra in (
            ("j", jcli, jfaults, []),
            ("t", tcli, tfaults, ["--device", "cpu"])):
        faults.reset()
        path = str(tmp_path / f"{name}.jsonl")
        with pytest.raises(Exception) as e:
            cli.run(cli.config_from_args(argv + extra
                                         + ["--telemetry", path]))
        assert type(e.value).__name__ == "SimulationDiverged"
        faults.reset()
        paths.append(path)
    rows = _held(*paths)
    assert len(rows) == 1 and rows[0]["status"] == "quarantined"
    assert rows[0]["quarantine"] == "diverged" and rows[0]["value"] is None
    assert "field 0" in rows[0]["detail"]["health_reason"]


def test_a_jax_log_is_refused_by_name(tmp_path, monkeypatch):
    monkeypatch.setattr(jcli, "_emit_static_cost", lambda *a: None)
    jp = str(tmp_path / "j.jsonl")
    jcli.run(jcli.config_from_args(
        ["--stencil", "heat2d", "--grid", "16,16", "--iters", "2",
         "--telemetry", jp]))
    with pytest.raises(ValueError, match="not a port telemetry log.*"
                       "torch_version.*TPU package"):
        tledger.rows_from_log(jp)


def test_ingest_and_best_subcommands(tmp_path):
    log = str(tmp_path / "run.jsonl")
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "4",
         "--device", "cpu", "--telemetry", log]))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tledger.main(["ingest", log]) == 0
        assert tledger.main(["ingest", log]) == 0
        assert tledger.main(["best"]) == 0
    text = out.getvalue().splitlines()
    assert text[0].startswith("ledger ingest: 1 rows appended")
    assert text[1].startswith("ledger ingest: 0 rows appended")
    assert text[2].startswith(f"# {tmp_path / 'ledger.jsonl'}: 1 rows "
                              "(0 quarantined), 1 baselines")
    assert text[3].startswith("cli_heat3d_8x8x16|cpu ")
    assert f"src=telemetry:{log}" in text[3]


# ------------------------------------------------------------- seeding

def _seed_rows(label_run):
    """A ledger where the right row is neither the fastest overall nor
    the newest: the same label on another backend, a quarantined faster
    row, another label, and two rows on this key."""
    label = jledger._cli_label(label_run)
    flags = jledger._flags(label_run) or None
    return [
        jledger.make_row(label, 900.0, source="cuda-row",
                         expected_backend="cuda", flags=flags),
        jledger.make_row(label, 800.0, source="wedged", heartbeat="WEDGED",
                         expected_backend="cpu", flags=flags),
        jledger.make_row("cli_other", 700.0, source="other",
                         expected_backend="cpu"),
        jledger.make_row(label, 5.0, source="the-best", measured_at=1.0,
                         expected_backend="cpu", flags=flags),
        jledger.make_row(label, 4.0, source="older", measured_at=2.0,
                         expected_backend="cpu", flags=flags),
    ]


@pytest.mark.parametrize("argv", [
    ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8"],
    ["--stencil", "heat3d", "--grid", "48,32,128", "--iters", "8",
     "--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
     "--exchange", "rdma"],
], ids=["plain", "stream-rdma"])
def test_anomaly_seeding_and_bundle_pick_the_reference_row(argv, tmp_path):
    jcfg = jcli.config_from_args(argv + ["--anomaly"])
    tcfg = tcli.config_from_args(argv + ["--anomaly", "--device", "cpu"])
    run = dataclasses.asdict(tcfg)
    rows = _seed_rows(run)
    tledger.append_rows(rows)
    session = types.SimpleNamespace(trace=None, spans=None,
                                    recorder=types.SimpleNamespace())
    jmon = jcli._make_anomaly_monitor(jcfg, session, 1000)
    tcli._attach_anomaly(tcfg, session, 1000)
    tmon = session.recorder.anomaly
    assert (tmon.best_source, tmon.best_value) == \
        (jmon.best_source, jmon.best_value) == ("the-best", 5.0)
    manifest = {"tool": "cli", "run": run, "provenance": {"backend": "cpu"}}
    got = tflightrec._best_known_for(manifest)
    assert _strip(got) == _strip(jflightrec._best_known_for(manifest))
    assert got["source"] == "the-best"
    # no matching key (another backend) and no ledger: None, no raise
    assert tflightrec._best_known_for(
        {**manifest, "provenance": {"backend": "rocm"}}) is None
    os.remove(tledger.default_ledger_path())
    assert tflightrec._best_known_for(manifest) is None


def test_a_diverged_run_bundle_records_its_row(tmp_path, monkeypatch):
    """A run that ends with a bundle (an error) records the ledger row
    of its own label on its own backend."""
    argv = ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8",
            "--log-every", "2", "--health", "--device", "cpu"]
    cfg = tcli.config_from_args(argv)
    tledger.append_rows(_seed_rows(dataclasses.asdict(cfg)))
    log = str(tmp_path / "d.jsonl")
    monkeypatch.setenv("FAULT_INJECT", "numerics:step=3:nan")
    tfaults.reset()
    with pytest.raises(Exception):
        tcli.run(tcli.config_from_args(argv + ["--telemetry", log]))
    tfaults.reset()
    bundle = tflightrec.read_bundle(str(tmp_path / "d.bundle.json"))
    assert bundle["verdict"] == "DIVERGED"
    assert bundle["best_known"]["source"] == "the-best"
    json.dumps(bundle)
