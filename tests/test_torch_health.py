"""The numerics sentinel and the exchange audit: the port's
``obs/health.py`` against the JAX package's.

* ``make_health_fn`` on the same seeded numpy fields (with NaN and Inf
  cells planted) for heat3d, wave3d, sor3d, life, grayscott2d and mdf, in
  float32 and bfloat16 (Life in its int32), unbatched and as an ensemble
  of 3: min, max, the nonfinite count and Life's population exact; the
  mean and the invariants within ``rtol=1e-5`` (the sums run in another
  order);
* the same fields as ``ShardedField`` s on 2x2 (2D: 2) CPU meshes, with a
  small reduction slab so every block is reduced in several slabs, equal
  the unsharded result: wave's energy and SOR's residual take their
  block-edge terms from the exchange;
* ``HealthMonitor`` records and verdicts, ``apply_nan_poison``'s cell;
* ``HaloAuditor``: a clean pass on every transport that runs here, and a
  seeded single-bit corruption localised to the JAX package's site;
* the CLI's ``--health`` / ``--halo-audit`` records against the JAX
  CLI's, a ``FAULT_INJECT`` numerics spec, and a 2-process gloo launch
  whose records equal the one-process run's.
"""

import json
import math
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli
from mpi_cuda_process_tpu.obs import health as jhealth
from mpi_cuda_process_tpu.ops.stencil import make_stencil as jmake
from mpi_cuda_process_tpu.parallel import mesh as jmesh
from mpi_cuda_process_tpu.parallel import stepper as jstepper
from mpi_cuda_process_tpu.resilience import faults as jfaults
from mpi_cuda_process_tpu.utils.init import init_state as jinit

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.obs import health as thealth
from mpi_cuda_process_tpu_torch.obs import trace as ttrace
from mpi_cuda_process_tpu_torch.ops.stencil import make_stencil as tmake
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.parallel import stepper as tstepper
from mpi_cuda_process_tpu_torch.resilience import faults as tfaults
from mpi_cuda_process_tpu_torch.utils.init import init_state as tinit

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, each subprocess
RTOL = 1e-5
CPU = torch.device("cpu")

STENCILS = ["heat3d", "wave3d", "sor3d", "life", "grayscott2d", "mdf"]
SHAPES = {3: (8, 12, 16), 2: (12, 16)}


def _numpy_fields(name, dtype, ensemble, seed=7, plant=True):
    """Seeded numpy fields of ``name`` (float32 values, or Life's int32),
    with a NaN and an Inf planted in field 0 of float states."""
    st = tmake(name)
    shape = ((ensemble,) if ensemble else ()) + SHAPES[st.ndim]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(st.num_fields):
        if name == "life":
            out.append((rng.random(shape) < 0.3).astype(np.int32))
            continue
        a = rng.standard_normal(shape).astype(np.float32) * 3 + 1
        if plant and i == 0:
            flat = a.reshape(-1)
            flat[5] = np.nan
            flat[17] = np.inf
        out.append(a)
    return out


def _both(name, dtype, arrays):
    """The same arrays as JAX and torch fields of ``dtype``."""
    if name == "life":
        return ([jnp.asarray(a) for a in arrays],
                [torch.from_numpy(a.copy()) for a in arrays])
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a.copy()).to(td) for a in arrays])


def _stencils(name, dtype):
    kw = {} if name == "life" else {"dtype": dtype}
    return jmake(name, **kw), tmake(name, **kw)


def _assert_vals(jv, tv, exact_mean=False):
    assert set(jv) == set(tv), (sorted(jv), sorted(tv))
    for k in jv:
        a = np.asarray(jv[k], dtype=np.float64)
        b = np.asarray(tv[k], dtype=np.float64)
        assert a.shape == b.shape, k
        exact = k.endswith(("_min", "_max", "_nonfinite")) or exact_mean
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6,
                                       equal_nan=True, err_msg=k)


@pytest.mark.parametrize("ensemble", [0, 3], ids=["single", "ens3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", STENCILS)
def test_health_fn_matches_jax(name, dtype, ensemble):
    if name == "life" and dtype == "bfloat16":
        dtype = "int32"  # Life's one type
    js, ts = _stencils(name, "float32" if dtype == "int32" else dtype)
    jf, tf = _both(name, dtype, _numpy_fields(name, dtype, ensemble))
    jv = jax.device_get(jhealth.make_health_fn(js, ensemble)(tuple(jf)))
    tv = thealth.make_health_fn(ts, ensemble)(tuple(tf))
    # Life's population is an exact integer sum
    _assert_vals(jv, tv, exact_mean=False)
    if name == "life":
        np.testing.assert_array_equal(np.asarray(tv["invariant"]),
                                      np.asarray(jv["invariant"]))
    if name != "life":
        # the planted cells were counted
        assert np.sum(tv["field0_nonfinite"]) == 2


@pytest.mark.parametrize("name,counts,ensemble", [
    ("heat3d", (2, 2), 0), ("wave3d", (2, 2), 0), ("sor3d", (2, 2), 0),
    ("wave3d", (1, 2, 2), 0), ("sor3d", (2, 1, 2), 0),
    ("wave3d", (2, 2), 2), ("sor2d", (2,), 0), ("wave2d", (2, 2), 0),
    ("life", (2, 2), 0),
])
def test_sharded_health_equals_unsharded(name, counts, ensemble,
                                         monkeypatch):
    # several reduction slabs a block: the slab seams are exercised too
    monkeypatch.setattr(thealth, "CHUNK_ELEMS", 64)
    st = tmake(name)
    arrays = _numpy_fields(name, "float32", ensemble, plant=False)
    fields = [torch.from_numpy(a.copy()) for a in arrays]
    fn = thealth.make_health_fn(st, ensemble)
    whole = fn(tuple(fields))
    mesh = tmesh.make_mesh(counts, [CPU] * math.prod(counts))
    sharded = tstepper.shard_fields(tuple(fields), mesh, st.ndim,
                                    ensemble=bool(ensemble))
    _assert_vals(whole, fn(sharded))
    # and the JAX package's unsharded value
    js = jmake(name)
    jv = jax.device_get(jhealth.make_health_fn(js, ensemble)(
        tuple(jnp.asarray(a) for a in arrays)))
    _assert_vals(jv, fn(sharded))


# Relative quantities (drifts) are compared to RTOL absolutely; the
# member spread of an ensemble (a difference of invariants) to RTOL of
# the invariants' magnitude, which the reference sums in float32.
_ABS_KEYS = ("drift", "worst_drift")


def _records_close(a, b, path="rec", scale=None):
    """Structural equality with float leaves within RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        if scale is None and isinstance(a.get("invariant"), dict):
            v = a["invariant"]["value"]
            scale = max(abs(x) for x in (v if isinstance(v, list)
                                         else [v]))
        for k in a:
            _records_close(a[k], b[k], f"{path}.{k}", scale)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _records_close(x, y, f"{path}[{i}]", scale)
    elif isinstance(a, float) and isinstance(b, (int, float)):
        if math.isnan(a):
            assert math.isnan(b), path
        else:
            key = path.rsplit(".", 1)[-1]
            atol = (RTOL if key.split("[")[0] in _ABS_KEYS else
                    RTOL * scale if key in ("spread", "std") and scale
                    else 2e-8)
            atol = max(atol, RTOL) if "worst_field" in path else atol
            assert math.isclose(a, b, rel_tol=RTOL, abs_tol=atol), \
                (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_monitor_records_and_verdicts_match_jax():
    """The same states through both monitors: clean, drifted past heat's
    tolerance, poisoned; every record equal (stats within RTOL)."""
    js, ts = jmake("heat3d"), tmake("heat3d")
    jm, tm = jhealth.HealthMonitor(js), thealth.HealthMonitor(ts)
    base = _numpy_fields("heat3d", "float32", 0, plant=False)[0]
    states = [base, base + 1.0, base * 400.0]
    poisoned = base.copy()
    poisoned.reshape(-1)[3] = np.nan
    states.append(poisoned)
    for step, a in enumerate(states):
        jr = jm.check(step, (jnp.asarray(a),), chunk=step)
        tr = tm.check(step, (torch.from_numpy(a.copy()),), chunk=step)
        _records_close(jr, tr)
        assert jr["verdict"] == tr["verdict"]
    assert tm.verdict == jhealth.VERDICT_DIVERGED
    # ensemble: per-member stats and the member spread
    jm = jhealth.HealthMonitor(jmake("wave3d"), ensemble=3)
    tm = thealth.HealthMonitor(tmake("wave3d"), ensemble=3)
    arrays = _numpy_fields("wave3d", "float32", 3, plant=False)
    for step in range(2):
        jr = jm.check(step, tuple(jnp.asarray(a) for a in arrays))
        tr = tm.check(step, tuple(torch.from_numpy(a.copy())
                                  for a in arrays))
        _records_close(jr, tr)
        arrays = [a * 1.5 for a in arrays]
    assert tr["verdict"] == jr["verdict"] == jhealth.VERDICT_DIVERGED


@pytest.mark.parametrize("ensemble", [0, 3])
def test_apply_nan_poison_hits_the_same_cell(ensemble):
    arrays = _numpy_fields("wave3d", "float32", ensemble, plant=False)
    jf = jhealth.apply_nan_poison(tuple(jnp.asarray(a) for a in arrays))
    tf = thealth.apply_nan_poison(tuple(torch.from_numpy(a.copy())
                                        for a in arrays))
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(np.isnan(np.asarray(a)),
                                      torch.isnan(b).numpy())
    # a sharded field: the block that holds the cell
    st = tmake("wave3d")
    mesh = tmesh.make_mesh((2, 2), [CPU] * 4)
    sf = tstepper.shard_fields(tuple(torch.from_numpy(a.copy())
                                     for a in arrays), mesh, 3,
                               ensemble=bool(ensemble))
    thealth.apply_nan_poison(sf)
    got = tstepper.gather_fields(sf)
    for a, b in zip(jf, got):
        np.testing.assert_array_equal(np.isnan(np.asarray(a)),
                                      torch.isnan(b).numpy())
    del st
    with pytest.raises(ValueError, match="all-integer"):
        thealth.apply_nan_poison((torch.zeros((4, 4), dtype=torch.int32),))


GRID = (8, 8, 16)


def _t_sharded(st, counts, ensemble=0, kind="auto", periodic=False):
    mesh = tmesh.make_mesh(counts, [CPU] * math.prod(counts))
    fields = tinit(st, GRID, 3, kind=kind, periodic=periodic,
                   ensemble=ensemble, device=CPU)
    return mesh, tstepper.shard_fields(fields, mesh, 3,
                                       ensemble=bool(ensemble))


@pytest.mark.parametrize("counts", [(2,), (1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("exchange", ["ppermute", "rdma"])
def test_audit_clean_pass_every_transport(counts, exchange):
    st = tmake("heat3d")
    mesh, fields = _t_sharded(st, counts)
    aud = thealth.HaloAuditor(st, mesh, GRID, exchange=exchange)
    rec = aud.audit(fields, step=0, chunk=0)
    assert rec["ok"] and rec["mismatch_total"] == 0
    assert rec["sites_checked"] == 2 * sum(1 for c in counts if c > 1)
    assert rec["backend"] == ("ppermute" if exchange == "ppermute"
                              else "plain-ring")


def test_audit_clean_mixed_halo_periodic_wide_and_ensemble():
    st = tmake("wave3d")
    mesh, fields = _t_sharded(st, (2, 2), kind="pulse")
    rec = thealth.HaloAuditor(st, mesh, GRID).audit(fields, step=0)
    assert rec["ok"] and rec["sites_checked"] == 4
    assert all(s["field"] == 0 for s in rec["sites"])
    st = tmake("heat3d")
    mesh, fields = _t_sharded(st, (2,), kind="random", periodic=True)
    assert thealth.HaloAuditor(st, mesh, GRID, periodic=True).audit(
        fields, step=0)["ok"]
    st = tmake("heat3d4th")
    mesh, fields = _t_sharded(st, (2,))
    rec = thealth.HaloAuditor(st, mesh, GRID).audit(fields, step=0)
    assert rec["ok"] and all(s["halo"] == 2 for s in rec["sites"])
    st = tmake("heat3d")
    mesh, fields = _t_sharded(st, (2,), ensemble=2)
    assert thealth.HaloAuditor(st, mesh, GRID).audit(fields, step=0)["ok"]


def _jax_flip(slab, axis_name, shard):
    bits = jax.lax.bitcast_convert_type(slab, jnp.uint32)
    idx = (0,) * slab.ndim
    bad = jax.lax.bitcast_convert_type(
        bits.at[idx].set(bits[idx] ^ 1), slab.dtype)
    return jnp.where(jax.lax.axis_index(axis_name) == shard, bad, slab)


@pytest.mark.parametrize("target", [
    (0, "left", 1), (0, "right", 0), (1, "left", 1)])
def test_seeded_corruption_localised_like_jax(target):
    t_axis, t_dir, t_shard = target

    def jcorrupt(field, axis, direction, slab, axis_name):
        if field == 0 and axis == t_axis and direction == t_dir:
            return _jax_flip(slab, axis_name, t_shard)
        return slab

    def tcorrupt(field, axis, direction, slab, shard):
        if (field, axis, direction, shard) == (0, t_axis, t_dir, t_shard):
            slab.view(torch.int32).reshape(-1)[0] ^= 1
        return slab

    jst, tst = jmake("heat3d"), tmake("heat3d")
    jm = jmesh.make_mesh((2, 2))
    jf = jstepper.shard_fields(jinit(jst, GRID, seed=3), jm, 3)
    jrec = jhealth.HaloAuditor(jst, jm, GRID, _corrupt=jcorrupt).audit(
        jf, step=7, chunk=3)
    events = []

    class _Trace:
        def event(self, kind, **payload):
            events.append({"kind": kind, **payload})

    mesh, tf = _t_sharded(tst, (2, 2))
    aud = thealth.HaloAuditor(tst, mesh, GRID, trace=_Trace(),
                              _corrupt=tcorrupt)
    trec = aud.audit(tf, step=7, chunk=3)
    assert trec == jrec
    assert not trec["ok"] and events[-1]["chunk"] == 3
    with pytest.raises(thealth.SimulationDiverged, match=t_dir):
        aud.audit_or_raise(tf, step=7, chunk=3)
    # the corruption touched a copy: the state itself is clean
    assert thealth.HaloAuditor(tst, mesh, GRID).audit(tf, step=7)["ok"]


def test_audit_nan_transported_bit_exactly_is_clean():
    st = tmake("heat3d")
    mesh, fields = _t_sharded(st, (2,))
    fields[0][1][(1, 4, 8)] = float("nan")
    assert thealth.HaloAuditor(st, mesh, GRID).audit(fields, step=0)["ok"]


def test_auditor_refusals_match_jax():
    st = tmake("heat3d")
    with pytest.raises(ValueError, match="no sharded exchange sites"):
        thealth.HaloAuditor(st, tmesh.make_mesh((), [CPU]), GRID)
    for argv in (["--halo-audit", "1"],
                 ["--halo-audit", "-1", "--mesh", "2,1,1"],
                 ["--halo-audit", "2", "--mesh", "2", "--tol", "1e-3"]):
        base = ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "4"]
        with pytest.raises(ValueError) as je:
            jcli.run(jcli.config_from_args(base + argv))
        with pytest.raises(ValueError) as te:
            tcli.run(tcli.config_from_args(base + argv + ["--device",
                                                          "cpu"]))
        assert str(te.value) == str(je.value)


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _state_means(fields, ensemble):
    """The float64 mean of each field of a state (a list, one a member,
    for an ensemble)."""
    out = []
    for f in fields:
        a = np.asarray(f, dtype=np.float64)
        out.append([float(m) for m in a.reshape(a.shape[0], -1).mean(1)]
                   if ensemble else float(a.mean()))
    return out


def _with_state_means(rec, means, base):
    """A reference health record with its field means, and the worst
    field's drift from them, taken from the float64 means of the state
    the reference checked (``base``: those of its first check)."""
    rec = json.loads(json.dumps(rec))
    worst = None
    for i, (cur, b0) in enumerate(zip(means, base)):
        many = isinstance(cur, list)
        rec["fields"][i]["mean"] = ([round(x, 8) for x in cur] if many
                                    else round(cur, 8))
        cur, b0 = (cur, b0) if many else ([cur], [b0])
        d = max(jhealth.drift(v, w, None, "conserve")
                for v, w in zip(cur, b0))
        if worst is None or d > worst["drift"]:
            worst = {"field": i, "drift": round(d, 6)}
    if "worst_field" in rec:
        rec["worst_field"] = worst
    return rec


def _compare_cli(tmp_path, monkeypatch, argv, kinds=("health",
                                                     "halo_audit")):
    """The port's CLI records against the JAX CLI's for the same command.

    The reference's field mean is a float32 sum (XLA's CPU reduction),
    off by up to cells * 2^-24 relative: on sor3d 16x16x32 its step-2
    mean is 57.2594223 where the float64 mean of its own state is
    57.2583468 (ROADMAP C).  So each port mean (and the worst field's
    drift) is held at RTOL to the float64 mean of the state the reference
    checked at that boundary, recorded as its monitor sees it; every
    other value is held to the reference's record."""
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")
    # the reference's costmodel event (static cost, ROADMAP A6) has no
    # port counterpart yet; its tracing dominates a small run's time
    monkeypatch.setattr(jcli, "_emit_static_cost", lambda *a: None)
    ensemble = "--ensemble" in argv
    seen = []
    check = jhealth.HealthMonitor.check

    def recording_check(self, step, fields, chunk=None):
        seen.append(_state_means(fields, ensemble))
        return check(self, step, fields, chunk=chunk)

    monkeypatch.setattr(jhealth.HealthMonitor, "check", recording_check)
    jp, tp = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jcli.run(jcli.config_from_args(argv + ["--telemetry", jp]))
    tcli.run(tcli.config_from_args(argv + ["--telemetry", tp,
                                           "--device", "cpu"]))
    J, T = _records(jp), _records(tp)
    ttrace.validate_log(tp)
    for kind in kinds + ("chunk",):
        js = [r for r in J if r["kind"] == kind]
        ts = [r for r in T if r["kind"] == kind]
        assert len(js) == len(ts), kind
        if kind == "chunk":
            assert [r["steps"] for r in js] == [r["steps"] for r in ts]
            continue
        if kind == "health":
            assert len(seen) == len(js)
            js = [_with_state_means(r, m, seen[0]) for r, m in zip(js, seen)]
        for a, b in zip(js, ts):
            a, b = dict(a), dict(b)
            a.pop("t"), b.pop("t")
            _records_close(a, b)
    return T, tcli


@pytest.mark.parametrize("argv", [
    ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8", "--mesh",
     "2,1,1", "--checkpoint-every", "2", "--halo-audit", "2", "--health"],
    ["--stencil", "wave3d", "--grid", "16,16,32", "--iters", "8",
     "--mesh", "2,2", "--halo-audit", "2", "--health"],
    ["--stencil", "sor3d", "--grid", "16,16,32", "--iters", "8",
     "--health"],
    ["--stencil", "heat2d", "--grid", "32,32", "--iters", "8", "--mesh",
     "2", "--health", "--ensemble", "2"],
], ids=["heat3d-mesh2", "wave3d-mesh22", "sor3d-synth", "heat2d-ens"])
def test_cli_records_match_jax(argv, tmp_path, monkeypatch):
    recs, _ = _compare_cli(tmp_path, monkeypatch, argv)
    health = [r for r in recs if r["kind"] == "health"]
    assert health and all(r["verdict"] == "HEALTHY" for r in health)
    # the last record's mean: the float64 mean of the final state
    if "--ensemble" not in argv:
        fields, _ = tcli.run(tcli.config_from_args(argv + ["--device",
                                                           "cpu"]))
        if tstepper.is_sharded(fields):
            fields = tstepper.gather_fields(fields)
        want = float(fields[0].double().mean())
        last = health[-1]
        assert last["step"] == int(argv[argv.index("--iters") + 1])
        assert math.isclose(last["fields"][0]["mean"], want,
                            rel_tol=1e-7)


def test_numerics_fault_raises_at_the_same_step(tmp_path, monkeypatch):
    argv = ["--stencil", "heat3d", "--grid", "8,8,16", "--iters", "8",
            "--log-every", "2", "--health", "--checkpoint-every", "2"]
    monkeypatch.setenv("FAULT_INJECT", "numerics:step=3:nan")
    msgs, recs = [], []
    for name, cli, faults, extra in (
            ("j", jcli, jfaults, []), ("t", tcli, tfaults,
                                       ["--device", "cpu"])):
        faults.reset()
        path = str(tmp_path / f"{name}.jsonl")
        ck = str(tmp_path / f"ck_{name}")
        with pytest.raises(Exception) as e:
            cli.run(cli.config_from_args(
                argv + extra + ["--telemetry", path, "--checkpoint-dir",
                                ck]))
        assert type(e.value).__name__ == "SimulationDiverged"
        msgs.append(str(e.value))
        recs.append([r for r in _records(path) if r["kind"] == "health"])
        # the diverged state is never checkpointed: step 2's is the last
        with open(os.path.join(ck, "meta.json")) as fh:
            assert json.load(fh)["step"] == 2
        assert os.path.exists(str(tmp_path / f"{name}.bundle.json"))
        faults.reset()
    assert msgs[0] == msgs[1]
    assert "step 4" in msgs[1]
    bad = recs[1][-1]
    assert bad["verdict"] == "DIVERGED" and bad["nonfinite_total"] == 1
    assert bad["fields"][0]["nonfinite"] == 1
    _records_close(recs[0][-1] | {"t": 0}, bad | {"t": 0})


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", tmesh.VIRTUAL_DEVICES_ENV,
              "FAULT_INJECT"):
        env.pop(k, None)
    env[tmesh.DIST_TIMEOUT_ENV] = "60"
    env["PYTHONPATH"] = _REPO
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_two_processes_give_the_one_process_records(tmp_path):
    """2 processes under gloo: each writes its own log (process_index 0
    and 1), and every health and audit record equals the one-process run
    of the same mesh, value for value."""
    argv = ["--stencil", "wave3d", "--grid", "16,16,32", "--iters", "8",
            "--mesh", "2,2", "--log-every", "2", "--health",
            "--halo-audit", "2", "--device", "cpu"]
    path = str(tmp_path / "mp.jsonl")
    one = str(tmp_path / "one.jsonl")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv,
         "--telemetry", path], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=_REPO,
        env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=r,
                 WORLD_SIZE=2, LOCAL_RANK=r, LOCAL_WORLD_SIZE=2))
        for r in range(2)]
    single = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv,
         "--telemetry", one], capture_output=True, text=True, cwd=_REPO,
        env=_env(**{tmesh.VIRTUAL_DEVICES_ENV: 4}), timeout=TIMEOUT)
    for p in procs:
        _, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err[-2000:]
    assert single.returncode == 0, single.stderr[-2000:]
    ref = _records(one)
    for r, log_path in enumerate((path, str(tmp_path / "mp.p1.jsonl"))):
        manifest, events = ttrace.validate_log(log_path)
        assert manifest["provenance"]["process_index"] == r
        assert manifest["provenance"]["process_count"] == 2
        for kind in ("health", "halo_audit"):
            got = [{k: v for k, v in e.items() if k != "t"}
                   for e in events if e["kind"] == kind]
            want = [{k: v for k, v in e.items() if k != "t"}
                    for e in ref if e["kind"] == kind]
            assert got == want
            assert len(got) == (2 if kind == "halo_audit" else 4)
