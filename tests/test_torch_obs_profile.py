"""Device-trace attribution on torch.profiler traces (``obs/profile.py``).

* synthetic Chrome traces in torch.profiler's (Kineto's) format: kernel,
  memcpy and memset lanes beside host ``cpu_op`` / ``cuda_runtime`` /
  ``python_function`` events.  NCCL and the ring kernels are the
  exchange by name; a copy launched under ``parallel/halo.py`` frames is
  the exchange, one launched under the stepper is interior compute; the
  interval arithmetic gives busy, compute, exchange, exposed time, the
  overlap efficiency and the chunk's idle share;
* the degradations say ``attribution: unavailable`` with a reason, never
  zeros: no device lanes (a CPU trace), device lanes without complete
  events, a copy whose launching frames are not in the trace, no trace
  file, a profiler error, a run that ended before the target chunk;
* a real CPU trace: the host ops the exchange issues sit under
  ``halo.py`` frames and the interior's do not (device events grafted
  onto them by ``External id``);
* ``ChunkProfiler`` scopes exactly the target chunk, with injected stubs
  and on the CPU's torch.profiler through the CLI, and the CLI's
  ``--profile`` / ``--profile-dir`` refusals equal the JAX CLI's.
"""

import json
import os

import pytest
import torch

from mpi_cuda_process_tpu import cli as jcli

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.obs import profile as tprofile
from mpi_cuda_process_tpu_torch.parallel import halo
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

PID, TID, GPU = 100, 100, 0


def _host(name, ts, dur, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": PID, "tid": TID,
            "ts": ts, "dur": dur, "args": args}


def _dev(name, ts, dur, cat="kernel", corr=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU, "tid": 7,
            "ts": ts, "dur": dur, "args": args}


def _trace():
    """A chunk of an overlapped sharded step: the exchange's slab copy
    (halo.py) and an NCCL send beside the interior kernel, then the
    shells, then a ring kernel and a peer memcpy alone."""
    return [
        _host("repo/mpi_cuda_process_tpu_torch/parallel/stepper.py(800): "
              "step", 0, 1000, cat="python_function"),
        _host("repo/mpi_cuda_process_tpu_torch/parallel/halo.py(570): "
              "_border_rounds", 10, 20, cat="python_function"),
        _host("cudaLaunchKernel", 12, 2, cat="cuda_runtime", correlation=1),
        _host("cudaLaunchKernel", 40, 2, cat="cuda_runtime", correlation=2),
        _host("cudaLaunchKernel", 60, 2, cat="cuda_runtime", correlation=3),
        _dev("void at::native::elementwise_kernel<copy>", 100, 50, corr=1),
        _dev("stream_yzslab_f32", 100, 300, corr=2),
        _dev("ncclDevKernel_SendRecv", 160, 100),
        _dev("void at::native::fill_kernel", 400, 20, corr=3),
        _dev("fused_shell", 420, 80),
        _dev("ring_exchange", 600, 50),
        _dev("Memcpy PtoP (Device -> Device)", 700, 50, cat="gpu_memcpy"),
    ]


def test_attribution_buckets_interval_math_and_idle_share():
    att = tprofile.attribute_events(_trace())
    assert att["attribution"] == "ok"
    assert att["n_device_events"] == 7
    # exchange: copy [100,150) nccl [160,260) ring [600,650) p2p [700,750)
    assert att["comm_us"] == pytest.approx(50 + 100 + 50 + 50)
    # nccl, ring and p2p by name; the copy by its halo.py launcher
    assert att["comm_events"] == {"by_name": 3, "by_launcher": 1}
    # compute: interior [100,400) fill (stepper launch) [400,420) shell
    # [420,500)
    assert att["compute_us"] == pytest.approx(400)
    assert att["exposed_comm_us"] == pytest.approx(100)
    assert att["device_busy_us"] == pytest.approx(500)
    assert att["overlap_efficiency"] == pytest.approx(1 - 100 / 250)
    assert att["device_span_us"] == pytest.approx(650)
    rec = {"attribution": "ok", **att}
    assert "idle share" not in tprofile.format_attribution(rec)


def test_attribution_record_idle_share(tmp_path):
    path = str(tmp_path / "chunk1.trace.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": _trace()}, fh)
    rec = tprofile.attribution_record(str(tmp_path), profiled_chunk=1,
                                      wall_s=1e-3, path=path)
    assert rec["attribution"] == "ok"
    assert rec["idle_share"] == pytest.approx(0.5)
    assert rec["chunk_wall_us"] == pytest.approx(1000.0)
    assert "idle share 50.00%" in tprofile.format_attribution(rec)


def test_busy_past_the_wall_is_unavailable_not_zero_idle(tmp_path):
    """Device busy 500 us in a 400 us chunk: the clocks disagree or
    events were counted twice; the record says so and keeps both
    numbers instead of reporting an idle share of 0."""
    path = str(tmp_path / "chunk1.trace.json")
    with open(path, "w") as fh:
        json.dump({"traceEvents": _trace()}, fh)
    rec = tprofile.attribution_record(str(tmp_path), profiled_chunk=1,
                                      wall_s=4e-4, path=path)
    assert rec["attribution"] == "unavailable"
    assert "exceeds the chunk's wall" in rec["reason"]
    assert rec["device_busy_us"] == pytest.approx(500)
    assert rec["chunk_wall_us"] == pytest.approx(400)
    assert "idle_share" not in rec
    assert "attribution unavailable" in tprofile.format_attribution(rec)


def test_comm_classification_by_name():
    for name in ("ncclDevKernel_AllReduce_Sum_f32", "ring_send",
                 "ring_drain", "ring_exchange"):
        assert tprofile.is_comm_event(name)
    assert tprofile.is_comm_event("Memcpy PtoP (Device -> Device)",
                                  "gpu_memcpy")
    for name in ("stream_yzslab_f32", "fused_zslab", "march_step"):
        assert not tprofile.is_comm_event(name)


def test_no_exchange_is_none_not_perfect_hiding():
    att = tprofile.attribute_events([
        _host("x/stepper.py(1): step", 0, 100, cat="python_function"),
        _dev("raw_step_heat", 0, 10)])
    assert att["attribution"] == "ok" and att["overlap_efficiency"] is None
    assert att["comm_us"] == 0


@pytest.mark.parametrize("events,why", [
    ([_host("aten::add", 0, 5)], "no device lanes"),
    ([dict(_dev("k", 0, 5), ph="i")], "no complete events"),
    # a copy with no correlated launch: exchange or interior, unknown
    ([_host("x/stepper.py(1): step", 0, 100, cat="python_function"),
      _dev("void at::native::elementwise_kernel<copy>", 0, 5, corr=99)],
     "cannot be told apart"),
    # a trace without Python stacks cannot place any copy
    ([_host("cudaLaunchKernel", 0, 1, cat="cuda_runtime", correlation=1),
      _dev("Memcpy DtoD (Device -> Device)", 0, 5, cat="gpu_memcpy",
           corr=1)], "cannot be told apart"),
], ids=["host-only", "no-complete", "orphan-copy", "no-stacks"])
def test_unavailable_degradations(events, why):
    att = tprofile.attribute_events(events)
    assert att["attribution"] == "unavailable"
    assert why in att["reason"]
    assert "comm_us" not in att and "compute_us" not in att


def test_attribution_record_degradations(tmp_path):
    d = str(tmp_path)
    assert "no .trace.json" in tprofile.attribution_record(
        d, profiled_chunk=1)["reason"]
    assert "profiler error" in tprofile.attribution_record(
        d, profiled_chunk=1, error="boom")["reason"]
    assert "before the target chunk" in tprofile.attribution_record(
        d, profiled_chunk=None)["reason"]
    with open(os.path.join(d, "chunk1.trace.json"), "w") as fh:
        fh.write("{not json")
    assert "trace parse failed" in tprofile.attribution_record(
        d, profiled_chunk=1)["reason"]


def test_real_cpu_trace_places_exchange_ops_under_halo_frames(tmp_path):
    """A torch.profiler trace of one exchange-and-pad plus an interior
    op: device events grafted onto its cpu_ops by External id are
    classified by the real Python frames."""
    m = tmesh.make_mesh((2,), [torch.device("cpu")] * 2)
    blocks = [torch.rand(4, 4, 4) for _ in range(2)]
    prof = tprofile._start_torch_profiler(str(tmp_path))
    padded = halo.exchange_and_pad(blocks, m, 1, 0.0)
    interior = torch.sin(padded[0])
    path = str(tmp_path / "real.trace.json")
    tprofile.ChunkProfiler._stop_torch(prof, path)
    del interior
    events = tprofile.load_trace_events(str(tmp_path), path)
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and "External id" in (e.get("args") or {})]
    copies = [e for e in ops if e["name"] == "aten::copy_"]
    sins = [e for e in ops if e["name"] == "aten::sin"]
    assert copies and sins
    fake = []
    for i, e in enumerate(copies + sins):
        fake.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                     "name": ("copy_kernel" if e in copies
                              else "sin_kernel"),
                     "ts": 1e9 + 10 * i, "dur": 5,
                     "args": {"External id": e["args"]["External id"]}})
    att = tprofile.attribute_events(events + fake)
    assert att["attribution"] == "ok"
    assert att["comm_us"] == pytest.approx(5 * len(copies))
    assert att["compute_us"] == pytest.approx(5 * len(sins))
    assert att["comm_events"] == {"by_name": 0, "by_launcher": len(copies)}


class _Stub(tprofile.ChunkProfiler):
    def __init__(self, outdir, **kw):
        self.calls = []
        super().__init__(outdir,
                         start=lambda d: self.calls.append(("start", d)),
                         stop=lambda h, p: self.calls.append(("stop", p)),
                         **kw)


def test_chunk_profiler_scopes_exactly_the_target_chunk(tmp_path):
    p = _Stub(str(tmp_path), target_chunk=2)
    for n in range(5):
        p.begin_chunk(n)
        p.end_chunk(n)
    assert [c[0] for c in p.calls] == ["start", "stop"]
    assert p.profiled_chunk == 2 and p.wall_s is not None
    assert p.path.endswith("chunk2.trace.json")
    q = _Stub(str(tmp_path), target_chunk=1)
    q.begin_chunk(1)
    q.close()
    q.close()
    assert [c[0] for c in q.calls] == ["start", "stop"]
    assert not q.active


def test_profiler_failure_is_recorded_never_raised(tmp_path):
    def bad(_):
        raise RuntimeError("no profiler")

    p = tprofile.ChunkProfiler(str(tmp_path), start=bad,
                               stop=lambda h, p: None)
    assert p.begin_chunk(1) is False
    assert "no profiler" in p.error
    assert p.end_chunk(1) is False


def test_cli_profile_scopes_one_chunk_on_the_cpu(tmp_path):
    d = str(tmp_path / "prof")
    log = str(tmp_path / "t.jsonl")
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "8",
         "--log-every", "2", "--profile", d, "--telemetry", log,
         "--device", "cpu"]))
    assert os.listdir(d) == ["chunk1.trace.json"]
    events = tprofile.load_trace_events(d)
    steps = [e for e in events if e.get("cat") == "python_function"
             and e["name"].endswith(": step") and "driver.py" in e["name"]]
    assert len(steps) == 2  # chunk 1: steps 3 and 4, nothing else
    assert not [e for e in events if "diagnostics.py" in
                str(e.get("name"))]
    recs = [json.loads(x) for x in open(log) if x.strip()]
    prof = [r for r in recs if r["kind"] == "profile"]
    assert len(prof) == 1 and prof[0]["profiled_chunk"] == 1
    assert prof[0]["attribution"] == "unavailable"  # no device lanes
    chunks = [r for r in recs if r["kind"] == "chunk"]
    assert [c.get("profiled", False) for c in chunks] == \
        [False, True, False, False]


def test_cli_profile_dir_writes_the_whole_loop(tmp_path):
    d = str(tmp_path / "whole")
    tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "16,16,32", "--iters", "4",
         "--profile-dir", d, "--device", "cpu"]))
    assert os.listdir(d) == ["run.trace.json"]
    events = tprofile.load_trace_events(d)
    assert len([e for e in events if e.get("cat") == "python_function"
                and e["name"].endswith(": step")
                and "driver.py" in e["name"]]) == 4


@pytest.mark.parametrize("extra", [
    ["--profile", "a", "--profile-dir", "b"],
    ["--profile", "a", "--tol", "1e-3"],
], ids=["both", "tol"])
def test_cli_profile_exclusions_match_jax(extra):
    base = ["--stencil", "sor3d", "--grid", "8,8,16", "--iters", "4"]
    with pytest.raises(ValueError) as je:
        jcli.run(jcli.config_from_args(base + extra))
    with pytest.raises(ValueError) as te:
        tcli.run(tcli.config_from_args(base + extra + ["--device", "cpu"]))
    # the port's message names profilers, not the reference's library
    assert str(te.value).split(";")[-1] == str(je.value).split(";")[-1]
