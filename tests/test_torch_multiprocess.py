"""Decomposition across processes: the port's multi-process runs over gloo
on the CPU, against the same ``--mesh`` run in one process and against the
JAX package.

The reference is a multi-process program (two MPI ranks swapping halo rows,
kernel.cu:175-178); the JAX package runs it as two OS processes over
``jax.distributed`` (tests/test_multiprocess.py).  Here the port's CLI runs
as 2 and 4 OS processes, each started with the variables ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``)
and a free port, so ``parallel.mesh.bootstrap_distributed`` opens a gloo
group and every slab that crosses a process boundary goes through
``torch.distributed`` point to point.  To stay cheap, one 2-process launch
and one 4-process launch each run every case of their world in turn, and a
third process runs every case in one process (``--mesh`` on virtual
devices); every process writes its own blocks and log lines to a
temporary directory, and the parametrised tests below read them.

Every case is held bit-equal to the one-process run (every block of every
field, and the ``--log-every`` lines digit for digit), and against the JAX
package's single-process plain step run from the same initial fields, op by
op: Life exactly, float32 at ``atol = 1e-4, rtol = 0``
(tests/test_fused.py:70), bfloat16 at ``32 eps max(|ref|, 1)``
(tests/test_torch_bf16.py:13-18); the ``--pipeline`` cases (the slab-carry
exchange, with and without ``--overlap``) too, and the ``--exchange rdma``
cases (the ring's peer form, ``remote.PeerSite``, in its plain version:
receive slots, flags and credits in shared files; heat3d ``--mesh 2`` on 2
processes and ``--mesh 2,2`` on 2 and 4, ± ``--overlap``, one with
``--pipeline``, one in bfloat16), each also bit-equal to its gloo twin.
Plus one CLI run under ``torchrun --nproc-per-node 2``, the refusals of a
multi-process run (an ``npy`` checkpoint save, ``--render``, ``--exchange
rdma`` between nodes, a mesh the processes do not divide), the bootstrap
without a cluster, and the sharded
checkpoint across processes: 4 processes on ``--mesh 2,2`` killed by
``FAULT_INJECT=exchange:step=4:sigkill`` on every rank, resumed as 2
processes on ``--mesh 4`` and then as one unsharded process, an ``npy``
checkpoint resumed by 2 processes, and a kill inside a sharded write, each
bit-equal to the uninterrupted run.  Every subprocess has its own timeout
and is killed on expiry.
"""

import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_cuda_process_tpu import driver as jdriver
from mpi_cuda_process_tpu.ops import make_stencil as jmake_stencil

from mpi_cuda_process_tpu_torch import cli as tcli
from mpi_cuda_process_tpu_torch.parallel import mesh as tmesh
from mpi_cuda_process_tpu_torch.utils import checkpointing as tckpt
from mpi_cuda_process_tpu_torch.utils.init import init_state as tinit_state

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds, each subprocess
EPS_BF16 = 2.0 ** -7

_PULSE = ("--init", "pulse")
_LIFE = ("--init", "random", "--density", "0.3", "--seed", "7")

# (id, processes, stencil, grid, iterations, flags); every case runs with
# --device cpu.  The 2-process cases split z (a 2-process axis; periodic
# too) or hold two shards each of a 2x2 mesh; the 4-process cases put one
# shard of 2x2 on each process, so the two axes' peers differ.
CASES = [
    ("life_m2", 2, "life", (16, 16), 6, ("--mesh", "2", *_LIFE,
                                         "--log-every", "2")),
    ("life_m2_pallas", 2, "life", (16, 16), 6,
     ("--mesh", "2", "--compute", "pallas", *_LIFE, "--log-every", "2")),
    ("life_m2_fuse2", 2, "life", (16, 16), 6,
     ("--mesh", "2", "--fuse", "2", *_LIFE, "--log-every", "2")),
    ("life_m2_fuse2_overlap", 2, "life", (16, 16), 6,
     ("--mesh", "2", "--fuse", "2", "--overlap", *_LIFE,
      "--log-every", "2")),
    ("heat3d_m2", 2, "heat3d", (16, 8, 32), 4,
     ("--mesh", "2", *_PULSE, "--log-every", "2")),
    ("heat3d_m2_pallas", 2, "heat3d", (16, 8, 32), 4,
     ("--mesh", "2", "--compute", "pallas", *_PULSE, "--log-every", "2")),
    ("heat3d_m2_pallas_overlap", 2, "heat3d", (16, 8, 32), 4,
     ("--mesh", "2", "--compute", "pallas", "--overlap", *_PULSE,
      "--log-every", "2")),
    ("wave3d_m2_pallas", 2, "wave3d", (16, 8, 32), 4,
     ("--mesh", "2", "--compute", "pallas", *_PULSE, "--log-every", "2")),
    ("heat3d_m2_periodic", 2, "heat3d", (16, 8, 32), 4,
     ("--mesh", "2", "--periodic", "--compute", "pallas", *_PULSE,
      "--log-every", "2")),
    ("heat3d_22_on_2", 2, "heat3d", (16, 16, 32), 4,
     ("--mesh", "2,2", "--compute", "pallas", *_PULSE, "--log-every", "2")),
    ("sor3d_m2_tol", 2, "sor3d", (16, 8, 32), 64,
     ("--mesh", "2", "--tol", "2", "--tol-check-every", "8")),
    ("heat3d_m2_bf16", 2, "heat3d", (16, 8, 32), 4,
     ("--mesh", "2", "--compute", "pallas", "--dtype", "bfloat16", *_PULSE,
      "--log-every", "2")),
    ("heat3d_m2_fuse4", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", *_PULSE, "--log-every", "4")),
    ("heat3d_m2_fuse4_overlap", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--overlap", *_PULSE,
      "--log-every", "4")),
    ("heat3d_m2_padfree", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "padfree", *_PULSE,
      "--log-every", "4")),
    ("heat3d_m2_padfree_overlap", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "padfree", "--overlap",
      *_PULSE, "--log-every", "4")),
    ("heat3d_m2_stream", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", *_PULSE,
      "--log-every", "4")),
    ("heat3d_m2_stream_overlap", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
      *_PULSE, "--log-every", "4")),
    ("heat3d_22", 4, "heat3d", (16, 16, 32), 4,
     ("--mesh", "2,2", *_PULSE, "--log-every", "2")),
    ("heat3d_22_pallas", 4, "heat3d", (16, 16, 32), 4,
     ("--mesh", "2,2", "--compute", "pallas", *_PULSE, "--log-every", "2")),
    ("heat3d_22_pallas_overlap", 4, "heat3d", (16, 16, 32), 4,
     ("--mesh", "2,2", "--compute", "pallas", "--overlap", *_PULSE,
      "--log-every", "2")),
    ("heat3d_22_periodic", 4, "heat3d", (16, 16, 32), 4,
     ("--mesh", "2,2", "--periodic", "--compute", "pallas", *_PULSE,
      "--log-every", "2")),
    ("heat3d27_22_pallas", 4, "heat3d27", (16, 16, 32), 4,
     ("--mesh", "2,2", "--compute", "pallas", *_PULSE, "--log-every", "2")),
    ("heat3d27_22_padfree", 4, "heat3d27", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree", *_PULSE,
      "--log-every", "4")),
    ("heat3d_22_fuse4", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", *_PULSE, "--log-every", "4")),
    ("heat3d_22_fuse4_overlap", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--overlap", *_PULSE,
      "--log-every", "4")),
    ("heat3d_22_padfree", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree", *_PULSE,
      "--log-every", "4")),
    ("heat3d_22_padfree_overlap", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree", "--overlap",
      *_PULSE, "--log-every", "4")),
    ("heat3d_22_stream", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", *_PULSE,
      "--log-every", "4")),
    ("heat3d_22_stream_overlap", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
      *_PULSE, "--log-every", "4")),
    ("wave3d_m4_padfree", 4, "wave3d", (32, 8, 32), 8,
     ("--mesh", "4", "--fuse", "4", "--fuse-kind", "padfree", *_PULSE,
      "--log-every", "4")),
    # the pipelined slab-carry exchange: each pass's exchange posted from
    # the previous pass's borders (with --overlap its shells)
    ("heat3d_m2_padfree_pipeline", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "padfree", "--pipeline",
      *_PULSE, "--log-every", "4")),
    ("heat3d_m2_padfree_overlap_pipeline", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "padfree", "--overlap",
      "--pipeline", *_PULSE, "--log-every", "4")),
    ("heat3d_m2_stream_overlap_pipeline", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
      "--pipeline", *_PULSE, "--log-every", "4")),
    ("heat3d_22_on_2_padfree_overlap_pipeline", 2, "heat3d", (32, 32, 32),
     8, ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
         "--overlap", "--pipeline", *_PULSE, "--log-every", "4")),
    ("heat3d_22_padfree_pipeline", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
      "--pipeline", *_PULSE, "--log-every", "4")),
    ("heat3d_22_padfree_overlap_pipeline", 4, "heat3d", (32, 32, 32), 12,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree", "--overlap",
      "--pipeline", *_PULSE, "--log-every", "4")),
    ("heat3d_22_stream_overlap_pipeline", 4, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
      "--pipeline", *_PULSE, "--log-every", "8")),
    ("wave3d_m4_padfree_pipeline", 4, "wave3d", (32, 8, 32), 8,
     ("--mesh", "4", "--fuse", "4", "--fuse-kind", "padfree", "--pipeline",
      *_PULSE, "--log-every", "4")),
    # --tol: the carry threads through every residual check, whose
    # all-reduce runs while the last pass's exchange is in flight
    ("sor3d_m2_padfree_pipeline_tol", 2, "sor3d", (32, 16, 32), 64,
     ("--mesh", "2", "--fuse", "2", "--fuse-kind", "padfree", "--pipeline",
      "--tol", "2", "--tol-check-every", "8")),
    # the gloo twins of the peer-ring cases below that have none above
    ("heat3d_22_on_2_stream", 2, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", *_PULSE,
      "--log-every", "4")),
    ("heat3d_22_on_2_stream_overlap", 2, "heat3d", (32, 32, 32), 8,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream", "--overlap",
      *_PULSE, "--log-every", "4")),
    ("heat3d_m2_stream_bf16", 2, "heat3d", (32, 16, 32), 8,
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", "--dtype",
      "bfloat16", *_PULSE, "--log-every", "4")),
    # --exchange rdma: the ring's peer form (ring_send / ring_drain; here
    # its plain version through shared files), each case the same run as
    # its gloo twin (the same id without "_rdma") plus the flag
    *[(name + "_rdma", world, stencil, grid, iters, flags
       + ("--exchange", "rdma"))
      for name, world, stencil, grid, iters, flags in (
          ("heat3d_m2_stream", 2, "heat3d", (32, 16, 32), 8,
           ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", *_PULSE,
            "--log-every", "4")),
          ("heat3d_m2_stream_overlap", 2, "heat3d", (32, 16, 32), 8,
           ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream",
            "--overlap", *_PULSE, "--log-every", "4")),
          ("heat3d_22_on_2_stream", 2, "heat3d", (32, 32, 32), 8,
           ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
            *_PULSE, "--log-every", "4")),
          ("heat3d_22_on_2_stream_overlap", 2, "heat3d", (32, 32, 32), 8,
           ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
            "--overlap", *_PULSE, "--log-every", "4")),
          ("heat3d_22_stream", 4, "heat3d", (32, 32, 32), 8,
           ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
            *_PULSE, "--log-every", "4")),
          ("heat3d_22_stream_overlap", 4, "heat3d", (32, 32, 32), 8,
           ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
            "--overlap", *_PULSE, "--log-every", "4")),
          ("heat3d_22_stream_overlap_pipeline", 4, "heat3d", (32, 32, 32),
           8, ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
               "--overlap", "--pipeline", *_PULSE, "--log-every", "8")),
          ("heat3d_m2_stream_bf16", 2, "heat3d", (32, 16, 32), 8,
           ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream",
            "--dtype", "bfloat16", *_PULSE, "--log-every", "4")))],
]
IDS = [c[0] for c in CASES]
RDMA_IDS = [c[0] for c in CASES if "rdma" in c[5]]

# What a 2-process run refuses before any field is built, and the words
# its message must hold: (id, stencil, grid, flags, exception, words,
# environment for the run).  The two checkpoint ids keep their names from
# the refusals they pinned before the sharded backend ran: an npy save
# still needs the global grid, and a resume with no checkpoint written yet
# runs from the initial state ("none": no exception; the checkpoint flows
# are the tests below).  The rdma id pinned the refusal of every
# multi-process --exchange rdma run before the peer ring; it now pins the
# refusal of a ring between nodes (the launcher's LOCAL_WORLD_SIZE 1 of
# WORLD_SIZE 2: one process a node).
REFUSALS = [
    ("checkpoint", "heat3d", (16, 8, 32),
     ("--mesh", "2", "--checkpoint-every", "2", "--checkpoint-dir", "{ck}"),
     "ValueError", "--checkpoint-backend orbax", {}),
    ("resume", "heat3d", (16, 8, 32),
     ("--mesh", "2", "--resume", "--checkpoint-dir", "{ck}"),
     "none", "", {}),
    ("render", "life", (16, 16), ("--mesh", "2", "--render"),
     "ValueError", "global grid", {}),
    ("rdma", "heat3d", (32, 16, 32),
     ("--mesh", "2", "--fuse", "4", "--fuse-kind", "stream", "--exchange",
      "rdma"), "NotImplementedError",
     "ROADMAP B7's inter-node part", {"LOCAL_WORLD_SIZE": "1"}),
    ("mesh_not_divided", "heat3d", (18, 8, 32), ("--mesh", "3"),
     "ValueError", "do not divide over 2 processes", {}),
]
# The same process's entry points that would need the global grid, called
# on a finished run's fields (the npy writer among them: it points to the
# sharded backend).
CALL_REFUSALS = [("gather_fields", "ValueError", "global grid"),
                 ("gather_to_numpy", "ValueError", "global grid"),
                 ("save_checkpoint", "ValueError",
                  "--checkpoint-backend orbax")]

_WORKER = r"""
import json, logging, os, sys, traceback
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from mpi_cuda_process_tpu_torch import cli, interop
from mpi_cuda_process_tpu_torch.parallel import halo, mesh as mesh_lib
from mpi_cuda_process_tpu_torch.parallel import stepper
from mpi_cuda_process_tpu_torch.utils import checkpointing, diagnostics

out_dir, cases, refusals = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3])
rank = int(os.environ.get("RANK", "0"))
tag = sys.argv[4] if len(sys.argv) > 4 else f"r{{rank}}"
lines = []


class Grab(logging.Handler):
    def emit(self, record):
        lines.append(record.getMessage())


log = logging.getLogger("mpi_cuda_process_tpu_torch")
log.setLevel(logging.INFO)
log.addHandler(Grab())


def argv_of(stencil, grid, iters, flags):
    return ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
            "--iters", str(iters), "--device", "cpu", *flags]


fields = None
for name, size, stencil, grid, iters, flags in cases:
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(size)
    lines.clear()
    res = {{}}
    try:
        cfg = cli.config_from_args(argv_of(stencil, grid, iters, flags))
        fields, _ = cli.run(cfg)
        st = cli._make_cfg_stencil(cfg)
        mesh = fields[0].mesh
        res["diag"] = diagnostics.field_diagnostics(st, fields)
        res["coords"] = [list(c) for c in mesh.local_coords()]
        res["blocks"] = len(fields[0])
        res["processes"] = mesh.processes
        res["backend"] = halo.default_transport(mesh).backend
        arrays = {{}}
        for j, f in enumerate(fields):
            for c, b in zip(mesh.local_coords(), f):
                b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
                arrays[f"f{{j}}_" + "_".join(map(str, c))] = b.numpy()
        np.savez(os.path.join(out_dir, f"{{name}}_{{tag}}.npz"), **arrays)
    except Exception as e:
        res["error"] = traceback.format_exc()
    res["lines"] = list(lines)
    with open(os.path.join(out_dir, f"{{name}}_{{tag}}.json"), "w") as fh:
        json.dump(res, fh)

refused = {{}}
for name, stencil, grid, flags, env in refusals:
    lines.clear()
    saved = {{k: os.environ.get(k) for k in env}}
    os.environ.update(env)
    try:
        cli.run(cli.config_from_args(argv_of(stencil, grid, 4, flags)))
        refused[name] = ["none", ""]
    except Exception as e:
        refused[name] = [type(e).__name__, str(e)]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
if refusals:
    calls = {{
        "gather_fields": lambda: stepper.gather_fields(fields),
        "gather_to_numpy": lambda: interop.gather_to_numpy(fields),
        "save_checkpoint": lambda: checkpointing.save_checkpoint(
            os.path.join(out_dir, "never"), fields, 4),
    }}
    for name, call in calls.items():
        try:
            call()
            refused[name] = ["none", ""]
        except Exception as e:
            refused[name] = [type(e).__name__, str(e)]
    refused["bootstrap_again"] = [
        str(mesh_lib.bootstrap_distributed(device="cpu")), ""]
    with open(os.path.join(out_dir, f"refusals_r{{rank}}.json"), "w") as fh:
        json.dump(refused, fh)
mesh_lib.shutdown_distributed()
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = dict(os.environ)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE", tmesh.VIRTUAL_DEVICES_ENV):
        env.pop(k, None)
    env[tmesh.DIST_TIMEOUT_ENV] = "60"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _finish(procs):
    """Wait for every process (its own timeout each), killing the rest on
    a failure; returns their (stdout, stderr)."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"process failed:\n{out}\n{err}"
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


_CLI = ("--stencil", "heat3d", "--grid", "16,8,32", "--iters", "4",
        "--mesh", "2", "--compute", "pallas", "--init", "pulse",
        "--log-every", "1", "--device", "cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch everything at once: the one-process references, the 2- and
    4-process workers, a torchrun CLI run and its one-process twin."""
    out = tmp_path_factory.mktemp("multiprocess")
    ck = str(out / "ck")
    worker = _WORKER.format(repo=_REPO)

    def spec(world):
        return json.dumps([[n, w, s, g, i, f] for n, w, s, g, i, f in CASES
                           if w == world])

    # the one-process runs: as many virtual devices as the mesh's shards
    single_spec = json.dumps([
        [n, int(np.prod([int(v) for v in f[f.index("--mesh") + 1]
                         .split(",")])), s, g, i, f]
        for n, _, s, g, i, f in CASES])

    refusals = json.dumps([[n, s, g, [x.format(ck=ck) for x in f], env]
                           for n, s, g, f, _, _, env in REFUSALS])
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(out), single_spec, "[]", "ref"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())]
    for world in (2, 4):
        port = _free_port()
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", worker, str(out), spec(world),
                 refusals if world == 2 else "[]"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, RANK=r,
                         WORLD_SIZE=world, LOCAL_RANK=r,
                         LOCAL_WORLD_SIZE=world)))
    trun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", "mpi_cuda_process_tpu_torch", *_CLI],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(PYTHONPATH=_REPO), cwd=_REPO)
    single = subprocess.Popen(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *_CLI],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(PYTHONPATH=_REPO, **{tmesh.VIRTUAL_DEVICES_ENV: 2}),
        cwd=_REPO)
    logs = _finish(procs + [trun, single])
    return {"dir": out, "ck": ck, "torchrun": logs[-2][1],
            "single": logs[-1][1]}


def _load(runs, name, rank):
    """A process's results of a case: ``rank`` of the multi-process run,
    or ``"ref"``, the one-process run."""
    tag = rank if rank == "ref" else f"r{rank}"
    with open(runs["dir"] / f"{name}_{tag}.json") as fh:
        res = json.load(fh)
    assert "error" not in res, res["error"]
    return res, dict(np.load(runs["dir"] / f"{name}_{tag}.npz"))


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", IDS)
def test_each_process_holds_only_its_own_shards(runs, name):
    """Every process holds size / processes blocks, its contiguous run of
    the mesh's row-major shards, and the transport is gloo; the one-process
    run holds every shard, in process."""
    _, world, *_ = _case(name)
    ref, _ = _load(runs, name, "ref")
    assert ref["processes"] == 1 and ref["backend"] == "in-process"
    whole = ref["coords"]
    per = len(whole) // world
    assert per * world == len(whole) == ref["blocks"]
    for r in range(world):
        res, arrays = _load(runs, name, r)
        assert res["processes"] == world and res["backend"] == "gloo"
        assert res["blocks"] == per and len(arrays) == per * len(
            _load(runs, name, "ref")[1]) // len(whole)
        assert res["coords"] == whole[r * per:(r + 1) * per]


@pytest.mark.parametrize("name", IDS)
def test_bit_equal_to_one_process(runs, name):
    """Every block of every field equals the one-process run's block of
    the same shard, bit for bit."""
    _, world, *_ = _case(name)
    ref = _load(runs, name, "ref")[1]
    got = {}
    for r in range(world):
        got.update(_load(runs, name, r)[1])
    assert sorted(got) == sorted(ref)
    for key, a in got.items():
        assert a.dtype == ref[key].dtype
        np.testing.assert_array_equal(a, ref[key], err_msg=key)


@pytest.mark.parametrize("name", IDS)
def test_log_lines_equal_one_process(runs, name):
    """The --log-every lines (the converged line of a --tol run) and the
    final diagnostics are the one-process run's on every process, digit
    for digit: every reduction combines every shard's partial in mesh
    order."""
    _, world, *_ = _case(name)
    ref, _ = _load(runs, name, "ref")
    want = [ln for ln in ref["lines"] if ln.startswith("step ")]
    conv = [ln.split(" in ")[0] for ln in ref["lines"]
            if ln.startswith("converged=")]
    assert want or conv
    for r in range(world):
        res, _ = _load(runs, name, r)
        assert [ln for ln in res["lines"] if ln.startswith("step ")] == want
        assert [ln.split(" in ")[0] for ln in res["lines"]
                if ln.startswith("converged=")] == conv
        assert res["diag"] == ref["diag"]
        assert any("transport gloo" in ln for ln in res["lines"])


def _global(runs, name, world, field, shape, dtype):
    out = np.empty(shape, dtype=dtype)
    for r in range(world):
        res, arrays = _load(runs, name, r)
        for c in res["coords"]:
            a = arrays[f"f{field}_" + "_".join(map(str, c))]
            local = a.shape
            sl = tuple(slice(ci * n, (ci + 1) * n)
                       for ci, n in zip(list(c) + [0] * len(shape), local))
            out[sl] = a
    return out


@pytest.mark.parametrize("name", IDS)
def test_matches_jax_single_process(runs, name):
    """The multi-process fields against the JAX package's plain step in
    one process, op by op from the port's initial fields, for as many
    steps as the run took: Life exact, float32 atol 1e-4, bfloat16
    32 eps max(|ref|, 1)."""
    _, world, stencil, grid, iters, flags = _case(name)
    cfg = tcli.config_from_args(["--stencil", stencil, "--grid",
                                 ",".join(map(str, grid)), "--iters",
                                 str(iters), "--device", "cpu", *flags])
    st = tcli._make_cfg_stencil(cfg)
    init = tinit_state(st, cfg.grid, cfg.seed, cfg.density, kind=cfg.init,
                       periodic=cfg.periodic, device="cpu")
    steps = iters
    if cfg.tol:
        res, _ = _load(runs, name, 0)
        line = next(ln for ln in res["lines"] if ln.startswith("converged="))
        steps = int(re.search(r"after (\d+) steps", line).group(1))
        assert steps < iters  # it converged before the cap
    bf16 = st.dtype == torch.bfloat16
    params = {"dtype": "bfloat16"} if bf16 else {}
    jst = jmake_stencil(stencil, **params)
    jstep = jdriver.make_step(jst, tuple(grid), periodic=cfg.periodic)
    jf = tuple(jnp.asarray(f.float().numpy() if bf16 else f.numpy())
               .astype(jst.dtype) for f in init)
    for _ in range(steps):
        jf = jstep(jf)
    for j, ref in enumerate(jf):
        ref = np.asarray(ref.astype(jnp.float32) if bf16 else ref)
        if bf16:
            bits = _global(runs, name, world, j, tuple(grid), np.int16)
            got = torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
            atol = 32 * EPS_BF16 * max(float(np.abs(ref).max()), 1.0)
        else:
            got = _global(runs, name, world, j, tuple(grid), ref.dtype)
            atol = 0 if stencil == "life" else 1e-4
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("name,exc,words", [(r[0], r[4], r[5])
                                            for r in REFUSALS]
                         + CALL_REFUSALS,
                         ids=[r[0] for r in REFUSALS]
                         + [r[0] for r in CALL_REFUSALS])
def test_multiprocess_refusals(runs, name, exc, words):
    """A multi-process run refuses an npy checkpoint save (it would need
    the global grid: the sharded backend writes each process's shards),
    --render and the global grid's entry points (no process holds it),
    --exchange rdma between nodes (the peer ring maps its peers' memory,
    which reaches one node: ROADMAP B7's inter-node part) and a mesh the
    processes do not divide, on every process, before any field is built:
    no checkpoint directory appears (a --resume with none written runs
    from the initial state)."""
    for r in range(2):
        with open(runs["dir"] / f"refusals_r{r}.json") as fh:
            got = json.load(fh)
        assert got[name][0] == exc, got[name]
        assert words in got[name][1], got[name]
        assert got["bootstrap_again"][0] == "True"
    assert not os.path.exists(runs["ck"])


@pytest.mark.parametrize("name", RDMA_IDS)
def test_rdma_bit_equal_to_gloo_twin(runs, name):
    """Every --exchange rdma case across processes runs the peer ring (its
    plain version: the backend line names plain-peer-ring, and every site
    is drained at the end on every process) and equals its gloo twin (the
    same run without the flag) block for block and log line for log line,
    bit for bit: the ring only copies bits."""
    _, world, stencil, grid, iters, flags = _case(name)
    twin = name[:-len("_rdma")]
    assert _case(twin)[1:] == (world, stencil, grid, iters,
                               flags[:-2]), twin
    for r in range(world):
        res, arrays = _load(runs, name, r)
        tres, tarrays = _load(runs, twin, r)
        assert "exchange: mode=rdma backend=plain-peer-ring" in res["lines"]
        assert any(ln.startswith("exchange: peer ring drained: ")
                   for ln in res["lines"])
        assert sorted(arrays) == sorted(tarrays)
        for key, a in arrays.items():
            np.testing.assert_array_equal(a, tarrays[key], err_msg=key)
        assert [ln for ln in res["lines"] if ln.startswith("step ")] == \
            [ln for ln in tres["lines"] if ln.startswith("step ")]
        assert res["diag"] == tres["diag"]


def _step_lines(text, rank=None):
    pat = re.compile(r"mpi_cuda_process_tpu_torch"
                     + (r" \[rank (\d+)/2\]" if rank else "")
                     + r": (step \d+ .*)$")
    out = {}
    for ln in text.splitlines():
        m = pat.search(ln)
        if m:
            key = m.group(1) if rank else "0"
            out.setdefault(key, []).append(m.groups()[-1])
    return out


def test_torchrun_cli_log_lines_equal_one_process(runs):
    """``torchrun --nproc-per-node 2 -m mpi_cuda_process_tpu_torch`` with
    --mesh 2: both ranks log the mesh over 2 processes with its gloo
    transport, and their --log-every lines equal the one-process run's."""
    want = _step_lines(runs["single"])["0"]
    assert len(want) == 4
    got = _step_lines(runs["torchrun"], rank=True)
    assert sorted(got) == ["0", "1"]
    assert got["0"] == got["1"] == want
    assert len(re.findall(r"\[rank \d/2\]: mesh 2: 2 shards over 2 "
                          r"processes, 1 here on cpu; transport gloo",
                          runs["torchrun"])) == 2


def test_bootstrap_without_cluster_returns_false(monkeypatch):
    """No launcher's variables: one process drives every shard, as
    before."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.bootstrap_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.bootstrap_distributed(device="cpu") is False
    assert tmesh.process_count() == 1


@pytest.mark.parametrize("env,words", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, "MASTER_PORT"),
    ({"WORLD_SIZE": "2", "MASTER_PORT": "29500"}, "RANK"),
    ({"WORLD_SIZE": "2", "RANK": "2", "MASTER_PORT": "29500"},
     "RANK=2 is not a rank"),
    ({"WORLD_SIZE": "two", "RANK": "0", "MASTER_PORT": "29500"},
     "not an integer"),
], ids=["no_port", "no_rank", "rank_out_of_range", "bad_world"])
def test_bootstrap_fails_fast_on_a_bad_configuration(monkeypatch, env,
                                                     words):
    """A configured cluster with a missing or malformed variable raises
    naming it, before any process group is opened."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=words):
        tmesh.bootstrap_distributed(device="cpu")
    assert tmesh.process_count() == 1


@pytest.mark.parametrize("kind,local,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl"), ("cuda", 4, 1, "gloo-host"),
    ("cuda", 3, 2, "gloo-host")])
def test_backend_rule(kind, local, cards, want):
    """gloo on the CPU, nccl when each process of a node has its own card,
    gloo through pinned host buffers when processes share one."""
    assert tmesh.choose_backend(kind, local, cards) == want


def test_mesh_ownership_over_processes():
    """Shards are held row-major in contiguous runs of size / processes;
    a shard count the processes do not divide raises at once."""
    cpu = torch.device("cpu")
    m = tmesh.Mesh((2, 2), [cpu] * 2, process=1, processes=2,
                   backend="gloo")
    assert m.local_coords() == [(1, 0), (1, 1)]
    assert [m.rank_of(c) for c in m.coords()] == [0, 0, 1, 1]
    assert m.local_index((1, 1)) == 1 and m.device((1, 0)) == cpu
    with pytest.raises(ValueError, match="held by process 0"):
        m.device((0, 1))
    with pytest.raises(ValueError, match="do not divide over 4"):
        tmesh.Mesh((3,), [cpu], process=0, processes=4, backend="gloo")
    one = tmesh.make_mesh((2, 2), [cpu] * 4)
    assert not one.multiprocess and one.local_coords() == list(one.coords())
    assert one.gather([torch.tensor(1.0)] * 4)[3] == torch.tensor(1.0)


# ---- the sharded checkpoint across processes --------------------------------

_CK = ("--stencil", "heat3d", "--grid", "16,16,32", "--init", "pulse",
       "--checkpoint-every", "2", "--device", "cpu")


def _cli_procs(world, argv, fault=None):
    """``world`` processes of the CLI (one without the launcher's
    variables), each with the fault spec ``fault``."""
    extra = {"FAULT_INJECT": fault} if fault else {}
    cmd = [sys.executable, "-m", "mpi_cuda_process_tpu_torch", *argv]
    if world == 1:
        return [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=_env(PYTHONPATH=_REPO, **extra),
                                 cwd=_REPO)]
    port = _free_port()
    return [subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(PYTHONPATH=_REPO, MASTER_ADDR="localhost", MASTER_PORT=port,
                 RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
                 LOCAL_WORLD_SIZE=world, **extra), cwd=_REPO)
        for r in range(world)]


def _ended(groups):
    """Wait for every process of every group (its own timeout each);
    returns each group's (return codes, stderr texts)."""
    out = []
    try:
        for procs in groups:
            rcs, errs = [], []
            for p in procs:
                _, err = p.communicate(timeout=TIMEOUT)
                rcs.append(p.returncode)
                errs.append(err)
            out.append((rcs, errs))
    finally:
        for procs in groups:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return out


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    """The checkpoint flows, phase by phase (each phase's launches at
    once): (1) 4 processes on --mesh 2,2, killed at the step-4 boundary,
    a 1-process npy run to step 4, and 2 processes killed inside their
    step-4 sharded write; (2) the killed run resumed as 2 processes on
    --mesh 4 to step 6, and the npy checkpoint resumed by 2 processes on
    --mesh 2,2 to step 8; (3) the step-6 checkpoint resumed unsharded to
    step 8."""
    out = tmp_path_factory.mktemp("mp_ckpt")
    ck, npy, atomic = (str(out / n) for n in ("ck", "npy", "atomic"))
    orbax = ("--checkpoint-backend", "orbax")
    phase1 = _ended([
        _cli_procs(4, [*_CK, *orbax, "--iters", "8", "--mesh", "2,2",
                       "--checkpoint-dir", ck],
                   fault="exchange:step=4:sigkill"),
        _cli_procs(1, [*_CK, "--iters", "4", "--checkpoint-dir", npy]),
        _cli_procs(2, [*_CK, *orbax, "--iters", "8", "--mesh", "2",
                       "--checkpoint-dir", atomic],
                   fault="checkpoint:during_write:step=4:sigkill")])
    files = sorted(os.listdir(os.path.join(ck, "step_000000000002")))
    phase2 = _ended([
        _cli_procs(2, [*_CK, *orbax, "--iters", "6", "--mesh", "4",
                       "--resume", "--checkpoint-dir", ck]),
        _cli_procs(2, [*_CK, *orbax, "--iters", "8", "--mesh", "2,2",
                       "--resume", "--checkpoint-dir", npy])])
    at6 = tmp_path_factory.mktemp("at6") / "ck"
    shutil.copytree(ck, at6)
    phase3 = _ended([_cli_procs(1, [*_CK, *orbax, "--iters", "8",
                                    "--resume", "--checkpoint-dir", ck])])
    return {"ck": ck, "npy": npy, "atomic": atomic, "at6": str(at6),
            "files_at_2": files, "killed": phase1[0], "npy_run": phase1[1],
            "atomic_run": phase1[2], "mesh4": phase2[0],
            "npy_resume": phase2[1], "unsharded": phase3[0]}


def _ref(iters):
    """The uninterrupted unsharded run of ``iters`` steps."""
    fields, _ = tcli.run(tcli.config_from_args(
        ["--stencil", "heat3d", "--grid", "16,16,32", "--init", "pulse",
         "--iters", str(iters), "--device", "cpu"]))
    return fields


def _held(path, iters):
    got, step, _ = tckpt.load_any(path)
    assert step == iters
    for a, b in zip(got, _ref(iters)):
        assert torch.equal(a, b)


def test_multiprocess_fault_kill_leaves_the_previous_checkpoint(ckpt_runs):
    """Every rank dies by SIGKILL at the step-4 boundary, before its save:
    the step-2 sharded checkpoint is the newest, written by every process
    (one file of blocks each), and equals the uninterrupted run's step 2."""
    rcs, errs = ckpt_runs["killed"]
    assert rcs == [-signal.SIGKILL] * 4, errs
    assert all("firing 'exchange:step=4:sigkill'" in e for e in errs)
    assert ckpt_runs["files_at_2"] == [
        ".metadata", "__0_0.distcp", "__1_0.distcp", "__2_0.distcp",
        "__3_0.distcp", "meta.json"]
    assert tckpt.latest_step(ckpt_runs["ck"]) == 8  # resumed since


def _npy_twin_ran(ckpt_runs):
    rcs, errs = ckpt_runs["npy_run"]
    assert rcs == [0], errs


def test_multiprocess_resume_on_another_mesh_and_process_count(ckpt_runs):
    """The 4-process --mesh 2,2 checkpoint resumed as 2 processes on
    --mesh 4: its step-6 checkpoint equals the uninterrupted run's."""
    rcs, errs = ckpt_runs["mesh4"]
    assert rcs == [0, 0], errs
    assert all("resumed from" in e and "at step 2" in e for e in errs)
    assert all("transport gloo" in e for e in errs)
    _held(ckpt_runs["at6"], 6)


def test_multiprocess_checkpoint_resumes_unsharded_bit_equal(ckpt_runs):
    """The 2-process step-6 checkpoint resumed in one unsharded process to
    step 8: bit-equal to the uninterrupted run."""
    rcs, errs = ckpt_runs["unsharded"]
    assert rcs == [0], errs
    _held(ckpt_runs["ck"], 8)


def test_multiprocess_resume_from_npy(ckpt_runs):
    """An npy checkpoint (one process) resumed by 2 processes on --mesh
    2,2, each reading its own slices, saving through the sharded backend:
    bit-equal to the uninterrupted run."""
    _npy_twin_ran(ckpt_runs)
    rcs, errs = ckpt_runs["npy_resume"]
    assert rcs == [0, 0], errs
    assert all("at step 4" in e for e in errs)
    _held(ckpt_runs["npy"], 8)


def test_multiprocess_kill_inside_a_sharded_write(ckpt_runs):
    """Both ranks die between their step-4 payload and the rename: the
    step-2 checkpoint stays the newest loadable state."""
    rcs, errs = ckpt_runs["atomic_run"]
    assert rcs == [-signal.SIGKILL] * 2, errs
    assert ".tmp_step_000000000004" in os.listdir(ckpt_runs["atomic"])
    assert tckpt.latest_step(ckpt_runs["atomic"]) == 2
    _held(ckpt_runs["atomic"], 2)
