"""Command-line entry point of the port::

    python -m mpi_cuda_process_tpu_torch --stencil heat3d --grid 512,512,512 \
        --iters 100 --fuse 4
    python -m mpi_cuda_process_tpu_torch --stencil wave3d --grid 256,256,256 \
        --iters 100 --compute pallas
    python -m mpi_cuda_process_tpu_torch --stencil heat3d \
        --grid 1024,1024,1024 --iters 100 --mesh 2,2 --compute pallas --overlap
    python -m mpi_cuda_process_tpu_torch --stencil heat3d \
        --grid 1024,1024,1024 --iters 100 --mesh 2,2 --fuse 4 \
        --fuse-kind stream --exchange rdma
    python -m mpi_cuda_process_tpu_torch --stencil heat2d --grid 64,64 \
        --iters 50 --device cpu --render
    python -m mpi_cuda_process_tpu_torch --stencil life --grid 512,512 \
        --iters 1000 --mesh 2 --compute pallas --overlap
    python -m mpi_cuda_process_tpu_torch --stencil grayscott3d \
        --grid 512,512,512 --iters 40 --fuse 4
    python -m mpi_cuda_process_tpu_torch --stencil sor3d --grid 128,128,128 \
        --iters 4000 --fuse 4 --tol 1e-3 --tol-check-every 100
    python -m mpi_cuda_process_tpu_torch --stencil wave3d \
        --grid 256,4096,4096 --iters 40 --mesh 4,1,1 --fuse 4 \
        --fuse-kind stream --dtype bfloat16 --mem-check error

The flags keep the TPU package's names and values, so one command line runs
on both.  ``--compute pallas`` selects the hand-written CUDA raw-step kernel
(K1/K2, Gray-Scott's), or under ``--mesh``/``--periodic`` the compute_fn
kernel (K4/K5), and on 2D grids the 2D compute_fn kernel (K7); where the TPU
package has no such kernel (advection and Gray-Scott under ``--mesh`` or
``--periodic``, or in 2D) it raises as that package does; ``--fuse K`` the
temporal-blocking kernel (3D: K3, its sharded mode under ``--mesh``, with
``--fuse-kind padfree`` K6 on a z-only mesh and K9 on a mesh that shards y,
with ``--fuse-kind stream`` the streaming kernel K10, unsharded or on any
z/y mesh, there with ``--exchange rdma`` its slab exchanges through the
ring-exchange kernel, and with ``--overlap`` the boundary shells beside the
exchange; 2D: K8, its sharded mode under a row-split ``--mesh``);
``--compute jnp`` the plain tensor path; ``--compute auto`` (the default)
the path its dispatch tables measured fastest on an H100 (``_RAW_WINS``,
``_AUTO_FUSE_K``/``_AUTO_FUSE_K_BF16`` with ``_AUTO_FUSE_KIND``,
``_AUTO_FULL_K``, ``_COMPUTE_FN_WINS``), or the plain path where no entry
applies or a kernel refuses the run's dtype, cadences or shape.
``--check-finite N`` checks every field at each N-step boundary,
``--debug-checks`` after every step (``driver.make_checked_runner``), and
both raise naming the step; ``--dump-every N --dump-dir D`` writes field 0
as ``step_{N:08d}.npy`` through the native writer pool
(``utils/native.py``).
Red-black SOR (sor2d, sor3d) has no raw-step or compute_fn kernel, so
``--compute pallas`` raises for it as in the TPU package; it runs plain or
through every ``--fuse`` kind, and ``--tol`` stops a run once its residual
falls below the tolerance.
``--dtype bfloat16`` runs on every kernel path: the raw-step kernels
(unsharded ``--compute pallas``), the compute_fn kernels (K4/K5 under
``--mesh``/``--periodic``, K7 on 2D grids), every 3D ``--fuse K`` kind (K3
unsharded and sharded with its overlap shells, K6, K9 and K10, with
``--exchange rdma``; k with ``2*k*halo`` a multiple of 16, as in the TPU
package), the 2D ``--fuse K`` kernel K8 (unsharded and row-split, any k)
and the plain path.  Other float types (float16) run the plain path only,
and Life runs its kernels in int32 only: a kernel path refuses them naming
its ROADMAP item.
``--mem-check`` (default ``error``) prices the run's device memory before
any field is allocated and refuses with the arithmetic when it cannot fit
the card (``utils/budget.py``; ``warn`` logs and goes on; skipped on the
CPU).
``--mesh`` decomposes the grid over the visible devices
(``MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=N`` puts N shards on one card),
or, launched by ``torchrun`` (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``...),
over the processes: each holds its own shards, the slabs that cross a
process boundary go through ``torch.distributed`` (``nccl`` when each
process has a card, ``gloo`` on the CPU, ``gloo`` staged through pinned
host buffers when processes share a card), and the fields equal the same
``--mesh`` run in one process bit for bit.  A multi-process run refuses
an ``npy`` checkpoint save (it would need the global grid: the sharded
backend, ``--checkpoint-backend orbax``, has each process write its own
shards) and ``--render`` (no process holds the global grid) before any
field is built; there ``--exchange rdma`` runs the ring's peer form
(``ring_send`` / ``ring_drain`` into receive slots the peers map through
CUDA IPC, or shared memory on the CPU), on one node only: across nodes,
or across cards that cannot reach each other's memory, it is refused by
name (ROADMAP B7).
``--checkpoint-backend orbax`` writes ``torch.distributed.checkpoint``'s
format, each process its own blocks, and ``--resume`` loads any format
onto this run's mesh, process count or unsharded grid.
``--pipeline`` (with ``--fuse K``, ``--mesh`` and ``--fuse-kind padfree``
or ``stream``) posts each pass's halo exchange one pass ahead of its
consumer (the slab-carry exchange; the same values).
``FAULT_INJECT`` fires the ``exchange`` fault at the chunk boundaries, the
``checkpoint`` fault in both checkpoint writers and the ``compile`` fault
where a runner is built (``resilience/faults.py``).
``--ensemble N`` runs N independent universes (member i from seed + i) in
one batched step: a leading member axis from the init through every
kernel (each launch takes all the members a block holds, the member in its
launch grid), the exchange (one shift a site for all of them), the
checkpoint and the log line; ``--ensemble-mesh M`` shards the members over
M device groups (a mesh axis in front of ``--mesh``'s, every group an
independent spatial mesh), and ``--ensemble-perturb EPS`` scales member
i's fields by ``1 + EPS u_i``.
``--groups SPEC`` partitions the devices into contiguous groups along grid
axis 0, each with its own op, refinement ratio, dtype, mesh and mode tokens
(``parallel/groups.py``), coupled only at interface bands refreshed once a
round by ``--group-transport`` (``device_put`` or ``collective``, the same
bits); it runs in one process, over the visible cards or over virtual
devices on one card, and is refused under a multi-process launcher.
The observability layer (``obs/``): ``--telemetry PATH`` writes the JSONL
event log (a provenance-stamped manifest, a record a chunk, heartbeat
verdicts, the summary; under a multi-process launch process r > 0 writes
``PATH`` with ``.p<r>`` before its extension), ``--health`` checks every
field at each chunk boundary (min/max/mean, NaN/Inf counts, the op's
invariant; DIVERGED aborts before that boundary's checkpoint),
``--halo-audit K`` re-exchanges and compares the ghost slabs bit for bit
every K chunks, ``--anomaly`` flags performance anomalies (a run that
ends with findings leaves a flight-recorder bundle), ``--profile DIR``
scopes a ``torch.profiler`` session to one steady-state chunk and
attributes the card's time to the interior and the exchange, and
``--profile-dir DIR`` traces the whole time loop; none of them changes
the step's ops or launches.  ``FAULT_INJECT``'s ``numerics`` site poisons
one cell at a chunk boundary and its ``heartbeat`` site wedges the
heartbeat's probe.
``--device`` (default ``cuda``) picks where the state lives; asking for
``cuda`` without a card raises, it never carries on on the CPU.  Only the
flags the port runs are registered; a combination that needs a kernel or
module not ported yet raises, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import logging
import math
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import driver
from .config import RunConfig, parse_int_tuple, parse_params
from .ops import stencil as stencil_lib
# populate the registry
from .ops import advection, heat, life, reaction, sor, wave  # noqa: F401
from .ops.cuda import fullgrid as fullgrid_lib
from .ops.cuda import fused as fused_lib
from .ops.cuda import kernels as kernels_lib
from .ops.cuda import rawstep, streamfused
from .ops.cuda._build import FLOAT_DTYPES
from .parallel import groups as groups_lib
from .parallel import halo
from .parallel import mesh as mesh_lib
from .parallel import stepper as stepper_lib
from .parallel.stepper import GLOBAL_GRID_REASON
from .resilience import faults
from .utils import checkpointing, diagnostics, native, render
from .utils.init import init_state, init_state_sharded

log = logging.getLogger("mpi_cuda_process_tpu_torch")

# Every kernel takes float32 and bfloat16 (Life: int32); a kernel path
# refuses any other type by its own item.
_OTHER_DTYPE_ITEMS = {
    "raw": "ROADMAP B1 (the raw-step kernels take float32 and bfloat16)",
    "compute_fn": "ROADMAP B2 (the compute_fn kernels K4, K5 and K7 take "
                  "float32 and bfloat16)",
    "fused": "ROADMAP B3 (the fused kernels K3, K6 and K9 take float32 and "
             "bfloat16)",
    "stream": "ROADMAP B5 (the streaming kernel takes float32 and "
              "bfloat16)",
    "fullgrid": "ROADMAP B6 (the 2D k-step kernel K8 takes float32 and "
                "bfloat16)",
    "life": "ROADMAP B10 (Life runs on K7 and K8 in int32 only)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_cuda_process_tpu_torch",
        description="stencil / finite-difference framework on PyTorch + CUDA",
    )
    p.add_argument("--stencil", default="heat2d",
                   choices=stencil_lib.available_stencils())
    p.add_argument("--grid", type=parse_int_tuple, default=(512, 512),
                   help="grid shape, e.g. 512,512 or 256x256x256")
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--mesh", type=parse_int_tuple, default=(),
                   help="per-grid-axis shard counts, e.g. 2,2 (default: "
                        "unsharded); needs that many devices, or "
                        f"{mesh_lib.VIRTUAL_DEVICES_ENV}=N for N shards on "
                        "one device; under torchrun the shards are spread "
                        "over the processes, each holding its own")
    p.add_argument("--groups", default="",
                   help="MPMD device groups (parallel/groups.py): "
                        "partition the slice into contiguous sub-meshes "
                        "along grid axis 0, each running its OWN op / "
                        "refinement ratio / dtype / mesh, coupled only "
                        "at interface faces — e.g. "
                        "\"wave3d:fine@0-3:z1/4,heat3d:coarse@4-7\" runs "
                        "a 2x-refined wave3d hot region over the first "
                        "quarter of z on devices 0-3 inside a coarse "
                        "heat3d far-field on devices 4-7.  Clause "
                        "grammar: <op>[:fine[R]|:coarse][:<dtype>]@"
                        "<d0>-<d1>[:z<num>/<den>][:mesh<m0>x<m1>...]"
                        "[:<mode>+<mode>...].  Each group's interior "
                        "step runs on its own sub-mesh; a trailing "
                        "'+'-joined mode token (fuse<K>/stream/padfree/"
                        "overlap/pipeline/plain, e.g. "
                        ":fuse2+stream+overlap) routes it through the "
                        "matching fused/overlapped stepper UNMODIFIED "
                        "(fuse<K> must agree across groups; 'plain' "
                        "locks the default; no token = unset, "
                        "--auto-policy may resolve it per group).  The "
                        "ghost-band interface refresh is the only "
                        "cross-group traffic (jaxprcheck."
                        "assert_coupled_structure pins it).  A 2-group "
                        "same-physics split is bit-exact vs the "
                        "monolithic run under every legal mode combo.  "
                        "Excludes the monolithic mode flags (--mesh/"
                        "--fuse/--ensemble/--overlap/--pipeline/...): "
                        "per-group behavior lives in the clauses")
    p.add_argument("--group-transport", default="device_put",
                   choices=["device_put", "collective"],
                   help="interface transport for --groups: device_put "
                        "(host-ordered buffer moves between the group "
                        "meshes — correct on any backend) | collective "
                        "(one union-mesh shard_map whose per-interface "
                        "ppermutes move the raw edge rows chip to chip; "
                        "resample/cast shard-local on the receiver — "
                        "bit-identical to device_put, zero host hops, "
                        "jaxprcheck.assert_group_transport_structure "
                        "pins exactly 2 ppermutes per interface and "
                        "zero device_put)")
    p.add_argument("--dtype", default=None,
                   help="float32|bfloat16|float16 (default: the stencil's "
                        "own); every kernel takes float32 and bfloat16 "
                        "(Life: int32), the plain path any float type")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--density", type=float, default=0.15,
                   help="initial alive fraction of --init random (Life)")
    p.add_argument("--init", default="auto",
                   choices=["auto", "random", "zero", "pulse", "patch"])
    p.add_argument("--periodic", action="store_true",
                   help="periodic BCs instead of guard-cell frame")
    p.add_argument("--param", action="append", default=[],
                   help="stencil parameter override, key=value (repeatable)")
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--check-finite", type=int, default=0,
                   help="every N steps, verify all fields are finite and "
                        "abort with the failing step range if not (debug "
                        "sanitizer for blow-ups: NaN/Inf from unstable "
                        "parameters)")
    p.add_argument("--debug-checks", action="store_true",
                   help="debug mode: every step asserts all fields finite "
                        "(the error names the exact failing step); slower "
                        "— complements --check-finite's polling")
    p.add_argument("--health", action="store_true",
                   help="numerics sentinel (obs/health.py): at every "
                        "chunk boundary a health reduction outside the "
                        "step computes per-field global min/max/mean and "
                        "NaN/Inf counts plus the op's registered "
                        "invariant (heat: total heat; wave: the leapfrog "
                        "discrete energy; sor: the residual norm), block "
                        "by block on the device and combined across "
                        "processes, never gathering field state; a "
                        "DIVERGED verdict aborts the run before that "
                        "boundary's checkpoint.  With no logging cadence "
                        "a ~8-chunk boundary cadence is synthesized")
    p.add_argument("--anomaly", action="store_true",
                   help="run doctor (obs/anomaly.py): performance-anomaly "
                        "detection at chunk boundaries from the chunk "
                        "records (throughput collapse against the run's "
                        "own baseline, kernel library loads after chunk "
                        "0, device-memory creep, growing chunk-time "
                        "variance, boundary stalls, straggler groups); "
                        "findings are 'anomaly' events and a DEGRADED "
                        "verdict, and a run that ends with findings "
                        "leaves a flight-recorder bundle beside its "
                        "telemetry log")
    p.add_argument("--halo-audit", type=int, default=0, metavar="K",
                   help="exchange audit (obs/health.py), every K chunks: "
                        "re-exchange the ghost slabs through the run's "
                        "transport (--exchange ppermute or rdma) and "
                        "compare every received slab bit for bit with "
                        "the neighbour's border rows read straight from "
                        "its block (an all_gather across processes); a "
                        "mismatch aborts naming the (field, axis, "
                        "direction, ring-shard) site.  Needs a sharded "
                        "--mesh")
    p.add_argument("--dump-every", type=int, default=0,
                   help="async-dump field0 snapshots every N steps (.npy, "
                        "non-blocking via the native writer pool)")
    p.add_argument("--dump-dir", default=None)
    p.add_argument("--ensemble", type=int, default=0,
                   help="run N independent universes batched through ONE "
                        "compiled step (seeds seed..seed+N-1; a leading "
                        "member axis rides init -> stepper -> "
                        "diagnostics).  Composes with --mesh: the "
                        "batched sharded steppers vmap the local update "
                        "per member, so the halo exchange stays ONE "
                        "round per site regardless of N and every Pallas "
                        "kernel gains one batch grid dimension — the "
                        "per-step fixed costs (exchange rounds, kernel "
                        "launches, compile, telemetry cadence) are paid "
                        "once per BATCH.  Composes with --fuse (every "
                        "kind incl. stream), --overlap, --pipeline, and "
                        "--exchange rdma")
    p.add_argument("--ensemble-mesh", type=int, default=0, metavar="M",
                   help="shard the member axis over M device groups — "
                        "the ensemble becomes a THIRD mesh axis "
                        "(ensemble x y x z, e.g. a v5e-64 as 8x8 "
                        "spatial x M-way ensemble; each group is an "
                        "independent spatial mesh, so halo ppermutes "
                        "never cross members).  Needs --ensemble N with "
                        "N %% M == 0 and M x prod(--mesh) devices; "
                        "0/1 = every device holds all N members")
    p.add_argument("--ensemble-perturb", type=float, default=0.0,
                   metavar="EPS",
                   help="per-member init perturbation: member i's "
                        "inexact fields scaled by 1 + EPS * u_i with "
                        "u_i ~ U(-1,1) drawn from (seed, i) — "
                        "deterministic parameter diversity for ensemble "
                        "studies beyond the per-member seeds (guard "
                        "frames re-pinned; integer fields untouched)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-backend", default="npy",
                   choices=["npy", "orbax"],
                   help="npy: .npy files + meta.json of the global grid "
                        "(one process); orbax: the sharded backend — the "
                        "port writes torch.distributed.checkpoint's format, "
                        "each process its own blocks, and a resume reads "
                        "them onto any mesh or process count")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--render", action="store_true",
                   help="ASCII-render the final grid")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the WHOLE "
                        "time loop (raw trace only; for chunk-scoped "
                        "attribution use --profile)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="device-trace attribution (obs/profile.py): scope "
                        "a torch.profiler session to ONE steady-state "
                        "chunk (the first after the kernel build and "
                        "warm-up; started and stopped at chunk "
                        "boundaries, the step untouched), then bucket "
                        "the card's time into interior compute and the "
                        "exchange (NCCL and ring kernels, peer copies, "
                        "halo.py's pad and slab copies) with a measured "
                        "overlap efficiency and the chunk's idle share, "
                        "logged and, with --telemetry, recorded as a "
                        "'profile' event.  On the CPU (no device lanes) "
                        "the record says 'attribution: unavailable'")
    p.add_argument("--telemetry", default=None, metavar="PATH",
                   help="write a JSONL telemetry event log: a "
                        "provenance-stamped run manifest (config, mesh, "
                        "git sha, PyTorch and CUDA versions, the card's "
                        "name and power limit), per-chunk runtime stats "
                        "(first chunk vs steady state, kernel library "
                        "loads mid-run, device-memory peaks), heartbeat "
                        "verdicts and a summary; under a multi-process "
                        "launch process r > 0 writes PATH with .p<r> "
                        "before its extension")
    p.add_argument("--supervise", action="store_true",
                   help="fault-tolerant run supervisor "
                        "(resilience/supervisor.py): the run goes in a "
                        "child process (python -m "
                        "mpi_cuda_process_tpu_torch, with --checkpoint-every"
                        " and --telemetry forced on), its telemetry "
                        "watched; on a WEDGED/STALLED verdict, the child's "
                        "death or a wall-clock stall with no events the "
                        "child is killed and, after an exponential backoff,"
                        " relaunched with --resume from the latest "
                        "checkpoint (bit-equal to an uninterrupted run); "
                        "the trail lands in PATH.supervisor.jsonl.  Gives "
                        "up (exit 1) after --max-restarts.  One process "
                        "only (refused under torchrun)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="supervised relaunches before giving up "
                        "(default 2)")
    p.add_argument("--restart-backoff", type=float, default=5.0,
                   help="supervised restart backoff base seconds "
                        "(doubles per restart, bounded; default 5)")
    p.add_argument("--supervise-stall-s", type=float, default=600.0,
                   help="supervisor wall-clock kill threshold: seconds "
                        "with no child telemetry event (default 600; set "
                        "it above the child's longest silent phase, the "
                        "first kernel build with nvcc included)")
    p.add_argument("--degraded-action", default="warn",
                   choices=["warn", "restart", "abort"],
                   help="what --supervise does about a DEGRADED child "
                        "(anomaly events in its telemetry): warn = keep "
                        "watching (default), restart = kill and resume "
                        "from the latest checkpoint, abort = give up with "
                        "the flight-recorder bundle")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   dest="serve_port",
                   help="live run console (obs/serve.py): an HTTP service "
                        "over this run's telemetry log exposing /metrics "
                        "(Prometheus text: steps/s, Gcells/s, compile vs "
                        "steady split, recompiles, memory peak, heartbeat "
                        "and health verdicts, the ledger's best-known "
                        "values), /status.json (manifest provenance + "
                        "latest chunk + verdicts; under a multi-process "
                        "launch one 'hosts' row a process, served by "
                        "process 0 alone) and /events?after=SEQ "
                        "(incremental NDJSON tail, bounded long-poll).  "
                        "PORT 0 binds an ephemeral port; the bound "
                        "address is logged and written into the log as a "
                        "'serve' event.  Implies --telemetry (a default "
                        "path is derived when unset).  The server only "
                        "tails the log the run writes anyway: no op and "
                        "no launch in the step.  Shuts down with the run")
    p.add_argument("--compute", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="auto: the path the dispatch tables measured "
                        "fastest on an H100 for the stencil, dtype and "
                        "cadences (a --fuse k kernel, the raw-step kernel, "
                        "the compute_fn kernel, or the plain path); jnp: "
                        "the plain tensor path; pallas: the hand-written "
                        "CUDA raw-step kernel, or the compute_fn kernel "
                        "under --mesh or --periodic and on 2D grids")
    p.add_argument("--overlap", action="store_true",
                   help="under --mesh: compute the bulk of each block while "
                        "the halo exchange runs (side CUDA stream), then "
                        "the boundary rings (with --fuse K: the 2*K*halo "
                        "deep boundary shells); same values")
    p.add_argument("--pipeline", action="store_true",
                   help="with --fuse K --mesh and a slab-operand "
                        "--fuse-kind (padfree, stream): post each pass's "
                        "halo exchange from the previous pass's border rows "
                        "(with --overlap its boundary shells), one pass "
                        "ahead of its consumer; same values (for parity "
                        "with the JAX package: no gain measured on one "
                        "card)")
    p.add_argument("--tol", type=float, default=0.0,
                   help="stop when the residual max|u - u_prev_check| over a "
                        "--tol-check-every-step interval drops below TOL "
                        "(solver-style convergence; --iters is the step cap)")
    p.add_argument("--tol-check-every", type=int, default=10,
                   help="steps between residual checks for --tol")
    p.add_argument("--fuse", type=int, default=0,
                   help="temporal blocking: advance K steps per memory pass "
                        "with the hand-written CUDA fused kernel (3D "
                        "windows, or the 2D whole-grid kernel)")
    p.add_argument("--fuse-kind", default="auto",
                   choices=["auto", "tiled", "padfree", "stream"],
                   help="unsharded: auto/tiled/padfree all run the one "
                        "fused kernel; under --mesh: auto = the padded "
                        "kind, padfree = the slab-operand kernels (z slabs "
                        "on a z-only mesh; z and y slabs and corners on a "
                        "mesh that shards y; every 3D fused family); "
                        "stream = the streaming kernel (each plane "
                        "read once per pass; guard-frame only; every 3D "
                        "fused family), unsharded or with the padfree "
                        "operands under --mesh")
    p.add_argument("--exchange", default="ppermute",
                   choices=["ppermute", "rdma"],
                   help="halo-exchange transport for sharded --fuse runs: "
                        "ppermute = slab copies between the shards' "
                        "blocks (the default every other mode uses); "
                        "rdma = the ring-exchange kernel: each slab goes "
                        "chunk by chunk straight into its place in the "
                        "neighbour's received slab, each chunk counted on "
                        "its ready counter (no receive ring, no credits), "
                        "one launch per exchange site for every ring on a "
                        "card; across processes (one node) a send into "
                        "the peers' receive slots and a drain, under "
                        "ready flags and credits.  Needs "
                        "--fuse, --mesh and --fuse-kind stream, "
                        "guard-frame only; composes with --overlap; the "
                        "same values as ppermute")
    p.add_argument("--mem-check", default="error",
                   choices=["off", "warn", "error"],
                   help="device-memory budget guard: estimate the run's "
                        "peak bytes per card before allocating any field "
                        "and refuse with the arithmetic (error), log and "
                        "go on (warn) or skip (off); skipped on the CPU")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the state lives (default cuda; raises "
                        "without a card)")
    return p


def config_from_args(argv=None) -> RunConfig:
    a = build_parser().parse_args(argv)
    return RunConfig(
        stencil=a.stencil, grid=a.grid, iters=a.iters, dtype=a.dtype,
        mesh=a.mesh, groups=a.groups, group_transport=a.group_transport,
        seed=a.seed, density=a.density, init=a.init,
        periodic=a.periodic,
        log_every=a.log_every, checkpoint_every=a.checkpoint_every,
        check_finite=a.check_finite, debug_checks=a.debug_checks,
        dump_every=a.dump_every, dump_dir=a.dump_dir,
        checkpoint_dir=a.checkpoint_dir,
        checkpoint_backend=a.checkpoint_backend, resume=a.resume,
        render=a.render, profile_dir=a.profile_dir, profile=a.profile,
        telemetry=a.telemetry, serve_port=a.serve_port, health=a.health,
        anomaly=a.anomaly, degraded_action=a.degraded_action,
        supervise=a.supervise, max_restarts=a.max_restarts,
        restart_backoff=a.restart_backoff,
        supervise_stall_s=a.supervise_stall_s,
        halo_audit=a.halo_audit, compute=a.compute, overlap=a.overlap,
        pipeline=a.pipeline, fuse=a.fuse, ensemble=a.ensemble,
        ensemble_mesh=a.ensemble_mesh, ensemble_perturb=a.ensemble_perturb,
        tol=a.tol, tol_check_every=a.tol_check_every,
        fuse_kind=a.fuse_kind, exchange=a.exchange, mem_check=a.mem_check,
        device=a.device,
        params=parse_params(a.param),
    )


# Dispatch tables of ``--compute auto``, keyed by the stencil's name (mdf
# runs heat2d's), the counterparts of the TPU package's v5e tables.  Every
# entry is read from one NVIDIA H100 80GB HBM3 at 700 W:
# ``scripts/torch_dispatch_times.py``, PERF.md section 5 ("Dispatch"),
# ms/step of every candidate path at 256^3, 512^3 and 1024^3 (2D: 512^2
# for 1000 steps and 16384^2), float32 and bfloat16.  As in the TPU
# package, a family is entered only where its path won at every measured
# size; a run whose dtype, cadences or shape the kernel refuses stays on
# the plain path (auto never raises for a kernel).
#
# The whole-step raw kernels (K1, K2, Gray-Scott's) beat the plain step
# 7-45x at every size in both dtypes (heat3d 0.058 / 0.406 / 3.60 ms
# against 0.788 / 5.96 / 47.4 in float32; heat3d27 0.107 / 0.635 / 5.00
# against 3.69 / 28.0 / 223).  The streaming kernel beats them only at
# 1024^3 (heat3d, wave3d) or from 512^3 (grayscott3d float32) and loses
# 2-4x at 256^3, so no 3D raw family takes temporal blocking.  The plain
# step lost at 256^3, the smallest size timed, so unlike the TPU package
# (_RAW_ABOVE_CLIFF) no family keeps the plain step below a size.
_RAW_WINS: frozenset = frozenset({
    "heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d", "grayscott3d"})
# Temporal blocking k (3D, unsharded), by dtype.  sor3d has no raw kernel:
# float32 K3 k = 2 is the fastest path at every size (0.135 / 0.893 / 6.56
# ms against plain 1.77 / 13.4 / 107); bfloat16 K3 k = 4 beats plain 4x at
# every size (0.289 / 2.14 / 16.6 against 1.23 / 9.02 / 71.4) and K10 k = 4
# only from 512^3 (1.70 / 12.3), losing 3x at 256^3 (0.870).
_AUTO_FUSE_K: dict = {"sor3d": 2}
_AUTO_FUSE_K_BF16: dict = {"sor3d": 4}
# The kind ("stream": K10) where the streaming kernel won at every size:
# none.
_AUTO_FUSE_KIND: dict = {}
# 2D: the whole-grid kernel K8 at k = 8 beats plain and K7 at 512^2 (1000
# steps, BASELINE config 1) and 16384^2 in both dtypes for every family
# (heat2d 0.029 / 0.574 ms against plain 0.196 / 9.43 and K7 0.257 / 3.13);
# k = 4 is faster at 512^2 in float32 (0.025) and 1.65x slower at 16384^2,
# and k = 16 does not divide config 1's 1000 steps.
_AUTO_FULL_K: dict = {name: 8 for name in (
    "heat2d", "life", "wave2d", "advect2d", "grayscott2d", "sor2d")}
# The compute_fn kernels (K4, K5; 2D: K7) against the plain step where they
# plug in, by placement: "mesh" (1024^3 on --mesh 2,2, 16384^2 on --mesh
# 4; heat3d 11.7 ms against 46.3, heat2d 2.90 against 9.25) and "single"
# (unsharded: 3D --periodic at every 3D size, heat3d 0.302 / 2.26 / 19.0
# against 0.870 / 6.62 / 53.4; 2D at 512^2 and 16384^2).  heat2d's K7
# loses unsharded at 512^2 (0.257 against 0.196), Life's wins (0.197
# against 0.281).
_COMPUTE_FN_WINS: dict = {
    **{name: frozenset({"mesh", "single"}) for name in (
        "heat3d", "heat3d27", "heat3d4th", "wave3d", "life")},
    "heat2d": frozenset({"mesh"}),
}

# RunConfig fields the port does not run yet: (field, flag, ROADMAP item).
# A config that sets one raises from build() by flag name.
_UNPORTED = (
    ("serve_engine", "--serve-engine", "A8 (serving)"),
    ("serve_router", "--serve-router", "A8 (serving)"),
    ("auto_policy", "--auto-policy", "A8 (policy)"),
    ("policy_recheck", "--policy-recheck", "A8 (policy)"),
    ("kernel_variant", "--kernel-variant", "A8 (policy)"),
    ("autotune", "--autotune", "A8 (policy)"),
    ("compile_cache", "--compile-cache", "A8 (serving)"),
)


def _refuse_unported(cfg: RunConfig) -> None:
    defaults = RunConfig()
    for field, flag, item in _UNPORTED:
        if getattr(cfg, field) != getattr(defaults, field):
            raise NotImplementedError(
                f"the port does not run {flag} yet: ROADMAP {item}")


def _device(cfg: RunConfig) -> torch.device:
    dev = torch.device(cfg.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is available (pass --device cpu "
            "to run on the CPU)")
    return dev


def _make_cfg_stencil(cfg: RunConfig):
    params = dict(cfg.params)
    if cfg.dtype:
        params.setdefault("dtype", cfg.dtype)
    return stencil_lib.make_stencil(cfg.stencil, **params)


def maybe_auto_fuse(cfg: RunConfig) -> RunConfig:
    """Upgrade an eligible ``--compute auto`` run to ``--fuse k``.

    Applies to the measured fused-kernel winners (``_AUTO_FUSE_K`` and
    ``_AUTO_FUSE_K_BF16`` in 3D, by dtype; ``_AUTO_FULL_K`` in 2D), on a
    card, unsharded, only when every cadence (iters, log, checkpoint,
    check-finite and dump intervals) is a multiple of k, nothing observes
    single steps (``--debug-checks``, ``--tol``) and the kernel accepts the
    run's stencil, dtype and grid: each probe is the function ``build()``
    will call for the chosen kind.  A ``"stream"`` kind that does not fit
    falls through to the window kernel's probe; a run no probe accepts
    stays as it is.
    """
    if cfg.compute != "auto" or cfg.fuse or cfg.fuse_kind != "auto":
        # a forced kind without --fuse must reach build()'s guard
        return cfg
    if torch.device(cfg.device).type != "cuda":
        return cfg
    st = _make_cfg_stencil(cfg)
    if len(cfg.grid) == 2:
        k = _AUTO_FULL_K.get(st.name)
    else:
        k = {torch.float32: _AUTO_FUSE_K,
             torch.bfloat16: _AUTO_FUSE_K_BF16}.get(st.dtype, {}).get(
                 st.name)
    if k is None:
        return cfg
    if (cfg.periodic or cfg.tol > 0 or cfg.debug_checks or cfg.ensemble
            or cfg.overlap or cfg.pipeline or cfg.resume
            or cfg.exchange != "ppermute" or cfg.mesh):
        return cfg
    cadences = [cfg.iters, cfg.log_every, cfg.checkpoint_every,
                cfg.check_finite, cfg.dump_every]
    if any(v % k for v in cadences if v):
        return cfg
    if st.ndim == 2:
        up = dataclasses.replace(cfg, fuse=k)
        if _dtype_refusal(up, st, False) or \
                fullgrid_lib.make_fullgrid_step(st, cfg.grid, k) is None:
            return cfg
        log.info("auto: temporal blocking k=%d (whole-grid CUDA kernel)", k)
        return up
    if _AUTO_FUSE_KIND.get(st.name) == "stream":
        up = dataclasses.replace(cfg, fuse=k, fuse_kind="stream")
        if not _dtype_refusal(up, st, False) and \
                streamfused.make_stream_fused_step(st, cfg.grid, k) \
                is not None:
            log.info("auto: temporal blocking k=%d (streaming CUDA "
                     "kernel)", k)
            return up
        # the streaming rings do not fit: try the window kernel
    up = dataclasses.replace(cfg, fuse=k)
    if _dtype_refusal(up, st, False) or \
            fused_lib.make_fused_step(st, cfg.grid, k) is None:
        return cfg
    log.info("auto: temporal blocking k=%d (fused CUDA kernel)", k)
    return up


def _dtype_refusal(cfg: RunConfig, st, use_mesh: bool):
    """None where the run's kernel path takes the stencil's dtype, else
    the ROADMAP item of the path's kernel: every kernel takes float32 and
    bfloat16 (Life: int32 only); the plain path takes any dtype."""
    if not (cfg.fuse or cfg.compute == "pallas"):
        return None
    if st.name == "life":
        return None if st.dtype == torch.int32 else _OTHER_DTYPE_ITEMS["life"]
    if st.dtype in FLOAT_DTYPES:
        return None
    if st.ndim == 2:
        return _OTHER_DTYPE_ITEMS["fullgrid" if cfg.fuse else "compute_fn"]
    if not cfg.fuse:
        return _OTHER_DTYPE_ITEMS["compute_fn" if use_mesh or cfg.periodic
                                  else "raw"]
    return _OTHER_DTYPE_ITEMS["stream" if cfg.fuse_kind == "stream"
                              else "fused"]


def _check_mem_budget(cfg: RunConfig, st, mesh) -> None:
    """The device-memory guard (``utils/budget.py``), as the TPU package's
    ``_check_mem_budget``: on a card only, before any field is allocated,
    priced for the path the run takes (``compute="raw"`` where the raw
    kernel runs) and for every shard the card holds."""
    if cfg.mem_check == "off" or torch.device(cfg.device).type != "cuda":
        return
    from .utils import budget

    compute = cfg.compute
    if not cfg.fuse and _raw_eligible(cfg, st) and \
            rawstep.make_raw_step(st, cfg.grid) is not None:
        compute = "raw"
    shards = budget.shards_on_card(mesh)
    try:
        total, _ = budget.check_budget(
            st, cfg.grid, mesh=cfg.mesh, fuse=cfg.fuse,
            ensemble=cfg.ensemble, periodic=cfg.periodic, compute=compute,
            fuse_kind=cfg.fuse_kind, overlap=cfg.overlap,
            pipeline=cfg.pipeline, exchange=cfg.exchange,
            ensemble_mesh=cfg.ensemble_mesh, shards_per_device=shards,
            processes=mesh.processes if mesh is not None else 1)
    except ValueError:
        if cfg.mem_check == "error":
            raise
        log.warning("device memory budget exceeded (--mem-check warn): "
                    "proceeding anyway; expect an out-of-memory error",
                    exc_info=True)
    else:
        log.info("memory budget: ~%.2f GiB per device estimated",
                 total / 2**30)
    if cfg.checkpoint_backend == "orbax" and cfg.checkpoint_dir:
        log.info("checkpoint staging: ~%.2f GiB of host memory a process "
                 "(one block at a time)",
                 budget.checkpoint_host_bytes(st, cfg.grid, cfg.mesh) / 2**30)


def _uses_mesh(cfg: RunConfig) -> bool:
    """Whether this run decomposes over a device mesh (sharded step_fn):
    a spatial decomposition (``--mesh``), or a pure data-parallel ensemble
    (``--ensemble-mesh`` with no spatial axes); ``--ensemble`` alone stays
    on the single-device batched path, as in the TPU package."""
    return (bool(cfg.mesh) and math.prod(cfg.mesh) > 1) \
        or cfg.ensemble_mesh > 1


def _raw_eligible(cfg: RunConfig, st) -> bool:
    """Structural eligibility of the whole-step raw kernel: always under
    ``--compute pallas`` (a refused dtype raises there by its item), under
    ``auto`` on a card for the measured winners in a dtype the kernels
    take."""
    if cfg.periodic or cfg.ensemble or cfg.fuse or cfg.compute == "jnp" \
            or _uses_mesh(cfg):
        return False
    if cfg.compute == "pallas":
        return True
    if torch.device(cfg.device).type != "cuda" or \
            st.dtype not in FLOAT_DTYPES:
        return False
    return st.name in _RAW_WINS


def resolve_raw_step(cfg: RunConfig, st):
    """Whole-step raw kernel (K1/K2, Gray-Scott's) for eligible runs, or
    None."""
    if not _raw_eligible(cfg, st) or not rawstep.raw_step_supported(st):
        return None
    return rawstep.make_raw_step(st, cfg.grid, device=cfg.device)


def _compute_fn_auto(cfg: RunConfig, st) -> bool:
    """Whether ``--compute auto`` takes the compute_fn kernel: on a card,
    where the kernel plugs into the step (``--mesh``, ``--periodic``, 2D
    grids) and won in that placement (``_COMPUTE_FN_WINS``), in a dtype it
    takes."""
    if cfg.compute != "auto" or torch.device(cfg.device).type != "cuda":
        return False
    if not kernels_lib.has_pallas_kernel(st.name):
        return False
    if not (_uses_mesh(cfg) or cfg.periodic or st.ndim == 2):
        return False
    place = "mesh" if _uses_mesh(cfg) else "single"
    if place not in _COMPUTE_FN_WINS.get(st.name, ()):
        return False
    pallas = dataclasses.replace(cfg, compute="pallas")
    return _dtype_refusal(pallas, st, _uses_mesh(cfg)) is None


def resolve_compute_fn(cfg: RunConfig, st):
    """The ``compute_fn`` kernel (K4/K5, 2D: K7) that plugs into the step
    when the raw kernel does not apply (``--mesh``, ``--periodic``, 2D
    grids): always under ``--compute pallas``, under ``auto`` where it was
    measured faster than the plain update (``_COMPUTE_FN_WINS``); None
    otherwise."""
    if cfg.compute == "pallas":
        if not kernels_lib.has_pallas_kernel(st.name):
            raise ValueError(f"no pallas kernel for {st.name!r}")
    elif not _compute_fn_auto(cfg, st):
        return None
    log.info("compute: compute_fn CUDA kernel (%s)", st.name)
    return kernels_lib.make_pallas_compute(st, device=cfg.device)


def _resume(cfg: RunConfig, st, device, mesh=None):
    """Load the checkpoint (any format) into this run's blocks: the
    blocks of ``mesh`` this process holds, each on its device, or the
    whole fields when unsharded (with ``--ensemble`` N, the batched
    ``(N, *grid)`` fields, cut over the ensemble groups).  Every block
    reads its own part of the checkpoint (``checkpointing.load_any``); no
    process gathers."""
    grid = tuple(cfg.grid)
    members = (cfg.ensemble,) if cfg.ensemble else ()
    if mesh is not None:
        n_local = stepper_lib.ensemble_members_local(mesh, cfg.ensemble)
        local = (n_local,) * bool(n_local) + tuple(
            g // c for g, c in zip(grid, mesh.counts(len(grid))))
        targets = tuple(
            stepper_lib.ShardedField(
                [torch.empty(local, dtype=st.dtype, device=mesh.device(c))
                 for c in mesh.local_coords()], mesh, members + grid,
                lead=len(members))
            for _ in range(st.num_fields))
    else:
        targets = tuple(torch.empty(members + grid, dtype=st.dtype,
                                    device=device)
                        for _ in range(st.num_fields))
    sharded = checkpointing.checkpoint_format(cfg.checkpoint_dir) == "dcp"
    if sharded:
        # its first import takes seconds, which are not the read's
        import torch.distributed.checkpoint as dcp  # noqa: F401
    t0 = time.perf_counter()
    fields, start_step, _ = checkpointing.load_any(cfg.checkpoint_dir,
                                                   target_fields=targets)
    seconds = time.perf_counter() - t0
    log.info("resumed from %s at step %d", cfg.checkpoint_dir, start_step)
    if sharded:
        log.info("checkpoint read: %d bytes of this process's blocks in "
                 "%.3fs", checkpointing.local_nbytes(fields), seconds)
    return fields, start_step


def _make_run_mesh(cfg: RunConfig, device):
    """The run's mesh over the visible devices of ``--device``, or, once
    a launcher's cluster is bootstrapped, over every process."""
    mesh_lib.bootstrap_distributed(device=device.type)
    m = mesh_lib.make_mesh(cfg.mesh, mesh_lib.local_devices(device.type),
                           ensemble=cfg.ensemble_mesh or 1)
    name = "x".join(map(str, m.full_shape)) or "1"
    if m.ensemble > 1:
        name += f" (ensemble {m.ensemble} x spatial " + (
            "x".join(map(str, cfg.mesh)) or "1") + ")"
    if m.multiprocess:
        log.info("mesh %s: %d shards over %d processes, %d here on %s; "
                 "transport %s", name, m.size,
                 m.processes, m.per_process, m.devices[0], m.backend)
        _refuse_multiprocess(cfg, m)
    else:
        log.info("mesh %s: %d shards on %d device(s)", name, m.size,
                 len(m.unique_devices()))
    return m


def _saves_checkpoints(cfg: RunConfig) -> bool:
    """Whether the run writes a checkpoint: every --checkpoint-every
    boundary and the last step, or a --tol run's final state."""
    return bool(cfg.checkpoint_dir) and bool(cfg.checkpoint_every
                                             or cfg.tol > 0)


def _refuse_multiprocess(cfg: RunConfig, m) -> None:
    """What a multi-process run cannot do yet, refused by its item before
    any field is built."""
    if cfg.checkpoint_backend == "npy" and _saves_checkpoints(cfg):
        raise ValueError(
            "--checkpoint-dir on a multi-process run: "
            f"{checkpointing.NPY_ACROSS_PROCESSES}")
    if cfg.render:
        raise ValueError(
            f"--render draws the global grid, and {GLOBAL_GRID_REASON}")
    if _dumps(cfg):
        raise ValueError(
            f"--dump-every writes field 0 of the global grid, and "
            f"{GLOBAL_GRID_REASON}")
    if cfg.exchange == "rdma":
        _refuse_peer_ring(m)


def _dumps(cfg: RunConfig) -> bool:
    """Whether the run writes ``--dump-every`` snapshots."""
    return bool(cfg.dump_every and cfg.dump_dir)


def _refuse_peer_ring(m) -> None:
    """The peer ring maps every peer's device memory (CUDA IPC) or its
    shared-memory file: every process must be on this node, and with a
    card a process, every pair of cards must reach each other's memory
    (``cudaDeviceCanAccessPeer``).  Refused by name; never carried by
    gloo instead."""
    if not mesh_lib.same_node():
        raise NotImplementedError(
            "--exchange rdma across nodes: the peer ring maps its peers' "
            "memory through CUDA IPC or shared memory, which reach one node "
            f"only (LOCAL_WORLD_SIZE={os.environ.get('LOCAL_WORLD_SIZE')} "
            f"of WORLD_SIZE={m.processes}): {halo.RDMA_NODES_ITEM}")
    if m.devices[0].type != "cuda":
        return
    n = torch.cuda.device_count()
    cards = sorted({r % n for r in range(int(os.environ.get(
        "LOCAL_WORLD_SIZE", m.processes)))})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise NotImplementedError(
                    f"--exchange rdma: cuda:{a} cannot access cuda:{b}'s "
                    "memory (cudaDeviceCanAccessPeer is false), so the peer "
                    "ring cannot write into its receive slots: "
                    f"{halo.RDMA_ITEM}")


def _validate_ensemble(cfg: RunConfig) -> None:
    """Fail-fast checks for the batched-run flags (before any build), the
    TPU package's checks and messages."""
    if cfg.ensemble_mesh > 1:
        if not cfg.ensemble:
            raise ValueError(
                "--ensemble-mesh shards the member axis of a batched "
                "run; it needs --ensemble N")
        if cfg.ensemble % cfg.ensemble_mesh:
            raise ValueError(
                f"--ensemble {cfg.ensemble} not divisible by "
                f"--ensemble-mesh {cfg.ensemble_mesh}")
    if cfg.ensemble_perturb and not cfg.ensemble:
        raise ValueError(
            "--ensemble-perturb perturbs ensemble members; it needs "
            "--ensemble N")


def build(cfg: RunConfig):
    """Materialize (stencil, step_fn, fields, start_step) from a config.

    ``--ensemble N`` builds the batched step: unsharded, the plain step or
    the ``--fuse`` kernel step (K3, K8, K10 with ``batch=N``) over the
    member axis (``driver.make_ensemble_step``); under ``--mesh`` or
    ``--ensemble-mesh`` the sharded steppers with ``ensemble=N``; and the
    batched fields (``init_state(..., ensemble=N, perturb=EPS)``)."""
    _refuse_unported(cfg)
    if cfg.groups:
        raise ValueError("build() makes one monolithic run; a --groups "
                         "config is built by build_coupled()")
    if cfg.group_transport not in ("", "device_put"):
        raise ValueError(
            "--group-transport selects the --groups interface "
            "transport; a monolithic run has no interfaces to move — "
            "drop the flag or pass --groups")
    device = _device(cfg)
    st = _make_cfg_stencil(cfg)
    _validate_ensemble(cfg)
    if cfg.fuse_kind != "auto" and not cfg.fuse:
        raise ValueError("--fuse-kind requires an explicit --fuse K")
    use_mesh = _uses_mesh(cfg)
    if cfg.exchange == "rdma":
        # a forced exchange mode is never ignored: every unsupported
        # combination raises with the reason before any build work
        if not cfg.fuse:
            raise ValueError(
                "--exchange rdma requires an explicit --fuse K (the ring "
                "exchange feeds the streaming temporal-blocking kernels)")
        if not use_mesh:
            raise ValueError(
                "--exchange rdma needs --mesh: an unsharded run has no "
                "halo exchange for the ring to carry")
        if cfg.fuse_kind != "stream":
            raise ValueError(
                "--exchange rdma rides the streaming kernel family: "
                "force --fuse-kind stream or drop --exchange rdma")
        if cfg.periodic:
            raise ValueError(
                "--exchange rdma is guard-frame only (the streaming "
                "kernels have no periodic wrap path)")
    if cfg.overlap and not use_mesh:
        raise ValueError(
            "--overlap needs --mesh: the split overlaps the halo exchange "
            "with the interior update, and an unsharded run has no "
            "exchange to overlap")
    if cfg.pipeline and not cfg.fuse:
        # a requested pipeline is never ignored: without temporal blocking
        # there are no fused passes for the slab carry to span
        raise ValueError("--pipeline requires an explicit --fuse K "
                         "(the slab-carry scan pipelines the exchange "
                         "across fused passes)")
    if cfg.pipeline and not use_mesh:
        raise ValueError(
            "--pipeline needs --mesh: the slab-carry scan pipelines the "
            "width-m halo exchange across fused passes, and an unsharded "
            "run has no exchange to pipeline")
    m = _make_run_mesh(cfg, device) if use_mesh else None
    item = _dtype_refusal(cfg, st, use_mesh)
    if item:
        raise NotImplementedError(
            f"{stencil_lib.dtype_name(st.dtype)} on this kernel path is not "
            f"ported: {item}")
    _check_mem_budget(cfg, st, m)
    if cfg.fuse:
        if cfg.compute == "pallas":
            raise ValueError("--fuse replaces the whole step; it excludes "
                             "--compute pallas")
        if st.ndim == 2 and cfg.fuse_kind != "auto":
            raise ValueError(
                "--fuse-kind selects the 3D kernel variant; 2D grids use "
                "the whole-grid kernel")
        if use_mesh:
            if cfg.fuse_kind not in ("auto", "stream", "padfree"):
                raise ValueError(
                    "--fuse-kind selects the 3D kernel variant; sharded "
                    "runs support 'stream' and 'padfree' (the slab-operand "
                    "kernels, on any mesh of z and y) and the "
                    "exchange-padded kernel is 'auto'")
            kind = cfg.fuse_kind if cfg.fuse_kind in ("stream",
                                                      "padfree") else None
            step_fn = stepper_lib.make_sharded_temporal_step(
                st, m, cfg.grid, cfg.fuse, periodic=cfg.periodic, kind=kind,
                overlap=cfg.overlap, pipeline=cfg.pipeline,
                exchange=cfg.exchange, ensemble=cfg.ensemble, device=device)
            if cfg.overlap and step_fn is not None and \
                    not getattr(step_fn, "_overlap_active", False):
                log.warning(
                    "--overlap: block geometry cannot host the interior/"
                    "boundary split (local extent < 3*k*halo*phases on a "
                    "sharded axis); running the plain exchange-then-"
                    "compute fused step"
                    + (" (the slab-carry pipeline stays active on the "
                       "non-split body)" if cfg.pipeline else ""))
            if step_fn is None:
                raise ValueError(
                    f"--fuse {cfg.fuse} + --mesh {cfg.mesh}"
                    + (f" --fuse-kind {kind}" if kind else "")
                    + (" --pipeline" if cfg.pipeline else "")
                    + (" --exchange rdma" if cfg.exchange == "rdma" else "")
                    + f" unsupported for {st.name} on {cfg.grid}: needs a "
                    f"fused kernel, an unsharded lane axis"
                    + (", guard-frame BCs, rings that fit shared memory"
                       if kind == "stream" else
                       ", 2*k*halo*phases a multiple of the dtype's "
                       "sublane tile (8 for f32, 16 for bf16)")
                    + ", per-shard extents dividing the grid, and blocks "
                    ">= the k-step margin")
            if cfg.pipeline:
                log.info("exchange: pipelined slab carry (%s kind, "
                         "overlap %s)", step_fn._padfree_kind,
                         "on" if step_fn._overlap_active else "off")
            if cfg.exchange == "rdma":
                # which path carries the ring: the kernels on cards, their
                # plain versions on the CPU (never read as a measured
                # ring); across processes the peer ring
                log.info("exchange: mode=rdma backend=%s",
                         getattr(step_fn, "_rdma_backend", "unknown"))
        elif st.ndim == 2:
            step_fn = fullgrid_lib.make_fullgrid_step(
                st, cfg.grid, cfg.fuse, periodic=cfg.periodic, device=device)
        elif cfg.fuse_kind == "stream":
            if cfg.periodic:
                raise ValueError(
                    "--fuse-kind stream is guard-frame only (the streaming "
                    "kernel has no periodic wrap path)")
            # --ensemble N: the batched streaming step (the member in the
            # launch grid), already tagged, so no wrap below
            step_fn = streamfused.make_stream_fused_step(
                st, cfg.grid, cfg.fuse, batch=cfg.ensemble, device=device)
            if step_fn is None:
                raise ValueError(
                    f"--fuse {cfg.fuse} --fuse-kind stream unsupported for "
                    f"{st.name} on {cfg.grid}: needs a 3D fused family and "
                    f"k-step rings that fit shared memory")
        else:
            step_fn = fused_lib.make_fused_step(
                st, cfg.grid, cfg.fuse, periodic=cfg.periodic, device=device)
        if step_fn is None:
            raise ValueError(
                f"--fuse {cfg.fuse} unsupported for {st.name} on grid "
                f"{cfg.grid} (need a fused kernel, 2*k*halo a multiple "
                f"of the dtype's sublane tile — 8 for f32, 16 for bf16 — "
                f"and a window that fits shared memory)")
        if cfg.ensemble:
            # the unsharded K3 / K8 steps take the member axis as they are
            # (one launch for every member); the sharded and streaming
            # builders return steps already batched
            step_fn = driver.make_ensemble_step(step_fn)
    else:
        step_fn = resolve_raw_step(cfg, st)
        if step_fn is not None:
            log.info("compute: whole-step raw CUDA kernel (%s)", st.name)
        elif use_mesh:
            step_fn = stepper_lib.make_sharded_step(
                st, m, cfg.grid, periodic=cfg.periodic,
                compute_fn=resolve_compute_fn(cfg, st), overlap=cfg.overlap,
                ensemble=cfg.ensemble)
        else:
            step_fn = driver.make_step(
                st, cfg.grid, periodic=cfg.periodic,
                compute_fn=resolve_compute_fn(cfg, st))
            if cfg.ensemble:
                step_fn = driver.make_ensemble_step(step_fn)
    resuming = (cfg.resume and cfg.checkpoint_dir
                and checkpointing.checkpoint_format(cfg.checkpoint_dir))
    if resuming:
        fields, start_step = _resume(cfg, st, device, m)
    elif m is not None:
        # each block computed on its own device; no device holds the grid
        # (with --ensemble, only the members of the block's group)
        fields = init_state_sharded(st, cfg.grid, m, cfg.seed, cfg.density,
                                    kind=cfg.init, periodic=cfg.periodic,
                                    ensemble=cfg.ensemble,
                                    perturb=cfg.ensemble_perturb)
        start_step = 0
    else:
        fields = init_state(st, cfg.grid, cfg.seed, cfg.density,
                            kind=cfg.init, periodic=cfg.periodic,
                            device=device, ensemble=cfg.ensemble,
                            perturb=cfg.ensemble_perturb)
        start_step = 0
    # a fused step_fn advances cfg.fuse steps per call; run() accounts.
    return st, step_fn, fields, start_step


def _save_ckpt(cfg: RunConfig, fields, step: int):
    if cfg.checkpoint_backend == "orbax":
        # its first import takes seconds, which are not the write's
        import torch.distributed.checkpoint as dcp  # noqa: F401
        t0 = time.perf_counter()
        checkpointing.orbax_save_checkpoint(
            cfg.checkpoint_dir, fields, step, dataclasses.asdict(cfg))
        log.info("checkpoint step %d: %d bytes of this process's blocks "
                 "written in %.3fs", step, checkpointing.local_nbytes(fields),
                 time.perf_counter() - t0)
    else:
        checkpointing.save_checkpoint(
            cfg.checkpoint_dir, fields, step, dataclasses.asdict(cfg))


def _session_span(session, name: str, **attrs):
    """A span on the session's emitter, or a null context without one
    (spans are never load-bearing: obs/spans.py)."""
    from .obs import spans as spans_lib

    return spans_lib.maybe_span(
        getattr(session, "spans", None), name, **attrs)


def _epilogue(cfg: RunConfig, fields, final_step: int, save_ckpt: bool,
              session=None):
    """Shared run tail: final checkpoint + optional ASCII render."""
    if save_ckpt and cfg.checkpoint_dir:
        with _session_span(session, "checkpoint", step=final_step,
                           final=True):
            _save_ckpt(cfg, fields, final_step)
    if cfg.render:
        f = fields[0]
        if stepper_lib.is_sharded(fields):
            f = stepper_lib.gather_fields((f,), device="cpu")[0]
        f = f.detach().cpu()
        print(render.ascii_render(
            np.asarray(f.float() if f.is_floating_point() else f)))


def run(cfg: RunConfig) -> Tuple:
    """Execute a configured run; returns (final_fields, mcells_per_s)."""
    if cfg.serve_port is not None and not cfg.telemetry:
        # --serve tails the telemetry log; without one there is nothing
        # to serve, so derive a default path
        cfg = dataclasses.replace(cfg, telemetry=_serve_log_path())
    if not cfg.groups:
        cfg = maybe_auto_fuse(cfg)
    return _run_once(cfg)


def _serve_log_path() -> str:
    """The log ``--serve`` derives without ``--telemetry``, under
    ``trace.default_telemetry_dir()``.  Every process of a multi-process
    launch derives the same path (the launch's rendezvous port and the
    launcher's pid), so process 0's console finds every process's log."""
    from .obs import trace as trace_lib

    if trace_lib.process_identity()[1] > 1:
        name = (f"serve-{os.environ.get('MASTER_PORT', '0')}-"
                f"{os.getppid()}.jsonl")
    else:
        name = f"serve-{os.getpid()}-{int(time.time())}.jsonl"
    return os.path.join(trace_lib.default_telemetry_dir(), name)


def _process_tag() -> str:
    """``".p<r>"`` for process r > 0 of a multi-process launch, else
    empty: the suffix of each process's own trace files."""
    from .obs import trace as trace_lib

    rank, world = trace_lib.process_identity()
    return f".p{rank}" if world > 1 and rank else ""


def _open_telemetry(cfg: RunConfig):
    """Telemetry session for ``--telemetry PATH`` (obs/): the manifest is
    written up front (a run that dies in set-up still leaves its
    provenance), the heartbeat starts at once, and the recorder becomes
    ``run_simulation``'s chunk-boundary observer.  Process r > 0 of a
    multi-process launch writes its own log (``trace.process_log_path``)."""
    from . import obs
    from .obs import trace as trace_lib

    extra = {}
    if cfg.groups:
        # the manifest's `groups` block: one resolved entry per group
        # (best-effort: a malformed spec raises in _run_coupled with the
        # session open to record the error)
        try:
            extra["groups"] = [
                dict(p.describe(), transport=cfg.group_transport)
                for p in groups_lib.plans_from_config(
                    cfg.groups, cfg.grid, default_dtype=cfg.dtype or None)]
        except Exception:  # noqa: BLE001 — see above
            pass
    try:
        # the heartbeat's stall threshold (the TPU package's
        # OBS_STALL_AFTER_S): a supervisor or a test makes the in-process
        # verdict land before its own wall-clock kill; default 600 s
        stall_after_s = float(os.environ.get("OBS_STALL_AFTER_S", "600")
                              or 600)
    except ValueError:
        stall_after_s = 600.0
    return obs.open_session(
        trace_lib.process_log_path(cfg.telemetry), tool="cli",
        run=dataclasses.asdict(cfg), step_unit=max(1, cfg.fuse),
        stall_after_s=stall_after_s, ensemble=cfg.ensemble, **extra)


def _open_serve(cfg: RunConfig, session):
    """Live console for ``--serve PORT`` (obs/serve.py), or None.

    The server tails the session's log — the run loop never sees it.
    The bound address is logged AND recorded as a ``serve`` event, so a
    remote monitor can discover the URL from the log alone.  Under a
    multi-process launch process 0 serves every process's log
    (``serve_aggregate``: one ``hosts`` row a process) and the others
    bind nothing, so no two processes race for one port.  Never
    load-bearing: a bind failure logs and the run proceeds unserved.
    """
    if cfg.serve_port is None or session is None:
        return None
    from .obs import trace as trace_lib

    rank, world = trace_lib.process_identity()
    if rank:
        return None
    try:
        from .obs import serve as serve_lib

        if world > 1:
            server = serve_lib.serve_aggregate(
                trace_lib.launch_log_paths(cfg.telemetry),
                port=cfg.serve_port)
        else:
            server = serve_lib.serve_run(session.path, port=cfg.serve_port)
        log.info("obs live console serving at %s "
                 "(/metrics /status.json /events)", server.url)
        session.event("serve", url=server.url, port=server.port,
                      endpoints=["/metrics", "/status.json", "/events"])
        return server
    except Exception as e:  # noqa: BLE001 — telemetry never load-bearing
        log.warning("--serve disabled (%s: %s)", type(e).__name__, e)
        return None


def _attach_anomaly(cfg: RunConfig, session, cells: int) -> None:
    """Hang the run doctor (obs/anomaly.py) off the session recorder for
    ``--anomaly``, seeded with the campaign ledger's ``best_known`` row
    for this label on this run's device type (obs/ledger.py) so the
    roofline-gap band has a reference.  The ledger lookup is best-effort
    (no ledger, no matching baseline key: own-baseline detection only),
    and so is the monitor: a construction failure leaves the run
    undoctored, not dead."""
    if not cfg.anomaly or session is None:
        return
    try:
        import socket

        from .obs import anomaly as anomaly_lib
        from .obs import ledger as ledger_lib
        from .obs import trace as trace_lib

        try:
            best = ledger_lib.lookup_best(
                dataclasses.asdict(cfg), torch.device(cfg.device).type,
                source="anomaly-probe")
        except Exception:  # noqa: BLE001 — the band is optional evidence
            best = None
        try:
            ident = (f"{socket.gethostname()}|"
                     f"p{trace_lib.process_identity()[0]}")
        except Exception:  # noqa: BLE001
            ident = "?|p?"
        session.recorder.anomaly = anomaly_lib.AnomalyMonitor(
            trace=session.trace, spans=session.spans, ident=ident,
            cells=cells, best_known=best)
    except Exception:  # noqa: BLE001
        log.debug("--anomaly monitor construction failed; run proceeds "
                  "undoctored", exc_info=True)


def _card_layout(cfg: RunConfig, fields) -> Tuple[Optional[str], int, str]:
    """(card name or None on the CPU, shards on the fullest card, exchange
    link) of a run's state: the device map of its mesh, the processes
    that share this process's card, and the transport's link
    (``costmodel.link_of``)."""
    from .obs import costmodel

    f = fields[0]
    block = f[0] if isinstance(f, list) else f
    card = (torch.cuda.get_device_name(block.device)
            if block.is_cuda else None)
    mesh = getattr(f, "mesh", None)
    if mesh is None:
        return card, 1, "hbm"
    per_device = collections.Counter(mesh.devices)
    shards = max(per_device.values())
    sharing = mesh_lib.ranks_on_device() if mesh.multiprocess else 1
    shards *= sharing
    cards = len(per_device)
    if cfg.exchange == "rdma" and mesh.multiprocess:
        # the peer ring: CUDA IPC copies, within one card or over NVLink
        return card, shards, "hbm" if sharing > 1 else "nvlink"
    return card, shards, costmodel.link_of(mesh.backend, cards)


def _emit_static_cost(cfg: RunConfig, st, session, fields) -> None:
    """The ``costmodel`` event (obs/costmodel.py): the static counters
    and the roofline priced for this run's card, its shards per card and
    its exchange link.  Best-effort: it never blocks the run and changes
    no field."""
    try:
        from .obs import costmodel

        card, shards, link = _card_layout(cfg, fields)
        session.event("costmodel", **costmodel.static_cost(
            st, cfg.grid, mesh=cfg.mesh, fuse=cfg.fuse,
            fuse_kind=cfg.fuse_kind, periodic=cfg.periodic,
            ensemble=cfg.ensemble, exchange=cfg.exchange,
            ensemble_mesh=cfg.ensemble_mesh, card=card,
            shards_per_card=shards, link=link))
    except Exception:  # noqa: BLE001 — telemetry is never load-bearing
        log.debug("static cost model failed; trace goes without it",
                  exc_info=True)


def _maybe_bundle(session, reason: str, verdict=None) -> None:
    """Terminal-verdict flight-recorder bundle (obs/flightrec.py), on an
    error or DIVERGED abort or a clean exit with anomaly findings;
    ``bundle_from_session`` swallows every failure."""
    from .obs import flightrec as flightrec_lib

    path = flightrec_lib.bundle_from_session(session, reason,
                                             verdict=verdict)
    if path:
        log.info("flight-recorder bundle: %s", path)


def _run_once(cfg: RunConfig) -> Tuple:
    """One run, inside its telemetry session when ``--telemetry`` asks
    for one: the error event and the bundle on a failed run, the bundle
    of a run that finished DEGRADED."""
    if not cfg.telemetry:
        return _run_measured(cfg, None)
    session = _open_telemetry(cfg)
    server = None
    try:
        server = _open_serve(cfg, session)
        result = _run_measured(cfg, session)
        mon = getattr(session.recorder, "anomaly", None)
        if mon is not None and mon.count:
            _maybe_bundle(session, "degraded", verdict="DEGRADED")
        return result
    except BaseException as e:
        session.error(e)
        from .obs import health as health_lib

        verdict = "DIVERGED" if isinstance(
            e, health_lib.SimulationDiverged) else None
        _maybe_bundle(session, f"error:{type(e).__name__}",
                      verdict=verdict)
        raise
    finally:
        session.close()
        if server is not None:
            # after session.close() so the summary is on disk for the
            # server's last drain; then the console goes with the run
            server.close()


@contextlib.contextmanager
def _profiled(cfg: RunConfig):
    """A ``torch.profiler`` session over the time loop for
    ``--profile-dir`` (its Chrome trace written there as
    ``run[.p<r>].trace.json``); a null context otherwise."""
    if not cfg.profile_dir:
        yield
        return
    from .obs import profile as profile_lib

    os.makedirs(cfg.profile_dir, exist_ok=True)
    prof = profile_lib._start_torch_profiler(cfg.profile_dir)
    try:
        yield
    finally:
        profile_lib.ChunkProfiler._stop_torch(prof, os.path.join(
            cfg.profile_dir, f"run{_process_tag()}.trace.json"))


def _check_obs_flags(cfg: RunConfig) -> None:
    """The observability flags' refusals (the TPU package's checks and
    messages), before any build."""
    if cfg.profile and cfg.profile_dir:
        raise ValueError("--profile and --profile-dir both open a "
                         "profiler session and profilers do not nest; "
                         "pick the chunk-scoped (--profile) or "
                         "whole-run (--profile-dir) trace")
    if cfg.profile and cfg.tol > 0:
        raise ValueError("--profile scopes one steady-state chunk; "
                         "--tol runs inside a single while_loop with no "
                         "chunk boundary to scope")
    if cfg.halo_audit < 0:
        raise ValueError("--halo-audit takes a positive chunk cadence K")
    if cfg.halo_audit and not (cfg.mesh and any(c > 1 for c in cfg.mesh)):
        raise ValueError(
            "--halo-audit re-exchanges ghost slabs across a device "
            "mesh; it needs a spatially sharded --mesh (an unsharded "
            "run has no exchange to audit)")
    if cfg.halo_audit and cfg.tol > 0:
        raise ValueError(
            "--halo-audit runs at chunk boundaries; --tol runs inside "
            "one while_loop with no boundary to audit at")


def _run_measured(cfg: RunConfig, session) -> Tuple:
    if cfg.groups:
        return _run_coupled(cfg, session)
    if cfg.debug_checks and cfg.fuse:
        raise ValueError("--debug-checks excludes --fuse (the fused "
                         "kernel replaces the step being instrumented)")
    _check_obs_flags(cfg)
    build_t0, build_m0 = time.time(), time.perf_counter()
    st, step_fn, fields, start_step = build(cfg)
    build_s = time.perf_counter() - build_m0
    if session is not None:
        _emit_static_cost(cfg, st, session, fields)
        if start_step:
            session.event("resume", resumed_from_step=start_step)
            if session.spans is not None:
                session.spans.emit("resume", start=build_t0,
                                   dur_s=build_s,
                                   resumed_from_step=start_step)
        if cfg.exchange == "rdma":
            # which path carries the ring: the kernels on cards, their
            # plain versions on the CPU (never read as a measured ring)
            session.event(
                "exchange", mode="rdma",
                backend=getattr(step_fn, "_rdma_backend", "unknown"))
    remaining = cfg.iters - start_step
    if remaining <= 0:
        log.info("checkpoint already at step %d >= iters", start_step)
        if session is not None:
            session.finish(steps=0, mcells_per_s=0.0,
                           note="checkpoint already at/past iters")
        return fields, 0.0
    # every member's cells: an ensemble advances N grids a step
    cells = math.prod(cfg.grid) * max(1, cfg.ensemble)
    step_unit = max(1, cfg.fuse)

    # the numerics sentinel and the exchange audit: chunk-boundary
    # observers outside the step (obs/health.py)
    monitor = auditor = None
    if cfg.health:
        from .obs import health as health_lib

        monitor = health_lib.HealthMonitor(
            st, trace=session.trace if session is not None else None,
            ensemble=cfg.ensemble,
            spans=session.spans if session is not None else None)
    if cfg.halo_audit:
        from .obs import health as health_lib

        auditor = health_lib.HaloAuditor(
            st, fields[0].mesh, cfg.grid, exchange=cfg.exchange,
            periodic=cfg.periodic,
            trace=session.trace if session is not None else None)
    _attach_anomaly(cfg, session, cells)

    if cfg.tol > 0:
        return _run_until_converged(cfg, st, step_fn, fields, start_step,
                                    remaining, cells, session, monitor)

    if _dumps(cfg):
        os.makedirs(cfg.dump_dir, exist_ok=True)
    last_ok = [start_step]
    chunk_count = [0]
    audits_run = [0]

    def callback(done_in_run, fs):
        step = start_step + done_in_run * step_unit
        # the fault point of the chunk boundary, before its checkpoint: a
        # kill here leaves the previous boundary's checkpoint the newest
        faults.maybe_fire("exchange", step=step)
        replaced = None
        if faults.injected_numeric_poison(step) is not None:
            # the numerics fault site: one NaN cell in the state that
            # continues (the driver adopts the returned fields)
            from .obs import health as health_lib

            fs = replaced = health_lib.apply_nan_poison(fs)
        if cfg.check_finite and step % cfg.check_finite == 0:
            for i, f in enumerate(fs):
                if not f.dtype.is_floating_point:
                    continue  # int grids cannot hold NaN/Inf
                if not driver.all_finite(f):
                    raise RuntimeError(
                        f"field {i} became non-finite between steps "
                        f"{last_ok[0]} and {step} (NaN/Inf blow-up — "
                        f"check stability parameters)")
            last_ok[0] = step
        if cfg.log_every and step % cfg.log_every == 0:
            # the Jacobi residual needs a one-step step_fn (not a fused one)
            d = diagnostics.field_diagnostics(
                st, fs, step_fn=None if cfg.fuse else step_fn)
            log.info("step %d  %s", step, diagnostics.format_diagnostics(d))
        # the sentinel and the audit run BEFORE this boundary's
        # checkpoint, so a diverged (or poisoned) state is never saved
        chunk = chunk_count[0]
        chunk_count[0] += 1
        if monitor is not None:
            monitor.check_or_raise(step, fs, chunk=chunk)
        if auditor is not None and (chunk + 1) % cfg.halo_audit == 0:
            audits_run[0] += 1
            auditor.audit_or_raise(fs, step, chunk=chunk)
        # the last step's checkpoint is the epilogue's, outside the timing
        if cfg.checkpoint_every and cfg.checkpoint_dir and \
                step % cfg.checkpoint_every == 0 and step != cfg.iters:
            with _session_span(session, "checkpoint", step=step):
                _save_ckpt(cfg, fs, step)
        if _dumps(cfg) and step % cfg.dump_every == 0:
            f = fs[0]
            if stepper_lib.is_sharded(fs):
                f = stepper_lib.gather_fields((f,), device="cpu")[0]
            native.async_write_npy(
                os.path.join(cfg.dump_dir, f"step_{step:08d}.npy"), f)
        return replaced

    intervals = [v for v in (cfg.log_every, cfg.checkpoint_every,
                             cfg.check_finite,
                             cfg.dump_every if cfg.dump_dir else 0) if v]
    interval = math.gcd(*intervals) if intervals else 0
    if (cfg.health or cfg.halo_audit or cfg.anomaly) and not interval:
        # no logging cadence: synthesize ~8 chunk boundaries for the
        # sentinel, the audit and the doctor, in multiples of the step
        # unit
        if remaining >= 2 * step_unit:
            interval = max(1, (remaining // step_unit) // 8) * step_unit
    # With temporal blocking the step_fn advances cfg.fuse steps per call:
    # loop over remaining/K calls, and run the callback cadence in K-units.
    if step_unit > 1:
        if remaining % step_unit:
            raise ValueError(
                f"iters remaining ({remaining}) must be a multiple of "
                f"--fuse {step_unit}")
        if interval % step_unit:
            raise ValueError(
                f"log/checkpoint/dump intervals must be multiples of "
                f"--fuse {step_unit}")
        if start_step % step_unit:
            raise ValueError(
                f"resume step {start_step} not a multiple of "
                f"--fuse {step_unit}")
        interval //= step_unit

    observer = session.recorder if session is not None else None
    prof = None
    if cfg.profile:
        from .obs import profile as profile_lib
        from .obs import runtime as runtime_lib

        calls = remaining // step_unit
        if interval == 0 and calls >= 2:
            # no logging cadence: one boundary, so a steady-state chunk
            # (after the build and warm-up) exists to scope
            interval = (calls + 1) // 2
        n_chunks = -(-calls // interval) if interval else 1
        prof = profile_lib.ChunkProfiler(
            cfg.profile, target_chunk=1 if n_chunks >= 2 else 0,
            tag=_process_tag())
        if observer is None:
            observer = runtime_lib.RuntimeRecorder(
                step_unit=step_unit, cuda=_on_cuda(fields))
        observer.profiler = prof

    # the clock times the steps: the init's (or the resume's) device work
    # is set-up and must not run on inside the timed loop
    driver.synchronize(fields)
    t0 = time.perf_counter()
    # the loop takes the fields, so the initial state is freed after the
    # first step instead of living through the run beside input and output
    donated = driver.Donated(fields)
    del fields
    try:
        with _profiled(cfg):
            fields = driver.run_simulation(
                st, donated, remaining // step_unit, step_fn=step_fn,
                log_every=interval, callback=callback,
                start_step=start_step // step_unit,
                runner_factory=driver.make_checked_runner
                if cfg.debug_checks else None,
                observer=observer)
            driver.synchronize(fields)
    finally:
        if prof is not None:
            prof.close()  # never leave a profiler session open
    # the global cells over the slowest process's time
    dt = _slowest(fields, time.perf_counter() - t0)
    _check_peer_ring(step_fn)

    # a run with no boundary still has its final state judged once
    if monitor is not None and monitor.checks == 0:
        monitor.check_or_raise(cfg.iters, fields)
    if auditor is not None and audits_run[0] == 0:
        auditor.audit_or_raise(fields, cfg.iters)
    if prof is not None:
        from .obs import profile as profile_lib

        att = profile_lib.attribution_record(
            cfg.profile, profiled_chunk=prof.profiled_chunk,
            error=prof.error, wall_s=prof.wall_s, path=prof.path)
        log.info("profile: %s", profile_lib.format_attribution(att))
        if session is not None:
            session.event("profile", **att)
    if _dumps(cfg):
        native.wait_all()  # drain the async dump queue; raises IO errors
    mcells = cells * remaining / dt / 1e6
    log.info("%d steps on %s grid in %.3fs  (%.1f Mcells/s)",
             remaining, "x".join(map(str, cfg.grid)), dt, mcells)
    if session is not None:
        session.finish(steps=remaining, wall_s=round(dt, 4),
                       mcells_per_s=round(mcells, 3))
    _epilogue(cfg, fields, cfg.iters, save_ckpt=bool(cfg.checkpoint_every),
              session=session)
    return fields, mcells


def _on_cuda(fields) -> bool:
    """Whether a run's state lives on a card."""
    f = fields[0]
    f = f[0] if isinstance(f, list) else f
    return f.is_cuda


def _run_until_converged(cfg: RunConfig, st, step_fn, fields,
                         start_step: int, remaining: int, cells: int,
                         session=None, monitor=None):
    """The ``--tol`` run: ``driver.run_until`` with the TPU package's
    rules (no log or checkpoint cadence, with ``--fuse k`` the remaining
    iterations and ``--tol-check-every`` in multiples of k); one loop is
    one chunk for the telemetry and the sentinel, and the final state is
    checkpointed."""
    if cfg.log_every or cfg.checkpoint_every or cfg.dump_every or \
            cfg.check_finite or cfg.debug_checks:
        raise ValueError(
            "--tol runs inside one while_loop; it excludes "
            "--debug-checks and periodic log/checkpoint/dump/"
            "check-finite (a non-finite state never converges: the "
            "residual stays NaN>tol and the loop exits at the "
            "--iters cap)")
    # each step_fn call advances `unit` real steps, so the cap and the
    # check cadence are counted in calls
    unit = max(1, cfg.fuse)
    if unit > 1 and remaining % unit:
        raise ValueError(
            f"--tol with --fuse {unit} needs remaining iters "
            f"({remaining}) to be a multiple of {unit}")
    if unit > 1 and cfg.tol_check_every % unit:
        raise ValueError(
            f"--tol with --fuse {unit} needs --tol-check-every "
            f"({cfg.tol_check_every}) to be a multiple of {unit}")
    driver.synchronize(fields)
    t0 = time.perf_counter()
    with _profiled(cfg):
        fields, n_calls, res = driver.run_until(
            step_fn, fields, cfg.tol, remaining // unit,
            check_every=cfg.tol_check_every // unit if unit > 1
            else cfg.tol_check_every,
            boundary=lambda n: faults.maybe_fire(
                "exchange", step=start_step + n * unit))
        driver.synchronize(fields)
    dt = _slowest(fields, time.perf_counter() - t0)
    _check_peer_ring(step_fn)
    n_done = n_calls * unit
    if monitor is not None:
        # one loop = one chunk: the sentinel judges the final state (a
        # non-finite state never converges)
        monitor.check_or_raise(start_step + n_done, fields, chunk=0)
    mcells = cells * n_done / dt / 1e6 if n_done else 0.0
    log.info(
        "converged=%s after %d steps (residual %.3e, tol %.1e) in %.3fs"
        "  (%.1f Mcells/s)",
        res <= cfg.tol, n_done, res, cfg.tol, dt, mcells)
    if session is not None:
        # one loop = one chunk (build, warm-up and run together)
        session.recorder.record_chunk(n_calls, dt)
        session.finish(phase="tol_loop", steps=n_done, wall_s=dt,
                       mcells_per_s=round(mcells, 3),
                       converged=bool(res <= cfg.tol),
                       residual=float(res))
    _epilogue(cfg, fields, start_step + n_done, save_ckpt=True,
              session=session)
    return fields, mcells


# Monolithic mode flags that do not compose with --groups (the TPU
# package's list and messages): each group's clause is its own config, so
# a slice-wide mode flag has no single run to configure.
_GROUP_CONFLICTS = (
    ("--mesh", lambda c: bool(c.mesh)),
    ("--ensemble/--ensemble-mesh/--ensemble-perturb",
     lambda c: bool(c.ensemble or c.ensemble_mesh or c.ensemble_perturb)),
    ("--fuse", lambda c: bool(c.fuse)),
    ("--fuse-kind", lambda c: c.fuse_kind != "auto"),
    ("--overlap", lambda c: c.overlap),
    ("--pipeline", lambda c: c.pipeline),
    ("--exchange rdma", lambda c: c.exchange == "rdma"),
    ("--periodic", lambda c: c.periodic),
    ("--tol", lambda c: c.tol > 0),
    ("--profile/--profile-dir",
     lambda c: bool(c.profile or c.profile_dir)),
    ("--halo-audit", lambda c: bool(c.halo_audit)),
    ("--debug-checks", lambda c: c.debug_checks),
    ("--policy-recheck", lambda c: bool(c.policy_recheck)),
    ("--compute pallas", lambda c: c.compute == "pallas"),
    ("--kernel-variant", lambda c: bool(c.kernel_variant)),
    ("--dump-every", lambda c: bool(c.dump_every)),
)


def _launched_multiprocess() -> bool:
    """Whether this process is one of a multi-process launch (an open
    process group, or a launcher's ``MASTER_ADDR`` and ``WORLD_SIZE`` >
    1)."""
    world = os.environ.get("WORLD_SIZE", "1")
    return mesh_lib.process_count() > 1 or bool(
        os.environ.get("MASTER_ADDR") and world.isdigit() and int(world) > 1)


def _check_coupled_mem_budget(cfg: RunConfig, plans, device) -> None:
    """The device-memory guard of a coupled run, on a card only, before
    any field is allocated: the groups that share a card summed."""
    if cfg.mem_check == "off" or device.type != "cuda":
        return
    from .utils import budget

    try:
        worst, _ = budget.check_coupled_budget(
            plans, transport=cfg.group_transport,
            devices=[p.devices(device.type) for p in plans])
    except ValueError:
        if cfg.mem_check == "error":
            raise
        log.warning("device memory budget exceeded (--mem-check warn): "
                    "proceeding anyway; expect an out-of-memory error",
                    exc_info=True)
    else:
        log.info("memory budget (coupled): ~%.2f GiB on the fullest card "
                 "estimated", worst / 2**30)


def build_coupled(cfg: RunConfig):
    """Materialize (plans, runner, start_round) of a ``--groups`` config:
    the conflicts and the memory guard before any field is built, then the
    ``parallel.groups.CoupledRunner`` (each group's fields from the init,
    or from a coupled checkpoint under ``--resume``)."""
    _refuse_unported(cfg)
    for flag, fired in _GROUP_CONFLICTS:
        if fired(cfg):
            raise ValueError(
                f"--groups partitions the slice into per-group sub-"
                f"meshes with their own per-group configs; {flag} "
                "configures the monolithic run and does not compose "
                "with --groups (put per-group behavior in the group "
                "clauses: <op>[:fine[R]|:coarse][:<dtype>]@<d0>-<d1>"
                "[:z<num>/<den>][:mesh<m0>x<m1>...])")
    if _launched_multiprocess():
        # never a silently narrowed device set: each process would see
        # only its own card
        raise NotImplementedError(
            "--groups across processes is not ported (a --groups run is "
            "one process over the visible cards, or over virtual devices "
            f"on one card): {groups_lib.PROCESSES_ITEM}")
    device = _device(cfg)
    plans = groups_lib.plans_from_config(
        cfg.groups, cfg.grid, default_dtype=cfg.dtype or None,
        n_devices=len(mesh_lib.local_devices(device.type)))
    _check_coupled_mem_budget(cfg, plans, device)
    runner = groups_lib.CoupledRunner(
        plans, seed=cfg.seed, density=cfg.density, init_kind=cfg.init,
        transport=cfg.group_transport, device=device)
    for p, kind in zip(plans, runner.step_kinds()):
        log.info("group %s: grid %s on mesh %s (devices %d-%d), %s, %s "
                 "step", p.name, "x".join(map(str, p.grid)),
                 "x".join(map(str, p.mesh_shape)), p.spec.dev_lo,
                 p.spec.dev_hi, stencil_lib.dtype_name(p.stencil.dtype),
                 kind)
    log.info("groups: %d interface(s), transport %s", len(plans) - 1,
             cfg.group_transport)
    start_round = 0
    if cfg.resume and cfg.checkpoint_dir and os.path.isdir(
            os.path.join(cfg.checkpoint_dir, "group0")):
        start_round = runner.load_checkpoint(cfg.checkpoint_dir)
        log.info("resumed coupled run from %s at round %d",
                 cfg.checkpoint_dir, start_round)
    return plans, runner, start_round


def _run_coupled(cfg: RunConfig, session=None) -> Tuple:
    """The ``--groups`` run loop (the TPU package's ``_run_coupled``): a
    chunked round loop with ``--log-every`` (Mcells/s a group),
    ``--check-finite`` (naming the group), coupled checkpoints (a
    directory a group, one agreed round), the ``exchange`` fault site at
    each chunk boundary and the ``numerics`` site's poison of group 0;
    with a telemetry session, a ``group_chunk`` event a group a chunk
    (its ready horizon: the groups synchronized in turn) and the run
    doctor's per-group straggler view; with ``--health`` a sentinel a
    group (``open_system``: a group trades its invariant through the
    interface bands), whose records name their group.  Returns (the
    assembled base-resolution fields on the host, Mcells/s from
    ``cell_updates_per_round``)."""
    plans, runner, start_round = build_coupled(cfg)
    if session is not None:
        try:
            from .obs import costmodel

            dev = runner.fields[0][0][0].device
            session.event("costmodel", **costmodel.coupled_cost(
                plans, card=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else None),
                transport=cfg.group_transport))
        except Exception:  # noqa: BLE001 — telemetry never load-bearing
            log.debug("coupled cost model failed; trace goes without it",
                      exc_info=True)
    if session is not None and start_round:
        session.event("resume", resumed_from_step=start_round)
    remaining = cfg.iters - start_round
    if remaining <= 0:
        log.info("coupled checkpoint already at round %d >= iters",
                 start_round)
        if session is not None:
            session.finish(steps=0, mcells_per_s=0.0,
                           note="checkpoint already at/past iters")
        return runner.assemble(), 0.0
    monitors = None
    if cfg.health:
        from .obs import health as health_lib

        # trace=None: the loop writes the "health" events itself, each
        # naming its group
        monitors = [health_lib.HealthMonitor(p.stencil, open_system=True)
                    for p in plans]
    intervals = [v for v in (cfg.log_every, cfg.checkpoint_every,
                             cfg.check_finite) if v]
    interval = math.gcd(*intervals) if intervals else 0
    if (cfg.health or cfg.anomaly) and not interval and remaining >= 2:
        interval = max(1, remaining // 8)
    cells_round = runner.cell_updates_per_round()
    _attach_anomaly(cfg, session, cells_round)
    done = 0
    chunk = 0
    runner.block_until_ready()
    t0 = time.perf_counter()
    while done < remaining:
        n = min(interval or remaining, remaining - done)
        tc = time.perf_counter()
        runner.run(n)
        # synchronize the groups in order and stamp each ready horizon
        group_ready_ms = []
        for fs in runner.fields:
            driver.synchronize(fs)
            group_ready_ms.append(
                round((time.perf_counter() - tc) * 1e3 / n, 6))
        dtc = time.perf_counter() - tc
        done += n
        step = start_round + done
        faults.maybe_fire("exchange", step=step)
        if session is not None:
            session.recorder.record_chunk(n, dtc)
            for p, ready_ms in zip(plans, group_ready_ms):
                session.event(
                    "group_chunk", step=step, group=p.name, op=p.spec.op,
                    ratio=p.ratio,
                    dtype=stencil_lib.dtype_name(p.stencil.dtype),
                    steps=n, wall_s=round(dtc, 4),
                    ready_ms_per_step=ready_ms,
                    mcells_per_s=round(p.cells * n / dtc / 1e6, 3))
            mon = getattr(session.recorder, "anomaly", None)
            if mon is not None:
                try:
                    mon.observe_members(step, [
                        {"name": p.name, "ms_per_step": ready_ms}
                        for p, ready_ms in zip(plans, group_ready_ms)],
                        kind="group")
                except Exception:  # noqa: BLE001 — never load-bearing
                    pass
        if faults.injected_numeric_poison(step) is not None:
            from .obs import health as health_lib

            runner.fields[0] = health_lib.apply_nan_poison(
                runner.fields[0])
        if cfg.check_finite and step % cfg.check_finite == 0:
            for p, fs in zip(plans, runner.fields):
                for i, f in enumerate(fs):
                    if not f.dtype.is_floating_point:
                        continue
                    if not driver.all_finite(f):
                        raise RuntimeError(
                            f"group {p.name} field {i} became non-"
                            f"finite by step {step} (NaN/Inf blow-up "
                            "— check stability parameters)")
        if monitors is not None:
            _check_groups(plans, monitors, runner.fields, step, session,
                          chunk=chunk)
        if cfg.log_every and step % cfg.log_every == 0:
            log.info("round %d  %s", step, "  ".join(
                f"{p.name}:{p.cells * n / dtc / 1e6:.1f}Mc/s"
                for p in plans))
        if cfg.checkpoint_every and cfg.checkpoint_dir and \
                step % cfg.checkpoint_every == 0:
            with _session_span(session, "checkpoint", step=step):
                runner.save_checkpoint(cfg.checkpoint_dir)
        chunk += 1
    dt = time.perf_counter() - t0
    if monitors is not None and monitors[0].checks == 0:
        _check_groups(plans, monitors, runner.fields, cfg.iters, session)
    mcells = cells_round * remaining / dt / 1e6
    log.info("%d coupled rounds x %d groups (%d cell-updates/round) in "
             "%.3fs  (%.1f Mcells/s)", remaining, len(plans),
             cells_round, dt, mcells)
    if session is not None:
        session.finish(steps=remaining, wall_s=round(dt, 4),
                       mcells_per_s=round(mcells, 3), coupled=True,
                       n_groups=len(plans),
                       cell_updates_per_round=cells_round)
    if cfg.checkpoint_dir and (cfg.checkpoint_every or cfg.resume):
        with _session_span(session, "checkpoint", step=cfg.iters,
                           final=True):
            runner.save_checkpoint(cfg.checkpoint_dir)
    fields = runner.assemble()
    if cfg.render:
        f = fields[0]
        print(render.ascii_render(
            np.asarray(f.float() if f.is_floating_point() else f)))
    return fields, mcells


def _check_groups(plans, monitors, group_fields, step: int, session,
                  chunk=None) -> None:
    """Each group's sentinel at one boundary: a ``health`` record naming
    the group, and a DIVERGED verdict raised naming it first."""
    from .obs import health as health_lib

    for p, mon, fs in zip(plans, monitors, group_fields):
        rec = mon.check(step, fs, chunk=chunk)
        rec["group"] = p.name
        if session is not None:
            session.event("health", **rec)
        if rec["verdict"] == health_lib.VERDICT_DIVERGED:
            raise health_lib.SimulationDiverged(
                f"group {p.name} DIVERGED at step {step}: "
                f"{rec['reason']}", record=rec)


def _check_peer_ring(step_fn) -> None:
    """After the loop, on a peer ring (``--exchange rdma`` across
    processes): raise a wait that timed out, and hold every site's flags
    and credits at its last epoch (collective: every process drained
    every epoch)."""
    transport = getattr(step_fn, "_rdma_transport", None)
    if transport is None or not transport.multiprocess:
        return
    transport.check()
    transport.check_drained()
    log.info("exchange: peer ring drained: %d site(s), %d shift(s) "
             "posted here", len(transport.peer_sites()),
             transport.stats["shifts"])


def _slowest(fields, dt: float) -> float:
    """``dt`` of this process, or the largest of every process's on a
    mesh that spans processes."""
    mesh = getattr(fields[0], "mesh", None)
    return dt if mesh is None else mesh.max_all(dt)


def _rank_tag() -> str:
    """`` [rank r/n]`` under a launcher's multi-process run, else empty:
    each process's log lines say whose they are."""
    world = os.environ.get("WORLD_SIZE", "1")
    if os.environ.get("MASTER_ADDR") and world.isdigit() and int(world) > 1:
        return f" [rank {os.environ.get('RANK', '?')}/{world}]"
    return ""


SUPERVISE_PROCESSES_ITEM = ("ROADMAP A8 (resilience): --supervise under "
                            "a multi-process launch")


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(levelname)s %(name)s{_rank_tag()}: "
               "%(message)s")
    cfg = config_from_args(argv)
    if cfg.supervise:
        if _launched_multiprocess():
            # the supervisor watches one child process, as the TPU
            # package's does
            raise NotImplementedError(
                "--supervise watches one process; under a multi-process "
                f"launch it is not ported: {SUPERVISE_PROCESSES_ITEM}")
        from .resilience import supervisor as supervisor_lib

        return supervisor_lib.run_supervised(cfg)
    try:
        run(cfg)
    finally:
        mesh_lib.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
