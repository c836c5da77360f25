#!/usr/bin/env python3
"""Decomposition across processes on one NVIDIA card, alone: chip_smoke.py's
phase 5d (or 5e, 5f, 5g, 5h, 5i, 5j, 5k, 5l, 5m), repeated.

    python3 scripts/torch_multiprocess.py [--repeat N]
        [--phase 5d|5e|5f|5g|5h|5i|5j|5k|5l|5m]

Builds the kernels, then runs ``chip_smoke.multiprocess_phase`` N times
(default 2) in one process: every ``chip_smoke.MP_RUNS`` run (BASELINE
config 3 as 4 processes, wave3d ``--mesh 4`` as 4, Life ``--mesh 2`` as 2)
once in one process and once as its processes sharing the card (gloo
through pinned host buffers), each held bit for bit, with its
``--log-every`` lines and launches, to the one-process run.  Prints each
run's JSON line as the smoke does (ms/step beside the one-process ms/step,
the exchange's host time per step call), so two repeats in one call show
the spread of these short runs; then the card's name and power limit.
Exits 1 if any run differs from its one-process run.  ``--phase 5e`` runs
``chip_smoke.pipeline_checkpoint_phase`` instead: every ``PIPE_RUNS`` run
with and without ``--pipeline`` in one process, ``PIPE_MP_RUNS`` as 4
processes, and the sharded checkpoint killed on 4 processes and resumed
on 2 and on 1 (its write and read seconds and bytes).  ``--phase 5f``
runs ``chip_smoke.peer_ring_phase``: every ``PEER_RUNS`` run (the peer ring,
``--exchange rdma`` across processes, beside its gloo-host twin) in one
process and as its processes, with its ms/step, both transports' host time
and its peak beside ``--mem-check``'s estimate.  ``--phase 5g`` runs
``chip_smoke.auto_dispatch_phase``: every ``AUTO_RUNS`` run under the
default ``--compute auto`` beside the explicit run of the path the
dispatch tables promise (launches, bit-equal fields) and the plain run,
then the sanitizers' blow-ups and the dumps on the card.  ``--phase 5h``
runs ``chip_smoke.ensemble_phase``: every batched kernel against its plain
version and its members' own launches, then every ``ENS_RUNS`` run
(``--ensemble``) beside the unbatched runs of its first and last members.
``--phase 5i`` runs ``chip_smoke.groups_phase``: every ``GROUP_RUNS``
``--groups`` run under both transports (bit-equal to each other and to
its monolithic twin or the plain versions of its kernels; peak beside the
coupled estimate), then ms a round, the exchange's share and launches a
round by CUDA events beside the twin's.  ``--phase 5j`` runs
``chip_smoke.obs_phase``: config 3 with every observability flag beside
its obs-off twin (bit-equal, the same step launches, a valid log, clean
health and audit records, the peak beside the estimate), the ring under
the auditor, an injected numerics fault in a child, the profiler's
attribution on K9 ``--overlap``, 4 processes' health records against one
process's, the groups' records, the heartbeat probe; ms/step with obs on
and off, ms a health check and an audit pass, by CUDA events.  ``--phase
5k`` runs ``chip_smoke.serve_phase``: config 3 with ``--serve 0`` beside
its telemetry-only twin (bit-equal, the same launches, scrapes rising
mid-run), ms/step served and telemetry-only by CUDA events, the ledger's
ingest / best / ``--anomaly`` seeding / flight-recorder lookup, and 4
processes whose process 0 serves 4 ``hosts`` rows.  ``--phase 5l`` runs
``chip_smoke.costmodel_phase``: the ``costmodel`` event of config 3, 2 and
1 runs against each run's own exchange and a recorded pass, the roofline
gap, the launch checks on recorded passes, and ``--supervise`` (a hang and
a SIGKILL, each resumed bit-equal to the twin, and a permanent hang giving
up with the card probe's verdict, all three at once).  ``--phase 5m`` runs
``chip_smoke.serving_phase``: one ``ServingEngine`` over config 2, config
1 and config 3's layout as size classes (grow, shrink, preemption,
cancels, an eviction, a warm class that builds nothing, an over-budget
class refused) and a 2-replica ``ServingRouter`` with a replica killed,
every finished job bit-equal to its solo run, with served ms/step beside
the ``--ensemble 8`` twin, ttfc cold and warm and each repack's ms.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--phase", choices=["5d", "5e", "5f", "5g", "5h", "5i", "5j",
                                        "5k", "5l", "5m"],
                   default="5d")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_multiprocess: no CUDA card")
    import chip_smoke as cs
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fullgrid, fused,
                                                     kernels, rawstep,
                                                     remote, streamfused)

    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger(cs.PKG)
    log.setLevel(logging.INFO)
    log.addHandler(Capture())
    counters = (rawstep.launches, fused.launches, kernels.launches,
                fullgrid.launches, streamfused.launches, remote.launches)

    def counted(fn):
        for c in counters:
            c.clear()
        out = fn()
        got = {}
        for c in counters:
            got.update(c)
        return out, got

    scratch = os.path.join(HERE, "build", "torch_multiprocess")
    os.makedirs(scratch, exist_ok=True)
    for rep in range(args.repeat):
        t0 = time.perf_counter()
        if args.phase == "5f":
            out = cs.peer_ring_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "peer_ring", "repeat": rep,
                     "runs": len(out["runs"]), "nccl": out["nccl"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5m":
            out = cs.serving_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "serving", "repeat": rep,
                     "launches": out["launches"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5l":
            out = cs.costmodel_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "costmodel", "repeat": rep,
                     "launches": out["launches"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5k":
            out = cs.serve_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "serve", "repeat": rep,
                     "launches": out["launches"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5j":
            out = cs.obs_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "obs", "repeat": rep,
                     "launches": out["launches"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5i":
            out = cs.groups_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "groups", "repeat": rep,
                     "runs": len(out["runs"]), "launches": out["launches"],
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5h":
            out = cs.ensemble_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "ensemble", "repeat": rep,
                     "runs": len(out["runs"]),
                     "kernels_checked": len(out["checked"]),
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5g":
            out = cs.auto_dispatch_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "auto_dispatch", "repeat": rep,
                     "runs": len(out["runs"]),
                     "seconds": time.perf_counter() - t0})
            continue
        if args.phase == "5e":
            out = cs.pipeline_checkpoint_phase(counted, lines, {}, scratch)
            cs.emit({"phase": "pipeline_checkpoint", "repeat": rep,
                     "runs": len(out["pipeline"]),
                     "seconds": time.perf_counter() - t0})
            continue
        rows, nccl, _ = cs.multiprocess_phase(counted, lines, {}, scratch)
        cs.emit({"phase": "multiprocess", "repeat": rep, "runs": len(rows),
                 "nccl": nccl, "seconds": time.perf_counter() - t0})
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
