#!/usr/bin/env python3
"""A/B of the overlapped sharded step's stream policy, on one NVIDIA card.

    python3 scripts/torch_overlap_streams.py [--grid 1024] [--steps 20]

Runs the PyTorch port's ``make_sharded_step(overlap=True)`` for heat3d with
the compute_fn kernel (K4) on a 2x2 mesh of four shards on one card, in
turns: the non-overlapped step, the overlapped step as the package writes
it (side stream ordered both ways, no ``record_stream``), and the same step
with ``record_stream`` added on every tensor that crosses streams (the
field blocks the side stream reads, the padded blocks the current stream
reads).  For each it prints one JSON line: ms per step (host clock over
``--steps`` steps ending in a synchronize, after one warm-up step), the
caching allocator's cudaMalloc calls and free-and-retry events over those
steps (``torch.cuda.memory_stats``), and the peak memory.  Four shards on
one card measure decomposition overhead, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import kernels
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.parallel.mesh import make_mesh
    from mpi_cuda_process_tpu_torch.utils.init import init_state_sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    st = make_stencil("heat3d")
    grid = (a.grid,) * 3
    mesh = make_mesh((2, 2), [dev] * 4)
    comp = kernels.make_pallas_compute(st, device=dev)

    plain_join, plain_exchange = (stepper._SideStreams.join,
                                  stepper.exchange_and_pad)
    crossing = []  # (tensor, stream that reads it) of the current step

    def run(label, overlap, record_streams):
        if record_streams:
            def join(self):
                plain_join(self)
                for t, s in crossing:
                    t.record_stream(s)
                crossing.clear()

            def exchange(blocks, *args, **kw):
                side = torch.cuda.current_stream(dev)
                for b in blocks:
                    crossing.append((b, side))  # read on the side stream
                out = plain_exchange(blocks, *args, **kw)
                for p in out:  # read later on the current stream
                    crossing.append((p, torch.cuda.default_stream(dev)))
                return out

            stepper._SideStreams.join = join
            stepper.exchange_and_pad = exchange
        try:
            step = stepper.make_sharded_step(st, mesh, grid, compute_fn=comp,
                                             overlap=overlap)
            fields = init_state_sharded(st, grid, mesh, kind="pulse")
            fields = step(fields)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s0 = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            for _ in range(a.steps):
                fields = step(fields)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            s1 = torch.cuda.memory_stats()
            print(json.dumps({
                "variant": label, "grid": list(grid), "mesh": [2, 2],
                "steps": a.steps, "ms_per_step": 1e3 * dt / a.steps,
                "cuda_mallocs": s1["segment.all.allocated"]
                - s0["segment.all.allocated"],
                "alloc_retries": s1["num_alloc_retries"]
                - s0["num_alloc_retries"],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "card": smi}), flush=True)
            del fields, step
        finally:
            stepper._SideStreams.join = plain_join
            stepper.exchange_and_pad = plain_exchange
            crossing.clear()
            torch.cuda.empty_cache()

    for label, overlap, rs in (("non-overlap", False, False),
                               ("overlap", True, False),
                               ("overlap+record_stream", True, True),
                               ("overlap+record_stream", True, True),
                               ("overlap", True, False),
                               ("non-overlap", False, False)):
        run(label, overlap, rs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
