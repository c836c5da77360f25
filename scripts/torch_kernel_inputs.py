#!/usr/bin/env python3
"""How the advection and Gray-Scott kernels' times depend on their inputs,
on one NVIDIA card.

    python3 scripts/torch_kernel_inputs.py [--grid 512] [--steps 40]

A ``--grid``^3 float32 state of grayscott3d and of advect3d (cz = -0.25, as
the main path of chip_smoke.py runs it) in four forms: uniform random
values in [0, 1) (what chip_smoke.py times), the family's own init
(Gray-Scott's patch, advection's pulse), that init advanced ``--steps``
plain steps (the state a CLI run of that length passes through), and the
same state with its subnormal values (|x| < 2^-126) set to 0.  For each
form: the count of subnormal cells, and by CUDA events over ``--reps``
launches after one warm-up the whole-step raw kernel (K1's advection kind,
``raw_step_grayscott``) and K3 ``fused_step`` at k = 4.  Then the CLI
itself (``cli.run``, host clock, as chip_smoke.py reads it) at ``--steps``
and 5 x ``--steps`` iterations of ``--compute pallas``, with the caching
allocator's cudaMalloc calls over the run.  Prints one JSON line per
measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = 2.0 ** -126  # float32's smallest normal


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import cli, driver, make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import _build, fused, rawstep
    from mpi_cuda_process_tpu_torch.utils.init import init_state

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    shape = (a.grid,) * 3

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / a.reps

    def subnormal(fields):
        return sum(int(((f != 0) & (f.abs() < TINY)).sum()) for f in fields)

    params = {"advect3d": {"cz": -0.25}}
    for name in ("grayscott3d", "advect3d"):
        st = make_stencil(name, **params.get(name, {}))
        raw = rawstep.make_raw_step(st, shape, device=dev)
        plain = driver.make_step(st, shape)
        init = init_state(st, shape, 0, device=dev)
        stepped = init
        for _ in range(a.steps):
            stepped = plain(stepped)
        forms = {
            "random": tuple(torch.rand(shape, generator=gen, device=dev)
                            for _ in range(st.num_fields)),
            "init": init,
            f"init+{a.steps}": stepped,
            f"init+{a.steps}, subnormals set to 0": tuple(
                torch.where(f.abs() < TINY, torch.zeros_like(f), f)
                for f in stepped),
        }
        for form, fields in forms.items():
            print(json.dumps({
                "stencil": name, "input": form,
                "subnormal_cells": subnormal(fields),
                "raw_ms": time_ms(lambda: raw(fields)),
                "fused_k4_ms": time_ms(
                    lambda: fused.fused_step(fields, st, 4))}), flush=True)
        del forms, init, stepped
        torch.cuda.empty_cache()
        for iters in (a.steps, 5 * a.steps):
            argv = ["--stencil", name, "--grid", ",".join(map(str, shape)),
                    "--iters", str(iters), "--compute", "pallas"]
            for key, v in params.get(name, {}).items():
                argv += ["--param", f"{key}={v}"]
            s0 = torch.cuda.memory_stats()
            _, mcells = cli.run(cli.config_from_args(argv))
            s1 = torch.cuda.memory_stats()
            print(json.dumps({
                "stencil": name, "cli": argv[6:], "iters": iters,
                "ms_per_step": 1e3 * a.grid ** 3 / (mcells * 1e6),
                "cuda_mallocs": s1["segment.all.allocated"]
                - s0["segment.all.allocated"]}), flush=True)
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
