#!/usr/bin/env python3
"""Core tiles of K3's SOR kind (``fused_step<SOR7>``), on one NVIDIA card.

    python3 scripts/torch_sor_cores.py [--grid 512] [--reps 10]

sor3d relaxes in place in one shared-memory buffer, with a margin of 2k, so
its window may hold a larger core than ``fused.CORE``.  For each candidate
(TZ, TY, TX) core whose window fits one block (the library takes the core
as an argument, so one build serves all), runs ``fused_step`` on a
``--grid``^3 float32 grid of random values at k = 4 and k = 2, holds the
result against k plain red-black steps (max |d| printed; the kernel is
meant to be bit-equal) and times it by CUDA events over ``--reps`` launches
after one warm-up, beside the streaming kernel K10 and the plain steps on
the same input.  Prints one JSON line per measurement, then the card's name
and power limit; the byte bound is one read and one write of the field at
the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CANDIDATES = ((8, 8, 32), (8, 16, 32), (12, 16, 32), (16, 16, 32),
              (8, 8, 64), (4, 16, 64), (16, 16, 64), (32, 16, 32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import _build, fused, streamfused
    from mpi_cuda_process_tpu_torch.ops.cuda.rawstep import coefficients
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    lib = fused._lib()
    st = make_stencil("sor3d")
    kind = fused._FUSED[st.name][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    grid = (a.grid,) * 3
    u = torch.rand(grid, generator=gen, device=dev)
    bound = 2 * 4 * a.grid ** 3 / 3.35e12 * 1e3

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for k in (4, 2):
        m = k_step_margin(st, k)
        ref = fused.plain_steps((u,), st, k)[0]
        out = torch.empty_like(u)

        def launch(core):
            rc = lib.fused_step_f32(kind, u.data_ptr(), None, out.data_ptr(),
                                    None, *grid, k, 0, *coefficients(st),
                                    *core, fused.THREADS, fused.PATHS,
                                    _build.stream_of(u))
            _build.check(lib, rc, "fused_step")

        for core in CANDIDATES:
            smem = fused.smem_bytes(core, m, fused.buffers(st))
            if smem > fused.SMEM_LIMIT:
                continue
            ms = time_ms(lambda: launch(core), a.reps)
            launch(core)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "fused_step<sor3d>", "k": k, "core": list(core),
                "default": core == fused.core_of(st), "smem_bytes": smem,
                "ms": ms, "ms_per_step": ms / k, "bound_ms": bound,
                "max_abs_err": float((out - ref).abs().max())}), flush=True)
        stream = streamfused.make_stream_fused_step(st, grid, k, device=dev)
        got = stream((u,))[0]
        print(json.dumps({
            "kernel": "stream_step<sor3d>", "k": k,
            "ms": time_ms(lambda: stream((u,)), a.reps),
            "max_abs_err": float((got - ref).abs().max()),
            "plain_ms": time_ms(lambda: fused.plain_steps((u,), st, k), 2),
            "bound_ms": bound}), flush=True)
    print(json.dumps({"grid": list(grid), "card": smi}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
