#!/usr/bin/env python3
"""A short on-card check of the compute_fn kernels K4, K5 and K7 and the 2D
k-step kernel K8 in bfloat16 (and float32), on one NVIDIA card.

    python3 scripts/torch_compute_bf16.py

Builds the kernels, then holds every instance against its plain version on
random inputs (max |d| must be 0): ``zchunk_heat`` (heat3d, heat3d27,
heat3d4th) and ``zchunk_wave`` on padded blocks of (66, 70, 130) and
(128, 128, 256) cells; ``whole2d`` (heat2d) on (130, 258) and (1000, 777);
``fullgrid_step`` (every float 2D family, k = 1, 3, 8, 16; sor2d k up to 8)
at (130, 258) and (1000, 777), guard-frame and periodic, and
``fullgrid_padded`` on a row shard of a 4-shard split at three origins;
each in bfloat16 and float32.  Then times each at the main path's shapes by
CUDA events (K4 and K5 on one 1024^3 2x2 shard, K7 and K8 at 16384^2) beside
its plain version, and measures the device-memory peak of three CLI runs
on four virtual shards (heat3d 1024^3 --mesh 2,2 --compute pallas in both
types, heat2d 16384^2 --mesh 4 --fuse 16 in bfloat16) beside
``--mem-check``'s estimate.  Prints JSON lines, then the card's name and
power limit; exits 1 if any comparison is not 0.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DTYPES = ("bfloat16", "float32")
FAMILIES_2D = (("heat2d", {}), ("wave2d", {}), ("advect2d", {"cx": -0.4,
                                                             "cy": 0.2}),
               ("grayscott2d", {}), ("sor2d", {}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_compute_bf16: needs a CUDA card")
    from mpi_cuda_process_tpu_torch import cli, driver, make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fullgrid, fused,
                                                     kernels)
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.utils import budget

    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 1)}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    errs, bad = {}, []

    def rnd(shape, dt):
        return torch.rand(shape, generator=gen, device=dev).to(dt)

    def cmp(key, got, ref):
        torch.cuda.synchronize()
        e = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(got, ref))
        errs[key] = max(errs.get(key, 0.0), e)
        if e != 0.0:
            bad.append((key, e))

    for dtype in DTYPES:
        for name in ("heat3d", "heat3d27", "heat3d4th", "wave3d"):
            st = make_stencil(name, dtype=dtype)
            h = st.halo
            comp = kernels.make_pallas_compute(st, device=dev)
            for shape in ((66, 70, 130), (128, 128, 256)):
                ins = (rnd(tuple(s + 2 * h for s in shape), st.dtype),) + (
                    (rnd(shape, st.dtype),) if st.num_fields == 2 else ())
                cmp(f"compute<{name},{dtype}>", comp(ins)[:1],
                    st.update(ins)[:1])
        st = make_stencil("heat2d", dtype=dtype)
        comp = kernels.make_pallas_compute(st, device=dev)
        for shape in ((130, 258), (1000, 777)):
            ins = (rnd(tuple(s + 2 for s in shape), st.dtype),)
            cmp(f"whole2d<heat2d,{dtype}>", comp(ins), st.update(ins))
        for name, kw in FAMILIES_2D:
            st = make_stencil(name, dtype=dtype, **kw)
            nf = st.num_fields
            ks = (1, 3, 8) if name == "sor2d" else (1, 3, 8, 16)
            for shape in ((130, 258), (1000, 776)):
                for periodic in (False, True):
                    if periodic and name == "sor2d" and shape[0] % 2:
                        continue
                    f = tuple(rnd(shape, st.dtype) for _ in range(nf))
                    step = driver.make_step(st, shape, periodic=periodic)
                    for k in ks:
                        ref = f
                        for _ in range(k):
                            ref = step(ref)
                        cmp(f"fullgrid_step<{name},{dtype}>",
                            fullgrid.fullgrid_step(f, st, k, periodic), ref)
                    # one row shard of a 4-shard split, k = 16 (sor2d 8)
                    k = ks[-1]
                    m = k_step_margin(st, k)
                    Ly = shape[0] // 4
                    p = tuple(rnd((Ly + 2 * m, shape[1]), st.dtype)
                              for _ in range(nf))
                    for org in (0, Ly, 3 * Ly):
                        ref = fused._plain_window_steps(
                            p, st, k, (org - m, 0), shape, periodic,
                            wrap_axes=(1,))
                        ref = tuple(r[m:m + Ly] for r in ref)
                        cmp(f"fullgrid_padded<{name},{dtype}>",
                            fullgrid.fullgrid_padded(p, st, k, shape[0], org,
                                                     periodic), ref)
    print(json.dumps(errs))

    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    local = (512, 512, 1024)
    for dtype in DTYPES:
        for name in ("heat3d", "wave3d", "heat3d27", "heat3d4th"):
            st = make_stencil(name, dtype=dtype)
            h = st.halo
            shp = local if name in ("heat3d", "wave3d") else (256, 256, 512)
            ins = (rnd(tuple(s + 2 * h for s in shp), st.dtype),) + (
                (rnd(shp, st.dtype),) if st.num_fields == 2 else ())
            comp = kernels.make_pallas_compute(st, device=dev)
            print(json.dumps({
                "kernel": f"compute<{name},{dtype}>", "shape": list(shp),
                "ms": time_ms(lambda: comp(ins), 10),
                "plain_ms": time_ms(lambda: st.update(ins), 2)}))
            del ins
        grid = (16384, 16384)
        st = make_stencil("heat2d", dtype=dtype)
        ins = (rnd((grid[0] + 2, grid[1] + 2), st.dtype),)
        comp = kernels.make_pallas_compute(st, device=dev)
        print(json.dumps({"kernel": f"whole2d<heat2d,{dtype}>",
                          "shape": list(grid),
                          "ms": time_ms(lambda: comp(ins), 10),
                          "plain_ms": time_ms(lambda: st.update(ins), 2)}))
        del ins
        for name, kw in FAMILIES_2D:
            st = make_stencil(name, dtype=dtype, **kw)
            f = tuple(rnd(grid, st.dtype) for _ in range(st.num_fields))
            for k in ((8,) if name == "sor2d" else (8, 16)):
                ms = time_ms(lambda: fullgrid.fullgrid_step(f, st, k), 3)
                print(json.dumps({"kernel": f"fullgrid_step<{name},{dtype}>",
                                  "k": k, "shape": list(grid),
                                  "ms_per_launch": ms,
                                  "ms_per_step": ms / k}))
            del f
            torch.cuda.empty_cache()

    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
    for name, grid, flags, dtype in (
            ("heat3d", (1024,) * 3, ("--mesh", "2,2", "--compute", "pallas"),
             "bfloat16"),
            ("heat3d", (1024,) * 3, ("--mesh", "2,2", "--compute", "pallas"),
             "float32"),
            ("heat2d", (16384, 16384), ("--mesh", "4", "--fuse", "16"),
             "bfloat16")):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        argv = ["--stencil", name, "--grid", ",".join(map(str, grid)),
                "--iters", "16", "--init", "pulse", "--dtype", dtype, *flags,
                "--mem-check", "warn"]
        cfg = cli.config_from_args(argv)
        fields, mcells = cli.run(cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        del fields
        st = make_stencil(name, dtype=dtype)
        est, parts = budget.estimate_run_bytes(
            st, grid, mesh=cfg.mesh, fuse=cfg.fuse, compute=cfg.compute,
            shards_per_device=4)
        print(json.dumps({"run": argv, "ms_per_step":
                          1e3 * math.prod(grid) / (mcells * 1e6),
                          "peak_bytes": peak, "estimate_bytes": est,
                          "parts": parts}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if bad:
        print("not bit-equal:", bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
