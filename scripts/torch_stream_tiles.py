#!/usr/bin/env python3
"""Column shapes of the streaming kernel (K10), on one NVIDIA card.

    python3 scripts/torch_stream_tiles.py [--grid 512] [--reps 10]

For each candidate (TY, TX) column of ``streamfused.TILE`` that fits shared
memory (one built library serves every column), runs ``stream_step`` for
heat3d, wave3d, heat3d27 (k = 4) and heat3d4th (k = 2) on a ``--grid``^3
float32 grid of random values, holds the result against k
plain steps (max |d| printed; the kernel is meant to be bit-equal), and
times it by CUDA events over ``--reps`` launches after one warm-up, beside
the overlapped-window kernel K3 (``fused_step``) on the same input, timed
before and after the candidates.  Then the default column at k = 1, 2, 3,
4, 6 and 8 (heat3d; ms per pass and per step, beside the one-step kernel
K1), and ``stream_yzslab`` on one shard of a 2x2 mesh of a 2*grid cube
(heat3d).  Prints one JSON line per measurement, then the card's name and
power limit; the byte bound is one read and one write of every field at
the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CANDIDATES = ((16, 64), (16, 56), (24, 56), (8, 120), (16, 120), (32, 56),
              (8, 128))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fused, rawstep,
                                                     streamfused)

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_log.get(
        "streamfused", "").splitlines() if "Used" in ln or "spill" in ln]}),
        flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

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

    grid = (a.grid,) * 3
    default = streamfused.TILE
    for name, k in (("heat3d", 4), ("wave3d", 4), ("heat3d27", 4),
                    ("heat3d4th", 2)):
        st = make_stencil(name)
        fields = tuple(torch.rand(grid, generator=gen, device=dev)
                       for _ in range(st.num_fields))
        ref = fused.plain_steps(fields, st, k)
        bound = 2 * st.num_fields * 4 * a.grid ** 3 / 3.35e12 * 1e3
        k3 = [time_ms(lambda: fused.fused_step(fields, st, k))]
        rows = []
        for tile in CANDIDATES:
            streamfused.TILE = tile
            if not streamfused.fits(st, k):
                continue
            got = streamfused.stream_step(fields, st, k)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            del got
            rows.append({"stencil": name, "k": k, "grid": list(grid),
                         "tile": list(tile),
                         "smem": streamfused.smem_bytes(st, k),
                         "max_abs_err": err,
                         "ms": time_ms(lambda: streamfused.stream_step(
                             fields, st, k))})
        streamfused.TILE = default
        k3.append(time_ms(lambda: fused.fused_step(fields, st, k)))
        for r in rows:
            r.update(k3_ms=k3, bound_ms=bound)
            print(json.dumps(r), flush=True)
        del fields, ref
        torch.cuda.empty_cache()

    # levels: the default column at k = 1..8, heat3d (ms per pass and per
    # step, beside K1's one-step kernel on the same grid)
    st = make_stencil("heat3d")
    fields = (torch.rand(grid, generator=gen, device=dev),)
    raw = rawstep.make_raw_step(st, grid, device=dev)
    k1 = time_ms(lambda: raw(fields))
    for k in (1, 2, 3, 4, 6, 8):
        got = streamfused.stream_step(fields, st, k)
        ref = fused.plain_steps(fields, st, k)
        err = float((got[0] - ref[0]).abs().max())
        ms = time_ms(lambda: streamfused.stream_step(fields, st, k))
        print(json.dumps({"stencil": "heat3d", "k": k, "grid": list(grid),
                          "tile": list(default), "max_abs_err": err,
                          "ms": ms, "ms_per_step": ms / k,
                          "k1_ms_per_step": k1}), flush=True)
        del got, ref
    del fields

    # one (z, y) shard of a 2x2 mesh: the core, slabs and corners
    st = make_stencil("heat3d")
    k, m = 4, 4
    gshape = (2 * a.grid,) * 3
    Lz, Ly, X = a.grid, a.grid, 2 * a.grid

    def piece(shape):
        return (torch.rand(shape, generator=gen, device=dev),)

    args = (piece((Lz, Ly, X)), piece((m, Ly, X)), piece((m, Ly, X)),
            piece((Lz, m, X)), piece((Lz, m, X)),
            [piece((m, m, X)) for _ in range(4)], st, k, gshape, (0, 0))
    ref = fused.plain_yzslab(*args)
    k9 = [time_ms(lambda: fused.fused_yzslab(*args))]
    rows = []
    for tile in CANDIDATES:
        streamfused.TILE = tile
        if not streamfused.fits(st, k):
            continue
        got = streamfused.stream_yzslab(*args)
        torch.cuda.synchronize()
        err = float((got[0] - ref[0]).abs().max())
        rows.append({"stencil": "heat3d", "k": k, "shard": [Lz, Ly, X],
                     "tile": list(tile), "max_abs_err": err,
                     "ms": time_ms(lambda: streamfused.stream_yzslab(*args))})
    streamfused.TILE = default
    k9.append(time_ms(lambda: fused.fused_yzslab(*args)))
    for r in rows:
        r.update(k9_ms=k9, bound_ms=2 * 4 * Lz * Ly * X / 3.35e12 * 1e3)
        print(json.dumps(r), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
