#!/usr/bin/env python3
"""Launch tiles and fast paths of the streaming kernel (K10:
``csrc/ring.cuh`` through ``streamfused.stream_step``), on one NVIDIA card.

    python3 scripts/torch_stream_tiles.py [--reps 10] [--grid 512]

For every K10 family at its main-path k in float32 (4; heat3d4th 2) and
bfloat16 (4; heat3d and wave3d also 8), times ``stream_step`` on a
``--grid``^3 grid of random values under each candidate tile (TY, TX,
threads, blocks an SM) whose rings fit one block and which has a warp
for every level
(``streamfused.TILES`` is set for the run; one build serves all), each
result held to k plain steps (max |d| printed: the kernel is bit-equal);
heat3d and wave3d also as ``stream_yzslab`` on one (512, 512, 1024) shard
of 1024^3 on 2x2 and as ``stream_zslab`` on one (256, 1024, 1024) shard
of ``--mesh 4``, the shapes of their targets, with the pad-free K9 / K6
beside them.  At each family's best tile it then times the fast paths
apart (``streamfused.PATHS``: none, 16-byte copies alone, no frame test
alone, both): what the per-cell path costs.  K3 (``fused_step``) on the
same input is timed before and after the candidates.  Prints one JSON
line per measurement, writes them all to chiprun_out/stream_tiles.json,
prints the fastest tile of each (family, dtype, k), then the card's name
and power limit.  The byte bound is one read and one write of each field
at the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (family, float32 k, bfloat16 ks)
FAMILIES = (("heat3d", 4, (4, 8)), ("heat3d27", 4, (4,)),
            ("heat3d4th", 2, (4,)), ("wave3d", 4, (4, 8)),
            ("advect3d", 4, (4,)), ("grayscott3d", 4, (4,)),
            ("sor3d", 4, (4,)))
# (TY, TX, threads, blocks an SM); those whose rings exceed shared memory,
# or whose levels outnumber their warps, are skipped
CANDIDATES = ((16, 32, 512, 2), (16, 64, 512, 2), (8, 64, 512, 2),
              (16, 64, 1024, 1), (32, 64, 1024, 1), (32, 32, 1024, 1),
              (32, 64, 512, 1), (32, 32, 512, 1), (16, 64, 512, 1),
              (16, 128, 512, 1), (24, 64, 512, 1), (32, 32, 512, 2))
PARAMS = {"advect3d": {"cz": -0.25}}
SHARDS = {"yzslab": (512, 512, 1024), "zslab": (256, 1024, 1024)}


def time_ms(torch, fn, reps):
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
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    lines = []

    def emit(obj):
        lines.append(obj)
        print(json.dumps(obj), flush=True)

    emit({"ptxas": [ln.strip() for ln in _build.build_log.get(
        "streamfused", "").splitlines() if "Used" in ln or "spill" in ln]})
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    grid = (a.grid,) * 3
    best = {}

    def sweep(st, k, run, ref, what, shape, extra=None):
        """Every candidate tile of (st, k) on `run`; returns the best."""
        key = (st.name, str(st.dtype).replace("torch.", ""), k)
        saved = streamfused.TILES.get(key)
        rows = []
        for tile in CANDIDATES:
            if not streamfused.level_warps_fit(
                    streamfused.levels(st, k), tile[2]) or \
                    streamfused.smem_bytes(st, k, tile) > fused.SMEM_LIMIT:
                continue
            streamfused.TILES[key] = tile
            got = run()
            torch.cuda.synchronize()
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, ref))
            del got
            row = {"what": what, "stencil": st.name, "dtype": key[1],
                   "k": k, "shape": list(shape), "tile": list(tile),
                   "smem": streamfused.smem_bytes(st, k, tile),
                   "max_abs_err": err, "ms": time_ms(torch, run, a.reps),
                   "bound_ms": 2 * st.num_fields * st.dtype.itemsize
                   * shape[0] * shape[1] * shape[2] / 3.35e12 * 1e3}
            row.update(extra or {})
            rows.append(row)
            emit(row)
        win = min(rows, key=lambda r: r["ms"])
        streamfused.TILES[key] = tuple(win["tile"])
        for paths in (0, streamfused.VEC_LOAD, streamfused.FRAME_FREE,
                      streamfused.PATHS):
            streamfused.PATHS = paths
            emit({"what": what + " paths", "stencil": st.name,
                  "dtype": key[1], "k": k, "tile": win["tile"],
                  "paths": paths, "ms": time_ms(torch, run, a.reps)})
        streamfused.PATHS = streamfused.VEC_LOAD | streamfused.FRAME_FREE
        if saved is None:
            del streamfused.TILES[key]
        else:
            streamfused.TILES[key] = saved
        return win

    for name, k32, k16s in FAMILIES:
        for dtype, ks in ((torch.float32, (k32,)), (torch.bfloat16, k16s)):
            for k in ks:
                st = make_stencil(name, dtype=dtype, **PARAMS.get(name, {}))
                fields = tuple(torch.rand(grid, generator=gen, device=dev)
                               .to(dtype) for _ in range(st.num_fields))
                ref = fused.plain_steps(fields, st, k)
                k3 = None
                if fused.margin_of(st, k) is not None:
                    k3 = [time_ms(torch, lambda: fused.fused_step(
                        fields, st, k), a.reps)]
                win = sweep(st, k, lambda: streamfused.stream_step(
                    fields, st, k), ref, "stream_step", grid)
                if k3 is not None:
                    k3.append(time_ms(torch, lambda: fused.fused_step(
                        fields, st, k), a.reps))
                best[f"{name},{win['dtype']},{k}"] = {
                    "tile": win["tile"], "ms": win["ms"], "k3_ms": k3}
                del fields, ref
                torch.cuda.empty_cache()

    # the shards of the targets: heat3d and wave3d, k = 4, float32 and
    # bfloat16, beside the pad-free K9 / K6
    for name in ("heat3d", "wave3d"):
        for dtype in (torch.float32, torch.bfloat16):
            st = make_stencil(name, dtype=dtype)
            k = 4
            m = k_step_margin(st, k)

            def piece(shape):
                return tuple(torch.rand(shape, generator=gen, device=dev)
                             .to(dtype) for _ in range(st.num_fields))

            Lz, Ly, X = SHARDS["yzslab"]
            gshape = (2 * Lz, 2 * Ly, X)
            yz = (piece((Lz, Ly, X)), piece((m, Ly, X)), piece((m, Ly, X)),
                  piece((Lz, m, X)), piece((Lz, m, X)),
                  [piece((m, m, X)) for _ in range(4)], st, k, gshape,
                  (0, Ly))
            ref = fused.plain_yzslab(*yz)
            k9 = None
            if fused.margin_of(st, k) is not None:
                k9 = time_ms(torch, lambda: fused.fused_yzslab(*yz), a.reps)
            win = sweep(st, k, lambda: streamfused.stream_yzslab(*yz), ref,
                        "stream_yzslab", (Lz, Ly, X), {"k9_ms": k9})
            best[f"yzslab:{name},{win['dtype']},{k}"] = {
                "tile": win["tile"], "ms": win["ms"], "k9_ms": k9}
            del yz, ref
            Lz, Y, X = SHARDS["zslab"]
            zs = (piece((Lz, Y, X)), piece((m, Y, X)), piece((m, Y, X)), st,
                  k, 4 * Lz, Lz)
            ref = fused.plain_zslab(*zs)
            k6 = None
            if fused.margin_of(st, k) is not None:
                k6 = time_ms(torch, lambda: fused.fused_zslab(*zs), a.reps)
            win = sweep(st, k, lambda: streamfused.stream_zslab(*zs), ref,
                        "stream_zslab", (Lz, Y, X), {"k6_ms": k6})
            best[f"zslab:{name},{win['dtype']},{k}"] = {
                "tile": win["tile"], "ms": win["ms"], "k6_ms": k6}
            del zs, ref
            torch.cuda.empty_cache()

    emit({"best": best})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "stream_tiles.json"),
              "w") as f:
        json.dump({"card": smi, "lines": lines}, f)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
