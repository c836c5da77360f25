#!/usr/bin/env python3
"""Launch tiles and fast paths of K8's streaming kind (``csrc/ring.cuh``
with the 2D kinds, through ``fullgrid.fullgrid_step`` and
``fullgrid_padded``), on one NVIDIA card.

    python3 scripts/torch_fullgrid_tiles.py [--reps 10] [--grid 16384]
                                            [--families life,wave2d]

For every K8 family at its main-path k (float32 and Life int32: 8;
bfloat16: 16, sor2d 8), times ``fullgrid_step`` on a ``--grid``^2 grid of
random values under each candidate tile (TX, CZ, threads, blocks an SM)
whose rings fit one block and which has a warp for every level (``fullgrid.RING_TILES`` is
set for the run; one build serves all), each result held to k plain steps
(max |d| printed: the kernel is bit-equal), beside the tiled kind (the
first design, ``fullgrid_step<KIND, RAW>``, still the periodic path) on
the same input; bfloat16 grayscott2d and heat2d also through
``fullgrid_padded`` on one (4096, 16384) row shard of ``--mesh 4``.  At
each family's best tile it then times the fast paths apart
(``fullgrid.PATHS``: none, 16-byte copies alone, no frame test alone,
both).  Prints one JSON line per measurement, writes them all to
chiprun_out/fullgrid_tiles.json, prints the fastest tile of each
(family, dtype, k), then the card's name and power limit.  The byte bound
is one read and one write of each field at the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (family, stencil kwargs, float32/int32 k, bfloat16 k or None)
FAMILIES = (("heat2d", {}, 8, 16), ("life", {}, 8, None),
            ("wave2d", {}, 8, 16), ("advect2d", {"cx": -0.4}, 8, 16),
            ("grayscott2d", {}, 8, 16), ("sor2d", {}, 8, 8))
# (TX, CZ, threads, blocks an SM); those whose rings exceed shared memory,
# or whose levels outnumber their warps, are skipped
CANDIDATES = ((480, 512, 512, 2), (480, 1024, 512, 2), (352, 1024, 512, 2),
              (224, 1024, 512, 2), (480, 512, 1024, 1), (480, 1024, 1024, 1),
              (224, 1024, 1024, 1), (1024, 1024, 1024, 1),
              (480, 512, 512, 1), (352, 1024, 512, 1), (256, 1024, 512, 2))


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
    ap.add_argument("--grid", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--families", default="",
                    help="comma-separated families to sweep (default all)")
    a = ap.parse_args()
    only = set(filter(None, a.families.split(",")))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import driver, make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fullgrid, fused,
                                                     streamfused)
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
        "fullgrid", "").splitlines() if "Used" in ln or "spill" in ln]})
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    best = {}
    ring_ok = fullgrid.ring_ok

    def tiled(fn):
        """fn() on the tiled kind: the first design."""
        fullgrid.ring_ok = lambda *args: False
        try:
            return fn()
        finally:
            fullgrid.ring_ok = ring_ok

    def sweep(st, k, run, ref, what, shape):
        key = (st.name, str(st.dtype).replace("torch.", ""), k)
        saved = fullgrid.RING_TILES.get(key)
        old = tiled(lambda: time_ms(torch, run, a.reps))
        rows = []
        for tile in CANDIDATES:
            if not streamfused.level_warps_fit(
                    streamfused.levels(st, k), tile[2]) or \
                    streamfused.smem_bytes(st, k, tile) > fused.SMEM_LIMIT:
                continue
            fullgrid.RING_TILES[key] = tile
            got = run()
            torch.cuda.synchronize()
            err = max(float((g.float() - r.float()).abs().max())
                      for g, r in zip(got, ref))
            del got
            row = {"what": what, "stencil": st.name, "dtype": key[1],
                   "k": k, "shape": list(shape), "tile": list(tile),
                   "smem": streamfused.smem_bytes(st, k, tile),
                   "max_abs_err": err, "ms": time_ms(torch, run, a.reps),
                   "tiled_ms": old,
                   "bound_ms": 2 * st.num_fields * st.dtype.itemsize
                   * shape[0] * shape[1] / 3.35e12 * 1e3}
            rows.append(row)
            emit(row)
        win = min(rows, key=lambda r: r["ms"])
        fullgrid.RING_TILES[key] = tuple(win["tile"])
        for paths in (0, streamfused.VEC_LOAD, streamfused.FRAME_FREE,
                      streamfused.VEC_LOAD | streamfused.FRAME_FREE):
            fullgrid.PATHS = paths
            emit({"what": what + " paths", "stencil": st.name,
                  "dtype": key[1], "k": k, "tile": win["tile"],
                  "paths": paths, "ms": time_ms(torch, run, a.reps)})
        fullgrid.PATHS = streamfused.VEC_LOAD | streamfused.FRAME_FREE
        if saved is None:
            del fullgrid.RING_TILES[key]
        else:
            fullgrid.RING_TILES[key] = saved
        best[f"{what}:{st.name},{key[1]},{k}"] = {
            "tile": win["tile"], "ms": win["ms"], "tiled_ms": old}

    grid = (a.grid, a.grid)
    for name, kw, k32, k16 in FAMILIES:
        if only and name not in only:
            continue
        for dtype, k in ((torch.float32, k32), (torch.bfloat16, k16)):
            if k is None:
                continue
            if name == "life":
                dtype = torch.int32
            st = make_stencil(name, dtype=dtype, **kw)
            if name == "life":
                fields = ((torch.rand(grid, generator=gen, device=dev)
                           < 0.35).to(torch.int32),)
            else:
                fields = tuple(torch.rand(grid, generator=gen, device=dev)
                               .to(dtype) for _ in range(st.num_fields))
            plain = driver.make_step(st, grid)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            sweep(st, k, lambda: fullgrid.fullgrid_step(fields, st, k), ref,
                  "fullgrid_step", grid)
            del fields, ref
            torch.cuda.empty_cache()

    # one (4096, 16384) row shard of --mesh 4, from its padded block
    for name in ("heat2d", "grayscott2d"):
        if only and name not in only:
            continue
        st = make_stencil(name, dtype=torch.bfloat16)
        k = 16
        m = k_step_margin(st, k)
        H = a.grid // 4
        padded = tuple(torch.rand((H + 2 * m, a.grid), generator=gen,
                                  device=dev).to(torch.bfloat16)
                       for _ in range(st.num_fields))
        out = fused._plain_window_steps(padded, st, k, (H - m, 0),
                                        (a.grid, a.grid), False,
                                        wrap_axes=(1,))
        ref = tuple(f[m:m + H] for f in out)
        del out
        sweep(st, k, lambda: fullgrid.fullgrid_padded(padded, st, k, a.grid,
                                                      H),
              ref, "fullgrid_padded", (H, a.grid))
        del padded, ref
        torch.cuda.empty_cache()

    emit({"best": best})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fullgrid_tiles.json"),
              "w") as f:
        json.dump({"card": smi, "lines": lines}, f)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
