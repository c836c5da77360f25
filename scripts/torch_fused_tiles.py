#!/usr/bin/env python3
"""Launch tiles and fast paths of the k-step window kernel (K3, K6, K9:
``csrc/fused.cu::fused_step``), on one NVIDIA card.

    python3 scripts/torch_fused_tiles.py [--reps 10] [--parent DIR]

For every fused family at its main-path k in float32 (halo-1 families k =
4, heat3d4th 2, sor3d 4) and bfloat16 (8; heat3d4th and sor3d 4), times
``fused_step`` on a 512^3 grid of random values under each candidate tile
(TZ, TY, TX, threads) whose window fits one block (``fused.TILES`` is set
for the run; one build serves all), each result held to the default
tile's bit for bit; heat3d and wave3d also as K9 (``fused_yzslab``) on one
(512, 512, 1024) shard of 1024^3 on 2x2, the shape of its target.  At each
family's best tile it then times the fast paths apart (``fused.PATHS``:
none, row loads alone, with 16-byte copies, with no frame test, all):
what the per-cell path costs.  Each line names the cells the tile's
micro-steps update per useful cell-step (the recompute).  With ``--parent
DIR`` (an
unpacked earlier tree of this repository) the earlier kernel's default
launch at each family's 512^3 shape is timed in a subprocess before and
after this tree's, on the same card.  Prints one JSON line per
measurement, writes them all to chiprun_out/fused_tiles.json, then prints
the card's name and power limit.  The byte bound is one read and one
write of each field at the data sheet's 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (family, float32 k, bfloat16 k): each family's k on the main path
FAMILIES = (("heat3d", 4, 8), ("heat3d27", 4, 8), ("heat3d4th", 2, 4),
            ("wave3d", 4, 8), ("advect3d", 4, 8), ("grayscott3d", 4, 8),
            ("sor3d", 4, 4))
# (TZ, TY, TX, threads); those whose window exceeds shared memory are
# skipped
CANDIDATES = ((8, 8, 32, 256), (8, 8, 32, 512), (16, 8, 32, 512),
              (8, 16, 32, 512), (32, 8, 32, 512), (16, 16, 32, 256),
              (16, 16, 32, 512), (16, 16, 32, 1024), (8, 8, 64, 512),
              (16, 8, 64, 512), (16, 8, 64, 1024), (32, 16, 32, 1024))
PARAMS = {"advect3d": {"cz": -0.25}}
GRID = (512, 512, 512)
BIG_SHARD = (512, 512, 1024)  # one 2x2 shard of 1024^3


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


def updated_per_useful(tile, m, h, steps):
    """Cells the micro-steps update per useful cell-step of a tile."""
    tz, ty, tx = tile
    n = sum((tz + 2 * m - 2 * s * h) * (ty + 2 * m - 2 * s * h)
            * (tx + 2 * m - 2 * s * h) for s in range(1, steps + 1))
    return n / (tz * ty * tx * steps)


def parent_times(parent: str, reps: int) -> dict:
    """The earlier tree's default K3 launch at 512^3 per (family, dtype),
    timed in a subprocess that imports that tree's package."""
    code = f"""
import json, sys, torch
sys.path.insert(0, {parent!r})
from mpi_cuda_process_tpu_torch import make_stencil
from mpi_cuda_process_tpu_torch.ops.cuda import fused
out = {{}}
for name, k32, k16 in {FAMILIES!r}:
    for dt, k in (("float32", k32), ("bfloat16", k16)):
        st = make_stencil(name, dtype=dt, **{PARAMS!r}.get(name, {{}}))
        if fused.margin_of(st, k) is None:
            continue
        f = tuple(torch.rand({GRID!r}, device="cuda").to(st.dtype)
                  for _ in range(st.num_fields))
        fn = lambda: fused.fused_step(f, st, k)
        fn(); torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        for _ in range({reps}):
            fn()
        e.record(); torch.cuda.synchronize()
        out[name + "," + dt] = s.elapsed_time(e) / {reps}
        del f
print("PARENT " + json.dumps(out))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=parent, check=True)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("PARENT ")]
    return json.loads(line[-1][len("PARENT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import _build, fused
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.build_all()
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    before = parent_times(a.parent, a.reps) if a.parent else {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    for name, k32, k16 in FAMILIES:
        for dt, k in (("float32", k32), ("bfloat16", k16)):
            st = make_stencil(name, dtype=dt, **PARAMS.get(name, {}))
            if fused.margin_of(st, k) is None:
                continue
            m, h = k_step_margin(st, k), st.halo
            steps = k * (2 if name == "sor3d" else 1)
            key = (name, dt, k)
            isz, nf = st.dtype.itemsize, st.num_fields
            shapes = [("fused_step", GRID)]
            if name in ("heat3d", "wave3d"):
                shapes.append(("fused_yzslab", BIG_SHARD))
            for wrapper, shape in shapes:
                def rand(s):
                    return tuple(torch.rand(s, generator=gen, device=dev)
                                 .to(st.dtype) for _ in range(nf))

                if wrapper == "fused_step":
                    args = (rand(shape),)

                    def call():
                        return fused.fused_step(args[0], st, k)
                else:
                    Lz, Ly, X = shape
                    args = (rand(shape), rand((m, Ly, X)), rand((m, Ly, X)),
                            rand((Lz, m, X)), rand((Lz, m, X)),
                            [rand((m, m, X)) for _ in range(4)], st, k,
                            (2 * Lz, 2 * Ly, X), (0, 0))

                    def call():
                        return fused.fused_yzslab(*args)

                cells = shape[0] * shape[1] * shape[2]
                bound = 2 * nf * isz * cells / 3.35e12 * 1e3
                saved = fused.TILES.get(key)
                fused.TILES.pop(key, None)
                ref = call()
                best = None
                for tile in CANDIDATES:
                    smem = fused.smem_bytes(tile[:3], m, fused.buffers(st),
                                            isz)
                    if smem > fused.SMEM_LIMIT:
                        continue
                    fused.TILES[key] = tile
                    got = call()
                    ms = time_ms(torch, call, a.reps)
                    err = max(float((g.float() - r.float()).abs().max())
                              for g, r in zip(got, ref))
                    emit({"kernel": f"{wrapper}<{name},{dt}>", "k": k,
                          "shape": list(shape), "tile": list(tile),
                          "smem_bytes": smem,
                          "updated_per_useful": updated_per_useful(
                              tile[:3], m, h, steps),
                          "ms": ms, "bound_ms": bound,
                          "max_abs_err_vs_default_tile": err})
                    if best is None or ms < best[1]:
                        best = (tile, ms)
                fused.TILES[key] = best[0]
                every = fused.PATHS
                for paths in (0, fused.ROW_LOAD,
                              fused.ROW_LOAD | fused.VEC_LOAD,
                              fused.ROW_LOAD | fused.FRAME_FREE, every):
                    fused.PATHS = paths
                    emit({"kernel": f"{wrapper}<{name},{dt}>", "k": k,
                          "shape": list(shape), "tile": list(best[0]),
                          "paths": {"vec_load": bool(paths & 1),
                                    "frame_free": bool(paths & 2),
                                    "row_load": bool(paths & 4)},
                          "ms": time_ms(torch, call, a.reps),
                          "bound_ms": bound})
                fused.PATHS = every
                if wrapper == "fused_step" and before:
                    emit({"kernel": f"{wrapper}<{name},{dt}>", "k": k,
                          "best_tile": list(best[0]), "best_ms": best[1],
                          "parent_ms_before": before.get(f"{name},{dt}")})
                if saved is None:
                    fused.TILES.pop(key, None)
                else:
                    fused.TILES[key] = saved
                del args, ref
                torch.cuda.empty_cache()
    if a.parent:
        emit({"parent_ms_after": parent_times(a.parent, a.reps)})
    emit({"card": smi})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "fused_tiles.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
