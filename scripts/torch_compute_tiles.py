#!/usr/bin/env python3
"""Launch tiles of the tiled compute_fn kernels K4 and K7
(``csrc/march.cuh``: ``zchunk_heat``, ``whole2d_step``), on one NVIDIA
card.

    python3 scripts/torch_compute_tiles.py [--reps 10] [--quick] [--parent DIR]
                                           [--cli]

Builds only ``csrc/zchunk.cu`` and ``csrc/whole2d.cu`` (about a minute).
Then, for every kind of ``kernels.TILES`` — K4 heat3d on one 2x2 shard of
1024^3, heat3d27 and heat3d4th on one 2x2 shard of 512^3, K7 heat2d and
Life at 16384^2; float32, bfloat16 (cells in pairs) and Life's int32 —
times by CUDA events every candidate tile (``kernels.candidates``;
``--quick``: the table's tile), each result held to the plain update (the
stencil's own, on the card) bit for bit.  Each line names the tile's build
(threads, blocks an SM, register cap), its cells, rows, run and strip, its
shared memory and the bound (one read of the padded block and one write of
the interior at the data sheet's 3.35 TB/s).  Before timing it checks the
table's tile on small blocks: widths in each residue mod 8, one plane, one
row, one cell, runs that do not divide the extent, and bfloat16 inputs
with subnormals, signed zeros and sums on ties
(``tests/compute_schedule.py::special_bf16``).  With ``--parent DIR`` (an unpacked earlier tree of
this repository: the kernels' first form) the earlier tree's K4 / K7
launch of every kind and K5
(``zchunk_wave``, float32 and bfloat16, one 2x2 shard of 1024^3) are
timed in a subprocess before and after this tree's, and this tree's K5
beside them, on the same card; with ``--cli`` also the CLI ms/step of the
``--compute pallas`` runs in ``CLI_RUNS`` in both trees, in the order
parent, this, this, parent (the CLI's own clock, kernels built before it
starts).  Prints one JSON line per measurement, the
fastest tile per kind, writes them all to chiprun_out/compute_tiles.json,
then prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

# (stencil, dtypes, the main path's interior shape)
KINDS = (("heat3d", ("float32", "bfloat16"), (512, 512, 1024)),
         ("heat3d27", ("float32", "bfloat16"), (256, 256, 512)),
         ("heat3d4th", ("float32", "bfloat16"), (256, 256, 512)),
         ("heat2d", ("float32", "bfloat16"), (16384, 16384)),
         ("life", ("int32",), (16384, 16384)))
# the small blocks of the correctness sweep (interior shapes)
SMALL3D = [(5, 7, 8 * 4 + r) for r in range(8)] + [
    (1, 1, 1), (1, 9, 33), (9, 1, 130), (67, 3, 5), (3, 18, 131)]
SMALL2D = [(9, 8 * 8 + r) for r in range(8)] + [
    (1, 1), (1, 1000), (1000, 1), (517, 7), (3, 4099)]


# --cli: (stencil, grid, iterations, flags) of the --compute pallas runs
# timed in both trees; --mesh shards run on one card
CLI_RUNS = (("heat2d", "16384,16384", 300, ()),
            ("heat2d", "16384,16384", 300, ("--dtype", "bfloat16")),
            ("heat2d", "16384,16384", 200, ("--mesh", "4", "--overlap")),
            ("heat3d", "1024,1024,1024", 50, ("--mesh", "2,2")),
            ("heat3d", "1024,1024,1024", 50, ("--mesh", "2,2", "--dtype",
                                              "bfloat16")))


def cli_ms(root: str, stencil: str, grid: str, iters: int, flags) -> float:
    """ms/step of one CLI run in the tree at ``root``, from its "N steps on
    ... in Ts" line."""
    env = dict(os.environ, MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES="4")
    r = subprocess.run(
        [sys.executable, "-m", "mpi_cuda_process_tpu_torch", "--stencil",
         stencil, "--grid", grid, "--iters", str(iters), "--init", "pulse",
         "--compute", "pallas", *flags], cwd=root, env=env,
        capture_output=True, text=True, check=True)
    m = re.search(r"(\d+) steps on \S+ grid in ([0-9.]+)s",
                  r.stdout + r.stderr)
    return 1e3 * float(m.group(2)) / int(m.group(1))


def cli_times(parent: str) -> dict:
    """Each CLI_RUNS entry's ms/step in the parent tree and this one, in
    the order parent, this, this, parent, after building both trees'
    kernels side by side."""
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from mpi_cuda_process_tpu_torch.ops.cuda "
         "import _build; _build.build_all()"], cwd=root)
        for root in (parent, ROOT)]
    if any(p.wait() for p in builds):
        raise SystemExit("--cli: a tree's kernels did not build")
    out = {}
    for stencil, grid, iters, flags in CLI_RUNS:
        key = " ".join((stencil, grid, *flags))
        out[key] = {side: [] for side in ("parent", "this")}
        for side, root in (("parent", parent), ("this", ROOT),
                           ("this", ROOT), ("parent", parent)):
            out[key][side].append(cli_ms(root, stencil, grid, iters, flags))
    return out


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


# times the K4 / K7 kinds at their main-path shapes and K5 on one 2x2
# shard of 1024^3, in whichever tree ROOT names (this one, or --parent)
TREE_TIMES = """
import json, sys, torch
sys.path.insert(0, ROOT)
from mpi_cuda_process_tpu_torch import make_stencil
from mpi_cuda_process_tpu_torch.ops.cuda import _build, kernels
_build.SOURCES = ("zchunk", "whole2d")
dev = torch.device("cuda", torch.cuda.current_device())
gen = torch.Generator(device=dev)
gen.manual_seed(16)
out = {}
for name, dts, shape in KINDS + (("wave3d", ("float32", "bfloat16"),
                                  (512, 512, 1024)),):
    for dt in dts:
        st = make_stencil(name) if dt == "int32" else make_stencil(
            name, dtype=dt)
        padded = tuple(s + 2 * st.halo for s in shape)
        ins = (torch.rand(padded, generator=gen, device=dev).to(st.dtype),)
        if name == "wave3d":
            ins += (torch.rand(shape, generator=gen, device=dev).to(
                st.dtype),)
        comp = kernels.make_pallas_compute(st, device=dev)
        comp(ins)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(REPS):
            comp(ins)
        e.record()
        torch.cuda.synchronize()
        out[name + "," + dt] = s.elapsed_time(e) / REPS
        del ins
        torch.cuda.empty_cache()
print("TIMES " + json.dumps(out))
"""


def tree_times(root: str, reps: int) -> dict:
    """Each kind's ms (K4 / K7 at its TILES entry, K5) in the tree at
    ``root``, timed in a subprocess that imports that tree's package."""
    import subprocess as sp
    code = (f"ROOT = {root!r}\nREPS = {reps}\nKINDS = {KINDS!r}\n"
            + TREE_TIMES)
    r = sp.run([sys.executable, "-c", code], capture_output=True, text=True,
               cwd=root, check=True)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("TIMES ")]
    return json.loads(line[-1][len("TIMES "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--cli", action="store_true")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import _build, kernels
    from compute_schedule import special_bf16

    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.SOURCES = ("zchunk", "whole2d")  # the two this script times
    _build.build_all()
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if a.parent:
        emit({"parent_ms_before": tree_times(a.parent, 20)})
        emit({"this_tree_ms": tree_times(ROOT, 20)})
    emit({"build": {n: [ln.strip() for ln in log.splitlines()
                        if "march_step" in ln or "Used" in ln
                        or "spill" in ln or "stack" in ln][:400]
                    for n, log in _build.build_log.items()},
          "nvcc_seconds": _build.build_seconds})
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    def stencil(name, dt):
        return make_stencil(name) if dt == "int32" else \
            make_stencil(name, dtype=dt)

    def block(st, shape, special=False):
        padded = tuple(s + 2 * st.halo for s in shape)
        if st.name == "life":
            return (torch.rand(padded, generator=gen, device=dev)
                    < 0.35).to(torch.int32)
        if special:
            return special_bf16(padded, gen, dev)
        return torch.rand(padded, generator=gen, device=dev).to(st.dtype)

    def run(st, p):
        return kernels.make_pallas_compute(st, device=dev)((p,))[0]

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
            t.view(torch.int32)

    def describe(st, tile):
        geo = kernels.march_geometry(st, tile)
        group = 32 * tile.rowwarps if st.ndim == 3 else tile.threads
        return {"threads": tile.threads,
                "blocks_per_sm": tile.blocks, "registers": tile.registers,
                "tx": tile.tx, "ty": tile.ty, "zrun": tile.zrun,
                "rowwarps": tile.rowwarps, "zqueue": tile.zqueue,
                "strip": tile.tx // group,
                "smem_bytes": geo.smem, "ring_slots": geo.slots}

    failures = []
    # correctness sweep: every kind's table tile on small blocks
    for name, dts, _shape in KINDS:
        for dt in dts:
            st = stencil(name, dt)
            tile = kernels.TILES[(name, dt)]
            checked = 0
            for shape in (SMALL2D if st.ndim == 2 else SMALL3D):
                for special in ((False, True) if dt == "bfloat16"
                                else (False,)):
                    p = block(st, shape, special)
                    got, ref = run(st, p), st.update((p,))[0]
                    torch.cuda.synchronize()
                    if got.shape != ref.shape or not torch.equal(
                            bits(got), bits(ref)):
                        bad = (bits(got) != bits(ref)).nonzero()[:3]
                        failures.append({
                            "kernel": name, "dtype": dt, "tile": list(tile),
                            "shape": list(shape), "special": special,
                            "first_bad": bad.tolist()})
                    checked += 1
            emit({"check": name, "dtype": dt, **describe(st, tile),
                  "blocks_checked": checked})
    if failures:
        emit({"failures": failures})
    # timing at the main path's shapes
    best = {}
    for name, dts, shape in KINDS:
        for dt in dts:
            st = stencil(name, dt)
            key = (name, dt)
            saved = kernels.TILES[key]
            p = block(st, shape)
            ref = st.update((p,))[0]
            cells = ref.numel()
            bound = (p.numel() + cells) * p.element_size() / 3.35e12 * 1e3
            for tile in ([saved] if a.quick else kernels.candidates(st)):
                kernels.TILES[key] = tile
                got = run(st, p)
                same = bool(torch.equal(bits(got), bits(ref)))
                ms = time_ms(torch, lambda: run(st, p), a.reps)
                emit({"kernel": name, "dtype": dt, "shape": list(shape),
                      **describe(st, tile), "ms": ms, "bound_ms": bound,
                      "fraction_of_bound": bound / ms,
                      "bit_equal_to_plain": same})
                if not same:
                    failures.append({"kernel": name, "dtype": dt,
                                     "tile": describe(st, tile),
                                     "shape": list(shape)})
                elif key not in best or ms < best[key][1]:
                    best[key] = (tile, ms)
                del got
            kernels.TILES[key] = saved
            del p, ref
            torch.cuda.empty_cache()
    for (name, dt), (tile, ms) in best.items():
        emit({"best": name, "dtype": dt, "tile": list(tile), "ms": ms,
              "table": list(kernels.TILES[(name, dt)])})
    if a.parent:
        emit({"this_tree_ms_after": tree_times(ROOT, 20)})
        emit({"parent_ms_after": tree_times(a.parent, 20)})
        if a.cli:
            emit({"cli_ms_per_step": cli_times(a.parent)})
    emit({"card": smi, "failures": len(failures)})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compute_tiles.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    print(smi)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
