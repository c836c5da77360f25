#!/usr/bin/env python3
"""Launch tiles of the tiled one-step kernels (``csrc/march.cuh``): K4,
K5 and K7 (``zchunk_heat``, ``zchunk_wave``, ``whole2d_step``) and the raw
steps K1, K2 and Gray-Scott's (``raw_step_heat``, ``raw_step_wave``,
``raw_step_grayscott``), on one NVIDIA card.

    python3 scripts/torch_compute_tiles.py [--reps 10] [--quick] [--parent DIR]
                                           [--cli] [--only K1,K2,GS]

Builds only ``csrc/zchunk.cu``, ``csrc/whole2d.cu`` and ``csrc/rawstep.cu``
(a few minutes).  Then, for every kind of ``kernels.TILES`` — K4 heat3d
and K5 wave3d on one 2x2 shard of 1024^3, heat3d27 and heat3d4th on one
2x2 shard of 512^3, K7 heat2d and Life at 16384^2 — and of
``rawstep.TILES`` — K1 heat3d, heat3d27, heat3d4th and advect3d (cz =
-0.25), K2 wave3d and Gray-Scott (GS) grayscott3d on the unsharded 512^3
grid, heat3d and wave3d also at 1024^3 — in float32, bfloat16 (cells in
pairs) and Life's int32, times by CUDA events every candidate tile
(``march.candidates``; ``--quick``: the table's tile), each result held
to the plain version (the stencil's own update; the raw kinds:
``driver.make_step``, every field, on the card) bit for bit.  Each line
names the tile's build (threads, blocks an SM, register cap), its cells,
rows, run and strip, its shared memory and the bound (one read of each
input and one write of each output at the data sheet's 3.35 TB/s).
Before timing it checks the table's tile on small blocks: widths in each
residue mod 8, one plane, one row, one cell (the raw kinds: the smallest
grid they take), runs that do not divide the extent, raw grids whose
every tile touches a wall beside grids with interior tiles, and bfloat16
inputs with subnormals, signed zeros and sums on ties
(``tests/compute_schedule.py::special_bf16``); the raw kinds take two
steps there.  ``--only`` keeps the named kernels (K1, K2, GS, K4, K5,
K7).  It also prints every ``march_step`` instantiation's registers,
stack and local memory (``cuobjdump -res-usage`` on the built library).
With ``--parent DIR`` (an unpacked earlier tree of this repository) the
earlier tree's launch of every kind above is timed in a subprocess
before and after this tree's, and this tree's beside them, on the same
card (parent, this, this, parent), and the parent's instantiations'
resources are printed beside this tree's (an instantiation whose
registers, stack or local memory moved is listed); with ``--cli`` also
the CLI ms/step of the ``--compute pallas`` runs in ``CLI_RUNS`` in both
trees, in the same order (the CLI's own clock, kernels built before it
starts).  Prints one JSON line per measurement, the fastest tile per
kind, writes them all to
chiprun_out/compute_tiles.json, then prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

SOURCES = ("zchunk", "whole2d", "rawstep")
# (kernel, stencil, dtypes, the main path's output shape): the compute_fn
# kernels on their padded blocks, K1, K2 and Gray-Scott on the raw grid
KINDS = (("K4", "heat3d", ("float32", "bfloat16"), (512, 512, 1024)),
         ("K4", "heat3d27", ("float32", "bfloat16"), (256, 256, 512)),
         ("K4", "heat3d4th", ("float32", "bfloat16"), (256, 256, 512)),
         ("K5", "wave3d", ("float32", "bfloat16"), (512, 512, 1024)),
         ("K7", "heat2d", ("float32", "bfloat16"), (16384, 16384)),
         ("K7", "life", ("int32",), (16384, 16384)),
         ("K1", "heat3d", ("float32", "bfloat16"), (512, 512, 512)),
         ("K1", "heat3d27", ("float32", "bfloat16"), (512, 512, 512)),
         ("K1", "heat3d4th", ("float32", "bfloat16"), (512, 512, 512)),
         ("K1", "advect3d", ("float32", "bfloat16"), (512, 512, 512)),
         ("K2", "wave3d", ("float32", "bfloat16"), (512, 512, 512)),
         ("GS", "grayscott3d", ("float32", "bfloat16"), (512, 512, 512)))
RAW = ("K1", "K2", "GS")
# K1 heat3d's and K2's unsharded CLI size, timed at the table's tile and
# its candidates beside the 512^3 ones
BIG = (("K1", "heat3d", ("float32", "bfloat16"), (1024, 1024, 1024)),
       ("K2", "wave3d", ("float32", "bfloat16"), (1024, 1024, 1024)))
# parameters of the kinds (advection with a negative Courant number on
# one axis, as on the main path)
PARAMS = {"advect3d": {"cz": -0.25}}
# the small blocks of the correctness sweep (output shapes)
SMALL3D = [(5, 7, 8 * 4 + r) for r in range(8)] + [
    (1, 1, 1), (1, 9, 33), (9, 1, 130), (67, 3, 5), (3, 18, 131)]
SMALL2D = [(9, 8 * 8 + r) for r in range(8)] + [
    (1, 1), (1, 1000), (1000, 1), (517, 7), (3, 4099)]


def small_raw(h):
    """The raw kinds' sweep: x in each residue mod 8, the smallest grid the
    step takes, every tile at a wall, grids with interior tiles and
    runs."""
    m = 2 * h + 1
    return [(m + 4, m + 5, 8 * 4 + r) for r in range(8)] + [
        (m, m, m), (m, 9, 33), (9, m, 130), (67, m + 2, m + 4),
        (m + 2, 18, 131), (40, 40, 600), (70, 37, 1100)]


# --cli: (stencil, grid, iterations, flags) of the --compute pallas runs
# timed in both trees: K1, K2 and Gray-Scott (its own init, the patch)
# unsharded, K5 on --mesh 2,2 (shards on one card)
CLI_RUNS = (("heat3d", "512,512,512", 100, ()),
            ("heat3d", "512,512,512", 100, ("--dtype", "bfloat16")),
            ("heat3d", "1024,1024,1024", 50, ()),
            ("heat3d", "1024,1024,1024", 50, ("--dtype", "bfloat16")),
            ("heat3d27", "512,512,512", 100, ()),
            ("advect3d", "512,512,512", 100, ("--param", "cz=-0.25")),
            ("wave3d", "1024,1024,1024", 50, ("--mesh", "2,2")),
            ("wave3d", "1024,1024,1024", 50, ("--mesh", "2,2", "--dtype",
                                              "bfloat16")),
            ("wave3d", "1024,1024,1024", 50, ()),
            ("wave3d", "1024,1024,1024", 50, ("--dtype", "bfloat16")),
            ("grayscott3d", "1024,1024,1024", 50, ("--init", "patch")),
            ("grayscott3d", "1024,1024,1024", 50, ("--init", "patch",
                                                   "--dtype", "bfloat16")))


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


# times every kind at its main-path shape through the wrappers a run
# calls, in whichever tree ROOT names (this one, or --parent)
TREE_TIMES = """
import json, sys, torch
sys.path.insert(0, ROOT)
from mpi_cuda_process_tpu_torch import make_stencil
from mpi_cuda_process_tpu_torch.ops.cuda import _build, kernels, rawstep
_build.SOURCES = SOURCES
dev = torch.device("cuda", torch.cuda.current_device())
gen = torch.Generator(device=dev)
gen.manual_seed(16)
out = {}
for kern, name, dts, shape in KINDS:
    for dt in dts:
        kw = PARAMS.get(name, {})
        st = make_stencil(name, **kw) if dt == "int32" else make_stencil(
            name, dtype=dt, **kw)
        raw = kern in RAW
        first = shape if raw else tuple(s + 2 * st.halo for s in shape)
        ins = (torch.rand(first, generator=gen, device=dev).to(st.dtype),)
        ins += tuple(torch.rand(shape, generator=gen, device=dev).to(
            st.dtype) for _ in range(st.num_fields - 1))
        fn = rawstep.make_raw_step(st, shape, device=dev) if raw else \\
            kernels.make_pallas_compute(st, device=dev)
        fn(ins)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(REPS):
            fn(ins)
        e.record()
        torch.cuda.synchronize()
        out[kern + " " + name + "," + dt] = s.elapsed_time(e) / REPS
        del ins
        torch.cuda.empty_cache()
print("TIMES " + json.dumps(out))
"""


def tree_times(root: str, reps: int, kinds) -> dict:
    """Each kind's ms (at its table entry) in the tree at ``root``, timed
    in a subprocess that imports that tree's package."""
    code = (f"ROOT = {root!r}\nREPS = {reps}\nKINDS = {kinds!r}\n"
            f"PARAMS = {PARAMS!r}\nSOURCES = {SOURCES!r}\nRAW = {RAW!r}\n"
            + TREE_TIMES)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root)
    if r.returncode:
        raise SystemExit(f"tree_times({root}) failed:\n{r.stderr[-4000:]}")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("TIMES ")]
    return json.loads(line[-1][len("TIMES "):])


def res_usage(root: str) -> dict:
    """Registers, stack and local bytes of every ``march_step``
    instantiation in the libraries of ``SOURCES`` built under ``root``
    (``cuobjdump -res-usage``), keyed by source and the instantiation's
    template arguments (its mangled name up to its parameter list)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name in SOURCES:
        libs = sorted(glob.glob(os.path.join(
            root, "build", "torch_kernels", f"lib{name}-*.so")),
            key=os.path.getmtime)
        if not libs:
            continue
        text = subprocess.run([exe, "-res-usage", libs[-1]],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in text.splitlines():
            m = re.match(r"\s*Function (\S+):", line)
            if m:
                fn = m.group(1)
                continue
            if fn and "REG:" in line and "march_step" in fn:
                vals = dict(re.findall(r"(\w+):(\d+)", line))
                key = fn[:fn.index("EEv")] if "EEv" in fn else fn
                out[f"{name} {key}"] = {k: int(vals.get(k, -1)) for k in
                                        ("REG", "STACK", "LOCAL")}
            fn = None if "REG:" in line else fn
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--cli", action="store_true")
    ap.add_argument("--only", default="K1,K2,GS,K4,K5,K7")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from mpi_cuda_process_tpu_torch import driver, make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, kernels, march,
                                                     rawstep)
    from compute_schedule import special_bf16

    only = set(a.only.split(","))
    kinds = tuple(k for k in KINDS if k[0] in only)
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _build.SOURCES = SOURCES  # the three this script times
    _build.build_all()
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if a.parent:
        emit({"parent_ms_before": tree_times(a.parent, 20, kinds)})
        emit({"this_tree_ms": tree_times(ROOT, 20, kinds)})
    emit({"build": {n: [ln.strip() for ln in log.splitlines()
                        if "march_step" in ln or "Used" in ln
                        or "spill" in ln or "stack" in ln][:600]
                    for n, log in _build.build_log.items()},
          "nvcc_seconds": _build.build_seconds})
    try:
        usage = res_usage(ROOT)
        emit({"res_usage": usage})
        if a.parent:
            old = res_usage(a.parent)
            emit({"res_usage_parent": old,
                  "res_usage_moved": {k: {"parent": old[k], "this": usage[k]}
                                      for k in sorted(old.keys() & usage.keys())
                                      if old[k] != usage[k]},
                  "res_usage_only_parent": sorted(old.keys() - usage.keys()),
                  "res_usage_only_this": sorted(usage.keys() - old.keys())})
    except (OSError, subprocess.CalledProcessError) as e:
        emit({"res_usage_error": repr(e)})
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)

    def stencil(name, dt):
        kw = PARAMS.get(name, {})
        return make_stencil(name, **kw) if dt == "int32" else \
            make_stencil(name, dtype=dt, **kw)

    def block(st, shape, raw, special=False):
        """The kind's inputs: the padded block (raw kinds: the raw grid),
        and K5's u_prev; a raw kind's every field."""
        first = shape if raw else tuple(s + 2 * st.halo for s in shape)
        if st.name == "life":
            return ((torch.rand(first, generator=gen, device=dev)
                     < 0.35).to(torch.int32),)
        shapes = (first,) + (shape,) * (st.num_fields - 1)
        if special:
            return tuple(special_bf16(s, gen, dev) for s in shapes)
        return tuple(torch.rand(s, generator=gen, device=dev).to(st.dtype)
                     for s in shapes)

    def run(kern, st, ins, steps=1):
        """The kernel's new fields (the compute_fn kernels: their one)."""
        if kern in RAW:
            step = rawstep.make_raw_step(st, ins[0].shape, device=dev)
            for _ in range(steps):
                ins = step(ins)
            return ins
        return kernels.make_pallas_compute(st, device=dev)(ins)[:1]

    def plain(kern, st, ins, steps=1):
        if kern in RAW:
            step = driver.make_step(st, ins[0].shape)
            for _ in range(steps):
                ins = step(ins)
            return ins
        return st.update(ins)[:1]

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
            t.view(torch.int32)

    def same(got, ref):
        return len(got) == len(ref) and all(
            g.shape == r.shape and torch.equal(bits(g), bits(r))
            for g, r in zip(got, ref))

    def describe(st, tile):
        geo = march.march_geometry(st, tile)
        group = 32 * tile.rowwarps if st.ndim == 3 else tile.threads
        return {"threads": tile.threads,
                "blocks_per_sm": tile.blocks, "registers": tile.registers,
                "tx": tile.tx, "ty": tile.ty, "zrun": tile.zrun,
                "rowwarps": tile.rowwarps, "zqueue": tile.zqueue,
                "strip": tile.tx // group,
                "smem_bytes": geo.smem, "ring_slots": geo.slots}

    def table(kern):
        return rawstep.TILES if kern in RAW else kernels.TILES

    failures = []
    # correctness sweep: every kind's table tile on small blocks (the raw
    # kinds two steps: K2's second reads the first's u as its u_prev)
    for kern, name, dts, _shape in kinds:
        for dt in dts:
            st = stencil(name, dt)
            tile = table(kern)[(name, dt)]
            raw = kern in RAW
            shapes = small_raw(st.halo) if raw else \
                SMALL2D if st.ndim == 2 else SMALL3D
            checked = 0
            for shape in shapes:
                for special in ((False, True) if dt == "bfloat16"
                                else (False,)):
                    ins = block(st, shape, raw, special)
                    steps = 2 if raw else 1
                    got = run(kern, st, ins, steps)
                    ref = plain(kern, st, ins, steps)
                    torch.cuda.synchronize()
                    if not same(got, ref):
                        bad = [(bits(g) != bits(r)).nonzero()[:3].tolist()
                               for g, r in zip(got, ref)
                               if g.shape == r.shape]
                        failures.append({
                            "kernel": kern, "stencil": name, "dtype": dt,
                            "tile": list(tile), "shape": list(shape),
                            "special": special, "first_bad": bad})
                    checked += 1
            emit({"check": kern, "stencil": name, "dtype": dt,
                  **describe(st, tile), "blocks_checked": checked})
    if failures:
        emit({"failures": failures})
    # timing at the main path's shapes
    best = {}
    timed = list(kinds) + [k for k in BIG if k[0] in only]
    for kern, name, dts, shape in timed:
        for dt in dts:
            st = stencil(name, dt)
            key = (name, dt)
            tab = table(kern)
            saved = tab[key]
            ins = block(st, shape, kern in RAW)
            ref = plain(kern, st, ins)
            # every input read once, every output written once (K2's new
            # u_prev is its old u: not written)
            written = 2 if kern == "GS" else 1
            nbytes = sum(t.numel() for t in ins) + written * ref[0].numel()
            bound = nbytes * ref[0].element_size() / 3.35e12 * 1e3
            for tile in ([saved] if a.quick else march.candidates(st)):
                tab[key] = tile
                got = run(kern, st, ins)
                ok = same(got, ref)
                ms = time_ms(torch, lambda: run(kern, st, ins), a.reps)
                emit({"kernel": kern, "stencil": name, "dtype": dt,
                      "shape": list(shape), **describe(st, tile), "ms": ms,
                      "bound_ms": bound, "fraction_of_bound": bound / ms,
                      "bit_equal_to_plain": ok})
                if not ok:
                    failures.append({"kernel": kern, "stencil": name,
                                     "dtype": dt,
                                     "tile": describe(st, tile),
                                     "shape": list(shape)})
                elif (kern, name, dt, shape) not in best or \
                        ms < best[(kern, name, dt, shape)][1]:
                    best[(kern, name, dt, shape)] = (tile, ms)
                del got
            tab[key] = saved
            del ins, ref
            torch.cuda.empty_cache()
    for (kern, name, dt, shape), (tile, ms) in best.items():
        emit({"best": kern, "stencil": name, "dtype": dt,
              "shape": list(shape), "tile": list(tile), "ms": ms,
              "table": list(table(kern)[(name, dt)])})
    if a.parent:
        emit({"this_tree_ms_after": tree_times(ROOT, 20, kinds)})
        emit({"parent_ms_after": tree_times(a.parent, 20, kinds)})
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
