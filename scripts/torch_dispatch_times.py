#!/usr/bin/env python3
"""Time every candidate path of ``--compute auto`` on one NVIDIA card: the
data behind the port's dispatch tables (``cli._RAW_WINS``,
``_AUTO_FUSE_K``, ``_AUTO_FUSE_K_BF16``, ``_AUTO_FUSE_KIND``,
``_AUTO_FULL_K``, ``_COMPUTE_FN_WINS``), and ``raw_wins_at`` the sizes
where a raw kernel beat the plain step (a size-dependent entry, as the
TPU package's ``_RAW_ABOVE_CLIFF``, would need a loss below a size).

    python3 scripts/torch_dispatch_times.py [--only heat3d,life]
        [--sizes 512,16384] [--tree DIR] [--out build/dispatch_times.json]
    python3 scripts/torch_dispatch_times.py --resources [--tree DIR]
    python3 scripts/torch_dispatch_times.py --rehearse   # CPU, tiny, no times

``--tree DIR`` times the port of another unpacked tree of this repository
(``git archive`` of an earlier commit under a git-ignored directory, its
kernels built under ``DIR/build``) with this script, so two trees compare
in one call on one card (run them parent, this, this, parent).
``--resources`` builds the kernels and prints, instead of timing, each
kernel's registers, stack and local bytes a thread (``cuobjdump
-res-usage``), then the kernels whose stack or local memory is not 0
(register spills).

Every candidate runs through ``cli.build`` with its explicit flags, as a
user's command line would, and its step through ``driver.make_runner``:

* plain (``--compute jnp``); the raw-step kernel (``--compute pallas``:
  K1, K2, Gray-Scott's); ``--fuse k`` on the window kernel K3 for each k in
  (2, 4, 8) that ``fused.margin_of`` accepts (unsharded, ``--fuse-kind
  padfree`` runs the same kernel) and on the streaming kernel K10
  (``--fuse-kind stream``) for each k in (2, 4, 8) whose rings fit; for
  the families with a compute_fn kernel, plain against K4/K5 under
  ``--periodic``.  Sizes 256^3 (BASELINE config 2's heat3d first), 512^3
  and 1024^3, every 3D family;
* 2D: plain, K7 (``--compute pallas``, heat2d/mdf and Life) and K8
  (``--fuse k``, k in (4, 8, 16) dividing the step count) at 512^2 for
  1000 steps (BASELINE config 1's heat2d/mdf first) and 16384^2;
* sharded: plain against the compute_fn kernel under ``--mesh 2,2`` at
  1024^3 (3D) and ``--mesh 4`` at 16384^2 (2D), 4 shards on the card.

Each size runs in float32 and bfloat16 (Life in int32).  Per candidate: the
kernels are built and one warm-up chunk runs outside the clock; then
``REPEATS`` chunks, each timed by CUDA events and the host clock (to a
synchronize), with the caching allocator's ``cudaMalloc`` count inside the
clock (0 once its pool is warm); the median and range are printed.  The
first candidate is timed again at the end of the call (the same-call
reread).  One JSON line a candidate; then, per family and dtype, the
fastest path at each size and what the data support under the tables' rule
(a family is entered only where its path won at every measured size); then
a markdown summary; then the card's name and power limit.  Every line also
goes to ``--out``.  Exits 1 when a candidate failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES_3D = ("heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
               "grayscott3d", "sor3d")
FAMILIES_2D = ("heat2d", "mdf", "life", "wave2d", "advect2d", "grayscott2d",
               "sor2d")
DTYPES = ("float32", "bfloat16")
KS_3D = (2, 4, 8)
KS_2D = (4, 8, 16)
# (grid, steps a chunk): the steps a multiple of every k of the size's
# candidates (512^2: BASELINE config 1's 1000 iterations)
SIZES_3D = (((256,) * 3, 128), ((512,) * 3, 32), ((1024,) * 3, 16))
SIZES_2D = (((512, 512), 1000), ((16384, 16384), 32))
SHARDED_3D = ((1024,) * 3, "2,2", 16)
SHARDED_2D = ((16384, 16384), "4", 32)
REHEARSAL_3D = (((16, 16, 32), 8), ((32, 32, 32), 8))
REHEARSAL_2D = (((32, 64), 16), ((64, 64), 16))
REPEATS = 3  # timed chunks a candidate


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


class Timer:
    """Times candidates on the card (or, rehearsing, only runs them)."""

    def __init__(self, rehearse: bool, out):
        import torch

        self.torch = torch
        self.rehearse = rehearse
        self.device = "cpu" if rehearse else "cuda"
        self.out = out
        self.rows = []
        self.failed = []

    def emit(self, obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        self.out.write(line + "\n")
        self.out.flush()

    def _sync(self):
        if not self.rehearse:
            self.torch.cuda.synchronize()

    def _mallocs(self) -> int:
        if self.rehearse:
            return 0
        return self.torch.cuda.memory_stats()["segment.all.allocated"]

    def candidates(self, name, grid, dtype, steps, mesh=None):
        """[(label, flags)] of one (family, grid, dtype): every path the
        port can run for it, explicit."""
        from mpi_cuda_process_tpu_torch import cli
        from mpi_cuda_process_tpu_torch.ops.cuda import (fullgrid, fused,
                                                         kernels, rawstep,
                                                         streamfused)

        cfg = cli.config_from_args(self.argv(name, grid, dtype, steps, ()))
        st = cli._make_cfg_stencil(cfg)
        has_fn = kernels.has_pallas_kernel(st.name)
        if mesh is not None:
            return [("plain", ("--mesh", mesh, "--compute", "jnp"))] + (
                [("compute_fn", ("--mesh", mesh, "--compute", "pallas"))]
                if has_fn else [])
        out = [("plain", ("--compute", "jnp"))]
        if len(grid) == 3:
            if rawstep.raw_step_supported(st):
                out.append(("raw", ("--compute", "pallas")))
            out += [(f"fuse{k}", ("--fuse", str(k))) for k in KS_3D
                    if fused.make_fused_step(st, grid, k) is not None]
            out += [(f"stream{k}", ("--fuse", str(k), "--fuse-kind",
                                    "stream")) for k in KS_3D
                    if streamfused.make_stream_fused_step(st, grid, k)
                    is not None]
            if has_fn:
                out += [("plain_periodic", ("--compute", "jnp",
                                            "--periodic")),
                        ("compute_fn_periodic", ("--compute", "pallas",
                                                 "--periodic"))]
        else:
            if has_fn:
                out.append(("compute_fn", ("--compute", "pallas")))
            out += [(f"fuse{k}", ("--fuse", str(k))) for k in KS_2D
                    if steps % k == 0
                    and fullgrid.make_fullgrid_step(st, grid, k) is not None]
        return out

    def argv(self, name, grid, dtype, steps, flags):
        a = ["--stencil", name, "--grid", ",".join(map(str, grid)),
             "--iters", str(steps), "--device", self.device, *flags]
        if dtype is not None:
            a += ["--dtype", dtype]
        return a

    def time(self, name, grid, dtype, steps, label, flags):
        """One candidate: build, a warm-up chunk, ``REPEATS`` timed ones."""
        torch = self.torch
        from mpi_cuda_process_tpu_torch import cli, driver

        row = {"family": name, "grid": list(grid), "dtype": dtype or "int32",
               "candidate": label, "flags": list(flags), "steps": steps}
        try:
            cfg = cli.config_from_args(self.argv(name, grid, dtype, steps,
                                                 flags))
            st, step_fn, fields, _ = cli.build(cfg)
            runner = driver.make_runner(step_fn, steps // max(1, cfg.fuse))
            fields = runner(fields)  # warm-up chunk, outside the clock
            self._sync()
            ev, host, mallocs = [], [], []
            for _ in range(REPEATS):
                m0 = self._mallocs()
                if not self.rehearse:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                t0 = time.perf_counter()
                fields = runner(fields)
                if not self.rehearse:
                    e1.record()
                self._sync()
                t1 = time.perf_counter()
                mallocs.append(self._mallocs() - m0)
                if not self.rehearse:
                    ev.append(e0.elapsed_time(e1) / steps)
                    host.append(1e3 * (t1 - t0) / steps)
            row["finite"] = all(driver.all_finite(f) for f in fields
                                if f.dtype.is_floating_point)
            row["cuda_mallocs"] = mallocs
            if ev:
                row.update(ms=statistics.median(ev), ms_min=min(ev),
                           ms_max=max(ev),
                           host_ms=statistics.median(host),
                           host_ms_min=min(host), host_ms_max=max(host))
            del fields, step_fn, runner
        except Exception as e:  # noqa: BLE001 — one failed candidate is
            # recorded and the call goes on; the exit code reports it
            row["error"] = f"{type(e).__name__}: {e}"[:400]
            self.failed.append(row)
        if not self.rehearse:
            torch.cuda.empty_cache()
        self.rows.append(row)
        self.emit(row)
        return row

    def group(self, name, grid, dtype, steps, mesh=None):
        from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

        if mesh is not None:
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
        try:
            for label, flags in self.candidates(name, grid, dtype, steps,
                                                mesh):
                self.time(name, grid, dtype, steps, label, flags)
        finally:
            os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)


def resources(libs):
    """One line a kernel of the built libraries (``{name: path}``): its
    registers, stack and local bytes a thread from ``cuobjdump
    -res-usage``, the name demangled by ``cu++filt``; then one line naming
    the kernels whose stack or local bytes are not 0."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin")
    rows = []
    for lib, path in sorted(libs.items()):
        text = subprocess.run(
            [os.path.join(cuda_bin, "cuobjdump"), "-res-usage", str(path)],
            capture_output=True, text=True, check=True).stdout
        fn = None
        for line in text.splitlines():
            m = re.match(r"\s*Function (\S+):", line)
            if m:
                fn = m.group(1)
            elif fn and "REG:" in line:
                vals = dict(re.findall(r"(\w+):(\d+)", line))
                rows.append({"library": lib, "kernel": fn,
                             **{k: int(vals.get(k, -1))
                                for k in ("REG", "STACK", "LOCAL")}})
                fn = None
    names = subprocess.run(
        [os.path.join(cuda_bin, "cu++filt")],
        input="\n".join(r["kernel"] for r in rows), capture_output=True,
        text=True, check=True).stdout.splitlines()
    for r, name in zip(rows, names):
        r["kernel"] = name
    spills = [f"{r['library']} {r['kernel']}: STACK {r['STACK']}, LOCAL "
              f"{r['LOCAL']}, REG {r['REG']}" for r in rows
              if r["STACK"] > 0 or r["LOCAL"] > 0]
    return rows + [{"kernels": len(rows), "with_stack_or_local": spills}]


def dtypes_of(name):
    return (None,) if name == "life" else DTYPES


def verdicts(rows):
    """Per (family, dtype, placement): the fastest candidate at each size,
    and which table entries the data support (a path that won at every
    measured size)."""
    out = []
    keys = []
    for r in rows:
        place = "sharded" if any(f == "--mesh" for f in r["flags"]) \
            else "unsharded"
        key = (r["family"], r["dtype"], place)
        if key not in keys:
            keys.append(key)
    for fam, dt, place in keys:
        by_size = {}
        for r in rows:
            rplace = "sharded" if "--mesh" in r["flags"] else "unsharded"
            if (r["family"], r["dtype"], rplace) != (fam, dt, place) or \
                    "ms" not in r:
                continue
            by_size.setdefault(tuple(r["grid"]), {})[r["candidate"]] = \
                r["ms"]
        if not by_size:
            continue
        sizes = sorted(by_size, key=lambda g: g[0])
        fastest = {"x".join(map(str, g)): min(
            (c for c in by_size[g] if not c.endswith("periodic")),
            key=by_size[g].get) for g in sizes}
        v = {"verdict": fam, "dtype": dt, "placement": place,
             "fastest": fastest}

        def wins(a, b):
            return all(a in by_size[g] and b in by_size[g]
                       and by_size[g][a] < by_size[g][b] for g in sizes)

        v["raw_wins"] = wins("raw", "plain")
        v["raw_wins_at"] = ["x".join(map(str, g)) for g in sizes
                            if "raw" in by_size[g]
                            and by_size[g]["raw"] < by_size[g]["plain"]]
        v["compute_fn_wins"] = (wins("compute_fn", "plain") or
                                wins("compute_fn_periodic", "plain_periodic"))
        everywhere = [c for c in by_size[sizes[0]]
                      if all(c in by_size[g] for g in sizes)]
        k_paths = [c for c in everywhere
                   if c.startswith(("fuse", "stream"))]
        others = [c for c in everywhere if c not in k_paths
                  and not c.endswith("periodic")]
        beat = [c for c in k_paths
                if all(wins(c, o) for o in others)]
        v["fastest_everywhere"] = next(
            (c for c in everywhere if all(fastest["x".join(map(str, g))]
                                          == c for g in sizes)), None)
        # the k-step paths that beat every one-step path at every size,
        # best first (by their worst ratio to the size's fastest)
        v["k_paths_winning_everywhere"] = sorted(
            beat, key=lambda c: max(by_size[g][c] / min(by_size[g].values())
                                    for g in sizes))
        out.append(v)
    return out


def markdown(rows):
    """One line per (family, dtype, placement): each candidate's median
    ms/step at each size, smallest size first."""
    lines = []
    seen = {}
    for r in rows:
        place = "sharded" if "--mesh" in r["flags"] else "unsharded"
        key = (r["family"], r["dtype"], place)
        ms = (f"{r['ms']:.4g}" if "ms" in r
              else "err" if "error" in r else "-")
        seen.setdefault(key, {}).setdefault(r["candidate"], []).append(
            ("x".join(map(str, r["grid"][:1])), ms))
    for (fam, dt, place), cands in seen.items():
        cells = "; ".join(f"{c} " + " / ".join(ms for _, ms in v)
                          for c, v in cands.items())
        sizes = " / ".join(s for s, _ in next(iter(cands.values())))
        lines.append(f"| {fam} {dt} {place} ({sizes}) | {cells} |")
    return "\n".join(lines)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="",
                   help="comma-separated families (default: all)")
    p.add_argument("--out", default=os.path.join("build",
                                                 "dispatch_times.json"))
    p.add_argument("--sizes", default="",
                   help="comma-separated first grid extents to time "
                        "(default: all)")
    p.add_argument("--tree", default="",
                   help="time the port of this unpacked tree instead")
    p.add_argument("--resources", action="store_true",
                   help="print the built kernels' registers, stack and "
                        "local bytes instead of timing")
    p.add_argument("--rehearse", action="store_true",
                   help="run every candidate on the CPU at tiny sizes "
                        "(plain versions of the kernels; no time kept)")
    args = p.parse_args()
    if args.rehearse and args.resources:
        raise SystemExit("torch_dispatch_times: --resources needs the "
                         "CUDA toolkit")
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    import mpi_cuda_process_tpu_torch as port

    if not args.rehearse and not torch.cuda.is_available():
        raise SystemExit("torch_dispatch_times: needs a CUDA card")
    only = set(filter(None, args.only.split(",")))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    smi = "rehearsal on the CPU" if args.rehearse else nvidia_smi()
    with open(args.out, "w") as out:
        t = Timer(args.rehearse, out)
        if not args.rehearse:
            from mpi_cuda_process_tpu_torch.ops.cuda import _build

            t0 = time.perf_counter()
            _build.build_all()
            t.emit({"build_seconds": round(time.perf_counter() - t0, 1),
                    "card": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "package": os.path.dirname(port.__file__)})
        if args.resources:
            for line in resources(_build.build_all()):
                t.emit(line)
            print(smi, flush=True)
            return 0
        sizes = set(filter(None, args.sizes.split(",")))
        sizes3 = REHEARSAL_3D if args.rehearse else SIZES_3D
        sizes2 = REHEARSAL_2D if args.rehearse else SIZES_2D
        groups = []
        # BASELINE config 2 (heat3d 256^3) and config 1 (heat2d/mdf 512^2,
        # 1000 steps) first: the sizes its commands run
        for fam in ("heat3d",):
            groups += [(fam, sizes3[0][0], d, sizes3[0][1], None)
                       for d in dtypes_of(fam)]
        for fam in ("heat2d", "mdf"):
            groups += [(fam, sizes2[0][0], d, sizes2[0][1], None)
                       for d in dtypes_of(fam)]
        for fam in FAMILIES_3D:
            for grid, steps in sizes3:
                groups += [(fam, grid, d, steps, None) for d in dtypes_of(fam)
                           if (fam, grid, d, steps, None) not in groups]
        for fam in FAMILIES_2D:
            for grid, steps in sizes2:
                groups += [(fam, grid, d, steps, None) for d in dtypes_of(fam)
                           if (fam, grid, d, steps, None) not in groups]
        s3 = ((16, 16, 32), "2,2", 8) if args.rehearse else SHARDED_3D
        s2 = ((32, 64), "4", 16) if args.rehearse else SHARDED_2D
        for fams, (grid, mesh, steps) in ((FAMILIES_3D, s3),
                                          (FAMILIES_2D, s2)):
            groups += [(fam, grid, d, steps, mesh) for fam in fams
                       for d in dtypes_of(fam)]
        for fam, grid, d, steps, mesh in groups:
            if (not only or fam in only) and (
                    not sizes or str(grid[0]) in sizes):
                t.group(fam, grid, d, steps, mesh)
        first = next((r for r in t.rows if "error" not in r), None)
        if first is not None:
            again = t.time(first["family"], tuple(first["grid"]),
                           None if first["dtype"] == "int32"
                           else first["dtype"], first["steps"],
                           first["candidate"], tuple(first["flags"]))
            t.rows.pop()  # the reread is not a candidate of its own
            t.emit({"reread": first["candidate"], "family": first["family"],
                    "grid": first["grid"], "dtype": first["dtype"],
                    "first_ms": first.get("ms"), "again_ms": again.get("ms")})
        for v in verdicts(t.rows):
            t.emit(v)
        md = markdown(t.rows)
        print(md, flush=True)
        out.write(md + "\n")
        t.emit({"failed": [f"{r['family']} {r['dtype']} {r['grid']} "
                           f"{r['candidate']}: {r['error']}"
                           for r in t.failed], "card": smi})
    print(smi, flush=True)
    return 1 if t.failed else 0


if __name__ == "__main__":
    sys.exit(main())
