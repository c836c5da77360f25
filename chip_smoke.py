#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as one JSON line:

  1. device: a CUDA card is required (exit 1 without one); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernels from
     mpi_cuda_process_tpu_torch/ops/cuda/csrc with nvcc (sm_90a), all
     sources in parallel;
  3. kernels: every kernel against its plain PyTorch version on the card,
     on random inputs.  K1 raw_step_heat (7/27/13-point), K2 raw_step_wave,
     K3 fused_step, K4 zchunk_heat and K5 zchunk_wave at an aligned
     (128, 128, 256), a ragged (66, 70, 130) and the main path's 512^3 grid;
     K3's sharded mode and K6 fused_zslab against k plain sharded steps on
     2x2 and 4x1 meshes of virtual shards at (128, 128, 256) and
     (68, 70, 130), guard-frame and periodic.  Tolerances: raw step
     atol = 32 eps max(|ref|, 1); compute_fn kernels rtol = atol = 1e-6;
     fused k-step atol = 1e-4, rtol = 0; guard-frame cells exactly equal;
  4. main path, unsharded: ``cli.main()`` at 512^3 float32 — heat3d and
     wave3d for 100 iterations, heat3d27 and heat3d4th for 40, each with
     --compute jnp, --compute pallas and --fuse K (K = 4; 2 for heat3d4th),
     each kernel path held against its jnp run; a checkpoint round trip
     (--checkpoint-every 50, --resume to 100) bit for bit;
  5. main path, sharded (MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=4: four
     shards on the one card — decomposition overhead, not scaling):
     ``cli.run()`` at 1024^3 float32, --init pulse, 100 iterations, heat3d
     and wave3d, each --mesh 2,2 with --compute jnp, --compute pallas (K4 /
     K5), --fuse 4 (K3 sharded) and --mesh 4 --fuse 4 --fuse-kind padfree
     (K6), heat3d also --compute pallas --overlap; heat3d27 and heat3d4th
     at 512^3 --mesh 2,2 for 20 iterations with --compute pallas and --fuse
     (4 / 2).  Every sharded field is held against the unsharded run of the
     same mode and the unsharded plain run; overlap must equal non-overlap
     bit for bit.  Then a sharded checkpoint round trip at 512^3 --mesh 2,2
     through ``cli.main()`` (--checkpoint-every 50, --resume to 100), bit
     for bit;
  6. timing: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call (F.conv3d with TF32 off), by
     CUDA events at the main path's shapes, beside the bound from bytes and
     flops; and the split of one sharded step at 1024^3 on 2x2 into
     exchange/pad, kernel and re-pin.

Every launch counter is set to 0 just before each main-path run and read
just after.  The line before the last lists the kernels as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: exit code 1,
no result line.  Scratch (checkpoints) goes to build/chip_smoke/ and is
removed.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "mpi_cuda_process_tpu_torch"
MAIN = (512, 512, 512)
BIG = (1024, 1024, 1024)
ITERS = 100
# (stencil, iterations, fuse k) of the unsharded main path at MAIN: heat3d
# and wave3d at full depth, the other two tap sets cut to 40 iterations.
MAIN_RUNS = (("heat3d", ITERS, 4), ("wave3d", ITERS, 4),
             ("heat3d27", 40, 4), ("heat3d4th", 40, 2))
# (stencil, grid, iterations, fuse k, overlap) of the sharded main path.
MESH_RUNS = (("heat3d", BIG, ITERS, 4, True), ("wave3d", BIG, ITERS, 4, False),
             ("heat3d27", MAIN, 20, 4, False),
             ("heat3d4th", MAIN, 20, 2, False))
EPS32 = 2.0 ** -23
FLOPS_PER_CELL = {"heat3d": 10, "heat3d27": 55, "heat3d4th": 27,
                  "wave3d": 12}
TPU = "mpi_cuda_process_tpu/ops/pallas/"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    """(bytes/s, float32 flop/s) peaks of the card (data sheets)."""
    if "H200" in name:
        return 4.8e12, 67e12
    if "PCIe" in name:
        return 2.0e12, 51e12
    return 3.35e12, 67e12  # H100 SXM


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "ops", "cuda", "csrc")):
        fail(f"run from a checkout: {PKG}/ops/cuda/csrc is not beside "
             "chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from mpi_cuda_process_tpu_torch import cli, driver, make_stencil
    from mpi_cuda_process_tpu_torch.interop import fields_from_numpy
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fused, kernels,
                                                     rawstep)
    from mpi_cuda_process_tpu_torch.parallel import halo, mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.utils import checkpointing

    counters = (rawstep.launches, fused.launches, kernels.launches)
    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    bw, flops32 = card_rates(smi)
    emit({"phase": "device", "ok": True, "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
             for n, log in _build.build_log.items()}
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(_build.build_seconds, 3), "ptxas": ptxas})

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    errs = {}  # kernel entry -> max |kernel - plain| over every comparison

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def frame_of(shape, halo_w):
        return driver.frame_mask(shape, shape, (0, 0, 0), halo_w, dev)

    def compare(entry, got, ref, atol, frame, rtol=0.0):
        worst = 0.0
        for g, r in zip(got, ref):
            d = (g - r).abs()
            err = float(d.max())
            bad = float((d - atol - rtol * r.abs()).max())
            if not math.isfinite(err) or bad > 0:
                fail(f"{entry}: max|d| {err:.3e} > atol {atol:.3e} "
                     f"rtol {rtol:.1e}")
            if frame is not None and not torch.equal(g[frame], r[frame]):
                fail(f"{entry}: frame cells differ")
            worst = max(worst, err)
        errs[entry] = max(errs.get(entry, 0.0), worst)
        return worst

    def virtual_mesh(shape):
        return mesh_lib.make_mesh(shape, [dev] * 4)

    cases = []
    for shape in ((128, 128, 256), (66, 70, 130)):
        for name in ("heat3d", "heat3d27", "heat3d4th", "wave3d"):
            cases.append(("raw", name, shape, 1, False, None))
            cases.append(("zchunk", name, shape, 1, False, None))
        for name, k in (("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                        ("heat3d4th", 4), ("wave3d", 4)):
            for periodic in (False, True):
                cases.append(("fused", name, shape, k, periodic, None))
    for name, k in (("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                    ("wave3d", 4)):
        cases += [("raw", name, MAIN, 1, False, None),
                  ("zchunk", name, MAIN, 1, False, None),
                  ("fused", name, MAIN, k, False, None)]
        for shape in ((128, 128, 256), (68, 70, 130)):
            for periodic in (False, True):
                cases += [("sharded", name, shape, k, periodic, (2, 2)),
                          ("sharded", name, shape, k, periodic, (4, 1)),
                          ("zslab", name, shape, k, periodic, (4,))]
    checked = []
    for path, name, shape, k, periodic, mshape in cases:
        st = make_stencil(name)
        rtol = 0.0
        frame = None if periodic else frame_of(shape, st.halo)
        if path == "zchunk":
            h = st.halo
            p = rand(tuple(s + 2 * h for s in shape))
            ins = (p,) + ((rand(shape),) if st.num_fields == 2 else ())
            ref = st.update(ins)[:1]
            got = kernels.make_pallas_compute(st, device=dev)(ins)[:1]
            entry = ("zchunk_wave" if name == "wave3d"
                     else f"zchunk_heat<{name}>")
            atol = rtol = 1e-6
            frame = None
            if name == "wave3d" and kernels.make_pallas_compute(st)(
                    ins)[1] is not ins[1]:
                fail("zchunk_wave: the second output is not u_prev")
        elif path in ("sharded", "zslab"):
            mesh = virtual_mesh(mshape)
            fields = stepper.shard_fields(
                tuple(rand(shape) for _ in range(st.num_fields)), mesh, 3)
            plain = stepper.make_sharded_step(st, mesh, shape,
                                              periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            step = stepper.make_sharded_fused_step(
                st, mesh, shape, k, periodic=periodic,
                kind="padfree" if path == "zslab" else None, device=dev)
            got = stepper.gather_fields(step(fields))
            ref = stepper.gather_fields(ref)
            entry = (f"fused_zslab<{name}>" if path == "zslab"
                     else f"fused_step_padded<{name}>")
            atol = 1e-4
            del fields
        else:
            fields = tuple(rand(shape) for _ in range(st.num_fields))
            plain = driver.make_step(st, shape, periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            if path == "raw":
                got = rawstep.make_raw_step(st, shape, device=dev)(fields)
                entry = ("raw_step_wave" if name == "wave3d"
                         else f"raw_step_heat<{name}>")
                scale = max(float(ref[0].abs().max()), 1.0)
                atol = 32 * EPS32 * scale
                if name == "wave3d" and got[1] is not fields[0]:
                    fail("raw_step_wave: the new u_prev is not the old u")
            else:
                got = fused.make_fused_step(st, shape, k, periodic=periodic,
                                            device=dev)(fields)
                entry = f"fused_step<{name}>"
                atol = 1e-4
            del fields
        torch.cuda.synchronize()
        err = compare(entry, got, ref, atol, frame, rtol)
        checked.append({"kernel": entry, "shape": list(shape), "k": k,
                        "periodic": periodic, "mesh": mshape,
                        "max_abs_err": err, "atol": atol, "rtol": rtol})
        del ref, got
    for c in counters:
        c.clear()
    emit({"phase": "kernels", "ok": True, "checked": len(checked),
          "max_abs_err": errs, "cases": checked})
    torch.cuda.empty_cache()

    # ---- 4. unsharded main path through cli.main() -------------------------
    scratch = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    lines = []
    main_launches = {}  # counter key -> launches over every main-path run

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logging.getLogger(PKG).addHandler(Capture())
    runs = {}

    def counted(fn):
        """Run ``fn`` with every launch counter set to 0 just before and
        read just after; returns (result, launches of this run)."""
        for c in counters:
            c.clear()
        out = fn()
        got = {}
        for c in counters:
            got.update(c)
        for key, n in got.items():
            main_launches[key] = main_launches.get(key, 0) + n
        return out, got

    def drive(label, stencil, *flags, iters=ITERS, ckpt_every=ITERS,
              grid=MAIN):
        d = os.path.join(scratch, label)
        lines.clear()
        rc, got = counted(lambda: cli.main(
            ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
             "--iters", str(iters), "--checkpoint-every", str(ckpt_every),
             "--checkpoint-dir", d, *flags]))
        if rc != 0:
            fail(f"{label}: cli.main returned {rc}")
        m = [re.search(r"(\d+) steps on \S+ grid in ([\d.]+)s\s+\(([\d.]+) "
                       r"Mcells/s\)", ln) for ln in lines]
        m = [x for x in m if x]
        if not m:
            fail(f"{label}: no Mcells/s line logged")
        steps, secs, mcells = int(m[-1][1]), float(m[-1][2]), float(m[-1][3])
        arrays, step, _ = checkpointing.load_any(d)
        fields = fields_from_numpy(arrays, device=dev)
        for f in fields:
            if tuple(f.shape) != tuple(grid) or \
                    not bool(torch.isfinite(f).all()):
                fail(f"{label}: final field not finite / wrong shape")
        runs[label] = {"fields": fields, "step": step}
        return {"label": label, "steps": steps, "seconds": secs,
                "mcells_per_s": mcells, "ms_per_step": 1e3 * secs / steps,
                "launches": got}

    results = []
    for stencil, iters, k in MAIN_RUNS:
        for mode in (("--compute", "jnp"), ("--compute", "pallas"),
                     ("--fuse", str(k))):
            res = drive(f"{stencil}_{mode[1]}", stencil, *mode, iters=iters,
                        ckpt_every=iters)
            raw_key = ("raw_step_wave" if stencil == "wave3d"
                       else "raw_step_heat") + f"[{stencil}]"
            want = {"jnp": {}, "pallas": {raw_key: iters}}.get(
                mode[1], {f"fused_step[{stencil}]": iters // k})
            if res["launches"] != want:
                fail(f"{res['label']}: launches {res['launches']} != {want}")
            results.append(res)

    for stencil, iters, k in MAIN_RUNS:
        halo_w = make_stencil(stencil).halo
        ref = runs[f"{stencil}_jnp"]["fields"]
        frame = frame_of(MAIN, halo_w)
        scale = max(float(ref[0].abs().max()), 1.0)
        for mode, atol in (("pallas", 32 * EPS32 * scale), (str(k), 1e-4)):
            got = runs[f"{stencil}_{mode}"]["fields"]
            err = 0.0
            for g, r in zip(got, ref):
                err = max(err, float((g - r).abs().max()))
                if not torch.equal(g[frame], r[frame]):
                    fail(f"{stencil} {mode}: frame cells differ from jnp")
            if err > atol:
                fail(f"{stencil} {mode}: max|d| vs jnp {err:.3e} > {atol:.3e}")
            for r in results:
                if r["label"] == f"{stencil}_{mode}":
                    r["max_abs_err_vs_jnp"] = err
                    r["atol"] = atol
        for mode in ("jnp", "pallas", str(k)):
            if f"{stencil}_{mode}" != "heat3d_pallas":  # kept for the resume
                del runs[f"{stencil}_{mode}"]["fields"]

    # checkpoint round trip: 50 steps + checkpoint, then resume to 100
    drive("ckpt_half", "heat3d", "--compute", "pallas", iters=ITERS // 2,
          ckpt_every=ITERS // 2)
    os.replace(os.path.join(scratch, "ckpt_half"),
               os.path.join(scratch, "ckpt_resumed"))
    resumed = drive("ckpt_resumed", "heat3d", "--compute", "pallas",
                    "--resume", ckpt_every=ITERS // 2)
    a, b = runs["ckpt_resumed"]["fields"], runs["heat3d_pallas"]["fields"]
    if resumed["steps"] != ITERS - ITERS // 2 or runs["ckpt_resumed"]["step"] != ITERS or \
            not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("checkpoint round trip does not match the uninterrupted run")
    runs.clear()
    emit({"phase": "main_path", "ok": True, "grid": list(MAIN),
          "iters": ITERS, "runs": results, "launches": dict(main_launches),
          "checkpoint_roundtrip": "bit-exact"})
    torch.cuda.empty_cache()

    # ---- 5. sharded main path ----------------------------------------------
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
    mesh_results = []

    def run_cli(stencil, grid, iters, *flags):
        argv = ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                "--iters", str(iters), "--init", "pulse", *flags]
        s0 = torch.cuda.memory_stats()
        (fields, mcells), got = counted(
            lambda: cli.run(cli.config_from_args(argv)))
        torch.cuda.synchronize()
        s1 = torch.cuda.memory_stats()
        cells = math.prod(grid)
        res = {"stencil": stencil, "grid": list(grid), "iters": iters,
               "flags": list(flags), "mcells_per_s": mcells,
               "ms_per_step": 1e3 * cells / (mcells * 1e6),
               "launches": got,
               # the caching allocator's cudaMalloc calls and free-and-retry
               # events over the run (0 and 0 once its pool is warm)
               "cuda_mallocs": s1["segment.all.allocated"]
               - s0["segment.all.allocated"],
               "alloc_retries": s1["num_alloc_retries"]
               - s0["num_alloc_retries"]}
        return fields, res

    def block_err(sharded, ref, frame_w, what):
        """max |d| of sharded fields against whole ones, frame exact."""
        err = 0.0
        for sf, r in zip(sharded, ref):
            local = tuple(sf[0].shape)
            for c, blk in zip(sf.mesh.coords(), sf):
                sl = stepper.block_slices(c, local)
                rb = r[sl]
                if not bool(torch.isfinite(blk).all()):
                    fail(f"{what}: non-finite values")
                err = max(err, float((blk - rb).abs().max()))
                if frame_w:
                    fm = driver.frame_mask(
                        local, sf.global_shape,
                        stepper.shard_offsets(c, local), frame_w, dev)
                    if not torch.equal(blk[fm], rb[fm]):
                        fail(f"{what}: frame cells differ")
        return err

    def check(res, err, atol, what):
        res.setdefault("max_abs_err", {})[what] = err
        if err > atol:
            fail(f"{res['stencil']} {res['flags']}: max|d| vs {what} "
                 f"{err:.3e} > {atol:.3e}")

    for stencil, grid, iters, k, with_overlap in MESH_RUNS:
        st = make_stencil(stencil)
        h = st.halo
        raw_key = ("raw_step_wave" if stencil == "wave3d"
                   else "raw_step_heat") + f"[{stencil}]"
        zkey = ("zchunk_wave" if stencil == "wave3d"
                else "zchunk_heat") + f"[{stencil}]"
        big = grid == BIG
        ref_plain, r = run_cli(stencil, grid, iters, "--compute", "jnp")
        mesh_results.append(r)
        scale = max(float(ref_plain[0].abs().max()), 1.0)
        ref_pallas, r = run_cli(stencil, grid, iters, "--compute", "pallas")
        if r["launches"] != {raw_key: iters}:
            fail(f"{stencil} unsharded pallas: launches {r['launches']}")
        check(r, max(float((x - y).abs().max())
                     for x, y in zip(ref_pallas, ref_plain)),
              32 * EPS32 * scale, "unsharded plain")
        mesh_results.append(r)
        ref_fused, r = run_cli(stencil, grid, iters, "--fuse", str(k))
        if r["launches"] != {f"fused_step[{stencil}]": iters // k}:
            fail(f"{stencil} unsharded fuse: launches {r['launches']}")
        check(r, max(float((x - y).abs().max())
                     for x, y in zip(ref_fused, ref_plain)),
              1e-4, "unsharded plain")
        mesh_results.append(r)
        modes = [("jnp", ("--mesh", "2,2", "--compute", "jnp"), {}),
                 ("pallas", ("--mesh", "2,2", "--compute", "pallas"),
                  {zkey: 4 * iters})]
        if with_overlap:
            modes.append(("overlap", ("--mesh", "2,2", "--compute", "pallas",
                                      "--overlap"),
                          {zkey: 4 * iters + 16 * iters}))
        modes.append(("fuse", ("--mesh", "2,2", "--fuse", str(k)),
                      {f"fused_step_padded[{stencil}]": 4 * iters // k}))
        if big:
            modes.append(("padfree", ("--mesh", "4", "--fuse", str(k),
                                      "--fuse-kind", "padfree"),
                          {f"fused_zslab[{stencil}]": 4 * iters // k}))
        kept = None
        for label, flags, want in modes:
            got, r = run_cli(stencil, grid, iters, *flags)
            if r["launches"] != want:
                fail(f"{stencil} {label}: launches {r['launches']} != {want}")
            if label in ("fuse", "padfree"):
                atol, same = 1e-4, ref_fused
            elif label == "jnp":
                atol, same = 32 * EPS32 * scale, ref_plain
            else:
                atol, same = 1e-6 + 1e-6 * scale, ref_pallas
            check(r, block_err(got, same, h, f"{stencil} {label}"), atol,
                  "unsharded same mode")
            check(r, block_err(got, ref_plain, h, f"{stencil} {label}"),
                  max(atol, 32 * EPS32 * scale), "unsharded plain")
            if label == "pallas" and with_overlap:
                kept = got
            elif label == "overlap":
                if not all(torch.equal(x, y) for a, b in zip(got, kept)
                           for x, y in zip(a, b)):
                    fail(f"{stencil}: --overlap differs from non-overlap")
                r["bit_equal_to_non_overlap"] = True
                kept = None
            mesh_results.append(r)
            del got
            torch.cuda.empty_cache()
        del ref_plain, ref_pallas, ref_fused
        torch.cuda.empty_cache()

    # sharded checkpoint round trip at 512^3 on 2x2 through cli.main()
    grid2 = ("--mesh", "2,2", "--compute", "pallas")
    drive("mesh_full", "heat3d", *grid2, "--init", "pulse")
    drive("mesh_half", "heat3d", *grid2, "--init", "pulse", iters=ITERS // 2,
          ckpt_every=ITERS // 2)
    os.replace(os.path.join(scratch, "mesh_half"),
               os.path.join(scratch, "mesh_resumed"))
    resumed = drive("mesh_resumed", "heat3d", *grid2, "--init", "pulse",
                    "--resume", ckpt_every=ITERS // 2)
    a, b = runs["mesh_resumed"]["fields"], runs["mesh_full"]["fields"]
    if resumed["steps"] != ITERS - ITERS // 2 or runs["mesh_resumed"]["step"] != ITERS or \
            not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("sharded checkpoint round trip does not match the "
             "uninterrupted run")
    shutil.rmtree(scratch, ignore_errors=True)
    runs.clear()
    emit({"phase": "sharded_main_path", "ok": True,
          "note": "4 shards on 1 card: decomposition overhead, not scaling",
          "runs": mesh_results, "checkpoint_roundtrip": "bit-exact",
          "launches": dict(main_launches)})
    torch.cuda.empty_cache()

    # ---- 6. timing at the main path's shapes --------------------------------
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

    def bound(n_bytes, n_flops):
        b, f = n_bytes / bw * 1e3, n_flops / flops32 * 1e3
        return (b, "bytes") if b >= f else (f, "operations")

    def stencil_weight(name, st):
        """(weight, pad): the update as one convolution's weight."""
        from mpi_cuda_process_tpu_torch.ops import heat

        if name == "heat3d4th":
            a = st.params["alpha"]
            w = torch.zeros(1, 1, 5, 5, 5)
            for d in range(3):
                for s in (-2, -1, 1, 2):
                    off = [2, 2, 2]
                    off[d] += s
                    w[(0, 0) + tuple(off)] = a * heat.W4TH[abs(s)]
            w[0, 0, 2, 2, 2] = 1 + a * heat.w4th_center(3)
            return w.to(dev), 2
        faces = ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                 (1, 1, 2))
        if name == "wave3d":
            c = st.params["c2dt2"]
            w = torch.zeros(1, 2, 3, 3, 3)
            w[0, 0, 1, 1, 1] = 2 - 6 * c
            for off in faces:
                w[(0, 0) + off] = c
            w[0, 1, 1, 1, 1] = -1
            return w.to(dev), 1
        if name == "heat3d":
            a = st.params["alpha"]
            w = torch.zeros(1, 1, 3, 3, 3)
            for off in faces:
                w[(0, 0) + off] = a
            w[0, 0, 1, 1, 1] = 1 - 6 * a
            return w.to(dev), 1
        a = st.params["alpha"]  # heat3d27: faces / edges / corners
        w = torch.empty(1, 1, 3, 3, 3)
        for i in range(27):
            z, y, x_ = i // 9 - 1, i // 3 % 3 - 1, i % 3 - 1
            nz = (z != 0) + (y != 0) + (x_ != 0)
            w[0, 0, z + 1, y + 1, x_ + 1] = a * (
                heat.W27_CENTER, heat.W27_FACE, heat.W27_EDGE,
                heat.W27_CORNER)[nz]
        w[0, 0, 1, 1, 1] += 1
        return w.to(dev), 1

    def library_call(name, st, fields, shape):
        """One F.conv3d computing the one-step update on the interior
        (zero padding in place of the frame pin), checked against the plain
        step's interior, as a zero-argument callable."""
        w, pad = stencil_weight(name, st)
        x = torch.stack(fields).reshape(1, len(fields), *shape)

        def call():
            return F.conv3d(x, w, padding=pad)

        inner = (slice(st.halo, -st.halo),) * 3
        got = call()[0, 0][inner]
        ref = driver.make_step(st, shape)(fields)[0][inner]
        err = float((got - ref).abs().max())
        if not err <= 1e-4:
            fail(f"F.conv3d yardstick for {name} disagrees with the plain "
                 f"step: max|d| {err:.3e}")
        return call

    def padded_library_call(name, st, ins):
        """One F.conv3d with padding=0 on the padded block: the compute_fn's
        own function (wave3d: u_prev zero-padded as a second channel)."""
        w, _ = stencil_weight(name, st)
        p = ins[0]
        if name == "wave3d":
            x = torch.stack([p, F.pad(ins[1], (1,) * 6)])[None]
        else:
            x = p[None, None]

        def call():
            return F.conv3d(x, w, padding=0)

        err = float((call()[0, 0] - st.update(ins)[0]).abs().max())
        if not err <= 1e-4:
            fail(f"padded F.conv3d yardstick for {name} disagrees with the "
                 f"plain update: max|d| {err:.3e}")
        return call

    kernels_out = []

    # kernel wrapper -> (K number, row of PERF.md's table of TPU kernels)
    rows = {"raw_step_heat": ("K1", 1), "raw_step_wave": ("K2", 2),
            "fused_step": ("K3", 5), "fused_step_padded": ("K3", 5),
            "zchunk_heat": ("K4", 12), "zchunk_wave": ("K5", 13),
            "fused_zslab": ("K6", 8)}

    def record(entry, wrapper, name, src, replaces, ms, plain_ms, moved,
               flops, library_ms, k, shape, per_step):
        b_ms, b_by = bound(moved, flops)
        kernels_out.append({
            "name": entry, "kernel": rows[wrapper][0],
            "table_row": rows[wrapper][1], "route": "cuda",
            "source": f"{PKG}/ops/cuda/csrc/{src}", "replaces": replaces,
            "launches": main_launches.get(f"{wrapper}[{name}]", 0),
            "max_abs_err": errs[entry], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "steps_per_launch": k, "shape": list(shape),
            "launches_per_step": per_step})

    cells = math.prod(MAIN)
    nbytes = 4 * cells
    for entry, wrapper, name, k, replaces in (
            ("raw_step_heat<heat3d>", "raw_step_heat", "heat3d", 1,
             "rawstep.py:164"),
            ("raw_step_heat<heat3d27>", "raw_step_heat", "heat3d27", 1,
             "rawstep.py:164"),
            ("raw_step_heat<heat3d4th>", "raw_step_heat", "heat3d4th", 1,
             "rawstep.py:164"),
            ("raw_step_wave", "raw_step_wave", "wave3d", 1, "rawstep.py:172"),
            ("fused_step<heat3d>", "fused_step", "heat3d", 4,
             "fused.py:280"),
            ("fused_step<heat3d27>", "fused_step", "heat3d27", 4,
             "fused.py:280"),
            ("fused_step<heat3d4th>", "fused_step", "heat3d4th", 2,
             "fused.py:280"),
            ("fused_step<wave3d>", "fused_step", "wave3d", 4,
             "fused.py:280")):
        st = make_stencil(name)
        fields = tuple(rand(MAIN) for _ in range(st.num_fields))
        if wrapper == "fused_step":
            kern = fused.make_fused_step(st, MAIN, k, device=dev)
            src = "fused.cu"
            moved = 2 * st.num_fields * nbytes
        else:
            kern = rawstep.make_raw_step(st, MAIN, device=dev)
            src = "rawstep.cu"
            moved = (st.num_fields + 1) * nbytes
        plain = driver.make_step(st, MAIN)

        def run_plain(fields=fields, plain=plain, k=k):
            fs = fields
            for _ in range(k):
                fs = plain(fs)
            return fs

        ms = time_ms(lambda: kern(fields), 20)
        plain_ms = time_ms(run_plain, 3)
        library_ms = None
        if wrapper != "fused_step":
            library_ms = time_ms(library_call(name, st, fields, MAIN), 20)
        record(entry, wrapper, name, src, TPU + replaces, ms, plain_ms, moved,
               FLOPS_PER_CELL[name] * k * cells, library_ms, k, MAIN,
               1.0 / k)
        del fields

    # the sharded kernels, one shard of the sharded main path's run
    split = []
    for name, grid, _iters, k, _ov in MESH_RUNS:
        st = make_stencil(name)
        h = st.halo
        nf = st.num_fields
        mesh = virtual_mesh((2, 2))
        local = (grid[0] // 2, grid[1] // 2, grid[2])
        lcells = math.prod(local)
        # K4 / K5 on one shard's padded block
        padded = tuple(s + 2 * h for s in local)
        ins = (rand(padded),) + ((rand(local),) if nf == 2 else ())
        comp = kernels.make_pallas_compute(st, device=dev)
        ms = time_ms(lambda: comp(ins), 20)
        plain_ms = time_ms(lambda: st.update(ins), 3)
        library_ms = time_ms(padded_library_call(name, st, ins), 10)
        moved = 4 * (math.prod(padded) + lcells * nf)
        entry = "zchunk_wave" if name == "wave3d" else f"zchunk_heat<{name}>"
        wrapper = "zchunk_wave" if name == "wave3d" else "zchunk_heat"
        record(entry, wrapper, name, "zchunk.cu",
               TPU + ("kernels.py:138" if name == "wave3d"
                      else "kernels.py:133"),
               ms, plain_ms, moved, FLOPS_PER_CELL[name] * lcells,
               library_ms, 1, local, 4.0)
        del ins
        # K3 sharded mode on one shard's z/y-padded block
        m = k * h
        pshape = (local[0] + 2 * m, local[1] + 2 * m, local[2])
        ins = tuple(rand(pshape) for _ in range(nf))
        kern = lambda: fused.fused_step_padded(ins, st, k, grid, (0, 0))
        plain = lambda: fused._plain_window_steps(
            ins, st, k, (-m, -m, 0), grid, False, (2,))
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        record(f"fused_step_padded<{name}>", "fused_step_padded", name,
               "fused.cu", TPU + "fused.py:280", ms, plain_ms,
               4 * nf * (math.prod(pshape) + lcells),
               FLOPS_PER_CELL[name] * k * lcells, None, k, local, 4.0 / k)
        del ins
        if grid == BIG:
            # K6 on one z-only shard of --mesh 4
            zl = (grid[0] // 4, grid[1], grid[2])
            zcells = math.prod(zl)
            core = tuple(rand(zl) for _ in range(nf))
            lo = tuple(rand((m, zl[1], zl[2])) for _ in range(nf))
            hi = tuple(rand((m, zl[1], zl[2])) for _ in range(nf))
            kern = lambda: fused.fused_zslab(core, lo, hi, st, k, grid[0], 0)

            def plain(core=core, lo=lo, hi=hi):
                win = tuple(torch.cat(t) for t in zip(lo, core, hi))
                return fused._plain_window_steps(win, st, k, (-m, 0, 0),
                                                 grid, False, (1, 2))

            ms = time_ms(kern, 10)
            plain_ms = time_ms(plain, 2)
            record(f"fused_zslab<{name}>", "fused_zslab", name, "fused.cu",
                   TPU + "fused.py:432", ms, plain_ms,
                   4 * nf * (2 * zcells + 2 * m * zl[1] * zl[2]),
                   FLOPS_PER_CELL[name] * k * zcells, None, k, zl, 4.0 / k)
            del core, lo, hi
        if grid == BIG:
            # one sharded step on 2x2, split into exchange/pad, kernel and
            # re-pin by CUDA events (the pieces make_sharded_step runs)
            fields = stepper.shard_fields(
                tuple(rand(grid) for _ in range(nf)), mesh, 3)
            step = stepper.make_sharded_step(st, mesh, grid, compute_fn=comp)
            ex = lambda: [halo.exchange_and_pad(f, mesh, fh, bc)
                          for f, bc, fh in zip(fields, st.bc_value,
                                               st.field_halos)]
            pads = ex()
            new = [comp(tuple(p[i] for p in pads)) for i in range(4)]
            masks = [driver.frame_mask(
                local, grid, stepper.shard_offsets(c, local), h, dev)
                for c in mesh.coords()]
            row = {"stencil": name, "grid": list(grid), "mesh": [2, 2],
                   "exchange_pad_ms": time_ms(ex, 5),
                   "kernel_ms": time_ms(
                       lambda: [comp(tuple(p[i] for p in pads))
                                for i in range(4)], 5),
                   "repin_ms": time_ms(
                       lambda: [torch.where(masks[i], fields[0][i],
                                            new[i][0]) for i in range(4)],
                       5),
                   "step_ms": time_ms(lambda: step(fields), 5)}
            fstep = stepper.make_sharded_fused_step(st, mesh, grid, k,
                                                    device=dev)
            row["fused_exchange_pad_ms"] = time_ms(
                lambda: [halo.exchange_and_pad(f, mesh, k * h, bc,
                                               axes=(0, 1))
                         for f, bc in zip(fields, st.bc_value)], 3)
            row["fused_step_ms"] = time_ms(lambda: fstep(fields), 3)
            split.append(row)
            del fields, pads, new, masks
        torch.cuda.empty_cache()

    for kk in kernels_out:
        if kk["launches"] < 1:
            fail(f"{kk['name']} was not launched on the main path")
    emit({"phase": "timing", "ok": True, "card": smi,
          "bytes_per_s": bw, "flops32_per_s": flops32,
          "sharded_step_split": split,
          "note": "sharded figures: 4 shards on 1 card, decomposition "
                  "overhead, not scaling"})
    print(smi, flush=True)
    emit({"kernels": kernels_out})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
