#!/usr/bin/env python3
"""A short on-card check of K3, its shells, K6 and K9 in bfloat16, and of
K6 and K9's advect3d and grayscott3d kinds in float32, on one NVIDIA card.

    python3 scripts/torch_fused_bf16.py

Builds the kernels, then holds every instance against its plain version on
random inputs (max |d| must be 0): ``fused_step`` at (66, 70, 130) and
(128, 128, 256), guard-frame and periodic; ``fused_step_padded`` on a 2x2
shard's padded block at three origins; ``fused_zslab`` on a z-only shard at
three origins; ``fused_yzslab`` on a 2x2 shard at four origins; and the
sharded steps (padded and pad-free, with and without the overlap shells)
against k plain sharded steps on a 2x2 mesh of virtual shards.  Every
family at its bfloat16 k (8; heat3d4th and sor3d 4), and advect3d,
grayscott3d and heat3d in float32 at k = 4.  Then times ``fused_step`` at
512^3 by CUDA events.  Prints one JSON object of the comparisons, one JSON
line per timing, then the card's name and power limit; exits 1 if any
comparison is not 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = [("heat3d", 8, {}, "bfloat16"), ("heat3d27", 8, {}, "bfloat16"),
         ("heat3d4th", 4, {}, "bfloat16"), ("wave3d", 8, {}, "bfloat16"),
         ("advect3d", 8, {"cx": -0.3, "cy": 0.2, "cz": -0.25}, "bfloat16"),
         ("grayscott3d", 8, {}, "bfloat16"), ("sor3d", 4, {}, "bfloat16"),
         ("advect3d", 4, {"cx": -0.3, "cy": 0.2, "cz": -0.25}, "float32"),
         ("grayscott3d", 4, {}, "float32"), ("heat3d", 4, {}, "float32")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fused_bf16: needs a CUDA card")
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import _build, fused
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper

    t0 = time.perf_counter()
    _build.build_all()
    print(json.dumps({"build_seconds": round(time.perf_counter() - t0, 1)}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
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

    for name, k, kw, dtype in CASES:
        st = make_stencil(name, dtype=dtype, **kw)
        dt = st.dtype
        nf, m = st.num_fields, k_step_margin(st, k)
        tag = f"{name},{dtype}"
        for shape in ((66, 70, 130), (128, 128, 256)):
            for periodic in (False, True):
                f = tuple(rnd(shape, dt) for _ in range(nf))
                cmp(f"fused_step<{tag}>",
                    fused.fused_step(f, st, k, periodic),
                    fused.plain_steps(f, st, k, periodic))
        Z, Y, X = shape = (128, 128, 256)
        Lz, Ly = Z // 2, Y // 2

        def pieces(s):
            return tuple(rnd(s, dt) for _ in range(nf))

        for periodic in (False, True):
            p = pieces((Lz + 2 * m, Ly + 2 * m, X))
            for org in ((0, 0), (Lz, 0), (Lz, Ly)):
                cmp(f"fused_step_padded<{tag}>",
                    fused.fused_step_padded(p, st, k, shape, org, periodic),
                    fused.plain_step_padded(p, st, k, shape, org, periodic))
            core, lo, hi = pieces((Z // 4, Y, X)), pieces((m, Y, X)), \
                pieces((m, Y, X))
            for oz in (0, Z // 4, 3 * Z // 4):
                args = (core, lo, hi, st, k, Z, oz, periodic)
                cmp(f"fused_zslab<{tag}>", fused.fused_zslab(*args),
                    fused.plain_zslab(*args))
            yz = (pieces((Lz, Ly, X)), pieces((m, Ly, X)), pieces((m, Ly, X)),
                  pieces((Lz, m, X)), pieces((Lz, m, X)),
                  [pieces((m, m, X)) for _ in range(4)], st, k, shape)
            for org in ((0, 0), (Lz, 0), (0, Ly), (Lz, Ly)):
                cmp(f"fused_yzslab<{tag}>",
                    fused.fused_yzslab(*yz, org, periodic),
                    fused.plain_yzslab(*yz, org, periodic))
        mesh = mesh_lib.make_mesh((2, 2), [dev] * 4)
        fields = stepper.shard_fields(pieces(shape), mesh, 3)
        plain = stepper.make_sharded_step(st, mesh, shape)
        ref = fields
        for _ in range(k):
            ref = plain(ref)
        ref = stepper.gather_fields(ref)
        for kind in (None, "padfree"):
            for overlap in (False, True):
                step = stepper.make_sharded_fused_step(
                    st, mesh, shape, k, kind=kind, overlap=overlap,
                    device=dev)
                if step._overlap_active != overlap:
                    bad.append((f"{tag} {kind} overlap not taken", overlap))
                cmp(f"step<{tag},{kind or 'padded'},{overlap}>",
                    stepper.gather_fields(step(fields)), ref)
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

    for name, k, kw, dtype in CASES:
        st = make_stencil(name, dtype=dtype, **kw)
        f = tuple(rnd((512,) * 3, st.dtype) for _ in range(st.num_fields))
        ms = time_ms(lambda: fused.fused_step(f, st, k), 5)
        print(json.dumps({"kernel": f"fused_step<{name},{dtype}>", "k": k,
                          "shape": [512] * 3, "ms_per_pass": ms,
                          "ms_per_step": ms / k}))
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
