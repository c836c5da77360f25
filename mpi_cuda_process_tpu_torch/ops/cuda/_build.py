"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/torch_kernels/`` at the repository root (git-ignored), and loaded
with ``ctypes``: pointers and the stream cross as ``c_void_p``.  All sources
compile in parallel, one ``nvcc`` each, started together.  A library's file
name carries a hash of its sources and flags, so an edited kernel is rebuilt
and an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module and never
build.  A failed or impossible build raises; there is no fallback.

``--compile-cache DIR`` points the library cache at DIR
(:func:`set_build_dir`): a later process with the same DIR finds every
library built and runs no ``nvcc``.  :data:`compiles` counts this
process's compiles by kind (an nvcc run a source, a step built by
``cli.build_step``, a runner by ``driver.make_runner``): the serving
layer's "a warm class compiles nothing" reads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("rawstep", "fused", "zchunk", "whole2d", "fullgrid",
           "streamfused", "remote")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiles of this process by kind: "nvcc", "build", "runner"
compiles: Counter = Counter()
_count_lock = threading.Lock()
# name -> nvcc's output (per-kernel registers, shared memory, spills)
build_log: Dict[str, str] = {}
build_seconds: float = 0.0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built at first use and need "
        "the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)")


def note_compile(kind: str, n: int = 1) -> None:
    """Count ``n`` compiles of ``kind`` (a read-modify-write under a lock:
    the serving engine's class threads build concurrently)."""
    with _count_lock:
        compiles[kind] += n


def set_build_dir(path) -> Path:
    """Point the library cache at ``path`` (``--compile-cache``) for every
    kernel this process loads from now on.  Libraries already loaded stay
    loaded (a loaded library cannot be swapped safely).  The libraries of
    these sources built in the previous directory are copied into
    ``path`` (the names carry the source hash, so they are the same
    libraries), so a later process with ``path`` runs no nvcc for them.
    Returns the resolved directory."""
    global BUILD_DIR
    new = Path(path).resolve()
    with _lock:
        if new == BUILD_DIR:
            return new
        new.mkdir(parents=True, exist_ok=True)
        for n in SOURCES:
            old = _lib_path(n)
            target = new / old.name
            if old.exists() and not target.exists():
                tmp = target.with_suffix(f".tmp{os.getpid()}")
                shutil.copy2(old, tmp)
                os.replace(tmp, target)
        BUILD_DIR = new
    return new


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source (in parallel); return name -> library."""
    global build_seconds
    paths = {n: _lib_path(n) for n in SOURCES}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    note_compile("nvcc", len(todo))
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        if name not in _libs:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            lib.kernels_error_string.argtypes = [ctypes.c_int]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (launch refused,
    invalid configuration, a fault reported by an earlier launch)."""
    if code != 0:
        msg = lib.kernels_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# Shared memory on Hopper: the dynamic shared memory one block may use
# (232,448 bytes), and what one SM holds for all its blocks (233,472).
SMEM_LIMIT = 227 * 1024
SMEM_PER_SM = 228 * 1024

_SMS: Dict[int, int] = {}  # device index -> streaming multiprocessors


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of CUDA ``device``, read once."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def fit_runs(extent: int, run: int, tiles: int, lead: int, slots: int,
             waves: int = 0) -> int:
    """The planes (rows) of one run of a persistent launch that marches
    ``extent`` planes in runs of at most ``run``, ``tiles`` tiles side by
    side: ``run``, or fewer where more runs fill the card's last wave of
    blocks (``slots``: the blocks it holds at once) for less than they add
    in lead-in (``lead`` planes a run reads before its first output).
    Tries up to 4 times the runs of ``run``, or enough runs for ``waves``
    waves if that is more, and minimises waves x (planes a run + lead)."""
    first = -(-extent // run)
    most = min(extent, max(4 * first, -(-waves * slots // tiles)))
    best = None
    for runs in range(first, most + 1):
        planes = -(-extent // runs)
        cost = -(-tiles * runs // slots) * (planes + lead)
        if best is None or cost < best[0]:
            best = (cost, planes)
    return best[1]


# The storage types of the float kernels (every kernel but Life's kinds of
# K7 and K8, which take int32), and the suffix of each type's C entry
# point: one source, an "_f32" and a "_bf16" export.
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def entry(lib: ctypes.CDLL, name: str, t):
    """The C entry point of kernel ``name`` for ``t``'s dtype
    (``name_f32`` or ``name_bf16``)."""
    return getattr(lib, f"{name}_{SUFFIXES[t.dtype]}")


def twin_entry(lib: ctypes.CDLL, name: str, t):
    """The C entry point of a kernel whose 4-byte kinds (float32, and Life's
    int32) share the export ``name`` and whose bfloat16 kind is its twin
    ``name_bf16`` (K7, K8)."""
    return getattr(lib, f"{name}_bf16" if t.dtype == torch.bfloat16
                   else name)


def launch_key(wrapper: str, name: str, t, members: int = 0) -> str:
    """A launch counter's key: ``"wrapper[name]"`` for float32 operands
    (Life: int32, its one type), ``"wrapper[name,bfloat16]"`` for another
    type, so a run's counts say which kind of the kernel ran; a batched
    launch (``members`` > 0, an ensemble's) ends in ``",ensemble"``:
    ``"wrapper[name,ensemble]"``, ``"wrapper[name,bfloat16,ensemble]"``."""
    tags = [name]
    if t.dtype not in (torch.float32, torch.int32):
        tags.append(str(t.dtype).replace("torch.", ""))
    if members:
        tags.append("ensemble")
    return f"{wrapper}[{','.join(tags)}]"


def batch_of(t, ndim: int = 3):
    """``(members, shape)`` of a kernel operand: 0 and its shape for an
    ``ndim``-dimensional tensor, N and the rest for a batched ``(N,
    ...)`` one (an ensemble run's member axis)."""
    if t.dim() == ndim + 1:
        return int(t.shape[0]), tuple(int(s) for s in t.shape[1:])
    return 0, tuple(int(s) for s in t.shape)


def check_operands(what: str, *tensors, shape=None, dtype=None,
                   ndim: int = 3, members: int = 0) -> None:
    """Device, dtype, shape and contiguity gate for the kernels: ``dtype``
    is the type every operand must have, or a tuple of the types a kernel
    takes (all operands of one type); float32 when None.  ``ndim``-
    dimensional operands, or with ``members`` N > 0 batched ``(N,
    *shape)`` ones."""
    if members:
        ndim += 1
        if shape is not None:
            shape = (members,) + tuple(shape)
    allowed = (torch.float32,) if dtype is None else \
        tuple(dtype) if isinstance(dtype, tuple) else (dtype,)
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: operands must share one CUDA device "
                             f"(got {t.device} and {dev})")
        if t.dtype not in allowed or t.dtype != tensors[0].dtype:
            names = "/".join(str(a).replace("torch.", "") for a in allowed)
            raise TypeError(f"{what}: {names} operands of one type only "
                            f"(got {t.dtype} beside {tensors[0].dtype})")
        if t.dim() != ndim or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{what}: expected a {ndim}D tensor of shape "
                             f"{shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    if dev.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{what}: operands on {dev}, but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
