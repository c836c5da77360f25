"""Per-chunk runtime stats: first chunk vs steady state, recorded host-side.

The port's counterpart of the TPU package's ``obs/runtime.py``.
``driver.run_simulation`` calls :meth:`RuntimeRecorder.begin_chunk` and
:meth:`RuntimeRecorder.record_chunk` around each chunk (its ``observer``
hook), the chunk's wall time measured up to a device synchronize.
Everything here is host Python at those boundaries: the step's aten ops
and kernel launches are identical with a recorder attached or not.

What a chunk record carries:

* wall seconds and ms/step (in REAL steps: the recorder knows the
  ``--fuse`` step unit);
* a recompile flag.  The port compiles no step program per chunk; its
  counterpart of a backend compile is a **kernel library load**
  (``ops/cuda/_build.load``: the first use of a CUDA source in the
  process, which builds every stale source with nvcc first).  A load
  inside a chunk after chunk 0 means a kernel family was first used
  mid-run — seconds of nvcc or ``dlopen`` inside a timed chunk — and is
  marked instead of silently polluting the steady-state percentiles.
  The first launch of a new tile or slab configuration (a ring exchange
  site, a kernel's tile table entry) builds no library and is not
  counted;
* device-memory figures of the run's card, when the run is on one:
  ``bytes_in_use`` (``torch.cuda.memory_allocated``),
  ``peak_bytes_in_use`` (``torch.cuda.max_memory_allocated``, reset at
  each :meth:`begin_chunk`, so it is the chunk's own peak) and
  ``bytes_limit`` (the card's total memory).  A CPU run omits the field.

Before each reset the recorder folds the allocator's peak into
``peak_seen``, so the boundary work between chunks (checkpoints, health
checks, audits) counts toward the run's peak: :meth:`summary`'s
``memory_peak_bytes`` is the whole run's.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


def compile_events_seen() -> int:
    """Kernel libraries loaded in this process (the port's compiles)."""
    from ..ops.cuda import _build

    return len(_build._libs)


def compiles_seen() -> Dict[str, int]:
    """The port's compiles in this process, by kind: ``nvcc`` (a kernel
    source compiled), ``build`` (a step built, ``cli.build_step``: a CLI
    run's or a serving class's) and ``runner`` (a chunk runner,
    ``driver.make_runner``).  A warm serving class adds none."""
    from ..ops.cuda import _build

    return {k: int(_build.compiles.get(k, 0))
            for k in ("nvcc", "build", "runner")}


def device_memory_stats() -> Dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` of the
    current card, or {} on the CPU or when CUDA is not initialised."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        device = torch.cuda.current_device()
        return {
            "bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(device).total_memory),
        }
    except Exception:  # noqa: BLE001 — memory figures are best-effort
        return {}


def _reset_peak() -> None:
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.reset_peak_memory_stats(torch.cuda.current_device())
    except Exception:  # noqa: BLE001
        pass


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class RuntimeRecorder:
    """Collects per-chunk wall times; optionally mirrors them to a trace.

    ``step_unit`` converts the driver's call-unit chunk sizes into real
    steps (``--fuse K`` advances K steps per call).  ``last_progress``
    (monotonic seconds) is the liveness signal the heartbeat watches.
    ``cuda`` says whether the run's state is on a card (memory figures;
    a CPU run records none).

    ``profiler`` (a :class:`~.profile.ChunkProfiler`, optional) rides the
    same chunk boundaries, so a ``--profile`` run scopes its
    ``torch.profiler`` session to exactly one chunk.  ``anomaly`` (an
    :class:`~.anomaly.AnomalyMonitor`, optional) consumes each finished
    chunk record.  ``spans`` (optional) receives chunk 0 as a
    ``compile`` span: the kernel build, library load and warm-up.
    """

    def __init__(self, trace=None, step_unit: int = 1, profiler=None,
                 ensemble: int = 0, spans=None, cuda: bool = False):
        self.trace = trace
        self.profiler = profiler
        self.spans = spans
        self.step_unit = max(1, int(step_unit))
        self.ensemble = max(0, int(ensemble))
        self.cuda = bool(cuda)
        self.chunks: List[Dict[str, Any]] = []
        self.anomaly = None
        self.recompiles = 0
        self.peak_seen = 0
        self.last_progress = time.monotonic()
        self._chunk_begin_compiles: Optional[int] = None

    def mark(self) -> None:
        """Record liveness without a chunk."""
        self.last_progress = time.monotonic()

    def _fold_peak(self) -> None:
        if self.cuda:
            mem = device_memory_stats()
            if mem:
                self.peak_seen = max(self.peak_seen,
                                     mem["peak_bytes_in_use"])

    def begin_chunk(self) -> None:
        """Snapshot the load counter as a chunk starts and reset the
        allocator's peak (after folding the boundary's into
        ``peak_seen``).  Loads between chunks (a checkpoint writer, a
        health reduction) are legitimate; only loads between
        ``begin_chunk`` and ``record_chunk`` implicate the step."""
        self.mark()
        if self.cuda:
            self._fold_peak()
            _reset_peak()
        if self.profiler is not None:
            self.profiler.begin_chunk(len(self.chunks))
        self._chunk_begin_compiles = compile_events_seen()

    def record_chunk(self, steps: int, seconds: float) -> Dict[str, Any]:
        """One chunk finished: ``steps`` call-units in ``seconds`` wall."""
        self.mark()
        real_steps = int(steps) * self.step_unit
        n = len(self.chunks)
        profiled = (self.profiler is not None
                    and self.profiler.end_chunk(n))
        recompiled = False
        if self._chunk_begin_compiles is not None:
            during = compile_events_seen() - self._chunk_begin_compiles
            self._chunk_begin_compiles = None
            # first chunk: loads are the expected warm-up, not drift
            if n > 0 and during > 0:
                recompiled = True
                self.recompiles += during
        rec: Dict[str, Any] = {
            "chunk": n,
            "steps": real_steps,
            "wall_s": round(float(seconds), 6),
            "ms_per_step": round(seconds * 1e3 / max(1, real_steps), 6),
            "recompiled": recompiled,
        }
        if self.ensemble:
            rec["members"] = self.ensemble
        if profiled:
            rec["profiled"] = True
        mem = device_memory_stats() if self.cuda else {}
        if mem:
            rec["memory"] = mem
            self.peak_seen = max(self.peak_seen, mem["peak_bytes_in_use"])
        self.chunks.append(rec)
        if self.trace is not None:
            self.trace.event("chunk", **rec)
        if self.anomaly is not None:
            try:
                self.anomaly.observe_chunk(rec)
            except Exception:  # noqa: BLE001 — diagnosis never kills the run
                pass
        if n == 0 and self.spans is not None:
            self.spans.emit("compile", time.time() - float(seconds),
                            float(seconds), steps=real_steps,
                            ms_per_step=rec["ms_per_step"])
        return rec

    def summary(self) -> Dict[str, Any]:
        """First chunk (build, load and warm-up) vs steady percentiles."""
        out: Dict[str, Any] = {
            "n_chunks": len(self.chunks),
            "steps": sum(c["steps"] for c in self.chunks),
            "recompiles": self.recompiles,
        }
        self._fold_peak()
        if self.peak_seen:
            out["memory_peak_bytes"] = self.peak_seen
        if not self.chunks:
            return out
        out["first_chunk_s"] = self.chunks[0]["wall_s"]
        out["first_chunk_ms_per_step"] = self.chunks[0]["ms_per_step"]
        # steady state = everything after the warm-up chunk; a single-chunk
        # run has no steady sample and says so
        steady = [c for c in self.chunks[1:] if not c["recompiled"]]
        if steady:
            per = sorted(c["ms_per_step"] for c in steady)
            out["steady"] = {
                "chunks": len(per),
                "ms_per_step_best": per[0],
                "ms_per_step_p50": _percentile(per, 0.50),
                "ms_per_step_p90": _percentile(per, 0.90),
            }
        return out
