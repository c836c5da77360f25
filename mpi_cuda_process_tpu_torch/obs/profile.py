"""Device-trace attribution: what the card actually did with one chunk.

The port's counterpart of the TPU package's ``obs/profile.py``:

* :class:`ChunkProfiler` — a ``torch.profiler`` session (CPU and, on a
  card, CUDA activity, with Python stacks) scoped to ONE chunk (by
  default the first steady-state chunk, after the build and warm-up
  chunk), attached to the :class:`~.runtime.RuntimeRecorder` the driver
  already calls at chunk boundaries; with ``--profile`` off nothing here
  is constructed.  The session writes its Chrome trace to
  ``<dir>/chunk<N>[.p<rank>].trace.json`` and times the chunk's wall.
* :func:`load_trace_events` and :func:`attribute_events`: bucket device
  time into interior compute and the exchange, and compute the measured
  overlap efficiency ``1 - exposed_exchange / exchange``, by interval
  arithmetic over the device lanes; :func:`attribution_record` adds the
  chunk's idle share (the time the card was busy with nothing, over the
  chunk's wall time), and says ``unavailable`` when the device was busy
  longer than the chunk's wall (clocks that disagree, or events counted
  twice).

The port's own lane and classification rules:

* device lanes are the trace's device activity: ``cat`` of ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset`` (CUPTI's records); host events
  (``cpu_op``, ``cuda_runtime``, ``python_function``, annotations) are
  never device time;
* the exchange is NCCL's kernels, the ring kernels (``ring_exchange``,
  ``ring_send``, ``ring_drain``), peer and device-to-device copies, and
  every device event launched from ``parallel/halo.py`` or
  ``ops/cuda/remote.py`` (the pad and slab copies, the guard fills):
  the launching host op is found through the event's ``External id`` /
  ``correlation``, and its Python frames through the stack events that
  enclose it on its thread;
* everything else is interior compute, except a copy, fill or memset
  whose launching frames cannot be found: it could be either, so the
  attribution says ``unavailable`` rather than count an exchange copy as
  compute.

Honesty rule: on the CPU (no device lanes) or when the trace yields no
device events, the record says ``attribution: unavailable`` with the
reason — never fabricated zeros.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Device activity categories of a torch.profiler (Kineto) Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernel names that are the exchange wherever they come from
# (lowercased substring match).
_COMM_MARKERS = ("nccl", "ring_exchange", "ring_send", "ring_drain")
# Host source files whose launches are the exchange.
_EXCHANGE_SOURCES = ("parallel/halo.py", "ops/cuda/remote.py")
# Device events that are plain data movement: exchange or not by their
# launcher alone.
_COPY_MARKERS = ("copy", "fill", "memset", "memcpy")


def is_comm_event(name: str, cat: str = "kernel") -> bool:
    """Whether a device event is the exchange by its name alone: NCCL and
    the ring kernels, and peer or device-to-device copies."""
    low = str(name).lower()
    if any(m in low for m in _COMM_MARKERS):
        return True
    if cat == "gpu_memcpy" and ("ptop" in low or "peer" in low):
        return True
    return False


def _is_copy(name: str, cat: str) -> bool:
    low = str(name).lower()
    return cat != "kernel" or any(m in low for m in _COPY_MARKERS)


# ------------------------------------------------------------ trace IO

def find_trace_files(profile_dir: str) -> List[str]:
    """Chrome-trace files under a profile dir, oldest first."""
    pats = (os.path.join(profile_dir, "**", "*.trace.json.gz"),
            os.path.join(profile_dir, "**", "*.trace.json"))
    found: List[str] = []
    for pat in pats:
        found.extend(glob.glob(pat, recursive=True))
    return sorted(set(found), key=lambda p: (os.path.getmtime(p), p))


def load_trace_events(profile_dir: str,
                      path: Optional[str] = None) -> List[Dict[str, Any]]:
    """``traceEvents`` of ``path``, or of the NEWEST trace file under
    ``profile_dir``; ``[]`` when there is none."""
    if path is None:
        files = find_trace_files(profile_dir)
        if not files:
            return []
        path = files[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:  # type: ignore[operator]
        doc = json.load(fh)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    return events if isinstance(events, list) else []


# -------------------------------------------------- interval arithmetic

def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of half-open intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _total(merged: Sequence[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _intersection_total(a: Sequence[Tuple[float, float]],
                        b: Sequence[Tuple[float, float]]) -> float:
    """Total overlap between two MERGED interval lists (two-pointer)."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return tot


# ---------------------------------------------------------- attribution

def device_events(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Complete device-activity events (``ph == "X"``, a device
    category, a positive duration)."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        try:
            if float(e.get("dur", 0.0)) > 0 and "ts" in e:
                out.append(e)
        except (TypeError, ValueError):
            continue
    return out


class _Launchers:
    """Host-side lookup: a device event's launching host event, and
    whether a Python frame of the exchange encloses it on its thread."""

    def __init__(self, events: Sequence[Dict[str, Any]]):
        self.by_corr: Dict[Any, Dict[str, Any]] = {}
        self.by_ext: Dict[Any, Dict[str, Any]] = {}
        frames: Dict[Tuple[Any, Any], List[Tuple[float, float, bool]]] = {}
        self.has_stacks = False
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            args = e.get("args") or {}
            if cat == "cuda_runtime" and "correlation" in args:
                self.by_corr[args["correlation"]] = e
            elif cat == "cpu_op" and "External id" in args:
                self.by_ext.setdefault(args["External id"], e)
            elif cat == "python_function":
                self.has_stacks = True
                try:
                    s = float(e["ts"])
                    d = float(e.get("dur", 0.0))
                except (KeyError, TypeError, ValueError):
                    continue
                name = str(e.get("name", "")).replace("\\", "/")
                frames.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (s, s + d, any(m in name for m in _EXCHANGE_SOURCES)))
        # per thread: the exchange frames' intervals, merged and sorted
        self.exch: Dict[Tuple[Any, Any], List[Tuple[float, float]]] = {
            k: _merge([(s, e) for s, e, x in v if x])
            for k, v in frames.items()}
        self._starts = {k: [s for s, _ in v] for k, v in self.exch.items()}

    def launcher(self, dev: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        args = dev.get("args") or {}
        host = self.by_corr.get(args.get("correlation"))
        if host is None:
            host = self.by_ext.get(args.get("External id"))
        return host

    def in_exchange(self, host: Dict[str, Any]) -> bool:
        key = (host.get("pid"), host.get("tid"))
        iv = self.exch.get(key)
        if not iv:
            return False
        t = float(host.get("ts", 0.0))
        i = bisect.bisect_right(self._starts[key], t) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]


def attribute_events(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Bucket device time: interior compute / exchange / exposed.

    ``comm`` is the union of exchange intervals, ``compute`` the union of
    everything else on the device lanes; ``exposed_comm`` is exchange
    time with no concurrent compute.  All durations in trace
    microseconds.  ``comm_events`` counts the device events classed as
    the exchange by their name (NCCL, the ring kernels, peer copies) and
    by their launching frames (``parallel/halo.py``,
    ``ops/cuda/remote.py``)."""
    devs = device_events(events)
    if not devs:
        if any(e.get("cat") in DEVICE_CATS for e in events):
            return {"attribution": "unavailable",
                    "reason": "device lanes present but carry no complete "
                              "events"}
        return {"attribution": "unavailable",
                "reason": "no device lanes in the trace (a CPU run, or a "
                          "profiler that captured host events only)"}
    who = _Launchers(events)
    comm: List[Tuple[float, float]] = []
    compute: List[Tuple[float, float]] = []
    unknown = 0
    by = {"by_name": 0, "by_launcher": 0}
    for e in devs:
        s = float(e["ts"])
        d = float(e["dur"])
        name, cat = e.get("name", ""), e.get("cat", "")
        if is_comm_event(name, cat):
            comm.append((s, s + d))
            by["by_name"] += 1
            continue
        host = who.launcher(e)
        if host is not None and who.in_exchange(host):
            comm.append((s, s + d))
            by["by_launcher"] += 1
        elif _is_copy(name, cat) and (host is None or not who.has_stacks):
            unknown += 1
        else:
            compute.append((s, s + d))
    if unknown:
        return {"attribution": "unavailable",
                "reason": f"{unknown} copy/fill device event(s) whose "
                          "launching Python frames are not in the trace: "
                          "exchange and interior copies cannot be told "
                          "apart",
                "n_device_events": len(devs)}
    comm_m, compute_m = _merge(comm), _merge(compute)
    comm_us = _total(comm_m)
    compute_us = _total(compute_m)
    hidden_us = _intersection_total(comm_m, compute_m)
    exposed_us = comm_us - hidden_us
    busy_m = _merge(list(comm_m) + list(compute_m))
    busy_us = _total(busy_m)
    return {
        "attribution": "ok",
        "n_device_events": len(devs),
        "device_busy_us": round(busy_us, 3),
        "compute_us": round(compute_us, 3),
        "comm_us": round(comm_us, 3),
        "comm_events": by,
        "exposed_comm_us": round(exposed_us, 3),
        # 1 - exposed/total: 1.0 = exchange fully hidden behind compute,
        # 0.0 = fully serial; None when the trace carries no exchange
        "overlap_efficiency": (round(1.0 - exposed_us / comm_us, 4)
                               if comm_us > 0 else None),
        "device_span_us": round(busy_m[-1][1] - busy_m[0][0], 3),
    }


def attribution_record(profile_dir: str,
                       profiled_chunk: Optional[int] = None,
                       error: Optional[str] = None,
                       wall_s: Optional[float] = None,
                       path: Optional[str] = None) -> Dict[str, Any]:
    """The ``profile`` telemetry event payload for a finished run.
    ``wall_s`` (the profiled chunk's wall time, up to its device
    synchronize) gives ``idle_share``: 1 - device busy / wall; a busy
    time past the wall makes the attribution ``unavailable``, with both
    numbers kept."""
    rec: Dict[str, Any] = {
        "profile_dir": os.path.abspath(profile_dir),
        "profiled_chunk": profiled_chunk,
    }
    if error:
        rec.update(attribution="unavailable",
                   reason=f"profiler error: {error}")
        return rec
    if profiled_chunk is None:
        rec.update(attribution="unavailable",
                   reason="no chunk reached the profile scope (run ended "
                          "before the target chunk)")
        return rec
    try:
        events = load_trace_events(profile_dir, path)
    except Exception as e:  # noqa: BLE001 — a corrupt trace must not
        rec.update(attribution="unavailable",  # kill the run epilogue
                   reason=f"trace parse failed: {type(e).__name__}: {e}")
        return rec
    if not events:
        rec.update(attribution="unavailable",
                   reason="no .trace.json emitted under the profile dir")
        return rec
    rec.update(attribute_events(events))
    if rec.get("attribution") == "ok" and wall_s:
        wall_us = wall_s * 1e6
        rec["chunk_wall_us"] = round(wall_us, 3)
        if rec["device_busy_us"] > wall_us:
            rec.update(attribution="unavailable",
                       reason=f"device busy {rec['device_busy_us']} us "
                              f"exceeds the chunk's wall {wall_us:.3f} us: "
                              "the clocks disagree or events were counted "
                              "twice")
        else:
            rec["idle_share"] = round(
                1.0 - rec["device_busy_us"] / wall_us, 6)
    return rec


def format_attribution(rec: Dict[str, Any]) -> str:
    """One human line for logs."""
    if rec.get("attribution") != "ok":
        return f"attribution unavailable ({rec.get('reason')})"
    eff = rec.get("overlap_efficiency")
    parts = [
        f"busy {rec['device_busy_us'] / 1e3:.3f} ms",
        f"compute {rec['compute_us'] / 1e3:.3f} ms",
        f"comm {rec['comm_us'] / 1e3:.3f} ms",
        f"exposed {rec['exposed_comm_us'] / 1e3:.3f} ms",
    ]
    parts.append("no exchange in trace" if eff is None
                 else f"measured overlap efficiency {eff:.2%}")
    if rec.get("idle_share") is not None:
        parts.append(f"idle share {rec['idle_share']:.2%}")
    return "  ".join(parts)


# ------------------------------------------------------- chunk profiler

def _start_torch_profiler(outdir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, with_stack=True)
    prof.__enter__()
    return prof


class ChunkProfiler:
    """Scope one ``torch.profiler`` session to one chunk of a run.

    Attached as ``recorder.profiler``; the recorder calls
    :meth:`begin_chunk` / :meth:`end_chunk` with the chunk index at the
    boundaries the driver already observes (``end_chunk`` after the
    chunk's device synchronize).  ``target_chunk`` defaults to 1 — the
    first chunk after the build and warm-up.  One trace per run.

    ``start(outdir) -> handle`` and ``stop(handle, path)`` are injectable
    for tests; production uses ``torch.profiler.profile`` and exports its
    Chrome trace to :attr:`path`.  A profiler failure is recorded in
    ``self.error`` and never propagates.
    """

    def __init__(self, outdir: str, target_chunk: int = 1,
                 start=None, stop=None, tag: str = ""):
        self.outdir = outdir
        self.target_chunk = int(target_chunk)
        self._start = start or _start_torch_profiler
        self._stop = stop or self._stop_torch
        self.tag = tag
        self.active = False
        self.profiled_chunk: Optional[int] = None
        self.error: Optional[str] = None
        self.path: Optional[str] = None
        self.wall_s: Optional[float] = None
        self._handle = None
        self._t0 = 0.0

    @staticmethod
    def _stop_torch(handle, path: str) -> None:
        handle.__exit__(None, None, None)
        handle.export_chrome_trace(path)

    def begin_chunk(self, chunk_index: int) -> bool:
        """Start the session iff this is the target chunk (once a run)."""
        if self.active or self.profiled_chunk is not None:
            return False
        if int(chunk_index) != self.target_chunk:
            return False
        try:
            os.makedirs(self.outdir, exist_ok=True)
            self.path = os.path.join(
                self.outdir, f"chunk{int(chunk_index)}{self.tag}.trace.json")
            self._handle = self._start(self.outdir)
            self.active = True
            self._t0 = time.perf_counter()
        except Exception as e:  # noqa: BLE001
            self.error = f"{type(e).__name__}: {e}"
        return self.active

    def end_chunk(self, chunk_index: int) -> bool:
        """Stop the session if running; True iff this chunk was captured."""
        if not self.active:
            return False
        self.wall_s = time.perf_counter() - self._t0
        try:
            self._stop(self._handle, self.path)
        except Exception as e:  # noqa: BLE001
            self.error = f"{type(e).__name__}: {e}"
        self.active = False
        self._handle = None
        self.profiled_chunk = int(chunk_index)
        return True

    def close(self) -> None:
        """Abort path: stop a still-open session.  Idempotent."""
        if self.active:
            try:
                self._stop(self._handle, self.path)
            except Exception as e:  # noqa: BLE001
                self.error = f"{type(e).__name__}: {e}"
            self.active = False
            self._handle = None
