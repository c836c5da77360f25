"""JSONL event recorder + provenance-stamped run manifests.

The port's counterpart of the TPU package's ``obs/trace.py``: the same
schema numbers, record kinds and validator rules, so every event the port
writes passes that package's ``validate_event`` and one reader handles both
packages' logs.  An entry point (the CLI's ``--telemetry PATH``) opens a
trace, writes ONE manifest line — a versioned, validated record of what
ran (config, flags), on what (backend, card, device count, process) and
from which code (git sha, PyTorch and CUDA versions) — then appends events
(chunk timings, heartbeat verdicts, health checks, a final summary) as
JSON lines.

The manifest's provenance differs from the reference's in one place: the
reference stamps the version of its array library (``jax_version``), the
port stamps ``torch_version`` and ``cuda_version`` (PyTorch's CUDA build,
``"none"`` for a CPU build) and, on a card, ``nvidia_smi``: the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` reports them (a card may be capped below its
maximum, and every number beside it depends on the cap).  The reference's
validator therefore rejects a port manifest, naming ``jax_version`` alone;
this module's validator is the port's definition.

Design constraints:

* **Zero ops in the step.**  Events are written host-side at chunk
  boundaries only; the step's aten ops and kernel launches are identical
  with telemetry on and off (``tests/test_torch_obs.py``, chip_smoke.py
  phase 5j).
* **Thread-safe writes** (the heartbeat thread shares the writer).
* **Never load-bearing**: telemetry failures must not kill a run; callers
  wrap session setup in try/except (the writer itself only raises on
  programmer errors like an invalid manifest).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# Schema 2 carries the multi-process identity (process_index /
# process_count / hostname); schema-1 logs still parse.
SCHEMA_VERSION = 2
ACCEPTED_SCHEMAS = (1, 2)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# provenance keys every port manifest must carry, with their types
_PROVENANCE_TYPES = {
    "git_sha": str,
    "torch_version": str,
    "cuda_version": str,
    "backend": str,
    "device_kind": str,
    "device_count": int,
    "framework_version": str,
}

# schema-2 additions: required on schema-2 manifests, absent on schema-1
_PROVENANCE_V2_TYPES = {
    "process_index": int,
    "process_count": int,
    "hostname": str,
}


def default_telemetry_dir() -> str:
    """Where tools drop event logs when no path is given.

    ``OBS_TELEMETRY_DIR`` overrides (tests point it at a tmpdir); the
    default is ``<repo>/.telemetry``, which git ignores.
    """
    return os.environ.get("OBS_TELEMETRY_DIR") or \
        os.path.join(_REPO, ".telemetry")


def _git_sha() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=_REPO,
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except Exception:  # noqa: BLE001 — provenance is best-effort
        pass
    return "unknown"


def nvidia_smi() -> Optional[str]:
    """The card's ``name, power.limit`` as nvidia-smi reports them (first
    card), or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0].strip()
    except Exception:  # noqa: BLE001 — best-effort
        pass
    return None


def process_identity() -> Tuple[int, int]:
    """(process_index, process_count): the open process group's rank and
    size, else a launcher's ``RANK`` / ``WORLD_SIZE`` (a session opens
    before the run's process group does), else (0, 1)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:  # noqa: BLE001
        pass
    try:
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        rank = int(os.environ.get("RANK", "0") or 0)
    except ValueError:
        return 0, 1
    if os.environ.get("MASTER_ADDR") and world > 1:
        return rank, world
    return 0, 1


def _rank_log_path(path: str, rank: int) -> str:
    if rank == 0:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.p{rank}{ext}"


def process_log_path(path: str) -> str:
    """This process's log path: ``path`` itself for process 0 (or one
    process), ``<stem>.p<r><ext>`` for process r > 0 of a multi-process
    run, so the processes never write one file."""
    rank, world = process_identity()
    return path if world <= 1 else _rank_log_path(path, rank)


def launch_log_paths(path: str) -> List[str]:
    """Every process's log path of this launch, in process order (the
    logs a console of the whole launch watches)."""
    return [_rank_log_path(path, r) for r in range(process_identity()[1])]


def provenance(device: Optional[str] = None) -> Dict[str, Any]:
    """The code+hardware identity block stamped into every manifest.

    ``device`` is the run's device type (``"cuda"`` or ``"cpu"``); by
    default the card when one is visible."""
    import torch

    from .. import __version__

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    backend = str(device).split(":")[0]
    smi = None
    try:
        if backend == "cuda" and torch.cuda.is_available():
            device_kind = torch.cuda.get_device_name(0)
            device_count = int(torch.cuda.device_count())
            smi = nvidia_smi()
        else:
            device_kind, device_count = "cpu", 1
    except Exception:  # noqa: BLE001 — a wedged card must not block
        device_kind, device_count = "unknown", 1
    process_index, process_count = process_identity()
    try:
        hostname = socket.gethostname() or "unknown"
    except Exception:  # noqa: BLE001
        hostname = "unknown"
    return {
        "git_sha": _git_sha(),
        "builder_rev": None,
        "torch_version": str(torch.__version__),
        "cuda_version": str(torch.version.cuda or "none"),
        "backend": backend,
        "device_kind": device_kind,
        "device_count": device_count,
        "nvidia_smi": smi,
        "process_index": process_index,
        "process_count": process_count,
        "hostname": hostname,
        "framework_version": __version__,
    }


def build_manifest(tool: str, run: Dict[str, Any],
                   **extra: Any) -> Dict[str, Any]:
    """Assemble and validate a manifest record.

    ``tool`` names the emitting entry point; ``run`` is its config dict
    (the full RunConfig for the CLI; its ``device`` picks the backend).
    ``extra`` lands at the top level."""
    m: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "kind": "manifest",
        "tool": tool,
        "created_at": time.time(),
        "run": dict(run),
        "provenance": provenance(run.get("device")),
    }
    m.update(extra)
    validate_manifest(m)
    return m


def validate_manifest(m: Any) -> Dict[str, Any]:
    """Raise ValueError listing EVERY problem; return ``m`` when valid."""
    problems: List[str] = []
    if not isinstance(m, dict):
        raise ValueError(f"manifest must be a dict, got {type(m).__name__}")
    if m.get("schema") not in ACCEPTED_SCHEMAS:
        problems.append(
            f"schema must be one of {ACCEPTED_SCHEMAS} "
            f"(got {m.get('schema')!r}); bump the reader, never the record")
    if m.get("kind") != "manifest":
        problems.append(f"kind must be 'manifest' (got {m.get('kind')!r})")
    if not isinstance(m.get("tool"), str) or not m.get("tool"):
        problems.append(f"tool must be a nonempty str (got {m.get('tool')!r})")
    if not isinstance(m.get("created_at"), (int, float)) \
            or m.get("created_at", 0) <= 0:
        problems.append(
            f"created_at must be a positive unix time "
            f"(got {m.get('created_at')!r})")
    if not isinstance(m.get("run"), dict):
        problems.append(f"run must be a dict (got {type(m.get('run')).__name__})")
    prov = m.get("provenance")
    if not isinstance(prov, dict):
        problems.append("provenance must be a dict")
    else:
        for key, typ in _PROVENANCE_TYPES.items():
            if not isinstance(prov.get(key), typ):
                problems.append(
                    f"provenance.{key} must be {typ.__name__} "
                    f"(got {prov.get(key)!r})")
        for key, typ in _PROVENANCE_V2_TYPES.items():
            present = key in prov
            if m.get("schema") == 2 and not present:
                problems.append(
                    f"provenance.{key} is required at schema 2 "
                    f"({typ.__name__})")
            elif present and not isinstance(prov.get(key), typ):
                problems.append(
                    f"provenance.{key} must be {typ.__name__} "
                    f"(got {prov.get(key)!r})")
        if isinstance(prov.get("device_count"), int) and \
                prov["device_count"] < 1:
            problems.append("provenance.device_count must be >= 1")
        if isinstance(prov.get("process_count"), int) and \
                prov["process_count"] < 1:
            problems.append("provenance.process_count must be >= 1")
        smi = prov.get("nvidia_smi", None)
        if smi is not None and not isinstance(smi, str):
            problems.append(
                f"provenance.nvidia_smi must be str or null (got {smi!r})")
        br = prov.get("builder_rev", None)
        if br is not None and not isinstance(br, int):
            problems.append(
                f"provenance.builder_rev must be int or null (got {br!r})")
    if problems:
        raise ValueError("invalid manifest: " + "; ".join(problems))
    return m


def validate_event(e: Any) -> Dict[str, Any]:
    """Raise ValueError on a malformed event record; return it when valid."""
    if not isinstance(e, dict):
        raise ValueError(f"event must be a dict, got {type(e).__name__}")
    problems: List[str] = []
    if e.get("schema") not in ACCEPTED_SCHEMAS:
        problems.append(f"schema must be one of {ACCEPTED_SCHEMAS} "
                        f"(got {e.get('schema')!r})")
    kind = e.get("kind")
    if not isinstance(kind, str) or not kind:
        problems.append(f"kind must be a nonempty str (got {kind!r})")
    elif kind == "manifest":
        problems.append("'manifest' is reserved for the first record")
    if not isinstance(e.get("t"), (int, float)) or e.get("t", 0) <= 0:
        problems.append(f"t must be a positive unix time (got {e.get('t')!r})")
    if problems:
        raise ValueError("invalid event: " + "; ".join(problems))
    return e


class TraceWriter:
    """Append-only JSONL writer: one manifest first, then events.

    Thread-safe (the heartbeat thread writes verdict events while the
    main thread writes chunks).  Values that are not JSON-native are
    stringified (``default=str``) so a dtype or Path in a config dict
    never kills a run.  ``mirrors`` are in-process taps: each callable
    sees every record right after it hits disk (the flight recorder rides
    here); a mirror raising never kills the write path.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._fh = open(path, "w")
        self._lock = threading.Lock()
        self._wrote_manifest = False
        self.last_event_t = time.monotonic()
        self.mirrors: List[Any] = []

    def write_manifest(self, manifest: Dict[str, Any]) -> None:
        validate_manifest(manifest)
        with self._lock:
            if self._wrote_manifest:
                raise ValueError("manifest already written")
            self._write(manifest)
            self._wrote_manifest = True

    def event(self, kind: str, **payload: Any) -> Dict[str, Any]:
        rec = {"schema": SCHEMA_VERSION, "kind": kind, "t": time.time()}
        rec.update(payload)
        validate_event(rec)
        with self._lock:
            if not self._wrote_manifest:
                raise ValueError("write the manifest before any event")
            self._write(rec)
        return rec

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._fh is None:
            return  # closed: drop silently (late heartbeat verdicts)
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()
        self.last_event_t = time.monotonic()
        for mirror in self.mirrors:
            try:
                mirror(rec)
            except Exception:  # noqa: BLE001 — taps are never load-bearing
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Parse a JSONL trace: ``(manifest, events)``.  No validation."""
    manifest: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if manifest is None:
                manifest = rec
            else:
                events.append(rec)
    if manifest is None:
        raise ValueError(f"{path}: empty event log")
    return manifest, events


def validate_log(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """``read_log`` + schema validation of the manifest and every event."""
    manifest, events = read_log(path)
    try:
        validate_manifest(manifest)
    except ValueError as e:
        raise ValueError(f"{path}: first record: {e}") from None
    for i, e in enumerate(events):
        try:
            validate_event(e)
        except ValueError as err:
            raise ValueError(f"{path}: event {i}: {err}") from None
    return manifest, events


class LogTail:
    """Incremental JSONL reader: ``poll()`` returns newly appended records.

    The live console's view of a run: it tails the telemetry log between
    polls, consuming only COMPLETE lines (a process killed mid-write
    leaves a partial last line, which stays unconsumed until — if ever —
    its terminator lands, never parsed as garbage).  Reads in binary and
    tracks a byte offset so a decode boundary can't desync the position.
    A missing file (the run not yet started, or dead before its first
    record) yields no records rather than raising; malformed complete
    lines are counted (``malformed``) and skipped — the watcher must
    survive anything a dying process leaves behind.

    Truncation is detected by size: a file now SHORTER than the consumed
    offset was rewritten from the top (``TraceWriter`` opens ``"w"``), so
    the tail restarts at byte 0 (``truncations`` counts the resets).  A
    rewrite that has already grown past the old offset reads as an
    append: every writer here starts a fresh file empty, so the shrink
    shows at the next poll.
    """

    def __init__(self, path: str):
        self.path = path
        self.malformed = 0
        self.truncations = 0
        self._pos = 0

    def poll(self) -> List[Dict[str, Any]]:
        try:
            fh = open(self.path, "rb")
        except OSError:
            return []
        with fh:
            try:
                size = os.fstat(fh.fileno()).st_size
            except OSError:
                size = None
            if size is not None and size < self._pos:
                self._pos = 0
                self.truncations += 1
            fh.seek(self._pos)
            buf = fh.read()
        end = buf.rfind(b"\n")
        if end < 0:
            return []
        self._pos += end + 1
        out: List[Dict[str, Any]] = []
        for line in buf[:end + 1].splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8", errors="replace"))
            except ValueError:
                self.malformed += 1
                continue
            if isinstance(rec, dict):
                out.append(rec)
            else:
                self.malformed += 1
        return out
