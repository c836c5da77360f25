"""Run configuration: one frozen dataclass per run.

A copy of the TPU package's ``RunConfig`` — the same fields, names and
defaults, so a checkpoint's recorded config reads the same on both sides —
plus ``device``, the counterpart of that package's platform selection.  The
port's CLI registers only the flags it runs; :func:`cli.build` refuses every
other field that differs from its default, by flag name.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RunConfig:
    stencil: str = "heat2d"
    grid: Tuple[int, ...] = (512, 512)
    iters: int = 1000
    dtype: Optional[str] = None  # None = the stencil's own default dtype
    mesh: Tuple[int, ...] = ()  # per-grid-axis shard counts; () = unsharded
    seed: int = 0
    density: float = 0.15
    init: str = "auto"
    periodic: bool = False
    log_every: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_backend: str = "npy"  # npy (host gather) | orbax (per-shard)
    resume: bool = False
    render: bool = False
    profile_dir: Optional[str] = None  # whole-run profiler trace
    profile: Optional[str] = None  # chunk-scoped profiler trace
    compute: str = "auto"  # auto | jnp | pallas
    overlap: bool = False  # interior/boundary split for comm overlap
    pipeline: bool = False  # cross-pass pipelined halo exchange
    ensemble: int = 0  # >0: batch of N independent universes
    ensemble_mesh: int = 0  # member-axis device shards
    ensemble_perturb: float = 0.0  # per-member init perturbation
    fuse: int = 0  # >0: temporal blocking, k steps per memory pass
    fuse_kind: str = "auto"  # auto | tiled | padfree | stream
    exchange: str = "ppermute"  # halo transport: ppermute | rdma
    groups: str = ""  # MPMD device groups; "" = monolithic
    group_transport: str = "device_put"  # device_put | collective
    auto_policy: bool = False  # measurement-driven mode resolution
    kernel_variant: str = ""  # forced kernel-constant variant id
    autotune: bool = False  # measured kernel-constant sweep
    policy_recheck: int = 0  # re-resolve the policy every K chunks
    check_finite: int = 0  # >0: assert all fields finite every N steps
    debug_checks: bool = False  # per-step finiteness checks
    health: bool = False  # numerics sentinel at chunk boundaries
    halo_audit: int = 0  # exchange audit every K chunks
    anomaly: bool = False  # performance-anomaly detection
    degraded_action: str = "warn"  # supervisor policy for DEGRADED runs
    tol: float = 0.0  # >0: stop when residual < tol
    tol_check_every: int = 10  # residual check cadence for --tol
    dump_every: int = 0  # >0: async .npy snapshots of field0 every N steps
    dump_dir: Optional[str] = None
    telemetry: Optional[str] = None  # JSONL telemetry event log
    mem_check: str = "error"  # error | warn | off: device memory guard
    supervise: bool = False  # fault-tolerant supervised run
    max_restarts: int = 2
    restart_backoff: float = 5.0
    supervise_stall_s: float = 600.0
    serve_port: Optional[int] = None  # live run console
    compile_cache: Optional[str] = None  # persistent compilation cache
    serve_engine: Optional[int] = None  # resident serving engine
    serve_router: Optional[int] = None  # fleet front door
    router_replicas: int = 3
    shrink_after: int = 64
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The port's own field: where the state lives ("cuda" or "cpu").
    device: str = "cuda"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        d = dict(d)
        for k in ("grid", "mesh"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def groups_signature(groups: str) -> str:
    """Short stable signature of a ``--groups`` string (the TPU package's):
    whitespace-normalized, so cosmetically different spellings of the same
    split share a signature."""
    import hashlib

    canon = ",".join(p.strip() for p in (groups or "").split(",")
                     if p.strip())
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


def parse_int_tuple(s: str) -> Tuple[int, ...]:
    s = s.strip()
    if not s:
        return ()
    return tuple(int(p) for p in s.replace("x", ",").split(",") if p.strip())


def parse_params(pairs) -> Dict[str, Any]:
    """Parse repeated ``--param key=value`` flags (values as float/int/str)."""
    out: Dict[str, Any] = {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        if not _:
            raise ValueError(f"--param expects key=value, got {p!r}")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out
