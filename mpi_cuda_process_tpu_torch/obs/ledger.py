"""Append-only campaign ledger: every measurement, with provenance, forever.

The port's counterpart of the TPU package's ``obs/ledger.py``: the same
row schema, keys, quarantine rules and ``best_known`` order, so a row the
port writes reads like one the reference writes — and a ledger never
mixes the two, since the port keeps its OWN file (never the reference's
committed ``benchmarks/ledger.jsonl``, which holds TPU rows):

* every CLI telemetry log is ingested into one append-only,
  schema-versioned JSONL ledger (:func:`ingest_log`, or ``python -m
  mpi_cuda_process_tpu_torch.obs.ledger ingest LOG``);
* rows are keyed by label x config x mesh x kind x flags x builder rev
  (:func:`make_key`), and **quarantine** is first-class: 0.0, errored,
  backend-mismatched, DIVERGED and WEDGED/STALLED values are recorded with
  their reason instead of being scorable — a quarantined row can NEVER
  become a baseline (:func:`best_known` filters on ``status == "ok"``);
* :func:`best_known` gives the best known value with its provenance per
  (label, backend) — the band the run doctor (``--anomaly``) measures a
  run against, the row the flight bundle records, and the
  ``obs_ledger_best_known`` family the live console serves.

The backend is part of every baseline key: the port's manifests stamp
``backend: "cuda"`` (or ``"cpu"``), so an H100 row never baselines a run
on another backend, and each row's provenance names the card and its
power limit (``device_kind``, ``nvidia_smi``).  ``builder_rev`` is None
on every port row: the port has no measurement harness that stamps one
(ROADMAP A9), so a port row's ``key_id`` differs from the reference's
for the same run while its ``baseline_key`` does not.

The reference's bench and campaign half (``backfill`` of the TPU
scoreboards, the ``bench`` / ``measure`` / ``scaling`` logs, the wedged
bench hook) comes with the port's measurement harness (ROADMAP A9).

No CUDA is touched here; the ledger must be readable on a wedged box.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import trace as trace_lib

LEDGER_SCHEMA = 1

LEDGER_FILE = "ledger_torch.jsonl"


def default_ledger_path() -> str:
    """``OBS_LEDGER_PATH`` when set, else the port's own ledger in the
    telemetry directory (``<repo>/.telemetry/ledger_torch.jsonl``, which
    git ignores)."""
    return os.environ.get("OBS_LEDGER_PATH") or \
        os.path.join(trace_lib.default_telemetry_dir(), LEDGER_FILE)


# ---------------------------------------------------------------- rows

def make_key(label: str, backend: Optional[str] = None,
             grid: Any = None, mesh: Any = None,
             kind: Optional[str] = None, dtype: Optional[str] = None,
             flags: Optional[Dict[str, Any]] = None,
             builder_rev: Optional[int] = None) -> Dict[str, Any]:
    """The row identity: label x config x mesh x kind x flags x rev."""
    return {
        "label": str(label),
        "backend": backend,
        "grid": list(grid) if grid else None,
        "mesh": list(mesh) if mesh else None,
        "kind": kind,
        "dtype": dtype,
        "flags": dict(flags) if flags else None,
        "builder_rev": builder_rev,
    }


def key_id(key: Dict[str, Any]) -> str:
    return json.dumps(key, sort_keys=True, separators=(",", ":"))


def baseline_key(row: Dict[str, Any]) -> str:
    """Baseline identity: the same label on the same backend under the
    same exchange mode, ensemble size, kernel variant, group signature
    and group transport.

    Deliberately coarser than :func:`key_id`: a builder-rev bump or a
    flag change must still be COMPARED against the old number, but a CPU
    smoke must never be judged against an H100 baseline — and a ppermute
    measurement must never be the baseline of an rdma run (different
    execution paths), an ``ens=8`` row (8 members' throughput) never that
    of a single simulation, a ``|var:<id>`` row (swept kernel constants)
    never that of the default constants, a coupled ``--groups`` row never
    that of a monolithic run or another split, and a collective-transport
    coupled row never that of a device_put one.  Each rides the flags
    only when non-default, so the key of a plain run is ``label|backend``.
    """
    k = row["key"]
    flags = k.get("flags") or {}
    mode = flags.get("exchange")
    tail = f"|{mode}" if mode else ""
    ens = flags.get("ensemble")
    if ens:
        tail += f"|ens{ens}"
    var = flags.get("kernel_variant")
    if var:
        tail += f"|var:{var}"
    grp = flags.get("groups_sig")
    if grp:
        tail += f"|grp:{grp}"
    gtx = flags.get("group_transport")
    if gtx:
        tail += f"|gtx:{gtx}"
    return f"{k['label']}|{k.get('backend')}{tail}"


def classify(value: Any, *, stale: bool = False, suspect: bool = False,
             error: Optional[str] = None,
             cancelled: bool = False,
             backend: Optional[str] = None,
             expected_backend: Optional[str] = None,
             heartbeat: Optional[str] = None,
             health: Optional[str] = None) -> Tuple[str, Optional[str]]:
    """Quarantine decision for one measurement: ``(status, reason)``.

    The reference's rules, in its order (which decides only the reason
    reported; ANY tripped rule quarantines): cancelled, errored, a stale
    replay, a noise-floor suspect, a backend mismatch, DIVERGED health (a
    run computing garbage is not a baseline, however fast it looked), a
    WEDGED/STALLED heartbeat, and a zero or missing value (0.0 is never a
    measurement).
    """
    if cancelled:
        return "quarantined", "cancelled"
    if error:
        return "quarantined", f"errored: {str(error)[:120]}"
    if stale:
        return "quarantined", "stale replay — not a fresh measurement"
    if suspect:
        return "quarantined", "noise-floor suspect"
    if backend and expected_backend and backend != expected_backend:
        return "quarantined", (f"backend mismatch: record says "
                               f"{backend!r}, provenance says "
                               f"{expected_backend!r}")
    if health == "DIVERGED":
        return "quarantined", "diverged"
    if heartbeat in ("WEDGED", "STALLED"):
        return "quarantined", f"heartbeat verdict {heartbeat}"
    if not isinstance(value, (int, float)) or value <= 0.0:
        return "quarantined", f"zero/missing value ({value!r})"
    return "ok", None


def make_row(label: str, value: Any, *, source: str,
             unit: str = "Mcells/s",
             measured_at: Optional[float] = None,
             ms_per_step: Optional[float] = None,
             heartbeat: Optional[str] = None,
             health: Optional[str] = None,
             provenance: Optional[Dict[str, Any]] = None,
             detail: Optional[Dict[str, Any]] = None,
             stale: bool = False, suspect: bool = False,
             error: Optional[str] = None,
             cancelled: bool = False,
             backend: Optional[str] = None,
             expected_backend: Optional[str] = None,
             **key_kw: Any) -> Dict[str, Any]:
    status, reason = classify(
        value, stale=stale, suspect=suspect, error=error,
        cancelled=cancelled,
        backend=backend, expected_backend=expected_backend,
        heartbeat=heartbeat, health=health)
    key = make_key(label, backend=backend or expected_backend, **key_kw)
    row: Dict[str, Any] = {
        "schema": LEDGER_SCHEMA,
        "kind": "ledger_row",
        "ingested_at": time.time(),
        "label": str(label),
        "key": key,
        "key_id": key_id(key),
        "value": value if isinstance(value, (int, float)) else None,
        "unit": unit,
        "ms_per_step": ms_per_step,
        "measured_at": measured_at,
        "status": status,
        "quarantine": reason,
        "heartbeat": heartbeat,
        "source": source,
        "provenance": provenance or None,
        "detail": detail or None,
    }
    if health is not None:
        # only when a health verdict exists, as the reference writes it
        row["health"] = health
    validate_row(row)
    return row


def validate_row(row: Any) -> Dict[str, Any]:
    """Raise ValueError listing every problem; return ``row`` if valid."""
    if not isinstance(row, dict):
        raise ValueError(f"ledger row must be a dict, got "
                         f"{type(row).__name__}")
    problems: List[str] = []
    if row.get("schema") != LEDGER_SCHEMA:
        problems.append(f"schema must be {LEDGER_SCHEMA} "
                        f"(got {row.get('schema')!r}); bump the reader, "
                        "never the record")
    if row.get("kind") != "ledger_row":
        problems.append(f"kind must be 'ledger_row' (got {row.get('kind')!r})")
    if not isinstance(row.get("label"), str) or not row.get("label"):
        problems.append(f"label must be a nonempty str "
                        f"(got {row.get('label')!r})")
    if not isinstance(row.get("key"), dict):
        problems.append("key must be a dict")
    if row.get("status") not in ("ok", "quarantined"):
        problems.append(f"status must be ok|quarantined "
                        f"(got {row.get('status')!r})")
    if row.get("status") == "ok":
        v = row.get("value")
        if not isinstance(v, (int, float)) or v <= 0:
            problems.append(f"an ok row needs a positive value (got {v!r})")
    elif not row.get("quarantine"):
        problems.append("a quarantined row needs a quarantine reason")
    if not isinstance(row.get("source"), str) or not row.get("source"):
        problems.append("source must be a nonempty str")
    if not isinstance(row.get("ingested_at"), (int, float)) \
            or row.get("ingested_at", 0) <= 0:
        problems.append("ingested_at must be a positive unix time")
    if problems:
        raise ValueError("invalid ledger row: " + "; ".join(problems))
    return row


# ------------------------------------------------------------- file IO

def read_rows(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every valid row of the ledger (missing file -> []).

    A corrupt line raises with its line number — an append-only file
    that went bad must be loud, not silently shortened.
    """
    path = path or default_ledger_path()
    if not os.path.exists(path):
        return []
    rows: List[Dict[str, Any]] = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(validate_row(json.loads(line)))
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from None
    return rows


def _row_uid(row: Dict[str, Any]) -> Tuple[str, Optional[float], str]:
    ts = row.get("measured_at")
    return (row["key_id"],
            round(float(ts), 3) if isinstance(ts, (int, float)) else None,
            row["source"])


def append_rows(rows: Iterable[Dict[str, Any]],
                path: Optional[str] = None) -> int:
    """Append rows not already present (by key x measured_at x source).

    The dedupe makes every ingest idempotent: re-ingesting the same log
    appends nothing.  Returns the number of rows actually appended.
    """
    path = path or default_ledger_path()
    seen = {_row_uid(r) for r in read_rows(path)}
    fresh = []
    for r in rows:
        uid = _row_uid(validate_row(r))
        if uid not in seen:
            seen.add(uid)
            fresh.append(r)
    if not fresh:
        return 0
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "a") as fh:
        for r in fresh:
            fh.write(json.dumps(r, default=str) + "\n")
    return len(fresh)


# ------------------------------------------------- telemetry ingestion

def _flags(run: Dict[str, Any]) -> Dict[str, Any]:
    out = {k: run.get(k) for k in ("fuse", "fuse_kind", "overlap",
                                   "pipeline")
           if run.get(k)}
    # exchange mode and ensemble size are part of the row identity AND
    # the baseline key (see baseline_key) — recorded only when
    # non-default, as the reference records them
    if run.get("exchange") and run["exchange"] != "ppermute":
        out["exchange"] = run["exchange"]
    if run.get("ensemble"):
        out["ensemble"] = run["ensemble"]
        if run.get("ensemble_mesh"):
            out["ensemble_mesh"] = run["ensemble_mesh"]
    if run.get("kernel_variant"):
        out["kernel_variant"] = run["kernel_variant"]
    if run.get("groups"):
        # a short stable signature, not the raw spec string: the flag
        # set rides every row and key, and the signature is what the
        # |grp: baseline-key tail needs (config.groups_signature)
        from ..config import groups_signature

        out["groups_sig"] = groups_signature(run["groups"])
        if run.get("group_transport") and \
                run["group_transport"] != "device_put":
            # non-default interface transport: part of the identity
            # AND the |gtx: baseline-key tail
            out["group_transport"] = run["group_transport"]
    return out


def _cli_label(run: Dict[str, Any]) -> str:
    parts = [str(run.get("stencil") or "run"),
             "x".join(map(str, run.get("grid") or ()))]
    if run.get("dtype"):
        parts.append(str(run["dtype"]))
    if run.get("fuse"):
        parts.append(f"fuse{run['fuse']}")
    if run.get("fuse_kind") and run["fuse_kind"] != "auto":
        parts.append(str(run["fuse_kind"]))
    if run.get("mesh"):
        parts.append("mesh" + "x".join(map(str, run["mesh"])))
    if run.get("overlap"):
        parts.append("overlap")
    if run.get("pipeline"):
        parts.append("pipeline")
    if run.get("exchange") and run["exchange"] != "ppermute":
        parts.append(str(run["exchange"]))
    if run.get("ensemble"):
        parts.append(f"ens{run['ensemble']}")
        if run.get("ensemble_mesh"):
            parts.append(f"ensmesh{run['ensemble_mesh']}")
    if run.get("kernel_variant"):
        parts.append(f"var{run['kernel_variant']}")
    if run.get("groups"):
        n = len([c for c in str(run["groups"]).split(",") if c.strip()])
        parts.append(f"grp{n}")
    return "cli_" + "_".join(p for p in parts if p)


def group_label(op: Any) -> str:
    """The per-group ledger row label: the op alone.

    Deliberately minimal — the clause signature in the flags
    (``groups_sig`` of the single clause's canonical form, with its mode
    tokens folded in) carries the full identity into the baseline key, so
    two clauses differing in ANYTHING (devices, z fraction, sub-mesh,
    dtype, ratio, modes) never share a baseline.
    """
    return f"cli_grp_{op}"


def group_flags(clause: str, transport: Optional[str] = None
                ) -> Dict[str, Any]:
    """The per-group ledger row flags for one canonical clause."""
    from ..config import groups_signature

    out: Dict[str, Any] = {"groups_sig": groups_signature(clause)}
    if transport and transport != "device_put":
        out["group_transport"] = transport
    return out


def _group_rows(manifest: Dict[str, Any], events: List[Dict[str, Any]],
                run: Dict[str, Any], prov: Dict[str, Any], source: str,
                hb: Optional[str], health: Optional[str]
                ) -> List[Dict[str, Any]]:
    """Per-group rows for one coupled CLI log.

    One row per group, valued at the group's wall-weighted mean Mcells/s
    over its ``group_chunk`` events.  Needs the manifest ``groups``
    block's ``clause`` entry (a run that died before any chunk adds
    nothing — the main coupled row still lands).
    """
    rows: List[Dict[str, Any]] = []
    transport = run.get("group_transport") or None
    for meta in manifest.get("groups") or []:
        if not isinstance(meta, dict) or not meta.get("clause"):
            continue
        name = meta.get("group")
        wall = 0.0
        weighted = 0.0
        last_t = None
        for e in events:
            if e.get("kind") != "group_chunk" or e.get("group") != name:
                continue
            w = e.get("wall_s")
            v = e.get("mcells_per_s")
            if not isinstance(w, (int, float)) or w <= 0 or \
                    not isinstance(v, (int, float)):
                continue
            wall += w
            weighted += v * w
            if e.get("t") is not None:
                last_t = e["t"]
        if wall <= 0:
            continue
        rows.append(make_row(
            group_label(meta.get("op")), round(weighted / wall, 3),
            source=source, measured_at=last_t, heartbeat=hb,
            health=health, expected_backend=prov.get("backend"),
            provenance=_prov_subset(prov),
            grid=meta.get("grid"), mesh=meta.get("mesh") or None,
            dtype=meta.get("dtype"),
            flags=group_flags(meta["clause"], transport),
            builder_rev=prov.get("builder_rev"),
            detail={"group": name, "clause": meta["clause"],
                    "modes": list(meta.get("modes") or [])}))
    return rows


def _prov_subset(prov: Dict[str, Any]) -> Dict[str, Any]:
    """The provenance a row carries: the reference's keys with the port's
    versions in place of ``jax_version``, and the card's name and power
    limit (``nvidia_smi``) beside every value."""
    return {k: prov.get(k) for k in ("git_sha", "backend", "device_kind",
                                     "device_count", "builder_rev",
                                     "torch_version", "cuda_version",
                                     "nvidia_smi")}


def rows_from_log(log_path: str) -> List[Dict[str, Any]]:
    """Ledger rows for one port CLI telemetry JSONL.

    Does NOT append — callers pair this with :func:`append_rows`
    (:func:`ingest_log`).  The manifest must be a port manifest (the
    port's validator); a log of another tool adds no row.
    """
    manifest, events = trace_lib.read_log(log_path)
    try:
        trace_lib.validate_manifest(manifest)
    except ValueError as e:
        raise ValueError(
            f"{log_path}: not a port telemetry log ({e}); a log of the "
            "TPU package goes into that package's ledger") from None
    if manifest["tool"] != "cli":
        return []
    run = manifest.get("run") or {}
    prov = manifest.get("provenance") or {}
    source = f"telemetry:{os.path.abspath(log_path)}"
    # newest heartbeat verdict anywhere in the log (summary included)
    hb = None
    for e in events:
        if e.get("kind") == "heartbeat":
            hb = e.get("verdict")
        elif e.get("kind") == "summary" and isinstance(
                e.get("heartbeat"), dict):
            hb = e["heartbeat"].get("verdict") or hb
    # health sentinel verdict (obs/health.py): once DIVERGED, every row
    # of this log quarantines with reason 'diverged' (a later HEALTHY
    # check cannot un-diverge a run; the CLI aborts at the first DIVERGED
    # boundary anyway)
    health = None
    for e in events:
        if e.get("kind") == "health":
            health = e.get("verdict") if health != "DIVERGED" else health
    rows: List[Dict[str, Any]] = []
    # a resumed run names its resume point in a 'resume' event; the row
    # detail carries it, so an after-restart value reads as honest but
    # restarted
    resumed_from = None
    for e in events:
        if e.get("kind") == "resume" and \
                e.get("resumed_from_step") is not None:
            resumed_from = e["resumed_from_step"]
    summaries = [e for e in events if e.get("kind") == "summary"]
    # run-doctor findings (obs/anomaly.py, --anomaly): a DEGRADED run's
    # value is honest — the steps ran, the number is real — so the row is
    # NOT quarantined, just flagged; clean runs add no detail key
    n_anomalies = sum(1 for e in events if e.get("kind") == "anomaly")
    if run.get("groups"):
        # per-group rows land ALONGSIDE the coupled headline row
        rows.extend(_group_rows(manifest, events, run, prov,
                                source, hb, health))
    for s in summaries:
        detail = {}
        if resumed_from is not None:
            detail["resumed_from_step"] = resumed_from
        if n_anomalies:
            detail["degraded"] = n_anomalies
        rows.append(make_row(
            _cli_label(run), s.get("mcells_per_s"), source=source,
            measured_at=s.get("t"), heartbeat=hb, health=health,
            expected_backend=prov.get("backend"),
            provenance=_prov_subset(prov),
            grid=run.get("grid"), mesh=run.get("mesh"),
            kind=run.get("fuse_kind"), dtype=run.get("dtype"),
            flags=_flags(run), builder_rev=prov.get("builder_rev"),
            detail=detail or None))
    if health == "DIVERGED" and not summaries:
        # a diverged run aborts before its summary — the row still lands
        # (value-less, quarantined 'diverged') so the ledger records that
        # this config BLEW UP rather than nothing
        div = [e for e in events if e.get("kind") == "health"
               and e.get("verdict") == "DIVERGED"]
        detail = {"health_reason": str(div[-1].get("reason"))[:200]} \
            if div and div[-1].get("reason") else None
        rows.append(make_row(
            _cli_label(run), None, source=source,
            measured_at=div[-1].get("t") if div else None,
            heartbeat=hb, health=health,
            expected_backend=prov.get("backend"),
            provenance=_prov_subset(prov),
            grid=run.get("grid"), mesh=run.get("mesh"),
            kind=run.get("fuse_kind"), dtype=run.get("dtype"),
            flags=_flags(run), builder_rev=prov.get("builder_rev"),
            detail=detail))
    return rows


def ingest_log(log_path: str, ledger_path: Optional[str] = None) -> int:
    """Parse one telemetry log and append its rows; returns rows added."""
    return append_rows(rows_from_log(log_path), ledger_path)


# ----------------------------------------------------------- baselines

def _best_order(row: Dict[str, Any]) -> Tuple[Any, ...]:
    """Total order for best_known: value, then measured_at, then the
    full key identity and source.  The trailing components never change
    WHICH measurement wins on merit — they only make ties impossible, so
    the winner is a pure function of the row SET, never of file order."""
    return (row["value"], row.get("measured_at") or 0,
            row.get("key_id") or key_id(row["key"]),
            str(row.get("source") or ""))


def best_known(rows: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Best ok value per (label, backend), with full row provenance.

    Quarantined rows are structurally excluded — the function reads
    ``status`` only, so no 0.0/errored/wedged record can ever surface as
    a baseline.  Ties are broken by the total order of
    :func:`_best_order`, never by file position.
    """
    best: Dict[str, Dict[str, Any]] = {}
    for r in rows:
        if r.get("status") != "ok":
            continue
        bk = baseline_key(r)
        cur = best.get(bk)
        if cur is None or _best_order(r) > _best_order(cur):
            best[bk] = r
    return best


def lookup_best(run: Dict[str, Any], backend: str,
                source: str) -> Optional[Dict[str, Any]]:
    """The ``best_known`` row for the run a RunConfig dict describes on
    ``backend``, or None (no ledger, no matching key): the seeding of the
    run doctor and the flight bundle.  ``source`` names the probe row."""
    rows = read_rows(default_ledger_path())
    if not rows:
        return None
    probe = make_row(_cli_label(run), 1.0, source=source,
                     expected_backend=backend, flags=_flags(run) or None)
    return best_known(rows).get(baseline_key(probe))


# ----------------------------------------------------------------- CLI

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpi_cuda_process_tpu_torch.obs.ledger",
        description=__doc__.split("\n")[0])
    ap.add_argument("--ledger", default=None,
                    help=f"ledger path (default {default_ledger_path()})")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_in = sub.add_parser("ingest", help="ingest one telemetry JSONL")
    p_in.add_argument("log")
    sub.add_parser("best", help="print best-known-value-with-provenance "
                                "per label x backend")
    a = ap.parse_args(argv)
    path = a.ledger or default_ledger_path()
    if a.cmd == "ingest":
        n = ingest_log(a.log, path)
        print(f"ledger ingest: {n} rows appended from {a.log} -> {path}")
        return 0
    rows = read_rows(path)
    best = best_known(rows)
    quarantined = sum(1 for r in rows if r["status"] == "quarantined")
    print(f"# {path}: {len(rows)} rows ({quarantined} quarantined), "
          f"{len(best)} baselines")
    for bk in sorted(best):
        r = best[bk]
        print(f"{bk:60s} {r['value']:>12} {r['unit']:9s} "
              f"src={r['source']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
