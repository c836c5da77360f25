"""Live run console: /metrics + /status.json + /events over the trace.

The port's counterpart of the TPU package's ``obs/serve.py``, behind the
CLI's ``--serve PORT``.  ``obs/metrics.py`` turns the telemetry event
stream into an aggregate; this module puts an HTTP face on it, so "is
the run wedged?" becomes a ``curl``, not a log read.  Endpoints:

* ``GET /metrics``     — Prometheus text exposition of the registry
  (steps/s, Gcells/s, the compile vs steady split, recompiles, the
  memory peak, heartbeat and health verdicts, and the ledger's
  ``obs_ledger_best_known{label,backend,unit}`` baselines);
* ``GET /status.json`` — the structured answer: manifest provenance,
  latest chunk, throughput, heartbeat and health verdicts (and under a
  multi-process launch one ``hosts`` row a process, ``obs/aggregate.py``);
* ``GET /events?after=SEQ[&wait=S]`` — incremental NDJSON tail of the
  merged event stream (each record annotated with ``_seq``); with
  ``wait`` the request long-polls (bounded — see ``MAX_WAIT_S``) until a
  new record lands or the wait expires;
* ``GET /`` — the index of the above.

Design constraints:

* **The server never touches the run.**  The run only writes its JSONL
  trace (exactly as before); a poller thread tails the file(s) with
  :class:`~.trace.LogTail` (complete lines only) and folds records into
  the registry.  Handlers read ONLY registry snapshots and the bounded
  event buffer, so ``--serve`` adds no launch and no op to the step
  (``tests/test_torch_serve.py`` pins the aten ops; chip_smoke.py phase
  5k the launch counters on the card).
* **Clean shutdown.**  :meth:`ObsServer.close` stops the poller, drains
  one final poll (the summary event), wakes parked long-polls, stops
  the HTTP loop and joins its threads (all named ``obs-serve*``) — a run
  exiting leaks nothing.

The reference's campaign console (``CampaignConsole``,
``serve_campaign``: a directory of measurement-harness logs) comes with
the port's measurement harness (ROADMAP A9).

Pure stdlib.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import metrics as metrics_lib
from .trace import LogTail

# Long-poll ceiling for /events?wait=S: bounded so a dying client can
# never pin a handler thread for long
MAX_WAIT_S = 25.0
MAX_EVENT_BATCH = 5000


class RunConsole:
    """The state behind the endpoints: tailed logs -> registry + buffer.

    ``watch(path)`` registers a JSONL trace (idempotent; the file may
    not exist yet — ``LogTail`` treats a missing file as empty).
    ``poll()`` drains every tail in registration order, assigns each
    new record a monotonically increasing ``seq``, folds it into
    :class:`~.metrics.RunMetrics`, and wakes long-poll waiters.
    """

    def __init__(self, max_events: int = 4096):
        self.metrics = metrics_lib.RunMetrics()
        self._cond = threading.Condition()
        self._tails: List[Tuple[str, LogTail]] = []
        self._watched: set = set()
        self._events: "collections.deque" = \
            collections.deque(maxlen=max_events)
        self.seq = 0  # seq of the newest buffered record (1-based)
        self.closed = False

    def close(self) -> None:
        """Wake every parked long-poll so shutdown never waits on one."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def watch(self, path: str) -> None:
        path = os.path.abspath(path)
        with self._cond:
            if path in self._watched:
                return
            self._watched.add(path)
            self._tails.append((path, LogTail(path)))

    def watched(self) -> List[str]:
        with self._cond:
            return [p for p, _ in self._tails]

    def poll(self) -> int:
        """Drain all tails once; returns the number of new records."""
        with self._cond:
            tails = list(self._tails)
        new: List[Tuple[str, Dict[str, Any]]] = []
        for path, tail in tails:
            new.extend((path, rec) for rec in tail.poll())
        if not new:
            return 0
        for path, rec in new:
            self._ingest(path, rec)
        with self._cond:
            for _path, rec in new:
                self.seq += 1
                self._events.append((self.seq, rec))
            self._cond.notify_all()
        return len(new)

    def _ingest(self, path: str, rec: Dict[str, Any]) -> None:
        """Per-record hook (source path attached): the base console
        folds everything into ONE merged RunMetrics; the aggregate
        console (obs/aggregate.py) also routes by origin so the
        per-host table stays separable."""
        self.metrics.ingest(rec)

    def status(self) -> Dict[str, Any]:
        """The ``/status.json`` payload (subclasses extend it — the
        aggregate console adds the per-host table)."""
        return self.metrics.status()

    def load_ledger(self, path: Optional[str] = None) -> int:
        """Fold the campaign ledger's ``best_known`` baselines into the
        registry as labeled gauges (``obs_ledger_best_known{label,
        backend,unit}``) so ``/metrics`` carries the ledger's baselines
        next to the live numbers.  Best-effort; returns baselines
        loaded."""
        from . import ledger as ledger_lib

        path = path or ledger_lib.default_ledger_path()
        try:
            best = ledger_lib.best_known(ledger_lib.read_rows(path))
        except Exception:  # noqa: BLE001 — the console serves without it
            return 0
        reg = self.metrics.registry
        with reg.lock:
            fam = reg.gauge_family(
                "obs_ledger_best_known",
                "campaign-ledger best known value per label x backend "
                "(quarantined rows structurally excluded)")
            for row in best.values():
                key = row.get("key") or {}
                try:
                    fam.set(float(row["value"]),
                            label=key.get("label"),
                            backend=key.get("backend"),
                            unit=row.get("unit"))
                except (TypeError, ValueError, KeyError):
                    continue
        return len(best)

    def events_after(self, after: int, limit: int = 1000,
                     wait_s: float = 0.0) -> List[Tuple[int, Dict[str, Any]]]:
        """Buffered records with seq > ``after`` (oldest first).

        With ``wait_s`` > 0 and nothing newer buffered, blocks until a
        new record lands or the (clamped) wait expires — the bounded
        long-poll.  Records older than the buffer are gone (the buffer
        is bounded); callers see the gap as a seq jump, never stale
        data replayed.
        """
        limit = max(1, min(int(limit), MAX_EVENT_BATCH))
        wait_s = max(0.0, min(float(wait_s), MAX_WAIT_S))
        deadline = time.monotonic() + wait_s
        with self._cond:
            while True:
                out = [(s, r) for s, r in self._events if s > after]
                if out or wait_s <= 0 or self.closed:
                    return out[:limit]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(min(remaining, 0.5))



class _Handler(BaseHTTPRequestHandler):
    server_version = "obs-serve/1"
    protocol_version = "HTTP/1.1"

    # the run's stderr is the run's; access logs would drown it
    def log_message(self, *args: Any) -> None:
        pass

    @property
    def console(self) -> RunConsole:
        return self.server.console  # type: ignore[attr-defined]

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; nothing to clean up

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/metrics":
                self._reply(200,
                            self.console.metrics.registry.to_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
            elif route in ("/status.json", "/status"):
                body = json.dumps(self.console.status(), default=str)
                self._reply(200, body, "application/json")
            elif route == "/events":
                self._events(url)
            elif route == "/":
                self._reply(200,
                            "obs live console\n"
                            "  /metrics      Prometheus text\n"
                            "  /status.json  provenance + latest chunk + "
                            "heartbeat + health (verdict DEGRADED = "
                            "run-doctor anomaly findings; hosts: one row "
                            "a process)\n"
                            "  /events?after=SEQ&wait=S  incremental "
                            "NDJSON tail (bounded long-poll)\n",
                            "text/plain; charset=utf-8")
            else:
                self._reply(404, f"no route {route!r}\n",
                            "text/plain; charset=utf-8")
        except Exception as e:  # noqa: BLE001 — a handler never kills
            try:
                self._reply(500, f"{type(e).__name__}: {e}\n",
                            "text/plain; charset=utf-8")
            except Exception:  # noqa: BLE001
                pass

    def _events(self, url) -> None:
        qs = parse_qs(url.query)

        def _num(key: str, default: float, cast) -> Any:
            try:
                return cast(qs[key][0])
            except (KeyError, IndexError, ValueError):
                return default

        after = _num("after", 0, int)
        wait_s = _num("wait", 0.0, float)
        limit = _num("limit", 1000, int)
        out = self.console.events_after(after, limit=limit, wait_s=wait_s)
        body = "".join(json.dumps({**rec, "_seq": seq}, default=str) + "\n"
                       for seq, rec in out)
        self._reply(200, body, "application/x-ndjson")


class ObsServer:
    """A ThreadingHTTPServer + log-poller pair around one console."""

    def __init__(self, console: RunConsole, port: int = 0,
                 host: str = "127.0.0.1", poll_s: float = 0.25):
        self.console = console
        self.poll_s = float(poll_s)
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.console = console  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._stop = threading.Event()
        self._closed = False
        console.poll()  # manifest visible before the first scrape
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-serve-http",
            daemon=True)
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="obs-serve-poll", daemon=True)
        self._http_thread.start()
        self._poll_thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.console.poll()
            except Exception:  # noqa: BLE001 — the watcher must survive
                pass            # anything a dying writer leaves behind

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop serving and join the threads.  Idempotent, never raises
        (runs on the teardown path of the run it watched)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._stop.set()
            self._poll_thread.join(join_timeout_s)
            try:
                self.console.poll()  # final drain: the summary event
            except Exception:  # noqa: BLE001
                pass
            self.console.close()  # wake parked long-polls (empty reply)
            self._httpd.shutdown()
            self._http_thread.join(join_timeout_s)
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 — teardown must not raise
            pass

    def __enter__(self) -> "ObsServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()




def _ledger_if_present(console: RunConsole) -> None:
    """Best-known baselines ride every served console when the default
    ledger exists (the ledger and the live console are ONE surface)."""
    from . import ledger as ledger_lib

    try:
        if os.path.exists(ledger_lib.default_ledger_path()):
            console.load_ledger()
    except Exception:  # noqa: BLE001 — never load-bearing
        pass


def serve_run(log_path: str, port: int = 0, host: str = "127.0.0.1",
              poll_s: float = 0.25) -> ObsServer:
    """Serve one run's telemetry log."""
    console = RunConsole()
    console.watch(log_path)
    _ledger_if_present(console)
    return ObsServer(console, port=port, host=host, poll_s=poll_s)


def serve_aggregate(paths: List[str], port: int = 0,
                    host: str = "127.0.0.1",
                    poll_s: float = 0.25) -> ObsServer:
    """Serve N per-process telemetry logs as ONE status page: the merged
    stream on /metrics and /events, plus the per-process table
    (``hosts``/``aggregate``) on /status.json (obs/aggregate.py)."""
    from . import aggregate as aggregate_lib

    console = aggregate_lib.make_console(paths)
    _ledger_if_present(console)
    return ObsServer(console, port=port, host=host, poll_s=poll_s)
