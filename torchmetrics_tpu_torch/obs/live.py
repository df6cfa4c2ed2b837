# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Live operational telemetry: background publisher + status-file/HTTP sinks.

Spans and counters drain to files you inspect AFTER a run; the device
telemetry plane materializes at compute/sync. A multi-hour
:class:`~torchmetrics_tpu_torch.robustness.runner.StreamingEvaluator` pass on a
preemptible fleet is a black box while it is ALIVE. This module adds the
live plane: an opt-in background :class:`TelemetryPublisher` thread that,
every ``cadence_s``, snapshots the counter/gauge registry (plus the span
ring's high-water/drop accounting and any registered :func:`probes <
register_probe>`) and publishes it two ways:

- **status files** — one atomic ``status.rank<k>.json`` per tick
  (temp + fsync + ``os.replace``, the ``store_format.py`` idiom) carrying the
  trace export's ``epoch_ns``/``mono_ns``/``pid``/``rank`` meta anchors, so
  ``metricscope watch <dir>`` can aggregate a whole fleet's files
  clock-aligned and flag a rank that stopped publishing;
- **HTTP** — an optional stdlib ``http.server`` endpoint (localhost by
  default) serving ``/metrics`` in OpenMetrics text format
  (:mod:`~torchmetrics_tpu_torch.obs.openmetrics`) and ``/healthz`` JSON whose
  HTTP status matches the derived liveness state.

**Liveness states** (:func:`derive_health`): ``ok`` | ``stalling`` |
``degraded`` | ``stalled``, derived from the runner's live watchdog margin
(sampled through a probe, so it decays in real time DURING a stalled update
— ``/healthz`` flips to ``stalled`` before ``StallError`` is even raised)
and the fault-tolerant sync's degrade/failure counters.

**Disabled-path contract** (same discipline as ``trace.ENABLED``): off — the
default — there is NO publisher thread and every producer call site is one
module-flag check with nothing allocated behind it. Opt in with
``TM_TPU_PUBLISH=<dir-or-host:port>`` in the environment (the runner checks
it once at construction) or scoped with :func:`publishing`.

Standalone (stdlib only, imports neither torch nor jax) like the rest of the obs package, so
``metricscope watch`` renders status files without paying the library import.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import counters as _counters
from . import openmetrics as _openmetrics
from . import trace as _trace
from .export import render_table as _render_table

#: THE flag every producer call site checks (``if live.ENABLED:``). True only
#: while a publisher is running; flip via enable()/disable()/publishing().
ENABLED: bool = False

#: status-payload layout version
STATUS_VERSION = 1

_DEFAULT_CADENCE_S = 1.0

#: watchdog-margin fractions the health derivation switches on: below
#: ``_STALLING_FRACTION`` of the deadline remaining the run is "stalling",
#: below ``_STALLED_FRACTION`` it is "stalled" — strictly before the margin
#: hits zero and ``StallError`` fires, so an external scraper sees the stall
#: while the process can still be inspected.
_STALLING_FRACTION = 0.5
_STALLED_FRACTION = 0.1

#: liveness state -> HTTP status for /healthz. ``stalling`` stays 200 (the
#: run is still making progress — it is an early warning, not a failure);
#: ``degraded`` (sync fell back to local-only state: reported values no
#: longer cover the fleet) and ``stalled`` are 503 so load-balancer-style
#: checks fail fast.
HEALTH_HTTP_STATUS = {"ok": 200, "stalling": 200, "degraded": 503, "stalled": 503}

_STATUS_RE = re.compile(r"^status\.rank(-?\d+)\.json$")

_lock = threading.Lock()
_probes: Dict[str, Callable[[], Dict[str, float]]] = {}
_publisher: Optional["TelemetryPublisher"] = None
_env_checked = False


# ------------------------------------------------------------------- probes


def register_probe(name: str, fn: Callable[[], Dict[str, float]]) -> None:
    """Register a live gauge source: ``fn()`` returns ``{gauge_name: value}``
    and is called on every publisher tick AND every ``/metrics``/``/healthz``
    request — unlike ``set_gauge`` values (which age between sets), a probe
    is always current. Last registration per name wins."""
    with _lock:
        _probes[name] = fn


def unregister_probe(name: str) -> None:
    with _lock:
        _probes.pop(name, None)


def probes() -> List[str]:
    """Names of the registered probes (for tests/diagnostics)."""
    with _lock:
        return sorted(_probes)


def sample_probes() -> Dict[str, float]:
    """One merged gauge dict from every registered probe. A raising probe is
    skipped and counted (``obs.live.probe_errors``) — the publisher thread
    must never die on a producer's bug."""
    with _lock:
        items = list(_probes.items())
    merged: Dict[str, float] = {}
    for _name, fn in items:
        try:
            merged.update(fn())
        except Exception:
            _counters.inc("obs.live.probe_errors")
    return merged


# ------------------------------------------------------------------- health


#: severity ladder — the derived state is the MOST severe signal, so a
#: degraded run (a latched condition: the counters never reset) can never be
#: reported healthier than "degraded" just because a long-but-fine step dips
#: into the stalling window: /healthz must not flap 503 -> 200 -> 503
_SEVERITY = {"ok": 0, "stalling": 1, "degraded": 2, "stalled": 3}
_SEVERITY_NAME = {code: name for name, code in _SEVERITY.items()}

#: numeric gauge codes → names for the serve plane's per-stream gauges
#: (mirrors serve.stream.STATE_CODES / CIRCUIT_CODES without importing the
#: serve package — this module stays dependency-light for the ctl plane)
_STREAM_STATE_NAME = {0: "starting", 1: "serving", 2: "draining", 3: "drained", 4: "failed"}
_CIRCUIT_NAME = {0: "closed", 1: "half_open", 2: "open"}

_SERVE_HEALTH_RE = re.compile(r"^serve\.(?P<stream>[^.]+)\.health_state$")

#: numeric codes of the federation plane's per-leaf ``fleet.leaf.<name>.state``
#: gauge (mirrors serve.federation.LEAF_STATE_CODES without importing it)
_LEAF_STATE_NAME = {0: "fresh", 1: "lagging", 2: "unreachable", 3: "quarantined"}

_FLEET_HEALTH_RE = re.compile(r"^fleet\.leaf\.(?P<leaf>[^.]+)\.health_state$")

#: the drift subsystem's per-stream severity gauge (0 ok / 1 warn /
#: 2 critical — drift.DRIFT_SEVERITY_STATES): warn floors health at
#: "stalling" (visible, still 200), critical at "degraded" (503) — a stream
#: scoring off-distribution is operationally equivalent to one serving from
#: a degraded store. Severity is computed with patience/recovery by the
#: metric, so this floor un-floors as soon as the live window returns.
_DRIFT_HEALTH_RE = re.compile(r"^drift\.(?P<stream>[^.]+)\.severity$")

#: drift severity code → the health state it floors to
_DRIFT_SEVERITY_HEALTH = {1: "stalling", 2: "degraded"}

#: the StateGuard's per-stream rollback-pressure gauge (0 ok / 1 one recent
#: rollback / 2 repeats inside the recovery window — serve.stream publishes
#: it from the rollback ring): one rollback is a survived incident and floors
#: at "stalling" (visible, still 200); repeats mean the upstream is actively
#: feeding poison and floor at "degraded" (503) until the window drains
_GUARD_HEALTH_RE = re.compile(r"^guard\.(?P<stream>[^.]+)\.health_state$")

_GUARD_CODE_HEALTH = {1: "stalling", 2: "degraded"}


def derive_health(counters: Dict[str, int], gauges: Dict[str, float]) -> Dict[str, Any]:
    """Liveness state from a counter/gauge snapshot (see the module table).

    Severity-monotone: ``stalled`` > ``degraded`` > ``stalling`` > ``ok``.
    When ``metricserve`` streams publish ``serve.<stream>.health_state``
    gauges (0 ok … 3 stalled), the process health is additionally floored at
    the WORST stream's state — a daemon is only as healthy as its sickest
    stream.
    """
    margin = gauges.get("runner.watchdog.margin_s")
    timeout = gauges.get("runner.watchdog.timeout_s")
    state, reason = "ok", None

    def escalate(candidate: str, why: str) -> None:
        nonlocal state, reason
        if _SEVERITY[candidate] > _SEVERITY[state]:
            state, reason = candidate, why

    degrades = counters.get("metric.sync.degrade", 0)
    failures = counters.get("metric.sync.failure", 0)
    stalls = counters.get("runner.watchdog_stall", 0)
    if margin is not None and timeout:
        fraction = margin / timeout
        if fraction <= _STALLED_FRACTION:
            escalate("stalled", f"watchdog margin {margin:.3f}s of {timeout:.3f}s — the in-flight step has stalled")
        elif fraction <= _STALLING_FRACTION:
            escalate("stalling", f"watchdog margin {margin:.3f}s of {timeout:.3f}s is shrinking")
    if degrades or failures:
        escalate(
            "degraded",
            f"sync degraded {degrades} time(s), failed {failures} time(s) — values may be local-only",
        )
    if stalls:
        escalate("stalled", f"watchdog raised StallError {stalls} time(s)")
    for name, value in gauges.items():
        match = _SERVE_HEALTH_RE.match(name)
        if match is not None:
            code = max(0, min(int(value), 3))
            if code:
                escalate(
                    _SEVERITY_NAME[code],
                    f"stream {match.group('stream')} is {_SEVERITY_NAME[code]}",
                )
            continue
        # drift floor: sustained distribution shift on a served stream is an
        # operational health state (warn -> stalling, critical -> degraded)
        match = _DRIFT_HEALTH_RE.match(name)
        if match is not None:
            floor = _DRIFT_SEVERITY_HEALTH.get(max(0, min(int(value), 2)))
            if floor is not None:
                psi = gauges.get(f"drift.{match.group('stream')}.psi")
                why = f"stream {match.group('stream')} is drifting"
                escalate(floor, why if psi is None else f"{why} (psi {psi:.3f})")
            continue
        # guard floor: poison-probe rollbacks on a served stream (state was
        # corrupted and restored from the known-good ring) — repeats read as
        # an actively-poisoning upstream
        match = _GUARD_HEALTH_RE.match(name)
        if match is not None:
            floor = _GUARD_CODE_HEALTH.get(max(0, min(int(value), 2)))
            if floor is not None:
                rollbacks = gauges.get(f"guard.{match.group('stream')}.rollbacks")
                why = f"stream {match.group('stream')} rolled back poisoned state"
                escalate(floor, why if rollbacks is None else f"{why} ({int(rollbacks)} rollback(s))")
            continue
        # fleet floor (federation aggregator probe): a process hosting an
        # aggregator is only as healthy as its sickest leaf
        match = _FLEET_HEALTH_RE.match(name)
        if match is not None:
            code = max(0, min(int(value), 3))
            if code:
                leaf = match.group("leaf")
                leaf_state = _LEAF_STATE_NAME.get(
                    int(gauges.get(f"fleet.leaf.{leaf}.state", -1)), _SEVERITY_NAME[code]
                )
                escalate(_SEVERITY_NAME[code], f"fleet leaf {leaf} is {leaf_state}")
    coverage = gauges.get("fleet.coverage")
    if coverage is not None and coverage < 1.0:
        escalate("degraded", f"fleet coverage {coverage:.2f} — the aggregate is partial")
    return {"state": state, "reason": reason, "http_status": HEALTH_HTTP_STATUS[state]}


def group_stream_gauges(gauges: Dict[str, float]) -> Dict[str, Dict[str, Any]]:
    """Group ``serve.<stream>.<field>`` gauges into ``{stream: {field: v}}``.

    Daemon-global serve gauges (``serve.streams``, ``serve.dropped_batches``
    — no field component) are left out; stream names never contain dots
    (the daemon enforces that at create time).
    """
    streams: Dict[str, Dict[str, Any]] = {}
    for name, value in gauges.items():
        if not name.startswith("serve."):
            continue
        rest = name[len("serve."):]
        stream, dot, field = rest.partition(".")
        if dot and stream and field:
            streams.setdefault(stream, {})[field] = value
    return streams


def group_fleet_gauges(gauges: Dict[str, float]) -> Dict[str, Dict[str, Any]]:
    """Group ``fleet.leaf.<name>.<field>`` gauges into ``{leaf: {field: v}}``
    (the federation aggregator's probe). Fleet-global gauges
    (``fleet.coverage``, ``fleet.leaves``, ``fleet.fold_seq``) are left out;
    leaf names never contain dots (the aggregator enforces that at
    ``add_leaf`` time)."""
    fleet: Dict[str, Dict[str, Any]] = {}
    for name, value in gauges.items():
        if not name.startswith("fleet.leaf."):
            continue
        rest = name[len("fleet.leaf."):]
        leaf, dot, field = rest.partition(".")
        if dot and leaf and field:
            fleet.setdefault(leaf, {})[field] = value
    return fleet


# ------------------------------------------------------- file-sink plumbing


def status_filename(rank: int) -> str:
    return f"status.rank{int(rank)}.json"


def _atomic_write_bytes(path: str, data: bytes) -> None:
    # store_format.atomic_write's idiom, re-implemented so obs stays a
    # standalone package: temp sibling + fsync + os.replace — a reader (or a
    # concurrent `metricscope watch`) never observes a torn status file
    directory = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _detect_rank() -> int:
    """Process rank WITHOUT importing torch: ``torch.distributed``'s rank
    when the host program already imported it and initialised a process
    group (the obs package must stay importable standalone)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank())
        except Exception:
            pass
    try:
        return int(os.environ.get("TM_TPU_RANK", "0"))
    except ValueError:
        return 0


# ---------------------------------------------------------------- publisher


class TelemetryPublisher:
    """Background thread publishing periodic status snapshots.

    Args:
        directory: file sink — one atomic ``status.rank<k>.json`` per tick
            (``None`` disables the file sink).
        http: HTTP sink — ``"host:port"`` / ``":port"`` / bare port int,
            default host ``127.0.0.1``, port 0 binds an ephemeral port
            (``None`` disables the HTTP sink). Serves ``/metrics``
            (OpenMetrics) and ``/healthz`` (JSON, status-mapped).
        cadence_s: tick period for the file sink (HTTP renders on demand).
        rank: process rank for the file name and the ``rank`` label;
            default auto-detects (the ``torch.distributed`` rank if a group is
            initialised, else ``TM_TPU_RANK``, else 0).
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        http: Optional[Any] = None,
        cadence_s: float = _DEFAULT_CADENCE_S,
        rank: Optional[int] = None,
    ) -> None:
        if directory is None and http is None:
            raise ValueError("TelemetryPublisher needs a directory and/or an http address")
        if cadence_s <= 0:
            raise ValueError(f"cadence_s must be > 0, got {cadence_s}")
        self.directory = None if directory is None else str(directory)
        self.cadence_s = float(cadence_s)
        self.rank = _detect_rank() if rank is None else int(rank)
        self.seq = 0
        self.publish_errors = 0
        self._http_spec = http
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._server = None
        self._server_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- payloads
    def status(self) -> Dict[str, Any]:
        """One self-contained status payload: registry snapshot + live probe
        samples + ring accounting + derived health, anchored with the same
        ``epoch_ns``/``mono_ns``/``pid``/``rank`` meta fields trace exports
        carry — so multi-rank aggregation clock-aligns status files exactly
        like trace merges."""
        snap = _counters.snapshot(include_ts=True)
        mono_ns = time.monotonic_ns()
        gauge_age_s = {
            name: max(0.0, (mono_ns - ts) / 1e9) for name, ts in snap.get("gauge_ts_mono_ns", {}).items()
        }
        live_gauges = sample_probes()
        gauges = {**snap["gauges"], **live_gauges}
        for name in live_gauges:
            gauge_age_s[name] = 0.0  # probes are sampled at publish time
        health = derive_health(snap["counters"], gauges)
        return {
            "type": "status",
            "status_version": STATUS_VERSION,
            "seq": self.seq,
            "epoch_ns": time.time_ns(),
            "mono_ns": time.perf_counter_ns(),
            "pid": os.getpid(),
            "rank": self.rank,
            "cadence_s": self.cadence_s,
            "counters": snap["counters"],
            "gauges": gauges,
            "gauge_age_s": gauge_age_s,
            "ring": {"high_water": _trace.high_water(), "dropped": _trace.dropped_events()},
            "health": health,
        }

    def health(self) -> Dict[str, Any]:
        """Fresh liveness derivation (probes sampled now), plus the runner's
        cursor when a runner probe is live — the ``/healthz`` body. When a
        ``metricserve`` daemon publishes ``serve.<stream>.*`` gauges, the body
        carries a ``streams`` section with the per-stream detail behind the
        worst-stream summary state."""
        snap = _counters.snapshot()
        gauges = {**snap["gauges"], **sample_probes()}
        health = derive_health(snap["counters"], gauges)
        health["rank"] = self.rank
        health["seq"] = self.seq
        if "runner.cursor" in gauges:
            health["cursor"] = int(gauges["runner.cursor"])
        streams = group_stream_gauges(gauges)
        if streams:
            for detail in streams.values():
                code = max(0, min(int(detail.get("health_state", 0)), 3))
                # "health" is the severity NAME; "state" stays the numeric
                # lifecycle gauge (serve.stream.STATE_CODES)
                detail["health"] = _SEVERITY_NAME[code]
            health["streams"] = streams
        fleet = group_fleet_gauges(gauges)
        if fleet:
            for detail in fleet.values():
                detail["leaf_state"] = _LEAF_STATE_NAME.get(int(detail.get("state", 0)), "fresh")
                code = max(0, min(int(detail.get("health_state", 0)), 3))
                detail["health"] = _SEVERITY_NAME[code]
            health["fleet"] = {
                "coverage": gauges.get("fleet.coverage"),
                "leaves": fleet,
            }
        return health

    def render_metrics(self) -> str:
        """The current registry + probes as one OpenMetrics exposition."""
        payload = self.status()
        now_epoch_s = payload["epoch_ns"] / 1e9
        gauge_epoch_s = {k: now_epoch_s - age for k, age in payload["gauge_age_s"].items()}
        counters = dict(payload["counters"])
        gauges = dict(payload["gauges"])
        # the derived health state rides along as a numeric gauge so scrapers
        # can alert on it: 0 ok, 1 stalling, 2 degraded, 3 stalled
        state_code = {"ok": 0, "stalling": 1, "degraded": 2, "stalled": 3}[payload["health"]["state"]]
        gauges["obs.live.health_state"] = state_code
        gauges["obs.live.seq"] = payload["seq"]
        # the SAME name trace exports publish as a registry gauge — assigning
        # (not adding a spelled-differently twin) overwrites any stale copy,
        # so the exposition never carries duplicate samples of one family
        gauges["obs.trace.ring_high_water"] = payload["ring"]["high_water"]
        gauge_epoch_s["obs.trace.ring_high_water"] = now_epoch_s
        counters["obs.trace.ring_dropped"] = payload["ring"]["dropped"]
        return _openmetrics.render(counters, gauges, labels={"rank": str(self.rank)}, gauge_epoch_s=gauge_epoch_s)

    # ------------------------------------------------------------ lifecycle
    def tick(self, final: bool = False) -> Dict[str, Any]:
        """Publish one status snapshot now (the loop calls this per cadence).

        ``final=True`` marks the payload — the drain-final tick :meth:`stop`
        publishes after the thread exits — so consumers of the post-stop
        ``status.rank<k>.json`` can tell "the run ended here" from "the
        publisher just has not ticked yet"."""
        payload = self.status()
        if final:
            payload["final"] = True
        self.seq += 1
        if self.directory is not None:
            data = json.dumps(payload, separators=(",", ":")).encode()
            try:
                _atomic_write_bytes(os.path.join(self.directory, status_filename(self.rank)), data)
            except OSError:
                self.publish_errors += 1
        return payload

    def _loop(self) -> None:
        while not self._stop.wait(self.cadence_s):
            try:
                self.tick()
            except Exception:
                self.publish_errors += 1  # the publisher thread must outlive any tick bug

    def start(self) -> "TelemetryPublisher":
        if self.directory is not None:
            os.makedirs(self.directory, exist_ok=True)
        if self._http_spec is not None:
            self._start_http(self._http_spec)
        self.tick()  # an immediate first snapshot: the file exists before the first cadence
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tm-tpu-telemetry-publisher")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread (one final flush tick — published AFTER the loop
        thread has joined, so the on-disk status file reflects the drain-final
        counters/cursor/health, marked ``"final": true``) and shut the HTTP
        server down."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        try:
            self.tick(final=True)
        except Exception:
            self.publish_errors += 1
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            if self._server_thread is not None:
                self._server_thread.join(timeout=10.0)
            self._server = None
            self._server_thread = None

    # ----------------------------------------------------------------- http
    def http_address(self) -> Optional[Tuple[str, int]]:
        """``(host, port)`` actually bound — port 0 (ephemeral) resolves to
        the real port here, so concurrent publishers/daemons can each bind
        ``http=":0"`` and discover where they landed — or ``None`` while no
        HTTP sink is up."""
        if self._server is None:
            return None
        return self._server.server_address[:2]

    def _start_http(self, spec: Any) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        host, port = _parse_http_spec(spec)
        publisher = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:  # silence per-request stderr
                pass

            def _send(self, code: int, content_type: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, _openmetrics.CONTENT_TYPE, publisher.render_metrics().encode())
                    elif path == "/healthz":
                        health = publisher.health()
                        self._send(health["http_status"], "application/json", json.dumps(health).encode())
                    else:
                        self._send(404, "text/plain", b"metricscope live plane: /metrics or /healthz\n")
                except Exception:
                    publisher.publish_errors += 1

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="tm-tpu-telemetry-http"
        )
        self._server_thread.start()


def _parse_http_spec(spec: Any) -> Tuple[str, int]:
    if isinstance(spec, int):
        return "127.0.0.1", spec
    text = str(spec)
    host, _, port_s = text.rpartition(":")
    return host or "127.0.0.1", int(port_s)


# --------------------------------------------------------- module lifecycle


def enable(
    directory: Optional[str] = None,
    http: Optional[Any] = None,
    cadence_s: float = _DEFAULT_CADENCE_S,
    rank: Optional[int] = None,
) -> TelemetryPublisher:
    """Start THE process publisher and flip :data:`ENABLED`. One publisher
    per process: enabling twice replaces the first (stopping it)."""
    global ENABLED, _publisher
    disable()
    _publisher = TelemetryPublisher(directory=directory, http=http, cadence_s=cadence_s, rank=rank).start()
    ENABLED = True
    return _publisher


def disable() -> None:
    """Stop the publisher (final flush included) and clear :data:`ENABLED`."""
    global ENABLED, _publisher
    ENABLED = False
    if _publisher is not None:
        publisher, _publisher = _publisher, None
        publisher.stop()


def publisher() -> Optional[TelemetryPublisher]:
    return _publisher


def is_enabled() -> bool:
    return ENABLED


@contextmanager
def publishing(
    directory: Optional[str] = None,
    http: Optional[Any] = None,
    cadence_s: float = _DEFAULT_CADENCE_S,
    rank: Optional[int] = None,
) -> Iterator[TelemetryPublisher]:
    """Scoped live publishing: ``with obs.publishing("/tmp/status"): ev.run(...)``."""
    pub = enable(directory=directory, http=http, cadence_s=cadence_s, rank=rank)
    try:
        yield pub
    finally:
        disable()


def maybe_enable_from_env() -> Optional[TelemetryPublisher]:
    """Honor ``TM_TPU_PUBLISH=<dir-or-host:port>`` exactly once per process.

    A value shaped like ``host:port`` / ``:port`` becomes the HTTP sink;
    anything else is the status-file directory. ``TM_TPU_PUBLISH_CADENCE_S``
    overrides the tick period. Called by producers at construction time
    (NOT at import: starting a thread from an import is a side effect the
    obs package must not have) — the repeated-call cost is one bool check.
    """
    global _env_checked
    if _env_checked or ENABLED:
        return _publisher
    _env_checked = True
    value = os.environ.get("TM_TPU_PUBLISH", "").strip()
    if not value:
        return None
    try:
        cadence_s = float(os.environ.get("TM_TPU_PUBLISH_CADENCE_S", str(_DEFAULT_CADENCE_S)))
    except ValueError:
        cadence_s = _DEFAULT_CADENCE_S
    if re.match(r"^[^/\\]*:\d+$", value):
        return enable(http=value, cadence_s=cadence_s)
    return enable(directory=value, cadence_s=cadence_s)


# ------------------------------------------------------------ watch consumer


def read_status_dir(directory: str) -> List[Dict[str, Any]]:
    """Parse every ``status.rank<k>.json`` in ``directory``, sorted by rank.

    Unparseable files are skipped with a ``_problem`` placeholder row rather
    than hiding a rank that IS publishing, however damaged.
    """
    try:
        names = sorted(os.listdir(directory))
    except OSError as err:
        raise FileNotFoundError(f"cannot read status directory {directory}: {err}") from err
    statuses: List[Dict[str, Any]] = []
    for name in names:
        match = _STATUS_RE.match(name)
        if not match:
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as fh:
                payload = json.load(fh)
            if not isinstance(payload, dict):
                raise ValueError(f"payload is a {type(payload).__name__}")
        except (OSError, ValueError) as err:
            statuses.append({"rank": int(match.group(1)), "_problem": str(err), "_path": path})
            continue
        payload.setdefault("rank", int(match.group(1)))
        payload["_path"] = path
        statuses.append(payload)
    statuses.sort(key=lambda s: s.get("rank", 0))
    return statuses


def _fmt_num(value: Any, pattern: str = "{:.1f}") -> str:
    if value is None:
        return "-"
    if isinstance(value, int) or (isinstance(value, float) and value.is_integer() and abs(value) < 1e12):
        return str(int(value))
    return pattern.format(value)


def format_watch_table(statuses: List[Dict[str, Any]], stale_after_s: float = 10.0) -> str:
    """Render the per-rank dashboard ``metricscope watch`` prints.

    Stale-rank detection is **fleet-relative** via the payloads' ``epoch_ns``
    wall-clock anchors: a rank whose last status is more than
    ``stale_after_s`` behind the NEWEST rank's has stopped publishing while
    the fleet moved on — flagged ``STALE`` (comparing against the viewer's
    own clock would flag every rank of a finished run). The footer reports
    how long ago the fleet as a whole last published.
    """
    if not statuses:
        return "(no status.rank<k>.json files found)"
    anchored = [s for s in statuses if isinstance(s.get("epoch_ns"), int)]
    ref_epoch_ns = max(s["epoch_ns"] for s in anchored) if anchored else None

    header = (
        "rank", "state", "batches", "samples", "samples/s", "cursor",
        "snap_age_s", "snap_bytes", "state_bytes", "occup", "margin_s", "behind_s", "flags",
    )
    rows = [header]
    stream_rows: List[Tuple[str, ...]] = []
    fleet_rows: List[Tuple[str, ...]] = []
    n_stale = 0
    states: Dict[str, int] = {}
    for status in statuses:
        rank = str(status.get("rank", "?"))
        if "_problem" in status:
            rows.append((rank, "unreadable", "-", "-", "-", "-", "-", "-", "-", "-", "-", "-", "UNREADABLE"))
            states["unreadable"] = states.get("unreadable", 0) + 1
            continue
        counters = status.get("counters", {})
        gauges = status.get("gauges", {})
        health = status.get("health", {})
        state = health.get("state", "?")
        flags = []
        behind_s = None
        if ref_epoch_ns is not None and isinstance(status.get("epoch_ns"), int):
            behind_s = (ref_epoch_ns - status["epoch_ns"]) / 1e9
            if behind_s > stale_after_s:
                flags.append("STALE")
                n_stale += 1
        elif ref_epoch_ns is not None:
            flags.append("UNANCHORED")  # old/foreign payload: not clock-comparable
        states[state] = states.get(state, 0) + 1
        # state-memory footprint: prefer the deduplicated process total the
        # attribution boundary publishes (compute-group-shared arrays counted
        # once); older payloads fall back to summing the per-class gauges.
        # None when the run never hit a boundary (or predates the gauges)
        state_total = gauges.get("metric.state_bytes_total")
        state_gauges = [state_total] if state_total is not None else [
            v for k, v in gauges.items() if k.startswith("metric.") and k.endswith(".state_bytes")
        ]
        rows.append((
            rank,
            state,
            _fmt_num(counters.get("runner.progress.batches")),
            _fmt_num(counters.get("runner.progress.samples")),
            _fmt_num(gauges.get("runner.throughput.samples_per_s"), "{:.1f}"),
            _fmt_num(gauges.get("runner.cursor")),
            _fmt_num(gauges.get("runner.snapshot.age_s"), "{:.1f}"),
            _fmt_num(gauges.get("runner.snapshot.bytes_last")),
            _fmt_num(sum(state_gauges) if state_gauges else None),
            # sliced-plane table occupancy (0..1, rendered %): "-" for runs
            # without a slice table, 100% + growing spills = undersized table
            "-" if gauges.get("slice.table.occupancy") is None
            else "{:.0f}%".format(100.0 * gauges["slice.table.occupancy"]),
            _fmt_num(gauges.get("runner.watchdog.margin_s"), "{:.2f}"),
            "-" if behind_s is None else f"{behind_s:.1f}",
            ",".join(flags),
        ))
        for stream, detail in sorted(group_stream_gauges(gauges).items()):
            health_code = max(0, min(int(detail.get("health_state", 0)), 3))
            stream_rows.append((
                rank,
                stream,
                _SEVERITY_NAME[health_code],
                _STREAM_STATE_NAME.get(int(detail.get("state", 0)), "?"),
                _fmt_num(detail.get("cursor")),
                _fmt_num(detail.get("pending")),
                _fmt_num(detail.get("queue_depth")),
                _fmt_num(detail.get("restarts")),
                _CIRCUIT_NAME.get(int(detail.get("circuit_state", 0)), "?"),
                _fmt_num(detail.get("deadletter_depth")),
                # durability gauge: 1.0 = snapshots land on disk, 0 = the
                # stream degraded to in-memory-only (or its dead-letter file
                # is behind) — the "is my state durable" column
                "-" if detail.get("durability") is None
                else ("yes" if detail["durability"] else "NO"),
                _fmt_num(detail.get("dropped")),
            ))
        fleet = group_fleet_gauges(gauges)
        if fleet:
            # the fleet tree: one aggregator row (coverage + leaf-state
            # tallies), then one indented row per leaf grouped under it
            coverage = gauges.get("fleet.coverage")
            leaf_states = {leaf: int(detail.get("state", 0)) for leaf, detail in fleet.items()}
            worst = max((int(d.get("health_state", 0)) for d in fleet.values()), default=0)
            fleet_rows.append((
                rank,
                "fleet",
                _SEVERITY_NAME[max(0, min(worst, 3))],
                "-" if coverage is None else "{:.0f}%".format(100.0 * coverage),
                _fmt_num(gauges.get("fleet.leaves", len(fleet))),
                _fmt_num(sum(1 for s in leaf_states.values() if s == 1)),
                _fmt_num(sum(1 for s in leaf_states.values() if s == 3)),
                _fmt_num(sum(int(d.get("streams", 0)) for d in fleet.values())),
                _fmt_num(gauges.get("fleet.fold_seq")),
            ))
            for leaf, detail in sorted(fleet.items()):
                code = max(0, min(int(detail.get("health_state", 0)), 3))
                state_code = int(detail.get("state", 0))
                fleet_rows.append((
                    rank,
                    f"└ {leaf}",
                    _SEVERITY_NAME[code],
                    _LEAF_STATE_NAME.get(state_code, "?"),
                    "-",
                    "yes" if state_code == 1 else "-",
                    "yes" if state_code == 3 else "-",
                    _fmt_num(detail.get("streams")),
                    "-",
                ))
    lines = _render_table(rows)
    if stream_rows:
        stream_header = (
            "rank", "stream", "health", "state", "cursor", "pending", "queue",
            "restarts", "circuit", "deadletter", "durable", "dropped",
        )
        lines.append("")
        lines.extend(_render_table([stream_header, *stream_rows]))
    if fleet_rows:
        fleet_header = (
            "rank", "fleet/leaf", "health", "state/cov", "leaves",
            "lagging", "quarantined", "streams", "fold_seq",
        )
        lines.append("")
        lines.extend(_render_table([fleet_header, *fleet_rows]))
    summary = ", ".join(f"{n} {state}" for state, n in sorted(states.items()))
    lines.append("")
    lines.append(f"{len(statuses)} rank(s): {summary}" + (f"; {n_stale} STALE (> {stale_after_s:.1f}s behind)" if n_stale else ""))
    if ref_epoch_ns is not None:
        lines.append(f"fleet last published {max(0.0, (time.time_ns() - ref_epoch_ns) / 1e9):.1f}s ago")
    return "\n".join(lines)


def format_watch_json(statuses: List[Dict[str, Any]], stale_after_s: float = 10.0) -> str:
    """The ``metricscope watch --json`` output: one compact JSON object per
    line — a ``{"kind": "rank", ...}`` row per status file, followed by a
    ``{"kind": "stream", ...}`` row per ``serve.<stream>.*`` gauge family and
    a ``{"kind": "leaf", ...}`` row per ``fleet.leaf.<name>.*`` family the
    rank publishes — so supervisors and ``metricserve ctl status`` consume
    fleet state line-by-line instead of scraping the human table. Staleness
    is the same fleet-relative ``epoch_ns`` comparison as the table."""
    anchored = [s for s in statuses if isinstance(s.get("epoch_ns"), int)]
    ref_epoch_ns = max(s["epoch_ns"] for s in anchored) if anchored else None
    lines: List[str] = []
    for status in statuses:
        rank = status.get("rank")
        if "_problem" in status:
            lines.append(json.dumps(
                {"kind": "rank", "rank": rank, "state": "unreadable", "problem": status["_problem"]},
                separators=(",", ":"),
            ))
            continue
        counters = status.get("counters", {})
        gauges = status.get("gauges", {})
        behind_s = None
        if ref_epoch_ns is not None and isinstance(status.get("epoch_ns"), int):
            behind_s = (ref_epoch_ns - status["epoch_ns"]) / 1e9
        row: Dict[str, Any] = {
            "kind": "rank",
            "rank": rank,
            "seq": status.get("seq"),
            "state": status.get("health", {}).get("state"),
            "reason": status.get("health", {}).get("reason"),
            "final": bool(status.get("final", False)),
            "batches": counters.get("runner.progress.batches"),
            "samples": counters.get("runner.progress.samples"),
            "samples_per_s": gauges.get("runner.throughput.samples_per_s"),
            "cursor": gauges.get("runner.cursor"),
            "snapshot_age_s": gauges.get("runner.snapshot.age_s"),
            "snapshot_bytes": gauges.get("runner.snapshot.bytes_last"),
            "watchdog_margin_s": gauges.get("runner.watchdog.margin_s"),
            "behind_s": behind_s,
            "stale": bool(behind_s is not None and behind_s > stale_after_s),
        }
        lines.append(json.dumps(row, separators=(",", ":")))
        for stream, detail in sorted(group_stream_gauges(gauges).items()):
            code = max(0, min(int(detail.get("health_state", 0)), 3))
            stream_row: Dict[str, Any] = {
                "kind": "stream",
                "rank": rank,
                "stream": stream,
                # severity NAME under "health"; detail's "state" stays the
                # numeric lifecycle gauge (serve.stream.STATE_CODES)
                "health": _SEVERITY_NAME[code],
            }
            stream_row.update(sorted(detail.items()))
            if "circuit_state" in detail:
                stream_row["circuit"] = _CIRCUIT_NAME.get(int(detail["circuit_state"]), "?")
            lines.append(json.dumps(stream_row, separators=(",", ":")))
        fleet = group_fleet_gauges(gauges)
        if fleet:
            # the same hierarchy as the table: ONE aggregator row with the
            # coverage/lagging/quarantined tallies, then its leaves
            leaf_states = {leaf: int(detail.get("state", 0)) for leaf, detail in fleet.items()}
            worst = max(0, min(max((int(d.get("health_state", 0)) for d in fleet.values()), default=0), 3))
            lines.append(json.dumps({
                "kind": "fleet",
                "rank": rank,
                "health": _SEVERITY_NAME[worst],
                "coverage": gauges.get("fleet.coverage"),
                "leaves": gauges.get("fleet.leaves", len(fleet)),
                "lagging": sum(1 for s in leaf_states.values() if s == 1),
                "quarantined": sum(1 for s in leaf_states.values() if s == 3),
                "streams": sum(int(d.get("streams", 0)) for d in fleet.values()),
                "fold_seq": gauges.get("fleet.fold_seq"),
            }, separators=(",", ":")))
        for leaf, detail in sorted(fleet.items()):
            code = max(0, min(int(detail.get("health_state", 0)), 3))
            leaf_row: Dict[str, Any] = {
                "kind": "leaf",
                "rank": rank,
                "leaf": leaf,
                "health": _SEVERITY_NAME[code],
                "leaf_state": _LEAF_STATE_NAME.get(int(detail.get("state", 0)), "?"),
                "coverage": gauges.get("fleet.coverage"),
            }
            leaf_row.update(sorted(detail.items()))
            lines.append(json.dumps(leaf_row, separators=(",", ":")))
    return "\n".join(lines)
