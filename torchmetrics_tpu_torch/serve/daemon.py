# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The ``metricserve`` daemon: registry + control plane + ingest plane
(counterpart of ``torchmetrics_tpu/serve/daemon.py``).

:class:`ServeDaemon` multiplexes many :class:`~torchmetrics_tpu_torch.serve.stream.
Stream`\\ s under one base directory::

    <base_dir>/
      streams/<name>/spec.json    # the declarative StreamSpec — restart fuel
      streams/<name>/store/       # the stream's CheckpointStore
      streams/<name>/costs.json   # cost ledger, written at compute boundaries
      status/                     # live-plane status.rank<k>.json files

and exposes two planes:

- **control** — localhost HTTP (``/v1/streams`` CRUD + ingest/flush/drain,
  plus the repair verbs ``revive`` — half-open a parked stream's circuit
  breaker — and ``deadletter`` list/requeue/purge for the poison-batch
  quarantine; ``/healthz`` and ``/metrics`` riding the live-plane publisher;
  health is the WORST stream via the ``serve.<name>.health_state`` gauges),
  port 0 by default so concurrent daemons never collide;
- **ingest** — a newline-JSON unix-socket fast path (one wire frame per
  line, blocking-with-deadline backpressure instead of HTTP 429 retries).

**Restart = resume.** ``start()`` re-creates every stream whose
``spec.json`` survives under ``streams/``; each evaluator restores through
the validate-all-then-apply ladder and the create/status responses carry
``next_seq`` so clients replay exactly the unpersisted suffix.

**Drain discipline.** ``shutdown(drain=True)`` (the SIGTERM path) stops
admitting, then drains streams **sequentially in sorted-name order** — on a
multi-host deployment every rank walks the same order, so the collective
sync inside each final ``compute()`` lines up across ranks — and finishes
with one final telemetry tick so the last ``status.rank<k>.json`` carries
the drain-final counters.

Chaos hooks: ``serve.accept`` fires on stream create, ``serve.ingest`` on
every admission, ``serve.drain`` at each stream drain (see
:mod:`torchmetrics_tpu_torch.robustness.faults`).

**The device.** Every stream of a daemon runs on the daemon's ``device``
(default ``"cuda"``; without a card that raises). The wire, the base
directory's layout and every reply are the JAX package's, byte for byte:
JAX's ``tools/metricserve.py ctl`` drives a port daemon, and either package's
daemon restarts over the other's base directory.
"""
from __future__ import annotations

import json
import os
import shutil
import socketserver
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.obs import attribution as _obs_attr
from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.serve import wire
from torchmetrics_tpu_torch.serve.stream import Stream, StreamSpec
from torchmetrics_tpu_torch.utilities.data import resolve_device

__all__ = ["ServeDaemon"]


class ServeDaemon:
    """One always-on eval service over one base directory.

    Args:
        base_dir: durable root (created on start); layout above.
        http: control-plane bind — ``"host:port"`` / ``":port"`` / int port;
            default ``127.0.0.1:0`` (ephemeral; read the bound address off
            :meth:`http_address`).
        socket_path: unix-socket ingest path, ``None`` disables the socket
            plane (HTTP ingest still works).
        publish: start the live plane (status files under
            ``<base_dir>/status``) if it is not already on; the daemon then
            owns the publisher and stops it (final tick included) at
            shutdown.
        rank: process rank label for stores/status (default auto-detect).
        device: the device every stream runs on (default ``"cuda"``; pass
            ``"cpu"`` to serve on the host).
    """

    def __init__(
        self,
        base_dir: str,
        http: Any = ":0",
        socket_path: Optional[str] = None,
        publish: bool = True,
        rank: Optional[int] = None,
        device: Any = "cuda",
    ) -> None:
        self.base_dir = str(base_dir)
        self.device = resolve_device(device, "ServeDaemon", "Pass device='cpu' (or --device cpu) to serve on the CPU.")
        self._http_spec = http
        self.socket_path = None if socket_path is None else str(socket_path)
        self._publish = bool(publish)
        self._rank = rank
        #: per-boot nonce stamped on every state export and on ``/healthz`` —
        #: a federation fold never mixes two boots' windows, and a restarted
        #: leaf's replayed prefix dedups against the epoch change
        self.epoch: Optional[str] = None
        self._streams: Dict[str, Stream] = {}
        self._creating: set = set()  # names reserved while their dir/store is built
        self._lock = threading.Lock()
        self._accepting = False
        self._owns_publisher = False
        self._http_server: Any = None
        self._http_thread: Optional[threading.Thread] = None
        self._sock_server: Any = None
        self._sock_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeDaemon":
        # fresh epoch per boot — state exported before a crash can never be
        # confused with state exported after the restart's replay
        self.epoch = uuid.uuid4().hex[:12]
        os.makedirs(os.path.join(self.base_dir, "streams"), exist_ok=True)
        if self._publish and not _obs_live.ENABLED:
            _obs_live.enable(directory=os.path.join(self.base_dir, "status"), rank=self._rank)
            self._owns_publisher = True
        _obs_live.register_probe("metricserve", self._probe)
        self._restore_streams()
        self._accepting = True
        self._start_http()
        if self.socket_path is not None:
            self._start_socket()
        return self

    def _restore_streams(self) -> None:
        """Restart fuel: re-create every stream whose spec.json survives,
        sorted so multi-rank restarts open stores in the same order."""
        root = os.path.join(self.base_dir, "streams")
        for name in sorted(os.listdir(root)):
            spec_path = os.path.join(root, name, "spec.json")
            if not os.path.isfile(spec_path):
                continue
            with open(spec_path) as fh:
                spec = StreamSpec.from_wire(json.load(fh))
            stream = Stream(spec, os.path.join(root, name, "store"), self.device)
            stream.start()
            self._streams[spec.name] = stream

    def shutdown(self, drain: bool = True) -> Dict[str, Any]:
        """The SIGTERM path: stop admitting, drain every stream (sorted —
        deterministic collective order across ranks), emit per-stream costs,
        publish one final telemetry tick, then close the servers."""
        self._accepting = False
        results: Dict[str, Any] = {}
        with self._lock:
            streams = sorted(self._streams.items())
        for name, stream in streams:
            if drain:
                results[name] = stream.drain()
                self._emit_costs(name)
            else:
                stream.abandon()
        if self._owns_publisher:
            # the probe is still registered: the publisher's final tick
            # carries the drain-final serve.<name>.* gauges
            _obs_live.disable()
            self._owns_publisher = False
        _obs_live.unregister_probe("metricserve")
        self._stop_servers()
        return results

    def _stop_servers(self) -> None:
        for server, thread in ((self._http_server, self._http_thread), (self._sock_server, self._sock_thread)):
            if server is not None:
                server.shutdown()
                server.server_close()
                if thread is not None:
                    thread.join(timeout=10.0)
        self._http_server = self._http_thread = None
        self._sock_server = self._sock_thread = None
        if self.socket_path is not None:
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    # -------------------------------------------------------------- registry
    def create_stream(self, spec_obj: Dict[str, Any]) -> Dict[str, Any]:
        if not self._accepting:
            return wire.error("draining", "daemon is shutting down; no new streams")
        if faults._ACTIVE:
            faults.fire("serve.accept")
        try:
            spec = StreamSpec.from_wire(spec_obj)
        except (wire.WireError, ValueError, TypeError) as err:
            return wire.error("bad_request", str(err))
        stream_dir = os.path.join(self.base_dir, "streams", spec.name)
        # reserve the name under the lock, build the dir/store OUTSIDE it —
        # holding _lock across the spec write and Stream.start() would stall
        # every ingest/flush request behind this stream's disk I/O (ML012)
        with self._lock:
            if spec.name in self._streams or spec.name in self._creating:
                return wire.error("exists", f"stream {spec.name} already exists")
            self._creating.add(spec.name)
        try:
            os.makedirs(stream_dir, exist_ok=True)
            with open(os.path.join(stream_dir, "spec.json"), "w") as fh:
                json.dump(spec.to_wire(), fh, separators=(",", ":"))
            try:
                stream = Stream(spec, os.path.join(stream_dir, "store"), self.device)
                next_seq = stream.start()
            except Exception as err:
                shutil.rmtree(stream_dir, ignore_errors=True)
                return wire.error("bad_request", f"stream {spec.name} failed to open: {err}")
            with self._lock:
                self._streams[spec.name] = stream
        finally:
            with self._lock:
                self._creating.discard(spec.name)
        return wire.ok(stream=spec.name, next_seq=next_seq)

    def _get(self, name: str) -> Optional[Stream]:
        with self._lock:
            return self._streams.get(name)

    def ingest(
        self, name: str, seq: Any, batch: Any, *, block: bool = False, deadline_s: Optional[float] = None
    ) -> Dict[str, Any]:
        if not self._accepting:
            return wire.error("draining", "daemon is shutting down")
        stream = self._get(name)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        return stream.offer(seq, batch, block=block, deadline_s=deadline_s)

    def flush(self, name: str) -> Dict[str, Any]:
        stream = self._get(name)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        return stream.flush()

    def drain_stream(self, name: str) -> Dict[str, Any]:
        stream = self._get(name)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        result = stream.drain()
        if result.get("ok"):
            self._emit_costs(name)
        return result

    def revive_stream(self, name: str) -> Dict[str, Any]:
        """Half-open a parked (circuit-open) stream and retry — the operator
        verb behind ``ctl revive``."""
        stream = self._get(name)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        return stream.revive()

    def deadletter(self, name: str, action: str = "list", seq: Any = None) -> Dict[str, Any]:
        """Quarantine management: ``list`` the records, ``requeue`` one back
        through the exactly-once path, or ``purge`` it for good."""
        stream = self._get(name)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        if action == "list":
            return stream.deadletter_list()
        if action == "requeue":
            return stream.deadletter_requeue(seq)
        if action == "purge":
            return stream.deadletter_purge(seq)
        return wire.error("bad_request", f"unknown deadletter action {action!r} (list|requeue|purge)")

    def delete_stream(self, name: str) -> Dict[str, Any]:
        with self._lock:
            stream = self._streams.pop(name, None)
        if stream is None:
            return wire.error("not_found", f"no stream named {name!r}")
        dropped = stream.abandon()
        shutil.rmtree(os.path.join(self.base_dir, "streams", name), ignore_errors=True)
        return wire.ok(stream=name, dropped=dropped)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            streams = sorted(self._streams.values(), key=lambda s: s.spec.name)
        return wire.ok(
            accepting=self._accepting,
            epoch=self.epoch,
            rank=_obs_live._detect_rank() if self._rank is None else self._rank,
            streams=[s.status() for s in streams],
        )

    # ---------------------------------------------------------------- export
    def export_state(self, name: Optional[str] = None, fingerprint: Optional[str] = None) -> Dict[str, Any]:
        """The ``/v1/state`` federation verb: per-stream checkpoint payloads
        stamped with this boot's epoch and each stream's applied-seq
        watermark. ``name`` narrows to one stream; ``fingerprint`` pins the
        export to a registry fingerprint (mismatch → ``fingerprint_mismatch``,
        HTTP 409 — the aggregator quarantines instead of folding a foreign
        schema)."""
        if name is not None:
            stream = self._get(name)
            if stream is None:
                return wire.error("not_found", f"no stream named {name!r}")
            result = stream.export(fingerprint=fingerprint)
            if result.get("ok"):
                result["epoch"] = self.epoch
            return result
        with self._lock:
            streams = sorted(self._streams.items())
        exports: Dict[str, Any] = {}
        for sname, stream in streams:
            exports[sname] = stream.export(fingerprint=fingerprint)
        return wire.ok(epoch=self.epoch, streams=exports)

    def _emit_costs(self, name: str) -> None:
        """Per-stream cost ledger at a compute boundary — the attribution
        plane's ledger is process-wide, stamped here with the stream it was
        emitted for."""
        path = os.path.join(self.base_dir, "streams", name, "costs.json")
        try:
            _obs_attr.write_costs(path)
        except Exception:
            _obs_counters.inc("serve.costs_errors")

    # ---------------------------------------------------------------- probe
    def _probe(self) -> Dict[str, float]:
        with self._lock:
            streams = list(self._streams.values())
        gauges: Dict[str, float] = {"serve.streams": float(len(streams))}
        for stream in streams:
            gauges.update(stream.gauges())
        return gauges

    # ----------------------------------------------------------------- http
    def http_address(self) -> Optional[Tuple[str, int]]:
        """``(host, port)`` the control plane bound (port 0 resolves here)."""
        if self._http_server is None:
            return None
        return self._http_server.server_address[:2]

    def _start_http(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        host, port = _obs_live._parse_http_spec(self._http_spec)
        daemon = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:
                pass

            def _send_json(self, obj: Dict[str, Any], code: Optional[int] = None) -> None:
                if code is None:
                    code = 200 if obj.get("ok", True) else _ERROR_HTTP_STATUS.get(
                        obj.get("error", {}).get("code"), 400
                    )
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if obj.get("ok") is False and obj["error"].get("code") == "backpressure":
                    self.send_header("Retry-After", str(obj["error"].get("retry_after_s", 0.05)))
                self.end_headers()
                self.wfile.write(body)

            def _query(self) -> Dict[str, str]:
                from urllib.parse import parse_qsl

                if "?" not in self.path:
                    return {}
                return dict(parse_qsl(self.path.split("?", 1)[1]))

            def _body(self) -> Dict[str, Any]:
                length = int(self.headers.get("Content-Length", 0))
                obj = wire.decode_frame(self.rfile.read(length)) if length else {}
                if obj:
                    wire.check_version(obj)
                return obj

            def _route(self) -> None:
                path = self.path.split("?", 1)[0].rstrip("/")
                parts = [p for p in path.split("/") if p]
                try:
                    if self.command == "GET" and path == "/healthz":
                        publisher = _obs_live.publisher()
                        health = publisher.health() if publisher else _obs_live.derive_health(
                            {}, _obs_live.sample_probes()
                        )
                        health["epoch"] = daemon.epoch
                        self._send_json(health, code=health["http_status"])
                    elif self.command == "GET" and path == "/metrics":
                        publisher = _obs_live.publisher()
                        if publisher is None:
                            self._send_json(wire.error("failed", "live plane is off"), code=503)
                            return
                        body = publisher.render_metrics().encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/openmetrics-text; version=1.0.0; charset=utf-8")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif self.command == "GET" and path == "/v1/state":
                        self._send_json(daemon.export_state(fingerprint=self._query().get("fingerprint")))
                    elif parts[:2] == ["v1", "streams"]:
                        self._streams_route(parts[2:])
                    else:
                        self._send_json(
                            wire.error("not_found", "metricserve control plane: /v1/streams, /healthz, /metrics")
                        )
                except wire.WireError as err:
                    self._send_json(wire.error("bad_request", str(err)))
                except Exception as err:  # the control plane must answer, never hang up
                    self._send_json(wire.error("failed", f"{type(err).__name__}: {err}"), code=500)

            def _streams_route(self, rest: List[str]) -> None:
                if not rest:
                    if self.command == "GET":
                        self._send_json(daemon.status())
                    elif self.command == "POST":
                        body = self._body()
                        body.pop("v", None)
                        self._send_json(daemon.create_stream(body))
                    else:
                        self._send_json(wire.error("bad_request", f"{self.command} not supported here"))
                    return
                name = rest[0]
                action = rest[1] if len(rest) > 1 else None
                if self.command == "DELETE" and action is None:
                    self._send_json(daemon.delete_stream(name))
                elif self.command == "GET" and action is None:
                    stream = daemon._get(name)
                    if stream is None:
                        self._send_json(wire.error("not_found", f"no stream named {name!r}"))
                    else:
                        self._send_json(wire.ok(**stream.status()))
                elif self.command == "POST" and action == "ingest":
                    body = self._body()
                    self._send_json(daemon.ingest(name, body.get("seq"), body.get("batch")))
                elif self.command == "POST" and action == "flush":
                    self._send_json(daemon.flush(name))
                elif self.command == "POST" and action == "drain":
                    self._send_json(daemon.drain_stream(name))
                elif self.command == "POST" and action == "revive":
                    self._send_json(daemon.revive_stream(name))
                elif self.command == "GET" and action == "state":
                    self._send_json(daemon.export_state(name, fingerprint=self._query().get("fingerprint")))
                elif self.command == "GET" and action == "deadletter":
                    self._send_json(daemon.deadletter(name, "list"))
                elif self.command == "POST" and action == "deadletter":
                    body = self._body()
                    self._send_json(daemon.deadletter(name, body.get("action", "list"), body.get("seq")))
                else:
                    self._send_json(wire.error("bad_request", f"{self.command} {self.path} not supported"))

            do_GET = do_POST = do_DELETE = _route

        self._http_server = ThreadingHTTPServer((host, port), _Handler)
        self._http_server.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True, name="metricserve-http"
        )
        self._http_thread.start()

    # --------------------------------------------------------------- socket
    def _start_socket(self) -> None:
        daemon = self
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

        class _SockServer(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        class _SockHandler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                # one frame per line; the connection stays open for a whole
                # replay session (the socket plane's win over per-batch HTTP)
                for line in self.rfile:
                    if not line.strip():
                        continue
                    try:
                        frame = wire.decode_frame(line)
                        wire.check_version(frame)
                        reply = daemon._handle_frame(frame)
                    except wire.WireError as err:
                        reply = wire.error("bad_request", str(err))
                    except Exception as err:
                        reply = wire.error("failed", f"{type(err).__name__}: {err}")
                    try:
                        self.wfile.write(wire.encode_frame(reply))
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return

        self._sock_server = _SockServer(self.socket_path, _SockHandler)
        self._sock_thread = threading.Thread(
            target=self._sock_server.serve_forever, daemon=True, name="metricserve-socket"
        )
        self._sock_thread.start()

    def _handle_frame(self, frame: Dict[str, Any]) -> Dict[str, Any]:
        """Dispatch one socket frame: ``op`` selects the control verb; ingest
        blocks with a deadline (``deadline_s``, default 5s) instead of the
        HTTP 429 round-trip."""
        op = frame.get("op")
        name = frame.get("stream")
        if op == "ingest":
            deadline = frame.get("deadline_s", 5.0)
            return self.ingest(name, frame.get("seq"), frame.get("batch"), block=True, deadline_s=deadline)
        if op == "create":
            return self.create_stream(frame.get("spec") or {})
        if op == "status":
            if name:
                stream = self._get(name)
                return wire.ok(**stream.status()) if stream else wire.error("not_found", f"no stream named {name!r}")
            return self.status()
        if op == "flush":
            return self.flush(name)
        if op == "drain":
            return self.drain_stream(name)
        if op == "delete":
            return self.delete_stream(name)
        if op == "revive":
            return self.revive_stream(name)
        if op == "deadletter":
            return self.deadletter(name, frame.get("action", "list"), frame.get("seq"))
        if op == "state":
            return self.export_state(name, fingerprint=frame.get("fingerprint"))
        return wire.error("bad_request", f"unknown op {op!r}")


#: wire error code → HTTP status (backpressure maps to 429 + Retry-After)
_ERROR_HTTP_STATUS = {
    "backpressure": 429,
    "bad_seq": 409,
    "not_found": 404,
    "exists": 409,
    "draining": 503,
    "failed": 500,
    "bad_payload": 400,
    "bad_request": 400,
    "unsupported_version": 400,
    "fingerprint_mismatch": 409,
}
