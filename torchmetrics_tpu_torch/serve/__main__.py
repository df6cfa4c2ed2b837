# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""metricserve CLI of the port — run and drive the always-on eval-service daemon
(counterpart of ``tools/metricserve.py``).

Usage::

    # the daemon (imports torch; one per host/rank; on the card by default)
    python -m torchmetrics_tpu_torch.serve serve --base-dir /tmp/metricserve
    python -m torchmetrics_tpu_torch.serve serve --base-dir /tmp/metricserve --device cpu

    # the client mode (supervisors, CI, your laptop)
    python -m torchmetrics_tpu_torch.serve ctl --http 127.0.0.1:8799 status --json
    python -m torchmetrics_tpu_torch.serve ctl --http ... create --name m1-val \\
        --target torchmetrics_tpu_torch.serve.factories:accuracy \\
        --kwargs '{"num_classes": 10}'
    python -m torchmetrics_tpu_torch.serve ctl --http ... ingest m1-val --seq 0 \\
        --batch '[[...preds...], [...target...]]'
    cat batches.jsonl | python -m torchmetrics_tpu_torch.serve ctl --socket \\
        /tmp/metricserve/ingest.sock replay m1-val
    python -m torchmetrics_tpu_torch.serve ctl --http ... flush|drain|delete|revive m1-val
    python -m torchmetrics_tpu_torch.serve ctl --http ... deadletter m1-val list|requeue|purge [--seq 7]

    # federation (two-tier fleet aggregation)
    python -m torchmetrics_tpu_torch.serve fleet serve --base-dir /tmp/fleet \\
        --leaf leaf0=http://127.0.0.1:8801 --leaf leaf1=http://127.0.0.1:8802
    python -m torchmetrics_tpu_torch.serve fleet status|aggregate|health --http 127.0.0.1:8900
    python -m torchmetrics_tpu_torch.serve fleet add --http ... leaf2 http://127.0.0.1:8803
    python -m torchmetrics_tpu_torch.serve fleet remove --http ... leaf2

``serve`` starts a :class:`torchmetrics_tpu_torch.serve.ServeDaemon` over
``--base-dir`` on ``--device`` (default ``cuda``; without a card it exits
with an error rather than serve on the host), restores every stream whose
``spec.json`` survives there (restart = resume from the snapshot cursor),
prints ONE ready line of JSON (``{"ok": true, "http": [host, port],
"socket": ..., "pid": ...}`` — parse it to discover the ephemeral port) and
then blocks. SIGTERM/SIGINT trigger the graceful drain: stop admitting,
apply every admitted batch, snapshot + final-compute every stream in sorted
order, one last telemetry tick.

``ctl`` is the client plane: it uses ONLY the wire-schema module. Run as
this file's path (``python torchmetrics_tpu_torch/serve/__main__.py ctl``)
it loads ``wire.py`` by file path and imports neither torch nor the package;
``-m`` imports the package first, as Python does for any ``-m`` module. The
wire is the JAX package's, byte for byte, so this ctl drives a JAX daemon
and JAX's ``tools/metricserve.py ctl`` drives a port daemon. The ``fleet``
verbs other than ``fleet serve`` are plain HTTP against the aggregator's
control plane. ``replay`` streams newline-JSON batches from stdin over the
unix socket, asking the daemon for the stream's ``next_seq`` first, so
re-running the same replay after a crash sends exactly the unpersisted
suffix (duplicates are acked, nothing double-counts).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import socket
import sys
import threading

_SERVE_DIR = os.path.dirname(os.path.abspath(__file__))
#: the directory holding the ``torchmetrics_tpu_torch`` package
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(_SERVE_DIR))


def _load_wire():
    """The wire-schema module: the package's when it is already imported
    (``-m``, or ``serve``), else ``wire.py`` loaded by PATH, so a ctl run as
    this file's path never pays (or requires) the torch import behind the
    package root."""
    if "torchmetrics_tpu_torch" in sys.modules:  # already paid — reuse
        from torchmetrics_tpu_torch.serve import wire

        return wire
    path = os.path.join(_SERVE_DIR, "wire.py")
    spec = importlib.util.spec_from_file_location("metricserve_wire", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules["metricserve_wire"] = module
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------------- serve


def _cmd_serve(args) -> int:
    sys.path.insert(0, _PACKAGE_PARENT)
    from torchmetrics_tpu_torch.serve import ServeDaemon

    socket_path = None
    if not args.no_socket:
        socket_path = args.socket or os.path.join(args.base_dir, "ingest.sock")
    daemon = ServeDaemon(
        args.base_dir,
        http=f"{args.host}:{args.port}",
        socket_path=socket_path,
        publish=not args.no_publish,
        device=args.device,
    ).start()
    host, port = daemon.http_address()
    ready = {"ok": True, "http": [host, port], "socket": socket_path, "pid": os.getpid()}
    print(json.dumps(ready), flush=True)

    stop = threading.Event()

    def _graceful(signum, frame) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    stop.wait()
    results = daemon.shutdown(drain=True)
    print(json.dumps({"ok": True, "drained": sorted(results)}), flush=True)
    return 0


# ------------------------------------------------------------------- fleet


def _fleet_request(http: str, method: str, path: str, body=None):
    """One HTTP round-trip against the aggregator control plane (stdlib only)."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{http}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return json.loads(err.read())


def _cmd_fleet(args) -> int:
    if args.verb == "serve":
        sys.path.insert(0, _PACKAGE_PARENT)
        from torchmetrics_tpu_torch.serve.federation import FleetAggregator

        agg = FleetAggregator(
            args.base_dir,
            http=f"{args.host}:{args.port}",
            pull_interval_s=args.pull_interval_s,
            fingerprint=args.fingerprint,
            publish=not args.no_publish,
            device=args.device,
        ).start()
        for pair in args.leaf or ():
            name, sep, url = pair.partition("=")
            if not sep:
                print(json.dumps({"ok": False, "error": {"code": "bad_request",
                                  "message": f"--leaf wants name=url, got {pair!r}"}}), flush=True)
                agg.shutdown()
                return 2
            reply = agg.add_leaf(name, url)
            if not reply.get("ok") and reply.get("error", {}).get("code") != "exists":
                print(json.dumps(reply), flush=True)
                agg.shutdown()
                return 1
        host, port = agg.http_address()
        print(json.dumps({"ok": True, "http": [host, port], "epoch": agg.epoch,
                          "leaves": agg.leaves(), "pid": os.getpid()}), flush=True)
        stop = threading.Event()

        def _graceful(signum, frame) -> None:
            stop.set()

        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
        stop.wait()
        agg.shutdown()
        print(json.dumps({"ok": True, "stopped": True}), flush=True)
        return 0
    if not args.http:
        raise SystemExit("fleet ctl verbs need --http host:port")
    if args.verb == "status":
        return _emit(_fleet_request(args.http, "GET", "/v1/fleet"), args.json)
    if args.verb == "aggregate":
        return _emit(_fleet_request(args.http, "GET", "/v1/fleet/aggregate"), args.json)
    if args.verb == "health":
        reply = _fleet_request(args.http, "GET", "/healthz")
        print(json.dumps(reply) if args.json else json.dumps(reply, indent=2))
        return 0 if reply.get("state") in ("ok", "stalling") else 1
    if args.verb == "add":
        return _emit(
            _fleet_request(args.http, "POST", "/v1/fleet/leaves", {"name": args.name, "url": args.url}),
            args.json,
        )
    if args.verb == "remove":
        return _emit(_fleet_request(args.http, "DELETE", f"/v1/fleet/leaves/{args.name}"), args.json)
    raise SystemExit(f"unknown fleet verb {args.verb!r}")


# --------------------------------------------------------------------- ctl


class _Client:
    """Thin wire client: HTTP control verbs, socket frames for ingest."""

    def __init__(self, wire, http=None, socket_path=None):
        if http is None and socket_path is None:
            raise SystemExit("ctl needs --http host:port and/or --socket path")
        self.wire = wire
        self.http = http
        self.socket_path = socket_path
        self._conn = None

    # HTTP -----------------------------------------------------------------
    def request(self, method: str, path: str, body=None):
        import urllib.error
        import urllib.request

        if self.http is None:
            return self.frame({"op": path})  # unreachable for current verbs
        data = None
        if body is not None:
            data = json.dumps({"v": self.wire.WIRE_VERSION, **body}).encode()
        req = urllib.request.Request(f"http://{self.http}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return json.loads(err.read())

    # socket ---------------------------------------------------------------
    def frame(self, obj):
        if self._conn is None:
            self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._conn.connect(self.socket_path)
            self._file = self._conn.makefile("rwb")
        self._file.write(self.wire.encode_frame({"v": self.wire.WIRE_VERSION, **obj}))
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise SystemExit("daemon closed the ingest socket")
        return self.wire.decode_frame(line)

    def op(self, obj):
        """Control verb over whichever plane is configured (HTTP preferred)."""
        if self.http is not None:
            verb = obj["op"]
            name = obj.get("stream")
            if verb == "status":
                return self.request("GET", f"/v1/streams/{name}" if name else "/v1/streams")
            if verb == "create":
                return self.request("POST", "/v1/streams", obj["spec"])
            if verb == "delete":
                return self.request("DELETE", f"/v1/streams/{name}")
            if verb == "ingest":
                return self.request(
                    "POST", f"/v1/streams/{name}/ingest", {"seq": obj["seq"], "batch": obj["batch"]}
                )
            if verb == "deadletter":
                if obj.get("action", "list") == "list":
                    return self.request("GET", f"/v1/streams/{name}/deadletter")
                return self.request(
                    "POST",
                    f"/v1/streams/{name}/deadletter",
                    {"action": obj["action"], "seq": obj.get("seq")},
                )
            return self.request("POST", f"/v1/streams/{name}/{verb}")
        return self.frame(obj)


def _emit(reply, as_json: bool) -> int:
    if as_json:
        print(json.dumps(reply))
    elif reply.get("ok"):
        fields = {k: v for k, v in reply.items() if k not in ("v", "ok")}
        print(json.dumps(fields) if fields else "ok")
    else:
        err = reply.get("error", {})
        print(f"error [{err.get('code')}]: {err.get('message')}", file=sys.stderr)
    return 0 if reply.get("ok") else 1


def _cmd_ctl(args) -> int:
    wire = _load_wire()
    client = _Client(wire, http=args.http, socket_path=args.socket)
    if args.verb == "status":
        reply = client.op({"op": "status", "stream": args.stream})
        return _emit(reply, args.json)
    if args.verb == "create":
        spec = json.loads(args.spec) if args.spec else {}
        if args.name:
            spec["name"] = args.name
        if args.target:
            spec["target"] = args.target
        if args.kwargs:
            spec["kwargs"] = json.loads(args.kwargs)
        if args.fused:
            spec["fused"] = True
        if args.window:
            spec["window"] = json.loads(args.window)
        if args.snapshot_every_n is not None:
            spec["snapshot_every_n"] = args.snapshot_every_n
        return _emit(client.op({"op": "create", "spec": spec}), args.json)
    if args.verb == "ingest":
        batch = json.loads(args.batch)
        reply = client.op({"op": "ingest", "stream": args.stream, "seq": args.seq, "batch": batch})
        return _emit(reply, args.json)
    if args.verb == "replay":
        return _cmd_replay(client, args)
    if args.verb == "deadletter":
        reply = client.op(
            {"op": "deadletter", "stream": args.stream, "action": args.action, "seq": args.seq}
        )
        return _emit(reply, args.json)
    if args.verb in ("flush", "drain", "delete", "revive"):
        return _emit(client.op({"op": args.verb, "stream": args.stream}), args.json)
    raise SystemExit(f"unknown ctl verb {args.verb!r}")


def _cmd_replay(client, args) -> int:
    """Stream stdin's newline-JSON batches from the daemon's ``next_seq``:
    line k of the input is ALWAYS seq k, so replaying the same file after a
    crash skips (as duplicates) everything already persisted.

    Backpressure is retried with jittered exponential backoff — the server's
    ``retry_after_s`` is the floor, the delay doubles per consecutive retry
    (capped at 2s), and jitter desynchronizes replaying clients so they don't
    re-stampede a recovering stream in lockstep. A batch that stays
    backpressured past ``--max-retry-s`` cumulative waiting fails loudly with
    the seq it stalled on."""
    import random
    import time

    status = client.op({"op": "status", "stream": args.stream})
    if not status.get("ok"):
        return _emit(status, args.json)
    next_seq = int(status["next_seq"])
    max_retry_s = float(getattr(args, "max_retry_s", 60.0))
    sent = acked = retries = 0
    for k, line in enumerate(sys.stdin):
        line = line.strip()
        if not line:
            continue
        if k < next_seq:
            continue  # already persisted server-side — skip without a round-trip
        batch = json.loads(line)
        reply = client.op({"op": "ingest", "stream": args.stream, "seq": k, "batch": batch})
        sent += 1
        waited = 0.0
        attempt = 0
        while not reply.get("ok") and reply.get("error", {}).get("code") == "backpressure":
            floor = float(reply["error"].get("retry_after_s", 0.05))
            delay = min(2.0, max(floor, floor * (2 ** attempt)))
            delay += random.uniform(0.0, delay / 2)
            if waited + delay > max_retry_s:
                print(
                    f"error [backpressure]: seq {k} still backpressured after"
                    f" {waited:.1f}s of retries (--max-retry-s {max_retry_s:g})",
                    file=sys.stderr,
                )
                return 1
            time.sleep(delay)
            waited += delay
            attempt += 1
            retries += 1
            reply = client.op({"op": "ingest", "stream": args.stream, "seq": k, "batch": batch})
        if not reply.get("ok"):
            return _emit(reply, args.json)
        acked += 1
    print(
        json.dumps(
            {
                "ok": True,
                "stream": args.stream,
                "skipped": next_seq,
                "sent": sent,
                "acked": acked,
                "retries": retries,
            }
        )
    )
    return 0


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m torchmetrics_tpu_torch.serve", description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    serve = sub.add_parser("serve", help="run the eval-service daemon (imports torch)")
    serve.add_argument("--base-dir", required=True, help="durable root for streams/stores/status")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=0, help="control-plane port (0 = ephemeral)")
    serve.add_argument("--socket", default=None, help="ingest socket path (default <base-dir>/ingest.sock)")
    serve.add_argument("--no-socket", action="store_true", help="disable the unix-socket ingest plane")
    serve.add_argument("--no-publish", action="store_true", help="do not start the live status-file plane")
    serve.add_argument("--device", default="cuda", help="device every stream runs on (default cuda; cpu serves on the host)")
    serve.set_defaults(fn=_cmd_serve)

    ctl = sub.add_parser("ctl", help="wire-only client: drive a running daemon of either package")
    ctl.add_argument("--http", default=None, help="control plane address host:port")
    ctl.add_argument("--socket", default=None, help="ingest socket path")
    ctl_sub = ctl.add_subparsers(dest="verb", required=True)

    st = ctl_sub.add_parser("status", help="daemon or per-stream status")
    st.add_argument("stream", nargs="?", default=None)

    cr = ctl_sub.add_parser("create", help="create a stream")
    cr.add_argument("--spec", default=None, help="full StreamSpec JSON (flags below override)")
    cr.add_argument("--name")
    cr.add_argument("--target", help="factory path module:callable")
    cr.add_argument("--kwargs", help="factory kwargs JSON")
    cr.add_argument("--fused", action="store_true")
    cr.add_argument("--window", help="WindowRing kwargs JSON, e.g. '{\"slots\":4,\"every_n\":8}'")
    cr.add_argument("--snapshot-every-n", type=int, default=None)

    ing = ctl_sub.add_parser("ingest", help="send one batch")
    ing.add_argument("stream")
    ing.add_argument("--seq", type=int, required=True)
    ing.add_argument("--batch", required=True, help="JSON list, one entry per update argument")

    rp = ctl_sub.add_parser("replay", help="stream stdin JSONL batches from the daemon's next_seq")
    rp.add_argument("stream")
    rp.add_argument(
        "--max-retry-s",
        type=float,
        default=60.0,
        dest="max_retry_s",
        help="give up on a batch after this much cumulative backpressure waiting (default 60)",
    )

    dl = ctl_sub.add_parser("deadletter", help="poison-batch quarantine: list/requeue/purge")
    dl.add_argument("stream")
    dl.add_argument("action", choices=("list", "requeue", "purge"))
    dl.add_argument("--seq", type=int, default=None, help="record to requeue/purge")

    for verb in ("flush", "drain", "delete", "revive"):
        v = ctl_sub.add_parser(
            verb, help="half-open a parked stream's circuit breaker" if verb == "revive" else None
        )
        v.add_argument("stream")

    for verb_parser in (
        st, cr, ing, rp, dl,
        *(ctl_sub.choices[v] for v in ("flush", "drain", "delete", "revive")),
    ):
        verb_parser.add_argument("--json", action="store_true", help="print raw wire envelopes")

    ctl.set_defaults(fn=_cmd_ctl)

    fleet = sub.add_parser("fleet", help="two-tier federation: aggregator daemon + leaf registry")
    fleet_sub = fleet.add_subparsers(dest="verb", required=True)

    fserve = fleet_sub.add_parser("serve", help="run the fleet aggregator (imports torch)")
    fserve.add_argument("--base-dir", required=True, help="durable root for leaves.json + fold store")
    fserve.add_argument("--host", default="127.0.0.1")
    fserve.add_argument("--port", type=int, default=0, help="control-plane port (0 = ephemeral)")
    fserve.add_argument("--pull-interval-s", type=float, default=1.0, dest="pull_interval_s")
    fserve.add_argument("--fingerprint", default=None,
                        help="pin every pull to this registry fingerprint (mismatch quarantines the leaf)")
    fserve.add_argument("--leaf", action="append", default=[], metavar="NAME=URL",
                        help="register a leaf at startup (repeatable; already-registered names are kept)")
    fserve.add_argument("--no-publish", action="store_true", help="do not register the fleet.* live probe")
    fserve.add_argument("--device", default="cuda", help="device of the fold's reference metrics (default cuda)")

    fst = fleet_sub.add_parser("status", help="leaf registry, classification and watermarks")
    fag = fleet_sub.add_parser("aggregate", help="fold the fleet now and print the answer")
    fhe = fleet_sub.add_parser("health", help="worst-leaf-floored fleet health (exit 1 when degraded)")
    fad = fleet_sub.add_parser("add", help="register a leaf daemon")
    fad.add_argument("name")
    fad.add_argument("url", help="leaf control-plane URL, e.g. http://127.0.0.1:8801")
    frm = fleet_sub.add_parser("remove", help="deregister a leaf")
    frm.add_argument("name")
    for verb_parser in (fst, fag, fhe, fad, frm):
        verb_parser.add_argument("--http", default=None, help="aggregator control plane host:port")
        verb_parser.add_argument("--json", action="store_true", help="print raw wire envelopes")

    fleet.set_defaults(fn=_cmd_fleet)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
