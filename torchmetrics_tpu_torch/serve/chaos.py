#!/usr/bin/env python
# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Chaos-soak harness for the port's metricserve self-healing plane
(counterpart of ``tools/metricchaos.py``).

Runs LIVE port daemons (``python -m torchmetrics_tpu_torch.serve serve``,
real subprocesses, real HTTP control plane) under a seeded fault schedule
and asserts the self-healing invariants end to end::

    # deterministic short soak (daemons on the card by default)
    python torchmetrics_tpu_torch/serve/chaos.py --workdir /tmp/chaos --mode short
    python torchmetrics_tpu_torch/serve/chaos.py --workdir /tmp/chaos --mode short --device cpu

    # seeded randomized long soak (the slow drill)
    python torchmetrics_tpu_torch/serve/chaos.py --workdir /tmp/chaos --mode long --seed 7 --rounds 3

    # federation drill: leaf fleet + aggregator under kills and corruption
    python torchmetrics_tpu_torch/serve/chaos.py --workdir /tmp/chaos --mode fleet

    # StateGuard drill: mask/reject sanitization + poison-probe rollback
    python torchmetrics_tpu_torch/serve/chaos.py --workdir /tmp/chaos --mode poison

``--device`` (default ``cuda``) is passed to every daemon and aggregator the
harness starts; each one's ready line must name that device, so a leg never
runs on the host when the card was asked for. The daemons' stderr goes to
``<base-dir>.log`` beside each base dir.

The short soak is two legs:

- **main leg** — one stream fed a schedule mixing a transient worker crash
  (supervised restart + retained replay), a deterministically poisonous
  batch (quarantined to ``deadletter.jsonl`` after ``poison_threshold``
  consecutive kills, cursor skips past it), and a persistent snapshot-write
  ENOSPC (stream degrades to in-memory-only; ``/healthz`` flips
  ``degraded``), finished with a daemon **SIGKILL** + fault-free restart +
  client replay + drain.
- **circuit leg** — a stream whose worker dies more times than its restart
  budget parks with the circuit breaker open (``/healthz`` ``stalled``);
  ``ctl revive`` half-opens it, the probe incarnation succeeds, and the
  drain completes.

Invariants asserted every leg:

1. zero dropped batches outside the quarantine (``dropped == 0``; a purge
   is the only sanctioned drop),
2. drained results are BITWISE equal to an uninterrupted reference run over
   the same batches minus exactly the quarantined seqs,
3. the poison batch sits in ``deadletter.jsonl`` with its error and attempt
   count,
4. ``/healthz`` reflects ``degraded`` / ``stalled`` / ``ok`` at the right
   times.

The **poison mode** drills the StateGuard: one daemon hosts a
``mask``-policy stream fed batches with NaN/Inf/out-of-domain rows mixed in,
a ``reject``-policy stream fed whole poisoned batches, and a
``propagate``-policy MSE stream fed NaN frames that corrupt state and trip
the in-program poison probe. Asserted invariants: the mask stream's drained
result is BITWISE equal to a reference fed the same batches with the invalid
ROWS stripped; the reject stream matches a reference fed only the valid
BATCHES; the MSE stream rolls back to the known-good in-memory ring (no disk
restore), quarantines each poison frame to ``deadletter.jsonl`` WITH its
guard verdict, walks ``/healthz`` 200 → 503 → 200 as the rollback window
drains, and still drains bitwise-equal to a reference fed only the valid
frames; every injected frame is accounted for in the ``guard.<stream>.*``
gauges plus the ledger.

The **fleet mode** runs the federation drill: N real leaf daemons plus one
corrupt HTTP stub under a ``fleet serve`` aggregator; a leaf is SIGKILLed
and restarted mid-fold (its replayed prefix must dedup through the
epoch/watermark protocol), the aggregator is SIGKILLed and must resume its
slots from the fold store, the stub stays quarantined, ``/healthz``
degrades with a coverage reason — and the final fleet aggregate is BITWISE
equal to a single uninterrupted daemon fed every leaf's batches.

The long soak replays the same leg logic ``--rounds`` times with
seed-derived randomized parameters (crash timing, poison position, ENOSPC
window, kill point) — randomness picks the schedule, every schedule is
still deterministic inside the daemon (``TM_TPU_FAULTS`` is hit-counted,
never coin-flipped), so any failing round reproduces from its printed
parameters.

Every leg's report also carries its wall ``seconds`` and ``ready_s``, the
time each daemon or aggregator it started took to print its ready line.

This harness imports the stdlib alone, neither torch nor jax nor either
package: run it as this file's path, so Python imports no package first.
The daemon subprocesses pay the torch import, with the directory holding
``torchmetrics_tpu_torch`` as their whole ``PYTHONPATH``; the harness speaks
plain HTTP.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import select
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

#: the directory holding the ``torchmetrics_tpu_torch`` package
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SERVE = [sys.executable, "-m", "torchmetrics_tpu_torch.serve"]
# JAX factory paths: the port's daemon resolves them onto its own factories
_CHECKED = "torchmetrics_tpu.serve.factories:checked_binary_accuracy"


class ChaosFailure(AssertionError):
    """An invariant the soak asserts did not hold."""


def _check(cond, message: str) -> None:
    if not cond:
        raise ChaosFailure(message)


# ----------------------------------------------------------------- daemon


def _die_with_parent() -> None:
    """In the child before exec: a daemon is SIGKILLed when the harness dies,
    so a harness killed at its caller's deadline leaves no daemon behind
    (Linux ``prctl(PR_SET_PDEATHSIG)``; elsewhere a no-op)."""
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _spawn(args, base_dir: str, env_faults: str, device: str, timeout_s: float, what: str):
    """Start ``python -m torchmetrics_tpu_torch.serve <args>`` with a clean
    ``PYTHONPATH`` (the package's parent alone), its stderr appended to
    ``<base_dir>.log``; return the process, its ready line and the seconds
    it took to print it. The ready line must be ok and name ``device``."""
    env = dict(os.environ, PYTHONPATH=_PACKAGE_PARENT)
    if env_faults:
        env["TM_TPU_FAULTS"] = env_faults
    else:
        env.pop("TM_TPU_FAULTS", None)
    log_path = base_dir.rstrip(os.sep) + ".log"
    started = time.monotonic()
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            _SERVE + list(args) + ["--device", device],
            stdout=subprocess.PIPE, stderr=log, env=env, text=True, preexec_fn=_die_with_parent,
        )
    line = ""
    try:
        while time.monotonic() < started + timeout_s:
            ready, _, _ = select.select([proc.stdout], [], [], 0.5)
            if ready:
                line = proc.stdout.readline()
                if line.strip() or proc.poll() is not None:
                    break
            elif proc.poll() is not None:
                break
        if not line.strip():
            with open(log_path) as log:
                tail = log.read()[-2000:]
            raise ChaosFailure(
                f"{what} printed no ready line within {timeout_s:g}s (rc {proc.poll()}); {log_path}: {tail}"
            )
        ready_s = time.monotonic() - started
        ready = json.loads(line)
        _check(ready.get("ok"), f"{what} ready line not ok: {ready}")
        _check(str(ready.get("device", "")).split(":")[0] == device.split(":")[0],
               f"{what} was asked for --device {device} but serves on {ready.get('device')}: {ready}")
    except BaseException:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        raise
    return proc, ready, ready_s


class Daemon:
    """One metricserve subprocess + its parsed ready line."""

    #: seconds from start to ready line of every daemon and aggregator started
    ready_log: list = []

    def __init__(self, base_dir: str, env_faults: str = "", timeout_s: float = 120.0,
                 port: int = 0, device: str = "cuda") -> None:
        self.base_dir = base_dir
        self.proc, ready, ready_s = _spawn(
            ["serve", "--base-dir", base_dir, "--no-socket", "--port", str(port)],
            base_dir, env_faults, device, timeout_s, "daemon",
        )
        Daemon.ready_log.append(ready_s)
        self.host, self.port = ready["http"]

    def http(self, method: str, path: str, body=None):
        data = None if body is None else json.dumps({"v": 1, **body}).encode()
        req = urllib.request.Request(f"http://{self.host}:{self.port}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def healthz(self) -> str:
        _, body = self.http("GET", "/healthz")
        return body.get("state", "?")

    def stream_status(self, name: str):
        _, body = self.http("GET", f"/v1/streams/{name}")
        return body

    def sigkill(self) -> None:
        """The drill: no drain, no atexit — only the durable footprint survives."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def sigterm(self) -> None:
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def ensure_dead(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _wait(predicate, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise ChaosFailure(f"timed out after {timeout_s:g}s waiting for {what}")


def _ingest(daemon: Daemon, name: str, seq: int, batch, timeout_s: float = 60.0):
    """HTTP ingest with backpressure retries — the client half of the
    exactly-once protocol."""
    deadline = time.monotonic() + timeout_s
    while True:
        code, reply = daemon.http("POST", f"/v1/streams/{name}/ingest", {"seq": seq, "batch": batch})
        if reply.get("ok"):
            return reply
        err = reply.get("error", {})
        if err.get("code") == "backpressure" and time.monotonic() < deadline:
            # jitter on the server's floor: concurrent harness clients (the
            # fleet mode runs several) must not re-stampede a recovering
            # stream in lockstep — the same policy as `ctl replay`
            floor = float(err.get("retry_after_s", 0.05))
            time.sleep(floor + random.uniform(0.0, floor))
            continue
        raise ChaosFailure(f"ingest seq {seq} into {name} failed: {code} {reply}")


# ---------------------------------------------------------------- batches


def make_batches(n_batches: int, per_batch: int, seed: int):
    """Seeded wire batches for a binary-accuracy stream — stdlib random only
    (the harness must run where numpy may not exist)."""
    rng = random.Random(seed)
    batches = []
    for _ in range(n_batches):
        preds = [round(rng.random(), 6) for _ in range(per_batch)]
        target = [rng.randint(0, 1) for _ in range(per_batch)]
        batches.append([preds, target])
    return batches


POISON = [[0.5, 0.5, 0.5, 0.5], [7, 7, 7, 7]]  # clean avals, values outside {0, 1}


def _reference_results(workdir: str, batches, seed_tag: str, device: str = "cuda"):
    """The uninterrupted run: a fault-free daemon fed the same (non-poison)
    batches, drained cleanly — the bitwise truth the chaos leg must match."""
    base = os.path.join(workdir, f"ref-{seed_tag}")
    shutil.rmtree(base, ignore_errors=True)
    daemon = Daemon(base, device=device)
    try:
        _, reply = daemon.http("POST", "/v1/streams", {
            "name": "soak", "target": _CHECKED, "snapshot_every_n": 2, "use_feed": False,
        })
        _check(reply.get("ok"), f"reference create failed: {reply}")
        for seq, batch in enumerate(batches):
            _ingest(daemon, "soak", seq, batch)
        _, reply = daemon.http("POST", "/v1/streams/soak/drain")
        _check(reply.get("ok"), f"reference drain failed: {reply}")
        return reply["results"]
    finally:
        daemon.sigterm()


# ------------------------------------------------------------------- legs


def run_main_leg(workdir: str, seed: int, n_batches: int = 10, crash_after: int = 3,
                 enospc_after: int = 1, poison_at: int = 6, kill_after: int | None = None,
                 device: str = "cuda"):
    """Transient crash + poison batch + persistent ENOSPC + SIGKILL +
    fault-free restart + replay + drain; returns the leg's summary dict."""
    batches = make_batches(n_batches, per_batch=4, seed=seed)
    lines = list(batches)
    lines[poison_at] = POISON  # line k is ALWAYS seq k — poison takes a slot

    faults = (
        f"fail:serve.worker.crash:after={crash_after}:count=1"
        f";fail:store.write.enospc:after={enospc_after}:count=100000"
    )
    base = os.path.join(workdir, f"main-{seed}")
    shutil.rmtree(base, ignore_errors=True)
    daemon = Daemon(base, env_faults=faults, device=device)
    observed = {"degraded": False}
    try:
        _, reply = daemon.http("POST", "/v1/streams", {
            "name": "soak", "target": _CHECKED, "snapshot_every_n": 2, "use_feed": False,
            "poison_threshold": 2, "backoff_base_s": 0.01, "max_restarts": 50,
        })
        _check(reply.get("ok"), f"create failed: {reply}")
        _check(daemon.healthz() == "ok", "healthz should start ok")

        stop_at = len(lines) if kill_after is None else kill_after
        for seq in range(stop_at):
            _ingest(daemon, "soak", seq, lines[seq])

        # heal: every acked seq applied or quarantined, quarantine depth 1
        def healed():
            status = daemon.stream_status("soak")
            if observed["degraded"] is False and not status.get("durable", True):
                observed["degraded"] = True
            return (
                status.get("state") == "serving"
                and status.get("pending") == 0
                and status.get("deadletter_depth") == 1
                and status.get("restarts", 0) >= 1
            ) and status
        status = _wait(healed, 90.0, "supervised heal + quarantine")
        _check(status["dropped"] == 0, f"healing dropped batches: {status}")

        # the ENOSPC schedule is persistent: the stream must have degraded
        _wait(lambda: not daemon.stream_status("soak").get("durable", True), 30.0,
              "durability to drop under ENOSPC")
        observed["degraded"] = True
        _check(daemon.healthz() == "degraded",
               f"healthz should be degraded under ENOSPC, got {daemon.healthz()}")

        # the quarantine record is durable and carries the evidence
        _, listing = daemon.http("GET", "/v1/streams/soak/deadletter")
        _check(listing.get("ok") and listing["depth"] == 1, f"deadletter listing: {listing}")
        record = listing["deadletter"][0]
        _check(record["seq"] == poison_at, f"wrong quarantined seq: {record}")
        _check("expected only the following values" in record["error"],
               f"quarantine lost its error: {record}")
        _check(record["attempts"] >= 2, f"quarantine lost its attempts: {record}")
        dl_path = os.path.join(base, "streams", "soak", "deadletter.jsonl")
        with open(dl_path) as fh:
            on_disk = [json.loads(line) for line in fh if line.strip()]
        _check([r["seq"] for r in on_disk] == [poison_at], f"deadletter.jsonl: {on_disk}")

        resumed_from = status["cursor"]
        daemon.sigkill()
    except BaseException:
        daemon.ensure_dead()
        raise

    # fault-free restart: spec + store + quarantine re-read from disk; the
    # client replays exactly the suffix the daemon asks for
    daemon = Daemon(base, device=device)
    try:
        status = daemon.stream_status("soak")
        _check(status.get("ok", True) and status.get("state") == "serving",
               f"restart did not resume the stream: {status}")
        next_seq = int(status["next_seq"])
        _check(next_seq <= len(lines), f"restart over-resumed: {status}")
        _check(status["deadletter_depth"] == 1, f"quarantine lost across SIGKILL: {status}")
        for seq in range(next_seq, len(lines)):
            _ingest(daemon, "soak", seq, lines[seq])
        _, reply = daemon.http("POST", "/v1/streams/soak/drain")
        _check(reply.get("ok"), f"post-restart drain failed: {reply}")
        _check(reply["cursor"] == len(lines), f"drain cursor: {reply}")
        status = daemon.stream_status("soak")
        _check(status["dropped"] == 0, f"non-quarantined batches dropped: {status}")
        _check(daemon.healthz() == "ok", f"healthz should settle ok, got {daemon.healthz()}")
        got = reply["results"]
    finally:
        daemon.sigterm()

    want = _reference_results(
        os.path.dirname(base), [b for i, b in enumerate(lines) if i != poison_at], f"main-{seed}", device
    )
    _check(got == want, f"results diverged from the uninterrupted reference: {got} != {want}")
    return {
        "leg": "main", "seed": seed, "results": got, "quarantined": [poison_at],
        "resumed_from": resumed_from, "degraded_observed": observed["degraded"],
    }


def run_circuit_leg(workdir: str, seed: int, n_batches: int = 6, device: str = "cuda"):
    """Exhaust the restart budget → circuit open + /healthz stalled → revive
    half-opens → probe succeeds → drain parity."""
    batches = make_batches(n_batches, per_batch=4, seed=seed + 1)
    base = os.path.join(workdir, f"circuit-{seed}")
    shutil.rmtree(base, ignore_errors=True)
    # the first 3 apply attempts die; budget is 2 restarts → the 3rd failure
    # parks the circuit with the fault NOT yet exhausted... after revive the
    # 4th attempt is fault-free and the probe incarnation heals
    daemon = Daemon(base, env_faults="fail:serve.worker.crash:count=3", device=device)
    try:
        _, reply = daemon.http("POST", "/v1/streams", {
            "name": "breaker", "target": _CHECKED, "snapshot_every_n": 2, "use_feed": False,
            "max_restarts": 2, "poison_threshold": 5, "backoff_base_s": 0.01,
        })
        _check(reply.get("ok"), f"create failed: {reply}")
        for seq, batch in enumerate(batches):
            _ingest(daemon, "breaker", seq, batch)

        def parked():
            status = daemon.stream_status("breaker")
            return status.get("state") == "failed" and status.get("circuit") == "open" and status
        status = _wait(parked, 60.0, "circuit to open after the restart budget")
        _check(status["dropped"] == 0, f"parking dropped batches: {status}")
        _check(daemon.healthz() == "stalled", f"healthz should be stalled, got {daemon.healthz()}")
        code, refused = daemon.http(
            "POST", "/v1/streams/breaker/ingest", {"seq": status["next_seq"], "batch": batches[0]}
        )
        _check(refused.get("error", {}).get("code") == "failed" and "revive" in refused["error"]["message"],
               f"parked ingest should point at revive: {refused}")

        _, reply = daemon.http("POST", "/v1/streams/breaker/revive")
        _check(reply.get("ok") and reply.get("revived"), f"revive failed: {reply}")

        def closed():
            s = daemon.stream_status("breaker")
            return s.get("state") == "serving" and s.get("circuit") == "closed" and s.get("pending") == 0
        _wait(closed, 60.0, "the revived probe incarnation to close the circuit")
        _check(daemon.healthz() == "ok", f"healthz should recover ok, got {daemon.healthz()}")

        _, reply = daemon.http("POST", "/v1/streams/breaker/drain")
        _check(reply.get("ok") and reply["cursor"] == len(batches), f"drain failed: {reply}")
        status = daemon.stream_status("breaker")
        _check(status["dropped"] == 0 and status["restarts"] >= 2, f"final status: {status}")
        got = reply["results"]
    finally:
        daemon.sigterm()

    want = _reference_results(os.path.dirname(base), batches, f"circuit-{seed}", device)
    _check(got == want, f"circuit-leg results diverged: {got} != {want}")
    return {"leg": "circuit", "seed": seed, "results": got, "restarts": status["restarts"]}


# ------------------------------------------------------------------ poison


_GUARDED_ACC = "torchmetrics_tpu.serve.factories:guarded_binary_accuracy"
_GUARDED_MSE = "torchmetrics_tpu.serve.factories:guarded_mean_squared_error"

NAN = float("nan")
INF = float("inf")


def _strip_invalid_rows(batch):
    """Host-side truth of the ``mask`` policy for the guarded binary-accuracy
    contract: drop rows with a non-finite pred, a pred outside [0, 1], or a
    target outside {0, 1}."""
    import math

    preds, target = batch
    keep = [
        i for i, (p, t) in enumerate(zip(preds, target))
        if math.isfinite(p) and 0.0 <= p <= 1.0 and t in (0, 1)
    ]
    return [[preds[i] for i in keep], [target[i] for i in keep]]


def _create_stream(daemon: Daemon, name: str, target: str, **fields):
    _, reply = daemon.http("POST", "/v1/streams", {
        "name": name, "target": target, "snapshot_every_n": 2, "use_feed": False, **fields,
    })
    _check(reply.get("ok"), f"create {name} failed: {reply}")


def _feed_and_drain(daemon: Daemon, name: str, batches):
    for seq, batch in enumerate(batches):
        _ingest(daemon, name, seq, batch)
    _, reply = daemon.http("POST", f"/v1/streams/{name}/drain")
    _check(reply.get("ok"), f"drain {name} failed: {reply}")
    return reply["results"]


def run_poison_leg(workdir: str, seed: int, recover_s: float = 2.0, device: str = "cuda"):
    """The StateGuard drill (see the module docstring): sanitize (mask),
    veto (reject) and rollback (propagate + probe) on one live daemon, with
    the 200 → 503 → 200 ``/healthz`` walk and bitwise parity against
    valid-subsequence references."""
    # --- schedules (seeded clean base + deterministic injections) --------
    mask_lines = make_batches(6, per_batch=4, seed=seed)
    mask_lines[1][0][1] = NAN      # one NaN pred row
    mask_lines[3][0][2] = INF      # one Inf pred row
    mask_lines[4][0][3] = 1.5      # pred outside [0, 1]
    mask_lines[4][1][0] = 7        # target outside {0, 1}
    injected_rows = {"nan": 1, "inf": 1, "domain": 2}

    reject_lines = make_batches(5, per_batch=4, seed=seed + 1)
    reject_lines[1][0][2] = NAN    # one bad row vetoes the WHOLE batch
    reject_lines[3][1][1] = 7
    vetoed = [1, 3]

    mse_lines = make_batches(6, per_batch=4, seed=seed + 2)
    poison_at = [2, 4]
    for seq in poison_at:
        mse_lines[seq] = [[NAN, 0.5, 0.25, 0.75], [0, 1, 0, 1]]

    base = os.path.join(workdir, f"poison-{seed}")
    shutil.rmtree(base, ignore_errors=True)
    daemon = Daemon(base, device=device)
    try:
        _create_stream(daemon, "mask", _GUARDED_ACC, kwargs={"policy": "mask"})
        _create_stream(daemon, "reject", _GUARDED_ACC, kwargs={"policy": "reject"})
        _create_stream(daemon, "mse", _GUARDED_MSE, kwargs={"policy": "propagate"},
                       guard_ring=4, guard_recover_s=recover_s)
        code, health = daemon.http("GET", "/healthz")
        _check(code == 200 and health.get("state") == "ok", f"healthz should start 200 ok: {health}")

        # --- mask + reject: absorption is NOT an incident ----------------
        results = {"mask": _feed_and_drain(daemon, "mask", mask_lines),
                   "reject": _feed_and_drain(daemon, "reject", reject_lines)}
        code, health = daemon.http("GET", "/healthz")
        _check(code == 200, f"masked/rejected rows must not floor health: {health}")

        # --- rollback walk: both poison frames land back to back, so both
        # rollbacks fall inside the recover_s window → degraded (503) ------
        for seq, batch in enumerate(mse_lines):
            _ingest(daemon, "mse", seq, batch)

        def rolled_back():
            status = daemon.stream_status("mse")
            guard = status.get("guard") or {}
            return guard.get("rollbacks", 0) >= len(poison_at) and status
        status = _wait(rolled_back, 60.0, "the poison probe to roll back twice")
        _check(status["dropped"] == 0, f"rollback dropped batches: {status}")
        code, health = daemon.http("GET", "/healthz")
        _check(code == 503 and health.get("state") == "degraded",
               f"repeat rollbacks should floor healthz at 503: {code} {health}")
        _check("rolled back" in str(health.get("reason")),
               f"health reason should name the rollback: {health}")

        # recovery: the sliding window drains and health un-floors
        _wait(lambda: daemon.http("GET", "/healthz")[0] == 200, recover_s + 30.0,
              "healthz to recover to 200 after the rollback window")

        _, reply = daemon.http("POST", "/v1/streams/mse/drain")
        _check(reply.get("ok"), f"mse drain failed: {reply}")
        results["mse"] = reply["results"]

        # --- accounting: every injected frame in gauges + ledger ----------
        mask_guard = daemon.stream_status("mask")["guard"]
        _check(mask_guard["nan_rows"] == injected_rows["nan"]
               and mask_guard["inf_rows"] == injected_rows["inf"]
               and mask_guard["domain_rows"] == injected_rows["domain"]
               and mask_guard["masked_rows"] == sum(injected_rows.values())
               and mask_guard["rollbacks"] == 0,
               f"mask accounting: {mask_guard}")
        reject_guard = daemon.stream_status("reject")["guard"]
        _check(reject_guard["rejected_batches"] == len(vetoed) and reject_guard["rollbacks"] == 0,
               f"reject accounting: {reject_guard}")
        mse_status = daemon.stream_status("mse")
        _check(mse_status["guard"]["rollbacks"] == len(poison_at)
               and mse_status["guard"]["poisoned"] == len(poison_at)
               and mse_status["deadletter_depth"] == len(poison_at),
               f"mse accounting: {mse_status}")
        _, listing = daemon.http("GET", "/v1/streams/mse/deadletter")
        records = {r["seq"]: r for r in listing["deadletter"]}
        _check(sorted(records) == poison_at, f"quarantined seqs: {sorted(records)}")
        for rec in records.values():
            _check(rec.get("guard", {}).get("nan_rows") == 1,
                   f"quarantine record lost its guard verdict: {rec}")
            _check("poison probe" in rec["error"], f"quarantine lost its error: {rec}")
    finally:
        daemon.sigterm()

    # --- bitwise parity vs the valid subsequence ------------------------
    ref_base = os.path.join(workdir, f"poison-ref-{seed}")
    shutil.rmtree(ref_base, ignore_errors=True)
    ref = Daemon(ref_base, device=device)
    try:
        _create_stream(ref, "mask", _GUARDED_ACC, kwargs={"policy": "mask"})
        _create_stream(ref, "reject", _GUARDED_ACC, kwargs={"policy": "reject"})
        _create_stream(ref, "mse", _GUARDED_MSE, kwargs={"policy": "propagate"})
        want = {
            "mask": _feed_and_drain(ref, "mask", [_strip_invalid_rows(b) for b in mask_lines]),
            "reject": _feed_and_drain(
                ref, "reject", [b for i, b in enumerate(reject_lines) if i not in vetoed]),
            "mse": _feed_and_drain(
                ref, "mse", [b for i, b in enumerate(mse_lines) if i not in poison_at]),
        }
    finally:
        ref.sigterm()
    for name in ("mask", "reject", "mse"):
        _check(results[name] == want[name],
               f"{name} diverged from its valid-subsequence reference: "
               f"{results[name]} != {want[name]}")
    return {
        "leg": "poison", "seed": seed, "results": results, "quarantined": poison_at,
        "masked_rows": sum(injected_rows.values()), "rejected_batches": len(vetoed),
        "rollbacks": len(poison_at), "health_walk": ["ok", "degraded", "ok"],
    }


# ------------------------------------------------------------------- fleet


class FleetProc:
    """One fleet-aggregator subprocess (``fleet serve``) + its parsed ready
    line."""

    def __init__(self, base_dir: str, leaves=None, pull_interval_s: float = 0.2,
                 timeout_s: float = 120.0, device: str = "cuda") -> None:
        self.base_dir = base_dir
        cmd = ["fleet", "serve", "--base-dir", base_dir, "--pull-interval-s", str(pull_interval_s)]
        for name, url in sorted((leaves or {}).items()):
            cmd += ["--leaf", f"{name}={url}"]
        self.proc, ready, ready_s = _spawn(cmd, base_dir, "", device, timeout_s, "aggregator")
        Daemon.ready_log.append(ready_s)
        self.host, self.port = ready["http"]
        self.epoch = ready.get("epoch")

    def http(self, method: str, path: str, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://{self.host}:{self.port}{path}", data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as err:
            return err.code, json.loads(err.read())

    def fleet_status(self):
        _, body = self.http("GET", "/v1/fleet")
        return body

    def leaf_state(self, name: str) -> str:
        return self.fleet_status().get("leaves", {}).get(name, {}).get("state", "?")

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def sigterm(self) -> None:
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def ensure_dead(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _start_corrupt_leaf():
    """An in-thread HTTP stub that answers ``/v1/state`` with a structurally
    valid export whose checkpoint carries a FOREIGN fingerprint — the
    validate-ALL-then-apply ladder must reject it and the aggregator must
    quarantine the leaf (naming it) without half-folding anything."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    export = {
        "v": 1, "ok": True, "epoch": "stub-epoch", "streams": {"soak": {
            "v": 1, "ok": True, "stream": "soak", "watermark": 3, "kind": "metric",
            "fingerprint": "deadbeefdeadbeef", "windowed": False,
            "spec": {"target": _CHECKED, "kwargs": {}},
            "state": {"payload_version": 1, "cursor": 3, "kind": "metric", "checkpoint": {
                "format_version": 1, "class": "BinaryAccuracy", "fingerprint": "deadbeefdeadbeef",
                "metrics": {"": {"fingerprint": "deadbeefdeadbeef", "update_count": 3, "state": {
                    "tp": {"__nd__": "int32", "shape": [], "data": 4},
                    "fp": {"__nd__": "int32", "shape": [], "data": 2},
                    "tn": {"__nd__": "int32", "shape": [], "data": 5},
                    "fn": {"__nd__": "int32", "shape": [], "data": 1},
                }, "host_counters": {}}},
            }},
        }},
    }

    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            body = json.dumps(export).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True, name="corrupt-leaf")
    thread.start()
    host, port = server.server_address[:2]
    return server, f"http://{host}:{port}"


def run_fleet_leg(workdir: str, seed: int, n_leaves: int = 3, n_batches: int = 8,
                  device: str = "cuda"):
    """The federation drill: N real leaves + one corrupt stub leaf under one
    aggregator; a leaf is SIGKILLed and restarted mid-fold (replayed prefix
    must dedup via the epoch/watermark protocol), the aggregator itself is
    SIGKILLed and resumes from its fold store, and the drained fleet
    aggregate must equal the single-daemon reference bitwise while
    ``/healthz`` degrades with a coverage reason for the quarantined stub."""
    batches = make_batches(n_batches * n_leaves, per_batch=4, seed=seed)
    names = [f"leaf{i}" for i in range(n_leaves)]
    per_leaf = {name: batches[i * n_batches:(i + 1) * n_batches] for i, name in enumerate(names)}
    half = n_batches // 2
    victim = names[min(1, n_leaves - 1)]

    # a restarted leaf must come back at its REGISTERED address (the
    # aggregator's registry is the source of truth, like any real fleet),
    # so every leaf gets a pinned port it rebinds across its restart
    import socket as _socket
    ports = {}
    for name in names:
        with _socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports[name] = sock.getsockname()[1]

    leaves = {}
    stub_server = agg = None
    bases = {}
    try:
        for name in names:
            base = os.path.join(workdir, f"fleet-{name}-{seed}")
            shutil.rmtree(base, ignore_errors=True)
            bases[name] = base
            daemon = Daemon(base, port=ports[name], device=device)
            _, reply = daemon.http("POST", "/v1/streams", {
                "name": "soak", "target": _CHECKED, "snapshot_every_n": 2, "use_feed": False,
            })
            _check(reply.get("ok"), f"fleet leaf {name} create failed: {reply}")
            leaves[name] = daemon
        stub_server, stub_url = _start_corrupt_leaf()

        agg_base = os.path.join(workdir, f"fleet-agg-{seed}")
        shutil.rmtree(agg_base, ignore_errors=True)
        urls = {name: f"http://{d.host}:{d.port}" for name, d in leaves.items()}
        urls["corrupt"] = stub_url
        agg = FleetProc(agg_base, leaves=urls, device=device)

        # first half everywhere, flushed — the fold is live from here on
        for name in sorted(leaves):
            for seq in range(half):
                _ingest(leaves[name], "soak", seq, per_leaf[name][seq])
            leaves[name].http("POST", "/v1/streams/soak/flush")

        def _watermark(status_body, leaf):
            return status_body.get("leaves", {}).get(leaf, {}).get("streams", {}).get(
                "soak", {}).get("watermark", -1)

        _wait(lambda: all(_watermark(agg.fleet_status(), n) >= half for n in names),
              90.0, "the aggregator to pull every leaf's first half")
        _wait(lambda: agg.leaf_state("corrupt") == "quarantined", 60.0,
              "the corrupt stub to be quarantined")

        # SIGKILL one leaf MID-FOLD; the aggregator must classify it
        # unreachable while its last slot keeps contributing
        leaves[victim].sigkill()
        _wait(lambda: agg.leaf_state(victim) == "unreachable", 60.0,
              f"{victim} to be classified unreachable")
        _, health = agg.http("GET", "/healthz")
        _check(health.get("state") == "degraded", f"fleet health should be degraded: {health}")
        _check("coverage" in str(health.get("reason")),
               f"degraded reason should carry the coverage: {health}")

        # restart the victim (restore from snapshot) and replay its suffix —
        # the replayed prefix must dedup against the retained higher-watermark
        # slot of the old epoch, never double-count
        leaves[victim] = Daemon(bases[victim], port=ports[victim], device=device)
        status = leaves[victim].stream_status("soak")
        next_seq = int(status["next_seq"])
        _check(next_seq <= half, f"restart over-resumed {victim}: {status}")
        for name in sorted(leaves):
            start = next_seq if name == victim else half
            for seq in range(start, n_batches):
                _ingest(leaves[name], "soak", seq, per_leaf[name][seq])
            leaves[name].http("POST", "/v1/streams/soak/flush")

        # SIGKILL the aggregator mid-fold; the restart must resume its slots
        # and registry from disk instead of re-pulling history
        pre_kill = agg.fleet_status()
        _check(pre_kill.get("fold_seq", 0) >= 1, f"no fold state persisted before the kill: {pre_kill}")
        agg.sigkill()
        agg = FleetProc(agg_base, device=device)  # registry comes from leaves.json, slots from the fold store
        resumed = agg.fleet_status()
        _check(set(resumed.get("leaves", {})) == set(urls),
               f"aggregator restart lost the registry: {sorted(resumed.get('leaves', {}))}")

        _wait(lambda: all(_watermark(agg.fleet_status(), n) == n_batches for n in names),
              90.0, "every leaf's final watermark to reach the aggregator")
        _wait(lambda: all(agg.leaf_state(n) == "fresh" for n in names), 60.0,
              "every real leaf to settle fresh")
        _wait(lambda: agg.leaf_state("corrupt") == "quarantined", 60.0,
              "the corrupt stub to stay quarantined after the restart")

        _, agg_reply = agg.http("GET", "/v1/fleet/aggregate")
        _check(agg_reply.get("ok"), f"aggregate failed: {agg_reply}")
        expected_coverage = n_leaves / (n_leaves + 1)
        _check(abs(agg_reply["coverage"] - expected_coverage) < 1e-9,
               f"coverage should be {expected_coverage}: {agg_reply['coverage']}")
        _check(agg_reply["leaves"]["corrupt"]["state"] == "quarantined"
               and "fingerprint" in str(agg_reply["leaves"]["corrupt"]["reason"]),
               f"quarantine should name the defect: {agg_reply['leaves']['corrupt']}")
        got = agg_reply["streams"]["soak"]["value"]

        _, health = agg.http("GET", "/healthz")
        _check(health.get("state") == "degraded" and "corrupt" in str(health.get("reason")),
               f"health should stay degraded naming the quarantined leaf: {health}")
    finally:
        if agg is not None:
            agg.ensure_dead()
        if stub_server is not None:
            stub_server.shutdown()
            stub_server.server_close()
        for daemon in leaves.values():
            daemon.sigterm()

    # the single-daemon truth: one stream fed every leaf's batches grouped in
    # sorted-leaf order (the fold's deterministic concatenation order)
    want = _reference_results(
        workdir, [b for name in sorted(per_leaf) for b in per_leaf[name]], f"fleet-{seed}", device
    )
    _check(got == want, f"fleet aggregate diverged from the single-daemon reference: {got} != {want}")
    return {"leg": "fleet", "seed": seed, "aggregate": got, "coverage": expected_coverage,
            "victim": victim, "quarantined": ["corrupt"]}


# ------------------------------------------------------------------- main


def _timed(leg, *args, **kwargs):
    """Run one leg; add its wall ``seconds`` and the ``ready_s`` of every
    daemon and aggregator it started to its report."""
    mark, started = len(Daemon.ready_log), time.monotonic()
    report = leg(*args, **kwargs)
    report["seconds"] = time.monotonic() - started
    report["ready_s"] = Daemon.ready_log[mark:]
    return report


def run_short(workdir: str, seed: int, device: str = "cuda"):
    return [_timed(run_main_leg, workdir, seed, device=device),
            _timed(run_circuit_leg, workdir, seed, device=device)]


def run_fleet(workdir: str, seed: int, device: str = "cuda"):
    return [_timed(run_fleet_leg, workdir, seed, device=device)]


def run_poison(workdir: str, seed: int, device: str = "cuda"):
    return [_timed(run_poison_leg, workdir, seed, device=device)]


def run_long(workdir: str, seed: int, rounds: int, device: str = "cuda"):
    """Seeded randomized soak: each round draws its own fault schedule from
    the master seed and must uphold the same invariants."""
    rng = random.Random(seed)
    reports = []
    for round_no in range(rounds):
        n_batches = rng.randint(8, 16)
        params = {
            "seed": rng.randint(0, 2**31 - 1),
            "n_batches": n_batches,
            "crash_after": rng.randint(1, n_batches - 2),
            "enospc_after": rng.randint(1, 3),
            "poison_at": rng.randint(1, n_batches - 2),
            "kill_after": rng.choice([None, n_batches - 1, n_batches]),
        }
        print(json.dumps({"round": round_no, "params": params}), flush=True)
        reports.append(_timed(run_main_leg, workdir, device=device, **params))
        if round_no % 2 == 1:
            reports.append(_timed(run_circuit_leg, workdir, seed=params["seed"], device=device))
    return reports


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="chaos", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", required=True, help="scratch root for daemon base dirs")
    parser.add_argument("--mode", choices=("short", "long", "fleet", "poison"), default="short")
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--rounds", type=int, default=3, help="long-mode rounds")
    parser.add_argument("--device", default="cuda",
                        help="device of every daemon and aggregator (default cuda; cpu runs them on the host)")
    args = parser.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    try:
        if args.mode == "short":
            reports = run_short(workdir, args.seed, args.device)
        elif args.mode == "fleet":
            reports = run_fleet(workdir, args.seed, args.device)
        elif args.mode == "poison":
            reports = run_poison(workdir, args.seed, args.device)
        else:
            reports = run_long(workdir, args.seed, args.rounds, args.device)
    except ChaosFailure as err:
        print(json.dumps({"ok": False, "invariant": str(err)}), flush=True)
        return 1
    print(json.dumps({"ok": True, "mode": args.mode, "device": args.device, "legs": reports}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
