# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's metricserve CLI end to end (counterpart of
``tests/unittests/serve/test_metricserve_cli.py``): a real daemon subprocess,
``python -m torchmetrics_tpu_torch.serve serve --device cpu``, driven by the
wire-only ctl client, SIGKILL chaos and SIGTERM grace; and the JAX package's
``tools/metricserve.py ctl`` driving a port daemon unchanged.

pytest-timeout is not installed here: every subprocess wait and status poll
carries its own deadline, and each is generous (at least 60 s), because a
slow host stretches process start-up.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).parent.parent
_CTL = str(_REPO_ROOT / "torchmetrics_tpu_torch" / "serve" / "__main__.py")
_JAX_CLI = str(_REPO_ROOT / "tools" / "metricserve.py")
_WAIT_S = 120


def _poisoned_env(tmp_path):
    """ctl must never import jax, torch or either package: poisoned modules
    make any attempt fatal (the ctl runs as the file's path, so Python
    imports no package first)."""
    poison = tmp_path / "poison"
    poison.mkdir(exist_ok=True)
    for mod in ("jax", "torch", "torchmetrics_tpu", "torchmetrics_tpu_torch"):
        (poison / f"{mod}.py").write_text(f"raise ImportError('metricserve ctl must not import {mod}')\n")
    return dict(os.environ, PYTHONPATH=str(poison))


def _start_daemon(base_dir, **env):
    """``python -m torchmetrics_tpu_torch.serve serve --device cpu``; the
    daemon imports the port and never JAX, which a poisoned ``jax`` proves."""
    poison = Path(base_dir).parent / "no_jax"
    poison.mkdir(parents=True, exist_ok=True)
    (poison / "jax.py").write_text("raise ImportError('the port must not import jax')\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchmetrics_tpu_torch.serve", "serve", "--base-dir", str(base_dir), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(_REPO_ROOT), str(poison)]), **env),
        cwd=str(_REPO_ROOT),
    )
    ready = proc.stdout.readline()
    assert ready, proc.stderr.read()
    info = json.loads(ready)
    assert info["ok"] and info["pid"] == proc.pid
    return proc, info


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.communicate(timeout=_WAIT_S)


def _ctl(env, *args, stdin=None, cli=_CTL):
    return subprocess.run(
        [sys.executable, cli, "ctl", *args],
        input=stdin, capture_output=True, text=True, timeout=_WAIT_S, env=env, cwd=str(_REPO_ROOT),
    )


def _batches_jsonl(n_batches=6, n=48, seed=3):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, n)
    return "\n".join(
        json.dumps([p.tolist(), t.tolist()])
        for p, t in zip(np.array_split(preds, n_batches), np.array_split(target, n_batches))
    ) + "\n"


def test_serve_ready_line_ctl_round_trip_and_sigterm_drain(tmp_path):
    base = tmp_path / "base"
    proc, info = _start_daemon(base)
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        # the socket path is discoverable from the ready line too
        assert info["socket"] == str(base / "ingest.sock")

        out = _ctl(env, "--http", http, "create", "--name", "m1",
                   "--target", "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                   "--snapshot-every-n", "2", "--json")
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["next_seq"] == 0

        # replay over the persistent unix socket (the ingest fast path)
        jsonl = _batches_jsonl()
        out = _ctl(env, "--socket", info["socket"], "replay", "m1", stdin=jsonl)
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout)
        assert summary["acked"] == 6 and summary["skipped"] == 0

        # re-running the SAME replay is a no-op: everything skips as duplicate
        out = _ctl(env, "--http", http, "--socket", info["socket"], "replay", "m1", stdin=jsonl)
        assert json.loads(out.stdout)["sent"] == 0

        out = _ctl(env, "--http", http, "status", "m1", "--json")
        status = json.loads(out.stdout)
        assert status["state"] == "serving" and status["next_seq"] == 6

        # SIGTERM = graceful drain: every admitted batch applies, results print
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=_WAIT_S)
        assert proc.returncode == 0, stderr
        assert json.loads(stdout.splitlines()[-1]) == {"ok": True, "drained": ["m1"]}
    finally:
        if proc.poll() is None:
            proc.kill()


def test_sigkill_restart_resumes_with_parity(tmp_path):
    """The acceptance chaos, through the real process boundary: SIGKILL the
    daemon mid-stream, restart it on the same base dir, replay the same
    JSONL — the drained result equals an uninterrupted daemon's, exactly."""
    jsonl = _batches_jsonl()
    env = _poisoned_env(tmp_path)
    spec_args = ["create", "--name", "m1",
                 "--target", "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                 "--snapshot-every-n", "2"]

    # uninterrupted reference daemon
    ref_proc, ref_info = _start_daemon(tmp_path / "ref")
    try:
        http = "{}:{}".format(*ref_info["http"])
        assert _ctl(env, "--http", http, *spec_args).returncode == 0
        assert _ctl(env, "--socket", ref_info["socket"], "replay", "m1", stdin=jsonl).returncode == 0
        out = _ctl(env, "--http", http, "drain", "m1", "--json")
        want = json.loads(out.stdout)["results"]
    finally:
        ref_proc.kill()
        ref_proc.communicate(timeout=_WAIT_S)

    # chaos daemon: ingest part of the stream, flush a snapshot, SIGKILL
    base = tmp_path / "chaos"
    proc, info = _start_daemon(base)
    http = "{}:{}".format(*info["http"])
    try:
        assert _ctl(env, "--http", http, *spec_args).returncode == 0
        partial = "\n".join(jsonl.splitlines()[:4]) + "\n"
        assert _ctl(env, "--socket", info["socket"], "replay", "m1", stdin=partial).returncode == 0
        assert _ctl(env, "--http", http, "flush", "m1").returncode == 0
        proc.send_signal(signal.SIGKILL)  # no drain, no goodbye
        proc.communicate(timeout=_WAIT_S)
        assert proc.returncode == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()

    # restart on the same base dir: the stream is already there, resumed at
    # its snapshot cursor; replaying the SAME file sends only the suffix
    proc, info = _start_daemon(base)
    http = "{}:{}".format(*info["http"])
    try:
        out = _ctl(env, "--http", http, "status", "m1", "--json")
        resumed_at = json.loads(out.stdout)["next_seq"]
        assert 0 < resumed_at <= 4, out.stdout
        out = _ctl(env, "--socket", info["socket"], "replay", "m1", stdin=jsonl)
        summary = json.loads(out.stdout)
        assert summary["skipped"] == resumed_at and summary["acked"] == 6 - resumed_at
        out = _ctl(env, "--http", http, "drain", "m1", "--json")
        got = json.loads(out.stdout)["results"]
        assert got == want  # bitwise through JSON binary64
    finally:
        proc.kill()
        proc.communicate(timeout=_WAIT_S)


def test_ctl_reports_wire_errors_cleanly(tmp_path):
    proc, info = _start_daemon(tmp_path / "base")
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        out = _ctl(env, "--http", http, "status", "ghost")
        assert out.returncode == 1
        assert "error [not_found]" in out.stderr
        out = _ctl(env, "--http", http, "create", "--name", "bad/name",
                   "--target", "torchmetrics_tpu_torch.serve.factories:binary_accuracy")
        assert out.returncode == 1 and "bad_request" in out.stderr
    finally:
        proc.kill()
        proc.communicate(timeout=_WAIT_S)


def _start_daemon_with_faults(base_dir, fault_spec):
    return _start_daemon(base_dir, TM_TPU_FAULTS=fault_spec)


def _poll_status(env, http, name, predicate, timeout_s=_WAIT_S):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        out = _ctl(env, "--http", http, "status", name, "--json")
        if out.returncode == 0:
            status = json.loads(out.stdout)
            if predicate(status):
                return status
        time.sleep(0.1)
    raise AssertionError(f"status predicate never held for {name}")


def test_ctl_deadletter_quarantine_requeue_purge_cycle(tmp_path):
    """The repair verbs end to end: a poison batch quarantines to
    deadletter.jsonl, ``deadletter list`` shows it, ``requeue`` re-admits it
    at the watermark (where it poisons AGAIN and re-quarantines under its
    new seq), and ``purge`` drops it for good — all through the wire-only ctl."""
    base = tmp_path / "base"
    proc, info = _start_daemon(base)
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        spec = json.dumps({
            "name": "toxic",
            "target": "torchmetrics_tpu_torch.serve.factories:checked_binary_accuracy",
            "snapshot_every_n": 2, "poison_threshold": 1, "backoff_base_s": 0.01,
        })
        assert _ctl(env, "--http", http, "create", "--spec", spec).returncode == 0

        lines = _batches_jsonl().splitlines()
        lines[2] = json.dumps([[0.5, 0.5, 0.5], [7, 7, 7]])  # clean avals, poison values
        out = _ctl(env, "--socket", info["socket"], "replay", "toxic", stdin="\n".join(lines) + "\n")
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["acked"] == 6

        _poll_status(env, http, "toxic",
                     lambda s: s["deadletter_depth"] == 1 and s["pending"] == 0 and s["state"] == "serving")
        out = _ctl(env, "--http", http, "deadletter", "toxic", "list", "--json")
        listing = json.loads(out.stdout)
        assert listing["depth"] == 1 and listing["deadletter"][0]["seq"] == 2
        assert (base / "streams" / "toxic" / "deadletter.jsonl").exists()

        # requeue: the poison re-enters at the watermark, kills the worker
        # once more, and re-quarantines under its NEW seq
        out = _ctl(env, "--http", http, "deadletter", "toxic", "requeue", "--seq", "2", "--json")
        assert out.returncode == 0, out.stderr
        as_seq = json.loads(out.stdout)["as_seq"]
        assert as_seq == 6
        status = _poll_status(env, http, "toxic",
                              lambda s: s["deadletter_depth"] == 1 and s["pending"] == 0)
        out = _ctl(env, "--http", http, "deadletter", "toxic", "list", "--json")
        assert json.loads(out.stdout)["deadletter"][0]["seq"] == as_seq

        # purge is the one sanctioned drop
        out = _ctl(env, "--http", http, "deadletter", "toxic", "purge", "--seq", str(as_seq), "--json")
        assert out.returncode == 0 and json.loads(out.stdout)["depth"] == 0
        status = _poll_status(env, http, "toxic", lambda s: s["dropped"] == 1)
        assert status["deadletter_depth"] == 0
        out = _ctl(env, "--http", http, "drain", "toxic", "--json")
        assert out.returncode == 0, out.stderr
    finally:
        proc.kill()
        proc.communicate(timeout=_WAIT_S)


def test_ctl_revive_half_opens_a_parked_circuit(tmp_path):
    """``ctl revive`` end to end: a worker crash parks a zero-budget stream
    with the circuit open, revive half-opens it, the fault-free probe
    incarnation heals, and the full replay + drain completes."""
    proc, info = _start_daemon_with_faults(tmp_path / "base", "fail:serve.worker.crash:count=1")
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        spec = json.dumps({
            "name": "breaker",
            "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
            "snapshot_every_n": 2, "max_restarts": 0, "backoff_base_s": 0.01,
        })
        assert _ctl(env, "--http", http, "create", "--spec", spec).returncode == 0
        jsonl = _batches_jsonl()
        first = jsonl.splitlines()[0] + "\n"
        assert _ctl(env, "--socket", info["socket"], "replay", "breaker", stdin=first).returncode == 0

        status = _poll_status(env, http, "breaker",
                              lambda s: s["state"] == "failed" and s["circuit"] == "open")
        assert "revive" in status["failure"] and status["dropped"] == 0

        out = _ctl(env, "--http", http, "revive", "breaker", "--json")
        assert out.returncode == 0, out.stderr
        reply = json.loads(out.stdout)
        assert reply["revived"] is True

        out = _ctl(env, "--socket", info["socket"], "replay", "breaker", stdin=jsonl)
        assert out.returncode == 0, out.stderr
        summary = json.loads(out.stdout)
        assert summary["skipped"] == 1 and summary["acked"] == 5
        _poll_status(env, http, "breaker",
                     lambda s: s["pending"] == 0 and s["circuit"] == "closed" and s["restarts"] == 0)
        out = _ctl(env, "--http", http, "drain", "breaker", "--json")
        assert out.returncode == 0 and json.loads(out.stdout)["cursor"] == 6
    finally:
        proc.kill()
        proc.communicate(timeout=_WAIT_S)


def test_replay_backoff_caps_at_max_retry_s(tmp_path):
    """A stream whose worker is stuck (injected per-apply delay, queue of 1)
    backpressures forever: replay retries with backoff, then fails LOUDLY
    naming the stalled seq once ``--max-retry-s`` is spent — it never hangs."""
    proc, info = _start_daemon_with_faults(tmp_path / "base", "delay:serve.worker.crash:arg=120")
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        spec = json.dumps({
            "name": "stuck",
            "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
            "queue_max": 1,
        })
        assert _ctl(env, "--http", http, "create", "--spec", spec).returncode == 0
        out = _ctl(env, "--socket", info["socket"], "replay", "stuck", "--max-retry-s", "2",
                   stdin=_batches_jsonl())
        assert out.returncode == 1
        assert "backpressure" in out.stderr and "--max-retry-s 2" in out.stderr
        assert "seq" in out.stderr
    finally:
        proc.kill()
        proc.communicate(timeout=_WAIT_S)


def test_jax_ctl_drives_a_port_daemon_unchanged(tmp_path):
    """The JAX package's ``tools/metricserve.py ctl`` (unedited, jax-free)
    drives a port daemon over HTTP and the socket: create with JAX's factory
    path, replay, status, flush, drain; the drained result equals the port's
    in-process run. The port's ctl under ``-m`` reads the same daemon."""
    from torchmetrics_tpu_torch.serve.stream import decode_batch, resolve_target

    proc, info = _start_daemon(tmp_path / "base")
    try:
        http = "{}:{}".format(*info["http"])
        env = _poisoned_env(tmp_path)
        out = _ctl(env, "--http", http, "create", "--name", "m1",
                   "--target", "torchmetrics_tpu.serve.factories:binary_accuracy",
                   "--snapshot-every-n", "2", "--json", cli=_JAX_CLI)
        assert out.returncode == 0 and json.loads(out.stdout)["next_seq"] == 0, out.stderr
        jsonl = _batches_jsonl()
        out = _ctl(env, "--socket", info["socket"], "replay", "m1", stdin=jsonl, cli=_JAX_CLI)
        assert out.returncode == 0 and json.loads(out.stdout)["acked"] == 6, out.stderr
        out = subprocess.run(
            [sys.executable, "-m", "torchmetrics_tpu_torch.serve", "ctl", "--http", http, "status", "m1", "--json"],
            capture_output=True, text=True, timeout=_WAIT_S, cwd=str(_REPO_ROOT),
        )
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["next_seq"] == 6
        out = _ctl(env, "--http", http, "flush", "m1", "--json", cli=_JAX_CLI)
        assert out.returncode == 0 and json.loads(out.stdout)["cursor"] == 6, out.stdout
        out = _ctl(env, "--http", http, "drain", "m1", "--json", cli=_JAX_CLI)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout)["results"]
        out = _ctl(env, "--http", http, "status", "ghost", cli=_JAX_CLI)
        assert out.returncode == 1 and "error [not_found]" in out.stderr
    finally:
        _stop(proc)
    ref = resolve_target("torchmetrics_tpu.serve.factories:binary_accuracy", device="cpu")
    for line in jsonl.splitlines():
        ref.update(*decode_batch(json.loads(line)))
    assert got == float(ref.compute())
