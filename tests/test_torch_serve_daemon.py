# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's ServeDaemon on the CPU (counterpart of
``tests/unittests/serve/test_daemon.py`` and ``test_drift_stream.py``):
registry, HTTP/socket planes, chaos restart parity, health, drift streams;
and a daemon of one package restarting over the other's base directory."""
from __future__ import annotations

import functools
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.serve import ServeDaemon as _ServeDaemon

CPU = "cpu"
# the port's entry points default to the card; these tests run them on the CPU
ServeDaemon = functools.partial(_ServeDaemon, device=CPU)

_SEED = 11


def _http(daemon, method, path, body=None):
    """One control-plane round trip; returns (http_status, parsed body, headers)."""
    host, port = daemon.http_address()
    data = None if body is None else json.dumps({"v": 1, **body}).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read()), dict(err.headers)


def _four_stream_fixtures(n_batches=6, n=96):
    """Specs + wire batches for the chaos quartet: plain, fused collection,
    sliced and windowed — the ≥ 4 concurrent stream shapes of the chaos drill."""
    rng = np.random.RandomState(_SEED)
    labels = rng.randint(0, 4, n)
    target4 = rng.randint(0, 4, n)
    probs = rng.rand(n, 4).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    keys = rng.randint(0, 4, n)
    bpreds = rng.rand(n).astype(np.float32)
    btarget = rng.randint(0, 2, n)

    def split(*cols):
        return [
            [np.array_split(c, n_batches)[k].tolist() for c in cols] for k in range(n_batches)
        ]

    specs = {
        "plain": {"name": "plain", "target": "torchmetrics_tpu_torch.serve.factories:accuracy",
                  "snapshot_every_n": 4, "use_feed": False},
        "fusedc": {"name": "fusedc", "target": "torchmetrics_tpu_torch.serve.factories:collection",
                   "fused": True, "fused_options": {"cat_capacity": 128},
                   "snapshot_every_n": 4, "use_feed": False},
        "sliced": {"name": "sliced", "target": "torchmetrics_tpu_torch.serve.factories:sliced_accuracy",
                   "kwargs": {"num_classes": 4, "num_cells": 4}, "snapshot_every_n": 4,
                   "use_feed": True},
        "windowed": {"name": "windowed", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                     "window": {"slots": 3, "every_n": 2}, "snapshot_every_n": 4, "use_feed": False},
    }
    batches = {
        "plain": split(labels, target4),
        "fusedc": split(probs, target4),
        "sliced": split(keys, labels, target4),
        "windowed": split(bpreds, btarget),
    }
    return specs, batches


def _ingest_all(daemon, batches, start_at=None):
    """Offer every batch from each stream's start seq; stops a stream's feed
    at the first hard failure (the injected kill)."""
    clean = True
    for name in sorted(batches):
        for seq in range((start_at or {}).get(name, 0), len(batches[name])):
            reply = daemon.ingest(name, seq, batches[name][seq], block=True, deadline_s=30.0)
            if not reply.get("ok"):
                clean = False
                break
    return clean


def _drain_all(daemon, names):
    results = {}
    for name in sorted(names):
        reply = daemon.drain_stream(name)
        assert reply["ok"], reply
        results[name] = reply["results"]
    return results


class TestChaosRestartParity:
    def test_kill_restart_replay_is_bitwise_equal(self, tmp_path):
        """Chaos acceptance: ≥ 4 concurrent streams (fused, sliced, windowed
        among them) survive a mid-ingest worker kill — now SUPERVISED back to
        serving (restart + retained-buffer replay, no client involvement) —
        plus a drainless teardown, the in-process twin of SIGKILL's durable
        footprint (snapshots + specs only); the restarted daemon's resumed
        results are EXACTLY the uninterrupted run's."""
        specs, batches = _four_stream_fixtures()

        # the uninterrupted reference run
        ref = ServeDaemon(str(tmp_path / "ref"), publish=False).start()
        for name in sorted(specs):
            assert ref.create_stream(specs[name])["ok"]
        assert _ingest_all(ref, batches)
        want = _drain_all(ref, specs)
        ref.shutdown(drain=False)

        # the chaos run: a lockstep preemption kills one stream's worker
        # mid-ingest; the supervisor heals it (every ack still lands), then
        # the daemon is torn down WITHOUT drain
        chaos_dir = str(tmp_path / "chaos")
        daemon = ServeDaemon(chaos_dir, publish=False).start()
        for name in sorted(specs):
            assert daemon.create_stream(specs[name])["ok"]
        with faults.inject(faults.Fault("preempt", "runner.preempt", after=5, count=1)):
            assert _ingest_all(daemon, batches)
            healed = False
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                streams = daemon.status()["streams"]
                if (
                    any(s["restarts"] >= 1 for s in streams)
                    and all(s["state"] == "serving" and s["pending"] == 0 for s in streams)
                ):
                    healed = True
                    break
                time.sleep(0.02)
        assert healed, "the injected worker kill was never supervised back to serving"
        assert all(s["dropped"] == 0 for s in daemon.status()["streams"])
        daemon.shutdown(drain=False)

        # restart = resume: every spec.json rebuilds its stream at the
        # snapshot cursor; the client replays exactly the unpersisted suffix
        daemon = ServeDaemon(chaos_dir, publish=False).start()
        status = daemon.status()
        start_at = {s["name"]: s["next_seq"] for s in status["streams"]}
        assert set(start_at) == set(specs), "restart lost a stream"
        assert any(v < 6 for v in start_at.values()), f"nothing to replay: {start_at}"
        assert _ingest_all(daemon, batches, start_at)
        got = _drain_all(daemon, specs)
        daemon.shutdown(drain=False)

        # bitwise: results travelled JSON (binary64-exact) both times
        assert got == want

    def test_restart_after_clean_drain_reports_drained_results(self, tmp_path):
        specs, batches = _four_stream_fixtures(n_batches=2, n=16)
        daemon = ServeDaemon(str(tmp_path), publish=False).start()
        assert daemon.create_stream(specs["plain"])["ok"]
        assert _ingest_all(daemon, {"plain": batches["plain"]})
        drained = daemon.shutdown(drain=True)
        assert drained["plain"]["ok"] and drained["plain"]["cursor"] == 2
        # per-stream costs ledger lands at the compute boundary
        assert os.path.isfile(os.path.join(str(tmp_path), "streams", "plain", "costs.json"))


class TestHttpPlane:
    @pytest.fixture()
    def daemon(self, tmp_path):
        d = ServeDaemon(str(tmp_path), publish=False).start()
        yield d
        d.shutdown(drain=False)

    def test_crud_and_ingest_round_trip(self, daemon):
        code, reply, _ = _http(daemon, "POST", "/v1/streams", {
            "name": "m1", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
            "use_feed": False,
        })
        assert code == 200 and reply["ok"] and reply["next_seq"] == 0
        code, reply, _ = _http(daemon, "POST", "/v1/streams", {
            "name": "m1", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
        })
        assert code == 409 and reply["error"]["code"] == "exists"

        batch = [[0.9, 0.1], [1, 0]]
        code, reply, _ = _http(daemon, "POST", "/v1/streams/m1/ingest", {"seq": 0, "batch": batch})
        assert code == 200 and reply["next_seq"] == 1
        # a gap is a 409 carrying the expected seq — the client rewinds
        code, reply, _ = _http(daemon, "POST", "/v1/streams/m1/ingest", {"seq": 7, "batch": batch})
        assert code == 409 and reply["error"]["code"] == "bad_seq" and reply["error"]["expected"] == 1

        code, reply, _ = _http(daemon, "GET", "/v1/streams/m1")
        assert code == 200 and reply["state"] == "serving" and reply["next_seq"] == 1
        code, reply, _ = _http(daemon, "POST", "/v1/streams/m1/flush")
        assert code == 200 and reply["cursor"] == 1
        code, reply, _ = _http(daemon, "POST", "/v1/streams/m1/drain")
        assert code == 200 and reply["results"] == 1.0

        code, reply, _ = _http(daemon, "DELETE", "/v1/streams/m1")
        assert code == 200 and reply["ok"]
        assert not os.path.isdir(os.path.join(daemon.base_dir, "streams", "m1"))
        code, reply, _ = _http(daemon, "GET", "/v1/streams/m1")
        assert code == 404 and reply["error"]["code"] == "not_found"

    def test_bad_requests_are_400s_not_hangups(self, daemon):
        code, reply, _ = _http(daemon, "POST", "/v1/streams", {"name": "x"})
        assert code == 400 and "target" in reply["error"]["message"]
        code, reply, _ = _http(daemon, "POST", "/v1/streams", {"name": "m2", "target": "nope"})
        assert code == 400 and reply["error"]["code"] == "bad_request"
        code, reply, _ = _http(daemon, "GET", "/wat")
        assert code == 404
        # a future wire version is refused instead of guessed at
        host, port = daemon.http_address()
        req = urllib.request.Request(
            f"http://{host}:{port}/v1/streams", data=json.dumps({"v": 99, "name": "z"}).encode(),
            method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400

    def test_backpressure_is_429_with_retry_after(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=False).start()
        try:
            assert daemon.create_stream({
                "name": "q", "target": "torchmetrics_tpu_torch.serve.factories:quantile",
                "queue_max": 1, "use_feed": False,
            })["ok"]
            batch = [np.zeros(8, np.float32).tolist()]
            saw_429 = False
            seq = 0
            for _ in range(300):
                code, reply, headers = _http(daemon, "POST", "/v1/streams/q/ingest",
                                             {"seq": seq, "batch": batch})
                if code == 200:
                    seq = reply["next_seq"]
                elif code == 429:
                    assert reply["error"]["code"] == "backpressure"
                    assert float(headers["Retry-After"]) > 0
                    saw_429 = True
                    break
                else:
                    raise AssertionError((code, reply))
            assert saw_429, "queue_max=1 never pushed back over HTTP"
            # admission control never dropped anything: the drain applies
            # every acked batch and the latched counter stays zero
            reply = daemon.drain_stream("q")
            assert reply["ok"] and reply["cursor"] == seq
            assert daemon._get("q").dropped == 0
        finally:
            daemon.shutdown(drain=False)


class TestHealth:
    def test_healthz_is_worst_stream(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=False).start()
        try:
            for name in ("good", "bad"):
                assert daemon.create_stream({
                    "name": name, "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                    "use_feed": False,
                    # "bad" parks on the FIRST crash (no restart budget), so
                    # the worst-stream health flip is deterministic
                    "max_restarts": 0,
                })["ok"]
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 200 and body["state"] == "ok"

            with faults.inject(faults.Fault("fail", "runner.preempt", count=1)):
                daemon.ingest("bad", 0, [[0.9], [1]])
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    if daemon._get("bad").status()["state"] == "failed":
                        break
                    time.sleep(0.02)
            status = daemon._get("bad").status()
            assert status["state"] == "failed" and status["circuit"] == "open"
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 503 and body["state"] == "stalled"
            assert "bad" in body["reason"]
            # the healthy stream is untouched — health is worst-of, not avg
            assert daemon._get("good").status()["state"] == "serving"
            # ctl revive half-opens the circuit; the probe incarnation
            # replays the retained batch (the fault is spent) and heals
            reply = daemon.revive_stream("bad")
            assert reply["ok"] and reply["revived"], reply
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                status = daemon._get("bad").status()
                if status["state"] == "serving" and status["pending"] == 0 and status["circuit"] == "closed":
                    break
                time.sleep(0.02)
            assert status["circuit"] == "closed" and status["dropped"] == 0
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 200 and body["state"] == "ok"
        finally:
            daemon.shutdown(drain=False)

    def test_healthz_body_carries_per_stream_detail_via_publisher(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=True).start()
        try:
            assert daemon.create_stream({
                "name": "m1", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                "use_feed": False,
            })["ok"]
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 200
            assert body["streams"]["m1"]["health"] == "ok"
            assert body["streams"]["m1"]["state"] == 1.0  # serving (STATE_CODES)
            assert body["streams"]["m1"]["cursor"] == 0.0
            # the OpenMetrics scrape exposes the serve gauge family too
            code, _, _ = _http(daemon, "GET", "/healthz")
            host, port = daemon.http_address()
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as resp:
                text = resp.read().decode()
            assert 'serve_m1_state' in text.replace(".", "_") or "serve.m1.state" in text
        finally:
            daemon.shutdown(drain=False)

    def test_healthz_flips_stalled_before_watchdog_raises(self, tmp_path):
        """The live watchdog margin decays DURING the wedged
        update, so /healthz reports stalled strictly before StallError fires
        and the stream is still 'serving' when it does."""
        from tests.unittests.serve import _targets

        _targets.BLOCK.clear()
        daemon = ServeDaemon(str(tmp_path), publish=False).start()
        try:
            assert daemon.create_stream({
                "name": "wedged", "target": "tests.torch_serve_targets:blocking_accuracy",
                "use_feed": False, "watchdog_timeout_s": 6.0, "on_stall": "raise",
                # park immediately on the stall — re-running the wedged apply
                # through the restart budget would just stall 5 more times
                "max_restarts": 0,
            })["ok"]
            assert daemon.ingest("wedged", 0, [[0.9, 0.2], [1, 0]])["ok"]
            flipped_while_serving = False
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                code, body, _ = _http(daemon, "GET", "/healthz")
                state = daemon._get("wedged").status()["state"]
                if body["state"] == "stalled" and state == "serving":
                    flipped_while_serving = True
                    break
                if state == "failed":
                    break
                time.sleep(0.05)
            assert flipped_while_serving, "/healthz did not flip before the watchdog raise"
            # ... and the watchdog then actually raises, failing the stream
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                status = daemon._get("wedged").status()
                if status["state"] == "failed":
                    break
                time.sleep(0.05)
            assert status["state"] == "failed" and "StallError" in status["failure"]
        finally:
            _targets.BLOCK.set()  # unstick the abandoned update thread
            daemon.shutdown(drain=False)


class TestDiskFaultDegradation:
    def test_bounded_enospc_degrades_then_recovers_with_restart_parity(self, tmp_path):
        """A BOUNDED disk-exhaustion window — ``count``
        exactly the snapshot retry budget — fails the cursor-2 cadence
        snapshot through every in-line retry, so the stream detaches its
        store and keeps serving in-memory-only (healthz 503 ``degraded``,
        ``durable`` False, ``write_failures`` == the spent attempts, zero
        restarts: degradation is NOT a crash); once the window clears, the
        recovery probe re-lands a snapshot and durability resumes; a
        drainless restart + suffix replay then matches the uninterrupted
        run bitwise."""
        spec = {"name": "m1", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                "snapshot_every_n": 2, "use_feed": False}
        rng = np.random.RandomState(_SEED)
        preds = np.array_split(rng.rand(48).astype(np.float32), 6)
        target = np.array_split(rng.randint(0, 2, 48), 6)
        batches = [[preds[k].tolist(), target[k].tolist()] for k in range(6)]

        ref = ServeDaemon(str(tmp_path / "ref"), publish=False).start()
        assert ref.create_stream(spec)["ok"]
        assert _ingest_all(ref, {"m1": batches})
        want = _drain_all(ref, ["m1"])
        ref.shutdown(drain=False)

        from torchmetrics_tpu_torch.serve.stream import _DISK_RETRIES

        chaos_dir = str(tmp_path / "chaos")
        daemon = ServeDaemon(chaos_dir, publish=False).start()
        try:
            assert daemon.create_stream(spec)["ok"]
            with faults.inject(faults.Fault("fail", "store.write.enospc", count=1 + _DISK_RETRIES)):
                for seq in range(4):
                    assert daemon.ingest("m1", seq, batches[seq], block=True, deadline_s=30.0)["ok"]
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    status = daemon._get("m1").status()
                    if not status["durable"] and status["pending"] == 0:
                        break
                    time.sleep(0.02)
                assert not status["durable"], "the exhausted retry budget never degraded the stream"
                assert status["state"] == "serving" and status["restarts"] == 0
                assert status["write_failures"] == 1 + _DISK_RETRIES
                code, body, _ = _http(daemon, "GET", "/healthz")
                assert code == 503 and body["state"] == "degraded"
                assert "m1" in body["reason"]
                # the window is spent: the next probe-due apply re-lands a
                # snapshot and re-attaches the store
                time.sleep(0.6)
                for seq in (4, 5):
                    assert daemon.ingest("m1", seq, batches[seq], block=True, deadline_s=30.0)["ok"]
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    status = daemon._get("m1").status()
                    if status["durable"] and status["pending"] == 0:
                        break
                    time.sleep(0.02)
            assert status["durable"], "durability never resumed after the fault window cleared"
            assert status["write_failures"] == 1 + _DISK_RETRIES and status["dropped"] == 0
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 200 and body["state"] == "ok"
        finally:
            daemon.shutdown(drain=False)

        # restart = resume from the RECOVERED snapshot: the replay suffix is
        # non-empty (the drainless teardown persisted nothing past the last
        # cadence snapshot) and the drain is bitwise the reference's
        daemon = ServeDaemon(chaos_dir, publish=False).start()
        try:
            start_at = {s["name"]: s["next_seq"] for s in daemon.status()["streams"]}
            assert 0 < start_at["m1"] <= 6, f"recovery left no durable footprint: {start_at}"
            assert _ingest_all(daemon, {"m1": batches}, start_at)
            assert _drain_all(daemon, ["m1"]) == want
        finally:
            daemon.shutdown(drain=False)


class TestAcceptFault:
    def test_rejected_create_leaves_no_directory(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=False).start()
        try:
            with faults.inject(faults.Fault("fail", "serve.accept", count=1)):
                with pytest.raises(faults.FaultInjected):
                    daemon.create_stream({
                        "name": "m1", "target": "torchmetrics_tpu_torch.serve.factories:binary_accuracy",
                    })
            assert not os.path.isdir(os.path.join(str(tmp_path), "streams", "m1"))
            # a bad factory is also cleaned up (create fully succeeds or not at all)
            reply = daemon.create_stream({"name": "m2", "target": "nope:nope"})
            assert not reply["ok"]
            assert not os.path.isdir(os.path.join(str(tmp_path), "streams", "m2"))
        finally:
            daemon.shutdown(drain=False)


# ----------------------------------- drift streams (JAX's test_drift_stream.py)

_REF = np.random.RandomState(7).normal(0.5, 0.1, 8192).astype(np.float32)


def _drift_spec(name="scores", patience=2):
    return {
        "name": name,
        "target": "torchmetrics_tpu_torch.serve.factories:drift",
        "kwargs": {
            "reference": [float(v) for v in _REF],
            "bins": 32,
            "lo": 0.0,
            "hi": 1.0,
            "patience": patience,
            "thresholds": {"psi": [0.1, 0.25]},
        },
        "use_feed": False,
    }


def _ingest_window(daemon, name, seq, rng, loc, n=512):
    vals = rng.normal(loc, 0.1, n).astype(np.float32)
    reply = daemon.ingest(name, seq, [vals.tolist()], block=True, deadline_s=30.0)
    assert reply.get("ok"), reply
    return seq + 1


def _healthz_settles(daemon, want_code, want_state, timeout_s=30.0):
    """Poll /healthz until it reports ``(want_code, want_state)`` — ingest
    acks can land a beat before the worker's gauge refresh reaches the HTTP
    thread's probe cache."""
    deadline = time.monotonic() + timeout_s
    while True:
        code, body, _ = _http(daemon, "GET", "/healthz")
        if (code == want_code and body.get("state") == want_state) or time.monotonic() > deadline:
            return code, body


class TestDriftStream:
    def test_sustained_drift_floors_healthz_and_recovers(self, tmp_path):
        """The acceptance walk: in-distribution 200 ok -> sustained drifted
        windows 503 degraded naming the stream -> recovery back to 200."""
        daemon = ServeDaemon(str(tmp_path), publish=True).start()
        rng = np.random.RandomState(21)
        try:
            code, body, _ = _http(daemon, "POST", "/v1/streams", _drift_spec(patience=2))
            assert code == 200 and body["ok"], body

            seq = 0
            for _ in range(3):
                seq = _ingest_window(daemon, "scores", seq, rng, loc=0.5)
            code, body = _healthz_settles(daemon, 200, "ok")
            assert code == 200 and body["state"] == "ok"

            # one drifted window is NOT enough (patience=2): no paging on a
            # transient spike
            seq = _ingest_window(daemon, "scores", seq, rng, loc=0.9)
            code, body, _ = _http(daemon, "GET", "/healthz")
            assert code == 200

            seq = _ingest_window(daemon, "scores", seq, rng, loc=0.9)
            code, body = _healthz_settles(daemon, 503, "degraded")
            assert code == 503 and body["state"] == "degraded"
            assert "scores" in body["reason"] and "drift" in body["reason"]
            assert "psi" in body["reason"]

            # recovery: flood with in-distribution windows until the live
            # histogram re-centers — the severity gauge drops the moment the
            # scores do, and /healthz un-floors on the next probe
            for _ in range(90):
                seq = _ingest_window(daemon, "scores", seq, rng, loc=0.5, n=2048)
            code, body = _healthz_settles(daemon, 200, "ok")
            assert code == 200 and body["state"] == "ok"
        finally:
            daemon.shutdown(drain=False)

    def test_metrics_scrape_exposes_drift_gauges(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=True).start()
        rng = np.random.RandomState(22)
        try:
            code, body, _ = _http(daemon, "POST", "/v1/streams", _drift_spec())
            assert code == 200 and body["ok"], body
            _ingest_window(daemon, "scores", 0, rng, loc=0.5)
            host, port = daemon.http_address()
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as resp:
                text = resp.read().decode()
            for gauge in ("psi", "kl", "ks", "severity"):
                assert f"drift.scores.{gauge}" in text or f"drift_scores_{gauge}" in text.replace(".", "_")
        finally:
            daemon.shutdown(drain=False)

    def test_cardinality_stream_serves_distinct_count_gauge(self, tmp_path):
        daemon = ServeDaemon(str(tmp_path), publish=True).start()
        try:
            code, body, _ = _http(daemon, "POST", "/v1/streams", {
                "name": "uniq",
                "target": "torchmetrics_tpu_torch.serve.factories:cardinality",
                "kwargs": {"precision": 12},
                "use_feed": False,
            })
            assert code == 200 and body["ok"], body
            tags = np.arange(5_000, dtype=np.int32)
            assert daemon.ingest("uniq", 0, [tags.tolist()], block=True, deadline_s=30.0)["ok"]
            reply = daemon.drain_stream("uniq")
            assert reply["ok"]
            est = float(np.asarray(reply["results"]))
            assert abs(est - 5_000) / 5_000 <= 0.05  # precision 12 ~ 1.6% sigma
        finally:
            daemon.shutdown(drain=False)


# ------------------------------------- a daemon of one package over the other's


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")], ids=["jax_then_port", "port_then_jax"])
def test_daemon_resumes_the_other_packages_base_dir(tmp_path, first, second):
    """A daemon of one package snapshots a stream and goes down without a
    drain; a daemon of the other package starts over the same base directory,
    restores the stream from its ``spec.json`` and store at the snapshot
    cursor, takes the rest of the batches and drains to the uninterrupted
    run's result, bit for bit (the spec names JAX's factory path, which the
    port resolves to its own)."""
    from torchmetrics_tpu.serve import ServeDaemon as JServeDaemon
    from torchmetrics_tpu_torch.serve.stream import decode_batch, resolve_target

    daemons = {"jax": JServeDaemon, "port": ServeDaemon}
    rng = np.random.RandomState(_SEED)
    preds, target = rng.rand(96).astype(np.float32), rng.randint(0, 2, 96)
    batches = [[p.tolist(), t.tolist()] for p, t in zip(np.array_split(preds, 6), np.array_split(target, 6))]
    spec = {"name": "cross", "target": "torchmetrics_tpu.serve.factories:binary_accuracy",
            "snapshot_every_n": 2, "use_feed": False}
    base = str(tmp_path / "base")
    daemon = daemons[first](base, publish=False).start()
    try:
        assert daemon.create_stream(spec)["ok"]
        for seq in range(4):
            assert daemon.ingest("cross", seq, batches[seq], block=True, deadline_s=60.0)["ok"]
        assert daemon.flush("cross")["ok"]
    finally:
        daemon.shutdown(drain=False)
    daemon = daemons[second](base, publish=False).start()
    try:
        status = daemon.status()["streams"][0]
        assert status["name"] == "cross" and status["next_seq"] == 4, status
        for seq in range(4, len(batches)):
            assert daemon.ingest("cross", seq, batches[seq], block=True, deadline_s=60.0)["ok"]
        reply = daemon.drain_stream("cross")
        assert reply["ok"] and reply["cursor"] == len(batches), reply
    finally:
        daemon.shutdown(drain=False)
    ref = resolve_target(spec["target"], device=CPU)
    for batch in batches:
        ref.update(*decode_batch(batch))
    assert reply["results"] == float(ref.compute())
