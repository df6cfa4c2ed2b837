# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""One port stream's lifecycle on the CPU (counterpart of
``tests/unittests/serve/test_stream.py``): exactly-once ingest, flush/drain
ops, supervised self-healing, poison-batch quarantine and disk-fault
degradation; then the port's stream against the JAX package's on the same
batches, and a bfloat16 state's export with and without ``ml_dtypes``."""
from __future__ import annotations

import functools
import json
import time

import numpy as np
import pytest

from torchmetrics_tpu_torch.robustness import faults
from torchmetrics_tpu_torch.robustness.faults import FaultInjected
from torchmetrics_tpu_torch.serve.stream import Stream as _Stream
from torchmetrics_tpu_torch.serve.stream import StreamSpec, decode_batch
from torchmetrics_tpu_torch.serve.stream import resolve_target as _resolve_target

CPU = "cpu"
# the port's entry points default to the card; these tests run them on the CPU
Stream = functools.partial(_Stream, device=CPU)
resolve_target = functools.partial(_resolve_target, device=CPU)

_ACC = "torchmetrics_tpu_torch.serve.factories:binary_accuracy"


def _wire_batches(n_batches=6, n=48, seed=7):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, n)
    return (
        [[p.tolist(), t.tolist()] for p, t in zip(np.array_split(preds, n_batches), np.array_split(target, n_batches))],
        preds,
        target,
    )


def _start(tmp_path, **spec_kw) -> Stream:
    spec_kw.setdefault("name", "m1")
    spec_kw.setdefault("target", _ACC)
    spec_kw.setdefault("use_feed", False)
    stream = Stream(StreamSpec(**spec_kw), str(tmp_path / "store"))
    stream.start()
    return stream


class TestSpec:
    @pytest.mark.parametrize("bad", ["", "a/b", "a.b", "a\\b", " pad "])
    def test_rejects_unclean_names(self, bad):
        with pytest.raises(ValueError, match="clean path component"):
            StreamSpec(name=bad, target=_ACC)

    def test_wire_round_trip(self):
        spec = StreamSpec(name="m1", target=_ACC, kwargs={"threshold": 0.25}, snapshot_every_n=2)
        again = StreamSpec.from_wire(spec.to_wire())
        assert again.to_wire() == spec.to_wire()

    def test_from_wire_rejects_unknown_fields(self):
        from torchmetrics_tpu_torch.serve import wire

        with pytest.raises(wire.WireError, match="unknown StreamSpec field"):
            StreamSpec.from_wire({"name": "m1", "target": _ACC, "wat": 1})

    def test_resolve_target_validates_path(self):
        with pytest.raises(ValueError, match="module:callable"):
            resolve_target("no-colon-here")

    def test_decode_batch_rejects_empty(self):
        from torchmetrics_tpu_torch.serve import wire

        with pytest.raises(wire.WireError, match="non-empty"):
            decode_batch([])


class TestSeqProtocol:
    def test_exactly_once_duplicates_and_gaps(self, tmp_path):
        stream = _start(tmp_path)
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["next_seq"] == 1
        assert stream.offer(1, batches[1])["next_seq"] == 2
        # duplicate replay: acked idempotently, nothing re-applied
        dup = stream.offer(0, batches[0])
        assert dup["ok"] and dup["duplicate"] and dup["next_seq"] == 2
        # gap: rejected with the expected value so the client can rewind
        gap = stream.offer(5, batches[2])
        assert not gap["ok"]
        assert gap["error"]["code"] == "bad_seq" and gap["error"]["expected"] == 2
        # duplicates and gaps never moved the watermark
        reply = stream.drain()
        assert reply["ok"] and reply["cursor"] == 2
        stream.abandon()

    def test_bad_seq_types_rejected(self, tmp_path):
        stream = _start(tmp_path)
        for bad in (-1, "0", True, None, 1.0):
            reply = stream.offer(bad, [[1.0], [1]])
            assert not reply["ok"] and reply["error"]["code"] == "bad_request", bad
        stream.abandon()

    def test_drain_parity_with_inprocess_run(self, tmp_path):
        """The whole point: wire-ingested results == in-process results,
        bitwise, through the shared decode path."""
        stream = _start(tmp_path, snapshot_every_n=2)
        batches, preds, target = _wire_batches()
        for seq, batch in enumerate(batches):
            assert stream.offer(seq, batch)["ok"]
        reply = stream.drain()
        assert reply["ok"] and reply["cursor"] == len(batches)
        assert stream.dropped == 0  # graceful drain applies everything

        ref = resolve_target(_ACC)
        for batch in batches:
            ref.update(*decode_batch(batch))
        assert reply["results"] == float(ref.compute())
        # a second drain is idempotent — same results, no re-compute
        again = stream.drain()
        assert again["ok"] and again["results"] == reply["results"]

    def test_offers_after_drain_are_refused(self, tmp_path):
        stream = _start(tmp_path)
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["ok"]
        assert stream.drain()["ok"]
        reply = stream.offer(1, batches[1])
        assert not reply["ok"] and reply["error"]["code"] == "draining"


class TestBackpressure:
    def test_full_queue_pushes_back_then_recovers(self, tmp_path):
        # a glacial update keeps the worker busy so the queue actually fills
        stream = _start(
            tmp_path,
            name="slow",
            target="torchmetrics_tpu_torch.serve.factories:quantile",
            queue_max=2,
        )
        big = [np.zeros(4, np.float32).tolist()]
        seq = 0
        saw_backpressure = False
        for _ in range(200):
            reply = stream.offer(seq, big)
            if reply.get("ok"):
                seq = reply["next_seq"]
            elif reply["error"]["code"] == "backpressure":
                assert reply["error"]["retry_after_s"] > 0
                saw_backpressure = True
                break
            else:
                raise AssertionError(reply)
        # blocking (socket) mode waits a slot out instead of erroring
        if saw_backpressure:
            reply = stream.offer(seq, big, block=True, deadline_s=30.0)
            assert reply["ok"], reply
        assert stream.drain()["ok"]
        assert stream.dropped == 0


class TestFailure:
    def test_ingest_fault_does_not_advance_watermark(self, tmp_path):
        stream = _start(tmp_path)
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["ok"]
        with faults.inject(faults.Fault("fail", "serve.ingest", count=1)):
            with pytest.raises(FaultInjected):
                stream.offer(1, batches[1])
        # the failed admission never acked: the SAME seq retries cleanly
        reply = stream.offer(1, batches[1])
        assert reply["ok"] and reply["next_seq"] == 2
        assert stream.drain()["cursor"] == 2

    def test_worker_death_is_supervised_back_to_serving(self, tmp_path):
        """A worker crash is no longer terminal: the supervisor restarts the
        worker, restores from the snapshot, replays the retained suffix —
        exactly-once with no client involvement, zero drops, and the drain
        still matches the uninterrupted in-process run bitwise."""
        stream = _start(tmp_path, name="healed", snapshot_every_n=2, backoff_base_s=0.01)
        batches, _, _ = _wire_batches()
        with faults.inject(faults.Fault("preempt", "runner.preempt", after=2, count=1)):
            for seq, batch in enumerate(batches):
                assert stream.offer(seq, batch, block=True, deadline_s=30.0)["ok"]
            reply = stream.drain()
        assert reply["ok"] and reply["cursor"] == len(batches), reply
        status = stream.status()
        assert status["restarts"] >= 1 and status["circuit"] == "closed"
        assert "SimulatedPreemption" in status["last_failure"]
        assert stream.dropped == 0
        ref = resolve_target(_ACC)
        for batch in batches:
            ref.update(*decode_batch(batch))
        assert reply["results"] == float(ref.compute())

    def test_restart_budget_exhaustion_parks_circuit_open_and_revive_heals(self, tmp_path):
        """More crashes than ``max_restarts`` inside the window parks the
        stream: state failed, circuit open, health stalled — but nothing is
        dropped, and a manual revive replays the retained suffix and heals."""
        stream = _start(
            tmp_path, name="parked", snapshot_every_n=2, max_restarts=0, backoff_base_s=0.01
        )
        batches, _, _ = _wire_batches()
        with faults.inject(faults.Fault("preempt", "runner.preempt", after=1, count=1)):
            for seq in range(3):
                assert stream.offer(seq, batches[seq])["ok"]
            assert stream._finished.wait(30.0)
        status = stream.status()
        assert status["state"] == "failed" and status["circuit"] == "open"
        assert "circuit open" in status["failure"] and "revive" in status["failure"]
        assert stream.gauges()["serve.parked.health_state"] == 3.0
        assert stream.gauges()["serve.parked.circuit_state"] == 2.0
        # parked ≠ dropped: the retained buffer still covers the suffix
        assert stream.dropped == 0
        refused = stream.offer(status["next_seq"], batches[3])
        assert refused["error"]["code"] == "failed" and "revive" in refused["error"]["message"]

        reply = stream.revive()
        assert reply["ok"] and reply["revived"], reply
        for seq in range(3, len(batches)):
            assert stream.offer(seq, batches[seq], block=True, deadline_s=30.0)["ok"]
        reply = stream.drain()
        assert reply["ok"] and reply["cursor"] == len(batches)
        status = stream.status()
        assert status["circuit"] == "closed" and stream.dropped == 0
        ref = resolve_target(_ACC)
        for batch in batches:
            ref.update(*decode_batch(batch))
        assert reply["results"] == float(ref.compute())
        # revive on a non-parked stream is a bad_request, not a restart
        assert stream.revive()["error"]["code"] == "bad_request"

    def test_abandon_without_compute(self, tmp_path):
        stream = _start(tmp_path)
        batches, _, _ = _wire_batches()
        for seq in range(3):
            assert stream.offer(seq, batches[seq])["ok"]
        stream.abandon()
        assert stream.status()["state"] == "failed"
        assert stream.result is None  # no final compute on the delete path


class TestPayloadValidation:
    def test_shape_and_dtype_drift_is_bad_payload(self, tmp_path):
        """The wire layer pins the first-accepted batch's avals: later
        batches may vary their leading (batch) dim but not part count, dtype
        or trailing shape — drift errors at ADMISSION, not in the worker."""
        stream = _start(tmp_path)
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["ok"]
        # fewer parts than the stream's update arity
        reply = stream.offer(1, [[0.5, 0.5]])
        assert not reply["ok"] and reply["error"]["code"] == "bad_payload"
        assert "1 part(s)" in reply["error"]["message"]
        # right arity, wrong dtype (float target vs the pinned int64)
        reply = stream.offer(1, [[0.5, 0.5], [1.0, 0.5]])
        assert not reply["ok"] and reply["error"]["code"] == "bad_payload"
        assert reply["error"]["expected"] and reply["error"]["got"]
        # right arity, wrong trailing shape (2-d preds vs the pinned 1-d)
        reply = stream.offer(1, [[[0.5], [0.5]], [1, 0]])
        assert not reply["ok"] and reply["error"]["code"] == "bad_payload"
        # a rejected payload never advanced the watermark
        ok = stream.offer(1, batches[1])
        assert ok["ok"] and ok["next_seq"] == 2
        # leading-dim variation is fine (clients split unevenly)
        assert stream.offer(2, [[0.9], [1]])["ok"]
        stream.abandon()


class TestDeadletter:
    _POISON = [[0.5, 0.5, 0.5], [7, 7, 7]]  # clean avals, values outside {0, 1}

    def test_poison_batch_is_quarantined_and_skipped(self, tmp_path):
        """A batch that kills the worker ``poison_threshold`` times in a row
        lands in deadletter.jsonl with its error; the cursor skips past it
        and the stream keeps serving — results equal the poison-free run."""
        stream = _start(
            tmp_path,
            name="toxic",
            target="torchmetrics_tpu_torch.serve.factories:checked_binary_accuracy",
            snapshot_every_n=2,
            poison_threshold=2,
            backoff_base_s=0.01,
        )
        batches, _, _ = _wire_batches()
        for seq in range(2):
            assert stream.offer(seq, batches[seq])["ok"]
        assert stream.offer(2, self._POISON)["ok"]  # avals pass; values are poison
        for seq in range(3, len(batches)):
            assert stream.offer(seq, batches[seq], block=True, deadline_s=30.0)["ok"]
        reply = stream.drain()
        # every seq (incl. the skipped poison one) moved the cursor
        assert reply["ok"] and reply["cursor"] == len(batches), reply

        listing = stream.deadletter_list()
        assert listing["ok"] and listing["depth"] == 1
        record = listing["deadletter"][0]
        assert record["seq"] == 2 and record["attempts"] == 2
        # torchmetrics validate_args reports bad targets as a RuntimeError
        assert "expected only the following values" in record["error"]
        assert record["batch"] == self._POISON
        # durable: the quarantine file holds the same record
        with open(stream.deadletter_path) as fh:
            on_disk = [json.loads(line) for line in fh if line.strip()]
        assert [r["seq"] for r in on_disk] == [2]
        assert stream.dropped == 0  # quarantined, not silently dropped
        assert stream.gauges()["serve.toxic.deadletter_depth"] == 1.0

        # results equal the run that never saw the poison batch (seq 2 took
        # batches[2]'s slot, so the reference excludes that index)
        ref = resolve_target(_ACC)
        for i, batch in enumerate(batches):
            if i != 2:
                ref.update(*decode_batch(batch))
        assert reply["results"] == float(ref.compute())

    def test_deadletter_survives_restart_and_requeue_re_enters_exactly_once(self, tmp_path):
        """A transient poison (environmental crash pinned to one batch) is
        quarantined, survives a stream rebuild from disk, and a requeue
        re-admits the payload through the normal exactly-once path."""
        spec_kw = dict(
            name="dl", target=_ACC, use_feed=False, snapshot_every_n=2,
            poison_threshold=1, backoff_base_s=0.01,
        )
        stream = Stream(StreamSpec(**spec_kw), str(tmp_path / "store"))
        stream.start()
        batches, _, _ = _wire_batches()
        with faults.inject(faults.Fault("fail", "serve.worker.crash", after=2, count=1)):
            for seq in range(3):
                assert stream.offer(seq, batches[seq], block=True, deadline_s=30.0)["ok"]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if stream.status()["deadletter_depth"] == 1 and stream.status()["pending"] == 0:
                    break
                time.sleep(0.02)
        assert stream.status()["deadletter_depth"] == 1
        stream.abandon()

        # dead-letter state survives the daemon restart (re-read from disk)
        resumed = Stream(StreamSpec(**spec_kw), str(tmp_path / "store"))
        resumed.start()
        listing = resumed.deadletter_list()
        assert listing["depth"] == 1 and listing["deadletter"][0]["seq"] == 2
        reply = resumed.deadletter_requeue(2)
        assert reply["ok"] and reply["requeued"] == 2, reply
        assert reply["as_seq"] == resumed.status()["next_seq"] - 1
        assert resumed.deadletter_list()["depth"] == 0
        drained = resumed.drain()
        assert drained["ok"]
        ref = resolve_target(_ACC)
        for batch in batches[:3]:
            ref.update(*decode_batch(batch))
        assert drained["results"] == float(ref.compute())
        assert resumed.dropped == 0

    def test_purge_latches_dropped_and_requeue_of_missing_seq_is_not_found(self, tmp_path):
        stream = _start(
            tmp_path,
            name="purged",
            target="torchmetrics_tpu_torch.serve.factories:checked_binary_accuracy",
            poison_threshold=1,
            backoff_base_s=0.01,
        )
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["ok"]
        assert stream.offer(1, self._POISON)["ok"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if stream.status()["deadletter_depth"] == 1:
                break
            time.sleep(0.02)
        assert stream.deadletter_requeue(99)["error"]["code"] == "not_found"
        assert stream.deadletter_requeue("1")["error"]["code"] == "bad_request"
        reply = stream.deadletter_purge(1)
        assert reply["ok"] and reply["purged"] == 1 and reply["depth"] == 0
        assert stream.dropped == 1  # acked, never applied, now unrecoverable
        assert stream.deadletter_purge(1)["error"]["code"] == "not_found"
        assert stream.drain()["ok"]


class TestDegradation:
    def test_disk_fault_degrades_to_memory_only_then_recovers(self, tmp_path):
        """ENOSPC on snapshot writes: retries, then the store detaches and
        the stream keeps serving (health degraded, durability gauge 0); the
        recovery probe re-enables durability once the disk heals, and a
        kill-and-resume from the post-recovery snapshot still matches."""
        stream = _start(tmp_path, name="flaky", snapshot_every_n=1)
        batches, _, _ = _wire_batches(n_batches=12, n=96)
        fault = faults.Fault("fail", "store.write.enospc", after=2, count=1000)
        with faults.inject(fault):
            degraded = False
            for seq in range(6):
                assert stream.offer(seq, batches[seq], block=True, deadline_s=30.0)["ok"]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                status = stream.status()
                if not status["durable"] and status["pending"] == 0:
                    degraded = True
                    break
                time.sleep(0.02)
            assert degraded, "ENOSPC never degraded the stream"
            assert status["state"] == "serving"  # still serving, memory-only
            assert status["write_failures"] >= 1
            assert stream.health_code() == 2
            assert stream.gauges()["serve.flaky.durability"] == 0.0
        # the disk "heals" (faults cleared); keep feeding until the recovery
        # probe lands a snapshot and durability flips back on
        recovered = False
        deadline = time.monotonic() + 30
        seq = 6
        while time.monotonic() < deadline:
            if seq < len(batches):
                assert stream.offer(seq, batches[seq], block=True, deadline_s=30.0)["ok"]
                seq += 1
            if stream.status()["durable"]:
                recovered = True
                break
            time.sleep(0.1)
        assert recovered, "durability never recovered after the disk healed"
        assert stream.health_code() == 0
        reply = stream.flush()
        assert reply["ok"] and reply["durable"]
        stream.abandon()
        # kill-and-resume: the post-recovery snapshot is genuinely durable
        resumed = Stream(stream.spec, stream.store_dir)
        start = resumed.start()
        assert start >= 6, f"recovered snapshot should cover the outage, resumed at {start}"
        resumed.abandon()

    def test_deadletter_write_fault_keeps_quarantine_in_memory(self, tmp_path):
        """ENOSPC on the deadletter.jsonl rewrite: the quarantine stays in
        memory (durability gauge drops), the stream keeps serving, and the
        file lands once the disk recovers."""
        stream = _start(
            tmp_path,
            name="dlflaky",
            target="torchmetrics_tpu_torch.serve.factories:checked_binary_accuracy",
            poison_threshold=1,
            backoff_base_s=0.01,
        )
        batches, _, _ = _wire_batches()
        assert stream.offer(0, batches[0])["ok"]
        with faults.inject(faults.Fault("fail", "deadletter.write", count=1000)):
            assert stream.offer(1, TestDeadletter._POISON)["ok"]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                status = stream.status()
                # `durable` drops only once the persist RETRIES exhaust, a
                # beat after the quarantine record itself appears
                if status["deadletter_depth"] == 1 and not status["durable"]:
                    break
                time.sleep(0.02)
            assert status["deadletter_depth"] == 1 and not status["durable"]
        # disk heals: the next applied batch's recovery probe persists it
        deadline = time.monotonic() + 30
        seq = 2
        while time.monotonic() < deadline:
            assert stream.offer(seq, batches[seq % len(batches)], block=True, deadline_s=30.0)["ok"]
            seq += 1
            if stream.status()["durable"]:
                break
            time.sleep(0.1)
        assert stream.status()["durable"], "deadletter.jsonl never re-persisted"
        with open(stream.deadletter_path) as fh:
            assert [json.loads(line)["seq"] for line in fh if line.strip()] == [1]
        assert stream.drain()["ok"]


class TestOps:
    def test_flush_serializes_after_admitted_batches(self, tmp_path):
        stream = _start(tmp_path, snapshot_every_n=100)  # only flush snapshots
        batches, _, _ = _wire_batches()
        for seq in range(4):
            assert stream.offer(seq, batches[seq])["ok"]
        reply = stream.flush()
        assert reply["ok"] and reply["cursor"] == 4 and reply["snapshot_step"] == 4
        # the snapshot is durable: a fresh stream resumes at the flush point
        stream.abandon()
        resumed = Stream(stream.spec, stream.store_dir)
        assert resumed.start() == 4
        resumed.abandon()

    def test_feed_path_matches_plain_path(self, tmp_path):
        batches, _, _ = _wire_batches()
        results = []
        for use_feed, sub in ((False, "plain"), (True, "feed")):
            stream = _start(tmp_path / sub, name=f"s{int(use_feed)}", use_feed=use_feed)
            for seq, batch in enumerate(batches):
                assert stream.offer(seq, batch)["ok"]
            # an op marker rides the feed too (leafless pytree stages as no-op)
            assert stream.flush()["ok"]
            results.append(stream.drain()["results"])
        assert results[0] == results[1]


# ------------------------------------------------ the port against the JAX package

#: float leaves of results and exports agree within this absolute budget,
#: scaled by max(1, |JAX value|); integer and boolean leaves bitwise
_BUDGET = 1e-5


def _parity_batches(kind, n_batches=4, n=64, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if kind == "binary":
            out.append((rng.rand(n).astype(np.float32), rng.randint(0, 2, n)))
        elif kind == "multiclass":
            p = rng.rand(n, 4).astype(np.float32)
            out.append((p / p.sum(1, keepdims=True), rng.randint(0, 4, n)))
        elif kind == "values":
            out.append((rng.standard_normal(n).astype(np.float32),))
        elif kind == "regression":
            out.append((rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32)))
        elif kind == "tags":
            out.append((rng.zipf(1.5, n).astype(np.int64) % 5000,))
        else:  # sliced: cohort keys lead
            out.append((rng.randint(0, 6, n), rng.randint(0, 4, n), rng.randint(0, 4, n)))
    return out


_PARITY = [
    ("binary_accuracy", {}, {}, "binary"),
    ("binary_average_precision", {}, {}, "binary"),
    ("collection", {}, {"fused": True, "fused_options": {"cat_capacity": 512}}, "multiclass"),
    ("quantile", {"capacity": 64, "levels": 8}, {}, "values"),
    ("guarded_mean_squared_error", {"policy": "mask"}, {}, "regression"),
    ("heavy_hitters", {"width": 256, "k": 8}, {}, "tags"),
    ("sliced_accuracy", {"num_classes": 4, "num_cells": 8}, {}, "sliced"),
]


def _assert_close(got, want, where="results"):
    """Walk two JSON trees: ints, bools and strings equal, floats within _BUDGET,
    ``__nd__`` markers with equal dtype names and shapes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        if "__nd__" in want:
            assert got["__nd__"] == want["__nd__"] and got["shape"] == want["shape"], where
        for key in want:
            _assert_close(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), where
        if np.isnan(want):
            assert np.isnan(got), where
        else:
            assert abs(got - want) <= _BUDGET * max(1.0, abs(want)) or got == want, (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("factory,kwargs,spec_kw,kind", _PARITY, ids=[p[0] for p in _PARITY])
def test_port_and_jax_streams_drain_and_export_alike(tmp_path, factory, kwargs, spec_kw, kind):
    """The same numpy batches, offered in process to a JAX ``Stream`` and a
    port ``Stream``: the drained results and the ``/v1/state`` exports agree
    (integer states bitwise, floats within _BUDGET, ``__nd__`` dtype names
    equal), and so do the registry fingerprints."""
    from torchmetrics_tpu.serve.stream import Stream as JStream
    from torchmetrics_tpu.serve.stream import StreamSpec as JSpec

    batches = _parity_batches(kind)
    replies = {}
    for tag, stream_cls, spec_cls in (("jax", JStream, JSpec), ("port", Stream, StreamSpec)):
        spec = spec_cls(
            name=factory, target=f"torchmetrics_tpu.serve.factories:{factory}", kwargs=kwargs,
            snapshot_every_n=3, **spec_kw,
        )
        stream = stream_cls(spec, str(tmp_path / tag / "store"))
        stream.start()
        for seq, batch in enumerate(batches):
            assert stream.offer(seq, batch, block=True, deadline_s=60.0)["ok"]
        drained = stream.drain()
        assert drained["ok"], drained
        exported = json.loads(json.dumps(stream.export()))
        assert exported["ok"], exported
        replies[tag] = (drained, exported)
    (jdrain, jexport), (tdrain, texport) = replies["jax"], replies["port"]
    _assert_close(tdrain["results"], jdrain["results"])
    assert texport["fingerprint"] == jexport["fingerprint"] and texport["kind"] == jexport["kind"]
    assert texport["watermark"] == jexport["watermark"] == len(batches)
    assert texport["spec"] == jexport["spec"]
    _assert_close(texport["state"], jexport["state"], "state")


@pytest.mark.parametrize("hide_ml_dtypes", [False, True], ids=["ml_dtypes", "no_ml_dtypes"])
def test_bfloat16_state_exports_and_restores(tmp_path, monkeypatch, hide_ml_dtypes):
    """A bfloat16 state (``set_dtype``) checkpoints, snapshots to the store
    and exports as ``{"__nd__": "bfloat16", ...}``, with or without
    ``ml_dtypes``; the export decodes and loads into a fresh metric bit for
    bit; where ``ml_dtypes`` is present it equals the JAX stream's export and
    loads in the JAX package."""
    import sys

    import torch

    from torchmetrics_tpu_torch.serve import decode_state
    from tests.torch_serve_targets import bf16_sum

    batches = [(np.random.RandomState(k).standard_normal(16).astype(np.float32),) for k in range(3)]
    if hide_ml_dtypes:
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    stream = Stream(StreamSpec(name="bf", target="tests.torch_serve_targets:bf16_sum", snapshot_every_n=1,
                               use_feed=False), str(tmp_path / "port" / "store"))
    stream.start()
    for seq, batch in enumerate(batches):
        assert stream.offer(seq, batch, block=True, deadline_s=60.0)["ok"]
    assert stream.flush()["ok"]
    exported = json.loads(json.dumps(stream.export()))
    leaf = exported["state"]["checkpoint"]["metrics"][""]["state"]["sum_value"]
    assert leaf["__nd__"] == "bfloat16" and leaf["shape"] == []
    fresh = bf16_sum(device=CPU)
    fresh.load_checkpoint(decode_state(exported["state"])["checkpoint"])
    live = stream.evaluator.metric
    assert fresh.sum_value.dtype == torch.bfloat16
    assert torch.equal(fresh.sum_value.view(torch.int16), live.sum_value.view(torch.int16))
    # the store's snapshot restores bit for bit in a new stream
    stream.abandon()
    again = Stream(stream.spec, stream.store_dir)
    assert again.start() == len(batches)
    assert torch.equal(again.evaluator.metric.sum_value.view(torch.int16), live.sum_value.view(torch.int16))
    again.abandon()
    if hide_ml_dtypes:
        return
    from torchmetrics_tpu.robustness.checkpoint import load_checkpoint as jload
    from torchmetrics_tpu.serve import decode_state as jdecode
    from torchmetrics_tpu.serve.stream import Stream as JStream
    from torchmetrics_tpu.serve.stream import StreamSpec as JSpec
    from tests.torch_serve_targets import jax_bf16_sum

    jstream = JStream(JSpec(name="bf", target="tests.torch_serve_targets:jax_bf16_sum", use_feed=False),
                      str(tmp_path / "jax" / "store"))
    jstream.start()
    for seq, batch in enumerate(batches):
        assert jstream.offer(seq, batch, block=True, deadline_s=60.0)["ok"]
    jexported = json.loads(json.dumps(jstream.export()))
    jstream.abandon()
    assert exported["state"]["checkpoint"] == jexported["state"]["checkpoint"]
    jmetric = jax_bf16_sum()
    jload(jmetric, jdecode(exported["state"])["checkpoint"])
    assert float(jmetric.sum_value) == float(live.sum_value)
