# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's fleet federation on the CPU (counterpart of
``tests/unittests/serve/test_federation.py``): state exports, the
dtype-preserving codec, slot dedup, quarantine, coverage-degraded health and
fold-state resume; and a mixed fleet of a JAX leaf and a port leaf folded by
either package's aggregator."""
from __future__ import annotations

import functools
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from torchmetrics_tpu_torch.serve import FleetAggregator as _FleetAggregator
from torchmetrics_tpu_torch.serve import ServeDaemon as _ServeDaemon
from torchmetrics_tpu_torch.serve import decode_state, encode_state
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

CPU = "cpu"
# the port's entry points default to the card; these tests run them on the CPU
ServeDaemon = functools.partial(_ServeDaemon, device=CPU)
FleetAggregator = functools.partial(_FleetAggregator, device=CPU)

_SEED = 17
_ACC = "torchmetrics_tpu_torch.serve.factories:binary_accuracy"
_AP = "torchmetrics_tpu_torch.serve.factories:binary_average_precision"
_Q = "torchmetrics_tpu_torch.serve.factories:quantile"
_COLL = "torchmetrics_tpu_torch.serve.factories:collection"
_SLICED = "torchmetrics_tpu_torch.serve.factories:sliced_accuracy"


def _http(address, method, path, body=None):
    host, port = address
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _url(daemon) -> str:
    host, port = daemon.http_address()
    return f"http://{host}:{port}"


def _binary_batches(n_batches=6, n=96, seed=_SEED):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, n)
    return [
        [p.tolist(), t.tolist()]
        for p, t in zip(np.array_split(preds, n_batches), np.array_split(target, n_batches))
    ]


def _feed(daemon, name, batches, start=0):
    for seq in range(start, len(batches)):
        assert daemon.ingest(name, seq, batches[seq], block=True, deadline_s=30.0)["ok"]
    assert daemon.flush(name)["ok"]


def _leaf(tmp_path, tag, spec, batches=None):
    daemon = ServeDaemon(str(tmp_path / tag), publish=False).start()
    assert daemon.create_stream(spec)["ok"]
    if batches is not None:
        _feed(daemon, spec["name"], batches)
    return daemon


def _reference(tmp_path, tag, spec, leaf_batches):
    """Single-daemon truth: one stream fed every leaf's batches grouped in
    sorted-leaf order (the fold's deterministic concatenation order)."""
    daemon = ServeDaemon(str(tmp_path / f"ref-{tag}"), publish=False).start()
    try:
        assert daemon.create_stream(spec)["ok"]
        seq = 0
        for leaf in sorted(leaf_batches):
            for batch in leaf_batches[leaf]:
                assert daemon.ingest(spec["name"], seq, batch, block=True, deadline_s=30.0)["ok"]
                seq += 1
        reply = daemon.drain_stream(spec["name"])
        assert reply["ok"], reply
        return reply["results"]
    finally:
        daemon.shutdown(drain=False)


class TestStateCodec:
    def test_round_trips_arrays_scalars_bytes(self):
        tree = {
            "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i32": np.asarray([[7, -1]], dtype=np.int32),
            "b": np.asarray([True, False]),
            "scalar": np.float32(0.5),
            "py": 3,
            "blob": b"\x00\xff\x80kll",
            "nested": {"rows": [np.asarray([1.5], dtype=np.float64), "text", None]},
        }
        back = decode_state(json.loads(json.dumps(encode_state(tree))))
        np.testing.assert_array_equal(back["f32"], tree["f32"])
        assert back["f32"].dtype == np.float32 and back["f32"].shape == (2, 3)
        np.testing.assert_array_equal(back["i32"], tree["i32"])
        assert back["i32"].dtype == np.int32
        assert back["b"].dtype == np.bool_ and back["b"].tolist() == [True, False]
        assert float(back["scalar"]) == 0.5
        assert back["py"] == 3 and back["blob"] == tree["blob"]
        np.testing.assert_array_equal(back["nested"]["rows"][0], tree["nested"]["rows"][0])
        assert back["nested"]["rows"][0].dtype == np.float64
        assert back["nested"]["rows"][1:] == ["text", None]

    def test_ml_dtypes_survive(self):
        ml_dtypes = pytest.importorskip("ml_dtypes")
        arr = np.asarray([1.0, -2.0], dtype=ml_dtypes.bfloat16)
        back = decode_state(json.loads(json.dumps(encode_state(arr))))
        assert back.dtype == ml_dtypes.bfloat16 and back.tolist() == [1.0, -2.0]

    def test_unknown_dtype_raises(self):
        with pytest.raises(StateRestoreError, match="dtype"):
            decode_state({"__nd__": "no_such_dtype", "shape": [1], "data": [0]})


class TestLeafExports:
    def test_export_watermark_tracks_applied_cursor(self, tmp_path):
        batches = _binary_batches()
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, batches)
        try:
            export = daemon.export_state()
            assert export["ok"] and export["epoch"] == daemon.epoch
            env = export["streams"]["s"]
            assert env["ok"] and env["watermark"] == len(batches) == env["state"]["cursor"]
            assert env["kind"] == "metric" and env["spec"]["target"] == _ACC
            # the single-stream verb and the HTTP routes agree
            single = daemon.export_state("s")
            assert single["ok"] and single["watermark"] == len(batches)
            code, body = _http(daemon.http_address(), "GET", "/v1/state")
            assert code == 200 and body["streams"]["s"]["watermark"] == len(batches)
            code, body = _http(daemon.http_address(), "GET", "/v1/streams/s/state")
            assert code == 200 and body["watermark"] == len(batches)
        finally:
            daemon.shutdown(drain=False)

    def test_drained_stream_still_exports(self, tmp_path):
        batches = _binary_batches(n_batches=3)
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, batches)
        try:
            assert daemon.drain_stream("s")["ok"]
            export = daemon.export_state("s")
            assert export["ok"] and export["watermark"] == len(batches)
        finally:
            daemon.shutdown(drain=False)

    def test_fingerprint_pin_mismatch_is_409(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, _binary_batches(n_batches=2))
        try:
            good = daemon.export_state("s")["fingerprint"]
            assert daemon.export_state("s", fingerprint=good)["ok"]
            bad = daemon.export_state("s", fingerprint="deadbeef")
            assert not bad["ok"] and bad["error"]["code"] == "fingerprint_mismatch"
            assert bad["error"]["expected"] == "deadbeef" and bad["error"]["got"] == good
            code, body = _http(daemon.http_address(), "GET", "/v1/streams/s/state?fingerprint=deadbeef")
            assert code == 409 and body["error"]["code"] == "fingerprint_mismatch"
            # the all-streams export stays top-level ok with per-stream errors
            code, body = _http(daemon.http_address(), "GET", "/v1/state?fingerprint=deadbeef")
            assert code == 200 and body["ok"]
            assert body["streams"]["s"]["error"]["code"] == "fingerprint_mismatch"
        finally:
            daemon.shutdown(drain=False)

    def test_epoch_rotates_across_restart(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = ServeDaemon(str(tmp_path / "leaf"), publish=False).start()
        assert daemon.create_stream(spec)["ok"]
        first = daemon.epoch
        _, health = _http(daemon.http_address(), "GET", "/healthz")
        assert health["epoch"] == first
        assert daemon.status()["epoch"] == first
        daemon.shutdown(drain=False)
        daemon = ServeDaemon(str(tmp_path / "leaf"), publish=False).start()
        try:
            assert daemon.epoch and daemon.epoch != first
            assert daemon.export_state()["epoch"] == daemon.epoch
        finally:
            daemon.shutdown(drain=False)


def _start_agg(tmp_path, leaves, **kwargs):
    kwargs.setdefault("pull_interval_s", 60.0)  # pulls are driven by pull_now()
    kwargs.setdefault("publish", False)
    agg = FleetAggregator(str(tmp_path / "agg"), **kwargs)
    agg.start()
    for name, daemon in sorted(leaves.items()):
        assert agg.add_leaf(name, _url(daemon))["ok"]
    return agg


class TestFleetFold:
    def test_elementwise_fold_is_bitwise(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        all_batches = _binary_batches(n_batches=9, n=108)
        per_leaf = {f"l{i}": all_batches[3 * i : 3 * i + 3] for i in range(3)}
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        agg = _start_agg(tmp_path, leaves)
        try:
            agg.pull_now()
            result = agg.aggregate()
            assert not result["errors"] and result["coverage"] == 1.0
            assert all(v["state"] == "fresh" for v in result["leaves"].values())
            stream = result["streams"]["s"]
            assert [e["leaf"] for e in stream["leaves"]] == sorted(per_leaf)
            want = _reference(tmp_path, "acc", spec, per_leaf)
            assert stream["value"] == want, f"{stream['value']} != {want}"
            assert agg.health()["state"] == "ok"
        finally:
            agg.shutdown()
            for daemon in leaves.values():
                daemon.shutdown(drain=False)

    def test_cat_fold_matches_leaf_grouped_reference(self, tmp_path):
        spec = {"name": "s", "target": _AP, "snapshot_every_n": 2, "use_feed": False}
        all_batches = _binary_batches(n_batches=6, n=120)
        per_leaf = {"a": all_batches[:3], "b": all_batches[3:]}
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        agg = _start_agg(tmp_path, leaves)
        try:
            agg.pull_now()
            result = agg.aggregate()
            assert not result["errors"]
            want = _reference(tmp_path, "ap", spec, per_leaf)
            assert result["streams"]["s"]["value"] == want
        finally:
            agg.shutdown()
            for daemon in leaves.values():
                daemon.shutdown(drain=False)

    def test_sketch_fold_is_exact_below_capacity(self, tmp_path):
        spec = {"name": "s", "target": _Q, "kwargs": {"q": 0.5, "capacity": 4096, "levels": 14},
                "snapshot_every_n": 2, "use_feed": False}
        rng = np.random.RandomState(_SEED)
        data = rng.randn(3000).astype(np.float32)
        per_leaf = {
            "a": [[c.tolist()] for c in np.array_split(data[:1700], 3)],
            "b": [[c.tolist()] for c in np.array_split(data[1700:], 3)],
        }
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        agg = _start_agg(tmp_path, leaves)
        try:
            agg.pull_now()
            result = agg.aggregate()
            assert not result["errors"]
            # below capacity the merged sketch IS the sorted union — the fold
            # equals the single-daemon drain exactly
            want = _reference(tmp_path, "q", spec, per_leaf)
            assert result["streams"]["s"]["value"] == want
        finally:
            agg.shutdown()
            for daemon in leaves.values():
                daemon.shutdown(drain=False)

    def test_collection_folds_per_member(self, tmp_path):
        rng = np.random.RandomState(_SEED)
        n = 96
        probs = rng.rand(n, 4).astype(np.float32)
        probs /= probs.sum(axis=1, keepdims=True)
        target = rng.randint(0, 4, n)
        batches = [
            [p.tolist(), t.tolist()]
            for p, t in zip(np.array_split(probs, 6), np.array_split(target, 6))
        ]
        spec = {"name": "s", "target": _COLL, "snapshot_every_n": 2, "use_feed": False}
        per_leaf = {"a": batches[:3], "b": batches[3:]}
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        agg = _start_agg(tmp_path, leaves)
        try:
            agg.pull_now()
            result = agg.aggregate()
            assert not result["errors"]
            got = result["streams"]["s"]["value"]
            want = _reference(tmp_path, "coll", spec, per_leaf)
            assert set(got) == set(want)
            for key in want:
                assert abs(got[key] - want[key]) < 1e-6, f"{key}: {got[key]} != {want[key]}"
        finally:
            agg.shutdown()
            for daemon in leaves.values():
                daemon.shutdown(drain=False)

    def test_sliced_streams_report_not_poison(self, tmp_path):
        rng = np.random.RandomState(_SEED)
        n = 64
        keys = rng.randint(0, 4, n)
        labels = rng.randint(0, 4, n)
        target = rng.randint(0, 4, n)
        batches = [
            [k.tolist(), l.tolist(), t.tolist()]
            for k, l, t in zip(np.array_split(keys, 4), np.array_split(labels, 4), np.array_split(target, 4))
        ]
        sliced = {"name": "sl", "target": _SLICED, "kwargs": {"num_classes": 4, "num_cells": 4},
                  "snapshot_every_n": 2, "use_feed": True}
        acc = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = ServeDaemon(str(tmp_path / "leaf"), publish=False).start()
        assert daemon.create_stream(sliced)["ok"] and daemon.create_stream(acc)["ok"]
        _feed(daemon, "sl", batches)
        _feed(daemon, "s", _binary_batches(n_batches=2))
        agg = _start_agg(tmp_path, {"a": daemon})
        try:
            agg.pull_now()
            result = agg.aggregate()
            # the sliced stream is a per-stream error; the foldable one folds
            assert "sl" in result["errors"] and "aggregate locally" in result["errors"]["sl"]
            assert "s" in result["streams"] and result["leaves"]["a"]["state"] == "fresh"
        finally:
            agg.shutdown()
            daemon.shutdown(drain=False)


class TestDedupAndDegradation:
    def test_replayed_prefix_dedups_never_double_counts(self, tmp_path):
        """The epoch/watermark protocol, pinned at its exact boundary: the
        leaf's three export snapshots (old boot at watermark 4; restarted
        boot mid-replay at watermark 2; restarted boot caught up at 6) are
        captured from real daemons and replayed to the aggregator through a
        stub, so the mid-replay window is deterministic instead of racing a
        live daemon's WAL re-apply."""
        batches = _binary_batches(n_batches=6)
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        old_boot = _leaf(tmp_path, "boot1", spec, batches[:4])
        export_old = json.loads(json.dumps(old_boot.export_state()))
        old_epoch = old_boot.epoch
        old_boot.shutdown(drain=False)
        new_boot = _leaf(tmp_path, "boot2", spec, batches[:2])
        export_mid = json.loads(json.dumps(new_boot.export_state()))
        _feed(new_boot, "s", batches, start=2)
        export_done = json.loads(json.dumps(new_boot.export_state()))
        new_epoch = new_boot.epoch
        new_boot.shutdown(drain=False)
        assert new_epoch != old_epoch

        proxy = _MutableProxyLeaf(export_old)
        agg = FleetAggregator(str(tmp_path / "agg"), pull_interval_s=60.0, publish=False)
        agg.start()
        try:
            assert agg.add_leaf("a", proxy.url())["ok"]
            agg.pull_now()
            before = agg.aggregate()
            assert before["streams"]["s"]["leaves"][0] == {
                "leaf": "a", "epoch": old_epoch, "watermark": 4,
            }

            proxy.body = export_mid  # the restart's replayed prefix: 2 < 4
            agg.pull_now()
            mid = agg.aggregate()
            slot = mid["streams"]["s"]["leaves"][0]
            # the OLD slot is retained — accepting the lower-watermark replay
            # would forget acked batches and later double-count them
            assert slot["epoch"] == old_epoch and slot["watermark"] == 4, slot
            assert mid["leaves"]["a"]["state"] == "lagging"
            assert "replay" in mid["leaves"]["a"]["reason"]
            assert mid["streams"]["s"]["value"] == before["streams"]["s"]["value"]
            assert agg.health()["state"] == "stalling"

            proxy.body = export_done  # the replay passed the retained slot
            agg.pull_now()
            after = agg.aggregate()
            slot = after["streams"]["s"]["leaves"][0]
            assert slot["epoch"] == new_epoch and slot["watermark"] == 6, slot
            assert after["leaves"]["a"]["state"] == "fresh"
            want = _reference(tmp_path, "dedup", spec, {"a": batches})
            assert after["streams"]["s"]["value"] == want
        finally:
            agg.shutdown()
            proxy.close()

    def test_unreachable_leaf_degrades_with_stale_slots(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        batches = _binary_batches()
        per_leaf = {"a": batches[:3], "b": batches[3:]}
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        from torchmetrics_tpu_torch.robustness import SyncConfig

        agg = _start_agg(tmp_path, leaves, sync=SyncConfig(timeout_s=1.0, retries=0))
        try:
            agg.pull_now()
            healthy = agg.aggregate()
            leaves["b"].shutdown(drain=False)
            agg.pull_now()
            result = agg.aggregate()
            assert result["leaves"]["b"]["state"] == "unreachable"
            assert result["coverage"] == 0.5
            # the dead leaf's last slot still contributes: stale but correct
            assert result["streams"]["s"]["value"] == healthy["streams"]["s"]["value"]
            health = agg.health()
            assert health["state"] == "degraded" and health["http_status"] == 503
            assert "b is unreachable" in health["reason"] and "coverage 1/2" in health["reason"]
            status = agg.fleet_status()
            assert status["leaves"]["b"]["failures"] >= 1
        finally:
            agg.shutdown()
            leaves["a"].shutdown(drain=False)

    def test_fingerprint_pinned_fleet_quarantines_foreign_leaf(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, _binary_batches(n_batches=2))
        agg = _start_agg(tmp_path, {"a": daemon}, fingerprint="deadbeef")
        try:
            agg.pull_now()
            result = agg.aggregate()
            assert result["leaves"]["a"]["state"] == "quarantined"
            assert result["coverage"] == 0.0 and "s" not in result["streams"]
            health = agg.health()
            assert health["state"] == "degraded" and "quarantined" in health["reason"]
        finally:
            agg.shutdown()
            daemon.shutdown(drain=False)


class _MutableProxyLeaf:
    """An HTTP stub replaying a captured /v1/state body; the test can corrupt
    one stream's payload and later heal it — the aggregator must quarantine
    the whole pull (validate-ALL-then-apply) and recover on the clean pull."""

    def __init__(self, body):
        self.body = body
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                data = json.dumps(outer.body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def url(self):
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class TestQuarantineLifecycle:
    def test_corrupt_payload_quarantines_whole_pull_then_heals(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        spec2 = {"name": "t", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = ServeDaemon(str(tmp_path / "leaf"), publish=False).start()
        assert daemon.create_stream(spec)["ok"] and daemon.create_stream(spec2)["ok"]
        _feed(daemon, "s", _binary_batches(n_batches=3))
        _feed(daemon, "t", _binary_batches(n_batches=3, seed=_SEED + 1))
        good = json.loads(json.dumps(daemon.export_state()))
        daemon.shutdown(drain=False)

        corrupt = json.loads(json.dumps(good))
        # one stream was written by a FOREIGN registry; the other is clean
        for entry in corrupt["streams"]["t"]["state"]["checkpoint"]["metrics"].values():
            entry["fingerprint"] = "deadbeef"
        proxy = _MutableProxyLeaf(corrupt)
        agg = FleetAggregator(str(tmp_path / "agg"), pull_interval_s=60.0, publish=False)
        agg.start()
        try:
            assert agg.add_leaf("a", proxy.url())["ok"]
            agg.pull_now()
            result = agg.aggregate()
            assert result["leaves"]["a"]["state"] == "quarantined"
            reason = result["leaves"]["a"]["reason"]
            assert "stream t" in reason and "fingerprint" in reason, reason
            # validate-ALL-then-apply: the CLEAN stream was not half-folded
            assert result["streams"] == {} and result["coverage"] == 0.0
            assert agg.health()["state"] == "degraded"

            proxy.body = good  # the leaf heals; the next pull readmits it
            agg.pull_now()
            healed = agg.aggregate()
            assert healed["leaves"]["a"]["state"] == "fresh"
            assert set(healed["streams"]) == {"s", "t"} and healed["coverage"] == 1.0
            assert agg.health()["state"] == "ok"
        finally:
            agg.shutdown()
            proxy.close()


class TestFoldStateResume:
    def test_registry_and_slots_survive_restart(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        batches = _binary_batches()
        per_leaf = {"a": batches[:3], "b": batches[3:]}
        leaves = {name: _leaf(tmp_path, name, spec, per_leaf[name]) for name in per_leaf}
        agg = _start_agg(tmp_path, leaves)
        try:
            agg.pull_now()
            before = agg.aggregate()
            assert not before["errors"]
            agg._save_fold_state()  # what the periodic writer persists
            fold_seq = agg.fleet_status()["fold_seq"]
            assert fold_seq >= 1
        finally:
            agg.shutdown()
        # leaves go dark BEFORE the restart: the resumed aggregator must
        # answer from its fold store, not from re-pulling history
        for daemon in leaves.values():
            daemon.shutdown(drain=False)

        resumed = FleetAggregator(str(tmp_path / "agg"), pull_interval_s=60.0, publish=False)
        resumed.start()
        try:
            status = resumed.fleet_status()
            assert set(status["leaves"]) == {"a", "b"}
            assert status["fold_seq"] >= fold_seq
            result = resumed.aggregate()
            assert all(v["state"] == "lagging" for v in result["leaves"].values())
            assert all("restored from fold checkpoint" in v["reason"] for v in result["leaves"].values())
            assert result["streams"]["s"]["value"] == before["streams"]["s"]["value"]
            assert result["coverage"] == 1.0  # lagging leaves still contribute
            assert resumed.health()["state"] == "stalling"
        finally:
            resumed.shutdown()

    def test_removed_leaf_stays_removed_across_restart(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, _binary_batches(n_batches=2))
        agg = _start_agg(tmp_path, {"a": daemon, "b": daemon})
        try:
            agg.pull_now()
            agg._save_fold_state()
            assert agg.remove_leaf("b")["ok"]
            assert set(agg.leaves()) == {"a"}
        finally:
            agg.shutdown()
        resumed = FleetAggregator(str(tmp_path / "agg"), pull_interval_s=60.0, publish=False)
        resumed.start()
        try:
            # the registry wins over stale fold-store slots
            assert set(resumed.fleet_status()["leaves"]) == {"a"}
            assert "b" not in resumed.aggregate()["leaves"]
        finally:
            resumed.shutdown()
            daemon.shutdown(drain=False)


class TestControlPlane:
    def test_http_verbs_and_healthz(self, tmp_path):
        spec = {"name": "s", "target": _ACC, "snapshot_every_n": 2, "use_feed": False}
        daemon = _leaf(tmp_path, "leaf", spec, _binary_batches(n_batches=2))
        agg = FleetAggregator(str(tmp_path / "agg"), pull_interval_s=60.0, publish=False)
        agg.start()
        try:
            addr = agg.http_address()
            code, body = _http(addr, "POST", "/v1/fleet/leaves", {"name": "a", "url": _url(daemon)})
            assert code == 200 and body["ok"]
            code, body = _http(addr, "POST", "/v1/fleet/leaves", {"name": "a", "url": _url(daemon)})
            assert code == 409 and body["error"]["code"] == "exists"
            code, body = _http(addr, "POST", "/v1/fleet/leaves", {"name": "../evil", "url": "x"})
            assert code == 400 and body["error"]["code"] == "bad_request"
            agg.pull_now()
            code, body = _http(addr, "GET", "/v1/fleet")
            assert code == 200 and body["leaves"]["a"]["state"] == "fresh"
            assert body["leaves"]["a"]["streams"]["s"]["watermark"] == 2
            code, body = _http(addr, "GET", "/v1/fleet/aggregate")
            assert code == 200 and body["ok"] and "s" in body["streams"]
            code, body = _http(addr, "GET", "/healthz")
            assert code == 200 and body["state"] == "ok" and body["coverage"] == 1.0
            # a dead leaf flips /healthz to 503 with the coverage reason
            daemon.shutdown(drain=False)
            from torchmetrics_tpu_torch.robustness import SyncConfig

            agg.sync = SyncConfig(timeout_s=1.0, retries=0)
            agg.pull_now()
            code, body = _http(addr, "GET", "/healthz")
            assert code == 503 and body["state"] == "degraded" and "coverage" in body["reason"]
            code, body = _http(addr, "DELETE", "/v1/fleet/leaves/a")
            assert code == 200 and body["ok"]
            code, body = _http(addr, "DELETE", "/v1/fleet/leaves/a")
            assert code == 404
        finally:
            agg.shutdown()


# ------------------------------------------------ a mixed fleet: JAX and port leaves

#: fleet values of the two aggregators and the one-process fold agree within
#: this absolute budget, scaled by max(1, |value|)
_MIXED_BUDGET = 1e-6


@pytest.mark.parametrize(
    "factory,kwargs",
    [("binary_accuracy", {}), ("binary_average_precision", {}), ("quantile", {"capacity": 256, "levels": 4})],
    ids=["sum", "cat", "sketch"],
)
def test_mixed_fleet_folds_alike_in_either_aggregator(tmp_path, factory, kwargs):
    """A JAX ``ServeDaemon`` leaf and a port ``ServeDaemon(device="cpu")``
    leaf serve one stream (the spec names JAX's factory path); a JAX
    ``FleetAggregator`` and a port one each pull both over localhost and fold
    them. The two answers equal each other and the one-process fold of the
    same batches in sorted-leaf order (the sketch below its capacity, where
    its merge is exact)."""
    from torchmetrics_tpu.serve import FleetAggregator as JFleetAggregator
    from torchmetrics_tpu.serve import ServeDaemon as JServeDaemon
    from torchmetrics_tpu_torch.serve.stream import decode_batch, resolve_target

    spec = {"name": "s", "target": f"torchmetrics_tpu.serve.factories:{factory}", "kwargs": kwargs,
            "snapshot_every_n": 2, "use_feed": False}
    if factory == "quantile":
        rng = np.random.RandomState(_SEED)
        all_batches = [[rng.standard_normal(40).astype(np.float32).tolist()] for _ in range(6)]
    else:
        all_batches = _binary_batches(n_batches=6, n=120)
    per_leaf = {"a_jax": all_batches[:3], "b_port": all_batches[3:]}
    leaves = {}
    for name, daemon_cls in (("a_jax", JServeDaemon), ("b_port", ServeDaemon)):
        leaves[name] = daemon_cls(str(tmp_path / name), publish=False).start()
        assert leaves[name].create_stream(spec)["ok"]
        _feed(leaves[name], "s", per_leaf[name])
    values = {}
    try:
        for tag, agg_cls in (("jax", JFleetAggregator), ("port", FleetAggregator)):
            agg = agg_cls(str(tmp_path / f"agg_{tag}"), pull_interval_s=60.0, publish=False).start()
            try:
                for name in sorted(leaves):
                    assert agg.add_leaf(name, _url(leaves[name]))["ok"]
                agg.pull_now()
                result = agg.aggregate()
                assert not result["errors"] and result["coverage"] == 1.0, result
                stream = result["streams"]["s"]
                assert [e["leaf"] for e in stream["leaves"]] == sorted(per_leaf)
                assert [e["watermark"] for e in stream["leaves"]] == [3, 3]
                values[tag] = np.asarray(stream["value"], np.float64)
            finally:
                agg.shutdown()
    finally:
        for daemon in leaves.values():
            daemon.shutdown(drain=False)
    ref = resolve_target(spec["target"], kwargs, device=CPU)
    for name in sorted(per_leaf):
        for batch in per_leaf[name]:
            ref.update(*decode_batch(batch))
    want = np.asarray(ref.compute(), np.float64)
    for tag, got in values.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=_MIXED_BUDGET * max(1.0, float(np.abs(want).max())),
                                   err_msg=tag)
    if factory == "binary_accuracy":  # integer states fold exactly: the values are bitwise equal
        assert values["jax"].tolist() == values["port"].tolist() == want.tolist()
