# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's ``CheckpointStore`` (the counterparts of
``tests/unittests/bases/test_store.py``: atomicity, CRC32 integrity,
monotonic steps, retention, rank-aware writes, and the negative paths —
torn writes, bitrot, deleted and truncated snapshots, unpicklable payloads,
manifest damage, fingerprint drift and the validation ladder all recover to
the newest VALID snapshot or raise a named error, never a half-restore),
and stores crossing packages: a store either package's ``CheckpointStore``
wrote is read by the other's and passes ``tools/metricdoctor.py verify``
(run in a subprocess, not edited). JAX's ``test_snapshot_bytes_gauge_and_counters``
has its counterpart in ``tests/test_torch_obs.py``.
"""
import json
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmetrics_tpu.robustness as JR
import torchmetrics_tpu_torch as T
from torchmetrics_tpu_torch.robustness import CheckpointStore, checkpoint_fingerprint, faults
from torchmetrics_tpu_torch.robustness import store_format as fmt
from torchmetrics_tpu_torch.utilities.exceptions import CheckpointStoreWarning, StateRestoreError

ROOT = Path(__file__).resolve().parent.parent


def _store(tmp_path, **kwargs):
    return CheckpointStore(str(tmp_path / "store"), **kwargs)


def _seed(store, n=3):
    for step in range(1, n + 1):
        store.save({"step": step, "blob": np.arange(step * 4, dtype=np.float32)}, step=step)


def _acc(num_classes=5):
    return T.MulticlassAccuracy(num_classes=num_classes, device="cpu")


def _labels(rng, n):
    return torch.from_numpy(rng.randint(0, 5, n)), torch.from_numpy(rng.randint(0, 5, n))


@pytest.fixture(autouse=True)
def _no_store_warnings_leak():
    # every test asserts its own warnings; anything unasserted should fail loudly
    with warnings.catch_warnings():
        warnings.filterwarnings("error", category=CheckpointStoreWarning)
        yield


# ----------------------------------------------------------------- happy path


def test_save_latest_roundtrip_and_layout(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 3)
    step, payload = store.latest()
    assert step == 3 and payload["step"] == 3
    np.testing.assert_array_equal(payload["blob"], np.arange(12, dtype=np.float32))
    names = sorted(os.listdir(store.directory))
    assert names == [fmt.MANIFEST_NAME] + [fmt.snapshot_filename(s) for s in (1, 2, 3)]
    manifest = fmt.read_manifest(store.directory)
    assert [e["step"] for e in manifest["snapshots"]] == [1, 2, 3]
    for entry in manifest["snapshots"]:
        data = fmt.read_snapshot_bytes(store.directory, entry)
        assert pickle.loads(data)["step"] == entry["step"]
    assert store.verify()["ok"]


def test_steps_are_strictly_monotonic(tmp_path):
    store = _store(tmp_path)
    store.save({"x": 1}, step=5)
    with pytest.raises(ValueError, match="strictly monotonic"):
        store.save({"x": 2}, step=5)
    with pytest.raises(ValueError, match="strictly monotonic"):
        store.save({"x": 2}, step=4)
    store.save({"x": 2}, step=6)
    assert store.steps() == [5, 6]


def test_keep_last_retention_prunes_oldest(tmp_path):
    store = _store(tmp_path, keep_last=2)
    _seed(store, 5)
    assert store.steps() == [4, 5]
    files = [n for n in os.listdir(store.directory) if n.endswith(fmt.SNAPSHOT_SUFFIX)]
    assert sorted(files) == [fmt.snapshot_filename(4), fmt.snapshot_filename(5)]


def test_empty_store_latest_is_none(tmp_path):
    store = _store(tmp_path)
    assert store.latest() is None and store.steps() == [] and store.last_step() is None
    os.makedirs(store.directory)
    report = store.verify()
    assert report["ok"] and "no manifest" in report["problems"][0]
    missing = CheckpointStore(str(tmp_path / "nope")).verify()
    assert not missing["ok"] and "not a directory" in missing["problems"][0]


def test_non_writer_rank_never_touches_disk(tmp_path, monkeypatch):
    import torchmetrics_tpu_torch.robustness.store as store_mod

    monkeypatch.setattr(store_mod, "_process_index", lambda: 1)
    store = _store(tmp_path)  # write_rank=0 default
    assert not store.is_writer
    assert store.save({"x": 1}, step=1) is None
    assert store.prune() == []
    assert not os.path.exists(store.directory)
    every = CheckpointStore(str(tmp_path / "every"), write_rank=None)
    assert every.is_writer and every.save({"x": 1}, step=1) is not None


def test_process_index_is_the_default_group_rank_else_0():
    import torchmetrics_tpu_torch.robustness.store as store_mod

    assert store_mod._process_index() == 0  # no process group in this test process


def test_invalid_keep_last_refused(tmp_path):
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointStore(str(tmp_path), keep_last=0)


# -------------------------------------------------------------- negative paths


def test_torn_write_leaves_store_readable(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 2)
    with faults.inject(faults.Fault("fail", "store.write.torn")):
        with pytest.raises(faults.FaultInjected):
            store.save({"step": 3}, step=3)
    assert fmt.temp_files(store.directory), "torn write left no temp debris"
    assert not os.path.exists(os.path.join(store.directory, fmt.snapshot_filename(3)))
    step, payload = store.latest()  # no warning: the manifest is clean
    assert step == 2 and payload["step"] == 2
    report = store.verify()
    assert report["ok"] and report["torn_temp_files"]
    removed = store.prune()
    assert any(".tmp-" in n for n in removed)
    store.save({"step": 3}, step=3)
    assert store.latest()[0] == 3


def test_disk_exhaustion_surfaces_as_enospc(tmp_path):
    import errno

    store = _store(tmp_path, keep_last=None)
    _seed(store, 1)
    with faults.inject(faults.Fault("fail", "store.write.enospc")):
        with pytest.raises(OSError) as info:
            store.save({"step": 2}, step=2)
    assert info.value.errno == errno.ENOSPC
    assert store.steps() == [1] and not fmt.temp_files(store.directory)


def test_crc_mismatch_skips_to_newest_valid_with_named_warning(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 2)
    with faults.inject(faults.Fault("corrupt", "store.payload", arg=32)):
        store.save({"step": 3}, step=3)
    with pytest.warns(CheckpointStoreWarning, match="step 3.*CRC32"):
        step, payload = store.latest()
    assert step == 2 and payload["step"] == 2
    report = store.verify()
    assert not report["ok"] and "CRC32" in report["problems"][0]


def test_manifest_pointing_at_deleted_snapshot_falls_back(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 3)
    os.unlink(os.path.join(store.directory, fmt.snapshot_filename(3)))
    with pytest.warns(CheckpointStoreWarning, match="step 3.*deleted"):
        step, _ = store.latest()
    assert step == 2


def test_truncated_snapshot_file_falls_back(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 2)
    path = os.path.join(store.directory, fmt.snapshot_filename(2))
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[: len(data) // 2])
    with pytest.warns(CheckpointStoreWarning, match="step 2.*torn or truncated"):
        step, _ = store.latest()
    assert step == 1


def test_unpicklable_payload_falls_back(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 2)
    manifest = fmt.read_manifest(store.directory)
    garbage = b"\x00not a pickle\x00"
    fmt.atomic_write(os.path.join(store.directory, fmt.snapshot_filename(2)), garbage)
    manifest["snapshots"][1]["crc32"] = fmt.payload_crc(garbage)
    manifest["snapshots"][1]["bytes"] = len(garbage)
    fmt.write_manifest(store.directory, manifest)
    with pytest.warns(CheckpointStoreWarning, match="step 2.*unpickle"):
        step, _ = store.latest()
    assert step == 1


def test_all_snapshots_bad_returns_none(tmp_path):
    store = _store(tmp_path, keep_last=None)
    _seed(store, 2)
    for step in (1, 2):
        os.unlink(os.path.join(store.directory, fmt.snapshot_filename(step)))
    with pytest.warns(CheckpointStoreWarning):
        assert store.latest() is None


def test_malformed_manifest_is_a_hard_error(tmp_path):
    store = _store(tmp_path)
    _seed(store, 1)
    Path(store.directory, fmt.MANIFEST_NAME).write_text("{not json")
    with pytest.raises(fmt.StoreFormatError, match="unreadable"):
        store.latest()
    report = store.verify()
    assert not report["ok"] and not report["manifest_ok"]


def test_future_store_format_version_refused(tmp_path):
    store = _store(tmp_path)
    _seed(store, 1)
    path = Path(store.directory, fmt.MANIFEST_NAME)
    manifest = json.loads(path.read_text())
    manifest["store_format_version"] = 99
    path.write_text(json.dumps(manifest))
    with pytest.raises(fmt.StoreFormatError, match="version 99"):
        store.latest()


def test_fingerprint_drift_raises_named_error(tmp_path):
    rng = np.random.RandomState(0)
    src = _acc()
    src.update(*_labels(rng, 64))
    directory = str(tmp_path / "store")
    store = CheckpointStore(directory, fingerprint=checkpoint_fingerprint(src))
    store.save({"checkpoint": src.save_checkpoint()}, step=1)

    drifted = _acc(7)
    reopened = CheckpointStore(directory, fingerprint=checkpoint_fingerprint(drifted))
    with pytest.raises(StateRestoreError, match="fingerprint"):
        reopened.latest()
    with pytest.raises(StateRestoreError, match="fingerprint"):
        reopened.save({"x": 1}, step=2)

    unpinned = CheckpointStore(directory)

    def validate(payload):
        drifted.load_checkpoint(payload["checkpoint"])

    with pytest.warns(CheckpointStoreWarning, match="fails validation"):
        assert unpinned.latest(validate=validate) is None
    assert drifted._update_count == 0

    fresh = _acc()
    step, _ = unpinned.latest(validate=lambda p: fresh.load_checkpoint(p["checkpoint"]))
    assert step == 1 and fresh._update_count == src._update_count
    assert float(fresh.compute()) == float(src.compute())


def test_latest_validation_ladder_falls_back_to_older_schema_match(tmp_path):
    rng = np.random.RandomState(1)
    src = _acc()
    src.update(*_labels(rng, 32))
    good = src.save_checkpoint()
    src.update(*_labels(rng, 32))
    truncated = src.save_checkpoint()
    del truncated["metrics"][""]["state"]

    store = _store(tmp_path, keep_last=None)
    store.save({"checkpoint": good}, step=1)
    store.save({"checkpoint": truncated}, step=2)

    fresh = _acc()
    with pytest.warns(CheckpointStoreWarning, match="step 2.*fails validation"):
        step, _ = store.latest(validate=lambda p: fresh.load_checkpoint(p["checkpoint"]))
    assert step == 1 and fresh._update_count == 1


# --------------------------------------------------------- across the packages


def _metricdoctor(*args):
    return subprocess.run(
        [sys.executable, str(ROOT / "tools" / "metricdoctor.py"), *args],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120,
    )


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_cross_packages_and_pass_metricdoctor(tmp_path, writer):
    """One package's store of metric checkpoints, read by the other's
    ``latest`` with the other's metric as validator, and verified by
    ``tools/metricdoctor.py``; a bitrotted copy fails ``verify`` (exit 1)
    and falls back one snapshot in both packages."""
    import jax.numpy as jnp

    import torchmetrics_tpu as J

    rng = np.random.RandomState(5)
    batches = [(rng.randint(0, 5, 48), rng.randint(0, 5, 48)) for _ in range(3)]
    pkgs = {"port": (T, CheckpointStore, lambda x: torch.from_numpy(x), {"device": "cpu"}),
            "jax": (J, JR.CheckpointStore, jnp.asarray, {})}
    reader = "jax" if writer == "port" else "port"
    pkg, store_cls, conv, kw = pkgs[writer]
    src = pkg.classification.MulticlassAccuracy(num_classes=5, **kw)
    directory = str(tmp_path / "s")
    store = store_cls(directory, keep_last=None, fingerprint=src.__class__.__name__)
    for step, (p, t) in enumerate(batches, 1):
        src.update(conv(p), conv(t))
        store.save({"checkpoint": src.save_checkpoint()}, step=step)

    out = _metricdoctor("verify", directory)
    assert out.returncode == 0, out.stdout + out.stderr
    listing = _metricdoctor("list", directory)
    assert listing.returncode == 0 and fmt.snapshot_filename(3) in listing.stdout, listing.stdout

    rpkg, rstore_cls, _, rkw = pkgs[reader]
    dst = rpkg.classification.MulticlassAccuracy(num_classes=5, **rkw)
    step, _ = rstore_cls(directory, fingerprint=src.__class__.__name__).latest(
        validate=lambda payload: dst.load_checkpoint(payload["checkpoint"])
    )
    assert step == 3 and dst._update_count == 3
    assert float(dst.compute()) == float(src.compute())

    # bitrot the newest snapshot: metricdoctor fails it, both packages fall back to step 2
    path = Path(directory, fmt.snapshot_filename(3))
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    assert _metricdoctor("verify", directory).returncode == 1
    for name, (_, any_store, _, _) in pkgs.items():
        with pytest.warns(Warning, match="step 3"):
            assert any_store(directory).latest()[0] == 2, name


@pytest.mark.parametrize("hide_ml_dtypes", [False, True], ids=["ml_dtypes", "no_ml_dtypes"])
def test_bfloat16_state_snapshots_and_resumes(tmp_path, monkeypatch, hide_ml_dtypes):
    """A bfloat16 state goes through the store (pickle, CRC, manifest) and a
    resumed evaluator restores it bit for bit, with or without ``ml_dtypes``
    (hidden here): ROADMAP C5."""
    import sys

    from torchmetrics_tpu_torch.robustness import StreamingEvaluator

    if hide_ml_dtypes:
        monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    rng = np.random.default_rng(9)
    m = T.MeanSquaredError(device="cpu")
    m.update(torch.from_numpy(rng.standard_normal(16).astype(np.float32)), torch.zeros(16))
    m.set_dtype(torch.bfloat16)
    runner = StreamingEvaluator(m, store=_store(tmp_path))
    runner.cursor = 1
    assert runner.snapshot() == 1
    assert _store(tmp_path).verify()["ok"]
    fresh = T.MeanSquaredError(device="cpu").set_dtype(torch.bfloat16)
    resumed = StreamingEvaluator(fresh, store=_store(tmp_path))
    assert resumed._restore_latest() == 1
    assert fresh.sum_squared_error.dtype == torch.bfloat16
    assert torch.equal(fresh.sum_squared_error.view(torch.int16), m.sum_squared_error.view(torch.int16))
