# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's ``save_checkpoint``/``load_checkpoint`` against the JAX
package's, on the CPU, both ways.

The same seeded numpy batches go through a metric of each package; then:
the two checkpoints have the same paths, keys, fingerprints, update counts
and host counters; integer states are bitwise equal and float states within
rtol 1e-6, atol 1e-6 (sums in another order); each package's checkpoint,
pickled, loads into a fresh metric of the other, which then checkpoints the
SAME bytes back (a restore changes no bit) and computes within rtol 1e-6,
atol 1e-7 of the writer's value. A pickle of the port's checkpoint names
only numpy (no torch), as a JAX one does. Cat states are compared
concatenated: the list's length is not part of the result. Cases: a binned
and an exact AUROC, ``Running(MeanSquaredError(), 3)`` (a host counter),
``MinMaxMetric(MulticlassAUROC)``, ``ClasswiseWrapper(MulticlassF1Score)``,
``MeanMetric`` with NaNs, each step of a ``MetricTracker`` (the tracker is
no ``Metric`` in either package: its steps checkpoint) and the headline
``MetricCollection`` through the runner's per-member dict.

Also the port's counterparts of ``tests/unittests/bases/test_checkpointing.py``
(the sketch cases wait for ROADMAP A9), and the port's own rules: a load
installs tensors of their own on the metric's device, and clears the
mesh-replicated flag.
"""
import io
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.parallel.sharded import _walk_metrics as j_walk
from torchmetrics_tpu.robustness import StreamingEvaluator as JEval
from torchmetrics_tpu.robustness import checkpoint_fingerprint as j_fingerprint
from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics as t_walk
from torchmetrics_tpu_torch.robustness import StreamingEvaluator as TEval
from torchmetrics_tpu_torch.robustness import checkpoint_fingerprint as t_fingerprint
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

C, N, NB, THR = 5, 64, 4, 16
STATE_RTOL, STATE_ATOL = 1e-6, 1e-6
VALUE_RTOL, VALUE_ATOL = 1e-6, 1e-7


def _kw(pkg):
    return {} if pkg is J else {"device": "cpu"}


def _conv(pkg, x):
    return jnp.asarray(x) if pkg is J else torch.from_numpy(np.ascontiguousarray(x))


def _cls_batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(NB):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _reg_batches(seed=1):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32)) for _ in range(NB)
    ]


def _nan_batches(seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(NB):
        v = rng.standard_normal(N).astype(np.float32)
        if i == 2:
            v[[3, 17]] = np.nan
        out.append((v,))
    return out


def _update(metric, batch, pkg):
    metric.update(*(_conv(pkg, x) for x in batch))


def _update_then_compute(metric, batch, pkg):
    _update(metric, batch, pkg)
    metric.compute()  # MinMaxMetric folds its bounds at compute


#: (id, factory(pkg), batches, per-batch step)
CASES = [
    ("binned_auroc", lambda p: p.classification.MulticlassAUROC(num_classes=C, thresholds=THR, **_kw(p)), _cls_batches, _update),
    ("exact_auroc", lambda p: p.classification.MulticlassAUROC(num_classes=C, **_kw(p)), _cls_batches, _update),
    ("running_mse", lambda p: p.Running(p.MeanSquaredError(**_kw(p)), window=3), _reg_batches, _update),
    (
        "minmax_auroc",
        lambda p: p.MinMaxMetric(p.classification.MulticlassAUROC(num_classes=C, thresholds=THR, **_kw(p))),
        _cls_batches,
        _update_then_compute,
    ),
    (
        "classwise_f1",
        lambda p: p.ClasswiseWrapper(p.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(p))),
        _cls_batches,
        _update,
    ),
    ("mean_nan", lambda p: p.MeanMetric(nan_strategy="disable", **_kw(p)), _nan_batches, _update),
]


def _driven(pkg, make, batches, step):
    metric = make(pkg)
    for batch in batches:
        step(metric, batch, pkg)
    return metric


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _flat_value(value):
    if isinstance(value, dict):
        return {k: _np(v) for k, v in value.items()}
    return {"": _np(value)}


def _leaf(value):
    """A state as one array: cat states concatenated (their length is not part of the result)."""
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(v) for v in value]) if value else np.zeros((0,))
    return value


def _assert_leaf_bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _assert_checkpoints_bitwise(got, want, what):
    """Two checkpoint dicts with the same structure and the same bytes in every leaf."""
    assert {k: v for k, v in got.items() if k != "metrics"} == {k: v for k, v in want.items() if k != "metrics"}, what
    assert sorted(got["metrics"]) == sorted(want["metrics"]), what
    for path, entry in want["metrics"].items():
        mine = got["metrics"][path]
        assert mine["fingerprint"] == entry["fingerprint"] and mine["update_count"] == entry["update_count"], (what, path)
        assert mine["host_counters"] == entry["host_counters"], (what, path)
        assert sorted(mine["state"]) == sorted(entry["state"]), (what, path)
        for name, value in entry["state"].items():
            if isinstance(value, list):
                assert isinstance(mine["state"][name], list) and len(mine["state"][name]) == len(value), (what, path, name)
                for g, w in zip(mine["state"][name], value):
                    _assert_leaf_bitwise(g, w, f"{what} {path}/{name}")
            else:
                _assert_leaf_bitwise(mine["state"][name], value, f"{what} {path}/{name}")


def _assert_checkpoints_close(got, want, what):
    """The two packages' checkpoints of one stream: same structure, int leaves
    bitwise, float leaves within the state budget."""
    assert got["fingerprint"] == want["fingerprint"] and got["class"] == want["class"], what
    assert got["format_version"] == want["format_version"] == 1, what
    assert sorted(got["metrics"]) == sorted(want["metrics"]), what
    for path, entry in want["metrics"].items():
        mine = got["metrics"][path]
        assert mine["fingerprint"] == entry["fingerprint"], (what, path)
        assert type(mine["update_count"]) is int and mine["update_count"] == entry["update_count"], (what, path)
        assert mine["host_counters"] == entry["host_counters"], (what, path)
        for attr, value in mine["host_counters"].items():
            assert type(value) is type(entry["host_counters"][attr]), (what, path, attr)
        assert sorted(mine["state"]) == sorted(entry["state"]), (what, path)
        for name, value in entry["state"].items():
            g, w = _leaf(mine["state"][name]), _leaf(value)
            assert isinstance(mine["state"][name], list) == isinstance(value, list), (what, path, name)
            assert g.dtype == w.dtype and g.shape == w.shape, (what, path, name, g.dtype, w.dtype, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=STATE_RTOL, atol=STATE_ATOL, equal_nan=True, err_msg=f"{what} {path}/{name}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}/{name}")


def _assert_values_close(got, want, what):
    got, want = _flat_value(got), _flat_value(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], rtol=VALUE_RTOL, atol=VALUE_ATOL, equal_nan=True, err_msg=f"{what} {k}")


class _NamesModules(pickle.Unpickler):
    """Unpickler that records every global a pickle names."""

    def __init__(self, data):
        super().__init__(io.BytesIO(data))
        self.modules = set()

    def find_class(self, module, name):
        self.modules.add(module)
        return super().find_class(module, name)


def _pickled_modules(obj):
    reader = _NamesModules(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    reader.load()
    return reader.modules


# ----------------------------------------------------------- cross-package


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_checkpoints_cross_both_ways(case):
    _, make, batches_fn, step = case
    batches = batches_fn()
    jm, tm = _driven(J, make, batches, step), _driven(T, make, batches, step)
    assert [p for p, _ in t_walk(tm)] == [p for p, _ in j_walk(jm)]
    assert t_fingerprint(tm) == j_fingerprint(jm)
    ck_j, ck_t = jm.save_checkpoint(), tm.save_checkpoint()
    _assert_checkpoints_close(ck_t, ck_j, "port vs JAX checkpoint")
    assert {m.split(".")[0] for m in _pickled_modules(ck_t)} <= {"numpy"}, _pickled_modules(ck_t)

    # JAX -> port: the port restores the JAX bytes and writes them back unchanged
    t_fresh = make(T)
    t_fresh.load_checkpoint(pickle.loads(pickle.dumps(ck_j)))
    _assert_checkpoints_bitwise(t_fresh.save_checkpoint(), ck_j, "JAX checkpoint through the port")
    _assert_values_close(t_fresh.compute(), jm.compute(), "port restored from JAX")
    # port -> JAX
    j_fresh = make(J)
    j_fresh.load_checkpoint(pickle.loads(pickle.dumps(ck_t)))
    _assert_checkpoints_bitwise(j_fresh.save_checkpoint(), ck_t, "port checkpoint through JAX")
    _assert_values_close(j_fresh.compute(), tm.compute(), "JAX restored from the port")


def _suite(pkg):
    return pkg.MetricCollection(
        {
            "acc": pkg.classification.MulticlassAccuracy(num_classes=C, average="micro", **_kw(pkg)),
            "f1": pkg.classification.MulticlassF1Score(num_classes=C, average="macro", **_kw(pkg)),
            "auroc": pkg.classification.MulticlassAUROC(num_classes=C, thresholds=THR, **_kw(pkg)),
        }
    )


def test_headline_collection_checkpoints_cross_through_the_runner():
    """The runner's per-member dict of the headline suite, both ways."""
    batches = _cls_batches()
    suites = {}
    for pkg in (J, T):
        suites[pkg] = _suite(pkg)
        for batch in batches:
            _update(suites[pkg], batch, pkg)
    ck_j, ck_t = JEval(suites[J])._checkpoint(), TEval(suites[T])._checkpoint()
    assert sorted(ck_t) == sorted(ck_j) == ["acc", "auroc", "f1"]
    assert TEval(suites[T])._fingerprint() == JEval(suites[J])._fingerprint()
    for key in ck_j:
        _assert_checkpoints_close(ck_t[key], ck_j[key], key)
        for name, value in ck_t[key]["metrics"][""]["state"].items():
            _assert_leaf_bitwise(value, ck_j[key]["metrics"][""]["state"][name], f"{key}.{name}")  # int32 counts
    t_fresh, j_fresh = _suite(T), _suite(J)
    TEval(t_fresh)._restore_checkpoint(pickle.loads(pickle.dumps(ck_j)))
    JEval(j_fresh)._restore_checkpoint(pickle.loads(pickle.dumps(ck_t)))
    for key in ck_j:
        _assert_checkpoints_bitwise(TEval(t_fresh)._checkpoint()[key], ck_j[key], key)
        _assert_checkpoints_bitwise(JEval(j_fresh)._checkpoint()[key], ck_t[key], key)
    _assert_values_close(t_fresh.compute(), suites[J].compute(), "suite restored in the port")
    _assert_values_close(j_fresh.compute(), suites[T].compute(), "suite restored in JAX")


def test_tracker_steps_checkpoint_across_packages():
    """``MetricTracker`` is no ``Metric`` in either package (JAX's
    ``save_checkpoint`` of one raises): its walk paths match, and each
    tracked step's suite checkpoints across, both ways."""
    batches = _cls_batches()
    trackers = {}
    for pkg in (J, T):
        trackers[pkg] = pkg.MetricTracker(_suite(pkg), maximize=[True, True, True])
        for i, batch in enumerate(batches):
            if i % 2 == 0:
                trackers[pkg].increment()
            _update(trackers[pkg], batch, pkg)
    assert [p for p, _ in t_walk(trackers[T])] == [p for p, _ in j_walk(trackers[J])]
    for step in range(trackers[J].n_steps):
        js, ts = trackers[J]._metrics[step], trackers[T]._metrics[step]
        ck_j, ck_t = JEval(js)._checkpoint(), TEval(ts)._checkpoint()
        for key in ck_j:
            _assert_checkpoints_close(ck_t[key], ck_j[key], f"step {step} {key}")
        fresh = _suite(T)
        TEval(fresh)._restore_checkpoint(ck_j)
        _assert_values_close(fresh.compute(), js.compute(), f"step {step}")


# ------------------------------------------- counterparts of test_checkpointing


def _int_batches(seed, n=6, size=48):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randint(0, 5, size)), torch.from_numpy(rng.randint(0, 5, size))) for _ in range(n)]


def _assert_states_equal(got, want):
    got_tree, want_tree = got.state_tree(include_count=True), want.state_tree(include_count=True)
    assert set(got_tree) == set(want_tree)
    for key, want_val in want_tree.items():
        got_val = got_tree[key]
        if isinstance(want_val, list):
            assert len(got_val) == len(want_val), key
            for g, w in zip(got_val, want_val):
                assert torch.equal(g, w), key
        elif isinstance(want_val, torch.Tensor):
            assert torch.equal(got_val, want_val), key
        else:
            assert got_val == want_val, key


def test_checkpoint_roundtrip_array_state_bit_for_bit():
    batches = _int_batches(7)
    m = T.MulticlassAccuracy(num_classes=5, device="cpu")
    for b in batches[:3]:
        m.update(*b)
    blob = pickle.dumps(m.save_checkpoint())
    resumed = T.MulticlassAccuracy(num_classes=5, device="cpu")
    resumed.load_checkpoint(pickle.loads(blob))
    for b in batches[3:]:
        resumed.update(*b)
    unbroken = T.MulticlassAccuracy(num_classes=5, device="cpu")
    for b in batches:
        unbroken.update(*b)
    _assert_states_equal(resumed, unbroken)
    assert float(resumed.compute()) == float(unbroken.compute())


def test_checkpoint_roundtrip_list_state_metric():
    rng = np.random.RandomState(11)
    batches = [(torch.from_numpy(rng.rand(16).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 16))) for _ in range(4)]
    ap = T.BinaryAveragePrecision(device="cpu")
    for b in batches[:2]:
        ap.update(*b)
    resumed = T.BinaryAveragePrecision(device="cpu")
    resumed.load_checkpoint(pickle.loads(pickle.dumps(ap.save_checkpoint())))
    for b in batches[2:]:
        resumed.update(*b)
    unbroken = T.BinaryAveragePrecision(device="cpu")
    for b in batches:
        unbroken.update(*b)
    _assert_states_equal(resumed, unbroken)
    assert float(resumed.compute()) == float(unbroken.compute())


def test_checkpoint_roundtrip_wrapper_metric():
    vals = [1.0, 4.0, 2.0, 8.0, 5.0]
    m = T.RunningMean(window=3, device="cpu")
    for v in vals[:3]:
        m.update(v)
    ckpt = pickle.loads(pickle.dumps(m.save_checkpoint()))
    resumed = T.RunningMean(window=3, device="cpu")
    resumed.load_checkpoint(ckpt)
    assert resumed._num_vals_seen == 3
    for v in vals[3:]:
        resumed.update(v)
    unbroken = T.RunningMean(window=3, device="cpu")
    for v in vals:
        unbroken.update(v)
    assert float(resumed.compute()) == float(unbroken.compute())


def test_checkpoint_truncated_or_corrupted_raises():
    m = T.MulticlassAccuracy(num_classes=5, device="cpu")
    m.update(*_int_batches(0, n=1, size=32)[0])
    ckpt = m.save_checkpoint()
    fresh = T.MulticlassAccuracy(num_classes=5, device="cpu")
    with pytest.raises(StateRestoreError, match="truncated or corrupted"):
        fresh.load_checkpoint(b"not a checkpoint")
    truncated = {k: v for k, v in ckpt.items() if k != "metrics"}
    with pytest.raises(StateRestoreError, match="missing key.*metrics"):
        fresh.load_checkpoint(truncated)
    half_entry = pickle.loads(pickle.dumps(ckpt))
    del half_entry["metrics"][""]["state"]
    with pytest.raises(StateRestoreError, match="malformed"):
        fresh.load_checkpoint(half_entry)
    corrupt = pickle.loads(pickle.dumps(ckpt))
    name = next(iter(corrupt["metrics"][""]["state"]))
    corrupt["metrics"][""]["state"][name] = np.zeros((13, 13, 13), np.float16)
    with pytest.raises(StateRestoreError, match=name):
        fresh.load_checkpoint(corrupt)
    versioned = pickle.loads(pickle.dumps(ckpt))
    versioned["format_version"] = 99
    with pytest.raises(StateRestoreError, match="format_version"):
        fresh.load_checkpoint(versioned)
    drifted = pickle.loads(pickle.dumps(ckpt))
    drifted["metrics"][""]["fingerprint"] = "0" * 16
    with pytest.raises(StateRestoreError, match="fingerprint mismatch"):
        fresh.load_checkpoint(drifted)
    smuggled = pickle.loads(pickle.dumps(ckpt))
    smuggled["metrics"][""]["host_counters"] = {"_defaults": 1}
    with pytest.raises(StateRestoreError, match="host counter"):
        fresh.load_checkpoint(smuggled)
    assert fresh._update_count == 0
    fresh.load_checkpoint(ckpt)
    assert float(fresh.compute()) == float(m.compute())


def test_checkpoint_num_classes_mismatch_raises():
    src = T.MulticlassAccuracy(num_classes=5, device="cpu")
    src.update(*_int_batches(2, n=1, size=64)[0])
    dst = T.MulticlassAccuracy(num_classes=7, device="cpu")
    with pytest.raises(StateRestoreError, match="expected shape"):
        dst.load_checkpoint(src.save_checkpoint())
    assert dst._update_count == 0


def test_a_jax_sketch_entry_is_refused():
    """Sketch states wait for ROADMAP A9: a JAX sketch payload does not
    validate against a port metric of the same name's array state."""
    src = J.MeanMetric()
    src.update(jnp.asarray([1.0, 2.0]))
    ck = src.save_checkpoint()
    ck["metrics"][""]["state"]["mean_value"] = {"__sketch__": "KLLState", "leaves": {"items": np.zeros(4, np.float32)}}
    dst = T.MeanMetric(device="cpu")
    with pytest.raises(StateRestoreError):
        dst.load_checkpoint(ck)
    assert dst._update_count == 0


# ------------------------------------------------------------- the port's rules


def test_saved_arrays_are_copies_and_loaded_tensors_own_their_memory():
    m = T.SumMetric(device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    ck = m.save_checkpoint()
    saved = ck["metrics"][""]["state"]["sum_value"]
    m.update(torch.tensor([4.0]))  # a new state tensor; also prove no shared buffer in place
    m.sum_value.add_(100.0)
    assert float(saved) == 3.0
    fresh = T.SumMetric(device="cpu")
    fresh.load_checkpoint(ck)
    fresh.sum_value.add_(1.0)  # a write through the loaded tensor leaves the payload alone
    assert float(ck["metrics"][""]["state"]["sum_value"]) == 3.0
    assert type(ck["metrics"][""]["update_count"]) is int


def test_load_installs_on_the_metric_device_and_clears_the_mesh_flag():
    src = T.MulticlassAccuracy(num_classes=5, device="cpu")
    src.update(*_int_batches(3, n=1)[0])
    dst = T.MulticlassAccuracy(num_classes=5, device="cpu")
    dst._mesh_replicated = True
    dst.load_checkpoint(src.save_checkpoint())
    assert not dst._mesh_replicated
    assert all(t.device == dst.device for t in dst.state_tree().values())
