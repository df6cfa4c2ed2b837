# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's ``StreamingEvaluator`` on the CPU, against the JAX package's.

The counterparts of ``tests/unittests/bases/test_durability.py``:
kill-and-resume parity for the elementwise, cat and sketch regimes (the
sketch states leaf for leaf bitwise), a kill between snapshots, empty and dirty
stores, a short stream, torn writes and bitrot mid-run, the collection's
kill and resume, its never-half-applied restore and member drift, both
``on_stall`` policies, the time policy, a custom ``update_fn`` over
``sharded_update`` (a one-rank gloo group) and one seeded chaos case per
regime. Every resumed result is held against the JAX package's
uninterrupted run of the same numpy batches: int32 states bitwise, cat
states concatenated bitwise (after a fused drive a cat state is one
concatenated array, so the list's length is not part of the result),
values within rtol 1e-6, atol 1e-7. Also: the serve cycle
(``serve_open``/``step``/``skip``/``close``), ``fused=True`` equal to the
unfused drive (the plan runs eagerly on the CPU), the refused combinations of
``window_ring`` and a ``SlicedPlan`` target, and
stores crossing packages through the two runners — a run killed in one
package resumes in the other and ends equal to the other package's
uninterrupted run; the mixed store passes both packages' ``verify_store``
and ``tools/metricdoctor.py verify``.

JAX's ``test_runner_obs_counters`` waits for ROADMAP A12 (the port has no
trace spans or counters yet); the two-rank scenarios are in
``tests/test_torch_durable_ranks.py``.
"""
import subprocess
import sys
import threading
import time
import warnings
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.robustness as JR
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.robustness import store_format as jfmt
from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator, faults
from torchmetrics_tpu_torch.robustness import store_format as fmt
from torchmetrics_tpu_torch.robustness.faults import SimulatedPreemption
from torchmetrics_tpu_torch.utilities.exceptions import CheckpointStoreWarning, StallError, StateRestoreError

ROOT = Path(__file__).resolve().parent.parent
N_BATCHES = 8
VALUE_RTOL, VALUE_ATOL = 1e-6, 1e-7


def _cls_batches(seed=0, n=N_BATCHES, size=48):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 5, size).astype(np.int32), rng.randint(0, 5, size).astype(np.int32)) for _ in range(n)]


def _bin_batches(seed=1, n=N_BATCHES, size=32):
    rng = np.random.RandomState(seed)
    return [(rng.rand(size).astype(np.float32), rng.randint(0, 2, size).astype(np.int32)) for _ in range(n)]


def _sketch_batches(seed=2, n=N_BATCHES, size=2048):
    rng = np.random.RandomState(seed)
    return [(rng.randn(size).astype(np.float32),) for _ in range(n)]


def _t(batches):
    return [tuple(torch.from_numpy(x) for x in b) for b in batches]


def _j(batches):
    return [tuple(jnp.asarray(x) for x in b) for b in batches]


def _kw(pkg):
    return {} if pkg is J else {"device": "cpu"}


#: (label, metric factory(pkg), batch stream factory) for the three state regimes
REGIMES = [
    ("elementwise", lambda p: p.classification.MulticlassAccuracy(num_classes=5, **_kw(p)), _cls_batches),
    ("cat", lambda p: p.classification.BinaryAveragePrecision(**_kw(p)), _bin_batches),
    ("sketch", lambda p: p.Quantile(q=[0.25, 0.75], capacity=256, levels=14, **_kw(p)), _sketch_batches),
]


def _uninterrupted(pkg, make, batches):
    metric = make(pkg)
    for batch in (_j if pkg is J else _t)(batches):
        metric.update(*batch)
    return metric


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _leaf(value):
    if isinstance(value, list):
        return np.concatenate([np.atleast_1d(_np(v)) for v in value]) if value else None
    return _np(value)


def _assert_state_parity(got, want, label):
    """``got`` (either package) against ``want`` (either package): the same
    update count, every state bitwise (cat states concatenated)."""
    got_tree = got.state_tree(include_count=True)
    want_tree = want.state_tree(include_count=True)
    assert set(got_tree) == set(want_tree), label
    assert int(got_tree.pop("_update_count")) == int(want_tree.pop("_update_count")), label
    for key, want_val in want_tree.items():
        if hasattr(want_val, "_fields"):  # a sketch state: leaf by leaf
            for field, g, w in zip(type(want_val)._fields, got_tree[key], want_val):
                g, w = np.atleast_1d(_np(g)), np.atleast_1d(_np(w))
                assert g.dtype == w.dtype and g.shape == w.shape, (label, key, field)
                np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=f"{label}:{key}.{field}")
            continue
        g, w = _leaf(got_tree[key]), _leaf(want_val)
        assert (g is None) == (w is None), f"{label}:{key}"
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (label, key, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8), np.atleast_1d(w).view(np.uint8), err_msg=f"{label}:{key}")


def _assert_values_close(got, want, label):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), label
        for k in want:
            _assert_values_close(got[k], want[k], f"{label}:{k}")
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=VALUE_RTOL, atol=VALUE_ATOL, err_msg=label)


def _kill_at(ev, batches, kill_after):
    """Drive ``ev`` until the injected preemption after batch ``kill_after+1``."""
    with faults.inject(faults.Fault("preempt", "runner.preempt", after=kill_after, count=1)):
        with pytest.raises(SimulatedPreemption):
            ev.run(batches)


# ------------------------------------------------------- kill-and-resume parity


@pytest.mark.parametrize("label,make,make_batches", REGIMES, ids=[r[0] for r in REGIMES])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_kill_and_resume_parity(tmp_path, label, make, make_batches, fused):
    """Killed at a fixed batch and resumed from the store, each regime equals
    the JAX package's uninterrupted run bitwise (the fused drive too: its
    cat states fold back as one concatenated array)."""
    batches = make_batches()
    options = {"cat_capacity": 32 * N_BATCHES} if (fused and label == "cat") else {}
    kw = {"snapshot_every_n": 2, "fused": fused, "fused_options": options}
    store = CheckpointStore(str(tmp_path / label), keep_last=2)
    _kill_at(StreamingEvaluator(make(T), store=store, **kw), _t(batches), kill_after=4)
    assert store.last_step() == 4, "snapshot for the batch the process died on must not exist"

    resumed = StreamingEvaluator(make(T), store=store, **kw)
    result = resumed.resume(_t(batches))
    unbroken = _uninterrupted(J, make, batches)
    _assert_state_parity(resumed.metric, unbroken, label)
    _assert_values_close(result, unbroken.compute(), label)


def test_kill_between_snapshots_replays_lost_batches(tmp_path):
    batches = _cls_batches()
    make = REGIMES[0][1]
    store = CheckpointStore(str(tmp_path / "s"), keep_last=None)
    _kill_at(StreamingEvaluator(make(T), store=store, snapshot_every_n=3), _t(batches), kill_after=4)
    assert store.steps() == [3], "only the every-3 snapshot should exist"
    resumed = StreamingEvaluator(make(T), store=store, snapshot_every_n=3)
    resumed.resume(_t(batches))
    assert resumed.cursor == N_BATCHES
    _assert_state_parity(resumed.metric, _uninterrupted(J, make, batches), "replay")
    assert resumed.metric._update_count == N_BATCHES  # 3 restored + 5 replayed


def test_resume_on_empty_store_runs_from_scratch(tmp_path):
    batches = _cls_batches()
    make = REGIMES[0][1]
    store = CheckpointStore(str(tmp_path / "s"))
    result = StreamingEvaluator(make(T), store=store, snapshot_every_n=4).resume(_t(batches))
    _assert_values_close(result, _uninterrupted(J, make, batches).compute(), "empty store")
    assert store.last_step() == N_BATCHES  # a completed pass leaves a final snapshot


def test_run_refuses_dirty_store(tmp_path):
    batches = _t(_cls_batches())
    store = CheckpointStore(str(tmp_path / "s"))
    StreamingEvaluator(T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store, snapshot_every_n=4).run(batches)
    with pytest.raises(ValueError, match="use resume"):
        StreamingEvaluator(T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store).run(batches)


def test_resume_with_short_stream_raises(tmp_path):
    batches = _t(_cls_batches())
    store = CheckpointStore(str(tmp_path / "s"))
    _kill_at(StreamingEvaluator(T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store, snapshot_every_n=2), batches, 4)
    ev = StreamingEvaluator(T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store)
    with pytest.raises(ValueError, match="cannot fast-forward"):
        ev.resume(batches[:2])


def test_torn_write_mid_run_falls_back_one_snapshot(tmp_path):
    batches = _cls_batches()
    make = REGIMES[0][1]
    store = CheckpointStore(str(tmp_path / "s"), keep_last=None)
    with faults.inject(faults.Fault("fail", "store.write.torn", after=1, count=1)):
        with pytest.raises(faults.FaultInjected):
            StreamingEvaluator(make(T), store=store, snapshot_every_n=2).run(_t(batches))
    assert store.steps() == [2]
    assert fmt.temp_files(store.directory), "torn save left no temp file"
    resumed = StreamingEvaluator(make(T), store=store, snapshot_every_n=2)
    resumed.resume(_t(batches))
    _assert_state_parity(resumed.metric, _uninterrupted(J, make, batches), "torn")


def test_bitrot_mid_run_falls_back_one_snapshot(tmp_path):
    batches = _cls_batches()
    make = REGIMES[0][1]
    store = CheckpointStore(str(tmp_path / "s"), keep_last=None)
    with faults.inject(faults.Fault("corrupt", "store.payload", after=1, arg=64)):
        _kill_at(StreamingEvaluator(make(T), store=store, snapshot_every_n=2), _t(batches), 4)
    assert store.steps() == [2, 4]
    resumed = StreamingEvaluator(make(T), store=store, snapshot_every_n=2)
    with pytest.warns(CheckpointStoreWarning, match="step 4"):
        resumed.resume(_t(batches))
    _assert_state_parity(resumed.metric, _uninterrupted(J, make, batches), "bitrot")


# ----------------------------------------------------------- MetricCollection


def _bin_suite(pkg):
    cls = pkg.classification
    return pkg.MetricCollection({"ap": cls.BinaryAveragePrecision(**_kw(pkg)), "acc": cls.BinaryAccuracy(**_kw(pkg))})


def test_collection_kill_and_resume(tmp_path):
    batches = _bin_batches()
    store = CheckpointStore(str(tmp_path / "coll"), keep_last=2)
    _kill_at(StreamingEvaluator(_bin_suite(T), store=store, snapshot_every_n=2), _t(batches), kill_after=3)
    resumed = StreamingEvaluator(_bin_suite(T), store=store, snapshot_every_n=2)
    result = resumed.resume(_t(batches))
    unbroken = _bin_suite(J)
    for b in _j(batches):
        unbroken.update(*b)
    _assert_values_close(result, unbroken.compute(), "collection")
    for key in ("ap", "acc"):
        _assert_state_parity(resumed.metric[key], unbroken[key], key)


def test_collection_restore_never_half_applies():
    import copy

    make = lambda: T.MetricCollection(  # noqa: E731
        {"a_acc": T.BinaryAccuracy(device="cpu"), "b_ap": T.BinaryAveragePrecision(device="cpu")}
    )
    src = make()
    src.update(*_t(_bin_batches(n=1))[0])
    checkpoint = StreamingEvaluator(src)._checkpoint()
    fresh = make()
    ev = StreamingEvaluator(fresh)
    names = [n for n, _ in fresh.items(keep_base=True, copy_state=False)]
    bad = copy.deepcopy(checkpoint)
    del bad[names[-1]]["metrics"][""]["state"]
    with pytest.raises(StateRestoreError):
        ev._restore_checkpoint(bad)
    for _, member in fresh.items(keep_base=True, copy_state=False):
        assert member._update_count == 0
        assert not member._mesh_replicated
    ev._restore_checkpoint(checkpoint)
    for _, member in fresh.items(keep_base=True, copy_state=False):
        assert member._update_count == 1


def test_collection_member_drift_raises_named_error(tmp_path):
    batches = _t(_bin_batches(n=4))
    directory = str(tmp_path / "coll")
    make = lambda: T.MetricCollection({"ap": T.BinaryAveragePrecision(device="cpu")})  # noqa: E731
    _kill_at(StreamingEvaluator(make(), store=CheckpointStore(directory), snapshot_every_n=2), batches, kill_after=2)
    renamed = T.MetricCollection({"average_precision": T.BinaryAveragePrecision(device="cpu")})
    ev = StreamingEvaluator(renamed, store=CheckpointStore(directory))
    with pytest.raises(StateRestoreError, match="fingerprint"):
        ev.resume(batches)
    assert renamed["average_precision"]._update_count == 0


# ------------------------------------------------------------------- watchdog


class _StallOnce(T.MulticlassAccuracy):
    """Second update blocks past any reasonable deadline (while ``armed``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._calls = 0
        self.armed = True

    def update(self, *args, **kwargs):
        self._calls += 1
        if self.armed and self._calls == 2:
            time.sleep(10)
        super().update(*args, **kwargs)


def test_watchdog_raise():
    ev = StreamingEvaluator(_StallOnce(num_classes=5, device="cpu"), watchdog_timeout_s=0.3, on_stall="raise")
    t0 = time.monotonic()
    with pytest.raises(StallError, match="exceeded the 0.3s watchdog"):
        ev.run(_t(_cls_batches(n=4)))
    assert time.monotonic() - t0 < 8.0
    assert ev.cursor == 1  # the stalled batch never counted


def test_watchdog_snapshot_then_raise(tmp_path):
    batches = _cls_batches(n=4)
    store = CheckpointStore(str(tmp_path / "s"))
    ev = StreamingEvaluator(
        _StallOnce(num_classes=5, device="cpu"), store=store, watchdog_timeout_s=0.3, on_stall="snapshot_then_raise"
    )
    with pytest.raises(StallError, match="last-good state saved at step 1"):
        ev.run(_t(batches))
    fresh = _StallOnce(num_classes=5, device="cpu")  # same class: the spec fingerprint must match
    fresh.armed = False
    with warnings.catch_warnings():
        warnings.filterwarnings("error", category=CheckpointStoreWarning)  # restore, not restart
        StreamingEvaluator(fresh, store=store).resume(_t(batches))
    assert fresh._update_count == len(batches)  # 1 restored + 3 replayed
    _assert_state_parity(fresh, _uninterrupted(J, REGIMES[0][1], batches), "stall")


def test_watchdog_worker_runs_the_update_and_returns_its_errors():
    """With a deadline the update runs on the worker thread; an error there
    reaches the caller, and off the card the worker enters no CUDA device."""
    seen = []

    def update_fn(metric, batch):
        seen.append(threading.current_thread().name)
        metric.update(*batch)

    metric = T.MulticlassAccuracy(num_classes=5, device="cpu")
    ev = StreamingEvaluator(metric, update_fn=update_fn, watchdog_timeout_s=30)
    ev.run(_t(_cls_batches(n=2)))
    assert seen == ["tm-torch-runner-update"] * 2 and ev._cuda_index is None

    def failing(metric, batch):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        StreamingEvaluator(metric, update_fn=failing, watchdog_timeout_s=30).run(_t(_cls_batches(n=1)))


def test_invalid_configuration_rejected(tmp_path):
    metric = T.MulticlassAccuracy(num_classes=5, device="cpu")
    with pytest.raises(ValueError, match="snapshot_every_n"):
        StreamingEvaluator(metric, snapshot_every_n=0)
    with pytest.raises(ValueError, match="snapshot_every_s"):
        StreamingEvaluator(metric, snapshot_every_s=0.0)
    with pytest.raises(ValueError, match="on_stall"):
        StreamingEvaluator(metric, on_stall="retry")
    with pytest.raises(ValueError, match="watchdog_timeout_s"):
        StreamingEvaluator(metric, watchdog_timeout_s=0)
    with pytest.raises(ValueError, match="CheckpointStore"):
        StreamingEvaluator(metric, store=str(tmp_path))
    with pytest.raises(ValueError, match="update_fn"):
        StreamingEvaluator(metric, fused=True, update_fn=lambda m, b: None)
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointStore(str(tmp_path), keep_last=0)


def test_window_ring_and_sliced_plan_wait_for_a10():
    """A10 is ported: the runner refuses the combinations JAX's refuses, with
    JAX's messages (the drives themselves: tests/test_torch_windowing.py and
    tests/test_torch_sliced.py)."""
    from torchmetrics_tpu.robustness import StreamingEvaluator as JEvaluator
    from torchmetrics_tpu_torch.parallel import WindowRing

    metric = T.MulticlassAccuracy(num_classes=5, device="cpu")
    jmetric = J.classification.MulticlassAccuracy(num_classes=5)
    for evaluator, target in ((StreamingEvaluator, metric), (JEvaluator, jmetric)):
        with pytest.raises(ValueError, match="window_ring must be a WindowRing, got object"):
            evaluator(target, window_ring=object())
    with pytest.raises(ValueError, match="SAME metric"):
        StreamingEvaluator(metric, window_ring=WindowRing(T.MulticlassAccuracy(num_classes=5, device="cpu"), slots=2))
    with pytest.raises(ValueError, match="cannot combine with fused=True"):
        StreamingEvaluator(metric, window_ring=WindowRing(metric, slots=2), fused=True)
    plan = T.MulticlassAccuracy(num_classes=5, device="cpu").sliced(num_cells=4)
    for kwargs in ({"fused": True}, {"update_fn": lambda m, b: None}, {"window_ring": WindowRing(metric, slots=2)}):
        with pytest.raises(ValueError, match="owns its own dispatch and state layout"):
            StreamingEvaluator(plan, **kwargs)


def test_a_windowed_jax_snapshot_is_refused(tmp_path):
    """A JAX store whose payloads carry closed windows is not resumed (the
    windows would be dropped): the ladder skips it with a named warning."""
    store = CheckpointStore(str(tmp_path / "s"))
    src = T.MulticlassAccuracy(num_classes=5, device="cpu")
    ev = StreamingEvaluator(src, store=store)
    payload = ev._payload()
    payload["window"] = {"closed": []}
    store.save(payload, step=1)
    with pytest.warns(CheckpointStoreWarning, match="window"):
        fresh = StreamingEvaluator(T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store)
        fresh.resume(_t(_cls_batches(n=1)))
    assert fresh.cursor == 1 and fresh.metric._update_count == 1  # started over from batch 0


def test_time_policy_snapshots(tmp_path):
    store = CheckpointStore(str(tmp_path / "s"), keep_last=None)

    def slow_update(metric, batch):
        time.sleep(0.05)
        metric.update(*batch)

    ev = StreamingEvaluator(
        T.MulticlassAccuracy(num_classes=5, device="cpu"), store=store, snapshot_every_s=0.01, update_fn=slow_update
    )
    ev.run(_t(_cls_batches(n=6)))
    assert store.steps() == list(range(1, 7))


@pytest.fixture
def single_rank_mesh():
    """A one-rank gloo group (an in-process store, no port) and its DeviceMesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_custom_update_fn_sharded_step(tmp_path, single_rank_mesh):
    """update_fn carries the sharded regime: kill-and-resume over
    ``sharded_update`` steps equals JAX's uninterrupted sharded run."""
    import jax
    from jax.sharding import Mesh

    from torchmetrics_tpu.parallel import sharded_update as jax_sharded_update
    from torchmetrics_tpu_torch.parallel import sharded_update

    rng = np.random.RandomState(9)
    batches = [(rng.randint(0, 5, 64).astype(np.int32), rng.randint(0, 5, 64).astype(np.int32)) for _ in range(6)]
    step = lambda metric, batch: sharded_update(metric, single_rank_mesh, *batch)  # noqa: E731
    make = REGIMES[0][1]
    store = CheckpointStore(str(tmp_path / "sh"), keep_last=2)
    _kill_at(StreamingEvaluator(make(T), store=store, snapshot_every_n=2, update_fn=step), _t(batches), kill_after=3)
    resumed = StreamingEvaluator(make(T), store=store, snapshot_every_n=2, update_fn=step)
    result = resumed.resume(_t(batches))

    mesh = Mesh(np.array(jax.devices()), ("data",))
    unbroken = make(J)
    for batch in _j(batches):
        jax_sharded_update(unbroken, mesh, *batch)
    _assert_values_close(result, unbroken.compute(), "sharded step")
    _assert_state_parity(resumed.metric, unbroken, "sharded step")


# ---------------------------------------------------------------- serve cycle


def test_serve_open_step_skip_close(tmp_path):
    """The open-loop drive: a skipped batch moves the cursor (and the durable
    watermark) without touching the state; a second open restores the
    cursor and the state the first close persisted."""
    batches = _cls_batches(n=6)
    store = CheckpointStore(str(tmp_path / "serve"), keep_last=None)
    ev = StreamingEvaluator(REGIMES[0][1](T), store=store, snapshot_every_n=2)
    assert ev.serve_open() == 0
    for i, batch in enumerate(_t(batches)):
        if i == 3:
            ev.serve_skip()
        else:
            ev.serve_step(batch)
    value = ev.serve_close()
    assert ev.cursor == 6 and store.steps() == [2, 4, 6]
    want = _uninterrupted(J, REGIMES[0][1], [b for i, b in enumerate(batches) if i != 3])
    _assert_values_close(value, want.compute(), "serve")
    _assert_state_parity(ev.metric, want, "serve")

    again = StreamingEvaluator(REGIMES[0][1](T), store=store)
    assert again.serve_open() == 6
    _assert_state_parity(again.metric, want, "serve reopened")
    again.serve_step(_t(_cls_batches(seed=3, n=1))[0])
    assert again.cursor == 7
    again.serve_close()
    assert store.last_step() == 7


# ---------------------------------------------------------------- fused drive


def _headline(pkg):
    cls = pkg.classification
    return pkg.MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(num_classes=5, average="micro", **_kw(pkg)),
            "f1": cls.MulticlassF1Score(num_classes=5, average="macro", **_kw(pkg)),
            "auroc": cls.MulticlassAUROC(num_classes=5, thresholds=16, **_kw(pkg)),
        }
    )


def _prob_batches(seed=4, n=N_BATCHES, size=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((size, 5)).astype(np.float32)
        out.append(((np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32), rng.integers(0, 5, size).astype(np.int32)))
    return out


@pytest.mark.parametrize("on_stall", ["raise", "snapshot_then_raise"])
def test_fused_run_equals_unfused_bitwise(tmp_path, on_stall):
    """``run(fused=True)`` (with the watchdog: the plan is built on its worker
    thread) gives the unfused run's int32 states bitwise, and JAX's."""
    batches = _prob_batches()
    runs = {}
    for fused in (False, True):
        store = CheckpointStore(str(tmp_path / f"f{fused}"), keep_last=None)
        ev = StreamingEvaluator(_headline(T), store=store, snapshot_every_n=3, fused=fused,
                                watchdog_timeout_s=60, on_stall=on_stall)
        runs[fused] = (ev.run(_t(batches)), ev)
        assert store.steps() == [3, 6, N_BATCHES]
    unbroken = _headline(J)
    for b in _j(batches):
        unbroken.update(*b)
    for key in ("acc", "f1", "auroc"):
        _assert_state_parity(runs[True][1].metric[key], runs[False][1].metric[key], f"fused vs unfused {key}")
        _assert_state_parity(runs[True][1].metric[key], unbroken[key], f"fused vs JAX {key}")
    _assert_values_close(runs[True][0], runs[False][0], "fused values")
    _assert_values_close(runs[True][0], unbroken.compute(), "fused vs JAX values")


# ------------------------------------------------------------------ chaos case


def _chaos_trial(tmp_path, label, make, make_batches, rng):
    batches = make_batches(seed=100)
    store = CheckpointStore(str(tmp_path / f"{label}-chaos"), keep_last=3)
    kill_after = int(rng.randint(1, len(batches) - 1))
    every_n = int(rng.randint(1, 4))
    store_fault = rng.choice(["none", "torn", "bitrot"])
    injected = [faults.Fault("preempt", "runner.preempt", after=kill_after, count=1)]
    if store_fault == "torn":
        injected.append(faults.Fault("fail", "store.write.torn", after=1, count=1))
    elif store_fault == "bitrot":
        injected.append(faults.Fault("corrupt", "store.payload", after=1, count=1, arg=32))
    with faults.inject(*injected):
        with pytest.raises((SimulatedPreemption, faults.FaultInjected)):
            StreamingEvaluator(make(T), store=store, snapshot_every_n=every_n).run(_t(batches))
    resumed = StreamingEvaluator(make(T), store=store, snapshot_every_n=every_n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", CheckpointStoreWarning)  # bitrot fallback warns by design
        result = resumed.resume(_t(batches))
    unbroken = _uninterrupted(J, make, batches)
    _assert_state_parity(resumed.metric, unbroken, f"{label}-{store_fault}@{kill_after}")
    _assert_values_close(result, unbroken.compute(), label)


@pytest.mark.parametrize("label,make,make_batches", REGIMES, ids=[r[0] for r in REGIMES])
def test_chaos_one_seeded_case(tmp_path, label, make, make_batches):
    """One seeded kill/fault/resume case per regime (JAX's soak is ``slow``)."""
    _chaos_trial(tmp_path, label, make, make_batches, np.random.RandomState(zlib.crc32(label.encode())))


# --------------------------------------------------------- stores across packages


def _jax_kill_at(ev, batches, kill_after):
    from torchmetrics_tpu.robustness import faults as jfaults

    with jfaults.inject(jfaults.Fault("preempt", "runner.preempt", after=kill_after, count=1)):
        with pytest.raises(jfaults.SimulatedPreemption):
            ev.run(batches)


TARGETS = [
    ("accuracy", lambda p: p.classification.MulticlassAccuracy(num_classes=5, **_kw(p)), _cls_batches),
    ("quantile", REGIMES[2][1], _sketch_batches),
    ("suite", _headline, _prob_batches),
]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,make,make_batches", TARGETS, ids=[t[0] for t in TARGETS])
def test_store_killed_in_one_package_resumes_in_the_other(tmp_path, writer, name, make, make_batches):
    batches = make_batches()
    directory = str(tmp_path / "cross")
    if writer == "jax":
        _jax_kill_at(JR.StreamingEvaluator(make(J), store=JR.CheckpointStore(directory, keep_last=2), snapshot_every_n=2),
                     _j(batches), kill_after=4)
        resumed = StreamingEvaluator(make(T), store=CheckpointStore(directory, keep_last=2), snapshot_every_n=2)
        result = resumed.resume(_t(batches))
        reference = _uninterrupted(J, make, batches)
    else:
        _kill_at(StreamingEvaluator(make(T), store=CheckpointStore(directory, keep_last=2), snapshot_every_n=2),
                 _t(batches), kill_after=4)
        resumed = JR.StreamingEvaluator(make(J), store=JR.CheckpointStore(directory, keep_last=2), snapshot_every_n=2)
        result = resumed.resume(_j(batches))
        reference = _uninterrupted(T, make, batches)
    assert resumed.cursor == N_BATCHES
    if name == "suite":
        for key in ("acc", "f1", "auroc"):
            _assert_state_parity(resumed.metric[key], reference[key], f"{writer} {key}")
    else:
        _assert_state_parity(resumed.metric, reference, writer)
    _assert_values_close(result, reference.compute(), writer)
    # the store now holds both packages' snapshots: it verifies in each, and in metricdoctor
    assert fmt.verify_store(directory)["ok"] and jfmt.verify_store(directory)["ok"]
    assert fmt.read_manifest(directory)["snapshots"][-1]["step"] == N_BATCHES
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "metricdoctor.py"), "verify", directory],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
