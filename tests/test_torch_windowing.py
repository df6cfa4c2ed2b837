# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's windowed plane (``WindowRing``) against the JAX package's, on
the CPU: the counterparts of ``tests/unittests/bases/test_windowing.py`` on
the same seeded numpy batches.

Budgets: a query over ``k`` closed windows equals a from-scratch recompute
over exactly those windows' batches, bitwise (integer confusion counts,
cat rows, histogram counts); the port's ring equals JAX's ring driven with
the same batches: the ring payloads leaf for leaf bitwise and the query
values within ``atol=1e-6`` (float divisions in another order). The
batches feed probabilities, so the update's softmax is the identity on both
packages and cat rows compare bitwise. Ring payloads read across the
packages both ways, alone and inside ``StreamingEvaluator`` snapshots.

JAX's ``test_window_gauges_and_probe`` keeps its probe half here; the
``window.*`` gauges and rotation counter wait for ROADMAP A12.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.parallel import WindowRing as JRing
from torchmetrics_tpu.robustness import CheckpointStore as JStore
from torchmetrics_tpu.robustness import StreamingEvaluator as JEvaluator
from torchmetrics_tpu.sketch import histogram as jhist
from torchmetrics_tpu.utilities.exceptions import StateRestoreError as JStateRestoreError
from torchmetrics_tpu_torch.parallel import WindowRing
from torchmetrics_tpu_torch.robustness import CheckpointStore, StreamingEvaluator
from torchmetrics_tpu_torch.sketch import histogram as thist
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError
from torchmetrics_tpu_torch.wrappers import Running

NUM_CLASSES = 5
BATCH = 24
ATOL = 1e-6


def _jkw(**extra):
    return dict(validate_args=False, distributed_available_fn=lambda: False, **extra)


def _tkw(**extra):
    return dict(validate_args=False, distributed_available_fn=lambda: False, device="cpu", **extra)


def _hist_class(pkg):
    sk = jhist if pkg is J else thist

    class _ScoreHistogram(pkg.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            extra = {} if pkg is J else {"device": self.device}
            self.add_state("hist", sk.hist_init(bins=8, lo=0.0, hi=1.0, **extra), dist_reduce_fx="merge")

        def update(self, preds, target):
            self.hist = sk.hist_update(self.hist, preds.max(-1) if pkg is J else preds.max(-1).values)

        def compute(self):
            return self.hist.counts

    return _ScoreHistogram


JHist, THist = _hist_class(J), _hist_class(T)


def _acc(pkg):
    return (J.classification if pkg is J else T).MulticlassAccuracy(num_classes=NUM_CLASSES, **(_jkw() if pkg is J else _tkw()))


def _suite(pkg):
    kw = _jkw() if pkg is J else _tkw()
    cls = J.classification if pkg is J else T
    return pkg.MetricCollection(
        {
            "acc": cls.MulticlassAccuracy(num_classes=NUM_CLASSES, **kw),
            "auroc_exact": cls.MulticlassAUROC(num_classes=NUM_CLASSES, thresholds=None, **kw),
            "hist": (JHist if pkg is J else THist)(distributed_available_fn=lambda: False, **({} if pkg is J else {"device": "cpu"})),
        },
        compute_groups=False,
    )


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((BATCH, NUM_CLASSES))
        e = np.exp(x - x.max(-1, keepdims=True))
        out.append(((e / e.sum(-1, keepdims=True)).astype(np.float32), rng.integers(0, NUM_CLASSES, BATCH).astype(np.int32)))
    return out


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _drive(target, ring, batches, conv, start=0):
    for i, b in enumerate(batches):
        target.update(*conv(b))
        ring.observe(start + i + 1)


def _assert_payloads_equal(got, want, path="ring"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for key in want:
            _assert_payloads_equal(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_payloads_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), path


def _values_equal(got, want, exact=True):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _values_equal(got[key], want[key], exact)
        return
    g, w = np.asarray(got), np.asarray(want)
    if exact:
        assert np.array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


# --------------------------------------------------------------- query fold


def test_windowed_query_equals_recompute_and_jax():
    """query(last=k) == a fresh metric over exactly those windows' batches,
    for every k — bitwise; the ring == JAX's ring (payload bitwise, values
    within ATOL)."""
    batches = _batches(10, seed=0)
    acc, jacc = _acc(T), _acc(J)
    ring, jring = WindowRing(acc, slots=5, every_n=2), JRing(jacc, slots=5, every_n=2)
    _drive(acc, ring, batches, _t)
    _drive(jacc, jring, batches, _j)
    assert len(ring) == 5 and ring.open_batches == 0
    _assert_payloads_equal(ring.payload(), jring.payload())
    for k in (1, 2, 5):
        ref = _acc(T)
        for b in batches[len(batches) - 2 * k :]:
            ref.update(*_t(b))
        assert torch.equal(ring.query(last=k), ref.compute()), k
        _values_equal(ring.query(last=k), jring.query(last=k), exact=False)


def test_windowed_collection_with_cat_and_sketch_states():
    """The fold supports elementwise sums, cat list concatenation and sketch
    merge in one collection; the ring round-trips its payload."""
    batches = _batches(6, seed=1)
    col = _suite(T)
    ring = WindowRing(col, slots=3, every_n=2)
    _drive(col, ring, batches, _t)
    ref = _suite(T)
    for b in batches[2:6]:
        ref.update(*_t(b))
    want = ref.compute()
    _values_equal({k: v for k, v in ring.query(last=2).items()}, want)
    restored = WindowRing(_suite(T), slots=3, every_n=2)
    restored.restore(ring.payload())
    _values_equal(restored.query(last=2), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_window_payload_reads_across_packages(direction):
    """A ring saved by either package (elementwise, cat and sketch states)
    restores in the other, and answers the same queries."""
    batches = _batches(6, seed=2)
    col, jcol = _suite(T), _suite(J)
    ring, jring = WindowRing(col, slots=3, every_n=2), JRing(jcol, slots=3, every_n=2)
    _drive(col, ring, batches, _t)
    _drive(jcol, jring, batches, _j)
    _assert_payloads_equal(ring.payload(), jring.payload())
    if direction == "jax_to_port":
        restored = WindowRing(_suite(T), slots=3, every_n=2)
        restored.restore(jring.payload())
        _values_equal(restored.query(last=3), ring.query(last=3))
    else:
        restored = JRing(_suite(J), slots=3, every_n=2)
        restored.restore(ring.payload())
        _values_equal(restored.query(last=3), jring.query(last=3))
    _assert_payloads_equal(restored.payload(), ring.payload())


def test_windowed_include_open_and_expiry():
    batches = _batches(7, seed=2)
    acc = _acc(T)
    ring = WindowRing(acc, slots=2, every_n=2)
    _drive(acc, ring, batches, _t)
    # windows: [0-1],[2-3],[4-5] closed; slots=2 keeps [2-3],[4-5]; open=[6]
    assert len(ring) == 2 and ring.open_batches == 1
    ref = _acc(T)
    for b in batches[2:]:
        ref.update(*_t(b))
    assert torch.equal(ring.query(include_open=True), ref.compute())
    with pytest.raises(ValueError, match="no closed windows"):
        WindowRing(_acc(T), slots=2).query()


def test_windowed_query_leaves_target_untouched():
    batches = _batches(3, seed=3)
    acc = _acc(T)
    ring = WindowRing(acc, slots=2, every_n=1)
    _drive(acc, ring, batches, _t)
    before = {k: v.clone() for k, v in acc.state_tree().items()}
    ring.query(last=2)
    for k, v in acc.state_tree().items():
        assert torch.equal(before[k], v)


def _mean_state_class(pkg):
    class _MeanState(pkg.Metric):
        full_state_update = False

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("avg", jnp.zeros(()) if pkg is J else torch.zeros(()), dist_reduce_fx="mean")

        def update(self, values):
            self.avg = values.mean()

        def compute(self):
            return self.avg

    return _MeanState


def test_windowed_empty_window_does_not_dilute_mean_states():
    """An EMPTY closed window folds with its TRUE weight 0, so 'mean' states
    keep the recompute parity; the all-empty fold stays finite."""
    metric = _mean_state_class(T)(distributed_available_fn=lambda: False, device="cpu")
    ring = WindowRing(metric, slots=3, every_n=1)
    metric.update(torch.tensor([2.0, 4.0]))
    ring.observe(1)  # window 1: mean 3.0
    ring.rotate(2)  # window 2: EMPTY (no traffic)
    assert len(ring) == 2
    assert float(ring.query(last=2)) == 3.0
    ring.rotate(3)
    assert np.isfinite(float(ring.query(last=2)))


def test_runner_rejected_checkpoint_leaves_ring_untouched():
    """A snapshot whose window payload validates but whose metric checkpoint
    is REJECTED must not half-apply: the live ring keeps its windows."""
    batches = _batches(4, seed=10)
    acc = _acc(T)
    ring = WindowRing(acc, slots=2, every_n=1)
    acc.update(*_t(batches[0]))
    ring.observe(1)
    good_window = ring.payload()
    prior_len = len(ring)
    ev = StreamingEvaluator(acc, window_ring=ring)
    bad_payload = {"payload_version": 1, "cursor": 3, "kind": "metric", "checkpoint": {"not": "a checkpoint"}, "window": good_window}
    with pytest.raises(Exception):
        ev._validate_payload(bad_payload)
    assert len(ring) == prior_len


# ------------------------------------------------------- Running bridge


def test_tumbling_ring_matches_running_wrapper():
    """A tumbling every_n=1 ring of N slots == Running(metric, window=N) on
    the overlap (integer-valued floats: bitwise in any association order)."""
    rng = np.random.default_rng(4)
    window = 4
    values = [torch.from_numpy(rng.integers(-50, 50, 8).astype(np.float32)) for _ in range(9)]
    base = T.SumMetric(distributed_available_fn=lambda: False, device="cpu")
    ring = WindowRing(base, slots=window, every_n=1)
    wrapped = Running(T.SumMetric(distributed_available_fn=lambda: False, device="cpu"), window=window)
    for i, x in enumerate(values):
        base.update(x)
        ring.observe(i + 1)
        wrapped.update(x)
        if i + 1 >= window:
            assert torch.equal(ring.query(last=window), wrapped.compute()), i


# --------------------------------------------------------- runner plumbing


def test_runner_drives_rotation_and_snapshot_payload(tmp_path):
    batches = [_t(b) for b in _batches(8, seed=5)]
    acc = _acc(T)
    ring = WindowRing(acc, slots=3, every_n=2)
    store = CheckpointStore(os.path.join(str(tmp_path), "s"), keep_last=2)
    StreamingEvaluator(acc, store=store, snapshot_every_n=4, window_ring=ring).run(batches)
    assert len(ring) == 3  # 4 closed, the oldest expired
    _, payload = store.latest()
    assert payload["window"]["ring"]


def test_runner_windowed_kill_and_resume_parity(tmp_path):
    """Killed after batch 6 (a poisoned batch), resumed in a fresh metric
    and ring: the ring's queries and the open state bitwise the
    uninterrupted run's."""
    batches = [_t(b) for b in _batches(9, seed=6)]

    def build():
        m = _acc(T)
        return m, WindowRing(m, slots=3, every_n=2)

    ref_metric, ref_ring = build()
    StreamingEvaluator(ref_metric, window_ring=ref_ring).run(batches)
    victim, victim_ring = build()
    store_dir = os.path.join(str(tmp_path), "s")
    with pytest.raises(Exception):
        StreamingEvaluator(victim, store=CheckpointStore(store_dir, keep_last=3), snapshot_every_n=2, window_ring=victim_ring).run(
            batches[:6] + [None]
        )
    resumed, resumed_ring = build()
    StreamingEvaluator(resumed, store=CheckpointStore(store_dir, keep_last=3), window_ring=resumed_ring).resume(batches)
    assert len(resumed_ring) == len(ref_ring)
    for k in (1, 3):
        assert torch.equal(resumed_ring.query(last=k), ref_ring.query(last=k)), k
    for name in ref_metric._defaults:
        assert torch.equal(getattr(ref_metric, name), getattr(resumed, name))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_runner_windowed_store_crosses_packages(tmp_path, direction):
    """A windowed run killed in one package resumes in the other: the
    snapshots' ``window`` payloads restore there, and the resumed ring's
    queries equal the other package's uninterrupted ring's."""
    batches = _batches(9, seed=15)
    jb, tb = [_j(b) for b in batches], [_t(b) for b in batches]
    store_dir = os.path.join(str(tmp_path), "s")
    victim_pkg = J if direction == "jax_to_port" else T
    victim = _acc(victim_pkg)
    ring_cls, store_cls, ev_cls = (JRing, JStore, JEvaluator) if victim_pkg is J else (WindowRing, CheckpointStore, StreamingEvaluator)
    with pytest.raises(Exception):
        ev_cls(victim, store=store_cls(store_dir, keep_last=3), snapshot_every_n=2,
               window_ring=ring_cls(victim, slots=3, every_n=2)).run((jb if victim_pkg is J else tb)[:6] + [None])
    if victim_pkg is J:
        resumed = _acc(T)
        ring = WindowRing(resumed, slots=3, every_n=2)
        ev = StreamingEvaluator(resumed, store=CheckpointStore(store_dir, keep_last=3), window_ring=ring)
        assert ev.store.latest(validate=ev._validate_payload)[0] == 6 and len(ring) == 3  # JAX's snapshot, ring included
        ev.resume(tb)
        ref = _acc(J)
        ref_ring = JRing(ref, slots=3, every_n=2)
        JEvaluator(ref, window_ring=ref_ring).run(jb)
    else:
        resumed = _acc(J)
        ring = JRing(resumed, slots=3, every_n=2)
        ev = JEvaluator(resumed, store=JStore(store_dir, keep_last=3), window_ring=ring)
        assert ev.store.latest(validate=ev._validate_payload)[0] == 6 and len(ring) == 3  # the port's snapshot, ring included
        ev.resume(jb)
        ref = _acc(T)
        ref_ring = WindowRing(ref, slots=3, every_n=2)
        StreamingEvaluator(ref, window_ring=ref_ring).run(tb)
    _assert_payloads_equal(ring.payload(), ref_ring.payload())
    for k in (1, 3):
        _values_equal(ring.query(last=k), ref_ring.query(last=k), exact=False)


def test_runner_windowed_restore_refuses_unwindowed_snapshot(tmp_path):
    batches = [_t(b) for b in _batches(4, seed=7)]
    store = CheckpointStore(os.path.join(str(tmp_path), "s"), keep_last=2)
    StreamingEvaluator(_acc(T), store=store, snapshot_every_n=2).run(batches)
    windowed = _acc(T)
    ev = StreamingEvaluator(windowed, store=CheckpointStore(os.path.join(str(tmp_path), "s"), keep_last=2),
                            window_ring=WindowRing(windowed, slots=2, every_n=2))
    # every snapshot lacks the ring: the recovery ladder exhausts and the run restarts from batch 0
    with pytest.warns(Warning):
        ev.resume(batches)
    assert ev.cursor == len(batches)


def test_runner_unwindowed_resume_refuses_windowed_snapshot(tmp_path):
    batches = [_t(b) for b in _batches(4, seed=11)]
    acc = _acc(T)
    store = CheckpointStore(os.path.join(str(tmp_path), "s"), keep_last=2)
    StreamingEvaluator(acc, store=store, snapshot_every_n=2, window_ring=WindowRing(acc, slots=2, every_n=2)).run(batches)
    ev = StreamingEvaluator(_acc(T), store=CheckpointStore(os.path.join(str(tmp_path), "s"), keep_last=2))
    with pytest.warns(Warning):
        ev.resume(batches)
    assert ev.cursor == len(batches)


def test_runner_rejects_bad_ring_combinations():
    """Each refusal of JAX's, with JAX's message."""
    for pkg, ring_cls, ev_cls in ((T, WindowRing, StreamingEvaluator), (J, JRing, JEvaluator)):
        acc = _acc(pkg)
        with pytest.raises(ValueError, match="SAME metric"):
            ev_cls(acc, window_ring=ring_cls(_acc(pkg), slots=2, every_n=1))
        with pytest.raises(ValueError, match="fused"):
            ev_cls(acc, window_ring=ring_cls(acc, slots=2, every_n=1), fused=True)
        with pytest.raises(ValueError, match="WindowRing"):
            ev_cls(acc, window_ring=object())
    for bad, match in ((dict(slots=0), "slots"), (dict(slots=2, every_n=0), "every_n"), (dict(slots=2, every_s=0.0), "every_s")):
        with pytest.raises(ValueError, match=match) as t_err:
            WindowRing(_acc(T), **bad)
        with pytest.raises(ValueError, match=match) as j_err:
            JRing(_acc(J), **bad)
        assert str(t_err.value) == str(j_err.value)


# ----------------------------------------------------------- payload + probe


def test_window_payload_negatives():
    """Each refusal of JAX's (version, slots, oversized, corrupt), the same
    message on both packages; a failed restore touches nothing."""
    acc, jacc = _acc(T), _acc(J)
    ring, jring = WindowRing(acc, slots=2, every_n=1), JRing(jacc, slots=2, every_n=1)
    batch = _batches(1, seed=8)[0]
    acc.update(*_t(batch))
    jacc.update(*_j(batch))
    ring.observe(1)
    jring.observe(1)
    payload = ring.payload()
    oversized = dict(payload, ring=[payload["ring"][0]] * 5)
    corrupt = dict(payload, ring=[dict(payload["ring"][0], members={"MulticlassAccuracy": {"tp": np.zeros((2, 2)), "_update_count": 1}})])
    for bad, match in ((dict(payload, window_payload_version=99), "version"), (oversized, "at most slots"), (corrupt, None)):
        with pytest.raises(StateRestoreError, match=match) as t_err:
            ring.restore(bad)
        with pytest.raises(JStateRestoreError, match=match):
            jring.restore(bad)
        if match:
            assert match in str(t_err.value)
    with pytest.raises(StateRestoreError, match="slots") as t_err:
        WindowRing(_acc(T), slots=3).restore(payload)
    with pytest.raises(JStateRestoreError, match="slots") as j_err:
        JRing(_acc(J), slots=3).restore(payload)
    assert str(t_err.value) == str(j_err.value)
    assert len(ring) == 1  # failed restores touched nothing


def test_window_payload_cache_tracks_rotations():
    """The encoded closed ring is cached per rotation, and a rotation
    invalidates it."""
    batches = _batches(3, seed=12)
    acc = _acc(T)
    ring = WindowRing(acc, slots=3, every_n=1)
    acc.update(*_t(batches[0]))
    ring.observe(1)
    p1, p2 = ring.payload(), ring.payload()
    assert p1["ring"][0] is p2["ring"][0]
    acc.update(*_t(batches[1]))
    ring.observe(2)
    p3 = ring.payload()
    assert len(p3["ring"]) == 2
    np.testing.assert_array_equal(p3["ring"][0]["members"]["MulticlassAccuracy"]["tp"], p1["ring"][0]["members"]["MulticlassAccuracy"]["tp"])
    ring2 = WindowRing(_acc(T), slots=3, every_n=1)
    ring2.restore(p3)
    assert len(ring2) == 2


def test_window_probe():
    batches = _batches(2, seed=9)
    acc = _acc(T)
    ring = WindowRing(acc, slots=2, every_n=1)
    for i, b in enumerate(batches):
        acc.update(*_t(b))
        ring.observe(i + 1)
    probe = ring.probe()
    assert probe["window.MulticlassAccuracy.slots_live"] == 2.0
    assert probe["window.MulticlassAccuracy.open_batches"] == 0.0
    assert probe["window.MulticlassAccuracy.age_s"] >= 0.0
