# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's CatBuffer, layout probe, DeviceFeed and ``_is_concrete`` on the CPU.

CatBuffer appends and merges go through both packages on the same seeded
numpy rows: ``data``, ``count`` and ``overflowed`` are held bitwise,
including appends that straddle the capacity (JAX drops the rows past it
with ``mode="drop"``; the port routes them to a spare row). The layout
probe must report JAX's ``(elem_shape, dtype)`` for the exact metrics.
DeviceFeed keeps JAX's order and failure contract; here it stages on the
CPU (its CUDA path runs in ``tests/test_torch_kernels_cuda.py``).
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.parallel import cat_buffer as jcb
from torchmetrics_tpu_torch.parallel import cat_buffer as tcb
from torchmetrics_tpu_torch.parallel import DeviceFeed
from torchmetrics_tpu_torch.utilities.checks import _is_concrete

CAP = 10


def _pair(elem, dtype, seed=0):
    """An empty JAX buffer and an empty port buffer of capacity CAP."""
    return jcb.cat_buffer_init(CAP, elem, jnp.dtype(dtype)), tcb.cat_buffer_init(CAP, elem, getattr(torch, dtype))


def _rows(rng, n, elem, dtype):
    if dtype == "int32":
        return rng.integers(-5, 5, (n, *elem)).astype(np.int32)
    return rng.standard_normal((n, *elem)).astype(np.float32)


def _assert_same(jbuf, tbuf):
    np.testing.assert_array_equal(tbuf.data.numpy(), np.asarray(jbuf.data))
    assert tbuf.data.dtype == getattr(torch, str(np.asarray(jbuf.data).dtype))
    assert tbuf.count.dtype == torch.int32 and tbuf.overflowed.dtype == torch.bool
    assert int(tbuf.count) == int(jbuf.count)
    assert bool(tbuf.overflowed) == bool(jbuf.overflowed)


@pytest.mark.parametrize("elem,dtype", [((), "float32"), ((3,), "float32"), ((2, 2), "int32")])
@pytest.mark.parametrize(
    "sizes",
    [[3, 4], [3, 4, 3], [6, 7], [12], [0, 10, 1], [4, 4, 4, 4]],
    ids=["fits", "to_capacity", "straddles", "past_at_once", "empty_then_full", "straddles_then_past"],
)
def test_append_bitwise_against_jax(elem, dtype, sizes):
    rng = np.random.default_rng(len(sizes) * 7 + len(elem))
    jbuf, tbuf = _pair(elem, dtype)
    for n in sizes:
        rows = _rows(rng, n, elem, dtype)
        before = tcb._copy(tbuf)
        jbuf = jcb.cat_buffer_append(jbuf, jnp.asarray(rows))
        new = tcb.cat_buffer_append(tbuf, torch.from_numpy(rows))
        _assert_same(before, tbuf)  # pure: the argument is left alone
        tbuf = new
        _assert_same(jbuf, tbuf)


def test_append_single_row_and_numpy_rows():
    jbuf, tbuf = _pair((3,), "float32")
    row = np.arange(3, dtype=np.float32)
    jbuf = jcb.cat_buffer_append(jbuf, jnp.asarray(row))
    tbuf = tcb.cat_buffer_append(tbuf, row)
    _assert_same(jbuf, tbuf)


@pytest.mark.parametrize(
    "na,nb,cap_b",
    [(3, 4, 6), (6, 6, 8), (0, 5, 5), (10, 1, 4), (2, 0, 3)],
    ids=["fits", "straddles", "empty_a", "full_a", "empty_b"],
)
@pytest.mark.parametrize("b_overflowed", [False, True])
def test_merge_bitwise_against_jax(na, nb, cap_b, b_overflowed):
    rng = np.random.default_rng(na * 10 + nb)
    ja, ta = _pair((2,), "float32")
    jb, tb = jcb.cat_buffer_init(cap_b, (2,)), tcb.cat_buffer_init(cap_b, (2,))
    for (j, t), n in (((ja, ta), na), ((jb, tb), nb)):
        rows = _rows(rng, n, (2,), "float32")
        if j is ja:
            ja, ta = jcb.cat_buffer_append(j, jnp.asarray(rows)), tcb.cat_buffer_append(t, torch.from_numpy(rows))
        else:
            jb, tb = jcb.cat_buffer_append(j, jnp.asarray(rows)), tcb.cat_buffer_append(t, torch.from_numpy(rows))
    if b_overflowed:
        extra = _rows(rng, cap_b + 1, (2,), "float32")
        jb, tb = jcb.cat_buffer_append(jb, jnp.asarray(extra)), tcb.cat_buffer_append(tb, torch.from_numpy(extra))
        assert bool(tb.overflowed)
    _assert_same(jcb.cat_buffer_merge(ja, jb), tcb.cat_buffer_merge(ta, tb))


def test_values_and_overflow():
    rng = np.random.default_rng(3)
    buf = tcb.cat_buffer_init(CAP, (2,))
    rows = _rows(rng, 4, (2,), "float32")
    buf = tcb.cat_buffer_append(buf, torch.from_numpy(rows))
    np.testing.assert_array_equal(tcb.cat_buffer_values(buf).numpy(), rows)
    buf = tcb.cat_buffer_append(buf, torch.from_numpy(_rows(rng, 7, (2,), "float32")))
    with pytest.raises(RuntimeError, match="overflowed its capacity of 10 rows"):
        tcb.cat_buffer_values(buf)


def test_buffer_without_spare_row_is_refused():
    bare = tcb.CatBuffer(torch.zeros(CAP, 2), torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.bool))
    with pytest.raises(ValueError, match="no spare row"):
        tcb.cat_buffer_append(bare, torch.ones(1, 2))


def _exact_pairs():
    c, lab = 4, 3
    return [
        ("binary_auroc", J.classification.BinaryAUROC(), T.BinaryAUROC(device="cpu"), "binary"),
        ("multiclass_auroc", J.classification.MulticlassAUROC(num_classes=c), T.MulticlassAUROC(num_classes=c, device="cpu"), "multiclass"),
        (
            "multiclass_ap",
            J.classification.MulticlassAveragePrecision(num_classes=c),
            T.MulticlassAveragePrecision(num_classes=c, device="cpu"),
            "multiclass",
        ),
        ("multilabel_auroc", J.classification.MultilabelAUROC(num_labels=lab), T.MultilabelAUROC(num_labels=lab, device="cpu"), "multilabel"),
        (
            "multilabel_prc",
            J.classification.MultilabelPrecisionRecallCurve(num_labels=lab),
            T.MultilabelPrecisionRecallCurve(num_labels=lab, device="cpu"),
            "multilabel",
        ),
    ]


def _example(task, rng, n=20):
    if task == "binary":
        return rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)
    if task == "multiclass":
        p = rng.random((n, 4)).astype(np.float32)
        return (p / p.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, 4, n).astype(np.int32)
    return rng.random((n, 3)).astype(np.float32), rng.integers(0, 2, (n, 3)).astype(np.int32)


@pytest.mark.parametrize("idx", range(5), ids=[p[0] for p in _exact_pairs()])
def test_infer_cat_layout_matches_jax(idx):
    _, jm, tm, task = _exact_pairs()[idx]
    rng = np.random.default_rng(idx)
    example = _example(task, rng)
    want = jcb.infer_cat_layout(jm, tuple(jnp.asarray(x) for x in example))
    # a metric mid-stream: the probe must leave its state, count and cache as they were
    seen = _example(task, rng, n=7)
    tm.update(*(torch.from_numpy(x) for x in seen))
    before = {k: [v.clone() for v in vs] for k, vs in tm.state_tree().items()}
    got = tcb.infer_cat_layout(tm, tuple(torch.from_numpy(x) for x in example))
    assert sorted(got) == sorted(want)
    for key, (elem, dtype) in want.items():
        assert got[key][0] == tuple(elem)
        assert str(got[key][1]).removeprefix("torch.") == str(np.dtype(dtype))
    assert tm._update_count == 1
    for key, vs in tm.state_tree().items():
        assert len(vs) == len(before[key]) and all(torch.equal(a, b) for a, b in zip(vs, before[key]))


def test_infer_cat_layout_refuses_a_metric_that_appends_nothing():
    class _Quiet(T.Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("rows", [], dist_reduce_fx="cat")

        def update(self, x):
            pass

        def compute(self):
            return None

    with pytest.raises(ValueError, match="received no append"):
        tcb.infer_cat_layout(_Quiet(), (torch.zeros(3),))


# ------------------------------------------------------------------ DeviceFeed


def test_device_feed_order_and_values():
    batches = [(np.full((4,), i, np.float32), np.full((4,), -i, np.float32)) for i in range(7)]
    out = list(DeviceFeed(batches, device="cpu", depth=2))
    assert len(out) == 7
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
        assert bool((a == i).all()) and bool((b == -i).all())
    batches[0][0][:] = 99  # staged batches hold copies, not the caller's arrays
    assert bool((out[0][0] == 0).all())


def test_device_feed_keeps_containers():
    batch = {"p": np.ones(2, np.float32), "rest": [np.zeros(1, np.int32), 3]}
    (out,) = list(DeviceFeed([batch], device="cpu"))
    assert isinstance(out, dict) and isinstance(out["rest"], list) and out["rest"][1] == 3
    assert out["p"].dtype == torch.float32 and out["rest"][0].dtype == torch.int32


def test_device_feed_depth_one_and_empty():
    assert list(DeviceFeed([], device="cpu", depth=1)) == []
    out = list(DeviceFeed([np.arange(3)], device="cpu", depth=1))
    assert len(out) == 1 and torch.equal(out[0], torch.arange(3))
    with pytest.raises(ValueError, match="depth"):
        DeviceFeed([], depth=0)


def test_device_feed_producer_exception_at_its_position():
    def gen():
        yield (np.arange(3, dtype=np.float32),)
        yield (np.arange(3, dtype=np.float32) + 1,)
        raise RuntimeError("decode exploded")

    consumed = []
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="decode exploded"):
        for batch in DeviceFeed(gen(), device="cpu", depth=2):
            consumed.append(batch)
    assert len(consumed) == 2  # the batches staged before the failure
    assert time.monotonic() - t0 < 5.0  # prompt, not a stall


def test_device_feed_early_abandon_stops_producer():
    batches = [(np.full((4,), i, np.float32),) for i in range(50)]
    for i, _batch in enumerate(DeviceFeed(batches, device="cpu", depth=1)):
        if i == 1:
            break
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if not any(t.name == "tm-tpu-device-feed" and t.is_alive() for t in threading.enumerate()):
            return
        time.sleep(0.05)
    raise AssertionError("staging thread still alive after the consumer abandoned iteration")


def test_device_feed_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(DeviceFeed([np.zeros(2)])))


# --------------------------------------------------------------- _is_concrete


@pytest.mark.parametrize(
    "value", [torch.zeros(3), torch.tensor(1), np.zeros(2), 3.0, None], ids=["tensor", "scalar", "numpy", "float", "none"]
)
def test_is_concrete_when_eager(value):
    assert _is_concrete(value) is True


def test_validation_still_runs_eagerly():
    metric = T.MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(RuntimeError, match="outside the expected range"):
        metric.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 7]))
    curve = T.BinaryAUROC(thresholds=8, device="cpu")
    with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
        curve.update(torch.tensor([0.1, 0.9]), torch.tensor([0, 2]))
