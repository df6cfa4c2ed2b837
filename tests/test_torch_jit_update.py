# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's one-metric step ``make_jit_update``/``fold_jit_state`` against
the JAX package's, on the CPU (where the step runs eagerly; its CUDA-graph
capture is held on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``): the counterparts of ``tests/unittests/bases/test_parallel.py``'s
jitted-update tests, the donate half of its donate test (device telemetry,
``"_telemetry"``, waits for ROADMAP A12), and the sketch state in the step.

Budgets: the ``"mean"`` running average and float sums within ``rtol=1e-6``;
the exact AUROC value within ``rtol=1e-6`` (as the JAX test holds it
against eager); counts, CatBuffer rows and sketch leaves bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.classification as JC
import torchmetrics_tpu_torch as T
from torchmetrics_tpu.parallel import fold_jit_state as j_fold_jit_state
from torchmetrics_tpu.parallel import make_jit_update as j_make_jit_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel import fold_jit_state, make_jit_update

CPU = "cpu"


class _SumPairs(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, values):
        self.total = self.total + values.sum()

    def compute(self):
        return self.total


def test_make_jit_update_device_loop():
    metric, jmetric = T.MeanMetric(device=CPU), J.MeanMetric()
    step, state = make_jit_update(metric)
    jstep, jstate = j_make_jit_update(jmetric)
    assert sorted(state) == sorted(jstate) and state["_update_count"].dtype == torch.int32
    for i in range(4):
        state = step(state, torch.full((8,), float(i)))
        jstate = jstep(jstate, jnp.full((8,), float(i)))
    metric.load_state_tree(state)
    jmetric.load_state_tree(jstate)
    assert metric._update_count == 4 == jmetric._update_count
    assert np.allclose(float(metric.compute()), 1.5)
    np.testing.assert_allclose(float(metric.compute()), float(jmetric.compute()), rtol=1e-6)


def test_make_jit_update_mean_state_weights_by_the_carried_count():
    """A ``"mean"`` state folds count-weighted, as JAX's step folds it."""

    class _MeanState(Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")

        def update(self, x):
            self.avg = x.mean()

        def compute(self):
            return self.avg

    step, state = make_jit_update(_MeanState(device=CPU))
    for v in (1.0, 2.0, 6.0):
        state = step(state, torch.full((4,), v))
    np.testing.assert_allclose(float(state["avg"]), 3.0, rtol=1e-6)
    assert int(state["_update_count"]) == 3


def test_make_jit_update_donate_semantics():
    """donate=False: the state passed in is unchanged by the step and the
    result is a new dict. donate=True: the step returns its carry and
    updates it in place from then on, so the caller's old dict aliases the
    new state; the metric's default tensors are never written."""
    metric = _SumPairs(device=CPU)
    step, state0 = make_jit_update(metric, donate=False)
    state1 = step(state0, torch.arange(8.0))
    assert float(state0["total"]) == 0.0 and float(state1["total"]) == 28.0 and state1 is not state0
    state2 = step(state1, torch.arange(8.0, 16.0))
    assert float(state1["total"]) == 28.0 and float(state2["total"]) == float(np.arange(16.0).sum())

    metric = _SumPairs(device=CPU)
    step, state0 = make_jit_update(metric, donate=True)
    state1 = step(state0, torch.arange(8.0))
    state2 = step(state1, torch.arange(8.0, 16.0))
    assert state2 is state1 and float(state1["total"]) == float(np.arange(16.0).sum())
    assert float(metric._defaults["total"]) == 0.0
    metric.reset()
    assert float(metric.total) == 0.0


def test_make_jit_update_telemetry_waits_for_a12():
    step, state = make_jit_update(_SumPairs(device=CPU))
    state = dict(state, _telemetry=torch.zeros(3))
    with pytest.raises(NotImplementedError, match="A12"):
        step(state, torch.arange(4.0))
    with pytest.raises(NotImplementedError, match="A12"):
        fold_jit_state(_SumPairs(device=CPU), state)


def test_make_jit_update_cat_capacity_streaming_exact_auroc():
    rng = np.random.default_rng(7)
    batches = [(rng.random(16, dtype=np.float32), rng.integers(0, 2, 16).astype(np.int32)) for _ in range(4)]
    eager = T.BinaryAUROC(thresholds=None, device=CPU)
    for p, t in batches:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
    metric = T.BinaryAUROC(thresholds=None, validate_args=False, device=CPU)
    example = tuple(torch.from_numpy(a) for a in batches[0])
    step, state = make_jit_update(metric, cat_capacity=128, example_batch=example)
    jmetric = JC.BinaryAUROC(thresholds=None, validate_args=False)
    jstep, jstate = j_make_jit_update(jmetric, cat_capacity=128, example_batch=tuple(jnp.asarray(a) for a in batches[0]))
    for p, t in batches:
        state = step(state, torch.from_numpy(p), torch.from_numpy(t))
        jstate = jstep(jstate, jnp.asarray(p), jnp.asarray(t))
    for k in ("preds", "target"):
        assert np.array_equal(state[k].data.numpy(), np.asarray(jstate[k].data)) and int(state[k].count) == int(jstate[k].count)
    fold_jit_state(metric, state)
    j_fold_jit_state(jmetric, jstate)
    np.testing.assert_allclose(float(metric.compute()), float(eager.compute()), rtol=1e-6)
    np.testing.assert_allclose(float(metric.compute()), float(jmetric.compute()), rtol=1e-6)


def test_make_jit_update_cat_overflow_raises_on_fold():
    metric = T.CatMetric(device=CPU)
    step, state = make_jit_update(metric, cat_capacity=8, example_batch=(torch.arange(6.0),))
    state = step(state, torch.arange(6.0))
    state = step(state, torch.arange(6.0))  # 12 rows > capacity 8
    with pytest.raises(RuntimeError, match="overflow"):
        fold_jit_state(metric, state)


def test_make_jit_update_without_capacity_still_rejects_list_states():
    with pytest.raises(ValueError) as want:
        j_make_jit_update(J.CatMetric())
    with pytest.raises(ValueError, match="cat_capacity") as got:
        make_jit_update(T.CatMetric(device=CPU))
    assert str(got.value) == str(want.value)


def test_make_jit_update_refuses_wrappers_and_host_state_updates():
    for tm, jm in [
        (T.MinMaxMetric(T.MeanMetric(device=CPU)), J.MinMaxMetric(J.MeanMetric())),
        (T.BootStrapper(T.MeanMetric(device=CPU), num_bootstraps=2), J.BootStrapper(J.MeanMetric(), num_bootstraps=2)),
    ]:
        with pytest.raises(ValueError) as want:
            j_make_jit_update(jm)
        with pytest.raises(ValueError) as got:
            make_jit_update(tm)
        assert str(got.value) == str(want.value)


def test_make_jit_update_carries_sketch_states():
    """Bounded Spearman (two KLL sketches and a summed grid) through the step
    equals JAX's step leaf for leaf. The step ranks each batch through a
    fresh sketch of that batch, as JAX's does, so its grid is not the eager
    one; the Quantile's step equals its eager updates bitwise (see
    ``tests/test_torch_sketch.py``)."""
    rng = np.random.default_rng(8)
    batches = [(rng.standard_normal(500).astype(np.float32), rng.standard_normal(500).astype(np.float32)) for _ in range(3)]
    metric, jmetric = T.SpearmanCorrCoef(num_bins=16, device=CPU), J.SpearmanCorrCoef(num_bins=16)
    step, state = make_jit_update(metric, donate=True)
    jstep, jstate = j_make_jit_update(jmetric)
    for x, y in batches:
        state = step(state, torch.from_numpy(x), torch.from_numpy(y))
        jstate = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    fold_jit_state(metric, state)
    j_fold_jit_state(jmetric, jstate)
    for name in ("preds_sketch", "target_sketch"):
        for got, want in zip(getattr(metric, name), getattr(jmetric, name)):
            assert np.array_equal(got.numpy(), np.asarray(want)) and got.numpy().dtype == np.asarray(want).dtype
    assert np.array_equal(metric.joint.numpy(), np.asarray(jmetric.joint))
    assert metric._update_count == 3 == jmetric._update_count
    np.testing.assert_allclose(float(metric.compute()), float(jmetric.compute()), rtol=1e-5)
