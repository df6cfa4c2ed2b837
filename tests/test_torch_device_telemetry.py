# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's device telemetry (``obs/device.py``) against the JAX package's,
on the CPU: the counterpart of ``tests/unittests/obs/test_device_telemetry.py``
without its timing ratchet (the overhead is measured on the card, in
``chip_smoke.py``'s obs phase).

- **Value parity**: states are bitwise equal with telemetry on and off, for
  ``make_jit_update``, ``sharded_update`` (a one-rank gloo mesh) and the
  fused plan.
- **Exact health counts**: a stream with injected NaN/Inf elements drains
  gauges equal to numpy's counts, and to JAX's gauges for the same stream:
  counts, element totals and the finite min/max/absmax (float32 values of
  the inputs themselves) exactly; the histogram's p50/p95/p99 within
  ``rtol=1e-6`` (its counts are integers in both packages, and each
  quantile is one float32 interpolation of them, whose rounding may differ).
- **Build-time flag**: the flag is read when the step is built, and the
  build keys (the step's capture key, the fused plan's fingerprint) change
  when it flips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu import obs as jobs
from torchmetrics_tpu.obs import device as jdevice
from torchmetrics_tpu.parallel import fold_jit_state as j_fold, make_jit_update as j_make, sharded_update as j_sharded
from torchmetrics_tpu_torch import obs as tobs
from torchmetrics_tpu_torch.obs import device as tdevice
from torchmetrics_tpu_torch.parallel import FusedCollectionPlan, fold_jit_state, make_jit_update, sharded_update

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean_obs():
    for dev, obs in ((jdevice, jobs), (tdevice, tobs)):
        dev.disable()
        obs.disable()
        obs.clear()
    yield
    for dev, obs in ((jdevice, jobs), (tdevice, tobs)):
        dev.disable()
        obs.disable()
        obs.clear()


def _stream(seed=2, n=5, size=32):
    """Batches with i+1 NaN elements each and a +/-Inf on every other one;
    returns the batches and numpy's NaN and Inf counts."""
    rng = np.random.RandomState(seed)
    batches, n_nan, n_inf = [], 0, 0
    for i in range(n):
        batch = rng.randn(size).astype(np.float32)
        batch[: i + 1] = np.nan
        n_nan += i + 1
        if i % 2 == 0:
            batch[-1] = np.inf if i % 4 == 0 else -np.inf
            n_inf += 1
        batches.append(batch)
    return batches, n_nan, n_inf


def _jax_gauges(batches, histogram=None):
    jdevice.enable(histogram=histogram)
    metric = J.SumMetric(distributed_available_fn=lambda: False)
    step, state = j_make(metric)
    for batch in batches:
        state = step(state, jnp.asarray(batch))
    j_fold(metric, state)
    jobs.counter_clear()
    metric.compute()
    jdevice.disable()
    return jobs.snapshot()["gauges"]


def _port_gauges(batches, histogram=None):
    tdevice.enable(histogram=histogram)
    metric = T.SumMetric(**CPU)
    step, state = make_jit_update(metric)
    for batch in batches:
        state = step(state, torch.from_numpy(batch))
    fold_jit_state(metric, state)
    tobs.counter_clear()
    metric.compute()
    tdevice.disable()
    return tobs.snapshot()["gauges"]


@pytest.mark.parametrize("histogram", [None, (16, -4.0, 4.0)])
def test_drained_gauges_equal_numpy_counts_and_jax(histogram):
    batches, n_nan, n_inf = _stream()
    got, want = _port_gauges(batches, histogram), _jax_gauges(batches, histogram)
    assert got["device.SumMetric.nan_count"] == n_nan and got["device.SumMetric.inf_count"] == n_inf
    assert got["device.SumMetric.updates"] == len(batches)
    assert sorted(got) == sorted(want)
    for name in want:
        if ".hist.p" in name:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
        else:
            assert got[name] == want[name], name


def test_jit_update_value_parity_bitwise():
    rng = np.random.RandomState(0)
    batches = [(rng.randn(64, 8).astype(np.float32), rng.randint(0, 8, 64).astype(np.int32)) for _ in range(4)]

    def run():
        metric = T.classification.MulticlassAccuracy(num_classes=8, **CPU)
        step, state = make_jit_update(metric)
        for preds, target in batches:
            state = step(state, torch.from_numpy(preds), torch.from_numpy(target))
        fold_jit_state(metric, state)
        return metric

    plain = run()
    tdevice.enable(histogram=(32, -5.0, 5.0))
    traced = run()
    assert plain._device_telemetry is None and traced._device_telemetry is not None
    assert torch.equal(plain.compute(), traced.compute())
    for key, value in plain.state_tree(include_count=True).items():
        other = traced.state_tree(include_count=True)[key]
        assert value == other if isinstance(value, int) else torch.equal(value, other), key


def test_fused_plan_telemetry_parity_and_drain():
    """One telemetry carry for the collection, accumulated into every
    leader at fold-back and drained at the collection's compute."""
    batches, n_nan, n_inf = _stream(n=3)

    def run():
        coll = T.MetricCollection({"sum": T.SumMetric(**CPU), "max": T.MaxMetric(**CPU)})
        plan = FusedCollectionPlan(coll)
        for batch in batches:
            plan.update(torch.from_numpy(batch))
        plan.fold_back()
        return coll, plan

    plain, plain_plan = run()
    tdevice.enable()
    traced, traced_plan = run()
    tdevice.disable()
    assert "_telemetry" not in plain_plan.state and "_telemetry" in traced_plan.state
    assert plain_plan._fingerprint() != traced_plan._fingerprint()
    out_p, out_t = plain.compute(), traced.compute()
    assert all(torch.equal(out_p[k], out_t[k]) or bool(torch.isnan(out_p[k])) for k in out_p)
    gauges = tobs.snapshot()["gauges"]
    for name in ("SumMetric", "MaxMetric"):
        assert gauges[f"device.{name}.nan_count"] == n_nan and gauges[f"device.{name}.inf_count"] == n_inf
        assert gauges[f"device.{name}.updates"] == len(batches)


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


def test_sharded_update_telemetry_parity_and_counts(single_rank_mesh):
    """The ranks' telemetry reduced over the mesh with the states' own
    collectives: states bitwise equal with it on and off, drained counts
    equal JAX's sharded run over its one-device mesh."""
    batches, n_nan, n_inf = _stream(n=3, size=8)

    def run():
        metric = T.MeanMetric(nan_strategy="ignore", **CPU)
        for batch in batches:
            sharded_update(metric, single_rank_mesh, torch.from_numpy(batch))
        return metric

    plain = run()
    tdevice.enable()
    traced = run()
    for key, value in plain.state_tree(include_count=True).items():
        other = traced.state_tree(include_count=True)[key]
        np.testing.assert_array_equal(np.asarray(other), np.asarray(value), err_msg=key)  # an Inf makes the mean NaN
    tobs.counter_clear()
    traced.compute()
    got = tobs.snapshot()["gauges"]

    jdevice.enable()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jm = J.MeanMetric(nan_strategy="ignore", distributed_available_fn=lambda: False)
    for batch in batches:
        j_sharded(jm, mesh, jnp.asarray(batch))
    jobs.counter_clear()
    jm.compute()
    want = jobs.snapshot()["gauges"]
    assert got["device.MeanMetric.nan_count"] == n_nan and got["device.MeanMetric.inf_count"] == n_inf
    assert {k: v for k, v in got.items() if k.startswith("device.")} == {
        k: v for k, v in want.items() if k.startswith("device.")
    }


def test_flag_is_read_at_build_and_flips_the_key():
    metric = T.SumMetric(**CPU)
    step_off, state_off = make_jit_update(metric)
    tdevice.enable()
    step_on, state_on = make_jit_update(metric)
    tdevice.disable()
    # a step built with telemetry on keeps it after the flag went off, and vice versa
    state_on = step_on(state_on, torch.tensor([1.0, float("nan")]))
    assert int(state_on["_telemetry"].nan_count.sum()) == 1 and "_telemetry" not in step_off(state_off, torch.ones(2))
    assert step_on._obs_site(step_on._body)["key"] != step_off._obs_site(step_off._body)["key"]
    assert tdevice.config_token() == (False, None)
    with tdevice.device_telemetry(histogram=(8, 0.0, 1.0)):
        assert tdevice.config_token() == (True, (8, 0.0, 1.0))
    assert tdevice.config_token() == (False, None)


def test_accumulate_drains_a_stale_regime_first():
    """A pending state from another telemetry config (arity or histogram) is
    drained to gauges, never merged elementwise (JAX's rule)."""
    metric = T.SumMetric(**CPU)
    one = tdevice.telemetry_update(tdevice.telemetry_init(1, device="cpu"), [torch.tensor([float("nan")])])
    two = tdevice.telemetry_update(tdevice.telemetry_init(2, device="cpu"), [torch.tensor([1.0]), torch.tensor([2.0])])
    tdevice.accumulate(metric, one)
    tdevice.accumulate(metric, two)
    assert tobs.snapshot()["gauges"]["device.SumMetric.nan_count"] == 1
    assert metric._device_telemetry[0].nan_count.shape == (2,)
    merged = tdevice.telemetry_merge(two, two)
    assert int(merged.updates) == 2 and float(merged.max_val[1]) == 2.0 and float(merged.min_val[0]) == 1.0
