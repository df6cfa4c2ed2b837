# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The aggregation metrics and the running window of the port against the
JAX package's, on the CPU: ``MaxMetric``, ``MinMetric``, ``SumMetric``,
``CatMetric``, the weighted ``MeanMetric`` under every ``nan_strategy``,
``RunningMean``/``RunningSum`` and ``Running`` over another metric, the
fused plan and its eligibility report.

Budgets: max, min and the concatenated values are bitwise (no arithmetic);
the sums, weighted sums and means add in another order than XLA's,
``rtol=1e-6, atol=1e-6``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.aggregation as JA
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.aggregation as TA
from torchmetrics_tpu_torch.interop import state_to_numpy

RTOL, ATOL = 1e-6, 1e-6
AGGREGATORS = ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric"]
STRATEGIES = ["error", "warn", "ignore", "disable", 2.5, -1]
BITWISE = {"MaxMetric", "MinMetric", "CatMetric"}


def _values(seed, nan=True, n=50):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    if nan:
        x[rng.choice(n, 5, replace=False)] = np.nan
    return x


def _np(x):
    if isinstance(x, list):
        return [_np(v) for v in x]
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _same(got, want, bitwise, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, bitwise, what)
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    if bitwise:
        assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8)), (what, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _outcome(fn):
    """``("ok", warnings)`` or ``("raised", type, message)``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            fn()
        except Exception as err:  # noqa: BLE001 - the outcome is compared
            return ("raised", type(err).__name__, str(err))
    return ("ok", sorted({str(w.message) for w in caught if "nan" in str(w.message)}))


def _feed(metric, kind, batches, weights=None):
    for i, b in enumerate(batches):
        x = jnp.asarray(b) if kind == "jax" else torch.from_numpy(b)
        if weights is None:
            metric.update(x)
        else:
            w = weights[i]
            w = (jnp.asarray(w) if kind == "jax" else torch.from_numpy(w)) if isinstance(w, np.ndarray) else w
            metric.update(x, w)


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", AGGREGATORS)
def test_aggregator_matches_jax(name, strategy):
    """Batches with NaNs, then a Python scalar: the same outcome (a value, a
    warning or an error) and the same states and value as JAX's."""
    batches = [_values(s) for s in range(3)]
    jm, tm = getattr(J, name)(nan_strategy=strategy), getattr(T, name)(nan_strategy=strategy, device="cpu")
    want = _outcome(lambda: (_feed(jm, "jax", batches), jm.update(1.25)))
    got = _outcome(lambda: (_feed(tm, "torch", batches), tm.update(1.25)))
    assert got == want
    if want[0] == "raised":
        return
    jtree, ttree = jm.state_tree(), state_to_numpy(tm)
    assert sorted(jtree) == sorted(ttree)
    for key, value in jtree.items():
        _same(ttree[key], value, name in BITWISE, key)
    _same(tm.compute(), jm.compute(), name in BITWISE, "value")
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]


@pytest.mark.parametrize("strategy", ["warn", "ignore", 0.5])
def test_weighted_mean_matches_jax(strategy):
    """Weights broadcast to the value's shape: a scalar, a per-entry array, a
    0-d array; NaN values take their weight out (``ignore``) or are imputed."""
    batches = [_values(s) for s in range(4)]
    rng = np.random.default_rng(9)
    weights = [2.0, rng.uniform(0, 2, 50).astype(np.float32), np.asarray(0.5, np.float32), 1]
    jm, tm = J.MeanMetric(nan_strategy=strategy), T.MeanMetric(nan_strategy=strategy, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _feed(jm, "jax", batches, weights)
        _feed(tm, "torch", batches, weights)
    _same(tm.mean_value, jm.mean_value, False, "mean_value")
    _same(tm.weight, jm.weight, False, "weight")
    _same(tm.compute(), jm.compute(), False, "value")


@pytest.mark.parametrize("name", AGGREGATORS)
def test_empty_value_leaves_the_state_alone(name):
    jm, tm = getattr(J, name)(), getattr(T, name)(device="cpu")
    jm.update(jnp.asarray([3.0, -1.0]))
    tm.update(torch.tensor([3.0, -1.0]))
    before = state_to_numpy(tm)
    jm.update(jnp.zeros(0))
    tm.update(torch.zeros(0))
    after = state_to_numpy(tm)
    for key in before:
        _same(after[key], before[key], True, key)
        _same(after[key], jm.state_tree()[key], name in BITWISE, key)


def test_inputs_of_every_kind_land_on_the_metric_device():
    """Python scalars, numpy arrays, int tensors and float64 arrays become
    float32 on the metric's device, as ``jnp.asarray(x, float32)`` does."""
    jm, tm = J.SumMetric(), T.SumMetric(device="cpu")
    for x in (3, 2.5, np.arange(4), np.linspace(0, 1, 5), torch.arange(3, dtype=torch.int64)):
        jm.update(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x))
        tm.update(x)
    assert tm.sum_value.device.type == "cpu" and tm.sum_value.dtype == torch.float32
    _same(tm.compute(), jm.compute(), False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.MeanMetric()


def test_quantile_and_median_are_refused_naming_a9():
    """(Once a refusal; now the parity of the same scope.) ``Quantile`` and
    ``Median`` are exported where JAX exports them and equal JAX's on the same
    stream: the KLL state leaf for leaf bitwise, the quantiles and the error
    bound bitwise, through ``update`` and ``forward``."""
    rng = np.random.default_rng(147)
    for name, kw in (("Quantile", {"q": [0.1, 0.5, 0.9], "capacity": 128, "levels": 14}), ("Median", {"capacity": 256})):
        assert getattr(TA, name) is getattr(T, name)
        jm, tm = getattr(J, name)(**kw), getattr(T, name)(device="cpu", **kw)
        for i in range(4):
            x = (rng.standard_normal(700 + i) * 3).astype(np.float32)
            if i % 2:
                _same(tm(torch.from_numpy(x)), jm(jnp.asarray(x)), True, f"{name} forward {i}")
            else:
                tm.update(torch.from_numpy(x))
                jm.update(jnp.asarray(x))
        for field, got, want in zip(jm.sketch._fields, tm.sketch, jm.sketch):
            _same(got, want, True, f"{name} {field}")
        _same(tm.compute(), jm.compute(), True, f"{name} value")
        _same(tm.error_bound(), jm.error_bound(), True, f"{name} bound")
    with pytest.raises(AttributeError):
        TA.NotAMetric  # noqa: B018 - other names are plain attribute errors


def test_exports_equal_jax_but_quantile_and_median():
    agg = set(JA.__dict__.get("__all__", [])) or {
        n for n in J.__all__ if getattr(getattr(J, n), "__module__", "") == "torchmetrics_tpu.aggregation"
    }
    assert sorted(TA.__all__) == sorted(agg)
    for name in TA.__all__:
        assert getattr(T, name) is getattr(TA, name) and name in T.__all__ and name in J.__all__


def test_nan_strategy_errors_match_jax():
    for bad in ("drop", None, [1.0]):
        want = _outcome(lambda: J.MeanMetric(nan_strategy=bad))
        got = _outcome(lambda: T.MeanMetric(nan_strategy=bad, device="cpu"))
        assert got == want, bad


# ------------------------------------------------------------------ running


@pytest.mark.parametrize("window", [1, 3, 5])
@pytest.mark.parametrize("name", ["RunningMean", "RunningSum"])
def test_running_matches_jax(name, window):
    """Window slots after each update and the value over the last ``window``
    updates, through ``update`` and ``forward``; reset clears everything."""
    jm, tm = getattr(J, name)(window=window, nan_strategy="ignore"), getattr(T, name)(window=window, nan_strategy="ignore", device="cpu")
    for i in range(7):
        x = _values(40 + i)
        if i % 2:
            _same(tm(torch.from_numpy(x)), jm(jnp.asarray(x)), False, f"forward {i}")
        else:
            jm.update(jnp.asarray(x))
            tm.update(torch.from_numpy(x))
        _same(tm.compute(), jm.compute(), False, f"value after {i + 1}")
        assert tm._num_vals_seen == jm._num_vals_seen == i + 1
    jtree, ttree = jm.state_tree(), state_to_numpy(tm)
    assert sorted(jtree) == sorted(ttree)
    for key, value in jtree.items():
        _same(ttree[key], value, False, key)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    tm.reset()
    assert tm._num_vals_seen == 0 and all(float(v) == 0 for v in state_to_numpy(tm).values())


def test_running_over_another_metric_matches_jax():
    """``Running`` of a regression metric: its states stored per slot."""
    rng = np.random.default_rng(3)
    jm, tm = J.wrappers.Running(J.MeanSquaredError(), window=3), T.wrappers.Running(T.MeanSquaredError(device="cpu"), window=3)
    for _ in range(5):
        p, t = rng.standard_normal(32).astype(np.float32), rng.standard_normal(32).astype(np.float32)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _same(tm.compute(), jm.compute(), False)
    for i in range(3):
        _same(getattr(tm, f"total_{i}"), getattr(jm, f"total_{i}"), True, f"total_{i}")


@pytest.mark.parametrize("case", ["not_a_metric", "window0", "window_float", "full_state"])
def test_running_errors_match_jax(case):
    def make(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        if case == "not_a_metric":
            return pkg.wrappers.Running(object(), window=2)
        if case == "full_state":
            return pkg.wrappers.Running(pkg.MaxMetric(**kw), window=2)
        return pkg.wrappers.Running(pkg.SumMetric(**kw), window=0 if case == "window0" else 2.0)

    assert _outcome(lambda: make(T)) == _outcome(lambda: make(J))


# -------------------------------------------------------------- fused plans


def _aggregator_suite(pkg, strategy):
    kw = {} if pkg is J else {"device": "cpu"}
    return pkg.MetricCollection({
        "sum": pkg.SumMetric(nan_strategy=strategy, **kw),
        "max": pkg.MaxMetric(nan_strategy=strategy, **kw),
        "min": pkg.MinMetric(nan_strategy=strategy, **kw),
        "mean": pkg.MeanMetric(nan_strategy=strategy, **kw),
    })


@pytest.mark.parametrize("strategy", ["warn", "ignore", 3.0])
def test_fused_aggregators_match_jax_fused(strategy):
    """The aggregators through ``suite.fused()`` against JAX's fused plan on
    the same batches (NaNs in them): states bitwise for max/min, within the
    budget for the sums. With ``"warn"`` the NaNs pass unmasked in both, as
    under JAX's ``jit``: the fused step keeps shapes fixed."""
    batches = [_values(60 + s) for s in range(4)]
    tcol, jcol = _aggregator_suite(T, strategy), _aggregator_suite(J, strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for b in batches[:2]:
            tcol.update(torch.from_numpy(b))
            jcol.update(jnp.asarray(b))
        tcol.reset()
        jcol.reset()
        tplan, jplan = tcol.fused(), jcol.fused()
        for b in batches:
            tplan.update(torch.from_numpy(b))
            jplan.update(jnp.asarray(b))
    tplan.fold_back()
    jplan.fold_back()
    for key in ("sum", "max", "min", "mean"):
        jtree, ttree = dict.__getitem__(jcol, key).state_tree(), state_to_numpy(dict.__getitem__(tcol, key))
        for name, value in jtree.items():
            _same(ttree[name], value, key in ("max", "min"), f"{key}.{name}")
    if strategy == "warn":
        assert np.isnan(float(tcol["sum"].compute())) and np.isnan(float(jcol["sum"].compute()))


def test_fused_cat_metric_equals_eager():
    """``CatMetric`` fused with a CatBuffer carry: the rows equal the eager fold's."""
    batches = [_values(70 + s, nan=False) for s in range(3)]
    from torchmetrics_tpu_torch.parallel import FusedCollectionPlan

    eager, fused = T.CatMetric(device="cpu"), T.CatMetric(device="cpu")
    plan = FusedCollectionPlan(fused, cat_capacity=200, example_batch=(torch.from_numpy(batches[0]),))
    for b in batches:
        eager.update(torch.from_numpy(b))
        plan.update(torch.from_numpy(b))
    plan.fold_back()
    _same(fused.compute(), eager.compute(), True)


def test_fusion_report_matches_jax_running_refused():
    """The reasons equal JAX's: ``Running`` carries a host counter."""
    from torchmetrics_tpu.parallel import fusion_report as j_fusion_report
    from torchmetrics_tpu_torch.parallel import fusion_report

    def members(pkg):
        kw = {} if pkg is J else {"device": "cpu"}
        return pkg.MetricCollection({
            "sum": pkg.SumMetric(**kw), "cat": pkg.CatMetric(**kw), "mean": pkg.MeanMetric(**kw),
            "running": pkg.RunningMean(window=3, **kw), "rsum": pkg.RunningSum(window=2, **kw),
        })

    report = fusion_report(members(T))
    assert report == j_fusion_report(members(J))
    assert "host-side counters ['_num_vals_seen']" in report["running"]


def test_sharded_update_refuses_running_until_wrappers_are_ported():
    """Wrappers are ported to the sharded plane: it takes ``RunningMean`` (its
    state walk reaches the wrapped ``MeanMetric``), and refuses only what the
    JAX package refuses (``BootStrapper``, with JAX's reason)."""
    from torchmetrics_tpu.parallel.sharded import make_sharded_update as jax_make_sharded_update
    from torchmetrics_tpu_torch.parallel.sharded import deep_reductions, make_sharded_update

    running = T.RunningMean(window=2, device="cpu")
    make_sharded_update(running, None)
    assert deep_reductions(running) == {k: v for k, v in J.RunningMean(window=2)._reductions.items()} | {
        f"base_metric:{k}": v for k, v in running.base_metric._reductions.items()
    }
    boot = T.wrappers.BootStrapper(T.MeanMetric(device="cpu"), num_bootstraps=2)
    with pytest.raises(ValueError) as got:
        make_sharded_update(boot, None)
    with pytest.raises(ValueError) as want:
        jax_make_sharded_update(J.wrappers.BootStrapper(J.MeanMetric(), num_bootstraps=2), None)
    assert str(got.value) == str(want.value)
