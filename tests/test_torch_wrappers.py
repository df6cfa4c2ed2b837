# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's wrapper metrics against the JAX package's, on the CPU.

Every wrapper (``MinMaxMetric``, ``ClasswiseWrapper``, the three input
transformers, ``MultioutputWrapper``, ``MultitaskWrapper``,
``BootStrapper``, ``MetricTracker``, ``FeatureShare``/``NetworkCache``,
``Running``) gets the same seeded numpy batches in both packages. Budgets:
int32 states bitwise; float values within rtol 1e-6; float states that sum
the data within rtol 1e-6 and atol 1e-6 times the magnitude of what they sum
(a sum may cancel to near zero, and XLA adds in another order); the
bootstrap's ``std`` and ``quantile`` within rtol 1e-6 and atol 1e-7.

Also pinned: a wrapper lives on its child's device, and an explicit device
that differs raises; a ``MetricCollection`` of wrappers over different base
metrics forms no compute group (the JAX package folds two ``MinMaxMetric``
over different bases into one group and reports a wrong value); the port's
``wrappers`` and top level export the JAX package's names but those of the
domains not ported yet; every exported class carries JAX's
``higher_is_better`` and plot attributes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.wrappers as JW
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.wrappers as TW

C, N, NB = 5, 96, 4
RTOL, ATOL = 1e-6, 1e-7


def _kw(pkg):
    return {} if pkg is J else {"device": "cpu"}


def _conv(pkg, x):
    return jnp.asarray(x) if pkg is J else torch.from_numpy(np.ascontiguousarray(x))


def _cls_batches(seed=0, nb=NB):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _reg_batches(seed=1, outputs=3, nan_rows=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(NB):
        preds = rng.standard_normal((N, outputs)).astype(np.float32)
        target = (preds + 0.5 * rng.standard_normal((N, outputs))).astype(np.float32)
        if nan_rows:
            preds[rng.integers(0, N, 4), rng.integers(0, outputs, 4)] = np.nan
            target[rng.integers(0, N, 3), rng.integers(0, outputs, 3)] = np.nan
        out.append((preds, target))
    return out


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _close(got, want, what, rtol=RTOL, atol=0.0):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _close_tree(got: dict, want: dict, what, **tol):
    assert list(got) == list(want), (what, list(got), list(want))
    for k in want:
        _close(got[k], want[k], f"{what}.{k}", **tol)


def _states_bitwise(tmetric, jmetric, what):
    for key, value in jmetric.state_tree().items():
        got, want = _np(getattr(tmetric, key)), np.asarray(value)
        assert got.dtype == want.dtype and got.shape == want.shape, (what, key)
        np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=f"{what}.{key}")


# ------------------------------------------------------------------ MinMax


def test_minmax_matches_jax_over_computes():
    """``raw``/``min``/``max`` after every batch, and the bound states."""
    out = {}
    for pkg in (J, T):
        metric = pkg.MinMaxMetric(pkg.classification.MulticlassAccuracy(num_classes=C, average="micro", **_kw(pkg)))
        vals = []
        for p, t in _cls_batches():
            metric.update(_conv(pkg, p), _conv(pkg, t))
            vals.append(metric.compute())
        out[pkg] = (vals, metric)
    for got, want in zip(out[T][0], out[J][0]):
        _close_tree(got, want, "minmax")
    _states_bitwise(out[T][1], out[J][1], "minmax")
    _states_bitwise(out[T][1]._base_metric, out[J][1]._base_metric, "minmax base")


def test_minmax_forward_and_reset_match_jax():
    out = {}
    for pkg in (J, T):
        metric = pkg.MinMaxMetric(pkg.classification.MulticlassF1Score(num_classes=C, **_kw(pkg)))
        out[pkg] = [metric(_conv(pkg, p), _conv(pkg, t)) for p, t in _cls_batches()]
        out[pkg].append(metric.compute())
        metric.reset()
        assert float(metric.min_val) == float("inf") and float(metric.max_val) == float("-inf")
    for got, want in zip(out[T], out[J]):
        _close_tree(got, want, "minmax forward")


def test_minmax_nan_value_keeps_the_bounds():
    """A NaN value of the base metric leaves the bounds, as ``jnp.where`` does
    (``torch.maximum`` would take the NaN)."""
    out = {}
    for pkg in (J, T):
        metric = pkg.MinMaxMetric(pkg.SumMetric(nan_strategy="disable", **_kw(pkg)))
        vals = []
        for x in (np.array([1.0], np.float32), np.array([np.nan], np.float32)):
            metric.update(_conv(pkg, x))
            vals.append(metric.compute())
        out[pkg] = vals
    for got, want in zip(out[T], out[J]):
        _close_tree(got, want, "minmax nan")
    assert float(out[T][1]["max"]) == 1.0 and np.isnan(float(out[T][1]["raw"]))


def test_minmax_refuses_a_vector_value_as_jax_does():
    for pkg in (J, T):
        metric = pkg.MinMaxMetric(pkg.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(pkg)))
        p, t = _cls_batches()[0]
        metric.update(_conv(pkg, p), _conv(pkg, t))
        with pytest.raises(RuntimeError, match="float or scalar tensor"):
            metric.compute()
    assert TW.MinMaxMetric._is_suitable_val(torch.ones(1, 1)) and not TW.MinMaxMetric._is_suitable_val(torch.ones(2))
    assert TW.MinMaxMetric._is_suitable_val(2.0) and not TW.MinMaxMetric._is_suitable_val("x")


# --------------------------------------------------------------- Classwise


@pytest.mark.parametrize(
    "options",
    [{}, {"labels": ["a", "b", "c", "d", "e"]}, {"prefix": "p_"}, {"postfix": "_q"}, {"prefix": "p_", "postfix": "_q", "labels": list("vwxyz")}],
    ids=["default", "labels", "prefix", "postfix", "all"],
)
def test_classwise_matches_jax(options):
    out = {}
    for pkg in (J, T):
        metric = pkg.ClasswiseWrapper(pkg.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(pkg)), **options)
        batches = _cls_batches()
        fwd = metric(_conv(pkg, batches[0][0]), _conv(pkg, batches[0][1]))
        for p, t in batches[1:]:
            metric.update(_conv(pkg, p), _conv(pkg, t))
        out[pkg] = (fwd, metric.compute())
    for got, want in zip(out[T], out[J]):
        _close_tree(got, want, "classwise")


def test_classwise_argument_errors_match_jax():
    for bad in ({"labels": "abc"}, {"prefix": 1}, {"postfix": 2}):
        msgs = []
        for pkg in (J, T):
            with pytest.raises(ValueError) as err:
                pkg.ClasswiseWrapper(pkg.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(pkg)), **bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------------ transformers


def test_binary_target_transformer_casts_to_int32_as_jax_does():
    rng = np.random.default_rng(3)
    preds = rng.random(N).astype(np.float32)
    target = rng.random(N).astype(np.float32)
    out = {}
    for pkg in (J, T):
        metric = pkg.BinaryTargetTransformer(pkg.classification.BinaryAccuracy(**_kw(pkg)), threshold=0.3)
        transformed = metric.transform_target(_conv(pkg, target))
        metric.update(_conv(pkg, preds), _conv(pkg, target))
        out[pkg] = (transformed, metric.compute(), metric.wrapped_metric)
    assert out[T][0].dtype == torch.int32
    _close(out[T][0], out[J][0], "transformed target")
    _close(out[T][1], out[J][1], "binary accuracy")
    _states_bitwise(out[T][2], out[J][2], "transformer")


def test_lambda_and_collection_transformers_match_jax():
    out = {}
    for pkg in (J, T):
        col = pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg)),
                                    "f1": pkg.classification.MulticlassF1Score(num_classes=C, **_kw(pkg))})
        metric = pkg.LambdaInputTransformer(col, transform_pred=lambda p: 1 - p, transform_target=lambda t: (t + 1) % C)
        batches = _cls_batches()
        fwd = metric(_conv(pkg, batches[0][0]), _conv(pkg, batches[0][1]))
        for p, t in batches[1:]:
            metric.update(_conv(pkg, p), _conv(pkg, t))
        out[pkg] = (fwd, metric.compute())
        metric.reset()
        assert all(m._update_count == 0 for m in col.values())
    for got, want in zip(out[T], out[J]):
        _close_tree(got, want, "lambda transformer")
    for bad in ({"transform_pred": 1}, {"transform_target": "x"}):
        with pytest.raises(TypeError):
            T.LambdaInputTransformer(T.SumMetric(device="cpu"), **bad)
    with pytest.raises(TypeError, match="MetricsCollection"):
        T.MetricInputTransformer(object())


# ------------------------------------------------------------ Multioutput


@pytest.mark.parametrize("remove_nans", [True, False])
@pytest.mark.parametrize("base", ["R2Score", "MeanSquaredError"])
def test_multioutput_matches_jax(remove_nans, base):
    """One copy of the base metric per output column: states of every copy
    and the stacked values (NaN rows dropped per output with ``remove_nans``)."""
    out = {}
    batches = _reg_batches(nan_rows=remove_nans)
    for pkg in (J, T):
        metric = pkg.MultioutputWrapper(getattr(pkg, base)(**_kw(pkg)), num_outputs=3, remove_nans=remove_nans)
        fwd = metric(_conv(pkg, batches[0][0]), _conv(pkg, batches[0][1]))
        for p, t in batches[1:]:
            metric.update(_conv(pkg, p), _conv(pkg, t))
        out[pkg] = (fwd, metric.compute(), metric)
    _close(out[T][0], out[J][0], "multioutput forward")
    _close(out[T][1], out[J][1], "multioutput compute")
    # float sums (R²'s sum of the targets) may cancel: atol 1e-6 times the magnitude of what they sum
    atol = 1e-6 * float(sum(np.nansum(np.abs(x)) for b in batches for x in b))
    for i, (tm, jm) in enumerate(zip(out[T][2].metrics, out[J][2].metrics)):
        for key, value in jm.state_tree().items():
            _close(getattr(tm, key), value, f"output {i} {key}", atol=atol)
    if remove_nans:
        assert "remove_nans=True" in out[T][2]._sharded_update_unsupported
        assert out[T][2]._sharded_update_unsupported == out[J][2]._sharded_update_unsupported
    else:
        assert out[T][2]._sharded_update_unsupported is None


def test_multioutput_output_dim_and_no_squeeze_match_jax():
    rng = np.random.default_rng(4)
    preds = rng.standard_normal((3, N)).astype(np.float32)
    target = rng.standard_normal((3, N)).astype(np.float32)
    out = {}
    for pkg in (J, T):
        metric = pkg.MultioutputWrapper(pkg.MeanAbsoluteError(**_kw(pkg)), num_outputs=3, output_dim=0, squeeze_outputs=False)
        metric.update(_conv(pkg, preds[:, :, None].transpose(0, 1, 2)[:, :, 0]), _conv(pkg, target))
        out[pkg] = metric.compute()
    _close(out[T], out[J], "output_dim=0")


# -------------------------------------------------------------- Multitask


def _multitask(pkg, **options):
    kw = _kw(pkg)
    cls = pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=C, **kw),
                                "f1": pkg.classification.MulticlassF1Score(num_classes=C, **kw)})
    return pkg.MultitaskWrapper({"cls": cls, "reg": pkg.MeanSquaredError(**kw)}, **options)


@pytest.mark.parametrize("options", [{}, {"prefix": "p/", "postfix": "/s"}], ids=["plain", "prefixed"])
def test_multitask_matches_jax(options):
    out = {}
    cls_batches, reg_batches = _cls_batches(), _reg_batches(outputs=1, nan_rows=False)
    for pkg in (J, T):
        metric = _multitask(pkg, **options)
        for flatten in (True, False):
            names = list(metric.keys(flatten=flatten))
            assert names == [k for k, _ in metric.items(flatten=flatten)] and len(names) == len(list(metric.values(flatten=flatten)))
        out.setdefault("keys", []).append((list(metric.keys()), list(metric.keys(flatten=False))))

        def batch(i):
            (p, t), (rp, rt) = cls_batches[i], reg_batches[i]
            return {"cls": _conv(pkg, p), "reg": _conv(pkg, rp[:, 0])}, {"cls": _conv(pkg, t), "reg": _conv(pkg, rt[:, 0])}

        fwd = metric(*batch(0))
        for i in range(1, NB):
            metric.update(*batch(i))
        copy = metric.clone(prefix="c_")
        out[pkg] = (fwd, metric.compute(), copy.compute(), list(copy.keys()))
        with pytest.raises(ValueError, match="same keys"):
            metric.update({"cls": batch(0)[0]["cls"]}, {"cls": batch(0)[1]["cls"]})
    assert out["keys"][0] == out["keys"][1]
    assert out[T][3] == out[J][3]
    for got, want in zip(out[T][:3], out[J][:3]):
        assert list(got) == list(want)
        for k in want:
            _close_tree(got[k], want[k], k) if isinstance(want[k], dict) else _close(got[k], want[k], k)


# ------------------------------------------------------------ BootStrapper


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_matches_jax(strategy):
    """Each copy's int32 states bitwise (the same seed draws the same
    indices), and mean/std (ddof=1)/quantiles/raw within the budget."""
    out = {}
    for pkg in (J, T):
        quantile = np.array([0.05, 0.5, 0.95], np.float32)
        metric = pkg.BootStrapper(
            pkg.classification.MulticlassF1Score(num_classes=C, **_kw(pkg)), num_bootstraps=6, sampling_strategy=strategy,
            seed=7, quantile=_conv(pkg, quantile), raw=True,
        )
        for p, t in _cls_batches():
            metric.update(_conv(pkg, p), _conv(pkg, t))
        out[pkg] = (metric.compute(), metric)
    for tm, jm in zip(out[T][1].metrics, out[J][1].metrics):
        _states_bitwise(tm, jm, f"bootstrap {strategy}")
    got, want = out[T][0], out[J][0]
    assert list(got) == list(want) == ["mean", "std", "quantile", "raw"]
    for k in want:
        _close(got[k], want[k], k, rtol=RTOL, atol=ATOL)


def test_bootstrapper_forward_and_scalar_quantile_match_jax():
    out = {}
    for pkg in (J, T):
        metric = pkg.BootStrapper(pkg.MeanSquaredError(**_kw(pkg)), num_bootstraps=4, seed=3, quantile=0.25)
        vals = [metric(_conv(pkg, p[:, 0]), _conv(pkg, t[:, 0])) for p, t in _reg_batches(nan_rows=False)]
        out[pkg] = vals + [metric.compute()]
    for got, want in zip(out[T], out[J]):
        _close_tree(got, want, "bootstrap forward", rtol=RTOL, atol=ATOL)


def test_bootstrapper_refuses_what_jax_refuses():
    for pkg in (J, T):
        with pytest.raises(ValueError, match="sampling_strategy"):
            pkg.BootStrapper(pkg.SumMetric(**_kw(pkg)), sampling_strategy="jackknife")
        metric = pkg.BootStrapper(pkg.SumMetric(**_kw(pkg)))
        with pytest.raises(ValueError, match="None of the input contained tensors"):
            metric.update(3.0)
    assert TW.BootStrapper._sharded_update_unsupported == JW.BootStrapper._sharded_update_unsupported


# ----------------------------------------------------------- MetricTracker


@pytest.mark.parametrize("kind", ["metric", "collection"])
def test_tracker_matches_jax(kind):
    out = {}
    for pkg in (J, T):
        kw = _kw(pkg)
        if kind == "metric":
            base, maximize = pkg.classification.MulticlassAccuracy(num_classes=C, **kw), True
        else:
            base = pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=C, **kw),
                                         "hamming": pkg.classification.MulticlassHammingDistance(num_classes=C, **kw)})
            maximize = None
        tracker = pkg.MetricTracker(base, maximize=maximize)
        with pytest.raises(ValueError, match="increment"):
            tracker.update(*[_conv(pkg, x) for x in _cls_batches()[0]])
        for step in range(3):
            tracker.increment()
            for p, t in _cls_batches(seed=10 + step, nb=step + 1):
                tracker.update(_conv(pkg, p), _conv(pkg, t))
        out[pkg] = (tracker.compute(), tracker.compute_all(), tracker.best_metric(return_step=True), tracker.n_steps)
    assert out[T][3] == out[J][3] == 3
    for i in range(2):
        got, want = out[T][i], out[J][i]
        _close_tree(got, want, "tracker") if isinstance(want, dict) else _close(got, want, "tracker")
    (gv, gi), (wv, wi) = out[T][2], out[J][2]
    assert gi == wi
    if isinstance(wv, dict):
        assert list(gv) == list(wv) and all(abs(gv[k] - wv[k]) <= RTOL * abs(wv[k]) for k in wv)
    else:
        assert abs(gv - wv) <= RTOL * abs(wv)


def test_tracker_argument_errors_match_jax():
    for pkg in (J, T):
        acc = pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg))
        with pytest.raises(ValueError, match="single bool"):
            pkg.MetricTracker(acc, maximize=[True])
        with pytest.raises(TypeError):
            pkg.MetricTracker(object())
        with pytest.raises(AttributeError, match="higher_is_better"):
            pkg.MetricTracker(pkg.classification.MulticlassStatScores(num_classes=C, **_kw(pkg)), maximize=None)
    assert not isinstance(T.MetricTracker(T.SumMetric(device="cpu")), T.Metric)


def test_tracker_of_a_dict_valued_metric_warns_and_returns_none_as_jax_does():
    for pkg in (J, T):
        tracker = pkg.MetricTracker(pkg.MinMaxMetric(pkg.SumMetric(**_kw(pkg))))
        for step in range(2):
            tracker.increment()
            tracker.update(_conv(pkg, np.array([1.0 + step], np.float32)))
        assert isinstance(tracker.compute_all(), list)
        with pytest.warns(UserWarning, match="best metric"):
            assert tracker.best_metric() is None


# ------------------------------------------------------------ FeatureShare


def _feature_metric(pkg, weights):
    """A toy metric with a feature network (a fixed random linear map), the
    same weights in both packages: its state sums the features of its inputs."""

    class Net:
        calls = 0

        def __call__(self, x):
            Net.calls += 1
            w = _conv(pkg, weights)
            return x @ w

    class Features(pkg.Metric):
        feature_network = "net"

        def __init__(self, scale, **kwargs):
            super().__init__(**kwargs)
            self.net = Net()
            self.scale = scale
            self.add_state("total", np.zeros(weights.shape[1], np.float32), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + self.net(x).sum(0) * self.scale

        def compute(self):
            return self.total

    return Features, Net


def test_feature_share_matches_jax_and_calls_the_network_once_per_input():
    rng = np.random.default_rng(9)
    weights = rng.standard_normal((6, 3)).astype(np.float32)
    xs = [rng.standard_normal((N, 6)).astype(np.float32) for _ in range(3)]
    out = {}
    for pkg in (J, T):
        cls, net = _feature_metric(pkg, weights)
        shared = pkg.FeatureShare({"a": cls(1.0, **_kw(pkg)), "b": cls(2.0, **_kw(pkg))})
        assert shared.compute_groups == {}
        for x in xs:
            shared.update(_conv(pkg, x))
        out[pkg] = (shared.compute(), net.calls)
    assert out[T][1] == out[J][1] == len(xs)  # the second member hits the cache
    _close_tree(out[T][0], out[J][0], "feature share", rtol=1e-5)


def test_network_cache_evicts_the_oldest_as_jax_does():
    keys = {}
    for pkg in (J, T):
        seen = []
        cache = (JW if pkg is J else TW).feature_share.NetworkCache(lambda x: seen.append(1) or x, max_size=2)
        for v in (1, 2, 1, 3, 2, 1):
            cache(_conv(pkg, np.full(3, v, np.float32)))
        keys[pkg] = (len(seen), len(cache._cache))
    assert keys[T] == keys[J]
    with pytest.raises(AttributeError, match="feature_network"):
        T.FeatureShare({"a": T.SumMetric(device="cpu")})


# ----------------------------------------------------------------- Running


def test_running_matches_jax():
    out = {}
    for pkg in (J, T):
        metric = pkg.Running(pkg.MeanSquaredError(**_kw(pkg)), window=3)
        vals = []
        for p, t in _reg_batches(nan_rows=False) + _reg_batches(seed=2, nan_rows=False):
            metric.update(_conv(pkg, p[:, 0]), _conv(pkg, t[:, 0]))
            vals.append(metric.compute())
        out[pkg] = (vals, metric)
    for got, want in zip(*(out[p][0] for p in (T, J))):
        _close(got, want, "running", rtol=1e-6)
    for key, value in out[J][1].state_tree().items():
        _close(getattr(out[T][1], key), value, key)


# --------------------------------------------------------- device and groups


def test_a_wrapper_lives_on_its_childs_device():
    acc = T.classification.MulticlassAccuracy(num_classes=C, device="cpu")
    for wrapper in (T.MinMaxMetric(acc), T.ClasswiseWrapper(T.classification.MulticlassF1Score(num_classes=C, average=None, device="cpu")),
                    T.BootStrapper(acc), T.MultioutputWrapper(T.MeanSquaredError(device="cpu"), 2),
                    T.MultitaskWrapper({"a": acc}), T.BinaryTargetTransformer(acc), T.Running(T.SumMetric(device="cpu"))):
        assert wrapper.device == torch.device("cpu"), type(wrapper).__name__
    assert T.MinMaxMetric(acc, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="device=meta"):
        T.MinMaxMetric(acc, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        T.MultitaskWrapper({"a": acc, "b": T.SumMetric(device="meta")})


def test_wrappers_never_join_a_compute_group():
    """Two ``MinMaxMetric`` over different bases hold equal bounds until a
    compute, so the JAX package groups them and feeds the batches to the
    leader's base alone: its F1 differs from the same wrapper alone. The
    port's collection forms no group, and each value equals the wrapper's alone."""
    batches = _cls_batches(seed=3, nb=3)
    results = {}
    for pkg in (J, T):
        def make(kind):
            cls = pkg.classification
            base = (cls.MulticlassAccuracy(num_classes=8, average="micro", **_kw(pkg)) if kind == "acc"
                    else cls.MulticlassF1Score(num_classes=8, average="macro", **_kw(pkg)))
            return pkg.MinMaxMetric(base)

        col = pkg.MetricCollection({"acc": make("acc"), "f1": make("f1")})
        alone = {"acc": make("acc"), "f1": make("f1")}
        for p, t in batches:
            p = np.concatenate([p, p[:, :3]], axis=1)  # 8 classes
            t = (t + 3 * (t % 2)).astype(np.int32)
            col.update(_conv(pkg, p), _conv(pkg, t))
            for m in alone.values():
                m.update(_conv(pkg, p), _conv(pkg, t))
        results[pkg] = (col.compute_groups, col.compute(), {k: m.compute() for k, m in alone.items()})
    jgroups, jvals, jalone = results[J]
    assert jgroups == {0: ["acc", "f1"]}
    assert abs(float(jvals["f1_raw"]) - float(jalone["f1"]["raw"])) > 1e-3  # the JAX package's fault
    tgroups, tvals, talone = results[T]
    assert tgroups == {0: ["acc"], 1: ["f1"]}
    for key in ("acc", "f1"):
        for part in ("raw", "min", "max"):
            assert torch.equal(tvals[f"{key}_{part}"], talone[key][part]), (key, part)
    _close(tvals["acc_raw"], jvals["acc_raw"], "acc")
    _close(tvals["f1_raw"], jalone["f1"]["raw"], "f1 against the JAX wrapper alone")


# ----------------------------------------------------------------- exports

# the JAX package's top-level names the port does not export there: not metrics, the version string
# and the functional namespace, which the port reaches as a module (every domain is ported)
NOT_PORTED = {"__version__", "functional"}


def test_exports_equal_jax_but_the_domains_not_ported():
    """``wrappers`` exports exactly JAX's names; the top level exports JAX's
    names but ``NOT_PORTED`` (``Running`` and ``CompositionalMetric`` among
    them), every one defined in the port."""
    assert sorted(TW.__all__) == sorted(JW.__all__)
    for name in TW.__all__:
        assert getattr(TW, name).__module__.startswith("torchmetrics_tpu_torch.wrappers.")
    assert NOT_PORTED <= set(J.__all__)
    assert sorted(T.__all__) == sorted(set(J.__all__) - NOT_PORTED)
    for name in T.__all__:
        assert getattr(T, name).__module__.startswith("torchmetrics_tpu_torch.")
    for name in ("Running", "CompositionalMetric", "MinMaxMetric", "MetricTracker"):
        assert name in T.__all__ and getattr(T, name) is getattr(TW, name, getattr(T, name))


def test_classes_carry_jax_plot_attributes():
    """``higher_is_better``, ``plot_lower_bound``, ``plot_upper_bound`` and
    ``plot_legend_name`` of every class the port exports equal its JAX twin's."""
    import torchmetrics_tpu.classification as JC
    import torchmetrics_tpu.regression as JR
    import torchmetrics_tpu_torch.classification as TC
    import torchmetrics_tpu_torch.regression as TR

    checked = 0
    for jmod, tmod in ((J, T), (JC, TC), (JR, TR), (JW, TW)):
        for name in tmod.__all__:
            tcls, jcls = getattr(tmod, name), getattr(jmod, name)
            if not isinstance(tcls, type):
                continue
            for attr in ("higher_is_better", "plot_lower_bound", "plot_upper_bound", "plot_legend_name"):
                assert getattr(tcls, attr, "missing") == getattr(jcls, attr, "missing"), (name, attr)
            checked += 1
    assert checked > 150
