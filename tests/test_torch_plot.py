# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's plotting (``utilities/plot.py``, ``Metric.plot``, the curve and
confusion-matrix overrides, ``MetricCollection.plot``, ``MetricTracker.plot``
and ``MultitaskWrapper.plot``) against the JAX package's, on matplotlib's Agg
backend.

The same seeded batches go through both packages' metrics; what the two
figures draw must agree: every line's data (``get_xydata``, within rtol 1e-6
as the values they plot), the titles, axis labels, y-limits and legend
labels, and a confusion matrix's image array (bitwise) and cell texts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import torchmetrics_tpu as J  # noqa: E402
import torchmetrics_tpu_torch as T  # noqa: E402
from torchmetrics_tpu.utilities import plot as jplot  # noqa: E402
from torchmetrics_tpu_torch.utilities import plot as tplot  # noqa: E402

C, N = 4, 80


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _kw(pkg):
    return {} if pkg is J else {"device": "cpu"}


def _conv(pkg, x):
    return jnp.asarray(x) if pkg is J else torch.from_numpy(x)


def _batches(seed=0, nb=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        x = rng.standard_normal((N, C)).astype(np.float32)
        probs = (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, N).astype(np.int32)))
    return out


def _fed(pkg, make, batches=None):
    metric = make(pkg)
    for p, t in batches or _batches():
        metric.update(_conv(pkg, p), _conv(pkg, t))
    return metric


def _drawn(ax):
    """What an axes draws, comparable across the packages."""
    legend = ax.get_legend()
    return {
        "lines": [line.get_xydata() for line in ax.lines],
        "title": ax.get_title(),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "ylim": ax.get_ylim(),
        "legend": [t.get_text() for t in legend.get_texts()] if legend else [],
        "images": [np.asarray(im.get_array()) for im in ax.images],
        "texts": [(t.get_position(), t.get_text()) for t in ax.texts],
    }


def _assert_drawn_equal(tax, jax_ax, what):
    got, want = _drawn(tax), _drawn(jax_ax)
    assert len(got["lines"]) == len(want["lines"]), what
    for g, w in zip(got["lines"], want["lines"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=what)
    for key in ("title", "labels", "legend", "texts"):
        assert got[key] == want[key], (what, key, got[key], want[key])
    np.testing.assert_allclose(got["ylim"], want["ylim"], rtol=1e-6, err_msg=what)
    assert len(got["images"]) == len(want["images"]), what
    for g, w in zip(got["images"], want["images"]):
        assert g.dtype == w.dtype and np.array_equal(g, w), what


def _axes(result):
    """The axes of a plot call's ``(fig, ax)`` result."""
    return result[1]


@pytest.mark.parametrize(
    "case",
    ["scalar", "per_class", "bounded_dict", "sequence"],
)
def test_metric_plot_matches_jax(case):
    """A scalar value, a per-class vector (legend name ``Class``), a dict
    (``MinMaxMetric``), and a sequence of values handed to ``plot``."""
    makes = {
        "scalar": lambda pkg: pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg)),
        "per_class": lambda pkg: pkg.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(pkg)),
        "bounded_dict": lambda pkg: pkg.MinMaxMetric(pkg.classification.MulticlassAUROC(num_classes=C, thresholds=16, **_kw(pkg))),
        "sequence": lambda pkg: pkg.classification.MulticlassRecall(num_classes=C, average=None, **_kw(pkg)),
    }
    axes = {}
    for pkg in (J, T):
        metric = _fed(pkg, makes[case])
        if case == "sequence":
            values = []
            for p, t in _batches(seed=4, nb=3):
                values.append(metric(_conv(pkg, p), _conv(pkg, t)))
            axes[pkg] = _axes(metric.plot(values))
        else:
            axes[pkg] = _axes(metric.plot())
    _assert_drawn_equal(axes[T], axes[J], case)


@pytest.mark.parametrize("kind", ["BinaryROC", "MulticlassROC", "MulticlassPrecisionRecallCurve", "MultilabelROC"])
def test_curve_plot_matches_jax(kind):
    rng = np.random.default_rng(2)
    if kind.startswith("Binary"):
        batches = [(rng.random(N).astype(np.float32), rng.integers(0, 2, N).astype(np.int32))]
        args = {}
    elif kind.startswith("Multilabel"):
        batches = [(rng.random((N, C)).astype(np.float32), rng.integers(0, 2, (N, C)).astype(np.int32))]
        args = {"num_labels": C}
    else:
        batches = _batches()
        args = {"num_classes": C}
    axes = {}
    for pkg in (J, T):
        metric = _fed(pkg, lambda p: getattr(p.classification, kind)(thresholds=11, **args, **_kw(p)), batches)
        axes[pkg] = _axes(metric.plot(score=True if kind == "BinaryROC" else None))
    _assert_drawn_equal(axes[T], axes[J], kind)


@pytest.mark.parametrize("kind", ["MulticlassConfusionMatrix", "BinaryConfusionMatrix", "MultilabelConfusionMatrix"])
def test_confusion_matrix_plot_matches_jax(kind):
    """The image (the matrix, bitwise) and every cell's text; the multilabel
    matrix takes the base ``Metric`` plot in both packages."""
    rng = np.random.default_rng(6)
    if kind.startswith("Binary"):
        batches = [(rng.random(N).astype(np.float32), rng.integers(0, 2, N).astype(np.int32))]
        args = {}
    elif kind.startswith("Multilabel"):
        batches = [(rng.random((N, C)).astype(np.float32), rng.integers(0, 2, (N, C)).astype(np.int32))]
        args = {"num_labels": C}
    else:
        batches = _batches()
        args = {"num_classes": C}
    axes = {}
    for pkg in (J, T):
        metric = _fed(pkg, lambda p: getattr(p.classification, kind)(**args, **_kw(p)), batches)
        if kind.startswith("Multilabel"):
            result = tplot.plot_confusion_matrix(metric.compute()) if pkg is T else jplot.plot_confusion_matrix(metric.compute())
            axes[pkg] = list(result[1])
        else:
            axes[pkg] = [_axes(metric.plot(labels=[f"c{i}" for i in range(C if args else 2)]))]
    assert len(axes[T]) == len(axes[J])
    for tax, jax_ax in zip(axes[T], axes[J]):
        _assert_drawn_equal(tax, jax_ax, kind)
        assert [t.get_text() for t in tax.get_xticklabels()] == [t.get_text() for t in jax_ax.get_xticklabels()]


def test_normalized_confusion_matrix_text_matches_jax():
    axes = {}
    for pkg in (J, T):
        metric = _fed(pkg, lambda p: p.classification.MulticlassConfusionMatrix(num_classes=C, normalize="true", **_kw(p)))
        axes[pkg] = _axes(metric.plot(add_text=True))
    _assert_drawn_equal(axes[T], axes[J], "normalized")


def test_collection_plot_matches_jax():
    """``MetricCollection.plot``: one figure per member, and ``together=True``."""
    results = {}
    for pkg in (J, T):
        col = pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg)),
                                    "f1": pkg.classification.MulticlassF1Score(num_classes=C, average=None, **_kw(pkg))})
        for p, t in _batches():
            col.update(_conv(pkg, p), _conv(pkg, t))
        results[pkg] = ([ax for _, ax in col.plot()], [ax for _, ax in col.plot(together=True)])
    for tax, jax_ax in zip(results[T][0] + results[T][1], results[J][0] + results[J][1]):
        _assert_drawn_equal(tax, jax_ax, "collection")
    assert len(results[T][0]) == len(results[J][0]) == 2


@pytest.mark.parametrize("kind", ["metric", "collection"])
def test_tracker_plot_matches_jax(kind):
    axes = {}
    for pkg in (J, T):
        acc = pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg))
        base = acc if kind == "metric" else pkg.MetricCollection(
            {"acc": acc, "prec": pkg.classification.MulticlassPrecision(num_classes=C, **_kw(pkg))})
        tracker = pkg.MetricTracker(base)
        for step in range(3):
            tracker.increment()
            for p, t in _batches(seed=20 + step, nb=1):
                tracker.update(_conv(pkg, p), _conv(pkg, t))
        axes[pkg] = _axes(tracker.plot())
    _assert_drawn_equal(axes[T], axes[J], f"tracker {kind}")


def test_multitask_plot_matches_jax():
    axes = {}
    rng = np.random.default_rng(8)
    reg = (rng.standard_normal(N).astype(np.float32), rng.standard_normal(N).astype(np.float32))
    for pkg in (J, T):
        wrapper = pkg.MultitaskWrapper({
            "cls": pkg.MetricCollection({"acc": pkg.classification.MulticlassAccuracy(num_classes=C, **_kw(pkg))}),
            "reg": pkg.MeanSquaredError(**_kw(pkg)),
        })
        p, t = _batches()[0]
        wrapper.update({"cls": _conv(pkg, p), "reg": _conv(pkg, reg[0])}, {"cls": _conv(pkg, t), "reg": _conv(pkg, reg[1])})
        fig, grid = plt.subplots(1, 2)
        results = wrapper.plot(axes=grid)
        assert [ax for _, ax in results] == list(grid)
        axes[pkg] = list(grid)
    for tax, jax_ax in zip(axes[T], axes[J]):
        _assert_drawn_equal(tax, jax_ax, "multitask")


def test_plot_helpers_match_jax_on_values_given():
    """The helpers themselves, on values handed in: a dict of a scalar and a
    vector, bounds, a trimmed grid of axes."""
    vals = {"a": np.float32(0.25), "b": np.arange(3, dtype=np.float32)}
    got = tplot.plot_single_or_multi_val({k: torch.from_numpy(np.asarray(v)) for k, v in vals.items()}, lower_bound=0.0,
                                         upper_bound=2.0, name="x")
    want = jplot.plot_single_or_multi_val({k: jnp.asarray(v) for k, v in vals.items()}, lower_bound=0.0, upper_bound=2.0, name="x")
    _assert_drawn_equal(got[1], want[1], "helper dict")
    _, grid = plt.subplots(2, 3)
    assert len(tplot.trim_axs(grid, 4)) == 4
    curve = (torch.linspace(0, 1, 5), torch.linspace(0, 1, 5) ** 2)
    got = tplot.plot_curve(curve, score=torch.tensor(0.5), label_names=("x", "y"), name="c")
    want = jplot.plot_curve(tuple(jnp.asarray(c.numpy()) for c in curve), score=jnp.asarray(0.5), label_names=("x", "y"), name="c")
    _assert_drawn_equal(got[1], want[1], "helper curve")
