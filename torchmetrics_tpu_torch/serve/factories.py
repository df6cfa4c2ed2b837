# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Ready-made stream-target factories for ``metricserve`` (counterpart of
``torchmetrics_tpu/serve/factories.py``).

A wire ``create`` names its metric target declaratively — a
``module:callable`` path plus JSON kwargs (see
:func:`~torchmetrics_tpu_torch.serve.stream.resolve_target`) — because a daemon
cannot receive live Python objects. These are the built-ins the docs, tests
and bench use; deployments register their own factories the same way (any
importable callable returning a ``Metric``, ``MetricCollection`` or
``SlicedPlan`` works).

The same 12 names build the port's counterpart of the same metric with the
same defaults. Each also takes ``device`` (default ``"cuda"``), which never
rides a spec's kwargs: a spec travels on the wire to aggregators of either
package, and JAX's factories take no device. The stream, daemon or
aggregator that resolves the target passes its own device
(:func:`~torchmetrics_tpu_torch.serve.stream.resolve_target`).
"""
from __future__ import annotations

from typing import Any

__all__ = [
    "accuracy",
    "binary_accuracy",
    "binary_average_precision",
    "cardinality",
    "checked_binary_accuracy",
    "collection",
    "drift",
    "guarded_binary_accuracy",
    "guarded_mean_squared_error",
    "heavy_hitters",
    "quantile",
    "sliced_accuracy",
]


def accuracy(num_classes: int = 4, average: str = "micro", device: Any = "cuda") -> Any:
    """A plain ``MulticlassAccuracy`` — the simplest stream target."""
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    return MulticlassAccuracy(num_classes=num_classes, average=average, validate_args=False, device=device)


def binary_accuracy(threshold: float = 0.5, device: Any = "cuda") -> Any:
    """Elementwise (sum-state) binary accuracy — replica ``sync()`` folds it
    across ranks at the drain compute."""
    from torchmetrics_tpu_torch.classification import BinaryAccuracy

    return BinaryAccuracy(threshold=threshold, validate_args=False, device=device)


def checked_binary_accuracy(threshold: float = 0.5, device: Any = "cuda") -> Any:
    """Binary accuracy WITH host-side argument validation: a target value
    outside ``{0, 1}`` raises in the worker. Shape/dtype-clean batches with
    bad values pass wire admission and kill the apply — the deterministic
    poison batch the dead-letter quarantine drills against."""
    from torchmetrics_tpu_torch.classification import BinaryAccuracy

    return BinaryAccuracy(threshold=threshold, validate_args=True, device=device)


def guarded_binary_accuracy(threshold: float = 0.5, policy: str = "mask", device: Any = "cuda") -> Any:
    """Binary accuracy under the StateGuard (``robustness/guard.py``): the
    domain contract (finite preds in [0, 1], target in {0, 1}) is compiled
    into the update step. ``policy="mask"`` accumulates only valid rows,
    ``"reject"`` vetoes whole invalid batches, ``"propagate"`` only counts —
    the stream publishes the verdicts as ``guard.<stream>.*`` gauges."""
    from torchmetrics_tpu_torch.classification import BinaryAccuracy
    from torchmetrics_tpu_torch.robustness.guard import enable_guard

    return enable_guard(BinaryAccuracy(threshold=threshold, validate_args=False, device=device), policy=policy)


def guarded_mean_squared_error(policy: str = "propagate", device: Any = "cuda") -> Any:
    """MSE under the StateGuard — float error-sum state, so a propagated NaN
    frame actually poisons state and trips the in-program poison probe: the
    canonical target for the serve plane's known-good rollback drill."""
    from torchmetrics_tpu_torch.regression.mse import MeanSquaredError
    from torchmetrics_tpu_torch.robustness.guard import enable_guard

    return enable_guard(MeanSquaredError(device=device), policy=policy)


def binary_average_precision(device: Any = "cuda") -> Any:
    """Cat (list-state) average precision — per-rank rows gather (pad/trim)
    across ranks at the drain compute."""
    from torchmetrics_tpu_torch.classification import BinaryAveragePrecision

    return BinaryAveragePrecision(validate_args=False, device=device)


def quantile(q: float = 0.5, capacity: int = 256, levels: int = 14, device: Any = "cuda") -> Any:
    """Bounded-memory KLL quantile — the ``dist_reduce_fx="merge"`` regime;
    ranks pairwise-merge sketches at the drain compute."""
    from torchmetrics_tpu_torch import Quantile

    return Quantile(q=q, capacity=capacity, levels=levels, device=device)


def collection(num_classes: int = 4, device: Any = "cuda") -> Any:
    """An accuracy + AUROC ``MetricCollection`` — pair with ``fused=True``
    for the one-dispatch evaluation plane."""
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection(
        {
            "acc": MulticlassAccuracy(num_classes=num_classes, validate_args=False, device=device),
            "auroc": MulticlassAUROC(num_classes=num_classes, validate_args=False, device=device),
        }
    )


def drift(
    reference: Any = None,
    bins: int = 64,
    lo: float = 0.0,
    hi: float = 1.0,
    thresholds: Any = None,
    patience: int = 3,
    reference_checkpoint: Any = None,
    reference_path: Any = None,
    reference_state: Any = None,
    device: Any = "cuda",
) -> Any:
    """A :class:`~torchmetrics_tpu_torch.drift.DriftScore` stream — live-window
    drift vs a pinned reference, published as ``drift.<stream>.*`` gauges
    that can floor ``/healthz``.

    All kwargs are wire-JSON-able: ``reference`` is a raw sample (list of
    floats) binned at ``bins/lo/hi``; ``reference_checkpoint`` is a path to
    a pickled checkpoint payload to pin the reference from instead
    (``reference_path``/``reference_state`` narrow the lookup);
    ``thresholds`` maps score names to ``[warn, critical]`` pairs.
    """
    from torchmetrics_tpu_torch.drift import DriftScore

    ckpt = None
    if reference_checkpoint is not None:
        import pickle

        with open(reference_checkpoint, "rb") as fh:
            ckpt = pickle.load(fh)
    if thresholds is not None:
        thresholds = {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in dict(thresholds).items()}
    return DriftScore(
        reference=reference,
        bins=bins,
        lo=lo,
        hi=hi,
        thresholds=thresholds,
        patience=patience,
        reference_checkpoint=ckpt,
        reference_path=reference_path,
        reference_state=reference_state,
        device=device,
    )


def cardinality(precision: int = 12, device: Any = "cuda") -> Any:
    """A :class:`~torchmetrics_tpu_torch.drift.Cardinality` stream — HyperLogLog
    distinct count of the streamed tags (``drift.<stream>.cardinality``
    gauge rides ``/metrics``)."""
    from torchmetrics_tpu_torch.drift import Cardinality

    return Cardinality(precision=precision, device=device)


def heavy_hitters(depth: int = 4, width: int = 1024, k: int = 32, device: Any = "cuda") -> Any:
    """A :class:`~torchmetrics_tpu_torch.drift.HeavyHitters` stream — top-``k``
    hot tags via Count-Min; query via stream snapshots/compute."""
    from torchmetrics_tpu_torch.drift import HeavyHitters

    return HeavyHitters(depth=depth, width=width, k=k, device=device)


def sliced_accuracy(num_classes: int = 4, num_cells: int = 16, key_width: int = 1, device: Any = "cuda") -> Any:
    """A per-cohort accuracy ``SlicedPlan``; wire batches lead with the
    integer cohort-key column(s): ``[keys, preds, target]``."""
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    metric = MulticlassAccuracy(num_classes=num_classes, validate_args=False, device=device)
    return metric.sliced(num_cells=num_cells, key_width=key_width)
