# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Factory for stat-scores-derived module metric families (counterpart of
``torchmetrics_tpu/classification/_derived.py``).

One factory subclasses the StatScores state machines and swaps in the
family's reduce function. A reduce adapter has the signature
``reduce(tp, fp, tn, fn, average, multidim_average, multilabel, top_k, zero_division)``.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores, MultilabelStatScores
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import ClassificationTask


def make_stat_scores_family(
    name: str,
    reduce: Callable,
    higher_is_better: bool = True,
    plot_lower_bound: float = 0.0,
    plot_upper_bound: float = 1.0,
) -> tuple:
    """Build ``(Binary<Name>, Multiclass<Name>, Multilabel<Name>, <Name>)`` module classes."""

    class _Binary(BinaryStatScores):
        def compute(self):
            tp, fp, tn, fn = self._final_state()
            return reduce(tp, fp, tn, fn, "binary", self.multidim_average, False, 1, self.zero_division)

    class _Multiclass(MulticlassStatScores):
        def compute(self):
            tp, fp, tn, fn = self._final_state()
            return reduce(tp, fp, tn, fn, self.average, self.multidim_average, False, self.top_k, self.zero_division)

    class _Multilabel(MultilabelStatScores):
        def compute(self):
            tp, fp, tn, fn = self._final_state()
            return reduce(tp, fp, tn, fn, self.average, self.multidim_average, True, 1, self.zero_division)

    class _Wrapper(_ClassificationTaskWrapper):
        def __new__(  # type: ignore[misc]
            cls,
            task: str,
            threshold: float = 0.5,
            num_classes: Optional[int] = None,
            num_labels: Optional[int] = None,
            average: Optional[str] = "micro",
            multidim_average: str = "global",
            top_k: Optional[int] = 1,
            ignore_index: Optional[int] = None,
            validate_args: bool = True,
            **kwargs: Any,
        ) -> Metric:
            task = ClassificationTask.from_str(task)
            kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
            if task == ClassificationTask.BINARY:
                return _Binary(threshold, **kwargs)
            if task == ClassificationTask.MULTICLASS:
                if not isinstance(num_classes, int):
                    raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
                if not isinstance(top_k, int):
                    raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
                return _Multiclass(num_classes, top_k, average, **kwargs)
            if task == ClassificationTask.MULTILABEL:
                if not isinstance(num_labels, int):
                    raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
                return _Multilabel(num_labels, threshold, average, **kwargs)
            raise ValueError(f"Not handled value: {task}")

    # bind the classes into the caller's module under their public names, so
    # pickling finds them (pickle looks classes up by __module__ + __qualname__)
    # and the state-spec fingerprint, which hashes the class name, matches JAX's
    caller_module = sys._getframe(1).f_globals.get("__name__", __name__)
    # JAX's runnable examples: perfect predictions give the family's best value
    perfect = "1.0" if higher_is_better else "0.0"
    examples = {
        "Binary": (
            ">>> metric = Binary{name}(device='cpu')\n"
            "    >>> metric.update(np.array([0, 1, 1, 0]), np.array([0, 1, 1, 0]))\n"
        ),
        "Multiclass": (
            ">>> metric = Multiclass{name}(num_classes=3, average='macro', device='cpu')\n"
            "    >>> metric.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1]))\n"
        ),
        "Multilabel": (
            ">>> metric = Multilabel{name}(num_labels=2, device='cpu')\n"
            "    >>> metric.update(np.array([[1, 0], [0, 1]]), np.array([[1, 0], [0, 1]]))\n"
        ),
    }
    for klass, prefix in ((_Binary, "Binary"), (_Multiclass, "Multiclass"), (_Multilabel, "Multilabel")):
        klass.__name__ = klass.__qualname__ = f"{prefix}{name}"
        klass.__module__ = caller_module
        klass.__doc__ = (
            f"{prefix} {name} module metric.\n\n"
            "    Example:\n"
            "    >>> import numpy as np\n"
            f"    >>> from {caller_module} import {prefix}{name}\n"
            f"    {examples[prefix].format(name=name)}"
            "    >>> round(float(metric.compute()), 4)\n"
            f"    {perfect}\n"
        )
        klass.higher_is_better = higher_is_better
        klass.plot_lower_bound = plot_lower_bound
        klass.plot_upper_bound = plot_upper_bound
    _Wrapper.__name__ = _Wrapper.__qualname__ = name
    _Wrapper.__module__ = caller_module
    _Wrapper.__doc__ = (
        f"Task-dispatching {name}.\n\n"
        "    Example:\n"
        "    >>> import numpy as np\n"
        f"    >>> from {caller_module} import {name}\n"
        f"    >>> metric = {name}(task='multiclass', num_classes=3, average='macro', device='cpu')\n"
        "    >>> metric.update(np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1]))\n"
        "    >>> round(float(metric.compute()), 4)\n"
        f"    {perfect}\n"
    )
    return _Binary, _Multiclass, _Multilabel, _Wrapper
