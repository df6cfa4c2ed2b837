# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The flagship suite as one step function, the counterpart of ``__graft_entry__.entry``.

:func:`entry` returns ``(fn, example_args)``: ``fn(preds, target)`` evaluates
accuracy + macro-F1 + binned macro-AUROC over one batch of multiclass logits
(C=8, T=32, N=256) through the same functional pieces as the JAX entry, so
the stat scores (argmax fused) go through kernel K2 and the binned curve
through K1 on the card. The example arguments are numpy arrays from the same seed as
the JAX entry's. ``fn`` moves its inputs to the entry's device, the card
unless the caller asks for ``device="cpu"``; as with the module metrics,
:func:`entry` raises when no CUDA device exists and the CPU was not asked
for.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.auroc import _multiclass_auroc_compute
from torchmetrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_update,
    _uniform_grid,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_update,
)
from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utilities.compute import _linspace_like_jax
from torchmetrics_tpu_torch.utilities.data import _to_tensor

NUM_CLASSES = 8
NUM_THRESHOLDS = 32
BATCH = 256


def entry(
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Callable[..., Dict[str, torch.Tensor]], Tuple[np.ndarray, np.ndarray]]:
    """Return ``(fn, example_args)`` — the metric-suite step on one batch, on ``device``."""
    device = resolve_device(device, "entry")
    num_classes = NUM_CLASSES
    thresholds = _linspace_like_jax(0.0, 1.0, NUM_THRESHOLDS, device=device)
    affine = _uniform_grid(NUM_THRESHOLDS)  # fixed with the grid, on the host

    def suite_step(preds, target) -> Dict[str, torch.Tensor]:
        preds, target = _to_tensor(preds, device), _to_tensor(target, device)
        p, t = _multiclass_stat_scores_format(preds, target, top_k=1, average="macro")
        tp, fp, tn, fn = _multiclass_stat_scores_update(p, t, num_classes, average="macro")
        cp, ct, _ = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds)
        curve = _multiclass_precision_recall_curve_update(cp, ct, num_classes, thresholds, ascending=True, affine=affine)
        return {
            "accuracy": tp.sum() / torch.clamp((tp + fn).sum(), min=1),
            "f1_macro": _fbeta_reduce(tp, fp, tn, fn, 1.0, "macro", "global", False, 0),
            "auroc_macro": _multiclass_auroc_compute(curve, num_classes, "macro", thresholds),
        }

    rng = np.random.default_rng(0)
    preds = rng.standard_normal((BATCH, num_classes)).astype(np.float32)
    target = rng.integers(0, num_classes, size=(BATCH,)).astype(np.int32)
    return suite_step, (preds, target)
