# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Functional retrieval metrics (counterpart of ``torchmetrics_tpu/functional/retrieval``)."""
from torchmetrics_tpu_torch.functional.retrieval.metrics import (
    retrieval_auroc,
    retrieval_average_precision,
    retrieval_fall_out,
    retrieval_hit_rate,
    retrieval_normalized_dcg,
    retrieval_precision,
    retrieval_precision_recall_curve,
    retrieval_r_precision,
    retrieval_recall,
    retrieval_reciprocal_rank,
)

__all__ = [
    "retrieval_auroc",
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
