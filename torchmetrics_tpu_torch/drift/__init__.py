# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Data-drift detection over mergeable sketches (counterpart of
``torchmetrics_tpu/drift``).

Distribution-shift scores between a **pinned reference**
:class:`~torchmetrics_tpu_torch.sketch.HistogramSketch` and a **live
window**, plus distinct-count and heavy-hitter monitors over the HyperLogLog
and Count-Min sketches. Every state is an ordinary ``dist_reduce_fx="merge"``
sketch, so the family syncs, shards, fuses and checkpoints without new
machinery.
"""
from torchmetrics_tpu_torch.drift.metrics import Cardinality, DriftScore, HeavyHitters
from torchmetrics_tpu_torch.drift.scores import (
    DRIFT_SEVERITY_STATES,
    DriftScores,
    drift_scores,
    ks_statistic,
    psi_score,
    symmetric_kl,
)

__all__ = [
    "Cardinality",
    "DRIFT_SEVERITY_STATES",
    "DriftScore",
    "DriftScores",
    "HeavyHitters",
    "drift_scores",
    "ks_statistic",
    "psi_score",
    "symmetric_kl",
]
