# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

- :func:`binned_curve_state` (K1, ``csrc/binned_curve_state.cu``): the binned
  multi-threshold confusion state of the precision-recall curve family.
- :func:`stat_counts` (K2, ``csrc/stat_counts.cu``): the argmax, the
  confusion counts and the tp/fp/tn/fn of the multiclass stat-scores family.
- :func:`cm_track` (K3, ``csrc/cm_track.cu``): the Count-Min sketch's
  heavy-hitter table after a batch of tags, a dependent scan over the tags.

Each wrapper counts its kernel launches in its ``launches`` attribute. A
CUDA graph that holds a launch replays it without the wrapper, so a count
moves when a capture records the launch and never at a replay; a profiler
trace counts the replays' launches.
"""
from torchmetrics_tpu_torch.ops.binned_curve_state import binned_curve_state, binned_curve_state_plain
from torchmetrics_tpu_torch.ops.cm_track import cm_track, cm_track_plain
from torchmetrics_tpu_torch.ops.stat_counts import stat_counts, stat_counts_plain

#: every kernel wrapper of the port, by kernel name
KERNELS = {"binned_curve_state": binned_curve_state, "stat_counts": stat_counts, "cm_track": cm_track}

__all__ = [
    "KERNELS",
    "binned_curve_state",
    "binned_curve_state_plain",
    "cm_track",
    "cm_track_plain",
    "stat_counts",
    "stat_counts_plain",
]
