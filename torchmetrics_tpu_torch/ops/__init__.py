# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

- :func:`binned_curve_state` (K1, ``csrc/binned_curve_state.cu``): the binned
  multi-threshold confusion state of the precision-recall curve family;
  :func:`binned_curve_state_segmented` (K1s) the same per cohort cell.
- :func:`stat_counts` (K2, ``csrc/stat_counts.cu``): the argmax, the
  confusion counts and the tp/fp/tn/fn of the multiclass stat-scores family;
  :func:`stat_counts_segmented` (K2s) the same per cohort cell.
- :func:`cm_track` (K3, ``csrc/cm_track.cu``): the Count-Min sketch's
  heavy-hitter table after a batch of tags, a dependent scan over the tags.
- :func:`slice_assign` (K4, ``csrc/slice_assign.cu``): the sliced plan's
  slice table, a batch of cohort keys placed in it.
- :func:`biquad_cascade` (K5, ``csrc/biquad.cu``): SRMR's IIR filter
  banks, rows of samples through a cascade of biquads along time.
- :func:`coco_match` (K6, ``csrc/coco_match.cu``): COCO's greedy matching
  of score-ordered detections to ground truths, the mAP's hot loop.
- :func:`window_moments` (K7, ``csrc/window_moments.cu``): the five windowed
  moments of two image stacks, the filter of SSIM, MS-SSIM, UQI, VIF and SCC.
- :func:`token_nll` (K8, ``csrc/token_nll.cu``): each row's negative
  log-likelihood of its target under the softmax of its logits, Perplexity's
  update, in one read of the logits.

Each wrapper counts its kernel launches in its ``launches`` attribute. A
CUDA graph that holds a launch replays it without the wrapper, so a count
moves when a capture records the launch and never at a replay; a profiler
trace counts the replays' launches.
"""
from torchmetrics_tpu_torch.ops.binned_curve_state import (
    binned_curve_state,
    binned_curve_state_plain,
    binned_curve_state_segmented,
    binned_curve_state_segmented_plain,
)
from torchmetrics_tpu_torch.ops.biquad import biquad_cascade, biquad_cascade_plain
from torchmetrics_tpu_torch.ops.cm_track import cm_track, cm_track_plain
from torchmetrics_tpu_torch.ops.coco_match import coco_match, coco_match_plain
from torchmetrics_tpu_torch.ops.slice_assign import slice_assign, slice_assign_plain
from torchmetrics_tpu_torch.ops.stat_counts import (
    stat_counts,
    stat_counts_plain,
    stat_counts_segmented,
    stat_counts_segmented_plain,
)
from torchmetrics_tpu_torch.ops.token_nll import token_nll, token_nll_plain
from torchmetrics_tpu_torch.ops.window_moments import window_moments, window_moments_plain

#: every kernel wrapper of the port, by kernel name
KERNELS = {
    "binned_curve_state": binned_curve_state,
    "stat_counts": stat_counts,
    "cm_track": cm_track,
    "binned_curve_state_segmented": binned_curve_state_segmented,
    "stat_counts_segmented": stat_counts_segmented,
    "slice_assign": slice_assign,
    "biquad_cascade": biquad_cascade,
    "coco_match": coco_match,
    "window_moments": window_moments,
    "token_nll": token_nll,
}

__all__ = [
    "KERNELS",
    "biquad_cascade",
    "biquad_cascade_plain",
    "binned_curve_state",
    "binned_curve_state_plain",
    "binned_curve_state_segmented",
    "binned_curve_state_segmented_plain",
    "cm_track",
    "cm_track_plain",
    "coco_match",
    "coco_match_plain",
    "slice_assign",
    "slice_assign_plain",
    "stat_counts",
    "stat_counts_plain",
    "stat_counts_segmented",
    "stat_counts_segmented_plain",
    "token_nll",
    "token_nll_plain",
    "window_moments",
    "window_moments_plain",
]
