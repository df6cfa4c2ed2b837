# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The collection plane of the port (counterpart of ``torchmetrics_tpu/parallel``).

- :mod:`~torchmetrics_tpu_torch.parallel.fused`: a whole ``MetricCollection``'s
  update as one step on an in-place state carry, captured as one CUDA graph
  on the card (``MetricCollection.fused()``);
- :mod:`~torchmetrics_tpu_torch.parallel.cat_buffer`: fixed-capacity append
  buffers that carry list ("cat") states through that step;
- :mod:`~torchmetrics_tpu_torch.parallel.feed`: the double-buffered
  host→device batch feed;
- :mod:`~torchmetrics_tpu_torch.parallel.sharded`: sharded updates over a
  ``torch.distributed`` device mesh (``sharded_update``, ``ShardedMetric``),
  the partial-state merges under them, and the one-metric captured step
  (``make_jit_update``, ``fold_jit_state``);
- :mod:`~torchmetrics_tpu_torch.parallel.sliced`: the sliced plane, one step
  per batch for thousands of cohort cells (``SlicedPlan``,
  ``Metric.sliced``, ``MetricCollection.sliced``);
- :mod:`~torchmetrics_tpu_torch.parallel.windowing`: tumbling and sliding
  windows as a ring of mergeable state snapshots (``WindowRing``).
"""
from torchmetrics_tpu_torch.parallel.cat_buffer import (
    CatBuffer,
    cat_buffer_all_gather,
    cat_buffer_append,
    cat_buffer_init,
    cat_buffer_merge,
    cat_buffer_values,
)
from torchmetrics_tpu_torch.parallel.feed import DeviceFeed
from torchmetrics_tpu_torch.parallel.fused import FusedCollectionPlan, fusion_ineligibility, fusion_report
from torchmetrics_tpu_torch.parallel.sharded import (
    ShardedMetric,
    deep_reductions,
    deep_state_tree,
    fold_jit_state,
    make_jit_update,
    make_sharded_update,
    mesh_reduce_tree,
    metric_merge,
    sharded_update,
    tree_merge,
)
from torchmetrics_tpu_torch.parallel.sliced import (
    SlicedPlan,
    SliceTable,
    slice_key_reason,
    slice_table_size_reason,
    sliced_ineligibility,
)
from torchmetrics_tpu_torch.parallel.windowing import WindowRing

__all__ = [
    "CatBuffer",
    "DeviceFeed",
    "FusedCollectionPlan",
    "ShardedMetric",
    "SliceTable",
    "SlicedPlan",
    "WindowRing",
    "cat_buffer_all_gather",
    "cat_buffer_append",
    "cat_buffer_init",
    "cat_buffer_merge",
    "cat_buffer_values",
    "deep_reductions",
    "deep_state_tree",
    "fold_jit_state",
    "fusion_ineligibility",
    "fusion_report",
    "make_jit_update",
    "make_sharded_update",
    "mesh_reduce_tree",
    "metric_merge",
    "sharded_update",
    "slice_key_reason",
    "slice_table_size_reason",
    "sliced_ineligibility",
    "tree_merge",
]
