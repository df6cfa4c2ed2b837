# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Bounded-memory mergeable sketches (counterpart of ``torchmetrics_tpu/sketch``).

Every ``dist_reduce_fx="cat"`` metric state grows with the stream. The
sketches here trade exactness for **fixed-shape state with hard error
bounds**, each exposing the same four pure functions:

    init(...) -> State            # fixed-shape NamedTuple of tensors
    update(State, x) -> State     # shape-preserving
    merge(State, State) -> State  # shape-preserving, associative/commutative
                                  # (up to floating point)
    query(State, ...) -> value    # quantile/cdf/mean/sample/...

``merge`` is what plugs them into the metric runtime: states registered with
``add_state(..., dist_reduce_fx="merge")`` sync across ranks by pairwise
merge, reduce across a mesh in the sharded update, ride the fused plan's
carry and checkpoint with per-leaf validation; see
:mod:`torchmetrics_tpu_torch.sketch.registry`. Every state is the JAX
package's leaf for leaf (names, dtypes, shapes, values), so checkpoints read
across the two packages. ``init`` functions take a ``device`` (the card
unless the caller asks for the CPU); updates and merges run where the state
lies.

Sketches: :class:`KLLSketch` (quantiles and ranks with a deterministic
rank-error bound), :class:`HistogramSketch` (fixed bins, exact merge),
:class:`ReservoirSketch` (uniform sample, JAX's threefry key threaded through
the state), :class:`MomentsSketch` (Chan/Welford count, mean, M2),
:class:`HLLSketch` (HyperLogLog distinct count) and :class:`CountMinSketch`
(frequency grid and heavy-hitter table; the table's scan is the hand kernel
K3 on the card).
"""
from torchmetrics_tpu_torch.sketch.countmin import (
    CountMinSketch,
    cm_error_bound,
    cm_heavy_hitters,
    cm_init,
    cm_merge,
    cm_point_query,
    cm_state_bytes,
    cm_update,
)
from torchmetrics_tpu_torch.sketch.histogram import (
    HistogramSketch,
    hist_cdf,
    hist_counts,
    hist_init,
    hist_merge,
    hist_quantile,
    hist_update,
)
from torchmetrics_tpu_torch.sketch.hll import (
    MAX_PRECISION,
    MIN_PRECISION,
    HLLSketch,
    hll_cardinality,
    hll_error_bound,
    hll_init,
    hll_merge,
    hll_precision,
    hll_state_bytes,
    hll_update,
)
from torchmetrics_tpu_torch.sketch.moments import (
    MomentsSketch,
    moments_count,
    moments_init,
    moments_mean,
    moments_merge,
    moments_std,
    moments_update,
    moments_variance,
)
from torchmetrics_tpu_torch.sketch.quantile import (
    MAX_STREAM,
    KLLSketch,
    kll_cdf,
    kll_error_bound,
    kll_geometry,
    kll_init,
    kll_levels_for,
    kll_merge,
    kll_quantile,
    kll_rank,
    kll_state_bytes,
    kll_update,
)
from torchmetrics_tpu_torch.sketch.registry import (
    is_sketch_state,
    merge_states,
    reduce_merge_states,
    register_sketch_state,
    registered_sketch_classes,
    sketch_state_class,
)
from torchmetrics_tpu_torch.sketch.reservoir import (
    ReservoirSketch,
    reservoir_init,
    reservoir_merge,
    reservoir_sample,
    reservoir_update,
)

__all__ = [
    "CountMinSketch",
    "HLLSketch",
    "HistogramSketch",
    "KLLSketch",
    "MAX_PRECISION",
    "MAX_STREAM",
    "MIN_PRECISION",
    "MomentsSketch",
    "ReservoirSketch",
    "cm_error_bound",
    "cm_heavy_hitters",
    "cm_init",
    "cm_merge",
    "cm_point_query",
    "cm_state_bytes",
    "cm_update",
    "hist_cdf",
    "hist_counts",
    "hist_init",
    "hist_merge",
    "hist_quantile",
    "hist_update",
    "hll_cardinality",
    "hll_error_bound",
    "hll_init",
    "hll_merge",
    "hll_precision",
    "hll_state_bytes",
    "hll_update",
    "is_sketch_state",
    "kll_cdf",
    "kll_error_bound",
    "kll_geometry",
    "kll_init",
    "kll_levels_for",
    "kll_merge",
    "kll_quantile",
    "kll_rank",
    "kll_state_bytes",
    "kll_update",
    "merge_states",
    "moments_count",
    "moments_init",
    "moments_mean",
    "moments_merge",
    "moments_std",
    "moments_update",
    "moments_variance",
    "reduce_merge_states",
    "register_sketch_state",
    "registered_sketch_classes",
    "reservoir_init",
    "reservoir_merge",
    "reservoir_sample",
    "reservoir_update",
    "sketch_state_class",
]
