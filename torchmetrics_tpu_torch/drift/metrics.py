# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Drift, cardinality and heavy-hitter metrics over mergeable sketches
(counterpart of ``torchmetrics_tpu/drift/metrics.py``).

All three are ordinary :class:`~torchmetrics_tpu_torch.metric.Metric`
subclasses whose only states are ``dist_reduce_fx="merge"`` sketches, so
replica sync, the sharded update, the fused plan, the captured step and
checkpoints apply without new state kinds.

:class:`DriftScore` (and :class:`Cardinality`) keep host-side serve gauges:
an eager update refreshes a cached float dict that :meth:`serve_gauges`
returns without touching the device. Updates inside a fused plan's step or
a CUDA graph capture skip the cache (the JAX package skips it under trace);
the scores stay available through ``compute``. A served stream
(``serve/stream.py``) publishes them as the ``drift.<name>.*`` gauges.
Sliced over cohort cells
(``DriftScore(...).sliced(num_cells=...)``), the live histograms fold by
segment and ``compute_all`` scores every cohort at once.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.drift.scores import DriftScores, drift_scores
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.robustness.spec import SKETCH_PAYLOAD_KEY, _owned_tensor
from torchmetrics_tpu_torch.sketch.countmin import cm_heavy_hitters, cm_init, cm_point_query, cm_update
from torchmetrics_tpu_torch.sketch.histogram import HistogramSketch, hist_init, hist_update
from torchmetrics_tpu_torch.sketch.hll import hll_cardinality, hll_error_bound, hll_init, hll_update
from torchmetrics_tpu_torch.sketch.registry import map_leaves
from torchmetrics_tpu_torch.utilities.checks import _in_fused_step, _is_concrete
from torchmetrics_tpu_torch.utilities.data import _to_tensor, resolve_device

Tensor = torch.Tensor

#: default thresholds: the industry PSI operating points (warn at "moderate
#: shift", critical at "action required")
DEFAULT_THRESHOLDS: Dict[str, Tuple[float, float]] = {"psi": (0.1, 0.25)}


def _eager(x: Tensor) -> bool:
    """Whether a host cache may read ``x`` now: not inside a fused step or a capture."""
    return _is_concrete(x) and not _in_fused_step()


def reference_from_checkpoint(
    checkpoint: Mapping[str, Any],
    metric_path: Optional[str] = None,
    state_name: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> HistogramSketch:
    """Extract a pinned reference histogram from a checkpoint payload of either
    package (``save_checkpoint``'s dict, where sketch states are
    ``{"__sketch__": class, "leaves": {...}}`` entries).

    The first serialized ``HistogramSketch`` found is decoded; narrow the
    search with ``metric_path`` (the checkpoint's metric-walk key, ``""`` for
    a bare metric) and/or ``state_name``. Leaves are copied onto ``device``
    (the card unless the caller asks for the CPU).
    """
    metrics = checkpoint.get("metrics")
    if not isinstance(metrics, Mapping):
        raise ValueError("not a checkpoint payload: missing 'metrics' dict")
    device = resolve_device(device, "reference_from_checkpoint")
    paths = [metric_path] if metric_path is not None else sorted(metrics)
    for path in paths:
        entry = metrics.get(path)
        if not isinstance(entry, Mapping):
            continue
        state = entry.get("state", {})
        names = [state_name] if state_name is not None else sorted(state)
        for name in names:
            payload = state.get(name)
            if isinstance(payload, Mapping) and payload.get(SKETCH_PAYLOAD_KEY) == HistogramSketch.__name__:
                leaves = payload["leaves"]
                return HistogramSketch(*[_owned_tensor(leaves[f], device) for f in HistogramSketch._fields])
    raise ValueError(
        f"no serialized HistogramSketch state found (metric_path={metric_path!r},"
        f" state_name={state_name!r}) — is this a histogram-bearing checkpoint?"
    )


def _empty_like(reference: HistogramSketch) -> HistogramSketch:
    """A zeroed live histogram sharing the reference's bin edges exactly."""
    zero = torch.zeros((), dtype=torch.int32, device=reference.edges.device)
    return HistogramSketch(
        edges=reference.edges.clone(), counts=torch.zeros_like(reference.counts), low=zero, high=zero.clone(), count=zero.clone()
    )


class DriftScore(Metric):
    """PSI / symmetric-KL / KS drift of a live stream against a pinned
    reference distribution.

    The **reference** is a constructor constant (a :class:`HistogramSketch`,
    a raw sample binned at init, or a checkpoint payload via
    ``reference_checkpoint`` / :func:`reference_from_checkpoint`): it never
    syncs or resets. The only registered state is the **live** histogram
    (``"merge"``).

    ``thresholds`` maps score names (``"psi"``/``"kl"``/``"ks"``) to a
    ``(warn, critical)`` pair (or a single critical float). After
    ``patience`` *consecutive* eager updates breach a threshold the published
    severity escalates (0 ok / 1 warn / 2 critical), and it drops back the
    moment the scores recover.

    Args:
        reference: pinned reference, a ``HistogramSketch`` or a sample.
        bins, lo, hi: histogram geometry when ``reference`` is a sample.
        eps: probability floor for the PSI/KL bins.
        thresholds: score-name -> (warn, critical) map; default PSI 0.1/0.25.
        patience: consecutive breaching updates before severity escalates.
        reference_checkpoint: checkpoint payload to load the reference from
            (with optional ``reference_path``/``reference_state``).
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        reference: Optional[Union[HistogramSketch, Tensor, Sequence[float]]] = None,
        bins: int = 64,
        lo: float = 0.0,
        hi: float = 1.0,
        eps: float = 1e-6,
        thresholds: Optional[Mapping[str, Union[float, Tuple[float, float]]]] = None,
        patience: int = 3,
        reference_checkpoint: Optional[Mapping[str, Any]] = None,
        reference_path: Optional[str] = None,
        reference_state: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reference_checkpoint is not None:
            if reference is not None:
                raise ValueError("pass either `reference` or `reference_checkpoint`, not both")
            reference = reference_from_checkpoint(reference_checkpoint, reference_path, reference_state, device=self._device)
        if reference is None:
            raise ValueError("DriftScore needs a pinned reference (sketch, sample array, or checkpoint)")
        if isinstance(reference, HistogramSketch):
            reference = map_leaves(lambda leaf: leaf.to(self._device, copy=True), reference)
        else:
            sample = _to_tensor(reference, self._device).to(torch.float32)
            reference = hist_update(hist_init(bins, lo, hi, device=self._device), sample)
        self.reference = reference
        self.eps = float(eps)
        if patience < 1:
            raise ValueError(f"need patience >= 1, got {patience}")
        self.patience = int(patience)
        self.thresholds: Dict[str, Tuple[float, float]] = {}
        for name, bound in dict(DEFAULT_THRESHOLDS if thresholds is None else thresholds).items():
            if name not in ("psi", "kl", "ks"):
                raise ValueError(f"unknown drift score {name!r} in thresholds (want psi/kl/ks)")
            warn, crit = bound if isinstance(bound, (tuple, list)) else (bound, bound)
            self.thresholds[name] = (float(warn), float(crit))
        self.add_state("live", default=_empty_like(reference), dist_reduce_fx="merge")
        self._breach_run = 0
        self._gauge_cache: Dict[str, float] = {"psi": 0.0, "kl": 0.0, "ks": 0.0, "severity": 0.0}

    def update(self, value: Union[float, Tensor]) -> None:
        """Fold a batch into the live histogram; refresh the serve gauges when eager."""
        self.live = hist_update(self.live, _to_tensor(value, self._device).to(torch.float32))
        if _eager(self.live.count):
            self._refresh_gauges()

    def compute(self) -> DriftScores:
        """The three scores of the live window against the reference."""
        return drift_scores(self.reference, self.live, self.eps)

    def _raw_severity(self, scores: Mapping[str, float]) -> int:
        sev = 0
        for name, (warn, crit) in self.thresholds.items():
            v = scores[name]
            if v >= crit:
                sev = max(sev, 2)
            elif v >= warn:
                sev = max(sev, 1)
        return sev

    def _refresh_gauges(self) -> None:
        s = drift_scores(self.reference, self.live, self.eps)
        scores = {"psi": float(s.psi), "kl": float(s.kl), "ks": float(s.ks)}
        raw = self._raw_severity(scores)
        self._breach_run = self._breach_run + 1 if raw > 0 else 0
        # severity is sustained-only: it needs `patience` consecutive
        # breaching updates to escalate, but recovers immediately
        scores["severity"] = float(raw if self._breach_run >= self.patience else 0)
        self._gauge_cache = scores

    def severity(self) -> int:
        """Current published severity (0 ok / 1 warn / 2 critical)."""
        return int(self._gauge_cache["severity"])

    def serve_gauges(self) -> Dict[str, float]:
        """Host-cached gauges for the serve plane (``drift.<stream>.*``)."""
        return dict(self._gauge_cache)

    def reset(self) -> None:
        super().reset()
        self._breach_run = 0
        self._gauge_cache = {"psi": 0.0, "kl": 0.0, "ks": 0.0, "severity": 0.0}

    def _apply(self, fn: Any) -> None:
        super()._apply(fn)
        self.reference = map_leaves(fn, self.reference)


class Cardinality(Metric):
    """Approximate distinct count via HyperLogLog: ``2**precision * 4`` bytes
    of mergeable state with relative error ``1.04/sqrt(2**precision)``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, precision: int = 12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.precision = int(precision)
        self.add_state("sketch", default=hll_init(self.precision, device="cpu"), dist_reduce_fx="merge")
        self._gauge_cache: Dict[str, float] = {"cardinality": 0.0}

    def update(self, value: Tensor) -> None:
        self.sketch = hll_update(self.sketch, _to_tensor(value, self._device))
        if _eager(self.sketch.count):
            self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        self._gauge_cache = {"cardinality": float(hll_cardinality(self.sketch))}

    def compute(self) -> Tensor:
        """Bias-corrected distinct-count estimate."""
        return hll_cardinality(self.sketch)

    def error_bound(self) -> float:
        """Relative standard error of :meth:`compute` (``1.04/sqrt(m)``)."""
        return hll_error_bound(self.sketch)

    def serve_gauges(self) -> Dict[str, float]:
        return dict(self._gauge_cache)


class HeavyHitters(Metric):
    """Top-``k`` most frequent tags via Count-Min and a candidate table: hot
    keys over an unbounded stream in fixed memory. On the card the table's
    scan over each batch is the hand kernel K3."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, depth: int = 4, width: int = 1024, k: int = 32, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.depth, self.width, self.k = int(depth), int(width), int(k)
        self.add_state("sketch", default=cm_init(self.depth, self.width, self.k, device="cpu"), dist_reduce_fx="merge")

    def update(self, value: Tensor) -> None:
        self.sketch = cm_update(self.sketch, _to_tensor(value, self._device))

    def compute(self) -> Tuple[Tensor, Tensor]:
        """``(keys, counts)`` sorted by count desc (count 0 = empty slot)."""
        return cm_heavy_hitters(self.sketch)

    def count_of(self, value: Tensor) -> Tensor:
        """Point estimate(s) for specific tag(s), never below the truth."""
        return cm_point_query(self.sketch, _to_tensor(value, self._device))
