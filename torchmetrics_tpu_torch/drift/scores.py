# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Distribution-shift scores between two fixed-bin histograms (counterpart of
``torchmetrics_tpu/drift/scores.py``).

All three scores compare a *reference* :class:`HistogramSketch` (pinned at
deployment time) against a *live* one (the current window) sharing the same
bin edges, over ``bins + 2`` cells: the in-range bins plus the ``low`` and
``high`` out-of-range tallies, since mass leaving the reference range is
exactly the drift signal. PSI and symmetric KL divide by bin mass, so both
probability vectors are floored at ``eps`` and renormalized first; KS uses
the raw proportions. If EITHER side has folded zero values every score is
``0.0``: an empty window is "no evidence of drift", not "maximal drift".
They are plain tensor code on the two count vectors, so they run inside a
captured step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from torchmetrics_tpu_torch.sketch.histogram import HistogramSketch

Tensor = torch.Tensor

#: severity ladder published by ``DriftScore.serve_gauges``: 0 ok, 1 warn, 2 critical
DRIFT_SEVERITY_STATES = ("ok", "warn", "critical")


class DriftScores(NamedTuple):
    """The three shift scores as 0-d float32 tensors."""

    psi: Tensor
    kl: Tensor
    ks: Tensor


def _check_edges(reference: HistogramSketch, live: HistogramSketch) -> None:
    if reference.edges.shape != live.edges.shape:
        raise ValueError(
            "drift scores need histograms with identical bin edges:"
            f" {tuple(reference.edges.shape)} vs {tuple(live.edges.shape)}"
        )


def _raw_proportions(state: HistogramSketch) -> Tensor:
    """(bins+2,) proportion vector ``[low, counts..., high] / count``."""
    cells = torch.cat([state.low.reshape(1), state.counts, state.high.reshape(1)]).to(torch.float32)
    return cells / torch.clamp(state.count, min=1).to(torch.float32)


def _floored_proportions(state: HistogramSketch, eps: float) -> Tensor:
    p = torch.clamp(_raw_proportions(state), min=eps)
    return p / torch.sum(p)


def _both_nonempty(reference: HistogramSketch, live: HistogramSketch) -> Tensor:
    return (reference.count > 0) & (live.count > 0)


def _psi(reference: HistogramSketch, live: HistogramSketch, eps: float) -> Tensor:
    p = _floored_proportions(live, eps)
    q = _floored_proportions(reference, eps)
    return torch.sum((p - q) * torch.log(p / q))


def _ks(reference: HistogramSketch, live: HistogramSketch) -> Tensor:
    p = torch.cumsum(_raw_proportions(live), 0)
    q = torch.cumsum(_raw_proportions(reference), 0)
    return torch.max(torch.abs(p - q))


def psi_score(reference: HistogramSketch, live: HistogramSketch, eps: float = 1e-6) -> Tensor:
    """Population Stability Index ``sum((p_live - p_ref) * ln(p_live/p_ref))``.
    Common operating points: < 0.1 stable, 0.1-0.25 moderate shift, > 0.25
    action required."""
    _check_edges(reference, live)
    return torch.where(_both_nonempty(reference, live), _psi(reference, live, eps), 0.0)


def symmetric_kl(reference: HistogramSketch, live: HistogramSketch, eps: float = 1e-6) -> Tensor:
    """Symmetrized KL divergence ``(KL(live||ref) + KL(ref||live)) / 2``
    (PSI / 2 on the same floored bins)."""
    return 0.5 * psi_score(reference, live, eps)


def ks_statistic(reference: HistogramSketch, live: HistogramSketch) -> Tensor:
    """Kolmogorov-Smirnov statistic ``max |CDF_ref - CDF_live|`` at the bin
    edges (the exact KS of the binned distributions)."""
    _check_edges(reference, live)
    return torch.where(_both_nonempty(reference, live), _ks(reference, live), 0.0)


def drift_scores(reference: HistogramSketch, live: HistogramSketch, eps: float = 1e-6) -> DriftScores:
    """All three scores in one call."""
    _check_edges(reference, live)
    nonempty = _both_nonempty(reference, live)
    psi = _psi(reference, live, eps)
    ks = _ks(reference, live)
    return DriftScores(
        psi=torch.where(nonempty, psi, 0.0),
        kl=torch.where(nonempty, 0.5 * psi, 0.0),
        ks=torch.where(nonempty, ks, 0.0),
    )
