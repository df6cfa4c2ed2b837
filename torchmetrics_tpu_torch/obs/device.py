# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Device telemetry: a fixed-shape health state riding the captured step
(counterpart of ``torchmetrics_tpu/obs/device.py``).

The host-side tracing of :mod:`~torchmetrics_tpu_torch.obs.trace` stops at
the graph boundary: once ``make_jit_update``, ``sharded_update`` or a fused
plan hand a batch to a captured CUDA graph, the whole step is one replay.
This module puts a small **fixed-shape telemetry state**
(:class:`TelemetryState`) INSIDE that step: per-input NaN/Inf counts,
min/max/absmax gauges, an update counter and an optional fixed-bin value
histogram (riding :class:`~torchmetrics_tpu_torch.sketch.histogram.HistogramSketch`).
The state is an extra carry of the step, written in place like the metric
states and reduced with the metric's own collectives over a mesh, so the
per-batch cost is a handful of elementwise reductions on the device and **no
host read**: the accumulated state is only read ("drained") into ordinary
obs gauges (``device.<Metric>.nan_count``, ``device.<Metric>.in0.min``, ...)
at ``compute()``/``sync()`` boundaries.

**The build-time contract.** Telemetry is gated by a module-level flag
(:data:`ENABLED`, env ``TM_TPU_DEVICE_TELEMETRY=1`` or
:func:`enable`/:func:`device_telemetry`) read when the step is BUILT
(``make_jit_update``, ``make_sharded_update``, ``suite.fused()``), never
inside the step. With the flag off, a step's build never calls this
module's update functions, so the captured graph is the one a
never-instrumented build captures. The flag and the histogram config are part of the step's
build key (:func:`config_token`), so flipping them never lets a step built
one way serve the other.

Unlike the rest of ``torchmetrics_tpu_torch.obs`` this module imports torch;
it is therefore NOT imported by ``obs/__init__.py``.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.sketch.histogram import HistogramSketch, hist_init, hist_merge, hist_quantile, hist_update

from . import counters as _counters
from . import trace as _trace

Tensor = torch.Tensor

#: THE flag read when a step is built (never inside the step).
#: Flip via enable()/disable()/device_telemetry().
ENABLED: bool = os.environ.get("TM_TPU_DEVICE_TELEMETRY", "0") == "1"

#: optional fixed-bin histogram config for input 0: (bins, lo, hi) or None
_HISTOGRAM: Optional[Tuple[int, float, float]] = None


def _env_histogram() -> Optional[Tuple[int, float, float]]:
    """``TM_TPU_DEVICE_TELEMETRY_HIST=bins:lo:hi`` (e.g. ``64:-10:10``)."""
    raw = os.environ.get("TM_TPU_DEVICE_TELEMETRY_HIST", "")
    if not raw:
        return None
    try:
        bins, lo, hi = raw.split(":")
        return (int(bins), float(lo), float(hi))
    except ValueError:
        return None


if ENABLED:
    _HISTOGRAM = _env_histogram()


def enable(histogram: Optional[Tuple[int, float, float]] = None) -> None:
    """Turn device telemetry on for steps built AFTER this call.

    ``histogram=(bins, lo, hi)`` additionally folds input 0's values into a
    fixed-bin :class:`HistogramSketch` inside the step.
    """
    global ENABLED, _HISTOGRAM
    ENABLED = True
    _HISTOGRAM = histogram


def disable() -> None:
    global ENABLED, _HISTOGRAM
    ENABLED = False
    _HISTOGRAM = None


def is_enabled() -> bool:
    return ENABLED


def config_token() -> Tuple:
    """Hashable build config: part of a step's build key, so a flag or
    histogram flip builds a new step."""
    return (ENABLED, _HISTOGRAM)


@contextmanager
def device_telemetry(histogram: Optional[Tuple[int, float, float]] = None) -> Iterator[None]:
    """Scoped enable: ``with device_telemetry(): step, init = make_jit_update(m)``.

    Only affects steps BUILT inside the scope (the flag is read at build
    time); restores the previous flag and histogram config on exit.
    """
    global ENABLED, _HISTOGRAM
    prev = (ENABLED, _HISTOGRAM)
    ENABLED, _HISTOGRAM = True, histogram
    try:
        yield
    finally:
        ENABLED, _HISTOGRAM = prev


# ---------------------------------------------------------------- the state


class TelemetryState(NamedTuple):
    """Fixed-shape per-step health accumulator.

    All per-input fields have shape ``(n_inputs,)``; ``n_inputs`` is fixed
    when the step is built. NaN/Inf counts are exact; min/max/absmax track
    FINITE values only (a NaN cannot poison the gauges). ``hist`` is ``None``
    unless a histogram was configured.
    """

    nan_count: Tensor  #: (n,) int32 — exact count of NaN elements seen per input
    inf_count: Tensor  #: (n,) int32 — exact count of +/-Inf elements per input
    elems: Tensor  #: (n,) int32 — total elements folded per input
    min_val: Tensor  #: (n,) float32 — min over finite elements (+inf when none)
    max_val: Tensor  #: (n,) float32 — max over finite elements (-inf when none)
    absmax: Tensor  #: (n,) float32 — max |x| over finite elements (0 when none)
    updates: Tensor  #: () int32 — update steps folded in
    hist: Optional[HistogramSketch]  #: optional fixed-bin histogram of input 0


def telemetry_init(
    n_inputs: int, histogram: Optional[Tuple[int, float, float]] = None, device: Any = "cuda"
) -> TelemetryState:
    """Empty telemetry state for a step taking ``n_inputs`` batch tensors, on
    ``device`` (the card unless the caller asks for the CPU)."""
    if n_inputs < 1:
        raise ValueError(f"need n_inputs >= 1, got {n_inputs}")
    device = torch.device(device)
    return TelemetryState(
        nan_count=torch.zeros((n_inputs,), dtype=torch.int32, device=device),
        inf_count=torch.zeros((n_inputs,), dtype=torch.int32, device=device),
        elems=torch.zeros((n_inputs,), dtype=torch.int32, device=device),
        min_val=torch.full((n_inputs,), float("inf"), dtype=torch.float32, device=device),
        max_val=torch.full((n_inputs,), float("-inf"), dtype=torch.float32, device=device),
        absmax=torch.zeros((n_inputs,), dtype=torch.float32, device=device),
        updates=torch.zeros((), dtype=torch.int32, device=device),
        hist=None if histogram is None else hist_init(*histogram, device=device),
    )


def telemetry_update(state: TelemetryState, inputs: Sequence[Any]) -> TelemetryState:
    """Fold one batch's input tensors in (pure, capture-safe, shape-preserving).

    Every input is folded. Inputs beyond the state's ``n_inputs`` slots (an
    under-declared ``*args`` update signature) collapse into the LAST slot,
    so the TOTAL nan/inf/element counts stay exact even when per-input
    attribution cannot. Non-float inputs contribute exact min/max and zero
    NaN/Inf. NaNs fold into the histogram's total count but (by IEEE
    comparison) land in neither a bin nor the out-of-range tallies.
    """
    n = state.nan_count.shape[0]
    device = state.nan_count.device
    nan_c, inf_c, elems = state.nan_count, state.inf_count, state.elems
    min_v, max_v, abs_v = state.min_val, state.max_val, state.absmax
    hist = state.hist
    slots = torch.arange(n, device=device)
    for pos, raw in enumerate(inputs):
        x = torch.as_tensor(raw, device=device).reshape(-1)
        if x.numel() == 0:  # an empty input contributes nothing
            continue
        at = slots == min(pos, n - 1)
        xf = x.to(torch.float32)
        # the fewest passes: the inf count derives from the finite count, the
        # absmax from the finite min and max
        finite = torch.isfinite(xf)
        n_nan = torch.isnan(xf).sum(dtype=torch.int32)
        n_finite = finite.sum(dtype=torch.int32)
        batch_min = torch.where(finite, xf, float("inf")).min()
        batch_max = torch.where(finite, xf, float("-inf")).max()
        size = x.numel()
        nan_c = nan_c + torch.where(at, n_nan, 0)
        inf_c = inf_c + torch.where(at, size - n_finite - n_nan, 0)
        elems = elems + torch.where(at, size, 0).to(torch.int32)
        min_v = torch.where(at, torch.minimum(min_v, batch_min), min_v)
        max_v = torch.where(at, torch.maximum(max_v, batch_max), max_v)
        absmax = torch.where(n_finite > 0, torch.maximum(batch_min.abs(), batch_max.abs()), 0.0)
        abs_v = torch.where(at, torch.maximum(abs_v, absmax), abs_v)
        if hist is not None and pos == 0:  # the histogram watches input 0 only
            hist = hist_update(hist, xf)
    return TelemetryState(nan_c, inf_c, elems, min_v, max_v, abs_v, state.updates + 1, hist)


def telemetry_merge(a: TelemetryState, b: TelemetryState) -> TelemetryState:
    """Pairwise merge (exact; associative and commutative)."""
    return TelemetryState(
        nan_count=a.nan_count + b.nan_count,
        inf_count=a.inf_count + b.inf_count,
        elems=a.elems + b.elems,
        min_val=torch.minimum(a.min_val, b.min_val),
        max_val=torch.maximum(a.max_val, b.max_val),
        absmax=torch.maximum(a.absmax, b.absmax),
        updates=a.updates + b.updates,
        hist=None if a.hist is None else hist_merge(a.hist, b.hist),
    )


def telemetry_mesh_reduce(state: TelemetryState, axis_name: str, mesh: Any = None) -> TelemetryState:
    """Reduce per-rank partial telemetry over a mesh dim, with the metric
    states' own collectives (``parallel.sharded.mesh_reduce_tree``): counts
    sum, gauges min/max. Histogram counts sum; its edge vector is a
    replicated constant and passes through."""
    from torchmetrics_tpu_torch.parallel.sharded import mesh_reduce_tree

    tree = {
        "nan_count": state.nan_count,
        "inf_count": state.inf_count,
        "elems": state.elems,
        "min_val": state.min_val,
        "max_val": state.max_val,
        "absmax": state.absmax,
        "updates": state.updates,
    }
    reductions = {k: "sum" for k in tree}
    reductions.update(min_val="min", max_val="max", absmax="max")
    if state.hist is not None:
        for field in ("counts", "low", "high", "count"):
            tree[f"hist.{field}"] = getattr(state.hist, field)
            reductions[f"hist.{field}"] = "sum"
    out = mesh_reduce_tree(reductions, tree, axis_name, mesh=mesh)
    hist = state.hist
    if hist is not None:
        hist = HistogramSketch(hist.edges, out["hist.counts"], out["hist.low"], out["hist.high"], out["hist.count"])
    return TelemetryState(
        out["nan_count"], out["inf_count"], out["elems"], out["min_val"], out["max_val"], out["absmax"], out["updates"], hist
    )


# ------------------------------------------------------------------ draining


def state_histogram_config(state: TelemetryState) -> Optional[Tuple[int, float, float]]:
    """Recover the ``(bins, lo, hi)`` geometry a state's histogram was built
    with, by reading its edge vector. This READS the device: call it only
    from host-boundary code (``fold_jit_state``), never per batch."""
    if state.hist is None:
        return None
    edges = state.hist.edges.detach().cpu().numpy()
    return (len(edges) - 1, float(edges[0]), float(edges[-1]))


def accumulate(metric: Any, state: TelemetryState, histogram: Optional[Tuple[int, float, float]] = None) -> None:
    """Fold one step's (mesh-reduced) telemetry into the metric's pending
    accumulator: a device-side merge of a handful of tiny tensors, no host
    read; :func:`drain_metric` reads it at a compute/sync boundary.

    ``histogram`` is the ``(bins, lo, hi)`` config the producing step was
    BUILT with (``None``: no histogram); the pending slot remembers it, so a
    state from a DIFFERENT telemetry config (input arity, histogram presence,
    bin count or range) is never merged elementwise. On a mismatch the
    pending state is drained to gauges first and the new regime starts fresh.
    """
    prev = getattr(metric, "_device_telemetry", None)
    if prev is not None:
        prev_state, prev_hist = prev
        if prev_state.nan_count.shape != state.nan_count.shape or prev_hist != histogram:
            drain_state(prev_state, type(metric).__name__)
            prev = None
    metric._device_telemetry = (state, histogram) if prev is None else (telemetry_merge(prev[0], state), histogram)


def drain_state(state: TelemetryState, name: str) -> Dict[str, float]:
    """Read a telemetry state into obs gauges (the host read happens HERE).

    Gauge names: ``device.<name>.nan_count``/``.inf_count``/``.updates``
    (totals), ``device.<name>.in<i>.{nan_count,inf_count,elems,min,max,absmax}``
    per input (min/max/absmax only for inputs that saw finite data), and, with
    a histogram configured, ``device.<name>.hist.{p50,p95,p99,outliers}``.
    """
    nan_c = state.nan_count.detach().cpu().numpy()
    inf_c = state.inf_count.detach().cpu().numpy()
    elems = state.elems.detach().cpu().numpy()
    min_v = state.min_val.detach().cpu().numpy()
    max_v = state.max_val.detach().cpu().numpy()
    abs_v = state.absmax.detach().cpu().numpy()
    prefix = f"device.{name}"
    out: Dict[str, float] = {
        f"{prefix}.nan_count": int(nan_c.sum()),
        f"{prefix}.inf_count": int(inf_c.sum()),
        f"{prefix}.updates": int(state.updates),
    }
    for i in range(nan_c.shape[0]):
        out[f"{prefix}.in{i}.nan_count"] = int(nan_c[i])
        out[f"{prefix}.in{i}.inf_count"] = int(inf_c[i])
        out[f"{prefix}.in{i}.elems"] = int(elems[i])
        if min_v[i] != float("inf"):  # at least one finite element seen
            out[f"{prefix}.in{i}.min"] = float(min_v[i])
            out[f"{prefix}.in{i}.max"] = float(max_v[i])
            out[f"{prefix}.in{i}.absmax"] = float(abs_v[i])
    if state.hist is not None:
        q = torch.tensor([0.5, 0.95, 0.99], dtype=state.hist.edges.dtype, device=state.hist.edges.device)
        p50, p95, p99 = (float(v) for v in hist_quantile(state.hist, q).detach().cpu().numpy())
        if p50 == p50:  # not NaN: the histogram saw data
            out[f"{prefix}.hist.p50"] = p50
            out[f"{prefix}.hist.p95"] = p95
            out[f"{prefix}.hist.p99"] = p99
        out[f"{prefix}.hist.outliers"] = int(state.hist.low) + int(state.hist.high)
    for gauge, value in out.items():
        _counters.set_gauge(gauge, value)
    if _trace.ENABLED:
        _counters.inc("device.telemetry.drain")
    return out


def drain_metric(metric: Any) -> Optional[Dict[str, float]]:
    """Drain a metric's pending accumulator (if any) into gauges and clear it.

    Called by ``Metric.compute``/``Metric.sync`` and the collection's compute
    boundary: the ONLY places device telemetry touches the host.
    """
    pending = getattr(metric, "_device_telemetry", None)
    if pending is None:
        return None
    metric._device_telemetry = None
    state, _histogram = pending
    return drain_state(state, type(metric).__name__)
