# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Numerically-safe compute helpers (counterpart of ``torchmetrics_tpu/utilities/compute.py``)."""
from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch


def _dim_sum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x.sum(axis)`` that is a no-op on 0-d tensors."""
    return x.sum(dim=axis, dtype=x.dtype) if x.ndim > 0 else x


def _safe_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y.T``; half-precision inputs multiply in float32 and the product
    comes back in ``x``'s dtype. A float32 product runs in float32 on the
    card too: the port never turns TF32 on
    (``torch.backends.cuda.matmul.allow_tf32`` stays ``False``)."""
    half = (torch.float16, torch.bfloat16)
    if x.dtype in half or y.dtype in half:
        return (x.to(torch.float32) @ y.to(torch.float32).T).to(x.dtype)
    return x @ y.T


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * log(y)`` that is 0 wherever ``x == 0``, ``y`` NaN included, as the JAX package's is."""
    return torch.where(x == 0, torch.zeros_like(x), x * torch.log(y))


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """Division with a defined value where ``denom == 0``; integer inputs become float32."""
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom if denom.is_floating_point() else denom.to(torch.float32)
    zero = torch.tensor(zero_division, dtype=torch.result_type(num, denom), device=num.device)
    nonzero = denom != 0
    return torch.where(nonzero, num / torch.where(nonzero, denom, torch.ones_like(denom)), zero)


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    top_k: int = 1,
) -> torch.Tensor:
    """Weighted/macro final averaging of per-class scores."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(score.dtype)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            # with top_k > 1 a class can collect fp without ever appearing in
            # target; only absent classes (tp+fn==0) are dropped then
            mask = (tp + fn == 0) if top_k != 1 else (tp + fp + fn == 0)
            weights = torch.where(mask, torch.zeros_like(weights), weights)
        weights = torch.where(torch.isnan(score), torch.zeros_like(weights), weights)
    score = torch.where(torch.isnan(score), torch.zeros_like(score), score)
    return _sum_last_in_xla_order(_safe_divide(weights * score, weights.sum(-1, keepdim=True)))


def _sum_last_in_xla_order(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` of float values, added in one fixed order on every device.

    ``Tensor.sum`` adds in an order of each backend's choosing, so the same
    float32 scores sum to other last bits on a card than on the CPU. This
    takes the order of XLA's CPU reduction, which the JAX package's
    ``.sum(-1)`` gets: a row of up to 32 values from left to right; a longer
    row as the sum of its two halves (the left one ``ceil(n / 2)`` long),
    each summed so. For rows of up to 64 that is XLA's order bit for bit
    (``tests/test_torch_utilities.py``); longer rows keep the rule.
    """
    n = x.shape[-1]
    if n == 0:
        return x.sum(-1)
    if n <= 32:
        acc = x[..., 0]
        for i in range(1, n):
            acc = acc + x[..., i]
        return acc
    h = (n + 1) // 2
    return _sum_last_in_xla_order(x[..., :h]) + _sum_last_in_xla_order(x[..., h:])


@lru_cache(maxsize=None)
def _xla_order_plan(n: int) -> Tuple[List[List[int]], List[Tuple[List[int], List[int], List[int]]]]:
    """The tree of :func:`_sum_last_in_xla_order` over ``n`` values: its
    leaves' positions (each at most 32, in order), then its inner nodes by
    height, as (node, left child, right child) slots of one table whose
    first slots are the leaves', the root last."""
    leaves: List[List[int]] = []

    def collect(start: int, length: int) -> None:
        if length <= 32:
            leaves.append(list(range(start, start + length)))
            return
        h = (length + 1) // 2
        collect(start, h)
        collect(start + h, length - h)

    collect(0, n)
    next_leaf, next_node = iter(range(len(leaves))), itertools.count(len(leaves))
    levels: Dict[int, Tuple[List[int], List[int], List[int]]] = {}

    def build(length: int) -> Tuple[int, int]:  # (slot, height), leaves met in the order collect met them
        if length <= 32:
            return next(next_leaf), 0
        h = (length + 1) // 2
        (left, hl), (right, hr) = build(h), build(length - h)
        slot, height = next(next_node), max(hl, hr) + 1
        for part, value in zip(levels.setdefault(height, ([], [], [])), (slot, left, right)):
            part.append(value)
        return slot, height

    build(n)
    return leaves, [levels[height] for height in sorted(levels)]


_XLA_ORDER_INDICES: Dict[Tuple[int, str], Tuple[torch.Tensor, list]] = {}


def _sum_in_xla_order(x: torch.Tensor) -> torch.Tensor:
    """``_sum_last_in_xla_order`` of a 1-D float tensor, bit for bit, in a
    few dozen vector ops instead of one op a value: the leaves' runs of up
    to 32 values as the columns of one gather (short runs padded with -0.0,
    which adds exactly nothing), summed column by column, then the inner
    nodes level by level. The index tensors are kept per length and device,
    so a CUDA graph captured after a first call holds no host copy."""
    n = x.shape[0]
    if n <= 32:
        return _sum_last_in_xla_order(x)
    key = (n, str(x.device))
    if key not in _XLA_ORDER_INDICES:
        leaves, plan = _xla_order_plan(n)
        table = torch.full((len(leaves), 32), n, dtype=torch.int64)
        for i, leaf in enumerate(leaves):
            table[i, : len(leaf)] = torch.tensor(leaf)
        steps = [tuple(torch.tensor(v, dtype=torch.int64, device=x.device) for v in level) for level in plan]
        _XLA_ORDER_INDICES[key] = (table.to(x.device), steps)
    table, steps = _XLA_ORDER_INDICES[key]
    padded = torch.cat([x, torch.full((1,), -0.0, dtype=x.dtype, device=x.device)])[table]
    acc = padded[:, 0]
    for i in range(1, 32):
        acc = acc + padded[:, i]
    slots = torch.cat([acc, torch.empty(sum(len(level[0]) for level in steps), dtype=x.dtype, device=x.device)])
    for nodes, lefts, rights in steps:
        slots = slots.index_copy(0, nodes, slots[lefts] + slots[rights])
    return slots[-1]


def _mean_last_in_xla_order(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=-1)`` of float32 values, bitwise on every device:
    :func:`_sum_last_in_xla_order`, times the float32 reciprocal of the
    count, which is how XLA's CPU compiler divides by a constant."""
    recip = torch.full((), 1.0 / x.shape[-1], dtype=x.dtype, device=x.device)
    return (_sum_in_xla_order(x) if x.ndim == 1 else _sum_last_in_xla_order(x)) * recip


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float, axis: int = -1) -> torch.Tensor:
    """Trapezoidal area under the curve ``y(x)`` along ``axis``."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    return ((y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0 * dx).sum(dim=axis) * direction


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """AUC with monotonicity handling: a decreasing ``x`` integrates with
    direction -1, a non-monotone one gives NaN (no host sync), as in JAX."""
    if reorder:
        order = torch.sort(x, stable=True).indices
        x, y = x[order], y[order]
        direction = torch.tensor(1.0, device=x.device)
    else:
        dx = torch.diff(x)
        one = torch.tensor(1.0, device=x.device)
        decreasing = torch.where(torch.all(dx <= 0), -one, torch.full_like(one, float("nan")))
        direction = torch.where(torch.any(dx < 0), decreasing, one)
    return _auc_compute_without_check(x, y, direction)


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Area under the curve ``y(x)`` by the trapezoidal rule."""
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError(f"Expected 1d arrays, got x.ndim={x.ndim}, y.ndim={y.ndim}")
    if x.shape[0] != y.shape[0]:
        raise ValueError("x and y must have the same length")
    return _auc_compute(x, y, reorder=reorder)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """1-D linear interpolation with ``jnp.interp``'s semantics (PyTorch has no ``interp``).

    ``xp`` ascends and may repeat (an ROC's fpr axis does): the segment is
    found by ``searchsorted(side="right")``, a segment of zero width takes
    its left value, and points beyond either end take ``fp[0]`` / ``fp[-1]``.
    XLA's CPU compiler fuses ``fp[i-1] + (delta / dx) * df`` into one FMA;
    the product of two float32 values is exact in float64, so the FMA is
    replayed there and rounded once more to float32. That matches the FMA
    bit for bit unless the float64 sum lands on a float32 rounding tie
    (a double rounding, then one ulp apart).
    """
    xp = xp.to(x.dtype).contiguous()
    fp = fp if fp.is_floating_point() else fp.to(torch.float32)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.shape[0] - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    dx = xp[i] - lo_x
    zero_width = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    slope = (x - lo_x) / torch.where(zero_width, torch.ones_like(dx), dx)
    wide = torch.float64 if fp.dtype == torch.float32 else fp.dtype
    fused = (lo_f.to(wide) + slope.to(wide) * (fp[i] - lo_f).to(wide)).to(fp.dtype)
    f = torch.where(zero_width, lo_f, fused)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def normalize_logits_if_needed(tensor: torch.Tensor, normalization: str = "sigmoid", rows: Optional[int] = None) -> torch.Tensor:
    """Apply sigmoid/softmax only when some value lies outside [0, 1].

    The test is over the whole tensor, as in the JAX package, and both
    branches are computed and one selected with ``torch.where``: the choice
    never reads a value back to the host, so an update on the card does not
    sync here. With ``rows``, the tensor holds ``rows`` equal runs of
    values, one per batch row, and each run is tested on its own: JAX's
    per-row ``vmap`` of an update in a sliced plan decides per row.
    """
    if tensor.numel() == 0:
        return tensor
    if normalization not in ("sigmoid", "softmax"):
        return tensor
    if rows is not None:
        runs = tensor.reshape(rows, -1)
        ok = (runs.amin(1) >= 0) & (runs.amax(1) <= 1)
        in_range = ok[:, None].expand(runs.shape).reshape(tensor.shape)
    else:
        in_range = (tensor.min() >= 0) & (tensor.max() <= 1)
    normalized = torch.sigmoid(tensor) if normalization == "sigmoid" else torch.softmax(tensor, dim=1)
    return torch.where(in_range, tensor, normalized)


def _linspace_like_jax(
    start: float, stop: float, num: int, device: Union[str, torch.device, None] = None
) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32, bitwise.

    ``torch.linspace`` and ``jnp.linspace`` disagree in the last bit at some
    grid points (4 of 128 at ``num=128``), and a threshold one ulp off bins a
    probability differently. JAX writes ``start * (1 - i / div) + stop * (i / div)``
    with ``div = num - 1``; XLA's CPU compiler turns ``i / div`` into
    ``i * r`` with ``r`` the float32 reciprocal, reassociates
    ``stop * (i * r)`` into ``i * (stop * r)``, and fuses that product and
    the final add into one FMA. This replays those float32 operations, the
    FMA exactly in float64 (the product of two float32 values is exact
    there). For ``start=0, stop=1``, the grid an integer ``thresholds``
    builds, every point is ``i * r`` rounded once, whatever the fusion, so
    that grid is exact; other ranges match XLA's CPU output on the ranges
    the tests hold, within two float32 ulps of the range's magnitude. The
    grid is computed on the CPU and then moved to ``device``.
    """
    if num < 0:
        raise ValueError(f"Number of samples, {num}, must be non-negative.")
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    if num == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    if num == 1:
        return start_t.reshape(1).to(device)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(div), dtype=torch.float32)
    iota = torch.arange(div, dtype=torch.float32)
    head = start_t * (1 - iota * recip)  # float32, rounded at each step
    fused = iota.double() * (stop_t * recip).double() + head.double()
    return torch.cat([fused.float(), stop_t.reshape(1)]).to(device)
