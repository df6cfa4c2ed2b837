# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Kendall rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/kendall.py``).

**The pair census.** Concordant and discordant pairs over all ``i < j`` are
counted in blocks of ``_CENSUS_BLOCK`` rows, as in the JAX package, and each
block's count is exact. The accumulator is int32 while the number of pairs
``n * (n - 1) / 2`` fits in it (up to n = 65536), float32 above: each
block's exact count is then rounded to float32 and added in block order, the
JAX package's rule and order, so the float branch agrees with it bit for bit.

A block's count is cheaper here than JAX's full ``(block, n)`` sign-product
matrix: the row block ``[s, s + B)`` pairs only with the columns ``>= s``
(a column ``j < s`` has ``j < i`` for every row ``i`` of the block), and only
the diagonal ``B x B`` square needs the ``j > i`` mask. Signs are int8 from
two comparisons (``x_i > x_j`` minus ``x_i < x_j``): a comparison with NaN
is false, so a pair with a NaN counts as neither, as JAX's NaN sign product
does. With ``P`` the sign product, the count of positive ``P`` is the
concordant pairs and the count of nonzero ``P`` both kinds. On the CPU the columns go in
chunks that fit the cache; on the card a row block takes all its columns.

**Ties and the test.** Tie statistics come from a sort and segment counts in
float32, ``t * (t - 1) // 2`` included (``torch.floor_divide`` on floats is
``jnp.floor_divide``'s rule). The p-value uses ``torch.special.erf``, which
differs from XLA's by ulps.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.spearman import _tie_segments
from torchmetrics_tpu_torch.functional.regression.utils import _float32_pair
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.enums import EnumStr

Tensor = torch.Tensor


class _MetricVariant(EnumStr):
    """Variants of Kendall's tau."""

    A = "a"
    B = "b"
    C = "c"

    @staticmethod
    def _name() -> str:
        return "variant"


class _TestAlternative(EnumStr):
    """Alternative hypotheses of the significance test."""

    TWO_SIDED = "two-sided"
    LESS = "less"
    GREATER = "greater"

    @staticmethod
    def _name() -> str:
        return "alternative"


_CENSUS_BLOCK = 1024
#: columns per chunk of a row block on the CPU (a 1024 x 16384 int8 product is 16 MiB)
_CPU_CENSUS_COLUMNS = 1 << 14


def _signs(rows: Tensor, cols: Tensor) -> Tensor:
    """``sign(rows[:, None] - cols[None, :])`` as int8, 0 where either is NaN."""
    r, c = rows[:, None], cols[None, :]
    return torch.gt(r, c).view(torch.int8) - torch.lt(r, c).view(torch.int8)


def _census_counts(x: Tensor, y: Tensor) -> Tensor:
    """Exact concordant and discordant counts of every row block, int64 ``(blocks, 2)``
    on the inputs' device (nothing is read back to the host)."""
    n = x.shape[0]
    chunk = n if x.is_cuda else _CPU_CENSUS_COLUMNS
    lower = ~torch.ones(_CENSUS_BLOCK, _CENSUS_BLOCK, dtype=torch.bool, device=x.device).triu(1)  # pairs j <= i
    out = []
    for s in range(0, max(n, 1), _CENSUS_BLOCK):
        xi, yi = x[s : s + _CENSUS_BLOCK], y[s : s + _CENSUS_BLOCK]
        rows = xi.shape[0]
        con = torch.zeros((), dtype=torch.int64, device=x.device)
        both = torch.zeros((), dtype=torch.int64, device=x.device)  # concordant + discordant
        for c0 in range(s, n, chunk):
            prod = _signs(xi, x[c0 : c0 + chunk])
            prod.mul_(_signs(yi, y[c0 : c0 + chunk]))
            if c0 == s:  # the diagonal square: only the pairs j > i
                prod[:, :rows].masked_fill_(lower[:rows, :rows], 0)
            con = con + torch.count_nonzero(prod > 0)
            both = both + torch.count_nonzero(prod)
        out.append(torch.stack([con, both - con]))
    return torch.stack(out)


def _pair_census(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """Concordant and discordant pairs over all ``i < j``: int32 while the pair
    count fits, else float32 accumulated block by block (see the module doc)."""
    n = x.shape[0]
    counts = _census_counts(x, y)
    if n * (n - 1) // 2 < 2**31 - 1:
        total = counts.sum(0).to(torch.int32)
        return total[0], total[1]
    con = torch.zeros((), dtype=torch.float32, device=x.device)
    dis = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in counts.to(torch.float32):
        con = con + block[0]
        dis = dis + block[1]
    return con, dis


def _tie_stats(x: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(sum t(t-1)/2, sum t(t-1)(t-2), sum t(t-1)(2t+5), n_unique)`` over the
    tie groups of ``x`` (float32 sums, int32 count)."""
    n = x.shape[0]
    seg = _tie_segments(torch.sort(x).values)
    t = torch.zeros(n, dtype=torch.float32, device=x.device).index_add_(
        0, seg.long(), torch.ones(n, dtype=torch.float32, device=x.device)
    )
    ties = torch.sum(torch.floor_divide(t * (t - 1), 2))
    ties_p1 = torch.sum(t * (t - 1.0) * (t - 2))
    ties_p2 = torch.sum(t * (t - 1.0) * (2 * t + 5))
    n_unique = seg[-1] + 1
    return ties, ties_p1, ties_p2, n_unique


def _normal_cdf(x: Tensor) -> Tensor:
    return 0.5 * (1 + torch.special.erf(x / math.sqrt(2.0)))


def _kendall_tau_1d(preds: Tensor, target: Tensor, variant: str, alternative: Optional[str]) -> Tuple[Tensor, Tensor]:
    """Tau and the p-value for one output column."""
    n_total = preds.shape[0]
    concordant, discordant = _pair_census(preds, target)
    con_min_dis = (concordant - discordant).to(torch.float32)
    preds_ties, preds_p1, preds_p2, preds_unique = _tie_stats(preds)
    target_ties, target_p1, target_p2, target_unique = _tie_stats(target)

    if variant == "a":
        tau = con_min_dis / (concordant + discordant)
    elif variant == "b":
        total_combinations = n_total * (n_total - 1) / 2
        denominator = (total_combinations - preds_ties) * (total_combinations - target_ties)
        tau = con_min_dis / torch.sqrt(denominator)
    else:
        min_classes = torch.minimum(preds_unique, target_unique).to(torch.float32)
        tau = 2 * con_min_dis / ((min_classes - 1) / min_classes * n_total**2)

    # the p-value of the significance test
    t_value_denominator_base = n_total * (n_total - 1) * (2.0 * n_total + 5)
    if variant == "a":
        half = torch.full((), t_value_denominator_base / 2, dtype=torch.float32, device=preds.device)
        t_value = 3 * con_min_dis / torch.sqrt(half)
    else:
        m = n_total * (n_total - 1)
        t_value_denominator = (t_value_denominator_base - preds_p2 - target_p2) / 18
        t_value_denominator = t_value_denominator + (2 * preds_ties * target_ties) / m
        t_value_denominator = t_value_denominator + preds_p1 * target_p1 / (9 * m * (n_total - 2))
        t_value = con_min_dis / torch.sqrt(t_value_denominator)

    if alternative == "two-sided":
        t_value = torch.abs(t_value)
    if alternative in ("two-sided", "greater"):
        t_value = -t_value
    p_value = _normal_cdf(t_value)
    if alternative == "two-sided":
        p_value = p_value * 2
    p_value = torch.where(torch.isnan(t_value), torch.full_like(p_value, math.nan), p_value)
    return torch.clamp(tau, -1.0, 1.0), p_value


def _kendall_corrcoef_compute(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    alternative: Optional[str] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Tau (and the p-value where ``alternative`` is given) for ``(N,)`` or ``(N, d)`` inputs."""
    if preds.ndim == 1:
        tau, p_value = _kendall_tau_1d(preds, target, variant, alternative)
    else:
        pairs = [_kendall_tau_1d(preds[:, i], target[:, i], variant, alternative) for i in range(preds.shape[1])]
        tau, p_value = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    return tau, p_value if alternative is not None else None


def kendall_rank_corrcoef(
    preds: Tensor,
    target: Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
):
    """Compute Kendall's rank correlation coefficient (and the p-value with ``t_test=True``)."""
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {type(t_test)}.")
    _variant = _MetricVariant.from_str(str(variant))
    _alt = _TestAlternative.from_str(str(alternative)) if t_test else None
    preds, target = _float32_pair(preds, target)
    _check_same_shape(preds, target)
    tau, p_value = _kendall_corrcoef_compute(
        preds, target, str(_variant.value), str(_alt.value) if _alt is not None else None
    )
    if p_value is not None:
        return tau, p_value
    return tau
