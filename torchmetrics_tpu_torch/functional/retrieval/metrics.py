# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Retrieval metrics (counterpart of ``torchmetrics_tpu/functional/retrieval/metrics.py``).

Every metric has a *masked-row* form ``_<name>_kernel(preds, target, valid,
...)`` over a ``(Q, L)`` grid: one query per row, its documents in the
columns, padded slots with ``valid=False``, ``preds=-inf`` and
``target=0``. JAX ``vmap``s a one-row kernel over the rows; here each
kernel is written over the rows at once, the same arithmetic per row. The
module layer packs the queries into the grid; the public functions take
one query's 1-D inputs as a one-row grid.

Rows are ranked by a stable descending sort, ``jnp.argsort(-preds)``'s
order: ties keep their column order, NaN scores sort after every number
(after the padded slots too), and -0 ties +0. A radix sort on the card
could order -0 and +0 apart, so every zero is made +0 (``preds + 0.0``)
before the sort; that changes no value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _to_tensors

Tensor = torch.Tensor


def _validate_top_k(top_k) -> None:
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def _rank_order(preds: Tensor) -> Tensor:
    """Per row, the column order of a stable descending sort by score."""
    return torch.argsort(-(preds + 0.0), dim=-1, stable=True)


def _sorted_by_score(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The rows sorted by descending score (padded slots, at -inf, last
    but for NaN scores); the target as float32."""
    order = _rank_order(preds)
    return preds.gather(-1, order), target.gather(-1, order).to(torch.float32), valid.gather(-1, order)


def _columns(n: int, device: torch.device) -> Tensor:
    return torch.arange(n, device=device)


def _segments(sp: Tensor) -> Tensor:
    """Per row, the id of each sorted slot's run of equal scores (NaN never
    equals, so each NaN is a run of its own)."""
    new_seg = torch.zeros_like(sp, dtype=torch.int64)
    new_seg[:, 1:] = (sp[:, 1:] != sp[:, :-1]).to(torch.int64)
    return torch.cumsum(new_seg, dim=-1)


def _segment_mean(values: Tensor, seg: Tensor) -> Tensor:
    """Each slot's run mean of ``values`` (JAX's two ``segment_sum`` over the
    row, then the gather back)."""
    gsum = torch.zeros_like(values).scatter_add(-1, seg, values)
    gcount = torch.zeros_like(values).scatter_add(-1, seg, torch.ones_like(values))
    return (gsum / torch.clamp(gcount, min=1.0)).gather(-1, seg)


# ------------------------------------------------------------------ kernels
def _average_precision_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """AP of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    k = n if top_k is None else min(top_k, n)
    cols = _columns(n, st.device)
    rel = (st > 0) & sv & (cols < k)
    positions = torch.arange(1, n + 1, dtype=torch.float32, device=st.device)
    hits = torch.cumsum(rel.to(torch.float32), dim=-1)
    prec_at_hit = torch.where(rel, hits / positions, torch.zeros_like(hits))
    n_rel = rel.sum(-1, dtype=torch.int32)
    ap = prec_at_hit.sum(-1) / torch.clamp(n_rel, min=1)
    return torch.where(n_rel > 0, ap, torch.zeros_like(ap))


def _reciprocal_rank_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """RR of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    k = n if top_k is None else min(top_k, n)
    rel = (st > 0) & sv & (_columns(n, st.device) < k)
    first = torch.argmax(rel.to(torch.int32), dim=-1)  # the first hit, or 0 if none
    rr = 1.0 / (first.to(torch.float32) + 1.0)
    return torch.where(rel.any(-1), rr, torch.zeros_like(rr))


def _precision_kernel(
    preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> Tensor:
    """Precision@k of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n_docs = sv.sum(-1, dtype=torch.int32)
    n = st.shape[-1]
    cols = _columns(n, st.device)
    if top_k is None:
        in_k = cols < n_docs[:, None]
        denom = n_docs.to(torch.float32)
    elif adaptive_k:
        k = torch.clamp(n_docs, max=top_k)
        in_k = cols < k[:, None]
        denom = k.to(torch.float32)
    else:
        in_k = cols < min(top_k, n)
        denom = float(top_k)
    rel = ((st > 0) & sv & in_k).sum(-1, dtype=torch.int32).to(torch.float32)
    has_pos = ((target > 0) & valid).any(-1)
    value = rel / denom
    return torch.where(has_pos, value, torch.zeros_like(value))


def _recall_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall@k of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    k = n if top_k is None else min(top_k, n)
    rel = ((st > 0) & sv & (_columns(n, st.device) < k)).sum(-1, dtype=torch.int32).to(torch.float32)
    total = ((target > 0) & valid).sum(-1, dtype=torch.int32).to(torch.float32)
    value = rel / torch.clamp(total, min=1.0)
    return torch.where(total > 0, value, torch.zeros_like(value))


def _hit_rate_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """HitRate@k of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    k = n if top_k is None else min(top_k, n)
    return ((st > 0) & sv & (_columns(n, st.device) < k)).any(-1).to(torch.float32)


def _fall_out_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out@k of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    k = n if top_k is None else min(top_k, n)
    nonrel_at_k = ((st == 0) & sv & (_columns(n, st.device) < k)).sum(-1, dtype=torch.int32).to(torch.float32)
    total_nonrel = ((target == 0) & valid).sum(-1, dtype=torch.int32).to(torch.float32)
    value = nonrel_at_k / torch.clamp(total_nonrel, min=1.0)
    return torch.where(total_nonrel > 0, value, torch.zeros_like(value))


def _r_precision_kernel(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """R-precision of each row."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    n_rel = ((target > 0) & valid).sum(-1, dtype=torch.int32)
    in_r = _columns(n, st.device) < n_rel[:, None]
    rel = ((st > 0) & sv & in_r).sum(-1, dtype=torch.int32).to(torch.float32)
    value = rel / torch.clamp(n_rel, min=1).to(torch.float32)
    return torch.where(n_rel > 0, value, torch.zeros_like(value))


def _dcg_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int], ignore_ties: bool) -> Tensor:
    """DCG of each row, tie-averaged unless ``ignore_ties``: each run of
    equal scores shares its mean gain over its discounts."""
    n = target.shape[-1]
    k = n if top_k is None else min(top_k, n)
    cols = _columns(n, target.device)
    discount = 1.0 / torch.log2(cols.to(torch.float32) + 2.0)
    discount = torch.where(cols < k, discount, torch.zeros_like(discount))

    sp, st, sv = _sorted_by_score(preds, target, valid)
    gains = torch.where(sv, st, torch.zeros_like(st))
    if ignore_ties:
        return (discount * gains).sum(-1)
    return (_segment_mean(gains, _segments(sp)) * discount).sum(-1)


def _ndcg_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Normalized DCG of each row: the ideal ranks by the target."""
    gain = _dcg_kernel(preds, target, valid, top_k, ignore_ties=False)
    ideal_scores = torch.where(valid, target.to(torch.float32), torch.full_like(target, float("-inf"), dtype=torch.float32))
    ideal_gain = _dcg_kernel(ideal_scores, target, valid, top_k, True)
    value = gain / torch.clamp(ideal_gain, min=1e-12)
    return torch.where(ideal_gain > 0, value, torch.zeros_like(value))


def _auroc_kernel(preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Exact AUROC of each row by the rank statistic (Mann-Whitney U with
    midranks for ties), the ascending midranks read off the descending
    sort by the same run means as :func:`_dcg_kernel`."""
    sp, st, sv = _sorted_by_score(preds, target, valid)
    n = st.shape[-1]
    cols = _columns(n, st.device)
    if top_k is not None:
        sv = sv & (cols < min(top_k, n))
    pos = (st > 0) & sv
    neg = (st == 0) & sv
    n_pos = pos.sum(-1, dtype=torch.int32).to(torch.float32)
    n_neg = neg.sum(-1, dtype=torch.int32).to(torch.float32)
    n_valid = sv.sum(-1, dtype=torch.int32).to(torch.float32)
    positions = cols.to(torch.float32).expand(st.shape)
    midrank = n_valid[:, None] - _segment_mean(positions, _segments(sp))
    rank_sum_pos = torch.where(pos, midrank, torch.zeros_like(midrank)).sum(-1)
    auc = (rank_sum_pos - n_pos * (n_pos + 1) / 2) / torch.clamp(n_pos * n_neg, min=1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.zeros_like(auc))


def _precision_recall_curve_kernel(
    preds: Tensor, target: Tensor, valid: Tensor, max_k: int, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-k precision and recall of each row, ``(Q, max_k)``, and the k."""
    _, st, sv = _sorted_by_score(preds, target, valid)
    q, n = st.shape
    n_docs = sv.sum(-1, dtype=torch.int32)
    kk = torch.arange(1, max_k + 1, dtype=torch.float32, device=st.device)
    if adaptive_k:
        topk = torch.minimum(kk[None, :], torch.clamp(n_docs, min=1).to(torch.float32)[:, None])
    else:
        topk = kk.expand(q, max_k)
    rel_sorted = torch.where(sv, st, torch.zeros_like(st))[:, : min(max_k, n)]
    if rel_sorted.shape[-1]:
        rel_cum = torch.cumsum(rel_sorted, dim=-1)
        pad = max_k - rel_cum.shape[-1]
        if pad > 0:  # the row's last count repeats, as ``jnp.pad(mode="edge")``
            rel_cum = torch.cat([rel_cum, rel_cum[:, -1:].expand(q, pad)], dim=-1)
    else:
        rel_cum = torch.zeros((q, max_k), dtype=torch.float32, device=st.device)
    total = ((target > 0) & valid).sum(-1, dtype=torch.int32).to(torch.float32)[:, None]
    has_pos = total > 0
    recall = torch.where(has_pos, rel_cum / torch.clamp(total, min=1.0), torch.zeros_like(rel_cum))
    precision = torch.where(has_pos, rel_cum / topk, torch.zeros_like(rel_cum))
    return precision, recall, topk


# ------------------------------------------------------------- public functions
def _one_query(preds: Tensor, target: Tensor, allow_non_binary_target: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """One query's inputs as a one-row grid, every slot valid."""
    preds, target = _check_retrieval_functional_inputs(*_to_tensors(preds, target), allow_non_binary_target)
    return preds[None], target[None], torch.ones_like(preds, dtype=torch.bool)[None]


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Average precision of one query."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    return _average_precision_kernel(*row, top_k)[0]


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank of one query."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    return _reciprocal_rank_kernel(*row, top_k)[0]


def retrieval_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    """Precision@k of one query."""
    row = _one_query(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if top_k is not None:
        _validate_top_k(top_k)
    return _precision_kernel(*row, top_k, adaptive_k)[0]


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Recall@k of one query."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    return _recall_kernel(*row, top_k)[0]


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """HitRate@k of one query."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    return _hit_rate_kernel(*row, top_k)[0]


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Fall-out@k of one query."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    return _fall_out_kernel(*row, top_k)[0]


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision of one query."""
    return _r_precision_kernel(*_one_query(preds, target))[0]


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Normalized DCG of one query (graded relevance allowed)."""
    row = _one_query(preds, target, allow_non_binary_target=True)
    if top_k is not None:
        _validate_top_k(top_k)
    return _ndcg_kernel(*row, top_k)[0]


def retrieval_auroc(
    preds: Tensor, target: Tensor, top_k: Optional[int] = None, max_fpr: Optional[float] = None
) -> Tensor:
    """AUROC of one query; with ``max_fpr`` the partial AUC of the exact
    binary curve over the top ``top_k`` documents (a host decision on the
    query's classes, as in JAX)."""
    row = _one_query(preds, target)
    if top_k is not None:
        _validate_top_k(top_k)
    if max_fpr is not None:
        from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc

        preds, target = row[0][0], row[1][0]
        n = preds.shape[0]
        k = n if top_k is None else min(top_k, n)
        order = _rank_order(preds)[:k]
        t = target[order]
        if not bool((t > 0).any()) or not bool((t == 0).any()):
            return torch.tensor(0.0, device=preds.device)
        return binary_auroc(preds[order], t.to(torch.int32), max_fpr=max_fpr)
    return _auroc_kernel(*row, top_k)[0]


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision and recall at k = 1..max_k of one query, and the k."""
    row = _one_query(preds, target)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = row[0].shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    precision, recall, topk = _precision_recall_curve_kernel(*row, max_k, adaptive_k)
    return precision[0], recall[0], topk[0]
