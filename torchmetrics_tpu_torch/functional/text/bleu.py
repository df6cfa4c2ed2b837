# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BLEU score (counterpart of ``torchmetrics_tpu/functional/text/bleu.py``)."""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _count_ngram

Tensor = torch.Tensor


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenizer."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: Tensor,
    denominator: Tensor,
    preds_len: Tensor,
    target_len: Tensor,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Clipped n-gram counts and closest-length bookkeeping, returned as new
    float32 tensors on the accumulators' device, as JAX returns new arrays:
    the counts are folded into the accumulators' values in Python floats and
    rounded to float32 once."""
    target_tok: Sequence[Sequence[Sequence[str]]] = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok: Sequence[Sequence[str]] = [tokenizer(line) if line else [] for line in preds]
    device = numerator.device
    numerator_np = numerator.tolist()
    denominator_np = denominator.tolist()
    preds_len_acc = float(preds_len)
    target_len_acc = float(target_len)
    for pred, targets in zip(preds_tok, target_tok):
        preds_len_acc += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len_acc += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter: Counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)
        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            numerator_np[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            denominator_np[len(counter) - 1] += preds_counter[counter]

    def f32(value):
        return torch.tensor(value, dtype=torch.float32, device=device)

    return f32(numerator_np), f32(denominator_np), f32(preds_len_acc), f32(target_len_acc)


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Geometric-mean precision with the brevity penalty; a zero numerator
    gives 0 by a select, as in JAX (no host branch)."""
    ones = torch.ones(n_gram, dtype=numerator.dtype, device=numerator.device)
    if smooth:
        precision_scores = (numerator + ones) / (denominator + ones)
        precision_scores = torch.cat([(numerator[0] / denominator[0]).reshape(1), precision_scores[1:]])
    else:
        precision_scores = numerator / denominator
    # guard the log against 0/0 lanes; any zero numerator zeroes the result below
    safe_precision = torch.where(numerator > 0, precision_scores, torch.ones_like(precision_scores))
    log_precision_scores = torch.tensor(weights, dtype=torch.float32, device=numerator.device) * torch.log(safe_precision)
    geometric_mean = torch.exp(torch.sum(log_precision_scores))
    brevity_penalty = torch.where(
        preds_len > target_len, torch.ones_like(preds_len), torch.exp(1 - target_len / preds_len)
    )
    return torch.where(torch.min(numerator) == 0.0, torch.zeros_like(geometric_mean), brevity_penalty * geometric_mean)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> Tensor:
    """BLEU score of a translated corpus."""
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator = torch.zeros(n_gram)
    denominator = torch.zeros(n_gram)
    preds_len = torch.tensor(0.0)
    target_len = torch.tensor(0.0)
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds_, target_, numerator, denominator, preds_len, target_len, n_gram
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
