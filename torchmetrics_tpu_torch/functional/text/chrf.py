# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""chrF / chrF++ score (counterpart of ``torchmetrics_tpu/functional/text/chrf.py``).

Counting runs on the host (string work) in numpy, as in JAX; the totals
are per-order count vectors, ``"sum"``-reducible metric states.
"""
from __future__ import annotations

from collections import Counter
from itertools import chain
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """Characters of the sentence."""
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split leading/trailing punctuation."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """Words with separated punctuation."""
    return list(chain.from_iterable(_separate_word_and_punctuation(word) for word in sentence.strip().split()))


def _ngram_counts(char_or_word_list: List[str], n_gram_order: int) -> Dict[int, Counter]:
    """Counter of n-grams per order."""
    ngrams: Dict[int, Counter] = {}
    for n in range(1, n_gram_order + 1):
        ngrams[n] = Counter(tuple(char_or_word_list[i : i + n]) for i in range(len(char_or_word_list) - n + 1))
    return ngrams


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter]]:
    """Char and word n-gram counters of one sentence."""
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    return char_counts, word_counts


def _matching_counts(pred: Dict[int, Counter], ref: Dict[int, Counter]) -> Dict[int, float]:
    """Clipped matches per order."""
    return {n: float(sum((pred.get(n, Counter()) & ref.get(n, Counter())).values())) for n in pred}


def _totals(counts: Dict[int, Counter]) -> Dict[int, float]:
    return {n: float(sum(c.values())) for n, c in counts.items()}


def _fscore_from_totals(
    matching: np.ndarray, ref_total: np.ndarray, hyp_total: np.ndarray, beta: float
) -> np.ndarray:
    """Per-order F-beta with eps smoothing."""
    precision = np.where(hyp_total > 0, matching / np.maximum(hyp_total, 1), 0.0)
    recall = np.where(ref_total > 0, matching / np.maximum(ref_total, 1), 0.0)
    denominator = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
    return (1 + beta**2) * precision * recall / denominator


def _sentence_chrf(
    pred_char: Dict[int, Counter],
    pred_word: Dict[int, Counter],
    targets: Sequence[str],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Best-reference sentence chrF + that reference's counts."""
    n_order = float(n_char_order + n_word_order)
    pred_char_total = np.array([_totals(pred_char).get(n, 0.0) for n in range(1, n_char_order + 1)])
    pred_word_total = np.array([_totals(pred_word).get(n, 0.0) for n in range(1, n_word_order + 1)])

    best = (-1.0, None)
    for tgt in targets:
        t_char, t_word = _sentence_counts(tgt, n_char_order, n_word_order, lowercase, whitespace)
        m_char = np.array([_matching_counts(pred_char, t_char).get(n, 0.0) for n in range(1, n_char_order + 1)])
        m_word = np.array([_matching_counts(pred_word, t_word).get(n, 0.0) for n in range(1, n_word_order + 1)])
        t_char_total = np.array([_totals(t_char).get(n, 0.0) for n in range(1, n_char_order + 1)])
        t_word_total = np.array([_totals(t_word).get(n, 0.0) for n in range(1, n_word_order + 1)])
        f_char = _fscore_from_totals(m_char, t_char_total, pred_char_total, beta)
        f_word = _fscore_from_totals(m_word, t_word_total, pred_word_total, beta)
        score = float((f_char.sum() + f_word.sum()) / n_order)
        if score > best[0]:
            best = (score, (m_char, m_word, t_char_total, t_word_total))
    score, (m_char, m_word, t_char_total, t_word_total) = best
    return score, m_char, m_word, t_char_total, t_word_total


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """Accumulate corpus totals; returns the six per-order count vectors
    plus sentence-level scores."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else t for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    tot_p_char = np.zeros(n_char_order)
    tot_p_word = np.zeros(n_word_order)
    tot_t_char = np.zeros(n_char_order)
    tot_t_word = np.zeros(n_word_order)
    tot_m_char = np.zeros(n_char_order)
    tot_m_word = np.zeros(n_word_order)
    sentence_scores: List[float] = []
    for pred, targets in zip(preds, target):
        p_char, p_word = _sentence_counts(pred, n_char_order, n_word_order, lowercase, whitespace)
        tot_p_char += np.array([_totals(p_char).get(n, 0.0) for n in range(1, n_char_order + 1)])
        tot_p_word += np.array([_totals(p_word).get(n, 0.0) for n in range(1, n_word_order + 1)])
        score, m_char, m_word, t_char_total, t_word_total = _sentence_chrf(
            p_char, p_word, targets, n_char_order, n_word_order, beta, lowercase, whitespace
        )
        sentence_scores.append(score)
        tot_m_char += m_char
        tot_m_word += m_word
        tot_t_char += t_char_total
        tot_t_word += t_word_total
    return tot_p_char, tot_p_word, tot_t_char, tot_t_word, tot_m_char, tot_m_word, sentence_scores


def _chrf_score_compute(
    tot_p_char: np.ndarray,
    tot_p_word: np.ndarray,
    tot_t_char: np.ndarray,
    tot_t_word: np.ndarray,
    tot_m_char: np.ndarray,
    tot_m_word: np.ndarray,
    beta: float,
) -> Tensor:
    """Corpus chrF from totals."""
    f_char = _fscore_from_totals(np.asarray(tot_m_char), np.asarray(tot_t_char), np.asarray(tot_p_char), beta)
    f_word = _fscore_from_totals(np.asarray(tot_m_word), np.asarray(tot_t_word), np.asarray(tot_p_word), beta)
    n_order = len(f_char) + len(f_word)
    return torch.tensor((f_char.sum() + f_word.sum()) / n_order, dtype=torch.float32)


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """chrF/chrF++ score."""
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    *totals, sentence_scores = _chrf_score_update(
        preds, target, n_char_order, n_word_order, beta, lowercase, whitespace
    )
    score = _chrf_score_compute(*totals, beta)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32)
    return score
