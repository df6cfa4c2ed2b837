# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""ROUGE score (counterpart of ``torchmetrics_tpu/functional/text/rouge.py``).

Host work in Python and numpy, as in JAX; each pair's scores are float32
scalars, and the means over pairs add in XLA's order
(``_mean_last_in_xla_order``), JAX's ``jnp.mean``.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order
from torchmetrics_tpu_torch.utilities.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


def _split_sentence(x: str) -> Sequence[str]:
    """Sentence split for rougeLsum: nltk's punkt where its data is installed,
    else a punctuation regex, the same branch as JAX's, so both packages
    split alike on one machine."""
    try:
        import nltk

        try:
            return nltk.sent_tokenize(x)
        except LookupError:
            pass
    except ImportError:
        pass
    re_split = re.split(r"(?<=[.!?])\s+", x.strip())
    return [s for s in re_split if s]


def _zero_scores() -> Dict[str, Tensor]:
    return {"precision": torch.tensor(0.0), "recall": torch.tensor(0.0), "fmeasure": torch.tensor(0.0)}


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, Tensor]:
    """precision/recall/fmeasure triple."""
    precision = hits_or_lcs / pred_len if pred_len > 0 else 0.0
    recall = hits_or_lcs / target_len if target_len > 0 else 0.0
    if precision == recall == 0.0:
        return _zero_scores()
    fmeasure = 2 * precision * recall / (precision + recall)
    return {
        "precision": torch.tensor(precision, dtype=torch.float32),
        "recall": torch.tensor(recall, dtype=torch.float32),
        "fmeasure": torch.tensor(fmeasure, dtype=torch.float32),
    }


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str], return_full_table: bool = False):
    """Longest common subsequence DP, with the row recurrence vectorized in
    numpy over the tokens' hashes, as in JAX."""
    m, n = len(pred_tokens), len(target_tokens)
    table = np.zeros((n + 1, m + 1), dtype=np.int64)
    if m and n:
        pred_arr = np.array([hash(t) for t in pred_tokens])
        for i in range(1, n + 1):
            match = pred_arr == hash(target_tokens[i - 1])
            prev = table[i - 1]
            row = np.where(match, prev[:-1] + 1, 0)
            # running max fold: table[i][j] = max(row[j], table[i-1][j], table[i][j-1])
            cur = np.maximum(row, prev[1:])
            table[i, 1:] = np.maximum.accumulate(cur)
    if return_full_table:
        return table
    return int(table[-1, -1])


def _backtracked_lcs(lcs_table, pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> Sequence[int]:
    """Indices of target tokens on the LCS path."""
    i = len(pred_tokens)
    j = len(target_tokens)
    backtracked: List[int] = []
    while i > 0 and j > 0:
        if pred_tokens[i - 1] == target_tokens[j - 1]:
            backtracked.insert(0, j - 1)
            i -= 1
            j -= 1
        elif lcs_table[j][i - 1] > lcs_table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return backtracked


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> Sequence[str]:
    """Union of per-sentence LCS indices."""

    def lcs_ind(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> Sequence[int]:
        lcs_table = _lcs(pred_tokens, target_tokens, return_full_table=True)
        return _backtracked_lcs(lcs_table, pred_tokens, target_tokens)

    lcs_union: set = set()
    for pred_tokens in pred_tokens_list:
        lcs_union = lcs_union.union(lcs_ind(pred_tokens, target_tokens))
    return [target_tokens[i] for i in sorted(lcs_union)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """rouge-score-style normalization + tokenization."""
    if normalizer is not None:
        text = normalizer(text)
    else:
        text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if tokenizer is not None else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, Tensor]:
    """ROUGE-N."""

    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return _zero_scores()
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams) & set(target_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, Tensor]:
    """ROUGE-L."""
    if 0 in (len(pred), len(target)):
        return _zero_scores()
    lcs = _lcs(pred, target)
    return _compute_metrics(lcs, len(pred), len(target))


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, Tensor]:
    """ROUGE-Lsum over sentence splits."""
    if 0 in (len(pred), len(target)):
        return _zero_scores()

    def _get_token_counts(sentences: Sequence[Sequence[str]]) -> Counter:
        ngrams: Counter = Counter()
        for sentence in sentences:
            ngrams.update(sentence)
        return ngrams

    pred_tokens_count = _get_token_counts(pred)
    target_tokens_count = _get_token_counts(target)
    hits = 0
    for tgt in target:
        lcs_words = _union_lcs(pred, tgt)
        for w in lcs_words:
            if pred_tokens_count[w] > 0 and target_tokens_count[w] > 0:
                hits += 1
                pred_tokens_count[w] -= 1
                target_tokens_count[w] -= 1
    return _compute_metrics(hits, sum(len(s) for s in pred), sum(len(s) for s in target))


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, Tensor]]]:
    """Per-pair ROUGE with best/avg multi-reference accumulation."""
    results: Dict[Union[int, str], List[Dict[str, Tensor]]] = {rouge_key: [] for rouge_key in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        result_inner: Dict[Union[int, str], Dict[str, Tensor]] = {}
        result_avg: Dict[Union[int, str], List[Dict[str, Tensor]]] = {rouge_key: [] for rouge_key in rouge_keys_values}
        list_results = []
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        pred_lsum = None
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)
            ]

        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            if "Lsum" in rouge_keys_values:
                target_lsum = [
                    _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                    for s in _split_sentence(target_raw_inner)
                ]
            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred, tgt, rouge_key)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    score = _rouge_lsum_score(pred_lsum, target_lsum)
                result_inner[rouge_key] = score
                result_avg[rouge_key].append(score)
            list_results.append(result_inner.copy())

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            all_fmeasure = np.array([float(v[key_curr]["fmeasure"]) for v in list_results])
            highest_idx = int(np.argmax(all_fmeasure))
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        else:  # avg
            for rouge_key, metrics in result_avg.items():
                avg = {
                    t: _mean_last_in_xla_order(torch.stack([m[t] for m in metrics])) for t in ("fmeasure", "precision", "recall")
                }
                results[rouge_key].append(avg)
    return results


def _rouge_score_compute(sentence_results: Dict[str, List[Tensor]]) -> Dict[str, Tensor]:
    """Mean over samples."""
    results: Dict[str, Tensor] = {}
    for rouge_key, scores in sentence_results.items():
        results[rouge_key] = _mean_last_in_xla_order(torch.stack(scores)) if scores else torch.tensor(0.0)
    return results


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
) -> Dict[str, Tensor]:
    """ROUGE score."""
    if use_stemmer:
        if not _NLTK_AVAILABLE:
            raise ModuleNotFoundError("Stemmer requires the nltk package: pip install nltk")
        from nltk.stem.porter import PorterStemmer

        stemmer = PorterStemmer()
    else:
        stemmer = None

    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )
    output: Dict[str, List[Tensor]] = {}
    for rouge_key, metrics in sentence_results.items():
        for metric in metrics:
            for tp, value in metric.items():
                output.setdefault(f"rouge{rouge_key}_{tp}", []).append(value)
    return {name: _mean_last_in_xla_order(torch.stack(vals)) for name, vals in output.items()}
