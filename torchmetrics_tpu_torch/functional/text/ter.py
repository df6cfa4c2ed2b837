# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Translation edit rate (counterpart of ``torchmetrics_tpu/functional/text/ter.py``).

Implements the published Tercom algorithm (Snover et al. 2006) the way
sacrebleu's ``lib_ter`` specifies it: greedy best-shift search on the
hypothesis over a word-level Levenshtein distance against the reference,
``TER = (shifts + edits) / avg reference length``. The Levenshtein rows are
vectorized numpy recurrences; the trace and alignment semantics (op
preference sub > hyp-deletion > insertion on ties) match Tercom so shift
candidates rank identically. Host work in numpy, as in JAX; the statistics
become float32 where JAX casts them.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor

# Tercom-inspired limits (the same constants as sacrebleu)
_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

_ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
_FULL_WIDTH_PUNCT = r"([．，？：；！＂（）])"


class _TercomTokenizer:
    """Tercom normalizer (the rules of jhclark/tercom ``Normalizer.java`` as sacrebleu publishes them)."""

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)
            if self.asian_support:
                sentence = re.sub(_ASIAN_PUNCT, "", sentence)
                sentence = re.sub(_FULL_WIDTH_PUNCT, "", sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = re.sub(r"\n-", "", sentence)
        sentence = re.sub(r"\n", " ", sentence)
        sentence = re.sub(r"&quot;", '"', sentence)
        sentence = re.sub(r"&amp;", "&", sentence)
        sentence = re.sub(r"&lt;", "<", sentence)
        sentence = re.sub(r"&gt;", ">", sentence)
        sentence = f" {sentence} "
        sentence = re.sub(r"([{-~[-` -&(-+:-@/])", r" \1 ", sentence)
        sentence = re.sub(r"'s ", r" 's ", sentence)
        sentence = re.sub(r"'s$", r" 's", sentence)
        sentence = re.sub(r"([^0-9])([\.,])", r"\1 \2 ", sentence)
        sentence = re.sub(r"([\.,])([^0-9])", r" \1 \2", sentence)
        sentence = re.sub(r"([0-9])(-)", r"\1 \2 ", sentence)
        return sentence

    @staticmethod
    def _normalize_asian(sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(_ASIAN_PUNCT, r" \1 ", sentence)
        sentence = re.sub(_FULL_WIDTH_PUNCT, r" \1 ", sentence)
        return sentence


# DP op codes: 0 = match/sub (diagonal), 1 = hyp word dropped (up),
# 2 = ref word inserted (left). Tie preference follows Tercom: diag, up, left.
_OP_DIAG, _OP_UP, _OP_LEFT = 0, 1, 2


def _levenshtein_with_alignment(
    hyp: List[str], ref: List[str]
) -> Tuple[int, Dict[int, int], List[int], List[int]]:
    """Word Levenshtein + Tercom-style alignment of ref positions to hyp.

    Returns ``(distance, align, ref_errors, hyp_errors)`` where ``align``
    maps each reference index to the hyp index it is aligned with (the
    current hyp position for insertions), matching sacrebleu's
    ``trace_to_alignment`` of the flipped trace.
    """
    n_h, n_r = len(hyp), len(ref)
    # cost matrix computed row-wise with numpy; ops tracked for backtrace
    dist = np.zeros((n_h + 1, n_r + 1), dtype=np.int64)
    ops = np.zeros((n_h + 1, n_r + 1), dtype=np.int8)
    dist[0, :] = np.arange(n_r + 1)
    ops[0, 1:] = _OP_LEFT
    dist[1:, 0] = np.arange(1, n_h + 1)
    ops[1:, 0] = _OP_UP
    ref_arr = np.asarray(ref, dtype=object)
    offsets = np.arange(n_r + 1)
    for i in range(1, n_h + 1):
        sub_cost = (ref_arr != hyp[i - 1]).astype(np.int64)
        prev = dist[i - 1]
        # strictly-better preference order: diagonal, up, left (Tercom)
        base = prev[:-1] + sub_cost
        op_row = np.zeros(n_r, dtype=np.int8)
        up = prev[1:] + 1
        better_up = up < base
        base = np.where(better_up, up, base)
        op_row = np.where(better_up, _OP_UP, op_row)
        # the left-neighbour dependency row[j] = min(b[j], row[j-1] + 1) is a
        # prefix scan: row[j] = j + cummin(b[k] - k), with b[0] = boundary i
        b = np.concatenate([[i], base])
        row_full = offsets + np.minimum.accumulate(b - offsets)
        from_left = row_full[1:] < base
        op_row = np.where(from_left, _OP_LEFT, op_row)
        dist[i] = row_full
        ops[i, 1:] = op_row
    # backtrace -> alignment
    align: Dict[int, int] = {}
    ref_err: List[int] = []
    hyp_err: List[int] = []
    trace: List[int] = []
    i, j = n_h, n_r
    while i > 0 or j > 0:
        op = ops[i, j]
        trace.append(op)
        if op == _OP_DIAG:
            i -= 1
            j -= 1
        elif op == _OP_UP:
            i -= 1
        else:
            j -= 1
    pos_hyp, pos_ref = -1, -1
    for op in reversed(trace):
        if op == _OP_DIAG:
            pos_hyp += 1
            pos_ref += 1
            align[pos_ref] = pos_hyp
            err = int(hyp[pos_hyp] != ref[pos_ref])
            hyp_err.append(err)
            ref_err.append(err)
        elif op == _OP_UP:
            pos_hyp += 1
            hyp_err.append(1)
        else:
            pos_ref += 1
            align[pos_ref] = pos_hyp
            ref_err.append(1)
    return int(dist[n_h, n_r]), align, ref_err, hyp_err


def _edit_distance_only(hyp: List[str], ref: List[str]) -> int:
    """Plain word-level Levenshtein distance (vectorized rows)."""
    n_r = len(ref)
    prev = np.arange(n_r + 1, dtype=np.int64)
    ref_arr = np.asarray(ref, dtype=object)
    offsets = np.arange(n_r + 1)
    for i, h in enumerate(hyp, start=1):
        base = np.minimum(prev[:-1] + (ref_arr != h), prev[1:] + 1)
        b = np.concatenate([[i], base])
        prev = offsets + np.minimum.accumulate(b - offsets)
    return int(prev[-1])


def _find_shifted_pairs(hyp: List[str], ref: List[str]):
    """Matching word sub-sequences eligible for shifting."""
    for hyp_start in range(len(hyp)):
        for ref_start in range(len(ref)):
            if abs(ref_start - hyp_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if hyp[hyp_start + length - 1] != ref[ref_start + length - 1]:
                    break
                yield hyp_start, ref_start, length
                if len(hyp) == hyp_start + length or len(ref) == ref_start + length:
                    break


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` to position ``target``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start]
        + words[start + length : length + target]
        + words[start : start + length]
        + words[length + target :]
    )


def _best_shift(
    hyp: List[str], ref: List[str], base_distance: int, checked_candidates: int
) -> Tuple[int, List[str], int]:
    """One round of greedy shift search."""
    _, align, ref_err, hyp_err = _levenshtein_with_alignment(hyp, ref)
    best: Optional[Tuple] = None
    for hyp_start, ref_start, length in _find_shifted_pairs(hyp, ref):
        # skip if the hypothesis span is already correct, the reference span
        # already matches, or the shift would land within the span itself
        if sum(hyp_err[hyp_start : hyp_start + length]) == 0:
            continue
        if sum(ref_err[ref_start : ref_start + length]) == 0:
            continue
        if hyp_start <= align[ref_start] < hyp_start + length:
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if ref_start + offset == -1:
                idx = 0
            elif ref_start + offset in align:
                idx = align[ref_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted = _perform_shift(hyp, hyp_start, length, idx)
            candidate = (
                base_distance - _edit_distance_only(shifted, ref),
                length,
                -hyp_start,
                -idx,
                shifted,
            )
            checked_candidates += 1
            if best is None or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break
    if best is None:
        return 0, hyp, checked_candidates
    return best[0], best[4], checked_candidates


def _sentence_num_edits(hyp: List[str], ref: List[str]) -> int:
    """Shifts + residual edit distance for one (hyp, ref) pair."""
    if len(ref) == 0:
        return len(hyp)
    num_shifts = 0
    checked_candidates = 0
    words = list(hyp)
    while True:
        base_distance = _edit_distance_only(words, ref)
        delta, new_words, checked_candidates = _best_shift(words, ref, base_distance, checked_candidates)
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        words = new_words
    return num_shifts + _edit_distance_only(words, ref)


def _compute_sentence_statistics(
    hyp_words: List[str], ref_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edit count over references + average reference length."""
    total_ref_len = 0.0
    best_num_edits = float("inf")
    for ref in ref_words:
        total_ref_len += len(ref)
        num_edits = _sentence_num_edits(hyp_words, ref)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    return best_num_edits, total_ref_len / len(ref_words)


def _compute_ter_score_from_statistics(num_edits, tgt_length):
    """Score with empty-reference conventions."""
    num_edits = torch.as_tensor(num_edits).to(torch.float32)
    tgt_length = torch.as_tensor(tgt_length).to(num_edits.device, torch.float32)
    one, zero = torch.ones_like(num_edits), torch.zeros_like(num_edits)
    return torch.where(
        (tgt_length > 0) & (num_edits > 0),
        num_edits / torch.clamp(tgt_length, min=1e-16),
        torch.where((tgt_length == 0) & (num_edits > 0), one, zero),
    )


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """Corpus statistics + sentence scores."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    total_num_edits = 0.0
    total_tgt_length = 0.0
    sentence_ter: List[float] = []
    for pred, tgt in zip(preds, target):
        tgt_words = [tokenizer(t).split() for t in tgt]
        pred_words = tokenizer(pred).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words, tgt_words)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        sentence_ter.append(float(_compute_ter_score_from_statistics(num_edits, tgt_length)))
    return total_num_edits, total_tgt_length, sentence_ter


def _ter_compute(total_num_edits, total_tgt_length) -> Tensor:
    """Corpus TER."""
    return _compute_ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
):
    """Translation edit rate."""
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, tokenizer)
    ter = _ter_compute(total_num_edits, total_tgt_length)
    if return_sentence_level_score:
        return ter, torch.tensor(sentence_ter, dtype=torch.float32)
    return ter
