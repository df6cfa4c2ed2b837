# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Extended edit distance (counterpart of ``torchmetrics_tpu/functional/text/eed.py``).

Implements the published EED measure (Stanchev, Wang, Ney, WMT 2019): a
CDER-style character-level alignment grid with jump penalties and a coverage
cost. The per-reference-character row update is a vectorized numpy
recurrence (the deletion term is a prefix-min scan), host work as in JAX;
the scores become float32 where JAX casts them.
"""
from __future__ import annotations

import re
import unicodedata
from typing import List, Sequence, Union

import numpy as np
import torch

Tensor = torch.Tensor


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """EED score for one (hyp, ref) string pair (the algorithm of
    rwth-i6/ExtendedEditDistance).

    ``row[i]`` holds the cheapest path cost from (0,0) to (i, w) in the CDER
    grid; each reference character triggers one vectorized row update.
    """
    n_h = len(hyp)
    hyp_arr = np.array(list(hyp)) if n_h else np.zeros(0, dtype="<U1")
    number_of_visits = np.full(n_h + 1, -1, dtype=np.int64)
    row = np.ones(n_h + 1, dtype=np.float64)
    row[0] = 0.0
    offsets = np.arange(n_h + 1) * deletion

    for w in range(len(ref)):
        ref_char = ref[w]
        next_row = np.empty(n_h + 1, dtype=np.float64)
        next_row[0] = row[0] + 1.0
        if n_h:
            sub = row[:-1] + (hyp_arr != ref_char)
            ins = row[1:] + insertion
            base = np.minimum(sub, ins)
            # deletion chains: next_row[i] = min over j<=i of b[j] + (i-j)*del
            b = np.concatenate([[next_row[0]], base])
            next_row = offsets + np.minimum.accumulate(b - offsets)
        min_index = int(np.argmin(next_row))
        number_of_visits[min_index] += 1
        # long jumps are allowed at word boundaries of the reference
        if ref_char == " ":
            next_row = np.minimum(next_row, alpha + next_row[min_index])
        row = next_row

    coverage = rho * float(np.where(number_of_visits >= 0, number_of_visits, 1).sum())
    return min(1.0, (float(row[-1]) + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    for pattern, replacement in (
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ):
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing: NFKC normalization."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_compute(sentence_level_scores: List[float]) -> Tensor:
    """Average of sentence scores."""
    if len(sentence_level_scores) == 0:
        return torch.tensor(0.0)
    return torch.tensor(sum(sentence_level_scores) / len(sentence_level_scores), dtype=torch.float32)


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Sentence-level EED scores."""
    if language not in ("en", "ja"):
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preprocess = _preprocess_en if language == "en" else _preprocess_ja
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    preds = [preprocess(p) for p in preds]
    target = [[preprocess(t) for t in tgt] for tgt in target]
    if 0 in (len(preds), len(target[0]) if target else 0):
        return []
    scores: List[float] = []
    for hyp, refs in zip(preds, target):
        scores.append(min(_eed_function(hyp, ref, alpha, rho, deletion, insertion) for ref in refs))
    return scores


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
):
    """EED."""
    for param_name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
    sentence_eed = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    average = _eed_compute(sentence_eed)
    if return_sentence_level_score:
        return average, torch.tensor(sentence_eed, dtype=torch.float32)
    return average
