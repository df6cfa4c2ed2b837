# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SQuAD exact match and F1 (counterpart of ``torchmetrics_tpu/functional/text/squad.py``)."""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple

import torch

from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

Tensor = torch.Tensor

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


_PUNCTUATION = frozenset(string.punctuation)


def _normalize_text(s: str) -> str:
    """Lower, strip punctuation/articles, squeeze whitespace."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in _PUNCTUATION)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    """Tokens of the normalized text."""
    return [] if not s else _normalize_text(s).split()


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-overlap F1."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return (2 * precision * recall) / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    """Exact match on normalized text."""
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]) -> float:
    """Best score over the reference answers."""
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds, targets) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Normalize/validate user inputs to (id→answer, squad-target)."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {prediction["id"]: prediction["prediction_text"] for prediction in preds}
    _fn_answer = lambda tgt: {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}
    targets_dict = [{"paragraphs": [{"qas": [_fn_answer(target) for target in targets]}]}]
    return preds_dict, targets_dict


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[Tensor, Tensor, Tensor]:
    """Summed F1, EM and example count, float32 scalars (JAX's ``jnp.asarray`` of Python floats)."""
    f1 = exact_match = total = 0.0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return (
        torch.tensor(f1, dtype=torch.float32),
        torch.tensor(exact_match, dtype=torch.float32),
        torch.tensor(total, dtype=torch.float32),
    )


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    """100-scaled means."""
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds, target) -> Dict[str, Tensor]:
    """SQuAD v1.1 EM/F1."""
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict)
    return _squad_compute(f1, exact_match, total)
