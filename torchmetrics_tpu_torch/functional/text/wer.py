# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Word/char/match error rates and word-information metrics (counterpart of
``torchmetrics_tpu/functional/text/wer.py``). The counts are host integers;
each update returns them as float32 scalars, as JAX's ``jnp.asarray(float)``."""
from __future__ import annotations

from typing import List, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _batch_edit_distance, _normalize_inputs

Tensor = torch.Tensor


def _f32(value: float) -> Tensor:
    return torch.tensor(value, dtype=torch.float32)


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[Tensor, Tensor]:
    """Summed edit operations and the reference word count."""
    preds, target = _normalize_inputs(preds, target)
    pred_tokens = [p.split() for p in preds]
    tgt_tokens = [t.split() for t in target]
    errors = int(_batch_edit_distance(pred_tokens, tgt_tokens).sum())
    total = sum(len(t) for t in tgt_tokens)
    return _f32(float(errors)), _f32(float(total))


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def word_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tensor:
    """Word error rate."""
    errors, total = _wer_update(preds, target)
    return _wer_compute(errors, total)


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[Tensor, Tensor]:
    """Summed character edit operations and the reference character count."""
    preds, target = _normalize_inputs(preds, target)
    errors = int(_batch_edit_distance([list(p) for p in preds], [list(t) for t in target]).sum())
    total = sum(len(t) for t in target)
    return _f32(float(errors)), _f32(float(total))


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def char_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tensor:
    """Character error rate."""
    errors, total = _cer_update(preds, target)
    return _cer_compute(errors, total)


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[Tensor, Tensor]:
    """Summed edit operations and the sum of each pair's longer length."""
    preds, target = _normalize_inputs(preds, target)
    pred_tokens = [p.split() for p in preds]
    tgt_tokens = [t.split() for t in target]
    errors = int(_batch_edit_distance(pred_tokens, tgt_tokens).sum())
    total = sum(max(len(t), len(p)) for p, t in zip(pred_tokens, tgt_tokens))
    return _f32(float(errors)), _f32(float(total))


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    return errors / total


def match_error_rate(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tensor:
    """Match error rate."""
    errors, total = _mer_update(preds, target)
    return _mer_compute(errors, total)


def _wil_wip_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[Tensor, Tensor, Tensor]:
    """The shared accumulation of WIL and WIP: minus the hits, the reference and the prediction word counts."""
    preds, target = _normalize_inputs(preds, target)
    pred_tokens = [p.split() for p in preds]
    tgt_tokens = [t.split() for t in target]
    errors = int(_batch_edit_distance(pred_tokens, tgt_tokens).sum())
    target_total = sum(len(t) for t in tgt_tokens)
    preds_total = sum(len(p) for p in pred_tokens)
    total = sum(max(len(t), len(p)) for p, t in zip(pred_tokens, tgt_tokens))
    return _f32(float(errors - total)), _f32(float(target_total)), _f32(float(preds_total))


def _word_info_lost_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """1 - (C/N_t)(C/N_p)."""
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tensor:
    """Word information lost."""
    errors, target_total, preds_total = _wil_wip_update(preds, target)
    return _word_info_lost_compute(errors, target_total, preds_total)


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """(C/N_t)(C/N_p)."""
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tensor:
    """Word information preserved."""
    errors, target_total, preds_total = _wil_wip_update(preds, target)
    return _wip_compute(errors, target_total, preds_total)
