# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""InfoLM (counterpart of ``torchmetrics_tpu/functional/text/infolm.py``).

Information measures between masked-language-model token distributions of
candidate and reference sentences (Staerman et al., 2021). As in JAX, all
masked variants of a batch of sentences are stacked into one ``(S*B, S)``
batch for one MLM forward, and the distribution at each variant's masked
position is taken from the logits at that position alone (the diagonal is
selected before the softmax). The model is a PyTorch masked LM
(``transformers.AutoModelForMaskedLM``, or any module with its call
signature passed as ``model``) and runs where its parameters are; the
default model is read from the local Hugging Face cache only.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bert import _model_device
from torchmetrics_tpu_torch.utilities.imports import _TRANSFORMERS_AVAILABLE

Tensor = torch.Tensor

ALLOWED_INFORMATION_MEASURES = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


class _InformationMeasure:
    """Dispatch and validation of the nine measures."""

    def __init__(self, information_measure: str, alpha: Optional[float] = None, beta: Optional[float] = None) -> None:
        if information_measure not in ALLOWED_INFORMATION_MEASURES:
            raise ValueError(
                f"Argument `information_measure` expected to be one of {ALLOWED_INFORMATION_MEASURES},"
                f" but got {information_measure}."
            )
        self.information_measure = information_measure
        if information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence"):
            if not isinstance(alpha, float) or alpha in (0, 1):
                raise ValueError(f"Parameter `alpha` is expected to be a float differing from 0 and 1, got {alpha}.")
        if information_measure in ("beta_divergence", "ab_divergence"):
            if not isinstance(beta, float) or beta in (0, -1):
                raise ValueError(f"Parameter `beta` is expected to be a float differing from 0 and -1, got {beta}.")
        if information_measure == "ab_divergence" and (alpha is not None and beta is not None and alpha + beta == 0):
            raise ValueError(f"Parameters `alpha` and `beta` cannot sum to 0, got {alpha} and {beta}.")
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        fn = getattr(self, f"_calculate_{self.information_measure}")
        return torch.nan_to_num(fn(preds_distribution, target_distribution))

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sqrt(torch.sum((t - p) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.amax(torch.abs(t - p), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sqrt(p * t).sum(-1), 0, 1))


def _get_special_tokens_map(tokenizer: Any) -> Dict[str, int]:
    """The special token ids the masking needs."""
    return {
        "mask_token_id": tokenizer.mask_token_id,
        "pad_token_id": tokenizer.pad_token_id,
        "sep_token_id": tokenizer.sep_token_id,
        "cls_token_id": tokenizer.cls_token_id,
    }


def _get_token_mask(input_ids: np.ndarray, special_tokens_map: Dict[str, int]) -> np.ndarray:
    """True for real (non-special) tokens."""
    mask = np.ones_like(input_ids, dtype=bool)
    for key in ("pad_token_id", "sep_token_id", "cls_token_id"):
        mask &= input_ids != special_tokens_map[key]
    return mask


def _get_tokens_idf(input_ids: np.ndarray, token_mask: np.ndarray) -> np.ndarray:
    """Per-position plus-one-smoothed idf weights."""
    num_sentences = input_ids.shape[0]
    counter: Counter = Counter()
    for row, mask in zip(input_ids, token_mask):
        counter.update(set(row[mask].tolist()))
    idf: Dict[int, float] = defaultdict(lambda: math.log((num_sentences + 1) / 1))
    idf.update({idx: math.log((num_sentences + 1) / (count + 1)) for idx, count in counter.items()})
    return np.vectorize(lambda t: idf[int(t)])(input_ids).astype(np.float64)


def _get_data_distribution(
    model: Any,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    temperature: float,
    idf: bool,
    special_tokens_map: Dict[str, int],
    batch_size: int = 8,
) -> Tensor:
    """Per-sentence vocabulary distribution: the MLM's distribution at each
    masked real token, idf-weighted and averaged, with all masked variants
    of a batch in one forward."""
    token_mask = _get_token_mask(input_ids, special_tokens_map)
    idf_weights = _get_tokens_idf(input_ids, token_mask) if idf else np.ones_like(token_mask, dtype=np.float64)
    mask_token_id = int(special_tokens_map["mask_token_id"])
    device = _model_device(model)
    out = []
    with torch.no_grad():
        for start in range(0, input_ids.shape[0], batch_size):
            ids = torch.from_numpy(np.ascontiguousarray(input_ids[start : start + batch_size])).to(device).long()
            att = torch.from_numpy(np.ascontiguousarray(attention_mask[start : start + batch_size])).to(device).long()
            tmask = torch.from_numpy(token_mask[start : start + batch_size]).to(device, torch.float32)
            w_idf = torch.from_numpy(idf_weights[start : start + batch_size].astype(np.float32)).to(device)
            b, s = ids.shape
            # (S, B, S): variant l has position l replaced with [MASK]
            eye = torch.eye(s, dtype=torch.bool, device=device)[:, None, :]
            ids_rep = torch.where(eye, torch.full_like(ids, mask_token_id)[None], ids[None].expand(s, b, s))
            att_rep = att[None].expand(s, b, s)
            logits = model(input_ids=ids_rep.reshape(s * b, s), attention_mask=att_rep.reshape(s * b, s)).logits
            logits = logits.reshape(s, b, s, -1)
            positions = torch.arange(s, device=device)
            # the distribution at the masked position of each variant -> (B, S, V)
            probs = torch.softmax(logits[positions, :, positions].to(torch.float32) / np.float32(temperature), dim=-1)
            probs = probs.movedim(0, 1)
            weights = tmask * w_idf
            probs = probs * (w_idf * tmask)[:, :, None]
            out.append(probs.sum(dim=1) / weights.sum(dim=1, keepdim=True))
    return torch.cat(out)


def _load_default_mlm(model_name_or_path: str):
    """The tokenizer and the masked LM from the local Hugging Face cache (nothing is downloaded)."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`infolm` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoModelForMaskedLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModelForMaskedLM.from_pretrained(model_name_or_path, local_files_only=True)
    return tokenizer, model


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    device: Optional[Any] = None,
    max_length: Optional[int] = None,
    batch_size: int = 64,
    num_threads: int = 0,
    verbose: bool = True,
    return_sentence_level_score: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
):
    """InfoLM. The masked LM runs where ``model``'s parameters are (the default model goes to ``device``, the card unless given)."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sententes must be the same!")
    if not (isinstance(temperature, float) and temperature > 0):
        raise ValueError(f"Argument `temperature` is expected to be a positive float, got {temperature}.")
    measure = _InformationMeasure(information_measure, alpha, beta)
    tokenizer = user_tokenizer
    if model is None:
        tokenizer, model = _load_default_mlm(model_name_or_path)
        model = model.to(device if device is not None else "cuda")
    max_length = max_length or getattr(getattr(model, "config", None), "max_position_embeddings", 512)
    special_tokens_map = _get_special_tokens_map(tokenizer)

    enc_p = tokenizer(list(preds), padding=True, truncation=True, max_length=max_length, return_tensors="np")
    enc_t = tokenizer(list(target), padding=True, truncation=True, max_length=max_length, return_tensors="np")
    preds_distribution = _get_data_distribution(
        model, np.asarray(enc_p["input_ids"]), np.asarray(enc_p["attention_mask"]), temperature, idf,
        special_tokens_map, batch_size=min(batch_size, 8),
    )
    target_distribution = _get_data_distribution(
        model, np.asarray(enc_t["input_ids"]), np.asarray(enc_t["attention_mask"]), temperature, idf,
        special_tokens_map, batch_size=min(batch_size, 8),
    )
    info_lm_score = measure(preds_distribution, target_distribution)
    if return_sentence_level_score:
        return info_lm_score.mean(), info_lm_score
    return info_lm_score.mean()
