# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""InfoLM module metric (counterpart of ``torchmetrics_tpu/text/infolm.py``)."""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.infolm import (
    _get_data_distribution,
    _get_special_tokens_map,
    _InformationMeasure,
    _load_default_mlm,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.text.bert import _stream, _token_state

Tensor = torch.Tensor


class InfoLM(Metric):
    """InfoLM.

    States: tokenized ``input_ids``/``attention_mask`` streams for both
    corpora (``dist_reduce_fx="cat"``); the masked-LM forwards run at
    ``compute`` so corpus-level IDF sees the whole stream.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        if not (isinstance(temperature, float) and temperature > 0):
            raise ValueError(f"Argument `temperature` is expected to be a positive float, got {temperature}.")
        self.temperature = temperature
        self.information_measure_cls = _InformationMeasure(information_measure, alpha, beta)
        self.idf = idf
        self.batch_size = batch_size
        self.return_sentence_level_score = return_sentence_level_score
        if model is None:
            self.tokenizer, self.model = _load_default_mlm(model_name_or_path)
            self.model = self.model.to(self.device)
        else:
            self.model = model
            self.tokenizer = user_tokenizer
        self.max_length = max_length or getattr(getattr(self.model, "config", None), "max_position_embeddings", 512)
        self.special_tokens_map = _get_special_tokens_map(self.tokenizer)

        self.add_state("preds_input_ids", [], dist_reduce_fx="cat")
        self.add_state("preds_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        """Tokenize and store."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        if len(preds) != len(target):
            raise ValueError("Number of predicted and reference sententes must be the same!")
        enc_p = self.tokenizer(
            list(preds), padding="max_length", truncation=True, max_length=self.max_length, return_tensors="np"
        )
        enc_t = self.tokenizer(
            list(target), padding="max_length", truncation=True, max_length=self.max_length, return_tensors="np"
        )
        self.preds_input_ids.append(_token_state(enc_p["input_ids"], self.device))
        self.preds_attention_mask.append(_token_state(enc_p["attention_mask"], self.device))
        self.target_input_ids.append(_token_state(enc_t["input_ids"], self.device))
        self.target_attention_mask.append(_token_state(enc_t["attention_mask"], self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        """Masked-LM distributions + information measure."""
        preds_ids, preds_mask = _stream(self.preds_input_ids), _stream(self.preds_attention_mask)
        target_ids, target_mask = _stream(self.target_input_ids), _stream(self.target_attention_mask)
        # trim the max_length padding to the longest real sequence
        real = max(int(preds_mask.sum(1).max()), int(target_mask.sum(1).max()))
        preds_dist = _get_data_distribution(
            self.model, preds_ids[:, :real], preds_mask[:, :real], self.temperature, self.idf,
            self.special_tokens_map, batch_size=min(self.batch_size, 8),
        )
        target_dist = _get_data_distribution(
            self.model, target_ids[:, :real], target_mask[:, :real], self.temperature, self.idf,
            self.special_tokens_map, batch_size=min(self.batch_size, 8),
        )
        scores = self.information_measure_cls(preds_dist, target_dist)
        if self.return_sentence_level_score:
            return scores.mean(), scores
        return scores.mean()

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
