# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BERTScore module metric (counterpart of ``torchmetrics_tpu/text/bert.py``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bert import _DEFAULT_MODEL, _load_default_model, bert_score
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


def _token_state(values: Any, device: torch.device) -> Tensor:
    """A tokenizer's array as a state tensor: int64 becomes int32, as ``jnp.asarray`` makes it."""
    t = torch.from_numpy(np.array(values, copy=True))
    return t.to(device, torch.int32 if t.dtype == torch.int64 else t.dtype)


def _stream(state: Any) -> np.ndarray:
    return np.concatenate([np.asarray(x.cpu()) for x in state]) if isinstance(state, list) else np.asarray(state.cpu())


class BERTScore(Metric):
    """BERTScore.

    States are the tokenized ``input_ids``/``attention_mask`` streams
    (``dist_reduce_fx="cat"``, int32, padded to ``max_length``); the
    transformer runs once at ``compute``, where its parameters are (the
    default model goes to the metric's device).
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Any] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path or _DEFAULT_MODEL
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.user_forward_fn = user_forward_fn
        self.verbose = verbose
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.baseline_url = baseline_url
        if model is None:
            self.model, self.tokenizer = _load_default_model(self.model_name_or_path)
            self.model = self.model.to(self.device)
        else:
            self.model = model
            self.tokenizer = user_tokenizer

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

    def compute(self) -> Dict[str, Tensor]:
        """Run the transformer over the stored stream."""
        preds = {"input_ids": _stream(self.preds_input_ids), "attention_mask": _stream(self.preds_attention_mask)}
        target = {"input_ids": _stream(self.target_input_ids), "attention_mask": _stream(self.target_attention_mask)}
        return bert_score(
            preds,
            target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_tokenizer=self.tokenizer,
            user_forward_fn=self.user_forward_fn,
            verbose=self.verbose,
            idf=self.idf,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            baseline_url=self.baseline_url,
        )

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
