# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIPScore module metric (counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``)."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update, _get_clip_model_and_processor
from torchmetrics_tpu_torch.metric import Metric

Tensor = torch.Tensor


class CLIPScore(Metric):
    """CLIPScore: the mean over the pairs of ``100 * cos(E_I, E_C)``, clamped at 0.

    ``model``/``processor`` inject any CLIP-compatible pair (a transformers
    ``CLIPModel`` and a processor called as ``CLIPProcessor`` is); otherwise
    ``model_name_or_path`` is read from the local Hugging Face cache and the
    model moved to the metric's device. The towers run on the metric's
    device, where an injected model must be.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(
        self,
        model_name_or_path: str = "openai/clip-vit-large-patch14",
        model: Optional[Any] = None,
        processor: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model, self.processor = _get_clip_model_and_processor(model_name_or_path, model, processor, self.device)
        self.add_state("score", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, images: Union[Tensor, List[Tensor]], text: Union[str, List[str]]) -> None:
        """Add the batch's scores and its number of pairs."""
        score, n_samples = _clip_score_update(images, text, self.model, self.processor, self.device)
        self.score = self.score + score.sum()
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> Tensor:
        """The mean score, clamped at 0."""
        return torch.clamp(self.score / self.n_samples, min=0.0)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
