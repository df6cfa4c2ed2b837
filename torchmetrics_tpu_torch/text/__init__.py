# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Text module metrics of the port (counterpart of ``torchmetrics_tpu/text``)."""
from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.infolm import InfoLM
from torchmetrics_tpu_torch.text.metrics import (
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    MatchErrorRate,
    Perplexity,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
