# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Optional-dependency flags (counterpart of ``torchmetrics_tpu/utilities/imports.py``).

The port's own copy, standard library only: a flag probes
``importlib.util.find_spec`` once, lazily, and never imports the module.
It holds the flags the ported domains read (audio's PESQ and DNSMOS; text's
``intl`` tokenizer, ROUGE's stemmer and the transformer towers of BERTScore
and InfoLM); the JAX package's other flags come with the domains that read them.
"""
from __future__ import annotations

import importlib
import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def _module_available(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except (ImportError, ModuleNotFoundError, ValueError):
        return False


class ModuleAvailableCache:
    """Lazy boolean flag for an optional dependency, ``bool(flag)`` probes once."""

    def __init__(self, module: str) -> None:
        self.module = module

    def __bool__(self) -> bool:
        return _module_available(self.module)

    def __repr__(self) -> str:
        return f"ModuleAvailableCache({self.module!r}, available={bool(self)})"


_PESQ_AVAILABLE = ModuleAvailableCache("pesq")
_ONNXRUNTIME_AVAILABLE = ModuleAvailableCache("onnxruntime")
_REGEX_AVAILABLE = ModuleAvailableCache("regex")
_NLTK_AVAILABLE = ModuleAvailableCache("nltk")
_TRANSFORMERS_AVAILABLE = ModuleAvailableCache("transformers")
