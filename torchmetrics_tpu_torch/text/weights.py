# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BERT weights carried from a Flax parameter tree into PyTorch.

:func:`bert_params_from_jax` turns the parameter tree of a Flax BERT
(``FlaxBertModel`` or ``FlaxBertForMaskedLM``, as nested dicts of numpy
arrays) into a ``state_dict`` of the matching ``transformers`` PyTorch
class (``BertModel`` or ``BertForMaskedLM``), so BERTScore and InfoLM can
run the weights the JAX package runs. Standard library, numpy and torch
only: it reads no Flax.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

#: the state_dict entries a tree has no leaf for: the MLM's decoder, tied to
#: the word embeddings and to ``cls.predictions.bias``, and the position ids buffer
_TIED_OR_BUFFERS = ("cls.predictions.decoder.weight", "cls.predictions.decoder.bias", "position_ids", "token_type_ids")


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, (*prefix, str(key)))
        else:
            yield (*prefix, str(key)), value


def bert_params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A PyTorch ``state_dict`` of the Flax BERT parameter ``tree``.

    Dense ``kernel`` (in, out) becomes ``weight`` (out, in); ``embedding``
    becomes ``weight``; LayerNorm's ``scale`` becomes ``weight``; every other
    leaf keeps its name and values. A tree under ``{"params": ...}`` is
    unwrapped.
    """
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        value = np.array(leaf, dtype=np.float32)  # a copy: the tensor must own writable memory
        *head, name = path
        if name == "kernel":
            name, value = "weight", value.T
        elif name in ("embedding", "scale"):
            name = "weight"
        out[".".join((*head, name))] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def load_bert_params(model: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Load :func:`bert_params_from_jax` of ``tree`` into ``model``; raises if
    a parameter is left out or a leaf has no place, but the tied decoder and
    the buffers."""
    missing, unexpected = model.load_state_dict(bert_params_from_jax(tree), strict=False)
    missing = [k for k in missing if not k.endswith(_TIED_OR_BUFFERS)]
    if missing or unexpected:
        raise ValueError(f"the Flax tree does not fit {type(model).__name__}: missing {missing}, unexpected {list(unexpected)}")
    if hasattr(model, "tie_weights"):
        model.tie_weights()
    return model


__all__ = ["bert_params_from_jax", "load_bert_params"]
