# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BERTScore (counterpart of ``torchmetrics_tpu/functional/text/bert.py``).

The embedding model is a PyTorch transformer (``transformers.AutoModel``,
or any module with its call signature passed as ``model``); the pairwise
token cosines and the greedy max-matching are one batched ``einsum`` and a
max a chunk. JAX runs the whole corpus as one compiled program (a
``lax.map`` over chunks, one dispatch for a remote TPU); the port runs the
same chunks eagerly on the model's device. ``model``, ``user_tokenizer``
and ``user_forward_fn`` are injectable as in JAX, which keeps the metric
usable offline. The default model is read from the local Hugging Face
cache only: nothing is downloaded.

As in JAX, scores come back in input order (the reference permutes its
per-sentence outputs when the inputs are not sorted by length).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.imports import _TRANSFORMERS_AVAILABLE

Tensor = torch.Tensor

_DEFAULT_MODEL = "roberta-large"


def _process_attention_mask_for_special_tokens(attention_mask: np.ndarray) -> np.ndarray:
    """Zero the [CLS] and [SEP] positions."""
    attention_mask = attention_mask.copy()
    attention_mask[:, 0] = 0
    sep_pos = np.cumsum(attention_mask - 0.1, axis=-1).argmax(-1)
    attention_mask[np.arange(attention_mask.shape[0]), sep_pos] = 0
    return attention_mask


def _get_tokens_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """Plus-one-smoothed log inverse document frequencies."""
    num_sentences = input_ids.shape[0]
    counter: Counter = Counter()
    for row, mask in zip(input_ids, attention_mask):
        counter.update(set(row[mask > 0].tolist()))
    idf: Dict[int, float] = defaultdict(lambda: math.log((num_sentences + 1) / 1))
    idf.update({idx: math.log((num_sentences + 1) / (count + 1)) for idx, count in counter.items()})
    return idf


def _model_device(model: Any, device: Optional[Any] = None) -> torch.device:
    """Where the tower runs: ``device`` if given, else the model's parameters' device, else the CPU."""
    if device is not None:
        return torch.device(device)
    params = getattr(model, "parameters", None)
    first = next(iter(params()), None) if callable(params) else None
    return first.device if first is not None else torch.device("cpu")


def _host_side_inputs(
    input_ids: np.ndarray, attention_mask: np.ndarray, idf: bool, tokens_idf: Optional[Dict[int, float]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Trim to the longest real sequence, the special-token mask and the
    per-sentence normalized idf scale (float32)."""
    real_len = int(attention_mask.sum(1).max())
    input_ids = input_ids[:, :real_len]
    attention_mask = attention_mask[:, :real_len]
    pmask = _process_attention_mask_for_special_tokens(attention_mask)
    if idf:
        assert tokens_idf is not None
        weights = np.vectorize(lambda t: tokens_idf[int(t)])(input_ids).astype(np.float64) * pmask
    else:
        weights = pmask.astype(np.float64)
    scale = weights / weights.sum(-1, keepdims=True)
    return input_ids, attention_mask, pmask, scale.astype(np.float32)


def _normalized(out: Tensor, pmask: Tensor) -> Tensor:
    """Unit-norm ``(B, L, S, D)`` token embeddings with the special tokens zeroed."""
    out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)
    return out * pmask[:, None, :, None]


def _pairwise_prf(preds_emb: Tensor, target_emb: Tensor, preds_scale: Tensor, target_scale: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matching precision, recall and F1 of ``(B, L, S, D)``
    embeddings as ``(B, L)``; the layer axis L is 1 unless ``all_layers``."""
    cos_sim = torch.einsum("blpd,blrd->blpr", preds_emb, target_emb)
    precision = (cos_sim.amax(dim=3) * preds_scale[:, None, :]).sum(-1)
    recall = (cos_sim.amax(dim=2) * target_scale[:, None, :]).sum(-1)
    f1 = 2 * precision * recall / (precision + recall)
    return precision, recall, torch.nan_to_num(f1)


def _flatten_layerwise(t: Tensor) -> Tensor:
    """The reference's layout: (L, B), squeezed to (B,) for L == 1."""
    return t.T.squeeze(0) if t.shape[1] == 1 else t.T.reshape(-1)


def _embed(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    model: Any,
    user_forward_fn: Callable,
    idf: bool,
    tokens_idf: Optional[Dict[int, float]],
    batch_size: int,
    device: torch.device,
) -> Tuple[Tensor, Tensor]:
    """Unit-norm token embeddings masked for special tokens and the idf
    scales, through a user-supplied forward (given torch tensors on ``device``)."""
    input_ids, attention_mask, pmask, scale = _host_side_inputs(input_ids, attention_mask, idf, tokens_idf)
    pmask_t = torch.from_numpy(pmask).to(device, torch.float32)
    out = []
    for start in range(0, input_ids.shape[0], batch_size):
        ids = torch.from_numpy(np.ascontiguousarray(input_ids[start : start + batch_size])).to(device)
        mask = torch.from_numpy(np.ascontiguousarray(attention_mask[start : start + batch_size])).to(device)
        with torch.no_grad():
            emb = torch.as_tensor(user_forward_fn(model, {"input_ids": ids, "attention_mask": mask})).to(device)
        out.append(_normalized(emb[:, None].to(torch.float32), pmask_t[start : start + batch_size]))
    return torch.cat(out), torch.from_numpy(scale).to(device)


def _chunked_score(
    preds_ids: np.ndarray,
    preds_mask: np.ndarray,
    target_ids: np.ndarray,
    target_mask: np.ndarray,
    model: Any,
    num_layers: Optional[int],
    all_layers: bool,
    idf: bool,
    tokens_idf: Optional[Dict[int, float]],
    batch_size: int,
    device: torch.device,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The corpus in chunks of ``batch_size`` pairs: the encoder over both
    sides (``output_hidden_states``), the special-token mask, the idf scales
    and the greedy matching, chunk by chunk (JAX's ``_chunked_fused_score``)."""
    sides = [
        [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in _host_side_inputs(ids, mask, idf, tokens_idf)]
        for ids, mask in ((preds_ids, preds_mask), (target_ids, target_mask))
    ]

    def encode(ids: Tensor, mask: Tensor, pmask: Tensor) -> Tensor:
        hidden = model(input_ids=ids.long(), attention_mask=mask.long(), output_hidden_states=True).hidden_states
        out = torch.stack(hidden, dim=1) if all_layers else hidden[num_layers if num_layers is not None else -1][:, None]
        return _normalized(out.to(torch.float32), pmask.to(torch.float32))

    prf = []
    with torch.no_grad():
        for start in range(0, preds_ids.shape[0], batch_size):
            chunk = [[a[start : start + batch_size] for a in side] for side in sides]
            emb_p = encode(*chunk[0][:3])
            emb_t = encode(*chunk[1][:3])
            prf.append(torch.stack(_pairwise_prf(emb_p, emb_t, chunk[0][3], chunk[1][3])))  # (3, bs, L)
    prf = torch.cat(prf, dim=1)
    return _flatten_layerwise(prf[0]), _flatten_layerwise(prf[1]), _flatten_layerwise(prf[2])


def _load_default_model(model_name_or_path: str):
    """The tokenizer and the model from the local Hugging Face cache (nothing is downloaded)."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric with default models requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.4` or `pip install torchmetrics[text]`."
        )
    from transformers import AutoModel, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
    model = AutoModel.from_pretrained(model_name_or_path, local_files_only=True)
    return model, tokenizer


def bert_score(
    preds: Union[str, Sequence[str], Dict[str, np.ndarray]],
    target: Union[str, Sequence[str], Dict[str, np.ndarray]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Any] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Any] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Dict[str, Union[Tensor, List[float], str]]:
    """BERTScore.

    ``preds`` and ``target`` are raw strings or pre-tokenized dicts with
    ``input_ids`` and ``attention_mask``. The tower runs on ``device`` if
    given, else where ``model``'s parameters are (the default model is moved
    to the card). Baseline rescaling reads a local ``baseline_path`` CSV
    (downloading baselines needs the network).
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if not isinstance(preds, dict) and not isinstance(target, dict) and len(preds) != len(target):
        raise ValueError("Number of predicted and reference sententes must be the same!")
    if all_layers and user_forward_fn is not None:
        raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")
    if rescale_with_baseline and baseline_path is None and baseline_url is None:
        raise ValueError(
            "Baseline rescaling requires a local `baseline_path` (downloading baselines needs network egress)."
        )

    tokenizer = user_tokenizer
    if model is None:
        model, tokenizer = _load_default_model(model_name_or_path or _DEFAULT_MODEL)
        model = model.to(device if device is not None else "cuda")
    run_on = _model_device(model, device)

    def tokenize(texts):
        if isinstance(texts, dict):
            return np.asarray(texts["input_ids"]), np.asarray(texts["attention_mask"])
        enc = tokenizer(list(texts), padding=True, truncation=True, max_length=max_length, return_tensors="np")
        return np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])

    preds_ids, preds_mask = tokenize(preds)
    target_ids, target_mask = tokenize(target)

    tokens_idf = _get_tokens_idf(target_ids, target_mask) if idf else None

    if user_forward_fn is not None:
        preds_emb, preds_scale = _embed(preds_ids, preds_mask, model, user_forward_fn, idf, tokens_idf, batch_size, run_on)
        target_emb, target_scale = _embed(target_ids, target_mask, model, user_forward_fn, idf, tokens_idf, batch_size, run_on)
        # pad both sides to a common sequence length for one batched einsum
        max_len = max(preds_emb.shape[2], target_emb.shape[2])

        def pad_to(x: Tensor, scale: Tensor) -> Tuple[Tensor, Tensor]:
            pad = max_len - x.shape[2]
            if pad:
                x = torch.nn.functional.pad(x, (0, 0, 0, pad))
                scale = torch.nn.functional.pad(scale, (0, pad))
            return x, scale

        preds_emb, preds_scale = pad_to(preds_emb, preds_scale)
        target_emb, target_scale = pad_to(target_emb, target_scale)
        precision, recall, f1 = (
            _flatten_layerwise(t) for t in _pairwise_prf(preds_emb, target_emb, preds_scale, target_scale)
        )
    else:
        precision, recall, f1 = _chunked_score(
            preds_ids, preds_mask, target_ids, target_mask,
            model, num_layers, all_layers, idf, tokens_idf, batch_size, run_on,
        )

    if rescale_with_baseline and baseline_path is not None:
        import csv

        with open(baseline_path) as fname:
            rows = [[float(v) for v in row] for i, row in enumerate(csv.reader(fname)) if i > 0]
        baseline = np.asarray(rows)[:, 1:]
        if all_layers:
            # per-layer baselines over the (L, B)-flattened scores
            n_b = precision.shape[0] // baseline.shape[0]
            scale = torch.as_tensor(np.repeat(baseline, n_b, axis=0), dtype=torch.float32, device=precision.device)
            precision = (precision - scale[:, 0]) / (1 - scale[:, 0])
            recall = (recall - scale[:, 1]) / (1 - scale[:, 1])
            f1 = (f1 - scale[:, 2]) / (1 - scale[:, 2])
        else:
            scale = torch.as_tensor(baseline[num_layers if num_layers is not None else -1], dtype=torch.float32, device=precision.device)
            precision = (precision - scale[0]) / (1 - scale[0])
            recall = (recall - scale[1]) / (1 - scale[1])
            f1 = (f1 - scale[2]) / (1 - scale[2])

    output: Dict[str, Union[Tensor, List[float], str]] = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        output["hash"] = f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"
    return output
