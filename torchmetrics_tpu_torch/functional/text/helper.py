# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Text helpers: the batched edit distance and n-gram counting (counterpart
of ``torchmetrics_tpu/functional/text/helper.py``).

String processing is host work; these helpers stay in Python and numpy and
feed counts into the metric states. The edit distance runs in the port's
own copy of the JAX package's C++ extension (``native/edit_distance.cpp``),
built with ``g++`` at first use; there is no other route.
"""
from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple, Union

import numpy as np


def _batch_edit_distance(
    pred_seqs: Sequence[Sequence], target_seqs: Sequence[Sequence], substitution_cost: int = 1
) -> np.ndarray:
    """Levenshtein distance of every (pred, target) pair at once, int64.

    Tokens are interned to consecutive integer ids (exact equality, no hash
    collisions), then the whole batch runs through the native DP (OpenMP
    over the pairs). A failed build raises with the compiler's output.
    """
    from torchmetrics_tpu_torch.native import get_edit_library

    if len(pred_seqs) != len(target_seqs):
        raise ValueError(
            f"Expected `pred_seqs` and `target_seqs` to have same length, got {len(pred_seqs)} and {len(target_seqs)}"
        )
    lib = get_edit_library()
    vocab: dict = {}

    def intern(seq):
        return [vocab.setdefault(tok, len(vocab)) for tok in seq]

    pred_ids = [intern(s) for s in pred_seqs]
    tgt_ids = [intern(s) for s in target_seqs]
    pred_flat = np.array([i for s in pred_ids for i in s], dtype=np.uint64)
    tgt_flat = np.array([i for s in tgt_ids for i in s], dtype=np.uint64)
    pred_off = np.concatenate(([0], np.cumsum([len(s) for s in pred_ids]))).astype(np.int64)
    tgt_off = np.concatenate(([0], np.cumsum([len(s) for s in tgt_ids]))).astype(np.int64)
    out = np.empty(len(pred_ids), dtype=np.int64)
    lib.batch_edit_distance(
        pred_flat.ctypes.data, pred_off.ctypes.data,
        tgt_flat.ctypes.data, tgt_off.ctypes.data,
        len(pred_ids), substitution_cost, out.ctypes.data,
    )
    return out


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """All n-grams up to ``n_gram``."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _normalize_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]
) -> Tuple[List[str], List[str]]:
    """Promote single strings to lists and validate pairing.

    The JAX package's documented divergence from the reference, kept here:
    the reference's WER/CER/MER/WIL/WIP silently ``zip``-truncate
    mismatched preds/target lists to the shorter one; here a length
    mismatch raises, since truncation silently discards data.
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    return list(preds), list(target)
