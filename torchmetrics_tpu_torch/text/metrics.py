# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Text module metrics over the functional metrics (counterpart of
``torchmetrics_tpu/text/metrics.py``).

Every class keeps the JAX package's states and dtypes: host string work
feeds float32 (and EditDistance's int32) sums, the per-sample scores of
ROUGE, EED and the sentence-level options are ``"cat"`` lists of float32.
Perplexity alone has a device path: one K8 launch an update.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from torchmetrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update
from torchmetrics_tpu_torch.functional.text.edit import _edit_distance_compute, _edit_distance_update
from torchmetrics_tpu_torch.functional.text.eed import _eed_update
from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from torchmetrics_tpu_torch.functional.text.squad import (
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from torchmetrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from torchmetrics_tpu_torch.functional.text.wer import (
    _cer_update,
    _mer_update,
    _wer_update,
    _wil_wip_update,
    _wer_compute,
    _mer_compute,
    _cer_compute,
    _word_info_lost_compute,
    _wip_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import _mean_last_in_xla_order
from torchmetrics_tpu_torch.utilities.data import _jnp_add, dim_zero_cat
from torchmetrics_tpu_torch.utilities.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor


def _f32(value: Any, device: torch.device) -> Tensor:
    return torch.as_tensor(np.asarray(value), dtype=torch.float32).to(device)


def _host(state: Tensor) -> np.ndarray:
    return state.detach().to("cpu", torch.float32).numpy()


class BLEUScore(Metric):
    """BLEU."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self.tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn

        self.add_state("preds_len", 0.0, dist_reduce_fx="sum")
        self.add_state("target_len", 0.0, dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        """Fold clipped n-gram counts."""
        if isinstance(preds, str):
            preds = [preds]
        target = [[t] if isinstance(t, str) else t for t in target]
        self.numerator, self.denominator, self.preds_len, self.target_len = _bleu_score_update(
            preds, target, self.numerator, self.denominator, self.preds_len, self.target_len,
            self.n_gram, self.tokenizer,
        )

    def compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class SacreBLEUScore(BLEUScore):
    """SacreBLEU."""

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)


class CHRFScore(Metric):
    """chrF/chrF++."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_preds_chars", torch.zeros(n_char_order), dist_reduce_fx="sum")
        self.add_state("total_preds_words", torch.zeros(n_word_order), dist_reduce_fx="sum")
        self.add_state("total_target_chars", torch.zeros(n_char_order), dist_reduce_fx="sum")
        self.add_state("total_target_words", torch.zeros(n_word_order), dist_reduce_fx="sum")
        self.add_state("total_matching_chars", torch.zeros(n_char_order), dist_reduce_fx="sum")
        self.add_state("total_matching_words", torch.zeros(n_word_order), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        """Fold per-order n-gram totals."""
        tp_c, tp_w, tt_c, tt_w, tm_c, tm_w, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace
        )
        dev = self.device
        self.total_preds_chars = _jnp_add(self.total_preds_chars, _f32(tp_c, dev))
        self.total_preds_words = _jnp_add(self.total_preds_words, _f32(tp_w, dev))
        self.total_target_chars = _jnp_add(self.total_target_chars, _f32(tt_c, dev))
        self.total_target_words = _jnp_add(self.total_target_words, _f32(tt_w, dev))
        self.total_matching_chars = _jnp_add(self.total_matching_chars, _f32(tm_c, dev))
        self.total_matching_words = _jnp_add(self.total_matching_words, _f32(tm_w, dev))
        if self.return_sentence_level_score:
            self.sentence_chrf_score.append(_f32(sentence_scores, dev))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_score_compute(
            _host(self.total_preds_chars),
            _host(self.total_preds_words),
            _host(self.total_target_chars),
            _host(self.total_target_words),
            _host(self.total_matching_chars),
            _host(self.total_matching_words),
            self.beta,
        ).to(self.device)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class ROUGEScore(Metric):
    """ROUGE."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer and not _NLTK_AVAILABLE:
            raise ModuleNotFoundError("Stemmer requires that `nltk` is installed.")
        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.use_stemmer = use_stemmer
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        if use_stemmer:
            from nltk.stem.porter import PorterStemmer

            self.stemmer = PorterStemmer()
        else:
            self.stemmer = None

        for rouge_key in self.rouge_keys:
            for score_name in ("fmeasure", "precision", "recall"):
                self.add_state(f"{rouge_key}_{score_name}", [], dist_reduce_fx="cat")

    def update(
        self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]
    ) -> None:
        """Fold per-sample ROUGE scores."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        elif target and all(isinstance(t, str) for t in target):
            target = [[t] for t in target]
        results = _rouge_score_update(
            preds, target, self.rouge_keys_values,
            accumulate=self.accumulate, stemmer=self.stemmer,
            normalizer=self.normalizer, tokenizer=self.tokenizer,
        )
        for rouge_key, metrics in results.items():
            key_name = {v: k for k, v in ALLOWED_ROUGE_KEYS.items()}[rouge_key]
            for metric in metrics:
                for score_name, score in metric.items():
                    getattr(self, f"{key_name}_{score_name}").append(score.to(self.device, torch.float32))

    def compute(self) -> Dict[str, Tensor]:
        """Mean over the stream."""
        update_output = {}
        for rouge_key in self.rouge_keys:
            for score_name in ("fmeasure", "precision", "recall"):
                values = getattr(self, f"{rouge_key}_{score_name}")
                update_output[f"{rouge_key}_{score_name}"] = (
                    _mean_last_in_xla_order(dim_zero_cat(values)) if len(values) else torch.tensor(0.0, device=self.device)
                )
        return update_output

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class TranslationEditRate(Metric):
    """TER."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
        if not isinstance(no_punctuation, bool):
            raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
        if not isinstance(lowercase, bool):
            raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
        if not isinstance(asian_support, bool):
            raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", 0.0, dist_reduce_fx="sum")
        self.add_state("total_tgt_length", 0.0, dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_length, sentence_scores = _ter_update(preds, target, self.tokenizer)
        self.total_num_edits = self.total_num_edits + num_edits
        self.total_tgt_length = self.total_tgt_length + tgt_length
        if self.return_sentence_level_score:
            self.sentence_ter.append(_f32(sentence_scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        ter = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class ExtendedEditDistance(Metric):
    """EED."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for param_name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        self.sentence_eed.append(_f32(scores, self.device))

    def compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        all_scores = dim_zero_cat(self.sentence_eed) if len(self.sentence_eed) else torch.zeros(0, device=self.device)
        average = _mean_last_in_xla_order(all_scores) if all_scores.numel() else torch.tensor(0.0, device=self.device)
        if self.return_sentence_level_score:
            return average, all_scores
        return average

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class EditDistance(Metric):
    """Character edit distance."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        self.substitution_cost = substitution_cost
        allowed_reduction = (None, "mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction}, but got {reduction}")
        self.reduction = reduction

        if self.reduction == "none" or self.reduction is None:
            self.add_state("edit_scores_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", 0, dist_reduce_fx="sum")
            self.add_state("num_elements", 0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        distance = _edit_distance_update(preds, target, self.substitution_cost).to(self.device)
        if self.reduction == "none" or self.reduction is None:
            self.edit_scores_list.append(distance)
        else:
            self.edit_scores = _jnp_add(self.edit_scores, distance.sum(dtype=torch.int32))
            self.num_elements = self.num_elements + distance.shape[0]

    def compute(self) -> Tensor:
        if self.reduction == "none" or self.reduction is None:
            if len(self.edit_scores_list):
                return dim_zero_cat(self.edit_scores_list)
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return _edit_distance_compute(torch.atleast_1d(self.edit_scores), self.num_elements, self.reduction)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class _ErrorRateMetric(Metric):
    """Shared shell for WER/CER/MER: errors + total with ``sum`` reduce."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _update_fn = None
    _compute_fn = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = type(self)._update_fn(preds, target)
        # JAX's updates are weakly typed Python floats: they take a narrowed state's type, as these do
        self.errors = self.errors + float(errors)
        self.total = self.total + float(total)

    def compute(self) -> Tensor:
        return type(self)._compute_fn(self.errors, self.total)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class WordErrorRate(_ErrorRateMetric):
    """WER."""

    _update_fn = staticmethod(_wer_update)
    _compute_fn = staticmethod(_wer_compute)


class CharErrorRate(_ErrorRateMetric):
    """CER."""

    _update_fn = staticmethod(_cer_update)
    _compute_fn = staticmethod(_cer_compute)


class MatchErrorRate(_ErrorRateMetric):
    """MER."""

    _update_fn = staticmethod(_mer_update)
    _compute_fn = staticmethod(_mer_compute)


class WordInfoLost(Metric):
    """WIL."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("target_total", 0.0, dist_reduce_fx="sum")
        self.add_state("preds_total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wil_wip_update(preds, target)
        self.errors = self.errors + float(errors)
        self.target_total = self.target_total + float(target_total)
        self.preds_total = self.preds_total + float(preds_total)

    def compute(self) -> Tensor:
        return _word_info_lost_compute(self.errors, self.target_total, self.preds_total)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class WordInfoPreserved(WordInfoLost):
    """WIP."""

    higher_is_better = True

    def compute(self) -> Tensor:
        return _wip_compute(self.errors, self.target_total, self.preds_total)


class Perplexity(Metric):
    """Perplexity over ``[B, T, V]`` logits and ``[B, T]`` targets, each
    update one K8 launch on the card.

    ``total_log_probs`` is float32: JAX makes it float64 only under
    ``jax_enable_x64``, a flag the port does not have. ``count`` is float32,
    the int32 token count of each update added to it, as in JAX."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", 0.0, dist_reduce_fx="sum")
        self.add_state("count", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = self._inputs(preds, target)
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = _jnp_add(self.total_log_probs, total_log_probs)
        self.count = _jnp_add(self.count, count)

    def compute(self) -> Tensor:
        return _perplexity_compute(self.total_log_probs, self.count)

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)


class SQuAD(Metric):
    """SQuAD EM/F1."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", 0.0, dist_reduce_fx="sum")
        self.add_state("exact_match", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds, target) -> None:
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict)
        # weakly typed Python floats, as in JAX: ``total`` is int32 until the first update, then float32
        self.f1_score = self.f1_score + float(f1)
        self.exact_match = self.exact_match + float(exact_match)
        self.total = self.total + float(total)

    def compute(self) -> Dict[str, Tensor]:
        # JAX's ``total`` is weakly typed after an update: it divides in the scores' type (a narrowed state's)
        return _squad_compute(self.f1_score, self.exact_match, self.total.to(self.exact_match.dtype))

    def plot(self, val=None, ax=None):
        return self._plot(val, ax)
