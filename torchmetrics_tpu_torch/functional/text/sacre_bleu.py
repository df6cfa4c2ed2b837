# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""SacreBLEU (counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``).

Implements the sacrebleu tokenizers ``none``/``13a``/``zh``/``intl``/``char``;
the mecab/flores tokenizers require optional native deps and raise a clear
error when unavailable (MeCab is installed on neither machine the port runs on).
"""
from __future__ import annotations

import re
from typing import ClassVar, Optional, Sequence

import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update
from torchmetrics_tpu_torch.utilities.imports import _REGEX_AVAILABLE

Tensor = torch.Tensor

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char", "ja-mecab", "ko-mecab")

# CJK codepoint ranges used by the sacrebleu `zh` tokenizer
_UCODE_RANGES = (
    (0x3400, 0x4DB5), (0x4E00, 0x9FA5), (0x9FA6, 0x9FBB), (0xF900, 0xFA2D),
    (0xFA30, 0xFA6A), (0xFA70, 0xFAD9), (0x20000, 0x2A6D6), (0x2F800, 0x2FA1D),
    (0xFF00, 0xFFEF), (0x2E80, 0x2EFF), (0x3000, 0x303F), (0x31C0, 0x31EF),
    (0x2F00, 0x2FDF), (0x2FF0, 0x2FFF), (0x3100, 0x312F), (0x31A0, 0x31BF),
    (0xFE10, 0xFE1F), (0xFE30, 0xFE4F), (0x2600, 0x26FF), (0x2700, 0x27BF),
    (0x3200, 0x32FF), (0x3300, 0x33FF),
)


class _SacreBLEUTokenizer:
    """Sacrebleu-compatible tokenizers."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    if _REGEX_AVAILABLE:
        import regex

        _INT_REGEX = (
            (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
            (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
            (regex.compile(r"(\p{S})"), r" \1 "),
        )

    _TOKENIZE_FN: ClassVar[dict] = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
        "ja-mecab": "_tokenize_ja_mecab",
        "ko-mecab": "_tokenize_ko_mecab",
    }

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        cls._check_tokenizers_validity(tokenize)
        tokenize_fn = getattr(cls, cls._TOKENIZE_FN[tokenize])
        return cls._lower(tokenize_fn(line), lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        cp = ord(uchar)
        return any(start <= cp <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += f" {char} "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        if not _REGEX_AVAILABLE:
            raise ModuleNotFoundError("`intl` tokenizer requires the `regex` package: pip install regex")
        for _re, repl in cls._INT_REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @classmethod
    def _tokenize_ja_mecab(cls, line: str) -> str:
        try:
            import ipadic
            import MeCab
        except ImportError as err:
            raise ModuleNotFoundError("`ja-mecab` tokenizer requires mecab-python3 and ipadic.") from err
        tagger = MeCab.Tagger(ipadic.MECAB_ARGS + " -Owakati")
        return tagger.parse(line.strip()).strip()

    @classmethod
    def _tokenize_ko_mecab(cls, line: str) -> str:
        try:
            import mecab_ko
            import mecab_ko_dic
        except ImportError as err:
            raise ModuleNotFoundError("`ko-mecab` tokenizer requires mecab_ko and mecab_ko_dic.") from err
        tagger = mecab_ko.Tagger(mecab_ko_dic.MECAB_ARGS + " -Owakati")
        return tagger.parse(line.strip()).strip()

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize not in cls._TOKENIZE_FN:
            raise ValueError(f"Argument `tokenize` expected to be one of {list(cls._TOKENIZE_FN)} but got {tokenize}.")


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> Tensor:
    """SacreBLEU score."""
    if tokenize not in AVAILABLE_TOKENIZERS:
        raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator = torch.zeros(n_gram)
    denominator = torch.zeros(n_gram)
    preds_len = torch.tensor(0.0)
    target_len = torch.tensor(0.0)
    tokenize_fn = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds, target, numerator, denominator, preds_len, target_len, n_gram, tokenize_fn
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
