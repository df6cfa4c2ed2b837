# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Text of the port (the 14 host-string functions, the 13 host-input
classes, the SacreBLEU tokenizers, the refusals) against the JAX package's,
on seeded corpora made with numpy, on the CPU.

Budgets: the counts, the chrF, TER and EED statistics and every state are
the same host integers and float64 rounded to float32 at the same point:
bitwise, with JAX's dtypes. Values are bitwise too where both packages
divide the same float32 numbers (the error rates, TER, SQuAD, chrF's numpy)
or mean up to 64 float32 scores in XLA's order (ROUGE, EED); BLEU's
``exp(sum(w * log p))`` runs through each library's float32 ``log`` and
``exp``: ``rtol=1e-6``. Perplexity is in ``tests/test_torch_token_nll.py``,
BERTScore and InfoLM in ``tests/test_torch_text_models.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.text as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.text as TF
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy

BLEU_RTOL = 1e-6
_WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "Hello", "world", "is", "it's", "we",
          "they", "3.5", "1,000", "U.S.", "e.g.", "don't", "fox", "over", "lazy", "quick", "brown", "jumped",
          "Mr.", "(note)", "&amp;", "naïve", "café", "東京", "数据", "quote\"d", "x-ray", "well-known"]
_PUNCT = ["", "", "", ",", ".", "!", "?", ";", ":"]


def _sentence(rng, n_words):
    words = [str(rng.choice(_WORDS)) + str(rng.choice(_PUNCT)) for _ in range(n_words)]
    return " ".join(words)


def _corpus(seed, n=24, refs=2):
    """Seeded predictions and their references: edited copies (substitutions,
    drops, swaps), some multi-sentence, an empty prediction and an exact match."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n):
        ref = [_sentence(rng, int(rng.integers(3, 14))) for _ in range(refs)]
        words = ref[0].split()
        pred = [w if rng.random() > 0.2 else str(rng.choice(_WORDS)) for w in words if rng.random() > 0.1]
        if len(pred) > 3 and rng.random() < 0.3:
            k = int(rng.integers(0, len(pred) - 2))
            pred[k], pred[k + 2] = pred[k + 2], pred[k]
        text = " ".join(pred)
        if i % 5 == 1:
            text = text + ". " + _sentence(rng, 4).capitalize() + "."
        preds.append(text)
        targets.append(ref)
    preds[3] = ""
    preds[5] = targets[5][0]
    return preds, targets


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what="", rtol=BLEU_RTOL, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


# ------------------------------------------------------------------ functions

ERROR_RATES = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost", "word_information_preserved"]


@pytest.mark.parametrize("name", ERROR_RATES)
def test_error_rates_bitwise_to_jax(name):
    preds, targets = _corpus(1)
    target = [t[0] for t in targets]
    _bitwise(getattr(TF, name)(preds, target), getattr(JF, name)(preds, target), name)
    _bitwise(getattr(TF, name)(preds[0], target[0]), getattr(JF, name)(preds[0], target[0]), f"{name} one string")


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("cost", [1, 2])
def test_edit_distance_bitwise_to_jax(reduction, cost):
    preds, targets = _corpus(2)
    target = [t[0] for t in targets]
    kw = dict(substitution_cost=cost, reduction=reduction)
    _bitwise(TF.edit_distance(preds, target, **kw), JF.edit_distance(preds, target, **kw), f"{reduction} {cost}")


@pytest.mark.parametrize("n_gram,smooth,weights", [(4, False, None), (4, True, None), (2, False, [0.3, 0.7]), (1, True, None), (3, False, None)])
def test_bleu_matches_jax(n_gram, smooth, weights):
    preds, targets = _corpus(3)
    kw = dict(n_gram=n_gram, smooth=smooth, weights=weights)
    _close(TF.bleu_score(preds, targets, **kw), JF.bleu_score(preds, targets, **kw), "bleu")
    _close(TF.bleu_score(preds[0], [targets[0]], **kw), JF.bleu_score(preds[0], [targets[0]], **kw), "bleu one")


@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
@pytest.mark.parametrize("lowercase", [False, True])
def test_sacre_bleu_tokenizers_match_jax(tokenize, lowercase):
    from torchmetrics_tpu.functional.text.sacre_bleu import _SacreBLEUTokenizer as JTok
    from torchmetrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer as TTok

    preds, targets = _corpus(4)
    for line in preds + [t for ts in targets for t in ts]:
        assert TTok.tokenize(line, tokenize, lowercase) == JTok.tokenize(line, tokenize, lowercase), line
    kw = dict(tokenize=tokenize, lowercase=lowercase, smooth=tokenize == "char")
    _close(TF.sacre_bleu_score(preds, targets, **kw), JF.sacre_bleu_score(preds, targets, **kw), tokenize)


@pytest.mark.parametrize("tokenize", ["ja-mecab", "ko-mecab"])
def test_sacre_bleu_mecab_tokenizers_raise_in_both(tokenize):
    preds, targets = _corpus(4, n=8)
    assert _raised(TF.sacre_bleu_score, preds, targets, tokenize=tokenize) == _raised(
        JF.sacre_bleu_score, preds, targets, tokenize=tokenize)
    tm, jm = T.SacreBLEUScore(tokenize=tokenize, device="cpu"), J.SacreBLEUScore(tokenize=tokenize)
    assert _raised(tm.update, preds, targets) == _raised(jm.update, preds, targets)
    assert _raised(TF.sacre_bleu_score, preds, targets, tokenize="spm") == _raised(
        JF.sacre_bleu_score, preds, targets, tokenize="spm")


@pytest.mark.parametrize("kw", [{}, {"n_word_order": 0}, {"lowercase": True, "whitespace": True}, {"beta": 1.0, "n_char_order": 4}])
def test_chrf_bitwise_to_jax(kw):
    preds, targets = _corpus(5)
    got = TF.chrf_score(preds, targets, return_sentence_level_score=True, **kw)
    want = JF.chrf_score(preds, targets, return_sentence_level_score=True, **kw)
    _bitwise(got[0], want[0], "corpus")
    _bitwise(got[1], want[1], "sentences")


@pytest.mark.parametrize("kw", [{}, {"normalize": True}, {"no_punctuation": True, "lowercase": False},
                                {"asian_support": True, "normalize": True, "no_punctuation": True}])
def test_ter_bitwise_to_jax(kw):
    preds, targets = _corpus(6)
    got = TF.translation_edit_rate(preds, targets, return_sentence_level_score=True, **kw)
    want = JF.translation_edit_rate(preds, targets, return_sentence_level_score=True, **kw)
    _bitwise(got[0], want[0], "corpus")
    _bitwise(got[1], want[1], "sentences")


@pytest.mark.parametrize("language", ["en", "ja"])
@pytest.mark.parametrize("kw", [{}, {"alpha": 1.5, "rho": 0.5, "deletion": 0.1, "insertion": 0.8}])
def test_eed_bitwise_to_jax(language, kw):
    preds, targets = _corpus(7)
    got = TF.extended_edit_distance(preds, targets, language=language, return_sentence_level_score=True, **kw)
    want = JF.extended_edit_distance(preds, targets, language=language, return_sentence_level_score=True, **kw)
    _bitwise(got[0], want[0], "corpus")
    _bitwise(got[1], want[1], "sentences")


@pytest.mark.parametrize("accumulate", ["best", "avg"])
@pytest.mark.parametrize("use_stemmer", [False, True])
def test_rouge_bitwise_to_jax(accumulate, use_stemmer):
    preds, targets = _corpus(8)
    keys = ("rouge1", "rouge2", "rouge3", "rougeL", "rougeLsum")
    got = TF.rouge_score(preds, targets, accumulate=accumulate, use_stemmer=use_stemmer, rouge_keys=keys)
    want = JF.rouge_score(preds, targets, accumulate=accumulate, use_stemmer=use_stemmer, rouge_keys=keys)
    assert sorted(got) == sorted(want)
    for key in want:
        _bitwise(got[key], want[key], key)


def test_rouge_lsum_splits_sentences_as_jax():
    from torchmetrics_tpu.functional.text.rouge import _split_sentence as jsplit
    from torchmetrics_tpu_torch.functional.text.rouge import _split_sentence as tsplit

    text = "The cat sat. The dog ran!  Is it raining? yes it is.No split here"
    assert tsplit(text) == jsplit(text)
    preds, targets = ["One sentence. Two sentences here!"], [["One sentence here. Two sentences!"]]
    got = TF.rouge_score(preds, targets, rouge_keys="rougeLsum")
    want = JF.rouge_score(preds, targets, rouge_keys="rougeLsum")
    for key in want:
        _bitwise(got[key], want[key], key)


def _squad_batch(seed, n=40):
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n):
        answers = [_sentence(rng, int(rng.integers(1, 5))) for _ in range(int(rng.integers(1, 4)))]
        pick = answers[0].split()
        pred = " ".join(pick[: max(1, len(pick) - int(rng.integers(0, 2)))]) if rng.random() < 0.7 else _sentence(rng, 3)
        preds.append({"prediction_text": pred, "id": str(i)})
        targets.append({"answers": {"answer_start": [0] * len(answers), "text": answers}, "id": str(i)})
    return preds, targets


def test_squad_bitwise_to_jax():
    preds, targets = _squad_batch(9)
    got, want = TF.squad(preds, targets), JF.squad(preds, targets)
    for key in want:
        _bitwise(got[key], want[key], key)
    _bitwise(TF.squad(preds[0], targets[0])["f1"], JF.squad(preds[0], targets[0])["f1"], "one dict")


# -------------------------------------------------------------------- classes

def _text_batches(kind, seed):
    if kind == "squad":
        p, t = _squad_batch(seed, 20)
        return [(p[:12], t[:12]), (p[12:], t[12:])]
    preds, targets = _corpus(seed, n=20)
    if kind == "single":
        targets = [t[0] for t in targets]
    return [(preds[:11], targets[:11]), (preds[11:], targets[11:])]


# (class, kwargs, batch kind, value budget: None is bitwise)
CLASS_CASES = [
    ("WordErrorRate", {}, "single", None), ("CharErrorRate", {}, "single", None), ("MatchErrorRate", {}, "single", None),
    ("WordInfoLost", {}, "single", None), ("WordInfoPreserved", {}, "single", None),
    ("EditDistance", {}, "single", None), ("EditDistance", {"reduction": "sum", "substitution_cost": 2}, "single", None),
    ("EditDistance", {"reduction": "none"}, "single", None),
    ("BLEUScore", {}, "multi", BLEU_RTOL), ("BLEUScore", {"n_gram": 2, "smooth": True}, "multi", BLEU_RTOL),
    ("SacreBLEUScore", {"tokenize": "intl", "lowercase": True}, "multi", BLEU_RTOL),
    ("CHRFScore", {}, "multi", None), ("CHRFScore", {"n_word_order": 0, "return_sentence_level_score": True}, "multi", None),
    ("ROUGEScore", {}, "multi", None), ("ROUGEScore", {"accumulate": "avg", "use_stemmer": True, "rouge_keys": ("rouge1", "rougeLsum")}, "multi", None),
    ("TranslationEditRate", {}, "multi", None), ("TranslationEditRate", {"normalize": True, "return_sentence_level_score": True}, "multi", None),
    ("ExtendedEditDistance", {}, "multi", None), ("ExtendedEditDistance", {"return_sentence_level_score": True, "language": "ja"}, "multi", None),
    ("SQuAD", {}, "squad", None),
]


def _leaves(tree):
    out = {}
    for key, value in tree.items():
        if key == "_update_count":
            continue
        for i, leaf in enumerate(value if isinstance(value, list) else [value]):
            out[f"{key}.{i}"] = leaf
    return out


def _values(value):
    if isinstance(value, dict):
        return {k: v for k, v in value.items()}
    if isinstance(value, tuple):
        return {str(i): v for i, v in enumerate(value)}
    return {"value": value}


@pytest.mark.parametrize("name,kw,kind,rtol", CLASS_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASS_CASES)])
def test_classes_states_values_streaming_and_checkpoints(name, kw, kind, rtol):
    """Two updates into both packages: every state bitwise with JAX's dtype;
    the value against JAX's and against the one-call functional (the
    stream's concatenation); each state tree read into the other package."""
    tm, jm = getattr(T, name)(device="cpu", **kw), getattr(J, name)(**kw)
    batches = _text_batches(kind, seed=sum(map(ord, name)))
    for p, t in batches:
        tm.update(p, t)
        jm.update(p, t)
    got, want = _leaves(state_to_numpy(tm)), _leaves(jm.state_tree())
    assert sorted(got) == sorted(want), name
    for key in want:
        _bitwise(got[key], want[key], f"{name} {key}")
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    tval, jval = _values(tm.compute()), _values(jm.compute())
    assert sorted(tval) == sorted(jval)
    for key in jval:
        (_bitwise if rtol is None else _close)(tval[key], jval[key], f"{name} value {key}")
    one = getattr(T, name)(device="cpu", **kw)
    one.update([p for b in batches for p in b[0]], [t for b in batches for t in b[1]])
    for key, value in _values(one.compute()).items():
        if name not in ("BLEUScore", "SacreBLEUScore", "EditDistance"):  # float32 sums of the same counts per update
            (_bitwise if rtol is None else _close)(value, tval[key], f"{name} one call {key}")
    fresh = getattr(T, name)(device="cpu", **kw)
    if name == "SQuAD":
        # ``total`` is declared int32 and holds float32 after an update (int32 + float32 in JAX): neither package
        # restores such a tree, strict or not, and both refuse it alike
        jtree = dict(jm.state_tree(include_count=True))
        for strict in (True, False):
            assert _raised(state_from_numpy, fresh, jtree, strict=strict)[1] == _raised(
                getattr(J, name)(**kw).load_state_tree, jtree, strict=strict)[1]
        return
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    for key, value in _values(fresh.compute()).items():
        (_bitwise if rtol is None else _close)(value, jval[key], f"{name} JAX tree into the port {key}")
    jfresh = getattr(J, name)(**kw)
    tree = state_to_numpy(tm, include_count=True)
    jfresh.load_state_tree({k: v if k == "_update_count" else (
        [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)) for k, v in tree.items()})
    for key, value in _values(jfresh.compute()).items():
        (_bitwise if rtol is None else _close)(tval[key], value, f"{name} port tree into JAX {key}")


def test_class_attributes_equal_jax():
    import torchmetrics_tpu.text as JT
    import torchmetrics_tpu_torch.text as TT

    assert TT.__all__ == JT.__all__
    for name in TT.__all__:
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
            assert getattr(getattr(TT, name), attr, "missing") == getattr(getattr(JT, name), attr, "missing"), (name, attr)


# ------------------------------------------------------------------- refusals

REFUSALS = [
    ("BLEUScore", {"n_gram": 3, "weights": [0.5, 0.5]}), ("SacreBLEUScore", {"tokenize": "bogus"}),
    ("CHRFScore", {"n_char_order": 0}), ("CHRFScore", {"n_word_order": -1}), ("CHRFScore", {"beta": -1.0}),
    ("ROUGEScore", {"accumulate": "max"}), ("ROUGEScore", {"rouge_keys": ("rouge10",)}),
    ("TranslationEditRate", {"normalize": 1}), ("TranslationEditRate", {"asian_support": "yes"}),
    ("ExtendedEditDistance", {"language": "de"}), ("ExtendedEditDistance", {"alpha": 2}),
    ("ExtendedEditDistance", {"rho": -0.3}), ("EditDistance", {"substitution_cost": -1}),
    ("EditDistance", {"reduction": "max"}), ("Perplexity", {"ignore_index": 1.5}),
]


@pytest.mark.parametrize("name,kw", REFUSALS, ids=[f"{c[0]}-{i}" for i, c in enumerate(REFUSALS)])
def test_constructor_refusals_match_jax(name, kw):
    assert _raised(getattr(T, name), device="cpu", **kw) == _raised(getattr(J, name), **kw)


FUNCTION_REFUSALS = [
    ("word_error_rate", (["a b", "c"], ["a b"]), {}), ("char_error_rate", (["a"], ["a", "b"]), {}),
    ("edit_distance", (["a", 3], ["a", "b"]), {}), ("edit_distance", (["a"], ["a", "b"]), {}),
    ("edit_distance", (["a"], ["b"]), {"reduction": "max"}),
    ("bleu_score", (["a b"], [["a"], ["b"]]), {}), ("bleu_score", (["a b"], [["a"]]), {"n_gram": 2, "weights": [1.0]}),
    ("sacre_bleu_score", (["a b"], [["a"], ["b"]]), {}), ("chrf_score", (["a"], [["a"]]), {"n_char_order": 0}),
    ("chrf_score", (["a", "b"], [["a"]]), {}), ("translation_edit_rate", (["a"], [["a"]]), {"lowercase": 1}),
    ("translation_edit_rate", (["a", "b"], [["a"]]), {}), ("extended_edit_distance", (["a"], [["a"]]), {"language": "fr"}),
    ("extended_edit_distance", (["a", "b"], [["a"]]), {}), ("extended_edit_distance", (["a"], [["a"]]), {"insertion": 1}),
    ("rouge_score", (["a"], ["a"]), {"rouge_keys": "rougeX"}), ("rouge_score", (["a"], ["a"]), {"accumulate": "sum"}),
    ("squad", ([{"prediction_text": "a"}], [{"answers": {"text": ["a"]}, "id": "1"}]), {}),
    ("squad", ([{"prediction_text": "a", "id": "1"}], [{"answers": {"text": ["a"]}}]), {}),
    ("squad", ([{"prediction_text": "a", "id": "1"}], [{"answers": {"start": [0]}, "id": "1"}]), {}),
]


@pytest.mark.parametrize("name,args,kw", FUNCTION_REFUSALS, ids=[f"{c[0]}-{i}" for i, c in enumerate(FUNCTION_REFUSALS)])
def test_function_refusals_match_jax(name, args, kw):
    assert _raised(getattr(TF, name), *args, **kw) == _raised(getattr(JF, name), *args, **kw)


def test_squad_unanswered_question_warns_and_scores_zero_as_jax():
    preds = [{"prediction_text": "a b", "id": "1"}]
    targets = [{"answers": {"text": ["a b"]}, "id": "1"}, {"answers": {"text": ["c"]}, "id": "2"}]
    with pytest.warns(UserWarning, match="Unanswered question 2"):
        got = TF.squad(preds, targets)
    with pytest.warns(UserWarning, match="Unanswered question 2"):
        want = JF.squad(preds, targets)
    for key in want:
        _bitwise(got[key], want[key], key)
