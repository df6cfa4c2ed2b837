# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""BERTScore and InfoLM of the port against the JAX package's, on tiny
BERT configurations built from a config (no download): the JAX package runs
transformers' Flax classes, the port transformers' PyTorch classes with the
same weights, carried across by the port's converter
(``text/weights.py::bert_params_from_jax``, itself held against
transformers' own Flax-to-PyTorch loader here). A seeded word-hash
tokenizer stands in for a vocabulary file.

Budgets: scores within ``2e-5`` (BERTScore's precision, recall and F1, of 1)
and InfoLM within ``1e-4`` of ``max(1, |score|)`` (the Fisher-Rao distance
``2 arccos(s)`` through its ``s``: the arccos's slope is unbounded where
``s`` rounds near 1): the same float32 towers
in Flax (XLA) and PyTorch (oneDNN) add in other orders, and InfoLM's softmax
at temperature 0.25 over the vocabulary magnifies that. The module states
(int32 token ids and masks) are bitwise and cross the two packages'
checkpoints both ways. The default-model paths raise in both packages
(the tokenizer read from an empty cache with ``local_files_only``).
"""
from __future__ import annotations

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from transformers import BertConfig, BertForMaskedLM, BertModel, FlaxBertForMaskedLM, FlaxBertModel  # noqa: E402

import torchmetrics_tpu.functional.text as JF  # noqa: E402
import torchmetrics_tpu.text as JT  # noqa: E402
import torchmetrics_tpu_torch.functional.text as TF  # noqa: E402
import torchmetrics_tpu_torch.text as TT  # noqa: E402
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from torchmetrics_tpu_torch.text.weights import bert_params_from_jax, load_bert_params  # noqa: E402

BERT_ATOL = 2e-5
INFOLM_RTOL = 1e-4
MEASURES = [("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
            ("ab_divergence", 0.5, 0.3), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
            ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None)]


class _WordHashTokenizer:
    """Lowercased words to ``4 + crc32(word) % (vocab - 4)``; [PAD] 0, [CLS] 1, [SEP] 2, [MASK] 3."""

    pad_token_id, cls_token_id, sep_token_id, mask_token_id = 0, 1, 2, 3

    def __init__(self, vocab_size=64, max_len=24):
        self.vocab_size, self.max_len = vocab_size, max_len

    def __call__(self, text=None, padding=True, truncation=True, max_length=None, return_tensors="np", **kw):
        max_length = min(max_length or self.max_len, self.max_len)
        rows = []
        for sentence in text:
            ids = [4 + zlib.crc32(w.encode()) % (self.vocab_size - 4) for w in sentence.lower().split()]
            rows.append([1] + ids[: max_length - 2] + [2])
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        input_ids = np.zeros((len(rows), width), np.int32)
        attention_mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def _config():
    return BertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                      vocab_size=64, max_position_embeddings=32)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def encoders():
    flax = FlaxBertModel(_config(), seed=0)
    port = load_bert_params(BertModel(_config()).eval(), _numpy_tree(flax.params))
    return flax, port


@pytest.fixture(scope="module")
def mlms():
    flax = FlaxBertForMaskedLM(_config(), seed=1)
    port = load_bert_params(BertForMaskedLM(_config()).eval(), _numpy_tree(flax.params))
    return flax, port


def _pairs(seed, n=10):
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "in", "park", "hello", "world", "is", "blue", "sky"]
    refs = [" ".join(rng.choice(words, int(rng.integers(3, 12)))) for _ in range(n)]
    preds = [" ".join(w if rng.random() > 0.3 else str(rng.choice(words)) for w in r.split()) for r in refs]
    return preds, refs


def _np(x):
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_converter_matches_transformers_own_loader(encoders, mlms):
    """The port's converter gives the state_dict transformers' Flax-to-PyTorch loader gives."""
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    for flax, ours, cls in ((*encoders, BertModel), (*mlms, BertForMaskedLM)):
        ref = load_flax_weights_in_pytorch_model(cls(_config()).eval(), flax.params).state_dict()
        mine = ours.state_dict()
        assert sorted(ref) == sorted(mine)
        for key, value in ref.items():
            assert torch.equal(value, mine[key]), key
    assert set(bert_params_from_jax({"params": _numpy_tree(encoders[0].params)})) == set(bert_params_from_jax(_numpy_tree(encoders[0].params)))
    with pytest.raises(ValueError, match="does not fit"):
        load_bert_params(BertForMaskedLM(_config()), _numpy_tree(encoders[0].params))


def _jax_forward(model, batch):
    return model(batch["input_ids"], batch["attention_mask"]).last_hidden_state


def _port_forward(model, batch):
    return model(input_ids=batch["input_ids"].long(), attention_mask=batch["attention_mask"].long()).last_hidden_state


@pytest.mark.parametrize("kw", [{}, {"idf": True}, {"num_layers": 1}, {"all_layers": True}, {"idf": True, "batch_size": 3},
                                {"user_forward_fn": True}, {"user_forward_fn": True, "idf": True}, {"return_hash": True}])
def test_bert_score_matches_jax(encoders, kw):
    flax, port = encoders
    preds, refs = _pairs(1)
    tok = _WordHashTokenizer()
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("user_forward_fn"):
        jkw["user_forward_fn"], tkw["user_forward_fn"] = _jax_forward, _port_forward
    want = JF.bert_score(preds, refs, model=flax, user_tokenizer=tok, **jkw)
    got = TF.bert_score(preds, refs, model=port, user_tokenizer=tok, **tkw)
    assert sorted(got) == sorted(want)
    for key in ("precision", "recall", "f1"):
        assert _np(got[key]).shape == np.asarray(want[key]).shape and _np(got[key]).dtype == np.float32, key
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=BERT_ATOL, rtol=0, err_msg=key)
    if "hash" in want:
        assert got["hash"] == want["hash"]


@pytest.mark.parametrize("all_layers", [False, True])
def test_bert_score_baseline_rescaling_from_a_local_csv(encoders, tmp_path, all_layers):
    flax, port = encoders
    path = tmp_path / "baseline.csv"
    path.write_text("LAYER,P,R,F\n0,0.1,0.2,0.15\n1,0.3,0.25,0.2\n2,0.35,0.3,0.32\n")
    preds, refs = _pairs(2, 6)
    tok = _WordHashTokenizer()
    kw = dict(rescale_with_baseline=True, baseline_path=str(path), all_layers=all_layers)
    want = JF.bert_score(preds, refs, model=flax, user_tokenizer=tok, **kw)
    got = TF.bert_score(preds, refs, model=port, user_tokenizer=tok, **kw)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=4 * BERT_ATOL, rtol=0, err_msg=key)
    with pytest.raises(ValueError) as err_t:
        TF.bert_score(preds, refs, model=port, user_tokenizer=tok, rescale_with_baseline=True)
    with pytest.raises(ValueError) as err_j:
        JF.bert_score(preds, refs, model=flax, user_tokenizer=tok, rescale_with_baseline=True)
    assert str(err_t.value) == str(err_j.value)


def _cross_checkpoints(tm, jm, make_t, make_j):
    """Each package's state tree into a fresh metric of the other: the same scores."""
    fresh = make_t()
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    jfresh = make_j()
    tree = state_to_numpy(tm, include_count=True)
    jfresh.load_state_tree({k: v if k == "_update_count" else [jnp.asarray(x) for x in v] for k, v in tree.items()})
    return fresh, jfresh


def test_bert_score_module_states_values_and_checkpoints(encoders):
    flax, port = encoders
    tok = _WordHashTokenizer()
    tm = TT.BERTScore(model=port, user_tokenizer=tok, idf=True, max_length=24, device="cpu")
    jm = JT.BERTScore(model=flax, user_tokenizer=tok, idf=True, max_length=24)
    for seed in (3, 4):
        preds, refs = _pairs(seed, 5)
        tm.update(preds, refs)
        jm.update(preds, refs)
    got, want = state_to_numpy(tm), jm.state_tree()
    assert sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key]) == 2
        for a, b in zip(got[key], want[key]):
            assert a.dtype == np.asarray(b).dtype == np.int32 and np.array_equal(a, np.asarray(b)), key
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    tval, jval = tm.compute(), jm.compute()
    for key in ("precision", "recall", "f1"):
        np.testing.assert_allclose(_np(tval[key]), np.asarray(jval[key]), atol=BERT_ATOL, rtol=0, err_msg=key)
    fresh, jfresh = _cross_checkpoints(
        tm, jm, lambda: TT.BERTScore(model=port, user_tokenizer=tok, idf=True, max_length=24, device="cpu"),
        lambda: JT.BERTScore(model=flax, user_tokenizer=tok, idf=True, max_length=24))
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(_np(fresh.compute()[key]), _np(tval[key]), err_msg=f"JAX tree into the port {key}")
        np.testing.assert_array_equal(np.asarray(jfresh.compute()[key]), np.asarray(jval[key]), err_msg=f"port tree into JAX {key}")


@pytest.mark.parametrize("measure,alpha,beta", MEASURES, ids=[m[0] for m in MEASURES])
@pytest.mark.parametrize("idf", [True, False])
def test_infolm_every_measure_matches_jax(mlms, measure, alpha, beta, idf):
    flax, port = mlms
    preds, refs = _pairs(5, 6)
    tok = _WordHashTokenizer()
    kw = dict(information_measure=measure, alpha=alpha, beta=beta, idf=idf, return_sentence_level_score=True)
    jmean, jscores = JF.infolm(preds, refs, model=flax, user_tokenizer=tok, **kw)
    tmean, tscores = TF.infolm(preds, refs, model=port, user_tokenizer=tok, **kw)
    want, got = np.asarray(jscores), _np(tscores)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if measure == "fisher_rao_distance":  # 2 arccos(s), s a float32 sum within rounding of 1: compare s = cos(d / 2)
        want, got = np.cos(want.astype(np.float64) / 2), np.cos(got.astype(np.float64) / 2)
        jmean, tmean = float(np.cos(float(jmean) / 2)), float(np.cos(float(tmean) / 2))
    np.testing.assert_array_less(np.abs(got - want), INFOLM_RTOL * np.maximum(1.0, np.abs(want)) + 1e-30)
    assert abs(float(tmean) - float(jmean)) <= INFOLM_RTOL * max(1.0, abs(float(jmean)))


def test_infolm_module_states_values_and_checkpoints(mlms):
    flax, port = mlms
    tok = _WordHashTokenizer()
    kw = dict(information_measure="l2_distance", temperature=0.5, return_sentence_level_score=True)
    tm = TT.InfoLM(model=port, user_tokenizer=tok, device="cpu", **kw)
    jm = JT.InfoLM(model=flax, user_tokenizer=tok, **kw)
    for seed in (6, 7):
        preds, refs = _pairs(seed, 4)
        tm.update(preds, refs)
        jm.update(preds, refs)
    for key, want in jm.state_tree().items():
        for a, b in zip(state_to_numpy(tm)[key], want):
            assert a.dtype == np.int32 and np.array_equal(a, np.asarray(b)), key
    (tmean, tscores), (jmean, jscores) = tm.compute(), jm.compute()
    np.testing.assert_allclose(_np(tscores), np.asarray(jscores), rtol=INFOLM_RTOL, atol=INFOLM_RTOL)
    make_t = lambda: TT.InfoLM(model=port, user_tokenizer=tok, device="cpu", **kw)  # noqa: E731
    fresh, jfresh = _cross_checkpoints(tm, jm, make_t, lambda: JT.InfoLM(model=flax, user_tokenizer=tok, **kw))
    np.testing.assert_array_equal(_np(fresh.compute()[1]), _np(tscores))
    np.testing.assert_array_equal(np.asarray(jfresh.compute()[1]), np.asarray(jscores))


def test_refusals_match_jax(encoders, mlms):
    def raised(fn, *args, **kw):
        with pytest.raises(Exception) as info:
            fn(*args, **kw)
        return type(info.value), str(info.value)

    tok = _WordHashTokenizer()
    assert raised(TF.bert_score, ["a"], ["a", "b"], model=encoders[1], user_tokenizer=tok) == raised(
        JF.bert_score, ["a"], ["a", "b"], model=encoders[0], user_tokenizer=tok)
    assert raised(TF.bert_score, ["a"], ["b"], model=encoders[1], user_tokenizer=tok, all_layers=True, user_forward_fn=_port_forward)[1] == raised(
        JF.bert_score, ["a"], ["b"], model=encoders[0], user_tokenizer=tok, all_layers=True, user_forward_fn=_jax_forward)[1]
    for kw in ({"temperature": 0}, {"information_measure": "bogus"}, {"information_measure": "alpha_divergence", "alpha": 1.0},
               {"information_measure": "beta_divergence", "beta": -1.0}, {"information_measure": "ab_divergence", "alpha": 0.5, "beta": -0.5}):
        assert raised(TF.infolm, ["a b"], ["a c"], model=mlms[1], user_tokenizer=tok, **kw) == raised(
            JF.infolm, ["a b"], ["a c"], model=mlms[0], user_tokenizer=tok, **kw)
        assert raised(TT.InfoLM, model=mlms[1], user_tokenizer=tok, device="cpu", **kw) == raised(JT.InfoLM, model=mlms[0], user_tokenizer=tok, **kw)


def test_default_model_paths_raise_in_both(tmp_path, monkeypatch):
    """Each default-model path raises the same missing-file error in both packages (the tokenizer, loaded
    first, is read from an empty cache with ``local_files_only``: nothing is downloaded), and each raises
    its ModuleNotFoundError where transformers is missing."""
    import transformers

    load = transformers.AutoTokenizer.from_pretrained
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda name, **kw: load(name, **{**kw, "local_files_only": True, "cache_dir": str(tmp_path)}))
    names = {}
    for label, F, M, extra in (("jax", JF, JT, {}), ("port", TF, TT, {"device": "cpu"})):
        names[label] = []
        for call in (lambda: F.bert_score(["a b"], ["a c"]), lambda: F.infolm(["a b"], ["a c"]),
                     lambda: M.BERTScore(**extra), lambda: M.InfoLM(**extra)):
            with pytest.raises(OSError) as err:
                call()
            names[label].append(str(err.value))
    assert names["jax"] == names["port"], names
    for pkg in ("torchmetrics_tpu", "torchmetrics_tpu_torch"):
        for name in ("bert", "infolm"):
            monkeypatch.setattr(importlib.import_module(f"{pkg}.functional.text.{name}"), "_TRANSFORMERS_AVAILABLE", False)
    for jfn, tfn in ((JF.bert_score, TF.bert_score), (JF.infolm, TF.infolm)):
        with pytest.raises(ModuleNotFoundError) as want:
            jfn(["a"], ["b"])
        with pytest.raises(ModuleNotFoundError) as got:
            tfn(["a"], ["b"])
        assert str(got.value) == str(want.value)
