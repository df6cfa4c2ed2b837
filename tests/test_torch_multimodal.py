# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""CLIPScore and CLIP-IQA of the port against the JAX package's, on the
tiny CLIP configuration of ``tests/unittests/multimodal/test_clip_and_bert.py``
built from a config (no download): the JAX package runs transformers'
``FlaxCLIPModel``, the port transformers' PyTorch ``CLIPModel`` with the same
weights, carried across by the port's converter
(``multimodal/weights.py::clip_params_from_jax``, itself held against
transformers' own Flax-to-PyTorch loader here). Both packages use JAX's
word-hash processor; its ``hash(w)`` is salted per process, so both
packages' inputs are built in this one process and no score is pinned.

Budgets: features within ``FEATURE_ATOL`` (1e-5), the scores (0-100)
within ``SCORE_ATOL`` (1e-4) and CLIP-IQA's probabilities within
``PROB_ATOL`` (1e-5): the same float32 towers in Flax (XLA) and PyTorch
(oneDNN) add in other orders. Refusals and the truncation warning carry
JAX's messages; the states are JAX's (dtypes after ``set_dtype`` too) and
checkpoints cross both ways.
"""
from __future__ import annotations

import importlib
import inspect
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from transformers import BertConfig, CLIPConfig, CLIPModel, FlaxBertModel, FlaxCLIPModel  # noqa: E402

import torchmetrics_tpu.functional.multimodal as JF  # noqa: E402
import torchmetrics_tpu.multimodal as JM  # noqa: E402
import torchmetrics_tpu_torch.functional.multimodal as TF  # noqa: E402
import torchmetrics_tpu_torch.multimodal as TM  # noqa: E402
from torchmetrics_tpu.functional.multimodal.clip_iqa import _PROMPTS as J_PROMPTS  # noqa: E402
from torchmetrics_tpu.functional.multimodal.clip_iqa import _clip_iqa_compute as j_compute  # noqa: E402
from torchmetrics_tpu.functional.multimodal.clip_iqa import _clip_iqa_get_anchor_vectors as j_anchors  # noqa: E402
from torchmetrics_tpu.functional.multimodal.clip_iqa import _clip_iqa_update as j_update  # noqa: E402
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _PROMPTS as T_PROMPTS  # noqa: E402
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _clip_iqa_compute as t_compute  # noqa: E402
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _clip_iqa_get_anchor_vectors as t_anchors  # noqa: E402
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import _clip_iqa_update as t_update  # noqa: E402
from torchmetrics_tpu_torch.multimodal.weights import clip_params_from_jax, load_clip_params  # noqa: E402

FEATURE_ATOL = 1e-5
SCORE_ATOL = 1e-4
PROB_ATOL = 1e-5
CPU = "cpu"


class _WordHashTokenizer:
    """JAX's test tokenizer (``test_clip_and_bert.py``): words hashed into a small id space, 1 first, ``end`` last."""

    end = 2

    def __init__(self, vocab_size=64, max_len=16):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, text=None, padding=True, truncation=True, max_length=None, return_tensors="np", **kw):
        max_length = min(max_length or self.max_len, self.max_len)
        rows = []
        for sentence in text:
            ids = [1]
            ids += [3 + (hash(w) % (self.vocab_size - 4)) for w in sentence.lower().split()]
            ids = ids[: max_length - 1] + [self.end]
            rows.append(ids)
        width = max_length if padding == "max_length" else max(len(r) for r in rows)
        input_ids = np.zeros((len(rows), width), np.int32)
        attention_mask = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


class _TinyCLIPProcessor(_WordHashTokenizer):
    """JAX's test processor: the tokenizer and images passed through as 3 x 32 x 32 float32."""

    def __call__(self, text=None, images=None, return_tensors="np", padding=True, **kw):
        out = {}
        if text is not None:
            out.update(super().__call__(text=text, padding=padding))
        if images is not None:
            out["pixel_values"] = np.stack([np.asarray(i, np.float32).reshape(3, 32, 32) for i in images])
        return out


class _EndAt63(_TinyCLIPProcessor):
    """The same processor with 63 (below the vocabulary's 64) as the last token: an EOS id that is present."""

    end = 63


def _config(**text):
    return CLIPConfig(
        text_config={"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2,
                     "num_hidden_layers": 2, "vocab_size": 64, "max_position_embeddings": 32, **text},
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 2,
                       "num_hidden_layers": 2, "image_size": 32, "patch_size": 8},
        projection_dim=16,
    )


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(config):
    flax = FlaxCLIPModel(config, seed=0)
    return flax, load_clip_params(CLIPModel(config).eval(), _numpy_tree(flax.params))


@pytest.fixture(scope="module")
def clips():
    return _pair(_config())


def _np(x):
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _images(seed, n=4):
    return np.random.RandomState(seed).rand(n, 3, 32, 32).astype(np.float32)


CAPTIONS = ["a photo of a cat", "a dog on the grass", "two birds in a blue sky", "an empty street at night"]


def test_converter_matches_transformers_own_loader(clips):
    """The port's converter gives the state_dict transformers' Flax-to-PyTorch loader gives, the patch
    embedding's kernel (8, 8, 3, 32) as (32, 3, 8, 8); a tree that does not fit is refused."""
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    flax, port = clips
    ref = load_flax_weights_in_pytorch_model(CLIPModel(_config()).eval(), flax.params).state_dict()
    mine = port.state_dict()
    assert sorted(ref) == sorted(mine)
    for key, value in ref.items():
        assert torch.equal(value, mine[key]), key
    tree = _numpy_tree(flax.params)
    params = clip_params_from_jax(tree)
    assert tree["vision_model"]["embeddings"]["patch_embedding"]["kernel"].shape == (8, 8, 3, 32)
    assert tuple(params["vision_model.embeddings.patch_embedding.weight"].shape) == (32, 3, 8, 8)
    assert params["logit_scale"].shape == () and float(params["logit_scale"]) == float(tree["logit_scale"])
    assert torch.equal(params["vision_model.embeddings.class_embedding"],
                       torch.from_numpy(tree["vision_model"]["embeddings"]["class_embedding"]))
    assert set(clip_params_from_jax({"params": tree})) == set(params)
    with pytest.raises(ValueError, match="does not fit"):  # a BERT tree
        load_clip_params(CLIPModel(_config()), _numpy_tree(FlaxBertModel(BertConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, vocab_size=64), seed=0).params))
    with pytest.raises(ValueError, match="misshapen"):  # one layer, other widths
        load_clip_params(CLIPModel(_config(hidden_size=16, intermediate_size=32)), tree)
    with pytest.raises(ValueError, match="missing"):  # a layer too many
        load_clip_params(CLIPModel(_config(num_hidden_layers=3)), tree)


def test_features_match_jax(clips):
    flax, port = clips
    images = _images(0)
    proc = _TinyCLIPProcessor()
    enc = proc(text=CAPTIONS)
    want_img = np.asarray(flax.get_image_features(jnp.asarray(images)))
    want_txt = np.asarray(flax.get_text_features(jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"])))
    with torch.no_grad():
        got_img = _np(port.get_image_features(torch.from_numpy(images)))
        got_txt = _np(port.get_text_features(input_ids=torch.from_numpy(enc["input_ids"]).long(),
                                             attention_mask=torch.from_numpy(enc["attention_mask"]).long()))
    assert got_img.shape == want_img.shape == (4, 16) and got_txt.shape == want_txt.shape == (4, 16)
    np.testing.assert_allclose(got_img, want_img, atol=FEATURE_ATOL, rtol=0)
    np.testing.assert_allclose(got_txt, want_txt, atol=FEATURE_ATOL, rtol=0)
    # the unit-norm features the update paths use
    np.testing.assert_allclose(_np(t_update(images, port, proc, 1.0, CPU)), np.asarray(j_update(images, flax, proc, 1.0)),
                               atol=FEATURE_ATOL, rtol=0)


@pytest.mark.parametrize("form", ["list", "array", "tensor", "one"])
def test_clip_score_functional_matches_jax(clips, form):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = _images(1)
    jimages, timages, text = {
        "list": (list(jnp.asarray(images)), [torch.from_numpy(i) for i in images], CAPTIONS),
        "array": (images, images, CAPTIONS),
        "tensor": (jnp.asarray(images), torch.from_numpy(images), CAPTIONS),
        "one": (images[0], torch.from_numpy(images[0]), CAPTIONS[0]),
    }[form]
    want = JF.clip_score(jimages, text, model=flax, processor=proc)
    got = TF.clip_score(timages, text, model=port, processor=proc, device=CPU)
    assert got.dtype == torch.float32 and got.shape == () and got.device.type == "cpu"
    assert abs(float(got) - float(want)) <= SCORE_ATOL
    from torchmetrics_tpu.functional.multimodal.clip_score import _clip_score_update as j_score
    from torchmetrics_tpu_torch.functional.multimodal.clip_score import _clip_score_update as t_score

    (js, jn), (ts, tn) = j_score(jimages, text, flax, proc), t_score(timages, text, port, proc, CPU)
    assert jn == tn and _np(ts).shape == np.asarray(js).shape
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=SCORE_ATOL, rtol=0)


def test_clip_score_module_matches_jax_in_one_and_two_updates(clips):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = _images(2)
    want = float(JF.clip_score(list(images), CAPTIONS, model=flax, processor=proc))
    one = TM.CLIPScore(model=port, processor=proc, device=CPU)
    one.update(torch.from_numpy(images), CAPTIONS)
    two = TM.CLIPScore(model=port, processor=proc, device=CPU)
    two.update(images[:1], CAPTIONS[:1])
    two.update(images[1:], CAPTIONS[1:])
    jm = JM.CLIPScore(model=flax, processor=proc)
    jm.update(jnp.asarray(images[:3]), CAPTIONS[:3])
    jm.update(jnp.asarray(images[3:]), CAPTIONS[3:])
    for metric in (one, two):
        assert metric.score.dtype == torch.float32 and metric.n_samples.dtype == torch.int32
        assert int(metric.n_samples) == int(jm.n_samples) == 4
        assert abs(float(metric.score) - float(jm.score)) <= 4 * SCORE_ATOL
        assert abs(float(metric.compute()) - want) <= SCORE_ATOL
        assert abs(float(metric.compute()) - float(jm.compute())) <= SCORE_ATOL


@pytest.mark.parametrize(
    "prompts",
    [("quality",), ("quality", "brightness", "sharpness"), (("Nice photo.", "Terrible photo."),),
     ("quality", ("Nice photo.", "Terrible photo."), ("A", "B")), tuple(T_PROMPTS) + (("Nice photo.", "Terrible photo."),)],
    ids=["one", "several", "one-custom", "custom-pairs", "all-16-and-custom"],
)
def test_clip_iqa_matches_jax(clips, prompts):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = _images(3, 5)
    want = JF.clip_image_quality_assessment(images, prompts=prompts, model=flax, processor=proc)
    got = TF.clip_image_quality_assessment(torch.from_numpy(images), prompts=prompts, model=port, processor=proc, device=CPU)
    module = TM.CLIPImageQualityAssessment(prompts=prompts, model=port, processor=proc, device=CPU)
    module.update(images[:2])
    module.update(images[2:])
    jmodule = JM.CLIPImageQualityAssessment(prompts=prompts, model=flax, processor=proc)
    jmodule.update(images)
    for value, jvalue in ((got, want), (module.compute(), jmodule.compute())):
        assert type(value) is dict if len(prompts) > 1 else isinstance(value, torch.Tensor)
        value, jvalue = (value, jvalue) if isinstance(value, dict) else ({"": value}, {"": jvalue})
        assert list(value) == list(jvalue)
        for key in jvalue:
            assert _np(value[key]).shape == np.asarray(jvalue[key]).shape == (5,), key
            assert np.all((_np(value[key]) >= 0) & (_np(value[key]) <= 1)), key
            np.testing.assert_allclose(_np(value[key]), np.asarray(jvalue[key]), atol=PROB_ATOL, rtol=0, err_msg=key)
    # the matrix form, from the same features and anchors
    prompts_list, names = TF.clip_iqa._clip_iqa_format_prompts(prompts)
    feats, anchors = t_update(images, port, proc, 1.0, CPU), t_anchors(port, proc, prompts_list, CPU)
    jfeats, janchors = j_update(images, flax, proc, 1.0), j_anchors(flax, proc, prompts_list)
    np.testing.assert_allclose(_np(anchors), np.asarray(janchors), atol=FEATURE_ATOL, rtol=0)
    matrix, jmatrix = t_compute(feats, anchors, names, format_as_dict=False), j_compute(jfeats, janchors, names, format_as_dict=False)
    assert _np(matrix).shape == np.asarray(jmatrix).shape
    np.testing.assert_allclose(_np(matrix), np.asarray(jmatrix), atol=PROB_ATOL, rtol=0)


def test_clip_iqa_data_range_and_cached_anchors(clips):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = (_images(4) * 255).astype(np.uint8)
    want = JF.clip_image_quality_assessment(images, data_range=255, model=flax, processor=proc)
    got = TF.clip_image_quality_assessment(images, data_range=255, model=port, processor=proc, device=CPU)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=PROB_ATOL, rtol=0)
    metric = TM.CLIPImageQualityAssessment(data_range=255.0, model=port, processor=proc, device=CPU)
    assert metric._anchors is None
    metric.update(images)
    first = metric.compute()
    anchors = metric._anchors
    metric.update(images)
    assert metric.anchors is anchors and _np(metric.compute()).shape == (8,)
    np.testing.assert_allclose(_np(first), np.asarray(want), atol=PROB_ATOL, rtol=0)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def test_refusals_match_jax(clips):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    pairs = [
        (lambda m, **d: (TF if d else JF).clip_score([np.zeros((3, 32, 32), np.float32)], ["a", "b"], model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_score([np.zeros((32, 32), np.float32)], ["a"], model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_score(np.zeros((2, 1, 3, 32, 32), np.float32), ["a", "b"], model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 3, 32, 32)), prompts=("bogus",), model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 3, 32, 32)), prompts=(("a", "b", "c"),), model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 3, 32, 32)), prompts="quality", model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 3, 32, 32)), prompts=(1,), model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 32, 32)), model=m, processor=proc, **d)),
        (lambda m, **d: (TF if d else JF).clip_image_quality_assessment(np.zeros((1, 1, 32, 32)), model=m, processor=proc, **d)),
        (lambda m, **d: (TM if d else JM).CLIPImageQualityAssessment(data_range=0, model=m, processor=proc, **d)),
        (lambda m, **d: (TM if d else JM).CLIPImageQualityAssessment(data_range="1", model=m, processor=proc, **d)),
        (lambda m, **d: (TM if d else JM).CLIPImageQualityAssessment(prompts=("bogus",), model=m, processor=proc, **d)),
        (lambda m, **d: (TM if d else JM).CLIPImageQualityAssessment(model=m, processor=proc, **d).update(np.zeros((2, 32, 32)))),
        (lambda m, **d: (TM if d else JM).CLIPScore(model=m, processor=proc, **d).update(np.zeros((2, 3, 32, 32)), ["a"])),
    ]
    for i, call in enumerate(pairs):
        assert _raised(call, port, device=CPU) == _raised(call, flax), i


def test_truncation_past_max_position_embeddings_warns_as_jax(clips):
    """Captions of 40 tokens at max_position_embeddings=32: both warn with JAX's message and truncate alike."""
    flax, port = clips
    proc = _TinyCLIPProcessor(max_len=48)
    images = _images(5, 2)
    text = [" ".join(f"w{i}" for i in range(38)), "short caption"]
    for pkg, model, extra in ((JF, flax, {}), (TF, port, {"device": CPU})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            value = pkg.clip_score(list(images), text, model=model, processor=proc, **extra)
        messages = [str(w.message) for w in caught if issubclass(w.category, UserWarning) and "max_position_embeddings" in str(w.message)]
        assert len(messages) == 1, messages
        if pkg is JF:
            want, jmessages = float(value), messages
    assert messages == jmessages
    assert "max_position_embeddings=32" in messages[0]
    assert abs(float(value) - want) <= SCORE_ATOL


@pytest.mark.parametrize("case", ["absent", "present", "eos-2"])
def test_eos_pooling_matches_jax(case):
    """Where the text tower pools: CLIP's default eos 49407 is absent from these ids (position 0 in both),
    eos 63 is each caption's last token (its first occurrence), eos 2 takes the legacy argmax of the ids."""
    config = {"absent": _config(), "present": _config(eos_token_id=63), "eos-2": _config(eos_token_id=2)}[case]
    proc = _EndAt63() if case == "present" else _TinyCLIPProcessor()
    flax, port = _pair(config)
    enc = proc(text=CAPTIONS)
    want = np.asarray(flax.get_text_features(jnp.asarray(enc["input_ids"]), jnp.asarray(enc["attention_mask"])))
    with torch.no_grad():
        ids = torch.from_numpy(enc["input_ids"]).long()
        got = _np(port.get_text_features(input_ids=ids, attention_mask=torch.from_numpy(enc["attention_mask"]).long()))
        hidden = port.text_model(input_ids=ids, attention_mask=torch.from_numpy(enc["attention_mask"]).long()).last_hidden_state
    np.testing.assert_allclose(got, want, atol=FEATURE_ATOL, rtol=0)
    rows = np.arange(len(CAPTIONS))
    at = {"absent": np.zeros(len(CAPTIONS), int), "present": enc["attention_mask"].sum(1) - 1,
          "eos-2": enc["input_ids"].argmax(1)}[case]
    with torch.no_grad():
        expected = _np(port.text_projection(hidden[rows, torch.from_numpy(at)]))
    np.testing.assert_allclose(got, expected, atol=1e-6, rtol=0)


@pytest.mark.parametrize("tdt,jdt", [(torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16)], ids=["bf16", "f16"])
def test_set_dtype_then_update_as_jax(clips, tdt, jdt):
    """``set_dtype`` then a float32 update: each state's dtype is JAX's (a 16-bit score plus a float32 sum is float32)."""
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = _images(6, 2)
    for make_t, make_j, args in (
        (lambda: TM.CLIPScore(model=port, processor=proc, device=CPU), lambda: JM.CLIPScore(model=flax, processor=proc), (images, CAPTIONS[:2])),
        (lambda: TM.CLIPImageQualityAssessment(model=port, processor=proc, device=CPU),
         lambda: JM.CLIPImageQualityAssessment(model=flax, processor=proc), (images,)),
    ):
        tm, jm = make_t().set_dtype(tdt), make_j().set_dtype(jdt)
        for name in ("score", "n_samples"):
            if hasattr(jm, name):
                assert str(getattr(tm, name).dtype).split(".")[-1] == str(getattr(jm, name).dtype), name
        tm.update(*args)
        jm.update(*args)
        for name, want in jm.state_tree().items():
            got = getattr(tm, name)
            pairs = zip(got, want) if isinstance(want, list) else [(got, want)]
            for a, b in pairs:
                assert _np(a).dtype == np.asarray(b).dtype, name
                np.testing.assert_allclose(_np(a).astype(np.float64), np.asarray(b).astype(np.float64), atol=4 * SCORE_ATOL, rtol=0)
        value, jvalue = tm.compute(), jm.compute()
        assert _np(value).dtype == np.asarray(jvalue).dtype
        np.testing.assert_allclose(_np(value), np.asarray(jvalue), atol=SCORE_ATOL, rtol=0)


def test_checkpoints_cross_both_ways(clips):
    flax, port = clips
    proc = _TinyCLIPProcessor()
    images = _images(7, 3)
    for make_t, make_j, args in (
        (lambda: TM.CLIPScore(model=port, processor=proc, device=CPU), lambda: JM.CLIPScore(model=flax, processor=proc), (images, CAPTIONS[:3])),
        (lambda: TM.CLIPImageQualityAssessment(prompts=("quality", "warm"), model=port, processor=proc, device=CPU),
         lambda: JM.CLIPImageQualityAssessment(prompts=("quality", "warm"), model=flax, processor=proc), (images,)),
    ):
        tm, jm = make_t(), make_j()
        tm.update(*args)
        jm.update(*args)
        assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
        fresh, jfresh = make_t(), make_j()
        fresh.load_checkpoint(pickle.loads(pickle.dumps(jm.save_checkpoint())))
        jfresh.load_checkpoint(pickle.loads(pickle.dumps(tm.save_checkpoint())))
        for got, want in ((fresh.compute(), jm.compute()), (tm.compute(), jfresh.compute())):
            got, want = (got, want) if isinstance(got, dict) else ({"": got}, {"": want})
            for key in want:
                np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=SCORE_ATOL, rtol=0, err_msg=key)


def test_default_model_paths_raise(tmp_path, monkeypatch):
    """Without an injected pair the port reads transformers' CLIP from the local cache alone: from an empty
    cache each entry point raises OSError (nothing is downloaded); without transformers, JAX's
    ModuleNotFoundError; without a card, a module metric not asked for the CPU raises before loading."""
    import transformers

    for cls in (transformers.CLIPModel, transformers.CLIPProcessor):
        load = cls.from_pretrained
        monkeypatch.setattr(cls, "from_pretrained", lambda name, _load=load, **kw: _load(
            name, **{**kw, "local_files_only": True, "cache_dir": str(tmp_path)}))
    images = _images(8, 1)
    for call in (lambda: TF.clip_score(images, ["a"], device=CPU), lambda: TF.clip_image_quality_assessment(images, device=CPU),
                 lambda: TM.CLIPScore(device=CPU), lambda: TM.CLIPImageQualityAssessment(device=CPU)):
        with pytest.raises(OSError):
            call()
    if not torch.cuda.is_available():
        for cls in (TM.CLIPScore, TM.CLIPImageQualityAssessment):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls()
    for pkg in ("torchmetrics_tpu", "torchmetrics_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(f"{pkg}.functional.multimodal.clip_score"), "_TRANSFORMERS_AVAILABLE", False)
    assert _raised(TF.clip_score, images, ["a"], device=CPU) == _raised(JF.clip_score, images, ["a"])
    assert _raised(TM.CLIPScore, device=CPU) == _raised(JM.CLIPScore)


def test_signatures_flags_and_prompts_are_jax_s():
    """The entry points take JAX's arguments (the functionals one more, ``device``), the classes carry JAX's
    flags and plot bounds, and the prompt table is JAX's letter for letter."""
    assert T_PROMPTS == J_PROMPTS and list(T_PROMPTS) == list(J_PROMPTS)
    for name in ("clip_score", "clip_image_quality_assessment"):
        jsig, tsig = inspect.signature(getattr(JF, name)), inspect.signature(getattr(TF, name))
        assert list(tsig.parameters) == list(jsig.parameters) + ["device"]
        for key, param in jsig.parameters.items():
            assert tsig.parameters[key].default == param.default, (name, key)
    for name in ("CLIPScore", "CLIPImageQualityAssessment"):
        jcls, tcls = getattr(JM, name), getattr(TM, name)
        assert inspect.signature(tcls.__init__).parameters.keys() == inspect.signature(jcls.__init__).parameters.keys()
        for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
            assert getattr(tcls, attr) == getattr(jcls, attr), (name, attr)
    assert sorted(TF.__all__) == sorted(JF.__all__) and sorted(TM.__all__) == sorted(JM.__all__)
