# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``compute()`` returns its dicts in the JAX package's key order.

JAX's ``Metric.compute`` hands its result to ``jax.tree_util.tree_map``,
which rebuilds a plain ``dict`` (and a ``defaultdict``) with its keys
sorted and leaves an ``OrderedDict``, a list, a tuple and a NamedTuple in
their order; the port's ``_squeeze_if_scalar`` rebuilds its results the
same way. Every example of the two example tables that reads a dict out of
``compute()`` runs here in both packages up to that call, and the keys are
compared in order; so are a few metrics whose keys depend on their
arguments (the mAP, ROUGE, the IoU family's per-class keys, CLIP-IQA's
prompts) and custom metrics returning each container kind.
"""
from __future__ import annotations

import doctest
import re
from collections import OrderedDict, defaultdict
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu_torch as T
from torchmetrics_tpu import _examples as j_examples
from torchmetrics_tpu import _examples_generated as j_generated
from torchmetrics_tpu_torch import _examples as t_examples
from torchmetrics_tpu_torch import _examples_generated as t_generated
from torchmetrics_tpu_torch.utilities.data import _squeeze_if_scalar

_COMPUTE = re.compile(r"(\w+)\.compute\(\)")


def _dict_examples():
    """Keys of the examples whose ``compute()`` result is read as a dict."""
    out = []
    for j_table, t_table in ((j_examples._EXAMPLES, t_examples._EXAMPLES), (j_generated._GENERATED, t_generated._GENERATED)):
        for key, source in j_table.items():
            if key in t_table and re.search(r"\.compute\(\)(\.items\(\)|\[)", source):
                out.append((key, source, t_table[key]))
    return out


_DICT_EXAMPLES = _dict_examples()


def _keys_at_first_compute(source):
    """Run an example's statements up to its first ``compute()`` and return
    the keys of that ``compute()``'s result, in order."""
    namespace = {}
    for example in doctest.DocTestParser().get_examples(source):
        match = _COMPUTE.search(example.source)
        if match:
            return list(namespace[match.group(1)].compute())
        exec(compile(example.source, "<example>", "single"), namespace)  # noqa: S102 - the tables' own examples
    raise AssertionError("the example never calls compute()")


def test_the_tables_hold_dict_examples():
    keys = {key for key, _, _ in _DICT_EXAMPLES}
    assert len(keys) >= 10, keys
    assert any("MeanAveragePrecision" in k for k in keys) and any("ROUGEScore" in k for k in keys)


@pytest.mark.parametrize(("key", "j_source", "t_source"), _DICT_EXAMPLES, ids=[k for k, _, _ in _DICT_EXAMPLES])
def test_example_dict_keys_in_jax_order(key, j_source, t_source):
    want = _keys_at_first_compute(j_source)
    got = _keys_at_first_compute(t_source)
    assert got == want


def _box_batch(seed, n_imgs=3):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n_imgs):
        xy = rng.uniform(0, 60, (4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (4, 2))], axis=1).astype(np.float32)
        preds.append({"boxes": boxes + rng.normal(0, 2, boxes.shape).astype(np.float32),
                      "scores": rng.random(4).astype(np.float32), "labels": rng.integers(0, 3, 4)})
        target.append({"boxes": boxes, "labels": rng.integers(0, 3, 4)})
    return preds, target


def _torch_items(batch):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in batch]


def test_mean_average_precision_keys_start_with_classes():
    preds, target = _box_batch(0, 1)
    jm, tm = J.detection.MeanAveragePrecision(), T.detection.MeanAveragePrecision(device="cpu")
    jm.update(preds, target)
    tm.update(_torch_items(preds), _torch_items(target))
    got, want = list(tm.compute()), list(jm.compute())
    assert got == want
    assert got[:3] == ["classes", "map", "map_50"]


@pytest.mark.parametrize("cls", ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion",
                                 "DistanceIntersectionOverUnion", "CompleteIntersectionOverUnion"])
def test_iou_class_metrics_keys(cls):
    preds, target = _box_batch(1)
    jm = getattr(J.detection, cls)(class_metrics=True)
    tm = getattr(T.detection, cls)(class_metrics=True, device="cpu")
    jm.update(preds, target)
    tm.update(_torch_items(preds), _torch_items(target))
    got, want = list(tm.compute()), list(jm.compute())
    assert got == want and len(got) > 2


@pytest.mark.parametrize("kw", [{}, {"rouge_keys": ("rougeLsum", "rouge2", "rouge1")}, {"accumulate": "avg"}],
                         ids=["default", "keys-reversed", "avg"])
def test_rouge_keys(kw):
    preds = ["the cat sat on the mat", "a quick brown fox"]
    target = ["the cat is on the mat", "the quick brown fox jumps"]
    jm, tm = J.text.ROUGEScore(**kw), T.text.ROUGEScore(device="cpu", **kw)
    jm.update(preds, target)
    tm.update(preds, target)
    assert list(tm.compute()) == list(jm.compute())


def test_clip_iqa_two_prompts_keys():
    from tests.test_torch_multimodal import _TinyCLIPProcessor, _config, _images, _pair

    flax, port = _pair(_config())
    proc = _TinyCLIPProcessor()
    prompts = ("sharpness", ("Nice photo.", "Terrible photo."))
    images = _images(2, 3)
    jm = J.multimodal.CLIPImageQualityAssessment(prompts=prompts, model=flax, processor=proc)
    tm = T.multimodal.CLIPImageQualityAssessment(prompts=prompts, model=port, processor=proc, device="cpu")
    jm.update(images)
    tm.update(images)
    got, want = list(tm.compute()), list(jm.compute())
    assert got == want == ["sharpness", "user_defined_0"]


class _Pair(NamedTuple):
    second: object
    first: object


_KINDS = {
    "dict": lambda v: {"zeta": v, "alpha": v + 1, "mid": {"z": v, "b": v}},
    "defaultdict": lambda v: defaultdict(int, {"zeta": v, "alpha": v + 1}),
    "ordereddict": lambda v: OrderedDict([("zeta", v), ("alpha", v + 1), ("mid", {"z": v, "b": v})]),
    "namedtuple": lambda v: _Pair({"y": v, "x": v}, [v, {"d": v, "c": v}]),
}


def _kind_metric(package, xp, kind):
    class KindMetric(package.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", xp.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + x.sum()

        def compute(self):
            return _KINDS[kind](self.total)

    return KindMetric


def _structure(value):
    """The keys, containers and their order of a nested result, leaves dropped."""
    if isinstance(value, dict):
        return (type(value).__name__, [(k, _structure(v)) for k, v in value.items()])
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [_structure(v) for v in value])
    return "leaf"


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_container_kinds_keep_jax_order(kind):
    jm = _kind_metric(J, jnp, kind)()
    tm = _kind_metric(T, torch, kind)(device="cpu")
    jm.update(jnp.ones(3))
    tm.update(torch.ones(3))
    got, want = tm.compute(), jm.compute()
    assert _structure(got) == _structure(want)
    if kind == "ordereddict":
        assert list(got) == ["zeta", "alpha", "mid"]
    if kind == "defaultdict":
        assert got.default_factory is int and list(got) == ["alpha", "zeta"]


def test_forward_batch_value_sorted_too():
    tm = _kind_metric(T, torch, "dict")(device="cpu")
    jm = _kind_metric(J, jnp, "dict")()
    assert list(tm(torch.ones(2))) == list(jm(jnp.ones(2))) == ["alpha", "mid", "zeta"]


def test_uncomparable_keys_keep_their_order():
    value = _squeeze_if_scalar({2: torch.ones(1), "a": torch.ones(2)})
    assert list(value) == [2, "a"] and value[2].shape == ()
