# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Segmentation of the port (``mean_iou``, ``generalized_dice_score``,
``MeanIoU``, ``GeneralizedDiceScore``) against the JAX package's; the cases
of ``tests/unittests/pairwise_segmentation/test_pairwise_segmentation.py``'s
segmentation half, and every argument branch.

The same seeded numpy inputs go through both packages on the CPU. Budgets:

- the per-sample, per-class intersections, unions and sums are integer
  counts and bitwise, dtype included; so are the states' batch counts;
- on label maps and integer one-hots every value and float state is bitwise
  too (tolerance 0): each is elementwise float32 arithmetic on exact counts,
  and every sum over the classes or the batch adds in XLA's CPU order
  (``_sum_last_in_xla_order``, JAX's bits up to 64 values);
- on float one-hot inputs (probabilities) the spatial sums add in torch's
  order: ``rtol=1e-6, atol=1e-7``.
"""
from __future__ import annotations

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional.classification as JFC
import torchmetrics_tpu.functional.segmentation as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional.classification as TFC
import torchmetrics_tpu_torch.functional.segmentation as TF
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility

N, C, H, W = 4, 5, 12, 10
RTOL, ATOL = 1e-6, 1e-7

j_iou = importlib.import_module("torchmetrics_tpu.functional.segmentation.mean_iou")
t_iou = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.mean_iou")
j_gd = importlib.import_module("torchmetrics_tpu.functional.segmentation.generalized_dice")
t_gd = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.generalized_dice")


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _raised(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def _labels(seed, n=N, missing=()):
    """Seeded index maps; the classes in ``missing`` never occur in the
    target (an empty ground-truth class: an infinite dice weight)."""
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, C, (n, H, W)).astype(np.int32)
    target = rng.integers(0, C, (n, H, W)).astype(np.int32)
    for cls in missing:
        target[target == cls] = (cls + 1) % C
    return preds, target


def _onehot(labels):
    return np.moveaxis(np.eye(C, dtype=np.int32)[labels], -1, 1)


def _inputs(fmt, seed, missing=()):
    preds, target = _labels(seed, missing=missing)
    if fmt == "one-hot":
        return _onehot(preds), _onehot(target)
    if fmt == "float":  # softmax probabilities against a one-hot target
        logits = np.random.default_rng(seed + 50).standard_normal((N, C, H, W)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), _onehot(target).astype(np.float32)
    return preds, target


def _fmt(fmt):
    return "index" if fmt == "index" else "one-hot"


FLAGS = [(bg, pc) for bg in (True, False) for pc in (True, False)]


@pytest.mark.parametrize("fmt", ["index", "one-hot"])
@pytest.mark.parametrize("bg,pc", FLAGS)
def test_mean_iou_functional_bitwise(fmt, bg, pc):
    preds, target = _inputs(fmt, seed=1, missing=(2,))
    want = JF.mean_iou(preds, target, C, bg, pc, _fmt(fmt))
    got = TF.mean_iou(torch.from_numpy(preds), torch.from_numpy(target), C, bg, pc, _fmt(fmt))
    _bitwise(got, want, "mean_iou")


@pytest.mark.parametrize("fmt", ["index", "one-hot"])
@pytest.mark.parametrize("bg", [True, False])
def test_mean_iou_counts_bitwise(fmt, bg):
    """The per-sample, per-class intersection and union."""
    preds, target = _inputs(fmt, seed=2)
    want = j_iou._mean_iou_update(jnp.asarray(preds), jnp.asarray(target), C, bg, _fmt(fmt))
    got = t_iou._mean_iou_update(torch.from_numpy(preds), torch.from_numpy(target), C, bg, _fmt(fmt))
    for g, w, what in zip(got, want, ("intersection", "union")):
        _bitwise(g, w, what)


@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
@pytest.mark.parametrize("fmt", ["index", "one-hot", "float"])
@pytest.mark.parametrize("bg,pc", FLAGS)
def test_generalized_dice_functional(weight_type, fmt, bg, pc):
    """Class 2 is absent from the target: its weight is infinite and takes
    the sample's largest finite weight, JAX's deliberate deviation."""
    preds, target = _inputs(fmt, seed=3, missing=(2,))
    want = JF.generalized_dice_score(preds, target, C, bg, pc, weight_type, _fmt(fmt))
    got = TF.generalized_dice_score(torch.from_numpy(preds), torch.from_numpy(target), C, bg, pc, weight_type, _fmt(fmt))
    (_close if fmt == "float" else _bitwise)(got, want, "generalized_dice_score")


@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
@pytest.mark.parametrize("bg", [True, False])
def test_generalized_dice_terms_bitwise(weight_type, bg):
    """The per-sample, per-class weighted numerator and denominator, with an
    empty ground-truth class (the per-sample max weight)."""
    preds, target = _inputs("index", seed=7, missing=(1, 3))
    want = j_gd._generalized_dice_update(jnp.asarray(preds), jnp.asarray(target), C, bg, weight_type, "index")
    got = t_gd._generalized_dice_update(torch.from_numpy(preds), torch.from_numpy(target), C, bg, weight_type, "index")
    for g, w, what in zip(got, want, ("numerator", "denominator")):
        _bitwise(g, w, what)


def test_generalized_dice_is_reexported_from_classification():
    assert TFC.generalized_dice_score is TF.generalized_dice_score
    assert "generalized_dice_score" in TFC.__all__ and "generalized_dice_score" in JFC.__all__


def test_out_of_range_labels_raise_jax_errors_and_one_hot_to_zeros_under_capture(monkeypatch):
    """Concrete index labels outside ``[0, C)`` raise JAX's ``ValueError``;
    where values cannot be read (``_is_concrete`` false, as under a CUDA
    graph capture) they one-hot to zero rows, as JAX's do under ``jit``."""
    preds, target = _labels(seed=4)
    bad = target.copy()
    bad[0, 0, 0], bad[1, 2, 3] = C, -1
    for fn in ("mean_iou", "generalized_dice_score"):
        want = _raised(getattr(JF, fn), preds, bad, C, input_format="index")
        got = _raised(getattr(TF, fn), torch.from_numpy(preds), torch.from_numpy(bad), C, input_format="index")
        assert got == want and got[0] is ValueError
    seg = importlib.import_module("torchmetrics_tpu_torch.functional.segmentation.utils")
    monkeypatch.setattr(seg, "_is_concrete", lambda x: False)
    want = jax.jit(partial(j_iou._mean_iou_update, num_classes=C, include_background=True, input_format="index"))(
        jnp.asarray(preds), jnp.asarray(bad))
    got = t_iou._mean_iou_update(torch.from_numpy(preds), torch.from_numpy(bad), C, True, "index")
    for g, w in zip(got, want):
        _bitwise(g, w, "under capture")


@pytest.mark.parametrize("fn,kwargs", [
    ("mean_iou", {"num_classes": 0}),
    ("mean_iou", {"num_classes": C, "include_background": 1}),
    ("mean_iou", {"num_classes": C, "per_class": "yes"}),
    ("mean_iou", {"num_classes": C, "input_format": "probs"}),
    ("generalized_dice_score", {"num_classes": -1}),
    ("generalized_dice_score", {"num_classes": C, "weight_type": "cubic"}),
    ("generalized_dice_score", {"num_classes": C, "include_background": None}),
    ("generalized_dice_score", {"num_classes": C, "input_format": "labels"}),
])
def test_argument_errors_match_jax(fn, kwargs):
    preds, target = _inputs("one-hot", seed=5)
    want = _raised(getattr(JF, fn), preds, target, **kwargs)
    assert _raised(getattr(TF, fn), torch.from_numpy(preds), torch.from_numpy(target), **kwargs) == want


@pytest.mark.parametrize("fn", ["mean_iou", "generalized_dice_score"])
def test_shape_errors_match_jax(fn):
    preds, target = _inputs("one-hot", seed=6)
    cases = [
        (preds, target[:, :-1], "one-hot"),  # one-hot shapes differ
        (preds[:, :, 0, 0], target[:, :, 0, 0], "one-hot"),  # fewer than 3 dims
        (np.zeros(N, np.int32), np.zeros(N, np.int32), "index"),  # fewer than 2 dims
    ]
    for p, t, fmt in cases:
        want = _raised(getattr(JF, fn), p, t, C, input_format=fmt)
        assert _raised(getattr(TF, fn), torch.from_numpy(p), torch.from_numpy(t), C, input_format=fmt) == want


def _module_pair(name, kw):
    return getattr(J, name)(**kw), getattr(T, name)(device="cpu", **kw)


MODULE_CASES = [
    ("MeanIoU", {"num_classes": C, "include_background": bg, "per_class": pc, "input_format": fmt})
    for bg, pc in FLAGS for fmt in ("index", "one-hot")
] + [
    ("GeneralizedDiceScore", {"num_classes": C, "include_background": bg, "per_class": pc, "weight_type": wt,
                              "input_format": fmt})
    for bg, pc in FLAGS for wt in ("square", "simple", "linear") for fmt in ("index", "one-hot")
]


def _module_id(case):
    name, kw = case
    return "-".join([name] + [f"{k}={v}" for k, v in kw.items() if k != "num_classes"])


@pytest.mark.parametrize("case", MODULE_CASES, ids=_module_id)
def test_module_states_values_and_checkpoints(case):
    """Three batches (of 4, 4 and 3 samples) into both: every state and the
    value bitwise; the fingerprint; each state tree into a fresh metric of
    the other package, the same value."""
    name, kw = case
    jm, tm = _module_pair(name, kw)
    fmt = "one-hot" if kw["input_format"] == "one-hot" else "index"
    for seed in range(3):
        preds, target = _inputs(fmt, seed=10 + seed, missing=(seed,))
        if seed == 2:
            preds, target = preds[:3], target[:3]
        jm.update(preds, target)
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = {k: np.asarray(v) for k, v in jm.state_tree().items()}
    got = state_to_numpy(tm)
    assert sorted(want) == sorted(got)
    for state in want:
        _bitwise(got[state], want[state], state)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    _bitwise(tm.compute(), jm.compute(), name)

    fresh, jfresh = _module_pair(name, kw)
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    _bitwise(fresh.compute(), jm.compute(), "JAX tree into the port")
    jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v)
                            for k, v in state_to_numpy(tm, include_count=True).items()})
    _bitwise(tm.compute(), jfresh.compute(), "port tree into JAX")


def test_mean_iou_batch_count_is_int32():
    jm, tm = _module_pair("MeanIoU", {"num_classes": C})
    assert _np(tm.num_batches).dtype == np.asarray(jm.num_batches).dtype == np.int32
    assert _np(tm.score).dtype == np.asarray(jm.score).dtype == np.float32


@pytest.mark.parametrize("name", ["MeanIoU", "GeneralizedDiceScore"])
def test_fused_plan_equals_eager_bitwise(name):
    """Both classes fuse in JAX and in the port (``fusion_ineligibility`` is
    ``None`` in both); the port's fused fold equals its eager fold bitwise,
    and JAX's fused fold."""
    kw = {"num_classes": C, "per_class": True, "input_format": "index"}
    jm, tm = _module_pair(name, kw)
    assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm) is None
    batches = [_inputs("index", seed=20 + s) for s in range(4)]
    eager = T.MetricCollection({"m": getattr(T, name)(device="cpu", **kw)})
    fused = T.MetricCollection({"m": getattr(T, name)(device="cpu", **kw)})
    jfused = J.MetricCollection({"m": getattr(J, name)(**kw)})
    for p, t in batches[:2]:
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
        jfused.update(p, t)
    fused.reset()
    jfused.reset()
    plan, jplan = fused.fused(), jfused.fused()
    for p, t in batches:
        eager.update(torch.from_numpy(p), torch.from_numpy(t))
        plan.update(torch.from_numpy(p), torch.from_numpy(t))
        jplan.update(jnp.asarray(p), jnp.asarray(t))
    plan.fold_back()
    jplan.fold_back()
    a, b = state_to_numpy(dict.__getitem__(eager, "m")), state_to_numpy(dict.__getitem__(fused, "m"))
    jt = {k: np.asarray(v) for k, v in dict.__getitem__(jfused, "m").state_tree().items()}
    for state in a:
        _bitwise(b[state], a[state], f"fused {state}")
        _bitwise(b[state], jt[state], f"fused {state} vs JAX")
    _bitwise(fused.compute()["m"], jfused.compute()["m"], "value")
