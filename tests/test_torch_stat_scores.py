# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Parity of the port's stat scores (kernel K2's module) with the JAX package's.

The multiclass confusion-matrix branch runs in
:func:`~torchmetrics_tpu_torch.ops.stat_counts` (the argmax of the scores
fused in), whose plain PyTorch version runs on the CPU tensors used here. tp/fp/tn/fn must be bitwise
equal to JAX's and int32: macro and micro, with and without
``ignore_index``, argmax ties, NaN rows, out-of-range labels under
``validate_args=False``, and the one-hot (top_k > 1, samplewise) path.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.ops import stat_counts, stat_counts_plain

jss = importlib.import_module("torchmetrics_tpu.functional.classification.stat_scores")
tss = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")


def _both(fn_name, preds, target, *args, **kwargs):
    want = getattr(jss, fn_name)(jnp.asarray(preds), jnp.asarray(target), *args, **kwargs)
    got = getattr(tss, fn_name)(torch.from_numpy(np.array(preds)), torch.from_numpy(np.array(target)), *args, **kwargs)
    return got, want


def _assert_counts_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, g.dtype
        assert w.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)


def _probs(rng, n, c):
    p = rng.random((n, c)).astype(np.float32)
    return p / p.sum(1, keepdims=True)


@pytest.mark.parametrize("average", ["macro", "micro", "weighted", None])
@pytest.mark.parametrize("ignore_index", [None, 2, -1])
def test_multiclass_update_bitwise(average, ignore_index):
    rng = np.random.default_rng(21)
    n, c = 1024, 7
    p = _probs(rng, n, c)
    t = rng.integers(0, c, n).astype(np.int32)
    if ignore_index is not None:
        t[rng.random(n) < 0.1] = ignore_index
    jp, jt = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t))
    tp_, tt = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    want = jss._multiclass_stat_scores_update(jp, jt, c, 1, average, "global", ignore_index)
    got = tss._multiclass_stat_scores_update(tp_, tt, c, 1, average, "global", ignore_index)
    _assert_counts_equal(got, want)


def test_argmax_ties_take_the_first_maximum():
    p = np.array([[0.4, 0.4, 0.2], [0.1, 0.45, 0.45], [1 / 3, 1 / 3, 1 / 3], [0.0, 0.0, 0.0]], np.float32)
    t = np.array([1, 2, 0, 2], np.int32)
    jp, _ = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t))
    tp_, _ = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t))
    assert tp_.reshape(-1).tolist() == [0, 1, 0, 0] == np.asarray(jp).reshape(-1).tolist()
    got, want = _both("multiclass_stat_scores", p, t, 3, average=None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nan_rows_argmax_like_jax():
    """``jnp.argmax`` and ``torch.argmax`` both pick a NaN's index; the counts agree."""
    rng = np.random.default_rng(22)
    p = _probs(rng, 64, 4)
    p[3, 2] = np.nan
    p[10, :] = np.nan
    t = rng.integers(0, 4, 64).astype(np.int32)
    jp, jt = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t))
    tp_, tt = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))
    _assert_counts_equal(
        tss._multiclass_stat_scores_update(tp_, tt, 4), jss._multiclass_stat_scores_update(jp, jt, 4)
    )


@pytest.mark.parametrize("ignore_index", [None, 1, 9])
def test_confusion_hist_out_of_range_labels(ignore_index):
    """``validate_args=False`` lets labels outside [0, C) through: jnp.bincount semantics hold."""
    rng = np.random.default_rng(23)
    c = 5
    preds = rng.integers(-3, c + 3, 512).astype(np.int32)
    target = rng.integers(-2, c + 2, 512).astype(np.int32)
    if ignore_index is not None:
        target[::7] = ignore_index
    want = jss._multiclass_stat_scores_update(jnp.asarray(preds), jnp.asarray(target), c, ignore_index=ignore_index)
    got = tss._multiclass_stat_scores_update(torch.from_numpy(preds), torch.from_numpy(target), c, ignore_index=ignore_index)
    _assert_counts_equal(got, want)


def test_confusion_hist_int64_labels_and_launch_count():
    rng = np.random.default_rng(24)
    preds = torch.from_numpy(rng.integers(0, 6, 300))
    target = torch.from_numpy(rng.integers(0, 6, 300))
    before = stat_counts.launches
    counts = stat_counts(preds, target, 6)
    assert stat_counts.launches == before  # the CPU path is the plain version: no launch
    assert counts.dtype == torch.int32 and counts.shape == (4, 6)
    np.testing.assert_array_equal(counts.numpy(), stat_counts_plain(preds, target, 6).numpy())
    cm = np.histogram2d(target.numpy(), preds.numpy(), bins=6, range=[[0, 6], [0, 6]])[0].astype(np.int64)
    tp = np.diag(cm)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    np.testing.assert_array_equal(counts.numpy(), np.stack([tp, fp, 300 - (fp + fn + tp), fn]))


@pytest.mark.parametrize("ignore_index", [None, 2])
def test_confusion_hist_empty_batch_is_zero_and_counts_no_launch(ignore_index):
    before = stat_counts.launches
    empty = torch.zeros(0, dtype=torch.int32)
    counts = stat_counts(empty, empty, 5, ignore_index)
    assert counts.shape == (4, 5) and counts.dtype == torch.int32 and int(counts.abs().sum()) == 0
    scores = stat_counts(torch.zeros(0, 5), empty, 5, ignore_index)
    assert scores.shape == (4, 5) and int(scores.abs().sum()) == 0
    assert stat_counts.launches == before


def _hard_scores(rng, n, c):
    """Probabilities with the rows ``jnp.argmax`` rules on: ties, NaN, all -inf, +-0, +inf."""
    p = _probs(rng, n, c)
    p[0, :] = 0.5  # all tied: the first index
    p[1, :] = np.nan  # all NaN: 0
    p[2, :] = -np.inf  # all -inf: 0
    p[3, :] = 0.0
    p[3, ::2] = -0.0  # -0 and 0 tie
    p[4, c - 1] = np.nan  # one NaN wins over larger numbers
    p[5, 1:] = np.inf
    p[5, c - 1] = np.nan  # NaN beats +inf
    p[6, :] = 0.1
    p[6, c // 2 :] = 0.9  # tied maxima: the first of them
    p[7, :] = [np.nan if i % 2 else 1.0 for i in range(c)]  # the first NaN
    return p


@pytest.mark.parametrize("average", ["macro", "weighted", None])
@pytest.mark.parametrize("ignore_index", [None, 2, -1, 9])
@pytest.mark.parametrize("c", [3, 7, 8])
def test_fused_scores_update_bitwise(c, ignore_index, average):
    """K2's plain version on float scores (the format keeps them) against
    JAX's format + update: argmax edge rows, ignore_index in and out of the
    classes, out-of-range targets as ``validate_args=False`` lets through,
    C a multiple of 4 or not."""
    rng = np.random.default_rng(29 + c)
    n = 300
    p = _hard_scores(rng, n, c)
    t = rng.integers(-2, c + 2, n).astype(np.int32)
    if ignore_index is not None:
        t[rng.random(n) < 0.1] = ignore_index
    jp, jt = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t))
    want = jss._multiclass_stat_scores_update(jp, jt, c, 1, average, "global", ignore_index)
    tp_, tt = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t), 1, average, "global")
    assert tp_.shape == (n, c) and tp_.dtype == torch.float32 and tt.shape == (n,)  # the scores reach K2
    got = tss._multiclass_stat_scores_update(tp_, tt, c, 1, average, "global", ignore_index)
    _assert_counts_equal(got, want)
    _assert_counts_equal(tuple(stat_counts_plain(tp_, tt, c, ignore_index)), want)


def test_fused_scores_with_extra_dims_bitwise():
    """(N, C, X) scores: the format moves the classes last, so K2 sees (N*X, C)."""
    rng = np.random.default_rng(33)
    n, c, extra = 40, 5, 3
    p = rng.random((n, c, extra)).astype(np.float32)
    t = rng.integers(0, c, (n, extra)).astype(np.int32)
    jp, jt = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t))
    want = jss._multiclass_stat_scores_update(jp, jt, c)
    tp_, tt = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t), 1, "macro")
    assert tp_.shape == (n * extra, c)
    _assert_counts_equal(tss._multiclass_stat_scores_update(tp_, tt, c), want)


@pytest.mark.parametrize("scores", [True, False], ids=["scores", "labels"])
def test_stat_counts_int64_labels_are_cut_to_int32(scores):
    """int64 labels are read as ``static_cast<int>`` reads them, as ``astype(jnp.int32)`` cuts them."""
    rng = np.random.default_rng(34)
    n, c = 128, 6
    preds = torch.from_numpy(_probs(rng, n, c)) if scores else torch.from_numpy(rng.integers(0, c, n))
    small = rng.integers(-1, c + 1, n)
    wide = small + rng.choice([-(2**32), 2**32, 3 * 2**32], n)  # the same low 32 bits
    if not scores:
        preds = preds + torch.from_numpy(rng.choice([0, 2**32], n))
    for ignore_index in (None, 3):
        got = stat_counts_plain(preds, torch.from_numpy(wide), c, ignore_index)
        want = stat_counts_plain(preds.to(torch.int32) if not scores else preds, torch.from_numpy(small), c, ignore_index)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("top_k,multidim_average", [(2, "global"), (1, "samplewise"), (3, "samplewise")])
@pytest.mark.parametrize("ignore_index", [None, 0])
def test_one_hot_path_bitwise(top_k, multidim_average, ignore_index):
    rng = np.random.default_rng(25)
    n, c, extra = 32, 5, 3
    p = rng.random((n, c, extra)).astype(np.float32)
    t = rng.integers(0, c, (n, extra)).astype(np.int32)
    if ignore_index is not None:
        t[::5, 1] = ignore_index
    jp, jt = jss._multiclass_stat_scores_format(jnp.asarray(p), jnp.asarray(t), top_k)
    tp_, tt = tss._multiclass_stat_scores_format(torch.from_numpy(p), torch.from_numpy(t), top_k)
    want = jss._multiclass_stat_scores_update(jp, jt, c, top_k, "macro", multidim_average, ignore_index)
    got = tss._multiclass_stat_scores_update(tp_, tt, c, top_k, "macro", multidim_average, ignore_index)
    _assert_counts_equal(got, want)


@pytest.mark.parametrize("average", ["macro", "micro", "weighted", None])
def test_multiclass_stat_scores_compute(average):
    rng = np.random.default_rng(26)
    p = _probs(rng, 200, 4)
    t = rng.integers(0, 4, 200).astype(np.int32)
    got, want = _both("multiclass_stat_scores", p, t, 4, average=average)
    want = np.asarray(want)
    if want.dtype == np.int32:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # a float32 mean/weighted sum over 4 classes: rtol 1e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_binary_stat_scores_bitwise(ignore_index, multidim_average):
    rng = np.random.default_rng(27)
    p = rng.random((40, 6)).astype(np.float32)
    t = rng.integers(0, 2, (40, 6)).astype(np.int32)
    if ignore_index is not None:
        t[::3, 2] = ignore_index
    got, want = _both("binary_stat_scores", p, t, 0.5, multidim_average, ignore_index)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binary_logits_go_through_sigmoid():
    rng = np.random.default_rng(28)
    logits = (rng.standard_normal(300) * 3).astype(np.float32)
    t = rng.integers(0, 2, 300).astype(np.int32)
    got, want = _both("binary_stat_scores", logits, t)
    # sigmoid ulps could flip a value sitting on the 0.5 threshold; none does
    # at this seed, so the counts are held bitwise
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_validation_refuses_out_of_range_target():
    with pytest.raises(RuntimeError, match="outside the expected range"):
        tss.multiclass_stat_scores(torch.rand(8, 3), torch.tensor([0, 1, 3, 3, 0, 1, 0, 0]), 3)
