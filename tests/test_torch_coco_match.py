# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""K6's plain version (``ops.coco_match.coco_match_plain``, the CPU route of
``coco_match``) against the JAX package's ``_match_one_image``, vmapped
over images as its ``_match_and_accumulate`` runs it.

Both sides get the same IoU matrix (numpy, float32), so the matcher is held
bit for bit: it only compares and selects. The cases are seeded (IoUs
rounded to 0.05 so that ties are common, G and D not multiples of 32, more
than 32 ground truths) and adversarial: ties at the top, crowds matched
again, all-ignored and empty images, NaN IoUs (``jnp.max`` and
``jnp.argmax`` take a NaN as the largest value), thresholds at exactly 1.0
(pycocotools' bar ``min(t, 1 - 1e-10)`` is 1.0 in float32, so an IoU of 1.0
matches there), 0.0, -1.0 (the -1.0 sentinel of non-candidates then
matches) and NaN; candidate IoUs of -1.0, -2.0 and +-0, several NaNs a row,
rows whose candidates are every ground truth, and G around a word and
around the kernel's 128 ground truths in registers. The card test of the
kernel itself is in
``tests/test_torch_kernels_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.functional.detection.map import DEFAULT_AREA_RANGES, _match_one_image
from torchmetrics_tpu_torch.functional.detection.map import _match
from torchmetrics_tpu_torch.ops import coco_match, coco_match_plain
from torchmetrics_tpu_torch.ops.coco_match import match_bar

AREA_RNGS = np.asarray(list(DEFAULT_AREA_RANGES.values()), np.float32)
COCO_THRS = np.linspace(0.5, 0.95, 10).astype(np.float32)

_jax_match = jax.jit(jax.vmap(_match_one_image, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None)))


def _case(seed, n=5, d=37, g=45, classes=3, crowd=0.2, quantum=0.05, valid=0.85):
    """Seeded inputs of ``_match_one_image`` for ``n`` images as numpy arrays."""
    rng = np.random.default_rng(seed)
    iou = rng.random((n, d, g))
    if quantum:
        iou = np.round(iou / quantum) * quantum
    return {
        "iou": iou.astype(np.float32),
        "det_area": rng.uniform(0, 150**2, (n, d)).astype(np.float32),
        "det_labels": rng.integers(0, classes, (n, d)).astype(np.int32),
        "det_valid": rng.random((n, d)) < valid,
        "gt_labels": rng.integers(0, classes, (n, g)).astype(np.int32),
        "gt_valid": rng.random((n, g)) < valid,
        "gt_crowd": rng.random((n, g)) < crowd,
        "gt_area": rng.uniform(0, 150**2, (n, g)).astype(np.float32),
    }


ORDER = ("iou", "det_area", "det_labels", "det_valid", "gt_labels", "gt_valid", "gt_crowd", "gt_area")


def _both(case, thrs=COCO_THRS):
    """``(det_matched, det_ignored, gt_ignored)`` of JAX and of the port's CPU route, as numpy."""
    want = _jax_match(*(jnp.asarray(case[k]) for k in ORDER), jnp.asarray(thrs), jnp.asarray(AREA_RNGS))
    got = _match(*(torch.from_numpy(np.ascontiguousarray(case[k])) for k in ORDER), torch.from_numpy(thrs),
                 torch.from_numpy(AREA_RNGS))
    return [np.asarray(w) for w in want], [x.numpy() for x in got]


def _assert_same(case, thrs=COCO_THRS):
    want, got = _both(case, thrs)
    for name, w, x in zip(("det_matched", "det_ignored", "gt_ignored"), want, got):
        assert w.shape == x.shape and w.dtype == x.dtype == np.bool_, (name, w.shape, x.shape)
        np.testing.assert_array_equal(x, w, err_msg=name)
    return want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_cases_bitwise(seed):
    want = _assert_same(_case(seed))
    assert want[0].any() and want[1].any() and not want[0].all()  # the rules fired


def test_more_than_32_ground_truths_and_one_of_each():
    _assert_same(_case(5, n=3, d=70, g=100, classes=2, quantum=0.1))
    _assert_same(_case(6, n=2, d=1, g=1, classes=1, valid=1.0))


def test_ties_go_to_the_last_ground_truth():
    """Every IoU equal: the last regular ground truth wins each detection in turn."""
    case = _case(7, n=2, d=6, g=5, classes=1, crowd=0.0, valid=1.0)
    case["iou"][:] = 0.75
    want = _assert_same(case)
    assert want[0][:, 0, 0, :5].all() and not want[0][:, 0, 0, 5].any()  # 5 ground truths, 6 detections


def test_crowds_match_again_and_ignored_only_when_regular_fails():
    """A crowd ground truth takes every detection a regular one does not:
    stage 2 runs only when stage 1 fails, and a crowd stays matchable."""
    case = _case(8, n=1, d=6, g=3, classes=1, crowd=0.0, valid=1.0)
    case["gt_crowd"][:] = [False, True, True]
    case["iou"][0] = np.float32([[0.9, 0.95, 0.6]] * 6)
    want = _assert_same(case)
    matched, ignored = want[0][0, 0, 0], want[1][0, 0, 0]
    assert matched.all() and not ignored[0] and ignored[1:].all()


def test_all_ignored_and_empty_images():
    case = _case(9, n=4, d=12, g=9)
    case["gt_crowd"][0] = True  # every ground truth a crowd
    case["gt_valid"][1] = False  # no ground truth
    case["det_valid"][2] = False  # no detection
    case["gt_area"][3] = 1e11  # outside all four ranges, "all" (up to 1e10) too
    _assert_same(case)


def test_nan_iou_takes_jax_answer():
    """A NaN among the candidates is their max, so that stage fails even with
    a high IoU beside it; the last NaN is the argmax."""
    case = _case(10, n=3, d=20, g=11, classes=2)
    rng = np.random.default_rng(11)
    case["iou"][rng.random(case["iou"].shape) < 0.15] = np.nan
    want = _assert_same(case)
    one = _case(12, n=1, d=2, g=3, classes=1, crowd=0.0, valid=1.0)
    one["iou"][0] = np.float32([[0.9, np.nan, 0.2], [0.9, 0.3, 0.2]])
    want = _assert_same(one)
    assert not want[0][0, 0, 0, 0] and want[0][0, 0, 0, 1]  # the NaN blocks the first, not the second


@pytest.mark.parametrize("thrs", [[1.0, 0.5], [0.0, -1.0], [-2.0, np.nan, 0.95]], ids=["one", "zero-minus-one", "below-nan"])
def test_edge_thresholds(thrs):
    case = _case(13, n=3, d=10, g=7, classes=2)
    case["iou"][:, ::3] = 1.0
    thrs = np.asarray(thrs, np.float32)
    want = _assert_same(case, thrs)
    if thrs[0] == 1.0:
        assert want[0][:, :, 0].any()  # an IoU of exactly 1.0 matches at the threshold 1.0


@pytest.mark.parametrize("g", [32, 63, 64, 65, 127, 128, 129])
def test_ground_truth_counts_around_a_word_and_the_register_cap(g):
    """G at one word of 32 bits and around it, and around the kernel's 128 ground truths in registers."""
    want = _assert_same(_case(20 + g, n=2, d=11, g=g, classes=2, quantum=0.1))
    assert want[0].any()


EDGE_THRS = np.float32([-2.0, -1.5, -1.0, -0.0, 0.0, 0.5, 1.0, np.nan])


@pytest.mark.parametrize("values", [[-1.0, 0.5], [-2.0, -1.0, 0.3], [-0.0, 0.0], [np.nan, np.nan, 0.7, -1.0]],
                         ids=["minus-one", "minus-two", "signed-zeros", "nans"])
def test_special_candidate_values(values):
    """Candidate IoUs of exactly -1.0 (tied with every non-candidate's -1.0, so the later index wins), below
    it (a non-candidate then wins), -0.0 against +0.0 (equal: the later index wins) and several NaNs a row
    (the last NaN wins, and fails every threshold)."""
    case = _case(30, n=3, d=12, g=10, classes=1, crowd=0.1, valid=0.9)
    rng = np.random.default_rng(31)
    case["iou"] = np.asarray(values, np.float32)[rng.integers(0, len(values), case["iou"].shape)]
    want = _assert_same(case, EDGE_THRS)
    assert want[0].any() and not want[0].all()


def test_candidates_cover_the_row():
    """Every ground truth valid, of the detections' one class and unignored (area range "all", no crowd),
    IoUs at or below -1.0: at the first step stage 1's candidates are the whole row, so no -1.0 column
    outside them takes part, and a threshold of -2.0 matches the last of the largest IoUs."""
    case = _case(32, n=3, d=9, g=40, classes=1, crowd=0.0, valid=1.0)
    rng = np.random.default_rng(33)
    case["iou"] = np.float32([-1.0, -2.0, -1.5])[rng.integers(0, 3, case["iou"].shape)]
    want = _assert_same(case, EDGE_THRS)
    first = case["iou"][:, 0]
    assert want[0][:, 0, 0, 0].all() and want[0][:, 0, 2, 0].all() == bool((first == -1.0).any(-1).all())


def test_match_bar_is_jax_float32_minimum():
    thrs = np.asarray([0.5, 1.0, 1.5, np.nan, -1.0, np.float32(1 - 1e-10)], np.float32)
    got = match_bar(torch.from_numpy(thrs)).numpy()
    want = np.asarray(jnp.minimum(jnp.asarray(thrs), 1 - 1e-10))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrapper_takes_the_plain_route_on_cpu_and_checks_its_inputs():
    case = _case(14, n=2, d=9, g=4)
    args = [torch.from_numpy(case[k]) for k in ("iou", "det_labels", "det_valid", "gt_labels", "gt_valid", "gt_crowd")]
    gt_ig = torch.zeros((2, 4, 4), dtype=torch.bool)
    thrs = torch.from_numpy(COCO_THRS)
    before = coco_match.launches
    for x, y in zip(coco_match(*args, gt_ig, thrs), coco_match_plain(*args, gt_ig, thrs)):
        assert torch.equal(x, y)
    assert coco_match.launches == before  # the plain route is not counted
    with pytest.raises(ValueError, match="float32 IoU"):
        coco_match(args[0].double(), *args[1:], gt_ig, thrs)
    with pytest.raises(ValueError, match="det_labels"):
        coco_match(args[0], args[1].long(), *args[2:], gt_ig, thrs)
