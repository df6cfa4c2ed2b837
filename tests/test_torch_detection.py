# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""Detection of the port (the box helpers, the IoU family, COCO mAP and
panoptic quality, functions and classes) against the JAX package's, on the
same seeded numpy inputs on the CPU, and against JAX's golden fixtures and
numpy COCO oracle.

What is bitwise and what has a budget, and why:

- box conversion and areas, ``box_iou``, GIoU and DIoU are elementwise
  float32 ops in the same order (eager ``jnp`` runs op by op): bitwise.
  CIoU's ``atan`` is another implementation: ``CIOU_ATOL``.
- the mAP's batched IoU: JAX's is one jitted program, and XLA's CPU backend
  contracts ``area_d + area_g - inter`` (``area_d`` a product) into an FMA,
  so it can sit a few ulps from the port's (``IOU_ULPS``). The matcher is
  therefore held bitwise on one IoU matrix (``tests/test_torch_coco_match.py``),
  and an IoU a few ulps from a bar flips a match: shown below with a
  threshold set at such an IoU, not reseeded around.
- given equal matches the precision, recall and score tables are bitwise
  (integer counts and slots, float32 divisions, maxes and selections); the
  summary means add up to T x R x K float32 cells in another order:
  ``SUMMARY_ATOL``.
- the IoU classes' means sum in float64 on the port, float32 in numpy on
  JAX: ``MEAN_RTOL``. Their states are the matrices, bitwise (CIoU: budget).
- panoptic quality's states are the same host numpy counts: bitwise; its
  values too (float32 ops, the class means in XLA's order).
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as J
import torchmetrics_tpu.functional as JFA
import torchmetrics_tpu.functional.detection as JF
import torchmetrics_tpu_torch as T
import torchmetrics_tpu_torch.functional as TFA
import torchmetrics_tpu_torch.functional.detection as TF
from tests.unittests.detection._coco_oracle import coco_eval_oracle
from tests.unittests.detection.test_map import _boxes_to_masks, _make_dataset, _mixed_dataset
from tests.unittests.detection.test_map_adversarial import CASES, FIXTURE_PATH
from torchmetrics_tpu.functional.detection import helpers as JH
from torchmetrics_tpu.functional.detection import map as JMAP
from torchmetrics_tpu.parallel.fused import fusion_ineligibility as j_fusion_ineligibility
from torchmetrics_tpu_torch.functional.detection import helpers as TH
from torchmetrics_tpu_torch.functional.detection import map as TMAP
from torchmetrics_tpu_torch.interop import state_from_numpy, state_to_numpy
from torchmetrics_tpu_torch.parallel.fused import fusion_ineligibility
from torchmetrics_tpu_torch.utilities.distributed import gather_all_tensors

CIOU_ATOL = 1e-6
IOU_ULPS = 8
SUMMARY_ATOL = 1e-6
MEAN_RTOL = 1e-6
KEYS = ["map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100",
        "mar_small", "mar_medium", "mar_large"]
TABLES = ("precision", "recall", "scores")
CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
           "CompleteIntersectionOverUnion", "MeanAveragePrecision", "PanopticQuality", "ModifiedPanopticQuality"]


def _np(x):
    return np.ascontiguousarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


def _bitwise(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(want).view(np.uint8), err_msg=what)


def _close(got, want, atol=0.0, rtol=0.0, what=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as err:  # noqa: BLE001 - the type and message are what is compared
        return type(err).__name__, str(err)
    return None


def _tensor_items(items):
    """The same per-image dicts with CPU tensors in place of numpy arrays (lists of RLEs stay)."""
    return [{k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v for k, v in it.items()} for it in items]


def _same_map(got, want, what=""):
    """mAP results: every key, the tables bitwise, the summaries within SUMMARY_ATOL."""
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        if key.split("_", 1)[-1] in TABLES or key in TABLES or key.endswith("classes"):
            _bitwise(got[key], w, f"{what} {key}")
        else:
            _close(got[key], w, atol=SUMMARY_ATOL, what=f"{what} {key}")


def _boxes(seed, n, size=400.0):
    rng = np.random.default_rng(seed)
    xy = rng.random((n, 2)) * size
    return np.concatenate([xy, xy + rng.random((n, 2)) * size / 3 + 1.0], 1).astype(np.float32)


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("fmt", ["xywh", "cxcywh"])
def test_box_convert_and_area_bitwise(fmt):
    boxes = _boxes(0, 37)
    for a, b in ((fmt, "xyxy"), ("xyxy", fmt), (fmt, fmt)):
        _bitwise(TH.box_convert(_t(boxes), a, b), JH.box_convert(boxes, a, b), f"{a}->{b}")
    _bitwise(TH.box_area(_t(boxes)), JH.box_area(boxes), "area")
    assert _raised(TH.box_convert, _t(boxes), "xyxy", "ltrb") == _raised(JH.box_convert, boxes, "xyxy", "ltrb")


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou"])
def test_pairwise_matrices(name):
    p, g = _boxes(1, 19), _boxes(2, 23)
    p[:10] = g[:10] + np.random.default_rng(3).normal(0, 5, (10, 4)).astype(np.float32)
    got, want = getattr(TH, name)(_t(p), _t(g)), getattr(JH, name)(p, g)
    if name == "complete_box_iou":
        _close(got, want, atol=CIOU_ATOL, what=name)
    else:
        _bitwise(got, want, name)
    if name == "box_iou":
        crowd = np.random.default_rng(4).random(23) < 0.3
        _bitwise(TH.box_iou(_t(p), _t(g), _t(crowd)), JH.box_iou(p, g, iscrowd=crowd), "crowd")


def test_validators_raise_as_jax():
    ok_p = {"boxes": np.zeros((2, 4)), "labels": np.zeros(2), "scores": np.zeros(2)}
    ok_t = {"boxes": np.zeros((2, 4)), "labels": np.zeros(2)}
    cases = [
        ([ok_p], [ok_t], "bbox", False), ([ok_p], [ok_t], "keypoints", False), (ok_p, [ok_t], "bbox", False),
        ([ok_p], [ok_t, ok_t], "bbox", False), ([{"boxes": ok_p["boxes"]}], [ok_t], "bbox", False),
        ([ok_p], [{**ok_t, "labels": np.zeros(3)}], "bbox", False),
        ([{**ok_p, "scores": np.zeros(1)}], [ok_t], "bbox", False),
        ([{"boxes": ok_p["boxes"], "labels": np.zeros(2)}], [ok_t], "bbox", True),
        ([ok_p], [ok_t], ("bbox", "segm"), False),
    ]
    for preds, target, iou_type, ignore in cases:
        want = _raised(JH._input_validator, preds, target, iou_type=iou_type, ignore_score=ignore)
        assert _raised(TH._input_validator, preds, target, iou_type=iou_type, ignore_score=ignore) == want
        assert _raised(TH._input_validator, _tensor_items(preds) if isinstance(preds, list) else preds,
                       _tensor_items(target), iou_type=iou_type, ignore_score=ignore) == want
    for arg in ("bbox", ("segm", "bbox"), "keypoints", ("bbox", "mask")):
        assert _raised(TH._validate_iou_type_arg, arg) == _raised(JH._validate_iou_type_arg, arg)


# ---------------------------------------------------------------- IoU family


IOU_FUNCS = ["intersection_over_union", "generalized_intersection_over_union", "distance_intersection_over_union",
             "complete_intersection_over_union"]


@pytest.mark.parametrize("name", IOU_FUNCS)
def test_iou_functions(name):
    p, g = _boxes(5, 12), _boxes(6, 12)
    p[:8] = g[:8] + np.random.default_rng(7).normal(0, 4, (8, 4)).astype(np.float32)
    budget = CIOU_ATOL if name.startswith("complete") else 0.0
    for kw in ({}, {"aggregate": False}, {"iou_threshold": 0.5, "replacement_val": -3}, {"iou_threshold": 0.4, "aggregate": False}):
        _close(getattr(TF, name)(_t(p), _t(g), **kw), getattr(JF, name)(p, g, **kw), atol=budget, what=f"{name} {kw}")
        assert getattr(TFA, name) is getattr(TF, name)
    _close(getattr(TF, name)(_t(p[:0]), _t(g[:0])), getattr(JF, name)(p[:0], g[:0]), what="empty")
    assert _raised(getattr(TF, name), _t(p[:, :3]), _t(g)) == _raised(getattr(JF, name), p[:, :3], g)


def _iou_stream(seed, n_imgs=5):
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for i in range(n_imgs):
        n_d, n_g = int(rng.integers(0, 7)), int(rng.integers(0, 6)) if i else 0
        g = _boxes(seed * 10 + i, n_g)
        d = _boxes(seed * 10 + i + 5, n_d)
        d[: min(n_d, n_g)] = g[: min(n_d, n_g)] + rng.normal(0, 6, (min(n_d, n_g), 4)).astype(np.float32)
        preds.append({"boxes": d.astype(np.float64), "labels": rng.integers(0, 3, n_d), "scores": rng.random(n_d)})
        target.append({"boxes": g.astype(np.float64), "labels": rng.integers(0, 3, n_g)})
    return preds, target


@pytest.mark.parametrize("cls", CLASSES[:4])
@pytest.mark.parametrize("kw", [{}, {"class_metrics": True, "iou_threshold": 0.3}, {"respect_labels": False, "box_format": "xywh"}],
                         ids=["default", "classes-threshold", "unlabelled-xywh"])
def test_iou_classes_states_values_and_checkpoints(cls, kw):
    jm, tm = getattr(J, cls)(**kw), getattr(T, cls)(device="cpu", **kw)
    preds, target = _iou_stream(8)
    for i in range(0, 5, 2):
        jm.update(preds[i:i + 2], target[i:i + 2])
        tm.update(_tensor_items(preds[i:i + 2]), _tensor_items(target[i:i + 2]))
    budget = CIOU_ATOL if cls.startswith("Complete") else 0.0
    jtree, ttree = jm.state_tree(), state_to_numpy(tm)
    for key in jtree:
        assert len(jtree[key]) == len(ttree[key]) == 5
        for a, b in zip(ttree[key], jtree[key]):
            _close(a, b, atol=budget, what=key)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    got = tm.compute()
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], atol=budget, rtol=MEAN_RTOL, what=key)
    fresh = getattr(T, cls)(device="cpu", **kw)
    state_from_numpy(fresh, dict(jm.state_tree(include_count=True)), fingerprint=jm.state_spec()["fingerprint"])
    for key, val in fresh.compute().items():
        _close(val, want[key], atol=budget, rtol=MEAN_RTOL, what=f"JAX tree into the port: {key}")


# ---------------------------------------------------------------- mAP


def _map_both(preds, target, **kw):
    want = JMAP.coco_mean_average_precision(preds, target, **kw)
    got = TMAP.coco_mean_average_precision(_tensor_items(preds), _tensor_items(target), device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("seed,kw", [
    (0, {"extended_summary": True, "class_metrics": True}),
    (1, {"extended_summary": True, "box_format": "cxcywh"}),
    (2, {"average": "micro", "extended_summary": True}),
    (3, {"iou_thresholds": [0.5, 0.75, 0.9], "rec_thresholds": [0.0, 0.3, 0.6, 0.95], "max_detection_thresholds": [2, 5, 50],
         "extended_summary": True, "class_metrics": True}),
], ids=["classes", "cxcywh", "micro", "custom-grids"])
def test_map_functional_tables_bitwise(seed, kw):
    preds, target = _make_dataset(np.random.RandomState(seed), n_imgs=7, crowd_frac=0.2)
    got, want = _map_both(preds, target, **kw)
    _same_map(got, want, str(kw))
    assert got["precision"].device.type == "cpu"
    if seed == 0:
        oracle = coco_eval_oracle(preds, target)
        for key in KEYS:
            assert abs(float(got[key]) - oracle[key]) < 1e-6, key


def test_map_functional_with_numpy_inputs_needs_a_device():
    preds, target = _make_dataset(np.random.RandomState(0), n_imgs=7, crowd_frac=0.2)
    got = TMAP.coco_mean_average_precision(preds, target, device="cpu", extended_summary=True, class_metrics=True)
    want = TMAP.coco_mean_average_precision(_tensor_items(preds), _tensor_items(target), extended_summary=True,
                                            class_metrics=True)
    for key in want:
        _bitwise(got[key], want[key], key)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TMAP.coco_mean_average_precision(preds, target)


@pytest.mark.parametrize("name", sorted(CASES))
def test_map_adversarial_cases_against_the_oracle(name):
    """JAX's adversarial cases (ties, exact-threshold IoUs, max-det cuts,
    crowd and area interplay, empty mixes) against its numpy oracle."""
    preds, target, kwargs = CASES[name]()
    got = TMAP.coco_mean_average_precision(_tensor_items(preds), _tensor_items(target), **kwargs)
    oracle = coco_eval_oracle(preds, target, max_dets=kwargs.get("max_detection_thresholds", (1, 10, 100)))
    keys = [k for k in KEYS if k in oracle] if kwargs.get("max_detection_thresholds") else KEYS
    for key in keys:
        assert abs(float(got[key]) - oracle[key]) < 1e-6, (name, key, float(got[key]), oracle[key])


def test_map_golden_fixtures():
    with open(FIXTURE_PATH) as fh:
        fixtures = json.load(fh)
    for case in fixtures["cases"]:
        preds = [{k: np.asarray(v, np.float64 if k != "labels" else np.int64) for k, v in p.items()} for p in case["preds"]]
        target = [{k: np.asarray(v, np.int64 if k in ("labels", "iscrowd") else np.float64) for k, v in t.items()}
                  for t in case["target"]]
        got = TMAP.coco_mean_average_precision(preds, target, device="cpu")
        for key, expected in case["expected"].items():
            assert abs(float(got[key]) - expected) < 1e-6, (case["name"], key, float(got[key]), expected)
    for case in fixtures["mixed_cases"]:
        def rles(ms):
            return [{"size": m["size"], "counts": np.asarray(m["counts"], np.uint32)} for m in ms]
        preds = [{"boxes": np.asarray(p["boxes"], np.float64).reshape(-1, 4), "masks": rles(p["masks"]),
                  "scores": np.asarray(p["scores"]), "labels": np.asarray(p["labels"])} for p in case["preds"]]
        target = [{"boxes": np.asarray(t["boxes"], np.float64).reshape(-1, 4), "masks": rles(t["masks"]),
                   "labels": np.asarray(t["labels"]), "iscrowd": np.asarray(t["iscrowd"])} for t in case["target"]]
        metric = T.MeanAveragePrecision(iou_type=tuple(case["iou_type"]), device="cpu")
        metric.update(preds, target)
        res = metric.compute()
        for key, expected in case["expected"].items():
            assert abs(float(res[key]) - expected) < 1e-6, (case["name"], key, float(res[key]), expected)


def test_batched_iou_within_ulps_and_a_flip_at_a_threshold(monkeypatch):
    """At the evaluation's packed shape the port's box IoU is within
    IOU_ULPS of JAX's jitted one (the FMA). A threshold set exactly at an
    IoU where the two differ flips that match, and the tables differ; the
    same evaluation on JAX's IoU matrix gives JAX's tables bit for bit."""
    rng = np.random.default_rng(21)
    n, d, g = 16, 24, 12
    gt = np.stack([_boxes(100 + i, g) for i in range(n)])
    det = np.concatenate([gt + rng.normal(0, 6, gt.shape).astype(np.float32),
                          np.stack([_boxes(200 + i, d - g) for i in range(n)])], 1)
    scores = np.linspace(0.99, 0.5, d)  # descending: the packed order is the input order
    preds = [{"boxes": det[i].astype(np.float64), "scores": scores, "labels": np.zeros(d, np.int64)} for i in range(n)]
    target = [{"boxes": gt[i].astype(np.float64), "labels": np.zeros(g, np.int64)} for i in range(n)]
    det_p = TMAP._pack_ragged([p["boxes"] for p in preds], 24, 4)[0]
    gt_p = TMAP._pack_ragged([t["boxes"] for t in target], 16, 4)[0]
    crowd = np.zeros((n, 16), bool)
    ji = np.asarray(JMAP._bbox_iou_and_area(jnp.asarray(det_p), jnp.asarray(gt_p), jnp.asarray(crowd))[0])
    ti = TMAP._bbox_iou_and_area(_t(det_p), _t(gt_p), _t(crowd))[0].numpy()
    ulps = np.abs(ji.view(np.int32).astype(np.int64) - ti.view(np.int32))
    assert ulps.max() <= IOU_ULPS
    i, p, q = np.argwhere((ulps > 0) & (ji > 0.5))[0]
    kw = {"iou_thresholds": [float(max(ji[i, p, q], ti[i, p, q]))], "extended_summary": True}
    got, want = _map_both(preds, target, **kw)
    assert not all(torch.equal(got[k], torch.from_numpy(np.array(want[k]))) for k in TABLES)  # the flip shows
    monkeypatch.setattr(TMAP, "_bbox_iou_and_area", lambda dd, gg, cc: (torch.from_numpy(ji.copy()), TMAP.box_area(dd)))
    _same_map(TMAP.coco_mean_average_precision(_tensor_items(preds), _tensor_items(target), **kw), want, "JAX's IoU")


def test_segm_functional_and_mask_paths():
    preds_b, target_b = _make_dataset(np.random.RandomState(5), n_imgs=4, crowd_frac=0.2)
    preds, target = [], []
    for p, t in zip(preds_b, target_b):
        preds.append({"masks": _boxes_to_masks(np.clip(p["boxes"], 0, 119)), "scores": p["scores"], "labels": p["labels"]})
        target.append({"masks": _boxes_to_masks(np.clip(t["boxes"], 0, 119)), "labels": t["labels"], "iscrowd": t["iscrowd"]})
    got, want = _map_both(preds, target, iou_type="segm", extended_summary=True)
    _same_map(got, want, "segm")


@pytest.mark.parametrize("mode", ["bbox", "segm", "mixed"])
def test_map_class_streams_and_checkpoints(mode):
    iou_type = ("bbox", "segm") if mode == "mixed" else mode
    preds, target = _mixed_dataset(seed=23)
    strip = lambda items: [{k: v for k, v in it.items() if k != "_mrects"} for it in items]  # noqa: E731
    preds, target = strip(preds), strip(target)
    for t in target[::2]:
        t["area"] = np.where(np.arange(len(t["labels"])) % 2, 0.0, 500.0)  # user areas where positive
    kw = {"iou_type": iou_type, "class_metrics": True, "extended_summary": True}
    jm, tm = J.MeanAveragePrecision(**kw), T.MeanAveragePrecision(device="cpu", **kw)
    for i in range(0, len(preds), 2):
        jm.update(preds[i:i + 2], target[i:i + 2])
        tm.update(_tensor_items(preds[i:i + 2]), _tensor_items(target[i:i + 2]))
    want = jm.compute()
    _same_map(tm.compute(), want, mode)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    if mode != "bbox":
        for a, b in zip(tm.detection_mask, jm.detection_mask):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x["counts"], y["counts"])
        return
    jtree, ttree = jm.state_tree(include_count=True), state_to_numpy(tm, include_count=True)
    for key in jtree:
        if key != "_update_count":
            for a, b in zip(ttree[key], jtree[key]):
                _bitwise(a, b, key)
    fresh = T.MeanAveragePrecision(device="cpu", **kw)
    state_from_numpy(fresh, dict(jtree), fingerprint=jm.state_spec()["fingerprint"])
    _same_map(fresh.compute(), want, "JAX tree into the port")
    jfresh = J.MeanAveragePrecision(**kw)
    jfresh.load_state_tree({k: v if k == "_update_count" else [jnp.asarray(x) for x in v] for k, v in ttree.items()})
    _same_map(tm.compute(), jfresh.compute(), "port tree into JAX")


def test_map_sync_dist_keeps_masks_beside_their_rows():
    preds, target = _mixed_dataset(seed=23)
    strip = lambda items: [{k: v for k, v in it.items() if k != "_mrects"} for it in items]  # noqa: E731
    one = T.MeanAveragePrecision(iou_type=("bbox", "segm"), device="cpu")
    one.update(strip(preds), strip(target))
    two = T.MeanAveragePrecision(iou_type=("bbox", "segm"), sync_on_compute=False, device="cpu")
    two.update(strip(preds[:2]), strip(target[:2]))
    two.update(strip(preds[2:]), strip(target[2:]))
    two._sync_dist(gather_all_tensors)
    assert len(two.detection_box) == len(two.detection_mask) == len(preds)
    res_one, res_two = one.compute(), two.compute()
    for key in res_one:
        _bitwise(res_two[key], res_one[key], key)


def test_coco_json_both_ways(tmp_path):
    preds, target = _make_dataset(np.random.RandomState(8), n_imgs=4, crowd_frac=0.2)
    tm = T.MeanAveragePrecision(box_format="xywh", device="cpu")
    jm = J.MeanAveragePrecision(box_format="xywh")
    tm.update(_tensor_items(preds), _tensor_items(target))
    jm.update(preds, target)
    tm.tm_to_coco(str(tmp_path / "port"))
    jm.tm_to_coco(str(tmp_path / "jax"))
    for part in ("preds", "target"):
        assert json.loads((tmp_path / f"port_{part}.json").read_text()) == json.loads((tmp_path / f"jax_{part}.json").read_text())
    got = T.MeanAveragePrecision.coco_to_tm(str(tmp_path / "jax_preds.json"), str(tmp_path / "jax_target.json"))
    want = J.MeanAveragePrecision.coco_to_tm(str(tmp_path / "jax_preds.json"), str(tmp_path / "jax_target.json"))
    for g_items, w_items in zip(got, want):
        for g, w in zip(g_items, w_items):
            assert sorted(g) == sorted(w)
            for k in w:
                _bitwise(g[k], w[k], k)
    masks = _boxes_to_masks(np.array([[10, 10, 50, 50], [60, 60, 110, 110]]))
    sm = T.MeanAveragePrecision(iou_type="segm", device="cpu")
    sm.update([{"masks": masks, "scores": np.array([0.9, 0.8]), "labels": np.array([0, 1])}],
              [{"masks": _t(masks), "labels": np.array([0, 1])}])
    sm.tm_to_coco(str(tmp_path / "segm"))
    p, t = J.MeanAveragePrecision.coco_to_tm(str(tmp_path / "segm_preds.json"), str(tmp_path / "segm_target.json"), iou_type="segm")
    jsm = J.MeanAveragePrecision(iou_type="segm")
    jsm.update(p, t)
    assert float(jsm.compute()["map"]) == float(sm.compute()["map"]) == 1.0


def test_map_arguments_and_empty_inputs_as_jax():
    for kw in ({"box_format": "bad"}, {"iou_type": "keypoints"}, {"iou_type": ("bbox", "bbox")}, {"iou_thresholds": 0.5},
               {"rec_thresholds": (0.1,)}, {"max_detection_thresholds": [1, 10]}, {"max_detection_thresholds": 5},
               {"class_metrics": 1}, {"extended_summary": "yes"}, {"average": "weighted"}):
        assert _raised(T.MeanAveragePrecision, device="cpu", **kw) == _raised(J.MeanAveragePrecision, **kw), kw
    preds = [{"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "labels": np.zeros(0, np.int64)}]
    target = [{"boxes": np.zeros((0, 4)), "labels": np.zeros(0, np.int64)}]
    got, want = _map_both(preds, target, extended_summary=True)
    _same_map(got, want, "empty")
    got, want = _map_both([], [], class_metrics=True)
    _same_map(got, want, "no images")
    assert _raised(TMAP.coco_mean_average_precision, [], [], iou_type="x", device="cpu") == _raised(
        JMAP.coco_mean_average_precision, [], [], iou_type="x")


# ---------------------------------------------------------------- panoptic quality


def _panoptic(seed, batch=3, h=12, w=10):
    """Seeded (B, H, W, 2) maps over things {0, 1, 2} and stuffs {6, 7}, with unknown (9) pixels in preds."""
    rng = np.random.default_rng(seed)
    cats = np.array([0, 1, 2, 6, 7])
    target = np.stack([rng.choice(cats, (batch, h, w)), rng.integers(0, 3, (batch, h, w))], -1)
    preds = target.copy()
    flip = rng.random((batch, h, w)) < 0.3
    preds[..., 0] = np.where(flip, rng.choice(np.append(cats, 9), (batch, h, w)), preds[..., 0])
    preds[..., 1] = np.where(rng.random((batch, h, w)) < 0.2, rng.integers(0, 3, (batch, h, w)), preds[..., 1])
    return preds, target


@pytest.mark.parametrize("name", ["panoptic_quality", "modified_panoptic_quality"])
def test_panoptic_functions(name):
    preds, target = _panoptic(30)
    for kw in ({}, {"return_sq_and_rq": True}, {"return_per_class": True}, {"return_per_class": True, "return_sq_and_rq": True}):
        got = getattr(TF, name)(_t(preds), _t(target), things={0, 1, 2}, stuffs={6, 7}, allow_unknown_preds_category=True, **kw)
        want = getattr(JF, name)(preds, target, things={0, 1, 2}, stuffs={6, 7}, allow_unknown_preds_category=True, **kw)
        _bitwise(got, want, f"{name} {kw}")
        assert getattr(TFA, name) is getattr(TF, name)
    for bad in ({"things": {0, 1}, "stuffs": {1}}, {"things": {"a"}, "stuffs": {1}}, {"things": set(), "stuffs": set()},
                {"things": {0, 1, 2}, "stuffs": {6, 7}}):
        assert _raised(getattr(TF, name), _t(preds), _t(target), **bad) == _raised(getattr(JF, name), preds, target, **bad)
    assert _raised(getattr(TF, name), _t(preds[:, :3]), _t(target), {0}, {6}) == _raised(getattr(JF, name), preds[:, :3], target, {0}, {6})


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_classes_states_values_and_checkpoints(cls):
    kw = {"things": {0, 1, 2}, "stuffs": {6, 7}, "allow_unknown_preds_category": True, "return_sq_and_rq": True}
    jm, tm = getattr(J, cls)(**kw), getattr(T, cls)(device="cpu", **kw)
    for seed in (31, 32, 33):
        preds, target = _panoptic(seed)
        jm.update(preds, target)
        tm.update(_t(preds), _t(target))
    jtree, ttree = jm.state_tree(include_count=True), state_to_numpy(tm, include_count=True)
    for key in jtree:
        if key != "_update_count":
            _bitwise(ttree[key], jtree[key], key)
    assert tm.state_spec()["fingerprint"] == jm.state_spec()["fingerprint"]
    want = jm.compute()
    _bitwise(tm.compute(), want, cls)
    fresh = getattr(T, cls)(device="cpu", **kw)
    state_from_numpy(fresh, dict(jtree), fingerprint=jm.state_spec()["fingerprint"])
    _bitwise(fresh.compute(), want, "JAX tree into the port")
    jfresh = getattr(J, cls)(**kw)
    jfresh.load_state_tree({k: v if k == "_update_count" else jnp.asarray(v) for k, v in ttree.items()})
    _bitwise(tm.compute(), jfresh.compute(), "port tree into JAX")


# ---------------------------------------------------------------- classes and exports


def _make(pkg, cls, **kw):
    if "Panoptic" in cls:
        kw.update(things={0, 1}, stuffs={6})
    if pkg is T:
        kw["device"] = "cpu"
    return getattr(pkg, cls)(**kw)


@pytest.mark.parametrize("cls", CLASSES)
def test_class_attributes_and_fusion_eligibility_equal_jax(cls):
    jm, tm = _make(J, cls), _make(T, cls)
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound", "plot_upper_bound"):
        assert getattr(tm, attr, "missing") == getattr(jm, attr, "missing"), attr
    assert fusion_ineligibility(tm) == j_fusion_ineligibility(jm)
    assert sorted(tm._defaults) == sorted(jm._defaults)


def test_detection_exports_equal_jax():
    import torchmetrics_tpu.detection as JD
    import torchmetrics_tpu_torch.detection as TD

    assert sorted(TD.__all__) == sorted(JD.__all__) and sorted(TF.__all__) == sorted(JF.__all__)
    for name in TD.__all__:
        assert getattr(T, name) is getattr(TD, name) and name in T.__all__
    for name in TF.__all__:
        assert getattr(TFA, name) is getattr(TF, name) and name in TFA.__all__ and name in JFA.__all__
